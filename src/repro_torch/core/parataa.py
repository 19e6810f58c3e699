"""ParaTAA (Algorithm 1): parallel sampling of diffusion models with
Triangular Anderson Acceleration — a resumable stepwise solver over a
leading lane axis.

One solver covers FP / FP+ / AA / AA+ / TAA via `mode` + `order_k`:
  * FP  (Shih et al. 2023)  : mode="fp",  order_k = window size
  * FP+ (paper)             : mode="fp",  order_k tuned
  * ParaTAA (paper)         : mode="taa", order_k & history_m tuned
  * mode="seq"              : the eq. (6) sequential reference expressed as
                              a stepwise state (one timestep per iteration)

Every tensor of :class:`SolverState` carries a leading lane axis B: the
lanes of one engine dispatch are solved together, and each solver
iteration evaluates eps_theta on all lanes' windows in ONE batched call
(lane-major, B * w samples).  Where the JAX package vmaps a
``while_loop``/``cond``, this port runs a host loop over iterations and
selects per lane with ``torch.where``: every lane is evaluated, but ``x``,
``it``, ``nfe`` and ``t2`` advance only on lanes not yet ``finished``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch import comm
from repro_torch.core.anderson import anderson_update
from repro_torch.core.coeffs import SolverCoeffs, system_matrices
from repro_torch.core.system import first_order_residuals
from repro_torch.device import constant, to_device
from repro_torch.models.shardctx import (current_mesh, window_gather,
                                         window_shard)


@dataclasses.dataclass(frozen=True)
class ParaTAAConfig:
    order_k: int = 4           # order of the nonlinear system (Def. 2.1)
    history_m: int = 3         # AA history size (m=1 ~ plain FP)
    window: int = 0            # sliding window size w (0 => w = T)
    mode: str = "taa"          # fp | aa | aa+ | taa | seq
    tau: float = 1e-3          # stopping tolerance
    lam: float = 1e-8          # Gram regularizer (Remark 3.3)
    s_max: int = 100           # max iterations
    safeguard: bool = True     # Theorem 3.6 post-processing
    t_init: int = 0            # 0 => fresh start (T_init = T)
    use_pallas: Optional[bool] = None  # kernels.ops routing of the TAA
                               # round (None = by device: the kernels on
                               # the card, the plain versions on the CPU;
                               # False = the plain versions on any device)
    fuse_round: bool = False   # the Anderson round as ONE ops.taa_round
                               # dispatch (one kernel launch on the card)
    time_axis: Optional[str] = None  # mesh axis the solve window shards
                               # over (None = unsharded), resolved against
                               # the ambient shardctx mesh.  Sharded: the
                               # window eps eval only — each time rank
                               # evaluates w / time_shards rows of every
                               # lane and one all-gather (exact) brings
                               # them back, so every later step runs on
                               # replicated operands and the result is the
                               # unsharded one bit for bit


@dataclasses.dataclass(frozen=True)
class SolverState:
    """The entire solver carry, every field with a leading lane axis B
    (D is the flat latent size).

    x:        (B, T+1, D) current trajectory iterate (x[:, T] = the noise).
    e:        (B, T+1, D) stored eps evaluations.
    R_prev:   (B, T, D) previous residual (Anderson dF bookkeeping), f32.
    dX, dF:   (B, m, T, D) Anderson histories.
    r_last:   (B, T) latest first-order residuals.
    t2:       (B,) highest unconverged row (-1 => converged).
    it:       (B,) iterations executed so far.
    nfe:      (B,) eps evaluations issued so far.
    done:     (B,) convergence flag (tolerance met; NOT the same as finished).
    xi:       (B, T+1, D) noise draws.
    noise_k:  (B, T, D) w_xi @ xi, the k-th order system's noise term.
    thresh:   (B, T) squared per-row stopping thresholds (carries tau).
    iter_cap: (B,) iteration budget.
    """
    x: torch.Tensor
    e: torch.Tensor
    R_prev: torch.Tensor
    dX: torch.Tensor
    dF: torch.Tensor
    r_last: torch.Tensor
    t2: torch.Tensor
    it: torch.Tensor
    nfe: torch.Tensor
    done: torch.Tensor
    xi: torch.Tensor
    noise_k: torch.Tensor
    thresh: torch.Tensor
    iter_cap: torch.Tensor

    @property
    def finished(self) -> torch.Tensor:
        """(B,) retire predicate: converged OR out of iteration budget."""
        return self.done | (self.it >= self.iter_cap)

    def keep_where(self, keep: torch.Tensor, other: "SolverState"
                   ) -> "SolverState":
        """Per-lane select: lanes where ``keep`` keep this state, the rest
        take ``other``'s."""
        out = {}
        for f in dataclasses.fields(self):
            a, b = getattr(self, f.name), getattr(other, f.name)
            k = keep.reshape((-1,) + (1,) * (a.dim() - 1))
            out[f.name] = torch.where(k, a, b)
        return SolverState(**out)


def _build_static(coeffs: SolverCoeffs, cfg: ParaTAAConfig,
                  device: torch.device) -> Dict:
    """The solve's device constants (system matrices, coefficients), made
    once per (coeffs, window, order, device) and shared by every
    ``init_state`` / ``sample`` / ``step_chunk`` call."""
    T = coeffs.T
    w = min(cfg.window if cfg.window else T, T)
    k = min(cfg.order_k, T)

    def make():
        mats_k = system_matrices(coeffs, k)

        def f32(a):
            return to_device(a, torch.float32, device)

        return dict(
            T=T, w=w, k=k,
            lift_k=f32(mats_k.lift), weps_k=f32(mats_k.w_eps),
            wxi_k=f32(mats_k.w_xi),
            a=f32(coeffs.a), b=f32(coeffs.b), c=f32(coeffs.c),
            taus=f32(coeffs.taus),
            thresh_scale=f32(coeffs.g2[1:]),  # (T,) row t -> g2[t+1]
        )

    return constant(("parataa", coeffs.cache_key(), w, k,
                     torch.device(device)), make)


def _iterate(state: SolverState, static, cfg: ParaTAAConfig,
             eps_fn) -> SolverState:
    """One Algorithm-1 iteration on every lane.  Returns the new state."""
    T, w = static["T"], static["w"]
    x, e, xi = state.x, state.e, state.xi
    B = x.shape[0]
    dev = x.device
    lanes = torch.arange(B, device=dev)
    rows = torch.arange(T, device=dev)

    t2 = state.t2
    t1 = torch.clamp(t2 - w + 1, min=0)

    # --- line 3: evaluate eps at each lane's window t1+1 .. t1+w ------------
    # The w window rows are independent in this pass, so they shard over
    # the `time` mesh axis: each time rank evaluates its w / time_shards
    # rows of every lane, and one all-gather (exact data movement) gives
    # every rank the whole window.  Everything below runs on replicated
    # operands, as the JAX package's replicate pins hold it.
    start = torch.clamp(t1 + 1, max=T + 1 - w)   # dynamic_slice's clamp
    idx = start[:, None] + torch.arange(w, device=dev)          # (B, w)
    ta = cfg.time_axis
    idx_local = window_shard(idx, ta, dim=1)
    xs = x[lanes[:, None], idx_local]                           # (B, w', D)
    e_w = window_gather(eps_fn(xs, static["taus"][idx_local]).to(e.dtype),
                        ta, dim=1, rows=w)
    e = e.clone()
    e[lanes[:, None], idx] = e_w

    # --- update residual R = F^(k)(x, e) - x (rows 0..T-1) ------------------
    F = torch.matmul(static["lift_k"], x.float()) \
        + torch.matmul(static["weps_k"], e.float()) + state.noise_k
    R = F - x[:, :T].float()

    # --- lines 4-9: first-order residuals, window bookkeeping ---------------
    # rows above t2 keep taking the cheap eps-free F^(k) polish with their
    # stored e (as in the JAX package: hard-freezing them can deadlock
    # lower rows whose thresholds sit below the inherited error)
    r = first_order_residuals((static["a"], static["b"], static["c"]),
                              x, e, xi)
    active = rows[None] >= t1[:, None]
    conv = r <= state.thresh
    unconv = active & ~conv
    any_unconv = unconv.any(dim=1)
    # highest unconverged active row (argmax takes the first maximum)
    new_t2_active = T - 1 - torch.argmax(
        torch.flip(unconv, [1]).to(torch.int32), dim=1)
    # all active rows converged: done if t1 == 0, else slide the window down
    new_t2 = torch.where(any_unconv, new_t2_active,
                         torch.where(t1 == 0, torch.full_like(t1, -1), t1 - 1))
    done = new_t2 < 0
    new_t1 = torch.clamp(new_t2 - w + 1, min=0)
    upd_mask = (rows[None] >= new_t1[:, None]) & ~done[:, None]

    # --- histories: write dF[(i-1) % m] = R^i - R^{i-1} before the update ---
    it = state.it
    m = cfg.history_m
    slot_prev = torch.clamp(it - 1, min=0) % m
    dF_entry = torch.where((it >= 1)[:, None, None], R - state.R_prev,
                           torch.zeros_like(R))
    dF = state.dF.clone()
    dF[lanes, slot_prev] = dF_entry.to(dF.dtype)

    # --- lines 10-11: accelerated update over the (new) window --------------
    guard = None
    if cfg.safeguard:
        # rows whose entire suffix has converged (rows above new_t2 are
        # frozen-converged by construction)
        conv_or_frozen = conv | (rows[None] > new_t2[:, None])
        suffix_all = torch.flip(torch.cumprod(
            torch.flip(conv_or_frozen.to(torch.int32), [1]), dim=1), [1])
        guard = torch.cat([suffix_all[:, 1:] > 0,
                           torch.ones((B, 1), dtype=torch.bool, device=dev)],
                          dim=1)                  # row T-1: empty suffix
    mode = cfg.mode if cfg.history_m > 1 else "fp"
    x_rows_new = anderson_update(
        x[:, :T], R.to(x.dtype), state.dX, dF, upd_mask,
        mode=mode, lam=cfg.lam, safeguard_mask=guard,
        use_pallas=cfg.use_pallas, time_axis=ta, fuse_round=cfg.fuse_round)
    x_new = torch.cat([x_rows_new, x[:, T:]], dim=1)

    # write dX[i % m] = x^{i+1} - x^i after it
    dX = state.dX.clone()
    dX[lanes, it % m] = (x_new[:, :T] - x[:, :T]).to(dX.dtype)

    return dataclasses.replace(
        state, x=x_new, e=e, R_prev=R, dX=dX, dF=dF,
        t2=new_t2, it=it + 1, done=done, r_last=r, nfe=state.nfe + w)


def _seq_iterate(state: SolverState, static, cfg: ParaTAAConfig,
                 eps_fn) -> SolverState:
    """One eq.-(6) sequential timestep per lane on the same state layout:
    read x[t2+1], write x[t2], slide t2 down (the recursion of
    ``repro_torch.diffusion.samplers._sequential_sample``)."""
    T = static["T"]
    B = state.x.shape[0]
    lanes = torch.arange(B, device=state.x.device)
    # finished lanes (t2 = -1) compute on a clamped row; the caller's
    # per-lane select discards them
    t = torch.clamp(state.t2 + 1, min=1, max=T)
    x_t = state.x[lanes, t]                                     # (B, D)
    e = eps_fn(x_t[:, None], static["taus"][t][:, None])[:, 0]
    a, b, c = static["a"], static["b"], static["c"]
    x_prev = a[t, None] * x_t + b[t, None] * e \
        + c[t - 1, None] * state.xi[lanes, t - 1]
    x = state.x.clone()
    x[lanes, t - 1] = x_prev.to(x.dtype)
    new_t2 = state.t2 - 1
    return dataclasses.replace(
        state, x=x, t2=new_t2, it=state.it + 1, nfe=state.nfe + 1,
        done=new_t2 < 0)


def _iterate_fn(cfg: ParaTAAConfig):
    return _seq_iterate if cfg.mode == "seq" else _iterate


def _per_lane(v, B: int, dtype, device) -> torch.Tensor:
    """Scalar or (B,) value -> (B,) tensor on ``device``, with no blocking
    host copy (a scalar is filled in on the device)."""
    if isinstance(v, torch.Tensor):
        v = v.to(device=device, dtype=dtype)
    elif np.ndim(v) == 0:
        return torch.full((B,), v, dtype=dtype, device=device)
    else:
        v = to_device(v, dtype, device)
    return v.expand(B).clone()


def init_state(coeffs: SolverCoeffs, cfg: ParaTAAConfig, xi: torch.Tensor,
               x_init: Optional[torch.Tensor] = None, dtype=torch.float32,
               t_init=None, tau_sq=None, iter_cap=None) -> SolverState:
    """Build the solver's initial :class:`SolverState`.

    xi:       (B, T+1, *shape) noise draws (xi[:, T] = x_T).
    x_init:   optional (B, T+1, *shape) initialization trajectory (Sec. 4.2).
    t_init:   restart depth T_init, a scalar or one per lane.
    tau_sq:   SQUARED stopping tolerance override, scalar or per lane
              (default ``cfg.tau ** 2``).
    iter_cap: iteration budget override, scalar or per lane (default s_max).
    """
    T = coeffs.T
    B = xi.shape[0]
    D = int(np.prod(xi.shape[2:]))
    dev = xi.device
    xi_f = xi.reshape(B, T + 1, D).float()
    x0_f = None if x_init is None else x_init.reshape(B, T + 1, D)

    static = _build_static(coeffs, cfg, dev)
    noise_k = torch.matmul(static["wxi_k"], xi_f)
    if tau_sq is None:
        tau_sq = cfg.tau ** 2
    tau_sq = _per_lane(tau_sq, B, torch.float32, dev)
    thresh = tau_sq[:, None] * static["thresh_scale"][None] * D
    if iter_cap is None:
        iter_cap = cfg.s_max
    if t_init is None:
        t_init = cfg.t_init if cfg.t_init else T
    if cfg.mode == "seq":
        t_init = T                                 # seq always walks all rows
    if x0_f is None:
        x0_f = xi_f  # standard Gaussian init (paper Sec. 5 setting)
    x = x0_f.to(dtype).clone()
    x[:, T] = xi_f[:, T].to(dtype)                 # x_T is always the noise
    m = cfg.history_m
    return SolverState(
        x=x,
        e=torch.zeros((B, T + 1, D), dtype=dtype, device=dev),
        R_prev=torch.zeros((B, T, D), dtype=torch.float32, device=dev),
        dX=torch.zeros((B, m, T, D), dtype=dtype, device=dev),
        dF=torch.zeros((B, m, T, D), dtype=dtype, device=dev),
        r_last=torch.full((B, T), float("inf"), dtype=torch.float32,
                          device=dev),
        t2=_per_lane(t_init, B, torch.long, dev) - 1,
        it=torch.zeros((B,), dtype=torch.long, device=dev),
        nfe=torch.zeros((B,), dtype=torch.long, device=dev),
        done=torch.zeros((B,), dtype=torch.bool, device=dev),
        xi=xi_f,
        noise_k=noise_k,
        thresh=thresh,
        iter_cap=_per_lane(iter_cap, B, torch.long, dev),
    )


def _flat_eps(eps_fn: Callable, shape) -> Callable:
    """Adapt an (n, *shape)-shaped eps_fn to the state's (B, w, D) layout:
    every lane's window goes to eps_fn as one lane-major batch of B * w."""
    def eps_flat(xw, taus_w):
        B, w, D = xw.shape
        out = eps_fn(xw.reshape((B * w,) + tuple(shape)),
                     taus_w.reshape(B * w))
        return out.reshape(B, w, D)

    return eps_flat


def _guarded_step(state: SolverState, static, cfg, eps_flat) -> SolverState:
    """One iteration where lanes already ``finished`` pass through.  It
    reads nothing on the host: an all-finished bank still costs the
    iteration's device work (as the JAX package's vmapped ``cond`` in a
    ``scan`` does)."""
    return state.keep_where(state.finished,
                            _iterate_fn(cfg)(state, static, cfg, eps_flat))


#: bytes one :func:`poll_finished` brings to the host (one bool)
POLL_BYTES = 1


def poll_finished(state: SolverState, group=None) -> bool:
    """Whether every lane has finished: the solver loop's one host read.

    On a CUDA tensor the flag goes by a copy that does not block into
    pinned host memory, and the host waits on an event recorded after it:
    the only wait of the solve.  ``sample`` calls this once per iteration,
    and nothing else on the solve path reads the device.  With ``group``
    (the lanes' data shards) the flag is first reduced over it, on the
    device and in stream order, so every shard stops at the same iteration:
    the slowest lane of the whole batch, as one unsharded batch would."""
    flag = state.finished.all()
    if group is not None:
        flag = comm.all_reduce_min(flag.to(torch.int32), group).bool()
    if flag.device.type != "cuda":
        return bool(flag)
    host = torch.empty((), dtype=torch.bool, pin_memory=True)
    host.copy_(flag, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    done.synchronize()
    return bool(host)


def step_chunk(eps_fn: Callable, coeffs: SolverCoeffs, cfg: ParaTAAConfig,
               state: SolverState, num_iters: int, *,
               sample_shape=()) -> SolverState:
    """Advance ``state`` by ``num_iters`` guarded solver iterations (lanes
    that finish pass through the rest): driving this until ``finished``
    reproduces ``sample``.  Nothing is read on the host.  ``sample_shape``
    is the unflattened latent shape ``eps_fn`` expects (``()`` = flat)."""
    static = _build_static(coeffs, cfg, state.x.device)
    shape = tuple(sample_shape) or (state.x.shape[-1],)
    eps_flat = _flat_eps(eps_fn, shape)
    for _ in range(num_iters):
        state = _guarded_step(state, static, cfg, eps_flat)
    return state


def state_info(state: SolverState) -> dict:
    """The info dict of a (possibly still-running) state, per lane."""
    return dict(iters=state.it, nfe=state.nfe, converged=state.done,
                residuals=state.r_last)


def lane_residual(state: SolverState) -> torch.Tensor:
    """(B,) per-lane convergence telemetry: the WORST row's latest
    first-order residual (+inf before a lane's first parallel iterate)."""
    return torch.amax(state.r_last, dim=-1)


def lane_summary(state: SolverState) -> torch.Tensor:
    """(B, 5) int32 per-lane scheduling summary, the one array a stepwise
    poll brings to the host: finished, it, nfe, done, and
    :func:`lane_residual`'s float32 bits (``.view(torch.int32)``, read back
    on the host with ``.view(np.float32)``)."""
    return torch.stack(
        [state.finished.to(torch.int32), state.it.to(torch.int32),
         state.nfe.to(torch.int32), state.done.to(torch.int32),
         lane_residual(state).float().view(torch.int32)], dim=-1)


def _axis_group(axis):
    """The ambient mesh's process group over ``axis`` (None without a mesh
    or an axis)."""
    mesh = current_mesh()
    if mesh is None or axis is None:
        return None
    from repro_torch.launch.mesh import axes_group

    return axes_group(mesh, (axis,) if isinstance(axis, str) else axis)


def sample(eps_fn: Callable, coeffs: SolverCoeffs, cfg: ParaTAAConfig, xi,
           x_init: Optional[torch.Tensor] = None, dtype=torch.float32,
           t_init=None, tau_sq=None, iter_cap=None, lane_axis=None):
    """Run every lane to convergence (or its iteration budget).

    eps_fn: (x (n, *shape), taus (n,)) -> eps (n, *shape), n = B * w
    xi:     (B, T+1, *shape) noise draws (xi[:, T] = x_T)
    x_init: optional (B, T+1, *shape) initialization trajectory (Sec. 4.2)
    t_init / tau_sq / iter_cap: scalar or per-lane overrides (``init_state``)
    Returns (trajectory (B, T+1, *shape), info dict of (B,) tensors plus
    ``polls``, the host reads made: one :func:`poll_finished` after each
    iteration, so as many as the slowest lane's iterations).  The first
    poll comes after the first iteration, so a batch whose every lane
    starts finished (``iter_cap`` 0) costs one pass-through iteration.
    lane_axis: the mesh axis (or axes) the lanes are a shard of (the
    engine's data axis): each poll then reduces the finished flag over
    that axis's group, so every shard iterates as long as the slowest
    lane of the whole batch.
    """
    shape = tuple(xi.shape[2:])
    state = init_state(coeffs, cfg, xi, x_init=x_init, dtype=dtype,
                       t_init=t_init, tau_sq=tau_sq, iter_cap=iter_cap)
    static = _build_static(coeffs, cfg, xi.device)
    eps_flat = _flat_eps(eps_fn, shape)
    group = _axis_group(lane_axis)
    polls = 0
    while True:
        state = _guarded_step(state, static, cfg, eps_flat)
        polls += 1
        if (poll_finished(state) if group is None
                else poll_finished(state, group)):
            break
    B = xi.shape[0]
    return (state.x.reshape((B, coeffs.T + 1) + shape),
            dict(state_info(state), polls=polls))


def sample_recording(eps_fn, coeffs: SolverCoeffs, cfg: ParaTAAConfig, xi,
                     x_init: Optional[torch.Tensor] = None,
                     dtype=torch.float32, t_init=None, tau_sq=None,
                     iter_cap=None):
    """Fixed-s_max variant that records per-iteration diagnostics per lane:
    residual vectors (B, s_max, T) and x_0 iterates (B, s_max, D)."""
    shape = tuple(xi.shape[2:])
    state = init_state(coeffs, cfg, xi, x_init=x_init, dtype=dtype,
                       t_init=t_init, tau_sq=tau_sq, iter_cap=iter_cap)
    static = _build_static(coeffs, cfg, xi.device)
    eps_flat = _flat_eps(eps_fn, shape)
    recs = dict(r=[], x0=[], t2=[], done=[])
    for _ in range(cfg.s_max):
        state = _guarded_step(state, static, cfg, eps_flat)
        recs["r"].append(state.r_last)
        recs["x0"].append(state.x[:, 0])
        recs["t2"].append(state.t2)
        recs["done"].append(state.done)
    hist = {k: torch.stack(v, dim=1) for k, v in recs.items()}
    info = dict(iters=state.it, nfe=state.nfe, converged=state.done,
                res_history=hist["r"], x0_history=hist["x0"],
                t2_history=hist["t2"], done_history=hist["done"])
    B = xi.shape[0]
    return state.x.reshape((B, coeffs.T + 1) + shape), info
