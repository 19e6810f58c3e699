"""The one-card dry-run on ``meta``: a reduced cell per family (dense,
SSM, hybrid, MoE, the DiT's ParaTAA iteration) runs, writes the
reference's JSON keys, its assembled cost equals its whole program's
count (FLOPs exactly; a train step's peak over two microbatches equals
its peak over four), and its FLOPs stand against the reference's
single-device XLA ``cost_analysis()`` of the same reduced step, without
a mesh and with ``runconfig.set_unroll_scans(True)`` (the reference's
own assembly: the step at a depth of one scan unit, whose one-trip loop
XLA inlines, plus the unit compiled standalone for each further unit).

XLA's ``flops`` count every elementwise op too, the port's counter only
the products, so the port's count is the smaller one.  Measured ratios
(port / XLA): qwen3 prefill 0.953, mamba2 prefill 0.837, recurrentgemma
decode 0.744 (the RG-LRU's gates and scan are elementwise), qwen2-moe
train 0.944, ParaTAA iteration 0.980; held in [0.7, 1.0].  The assembled
bytes against the whole program's: 1.0 to 5 digits but for the MoE train
step, 0.989 (the backward of the layers' ``unbind`` and the aux loss's
adds are not in a standalone unit); held within 2%."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.launch import steps as JS
from repro.models import backbone as JB
from repro.models import pdefs as JP
from repro.models import runconfig
from repro.roofline.analysis import normalize_cost_analysis
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as D
from tests.test_torch_helpers import torch_cfg

#: the keys of the reference's ``run_cell`` record
REFERENCE_KEYS = {
    "arch", "shape", "mesh", "chips", "status", "lower_s", "compile_s",
    "argument_bytes", "output_bytes", "temp_bytes", "peak_bytes", "fits_hbm",
    "flops_per_chip", "bytes_per_chip", "collective_bytes_per_chip",
    "collective_breakdown", "compute_s", "memory_s", "collective_s",
    "dominant", "model_flops_global", "model_flops_ratio"}
#: and of its ``run_parataa_cell`` record
PARATAA_KEYS = {
    "arch", "shape", "mesh", "chips", "status", "T", "window", "n_samples",
    "placement", "compile_s", "argument_bytes", "temp_bytes", "peak_bytes",
    "fits_hbm", "flops_per_chip", "bytes_per_chip",
    "collective_bytes_per_chip", "collective_breakdown", "compute_s",
    "memory_s", "collective_s", "dominant", "model_flops_global",
    "model_flops_ratio", "note"}

# (arch, shape, ShapeConfig fields); train cells at one microbatch
CELLS = [("qwen3-0.6b", ("mini_prefill", 64, 2, "prefill")),
         ("mamba2-1.3b", ("mini_prefill", 64, 2, "prefill")),
         ("recurrentgemma-2b", ("mini_decode", 64, 2, "decode")),
         ("qwen2-moe-a2.7b", ("mini_train", 32, 4, "train"))]


def _xla_flops(compiled) -> float:
    return float(normalize_cost_analysis(compiled.cost_analysis())["flops"])


def _abstract(fn):
    return jax.eval_shape(fn)


def jax_step_flops(cj, shape) -> float:
    """The reference's step, its params, inputs and cache abstract and
    unsharded, compiled on the CPU."""
    params = _abstract(lambda: JB.init(cj, jax.random.PRNGKey(0),
                                       JS.PARAM_DTYPE))
    inputs = JS.input_specs(cj, shape, None)
    if shape.kind == "train":
        opt = {k: jax.tree.map(
            lambda p: jax.ShapeDtypeStruct(p.shape, jnp.float32), params)
            for k in ("master", "mu", "nu")}
        opt["count"] = jax.ShapeDtypeStruct((), jnp.int32)
        return _xla_flops(jax.jit(JS.make_train_step(cj)).lower(
            params, opt, inputs, jax.ShapeDtypeStruct((), jnp.int32))
            .compile())
    cache = JB.abstract_cache(cj, shape.global_batch, shape.seq_len)
    make = JS.make_prefill_step if shape.kind == "prefill" else \
        JS.make_decode_step
    x = inputs["inputs" if shape.kind == "prefill" else "token"]
    return _xla_flops(jax.jit(make(cj)).lower(params, x, cache).compile())


def jax_unit_flops(cj, shape) -> float:
    """One scan unit compiled standalone, as the reference's
    ``_layer_cost`` compiles it, without its shardings."""
    if cj.is_hybrid:
        kinds, _, _ = JB.hybrid_layout(cj)
        defs = {f"l{j}": JB._layer_def(cj, k) for j, k in enumerate(kinds)}
    else:
        kinds = cj.layer_kinds()[:1]
        defs = JB._layer_def(cj, kinds[0])

    def unit(lp, h, pos, cache, mode):
        aux = None
        for j, kind in enumerate(kinds):
            p = lp[f"l{j}"] if cj.is_hybrid else lp
            c = None if cache is None else \
                (cache[f"l{j}"] if cj.is_hybrid else cache)
            h, _, aux = JB._apply_layer(cj, kind, p, h, pos, mode=mode,
                                        cache=c, causal=True)
        return h

    lp = _abstract(lambda: JP.init_params(defs, jax.random.PRNGKey(0),
                                          JS.PARAM_DTYPE))
    b, s = shape.global_batch, shape.seq_len
    s_eff = 1 if shape.kind == "decode" else s
    h = jax.ShapeDtypeStruct((b, s_eff, cj.d_model), JS.PARAM_DTYPE)
    pos = jax.ShapeDtypeStruct((b, s_eff), jnp.int32)
    if shape.kind == "train":
        def fn(lp, h, pos):
            lf = jax.checkpoint(lambda lp, h: jnp.sum(
                unit(lp, h, pos, None, "train").astype(jnp.float32)),
                policy=JB.REMAT_POLICY)
            return jax.value_and_grad(lf, argnums=(0, 1))(lp, h)
        return _xla_flops(jax.jit(fn).lower(lp, h, pos).compile())
    full = JB.abstract_cache(cj, b, s)
    if cj.is_hybrid:
        full = full["periods"]
    cache = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape[1:], x.dtype),
                         full)
    return _xla_flops(jax.jit(lambda lp, h, pos, c: unit(
        lp, h, pos, c, shape.kind)).lower(lp, h, pos, cache).compile())


@pytest.fixture
def unrolled():
    before = runconfig.UNROLL_SCANS
    runconfig.set_unroll_scans(True)
    yield
    runconfig.set_unroll_scans(before)


@pytest.mark.parametrize("name,fields", CELLS, ids=[c[0] for c in CELLS])
def test_reduced_cell_runs_and_stands_against_xla(name, fields, unrolled,
                                                  tmp_path):
    cj = dataclasses.replace(jreg.ARCHS[name].reduced(), train_grad_accum=1)
    ct = torch_cfg(cj)
    shape = ShapeConfig(*fields)
    rec = D.run_cell(name, shape, cfg=ct, verbose=False)
    if shape.kind == "train":
        whole = dataclasses.replace(ct, train_grad_accum=4)
        fn, args = D._program(whole, shape)
        with torch.enable_grad():
            assert D._memory(fn, args)["peak_bytes"] == D.run_cell(
                name, shape, cfg=whole, verbose=False)["peak_bytes"]
    assert rec["status"] == "ok" and REFERENCE_KEYS <= set(rec)
    assert (rec["chips"], rec["mesh"], rec["collective_s"]) == \
        (1, "one-card", 0.0)
    assert rec["peak_bytes"] == rec["argument_bytes"] + rec["temp_bytes"]
    assert rec["argument_bytes"] > 0 and rec["fits_hbm"]
    fn, args = D._program(ct, shape)
    grad = torch.enable_grad() if shape.kind == "train" else torch.no_grad()
    with grad:
        whole = D._counted(fn, *args)
    assert rec["flops_per_chip"] == whole.flops
    assert abs(rec["bytes_per_chip"] / whole.bytes - 1) < 2e-2
    path = tmp_path / f"{name}__{shape.name}__one-card.json"
    path.write_text(json.dumps(rec, default=str))
    assert json.loads(path.read_text())["dominant"] == rec["dominant"]

    _, n_units, _, one = D._scan_unit(ct)
    cj_one = dataclasses.replace(cj, num_layers=one.num_layers)
    want = jax_step_flops(cj_one, shape) + \
        (n_units - 1) * jax_unit_flops(cj, shape)
    ratio = rec["flops_per_chip"] / want
    assert 0.7 <= ratio <= 1.0, ratio


def test_reduced_parataa_cell_stands_against_xla(unrolled):
    """The reference's per-iteration program (its ``run_parataa_cell``
    body, unsharded: the window's DiT forwards, residuals and the TAA
    update) at the port's reduced geometry, float32 params."""
    from repro.core import ddim_coeffs
    from repro.core.anderson import anderson_update
    from repro.core.coeffs import system_matrices
    from repro.core.system import first_order_residuals
    from repro.diffusion import dit as jdit

    T, window, n = 100, 64, 16
    rec = D.run_parataa_cell(T=T, window=window, n_samples=n, reduced=True,
                             verbose=False)
    assert rec["status"] == "ok" and PARATAA_KEYS <= set(rec)
    cfg = jreg.ARCHS["dit-xl"].reduced()
    n_tok, latent = 32, cfg.latent_dim
    dim = n_tok * latent
    coeffs = ddim_coeffs(T)
    mats = system_matrices(coeffs, 8)
    lift, weps, wxi = (jnp.asarray(a, jnp.float32)
                       for a in (mats.lift, mats.w_eps, mats.w_xi))
    a, b, c, taus = (jnp.asarray(v, jnp.float32)
                     for v in (coeffs.a, coeffs.b, coeffs.c, coeffs.taus))

    def iteration(params, x, e, dX, dF, xi, labels, t1):
        xs = jax.vmap(lambda xv, t: jax.lax.dynamic_slice(
            xv, (t + 1, 0), (window, dim)))(x, t1)
        taus_w = jax.lax.dynamic_slice(taus, (t1[0] + 1,), (window,))
        eps = jdit.dit_apply(params, cfg, xs.reshape(n * window, n_tok,
                                                     latent),
                             jnp.tile(taus_w, n), jnp.repeat(labels, window))
        e = jax.vmap(lambda ev, w, t: jax.lax.dynamic_update_slice(
            ev, w, (t + 1, 0)))(e, eps.reshape(n, window, dim), t1)

        def upd(xv, ev, dXv, dFv, xiv):
            R = lift @ xv + weps @ ev + wxi @ xiv - xv[:T]
            r = first_order_residuals((a, b, c), xv, ev, xiv)
            x_new = anderson_update(xv[:T], R, dXv, dFv, jnp.ones((T,), bool),
                                    mode="taa", lam=1e-8)
            return jnp.concatenate([x_new, xv[T:]], 0), r
        return jax.vmap(upd)(x, e, dX, dF, xi)

    params = _abstract(lambda: jdit.dit_init(cfg, jax.random.PRNGKey(0)))
    f32 = lambda *s: jax.ShapeDtypeStruct(s, jnp.float32)
    i32 = jax.ShapeDtypeStruct((n,), jnp.int32)
    want = _xla_flops(jax.jit(iteration).lower(
        params, f32(n, T + 1, dim), f32(n, T + 1, dim), f32(n, 3, T, dim),
        f32(n, 3, T, dim), f32(n, T + 1, dim), i32, i32).compile())
    ratio = rec["flops_per_chip"] / want
    assert 0.7 <= ratio <= 1.0, ratio
    assert rec["model_flops_global"] == \
        2.0 * cfg.param_count() * n * window * n_tok


def test_main_writes_the_parataa_record(tmp_path, monkeypatch):
    """``main`` over the ParaTAA cell (reduced here) writes its JSON record,
    and the report renders it."""
    from repro_torch.roofline import report

    real = D.run_parataa_cell
    monkeypatch.setattr(D, "run_parataa_cell",
                        lambda **kw: real(reduced=True, verbose=False))
    D.main(["--parataa", "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "dit-xl__parataa_serve__one-card.json")
                     .read_text())
    assert rec["status"] == "ok" and np.isfinite(rec["compute_s"])
    table = report.render(str(tmp_path))
    assert "one H100" in table and "| dit-xl | parataa_serve |" in table
