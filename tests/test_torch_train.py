"""Port parity for the DiT training path: data pipelines, the LR schedule,
AdamW, ``dit_loss`` and its gradients, the train step, and the train
driver's restart and the JAX driver's run — the same numpy-seeded inputs
through the JAX package and the port, on the CPU, at the reduced DiT (4
layers, d 128, 4x32 heads).  The port's other driver tests are in
``tests/test_torch_train_driver.py`` (split for the parallel run's
balance)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS
from repro.data import pipeline as jpipe
from repro.diffusion import dit as jdit
from repro.diffusion.schedules import make_schedule
from repro.launch import steps as JS
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro.optim import lr_schedule as jlr_schedule
from repro_torch.data import pipeline as tpipe
from repro_torch.diffusion import dit as tdit
from repro_torch.diffusion.convert import (dit_init_numpy,
                                          dit_params_from_numpy)
from repro_torch.launch import steps as TS
from repro_torch.launch import train as ttrain
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, \
    lr_schedule
from repro_torch.tree import flatten_with_paths, leaves
from tests.test_torch_helpers import one_torch_thread  # noqa: F401
from tests.test_torch_helpers import (CPU, dit_param_trees, normal, rel_err,
                                      to_np, torch_cfg)
from tests.test_torch_train_driver import _train_argv

CFG_J = ARCHS["dit-xl"].reduced()
CFG_T = torch_cfg(CFG_J)
STEPS, BATCH = 5, 16


def _batches(pipe, n=STEPS, batch=BATCH):
    return [pipe.batch(i, batch) for i in range(n)]


def _torch_batch(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def _tree_rel_err(got, want) -> float:
    """The largest per-leaf ``rel_err`` over two trees of one structure."""
    g, w = leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    return max(rel_err(a, b) for a, b in zip(g, w))


# --- data pipelines ---------------------------------------------------------


@pytest.mark.parametrize("step,batch,seed", [(0, 16, 0), (41, 5, 3)])
def test_latent_pipeline_bit_identical(step, batch, seed):
    kw = dict(num_tokens=16, latent_dim=CFG_J.latent_dim,
              num_classes=CFG_J.num_classes, seed=seed)
    want = jpipe.LatentPipeline(**kw).batch(step, batch)
    got = tpipe.LatentPipeline(**kw).batch(step, batch)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])


def test_token_pipeline_bit_identical(tmp_path):
    kw = dict(seq_len=16, global_batch=8, vocab_size=100, seed=3)
    j, t = (jpipe.TokenPipeline(jpipe.DataConfig(**kw)),
            tpipe.TokenPipeline(tpipe.DataConfig(**kw)))
    for want, got in ((j.batch(41), t.batch(41)),
                      (j.host_slice(2, 1, 4), t.host_slice(2, 1, 4))):
        for k in ("inputs", "labels"):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    toks = np.arange(1000, dtype=np.int32) % 64
    f = tmp_path / "tokens.bin"
    toks.tofile(f)
    kw = dict(seq_len=9, global_batch=2, vocab_size=64, source="file",
              path=str(f))
    for step in (0, 7):
        want = jpipe.TokenPipeline(jpipe.DataConfig(**kw)).batch(step)
        got = tpipe.TokenPipeline(tpipe.DataConfig(**kw)).batch(step)
        for k in ("inputs", "labels"):
            np.testing.assert_array_equal(got[k], want[k])


# --- optimizer ----------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(), dict(warmup_steps=10,
                                             total_steps=100, base_lr=1.0),
                                dict(warmup_steps=0, total_steps=50,
                                     min_ratio=0.0)])
def test_lr_schedule_matches_jax(kw):
    kw = {"base_lr": 3e-4, **kw}
    steps = np.arange(0, 120, dtype=np.int32)
    got = torch.stack([lr_schedule(torch.tensor(s), **kw) for s in steps])
    want = np.asarray([jlr_schedule(jnp.asarray(s), **kw) for s in steps])
    assert got.dtype == torch.float32
    # float32 throughout in both: the cos of the one argument may round
    # differently by an ulp
    assert np.max(np.abs(got.numpy() - want) / kw["base_lr"]) < 1e-6


def _opt_trees(seed, dtype):
    shapes = {"a": (6, 5), "b": {"c": (7,), "d": (2, 3, 4)}}
    rng = np.random.default_rng(seed)

    def draw(shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    p = jax.tree.map(draw, shapes, is_leaf=lambda s: isinstance(s, tuple))
    # the first step's grads are large enough to be clipped
    gs = [jax.tree.map(lambda s, i=i: draw(s, 3.0 if i == 0 else 0.1), shapes,
                       is_leaf=lambda s: isinstance(s, tuple))
          for i in range(3)]
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    to_j = lambda t: jax.tree.map(lambda a: jnp.asarray(a).astype(jdt), t)
    to_t = lambda t: jax.tree.map(lambda a: torch.from_numpy(a).to(tdt), t)
    return (to_j(p), [to_j(g) for g in gs]), (to_t(p), [to_t(g) for g in gs])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(dtype):
    """Three updates (the first clipped) from the same params and grads:
    master, moments and params agree within 1e-6 relative (float32 roundings
    of the same formulas); bf16 params stay bf16 over an f32 master, within
    a bf16 ulp of the reference's."""
    (pj, gjs), (pt, gts) = _opt_trees(0, dtype)
    cfg_j, cfg_t = JAdamWConfig(lr=1e-2), AdamWConfig(lr=1e-2)
    oj, ot = jadamw_init(pj), adamw_init(pt)
    assert all(x.dtype == torch.float32 for x in leaves(ot["master"]))
    for i, (gj, gt) in enumerate(zip(gjs, gts)):
        lr = float(jlr_schedule(jnp.asarray(i), base_lr=1e-2, warmup_steps=2))
        pj, oj, mj = jadamw_update(gj, oj, pj, cfg_j, jnp.float32(lr))
        pt, ot, mt = adamw_update(gt, ot, pt, cfg_t,
                                  torch.tensor(lr, dtype=torch.float32))
        assert rel_err(mt["grad_norm"], mj["grad_norm"]) < 1e-6
        assert float(mt["lr"]) == float(mj["lr"])
    assert int(ot["count"]) == int(oj["count"]) == 3
    assert ot["count"].dtype == torch.int32 and ot["count"].shape == ()
    for k in ("master", "mu", "nu"):
        assert _tree_rel_err(ot[k], oj[k]) < 1e-6, k
    assert all(x.dtype == getattr(torch, dtype) for x in leaves(pt))
    tol = 1e-6 if dtype == "float32" else 2.0 ** -8
    assert _tree_rel_err(pt, pj) < tol


def test_adamw_default_lr_and_no_clip():
    """``lr_t`` None uses the config's lr (reported as a 0-d tensor);
    ``grad_clip`` 0 leaves the grads unscaled."""
    (pj, gjs), (pt, gts) = _opt_trees(1, "float32")
    cfg_j = JAdamWConfig(lr=1e-2, grad_clip=0.0)
    cfg_t = AdamWConfig(lr=1e-2, grad_clip=0.0)
    pj, oj, mj = jadamw_update(gjs[0], jadamw_init(pj), pj, cfg_j)
    pt, ot, mt = adamw_update(gts[0], adamw_init(pt), pt, cfg_t)
    assert mt["lr"].shape == () and float(mt["lr"]) == pytest.approx(1e-2)
    assert _tree_rel_err(pt, pj) < 1e-6


# --- loss ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def loss_inputs():
    pj, tree = dit_param_trees(CFG_J, seed=2, fan_in_qk=True)
    pt = dit_params_from_numpy(tree, CFG_T, CPU)
    pipe = jpipe.LatentPipeline(num_tokens=16, latent_dim=CFG_J.latent_dim,
                                num_classes=CFG_J.num_classes, seed=4)
    return pj, pt, pipe.batch(3, 8)


def test_dit_loss_and_grads_match_jax(loss_inputs):
    pj, pt, b = loss_inputs
    abar_j = jnp.asarray(make_schedule("linear", 1000)[0], jnp.float32)
    lj, gj = jax.jit(jax.value_and_grad(jdit.dit_loss), static_argnums=1)(
        pj, CFG_J, {k: jnp.asarray(v) for k, v in b.items()}, abar_j)
    grads_of = TS.make_grads_fn(CFG_T)
    lt, gt = grads_of(pt, _torch_batch(b))
    assert lt.shape == () and lt.dtype == torch.float32
    assert rel_err(lt, lj) < 1e-5                     # measured 8e-7
    # every leaf's gradient, relative to its own largest entry: float32
    # sums over 8 x 16 rows in another order (measured at most 1.1e-5)
    assert _tree_rel_err(gt, gj) < 5e-5
    assert not any(p.requires_grad for p in leaves(pt))


def test_remat_gives_the_same_values(loss_inputs):
    _, pt, b = loss_inputs
    tb = _torch_batch(b)
    x = tb["noise"]
    t = tb["t"].to(torch.float32)
    y = tb["labels"].long()
    outs = []
    flat = leaves(pt)
    for remat in (False, True):
        for p in flat:
            p.requires_grad_(True)
        out = tdit.dit_apply(pt, CFG_T, x, t, y, remat=remat)
        grads = torch.autograd.grad(out.square().sum(), flat)
        for p in flat:
            p.requires_grad_(False)
        outs.append((out.detach(), grads))
    (o0, g0), (o1, g1) = outs
    assert torch.equal(o0, o1)
    assert all(torch.equal(a, c) for a, c in zip(g0, g1))


# --- train step -----------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_init():
    """The JAX package's DiT init (``dit_init``, PRNGKey 0) as numpy: what
    the JAX train driver starts from in this process."""
    params = jdit.dit_init(CFG_J, jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def numpy_init():
    """DiT weights drawn once from the port's numpy initializer
    (``dit_init_numpy``, seed 0; the adaLN-zero leaves zeros, as in the
    reference's init), the same arrays for both packages.  The reference's
    own ``dit_init`` keys its leaves by the salted ``hash`` of their paths,
    so its draw changes with the process."""
    return dit_init_numpy(CFG_T, 0)


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_steps_match_jax(numpy_init, grad_accum):
    """Five steps of the port's train step against five of the reference's
    jitted one, from one numpy init, on the same batches.  Losses and grad
    norms agree within 1e-5 relative, and every parameter within 1e-5
    relative to its leaf's largest entry — except the zero-initialized
    adaLN leaves (ada, final_ada), held at 5e-5: their entries are the five
    Adam steps themselves, and an Adam step of an element whose gradient
    is near its rounding is sensitive to it.  Measured over the inits of
    seeds 0-5: the adaLN leaves 1.07e-5 to 1.86e-5 (grad_accum 1 and 2
    alike), every other leaf at most 8.9e-7, losses at most 1.9e-6.
    Master weights the same.  The metrics are 0-d tensors."""
    pipe = jpipe.LatentPipeline(num_tokens=16, latent_dim=CFG_J.latent_dim,
                                num_classes=CFG_J.num_classes)
    batches = _batches(pipe)
    # each package its own copy: on the CPU both may share a numpy
    # buffer's memory, and the port's step updates its params in place
    pj = jax.tree.map(lambda a: jnp.asarray(a.copy()), numpy_init)
    oj = jadamw_init(pj)
    jstep = jax.jit(JS.make_train_step(CFG_J, grad_accum=grad_accum))
    pt = dit_params_from_numpy(jax.tree.map(np.copy, numpy_init), CFG_T,
                               CPU)
    ot = adamw_init(pt)
    tstep = TS.make_train_step(CFG_T, grad_accum=grad_accum)
    marks = []
    for i, b in enumerate(batches):
        pj, oj, mj = jstep(pj, oj, {k: jnp.asarray(v) for k, v in b.items()},
                           jnp.asarray(i, jnp.int32))
        pt, ot, mt = tstep(pt, ot, _torch_batch(b), torch.tensor(i),
                           mark=lambda: marks.append(i))
        assert sorted(mt) == ["grad_norm", "loss", "lr"]
        assert all(v.shape == () for v in mt.values())
        assert rel_err(mt["loss"], mj["loss"]) < 1e-5, i
        assert rel_err(mt["grad_norm"], mj["grad_norm"]) < 1e-5, i
        assert rel_err(mt["lr"], mj["lr"]) < 1e-6, i
    assert marks == list(range(STEPS))
    assert int(ot["count"]) == STEPS
    for got, want in ((pt, pj), (ot["master"], oj["master"])):
        for (path, g), w in zip(flatten_with_paths(got),
                                jax.tree.leaves(want)):
            tol = 5e-5 if path[-1] in ("ada", "final_ada") else 1e-5
            assert rel_err(g, w) < tol, path


def tdit_params(seed):
    from repro_torch.diffusion.convert import dit_init
    return dit_init(CFG_T, seed, CPU)


def test_train_step_refuses_a_ragged_split():
    pt = tdit_params(seed=0)
    step = TS.make_train_step(CFG_T, grad_accum=3)
    pipe = tpipe.LatentPipeline(num_tokens=16, latent_dim=CFG_T.latent_dim,
                                num_classes=CFG_T.num_classes)
    with pytest.raises(ValueError, match="microbatches"):
        step(pt, adamw_init(pt), _torch_batch(pipe.batch(0, 4)), 0)


@pytest.mark.usefixtures("one_torch_thread")
def test_parataa_serve_step_matches_sequential():
    from repro_torch.core import ParaTAAConfig, ddim_coeffs
    from repro_torch.sampling import sequential_sample

    pt = tdit_params(seed=1)
    coeffs = ddim_coeffs(12)
    xi = torch.from_numpy(normal(3, 2, 13, 16, CFG_T.latent_dim))
    labels = torch.tensor([2, 5])
    x0, iters, nfe = TS.make_parataa_serve_step(
        CFG_T, ParaTAAConfig(), coeffs)(pt, xi, labels)
    assert x0.shape == (2, 16, CFG_T.latent_dim)
    for lane in range(2):
        def eps_fn(x, taus, y=int(labels[lane])):
            return tdit.dit_apply(pt, CFG_T, x, taus,
                                  torch.full((x.shape[0],), y))
        x_seq = sequential_sample(eps_fn, coeffs, xi[lane])
        assert rel_err(x0[lane], x_seq) < 2e-2
        assert 0 < int(iters[lane]) < coeffs.T and int(nfe[lane]) > 0


# --- drivers (the rest: tests/test_torch_train_driver.py) ----------------------


@pytest.mark.usefixtures("one_torch_thread")
def test_train_driver_restart_continues(tmp_path):
    ck = tmp_path / "ck"
    first = ttrain.run(_train_argv(ck, 6, 3))
    # restart with more steps: must resume from the checkpoint, not step 0
    again = ttrain.run(_train_argv(ck, 8, 3))
    assert again.start_step == 6 and len(again.losses) == 2
    # ... and match an uninterrupted run of the same 8 steps
    whole = ttrain.run(_train_argv(tmp_path / "other", 8, 100))
    np.testing.assert_allclose(first.losses + again.losses, whole.losses,
                               rtol=1e-6)
    for a, b in zip(leaves(again.state["params"]),
                    leaves(whole.state["params"])):
        assert torch.allclose(a, b, rtol=1e-6, atol=1e-7)


def test_jax_driver_trains_what_the_port_trains_and_serves(tmp_path,
                                                           jax_init,
                                                           monkeypatch,
                                                           capsys):
    """The JAX package's ``train.main`` from its init, and the port's loop
    from the same init converted: the same losses within 1e-5 relative.
    The port's ``serve.main --ckpt`` then restores exactly the params the
    JAX driver saved."""
    from repro.ckpt import load_pytree as jload
    from repro.launch.train import main as jtrain_main
    from repro_torch.launch import serve as tserve

    ck = tmp_path / "ck"
    argv = ["--arch", "dit-xl", "--smoke", "--steps", "5", "--batch", "16",
            "--log-every", "100"]
    want = jtrain_main(argv + ["--ckpt-dir", str(ck)])
    args = ttrain.parse_args(argv + ["--device", "cpu"])
    params = dit_params_from_numpy(jax_init, CFG_T, CPU)
    got = ttrain.train(args, CFG_T, params, adamw_init(params))
    assert got.start_step == 0 and len(got.losses) == 5
    np.testing.assert_allclose(got.losses, want, rtol=1e-5)

    served = []
    real = tserve.make_engine
    monkeypatch.setattr(tserve, "make_engine", lambda params, *a, **kw: (
        served.append(params), real(params, *a, **kw))[1])
    capsys.readouterr()
    tserve.main(["--smoke", "--requests", "1", "--steps-T", "8", "--ckpt",
                 str(ck), "--device", "cpu"])
    assert "restored checkpoint step 5" in capsys.readouterr().out
    saved = jload({"params": jdit.dit_init(CFG_J, jax.random.PRNGKey(1))},
                  ck / "step_00000005")["params"]
    [restored] = served
    for a, b in zip(leaves(restored), jax.tree.leaves(saved)):
        np.testing.assert_array_equal(to_np(a), np.asarray(b))
