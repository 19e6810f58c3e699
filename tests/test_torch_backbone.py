"""Port parity for the LM backbones (attention, mamba2, the RG-LRU hybrid,
MoE): configs, parameter definitions and per-leaf dtypes, ``forward``,
``prefill`` + ``decode_step`` (the SWA ring buffer and the int8 cache
included) and the blocked attention path — the same numpy-seeded weights
and inputs through the JAX package and the port, on the CPU, at each
config's ``reduced()`` size."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import registry as jreg
from repro.models import attention as jattn
from repro.models import backbone as jb
from repro.models import pdefs as jpdefs
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.models import attention as tattn
from repro_torch.models import backbone as tb
from repro_torch.models import pdefs as tpdefs
from repro_torch.models.convert import (backbone_init_numpy,
                                        backbone_init_on_device,
                                        backbone_params_from_numpy)
from repro_torch.tree import flatten_with_paths, leaves
from tests.test_torch_helpers import CPU, rel_err, to_np, torch_cfg

#: the six attention-family configs
ATTN_ARCHS = ["qwen3-0.6b", "granite-8b", "qwen2-72b", "h2o-danube-3-4b",
              "qwen2-vl-2b", "musicgen-medium"]
#: mamba2, the RG-LRU hybrid and the two MoE configs
SSM_MOE_ARCHS = ["mamba2-1.3b", "recurrentgemma-2b", "qwen2-moe-a2.7b",
                 "moonshot-v1-16b-a3b"]
#: every LM config
LM_ARCHS = ATTN_ARCHS + SSM_MOE_ARCHS
#: the reduced hybrid has 2 period groups and no tail; this variant adds
#: a tail of 2 RG-LRU layers (the list path)
TAIL = "recurrentgemma-2b+tail"
VARIANTS = {TAIL: ("recurrentgemma-2b", {"num_layers": 8})}
#: leaves whose spec keeps float32 in a bf16 tree
F32_LEAVES = {"A_log", "dt_bias", "D", "lam", "router"}


def cfgs(name, **changes):
    base, extra = VARIANTS.get(name, (name, {}))
    cj = dataclasses.replace(jreg.ARCHS[base].reduced(),
                             **{**extra, **changes})
    return cj, torch_cfg(cj)


def keystr(path) -> str:
    """A port path as ``jax.tree_util.keystr`` prints it: dict keys as
    ``['k']``, list indices as ``[0]``."""
    return "".join(f"[{k!r}]" for k in path)


#: leaves initialized to zeros or ones (biases, norm scales, the SSM's
#: decay, step bias and skip, the RG-LRU gate biases)
CONSTANT_INITS = ("bq", "bk", "bv", "scale", "A_log", "dt_bias", "D", "b_a",
                  "b_i")


def perturb(tree, seed):
    """The leaves of :data:`CONSTANT_INITS` moved off their inits, so that
    the parity checks see them."""
    rng = np.random.default_rng(seed)

    def walk(node):
        items = sorted(node.items()) if isinstance(node, dict) else \
            enumerate(node)
        for key, sub in items:
            if isinstance(sub, (dict, list)):
                walk(sub)
            elif key in CONSTANT_INITS:
                node[key] = sub + (0.1 * rng.standard_normal(
                    sub.shape)).astype(np.float32)
    walk(tree)
    return tree


def jax_params(cj, tree, dtype="float32", defs=None):
    """A numpy tree as JAX arrays of ``dtype``, each leaf whose ``ParamDef``
    names a dtype in that one (the reference's ``init_params`` rule)."""
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    defs = jb.build_defs(cj) if defs is None else defs
    return jax.tree.map(
        lambda d, a: jnp.asarray(a).astype(jnp.dtype(d.dtype) if d.dtype
                                           else jdt),
        defs, tree, is_leaf=jpdefs.is_def)


def param_trees(cj, ct, seed=0, dtype="float32"):
    """(JAX params, port params) from one numpy tree."""
    tree = perturb(backbone_init_numpy(ct, seed), seed + 1)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    return jax_params(cj, tree, dtype), backbone_params_from_numpy(
        tree, ct, CPU, tdt)


def inputs(cfg, b, s, seed=1):
    rng = np.random.default_rng(seed)
    if cfg.frontend == "embed":
        return (rng.standard_normal((b, s, cfg.d_model)) * 0.3).astype(
            np.float32)
    return rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


# --- configs and definitions ---------------------------------------------------


def test_configs_and_cells_match_jax():
    assert list(treg.ARCHS) == list(jreg.ARCHS)
    assert treg.ASSIGNED == jreg.ASSIGNED
    for name, cj in jreg.ARCHS.items():
        ct = treg.get_arch(name)
        assert dataclasses.asdict(ct) == dataclasses.asdict(cj), name
        assert dataclasses.asdict(ct.reduced()) == \
            dataclasses.asdict(cj.reduced()), name
        assert ct.layer_kinds() == cj.layer_kinds()
        assert (ct.kv_dim, ct.d_inner, ct.ssm_nheads) == \
            (cj.kv_dim, cj.d_inner, cj.ssm_nheads)
        for active in (False, True):
            assert ct.param_count(active) == cj.param_count(active), name
    assert {k: dataclasses.asdict(v) for k, v in tbase.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}
    assert treg.get_shape("decode_32k").seq_len == 32768
    assert [(a.name, s.name, ok, why) for a, s, ok, why in treg.all_cells()] \
        == [(a.name, s.name, ok, why) for a, s, ok, why in jreg.all_cells()]
    with pytest.raises(KeyError, match="unknown arch"):
        treg.get_arch("nope")


@pytest.mark.parametrize("name", LM_ARCHS)
def test_defs_match_jax(name):
    """The same leaf paths (list indices included), shapes and dtype
    overrides as the reference's ``build_defs``, at full width; their
    sizes, norms, biases and SSM/RG-LRU scalars aside, are the config's
    ``param_count`` (not for MoE, whose count has no pad experts)."""
    cj, ct = jreg.ARCHS[name], treg.get_arch(name)
    want = {jax.tree_util.keystr(p): (d.shape, d.dtype) for p, d in
            jax.tree_util.tree_flatten_with_path(
                jb.build_defs(cj), is_leaf=jpdefs.is_def)[0]}
    got = {keystr(path): (spec.shape, spec.dtype and str(spec.dtype)[6:])
           for path, spec in tpdefs.walk(tb.build_defs(ct))}
    assert got == want
    defs = tb.build_defs(ct)
    assert tpdefs.param_count(defs) == jpdefs.param_count(jb.build_defs(cj))
    core = sum(int(np.prod(s.shape)) for p, s in tpdefs.walk(defs)
               if p[-1] not in ("scale", "bq", "bk", "bv", "A_log",
                                "dt_bias", "D", "lam"))
    assert ct.is_moe or core == ct.param_count()


@pytest.mark.parametrize("name", SSM_MOE_ARCHS[:3])
def test_bf16_tree_keeps_the_float32_leaves(name):
    """In a bf16 tree, exactly the SSM decays (A_log, dt_bias, D), the
    RG-LRU's lam and the MoE router stay float32, in both packages: the
    JAX package's own init, and the port's from numpy, cast in place and
    drawn on the device."""
    cj, ct = cfgs(name)
    pj = jb.init(cj, jax.random.PRNGKey(0), jnp.bfloat16)
    want = {jax.tree_util.keystr(p) for p, a in
            jax.tree_util.tree_flatten_with_path(pj)[0]
            if a.dtype == jnp.float32}
    assert want and {w.split("'")[-2] for w in want} <= F32_LEAVES
    defs = tb.build_defs(ct)
    tree = backbone_init_numpy(ct, 0)
    cast = backbone_params_from_numpy(tree, ct, CPU)
    tpdefs.cast_params_(defs, cast, torch.bfloat16)
    for params in (
            backbone_params_from_numpy(tree, ct, CPU, torch.bfloat16), cast,
            backbone_init_on_device(ct, 0, CPU)):
        got = {keystr(p) for p, x in flatten_with_paths(params)
               if x.dtype == torch.float32}
        assert got == want
        assert {x.dtype for x in leaves(params)} == {torch.float32,
                                                     torch.bfloat16}


def test_params_from_numpy_checks_every_leaf():
    cj, ct = cfgs("qwen2-vl-2b")
    tree = jax.tree.map(np.asarray, jax.jit(jb.init, static_argnums=0)(
        cj, jax.random.PRNGKey(0)))
    params = backbone_params_from_numpy(tree, ct, CPU)
    for path, spec in tpdefs.walk(tb.build_defs(ct)):
        assert tuple(tpdefs.get_path(params, path).shape) == spec.shape
    del tree["layers"]["attn"]["bq"]
    with pytest.raises(KeyError):
        backbone_params_from_numpy(tree, ct, CPU)
    tree = backbone_init_numpy(ct, 0)
    tree["embed"] = tree["embed"][:, :-1]
    with pytest.raises(ValueError, match="embed"):
        backbone_params_from_numpy(tree, ct, CPU)


# --- forward ---------------------------------------------------------------------


@pytest.mark.parametrize("name", LM_ARCHS + [TAIL])
def test_forward_matches_jax(name):
    """40 tokens: past mamba2's reduced chunk of 16 and ragged (the
    padding), the MoE aux loss within 1e-5."""
    cj, ct = cfgs(name)
    pj, pt = param_trees(cj, ct)
    x = inputs(cj, 2, 40)
    want, aux_j = jb.forward(pj, cj, jnp.asarray(x))
    with torch.no_grad():
        got, aux_t = tb.forward(pt, ct, torch.from_numpy(x))
    assert got.shape == (2, 40, cj.vocab_size) and got.dtype == torch.float32
    assert aux_t.dtype == torch.float32
    assert (float(aux_t) == float(aux_j) == 0.0) if not cj.is_moe else \
        rel_err(aux_t, aux_j) < 1e-5
    assert rel_err(got, want) < 1e-4


@pytest.mark.parametrize("name", ["qwen3-0.6b", "recurrentgemma-2b"])
def test_forward_bf16_matches_jax(name):
    """bf16 trees (the float32 leaves kept in both) through both packages:
    the logits within 2e-2."""
    cj, ct = cfgs(name)
    pj, pt = param_trees(cj, ct, dtype="bfloat16")
    x = inputs(cj, 2, 40)
    want, _ = jb.forward(pj, cj, jnp.asarray(x))
    with torch.no_grad():
        got, _ = tb.forward(pt, ct, torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    assert rel_err(got, want) < 2e-2


@pytest.mark.parametrize("name", ["mamba2-1.3b", "qwen2-moe-a2.7b"])
def test_forward_bf16_is_as_close_to_float32_as_jax(name):
    """mamba2 and MoE in bf16 (the float32 leaves kept in both): bf16
    rounding compounds over the layers (mamba2's gated SSD output, ~1% of
    its scale a layer) or flips top-k choices (MoE), so the reference's
    own bf16 logits sit 4% (mamba2) and 30% (MoE) of their scale from its
    float32 ones here, and no bf16 implementation meets 2e-2 of another.
    What holds: the port's bf16 logits are no further from the float32
    ones than the reference's, and agree with the reference's within
    that distance."""
    cj, ct = cfgs(name)
    x = inputs(cj, 2, 40)
    out = {}
    for dtype in ("float32", "bfloat16"):
        pj, pt = param_trees(cj, ct, dtype=dtype)
        with torch.no_grad():
            got, _ = tb.forward(pt, ct, torch.from_numpy(x))
        out[dtype] = got, jb.forward(pj, cj, jnp.asarray(x))[0]
    (t32, j32), (t16, j16) = out["float32"], out["bfloat16"]
    assert t16.dtype == torch.bfloat16 and rel_err(t32, j32) < 1e-4
    jax_err = rel_err(j16, j32)
    assert rel_err(t16, t32) < 1.5 * jax_err
    assert rel_err(t16, j16) < 1.5 * jax_err


# --- prefill + decode ----------------------------------------------------------------


def _decode_run(pkg, params, cfg, x, p0, cache):
    """prefill(x[:, :p0]) then decode x[p0:] one token at a time: (prefill
    logits, decode logits, final cache), as numpy."""
    if pkg == "jax":
        prefill = jax.jit(lambda p, x, c: jb.prefill(p, cfg, x, c,
                                                     last_only=False))
        decode = jax.jit(lambda p, x, c: jb.decode_step(p, cfg, x, c))
        wrap, cat = jnp.asarray, jnp.concatenate
    else:
        prefill = lambda p, x, c: tb.prefill(p, cfg, x, c, last_only=False)
        decode = lambda p, x, c: tb.decode_step(p, cfg, x, c)
        wrap, cat = torch.from_numpy, torch.cat
    with torch.no_grad():
        plog, cache = prefill(params, wrap(x[:, :p0]), cache)
        outs = []
        for t in range(p0, x.shape[1]):
            d, cache = decode(params, wrap(x[:, t:t + 1]), cache)
            outs.append(d)
    return to_np(plog), to_np(cat(outs, 1)), cache


@pytest.mark.parametrize("name", LM_ARCHS + [TAIL])
def test_prefill_then_decode_matches_jax(name):
    """The reference's prefill/decode test on both packages: prefill 20
    tokens (mamba2: a chunk and a padded one), decode 8; logits and every
    leaf of the final cache (the structure too: a hybrid's periods and
    tail) against the JAX pair (1e-4; indices exact), and the decode
    logits against the JAX full forward."""
    cj, ct = cfgs(name)
    pj, pt = param_trees(cj, ct)
    b, s, p0 = 2, 28, 20
    x = inputs(cj, b, s, seed=2)
    pl_j, dl_j, cache_j = _decode_run(
        "jax", pj, cj, x, p0, jb.init_cache(cj, b, s, jnp.float32))
    cache_t = tb.init_cache(ct, b, s, torch.float32, CPU)
    pl_t, dl_t, cache_t2 = _decode_run("torch", pt, ct, x, p0, cache_t)
    assert cache_t2 is cache_t                       # written in place
    assert rel_err(pl_t, pl_j) < 1e-4
    assert rel_err(dl_t, dl_j) < 1e-4
    flat_j = jax.tree_util.tree_flatten_with_path(cache_j)[0]
    flat_t = flatten_with_paths(cache_t)
    assert [keystr(p) for p, _ in flat_t] == \
        [jax.tree_util.keystr(p) for p, _ in flat_j]
    for (path, got), (_, want) in zip(flat_t, flat_j):
        assert got.dtype == getattr(torch, str(want.dtype)), path
        if path[-1] == "index":
            np.testing.assert_array_equal(to_np(got), np.asarray(want))
        else:
            assert rel_err(got, want) < 1e-4, path
    assert int(tb.cache_index(ct, cache_t)) == s
    ref, _ = jb.forward(pj, cj, jnp.asarray(x))
    assert rel_err(dl_t, np.asarray(ref)[:, p0:]) < 1e-4


def test_swa_ring_buffer_long_decode():
    """Decode far past the window (the reference's ring-buffer test on the
    port): a 64-slot cache, 160 tokens, against the JAX full forward."""
    cj, ct = cfgs("h2o-danube-3-4b")
    assert ct.window_size == 64
    pj, pt = param_trees(cj, ct, seed=3)
    x = inputs(cj, 1, 160, seed=4)
    cache = tb.init_cache(ct, 1, 160, torch.float32, CPU)
    assert cache["k"].shape == (ct.num_layers, 1, 64, 2, 32)
    _, dec, _ = _decode_run("torch", pt, ct, x, 8, cache)
    ref, _ = jb.forward(pj, cj, jnp.asarray(x))
    assert rel_err(dec, np.asarray(ref)[:, 8:]) < 1e-4
    assert int(cache["index"][0]) == 160


def test_int8_cache_matches_jax():
    """The int8 cache on qwen3 (qk-norm): prefill + decode against the JAX
    pair.  The int8 values may differ by one where x / scale sits at a
    rounding tie (a float32 ulp apart in the two packages); the logits
    agree within 1e-3 of their scale."""
    cj, ct = cfgs("qwen3-0.6b", kv_quant=True)
    pj, pt = param_trees(cj, ct, seed=5)
    b, s, p0 = 2, 24, 16
    x = inputs(cj, b, s, seed=6)
    cache_t = tb.init_cache(ct, b, s, torch.float32, CPU)
    assert cache_t["k"].dtype == torch.int8
    assert cache_t["k_scale"].shape == (ct.num_layers, b, s, 2)
    pl_j, dl_j, cache_j = _decode_run(
        "jax", pj, cj, x, p0, jb.init_cache(cj, b, s, jnp.float32))
    pl_t, dl_t, _ = _decode_run("torch", pt, ct, x, p0, cache_t)
    assert rel_err(pl_t, pl_j) < 1e-4       # prefill attends unquantized
    assert rel_err(dl_t, dl_j) < 1e-3
    for key in ("k", "v"):
        diff = np.abs(to_np(cache_t[key]).astype(np.int32)
                      - np.asarray(cache_j[key]).astype(np.int32))
        assert diff.max() <= 1 and np.mean(diff) < 1e-3, key
        assert rel_err(cache_t[f"{key}_scale"], cache_j[f"{key}_scale"]) \
            < 1e-5


def test_quantize_roundtrip_error_bound():
    """The reference's bound on the port's quantizer: error <= scale/2."""
    k = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 24, 4, 64)).astype(np.float32))
    q8, s8 = tattn._quantize_kv(k)
    err = (tattn._dequantize_kv(q8, s8, torch.float32) - k).abs()
    bound = k.abs().amax(-1, keepdim=True) / 127.0 * 0.51 + 1e-6
    assert bool((err <= bound).all())
    jq, js = jattn._quantize_kv(jnp.asarray(k.numpy()))
    assert rel_err(s8, js) < 1e-6
    assert np.abs(q8.numpy().astype(int) - np.asarray(jq).astype(int)).max() \
        <= 1


# --- blocked attention -------------------------------------------------------------


@pytest.mark.parametrize("name", ATTN_ARCHS)
def test_blocked_attention_matches_jax(name, monkeypatch):
    """With the blocked path's threshold and block made small in both
    packages (16 and 8), a 100-token forward (a ragged last block; past
    the reduced SWA window of 64) and a prefill of it against the JAX
    package's, and against the port's own dense path."""
    cj, ct = cfgs(name)
    pj, pt = param_trees(cj, ct, seed=7)
    x = inputs(cj, 1, 100, seed=8)
    with torch.no_grad():
        dense, _ = tb.forward(pt, ct, torch.from_numpy(x))
    for mod in (jattn, tattn):
        monkeypatch.setattr(mod, "BLOCKED_ATTN_THRESHOLD", 16)
        monkeypatch.setattr(mod, "KV_BLOCK", 8)
    want, _ = jb.forward(pj, cj, jnp.asarray(x))
    with torch.no_grad():
        got, _ = tb.forward(pt, ct, torch.from_numpy(x))
        cache = tb.init_cache(ct, 1, 104, torch.float32, CPU)
        plog, _ = tb.prefill(pt, ct, torch.from_numpy(x), cache)
    assert rel_err(got, want) < 1e-4
    assert rel_err(got, dense) < 1e-4
    assert rel_err(plog[:, 0], np.asarray(want)[:, -1]) < 1e-4
    assert int(cache["index"][0]) == 100


@pytest.mark.parametrize("window", [0, 24])
def test_blocked_attention_bf16_dtypes_match_jax(window):
    """bf16 q, k, v through both packages' blocked path (8-key blocks, a
    ragged last one): QK^T of bf16 values summed in float32, P rounded to
    bf16 for P.V.  Keeping P in float32 instead moves the output by ~9e-4
    of its scale here, so the 1e-5 bound holds the rounding itself."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((2, 100, 4, 32)).astype(np.float32)
               for _ in range(3))
    pos = np.broadcast_to(np.arange(100, dtype=np.int32), (2, 100)).copy()
    kw = dict(window=window, causal=True, kv_block=8)
    want = jattn._blocked_attention(
        *(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)),
        jnp.asarray(pos), jnp.asarray(pos), **kw)
    tpos = torch.from_numpy(pos)
    got = tattn._blocked_attention(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
        tpos, tpos, **kw)
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    assert rel_err(got, want) < 1e-5


def test_blocked_attention_bf16_matches_jax(monkeypatch):
    """qwen3-0.6b in bf16 with the blocked path's threshold and block made
    small in both packages (16 and 8): a 100-token forward's logits
    against the JAX package's, at the bf16 tolerance."""
    cj, ct = cfgs("qwen3-0.6b")
    pj, pt = param_trees(cj, ct, seed=7, dtype="bfloat16")
    x = inputs(cj, 1, 100, seed=8)
    for mod in (jattn, tattn):
        monkeypatch.setattr(mod, "BLOCKED_ATTN_THRESHOLD", 16)
        monkeypatch.setattr(mod, "KV_BLOCK", 8)
    want, _ = jb.forward(pj, cj, jnp.asarray(x))
    with torch.no_grad():
        got, _ = tb.forward(pt, ct, torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    assert rel_err(got, want) < 2e-2
