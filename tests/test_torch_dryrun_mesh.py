"""The dry-run on the production meshes, in a ``fake`` world on ``meta``
(``launch.mesh.fake_mesh``: this process is rank 0, collectives move
nothing and are counted), at reduced size and at DiT-XL's width.

* The tensor-parallel DiT's product FLOPs summed over the ``model``
  group's ranks equal the unsharded count exactly, but for the four
  projections whose specs put nothing on ``model`` (in_proj, t_mlp1,
  t_mlp2, out_proj), which every model rank runs whole.
* A rank's parameter bytes (``steps.abstract_model_state(mesh=)``) are
  the full tree's over the blocks the reference's ``resolve_spec`` cuts
  it into (over data × model where both divide).
* The ParaTAA record on registry-shaped meshes: ``chips``, the FSDP
  axes against the reference's ``resolve_spec``, all-reduce and
  all-gather bytes equal to the formula, the link tier of each group.
* LM prefill, decode and train cells and the DiT's train cell on a
  production mesh are rank 0's tensor-parallel program (``ok``; a train
  cell's collectives the train step's formula); one-card records say
  "one-card"; ``main --mesh single`` and ``--mesh both`` write the
  production records.
* The LM backbones' product FLOPs summed over the ``model`` group equal
  the unsharded count, but for the products by leaves whose specs put
  nothing on ``model`` (the MoE router, mamba2's ``in_B``/``in_C`` and
  the C·Bᵀ products of their outputs, ``wk``/``wv`` where the KV heads do
  not divide); a rank's parameter and cache bytes are the full tree's
  over the blocks of the reference's ``resolve_spec`` and
  ``_cache_spec_for``.
* ``backbone.partial_leaves``, the leaves held whole over ``model``
  whose train-step gradients are each rank's partial, by arch, rows and
  model size.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.diffusion import dit
from repro_torch.launch import dryrun as D
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import fake_mesh
from repro_torch.models import pdefs
from repro_torch.models.shardctx import ShardedParams
from repro_torch.roofline import analysis as RA
from repro_torch.roofline.counter import CostCounter
from repro_torch.sampling import Placement
from repro_torch.tree import leaves

META = torch.device("meta")


def _params(cfg):
    return S.abstract_model_state(cfg, with_opt=False,
                                  dtype=torch.float32)[0]


def _dit_flops(params, cfg, B: int, N: int) -> int:
    x = torch.empty((B, N, cfg.latent_dim), device=META)
    t = torch.empty((B,), device=META)
    y = torch.zeros((B,), dtype=torch.long, device=META)
    with torch.no_grad(), CostCounter() as counter:
        dit.dit_apply(params, cfg, x, t, y)
    return counter.flops


@pytest.mark.parametrize("full_width", [False, True],
                         ids=["reduced", "dit-xl"])
def test_tp_flops_summed_over_model_equal_the_unsharded_count(full_width):
    cfg = get_arch("dit-xl") if full_width else get_arch("dit-xl").reduced()
    d, lat = cfg.d_model, cfg.latent_dim
    B, N = 4, (256 if full_width else 16)
    model = 16 if full_width else 4
    host = _dit_flops(_params(cfg), cfg, B, N)
    with fake_mesh("pod", data_parallel=2, model_parallel=model) as mesh:
        tp = ShardedParams.build(_params(cfg), dit.dit_defs(cfg), mesh)
        rank0 = _dit_flops(tp, cfg, B, N)
    # in_proj, out_proj, t_mlp1, t_mlp2: replicated over model
    whole = 2 * B * N * lat * d * 2 + 2 * B * (dit.TEMB_DIM * d + d * d)
    assert model * (rank0 - whole) + whole == host
    assert rank0 < host / model * 1.1


def _reference_specs(cfg, shape, axes):
    from repro.configs.registry import ARCHS as JARCHS
    from repro.diffusion import dit as jdit
    from repro.models import pdefs as jpdefs
    from tests.test_torch_placement import GridMesh
    from tests.test_torch_pdefs_specs import _jax_leaves

    jcfg = JARCHS["dit-xl"]
    if cfg.num_layers != jcfg.num_layers:
        jcfg = jcfg.reduced()
    grid = GridMesh(shape, axes)
    return {path: tuple(jpdefs.resolve_spec(leaf, grid)) for path, leaf in
            _jax_leaves(jdit.dit_defs(jcfg)).items()}


@pytest.mark.parametrize("name,sizes,full_width", [
    ("multi-pod", dict(data_parallel=2, model_parallel=2), False),
    ("pod", {}, True)], ids=["multi-pod-2x2x2-reduced", "pod-dit-xl"])
def test_rank_param_bytes_are_the_tree_over_its_blocks(name, sizes,
                                                       full_width):
    cfg = get_arch("dit-xl") if full_width else get_arch("dit-xl").reduced()
    defs = dit.dit_defs(cfg)
    full = {path: spec for path, spec in pdefs.walk(defs)}
    with fake_mesh(name, **sizes) as mesh:
        shape = tuple(int(n) for n in mesh.mesh.shape)
        want = _reference_specs(cfg, shape, mesh.mesh_dim_names)
        local = S.abstract_model_state(cfg, with_opt=False,
                                       dtype=torch.float32, mesh=mesh)[0]
        sizes_of = dict(zip(mesh.mesh_dim_names, shape))
        total = 0
        assert isinstance(local, ShardedParams)
        for (path, spec), leaf in zip(pdefs.walk(defs), leaves(local.local)):
            entries = pdefs.resolve_spec(spec, mesh)
            assert entries == want["/".join(map(str, path))], path
            blocks = int(np.prod([sizes_of[a] for e in entries
                                  for a in pdefs.entry_axes(e)]))
            assert leaf.numel() * blocks == int(np.prod(spec.shape)), path
            assert leaf.device.type == "meta"
            total += leaf.numel() * 4
    full_bytes = sum(int(np.prod(s.shape)) * 4 for s in full.values())
    data_model = int(np.prod(shape))
    # every leaf has embed over the data axes; heads/mlp/cond over model
    assert full_bytes / data_model <= total <= full_bytes / (
        data_model // sizes_of["model"])
    if full_width:
        # DiT-XL on pod: a leaf split over model is 1/256 a rank, one with
        # only embed rows (the four projections, y_embed) 1/16
        blocks = sum(int(np.prod(s.shape)) * 4 for p, s in full.items()
                     if "model" not in str(want["/".join(map(str, p))]))
        assert total == (full_bytes - blocks) // 256 + blocks // 16


def _formula_bytes(rec_cfg, plc, lanes: int, window: int, n_tok: int,
                   local_tree) -> dict:
    """Collective bytes of one mesh iteration: 2L all-reduces of the
    (lanes·window, N, d) float32 partials + the poll's int32 flag; the
    adaLN all-gathers over model (each rank's 6d/m, and 2d/m, columns of
    lanes·window rows) + every leaf's block, gathered over the data axes
    (a stacked leaf layer by layer, a block's leaves together: its whole
    block)."""
    cfg, m = rec_cfg, plc.model_shards
    rows = lanes * window
    d, L = cfg.d_model, cfg.num_layers
    all_reduce = 2 * L * rows * n_tok * d * 4 + 4
    ada = L * rows * (6 * d // m) * 4 + rows * (2 * d // m) * 4
    fsdp = sum(x.numel() * 4 for x in leaves(local_tree))
    return {"all-reduce": all_reduce, "all-gather": ada + fsdp}


@pytest.mark.parametrize("name,sizes,tiers", [
    ("pod", dict(data_parallel=2, model_parallel=2), {"nvlink"}),
    ("multi-pod", dict(data_parallel=2, model_parallel=2), {"nvlink"}),
    ("pod", dict(data_parallel=4, model_parallel=4), {"nvlink", "network"})],
    ids=["pod-2x2", "multi-pod-2x2x2", "pod-4x4"])
def test_parataa_record_on_registry_shaped_meshes(name, sizes, tiers):
    from repro.sampling import Placement as JPlacement
    from tests.test_torch_placement import GridMesh

    cfg = get_arch("dit-xl").reduced()
    with fake_mesh(name, **sizes) as mesh:
        shape = tuple(int(n) for n in mesh.mesh.shape)
        rec = D.run_parataa_cell(mesh=mesh, mesh_label=name, reduced=True,
                                 verbose=False)
        local = S.abstract_model_state(cfg, with_opt=False,
                                       dtype=torch.float32, mesh=mesh)[0]
        plc = Placement.for_mesh(mesh)
    want_plc = JPlacement.for_mesh(GridMesh(shape, mesh.mesh_dim_names))
    assert rec["status"] == "ok" and rec["chips"] == int(np.prod(shape))
    assert rec["n_samples"] == want_plc.round_batch(16)
    assert rec["placement"] == want_plc.describe().replace(
        "denoiser over", "denoiser TP-sharded over")
    lanes = rec["n_samples"] // plc.data_shards
    want = _formula_bytes(cfg, plc, lanes, 64, 32, local.local)
    assert rec["collective_breakdown"] == want, (rec["collective_breakdown"],
                                                 want)
    L = cfg.num_layers
    # a block's leaves in one flat FSDP all-gather, the top-level leaves
    # in another; one adaLN all-gather a block and one for final_ada
    assert rec["collective_counts"] == {"all-gather": 2 * (L + 1),
                                        "all-reduce": 2 * L + 1}
    by_link = rec["collective_by_link"]
    assert {t for t, n in by_link.items() if n} == tiers
    assert sum(by_link.values()) == sum(want.values())
    assert rec["collective_s"] == pytest.approx(
        by_link["nvlink"] / RA.LINK_BW + by_link["network"] / RA.NETWORK_BW)
    assert rec["model_flops_ratio"] == pytest.approx(
        rec["model_flops_global"] / (rec["flops_per_chip"] * rec["chips"]))
    assert "modeled, not measured" in rec["collective_model"]


def test_link_tiers_follow_eight_rank_nodes():
    assert RA.link_of(range(8)) == "nvlink"
    assert RA.link_of([0, 8]) == "network"
    assert RA.link_of(range(16, 24)) == "nvlink"
    got = RA.link_bytes({("all-reduce", (0, 1)): 10,
                         ("all-gather", (0, 16)): 7,
                         ("all-gather", (3,)): 1})
    assert got == {"nvlink": 11, "network": 7}
    terms = RA.roofline_terms(1.0, 1.0, 18.0, by_link=got)
    assert terms.collective_s == pytest.approx(11 / 450e9 + 7 / 50e9)
    assert RA.roofline_terms(1.0, 1.0, 18.0).collective_s == 18 / 450e9


def test_lm_and_train_cells_wait_on_production_meshes():
    """LM prefill and decode cells, and the LM's and the DiT's train_4k
    cells, are priced on fake pod and multi-pod worlds (reduced widths,
    short LM shapes): ``ok``, rank 0's train step with its collectives
    by the train formula (``backbone``/``dit.tp_train_collectives``);
    ``abstract_*(mesh=)`` give an LM's rank blocks."""
    from repro_torch.models import backbone as B

    for name, sizes, label in (("pod", dict(data_parallel=2,
                                             model_parallel=2), "single"),
                               ("multi-pod", dict(data_parallel=2,
                                                  model_parallel=2),
                                "multi")):
        with fake_mesh(name, **sizes) as mesh:
            chips = int(np.prod(tuple(int(n) for n in mesh.mesh.shape)))
            for arch, shape in (("qwen3-0.6b", S.ShapeConfig(
                    "prefill_64", 64, 8, "prefill")), ("mamba2-1.3b",
                    S.ShapeConfig("decode_64", 64, 8, "decode"))):
                rec = D.run_cell(arch, shape, cfg=get_arch(arch).reduced(),
                                 mesh_label=label, mesh=mesh, verbose=False)
                assert rec["status"] == "ok" and rec["mesh"] == label
                assert rec["chips"] == chips and rec["fits_hbm"]
                assert rec["collective_breakdown"]["all-reduce"] > 0
                assert sum(rec["collective_by_link"].values()) == \
                    rec["collective_bytes_per_chip"]
                assert "modeled, not measured" in rec["collective_model"]
            lm = dataclasses.replace(get_arch("qwen3-0.6b").reduced(),
                                     num_layers=2)
            ditr = dataclasses.replace(get_arch("dit-xl").reduced(),
                                       num_layers=2)
            train = S.ShapeConfig("train_256", 256, 16, "train")
            for arch, cfg, want in (
                    ("qwen3-0.6b", lm, B.tp_train_collectives(
                        lm, 2, 2, 256, lm.train_grad_accum)),
                    ("dit-xl", ditr, dit.tp_train_collectives(ditr, 2, 2))):
                rec = D.run_cell(arch, train, cfg=cfg,
                                 mesh_label=label, mesh=mesh, verbose=False)
                assert rec["status"] == "ok" and rec["chips"] == chips
                assert rec["fits_hbm"] and rec["flops_per_chip"] > 0
                assert rec["collective_counts"] == {
                    k: v for k, v in want.items() if v}, (arch, rec)
                assert sum(rec["collective_by_link"].values()) == \
                    rec["collective_bytes_per_chip"]
            params, _ = S.abstract_model_state(lm, with_opt=False,
                                               mesh=mesh)
            assert isinstance(params, ShardedParams)
            assert params["layers"]["attn"]["wq"].shape[2] == 2
            cache = S.abstract_cache(lm, S.ShapeConfig("t", 16, 4,
                                                       "decode"), mesh=mesh)
            assert cache["k"].shape[3] == 1 and cache["k"].device == META
    with pytest.raises(ValueError, match="needs its DeviceMesh"):
        D.run_cell("dit-xl", "train_4k", mesh_label="multi", verbose=False)
    rec = D._error("dit-xl", "parataa_serve", ValueError("x"))
    assert rec["mesh"] == "one-card"


def test_main_writes_the_production_records(tmp_path, monkeypatch):
    """``--all --mesh single``: the ParaTAA record on 256 ranks at full
    width (2 of DiT-XL's layers), dit-xl's train_4k cell the same on a
    batch of 64, and
    every LM prefill/decode/train cell that its arch supports (at reduced
    widths and depths, 256-token prefills and 256-token batches of 64
    here: the full-width ``--all`` takes minutes) ``ok``, every other cell skipped
    as its arch does not support it; ``--arch``/``--shape`` take lists;
    the report renders them.  ``--parataa --mesh both`` starts one
    process a production mesh (run in this one here, in turn: each its
    own fake world)."""
    import subprocess
    import sys

    started = []

    class InProcess:
        def __init__(self, argv):
            started.append(argv)
            assert argv[:3] == [sys.executable, "-m",
                                "repro_torch.launch.dryrun"]
            self.argv = argv[3:]

        def wait(self):
            D.main(self.argv)
            return 0

    from repro_torch.configs.base import SHAPES
    from repro_torch.configs.registry import ASSIGNED
    from repro_torch.roofline import report

    full, shapes = D.get_arch, D.get_shape

    def arch(name):             # 2 layers (a hybrid: one period)
        cfg = full(name) if name == "dit-xl" else full(name).reduced()
        return dataclasses.replace(cfg, num_layers=cfg.rglru_ratio
                                   if cfg.is_hybrid else 2)
    monkeypatch.setattr(D, "get_arch", arch)
    # the prefills and train batches at 256 tokens, 64 rows a train batch
    # (their cost on meta grows with both; which arch supports which
    # shape does not)
    monkeypatch.setattr(D, "get_shape", lambda name: dataclasses.replace(
        shapes(name), seq_len=256) if shapes(name).kind == "prefill"
        else dataclasses.replace(shapes(name), seq_len=256, global_batch=64)
        if shapes(name).kind == "train" else shapes(name))
    D.main(["--all", "--mesh", "single", "--out", str(tmp_path)])
    recs = [json.loads(p.read_text()) for p in tmp_path.glob("*.json")]
    assert all(r["mesh"] == "single" for r in recs)
    ok = [r for r in recs if r["status"] == "ok"]
    par = [r for r in ok if r["shape"] == "parataa_serve"]
    assert len(par) == 1
    assert par[0]["chips"] == 256 and par[0]["n_samples"] == 16
    assert par[0]["collective_breakdown"]["all-reduce"] > 0
    assert par[0]["collective_by_link"]["network"] > 0
    want = {(a, s) for a in ASSIGNED for s, shape in SHAPES.items()
            if full(a).supports_shape(shape)[0]} | {("dit-xl", "train_4k")}
    assert {(r["arch"], r["shape"]) for r in ok if r not in par} == want
    assert any(SHAPES[s].kind == "train" for a, s in want if a != "dit-xl")
    assert all(r["chips"] == 256 for r in ok)
    # what is skipped is a shape its arch does not support: never a
    # supported cell
    for r in recs:
        if r not in ok:
            assert r["status"] == "skipped", r
            assert not full(r["arch"]).supports_shape(SHAPES[r["shape"]])[0]
    table = report.render(str(tmp_path), "single")
    assert "256 H100s" in table and "| dit-xl | parataa_serve |" in table
    assert "| qwen3-0.6b | decode_32k |" in table
    assert "| dit-xl | train_4k |" in table
    from types import SimpleNamespace

    cells = D._cells(SimpleNamespace(all=False, parataa=False,
                                     arch="qwen3-0.6b,dit-xl",
                                     shape="decode_32k,train_4k"))
    assert cells == [("qwen3-0.6b", "decode_32k"), ("qwen3-0.6b", "train_4k"),
                     ("dit-xl", "decode_32k"), ("dit-xl", "train_4k")]

    both = tmp_path / "both"
    monkeypatch.setattr(subprocess, "Popen", InProcess)
    D.main(["--parataa", "--mesh", "both", "--out", str(both)])
    assert [a[-2:] for a in started] == [["--mesh", "single"],
                                         ["--mesh", "multi"]]
    got = {json.loads(p.read_text())["mesh"]: json.loads(p.read_text())
           for p in both.glob("*.json")}
    assert sorted(got) == ["multi", "single"]
    assert (got["single"]["chips"], got["multi"]["chips"]) == (256, 512)
    assert got["multi"]["n_samples"] == 32
    assert all(r["status"] == "ok" for r in got.values())



# --- the LM backbones on the production meshes ------------------------------------


def _lm_flops(cfg, shape, mesh=None) -> int:
    cost, _ = D.cell_cost(cfg, shape, mesh=mesh)
    return int(cost.flops)


def _whole_flops(cfg, kind: str, b: int, s: int) -> int:
    """Product FLOPs (a batch of ``b`` rows of ``s`` tokens) that every
    model rank runs whole: the products by leaves whose specs put nothing
    on ``model`` in this cell."""
    d, L = cfg.d_model, cfg.num_layers
    t = b * (1 if kind == "decode" else s)
    if cfg.is_ssm:           # in_B, in_C; the chunks' C·Bᵀ products
        gn = cfg.ssm_ngroups * cfg.ssm_state
        per = 2 * 2 * t * d * gn
        if kind != "decode":
            q = min(cfg.ssm_chunk, s)
            per += 2 * b * (s // q) * cfg.ssm_ngroups * q * q \
                * cfg.ssm_state
        return L * per
    whole = 0
    if cfg.is_moe:                                   # the router
        from repro_torch.models.moe import padded_experts

        whole += L * 2 * t * d * padded_experts(cfg)
    if cfg.tp_strategy == "heads" and cfg.num_kv_heads % 4:
        whole += L * 2 * 2 * t * d * cfg.num_kv_heads * cfg.head_dim
    return whole


@pytest.mark.parametrize("arch,kind", [
    ("qwen3-0.6b", "prefill"), ("qwen3-0.6b", "decode"),
    ("recurrentgemma-2b", "prefill"), ("mamba2-1.3b", "prefill"),
    ("qwen2-moe-a2.7b", "prefill"), ("qwen2-72b", "prefill")])
def test_lm_tp_flops_summed_over_model_equal_the_unsharded_count(arch,
                                                                kind):
    """Rank 0 of (data 2, model 4) on a fake pod: its product FLOPs, but
    for the products every model rank runs whole, times 4 and times the 2
    data shards, are the one-card cell's exactly."""
    cfg = get_arch(arch).reduced()
    shape = S.ShapeConfig(kind, 64, 4, kind)
    host = _lm_flops(cfg, shape)
    with fake_mesh("pod", data_parallel=2, model_parallel=4) as mesh:
        rank0 = _lm_flops(cfg, shape, mesh)
    whole = _whole_flops(cfg, kind, 2, 64)
    assert 2 * (4 * (rank0 - whole) + whole) == host, (rank0, whole, host)
    assert rank0 < host / 8 * 1.5


@pytest.mark.parametrize("name,sizes", [
    ("pod", dict(data_parallel=2, model_parallel=4)),
    ("multi-pod", dict(data_parallel=2, model_parallel=2))],
    ids=["pod-2x4", "multi-pod-2x2x2"])
def test_lm_rank_param_and_cache_bytes_are_the_reference_blocks(name,
                                                                 sizes):
    """Every LM arch (reduced): each leaf of a rank's params
    (``abstract_model_state(mesh=)``; the RG-LRU gates by their
    block-diagonal layout) and of its cache (``abstract_cache(mesh=)``)
    holds the full leaf's elements over the blocks of the reference's
    ``resolve_spec`` / ``_cache_spec_for``."""
    from repro.configs.registry import ARCHS as JARCHS
    from repro.launch.steps import _cache_spec_for as jcache_spec
    from repro.models import backbone as jb
    from repro.models import pdefs as jpdefs
    from repro_torch.configs.registry import ASSIGNED
    from repro_torch.models import backbone as tb
    from repro_torch.tree import flatten_with_paths, path_name
    from tests.test_torch_pdefs_specs import _jax_leaves
    from tests.test_torch_placement import GridMesh

    shape = S.ShapeConfig("d", 64, 8, "decode")
    with fake_mesh(name, **sizes) as mesh:
        dims = tuple(int(n) for n in mesh.mesh.shape)
        grid = GridMesh(dims, mesh.mesh_dim_names)
        sizes_of = dict(zip(mesh.mesh_dim_names, dims))

        def blocks(spec):
            return int(np.prod([sizes_of[a] for e in spec
                                for a in pdefs.entry_axes(e)]))

        for arch in ASSIGNED:
            cfg = get_arch(arch).reduced()
            jcfg = JARCHS[arch].reduced()
            want = {p: tuple(jpdefs.resolve_spec(leaf, grid)) for p, leaf
                    in _jax_leaves(jb.build_defs(jcfg)).items()}
            local = S.abstract_model_state(cfg, with_opt=False, mesh=mesh)[0]
            for (path, spec), leaf in zip(pdefs.walk(tb.build_defs(cfg)),
                                          leaves(local.local)):
                key = "/".join(map(str, path))
                assert local.specs[key] == want[key], (arch, key)
                assert leaf.numel() * blocks(want[key]) == \
                    int(np.prod(spec.shape)), (arch, key)
            cache = S.abstract_cache(cfg, shape, mesh=mesh)
            whole = tb.init_cache(cfg, 8, 64, torch.bfloat16, META)
            for (path, w), (_, leaf) in zip(flatten_with_paths(whole),
                                            flatten_with_paths(cache.local)):
                key = path_name(path)
                stacked = not cfg.is_hybrid or "periods" in key
                if key.endswith("index"):
                    spec = (None,) * w.dim()
                elif stacked:
                    spec = (None,) + tuple(jcache_spec(key, w.shape[1:],
                                                       grid))
                else:
                    spec = tuple(jcache_spec(key, w.shape, grid))
                assert cache.specs[key] == spec, (arch, key)
                assert leaf.numel() * blocks(spec) == w.numel(), (arch, key)


_ATTN_QKV = ["layers/attn/" + k for k in ("wq", "wk", "wv", "wo")]
_MAMBA_BC = ["layers/mamba/" + k for k in ("conv_B", "conv_C", "in_B",
                                           "in_C", "norm/scale")]


@pytest.mark.parametrize("arch,model,s,want", [
    # heads: the whole leaves of the split attention
    ("qwen3-0.6b", 2, 16, ["layers/attn/k_norm/scale",
                           "layers/attn/q_norm/scale"]),
    # seq_parallel: every whole leaf sees the rank's rows
    ("qwen2-72b", 2, 16, ["final_norm/scale", "layers/norm1/scale",
                          "layers/norm2/scale"]),
    # rows the model axis does not divide: no split, and no whole leaf
    # beside a split one
    ("qwen2-72b", 2, 15, []),
    # hidden: context-parallel attention, whole weights on the rank's rows
    ("qwen2-vl-2b", 2, 16, ["final_norm/scale", "layers/attn/bk",
                            "layers/attn/bq", "layers/attn/bv",
                            "layers/norm1/scale", "layers/norm2/scale"]
     + _ATTN_QKV),
    # mamba2: B/C projections, their convolutions and the gated norm
    ("mamba2-1.3b", 2, 15, _MAMBA_BC),
    ("mamba2-1.3b", 2, 16, _MAMBA_BC + ["final_norm/scale",
                                        "layers/norm/scale"]),
    # the MoE router beside the split experts
    ("qwen2-moe-a2.7b", 2, 16, ["layers/moe/router"]),
    # every leaf of a sublayer split, nothing beside it
    ("granite-8b", 2, 16, []),
    # one model rank: nothing is partial
    ("qwen2-vl-2b", 1, 16, []),
], ids=lambda v: str(v) if not isinstance(v, list) else f"{len(v)}")
def test_partial_leaves_are_the_whole_leaves_beside_a_split(arch, model, s,
                                                           want):
    """``backbone.partial_leaves`` (the whole leaves the gradient sync
    all-reduces over ``model``) at reduced widths on a fake (1, model)
    mesh: under a row split every leaf held whole over ``model``; else
    the whole leaves of each sublayer whose leaves split (the gradient
    parity of the train step on gloo ranks holds the rule itself:
    ``tests/test_torch_tp_train.py``)."""
    from repro_torch.models import backbone as B

    cfg = get_arch(arch).reduced()
    with fake_mesh("debug", data_parallel=1, model_parallel=model) as mesh:
        params, _ = S.abstract_model_state(cfg, with_opt=False, mesh=mesh)
        assert B.partial_leaves(cfg, params, s) == set(want)
        assert S.partial_leaves(get_arch("dit-xl").reduced(), params,
                                s) == set()
