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
* LM and train cells on a production mesh are written ``skipped`` with
  their ROADMAP item; one-card records say "one-card"; ``main --mesh
  single`` and ``--mesh both`` write the production records.
"""
from __future__ import annotations

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
    for arch, shape in (("qwen3-0.6b", "prefill_32k"),
                        ("mamba2-1.3b", "decode_32k")):
        rec = D.run_cell(arch, shape, mesh_label="single", verbose=False)
        assert rec["status"] == "skipped" and rec["mesh"] == "single"
        assert S.LM_MESH_ITEM in rec["reason"]
    rec = D.run_cell("dit-xl", "train_4k", mesh_label="multi",
                     verbose=False)
    assert rec["status"] == "skipped" and S.TRAIN_MESH_ITEM in rec["reason"]
    lm = get_arch("qwen3-0.6b").reduced()
    with fake_mesh("pod", data_parallel=2, model_parallel=2) as mesh:
        with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
            S.abstract_model_state(lm, mesh=mesh)
        with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
            S.abstract_cache(lm, S.ShapeConfig("t", 16, 2, "decode"),
                             mesh=mesh)
    rec = D._error("dit-xl", "parataa_serve", ValueError("x"))
    assert rec["mesh"] == "one-card"


def test_main_writes_the_production_records(tmp_path, monkeypatch):
    """``--all --mesh single`` at full width: the ParaTAA record on 256
    ranks, every other cell skipped; the report renders it.  ``--parataa
    --mesh both`` starts one process a production mesh (run in this one
    here, in turn: each its own fake world)."""
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

    from repro_torch.roofline import report

    D.main(["--all", "--mesh", "single", "--out", str(tmp_path)])
    recs = [json.loads(p.read_text()) for p in tmp_path.glob("*.json")]
    assert all(r["mesh"] == "single" for r in recs)
    ok = [r for r in recs if r["status"] == "ok"]
    assert [r["shape"] for r in ok] == ["parataa_serve"]
    assert ok[0]["chips"] == 256 and ok[0]["n_samples"] == 16
    assert ok[0]["collective_breakdown"]["all-reduce"] > 0
    assert ok[0]["collective_by_link"]["network"] > 0
    assert all(r["status"] == "skipped" for r in recs if r not in ok)
    table = report.render(str(tmp_path), "single")
    assert "256 H100s" in table and "| dit-xl | parataa_serve |" in table

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

