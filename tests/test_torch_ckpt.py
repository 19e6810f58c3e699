"""Port parity for checkpoints: the port's ``repro_torch.ckpt`` against the
JAX package's ``repro.ckpt`` — the same on-disk format, so each restores
the other's checkpoints exactly — plus the counterparts of the reference's
own checkpoint tests (round trip, host stripes, async keep/GC, atomic)."""
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import CheckpointManager as JManager
from repro.ckpt import load_pytree as jload
from repro.ckpt import save_pytree as jsave
from repro_torch.ckpt import CheckpointManager, load_pytree, save_pytree
from repro_torch.ckpt import checkpoint as tckpt
from repro_torch.tree import flatten_with_paths, path_name
from tests.test_torch_helpers import to_np


def _tree():
    """A param-and-state-shaped tree: f32, bf16, a 0-d int32 and a Python
    step, with dict keys given out of order."""
    rng = np.random.default_rng(0)
    return {"params": {"w": torch.from_numpy(
                           rng.standard_normal((2, 3)).astype(np.float32)),
                       "b": torch.from_numpy(rng.standard_normal(4).astype(
                           np.float32)).to(torch.bfloat16)},
            "opt": {"mu": {"w": torch.arange(6, dtype=torch.float32
                                             ).reshape(2, 3),
                           "b": torch.ones(4)},
                    "count": torch.tensor(7, dtype=torch.int32)},
            "step": 3}


def _jax_tree(tree):
    """The same tree as the JAX package holds it."""
    def conv(x):
        if isinstance(x, torch.Tensor):
            return jnp.asarray(to_np(x)).astype(
                jnp.bfloat16 if x.dtype == torch.bfloat16 else to_np(x).dtype)
        return x
    return jax.tree.map(conv, tree, is_leaf=lambda x: isinstance(
        x, torch.Tensor))


def _zeros_like(tree):
    return {"params": {k: torch.zeros_like(v)
                       for k, v in tree["params"].items()},
            "opt": {"mu": {k: torch.zeros_like(v)
                           for k, v in tree["opt"]["mu"].items()},
                    "count": torch.tensor(0, dtype=torch.int32)},
            "step": 0}


def assert_same(got, want):
    """Every leaf equal exactly, with the template's dtype and kind."""
    g, w = flatten_with_paths(got), flatten_with_paths(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        if isinstance(b, torch.Tensor):
            assert isinstance(a, torch.Tensor) and a.dtype == b.dtype, path
            assert a.shape == b.shape and torch.equal(a, b), path
        else:
            assert type(a) is type(b) and a == b, path


# --- the reference's own checkpoint tests, on the port -----------------------


def test_ckpt_roundtrip(tmp_path):
    t = _tree()
    save_pytree(t, tmp_path / "ck")
    assert_same(load_pytree(_zeros_like(t), tmp_path / "ck"), t)


def test_ckpt_multihost_stripes(tmp_path):
    t = _tree()
    save_pytree(t, tmp_path / "ck", host_id=0, num_hosts=2)
    save_pytree(t, tmp_path / "ck2", host_id=1, num_hosts=2)
    names = [path_name(p) for p, _ in flatten_with_paths(t)]
    with np.load(tmp_path / "ck" / "shard_0.npz") as z0, \
            np.load(tmp_path / "ck2" / "shard_1.npz") as z1:
        assert sorted(z0.files) == sorted(names[0::2])   # round-robin
        assert sorted(z1.files) == sorted(names[1::2])
    # merge both hosts' shards into one dir (a shared filesystem)
    shutil.move(str(tmp_path / "ck2" / "shard_1.npz"), str(tmp_path / "ck"))
    assert_same(load_pytree(_zeros_like(t), tmp_path / "ck"), t)


def test_ckpt_manager_async_keep_and_restore(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    t = _tree()
    for s in [10, 20, 30]:
        mgr.save(s, {**t, "s": torch.tensor(s)})
    mgr.wait()
    assert mgr.latest_step() == 30
    steps = sorted(int(p.name.split("_")[1]) for p in tmp_path.glob("step_*"))
    assert steps == [20, 30]  # keep=2 GC'd step 10
    step, out = mgr.restore({**_zeros_like(t), "s": torch.tensor(0)})
    assert step == 30 and int(out["s"]) == 30
    assert CheckpointManager(tmp_path / "empty").restore(t) == (None, None)


def test_ckpt_atomic_no_partial_dir(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3)
    mgr.save(5, _tree(), blocking=True)
    assert not list(tmp_path.glob("*.tmp"))
    assert sorted(p.name for p in (tmp_path / "step_00000005").iterdir()) \
        == ["manifest.json", "shard_0.npz"]


def test_ckpt_save_copies_before_returning(tmp_path):
    """The next train step updates the params in place: ``save`` has copied
    them by the time it returns, so the checkpoint holds the saved step's
    values."""
    mgr = CheckpointManager(tmp_path)
    t = _tree()
    want = {"w": t["params"]["w"].clone()}
    mgr.save(1, {"w": t["params"]["w"]})
    t["params"]["w"].add_(1.0)
    mgr.wait()
    _, out = mgr.restore({"w": torch.zeros(2, 3)})
    assert torch.equal(out["w"], want["w"])


def test_ckpt_save_error_surfaces_on_wait(tmp_path, monkeypatch):
    def broken(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(tckpt, "save_pytree", broken)
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, _tree())            # returns; the thread fails
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    mgr.wait()                      # raised once


def test_ckpt_restore_places_on_device_and_dtype(tmp_path):
    t = _tree()
    save_pytree(t, tmp_path / "ck")
    template = {"params": {"w": torch.zeros(2, 3, dtype=torch.bfloat16),
                           "b": torch.zeros(4, dtype=torch.float32)}}
    out = load_pytree(template, tmp_path / "ck", device="cpu")
    assert out["params"]["w"].dtype == torch.bfloat16
    assert torch.equal(out["params"]["w"], t["params"]["w"].bfloat16())
    assert torch.equal(out["params"]["b"], t["params"]["b"].float())
    assert out["params"]["w"].device.type == "cpu"


def test_ckpt_restore_reads_only_the_template(tmp_path, monkeypatch):
    """A serving template ``{"step", "params"}`` reads no optimizer array."""
    t = _tree()
    save_pytree(t, tmp_path / "ck")
    read = []
    real = np.lib.npyio.NpzFile.__getitem__

    def spy(self, key):
        read.append(key)
        return real(self, key)

    monkeypatch.setattr(np.lib.npyio.NpzFile, "__getitem__", spy)
    out = load_pytree({"step": 0, "params": _zeros_like(t)["params"]},
                      tmp_path / "ck")
    assert sorted(read) == ["params/b", "params/w", "step"]
    assert out["step"] == 3 and torch.equal(out["params"]["w"],
                                            t["params"]["w"])


# --- crossing between the packages ---------------------------------------------


def test_same_format_as_the_reference(tmp_path):
    """Both packages write the same manifest and the same npz members (names,
    dtypes, values) for the same tree."""
    t = _tree()
    save_pytree(t, tmp_path / "port")
    jsave(_jax_tree(t), tmp_path / "jax")
    manifest = [json.loads((tmp_path / d / "manifest.json").read_text())
                for d in ("port", "jax")]
    assert manifest[0] == manifest[1]
    assert [leaf["name"] for leaf in manifest[0]["leaves"]] == [
        "opt/count", "opt/mu/b", "opt/mu/w", "params/b", "params/w", "step"]
    with np.load(tmp_path / "port" / "shard_0.npz") as zp, \
            np.load(tmp_path / "jax" / "shard_0.npz") as zj:
        assert sorted(zp.files) == sorted(zj.files)
        for k in zj.files:
            assert zp[k].dtype == zj[k].dtype, k
            np.testing.assert_array_equal(zp[k], zj[k])


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    t = _tree()
    jsave(_jax_tree(t), tmp_path / "ck")
    assert_same(load_pytree(_zeros_like(t), tmp_path / "ck"), t)
    mgr = JManager(tmp_path / "mgr", keep=2)
    for s in (4, 8):
        mgr.save(s, _jax_tree({**t, "step": s}))
    mgr.wait()
    step, out = CheckpointManager(tmp_path / "mgr").restore(_zeros_like(t))
    assert step == 8
    assert_same(out, {**t, "step": 8})


def test_port_checkpoint_restores_in_jax(tmp_path):
    t = _tree()
    mgr = CheckpointManager(tmp_path, keep=2)
    mgr.save(6, t, blocking=True)
    jt = _jax_tree(t)
    step, out = JManager(tmp_path).restore(jax.tree.map(jnp.zeros_like, jt))
    assert step == 6
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(out)[0],
                            jax.tree.leaves(jt)):
        assert a.dtype == jnp.asarray(b).dtype, path
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))
    out = jload({"params": jt["params"]}, tmp_path / "step_00000006")
    np.testing.assert_array_equal(np.asarray(out["params"]["b"], np.float32),
                                  to_np(t["params"]["b"]))
