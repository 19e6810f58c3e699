"""The port's logical parameter axes and their mesh rules against the JAX
package's (``repro.models.pdefs``): every architecture's defs tree (and the
DiT's, and the DiffusionWrapper's) carries the reference's logical axes
leaf for leaf, and ``resolve_specs`` gives the reference's PartitionSpec
entries on the registry's mesh geometries (stand-in meshes: geometry needs
no process group).  Then the cache-leaf specs (``launch.steps``) the
same way."""
import jax
import pytest

from repro.configs import base as jbase
from repro.configs.registry import ARCHS as JARCHS
from repro.diffusion import dit as jdit
from repro.launch import steps as jsteps
from repro.models import backbone as jbackbone
from repro.models import pdefs as jpdefs
from repro_torch.configs import base as tbase
from repro_torch.configs.registry import ARCHS as TARCHS
from repro_torch.diffusion import dit as tdit
from repro_torch.launch import steps as tsteps
from repro_torch.models import backbone as tbackbone
from repro_torch.models import pdefs as tpdefs
from tests.test_torch_placement import GEOMETRIES, GridMesh


def _jax_leaves(defs):
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(
                defs, is_leaf=jpdefs.is_def)}


def _port_leaves(defs):
    return {"/".join(map(str, path)): spec
            for path, spec in tpdefs.walk(defs)}


def _trees(name):
    jc, tc = JARCHS[name], TARCHS[name]
    if jc.is_diffusion:
        yield jdit.dit_defs(jc), tdit.dit_defs(tc)
    else:
        yield jbackbone.build_defs(jc), tbackbone.build_defs(tc)
        yield jdit.wrapper_defs(jc, 8), tdit.wrapper_defs(tc, 8)


@pytest.mark.parametrize("name", sorted(TARCHS))
def test_defs_carry_the_reference_logical_axes(name):
    for jdefs, tdefs in _trees(name):
        want, got = _jax_leaves(jdefs), _port_leaves(tdefs)
        assert sorted(got) == sorted(want)
        for path, spec in got.items():
            assert spec.shape == want[path].shape, path
            assert spec.axes == want[path].axes, path


@pytest.mark.parametrize("shape,axes", GEOMETRIES,
                         ids=lambda v: "x".join(map(str, v)))
def test_resolve_specs_match_jax(shape, axes):
    mesh = GridMesh(shape, axes)
    for name in ("qwen3-0.6b", "qwen2-moe-a2.7b", "mamba2-1.3b",
                 "recurrentgemma-2b", "dit-xl"):
        for jdefs, tdefs in _trees(name):
            jspecs = jax.tree.map(lambda d: tuple(jpdefs.resolve_spec(d,
                                                                      mesh)),
                                  jdefs, is_leaf=jpdefs.is_def)
            want = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                             for k in path): leaf
                    for path, leaf in jax.tree_util.tree_leaves_with_path(
                        jspecs, is_leaf=lambda x: isinstance(x, tuple))}
            got = {"/".join(map(str, path)): tpdefs.resolve_spec(spec, mesh)
                   for path, spec in tpdefs.walk(tdefs)}
            assert got == want, name


@pytest.mark.parametrize("shape,axes", GEOMETRIES[:4],
                         ids=lambda v: "x".join(map(str, v)))
def test_input_and_cache_specs_match_jax(shape, axes):
    """The reference builds these specs into NamedShardings of a real
    mesh; its rules (``_batch_axis``, ``_cache_spec_for``, the stacking
    of ``abstract_cache``) are applied here to the same stand-in mesh."""
    mesh = GridMesh(shape, axes)
    for name in ("qwen3-0.6b", "h2o-danube-3-4b", "mamba2-1.3b",
                 "recurrentgemma-2b", "musicgen-medium", "dit-xl"):
        jc, tc = JARCHS[name].reduced(), TARCHS[name].reduced()
        for kind in ("decode", "prefill", "train"):
            jshape = jbase.ShapeConfig(f"t_{kind}", 64, 8, kind)
            tshape = tbase.ShapeConfig(f"t_{kind}", 64, 8, kind)
            ba = jsteps._batch_axis(mesh, 8)
            want = {k: (ba,) + (None,) * (len(v.shape) - 1)
                    for k, v in jsteps.input_specs(jc, jshape).items()}
            assert tsteps.input_partition(tc, tshape, mesh) == want
            if jc.is_diffusion or kind == "train":
                continue
            want = {}
            cache = jbackbone.abstract_cache(jc, 8, 64, jsteps.PARAM_DTYPE)
            for path, leaf in jax.tree_util.tree_leaves_with_path(cache):
                pstr = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                                for k in path)
                shp = leaf.shape
                if "index" in pstr:
                    spec = (None,) * len(shp)
                elif (not jc.is_hybrid) or "periods" in pstr:
                    spec = (None, *jsteps._cache_spec_for(pstr, shp[1:],
                                                          mesh))
                else:
                    spec = tuple(jsteps._cache_spec_for(pstr, shp, mesh))
                want[pstr] = spec
            got = {"/".join(map(str, p)): spec for p, spec in
                   tsteps.cache_partition(tc, tshape, mesh)}
            assert got == want, (name, kind)
