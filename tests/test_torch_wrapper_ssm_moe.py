"""Port parity for the DiffusionWrapper over mamba2, the RG-LRU hybrid and
the MoE configs (the checks of ``tests/test_torch_wrapper.py``, in a file
of their own so that the two run side by side)."""
import pytest

from tests.test_torch_backbone import SSM_MOE_ARCHS, TAIL
from tests.test_torch_wrapper import (check_parataa_on_the_wrapper,
                                      check_wrapper_apply, check_wrapper_defs)


@pytest.mark.parametrize("name", SSM_MOE_ARCHS + [TAIL])
def test_wrapper_defs_match_jax(name):
    check_wrapper_defs(name)


@pytest.mark.parametrize("name", SSM_MOE_ARCHS + [TAIL])
def test_wrapper_apply_matches_jax(name):
    check_wrapper_apply(name)


@pytest.mark.parametrize("name", SSM_MOE_ARCHS)
def test_parataa_on_the_wrapper_matches_jax(name):
    """The staged round, with the check against sequential DDIM (the fused
    round's agreement with the staged one does not depend on the
    denoiser; ``tests/test_torch_wrapper.py`` holds it over six archs).
    With MoE the reduced configs' capacity factor of 8 holds every slot
    for any window, so ParaTAA's fixed point is sequential DDIM's."""
    check_parataa_on_the_wrapper(name, fuse=False)
