"""ParaTAA: parallel sampling of diffusion models via triangular nonlinear
equations + Triangular Anderson Acceleration (the solver core)."""
from repro_torch.core.coeffs import (SolverCoeffs, ddim_coeffs, ddpm_coeffs,
                                     system_matrices)
from repro_torch.core.parataa import ParaTAAConfig

__all__ = [
    "SolverCoeffs", "ddim_coeffs", "ddpm_coeffs", "system_matrices",
    "ParaTAAConfig",
]
