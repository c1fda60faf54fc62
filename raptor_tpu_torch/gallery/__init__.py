from raptor_tpu_torch.gallery.stencils import (
    stencil_grid,
    poisson_2d,
    poisson_3d,
    laplacian_27pt,
    anisotropic_2d,
    diffusion_stencil_2d,
    elasticity_3d,
    convection_diffusion_2d,
    default_rhs,
)

__all__ = [
    "stencil_grid",
    "poisson_2d",
    "poisson_3d",
    "laplacian_27pt",
    "anisotropic_2d",
    "diffusion_stencil_2d",
    "elasticity_3d",
    "convection_diffusion_2d",
    "default_rhs",
]
