from .kernels import (
    psi_matrix,
    traj_footprint,
    traj_spread,
    kldiv_grad_batch,
    renormalize,
    cost_norm,
)
from .footprint import footprint_and_spread, footprint_and_spread_reference
