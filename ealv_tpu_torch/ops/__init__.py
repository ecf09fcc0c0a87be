from .kernels import (
    psi_matrix,
    traj_footprint,
    traj_spread,
    kldiv_grad_batch,
    renormalize,
    cost_norm,
)
from .footprint import footprint_and_spread, footprint_and_spread_reference
from .adam import (
    FusedAdam,
    adam_apply,
    adam_init,
    adam_update_flat,
    adam_update_reference,
)
from .wgrad import conv_wgrad_direct, conv_wgrad_reference
from .fast_conv import conv2d_valid_direct
