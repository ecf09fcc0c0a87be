"""The fingerprint stage (port of ``ealv_tpu/fingerprint/``): find objects
in the learned model's uncertainty, capture their latent fingerprints, and
re-localize them with Bayesian belief grids."""

from .distances import latent_distance
from .belief import FingerprintBelief, marginalize_angles
from .clustering import (ClusterDraws, ClusterResult, find_clusters, mean_shift,
                         merge_overlapping, optimize_samples)
from .identify import (FingerprintSet, calibrate_thresholds, identify_step,
                       relative_pose_beliefs, update_beliefs)
from .io import save_fingerprint, load_fingerprints, save_beliefs, load_beliefs
from .entropy import entropy_slice, entropy_slices
