"""The K = 3 fingerprint stage on the free plant, the port against the
JAX package, with learned weights: ``k3-study``'s scene
(``TrayScene.make(3, seed=0)``) and the weights of a 160-tick JAX toy run
on it (``test_torch_arm_long``'s ``"free-k3"`` run). The same checks as
``test_torch_arm_long_fp.py`` on the arm: the whole captures at the three
true centres (the poses the greedy filter keeps, the latents and poses),
the first object's capture ticks re-synchronised from the JAX state
before each (the object whose JAX capture kept 49 poses in the published
seed-0 runs), the
thresholds each side calibrates from its own three captures, and 30
identification ticks over the four combinations in both seek modes
(adoption at step 5), each from the JAX evaluation state and beliefs.
Tolerances of ``test_torch_arm_long_fp.py``.
"""

import pytest

from test_torch_arm_long_fp import check_capture, check_capture_ticks, \
    check_identification_ticks, check_thresholds
from test_torch_trainer import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("k", [0, 1, 2])
def test_k3_capture_matches_jax(k):
    check_capture("free-k3", k)


@pytest.mark.parametrize("k", [0])
def test_k3_capture_ticks_resynchronised(k):
    check_capture_ticks("free-k3", k)


@pytest.mark.parametrize("method", ["L2", "KL", "BC"])
def test_k3_calibrated_thresholds_match_jax(method):
    check_thresholds("free-k3", method)


@pytest.mark.parametrize("seek_mode", ["fixed", "uncertain"])
def test_k3_identification_ticks_resynchronised(seek_mode):
    check_identification_ticks("free-k3", seek_mode)
