"""Step-matched planner for every dynamics model and warm-start policy:
one ``plan_with_inputs`` call of the port against the JAX planner on the
same frozen inputs (the scenes and tolerances of test_torch_planner.py:
plan u at rtol 2e-3, atol 2e-4, ergodic cost at rtol 2e-3). The single
integrator has no velocity states, so BarrierPush does not apply to it."""

import numpy as np
import pytest

from test_torch_planner import _check_plan, _pair, _plan_pair
from test_torch_trainer import one_torch_thread  # noqa: F401

PLAN_CASES = [(dyn, pol) for dyn in ("double", "speed", "roll")
              for pol in ("Roll", "Zero", "BarrierPush", "LQR")] + \
    [("single", pol) for pol in ("Roll", "Zero", "LQR")]


@pytest.mark.parametrize("dyn,policy", PLAN_CASES)
def test_plan_with_inputs_every_model_and_policy(dyn, policy):
    jp, tp, scene = _pair(dyn, policy)
    jps2, jinfo, tps2, tinfo = _plan_pair(jp, tp, scene)
    _check_plan(jps2, jinfo, tps2, tinfo)
    assert not np.allclose(np.asarray(jps2.u), scene[5])  # the plan moved
