"""The arm backends in the port's runtimes against the JAX package's:
two ``Experiment`` ticks on each of ``arm``, ``arm-dynamic`` (with the
force variant, so the contact wrench reaches the replay ring as its norm,
and movable objects) and ``arm-dynamic-soft``; three ``EvalExperiment``
ticks and ``use_pose`` on ``arm``; and the reference's quirk that the eval
runtime runs the free env on the dynamic backends.

Step-matched as ``test_torch_tick.py``: the same weights, the port's arm
state converted from the JAX one (``arm_state_from_jax``), and the JAX
ticks' random draws fed to the port. Tolerances of ``test_torch_tick.py``
(env pose 1e-4; plan rtol 2e-3, atol 2e-4; beta, gamma and loss rtol
1e-3), joints at 1e-4.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from ealv_tpu.runtime import Experiment as JExperiment
from ealv_tpu.runtime.tester import EvalExperiment as JEval
from ealv_tpu.utils.config import ExperimentConfig as JConfig
from ealv_tpu_torch.runtime import EvalExperiment, Experiment
from ealv_tpu_torch.sim.arm import ArmEnv
from ealv_tpu_torch.sim.env import SyntheticEnv
from ealv_tpu_torch.utils.config import ExperimentConfig
from ealv_tpu_torch.utils.convert import arm_state_from_jax, params_from_jax
from test_torch_tester import _targets, _ticks_step_matched
from test_torch_tick import _close, _jax_tick_draws
from test_torch_trainer import one_torch_thread  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOY = dict(states="xyw", num_target_samples=64, num_traj_samples=100,
           image_dim=(24, 24, 3), batch_size=8, num_learning_opt=2, compute_dtype="float32")
BACKENDS = {"arm": {}, "arm-dynamic": dict(learn_force=True, obj_mobility=0.2),
            "arm-dynamic-soft": {}}


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_two_arm_ticks_step_matched(backend):
    toy = {**TOY, **BACKENDS[backend], "sim_backend": backend}
    exp_j = JExperiment(JConfig(**toy), train_calls_per_tick=1, train_every=1)
    exp_t = Experiment(ExperimentConfig(**toy), train_calls_per_tick=1, train_every=1,
                       device="cpu")
    assert isinstance(exp_t.env, ArmEnv)
    assert (exp_t.env.dynamic_contact, exp_t.env.soft_objects, exp_t.env.obj_mobility) == (
        exp_j.env.dynamic_contact, exp_j.env.soft_objects, exp_j.env.obj_mobility)
    es_j = exp_j.init(seed=0)
    es_t = exp_t.init(seed=0)
    _close(es_t.env.q, es_j.env.q, 1e-4, 1e-5, "init q")  # the port's own IK
    es_t.model.load_state_dict(params_from_jax(es_j.params, es_t.model))
    es_t.env = arm_state_from_jax(es_j.env, "cpu")
    tick_j = jax.jit(exp_j.tick)
    for k in range(2):
        es_j2, info_j = tick_j(es_j)
        es_t, info_t = exp_t.tick(es_t, _jax_tick_draws(exp_j, es_j, es_j2))
        es_j = es_j2
        slot = es_t.buf.pos - 1
        _close(es_t.env.q, es_j.env.q, 1e-4, 1e-4, f"tick {k} q")
        _close(es_t.env.pose, es_j.env.pose, 1e-4, 1e-5, f"tick {k} env pose")
        _close(es_t.env.scene.obj_xy, es_j.env.scene.obj_xy, 1e-5, 1e-6, f"tick {k} objects")
        _close(es_t.buf.x[slot], es_j.buf.x[slot], 1e-4, 1e-4, f"tick {k} pushed pose")
        _close(es_t.buf.y[slot], es_j.buf.y[slot], 1e-4, 1e-4, f"tick {k} pushed image")
        _close(es_t.buf.force[slot], es_j.buf.force[slot], 1e-4, 1e-5, f"tick {k} force")
        _close(es_t.pstate.u, es_j.pstate.u, 2e-3, 2e-4, f"tick {k} plan u")
        _close(info_t["ergodic_cost"], info_j["ergodic_cost"], 2e-3, 0, f"tick {k} cost")
        for key in ("beta", "gamma", "loss"):
            _close(info_t[key], info_j[key], 1e-3, 1e-6, f"tick {k} {key}")
        assert es_t.env.count == int(es_j.env.count) == exp_t.cfg.data_to_ctrl_rate * (k + 1)
    assert float(info_t["loss"]) != 0.0


def _arm_eval_pair():
    cfg_j = JConfig(**TOY, sim_backend="arm")
    jfn, jctx, tfn, tctx = _targets("explr", cfg_j, "xyw")
    ej = JEval(cfg_j, jfn)
    et = EvalExperiment(ExperimentConfig(**TOY, sim_backend="arm"), tfn, device="cpu")
    start = [0.45, 0.03, 0.35, 3.14, 0.0, 0.2]
    vj = ej.init(jnp.asarray(start), seed=2)
    vt = et.init(start, seed=2)
    _close(vt.env.pose, vj.env.pose, 1e-4, 1e-5, "init pose")
    vt.env = arm_state_from_jax(vj.env, "cpu")
    return ej, vj, jctx, et, vt, tctx


def test_arm_eval_ticks_step_matched():
    """Three EvalExperiment ticks on the arm toward an ExplrDist target."""
    ej, vj, jctx, et, vt, tctx = _arm_eval_pair()
    assert isinstance(et.env, ArmEnv) and et.env.dt == pytest.approx(ej.env.dt)
    _ticks_step_matched(ej, vj, jctx, et, vt, tctx)


def test_arm_use_pose_matches_jax():
    ej, vj, _, et, vt, _ = _arm_eval_pair()
    target = [0.5, -0.05, 0.3, 3.0, 0.1, -0.3]
    vj = ej.use_pose(vj, jnp.asarray(target), n_steps=4)
    vt = et.use_pose(vt, target, n_steps=4)
    _close(vt.env.q, vj.env.q, 5e-5, 5e-5, "q")
    _close(vt.env.pose, vj.env.pose, 5e-5, 5e-5, "pose")


@pytest.mark.parametrize("backend", ["arm-dynamic", "arm-dynamic-soft"])
def test_eval_runs_the_free_env_on_the_dynamic_backends(backend):
    """The reference quirk the port keeps: only "arm" selects the arm in
    the eval runtime (ealv_tpu/runtime/tester.py:93)."""
    ej = JEval(JConfig(**TOY, sim_backend=backend), lambda c, s: s[:, 0])
    et = EvalExperiment(ExperimentConfig(**TOY, sim_backend=backend), lambda c, s: s[:, 0],
                        device="cpu")
    assert type(ej.env).__name__ == "SyntheticEnv" and isinstance(et.env, SyntheticEnv)
