"""The explore-and-learn tick, the slice as a whole: the port against the
JAX ``Experiment`` at the toy size of ``bench.py --selfcheck``.

Step-matched: both start from the same weights (JAX init converted with
``params_from_jax``); the JAX tick runs as it is, and the random draws it
made (planner samples, history draw, batch indices, reparam noise) are
derived from its keys with the JAX package's own functions and fed to the
port's tick (whole runs compared over seeds are in
``test_torch_tick_stats.py``). Also: the port never imports JAX, and
``chip_smoke.py`` fails without a GPU. f32 comparisons with TF32 off.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ealv_tpu.runtime import Experiment as JExperiment
from ealv_tpu.utils.config import ExperimentConfig as JConfig
from ealv_tpu_torch.runtime import Experiment, TickDraws
from ealv_tpu_torch.utils.config import ExperimentConfig
from ealv_tpu_torch.utils.convert import params_from_jax
from test_torch_baselines import jax_draws as jax_baseline_draws
from test_torch_trainer import jax_train_draws, one_torch_thread  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOY = dict(states="xyw", num_target_samples=64, num_traj_samples=100,
           image_dim=(24, 24, 3), batch_size=8, num_learning_opt=2)


def _jax_tick_draws(exp, es, es_after):
    """The random draws of one JAX tick from ``es`` (``es_after`` is the
    state the tick returned: its replay ring is the one the trainer read):
    the planner's or the baseline's, the trainer's, and the entropy grade's
    uniform samples."""
    cfg = exp.cfg
    _, k_train, k_hp = jax.random.split(es.key, 3)
    train = [jax_train_draws(exp.model, es.params, es_after.buf,
                             jax.random.fold_in(k_train, 0), cfg.num_learning_opt,
                             cfg.batch_size)]
    grade = jax.random.uniform(jax.random.fold_in(k_hp, 0),
                               (cfg.num_target_samples, cfg.s_dim),
                               minval=exp.robot_lim[:, 0], maxval=exp.robot_lim[:, 1])
    grade = [torch.tensor(np.asarray(grade))]
    if exp.use_baseline:
        ps = exp.baseline.save_update(es.pstate, exp._measured_robot_state(es.env))
        return TickDraws(train=train, grade_samples=grade,
                         baseline=jax_baseline_draws(exp.baseline, ps))
    n_hist = cfg.num_traj_samples

    @jax.jit
    def planner_draws(es):
        ps = exp.planner.save_update(es.pstate, exp._measured_robot_state(es.env),
                                     save=True)
        _, k_samp, k_hist = jax.random.split(ps.key, 3)
        lims = ps.lims
        samples = jax.random.uniform(k_samp, (exp.cfg.num_target_samples, lims.shape[0]),
                                     minval=lims[:, 0], maxval=lims[:, 1])
        cap = ps.memory.capacity
        logw = jnp.where(jnp.arange(cap) < ps.memory.size, 0.0, -1e30)
        hist_idx = jax.lax.top_k(logw + jax.random.gumbel(k_hist, (cap,)), n_hist)[1]
        # self-check: these indices give the JAX planner's own history draw
        return samples, hist_idx, ps.memory.buf[hist_idx], \
            ps.memory.sample(k_hist, n_hist)[0]

    samples, hist_idx, got, want = planner_draws(es)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    return TickDraws(samples=torch.tensor(np.asarray(samples)),
                     hist_idx=torch.tensor(np.asarray(hist_idx), dtype=torch.int64),
                     train=train, grade_samples=grade)


def _close(a, b, rtol, atol, what):
    np.testing.assert_allclose(np.asarray(a.detach() if torch.is_tensor(a) else a),
                               np.asarray(b, np.float32), rtol=rtol, atol=atol,
                               err_msg=what)


def test_two_ticks_step_matched():
    """Tick 1 plans and learns nothing (the learning-ratio throttle); tick
    2 trains. Tolerances: env pose, pushed pose and image at 1e-4 (they
    follow the plan's first control); plan u at rtol 2e-3, atol 2e-4 and
    ergodic cost at rtol 2e-3 (footprint forms differ, see
    test_torch_planner.py); beta, gamma and loss at rtol 1e-3."""
    _two_ticks_step_matched(TOY)


def test_two_ticks_step_matched_xyzrpw():
    """The 6-DoF tick (SO(3) roll dynamics, 12 planner states), at the
    tolerances of test_two_ticks_step_matched. As in the reference, the
    Experiment gives the roll model no angle scale or shift, so a plan
    that takes the robot-coordinate roll below 0 wraps it to near 2pi and
    meets the barrier; the planner's R is compared too."""
    _two_ticks_step_matched({**TOY, "states": "xyzrpw"}, check_R=True)


def test_two_ticks_step_matched_xywb_force_ensemble():
    """The experiment's options together: the brightness state b (its
    command drives the env's brightness), the force variant (forces into
    the ring, the reseed and the trainer) and the z-ensemble target; the
    entropy grade then comes from a fresh plain decode, not the planner's.
    Tolerances of test_two_ticks_step_matched; brightness and the z ring at
    1e-4."""
    _two_ticks_step_matched({**TOY, "states": "xywb", "learn_force": True,
                             "use_z_ensemble": True})


@pytest.mark.parametrize("method,states", [("randomWalk", "xywb"), ("uniform", "xyw")])
def test_two_baseline_ticks_step_matched(method, states):
    """The baseline explorers in the tick, from the JAX keys' draws: the
    baseline's state at 1e-5, the rest as in test_two_ticks_step_matched."""
    _two_ticks_step_matched({**TOY, "states": states, "explr_method": method})


def _two_ticks_step_matched(toy, check_R=False):
    cfg_j = JConfig(**toy, compute_dtype="float32")
    cfg_t = ExperimentConfig(**toy, compute_dtype="float32")
    exp_j = JExperiment(cfg_j, train_calls_per_tick=1, train_every=1)
    exp_t = Experiment(cfg_t, train_calls_per_tick=1, train_every=1, device="cpu")
    es_j = exp_j.init(seed=0)
    es_t = exp_t.init(seed=0)
    es_t.model.load_state_dict(params_from_jax(es_j.params, es_t.model))
    tick_j = jax.jit(exp_j.tick)

    for k in range(2):
        es_j2, info_j = tick_j(es_j)
        draws = _jax_tick_draws(exp_j, es_j, es_j2)
        es_t, info_t = exp_t.tick(es_t, draws)
        es_j = es_j2
        slot = es_t.buf.pos - 1
        _close(es_t.env.pose, es_j.env.pose, 1e-4, 1e-5, f"tick {k} env pose")
        _close(es_t.buf.x[slot], es_j.buf.x[slot], 1e-4, 1e-4, f"tick {k} pushed pose")
        _close(es_t.buf.y[slot], es_j.buf.y[slot], 1e-4, 1e-4, f"tick {k} pushed image")
        if exp_t.use_baseline:
            _close(es_t.pstate.x, es_j.pstate.x, 1e-5, 1e-6, f"tick {k} baseline x")
            _close(es_t.pstate.last_vel, es_j.pstate.last_vel, 1e-5, 1e-6,
                   f"tick {k} baseline vel")
        else:
            _close(es_t.pstate.u, es_j.pstate.u, 2e-3, 2e-4, f"tick {k} plan u")
        _close(info_t["ergodic_cost"], info_j["ergodic_cost"], 2e-3, 0, f"tick {k} cost")
        _close(es_t.env.brightness, es_j.env.brightness, 1e-4, 1e-5, f"tick {k} brightness")
        _close(es_t.buf.force[slot], es_j.buf.force[slot], 1e-4, 1e-5, f"tick {k} force")
        _close(es_t.mstate.z_buff, es_j.mstate.z_buff, 1e-4, 1e-5, f"tick {k} z ring")
        for key in ("beta", "gamma", "loss"):
            _close(info_t[key], info_j[key], 1e-3, 1e-6, f"tick {k} {key}")
        if check_R:
            _close(es_t.pstate.dyn.R, es_j.pstate.dyn.R, 1e-5, 1e-6, f"tick {k} R")
        assert es_t.learning_ind == int(es_j.learning_ind) == k
        assert es_t.explr_step == int(es_j.explr_step) == k + 1
    assert float(info_t["loss"]) != 0.0  # the second tick trained


def test_port_imports_no_jax():
    code = ("import importlib, pkgutil, sys\n"
            "import ealv_tpu_torch\n"
            "for m in pkgutil.walk_packages(ealv_tpu_torch.__path__, 'ealv_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'ealv_tpu')]\n"
            "assert not bad, bad\n"
            "print(len([m for m in sys.modules if m.startswith('ealv_tpu_torch')]))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 20  # every submodule was imported


def test_chip_smoke_fails_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_standalone_entropy_schedule_path():
    """hyper_from_planner=False: the trainer's grade/spread come from a
    fresh pdf decode and the replay ring, as the reference recomputes
    them; the ticks still train with finite beta and gamma."""
    exp = Experiment(ExperimentConfig(**TOY, hyper_from_planner=False),
                     train_calls_per_tick=1, train_every=1, device="cpu")
    es, inf = exp.run_chunk(exp.init(seed=1), 4)
    assert es.learning_ind == 3
    assert torch.isfinite(inf["beta"]).all() and torch.isfinite(inf["gamma"]).all()
    assert float(inf["gamma"][-1]) > 0.0
    assert int(es.buf.beta_size) == 3


@pytest.mark.parametrize("kwargs,match", [
    (dict(use_magnitude=True), "klerg.py:550"), (dict(states="xyXY"), "config.py:156"),
    (dict(mesh=object()), "mesh")])
def test_unported_configurations_raise(kwargs, match):
    """use_magnitude=True and velocity states have no reference to match:
    the JAX Experiment fails on its first tick (use_magnitude) or in its
    config (upper-case states), and the messages say so."""
    mesh = kwargs.pop("mesh", None)
    with pytest.raises(NotImplementedError, match=match):
        Experiment(ExperimentConfig(**{**TOY, **kwargs}), mesh=mesh, device="cpu")


def test_upper_case_states_fail_in_the_reference_config():
    """The reference quirk the port's refusal names: the JAX config has no
    limits for velocity states."""
    with pytest.raises(KeyError):
        JConfig(**{**TOY, "states": "xyXY"}).tray_lim
