"""The port's tick re-synchronised along long JAX runs on the arm.

A free-running step-match cannot look past about a hundred ticks: the
command is the measured velocity plus ``u * dt``, so a plan that parts
by rounding after a trainer call carries its velocity offset forward, in
the reference as in the port. So each checkpoint here starts the port
from the JAX state itself (``experiment_state_from_jax``) and takes one
port tick with the JAX tick's random draws, against the JAX tick from the
same state.

The JAX run is made once per module and configuration (a loop of the
jitted JAX tick, the states kept only at the checkpoints). Its rings wrap
within the run (128 slots at the toy size, 1024 at the run entry's
``--small`` size over 1100 ticks, the ``slow`` variant), and it trains
every third tick. The checkpoints are ticks where the arm does something
a two-tick match never sees: the start (on ``"arm"`` the first plans are
all zero and the arm stands still), the first trainer call, the first drift corrections (every
20 velocity commands), the replay ring's fill and wrap and the planner's
trajectory ring's wrap, the step nearest a joint limit, on
``"arm-dynamic"`` (the force variant, movable objects, the force study's
wide and tall cylinders, exploring ``xyz`` from a start in contact deep
enough that the contact guard blocks motion into the object) the deepest
contact and the first step out of contact, and the last tick.

Tolerances of ``test_torch_tick.py``: the joints at 1e-4; the env pose
1e-4 (atol 1e-5); the objects 1e-5; the pushed pose, image and force
1e-4; plan u rtol 2e-3, atol 2e-4; the ergodic cost rtol 2e-3; beta,
gamma and loss rtol 1e-3; the counters exactly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ealv_tpu.hw import bridge as jb
from ealv_tpu.runtime import Experiment as JExperiment, HostLoopRunner as JRunner
from ealv_tpu.sim.arm import Q_MAX, Q_MIN
from ealv_tpu.sim.renderer import TrayScene as JScene
from ealv_tpu.utils.config import ExperimentConfig as JConfig
from ealv_tpu_torch.runtime import Experiment
from ealv_tpu_torch.scripts.run_experiment import SMALL
from ealv_tpu_torch.sim.renderer import TrayScene
from ealv_tpu_torch.utils.config import ExperimentConfig
from ealv_tpu_torch.utils.convert import experiment_state_from_jax
from test_torch_tick import _close, _jax_tick_draws
from test_torch_trainer import one_torch_thread  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOY = dict(num_target_samples=64, num_traj_samples=100, image_dim=(24, 24, 3), batch_size=8,
           num_learning_opt=2, compute_dtype="float32", buffer_capacity=128,
           traj_buffer_capacity=128)
LONG = dict(SMALL, compute_dtype="float32")
# the force study's contact-rich scene (wide, tall cylinders), started over
# the first object 5 cm below its top: 25 N, past the 22.5 N at which the
# contact guard blocks motion into the object
CONTACT = dict(obj_radius=(0.07, 0.06), obj_height=(0.38, 0.42))
CONTACT_START = (0.42, -0.06, 0.33)
CASES = {
    "arm": dict(states="xyw", sim_backend="arm"),
    "arm-dynamic": dict(states="xyz", sim_backend="arm-dynamic", learn_force=True,
                        obj_mobility=0.2),
    # the free plant on k3-study's 3-object scene (for test_torch_k3_long.py)
    "free-k3": dict(states="xyw", sim_backend="free"),
}
N_TOY = 160
N_LONG = 1100
TRAIN_EVERY = 3
COMMON = ("start", "first_train", "first_drift", "second_drift", "ring_full", "ring_wrap",
          "traj_wrap", "joint_limit", "last")
CHECKPOINTS = {"arm": COMMON, "arm-dynamic": COMMON + ("contact_exit", "deepest_contact")}


def _scenes(case):
    if case == "free-k3":
        return JScene.make(3, seed=0), TrayScene.make(3, seed=0, device="cpu")
    if not CASES[case]["sim_backend"].startswith("arm-dynamic"):
        return None, None
    js = JScene.default()._replace(obj_radius=jnp.asarray(CONTACT["obj_radius"]),
                                   obj_height=jnp.asarray(CONTACT["obj_height"]))
    ts = TrayScene.default("cpu")._replace(
        obj_radius=torch.tensor(CONTACT["obj_radius"]),
        obj_height=torch.tensor(CONTACT["obj_height"]))
    return js, ts


def _margin(q):
    """Distance of the nearest joint to its limit."""
    q = np.asarray(q)
    return float(np.minimum(q - np.asarray(Q_MIN), np.asarray(Q_MAX) - q).min())


class JaxRun:
    """A JAX ``Experiment`` run on an arm backend, one jitted tick at a
    time, keeping (state before, state after, info) at the checkpoints;
    ``every`` also keeps every ``every``-th tick."""

    def __init__(self, case, sizes, n_ticks, every=0):
        self.cfg_kw = {**sizes, **CASES[case]}
        self.scene_j, self.scene_t = _scenes(case)
        self.exp = JExperiment(JConfig(**self.cfg_kw), train_calls_per_tick=1,
                               train_every=TRAIN_EVERY, scene=self.scene_j)
        self.checkpoints = {}
        tick = jax.jit(self.exp.tick)
        es = self.exp.init(seed=0)
        if CASES[case]["sim_backend"].startswith("arm-dynamic"):
            start = np.mean(np.asarray(self.exp.env.tray_lim), 1)
            start[:3] = CONTACT_START
            es = es._replace(env=self.exp.env.init(jnp.asarray(start, jnp.float32),
                                                   scene=self.scene_j))
        cap = self.exp.cfg.buffer_capacity
        first = {"start": 0, "first_drift": 19, "second_drift": 39, "ring_full": cap - 1,
                 "ring_wrap": cap, "last": n_ticks - 1}
        best_margin, max_force = np.inf, 0.0
        for k in range(n_ticks):
            es2, info = tick(es)
            keep = [name for name, at in first.items() if at == k]
            if every and k % every == 0:
                keep.append(f"tick{k}")
            if int(es2.learning_ind) > int(es.learning_ind) and "first_train" not in \
                    self.checkpoints:
                keep.append("first_train")
            if int(es2.pstate.memory.pos) < int(es.pstate.memory.pos) and "traj_wrap" not in \
                    self.checkpoints:
                keep.append("traj_wrap")
            margin = _margin(es2.env.q) if hasattr(es2.env, "q") else np.inf
            if margin < best_margin:
                best_margin = margin
                keep.append("joint_limit")
            force = float(info["force"][0])
            if max_force > 0 and force == 0 and "contact_exit" not in self.checkpoints:
                keep.append("contact_exit")
            if force > max_force:
                max_force = force
                keep.append("deepest_contact")
            for name in keep:
                self.checkpoints[name] = (k, es, es2, info)
            es = es2
        self.min_margin, self.max_force = best_margin, max_force

    def port(self):
        return Experiment(ExperimentConfig(**self.cfg_kw), train_calls_per_tick=1,
                          train_every=TRAIN_EVERY, scene=self.scene_t, device="cpu")


@functools.lru_cache(maxsize=None)
def toy_run(case) -> JaxRun:
    return JaxRun(case, TOY, N_TOY)


def check_tick(run, exp_t, name):
    """One port tick from the converted JAX state at checkpoint ``name``
    against the JAX tick."""
    k, es_j, es_j2, info_j = run.checkpoints[name]
    es_t = experiment_state_from_jax(es_j, exp_t)
    es_t, info_t = exp_t.tick(es_t, _jax_tick_draws(run.exp, es_j, es_j2))
    what = f"{name} (tick {k})"
    slot = (int(es_t.buf.pos) - 1) % es_t.buf.capacity
    assert slot == (int(es_j2.buf.pos) - 1) % es_t.buf.capacity, what
    assert (es_t.buf.size, es_t.buf.total) == (int(es_j2.buf.size), int(es_j2.buf.total)), what
    assert (es_t.explr_step, es_t.learning_ind, es_t.env.count) == (
        int(es_j2.explr_step), int(es_j2.learning_ind), int(es_j2.env.count)), what
    mem_t, mem_j = es_t.pstate.memory, es_j2.pstate.memory
    assert (int(mem_t.pos), int(mem_t.size)) == (int(mem_j.pos), int(mem_j.size)), what
    _close(mem_t.buf[(int(mem_t.pos) - 1) % mem_t.capacity],
           mem_j.buf[(int(mem_j.pos) - 1) % mem_t.capacity], 1e-4, 1e-4, f"{what} traj push")
    _close(es_t.env.q, es_j2.env.q, 1e-4, 1e-4, f"{what} q")
    _close(es_t.env.pose, es_j2.env.pose, 1e-4, 1e-5, f"{what} env pose")
    _close(es_t.env.scene.obj_xy, es_j2.env.scene.obj_xy, 1e-5, 1e-6, f"{what} objects")
    _close(es_t.buf.x[slot], es_j2.buf.x[slot], 1e-4, 1e-4, f"{what} pushed pose")
    _close(es_t.buf.y[slot], es_j2.buf.y[slot], 1e-4, 1e-4, f"{what} pushed image")
    _close(es_t.buf.force[slot], es_j2.buf.force[slot], 1e-4, 1e-5, f"{what} pushed force")
    _close(es_t.pstate.u, es_j2.pstate.u, 2e-3, 2e-4, f"{what} plan u")
    _close(info_t["ergodic_cost"], info_j["ergodic_cost"], 2e-3, 0, f"{what} cost")
    for key in ("beta", "gamma", "loss"):
        _close(info_t[key], info_j[key], 1e-3, 1e-6, f"{what} {key}")
    return k


@pytest.mark.parametrize("case,name", [(c, n) for c, names in CHECKPOINTS.items()
                                       for n in names])
def test_resynchronised_tick(case, name):
    run = toy_run(case)
    assert name in run.checkpoints, f"the JAX run never reached {name}"
    k = check_tick(run, run.port(), name)
    if name == "start" and case == "arm":  # the arm stands still: the plan is zero
        assert k == 0 and not np.asarray(run.checkpoints[name][2].pstate.u).any()
    if name == "ring_wrap":
        assert int(run.checkpoints[name][2].buf.total) > run.exp.cfg.buffer_capacity
    if name == "deepest_contact":
        assert float(run.checkpoints[name][3]["force"][0]) > 22.5  # the guard blocks


def test_the_toy_runs_reach_their_checkpoints():
    """The toy runs go where the checkpoints say: both rings wrap, the
    dynamic arm leaves its start in contact, and the arm nears a joint
    limit."""
    arm, dyn = toy_run("arm"), toy_run("arm-dynamic")
    for run in (arm, dyn):
        assert run.checkpoints["traj_wrap"][0] < N_TOY - 1
        assert run.checkpoints["ring_wrap"][0] == run.exp.cfg.buffer_capacity
    assert dyn.checkpoints["contact_exit"][0] < N_TOY - 1
    assert min(arm.min_margin, dyn.min_margin) < 0.5


@pytest.mark.slow
@pytest.mark.parametrize("case", list(CHECKPOINTS))
def test_resynchronised_ticks_small_size(case):
    """The run entry's ``--small`` sizes (1024-slot rings) over 1100 ticks,
    at every checkpoint and every 100th tick."""
    run = JaxRun(case, LONG, N_LONG, every=100)
    exp_t = run.port()
    for name in CHECKPOINTS[case]:
        assert name in run.checkpoints, f"the JAX run never reached {name}"
    for name in run.checkpoints:
        check_tick(run, exp_t, name)


def test_jax_cli_learning_paths_part_by_rounding():
    """The JAX study CLI learns through ``Experiment.run_chunk`` or, with
    ``--host-loop``, through the host loop. On the toy arm run both absorb
    the same first 21 samples (1e-6) and then part linearly by rounding
    (the fused programs differ; 1.3e-4 by sample 60), where the port's two
    paths run the same operations and are bit-equal. Only the host loop
    logs the first step's stuck reset, which moves nothing:
    ``SyntheticBridge.reset`` leaves the arm where it is."""
    run = toy_run("arm")
    exp = run.exp
    es0 = run.checkpoints["start"][1]
    es_a, _ = jax.jit(lambda s: exp.run_chunk(s, 60))(es0)
    bridge = jb.SyntheticBridge(exp.env, es0.env)
    runner = JRunner(exp, bridge)
    es_b = runner.run(es0, 60)
    assert runner.events == ["stuck_reset"]
    xa, xb = np.asarray(es_a.buf.x), np.asarray(es_b.buf.x)
    np.testing.assert_allclose(xb[:21], xa[:21], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(xb[:60], xa[:60], rtol=1e-3, atol=1e-3)
    assert not np.array_equal(xb[:60], xa[:60])


@pytest.mark.parametrize("method", ["entklerg", "randomWalk"])
def test_converted_free_env_state_ticks_as_jax(method):
    """``experiment_state_from_jax`` on the free env, with the planner and
    with a baseline's state: the converted rings, z ring, planner and env
    equal the JAX leaves, and the port's tick from them equals the JAX
    tick (``test_torch_tick.py``'s draws and tolerances)."""
    toy = {**TOY, "states": "xyw", "explr_method": method}
    exp_j = JExperiment(JConfig(**toy), train_calls_per_tick=1, train_every=1)
    tick = jax.jit(exp_j.tick)
    es = exp_j.init(seed=3)
    for _ in range(5):
        es, _ = tick(es)
    exp_t = Experiment(ExperimentConfig(**toy), train_calls_per_tick=1, train_every=1,
                       device="cpu")
    es_t = experiment_state_from_jax(es, exp_t)
    same = np.testing.assert_array_equal
    same(es_t.buf.x.numpy(), np.asarray(es.buf.x))
    same(es_t.buf.y.numpy(), np.asarray(es.buf.y))
    same(es_t.buf.beta.numpy(), np.asarray(es.buf.beta))
    assert (es_t.buf.pos, es_t.buf.size, es_t.buf.total, int(es_t.buf.beta_size)) == (
        int(es.buf.pos), int(es.buf.size), int(es.buf.total), int(es.buf.beta_size))
    same(es_t.pstate.memory.buf.numpy(), np.asarray(es.pstate.memory.buf))
    same(es_t.mstate.z_buff.numpy(), np.asarray(es.mstate.z_buff))
    same(es_t.env.pose.numpy(), np.asarray(es.env.pose))
    assert (es_t.explr_step, es_t.learning_ind, es_t.hyper.iter) == (
        5, int(es.learning_ind), int(es.hyper.iter))
    es2, info = tick(es)
    es_t, info_t = exp_t.tick(es_t, _jax_tick_draws(exp_j, es, es2))
    slot = int(es_t.buf.pos) - 1
    _close(es_t.env.pose, es2.env.pose, 1e-4, 1e-5, "env pose")
    _close(es_t.buf.x[slot], es2.buf.x[slot], 1e-4, 1e-4, "pushed pose")
    if method == "randomWalk":
        _close(es_t.pstate.x, es2.pstate.x, 1e-5, 1e-6, "baseline x")
    else:
        _close(es_t.pstate.u, es2.pstate.u, 2e-3, 2e-4, "plan u")
    for key in ("beta", "gamma", "loss"):
        _close(info_t[key], info[key], 1e-3, 1e-6, key)
    assert float(info_t["loss"]) != 0.0
