"""The planner's horizon recurrences (``control/horizon.py``) and their
kernels (``ops/rollout.py``, ``csrc/rollout.cu``): the rollout and the
costate sweep.

On the CPU the plain versions, ``horizon_rollout_reference`` and
``costate_sweep_reference``, are held bit for bit against ``dyn.step``,
``policy.act`` and ``rk4_step`` called step by step, for every dynamics
model, warm-start policy, batch and integrator; and the wrappers raise on
what the kernels do not take. On the card (``cuda``-marked, skipped
without one) each kernel is held against its plain version at the cells'
shapes, and a plan's launches are counted through the replayed tick
graph. This file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_rollout.py
"""

import math

import numpy as np
import pytest
import torch

from ealv_tpu_torch.control import DynState, horizon as th, make_dynamics, make_policy, rk4_step
from ealv_tpu_torch.ops import rollout as tro

H = 10
MODELS = {"linear": dict(states="xyw"), "speed": dict(states="xyw", use_magnitude=True),
          "roll": dict(states="xyzrpw")}
POLICIES = ["Roll", "Zero", "BarrierPush", "LQR"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _model(name, dev, use_rk4=True):
    return make_dynamics(dt=0.2, use_rk4=use_rk4, device=dev, **MODELS[name])


def _start(dyn, dev, rng, near_cut=False):
    """A start state with positions past the barrier's bounds now and then
    (so BarrierPush acts); ``near_cut`` puts the roll model's angles by the
    wrap cuts and the pitch near pi/2."""
    m = dyn.num_actions
    x = rng.uniform(-1.2, 1.2, dyn.num_states)
    x[m: 2 * m] = rng.uniform(-1.5, 1.5, m)
    if near_cut and hasattr(dyn, "rpw"):
        x[list(dyn.rpw)] = (-1e-4, math.pi / 2 - 0.05, math.pi - 1e-4)
        x[[r + m for r in dyn.rpw]] = (-0.8, 0.6, 0.9)
    return dyn.init(torch.tensor(x, dtype=torch.float32, device=dev))


def _plans(dyn, k, dev, rng):
    shape = (H, dyn.num_actions) if k == 1 else (k, H, dyn.num_actions)
    return torch.tensor(rng.uniform(-1, 1, shape), dtype=torch.float32, device=dev)


def _step_by_step(dyn, policy, s: DynState, u):
    """The planner's old loop: act at the pre-step state, step, keep."""
    batch = u.shape[:-2]
    s = DynState(x=s.x.expand(*batch, *s.x.shape), R=s.R.expand(*batch, *s.R.shape))
    xs, Rs, us = [s.x], [s.R], []
    for t in range(u.shape[-2]):
        ut = policy.act(s.x, u[..., t, :])
        us.append(ut)
        s = dyn.step(s, ut)
        xs.append(s.x)
        Rs.append(s.R)
    return torch.stack(xs, -2), torch.stack(Rs, -3), torch.stack(us, -2)


@pytest.mark.parametrize("use_rk4", [True, False], ids=["rk4", "euler"])
@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("model", list(MODELS))
def test_rollout_reference_is_the_step_by_step_loop(model, policy, k, use_rk4):
    """Bit for bit: the states x_0..x_H, the carried R and the applied
    controls; ``rollout`` on CPU tensors is the reference."""
    rng = np.random.default_rng(1)
    dyn = _model(model, "cpu", use_rk4)
    pol = make_policy(policy, dyn, H)
    s0, u = _start(dyn, "cpu", rng), _plans(dyn, k, "cpu", rng)
    want = _step_by_step(dyn, pol, s0, u)
    before = tro.horizon_rollout.launches
    for got in (th.horizon_rollout_reference(dyn, pol, s0.x, s0.R, u),
                th.rollout(dyn, pol, s0.x, s0.R, u)):
        for a, b in zip(got, want, strict=True):
            assert a.shape == b.shape and torch.equal(a, b)
    assert tro.horizon_rollout.launches == before


@pytest.mark.parametrize("model", list(MODELS))
def test_rollout_without_a_policy_applies_the_plans(model):
    rng = np.random.default_rng(2)
    dyn = _model(model, "cpu")
    s0, u = _start(dyn, "cpu", rng), _plans(dyn, 5, "cpu", rng)
    xs, Rs, ue = th.rollout(dyn, None, s0.x, s0.R, u)
    want = _step_by_step(dyn, make_policy("Roll", dyn, H), s0, u)
    assert torch.equal(ue, u)
    for a, b in zip((xs, Rs), want[:2]):
        assert torch.equal(a, b)


def _costate_inputs(n, dev, rng):
    drive = torch.tensor(rng.standard_normal((H, n)), dtype=torch.float32, device=dev)
    jac = torch.tensor(rng.standard_normal((H, n, n)), dtype=torch.float32, device=dev)
    return drive, jac


@pytest.mark.parametrize("n", [6, 9, 12])
def test_costate_reference_is_the_step_by_step_rk4(n):
    """Bit for bit against rk4_step on rho' = drive[t] - M[t] rho with
    M = jac^T, backwards from rho = 0."""
    drive, jac = _costate_inputs(n, "cpu", np.random.default_rng(n))
    M = jac.transpose(-1, -2)
    rho, want = torch.zeros(n), [None] * H
    for t in reversed(range(H)):
        rho = rk4_step(lambda r, _: drive[t] - M[t] @ r, -0.2, rho, None)
        want[t] = rho
    before = tro.costate_sweep.launches
    for got in (th.costate_sweep_reference(drive, jac, 0.2),
                th.costate(drive, jac, 0.2)):
        assert torch.equal(got, torch.stack(want))
    assert tro.costate_sweep.launches == before


class _OtherModel:
    """A dynamics model the kernel has no code for (no ``rollout_args``)."""

    num_states, num_actions = 6, 3


@pytest.mark.parametrize("case", ["f64 plan", "strided plan", "f64 start", "other model"])
def test_rollout_raises_on_what_the_kernel_does_not_take(case):
    rng = np.random.default_rng(3)
    dyn = _model("linear", "cpu")
    s0, u = _start(dyn, "cpu", rng), _plans(dyn, 5, "cpu", rng)
    x0 = s0.x
    if case == "f64 plan":
        u, err = u.double(), TypeError
    elif case == "strided plan":
        u, err = u.transpose(0, 1).contiguous().transpose(0, 1), ValueError
    elif case == "f64 start":
        x0, err = x0.double(), TypeError
    else:
        dyn, err = _OtherModel(), TypeError
    with pytest.raises(err):
        th.rollout(dyn, None, x0, s0.R, u)


@pytest.mark.parametrize("case", ["f64 drive", "strided jac", "jac shape"])
def test_costate_raises_on_what_the_kernel_does_not_take(case):
    drive, jac = _costate_inputs(6, "cpu", np.random.default_rng(4))
    if case == "f64 drive":
        drive, err = drive.double(), TypeError
    elif case == "strided jac":
        jac, err = jac.transpose(-1, -2), ValueError
    else:
        jac, err = jac[:, :5], ValueError
    with pytest.raises(err):
        th.costate(drive, jac, 0.2)


@pytest.mark.parametrize("model", list(MODELS))
def test_kernel_wrappers_take_cuda_tensors_only(model):
    """``ops/rollout.py`` takes the model's and the policy's kernel
    arguments as plain tensors and numbers, accepts them on any device
    (``check_rollout``), and launches only on the card: a CPU tensor raises
    there, since the plain versions live in ``control/horizon.py``."""
    rng = np.random.default_rng(9)
    dyn = _model(model, "cpu")
    s0, u = _start(dyn, "cpu", rng), _plans(dyn, 5, "cpu", rng)
    before = (tro.horizon_rollout.launches, tro.costate_sweep.launches)
    for policy in POLICIES:
        args = {**dyn.rollout_args(), **make_policy(policy, dyn, H).rollout_args()}
        assert tro.check_rollout(s0.x, s0.R, u, **args) == (5, H, dyn.num_states,
                                                             dyn.num_actions)
        with pytest.raises(TypeError):
            tro.horizon_rollout(s0.x, s0.R, u, **args)
    drive, jac = _costate_inputs(dyn.num_states, "cpu", rng)
    assert tro.check_costate(drive, jac) == (H, dyn.num_states)
    with pytest.raises(TypeError):
        tro.costate_sweep(drive, jac, 0.2)
    assert (tro.horizon_rollout.launches, tro.costate_sweep.launches) == before


# ------------------------------------------------------------------ on the card

@pytest.mark.cuda
@pytest.mark.parametrize("near_cut", [False, True], ids=["random", "near-cut"])
@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("model", list(MODELS))
def test_rollout_kernel_matches_plain(cuda, model, policy, k, near_cut):
    """The kernel against the plain version on the card at the cells'
    shapes (n = 6, 9, 12; H = 10; K = 1 and 5). The double integrator and
    the speed model are bit-equal under every policy but LQR, whose gain
    is a dense matvec that cuBLAS sums in its own order; the roll model
    and LQR within 1e-6 relative (printed)."""
    rng = np.random.default_rng(5)
    dyn = _model(model, cuda)
    pol = make_policy(policy, dyn, H)
    s0, u = _start(dyn, cuda, rng, near_cut), _plans(dyn, k, cuda, rng)
    before = tro.horizon_rollout.launches
    got = th.rollout(dyn, pol, s0.x, s0.R, u)
    want = th.horizon_rollout_reference(dyn, pol, s0.x, s0.R, u)
    torch.cuda.synchronize()
    assert tro.horizon_rollout.launches == before + 1
    gaps = [th.state_gap(got[0], want[0], getattr(dyn, "rpw", ())),
            th.state_gap(got[1], want[1]), th.state_gap(got[2], want[2])]
    print(f"rollout {model} {policy} K={k} {'near-cut' if near_cut else 'random'}: "
          f"states {gaps[0]:.3e}, R {gaps[1]:.3e}, controls {gaps[2]:.3e}")
    if model != "roll" and policy != "LQR":
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    else:
        assert max(gaps) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("model", list(MODELS))
def test_costate_kernel_matches_plain(cuda, model, policy):
    """The sweep against the plain version on the planner's own matrices,
    A + B dmu at a rollout's pre-step states: bit-equal where each row of
    the transposed matrix has at most two nonzeros, whose sum no order
    changes (the double integrator under every policy but LQR, the speed
    model under Roll and Zero), else within 1e-6 relative (BarrierPush
    gives the speed model's velocity rows three); and on a dense random
    matrix within 1e-5."""
    rng = np.random.default_rng(6)
    dyn = _model(model, cuda)
    pol = make_policy(policy, dyn, H)
    s0, u = _start(dyn, cuda, rng), _plans(dyn, 1, cuda, rng)
    xs, Rs, ue = th.horizon_rollout_reference(dyn, pol, s0.x, s0.R, u)
    xs, Rs = xs[:-1], Rs[:-1]
    n = dyn.num_states
    A, B = dyn.get_lin(DynState(x=xs, R=Rs), ue) if dyn.state_dependent else (dyn.A, dyn.B)
    jac = A.expand(H, n, n) + B.expand(H, n, dyn.num_actions) @ pol.dx(xs, ue)
    drive = torch.tensor(rng.standard_normal((H, n)), dtype=torch.float32, device=cuda)
    got, want = th.costate(drive, jac, 0.2), th.costate_sweep_reference(drive, jac, 0.2)
    gap = th.state_gap(got, want)
    print(f"costate {model} {policy}: {gap:.3e}")
    if model == "linear" and policy != "LQR" or model == "speed" and policy in ("Roll", "Zero"):
        assert torch.equal(got, want)
    else:
        assert gap <= 1e-6
    drive, jac = _costate_inputs(n, cuda, rng)
    torch.testing.assert_close(th.costate(drive, jac, 0.2),
                               th.costate_sweep_reference(drive, jac, 0.2),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_kernels_raise_on_other_inputs_on_the_card(cuda):
    rng = np.random.default_rng(7)
    dyn = _model("roll", cuda)
    s0, u = _start(dyn, cuda, rng), _plans(dyn, 5, cuda, rng)
    with pytest.raises(TypeError):
        th.rollout(dyn, None, s0.x, s0.R, u.double())
    with pytest.raises(ValueError):
        th.rollout(dyn, None, s0.x, s0.R, u[:, ::2])
    with pytest.raises(TypeError):
        th.rollout(dyn, None, s0.x, s0.R.cpu(), u)
    drive, jac = _costate_inputs(12, cuda, rng)
    with pytest.raises(ValueError):
        th.costate(drive, jac.transpose(-1, -2), 0.2)


@pytest.mark.cuda
@pytest.mark.parametrize("states", ["xyw", "xyzrpw"])
def test_plans_replayed_in_the_tick_graph_launch_17_rollouts_and_5_sweeps(cuda, states,
                                                                            monkeypatch):
    """Six EvalExperiment ticks toward an ExplrDist, through the tick graph
    and eagerly, in turns: the eval state bit for bit after every tick, and
    every plan (one a tick) 17 rollout launches (the initial cost, two costs an
    inner iteration, five forward passes and the final rollout) and 5
    costate sweeps, read through the replays (``graphs.total_launches``);
    no planner call runs its per-step loop on the card."""
    from ealv_tpu_torch.control import ExplrDist
    from ealv_tpu_torch.runtime import EvalExperiment, graphs as tg
    from ealv_tpu_torch.runtime.graphs import _fields, _leaf
    from ealv_tpu_torch.utils.config import ExperimentConfig

    cfg = ExperimentConfig(states=states, image_dim=(24, 24, 3), cnn_kernels=(3, 3),
                           cnn_strides=(2, 2), cnn_channels=(8, 8), hidden_dim=(64, 32),
                           z_dim=8, num_target_samples=128, num_traj_samples=64,
                           traj_buffer_capacity=256, buffer_capacity=256,
                           compute_dtype="float32")
    rng = np.random.default_rng(8)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=cuda)
    ctx = ExplrDist.create(8, cfg.s_dim, device=cuda)
    for _ in range(3):
        ctx = ctx.push(t(rng.uniform(-0.6, 0.6, cfg.s_dim)), t(rng.uniform(0.02, 0.08, cfg.s_dim)))

    def leaves(tree, out):
        if isinstance(tree, torch.Generator):
            out.append(tree.get_state())
        elif isinstance(tree, torch.Tensor) or _leaf(tree) or isinstance(tree, torch.nn.Module):
            out.append(tree)
        else:
            for _, v in _fields(tree)[1]:
                leaves(v, out)
        return out

    runs = []
    for graphs in (False, True):
        ev_exp = EvalExperiment(cfg, lambda c, s: c.pdf(s), device=cuda)
        if not graphs:
            ev_exp.tick_graph = None
        runs.append([ev_exp, ev_exp.init(seed=2)])

    def plain(*a):
        raise AssertionError("a planner call on the card ran the per-step loop")

    monkeypatch.setattr(th, "horizon_rollout_reference", plain)
    monkeypatch.setattr(th, "costate_sweep_reference", plain)
    tg.reset_launches()
    try:
        for k in range(6):
            for run in runs:
                run[1], _ = run[0].tick(run[1], ctx)
            for a, b in zip(leaves(runs[0][1], []), leaves(runs[1][1], []), strict=True):
                if isinstance(a, torch.Tensor):
                    assert torch.equal(a, b), k
                elif not isinstance(a, torch.nn.Module):
                    assert a == b, k
        counts = tg.total_launches()
    finally:
        tg.reset_launches()
    assert (counts["horizon_rollout"], counts["costate_sweep"]) == (2 * 6 * 17, 2 * 6 * 5)
    assert runs[1][0].tick_graph.replays >= 4
