"""The planner's plan cost (``control/descent.py::plan_cost``) and its kernel
(``ops/descent.py::plan_cost``, ``csrc/descent.cu``): the footprint of a
plan or of candidate plans, the renormalisation, the KL divergence and the
box barrier in one launch.

On the CPU ``plan_cost_reference`` is held bit for bit against the
planner's former ``_cost`` (frozen below), which the step-matched tests
hold against the JAX package; the wrapper raises on what the kernel does
not take; a CPU plan launches none, and routes 11 costs a plan through
``plan_cost`` at the default mode. On the card (``cuda``-marked, skipped
without one) the kernel is held against ``plan_cost_reference`` on the same
CUDA tensors to 1e-6 relative, at the edge cases too; a candidate equal to
the nominal plan gets the single plan's bits; a replay gives the same
bits; whole plans through the kernel are bit-equal to plans through the
plain cost (under ``full_cost``, or they part at a near-tie of the slot's
costs); and replayed eval ticks count 11 launches a plan. The card runs

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cost_kernel.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from ealv_tpu_torch import control as tc
from ealv_tpu_torch.control import descent as td
from ealv_tpu_torch.control import klerg as tklerg
from ealv_tpu_torch.ops import cost_norm, psi_matrix, renormalize, traj_footprint
from ealv_tpu_torch.ops import descent as tdo

STATES = {2: "xy", 3: "xyw", 6: "xyzrpw"}
KS = [1, 5, 10]
BARRIERS = ["box", "none"]
RTOL = 1e-6  # the kernel against the plain version: the order of summation only


def _bits(a, b) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape or a.device != b.device:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def _former_cost(pl, dyn0, u_test, samples, p_n, q_base, barrier):
    """``KlergPlanner._cost`` as it was before the cost kernel."""
    if u_test.ndim == 2:
        traj = pl._traj_states(dyn0, u_test)
        q_iter = traj_footprint(traj, samples, pl._explr_idx, pl.std)
        q = cost_norm(renormalize(q_base + q_iter))
        return (p_n * torch.log(p_n / q)).sum() + barrier.batch(traj).sum()
    trajs = pl._traj_states(dyn0, u_test)
    k, h, _ = trajs.shape
    flat = trajs[..., pl._explr_idx].reshape(k * h, -1)
    psi_m = psi_matrix(samples, flat, pl.std)
    q_iters = psi_m.reshape(-1, k, h).sum(-1).T
    q = renormalize(q_base[None, :] + q_iters, dim=1)
    q = torch.where(torch.isnan(q), torch.full_like(q, 1e-6), q)
    q = q / q.sum(1, keepdim=True)
    d_kl = (p_n[None, :] * torch.log(p_n[None, :] / q)).sum(1)
    return d_kl + barrier.batch(trajs).sum(-1)


def _plain(trajs, samples, p_n, q_base, std, explr_idx, explr_locs, barrier):
    """``plan_cost`` through the plain version on any device."""
    return td.plan_cost_reference(trajs, samples, p_n, q_base, std, explr_idx, barrier)


def _case(d: int, k: int, barrier: str, dev, n: int = 700, seed: int = 0, H: int = 10):
    """A planner at ``STATES[d]``, its start, control plans (H, m) for k = 1
    or (k, H, m), fed samples, target and base footprint, and the barrier
    (the box from ``setup_barrier`` or none)."""
    states = STATES[d]
    rng = np.random.default_rng(seed + 100 * d + k)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    dyn = tc.make_dynamics(states, dt=0.1, device=dev)
    m = dyn.num_actions
    cfg = tc.KlergConfig(horizon=H, num_target_samples=n, num_traj_samples=64, std=0.05)
    pl = tc.KlergPlanner(cfg, dyn, tc.make_policy("Roll", dyn, H), lambda _c, s: s[:, 0],
                         states, explr_locs=list(range(d)), device=dev)
    lim = t([[-1.0, 1.0]] * d)
    box, _ = tc.setup_barrier(states, lim, t([[-1.0, 1.0]] * m), list(range(d)))
    x0 = np.zeros(dyn.num_states, np.float32)
    x0[:d] = rng.uniform(-0.8, 0.8, d)
    dyn0 = dyn.init(t(x0))
    u = t(rng.normal(0.0, 1.0, (H, m) if k == 1 else (k, H, m)))
    samples = t(rng.uniform(-1.1, 1.1, (n, d)))
    p = rng.uniform(0.1, 1.0, n).astype(np.float32)
    p_n = cost_norm(t(p))
    q_base = t(rng.uniform(0.0, 3.0, n))
    return pl, dyn0, u, samples, p_n, q_base, box if barrier == "box" else tc.NoBarrier()


# ------------------------------------------------------------------ on the CPU

@pytest.mark.parametrize("barrier", BARRIERS)
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("d", list(STATES))
def test_reference_is_the_former_cost(d, k, barrier):
    """``plan_cost_reference`` and the planner's ``_cost`` (on the CPU: the
    reference) give the former ``_cost``'s bits, for one plan and for 5 and
    10 candidates, at d = 2, 3 and 6, with the box barrier and without."""
    pl, dyn0, u, samples, p_n, q_base, bar = _case(d, k, barrier, "cpu")
    want = _former_cost(pl, dyn0, u, samples, p_n, q_base, bar)
    trajs = pl._traj_states(dyn0, u)
    got = td.plan_cost_reference(trajs, samples, p_n, q_base, pl.std, pl._explr_idx, bar)
    assert _bits(got, want)
    assert _bits(pl._cost(dyn0, u, samples, p_n, q_base, bar), want)
    assert want.shape == (() if k == 1 else (k,)) and torch.isfinite(want).all()


def test_a_barrier_the_kernel_does_not_know_is_added_plainly():
    """The tilt barrier passes no rows to the kernel; its plain ``batch``
    sum is added to the kernel's cost, as the reference adds it."""
    pl, dyn0, u, samples, p_n, q_base, box = _case(6, 5, "box", "cpu")
    tilt = tc.TiltBarrierFunction(inner=box)
    assert td._barrier_rows(tilt) is None and td._barrier_rows(tc.NoBarrier()) == ()
    assert td._barrier_rows(box) == (box.b_lim, box.barr_weight, box.power)
    want = _former_cost(pl, dyn0, u, samples, p_n, q_base, tilt)
    assert _bits(pl._cost(dyn0, u, samples, p_n, q_base, tilt), want)


REFUSED = ["f64 trajs", "f64 samples", "strided trajs", "strided samples", "p_n shape",
           "std shape", "mixed device", "4-D trajs", "H past the kernel", "N past the kernel",
           "d past the kernel", "column past n", "numpy column", "rows past n",
           "partial barrier", "b_lim shape", "K past the kernel"]


def _refused(case: str):
    """The wrapper's arguments with the fault ``case`` names, and the error."""
    pl, dyn0, u, samples, p_n, q_base, box = _case(3, 5, "box", "cpu", n=64)
    trajs = pl._traj_states(dyn0, u)
    cols, rows = list(pl._explr_cols), [box.b_lim, box.barr_weight, box.power]
    std, err = pl.std, ValueError
    if case == "f64 trajs":
        trajs, err = trajs.double(), TypeError
    elif case == "f64 samples":
        samples, err = samples.double(), TypeError
    elif case == "strided trajs":
        trajs = trajs.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "strided samples":
        samples = samples.t().contiguous().t()
    elif case == "p_n shape":
        p_n = p_n[:-1]
    elif case == "std shape":
        std = torch.cat([std, std])
    elif case == "mixed device":
        q_base, err = q_base.to("meta"), TypeError
    elif case == "4-D trajs":
        trajs = trajs[None]
    elif case == "H past the kernel":
        trajs = torch.zeros((2, tdo.MAX_COST_HORIZON + 1, trajs.shape[-1]))
    elif case == "N past the kernel":
        n = tdo.MAX_COST_SAMPLES + 1
        samples, p_n, q_base = torch.zeros((n, 3)), torch.ones(n), torch.ones(n)
    elif case == "d past the kernel":
        trajs = torch.zeros((5, 10, 12))
        samples, std, cols = torch.zeros((64, 9)), torch.ones(9), list(range(9))
    elif case == "column past n":
        cols[2] = trajs.shape[-1]
    elif case == "numpy column":
        cols[0] = np.int64(0)
    elif case == "rows past n":
        rows = [torch.zeros((7, 2)), torch.ones(7), torch.ones(7)]
    elif case == "partial barrier":
        rows[2] = None
    elif case == "b_lim shape":
        rows[0] = torch.zeros((6, 3))
    else:
        trajs = torch.zeros((tdo.MAX_CANDIDATES + 1, 1, trajs.shape[-1]))
    return (trajs, samples, p_n, q_base, std, cols, *rows), err


@pytest.mark.parametrize("case", REFUSED)
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    """The checks raise on any device: the kernel wrapper, and the plain
    path, which runs them before the reference."""
    args, err = _refused(case)
    with pytest.raises(err):
        tdo.check_cost(*args)
    with pytest.raises(err):
        tdo.plan_cost(*args)


def test_kernel_wrapper_takes_cuda_tensors_only():
    """Good CPU inputs pass the checks and raise at the launch: the plain
    version lives in ``control/descent.py``. The plain path refuses what
    the kernel refuses."""
    pl, dyn0, u, samples, p_n, q_base, box = _case(3, 5, "box", "cpu", n=64)
    trajs = pl._traj_states(dyn0, u)
    rows = (box.b_lim, box.barr_weight, box.power)
    assert trajs.stride(0) == 11 * 6 and not trajs.is_contiguous()  # the rollout's view
    assert tdo.check_cost(trajs, samples, p_n, q_base, pl.std, pl._explr_cols,
                          *rows) == (5, 10, 6, 64, 3, 6)
    assert tdo.check_cost(trajs[0], samples, p_n, q_base, pl.std,
                          pl._explr_cols) == (1, 10, 6, 64, 3, 0)
    before = tdo.plan_cost.launches
    with pytest.raises(TypeError):
        tdo.plan_cost(trajs, samples, p_n, q_base, pl.std, pl._explr_cols, *rows)
    with pytest.raises(ValueError):
        td.plan_cost(trajs, samples, p_n[:-1], q_base, pl.std, pl._explr_idx, pl._explr_cols,
                     box)
    assert tdo.plan_cost.launches == before


def _toy_planner(states, dev, seed=0, policy="Roll", **mode):
    """A toy KlergPlanner on ``states`` with a Gaussian target, its state
    with a filled history and a random plan, and fed draws."""
    H, N, M = 10, 96, 64
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    dyn = tc.make_dynamics(states, dt=0.1, device=dev)
    n, m, d = dyn.num_states, dyn.num_actions, len(states)
    cfg = tc.KlergConfig(horizon=H, num_target_samples=N, num_traj_samples=M, R=0.5,
                         std=0.05, **mode)
    mu, var = t(rng.uniform(-0.5, 0.5, d)), t(rng.uniform(0.05, 0.1, d))
    pl = tc.KlergPlanner(cfg, dyn, tc.make_policy(policy, dyn, H),
                         lambda _c, s: torch.exp(-0.5 * ((s - mu) ** 2 / var).sum(-1)),
                         states, explr_locs=list(range(d)), device=dev)
    lim = t([[-1.0, 1.0]] * d)
    barrier, _ = tc.setup_barrier(states, lim, t([[-1.0, 1.0]] * m), list(range(d)))
    x0 = np.zeros(n, np.float32)
    x0[:d] = rng.uniform(-0.5, 0.5, d)
    ps = pl.init_state(t(x0), lim, barrier, buffer_capacity=128, explr_lim_scale=1.15)
    for _ in range(M):
        h = np.zeros(n, np.float32)
        h[:d] = rng.uniform(-0.9, 0.9, d)
        ps.memory.push(t(h))
    ps = dataclasses.replace(ps, u=t(rng.normal(0.0, 0.3, (H, m))))
    draws = dict(samples=t(rng.uniform(-1.15, 1.15, (N, d))),
                 hist_idx=torch.as_tensor(rng.permutation(M), device=dev))
    return pl, ps, draws


MODES = {"default": {}, "fixed_lam": {"fixed_lam": True},
         "no search": {"ctrl_app_search": False}, "full_cost": {"full_cost": True}}
# cost calls a plan at num_iters 5: the initial cost, then in each inner
# iteration the full_cost substitutions, the search's windows and the new plan
COSTS_A_PLAN = {"default": 11, "fixed_lam": 6, "no search": 6, "full_cost": 16}


@pytest.mark.parametrize("mode", list(MODES))
def test_a_cpu_plan_routes_its_costs_and_launches_none(mode, monkeypatch):
    """Every cost of a CPU plan goes through ``plan_cost`` (11 a plan at
    the default mode, 6 under ``fixed_lam`` or without the slot search, 16
    under ``full_cost``) and runs the plain version: the kernel's count
    and the graphs' tally do not move."""
    from ealv_tpu_torch.runtime import graphs as tg
    calls = []
    monkeypatch.setattr(tklerg, "plan_cost",
                        lambda *a, _fn=tklerg.plan_cost: calls.append(1) or _fn(*a))
    before = tg.total_launches()["plan_cost"]
    pl, ps, draws = _toy_planner("xy", "cpu", **MODES[mode])
    ps, info = pl.plan(ps, None, **draws)
    assert torch.isfinite(info["cost"])
    assert len(calls) == COSTS_A_PLAN[mode]
    assert tg.total_launches()["plan_cost"] == before


# ------------------------------------------------------------------ on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want):
    gap = ((got - want).abs() / want.abs().clamp(min=1e-30)).max()
    assert gap <= RTOL, f"relative gap {float(gap):.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("n", [300, 2000, 2010, 4000])
@pytest.mark.parametrize("barrier", BARRIERS)
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("d", list(STATES))
def test_kernel_matches_plain(cuda, d, k, barrier, n):
    """The kernel against ``plan_cost_reference`` on the same CUDA tensors
    (K1 for one plan, the plain psi matrix for candidates), one launch a
    call, at one, four and eight samples a thread."""
    pl, dyn0, u, samples, p_n, q_base, bar = _case(d, k, barrier, cuda, n=n)
    trajs = pl._traj_states(dyn0, u)
    before = tdo.plan_cost.launches
    got = td.plan_cost(trajs, samples, p_n, q_base, pl.std, pl._explr_idx, pl._explr_cols, bar)
    assert tdo.plan_cost.launches == before + 1
    want = td.plan_cost_reference(trajs, samples, p_n, q_base, pl.std, pl._explr_idx, bar)
    assert got.shape == want.shape
    _close(got, want)


EDGES = ["underflow", "clamp", "on a point", "outside both limits", "tilt"]


def _edge(case: str, dev):
    pl, dyn0, u, samples, p_n, q_base, box = _case(3, 5, "box", dev, n=2000)
    trajs = pl._traj_states(dyn0, u).clone()
    if case == "underflow":  # every psi is 0 and so is q_base: the NaN rule
        trajs[..., :3] += 100.0
        q_base = torch.zeros_like(q_base)
    elif case == "clamp":  # q_base 0: most of q / sum falls below 1e-6
        q_base = torch.zeros_like(q_base)
    elif case == "on a point":
        samples = samples.clone()
        samples[0] = trajs[0, 3, :3]
        samples[1] = trajs[4, 9, :3]
    elif case == "outside both limits":
        trajs[:, ::2, :] = 2.0
        trajs[:, 1::2, :] = -2.0
    elif case == "tilt":
        box = tc.TiltBarrierFunction(inner=box, r_idx=0, p_idx=1)
    return pl, trajs, samples, p_n, q_base, box


@pytest.mark.cuda
@pytest.mark.parametrize("case", EDGES)
def test_kernel_matches_plain_at_the_edges(cuda, case):
    """Every psi underflowing with no base (the clamp and the NaN rule), a
    base of 0 (the clamp), samples exactly on trajectory points, states
    outside both limits of every barrier row, and a barrier the kernel
    does not know, for one plan and for five candidates."""
    pl, trajs, samples, p_n, q_base, bar = _edge(case, cuda)
    for x in (trajs, trajs[2]):
        got = td.plan_cost(x, samples, p_n, q_base, pl.std, pl._explr_idx, pl._explr_cols, bar)
        want = td.plan_cost_reference(x, samples, p_n, q_base, pl.std, pl._explr_idx, bar)
        assert torch.isfinite(want).all()
        _close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("d", list(STATES))
def test_a_candidate_equal_to_the_plan_gets_its_bits(cuda, d):
    """Candidates whose third is the nominal plan: its cost is the single
    plan's to the bit (K1's footprint in both); a captured launch replayed
    twice gives the eager call's bits."""
    pl, dyn0, u, samples, p_n, q_base, bar = _case(d, 5, "box", cuda, n=2000)
    args = (samples, p_n, q_base, pl.std, pl._explr_idx, pl._explr_cols, bar)
    trajs = pl._traj_states(dyn0, u)
    single = td.plan_cost(pl._traj_states(dyn0, u[2].clone()), *args)
    batch = td.plan_cost(trajs, *args)
    assert _bits(batch[2], single)
    assert not _bits(batch[1], single)

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        td.plan_cost(trajs, *args)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = td.plan_cost(trajs, *args)
    replays = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        replays.append(out.clone())
    assert _bits(replays[0], batch) and _bits(replays[1], batch)


# full_cost has a test of its own below
PLAN_MODES = {**{k: v for k, v in MODES.items() if k != "full_cost"}, "BarrierPush": {}}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(PLAN_MODES))
@pytest.mark.parametrize("states", ["xy", "xyw", "xyzrpw"])
def test_plans_with_the_kernel_are_the_plain_plans(cuda, states, mode, monkeypatch):
    """Toy plans on the card through the cost kernel, then through the
    plain cost (the same fed draws and generator state), over 10 seeds at
    m = 2, 3 and 6 in the default mode, under ``fixed_lam``, without the
    slot search and with the BarrierPush policy: plan, cost, kept footprint
    and rolled-out plan bit for bit; the kernel's launches a plan as
    ``COSTS_A_PLAN`` says, and none on the plain path."""
    from ealv_tpu_torch.runtime import graphs as tg
    policy = "BarrierPush" if mode == "BarrierPush" else "Roll"
    kernel_cost = tklerg.plan_cost
    for seed in range(10):
        outs = []
        for plain in (False, True):
            pl, ps, draws = _toy_planner(states, cuda, seed=seed, policy=policy,
                                         **PLAN_MODES[mode])
            monkeypatch.setattr(tklerg, "plan_cost", _plain if plain else kernel_cost)
            tg.reset_launches()
            ps, info = pl.plan(ps, None, **draws)
            launched = tg.total_launches()["plan_cost"]
            assert launched == (0 if plain else COSTS_A_PLAN.get(mode, 11)), seed
            outs.append((ps.u, ps.last_plan, info["cost"], info["q"]))
        tg.reset_launches()
        for name, a, b in zip(("u", "last_plan", "cost", "q"), *outs):
            assert _bits(a, b), (seed, name)


@pytest.mark.cuda
@pytest.mark.parametrize("states", ["xy", "xyw", "xyzrpw"])
def test_full_cost_plans_part_only_at_near_ties(cuda, states, monkeypatch):
    """``full_cost`` takes the slot from the costs of the H one-slot
    substitutions of u_star into the plan, which lie within a few 1e-7 of
    each other where a late slot changes little; there the order of
    summation can move the least. So over 10 seeds at m = 2, 3 and 6 a
    plan through the kernel is bit-equal to the plain plan, or the two
    first differ after a batch whose two least costs lie within 1e-6 of
    each other, every cost before agreeing to 1e-6 (PERF.md section 7 lists
    the seeds). 16 kernel launches a plan."""
    from ealv_tpu_torch.runtime import graphs as tg
    kernel_cost = tklerg.plan_cost
    for seed in range(10):
        outs, recs = [], []
        for fn in (kernel_cost, _plain):
            rec = []

            def recorded(*a, _fn=fn, _rec=rec):
                out = _fn(*a)
                _rec.append((a[0].clone(), out.clone()))
                return out

            monkeypatch.setattr(tklerg, "plan_cost", recorded)
            pl, ps, draws = _toy_planner(states, cuda, seed=seed, full_cost=True)
            tg.reset_launches()
            ps, info = pl.plan(ps, None, **draws)
            assert tg.total_launches()["plan_cost"] == (16 if fn is kernel_cost else 0)
            outs.append((ps.u, ps.last_plan, info["cost"], info["q"]))
            recs.append(rec)
        tg.reset_launches()
        if all(_bits(a, b) for a, b in zip(*outs)):
            continue
        kern, plain = recs
        first = next(i for i, (a, b) in enumerate(zip(kern, plain)) if not _bits(a[0], b[0]))
        for (_, a), (_, b) in zip(kern[:first], plain[:first]):
            _close(a, b)
        batch = max(i for i in range(first) if kern[i][1].dim() == 1)
        for costs in (kern[batch][1], plain[batch][1]):
            least = torch.sort(costs).values[:2]
            assert (least[1] - least[0]) / least[0] <= RTOL, (seed, costs)


@pytest.mark.cuda
@pytest.mark.parametrize("fixed_lam", [False, True], ids=["search", "fixed_lam"])
def test_replayed_eval_ticks_count_the_cost_launches(cuda, fixed_lam):
    """Six EvalExperiment ticks through the tick graph: every plan (one a
    tick) makes 11 ``plan_cost`` launches (6 under ``fixed_lam``) and 6 K1
    launches (the base footprint and one a forward pass), read through the
    replays (``graphs.total_launches``)."""
    from ealv_tpu_torch.control import ExplrDist
    from ealv_tpu_torch.runtime import EvalExperiment, graphs as tg
    from ealv_tpu_torch.utils.config import ExperimentConfig

    cfg = ExperimentConfig(states="xyw", image_dim=(24, 24, 3), cnn_kernels=(3, 3),
                           cnn_strides=(2, 2), cnn_channels=(8, 8), hidden_dim=(64, 32),
                           z_dim=8, num_target_samples=128, num_traj_samples=64,
                           traj_buffer_capacity=256, buffer_capacity=256,
                           compute_dtype="float32")
    rng = np.random.default_rng(8)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=cuda)
    ctx = ExplrDist.create(8, cfg.s_dim, device=cuda)
    for _ in range(3):
        ctx = ctx.push(t(rng.uniform(-0.6, 0.6, cfg.s_dim)), t(rng.uniform(0.02, 0.08, cfg.s_dim)))
    ev_exp = EvalExperiment(cfg, lambda c, s: c.pdf(s), device=cuda)
    ev_exp.planner.cfg = dataclasses.replace(ev_exp.planner.cfg, fixed_lam=fixed_lam)
    ev = ev_exp.init(seed=2)
    iters = ev_exp.planner.cfg.num_iters
    tg.reset_launches()
    try:
        for _ in range(6):
            ev, _ = ev_exp.tick(ev, ctx)
        counts = tg.total_launches()
    finally:
        tg.reset_launches()
    assert counts["plan_cost"] == 6 * (1 + iters * (1 if fixed_lam else 2))
    assert counts["footprint_and_spread"] == 6 * (1 + iters)
    assert ev_exp.tick_graph.replays >= 4
