"""The planner's inner-iteration bookkeeping (``control/descent.py``) and its
kernels (``ops/descent.py``, ``csrc/descent.cu``): the slot and the
candidate windows, the window search's acceptance, the step's acceptance.

On the CPU the plain versions are held against the JAX package's
``_line_search`` and the acceptance of its inner loop
(``ealv_tpu/control/klerg.py``) on fed inputs, ties and NaNs among them;
the wrappers raise on what the kernels do not take; a CPU plan launches
none. On the card (``cuda``-marked, skipped without one) each launch is
held bit for bit against its plain version on the same CUDA tensors, a
whole plan with the kernels against a plan with the plain versions, and
the launches of replayed eval ticks are counted. The CPU cases import JAX
inside the test; the card runs

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_descent_kernel.py
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from ealv_tpu_torch.control import descent as td
from ealv_tpu_torch.ops import descent as tdo

NAN = float("nan")
# (name, H, m, max_app_dur, idx): the slot and the windows' edge cases
SLOTS = {
    "random": (10, 2, 5, 0),
    "tie": (10, 2, 5, 1),
    "nan": (10, 3, 5, 2),
    "at-0": (10, 3, 5, 3),
    "at-idx": (10, 2, 5, 2),
    "at-end": (10, 6, 5, 1),
    "lam0-clamped": (10, 2, 5, 4),
    "mad-past-H": (6, 3, 9, 1),
    "mad-past-H-at-0": (6, 2, 9, 2),
    "not-negative": (10, 2, 5, 1),
    "mad-1": (10, 2, 1, 0),
    "idx-0-at-0": (10, 6, 5, 0),
}
# the costs of the windows: random, ties, NaNs, rising, falling, all above J0
COSTS = ["random", "ties", "nan", "nan-J0", "rising", "falling", "above"]


def _bits(a, b) -> bool:
    """Bit for bit, NaNs included (torch.equal is False on a NaN)."""
    if a.dtype != b.dtype or a.shape != b.shape or a.device != b.device:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def _slot_inputs(case: str, dev, seed: int = 0):
    """(djdlam, u, u_eff, u_star, idx, max_app_dur) with the slot the case
    names."""
    H, m, mad, idx = SLOTS[case]
    rng = np.random.default_rng(seed + sum(map(ord, case)))
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    dj = rng.uniform(-1.0, 0.5, H).astype(np.float32)
    if case == "tie":
        dj[[3, 7]] = dj.min() - 0.5  # the first of two least values
    elif case == "nan":
        dj[[4, 8]] = NAN  # the first NaN wins
    elif case in ("at-0", "idx-0-at-0", "mad-past-H-at-0"):
        dj[0] = -2.0
    elif case == "at-idx":
        dj[idx] = -2.0
    elif case == "at-end":
        dj[H - 1] = -2.0
    elif case == "lam0-clamped":
        dj[2] = -2.0  # t_app < idx: lam0 = max(t_app - idx, 1) = 1
    elif case == "mad-past-H":
        dj[4] = -2.0
    elif case == "not-negative":
        dj[:] = np.abs(dj)  # djdlam at t_app is not negative: the step stops
        dj[6] = 0.0
    u, u_eff, u_star = (rng.uniform(-1, 1, (H, m)) for _ in range(3))
    u_eff[1, 0] = -0.0
    return t(dj), t(u), t(u_eff), t(u_star), idx, mad


def _costs(kind: str, mad: int, dev, seed: int = 0):
    rng = np.random.default_rng(seed + 7 * len(kind))
    J0 = np.float32(1.0)
    Js = rng.uniform(0.5, 1.5, mad).astype(np.float32)
    if kind == "ties":
        Js[:] = 0.75
    elif kind == "nan":
        Js[::2] = NAN
    elif kind == "nan-J0":
        J0 = np.float32(NAN)
    elif kind == "rising":
        Js = np.linspace(0.6, 0.9, mad).astype(np.float32)
    elif kind == "falling":
        Js = np.linspace(0.9, 0.6, mad).astype(np.float32)
    elif kind == "above":
        Js += 1.0
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    return t(Js), t(J0)


# ------------------------------------------------------------------ on the CPU

def _jax_line_search(H, mad, cost_fn, t_app, u_app, u, idx, J0):
    from ealv_tpu import control as jc
    owner = types.SimpleNamespace(cfg=types.SimpleNamespace(horizon=H, max_app_dur=mad))
    return jc.KlergPlanner._line_search(owner, cost_fn, t_app, u_app, u, idx, J0)


@pytest.mark.parametrize("costs", COSTS)
@pytest.mark.parametrize("case", list(SLOTS))
def test_plain_window_search_matches_jax_line_search(case, costs):
    """The slot (first-index argmin, NaN first), its windows and candidates,
    the masked acceptance and the plan it applies, against the JAX
    ``_line_search`` and the JAX inner loop's slot, on the same fed djdlam,
    plans and window costs."""
    import jax.numpy as jnp
    dj, u, u_eff, u_star, idx, mad = _slot_inputs(case, "cpu")
    H = dj.shape[0]
    Js, J0 = _costs(costs, mad, "cpu")
    slot = td.choose_slot(dj, u, u_eff, u_star, idx, max_app_dur=mad)
    ti, tf, ok, u_new = td.accept_window(Js, J0, slot, u_eff, idx)

    j = lambda x: jnp.asarray(x.numpy())
    t_app = jnp.argmin(j(dj))
    assert int(slot.t_app) == int(t_app)
    assert bool(slot.step_done) == (not bool(j(dj)[t_app] < 0))
    seen = []

    def cost_fn(u_variants):
        seen.append(np.asarray(u_variants))
        return j(Js)

    want = _jax_line_search(H, mad, cost_fn, t_app, j(u_star)[t_app], j(u), idx, j(J0))
    np.testing.assert_array_equal(slot.plans.numpy().view(np.int32),
                                  seen[0].view(np.int32))
    assert (int(ti), int(tf), bool(ok)) == tuple(f(v) for f, v in zip((int, int, bool), want))
    t = jnp.arange(H)
    m = (want[2] & (t >= want[0]) & (t < want[1]))[:, None]
    np.testing.assert_array_equal(
        u_new.numpy().view(np.int32),
        np.asarray(jnp.where(m, j(u_star)[t_app][None], j(u_eff))).view(np.int32))


@pytest.mark.parametrize("lam", [0, 1, 3, 12])
@pytest.mark.parametrize("case", ["random", "at-0", "at-end", "nan"])
def test_plain_fixed_window_matches_jax(case, lam):
    """``fixed_lam``: the plan u_eff with u_app over [t_app, t_app + lam),
    as the JAX inner loop writes it."""
    import jax.numpy as jnp
    dj, u, u_eff, u_star, idx, _ = _slot_inputs(case, "cpu")
    slot = td.choose_slot(dj, u, u_eff, u_star, idx, lam=lam)
    assert slot.lam0 is None and slot.tis is None and slot.tfs is None
    j = lambda x: jnp.asarray(x.numpy())
    t_app = jnp.argmin(j(dj))
    t = jnp.arange(dj.shape[0])
    m = ((t >= t_app) & (t < t_app + lam))[:, None]
    want = jnp.where(m, j(u_star)[t_app][None], j(u_eff))
    assert int(slot.t_app) == int(t_app)
    np.testing.assert_array_equal(slot.plans.numpy().view(np.int32),
                                  np.asarray(want).view(np.int32))


ACCEPTS = {  # (cost, last_cost, done, step_done)
    "lower": (0.5, 1.0, False, False),
    "higher": (1.5, 1.0, False, False),
    "equal": (1.0, 1.0, False, False),
    "nan-cost": (NAN, 1.0, False, False),
    "nan-last": (0.5, NAN, False, False),
    "done": (0.5, 1.0, True, False),
    "step-done": (0.5, 1.0, False, True),
    "no-search": (0.5, 1.0, False, None),
}


def _accept_inputs(case, dev, n=37, h=10, m=3):
    cost, last, done, step_done = ACCEPTS[case]
    rng = np.random.default_rng(len(case))
    t = lambda a, dt=torch.float32: torch.tensor(np.asarray(a), dtype=dt, device=dev)
    return (t(rng.uniform(-1, 1, (h, m))), t(cost), t(rng.uniform(0, 1, n)),
            None if step_done is None else t(step_done, torch.bool),
            t(rng.uniform(-1, 1, (h, m))), t(last), t(rng.uniform(0, 1, n)),
            t(done, torch.bool))


@pytest.mark.parametrize("check_cost", [False, True], ids=["first", "later"])
@pytest.mark.parametrize("case", list(ACCEPTS))
def test_plain_step_acceptance_matches_jax(case, check_cost):
    """The inner loop's acceptance against the JAX loop's lines, on fed
    plans, costs, footprints and flags."""
    import jax.numpy as jnp
    args = _accept_inputs(case, "cpu")
    got = td.accept_step(*args, check_cost)
    u_new, cost, q, step_done, u, last_cost, q_keep, done = (
        None if a is None else jnp.asarray(a.numpy()) for a in args)
    if step_done is None:
        step_done = jnp.zeros((), bool)
    cost_break = check_cost & (last_cost <= cost)
    accept = (~done) & (~step_done) & (~cost_break)
    want = (jnp.where(accept, u_new, u), jnp.where(accept, cost, last_cost),
            jnp.where(accept, q, q_keep), done | step_done | cost_break)
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype
        np.testing.assert_array_equal(a.numpy().reshape(-1).view(np.uint8),
                                      b.reshape(-1).view(np.uint8))


@pytest.mark.parametrize("case", ["f64 djdlam", "strided u", "u_star shape", "H past the kernel",
                                  "both windows", "no window", "mad 0"])
def test_slot_raises_on_what_the_kernel_does_not_take(case):
    dj, u, u_eff, u_star, idx, mad = _slot_inputs("random", "cpu")
    kw = dict(max_app_dur=mad)
    if case == "f64 djdlam":
        dj, err = dj.double(), TypeError
    elif case == "strided u":
        u, err = u.t().contiguous().t(), ValueError
    elif case == "u_star shape":
        u_star, err = u_star[:-1], ValueError
    elif case == "H past the kernel":
        n = tdo.MAX_HORIZON + 1
        dj, u, u_eff, u_star = torch.zeros(n), *(torch.zeros((n, 2)) for _ in range(3))
        err = ValueError
    elif case == "both windows":
        kw, err = dict(max_app_dur=mad, lam=1), ValueError
    elif case == "no window":
        kw, err = {}, ValueError
    else:
        kw, err = dict(max_app_dur=0), ValueError
    with pytest.raises(err):
        td.choose_slot(dj, u, u_eff, u_star, idx, **kw)


@pytest.mark.parametrize("case", ["Js shape", "f64 J0", "a fixed slot", "strided u_eff"])
def test_window_raises_on_what_the_kernel_does_not_take(case):
    dj, u, u_eff, u_star, idx, mad = _slot_inputs("random", "cpu")
    slot = td.choose_slot(dj, u, u_eff, u_star, idx, max_app_dur=mad)
    Js, J0 = _costs("random", mad, "cpu")
    if case == "Js shape":
        Js, err = Js[:-1], ValueError
    elif case == "f64 J0":
        J0, err = J0.double(), TypeError
    elif case == "a fixed slot":
        slot, err = td.choose_slot(dj, u, u_eff, u_star, idx, lam=2), ValueError
    else:
        u_eff, err = u_eff.t().contiguous().t(), ValueError
    with pytest.raises(err):
        td.accept_window(Js, J0, slot, u_eff, idx)


@pytest.mark.parametrize("case", ["f64 q", "int done", "q_keep shape", "strided u_new"])
def test_accept_raises_on_what_the_kernel_does_not_take(case):
    args = list(_accept_inputs("lower", "cpu"))
    if case == "f64 q":
        args[2], err = args[2].double(), TypeError
    elif case == "int done":
        args[7], err = args[7].long(), TypeError
    elif case == "q_keep shape":
        args[6], err = args[6][:-1], ValueError
    else:
        args[0], err = args[0].t().contiguous().t(), ValueError
    with pytest.raises(err):
        td.accept_step(*args, True)


def test_kernel_wrappers_take_cuda_tensors_only():
    """``ops/descent.py`` checks its inputs on any device and launches only
    on the card: CPU tensors raise there, since the plain versions live in
    ``control/descent.py``."""
    dj, u, u_eff, u_star, idx, mad = _slot_inputs("random", "cpu")
    before = [f.launches for f in (tdo.descent_slot, tdo.descent_window, tdo.descent_accept)]
    assert tdo.check_slot(dj, u, u_eff, u_star, idx, max_app_dur=mad) == (10, 2)
    with pytest.raises(TypeError):
        tdo.descent_slot(dj, u, u_eff, u_star, idx, max_app_dur=mad)
    slot = td.choose_slot(dj, u, u_eff, u_star, idx, max_app_dur=mad)
    Js, J0 = _costs("random", mad, "cpu")
    assert tdo.check_window(Js, J0, slot, u_eff, idx) == (10, 2, mad)
    with pytest.raises(TypeError):
        tdo.descent_window(Js, J0, slot, u_eff, idx)
    args = _accept_inputs("lower", "cpu")
    assert tdo.check_accept(*args) == (10, 3, 37)
    with pytest.raises(TypeError):
        tdo.descent_accept(*args, True)
    after = [f.launches for f in (tdo.descent_slot, tdo.descent_window, tdo.descent_accept)]
    assert after == before


def _toy_planner(states, dev, seed=0, **mode):
    """A toy KlergPlanner on ``states`` with a Gaussian target, its state
    with a filled history and a random plan, and fed draws."""
    from ealv_tpu_torch import control as tc
    H, N, M = 10, 96, 64
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    dyn = tc.make_dynamics(states, dt=0.1, device=dev)
    n, m, d = dyn.num_states, dyn.num_actions, len(states)
    cfg = tc.KlergConfig(horizon=H, num_target_samples=N, num_traj_samples=M, R=0.5,
                         std=0.05, **mode)
    mu, var = t(rng.uniform(-0.5, 0.5, d)), t(rng.uniform(0.05, 0.1, d))
    pl = tc.KlergPlanner(cfg, dyn, tc.make_policy("Roll", dyn, H),
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


def test_a_cpu_plan_launches_no_descent_kernel():
    """Every mode's CPU plan runs the plain versions: the wrappers' counts
    and the graphs' tally do not move."""
    from ealv_tpu_torch.runtime import graphs as tg
    names = ("descent_slot", "descent_window", "descent_accept")
    before = tg.total_launches()
    for mode in ({}, {"fixed_lam": True}, {"ctrl_app_search": False}, {"full_cost": True}):
        pl, ps, draws = _toy_planner("xy", "cpu", **mode)
        ps, info = pl.plan(ps, None, **draws)
        assert torch.isfinite(info["cost"])
    after = tg.total_launches()
    assert [after[k] for k in names] == [before[k] for k in names]


# ------------------------------------------------------------------ on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("fixed", [False, True], ids=["search", "fixed"])
@pytest.mark.parametrize("case", list(SLOTS))
def test_slot_kernel_matches_plain(cuda, case, fixed):
    dj, u, u_eff, u_star, idx, mad = _slot_inputs(case, cuda)
    kw = dict(lam=3) if fixed else dict(max_app_dur=mad)
    before = tdo.descent_slot.launches
    got = td.choose_slot(dj, u, u_eff, u_star, idx, **kw)
    assert tdo.descent_slot.launches == before + 1
    want = td.choose_slot_reference(dj, u, u_eff, u_star, idx, **kw)
    for name in ("ints", "u_app", "step_done", "plans"):
        assert _bits(getattr(got, name), getattr(want, name)), name


@pytest.mark.cuda
@pytest.mark.parametrize("costs", COSTS)
@pytest.mark.parametrize("case", list(SLOTS))
def test_window_kernel_matches_plain(cuda, case, costs):
    dj, u, u_eff, u_star, idx, mad = _slot_inputs(case, cuda)
    slot = td.choose_slot(dj, u, u_eff, u_star, idx, max_app_dur=mad)
    Js, J0 = _costs(costs, mad, cuda)
    before = tdo.descent_window.launches
    got = td.accept_window(Js, J0, slot, u_eff, idx)
    assert tdo.descent_window.launches == before + 1
    want = td.accept_window_reference(Js, J0, slot, u_eff, idx)
    for name, a, b in zip(("ti", "tf", "ok", "u_new"), got, want):
        assert _bits(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(10, 2, 2000), (10, 6, 2010), (4, 3, 1), (40, 3, 70001)],
                         ids=["xy", "xyzrpw", "one sample", "wide"])
@pytest.mark.parametrize("check_cost", [False, True], ids=["first", "later"])
@pytest.mark.parametrize("case", list(ACCEPTS))
def test_accept_kernel_matches_plain(cuda, case, check_cost, shape):
    h, m, n = shape
    args = _accept_inputs(case, cuda, n=n, h=h, m=m)
    before = tdo.descent_accept.launches
    got = td.accept_step(*args, check_cost)
    assert tdo.descent_accept.launches == before + 1
    want = td.accept_step_reference(*args, check_cost)
    for name, a, b in zip(("u", "last_cost", "q_keep", "done"), got, want):
        assert _bits(a, b), name


@pytest.mark.cuda
def test_kernels_raise_on_other_inputs_on_the_card(cuda):
    dj, u, u_eff, u_star, idx, mad = _slot_inputs("random", cuda)
    with pytest.raises(TypeError):
        td.choose_slot(dj.cpu(), u, u_eff, u_star, idx, max_app_dur=mad)
    with pytest.raises(ValueError):
        td.choose_slot(dj, u[:, :1], u_eff, u_star, idx, max_app_dur=mad)
    slot = td.choose_slot(dj, u, u_eff, u_star, idx, max_app_dur=mad)
    Js, J0 = _costs("random", mad, cuda)
    with pytest.raises(TypeError):
        td.accept_window(Js, J0.double(), slot, u_eff, idx)
    args = list(_accept_inputs("lower", cuda))
    args[2] = args[2][::2]
    with pytest.raises(ValueError):
        td.accept_step(*args, True)


MODES = {"default": {}, "fixed_lam": {"fixed_lam": True},
         "no search": {"ctrl_app_search": False}, "full_cost": {"full_cost": True},
         "long windows": {"max_app_dur": 12}}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("states", ["xy", "xyw", "xyzrpw"])
def test_plan_with_the_kernels_is_the_plain_plan(cuda, states, mode, monkeypatch):
    """A toy plan on the card through the kernels, then through the plain
    versions (the same fed draws and generator state): plan, cost, kept
    footprint and rolled-out plan bit for bit, for m = 2, 3 and 6 and every
    mode; 3, 2 or 1 launches an inner iteration (search, fixed window, no
    search) and none of the plain versions."""
    from ealv_tpu_torch.control import klerg
    from ealv_tpu_torch.runtime import graphs as tg
    outs = []
    for plain in (False, True):
        pl, ps, draws = _toy_planner(states, cuda, seed=3, **MODES[mode])
        if plain:
            for name in ("choose_slot", "accept_window", "accept_step"):
                monkeypatch.setattr(klerg, name, getattr(td, f"{name}_reference"))
        tg.reset_launches()
        ps, info = pl.plan(ps, None, **draws)
        counts = tg.total_launches()
        outs.append((ps.u, ps.last_plan, info["cost"], info["q"]))
        cfg, iters = pl.cfg, pl.cfg.num_iters
        search = cfg.ctrl_app_search and not cfg.fixed_lam
        want = (0, 0, 0) if plain else (iters * cfg.ctrl_app_search, iters * search, iters)
        assert (counts["descent_slot"], counts["descent_window"],
                counts["descent_accept"]) == want
    tg.reset_launches()
    for a, b in zip(*outs):
        assert _bits(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("fixed_lam", [False, True], ids=["search", "fixed_lam"])
def test_replayed_eval_ticks_count_the_descent_launches(cuda, fixed_lam):
    """Six EvalExperiment ticks toward an ExplrDist through the tick graph
    and eagerly, in turns: the eval state bit for bit after every tick, and
    every plan (one a tick) 3 x num_iters launches of the descent kernels
    (2 x under ``fixed_lam``: no window search), read through the replays
    (``graphs.total_launches``)."""
    from ealv_tpu_torch.control import ExplrDist
    from ealv_tpu_torch.runtime import EvalExperiment, graphs as tg
    from ealv_tpu_torch.runtime.graphs import _fields, _leaf
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
        ev_exp.planner.cfg = dataclasses.replace(ev_exp.planner.cfg, fixed_lam=fixed_lam)
        if not graphs:
            ev_exp.tick_graph = None
        runs.append([ev_exp, ev_exp.init(seed=2)])
    iters = runs[0][0].planner.cfg.num_iters
    tg.reset_launches()
    try:
        for k in range(6):
            for run in runs:
                run[1], _ = run[0].tick(run[1], ctx)
            for a, b in zip(leaves(runs[0][1], []), leaves(runs[1][1], []), strict=True):
                if isinstance(a, torch.Tensor):
                    assert _bits(a, b) if a.is_floating_point() else torch.equal(a, b), k
                elif not isinstance(a, torch.nn.Module):
                    assert a == b, k
        counts = tg.total_launches()
    finally:
        tg.reset_launches()
    plans = 2 * 6
    want = (plans * iters, 0 if fixed_lam else plans * iters, plans * iters)
    assert (counts["descent_slot"], counts["descent_window"], counts["descent_accept"]) == want
    assert runs[1][0].tick_graph.replays >= 4
