"""K2, the fused Adam update, and ``FusedAdam`` against the JAX package.

The plain version of the kernel is held against the Pallas kernel
``ealv_tpu.ops.pallas_adam.adam_update_flat`` in interpret mode and against
the inline per-leaf path of its ``adam_apply``; ``FusedAdam`` against
``torch.optim.Adam``; and a trainer call with ``fused_adam=True`` against
the JAX ``train_call`` with ``fused_adam=True``, both started from the same
weights and the same non-zero Adam moments (``opt_state_from_jax``), with
fed draws. Everything is f32, TF32 off. On the CPU the port takes the
kernel's plain version; the kernel itself is held against it in
``test_torch_cuda.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ealv_tpu.ops import pallas_adam as jpa
from ealv_tpu.runtime.trainer import TrainerStatics as JStatics, train_call as j_train
from ealv_tpu_torch.ops import adam as tad
from ealv_tpu_torch.runtime.trainer import TrainerStatics, train_call
from ealv_tpu_torch.utils.convert import opt_state_from_jax, params_from_jax
from test_torch_trainer import (B, LR, jax_train_draws, one_torch_thread,  # noqa: F401
                                setup, _port_model)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# the same f32 formula in the same order on both sides; XLA and torch may
# round b^t and the fused multiply-adds differently by an ulp
TOL = dict(rtol=1e-6, atol=1e-7)


def _moments(n, rng):
    return (rng.normal(0, 0.1, n).astype(np.float32),
            rng.normal(0, 1e-3, n).astype(np.float32),
            rng.uniform(0, 1e-5, n).astype(np.float32))


@pytest.mark.parametrize("n,steps", [(128, 4), (3 * 128, 3), (640 * 128, 3)])
def test_plain_matches_pallas_kernel(n, steps):
    """adam_update_reference vs the Pallas kernel (interpret mode) over
    several steps from non-zero moments; n is a multiple of 128, as the
    TPU kernel requires."""
    rng = np.random.default_rng(n)
    p, m, v = _moments(n, rng)
    jp, jm, jv = map(jnp.asarray, (p, m, v))
    tp, tm, tv = map(torch.from_numpy, (p.copy(), m.copy(), v.copy()))
    for count in range(5, 5 + steps):
        g = rng.normal(0, 1e-2, n).astype(np.float32)
        jp, jm, jv = jpa.adam_update_flat(jp, jm, jv, jnp.asarray(g), jnp.float32(LR),
                                          jnp.int32(count), interpret=True)
        tad.adam_update_flat(tp, tm, tv, torch.from_numpy(g), LR, count)
        for a, b in ((tp, jp), (tm, jm), (tv, jv)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    assert tad.adam_apply.launches == 0  # CPU tensors never reach the kernel


def test_adam_apply_matches_jax_inline_path():
    """Lists of ragged tensors (1, 127, 129 and 2-D) against the JAX
    adam_apply's inline per-leaf path, three steps from zero moments."""
    rng = np.random.default_rng(7)
    shapes = [(1,), (127,), (129,), (33, 5)]
    params = {f"w{i}": rng.normal(0, 0.1, s).astype(np.float32) for i, s in enumerate(shapes)}
    jparams, jstate = dict(params), jpa.adam_init(params)
    tparams = [torch.from_numpy(params[k].copy()) for k in params]
    mu, nu = tad.adam_init(tparams)
    for count in (1, 2, 3):
        grads = {k: rng.normal(0, 1e-2, v.shape).astype(np.float32)
                 for k, v in params.items()}
        jparams, jstate = jpa.adam_apply(jparams, jstate, grads, LR, force_kernel=False)
        tad.adam_apply(tparams, mu, nu, [torch.from_numpy(grads[k]) for k in params],
                       LR, count)
    for k, tp, m, v in zip(params, tparams, mu, nu):
        np.testing.assert_allclose(tp.numpy(), np.asarray(jparams[k]), **TOL)
        np.testing.assert_allclose(m.numpy(), np.asarray(jstate.mu[k]), **TOL)
        np.testing.assert_allclose(v.numpy(), np.asarray(jstate.nu[k]), **TOL)


def _two_optimizers(shapes, rng):
    init = [rng.normal(0, 0.1, s).astype(np.float32) for s in shapes]
    params = [[torch.tensor(a, requires_grad=True) for a in init] for _ in range(2)]
    return params, [tad.FusedAdam(params[0], lr=LR), torch.optim.Adam(params[1], lr=LR)]


def test_fused_adam_matches_torch_adam():
    """Five steps: the two formulas place the bias correction differently
    (sqrt(v / c2) vs sqrt(v) / sqrt(c2)): rtol 1e-5, atol 1e-6."""
    rng = np.random.default_rng(3)
    shapes = [(64, 33), (64,), (7, 3, 3, 3)]
    params, opts = _two_optimizers(shapes, rng)
    for _ in range(5):
        grads = [rng.normal(0, 1e-2, s).astype(np.float32) for s in shapes]
        for ps, opt in zip(params, opts):
            for p, g in zip(ps, grads):
                p.grad = torch.from_numpy(g)
            opt.step()
    assert opts[0].param_groups[0]["step"] == 5
    for a, b in zip(*params):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_fused_adam_state_dict_round_trip():
    """A FusedAdam restored from its state_dict continues bit for bit."""
    rng = np.random.default_rng(4)
    shapes = [(16, 8), (8,)]
    init = [rng.normal(0, 0.1, s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(0, 1e-2, s).astype(np.float32) for s in shapes] for _ in range(4)]
    runs = []
    for resume in (False, True):
        ps = [torch.tensor(a, requires_grad=True) for a in init]
        opt = tad.FusedAdam(ps, lr=LR)
        for k, gs in enumerate(grads):
            if resume and k == 2:
                sd = opt.state_dict()
                opt = tad.FusedAdam(ps, lr=LR)
                opt.load_state_dict(sd)
                assert opt.param_groups[0]["step"] == 2
            for p, g in zip(ps, gs):
                p.grad = torch.from_numpy(g)
            opt.step()
        runs.append([p.detach().clone() for p in ps])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("fused", [True, False])
def test_trainer_call_step_matched_from_jax_optimizer_state(setup, fused):  # noqa: F811
    """A JAX trainer call (2 steps) makes non-zero Adam moments; the
    parameters and the optimizer state (PallasAdamState with fused_adam,
    optax's ScaleByAdamState without) are carried over, and a second 2-step
    call with fed draws runs on both sides. Losses at rtol 1e-3; parameters
    within 2 * lr * steps everywhere (a rounding-level gradient can flip an
    element's step) and at rtol 1e-4 on at least 99% of the elements."""
    jm, jp, jb, tb = setup
    statics_j = JStatics(model=jm, batch_size=B, num_learning_opt=2, lr=LR,
                         fused_adam=fused)
    call = jax.jit(lambda p, o, k: j_train(statics_j, p, o, jb, k, 0.01, 0.6))
    jp1, jo1, _ = call(jp, statics_j.make_optimizer().init(jp), jax.random.PRNGKey(1))
    assert isinstance(jax.tree.leaves(jo1, is_leaf=lambda s: hasattr(s, "mu"))[0],
                      jpa.PallasAdamState if fused else optax.ScaleByAdamState)
    key = jax.random.PRNGKey(2)
    draws = jax_train_draws(jm, jp1, jb, key, 2, B)
    jp2, _, jmet = call(jp1, jo1, key)

    tm = _port_model(jm, jp1)
    statics = TrainerStatics(batch_size=B, num_learning_opt=2, lr=LR, fused_adam=fused)
    opt = statics.make_optimizer(tm)
    assert isinstance(opt, tad.FusedAdam) == fused
    opt.load_state_dict(opt_state_from_jax(jo1, tm, opt))
    met = train_call(statics, tm, opt, tb, torch.tensor(0.01), torch.tensor(0.6),
                     draws=draws)
    np.testing.assert_allclose(met["loss"].numpy(), np.asarray(jmet["loss"]), rtol=1e-3)
    want = params_from_jax(jp2, tm)
    close = total = 0
    for name, p in tm.named_parameters():
        got, w = p.detach().numpy(), want[name].numpy()
        assert np.abs(got - w).max() <= 2 * LR * 2 + 1e-6, name
        close += np.isclose(got, w, rtol=1e-4, atol=1e-7).sum()
        total += got.size
    assert close >= 0.99 * total
    if fused:
        assert opt.param_groups[0]["step"] == 4
    else:
        assert all(float(s["step"]) == 4 for s in opt.state.values())


def test_trainer_switch_follows_the_jax_user_flow():
    """fused_adam is turned on as a JAX user does, by replacing the
    Experiment's trainer statics before init."""
    from ealv_tpu_torch.runtime import Experiment
    from ealv_tpu_torch.utils.config import ExperimentConfig
    exp = Experiment(ExperimentConfig(states="xyw", image_dim=(24, 24, 3), batch_size=8,
                                      num_target_samples=64, num_traj_samples=64),
                     device="cpu")
    assert isinstance(exp.init(0).opt, torch.optim.Adam)
    exp.trainer = dataclasses.replace(exp.trainer, fused_adam=True)
    assert isinstance(exp.init(0).opt, tad.FusedAdam)


# ---- the kernel's plan (csrc/adam.cu), emulated on the CPU ----

RAGGED = [1, 3, 4, 5, 127, 129, 4097, 3 * 4096 + 5]


def _cvae_sizes(force=False):
    """The production CVAE's parameter sizes; with ``force`` the variant
    at states "xywb" with learn_force (one more encoder input column, one
    more decoder output row)."""
    from ealv_tpu_torch.models import CVAE
    from ealv_tpu_torch.utils.config import ExperimentConfig
    cfg = ExperimentConfig(states="xywb" if force else "xyw")
    model = CVAE(img_dim=cfg.image_dim, z_dim=cfg.z_dim, s_dim=cfg.s_dim,
                 hidden_dim=cfg.model_hidden(), learn_force=force)
    return [p.numel() for p in model.parameters()]


def _kernel_writes(plan):
    """Per tensor, how often the kernel's blocks write each element: the
    block's tensor by the kernel's binary search over first blocks, its
    chunk, then float4 j of each thread and unroll step and the scalar tail
    (or the scalar loop)."""
    counts = [np.zeros(n, np.int64) for n in plan.sizes]
    tid = np.arange(tad.THREADS)
    for b in range(plan.blocks):
        lo, hi = 0, len(plan.sizes) - 1
        while lo < hi:
            mid = (lo + hi + 1) >> 1
            if plan.block_start[mid] <= b:
                lo = mid
            else:
                hi = mid - 1
        begin = (b - plan.block_start[lo]) * tad.CHUNK
        end = min(begin + tad.CHUNK, plan.sizes[lo])
        if not plan.vec[lo]:
            for j0 in range(begin, end, tad.THREADS):
                j = j0 + tid
                np.add.at(counts[lo], j[j < end], 1)
            continue
        vbegin, vend = begin >> 2, end >> 2
        for u in range(tad.VECS):
            j = vbegin + u * tad.THREADS + tid
            j = j[j < vend]
            for c in range(4):
                np.add.at(counts[lo], 4 * j + c, 1)
        j = (vend << 2) + tid
        np.add.at(counts[lo], j[j < end], 1)
    return counts


@pytest.mark.parametrize("sizes", [[n] for n in RAGGED] + [RAGGED, "cvae", "cvae-force"],
                         ids=lambda s: s if isinstance(s, str) else "-".join(map(str, s)))
@pytest.mark.parametrize("aligned", ["all", "none", "alternate"])
def test_plan_updates_every_element_once(sizes, aligned):
    """Every element of every tensor is written by exactly one thread,
    through the float4 path and its scalar tail or the scalar path."""
    if isinstance(sizes, str):
        sizes = _cvae_sizes(force=sizes == "cvae-force")
    vec = {"all": [True] * len(sizes), "none": [False] * len(sizes),
           "alternate": [i % 2 == 0 for i in range(len(sizes))]}[aligned]
    plan = tad.adam_plan(sizes, vec)
    assert plan.blocks == sum(-(-n // tad.CHUNK) for n in sizes)
    for n, c in zip(sizes, _kernel_writes(plan)):
        assert c.size == n and (c == 1).all()


# the force variant at xywb: two more encoder input columns (the force and
# b, 2 x 512), one more decoder input column (b, 256) and one more decoder
# output row with its bias (the force head, 512 + 1)
@pytest.mark.parametrize("force,total,blocks", [(False, 4309220, 1070),
                                                (True, 4309220 + 1024 + 256 + 513, 1070)])
def test_cvae_plan_is_one_launch_of_float4_blocks(force, total, blocks):
    sizes = _cvae_sizes(force)
    assert len(sizes) == 24 and sum(sizes) == total
    plan = tad.adam_plan(sizes, [True] * 24)
    assert plan.blocks == blocks and len(sizes) <= tad.ADAM_MAX_TENSORS


def _lists(shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [[torch.tensor(rng.normal(0, 0.1, s), dtype=torch.float32) for s in shapes]
            for _ in range(4)]


def test_launch_cache_takes_replaced_grads():
    """The checks and ctypes arrays are built once per tensor list; grads
    replaced by new tensors (as zero_grad(set_to_none=True) makes them on
    every step) reuse the entry, with their own addresses written into the
    pointer table; a grad off a 16-byte boundary makes a new entry whose
    plan reads that tensor element by element."""
    p, m, v, g = _lists([(64, 3), (5,)])
    tad._launch_cache.clear()
    dev, launches = tad._launches([*p, *m, *v, *g])
    assert dev.type == "cpu" and launches[0][5].sizes == (192, 5)
    assert launches[0][5].vec == (True, True)
    g2 = [x.clone() for x in g]
    _, again = tad._launches([*p, *m, *v, *g2])
    assert again is launches and len(tad._launch_cache) == 1
    assert list(again[0][1]) == [x.data_ptr() for x in (*p, *m, *v, *g2)]
    buf = torch.zeros(200)
    g3 = [buf[1:193].view(64, 3), g2[1]]
    _, shifted = tad._launches([*p, *m, *v, *g3])
    assert shifted is not launches and len(tad._launch_cache) == 2
    assert shifted[0][5].vec == (False, True)
    assert list(shifted[0][1])[6:] == [x.data_ptr() for x in g3]


@pytest.mark.parametrize("bad,error", [
    (lambda g: g.bfloat16(), TypeError), (lambda g: g.t().contiguous().t(), ValueError),
    (lambda g: g[:, :2], ValueError), (lambda g: g.t(), ValueError),
    (lambda g: g.to("meta"), TypeError)])
def test_launch_cache_checks_every_new_list(bad, error):
    """A grad of another dtype, device or layout, or a view with the old
    grad's address and size but not its layout, raises before any launch."""
    p, m, v, g = _lists([(6, 6)])
    tad._launches([*p, *m, *v, *g])
    with pytest.raises(error):
        tad._launches([*p, *m, *v, bad(g[0])])


def test_unaligned_tensors_take_the_scalar_path():
    """A contiguous view 4 bytes past a 16-byte boundary is read element by
    element; the other tensors keep float4."""
    buf = torch.zeros(4 * 200 + 1)
    p, m, v, g = _lists([(100,), (37,)])
    g[0] = buf[1:101]
    _, launches = tad._launches([*p, *m, *v, *g])
    plan = launches[0][5]
    aligned = all(x.data_ptr() % 16 == 0 for x in (p[1], m[1], v[1], g[1]))
    assert plan.vec == (False, aligned)
