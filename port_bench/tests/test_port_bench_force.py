"""The contact cell ``xyz_force.learn`` on the CPU at a toy size: the
reference's force CVAE (``reference/cvae_force.py``) against the port's on
seeded weights (forward, loss, gradients), its ensemble pdf against the
port's and against five plain decodes, the unfolded entropy grade against
``Experiment._grade_spread``, step-matched learning ticks on the arm (one
a trainer tick) that read correct, the control and the planted faults
that its limits catch, the model FLOPs against the decodes and encodes a
tick makes, the grade's K1 launch and the ``grade_ms`` reader."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from port_bench import counts, drive, harness
from port_bench.entries.learn_contact import FAULTS
from port_bench.metrics import grade_ms
from port_bench.reference import cvae as ref_cvae
from port_bench.reference import cvae_force
from port_bench.reference import losses as ref_losses
from port_bench.reference.tick_contact import ContactTick

SEED = 3_200_000_029
SECONDS = 600.0  # more than a toy window takes: its ticks (num_steps) end it
TOY = dict(image_dim=[24, 24, 3], hidden_dim=[32, 16], num_target_samples=64,
           num_traj_samples=50, traj_buffer_capacity=100, buffer_capacity=100, batch_size=8,
           num_learning_opt=3, num_steps=40)
# over the first object, below its top: every toy tick is in contact, so
# each trainer batch holds forces (the cell itself starts at the tray's centre)
OVER_OBJECT = [0.42, -0.06, 0.34]


def _toy(**traffic) -> dict:
    """The cell at a toy size: warm 2 ticks (on the CPU nothing captures),
    4 compared ticks among the window's first 16, 2 of them trainer ticks;
    the window ends by its ticks, about 38."""
    limits = harness.load_json(harness.ROOT / "limits" / "xyz_force.learn.json")
    files = harness.mix_files(harness.ROOT / "configs" / "xyz_force.json", "learn_contact",
                              limits)
    files["config"].update(TOY)
    files["traffic"].update(chunk=5, settle=2, start=OVER_OBJECT, **traffic)
    files["traffic"]["compare"].update(within=16)
    return files


@pytest.fixture(scope="module")
def run(monkeypatch_module):
    """A toy run with the control and every planted fault beside the
    program."""
    monkeypatch_module.setattr(harness, "CONTROLS", {**harness.CONTROLS, **FAULTS})
    files = _toy()
    return files, harness.measure(files, SEED, SECONDS, False, device="cpu",
                                  controls=("fp8", "half_batch", "stuck", *FAULTS))


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def _cfg(**over):
    files = _toy()
    cfg = {k: v for k, v in files["config"].items() if k != "scene"}
    cfg.update(over)
    return files["config"]["scene"], cfg


def _models(dtype: str):
    """The port's force CVAE and the reference's on the same seeded
    weights, at the toy widths, in ``dtype``."""
    from ealv_tpu_torch.models import CVAE
    scene, cfg = _cfg(compute_dtype=dtype)
    pcfg = drive.program_config(cfg)
    prog = CVAE(img_dim=pcfg.image_dim, z_dim=pcfg.z_dim, s_dim=pcfg.s_dim,
                hidden_dim=pcfg.model_hidden(), cnn_kernels=pcfg.cnn_kernels,
                cnn_strides=pcfg.cnn_strides, cnn_channels=pcfg.cnn_channels,
                learn_force=True, compute_dtype=getattr(torch, dtype))
    prog.reset_parameters(torch.Generator().manual_seed(11))
    tick = ContactTick(drive.reference_config(cfg), "cpu", scene, ref_cvae.CASTS[dtype],
                       ref_cvae.CASTS[dtype])
    ref = tick.make_model(11)
    return prog, ref, pcfg


def _batch(pcfg, b=6, seed=5):
    g = torch.Generator().manual_seed(seed)
    h, w, c = pcfg.image_dim
    return dict(x=torch.rand(b, pcfg.s_dim, generator=g) * 2 - 1,
                y=torch.rand(b, h, w, c, generator=g),
                force=torch.rand(b, 1, generator=g) * 30 * (torch.rand(b, 1, generator=g) > 0.5),
                x2=torch.rand(b, pcfg.s_dim, generator=g) * 2 - 1,
                y2=torch.rand(b, h, w, c, generator=g),
                force2=torch.rand(b, 1, generator=g) * 30)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_force_cvae_is_the_ports_bit_for_bit(dtype):
    """The seed's weights, every forward output, the loss with the force
    terms and each parameter's gradient."""
    from ealv_tpu_torch.models import cvae_loss
    prog, ref, pcfg = _models(dtype)
    assert [n for n, _ in prog.named_parameters()] == [n for n, _ in ref.named_parameters()]
    for (n, a), (_, b) in zip(prog.named_parameters(), ref.named_parameters()):
        assert torch.equal(a, b), n
    d = _batch(pcfg)
    eps = torch.randn(d["x"].shape[0], pcfg.z_dim, generator=torch.Generator().manual_seed(3))
    outs, grads = [], []
    for model, loss_fn in ((prog, cvae_loss), (ref, ref_losses.cvae_loss)):
        model.zero_grad(set_to_none=True)
        if model is prog:
            out = model(d["x"], d["y"], force=d["force"], x_decode=d["x2"], train=True, eps=eps)
        else:  # the reference draws its noise: the same block, fed through a generator
            gen = torch.Generator().manual_seed(3)
            out = model(d["x"], d["y"], force=d["force"], x_decode=d["x2"], train=True,
                        generator=gen)
        loss, _ = loss_fn(out, d["y"], y2=d["y2"], beta=0.01, gamma=0.3, gamma_weight=0.1,
                          other_locs=True, force=d["force"], force2=d["force2"],
                          learn_force=True)
        loss.backward()
        outs.append((out, loss.detach()))
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    (po, pl), (ro, rl) = outs
    for k in ("z_mu", "z_logvar", "z", "img_pred", "img_logvar", "force_pred", "force_logvar",
              "img_pred_decode", "force_pred_decode", "force_logvar_decode"):
        assert torch.equal(po[k], ro[k]), k
    assert torch.equal(pl, rl)
    assert grads[0].keys() == grads[1].keys()
    for n in grads[0]:
        assert torch.equal(grads[0][n], grads[1][n]), n
    # the force head's row and the encoder's force column carry gradient
    assert grads[1]["decode.4.weight"][1].abs().sum() > 0
    assert grads[1]["encode.0.weight"][:, ref.feat_dim].abs().sum() > 0


def _model_state(pcfg, seed=9):
    from ealv_tpu_torch.models.cvae import ModelState
    g = torch.Generator().manual_seed(seed)
    h, w, c = pcfg.image_dim
    return ModelState(seed_x=torch.zeros(pcfg.s_dim), seed_y=torch.zeros(h, w, c),
                      seed_force=torch.zeros(1), z=torch.randn(pcfg.z_dim, generator=g),
                      z_buff=torch.randn(5, pcfg.z_dim, generator=g),
                      initialized=torch.ones((), dtype=torch.bool))


def test_the_ensemble_pdf_is_the_ports_and_five_plain_decodes():
    prog, ref, pcfg = _models("bfloat16")
    state = _model_state(pcfg)
    state = dataclasses.replace(state, z=state.z_buff[0])
    samples = torch.rand(64, pcfg.s_dim, generator=torch.Generator().manual_seed(2)) * 2 - 1
    ens = ref.pdf(state, samples, ensemble=True)
    assert torch.equal(prog.pdf(state, samples, use_z_ensemble=True), ens)
    assert torch.equal(prog.pdf(state, samples), ref.pdf(state, samples, ensemble=False))
    plain = torch.stack([ref.decode_fn(z[None].expand(64, -1), samples)[1]
                         for z in state.z_buff]).mean(0)
    torch.testing.assert_close(ens, torch.exp(plain.clamp(*ref_cvae.LOGVAR_LIMS)).amax(1),
                               rtol=1e-6, atol=0)
    # the collapsed ensemble is the newest latent's plain decode, and differs
    assert not torch.equal(ens, ref.pdf(state, samples, ensemble=False))


def test_the_unfolded_grade_is_the_ports():
    """``Experiment._grade_spread`` on a toy experiment after a few ticks on
    the arm, against the reference's grade from the same generator state,
    the ring and the model state; beta and gamma are the grade and the
    spread as the trainer call takes them."""
    from ealv_tpu_torch.runtime.schedules import HyperState, hyperparam_update
    files = _toy()
    drv = drive.make(files["config"], files["traffic"], SEED, "cpu")
    for _ in range(4):
        drv.tick()
    es = drv.es
    assert not drv.exp.cfg.hyper_from_planner or drv.exp.cfg.use_z_ensemble
    state = es.gen.get_state()
    grade, spread = drv.exp._grade_spread(es)
    tick = drv.reference()
    model = tick.make_model()
    model.load_state_dict(dict(es.model.named_parameters()))
    ring = tick._ring(drv.snapshot(), es.buf.y)
    gen = torch.Generator()
    gen.set_state(state)
    rgrade, rspread = tick.grade_spread(model, es.mstate, ring, gen)
    assert torch.equal(gen.get_state(), es.gen.get_state())  # the same draws
    torch.testing.assert_close(rspread, spread, rtol=1e-6, atol=0)
    torch.testing.assert_close(rgrade, grade, rtol=1e-5, atol=0)
    assert 0 < float(spread) <= 1 and 0 < float(grade) <= 0.01
    hyper = hyperparam_update(HyperState.create("cpu"), grade, spread)
    assert torch.equal(hyper.beta, grade.float()) and torch.equal(hyper.gamma, spread.float())


def _fails(files, gaps) -> list:
    return [k for k, lim in files["limits"].items() if not gaps.get(k, float("inf")) <= lim]


def test_step_matched_learning_ticks_on_the_arm_read_correct(run):
    """The compared ticks (a trainer tick among them) read far below every
    limit, every number the limits name was produced, and the window's
    ring holds contact."""
    files, r = run
    assert len(r["per_tick"]) == 4 and sum("loss" in t for t in r["per_tick"]) >= 2
    assert _fails(files, r["gaps"]) == [], r["gaps"]
    for k, lim in files["limits"].items():
        assert r["gaps"][k] <= lim / 10, (k, r["gaps"][k])
    assert r["gaps"]["beta"] <= 1e-5 and r["gaps"]["gamma"] <= 1e-5


@pytest.mark.parametrize("control, caught", [
    ("fp8", ("image", "latent_median", "loss", "params_worst")),
    ("half_batch", ("loss", "params_worst")),
    ("stuck", ("image", "cost")),
    ("force_dropped", ("loss", "params_worst")),
    ("ensemble_collapsed", ("cost",)),
])
def test_the_control_and_each_planted_fault_exceed_a_limit(run, control, caught):
    files, r = run
    gaps = r["controls"][control]
    over = [k for k in caught if gaps.get(k, 0.0) > files["limits"][k]]
    assert over, (control, {k: gaps.get(k) for k in caught})


def test_the_faults_move_what_they_break_only(run):
    """``force_dropped`` leaves the exploration alone; ``ensemble_collapsed``
    the trainer call."""
    files, r = run
    dropped, collapsed = r["controls"]["force_dropped"], r["controls"]["ensemble_collapsed"]
    assert dropped["cost"] == 0 and dropped["image"] == 0 and dropped["force"] == 0
    assert collapsed["loss"] == 0 and collapsed["params_worst"] == 0


def _decode_rows(monkeypatch):
    """Counters of the rows the port's CVAE encodes and decodes, and of
    those the trainer's steps run forward."""
    from ealv_tpu_torch.models import cvae as prog_cvae
    rows = {"encode": 0, "decode": 0}
    real_enc, real_dec = prog_cvae.CVAE.encode_fn, prog_cvae.CVAE.decode_fn

    def enc(self, x, *a, **kw):
        rows["encode"] += x.shape[0]
        return real_enc(self, x, *a, **kw)

    def dec(self, z, x):
        rows["decode"] += z.shape[0]
        return real_dec(self, z, x)

    monkeypatch.setattr(prog_cvae.CVAE, "encode_fn", enc)
    monkeypatch.setattr(prog_cvae.CVAE, "decode_fn", dec)
    return rows


def test_the_model_flops_count_the_rows_a_tick_runs(monkeypatch):
    """``counts.tick_flops`` against the encodes and decodes the program
    makes in a tick with and without a trainer call: the 5 x N ensemble
    rows, the reseeding, the trainer's B encodes and 2B decodes a step (3x
    for the backward) and the grade's fresh N-row decode."""
    files = _toy()
    cfg = files["config"]
    drv = drive.make(cfg, files["traffic"], SEED, "cpu")
    f = counts.cvae_flops(cfg)
    rows = _decode_rows(monkeypatch)
    seen = set()
    for _ in range(8):
        trained = drv.will_train()
        before = dict(rows)
        drv.tick()
        assert drv.trained == trained
        enc, dec = rows["encode"] - before["encode"], rows["decode"] - before["decode"]
        n, b, steps = cfg["num_target_samples"], cfg["batch_size"], cfg["num_learning_opt"]
        assert enc == 1 + trained * steps * b
        assert dec == 5 * n + 1 + trained * (n + steps * 2 * b)
        flops = (5 * n + 1 + trained * n) * f["decode_mlp"] + (f["encode"] + f["img_decode"]) \
            + trained * 3 * steps * (b * f["encode"] + 2 * b * (f["decode_mlp"] + f["img_decode"]))
        assert drv.tick_flops(trained) == flops
        seen.add(trained)
    assert seen == {True, False}


def test_a_trainer_tick_adds_the_grades_k1_launch():
    files = _toy()
    drv = drive.make(files["config"], files["traffic"], SEED, "cpu")
    for _ in range(2):
        drv.tick()
    cfg = files["config"]
    fill = drv.fill()
    base = counts.k1_tick_launches(cfg, True, fill + 1)
    launches = [drv.k1_launches(fill + 1 + i) for i in range(3)]
    trains = [len(x) - len(base) for x in launches]
    assert sorted(trains) == [0, 0, 1]  # one trainer tick in three
    i = trains.index(1)
    size = int(drv.es.buf.size)
    assert launches[i][-1] == (cfg["num_target_samples"], cfg["buffer_capacity"], 3,
                               size + i + 1)


def test_grade_ms_reads_the_grade_span_a_call():
    spans = {"ticks": 30, "device_ms": {"grade": 0.2}, "device_calls": {"grade": 10}}
    assert grade_ms.read({"spans": spans}) == pytest.approx(0.6)
    assert grade_ms.read({"spans": dict(spans, device_calls={})}) is None
    assert grade_ms.read({"spans": None}) is None
