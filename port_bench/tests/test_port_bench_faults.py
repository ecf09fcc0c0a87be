"""A run with the timed path broken underneath comes out not correct: a
tick that returns its state unchanged, other start weights than the
seed's, an answer altered where it is produced (the camera image), in the
learning cells a trainer call with half of each batch left out (the mean
taken over the rest) and one that leaves the weights unchanged, and in
the exploration cell half of the planner's target samples left out with
the density taken over the rest. The harness's look for a card is
skipped: the run drives the port on the CPU at a toy size."""

import pytest
import torch

from port_bench import harness
from port_bench.tests.toy import toy_mix

SEED = 3_000_000_123


def _correct(files, r) -> bool:
    return all(r["gaps"].get(k, float("inf")) <= lim for k, lim in files["limits"].items())


@pytest.mark.parametrize("cell", ["xyw.learn", "xyzrpw.eval"])
def test_a_sound_run_is_correct(cell):
    files = toy_mix(cell)
    assert _correct(files, harness.measure(files, SEED, 0.3, False, device="cpu"))


@pytest.mark.parametrize("cell", ["xyw.learn", "xyzrpw.eval"])
def test_a_tick_that_leaves_its_state_unchanged_is_caught(cell, monkeypatch):
    from ealv_tpu_torch.runtime import agent, tester

    real_learn, real_eval = agent.Experiment.tick, tester.EvalExperiment.tick

    def stuck_learn(self, es, draws=None):
        if not getattr(self, "_stuck", False):  # warm-up ticks run as they are
            return real_learn(self, es, draws)
        robot = self.explored.measured(es.env)[: self.cfg.s_dim]
        return es, {"ergodic_cost": torch.ones(()), "loss": torch.zeros(()),
                    "robot_state": robot}

    def stuck_eval(self, ev, ctx, draws=None):
        if not getattr(self, "_stuck", False):
            return real_eval(self, ev, ctx, draws)
        _, _, force, img = self.env.observe(ev.env)
        return ev, {"cost": torch.ones(()), "image": img, "force": force,
                    "robot_state": self.explored.measured(ev.env)[: self.cfg.s_dim]}

    monkeypatch.setattr(agent.Experiment, "tick", stuck_learn)
    monkeypatch.setattr(tester.EvalExperiment, "tick", stuck_eval)
    real_window = harness.window

    def window(drv, *a, **kw):
        drv.exp._stuck = True
        return real_window(drv, *a, **kw)

    monkeypatch.setattr(harness, "window", window)
    files = toy_mix(cell)
    assert not _correct(files, harness.measure(files, SEED, 0.3, False, device="cpu"))


@pytest.mark.parametrize("cell", ["xyw.learn", "xyzrpw.eval"])
def test_other_start_weights_are_caught(cell, monkeypatch):
    from ealv_tpu_torch.models import cvae

    real = cvae.CVAE.reset_parameters

    def shifted(self, generator):
        real(self, generator)
        with torch.no_grad():
            next(self.parameters()).add_(1e-6)

    monkeypatch.setattr(cvae.CVAE, "reset_parameters", shifted)
    files = toy_mix(cell)
    r = harness.measure(files, SEED, 0.3, False, device="cpu")
    assert r["gaps"]["start"] > 0 and not _correct(files, r)


@pytest.mark.parametrize("cell", ["xyw.learn", "xyzrpw.eval"])
def test_an_altered_image_is_caught(cell, monkeypatch):
    from ealv_tpu_torch.sim import env as env_mod

    real = env_mod.render_camera
    monkeypatch.setattr(env_mod, "render_camera",
                        lambda *a, **kw: (real(*a, **kw) * 0.9).clamp(0.0, 1.0))
    files = toy_mix(cell)
    r = harness.measure(files, SEED, 0.3, False, device="cpu")
    assert r["gaps"]["image"] > files["limits"]["image"]
    assert not _correct(files, r)


@pytest.mark.parametrize("cell", ["xyw.eval", "xyzrpw.eval"])
def test_half_of_the_planners_samples_left_out_is_caught(cell, monkeypatch):
    from ealv_tpu_torch.control.klerg import KlergPlanner

    real = KlergPlanner.plan_with_inputs

    def half(self, pstate, pdf_ctx, samples, *a, **kw):
        return real(self, pstate, pdf_ctx, samples[: samples.shape[0] // 2], *a, **kw)

    monkeypatch.setattr(KlergPlanner, "plan_with_inputs", half)
    files = toy_mix(cell)
    r = harness.measure(files, SEED, 0.3, False, device="cpu")
    assert r["gaps"]["cost"] > files["limits"]["cost"]
    assert not _correct(files, r)


@pytest.mark.parametrize("cell", ["xyw.learn", "xyzrpw.learn"])
def test_a_trainer_call_on_half_of_each_batch_is_caught(cell, monkeypatch):
    from ealv_tpu_torch.runtime import agent

    real = agent.train_call
    # the data-parallel seam: train on rows [0, B/2) of each batch drawn
    monkeypatch.setattr(agent, "train_call",
                        lambda *a, **kw: real(*a, num_shards=2, shard=0, **kw))
    files = toy_mix(cell)
    r = harness.measure(files, SEED, 0.3, False, device="cpu")
    assert max(t.get("params_worst", 0.0) for t in r["per_tick"]) > files["limits"]["params_worst"]
    assert not _correct(files, r)


@pytest.mark.parametrize("cell", ["xyw.learn", "xyzrpw.learn"])
def test_a_trainer_call_that_leaves_the_weights_unchanged_is_caught(cell, monkeypatch):
    from ealv_tpu_torch.runtime import agent

    real = agent.train_call

    def frozen(statics, model, *a, **kw):
        before = [p.detach().clone() for p in model.parameters()]
        metrics = real(statics, model, *a, **kw)
        with torch.no_grad():
            for p, b in zip(model.parameters(), before):
                p.copy_(b)
        return metrics

    monkeypatch.setattr(agent, "train_call", frozen)
    files = toy_mix(cell)
    r = harness.measure(files, SEED, 0.3, False, device="cpu")
    assert r["gaps"]["params_worst"] == 1.0 and not _correct(files, r)
