"""Checkpoint and resume of the port's whole experiment state, in the form
of ``tests/test_resume.py``: a run that saves mid-way and continues must
equal, bit for bit, a fresh ``Experiment`` that loads the checkpoint and
replays the rest. The generator states are part of the state, so a
restored run does not re-seed. CPU, port only.
"""

import dataclasses
import json
import os

import pytest
import torch

from ealv_tpu_torch.ops import FusedAdam
from ealv_tpu_torch.runtime import Experiment
from ealv_tpu_torch.runtime.checkpoint import (latest_checkpoint, load_checkpoint,
                                               save_checkpoint, save_run_config,
                                               state_leaves)
from ealv_tpu_torch.utils.config import ExperimentConfig
from test_torch_trainer import one_torch_thread  # noqa: F401

CHUNK = 3


def tiny_experiment(fused_adam=False, fast_encoder_grads=False):
    cfg = ExperimentConfig(
        states="xyw", image_dim=(24, 24, 3), cnn_kernels=(3, 3), cnn_strides=(2, 2),
        cnn_channels=(8, 8), hidden_dim=(64, 32), z_dim=8, num_target_samples=128,
        num_traj_samples=64, traj_buffer_capacity=256, buffer_capacity=256,
        batch_size=8, num_learning_opt=2, fast_encoder_grads=fast_encoder_grads)
    exp = Experiment(cfg, train_calls_per_tick=1, device="cpu")
    exp.trainer = dataclasses.replace(exp.trainer, fused_adam=fused_adam)
    return exp


def assert_states_equal(a, b):
    la, lb = state_leaves(a), state_leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), path
        else:
            assert x == y, path


@pytest.mark.parametrize("fused_adam,fast_encoder_grads",
                         [(False, False), (True, "pallas")])
def test_resume_is_bit_identical(tmp_path, fused_adam, fast_encoder_grads):
    """2 chunks, save, 2 chunks and a post-training call, against a fresh
    Experiment that restores the checkpoint and replays the rest."""
    exp = tiny_experiment(fused_adam, fast_encoder_grads)
    es = exp.init(seed=0)
    for _ in range(2):
        es, _ = exp.run_chunk(es, CHUNK)
    ck = save_checkpoint(str(tmp_path / "ckpts"), es, step=es.explr_step)
    for _ in range(2):
        es, _ = exp.run_chunk(es, CHUNK)
    es, _ = exp.post_train_chunk(es, 1)

    exp2 = tiny_experiment(fused_adam, fast_encoder_grads)
    es2 = exp2.init(seed=0)
    assert latest_checkpoint(str(tmp_path / "ckpts")) == ck
    es2 = load_checkpoint(ck, es2)
    assert es2.explr_step == 2 * CHUNK and es2.learning_ind > 0
    assert isinstance(es2.opt, FusedAdam) == fused_adam
    for _ in range(2):
        es2, _ = exp2.run_chunk(es2, CHUNK)
    es2, _ = exp2.post_train_chunk(es2, 1)
    assert_states_equal(es, es2)


def test_restored_run_does_not_reseed(tmp_path):
    """The trainer's and the planner's generator states come back from the
    checkpoint, not from the seed of the Experiment they are loaded into."""
    exp = tiny_experiment()
    es = exp.init(seed=3)
    es, _ = exp.run_chunk(es, CHUNK)
    ck = save_checkpoint(str(tmp_path / "c"), es, step=es.explr_step)
    fresh = exp.init(seed=3)
    es2 = load_checkpoint(ck, exp.init(seed=3))
    for gen in (lambda s: s.gen, lambda s: s.pstate.gen):
        assert torch.equal(gen(es2).get_state(), gen(es).get_state())
        assert not torch.equal(gen(es2).get_state(), gen(fresh).get_state())
    assert_states_equal(es, es2)


def test_checkpoint_files_and_latest(tmp_path):
    """step_{step:07d} naming; the latest is the highest step; a write
    leaves no temporary file behind; an explicit path is a file; the run
    config goes to config.json."""
    exp = tiny_experiment()
    es = exp.init(seed=0)
    base = str(tmp_path / "ckpts")
    assert latest_checkpoint(base) is None
    for step in (9, 10, 2):
        es.explr_step = step
        save_checkpoint(base, es, step=step)
    assert sorted(os.listdir(base)) == ["step_0000002", "step_0000009", "step_0000010"]
    assert latest_checkpoint(base) == os.path.join(base, "step_0000010")
    path = save_checkpoint(os.path.join(base, "postexplr"), es)
    assert os.path.isfile(path) and load_checkpoint(path, exp.init(seed=1)).explr_step == 2
    assert not [f for f in os.listdir(base) if f.endswith(".tmp")]
    save_run_config(str(tmp_path / "run"), exp.cfg)
    with open(tmp_path / "run" / "config.json") as f:
        assert json.load(f)["buffer_capacity"] == exp.cfg.buffer_capacity


def test_load_into_another_shape_raises(tmp_path):
    exp = tiny_experiment()
    ck = save_checkpoint(str(tmp_path / "c"), exp.init(seed=0), step=0)
    other = Experiment(dataclasses.replace(exp.cfg, buffer_capacity=128),
                       train_calls_per_tick=1, device="cpu")
    with pytest.raises(ValueError):
        load_checkpoint(ck, other.init(seed=0))


def test_generator_state_of_another_device_type_raises(tmp_path):
    """A random stream does not cross device types: a saved generator state
    of a CUDA generator's 16 bytes (its Philox seed and offset) loaded into
    a CPU generator raises a ValueError that names the file, the field and
    both device types, before set_state sees it."""
    exp = tiny_experiment()
    ck = save_checkpoint(str(tmp_path / "c"), exp.init(seed=0), step=0)
    tree = torch.load(ck, weights_only=True)
    assert tree["gen"].numel() == 5056  # a CPU generator's Mersenne Twister state
    tree["gen"] = torch.zeros(16, dtype=torch.uint8)
    torch.save(tree, ck)
    with pytest.raises(ValueError, match="cuda generator.*cpu generator") as err:
        load_checkpoint(ck, exp.init(seed=0))
    assert ck in str(err.value) and "state.gen" in str(err.value)


@pytest.mark.parametrize("fused_adam", [False, True])
def test_checkpoint_with_host_int_counters_loads(tmp_path, fused_adam):
    """A checkpoint written when the replay ring's head, fill and push
    count and FusedAdam's step count were host ints loads into the device
    counters, and the run continues as the run that saved it."""
    exp = tiny_experiment(fused_adam)
    es = exp.init(seed=0)
    es, _ = exp.run_chunk(es, 2 * CHUNK)
    ck = save_checkpoint(str(tmp_path / "c"), es, step=es.explr_step)
    tree = torch.load(ck, weights_only=True)
    for k in ("pos", "size", "total"):
        tree["buf"][k] = int(tree["buf"][k])
    if fused_adam:
        tree["opt"]["param_groups"][0]["step"] = int(tree["opt"]["param_groups"][0]["step"])
    torch.save(tree, ck)
    es2 = load_checkpoint(ck, tiny_experiment(fused_adam).init(seed=0))
    assert all(getattr(es2.buf, k).dtype == torch.int64 for k in ("pos", "size", "total"))
    assert_states_equal(es, es2)
    es, _ = exp.run_chunk(es, CHUNK)
    es2, _ = exp.run_chunk(es2, CHUNK)
    assert_states_equal(es, es2)


def test_optimizer_keeps_its_device_options_on_load():
    """An optimizer loaded from another device's checkpoint keeps its own
    device options: a non-capturable Adam's state (a CPU run's) loaded into
    a capturable one (the card's) leaves it capturable, its step counts f32
    on the parameters' device."""
    from ealv_tpu_torch.runtime.checkpoint import _restore
    w = [torch.zeros(4, requires_grad=True) for _ in range(2)]
    saved = torch.optim.Adam([w[0]], lr=1e-3)
    w[0].grad = torch.ones(4)
    saved.step()
    opt = torch.optim.Adam([w[1]], lr=1e-3, capturable=True)
    _restore(opt, saved.state_dict(), "state.opt")
    assert opt.param_groups[0]["capturable"] is True
    step = opt.state[w[1]]["step"]
    assert step.dtype == torch.float32 and step.device == w[1].device and float(step) == 1.0
