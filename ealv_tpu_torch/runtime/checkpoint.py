"""Checkpoint and resume of the whole experiment state (port of
``ealv_tpu/runtime/checkpoint.py``).

A checkpoint is one file written by ``torch.save``: the ``ExperimentState``
as nested dicts of CPU tensors and Python scalars. It holds the model's and
the optimizer's ``state_dict`` (``torch.optim.Adam`` or ``FusedAdam``), the
replay ring with its hyperparameter ring and counters, the model, planner,
env and schedule states, the state of every ``torch.Generator`` (the
trainer's and the planner's), ``explr_step`` and ``learning_ind``. A run
restored from it continues exactly where the saved run stopped: nothing is
re-seeded. Writes go to a temporary file that ``os.replace`` moves into
place, so a killed run never leaves a half-written checkpoint.
"""

from __future__ import annotations

import dataclasses
import json
import os

import torch
from torch import nn


def _path(path: str) -> str:
    return os.path.abspath(os.path.expanduser(path))


def state_tree(obj):
    """``obj`` (an ``ExperimentState`` or any part of it) as nested dicts of
    tensors and Python scalars. Tensors are the live ones, not copies."""
    if isinstance(obj, torch.Tensor):
        return obj.detach()
    if isinstance(obj, torch.Generator):
        return obj.get_state()
    if isinstance(obj, (nn.Module, torch.optim.Optimizer)):
        return obj.state_dict()
    if dataclasses.is_dataclass(obj):
        return {f.name: state_tree(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):  # NamedTuple
        return {f: state_tree(getattr(obj, f)) for f in obj._fields}
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    raise TypeError(f"no checkpoint form for {type(obj).__name__}")


def state_leaves(obj):
    """(path, leaf) pairs of ``state_tree(obj)`` in a fixed order: the
    tensors and Python scalars that a checkpoint of ``obj`` holds."""
    def walk(tree, path):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from walk(v, f"{path}.{k}")
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                yield from walk(v, f"{path}[{i}]")
        else:
            yield path, tree
    return list(walk(state_tree(obj), "state"))


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


# the size in bytes of a generator's state, by device type: a CPU generator
# keeps its Mersenne Twister state, a CUDA one its Philox seed and offset
_GENERATOR_STATE_BYTES = {5056: "cpu", 16: "cuda"}
# the options of a torch optimizer's param group that follow the device its
# parameters are on, not the run: kept from the optimizer loaded into
_DEVICE_OPTIONS = ("capturable", "fused", "foreach")


def _restore_generator(example: torch.Generator, tree, where: str):
    """Load the saved state ``tree`` into ``example``. A random stream
    cannot continue on another device type: a CPU generator's state and a
    CUDA one's differ in kind and size, so such a state raises here rather
    than inside ``set_state``."""
    want = example.get_state()
    if tree.dtype != want.dtype or tree.shape != want.shape:
        saved = _GENERATOR_STATE_BYTES.get(tree.numel(), "an unknown device type")
        raise ValueError(
            f"{where}: the checkpoint's random stream is a {saved} generator's "
            f"({tree.numel()} bytes of state), the state's is a {example.device.type} "
            f"generator ({want.numel()} bytes); a random stream does not cross device "
            f"types, so load the checkpoint into a state built on the device it was "
            f"saved from")
    example.set_state(tree)
    return example


def _restore_optimizer(example: torch.optim.Optimizer, tree):
    """``load_state_dict``, keeping ``example``'s device options: a
    checkpoint of a CPU run's ``torch.optim.Adam`` (not capturable) loaded
    into a CUDA one keeps it capturable, its step counts moved to the
    parameters' device."""
    kept = [{k: g[k] for k in _DEVICE_OPTIONS if k in g} for g in example.param_groups]
    example.load_state_dict(tree)
    for group, options in zip(example.param_groups, kept):
        group.update(options)
        if options.get("capturable") or options.get("fused"):
            for p in group["params"]:
                state = example.state.get(p, {})
                if isinstance(state.get("step"), torch.Tensor):
                    state["step"] = state["step"].to(dtype=torch.float32, device=p.device)
    return example


def _restore(example, tree, where: str):
    """``example`` with its state replaced by ``tree``; modules, optimizers
    and generators are loaded in place, everything else is rebuilt."""
    if isinstance(example, torch.Tensor):
        if (isinstance(tree, int) and not isinstance(tree, bool) and example.dim() == 0
                and not example.is_floating_point() and example.dtype != torch.bool):
            # an integer counter that an older checkpoint kept as a host int
            return torch.tensor(tree, dtype=example.dtype, device=example.device)
        if tree.shape != example.shape or tree.dtype != example.dtype:
            raise ValueError(f"{where}: checkpoint has {tree.dtype} {tuple(tree.shape)}, "
                             f"the state {example.dtype} {tuple(example.shape)}")
        return tree.to(example.device)
    if isinstance(example, torch.Generator):
        return _restore_generator(example, tree, where)
    if isinstance(example, torch.optim.Optimizer):
        return _restore_optimizer(example, tree)
    if isinstance(example, nn.Module):
        example.load_state_dict(tree)
        return example
    if dataclasses.is_dataclass(example):
        return dataclasses.replace(example, **{
            f.name: _restore(getattr(example, f.name), tree[f.name], f"{where}.{f.name}")
            for f in dataclasses.fields(example)})
    if isinstance(example, tuple) and hasattr(example, "_fields"):
        return type(example)(**{f: _restore(getattr(example, f), tree[f], f"{where}.{f}")
                                for f in example._fields})
    if type(tree) is not type(example):
        raise ValueError(f"{where}: checkpoint has {tree!r}, the state {example!r}")
    return tree


def save_checkpoint(path: str, state, step: int | None = None) -> str:
    """Save ``state`` to the file ``path``, or to ``path/step_{step:07d}``
    with ``step``. Returns the checkpoint's path."""
    path = _path(path)
    if step is not None:
        path = os.path.join(path, f"step_{step:07d}")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = os.path.join(os.path.dirname(path),
                       f".{os.path.basename(path)}.{os.getpid()}.tmp")
    torch.save(_to_cpu(state_tree(state)), tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str, example_state):
    """Restore the checkpoint at ``path`` into the structure and devices of
    ``example_state`` (e.g. a fresh ``Experiment.init``). Its model,
    optimizer and generators are loaded in place; the returned state holds
    them. Tensors move to the example's devices; random streams do not: a
    generator's saved state loads only into a generator of the device type
    it was saved from (a CPU generator's state and a CUDA one's differ in
    kind), and any other raises ``ValueError``. A checkpoint that kept the
    replay ring's counters as host ints loads into the device counters."""
    path = _path(path)
    tree = torch.load(path, map_location="cpu", weights_only=True)
    return _restore(example_state, tree, f"{path}: state")


def latest_checkpoint(base: str) -> str | None:
    """Most recent ``step_*`` checkpoint under ``base``, if any."""
    base = _path(base)
    if not os.path.isdir(base):
        return None
    steps = sorted(d for d in os.listdir(base) if d.startswith("step_"))
    return os.path.join(base, steps[-1]) if steps else None


def save_run_config(dir_path: str, cfg) -> None:
    """Dump the frozen experiment config into the run dir as config.json."""
    os.makedirs(dir_path, exist_ok=True)
    with open(os.path.join(dir_path, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2, default=str)
