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


def _restore(example, tree, where: str):
    """``example`` with its state replaced by ``tree``; modules, optimizers
    and generators are loaded in place, everything else is rebuilt."""
    if isinstance(example, torch.Tensor):
        if tree.shape != example.shape or tree.dtype != example.dtype:
            raise ValueError(f"{where}: checkpoint has {tree.dtype} {tuple(tree.shape)}, "
                             f"the state {example.dtype} {tuple(example.shape)}")
        return tree.to(example.device)
    if isinstance(example, torch.Generator):
        example.set_state(tree)
        return example
    if isinstance(example, (nn.Module, torch.optim.Optimizer)):
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
    them."""
    tree = torch.load(_path(path), map_location="cpu", weights_only=True)
    return _restore(example_state, tree, "state")


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
