"""Whole steps of the port's loops as captured CUDA graphs: the
counterpart of the JAX package's compiled ``lax.scan`` over a tick.

The JAX package runs its tick (``ealv_tpu/runtime/agent.py``), its
25-step trainer call and its planner call as compiled programs. The port
runs them as eager Python, thousands of device launches a tick at
production size, each dispatched by the host. ``StepGraph`` captures a
whole step of a loop (``Experiment.tick``, one post-training call,
``EvalExperiment.tick``, a fingerprint capture or identification step, the
host loop's plan and its absorb-and-plan) as a CUDA graph and replays it:
the host then issues one launch a step. ``run_step`` is the step
mechanics the runtimes share: the carry split off the runtime's state,
the body on a view that holds the host values as they were, and the new
carry joined back.

A captured step reads fixed device addresses and frozen host values. So

- one graph is captured for each pattern of the host values the step
  branches on (which trainer calls run, the prior, the arm's drift
  corrections, ...). A pattern's first step runs eagerly (a real step of
  the run, which also creates the optimizer's moments, the library
  workspaces and the kernels' launch plans), its second captures and
  replays, later ones replay. A pattern whose step runs nothing that
  another pattern's eager step has not (the arm's drift corrections,
  ``Experiment.tick``) can be captured ahead (``prepare_step``): its first
  step replays;
- what the step replaces (the planner and env state, the target state,
  beta and gamma; the capture's model state; the identification's
  beliefs; the host loop's pending plan) is its carry, resident in static
  buffers that the step's last kernels overwrite, so the next replay reads
  what the last one wrote. A caller's carry that is not those buffers is
  copied in before a replay, and so are the fed draws; what the step
  returns is cloned out of the graph's memory;
- what the step reads or updates in place (the model's parameters and
  buffers, the optimizer's moments and step counts, the rings) is read by
  address: every graph is keyed on those addresses, the generators and
  the carry's structure, and all are dropped when that base key changes;
- the host values the step computes with are staged into device scalars
  by the caller before each replay;
- the step's ``torch.Generator``s are registered with each graph, so that
  a replay advances the random streams as the eager step does and draws
  what it would draw.

A capture that fails raises; nothing falls back to the eager step. On the
CPU there are no graphs: the runtimes run their steps eagerly there, and
the tests run the staging through ``EagerGraph``, which replays by calling
the step again on the static buffers and writing its outputs into the
first replay's. The patterns' graphs share one memory pool.

The kernels' wrappers count launches on the host, so a replay, which
makes none, leaves them as they are. Each graph records the launches its
capture made (the wrappers' counts are set back, since the capture ran no
kernel) and adds them to its step's ``launched`` on every replay:
``kernel_launches`` sums the eager counts and the graphs'.
"""

from __future__ import annotations

import copy
import dataclasses
import gc
import time

import torch
from torch import nn

from ..ops.adam import adam_apply
from ..ops.belief import fuse_beliefs
from ..ops.descent import descent_accept, descent_slot, descent_window, plan_cost
from ..ops.footprint import footprint_and_spread
from ..ops.rollout import costate_sweep, horizon_rollout
from ..ops.wgrad import conv_wgrad_direct
from . import tracing

KERNELS = {"footprint_and_spread": footprint_and_spread, "adam_apply": adam_apply,
           "conv_wgrad_direct": conv_wgrad_direct, "horizon_rollout": horizon_rollout,
           "costate_sweep": costate_sweep, "fuse_beliefs": fuse_beliefs,
           "descent_slot": descent_slot, "descent_window": descent_window,
           "descent_accept": descent_accept, "plan_cost": plan_cost}
# the launches every graph's replays made since the last reset_launches(),
# for a caller that cannot reach the graphs (a capture's EvalExperiment
# lives only inside capture_fingerprint)
_REPLAYED = dict.fromkeys(KERNELS, 0)


class CaptureError(RuntimeError):
    """A capture failed. Raised by the step that captures, and again by
    every later step of its pattern: nothing runs the eager step in its
    place."""


def _leaf(x) -> bool:
    return x is None or isinstance(x, (bool, int, float, str, torch.dtype))


def _fields(tree):
    """(kind, [(name, child)]) of a container, or None for a leaf."""
    if isinstance(tree, torch.Tensor) or _leaf(tree) or isinstance(
            tree, (nn.Module, torch.Generator)):
        return None
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return "dataclass", [(f.name, getattr(tree, f.name))
                             for f in dataclasses.fields(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return "namedtuple", list(zip(tree._fields, tree))
    if isinstance(tree, (tuple, list)):
        return "sequence", list(enumerate(tree))
    if isinstance(tree, dict):
        return "dict", list(tree.items())
    raise TypeError(f"a graph takes no input of type {type(tree).__name__}")


def _rebuild(tree, kind, children):
    if kind == "dataclass":
        return dataclasses.replace(tree, **dict(children))
    if kind == "namedtuple":
        return type(tree)(*(v for _, v in children))
    if kind == "sequence":
        return type(tree)(v for _, v in children)
    return dict(children)


def _spec(tree):
    """The hashable form of ``tree``'s structure: each tensor's shape,
    strides, dtype and device, each module's and generator's identity,
    each plain value."""
    if isinstance(tree, torch.Tensor):
        return "tensor", tuple(tree.shape), tree.stride(), tree.dtype, tree.device
    if isinstance(tree, (nn.Module, torch.Generator)):
        return type(tree).__name__, id(tree)
    if _leaf(tree):
        return tree
    kind, children = _fields(tree)
    return type(tree), tuple((k, _spec(v)) for k, v in children)


def _clone(tree):
    """``tree`` with every tensor cloned: the static buffers."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    found = _fields(tree)
    if found is None:
        return tree
    kind, children = found
    return _rebuild(tree, kind, [(k, _clone(v)) for k, v in children])


def _extent(t: torch.Tensor) -> tuple:
    """(device, first byte, end byte) of the memory ``t`` spans."""
    if t.numel() == 0:
        return t.device, 0, 0
    span = 1 + sum((n - 1) * s for n, s in zip(t.shape, t.stride()))
    return t.device, t.data_ptr(), t.data_ptr() + span * t.element_size()


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """``a`` and ``b`` are the same tensor: the same memory, read the same way."""
    return a is b or (a.data_ptr() == b.data_ptr() and a.device == b.device
                      and a.dtype == b.dtype and a.shape == b.shape
                      and a.stride() == b.stride())


def _overlaps(a: torch.Tensor, b: torch.Tensor) -> bool:
    (da, a0, a1), (db, b0, b1) = _extent(a), _extent(b)
    return da == db and a0 < b1 and b0 < a1


def _tensor_pairs(static, tree, out: list) -> list:
    """[(static tensor, the tree's tensor at its place)]."""
    if isinstance(static, torch.Tensor):
        out.append((static, tree))
        return out
    found = _fields(static)
    if found is not None:
        for (_, s), (_, t) in zip(found[1], _fields(tree)[1], strict=True):
            _tensor_pairs(s, t, out)
    return out


def _copy_into(static, tree):
    """Copy every tensor of ``tree`` into its static buffer; a tensor that
    is its static buffer is left as it is, one that partly overlaps it
    raises."""
    for s, t in _tensor_pairs(static, tree, []):
        if _same(s, t):
            continue
        if _overlaps(s, t):
            raise ValueError("a staged input partly overlaps its static buffer")
        s.copy_(t)


def _write_back(static, new) -> None:
    """Overwrite the static carry with the step's ``new`` carry, in place
    (inside a capture: the step's last kernels). A new value that is its
    static buffer stays; one that partly overlaps it, or that differs from
    it in shape or dtype, raises. A new value that reads another static
    buffer is copied first, since the copies overwrite that buffer."""
    pairs = []
    for s, t in _tensor_pairs(static, new, []):
        if not isinstance(t, torch.Tensor) or t.shape != s.shape or t.dtype != s.dtype:
            raise ValueError(f"the step's new carry {getattr(t, 'shape', t)} does not fit "
                             f"its static buffer {tuple(s.shape)} {s.dtype}")
        if _same(s, t):
            continue
        if _overlaps(s, t):
            raise ValueError("the step's new carry partly overlaps its static buffer")
        pairs.append((s, t))
    targets = [s for s, _ in pairs]
    pairs = [(s, t.clone() if any(_overlaps(t, u) for u in targets) else t) for s, t in pairs]
    for s, t in pairs:
        s.copy_(t)


def _addresses(tensors) -> tuple:
    return tuple(t.data_ptr() for t in tensors)


def inplace_key(tree) -> tuple:
    """What a step reads in place from ``tree`` (a planner's target
    context): its structure, each module's parameters and buffers and
    each tensor by address."""
    modules, tensors = [], []

    def walk(x):
        if isinstance(x, nn.Module):
            modules.append(x)
        elif isinstance(x, torch.Tensor):
            tensors.append(x)
        elif not isinstance(x, torch.Generator):
            found = _fields(x)
            for _, child in (found[1] if found else ()):
                walk(child)

    walk(tree)
    return _spec(tree), tuple(module_key(m) for m in modules), _addresses(tensors)


def module_key(model: nn.Module) -> tuple:
    """A module by identity and the addresses of its parameters and
    buffers, which a graph reads in place."""
    return id(model), _addresses([*model.parameters(), *model.buffers()])


def optimizer_key(opt: torch.optim.Optimizer) -> tuple:
    """An optimizer by identity, the addresses of its state's tensors (the
    moments and the step counts, which its step updates in place) and its
    groups' other options."""
    tensors = [v for st in opt.state.values() for v in st.values()
               if isinstance(v, torch.Tensor)]
    tensors += [v for g in opt.param_groups for v in g.values() if isinstance(v, torch.Tensor)]
    options = repr([[(k, v) for k, v in sorted(g.items())
                     if k != "params" and not isinstance(v, torch.Tensor)]
                    for g in opt.param_groups])
    return id(opt), _addresses(tensors), options


def kernel_counts() -> dict:
    """The kernels' wrapper counts: their eager launches."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def kernel_launches(*graphs) -> dict:
    """Every kernel's launches: the wrappers' eager counts plus what the
    ``graphs``' replays launched."""
    out = kernel_counts()
    for g in graphs:
        for name, n in g.launched.items():
            out[name] += n
    return out


def total_launches() -> dict:
    """Every kernel's launches since the last ``reset_launches()``: the
    wrappers' eager counts plus what every graph's replays launched."""
    counts = kernel_counts()
    return {name: counts[name] + _REPLAYED[name] for name in KERNELS}


def _replayed(launched: dict, recorded: dict) -> None:
    """Add a replay's recorded launches to a graph's ``launched`` and to
    the tally of every graph's."""
    for name, n in recorded.items():
        launched[name] += n
        _REPLAYED[name] += n


def reset_launches(*graphs) -> None:
    """Set the wrappers' counts, the tally of every graph's replayed
    launches and the ``graphs``' own to 0."""
    for fn in KERNELS.values():
        fn.launches = 0
    for name in KERNELS:
        _REPLAYED[name] = 0
    for g in graphs:
        g.launched = dict.fromkeys(KERNELS, 0)
        g.replays = 0


def _counted_capture(graph, body, static) -> tuple:
    """Capture ``body(static)`` into ``graph``. Returns (the kernel launches
    the capture recorded, its seconds); the wrappers' counts are set back,
    since a capture runs no kernel."""
    before = kernel_counts()
    t0 = time.perf_counter()
    try:
        graph.capture(body, static)
    except CaptureError:
        raise
    except Exception as e:
        raise CaptureError(f"capturing failed: {type(e).__name__}: {e}") from e
    finally:
        after = kernel_counts()
        for name, fn in KERNELS.items():
            fn.launches = before[name]
    return {name: after[name] - before[name] for name in KERNELS}, time.perf_counter() - t0


class CudaGraph:
    """One ``torch.cuda.CUDAGraph`` of a step, its generators registered,
    its memory from ``pool`` (a ``torch.cuda.MemPool`` shared with other
    graphs) or a private pool."""

    def __init__(self, generators, pool=None):
        self.pool = None if pool is None else pool.id
        self.graph = torch.cuda.CUDAGraph()
        for gen in generators:
            # each replay then reads the generator's seed and offset and
            # advances the offset by what the captured draws consume
            self.graph.register_generator_state(gen)
        self.out = None

    def capture(self, body, static):
        # Python's cyclic collector must not run inside a capture: a dead
        # reference cycle that holds another graph (an Experiment and its
        # planner refer to each other) would destroy that graph mid-capture
        # and invalidate this one. torch.cuda.graph no longer collects on
        # entry, so collect here, then hold the collector off until the end.
        gc.collect()
        enabled = gc.isenabled()
        gc.disable()
        failed = None
        try:
            # "thread_local": another thread's CUDA work (a bridge's camera,
            # the autograd engine's device thread) does not fail the capture
            shared = {} if self.pool is None else {"pool": self.pool}
            with torch.cuda.graph(self.graph, capture_error_mode="thread_local", **shared):
                try:
                    self.out = body(static)
                except BaseException as e:
                    failed = e
                    raise
        except Exception as e:
            if failed is None or e is failed:
                raise
            # the capture's end reports only that the capture was invalidated:
            # name the call's own error, which is the cause
            raise CaptureError(f"capturing the call failed: {type(failed).__name__}: "
                               f"{failed}") from failed
        finally:
            if enabled:
                gc.enable()

    def replay(self):
        self.graph.replay()
        return self.out


class EagerGraph:
    """The staging of a captured step without a card: "capture" keeps the
    function, each replay calls it on the static buffers and writes what it
    returns into the first replay's tensors, as a graph's replay overwrites
    its outputs. It holds the staging, the keys and the cloning to a graph's
    rules on the CPU."""

    def __init__(self, generators, pool=None):
        self.out = None

    def capture(self, body, static):
        self.body, self.static = body, static

    def replay(self):
        got = self.body(self.static)
        if self.out is None:
            self.out = got
        else:
            _copy_into(self.out, got)
        return self.out


@dataclasses.dataclass
class _Entry:
    graph: object
    draws: object  # the staged draws' static buffers
    recorded: dict  # the kernel launches the capture recorded


class StepGraph:
    """One step of a loop as captured graphs, one a pattern of the host
    values the step branches on (see the module's docstring).

    ``step(base_fn, pattern, carry, draws, body, generators)`` runs
    ``body(carry, draws) -> (new carry, out)``:

    - ``base_fn()`` keys what every pattern's graph reads in place (the
      addresses of the parameters, the optimizer's state and the rings, the
      generators, the carry's structure), with the tracer's ``state()``
      (a graph holds its stamps); when it changes, every graph is
      dropped. It is read again after an eager step, which may create what
      it holds (the optimizer's moments);
    - ``pattern`` keys the host values the step branches on (which trainer
      calls run, ...); with the fed draws' structure it picks the graph. A
      pattern's first step runs eagerly, its second captures and replays,
      later ones replay (``prepare`` captures one ahead);
    - ``carry`` is staged: copied into the static carry that every
      pattern's graph reads (a tensor that is its static buffer, as after
      a replay, is not copied), and the graph ends by writing the new
      carry into it. Returns (carry, out): after an eager step the body's
      new carry, after a replay the static carry; ``out`` cloned either
      way (out of the graph's memory, or off the static buffers that an
      eager step's out may hold);
    - ``draws`` (fed draws) are staged into the pattern's own buffers.

    Counts: ``warmups``, ``captures`` and ``replays`` over every pattern,
    ``counts[pattern]`` the three for each, ``capture_seconds[pattern]``;
    ``launched`` sums the kernel launches each capture recorded over its
    replays. The tracer's host spans ``key``,
    ``stage``, ``replay`` and ``clone`` (``runtime/tracing.py``) time the
    step's parts on the host. Every graph takes its memory from
    ``pool`` (a ``torch.cuda.MemPool``, which other steps' graphs may
    share); nothing allocated there outlives a replay but the graphs'
    outputs, which are cloned out at once. The ``MemPool`` object keeps the
    pool alive while its graphs are dropped and captured anew: the caching
    allocator refuses a capture into a graph pool whose last graph is gone
    and whose memory it has not yet released."""

    def __init__(self, graph_type=CudaGraph, pool=None):
        self.graph_type, self.pool = graph_type, pool
        self.base = self.carry = self.traced = None
        self.entries: dict = {}
        self.warm: set = set()
        self.counts: dict = {}
        self.capture_seconds: dict = {}
        self.launched = dict.fromkeys(KERNELS, 0)
        self.warmups = self.captures = self.replays = 0

    def _rebase(self, base) -> None:
        """Drop every graph (and the static carry) when the base or the
        tracer's state changes."""
        traced = tracing.state()
        if base != self.base or traced != self.traced:
            self.entries, self.warm, self.carry = {}, set(), None
            self.base, self.traced = base, traced

    def _count(self, pattern, i: int) -> None:
        self.counts.setdefault(pattern, [0, 0, 0])[i] += 1

    def step(self, base_fn, pattern, carry, draws, body, generators):
        with tracing.span("key"):
            self._rebase(base_fn())
            key = (pattern, _spec(draws))
        entry = self.entries.get(key)
        if entry is None:
            if key not in self.warm:
                new, out = body(carry, draws)
                self._rebase(base_fn())
                self.warm.add(key)
                self.warmups += 1
                self._count(pattern, 0)
                # out may hold carry tensors it left as they were: after a
                # replay those are the static buffers, which later replays
                # overwrite
                return new, _clone(out)
            entry = self._capture(key, carry, draws, body, generators)
        else:
            with tracing.span("stage"):
                _copy_into(self.carry, carry)
                _copy_into(entry.draws, draws)
        with tracing.span("replay"):
            out = entry.graph.replay()
        self.replays += 1
        self._count(pattern, 2)
        _replayed(self.launched, entry.recorded)
        with tracing.span("clone"):
            out = _clone(out)
        return self.carry, out

    def prepare(self, base_fn, pattern, carry, draws, body, generators) -> bool:
        """Capture ``pattern``'s graph ahead of its first step, without
        running it, so that its first step replays (``step``'s arguments).
        Only for a pattern whose step runs nothing that the steps made
        under the base have not run eagerly: there is no eager step to
        create what it would create. Needs a capture under the base, whose
        static carry the graph reads; ``carry`` only keys the base, and the
        static carry's values are left as they are. Returns whether it
        captured (False: the pattern has its graph)."""
        self._rebase(base_fn())
        key = (pattern, _spec(draws))
        if key in self.entries:
            return False
        if self.carry is None:
            raise RuntimeError("a step graph captures a pattern ahead only after a capture "
                               "under its base")
        self._capture(key, None, draws, body, generators)
        return True

    def _capture(self, key, carry, draws, body, generators) -> _Entry:
        if self.carry is None:
            self.carry = _clone(carry)
        elif carry is not None:
            _copy_into(self.carry, carry)
        static_draws = _clone(draws)

        def recorded_step(static):
            new, out = body(*static)
            _write_back(static[0], new)
            return out

        graph = self.graph_type(generators, self.pool)
        recorded, seconds = _counted_capture(graph, recorded_step, (self.carry, static_draws))
        self.capture_seconds.setdefault(key[0], []).append(seconds)
        entry = _Entry(graph, static_draws, recorded)
        self.entries[key] = entry
        self.captures += 1
        self._count(key[0], 1)
        return entry


def run_step(graph: StepGraph, state, split, join, base, pattern, draws, run, generators):
    """One step of a runtime's ``state`` through ``graph``, the mechanics
    ``Experiment``, ``EvalExperiment`` and ``HostLoopRunner`` share.
    ``split(state)`` is the
    carry; ``join(state, carry)`` a view of ``state`` that holds ``carry``
    and ``state``'s host values; ``run(view, draws)`` makes the step on a
    view and returns (the new state, out); ``base(state, carry)`` is the
    base key. The body reads the host values as they are now, as a capture
    freezes them: under one pattern they give the same branches on every
    step. Returns (a view of ``state`` holding the new carry, out); the
    caller advances its host values."""
    carry = split(state)
    carry, out = graph.step(lambda: base(state, carry), pattern, carry, draws,
                            _body(state, split, join, run), generators)
    return join(state, carry), out


def prepare_step(graph: StepGraph, state, split, join, base, pattern, draws, run,
                 generators) -> bool:
    """``StepGraph.prepare`` for ``run_step``'s step on ``state``: capture
    ``pattern``'s graph ahead, the body reading ``state``'s host values,
    without running it. Returns whether it captured."""
    carry = split(state)
    return graph.prepare(lambda: base(state, carry), pattern, carry, draws,
                         _body(state, split, join, run), generators)


def _body(state, split, join, run):
    """The step's body on the carry: ``run`` on a view of ``state`` as it
    is now (its host values frozen, as a capture freezes them)."""
    frozen = copy.copy(state)

    def body(carry, draws):
        new, out = run(join(frozen, carry), draws)
        return split(new), out

    return body
