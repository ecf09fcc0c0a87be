"""The tick's two hot calls as captured CUDA graphs: the counterpart of the
JAX package's single compiled programs.

The JAX package runs its 25-step trainer call as one ``lax.scan``
(``ealv_tpu/runtime/trainer.py``) and its planner call as one jitted
function whose loops are fixed-trip scans (``ealv_tpu/control/klerg.py``).
The port runs both as eager Python loops, about 10,800 and 7,700 device
launches a call at production size, each dispatched by the host.
``TrainerGraph`` and ``PlannerGraph`` capture one whole call each as a CUDA
graph and replay it: the host then issues one launch a call.

A captured call reads fixed device addresses. So each graph

- copies the inputs that change between calls (beta and gamma, fed draws;
  the planner's state, the model's target state) into static buffers
  before every replay, and clones what the call returns (the trainer's
  metrics, the new plan, the planner's info) out of the graph's memory;
- reads in place what is updated in place (the model's parameters and
  buffers, the optimizer's moments and step counts, the replay ring), and
  is keyed on those tensors' addresses, with every host value the call
  depends on (the trainer's statics, ``temp``, ``use_prior``, the staged
  inputs' shapes). A call whose key differs from the graph's never replays
  it: the first call under a new key runs eagerly (a real call of the run,
  which also creates the optimizer's moments, the library workspaces and
  the kernels' launch plans), the next one captures and replays;
- registers the call's ``torch.Generator`` with the graph, so that each
  replay advances the random stream as the eager call does and draws what
  it would draw.

A capture that fails raises; nothing falls back to the eager call. On the
CPU there are no graphs: ``Experiment`` runs the eager calls there, and
the tests run the staging through ``EagerGraph``, which replays by calling
the function again on the static buffers and writing its outputs into the
first replay's.

The kernels' wrappers count launches on the host, so a replay, which
makes none, leaves them as they are. Each graph records the launches its
capture made (``recorded``; the wrappers' counts are set back, since the
capture ran no kernel) and adds them to ``launched`` on every replay:
``kernel_launches`` sums the eager counts and the graphs'.

``StepGraph`` goes one level up, as the reference's ``lax.scan`` over the
tick does (``ealv_tpu/runtime/agent.py``): it captures a whole step of a
loop (``Experiment.tick``, one post-training call, ``EvalExperiment.tick``,
a fingerprint capture or identification step, the host loop's absorb and
plan) with the calls above run eagerly inside, one graph for each pattern
of the host values the step branches on. Its carry (what the step
replaces: the planner and env state, the target state, beta and gamma;
the capture's model state; the identification's beliefs; the host loop's
pending plan) stays resident in static buffers that the
step's last kernels overwrite, so the next replay reads what the last one
wrote; the host values it computes with are staged into device scalars
before each replay. The patterns' graphs share one memory pool.
``run_step`` is the step mechanics the runtimes share: the carry split
off the runtime's state, the body on a view that holds the host values
as they were, and the new carry joined back.
"""

from __future__ import annotations

import copy
import dataclasses
import gc
import time

import torch
from torch import nn

from ..ops.adam import adam_apply
from ..ops.footprint import footprint_and_spread
from ..ops.wgrad import conv_wgrad_direct
from .trainer import train_call

KERNELS = {"footprint_and_spread": footprint_and_spread, "adam_apply": adam_apply,
           "conv_wgrad_direct": conv_wgrad_direct}
# the launches every graph's replays made since the last reset_launches(),
# for a caller that cannot reach the graphs (a capture's EvalExperiment
# lives only inside capture_fingerprint)
_REPLAYED = dict.fromkeys(KERNELS, 0)


class CaptureError(RuntimeError):
    """A capture failed. Raised by the call or step that captures, and again
    by every later one under its key: nothing runs the eager call in its
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


def _pairs(static, tree, out: dict):
    """{id of a static node: the caller's node}, over the tensors and
    containers of the static inputs."""
    found = _fields(static)
    if found is not None or isinstance(static, torch.Tensor):
        out[id(static)] = tree
    if found is not None:
        for (_, s), (_, t) in zip(found[1], _fields(tree)[1], strict=True):
            _pairs(s, t, out)
    return out


def _escape(out, mine: dict):
    """What the call returned, for its caller: a part that is a static
    input is the caller's own input; every other tensor is cloned out of
    the graph's memory, which the next replay overwrites."""
    if id(out) in mine:
        return mine[id(out)]
    if isinstance(out, torch.Tensor):
        return out.clone()
    found = _fields(out)
    if found is None:
        return out
    kind, children = found
    return _rebuild(out, kind, [(k, _escape(v, mine)) for k, v in children])


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
    """One ``torch.cuda.CUDAGraph`` of a call, its generators registered,
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
    """The staging of a captured call without a card: "capture" keeps the
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


class _CapturedCall:
    """A call run as a graph under a key (see the module's docstring):
    ``warmups``, ``captures`` and ``replays`` count the three ways a call
    went; ``capture_seconds`` times each capture; ``recorded`` holds the
    kernel launches the last capture recorded, ``launched`` those its
    replays made."""

    def __init__(self, graph_type=CudaGraph):
        self.graph_type = graph_type
        self.key = None  # the captured graph's
        self._warm = None  # the last eager call's
        self.graph = self.static = None
        self.recorded = dict.fromkeys(KERNELS, 0)
        self.launched = dict.fromkeys(KERNELS, 0)
        self.warmups = self.captures = self.replays = 0
        self.capture_seconds: list[float] = []

    def _drop(self) -> None:
        """Release the graph and its memory pool."""
        self.graph = self.static = self.key = None

    def _call(self, key_fn, inputs, body, generators):
        """``body(inputs)``: eagerly under a new key, else replayed (captured
        first on the key's second call). ``key_fn()`` gives the key; it is
        read again after an eager call, which may create what the key holds
        (the optimizer's moments)."""
        key = key_fn()
        if key != self.key:
            if key != self._warm:
                self._drop()
                self.warmups += 1
                out = body(inputs)
                self._warm = key_fn()
                return out
            self._capture(key, inputs, body, generators)
        else:
            _copy_into(self.static, inputs)
        out = self.graph.replay()
        self.replays += 1
        _replayed(self.launched, self.recorded)
        return _escape(out, _pairs(self.static, inputs, {}))

    def _capture(self, key, inputs, body, generators):
        self._drop()
        static = _clone(inputs)
        graph = self.graph_type(generators)
        self.recorded, seconds = _counted_capture(graph, body, static)
        self.capture_seconds.append(seconds)
        self.graph, self.static, self.key = graph, static, key
        self.captures += 1


class TrainerGraph(_CapturedCall):
    """``train_call`` as a captured graph: one whole call of
    ``num_learning_opt`` steps (sample, forward, loss, backward, optimizer
    step). Staged: ``beta``, ``gamma`` and fed ``draws``. Read in place and
    keyed by address: the model's parameters and buffers, the optimizer's
    state, the replay ring's rows (``x``, ``y``, ``force``) and its head and
    fill counters. Registered: ``generator``. Returns the metrics, cloned.
    With a ``mesh`` (a ``parallel.Mesh`` over an NCCL group) the call is
    ``parallel.dp_train_call``, its gradient and metric all-reduces captured
    with it; keyed by the mesh."""

    def __call__(self, statics, model, opt, buf, beta, gamma,
                 generator: torch.Generator | None = None, weighted: bool = True,
                 deterministic: bool = False, draws=None, mesh=None):
        inputs = (beta, gamma, draws)
        ring = (buf.x, buf.y, buf.force, buf.pos, buf.size)
        spec = (statics, weighted, deterministic, id(buf), _spec(ring), id(generator),
                _spec(inputs), mesh)

        def key():
            return spec, module_key(model), optimizer_key(opt), _addresses(ring)

        def body(st):
            kw = dict(generator=generator, weighted=weighted, deterministic=deterministic,
                      draws=st[2])
            if mesh is None:
                return train_call(statics, model, opt, buf, st[0], st[1], **kw)
            from ..parallel.train import dp_train_call
            return dp_train_call(statics, mesh, model, opt, buf, st[0], st[1], **kw)

        return self._call(key, inputs, body, [] if generator is None else [generator])


class PlannerGraph(_CapturedCall):
    """``KlergPlanner.plan`` as a captured graph, its draws included.
    Staged: the planner state but its generator (the plan, the measured
    state, the visited-state ring, the limits, the barrier), the target
    context's tensors (the model's target state) and fed ``samples`` /
    ``hist_idx``. Read in place and keyed by address: the model's
    parameters and buffers, the planner's own tensors (its limits and
    kernel widths, which ``init_state`` may set anew). Keyed by value:
    ``temp`` and ``use_prior``.
    Registered: the planner state's generator. Returns (pstate, info) as
    ``plan`` does: the new plan and rollout and every info tensor cloned,
    the rest of the state the caller's own."""

    def __call__(self, planner, pstate, pdf_ctx, temp: float = 1.0,
                 use_prior: bool = False, samples=None, hist_idx=None):
        gen = pstate.gen
        inputs = (dataclasses.replace(pstate, gen=None), pdf_ctx, samples, hist_idx)
        modules = [x for x in (pdf_ctx if isinstance(pdf_ctx, tuple) else (pdf_ctx,))
                   if isinstance(x, nn.Module)]
        spec = (id(planner), float(temp), bool(use_prior), id(gen), _spec(inputs))

        def key():
            return (spec, tuple(module_key(m) for m in modules),
                    _addresses(v for v in vars(planner).values() if isinstance(v, torch.Tensor)))

        def body(st):
            return planner.plan(dataclasses.replace(st[0], gen=gen), st[1], temp=temp,
                                use_prior=use_prior, samples=st[2], hist_idx=st[3])

        return self._call(key, inputs, body, [gen])


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
      generators, the carry's structure); when it changes, every graph is
      dropped. It is read again after an eager step, which may create what
      it holds (the optimizer's moments);
    - ``pattern`` keys the host values the step branches on (which trainer
      calls run, ...); with the fed draws' structure it picks the graph. A
      pattern's first step runs eagerly, its second captures and replays,
      later ones replay;
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
    replays, as in ``_CapturedCall``. Every graph takes its memory from
    ``pool`` (a ``torch.cuda.MemPool``, which other steps' graphs may
    share); nothing allocated there outlives a replay but the graphs'
    outputs, which are cloned out at once. The ``MemPool`` object keeps the
    pool alive while its graphs are dropped and captured anew: the caching
    allocator refuses a capture into a graph pool whose last graph is gone
    and whose memory it has not yet released."""

    def __init__(self, graph_type=CudaGraph, pool=None):
        self.graph_type, self.pool = graph_type, pool
        self.base = self.carry = None
        self.entries: dict = {}
        self.warm: set = set()
        self.counts: dict = {}
        self.capture_seconds: dict = {}
        self.launched = dict.fromkeys(KERNELS, 0)
        self.warmups = self.captures = self.replays = 0

    def _rebase(self, base) -> None:
        """Drop every graph (and the static carry) when the base changes."""
        if base != self.base:
            self.entries, self.warm, self.carry = {}, set(), None
            self.base = base

    def _count(self, pattern, i: int) -> None:
        self.counts.setdefault(pattern, [0, 0, 0])[i] += 1

    def step(self, base_fn, pattern, carry, draws, body, generators):
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
            _copy_into(self.carry, carry)
            _copy_into(entry.draws, draws)
        out = entry.graph.replay()
        self.replays += 1
        self._count(pattern, 2)
        _replayed(self.launched, entry.recorded)
        return self.carry, _clone(out)

    def _capture(self, key, carry, draws, body, generators) -> _Entry:
        if self.carry is None:
            self.carry = _clone(carry)
        else:
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
    frozen = copy.copy(state)

    def body(carry, draws):
        new, out = run(join(frozen, carry), draws)
        return split(new), out

    carry, out = graph.step(lambda: base(state, carry), pattern, carry, draws, body,
                            generators)
    return join(state, carry), out
