"""The one traffic generator: it builds the program's entry that a traffic
file names and drives it tick by tick.

A traffic file (``traffic/<name>.json``) holds only parameters:

- ``entry``: the module ``port_bench/entries/<entry>.py`` whose ``Entry``
  builds and drives one of the program's entries (``learn``:
  ``Experiment.tick``, explore and learn; ``eval``:
  ``EvalExperiment.tick`` toward a frozen CVAE). A new entry is a new
  module there; no file that exists is edited;
- ``chunk``: ticks between two reads of the chunk's infos to the host;
- ``settle``: warm ticks in a row that must capture nothing before the
  window opens;
- ``compare``: how many of the window's first ``within`` ticks are drawn
  from the seed for the comparison with the reference, and how many of
  them, at least, make a trainer call;
- whatever else its entry reads (``learn``: the trainer throttle's
  ``train_calls_per_tick`` and ``train_every``).

Every draw the timed ticks make comes from the program's own generators,
seeded from ``--seed`` by the entry's ``init``. An ``Entry`` also copies
the state before a tick (``snapshot``), reads what the tick produced
(``outputs``) and has the reference recompute it (``recompute``). An
entry that brings work of its own says so through three hooks, whose
defaults are the explore and learn ticks': ``extra_gaps`` (its own
compared numbers, which a limits file can then name), ``tick_flops`` (a
tick's model FLOPs) and ``k1_launches`` (the K1 launches of a tick).
"""

from __future__ import annotations

import importlib

import torch

from . import counts
from .reference import config as ref_config
from .reference import cvae as ref_cvae
from .reference.tick import Tick


def _tuples(d: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def program_config(cfg: dict):
    from ealv_tpu_torch.utils.config import ExperimentConfig
    return ExperimentConfig(**_tuples(cfg))


def reference_config(cfg: dict):
    return ref_config.ExperimentConfig(**_tuples(cfg))


def params(model) -> dict:
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def planner_snapshot(pstate) -> dict:
    mem = pstate.memory
    return dict(u=pstate.u.clone(), dyn_x=pstate.dyn.x.clone(), dyn_R=pstate.dyn.R.clone(),
                mem_buf=mem.buf.clone(), mem_pos=mem.pos.clone(), mem_size=mem.size.clone(),
                lims=pstate.lims.clone(), last_plan=pstate.last_plan.clone(),
                planner_gen=pstate.gen.get_state())


def env_snapshot(env) -> dict:
    return dict(pose=env.pose.clone(), vel=env.vel.clone(), brightness=env.brightness.clone())


class Driver:
    """A program entry under one traffic file on ``device``. An entry sets
    ``exp``, ``graph`` (its step graph, or None) and ``start`` (the
    weights it started from) and defines the tick and its comparison."""

    learning: bool
    checked: tuple  # the infos read back at each chunk's end, each finite

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg_dict, self.traffic, self.seed = cfg, traffic, seed
        self.cfg = program_config(cfg)
        self.device = torch.device(device)
        self.trained = False  # whether the last tick made a trainer call

    def settled_count(self) -> int:
        """Warm-ups and captures the tick graph has made (0 without one)."""
        g = self.graph
        return 0 if g is None else g.warmups + g.captures

    def start_gap(self, tick: Tick) -> float:
        """The largest gap between the weights the program started from
        (``start``, copied at set-up) and those the reference draws from
        the seed: the start that the step-by-step comparison takes from
        the program, checked by itself."""
        ref = dict(tick.make_model(self.seed).named_parameters())
        return max(float((p.float() - ref[n].detach().float()).abs().max())
                   for n, p in self.start.items())

    def reference(self, cast=None, ring_cast=None, half_batch: bool = False,
                  stuck: bool = False) -> Tick:
        """The reference tick, its products and ring in the compute dtype
        the configuration states unless ``cast`` and ``ring_cast`` put it
        in another; ``half_batch`` and ``stuck`` plant those faults."""
        stated = ref_cvae.CASTS[self.cfg_dict["compute_dtype"]]
        return Tick(reference_config(self.cfg_dict), self.device, self.learning,
                    cast or stated, ring_cast or stated, half_batch, stuck)

    def will_train(self) -> bool:
        return False

    def ring_images(self):
        """The images the reference reads from the program's ring once the
        window has closed (None where the entry keeps none)."""
        return None

    def target(self, tick: Tick):
        """What every recomputed tick of a run shares (None: nothing)."""
        return None

    def extra_gaps(self, prog: dict, ref: dict, snap: dict) -> dict:
        """The entry's own compared numbers at one tick, from what the
        program (or a control in its place) produced, ``prog``, against the
        reference's recomputation ``ref`` of the tick after ``snap``:
        {name: gap}, merged into the tick's ``compare.tick_gaps``. Empty by
        default."""
        return {}

    def tick_flops(self, trained: bool) -> int:
        """The model FLOPs of one tick, ``trained`` where it made a trainer
        call."""
        return counts.tick_flops(self.cfg_dict, self.learning, trained)

    def k1_launches(self, fill: int) -> list:
        """(n, t, d, unmasked) of each K1 launch of a tick whose history
        holds ``fill`` points (``counts.k1_bound_s`` takes each)."""
        return counts.k1_tick_launches(self.cfg_dict, self.learning, fill)


def entry(traffic: dict) -> type:
    """The ``Entry`` class of the module the traffic file names."""
    return importlib.import_module(f"port_bench.entries.{traffic['entry']}").Entry


def make(cfg: dict, traffic: dict, seed: int, device) -> Driver:
    return entry(traffic)(cfg, traffic, seed, device)
