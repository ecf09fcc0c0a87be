"""The numbers that decide ``correct``: how far what the program's timed
ticks produced lies from what the reference recomputes from the same
state and the same draws. Each is the widest over the compared ticks
(``latent_median``: the median).

- ``cost``: the plan's ergodic cost, |program - reference| / |reference|;
- ``plan``: the planned controls, the largest absolute gap;
- ``state``: the robot state after the env step (robot coordinates, each
  in [-1, 1] or its velocity limits), the largest absolute gap;
- ``image``: the camera image the tick pushed (the learning loop's ring
  row, stored in the compute dtype) or returned, the largest absolute
  pixel gap (pixels in [0, 1]);
- ``latent``: the reseeded target latent z, the largest absolute gap of
  a component (z is in units of the prior's standard deviation);
  ``latent_rel``: |gap| / |reference|; ``latent_median``: the median of
  ``latent_rel`` over the compared ticks, where the widest swings with
  one tick whose z is small or whose encoder sits at a ReLU's kink;
- ``loss``: the trainer call's last loss, the absolute gap;
- ``beta``, ``gamma``: the weights the trainer call gave the KL and the
  cross-decode terms (the entropy grade and the coverage spread of the
  tick's planner), |program - reference| / |reference|;
- ``params``: each parameter's change over the trainer call, the gap of
  the two changes' norms over the larger of the reference's change norm
  and the median leaf's; the median leaf (``params_worst``: the worst);
- ``moments``: Adam's first moment after the call, measured as ``params``
  (``moments_worst``);
- ``params_total``: the change of all the parameters together over the
  call, |program's norm - reference's| / reference's;
- ``grad_sq``: the call's squared gradients as Adam took them in, worked
  out from its second moment: v_after - beta2^n v_before, the weighted sum
  of the n steps' squared gradients; measured as ``params``. Half of a
  batch left out doubles the gradient noise this sums.

The harness adds ``start``: the largest gap between the weights the
program started from and those the reference draws from the seed (the
start that the step-by-step comparison takes from the program; exact).
The reference steps the env with the program's plan (``reference/tick.py``,
``explore``), so ``state``, ``image`` and what follows check the stages
after the planner by themselves. ``params`` and ``moments`` leave out the
leaves whose first-step gradient in the reference is under a thousandth
of the median leaf's: their update is Adam's normalisation of round-off.
A trainer call is 25 Adam steps of a chaotic descent: a last-place
difference in its inputs grows into percents. The reference computes in
the configuration's precision and takes the planner's coverage spread in
K1's arithmetic, so that a sound call comes out in the same bits and a
fault stands far above it (PERF.md §4); the cells compare ``loss`` and
``params_worst`` and read the rest.
"""

from __future__ import annotations

import torch

NEGLIGIBLE_GRAD = 1e-3  # of the median leaf's gradient norm
BETA2 = 0.999  # Adam's second-moment decay (torch.optim.Adam's default)


def _leaf_gaps(prog: dict, ref: dict, base: dict | None, keep) -> list:
    def norm(d, n):
        x = d[n].float() - (base[n].float() if base is not None else 0.0)
        return float(torch.linalg.vector_norm(x))

    r = {n: norm(ref, n) for n in keep}
    med = float(torch.tensor(list(r.values())).median())
    return [abs(norm(prog, n) - r[n]) / max(r[n], med, 1e-30) for n in keep]


def _total_gap(prog: dict, ref: dict, base: dict) -> float:
    def norm(d):
        return float(torch.linalg.vector_norm(torch.cat(
            [(d[n].float() - base[n].float()).reshape(-1) for n in base])))

    r = norm(ref)
    return abs(norm(prog) - r) / max(r, 1e-30)


def _median(values) -> float:
    return float(torch.tensor(values).median())


def tick_gaps(prog: dict, ref: dict, snap: dict) -> dict:
    """The gaps of one tick."""
    rel = lambda a, b: float((a.float() - b.float()).abs().max()
                             / b.float().abs().max().clamp(min=1e-30))
    absmax = lambda a, b: float((a.float() - b.float()).abs().max())
    out = dict(cost=rel(prog["cost"], ref["cost"]),
               state=absmax(prog["robot_state"], ref["robot_state"]),
               image=absmax(prog["image"], ref["image"]),
               plan=absmax(prog["u"], ref["u"]))
    if "z" in prog:
        out["latent"] = absmax(prog["z"], ref["z"])
        out["latent_rel"] = float(torch.linalg.vector_norm(prog["z"].float() - ref["z"].float())
                                  / torch.linalg.vector_norm(ref["z"].float()).clamp(min=1e-30))
    if prog.get("trained"):
        g = {n: float(torch.linalg.vector_norm(v)) for n, v in ref["grad0"].items()}
        med = float(torch.tensor(list(g.values())).median())
        keep = [n for n, v in g.items() if v >= NEGLIGIBLE_GRAD * med]
        params = _leaf_gaps(prog["params"], ref["params"], snap["params"], keep)
        moments = _leaf_gaps(prog["exp_avg"], ref["exp_avg"], None, keep)
        decayed = {n: v * BETA2 ** len(ref["losses"]) for n, v in snap["exp_avg_sq"].items()}
        grad_sq = _leaf_gaps(prog["exp_avg_sq"], ref["exp_avg_sq"], decayed, keep)
        out.update(loss=absmax(prog["loss"], ref["losses"][-1]),
                   beta=rel(prog["beta"], ref["beta"]), gamma=rel(prog["gamma"], ref["gamma"]),
                   params=_median(params), params_worst=max(params),
                   moments=_median(moments), moments_worst=max(moments),
                   grad_sq=_median(grad_sq),
                   params_total=_total_gap(prog["params"], ref["params"], snap["params"]))
    return out


def widest(per_tick: list) -> dict:
    """Each number's widest reading over the compared ticks, and
    ``latent_median``."""
    out = {}
    for gaps in per_tick:
        for k, v in gaps.items():
            v = v if v == v else float("inf")  # a NaN gap fails
            out[k] = max(out.get(k, v), v)
    rel = [g["latent_rel"] for g in per_tick if "latent_rel" in g]
    if rel:
        out["latent_median"] = _median([v if v == v else float("inf") for v in rel])
    return out
