"""Multi-seed K=3 re-localization study with the PyTorch port (port of
``scripts/k3_study.py``): the 3-object fingerprint matrix at three
belief-target modes x N seeds, and the per-object localization errors
aggregated over the seeds.

  raw     --target-sharpness 1.0    the raw low-contrast belief target
  fixed   (default sharpness 20)    the sharpened belief of one fixed object
  active  --seek-mode uncertain     the sharpened belief of the least
                                    localized object, re-chosen every step

    python -m ealv_tpu_torch.scripts.k3_study                 # 3 seeds x 3 modes
    python -m ealv_tpu_torch.scripts.k3_study --seeds 0 1 2 --out runs/k3study
    python -m ealv_tpu_torch.scripts.k3_study --parse-only    # re-aggregate the logs

Each run is ``python -m ealv_tpu_torch.scripts.run_fingerprint_matrix`` in
a child process; its output lands in <out>/s<seed>_<mode>/log.txt, and the
aggregate in <out>/summary.md and <out>/summary.json. A run that failed or
printed no table is named in the summary, and the invocation exits 1.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PY = sys.executable

MODES = {
    "raw": ["--target-sharpness", "1.0"],
    "fixed": [],
    "active": ["--seek-mode", "uncertain"],
}
METHODS = ("L2", "KL", "BC", "L2_error")


def run_one(seed: int, mode: str, out: str, small: bool, learn_steps: int, id_steps: int,
            objects: int = 3, device: str = "cuda") -> int:
    os.makedirs(out, exist_ok=True)
    cmd = [PY, "-m", "ealv_tpu_torch.scripts.run_fingerprint_matrix",
           "--objects", str(objects), "--learn-steps", str(learn_steps),
           "--id-steps", str(id_steps), "--seed", str(seed), "--out", out,
           "--device", device] + MODES[mode] + (["--small"] if small else [])
    with open(os.path.join(out, "log.txt"), "w") as f:
        f.write("+ " + " ".join(cmd) + "\n")
        f.flush()
        return subprocess.call(cmd, stdout=f, stderr=subprocess.STDOUT, cwd=REPO)


def parse_log(path: str):
    """-> {method: [err_obj0, err_obj1, ...], 'seek_share': [...]}, or None."""
    if not os.path.exists(path):
        return None
    res = {}
    for line in open(path):
        m = re.match(r"\| (\w+) \| ([\d., ]+) \| ([\d.]+) \|", line)
        if m and m.group(1) in METHODS:
            res[m.group(1)] = [float(x) for x in m.group(2).split(",")]
        m = re.search(r"seek-target share per object.*: \[([\d., ]+)\]", line)
        if m:
            res["seek_share"] = [float(x) for x in m.group(1).split(",")]
    return res or None


def aggregate(out_root: str, seeds, modes=tuple(MODES)):
    runs = {}
    for mode in modes:
        for seed in seeds:
            parsed = parse_log(os.path.join(out_root, f"s{seed}_{mode}", "log.txt"))
            if parsed:
                runs[(mode, seed)] = parsed
    summary = {}
    for mode in modes:
        per_method = {}
        for method in METHODS:
            tables = [runs[(mode, s)][method] for s in seeds
                      if (mode, s) in runs and method in runs[(mode, s)]]
            if not tables:
                continue
            worsts = [max(tb) for tb in tables]
            per_method[method] = {
                "per_seed": tables,
                "mean_error": sum(sum(tb) / len(tb) for tb in tables) / len(tables),
                "worst_object_mean": sum(worsts) / len(worsts),
                "worst_object_max": max(worsts),
            }
        if per_method:
            summary[mode] = per_method
    return runs, summary


def render(summary, seeds, objects: int = 3, missing=()) -> str:
    lines = [f"# K={objects} belief-target study (seeds {', '.join(map(str, seeds))})", ""]
    if missing:
        lines += ["**INCOMPLETE** — the following runs failed or produced no "
                  "parseable table and are ABSENT from every aggregate below: "
                  + ", ".join(f"s{s}_{m}" for m, s in missing) + ".", ""]
    lines += [
        "Aggregates across seeds; `worst` = the least-localized object's "
        "error (the reference's multi-object failure mode), `mean` = "
        f"mean over the {objects} objects.",
        "",
        "| mode | method | mean err (avg over seeds) | "
        "worst-object err (avg) | worst-object err (max) |",
        "|---|---|---|---|---|",
    ]
    for mode, per_method in summary.items():
        for method, st in per_method.items():
            lines.append(f"| {mode} | {method} | {st['mean_error']:.3f} "
                         f"| {st['worst_object_mean']:.3f} | {st['worst_object_max']:.3f} |")
    return "\n".join(lines) + "\n"


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m ealv_tpu_torch.scripts.k3_study",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--modes", nargs="+", default=list(MODES), choices=list(MODES))
    ap.add_argument("--out", default=os.path.join(REPO, "runs", "k3study"))
    ap.add_argument("--learn-steps", type=int, default=800)
    ap.add_argument("--id-steps", type=int, default=500)
    ap.add_argument("--objects", type=int, default=3, help="object count K")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--device", default="cuda", help="torch device of the runs")
    ap.add_argument("--parse-only", action="store_true",
                    help="aggregate existing <out>/s<seed>_<mode>/log.txt without running")
    args = ap.parse_args(argv)

    if not args.parse_only:
        for seed in args.seeds:
            for mode in args.modes:
                out = os.path.join(args.out, f"s{seed}_{mode}")
                print(f"=== seed {seed} mode {mode} -> {out}", flush=True)
                rc = run_one(seed, mode, out, args.small, args.learn_steps, args.id_steps,
                             objects=args.objects, device=args.device)
                if rc != 0:
                    print(f"    rc={rc} (see {out}/log.txt)", flush=True)

    runs, summary = aggregate(args.out, args.seeds, args.modes)
    missing = [(m, s) for m in args.modes for s in args.seeds if (m, s) not in runs]
    md = render(summary, args.seeds, objects=args.objects, missing=missing)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "summary.md"), "w") as f:
        f.write(md)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump({"runs": {f"{m}_s{s}": v for (m, s), v in runs.items()},
                   "summary": summary, "missing": [f"s{s}_{m}" for m, s in missing]},
                  f, indent=1)
    print(md)
    print(f"summary -> {args.out}/summary.md")
    if missing:
        print(f"ERROR: {len(missing)} run(s) missing from the aggregate", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
