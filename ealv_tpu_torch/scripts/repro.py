"""One-command regeneration of the published PARITY tables with the
PyTorch port (port of ``scripts/repro.py``).

Each table name maps to a pinned-seed invocation of one of the port's
CLIs; outputs (the stdout log and whatever the CLI writes) land under
``runs/repro/<table>/``. Regenerate one table or all of them:

    python -m ealv_tpu_torch.scripts.repro --list
    python -m ealv_tpu_torch.scripts.repro planner     # PARITY section 2
    python -m ealv_tpu_torch.scripts.repro arm-s0 arm-s1 arm-s2
    python -m ealv_tpu_torch.scripts.repro --device cpu --small matrix

The registry is the JAX script's, argument for argument, with
``python -m ealv_tpu_torch.scripts.<cli>`` in place of ``scripts/<cli>.py``;
every table also passes ``--device`` (default ``cuda``; nothing falls back
to the CPU). ``planner`` runs the port's planner alone on the reference
demo's spec and writes its rows beside the published rows of
``docs/studies/planner/planner_table.md``. ``bench`` raises: the port has
no bench yet. ``soak`` drops ``--dash-every`` where matplotlib is missing
(the run entry refuses the flag there) and says so.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PY = sys.executable
PUBLISHED_PLANNER = os.path.join(REPO, "docs", "studies", "planner", "planner_table.md")


def _sub(cli, *args):
    return [PY, "-m", f"ealv_tpu_torch.scripts.{cli}", *map(str, args)]


TABLES = {
    "matrix": {
        "doc": "PARITY 5: method matrix, 600 learn / 300 id steps, seed 0",
        "cmd": _sub("run_fingerprint_matrix", "--learn-steps", 600,
                    "--id-steps", 300, "--seed", 0),
        "out": True,
        "small_ok": True,
    },
    "matrix1000": {
        "doc": "PARITY 5: reference-length 1000-step identification, seed 0",
        "cmd": _sub("run_fingerprint_matrix", "--learn-steps", 600,
                    "--id-steps", 1000, "--seed", 0),
        "out": True,
        "small_ok": True,
    },
    "k3": {
        "doc": "PARITY 6: K=3 multi-object, 800 learn / 500 id, seed 0",
        "cmd": _sub("run_fingerprint_matrix", "--objects", 3,
                    "--learn-steps", 800, "--id-steps", 500, "--seed", 0),
        "out": True,
        "small_ok": True,
    },
    "k3-active": {
        "doc": "PARITY 6: K=3 with uncertainty-targeted re-localization",
        "cmd": _sub("run_fingerprint_matrix", "--objects", 3,
                    "--learn-steps", 800, "--id-steps", 500, "--seed", 0,
                    "--seek-mode", "uncertain"),
        "out": True,
        "small_ok": True,
    },
    "k3-raw": {
        "doc": "PARITY 6: K=3 with the reference's raw (unsharpened) belief "
               "target — the target-blind baseline both stacks share",
        "cmd": _sub("run_fingerprint_matrix", "--objects", 3,
                    "--learn-steps", 800, "--id-steps", 500, "--seed", 0,
                    "--target-sharpness", 1.0),
        "out": True,
        "small_ok": True,
    },
    "k3-study": {
        "doc": "PARITY 6: 3-seed x 3-mode (raw/fixed/active) K=3 "
               "aggregate study; writes summary.md/json",
        "cmd": _sub("k3_study"),
        "out": True,
        "small_ok": True,
    },
    "k4": {
        "doc": "PARITY 6: K=4 multi-object, 800 learn / 500 id, seed 0",
        "cmd": _sub("run_fingerprint_matrix", "--objects", 4,
                    "--learn-steps", 800, "--id-steps", 500, "--seed", 0),
        "out": True,
        "small_ok": True,
    },
    "force": {
        "doc": "PARITY 4: force-learning end-to-end, 1200 steps, seed 0",
        "cmd": _sub("force_study", "--steps", 1200, "--seed", 0),
    },
    "force-dynamic": {
        "doc": "PARITY 4: force learning on the penalty-contact arm plant "
               "(contact force from simulated mechanics, franka_env.py "
               ":268-284 parity), 1200 steps, seed 0",
        "cmd": _sub("force_study", "--steps", 1200, "--seed", 0,
                    "--backend", "arm-dynamic"),
    },
    "force-soft": {
        "doc": "PARITY 4: force learning on the soft-object arm plant "
               "(compliant saturating contact, the loadSoftBody variant "
               "franka_env.py:160-162), 1200 steps, seed 0",
        "cmd": _sub("force_study", "--steps", 1200, "--seed", 0,
                    "--backend", "arm-dynamic-soft"),
    },
    "resume": {
        "doc": "SURVEY 5 beat: SIGKILL the flagship arm run mid-exploration, "
               "--resume from the pytree checkpoint, assert the continuation "
               "is bit-identical to an uninterrupted control run",
        "cmd": _sub("resume_study", "--backend", "arm", "--steps", 200,
                    "--save-rate", 50),
    },
    "bench": {
        "doc": "README headline: explore+learn step rate (the port's bench "
               "is ROADMAP.md item 11b, not written yet)",
        "cmd": None,
    },
    "soak": {
        "doc": "reference-length soak: 3000 steps + clustering + post-train "
               "+ periodic checkpoints on the arm backend",
        "cmd": _sub("run_experiment", "--steps", 3000, "--seed", 0,
                    "--backend", "arm", "--post-train", "--save-rate", 500,
                    "--cluster-every", 200, "--dash-every", 500),
        "out": True,
        "small_ok": True,
    },
}
# arm flagship study: three pinned seeds (PARITY 7 rows)
for s in (0, 1, 2):
    TABLES[f"arm-s{s}"] = {
        "doc": f"PARITY 7: arm-backend flagship study, seed {s}",
        "cmd": _sub("run_fingerprint_matrix", "--objects", 2,
                    "--backend", "arm", "--host-loop",
                    "--learn-steps", 800, "--id-steps", 1000, "--seed", s),
        "out": True,
        "small_ok": True,
    }


def _has_matplotlib() -> bool:
    return importlib.util.find_spec("matplotlib") is not None


def _planner_metrics(path, wall, n):
    """The published table's coverage metrics of an explored path (n, 4):
    late-x mean (second half), frac(x < 0), y-std, steps/s."""
    late = path[n // 2:]
    return {"late_x": float(late[:, 0].mean()),
            "frac_x_neg": float((path[:, 0] < 0).mean()),
            "y_std": float(path[:, 1].std()),
            "steps_per_s": n / wall}


def _published_planner_rows():
    """(impl, seed, metrics) of the published table's per-seed rows; its
    steps/s were measured on a TPU (ealv) and a CPU (torch) and stay as
    printed, for the record only."""
    rows = []
    with open(PUBLISHED_PLANNER) as f:
        for line in f:
            cells = [c.strip() for c in line.strip().strip("|").split("|")]
            if len(cells) != 6 or not cells[0].isdigit():
                continue
            rows.append((cells[1], int(cells[0]), {
                "late_x": float(cells[2]), "frac_x_neg": float(cells[3]),
                "y_std": float(cells[4]), "steps_per_s": float(cells[5])}))
    return rows


def planner_table(rows) -> str:
    """The published table's layout: one row per (seed, impl), then one
    mean±std row per implementation."""
    lines = ["| seed | impl | late-x mean | frac(x<0) | y-std | steps/s |",
             "|---|---|---|---|---|---|"]
    for impl, seed, m in sorted(rows, key=lambda r: (r[1], r[0])):
        lines.append(f"| {seed} | {impl} | {m['late_x']:.3f} | "
                     f"{m['frac_x_neg']:.2f} | {m['y_std']:.2f} | "
                     f"{m['steps_per_s']:.1f} |")
    for impl in dict.fromkeys(r[0] for r in rows):
        ms = [m for i, _, m in rows if i == impl]
        lx, fx, ys = (np.array([m[k] for m in ms]) for k in ("late_x", "frac_x_neg", "y_std"))
        lines.append(f"| mean±std ({len(ms)} seeds) | {impl} | "
                     f"{lx.mean():.3f}±{lx.std():.3f} | {fx.mean():.2f}±{fx.std():.2f} "
                     f"| {ys.mean():.2f}±{ys.std():.2f} | |")
    return "\n".join(lines)


def planner_study(seeds=tuple(range(10)), steps=300, out_dir=None, device="cuda",
                  num_target_samples=1500, num_traj_samples=1000):
    """PARITY section 2 with the port's planner: the reference's own demo
    spec (klerg.py:754-843) - states 'xyXY', the double integrator at
    dt 0.1, the Roll policy, horizon 10, R = 0.05, 1500 target x 1000
    trajectory samples, the Gaussian target (-0.8, 0) with variances
    (0.06, 1, 0.5, 1), start (0.5, -0.5, 0, 0), explore limits x 1.15, a
    2000-slot memory - one warm step per seed outside the timing, then
    ``steps`` timed steps. Prints and returns (rows, table): the port's
    rows ("port") beside the published ones ("ealv", "torch")."""
    import torch

    from ..control import (KlergConfig, KlergPlanner, gaussian_dist, make_dynamics,
                           make_policy, setup_barrier)

    dev = torch.device(device)
    states = "xyXY"
    dyn = make_dynamics("xy", dt=0.1, device=dev)
    policy = make_policy("Roll", dyn, 10)
    cfg = KlergConfig(horizon=10, num_target_samples=num_target_samples,
                      num_traj_samples=num_traj_samples, R=0.05)
    planner = KlergPlanner(cfg, dyn, policy, lambda ctx, samples: ctx.pdf(samples), states,
                           explr_locs=list(range(4)), device=dev)
    robot_lim = torch.tensor([[-1.0, 1.0]] * 2 + [[-1.5, 1.5]] * 2, device=dev)
    barrier, _ = setup_barrier("xy", robot_lim[:2], torch.tensor([[-1.5, 1.5]] * 2, device=dev),
                               [0, 1], barr_weight=5.0)
    target = gaussian_dist([-0.8, 0.0, 0.9, 0.0], [0.06, 1.0, 0.5, 1.0], device=dev)
    x0 = torch.tensor([0.5, -0.5, 0.0, 0.0], device=dev)

    def init(seed):
        return planner.init_state(x0, robot_lim, barrier, buffer_capacity=2000,
                                  explr_lim_scale=1.15, seed=seed)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    rows = []
    for seed in seeds:
        planner.step(init(seed), target, save_update=True)  # warm, untimed
        ps = init(seed)
        sync()
        path = []
        t0 = time.perf_counter()
        for _ in range(steps):
            ps, state, _, _, _ = planner.step(ps, target, save_update=True)
            path.append(state)
        path = torch.stack(path).cpu().numpy()  # one copy, which waits for the device
        wall = time.perf_counter() - t0
        rows.append(("port", seed, _planner_metrics(path, wall, steps)))
    table = planner_table(rows + _published_planner_rows())
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"[repro] planner: {len(seeds)} seeds x {steps} steps, {num_target_samples} x "
          f"{num_traj_samples} samples; port steps/s on {where} (the published rows' "
          f"steps/s: ealv on a TPU, torch on a CPU)")
    print(table, flush=True)
    if out_dir:
        with open(os.path.join(out_dir, "planner_table.md"), "w") as f:
            f.write(table + "\n")
    return rows, table


def table_command(name: str, small: bool = False, device: str = "cuda", out_dir=None):
    """The command line of table ``name``: the registry's, then ``--out``
    where the table writes files, ``--small`` where it has a small variant
    and ``small`` asks for it, and ``--device``. ``soak`` drops
    ``--dash-every`` where matplotlib is missing. Returns (cmd, notes)."""
    spec = TABLES[name]
    if spec["cmd"] is None:
        raise NotImplementedError(
            f"{name}: the port has no bench yet (ROADMAP.md item 11b); the JAX bench.py "
            "times the TPU package")
    cmd, notes = list(spec["cmd"]), []
    if name == "soak" and not _has_matplotlib():
        i = cmd.index("--dash-every")
        notes.append(f"{name}: no matplotlib here, so the run entry would refuse "
                     f"{' '.join(cmd[i:i + 2])}; running the table without it")
        del cmd[i:i + 2]
    if spec.get("out"):
        cmd += ["--out", out_dir or os.path.join(REPO, "runs", "repro", name)]
    if small:
        if spec.get("small_ok"):
            cmd += ["--small"]
        else:
            notes.append(f"{name}: no --small variant; running at the pinned "
                         "(published) shapes")
    return cmd + ["--device", device], notes


def run_table(name: str, small: bool = False, device: str = "cuda", out_root=None) -> int:
    """Run one table into ``<out_root>/<name>/`` (default ``runs/repro``):
    ``planner`` in this process, the others as their CLI with the output
    on stdout and in ``log.txt``. Returns the exit code."""
    out_dir = os.path.join(out_root or os.path.join(REPO, "runs", "repro"), name)
    if name == "planner":
        os.makedirs(out_dir, exist_ok=True)
        planner_study(out_dir=out_dir, device=device)
        return 0
    cmd, notes = table_command(name, small, device, out_dir)
    os.makedirs(out_dir, exist_ok=True)
    for note in notes:
        print(f"[repro] {note}", flush=True)
    print(f"[repro] {name}: {' '.join(cmd)}", flush=True)
    log = os.path.join(out_dir, "log.txt")
    t0 = time.perf_counter()
    with open(log, "w") as f:
        p = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True, cwd=REPO)
        for line in p.stdout:
            sys.stdout.write(line)
            f.write(line)
        p.wait()
    print(f"[repro] {name}: rc={p.returncode} in {time.perf_counter() - t0:.1f} s, "
          f"log -> {log}", flush=True)
    return p.returncode


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m ealv_tpu_torch.scripts.repro",
                                 description="regenerate the published PARITY tables "
                                             "with the PyTorch port")
    ap.add_argument("tables", nargs="*", help="table name(s), or 'all' (see --list)")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--small", action="store_true",
                    help="pass --small to the studies that support it (small shapes; "
                         "values will differ from the published tables)")
    ap.add_argument("--device", default="cuda", help="torch device of every table")
    args = ap.parse_args(argv)

    names = ["planner"] + list(TABLES)
    if args.list or not args.tables:
        print("available tables:")
        print(f"  {'planner':12s} PARITY 2: seeds-matched planner study (the port's "
              f"planner beside the published rows)")
        for n, spec in TABLES.items():
            print(f"  {n:12s} {spec['doc']}")
        return 0
    chosen = args.tables
    if chosen == ["all"]:
        print("[repro] all: every table but bench, which the port does not have yet")
        chosen = [n for n in names if n != "bench"]
    for n in chosen:
        if n not in names:
            ap.error(f"unknown table {n!r}; --list shows the registry")
    rc = 0
    for n in chosen:
        rc |= run_table(n, small=args.small, device=args.device)
    return rc


if __name__ == "__main__":
    sys.exit(main())
