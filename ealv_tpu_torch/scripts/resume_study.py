"""Mid-run kill and resume study with the PyTorch port (port of
``scripts/resume_study.py``): SIGKILL an exploration run, resume it, and
check that the continuation is bit-equal to an uninterrupted run.

The property shown: a checkpoint holds the whole ``ExperimentState``
(model, optimizer, replay ring, planner, env, schedules and every
generator's state; ``runtime/checkpoint.py``), written atomically, so a
``kill -9`` at any step loses nothing past the last checkpoint, and the
resumed run replays the rest exactly.

Protocol
  A (control)    : the run entry with --steps S, straight through.
  B (interrupted): the same command, SIGKILLed once log.txt shows a progress
                   line at step >= --kill-step and a checkpoint is on disk;
                   then run again with --resume (from the latest checkpoint,
                   which must lie before the run's last step).
  Check          : every leaf of the two final checkpoints is bit-equal.

--save-rate must be a multiple of --chunk, so that A and B run the same
chunks from the resume step on.

    python -m ealv_tpu_torch.scripts.resume_study --small --steps 100
    python -m ealv_tpu_torch.scripts.resume_study --small --device cpu --steps 8 --chunk 2 --save-rate 4
"""

from __future__ import annotations

import argparse
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import torch

from ..runtime.checkpoint import latest_checkpoint
from .batch_tests import ROOT


def _run_dir(out, method, seed):
    return os.path.join(out, "synth", f"{method}_{seed:04d}")


def _progress_step(log_path) -> int:
    """Largest exploration step in the run log's progress lines."""
    best = -1
    if not os.path.exists(log_path):
        return best
    with open(log_path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 4 and parts[0].isdigit() and "|" in line:
                best = max(best, int(parts[0]))
    return best


def _checkpoint_step(run_dir) -> int | None:
    """Step of the run dir's latest step checkpoint, if any."""
    ck = latest_checkpoint(os.path.join(run_dir, "checkpoints"))
    return None if ck is None else int(os.path.basename(ck)[len("step_"):])


def launch(cmd, log_path, kill_at=None, timeout=3600.0) -> str:
    """Run one experiment process; with ``kill_at``, SIGKILL it once its log
    reaches that step and its run dir holds a checkpoint (the progress line
    comes before the checkpoint of the same step). Returns "killed" or
    "completed"."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (ROOT, env.get("PYTHONPATH")) if p)
    with tempfile.TemporaryFile() as err:
        proc = subprocess.Popen(cmd, env=env, stdout=subprocess.DEVNULL, stderr=err)
        t0 = time.time()
        try:
            while proc.poll() is None:
                if (kill_at is not None and _progress_step(log_path) >= kill_at
                        and _checkpoint_step(os.path.dirname(log_path)) is not None):
                    proc.send_signal(signal.SIGKILL)  # no cleanup, no flush
                    proc.wait()
                    return "killed"
                if time.time() - t0 > timeout:
                    raise RuntimeError(f"timed out: {' '.join(cmd)}")
                time.sleep(0.05)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if proc.returncode != 0:
            err.seek(0)
            tail = err.read().decode(errors="replace")[-2000:]
            raise RuntimeError(f"run failed rc={proc.returncode}: {' '.join(cmd)}\n{tail}")
    if kill_at is not None:
        raise RuntimeError(f"run finished before reaching the kill step {kill_at}: "
                           "raise --steps or lower --kill-step")
    return "completed"


def _leaves(tree, path="state"):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def _same_bits(a, b) -> bool:
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        if not (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)):
            return False
        if a.shape != b.shape or a.dtype != b.dtype:
            return False
        if a.is_floating_point():  # NaN where both are NaN counts as equal
            return bool(((a == b) | (a.isnan() & b.isnan())).all())
        return torch.equal(a, b)
    return a == b


def compare_final(dir_a, dir_b) -> int:
    """Bit-compare the final step checkpoints of two run dirs; raises
    ``SystemExit`` naming the leaves that differ. Returns the leaf count."""
    ck_a = latest_checkpoint(os.path.join(dir_a, "checkpoints"))
    ck_b = latest_checkpoint(os.path.join(dir_b, "checkpoints"))
    print(f"control  final: {ck_a}\nresumed  final: {ck_b}")
    if ck_a is None or ck_b is None or os.path.basename(ck_a) != os.path.basename(ck_b):
        raise SystemExit(f"FINAL STEPS DIFFER: {ck_a} vs {ck_b}")
    # both files were written by the run entry's save_checkpoint
    tree_a = torch.load(ck_a, map_location="cpu", weights_only=True)
    tree_b = torch.load(ck_b, map_location="cpu", weights_only=True)
    leaves_a, leaves_b = list(_leaves(tree_a)), list(_leaves(tree_b))
    if [p for p, _ in leaves_a] != [p for p, _ in leaves_b]:
        raise SystemExit("the two checkpoints hold different leaves")
    bad = []
    for (path, a), (_, b) in zip(leaves_a, leaves_b):
        if not _same_bits(a, b):
            d = (float((a.double() - b.double()).abs().max())
                 if isinstance(a, torch.Tensor) and a.shape == b.shape else float("nan"))
            bad.append((path, d))
    print(f"compared {len(leaves_a)} leaves")
    if bad:
        for path, d in bad[:20]:
            print(f"  MISMATCH {path}: max|delta|={d:.3e}")
        raise SystemExit(f"{len(bad)} leaves differ: the resume is NOT bit-equal")
    print("ALL LEAVES BIT-EQUAL: kill -9 + --resume reproduced the uninterrupted run exactly")
    return len(leaves_a)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m ealv_tpu_torch.scripts.resume_study",
                                 description="Kill a run, resume it, compare bit for bit.")
    ap.add_argument("--method", default="entklerg")
    ap.add_argument("--backend", default=None, choices=["free", "arm"])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chunk", type=int, default=25)
    ap.add_argument("--save-rate", type=int, default=50,
                    help="checkpoint cadence (a multiple of --chunk)")
    ap.add_argument("--kill-step", type=int, default=None,
                    help="SIGKILL once the log shows this step (default: about 40%% of "
                         "--steps, past at least one checkpoint)")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--device", default="cuda", help="torch device of the runs")
    ap.add_argument("--out", default=os.path.join("runs", "resume_study"))
    ap.add_argument("--keep", action="store_true",
                    help="keep the run dirs (several GB at production size)")
    return ap


def main(argv=None) -> int:
    """Runs the study; returns the number of leaves compared."""
    args = build_parser().parse_args(argv)
    if args.save_rate % args.chunk:
        raise SystemExit("--save-rate must be a multiple of --chunk "
                         "(checkpoints land between chunks)")
    kill_at = args.kill_step or max(args.save_rate,
                                    (args.steps * 2 // 5) // args.chunk * args.chunk)
    base = [sys.executable, "-m", "ealv_tpu_torch.scripts.run_experiment",
            "--method", args.method, "--steps", str(args.steps), "--seed", str(args.seed),
            "--chunk", str(args.chunk), "--save-rate", str(args.save_rate),
            "--device", args.device]
    if args.backend:
        base += ["--backend", args.backend]
    if args.small:
        base += ["--small"]

    out_a = os.path.join(args.out, "control")
    out_b = os.path.join(args.out, "interrupted")
    dir_a = _run_dir(out_a, args.method, args.seed)
    dir_b = _run_dir(out_b, args.method, args.seed)
    shutil.rmtree(out_a, ignore_errors=True)
    shutil.rmtree(out_b, ignore_errors=True)

    print(f"[1/3] control run: {args.steps} steps")
    launch(base + ["--out", out_a], os.path.join(dir_a, "log.txt"))
    print(f"[2/3] interrupted run: SIGKILL at step >= {kill_at}")
    state = launch(base + ["--out", out_b], os.path.join(dir_b, "log.txt"), kill_at=kill_at)
    ck_step = _checkpoint_step(dir_b)
    print(f"      {state} at step ~{_progress_step(os.path.join(dir_b, 'log.txt'))}; "
          f"latest checkpoint at step {ck_step}; resuming")
    if not 0 < ck_step < args.steps:
        raise SystemExit(f"the interrupted run's latest checkpoint is at step {ck_step}: "
                         f"--resume would not replay exploration steps (raise --steps)")
    launch(base + ["--out", out_b, "--resume"], os.path.join(dir_b, "log.txt"))
    print("[3/3] comparing final checkpoints")
    n = compare_final(dir_a, dir_b)
    if not args.keep:
        shutil.rmtree(args.out, ignore_errors=True)
    return n


if __name__ == "__main__":
    main()
