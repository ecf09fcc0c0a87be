"""Run a function on several ranks of one machine, one spawned process a
rank, over a gloo ``torch.distributed`` group: the harness of the
data-parallel tests and of the two-rank phase on one card (gloo, because
NCCL refuses two ranks on one device). The ranks meet through a
``FileStore`` in a temporary directory (no port to pick); each returns its
value through a file. A rank that fails stops the others, and a run that
outlasts its ``timeout`` is killed, so a hung collective fails its caller
instead of hanging it."""

from __future__ import annotations

import multiprocessing
import os
import tempfile
import time
import traceback

import torch
import torch.distributed as dist


def _rank_main(fn, rank, world_size, out_dir, threads, args):
    if threads:
        torch.set_num_threads(threads)
    result = {"error": None, "value": None}
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(os.path.join(out_dir, "store"), world_size),
            rank=rank, world_size=world_size)
        try:
            # Every rank has joined before any may leave: a rank that
            # destroys the group while a peer still connects its mesh makes
            # that peer fail with "Connection closed by peer".
            dist.barrier()
            result["value"] = fn(*args)
        finally:
            dist.destroy_process_group()
    except Exception:  # the rank's boundary: the parent reports it
        result["error"] = traceback.format_exc()
    tmp = os.path.join(out_dir, f".rank{rank}.tmp")
    torch.save(result, tmp)
    os.replace(tmp, os.path.join(out_dir, f"rank{rank}.pt"))
    if result["error"]:
        raise SystemExit(1)  # the parent stops the other ranks


def run_ranks(fn, world_size: int, args=(), timeout: float = 120.0,
              threads: int | None = 1):
    """``fn(*args)`` on ``world_size`` spawned ranks of a gloo group
    (``fn`` is pickled by its import path; it calls ``make_mesh`` itself).
    Each rank runs torch on ``threads`` threads (None: torch's default).
    Returns the ranks' values in rank order. Raises ``RuntimeError`` with a
    rank's traceback if it fails, ``TimeoutError`` if the ranks are not done
    after ``timeout`` seconds; every rank is stopped either way."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="ealv_ranks_") as tmp:
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world_size, tmp, threads, args))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while any(p.is_alive() for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world_size} ranks of {fn.__name__} still running "
                                       f"after {timeout:.0f} s")
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        outs = {}
        for r in range(world_size):
            path = os.path.join(tmp, f"rank{r}.pt")
            if os.path.exists(path):
                outs[r] = torch.load(path, weights_only=False)  # written by _rank_main
        for r, out in outs.items():
            if out["error"]:
                raise RuntimeError(f"rank {r} of {fn.__name__} failed:\n{out['error']}")
        for r, p in enumerate(procs):
            if r not in outs:
                raise RuntimeError(f"rank {r} of {fn.__name__} exited with code "
                                   f"{p.exitcode} and no result")
        return [outs[r]["value"] for r in range(world_size)]
