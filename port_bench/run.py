"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the repository's root on a machine with the cards the cell asks
for. It sets up the cell's program entry from ``--seed``, warms it up until
every tick pattern is captured, measures for ``--seconds``, compares the
compared ticks with the reference, and prints one JSON line last on
standard output: with ``--trace 0`` the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics (and ``breakdown``). The numbers
compared, each with its limit, are the last lines on standard error and
the ``checks`` key that comes last in the line.

Exit codes: 0 with a result; 2 without enough cards; 3 if a module of
JAX or of the JAX package was loaded (no result is printed then).
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
CACHE = REPO / ".bench_cache"
# kernel caches inside the checkout, at fixed paths: only a cell's first run
# in a checkout builds; the port's own libraries go to ealv_tpu_torch/_build/
os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402

MISSING = 1e308  # a compared number that no compared tick produced, or not finite


def per_layer(files: dict, r: dict) -> dict:
    """Each per-layer metric of the cell that its reader finds."""
    out = {}
    for m in files["per_layer"]:
        reader = importlib.import_module(f"port_bench.metrics.{m['name']}")
        value = reader.read(r)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def end_to_end(files: dict, r: dict) -> dict:
    from port_bench.harness import p95
    values = {"tick_ms": r["window_s"] / r["ticks"] * 1e3,
              "tick_p95_ms": p95(r["gaps_s"]) * 1e3, "setup_s": r["setup_s"]}
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in files["end_to_end"] if files["cell"]["name"] in m.get("workloads", [files["cell"]["name"]])}


def checks(files: dict, r: dict) -> tuple:
    """(the numbers compared with their limits, the compared ticks that
    failed). A limited number that no compared tick produced fails."""
    out, failed = {}, 0
    for name, limit in files["limits"].items():
        value = r["gaps"].get(name, MISSING)
        out[name] = {"value": value if math.isfinite(value) else MISSING, "limit": limit}
    for gaps in r["per_tick"]:
        failed += any(gaps[k] > lim or gaps[k] != gaps[k]
                      for k, lim in files["limits"].items() if k in gaps)
    return out, failed


def result(files: dict, r: dict, trace_on: bool) -> dict:
    import torch
    checked, failed_ticks = checks(files, r)
    ok = all(c["value"] <= c["limit"] for c in checked.values())
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
              "memory_peak_bytes": r["memory_peak_bytes"]}
    line = {"correct": ok and r["nonfinite"] == 0 and r["captured_in_window"] == 0,
            "attempted": r["ticks"], "failed": r["nonfinite"] + failed_ticks,
            "metrics": per_layer(files, r) if trace_on else end_to_end(files, r),
            "device": device}
    if trace_on:
        t = r["traced"]
        device.update(busy_s=t["busy_s"], window_s=t["window_s"])
        line["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
    line["checks"] = checked
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from port_bench import harness

    files = harness.cell_files(args.workload)
    chips = files["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"port_bench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    r = harness.measure(files, args.seed, args.seconds, bool(args.trace))
    banned = harness.banned_modules()
    if banned:
        print(f"port_bench: modules of JAX or the JAX package were loaded: {banned}",
              file=sys.stderr)
        return 3
    line = result(files, r, bool(args.trace))
    print(f"port_bench: {r['ticks']} ticks in {r['window_s']:.3f} s after {r['warm_ticks']} "
          f"warm ticks; graphs captured in the window: {r['captured_in_window']}; "
          f"non-finite infos: {r['nonfinite']}", file=sys.stderr)
    for kind, sel in (("trainer", True), ("explore", False)):
        g = [x * 1e3 for x, t in zip(r["gaps_s"], r["trained"]) if t == sel]
        h = [x * 1e3 for x, t in zip(r["host_s"], r["trained"]) if t == sel]
        if g:
            print(f"port_bench: {len(g)} {kind} ticks: gap mean {sum(g) / len(g):.3f} ms, min "
                  f"{min(g):.3f}, max {max(g):.3f}; host mean {sum(h) / len(h):.3f} ms",
                  file=sys.stderr)
    if r["traced"]:
        t, n = r["traced"], files["traffic"]["chunk"]
        print(f"port_bench: the traced chunk, {n} ticks: {t['window_s'] / n * 1e3:.3f} ms a tick "
              f"under the profiler, {t['busy_s'] / n * 1e3:.3f} of them busy; the window "
              f"{r['window_s'] / r['ticks'] * 1e3:.3f}", file=sys.stderr)
    if r["spans"]:
        from ealv_tpu_torch.runtime import tracing
        print(tracing.describe(r["spans"]), file=sys.stderr)
    for name, v in sorted(r["gaps"].items()):
        if name not in line["checks"]:
            print(f"reading {name} {v!r} (not compared)", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
