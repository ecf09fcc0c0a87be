"""The readings that the limits of ``limits/<cell>.json`` are set from: for
each seed, one run of the cell (set-up, warm-up, a window of ``--seconds``)
in this one process, and at its compared ticks the program's gaps to the
reference beside those of the control (the reference with the CVAE's
products and the ring's images in float8 e4m3, in the program's place),
of a float32 witness and of the planted faults (``harness.CONTROLS``).
The benchmark's own runs do not run them.

    python3 -m port_bench.readings --workload <cell> --seeds 1,2,3 --seconds 8 [--out FILE]

Prints one JSON line a seed; with ``--out`` appends them to FILE too.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch
    from port_bench import harness

    if not torch.cuda.is_available():
        print("port_bench.readings: no CUDA device", file=sys.stderr)
        return 2
    files = harness.cell_files(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        r = harness.measure(files, seed, args.seconds, False, controls=tuple(harness.CONTROLS))
        line = json.dumps(dict(workload=args.workload, seed=seed, ticks=r["ticks"],
                               tick_ms=r["window_s"] / r["ticks"] * 1e3,
                               program=r["gaps"], **r["controls"],
                               program_per_tick=r["per_tick"],
                               per_tick=r["controls_per_tick"]))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
