"""``python3 -m port_bench.readings`` for the contact cell, with the
planted faults of its entry (``entries/learn_contact.py``'s ``FAULTS``:
``force_dropped``, ``ensemble_collapsed``) beside ``harness.CONTROLS``.

    python3 -m port_bench.readings_contact --workload xyz_force.learn --seeds 1,2,3 --seconds 8 [--out FILE]
"""

from __future__ import annotations

import sys


def main(argv=None) -> int:
    from port_bench import harness, readings
    from port_bench.entries.learn_contact import FAULTS
    harness.CONTROLS.update(FAULTS)
    return readings.main(argv)


if __name__ == "__main__":
    sys.exit(main())
