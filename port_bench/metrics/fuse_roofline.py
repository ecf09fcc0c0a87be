"""The belief fusions' share of their roofline, in %: their least time
over ``fuse_ms``. The least time moves each belief's prior and variance
through the card's memory once, read and written, in float32: C * K * G *
16 bytes at the HBM rate (``counts.PEAK_HBM_BYTES``), for C distance
combinations, K objects and a grid of G = grid ** d cells over the d
states (``run["config"]``). The grid itself is not counted: it can be made
from the limits. The bound holds whatever implements the fusion."""

from port_bench import counts
from port_bench.metrics import fuse_ms


def fusion_bytes(cfg: dict) -> int:
    ident = cfg["identify"]
    cells = ident["grid"] ** len(cfg["states"])
    return len(ident["combos"]) * ident["objects"] * cells * 16


def read(run):
    ms = fuse_ms.read(run)
    if not ms or "identify" not in (run.get("config") or {}):
        return None
    return fusion_bytes(run["config"]) / counts.PEAK_HBM_BYTES * 1e3 / ms * 100.0
