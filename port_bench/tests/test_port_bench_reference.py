"""The reference against the port's eager tick at a toy size on the CPU,
and the control: the reference with the CVAE's products and the ring's
images in float8 e4m3 put in the program's place fails a compared number.
On the card the same comparison runs at the cells' own sizes
(``python3 -m port_bench.readings``)."""

import ast
from pathlib import Path

import pytest

from port_bench import harness
from port_bench.tests.toy import toy_mix

SEED = 2 ** 31 + 12345  # more than 32 signed bits hold


def _fails(files, gaps) -> list:
    return [k for k, lim in files["limits"].items() if not gaps.get(k, float("inf")) <= lim]


@pytest.mark.parametrize("cell", ["xyw.learn", "xyzrpw.learn", "xyw.eval", "xyzrpw.eval"])
def test_the_port_agrees_and_the_control_does_not(cell):
    files = toy_mix(cell)
    r = harness.measure(files, SEED, 0.5, False, device="cpu", controls=("fp8",))
    assert r["per_tick"], "no compared tick"
    assert _fails(files, r["gaps"]) == [], r["gaps"]
    assert _fails(files, r["controls"]["fp8"]), r["controls"]["fp8"]
    if files["traffic"]["entry"] == "learn":
        assert any(t.get("loss") is not None for t in r["per_tick"]), "no trainer tick compared"


def test_the_reference_imports_nothing_of_the_program():
    for path in (Path(__file__).resolve().parents[1] / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else \
                [node.module or ""] if isinstance(node, ast.ImportFrom) and not node.level else []
            for name in names:
                assert name.split(".")[0] not in ("ealv_tpu_torch", "ealv_tpu", "jax", "jaxlib",
                                                  "flax"), (path.name, name)
