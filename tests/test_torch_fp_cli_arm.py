"""The port's method-matrix CLI (``ealv_tpu_torch.scripts.
run_fingerprint_matrix``) at ``--small --device cpu`` with the options of
its learning phase: the arm backend, the host loop, and the clustering
monitor inside the host loop. Port only, in-process, as
``test_torch_fp_cli.py``."""

import numpy as np
import pytest

from ealv_tpu_torch.scripts import run_fingerprint_matrix
from test_torch_fp_cli import run_matrix
from test_torch_trainer import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("flags", [["--backend", "arm"], ["--host-loop"],
                                   ["--backend", "arm", "--host-loop", "--cluster-every", "2"]])
def test_matrix_cli_arm_and_host_loop(capsys, flags):
    """The learning phase on the arm, through the host loop, and both with
    the clustering monitor after each block; the captures and the
    identification then run on the chosen backend."""
    rt, table, text = run_matrix(capsys, *flags)
    backend = "arm" if "arm" in flags else "free"
    assert rt.cfg.sim_backend == backend and set(table) == {"L2", "KL", "BC", "L2_error"}
    if "--host-loop" in flags:
        assert f"4 host-loop learning steps on '{backend}' backend" in text
        assert "recovery events:" in text
    else:
        assert "4 learning steps in" in text
    if "--cluster-every" in flags:
        assert "clusters @ 4:" in text
    for row in table.values():
        assert np.isfinite(row["error"]).all()


def test_matrix_cli_rejects_cluster_every_without_the_host_loop():
    with pytest.raises(SystemExit):
        run_fingerprint_matrix.main(["--device", "cpu", "--cluster-every", "5"])
