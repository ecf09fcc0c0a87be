"""K1 on the card: the CUDA kernel against its plain torch version.

Every test here needs a CUDA device and skips without one. This file
imports neither JAX nor the JAX package, so it also runs on a machine
without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from ealv_tpu_torch.ops import footprint as tfp
from ealv_tpu_torch.ops import kernels as tk


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(n, t, d, mask_kind, dev, seed=0):
    rng = np.random.default_rng(seed)
    samples = rng.uniform(-1, 1, (n, d))
    traj = rng.uniform(-1, 1, (t, d))
    std = np.full(d, 0.05)
    std[d // 2:] = 0.25
    mask = {"random": (rng.uniform(size=t) > 0.3) * 1.0, "zero": np.zeros(t),
            "ones": np.ones(t)}[mask_kind]
    return [torch.tensor(a, dtype=torch.float32, device=dev)
            for a in (samples, traj, std, mask)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,t,d,mask_kind", [
    (700, 900, 4, "random"), (700, 900, 2, "random"), (700, 900, 6, "random"),
    (300, 500, 3, "zero"), (2000, 10, 3, "ones"), (2000, 3000, 3, "random"),
    (1, 1, 8, "ones")])
def test_kernel_matches_plain(cuda, n, t, d, mask_kind):
    """f32 on both sides, summation order only: rtol 1e-5, atol 1e-6."""
    args = _inputs(n, t, d, mask_kind, cuda)
    before = tfp.footprint_and_spread.launches
    got = tfp.footprint_and_spread(*args)
    assert tfp.footprint_and_spread.launches == before + 1
    want = tfp.footprint_and_spread_reference(*args)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_traj_footprint_goes_through_the_kernel(cuda):
    samples, traj, std, mask = _inputs(64, 100, 3, "random", cuda)
    full = torch.cat([traj, -traj], 1)
    before = tfp.footprint_and_spread.launches
    got = tk.traj_spread(full, samples, [0, 1, 2], std, traj_mask=mask)
    assert tfp.footprint_and_spread.launches == before + 1
    want = tk.traj_spread(full.cpu(), samples.cpu(), [0, 1, 2], std.cpu(),
                          traj_mask=mask.cpu())
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_other_dtypes_and_shapes_raise(cuda):
    samples, traj, std, mask = _inputs(8, 9, 3, "ones", cuda)
    with pytest.raises(TypeError):
        tfp.footprint_and_spread(samples.double(), traj.double(), std.double(),
                                 mask.double())
    with pytest.raises(ValueError):
        tfp.footprint_and_spread(samples, traj.t().contiguous().t(), std, mask)
    with pytest.raises(ValueError):
        tfp.footprint_and_spread(*_inputs(8, 9, 9, "ones", cuda))
