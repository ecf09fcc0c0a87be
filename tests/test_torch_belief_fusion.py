"""The belief fusion's routing and its kernel's wrapper on the CPU
(``fingerprint/belief.py`` ``push_and_fuse``, ``ops/belief.py``): CPU
beliefs take the plain ``push`` and ``update_prior`` and never the kernel,
the identification's pushes are the old loop's, and the wrapper raises on
what the kernel does not take. The kernel itself is held against the plain
version on the card in ``tests/test_torch_cuda.py``.

This file imports neither JAX nor the JAX package:

    python -m pytest -p no:cacheprovider tests/test_torch_belief_fusion.py
"""

import dataclasses
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from ealv_tpu_torch.fingerprint import belief as tbel
from ealv_tpu_torch.fingerprint import identify as tid
from ealv_tpu_torch.ops import belief as tbo

FIELDS = ("prior", "prior_var", "meas_loc", "meas_val", "meas_n", "count")


def _belief(states="xyw", ns=8, cap=8, rng=None, pending=0, **kw):
    b = tbel.FingerprintBelief.create(states, [[-1.0, 1.0]] * len(states), num_samples=ns,
                                      meas_capacity=cap, thresh=0.8, clip=2.2, device="cpu",
                                      **kw)
    if rng is None:
        return b
    d = len(states)
    t = lambda a: torch.tensor(a, dtype=torch.float32)
    return dataclasses.replace(b, prior=t(rng.uniform(0.2, 0.9, ns ** d)),
                               meas_loc=t(rng.uniform(-1, 1, (cap, d))),
                               meas_val=t(rng.uniform(0, 2.5, cap)),
                               meas_n=torch.tensor(pending))


def _same(a, b):
    for name in FIELDS:
        assert torch.equal(getattr(a, name), getattr(b, name)), name


@pytest.fixture
def no_kernel(monkeypatch):
    """The kernel's wrapper raises if anything calls it."""
    def refuse(*a, **k):
        raise AssertionError("a CPU belief reached the kernel")

    monkeypatch.setattr(tbel, "fuse_beliefs", refuse)
    before = tbo.fuse_beliefs.launches
    yield
    assert tbo.fuse_beliefs.launches == before


@pytest.mark.parametrize("n_push", [0, 1, 2, 11])
def test_cpu_beliefs_take_the_plain_path(no_kernel, n_push):
    """``push_and_fuse`` and ``update_prior`` on CPU beliefs are the plain
    pushes and ``_update_prior_plain``, bit for bit; the ring wraps."""
    rng = np.random.default_rng(n_push)
    beliefs = [_belief(rng=rng, pending=p) for p in (0, 3, 8)]
    rows = torch.tensor(rng.uniform(-1, 1, (n_push, 3)), dtype=torch.float32)
    vals = torch.tensor(rng.uniform(0, 2.5, n_push), dtype=torch.float32)
    pushes = [(rows, vals), None, (rows, vals)]
    got = tbel.push_and_fuse(beliefs, pushes)
    for b, push, g in zip(beliefs, pushes, got):
        want = b
        if push is not None:
            for r, v in zip(*push):
                want = want.push(r, v)
        _same(g, want._update_prior_plain())
        if push is None:
            _same(b.update_prior(), g)


def test_plain_fusion_leaves_the_old_belief(no_kernel):
    rng = np.random.default_rng(4)
    b = _belief(rng=rng, pending=2)
    kept = {n: getattr(b, n).clone() for n in FIELDS}
    (new,) = tbel.push_and_fuse([b], [(torch.zeros((2, 3)), torch.ones(2))])
    for n, v in kept.items():
        assert torch.equal(getattr(b, n), v), n
    assert int(new.count) == 4 and int(new.meas_n) == 0


@pytest.mark.parametrize("error_mode", [False, True])
def test_match_pushes_are_the_old_loops_pushes(no_kernel, error_mode):
    """``fuse_matches`` through ``match_pushes``: the pushes of each
    fingerprint's reflected relative poses (rows i and K + i), or of the
    test pose in error mode, each with its best distance, as the loop it
    replaced made them; the rows are views of the relative poses."""
    rng = np.random.default_rng(7)
    k, states = 3, "xyw"
    lims = torch.tensor([[-1.0, 1.0], [-1.0, 1.0], [-1.5, 1.5]])
    fps = tid.FingerprintSet(z_mu=None, z_logvar=None, x=None, center_img=None, mask=None,
                             center=torch.tensor(rng.uniform(-0.5, 0.5, (k, 3)),
                                                 dtype=torch.float32))
    dists = torch.tensor([0.4, 1.2, 2.1])
    best = torch.tensor(rng.uniform(-0.5, 0.5, (k, 3)), dtype=torch.float32)
    test = torch.tensor([0.1, -0.3, 0.7])
    beliefs = [_belief(rng=rng, pending=1) for _ in range(k)]
    got = tid.fuse_matches(beliefs, dists, best, test, fps, states, lims, lims, error_mode)
    pushes = tid.match_pushes(dists, best, test, fps, states, lims, lims, error_mode)
    if error_mode:
        want = [b.push(test, dists[i])._update_prior_plain() for i, b in enumerate(beliefs)]
    else:
        bel = tid.relative_pose_beliefs(states, test, best, fps.center, lims, lims)
        want = [b.push(bel[i], dists[i]).push(bel[k + i], dists[i])._update_prior_plain()
                for i, b in enumerate(beliefs)]
        assert all(rows._base is not None and rows.shape == (2, 3) for rows, _ in pushes)
    assert all(vals.stride() == (0,) for _, vals in pushes)
    for g, w in zip(got, want):
        _same(g, w)


def _cases(rng):
    """(name, beliefs, pushes, error) the wrapper refuses."""
    b = _belief(rng=rng)
    rows, vals = torch.zeros((2, 3)), torch.zeros(2)
    wide = _belief("xyzrpw", ns=2)
    wide = dataclasses.replace(wide, grid=torch.zeros((wide.grid.shape[0], 7)))
    return {
        "f64 prior": ([dataclasses.replace(b, prior=b.prior.double())], None, TypeError),
        "short variance": ([dataclasses.replace(b, prior_var=b.prior_var[:-1])], None,
                           ValueError),
        "strided prior": ([dataclasses.replace(b, prior=torch.zeros(2 * 512)[::2])], None,
                          ValueError),
        "int32 count": ([dataclasses.replace(b, meas_n=torch.tensor(0, dtype=torch.int32))],
                        None, TypeError),
        "d = 7": ([wide], None, ValueError),
        "ring of 257": ([_belief(cap=257)], None, ValueError),
        "rows of the wrong width": ([b], [(torch.zeros((2, 2)), vals)], ValueError),
        "f64 rows": ([b], [(rows.double(), vals)], TypeError),
        "a row's floats apart": ([b], [(torch.zeros((3, 2)).t(), vals)], ValueError),
        "values of another count": ([b], [(rows, torch.zeros(3))], ValueError),
        "pushes for another count of beliefs": ([b, b], [None], ValueError),
        "beliefs of two sizes": ([b, _belief("xy", ns=10, rng=rng)], None, ValueError),
        "no belief": ([], None, ValueError),
    }


@pytest.mark.parametrize("case", list(_cases(np.random.default_rng(0))))
def test_wrapper_raises_on_what_the_kernel_does_not_take(case):
    """``check_fusion`` and ``fuse_beliefs`` raise before any launch."""
    beliefs, pushes, err = _cases(np.random.default_rng(0))[case]
    before = tbo.fuse_beliefs.launches
    with pytest.raises(err):
        tbo.check_fusion(beliefs, pushes)
    with pytest.raises(err):
        tbo.fuse_beliefs(beliefs, pushes)
    assert tbo.fuse_beliefs.launches == before


def test_wrapper_takes_cpu_shapes_and_launches_on_cuda_only():
    """CPU beliefs check out with their (G, d, cap), and raise in
    ``fuse_beliefs``: the plain version lives in ``fingerprint/belief.py``."""
    rng = np.random.default_rng(2)
    beliefs = [_belief(rng=rng), _belief(rng=rng), _belief(rng=rng)]
    pushes = [(torch.zeros((2, 3)), torch.zeros(1).expand(2)), None, None]
    assert tbo.check_fusion(beliefs, pushes) == (512, 3, 8)
    before = tbo.fuse_beliefs.launches
    with pytest.raises(TypeError, match="CUDA"):
        tbo.fuse_beliefs(beliefs, pushes)
    assert tbo.fuse_beliefs.launches == before


def test_no_build_at_import():
    """Importing the port, the fingerprint stage and the graphs builds and
    loads no CUDA library."""
    code = textwrap.dedent("""
        from ealv_tpu_torch.ops import cuda_build
        def refuse(*a, **k):
            raise AssertionError("built at import")
        cuda_build.build = cuda_build.load = refuse
        import ealv_tpu_torch, ealv_tpu_torch.fingerprint, ealv_tpu_torch.runtime.graphs
        import ealv_tpu_torch.fingerprint.test_runtime
        from ealv_tpu_torch.ops import belief
        assert not cuda_build._loaded and belief._library.cache_info().currsize == 0
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
