"""Run one of the port's CLIs with the arm's matrix products rounded as a
TPU rounds a float32 dot at XLA's default precision: one bfloat16 pass,
each operand rounded to bfloat16 and the products summed in float32.

A diagnostic for comparing the port with results taken with the JAX
package on a TPU. ``ealv_tpu/sim/arm.py`` writes its kinematics as plain
``@`` products at default precision: the forward-kinematics chain and its
flange, the damped pseudo-inverse's ``J J^T`` and ``J^T (.)^-1`` and its
product with the command, the IK's rotation error. On a TPU a float32 dot
at default precision runs as one bfloat16 pass, so the reference's arm
reads its pose to about 2e-3 m and 4e-3 rad there; on a CPU, and in the
port, these products are float32. This module swaps the port's arm
kinematics (``sim/arm.py``: ``_chain``, ``_ee``, ``_dls_solve``,
``ik_step``) for versions that round those products the TPU's way, then
runs the CLI in the same process. Nothing else changes: the planner, the
model and the free env keep their own precision, and the 6x6 solve stays
float32.

    python -m ealv_tpu_torch.scripts.tpu_dots run_fingerprint_matrix --objects 2 \\
        --backend arm --host-loop --learn-steps 800 --id-steps 1000 --seed 0
    python -m ealv_tpu_torch.scripts.tpu_dots force_study --backend arm-dynamic
"""

from __future__ import annotations

import contextlib
import importlib
import sys

import torch

from ..sim import arm


def bf16(x):
    """``x`` rounded to bfloat16 (to nearest, ties to even), as float32."""
    return x.to(torch.bfloat16).float()


def dot(a, b):
    """``a @ b`` as one bfloat16 pass: both operands rounded, the products
    (exact in float32) summed in float32."""
    return bf16(a) @ bf16(b)


def _chain(q):
    """``arm._chain`` with each product of the chain a bfloat16 pass; the
    reference's chain starts from the identity, so the first link comes out
    rounded too."""
    c = arm._consts(q.device)
    ct, st = torch.cos(q), torch.sin(q)
    zero, one = torch.zeros_like(q), torch.ones_like(q)
    links = torch.stack([
        ct, -st, zero, c.a,
        st * c.ca, ct * c.ca, c.neg_sa, c.neg_dsa,
        st * c.sa, ct * c.sa, c.ca, c.dca,
        zero, zero, zero, one], -1).reshape(7, 4, 4)
    frames = [bf16(links[0])]
    for i in range(1, 7):
        frames.append(dot(frames[-1], links[i]))
    return torch.stack(frames)


def _ee(frames):
    """``arm._ee`` as the reference's product with the flange transform:
    the position sums the rounded translation and the rounded z axis times
    the rounded flange offset; the rotation comes out rounded."""
    T = frames[-1]
    flange = bf16(torch.tensor(arm.FLANGE_D, device=T.device))
    return bf16(T[:3, 3]) + bf16(T[:3, 2]) * flange, bf16(T[:3, :3])


def _dls_solve(J, twist, damping=1e-2):
    """The reference's ``_dls_pinv(J) @ twist``: ``J J^T`` and both
    products with ``J^T (J J^T + damping^2 I)^-1`` as bfloat16 passes."""
    eye = arm._consts(J.device).eye6
    inv = torch.linalg.solve(dot(J, J.T) + damping ** 2 * eye, eye)
    return dot(dot(J.T, inv), twist[:, None])[:, 0]


def ik_step(q, target_p, target_R, gain=0.8, damping=5e-2):
    """``arm.ik_step`` with the rotation error ``target_R @ R^T`` as a
    bfloat16 pass."""
    frames = _chain(q)
    p, R = _ee(frames)
    R_err = dot(target_R, R.T)
    w = 0.5 * torch.stack([R_err[2, 1] - R_err[1, 2], R_err[0, 2] - R_err[2, 0],
                           R_err[1, 0] - R_err[0, 1]])
    twist = torch.cat([target_p - p, w])
    c = arm._consts(q.device)
    return torch.clamp(q + gain * _dls_solve(arm._jacobian(frames), twist, damping),
                       c.q_min, c.q_max)


PATCHES = {"_chain": _chain, "_ee": _ee, "_dls_solve": _dls_solve, "ik_step": ik_step}


@contextlib.contextmanager
def tpu_dots():
    """Inside the block, the port's arm kinematics round as a TPU does."""
    saved = {name: getattr(arm, name) for name in PATCHES}
    for name, fn in PATCHES.items():
        setattr(arm, name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(arm, name, fn)


def main(argv=None):
    """``argv``: a CLI module of ``ealv_tpu_torch.scripts`` and its
    arguments. Returns what its ``main`` returns."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        raise SystemExit(0 if argv else 2)
    cli = importlib.import_module(f"{__package__}.{argv[0]}")
    with tpu_dots():
        print("arm kinematics: float32 products as one bfloat16 pass (tpu_dots)", flush=True)
        return cli.main(argv[1:])


if __name__ == "__main__":
    main()
