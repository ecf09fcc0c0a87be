"""SO(3) utilities in torch (port of ``ealv_tpu/utils/rotations.py``):
Euler <-> rotation matrix, hat/unhat, Rodrigues exp, angle wrapping and
the Euler-rate Jacobian.

Convention: scipy's extrinsic 'xyz', ``R = Rz(c) @ Ry(b) @ Rx(a)`` for
angles ``(a, b, c)``. Every function takes leading batch dims: angles and
rotation vectors ``(..., 3)``, matrices ``(..., 3, 3)``. The 3x3 products
are elementwise sums in float32 (``mm``), never a library matmul, so TF32
or bf16 settings cannot drift R off orthonormal over the horizon.
"""

from __future__ import annotations

import math

import torch


def mm(a, b):
    """a @ b over the last two dims, as a float32 elementwise sum."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def _stack3x3(rows):
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def _rx(a):
    c, s = torch.cos(a), torch.sin(a)
    o, z = torch.ones_like(a), torch.zeros_like(a)
    return _stack3x3([[o, z, z], [z, c, -s], [z, s, c]])


def _ry(a):
    c, s = torch.cos(a), torch.sin(a)
    o, z = torch.ones_like(a), torch.zeros_like(a)
    return _stack3x3([[c, z, s], [z, o, z], [-s, z, c]])


def _rz(a):
    c, s = torch.cos(a), torch.sin(a)
    o, z = torch.ones_like(a), torch.zeros_like(a)
    return _stack3x3([[c, -s, z], [s, c, z], [z, z, o]])


_AXES = {"X": _rx, "Y": _ry, "Z": _rz}


def euler_angles_to_matrix(angles, convention: str = "XYZ"):
    """Euler angles (..., 3) -> rotation matrices (..., 3, 3), the flipped
    product ``m2 @ m1 @ m0``: 'XYZ' angles (a, b, c) give
    ``Rz(c) @ Ry(b) @ Rx(a)``."""
    mats = [_AXES[c](angles[..., i]) for i, c in enumerate(convention)]
    return mm(mm(mats[2], mats[1]), mats[0])


def matrix_to_euler_angles(R, convention: str = "XYZ"):
    """Rotation matrices (..., 3, 3) -> Euler angles (..., 3), 'XYZ' only:
    b = asin(-R[2,0]), a = atan2(R[2,1], R[2,2]), c = atan2(R[1,0], R[0,0])."""
    if convention != "XYZ":
        raise NotImplementedError("only 'XYZ' (scipy extrinsic xyz) is used")
    b = torch.asin(torch.clamp(-R[..., 2, 0], -1.0, 1.0))
    a = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    c = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    return torch.stack([a, b, c], -1)


def hat(w):
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    z = torch.zeros_like(w[..., 0])
    return _stack3x3([[z, -w[..., 2], w[..., 1]],
                      [w[..., 2], z, -w[..., 0]],
                      [-w[..., 1], w[..., 0], z]])


def unhat(W):
    """(..., 3, 3) skew-symmetric -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], -1)


def so3_exp(w, eps: float = 1e-8):
    """Rodrigues: exp(hat(w)) for rotation vectors w (..., 3); the angle is
    held at ``eps`` or more, so w = 0 gives the identity."""
    theta = torch.linalg.vector_norm(w, dim=-1, keepdim=True).clamp(min=eps)
    K = hat(w / theta)
    t = theta[..., None]
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + torch.sin(t) * K + (1.0 - torch.cos(t)) * mm(K, K)


def wrap_angles(rot):
    """Roll into [0, 2pi), pitch and yaw into [-pi, pi)."""
    r0 = torch.remainder(rot[..., :1], 2 * math.pi)
    r12 = torch.remainder(rot[..., 1:] + math.pi, 2 * math.pi) - math.pi
    return torch.cat([r0, r12], -1)


def euler_rate_jacobian(rot):
    """Body angular velocity -> XYZ Euler rates, B(r, p) (..., 3, 3):
    [[1, s0 t1, c0 t1], [0, c0, -s0], [0, s0/c1, c0/c1]], with pitch nudged
    by 1e-5 off the singularity at pi/2."""
    r = rot[..., 0]
    p = rot[..., 1] + 1e-5
    s0, c0 = torch.sin(r), torch.cos(r)
    t1, c1 = torch.tan(p), torch.cos(p)
    o, z = torch.ones_like(r), torch.zeros_like(r)
    return _stack3x3([[o, s0 * t1, c0 * t1], [z, c0, -s0], [z, s0 / c1, c0 / c1]])
