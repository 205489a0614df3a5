"""Batched unit-quaternion kinematics (PyTorch).

Counterpart of rigidmultiblobswall_tpu/ops/quaternion.py. Quaternions
are tensors of shape (..., 4), scalar first, q = (s, p1, p2, p3); every
function takes arbitrary leading batch dimensions and keeps the device
and dtype of its inputs.
"""

from __future__ import annotations

import math

import torch


def identity(batch_shape=(), dtype=torch.float64, device=None):
    """Identity quaternion(s) with shape batch_shape + (4,)."""
    q = torch.zeros(tuple(batch_shape) + (4,), dtype=dtype, device=device)
    q[..., 0] = 1.0
    return q


def multiply(q, r):
    """Hamilton product q*r, shape (..., 4)."""
    qs, qv = q[..., :1], q[..., 1:]
    rs, rv = r[..., :1], r[..., 1:]
    s = qs * rs - torch.sum(qv * rv, dim=-1, keepdim=True)
    v = qs * rv + rs * qv + torch.linalg.cross(qv, rv, dim=-1)
    return torch.cat([s, v], dim=-1)


def inverse(q):
    """Inverse (= conjugate) of unit quaternion(s)."""
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def normalize(q):
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def from_rotation(phi):
    """Exp-map: rotation vector(s) (..., 3) -> unit quaternion(s) (..., 4),
    q = (cos(|phi|/2), sin(|phi|/2) phi/|phi|), smooth at phi = 0."""
    n2 = torch.sum(phi * phi, dim=-1, keepdim=True)
    norm = torch.sqrt(n2)
    half = 0.5 * norm
    s = torch.cos(half)
    # sin(half)/half = sinc(half/pi), torch.sinc(x) = sin(pi x)/(pi x)
    p = 0.5 * phi * torch.sinc(half / math.pi)
    return torch.cat([s, p], dim=-1)


def to_rotation_vector(q):
    """Log-map: unit quaternion(s) -> rotation vector(s) (..., 3)."""
    s = torch.clamp(q[..., :1], -1.0, 1.0)
    p = q[..., 1:]
    pnorm = torch.linalg.norm(p, dim=-1, keepdim=True)
    angle = 2.0 * torch.atan2(pnorm, s)
    scale = torch.where(pnorm > 1e-30,
                        angle / torch.clamp(pnorm, min=1e-30),
                        torch.full_like(pnorm, 2.0))
    return scale * p


def rotation_matrix(q):
    """Rotation matrix R (..., 3, 3) of unit quaternion(s) (..., 4);
    a body-frame vector x maps to the lab frame as R @ x."""
    s = q[..., 0]
    p0, p1, p2 = q[..., 1], q[..., 2], q[..., 3]
    d = s * s - 0.5
    rows = [
        torch.stack([p0 * p0 + d, p0 * p1 - s * p2, p0 * p2 + s * p1], dim=-1),
        torch.stack([p0 * p1 + s * p2, p1 * p1 + d, p1 * p2 - s * p0], dim=-1),
        torch.stack([p0 * p2 - s * p1, p1 * p2 + s * p0, p2 * p2 + d], dim=-1),
    ]
    return 2.0 * torch.stack(rows, dim=-2)


def rotate(q, x):
    """Rotate vector(s) x (..., 3) by quaternion(s) q (..., 4)."""
    qv = q[..., 1:]
    s = q[..., :1]
    t = 2.0 * torch.linalg.cross(qv, x, dim=-1)
    return x + s * t + torch.linalg.cross(qv, t, dim=-1)


def random(generator, batch_shape=(), dtype=torch.float64, device=None):
    """Uniformly random unit quaternion(s) (Haar measure on SO(3)), drawn
    from an explicit torch.Generator."""
    v = torch.randn(tuple(batch_shape) + (4,), generator=generator,
                    dtype=dtype, device=device)
    return normalize(v)


def step(q, omega, dt):
    """Advance orientation: q_new = exp(omega dt) * q."""
    return multiply(from_rotation(omega * dt), q)
