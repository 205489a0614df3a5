"""Rigid-body kinematics: blob positions and the geometric K / K^T
products (PyTorch).

Counterpart of rigidmultiblobswall_tpu/models/kinematics.py. K is never
materialized for products: K U = v + w x r_rel and
K^T lam = (sum lam, sum r_rel x lam), batched per body type and over any
leading batch dimensions (stacked right-hand sides). Dense K matrices
serve the small per-body preconditioner blocks.

The products accept the per-type relative blob positions precomputed
(`rel=`), so an operator applied in every Krylov iteration rotates the
reference configurations once.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import quaternion as quat
from ..parallel.mesh import host_bool
from .system import State, System


def type_arrays(system: System, state: State, i: int):
    """(pos, quat) slices of type group i, shapes (..., c, 3), (..., c,
    4) for a state with leading batch dimensions (..., B, 3)."""
    sl = system.body_slice(i)
    return state.pos[..., sl, :], state.quat[..., sl, :]


def blob_rel_positions(system: System, state: State, i: int, ref=None):
    """Blob positions relative to body centers for type i: (..., c, nb,
    3). `ref` is the type's reference blobs (nb, 3) in the state's dtype
    and on its device, copied from the host when None."""
    _, q = type_arrays(system, state, i)
    R = quat.rotation_matrix(q)
    if ref is None:
        ref = torch.as_tensor(np.array(system.types[i].ref_config),
                              dtype=state.pos.dtype, device=state.pos.device)
    return torch.einsum("...cij,nj->...cni", R, ref)


def all_rel_positions(system: System, state: State, refs=None):
    """Tuple of blob_rel_positions for every type (`refs` one reference
    tensor a type, or None)."""
    return tuple(blob_rel_positions(system, state, i,
                                    None if refs is None else refs[i])
                 for i in range(len(system.types)))


def blob_positions(system: System, state: State, rel=None, refs=None):
    """All blob coordinates, (..., N, 3) in type-group order, for a state
    with leading batch dimensions (..., B, 3) or none; `refs` as in
    all_rel_positions."""
    rel = all_rel_positions(system, state, refs) if rel is None else rel
    out = []
    for i, t in enumerate(system.types):
        p, _ = type_arrays(system, state, i)
        out.append((p[..., :, None, :] + rel[i]).reshape(
            *p.shape[:-2], t.count * t.num_blobs, 3))
    return torch.cat(out, dim=-2)


def K_mul(system: System, state: State, U, rel=None):
    """K U: body velocities (..., B, 6) -> blob velocities (..., N, 3)."""
    rel = all_rel_positions(system, state) if rel is None else rel
    batch = U.shape[:-2] if U.ndim >= 3 else ()
    U = U.reshape(*batch, system.num_bodies, 6)
    out = []
    for i, t in enumerate(system.types):
        u_t = U[..., system.body_slice(i), :]
        v, w = u_t[..., :3], u_t[..., 3:]
        r_rel = rel[i].expand(*batch, *rel[i].shape)
        vel = v[..., :, None, :] + torch.linalg.cross(
            w[..., :, None, :].expand_as(r_rel), r_rel, dim=-1)
        out.append(vel.reshape(*batch, t.count * t.num_blobs, 3))
    return torch.cat(out, dim=-2)


def KT_mul(system: System, state: State, lam, rel=None):
    """K^T lam: blob forces (..., N, 3) -> body force-torques (..., B, 6)."""
    rel = all_rel_positions(system, state) if rel is None else rel
    batch = lam.shape[:-2] if lam.ndim >= 3 else ()
    lam = lam.reshape(*batch, system.num_blobs, 3)
    out = []
    for i, t in enumerate(system.types):
        lam_t = lam[..., system.blob_slice(i), :].reshape(
            *batch, t.count, t.num_blobs, 3)
        f = torch.sum(lam_t, dim=-2)
        r_rel = rel[i].expand_as(lam_t)
        tau = torch.sum(torch.linalg.cross(r_rel, lam_t, dim=-1), dim=-2)
        out.append(torch.cat([f, tau], dim=-1))
    return torch.cat(out, dim=-2)


def K_dense(system: System, state: State, i: int):
    """Dense K matrices of type i: (c, 3 nb, 6), for the per-body
    preconditioner solves."""
    t = system.types[i]
    r_rel = blob_rel_positions(system, state, i)
    c, nb = t.count, t.num_blobs
    eye = torch.eye(3, dtype=r_rel.dtype, device=r_rel.device).expand(
        c, nb, 3, 3)
    # rotation part: (K w) = w x r  ->  K[:, a, b] = -eps_{abc} r_c
    rx, ry, rz = r_rel[..., 0], r_rel[..., 1], r_rel[..., 2]
    zeros = torch.zeros_like(rx)
    rot = torch.stack([
        torch.stack([zeros, rz, -ry], dim=-1),
        torch.stack([-rz, zeros, rx], dim=-1),
        torch.stack([ry, -rx, zeros], dim=-1),
    ], dim=-2)
    return torch.cat([eye, rot], dim=-1).reshape(c, 3 * nb, 6)


def active_slip(system: System, state: State, dtype=None):
    """Prescribed active slip rotated to the lab frame, (N, 3): each
    type's body-frame slip_ref (a .slip file) turned by its bodies'
    orientations, zero for a type without one."""
    dtype = dtype or state.pos.dtype
    out = []
    for i, t in enumerate(system.types):
        if t.slip_ref is None:
            out.append(torch.zeros((t.count * t.num_blobs, 3), dtype=dtype,
                                   device=state.pos.device))
            continue
        _, q = type_arrays(system, state, i)
        slip = torch.einsum("cij,nj->cni", quat.rotation_matrix(q).to(dtype),
                            torch.tensor(np.array(t.slip_ref), dtype=dtype,
                                         device=state.pos.device))
        out.append(slip.reshape(t.count * t.num_blobs, 3))
    return torch.cat(out, dim=0)


def min_blob_height(system: System, state: State):
    return torch.min(blob_positions(system, state)[:, 2])


def valid_configuration(system: System, state: State) -> bool:
    """True when every blob lies above the wall (always for the domains
    without one). A host bool: the caller's retry loop branches on it
    (rank 0's under a mesh, parallel/mesh.host)."""
    if system.domain in ("no_wall", "periodic_spectral"):
        return True
    return host_bool(min_blob_height(system, state) > 0.0)


def advance(state: State, velocities, dt) -> State:
    """Euler update x += v dt, q <- exp(w dt) q."""
    U = velocities.reshape(-1, 6)
    return State(pos=state.pos + U[:, :3] * dt,
                 quat=quat.step(state.quat, U[:, 3:], dt))
