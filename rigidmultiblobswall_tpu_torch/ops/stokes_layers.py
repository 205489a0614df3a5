"""Stokes pressure and double-layer boundary operators (PyTorch).

Counterpart of rigidmultiblobswall_tpu/ops/stokes_layers.py, all of it
plain PyTorch (XLA there):
  - the pressure field of Stokeslets, unbounded and above a wall (Blake's
    image system), with the pseudo-periodic image boxes;
  - the RPY-regularized Stokes double layer, and the Stokes double layer
    with the Gimbutas (2015) half-space image system;
  - the dense unbounded double-layer matrix of body_mobility's
    double-layer slip correction.

The JAX package's two documented deviations from the reference carry
over: the unbounded pressure projects the displacement to the minimum
image before taking |r|, and the wall pressure applies 1/(4 pi) once,
not inside the source loop.
"""

from __future__ import annotations

import math

import torch

from .pair_kernels import box_offsets, min_image


def pressure_stokeslet(r_src, r_tgt, force, *, wall=False,
                       periodic_length=(0.0, 0.0, 0.0)):
    """p_i = 1/(4 pi) sum_j f_j . r_ij / r^3 (+ wall images), summed over
    the image boxes of periodic_length. Returns (Nt,)."""
    periodic_length = tuple(float(x) for x in periodic_length)
    force = force.reshape(-1, 3)
    d0 = min_image(r_tgt[:, None, :] - r_src[None, :, :], periodic_length)
    Lvec = torch.tensor(periodic_length, dtype=r_src.dtype,
                        device=r_src.device)
    p = torch.zeros(r_tgt.shape[0], dtype=r_src.dtype, device=r_src.device)
    for box in box_offsets(periodic_length):
        d = d0 if box == (0, 0, 0) else d0 + torch.tensor(
            box, dtype=d0.dtype, device=d0.device) * Lvec
        r2 = torch.sum(d * d, dim=-1)
        zero = r2 == 0.0
        invr3 = torch.where(zero, 0.0, 1.0 / torch.where(
            zero, 1.0, r2 * torch.sqrt(r2)))
        p = p + torch.einsum("tsk,sk,ts->t", d, force, invr3)
        if wall:
            rz = r_tgt[:, 2][:, None] + r_src[:, 2][None, :]
            d_img = torch.cat([d[..., :2], rz[..., None]], dim=-1)
            R2 = torch.sum(d_img * d_img, dim=-1)
            invR = 1.0 / torch.sqrt(torch.where(R2 == 0.0, 1.0, R2))
            invR3 = torch.where(R2 == 0.0, 0.0, invR ** 3)
            invR5 = invR3 * invR * invR
            h = r_src[:, 2][None, :]
            # - image stokeslet
            p = p - torch.einsum("tsk,sk,ts->t", d_img, force, invR3)
            # - source doublet corrections (Blake)
            fx, fy, fz = force[:, 0], force[:, 1], force[:, 2]
            corr = (-fx[None, :] * 2 * h * (-3 * rz * d[..., 0] * invR5)
                    - fy[None, :] * 2 * h * (-3 * rz * d[..., 1] * invR5)
                    + fz[None, :] * 2 * h * (-3 * rz * rz * invR5 + invR3))
            p = p + torch.sum(corr, dim=1)
    return p / (4.0 * math.pi)


def double_layer_rpy_source_target(r_src, r_tgt, normals, vector, weights,
                                   blob_radius):
    """RPY-regularized Stokes double layer (finite blob radius
    corrections). Returns (Nt, 3)."""
    vector = vector.reshape(-1, 3)
    normals = normals.reshape(-1, 3)
    d = r_tgt[:, None, :] - r_src[None, :, :]
    r2 = torch.sum(d * d, dim=-1)
    skip = r2 <= 1e-28
    r2s = torch.where(skip, 1.0, r2)
    invr5 = 1.0 / (r2s * r2s * torch.sqrt(r2s))
    rn = torch.einsum("tsk,sk->ts", d, normals)
    rv = torch.einsum("tsk,sk->ts", d, vector)
    a2 = blob_radius * blob_radius
    w = weights[None, :]

    coeff = (1.0 - 10.0 * a2 / (3.0 * r2s)) * rn * rv * invr5 * w
    coeff = torch.where(skip, 0.0, coeff)
    u = torch.einsum("ts,tsk->tk", coeff, d)

    nv = torch.einsum("sk,sk->s", normals, vector)[None, :]
    c2 = torch.where(skip, 0.0, (2.0 * a2 / 3.0) * invr5 * w)
    u = u + torch.einsum("ts,tsk->tk", c2 * nv, d)
    u = u + torch.einsum("ts,sk->tk", c2 * rv, normals)
    u = u + torch.einsum("ts,sk->tk", c2 * rn, vector)
    return -3.0 / (4.0 * math.pi) * u


def double_layer_source_target(r_src, r_tgt, normals, vector, weights, *,
                               wall=False):
    """Stokes double layer u_i = -3/(4 pi) sum_j w_j r (r.n)(r.v)/r^5,
    plus the Gimbutas (2015) image system when wall=True. Self pairs
    (r < 1e-14) are skipped in the unbounded part. Returns (Nt, 3)."""
    vector = vector.reshape(-1, 3)
    normals = normals.reshape(-1, 3)
    d = r_tgt[:, None, :] - r_src[None, :, :]
    r2 = torch.sum(d * d, dim=-1)
    skip = r2 <= 1e-28
    r2s = torch.where(skip, 1.0, r2)
    invr5 = 1.0 / (r2s * r2s * torch.sqrt(r2s))
    rn = torch.einsum("tsk,sk->ts", d, normals)
    rv = torch.einsum("tsk,sk->ts", d, vector)
    coeff = torch.where(skip, 0.0, rn * rv * invr5 * weights[None, :])
    u = torch.einsum("ts,tsk->tk", coeff, d)

    if wall:
        rz = r_tgt[:, 2][:, None] + r_src[:, 2][None, :]
        d_img = torch.cat([d[..., :2], rz[..., None]], dim=-1)
        R2 = torch.sum(d_img * d_img, dim=-1)
        zero = R2 == 0.0
        R2s = torch.where(zero, 1.0, R2)
        invr = 1.0 / torch.sqrt(R2s)
        invr3 = torch.where(zero, 0.0, invr ** 3)
        invr5 = torch.where(zero, 0.0, invr ** 5)
        invR2 = 1.0 / R2s
        w = weights[None, :]

        # image stokes doublet with reflected z components
        rn_img = (d[..., 0] * normals[None, :, 0]
                  + d[..., 1] * normals[None, :, 1]
                  - rz * normals[None, :, 2])
        rv_img = (d[..., 0] * vector[None, :, 0]
                  + d[..., 1] * vector[None, :, 1]
                  - rz * vector[None, :, 2])
        coeff_img = rn_img * rv_img * invr5 * w
        u = u - torch.einsum("ts,tsk->tk", coeff_img, d_img)

        nv = torch.einsum("sk,sk->s", normals, vector)[None, :]
        zt = r_tgt[:, 2][:, None]
        hs = r_src[:, 2][None, :]

        # derivative dipole source
        ddx = -2 * zt * nv * (-d[..., 0] * rz * invR2) * w * invr3
        ddy = -2 * zt * nv * (-d[..., 1] * rz * invR2) * w * invr3
        ddz = -2 * zt * nv * (1.0 / 3.0 - rz * rz * invR2) * w * invr3
        # derivative quadrupole source
        vzI = -vector[None, :, 2]
        nzI = -normals[None, :, 2]
        qx = -2 * zt * hs * (d[..., 0] * nv + vector[None, :, 0] * rn_img
                             + normals[None, :, 0] * rv_img
                             - 5 * d[..., 0] * rv_img * rn_img * invR2
                             ) * w * invr5
        qy = -2 * zt * hs * (d[..., 1] * nv + vector[None, :, 1] * rn_img
                             + normals[None, :, 1] * rv_img
                             - 5 * d[..., 1] * rv_img * rn_img * invR2
                             ) * w * invr5
        qz = -2 * zt * hs * (rz * nv + vzI * rn_img + nzI * rv_img
                             - 5 * rz * rv_img * rn_img * invR2) * w * invr5
        # dipole + quadrupole sources (z only)
        dz2 = 2 * nv * rz * w * invr3 / 3.0
        qz2 = 2 * hs * (-nv / 3.0 + rv_img * rn_img * invR2) * w * invr3

        u = u + torch.stack([torch.sum(ddx + qx, dim=1),
                             torch.sum(ddy + qy, dim=1),
                             torch.sum(ddz + qz + dz2 + qz2, dim=1)], dim=-1)
    return -3.0 / (4.0 * math.pi) * u


def double_layer_dense(r_src, r_tgt, normals, weights):
    """Dense unbounded Stokes double-layer matrix (3Nt, 3Ns), the self
    blocks zero: body_mobility's double-layer slip correction."""
    normals = normals.reshape(-1, 3)
    d = r_tgt[:, None, :] - r_src[None, :, :]
    r2 = torch.sum(d * d, dim=-1)
    skip = r2 <= 1e-28
    r2s = torch.where(skip, 1.0, r2)
    invr5 = 1.0 / (r2s * r2s * torch.sqrt(r2s))
    rn = torch.einsum("tsk,sk->ts", d, normals)
    fac = torch.where(skip, 0.0, rn * weights[None, :] * invr5)
    blocks = fac[:, :, None, None] * d[:, :, :, None] * d[:, :, None, :]
    nt, ns = r_tgt.shape[0], r_src.shape[0]
    D = blocks.permute(0, 2, 1, 3).reshape(3 * nt, 3 * ns)
    return -3.0 / (4.0 * math.pi) * D
