"""Pairwise RPY / Rotne-Prager-Blake translation blocks (PyTorch).

Counterpart of rigidmultiblobswall_tpu/ops/rpy.py (`_safe_r`, `_sym3`,
`_mat3`, `rpy_tt`, `wall_tt`); the other couplings are still to be
ported. Pure elementwise math mapping batched pair geometry to 3x3
blocks (..., 3, 3), in units of the blob radius a; callers apply
1/(8 pi eta a).

Conventions: `d` is (r_target - r_source)/a; `self_mask` marks a blob
paired with itself; wall corrections take the in-plane displacement,
the image distance rz = (z_target + z_source)/a and the source height
hs = z_source/a, with the wall at z = 0.
"""

from __future__ import annotations

import torch


def _safe_r(r2, mask_zero):
    """sqrt(r2) with masked entries replaced by 1."""
    return torch.sqrt(torch.where(mask_zero, torch.ones_like(r2), r2))


def _sym3(mxx, mxy, mxz, myy, myz, mzz):
    return torch.stack([
        torch.stack([mxx, mxy, mxz], dim=-1),
        torch.stack([mxy, myy, myz], dim=-1),
        torch.stack([mxz, myz, mzz], dim=-1),
    ], dim=-2)


def _mat3(rows9):
    xx, xy, xz, yx, yy, yz, zx, zy, zz = rows9
    return torch.stack([
        torch.stack([xx, xy, xz], dim=-1),
        torch.stack([yx, yy, yz], dim=-1),
        torch.stack([zx, zy, zz], dim=-1),
    ], dim=-2)


def rpy_tt(d, self_mask):
    """Translation-translation RPY block (units of 1/(8 pi eta a)).

    far (r>2):  (c1 I + c2 d d), c1 = (1 + 2/(3 r^2))/r,
                c2 = (1 - 2/r^2)/r^3
    near:       c1 = 4/3 (1 - 9r/32), c2 = (4/3)(3/32)/r
    self:       4/3 I
    """
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    r2 = dx * dx + dy * dy + dz * dz
    zero = self_mask | (r2 == 0.0)
    r = _safe_r(r2, zero)
    invr = 1.0 / r
    invr2 = invr * invr

    four_thirds = 4.0 / 3.0
    far = r > 2.0
    c1 = torch.where(far, (1.0 + (2.0 / 3.0) * invr2) * invr,
                     four_thirds * (1.0 - 0.28125 * r))
    c2 = torch.where(far, (1.0 - 2.0 * invr2) * invr2 * invr,
                     four_thirds * 0.09375 * invr)
    c1 = torch.where(zero, 0.0, c1)
    c2 = torch.where(zero, 0.0, c2)
    diag_self = self_mask.to(c1.dtype) * four_thirds

    mxx = c1 + c2 * dx * dx + diag_self
    myy = c1 + c2 * dy * dy + diag_self
    mzz = c1 + c2 * dz * dz + diag_self
    return _sym3(mxx, c2 * dx * dy, c2 * dx * dz, myy, c2 * dy * dz, mzz)


def wall_tt(dx, dy, rz, hs, self_mask):
    """Swan-Brady wall correction to the translation-translation block.

    Self terms use the 1/z expansions, pair terms the scalar set
    f1..f5 of the image system."""
    inv_z = 1.0 / torch.where(self_mask, hs, torch.ones_like(hs))
    inv_z3 = inv_z ** 3
    inv_z5 = inv_z3 * inv_z * inv_z
    self_xx = -(9.0 * inv_z - 2.0 * inv_z3 + inv_z5) / 12.0
    self_zz = -(9.0 * inv_z - 4.0 * inv_z3 + inv_z5) / 6.0

    R2 = dx * dx + dy * dy + rz * rz
    invR = 1.0 / _safe_r(R2, self_mask)
    ex = dx * invR
    ey = dy * invR
    ez = rz * invR
    invR3 = invR * invR * invR
    invR5 = invR3 * invR * invR
    h_hat = hs / rz
    hh = h_hat * (1.0 - h_hat)
    ez2 = ez * ez

    f1 = -(3.0 * (1.0 + 2.0 * hh * ez2) * invR
           + 2.0 * (1.0 - 3.0 * ez2) * invR3
           - 2.0 * (1.0 - 5.0 * ez2) * invR5) / 3.0
    f2 = -(3.0 * (1.0 - 6.0 * hh * ez2) * invR
           - 6.0 * (1.0 - 5.0 * ez2) * invR3
           + 10.0 * (1.0 - 7.0 * ez2) * invR5) / 3.0
    f3 = ez * (3.0 * h_hat * (1.0 - 6.0 * (1.0 - h_hat) * ez2) * invR
               - 6.0 * (1.0 - 5.0 * ez2) * invR3
               + 10.0 * (2.0 - 7.0 * ez2) * invR5) * 2.0 / 3.0
    f4 = ez * (3.0 * h_hat * invR - 10.0 * invR5) * 2.0 / 3.0
    f5 = -(3.0 * h_hat * h_hat * ez2 * invR + 3.0 * ez2 * invR3
           + (2.0 - 15.0 * ez2) * invR5) * 4.0 / 3.0

    sm = self_mask
    zero = torch.zeros_like(f1)
    mxx = torch.where(sm, self_xx, f1 + f2 * ex * ex)
    myy = torch.where(sm, self_xx, f1 + f2 * ey * ey)
    mzz = torch.where(sm, self_zz, f1 + f2 * ez * ez + f3 * ez + f4 * ez + f5)
    mxy = torch.where(sm, zero, f2 * ex * ey)
    mxz = torch.where(sm, zero, f2 * ex * ez + f3 * ex)
    myz = torch.where(sm, zero, f2 * ey * ez + f3 * ey)
    mzx = torch.where(sm, zero, f2 * ez * ex + f4 * ex)
    mzy = torch.where(sm, zero, f2 * ez * ey + f4 * ey)
    return _mat3((mxx, mxy, mxz, mxy, myy, myz, mzx, mzy, mzz))
