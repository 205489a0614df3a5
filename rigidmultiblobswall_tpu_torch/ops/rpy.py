"""Pairwise RPY / Rotne-Prager-Blake mobility blocks (PyTorch).

Counterpart of rigidmultiblobswall_tpu/ops/rpy.py for the unbounded and
single-wall blocks of every coupling: `rpy_tt`, `rpy_rr`, `rpy_cross`,
`wall_tt`, `wall_rr`, `wall_rot_force`, `wall_trans_torque`, and the
different-radii blocks of the source-target product, `rpy_tt_radii` and
`wall_tt_radii` (physical units); the pseudo-periodic image boxes sum
these blocks over the boxes (ops/pair_kernels.py). The free-surface tt
block `free_surface_tt` (RPY plus its image reflected in the slip plane)
and the in-plane blocks `rpy_tt_in_plane`, `wall_tt_in_plane` (the z row
and column zeroed by `z_coupling_mask`).
Pure elementwise math mapping batched pair geometry to 3x3 blocks
(..., 3, 3), in units of the blob radius a (the radii blocks excepted);
callers apply 1/(8 pi eta a^k), k = 1 (tt), 2 (tr, rt), 3 (rr).

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


def rpy_rr(d, self_mask):
    """Rotation-rotation RPY block (units of 1/(8 pi eta a^3)).

    far (r>=2): c1 = -1/(2 r^3), c2 = 3/(2 r^5)
    near:       c1 = 1 - 27 r/32 + 5 r^3/64, c2 = 9/(32 r) - 3 r/64
    self:       I
    """
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    r2 = dx * dx + dy * dy + dz * dz
    zero = self_mask | (r2 == 0.0)
    r = _safe_r(r2, zero)
    invr = 1.0 / r
    invr2 = invr * invr
    invr3 = invr2 * invr

    far = r >= 2.0
    c1 = torch.where(far, -0.5 * invr3,
                     1.0 - 0.84375 * r + 0.078125 * (r2 * r))
    c2 = torch.where(far, 1.5 * invr2 * invr3, 0.28125 * invr - 0.046875 * r)
    c1 = torch.where(zero, 0.0, c1)
    c2 = torch.where(zero, 0.0, c2)
    diag_self = self_mask.to(c1.dtype)

    mxx = c1 + c2 * dx * dx + diag_self
    myy = c1 + c2 * dy * dy + diag_self
    mzz = c1 + c2 * dz * dz + diag_self
    return _sym3(mxx, c2 * dx * dy, c2 * dx * dz, myy, c2 * dy * dz, mzz)


def rpy_cross(d, self_mask):
    """Trans-rot coupling block (units of 1/(8 pi eta a^2)), the same
    antisymmetric c [d x] for U from T and for W from F.

    far (r>=2): c = 1/r^3
    near:       c = (1 - 3r/8)/2
    self:       0
    """
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    r2 = dx * dx + dy * dy + dz * dz
    zero = self_mask | (r2 == 0.0)
    r = _safe_r(r2, zero)
    invr3 = 1.0 / (r2 * r + zero.to(r.dtype))
    c = torch.where(r >= 2.0, invr3, 0.5 * (1.0 - 0.375 * r))
    c = torch.where(zero, 0.0, c)
    zeros = torch.zeros_like(c)
    mxy = c * dz
    mxz = -c * dy
    myz = c * dx
    return _mat3((zeros, mxy, mxz, -mxy, zeros, myz, -mxz, -myz, zeros))


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


def _wall_cross_core(dx, dy, rz, h):
    """Wall trans-torque correction in the UT component pattern (the
    block is M -= corr); the rot-force pattern is its transpose. h is the
    height argument in units of a."""
    R2 = dx * dx + dy * dy + rz * rz
    invR = 1.0 / torch.sqrt(torch.where(R2 == 0.0, torch.ones_like(R2), R2))
    invR2 = invR * invR
    invR4 = invR2 * invR2
    ex = dx * invR
    ey = dy * invR
    ez = rz * invR
    h_hat = h / rz

    f1 = invR2
    f2 = (6.0 * h_hat * ez * ez * invR2 + (1.0 - 10.0 * ez * ez) * invR4) * 2.0
    f3 = -ez * (3.0 * h_hat * invR2 - 5.0 * invR4) * 2.0
    f4 = -ez * (h_hat * invR2 - invR4) * 2.0

    cxx = -f3 * ex * ey
    cxy = -f1 * ez + f3 * ex * ex - f4
    cxz = f1 * ey
    cyx = f1 * ez - f3 * ey * ey + f4
    cyy = f3 * ex * ey
    cyz = -f1 * ex
    czx = -f1 * ey - f2 * ey - f3 * ey * ez
    czy = f1 * ex + f2 * ex + f3 * ex * ez
    return _mat3((cxx, cxy, cxz, cyx, cyy, cyz, czx, czy,
                  torch.zeros_like(f1)))


def _cross_self(corr, self_mask, h, sign):
    """Replace self pairs by the antisymmetric xy self coupling
    sign * z^-4 / 8 (Mxy = +s, Myx = -s)."""
    inv_z = 1.0 / torch.where(self_mask, h, torch.ones_like(h))
    s = sign * 0.125 * inv_z ** 4
    zero = torch.zeros_like(s)
    self_block = _mat3((zero, s, zero, -s, zero, zero, zero, zero, zero))
    return torch.where(self_mask[..., None, None], self_block, corr)


def wall_rot_force(dx, dy, rz, hs, self_mask):
    """Wall correction for the rot-trans block (W_i from F_j): the
    transposed UT pattern at the source height hs = z_source/a, subtracted;
    self pairs take Mxy = -z^-4/8."""
    corr = -_wall_cross_core(dx, dy, rz, hs).transpose(-1, -2)
    return _cross_self(corr, self_mask, hs, -1.0)


def wall_trans_torque(dx, dy, rz, ht, self_mask):
    """Wall correction for the trans-rot block (U_i from T_j): the UT
    pattern at the reflected in-plane displacement and the target height
    ht = z_target/a, subtracted; self pairs take Mxy = +z^-4/8."""
    corr = -_wall_cross_core(-dx, -dy, rz, ht)
    return _cross_self(corr, self_mask, ht, 1.0)


def wall_rr(dx, dy, rz, hs, self_mask):
    """Wall correction for the rotation-rotation block; hs = z_source/a
    enters only the self term (-5/16 z^-3 in-plane, -1/8 z^-3 along z)."""
    inv_z = 1.0 / torch.where(self_mask, hs, torch.ones_like(hs))
    inv_z3 = inv_z ** 3
    self_xx = -inv_z3 * 0.3125
    self_zz = -inv_z3 * 0.125

    R2 = dx * dx + dy * dy + rz * rz
    invR = 1.0 / _safe_r(R2, self_mask)
    invR3 = invR * invR * invR
    ex = dx * invR
    ey = dy * invR
    ez = rz * invR

    f1 = (1.0 - 6.0 * ez * ez) * invR3 * 0.5
    f2 = -1.5 * invR3
    f3 = 3.0 * invR3 * ez
    f4 = 3.0 * invR3

    sm = self_mask
    zero = torch.zeros_like(f1)
    mxx = torch.where(sm, self_xx, f1 + f2 * ex * ex + f4 * ey * ey)
    myy = torch.where(sm, self_xx, f1 + f2 * ey * ey + f4 * ex * ex)
    mzz = torch.where(sm, self_zz, f1 + f2 * ez * ez + f3 * ez)
    mxy = torch.where(sm, zero, (f2 - f4) * ex * ey)
    mxz = torch.where(sm, zero, f2 * ex * ez)
    myz = torch.where(sm, zero, f2 * ey * ez)
    mzx = torch.where(sm, zero, f2 * ez * ex + f3 * ex)
    mzy = torch.where(sm, zero, f2 * ez * ey + f3 * ey)
    return _mat3((mxx, mxy, mxz, mxy, myy, myz, mzx, mzy, mzz))


# ---------------------------------------------------------------------------
# Different radii (source radius b, target radius a), physical units,
# prefactor 1/(8 pi eta): the source-target product of velocity fields
# (ops/mobility.py source_target_matvec)
# ---------------------------------------------------------------------------


def rpy_tt_radii(d, a_tgt, b_src):
    """TT block for blobs of different radii; d is the PHYSICAL displacement
    (target - source), a_tgt/b_src broadcastable radii."""
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    r2_raw = dx * dx + dy * dy + dz * dz
    zero = r2_raw == 0.0
    # safe denominators; zero pairs take the near branch
    r2 = torch.where(zero, 1.0, r2_raw)
    r = torch.sqrt(r2)
    r3 = r2 * r
    a = a_tgt
    b = b_src
    a2 = a * a
    b2 = b * b
    s2 = a2 + b2

    c1_far = (1.0 + s2 / (3.0 * r2)) / r
    c2_far = ((1.0 - s2 / r2) / r2) / r
    four_thirds = 4.0 / 3.0
    dd2 = (b - a) ** 2
    c1_mid = ((16.0 * (b + a) * r3 - (dd2 + 3.0 * r2) ** 2)
              / (32.0 * r3)) * four_thirds / (b * a)
    c2_mid = (((3.0 * (dd2 - r2) ** 2 / (32.0 * r3)) / r2) * four_thirds
              / (b * a))
    c1_near = four_thirds / torch.maximum(a, b)

    far = (~zero) & (r > (a + b))
    mid = (~zero) & (~far) & (r > torch.abs(b - a))
    c1 = torch.where(far, c1_far, torch.where(mid, c1_mid, c1_near))
    c2 = torch.where(far, c2_far, torch.where(mid, c2_mid, 0.0))

    mxx = c1 + c2 * dx * dx
    myy = c1 + c2 * dy * dy
    mzz = c1 + c2 * dz * dz
    mxy = c2 * dx * dy
    mxz = c2 * dx * dz
    myz = c2 * dy * dz
    return _sym3(mxx, mxy, mxz, myy, myz, mzz)


def wall_tt_radii(dx, dy, rz, x3, y3, a_tgt, b_src):
    """Finite-size wall image correction for different radii, physical
    units. dx, dy: in-plane displacement;
    rz = z_tgt + z_src; x3 = z_tgt; y3 = z_src."""
    a2 = a_tgt * a_tgt
    b2 = b_src * b_src
    r2 = dx * dx + dy * dy + rz * rz
    r = torch.sqrt(torch.where(r2 == 0.0, 1.0, r2))
    inv_r = 1.0 / r
    inv_r2 = inv_r * inv_r
    inv_r3 = inv_r2 * inv_r
    inv_r5 = inv_r3 * inv_r2
    inv_r7 = inv_r5 * inv_r2
    inv_r9 = inv_r7 * inv_r2
    s2 = a2 + b2

    # term 1: image RPY-like (negated stokeslet with sign flips on z column)
    t1c1 = (1.0 + s2 / (3.0 * r2)) * inv_r
    t1c2 = (1.0 - s2 / r2) * inv_r2 * inv_r
    xx = -(t1c1 + t1c2 * dx * dx)
    xy = -(t1c2 * dx * dy)
    xz = +(t1c2 * dx * rz)
    yx = -(t1c2 * dy * dx)
    yy = -(t1c1 + t1c2 * dy * dy)
    yz = +(t1c2 * dy * rz)
    zx = -(t1c2 * rz * dx)
    zy = -(t1c2 * rz * dy)
    zz = +(t1c1 + t1c2 * rz * rz)

    # term 2: Stokes doublet + source dipole pieces with x3*y3 prefactor
    xy3 = x3 * y3
    xx += -2.0 * (xy3 * (inv_r3 - 3.0 * dx * dx * inv_r5))
    xy += -2.0 * (xy3 * (-3.0 * dx * dy * inv_r5))
    xz += 2.0 * (-dx * x3 * inv_r3 + xy3 * (-3.0 * dx * rz * inv_r5))
    yx += -2.0 * (xy3 * (-3.0 * dy * dx * inv_r5))
    yy += -2.0 * (xy3 * (inv_r3 - 3.0 * dy * dy * inv_r5))
    yz += 2.0 * (-dy * x3 * inv_r3 + xy3 * (-3.0 * dy * rz * inv_r5))
    zx += -2.0 * (-y3 * dx * inv_r3 + xy3 * (-3.0 * rz * dx * inv_r5))
    zy += -2.0 * (-y3 * dy * inv_r3 + xy3 * (-3.0 * rz * dy * inv_r5))
    zz += 2.0 * (-inv_r - rz * x3 * inv_r3 - y3 * rz * inv_r3
                 + xy3 * (inv_r3 - 3.0 * rz * rz * inv_r5))

    # term 3: finite-size (a^2) correction
    ca = 2.0 * a2 / 3.0
    xx += -ca * (-y3 * (3.0 * rz * inv_r5 - 15.0 * rz * dx * dx * inv_r7))
    xy += -ca * (-y3 * (-15.0 * rz * dx * dy * inv_r7))
    xz += ca * (3.0 * dx * rz * inv_r5
                - y3 * (3.0 * dx * inv_r5 - 15.0 * rz * dx * rz * inv_r7))
    yx += -ca * (-y3 * (-15.0 * rz * dy * dx * inv_r7))
    yy += -ca * (-y3 * (3.0 * rz * inv_r5 - 15.0 * rz * dy * dy * inv_r7))
    yz += ca * (3.0 * dy * rz * inv_r5
                - y3 * (3.0 * dy * inv_r5 - 15.0 * rz * dy * rz * inv_r7))
    zx += -ca * (-y3 * (3.0 * dx * inv_r5 - 15.0 * rz * rz * dx * inv_r7))
    zy += -ca * (-y3 * (3.0 * dy * inv_r5 - 15.0 * rz * rz * dy * inv_r7))
    zz += ca * (-inv_r3 + 3.0 * rz * rz * inv_r5
                - y3 * (9.0 * rz * inv_r5 - 15.0 * rz**3 * inv_r7))

    # term 4: finite-size (b^2) correction
    cb = 2.0 * b2 / 3.0
    xx += -cb * (-x3 * (3.0 * rz * inv_r5 - 15.0 * rz * dx * dx * inv_r7))
    xy += -cb * (-x3 * (-15.0 * rz * dx * dy * inv_r7))
    xz += cb * (-x3 * (3.0 * dx * inv_r5 - 15.0 * rz * dx * rz * inv_r7))
    yx += -cb * (-x3 * (-15.0 * rz * dy * dx * inv_r7))
    yy += -cb * (-x3 * (3.0 * rz * inv_r5 - 15.0 * rz * dy * dy * inv_r7))
    yz += cb * (-x3 * (3.0 * dy * inv_r5 - 15.0 * rz * dy * rz * inv_r7))
    zx += -cb * (3.0 * rz * dx * inv_r5
                 - x3 * (3.0 * dx * inv_r5 - 15.0 * rz * rz * dx * inv_r7))
    zy += -cb * (3.0 * rz * dy * inv_r5
                 - x3 * (3.0 * dy * inv_r5 - 15.0 * rz * rz * dy * inv_r7))
    zz += cb * (-inv_r3 + 3.0 * rz * rz * inv_r5
                - x3 * (9.0 * rz * inv_r5 - 15.0 * rz**3 * inv_r7))

    # term 5: a^2 b^2 source-dipole-of-image correction
    cab = 2.0 * a2 * b2 / 3.0
    xx += -cab * (-inv_r5 + 5.0 * rz * rz * inv_r7 + 5.0 * dx * dx * inv_r7
                  - 35.0 * rz * rz * dx * dx * inv_r9)
    xy += -cab * (5.0 * dx * dy * inv_r7 - 35.0 * rz * rz * dx * dy * inv_r9)
    xz += cab * (15.0 * dx * rz * inv_r7 - 35.0 * rz**3 * dx * inv_r9)
    yx += -cab * (5.0 * dy * dx * inv_r7 - 35.0 * rz * rz * dy * dx * inv_r9)
    yy += -cab * (-inv_r5 + 5.0 * rz * rz * inv_r7 + 5.0 * dy * dy * inv_r7
                  - 35.0 * rz * rz * dy * dy * inv_r9)
    yz += cab * (15.0 * dy * rz * inv_r7 - 35.0 * rz**3 * dy * inv_r9)
    zx += -cab * (15.0 * rz * dx * inv_r7 - 35.0 * rz**3 * dx * inv_r9)
    zy += -cab * (15.0 * rz * dy * inv_r7 - 35.0 * rz**3 * dy * inv_r9)
    zz += cab * (-3.0 * inv_r5 + 30.0 * rz * rz * inv_r7
                 - 35.0 * rz**4 * inv_r9)

    return _mat3((xx, xy, xz, yx, yy, yz, zx, zy, zz))


def free_surface_tt(d, rz_img, self_mask):
    """TT block above a free surface (a slip plane at z = 0): RPY plus its
    image with the z column reflected, M += M_RPY(d_img) diag(1, 1, -1),
    d_img = (dx, dy, rz_img), rz_img = (z_t + z_s)/a. The image applies to
    the self pair too; an image at d_img = 0 is a coincident pair (0)."""
    m = rpy_tt(d, self_mask)
    d_img = torch.cat([d[..., :2], rz_img[..., None].expand_as(d[..., :1])],
                      dim=-1)
    m_img = rpy_tt(d_img, torch.zeros_like(self_mask))
    refl = torch.tensor([1.0, 1.0, -1.0], dtype=m.dtype, device=m.device)
    return m + m_img * refl


def z_coupling_mask(dtype, device=None):
    """(3, 3) ones with the z row and the z column zeroed: the in-plane
    domain's blocks are P M P with P = diag(1, 1, 0)."""
    mask = torch.ones((3, 3), dtype=dtype, device=device)
    mask[2, :] = 0.0
    mask[:, 2] = 0.0
    return mask


def rpy_tt_in_plane(d, self_mask):
    """TT block with the z row and column zeroed (the reference's in-plane
    product forces u_z = 0)."""
    m = rpy_tt(d, self_mask)
    return m * z_coupling_mask(m.dtype, m.device)


def wall_tt_in_plane(dx, dy, rz, hs, self_mask):
    """Wall TT correction with the z couplings zeroed; the self term
    corrects the xx and yy components only."""
    m = wall_tt(dx, dy, rz, hs, self_mask)
    return m * z_coupling_mask(m.dtype, m.device)
