"""Rot-coupling (grand mobility) stage of the spectral single-wall engine
(PyTorch): the tr, rt and rr blocks of single-blob bodies, beside the tt
block of ops/ewald_wall.py, for the rollers' domain
'single_wall_spectral'.

Counterpart of rigidmultiblobswall_tpu/ops/ewald_wall_rot.py. The
mathematics (see the JAX module's docstring), with the same Hasimoto
screen xi as the tt engine:

* Pair parts, real sources only: the cross block u = gamma(r) (t x d),
  w = gamma(r) (f x d) and the rr block w = alpha t + beta (r^.t) r^.
  Wave multipliers +i (k x .) sinc(ka) w_r(ka) phi / (2 eta k^2) and
  (w_r(ka)^2 phi / (4 eta)) (I - k^k^); near remainders gamma_r, alpha_r,
  beta_r from a two-piece Chebyshev fit (_host_cheb_rot).
* Image channels, real target and image source: rt w += (C0 + h_src C1) f,
  tr u += the transposed-reflected rt at h_TARGET, rr w += a
  height-independent channel; the near remainders evaluate the generated
  img_terms_rt / _tr / _rr on the tt engine's screened image series, the
  wave parts the generated mult_terms_rt / _tr / _rr at scaled wavenumbers
  k a.
* Wrap correction: the tt engine's polish-mode set, with the rot Toeplitz
  kernels of wall_kernels.build_polish_kernels_rot on the column profiles
  of the five input fields.
* Overlap regularization: inputs and outputs damped by B = min(z/a, 1),
  heights shifted to z >= a at plan build, as the direct grand engine.

The near field is kernel K8 (ops/cell_kernels.wall_rot_near) on the wall
plan's cells. The wave side follows the port's tt engine: complex tensors,
z transformed with torch.fft over the padded axis restricted to the
occupied planes (no z-DFT matrices), and the image channels' multipliers
formed once per params as the (nonzero) columns of the generated
mult_terms at unit channels.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Tuple

import numpy as np
import torch

from . import _wall_channels_gen as gen
from . import cell_kernels, ewald, wall_kernels
from . import ewald_wall as ew

__all__ = ["grand_matvec", "grand_near", "rot_tables", "rot_wave"]


# ---------------------------------------------------------------------------
# Host tables (numpy, cached per params; the cell capacity is not part of
# their key)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=16)
def _host_cheb_rot_cached(params: ew.WallParams):
    from numpy.polynomial import chebyshev as npcheb

    p = params
    edges = [(1e-9, 2.0 * p.a), (2.0 * p.a, p.r_cut)]
    for K in (24, 32, 40, 48):
        out = np.zeros((2, 3, K))
        err = 0.0
        for pidx, (lo, hi) in enumerate(edges):
            r = np.linspace(lo, hi, 3001)
            t = (2.0 * r - (hi + lo)) / (hi - lo)
            gamma, alpha, beta = ewald.rot_scalar_functions(r, p.a, p.eta)
            gw, cperp, cpar = ewald.rot_wave_freespace_scalars(
                r, p.a, p.eta, p.xi)
            rows = [gamma - gw, alpha - cperp, beta - (cpar - cperp)]
            for i, f in enumerate(rows):
                out[pidx, i] = npcheb.chebfit(t, f, K - 1)
                scale = max(np.abs(f).max(), 1e-30)
                err = max(err, np.abs(
                    npcheb.chebval(t, out[pidx, i]) - f).max() / scale)
        if err < max(5e-7, 0.02 * p.tol):
            break
    else:
        raise RuntimeError(f"rot near fit stalled at err {err}")
    _, _, _, _, self_rr = ewald.rot_realspace_tables(
        p.a, p.eta, p.xi, p.r_cut, n_points=64)
    return out, float(self_rr)


def _host_cheb_rot(params: ew.WallParams):
    """Two-piece Chebyshev fits (2, 3, K) of the pair rot near remainders
    over [0, 2a] and [2a, r_cut] (kink at touching), rows (gamma_r,
    alpha_r, beta_r), and the rr self coefficient. Physical units."""
    return _host_cheb_rot_cached(ew._key(params))


@functools.lru_cache(maxsize=8)
def _host_rot_polish_cached(params: ew.WallParams):
    gx, gy, gz = params.grid
    hx, hy, hz = params.spacing
    kx, ky, _ = ew._axis_freqs(params)
    margin = params.lz_box - params.data_extent
    idx, kxky = wall_kernels.polish_mode_set(gx, len(ky), kx, ky, margin,
                                             params.tol)
    wx = ewald._es_window_hat(np.abs(kxky[:, 0]),
                              0.5 * params.support * hx, params.es_beta)
    wy = ewald._es_window_hat(np.abs(kxky[:, 1]),
                              0.5 * params.support * hy, params.es_beta)
    circ = np.arange(2 * gz)
    circ = np.where(circ < gz, circ, circ - 2 * gz)
    kern = wall_kernels.build_polish_kernels_rot(
        kxky, circ * hz, a=params.a, eta=params.eta, xi=params.xi,
        hx=hx, hy=hy, hz=hz, support=params.support,
        es_beta=params.es_beta, what_x=wx, what_y=wy, tol=params.tol)
    kfft = np.fft.fft(kern, axis=-1)                  # (P, 8, 3, 3, 2gz)
    return (kfft.real.astype(np.float32).reshape(len(idx), 72, -1),
            kfft.imag.astype(np.float32).reshape(len(idx), 72, -1))


def _host_rot_polish(params: ew.WallParams):
    """The rot polish kernels' FFTs on the tt engine's mode set, (P, 72,
    2 gz) real and imaginary parts of (P, 8 channels, 3, 3, 2 gz). Rounded
    to float32 as the JAX package stores them, so that both packages apply
    the same kernels."""
    return _host_rot_polish_cached(ew._key(params))


# ---------------------------------------------------------------------------
# Device tables
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RotTables:
    """The rot stage's position-independent device constants."""

    cheb: torch.Tensor         # (2, 3, K) rot remainders (K8)
    self_rr: float
    polish: torch.Tensor       # (P, 8, 3, 3, 2 gz) complex
    pc: torch.Tensor           # (gx, gy2, gz) cross multiplier, polish cut
    pr: torch.Tensor           # (gx, gy2, gz) rr multiplier, polish cut
    # image channels' multipliers, the nonzero (out, in) columns of the
    # generated mult_terms_rt (out w, in (f, (h/a) f)), mult_terms_tr (out
    # (u0, u1), in t) and mult_terms_rr (out w, in t) at unit channels
    mult_rt: Tuple[Tuple[int, int, torch.Tensor], ...]
    mult_tr: Tuple[Tuple[int, int, torch.Tensor], ...]
    mult_rr: Tuple[Tuple[int, int, torch.Tensor], ...]

    def nbytes(self):
        grids = [self.polish, self.pc, self.pr] + [
            m for ms in (self.mult_rt, self.mult_tr, self.mult_rr)
            for _, _, m in ms]
        return sum(g.numel() * g.element_size() for g in grids)


def _columns(fn, n_in, args, dtype):
    """The nonzero columns (out, in, multiplier) of a generated k-space
    channel function that is linear in its n_in channel fields."""
    cdt = ew._complex_dtype(dtype)
    cols = []
    for j in range(n_in):
        unit = [0.0] * n_in
        unit[j] = 1.0
        for i, u in enumerate(fn(*args, *unit)):
            if torch.is_tensor(u) and bool(torch.any(u != 0)):
                cols.append((i, j, u.to(cdt).contiguous()))
    return tuple(cols)


@functools.lru_cache(maxsize=2)
def _rot_tables(params: ew.WallParams, dtype, device) -> RotTables:
    p = params
    cheb, self_rr = _host_cheb_rot(p)
    re, im = _host_rot_polish(p)
    gx, gy, gz = p.grid
    gy2 = gy // 2 + 1
    _, _, pol_mask = ew._host_polish(p)
    kx, ky, kz = (torch.as_tensor(k, dtype=dtype, device=device)
                  for k in ew._axis_freqs(p))
    KX = kx[:, None, None]
    KY = ky[None, :, None]
    KZ = kz[None, None, :]
    k2 = KX * KX + KY * KY + KZ * KZ
    live = k2 > 0
    k2s = torch.where(live, k2, torch.ones_like(k2))
    kk = torch.sqrt(k2s)
    phi = (1.0 + k2 / (4 * p.xi ** 2)) * torch.exp(-k2 / (4 * p.xi ** 2))
    sinc = torch.sin(kk * p.a) / (kk * p.a)
    x = kk * p.a
    small = x < 1e-4
    xs = torch.where(small, torch.ones_like(x), x)
    j1x = (torch.sin(xs) / xs - torch.cos(xs)) / (xs * xs)
    wr = torch.where(small, 1.0 - x * x / 10.0, 3.0 * j1x)
    h3 = float(np.prod(p.spacing))
    w2 = [torch.as_tensor(w, dtype=dtype, device=device) ** 2
          for w in ew._host_whats(p)]
    norm = h3 / (w2[0][:, None, None] * w2[1][None, :, None]
                 * w2[2][None, None, :])
    mask = torch.as_tensor(pol_mask, device=device).reshape(
        gx, gy2, 1).to(dtype)
    zero = torch.zeros((), dtype=dtype, device=device)
    pc = torch.where(live, sinc * wr * phi / (2 * p.eta * k2s) * norm * mask,
                     zero)
    pr = torch.where(live, wr * wr * phi / (4 * p.eta) * norm * mask, zero)
    # scaled-fit channels in physical k: W^_phys(k) = pref_n a^3 W~^(ak)
    # (the a^3 is the Fourier measure of the length rescaling)
    a = p.a
    pref_c = (1.0 / (8.0 * math.pi * p.eta * a * a)) * a ** 3
    pref_r = pref_c / a
    base = phi * norm * mask * (4.0 * math.pi) / (k2s * (a * a))
    F2c = torch.where(live, base * pref_c, zero)
    F2r = torch.where(live, base * pref_r, zero)
    ks = (KX * a, KY * a, KZ * a)
    return RotTables(
        cheb=torch.as_tensor(cheb, dtype=dtype, device=device).contiguous(),
        self_rr=float(self_rr),
        polish=torch.complex(
            torch.as_tensor(re, device=device),
            torch.as_tensor(im, device=device)).to(
                ew._complex_dtype(dtype)).reshape(re.shape[0], 8, 3, 3, -1),
        pc=pc, pr=pr,
        mult_rt=_columns(gen.mult_terms_rt, 6, (*ks, 0.0, F2c), dtype),
        mult_tr=_columns(gen.mult_terms_tr, 3, (*ks, 0.0, F2c), dtype),
        mult_rr=_columns(gen.mult_terms_rr, 3, (*ks, 0.0, F2r), dtype))


def rot_tables(params: ew.WallParams, dtype, device) -> RotTables:
    """The rot stage's device tables at params, in dtype on device: built
    once per params (host Chebyshev fit and polish kernels, the k-space
    multipliers) and carried by the caller (the rollers' carry)."""
    return _rot_tables(ew._key(params), dtype, torch.device(device))


# ---------------------------------------------------------------------------
# Near field (kernel K8)
# ---------------------------------------------------------------------------


def near_args(plan: ew.WallPlan, cheb):
    """Kernel K8's operands at this plan and rot remainder table cheb
    (RotTables.cheb), less the positions and the strengths: the positional
    arguments of cell_kernels.wall_rot_near and wall_rot_near_plain after
    (pos_all, f, t), and their keyword arguments (wall_rot_near also takes
    cz_range=ewald_wall._kept_layers(...))."""
    p = plan.params
    nt = plan.near_tables
    args = (plan.cell_table, plan.cell_dims, ew._bin_box(p, plan.cell_dims),
            p.cell_capacity, cheb, nt.img_cheb)
    pref_c = 1.0 / (8.0 * math.pi * p.eta * p.a * p.a)
    kw = dict(two_a=2.0 * p.a, r_cut=p.r_cut, z0=p.z0, a=p.a, pref_c=pref_c,
              pref_r=pref_c / p.a, img_range=nt.img_range)
    return args, kw


def grand_near(plan: ew.WallPlan, f, t, tables: RotTables, *, want_v=True,
               want_w=True):
    """Rot-block near field of damped f, t (N, 3), either None: the pair
    remainders of real sources and the screened image rot channels of
    image sources, by kernel K8, plus the rr self term. Returns (v, w),
    the tr part of the velocities and the rt + rr parts of the angular
    velocities; tt is not included. An output not asked for (want_v,
    want_w) is not formed: K8 runs only the products of the other, and the
    output returned in its place is zero."""
    args, kw = near_args(plan, tables.cheb)
    rows = cell_kernels.wall_rot_near(
        plan.pos_all, f, t, *args,
        cz_range=ew._kept_layers(plan.params, plan.cell_dims),
        want_v=want_v, want_w=want_w, **kw)
    v, w = rows[:, :3], rows[:, 3:]
    if t is not None and want_w:
        w = w + tables.self_rr * t
    return v, w


# ---------------------------------------------------------------------------
# Wave field
# ---------------------------------------------------------------------------


def _cross(pc, KX, KY, KZ, c):
    """+i (k x c) pc on k-space fields c (3, gx, gy2, gz)."""
    cx, cy, cz = c[0], c[1], c[2]
    return torch.stack([KY * cz - KZ * cy, KZ * cx - KX * cz,
                        KX * cy - KY * cx]) * (1j * pc)


def rot_wave(plan: ew.WallPlan, f, t, tables: RotTables, *, want_v=True,
             want_w=True):
    """Rot-block wave products of damped f, t (N, 3), either None: the pair
    cross and rr multipliers on the real sources, the generated image rot
    channels, the rot polish columns, inverse transforms onto the
    real-target planes and interpolation at the reals. Returns (v, w)
    without tt; an output not wanted is not formed and is None."""
    p = plan.params
    n = plan.n_real
    dtype = plan.pos_all.dtype
    gx, gy, gz = p.grid
    gy2 = gy // 2 + 1
    _, (ia, ib), (ra, rb) = ew._z_plane_ranges(p)
    nr = rb - ra
    pi = plan.tables.polish_idx
    khat = plan.tables.khat
    kx, ky, kz = (torch.as_tensor(k, dtype=dtype, device=plan.pos_all.device)
                  for k in ew._axis_freqs(p))
    KX, KY, KZ = kx[:, None, None], ky[None, :, None], kz[None, None, :]
    sub_real = plan._view(slice(0, n))
    sub_img = plan._view(slice(n, None))
    h_s = plan.heights[:, None] / p.a
    cdt = ew._complex_dtype(dtype)

    def field(sub, x, lo, hi):
        """Spread x (N, 3m) at sub, xy rfft of the planes [lo, hi): the
        k-space fields (3m, gx, gy2, gz) and the m polish profiles
        (3, P, gz)."""
        cxy = torch.fft.rfft2(ewald.spread(sub, x)[..., lo:hi], dim=(1, 2))
        return ew._zfft(cxy, lo, gz), [ew._profile(c, pi, lo, gz)
                                       for c in cxy.split(3)]

    def apply(acc, cols, ck):
        for i, j, m in cols:
            acc[i].addcmul_(m, ck[j])

    def zeros(c):
        return torch.zeros((c, gx, gy2, gz), dtype=cdt,
                           device=plan.pos_all.device)

    # k-space output fields: W (angular velocity) and, with torques, UV =
    # (V, V1), the velocity and the velocity that the target height h/a
    # scales at interpolation
    form_v = want_v and t is not None      # v comes from torques alone
    W = zeros(3) if want_w else None
    UV = zeros(6) if form_v else None
    # polish channel blocks: (output field, channel, input profile)
    blocks = []
    if f is not None and want_w:
        ck, (prof_c,) = field(sub_real, f, ra, rb)
        W += _cross(tables.pc, KX, KY, KZ, ck)
        # image rt channels: moments (f, (h/a) f) at the image points
        ck_b, (prof_b0, prof_b1) = field(
            sub_img, torch.cat([f, h_s * f], dim=1), ia, ib)
        apply(W, tables.mult_rt, ck_b)
        blocks += [("W", 2, prof_c), ("W", 5, prof_b0), ("W", 6, prof_b1)]
        del ck, ck_b
    if t is not None and (form_v or want_w):
        ck, (prof_d,) = field(sub_real, t, ra, rb)
        # image tr / rr channels from the image-spread torques
        ck_e, (prof_e,) = field(sub_img, t, ia, ib)
        if form_v:
            UV[:3] += _cross(tables.pc, KX, KY, KZ, ck)
            apply(UV, tables.mult_tr, ck_e)
            blocks += [("V", 0, prof_d), ("V", 3, prof_e), ("V1", 4, prof_e)]
        if want_w:
            kdott = torch.sum(khat * ck, dim=0, keepdim=True)
            W += tables.pr * (ck - khat * kdott)
            apply(W, tables.mult_rr, ck_e)
            blocks += [("W", 1, prof_d), ("W", 7, prof_e)]
        del ck, ck_e

    # the polish columns: dense z-convolutions by circular FFT, summed per
    # output field before the inverse transform
    names = ["V", "V1"] * form_v + ["W"] * want_w
    if not names:
        zero = torch.zeros((n, 3), dtype=dtype, device=plan.pos_all.device)
        return zero if want_v else None, None
    pol = {}
    for name, ch, prof in blocks:
        out_f = torch.einsum("pijL,jpL->ipL", tables.polish[:, ch],
                             torch.fft.fft(prof, n=2 * gz, dim=-1))
        pol[name] = pol[name] + out_f if name in pol else out_f
    acc = torch.cat([x for x in (UV, W) if x is not None])
    del UV, W
    Uacc = torch.fft.ifft(acc, dim=-1)[..., ra:rb].reshape(-1, gx * gy2, nr)
    del acc
    pout = torch.cat([torch.fft.ifft(pol[k], dim=-1)[..., ra:rb]
                      for k in names])
    Uacc[:, pi] += pout
    Ur = torch.fft.irfft2(Uacc.reshape(-1, gx, gy2, nr), s=(gx, gy),
                          dim=(1, 2))
    del Uacc
    U = Ur.new_zeros((Ur.shape[0], gx, gy, gz))
    U[..., ra:rb] = Ur
    out = ewald.interpolate(sub_real, U)             # (N, 3), (6) or (9)
    v = None
    if want_v:
        v = (out[:, 0:3] + h_s * out[:, 3:6] if form_v
             else torch.zeros_like(out[:, :3]))
    w = out[:, -3:] if want_w else None
    return v, w


# ---------------------------------------------------------------------------
# Grand product
# ---------------------------------------------------------------------------


def grand_matvec(plan: ew.WallPlan, f, t, tables: RotTables, *,
                 want_v=True, want_w=True):
    """(u, w) = M_grand (f, t) on the wall-spectral engine for single-blob
    bodies, f and t (N, 3) raw strengths or None: tt by
    ops/ewald_wall.matvec, the rot blocks by the near and wave stages
    above, with the overlap damping B on inputs and outputs. A caller that
    uses one output alone (the rr, tr and rt products) passes want_v or
    want_w False: tt, K8's products and the wave stage's fields of the
    other are then not formed, and that output is None."""
    dtype = plan.pos_all.dtype
    damp = plan.damp[:, None]
    fd = None if f is None else (f * damp).to(dtype)
    td = None if t is None else (t * damp).to(dtype)
    nv, nw = grand_near(plan, fd, td, tables, want_v=want_v, want_w=want_w)
    wv, ww = rot_wave(plan, fd, td, tables, want_v=want_v, want_w=want_w)
    v = w = None
    if want_v:
        v = damp * (nv + wv)
        if f is not None:
            v = v + ew.matvec(plan, f.to(dtype))
    if want_w:
        w = damp * (nw + ww)
    return v, w
