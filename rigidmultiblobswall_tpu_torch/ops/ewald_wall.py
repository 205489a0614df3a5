"""Spectral single-wall RPY mobility: the O(N log N) engine of domain
'single_wall_spectral' (PyTorch).

Counterpart of rigidmultiblobswall_tpu/ops/ewald_wall.py, one blob radius,
one device. The mathematics (see the JAX module's docstring):

* Image sources. The Swan-Brady wall correction is -RPY(R) D + T0(R) +
  h T1(R) + h^2 T2(R) (R the image displacement, h the source height, D =
  diag(1, 1, -1)). The image Stokeslet rides the sinc^2 RPY channel as
  sources -D f at the image points; T0..T2 are three more gridded
  channels with strengths h^m f and rational k-space multipliers (the
  generated `mult_terms`, ops/_wall_channels_gen.py).
* Aperiodic z: the FFT box is zero-padded in z; the few smallest
  in-plane modes ("polish" columns, k_par = 0 included), whose padded
  transform would wrap, are cut out of the multiplier and applied as
  dense z-convolutions built on the host from continuous-k_z quadrature
  (ops/wall_kernels.build_polish_kernels).
* Near field: the Hasimoto remainder of the combined real + image set
  (mirrored strengths at image rows) and the screened image channels of
  (real target, image source) pairs inside r_cut, summed by kernel K7
  (ops/cell_kernels.wall_near) over a linked-cell layout of the data slab
  plus one empty guard layer.
* Overlap regularization as in the reference: heights shift to z >= a
  at plan build and the product is damped B M(z_eff) B, B = min(z/a, 1).
* Brownian noise: the wave part is sampled in closed form per in-plane
  mode (wave_sqrt_noise, positive parts of the per-mode z-operators) and
  its defect Delta (wave_defect_matvec) joins the near field's Lanczos.

The host side (parameter choice, Chebyshev tables, polish kernels, noise
factors) is a numpy copy of the JAX package's, so both pick the same
grid, r_cut and tables. The JAX package's pre-gathered near-field layout,
its real/imaginary split of complex constants (a TPU runtime limit) and
its z-DFT matrices are not ported: the wave side keeps complex tensors
and transforms z with torch.fft over the padded axis, restricted to the
occupied planes as the JAX matrices are. The automatic near-field cell
capacity counts the binned cells (`auto_cell_capacity`), where the JAX
package takes a mean over the data slab's z layers and drops points of
a roller monolayer.

The multi-device product (a `mesh` of parallel/mesh.py on matvec and
matvec_multi; the JAX package's matvec_sharded): the near field's kept
(x, y) cell columns are shared across the ranks (kernel K7 over a column
range), and the wave field's x planes: each rank spreads its planes, the
y rFFT runs on its slab, a ky-padded all_to_all (gy // 2 + 1 padded to a
multiple of the ranks) makes x local, and each rank applies its ky slice
of the multipliers (the RPY projector, the image channels' T_m, whose
table a rank builds for its slice alone) and the z-convolutions of the
polish columns in its slice; the inverse mirrors it and each rank
interpolates from its planes. The near rows and the wave's rows of a
rank add into one partial that `all_reduce_sum` completes. The wave
stays replicated when gx does not divide into the ranks, as in the JAX
package (`REPLICATED_WAVE` counts those products). The noise sampler and
its defect take no mesh, as there.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import math
from typing import Tuple

import numpy as np
import torch

from . import _wall_channels_gen as gen
from . import cell_kernels, cells, ewald, wall_kernels
from ..parallel import mesh as mesh_mod

log = logging.getLogger(__name__)
# sharded products whose wave part ran replicated (gx not divisible)
REPLICATED_WAVE = {"grid": 0}

# z cell height in units of r_cut: the excess over 1.0 is drift slack
# shared between the plan refresh budget and binning robustness
Z_CELL_SLACK = 1.2


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class WallParams:
    """Static configuration of the wall engine for one
    (box_xy, slab, a, eta, accuracy)."""

    a: float
    eta: float
    box_xy: Tuple[float, float]
    z_hi: float                # top of the real-particle slab
    xi: float
    r_cut: float
    grid: Tuple[int, int, int]  # (gx, gy, gz) of the PADDED z box
    z0: float                  # physical z of grid plane 0 (negative)
    support: int = 9
    es_beta_factor: float = 0.98
    oversample: float = 1.5
    n_table: int = 2048
    # near-field slots per cell (0 = auto_cell_capacity at the plan's
    # first build; make_wall_plan stores the resolved value)
    cell_capacity: int = 0
    n_cheb: int = 0
    z_pad_factor: float = 2.0
    tol: float = 1e-4
    # z-Chebyshev orders of the closed-form wave noise sampler (0 = auto)
    noise_p: int = 0
    noise_pk: int = 0

    def noise_orders(self):
        """Resolved (p, pk) of the wave-noise factor tables (the JAX
        package's rule: the kernel's z content wants p up, the grid's
        resolution of the Chebyshev cardinal functions wants it down)."""
        s = math.sqrt(max(-math.log(0.02 * self.tol), 4.0))
        kz_eff = 2.0 * self.xi * s
        half = 0.5 * (self.z_hi - self.a)
        hz = self.spacing[2]
        p_need = int(math.ceil(kz_eff * half / math.pi)) + 8
        p_grid = 1 + int(math.pi * math.sqrt(2.0 * half / hz))
        p = self.noise_p or min(max(min(p_need, p_grid), 8), 40)
        pk = self.noise_pk or min(max(int(math.ceil(
            1.2 * kz_eff * 2.0 * self.z_hi / math.pi)) + 16, 32), 96)
        return p, pk

    @property
    def spacing(self):
        gx, gy, gz = self.grid
        Lx, Ly = self.box_xy
        return (Lx / gx, Ly / gy, self.lz_box / gz)

    @property
    def lz_box(self) -> float:
        """Padded z period (gz hz = z_pad_factor x the data extent)."""
        return self.grid[2] * self._hz

    @property
    def _hz(self) -> float:
        return self.z_pad_factor * (-2.0 * self.z0) / self.grid[2]

    @property
    def data_extent(self) -> float:
        return -2.0 * self.z0

    @property
    def es_beta(self):
        return (self.es_beta_factor * math.pi * self.support
                * (1.0 - 0.5 / self.oversample))

    def grid_params(self) -> ewald.EwaldParams:
        """An EwaldParams view of the padded box, for ops/ewald's
        spread and interpolate."""
        return ewald.EwaldParams(
            a=self.a, eta=self.eta,
            box=(self.box_xy[0], self.box_xy[1], self.lz_box),
            xi=self.xi, r_cut=self.r_cut, grid=self.grid,
            support=self.support, es_beta_factor=self.es_beta_factor,
            oversample=self.oversample, n_table=self.n_table,
            cell_capacity=max(self.cell_capacity, 1), n_cheb=self.n_cheb,
            tol=self.tol)


def default_wall_params(a, eta, box_xy, z_hi, *, tol=1e-4,
                        r_cut_factor=None, support=None, oversample=1.5,
                        grid_max=1024, z_pad_factor=1.8,
                        **kw) -> WallParams:
    """The JAX package's parameter heuristics: ewald.default_params with a
    wider split margin (the T1/T2 remainders carry polynomial prefactors)
    and a z grid over the padded slab [z0, z0 + pad LD], LD = 2 (z_hi +
    window), the pad the smallest in [z_pad_factor, 6] that keeps the
    polish set under ~4096 modes."""
    if support is None:
        support = int(min(max(math.ceil(
            (5.5 - math.log(0.3 * tol)) / 1.81), 6), 14))
    s = math.sqrt(max(-math.log(tol * 0.02), 6.0))
    Lx, Ly = (float(b) for b in box_xy)
    r_cut = (r_cut_factor if r_cut_factor is not None else 6.0) * a
    r_cut = min(r_cut, 0.45 * min(Lx, Ly))

    def _axes(rc):
        k_max = 2.0 * s * s / rc
        h = math.pi / (oversample * k_max)
        gx = max(ewald._round_up_grid(Lx / h), 8)
        gy = max(ewald._round_up_grid(Ly / h), 8)
        return gx, gy

    gx, gy = _axes(r_cut)
    if grid_max and max(gx, gy) > grid_max:
        r_cut = min(r_cut * max(gx, gy) / float(grid_max),
                    0.45 * min(Lx, Ly))
        gx, gy = _axes(r_cut)
    xi = s / r_cut
    hx = Lx / gx
    wz = 0.5 * support * hx + 2 * hx
    LD = 2.0 * (float(z_hi) + wz)
    kstar_num = math.log(1.0 / max(0.03 * tol, 1e-300)) + 5.0
    p_budget = 4096.0
    for _pad in (z_pad_factor, 2.5, 3.0, 4.0, 5.0, 6.0):
        if _pad < z_pad_factor:
            continue
        kstar = kstar_num / max((_pad - 1.0) * LD, 1e-30)
        p_est = Lx * Ly * kstar * kstar / (4.0 * math.pi ** 2) * math.pi
        z_pad_factor = _pad
        if p_est <= p_budget:
            break
    gz = max(ewald._round_up_grid(z_pad_factor * LD / hx,
                                  zslab_pm=max(int(support) - 1, 8)), 8)
    z0 = -0.5 * LD
    return WallParams(a=float(a), eta=float(eta), box_xy=(Lx, Ly),
                      z_hi=float(z_hi), xi=xi, r_cut=r_cut,
                      grid=(gx, gy, gz), z0=z0, support=int(support),
                      oversample=float(oversample),
                      z_pad_factor=float(z_pad_factor), tol=float(tol),
                      **kw)


# ---------------------------------------------------------------------------
# Host tables (numpy, cached per params; the cell capacity is not part of
# their key)
# ---------------------------------------------------------------------------


def _key(params: WallParams) -> WallParams:
    return dataclasses.replace(params, cell_capacity=0)


def _host_cheb_rpy(params: WallParams):
    """RPY remainder two-piece Chebyshev table (2, 2, K) and self term,
    the periodic engine's builder at the wall params' (a, eta, xi,
    r_cut)."""
    return ewald._host_cheb(_key(params).grid_params())


def _host_img_cheb(params: WallParams):
    """Scaled two-piece radial tables of the image-channel remainder:
    (coeffs (2, 10, K), r_lo, r_mid, r_hi) in units of a."""
    return wall_kernels.img_cheb_tables(params.xi * params.a, 1.8,
                                        params.r_cut / params.a,
                                        n_cheb=params.n_cheb,
                                        tol=0.02 * params.tol)


def _axis_freqs(params: WallParams):
    gx, gy, gz = params.grid
    hx, hy, hz = params.spacing
    return [2.0 * np.pi * np.fft.fftfreq(gx, d=hx),
            2.0 * np.pi * np.fft.rfftfreq(gy, d=hy),
            2.0 * np.pi * np.fft.fftfreq(gz, d=hz)]


@functools.lru_cache(maxsize=16)
def _host_whats_cached(params: WallParams):
    ks = _axis_freqs(params)
    return tuple(ewald._es_window_hat(np.abs(kd), 0.5 * params.support * hd,
                                      params.es_beta)
                 for kd, hd in zip(ks, params.spacing))


def _host_whats(params: WallParams):
    """Per-axis window transforms at the padded grid's frequencies."""
    return _host_whats_cached(_key(params))


@functools.lru_cache(maxsize=16)
def _host_polish_cached(params: WallParams):
    gx, gy, gz = params.grid
    hx, hy, hz = params.spacing
    kx, ky, kz = _axis_freqs(params)
    margin = params.lz_box - params.data_extent
    idx, kxky = wall_kernels.polish_mode_set(gx, len(ky), kx, ky, margin,
                                             params.tol)
    wx = ewald._es_window_hat(np.abs(kxky[:, 0]), 0.5 * params.support * hx,
                              params.es_beta)
    wy = ewald._es_window_hat(np.abs(kxky[:, 1]), 0.5 * params.support * hy,
                              params.es_beta)
    # circular delta layout: index d -> displacement delta_z
    circ = np.arange(2 * gz)
    circ = np.where(circ < gz, circ, circ - 2 * gz)
    kern = wall_kernels.build_polish_kernels(
        kxky, circ * hz, a=params.a, eta=params.eta, xi=params.xi,
        hx=hx, hy=hy, hz=hz, support=params.support,
        es_beta=params.es_beta, what_x=wx, what_y=wy, tol=params.tol)
    kfft = np.fft.fft(kern, axis=-1)                     # (P,4,3,3,2gz)
    mask = np.ones(gx * len(ky), bool)
    mask[idx] = False                                    # False AT polish
    return idx, kfft, mask


def _host_polish(params: WallParams):
    """Polish mode set (flat (gx, gy2) indices), the circular Toeplitz
    kernel FFTs (P, 4 channels, 3, 3, 2 gz) and the multiplier mask."""
    return _host_polish_cached(_key(params))


def _z_plane_ranges(p: WallParams):
    """Occupied z-plane ranges [lo, hi) of the padded grid: `data` covers
    every spread source's window (real + image), `img` the image sources,
    `real` the planes the real-target interpolation reads."""
    gz = p.grid[2]
    hz = p.spacing[2]
    R = 0.5 * p.support * hz + 2.0 * hz
    half = 0.5 * p.data_extent

    def rng(z_lo, z_hi):
        lo = max(int(math.floor(z_lo / hz)), 0)
        hi = min(int(math.ceil(z_hi / hz)) + 1, gz)
        return lo, hi

    data = rng(half - p.z_hi - R, half + p.z_hi + R)
    img = rng(half - p.z_hi - R, half - p.a + R)
    real = rng(half + p.a - R, half + p.z_hi + R)
    return data, img, real


@functools.lru_cache(maxsize=8)
def _host_noise_tables_cached(params: WallParams):
    from numpy.polynomial import chebyshev as npcheb

    p = params
    pz, pk = p.noise_orders()
    # z-Chebyshev nodes (2nd kind, endpoints included) on [a, z_hi]
    mid_z = 0.5 * (p.z_hi + p.a)
    half_z = 0.5 * (p.z_hi - p.a)
    tcheb = np.cos(np.pi * np.arange(pz) / (pz - 1))
    z_nodes = mid_z + half_z * tcheb
    bary_w = np.ones(pz)
    bary_w[1::2] = -1.0
    bary_w[0] *= 0.5
    bary_w[-1] *= 0.5

    # retained modes: the screen survives 0.05 tol
    ln_t = math.log(20.0 / p.tol)
    u = ln_t
    for _ in range(20):
        u = ln_t + math.log1p(u)
    k_cut = 2.0 * p.xi * math.sqrt(u)
    kx, ky, _ = _axis_freqs(p)
    kpar = np.sqrt(kx[:, None] ** 2 + ky[None, :] ** 2)
    sel = kpar <= k_cut
    idx = np.nonzero(sel.ravel())[0].astype(np.int32)
    kxm = np.broadcast_to(kx[:, None], kpar.shape).ravel()[idx]
    kym = np.broadcast_to(ky[None, :], kpar.shape).ravel()[idx]
    kpm = kpar.ravel()[idx]
    kp_safe = np.where(kpm > 0, kpm, 1.0)
    cosm = np.where(kpm > 0, kxm / kp_safe, 1.0)
    sinm = np.where(kpm > 0, kym / kp_safe, 0.0)
    hx, hy, hz = p.spacing
    wxh = ewald._es_window_hat(np.abs(kxm), 0.5 * p.support * hx, p.es_beta)
    wyh = ewald._es_window_hat(np.abs(kym), 0.5 * p.support * hy, p.es_beta)
    scale = math.sqrt(hx * hy) / (wxh * wyh)

    # kernel tables at pk Chebyshev k_par nodes -> Chebyshev coefficients
    tk = np.cos(np.pi * (2 * np.arange(pk) + 1) / (2 * pk))
    kq = 0.5 * k_cut * (tk + 1.0)
    G = wall_kernels.wave_zkernel_nodes(kq, z_nodes, a=p.a, eta=p.eta,
                                        xi=p.xi)
    il = np.arange(pz)
    it = pz + il
    iz = 2 * pz + il
    ilz = np.concatenate([il, iz])
    G_lz = G[:, ilz[:, None], ilz[None, :]]
    G_t = G[:, it[:, None], it[None, :]]
    ridge = 1e-5 * max(float(np.abs(np.diagonal(
        G, axis1=1, axis2=2)).max()), 1e-30)
    C_lz = npcheb.chebfit(tk, G_lz.reshape(pk, -1), pk - 1)
    C_t = npcheb.chebfit(tk, G_t.reshape(pk, -1), pk - 1)

    # chi: z-window deconvolution table (the engine's interpolation then
    # evaluates the Chebyshev cardinal functions through its z windows)
    gz = p.grid[2]
    R = 0.5 * p.support * hz
    zs = np.linspace(p.a, p.z_hi, 40 * pz)
    zeta = zs - p.z0
    pz_grid = np.arange(gz) * hz
    dzm = zeta[:, None] - pz_grid[None, :]
    t_w = np.clip(dzm / R, -1.0, 1.0)
    W = np.where(np.abs(dzm) <= R,
                 np.exp(p.es_beta * (np.sqrt(np.maximum(1 - t_w ** 2, 0.0))
                                     - 1.0)), 0.0)
    cols = np.nonzero(W.any(axis=0))[0]
    ts = (zs - mid_z) / half_z
    diff = ts[:, None] - tcheb[None, :]
    exact = diff == 0.0
    diff = np.where(exact, 1.0, diff)
    terms = bary_w[None, :] / diff
    L_vals = terms / terms.sum(axis=1, keepdims=True)
    L_vals = np.where(exact.any(axis=1, keepdims=True), exact.astype(float),
                      L_vals)
    chi_sub, *_ = np.linalg.lstsq(W[:, cols], L_vals, rcond=None)
    resid = np.abs(W[:, cols] @ chi_sub - L_vals).max()
    chi = np.zeros((gz, pz))
    chi[cols] = chi_sub
    return dict(p=pz, z_nodes=z_nodes, bary_w=bary_w, mid_z=mid_z,
                half_z=half_z,
                mode_idx=idx, cos=cosm.astype(np.float64),
                sin=sinm.astype(np.float64), kpar=kpm, k_cut=k_cut,
                scale=scale, C_lz=C_lz, C_t=C_t, ridge=ridge, chi=chi.T,
                chi_resid=float(resid))


def _host_noise_tables(params: WallParams):
    """Host tables of the closed-form wave-noise sampler: z-Chebyshev
    nodes, the retained in-plane modes with their rotations and scales,
    Chebyshev-in-k_par coefficients of the per-mode z-kernels
    (wall_kernels.wave_zkernel_nodes) and the z-window deconvolution table
    chi (pz, gz). Position independent."""
    return _host_noise_tables_cached(_key(params))


@functools.lru_cache(maxsize=8)
def _noise_factors_host_cached(params: WallParams):
    t = _host_noise_tables(params)
    x = 2.0 * t["kpar"] / t["k_cut"] - 1.0
    sc = t["scale"]
    outs = []
    for key in ("C_lz", "C_t"):
        C = np.asarray(t[key], np.float64)
        b1 = np.zeros((x.shape[0], C.shape[1]))
        b2 = np.zeros_like(b1)
        x2 = (2.0 * x)[:, None]
        for q in range(C.shape[0] - 1, 0, -1):
            b1, b2 = x2 * b1 - b2 + C[q][None, :], b1
        vals = x[:, None] * b1 - b2 + C[0][None, :]
        d = int(math.isqrt(C.shape[1]))
        G = vals.reshape(x.shape[0], d, d)
        G = 0.5 * (G + np.swapaxes(G, 1, 2))
        w, V = np.linalg.eigh(G)
        F = V * np.sqrt(np.maximum(w, 0.0))[:, None, :]
        Dh = V * np.sqrt(np.maximum(-w, 0.0))[:, None, :]
        outs.append((sc[:, None, None] * F, sc[:, None, None] * Dh))
    (F_lz, Dh_lz), (F_t, Dh_t) = outs
    return F_lz, F_t, Dh_lz, Dh_t


def _noise_factors_host(params: WallParams):
    """Per-mode factors (F_lz, F_t), F F^T = clamp+(G_k), and defect
    half-factors (Dh_lz, Dh_t), Dh Dh^T = clamp+(G_k) - G_k, scale-folded
    (f64 numpy). The per-mode z-operators are not individually PSD; the
    sampler takes their positive parts and the Lanczos of the near field
    carries the defect, so the covariances add to sum_k G_k."""
    return _noise_factors_host_cached(_key(params))


def noise_factors(params: WallParams, dtype, device):
    """The noise factor tables on `device` in `dtype`: built once per
    params on the host and kept on the device by the caller (the
    integrators' carry)."""
    return tuple(torch.as_tensor(a, dtype=dtype, device=device)
                 for a in _noise_factors_host(params))


# ---------------------------------------------------------------------------
# Device constants of a params set
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _NearTables:
    cheb: torch.Tensor         # (2, 2, K) RPY remainder
    self_coeff: float
    img_cheb: torch.Tensor     # (2, 10, Ki) image-channel radial series
    img_range: Tuple[float, float, float]  # (r_lo, r_mid, r_hi) / a


@dataclasses.dataclass(frozen=True)
class _Tables:
    polish_idx: torch.Tensor   # (P,) flat (gx, gy2) columns
    polish_kfft: torch.Tensor  # (P, 4, 3, 3, 2 gz) complex
    kern: torch.Tensor         # (gx, gy2, gz) RPY multiplier, polish cut
    khat: torch.Tensor         # (3, gx, gy2, gz)
    img_mult: torch.Tensor     # (3 m, 3, 3, gx, gy2, gz) complex: the
    #                            image channels' multipliers T_m (u = sum_m
    #                            T_m c_m), mult_terms at unit channels


def _complex_dtype(dtype):
    return torch.complex64 if dtype == torch.float32 else torch.complex128


@functools.lru_cache(maxsize=4)
def _near_tables(params: WallParams, dtype, device) -> _NearTables:
    """The near field's device constants (K7's coefficient tables), cached
    per params set."""
    cheb, self_c = _host_cheb_rpy(params)
    img, r_lo, r_mid, r_hi = _host_img_cheb(params)
    return _NearTables(
        cheb=torch.as_tensor(cheb, dtype=dtype, device=device).contiguous(),
        self_coeff=float(self_c),
        img_cheb=torch.as_tensor(img, dtype=dtype, device=device).contiguous(),
        img_range=(r_lo, r_mid, r_hi))


@functools.lru_cache(maxsize=4)
def _tables(params: WallParams, dtype, device, ky_range=None) -> _Tables:
    """The wave side's device constants, cached so that plan rebuilds
    reuse them: the polish columns and the k-space multipliers over
    (gx, gy2, gz), or over the ky slice ky_range = (y0, y1) of gy2 (a
    rank's share: the multipliers of its slice, the polish columns in it
    with flat indices into (gx, y1 - y0))."""
    p = params
    gx, gy, gz = p.grid
    gy2 = gy // 2 + 1
    y0, y1 = (0, gy2) if ky_range is None else ky_range
    pol_idx, pol_kfft, pol_mask = _host_polish(p)
    if ky_range is not None:
        kxi, kyi = np.divmod(np.asarray(pol_idx), gy2)
        keep = (kyi >= y0) & (kyi < y1)
        pol_idx = kxi[keep] * (y1 - y0) + (kyi[keep] - y0)
        pol_kfft = pol_kfft[keep]
        pol_mask = np.asarray(pol_mask).reshape(gx, gy2)[:, y0:y1]
    freqs = _axis_freqs(p)
    freqs[1] = freqs[1][y0:y1]
    kx, ky, kz = (torch.as_tensor(k, dtype=dtype, device=device)
                  for k in freqs)
    KX = kx[:, None, None]
    KY = ky[None, :, None]
    KZ = kz[None, None, :]
    k2 = KX * KX + KY * KY + KZ * KZ
    k2s = torch.where(k2 > 0, k2, torch.ones_like(k2))
    k = torch.sqrt(k2s)
    phi = (1.0 + k2 / (4 * p.xi ** 2)) * torch.exp(-k2 / (4 * p.xi ** 2))
    sinc = torch.sin(k * p.a) / (k * p.a)
    h3 = float(np.prod(p.spacing))
    w2 = [torch.as_tensor(w, dtype=dtype, device=device) ** 2
          for w in _host_whats(p)]
    w2[1] = w2[1][y0:y1]
    norm = h3 / (w2[0][:, None, None] * w2[1][None, :, None]
                 * w2[2][None, None, :])
    mask = torch.as_tensor(pol_mask, device=device).reshape(
        gx, y1 - y0, 1).to(dtype)
    live = k2 > 0
    zero = torch.zeros((), dtype=dtype, device=device)
    kern = torch.where(live, (sinc ** 2 * phi / (p.eta * k2s)) * norm * mask,
                       zero)
    khat = torch.where(live, torch.stack([(KX / k).expand_as(k2),
                                          (KY / k).expand_as(k2),
                                          (KZ / k).expand_as(k2)]), zero)
    base = phi * norm * mask / (8.0 * math.pi * p.eta)
    F4 = torch.where(live, base * (-8.0 * math.pi) / (k2s * k2s), zero)
    F2 = torch.where(live, base * (4.0 * math.pi) / k2s, zero)
    # the generated mult_terms is linear in its nine channel fields: its
    # columns at unit channels, formed once here, turn each product's
    # application into 27 multiply-adds (evaluated per product, its
    # expression tree is hundreds of full-grid passes)
    cdt = _complex_dtype(dtype)
    img_mult = torch.empty((3, 3, 3, gx, y1 - y0, gz), dtype=cdt,
                           device=device)
    for m in range(3):
        for j in range(3):
            args = [0.0] * 9
            args[3 * m + j] = 1.0
            for i, u in enumerate(gen.mult_terms(KX, KY, KZ, F4, F2,
                                                 p.a * p.a, *args)):
                img_mult[m, i, j] = torch.zeros((), dtype=cdt,
                                                device=device) + u
    return _Tables(
        polish_idx=torch.as_tensor(pol_idx, dtype=torch.int64, device=device),
        polish_kfft=torch.as_tensor(pol_kfft, device=device).to(cdt),
        kern=kern, khat=khat, img_mult=img_mult)


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class WallPlan:
    """Everything reusable across products at fixed positions. Positions
    are GRID-SHIFTED: pos_all = (x, y, z - z0) of the combined real +
    image set, the first n_real rows the real particles."""

    pos_all: torch.Tensor     # (2N, 3) xy-wrapped (after a refresh:
    #                           sort_pos plus the min-image drift)
    sort_pos: torch.Tensor    # (2N, 3) positions the cells were sorted at
    heights: torch.Tensor     # (N,) clipped physical z of the reals
    damp: torch.Tensor        # (N,) overlap damping min(z / a, 1)
    cell_table: torch.Tensor  # (n_cells cap,) int32 ids of the 2N set
    cell_slot: torch.Tensor   # (2N,)
    n_dropped_cells: torch.Tensor  # 0-d: cell-capacity overflows
    cell_dims: Tuple[int, int, int]
    n_clipped: torch.Tensor   # 0-d: real particles above z_hi
    params: WallParams

    @property
    def n_real(self) -> int:
        return self.pos_all.shape[0] // 2

    @property
    def tables(self) -> _Tables:
        return _tables(_key(self.params), self.pos_all.dtype,
                       self.pos_all.device)

    @property
    def near_tables(self) -> _NearTables:
        return _near_tables(_key(self.params), self.pos_all.dtype,
                            self.pos_all.device)

    def _view(self, sl):
        """A SpectralPlan view of the padded box over the points sl of
        pos_all (the fields ops/ewald's spread and interpolate read)."""
        return ewald.SpectralPlan(
            positions=self.pos_all[sl], sort_pos=self.sort_pos[sl],
            cheb=None, self_coeff=0.0, cell_table=None, cell_slot=None,
            n_dropped_cells=None, cell_dims=None, kernel=None, khat=None,
            params=self.params.grid_params())


def _wall_points(p: WallParams, positions):
    """(pos_all, heights, damp, n_clipped) at physical positions (N, 3):
    xy wrapped, heights clipped into [a, z_hi], images mirrored, all
    grid-shifted by -z0."""
    box2 = torch.as_tensor(p.box_xy, dtype=positions.dtype,
                           device=positions.device)
    xy = positions[:, :2]
    xy = xy - torch.floor(xy / box2) * box2
    z_raw = positions[:, 2]
    z = torch.clamp(z_raw, p.a, p.z_hi)
    n_clipped = torch.sum(z_raw > p.z_hi)
    damp = torch.clamp(z_raw / p.a, max=1.0)
    pos_all = torch.cat([torch.cat([xy, (z - p.z0)[:, None]], dim=1),
                         torch.cat([xy, (-z - p.z0)[:, None]], dim=1)])
    return pos_all.contiguous(), z, damp, n_clipped


def _bin_box(p: WallParams, dims):
    """The near-field binning volume: the data slab plus the guard
    layer, nz cells of Z_CELL_SLACK r_cut."""
    return (p.box_xy[0], p.box_xy[1], dims[2] * Z_CELL_SLACK * p.r_cut)


def _kept_layers(p: WallParams, dims):
    """The z layers [lo, hi] whose cells can hold REAL particles (grid z
    in [LD/2 + a, LD/2 + z_hi]): K7's target cells."""
    csize_z = Z_CELL_SLACK * p.r_cut
    lo = max(int((0.5 * p.data_extent + p.a) / csize_z), 0)
    hi = min(int((0.5 * p.data_extent + p.z_hi) / csize_z), dims[2] - 1)
    return lo, hi


def auto_cell_capacity(pos_all, box, dims):
    """The near-field cells' automatic capacity at these binned points:
    the fullest cell's count plus a drift slack of 4 sqrt(mean count over
    the occupied cells), rounded up to 8, at least 16. One host read per
    plan build. Counting the binned cells (not a mean over the data
    slab's z layers, the JAX package's rule) holds a roller monolayer,
    whose reals and images share one z layer, without drops; K7 and K8
    stage a cell's targets 128 at a time, so no capacity is refused."""
    counts = torch.bincount(cells.cell_ids(pos_all, box, dims),
                            minlength=int(np.prod(dims)))
    fullest, occupied = torch.stack(
        [counts.max(), torch.count_nonzero(counts)]).tolist()
    mean_occ = pos_all.shape[0] / max(occupied, 1)
    return int(max(-(-(fullest + 4.0 * math.sqrt(mean_occ)) // 8) * 8, 16))


def make_wall_plan(params: WallParams, positions) -> WallPlan:
    """The plan at (N, 3) PHYSICAL blob positions (wall at z = 0). The
    near-field cells bin the data slab plus one empty guard layer (not the
    padded FFT box), so the stencil's z wrap only meets empty cells; the
    z cells carry drift slack (Z_CELL_SLACK) for update_wall_plan."""
    p = params
    pos_all, heights, damp, n_clipped = _wall_points(p, positions)
    Lx, Ly = p.box_xy
    csize_z = Z_CELL_SLACK * p.r_cut
    nz_data = max(int(math.ceil(p.data_extent / csize_z)), 2)
    dims = (max(int(Lx // p.r_cut), 1), max(int(Ly // p.r_cut), 1),
            nz_data + 1)
    if min(dims[:2]) < 4:
        raise ValueError(f"wall box {(Lx, Ly)} too small for r_cut "
                         f"{p.r_cut}: need >= 4 xy cells")
    cap = p.cell_capacity
    if cap <= 0:
        cap = auto_cell_capacity(pos_all, _bin_box(p, dims), dims)
    p = dataclasses.replace(p, cell_capacity=int(cap))
    cell_table, cell_slot, _, n_dropped = cells.cell_bin(
        pos_all, _bin_box(p, dims), dims, int(cap))
    return WallPlan(pos_all=pos_all, sort_pos=pos_all, heights=heights,
                    damp=damp, cell_table=cell_table, cell_slot=cell_slot,
                    n_dropped_cells=n_dropped, cell_dims=dims,
                    n_clipped=n_clipped, params=p)


def update_wall_plan(plan: WallPlan, positions) -> WallPlan:
    """The plan at positions near the ones it was sorted at (the wall
    analog of ewald.update_plan): a refresh (new positions, heights and
    damping, the same cells and gridding x planes) while every point's
    min-image drift from sort_pos stays within half the cell slack and
    half a grid spacing, a full rebuild past that. One host sync decides
    the branch."""
    p = plan.params
    pos_all, heights, damp, n_clipped = _wall_points(p, positions)
    box3 = torch.as_tensor((p.box_xy[0], p.box_xy[1], p.lz_box),
                           dtype=pos_all.dtype, device=pos_all.device)
    delta = pos_all - plan.sort_pos
    delta = delta - torch.round(delta / box3) * box3
    dims = plan.cell_dims
    side = np.asarray([p.box_xy[0] / dims[0], p.box_xy[1] / dims[1],
                       Z_CELL_SLACK * p.r_cut])
    budget = 0.5 * np.minimum(side - p.r_cut,
                              np.asarray(p.spacing, np.float64))
    budget = torch.as_tensor(np.maximum(budget, 0.0), dtype=box3.dtype,
                             device=box3.device)
    if mesh_mod.host_bool(torch.all(torch.amax(torch.abs(delta), dim=0)
                                    <= budget)):
        return dataclasses.replace(
            plan, pos_all=(plan.sort_pos + delta).contiguous(),
            heights=heights, damp=damp, n_clipped=n_clipped)
    return make_wall_plan(p, positions)


# ---------------------------------------------------------------------------
# Near field (kernel K7)
# ---------------------------------------------------------------------------


def near_args(plan: WallPlan):
    """Kernel K7's operands at this plan, less the positions and the
    strengths: the positional arguments of cell_kernels.wall_near and
    wall_near_plain after (pos_all, forces), and their keyword arguments
    (wall_near also takes cz_range=_kept_layers(...))."""
    p = plan.params
    t = plan.near_tables
    args = (plan.cell_table, plan.cell_dims, _bin_box(p, plan.cell_dims),
            p.cell_capacity, t.cheb, t.img_cheb)
    kw = dict(two_a=2.0 * p.a, r_cut=p.r_cut, z0=p.z0, a=p.a,
              pref_img=1.0 / (8.0 * math.pi * p.eta * p.a),
              img_range=t.img_range)
    return args, kw


def near_rows(plan: WallPlan, f, mesh=None):
    """Kernel K7's rows (N, C) without the self term; under a mesh of
    several ranks this rank's share of the (x, y) cell columns, the other
    rows zero."""
    args, kw = near_args(plan)
    dims = plan.cell_dims
    columns = (mesh.share(dims[0] * dims[1]) if mesh_mod.is_sharded(mesh)
               else None)
    return cell_kernels.wall_near(
        plan.pos_all, f, *args,
        cz_range=_kept_layers(plan.params, plan.cell_dims), columns=columns,
        **kw)


def near_matvec(plan: WallPlan, forces):
    """Near-field rows (N, C), C = 3B b-major: the RPY remainder over the
    pairs of the combined set (mirrored strengths at image rows) and the
    screened image channels of (real target, image source) pairs, by
    kernel K7, plus the self term."""
    n = plan.n_real
    f = forces.reshape(n, -1).contiguous()
    return near_rows(plan, f) + plan.near_tables.self_coeff * f


# ---------------------------------------------------------------------------
# Wave field
# ---------------------------------------------------------------------------


def _zfft(cxy, lo, gz):
    """z transform of the occupied planes [lo, lo + nz) of the padded
    axis: (..., nz) -> (..., gz)."""
    full = cxy.new_zeros(cxy.shape[:-1] + (gz,))
    full[..., lo:lo + cxy.shape[-1]] = cxy
    return torch.fft.fft(full, dim=-1)


def _profile(cxy, pi, lo, gz):
    """The polish columns' z profiles (3, P, gz), zero outside the
    occupied planes."""
    prof = cxy.new_zeros((3, pi.shape[0], gz))
    prof[:, :, lo:lo + cxy.shape[-1]] = cxy.reshape(3, -1, cxy.shape[-1])[:,
                                                                          pi]
    return prof


def wave_matvec(plan: WallPlan, forces):
    """Wave-side product, forces (N, C), C = 3B: spread the merged real +
    image channel and the three h^m image channels, xy rfft of the
    occupied planes and z FFT, the multipliers (RPY projector, the image
    channels' T_m of the generated mult_terms), the polish columns'
    z-convolutions, inverse transforms onto the real-target planes and
    interpolation at the reals."""
    p = plan.params
    t = plan.tables
    n = plan.n_real
    f = forces.reshape(n, -1)
    B = f.shape[1] // 3
    gx, gy, gz = p.grid
    gy2 = gy // 2 + 1
    (da, db), (ia, ib), (ra, rb) = _z_plane_ranges(p)
    nr = rb - ra
    pi = t.polish_idx
    mirror = torch.as_tensor([1.0, 1.0, -1.0] * B, dtype=f.dtype,
                             device=f.device)
    f_all = torch.cat([f, -f * mirror])
    h = plan.heights[:, None]
    f_img = torch.cat([f, h * f, (h * h) * f], dim=1)   # (N, 9B) m-major

    # the channel groups add in k space: u^ = K_rpy c_merged + sum_m T_m c_m
    Uk = torch.zeros((3 * B, gx, gy2, gz), dtype=_complex_dtype(f.dtype),
                     device=f.device)
    prof_all, prof_img = [], [None] * (3 * B)
    g_all = ewald.spread(plan._view(slice(None)), f_all)  # (3B,gx,gy,gz)
    for b in range(B):
        cxy = torch.fft.rfft2(g_all[3 * b:3 * b + 3, :, :, da:db],
                              dim=(1, 2))
        prof_all.append(_profile(cxy, pi, da, gz))
        ck = _zfft(cxy, da, gz)
        kdotc = torch.sum(t.khat * ck, dim=0, keepdim=True)
        Uk[3 * b:3 * b + 3] = t.kern[None] * (ck - t.khat * kdotc)
    del g_all
    # the three h^m channels share one spread (the window weights)
    g_img = ewald.spread(plan._view(slice(n, None)), f_img)  # (9B, ...)
    for m in range(3):
        for b in range(B):
            c0 = 3 * (B * m + b)
            cxy = torch.fft.rfft2(g_img[c0:c0 + 3, :, :, ia:ib], dim=(1, 2))
            prof_img[B * m + b] = _profile(cxy, pi, ia, gz)
            ck = _zfft(cxy, ia, gz)
            for i in range(3):
                for j in range(3):
                    Uk[3 * b + i].addcmul_(t.img_mult[m, i, j], ck[j])
    del g_img

    # polish columns: dense z-convolutions by circular FFT; input groups
    # per right-hand side [merged, T0, T1, T2]
    pa = torch.cat(prof_all).reshape(B, 3, -1, gz)
    pim = torch.cat(prof_img).reshape(3, B, 3, -1, gz)
    pin = torch.cat([pa[:, None], pim.movedim(0, 1)], dim=1)  # (B,4,3,P,gz)
    pin_f = torch.fft.fft(pin, n=2 * gz, dim=-1)
    out_f = torch.einsum("pcijL,bcjpL->bipL", t.polish_kfft, pin_f)
    pout = torch.fft.ifft(out_f, dim=-1)[..., ra:rb].reshape(3 * B, -1, nr)

    Uacc = torch.fft.ifft(Uk, dim=-1)[..., ra:rb].reshape(3 * B, -1, nr)
    Uacc[:, pi] += pout
    Ur = torch.fft.irfft2(Uacc.reshape(3 * B, gx, gy2, nr), s=(gx, gy),
                          dim=(1, 2))
    U = Ur.new_zeros((3 * B, gx, gy, gz))
    U[..., ra:rb] = Ur
    return ewald.interpolate(plan._view(slice(0, n)), U)


def _wave_noise_pre(plan: WallPlan, w, F_lz, F_t):
    """The sampler's linear chain before the interpolation: (3 pz, gx, gy)
    real white noise -> per-mode factors in the rotated frame (l, t, z)
    with the z phases that make the per-mode operators real -> real plane
    fields -> z deconvolution: a (3, gx, gy, gz) grid."""
    p = plan.params
    tb = _host_noise_tables(p)
    gx, gy, gz = p.grid
    gy2 = gy // 2 + 1
    pz = tb["p"]
    dtype, dev = w.dtype, w.device
    cdt = _complex_dtype(dtype)
    idx = torch.as_tensor(tb["mode_idx"], dtype=torch.int64, device=dev)
    cos = torch.as_tensor(tb["cos"], dtype=dtype, device=dev)
    sin = torch.as_tensor(tb["sin"], dtype=dtype, device=dev)
    What = torch.fft.rfft2(w, dim=(1, 2))
    Wm = What.reshape(3 * pz, gx * gy2)[:, idx]
    wx, wy, wz = Wm[:pz], Wm[pz:2 * pz], Wm[2 * pz:]
    # z phases: T^dagger F T per mode, phase 1 at the self-conjugate
    # k = 0 mode (ewald_wall.py of the JAX package)
    phz = torch.where(torch.as_tensor(tb["kpar"] > 0.0, device=dev),
                      torch.tensor(-1j, dtype=cdt, device=dev),
                      torch.tensor(1.0 + 0.0j, dtype=cdt, device=dev))
    vl = cos[None] * wx + sin[None] * wy
    vt = -sin[None] * wx + cos[None] * wy
    v_lz = torch.cat([vl, wz * torch.conj(phz)[None, :]])

    def apply(F, v):
        # real factors on complex columns: real and imaginary parts apart
        return torch.complex(torch.einsum("mij,jm->im", F, v.real),
                             torch.einsum("mij,jm->im", F, v.imag))

    xi_lz = apply(F_lz, v_lz)
    xi_t = apply(F_t, vt)
    xl, xz = xi_lz[:pz], xi_lz[pz:] * phz[None, :]
    ox = cos[None] * xl - sin[None] * xi_t
    oy = sin[None] * xl + cos[None] * xi_t
    out = torch.cat([ox, oy, xz])                        # (3pz, M)
    Z = out.new_zeros((3 * pz, gx * gy2))
    Z[:, idx] = out
    psi = torch.fft.irfft2(Z.reshape(3 * pz, gx, gy2), s=(gx, gy),
                           dim=(1, 2))
    chi = torch.as_tensor(tb["chi"], dtype=dtype, device=dev)   # (pz, gz)
    return torch.einsum("cpxy,pz->cxyz", psi.reshape(3, pz, gx, gy), chi)


def _wave_noise_apply(plan: WallPlan, w, F_lz, F_t):
    """The sampler's linear chain: _wave_noise_pre, then interpolation at
    the real particles, (N, 3). Shared by the sampler (clamp+ factors)
    and the defect operator (defect half-factors)."""
    grid3 = _wave_noise_pre(plan, w, F_lz, F_t)
    return ewald.interpolate(plan._view(slice(0, plan.n_real)), grid3)


def wave_sqrt_noise(plan: WallPlan, w, factors):
    """u with Cov(u) = sum_k clamp+(G_k), the wave part less its defect,
    from real white noise w (3 pz, gx, gy) (pz = params.noise_orders()[0])
    and the factor tables of noise_factors. The UNDAMPED sample at the
    plan's clipped heights; callers apply the overlap damping."""
    return _wave_noise_apply(plan, w, factors[0], factors[1])


def wave_defect_matvec(plan: WallPlan, forces, factors):
    """Delta f, Delta = sum_k (clamp+(G_k) - G_k) = U Dh Dh^T U^T with U
    the sampler's chain, forces (N, 3). The adjoint: `spread` is the
    exact transpose of `interpolate`, and the pre-chain is transposed by
    reverse-mode autograd on its (linear) graph, whose rfft2/irfft2
    adjoints carry the Hermitian column weights."""
    p = plan.params
    pz = _host_noise_tables(p)["p"]
    gx, gy = p.grid[0], p.grid[1]
    Dh_lz, Dh_t = factors[2], factors[3]
    f3 = forces.reshape(-1, 3)
    grid_adj = ewald.spread(plan._view(slice(0, plan.n_real)), f3)
    with torch.enable_grad():
        w0 = torch.zeros((3 * pz, gx, gy), dtype=f3.dtype, device=f3.device,
                         requires_grad=True)
        (wt,) = torch.autograd.grad(_wave_noise_pre(plan, w0, Dh_lz, Dh_t),
                                    w0, grad_outputs=grid_adj)
    return _wave_noise_apply(plan, wt, Dh_lz, Dh_t)


# ---------------------------------------------------------------------------
# The full product
# ---------------------------------------------------------------------------


def wave_share(plan: WallPlan, forces, mesh):
    """This rank's share of wave_matvec's rows (N, C) under a mesh whose
    size divides gx (the module's docstring); the ranks' shares sum to
    wave_matvec."""
    p = plan.params
    n = plan.n_real
    f = forces.reshape(n, -1)
    B = f.shape[1] // 3
    gx, gy, gz = p.grid
    gy2 = gy // 2 + 1
    D = mesh.size
    nxl, nyl = gx // D, -(-gy2 // D)
    planes = (mesh.rank * nxl, nxl)
    y0 = min(mesh.rank * nyl, gy2)
    y1 = min(y0 + nyl, gy2)
    t = _tables(_key(p), f.dtype, f.device, (y0, y1))
    (da, db), (ia, ib), (ra, rb) = _z_plane_ranges(p)
    nr = rb - ra
    pi = t.polish_idx
    mirror = torch.as_tensor([1.0, 1.0, -1.0] * B, dtype=f.dtype,
                             device=f.device)
    f_all = torch.cat([f, -f * mirror])
    h = plan.heights[:, None]
    f_img = torch.cat([f, h * f, (h * h) * f], dim=1)   # (N, 9B) m-major

    def slab(view, strengths):
        ids = ewald.plane_particles(view, planes)
        return ewald.spread(view, strengths[ids], ids, planes=planes)

    def to_ky(g):
        # (C, nxl, gy, nz) planes -> (C, gx, y1 - y0, nz): y rfft, the
        # ky-padded all_to_all, x fft
        c = torch.fft.rfft(g, dim=2)
        c = torch.nn.functional.pad(c, (0, 0, 0, D * nyl - gy2))
        c = mesh_mod.all_to_all(mesh, c, split_dim=2, concat_dim=1)
        return torch.fft.fft(c, dim=1)[:, :, :y1 - y0]

    Uk = torch.zeros((3 * B, gx, y1 - y0, gz), dtype=_complex_dtype(f.dtype),
                     device=f.device)
    prof_all, prof_img = [], [None] * (3 * B)
    g_all = to_ky(slab(plan._view(slice(None)), f_all)[..., da:db])
    for b in range(B):
        cxy = g_all[3 * b:3 * b + 3]
        prof_all.append(_profile(cxy, pi, da, gz))
        ck = _zfft(cxy, da, gz)
        kdotc = torch.sum(t.khat * ck, dim=0, keepdim=True)
        Uk[3 * b:3 * b + 3] = t.kern[None] * (ck - t.khat * kdotc)
    del g_all
    g_img = to_ky(slab(plan._view(slice(n, None)), f_img)[..., ia:ib])
    for m in range(3):
        for b in range(B):
            c0 = 3 * (B * m + b)
            cxy = g_img[c0:c0 + 3]
            prof_img[B * m + b] = _profile(cxy, pi, ia, gz)
            ck = _zfft(cxy, ia, gz)
            for i in range(3):
                for j in range(3):
                    Uk[3 * b + i].addcmul_(t.img_mult[m, i, j], ck[j])
    del g_img

    Uacc = torch.fft.ifft(Uk, dim=-1)[..., ra:rb].reshape(3 * B, -1, nr)
    if pi.numel():   # a ky slice may hold no polish column
        pa = torch.cat(prof_all).reshape(B, 3, -1, gz)
        pim = torch.cat(prof_img).reshape(3, B, 3, -1, gz)
        pin = torch.cat([pa[:, None], pim.movedim(0, 1)], dim=1)
        pin_f = torch.fft.fft(pin, n=2 * gz, dim=-1)
        out_f = torch.einsum("pcijL,bcjpL->bipL", t.polish_kfft, pin_f)
        Uacc[:, pi] += torch.fft.ifft(out_f, dim=-1)[..., ra:rb].reshape(
            3 * B, -1, nr)
    # the inverse: x ifft on the ky slice, the all_to_all back to the
    # rank's planes, the y irfft
    Ux = torch.fft.ifft(Uacc.reshape(3 * B, gx, y1 - y0, nr), dim=1)
    Ux = torch.nn.functional.pad(Ux, (0, 0, 0, nyl - (y1 - y0)))
    Ux = mesh_mod.all_to_all(mesh, Ux, split_dim=1, concat_dim=2)
    Ur = torch.fft.irfft(Ux[:, :, :gy2], n=gy, dim=2)   # (3B, nxl, gy, nr)
    U = Ur.new_zeros((3 * B, nxl, gy, gz))
    U[..., ra:rb] = Ur
    view = plan._view(slice(0, n))
    ids = ewald.plane_particles(view, planes)
    rows = torch.zeros_like(f)
    rows[ids] = ewald.interpolate(view, U, ids, planes=planes)
    return rows


def matvec_sharded(plan: WallPlan, f, mesh):
    """The undamped product (N, C) -> (N, C) under a mesh of several
    ranks, on every rank: the near rows of this rank's columns and its
    share of the wave rows summed over the ranks in one all_reduce_sum,
    then the self term; the wave replicated when gx does not divide into
    the ranks."""
    f = f.contiguous()
    partial = near_rows(plan, f, mesh)
    replicated = plan.params.grid[0] % mesh.size != 0
    if not replicated:
        partial = partial + wave_share(plan, f, mesh)
    out = mesh_mod.all_reduce_sum(mesh, partial)
    if replicated:
        if REPLICATED_WAVE["grid"] == 0:
            log.info("ewald_wall.matvec_sharded: the wave part runs "
                     "replicated (gx %d on %d ranks), as the JAX package's "
                     "does", plan.params.grid[0], mesh.size)
        REPLICATED_WAVE["grid"] += 1
        out = out + wave_matvec(plan, f)
    return out + plan.near_tables.self_coeff * f


def matvec(plan: WallPlan, forces, mesh=None):
    """Single-wall RPY product M f, (N, 3) -> (N, 3) (or (N, 3B) stacked
    b-major), with the overlap damping B M(z_eff) B folded in; a mesh of
    several ranks shares it out (matvec_sharded)."""
    n = plan.n_real
    d = plan.damp[:, None]
    f2 = forces.reshape(n, -1) * d
    if mesh_mod.is_sharded(mesh):
        out = matvec_sharded(plan, f2, mesh) * d
    else:
        out = (near_matvec(plan, f2) + wave_matvec(plan, f2)) * d
    return out.reshape(forces.shape)


def matvec_multi(plan: WallPlan, forces, mesh=None):
    """Stacked products, (B, N, 3) -> (B, N, 3), in one engine sweep."""
    B, n = forces.shape[0], forces.shape[1]
    if B == 1:
        return matvec(plan, forces[0], mesh=mesh)[None]
    f = forces.permute(1, 0, 2).reshape(n, 3 * B)
    out = matvec(plan, f, mesh=mesh)
    return out.reshape(n, B, 3).permute(1, 0, 2)


# ---------------------------------------------------------------------------
# Oracle for the tests: the direct image-box lattice sum
# ---------------------------------------------------------------------------


def brute_force_wall(positions, forces, a, eta, box_xy, n_img=30):
    """Direct xy-periodic wall mobility: RPY + Swan-Brady blocks summed
    over (2 n_img + 1)^2 image boxes (float64 on the CPU). The combined
    real + image kernel decays like 1/rho^3 in-plane, so the lattice sum
    converges absolutely. Returns numpy (N, 3)."""
    from . import rpy

    pos = torch.as_tensor(np.asarray(positions, np.float64))
    f = torch.as_tensor(np.asarray(forces, np.float64).reshape(-1, 3))
    n = pos.shape[0]
    Lx, Ly = box_xy
    r = torch.arange(-n_img, n_img + 1, dtype=torch.float64)
    shifts = torch.stack(torch.meshgrid(r * Lx, r * Ly, indexing="ij"),
                         dim=-1).reshape(-1, 2)
    home = torch.all(shifts == 0.0, dim=1)
    pos_j = pos[None] + torch.cat([shifts, torch.zeros(len(shifts), 1)],
                                  dim=1)[:, None, :]
    u = torch.zeros_like(f)
    for i in range(n):
        d = (pos[i][None, None, :] - pos_j) / a
        self_mask = torch.zeros(d.shape[:2], dtype=torch.bool)
        self_mask[home] = (torch.arange(n) == i)[None, :]
        m = rpy.rpy_tt(d, self_mask)
        hs = pos_j[..., 2] / a
        w = rpy.wall_tt(d[..., 0], d[..., 1], pos[i, 2] / a + hs, hs,
                        self_mask)
        u[i] = torch.einsum("snij,nj->i", m + w, f) / (8 * np.pi * eta * a)
    return u.numpy()
