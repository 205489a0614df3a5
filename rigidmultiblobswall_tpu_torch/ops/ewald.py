"""Spectral (Positively-Split) Ewald RPY mobility of a triply-periodic box:
the O(N log N) engine of domain 'periodic_spectral' (PyTorch).

Counterpart of rigidmultiblobswall_tpu/ops/ewald.py, single blob radius,
one device. The mathematics (see the JAX module's docstring):

* M f = u^w + u^r with a Hasimoto split of the periodic RPY k-sum. The
  wave part, (1/V) sum_k sinc^2(ka) phi(k) / (eta k^2) (I - k^k^) e^{ik.x},
  phi(k) = (1 + k^2/4xi^2) exp(-k^2/4xi^2), is applied on a grid: spread
  the forces with an exponential-of-semicircle window, rFFT, scale by the
  kernel and project, inverse rFFT, interpolate with the same window.
* The real-space remainder alpha(r) I + beta(r) r^r^ is summed over the
  pairs with r < r_cut of a linked-cell layout (kernel K6,
  ops/cell_kernels.near_rpy), its scalars from a two-piece Chebyshev fit
  of host quadrature tables; plus the self term.
* Both parts are SPD, so the wave part has a closed-form square root
  (wave_sqrt_noise) and Lanczos runs on the near field alone.

The host-side parameter choice and quadrature (numpy, scipy) are copies
of the JAX package's, so both pick the same grid, r_cut, xi, window
support and Chebyshev coefficients. Gridding (`spread`, `interpolate`)
is plain PyTorch on separable window weights: index_add_ to spread, a
gather and a weighted sum to interpolate, in chunks of particles. A
particle stamps, per axis, the grid points the JAX layout stamps: along
x the P planes round(x/h) + (0..P-1) - P//2 of its sort-time position
(the JAX segment layout keeps them across plan refreshes), along y and z
every point within P h / 2 of its position; each weight is masked to
|d| <= P h / 2. The JAX package's z-slab plane-matmul layout exists only
because XLA on the TPU serializes colliding scatters and is not ported;
a hand-written gridding kernel is later work (ROADMAP).

The multi-device product (`matvec_sharded`, the JAX package's; a `mesh`
of parallel/mesh.py on matvec and matvec_multi): the near field's target
cells are shared across the ranks (kernel K6 over a cell range; P2 over a
range of targets on a mixed-radii plan), and the wave field's x planes:
each rank spreads and interpolates the stamps on its planes, the rFFT
along z and the FFT along y run on its slab, an all_to_all turns the slab
into a ky slice, the FFT along x and the k-scaling run there, and the
inverse mirrors it. The near rows and the wave's interpolated rows of a
rank add into one partial that `all_reduce_sum` completes. The wave
stays replicated (every rank the whole wave product) when gx or gy does
not divide into the ranks, or on a mixed-radii plan, as in the JAX
package; `REPLICATED_WAVE` counts those products by reason.

Mixed radii (`EwaldParams.radii`, `make_plan(group_of=...)`): the wave
kernel carries per-group shape factors sinc(k a_g), each group's
particles gridded on channels of their own (exact polydisperse PSE, SPD
by congruence), the near field takes per-group-pair three-piece
Chebyshev series (kernel P2, ops/cell_kernels.near_rpy_radii), and the
self term is per particle, as in the JAX package's mixed-radii mode. A
plan on the card lists P2's pairs once (cell_kernels.near_radii_pairs),
at its build and at every refresh, and each product walks the list.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import math
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from . import cell_kernels, cells
from ..parallel import mesh as mesh_mod

log = logging.getLogger(__name__)
# sharded products whose wave part ran replicated, by reason
REPLICATED_WAVE = {"grid": 0, "radii": 0}

# ---------------------------------------------------------------------------
# Host side: closed-form RPY and the quadrature-built remainder tables
# ---------------------------------------------------------------------------


def rpy_scalar_functions(r, a, eta):
    """Unbounded RPY mobility scalars: M = alpha I + beta r^ r^^T.

    r >= 2a: (1/(8 pi eta r)) [(1 + 2a^2/3r^2) I + (1 - 2a^2/r^2) rr];
    r <  2a: (1/(6 pi eta a)) [(1 - 9r/32a) I + (3r/32a) rr]."""
    r = np.asarray(r, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        far_a = (1.0 + 2.0 * a * a / (3.0 * r * r)) / (8 * np.pi * eta * r)
        far_b = (1.0 - 2.0 * a * a / (r * r)) / (8 * np.pi * eta * r)
    near_a = (1.0 - 9.0 * r / (32.0 * a)) / (6 * np.pi * eta * a)
    near_b = (3.0 * r / (32.0 * a)) / (6 * np.pi * eta * a)
    alpha = np.where(r >= 2 * a, far_a, near_a)
    beta = np.where(r >= 2 * a, far_b, near_b)
    return alpha, beta


def _bessel_weights(x):
    """(j0(x) - j1(x)/x, 2 j1(x)/x) with series near x=0."""
    x = np.asarray(x, dtype=np.float64)
    small = np.abs(x) < 1e-4
    xs = np.where(small, 1.0, x)
    j0 = np.sin(xs) / xs
    j1_over_x = (np.sin(xs) / xs - np.cos(xs)) / (xs * xs)
    perp = np.where(small, 2.0 / 3.0 - 2.0 * x * x / 15.0, j0 - j1_over_x)
    par = np.where(small, 2.0 / 3.0 - x * x / 15.0, 2.0 * j1_over_x)
    return perp, par


def wave_freespace_scalars(r, a, eta, xi, *, n_k=4001):
    """Free-space inverse transform of the wave-space kernel at radii r:
    returns (c_perp, c_par) with M^w_free = c_perp (I - rr) + c_par rr,
    by Simpson quadrature over k in [0, k_max]."""
    from scipy.integrate import simpson

    r = np.asarray(r, dtype=np.float64)
    k_max = 2.0 * xi * math.sqrt(math.log(1e22))
    k = np.linspace(0.0, k_max, n_k)
    k[0] = 1e-30
    sinc = np.sin(k * a) / (k * a)
    phi = (1.0 + k * k / (4 * xi * xi)) * np.exp(-k * k / (4 * xi * xi))
    g_times_k2 = sinc * sinc * phi / eta  # k^2 g(k)
    x = np.outer(r, k)  # (nr, nk)
    perp_w, par_w = _bessel_weights(x)
    c_perp = simpson(g_times_k2[None, :] * perp_w, x=k, axis=1) / (
        2 * np.pi**2)
    c_par = simpson(g_times_k2[None, :] * par_w, x=k, axis=1) / (
        2 * np.pi**2)
    return c_perp, c_par


def realspace_tables(a, eta, xi, r_max, *, n_points=2048):
    """Radial tables of the real-space remainder scalars
    (alpha_r, beta_r) with M^r(r) = alpha_r I + beta_r r^ r^^T =
    RPY(r) - M^w_free(r), on r in [0, r_max]. Returns
    (r_grid, alpha_r, beta_r, self_coeff) as float64 numpy arrays."""
    r = np.linspace(0.0, r_max, n_points)
    alpha, beta = rpy_scalar_functions(np.maximum(r, 1e-14), a, eta)
    # r = 0 entry: pair functions continuous at 0 via the near form
    alpha[0], beta[0] = 1.0 / (6 * np.pi * eta * a), 0.0
    c_perp, c_par = wave_freespace_scalars(r, a, eta, xi)
    # M^w_free = c_perp I + (c_par - c_perp) rr
    alpha_r = alpha - c_perp
    beta_r = beta - (c_par - c_perp)
    self_coeff = 1.0 / (6 * np.pi * eta * a) - c_perp[0]
    return r, alpha_r, beta_r, self_coeff


def rot_scalar_functions(r, a, eta):
    """Unbounded RPY rot-block scalars: the cross block M_UT = M_WF =
    gamma(r) [r x] (gamma multiplies the unnormalized displacement) and
    the rr block M_WT = alpha_rr I + beta_rr r^ r^^T; the far forms for
    r >= 2a, the RPY overlap forms under."""
    r = np.asarray(r, dtype=np.float64)
    rs = np.maximum(r, 1e-14)
    pref2 = 1.0 / (8 * np.pi * eta * a**3)
    with np.errstate(divide="ignore", invalid="ignore"):
        gamma_far = 1.0 / (8 * np.pi * eta * rs**3)
        a_far = -0.5 * pref2 * (a / rs) ** 3
        b_far = 1.5 * pref2 * (a / rs) ** 3
    x = rs / a
    gamma_near = pref2 * 0.5 * (1.0 - 0.375 * x)
    # near rr: c1 + c2 * d d (d scaled) -> alpha = c1, beta = c2 * x^2
    c1 = pref2 * (1.0 - 0.84375 * x + 0.078125 * x**3)
    c2x2 = pref2 * (0.28125 / np.maximum(x, 1e-14) - 0.046875 * x) * x * x
    gamma = np.where(r >= 2 * a, gamma_far, gamma_near)
    alpha_rr = np.where(r >= 2 * a, a_far, c1)
    beta_rr = np.where(r >= 2 * a, b_far, c2x2)
    return gamma, alpha_rr, beta_rr


def _w_r(x):
    """RPY rotlet window 3 j1(x)/x with series near 0."""
    x = np.asarray(x, dtype=np.float64)
    small = np.abs(x) < 1e-4
    xs = np.where(small, 1.0, x)
    j1_over_x = (np.sin(xs) / xs - np.cos(xs)) / (xs * xs)
    return np.where(small, 1.0 - x * x / 10.0, 3.0 * j1_over_x)


def rot_wave_freespace_scalars(r, a, eta, xi, *, n_k=4001):
    """Free-space inverse transforms of the wave-space rot kernels: the
    cross gamma_w(r) (M_w = gamma_w [r x]) and the rr (c_perp, c_par),
    M_w_rr = c_perp (I - rr) + c_par rr, of the wave multipliers
    -(i k x)/(2 eta k^2) sinc(ka) w_r(ka) phi(k) and
    (w_r(ka)^2 phi(k) / (4 eta)) (I - k^k^)."""
    from scipy.integrate import simpson

    r = np.asarray(r, dtype=np.float64)
    k_max = 2.0 * xi * math.sqrt(math.log(1e22))
    k = np.linspace(0.0, k_max, n_k)
    k[0] = 1e-30
    sinc = np.sin(k * a) / (k * a)
    wr = _w_r(k * a)
    phi = (1.0 + k * k / (4 * xi * xi)) * np.exp(-k * k / (4 * xi * xi))
    # gamma_w(r) r_k = rhat_k d/dr IFT[-(sinc wr phi)/(2 eta k^2)]
    #   => gamma_w = (1/(4 pi^2 eta r)) Int k sinc wr phi j1(kr) dk
    x = np.outer(r, k)
    small = np.abs(x) < 1e-6
    xs = np.where(small, 1.0, x)
    j1 = np.where(small, x / 3.0, np.sin(xs) / (xs * xs) - np.cos(xs) / xs)
    rs = np.maximum(r, 1e-14)
    gamma_w = simpson((k * sinc * wr * phi)[None, :] * j1, x=k,
                      axis=1) / (4 * np.pi**2 * eta * rs)
    # r = 0: gamma_w multiplies r_k, so its value is irrelevant; keep the
    # finite limit
    gamma_w = np.where(r < 1e-12,
                       simpson(k * k * sinc * wr * phi / 3.0, x=k)
                       / (4 * np.pi**2 * eta), gamma_w)
    g_rr_times_k2 = k * k * wr * wr * phi / (4 * eta)
    perp_w, par_w = _bessel_weights(x)
    c_perp = simpson(g_rr_times_k2[None, :] * perp_w, x=k, axis=1) / (
        2 * np.pi**2)
    c_par = simpson(g_rr_times_k2[None, :] * par_w, x=k, axis=1) / (
        2 * np.pi**2)
    return gamma_w, c_perp, c_par


def rot_realspace_tables(a, eta, xi, r_max, *, n_points=2048):
    """Radial tables of the rot-block real-space remainder scalars on
    r in [0, r_max]: (r, gamma_r, alpha_rr_r, beta_rr_r, self_rr), the
    cross remainder gamma_r [r x], the rr remainder alpha_rr_r I +
    beta_rr_r r^r^ and self_rr, the RPY rr self term 1/(8 pi eta a^3) less
    the wave self term."""
    r = np.linspace(0.0, r_max, n_points)
    gamma, alpha_rr, beta_rr = rot_scalar_functions(r, a, eta)
    alpha_rr[0] = 1.0 / (8 * np.pi * eta * a**3)
    beta_rr[0] = 0.0
    gamma_w, c_perp, c_par = rot_wave_freespace_scalars(r, a, eta, xi)
    gamma_r = gamma - gamma_w
    alpha_rr_r = alpha_rr - c_perp
    beta_rr_r = beta_rr - (c_par - c_perp)
    self_rr = 1.0 / (8 * np.pi * eta * a**3) - c_perp[0]
    return r, gamma_r, alpha_rr_r, beta_rr_r, self_rr


def rpy_radii_scalar_functions(r, ag, ah, eta):
    """Unequal-radii RPY tt scalars (alpha, beta), M = alpha I + beta
    r^ r^^T (numpy mirror of ops/rpy.rpy_tt_radii): the far form for r >
    ag + ah, the overlap form for |ag - ah| < r <= ag + ah, and the plateau
    of one blob inside the other."""
    r = np.asarray(r, dtype=np.float64)
    rs = np.maximum(r, 1e-14)
    s2 = ag * ag + ah * ah
    pref = 1.0 / (8.0 * np.pi * eta)
    c1_far = (1.0 + s2 / (3.0 * rs * rs)) / rs
    c2_far = (1.0 - s2 / (rs * rs)) / rs**3
    dd2 = (ah - ag) ** 2
    ft = 4.0 / 3.0
    c1_mid = ((16.0 * (ag + ah) * rs**3 - (dd2 + 3.0 * rs * rs) ** 2)
              / (32.0 * rs**3)) * ft / (ag * ah)
    c2_mid = (3.0 * (dd2 - rs * rs) ** 2 / (32.0 * rs**5)) * ft / (ag * ah)
    c1_near = np.full_like(rs, ft / max(ag, ah))
    far = r > (ag + ah)
    mid = (~far) & (r > abs(ah - ag))
    c1 = np.where(far, c1_far, np.where(mid, c1_mid, c1_near))
    c2 = np.where(far, c2_far, np.where(mid, c2_mid, 0.0))
    return pref * c1, pref * c2 * r * r


def wave_freespace_scalars_radii(r, ag, ah, eta, xi, *, n_k=4001):
    """Free-space inverse transform of the wave kernel with the per-group
    shape factors sinc(k ag) sinc(k ah): (c_perp, c_par), M^w_free =
    c_perp (I - rr) + c_par rr."""
    from scipy.integrate import simpson

    r = np.asarray(r, dtype=np.float64)
    k_max = 2.0 * xi * math.sqrt(math.log(1e22))
    k = np.linspace(0.0, k_max, n_k)
    k[0] = 1e-30
    sinc_g = np.sin(k * ag) / (k * ag)
    sinc_h = np.sin(k * ah) / (k * ah)
    phi = (1.0 + k * k / (4 * xi * xi)) * np.exp(-k * k / (4 * xi * xi))
    g_times_k2 = sinc_g * sinc_h * phi / eta
    x = np.outer(r, k)
    perp_w, par_w = _bessel_weights(x)
    c_perp = simpson(g_times_k2[None, :] * perp_w, x=k, axis=1) / (
        2 * np.pi**2)
    c_par = simpson(g_times_k2[None, :] * par_w, x=k, axis=1) / (
        2 * np.pi**2)
    return c_perp, c_par


def pair_remainder_radii(r, ag, ah, eta, xi):
    """Real-space remainder scalars (alpha_r, beta_r) of the group pair
    (ag, ah) at radii r, by direct quadrature: RPY_radii(r) minus
    M^w_free(r; sinc_g sinc_h). The r = 0 entry is the (g, g) self
    remainder."""
    r = np.asarray(r, dtype=np.float64)
    alpha, beta = rpy_radii_scalar_functions(r, ag, ah, eta)
    c_perp, c_par = wave_freespace_scalars_radii(r, ag, ah, eta, xi)
    return alpha - c_perp, beta - (c_par - c_perp)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EwaldParams:
    """Static spectral-Ewald configuration for one (box, a, eta, accuracy)."""

    a: float
    eta: float
    box: Tuple[float, float, float]
    xi: float
    r_cut: float
    grid: Tuple[int, int, int]
    support: int = 8           # window width P (grid points per axis)
    es_beta_factor: float = 0.98  # beta = f * pi * P * (1 - 1/(2*gamma))
    oversample: float = 1.5
    n_table: int = 2048
    # near-field cell-list slots per cell (0 = auto: mean occupancy +
    # 4 sigma, rounded up to 8; make_plan stores the resolved value)
    cell_capacity: int = 48
    # Chebyshev terms per piece (0 = grow the degree until the fit error
    # is well under tol)
    n_cheb: int = 0
    tol: float = 1e-4          # accuracy target the params were built for
    # distinct blob radii (mixed-radii mode) when non-empty: per-group wave
    # shape factors and per-group-pair near tables; `a` then sizes the grid
    # and r_cut (pass max(radii)), and make_plan needs group_of
    radii: Tuple[float, ...] = ()

    @property
    def spacing(self):
        return tuple(L / n for L, n in zip(self.box, self.grid))

    @property
    def es_beta(self):
        return (self.es_beta_factor * math.pi * self.support
                * (1.0 - 0.5 / self.oversample))


def _round_up_even(n):
    n = int(math.ceil(n))
    return n + (n % 2)


def _fft_friendly(n):
    """True when n has no prime factor beyond 7."""
    for p in (2, 3, 5, 7):
        while n % p == 0:
            n //= p
    return n == 1


def _round_up_grid(n, *, zslab_pm=None):
    """Round a per-axis grid size up to an even, FFT-friendly value; with
    zslab_pm set (the z axis), also to one whose JAX z-slab block height
    is at most 1.5 pm, as the JAX package's grid choice requires (the
    port keeps the rule so both packages pick the same grid)."""
    g = _round_up_even(n)
    while True:
        if _fft_friendly(g):
            if zslab_pm is None:
                return g
            for m in range(max(g // (2 * zslab_pm), 1), 0, -1):
                if g % (2 * m) == 0:
                    zb = g // (2 * m)
                    break
            if zb <= (3 * zslab_pm) // 2:
                return g
        g += 2


def default_params(a, eta, box, *, tol=1e-4, r_cut_factor=None,
                   support=None, oversample=1.5, grid_max=256,
                   **kw) -> EwaldParams:
    """Heuristic parameter choice (the JAX package's): splitting error
    ~ exp(-s^2) on both sides with s = xi r_cut = k_max/(2 xi); r_cut
    defaults to ~6a, then xi = s/r_cut and the grid resolves
    oversample * k_max. The window support follows the ES error model
    err ~ exp(5.5 - 1.81 P) at oversample 1.5. When the grid would exceed
    grid_max on an axis, r_cut is inflated so the grid stays bounded.
    radii= (the distinct blob radii) selects the mixed-radii mode."""
    if "radii" in kw:
        kw["radii"] = tuple(float(x) for x in kw["radii"])
    if support is None:
        support = int(min(max(math.ceil(
            (5.5 - math.log(0.3 * tol)) / 1.81), 6), 14))
    s = math.sqrt(max(-math.log(tol * 0.002), 4.0))
    box = tuple(float(b) for b in box)
    r_cut = (r_cut_factor if r_cut_factor is not None else 6.0) * a
    r_cut = min(r_cut, 0.45 * min(box))

    pm = max(int(support) - 1, 8)

    def _grid(rc):
        k_max = 2.0 * s * s / rc
        return tuple(max(_round_up_grid(oversample * k_max * L / math.pi,
                                        zslab_pm=pm if d == 2 else None), 8)
                     for d, L in enumerate(box))

    grid = _grid(r_cut)
    if grid_max and max(grid) > grid_max:
        r_cut = min(r_cut * max(grid) / float(grid_max), 0.45 * min(box))
        grid = _grid(r_cut)
    xi = s / r_cut
    return EwaldParams(a=float(a), eta=float(eta), box=box, xi=xi,
                       r_cut=r_cut, grid=grid, support=int(support),
                       oversample=float(oversample), tol=float(tol), **kw)


@functools.lru_cache(maxsize=16)
def _host_tables(params: EwaldParams):
    """Host radial tables, one quadrature per parameter set."""
    return realspace_tables(params.a, params.eta, params.xi, params.r_cut,
                            n_points=params.n_table)


@functools.lru_cache(maxsize=16)
def _host_cheb(params: EwaldParams):
    """Piecewise-Chebyshev fits of the real-space remainder scalars, two
    pieces ([0, 2a] and [2a, r_cut]: the RPY scalars kink at r = 2a).
    Returns (coeffs (2 pieces, 2 functions {alpha, beta}, K),
    self_coeff)."""
    from numpy.polynomial import chebyshev as npcheb

    r, a_tab, b_tab, self_c = _host_tables(params)
    edges = [(0.0, 2.0 * params.a), (2.0 * params.a, params.r_cut)]
    scale = 1.0 / (6 * np.pi * params.eta * params.a)
    target = 0.05 * params.tol
    for K in ([params.n_cheb] if params.n_cheb
              else (8, 10, 12, 14, 16, 20, 24, 28, 32)):
        out = np.zeros((2, 2, K))
        err = 0.0
        for i, (lo, hi) in enumerate(edges):
            m = (r >= lo) & (r <= hi)
            t = (2.0 * r[m] - (hi + lo)) / (hi - lo)
            for j, tab in enumerate((a_tab, b_tab)):
                out[i, j] = npcheb.chebfit(t, tab[m], K - 1)
                err = max(err, np.abs(
                    npcheb.chebval(t, out[i, j]) - tab[m]).max() / scale)
        if params.n_cheb or err < target:
            break
    return out, self_c


def _radii_pair_edges(params: EwaldParams, g: int, h: int):
    """Radial piece edges (0, e1, e2, r_cut) of group pair (g, h): the
    RPY radii scalars kink at |ag - ah| (one blob inside the other) and at
    ag + ah (touching). The first edge is floored at 1e-3 r_cut so that a
    same-radius pair keeps three well-conditioned pieces."""
    ag, ah = params.radii[g], params.radii[h]
    e1 = max(abs(ag - ah), 1e-3 * params.r_cut)
    e2 = ag + ah
    if not e1 < e2 < params.r_cut:
        raise ValueError(
            f"radii pair ({ag}, {ah}) needs r_cut > ag + ah "
            f"(r_cut={params.r_cut}); raise r_cut_factor")
    return (0.0, e1, e2, params.r_cut)


@functools.lru_cache(maxsize=16)
def _host_cheb_radii(params: EwaldParams):
    """Piecewise-Chebyshev fits of the per-group-pair remainder scalars
    (mixed-radii mode), each piece fit at 4K Chebyshev nodes of its own
    evaluated by direct quadrature (pair_remainder_radii), K grown until
    the fit error is under 0.05 tol of 1/(6 pi eta min(radii)). Returns
    (coeffs (G, G, 3 pieces, 2 functions, K), self_coeffs (G,)).

    Two departures from the JAX package, which give the same numbers:
    the self coefficients, which do not depend on K, are computed once
    before the K loop, not in each of its rounds; and a loop that ends at
    its largest K above the target warns (RuntimeWarning) instead of
    returning the fit silently: a radius gap between 1e-10 and the
    1e-3 r_cut edge floor puts the kink at |ag - ah| inside a piece."""
    from numpy.polynomial import chebyshev as npcheb

    G = len(params.radii)
    scale = 1.0 / (6 * np.pi * params.eta * min(params.radii))
    target = 0.05 * params.tol
    selfs = np.array([pair_remainder_radii(
        np.asarray([0.0]), ag, ag, params.eta, params.xi)[0][0]
        for ag in params.radii])
    for K in ([params.n_cheb] if params.n_cheb
              else (10, 12, 14, 16, 20, 24, 28, 32)):
        out = np.zeros((G, G, 3, 2, K))
        err = 0.0
        nodes = np.cos(np.pi * (np.arange(4 * K) + 0.5) / (4 * K))
        for g in range(G):
            for h in range(g, G):
                edges = _radii_pair_edges(params, g, h)
                for i in range(3):
                    lo, hi = edges[i], edges[i + 1]
                    r = 0.5 * (hi + lo) + 0.5 * (hi - lo) * nodes
                    al, be = pair_remainder_radii(
                        r, params.radii[g], params.radii[h], params.eta,
                        params.xi)
                    for j, tab in enumerate((al, be)):
                        out[g, h, i, j] = npcheb.chebfit(nodes, tab, K - 1)
                        err = max(err, np.abs(
                            npcheb.chebval(nodes, out[g, h, i, j])
                            - tab).max() / scale)
                out[h, g] = out[g, h]
        if params.n_cheb or err < target:
            break
    else:
        warnings.warn(
            f"mixed-radii remainder fit: {K} Chebyshev terms leave a "
            f"relative error {err:.3g} above the target {target:.3g} (radii "
            f"{params.radii}; a radius gap below 1e-3 r_cut puts a kink "
            "inside a piece)", RuntimeWarning, stacklevel=2)
    return out, selfs


def radii_edge_table(params: EwaldParams):
    """(G, G, 8) per group pair: the piece edges e1, e2 and each piece's
    (mid, 2 / width), the piece map of kernel P2 (numpy float64)."""
    G = len(params.radii)
    out = np.zeros((G, G, 8))
    for g in range(G):
        for h in range(G):
            e = _radii_pair_edges(params, min(g, h), max(g, h))
            out[g, h, :2] = e[1:3]
            for i in range(3):
                out[g, h, 2 + 2 * i] = 0.5 * (e[i] + e[i + 1])
                out[g, h, 3 + 2 * i] = 2.0 / (e[i + 1] - e[i])
    return out


def _axis_freqs(params: EwaldParams):
    """Per-axis angular frequencies; the z axis is the rfft half-spectrum."""
    (gx, gy, gz) = params.grid
    (Lx, Ly, Lz) = params.box
    return [2.0 * np.pi * np.fft.fftfreq(gx, d=Lx / gx),
            2.0 * np.pi * np.fft.fftfreq(gy, d=Ly / gy),
            2.0 * np.pi * np.fft.rfftfreq(gz, d=Lz / gz)]


def _es_window_np(x, R, beta):
    """Exponential-of-semicircle window on |x| <= R (numpy, host)."""
    t = np.clip(np.asarray(x, np.float64) / R, -1.0, 1.0)
    w = np.exp(beta * (np.sqrt(np.maximum(1.0 - t * t, 0.0)) - 1.0))
    return np.where(np.abs(x) <= R, w, 0.0)


def _es_window_hat(k, R, beta, *, n_quad=2000):
    """w^(k) = 2 int_0^R w(x) cos(kx) dx by host quadrature."""
    from scipy.integrate import simpson

    x = np.linspace(0.0, R, n_quad)
    w = _es_window_np(x, R, beta)
    k = np.atleast_1d(np.asarray(k, np.float64))
    integ = w[None, :] * np.cos(np.outer(k, x))
    return 2.0 * simpson(integ, x=x, axis=1)


@functools.lru_cache(maxsize=16)
def _host_whats(params: EwaldParams):
    """Per-axis window transforms w^(k) (host quadrature)."""
    P = params.support
    beta = params.es_beta
    ks = _axis_freqs(params)
    return tuple(_es_window_hat(kd, 0.5 * P * hd, beta)
                 for kd, hd in zip(ks, params.spacing))


def _device_kernel(params: EwaldParams, dtype, device, include_sinc=True):
    """k-space multiplier (gx, gy, gz//2+1) and unit wave vectors
    (3, gx, gy, gz//2+1) on the rfft half-spectrum, assembled on the
    device from 1-D host inputs. The normalization h^3 / w^^2 assumes the
    default "backward" FFT norm (1/n^3 on the inverse). include_sinc=False
    leaves out the sinc(ka)^2 shape factor (the mixed-radii mode applies
    per-group factors, _group_sinc)."""
    whats = _host_whats(params)
    ks = [torch.as_tensor(kd, dtype=dtype, device=device)
          for kd in _axis_freqs(params)]
    kx = ks[0][:, None, None]
    ky = ks[1][None, :, None]
    kz = ks[2][None, None, :]
    k2 = kx * kx + ky * ky + kz * kz
    k2_safe = torch.where(k2 > 0, k2, torch.ones_like(k2))
    k = torch.sqrt(k2_safe)
    sinc2 = ((torch.sin(k * params.a) / (k * params.a)) ** 2
             if include_sinc else 1.0)
    phi = (1.0 + k2 / (4 * params.xi**2)) * torch.exp(
        -k2 / (4 * params.xi**2))
    h3 = float(np.prod(params.spacing))
    w2 = [torch.as_tensor(w, dtype=dtype, device=device) ** 2 for w in whats]
    what2 = w2[0][:, None, None] * w2[1][None, :, None] * w2[2][None, None, :]
    kern = (sinc2 * phi / (params.eta * k2_safe)) * h3 / what2
    kern[0, 0, 0] = 0.0
    khat = torch.stack([(kx / k).expand(k2.shape), (ky / k).expand(k2.shape),
                        (kz / k).expand(k2.shape)])
    khat[:, 0, 0, 0] = 0.0
    return kern, khat


def _group_sinc(params: EwaldParams, dtype, device):
    """Per-group shape factors sinc(k a_g), (G, gx, gy, gz//2+1), on the
    device (mixed-radii mode)."""
    ks = [torch.as_tensor(kd, dtype=dtype, device=device)
          for kd in _axis_freqs(params)]
    k2 = (ks[0][:, None, None] ** 2 + ks[1][None, :, None] ** 2
          + ks[2][None, None, :] ** 2)
    k = torch.sqrt(torch.where(k2 > 0, k2, torch.ones_like(k2)))
    return torch.stack([torch.sin(k * ag) / (k * ag) for ag in params.radii])


# ---------------------------------------------------------------------------
# The plan: everything reusable across products at fixed positions
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SpectralPlan:
    """Everything reusable across products at fixed positions."""

    positions: torch.Tensor   # (N, 3) wrapped into the box (after a
    #                           refresh: sort_pos plus the min-image drift)
    sort_pos: torch.Tensor    # (N, 3) positions the cells were sorted at;
    #                           update_plan measures drift against these
    cheb: torch.Tensor        # (2 pieces, 2 functions, K) coefficients
    self_coeff: object        # float; (N, 1) per particle with radii
    cell_table: torch.Tensor  # (n_cells cap,) int32 particle ids (pad N)
    cell_slot: torch.Tensor   # (N,) flat (cell, slot) row per particle
    n_dropped_cells: torch.Tensor  # 0-d: cell-capacity overflows
    cell_dims: Tuple[int, int, int]
    kernel: torch.Tensor      # (gx, gy, gz//2+1) scalar k-space multiplier
    khat: torch.Tensor        # (3, gx, gy, gz//2+1) unit wave vectors
    params: EwaldParams
    # mixed-radii mode (params.radii non-empty), None otherwise; kernel then
    # carries no shape factor
    group_of: Optional[torch.Tensor] = None    # (N,) int32 radius group
    group_members: Optional[tuple] = None      # per group its particle ids
    gsinc: Optional[torch.Tensor] = None       # (G, gx, gy, gz//2+1)
    cheb_radii: Optional[torch.Tensor] = None  # (G, G, 3, 2, K)
    radii_edges: Optional[torch.Tensor] = None  # (G, G, 8) radii_edge_table
    # P2's pair list at `positions` (a plan on the card), None on the CPU
    radii_pairs: Optional[cell_kernels.RadiiPairs] = None


def _box(params, like):
    return torch.as_tensor(params.box, dtype=like.dtype, device=like.device)


def make_plan(params: EwaldParams, positions, group_of=None) -> SpectralPlan:
    """Build the reusable machinery for M v products at fixed positions
    (one plan per configuration). The mixed-radii mode (params.radii
    non-empty) needs group_of, each particle's radius group (N,)."""
    dtype, dev = positions.dtype, positions.device
    box = _box(params, positions)
    pos = (positions - torch.floor(positions / box) * box).contiguous()
    cheb, self_c = _host_cheb(params)
    radii = {}
    if params.radii:
        if group_of is None:
            raise ValueError("params.radii set: make_plan needs group_of")
        group_of = torch.as_tensor(group_of, device=dev).to(
            torch.int32).contiguous()
        cr, selfs = _host_cheb_radii(params)
        radii = dict(
            group_of=group_of,
            group_members=tuple(torch.nonzero(group_of == g).flatten()
                                for g in range(len(params.radii))),
            gsinc=_group_sinc(params, dtype, dev),
            cheb_radii=torch.as_tensor(cr, dtype=dtype,
                                       device=dev).contiguous(),
            radii_edges=torch.as_tensor(radii_edge_table(params),
                                        dtype=dtype, device=dev).contiguous())
        self_c = torch.as_tensor(selfs, dtype=dtype,
                                 device=dev)[group_of.long()][:, None]
    dims = tuple(max(int(L // params.r_cut), 1) for L in params.box)
    if min(dims) < 4:
        raise ValueError(
            f"box {params.box} too small for r_cut {params.r_cut}: "
            "need >= 4 cells per periodic dim (use the direct pairwise "
            "engine at this size)")
    nx, ny, nz = dims
    cap = params.cell_capacity
    if cap <= 0:
        # mean occupancy + 4 sigma (Poisson), rounded up to 8
        mean_occ = pos.shape[0] / (nx * ny * nz)
        cap = int(min(max(
            -(-(mean_occ + 4.0 * math.sqrt(mean_occ)) // 8) * 8, 16), 128))
    params = dataclasses.replace(params, cell_capacity=int(cap))
    cell_table, cell_slot, _, n_dropped = cells.cell_bin(pos, box, dims,
                                                         int(cap))
    kern, khat = _device_kernel(params, dtype, dev,
                                include_sinc=not params.radii)
    return _with_pairs(SpectralPlan(
        positions=pos, sort_pos=pos,
        cheb=torch.as_tensor(cheb, dtype=dtype, device=dev).contiguous(),
        self_coeff=self_c if params.radii else float(self_c),
        cell_table=cell_table, cell_slot=cell_slot,
        n_dropped_cells=n_dropped, cell_dims=dims, kernel=kern, khat=khat,
        params=params, **radii))


def _with_pairs(plan: SpectralPlan) -> SpectralPlan:
    """The plan with P2's pair list at its positions: listed on the card in
    the mixed-radii mode, none otherwise (the CPU's plain sweep lists
    nothing)."""
    if plan.cheb_radii is None or plan.positions.device.type != "cuda":
        return plan
    p = plan.params
    return dataclasses.replace(plan, radii_pairs=cell_kernels.near_radii_pairs(
        plan.positions, plan.group_of, plan.cell_table, plan.cell_dims,
        p.box, p.cell_capacity, r_cut=p.r_cut))


def update_plan(plan: SpectralPlan, positions) -> SpectralPlan:
    """The plan at positions near the ones it was sorted at: a refresh
    (new positions, the same cells) while every particle's min-image drift
    from sort_pos stays within half the cell slack (cell side - r_cut)
    and half a grid spacing, a full rebuild past that. The near field
    stays exact on the refresh branch (the old stencil still covers every
    pair within r_cut); the gridding keeps each particle's sort-time x
    planes, as the JAX package does; a rebuild keeps the radius groups.
    Either branch lists P2's pairs anew on the card (mixed radii). One host
    sync decides the branch, and the list's length takes another."""
    p = plan.params
    box = _box(p, plan.positions)
    pos_w = positions - torch.floor(positions / box) * box
    delta = pos_w - plan.sort_pos
    delta = delta - torch.round(delta / box) * box       # min-image drift
    side = np.asarray(p.box, np.float64) / np.asarray(plan.cell_dims)
    budget = 0.5 * np.minimum(side - p.r_cut,
                              np.asarray(p.spacing, np.float64))
    budget = torch.as_tensor(np.maximum(budget, 0.0), dtype=box.dtype,
                             device=box.device)
    if mesh_mod.host_bool(torch.all(torch.amax(torch.abs(delta), dim=0)
                                    <= budget)):
        # new positions: P2's list is made anew, never carried over
        return _with_pairs(dataclasses.replace(
            plan, positions=(plan.sort_pos + delta).contiguous()))
    return make_plan(p, positions, group_of=plan.group_of)


# ---------------------------------------------------------------------------
# Wave-space product
# ---------------------------------------------------------------------------


def _es_window(d, r_win, beta):
    """ES window of offsets d; 0 outside |d| <= r_win."""
    t = torch.clamp(d / r_win, -1.0, 1.0)
    w = torch.exp(beta * (torch.sqrt(torch.clamp(1.0 - t * t, min=0.0))
                          - 1.0))
    return torch.where(torch.abs(d) <= r_win, w, torch.zeros_like(w))


def _axis_stamps(x, first, g, h, L, P, beta):
    """Grid indices (m, P) along one axis starting at `first` (m,) and
    the window weights of the (min-image) offsets from x."""
    idx = torch.remainder(first[:, None] + torch.arange(P, device=x.device),
                          g)
    d = idx.to(x.dtype) * h - x[:, None]
    d = d - L * torch.round(d / L)
    return idx, _es_window(d, 0.5 * P * h, beta)


def _stamps(plan: SpectralPlan, sl):
    """Flat grid indices (m, P^3) and weights (m, P^3) of particles sl."""
    p = plan.params
    P = p.support
    beta = p.es_beta
    pos = plan.positions[sl]
    idx, w = [], []
    for ax in range(3):
        g, L = p.grid[ax], p.box[ax]
        h = L / g
        if ax == 0:
            # the sort-time planes round(x/h) + (0..P-1) - P//2
            first = torch.round(plan.sort_pos[sl, 0] / h).long() - P // 2
        else:
            # every point with |d| <= P h / 2
            first = torch.ceil(pos[:, ax] / h - 0.5 * P).long()
        i, wt = _axis_stamps(pos[:, ax], first, g, h, L, P, beta)
        idx.append(i)
        w.append(wt)
    gy, gz = p.grid[1], p.grid[2]
    flat = ((idx[0][:, :, None, None] * gy + idx[1][:, None, :, None]) * gz
            + idx[2][:, None, None, :])
    wts = w[0][:, :, None, None] * w[1][:, None, :, None] * w[2][:, None,
                                                                None, :]
    m = pos.shape[0]
    return flat.reshape(m, -1), wts.reshape(m, -1)


def _chunks(plan: SpectralPlan, n):
    """Slices of n particles whose stamp temporaries stay near 2^24
    entries (a few hundred MB at C = 6 in float32): few chunks, few
    launches."""
    step = max(1, (1 << 24) // plan.params.support ** 3)
    return [slice(i, min(i + step, n)) for i in range(0, n, step)]


def _on_planes(plan: SpectralPlan, idx, w, planes):
    """Stamps restricted to the x planes [x0, x0 + nx): indices into the
    (nx, gy, gz) slab, the weights off the slab zeroed."""
    if planes is None:
        return idx, w
    x0, nx = planes
    gy, gz = plan.params.grid[1], plan.params.grid[2]
    loc = idx - x0 * gy * gz
    keep = (loc >= 0) & (loc < nx * gy * gz)
    return (torch.where(keep, loc, torch.zeros_like(loc)),
            torch.where(keep, w, torch.zeros_like(w)))


def plane_particles(plan: SpectralPlan, planes):
    """The ids of the particles that stamp any of the x planes [x0, x0 +
    nx) (their sort-time planes, as _stamps takes them)."""
    p = plan.params
    x0, nx = planes
    gx, P = p.grid[0], p.support
    first = torch.round(plan.sort_pos[:, 0] / (p.box[0] / gx)).long() - P // 2
    xs = torch.remainder(first[:, None]
                         + torch.arange(P, device=first.device), gx)
    return torch.nonzero(((xs >= x0) & (xs < x0 + nx)).any(dim=1)).flatten()


def spread(plan: SpectralPlan, forces, ids=None, planes=None):
    """S f: (N, C) forces -> (C, gx, gy, gz) grid (C = 3 per right-hand
    side; stacked sides share the window weights). With ids, the
    particles ids only, forces (len(ids), C). With planes (x0, nx), the
    slab of those x planes alone, (C, nx, gy, gz)."""
    gx, gy, gz = plan.params.grid
    nxl = gx if planes is None else planes[1]
    n = plan.positions.shape[0] if ids is None else ids.shape[0]
    f = forces.reshape(n, -1)
    grid = torch.zeros((nxl * gy * gz, f.shape[1]), dtype=f.dtype,
                       device=f.device)
    for sl in _chunks(plan, n):
        idx, w = _on_planes(plan, *_stamps(plan, sl if ids is None
                                           else ids[sl]), planes)
        vals = w[:, :, None] * f[sl][:, None, :]
        grid.index_add_(0, idx.reshape(-1), vals.reshape(-1, f.shape[1]))
    return grid.T.reshape(-1, nxl, gy, gz)


def interpolate(plan: SpectralPlan, ug, ids=None, planes=None):
    """S^T u: (C, gx, gy, gz) grid -> (N, C), the transpose of `spread`;
    with ids, the rows of the particles ids only, (len(ids), C); with
    planes (x0, nx), ug the (C, nx, gy, gz) slab of those planes and the
    rows their stamps' share."""
    C = ug.shape[0]
    rows = ug.reshape(C, -1).T.contiguous()              # (G, C)
    n = plan.positions.shape[0] if ids is None else ids.shape[0]
    out = torch.empty((n, C), dtype=ug.dtype, device=ug.device)
    for sl in _chunks(plan, n):
        idx, w = _on_planes(plan, *_stamps(plan, sl if ids is None
                                           else ids[sl]), planes)
        out[sl] = torch.sum(w[:, :, None] * rows[idx], dim=1)
    return out


def k_scale(plan: SpectralPlan, gk):
    """Project out khat and apply the scalar kernel on the rfft
    half-spectrum; gk may carry C = 3 B channels (b-major)."""
    shape = gk.shape
    g = gk.reshape(-1, 3, *shape[1:])
    kdotg = torch.sum(plan.khat[None] * g, dim=1, keepdim=True)
    out = plan.kernel[None, None] * (g - plan.khat[None] * kdotg)
    return out.reshape(shape)


def _wave_matvec_radii(plan: SpectralPlan, forces):
    """Mixed-radii wave product, M_w = D^T C D with D = sum_g sinc_g F
    S_g (the JAX package's _wave_matvec_radii): each group's particles
    spread into C channels of their own, the k-space sum folds the
    groups' factors, and each group's particles interpolate the result
    with their group's factor. The JAX package grids G C channels for
    every particle, each particle's force in its group's block; here a
    group's particles grid their C channels alone, the same sums without
    the blocks of zeros (G times fewer stamps and gathered values)."""
    n = plan.positions.shape[0]
    f = forces.reshape(n, -1)
    gsum = 0
    for g, ids in enumerate(plan.group_members):
        gk = torch.fft.rfftn(spread(plan, f[ids], ids), dim=(1, 2, 3))
        gsum = gsum + plan.gsinc[g] * gk
    return _interpolate_groups(plan, k_scale(plan, gsum), f.shape[1])


def _interpolate_groups(plan: SpectralPlan, uk, C):
    """(N, C) rows from the k-space field uk (C, ...): each group's
    particles interpolate F^{-1} sinc_g uk."""
    out = torch.empty((plan.positions.shape[0], C), dtype=plan.kernel.dtype,
                      device=uk.device)
    for g, ids in enumerate(plan.group_members):
        ug = torch.fft.irfftn(plan.gsinc[g] * uk, s=plan.params.grid,
                              dim=(1, 2, 3))
        out[ids] = interpolate(plan, ug, ids)
    return out


def wave_matvec(plan: SpectralPlan, forces):
    """u^w = S^T F^{-1} B F S f (spread, rFFT, scale, irFFT, interpolate).
    forces (N, C) with C = 3 B."""
    if plan.gsinc is not None:
        return _wave_matvec_radii(plan, forces)
    grid = spread(plan, forces)
    gk = torch.fft.rfftn(grid, dim=(1, 2, 3))
    ug = torch.fft.irfftn(k_scale(plan, gk), s=plan.params.grid,
                          dim=(1, 2, 3))
    return interpolate(plan, ug)


def wave_sqrt_noise(plan: SpectralPlan, w):
    """u with Cov(u) = M_wave exactly, from real grid white noise w
    (3, gx, gy, gz): u = S^T F^{-1} K^{1/2} F w (the PSE split of
    Fiore/Balboa/Donev/Swan 2017; K^{1/2} is pointwise in k: the square
    root of the scalar kernel times the projector). With mixed radii the
    target-side group factors multiply it and each particle reads its own
    group's block: Cov(u) = D^T C^{1/2} C^{1/2} D = M_w exactly."""
    gk = torch.fft.rfftn(w.to(plan.positions.dtype), dim=(1, 2, 3))
    kdotg = torch.sum(plan.khat * gk, dim=0, keepdim=True)
    uk = torch.sqrt(plan.kernel)[None] * (gk - plan.khat * kdotg)
    if plan.gsinc is not None:
        return _interpolate_groups(plan, uk, 3)
    ug = torch.fft.irfftn(uk, s=plan.params.grid, dim=(1, 2, 3))
    return interpolate(plan, ug)


# ---------------------------------------------------------------------------
# Real-space product and the full product
# ---------------------------------------------------------------------------


def near_rows(plan: SpectralPlan, f, mesh=None):
    """The near-field remainder rows (N, 3B) without the self term: kernel
    K6 (with mixed radii kernel P2); under a mesh of several ranks this
    rank's share alone (K6's target cells, P2's targets), the other rows
    zero."""
    p = plan.params
    sharded = mesh_mod.is_sharded(mesh)
    if plan.cheb_radii is not None:
        return cell_kernels.near_rpy_radii(
            plan.positions, f, plan.group_of, plan.cell_table,
            plan.cell_dims, p.box, p.cell_capacity, plan.cheb_radii,
            plan.radii_edges, r_cut=p.r_cut, pairs=plan.radii_pairs,
            targets=mesh.share(f.shape[0]) if sharded else None)
    cells_range = (mesh.share(int(np.prod(plan.cell_dims))) if sharded
                   else None)
    return cell_kernels.near_rpy(
        plan.positions, f, plan.cell_table, plan.cell_dims, p.box,
        p.cell_capacity, plan.cheb, two_a=2.0 * p.a, r_cut=p.r_cut,
        cells_range=cells_range)


def real_matvec(plan: SpectralPlan, forces):
    """Near-field remainder (kernel K6; with mixed radii kernel P2) plus
    the self term, (N, 3B)."""
    n = plan.positions.shape[0]
    f = forces.reshape(n, -1).contiguous()
    return near_rows(plan, f) + plan.self_coeff * f


def wave_share(plan: SpectralPlan, f, mesh):
    """This rank's share of the wave rows (N, C) under a mesh whose size
    divides gx and gy: its x planes spread, the distributed rFFT (z and y
    on the slab, an all_to_all to a ky slice, x there), the k-scaling of
    its ky slice, the inverse mirrored, and the interpolation from its
    planes. The ranks' shares sum to wave_matvec."""
    p = plan.params
    gx, gy, gz = p.grid
    nxl, nyl = gx // mesh.size, gy // mesh.size
    planes = (mesh.rank * nxl, nxl)
    y0 = mesh.rank * nyl
    ids = plane_particles(plan, planes)
    g = spread(plan, f[ids], ids, planes=planes)         # (C, nxl, gy, gz)
    gk = torch.fft.fft(torch.fft.rfft(g, dim=3), dim=2)
    gk = mesh_mod.all_to_all(mesh, gk, split_dim=2, concat_dim=1)
    gk = torch.fft.fft(gk, dim=1)                        # (C, gx, nyl, nz2)
    kern = plan.kernel[:, y0:y0 + nyl]
    khat = plan.khat[:, :, y0:y0 + nyl]
    gb = gk.reshape(-1, 3, *gk.shape[1:])
    kdotg = torch.sum(khat[None] * gb, dim=1, keepdim=True)
    uk = (kern[None, None] * (gb - khat[None] * kdotg)).reshape(gk.shape)
    uk = torch.fft.ifft(uk, dim=1)
    uk = mesh_mod.all_to_all(mesh, uk, split_dim=1, concat_dim=2)
    ug = torch.fft.irfft(torch.fft.ifft(uk, dim=2), n=gz, dim=3)
    rows = torch.zeros((f.shape[0], f.shape[1]), dtype=f.dtype,
                       device=f.device)
    rows[ids] = interpolate(plan, ug, ids, planes=planes)
    return rows


def matvec_sharded(plan: SpectralPlan, forces, mesh):
    """M f under a mesh of several ranks, (N, 3B) -> (N, 3B) on every
    rank (the module's docstring): the near rows of this rank's cells and
    its share of the wave rows, summed over the ranks in one
    all_reduce_sum, then the self term. The wave runs replicated when the
    grid does not divide into the ranks or on a mixed-radii plan."""
    n = plan.positions.shape[0]
    f = forces.reshape(n, -1).contiguous()
    gx, gy, _ = plan.params.grid
    reason = ("radii" if plan.gsinc is not None
              else "grid" if gx % mesh.size or gy % mesh.size else None)
    partial = near_rows(plan, f, mesh)
    if reason is None:
        partial = partial + wave_share(plan, f, mesh)
    out = mesh_mod.all_reduce_sum(mesh, partial)
    if reason is not None:
        if REPLICATED_WAVE[reason] == 0:
            log.info("ewald.matvec_sharded: the wave part runs replicated "
                     "(%s) on %d ranks, as the JAX package's does",
                     "mixed radii" if reason == "radii"
                     else f"grid {plan.params.grid}", mesh.size)
        REPLICATED_WAVE[reason] += 1
        out = out + wave_matvec(plan, f)
    return out + plan.self_coeff * f


def matvec(plan: SpectralPlan, forces, mesh=None):
    """Full periodic RPY product M f, (N,3) -> (N,3); a mesh of several
    ranks shares it out (matvec_sharded)."""
    if mesh_mod.is_sharded(mesh):
        return matvec_sharded(plan, forces, mesh).reshape(forces.shape)
    return real_matvec(plan, forces) + wave_matvec(plan, forces)


def matvec_multi(plan: SpectralPlan, forces, mesh=None):
    """Stacked products M f_b, (B, N, 3) -> (B, N, 3), in one engine sweep:
    the window weights and the near-field Chebyshev scalars are shared
    across the B right-hand sides (under a mesh, one sharded sweep)."""
    B, n = forces.shape[0], forces.shape[1]
    if B == 1:
        return matvec(plan, forces[0], mesh=mesh)[None]
    f = forces.permute(1, 0, 2).reshape(n, 3 * B)       # b-major channels
    if mesh_mod.is_sharded(mesh):
        out = matvec_sharded(plan, f, mesh)
    else:
        out = real_matvec(plan, f) + wave_matvec(plan, f)
    return out.reshape(n, B, 3).permute(1, 0, 2)
