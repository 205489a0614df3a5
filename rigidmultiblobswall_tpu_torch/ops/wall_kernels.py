"""Runtime support for the spectral single-wall engine (ops/ewald_wall).

Bridges the GENERATED channel math (_wall_channels_gen, produced by
tools/gen_wall_channels.py) to the engine:

* scaled radial Chebyshev tables: the near-field image remainder needs
  d^n/du^n of the screened generators g4, g2 (u = r^2) at pair
  distances; everything is evaluated in blob-radius units (r' = r/a,
  h' = h/a, A2 = 1) so the f32 kernels stay conditioned like ops/rpy.py,
  with one overall 1/(8 pi eta a) prefactor outside;
* host-side evaluation of the channel k-multiplier entries straight
  from the CHANNELS term table (used by the polish-mode quadrature and
  the k_par = 0 Laurent finite parts — the generated mult_terms code is
  the device path);
* the polish-mode Toeplitz kernel builder: for the few smallest
  in-plane modes (including k_par = 0) the zero-padded-z FFT wraps the
  slab kernel; those columns are applied exactly as dense z-convolutions
  built from continuous-k_z quadrature (see ewald_wall docstring).

Physics source: the Blake/Swan-Brady image system of the reference
(mobility/mobility_numba.py:1553-1647), rederived in operator form by
tools/gen_wall_channels.py.

The PyTorch port's copy (host numpy, verbatim) of
rigidmultiblobswall_tpu/ops/wall_kernels.py, so that both packages build
the same tables: the trans-trans tables of ops/ewald_wall.py and the
rot-coupling ones (build_polish_kernels_rot and its helpers) of
ops/ewald_wall_rot.py.
"""

from __future__ import annotations

import functools
import math

import numpy as np

from . import _wall_channels_gen as gen

# number of radial derivative orders used by the generated apply code
N_RAD = 5


class _NpMath:
    """numpy shim for the generated math.* closed-form strings."""

    pi = np.pi

    @staticmethod
    def sqrt(x):
        return np.sqrt(x)

    @staticmethod
    def exp(x):
        return np.exp(x)

    @staticmethod
    def erfc(x):
        from scipy.special import erfc

        return erfc(x)


def radial_scaled(kind, n, r_scaled, xi_scaled):
    """a-scaled generator derivative: for u' = (r/a)^2 returns
    a^(2n-1) * d^n/du^n g_base(u) evaluated at u = a^2 u', which equals
    d^n/du'^n of the scaled generator — i.e. the value to feed the
    generated code running on scaled inputs (A2 = 1). kind in
    {'g4','g2','e4','e2'}; xi_scaled = xi * a."""
    u = np.asarray(r_scaled, np.float64) ** 2
    src = gen.RADIAL_SRC[kind][n]
    return eval(src, {"math": _NpMath},
                {"u": u, "xi": float(xi_scaled)})


@functools.lru_cache(maxsize=32)
def img_cheb_tables(xi_scaled: float, r_lo: float, r_hi: float,
                    n_cheb: int = 0, tol: float = 1e-7):
    """TWO-piece Chebyshev fits of the 10 radial inputs of the generated
    near-field apply (c4_0..c4_4 then c2_0..c2_4) over scaled radius
    [r_lo, r_hi] (units of a). The screened generators are smooth but
    their erfc transition near r_lo needs far more terms than the flat
    tail; splitting keeps the in-kernel Clenshaw short (a single piece
    needed K=64 at bench r_cut/a ~ 26 — 3x the pair flops).
    Returns (coeffs (2, 10, K), r_lo, r_mid, r_hi)."""
    from numpy.polynomial import chebyshev as npcheb

    r_mid = r_lo + 0.28 * (r_hi - r_lo)
    edges = [(r_lo, r_mid), (r_mid, r_hi)]
    for K in ([n_cheb] if n_cheb else (10, 12, 16, 20, 24, 28, 32)):
        out = np.zeros((2, 10, K))
        err = 0.0
        for pidx, (lo, hi) in enumerate(edges):
            r = np.linspace(lo, hi, 3001)
            t = (2.0 * r - (hi + lo)) / (hi - lo)
            funcs = [radial_scaled("g4", n, r, xi_scaled)
                     for n in range(N_RAD)]
            funcs += [radial_scaled("g2", n, r, xi_scaled)
                      for n in range(N_RAD)]
            for i, f in enumerate(funcs):
                out[pidx, i] = npcheb.chebfit(t, f, K - 1)
                scale = max(np.abs(f).max(), 1e-30)
                err = max(err, np.abs(
                    npcheb.chebval(t, out[pidx, i]) - f).max() / scale)
        if n_cheb or err < tol:
            break
    if not n_cheb and err >= tol:
        raise RuntimeError(f"img radial fit stalled at err {err}")
    return out, float(r_lo), float(r_mid), float(r_hi)


def img_radial_values_np(r_scaled, xi_scaled):
    """Direct (f64, host) radial inputs at scaled radii — the oracle
    path for tests; the engine uses the Chebyshev tables."""
    return ([radial_scaled("g4", n, r_scaled, xi_scaled)
             for n in range(N_RAD)]
            + [radial_scaled("g2", n, r_scaled, xi_scaled)
               for n in range(N_RAD)])


def img_exact_values_np(r_scaled):
    """Exact generator derivatives (sqrt(u), 1/sqrt(u)): feeding these
    to the generated apply evaluates the FULL channel kernels."""
    return ([radial_scaled("e4", n, r_scaled, 0.0) for n in range(N_RAD)]
            + [radial_scaled("e2", n, r_scaled, 0.0) for n in range(N_RAD)])


# ---------------------------------------------------------------------------
# Host-side channel multiplier entries from the term table (polish path)
# ---------------------------------------------------------------------------

_OP_NZ = {"iso": 0, "hess": None, "zrow": None, "zcol": None, "zz": 0}


_EPS3 = np.zeros((3, 3, 3))
_EPS3[0, 1, 2] = _EPS3[1, 2, 0] = _EPS3[2, 0, 1] = 1
_EPS3[0, 2, 1] = _EPS3[2, 1, 0] = _EPS3[1, 0, 2] = -1


def _term_entry_factor(op, i, j, kx, ky, kz):
    """The op's (i, j) tensor factor as a (complex) array over k.
    Covers the tt ops and the pseudo-tensor (rot-coupling) ops of
    tools/gen_wall_channels.py."""
    K = (kx, ky, kz)

    def _eps_dot(a, b):
        """sum_k eps_{a b k} (i k_k)."""
        out = 0.0
        for k in range(3):
            if _EPS3[a, b, k]:
                out = out + float(_EPS3[a, b, k]) * (1j * K[k])
        return out

    if op == "iso":
        return 1.0 if i == j else 0.0
    if op == "hess":
        return (1j * K[i]) * (1j * K[j])
    if op == "zrow":
        return (1j * K[j]) if i == 2 else 0.0
    if op == "zcol":
        return (1j * K[i]) if j == 2 else 0.0
    if op == "zz":
        return 1.0 if (i == 2 and j == 2) else 0.0
    if op == "curl":
        return _eps_dot(i, j)
    if op == "eps3":
        return float(_EPS3[i, j, 2])
    if op == "zcurlgrad":
        return _eps_dot(i, 2) * (1j * K[j])
    if op == "gradzcurl":
        return (1j * K[i]) * _eps_dot(j, 2)
    if op == "zcurlzcol":
        return _eps_dot(i, 2) if j == 2 else 0.0
    if op == "zrowzcurl":
        return _eps_dot(j, 2) if i == 2 else 0.0
    raise KeyError(op)


def channel_entry_np(m, i, j, kx, ky, kz, phi, a2=1.0):
    """(i, j) entry of the channel-m k-multiplier T_hat_m(k) * phi as a
    numpy array (scaled units: pass scaled k and a2 = 1). Includes the
    radius monomials at equal radii. NO 1/(8 pi eta a) prefactor."""
    kx = np.asarray(kx, np.float64)
    k2 = kx * kx + ky * ky + kz * kz
    k2s = np.where(k2 > 0, k2, 1.0)
    f4 = phi * (-8.0 * np.pi) / (k2s * k2s)
    f2 = phi * (4.0 * np.pi) / k2s
    mon = {"1": 1.0, "a2": a2, "b2": a2, "a2b2": a2 * a2}
    out = np.zeros(np.broadcast(kx, ky, kz).shape, complex)
    for (mm, name), terms in gen.CHANNELS.items():
        if mm != m:
            continue
        for (op, base, p, fr) in terms:
            fac = _term_entry_factor(op, i, j, kx, ky, kz)
            if np.isscalar(fac) and fac == 0.0:
                continue
            fhat = (f4 if base == 4 else f2) * (1j * kz) ** p
            out = out + float(fr) * mon[name] * fac * fhat
    return out


def channel_laurent_k0(m, i, j, a2=1.0):
    """Laurent coefficients (c2, c1) of entry (i,j) of T_hat_m at
    k_par = 0 around k_z = 0: entry ~ c2/k_z^2 + c1/k_z + regular.
    (phi - 1 = O(k^4), so these equal the unscreened coefficients.)"""
    c2 = 0.0 + 0.0j
    c1 = 0.0 + 0.0j
    mon = {"1": 1.0, "a2": a2, "b2": a2, "a2b2": a2 * a2}
    for (mm, name), terms in gen.CHANNELS.items():
        if mm != m:
            continue
        for (op, base, p, fr) in terms:
            # tensor factor at kx = ky = 0: only z-derivative entries live
            if op == "iso":
                nz, live = 0, (i == j)
            elif op == "hess":
                nz, live = 2, (i == 2 and j == 2)
            elif op == "zrow":
                nz, live = 1, (i == 2 and j == 2)
            elif op == "zcol":
                nz, live = 1, (i == 2 and j == 2)
            else:  # zz
                nz, live = 0, (i == 2 and j == 2)
            if not live:
                continue
            amp = (-8.0 * np.pi if base == 4 else 4.0 * np.pi)
            pole = (4 if base == 4 else 2) - p - nz
            coef = float(fr) * mon[name] * amp * (1j) ** (p + nz)
            if pole == 2:
                c2 += coef
            elif pole == 1:
                c1 += coef
            elif pole > 2:
                raise RuntimeError(
                    f"unexpected pole order {pole} for {(op, base, p)}")
    return c2, c1


# ---------------------------------------------------------------------------
# Polish-mode Toeplitz kernels (continuous-k_z quadrature)
# ---------------------------------------------------------------------------


def _es_window_hat_np(k, R, beta, n_quad=2000):
    from scipy.integrate import simpson

    x = np.linspace(0.0, R, n_quad)
    t = np.clip(x / R, -1.0, 1.0)
    w = np.exp(beta * (np.sqrt(np.maximum(1.0 - t * t, 0.0)) - 1.0))
    k = np.atleast_1d(np.asarray(k, np.float64))
    return 2.0 * simpson(w[None, :] * np.cos(np.outer(k, x)), x=x, axis=1)


def build_polish_kernels(modes_kxky, dz_grid, *, a, eta, xi, hx, hy, hz,
                         support, es_beta, what_x, what_y, tol,
                         n_quad=4097):
    """Dense z-convolution kernels for the polish modes.

    modes_kxky: (P, 2) PHYSICAL in-plane wavenumbers (kx, ky) — includes
    (0, 0).  dz_grid: (nd,) physical z displacements (target z - source
    grid z) at which the Toeplitz kernels are needed.  what_x/what_y:
    the 1-D window transforms evaluated AT each mode (P,).

    Returns complex128 (P, 4, 3, 3, nd): for each mode, channel c in
    {0: merged sinc^2-RPY, 1..3: image channels T0..T2}, the kernel
      T_c(k_par, dz) = (hz / 2 pi) int_{-pi/hz}^{pi/hz} dk_z
          M_c(k, k_z) * N(k, k_z) * e^{i k_z dz},
    with N = (hx hy hz) / (what_x^2 what_y^2 what_z(k_z)^2) — exactly
    the main path's multiplier normalization, continuous in k_z (the
    aperiodic-z convolution the padded FFT only approximates).  At
    k_par = 0 the 1/k_z^2 and 1/k_z poles are removed analytically and
    added back as their finite parts -|dz|/2 and (i/2) sign(dz)
    (IFT conventions; constants drop against the image system's zero
    net monopole / the engine's polish-mode physics tests)."""
    P = len(modes_kxky)
    nd = len(dz_grid)
    kz = np.linspace(-np.pi / hz, np.pi / hz, n_quad)
    mid = n_quad // 2                     # kz == 0 exactly (n_quad odd)
    assert kz[mid] == 0.0
    # SCREENED pole subtractions at k_par = 0 and their closed-form 1-D
    # IFTs. Subtracting bare 1/k_z^{1,2} poles would re-introduce
    # out-of-band kernel content that the gridded data cannot carry
    # (measured: a 2.7% error on the k0 Couette kernel); the screened
    # poles phi/k_z^{1,2} are band-limited like everything else:
    #   (1/2pi) int phi/k_z^2 e^{i k_z dz} = -(dz/2) erf(xi dz)
    #                                        - e^{-xi^2 dz^2}/(4 xi sqrt(pi))
    #   (1/2pi) int phi/k_z   e^{i k_z dz} = i [ erf(xi dz)/2
    #                                   + (xi dz/(2 sqrt(pi))) e^{-xi^2 dz^2} ]
    from scipy.special import erf as _erf

    kz_s = np.where(kz == 0, 1.0, kz)
    u_pole = kz * kz / (4 * xi * xi)
    phi_pole = (1.0 + u_pole) * np.exp(-u_pole)
    pole2 = phi_pole / kz_s ** 2
    pole1 = phi_pole / kz_s
    sdz = xi * dz_grid
    fp2 = (-(dz_grid / 2) * _erf(sdz)
           - np.exp(-sdz * sdz) / (4 * xi * np.sqrt(np.pi)))
    fp1 = 1j * (_erf(sdz) / 2
                + (sdz / (2 * np.sqrt(np.pi))) * np.exp(-sdz * sdz))
    wz = _es_window_hat_np(np.abs(kz), 0.5 * support * hz, es_beta)
    hvol = hx * hy * hz
    out = np.zeros((P, 4, 3, 3, nd), complex)
    # Simpson weights on the uniform grid -> the whole mode reduces to
    # one (36, nq) @ (nq, nd) GEMM instead of per-entry quadratures
    swts = np.ones(n_quad)
    swts[1:-1:2] = 4.0
    swts[2:-1:2] = 2.0
    swts *= (kz[1] - kz[0]) / 3.0
    exp_mat = np.exp(1j * np.outer(kz, dz_grid)) * swts[:, None]  # (nq, nd)

    a2 = a * a

    def one_mode(ip, kxv, kyv):
        """Reference per-mode path; only the k_par = 0 mode (which needs
        the pole finite parts) takes it."""
        k2 = kxv * kxv + kyv * kyv + kz * kz
        k2s = np.where(k2 > 0, k2, 1.0)
        k = np.sqrt(k2s)
        phi = (1.0 + k2 / (4 * xi * xi)) * np.exp(-k2 / (4 * xi * xi))
        sinc = np.sin(k * a) / (k * a)
        norm = hvol / (what_x[ip] ** 2 * what_y[ip] ** 2 * wz ** 2)
        k0_mode = (kxv == 0.0 and kyv == 0.0)
        kvec = (np.full_like(kz, kxv), np.full_like(kz, kyv), kz)
        pref = sinc * sinc * phi / (eta * k2s)

        rows = np.zeros((36, n_quad), complex)   # (channel*9, nq)
        fins = np.zeros((36, nd), complex)       # finite-part additions
        kill = np.zeros(36, bool)
        for i in range(3):
            for j in range(3):
                row = 9 * 0 + 3 * i + j
                ent = pref * ((1.0 if i == j else 0.0)
                              - kvec[i] * kvec[j] / k2s) * norm
                if k0_mode and i == j and i < 2:
                    c2 = norm[mid] / eta
                    ent = ent - c2 * pole2
                    ent[mid] = 0.5 * (ent[mid - 1] + ent[mid + 1])
                    fins[row] += 2 * np.pi * c2 * fp2
                elif k0_mode and i == 2 and j == 2:
                    kill[row] = True   # projector kills zz exactly
                else:
                    ent = np.where(k2 == 0, 0.0, ent)
                rows[row] = ent
        for m in range(3):
            for i in range(3):
                for j in range(3):
                    row = 9 * (1 + m) + 3 * i + j
                    ent = channel_entry_np(m, i, j, kxv, kyv, kz, phi,
                                           a2=a2)
                    ent = ent * norm / (8 * np.pi * eta)
                    if k0_mode:
                        c2, c1 = channel_laurent_k0(m, i, j, a2=a2)
                        c2 = c2 * norm[mid] / (8 * np.pi * eta)
                        c1 = c1 * norm[mid] / (8 * np.pi * eta)
                        ent = ent - c2 * pole2 - c1 * pole1
                        ent[mid] = 0.5 * (ent[mid - 1] + ent[mid + 1])
                        fins[row] += 2 * np.pi * (c2 * fp2 + c1 * fp1)
                    else:
                        ent = np.where(k2 == 0, 0.0, ent)
                    rows[row] = ent
        block = (rows @ exp_mat + fins) * (hz / (2 * np.pi))
        block[kill] = 0.0
        return block.reshape(4, 3, 3, nd)

    # ---- k_par > 0 modes: vectorized in chunks (flat slabs can have
    # thousands of polish modes; the per-mode python loop took minutes)
    kx_all = modes_kxky[:, 0]
    ky_all = modes_kxky[:, 1]
    k0_mask = (kx_all == 0.0) & (ky_all == 0.0)
    for ip in np.nonzero(k0_mask)[0]:
        out[ip] = one_mode(ip, kx_all[ip], ky_all[ip])
    rest = np.nonzero(~k0_mask)[0]
    KZ = kz[None, :]
    for c0 in range(0, len(rest), 64):
        sel = rest[c0:c0 + 64]
        C = len(sel)
        KX = kx_all[sel][:, None]
        KY = ky_all[sel][:, None]
        k2 = KX * KX + KY * KY + KZ * KZ             # (C, nq), > 0
        k = np.sqrt(k2)
        phi = (1.0 + k2 / (4 * xi * xi)) * np.exp(-k2 / (4 * xi * xi))
        sinc = np.sin(k * a) / (k * a)
        norm = hvol / (what_x[sel][:, None] ** 2
                       * what_y[sel][:, None] ** 2 * wz[None, :] ** 2)
        pref = sinc * sinc * phi / (eta * k2)
        kvec = (KX + 0 * KZ, KY + 0 * KZ, 0 * KX + KZ)
        rows = np.empty((C, 36, n_quad), complex)
        for i in range(3):
            for j in range(3):
                rows[:, 3 * i + j] = pref * (
                    (1.0 if i == j else 0.0)
                    - kvec[i] * kvec[j] / k2) * norm
        for m in range(3):
            for i in range(3):
                for j in range(3):
                    ent = channel_entry_np(m, i, j, KX, KY, KZ, phi,
                                           a2=a2)
                    rows[:, 9 * (1 + m) + 3 * i + j] = (
                        ent * norm / (8 * np.pi * eta))
        block = np.einsum("cfq,qd->cfd", rows, exp_mat,
                          optimize=True) * (hz / (2 * np.pi))
        out[sel] = block.reshape(C, 4, 3, 3, nd)
    return out


def _w_r_np(x):
    """RPY rotlet window 3 j1(x)/x with series near 0 (ewald._w_r)."""
    x = np.asarray(x, np.float64)
    small = np.abs(x) < 1e-4
    xs = np.where(small, 1.0, x)
    j1_over_x = (np.sin(xs) / xs - np.cos(xs)) / (xs * xs)
    return np.where(small, 1.0 - x * x / 10.0, 3.0 * j1_over_x)


def rot_channel_entry_np(table, i, j, kx, ky, kz, phi, a):
    """(i, j) entry of a rot-coupling channel k-multiplier (table =
    list of (op, base=2, p, fr) from gen.CHANNELS_RT[m] / CHANNELS_RR),
    evaluated at PHYSICAL wavenumbers. The rot tables are fitted in
    a-scaled lengths (their rational coefficients are only
    dimensionally consistent there), so factors evaluate at k*a; the
    result carries NO 1/(8 pi eta a^n) prefactor (caller applies it)."""
    kx = np.asarray(kx, np.float64)
    ks = (a * kx, a * ky, a * kz)
    k2s = ks[0] * ks[0] + ks[1] * ks[1] + ks[2] * ks[2]
    k2s = np.where(k2s > 0, k2s, 1.0)
    f2 = phi * (4.0 * np.pi) / k2s
    out = np.zeros(np.broadcast(kx, ky, kz).shape, complex)
    for (op, base, p, fr) in table:
        assert base == 2, (op, base)
        fac = _term_entry_factor(op, i, j, *ks)
        if np.isscalar(fac) and fac == 0.0:
            continue
        out = out + float(fr) * fac * f2 * (1j * ks[2]) ** p
    return out


def rot_channel_laurent_k0(table, i, j):
    """Laurent coefficients (c2, c1) of the (i, j) entry of a rot
    channel multiplier at k_par = 0 around (scaled) k_z = 0, in the
    SCALED variables (entry ~ c2/kz_s^2 + c1/kz_s + regular, kz_s =
    a kz). The tensor factor at kx = ky = 0 is a monomial c (i kz)^nz;
    c and nz are extracted numerically (exact for monomials)."""
    c2 = 0.0 + 0.0j
    c1 = 0.0 + 0.0j
    for (op, base, p, fr) in table:
        assert base == 2
        f1 = _term_entry_factor(op, i, j, 0.0, 0.0, 1.0)
        if np.isscalar(f1) and f1 == 0.0:
            continue
        f2v = _term_entry_factor(op, i, j, 0.0, 0.0, 2.0)
        f1 = complex(f1)
        f2v = complex(f2v)
        if abs(f1) < 1e-300:
            continue
        nz = int(round(math.log2(abs(f2v) / abs(f1))))
        c = f1 / (1j) ** nz
        pole = 2 - p - nz
        coef = float(fr) * c * 4.0 * np.pi * (1j) ** (p + nz)
        if pole == 2:
            c2 += coef
        elif pole == 1:
            c1 += coef
        elif pole > 2:
            raise RuntimeError(f"unexpected pole {pole} for {(op, p)}")
    return c2, c1


# rot polish channel list: (name, input field, output field)
#   inputs: D = real-spread torque, C = real-spread force,
#           E = image-spread torque, B0/B1 = image-spread (f, (h/a) f)
#   outputs: V = velocity field, V1 = velocity field to be scaled by
#            the target height h_t/a at interpolation, W = angular
#            velocity field
ROT_POLISH_CHANNELS = (
    "tr_pair",    # 0: D -> V    cross pair  u = gamma_w (t x d)
    "rr_pair",    # 1: D -> W    rr pair
    "rt_pair",    # 2: C -> W    cross pair  w = gamma_w (f x d)
    "tr_img0",    # 3: E -> V    image tr, m = 0 (transposed-reflected RT)
    "tr_img1",    # 4: E -> V1   image tr, m = 1
    "rt_img0",    # 5: B0 -> W   image rt, m = 0
    "rt_img1",    # 6: B1 -> W   image rt, m = 1
    "rr_img",     # 7: E -> W    image rr
)


def build_polish_kernels_rot(modes_kxky, dz_grid, *, a, eta, xi, hx, hy,
                             hz, support, es_beta, what_x, what_y, tol,
                             n_quad=4097):
    """Rot-coupling analog of build_polish_kernels: dense z-convolution
    Toeplitz kernels for the polish modes over the 8 rot channel blocks
    of ROT_POLISH_CHANNELS. Same conventions (continuous k_z quadrature,
    window-deconvolution normalization, screened pole finite parts at
    k_par = 0). Units: rt/tr blocks carry 1/(8 pi eta a^2), rr blocks
    1/(8 pi eta a^3) — i.e. the kernels act on RAW torque/force fields
    and produce physical velocity / angular-velocity fields.

    Returns complex128 (P, 8, 3, 3, nd)."""
    from scipy.special import erf as _erf

    P = len(modes_kxky)
    nd = len(dz_grid)
    kz = np.linspace(-np.pi / hz, np.pi / hz, n_quad)
    mid = n_quad // 2
    assert kz[mid] == 0.0
    kz_s = np.where(kz == 0, 1.0, kz)
    u_pole = kz * kz / (4 * xi * xi)
    phi_pole = (1.0 + u_pole) * np.exp(-u_pole)
    # SCALED poles: 1/(a kz)^{1,2} with closed-form 1-D IFTs in the
    # physical variable: IFT[phi/(a kz)^2] = fp2/a^2, IFT[phi/(a kz)]
    # = fp1/a (fp as in build_polish_kernels)
    sdz = xi * dz_grid
    fp2 = (-(dz_grid / 2) * _erf(sdz)
           - np.exp(-sdz * sdz) / (4 * xi * np.sqrt(np.pi)))
    fp1 = 1j * (_erf(sdz) / 2
                + (sdz / (2 * np.sqrt(np.pi))) * np.exp(-sdz * sdz))
    wz = _es_window_hat_np(np.abs(kz), 0.5 * support * hz, es_beta)
    hvol = hx * hy * hz
    swts = np.ones(n_quad)
    swts[1:-1:2] = 4.0
    swts[2:-1:2] = 2.0
    swts *= (kz[1] - kz[0]) / 3.0
    exp_mat = np.exp(1j * np.outer(kz, dz_grid)) * swts[:, None]

    # physical k-multiplier of a scaled-fit channel: W_phys(R) =
    # pref_n W~(R/a)  =>  W^_phys(k) = pref_n a^3 W~^(a k) — the a^3 is
    # the Fourier measure of the length rescaling (the near evaluators,
    # which work directly in scaled lengths, carry pref_n alone)
    pref_c = (1.0 / (8 * np.pi * eta * a * a)) * a ** 3   # rt/tr
    pref_r = pref_c / a                                   # rr
    NCH = len(ROT_POLISH_CHANNELS)
    out = np.zeros((P, NCH, 3, 3, nd), complex)
    eps = _EPS3

    def mode_rows(KXv, KYv, KZv, norm, batched):
        """(C?, NCH*9, nq) integrand rows at k_par > 0 (no poles)."""
        k2 = KXv * KXv + KYv * KYv + KZv * KZv
        k2s = np.where(k2 > 0, k2, 1.0)
        k = np.sqrt(k2s)
        phi = (1.0 + k2 / (4 * xi * xi)) * np.exp(-k2 / (4 * xi * xi))
        sinc = np.sin(k * a) / (k * a)
        wr = _w_r_np(k * a)
        shape = np.broadcast(KXv, KYv, KZv).shape
        if batched:
            rows = np.zeros((shape[0], NCH * 9, shape[-1]), complex)
        else:
            rows = np.zeros((NCH * 9, shape[-1]), complex)
        kvec = (KXv + 0 * KZv, KYv + 0 * KZv, 0 * KXv + KZv)
        # pair cross: u_hat = +i (k x t_hat) sinc wr phi/(2 eta k^2)
        #   M_il = i eps_{ilm}... as matrix: M[i][j] = i eps_{i j'?}
        # (M t)_i = i eps_{imj} k_m t_j  (from u = +i k x t * pref)
        pc = sinc * wr * phi / (2 * eta * k2s) * norm
        for i in range(3):
            for j in range(3):
                ent = 0.0
                for m in range(3):
                    if eps[i, m, j]:
                        ent = ent + float(eps[i, m, j]) * 1j * kvec[m]
                if np.isscalar(ent):
                    continue
                v = ent * pc
                rows[..., 0 * 9 + 3 * i + j, :] = v   # tr_pair
                rows[..., 2 * 9 + 3 * i + j, :] = v   # rt_pair
        # pair rr: (wr^2 phi / (4 eta)) (I - khat khat)
        pr = wr * wr * phi / (4 * eta) * norm
        for i in range(3):
            for j in range(3):
                ent = ((1.0 if i == j else 0.0)
                       - kvec[i] * kvec[j] / k2s)
                rows[..., 1 * 9 + 3 * i + j, :] = ent * pr
        # image channels (scaled factors at k a)
        for i in range(3):
            for j in range(3):
                e_tr0 = rot_channel_entry_np(
                    gen.CHANNELS_RT[0], j, i, -KXv, -KYv, KZv, phi, a)
                e_tr1 = rot_channel_entry_np(
                    gen.CHANNELS_RT[1], j, i, -KXv, -KYv, KZv, phi, a)
                e_rt0 = rot_channel_entry_np(
                    gen.CHANNELS_RT[0], i, j, KXv, KYv, KZv, phi, a)
                e_rt1 = rot_channel_entry_np(
                    gen.CHANNELS_RT[1], i, j, KXv, KYv, KZv, phi, a)
                e_rr = rot_channel_entry_np(
                    gen.CHANNELS_RR, i, j, KXv, KYv, KZv, phi, a)
                rows[..., 3 * 9 + 3 * i + j, :] = e_tr0 * norm * pref_c
                rows[..., 4 * 9 + 3 * i + j, :] = e_tr1 * norm * pref_c
                rows[..., 5 * 9 + 3 * i + j, :] = e_rt0 * norm * pref_c
                rows[..., 6 * 9 + 3 * i + j, :] = e_rt1 * norm * pref_c
                rows[..., 7 * 9 + 3 * i + j, :] = e_rr * norm * pref_r
        return rows

    kx_all = modes_kxky[:, 0]
    ky_all = modes_kxky[:, 1]
    k0_mask = (kx_all == 0.0) & (ky_all == 0.0)

    # ---- k_par = 0 mode: pole subtraction. Live poles:
    #  - pair cross entries (0,1)/(1,0): +-i phi (sinc wr)/ (2 eta kz)
    #    -> c1 = +-i norm0/(2 eta), remainder O(kz) regular;
    #  - image rot channels: generic scaled Laurent (pole order <= 1
    #    for every table; asserted).
    for ip in np.nonzero(k0_mask)[0]:
        norm0 = hvol / (what_x[ip] ** 2 * what_y[ip] ** 2 * wz ** 2)
        phi = phi_pole
        sinc = np.where(kz == 0, 1.0, np.sin(kz_s * a) / (kz_s * a))
        wr = _w_r_np(kz * a)
        rows = np.zeros((NCH * 9, n_quad), complex)
        fins = np.zeros((NCH * 9, nd), complex)
        # pair cross (i eps_{imj} kz for m = z): entries (0,1) = -i kz,
        # (1,0) = +i kz  [eps_{0 2 1} = -1, eps_{1 2 0} = +1]
        for (i, j, sgn) in ((0, 1, -1.0), (1, 0, 1.0)):
            full = sgn * 1j * kz * sinc * wr * phi / (
                2 * eta * np.where(kz == 0, 1.0, kz * kz)) * norm0
            c1 = sgn * 1j / (2 * eta) * norm0[mid]
            ent = full - c1 * phi / kz_s
            ent[mid] = 0.5 * (ent[mid - 1] + ent[mid + 1])
            fins_term = 2 * np.pi * c1 * fp1
            for ch in (0, 2):
                rows[ch * 9 + 3 * i + j] = ent
                fins[ch * 9 + 3 * i + j] += fins_term
        # pair rr: regular; zz entry is exactly 0 at k_par = 0
        pr = wr * wr * phi / (4 * eta) * norm0
        rows[1 * 9 + 3 * 0 + 0] = pr
        rows[1 * 9 + 3 * 1 + 1] = pr
        # image channels
        tabs = [(3, gen.CHANNELS_RT[0], True, pref_c),
                (4, gen.CHANNELS_RT[1], True, pref_c),
                (5, gen.CHANNELS_RT[0], False, pref_c),
                (6, gen.CHANNELS_RT[1], False, pref_c),
                (7, gen.CHANNELS_RR, False, pref_r)]
        for ch, tab, transpose, pref in tabs:
            for i in range(3):
                for j in range(3):
                    ii, jj = (j, i) if transpose else (i, j)
                    ent = rot_channel_entry_np(tab, ii, jj, 0.0, 0.0,
                                               kz, phi, a) * norm0 * pref
                    c2, c1 = rot_channel_laurent_k0(tab, ii, jj)
                    assert abs(c2) == 0.0, (ch, i, j, c2)
                    if c1 != 0.0:
                        # scaled pole phi/(a kz), coefficient frozen at
                        # the smooth norm's kz = 0 value (tt pattern);
                        # physical 1-D IFT of phi/kz is fp1
                        cc = c1 * norm0[mid] * pref / a
                        ent = ent - cc * phi / kz_s
                        fins[ch * 9 + 3 * i + j] += 2 * np.pi * cc * fp1
                    ent[mid] = 0.5 * (ent[mid - 1] + ent[mid + 1])
                    rows[ch * 9 + 3 * i + j] = ent
        block = (rows @ exp_mat + fins) * (hz / (2 * np.pi))
        out[ip] = block.reshape(NCH, 3, 3, nd)

    # ---- k_par > 0 modes, batched
    rest = np.nonzero(~k0_mask)[0]
    KZb = kz[None, :]
    for c0 in range(0, len(rest), 64):
        sel = rest[c0:c0 + 64]
        KXb = kx_all[sel][:, None]
        KYb = ky_all[sel][:, None]
        norm = hvol / (what_x[sel][:, None] ** 2
                       * what_y[sel][:, None] ** 2 * wz[None, :] ** 2)
        rows = mode_rows(KXb, KYb, KZb, norm, batched=True)
        block = np.einsum("cfq,qd->cfd", rows, exp_mat,
                          optimize=True) * (hz / (2 * np.pi))
        out[sel] = block.reshape(len(sel), NCH, 3, 3, nd)
    return out


def _graded_kz_quadrature(kz_max, n_base, kp_min):
    """Symmetric composite-Simpson kz grid: outer uniform segments at
    the n_base resolution plus dyadic refinement down to the Lorentzian
    width kp_min around kz = 0 (per-segment step ~ |kz|/16, bounded
    relative feature size for the 1/(kz^2 + kp^2) factors). EXACTLY
    mirror-symmetric — (kz, -kz) pairs carry equal weights, so the
    assembled kernels' realness after the z-phase transform stays
    structural, not a quadrature accident. Segment endpoints are
    duplicated (each segment carries both of its endpoints; duplicates
    just split the weight); kz == 0 occurs exactly once, strictly
    inside the central segment. Returns (kz, weights), sorted."""
    h_out = 2.0 * kz_max / max(n_base - 1, 2)
    w0 = min(max(kp_min, kz_max * 1e-7), kz_max / 4)
    W_out = min(max(32.0 * h_out, 2.0 * w0), kz_max / 2)

    def seg(lo, hi, n_int):
        n_int = max(2, int(n_int) + int(n_int) % 2)      # even intervals
        x = np.linspace(lo, hi, n_int + 1)
        w = np.ones(n_int + 1)
        w[1:-1:2] = 4.0
        w[2:-1:2] = 2.0
        w *= (hi - lo) / n_int / 3.0
        return x, w

    pos = []                                             # kz > 0 segments
    b = w0
    while b < W_out:
        t = min(2.0 * b, W_out)
        pos.append(seg(b, t, 16))
        b = t
    pos.append(seg(W_out, kz_max,
                   int(math.ceil((kz_max - W_out) / h_out))))
    xc, wc = seg(-w0, w0, 32)                            # 0 at center
    assert xc[len(xc) // 2] == 0.0
    xs = [xc] + [x for x, _ in pos] + [-x[::-1] for x, _ in pos]
    ws = [wc] + [w for _, w in pos] + [w[::-1] for _, w in pos]
    kz = np.concatenate(xs)
    wt = np.concatenate(ws)
    order = np.argsort(kz, kind="stable")
    return kz[order], wt[order]


def wave_zkernel_nodes(kpars, z_nodes, *, a, eta, xi, n_quad=8193):
    """Per-in-plane-mode z-operators of the WAVE part of the wall
    mobility, for the closed-form Brownian sampler (ewald_wall.
    wall_wave_sqrt_noise).

    For each k_par value, builds the (3p, 3p) matrix over (component,
    z-node) pairs of the POINT-evaluated screened kernel

      G[(i,a),(j,b)] = A_ij(z_a - z_b) - A_ij(z_a + z_b) D_jj
                       + sum_m z_b^m T^m_ij(z_a + z_b)

    where A is the sinc^2-phi screened RPY multiplier's continuous-k_z
    transform (the merged real+image channel), D = diag(1,1,-1) the
    mirror, and T^m the generated image-channel multipliers — exactly
    the engine's wave channels (ewald_wall.wave_matvec) with the
    gridding windows stripped (point sources/targets, aperiodic z).
    Components are in the ROTATED in-plane frame (l = along k_par,
    t = transverse, z), where G depends on |k_par| only and is
    block-diagonal over {l, z} x {t}.

    Entries coupling l<->z are pure imaginary with Hermitian G; the
    returned matrices are the REAL symmetric transform T G T^dagger,
    T = diag(1_l, 1_t, i * 1_z): multiply z-noise by i before applying
    a real factor and by -i after (phases preserve white noise).

    k_par = 0 carries the screened 1/k_z^{1,2} poles; they are
    subtracted and re-added as closed-form finite parts exactly as in
    build_polish_kernels.

    Returns (nk, 3p, 3p) float64, Hermitian-symmetrized; PSD up to
    quadrature error (callers add a tiny ridge before Cholesky)."""
    from scipy.special import erf as _erf

    z_nodes = np.asarray(z_nodes, np.float64)
    p = len(z_nodes)
    # kz band: the phi screen kills e^{-u} beyond u ~ 25. The smallest
    # nonzero k_par modes put a Lorentzian of width ~k_par at kz = 0 —
    # the quadrature must resolve it. A UNIFORM grid at that resolution
    # is O(xi / kp_min) points: the Chebyshev k_par nodes cluster as
    # k_cut (pi / 2 pk)^2 near 0, which at bench wall slabs drove
    # n_quad past 10^6 and the (nq, 2 p^2) exp_mat past 17 GB of host
    # RAM (round-4's invisible "compile" stall was THIS host loop). The
    # graded symmetric grid below resolves the Lorentzian with dyadic
    # refinement instead: per-segment Simpson, step ~ |kz|/16 inside
    # the refinement window, so each segment has bounded relative
    # feature size and the total stays ~n_quad + O(log(1/kp_min)).
    kp_min = min((k for k in np.asarray(kpars, float) if k > 0),
                 default=1.0)
    kz_max = 10.0 * xi
    kz, swts = _graded_kz_quadrature(kz_max, n_quad, kp_min)
    n_quad = len(kz)
    zero_ix = np.nonzero(kz == 0.0)[0]

    def _patch_zeros(ent):
        """Neighbor-average the (smooth, pole-subtracted) integrand at
        every kz == 0 abscissa; zeros sit strictly inside their uniform
        segment so index neighbors are segment neighbors."""
        ent[zero_ix] = 0.5 * (ent[zero_ix - 1] + ent[zero_ix + 1])
        return ent

    # dz values: p^2 differences then p^2 sums (flattened (a, b))
    dzd = (z_nodes[:, None] - z_nodes[None, :]).reshape(-1)
    dzs = (z_nodes[:, None] + z_nodes[None, :]).reshape(-1)
    dz_all = np.concatenate([dzd, dzs])
    exp_mat = np.exp(1j * np.outer(kz, dz_all)) * swts[:, None]

    # screened pole finite parts (build_polish_kernels conventions)
    kz_s = np.where(kz == 0, 1.0, kz)
    u_pole = kz * kz / (4 * xi * xi)
    phi_pole = (1.0 + u_pole) * np.exp(-u_pole)
    pole2 = phi_pole / kz_s ** 2
    pole1 = phi_pole / kz_s
    sdz = xi * dz_all
    fp2 = (-(dz_all / 2) * _erf(sdz)
           - np.exp(-sdz * sdz) / (4 * xi * np.sqrt(np.pi)))
    fp1 = 1j * (_erf(sdz) / 2
                + (sdz / (2 * np.sqrt(np.pi))) * np.exp(-sdz * sdz))

    a2 = a * a
    hm = z_nodes[None, :] ** np.arange(3)[:, None, None]  # (3, 1, p) b-powers
    kpars = np.asarray(kpars, np.float64)
    nk = len(kpars)
    out = np.empty((nk, 3 * p, 3 * p))

    def _assemble(ik, vals):
        """(36, 2 p^2) kz-integrated values -> real symmetric (3p, 3p)."""
        Ad = vals[:9, :p * p].reshape(3, 3, p, p)        # A(z_a - z_b)
        As = vals[:9, p * p:].reshape(3, 3, p, p)        # A(z_a + z_b)
        Tm = vals[9:, p * p:].reshape(3, 3, 3, p, p)     # T^m(z_a + z_b)
        D = np.array([1.0, 1.0, -1.0])
        Gc = (Ad - As * D[None, :, None, None]
              + np.einsum("mijab,mxb->ijab", Tm, hm))
        # (i,a),(j,b) layout; z-phase transform -> real; symmetrize
        G = np.transpose(Gc, (0, 2, 1, 3)).reshape(3 * p, 3 * p)
        T = np.ones(3 * p, complex)
        T[2 * p:] = 1j
        G = (T[:, None] * G * np.conj(T)[None, :])
        if np.abs(G.imag).max() > 1e-10 * max(np.abs(G.real).max(), 1e-30):
            raise RuntimeError(
                f"wave z-kernel not real after phase transform at "
                f"k_par={kpars[ik]}: imag {np.abs(G.imag).max():.2e}")
        G = G.real
        out[ik] = 0.5 * (G + G.T)

    # ---- k_par = 0 node(s): pole finite parts, per node
    KZ = kz[None, :]
    for ik in np.nonzero(kpars == 0.0)[0]:
        k2 = kz * kz
        k2s = np.where(k2 > 0, k2, 1.0)
        phi = (1.0 + k2 / (4 * xi * xi)) * np.exp(-k2 / (4 * xi * xi))
        sinc = np.sin(np.sqrt(k2s) * a) / (np.sqrt(k2s) * a)
        pref = sinc * sinc * phi / (eta * k2s)
        rows = np.zeros((36, n_quad), complex)
        fins = np.zeros((36, 2 * p * p), complex)
        for i in range(3):
            row = 3 * i + i
            if i < 2:
                ent = pref - (1.0 / eta) * pole2
                ent = _patch_zeros(ent)
                fins[row] += 2 * np.pi * (1.0 / eta) * fp2
                rows[row] = ent
            # zz: projector kills it exactly at k_par = 0
        for m in range(3):
            for i in range(3):
                for j in range(3):
                    row = 9 * (1 + m) + 3 * i + j
                    ent = channel_entry_np(m, i, j, 0.0, 0.0, kz, phi,
                                           a2=a2) / (8 * np.pi * eta)
                    c2, c1 = channel_laurent_k0(m, i, j, a2=a2)
                    c2 = c2 / (8 * np.pi * eta)
                    c1 = c1 / (8 * np.pi * eta)
                    ent = ent - c2 * pole2 - c1 * pole1
                    ent = _patch_zeros(ent)
                    fins[row] += 2 * np.pi * (c2 * fp2 + c1 * fp1)
                    ent = np.where(k2 == 0, 0.0, ent)
                    rows[row] = ent
        _assemble(ik, ((rows @ exp_mat) + fins) / (2 * np.pi))

    # ---- k_par > 0 nodes: batched over nodes (the per-node python loop
    # over channel terms dominated at ~3 s/node)
    rest = np.nonzero(kpars > 0.0)[0]
    for c0 in range(0, len(rest), 16):
        sel = rest[c0:c0 + 16]
        KP = kpars[sel][:, None]
        k2 = KP * KP + KZ * KZ                           # (C, nq) > 0
        k = np.sqrt(k2)
        phi = (1.0 + k2 / (4 * xi * xi)) * np.exp(-k2 / (4 * xi * xi))
        sinc = np.sin(k * a) / (k * a)
        pref = sinc * sinc * phi / (eta * k2)
        kvec = (KP + 0 * KZ, 0 * k2, 0 * KP + KZ)
        rows = np.zeros((len(sel), 36, n_quad), complex)
        for i in range(3):
            for j in range(3):
                rows[:, 3 * i + j] = pref * (
                    (1.0 if i == j else 0.0) - kvec[i] * kvec[j] / k2)
        for m in range(3):
            for i in range(3):
                for j in range(3):
                    rows[:, 9 * (1 + m) + 3 * i + j] = channel_entry_np(
                        m, i, j, KP, 0.0, KZ, phi,
                        a2=a2) / (8 * np.pi * eta)
        vals = np.einsum("cfq,qd->cfd", rows, exp_mat,
                         optimize=True) / (2 * np.pi)
        for ii, ik in enumerate(sel):
            _assemble(ik, vals[ii])
    return out


def polish_mode_set(gx, gy2, kx_freqs, ky_freqs, margin, tol):
    """Indices (into the (gx, gy2) rfft2 layout) of the modes whose
    padded-z wrap error e^(-k_par * margin) exceeds ~0.03 tol; always
    includes (0, 0). Returns (flat_idx (P,), kxky (P, 2))."""
    kstar = (math.log(1.0 / max(0.03 * tol, 1e-300)) + 5.0) / max(margin,
                                                                  1e-30)
    kx = np.asarray(kx_freqs)[:, None]
    ky = np.asarray(ky_freqs)[None, :]
    kpar = np.sqrt(kx * kx + ky * ky)
    sel = kpar <= kstar
    sel[0, 0] = True
    idx = np.nonzero(sel.ravel())[0].astype(np.int32)
    kxv = np.broadcast_to(kx, (len(kx_freqs), len(ky_freqs))).ravel()[idx]
    kyv = np.broadcast_to(ky, (len(kx_freqs), len(ky_freqs))).ravel()[idx]
    return idx, np.stack([kxv, kyv], axis=1)
