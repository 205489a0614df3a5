"""Boundary-integral Laplace operators of the phoretic model (PyTorch),
with kernel L1.

Counterpart of rigidmultiblobswall_tpu/ops/laplace.py: `single_layer`
(S), `double_layer` (D), `deriv_double_layer` (dD, the surface gradient's
kernel) and `dipole` (T), each with optional half-space (wall) images and
the self mask, and two fused sums of the phoretic solve:
`bvp_operator`, c/2 - D[c] + S[k c / Dc], and `surface_gradient`,
2 dD[c] - 2 T[(q - k c) / Dc]. Every operator weights each source by
its quadrature weight, with prefactor 1/(4 pi).

Each function launches kernel L1 (`csrc/laplace_layers.cu`, float32 or
float64, counted in `LAUNCHES[op, self_interaction]`) for CUDA tensors
and runs its plain PyTorch version (`*_plain`) for CPU tensors; any other
device raises. Where the targets are the sources (the fused sums, and
r_tgt the same tensor as r_src) L1 takes its symmetric sweep, which forms
each unordered pair once over `pair_kernels.plan_groups`' tile groups and
adds its terms to both ends (counted also in `SYM_LAUNCHES`); other
targets take the directed sweep over `plan_slices`' source slices.

The JAX package forms these sums as XLA on materialized (Nt, Ns, 3)
pair tensors; the plain versions keep its masks and order
term for term but take the targets in chunks, so that no (chunk, Ns, 3)
temporary exceeds `PLAIN_CHUNK_BYTES`. The fused plain versions compose
the unfused ones in the JAX package's order (models/phoretic.py there).

Masks, as the JAX package sets them: a real pair is dropped at zero
distance or, with self_interaction, at index coincidence (target i,
source i); an image only at zero image distance, where the single layer
keeps 1/R = 1 (its `_inv_r`) and the others vanish.
"""

from __future__ import annotations

import math

import torch

from . import _build, pair_kernels

# L1's operators and their C codes (csrc/laplace_layers.cu Op); the
# output components of each
OPS = {"S": 0, "D": 1, "dD": 2, "T": 3, "bvp": 4, "grad": 5}
NOUT = {"S": 1, "D": 1, "dD": 3, "T": 3, "bvp": 1, "grad": 3}
# L1 launches in this process by (operator, self_interaction), and those
# of them on the symmetric sweep
LAUNCHES = {(op, s): 0 for op in OPS for s in (True, False)}
SYM_LAUNCHES = dict.fromkeys(LAUNCHES, 0)
# the largest (chunk, Ns, 3) pair temporary of a plain version
PLAIN_CHUNK_BYTES = 1 << 27
# float32 blocks of L1 an SM holds at a time (128 threads,
# __launch_bounds__(128, 8): pairk::Shape; the slice plan aims for
# pair_kernels.PLAN_WAVES waves of them)
BLOCKS_PER_SM = 8

_FOUR_PI = 4.0 * math.pi


def launches(op):
    """L1 launches of operator `op` in this process, both masks."""
    return LAUNCHES[op, True] + LAUNCHES[op, False]


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _chunk_rows(n_t, n_s, itemsize):
    return max(1, min(n_t, PLAIN_CHUNK_BYTES // max(1, 3 * n_s * itemsize)))


def _inv_r(d2, mask_zero):
    return 1.0 / torch.sqrt(torch.where(mask_zero, 1.0, d2))


def _pairs(r_src, r_tgt, t0, self_interaction):
    """The pair geometry of targets t0.. against every source: d (t, s, 3),
    the image height z_t + z_s (t, s), |d|^2 and the real pair's mask."""
    d = r_tgt[:, None, :] - r_src[None, :, :]
    rz_img = r_tgt[:, 2][:, None] + r_src[:, 2][None, :]
    d2 = torch.sum(d * d, dim=-1)
    ti = torch.arange(t0, t0 + r_tgt.shape[0], device=d.device)[:, None]
    sj = torch.arange(r_src.shape[0], device=d.device)[None, :]
    zero = ((ti == sj) & bool(self_interaction)) | (d2 == 0.0)
    return d, rz_img, d2, zero


def _chunked(fn, r_src, r_tgt, self_interaction):
    """fn(d, rz_img, d2, zero) -> (t, ...) over target chunks."""
    rows = _chunk_rows(r_tgt.shape[0], r_src.shape[0], r_src.element_size())
    out = [fn(*_pairs(r_src, r_tgt[t0:t0 + rows], t0, self_interaction))
           for t0 in range(0, r_tgt.shape[0], rows)]
    return torch.cat(out, dim=0)


def single_layer_plain(r_src, r_tgt, field, weights, *, wall=False,
                       self_interaction=True):
    """(S c)_i = 1/(4pi) sum_j c_j w_j (1/r_ij [+ 1/r_img]); (Nt,)."""
    c = field * weights

    def rows(d, rz_img, d2, zero):
        S = torch.where(zero, 0.0, _inv_r(d2, zero))
        if wall:
            d2w = d[..., 0] ** 2 + d[..., 1] ** 2 + rz_img ** 2
            S = S + _inv_r(d2w, d2w == 0.0)
        return (S @ c) / _FOUR_PI

    return _chunked(rows, r_src, r_tgt, self_interaction)


def double_layer_plain(r_src, r_tgt, field, weights, normals, *, wall=False,
                       self_interaction=True):
    """(D c)_i = 1/(4pi) sum_j c_j w_j (r_ij . n_j)/r^3 [+ the image with
    n_z reflected, added]; (Nt,)."""
    c = field * weights

    def rows(d, rz_img, d2, zero):
        invr3 = _inv_r(d2, zero) ** 3
        rn = torch.einsum("tsk,sk->ts", d, normals)
        T = torch.where(zero, 0.0, invr3 * rn)
        if wall:
            d2w = d[..., 0] ** 2 + d[..., 1] ** 2 + rz_img ** 2
            invr3w = _inv_r(d2w, d2w == 0.0) ** 3
            rnw = (d[..., 0] * normals[None, :, 0]
                   + d[..., 1] * normals[None, :, 1]
                   - rz_img * normals[None, :, 2])
            T = T + invr3w * rnw
        return (T @ c) / _FOUR_PI

    return _chunked(rows, r_src, r_tgt, self_interaction)


def _deriv_apply(d_eff, zero, nz_sign, normals):
    invr = _inv_r(torch.sum(d_eff * d_eff, dim=-1), zero)
    invr2 = invr * invr
    invr3 = invr2 * invr
    fo = -3.0 * invr2
    dx, dy, dz = d_eff[..., 0], d_eff[..., 1], d_eff[..., 2]
    Lxx = (1.0 + fo * dx * dx) * invr3
    Lxy = (fo * dx * dy) * invr3
    Lxz = (fo * dx * dz) * invr3
    Lyy = (1.0 + fo * dy * dy) * invr3
    Lyz = (fo * dy * dz) * invr3
    Lzz = -Lxx - Lyy
    nx, ny = normals[None, :, 0], normals[None, :, 1]
    nz = nz_sign * normals[None, :, 2]
    gx = Lxx * nx + Lxy * ny + Lxz * nz
    gy = Lxy * nx + Lyy * ny + Lyz * nz
    gz = Lxz * nx + Lyz * ny + Lzz * nz
    out = torch.stack([gx, gy, gz], dim=-1)
    return torch.where(zero[..., None], 0.0, out)


def deriv_double_layer_plain(r_src, r_tgt, field, weights, normals, *,
                             wall=False, self_interaction=True):
    """(L c)_i^a = 1/(4pi) sum_j c_j w_j L^{ab}(r_ij) n_j^b, L = (I - 3
    rhat rhat)/r^3 with Lzz = -Lxx - Lyy, [+ the image with n_z
    reflected]; (Nt, 3)."""
    c = field * weights

    def rows(d, rz_img, d2, zero):
        G = _deriv_apply(d, zero, 1.0, normals)
        if wall:
            d_img = torch.cat([d[..., :2], rz_img[..., None]], dim=-1)
            d2w = torch.sum(d_img * d_img, dim=-1)
            G = G + _deriv_apply(d_img, d2w == 0.0, -1.0, normals)
        return torch.einsum("tsa,s->ta", G, c) / _FOUR_PI

    return _chunked(rows, r_src, r_tgt, self_interaction)


def dipole_plain(r_src, r_tgt, field, weights, *, wall=False,
                 self_interaction=True):
    """(T c)_i^a = 1/(4pi) sum_j c_j w_j r_ij^a / r^3 [+ image]; (Nt, 3)."""
    c = field * weights

    def rows(d, rz_img, d2, zero):
        invr3 = _inv_r(d2, zero) ** 3
        T = torch.where(zero[..., None], 0.0, d * invr3[..., None])
        if wall:
            d_img = torch.cat([d[..., :2], rz_img[..., None]], dim=-1)
            d2w = torch.sum(d_img * d_img, dim=-1)
            invr3w = _inv_r(d2w, d2w == 0.0) ** 3
            T = T + d_img * invr3w[..., None]
        return torch.einsum("tsa,s->ta", T, c) / _FOUR_PI

    return _chunked(rows, r_src, r_tgt, self_interaction)


def bvp_operator_plain(r, c, weights, normals, k_rate, dc, *, wall=False):
    """c/2 - D[c] + S[k c / Dc] on the surface (self mask on), in the JAX
    package's order (models/phoretic.py phoretic_slip's operator)."""
    x = 0.5 * c
    x = x - double_layer_plain(r, r, c, weights, normals, wall=wall)
    return x + single_layer_plain(r, r, k_rate * c / dc, weights, wall=wall)


def surface_gradient_plain(r, c, weights, normals, k_rate, q_rate, dc, *,
                           wall=False):
    """2 dD[c] - 2 T[(q - k c) / Dc] on the surface (self mask on), the
    layers of the concentration gradient in the JAX package's order."""
    g = 2.0 * deriv_double_layer_plain(r, r, c, weights, normals, wall=wall)
    return g - 2.0 * dipole_plain(r, r, (q_rate - k_rate * c) / dc, weights,
                                  wall=wall)


# ---------------------------------------------------------------------------
# Kernel L1
# ---------------------------------------------------------------------------


def plan_slices(n_tgt, n_src, n_sm):
    """(S, tiles_per_slice) of L1's source slices: K1's sliced-sweep plan
    (pair_kernels.plan_slices) for BLOCKS_PER_SM resident blocks and a
    float64 workspace row of three values."""
    return pair_kernels.plan_slices(n_tgt, n_src, n_sm, BLOCKS_PER_SM, 24)


def _launch(op, r_src, r_tgt, *, c, w, normals=None, k=None, q=None,
            dc=1.0, wall, self_interaction):
    """Kernel L1 for operator `op` on CUDA tensors, on the symmetric sweep
    when r_tgt is r_src (the self mask is then implied: i == j is a zero
    distance), else on the directed sweep; returns (Nt,) or (Nt, 3)."""
    symmetric = r_tgt is r_src
    tensors = [r_src, r_tgt, c, w] + [t for t in (normals, k, q)
                                      if t is not None]
    t0 = tensors[0]
    if t0.device.type != "cuda":
        raise ValueError(f"laplace {op}: unsupported device {t0.device}")
    if t0.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"laplace {op}: dtype {t0.dtype} (float32/float64 "
                        "only)")
    for t in tensors:
        if t.device != t0.device or t.dtype != t0.dtype:
            raise ValueError(f"laplace {op}: mixed {t.dtype} on {t.device} "
                             f"and {t0.dtype} on {t0.device}")
    ns, nt = r_src.shape[0], r_tgt.shape[0]
    if r_src.shape != (ns, 3) or r_tgt.shape != (nt, 3):
        raise ValueError(f"laplace {op}: positions must be (N, 3)")
    if 3 * max(ns, nt) >= 2 ** 31:
        raise ValueError(f"laplace {op}: too many rows for 32-bit indexing")
    r_src, c, w = (x.contiguous() for x in (r_src, c, w))
    r_tgt = r_src if symmetric else r_tgt.contiguous()
    normals, k, q = (None if x is None else x.contiguous()
                     for x in (normals, k, q))
    if c.shape != (ns,) or w.shape != (ns,):
        raise ValueError(f"laplace {op}: field and weights must be (Ns,)")
    nout = NOUT[op]
    out = torch.empty((nt, nout) if nout == 3 else (nt,), dtype=t0.dtype,
                      device=t0.device)
    if nt == 0:
        return out
    if ns == 0:
        return out.zero_()
    suffix = "f32" if t0.dtype == torch.float32 else "f64"
    n_sm = pair_kernels._n_sm(t0)
    stream = torch.cuda.current_stream(t0.device).cuda_stream

    def ptr(x):
        return None if x is None else x.data_ptr()

    if symmetric:
        groups, per = pair_kernels.plan_groups(ns, n_sm)
        ws = torch.empty((groups, ns, nout), dtype=torch.float64,
                         device=t0.device)
        name = f"laplace_layers_sym_{suffix}"
        err = getattr(_build.library(), name)(
            OPS[op], int(bool(wall)), r_src.data_ptr(), ptr(normals),
            c.data_ptr(), w.data_ptr(), ptr(k), ptr(q), float(dc), ns,
            groups, per, ws.data_ptr(), out.data_ptr(), stream)
    else:
        slices, per = plan_slices(nt, ns, n_sm)
        ws = torch.empty((slices, nt, nout), dtype=torch.float64,
                         device=t0.device)
        name = f"laplace_layers_{suffix}"
        err = getattr(_build.library(), name)(
            OPS[op], int(bool(wall)), int(bool(self_interaction)),
            r_src.data_ptr(), r_tgt.data_ptr(), ptr(normals), c.data_ptr(),
            w.data_ptr(), ptr(k), ptr(q), float(dc), ns, nt, slices, per,
            ws.data_ptr(), out.data_ptr(), stream)
    _build.check(name, err)
    LAUNCHES[op, bool(self_interaction)] += 1
    if symmetric:
        SYM_LAUNCHES[op, bool(self_interaction)] += 1
    return out


def _on_cpu(t, what):
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {t.device}")
    return False


# ---------------------------------------------------------------------------
# Public operators: L1 on the card, the plain versions on the CPU
# ---------------------------------------------------------------------------


def single_layer(r_src, r_tgt, field, weights, *, wall=False,
                 self_interaction=True):
    """(S c)_i = 1/(4pi) sum_j c_j w_j (1/r_ij [+ 1/r_img]); (Nt,)."""
    if _on_cpu(r_src, "single_layer"):
        return single_layer_plain(r_src, r_tgt, field, weights, wall=wall,
                                  self_interaction=self_interaction)
    return _launch("S", r_src, r_tgt, c=field, w=weights, wall=wall,
                   self_interaction=self_interaction)


def double_layer(r_src, r_tgt, field, weights, normals, *, wall=False,
                 self_interaction=True):
    """(D c)_i = 1/(4pi) sum_j c_j w_j (r_ij . n_j)/r^3 [+ image with n_z
    reflected]; (Nt,)."""
    if _on_cpu(r_src, "double_layer"):
        return double_layer_plain(r_src, r_tgt, field, weights, normals,
                                  wall=wall,
                                  self_interaction=self_interaction)
    return _launch("D", r_src, r_tgt, c=field, w=weights, normals=normals,
                   wall=wall, self_interaction=self_interaction)


def deriv_double_layer(r_src, r_tgt, field, weights, normals, *, wall=False,
                       self_interaction=True):
    """The surface gradient kernel L = (I - 3 rhat rhat)/r^3 applied to
    n_j, trace-corrected, [+ image with n_z reflected]; (Nt, 3)."""
    if _on_cpu(r_src, "deriv_double_layer"):
        return deriv_double_layer_plain(r_src, r_tgt, field, weights,
                                        normals, wall=wall,
                                        self_interaction=self_interaction)
    return _launch("dD", r_src, r_tgt, c=field, w=weights, normals=normals,
                   wall=wall, self_interaction=self_interaction)


def dipole(r_src, r_tgt, field, weights, *, wall=False,
           self_interaction=True):
    """(T c)_i^a = 1/(4pi) sum_j c_j w_j r_ij^a / r^3 [+ image]; (Nt, 3)."""
    if _on_cpu(r_src, "dipole"):
        return dipole_plain(r_src, r_tgt, field, weights, wall=wall,
                            self_interaction=self_interaction)
    return _launch("T", r_src, r_tgt, c=field, w=weights, wall=wall,
                   self_interaction=self_interaction)


def bvp_operator(r, c, weights, normals, k_rate, dc, *, wall=False):
    """The phoretic BVP operator c/2 - D[c] + S[k c / Dc] over the blobs
    r (self mask on), one L1 sweep on the card; (N,)."""
    if _on_cpu(r, "bvp_operator"):
        return bvp_operator_plain(r, c, weights, normals, k_rate, dc,
                                  wall=wall)
    return _launch("bvp", r, r, c=c, w=weights, normals=normals, k=k_rate,
                   dc=dc, wall=wall, self_interaction=True)


def surface_gradient(r, c, weights, normals, k_rate, q_rate, dc, *,
                     wall=False):
    """The layers of the surface concentration gradient, 2 dD[c] -
    2 T[(q - k c) / Dc] over the blobs r (self mask on), one L1 sweep on
    the card; (N, 3)."""
    if _on_cpu(r, "surface_gradient"):
        return surface_gradient_plain(r, c, weights, normals, k_rate, q_rate,
                                      dc, wall=wall)
    return _launch("grad", r, r, c=c, w=weights, normals=normals, k=k_rate,
                   q=q_rate, dc=dc, wall=wall, self_interaction=True)
