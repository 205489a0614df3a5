"""Kernel K1: the direct O(N^2) translation-translation pair product.

Counterpart of rigidmultiblobswall_tpu/ops/pair_kernels.py
(`pair_matvec_pallas`, coupling "tt"). The tr/rt/rr/grand couplings are
still to be ported (ROADMAP Queue 2, K1).

`pair_tt` takes normalized inputs (lengths / a, wall heights already
shifted to max(z, a), vector already damped; the caller applies
1/(8 pi eta a) and the target damping) and B right-hand sides stacked
as b-major columns, vec (Ns, 3B) -> (Nt, 3B):

- on a CUDA tensor it launches the hand-written kernel in
  `csrc/pair_tt.cu` (float32 or float64) and counts the launch in
  `LAUNCHES`;
- on a CPU tensor it runs `pair_tt_plain`, the row-tiled sum of the RPY
  and wall blocks from ops/rpy.py (the JAX package's generic tiled path,
  mobility.py:228-284, without periodic images). Tests and the chip
  smoke compare the kernel against it.
"""

from __future__ import annotations

import torch

from . import _build, rpy

# number of K1 launches made by `pair_tt` in this process
LAUNCHES = 0

# right-hand sides per launch (the kernel's template set): B = 1 for the
# GMRES corrector, Lanczos and the M W products, B = 2 for the lockstep
# det+RFD solve
MAX_RHS = 2


def _default_row_tile(n_src, n_tgt, itemsize, budget_bytes=1 << 26):
    """Target rows per tile so one (tile, Ns, 3, 3) block stays within
    the budget (mobility.py:_default_row_tile)."""
    per_row = max(n_src, 1) * 9 * itemsize
    return int(min(max(budget_bytes // per_row, 8), max(n_tgt, 1)))


def pair_tt_plain(q_src, q_tgt, vec, *, wall, self_interaction):
    """Plain PyTorch K1: out[i] = sum_j M_tt(q_tgt[i], q_src[j]) vec[j] for
    each right-hand side, computed from materialized (tile, Ns, 3, 3)
    blocks. Target row i pairs with source row i as `self` when
    self_interaction is set (targets are the leading sources)."""
    n_src, n_tgt = q_src.shape[0], q_tgt.shape[0]
    n_rhs = vec.shape[1] // 3
    v = vec.reshape(n_src, n_rhs, 3)
    row_tile = _default_row_tile(n_src, n_tgt, q_src.element_size())
    src_ids = torch.arange(n_src, device=q_src.device)
    zs = q_src[:, 2][None, :]
    out = torch.empty((n_tgt, 3 * n_rhs), dtype=q_src.dtype,
                      device=q_src.device)
    for i0 in range(0, n_tgt, row_tile):
        qt = q_tgt[i0:i0 + row_tile]
        rows = torch.arange(i0, i0 + qt.shape[0], device=q_src.device)
        d = qt[:, None, :] - q_src[None, :, :]
        self_mask = (rows[:, None] == src_ids[None, :]) & self_interaction
        m = rpy.rpy_tt(d, self_mask)
        if wall:
            zt = qt[:, 2][:, None]
            m = m + rpy.wall_tt(d[..., 0], d[..., 1], zt + zs,
                                zs.expand_as(d[..., 0]), self_mask)
        out[i0:i0 + qt.shape[0]] = torch.einsum(
            "tsab,skb->tka", m, v).reshape(qt.shape[0], 3 * n_rhs)
    return out


def pair_tt(q_src, q_tgt, vec, *, wall, self_interaction):
    """K1 wrapper: the CUDA kernel for CUDA tensors, `pair_tt_plain` for
    CPU tensors. q_src (Ns,3), q_tgt (Nt,3), vec (Ns,3B) -> (Nt,3B)."""
    if q_src.device.type == "cpu":
        return pair_tt_plain(q_src, q_tgt, vec, wall=wall,
                             self_interaction=self_interaction)
    global LAUNCHES
    n_src, n_tgt = q_src.shape[0], q_tgt.shape[0]
    _check(q_src, q_tgt, vec)
    n_rhs = vec.shape[1] // 3
    out = torch.empty((n_tgt, 3 * n_rhs), dtype=vec.dtype,
                      device=vec.device)
    if n_tgt == 0 or n_src == 0:
        return out.zero_()
    name = "pair_tt_f32" if vec.dtype == torch.float32 else "pair_tt_f64"
    fn = getattr(_build.library(), name)
    err = fn(q_src.data_ptr(), q_tgt.data_ptr(), vec.data_ptr(),
             out.data_ptr(), n_src, n_tgt, n_rhs, int(bool(wall)),
             int(bool(self_interaction)),
             torch.cuda.current_stream(vec.device).cuda_stream)
    _build.check(name, err)
    LAUNCHES += 1
    return out


def _check(q_src, q_tgt, vec):
    if q_src.device.type != "cuda":
        raise ValueError(f"pair_tt: unsupported device {q_src.device}")
    dtype = vec.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"pair_tt: dtype {dtype} (float32/float64 only)")
    for name, t in (("q_src", q_src), ("q_tgt", q_tgt), ("vec", vec)):
        if t.device != vec.device or t.dtype != dtype:
            raise ValueError(f"pair_tt: {name} is {t.dtype} on {t.device}, "
                             f"expected {dtype} on {vec.device}")
        if not t.is_contiguous():
            raise ValueError(f"pair_tt: {name} is not contiguous")
    if (q_src.ndim != 2 or q_src.shape[1] != 3 or q_tgt.ndim != 2
            or q_tgt.shape[1] != 3 or vec.ndim != 2
            or vec.shape[0] != q_src.shape[0] or vec.shape[1] % 3
            or vec.shape[1] == 0):
        raise ValueError(f"pair_tt: shapes q_src {tuple(q_src.shape)}, "
                         f"q_tgt {tuple(q_tgt.shape)}, vec "
                         f"{tuple(vec.shape)}; expected (Ns,3), (Nt,3), "
                         f"(Ns,3B)")
    if vec.shape[1] // 3 > MAX_RHS:
        raise ValueError(f"pair_tt: {vec.shape[1] // 3} right-hand sides; "
                         f"the kernel takes 1 to {MAX_RHS}")
    if max(q_src.shape[0], q_tgt.shape[0]) * vec.shape[1] >= 2 ** 31:
        raise ValueError("pair_tt: too many rows for 32-bit indexing")
