"""Hand-written CUDA kernels of the mobility/force engine, beside their
plain PyTorch versions.

Counterpart of rigidmultiblobswall_tpu/ops/mobility_pallas.py, all three
of its kernels:
  K2 `blob_blob_forces`: the blob-blob repulsion (`blob_blob_forces_pallas`
     there, `csrc/blob_forces.cu` here);
  K3 `dense_tt`: the tt mobility of one configuration, materialized as the
     interleaved (3N, 3N) matrix with the height shift, 1/(8 pi eta a) and
     the wall damping folded in (`dense_tt_pallas` and its caller
     models/saddle.py:130-139 there, `csrc/dense_tt.cu` here);
  K4 `symm_matvec`: u = M v from the upper-triangle tiles of that matrix,
     for one right-hand side or the lockstep solves' pairs
     (`symm_planes_matvec` there, `csrc/symm_planes.cu` here).
Each wrapper launches its kernel for CUDA tensors (float32 or float64) and
runs its plain PyTorch version for CPU tensors; any other device raises.
The (3,3,N,N) component planes of the JAX package exist to avoid the
TPU's padding of a minor length-3 axis; the port's layout is the
interleaved matrix M[3i+a, 3j+b], whose rows K4 reads as contiguous
segments and whose plain product is one matmul.
"""

from __future__ import annotations

import math

import torch

from . import _build, pair_kernels
from . import mobility as mob

# number of K2 launches made by `blob_blob_forces` in this process
LAUNCHES = 0
# number of K3 / K4 launches made by `dense_tt` / `symm_matvec`
DENSE_LAUNCHES = {"dense_tt": 0, "symm_matvec": 0}
# K4's tile edge in blobs (csrc/symm_planes.cu kBlobs): the kernel reads
# the tiles M[3 T I : 3 T (I+1), 3 T J : 3 T (J+1)] with J >= I only
SYMM_TILE = 64


def blob_blob_forces_plain(r_vectors, *, repulsion_strength, debye_length,
                           blob_radius):
    """Plain PyTorch K2: row-tiled O(N^2) soft repulsion, (N,3) -> (N,3)
    (forces.py:48-109 without periodic images)."""
    n = r_vectors.shape[0]
    row_tile = int(min(max((1 << 26) // (max(n, 1) * 8), 8), max(n, 1)))
    eps_over_b = repulsion_strength / debye_length
    two_a = 2.0 * blob_radius
    ids = torch.arange(n, device=r_vectors.device)
    out = torch.empty_like(r_vectors)
    for i0 in range(0, n, row_tile):
        ri = r_vectors[i0:i0 + row_tile]
        rows = torch.arange(i0, i0 + ri.shape[0], device=r_vectors.device)
        d = ri[:, None, :] - r_vectors[None, :, :]
        r2 = torch.sum(d * d, dim=-1)
        skip = (rows[:, None] == ids[None, :]) | (r2 == 0.0)
        rnorm = torch.sqrt(torch.where(skip, torch.ones_like(r2), r2))
        mag = torch.where(
            rnorm > two_a,
            eps_over_b * torch.exp(-(rnorm - two_a) / debye_length) / rnorm,
            eps_over_b / rnorm)
        mag = torch.where(skip, torch.zeros_like(mag), mag)
        out[i0:i0 + ri.shape[0]] = torch.sum(mag[..., None] * d, dim=1)
    return out


def fold_law(eps_over_b, inv_b, two_a):
    """The folded law of K2 and K5 (csrc/force_law.cuh): mag = eob r^-1
    2^min(c2a - c r, 0) with (eob, c, c2a) = (eps/b, log2(e)/b, 2a c)."""
    c = math.log2(math.e) * float(inv_b)
    return float(eps_over_b), c, float(two_a) * c


def force_law(repulsion_strength, debye_length, blob_radius):
    """K2's folded law from the repulsion's own parameters (fold_law)."""
    b = float(debye_length)
    return fold_law(float(repulsion_strength) / b, 1.0 / b,
                    2.0 * float(blob_radius))


def blob_blob_forces(r_vectors, *, repulsion_strength, debye_length,
                     blob_radius):
    """K2 wrapper: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors. r_vectors (N,3) -> (N,3), non-periodic. On the card the
    kernel takes K1's symmetric sweep over `pair_kernels.plan_groups`'
    tile groups, into a workspace (G, N, 3) summed in a fixed order."""
    if r_vectors.device.type == "cpu":
        return blob_blob_forces_plain(
            r_vectors, repulsion_strength=repulsion_strength,
            debye_length=debye_length, blob_radius=blob_radius)
    global LAUNCHES
    r = r_vectors
    if r.device.type != "cuda":
        raise ValueError(f"blob_blob_forces: unsupported device {r.device}")
    if r.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"blob_blob_forces: dtype {r.dtype} "
                        "(float32/float64 only)")
    if r.ndim != 2 or r.shape[1] != 3 or not r.is_contiguous():
        raise ValueError("blob_blob_forces: r_vectors must be a contiguous "
                         f"(N,3) tensor, got {tuple(r.shape)}")
    if 3 * r.shape[0] >= 2 ** 31:
        raise ValueError("blob_blob_forces: too many rows for 32-bit "
                         "indexing")
    out = torch.empty_like(r)
    if r.shape[0] == 0:
        return out
    n = r.shape[0]
    groups, per = pair_kernels.plan_groups(n, pair_kernels._n_sm(r))
    ws = torch.empty((groups, n, 3), dtype=r.dtype, device=r.device)
    name = ("blob_forces_f32" if r.dtype == torch.float32
            else "blob_forces_f64")
    fn = getattr(_build.library(), name)
    err = fn(r.data_ptr(), out.data_ptr(), ws.data_ptr(), n, groups, per,
             *force_law(repulsion_strength, debye_length, blob_radius),
             torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(name, err)
    LAUNCHES += 1
    return out


def _check_cuda(what, *tensors):
    """Device, dtype and contiguity checks shared by the K3/K4 wrappers."""
    t0 = tensors[0]
    if t0.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {t0.device}")
    if t0.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{what}: dtype {t0.dtype} (float32/float64 only)")
    for t in tensors:
        if t.device != t0.device or t.dtype != t0.dtype:
            raise ValueError(f"{what}: mixed {t.dtype} on {t.device} and "
                             f"{t0.dtype} on {t0.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensor is not contiguous")


def dense_tt_plain(r_vectors, eta, a, *, wall):
    """Plain PyTorch K3: the row-tiled (3N, 3N) builder of ops/mobility.py
    with the scaling folded in."""
    return mob.dense_mobility_tiled(
        r_vectors, eta, a, domain="single_wall" if wall else "no_wall")


def dense_tt(r_vectors, eta, a, *, wall):
    """K3 wrapper: the tt mobility of the configuration r_vectors (N,3) as
    the interleaved (3N, 3N) matrix, in the dtype of r_vectors. The CUDA
    kernel for CUDA tensors, `dense_tt_plain` for CPU tensors."""
    if r_vectors.device.type == "cpu":
        return dense_tt_plain(r_vectors, eta, a, wall=wall)
    r = r_vectors
    _check_cuda("dense_tt", r)
    if r.ndim != 2 or r.shape[1] != 3:
        raise ValueError(f"dense_tt: r_vectors must be (N,3), got "
                         f"{tuple(r.shape)}")
    n = r.shape[0]
    if 3 * n >= 2 ** 31:
        raise ValueError("dense_tt: too many blobs for 32-bit row indexing")
    out = torch.empty((3 * n, 3 * n), dtype=r.dtype, device=r.device)
    if n == 0:
        return out
    name = "dense_tt_f32" if r.dtype == torch.float32 else "dense_tt_f64"
    fn = getattr(_build.library(), name)
    err = fn(r.data_ptr(), out.data_ptr(), n, float(a),
             1.0 / (8.0 * math.pi * float(eta) * float(a)), int(bool(wall)),
             torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(name, err)
    DENSE_LAUNCHES["dense_tt"] += 1
    return out


def symm_matvec_plain(m, vec):
    """Plain PyTorch K4: the full product of the (3N, 3N) matrix, (N,3) ->
    (N,3) or a stack (b, N, 3) -> (b, N, 3)."""
    n3 = m.shape[0]
    v = vec.reshape(-1, n3).to(m.dtype)
    return (m @ v.T).T.reshape(vec.shape if vec.ndim == 3 else (-1, 3))


def symm_matvec(m, vec):
    """K4 wrapper: u = M v for the symmetric mobility M (3N, 3N) from
    `dense_tt` and v (N,3) (or flat), or a stack v (b, N, 3), reading only
    M's upper-triangle tiles on the card (one launch per pair of
    right-hand sides); `symm_matvec_plain` for CPU tensors. Returns (N,3)
    or (b, N, 3)."""
    if m.device.type == "cpu":
        return symm_matvec_plain(m, vec)
    n3 = m.shape[0]
    n_rhs = vec.numel() // n3 if n3 else 0
    if (m.ndim != 2 or m.shape[1] != n3 or n3 % 3
            or n_rhs * n3 != vec.numel() or (vec.ndim < 3 and n_rhs > 1)):
        raise ValueError(f"symm_matvec: shapes {tuple(m.shape)} and "
                         f"{tuple(vec.shape)}; expected (3N,3N) and (N,3) or "
                         "(b,N,3)")
    v = vec.reshape(n_rhs, n3).contiguous()
    _check_cuda("symm_matvec", m, v)
    if n3 >= 2 ** 31:
        raise ValueError("symm_matvec: too many rows for 32-bit indexing")
    out = torch.empty_like(v)
    shape = vec.shape if vec.ndim == 3 else (-1, 3)
    if n3 == 0:
        return out.reshape(shape)
    n_tiles = -(-n3 // (3 * SYMM_TILE))
    name = ("symm_matvec_f32" if m.dtype == torch.float32
            else "symm_matvec_f64")
    fn = getattr(_build.library(), name)
    stream = torch.cuda.current_stream(m.device).cuda_stream
    for b0 in range(0, v.shape[0], 2):
        vb = v[b0:b0 + 2]
        # one slot per (output tile, contributing tile, right-hand side):
        # each written once by the first pass, summed in a fixed order by
        # the second
        partials = torch.empty((n_tiles, n_tiles, vb.shape[0],
                                3 * SYMM_TILE), dtype=m.dtype,
                               device=m.device)
        err = fn(m.data_ptr(), vb.data_ptr(), partials.data_ptr(),
                 out[b0:b0 + 2].data_ptr(), n3, vb.shape[0], stream)
        _build.check(name, err)
        DENSE_LAUNCHES["symm_matvec"] += 1
    return out.reshape(shape)
