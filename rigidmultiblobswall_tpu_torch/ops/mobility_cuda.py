"""Hand-written CUDA kernels of the mobility/force engine, beside their
plain PyTorch versions.

Counterpart of rigidmultiblobswall_tpu/ops/mobility_pallas.py, all three
of its kernels:
  K2 `blob_blob_forces`: the blob-blob repulsion (`blob_blob_forces_pallas`
     there, `csrc/blob_forces.cu` here), with two periodic instances for
     the minimum-image sweep of rigidmultiblobswall_tpu/ops/forces.py's
     `blob_blob_forces` (XLA there): over the image boxes, and over the
     home box alone where `image_boxes` finds the others' forces zero;
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

import ctypes
import math

import torch

from . import _build, pair_kernels
from . import mobility as mob

# number of K2 launches made by `blob_blob_forces` in this process: the
# open domain's instance and the periodic ones, of which the one-box
# instance's
LAUNCHES = 0
PERIODIC_LAUNCHES = 0
ONE_BOX_LAUNCHES = 0
# (r - 2a) / b beyond which exp(-(r - 2a)/b) is 0 in the dtype: below half
# the smallest subnormal (float32 exp(-103.98), float64 exp(-745.13)), with
# a margin for the exponential's own rounding
UNDERFLOW = {torch.float32: 110.0, torch.float64: 750.0}
# number of K3 / K4 launches made by `dense_tt` / `symm_matvec`
DENSE_LAUNCHES = {"dense_tt": 0, "symm_matvec": 0}
# K4's tile edge in blobs (csrc/symm_planes.cu kBlobs): the kernel reads
# the tiles M[3 T I : 3 T (I+1), 3 T J : 3 T (J+1)] with J >= I only
SYMM_TILE = 64


def box_offsets(periodic_length):
    """The image boxes (b_x, b_y, b_z) of the direct periodic sweep, b in
    {-1, 0, 1} on each periodic axis (L > 0), (0, 0, 0) first (the JAX
    package's ops/mobility.py _box_offsets)."""
    axes = [(-1, 0, 1) if float(L) > 0 else (0,) for L in periodic_length]
    return [(0, 0, 0)] + [(bx, by, bz) for bx in axes[0] for by in axes[1]
                          for bz in axes[2] if (bx, by, bz) != (0, 0, 0)]


def min_image(d, periodic_length):
    """Displacements into the extended unit cell, truncation form
    d - trunc(d/L + sign(d)/2) L on each periodic axis (the JAX package's
    ops/mobility.py _min_image)."""
    d = d.clone()
    for axis, L in enumerate(float(x) for x in periodic_length):
        if L > 0:
            comp = d[..., axis]
            d[..., axis] = comp - torch.trunc(
                comp / L + 0.5 * torch.sign(comp)) * L
    return d


def image_boxes(periodic_length, debye_length, blob_radius, dtype):
    """The image boxes the periodic kernel sums: every box of box_offsets,
    or the home box alone when every pair of every other box has a
    magnitude that underflows to 0 in dtype. That skip is exact: after
    the minimum image |d_a| <= L_a / 2 on each periodic axis, so a pair in
    a box with b_a != 0 lies at r >= L_a / 2 (less a rounding margin),
    and (r - 2a) / b beyond UNDERFLOW[dtype] makes exp(-(r - 2a)/b) == 0
    there, in the plain version and in the kernel's exp2.

    With one box the kernel takes its one-box instance, whose minimum
    image d - round(d (1/L)) L (csrc/blob_forces.cu OneBoxPairs; 1/L
    rounded to d's dtype, ties to even) may pick the other image than
    min_image's for a pair whose d/L lies within a few ulps of a
    half-integer. Both images then lie at r >= L/2 (1 - 2^-21 |d/L|) and
    take a zero magnitude as well: UNDERFLOW sits more than 6 above the
    exponent where exp underflows (103.97 in float32, 745.13 in float64),
    which covers that margin (and the 1e-6 below) while
    2^-21 |d/L| (110 + 2a/b) < 6, e.g. |d| < 10^4 L for 2a/b < 1000."""
    boxes = box_offsets(periodic_length)
    periodic = [float(L) for L in periodic_length if float(L) > 0]
    if periodic:
        r_min = 0.5 * min(periodic) * (1.0 - 1e-6)
        if (r_min - 2.0 * blob_radius) / debye_length > UNDERFLOW[dtype]:
            return boxes[:1]
    return boxes


def blob_blob_forces_plain(r_vectors, *, repulsion_strength, debye_length,
                           blob_radius, periodic_length=(0.0, 0.0, 0.0),
                           rows=None):
    """Plain PyTorch K2: the row-tiled O(N^2) soft repulsion of
    forces.py:48-109, (N,3) -> (N,3), with every image box of a periodic
    box (minimum image, then box_offsets; the self pair skipped in the
    home box only). `rows` (a range of target rows) limits the rows
    computed; the others stay zero."""
    n = r_vectors.shape[0]
    dev, dtype = r_vectors.device, r_vectors.dtype
    row_tile = int(min(max((1 << 26) // (max(n, 1) * 8), 8), max(n, 1)))
    eps_over_b = repulsion_strength / debye_length
    two_a = 2.0 * blob_radius
    offsets = box_offsets(periodic_length)
    L = torch.as_tensor([float(x) for x in periodic_length], dtype=dtype,
                        device=dev)
    ids = torch.arange(n, device=dev)
    out = torch.zeros_like(r_vectors)
    lo, hi = (0, n) if rows is None else (rows.start, min(rows.stop, n))
    for i0 in range(lo, hi, row_tile):
        ri = r_vectors[i0:min(i0 + row_tile, hi)]
        rids = torch.arange(i0, i0 + ri.shape[0], device=dev)
        d0 = min_image(ri[:, None, :] - r_vectors[None, :, :],
                       periodic_length)
        acc = torch.zeros_like(ri)
        for box in offsets:
            if box == (0, 0, 0):
                skip = rids[:, None] == ids[None, :]
                d = d0
            else:
                skip = torch.zeros((ri.shape[0], n), dtype=torch.bool,
                                   device=dev)
                d = d0 + torch.as_tensor(box, dtype=dtype, device=dev) * L
            r2 = torch.sum(d * d, dim=-1)
            rnorm = torch.sqrt(torch.where(skip | (r2 == 0.0),
                                           torch.ones_like(r2), r2))
            mag = torch.where(
                rnorm > two_a,
                eps_over_b * torch.exp(-(rnorm - two_a) / debye_length)
                / rnorm, eps_over_b / rnorm)
            mag = torch.where(skip, torch.zeros_like(mag), mag)
            # force on blob i from j points along r_i - r_j (repulsion)
            acc += torch.sum(mag[..., None] * d, dim=1)
        out[i0:i0 + ri.shape[0]] = acc
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
                     blob_radius, periodic_length=(0.0, 0.0, 0.0)):
    """K2 wrapper: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors. r_vectors (N,3) -> (N,3); a periodic_length with an axis
    L > 0 takes a periodic instance: over image_boxes' boxes, or its
    one-box instance when image_boxes keeps the home box alone. On the
    card the kernel takes K1's symmetric sweep over
    `pair_kernels.plan_groups`' tile groups, into a workspace (G, N, 3)
    summed in a fixed order."""
    global LAUNCHES, PERIODIC_LAUNCHES, ONE_BOX_LAUNCHES
    periodic_length = tuple(float(x) for x in periodic_length)
    periodic = any(L > 0 for L in periodic_length)
    law = dict(repulsion_strength=repulsion_strength,
               debye_length=debye_length, blob_radius=blob_radius)
    if r_vectors.device.type == "cpu":
        return blob_blob_forces_plain(r_vectors, **law,
                                      periodic_length=periodic_length)
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
    suffix = "f32" if r.dtype == torch.float32 else "f64"
    name = f"blob_forces_{suffix}"
    args = [r.data_ptr(), out.data_ptr(), ws.data_ptr(), n, groups, per,
            *force_law(repulsion_strength, debye_length, blob_radius)]
    one_box = False
    if periodic:
        boxes = image_boxes(periodic_length, debye_length, blob_radius,
                            r.dtype)
        args.append((ctypes.c_double * 3)(*periodic_length))
        one_box = len(boxes) == 1
        if one_box:
            name = f"blob_forces_one_box_{suffix}"
        else:
            name = f"blob_forces_periodic_{suffix}"
            off = [b * L for box in boxes
                   for b, L in zip(box, periodic_length)]
            args += [len(boxes), (ctypes.c_double * len(off))(*off)]
    err = getattr(_build.library(), name)(
        *args, torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(name, err)
    if periodic:
        PERIODIC_LAUNCHES += 1
        ONE_BOX_LAUNCHES += one_box
    else:
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
