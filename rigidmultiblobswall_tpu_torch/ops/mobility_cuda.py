"""Hand-written CUDA kernels of the mobility/force engine, beside their
plain PyTorch versions.

Counterpart of rigidmultiblobswall_tpu/ops/mobility_pallas.py, all three
of its kernels, and of the MCMC pair energy (M1):
  K2 `blob_blob_forces`: the blob-blob repulsion (`blob_blob_forces_pallas`
     there, `csrc/blob_forces.cu` here), with two periodic instances for
     the minimum-image sweep of rigidmultiblobswall_tpu/ops/forces.py's
     `blob_blob_forces` (XLA there): over the image boxes, and over the
     home box alone where `image_boxes` finds the others' forces zero;
  K3 `dense_tt`: the tt mobility of one configuration, materialized as the
     interleaved (3N, 3N) matrix with the height shift, 1/(8 pi eta a) and
     the wall damping folded in (`dense_tt_pallas` and its caller
     models/saddle.py:130-139 there, `csrc/dense_tt.cu` here), with an
     image-box instance that sums the pseudo-periodic boxes of a
     periodic_length into each block (ops/mobility.py
     dense_mobility_tiled with images, XLA there), and free-surface
     instances (the block plus its image reflected in a slip plane at
     z = 0; dense_mobility_tiled's free_surface domain), open and in
     the boxes;
  K4 `symm_matvec`: u = M v from the upper-triangle tiles of that matrix,
     for one right-hand side or the lockstep solves' pairs
     (`symm_planes_matvec` there, `csrc/symm_planes.cu` here);
  M1 `blob_pair_energy`: the repulsion's energy summed over the unordered
     pairs of each configuration of a batch, under the minimum image on the
     periodic axes (XLA in the JAX package: ops/forces.py:506
     blob_blob_energy and models/mcmc.py:25 total_energy;
     `csrc/blob_energy.cu` here), in float64: a sweep over tile groups,
     or for configurations of at most ENERGY_SMALL_MAX blobs one warp a
     configuration;
  P1 `radii_matvec`: the square tt product with per-blob radii (the
     different-radii RPY block and its wall image system, ops/rpy.py
     rpy_tt_radii and wall_tt_radii), B = 1 or 2 right-hand sides
     (XLA in the JAX package: ops/mobility.py:540
     mobility_radii_trans_times_force, the source-target product with
     sources = targets; `csrc/pair_radii.cu` here, on K1's symmetric
     sweep), with its image-box instances (the boxes of a
     periodic_length) and its free-surface ones (source_target_matvec's
     free_surface branch), open and in the boxes.
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
# number of M1 launches made by `blob_pair_energy`
ENERGY_LAUNCHES = 0
# the most blobs a configuration has that M1 takes with its small
# instance (one warp a configuration, one launch); larger configurations
# take the tile sweep. On the H100 at 4096 configurations the small
# instance's device time is below the tile sweep's up to 48 blobs and
# within 6 % of it at 64; at 80 and above the tile sweep is faster
ENERGY_SMALL_MAX = 64
# the two mask flavours of a pair of distinct coincident blobs (r^2 = 0):
# 'zero' adds nothing (the JAX package's forces.blob_blob_energy), 'one'
# adds u(r = 1) (its mcmc.total_energy, which masks only the diagonal)
COINCIDENT = ("zero", "one")
# values of the plain energy's largest (configurations, rows, n, 3)
# difference tensor
ENERGY_CHUNK_VALUES = 1 << 24
# number of K3 launches made by `dense_tt`, by (mode, images): mode of
# pair_kernels.MODES, images True for the image-box instances
DENSE_TT_LAUNCHES = {(m, i): 0 for m in pair_kernels.MODES
                     for i in (False, True)}
# number of K4 launches made by `symm_matvec`
SYMM_LAUNCHES = 0
# the most right-hand sides a P1 launch takes (the kernel's template
# instances), and the P1 launches made by `radii_matvec`, by (B, mode,
# images) as DENSE_TT_LAUNCHES
RADII_MAX_RHS = 2
RADII_LAUNCHES = {(b, m, i): 0 for b in range(1, RADII_MAX_RHS + 1)
                  for m in pair_kernels.MODES for i in (False, True)}
# K4's tile edge in blobs (csrc/symm_planes.cu kBlobs): the kernel reads
# the tiles M[3 T I : 3 T (I+1), 3 T J : 3 T (J+1)] with J >= I only
SYMM_TILE = 64


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
    boxes = pair_kernels.box_offsets(periodic_length)
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
    offsets = pair_kernels.box_offsets(periodic_length)
    L = torch.as_tensor([float(x) for x in periodic_length], dtype=dtype,
                        device=dev)
    ids = torch.arange(n, device=dev)
    out = torch.zeros_like(r_vectors)
    lo, hi = (0, n) if rows is None else (rows.start, min(rows.stop, n))
    for i0 in range(lo, hi, row_tile):
        ri = r_vectors[i0:min(i0 + row_tile, hi)]
        rids = torch.arange(i0, i0 + ri.shape[0], device=dev)
        d0 = pair_kernels.min_image(
            ri[:, None, :] - r_vectors[None, :, :], periodic_length)
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


def energy_law(repulsion_strength, debye_length, blob_radius):
    """M1's folded energy law (csrc/force_law.cuh energy): u = eps
    (2^min(c (2a - r), 0) + max((2a - r)/b, 0)) with (eps, c, 2a, 1/b) and
    c = log2(e)/b."""
    b = float(debye_length)
    return (float(repulsion_strength), math.log2(math.e) / b,
            2.0 * float(blob_radius), 1.0 / b)


def _energy_rows(n, n_conf):
    """(configurations, target rows) a chunk of the plain energy, so that
    one (configurations, rows, n, 3) difference tensor holds about
    ENERGY_CHUNK_VALUES values: whole configurations when one fits, else
    row tiles of one."""
    per_conf = max(n * n * 3, 1)
    if per_conf <= ENERGY_CHUNK_VALUES:
        return max(min(n_conf, ENERGY_CHUNK_VALUES // per_conf), 1), max(n, 1)
    return 1, max(min(ENERGY_CHUNK_VALUES // (3 * n), n), 1)


def blob_blob_energy_plain(r_vectors, *, repulsion_strength, debye_length,
                           blob_radius, periodic_length=(0.0, 0.0, 0.0),
                           coincident="zero"):
    """Plain PyTorch M1: the pair energy sum over i < j of u(r_ij) of each
    configuration of r_vectors (P, n, 3), (P,) in float64, with u = eps
    exp(-(r - 2a)/b) for r > 2a and eps + eps (2a - r)/b otherwise, r
    under min_image. Chunked over configurations and target rows
    (`_energy_rows`); each chunk's terms are formed in r_vectors' dtype
    and summed in float64. coincident: COINCIDENT's flavour of a pair at
    r^2 = 0."""
    if coincident not in COINCIDENT:
        raise ValueError(f"coincident {coincident!r}; one of {COINCIDENT}")
    n_conf, n = r_vectors.shape[0], r_vectors.shape[1]
    dev = r_vectors.device
    out = torch.zeros(n_conf, dtype=torch.float64, device=dev)
    eps, b = float(repulsion_strength), float(debye_length)
    two_a = 2.0 * float(blob_radius)
    per, tile = _energy_rows(n, n_conf)
    ids = torch.arange(n, device=dev)
    for p0 in range(0, n_conf, per):
        r = r_vectors[p0:p0 + per]
        for i0 in range(0, n, tile):
            ri = r[:, i0:i0 + tile]
            d = pair_kernels.min_image(
                ri[:, :, None, :] - r[:, None, :, :], periodic_length)
            r2 = torch.sum(d * d, dim=-1)
            # the upper triangle j > i: each unordered pair once
            live = ids[None, :] > ids[i0:i0 + ri.shape[1], None]
            zero = r2 == 0.0
            rr = torch.sqrt(torch.where(zero, torch.ones_like(r2), r2))
            u = torch.where(rr > two_a, eps * torch.exp(-(rr - two_a) / b),
                            eps + eps * (two_a - rr) / b)
            if coincident == "zero":
                live = live & ~zero
            u = torch.where(live, u, torch.zeros_like(u))
            out[p0:p0 + per] += u.sum(dim=(1, 2), dtype=torch.float64)
    return out


def blob_pair_energy(r_vectors, *, repulsion_strength, debye_length,
                     blob_radius, periodic_length=(0.0, 0.0, 0.0),
                     coincident="zero"):
    """M1 wrapper: the pair energy of each configuration of r_vectors (P,
    n, 3) (blob_blob_energy_plain), (P,) in float64. The CUDA kernel for
    CUDA tensors (float32 or float64 positions), the plain version for CPU
    tensors; no pair (n < 2) or no repulsion gives zeros without a launch.
    On the card, configurations of at most ENERGY_SMALL_MAX blobs take the
    small instance (one warp a configuration); larger ones the sweep of
    each configuration's unordered pairs over `pair_kernels.plan_groups`'
    tile groups, one partial a block, summed in a fixed order. Either is
    one call, counted once in ENERGY_LAUNCHES."""
    periodic_length = tuple(float(x) for x in periodic_length)
    law = dict(repulsion_strength=repulsion_strength,
               debye_length=debye_length, blob_radius=blob_radius,
               periodic_length=periodic_length)
    if coincident not in COINCIDENT:
        raise ValueError(f"coincident {coincident!r}; one of {COINCIDENT}")
    r = r_vectors
    if r.ndim != 3 or r.shape[2] != 3:
        raise ValueError("blob_pair_energy: r_vectors must be (P, n, 3), "
                         f"got {tuple(r.shape)}")
    n_conf, n = r.shape[0], r.shape[1]
    if n < 2 or float(repulsion_strength) == 0.0 or n_conf == 0:
        return torch.zeros(n_conf, dtype=torch.float64, device=r.device)
    if r.device.type == "cpu":
        return blob_blob_energy_plain(r, **law, coincident=coincident)
    return energy_kernel(r, **law, coincident=coincident,
                         small=n <= ENERGY_SMALL_MAX)


def energy_kernel(r, *, repulsion_strength, debye_length, blob_radius,
                  periodic_length, coincident, small):
    """One M1 launch on the card: the small instance (small, n <= 128
    blobs a configuration) or the tile sweep; `blob_pair_energy` picks the
    instance by n (ENERGY_SMALL_MAX)."""
    global ENERGY_LAUNCHES
    if r.device.type != "cuda":
        raise ValueError(f"blob_pair_energy: unsupported device {r.device}")
    if r.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"blob_pair_energy: dtype {r.dtype} "
                        "(float32/float64 only)")
    n_conf, n = r.shape[0], r.shape[1]
    if 3 * n >= 2 ** 31:
        raise ValueError("blob_pair_energy: too many blobs for 32-bit "
                         "indexing")
    if small and not 2 <= n <= pair_kernels.TILE:
        raise ValueError(f"blob_pair_energy: the small instance takes 2 to "
                         f"{pair_kernels.TILE} blobs, got {n}")
    r = r.contiguous()
    out = torch.empty(n_conf, dtype=torch.float64, device=r.device)
    box = None
    if any(L > 0 for L in periodic_length):
        box = (ctypes.c_double * 3)(*periodic_length)
    prec = "f32" if r.dtype == torch.float32 else "f64"
    law = energy_law(repulsion_strength, debye_length, blob_radius)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    lib = _build.library()
    if small:
        name = f"blob_energy_small_{prec}"
        err = getattr(lib, name)(r.data_ptr(), out.data_ptr(), n_conf, n,
                                 *law, box, int(coincident == "one"), stream)
    else:
        groups, per = pair_kernels.plan_groups(n, pair_kernels._n_sm(r))
        partials = torch.empty((n_conf, groups * (groups + 1) // 2),
                               dtype=torch.float64, device=r.device)
        name = f"blob_energy_{prec}"
        err = getattr(lib, name)(
            r.data_ptr(), partials.data_ptr(), out.data_ptr(), n_conf, n,
            groups, per, *law, box, int(coincident == "one"), stream)
    _build.check(name, err)
    ENERGY_LAUNCHES += 1
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


# the pairwise domain of each K3 mode (pair_kernels.MODES)
_MODE_DOMAIN = {"open": "no_wall", "wall": "single_wall",
                "free_surface": "free_surface"}


def dense_tt_plain(r_vectors, eta, a, *, mode,
                   periodic_length=(0.0, 0.0, 0.0)):
    """Plain PyTorch K3: the row-tiled (3N, 3N) builder of ops/mobility.py
    with the scaling folded in (and the image boxes of periodic_length),
    in the domain mode of pair_kernels.MODES."""
    return mob.dense_mobility_tiled(
        r_vectors, eta, a, domain=_MODE_DOMAIN[pair_kernels._mode(mode)],
        periodic_length=periodic_length)


def dense_tt(r_vectors, eta, a, *, mode, periodic_length=(0.0, 0.0, 0.0)):
    """K3 wrapper: the tt mobility of the configuration r_vectors (N,3) as
    the interleaved (3N, 3N) matrix, in the dtype of r_vectors, in the
    domain mode of pair_kernels.MODES (wall: the height shift and damping
    folded in; free_surface: the reflected image, neither shift nor
    damping), summed over the image boxes of periodic_length when it has
    a periodic axis (K3's image-box instance); launches count in
    DENSE_TT_LAUNCHES by (mode, images). The CUDA kernel for CUDA
    tensors, `dense_tt_plain` for CPU tensors."""
    periodic_length = tuple(float(x) for x in periodic_length)
    pair_kernels._mode(mode)
    if r_vectors.device.type == "cpu":
        return dense_tt_plain(r_vectors, eta, a, mode=mode,
                              periodic_length=periodic_length)
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
    suffix = "f32" if r.dtype == torch.float32 else "f64"
    boxes = pair_kernels.image_boxes(periodic_length, float(a))
    name, extra = f"dense_tt_{suffix}", ()
    if boxes is not None:
        name = f"dense_tt_img_{suffix}"
        extra = pair_kernels._box_args(boxes)
    err = getattr(_build.library(), name)(
        r.data_ptr(), out.data_ptr(), n, float(a),
        1.0 / (8.0 * math.pi * float(eta) * float(a)),
        pair_kernels.MODE_CODE[mode], *extra,
        torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(name, err)
    DENSE_TT_LAUNCHES[mode, boxes is not None] += 1
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
    global SYMM_LAUNCHES
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
        SYMM_LAUNCHES += 1
    return out.reshape(shape)


def radii_matvec_plain(r_vectors, vec, radii, eta, *, domain,
                       periodic_length=(0.0, 0.0, 0.0)):
    """Plain PyTorch P1: the source-target product of ops/mobility.py with
    the blobs as both sources and targets, for each right-hand side of
    vec (B, N, 3)."""
    return torch.stack([mob.source_target_matvec(
        r_vectors, r_vectors, v, radii, radii, eta, domain=domain,
        periodic_length=periodic_length) for v in vec])


def radii_matvec(r_vectors, vec, radii, eta, *, domain="single_wall",
                 periodic_length=(0.0, 0.0, 0.0)):
    """P1 wrapper: u_b = M v_b for per-blob radii (N,), vec (B, N, 3) ->
    (B, N, 3), 1 <= B <= RADII_MAX_RHS, in the domain single_wall (the
    different-radii RPY block plus its wall image system at the heights
    z_eff = max(z, a_i), damped by B_ii = min(z_i / a_i, 1)), no_wall (the
    RPY block) or free_surface (plus its image reflected in the slip plane
    z = 0); a periodic_length with an axis L > 0 sums the image boxes
    after the minimum image (P1's image-box instance: the in-plane policy
    of csrc/pair_blocks.cuh PlaneBoxes when both in-plane lengths exceed
    pair_kernels.PLANE_FAR_MIN times the largest radius, the general one
    otherwise). The CUDA kernel (the symmetric sweep over
    pair_kernels.plan_groups' tile groups; the open free surface's with
    two targets a lane, csrc/pair_radii.cu radii_sym2_kernel) for CUDA
    tensors,
    `radii_matvec_plain` for CPU tensors. Launches count in RADII_LAUNCHES
    by (B, mode, images)."""
    periodic_length = tuple(float(x) for x in periodic_length)
    if domain not in mob.RADII_DOMAINS:
        raise NotImplementedError(f"radii_matvec: domain {domain!r}")
    if r_vectors.device.type == "cpu":
        return radii_matvec_plain(r_vectors, vec, radii, eta, domain=domain,
                                  periodic_length=periodic_length)
    n = r_vectors.shape[0]
    n_rhs = vec.shape[0]
    if (r_vectors.ndim != 2 or r_vectors.shape[1] != 3 or vec.ndim != 3
            or vec.shape[1:] != (n, 3) or radii.shape != (n,)
            or not 1 <= n_rhs <= RADII_MAX_RHS):
        raise ValueError(f"radii_matvec: shapes r {tuple(r_vectors.shape)}, "
                         f"vec {tuple(vec.shape)}, radii "
                         f"{tuple(radii.shape)}; expected (N,3), (B,N,3) "
                         f"with B in 1..{RADII_MAX_RHS}, (N,)")
    if 6 * n >= 2 ** 31:
        raise ValueError("radii_matvec: too many blobs for 32-bit indexing")
    wall = domain == "single_wall"
    mode = mob.DOMAIN_MODE[domain]
    dtype = torch.promote_types(r_vectors.dtype, vec.dtype)
    r = r_vectors.to(dtype)
    a = radii.to(dtype)
    v = vec.to(dtype)
    damp = None
    if wall:
        damp = torch.clamp(r[:, 2] / a, max=1.0)
        r = torch.cat([r[:, :2], torch.maximum(r[:, 2], a)[:, None]], dim=1)
        v = v * damp[None, :, None]
    # (N, 5) rows (x, y, z_eff, a, 1/a), 1/a by the exact division
    q = torch.cat([r, a[:, None], (1.0 / a)[:, None]], dim=1).contiguous()
    V = v.permute(1, 0, 2).reshape(n, 3 * n_rhs).contiguous()   # b-major
    _check_cuda("radii_matvec", q, V)
    out = torch.empty_like(V)
    if n == 0:
        return out.reshape(n, n_rhs, 3).permute(1, 0, 2)
    groups, per = pair_kernels.plan_groups(n, pair_kernels._n_sm(V))
    ws = torch.empty((groups, n, 3 * n_rhs), dtype=dtype, device=V.device)
    boxes = pair_kernels.image_boxes(periodic_length, 1.0)
    suffix = "f32" if dtype == torch.float32 else "f64"
    lib = _build.library()
    stream = torch.cuda.current_stream(V.device).cuda_stream
    args = (q.data_ptr(), V.data_ptr(), out.data_ptr(), ws.data_ptr(), n,
            n_rhs, groups, per, pair_kernels.MODE_CODE[mode])
    if boxes is None:
        name = f"pair_radii_sym_{suffix}"
        err = getattr(lib, name)(*args, stream)
    else:
        # the largest radius, for the in-plane policy's far test (one
        # host read a product)
        name = f"pair_radii_sym_img_{suffix}"
        err = getattr(lib, name)(*args, *pair_kernels._box_args(boxes),
                                 float(a.max()), stream)
    _build.check(name, err)
    RADII_LAUNCHES[n_rhs, mode, boxes is not None] += 1
    out = out * (1.0 / (8.0 * math.pi * eta))
    if wall:
        out = out * damp[:, None]
    return out.reshape(n, n_rhs, 3).permute(1, 0, 2)
