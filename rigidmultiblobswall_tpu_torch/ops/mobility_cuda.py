"""Hand-written CUDA kernels of the mobility/force engine, beside their
plain PyTorch versions.

Counterpart of rigidmultiblobswall_tpu/ops/mobility_pallas.py. Ported so
far: kernel K2, the blob-blob repulsion (`blob_blob_forces_pallas` there,
`csrc/blob_forces.cu` here). The materialized-operator kernels K3
(`dense_tt_pallas`) and K4 (`symm_planes_matvec`) are still to be ported
(ROADMAP Queue 2).
"""

from __future__ import annotations

import torch

from . import _build

# number of K2 launches made by `blob_blob_forces` in this process
LAUNCHES = 0


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


def blob_blob_forces(r_vectors, *, repulsion_strength, debye_length,
                     blob_radius):
    """K2 wrapper: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors. r_vectors (N,3) -> (N,3), non-periodic."""
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
    name = ("blob_forces_f32" if r.dtype == torch.float32
            else "blob_forces_f64")
    fn = getattr(_build.library(), name)
    err = fn(r.data_ptr(), out.data_ptr(), r.shape[0],
             float(repulsion_strength) / float(debye_length),
             1.0 / float(debye_length), 2.0 * float(blob_radius),
             torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(name, err)
    LAUNCHES += 1
    return out
