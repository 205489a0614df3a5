"""Blob force kernels (PyTorch).

Counterpart of rigidmultiblobswall_tpu/ops/forces.py:
`blob_external_forces`, the direct `blob_blob_forces` (open or with
periodic images) and the linked-cell `blob_blob_forces_neighbor_list` of
a fully periodic box or an xy-periodic wall slab, with its overflow count
and start-up capacity sizing. The direct pair sweep runs kernel K2
(ops/mobility_cuda.py; its periodic instance with periodic images) and
the linked-cell sweep kernel K5 (ops/cell_kernels.py) on a CUDA tensor,
their plain versions on a CPU tensor; `body_body_forces_torques`, the
Yukawa force between body centers, is plain PyTorch on both (XLA in the
JAX package too); `blob_blob_energy`, the repulsion's pair energy of the
MCMC sampler, runs kernel M1 (XLA there). The linked-cell path's fallback
to the direct periodic sweep in boxes under 4 cells, and neighbor lists
in open boxes, are still to be ported (ROADMAP Queue 1, items 4 and 14).

Physics: gravity plus the wall repulsion of
U(z) = U0 + U0 (a-z)/b for z < a, U0 exp(-(z-a)/b) otherwise, and the
blob-blob repulsion of U(r) = U0 + U0 (2a-r)/b for r < 2a,
U0 exp(-(r-2a)/b) otherwise.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import cell_kernels, cells, mobility_cuda


def blob_external_forces(r_vectors, *, g=0.0, blob_mass=1.0, blob_radius=1.0,
                         repulsion_strength_wall=0.0, debye_length_wall=1.0):
    """Gravity + wall repulsion per blob, (N,3)."""
    h = r_vectors[:, 2]
    amp = repulsion_strength_wall / debye_length_wall
    fz = torch.where(h > blob_radius,
                     amp * torch.exp(-(h - blob_radius) / debye_length_wall),
                     torch.full_like(h, amp))
    f = torch.zeros_like(r_vectors)
    f[:, 2] = -g * blob_mass + fz
    return f


def blob_blob_forces(r_vectors, *, repulsion_strength=0.0, debye_length=1.0,
                     blob_radius=1.0, periodic_length=(0.0, 0.0, 0.0)):
    """Pairwise soft repulsion, direct O(N^2) sweep, (N,3) -> (N,3); with
    a periodic_length, the minimum image plus the image boxes of
    mobility_cuda.box_offsets (the JAX package's forces.py:48-109)."""
    if repulsion_strength == 0.0:
        return torch.zeros_like(r_vectors)
    return mobility_cuda.blob_blob_forces(
        r_vectors.contiguous(), repulsion_strength=repulsion_strength,
        debye_length=debye_length, blob_radius=blob_radius,
        periodic_length=periodic_length)


def body_body_forces_torques(locations, *, repulsion_strength=0.0,
                             debye_length=1.0,
                             periodic_length=(0.0, 0.0, 0.0)):
    """The Yukawa force between body centers (zero torque), (B, 6) as
    (force, torque): on body i, sum over j of (eps/b + eps/r) exp(-r/b)
    d / r^2 with d = x_i - x_j at its minimum image and r = |d|; pairs
    at r = 0 add nothing."""
    nb = locations.shape[0]
    out = locations.new_zeros((nb, 6))
    if repulsion_strength == 0.0 or nb < 2:
        return out
    d = mobility_cuda.min_image(locations[:, None, :] - locations[None, :, :],
                                periodic_length)
    r2 = torch.sum(d * d, dim=-1)
    skip = (torch.eye(nb, dtype=torch.bool, device=locations.device)
            | (r2 == 0.0))
    r2 = torch.where(skip, torch.ones_like(r2), r2)
    r = torch.sqrt(r2)
    eps, b = repulsion_strength, debye_length
    mag = ((eps / b) + (eps / r)) * torch.exp(-r / b) / r2
    mag = torch.where(skip, torch.zeros_like(mag), mag)
    out[:, :3] = torch.sum(mag[..., None] * d, dim=1)
    return out


def blob_blob_energy(r_vectors, *, repulsion_strength=0.0, debye_length=1.0,
                     blob_radius=1.0, periodic_length=(0.0, 0.0, 0.0),
                     coincident="zero"):
    """Total pair potential energy (the MCMC sampler's), sum over i < j of
    U(r_ij) with r_ij under the minimum image on the periodic axes, in
    float64: r_vectors (N, 3) -> a scalar, or a batch (P, N, 3) -> (P,).
    Kernel M1 on a CUDA tensor, its plain version on a CPU tensor
    (mobility_cuda.blob_pair_energy). coincident 'zero' drops a pair of
    distinct coincident blobs, as the JAX package's blob_blob_energy does;
    'one' counts it at r = 1, as its mcmc.total_energy does."""
    r = r_vectors[None] if r_vectors.ndim == 2 else r_vectors
    e = mobility_cuda.blob_pair_energy(
        r, repulsion_strength=repulsion_strength, debye_length=debye_length,
        blob_radius=blob_radius, periodic_length=periodic_length,
        coincident=coincident)
    return e[0] if r_vectors.ndim == 2 else e


def _cutoff(blob_radius, debye_length, cutoff):
    """The pair cutoff; 0 or None picks the reference's 2a + 30 b."""
    return float(cutoff) if cutoff else (2.0 * float(blob_radius)
                                         + 30.0 * float(debye_length))


def neighbor_cell_dims(periodic_length, cutoff, grid_dim, z_extent=None):
    """Cells per axis, min(L // cutoff, grid_dim), of a fully periodic box,
    or of an xy-periodic wall slab with its z cells (wall_slab). Raises
    NotImplementedError for the layouts the port does not cover: open
    boxes, and boxes under 4 cells of the cutoff (where the JAX package
    takes the direct periodic sweep)."""
    slab = wall_slab(periodic_length, cutoff, z_extent)
    if slab is not None:
        periodic_length = tuple(periodic_length)[:2]
    dims = []
    for L in (float(x) for x in periodic_length):
        if L <= 0:
            raise NotImplementedError(
                "linked-cell blob forces in open or partly periodic boxes "
                "are not ported yet (ROADMAP Queue 1, item 14); the port "
                "covers fully periodic boxes and xy-periodic wall slabs "
                "of a declared z extent")
        nd = int(L // cutoff)
        if nd < 4:
            raise NotImplementedError(
                f"box {tuple(periodic_length)} holds fewer than 4 cells of "
                f"the cutoff {cutoff}: the JAX package falls back to the "
                "direct sweep with periodic images, not ported yet (ROADMAP "
                "Queue 1, item 4)")
        dims.append(min(nd, int(grid_dim)))
    if min(dims) < 4:
        raise ValueError(f"blob_blob_grid_dim {grid_dim}: the 27-cell "
                         "stencil needs at least 4 cells a side")
    if slab is not None:
        dims.append(slab[0])
    return tuple(dims)


def wall_slab(periodic_length, cutoff, z_extent):
    """The wall-slab layout of the linked cells, (nz, cs_z, z_clip), or
    None for other boxes: z cells of 1.001 cutoff covering the declared
    z extent plus one guard layer on top; heights clip into [0, z_clip]
    so the guard stays empty and the stencil's z wrap meets no blob (the
    JAX package's Pallas branch, forces.py:174-184)."""
    L = tuple(float(x) for x in periodic_length)
    if not (z_extent is not None and z_extent > 0 and L[0] > 0 and L[1] > 0
            and L[2] == 0):
        return None
    cs_z = 1.001 * cutoff
    nz = max(int(math.ceil(float(z_extent) / cs_z)), 1) + 1
    return nz, cs_z, (nz - 1) * cs_z * 0.999


def _wrap(r, box):
    return r - torch.floor(r / box) * box


def blob_blob_forces_neighbor_list(r_vectors, *, repulsion_strength=0.0,
                                   debye_length=1.0, blob_radius=1.0,
                                   periodic_length=(0.0, 0.0, 0.0),
                                   cutoff=None, grid_dim=16,
                                   cell_capacity=32, z_extent=None):
    """Linked-cell O(N 27 cap) pair force (the reference's kd-tree
    variant; default cutoff 2a + 30 b) of a fully periodic box, or of an
    xy-periodic wall slab whose blobs the caller declares below z_extent
    (the spectral wall engine's slab height; wall_slab): blobs bin into
    cells of edge >= cutoff, and each blob interacts with every blob of
    the 27 cells around its own. A blob beyond its cell's capacity is
    dropped as a source and a target (its row is zero), as on the JAX
    package's Pallas path; size cell_capacity with
    `auto_force_cell_capacity`. (N,3) -> (N,3)."""
    if repulsion_strength == 0.0:
        return torch.zeros_like(r_vectors)
    pos, dims, box, cell_table, _ = _force_cells(
        r_vectors, periodic_length,
        _cutoff(blob_radius, debye_length, cutoff), grid_dim, cell_capacity,
        z_extent)
    return cell_kernels.nl_forces(
        pos, cell_table, dims, box, int(cell_capacity),
        eps_over_b=repulsion_strength / debye_length,
        inv_b=1.0 / debye_length, two_a=2.0 * blob_radius,
        guard_z=float(periodic_length[2]) == 0.0)     # the wall slab


def _force_cells(r_vectors, periodic_length, cutoff, grid_dim, cap,
                 z_extent=None):
    """The linked-cell layout of the force sweep: binned positions (xy
    wrapped; z wrapped, or clipped into a wall slab), cells per axis, the
    binning box, the cell table and the count of dropped blobs (0-d)."""
    dims = neighbor_cell_dims(periodic_length, cutoff, grid_dim, z_extent)
    slab = wall_slab(periodic_length, cutoff, z_extent)
    L = tuple(float(x) for x in periodic_length)
    box = L if slab is None else (L[0], L[1], slab[0] * slab[1])
    box_t = torch.as_tensor(box, dtype=r_vectors.dtype,
                            device=r_vectors.device)
    if slab is None:
        pos = _wrap(r_vectors, box_t)
    else:
        pos = torch.cat([_wrap(r_vectors[:, :2], box_t[:2]),
                         torch.clamp(r_vectors[:, 2:], 0.0, slab[2])], dim=1)
    pos = pos.contiguous()
    cell_table, _, _, n_dropped = cells.cell_bin(pos, box_t, dims, int(cap))
    return pos, dims, box, cell_table, n_dropped


def force_z_extent(system):
    """The z extent a System declares for its linked-cell forces: the wall
    engine's slab height (single_wall_spectral), else None."""
    h = system.spectral_wall_height
    return h if h > 0 else None


def neighbor_list_overflow(system, r_blobs) -> int:
    """Blobs the linked-cell force layout mishandles at r_blobs (the
    binning of blob_blob_forces_neighbor_list, on the positions' device):
    the blobs it drops, plus on a wall slab the blobs above z_clip, whose
    height it clips. Nonzero means blobs lost or misplaced their
    repulsion. 0 when the method is not in use."""
    if system.blob_blob_force_method != "neighbor_list":
        return 0
    rc = _cutoff(system.blob_radius, system.debye_length,
                 system.blob_blob_cutoff)
    z_extent = force_z_extent(system)
    n_dropped = int(_force_cells(
        r_blobs, system.periodic_length, rc, system.blob_blob_grid_dim,
        system.blob_blob_cell_capacity, z_extent)[4])
    slab = wall_slab(system.periodic_length, rc, z_extent)
    if slab is not None:
        n_dropped += int(torch.sum(r_blobs[:, 2] > slab[2]))
    return n_dropped


def auto_force_cell_capacity(system, r_blobs, *, margin=1.25, log=None):
    """Size the linked-cell force capacity from the actual occupancy at
    r_blobs (host, once at start-up) in the binning the sweep uses (on a
    wall slab, its clipped z cells): max occupancy x margin, rounded up
    to 8, when that exceeds the system's capacity. Returns the System;
    a no-op for other force methods."""
    if system.blob_blob_force_method != "neighbor_list":
        return system
    rc = _cutoff(system.blob_radius, system.debye_length,
                 system.blob_blob_cutoff)
    z_extent = force_z_extent(system)
    dims = np.asarray(neighbor_cell_dims(
        system.periodic_length, rc, system.blob_blob_grid_dim, z_extent))
    slab = wall_slab(system.periodic_length, rc, z_extent)
    L3 = np.asarray(system.periodic_length, np.float64)
    if slab is not None:
        L3[2] = slab[0] * slab[1]
    x = np.array(r_blobs.detach().cpu().numpy() if isinstance(
        r_blobs, torch.Tensor) else r_blobs)
    if slab is not None:
        x[:, 2] = np.clip(x[:, 2], 0.0, slab[2])
    occs = []
    for d in range(3):
        x[:, d] = x[:, d] % L3[d]
        occs.append(np.clip(x[:, d] // (L3[d] / dims[d]), 0,
                            dims[d] - 1).astype(int))
    cid = (occs[0] * dims[1] + occs[1]) * dims[2] + occs[2]
    occ = int(np.bincount(cid).max())
    cap = -(-int(occ * margin) // 8) * 8
    if log is not None:
        log(f"force cells: dims={tuple(int(v) for v in dims)} "
            f"max_occ={occ} capacity={cap}")
    if cap <= system.blob_blob_cell_capacity:
        return system
    return dataclasses.replace(system, blob_blob_cell_capacity=cap)
