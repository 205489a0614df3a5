"""Blob force kernels (PyTorch).

Counterpart of rigidmultiblobswall_tpu/ops/forces.py:
`blob_external_forces`, the direct `blob_blob_forces` and the linked-cell
`blob_blob_forces_neighbor_list` of a fully periodic box, with its
overflow count and start-up capacity sizing. The direct pair sweep runs
kernel K2 (ops/mobility_cuda.py) and the linked-cell sweep kernel K5
(ops/cell_kernels.py) on a CUDA tensor, their plain versions on a CPU
tensor. Body-body Yukawa forces, periodic images of the direct sweep,
and neighbor lists in open or wall-slab boxes are still to be ported
(ROADMAP Queue 1, items 4, 14, 18 and 19).

Physics: gravity plus the wall repulsion of
U(z) = U0 + U0 (a-z)/b for z < a, U0 exp(-(z-a)/b) otherwise, and the
blob-blob repulsion of U(r) = U0 + U0 (2a-r)/b for r < 2a,
U0 exp(-(r-2a)/b) otherwise.
"""

from __future__ import annotations

import dataclasses

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
    """Pairwise soft repulsion, direct O(N^2) sweep, (N,3) -> (N,3)."""
    if any(float(L) > 0 for L in periodic_length):
        raise NotImplementedError("periodic images of the direct blob-blob "
                                  "sweep are not ported yet (ROADMAP Queue 1, "
                                  "item 4)")
    if repulsion_strength == 0.0:
        return torch.zeros_like(r_vectors)
    return mobility_cuda.blob_blob_forces(
        r_vectors.contiguous(), repulsion_strength=repulsion_strength,
        debye_length=debye_length, blob_radius=blob_radius)


def _cutoff(blob_radius, debye_length, cutoff):
    """The pair cutoff; 0 or None picks the reference's 2a + 30 b."""
    return float(cutoff) if cutoff else (2.0 * float(blob_radius)
                                         + 30.0 * float(debye_length))


def neighbor_cell_dims(periodic_length, cutoff, grid_dim):
    """Cells per axis, min(L // cutoff, grid_dim), of a fully periodic box.
    Raises NotImplementedError for the layouts the port does not cover:
    open or partly periodic boxes, and boxes under 4 cells of the cutoff
    (where the JAX package takes the direct periodic sweep)."""
    dims = []
    for L in (float(x) for x in periodic_length):
        if L <= 0:
            raise NotImplementedError(
                "linked-cell blob forces in open, partly periodic or "
                "wall-slab boxes are not ported yet (ROADMAP Queue 1, items "
                "14 and 19); the port covers fully periodic boxes")
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
    return tuple(dims)


def _wrap(r, box):
    return r - torch.floor(r / box) * box


def blob_blob_forces_neighbor_list(r_vectors, *, repulsion_strength=0.0,
                                   debye_length=1.0, blob_radius=1.0,
                                   periodic_length=(0.0, 0.0, 0.0),
                                   cutoff=None, grid_dim=16,
                                   cell_capacity=32, z_extent=None):
    """Linked-cell O(N 27 cap) pair force of a fully periodic box (the
    reference's kd-tree variant; default cutoff 2a + 30 b): blobs bin into
    cells of edge >= cutoff, and each blob interacts with every blob of
    the 27 cells around its own. A blob beyond its cell's capacity is
    dropped as a source and a target (its row is zero), as on the JAX
    package's Pallas path; size cell_capacity with
    `auto_force_cell_capacity`. (N,3) -> (N,3)."""
    if z_extent is not None:
        raise NotImplementedError("the wall-slab linked-cell forces (z_clip) "
                                  "wait for the wall spectral engine "
                                  "(ROADMAP Queue 1, item 19)")
    if repulsion_strength == 0.0:
        return torch.zeros_like(r_vectors)
    pos, dims, cell_table, _ = _force_cells(
        r_vectors, periodic_length,
        _cutoff(blob_radius, debye_length, cutoff), grid_dim, cell_capacity)
    return cell_kernels.nl_forces(
        pos, cell_table, dims, tuple(float(L) for L in periodic_length),
        int(cell_capacity), eps_over_b=repulsion_strength / debye_length,
        inv_b=1.0 / debye_length, two_a=2.0 * blob_radius)


def _force_cells(r_vectors, periodic_length, cutoff, grid_dim, cap):
    """The linked-cell layout of the force sweep: wrapped positions, cells
    per axis, the cell table and the count of dropped blobs (0-d)."""
    dims = neighbor_cell_dims(periodic_length, cutoff, grid_dim)
    box = torch.as_tensor(periodic_length, dtype=r_vectors.dtype,
                          device=r_vectors.device)
    pos = _wrap(r_vectors, box).contiguous()
    cell_table, _, _, n_dropped = cells.cell_bin(pos, box, dims, int(cap))
    return pos, dims, cell_table, n_dropped


def neighbor_list_overflow(system, r_blobs) -> int:
    """Blobs the linked-cell force layout drops at r_blobs (the binning of
    blob_blob_forces_neighbor_list, on the positions' device): nonzero
    means blobs lost their repulsion. 0 when the method is not in use."""
    if system.blob_blob_force_method != "neighbor_list":
        return 0
    return int(_force_cells(
        r_blobs, system.periodic_length,
        _cutoff(system.blob_radius, system.debye_length,
                system.blob_blob_cutoff),
        system.blob_blob_grid_dim, system.blob_blob_cell_capacity)[3])


def auto_force_cell_capacity(system, r_blobs, *, margin=1.25, log=None):
    """Size the linked-cell force capacity from the actual occupancy at
    r_blobs (host, once at start-up): max occupancy x margin, rounded up
    to 8, when that exceeds the system's capacity. Returns the System;
    a no-op for other force methods."""
    if system.blob_blob_force_method != "neighbor_list":
        return system
    rc = _cutoff(system.blob_radius, system.debye_length,
                 system.blob_blob_cutoff)
    L3 = np.asarray(system.periodic_length, np.float64)
    dims = np.asarray(neighbor_cell_dims(L3, rc, system.blob_blob_grid_dim))
    x = np.array(r_blobs.detach().cpu().numpy() if isinstance(
        r_blobs, torch.Tensor) else r_blobs)
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
