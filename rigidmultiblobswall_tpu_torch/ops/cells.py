"""Fixed-capacity linked cells of a periodic box, or of a box with open
axes sized from the data (PyTorch), shared by the two short-range pair
sweeps: the near field of the spectral engine
(kernel K6, ops/ewald.py) and the linked-cell blob forces (kernel K5,
ops/forces.py).

Counterpart of rigidmultiblobswall_tpu/ops/cells.py: `cell_bin`,
`neighbor_table` and `wrap_counts`. The JAX package's pre-gathered
(cell, 27 cap) source layout (`lane_pad_sources`, `padded_source_ids`,
`gather_src_pos`, `gather_tgt_xyz`) is a TPU layout and is not ported:
the CUDA kernels walk the 27 neighbor cells themselves
(csrc/cell_sweep.cuh), and the plain versions gather per cell tile.

Layout: cell c = (cx ny + cy) nz + cz holds its particles in slots
c cap .. c cap + cap - 1 of `cell_table`, in ascending particle order;
the live slots of a cell are a prefix of its cap slots, and every other
slot holds the sentinel id n.
"""

from __future__ import annotations

import numpy as np
import torch


def cell_bin(pos, box, dims, cap, cid=None):
    """Bin wrapped positions (N,3) into a fixed-capacity cell table.

    Returns (cell_table, cell_slot, cid, n_dropped):
      cell_table: (n_cells cap,) int32 particle ids, pad = N;
      cell_slot:  (N,) int64 flat (cell, slot) row per particle, and
                  n_cells cap (one past the end) for a dropped particle;
      cid:        (N,) int64 cell id per particle;
      n_dropped:  0-d int64 tensor, particles beyond their cell's cap.
    The sort is stable, so which particles overflow a cell matches the
    JAX package (jnp.argsort). `cid` given (open_cell_ids) bins by it in
    place of the periodic cells of box."""
    nx, ny, nz = (int(d) for d in dims)
    n = pos.shape[0]
    n_cells = nx * ny * nz
    dev = pos.device
    if cid is None:
        cid = cell_ids(pos, box, dims)
    order = torch.sort(cid, stable=True).indices
    sc = cid[order]
    slot = torch.arange(n, device=dev) - torch.searchsorted(sc, sc)
    in_cap = slot < cap
    addr = torch.where(in_cap, sc * cap + slot,
                       torch.full_like(sc, n_cells * cap))
    cell_table = torch.full((n_cells * cap + 1,), n, dtype=torch.int32,
                            device=dev)
    cell_table[addr] = order.to(torch.int32)
    cell_table = cell_table[:-1]
    slot_of = torch.full((n,), cap, dtype=torch.int64, device=dev)
    slot_of[order] = torch.where(in_cap, slot, torch.full_like(slot, cap))
    cell_slot = torch.where(slot_of < cap, cid * cap + slot_of,
                            torch.full_like(cid, n_cells * cap))
    n_dropped = torch.sum(~in_cap)
    return cell_table, cell_slot, cid, n_dropped


def open_frame(pos, periodic_length, dims, cutoff):
    """The cells of a box with open axes (the JAX package's generic
    linked-cell path, forces.py:187-201): per axis (lo, edge), lo 0 and
    edge L / n on a periodic axis (positions wrapped there), and on an
    open axis lo the data's minimum and edge max(extent / n, cutoff)
    (1 + 1e-6), in the positions' dtype. Returns (lo, edge), two (3,)
    tensors on the positions' device."""
    lo, edge = [], []
    for a, (L, nd) in enumerate(zip(periodic_length, dims)):
        x = pos[:, a]
        if float(L) > 0:
            lo.append(torch.zeros((), dtype=pos.dtype, device=pos.device))
            edge.append(torch.tensor(float(L) / int(nd), dtype=pos.dtype,
                                     device=pos.device))
        else:
            m = torch.min(x)
            lo.append(m)
            edge.append(torch.clamp((torch.max(x) - m) / int(nd),
                                    min=float(cutoff)) * (1.0 + 1e-6))
    return torch.stack(lo), torch.stack(edge)


def open_cell_ids(pos, periodic_length, dims, lo, edge):
    """(N,) int64 cell id of each position in the frame (lo, edge) of
    open_frame: floor((x - lo) / edge) clipped to [0, n - 1] per axis (a
    periodic axis: x / (L / n), as cell_ids)."""
    nx, ny, nz = (int(d) for d in dims)
    dims_t = torch.tensor((nx, ny, nz), dtype=torch.int64,
                          device=pos.device)
    c3 = []
    for a, L in enumerate(periodic_length):
        x = pos[:, a] if float(L) > 0 else pos[:, a] - lo[a]
        c3.append(torch.floor(x / edge[a]).to(torch.int64))
    c3 = torch.minimum(torch.clamp(torch.stack(c3, dim=1), min=0),
                       dims_t - 1)
    return (c3[:, 0] * ny + c3[:, 1]) * nz + c3[:, 2]


def cell_members(cid, n_cells):
    """Every particle of each cell, overflow included: (order, starts),
    order (N,) int32 the particle ids sorted stably by cell id (as
    cell_bin sorts them) and starts (n_cells + 1,) int32 each cell's first
    entry in order."""
    order = torch.sort(cid, stable=True).indices
    counts = torch.bincount(cid, minlength=n_cells)
    starts = torch.zeros(n_cells + 1, dtype=torch.int64, device=cid.device)
    starts[1:] = torch.cumsum(counts, 0)
    return order.to(torch.int32), starts.to(torch.int32)


def cell_ids(pos, box, dims):
    """(N,) int64 cell id of each wrapped position (N,3), on its device."""
    nx, ny, nz = (int(d) for d in dims)
    dev = pos.device
    box_t = torch.as_tensor(box, dtype=pos.dtype, device=dev)
    dims_t = torch.tensor((nx, ny, nz), dtype=torch.int64, device=dev)
    csize = box_t / dims_t.to(pos.dtype)
    c3 = torch.minimum(torch.clamp((pos / csize).to(torch.int64), min=0),
                       dims_t - 1)
    return (c3[:, 0] * ny + c3[:, 1]) * nz + c3[:, 2]


def host_cell_ids(pos, box, dims):
    """cell_bin's cell id of each wrapped position, on the host (numpy, in
    the positions' own precision), for the start-up capacity sizing."""
    dims = np.asarray(dims)
    csize = np.asarray(box, pos.dtype) / dims.astype(pos.dtype)
    c3 = np.clip((pos / csize).astype(np.int64), 0, dims - 1)
    return (c3[:, 0] * dims[1] + c3[:, 1]) * dims[2] + c3[:, 2]


def _cell_coords(dims):
    nx, ny, nz = dims
    return np.stack(np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                                indexing="ij"), axis=-1).reshape(-1, 3)


# the 27-cell stencil, i slowest (the kernels' order too)
_O27 = np.array([(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1)
                 for k in (-1, 0, 1)])


def neighbor_table(dims, device=None):
    """(n_cells, 27) int64 neighbor-cell ids with periodic wrap."""
    nx, ny, nz = dims
    nb3 = (_cell_coords(dims)[:, None, :] + _O27[None]) % np.array(dims)
    ids = (nb3[:, :, 0] * ny + nb3[:, :, 1]) * nz + nb3[:, :, 2]
    return torch.as_tensor(ids, dtype=torch.int64, device=device)


def wrap_counts(dims, device=None):
    """(n_cells, 27, 3) int64 periodic wrap counts (-1/0/+1) of each
    stencil neighbor: its particles' image sits at pos + wrap * box."""
    raw = _cell_coords(dims)[:, None, :] + _O27[None]
    return torch.as_tensor(np.floor_divide(raw, np.array(dims)),
                           dtype=torch.int64, device=device)
