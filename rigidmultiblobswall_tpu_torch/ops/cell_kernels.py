"""Kernels K5, K6 and K7: pair sweeps over the 27-cell stencil of a
periodic box or a wall slab, beside their plain PyTorch versions.

- K5 `nl_forces`: the linked-cell soft blob-blob repulsion, counterpart
  of rigidmultiblobswall_tpu/ops/forces.py (`_nl_force_kernel`, wrapper
  `_neighbor_forces_pallas`); CUDA source `csrc/nl_forces.cu`. Its open
  instance `nl_forces_open` takes a box with open axes (the generic path
  of that file, forces.py:187-269, XLA there): the cells of an open axis
  from the data's extent (ops/forces.py open_force_cells), the stencil
  stopped at the edges of an open axis and wrapped on a periodic one, and
  every blob a target, a cell's overflow included.
- K6 `near_rpy`: the near-field RPY remainder of the periodic spectral
  engine, u_i = sum_j alpha(r) f_j + (beta(r)/r^2)(d.f_j) d over
  0 < r < r_cut, with alpha and beta from a two-piece Chebyshev series
  (pieces r < 2a and 2a <= r < r_cut); counterpart of
  rigidmultiblobswall_tpu/ops/ewald.py (`_near_kernel`, wrapper
  `_near_rows_pallas`); CUDA source `csrc/near_rpy.cu`. B = 1 and 2
  right-hand sides stacked as b-major columns of (N, 3B).
- P2 `near_rpy_radii`: K6's sum with mixed blob radii, alpha and beta
  from the series of the pair's radius groups (g, h), three pieces on
  (0, e1), [e1, e2), [e2, r_cut) with e1 = max(|a_g - a_h|, 1e-3 r_cut)
  and e2 = a_g + a_h; counterpart of the radii branch of
  rigidmultiblobswall_tpu/ops/ewald.py's XLA cell sweep
  (`_xla_near_tile_fn`, ewald.py:1222-1345; the JAX package has no Pallas
  kernel for it); CUDA source `csrc/near_radii.cu`, B = 1 and 2. Its
  pairs are listed once per set of positions (`near_radii_pairs`, the
  list `RadiiPairs` that a mixed-radii plan on the card carries), and a
  product walks the list, one warp a target.
- K7 `wall_near`: the near field of the spectral wall engine over the
  combined set of N real points and their N images (the RPY remainder
  on mirrored strengths, plus the screened image channels of real
  targets and image sources), rows of the real points only; counterpart
  of rigidmultiblobswall_tpu/ops/ewald_wall.py (`_wall_near_kernel`,
  wrapper `_wall_near_rows`; its plain version follows
  `near_matvec_xla`); CUDA source `csrc/wall_near.cu`, B = 1 and 2.
- K8 `wall_rot_near`: the rot-coupling near field of the same engine
  (ops/ewald_wall_rot.py): for real targets, the rot remainders (gamma_r,
  alpha_r, beta_r) of real sources and the screened image rot channels
  (img_terms_rt / _tr / _rr) of image sources, on damped forces f and
  torques t, either of which may be absent; rows (v, w), of which a call
  forms the outputs it asks for (`want_v`, `want_w`): one instance a
  product (tr: v from t; rt: w from f; rr: w from t) or all three
  (grand). Counterpart of rigidmultiblobswall_tpu/ops/ewald_wall_rot.py
  (`grand_near_xla`, an XLA sweep); CUDA source `csrc/wall_rot_near.cu`.

All take positions wrapped into the box (or drifted from there by less
than the plan's budget), the cell table of ops/cells.cell_bin and the
cell dims (at least 4 a side, so the 27 stencil cells and their images
are distinct), and return one row per particle: the sum over the
particles of the 27 cells around its own, each at the periodic image the
cell's wrap count gives. A wall slab (`guard_z`: K5's wall-slab forces,
K7) may have fewer z cells when the top z layer is an empty guard: the
stencil's z wrap then lands only on that layer, and a z offset that
repeats a cell repeats the empty guard. A particle dropped by cell
overflow is neither a source nor a target: its row is zero, as in the
JAX package's Pallas path. K5 has no cutoff test: the sum runs over the
whole stencil, as both JAX paths do.

On a CUDA tensor a wrapper launches its kernel and counts the launch in
`LAUNCHES` (P2's list builds as "near_radii_pairs"); on a CPU tensor it
runs the plain version, a cell-tiled dense sweep in PyTorch; any other
case raises.

A rank's share (parallel/mesh.py): K6 takes `cells_range`, a range of
its target cells, K7 `columns`, a range of the nx ny (x, y) cell
columns, and P2 `targets`, a range of target rows; each writes the rows
of its share alone and leaves the others zero, so the ranks' outputs sum
exactly to the whole. Those launches count also in `SHARE_LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from . import _build, cells, mobility_cuda, pair_kernels

# kernel launches made by the wrappers in this process
LAUNCHES = {"nl_forces": 0, "nl_forces_open": 0, "near_rpy_b1": 0,
            "near_rpy_b2": 0,
            "near_rpy_radii_b1": 0, "near_rpy_radii_b2": 0,
            "near_radii_pairs": 0,
            "wall_near_b1": 0, "wall_near_b2": 0, "wall_rot_near_grand": 0,
            "wall_rot_near_rt": 0, "wall_rot_near_tr": 0,
            "wall_rot_near_rr": 0}
# launches of a rank's share (cells_range, columns or targets given)
SHARE_LAUNCHES = {"near_rpy_b1": 0, "near_rpy_b2": 0, "near_rpy_radii_b1": 0,
                  "near_rpy_radii_b2": 0, "wall_near_b1": 0,
                  "wall_near_b2": 0}

MAX_RHS = 2          # K6 and K7 template instances: B = 1 and B = 2
MAX_CHEB = 32        # Chebyshev terms per piece the kernels' tables hold
MAX_CHEB_ROT = 48    # K8's rot remainder table (csrc/wall_rot_near.cu)
MAX_GROUPS = 8       # P2's radius groups (its table: G^2 x 3 pieces)
ROT_GROUP = 8        # K8 stages its series zero-padded to whole groups
_TILE_CELLS = 16     # plain versions: target cells per tile
# P2's pair list: a source id in the low PAIR_ID_BITS bits of an entry,
# its image code above (csrc/near_radii.cu)
PAIR_ID_BITS = 27


def _tiles(pos, cell_table, dims, box, cap, cells_range):
    """Per tile of target cells: target ids (TC, cap), their validity and
    positions, and the stencil's source ids (TC, 27, cap), validity and
    image positions (TC, 27, cap, 3)."""
    n = pos.shape[0]
    n_cells = int(dims[0]) * int(dims[1]) * int(dims[2])
    dev = pos.device
    ids = cell_table.reshape(n_cells, cap).long()
    valid = ids < n
    ids_c = torch.where(valid, ids, torch.zeros_like(ids))
    nbr = cells.neighbor_table(dims, device=dev)
    shift = (cells.wrap_counts(dims, device=dev).to(pos.dtype)
             * torch.as_tensor(box, dtype=pos.dtype, device=dev))
    lo, hi = cells_range if cells_range is not None else (0, n_cells)
    hi = min(hi, n_cells)
    for c0 in range(lo, hi, _TILE_CELLS):
        c = torch.arange(c0, min(c0 + _TILE_CELLS, hi), device=dev)
        nb = nbr[c]
        s_ids = ids_c[nb]
        yield (ids_c[c], valid[c], pos[ids_c[c]], s_ids, valid[nb],
               pos[s_ids] + shift[c][:, :, None, :])


def _scatter_rows(out, t_ids, t_valid, rows):
    out[t_ids[t_valid]] = rows[t_valid].to(out.dtype)


def nl_forces_plain(pos, cell_table, dims, box, cap, *, eps_over_b, inv_b,
                    two_a, cells_range=None):
    """Plain PyTorch K5: (N,3) repulsion per particle; rows outside
    `cells_range` (a (first, last) range of target cells) stay zero."""
    out = torch.zeros_like(pos)
    for t_ids, t_valid, tp, _, s_valid, sp in _tiles(
            pos, cell_table, dims, box, cap, cells_range):
        d = tp[:, :, None, None, :] - sp[:, None]        # (TC,cap,27,cap,3)
        r2 = torch.sum(d * d, dim=-1)
        inside = (t_valid[:, :, None, None] & s_valid[:, None]
                  & (r2 > 0))
        r = torch.sqrt(torch.where(inside, r2, torch.ones_like(r2)))
        mag = torch.where(r > two_a,
                          eps_over_b * torch.exp((two_a - r) * inv_b) / r,
                          eps_over_b / r)
        mag = torch.where(inside, mag, torch.zeros_like(mag))
        rows = torch.sum(mag[..., None] * d, dim=(2, 3))
        _scatter_rows(out, t_ids, t_valid, rows)
    return out


def nl_forces_open_plain(pos, cell_table, dims, periodic_length, members,
                         cap, *, eps_over_b, inv_b, two_a, rows=None):
    """Plain PyTorch K5, open instance: the JAX package's generic
    linked-cell sweep (forces.py:233-269). Each blob's row sums over the
    table's blobs of the 27 cells around its own cell (members: cells.
    cell_members' (order, starts) of the binning), the stencil clipped
    and masked at the edges of an open axis and wrapped on a periodic
    one, d under the minimum image on the periodic axes, its own id
    skipped; a blob beyond its cell's capacity is no source but keeps its
    row. `rows` (a range of target blobs) limits the rows computed; the
    others stay zero."""
    n = pos.shape[0]
    dev, dtype = pos.device, pos.dtype
    nx, ny, nz = (int(d) for d in dims)
    L = tuple(float(x) for x in periodic_length)
    order, starts = (t.long() for t in members)
    cid = torch.empty(n, dtype=torch.int64, device=dev)
    cid[order] = torch.searchsorted(
        starts, torch.arange(n, device=dev), right=True) - 1
    c3 = torch.stack([cid // (ny * nz), (cid // nz) % ny, cid % nz], dim=1)
    offs = torch.as_tensor(cells._O27, dtype=torch.int64, device=dev)
    dims_t = torch.tensor((nx, ny, nz), dtype=torch.int64, device=dev)
    table = torch.cat([cell_table.long(),
                       torch.full((1,), n, dtype=torch.int64, device=dev)])
    pos_pad = torch.cat([pos, torch.full((1, 3), 1e30, dtype=dtype,
                                         device=dev)])
    out = torch.zeros_like(pos)
    lo_r, hi_r = (0, n) if rows is None else (rows.start, min(rows.stop, n))
    tile = max(1, min(n, (1 << 24) // max(27 * cap * 3, 1)))
    ar = torch.arange(cap, device=dev)
    for i0 in range(lo_r, hi_r, tile):
        ids = torch.arange(i0, min(i0 + tile, hi_r), device=dev)
        cand3 = c3[ids][:, None, :] + offs[None]             # (T, 27, 3)
        valid = torch.ones(cand3.shape[:2], dtype=torch.bool, device=dev)
        for a in range(3):
            if L[a] > 0:
                cand3[..., a] = torch.remainder(cand3[..., a], dims_t[a])
            else:
                valid &= (cand3[..., a] >= 0) & (cand3[..., a] < dims_t[a])
                cand3[..., a] = cand3[..., a].clamp(0, int(dims_t[a]) - 1)
        ncid = (cand3[..., 0] * ny + cand3[..., 1]) * nz + cand3[..., 2]
        src = table[ncid[..., None] * cap + ar].reshape(len(ids), -1)
        mask = (valid[..., None].expand(-1, -1, cap).reshape(len(ids), -1)
                & (src < n) & (src != ids[:, None]))
        src = torch.where(mask, src, torch.full_like(src, n))
        d = pair_kernels.min_image(pos[ids][:, None, :] - pos_pad[src], L)
        r2 = torch.sum(d * d, dim=-1)
        live = mask & (r2 > 0)
        r = torch.sqrt(torch.where(live, r2, torch.ones_like(r2)))
        mag = torch.where(r > two_a,
                          eps_over_b * torch.exp((two_a - r) * inv_b) / r,
                          eps_over_b / r)
        mag = torch.where(live, mag, torch.zeros_like(mag))
        d = torch.where(live[..., None], d, torch.zeros_like(d))
        out[ids] = torch.sum(mag[..., None] * d, dim=1)
    return out


def _clenshaw(coeffs, t):
    b1 = torch.zeros_like(t)
    b2 = torch.zeros_like(t)
    for c in coeffs.flip(0)[:-1]:
        b1, b2 = 2.0 * t * b1 - b2 + c, b1
    return t * b1 - b2 + coeffs[0]


def pad_terms(coeffs, group=ROT_GROUP):
    """A Chebyshev table (..., K) zero-padded at the top to whole groups of
    `group` terms, as K8 stages it: a leading zero coefficient leaves the
    Clenshaw state exactly zero, so every sum of the padded table equals
    the unpadded one bit for bit."""
    k = coeffs.shape[-1]
    pad = -k % group
    if pad == 0:
        return coeffs
    return torch.cat([coeffs, coeffs.new_zeros(coeffs.shape[:-1] + (pad,))],
                     dim=-1)


def rot_products(has_f, has_t, want_v=True, want_w=True):
    """The rot products a K8 call forms, in the order it forms them: tr (v
    from torques), rt (w from forces), rr (w from torques)."""
    return tuple(name for name, on in (("tr", want_v and has_t),
                                       ("rt", want_w and has_f),
                                       ("rr", want_w and has_t)) if on)


def rot_instances(has_f, has_t, want_v=True, want_w=True):
    """K8's launches for a call: the grand instance when it forms all three
    products, else one instance a product (each adds into its own half of
    the rows)."""
    prods = rot_products(has_f, has_t, want_v, want_w)
    return ("grand",) if len(prods) == 3 else prods


def near_rpy_plain(pos, forces, cell_table, dims, box, cap, cheb, *,
                   two_a, r_cut, cells_range=None):
    """Plain PyTorch K6 (the JAX package's XLA cell sweep,
    ewald.py:1222-1344, single radius): (N, 3B) near-field rows without
    the self term; rows outside `cells_range` stay zero."""
    n = pos.shape[0]
    f = forces.reshape(n, -1)
    nc = f.shape[1]
    out = torch.zeros((n, nc), dtype=pos.dtype, device=pos.device)
    cheb = torch.as_tensor(cheb, dtype=pos.dtype, device=pos.device)
    mids = (0.5 * two_a, 0.5 * (two_a + r_cut))
    halfs = (0.5 * two_a, 0.5 * (r_cut - two_a))
    for t_ids, t_valid, tp, s_ids, s_valid, sp in _tiles(
            pos, cell_table, dims, box, cap, cells_range):
        fs = f[s_ids].to(pos.dtype)                       # (TC,27,cap,nc)
        d = tp[:, :, None, None, :] - sp[:, None]
        r2 = torch.sum(d * d, dim=-1)                     # (TC,cap,27,cap)
        inside = (t_valid[:, :, None, None] & s_valid[:, None]
                  & (r2 > 0) & (r2 < r_cut * r_cut))
        # the series only on the pairs inside r_cut; zero elsewhere
        r2_in = r2[inside]
        r = torch.sqrt(r2_in)
        t0 = torch.clamp((r - mids[0]) / halfs[0], -1.0, 1.0)
        t1 = torch.clamp((r - mids[1]) / halfs[1], -1.0, 1.0)
        near = r < two_a
        al = torch.zeros_like(r2)
        bfac = torch.zeros_like(r2)
        al[inside] = torch.where(near, _clenshaw(cheb[0, 0], t0),
                                 _clenshaw(cheb[1, 0], t1))
        bfac[inside] = torch.where(near, _clenshaw(cheb[0, 1], t0),
                                   _clenshaw(cheb[1, 1], t1)) / r2_in
        d = torch.where(inside[..., None], d, torch.zeros_like(d))
        fs3 = fs.reshape(*fs.shape[:-1], nc // 3, 3)      # (TC,27,cap,B,3)
        ddotf = torch.einsum("tiskc,tskbc->tiskb", d, fs3)
        rows = (torch.einsum("tisk,tskbc->tibc", al, fs3)
                + torch.einsum("tiskb,tiskc->tibc", bfac[..., None] * ddotf,
                               d)).reshape(*t_ids.shape, nc)
        _scatter_rows(out, t_ids, t_valid, rows)
    return out


def _radii_series(r, gt, gs, cheb_radii, edges, r_cut):
    """alpha(r) and beta(r) of the pairs at distances r (M,) of radius
    groups gt, gs (M,): each group pair's three pieces evaluated at the
    clipped t of each piece and the one r falls in (r < e1, r < e2)
    selected, as the JAX package's XLA sweep does; edges (G, G, 8) on the
    host."""
    al = torch.zeros_like(r)
    be = torch.zeros_like(r)
    G = cheb_radii.shape[0]
    for g in range(G):
        for h in range(g, G):
            mask = ((gt == g) & (gs == h)) | ((gt == h) & (gs == g))
            e1, e2 = float(edges[g, h, 0]), float(edges[g, h, 1])
            lims = (0.0, e1, e2, r_cut)
            vals = []
            for i in range(3):
                lo, hi = lims[i], lims[i + 1]
                t = torch.clamp((2.0 * r - (hi + lo)) / (hi - lo), -1.0, 1.0)
                vals.append((_clenshaw(cheb_radii[g, h, i, 0], t),
                             _clenshaw(cheb_radii[g, h, i, 1], t)))
            in1, in2 = r < e1, r < e2
            for j, acc in enumerate((al, be)):
                q = torch.where(in1, vals[0][j],
                                torch.where(in2, vals[1][j], vals[2][j]))
                acc += torch.where(mask, q, torch.zeros_like(q))
    return al, be


def near_rpy_radii_plain(pos, forces, group_of, cell_table, dims, box, cap,
                         cheb_radii, edges, *, r_cut, cells_range=None,
                         targets=None):
    """Plain PyTorch P2 (the radii branch of the JAX package's XLA cell
    sweep, ewald.py:1260-1290): (N, 3B) near-field rows without the self
    term. Each group pair's three pieces are all evaluated at the clipped
    t of each piece and the one the radius falls in (r < e1, r < e2) is
    selected, as there; edges (G, G, 8) from ewald.radii_edge_table."""
    n = pos.shape[0]
    f = forces.reshape(n, -1)
    nc = f.shape[1]
    out = torch.zeros((n, nc), dtype=pos.dtype, device=pos.device)
    cheb_radii = torch.as_tensor(cheb_radii, dtype=pos.dtype,
                                 device=pos.device)
    edges = torch.as_tensor(edges, dtype=torch.float64).cpu()
    grp = group_of.long()
    for t_ids, t_valid, tp, s_ids, s_valid, sp in _tiles(
            pos, cell_table, dims, box, cap, cells_range):
        fs = f[s_ids].to(pos.dtype)                       # (TC,27,cap,nc)
        d = tp[:, :, None, None, :] - sp[:, None]
        r2 = torch.sum(d * d, dim=-1)                     # (TC,cap,27,cap)
        if targets is not None:
            t_valid = t_valid & (t_ids >= targets[0]) & (t_ids < targets[1])
        inside = (t_valid[:, :, None, None] & s_valid[:, None]
                  & (r2 > 0) & (r2 < r_cut * r_cut))
        r2_in = r2[inside]
        gt = grp[t_ids][:, :, None, None].expand_as(r2)[inside]
        gs = grp[s_ids][:, None].expand_as(r2)[inside]
        al_in, be_in = _radii_series(torch.sqrt(r2_in), gt, gs, cheb_radii,
                                     edges, r_cut)
        al = torch.zeros_like(r2)
        bfac = torch.zeros_like(r2)
        al[inside] = al_in
        bfac[inside] = be_in / r2_in
        d = torch.where(inside[..., None], d, torch.zeros_like(d))
        fs3 = fs.reshape(*fs.shape[:-1], nc // 3, 3)      # (TC,27,cap,B,3)
        ddotf = torch.einsum("tiskc,tskbc->tiskb", d, fs3)
        rows = (torch.einsum("tisk,tskbc->tibc", al, fs3)
                + torch.einsum("tiskb,tiskc->tibc", bfac[..., None] * ddotf,
                               d)).reshape(*t_ids.shape, nc)
        _scatter_rows(out, t_ids, t_valid, rows)
    return out


@dataclasses.dataclass(frozen=True)
class RadiiPairs:
    """P2's pair list at one set of positions (`near_radii_pairs`): target
    i's sources are entries[offsets[i]:offsets[i + 1]], the pairs with
    0 < r < r_cut in the stencil's order, each j | code << PAIR_ID_BITS
    (an int32 holding those 32 bits) with code = 9 (wx + 1) + 3 (wy + 1) +
    (wz + 1), the wrap counts of the source's image x_j + w box. A
    particle dropped by cell overflow has no pairs. rows (N, 4) holds the
    positions with the radius group in w, as the product reads a source."""

    positions: torch.Tensor   # (N, 3) the positions it was built at
    group_of: torch.Tensor    # (N,) int32 the radius groups
    offsets: torch.Tensor     # (N + 1,) int32
    entries: torch.Tensor     # (P,) int32
    rows: torch.Tensor        # (N, 4)


def _pair_rows(pos, group_of):
    return torch.cat([pos, group_of.to(pos.dtype)[:, None]],
                     dim=1).contiguous()


def decode_pairs(pairs):
    """(target, source, wrap counts (P, 3)) of every entry of the list, in
    its order, int64."""
    n = pairs.positions.shape[0]
    counts = (pairs.offsets[1:] - pairs.offsets[:-1]).long()
    tid = torch.repeat_interleave(
        torch.arange(n, device=pairs.entries.device), counts)
    key = pairs.entries.long() & 0xFFFFFFFF
    code = key >> PAIR_ID_BITS
    wrap = torch.stack([code // 9, code // 3 % 3, code % 3], dim=1) - 1
    return tid, key & ((1 << PAIR_ID_BITS) - 1), wrap


def _pair_d(pos, tid, sid, wrap, box):
    """d = x_i - (x_j + w box) formed in float64 and rounded once to the
    positions' type, as the kernel forms it (csrc/near_radii.cu pair_d)."""
    p64 = pos.double()
    shift = wrap.double() * torch.as_tensor(box, dtype=torch.float64,
                                            device=pos.device)
    return (p64[tid] - (p64[sid] + shift)).to(pos.dtype)


def near_radii_pairs_plain(pos, group_of, cell_table, dims, box, cap, *,
                           r_cut, cells_range=None):
    """Plain PyTorch P2 list: every pair of the 27-cell stencil with
    0 < r^2 < r_cut^2, d formed as the product forms it (`_pair_d`), each
    target's pairs in the stencil's order (RadiiPairs); the targets
    outside `cells_range` (a (first, last) range of target cells) get
    none."""
    n = pos.shape[0]
    dev = pos.device
    n_cells = int(dims[0]) * int(dims[1]) * int(dims[2])
    ids = cell_table.reshape(n_cells, cap).long()
    valid = ids < n
    ids_c = torch.where(valid, ids, torch.zeros_like(ids))
    nbr = cells.neighbor_table(dims, device=dev)
    wraps = cells.wrap_counts(dims, device=dev)          # (cells, 27, 3)
    codes = ((wraps[..., 0] + 1) * 9 + (wraps[..., 1] + 1) * 3
             + wraps[..., 2] + 1)                         # (cells, 27)
    lo, hi = cells_range if cells_range is not None else (0, n_cells)
    hi = min(hi, n_cells)
    tids = [torch.zeros(0, dtype=torch.int64, device=dev)]
    keys = list(tids)
    for c0 in range(lo, hi, _TILE_CELLS):
        c = torch.arange(c0, min(c0 + _TILE_CELLS, hi), device=dev)
        t_ids, s_ids = ids_c[c], ids_c[nbr[c]]          # (TC,cap), (TC,27,cap)
        tc, cap_t = t_ids.shape
        tid = t_ids[:, :, None, None].expand(tc, cap_t, 27, cap)
        sid = s_ids[:, None].expand(tc, cap_t, 27, cap)
        wrap = wraps[c][:, None, :, None, :].expand(tc, cap_t, 27, cap, 3)
        d = _pair_d(pos, tid.reshape(-1), sid.reshape(-1),
                    wrap.reshape(-1, 3), box).reshape(tc, cap_t, 27, cap, 3)
        r2 = torch.sum(d * d, dim=-1)
        inside = (valid[c][:, :, None, None] & valid[nbr[c]][:, None]
                  & (r2 > 0) & (r2 < r_cut * r_cut))
        cc, i, k, j = inside.nonzero(as_tuple=True)
        tids.append(t_ids[cc, i])
        keys.append(s_ids[cc, k, j] | (codes[c][cc, k] << PAIR_ID_BITS))
    tid = torch.cat(tids)
    # each target lies in one tile, its pairs already in the stencil's order
    order = torch.sort(tid, stable=True).indices
    key = torch.cat(keys)[order]
    offsets = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    offsets[1:] = torch.cumsum(torch.bincount(tid, minlength=n), 0)
    entries = torch.where(key >= 2 ** 31, key - 2 ** 32, key).to(torch.int32)
    return RadiiPairs(pos, group_of, offsets.to(torch.int32), entries,
                      _pair_rows(pos, group_of))


def near_rpy_radii_pairs_plain(pairs, forces, cheb_radii, edges, box, *,
                               r_cut, targets=None):
    """Plain PyTorch P2 product over a pair list: (N, 3B) near-field rows
    without the self term, each pair's d as the kernel forms it and its
    series as `near_rpy_radii_plain` evaluates them; with targets (t0,
    t1) the rows of those targets alone, the others zero."""
    pos = pairs.positions
    n = pos.shape[0]
    f = forces.reshape(n, -1).to(pos.dtype)
    nc = f.shape[1]
    cheb_radii = torch.as_tensor(cheb_radii, dtype=pos.dtype,
                                 device=pos.device)
    edges = torch.as_tensor(edges, dtype=torch.float64).cpu()
    tid, sid, wrap = decode_pairs(pairs)
    if targets is not None:
        mine = (tid >= targets[0]) & (tid < targets[1])
        tid, sid, wrap = tid[mine], sid[mine], wrap[mine]
    d = _pair_d(pos, tid, sid, wrap, box)
    r2 = torch.sum(d * d, dim=-1)
    grp = pairs.group_of.long()
    al, be = _radii_series(torch.sqrt(r2), grp[tid], grp[sid], cheb_radii,
                           edges, r_cut)
    f3 = f[sid].reshape(-1, nc // 3, 3)                  # (P, B, 3)
    ddotf = torch.einsum("pc,pbc->pb", d, f3)
    rows = (al[:, None, None] * f3
            + ((be / r2)[:, None] * ddotf)[..., None] * d[:, None])
    out = torch.zeros((n, nc), dtype=pos.dtype, device=pos.device)
    out.index_add_(0, tid, rows.reshape(-1, nc))
    return out


def _clenshaw_rows(coeffs, t):
    """Clenshaw sums of several series at once: coeffs (M, F, K) per
    point, t (M,) -> (M, F)."""
    b1 = torch.zeros(coeffs.shape[:2], dtype=t.dtype, device=t.device)
    b2 = torch.zeros_like(b1)
    t2 = 2.0 * t[:, None]
    for k in range(coeffs.shape[2] - 1, 0, -1):
        b1, b2 = t2 * b1 - b2 + coeffs[:, :, k], b1
    return t[:, None] * b1 - b2 + coeffs[:, :, 0]


def wall_pair_rows(dv, src_z, tgt_z, f_raw, cheb, img_cheb, *, two_a, r_cut,
                   a, pref_img, img_range):
    """K7's pairs inside r_cut one by one: displacements dv (M, 3) =
    target - source, the source's and target's physical z (M,), the
    source's raw strengths f_raw (M, 3B) -> (M, 3B) contributions to the
    target's row (the RPY remainder on mirrored strengths, plus the
    screened image channels for a real target and an image source)."""
    from . import _wall_channels_gen as gen

    B = f_raw.shape[1] // 3
    mids = (0.5 * two_a, 0.5 * (two_a + r_cut))
    halfs = (0.5 * two_a, 0.5 * (r_cut - two_a))
    ir_lo, ir_mid, ir_hi = img_range
    mirror = torch.as_tensor([-1.0, -1.0, 1.0] * B, dtype=dv.dtype,
                             device=dv.device)
    r2_in = torch.sum(dv * dv, dim=-1)
    r = torch.sqrt(r2_in)
    # ---- RPY remainder on mirrored strengths
    near = r < two_a
    t0 = torch.clamp((r - mids[0]) / halfs[0], -1.0, 1.0)
    t1 = torch.clamp((r - mids[1]) / halfs[1], -1.0, 1.0)
    al = torch.where(near, _clenshaw(cheb[0, 0], t0),
                     _clenshaw(cheb[1, 0], t1))
    bfac = torch.where(near, _clenshaw(cheb[0, 1], t0),
                       _clenshaw(cheb[1, 1], t1)) / r2_in
    src_img = src_z < 0.0
    fm = torch.where(src_img[:, None], f_raw * mirror, f_raw)
    fs3 = fm.reshape(-1, B, 3)
    ddotf = torch.sum(dv[:, None, :] * fs3, dim=-1)       # (M, B)
    rows = (al[:, None, None] * fs3
            + (bfac[:, None] * ddotf)[..., None] * dv[:, None, :])
    # ---- screened image channels: real target, image source
    pair = src_img & (tgt_z > 0.0)
    if bool(pair.any()):
        q = pair.nonzero(as_tuple=True)[0]
        rs = torch.clamp(r[q] / a, ir_lo, ir_hi)
        p0 = rs < ir_mid
        ti = torch.clamp(torch.where(
            p0, (2.0 * rs - (ir_mid + ir_lo)) / (ir_mid - ir_lo),
            (2.0 * rs - (ir_hi + ir_mid)) / (ir_hi - ir_mid)), -1.0, 1.0)
        cv = _clenshaw_rows(img_cheb[torch.where(p0, 0, 1)], ti).unbind(1)
        dq = dv[q] / a
        hq = -src_z[q] / a
        fr = f_raw[q].reshape(-1, B, 3)
        for b in range(B):
            ux, uy, uz = gen.img_terms(
                dq[:, 0], dq[:, 1], dq[:, 2], hq, fr[:, b, 0],
                fr[:, b, 1], fr[:, b, 2], 1.0, *cv)
            rows[q, b] += pref_img * torch.stack([ux, uy, uz], dim=1)
    return rows.reshape(-1, 3 * B)


def wall_near_plain(pos, forces, cell_table, dims, box, cap, cheb, img_cheb,
                    *, two_a, r_cut, z0, a, pref_img, img_range,
                    cells_range=None):
    """Plain PyTorch K7 (the JAX package's XLA sweep, ewald_wall.py:753-872,
    per pair inside r_cut): pos (2N, 3) grid-shifted reals then images,
    forces (N, 3B) raw strengths -> (N, 3B) rows of the real particles
    without the self term; rows outside `cells_range` stay zero."""
    n = pos.shape[0] // 2
    f = forces.reshape(n, -1).to(pos.dtype)
    nc = f.shape[1]
    out = torch.zeros((n, nc), dtype=pos.dtype, device=pos.device)
    cheb = torch.as_tensor(cheb, dtype=pos.dtype, device=pos.device)
    img_cheb = torch.as_tensor(img_cheb, dtype=pos.dtype, device=pos.device)
    kw = dict(two_a=two_a, r_cut=r_cut, a=a, pref_img=pref_img,
              img_range=img_range)
    for t_ids, t_valid, tp, s_ids, s_valid, sp in _tiles(
            pos, cell_table, dims, box, cap, cells_range):
        d = tp[:, :, None, None, :] - sp[:, None]        # (TC,cap,27,cap,3)
        r2 = torch.sum(d * d, dim=-1)
        inside = ((t_valid & (t_ids < n))[:, :, None, None]
                  & s_valid[:, None] & (r2 > 0) & (r2 < r_cut * r_cut))
        c, i, k, j = inside.nonzero(as_tuple=True)
        tid, sid = t_ids[c, i], s_ids[c, k, j]
        rows = wall_pair_rows(d[c, i, k, j], pos[sid, 2] + z0,
                              pos[tid, 2] + z0, f[sid % n], cheb, img_cheb,
                              **kw)
        out.index_add_(0, tid, rows)
    return out


def wall_rot_pair_rows(dv, src_z, tgt_z, f_src, t_src, cheb, img_cheb, *,
                       two_a, r_cut, a, pref_c, pref_r, img_range,
                       want_v=True, want_w=True):
    """K8's pairs inside r_cut one by one: displacements dv (M, 3) =
    target - source, the source's and target's physical z (M,), the
    source's damped strengths f_src and t_src (M, 3), either None ->
    (M, 6) contributions (v, w) to the target's row: the rot remainders
    for a real source, the screened image rot channels for an image
    source (the JAX package's grand_near_xla, ewald_wall_rot.py:235-304).
    Only the products of the outputs asked for (rot_products) are formed;
    the other half stays zero. The series run on K8's padded tables
    (pad_terms)."""
    from . import _wall_channels_gen as gen

    prods = rot_products(f_src is not None, t_src is not None, want_v,
                         want_w)
    out = dv.new_zeros((dv.shape[0], 6))
    r2 = torch.sum(dv * dv, dim=-1)
    r = torch.sqrt(r2)
    cheb = pad_terms(cheb)
    img_cheb = pad_terms(img_cheb)
    # ---- rot remainders (real sources): gamma_r for tr and rt, alpha_r
    # and beta_r for rr
    q = (src_z > 0.0).nonzero(as_tuple=True)[0]
    if q.numel():
        d, rq = dv[q], r[q]
        near = rq < two_a
        t0 = torch.clamp((rq - 0.5 * two_a) / (0.5 * two_a), -1.0, 1.0)
        t1 = torch.clamp((rq - 0.5 * (two_a + r_cut)) / (0.5 * (r_cut - two_a)),
                         -1.0, 1.0)

        def series(i):
            return torch.where(near, _clenshaw(cheb[0, i], t0),
                               _clenshaw(cheb[1, i], t1))

        rows = out.new_zeros((q.numel(), 6))
        if "tr" in prods or "rt" in prods:
            gam = series(0)[:, None]
        if "tr" in prods:
            rows[:, :3] += gam * torch.linalg.cross(t_src[q], d)
        if "rt" in prods:
            rows[:, 3:] += gam * torch.linalg.cross(f_src[q], d)
        if "rr" in prods:
            tq = t_src[q]
            rows[:, 3:] += (series(1)[:, None] * tq
                            + (series(2) * torch.sum(d * tq, -1)
                               / r2[q])[:, None] * d)
        out[q] += rows
    # ---- screened image rot channels (image sources, real targets)
    q = ((src_z < 0.0) & (tgt_z > 0.0)).nonzero(as_tuple=True)[0]
    if q.numel():
        ir_lo, ir_mid, ir_hi = img_range
        rs = torch.clamp(r[q] / a, ir_lo, ir_hi)
        p0 = rs < ir_mid
        ti = torch.clamp(torch.where(
            p0, (2.0 * rs - (ir_mid + ir_lo)) / (ir_mid - ir_lo),
            (2.0 * rs - (ir_hi + ir_mid)) / (ir_hi - ir_mid)), -1.0, 1.0)
        cv = _clenshaw_rows(img_cheb[torch.where(p0, 0, 1)], ti).unbind(1)
        dq = (dv[q] / a).unbind(1)
        rows = out.new_zeros((q.numel(), 6))
        if "rt" in prods:
            w = gen.img_terms_rt(*dq, -src_z[q] / a, *f_src[q].unbind(1),
                                 *cv)
            rows[:, 3:] += pref_c * torch.stack(w, dim=1)
        if "tr" in prods:
            u = gen.img_terms_tr(*dq, tgt_z[q] / a, *t_src[q].unbind(1), *cv)
            rows[:, :3] += pref_c * torch.stack(u, dim=1)
        if "rr" in prods:
            w = gen.img_terms_rr(*dq, *t_src[q].unbind(1), *cv)
            rows[:, 3:] += pref_r * torch.stack(w, dim=1)
        out[q] += rows
    return out


def wall_rot_near_plain(pos, f, t, cell_table, dims, box, cap, cheb,
                        img_cheb, *, two_a, r_cut, z0, a, pref_c, pref_r,
                        img_range, cells_range=None, want_v=True,
                        want_w=True):
    """Plain PyTorch K8 (the JAX package's XLA sweep, ewald_wall_rot.py:
    153-322, per pair inside r_cut): pos (2N, 3) grid-shifted reals then
    images, f and t (N, 3) damped strengths (either None), cheb (2, 3, K)
    the rot remainders, img_cheb (2, 10, Ki) the image series -> (N, 6)
    rows (v, w) of the real particles without the rr self term, the
    outputs not asked for (want_v, want_w) zero; rows outside
    `cells_range` stay zero."""
    n = pos.shape[0] // 2
    out = torch.zeros((n, 6), dtype=pos.dtype, device=pos.device)
    cheb = torch.as_tensor(cheb, dtype=pos.dtype, device=pos.device)
    img_cheb = torch.as_tensor(img_cheb, dtype=pos.dtype, device=pos.device)
    f = None if f is None else f.reshape(n, 3).to(pos.dtype)
    t = None if t is None else t.reshape(n, 3).to(pos.dtype)
    kw = dict(two_a=two_a, r_cut=r_cut, a=a, pref_c=pref_c, pref_r=pref_r,
              img_range=img_range, want_v=want_v, want_w=want_w)
    for t_ids, t_valid, tp, s_ids, s_valid, sp in _tiles(
            pos, cell_table, dims, box, cap, cells_range):
        d = tp[:, :, None, None, :] - sp[:, None]        # (TC,cap,27,cap,3)
        r2 = torch.sum(d * d, dim=-1)
        inside = ((t_valid & (t_ids < n))[:, :, None, None]
                  & s_valid[:, None] & (r2 > 0) & (r2 < r_cut * r_cut))
        c, i, k, j = inside.nonzero(as_tuple=True)
        tid, sid = t_ids[c, i], s_ids[c, k, j]
        src = sid % n
        rows = wall_rot_pair_rows(
            d[c, i, k, j], pos[sid, 2] + z0, pos[tid, 2] + z0,
            None if f is None else f[src], None if t is None else t[src],
            cheb, img_cheb, **kw)
        out.index_add_(0, tid, rows)
    return out


def _check(what, pos, cell_table, dims, cap, extra=(), guard_z=False,
           open_axes=False):
    if not open_axes and (min(int(d) for d in dims[:2]) < 4
                          or int(dims[2]) < (2 if guard_z else 4)):
        raise ValueError(f"{what}: cell dims {tuple(dims)}; the stencil "
                         "needs at least 4 cells a side (2 on z below an "
                         "empty guard layer)")
    if pos.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {pos.device}")
    dtype = pos.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{what}: dtype {dtype} (float32/float64 only)")
    for name, t in (("pos", pos),) + tuple(extra):
        if t.device != pos.device or t.dtype != dtype:
            raise ValueError(f"{what}: {name} is {t.dtype} on {t.device}, "
                             f"expected {dtype} on {pos.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
    if pos.ndim != 2 or pos.shape[1] != 3:
        raise ValueError(f"{what}: pos must be (N,3), got "
                         f"{tuple(pos.shape)}")
    n_cells = int(dims[0]) * int(dims[1]) * int(dims[2])
    if (cell_table.device != pos.device or cell_table.dtype != torch.int32
            or not cell_table.is_contiguous()
            or cell_table.shape != (n_cells * cap,)):
        raise ValueError(f"{what}: cell_table must be a contiguous int32 "
                         f"({n_cells * cap},) tensor on {pos.device}")
    if max(n_cells * cap, 6 * pos.shape[0]) >= 2 ** 31:
        raise ValueError(f"{what}: too many cells or rows for 32-bit "
                         "indexing")


def nl_forces(pos, cell_table, dims, box, cap, *, eps_over_b, inv_b, two_a,
              guard_z=False):
    """K5 wrapper: the CUDA kernel for CUDA tensors, `nl_forces_plain` for
    CPU tensors. pos (N,3) -> (N,3); guard_z declares an empty top z
    layer (the wall slab)."""
    kw = dict(eps_over_b=eps_over_b, inv_b=inv_b, two_a=two_a)
    if pos.device.type == "cpu":
        return nl_forces_plain(pos, cell_table, dims, box, cap, **kw)
    _check("nl_forces", pos, cell_table, dims, cap, guard_z=guard_z)
    out = torch.zeros_like(pos)
    if pos.shape[0] == 0:
        return out
    name = f"nl_forces_{'f32' if pos.dtype == torch.float32 else 'f64'}"
    err = getattr(_build.library(), name)(
        pos.data_ptr(), cell_table.data_ptr(), out.data_ptr(), pos.shape[0],
        *(int(d) for d in dims), int(cap), *(float(L) for L in box),
        *mobility_cuda.fold_law(eps_over_b, inv_b, two_a),
        torch.cuda.current_stream(pos.device).cuda_stream)
    _build.check(name, err)
    LAUNCHES["nl_forces"] += 1
    return out


def nl_forces_open(pos, cell_table, dims, periodic_length, frame, members,
                   cap, *, eps_over_b, inv_b, two_a):
    """K5 wrapper, open instance: the CUDA kernel for CUDA tensors,
    `nl_forces_open_plain` for CPU tensors. pos (N,3) wrapped on the
    periodic axes, cell_table from cells.cell_bin on the open frame's cell
    ids, frame (lo, edge) of cells.open_frame, members (order, starts) of
    cells.cell_members -> (N,3)."""
    kw = dict(eps_over_b=eps_over_b, inv_b=inv_b, two_a=two_a)
    if pos.device.type == "cpu":
        return nl_forces_open_plain(pos, cell_table, dims, periodic_length,
                                    members, cap, **kw)
    L = tuple(float(x) for x in periodic_length)
    for a, x in enumerate(L):
        if x > 0 and int(dims[a]) < 4:
            raise ValueError(f"nl_forces_open: cell dims {tuple(dims)}; a "
                             "periodic axis needs at least 4 cells")
    order, starts = members
    n_cells = int(dims[0]) * int(dims[1]) * int(dims[2])
    _check("nl_forces_open", pos, cell_table, dims, cap, open_axes=True)
    if (order.dtype != torch.int32
            or starts.dtype != torch.int32
            or order.shape != (pos.shape[0],)
            or starts.shape != (n_cells + 1,)
            or order.device != pos.device or starts.device != pos.device):
        raise ValueError("nl_forces_open: order and starts must be "
                         f"({pos.shape[0]},) and ({n_cells + 1},) int32 on "
                         f"{pos.device}")
    out = torch.zeros_like(pos)
    if pos.shape[0] == 0:
        return out
    lo, edge = (t.double().cpu().tolist() for t in frame)
    name = ("nl_forces_open_"
            f"{'f32' if pos.dtype == torch.float32 else 'f64'}")
    arr = ctypes.c_double * 3
    err = getattr(_build.library(), name)(
        pos.data_ptr(), cell_table.data_ptr(), order.contiguous().data_ptr(),
        starts.contiguous().data_ptr(), out.data_ptr(), pos.shape[0],
        *(int(d) for d in dims), int(cap), arr(*lo), arr(*edge),
        arr(*(x if x > 0 else 0.0 for x in L)),
        *mobility_cuda.fold_law(eps_over_b, inv_b, two_a),
        torch.cuda.current_stream(pos.device).cuda_stream)
    _build.check(name, err)
    LAUNCHES["nl_forces_open"] += 1
    return out


def near_rpy(pos, forces, cell_table, dims, box, cap, cheb, *, two_a,
             r_cut, cells_range=None):
    """K6 wrapper: the CUDA kernel for CUDA tensors, `near_rpy_plain` for
    CPU tensors. pos (N,3), forces (N,3B), cheb (2 pieces, 2 functions, K)
    -> (N,3B) without the self term; with cells_range (c0, c1) the rows of
    those target cells' particles alone, the others zero (a rank's
    share)."""
    kw = dict(two_a=two_a, r_cut=r_cut)
    if pos.device.type == "cpu":
        return near_rpy_plain(pos, forces, cell_table, dims, box, cap, cheb,
                              cells_range=cells_range, **kw)
    _check("near_rpy", pos, cell_table, dims, cap,
           (("forces", forces), ("cheb", cheb)))
    n = pos.shape[0]
    if (forces.ndim != 2 or forces.shape[0] != n or forces.shape[1] % 3
            or not 1 <= forces.shape[1] // 3 <= MAX_RHS):
        raise ValueError(f"near_rpy: forces must be (N, 3B) with B in 1.."
                         f"{MAX_RHS}, got {tuple(forces.shape)}")
    if cheb.ndim != 3 or cheb.shape[:2] != (2, 2) or not (
            1 <= cheb.shape[2] <= MAX_CHEB):
        raise ValueError(f"near_rpy: cheb must be (2, 2, K) with K <= "
                         f"{MAX_CHEB}, got {tuple(cheb.shape)}")
    n_rhs = forces.shape[1] // 3
    out = torch.zeros_like(forces)
    if n == 0:
        return out
    n_cells = int(dims[0]) * int(dims[1]) * int(dims[2])
    c0, c1 = _share("near_rpy", cells_range, n_cells)
    name = (f"near_rpy_{'f32' if pos.dtype == torch.float32 else 'f64'}"
            f"_b{n_rhs}")
    err = getattr(_build.library(), name)(
        pos.data_ptr(), forces.data_ptr(), cell_table.data_ptr(),
        cheb.data_ptr(), out.data_ptr(), n, *(int(d) for d in dims),
        int(cap), int(cheb.shape[2]), *(float(L) for L in box),
        float(two_a), float(r_cut), c0, c1,
        torch.cuda.current_stream(pos.device).cuda_stream)
    _build.check(name, err)
    LAUNCHES[f"near_rpy_b{n_rhs}"] += 1
    if cells_range is not None:
        SHARE_LAUNCHES[f"near_rpy_b{n_rhs}"] += 1
    return out


def _share(what, rng, total):
    """(lo, hi) of a share range within [0, total] (all of it for
    None)."""
    if rng is None:
        return 0, int(total)
    lo, hi = int(rng[0]), int(rng[1])
    if not 0 <= lo <= hi <= total:
        raise ValueError(f"{what}: range {(lo, hi)} outside [0, {total}]")
    return lo, hi


def _check_groups(what, group_of, pos):
    n = pos.shape[0]
    if (group_of.device != pos.device or group_of.dtype != torch.int32
            or group_of.shape != (n,) or not group_of.is_contiguous()):
        raise ValueError(f"{what}: group_of must be a contiguous int32 "
                         f"({n},) tensor on {pos.device}")


def near_radii_pairs(pos, group_of, cell_table, dims, box, cap, *, r_cut):
    """P2's pair list at these positions (RadiiPairs): the CUDA kernel's
    count and fill passes for CUDA tensors, with the scan of the counts
    between them (one host sync for the list's length), and
    `near_radii_pairs_plain` for CPU tensors. pos (N,3) in the box (or
    drifted from it by less than the plan's budget), group_of (N,) int32,
    the cell table of ops/cells.cell_bin."""
    if pos.device.type == "cpu":
        return near_radii_pairs_plain(pos, group_of, cell_table, dims, box,
                                      cap, r_cut=r_cut)
    _check("near_radii_pairs", pos, cell_table, dims, cap)
    _check_groups("near_radii_pairs", group_of, pos)
    n = pos.shape[0]
    if n >= 2 ** PAIR_ID_BITS:
        raise ValueError(f"near_radii_pairs: {n} particles; an entry holds "
                         f"ids below 2^{PAIR_ID_BITS}")
    dev = pos.device
    if n == 0:
        return RadiiPairs(pos, group_of, torch.zeros(1, dtype=torch.int32,
                                                     device=dev),
                          torch.zeros(0, dtype=torch.int32, device=dev),
                          _pair_rows(pos, group_of))
    name = f"near_radii_pairs_{'f32' if pos.dtype == torch.float32 else 'f64'}"
    fn = getattr(_build.library(), name)
    stream = torch.cuda.current_stream(dev).cuda_stream
    grid = (*(int(d) for d in dims), int(cap), *(float(L) for L in box),
            float(r_cut))
    count = torch.zeros(n, dtype=torch.int32, device=dev)
    _build.check(name, fn(pos.data_ptr(), cell_table.data_ptr(),
                          count.data_ptr(), None, None, n, *grid, 0, stream))
    offsets = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    torch.cumsum(count, 0, out=offsets[1:])
    total = int(offsets[-1])
    if total >= 2 ** 31:
        raise ValueError(f"near_radii_pairs: {total} pairs; the offsets "
                         "are int32")
    offsets = offsets.to(torch.int32)
    entries = torch.empty(total, dtype=torch.int32, device=dev)
    _build.check(name, fn(pos.data_ptr(), cell_table.data_ptr(), None,
                          offsets.data_ptr(), entries.data_ptr(), n, *grid, 1,
                          stream))
    LAUNCHES["near_radii_pairs"] += 1
    return RadiiPairs(pos, group_of, offsets, entries,
                      _pair_rows(pos, group_of))


def near_rpy_radii(pos, forces, group_of, cell_table, dims, box, cap,
                   cheb_radii, edges, *, r_cut, pairs=None, targets=None):
    """P2 wrapper: the CUDA kernel for CUDA tensors, the plain versions for
    CPU tensors (`near_rpy_radii_plain`, or `near_rpy_radii_pairs_plain`
    over `pairs`). pos (N,3), forces (N,3B), group_of (N,) int32 radius
    groups, cheb_radii (G, G, 3 pieces, 2 functions, K), edges (G, G, 8)
    (ewald.radii_edge_table), pairs the list `near_radii_pairs` built at
    these very pos and group_of (built here when None) -> (N,3B) without
    the self term; with targets (t0, t1) the rows of those targets alone,
    the others zero (a rank's share)."""
    if pos.device.type == "cpu":
        if pairs is not None:
            return near_rpy_radii_pairs_plain(pairs, forces, cheb_radii,
                                              edges, box, r_cut=r_cut,
                                              targets=targets)
        return near_rpy_radii_plain(pos, forces, group_of, cell_table, dims,
                                    box, cap, cheb_radii, edges,
                                    r_cut=r_cut, targets=targets)
    _check("near_rpy_radii", pos, cell_table, dims, cap,
           (("forces", forces), ("cheb_radii", cheb_radii),
            ("edges", edges)))
    n = pos.shape[0]
    if (forces.ndim != 2 or forces.shape[0] != n or forces.shape[1] % 3
            or not 1 <= forces.shape[1] // 3 <= MAX_RHS):
        raise ValueError(f"near_rpy_radii: forces must be (N, 3B) with B in "
                         f"1..{MAX_RHS}, got {tuple(forces.shape)}")
    G = cheb_radii.shape[0]
    if (cheb_radii.ndim != 5 or cheb_radii.shape[:4] != (G, G, 3, 2)
            or not 1 <= G <= MAX_GROUPS
            or not 1 <= cheb_radii.shape[4] <= MAX_CHEB
            or edges.shape != (G, G, 8)):
        raise ValueError(f"near_rpy_radii: cheb_radii must be (G, G, 3, 2, K) "
                         f"with G <= {MAX_GROUPS}, K <= {MAX_CHEB}, edges "
                         f"(G, G, 8); got {tuple(cheb_radii.shape)}, "
                         f"{tuple(edges.shape)}")
    _check_groups("near_rpy_radii", group_of, pos)
    if pairs is None:
        pairs = near_radii_pairs(pos, group_of, cell_table, dims, box, cap,
                                 r_cut=r_cut)
    elif pairs.positions is not pos or pairs.group_of is not group_of:
        raise ValueError("near_rpy_radii: the pair list was built at other "
                         "positions or radius groups")
    n_rhs = forces.shape[1] // 3
    t0, t1 = _share("near_rpy_radii", targets, n)
    # a share writes its own rows: the others must read zero
    out = (torch.empty_like if targets is None else torch.zeros_like)(forces)
    if n == 0:
        return out
    name = (f"near_rpy_radii_{'f32' if pos.dtype == torch.float32 else 'f64'}"
            f"_b{n_rhs}")
    err = getattr(_build.library(), name)(
        pairs.rows.data_ptr(), forces.data_ptr(), pairs.offsets.data_ptr(),
        pairs.entries.data_ptr(), cheb_radii.data_ptr(), edges.data_ptr(),
        out.data_ptr(), n, int(cheb_radii.shape[4]), G,
        *(float(L) for L in box), t0, t1,
        torch.cuda.current_stream(pos.device).cuda_stream)
    _build.check(name, err)
    LAUNCHES[f"near_rpy_radii_b{n_rhs}"] += 1
    if targets is not None:
        SHARE_LAUNCHES[f"near_rpy_radii_b{n_rhs}"] += 1
    return out


def wall_near(pos, forces, cell_table, dims, box, cap, cheb, img_cheb, *,
              two_a, r_cut, z0, a, pref_img, img_range, cz_range,
              columns=None):
    """K7 wrapper: the CUDA kernel for CUDA tensors, `wall_near_plain` for
    CPU tensors. pos (2N, 3) grid-shifted reals then images, forces
    (N, 3B) raw strengths, cheb (2, 2, K), img_cheb (2, 10, Ki), img_range
    the image series' (r_lo, r_mid, r_hi) / a, cz_range the z layers
    (lo, hi) of the target cells (those that can hold real particles)
    -> (N, 3B) without the self term; with columns (k0, k1) the rows of
    the real particles in those (x, y) cell columns alone, the others zero
    (a rank's share)."""
    kw = dict(two_a=two_a, r_cut=r_cut, z0=z0, a=a, pref_img=pref_img,
              img_range=img_range)
    if pos.device.type == "cpu":
        rng = None
        if columns is not None:
            nz = int(dims[2])
            rng = (int(columns[0]) * nz, int(columns[1]) * nz)
        return wall_near_plain(pos, forces, cell_table, dims, box, cap, cheb,
                               img_cheb, cells_range=rng, **kw)
    _check("wall_near", pos, cell_table, dims, cap,
           (("forces", forces), ("cheb", cheb), ("img_cheb", img_cheb)),
           guard_z=True)
    n = pos.shape[0] // 2
    if (pos.shape[0] % 2 or forces.ndim != 2 or forces.shape[0] != n
            or forces.shape[1] % 3
            or not 1 <= forces.shape[1] // 3 <= MAX_RHS):
        raise ValueError(f"wall_near: pos must be (2N, 3) and forces (N, 3B) "
                         f"with B in 1..{MAX_RHS}, got {tuple(pos.shape)}, "
                         f"{tuple(forces.shape)}")
    if (cheb.ndim != 3 or cheb.shape[:2] != (2, 2)
            or not 1 <= cheb.shape[2] <= MAX_CHEB or img_cheb.ndim != 3
            or img_cheb.shape[:2] != (2, 10)
            or not 1 <= img_cheb.shape[2] <= MAX_CHEB):
        raise ValueError(f"wall_near: cheb (2, 2, K) and img_cheb (2, 10, Ki) "
                         f"with K, Ki <= {MAX_CHEB}, got {tuple(cheb.shape)}, "
                         f"{tuple(img_cheb.shape)}")
    cz_lo, cz_hi = (int(c) for c in cz_range)
    if not 0 <= cz_lo <= cz_hi < int(dims[2]):
        raise ValueError(f"wall_near: z layers {cz_range} outside the "
                         f"{int(dims[2])} of the cell grid")
    n_rhs = forces.shape[1] // 3
    out = torch.zeros_like(forces)
    if n == 0:
        return out
    k0, k1 = _share("wall_near", columns, int(dims[0]) * int(dims[1]))
    name = (f"wall_near_{'f32' if pos.dtype == torch.float32 else 'f64'}"
            f"_b{n_rhs}")
    err = getattr(_build.library(), name)(
        pos.data_ptr(), forces.data_ptr(), cell_table.data_ptr(),
        cheb.data_ptr(), img_cheb.data_ptr(), out.data_ptr(), n,
        *(int(d) for d in dims), int(cap), int(cheb.shape[2]),
        int(img_cheb.shape[2]), cz_lo, cz_hi, *(float(L) for L in box),
        float(two_a), float(r_cut), float(z0), float(a), float(pref_img),
        *(float(v) for v in img_range), k0, k1,
        torch.cuda.current_stream(pos.device).cuda_stream)
    _build.check(name, err)
    LAUNCHES[f"wall_near_b{n_rhs}"] += 1
    if columns is not None:
        SHARE_LAUNCHES[f"wall_near_b{n_rhs}"] += 1
    return out


def wall_rot_near(pos, f, t, cell_table, dims, box, cap, cheb, img_cheb, *,
                  two_a, r_cut, z0, a, pref_c, pref_r, img_range, cz_range,
                  want_v=True, want_w=True):
    """K8 wrapper: the CUDA kernel for CUDA tensors, `wall_rot_near_plain`
    for CPU tensors. pos (2N, 3) grid-shifted reals then images, f and t
    (N, 3) damped forces and torques (either None, not both), cheb
    (2, 3, K) the rot remainders, img_cheb (2, 10, Ki) the image series,
    img_range their (r_lo, r_mid, r_hi) / a, cz_range the z layers (lo, hi)
    of the target cells -> (N, 6) rows (v, w) without the rr self term; an
    output not asked for (want_v, want_w) is not formed and stays zero.
    The call launches rot_instances' instances into one output (v comes
    from torques alone, so a product of forces alone forms w)."""
    kw = dict(two_a=two_a, r_cut=r_cut, z0=z0, a=a, pref_c=pref_c,
              pref_r=pref_r, img_range=img_range)
    if f is None and t is None:
        raise ValueError("wall_rot_near: neither forces nor torques")
    if pos.device.type == "cpu":
        return wall_rot_near_plain(pos, f, t, cell_table, dims, box, cap,
                                   cheb, img_cheb, want_v=want_v,
                                   want_w=want_w, **kw)
    strengths = tuple((name, x) for name, x in (("f", f), ("t", t))
                      if x is not None)
    _check("wall_rot_near", pos, cell_table, dims, cap,
           strengths + (("cheb", cheb), ("img_cheb", img_cheb)),
           guard_z=True)
    n = pos.shape[0] // 2
    if pos.shape[0] % 2 or any(x.shape != (n, 3) for _, x in strengths):
        raise ValueError(f"wall_rot_near: pos must be (2N, 3) and f, t "
                         f"(N, 3), got {tuple(pos.shape)}, "
                         f"{[tuple(x.shape) for _, x in strengths]}")
    if (cheb.ndim != 3 or cheb.shape[:2] != (2, 3)
            or not 1 <= cheb.shape[2] <= MAX_CHEB_ROT or img_cheb.ndim != 3
            or img_cheb.shape[:2] != (2, 10)
            or not 1 <= img_cheb.shape[2] <= MAX_CHEB):
        raise ValueError(f"wall_rot_near: cheb (2, 3, K <= {MAX_CHEB_ROT}) "
                         f"and img_cheb (2, 10, Ki <= {MAX_CHEB}), got "
                         f"{tuple(cheb.shape)}, {tuple(img_cheb.shape)}")
    cz_lo, cz_hi = (int(c) for c in cz_range)
    if not 0 <= cz_lo <= cz_hi < int(dims[2]):
        raise ValueError(f"wall_rot_near: z layers {cz_range} outside the "
                         f"{int(dims[2])} of the cell grid")
    out = torch.zeros((n, 6), dtype=pos.dtype, device=pos.device)
    if n == 0:
        return out
    lib = _build.library()
    prec = "f32" if pos.dtype == torch.float32 else "f64"
    for inst in rot_instances(f is not None, t is not None, want_v, want_w):
        name = f"wall_rot_near_{prec}_{inst}"
        err = getattr(lib, name)(
            pos.data_ptr(), None if f is None else f.data_ptr(),
            None if t is None else t.data_ptr(), cell_table.data_ptr(),
            cheb.data_ptr(), img_cheb.data_ptr(), out.data_ptr(), n,
            *(int(d) for d in dims), int(cap), int(cheb.shape[2]),
            int(img_cheb.shape[2]), cz_lo, cz_hi, *(float(L) for L in box),
            float(two_a), float(r_cut), float(z0), float(a), float(pref_c),
            float(pref_r), *(float(v) for v in img_range),
            torch.cuda.current_stream(pos.device).cuda_stream)
        _build.check(name, err)
        LAUNCHES[f"wall_rot_near_{inst}"] += 1
    return out


def pair_counts(pos, cell_table, dims, box, cap, r_cut=math.inf):
    """(candidate pairs, pairs with 0 < r < r_cut) of the stencil sweep:
    the work a bound on the kernels' time counts."""
    cand = inside = 0
    for _, t_valid, tp, _, s_valid, sp in _tiles(pos, cell_table, dims, box,
                                                 cap, None):
        d = tp[:, :, None, None, :] - sp[:, None]
        r2 = torch.sum(d * d, dim=-1)
        live = t_valid[:, :, None, None] & s_valid[:, None]
        cand += int(live.sum())
        inside += int((live & (r2 > 0) & (r2 < r_cut * r_cut)).sum())
    return cand, inside


def wall_pair_counts(pos, cell_table, dims, box, cap, r_cut, z0):
    """K7's work at these inputs: (candidate pairs of the real targets,
    pairs inside r_cut, of those the pairs with an image source)."""
    n = pos.shape[0] // 2
    cand = inside = img = 0
    for t_ids, t_valid, tp, s_ids, s_valid, sp in _tiles(
            pos, cell_table, dims, box, cap, None):
        d = tp[:, :, None, None, :] - sp[:, None]
        r2 = torch.sum(d * d, dim=-1)
        live = (t_valid & (t_ids < n))[:, :, None, None] & s_valid[:, None]
        near = live & (r2 > 0) & (r2 < r_cut * r_cut)
        src_img = (pos[s_ids, 2] + z0 < 0.0)[:, None]
        cand += int(live.sum())
        inside += int(near.sum())
        img += int((near & src_img).sum())
    return cand, inside, img
