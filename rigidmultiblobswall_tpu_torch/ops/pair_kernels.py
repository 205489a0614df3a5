"""Kernel K1: the direct O(N^2) pair product, every coupling.

Counterpart of rigidmultiblobswall_tpu/ops/pair_kernels.py
(`pair_matvec_pallas`): couplings tt, tr, rt, rr and grand, the last the
[[tt, tr], [rt, rr]] product of (F, T/a) in one pass.

`pair_matvec` takes normalized inputs (lengths / a, wall heights already
shifted to max(z, a), vector already damped; the caller applies
1/(8 pi eta a^k) and the target damping), a domain mode of MODES (open,
wall, free_surface: the tt block plus its image reflected in a slip plane
at z = 0, without shift or damping) and B right-hand sides stacked as
b-major columns, vec (Ns, nc B) -> (Nt, nc B), nc = 3 (6 for grand):

- on a CUDA tensor it launches the hand-written kernel of the coupling
  (`csrc/pair_tt.cu`, `csrc/pair_couplings.cu`, both on
  `csrc/pair_blocks.cuh`; the free surface's tt `csrc/pair_fs.cu`;
  float32 or float64) and counts the launch in `LAUNCHES[instance, B]`
  (INSTANCES: the coupling, or "tt_fs"). A square product (q_tgt None:
  the targets are the sources) takes the symmetric sweep, which condenses each
  unordered pair once over `plan_groups`' groups of tiles and applies it
  both ways (counted also in `SYM_LAUNCHES`): tt, rr and grand are
  symmetric, M_ji = M_ij^T, and tr and rt trade places, M_tr(j,i) =
  M_rt(i,j)^T. A two-tensor product takes the sliced sweep, which splits
  the sources into S slices of whole 128-source tiles (`plan_slices`, so
  that the card fills). The open free surface's symmetric sweep holds two
  targets a lane and takes the far form alone on tile pairs whose boxes
  lie apart (csrc/pair_blocks.cuh sym2_kernel).
  Both write partial sums into a workspace that the wrapper
  allocates, and a second kernel adds them in a fixed order;
- on a CPU tensor it runs `pair_plain`, the row-tiled sum of the blocks
  of ops/rpy.py (the JAX package's generic tiled path,
  mobility.py:228-284). Tests and the chip smoke compare the kernel
  against it.

`boxes=(L, offsets)` asks for the pseudo-periodic image boxes (the JAX
package's pairwise_matvec with a periodic_length, XLA there): L the box in
units of a (0 on an open axis), offsets the boxes of `box_offsets`, home
box first. Each pair's d = q_t - q_s goes to its minimum image
(`min_image`), then every box adds the block at d + b L, the self block in
the home box only. On the card both sweeps take their image-box instances
(`pair_{coupling}[_sym]_img_*`), counted in `IMAGE_LAUNCHES[coupling, B,
sweep]` and not in LAUNCHES. The kernels choose their policy from the
list on the host (csrc/pair_blocks.cuh with_boxes): the in-plane one
(PlaneBoxes: the box's 3 x 3 list above the wall or in an open slab, the
boxes off the home box in the far form alone) where it holds, the general
one (ImageBoxes) elsewhere. `plane_far` states the same rule for the
launch plan's occupancy query and the logs.

A rank's share of a product (parallel/mesh.py): `pairs=(p0, p1)` runs a
square product's symmetric sweep over the group pairs [p0, p1) of
`plan_groups`' G (G + 1) / 2 only, into a zeroed workspace, and returns
that share's partial (N, nc B), which the ranks' partials sum to the
product (every unordered pair computed once across the mesh); a
two-tensor product whose targets are the source rows [row0, row0 + Nt)
passes `row0`, which puts the self pair on source row0 + i. Their
launches (a call with pairs= or row0= given, 0 included) count in
`SHARE_LAUNCHES[instance, B, sweep]` beside LAUNCHES;
`pair_share_plain` and `pair_plain(..., row0=)` are the plain versions
over the same group pairs or rows (on the CPU the groups are those of
`PLAIN_SM` SMs, the H100's count).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build, rpy

# components per right-hand side
NCOMP = {"tt": 3, "tr": 3, "rt": 3, "rr": 3, "grand": 6}

# right-hand sides per launch (the kernels' template set): B = 1 for the
# single products, B = 2 for the lockstep solves (tt: det+RFD of
# Slip-Trapz; rr and tr: the rollers' det+stochastic torque solve)
MAX_RHS = {"tt": 2, "tr": 2, "rt": 1, "rr": 2, "grand": 1}

# the domain modes of the pair products: the open domain, the single wall
# (Swan-Brady image system) and the free surface (a slip plane at z = 0,
# tt only)
MODES = ("open", "wall", "free_surface")
# the domain code the C entry points of K1, K3 and P1 take for a mode
MODE_CODE = {"open": 0, "wall": 1, "free_surface": 2}

# the kernel instances of pair_matvec: every coupling, and the free
# surface's tt ("tt_fs", csrc/pair_fs.cu)
INSTANCES = {**MAX_RHS, "tt_fs": 2}

# K1 launches made by `pair_matvec` in this process, by (instance, B),
# and those of them on the symmetric sweep
LAUNCHES = {(c, b): 0 for c in INSTANCES for b in range(1, INSTANCES[c] + 1)}
SYM_LAUNCHES = dict.fromkeys(LAUNCHES, 0)
# launches of the image-box instances, by (coupling, B, sweep), sweep
# "sym" (the square product) or "sliced"
IMAGE_LAUNCHES = {(c, b, s): 0 for (c, b) in LAUNCHES
                  for s in ("sym", "sliced")}
# launches of a rank's share (pairs= or row0= given), by (instance, B,
# sweep), also counted in LAUNCHES or IMAGE_LAUNCHES
SHARE_LAUNCHES = {(c, b, s): 0 for (c, b) in LAUNCHES
                  for s in ("sym", "sliced")}
# the most image boxes a launch takes (csrc/pair_blocks.cuh kMaxBoxes)
MAX_BOXES = 27
# the SMs whose group plan the plain share version follows on the CPU
PLAIN_SM = 132


def launches(coupling):
    """K1 launches of `coupling` in this process, every B."""
    return sum(n for (c, _), n in LAUNCHES.items() if c == coupling)


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


# the in-plane policy's least periodic length in blob radii
# (csrc/pair_blocks.cuh kPlaneFarMin and plane_boxes, which decide): the minimum image keeps |d| <= L/2
# on a periodic axis, so every box off the home box lies at r >= L/2, and
# above 2.02 (1 % over contact, r = 2) no float32 rounding of d + b L
# brings one into the near forms
PLANE_FAR_MIN = 4.04


def plane_far(boxes):
    """Whether the image boxes (L, offsets) of pair_matvec (in units of
    a) take the in-plane far policy: L = (Lx, Ly, 0) with Lx and Ly above
    PLANE_FAR_MIN and the offsets box_offsets' nine boxes in its order.
    Every other list (a box periodic in z, L / a <= PLANE_FAR_MIN, one
    periodic axis, another list or order) takes the general policy."""
    if boxes is None:
        return False
    L, offsets = boxes
    L = tuple(float(x) for x in L)
    return (len(L) == 3 and L[2] == 0.0
            and min(L[0], L[1]) > PLANE_FAR_MIN
            and [tuple(b) for b in offsets] == box_offsets(L))


def image_boxes(periodic_length, a):
    """The `boxes` argument of pair_matvec for a box of periodic_length
    in physical units and blob radius a: (L / a, box_offsets), or None
    without a periodic axis."""
    if not any(float(L) > 0 for L in periodic_length):
        return None
    return (tuple(float(L) / a for L in periodic_length),
            box_offsets(periodic_length))


# sources a tile of the sweep (csrc/pair_blocks.cuh kTile); a slice is a
# run of whole tiles
TILE = 128
# the slice workspace (S, Nt, nc B) stays within this many bytes
WORKSPACE_LIMIT_BYTES = 1 << 26
# waves of blocks the plans aim for: more, smaller blocks balance the SMs
# better (tools/torch_profile_kernels.py on the H100: tt at 49,152 blobs 11.9
# ms in one slice, 10.6 ms at ~1.5 waves, 9.9 ms at 8 and more)
PLAN_WAVES = 8
# resident blocks an SM that the float32 sweeps ask for
# (csrc/pair_blocks.cuh Shape)
MIN_BLOCKS_F32 = 8


@functools.lru_cache(maxsize=512)
def plan_groups(n, n_sm):
    """Tile groups of the symmetric sweep over n blobs: (G,
    tiles_per_group), group g covering tiles [g t, min(n_tiles, (g + 1) t))
    for t = tiles_per_group, every group non-empty.

    The grid is the G (G + 1) / 2 group pairs of the upper triangle. The
    plan takes the fewest tiles a group that keep G at most the g whose
    g (g + 1) / 2 pairs make PLAN_WAVES waves of MIN_BLOCKS_F32 blocks on
    n_sm SMs (130 on 132 SMs), one tile a group when there are fewer tiles.
    The workspace holds G slices of n rows, so it grows like n."""
    tiles = max(-(-n // TILE), 1)
    want = PLAN_WAVES * n_sm * MIN_BLOCKS_F32
    g = math.isqrt(2 * want)
    while g * (g + 1) // 2 < want:
        g += 1
    per = -(-tiles // min(g, tiles))
    return -(-tiles // per), per


def group_pair(p, n_groups):
    """(GA, GB) of upper-triangle pair p in row-major order over n_groups
    groups (csrc/pair_blocks.cuh group_pair)."""
    row, start = 0, 0
    while start + n_groups - row <= p:
        start += n_groups - row
        row += 1
    return row, row + p - start


def group_plan(q):
    """(G, tiles_per_group) of the symmetric sweep over q's rows: the
    card's plan_groups on a CUDA tensor, PLAIN_SM's on the CPU."""
    n_sm = _n_sm(q) if q.device.type == "cuda" else PLAIN_SM
    return plan_groups(q.shape[0], n_sm)


def group_pairs(q):
    """The number of group pairs, G (G + 1) / 2, of the symmetric sweep
    over q's rows (what a mesh shares out)."""
    groups, _ = group_plan(q)
    return groups * (groups + 1) // 2


@functools.lru_cache(maxsize=512)
def plan_slices(n_tgt, n_src, n_sm, blocks_per_sm, row_bytes=0,
                limit=WORKSPACE_LIMIT_BYTES):
    """Source slices of the K1 sweep: (S, tiles_per_slice), slice s
    covering sources [s t 128, min(n_src, (s + 1) t 128)) for
    t = tiles_per_slice, every slice non-empty.

    The grid is ceil(n_tgt / 128) x S blocks, of which the card
    holds n_sm x blocks_per_sm at a time. The plan takes the fewest slices
    of whole tiles that give PLAN_WAVES such waves, at most one tile a
    slice and at most what keeps the workspace, S n_tgt row_bytes, within
    `limit`: S = 1 when the target blocks alone fill the waves."""
    t_blocks = -(-n_tgt // TILE)
    s_tiles = max(-(-n_src // TILE), 1)
    want = -(-PLAN_WAVES * n_sm * blocks_per_sm // t_blocks)
    if row_bytes:
        want = min(want, limit // (n_tgt * row_bytes))
    tiles = -(-s_tiles // max(min(want, s_tiles), 1))
    return -(-s_tiles // tiles), tiles


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _resident_blocks(instance, f64, n_rhs, mode, images=0):
    """Resident blocks an SM holds of a compiled K1 instance (INSTANCES)
    in a domain mode (MODES), from the CUDA occupancy calculator: images 0
    the open instance, 1 the general image boxes', 2 the in-plane one's."""
    blocks = ctypes.c_int(0)
    name = f"pair_{instance}_shape"
    _build.check(name, getattr(_build.library(), name)(
        int(f64), n_rhs, MODE_CODE[mode], int(images),
        ctypes.byref(blocks)))
    if blocks.value < 1:
        raise RuntimeError(f"{name}: the instance does not fit an SM")
    return blocks.value


def _n_sm(t):
    index = t.device.index
    return _sm_count(torch.cuda.current_device() if index is None else index)


def wall_mode(wall):
    """The domain mode of a wall flag: "wall" or "open"."""
    return "wall" if wall else "open"


def instance(coupling, mode):
    """The K1 instance (INSTANCES) of a coupling in a domain mode."""
    return "tt_fs" if _mode(mode) == "free_surface" else coupling


def launch_plan(coupling, q_src, q_tgt, vec, *, mode, boxes=None):
    """(S, tiles_per_slice) of the sliced sweep `pair_matvec` launches on
    these CUDA tensors (of its image-box instance with `boxes`)."""
    images = 0 if boxes is None else 2 if plane_far(boxes) else 1
    n_src, n_tgt = q_src.shape[0], q_tgt.shape[0]
    n_rhs = vec.shape[1] // NCOMP[coupling]
    blocks = _resident_blocks(instance(coupling, mode),
                              vec.dtype == torch.float64, n_rhs, mode,
                              images)
    return plan_slices(n_tgt, n_src, _n_sm(vec), blocks,
                       vec.shape[1] * vec.element_size())


# the plain versions of K1 and K3 (pair_plain, mobility.dense_mobility_tiled)
# keep one (tile, Ns, nc, nc) block within this many bytes, on any device:
# a tile costs ~100 elementwise launches, host-bound on the card, so larger
# tiles make fewer of them
PLAIN_TILE_BYTES = 1 << 30


def _default_row_tile(n_src, n_tgt, itemsize, ncomp=3, budget_bytes=1 << 26):
    """Target rows per tile so one (tile, Ns, nc, nc) block stays within
    the budget (mobility.py:_default_row_tile)."""
    per_row = max(n_src, 1) * ncomp * ncomp * itemsize
    return int(min(max(budget_bytes // per_row, 8), max(n_tgt, 1)))


def _mode(mode):
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}; one of {MODES}")
    return mode


def block(coupling, d, zt, zs, self_mask, mode):
    """3x3 block of tt/tr/rt/rr, or the 6x6 grand block, for d = (r_t -
    r_s)/a and heights zt, zs in units of a, in the domain mode of MODES
    (mobility.py:_block; free_surface has the tt block only)."""
    if coupling == "grand":
        b = {c: block(c, d, zt, zs, self_mask, mode)
             for c in ("tt", "tr", "rt", "rr")}
        return torch.cat([torch.cat([b["tt"], b["tr"]], dim=-1),
                          torch.cat([b["rt"], b["rr"]], dim=-1)], dim=-2)
    if _mode(mode) == "free_surface":
        if coupling != "tt":
            raise NotImplementedError("free_surface only supports 'tt'")
        return rpy.free_surface_tt(d, zt + zs, self_mask)
    wall = mode == "wall"
    dx, dy = d[..., 0], d[..., 1]
    if coupling == "tt":
        m = rpy.rpy_tt(d, self_mask)
        if wall:
            m = m + rpy.wall_tt(dx, dy, zt + zs, zs.expand_as(dx), self_mask)
    elif coupling == "rr":
        m = rpy.rpy_rr(d, self_mask)
        if wall:
            m = m + rpy.wall_rr(dx, dy, zt + zs, zs.expand_as(dx), self_mask)
    elif coupling == "tr":
        m = rpy.rpy_cross(d, self_mask)
        if wall:
            m = m + rpy.wall_trans_torque(dx, dy, zt + zs, zt.expand_as(dx),
                                          self_mask)
    elif coupling == "rt":
        m = rpy.rpy_cross(d, self_mask)
        if wall:
            m = m + rpy.wall_rot_force(dx, dy, zt + zs, zs.expand_as(dx),
                                       self_mask)
    else:
        raise ValueError(f"unknown coupling {coupling!r}")
    return m


def _apply_blocks(coupling, d, zt, zs, self_mask, mode, v):
    """sum_s M(d_ts) v_s, (tile, Ns, ...) geometry and v (Ns, B, nc) ->
    (tile, B, nc); grand as its four 3x3 blocks, (U, W a) = (tt F + tr T,
    rt F + rr T), without forming the 6x6 blocks."""
    if coupling != "grand":
        return torch.einsum("tsab,skb->tka",
                            block(coupling, d, zt, zs, self_mask, mode), v)
    f, t = v[..., :3], v[..., 3:]

    def mul(c, x):
        return torch.einsum("tsab,skb->tka",
                            block(c, d, zt, zs, self_mask, mode), x)

    return torch.cat([mul("tt", f) + mul("tr", t),
                      mul("rt", f) + mul("rr", t)], dim=-1)


def pair_plain(q_src, q_tgt, vec, *, coupling="tt", mode, self_interaction,
               boxes=None, row0=0):
    """Plain PyTorch K1: out[i] = sum_j M(q_tgt[i], q_src[j]) vec[j] for
    each right-hand side, computed from materialized (tile, Ns, nc, nc)
    blocks in the domain mode of MODES. Target row i pairs with source row
    row0 + i as `self` when self_interaction is set (the targets are
    sources [row0, row0 + Nt)). With boxes = (L, offsets) the sum runs
    over the image boxes as the JAX package's tile_fn does: d to its
    minimum image, then the block of every box at d + b L, the self mask
    in the home box only."""
    _mode(mode)
    nc = NCOMP[coupling]
    n_src, n_tgt = q_src.shape[0], q_tgt.shape[0]
    n_rhs = vec.shape[1] // nc
    v = vec.reshape(n_src, n_rhs, nc)
    row_tile = _default_row_tile(n_src, n_tgt, q_src.element_size(), nc,
                                 PLAIN_TILE_BYTES)
    src_ids = torch.arange(n_src, device=q_src.device)
    zs = q_src[:, 2][None, :]
    L, offsets = boxes if boxes is not None else ((0.0, 0.0, 0.0),
                                                  [(0, 0, 0)])
    Lvec = torch.tensor(L, dtype=q_src.dtype, device=q_src.device)
    out = torch.empty((n_tgt, nc * n_rhs), dtype=q_src.dtype,
                      device=q_src.device)
    for i0 in range(0, n_tgt, row_tile):
        qt = q_tgt[i0:i0 + row_tile]
        rows = torch.arange(row0 + i0, row0 + i0 + qt.shape[0],
                            device=q_src.device)
        d0 = qt[:, None, :] - q_src[None, :, :]
        if boxes is not None:
            d0 = min_image(d0, L)
        acc = None
        for box in offsets:
            home = box == (0, 0, 0)
            self_mask = ((rows[:, None] == src_ids[None, :])
                         & (self_interaction and home))
            d = d0 if home else d0 + torch.tensor(
                box, dtype=q_src.dtype, device=q_src.device) * Lvec
            part = _apply_blocks(coupling, d, qt[:, 2][:, None], zs,
                                 self_mask, mode, v)
            acc = part if acc is None else acc + part
        out[i0:i0 + qt.shape[0]] = acc.reshape(qt.shape[0], nc * n_rhs)
    return out


def pair_share_plain(q, vec, *, coupling="tt", mode, self_interaction,
                     boxes=None, pairs):
    """Plain PyTorch K1 over a rank's share of the symmetric sweep: the
    partial (N, nc B) of the group pairs [p0, p1) of group_plan's groups
    (the targets of group GA against the sources of group GB, and, off the
    diagonal, GB's against GA's), each unordered pair once. Each target
    group takes one plain sweep against every source, the rows of the
    groups it does not pair with in the share zeroed in the vector (and
    the self pairs only when its diagonal pair is in the share)."""
    n = q.shape[0]
    groups, per = group_plan(q)
    out = torch.zeros((n, vec.shape[1]), dtype=q.dtype, device=q.device)
    rows = [slice(g * per * TILE, min(n, (g + 1) * per * TILE))
            for g in range(groups)]
    partners = {}
    for p in range(*pairs):
        ga, gb = group_pair(p, groups)
        partners.setdefault(ga, set()).add(gb)
        partners.setdefault(gb, set()).add(ga)
    for g, src in partners.items():
        keep = torch.zeros(n, dtype=vec.dtype, device=vec.device)
        for h in src:
            keep[rows[h]] = 1.0
        a = rows[g]
        out[a] = pair_plain(q, q[a], vec * keep[:, None], coupling=coupling,
                            mode=mode, boxes=boxes, row0=a.start,
                            self_interaction=self_interaction and g in src)
    return out


def pair_matvec(q_src, q_tgt, vec, *, coupling="tt", mode,
                self_interaction, boxes=None, pairs=None, row0=None):
    """K1 wrapper: the CUDA kernel of `coupling` in the domain `mode`
    (MODES; free_surface: the tt coupling's free-surface instance) for
    CUDA tensors, `pair_plain` for CPU tensors. q_src (Ns,3), q_tgt
    (Nt,3) or None for the square product (the targets are the sources),
    vec (Ns,nc B) -> (Nt,nc B); boxes (L, offsets) or None (the module's
    docstring). On the card a square product takes the symmetric sweep
    over `plan_groups`' groups, a two-tensor product the sliced sweep over
    `launch_plan`'s slices, each in its image-box instance with boxes.
    A rank's share (the module's docstring): pairs=(p0, p1), a range of
    group_pairs(q_src), for a square product, the partial of those group
    pairs; row0 (an int, 0 included) for a two-tensor product whose
    targets are source rows [row0, row0 + Nt)."""
    if coupling not in NCOMP:
        raise ValueError(f"unknown coupling {coupling!r}")
    if _mode(mode) == "free_surface" and coupling != "tt":
        raise NotImplementedError("free_surface only supports 'tt'")
    square = q_tgt is None
    if square:
        q_tgt = q_src
    share = pairs is not None or row0 is not None
    if (pairs is not None and not square) or (row0 is not None and square):
        raise ValueError("pair_matvec: pairs= shares a square product, "
                         "row0 a two-tensor product")
    if pairs is not None:
        pairs = (int(pairs[0]), int(pairs[1]))
        if not 0 <= pairs[0] <= pairs[1] <= group_pairs(q_src):
            raise ValueError(f"pair_matvec: group pairs {pairs} outside "
                             f"[0, {group_pairs(q_src)}]")
    if q_src.device.type == "cpu":
        if pairs is not None:
            return pair_share_plain(q_src, vec, coupling=coupling, mode=mode,
                                    self_interaction=self_interaction,
                                    boxes=boxes, pairs=pairs)
        return pair_plain(q_src, q_tgt, vec, coupling=coupling, mode=mode,
                          self_interaction=self_interaction, boxes=boxes,
                          row0=row0 or 0)
    _check(coupling, q_src, q_tgt, vec, boxes)
    row0 = row0 or 0
    if row0 < 0 or (self_interaction and row0 + q_tgt.shape[0]
                    > q_src.shape[0]):
        raise ValueError(f"pair_matvec: row0 {row0} with {q_tgt.shape[0]} "
                         f"targets of {q_src.shape[0]} sources")
    nc = NCOMP[coupling]
    n_src, n_tgt = q_src.shape[0], q_tgt.shape[0]
    n_rhs = vec.shape[1] // nc
    out = torch.empty((n_tgt, nc * n_rhs), dtype=vec.dtype,
                      device=vec.device)
    if n_tgt == 0 or n_src == 0:
        return out.zero_()
    inst = instance(coupling, mode)
    code = MODE_CODE[mode]
    suffix = "f32" if vec.dtype == torch.float32 else "f64"
    img = "" if boxes is None else "_img"
    stream = torch.cuda.current_stream(vec.device).cuda_stream
    if square:
        name = f"pair_{inst}_sym{img}_{suffix}"
        groups, per = plan_groups(n_src, _n_sm(vec))
        total = groups * (groups + 1) // 2
        p0, p1 = (0, total) if pairs is None else pairs
        # a share leaves the slices of other ranks' pairs unwritten: they
        # must read zero in the slice sum
        alloc = torch.empty if (p0, p1) == (0, total) else torch.zeros
        ws = alloc((groups, n_src, nc * n_rhs), dtype=vec.dtype,
                   device=vec.device)
        args = (q_src.data_ptr(), vec.data_ptr(), out.data_ptr(),
                ws.data_ptr(), n_src, n_rhs, groups, per, code,
                int(bool(self_interaction)), p0, p1 - p0)
    else:
        name = f"pair_{inst}{img}_{suffix}"
        n_slices, tiles = launch_plan(coupling, q_src, q_tgt, vec, mode=mode,
                                      boxes=boxes)
        ws = (torch.empty((n_slices, n_tgt, nc * n_rhs), dtype=vec.dtype,
                          device=vec.device) if n_slices > 1 else None)
        args = (q_src.data_ptr(), q_tgt.data_ptr(), vec.data_ptr(),
                out.data_ptr(), None if ws is None else ws.data_ptr(), n_src,
                n_tgt, n_rhs, n_slices, tiles, code,
                int(bool(self_interaction)), int(row0))
    if boxes is not None:
        args += _box_args(boxes)
    err = getattr(_build.library(), name)(*args, stream)
    _build.check(name, err)
    if share:
        SHARE_LAUNCHES[inst, n_rhs, "sym" if square else "sliced"] += 1
    if boxes is not None:
        IMAGE_LAUNCHES[inst, n_rhs, "sym" if square else "sliced"] += 1
        return out
    LAUNCHES[inst, n_rhs] += 1
    if square:
        SYM_LAUNCHES[inst, n_rhs] += 1
    return out


def _box_args(boxes):
    """The image boxes' C arguments: L (3,), the count and the offsets
    b L, as host double arrays (the kernels choose their policy from
    them, as plane_far does)."""
    L, offsets = boxes
    off = [b * x for box in offsets for b, x in zip(box, L)]
    return ((ctypes.c_double * 3)(*L), len(offsets),
            (ctypes.c_double * len(off))(*off))


def _check(coupling, q_src, q_tgt, vec, boxes=None):
    what = f"pair_matvec({coupling})"
    if boxes is not None:
        L, offsets = boxes
        if (len(L) != 3 or not any(float(x) > 0 for x in L)
                or not 1 <= len(offsets) <= MAX_BOXES
                or tuple(offsets[0]) != (0, 0, 0)):
            raise ValueError(f"{what}: image boxes L {tuple(L)} with "
                             f"{len(offsets)} offsets; expected a periodic "
                             f"axis and 1 to {MAX_BOXES} boxes, the home box "
                             "first")
    if q_src.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q_src.device}")
    dtype = vec.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{what}: dtype {dtype} (float32/float64 only)")
    for name, t in (("q_src", q_src), ("q_tgt", q_tgt), ("vec", vec)):
        if t.device != vec.device or t.dtype != dtype:
            raise ValueError(f"{what}: {name} is {t.dtype} on {t.device}, "
                             f"expected {dtype} on {vec.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
    nc = NCOMP[coupling]
    if (q_src.ndim != 2 or q_src.shape[1] != 3 or q_tgt.ndim != 2
            or q_tgt.shape[1] != 3 or vec.ndim != 2
            or vec.shape[0] != q_src.shape[0] or vec.shape[1] % nc
            or vec.shape[1] == 0):
        raise ValueError(f"{what}: shapes q_src {tuple(q_src.shape)}, "
                         f"q_tgt {tuple(q_tgt.shape)}, vec "
                         f"{tuple(vec.shape)}; expected (Ns,3), (Nt,3), "
                         f"(Ns,{nc}B)")
    if vec.shape[1] // nc > MAX_RHS[coupling]:
        raise ValueError(f"{what}: {vec.shape[1] // nc} right-hand sides; "
                         f"the kernel takes 1 to {MAX_RHS[coupling]}")
    if max(q_src.shape[0], q_tgt.shape[0]) * vec.shape[1] >= 2 ** 31:
        raise ValueError(f"{what}: too many rows for 32-bit indexing")
