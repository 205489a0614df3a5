"""Kernel K6's compacted walk (csrc/near_rpy.cu) and kernel K5's staged
schedule (csrc/nl_forces.cu), modelled on the CPU in float64.

K6, on small random periodic boxes (a dense cluster, empty cells):
- a block per target cell; its 27-cell stencil in load_stencil's order
  (csrc/cell_sweep.cuh), staged in tiles of the kernel's kSrc sources,
  once for each chunk of kTgt of the cell's targets;
- the block's warps take its targets in turn (t = warp, warp + warps,
  ...); the candidates kStep a step in quarters of 32; the pairs inside
  r_cut appended in stencil order to the warp's ring (kRing of
  near_rpy.cu), which runs on across its targets;
- every full batch of 32 evaluated with lane k on entry k, the partial
  batch after the warp's last target of the tile; each lane adds its entry
  into its sums of the current target's run, and a run that moves on to
  the next target (or the tile's end) is reduced in the kernel's xor tree
  and added into the target's row.
K5, on the same boxes and a wall slab: a block per target cell; the
stencil staged once a tile and padded to whole warp-steps with far
sources; the targets in pairs (2p, 2p + 1), pair p to warp p mod warps;
lane l sums the tile's sources l, l + 32, ... for both targets of a pair
with K2's folded law, then the xor tree.
The models reproduce `cell_kernels.near_rpy_plain` and `nl_forces_plain`
at 1e-12, evaluate each pair inside r_cut (K6) or each candidate pair
(K5) exactly once, never hold more entries than a ring's slots, and get
right empty cells, a cell with more targets than one chunk, a stencil
longer than one tile and a grid of exactly 4 cells a side.
"""

import functools
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from rigidmultiblobswall_tpu_torch.ops import cell_kernels as ck
from rigidmultiblobswall_tpu_torch.ops import cells

CSRC = Path(ck.__file__).resolve().parents[1] / "csrc"
LANES = 32
FAR = 1e18          # csrc/nl_forces.cu far_coord


def _tiles(source):
    """kSrc (float32, float64) of a kernel's source."""
    text = (CSRC / source).read_text()
    m = re.search(r"cellk::Walk<T, (\d+), (\d+)>", text)
    return int(m[1]), int(m[2])


def _walk_constant(name, source="cell_sweep.cuh"):
    text = (CSRC / source).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text)[1])


TILES6, TILES5 = _tiles("near_rpy.cu"), _tiles("nl_forces.cu")
STEP6, RING6 = (_walk_constant(c, "near_rpy.cu") for c in ("kStep", "kRing"))
CHUNK = _walk_constant("kTgt")
WARPS = _walk_constant("kThreads") // LANES     # a block's warps


# ---------------------------------------------------------------- scenes

A, CAP, R_CUT, K = 0.3, 48, 1.8, 23
LAW = dict(eps_over_b=0.2 / 0.25, inv_b=1 / 0.25, two_a=2 * A)
# target chunks smaller than the 40-target cell of the "six" box
SMALL_CHUNK = 16


@functools.lru_cache(maxsize=None)
def _box(kind):
    """(pos, table, dims, box, cheb, r_cut) of a random periodic box,
    float64: "six" 6 cells a side (600 blobs, 40 of them packed into one
    cell, a coincident pair, empty cells), "four" exactly 4 cells a side;
    cheb a random decaying (2, 2, K) table (odd K: the kernels pad it)."""
    L = {"six": 12.0, "four": 7.3}[kind]
    dims = tuple(int(L // R_CUT) for _ in range(3))
    rng = np.random.default_rng(31)
    if kind == "six":
        r = rng.uniform(0, L, (600, 3))
        r[:40] = 4.0 + rng.uniform(0.05, 1.95, (40, 3))     # one cell
        r[:, 0] = np.where(r[:, 0] > 9.0, r[:, 0] - 3.0, r[:, 0])  # voids
    else:
        r = rng.uniform(0, L, (300, 3))
    r[11] = r[10]                                          # coincident
    pos = torch.as_tensor(r)
    table, _, _, dropped = cells.cell_bin(pos, (L, L, L), dims, CAP)
    assert int(dropped) == 0
    cheb = torch.as_tensor(rng.normal(size=(2, 2, K)) * 0.7 ** np.arange(K))
    return pos, table, dims, (L, L, L), cheb, R_CUT


def _forces(n, n_rhs):
    return torch.as_tensor(np.random.default_rng(5).normal(
        size=(n, 3 * n_rhs)))


def _layout(pos, table, dims, box, cap):
    """Per target cell: its targets' ids and its stencil's source ids and
    image positions, in load_stencil's order."""
    n = pos.shape[0]
    ids = table.reshape(-1, cap).long().numpy()
    nbr = cells.neighbor_table(dims).numpy()
    shift = cells.wrap_counts(dims).numpy() * np.asarray(box, float)
    p = pos.numpy()
    for c in range(ids.shape[0]):
        targets = ids[c][ids[c] < n]
        live = [ids[nb][ids[nb] < n] for nb in nbr[c]]
        yield c, targets, live, np.concatenate(live), np.concatenate(
            [p[s] + shift[c, k] for k, s in enumerate(live)])


def _xor_tree(v):
    """The kernels' fixed xor tree over 32 lanes: (32, C) -> (C,)."""
    lanes = np.arange(LANES)
    for o in (16, 8, 4, 2, 1):
        v = v + v[lanes ^ o]
    return v[0]


# ---------------------------------------------------------------- K6


def _near_pair_rows(dv, fs, cheb, two_a, r_cut):
    """K6's pairs one by one: displacements dv (M, 3) = target - source,
    source strengths fs (M, 3B) -> (M, 3B) contributions."""
    r2 = torch.sum(dv * dv, dim=-1)
    r = torch.sqrt(r2)
    mids = (0.5 * two_a, 0.5 * (two_a + r_cut))
    halfs = (0.5 * two_a, 0.5 * (r_cut - two_a))
    t0 = torch.clamp((r - mids[0]) / halfs[0], -1.0, 1.0)
    t1 = torch.clamp((r - mids[1]) / halfs[1], -1.0, 1.0)
    near = r < two_a
    al = torch.where(near, ck._clenshaw(cheb[0, 0], t0),
                     ck._clenshaw(cheb[1, 0], t1))
    bfac = torch.where(near, ck._clenshaw(cheb[0, 1], t0),
                       ck._clenshaw(cheb[1, 1], t1)) / r2
    f3 = fs.reshape(fs.shape[0], -1, 3)
    ddotf = torch.sum(dv[:, None, :] * f3, dim=-1)
    rows = al[:, None, None] * f3 + (bfac[:, None] * ddotf)[..., None] \
        * dv[:, None, :]
    return rows.reshape(fs.shape)


def _walk6(kind, n_rhs, tile, chunk):
    """K6's schedule: (out (N, 3B), evaluated (target, source) pairs, the
    batch sizes, the cells by kind). The schedule runs first and records
    its batches; the pairs are then evaluated in one call and the batches
    replayed in order."""
    pos, table, dims, box, cheb, r_cut = _box(kind)
    f = _forces(pos.shape[0], n_rhs)
    p = pos.numpy()
    rc2 = r_cut ** 2
    events, seen = [], set()    # ("batch", [(target, source, image)])
    #                             / ("end", None): a warp's tile is done
    for c, targets, live, s_ids, s_pos in _layout(pos, table, dims, box,
                                                  CAP):
        if targets.size == 0:
            seen.add("empty target cell")
            continue
        if any(s.size == 0 for s in live):
            seen.add("empty stencil cell")
        if targets.size > chunk:
            seen.add("beyond one chunk")
        if s_ids.size > tile:
            seen.add("longer than one tile")
        for t0 in range(0, targets.size, chunk):
            t_chunk = targets[t0:t0 + chunk]
            for s0 in range(0, s_ids.size, tile):
                sid, spos = s_ids[s0:s0 + tile], s_pos[s0:s0 + tile]
                m = sid.size

                def batch(ring):
                    return ("batch", [(t_, int(sid[j]), spos[j])
                                      for t_, j in ring])

                for warp in range(WARPS):
                    ring = []                     # (target id, tile index)
                    for t in range(warp, t_chunk.size, WARPS):
                        tid = int(t_chunk[t])
                        r2 = ((p[tid] - spos) ** 2).sum(-1)
                        inside = (r2 > 0) & (r2 < rc2)
                        for c0 in range(0, m, STEP6):
                            for q in range(c0, c0 + STEP6, LANES):
                                j = np.arange(q, min(q + LANES, m))
                                ring += [(tid, jj) for jj in
                                         j[inside[j]].tolist()]
                            assert len(ring) <= RING6
                            while len(ring) >= LANES:
                                events.append(batch(ring[:LANES]))
                                del ring[:LANES]
                    if ring:
                        events.append(batch(ring))
                    events.append(("end", None))
    # every evaluated pair at once
    entries = [e for kind_, b in events if kind_ == "batch" for e in b]
    tgt = np.array([e[0] for e in entries])
    src = np.array([e[1] for e in entries])
    dv = torch.as_tensor(p[tgt] - np.array([e[2] for e in entries]))
    rows = _near_pair_rows(dv, f[torch.as_tensor(src)], cheb, 2 * A,
                           r_cut).numpy()
    # the batches in order: lane k on entry k, runs of one target
    nc = f.shape[1]
    out = np.zeros((pos.shape[0], nc))
    acc, cur, sizes, first = np.zeros((LANES, nc)), None, [], 0
    for kind_, b in events:
        if kind_ == "end":
            if cur is not None:
                out[cur] += _xor_tree(acc)
            acc, cur = np.zeros((LANES, nc)), None
            continue
        t = tgt[first:first + len(b)]
        sizes.append(t.size)
        u = np.zeros((LANES, nc))
        u[:t.size] = rows[first:first + len(b)]
        first += len(b)
        te = np.full(LANES, -1)
        te[:t.size] = t
        for t1 in t[np.sort(np.unique(t, return_index=True)[1])]:
            if t1 != cur:
                if cur is not None:
                    out[cur] += _xor_tree(acc)
                acc, cur = np.zeros((LANES, nc)), t1
            mine = te == t1
            acc[mine] += u[mine]
    return out, list(zip(tgt.tolist(), src.tolist())), sizes, seen, dv


@functools.lru_cache(maxsize=None)
def _model6(kind, n_rhs, tile=None, chunk=CHUNK):
    return _walk6(kind, n_rhs, tile or TILES6[1], chunk)


@functools.lru_cache(maxsize=None)
def _plain6(kind, n_rhs):
    pos, table, dims, box, cheb, r_cut = _box(kind)
    return ck.near_rpy_plain(pos, _forces(pos.shape[0], n_rhs), table, dims,
                             box, CAP, cheb, two_a=2 * A,
                             r_cut=r_cut).numpy()


def _rel(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


def test_model_reads_the_kernel_constants():
    assert TILES6 == (768, 512) and TILES5 == (2048, 1024)
    assert STEP6 == 128 and RING6 == 256 and RING6 >= STEP6 + LANES - 1
    assert all(t % STEP6 == 0 for t in TILES6)
    assert CHUNK == 128 and WARPS == 8


# (scene, staged tile, target chunk): the float64 tile and the real chunk;
# tiles that split the stencils; chunks of 8 and 16 targets
K6_CASES = [("six", None, CHUNK), ("four", None, CHUNK), ("six", 48, CHUNK),
            ("six", None, 8), ("six", 96, SMALL_CHUNK)]


@pytest.mark.parametrize("kind, tile, chunk", K6_CASES)
@pytest.mark.parametrize("n_rhs", [1, 2])
def test_k6_walk_reproduces_the_plain_sweep(n_rhs, kind, tile, chunk):
    out, *_ = _model6(kind, n_rhs, tile, chunk)
    assert _rel(out, _plain6(kind, n_rhs)) <= 1e-12


@pytest.mark.parametrize("kind", ["six", "four"])
def test_k6_walk_evaluates_each_inside_pair_once(kind):
    """Every pair inside r_cut once, none outside it, and every batch full
    but the last of a warp's tile."""
    pos, table, dims, box, _, r_cut = _box(kind)
    _, visits, sizes, _, dv = _model6(kind, 1)
    cand, inside = ck.pair_counts(pos, table, dims, box, CAP, r_cut)
    assert len(visits) == len(set(visits)) == inside
    r = torch.linalg.norm(dv, dim=1)
    assert bool(((r > 0) & (r < r_cut)).all()) and 0 < inside < cand
    assert sum(s < LANES for s in sizes) <= len(sizes) - sum(
        s == LANES for s in sizes) and max(sizes) == LANES


@pytest.mark.parametrize("case, tile, chunk", [
    ("empty target cell", None, CHUNK), ("empty stencil cell", None, CHUNK),
    ("beyond one chunk", None, SMALL_CHUNK),
    ("longer than one tile", 96, CHUNK)])
def test_k6_walk_cases(case, tile, chunk):
    """Each case occurs in the scene and the rows match the plain sweep."""
    out, _, _, seen, _ = _model6("six", 2, tile, chunk)
    assert case in seen
    assert _rel(out, _plain6("six", 2)) <= 1e-12


# ---------------------------------------------------------------- K5


def _law_mag(r2):
    """K2's folded law as the wrapper hands it to K5 (float64)."""
    c = math.log2(math.e) * LAW["inv_b"]
    r = np.sqrt(r2)
    with np.errstate(divide="ignore", invalid="ignore"):
        mag = LAW["eps_over_b"] / r * np.exp2(
            np.minimum(LAW["two_a"] * c - c * r, 0.0))
    return np.where(r2 > 0, mag, 0.0)


@functools.lru_cache(maxsize=None)
def _slab():
    """The wall-slab forces' layout of a random 12 x 12 slab (z clipped
    below an empty guard layer)."""
    from rigidmultiblobswall_tpu_torch.ops import forces

    rng = np.random.default_rng(8)
    r = np.empty((500, 3))
    r[:, :2] = rng.uniform(0, 12.0, (500, 2))
    r[:, 2] = rng.uniform(0.2, 3.5, 500)
    pos, dims, box, table, dropped = forces._force_cells(
        torch.as_tensor(r), (12.0, 12.0, 0.0), 2 * A + 30 * 0.05, 16, CAP,
        3.0)
    assert int(dropped) == 0 and dims[2] == 3
    return pos, table, dims, box


def _scene5(kind):
    if kind == "slab":
        return _slab()
    pos, table, dims, box, _, _ = _box(kind)
    return pos, table, dims, box


def _walk5(kind, tile, chunk):
    """K5's schedule: (out (N, 3), visited (target, source) pairs, cells by
    kind)."""
    pos, table, dims, box = _scene5(kind)
    p = pos.numpy()
    out = np.zeros_like(p)
    visits, seen = [], set()
    for c, targets, live, s_ids, s_pos in _layout(pos, table, dims, box,
                                                  CAP):
        if targets.size > chunk:
            seen.add("beyond one chunk")
        if s_ids.size > tile:
            seen.add("longer than one tile")
        if targets.size % 2:
            seen.add("odd targets")
        for t0 in range(0, targets.size, chunk):
            t_chunk = targets[t0:t0 + chunk]
            nt = t_chunk.size
            for s0 in range(0, s_ids.size, tile):
                sid, spos = s_ids[s0:s0 + tile], s_pos[s0:s0 + tile]
                mp = -(-sid.size // LANES) * LANES
                src = np.full((mp, 3), FAR)
                src[:sid.size] = spos
                for warp in range(WARPS):
                    for pr in range(warp, -(-nt // 2), WARPS):
                        for t in (2 * pr, 2 * pr + 1):
                            tp = p[t_chunk[t]] if t < nt else np.full(3, FAR)
                            d = tp - src                     # (mp, 3)
                            contrib = _law_mag((d * d).sum(1))[:, None] * d
                            lanes = np.zeros((LANES, 3))
                            for step in range(mp // LANES):
                                lanes += contrib[step * LANES:
                                                 (step + 1) * LANES]
                            if t < nt:
                                out[t_chunk[t]] += _xor_tree(lanes)
                                visits += [(int(t_chunk[t]), int(s))
                                           for s in sid]
    return out, visits, seen


@functools.lru_cache(maxsize=None)
def _model5(kind, tile=None, chunk=CHUNK):
    return _walk5(kind, tile or TILES5[1], chunk)


@functools.lru_cache(maxsize=None)
def _plain5(kind):
    pos, table, dims, box = _scene5(kind)
    return ck.nl_forces_plain(pos, table, dims, box, CAP, **LAW).numpy()


# (scene, staged tile, target chunk): the float64 tile and the real chunk;
# tiles that split the stencils; chunks of 8 and 16 targets
K5_CASES = [("six", None, CHUNK), ("four", None, CHUNK),
            ("slab", None, CHUNK), ("six", 64, CHUNK), ("six", None, 8),
            ("slab", 96, 16)]


@pytest.mark.parametrize("kind, tile, chunk", K5_CASES)
def test_k5_schedule_reproduces_the_plain_forces(kind, tile, chunk):
    out, *_ = _model5(kind, tile, chunk)
    assert _rel(out, _plain5(kind)) <= 1e-12


@pytest.mark.parametrize("kind", ["six", "slab", "four"])
def test_k5_schedule_visits_each_candidate_once(kind):
    """Every (target, source) pair of the stencil once."""
    pos, table, dims, box = _scene5(kind)
    _, visits, _ = _model5(kind)
    cand, _ = ck.pair_counts(pos, table, dims, box, CAP)
    assert len(visits) == len(set(visits)) == cand


@pytest.mark.parametrize("case, tile, chunk", [
    ("beyond one chunk", None, SMALL_CHUNK),
    ("longer than one tile", 64, CHUNK), ("odd targets", None, CHUNK)])
def test_k5_schedule_cases(case, tile, chunk):
    out, _, seen = _model5("six", tile, chunk)
    assert case in seen
    assert _rel(out, _plain5("six")) <= 1e-12
