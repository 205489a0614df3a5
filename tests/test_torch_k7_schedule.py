"""Kernel K7's compacted walk (csrc/wall_near.cu), modelled on the CPU.

The model walks the kernel's schedule in float64 on a small random wall
slab (300 blobs, a cluster near the wall among them):
- a block per target cell of the layers that can hold real particles; its
  27-cell stencil in load_stencil's order (csrc/cell_sweep.cuh), staged in
  tiles of the kernel's kSrc sources, once for each chunk of kTgt of the
  cell's targets;
- a warp per target of the chunk in turn (t = warp, warp + 8, ...); the
  candidates 64 a
  step in two halves of 32; the pairs inside r_cut appended in stencil
  order to the target's real ring and to the warp's image ring, which
  carries its entries' targets over from one of the warp's targets to the
  next;
- every full batch of 32 drained with lane k on entry k: a real batch into
  the lane's own sums, an image batch reduced per run of one target; the
  real ring's partial batch after the target's last step, the image ring's
  after the warp's last target; the lanes reduced in the kernel's xor tree.
It reproduces `cell_kernels.wall_near_plain` at 1e-12, evaluates each pair
inside r_cut exactly once (`cell_kernels.wall_pair_counts`), never holds
more entries than a ring's slots, and gets right a target with no image
pair, one with more than 63 inside pairs, an image-only and an empty
stencil cell, in one tile or several, in one chunk of targets or several.
"""

import dataclasses
import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from rigidmultiblobswall_tpu_torch.ops import cell_kernels as ck
from rigidmultiblobswall_tpu_torch.ops import cells
from rigidmultiblobswall_tpu_torch.ops import ewald_wall as ew

CSRC = Path(ck.__file__).resolve().parents[1] / "csrc"
LANES = 32


def _kernel_constants():
    """kSrc (float32, float64) and kRing of csrc/wall_near.cu, and the
    warps a block of csrc/cell_sweep.cuh (the walk's shared pieces)."""
    text = (CSRC / "wall_near.cu").read_text()
    tile = re.search(r"cellk::Walk<T, (\d+), (\d+)>", text)
    ring = re.search(r"constexpr int kRing = (\d+);", text)
    threads = re.search(r"constexpr int kThreads = (\d+);",
                        (CSRC / "cell_sweep.cuh").read_text())
    return (int(tile[1]), int(tile[2])), int(ring[1]), int(threads[1]) // 32


def _target_chunk():
    """kTgt of csrc/cell_sweep.cuh: the targets a block stages at a
    time."""
    text = (CSRC / "cell_sweep.cuh").read_text()
    return int(re.search(r"constexpr int kTgt = (\d+);", text)[1])


TILES, RING, WARPS = _kernel_constants()
CHUNK = _target_chunk()


@functools.lru_cache(maxsize=None)
def _scene(n_rhs):
    """The slab's plan (float64, every cell within capacity) and random
    strengths (N, 3B)."""
    a, L, z_hi, n = 0.3, 12.0, 3.0, 300
    rng = np.random.default_rng(21)
    r = np.empty((n, 3))
    r[:, :2] = rng.uniform(0, L, (n, 2))
    r[:, 2] = rng.uniform(0.3 * a, 1.2 * z_hi, n)
    # a cluster near the wall: targets with many pairs and image pairs
    r[:80] = [6.1, 5.9, 0.7] + rng.uniform(-0.6, 0.6, (80, 3))
    r[81] = r[80]                                    # a coincident pair
    p = dataclasses.replace(ew.default_wall_params(a, 1.0, (L, L), z_hi),
                            cell_capacity=40)
    plan = ew.make_wall_plan(p, torch.as_tensor(r))
    assert int(plan.n_dropped_cells) == 0
    f = torch.as_tensor(rng.normal(size=(n, 3 * n_rhs)))
    return plan, f


def _xor_tree(v):
    """The kernel's fixed xor tree over 32 lanes: (32, C) -> (C,)."""
    lanes = np.arange(LANES)
    for o in (16, 8, 4, 2, 1):
        v = v + v[lanes ^ o]
    return v[0]


def _walk(plan, f, tile, chunk=CHUNK):
    """The kernel's schedule: (out (N, 3B), evaluated (target, source)
    pairs, per-target (real, image) pair counts, per-target real batches,
    the blocks' stencil cells by live kind). The schedule runs first and
    records its batches; the pairs are then evaluated in one call and the
    batches replayed in order."""
    args, kw = ew.near_args(plan)
    table, dims, box, cap, cheb, img_cheb = args
    pos = plan.pos_all.numpy()
    n, n2 = plan.n_real, pos.shape[0]
    z0 = kw.pop("z0")
    ids = table.reshape(-1, cap).long().numpy()
    nbr = cells.neighbor_table(dims).numpy()
    shift = cells.wrap_counts(dims).numpy() * np.asarray(box)
    lo, hi = ew._kept_layers(plan.params, dims)
    rc2 = plan.params.r_cut ** 2
    entries = []            # (target id, source id, source image position)
    events = []             # ("real", target, entries) / ("done", target)
    #                         / ("image", [(target, entry)])
    stencil_cells = []
    for c in range(ids.shape[0]):
        if not lo <= c % dims[2] <= hi:
            continue
        targets = ids[c][ids[c] < n]          # the live prefix's reals
        if targets.size == 0:
            continue
        live = [ids[nb][ids[nb] < n2] for nb in nbr[c]]
        stencil_cells.append([("empty" if s.size == 0 else
                               "image" if bool((s >= n).all()) else "mixed")
                              for s in live])
        s_ids = np.concatenate(live)
        s_pos = np.concatenate([pos[s] + shift[c, k]
                                for k, s in enumerate(live)])
        for t0 in range(0, targets.size, chunk):
            t_chunk = targets[t0:t0 + chunk]
            for s0 in range(0, s_ids.size, tile):
                sid, spos = s_ids[s0:s0 + tile], s_pos[s0:s0 + tile]
                m = sid.size
                image = pos[sid, 2] + z0 < 0

                def entry(tid, j):
                    entries.append((tid, sid[j], spos[j]))
                    return len(entries) - 1

                for warp in range(WARPS):
                    ring_i = []                   # (target id, tile index)
                    for t in range(warp, t_chunk.size, WARPS):
                        tid = int(t_chunk[t])
                        r2 = ((pos[tid] - spos) ** 2).sum(-1)
                        inside = (r2 > 0) & (r2 < rc2)
                        ring_r = []
                        for c0 in range(0, m, 2 * LANES):
                            for half in (c0, c0 + LANES):
                                j = np.arange(half, min(half + LANES, m))
                                ring_r += j[inside[j] & ~image[j]].tolist()
                                ring_i += [(tid, jj) for jj in
                                           j[inside[j] & image[j]].tolist()]
                            assert len(ring_r) <= RING and len(ring_i) <= RING
                            while len(ring_r) >= LANES:
                                events.append(("real", tid, [
                                    entry(tid, j) for j in ring_r[:LANES]]))
                                del ring_r[:LANES]
                            while len(ring_i) >= LANES:
                                events.append(("image", [
                                    (t_, entry(t_, j)) for t_, j in
                                    ring_i[:LANES]]))
                                del ring_i[:LANES]
                        if ring_r:
                            events.append(("real", tid, [entry(tid, j)
                                                         for j in ring_r]))
                        events.append(("done", tid))
                    if ring_i:
                        events.append(("image", [(t_, entry(t_, j))
                                                 for t_, j in ring_i]))
    # every evaluated pair at once
    tgt = np.array([e[0] for e in entries])
    src = np.array([e[1] for e in entries])
    src_pos = np.array([e[2] for e in entries])
    rows = ck.wall_pair_rows(
        torch.as_tensor(pos[tgt] - src_pos), torch.as_tensor(pos[src, 2] + z0),
        torch.as_tensor(pos[tgt, 2] + z0), f[torch.as_tensor(src % n)], cheb,
        img_cheb, **kw).numpy()
    # the batches in order: lane k on entry k
    nc = f.shape[1]
    out = np.zeros((n, nc))
    acc, batches = {}, {}
    for ev in events:
        if ev[0] == "real":
            lanes = np.zeros((LANES, nc))
            lanes[:len(ev[2])] = rows[ev[2]]
            acc[ev[1]] = acc.get(ev[1], 0.0) + lanes
            batches[ev[1]] = batches.get(ev[1], 0) + 1
        elif ev[0] == "done":
            out[ev[1]] += _xor_tree(acc.pop(ev[1], np.zeros((LANES, nc))))
        else:
            t = np.array([t_ for t_, _ in ev[1]])
            assert np.all(np.diff(t) >= 0), "image entries out of order"
            lanes = np.zeros((LANES, nc))
            lanes[:t.size] = rows[[e for _, e in ev[1]]]
            te = np.full(LANES, -1)
            te[:t.size] = t
            for t0 in np.unique(t):
                out[t0] += _xor_tree(np.where((te == t0)[:, None], lanes,
                                              0.0))
    visits = list(zip(tgt.tolist(), src.tolist()))
    pairs = {}
    for tid, sid in visits:
        pairs.setdefault(tid, [0, 0])[1 if sid >= n else 0] += 1
    return out, visits, pairs, batches, stencil_cells


@functools.lru_cache(maxsize=None)
def _model(n_rhs, tile, chunk=CHUNK):
    plan, f = _scene(n_rhs)
    return plan, f, _walk(plan, f, tile, chunk)


@functools.lru_cache(maxsize=None)
def _plain(n_rhs):
    plan, f = _scene(n_rhs)
    args, kw = ew.near_args(plan)
    return ck.wall_near_plain(plan.pos_all, f, *args, **kw).numpy()


def _rel(got, ref, rows=slice(None)):
    return np.abs(got[rows] - ref[rows]).max() / np.abs(ref).max()


# the float64 kernel's tile, and a small one that splits the stencils
TILE_CASES = [TILES[1], 96]


def test_model_reads_the_kernel_constants():
    assert TILES == (1408, 1024) and RING == 128 and WARPS == 8
    assert CHUNK == 128


@pytest.mark.parametrize("tile", TILE_CASES)
@pytest.mark.parametrize("n_rhs", [1, 2])
def test_walk_reproduces_the_plain_sweep(n_rhs, tile):
    _, _, (out, *_) = _model(n_rhs, tile)
    assert _rel(out, _plain(n_rhs)) <= 1e-12


@pytest.mark.parametrize("tile", TILE_CASES)
def test_walk_evaluates_each_pair_once(tile):
    plan, _, (_, visits, _, _, _) = _model(1, tile)
    p = plan.params
    args, _ = ew.near_args(plan)
    cand, inside, img = ck.wall_pair_counts(plan.pos_all, *args[:4],
                                            p.r_cut, p.z0)
    assert len(visits) == len(set(visits)) == inside
    assert sum(1 for _, s in visits if s >= plan.n_real) == img
    assert 0 < img < inside < cand


def _targets_of_case(case, plan, pairs, batches, stencil_cells):
    if case == "no_image_pair":
        return [t for t, (r, i) in pairs.items() if i == 0 and r > 0]
    if case == "more_than_63_pairs":
        return [t for t, (r, i) in pairs.items() if r + i > 63
                and batches.get(t, 0) >= 2]
    kind = {"image_only_cell": "image", "empty_cell": "empty"}[case]
    return [k for k, kinds in enumerate(stencil_cells) if kind in kinds]


@pytest.mark.parametrize("case", ["no_image_pair", "more_than_63_pairs",
                                  "image_only_cell", "empty_cell"])
def test_walk_cases(case):
    """Each case occurs in the scene and its rows match the plain sweep
    (for the stencil cases: every row, the blocks with such a cell
    among them)."""
    plan, _, (out, _, pairs, batches, stencil_cells) = _model(2, TILES[1])
    found = _targets_of_case(case, plan, pairs, batches, stencil_cells)
    assert found, f"the scene has no {case}"
    ref = _plain(2)
    rows = found if case in ("no_image_pair", "more_than_63_pairs") \
        else slice(None)
    assert _rel(out, ref, rows) <= 1e-12


@pytest.mark.parametrize("n_rhs", [1, 2])
def test_walk_in_target_chunks(n_rhs):
    """Chunks of 8 targets (the cluster's cells hold several): each chunk
    walks the stencil again, and the rows still match the plain sweep,
    every pair inside r_cut evaluated once."""
    plan, _, (out, visits, *_) = _model(n_rhs, 96, 8)
    args, _ = ew.near_args(plan)
    ids = plan.cell_table.reshape(-1, args[3]).long()
    assert int((ids < plan.n_real).sum(1).max()) > 8
    assert len(visits) == len(set(visits))
    assert _rel(out, _plain(n_rhs)) <= 1e-12
