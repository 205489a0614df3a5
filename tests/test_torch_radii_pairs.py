"""Kernel P2's pair list and list product (ops/cell_kernels.py
near_radii_pairs, near_rpy_radii with pairs=; csrc/near_radii.cu) and
M1's small-configuration instance (csrc/blob_energy.cu
energy_small_kernel), in float64 on the CPU through their plain versions
and numpy emulations of the kernels' orders:

- the plain list holds every pair with 0 < r < r_cut once, with its
  periodic image, against a brute-force minimum-image search and
  pair_counts' count, on random periodic boxes of G = 2 and 3 radius
  groups with a coincident pair and one blob inside another;
- the plain list product equals near_rpy_radii_plain (the walk's plain
  version) at 1e-12, and so does a numpy emulation of the kernel's lane
  order and xor tree; with the self term it matches the JAX package's
  real_matvec;
- a plan refreshed by update_plan gives the near field of a fresh plan at
  the new positions, through the list and through the plain sweep;
- M1's small instance: its pair enumeration (k -> (i, i + s mod n))
  covers each unordered pair once for n = 2, 3, 12, 31, 32, 33 and 128,
  and its lane sums and xor tree give blob_blob_energy_plain at 1e-12.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rigidmultiblobswall_tpu.ops import ewald as jew
from rigidmultiblobswall_tpu_torch.ops import cell_kernels as tck
from rigidmultiblobswall_tpu_torch.ops import cells as tcells
from rigidmultiblobswall_tpu_torch.ops import ewald as tew
from rigidmultiblobswall_tpu_torch.ops import mobility_cuda as tmc
from rigidmultiblobswall_tpu_torch.ops import pair_kernels as tpk

from torch_parity import to_np

ETA = 1.3
BOX = (18.0, 18.0, 18.0)
# tol 1e-3 with a 64 grid cap: 4 near-field cells a side in this box
TOL, GRID_MAX = 1e-3, 64
RADII = {2: (0.25, 0.45), 3: (0.2, 0.3, 0.45)}
LANES = 32


def _params(radii):
    return tew.default_params(max(radii), ETA, BOX, tol=TOL,
                              grid_max=GRID_MAX, radii=radii)


def _scene(n_groups, n=300, seed=0):
    """Positions in and around the box (the plan wraps them), a coincident
    pair, one blob inside another and an overlapping pair, radius groups
    and strengths (n, 6)."""
    rng = np.random.default_rng(seed + n_groups)
    pos = rng.uniform(-1.0, BOX[0] + 1.0, (n, 3))
    pos[3] = pos[2]                      # coincident
    pos[5] = pos[4] + 0.05               # one inside the other
    pos[7] = pos[6] + 0.5                # overlapping
    groups = rng.integers(0, n_groups, n).astype(np.int32)
    return pos, groups, rng.normal(size=(n, 6))


def _plan(n_groups, seed=0):
    pos, groups, f = _scene(n_groups, seed=seed)
    p = _params(RADII[n_groups])
    plan = tew.make_plan(p, torch.tensor(pos), group_of=torch.tensor(groups))
    assert int(plan.n_dropped_cells) == 0 and plan.radii_pairs is None
    return plan, pos, groups, f


def _pairs(plan):
    p = plan.params
    return tck.near_radii_pairs(plan.positions, plan.group_of,
                                plan.cell_table, plan.cell_dims, p.box,
                                p.cell_capacity, r_cut=p.r_cut)


def _walk_rows(plan, f):
    p = plan.params
    return tck.near_rpy_radii_plain(
        plan.positions, f, plan.group_of, plan.cell_table, plan.cell_dims,
        p.box, p.cell_capacity, plan.cheb_radii, plan.radii_edges,
        r_cut=p.r_cut)


def _rel(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("n_groups", [2, 3])
def test_list_holds_every_pair_once_with_its_image(n_groups):
    plan, _, _, _ = _plan(n_groups)
    p = plan.params
    pairs = _pairs(plan)
    tid, sid, wrap = tck.decode_pairs(pairs)
    got = sorted(zip(tid.tolist(), sid.tolist(), map(tuple, wrap.tolist())))
    assert len(got) == len(set(got))
    # brute force: every ordered pair at its minimum image (the box is
    # more than 4 r_cut a side, so the image within r_cut is unique)
    x = to_np(plan.positions)
    L = np.asarray(p.box)
    d = x[:, None, :] - x[None, :, :]
    w = np.round(d / L)
    r = np.linalg.norm(d - w * L, axis=-1)
    ii, jj = np.nonzero((r > 0) & (r < p.r_cut))
    want = sorted((int(i), int(j), tuple(int(v) for v in w[i, j]))
                  for i, j in zip(ii, jj))
    assert got == want
    # the coincident pair is not listed, the pair one inside the other is
    assert (2, 3) not in {(a, b) for a, b, _ in got}
    assert (4, 5) in {(a, b) for a, b, _ in got}
    _, inside = tck.pair_counts(plan.positions, plan.cell_table,
                                plan.cell_dims, p.box, p.cell_capacity,
                                p.r_cut)
    assert inside == len(got) == int(pairs.offsets[-1])
    # offsets: each target's segment, in target order and stencil order
    assert torch.equal(pairs.offsets[1:] - pairs.offsets[:-1],
                       torch.bincount(tid, minlength=x.shape[0]).int())
    assert torch.equal(pairs.rows[:, :3], plan.positions)
    assert torch.equal(pairs.rows[:, 3].long(), plan.group_of.long())


def test_list_keeps_the_stencil_order():
    """Each target's sources come in the 27-cell stencil's order: by
    stencil cell (ops/cells.neighbor_table's order), then by cell slot."""
    plan, _, _, _ = _plan(2)
    p = plan.params
    pairs = _pairs(plan)
    tid, sid, _ = tck.decode_pairs(pairs)
    n = plan.positions.shape[0]
    slot = torch.empty(n, dtype=torch.long)
    slot[plan.cell_table[plan.cell_table < n].long()] = torch.nonzero(
        plan.cell_table < n).flatten()
    cap = p.cell_capacity
    nbr = tcells.neighbor_table(plan.cell_dims)
    cell_of = slot // cap
    rank = torch.empty_like(sid)
    for e in range(sid.shape[0]):
        k = int(torch.nonzero(nbr[cell_of[tid[e]]] == cell_of[sid[e]])[0])
        rank[e] = k * cap + slot[sid[e]] % cap
    for i in range(n):
        seg = rank[int(pairs.offsets[i]):int(pairs.offsets[i + 1])]
        assert torch.all(seg[1:] > seg[:-1])


def test_list_of_a_cell_range():
    """The plain list of a range of target cells holds those cells'
    targets' segments of the whole list and nothing else."""
    plan, _, _, _ = _plan(3)
    p = plan.params
    whole = _pairs(plan)
    part = tck.near_radii_pairs_plain(
        plan.positions, plan.group_of, plan.cell_table, plan.cell_dims,
        p.box, p.cell_capacity, r_cut=p.r_cut, cells_range=(0, 16))
    n = plan.positions.shape[0]
    table = plan.cell_table[:16 * p.cell_capacity]
    mine = torch.zeros(n, dtype=torch.bool)
    mine[table[table < n].long()] = True
    for i in range(n):
        a = part.entries[int(part.offsets[i]):int(part.offsets[i + 1])]
        b = whole.entries[int(whole.offsets[i]):int(whole.offsets[i + 1])]
        assert torch.equal(a, b if mine[i] else b[:0])


@pytest.mark.parametrize("n_rhs", [1, 2])
@pytest.mark.parametrize("n_groups", [2, 3])
def test_list_product_matches_the_walk(n_groups, n_rhs):
    plan, _, _, f = _plan(n_groups)
    p = plan.params
    ft = torch.tensor(f[:, :3 * n_rhs])
    ref = _walk_rows(plan, ft)
    pairs = _pairs(plan)
    got = tck.near_rpy_radii_pairs_plain(pairs, ft, plan.cheb_radii,
                                         plan.radii_edges, p.box,
                                         r_cut=p.r_cut)
    assert _rel(got, ref) < 1e-12
    # the wrapper on CPU tensors takes the list product when given a list
    via = tck.near_rpy_radii(plan.positions, ft, plan.group_of,
                             plan.cell_table, plan.cell_dims, p.box,
                             p.cell_capacity, plan.cheb_radii,
                             plan.radii_edges, r_cut=p.r_cut, pairs=pairs)
    assert torch.equal(via, got)


def _emulated_product(plan, pairs, f):
    """The kernel's order in numpy float64: lane l of target i's warp sums
    the entries offsets[i] + l, + l + 32, ... in turn, then the warp's
    fixed xor tree (offsets 16, 8, 4, 2, 1)."""
    p = plan.params
    tid, sid, wrap = tck.decode_pairs(pairs)
    d = tck._pair_d(plan.positions, tid, sid, wrap, p.box)
    r2 = torch.sum(d * d, dim=-1)
    grp = plan.group_of.long()
    al, be = tck._radii_series(torch.sqrt(r2), grp[tid], grp[sid],
                               plan.cheb_radii, plan.radii_edges.numpy(),
                               p.r_cut)
    n, nc = f.shape
    fs = to_np(torch.as_tensor(f)[sid]).reshape(-1, nc // 3, 3)
    d, al, bf = to_np(d), to_np(al), to_np(be / r2)
    terms = (al[:, None, None] * fs
             + (bf[:, None] * np.einsum("pc,pbc->pb", d, fs))[..., None]
             * d[:, None]).reshape(-1, nc)
    offsets = to_np(pairs.offsets)
    out = np.zeros((n, nc))
    for i in range(n):
        lanes = np.zeros((LANES, nc))
        for e in range(offsets[i], offsets[i + 1]):
            lanes[(e - offsets[i]) % LANES] += terms[e]
        for o in (16, 8, 4, 2, 1):
            lanes = lanes + lanes[np.arange(LANES) ^ o]
        assert np.all(lanes == lanes[0])
        out[i] = lanes[0]
    return out


@pytest.mark.parametrize("n_groups", [2, 3])
def test_emulated_lane_order_matches_the_walk(n_groups):
    plan, _, _, f = _plan(n_groups, seed=4)
    got = _emulated_product(plan, _pairs(plan), f)
    ref = to_np(_walk_rows(plan, torch.tensor(f)))
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-12


@pytest.mark.parametrize("n_groups", [2, 3])
def test_list_product_with_self_term_matches_jax(n_groups):
    """The list product plus the per-particle self term against the JAX
    package's real_matvec (its XLA sweep's radii branch)."""
    plan, pos, groups, f = _plan(n_groups, seed=6)
    p = plan.params
    pj = jew.default_params(max(RADII[n_groups]), ETA, BOX, tol=TOL,
                            grid_max=GRID_MAX, radii=RADII[n_groups])
    plj = jew.make_plan(dataclasses.replace(pj, near_impl="xla"),
                        jnp.asarray(pos), group_of=jnp.asarray(groups))
    ref = np.asarray(jew.real_matvec(plj, jnp.asarray(f)))
    ft = torch.tensor(f)
    rows = tck.near_rpy_radii_pairs_plain(_pairs(plan), ft, plan.cheb_radii,
                                          plan.radii_edges, p.box,
                                          r_cut=p.r_cut)
    got = to_np(rows + plan.self_coeff * ft)
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-12


@pytest.mark.parametrize("n_groups", [2, 3])
def test_refreshed_plan_matches_a_fresh_one(n_groups):
    plan, pos, _, f = _plan(n_groups, seed=8)
    p = plan.params
    moved = pos + np.random.default_rng(9).uniform(-1e-3, 1e-3, pos.shape)
    near = tew.update_plan(plan, torch.tensor(moved))
    assert near.sort_pos is plan.sort_pos            # the refresh branch
    fresh = tew.make_plan(p, torch.tensor(moved), group_of=plan.group_of)
    ft = torch.tensor(f)
    ref = tew.real_matvec(fresh, ft)
    assert _rel(tew.real_matvec(near, ft), ref) < 1e-12
    rows = tck.near_rpy_radii_pairs_plain(_pairs(near), ft, near.cheb_radii,
                                          near.radii_edges, p.box,
                                          r_cut=p.r_cut)
    assert _rel(rows + near.self_coeff * ft, ref) < 1e-12


# ------------------------------------------------------------------ M1


def _small_pairs(n):
    """The small instance's pairs by lane: lane l takes k = l, l + 32, ...
    below n (n - 1) / 2, pair k = (i, i + s mod n), s = k // n + 1, i = k
    mod n (csrc/blob_energy.cu energy_small_kernel)."""
    lanes = [[] for _ in range(LANES)]
    for k in range(n * (n - 1) // 2):
        s, i = k // n + 1, k % n
        lanes[k % LANES].append((i, (i + s) % n))
    return lanes


@pytest.mark.parametrize("n", [2, 3, 12, 31, 32, 33, 128])
def test_m1_small_enumeration_covers_each_pair_once(n):
    seen = [tuple(sorted(pr)) for lane in _small_pairs(n) for pr in lane]
    assert all(i != j for i, j in seen)
    assert sorted(seen) == [(i, j) for i in range(n) for j in range(i + 1, n)]


@pytest.mark.parametrize("coincident", ["zero", "one"])
@pytest.mark.parametrize("box", [(0.0, 0.0, 0.0), (5.0, 5.0, 0.0),
                                 (5.0, 4.0, 3.0)])
@pytest.mark.parametrize("n", [2, 3, 12, 31, 32, 33, 128])
def test_m1_small_lane_sums_match_plain(n, box, coincident):
    rng = np.random.default_rng(n)
    law = dict(repulsion_strength=0.7, debye_length=0.25, blob_radius=0.2)
    r = rng.uniform(0, 5, (3, n, 3))
    r[..., 2] *= 3 / 5
    if n > 5:
        r[:, 5] = r[:, 4]                            # coincident
    eps, b, two_a = 0.7, 0.25, 0.4
    got = np.zeros(r.shape[0])
    for p in range(r.shape[0]):
        rt = torch.tensor(r[p])
        dist = to_np(tpk.min_image(rt[:, None] - rt[None], box).norm(dim=-1))
        lanes = np.zeros(LANES)
        for lane, prs in enumerate(_small_pairs(n)):
            for i, j in prs:
                rr = dist[i, j]
                if rr == 0.0:
                    if coincident == "zero":
                        continue
                    rr = 1.0
                lanes[lane] += (eps * np.exp(-(rr - two_a) / b)
                                if rr > two_a
                                else eps + eps * (two_a - rr) / b)
        for o in (16, 8, 4, 2, 1):
            lanes = lanes + lanes[np.arange(LANES) ^ o]
        got[p] = lanes[0]
    ref = to_np(tmc.blob_blob_energy_plain(
        torch.tensor(r), **law, periodic_length=box, coincident=coincident))
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=0)
