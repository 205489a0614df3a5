"""Kernel K1's pair algebra and launch plan, on the CPU.

- The division-free wall coefficients of csrc/pair_blocks.cuh
  (`tt_condense`, `rr_condense`, and `cross_shared` with `cross_block`),
  written out here in float64 numpy as the kernel forms them, expanded to
  3x3 blocks the way `diag_apply` and `cross_apply` apply them, against
  the JAX package's `wall_tt`, `wall_rr`, `wall_trans_torque` and
  `wall_rot_force` (rigidmultiblobswall_tpu/ops/rpy.py) and the port's
  copies, at random geometries, a source far below its target, both blobs
  on the wall after the height shift, R -> 2 and self pairs; 1e-13 of
  each block's largest entry.
- The symmetric sweep's premise on those formulas (the tt and rr blocks
  of (i, j) are the transposes of (j, i)'s, tr's of (i, j) that of rt's
  of (j, i), and the transposed applies of sym_kernel's source share give
  the (j, i) blocks); its schedule of group pairs, written out here as the
  kernel walks it, visits every unordered tile pair once, gives every
  workspace entry one owner and sums to M v, for a symmetric M and for the
  cross products, whose source share comes from the other block's
  transpose; the group plan fills the card with a workspace that grows
  like N; the square call (q_tgt None) is the same product as the call
  with two tensors.
- The slice plan of ops/pair_kernels.py: every source in exactly one
  slice of whole 128-source tiles, one slice up to 128 sources or when
  the target blocks alone fill the plan's waves, and the workspace within
  its byte limit.
- Kernel K2 (csrc/blob_forces.cu) on the same symmetric sweep: its walk,
  written out here as the kernel takes it (group pairs, the directed sweep
  of a diagonal tile, the warp rotation of sources and their sums off the
  diagonal, blobs past N at the far coordinate, the slice sum), on ragged
  N with a coincident pair and pairs inside 2a, against the plain
  `blob_blob_forces_plain` at 1e-12; and the folded law 2^min(c 2a - c r,
  0) / r against the two-branch law below, at and beyond 2a.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rigidmultiblobswall_tpu.ops import rpy as jrpy
from rigidmultiblobswall_tpu_torch.ops import mobility as tmob
from rigidmultiblobswall_tpu_torch.ops import mobility_cuda as mc
from rigidmultiblobswall_tpu_torch.ops import pair_kernels as pk
from rigidmultiblobswall_tpu_torch.ops import rpy as trpy


def _tt_wall(dx, dy, zt, zs):
    """tt_condense's wall terms (core off), as (A, S, P, Q, mzz)."""
    Rz = zt + zs
    W = 1.0 / np.sqrt(dx * dx + dy * dy + Rz * Rz)
    u = W * W
    Ru = Rz * u
    e = Ru * Rz
    k = zs * zt * u
    s = zs * u
    s2 = s + s
    n1 = (u * ((e * (10.0 / 3.0) - 2.0 / 3.0) * u + (2.0 / 3.0 - 2.0 * e))
          + (2.0 * k + 1.0))
    n2 = (1.0 - 6.0 * k) - u * ((e * (70.0 / 3.0) - 10.0 / 3.0) * u
                                + (2.0 - 10.0 * e))
    f3 = Ru * (-12.0 * k + u * ((40.0 / 3.0 - e * (140.0 / 3.0)) * u
                                + (e * 20.0 - 4.0))) + s2
    f4 = (Ru * u) * (-20.0 / 3.0 * u) + s2
    n5 = (zs * s) * 4.0 + u * ((8.0 / 3.0 - e * 20.0) * u + 4.0 * e)
    g2 = -(W * u) * n2
    g3, g4 = W * f3, W * f4
    g2Rz = g2 * Rz
    A = -W * n1
    return A, g2, g2Rz + g3, g2Rz + g4, A + Rz * (g2Rz + g3 + g4) - W * n5


def _diag_block(dx, dy, m):
    """The 3x3 block that diag_apply applies."""
    A, S, P, Q, mzz = m
    return np.stack([
        np.stack([S * dx * dx + A, S * dx * dy, P * dx], -1),
        np.stack([S * dx * dy, S * dy * dy + A, P * dy], -1),
        np.stack([Q * dx, Q * dy, mzz], -1)], -2)


def _rr_wall(dx, dy, zt, zs):
    """rr_condense's wall terms (core off), as (A, S, P, Q, mzz)."""
    Rz = zt + zs
    invR = 1.0 / np.sqrt(dx * dx + dy * dy + Rz * Rz)
    invR2 = invR * invR
    invR3 = invR * invR2
    ez2 = Rz * Rz * invR2
    f1 = 0.5 * (1.0 - 6.0 * ez2) * invR3
    f2 = -1.5 * invR3
    f4 = 3.0 * invR3
    g3 = (3.0 * invR3 * Rz * invR) * invR
    G2 = f2 * invR2
    G24 = (f2 - f4) * invR2
    P = G2 * Rz
    return (f1 + f4 * (1.0 - ez2), G24, P, P + g3,
            f1 + G2 * Rz * Rz + g3 * Rz)


def _diag_block_t(dx, dy, m):
    """The block that diag_apply_t applies: P and Q trade places."""
    A, S, P, Q, mzz = m
    return _diag_block(dx, dy, (A, S, Q, P, mzz))


def _cross_terms(dx, dy, zt, zs, h):
    """cross_shared and cross_block's wall terms at height h: (F1, K,
    G3, H)."""
    Rz = zt + zs
    W = 1.0 / np.sqrt(dx * dx + dy * dy + Rz * Rz)
    u2 = W * W
    e = Rz * Rz * u2
    F1 = W * u2
    F1u2 = F1 * u2
    K0, Kh = F1 * Rz * (1.0 + 2.0 * u2), -2.0 * F1
    G0, Gh = 10.0 * F1u2 * (Rz * u2), -6.0 * F1u2
    H0, Hh = F1 + 2.0 * F1u2 * (1.0 - 5.0 * e), 6.0 * F1u2 * Rz
    return F1, Kh * h + K0, Gh * h + G0, Hh * h + H0


def _cross_wall(dx, dy, zt, zs, is_tr, transpose=False):
    """The wall part of the block cross_apply<IS_TR, TRANSPOSE> adds (tr:
    -Mw at height zt; rt: -Mw^T at height zs; TRANSPOSE: the block's
    transpose), its columns from applying the condensed terms to e_x, e_y,
    e_z as cross_apply does."""
    F1, K, G3, H = _cross_terms(dx, dy, zt, zs, zt if is_tr else zs)
    ux, uy = (-dx, -dy) if is_tr else (dx, dy)
    cols = []
    for vx, vy, vz in np.eye(3):
        if is_tr != transpose:                   # -Mw v
            w = ux * vy - uy * vx
            out = (K * vy - F1 * uy * vz - G3 * ux * w,
                   -K * vx + F1 * ux * vz - G3 * uy * w, -H * w)
        else:                                    # -Mw^T v
            pr = ux * vx + uy * vy
            out = (G3 * uy * pr - K * vy + H * uy * vz,
                   -G3 * ux * pr + K * vx - H * ux * vz,
                   F1 * (ux * vy - uy * vx))
        cols.append(np.stack(out, -1))
    return np.stack(cols, -1)


def _geometries(case):
    """(dx, dy, zt, zs, self) in units of a, heights already >= 1."""
    rng = np.random.default_rng(11)
    n = 400
    dx, dy = rng.uniform(-12, 12, (2, n))
    zt, zs = rng.uniform(1, 20, (2, n))
    self_mask = np.zeros(n, bool)
    if case == "far_below":          # source on the wall, target far up
        zs = np.ones(n)
        zt = rng.uniform(50, 2000, n)
    elif case == "on_wall":          # both blobs at the shifted floor
        zt = zs = np.ones(n)
    elif case == "R_to_2":           # on the wall and nearly coincident
        zt = zs = np.ones(n)
        dx, dy = rng.uniform(-1e-3, 1e-3, (2, n)) * np.logspace(0, -5, n)
    elif case == "self":             # the wall self-mobility
        # the kernels evaluate the pair terms at the self geometry; the
        # cross blocks' z^-4 / 8 comes out of a cancellation of z^-2
        # terms, so their rounding grows like z^2: heights up to 8 a
        dx = dy = np.zeros(n)
        zs = zt = rng.uniform(1, 8, n)
        self_mask[:] = True
    return dx, dy, zt, zs, self_mask


CASES = ["random", "far_below", "on_wall", "R_to_2", "self"]


def _refs(block, dx, dy, zt, zs, self_mask):
    """The JAX package's and the port's wall block on the geometry."""
    h = {"tt": zs, "rr": zs, "tr": zt, "rt": zs}[block]
    jfn = {"tt": jrpy.wall_tt, "rr": jrpy.wall_rr,
           "tr": jrpy.wall_trans_torque, "rt": jrpy.wall_rot_force}[block]
    tfn = {"tt": trpy.wall_tt, "rr": trpy.wall_rr,
           "tr": trpy.wall_trans_torque, "rt": trpy.wall_rot_force}[block]
    rz = zt + zs
    ref_j = np.asarray(jfn(*map(jnp.asarray, (dx, dy, rz, h)),
                           jnp.asarray(self_mask)))
    ref_t = tfn(*map(torch.as_tensor, (dx, dy, rz, h)),
                torch.as_tensor(self_mask)).numpy()
    return ref_j, ref_t


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("block", ["tt", "tr", "rt", "rr"])
def test_division_free_wall_terms_match_rpy(block, case):
    dx, dy, zt, zs, self_mask = _geometries(case)
    if block == "tt":
        got = _diag_block(dx, dy, _tt_wall(dx, dy, zt, zs))
    elif block == "rr":
        got = _diag_block(dx, dy, _rr_wall(dx, dy, zt, zs))
    else:
        got = _cross_wall(dx, dy, zt, zs, block == "tr")
    for ref in _refs(block, dx, dy, zt, zs, self_mask):
        scale = np.abs(ref).max(axis=(-2, -1), keepdims=True)
        assert np.all(scale > 0)
        rel = (np.abs(got - ref) / scale).max()
        assert rel <= 1e-13, rel


@pytest.mark.parametrize("case", CASES[:4])
def test_wall_terms_are_symmetric(case):
    """The symmetric sweep's premise on the kernels' own formulas: the tt
    and rr blocks of (target i, source j) are the transposes of (j, i)'s,
    and the tr block of (i, j) the transpose of rt's of (j, i); and what
    sym_kernel applies to the source from the (i, j) pair alone is the
    (j, i) block: diag_apply_t of tt and rr, and for tr (rt) the rt (tr)
    block of (i, j) applied transposed."""
    dx, dy, zt, zs, _ = _geometries(case)
    tt_ij = _diag_block(dx, dy, _tt_wall(dx, dy, zt, zs))
    tt_ji = _diag_block(-dx, -dy, _tt_wall(-dx, -dy, zs, zt))
    rr_ij = _diag_block(dx, dy, _rr_wall(dx, dy, zt, zs))
    rr_ji = _diag_block(-dx, -dy, _rr_wall(-dx, -dy, zs, zt))
    tr_ij = _cross_wall(dx, dy, zt, zs, True)
    rt_ji = _cross_wall(-dx, -dy, zs, zt, False)
    for a, b in ((tt_ij, tt_ji), (rr_ij, rr_ji), (tr_ij, rt_ji)):
        scale = np.abs(a).max(axis=(-2, -1), keepdims=True)
        assert (np.abs(a - np.swapaxes(b, -1, -2)) / scale).max() <= 1e-13
    shares = (
        (_diag_block_t(dx, dy, _tt_wall(dx, dy, zt, zs)), tt_ji),
        (_diag_block_t(dx, dy, _rr_wall(dx, dy, zt, zs)), rr_ji),
        (_cross_wall(dx, dy, zt, zs, False, transpose=True),
         _cross_wall(-dx, -dy, zs, zt, True)),
        (_cross_wall(dx, dy, zt, zs, True, transpose=True), rt_ji))
    for got, want in shares:
        scale = np.abs(want).max(axis=(-2, -1), keepdims=True)
        assert (np.abs(got - want) / scale).max() <= 1e-13


def _group_pair(p, n):
    """csrc/pair_blocks.cuh group_pair: (A, B) of upper-triangle pair p
    in row-major order over n groups."""
    def start(row):
        return row * n - row * (row - 1) // 2
    t = 2.0 * n + 1.0
    r = int((t - math.sqrt(t * t - 8.0 * p)) * 0.5)
    while r > 0 and start(r) > p:
        r -= 1
    while r + 1 < n and start(r + 1) <= p:
        r += 1
    return r, r + p - start(r)


def _sym_schedule(n, groups, per):
    """sym_kernel's walk, block by block: for each block the tile pairs
    (a, b) it sweeps in order, and the (slice, tile) workspace entries it
    owns (target sums of its A tiles in slice GB, source sums of its B
    tiles in slice GA)."""
    n_tiles = -(-n // pk.TILE)
    blocks = []
    for p in range(groups * (groups + 1) // 2):
        ga, gb = _group_pair(p, groups)
        a_rng = range(ga * per, min(n_tiles, (ga + 1) * per))
        b_end = min(n_tiles, (gb + 1) * per)
        pairs = [(ta, tb) for ta in a_rng
                 for tb in range(ta if ga == gb else gb * per, b_end)]
        owned = ({(gb, t) for t in a_rng}
                 | {(ga, t) for t in range(gb * per, b_end)})
        blocks.append((ga, gb, pairs, owned))
    return blocks


SCHEDULE_CASES = [(1, 1, 1), (300, 3, 1), (1000, 4, 2), (1000, 3, 3),
                  (17000, 67, 2), (49152, 128, 3), (32768, 128, 2)]


@pytest.mark.parametrize("n, groups, per", SCHEDULE_CASES)
def test_symmetric_schedule_visits_each_tile_pair_once(n, groups, per):
    n_tiles = -(-n // pk.TILE)
    blocks = _sym_schedule(n, groups, per)
    pairs = [pair for _, _, block, _ in blocks for pair in block]
    assert len(pairs) == len(set(pairs)) == n_tiles * (n_tiles + 1) // 2
    assert all(a <= b for a, b in pairs)
    owners = {}
    for k, (_, _, _, owned) in enumerate(blocks):
        for entry in owned:
            assert owners.setdefault(entry, k) == k, "two owners"
    # every (slice, tile) entry the slice sum reads has its owner
    assert set(owners) == {(g, t) for g in range(groups)
                           for t in range(n_tiles)}
    # and every tile pair writes only into entries its block owns
    for ga, gb, block, owned in blocks:
        for ta, tb in block:
            assert (gb, ta) in owned and (ga, tb) in owned


@pytest.mark.parametrize("n, groups, per", [(1000, 4, 2), (1000, 3, 3),
                                            (700, 6, 1)])
def test_symmetric_schedule_sums_to_the_product(n, groups, per):
    """The walk on a random symmetric scalar matrix: target-side sums of
    M_ij v_j and source-side sums of M_ji v_i added into the owned slices
    in order, then the slices added, give M v."""
    rng = np.random.default_rng(4)
    m = rng.normal(size=(n, n))
    m = m + m.T
    v = rng.normal(size=n)
    ws = np.zeros((groups, n))
    for ga, gb, block, _ in _sym_schedule(n, groups, per):
        for ta, tb in block:
            ra = slice(ta * pk.TILE, min(n, (ta + 1) * pk.TILE))
            rb = slice(tb * pk.TILE, min(n, (tb + 1) * pk.TILE))
            ws[gb, ra] += m[ra, rb] @ v[rb]
            if ta != tb:
                ws[ga, rb] += m[ra, rb].T @ v[ra]
    np.testing.assert_allclose(ws.sum(0), m @ v, rtol=0, atol=1e-10)


@pytest.mark.parametrize("n, groups, per", [(1000, 4, 2), (1000, 3, 3),
                                            (700, 6, 1)])
def test_symmetric_schedule_sums_cross_products(n, groups, per):
    """The walk of a square tr product, whose matrix is not symmetric:
    target-side sums of m_tr[ra, rb] v[rb], source-side sums from the
    other block of the same pairs, m_rt[ra, rb]^T v[ra] (m_rt(i, j) =
    m_tr(j, i)^T), and the diagonal tile directed on m_tr; the slices
    added give m_tr v."""
    rng = np.random.default_rng(5)
    m_tr = rng.normal(size=(n, n))
    m_rt = m_tr.T
    v = rng.normal(size=n)
    ws = np.zeros((groups, n))
    for ga, gb, block, _ in _sym_schedule(n, groups, per):
        for ta, tb in block:
            ra = slice(ta * pk.TILE, min(n, (ta + 1) * pk.TILE))
            rb = slice(tb * pk.TILE, min(n, (tb + 1) * pk.TILE))
            ws[gb, ra] += m_tr[ra, rb] @ v[rb]
            if ta != tb:
                ws[ga, rb] += m_rt[ra, rb].T @ v[ra]
    np.testing.assert_allclose(ws.sum(0), m_tr @ v, rtol=0, atol=1e-10)


def test_group_plan_fills_the_card_with_a_linear_workspace():
    # the paths' shapes on 132 SMs: groups of 3, 2 and 1 tiles
    assert pk.plan_groups(49152, 132) == (128, 3)
    assert pk.plan_groups(32768, 132) == (128, 2)
    assert pk.plan_groups(12288, 132) == (96, 1)
    for n_sm in (16, 132):
        want = pk.PLAN_WAVES * n_sm * pk.MIN_BLOCKS_F32
        g_max = math.isqrt(2 * want) + 1
        for n in (1, 77, 128, 300, 12288, 49152, 98304, 10 ** 6):
            groups, per = pk.plan_groups(n, n_sm)
            n_tiles = -(-n // pk.TILE)
            # whole groups of tiles, every one non-empty
            assert (groups - 1) * per < n_tiles <= groups * per
            # the workspace: at most g_max slices of n rows, whatever n is
            assert groups <= g_max
            if n_tiles <= g_max:
                assert (groups, per) == (n_tiles, 1)
            else:
                assert groups * (groups + 1) // 2 >= want // 2


@pytest.mark.parametrize("coupling, nv", [("tt", 3), ("tt", 6), ("tr", 6),
                                          ("rt", 3), ("rr", 6),
                                          ("grand", 6)])
def test_square_call_is_the_two_tensor_product(coupling, nv):
    """q_tgt None (the square product) computes what (q, q) does, and
    mobility's r_tgt None does the same through the wrapper."""
    rng = np.random.default_rng(7)
    q = torch.as_tensor(rng.uniform(1, 6, (150, 3)))
    v = torch.as_tensor(rng.normal(size=(150, nv)))
    kw = dict(coupling=coupling, mode="wall", self_interaction=True)
    assert torch.equal(pk.pair_matvec(q, None, v, **kw),
                       pk.pair_matvec(q, q, v, **kw))
    if coupling != "grand":
        r = q * 0.3
        vb = v.reshape(150, nv // 3, 3).permute(1, 0, 2)
        one = tmob.pairwise_matvec_multi(r, None, vb, 1.0, 0.3,
                                         coupling=coupling)
        two = tmob.pairwise_matvec_multi(r, r, vb, 1.0, 0.3,
                                         coupling=coupling)
        assert torch.equal(one, two)


def _slices(n_src, n_slices, tiles):
    """The source ranges of csrc/pair_blocks.cuh's pair_kernel."""
    step = tiles * pk.TILE
    return [(s * step, min(n_src, (s + 1) * step)) for s in range(n_slices)]


PLAN_CASES = [(n_tgt, n_src, n_sm, bps)
              for n_tgt, n_src in ((1, 1), (77, 301), (128, 128), (300, 300),
                                   (12288, 12288), (32768, 32768),
                                   (49152, 49152), (1000, 98304))
              for n_sm, bps in ((132, 8), (132, 5), (132, 12), (16, 2))]


def test_plan_covers_every_source_once_in_whole_tiles():
    for n_tgt, n_src, n_sm, bps in PLAN_CASES:
        for row_bytes in (12, 24, 48):
            n_slices, tiles = pk.plan_slices(n_tgt, n_src, n_sm, bps,
                                             row_bytes)
            spans = _slices(n_src, n_slices, tiles)
            assert spans[0][0] == 0 and spans[-1][1] == n_src
            for (a0, a1), (b0, _) in zip(spans, spans[1:]):
                assert a1 == b0 and b0 % pk.TILE == 0
            assert all(a1 > a0 for a0, a1 in spans), "empty slice"


def test_plan_one_slice_when_small_or_full():
    for n in (1, 5, 127, 128):
        assert pk.plan_slices(n, n, 132, 8, 24) == (1, 1)
    # target blocks that fill the plan's waves alone need no slices
    full = 132 * 8 * 128 * pk.PLAN_WAVES
    assert pk.plan_slices(full, 4096, 132, 8, 24)[0] == 1
    assert pk.plan_slices(2 * full, 4096, 132, 8, 24)[0] == 1
    # a quarter of them is sliced to fill the waves
    n_slices, _ = pk.plan_slices(full // 4, 4096, 132, 8, 24)
    assert n_slices == 4


def test_plan_workspace_within_limit():
    for n_tgt, n_src, n_sm, bps in PLAN_CASES:
        for row_bytes, limit in ((24, pk.WORKSPACE_LIMIT_BYTES),
                                 (48, 1 << 20), (48, 1 << 12)):
            n_slices, _ = pk.plan_slices(n_tgt, n_src, n_sm, bps,
                                         row_bytes, limit)
            assert n_slices == 1 or n_slices * n_tgt * row_bytes <= limit


# ---------------------------------------------------------------------------
# K2 on the symmetric sweep
# ---------------------------------------------------------------------------

K2_LAW = dict(repulsion_strength=0.7, debye_length=0.25, blob_radius=0.3)
K2_FAR = 1e18      # csrc/blob_forces.cu far_coord


def _k2_mag(d):
    """csrc/blob_forces.cu magnitude in float64 on displacements (..., 3):
    eob r^-1 2^min(c2a - c r, 0), 0 where r^2 == 0."""
    eob, c, c2a = mc.force_law(**K2_LAW)
    r2 = np.sum(d * d, axis=-1)
    with np.errstate(divide="ignore", invalid="ignore"):
        invr = 1.0 / np.sqrt(r2)
        r = r2 * invr
        # r^2 == 0: r is NaN, and fmin (like the kernel's) returns 0
        mag = eob * invr * np.exp2(np.fmin(c2a - c * r, 0.0))
    return np.where(r2 > 0, mag, 0.0)


def _k2_sweep(r, groups, per):
    """The kernel's walk: per block its tile pairs in order, a diagonal
    tile directed, an off-diagonal one as four warps x four quarters of
    32-step rotations (lane l meets source (l + step) % 32, whose running
    sum travels with it), the warps' source sums added in warp order, the
    target sums added after the block's last tile pair of the row tile;
    then the G slices summed in runs of 16."""
    n = r.shape[0]
    n_tiles = -(-n // pk.TILE)
    q = np.full((n_tiles * pk.TILE, 3), K2_FAR)
    q[:n] = r
    ws = np.zeros((groups, n_tiles * pk.TILE, 3))
    lane = np.arange(32)
    for ga, gb, block, _ in _sym_schedule(n, groups, per):
        acc, row = None, None
        for ta, tb in block:
            if ta != row:
                if acc is not None:
                    ws[gb, row * pk.TILE:(row + 1) * pk.TILE] += acc
                acc, row = np.zeros((pk.TILE, 3)), ta
            qa = q[ta * pk.TILE:(ta + 1) * pk.TILE]
            if ta == tb:
                count = min(pk.TILE, n - ta * pk.TILE)
                d = qa[:, None] - qa[None, :count]
                acc += np.sum(_k2_mag(d)[..., None] * d, axis=1)
                continue
            qb = q[tb * pk.TILE:(tb + 1) * pk.TILE]
            s_sum = np.zeros((4, pk.TILE, 3))
            for w in range(4):
                for quarter in range(4):
                    qi = qa[w * 32 + lane]
                    qj = qb[quarter * 32 + lane]
                    bsum = np.zeros((32, 3))
                    for step in range(32):
                        src = (lane + step) % 32
                        d = qi - qj[src]
                        md = _k2_mag(d)[:, None] * d
                        acc[w * 32 + lane] += md
                        bsum[src] -= md
                    s_sum[w, quarter * 32 + lane] = bsum
            ws[ga, tb * pk.TILE:(tb + 1) * pk.TILE] += s_sum.sum(0)
        ws[gb, row * pk.TILE:(row + 1) * pk.TILE] += acc
    out = np.zeros((n, 3))
    for k0 in range(0, groups, 16):
        out += ws[k0:k0 + 16, :n].sum(0)
    return out


def _k2_scene(n):
    rng = np.random.default_rng(n)
    side = max(n, 1) ** (1 / 3) * 0.7      # some pairs closer than 2a
    r = rng.uniform(0, side, (n, 3))
    if n > 5:
        r[5] = r[4]                          # a coincident pair
        r[n - 1] = r[2] + [0.2, 0.0, 0.1]    # inside 2a = 0.6
    return r


@pytest.mark.parametrize("n, groups, per",
                         [(n,) + pk.plan_groups(n, 132)
                          for n in (1, 127, 129, 300, 1000)]
                         + [(1000, 3, 3), (300, 2, 2)])
def test_k2_symmetric_walk_reproduces_the_plain_forces(n, groups, per):
    r = _k2_scene(n)
    got = _k2_sweep(r, groups, per)
    ref = mc.blob_blob_forces_plain(torch.as_tensor(r), **K2_LAW).numpy()
    if n == 1:
        assert np.all(got == 0) and np.all(ref == 0)
        return
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()


@pytest.mark.parametrize("where", ["inside", "at", "beyond"])
def test_k2_folded_law_is_the_two_branch_law(where):
    eob, c, c2a = mc.force_law(**K2_LAW)
    two_a, b = 2 * K2_LAW["blob_radius"], K2_LAW["debye_length"]
    r = {"inside": np.linspace(1e-3, two_a, 64, endpoint=False),
         "at": np.array([two_a]),
         "beyond": two_a + np.geomspace(1e-9, 40 * b, 64)}[where]
    folded = eob / r * np.exp2(np.minimum(c2a - c * r, 0.0))
    two_branch = np.where(r > two_a,
                          eob * np.exp(-(r - two_a) / b) / r, eob / r)
    if where == "beyond":
        assert np.abs(folded / two_branch - 1).max() <= 1e-13
    else:                                  # 2^0 = 1 exactly
        assert np.array_equal(folded, two_branch)
    # and the magnitude the sweep uses is that law
    d = np.stack([r, np.zeros_like(r), np.zeros_like(r)], axis=-1)
    np.testing.assert_allclose(_k2_mag(d), folded, rtol=1e-13, atol=0)
