"""The open free surface's symmetric sweeps of kernels K1 (tt_fs,
csrc/pair_blocks.cuh sym2_kernel) and P1 (csrc/pair_radii.cu
radii_sym2_kernel), written out in numpy on the CPU in the kernels' order
on small tiles:

- two targets a lane: a block's two warps hold a tile's rows, lane l of
  warp w rows 2 w LANES + l and 2 w LANES + LANES + l; each chunk of
  LANES sources of the other tile rotates through the warp, and a step
  condenses a source against both of a lane's targets, M v_j to the
  target and M^T v_i to the source's running sum, which comes back to its
  lane and joins the other warp's in warp order;
- the tile far test: K1 (units of a, radius 1) takes the far form alone
  where the tiles' boxes lie more than 2 apart and their lowest heights
  add up to more than 2 (boxes_far and images_far), P1 (physical units)
  where the boxes lie further apart than their largest radii add up to
  and both tiles lie above the plane (boxes_far and above_plane), else
  P1's warp vote once a step for both of a lane's pairs; the full form
  (K1's near and zero forms, P1's three regimes of the pair and of its
  image) elsewhere;
- the diagonal tile directed, every ordered pair, the self pair's block;
- a ragged last tile's padding rows, a blob at (0, 0, 1) of radius 1,
  in its box, as the kernels stage them;

against the port's plain products and the JAX package's pairwise_matvec
and source_target_matvec on free_surface at 1e-12 in float64, for B = 1
and 2: a ragged n (the last tile and its last target pair half full), a
blob at z = a (its image touching), coincident blobs (one pair on the
plane, its image at R = 0), tile pairs that the far test must refuse (a
blob below its radius or the plane, tiles whose boxes overlap) and, for
P1, mixed radii with overlapping pairs and one blob inside another.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rigidmultiblobswall_tpu.ops import mobility as jmob
from rigidmultiblobswall_tpu_torch.ops import mobility_cuda as tmc
from rigidmultiblobswall_tpu_torch.ops import pair_kernels as tpk

from torch_parity import rel_err, to_np

ETA = 0.9
# the emulated tile and warp (the kernels' 128 rows and 32 lanes): two
# warps of LANES lanes, two targets a lane, hold a tile's TILE rows
TILE, LANES = 8, 2
WARPS = TILE // (2 * LANES)
# rows of the scenes: the last tile ragged (3 rows: warp 0's second lane
# holds one target of its pair)
N = 5 * TILE + 3


def _row2(w, lane, h):
    """The tile row a lane holds as its target h (pairk::row2)."""
    return w * 2 * LANES + h * LANES + lane


def _sweep2(n, block, v, tile_far, vote=None):
    """The two-targets-a-lane sweep over tiles of TILE rows. block(i, j,
    self, far) is a pair's 3 x 3 block (the far form alone where far);
    tile_far(a, b) the tile pair's test; vote(pairs) P1's warp vote of a
    step in a tile pair the test refused (None: K1, no vote). Returns the
    product (n, 3B) and each ordered pair's visits."""
    nb = v.shape[1] // 3
    n_tiles = -(-n // TILE)
    tgt = np.zeros_like(v)       # the target-side sums (acc, ws_a)
    src = np.zeros_like(v)       # the source-side sums (s_sum, ws_b)
    visits = np.zeros((n, n), dtype=int)
    for ta in range(n_tiles):
        acc = np.zeros((TILE, 3 * nb))
        for tb in range(ta, n_tiles):
            if tb == ta:          # the diagonal tile: directed, full form
                for w in range(WARPS):
                    for lane in range(LANES):
                        for h in (0, 1):
                            i = ta * TILE + _row2(w, lane, h)
                            if i >= n:
                                continue
                            for j in range(ta * TILE, min(n, (ta + 1) * TILE)):
                                m = block(i, j, i == j, False)
                                visits[i, j] += 1
                                for b in range(nb):
                                    acc[i - ta * TILE, 3 * b:3 * b + 3] += (
                                        m @ v[j, 3 * b:3 * b + 3])
                continue
            far = bool(tile_far(ta, tb))
            s_sum = np.zeros((WARPS, TILE, 3 * nb))
            for w in range(WARPS):
                for chunk in range(TILE // LANES):
                    accj = np.zeros((LANES, 3 * nb))
                    for step in range(LANES):
                        # lane l holds the chunk's source (l + step) % LANES
                        # (each step shuffles the sources one lane down)
                        pairs = []
                        for lane in range(LANES):
                            slot = (lane + step) % LANES
                            j = tb * TILE + chunk * LANES + slot
                            for h in (0, 1):
                                i = ta * TILE + _row2(w, lane, h)
                                if i < n and j < n:
                                    pairs.append((lane, slot, i, j))
                        step_far = far or (vote is not None and vote(
                            [(i, j) for _, _, i, j in pairs]))
                        for lane, slot, i, j in pairs:
                            m = block(i, j, False, step_far)
                            visits[i, j] += 1
                            visits[j, i] += 1
                            for b in range(nb):
                                sl = slice(3 * b, 3 * b + 3)
                                acc[i - ta * TILE, sl] += m @ v[j, sl]
                                accj[slot, sl] += m.T @ v[i, sl]
                    s_sum[w, chunk * LANES:(chunk + 1) * LANES] = accj
            for r in range(tb * TILE, min(n, (tb + 1) * TILE)):
                src[r] += s_sum[0, r - tb * TILE] + s_sum[1, r - tb * TILE]
        rows = slice(ta * TILE, min(n, (ta + 1) * TILE))
        tgt[rows] += acc[:rows.stop - rows.start]
    return tgt + src, visits


# the kernels' padding row of a ragged tile (pi and pj past n): a blob at
# (0, 0, 1) of radius 1, in the units of the kernel's positions
PAD, PAD_RADIUS = np.array([0.0, 0.0, 1.0]), 1.0


def _boxes(r, rad):
    """Each tile's (lo, hi, largest radius) as tile_box2 forms it: a
    ragged tile's box holds its padding rows too."""
    out = []
    for t in range(-(-len(r) // TILE)):
        rows = slice(t * TILE, (t + 1) * TILE)
        p, a = r[rows], rad[rows]
        if len(p) < TILE:
            p, a = np.vstack([p, PAD]), np.append(a, PAD_RADIUS)
        out.append((p.min(0), p.max(0), a.max()))
    return out


def _boxes_far(A, B):
    g = np.maximum(np.maximum(A[0] - B[1], B[0] - A[1]), 0.0)
    s = A[2] + B[2]
    return float(g @ g) > s * s * 1.0001


def _images_far(A, B):
    z = A[0][2] + B[0][2]
    s = A[2] + B[2]
    return z > 0 and z * z > s * s * 1.0001


def _above_plane(A, B):
    return A[0][2] >= 0 and B[0][2] >= 0


def _scene(n, seed, scale=1.0):
    """Blobs in the emulated tiles, each tile a 3 x 3 x 3 cell of a grid of
    cells 6 apart (3 columns), heights in [1.2, 4.2], times `scale`: most
    tile pairs lie far apart; tile 1 holds a blob below its radius and a
    coincident pair on the plane (its image at R = 0), tile 3's cell
    overlaps tile 2's and holds a blob at z = 1 (its image touching), tile
    2 a coincident pair."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) // TILE
    r = np.empty((n, 3))
    r[:, 0] = 6.0 * (t % 3) + rng.uniform(0, 3, n)
    r[:, 1] = 6.0 * (t // 3) + rng.uniform(0, 3, n)
    r[:, 2] = rng.uniform(1.2, 4.2, n)
    r[t == 3, 0] += 13.5
    r[t == 3, 1] -= 5.0
    r[TILE + 2, 2] = 0.5
    r[TILE + 4, 2] = 0.0
    r[TILE + 5] = r[TILE + 4]
    r[2 * TILE + 1] = r[2 * TILE]
    r[3 * TILE + 6, 2] = 1.0
    return r * scale


# ---------------------------------------------------------------------------
# K1 tt_fs: one radius, units of a
# ---------------------------------------------------------------------------

def _fs_coeffs(w):
    """fs_coeffs: c1 = w + (2/3) w^3, c2 = (1 - 2 w^2) w^3."""
    return w + 2.0 / 3.0 * w ** 3, (1 - 2 * w * w) * w ** 3


def _k1_block(q, i, j, self_, far, check=True):
    """fs_condense2's block of (i, j): the far form alone where far (the
    far test's guarantee r > 2 and |R| > 2 checked), else the near and
    zero forms by the pair's flags."""
    dx, dy, dz = q[i] - q[j]
    Rz = q[i, 2] + q[j, 2]
    xy2 = dx * dx + dy * dy
    r2, R2 = xy2 + dz * dz, xy2 + Rz * Rz
    if far:
        assert not check or (r2 > 4 and R2 > 4)
        c1, c2 = _fs_coeffs(1 / math.sqrt(r2))
        e1, e2 = _fs_coeffs(1 / math.sqrt(R2))
    else:
        if r2 > 4:
            c1, c2 = _fs_coeffs(1 / math.sqrt(r2))
        elif self_ or r2 == 0:
            c1, c2 = (4.0 / 3.0 if self_ else 0.0), 0.0
        else:
            c1, c2 = 4.0 / 3.0 - 0.375 * math.sqrt(r2), 0.125 / math.sqrt(r2)
        if R2 > 4:
            e1, e2 = _fs_coeffs(1 / math.sqrt(R2))
        elif R2 == 0:
            e1, e2 = 0.0, 0.0
        else:
            e1, e2 = 4.0 / 3.0 - 0.375 * math.sqrt(R2), 0.125 / math.sqrt(R2)
    cdz, eRz = c2 * dz, e2 * Rz
    A, S = c1 + e1, c2 + e2
    P, Q = cdz - eRz, cdz + eRz
    mzz = c1 + cdz * dz - (e1 + eRz * Rz)
    return np.array([[A + S * dx * dx, S * dx * dy, P * dx],
                     [S * dx * dy, A + S * dy * dy, P * dy],
                     [Q * dx, Q * dy, mzz]])


def _k1_tile_far(q):
    boxes = _boxes(q, np.ones(len(q)))
    return lambda a, b: (_boxes_far(boxes[a], boxes[b])
                         and _images_far(boxes[a], boxes[b]))


@pytest.mark.parametrize("n_rhs", [1, 2])
def test_k1_fs_open_sweep_emulated(n_rhs):
    """K1 tt_fs's open sweep, two targets a lane with the tile far test,
    against the port's plain product (units of a) and the JAX package's
    pairwise_matvec on free_surface (physical units) at 1e-12; every
    unordered pair met once off the diagonal, every ordered pair of a
    diagonal tile once."""
    q = _scene(N, 51)
    v = np.random.default_rng(52).normal(size=(N, 3 * n_rhs))
    out, visits = _sweep2(N, lambda i, j, s, far: _k1_block(q, i, j, s, far),
                          v, _k1_tile_far(q))
    assert (visits == 1).all()
    ref = tpk.pair_plain(torch.as_tensor(q), torch.as_tensor(q),
                         torch.as_tensor(v), coupling="tt",
                         mode="free_surface", self_interaction=True)
    assert rel_err(out, ref) < 1e-12
    a = 0.25
    r = q * a
    for b in range(n_rhs):
        jref = np.asarray(jmob.pairwise_matvec(
            jnp.asarray(r), jnp.asarray(r), jnp.asarray(v[:, 3 * b:3 * b + 3]),
            ETA, a, coupling="tt", domain="free_surface", method="generic"))
        got = out[:, 3 * b:3 * b + 3] / (8 * math.pi * ETA * a)
        assert rel_err(got, jref) < 1e-12


def test_k1_fs_far_test_refuses_what_it_must():
    """The far test passes most tile pairs of the scene and refuses those
    with tile 1 (a blob below its radius, images_far), tiles 2 and 3
    (overlapping cells, boxes_far) and the ragged tile 5 (its padding row
    at the origin stretches its box over the others); where it passes,
    every pair and image lies beyond 2. The far form forced on every tile
    pair misses the plain product; the test's choice meets it."""
    q = _scene(N, 53)
    tile_far = _k1_tile_far(q)
    n_tiles = -(-N // TILE)
    refused = {(a, b) for a in range(n_tiles) for b in range(a + 1, n_tiles)
               if not tile_far(a, b)}
    assert {(0, 1), (1, 2), (1, 4), (2, 3)} <= refused
    assert {(a, 5) for a in range(5)} <= refused
    assert all(1 in ab or 5 in ab or ab == (2, 3) for ab in refused)
    for a in range(n_tiles):
        for b in range(a + 1, n_tiles):
            if (a, b) in refused:
                continue
            for i in range(a * TILE, min(N, (a + 1) * TILE)):
                for j in range(b * TILE, min(N, (b + 1) * TILE)):
                    d = q[i] - q[j]
                    assert d @ d > 4 and (q[i, 2] + q[j, 2]) ** 2 > 4
    v = np.random.default_rng(54).normal(size=(N, 3))
    ref = to_np(tpk.pair_plain(torch.as_tensor(q), torch.as_tensor(q),
                               torch.as_tensor(v), coupling="tt",
                               mode="free_surface", self_interaction=True))
    forced, _ = _sweep2(
        N, lambda i, j, s, far: _k1_block(q, i, j, s, far, check=False), v,
        lambda a, b: True)
    assert rel_err(forced, ref) > 1e-6
    tested, _ = _sweep2(N, lambda i, j, s, far: _k1_block(q, i, j, s, far),
                        v, tile_far)
    assert rel_err(tested, ref) < 1e-12


def test_k1_fs_condense2_is_fs_condense():
    """fs_condense2's coefficients (c1 = w + (2/3) w^3, c2 = (1 - 2 w^2)
    w^3 and its fold of the image) give the plain free-surface block of
    every pair, near, coincident and self pairs included, at 1e-13."""
    q = _scene(N, 55)[:2 * TILE]
    for i in range(len(q)):
        for j in range(len(q)):
            m = _k1_block(q, i, j, i == j, False)
            ref = to_np(tpk.block(
                "tt", torch.as_tensor(q[i] - q[j]),
                torch.as_tensor(q[i, 2]), torch.as_tensor(q[j, 2]),
                torch.as_tensor(i == j), "free_surface"))
            assert np.abs(m - ref).max() <= 1e-13 * max(np.abs(ref).max(), 1)


# ---------------------------------------------------------------------------
# P1: per-blob radii, physical units
# ---------------------------------------------------------------------------

def _p1_rpy(r2, a, b, full):
    """rpy_coeffs: the far form, or with `full` the regime by its test
    (far r > a + b, overlapping r > |b - a|, else one inside the other)."""
    s2 = a * a + b * b
    if not full or r2 > (a + b) ** 2:
        invr = 1.0 / math.sqrt(r2)
        x = s2 * invr * invr
        return (1 + x / 3.0) * invr, invr ** 3 - x * invr ** 3
    dd2 = (b - a) ** 2
    if r2 > dd2:
        r = math.sqrt(r2)
        qq = dd2 + 3 * r2
        c1 = (0.5 * (a + b) - qq * qq / (32 * r ** 3)) * (4.0 / 3.0) / (a * b)
        c2 = (dd2 - r2) ** 2 / (8 * a * b * r ** 5)
        return c1, c2
    return 4.0 / (3.0 * max(a, b)), 0.0


def _p1_far(r, rad, i, j):
    """Both the pair and its image outside contact."""
    d = r[i] - r[j]
    s = (rad[i] + rad[j]) ** 2
    xy2 = d[0] ** 2 + d[1] ** 2
    return xy2 + d[2] ** 2 > s and xy2 + (r[i, 2] + r[j, 2]) ** 2 > s


def _p1_block(r, rad, i, j, far, check=True):
    """condense<FULL = !far>: the far forms of the pair and its image (the
    far test's or the vote's guarantee checked), else each regime by its
    own test."""
    a, b = rad[i], rad[j]
    dx, dy, dz = r[i] - r[j]
    Rz = r[i, 2] + r[j, 2]
    xy2 = dx * dx + dy * dy
    if far:
        assert not check or _p1_far(r, rad, i, j)
    c1, c2 = _p1_rpy(xy2 + dz * dz, a, b, not far)
    e1, e2 = _p1_rpy(xy2 + Rz * Rz, a, b, not far)
    A, S = c1 + e1, c2 + e2
    P, Q = c2 * dz - e2 * Rz, c2 * dz + e2 * Rz
    mzz = c1 + c2 * dz * dz - (e1 + e2 * Rz * Rz)
    return np.array([[A + S * dx * dx, S * dx * dy, P * dx],
                     [S * dx * dy, A + S * dy * dy, P * dy],
                     [Q * dx, Q * dy, mzz]])


def _p1_scene(seed, radii):
    """_scene at 0.3 (the largest radius) with radii drawn from `radii`:
    tile 1's low blob moved below the plane, tile 2 a coincident pair of
    unequal radii, one blob inside another and an overlapping pair, tile
    4 a blob at z = a."""
    r = _scene(N, seed, scale=0.3)
    rng = np.random.default_rng(seed + 1)
    rad = rng.choice(radii, N)
    r[TILE + 2, 2] = -0.05
    rad[2 * TILE], rad[2 * TILE + 1] = min(radii), max(radii)
    r[2 * TILE + 3] = r[2 * TILE + 2] + 0.01
    rad[2 * TILE + 2], rad[2 * TILE + 3] = max(radii), min(radii)
    r[2 * TILE + 5] = r[2 * TILE + 4] + np.array([0.12, 0.05, 0.02])
    r[4 * TILE + 3, 2] = rad[4 * TILE + 3]
    return r, rad


P1_RADII = {"one_radius": (0.3,), "mixed": (0.131, 0.157, 0.3),
            "wide": (0.08, 0.2, 0.3)}


@pytest.mark.parametrize("n_rhs", [1, 2])
@pytest.mark.parametrize("case", sorted(P1_RADII))
def test_p1_fs_open_sweep_emulated(case, n_rhs):
    """P1's open free-surface sweep, two targets a lane with the tile far
    test and the warp vote elsewhere, against the port's plain product
    and the JAX package's source_target_matvec at 1e-12; every pair met
    once."""
    r, rad = _p1_scene(56, P1_RADII[case])
    boxes = _boxes(r, rad)
    tested = []

    def tile_far(a, b):
        far = (_boxes_far(boxes[a], boxes[b])
               and _above_plane(boxes[a], boxes[b]))
        tested.append(far)
        return far

    v = np.random.default_rng(57).normal(size=(n_rhs, N, 3))
    vv = np.concatenate(list(v), axis=1)
    out, visits = _sweep2(
        N, lambda i, j, s, far: _p1_block(r, rad, i, j, far), vv, tile_far,
        vote=lambda pairs: all(_p1_far(r, rad, i, j) for i, j in pairs))
    assert (visits == 1).all()
    assert any(tested) and not all(tested)
    ref = to_np(tmc.radii_matvec_plain(
        torch.as_tensor(r), torch.as_tensor(v), torch.as_tensor(rad), ETA,
        domain="free_surface"))
    pref = 1.0 / (8 * math.pi * ETA)
    for b in range(n_rhs):
        got = out[:, 3 * b:3 * b + 3] * pref
        assert rel_err(got, ref[b]) < 1e-12
        jref = np.asarray(jmob.source_target_matvec(
            jnp.asarray(r), jnp.asarray(r), jnp.asarray(v[b]),
            jnp.asarray(rad), jnp.asarray(rad), ETA, domain="free_surface"))
        assert rel_err(got, jref) < 1e-12


def test_p1_fs_far_test_refuses_what_it_must():
    """The open test refuses tile 1 (a blob below the plane), tiles 2 and
    3 (overlapping cells) and the ragged tile 5 (its padding row of radius
    1 at the origin) and passes the rest, whose pairs and images all lie
    outside contact; the far form forced everywhere misses the plain
    product."""
    r, rad = _p1_scene(58, P1_RADII["mixed"])
    boxes = _boxes(r, rad)
    n_tiles = len(boxes)
    refused = {(a, b) for a in range(n_tiles) for b in range(a + 1, n_tiles)
               if not (_boxes_far(boxes[a], boxes[b])
                       and _above_plane(boxes[a], boxes[b]))}
    assert {(0, 1), (1, 4), (2, 3)} <= refused
    assert {(a, 5) for a in range(5)} <= refused
    assert all(1 in ab or 5 in ab or ab == (2, 3) for ab in refused)
    for a in range(n_tiles):
        for b in range(a + 1, n_tiles):
            if (a, b) not in refused:
                assert all(_p1_far(r, rad, i, j)
                           for i in range(a * TILE, min(N, (a + 1) * TILE))
                           for j in range(b * TILE, min(N, (b + 1) * TILE)))
    v = np.random.default_rng(59).normal(size=(N, 3))
    ref = to_np(tmc.radii_matvec_plain(
        torch.as_tensor(r), torch.as_tensor(v[None]), torch.as_tensor(rad),
        ETA, domain="free_surface"))[0] * (8 * math.pi * ETA)
    forced, _ = _sweep2(
        N, lambda i, j, s, far: _p1_block(r, rad, i, j, far, check=False), v,
        lambda a, b: True)
    assert rel_err(forced, ref) > 1e-6


def _padded_pair(kernel):
    """Two tiles, the second ragged (3 rows), whose real rows pass the far
    test and whose padding row refuses it: for K1 (units of a, radius 1)
    tile 0 at heights from 1 (images_far: 1 + 1 = 2 with the padding
    against 1 + 3 without), for P1 (radii 0.3, physical units) tile 1 1.0
    below tile 0 in x (boxes_far: 1.0 > 0.6 without the padding's radius,
    < 1.3 with it). Returns (positions, radii, test)."""
    rng = np.random.default_rng(61)
    n = TILE + 3
    r = np.empty((n, 3))
    r[:, 1] = rng.uniform(0, 3, n)
    if kernel == "K1":
        r[:TILE, 0] = 20 + rng.uniform(0, 3, TILE)
        r[TILE:, 0] = rng.uniform(0.5, 3, 3)
        r[:TILE, 2] = rng.uniform(1.0, 3, TILE)
        r[0, 2] = 1.0
        r[TILE:, 2] = rng.uniform(3, 4, 3)
        rad = np.ones(n)
        test = lambda A, B: _boxes_far(A, B) and _images_far(A, B)
    else:
        r[:TILE, 0] = 14 + rng.uniform(0, 3, TILE)
        r[TILE:, 0] = rng.uniform(10, 13, 3)
        r[TILE:, 0] += 13 - r[TILE:, 0].max()
        r[:TILE, 0] += 14 - r[:TILE, 0].min()
        r[:, 2] = rng.uniform(0.5, 3, n)
        rad = np.full(n, 0.3)
        test = lambda A, B: _boxes_far(A, B) and _above_plane(A, B)
    return r, rad, test


@pytest.mark.parametrize("kernel", ["K1", "P1"])
def test_far_test_counts_the_ragged_tiles_padding(kernel):
    """The ragged tile's padding row alone refuses a tile pair whose real
    rows pass the far test (K1 by images_far, P1 by boxes_far): the sweep
    takes the full form there, as the kernels do, and meets the plain
    product at 1e-12; the far form forced on the pair meets it too, since
    every real pair and image lies outside contact."""
    r, rad, test = _padded_pair(kernel)
    n = len(r)
    real = [(r[rows].min(0), r[rows].max(0), rad[rows].max())
            for rows in (slice(0, TILE), slice(TILE, n))]
    assert test(*real)
    assert not test(*_boxes(r, rad))
    v = np.random.default_rng(62).normal(size=(n, 3))
    if kernel == "K1":
        block = lambda i, j, s, far: _k1_block(r, i, j, s, far)
        ref = to_np(tpk.pair_plain(torch.as_tensor(r), torch.as_tensor(r),
                                   torch.as_tensor(v), coupling="tt",
                                   mode="free_surface", self_interaction=True))
        vote = None
    else:
        block = lambda i, j, s, far: _p1_block(r, rad, i, j, far)
        ref = to_np(tmc.radii_matvec_plain(
            torch.as_tensor(r), torch.as_tensor(v[None]),
            torch.as_tensor(rad), ETA, domain="free_surface"))[0] * (
                8 * math.pi * ETA)
        vote = lambda pairs: all(_p1_far(r, rad, i, j) for i, j in pairs)
    boxes = _boxes(r, rad)
    tested = []

    def tile_far(a, b):
        tested.append(test(boxes[a], boxes[b]))
        return tested[-1]

    out, visits = _sweep2(n, block, v, tile_far, vote)
    assert tested == [False] and (visits == 1).all()
    assert rel_err(out, ref) < 1e-12
    forced, _ = _sweep2(n, block, v, lambda a, b: True)
    assert rel_err(forced, ref) < 1e-12
