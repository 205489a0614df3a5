"""The free surface's image-box instances of kernels K1 (tt_fs) and P1
under the in-plane policy (PlaneBoxes), as csrc/pair_blocks.cuh
(sum_blocks' FsMoments) and csrc/pair_radii.cu (fs_box_sum, images_far)
form them, written out in numpy on the CPU:

- the minimum image in float64, then every box of a pair into the
  coefficient sums (the sums of c1, e1, c2, e2, (c2 + e2) dx^2, dx dy,
  dy^2, c2 dx, c2 dy, e2 dx and e2 dy), closed once a pair with dz and Rz
  folded in, and applied as M to v_j and as M^T to v_i on the symmetric
  sweep (the diagonal tile directed, the self pair in the home box);
- the home box in the full form: K1's near and zero forms of the pair and
  of its image; P1's three regimes of each, the image's settled far where
  the tile pair's z test (images_far: the tiles' lowest heights against
  their largest radii) passes;
- the eight far boxes in the far form alone;

against the port's plain products and the JAX package's pairwise_matvec
and source_target_matvec on free_surface with a periodic_length, at 1e-12
in float64: one radius and mixed radii, a blob at z = a (its image
touching), pairs at the half-box tie, L / a just above 4.04, and the z
test refusing a tile that holds a blob below its radius.
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
# the emulated sweep's tile (the kernels' 128 rows), small enough that the
# scenes span several tiles and tile pairs
TILE = 8


def _min_image(d, L):
    half = 0.5 if d > 0 else (-0.5 if d < 0 else 0.0)
    return d - np.trunc(d * (1.0 / L) + half) * L


class _Moments:
    """FsMoments: a pair's boxes by their coefficients."""

    def __init__(self):
        self.c1 = self.e1 = self.c2 = self.e2 = 0.0
        self.xx = self.xy = self.yy = 0.0
        self.cx = self.cy = self.ex = self.ey = 0.0

    def add(self, c1, c2, e1, e2, dx, dy):
        s = c2 + e2
        self.c1 += c1
        self.e1 += e1
        self.c2 += c2
        self.e2 += e2
        self.xx += s * dx * dx
        self.xy += s * dx * dy
        self.yy += s * dy * dy
        self.cx += c2 * dx
        self.cy += c2 * dy
        self.ex += e2 * dx
        self.ey += e2 * dy

    def close(self, dz, Rz):
        a = self.c1 + self.e1
        return np.array(
            [[self.xx + a, self.xy, self.cx * dz - self.ex * Rz],
             [self.xy, self.yy + a, self.cy * dz - self.ey * Rz],
             [self.cx * dz + self.ex * Rz, self.cy * dz + self.ey * Rz,
              (self.c1 - self.e1) + self.c2 * dz * dz - self.e2 * Rz * Rz]])


def _far_boxes(dx, dy, L):
    """(x, y) of PlaneBoxes' eight boxes off the home box, in its order:
    (bx, by) row-major over {-1, 0, 1}^2 without (0, 0)."""
    ox = (dx - L[0], dx, dx + L[0])
    oy = (dy - L[1], dy, dy + L[1])
    out = []
    for k in range(1, 9):
        idx = k - 1 + (1 if k >= 5 else 0)
        out.append((ox[idx // 3], oy[idx % 3]))
    return out


def _sweep(n, block, v, tile_far=None):
    """The symmetric sweep over tiles of TILE rows: the diagonal tile
    directed (every ordered pair, the self pair's block M(i, i)), each
    other tile pair's unordered pairs once, M v_j to i and M^T v_i to j.
    block(i, j, self, img_far) is a pair's closed box sum; tile_far(I, J)
    the tile pair's z test (None: no test)."""
    out = np.zeros_like(v)
    nb = v.shape[1] // 3
    tiles = [range(t, min(t + TILE, n)) for t in range(0, n, TILE)]
    for ti, rows_i in enumerate(tiles):
        for tj in range(ti, len(tiles)):
            far = bool(tile_far(ti, tj)) if tile_far else False
            for i in rows_i:
                for j in tiles[tj]:
                    if ti == tj:      # the diagonal tile: directed
                        m = block(i, j, i == j, far)
                        for b in range(nb):
                            out[i, 3 * b:3 * b + 3] += m @ v[j, 3 * b:3 * b + 3]
                        continue
                    m = block(i, j, False, far)
                    for b in range(nb):
                        out[i, 3 * b:3 * b + 3] += m @ v[j, 3 * b:3 * b + 3]
                        out[j, 3 * b:3 * b + 3] += m.T @ v[i, 3 * b:3 * b + 3]
    return out


# ---------------------------------------------------------------------------
# K1 tt_fs: one radius, in units of a
# ---------------------------------------------------------------------------

def _k1_far(r2):
    invr = 1.0 / math.sqrt(r2)
    return ((1 + 2.0 / 3.0 * invr * invr) * invr,
            (1 - 2 * invr * invr) * invr ** 3)


def _k1_home(r2, R2, self_):
    """tt_core and fs_image in the home box: the far forms, the near forms
    at r <= 2 (|R| <= 2), the self and coincident pairs' 4/3 and 0, the
    image at R = 0 zero."""
    if r2 <= 4:
        if self_ or r2 == 0:
            c1, c2 = (4.0 / 3.0 if self_ else 0.0), 0.0
        else:
            r = math.sqrt(r2)
            c1, c2 = 4.0 / 3.0 - 0.375 * r, 0.125 / r
    else:
        c1, c2 = _k1_far(r2)
    if R2 <= 4:
        if R2 == 0:
            e1, e2 = 0.0, 0.0
        else:
            R = math.sqrt(R2)
            e1, e2 = 4.0 / 3.0 - 0.375 * R, 0.125 / R
    else:
        e1, e2 = _k1_far(R2)
    return c1, c2, e1, e2


def _k1_block(q, L, i, j, self_):
    dx = _min_image(q[i, 0] - q[j, 0], L[0])
    dy = _min_image(q[i, 1] - q[j, 1], L[1])
    dz, Rz = q[i, 2] - q[j, 2], q[i, 2] + q[j, 2]
    m = _Moments()
    xy2 = dx * dx + dy * dy
    m.add(*_k1_home(xy2 + dz * dz, xy2 + Rz * Rz, self_), dx, dy)
    for x, y in _far_boxes(dx, dy, L):
        xy2 = x * x + y * y
        assert xy2 + dz * dz > 4      # PlaneBoxes' far boxes
        m.add(*_k1_far(xy2 + dz * dz), *_k1_far(xy2 + Rz * Rz), x, y)
    return m.close(dz, Rz)


def _k1_scene(L, n=30, seed=41):
    """Blobs in units of a in an (Lx, Ly, 0) box: some below a, one on the
    plane with a coincident partner (its image at R = 0), one at z = 1
    (its own image touching), an overlapping pair, and pairs at the
    half-box tie on both axes (exactly: dyadic coordinates and lengths,
    so the kernels' d (1/L) and the plain version's d / L pick the same
    image)."""
    rng = np.random.default_rng(seed)
    q = np.empty((n, 3))
    q[:, :2] = rng.uniform(0.0, 2.0 * L[0], (n, 2))
    q[:, 2] = rng.uniform(0.2, 5.0, n)
    q[2, 2] = 0.0
    q[3] = q[2]
    q[4, 2] = 1.0
    q[6] = q[5] + np.array([0.7, -0.4, 0.3])
    q[7, :2] = (1.25, 2.5)
    q[8, 0] = q[7, 0] + 0.5 * L[0]
    q[9, 1] = q[7, 1] - 0.5 * L[1]
    q[10, :2] = q[7, :2] + 0.5 * np.asarray(L[:2])
    return q


# (Lx, Ly) / a: just above the policy's 4.04, and a wider box
K1_BOXES = {"margin": (4.0625, 4.25, 0.0), "wide": (9.25, 7.75, 0.0)}


@pytest.mark.parametrize("n_rhs", [1, 2])
@pytest.mark.parametrize("box", sorted(K1_BOXES))
def test_k1_fs_plane_sweep_emulated(box, n_rhs):
    """K1 tt_fs's symmetric sweep with PlaneBoxes and the coefficient sums
    against the port's plain product (units of a) and the JAX package's
    pairwise_matvec on free_surface (physical units) at 1e-12."""
    L = K1_BOXES[box]
    boxes = (L, tpk.box_offsets(L))
    assert tpk.plane_far(boxes)
    q = _k1_scene(L)
    v = np.random.default_rng(42).normal(size=(len(q), 3 * n_rhs))
    out = _sweep(len(q), lambda i, j, s, _: _k1_block(q, L, i, j, s), v)
    ref = tpk.pair_plain(torch.as_tensor(q), torch.as_tensor(q),
                         torch.as_tensor(v), coupling="tt",
                         mode="free_surface", self_interaction=True,
                         boxes=boxes)
    assert rel_err(out, ref) < 1e-12
    a = 0.25
    r = q * a
    for b in range(n_rhs):
        jref = np.asarray(jmob.pairwise_matvec(
            jnp.asarray(r), jnp.asarray(r), jnp.asarray(v[:, 3 * b:3 * b + 3]),
            ETA, a, coupling="tt", domain="free_surface",
            periodic_length=tuple(x * a for x in L), method="generic"))
        got = out[:, 3 * b:3 * b + 3] / (8 * math.pi * ETA * a)
        assert rel_err(got, jref) < 1e-12


def test_k1_fs_moments_equal_the_box_sum_of_blocks():
    """The closed coefficient sums are the sum of the nine boxes' condensed
    blocks (fs_condense's A, S, P, Q, mzz into BlockSum), pair by pair:
    the algebra the kernel's fold of dz and Rz rests on."""
    L = K1_BOXES["margin"]
    q = _k1_scene(L, n=12, seed=43)
    for i in range(len(q)):
        for j in range(len(q)):
            dx = _min_image(q[i, 0] - q[j, 0], L[0])
            dy = _min_image(q[i, 1] - q[j, 1], L[1])
            dz, Rz = q[i, 2] - q[j, 2], q[i, 2] + q[j, 2]
            blocks = np.zeros((3, 3))
            for k, (x, y) in enumerate([(dx, dy)] + _far_boxes(dx, dy, L)):
                xy2 = x * x + y * y
                c1, c2, e1, e2 = (_k1_home(xy2 + dz * dz, xy2 + Rz * Rz,
                                           i == j) if k == 0 else
                                  _k1_far(xy2 + dz * dz) + _k1_far(
                                      xy2 + Rz * Rz))
                A, S = c1 + e1, c2 + e2
                P, Q = c2 * dz - e2 * Rz, c2 * dz + e2 * Rz
                mzz = c1 + c2 * dz * dz - e1 - e2 * Rz * Rz
                blocks += np.array([[A + S * x * x, S * x * y, P * x],
                                    [S * x * y, A + S * y * y, P * y],
                                    [Q * x, Q * y, mzz]])
            m = _k1_block(q, L, i, j, i == j)
            assert np.abs(m - blocks).max() <= 1e-13 * np.abs(blocks).max()
            if i != j:      # reciprocity: M(j, i) = M(i, j)^T
                mt = _k1_block(q, L, j, i, False)
                assert np.abs(mt - m.T).max() <= 1e-13 * np.abs(m).max()


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


def _p1_block(r, rad, L, i, j, img_far):
    """fs_box_sum: the home box's pair by its regime, its image by its own
    or in the far form where the tile pair's z test settled it; the eight
    others in the far form."""
    a, b = rad[i], rad[j]
    dx = _min_image(r[i, 0] - r[j, 0], L[0])
    dy = _min_image(r[i, 1] - r[j, 1], L[1])
    dz, Rz = r[i, 2] - r[j, 2], r[i, 2] + r[j, 2]
    m = _Moments()
    xy2 = dx * dx + dy * dy
    m.add(*_p1_rpy(xy2 + dz * dz, a, b, True),
          *_p1_rpy(xy2 + Rz * Rz, a, b, not img_far), dx, dy)
    for x, y in _far_boxes(dx, dy, L):
        xy2 = x * x + y * y
        assert xy2 + dz * dz > (a + b) ** 2
        m.add(*_p1_rpy(xy2 + dz * dz, a, b, False),
              *_p1_rpy(xy2 + Rz * Rz, a, b, False), x, y)
    return m.close(dz, Rz)


def _images_far(r, rad, ti, tj):
    """images_far on the tiles' lowest heights and largest radii."""
    rows_i = slice(ti * TILE, (ti + 1) * TILE)
    rows_j = slice(tj * TILE, (tj + 1) * TILE)
    z = r[rows_i, 2].min() + r[rows_j, 2].min()
    s = rad[rows_i].max() + rad[rows_j].max()
    return z > 0 and z * z > s * s * 1.0001


def _p1_scene(L, radii, n=32, seed=44, raised=False):
    """Blobs in physical units in an (Lx, Ly, 0) box, radii in `radii`
    (one value: one radius): overlapping pairs and one inside another
    (mixed radii), pairs at the half-box tie, a blob at z = a (its own
    image touching) in tile 1 and, unless `raised`, blobs below their
    radius in tiles 0 and 2 (every other blob at least 1.2 a above the
    plane); the ties exact, as _k1_scene's."""
    rng = np.random.default_rng(seed)
    rad = rng.choice(radii, n)
    r = np.empty((n, 3))
    r[:, :2] = rng.uniform(0.0, 2.0 * L[0], (n, 2))
    r[:, 2] = rad * rng.uniform(1.2, 12.0, n)
    r[1] = r[0] + np.array([0.5, 0.3, 0.2]) * (rad[0] + rad[1])
    r[12] = r[11]
    r[13] = r[11] + 0.05 * rad[11]
    r[15, :2] = (0.25, 0.5)
    r[14, 0] = r[15, 0] + 0.5 * L[0]
    r[16, 1] = r[15, 1] - 0.5 * L[1]
    r[17, :2] = r[15, :2] + 0.5 * np.asarray(L[:2])
    r[10, 2] = rad[10]
    if not raised:
        r[3, 2] = 0.4 * rad[3]
        r[20, 2] = 0.0
        r[21] = r[20]
    return r, rad


# (radii, L): one radius and two, L just above 4.04 times the largest
P1_CASES = {"one_radius": ((0.131,), (0.53125, 0.625, 0.0)),
            "mixed": ((0.131, 0.157), (0.640625, 0.71875, 0.0)),
            "mixed_wide": ((0.131, 0.157, 0.2), (2.25, 1.875, 0.0))}


@pytest.mark.parametrize("raised", [False, True])
@pytest.mark.parametrize("case", sorted(P1_CASES))
def test_p1_fs_plane_sweep_emulated(case, raised):
    """P1's free-surface symmetric sweep with PlaneBoxes, the coefficient
    sums and the z test against the port's plain product and the JAX
    package's source_target_matvec at 1e-12 (B = 2)."""
    radii, L = P1_CASES[case]
    r, rad = _p1_scene(L, radii, raised=raised)
    assert min(L[:2]) > tpk.PLANE_FAR_MIN * rad.max()
    v = np.random.default_rng(45).normal(size=(2, len(r), 3))
    vv = np.concatenate([v[0], v[1]], axis=1)
    tested = []

    def tile_far(ti, tj):
        far = _images_far(r, rad, ti, tj)
        tested.append(far)
        return far

    out = _sweep(len(r), lambda i, j, s, far: _p1_block(r, rad, L, i, j, far),
                 vv, tile_far)
    # the z test passes on the tile pairs of blobs above their radius and
    # refuses those with a blob below it or one at z = a
    assert any(tested) and not all(tested)
    ref = to_np(tmc.radii_matvec_plain(
        torch.as_tensor(r), torch.as_tensor(v), torch.as_tensor(rad), ETA,
        domain="free_surface", periodic_length=L))
    pref = 1.0 / (8 * math.pi * ETA)
    for b in range(2):
        got = out[:, 3 * b:3 * b + 3] * pref
        assert rel_err(got, ref[b]) < 1e-12
        jref = np.asarray(jmob.source_target_matvec(
            jnp.asarray(r), jnp.asarray(r), jnp.asarray(v[b]),
            jnp.asarray(rad), jnp.asarray(rad), ETA, domain="free_surface",
            periodic_length=L))
        assert rel_err(got, jref) < 1e-12


def test_p1_z_test_refuses_tiles_below_their_radius():
    """images_far passes only tile pairs whose every image is far, and
    refuses a diagonal tile holding a blob below its radius or one at z =
    a; those images do touch: the image's far form forced there misses
    the plain product, while the test's choice meets it."""
    radii, L = P1_CASES["mixed"]
    r, rad = _p1_scene(L, radii)
    r[20:22, 2] = 0.5 * rad[20:22]      # below a, off the plane
    n_tiles = -(-len(r) // TILE)
    low = {3 // TILE, 20 // TILE, 10 // TILE}
    assert len(low) == 3 and n_tiles == 4
    for ti in range(n_tiles):
        for tj in range(ti, n_tiles):
            far = _images_far(r, rad, ti, tj)
            rows_i = range(ti * TILE, (ti + 1) * TILE)
            rows_j = range(tj * TILE, (tj + 1) * TILE)
            if far:
                assert all((r[i, 2] + r[j, 2]) ** 2 > (rad[i] + rad[j]) ** 2
                           for i in rows_i for j in rows_j)
            if ti == tj:
                assert far == (ti not in low)
    v = np.random.default_rng(46).normal(size=(len(r), 3))
    ref = to_np(tmc.radii_matvec_plain(
        torch.as_tensor(r), torch.as_tensor(v[None]), torch.as_tensor(rad),
        ETA, domain="free_surface", periodic_length=L))[0]
    pref = 1.0 / (8 * math.pi * ETA)
    block = lambda i, j, s, far: _p1_block(r, rad, L, i, j, far)  # noqa: E731
    forced = _sweep(len(r), block, v, lambda ti, tj: True) * pref
    assert rel_err(forced, ref) > 1e-6
    tested = _sweep(len(r), block, v,
                    lambda ti, tj: _images_far(r, rad, ti, tj)) * pref
    assert rel_err(tested, ref) < 1e-12


def test_p1_one_radius_is_k1():
    """At one radius P1's free-surface box sum is K1 tt_fs's: the blocks
    in physical units at a = 1 equal _k1_block's, every box far or not."""
    L = K1_BOXES["margin"]
    q = _k1_scene(L, n=14, seed=47)
    rad = np.ones(len(q))
    for i in range(len(q)):
        for j in range(len(q)):
            if i == j or (q[i] == q[j]).all() or q[i, 2] + q[j, 2] == 0:
                # K1's self and coincident rules (4/3, 0 and an image at R
                # = 0 of 0), where P1 takes the inside regime
                continue
            k1 = _k1_block(q, L, i, j, False)
            p1 = _p1_block(q, rad, L, i, j, False)
            assert np.abs(k1 - p1).max() <= 1e-13 * np.abs(k1).max()
