"""The image-box instances of kernels K1 and K3 as csrc/pair_blocks.cuh and
csrc/dense_tt.cu compute them, on the CPU:

- the identity K3's triangle grid rests on: the JAX package's
  `dense_mobility_tiled` with a periodic_length (float64) is symmetric,
  block (j, i) = block (i, j)^T, on a scene with pairs at the half-box
  tie, above the wall and without it, to 1e-12;
- the host's choice of the in-plane far policy (csrc/pair_blocks.cuh
  `plane_boxes`, which picks PlaneBoxes from the arrays `_box_args`
  passes, written out here, and ops/pair_kernels.py `plane_far`, its
  mirror for the launch plan): taken for the pseudo-periodic paths'
  boxes, refused for a box periodic in z, for L / a <= 4.04, for a list
  that does not start at the home box and for other lists; and the
  float32 geometry it rests on, every box off the home box outside
  contact (r^2 > 4) at the margin's box and at the ties;
- the in-plane symmetric sweep of the diagonal couplings written out in
  numpy as the kernel forms it: the minimum image, the home box in the
  full form and the other eight in the far form, a pair's boxes summed
  into one 3 x 3 block (BlockSum, from tt_condense's and rr_condense's
  scalars) applied as M to v_j and as M^T to v_i, the diagonal directed
  with the self block in the home box; against the plain product at
  1e-12;
- K3's triangle grid written out as the kernel walks it: every matrix
  entry written exactly once, tile (J, I) the transpose of tile (I, J),
  against the plain builder at 1e-12.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rigidmultiblobswall_tpu.ops import mobility as jmob
from rigidmultiblobswall_tpu_torch.ops import mobility as tmob
from rigidmultiblobswall_tpu_torch.ops import mobility_cuda as tmc
from rigidmultiblobswall_tpu_torch.ops import pair_kernels as tpk

from test_torch_k1_algebra import _group_pair, _rr_wall, _tt_wall
from torch_parity import random_blobs, rel_err, to_np

A, ETA = 0.25, 0.9


# ---------------------------------------------------------------------------
# The symmetry of the box-summed matrix (K3's triangle grid)
# ---------------------------------------------------------------------------

def _tie_scene(L, n=14, seed=3):
    """Blobs in physical units with pairs at the half-box tie on both
    periodic axes (x_i - x_j = +-L/2 exactly, in units of a too: a is a
    power of two) and the rest at random, some below a."""
    rng = np.random.default_rng(seed)
    r = np.empty((n, 3))
    r[:, :2] = rng.uniform(0.0, 2.0 * L[0], (n, 2))
    r[:, 2] = rng.uniform(0.05, 3.0, n)
    r[1, 0] = r[0, 0] + 0.5 * L[0]           # x tie
    r[2, 1] = r[0, 1] - 0.5 * L[1]           # y tie
    r[3, :2] = r[0, :2] + 0.5 * np.asarray(L[:2])   # both
    r[5] = r[4]                              # coincident
    return r


@pytest.mark.parametrize("domain", ["single_wall", "no_wall"])
def test_dense_box_sum_is_symmetric_at_the_half_box_tie(domain):
    """The JAX package's dense matrix with images, x64: M[3j+b, 3i+a] =
    M[3i+a, 3j+b] at 1e-12, the tie pairs included (min_image is odd in
    d there too), though a single box's wall block is not symmetric."""
    L = (3.0, 2.5, 0.0)
    r = _tie_scene(L)
    d = r[1, 0] - r[0, 0]
    assert d / L[0] == 0.5
    planes = np.asarray(jmob.dense_mobility_tiled(
        jnp.asarray(r), ETA, A, domain=domain, periodic_length=L))
    n = len(r)
    m = planes.transpose(2, 0, 3, 1).reshape(3 * n, 3 * n)
    assert np.abs(m - m.T).max() <= 1e-12 * np.abs(m).max()
    # the images matter at this box
    open_ = np.asarray(jmob.dense_mobility_tiled(
        jnp.asarray(r), ETA, A, domain=domain))
    open_m = open_.transpose(2, 0, 3, 1).reshape(3 * n, 3 * n)
    assert np.abs(m - open_m).max() > 1e-2 * np.abs(m).max()


# ---------------------------------------------------------------------------
# The host's choice of the in-plane far policy
# ---------------------------------------------------------------------------

def _boxes(L):
    return tuple(L), tpk.box_offsets(L)


def _k_plane_far_min():
    """csrc/pair_blocks.cuh's kPlaneFarMin, read from the source."""
    src = (Path(tpk.__file__).parents[1] / "csrc"
           / "pair_blocks.cuh").read_text()
    return float(re.search(r"constexpr double kPlaneFarMin = ([0-9.]+);",
                           src).group(1))


def _kernel_takes_plane(boxes):
    """csrc/pair_blocks.cuh plane_boxes on the C arguments of _box_args:
    nine boxes, L = (Lx, Ly, 0) with both above kPlaneFarMin, and box k
    the (k == 0 ? 4 : k - 1 + (k >= 5)) th of the 3 x 3 list in x-major
    order, b L exactly."""
    L, n_boxes, off = tpk._box_args(boxes)
    k_min = _k_plane_far_min()
    if n_boxes != 9 or not (L[0] > k_min and L[1] > k_min and L[2] == 0.0):
        return False
    for k in range(9):
        idx = 4 if k == 0 else k - 1 + (k >= 5)
        if (off[3 * k] != (idx // 3 - 1) * L[0]
                or off[3 * k + 1] != (idx % 3 - 1) * L[1]
                or off[3 * k + 2] != 0.0):
            return False
    return True


# the pseudo-periodic paths' boxes in units of a (chip_smoke.py phase 20:
# 20a, 20b with a = 0.131, 20c with a = 0.5, 20d with a = 1)
PATH_BOXES = {"20a": (25.6 / 0.131, 25.6 / 0.131, 0.0),
              "20b": (17.6 / 0.131, 17.6 / 0.131, 0.0),
              "20c": (291.2 / 0.5, 291.2 / 0.5, 0.0),
              "20d": (153.6, 153.6, 0.0),
              "margin": (4.05, 4.2, 0.0)}


@pytest.mark.parametrize("box", sorted(PATH_BOXES))
def test_plane_far_is_taken_for_the_in_plane_boxes(box):
    boxes = _boxes(PATH_BOXES[box])
    assert len(boxes[1]) == 9
    assert tpk.plane_far(boxes)
    assert _kernel_takes_plane(boxes)
    assert _k_plane_far_min() == tpk.PLANE_FAR_MIN


REFUSED = {
    "z_periodic": _boxes((23.0, 19.0, 21.0)),
    "L_below_margin": _boxes((4.04, 10.0, 0.0)),
    "L_at_4": _boxes((4.0, 4.0, 0.0)),
    "L_3": _boxes((3.0, 3.0, 0.0)),
    "one_axis": _boxes((10.0, 0.0, 0.0)),
    "home_not_first": ((23.0, 19.0, 0.0),
                       tpk.box_offsets((23.0, 19.0, 0.0))[::-1]),
    "other_order": ((23.0, 19.0, 0.0),
                    [(0, 0, 0)] + tpk.box_offsets((23.0, 19.0, 0.0))[:0:-1]),
    "home_only": ((23.0, 19.0, 0.0), [(0, 0, 0)]),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_plane_far_is_refused_elsewhere(case):
    """Every other list keeps the general policy (ImageBoxes)."""
    boxes = REFUSED[case]
    assert not tpk.plane_far(boxes)
    assert not _kernel_takes_plane(boxes)
    assert not tpk.plane_far(None)


@pytest.mark.parametrize("L", [(4.05, 4.05), (4.0401, 7.3),
                               PATH_BOXES["20a"][:2]])
def test_far_boxes_stay_outside_contact_in_float32(L):
    """PlaneBoxes' far form rests on r^2 > 4 in every box off the home
    box, formed as the float32 instance forms it: the minimum image in
    float64 rounded to float32, d + b L and the squares in float32. Pairs
    at and beside the half-box tie, at zero, and at random."""
    f32 = np.float32
    rng = np.random.default_rng(9)
    n = 20000
    d = np.concatenate([rng.uniform(-3 * L[0], 3 * L[0], (n, 2)),
                        np.array([[0.5 * L[0], 0.5 * L[1]],
                                  [-0.5 * L[0], -0.5 * L[1]],
                                  [0.0, 0.0],
                                  [np.nextafter(0.5 * L[0], 0.0),
                                   np.nextafter(-0.5 * L[1], 0.0)],
                                  [np.nextafter(0.5 * L[0], 1.0),
                                   np.nextafter(-0.5 * L[1], -1.0)]])])
    dz = np.concatenate([rng.uniform(-0.5, 0.5, n), np.zeros(5)]).astype(f32)
    img = []
    for ax in range(2):
        half = np.where(d[:, ax] > 0, 0.5, np.where(d[:, ax] < 0, -0.5, 0.0))
        inv = 1.0 / L[ax]
        img.append((d[:, ax] - np.trunc(d[:, ax] * inv + half) * L[ax])
                   .astype(f32))
    Lx, Ly = f32(L[0]), f32(L[1])
    for bx in (-1, 0, 1):
        for by in (-1, 0, 1):
            if bx == by == 0:
                continue
            x = (img[0] + f32(bx) * Lx).astype(f32)
            y = (img[1] + f32(by) * Ly).astype(f32)
            r2 = (x * x + y * y).astype(f32) + dz * dz
            assert (r2 > f32(4)).all(), (bx, by, r2.min())


# ---------------------------------------------------------------------------
# The in-plane symmetric sweep of tt and rr, written out as the kernel
# forms it (PlaneBoxes, BlockSum)
# ---------------------------------------------------------------------------

def _core(coupling, r2, zero, self_, far):
    """The RPY core coefficients (c1, c2) of tt_condense / rr_condense:
    the far form, or in the home box the near and zero forms."""
    r = np.sqrt(r2)
    invr = 1.0 / r if r2 > 0 else np.inf
    if coupling == "tt":
        c1 = (1 + 2.0 / 3.0 * invr * invr) * invr
        c2 = (1 - 2 * invr * invr) * invr * invr * invr
        if not far and r2 <= 4:
            if zero:
                return (4.0 / 3.0 if self_ else 0.0), 0.0
            return 4.0 / 3.0 - 0.375 * r, 0.125 * invr
        return c1, c2
    c1 = -0.5 * invr ** 3
    c2 = 1.5 * invr ** 5
    if not far and r2 <= 4:
        if zero:
            return (1.0 if self_ else 0.0), 0.0
        return (1 - 0.84375 * r + 0.078125 * r ** 3,
                0.28125 * invr - 0.046875 * r)
    return c1, c2


def _condense(coupling, dx, dy, dz, zt, zs, wall, self_, far):
    """(A, S, P, Q, mzz) of one box, the core plus the wall terms."""
    r2 = dx * dx + dy * dy + dz * dz
    c1, c2 = _core(coupling, r2, self_ or r2 == 0, self_, far)
    A, S, P, Q, mzz = c1, c2, c2 * dz, c2 * dz, c1 + c2 * dz * dz
    if wall:
        w = (_tt_wall if coupling == "tt" else _rr_wall)(dx, dy, zt, zs)
        A, S, P, Q, mzz = (A + w[0], S + w[1], P + w[2], Q + w[3],
                           mzz + w[4])
    return A, S, P, Q, mzz


def _block_sum(coupling, dx, dy, dz, zt, zs, L, wall, self_):
    """PlaneBoxes' nine boxes summed into BlockSum's 3 x 3 block (closed):
    the home box first in the full form, then (bx, by) row-major without
    (0, 0) in the far form."""
    ox = (dx - L[0], dx, dx + L[0])
    oy = (dy - L[1], dy, dy + L[1])
    s = dict.fromkeys(("a", "xx", "xy", "yy", "xz", "yz", "zx", "zy", "zz"),
                      0.0)
    for k in range(9):
        idx = 4 if k == 0 else k - 1 + (1 if k >= 5 else 0)
        x, y = ox[idx // 3], oy[idx % 3]
        Am, S, P, Q, mzz = _condense(coupling, x, y, dz, zt, zs, wall,
                                     self_ and k == 0, k != 0)
        s["a"] += Am
        s["xx"] += S * x * x
        s["xy"] += S * x * y
        s["yy"] += S * y * y
        s["xz"] += P * x
        s["yz"] += P * y
        s["zx"] += Q * x
        s["zy"] += Q * y
        s["zz"] += mzz
    return np.array([[s["xx"] + s["a"], s["xy"], s["xz"]],
                     [s["xy"], s["yy"] + s["a"], s["yz"]],
                     [s["zx"], s["zy"], s["zz"]]])


def _min_image(d, L, inv_L):
    half = 0.5 if d > 0 else (-0.5 if d < 0 else 0.0)
    return d - np.trunc(d * inv_L + half) * L


@pytest.mark.parametrize("n_rhs", [1, 2])
@pytest.mark.parametrize("wall", [True, False])
@pytest.mark.parametrize("coupling", ["tt", "rr"])
def test_in_plane_block_sum_sweep_emulated(coupling, wall, n_rhs):
    """The symmetric sweep with PlaneBoxes and BlockSum: for i < j one
    box-summed block M of (i, j), M v_j to i and M^T v_i to j; i = j the
    directed pass with the self block in the home box; equals the plain
    product with images at 1e-12 (pairs inside contact and a coincident
    pair in the home box, a tie)."""
    L = (6.1, 5.3, 0.0)
    r, _ = random_blobs(n=12, seed=31, a=A)
    r[:, :2] *= 3.0
    r[7] = r[6]
    r[9, 0] = r[8, 0] + 0.5 * L[0] * A
    q, _ = tmob._normalized(torch.as_tensor(r), A, wall, torch.float64)
    qn = q.numpy()
    assert tpk.plane_far(_boxes(L))
    rng = np.random.default_rng(32)
    v = rng.normal(size=(len(r), 3 * n_rhs))
    out = np.zeros_like(v)
    inv_L = (1.0 / L[0], 1.0 / L[1])
    for i in range(len(r)):
        for j in range(i, len(r)):
            dx = _min_image(qn[i, 0] - qn[j, 0], L[0], inv_L[0])
            dy = _min_image(qn[i, 1] - qn[j, 1], L[1], inv_L[1])
            m = _block_sum(coupling, dx, dy, qn[i, 2] - qn[j, 2], qn[i, 2],
                           qn[j, 2], L, wall, i == j)
            for b in range(n_rhs):
                out[i, 3 * b:3 * b + 3] += m @ v[j, 3 * b:3 * b + 3]
                if i != j:
                    out[j, 3 * b:3 * b + 3] += m.T @ v[i, 3 * b:3 * b + 3]
    ref = tpk.pair_plain(q, q, torch.as_tensor(v), coupling=coupling,
                         mode=tpk.wall_mode(wall), self_interaction=True,
                         boxes=_boxes(L))
    assert rel_err(out, to_np(ref)) < 1e-12


# ---------------------------------------------------------------------------
# K3's triangle grid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kb, n", [(32, 70), (32, 32), (16, 40), (16, 5)])
@pytest.mark.parametrize("L", [(0.0, 0.0, 0.0), (3.0, 2.5, 0.0)])
def test_k3_triangle_grid_emulated(kb, n, L):
    """dense_tt_kernel's walk: blocks over the upper triangle of square
    tiles of kb blobs (group_pair), each condensing its pairs (I < J: all;
    I = J: i <= j, mirrored, a blob's own block by its upper entries) into
    a (3 kb)^2 tile, writing tile (I, J) and, off the diagonal, its
    transpose as tile (J, I), masked at the ragged edge. Every entry is
    written once, the matrix is its exact transpose and the plain
    builder's at 1e-12."""
    rng = np.random.default_rng(5)
    r = rng.uniform(0.0, 6.0, (n, 3))
    r[:, 2] = rng.uniform(0.05, 3.0, n)
    rt = torch.as_tensor(r)
    ref = to_np(tmc.dense_tt_plain(rt, ETA, A, mode="wall",
                                   periodic_length=L))
    n_tiles = -(-n // kb)
    out = np.full((3 * n, 3 * n), np.nan)
    writes = np.zeros((3 * n, 3 * n), int)
    for p in range(n_tiles * (n_tiles + 1) // 2):
        ti, tj = _group_pair(p, n_tiles)
        i0, j0 = ti * kb, tj * kb
        diag = ti == tj
        tile = np.full((3 * kb, 3 * kb), np.nan)
        for li in range(kb):
            for lj in range(kb):
                if diag and li > lj:
                    continue
                i, j = i0 + li, j0 + lj
                if i >= n or j >= n:
                    blk = np.zeros((3, 3))      # padded blobs: masked
                else:
                    blk = ref[3 * i:3 * i + 3, 3 * j:3 * j + 3]
                if diag and li == lj:       # a blob's own block: its upper
                    blk = np.triu(blk) + np.triu(blk, 1).T   # entries
                tile[3 * li:3 * li + 3, 3 * lj:3 * lj + 3] = blk
                if diag and li != lj:
                    tile[3 * lj:3 * lj + 3, 3 * li:3 * li + 3] = blk.T
        rows_i = 3 * min(kb, n - i0)
        rows_j = 3 * min(kb, n - j0)
        for rr in range(3 * kb):
            for cc in range(3 * kb):
                if rr < rows_i and cc < rows_j:
                    out[3 * i0 + rr, 3 * j0 + cc] = tile[rr, cc]
                    writes[3 * i0 + rr, 3 * j0 + cc] += 1
                if not diag and rr < rows_j and cc < rows_i:
                    out[3 * j0 + rr, 3 * i0 + cc] = tile[cc, rr]
                    writes[3 * j0 + rr, 3 * i0 + cc] += 1
    assert (writes == 1).all()
    assert np.isfinite(out).all()
    assert (out == out.T).all()
    assert np.abs(out - ref).max() <= 1e-12 * np.abs(ref).max()
