"""Kernel L1's symmetric sweep (csrc/laplace_layers.cu l1_sym) emulated
in float64 numpy on the CPU, held against the port's plain versions
(ops/laplace.py) and the JAX package's operators (rigidmultiblobswall_tpu/
ops/laplace.py, models/phoretic.py's fused sums) to 1e-12 x max|ref|.

The emulation walks what the kernel walks: the group pairs (GA <= GB) of
the upper triangle in pairk::group_pair's order over plan_groups' tile
groups; in each, the diagonal tile's ordered pairs and every other tile
pair's unordered pairs once, with the mirrored terms seen from the source
(r_ji = -r_ij, R_ji = (-dx, -dy, z_i + z_j): L even, the image's L_xz and
L_yz odd, the other end's normal and coefficients); the workspace slices
owned one block each, summed in order. So a wrong sign in a mirrored term
or a slice that two blocks write shows here before the card runs it. The
reduce-scatter that returns the source sums to the lanes is emulated on a
32-lane warp."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rigidmultiblobswall_tpu.ops import laplace as jl
from rigidmultiblobswall_tpu_torch.ops import laplace as tl
from rigidmultiblobswall_tpu_torch.ops import pair_kernels as pk

TILE = 128
OPS = ("S", "D", "dD", "T", "bvp", "grad")
DC = 0.7


def _inputs(n=300, seed=4):
    """Blobs above the wall: one on it (its own image at zero distance),
    two distinct coincident blobs in the first and last tiles, two on the
    wall at equal x, y (a zero image distance), unit normals, the field,
    weights and rates."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(0, 6, (n, 3))
    r[:, 2] = rng.uniform(0, 3, n)
    r[0, 2] = 0.0
    r[5] = r[n - 3]
    r[10] = (1.5, 2.5, 0.0)
    r[n - 20] = (1.5, 2.5, 0.0)
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return (r, nrm, rng.normal(size=n), rng.uniform(0.1, 1.0, n),
            rng.uniform(0.0, 5.0, n), rng.uniform(0.0, 1.0, n))


def group_pair(p, n):
    """pairk::group_pair: (A, B) of upper-triangle pair p, row-major."""
    def start(row):
        return row * n - row * (row - 1) // 2

    t = 2.0 * n + 1.0
    r = int((t - math.sqrt(t * t - 8.0 * p)) * 0.5)
    while r > 0 and start(r) > p:
        r -= 1
    while r + 1 < n and start(r + 1) <= p:
        r += 1
    return r, r + (p - start(r))


def _blobs(op, r, nrm, c, w, k, q):
    """Each blob's row as the kernel stages it: position, a = c w, and the
    normal and b where the operator reads them (else 0)."""
    zero = np.zeros(len(c))
    with_n = op not in ("S", "T")
    b = {"bvp": k * c / DC * w, "grad": (q - k * c) / DC * w}.get(op, zero)
    n = nrm if with_n else np.zeros_like(nrm)
    return dict(x=r[:, 0], y=r[:, 1], z=r[:, 2], a=c * w, nx=n[:, 0],
                ny=n[:, 1], nz=n[:, 2], b=b)


def _terms(op, dx, dy, dz, inv, inv_s):
    """csrc/laplace_layers.cu pair_terms."""
    t = dict(inv_s=inv_s, inv3=inv ** 3)
    if op in ("dD", "grad"):
        fo = -3.0 * inv * inv
        t.update(lxx=(1.0 + fo * dx * dx) * t["inv3"],
                 lxy=fo * dx * dy * t["inv3"], lxz=fo * dx * dz * t["inv3"],
                 lyy=(1.0 + fo * dy * dy) * t["inv3"],
                 lyz=fo * dy * dz * t["inv3"])
        t["lzz"] = -t["lxx"] - t["lyy"]
    return t


def _apply(op, odd, t, ex, ey, ez, nx, ny, nz, a, b):
    """csrc/laplace_layers.cu apply: one direction's terms, (..., C)."""
    if op == "S":
        return (a * t["inv_s"])[..., None]
    if op in ("D", "bvp"):
        rn = ex * nx + ey * ny + ez * nz
        v = a * rn * t["inv3"]
        return (v if op == "D" else b * t["inv_s"] - v)[..., None]
    if op == "T":
        s = a * t["inv3"]
        return np.stack([s * ex, s * ey, s * ez], axis=-1)
    sign = -1.0 if odd else 1.0
    lxz, lyz = sign * t["lxz"], sign * t["lyz"]
    g = np.stack([t["lxx"] * nx + t["lxy"] * ny + lxz * nz,
                  t["lxy"] * nx + t["lyy"] * ny + lyz * nz,
                  lxz * nx + lyz * ny + t["lzz"] * nz], axis=-1)
    if op == "dD":
        return a[..., None] * g
    s = b * t["inv3"]
    return a[..., None] * g - s[..., None] * np.stack([ex, ey, ez], axis=-1)


def _pair(op, wall, bl, i, j, both):
    """csrc/laplace_layers.cu pair over targets i x sources j: the targets'
    sums (len(i), C) and, with both, the sources' (len(j), C)."""
    ti = {key: v[i][:, None] for key, v in bl.items()}
    sj = {key: v[j][None, :] for key, v in bl.items()}
    dx, dy, dz = ti["x"] - sj["x"], ti["y"] - sj["y"], ti["z"] - sj["z"]
    xy2 = dx * dx + dy * dy
    d2 = xy2 + dz * dz
    with np.errstate(divide="ignore"):
        inv = np.where(d2 == 0.0, 0.0, 1.0 / np.sqrt(d2))
    t = _terms(op, dx, dy, dz, inv, inv)
    acc = _apply(op, False, t, dx, dy, dz, sj["nx"], sj["ny"], sj["nz"],
                 sj["a"], sj["b"])
    cj = _apply(op, False, t, -dx, -dy, -dz, ti["nx"], ti["ny"], ti["nz"],
                ti["a"], ti["b"]) if both else 0.0
    if wall:
        rz = ti["z"] + sj["z"]
        d2w = xy2 + rz * rz
        with np.errstate(divide="ignore"):
            invw = np.where(d2w == 0.0, 0.0, 1.0 / np.sqrt(d2w))
        tw = _terms(op, dx, dy, rz, invw, np.where(d2w == 0.0, 1.0, invw))
        acc = acc + _apply(op, False, tw, dx, dy, rz, sj["nx"], sj["ny"],
                           -sj["nz"], sj["a"], sj["b"])
        if both:
            cj = cj + _apply(op, True, tw, -dx, -dy, rz, ti["nx"],
                             ti["ny"], -ti["nz"], ti["a"], ti["b"])
    return acc.sum(axis=1), (cj.sum(axis=0) if both else None)


def sym_sweep(op, wall, r, nrm, c, w, k, q, groups, per):
    """The symmetric sweep over the blobs r, as the kernel walks it and
    with its workspace (G, N, C): every (slice, tile) entry zeroed and
    written by one block, the slices summed in order, scaled, plus c/2
    for the BVP operator."""
    n = r.shape[0]
    n_tiles = -(-n // TILE)
    assert groups * per >= n_tiles
    nout = tl.NOUT[op]
    bl = _blobs(op, r, nrm, c, w, k, q)
    ws = np.full((groups, n, nout), np.nan)
    owner = {}

    def rows(tile):
        return np.arange(tile * TILE, min(n, (tile + 1) * TILE))

    for p in range(groups * (groups + 1) // 2):
        ga, gb = group_pair(p, groups)
        a_tiles = range(ga * per, min(n_tiles, (ga + 1) * per))
        b_tiles = range(gb * per, min(n_tiles, (gb + 1) * per))
        for sl, tiles in ((gb, a_tiles), (ga, b_tiles)):
            for tile in tiles:
                assert owner.setdefault((sl, tile), p) == p, (sl, tile)
                ws[sl, rows(tile)] = 0.0
        for ta in a_tiles:
            run = 0.0
            for tb in (range(ta, b_tiles.stop) if ga == gb else b_tiles):
                if tb == ta:  # the diagonal tile: every ordered pair
                    acc, _ = _pair(op, wall, bl, rows(ta), rows(ta), False)
                else:
                    acc, cj = _pair(op, wall, bl, rows(ta), rows(tb), True)
                    ws[ga, rows(tb)] += cj
                run = run + acc
            ws[gb, rows(ta)] += run
    assert len(owner) == groups * n_tiles
    assert np.isfinite(ws).all()
    out = np.zeros((n, nout))
    for sl in range(groups):
        out += ws[sl]
    out *= (0.5 if op == "grad" else 0.25) / math.pi
    if op == "bvp":
        out += 0.5 * c[:, None]
    return out if nout == 3 else out[:, 0]


def _plain(op, wall, self_interaction, r, nrm, c, w, k, q):
    T = torch.as_tensor
    if op == "bvp":
        return tl.bvp_operator_plain(T(r), T(c), T(w), T(nrm), T(k), DC,
                                     wall=wall).numpy()
    if op == "grad":
        return tl.surface_gradient_plain(T(r), T(c), T(w), T(nrm), T(k),
                                         T(q), DC, wall=wall).numpy()
    fn = {"S": tl.single_layer_plain, "D": tl.double_layer_plain,
          "dD": tl.deriv_double_layer_plain, "T": tl.dipole_plain}[op]
    extra = (T(nrm),) if op in ("D", "dD") else ()
    return fn(T(r), T(r), T(c), T(w), *extra, wall=wall,
              self_interaction=self_interaction).numpy()


def _jax(op, wall, self_interaction, r, nrm, c, w, k, q):
    """The JAX package's operator on the blobs as targets; the fused sums
    composed as its models/phoretic.py phoretic_slip composes them."""
    J = jnp.asarray
    r, nrm, c, w, k, q = map(J, (r, nrm, c, w, k, q))
    if op == "bvp":
        x = 0.5 * c - jl.double_layer(r, r, c, w, nrm, wall=wall)
        return x + jl.single_layer(r, r, k * c / DC, w, wall=wall)
    if op == "grad":
        g = 2.0 * jl.deriv_double_layer(r, r, c, w, nrm, wall=wall)
        return g - 2.0 * jl.dipole(r, r, (q - k * c) / DC, w, wall=wall)
    fn = {"S": jl.single_layer, "D": jl.double_layer,
          "dD": jl.deriv_double_layer, "T": jl.dipole}[op]
    extra = (nrm,) if op in ("D", "dD") else ()
    return fn(r, r, c, w, *extra, wall=wall,
              self_interaction=self_interaction)


def _close(got, ref, tol=1e-12):
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    scale = np.abs(ref).max()
    assert scale > 0
    assert np.abs(got - ref).max() <= tol * scale


# (N, plan): plan_groups' plan on a 132-SM card (three groups of one
# ragged tile), and two groups of two tiles, one group of three
PLANS = {"plan_groups": (300, None), "two_tile_groups": (300, (2, 2)),
         "one_group": (300, (1, 3))}


@pytest.mark.parametrize("plan", list(PLANS))
@pytest.mark.parametrize("wall", [False, True])
@pytest.mark.parametrize("op", OPS)
def test_symmetric_sweep_matches_plain_and_jax(op, wall, plan):
    n, groups_per = PLANS[plan]
    args = _inputs(n)
    groups, per = groups_per or pk.plan_groups(n, 132)
    got = sym_sweep(op, wall, *args, groups, per)
    for self_interaction in ((True,) if op in ("bvp", "grad")
                             else (True, False)):
        _close(got, _plain(op, wall, self_interaction, *args))
        _close(got, _jax(op, wall, self_interaction, *args))


def test_plan_groups_cover_the_tiles():
    """The plans the wrapper launches: every tile in one group, every
    group non-empty, at the card's shapes and ragged small ones."""
    for n in (1, 100, 300, 1500, 20000, 49152):
        groups, per = pk.plan_groups(n, 132)
        tiles = -(-n // TILE)
        assert groups * per >= tiles > (groups - 1) * per
    assert pk.plan_groups(49152, 132) == (128, 3)


@pytest.mark.parametrize("groups", [1, 2, 3, 128, 301])
def test_group_pair_walks_the_upper_triangle(groups):
    pairs = [group_pair(p, groups)
             for p in range(groups * (groups + 1) // 2)]
    assert pairs == [(a, b) for a in range(groups)
                     for b in range(a, groups)]


@pytest.mark.parametrize("levels", [3, 4, 5])
def test_reduce_scatter_returns_each_source_sum_to_its_lanes(levels):
    """sweep_broadcast's reduce-scatter on a 32-lane warp: a batch of
    2^L sources pushed one at a time through the binary counter (the
    lanes with the level's mask bit keep the newer half), then the
    butterfly over the low 5 - L lane bits; lane l ends with the sum over
    the 32 lanes of source src(l), bit m of src = lane bit 4 - m."""
    rng = np.random.default_rng(levels)
    B, G = 1 << levels, 32 >> levels
    v = rng.normal(size=(32, B))       # lane l's share of source k
    lanes = np.arange(32)
    pend = {}
    for kk in range(B):
        val = v[:, kk].copy()
        for m in range(levels):
            if (kk >> m) & 1:
                mask = 16 >> m
                hi = (lanes & mask) != 0
                send = np.where(hi, pend[m], val)
                keep = np.where(hi, val, pend[m])
                val = keep + send[lanes ^ mask]
            else:
                pend[m] = val
                break
    mask = 1
    while mask < G:
        val = val + val[lanes ^ mask]
        mask <<= 1
    src = sum(((lanes >> (4 - m)) & 1) << m for m in range(levels))
    np.testing.assert_allclose(val, v.sum(axis=0)[src], rtol=1e-12)
    writers = lanes[(lanes & (G - 1)) == 0]
    assert sorted(src[writers]) == list(range(B))
