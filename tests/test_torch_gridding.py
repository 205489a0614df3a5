"""The spectral gridding of the PyTorch port: `spread` and `interpolate`
of ops/ewald.py, kernels G1 and G2 on the card (ops/grid_kernels.py,
csrc/gridding.cu) and their plain versions `spread_plain` and
`interpolate_plain` on the CPU.

- The plain versions against the JAX package's `spread` and
  `interpolate` in float64 on a (32, 30, 32) grid for window supports 6
  and 9 and C = 3, 6, 9 and 18 channels, after an `update_plan` refresh
  that moves every particle off its sort-time position (the x planes
  from the sort-time position, y and z from the current one), to 1e-11.
- The adjoint identity <S f, u> = <f, S^T u>, whole and on a slab with
  ids, to 1e-12; the slabs of a partition of the x planes (`planes`, the
  ids of `plane_particles`) concatenate to the whole spread and their
  interpolation rows sum to the whole interpolation; ids alone spread as
  the masked forces do.
- Dispatch: on the CPU `spread` and `interpolate` (and the wave product
  above them) never reach the kernel wrappers; the wrappers refuse CPU
  tensors and what the kernels do not take; the channel blocks a call
  launches cover C once; the kernels' walk in sort-time x order, with
  each point's row of the forces and outputs, is the same function.
- On the card (marked `gpu`, skipped without one; this file imports JAX
  only inside the fixture of its JAX tests, so the machine with the card
  runs `python -m pytest --noconftest -q -m gpu
  tests/test_torch_gridding.py`): G1 and G2 in float64 against the
  plain versions to 1e-12, and in float32 against the float64 plain
  version within twice the float32 plain version's own error plus
  u32 sqrt(P^3) max|ref| (both float32 versions take the same float32
  offsets; the kernels sum in another order), for C = 3, 6, 9, 12 and 18,
  with ids, with planes and ids, and on a wall view whose image points
  lie at negative z; G2 bit-identical on repeat and in the caller's order
  of the points as in the kernels' sort-time x order.
"""

import dataclasses

import numpy as np
import pytest
import torch

from rigidmultiblobswall_tpu_torch.ops import ewald as tew
from rigidmultiblobswall_tpu_torch.ops import ewald_wall as tww
from rigidmultiblobswall_tpu_torch.ops import grid_kernels as gk

A, ETA = 0.5, 1.3
# a (32, 30, 32) grid and 4 cells a side with room for a plan refresh's
# drift (0.08 on y)
BOX = (12.0, 11.0, 12.5)
TOL, GRID_MAX, R_CUT_FACTOR = 0.5, 32, 4.6
U32 = float(np.finfo(np.float32).eps / 2)


@pytest.fixture(scope="module")
def jew():
    """The JAX package's ewald module (imported here, so the card's
    `-m gpu --noconftest` run never imports JAX)."""
    from rigidmultiblobswall_tpu.ops import ewald
    return ewald


def _np(t):
    return t.detach().cpu().numpy()


def _rel(got, ref):
    ref = np.asarray(ref)
    return float(np.abs(np.asarray(got) - ref).max() / np.abs(ref).max())


def _params(support):
    return tew.default_params(A, ETA, BOX, tol=TOL, grid_max=GRID_MAX,
                              support=support, r_cut_factor=R_CUT_FACTOR)


def _scene(n=60, seed=0):
    """Positions over the box and past its faces, and the same particles
    drifted by up to 0.07 a coordinate (a plan refresh: 0.2 h)."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1.0, 1.0, (n, 3)) + rng.uniform(0, 1, (n, 3)) * BOX
    return pos, pos + rng.uniform(-0.07, 0.07, pos.shape)


def _refreshed_plan(params, pos, pos2, dtype=torch.float64, device="cpu"):
    plan = tew.make_plan(params, torch.as_tensor(pos, dtype=dtype,
                                                 device=device))
    plan = tew.update_plan(plan, torch.as_tensor(pos2, dtype=dtype,
                                                 device=device))
    assert not torch.equal(plan.positions, plan.sort_pos)
    return plan


def _partition(gx):
    """Three slabs of uneven width covering the x planes once."""
    cuts = [0, gx // 4, gx // 2 + 1, gx]
    return [(a, b - a) for a, b in zip(cuts[:-1], cuts[1:])]


# ---------------------------------------------------------------------------
# The plain versions against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("C", [3, 6, 9, 18])
@pytest.mark.parametrize("support", [6, 9])
def test_plain_gridding_matches_jax_after_refresh(jew, support, C):
    import jax.numpy as jnp

    pt = _params(support)
    pj = jew.default_params(A, ETA, BOX, tol=TOL, grid_max=GRID_MAX,
                            support=support, r_cut_factor=R_CUT_FACTOR)
    assert (pj.grid, pj.support) == (pt.grid, pt.support)
    pos, pos2 = _scene(seed=support)
    jplan = jew.update_plan(
        jew.make_plan(dataclasses.replace(pj, near_impl="xla"),
                      jnp.asarray(pos)), jnp.asarray(pos2))
    tplan = _refreshed_plan(pt, pos, pos2)
    rng = np.random.default_rng(C)
    f = rng.normal(size=(pos.shape[0], C))
    u = rng.normal(size=(C,) + pt.grid)
    assert _rel(_np(tew.spread_plain(tplan, torch.as_tensor(f))),
                jew.spread(jplan, jnp.asarray(f))) < 1e-11
    assert _rel(_np(tew.interpolate_plain(tplan, torch.as_tensor(u))),
                jew.interpolate(jplan, jnp.asarray(u))) < 1e-11


# ---------------------------------------------------------------------------
# Identities of the plain versions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("support", [6, 9])
def test_adjoint_identity(support):
    """<S f, u> = <f, S^T u>, on the whole grid and on a slab of x planes
    with the ids that stamp it."""
    plan = _refreshed_plan(_params(support), *_scene(seed=10 + support))
    rng = np.random.default_rng(support)
    f = torch.as_tensor(rng.normal(size=(plan.positions.shape[0], 6)))
    u = torch.as_tensor(rng.normal(size=(6,) + plan.params.grid))
    sf = tew.spread(plan, f)
    lhs, rhs = torch.sum(sf * u), torch.sum(f * tew.interpolate(plan, u))
    assert abs(float(lhs - rhs)) <= 1e-12 * float(torch.sum(torch.abs(
        sf * u)))
    planes = (5, 11)
    ids = tew.plane_particles(plan, planes)
    us = u[:, 5:16].contiguous()
    sf = tew.spread(plan, f[ids], ids, planes=planes)
    lhs = torch.sum(sf * us)
    rhs = torch.sum(f[ids] * tew.interpolate(plan, us, ids, planes=planes))
    assert abs(float(lhs - rhs)) <= 1e-12 * float(torch.sum(torch.abs(
        sf * us)))


@pytest.mark.parametrize("support", [6, 9])
def test_plane_slabs_partition_the_gridding(support):
    """The slabs of a partition of the x planes, each spread from the
    particles that stamp it, concatenate to the whole spread; their
    interpolation rows sum to the whole interpolation."""
    plan = _refreshed_plan(_params(support), *_scene(seed=20 + support))
    gx = plan.params.grid[0]
    n = plan.positions.shape[0]
    rng = np.random.default_rng(3)
    f = torch.as_tensor(rng.normal(size=(n, 9)))
    u = torch.as_tensor(rng.normal(size=(9,) + plan.params.grid))
    slabs, rows = [], torch.zeros((n, 9), dtype=torch.float64)
    for x0, nx in _partition(gx):
        ids = tew.plane_particles(plan, (x0, nx))
        assert 0 < ids.numel() < n
        g = tew.spread(plan, f[ids], ids, planes=(x0, nx))
        assert g.shape == (9, nx) + plan.params.grid[1:]
        slabs.append(g)
        rows[ids] += tew.interpolate(plan, u[:, x0:x0 + nx].contiguous(),
                                     ids, planes=(x0, nx))
    assert _rel(_np(torch.cat(slabs, dim=1)),
                _np(tew.spread(plan, f))) < 1e-12
    assert _rel(_np(rows), _np(tew.interpolate(plan, u))) < 1e-12


def test_ids_spread_as_masked_forces():
    plan = _refreshed_plan(_params(9), *_scene(seed=30))
    n = plan.positions.shape[0]
    rng = np.random.default_rng(4)
    f = torch.as_tensor(rng.normal(size=(n, 3)))
    ids = torch.as_tensor(rng.permutation(n)[:n // 3])
    masked = torch.zeros_like(f)
    masked[ids] = f[ids]
    assert _rel(_np(tew.spread(plan, f[ids], ids)),
                _np(tew.spread(plan, masked))) < 1e-12
    u = torch.as_tensor(rng.normal(size=(3,) + plan.params.grid))
    assert torch.equal(tew.interpolate(plan, u, ids),
                       tew.interpolate(plan, u)[ids])


# ---------------------------------------------------------------------------
# Dispatch and the wrappers' checks
# ---------------------------------------------------------------------------


def test_cpu_gridding_never_reaches_the_kernel_wrappers(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU tensor reached a kernel wrapper")

    plan = _refreshed_plan(_params(6), *_scene(seed=40))
    rng = np.random.default_rng(5)
    f = torch.as_tensor(rng.normal(size=(plan.positions.shape[0], 3)))
    u = torch.as_tensor(rng.normal(size=(3,) + plan.params.grid))
    want = (tew.spread_plain(plan, f), tew.interpolate_plain(plan, u),
            tew.wave_matvec(plan, f))
    monkeypatch.setattr(gk, "grid_spread", refuse)
    monkeypatch.setattr(gk, "grid_interpolate", refuse)
    assert torch.equal(tew.spread(plan, f), want[0])
    assert torch.equal(tew.interpolate(plan, u), want[1])
    assert torch.equal(tew.wave_matvec(plan, f), want[2])
    ids = tew.plane_particles(plan, (0, 8))
    tew.spread(plan, f[ids], ids, planes=(0, 8))
    tew.interpolate(plan, u[:, :8].contiguous(), ids, planes=(0, 8))


def test_wrappers_refuse_what_the_kernels_do_not_take():
    plan = _refreshed_plan(_params(6), *_scene(seed=50))
    p = plan.params
    pos, spos = plan.positions, plan.sort_pos
    n = pos.shape[0]
    f = torch.zeros((n, 3), dtype=torch.float64)
    u = torch.zeros((3,) + p.grid, dtype=torch.float64)
    with pytest.raises(ValueError, match="unsupported device"):
        gk.grid_spread(pos, spos, f, p)
    with pytest.raises(ValueError, match="unsupported device"):
        gk.grid_interpolate(pos, spos, u, p)
    with pytest.raises(ValueError, match="expected torch.float64"):
        gk.grid_spread(pos, spos, f.float(), p)
    with pytest.raises(TypeError, match="float32/float64"):
        gk.grid_spread(pos.half(), spos.half(), f.half(), p)
    with pytest.raises(ValueError, match="not contiguous"):
        gk.grid_interpolate(pos, spos, u.transpose(1, 2), p)
    with pytest.raises(ValueError, match="outside the grid"):
        gk.grid_spread(pos, spos, f, p, planes=(p.grid[0] - 2, 4))
    with pytest.raises(ValueError, match="support"):
        gk.grid_spread(pos, spos, f, dataclasses.replace(p, support=17))
    with pytest.raises(ValueError, match="ids"):
        gk.grid_spread(pos, spos, f, p, ids=torch.zeros((n, 1)))
    with pytest.raises(ValueError, match="multiple of 3"):
        gk.grid_spread(pos, spos, torch.zeros((n, 4), dtype=pos.dtype), p)


@pytest.mark.parametrize("with_ids", [False, True])
def test_x_order_walk_is_the_same_function(with_ids):
    """The kernels' walk (grid_kernels.walk): the points in their
    sort-time x order, each with its own row of the forces and outputs.
    Spreading the walk's points with the walk's rows of the forces gives
    the caller's spread, and the walk's rows put each interpolated row
    where the caller's order has it."""
    plan = _refreshed_plan(_params(9), *_scene(seed=80))
    n = plan.positions.shape[0]
    rng = np.random.default_rng(8)
    ids = torch.as_tensor(rng.permutation(n)[:40]) if with_ids else None
    m = n if ids is None else ids.numel()
    pts, rows = gk.walk(plan.sort_pos, ids)
    assert torch.equal(torch.sort(rows).values, torch.arange(m))
    assert torch.equal(pts, rows if ids is None else ids[rows])
    xs = plan.sort_pos[pts, 0]
    assert bool(torch.all(xs[1:] >= xs[:-1]))
    f = torch.as_tensor(rng.normal(size=(m, 6)))
    u = torch.as_tensor(rng.normal(size=(6,) + plan.params.grid))
    assert _rel(_np(tew.spread_plain(plan, f[rows], pts)),
                _np(tew.spread_plain(plan, f, ids))) < 1e-12
    walked = torch.empty((m, 6), dtype=torch.float64)
    walked[rows] = tew.interpolate_plain(plan, u, pts)
    assert torch.equal(walked, tew.interpolate_plain(plan, u, ids))


def test_channel_blocks_cover_every_channel_once():
    for C in range(3, 61, 3):
        blocks = gk.channel_blocks(C)
        assert [c for c0, ct in blocks for c in range(c0, c0 + ct)] == \
            list(range(C))
        assert all(ct in gk.CHANNEL_BLOCKS for _, ct in blocks)
    # every C the engines pass is one launch
    for C in (3, 6, 9, 18):
        assert gk.channel_blocks(C) == [(0, C)]


# ---------------------------------------------------------------------------
# On the card: G1 and G2 against the plain versions
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _wall_view(device, dtype):
    """A wall engine's view of the padded box: real points above the wall
    and their mirror images at negative z, with a refresh's drift."""
    p = tww.default_wall_params(A, ETA, (8.0, 9.0), 2.0, tol=1e-2,
                                grid_max=32).grid_params()
    rng = np.random.default_rng(60)
    real = np.column_stack([rng.uniform(0, 8.0, 40), rng.uniform(0, 9.0, 40),
                            rng.uniform(0.3, 2.0, 40)])
    pts = np.concatenate([real, real * [1.0, 1.0, -1.0]])
    drift = pts + rng.uniform(-0.05, 0.05, pts.shape)
    t = dict(dtype=dtype, device=device)
    return tew.SpectralPlan(
        positions=torch.as_tensor(drift, **t), sort_pos=torch.as_tensor(
            pts, **t), cheb=None, self_coeff=0.0, cell_table=None,
        cell_slot=None, n_dropped_cells=None, cell_dims=None, kernel=None,
        khat=None, params=p)


def _cast(plan, dtype):
    return dataclasses.replace(plan, positions=plan.positions.to(dtype),
                               sort_pos=plan.sort_pos.to(dtype))


def _launches(kind):
    return sum(v for k, v in gk.LAUNCHES.items() if k.startswith(kind))


def _check_pair(plan64, plan, f, u, ids, planes):
    """G1 and G2 on plan (the card) against the plain versions on plan64
    (the same positions in float64)."""
    dtype = plan.positions.dtype
    P = plan.params.support
    f64 = f.double()
    u64 = u.double()
    ref_s = tew.spread_plain(plan64, f64, ids, planes)
    ref_i = tew.interpolate_plain(plan64, u64, ids, planes)
    got_s = tew.spread(plan, f, ids, planes)
    got_i = tew.interpolate(plan, u, ids, planes)
    assert torch.equal(got_i, tew.interpolate(plan, u, ids, planes))
    for got, ref, plain in (
            (got_s, ref_s, lambda: tew.spread_plain(plan, f, ids, planes)),
            (got_i, ref_i, lambda: tew.interpolate_plain(plan, u, ids,
                                                         planes))):
        assert got.shape == ref.shape and got.dtype == dtype
        scale = float(ref.abs().max())
        err = float((got.double() - ref).abs().max())
        if dtype == torch.float64:
            assert err <= 1e-12 * scale
        else:
            e_plain = float((plain().double() - ref).abs().max())
            assert err <= 2 * e_plain + U32 * P ** 1.5 * scale


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["whole", "ids", "planes"])
@pytest.mark.parametrize("C", [3, 6, 9, 12, 18])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernels_match_plain_on_card(cuda, dtype, C, case):
    pos, pos2 = _scene(n=400, seed=70)
    plan64 = _refreshed_plan(_params(9), pos, pos2, device=cuda)
    plan = _cast(plan64, dtype)
    gx = plan.params.grid[0]
    g = torch.Generator(device=cuda).manual_seed(C)
    ids = planes = None
    if case == "ids":
        ids = torch.randperm(400, generator=g, device=cuda)[:150]
    if case == "planes":
        planes = _partition(gx)[1]
        ids = tew.plane_particles(plan64, planes)
    n = 400 if ids is None else ids.numel()
    nxl = gx if planes is None else planes[1]
    f = torch.randn((n, C), generator=g, device=cuda, dtype=dtype)
    u = torch.randn((C, nxl) + plan.params.grid[1:], generator=g,
                    device=cuda, dtype=dtype)
    before = (_launches("grid_spread"), _launches("grid_interpolate"),
              sum(gk.SHARE_LAUNCHES.values()))
    _check_pair(plan64, plan, f, u, ids, planes)
    blocks = len(gk.channel_blocks(C))
    assert _launches("grid_spread") - before[0] == 2 * blocks
    assert _launches("grid_interpolate") - before[1] == 2 * blocks
    assert sum(gk.SHARE_LAUNCHES.values()) - before[2] == (
        0 if planes is None else 4 * blocks)


@pytest.mark.gpu
@pytest.mark.parametrize("C", [3, 18])
def test_kernels_in_the_callers_order_match(cuda, C, monkeypatch):
    """The points in the caller's order (the walk replaced by the
    identity) compute the same function: G2's rows bit for bit (each
    row's sum is the point's own), G1's grid within its atomics' order."""
    pos, pos2 = _scene(n=400, seed=71)
    plan = _cast(_refreshed_plan(_params(9), pos, pos2, device=cuda),
                 torch.float32)
    p = plan.params
    g = torch.Generator(device=cuda).manual_seed(C)
    f = torch.randn((400, C), generator=g, device=cuda)
    u = torch.randn((C,) + p.grid, generator=g, device=cuda)
    args = (plan.positions, plan.sort_pos)
    got_i, a = gk.grid_interpolate(*args, u, p), gk.grid_spread(*args, f, p)
    rows = torch.arange(400, device=cuda)
    monkeypatch.setattr(gk, "walk", lambda sort_pos, ids: (rows, rows))
    assert torch.equal(got_i, gk.grid_interpolate(*args, u, p))
    b = gk.grid_spread(*args, f, p)
    assert float((a - b).abs().max()) <= U32 * 16 * float(a.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernels_match_plain_on_a_wall_view(cuda, dtype):
    plan64 = _wall_view(cuda, torch.float64)
    assert float(plan64.positions[:, 2].min()) < 0
    plan = _cast(plan64, dtype)
    g = torch.Generator(device=cuda).manual_seed(1)
    n = plan.positions.shape[0]
    for C in (3, 9, 18):
        f = torch.randn((n, C), generator=g, device=cuda, dtype=dtype)
        u = torch.randn((C,) + plan.params.grid, generator=g, device=cuda,
                        dtype=dtype)
        _check_pair(plan64, plan, f, u, None, None)
