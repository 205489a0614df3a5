"""The spectral single-wall engine of the PyTorch port (ops/ewald_wall.py,
kernel K7's plain version, the wall-slab linked-cell forces) against the
JAX package on the CPU, float64, on the JAX tests' scene (6 blobs in a
26 a box, tests/test_wall_spectral.py).

- Host side: default_wall_params picks the same grid, r_cut, xi, support
  and z0 (bench.py's spectral_wall box included); the RPY and image
  Chebyshev tables, the polish set and its kernel FFTs, and the noise
  factors (tol 1e-3) equal JAX's to 1e-12.
- The plan's heights, damping, clipped and dropped counts equal JAX's;
  the near field (plain K7) matches near_matvec_xla for B = 1 and 2; the
  wave side, matvec and matvec_multi, update_wall_plan on both branches,
  the noise chain and the defect operator match to 1e-10 relative. The
  JAX package stores its z-DFT matrices in float32 (a TPU runtime limit),
  which caps its float64 wave side at ~1e-8; the comparisons give it
  float64 matrices (`jax_zdft64`), and one test bounds the float32 gap.
- The defect's adjoint passes a dot-product test; matvec matches the
  Richardson-extrapolated lattice sum within the JAX test's bound.
- csrc/wall_img_terms.cuh equals a fresh emission.
- The wall-slab forces match the JAX CPU path; the three repairs: the
  preconditioner's wall blocks, the noise's wall branch, the guard-layer
  cell grids.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rigidmultiblobswall_tpu.models import integrators as jint
from rigidmultiblobswall_tpu.models import saddle as jsad
from rigidmultiblobswall_tpu.models import system as jsys
from rigidmultiblobswall_tpu.ops import ewald_wall as jew
from rigidmultiblobswall_tpu.ops import forces as jforces
from rigidmultiblobswall_tpu_torch.models import integrators as tint
from rigidmultiblobswall_tpu_torch.models import saddle as tsad
from rigidmultiblobswall_tpu_torch.models import system as tsys
from rigidmultiblobswall_tpu_torch.ops import _emit_wall_cuh, cell_kernels
from rigidmultiblobswall_tpu_torch.ops import cells as tcells
from rigidmultiblobswall_tpu_torch.ops import ewald_wall as tew
from rigidmultiblobswall_tpu_torch.ops import forces as tforces

from torch_parity import jax_zdft64, to_np, wall_spectral_scene

A, ETA = 0.25, 0.9
LBOX = 26 * A


def _rel(got, ref):
    ref = np.asarray(ref)
    return float(np.abs(to_np(got) - ref).max() / np.abs(ref).max())


@pytest.fixture
def zdft64(monkeypatch):
    monkeypatch.setattr(jew, "_host_zdft", jax_zdft64)


def _config(n=6, seed=0, z_lo=1.2, z_hi=3.0):
    rng = np.random.default_rng(seed)
    pos = np.stack([rng.uniform(0, LBOX, n), rng.uniform(0, LBOX, n),
                    rng.uniform(z_lo * A, z_hi * A, n)], axis=1)
    return pos, rng.normal(size=(n, 6))


def _params(tol=1e-4):
    kw = dict(z_hi=3.5 * A, tol=tol)
    return (jew.default_wall_params(A, ETA, (LBOX, LBOX), near_impl="xla",
                                    **kw),
            tew.default_wall_params(A, ETA, (LBOX, LBOX), **kw))


@functools.lru_cache(maxsize=4)
def _plans(tol=1e-4):
    pos, f = _config()
    pj, pt = _params(tol)
    return (jew.make_wall_plan(pj, jnp.asarray(pos)),
            tew.make_wall_plan(pt, torch.as_tensor(pos)), pos, f)


@pytest.mark.parametrize("box, z_hi, tol, grid_max", [
    ((LBOX, LBOX), 3.5 * A, 1e-4, 1024), ((LBOX, 1.3 * LBOX), 6 * A, 1e-3,
                                          1024),
    ((102.4, 102.4), 3.25, 1e-4, 512), ((20.0, 20.0), 2.0, 1e-5, 64)])
def test_default_wall_params_match_jax(box, z_hi, tol, grid_max):
    pj = jew.default_wall_params(0.131 if box[0] > 50 else A, ETA, box,
                                 z_hi=z_hi, tol=tol, grid_max=grid_max)
    pt = tew.default_wall_params(0.131 if box[0] > 50 else A, ETA, box,
                                 z_hi=z_hi, tol=tol, grid_max=grid_max)
    assert (pt.grid, pt.r_cut, pt.xi, pt.support, pt.z0, pt.z_pad_factor,
            pt.lz_box, pt.noise_orders()) == (
        pj.grid, pj.r_cut, pj.xi, pj.support, pj.z0, pj.z_pad_factor,
        pj.lz_box, pj.noise_orders())
    assert tew._z_plane_ranges(pt) == jew._z_plane_ranges(pj)


def test_host_tables_match_jax():
    plj, plt, _, _ = _plans()
    pj, pt = plj.params, plt.params
    cj, sj = jew._host_cheb_rpy(pj)
    ct, st = tew._host_cheb_rpy(pt)
    assert np.abs(ct - cj).max() <= 1e-12 * np.abs(cj).max() and st == sj
    ij, it = jew._host_img_cheb(pj), tew._host_img_cheb(pt)
    assert it[1:] == ij[1:]
    assert np.abs(it[0] - ij[0]).max() <= 1e-12 * np.abs(ij[0]).max()
    (xj, kj, mj), (xt, kt, mt) = jew._host_polish(pj), tew._host_polish(pt)
    assert np.array_equal(xt, xj) and np.array_equal(mt, mj)
    assert np.abs(kt - kj).max() <= 1e-12 * np.abs(kj).max()
    for wt, wj in zip(tew._host_whats(pt), jew._host_whats(pj)):
        assert np.abs(wt - wj).max() <= 1e-12 * np.abs(wj).max()
    # the device tables: the polish FFTs kept complex
    assert torch.equal(plt.tables.polish_kfft, torch.as_tensor(kj))


def test_noise_factors_match_jax():
    plj, plt, _, _ = _plans(1e-3)
    tj = jew._host_noise_tables(plj.params)
    tt = tew._host_noise_tables(plt.params)
    for key in ("mode_idx", "cos", "sin", "kpar", "scale", "C_lz", "C_t",
                "chi", "z_nodes"):
        assert np.allclose(tt[key], tj[key], rtol=0,
                           atol=1e-12 * max(np.abs(tj[key]).max(), 1.0)), key
    fj = jew._noise_factors_host(plj.params)
    ft = tew.noise_factors(plt.params, torch.float64, "cpu")
    for a, b in zip(ft, fj):
        assert a.shape == b.shape and _rel(a, b) <= 1e-12


def test_make_wall_plan_matches_jax():
    pos, _ = _config(40, seed=3, z_lo=0.3, z_hi=4.5)  # below a, above z_hi
    pj, pt = _params()
    pj, pt = (dataclasses.replace(p, cell_capacity=2) for p in (pj, pt))
    plj = jew.make_wall_plan(pj, jnp.asarray(pos))
    plt = tew.make_wall_plan(pt, torch.as_tensor(pos))
    assert plt.cell_dims == plj.cell_dims
    assert plt.params.cell_capacity == plj.params.cell_capacity
    for name in ("pos_all", "heights", "damp"):
        assert _rel(getattr(plt, name), getattr(plj, name)) <= 1e-15, name
    assert np.array_equal(to_np(plt.cell_table), np.asarray(plj.cell_table))
    assert int(plt.n_clipped) == int(plj.n_clipped) > 0
    assert (0, int(plt.n_dropped_cells)) == (int(plj.n_dropped_grid),
                                             int(plj.n_dropped_cells))
    assert int(plt.n_dropped_cells) > 0
    lo, hi = tew._kept_layers(pt, plt.cell_dims)
    kept = jew._kept_target_cells(plj.params, plj.cell_dims)
    assert np.array_equal(np.unique(kept % plj.cell_dims[2]),
                          np.arange(lo, hi + 1))


@pytest.mark.parametrize("n_rhs", [1, 2])
def test_near_matvec_matches_xla(n_rhs):
    plj, plt, _, f = _plans()
    fb = f[:, :3 * n_rhs]
    ref = jew.near_matvec_xla(plj, jnp.asarray(fb))
    assert _rel(tew.near_matvec(plt, torch.as_tensor(fb)), ref) <= 1e-10


@pytest.mark.parametrize("n_rhs", [1, 2])
def test_wave_matvec_matches_jax(zdft64, n_rhs):
    plj, plt, _, f = _plans()
    fb = f[:, :3 * n_rhs]
    ref = jew.wave_matvec(plj, jnp.asarray(fb))
    assert _rel(tew.wave_matvec(plt, torch.as_tensor(fb)), ref) <= 1e-10


def test_matvec_and_multi_match_jax(zdft64):
    plj, plt, _, f = _plans()
    f3 = f[:, :3]
    ref = jew.matvec(plj, jnp.asarray(f3))
    assert _rel(tew.matvec(plt, torch.as_tensor(f3)), ref) <= 1e-10
    F = np.stack([f[:, :3], f[:, 3:]])
    ref = jew.matvec_multi(plj, jnp.asarray(F))
    assert _rel(tew.matvec_multi(plt, torch.as_tensor(F)), ref) <= 1e-10


def test_jax_float32_zdft_gap():
    """Without float64 DFT matrices the JAX wave side is float32-limited:
    the port stays within float32 rounding of it."""
    plj, plt, _, f = _plans()
    err = _rel(tew.matvec(plt, torch.as_tensor(f[:, :3])),
               jew.matvec(plj, jnp.asarray(f[:, :3])))
    assert err <= 1e-6


@pytest.mark.parametrize("step", [0.02, 2.0])
def test_update_wall_plan_matches_jax(zdft64, step):
    plj, plt, pos, f = _plans()
    rng = np.random.default_rng(9)
    pos2 = pos + step * A * rng.normal(size=pos.shape)
    pos2[:, 2] = np.abs(pos2[:, 2])
    uj = jew.update_wall_plan(plj, jnp.asarray(pos2))
    ut = tew.update_wall_plan(plt, torch.as_tensor(pos2))
    refreshed = ut.sort_pos is plt.sort_pos
    assert refreshed == (step < 1.0)
    assert refreshed == bool(np.all(np.asarray(uj.sort_pos)
                                    == np.asarray(plj.sort_pos)))
    ref = jew.matvec(uj, jnp.asarray(f[:, :3]))
    assert _rel(tew.matvec(ut, torch.as_tensor(f[:, :3])), ref) <= 1e-10


def test_noise_chain_and_defect_match_jax():
    plj, plt, _, f = _plans(1e-3)
    fj = jew._noise_factors_device(plj.params, jnp.float64)
    ft = tew.noise_factors(plt.params, torch.float64, "cpu")
    pz = tew._host_noise_tables(plt.params)["p"]
    gx, gy, _ = plt.params.grid
    w = np.random.default_rng(5).normal(size=(3 * pz, gx, gy))
    ref = jew._wave_noise_apply(plj, jnp.asarray(w), fj[0], fj[1])
    got = tew.wave_sqrt_noise(plt, torch.as_tensor(w), ft)
    assert _rel(got, ref) <= 1e-10
    ref = jew.wave_defect_matvec(plj, jnp.asarray(f[:, :3]), factors=fj)
    got = tew.wave_defect_matvec(plt, torch.as_tensor(f[:, :3]), ft)
    assert _rel(got, ref) <= 1e-10


def test_defect_adjoint_dot_product():
    """<pre(w), g> = <w, pre^T g> for the sampler's pre-chain, whose
    rfft2 / irfft2 adjoints carry the Hermitian column weights."""
    _, plt, _, _ = _plans(1e-3)
    ft = tew.noise_factors(plt.params, torch.float64, "cpu")
    pz = tew._host_noise_tables(plt.params)["p"]
    gx, gy, gz = plt.params.grid
    rng = np.random.default_rng(6)
    w = torch.as_tensor(rng.normal(size=(3 * pz, gx, gy)))
    g = torch.as_tensor(rng.normal(size=(3, gx, gy, gz)))
    lhs = torch.sum(tew._wave_noise_pre(plt, w, ft[2], ft[3]) * g)
    w0 = torch.zeros_like(w, requires_grad=True)
    (adj,) = torch.autograd.grad(tew._wave_noise_pre(plt, w0, ft[2], ft[3]),
                                 w0, grad_outputs=g)
    assert abs(float(lhs - torch.sum(w * adj))) <= 1e-12 * abs(float(lhs))
    # and the defect operator is symmetric
    f1, f2 = (torch.as_tensor(rng.normal(size=(6, 3))) for _ in range(2))
    d1 = torch.sum(f2 * tew.wave_defect_matvec(plt, f1, ft))
    d2 = torch.sum(f1 * tew.wave_defect_matvec(plt, f2, ft))
    assert abs(float(d1 - d2)) <= 1e-12 * abs(float(d1))


def test_matvec_matches_converged_lattice_sum():
    _, plt, pos, f = _plans()
    u1 = tew.brute_force_wall(pos, f[:, :3], A, ETA, (LBOX, LBOX), n_img=40)
    u2 = tew.brute_force_wall(pos, f[:, :3], A, ETA, (LBOX, LBOX), n_img=80)
    oracle = 2 * u2 - u1
    ref = jew.brute_force_wall(pos, f[:, :3], A, ETA, (LBOX, LBOX),
                               n_img=40)
    assert np.abs(u1 - ref).max() <= 1e-12 * np.abs(ref).max()
    u = to_np(tew.matvec(plt, torch.as_tensor(f[:, :3])))
    assert np.abs(u - oracle).max() / np.abs(oracle).max() < 1e-5


def test_emitted_header_is_fresh():
    assert _emit_wall_cuh.HEADER.read_text() == _emit_wall_cuh.emit()
    text = _emit_wall_cuh.emit()
    assert "T((4.0 / 3.0))" in text and "**" not in text


def test_wall_slab_forces_match_jax_cpu_path():
    """The scene of tests/test_forces.py's wall-slab tests: the wall-slab
    cells (K5's plain version) against the JAX CPU path's open-z cells;
    the pairs they differ in lie beyond the cutoff (tail ~e^-30)."""
    rng = np.random.default_rng(11)
    L, z_hi, n = 12.0, 3.0, 320
    r = np.empty((n, 3))
    r[:, :2] = rng.uniform(0, L, (n, 2))
    r[:, 2] = rng.uniform(0.2, z_hi - 0.2, n)
    kw = dict(repulsion_strength=0.7, debye_length=0.05, blob_radius=0.3,
              periodic_length=(L, L, 0.0), cell_capacity=64,
              z_extent=z_hi)
    ref = np.asarray(jforces.blob_blob_forces_neighbor_list(
        jnp.asarray(r), **kw))
    got = tforces.blob_blob_forces_neighbor_list(torch.as_tensor(r), **kw)
    assert _rel(got, ref) <= 1e-12
    rc = 2 * 0.3 + 30 * 0.05
    assert tforces.wall_slab((L, L, 0.0), rc, z_hi) == (3, 1.001 * rc,
                                                        2 * 1.001 * rc
                                                        * 0.999)


def _wall_systems(cap, r):
    base = dict(eta=1.0, blob_radius=0.3, kT=0.0,
                domain="single_wall_spectral", periodic_length=(12.0, 12.0,
                                                                0.0),
                spectral_wall_height=3.0, blob_blob_force_method=(
                    "neighbor_list"), repulsion_strength=0.7,
                debye_length=0.05, blob_blob_grid_dim=16,
                blob_blob_cell_capacity=cap)
    t = jsys.BodyType(name="b", ref_config=np.zeros((1, 3)), count=len(r))
    js = jsys.System(types=(t,), **base)
    return js, tsys.from_reference(js, device="cpu")


@pytest.mark.parametrize("cap", [64, 1])
def test_wall_slab_overflow_matches_jax(cap):
    rng = np.random.default_rng(3)
    r = np.empty((200, 3))
    r[:, :2] = rng.uniform(0, 12.0, (200, 2))
    r[:, 2] = rng.uniform(0.2, 2.8, 200)
    js, ts = _wall_systems(cap, r)
    for rr in (r, np.concatenate([r[:195], r[195:] + [0, 0, 50.0]])):
        assert tforces.neighbor_list_overflow(ts, torch.as_tensor(rr)) == int(
            jforces.neighbor_list_overflow(js, jnp.asarray(rr)))
    sized = tforces.auto_force_cell_capacity(ts, torch.as_tensor(r))
    assert tforces.neighbor_list_overflow(sized, torch.as_tensor(r)) == 0


def test_repair_pc_takes_wall_blocks():
    js, jst, ts, tst = wall_spectral_scene()
    pj = jsad.build_block_diag_pc(js, jst)
    pt = tsad.build_block_diag_pc(ts, tst)
    for name in ("chol", "m_inv", "N_body"):
        assert _rel(getattr(pt.per_type[0], name),
                    getattr(pj.per_type[0], name)) <= 1e-12, name


def test_repair_noise_takes_the_wall_branch(monkeypatch):
    """_noise_slip on single_wall_spectral: the damped wave sample plus
    Lanczos on D (M_near - Delta) D, fed the normals JAX draws from its
    key, equals JAX's."""
    js, jst, ts, tst = wall_spectral_scene(kT=0.05)
    from rigidmultiblobswall_tpu.models import kinematics as jkin
    from rigidmultiblobswall_tpu_torch.models import kinematics as tkin

    plj = jsad.maybe_dense_mobility(js, jkin.blob_positions(js, jst))
    plt = tsad.maybe_dense_mobility(ts, tkin.blob_positions(ts, tst))
    fj = jew._noise_factors_device(plj.params, jnp.float64)
    ft = tew.noise_factors(plt.params, torch.float64, "cpu")
    key = jax.random.PRNGKey(7)
    kw, kr = jax.random.split(key)
    pz = plt.params.noise_orders()[0]
    gx, gy, _ = plt.params.grid
    draws = [np.asarray(jax.random.normal(kw, (3 * pz, gx, gy),
                                          jnp.float64)),
             np.asarray(jax.random.normal(kr, (3 * js.num_blobs,),
                                          jnp.float64))]
    monkeypatch.setattr(tint, "draw_normal",
                        lambda g, shape, like: torch.as_tensor(draws.pop(0)))
    kwl = dict(tolerance=1e-10, max_iter=40)
    ref, it_ref = jint._noise_slip(js, jst, None, key, 3.0, m_dense=plj,
                                   _cached_noise_factors=fj, **kwl)
    got, it = tint._noise_slip(ts, tst, None, torch.Generator(), 3.0,
                               plan=plt, factors=ft, **kwl)
    assert it == int(it_ref) and _rel(got, ref) <= 1e-10


def test_repair_guard_layer_cell_grids():
    """Three z cells (and two) pass the kernels' check when the top layer
    is a declared empty guard: the 27-cell walk then visits 27 distinct
    cells (3) or repeats only the guard (2); without a guard they raise."""
    nb = tcells.neighbor_table((4, 4, 3))
    assert all(len(set(row.tolist())) == 27 for row in nb)
    pos = torch.zeros((10, 3), device="meta")
    for dims, guard, msg in (((4, 4, 3), False, "cells a side"),
                             ((4, 4, 3), True, "device"),
                             ((4, 4, 2), True, "device"),
                             ((4, 3, 3), True, "cells a side")):
        with pytest.raises(ValueError, match=msg):
            cell_kernels.nl_forces(pos, None, dims, (8.0, 8.0, 3.0), 4,
                                   eps_over_b=1.0, inv_b=1.0, two_a=1.0,
                                   guard_z=guard)
