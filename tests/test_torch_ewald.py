"""The periodic spectral Ewald engine of the PyTorch port (ops/ewald.py,
the near-field kernel K6's plain version) and the periodic_spectral path
against the JAX package on the CPU.

- Host side: default_params picks the same grid, r_cut, xi and support
  over a sweep of boxes, tolerances and grid caps; the Chebyshev
  coefficients and window transforms agree to 1e-14.
- K6: the plain version in float32 (B = 1, 2) against the Pallas kernel in
  interpret mode at 5e-6 x max|ref|, real_matvec in float64 against the
  XLA cell sweep to 1e-12.
- Wave side, float64: spread, interpolate, wave_matvec and matvec_multi
  (B = 2) for odd and even window support, and wave_sqrt_noise fed JAX's
  grid noise, to 1e-11 relative; update_plan takes the refresh and the
  rebuild branch where JAX does.
- The path: Slip-Trapz with neighbor-list forces, 2 steps in float64 at
  kT = 0 and at kT = 0.05 fed JAX's normals, traction EM at kT = 0.05
  fed JAX's normals, and forward Euler, against
  integrators.make_stepper, final positions to 1e-9 of the displacement
  with equal GMRES and Lanczos counts and equal capacity overflows; a
  step whose carry has no plan builds it once at its start, and the
  products below it raise without one.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rigidmultiblobswall_tpu.models import integrators as jint
from rigidmultiblobswall_tpu.models import system as jsys
from rigidmultiblobswall_tpu.ops import ewald as jew
from rigidmultiblobswall_tpu_torch.models import integrators as tint
from rigidmultiblobswall_tpu_torch.models import saddle as tsad
from rigidmultiblobswall_tpu_torch.models import system as tsys
from rigidmultiblobswall_tpu_torch.ops import ewald as tew

from torch_parity import shell_vertices, to_np

A, ETA = 0.5, 1.3
BOX = (12.5, 12.5, 12.5)
# tol 0.2: a 32^3 grid with 4 near-field cells a side in this box
TOL, GRID_MAX = 0.2, 32


def _rel(got, ref):
    ref = np.asarray(ref)
    return float(np.abs(to_np(got) - ref).max() / np.abs(ref).max())


def _params(**kw):
    kw = dict(dict(tol=TOL, grid_max=GRID_MAX), **kw)
    return (jew.default_params(A, ETA, BOX, **kw),
            tew.default_params(A, ETA, BOX, **kw))


def _scene(n=150, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-2.0, BOX[0] + 2.0, (n, 3)).astype(dtype)
    pos[5] = pos[4] + 0.3                # closer than 2a
    return pos, rng.normal(size=(n, 6)).astype(dtype)


def _plans(pj, pt, pos, near_impl="xla"):
    return (jew.make_plan(dataclasses.replace(pj, near_impl=near_impl),
                          jnp.asarray(pos)),
            tew.make_plan(pt, torch.as_tensor(pos)))


@pytest.mark.parametrize("box, tol, grid_max", [
    ((20.0, 20.0, 20.0), 1e-4, 256), ((20.0, 20.0, 20.0), 1e-4, 64),
    ((33.6, 33.6, 33.6), 1e-4, 256), ((9.0, 11.0, 14.0), 1e-3, 256),
    ((12.5, 12.5, 12.5), 0.2, 32), ((40.0, 40.0, 40.0), 1e-6, 128)])
def test_default_params_match_jax(box, tol, grid_max):
    pj = jew.default_params(A, ETA, box, tol=tol, grid_max=grid_max)
    pt = tew.default_params(A, ETA, box, tol=tol, grid_max=grid_max)
    assert (pt.grid, pt.r_cut, pt.xi, pt.support) == (
        pj.grid, pj.r_cut, pj.xi, pj.support)


def test_host_series_and_window_transforms_match_jax():
    for tol in (1e-4, TOL):
        pj, pt = _params(tol=tol)
        cj, sj = jew._host_cheb(pj)
        ct, st = tew._host_cheb(pt)
        assert ct.shape == cj.shape
        np.testing.assert_allclose(ct, cj, rtol=0, atol=1e-14 * np.abs(
            cj).max())
        assert abs(st - sj) <= 1e-14 * abs(sj)
        for wt, wj in zip(tew._host_whats(pt), jew._host_whats(pj)):
            np.testing.assert_allclose(wt, wj, rtol=1e-14, atol=0)


@pytest.mark.parametrize("n_rhs", [1, 2])
def test_plain_k6_f32_matches_pallas_interpret(n_rhs):
    pj, pt = _params()
    pos, f = _scene(seed=1, dtype=np.float32)
    f = f[:, :3 * n_rhs]
    jplan, tplan = _plans(pj, pt, pos, near_impl="pallas")
    assert jplan.src_pos is not None
    ref = np.asarray(jew.real_matvec(jplan, jnp.asarray(f)))
    got = tew.real_matvec(tplan, torch.as_tensor(f))
    assert got.dtype == torch.float32
    assert _rel(got, ref) < 5e-6


@pytest.mark.parametrize("n_rhs", [1, 2])
def test_real_matvec_matches_xla_sweep(n_rhs):
    pj, pt = _params()
    pos, f = _scene(seed=2)
    f = f[:, :3 * n_rhs]
    jplan, tplan = _plans(pj, pt, pos)
    assert int(tplan.n_dropped_cells) == int(jplan.n_dropped_cells) == 0
    ref = jew.real_matvec(jplan, jnp.asarray(f))
    assert _rel(tew.real_matvec(tplan, torch.as_tensor(f)), ref) < 1e-12


@pytest.mark.parametrize("support", [7, 6])
def test_wave_side_matches_jax(support):
    """Odd support: the x planes and the every-point rule coincide; even
    support: the port stamps the planes JAX's layout stamps."""
    pj, pt = _params(support=support)
    pos, f = _scene(seed=3)
    jplan, tplan = _plans(pj, pt, pos)
    fj, ft = jnp.asarray(f), torch.as_tensor(f)
    grid = jew.spread(jplan, fj)
    assert _rel(tew.spread(tplan, ft), grid) < 1e-11
    assert _rel(tew.interpolate(tplan, torch.as_tensor(np.array(grid))),
                jew.interpolate(jplan, grid)) < 1e-11
    assert _rel(tew.wave_matvec(tplan, ft[:, :3]),
                jew.wave_matvec(jplan, fj[:, :3])) < 1e-11
    stack = f.reshape(-1, 2, 3).transpose(1, 0, 2)
    assert _rel(tew.matvec_multi(tplan, torch.as_tensor(stack)),
                jew.matvec_multi(jplan, jnp.asarray(stack))) < 1e-11


def test_wave_sqrt_noise_matches_jax():
    pj, pt = _params()
    pos, _ = _scene(seed=4)
    jplan, tplan = _plans(pj, pt, pos)
    key = jax.random.PRNGKey(7)
    w = np.array(jax.random.normal(key, (3,) + pj.grid))
    assert _rel(tew.wave_sqrt_noise(tplan, torch.as_tensor(w)),
                jew.wave_sqrt_noise(jplan, key)) < 1e-11


@pytest.mark.parametrize("drift, rebuilt", [(0.1, False), (3.0, True)])
def test_update_plan_branches_match_jax(drift, rebuilt):
    """A drift under the budget refreshes (the cells are kept), one past
    it rebuilds; either way the products equal JAX's updated plan's."""
    pj, pt = _params()
    pos, f = _scene(seed=5)
    jplan, tplan = _plans(pj, pt, pos)
    h = min(pt.spacing)
    rng = np.random.default_rng(6)
    pos2 = pos + rng.uniform(-drift * h, drift * h, pos.shape)
    jup = jew.update_plan(jplan, jnp.asarray(pos2))
    tup = tew.update_plan(tplan, torch.as_tensor(pos2))
    kept = np.array_equal(to_np(tup.cell_table), to_np(tplan.cell_table))
    assert kept == (not rebuilt)
    assert kept == bool(jnp.array_equal(jup.cell_table, jplan.cell_table))
    assert _rel(tew.matvec(tup, torch.as_tensor(f[:, :3])),
                jew.matvec(jup, jnp.asarray(f[:, :3]))) < 1e-11


# ---------------------------------------------------------------------------
# The periodic_spectral path
# ---------------------------------------------------------------------------

L_PATH = 3.2


def _path_scene(kT=0.0):
    """8 twelve-blob shells in a 3.2 box at bench.py's spectral physics
    (a = 0.131, repulsion 0.2/0.2 through neighbor lists), cut to a 32^3
    grid and 4 cells a side."""
    rng = np.random.default_rng(0)
    idx = np.arange(8)
    pos = (np.stack([idx % 2, (idx // 2) % 2, idx // 4], axis=1) * 1.6
           + 0.8 + rng.uniform(-0.2, 0.2, (8, 3)))
    quat = rng.normal(size=(8, 4))
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    t = jsys.BodyType(name="shell", ref_config=shell_vertices(12, 0.5),
                      count=8)
    js = jsys.System(
        types=(t,), eta=1.0, blob_radius=0.131, kT=kT, g=0.0,
        domain="periodic_spectral", periodic_length=(L_PATH,) * 3,
        spectral_tol=0.2, spectral_grid_max=32, repulsion_strength=0.2,
        debye_length=0.2, blob_blob_force_method="neighbor_list",
        blob_blob_cutoff=0.79, blob_blob_cell_capacity=16,
        solver_tolerance=1e-12)
    jst = jsys.make_state(pos, quat)
    ts, tst = tsys.from_reference(js, pos, quat, device="cpu")
    ts = tsad.exact_spectral_capacities(ts, tst)
    js = dataclasses.replace(
        js, spectral_cell_capacity=ts.spectral_cell_capacity)
    return js, jst, ts, tst


def _steps(js, jst, ts, tst, scheme, n_steps, dt=2e-3):
    keys = [jax.random.PRNGKey(100 + i) for i in range(n_steps)]
    jstep = jax.jit(jint.make_stepper(js, scheme, dt,
                                      lanczos_tolerance=1e-10))
    jc, s = jint.init_carry(js, state=jst), jst
    for k in keys:
        s, jc, jaux = jstep(s, k, jc)
    tstep = tint.make_stepper(ts, scheme, dt, lanczos_tolerance=1e-10)
    tc, t = tint.init_carry(ts, state=tst), tst
    gen = torch.Generator().manual_seed(0)
    for _ in keys:
        t, tc, taux = tstep(t, gen, tc)
    disp = np.abs(np.asarray(s.pos) - np.asarray(jst.pos)).max()
    assert disp > 1e-5                           # the bodies moved
    np.testing.assert_allclose(to_np(t.pos), np.asarray(s.pos), rtol=0,
                               atol=1e-9 * disp)
    np.testing.assert_allclose(to_np(t.quat), np.asarray(s.quat), rtol=0,
                               atol=1e-9)
    assert taux.det_iterations == int(jaux.det_iterations)
    assert taux.stoch_iterations == int(jaux.stoch_iterations)
    assert taux.capacity_overflows == int(jaux.capacity_overflows) == 0
    assert taux.rejections == 0 and taux.solves_converged
    return keys


@pytest.mark.parametrize("scheme, n_steps", [
    ("stochastic_Slip_Trapz", 2), ("deterministic_forward_euler", 1)])
def test_spectral_path_matches_jax_at_zero_temperature(scheme, n_steps):
    _steps(*_path_scene(), scheme, n_steps)


def test_spectral_slip_trapz_matches_jax_with_jax_noise(monkeypatch):
    """kT > 0: the port's draw_normal returns the normals the JAX step
    draws, in the port's order: W_slip (key k2), the grid noise (kw of
    k1), the Lanczos z (kr of k1)."""
    js, jst, ts, tst = _path_scene(kT=0.05)
    p = tsad.spectral_params(ts)
    n = js.num_blobs
    draws = []
    for i in range(2):
        _, sub = jax.random.split(jax.random.PRNGKey(100 + i))
        k1, k2 = jax.random.split(sub)
        kw, kr = jax.random.split(k1)
        draws += [jax.random.normal(k2, (n, 3)),
                  jax.random.normal(kw, (3,) + p.grid),
                  jax.random.normal(kr, (3 * n,))]
    feed = iter(np.asarray(d) for d in draws)

    def jax_draws(generator, shape, like):
        z = next(feed)
        assert z.shape == tuple(shape)
        return torch.as_tensor(z, dtype=like.dtype, device=like.device)

    monkeypatch.setattr(tint, "draw_normal", jax_draws)
    _steps(js, jst, ts, tst, "stochastic_Slip_Trapz", 2, dt=1e-3)


def test_spectral_traction_em_matches_jax_with_jax_noise(monkeypatch):
    """stochastic_traction_EM on the spectral engine, kT > 0, the JAX
    step's normals fed in the port's order: W_slip (k_rfd), the grid
    noise (kw of k_noise), the Lanczos z (kr of k_noise); the RFD product
    on the plan refreshed at the displaced configuration."""
    js, jst, ts, tst = _path_scene(kT=0.05)
    p = tsad.spectral_params(ts)
    n = js.num_blobs
    draws = []
    for i in range(2):
        _, sub = jax.random.split(jax.random.PRNGKey(100 + i))
        k_noise, k_rfd = jax.random.split(sub)
        kw, kr = jax.random.split(k_noise)
        draws += [jax.random.normal(k_rfd, (n, 3)),
                  jax.random.normal(kw, (3,) + p.grid),
                  jax.random.normal(kr, (3 * n,))]
    feed = iter(np.asarray(d) for d in draws)

    def jax_draws(generator, shape, like):
        z = next(feed)
        assert z.shape == tuple(shape)
        return torch.as_tensor(z, dtype=like.dtype, device=like.device)

    monkeypatch.setattr(tint, "draw_normal", jax_draws)
    _steps(js, jst, ts, tst, "stochastic_traction_EM", 2, dt=1e-3)


def test_from_reference_carries_spectral_fields_and_refuses_the_rest():
    """The spectral fields and radii cross; a JAX mesh is swapped for the
    port's (a one-rank mesh runs the product unchanged)."""
    js, _, ts, _ = _path_scene()
    ts0 = tsys.from_reference(js, device="cpu")
    for name in ("spectral_tol", "spectral_grid_max",
                 "spectral_cell_capacity", "blob_blob_cutoff",
                 "blob_blob_grid_dim", "blob_blob_cell_capacity",
                 "blob_blob_force_method", "periodic_length"):
        assert getattr(ts0, name) == getattr(js, name), name
    assert tsad.spectral_params(ts0) == dataclasses.replace(
        tew.default_params(0.131, 1.0, (L_PATH,) * 3, tol=0.2, grid_max=32),
        cell_capacity=js.spectral_cell_capacity)
    wall = dataclasses.replace(js, domain="single_wall_spectral",
                               periodic_length=(L_PATH, L_PATH, 0.0),
                               spectral_wall_height=2.0)
    # the wall spectral engine is carried across with its slab height
    tw = tsys.from_reference(wall, device="cpu")
    assert (tw.domain, tw.spectral_wall_height) == ("single_wall_spectral",
                                                    2.0)
    # per-blob radii are carried across, and the spectral parameters take
    # them (the mixed-radii mode)
    radii = dataclasses.replace(js, types=(dataclasses.replace(
        js.types[0], blob_radii=np.linspace(0.1, 0.2, 12)),))
    tr = tsys.from_reference(radii, device="cpu")
    assert tr.has_mixed_radii
    np.testing.assert_array_equal(tr.blob_radii, radii.blob_radii)
    # a JAX mesh cannot cross: the port's System takes the caller's mesh
    # (here one rank without a process group), or none
    from rigidmultiblobswall_tpu_torch.parallel import mesh as pmesh

    one = pmesh.make_mesh(1, device="cpu")
    tm = tsys.from_reference(dataclasses.replace(js, mesh=object()),
                             device="cpu", mesh=one)
    assert tm.mesh is one and tm.mobility_kwargs["mesh"] is one
    assert tsys.from_reference(dataclasses.replace(js, mesh=object()),
                               device="cpu").mesh is None
    assert tew.default_params(A, ETA, BOX, radii=(0.1, 0.2)).radii == (0.1,
                                                                       0.2)
    plan = tsad.maybe_dense_mobility(ts, torch.zeros((4, 3),
                                                     dtype=torch.float64))
    f = torch.as_tensor(np.random.default_rng(3).normal(size=(4, 3)))
    assert torch.equal(tew.matvec(plan, f, mesh=one), tew.matvec(plan, f))


def test_step_resolves_the_plan_once_and_products_need_it():
    """A carry without a plan gets one built at the step's start, with the
    result of init_carry(state=...)'s; below the step, a spectral product
    without the plan raises instead of building one."""
    from rigidmultiblobswall_tpu_torch.models import solvers as tsolvers

    _, _, ts, tst = _path_scene()
    step = tint.make_stepper(ts, "deterministic_forward_euler", 2e-3)
    gen = torch.Generator()
    s_built, c_built, _ = step(tst, gen, tint.init_carry(ts, device="cpu"))
    s_ref, _, _ = step(tst, gen, tint.init_carry(ts, state=tst))
    assert isinstance(c_built.plan, tew.SpectralPlan)
    assert torch.equal(s_built.pos, s_ref.pos)
    assert torch.equal(s_built.quat, s_ref.quat)
    vec = torch.zeros(tsad.saddle_size(ts), dtype=torch.float64)
    with pytest.raises(ValueError, match="plan"):
        tsad.make_linear_operator(ts, tst)(vec)
    with pytest.raises(ValueError, match="plan"):
        tsolvers.solve_mobility_problem(ts, tst, m_dense=None)
