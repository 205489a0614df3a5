"""Roller suspensions of the PyTorch port against the JAX package,
float64 on the CPU (models/rollers.py; every hydrodynamic product runs
K1's plain version here).

- each of the nine schemes, hydro on and off, free_kinematics True and
  False: 3 steps from the same start, solver tolerance 1e-10, final
  positions agreeing to 1e-9 of the displacement and the same GMRES and
  Lanczos iteration counts on every step. Stochastic schemes feed the
  port's noise helper the normals the JAX stepper draws from its key;
- the lockstep det+stochastic update equals the separate solves; the
  torque solve meets the omega constraint; the wall-rejection retry is
  bounded; `from_reference` carries a JAX suspension across, its spectral
  fields included; periodic boxes of the direct engine are refused;
- the wall-spectral domain (16 rollers in a 14 x 14 box,
  stochastic_adams_bashforth_rollers, constrained omega): 2 steps from the
  same start with the JAX stepper's normals fed in, final positions to
  1e-8 of the displacement and the same solver counts, the carried plan
  refreshed as the JAX package refreshes it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rigidmultiblobswall_tpu.models import rollers as jrol
from rigidmultiblobswall_tpu.ops import mobility as jmob
from rigidmultiblobswall_tpu_torch.models import rollers as trol
from rigidmultiblobswall_tpu_torch.ops import mobility as tmob

from torch_parity import to_np

TOL = 1e-9
N = 5
DT = 1e-3
N_STEPS = 3


def _suspensions(n=N, **kw):
    base = dict(num_rollers=n, eta=0.9, blob_radius=0.3, kT=0.05, g=1.0,
                repulsion_strength_wall=1.0, debye_length_wall=0.3,
                repulsion_strength=0.5, debye_length=0.3,
                solver_tolerance=1e-10, omega_one_roller=(0.3, 4.0, 0.0),
                lanczos_max_iter=40)
    base.update(kw)
    jsus = jrol.RollerSuspension(**base)
    return jsus, trol.from_reference(jsus)


def _positions(n=N, seed=0):
    rng = np.random.default_rng(seed)
    r = rng.uniform(-1.5, 1.5, (n, 3))
    r[:, 2] = rng.uniform(0.5, 1.5, n)
    return r


def _jax_normals(scheme, sus, key):
    """The normals one attempt of the JAX stepper draws from its step key,
    in the order the port draws them."""
    _, sub = jax.random.split(key)            # make_stepper's attempt key
    n = sus.num_rollers
    hydro = sus.hydro_interactions
    drift = sus.kT > 0 and sus.domain != "no_wall"
    noise_shape = (3 * n,) if hydro else (n, 3)

    def normal(k, shape):
        return np.array(jax.random.normal(k, shape, dtype=jnp.float64))

    if scheme.startswith("deterministic"):
        return []
    if scheme in ("stochastic_first_order_rollers",
                  "stochastic_adams_bashforth_rollers",
                  "stochastic_EM_rollers"):
        k_noise, k_rfd = jax.random.split(jax.random.split(sub)[1])
        if scheme == "stochastic_EM_rollers":
            return [normal(k_noise, noise_shape)]
        if sus.free_kinematics:
            out = [normal(k_noise, noise_shape)]
            return out + ([normal(k_rfd, (n, 3))] if hydro and drift else [])
        # grand Lanczos noise, then one RFD displacement
        return ([normal(k_noise, (6 * n,))]
                + ([normal(k_rfd, (n, 3))] if drift else []))
    if scheme == "stochastic_GDC_rollers":
        return [normal(jax.random.split(sub)[0], noise_shape)]
    keys = jax.random.split(sub, 3 if "mid_point" in scheme else 2)
    out = [normal(keys[0], (n, 3))] if drift else []
    return out + [normal(k, noise_shape) for k in keys[1:]]


def _run_both(jsus, tsus, scheme, r0, monkeypatch, n_steps=N_STEPS):
    keys = [jax.random.PRNGKey(100 + i) for i in range(n_steps)]
    feed = iter([z for k in keys for z in _jax_normals(scheme, jsus, k)])

    def jax_draws(generator, shape, like):
        z = next(feed)
        assert z.shape == tuple(shape)
        return torch.as_tensor(z, dtype=like.dtype, device=like.device)

    monkeypatch.setattr(trol, "draw_normal", jax_draws)
    jstep = jax.jit(jrol.make_stepper(jsus, scheme, DT))
    tstep = trol.make_stepper(tsus, scheme, DT)
    jr, jc = jnp.asarray(r0), jrol.init_carry(jsus)
    tr_ = torch.as_tensor(r0)
    tc = trol.init_carry(tsus, positions=tr_)
    gen = torch.Generator().manual_seed(0)
    iters = []
    for k in keys:
        jr, jc, jaux = jstep(jr, k, jc)
        tr_, tc, taux = tstep(tr_, gen, tc)
        iters.append(((int(jaux.det_iterations), int(jaux.stoch_iterations),
                       int(jaux.rejections), int(jaux.wall_overlaps)),
                      (taux.det_iterations, taux.stoch_iterations,
                       taux.rejections, taux.wall_overlaps)))
    assert next(feed, None) is None   # the port drew every JAX normal
    return np.asarray(jr), to_np(tr_), iters


@pytest.mark.parametrize("free", [False, True])
@pytest.mark.parametrize("hydro", [True, False])
@pytest.mark.parametrize("scheme", jrol.available_schemes())
def test_scheme_matches_jax(scheme, hydro, free, monkeypatch):
    jsus, tsus = _suspensions(hydro_interactions=hydro,
                              free_kinematics=free)
    r0 = _positions(seed=1)
    jfinal, tfinal, iters = _run_both(jsus, tsus, scheme, r0, monkeypatch)
    disp = np.abs(jfinal - r0).max()
    assert disp > 1e-4                       # the rollers really moved
    np.testing.assert_allclose(tfinal, jfinal, atol=TOL * disp, rtol=0)
    for jit, tit in iters:
        assert tit == jit
    if hydro and not (free and scheme.startswith("deterministic")):
        assert any(j[0] + j[1] > 0 for j, _ in iters)


def test_lockstep_matches_separate_solves():
    """Mirrors tests/test_rollers.py: the fused constrained-omega update
    (one lockstep M_rr Krylov loop, one shared M_tr sweep) equals
    deterministic_velocity_and_torque + stochastic_velocity on the same
    normals."""
    _, sus = _suspensions(10, kT=0.2, free_kinematics=False,
                          omega_one_roller=(0.0, 4.0, 0.0),
                          solver_tolerance=1e-12)
    r = torch.as_tensor(_positions(10, seed=3))
    v_ref, t_ref, _ = trol.deterministic_velocity_and_torque(sus, r)
    vs_ref, itl_ref, _ = trol.stochastic_velocity(
        sus, r, torch.Generator().manual_seed(7), 1e-3)
    v, t, vs, it, it_l = trol.det_stoch_velocity_lockstep(
        sus, r, torch.Generator().manual_seed(7), 1e-3)
    scale_v = float(v_ref.abs().max())
    assert float((v - v_ref).abs().max()) < 1e-8 * scale_v
    assert float((t - t_ref).abs().max()) < 1e-8 * float(t_ref.abs().max())
    assert float((vs - vs_ref).abs().max()) < 1e-8 * max(
        float(vs_ref.abs().max()), scale_v)
    assert it_l == itl_ref and it > 0


@pytest.mark.parametrize("domain", ["single_wall", "no_wall"])
def test_torque_solve_meets_omega_constraint(domain):
    _, sus = _suspensions(6, free_kinematics=False, domain=domain,
                          solver_tolerance=1e-12)
    r = torch.as_tensor(_positions(6, seed=4))
    v, t, iters = trol.deterministic_velocity_and_torque(sus, r)
    force = trol.roller_forces(sus, r)
    kw = sus.mobility_kwargs
    w = (tmob.mobility_rot_times_force(r, force, sus.eta, sus.blob_radius,
                                       **kw)
         + tmob.mobility_rot_times_torque(r, t, sus.eta, sus.blob_radius,
                                          **kw))
    omega = np.tile(sus.omega_one_roller, (6, 1))
    np.testing.assert_allclose(to_np(w), omega, atol=1e-9, rtol=0)
    assert iters > 0


def test_wall_rejection_retries_are_bounded():
    """A step that always crosses the wall retries max_rejections times
    and reports it, as the JAX stepper does."""
    _, sus = _suspensions(4, g=1e5)
    r = torch.as_tensor(_positions(4, seed=5))
    step = trol.make_stepper(sus, "stochastic_adams_bashforth_rollers", 1.0,
                             max_rejections=3)
    r1, _, aux = step(r, torch.Generator().manual_seed(0),
                      trol.init_carry(sus, positions=r))
    assert aux.rejections == 2
    assert float(r1[:, 2].min()) < 0 and aux.wall_overlaps == 4


def test_from_reference_and_refusals():
    jsus, tsus = _suspensions(free_kinematics=False, kT=0.1)
    for f in dataclasses.fields(tsus):
        assert getattr(tsus, f.name) == getattr(jsus, f.name), f.name
    with pytest.raises(NotImplementedError,
                       match="torque_fn.*JAX-traced.*own torch hook"):
        trol.from_reference(dataclasses.replace(
            jsus, torque_fn=lambda sus, r: r))
    # the wall-spectral domain (formerly refused) carries across with its
    # spectral fields; its engine needs a slab top, as in the JAX package
    jspec = jrol.RollerSuspension(
        num_rollers=N, domain="single_wall_spectral",
        periodic_length=(8.0, 8.0, 0.0), spectral_wall_height=2.0,
        spectral_tol=1e-3, spectral_grid_max=64, spectral_cell_capacity=24,
        spectral_bucket_capacity=16)
    tspec = trol.from_reference(jspec)
    for f in dataclasses.fields(tspec):
        assert getattr(tspec, f.name) == getattr(jspec, f.name), f.name
    assert trol._roller_spectral_params(tspec).cell_capacity == 24
    # the TPU gridding knob has no counterpart and is dropped
    assert not hasattr(tspec, "spectral_bucket_capacity")
    with pytest.raises(ValueError, match="spectral_wall_height"):
        trol._roller_spectral_params(dataclasses.replace(
            tspec, spectral_wall_height=0.0))
    # the direct engine's periodic image boxes (formerly refused) carry
    # across, and its grand product matches JAX's on the same inputs
    jbox = jrol.RollerSuspension(num_rollers=N,
                                 periodic_length=(8.0, 8.0, 0.0))
    tbox = trol.RollerSuspension(num_rollers=N,
                                 periodic_length=(8.0, 8.0, 0.0))
    assert tbox == trol.from_reference(jbox)
    r = _positions(seed=3)
    f, t = np.random.default_rng(4).normal(size=(2, N, 3))
    u_ref, w_ref = jmob.grand_mobility_matvec(
        jnp.asarray(r), jnp.asarray(f), jnp.asarray(t), jbox.eta,
        jbox.blob_radius, **jbox.mobility_kwargs)
    u, w = tmob.grand_mobility_matvec(
        torch.as_tensor(r), torch.as_tensor(f), torch.as_tensor(t),
        tbox.eta, tbox.blob_radius, **tbox.mobility_kwargs)
    np.testing.assert_allclose(to_np(u), np.asarray(u_ref), rtol=0,
                               atol=1e-12 * np.abs(np.asarray(u_ref)).max())
    np.testing.assert_allclose(to_np(w), np.asarray(w_ref), rtol=0,
                               atol=1e-12 * np.abs(np.asarray(w_ref)).max())
    with pytest.raises(ValueError):
        trol.make_stepper(tsus, "no_such_scheme", DT)


def test_simulate_saves_every_k_steps():
    _, sus = _suspensions(4, kT=0.05)
    r = torch.as_tensor(_positions(4, seed=6))
    rf, traj, auxs = trol.simulate(
        sus, r, torch.Generator().manual_seed(2),
        scheme="stochastic_adams_bashforth_rollers", dt=DT, n_steps=4,
        save_every=2)
    assert traj.shape == (2, 4, 3) and len(auxs) == 2
    assert torch.equal(traj[-1], rf) and bool(torch.isfinite(rf).all())


def test_wall_spectral_step_matches_jax(monkeypatch):
    """16 rollers on domain single_wall_spectral (the scene of
    tests/test_wall_rot_engine.py's rollers case, tolerance 1e-3 to keep
    the JAX compile short): 2 steps of stochastic_adams_bashforth_rollers
    through make_stepper with the carried plan, the JAX normals fed in;
    final positions to 1e-8 of the displacement, the same GMRES and
    Lanczos counts, no rejections."""
    from rigidmultiblobswall_tpu.ops import ewald_wall as jew
    from rigidmultiblobswall_tpu.ops import ewald_wall_rot as jewr

    from test_torch_wall_rot import _jax_zdft_real64
    from torch_parity import jax_zdft64

    monkeypatch.setattr(jew, "_host_zdft", jax_zdft64)
    monkeypatch.setattr(jewr, "_host_zdft_real", _jax_zdft_real64)
    n, L = 16, 14.0
    rng = np.random.default_rng(11)
    r0 = np.stack([rng.uniform(0, L, n), rng.uniform(0, L, n),
                   rng.uniform(0.55, 1.2, n)], axis=1)
    jsus = jrol.RollerSuspension(
        num_rollers=n, eta=0.9, blob_radius=0.5, kT=2e-3, g=0.05,
        repulsion_strength=0.1, debye_length=0.2,
        repulsion_strength_wall=0.1, debye_length_wall=0.2,
        solver_tolerance=1e-8, free_kinematics=False,
        omega_one_roller=(0.0, 4.0, 0.0), lanczos_max_iter=12,
        periodic_length=(L, L, 0.0), domain="single_wall_spectral",
        spectral_tol=1e-3, spectral_wall_height=1.4)
    tsus = trol.from_reference(jsus)
    scheme = "stochastic_adams_bashforth_rollers"
    keys = [jax.random.PRNGKey(100 + i) for i in range(2)]
    feed = iter([z for k in keys for z in _jax_normals(scheme, jsus, k)])

    def jax_draws(generator, shape, like):
        z = next(feed)
        assert z.shape == tuple(shape)
        return torch.as_tensor(z, dtype=like.dtype, device=like.device)

    monkeypatch.setattr(trol, "draw_normal", jax_draws)
    jstep = jax.jit(jrol.make_stepper(jsus, scheme, DT))
    tstep = trol.make_stepper(tsus, scheme, DT)
    jr = jnp.asarray(r0)
    jc = jrol.init_carry(jsus, dtype=jnp.float64, positions=jr)
    tr_ = torch.as_tensor(r0)
    tc = trol.init_carry(tsus, positions=tr_)
    assert tc.plan.params.grid == jc.plan.params.grid
    gen = torch.Generator().manual_seed(0)
    for k in keys:
        jr, jc, jaux = jstep(jr, k, jc)
        tr_, tc, taux = tstep(tr_, gen, tc)
        assert (taux.det_iterations, taux.stoch_iterations, taux.rejections,
                taux.wall_overlaps) == (
            int(jaux.det_iterations), int(jaux.stoch_iterations),
            int(jaux.rejections), int(jaux.wall_overlaps))
        assert taux.det_iterations > 0 and taux.rejections == 0
        assert taux.plan_drops == 0 == int(jc.plan.n_dropped_cells)
    assert next(feed, None) is None
    disp = np.abs(np.asarray(jr) - r0).max()
    assert disp > 1e-4
    np.testing.assert_allclose(to_np(tr_), np.asarray(jr), atol=1e-8 * disp,
                               rtol=0)
    vel = np.asarray(jaux.velocities)
    assert np.abs(to_np(taux.velocities) - vel).max() <= 1e-8 * np.abs(
        vel).max()


def test_wall_spectral_step_reports_plan_drops():
    """A wall-spectral step on a carry without a plan builds one at r, and
    reports the points its full cells left out (here a capacity of 1)."""
    n, L = 16, 14.0
    rng = np.random.default_rng(11)
    r0 = torch.as_tensor(np.stack([rng.uniform(0, L, n), rng.uniform(0, L, n),
                                   rng.uniform(0.55, 1.2, n)], axis=1))
    sus = trol.RollerSuspension(
        num_rollers=n, eta=0.9, blob_radius=0.5, g=0.05,
        free_kinematics=False, omega_one_roller=(0.0, 4.0, 0.0),
        periodic_length=(L, L, 0.0), domain="single_wall_spectral",
        spectral_tol=1e-3, spectral_wall_height=1.4, spectral_cell_capacity=1)
    want = int(trol.init_carry(sus, positions=r0).plan.n_dropped_cells)
    assert want > 0
    step = trol.make_stepper(sus, "deterministic_forward_euler_rollers", DT)
    r1, carry, aux = step(r0, torch.Generator(),
                          trol.init_carry(sus, device="cpu"))
    assert aux.plan_drops == want and carry.plan is not None
    assert bool(torch.isfinite(r1).all())


def test_wall_plan_auto_capacity_bins_bench_lattice():
    """bench.py's wall rollers (32,768 rollers at z = 1.2 on a 1.6-spaced
    lattice with 0.1 jitter, box 291.2, slab top 1.8, tolerance 1e-4, grid
    at most 512) at the automatic cell capacity: the plan bins all 65,536
    real and image points (a mean over the data slab's z layers gave 48
    and dropped 378: the reals and images share one z layer). A plan
    build on the CPU; no product is evaluated. A rebuild keeps the
    capacity."""
    from rigidmultiblobswall_tpu_torch.ops import cells as tcells
    from rigidmultiblobswall_tpu_torch.ops import ewald_wall as tew

    n = 32768
    side = int(np.ceil(n ** 0.5))
    idx = np.arange(n)
    rng = np.random.default_rng(0)
    r0 = np.stack([(idx % side) * 1.6, (idx // side) * 1.6,
                   np.full(n, 1.2)], axis=1).astype(np.float32)
    r0[:, :2] += rng.uniform(-0.1, 0.1, size=(n, 2))
    sus = trol.RollerSuspension(
        num_rollers=n, blob_radius=0.5, domain="single_wall_spectral",
        periodic_length=(side * 1.6, side * 1.6, 0.0),
        spectral_wall_height=1.8, spectral_tol=1e-4, spectral_grid_max=512)
    params = trol._roller_spectral_params(sus)
    assert params.cell_capacity == 0
    r = torch.as_tensor(r0)
    plan = tew.make_wall_plan(params, r)
    cap = plan.params.cell_capacity
    counts = torch.bincount(tcells.cell_ids(
        plan.pos_all, tew._bin_box(plan.params, plan.cell_dims),
        plan.cell_dims))
    assert int(plan.n_dropped_cells) == 0
    assert cap % 8 == 0 and cap >= int(counts.max()) + 16
    # a rebuild past the drift budget keeps the resolved capacity
    moved = tew.update_wall_plan(plan, r + torch.tensor([3.0, 0.0, 0.0]))
    assert moved.sort_pos is not plan.sort_pos
    assert moved.params.cell_capacity == cap
    assert int(moved.n_dropped_cells) == 0
