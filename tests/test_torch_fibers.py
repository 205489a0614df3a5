"""The PyTorch port's inextensible fibers (models/fibers.py) against the
JAX package, float64 on the CPU: each oracle of tests/test_fibers.py with
a parity counterpart (frames, positions, the bending energy and force,
the stencils, K, Kinv, B, B^T and their dense forms, the mobilities of
both modes and domains, the system, its preconditioner and solve with
equal GMRES counts, the noise, the RFD), three steps of each scheme on
JAX's own draws fed, simulate's saves, the stresslets, from_reference,
the full mode's route to K1's square product, and the fibers example's
twin against the JAX script."""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rigidmultiblobswall_tpu.models import fibers as jfib
from rigidmultiblobswall_tpu_torch.examples import fibers_run
from rigidmultiblobswall_tpu_torch.models import fibers as tfib
from rigidmultiblobswall_tpu_torch.ops import pair_kernels

from torch_parity import to_np

ROOT = Path(__file__).resolve().parents[1]
CLAMPS = [False, True]
MODES = ["batched", "full"]
DOMAINS = ["no_wall", "single_wall"]


def _close(got, ref, tol):
    got, ref = to_np(got), to_np(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * max(np.abs(ref).max(), 1.0))


def _jsus(**kw):
    args = dict(num_fibers=3, num_links=8, ds=0.25, a=0.125, k_bend=1.0,
                eta=1.0, kT=0.0)
    args.update(kw)
    return jfib.FiberSuspension(**args)


def _jstate(js, seed=0, bend=0.3, height=3.0):
    """tests/test_fibers.py's random smoothly bent state (numpy seed)."""
    rng = np.random.default_rng(seed)
    t = np.tile(np.array([0.0, 0.0, 1.0]), (js.num_fibers, js.num_links, 1))
    t += bend * rng.normal(size=t.shape)
    t /= np.linalg.norm(t, axis=-1, keepdims=True)
    t = jnp.asarray(t)
    u, v = jfib.bishop_frame(t)
    x0 = jnp.asarray(rng.normal(size=(js.num_fibers, 3)) + height)
    return jfib.FiberState(x0=x0, t=t, u=u, v=v)


def _pair(seed=0, **kw):
    """(jax suspension, jax state, port suspension, port state)."""
    js = _jsus(**kw)
    jst = _jstate(js, seed=seed)
    ts, tst = tfib.from_reference(js, jst, device="cpu")
    return js, jst, ts, tst


def _t(x):
    return torch.as_tensor(np.array(x))


# ---------------------------------------------------------------------------
# Geometry and elasticity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("clamp", CLAMPS)
def test_frames_positions_energy_force_match_jax(clamp):
    js, jst, ts, tst = _pair(seed=1, clamp=clamp, t_fix=(0.0, 1.0, 0.0))
    u, v = tfib.bishop_frame(tst.t)
    _close(u, jst.u, 1e-12)
    _close(v, jst.v, 1e-12)
    # a given u0
    u0 = jst.u[:, 0] * -1.0
    ju, jv = jfib.bishop_frame(jst.t, u0)
    tu, tv = tfib.bishop_frame(tst.t, _t(u0))
    _close(tu, ju, 1e-12)
    _close(tv, jv, 1e-12)
    _close(tfib.blob_positions(ts, tst), jfib.blob_positions(js, jst), 1e-12)
    _close(tfib.end_to_end_distance(ts, tst),
           jfib.end_to_end_distance(js, jst), 1e-12)
    _close(tfib.bending_energy(ts, tst.t), jfib.bending_energy(js, jst.t),
           1e-12)
    _close(tfib.bending_force(ts, tst.t), jfib.bending_force(js, jst.t),
           1e-12)


def test_straight_state_matches_jax():
    js = _jsus()
    ts = tfib.from_reference(js)
    x0 = np.array([[0.0, 0.0, 0.0], [1.0, 2.0, 3.0], [-1.0, 0.5, 2.0]])
    for direction in ([0.0, 1.0, 0.0], [1.0, 0.0, 0.0], [1.0, 1.0, 2.0]):
        ref = jfib.straight_fiber_state(js, x0, direction)
        got = tfib.straight_fiber_state(ts, x0, direction, device="cpu")
        for g, r in zip(got, ref):
            _close(g, r, 1e-12)


@pytest.mark.parametrize("clamp", CLAMPS)
def test_stencils_match_jax(clamp):
    js = _jsus(clamp=clamp)
    ts = tfib.from_reference(js)
    d4 = tfib.d4_matrix(ts, device="cpu")
    assert d4.dtype == torch.float64
    np.testing.assert_array_equal(to_np(d4), np.asarray(jfib.d4_matrix(js)))
    np.testing.assert_array_equal(to_np(tfib.d2t_matrix(ts, device="cpu")),
                                  np.asarray(jfib.d2t_matrix(js)))
    assert tfib.d4_matrix(ts, torch.float32, "cpu").dtype == torch.float32


# ---------------------------------------------------------------------------
# Kinematic operators
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("clamp", CLAMPS)
def test_kinematic_operators_match_jax(clamp):
    js, jst, ts, tst = _pair(seed=2, clamp=clamp)
    rng = np.random.default_rng(3)
    om = rng.normal(size=(js.num_fibers, js.n_om))
    theta = rng.normal(size=(js.num_fibers, js.n_theta))
    vel = rng.normal(size=(js.num_fibers, js.num_blobs_per_fiber, 3))
    _close(tfib.apply_K(ts, _t(om), tst.u, tst.v),
           jfib.apply_K(js, jnp.asarray(om), jst.u, jst.v), 1e-12)
    _close(tfib.apply_Kinv(ts, _t(vel), tst.u, tst.v),
           jfib.apply_Kinv(js, jnp.asarray(vel), jst.u, jst.v), 1e-12)
    _close(tfib.apply_B(ts, _t(theta), tst.t),
           jfib.apply_B(js, jnp.asarray(theta), jst.t), 1e-12)
    _close(tfib.apply_BT(ts, _t(vel), tst.t),
           jfib.apply_BT(js, jnp.asarray(vel), jst.t), 1e-12)
    _close(tfib.k_dense(ts, tst.u, tst.v), jfib.k_dense(js, jst.u, jst.v),
           1e-12)
    _close(tfib.b_dense(ts, tst.t), jfib.b_dense(js, jst.t), 1e-12)
    # split and merge round trip
    w, rates = tfib.split_om(ts, _t(om))
    np.testing.assert_array_equal(to_np(tfib.merge_om(ts, w, rates)), om)


# ---------------------------------------------------------------------------
# Mobility, noise, RFD
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("domain", DOMAINS)
def test_mobility_matches_jax(mode, domain):
    # heights near the wall, so the overlap regularization acts
    js, jst, ts, tst = _pair(seed=4, hydrodynamics=mode, domain=domain)
    jst = jst._replace(x0=jst.x0.at[:, 2].set(0.05))
    tst = tst._replace(x0=_t(jst.x0))
    jpos, tpos = jfib.blob_positions(js, jst), tfib.blob_positions(ts, tst)
    _close(tfib.mobility_dense_batched(ts, tpos),
           jfib.mobility_dense_batched(js, jpos), 1e-12)
    f = np.random.default_rng(5).normal(size=tuple(jpos.shape))
    _close(tfib.mobility_matvec(ts, tpos, _t(f)),
           jfib.mobility_matvec(js, jpos, jnp.asarray(f)), 1e-12)


@pytest.mark.parametrize("mode", MODES)
def test_noise_and_rfd_match_jax(mode):
    js, jst, ts, tst = _pair(seed=6, hydrodynamics=mode, domain="single_wall",
                             solver_tolerance=1e-8)
    jpos, tpos = jfib.blob_positions(js, jst), tfib.blob_positions(ts, tst)
    key = jax.random.PRNGKey(7)
    ref, ref_its = jfib.sqrt_mobility_noise(js, jpos, key)
    w = jax.random.normal(key, (js.num_fibers, 3 * js.num_blobs_per_fiber))
    got, its = tfib.sqrt_mobility_noise(ts, tpos, w=_t(w))
    _close(got, ref, 1e-10)
    assert its == int(ref_its)
    if mode == "full":
        assert its > 1
    key = jax.random.PRNGKey(8)
    w = jax.random.normal(key, (js.num_fibers, js.num_blobs_per_fiber, 3))
    _close(tfib.m_rfd(ts, tst, w=_t(w)), jfib.m_rfd(js, jst, key), 1e-10)


def test_cholesky_failure_raises():
    js, jst, ts, tst = _pair(seed=6)
    pos = tfib.blob_positions(ts, tst)
    m = tfib.mobility_dense_batched(ts, pos).clone()
    m[1] = -m[1]
    with pytest.raises(RuntimeError, match="Cholesky factorization failed "
                       r"for fibers \[1\]"):
        tfib.sqrt_mobility_noise(ts, pos, w=torch.zeros(3, 27,
                                                        dtype=torch.float64),
                                 m_batched=m)


# ---------------------------------------------------------------------------
# The linear system
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("clamp", CLAMPS)
def test_system_and_solve_match_jax(mode, clamp):
    js, jst, ts, tst = _pair(seed=8, clamp=clamp, hydrodynamics=mode,
                             domain="single_wall", solver_tolerance=1e-10)
    impl = 0.5 * 1e-3 * js.k_bend / js.ds ** 3
    _close(tfib.system_matrix_batched(ts, impl, tst),
           jfib.system_matrix_batched(js, impl, jst), 1e-10)
    rng = np.random.default_rng(9)
    x = rng.normal(size=js.num_fibers * 3 * js.num_blobs_per_fiber)
    _close(tfib.apply_system(ts, impl, tst, _t(x)),
           jfib.apply_system(js, impl, jst, jnp.asarray(x)), 1e-10)
    _close(tfib.factor_pc(ts, impl, tst)(_t(x)),
           jfib.factor_pc(js, impl, jst)(jnp.asarray(x)), 1e-10)
    rhs = rng.normal(size=(js.num_fibers, js.num_blobs_per_fiber, 3))
    jom, jth, (jits, jres, jconv) = jfib.solve_fiber_system(
        js, impl, jst, jnp.asarray(rhs))
    om, th, (its, res, conv) = tfib.solve_fiber_system(ts, impl, tst, _t(rhs))
    _close(om, jom, 1e-10)
    _close(th, jth, 1e-10)
    assert int(its) == int(jits)
    assert bool(conv) and bool(jconv)
    if mode == "full":
        assert its > 1
        assert abs(float(res) - float(jres)) <= 1e-6 * float(jres) + 1e-14


# ---------------------------------------------------------------------------
# Stepping on JAX's draws
# ---------------------------------------------------------------------------


def jax_draws(key, js):
    """The FiberDraws a JAX stochastic step of `js` draws from `key`."""
    k1, k2, k3 = jax.random.split(key, 3)
    F, B = js.num_fibers, js.num_blobs_per_fiber
    cn = abs(js.impl_c - 1.0) > 1e-5
    w1 = jax.random.normal(k1, (F, 3 * B), dtype=jnp.float64)
    w2 = jax.random.normal(k2, (F, 3 * B) if cn else (F, B - 2, 3),
                           dtype=jnp.float64)
    w_rfd = jax.random.normal(k3, (F, B, 3), dtype=jnp.float64)
    return tfib.FiberDraws(_t(w1), _t(w2), _t(w_rfd))


STEP_CASES = [(kind, clamp, mode)
              for kind in ("deterministic", "cn", "be")
              for clamp in CLAMPS for mode in MODES
              if not (kind == "be" and clamp)]


@pytest.mark.parametrize("kind,clamp,mode", STEP_CASES)
def test_three_steps_match_jax(kind, clamp, mode):
    """Three steps from a bent state; clamped fibers stand above the wall
    (their bases at z = 0.3), free ones in the open."""
    kw = dict(clamp=clamp, hydrodynamics=mode, solver_tolerance=1e-10,
              kT=0.0 if kind == "deterministic" else 0.05,
              impl_c=1.0 if kind == "be" else 0.5,
              domain="single_wall" if clamp else "no_wall")
    js = _jsus(**kw)
    jst = _jstate(js, seed=10, height=0.3 if clamp else 3.0)
    if clamp:
        jst = jst._replace(x0=jst.x0.at[:, 2].set(0.3))
    ts, tst = tfib.from_reference(js, jst, device="cpu")
    dt = 0.5 * (js.ds ** 3 / js.m0) / js.k_bend
    jstep = jfib.make_stepper(js, dt)
    tstep = tfib.make_stepper(ts, dt)
    x_start = to_np(tfib.blob_positions(ts, tst))
    for i in range(3):
        key = jax.random.PRNGKey(100 + i)
        jst, jaux = jstep(jst, key)
        draws = jax_draws(key, js) if js.kT > 0 else None
        tst, aux = tstep(tst, None, draws)
        assert int(aux.iterations) == int(jaux.iterations)
        assert bool(aux.converged) and bool(jaux.converged)
        _close(aux.rates, jaux.rates, 1e-9)
        _close(aux.tensions, jaux.tensions, 1e-9)
    pos = to_np(tfib.blob_positions(ts, tst))
    ref = np.asarray(jfib.blob_positions(js, jst))
    disp = np.abs(ref - x_start).max()
    assert disp > 1e-6
    np.testing.assert_allclose(pos, ref, rtol=0, atol=1e-9 * disp)
    for name in ("t", "u", "v"):
        _close(getattr(tst, name), getattr(jst, name), 1e-9)
    if clamp:
        np.testing.assert_array_equal(to_np(tst.x0), np.asarray(jst.x0))
    if mode == "full" and js.kT > 0:
        assert aux.lanczos_iterations > 2
    np.testing.assert_allclose(np.linalg.norm(to_np(tst.t), axis=-1), 1.0,
                               atol=1e-12)


def test_backward_euler_noise_refuses_clamped_fibers():
    js, jst, ts, tst = _pair(clamp=True, kT=0.05, impl_c=1.0)
    with pytest.raises(NotImplementedError, match="backward-Euler"):
        jfib.make_stepper(js, 1e-3)(jst, jax.random.PRNGKey(0))
    with pytest.raises(NotImplementedError, match="backward-Euler"):
        tfib.make_stepper(ts, 1e-3)(tst, torch.Generator().manual_seed(0))


def test_force_hook_matches_jax():
    """A force_fn: the JAX hook on JAX arrays, the port's on tensors."""
    js, jst, ts, tst = _pair(seed=11, kT=0.05)

    def jforce(sus, pos):
        return jnp.broadcast_to(jnp.asarray([0.0, 0.3, -1.0]), pos.shape) \
            * (1.0 + pos[..., 2:3])

    def tforce(sus, pos):
        return pos.new_tensor([0.0, 0.3, -1.0]) * (1.0 + pos[..., 2:3])

    js = dataclasses.replace(js, force_fn=jforce)
    ts = dataclasses.replace(ts, force_fn=tforce)
    dt = 0.5 * (js.ds ** 3 / js.m0) / js.k_bend
    key = jax.random.PRNGKey(3)
    jnew, _ = jfib.make_stepper(js, dt)(jst, key)
    tnew, _ = tfib.make_stepper(ts, dt)(tst, None, jax_draws(key, js))
    _close(tfib.blob_positions(ts, tnew), jfib.blob_positions(js, jnew), 1e-9)


def test_generator_draws_in_jax_order():
    """Without draws the step takes w1, w2 and w_rfd from the generator in
    that order (JAX's k1, k2, k3), each of JAX's shape."""
    for impl_c, w2_shape in ((0.5, (3, 27)), (1.0, (3, 7, 3))):
        js, jst, ts, tst = _pair(seed=12, kT=0.05, impl_c=impl_c)
        d = tfib.draw(ts, torch.Generator().manual_seed(5), torch.float64,
                      "cpu")
        g = torch.Generator().manual_seed(5)
        w1 = torch.randn((3, 27), generator=g, dtype=torch.float64)
        w2 = torch.randn(w2_shape, generator=g, dtype=torch.float64)
        w_rfd = torch.randn((3, 9, 3), generator=g, dtype=torch.float64)
        for got, ref in zip(d, (w1, w2, w_rfd)):
            assert torch.equal(got, ref)
        step = tfib.make_stepper(ts, 1e-3)
        a, _ = step(tst, torch.Generator().manual_seed(5))
        b, _ = step(tst, None, d)
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_simulate_matches_jax():
    """simulate's saves and the last aux of each save, on the draws of
    JAX's key schedule (one split a step)."""
    js, jst, ts, tst = _pair(seed=13, kT=0.05)
    dt = 0.5 * (js.ds ** 3 / js.m0) / js.k_bend
    key = jax.random.PRNGKey(42)
    jfinal, jtraj, jaux = jfib.simulate(js, jst, key, dt=dt, n_steps=5,
                                        save_every=2)
    draws = []
    for _ in range(4):
        key, sub = jax.random.split(key)
        draws.append(jax_draws(sub, js))
    final, traj, aux = tfib.simulate(ts, tst, None, dt=dt, n_steps=5,
                                     save_every=2, draws=draws)
    for got, ref in zip(traj, jtraj):
        _close(got, ref, 1e-9)
    for got, ref in zip(final, jfinal):
        _close(got, ref, 1e-9)
    _close(aux.rates, jaux.rates, 1e-9)
    np.testing.assert_array_equal(to_np(aux.iterations),
                                  np.asarray(jaux.iterations))
    assert to_np(aux.converged).all()


def test_full_mode_products_take_the_square_call(monkeypatch):
    """Every full-mode product reaches K1 as the square product (q_tgt
    None, the symmetric sweep on the card), none with two tensors."""
    calls = []
    plain = pair_kernels.pair_matvec

    def spy(q_src, q_tgt, vec, **kw):
        calls.append((q_tgt is None, kw["coupling"], q_src.shape[0]))
        return plain(q_src, q_tgt, vec, **kw)

    monkeypatch.setattr(pair_kernels, "pair_matvec", spy)
    js, jst, ts, tst = _pair(seed=14, clamp=True, kT=0.05,
                             hydrodynamics="full", domain="single_wall")
    tst = tst._replace(x0=tst.x0 * torch.tensor([1.0, 1.0, 0.0]) + 0.3 *
                       torch.tensor([0.0, 0.0, 1.0]))
    step = tfib.make_stepper(ts, 1e-3)
    _, aux = step(tst, torch.Generator().manual_seed(0))
    # rhs, two Lanczos chains, two RFD products, the GMRES iterations
    assert len(calls) >= 3 + aux.lanczos_iterations + aux.iterations
    assert all(c == (True, "tt", ts.num_blobs) for c in calls)


# ---------------------------------------------------------------------------
# Stresslets, from_reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("clamp", CLAMPS)
def test_stresslets_match_jax(clamp):
    js, jst, ts, tst = _pair(seed=15, clamp=clamp)
    f = np.random.default_rng(16).normal(
        size=(js.num_fibers, js.num_blobs_per_fiber, 3))
    _close(tfib.constraint_forces(ts, tst, _t(f)),
           jfib.constraint_forces(js, jst, jnp.asarray(f)), 1e-10)
    _close(tfib.stresslet_deterministic(ts, tst),
           jfib.stresslet_deterministic(js, jst), 1e-10)
    pos = np.asarray(jfib.blob_positions(js, jst))
    _close(tfib.fiber_stresslet(ts, _t(pos), _t(f)),
           jfib.fiber_stresslet(js, jnp.asarray(pos), jnp.asarray(f)), 1e-12)


def test_min_norm_lstsq_matches_jax_on_a_singular_system():
    """constraint_forces' least squares keeps jnp.linalg.lstsq's minimum
    norm solution where the matrix is rank deficient."""
    rng = np.random.default_rng(17)
    a = rng.normal(size=(2, 6, 4))
    n = a @ np.swapaxes(a, -1, -2)            # rank 4 of 6
    b = rng.normal(size=(2, 6))
    got = tfib._lstsq_min_norm(_t(n), _t(b))
    for k in range(2):
        ref = jnp.linalg.lstsq(jnp.asarray(n[k]), jnp.asarray(b[k]))[0]
        _close(got[k], ref, 1e-10)


def test_from_reference_carries_fields_and_refuses_a_jax_hook():
    js = _jsus(kT=0.1, clamp=True, t_fix=(0.0, 1.0, 0.0), impl_c=1.0,
               hydrodynamics="full", domain="single_wall",
               solver_tolerance=1e-6, gmres_restart=7, gmres_maxiter=9,
               rf_delta_factor=0.01)
    jst = _jstate(js)
    ts, tst = tfib.from_reference(js, jst, dtype=torch.float32, device="cpu")
    for f in dataclasses.fields(jfib.FiberSuspension):
        if f.name != "force_fn":
            assert getattr(ts, f.name) == getattr(js, f.name), f.name
    for n in ("num_blobs_per_fiber", "num_blobs", "n_om", "n_theta", "m0"):
        assert getattr(ts, n) == getattr(js, n)
    assert all(x.dtype == torch.float32 for x in tst)
    _close(tst.t, jst.t, 1e-7)
    with pytest.raises(NotImplementedError, match="force_fn"):
        tfib.from_reference(dataclasses.replace(
            js, force_fn=lambda sus, pos: jnp.zeros_like(pos)))
    with pytest.raises(ValueError):
        tfib.FiberSuspension(num_fibers=1, num_links=2, ds=0.1, a=0.05,
                             k_bend=1.0)
    with pytest.raises(ValueError):
        dataclasses.replace(ts, hydrodynamics="sparse")
    with pytest.raises(ValueError):
        dataclasses.replace(ts, domain="periodic")


# ---------------------------------------------------------------------------
# The fibers example's twin
# ---------------------------------------------------------------------------


def _load_jax_script(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_fibers_twin_matches_the_jax_script(tmp_path, monkeypatch, capsys):
    """examples/fibers/run.py and its twin at a tiny size, the twin on the
    JAX script's draws (PRNGKey(0), one split a step) in float64: the
    same end-to-end file to 1e-9 and the same summary lines."""
    argv = ["--fibers", "3", "--links", "5", "--steps", "6",
            "--save-every", "3"]
    jrun = _load_jax_script(ROOT / "examples" / "fibers" / "run.py",
                            "jax_fibers_run")
    monkeypatch.setattr("sys.argv", ["run.py", *argv, "--output",
                                     str(tmp_path / "jax.txt")])
    jrun.main()
    jax_out = capsys.readouterr().out.splitlines()

    args = fibers_run.parser().parse_args(
        [*argv, "--output", str(tmp_path / "torch.txt"), "--device", "cpu",
         "--f64"])
    js = _twin_jax_sus(args)
    key, draws = jax.random.PRNGKey(0), []
    for _ in range(args.steps):
        key, sub = jax.random.split(key)
        draws.append(jax_draws(sub, js))
    e2e = fibers_run.run(args, draws=draws)
    out = capsys.readouterr().out.splitlines()
    ref = np.loadtxt(tmp_path / "jax.txt")
    got = np.loadtxt(tmp_path / "torch.txt")
    assert got.shape == ref.shape == (2, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-9)
    np.testing.assert_allclose(e2e, ref, rtol=0, atol=1e-9)
    assert out[0] == jax_out[0]
    assert out[1].replace("torch.txt", "jax.txt") == jax_out[1]


def _twin_jax_sus(args):
    """The JAX script's suspension (for its draws' shapes)."""
    ds = 2.0 / args.links
    return jfib.FiberSuspension(num_fibers=args.fibers,
                                num_links=args.links, ds=ds, a=ds / 2,
                                k_bend=8.0 * args.kT, kT=args.kT,
                                impl_c=1.0)


def test_fibers_twin_writes_to_the_working_directory(tmp_path, monkeypatch,
                                                     capsys):
    """Without --output the file lands in the working directory, in the
    JAX layout (a row a save, a column a fiber), from torch draws."""
    monkeypatch.chdir(tmp_path)
    fibers_run.main(["--fibers", "2", "--links", "4", "--steps", "4",
                     "--save-every", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    e2e = np.loadtxt(tmp_path / "end_to_end_distances.txt")
    assert e2e.shape == (2, 2) and np.isfinite(e2e).all()
    assert np.all((e2e > 1.5) & (e2e <= 2.0 + 1e-5))
    assert "fibers=2 blobs/fiber=5 " in out and "mean end-to-end" in out
    assert not (ROOT / "rigidmultiblobswall_tpu_torch" / "examples"
                / "end_to_end_distances.txt").exists()
