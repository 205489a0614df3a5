"""The multibody schemes of ROADMAP Queue 1, item 17 in the PyTorch port
against the JAX package, float64 on the CPU: stochastic first-order RFD,
traction EM and AB, Slip-Mid and GDC-RFD, three steps from the same start
with the JAX step's normals fed to the port (at kT = 0 the RFD directions
are random all the same and steer the solves), on the materialized engine
and, with both packages' MATERIALIZE_BUDGET_BYTES at 0, on the
matrix-free one. Each step's GMRES and Lanczos counts are equal, final
positions agree to 1e-9 of the displacement and orientations to 1e-9.
The solver tolerance is 1e-10: near 1e-12 a Givens estimate crosses the
target at rounding level, so the two packages' counts could part by one
for the summation order alone.

Krylov recycling (make_stepper(recycle_k=6)): JAX's recycling scene
(tests/test_solvers.py) through both steppers, equal GMRES counts every
step and final positions to 1e-9 of the displacement. With obstacles:
Slip-Mid, GDC-RFD and Slip-Trapz against JAX, the obstacles' positions
and orientations unchanged; the JAX preconditioner's prescribed block
is made exact for this, as the port's is (a warm-started JAX solve with
obstacles stalls, which a test shows)."""

import jax
import numpy as np
import pytest
import torch

from rigidmultiblobswall_tpu.models import integrators as jint
from rigidmultiblobswall_tpu.models import saddle as jsad
from rigidmultiblobswall_tpu.models import system as jsys
from rigidmultiblobswall_tpu_torch.models import integrators as tint
from rigidmultiblobswall_tpu_torch.models import saddle as tsad
from rigidmultiblobswall_tpu_torch.models import system as tsys

from torch_parity import feed_jax_noise, shell_vertices, shells_scene, to_np

TOL = 1e-9
SCHEMES = ("stochastic_first_order_RFD", "stochastic_traction_EM",
           "stochastic_traction_AB", "stochastic_Slip_Mid",
           "stochastic_GDC_RFD")


def _keys(n):
    return [jax.random.PRNGKey(100 + i) for i in range(n)]


def _run_both(js, jst, ts, tst, scheme, keys, dt, *, recycle_k=0,
              **stepper_kw):
    """The JAX and the port stepper over `keys`; returns the final states
    and each step's (GMRES, Lanczos, rejections) counts of both."""
    jstep = jax.jit(jint.make_stepper(js, scheme, dt, recycle_k=recycle_k,
                                      **stepper_kw))
    jc = jint.init_carry(js, state=jst, recycle_k=recycle_k)
    tstep = tint.make_stepper(ts, scheme, dt, recycle_k=recycle_k,
                              **stepper_kw)
    tc = tint.init_carry(ts, state=tst, recycle_k=recycle_k)
    gen = torch.Generator().manual_seed(0)
    s, t, jcounts, tcounts = jst, tst, [], []
    for k in keys:
        s, jc, jaux = jstep(s, k, jc)
        t, tc, taux = tstep(t, gen, tc)
        jcounts.append((int(jaux.det_iterations), int(jaux.stoch_iterations),
                        int(jaux.rejections)))
        tcounts.append((taux.det_iterations, taux.stoch_iterations,
                        taux.rejections))
        assert taux.solves_converged
    return s, t, jcounts, tcounts


def _assert_same(jfinal, tfinal, jstart):
    disp = np.abs(np.asarray(jfinal.pos) - np.asarray(jstart.pos)).max()
    assert disp > 1e-5                                # the bodies moved
    np.testing.assert_allclose(to_np(tfinal.pos), np.asarray(jfinal.pos),
                               atol=TOL * disp, rtol=0)
    np.testing.assert_allclose(to_np(tfinal.quat), np.asarray(jfinal.quat),
                               atol=TOL, rtol=0)


@pytest.mark.parametrize("engine", ["materialized", "matrix_free"])
@pytest.mark.parametrize("kT", [0.0, 0.05])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_scheme_matches_jax(monkeypatch, scheme, kT, engine):
    if engine == "matrix_free":
        monkeypatch.setattr(jsad, "MATERIALIZE_BUDGET_BYTES", 0)
        monkeypatch.setattr(tsad, "MATERIALIZE_BUDGET_BYTES", 0)
    js, jst, ts, tst, _, _ = shells_scene(3, seed=3, kT=kT,
                                          solver_tolerance=1e-10)
    keys = _keys(3)
    feed_jax_noise(monkeypatch, keys, scheme, js)
    jfinal, tfinal, jcounts, tcounts = _run_both(
        js, jst, ts, tst, scheme, keys, 1e-3, lanczos_tolerance=1e-10)
    assert tcounts == jcounts
    assert all(rej == 0 for _, _, rej in tcounts)
    _assert_same(jfinal, tfinal, jst)


def _recycling_scene():
    """tests/test_solvers.py's recycling scene: nine 8-blob shells on a
    3 x 3 lattice above the wall, kT = 0, solver tolerance 2e-4."""
    rng = np.random.default_rng(3)
    shell = rng.normal(size=(8, 3))
    shell *= 0.4 / np.linalg.norm(shell, axis=1, keepdims=True)
    t = jsys.BodyType(name="s8", ref_config=shell, count=9)
    js = jsys.System(types=(t,), eta=1.0, blob_radius=0.12, kT=0.0, g=0.3,
                     domain="single_wall", solver_tolerance=2e-4)
    idx = np.arange(9)
    pos = np.stack([(idx % 3) * 1.4, (idx // 3) * 1.4, np.full(9, 1.5)],
                   axis=1)
    quat = np.tile([1.0, 0, 0, 0], (9, 1))
    ts, tst = tsys.from_reference(js, pos, quat, device="cpu")
    return js, jsys.make_state(pos, quat), ts, tst


@pytest.mark.parametrize("scheme", ["deterministic_adams_bashforth",
                                    "deterministic_forward_euler",
                                    "stochastic_Slip_Trapz"])
def test_recycling_stepper_matches_jax(scheme):
    """recycle_k = 6 over 4 steps: equal GMRES counts every step and the
    same trajectory."""
    js, jst, ts, tst = _recycling_scene()
    jfinal, tfinal, jcounts, tcounts = _run_both(
        js, jst, ts, tst, scheme, _keys(4), 5e-4, recycle_k=6,
        gmres_maxiter=200, max_rejections=2)
    assert tcounts == jcounts
    _assert_same(jfinal, tfinal, jst)


def test_recycling_cuts_the_gmres_work():
    """The port alone, as tests/test_solvers.py holds the JAX package:
    the first step is the plain one, the recycled steps are cheaper, and
    the trajectory stays within the solver tolerance."""
    _, _, ts, tst = _recycling_scene()
    trajs, iters = {}, {}
    for k in (0, 6):
        step = tint.make_stepper(ts, "deterministic_adams_bashforth", 5e-4,
                                 gmres_maxiter=200, max_rejections=2,
                                 recycle_k=k)
        carry = tint.init_carry(ts, state=tst)
        s, its = tst, []
        for _ in range(4):
            s, carry, aux = step(s, torch.Generator(), carry)
            its.append(aux.det_iterations)
        trajs[k], iters[k] = to_np(s.pos), its
    assert isinstance(carry.recycle, tint.RecycleState)
    assert iters[0][0] == iters[6][0]
    assert sum(iters[6][1:]) < sum(iters[0][1:])
    assert iters[6][-1] <= 1
    scale = np.abs(trajs[0] - to_np(tst.pos)).max()
    assert np.abs(trajs[0] - trajs[6]).max() < 2e-3 * scale


def _obstacle_scene(kT):
    """Four free 12-blob shells and two obstacle shells (zero prescribed
    velocity) above the wall."""
    rng = np.random.default_rng(11)
    ref = shell_vertices(12, 0.5)
    free = jsys.BodyType(name="free", ref_config=ref, count=4)
    obst = jsys.BodyType(name="obst", ref_config=ref, count=2,
                         prescribed_kinematics=True, is_obstacle=True)
    js = jsys.System(types=(free, obst), eta=1.0, blob_radius=0.131, kT=kT,
                     g=0.1, domain="single_wall", repulsion_strength_wall=0.2,
                     debye_length_wall=0.2, repulsion_strength=0.2,
                     debye_length=0.2, solver_tolerance=1e-10)
    pos = np.stack([1.6 * np.arange(6), 0.3 * np.arange(6),
                    np.full(6, 0.9)], axis=1)
    pos[:, :2] += rng.uniform(-0.2, 0.2, (6, 2))
    quat = rng.normal(size=(6, 4))
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    ts, tst = tsys.from_reference(js, pos, quat, device="cpu")
    return js, jsys.make_state(pos, quat), ts, tst


def exact_jax_prescribed_pc(monkeypatch):
    """Give the JAX preconditioner the port's exact prescribed block, U =
    F + K^T lambda: the JAX package's drops F (saddle.py:678-682), and
    its warm-started correctors with obstacles then stop unconverged at
    maxiter (saddle.apply_block_diag_pc's docstring in the port). Cold
    solves take the same steps with either."""
    orig = jsad.apply_block_diag_pc

    def exact(system, pc, vec):
        out = orig(system, pc, vec)
        n3, b6 = 3 * system.num_blobs, 6 * system.num_bodies
        mask = np.repeat(system.prescribed_body_mask, 6)
        return out.at[n3:n3 + b6].add(np.where(mask, 1.0, 0.0)
                                       * vec[n3:n3 + b6])

    monkeypatch.setattr(jsad, "apply_block_diag_pc", exact)


def test_jax_warm_started_obstacle_solve_stalls():
    """The defect the port repairs: with obstacles, the JAX Slip-Trapz
    corrector (warm-started from the predictor, whose U holds the
    prescribed velocity) runs to maxiter unconverged; the port's
    converges."""
    from rigidmultiblobswall_tpu.models import solvers as jsol
    from rigidmultiblobswall_tpu_torch.models import solvers as tsol

    js, jst, ts, tst = _obstacle_scene(kT=0.0)
    jcold = jsol.solve_mobility_problem(js, jst)
    tcold = tsol.solve_mobility_problem(ts, tst)
    x0 = np.concatenate([np.ravel(jcold.lam), np.ravel(jcold.velocities)])
    jwarm = jsol.solve_mobility_problem(js, jst, x0=x0, maxiter=120)
    twarm = tsol.solve_mobility_problem(ts, tst, x0=torch.as_tensor(x0),
                                        maxiter=120)
    assert not bool(jwarm.converged) and int(jwarm.iterations) == 120
    assert tcold.converged and twarm.converged and twarm.iterations < 120
    scale = float(tcold.velocities.abs().max())
    np.testing.assert_allclose(to_np(twarm.velocities),
                               to_np(tcold.velocities), rtol=0,
                               atol=1e-8 * scale)


@pytest.mark.parametrize("scheme", ["stochastic_Slip_Mid",
                                    "stochastic_GDC_RFD",
                                    "stochastic_Slip_Trapz"])
def test_obstacle_scheme_matches_jax(monkeypatch, scheme):
    """kT = 0.05, three steps with the JAX normals fed (the JAX
    preconditioner's prescribed block made exact, as the port's): the
    same trajectory and counts, and the obstacles exactly where they
    were."""
    exact_jax_prescribed_pc(monkeypatch)
    js, jst, ts, tst = _obstacle_scene(kT=0.05)
    keys = _keys(3)
    feed_jax_noise(monkeypatch, keys, scheme, js)
    jfinal, tfinal, jcounts, tcounts = _run_both(
        js, jst, ts, tst, scheme, keys, 1e-3, lanczos_tolerance=1e-10)
    assert tcounts == jcounts
    _assert_same(jfinal, tfinal, jst)
    assert torch.equal(tfinal.pos[4:], tst.pos[4:])
    assert torch.equal(tfinal.quat[4:], tst.quat[4:])
    assert float((tfinal.pos[:4] - tst.pos[:4]).abs().max()) > 1e-5


def test_simulate_matches_the_stepper_and_jax():
    """integrators.simulate: the states of every second step of a manual
    make_stepper loop, and at kT = 0 JAX's simulate's final state."""
    js, jst, ts, tst, _, _ = shells_scene(3, seed=1, solver_tolerance=1e-10)
    final, traj, auxs = tint.simulate(
        ts, tst, torch.Generator().manual_seed(0),
        scheme="deterministic_forward_euler", dt=2e-3, n_steps=5,
        save_every=2)
    assert traj.pos.shape == (2, 3, 3) and traj.quat.shape == (2, 3, 4)
    assert len(auxs) == 2
    step = tint.make_stepper(ts, "deterministic_forward_euler", 2e-3)
    carry, s = tint.init_carry(ts, state=tst), tst
    for i in range(4):
        s, carry, _ = step(s, torch.Generator(), carry)
        if i % 2:
            assert torch.equal(traj.pos[i // 2], s.pos)
    assert torch.equal(final.pos, s.pos)
    jfinal, _, _ = jint.simulate(js, jst, jax.random.PRNGKey(0),
                                 scheme="deterministic_forward_euler",
                                 dt=2e-3, n_steps=4, save_every=2)
    _assert_same(jfinal, final, jst)
