"""Krylov solvers, preconditioner and mobility solve of the PyTorch port
against the JAX package, float64 on the CPU: both sides solve to 1e-12
and agree to 1e-9."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rigidmultiblobswall_tpu.models import saddle as jsaddle
from rigidmultiblobswall_tpu.models import solvers as jsolvers
from rigidmultiblobswall_tpu.ops import gmres as jgmres
from rigidmultiblobswall_tpu.ops import lanczos as jlanczos
from rigidmultiblobswall_tpu_torch.models import saddle as tsaddle
from rigidmultiblobswall_tpu_torch.models import solvers as tsolvers
from rigidmultiblobswall_tpu_torch.ops import gmres as tgmres
from rigidmultiblobswall_tpu_torch.ops import lanczos as tlanczos

from torch_parity import rel_err, shells_scene, to_np

TOL = 1e-9


def _spd(n=40, seed=0):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    A = Q @ np.diag(np.linspace(0.5, 20.0, n)) @ Q.T
    return A, rng.normal(size=n), rng.normal(size=(2, n))


@pytest.mark.parametrize("restart", [60, 7])
def test_gmres_matches_jax(restart):
    A, b, _ = _spd()
    d = np.diag(A).copy()
    jres = jgmres.gmres(lambda x: jnp.asarray(A) @ x, jnp.asarray(b),
                        tol=1e-12, restart=restart,
                        M=lambda v: v / jnp.asarray(d))
    At, dt = torch.as_tensor(A), torch.as_tensor(d)
    tres = tgmres.gmres(lambda x: At @ x, torch.as_tensor(b), tol=1e-12,
                        restart=restart, M=lambda v: v / dt)
    assert tres.converged and bool(jres.converged)
    assert rel_err(tres.x, jres.x) < TOL
    assert rel_err(tres.x, np.linalg.solve(A, b)) < TOL
    assert abs(tres.iterations - int(jres.iterations)) <= 1


def test_gmres_warm_start_and_lockstep_match_jax():
    A, _, B = _spd(seed=1)
    At = torch.as_tensor(A)
    jres = jgmres.gmres_lockstep(lambda X: X @ jnp.asarray(A).T,
                                 jnp.asarray(B), tol=1e-12, restart=60)
    tres = tgmres.gmres_lockstep(lambda X: X @ At.T, torch.as_tensor(B),
                                 tol=1e-12, restart=60)
    assert np.all(tres.converged)
    assert rel_err(tres.x, jres.x) < TOL
    x0 = torch.as_tensor(np.linalg.solve(A, B[0]) * (1 + 1e-3))
    warm = tgmres.gmres(lambda x: At @ x, torch.as_tensor(B[0]), x0=x0,
                        tol=1e-12)
    assert rel_err(warm.x, jres.x[0]) < TOL


@pytest.mark.parametrize("check_every", [1, 4])
def test_lanczos_matches_jax_same_z(check_every):
    A, z, _ = _spd(n=30, seed=2)
    L = np.tril(np.random.default_rng(3).normal(size=(30, 30))) * 0.1 \
        + np.eye(30)
    jres = jlanczos.stochastic_forcing_lanczos(
        lambda v: jnp.asarray(A) @ v, jnp.asarray(z), factor=0.7,
        tolerance=1e-12, max_iter=30, check_every=check_every,
        L_mult=lambda v: jnp.asarray(L) @ v)
    At, Lt = torch.as_tensor(A), torch.as_tensor(L)
    tres = tlanczos.stochastic_forcing_lanczos(
        lambda v: At @ v, torch.as_tensor(z), factor=0.7, tolerance=1e-12,
        max_iter=30, check_every=check_every, L_mult=lambda v: Lt @ v)
    assert tres.iterations == int(jres.iterations)
    assert rel_err(tres.noise, jres.noise) < TOL
    w, Q = np.linalg.eigh(A)
    exact = 0.7 * L @ (Q @ (np.sqrt(w) * (Q.T @ z)))
    assert rel_err(tres.noise, exact) < 1e-6


def test_block_diag_pc_matches_jax():
    js, jst, ts, tst, _, _ = shells_scene(3, seed=1)
    jpc = jsaddle.build_block_diag_pc(js, jst)
    tpc = tsaddle.build_block_diag_pc(ts, tst)
    for field in ("chol", "m_inv", "K", "N_body"):
        assert rel_err(getattr(tpc.per_type[0], field),
                       getattr(jpc.per_type[0], field)) < TOL
    vec = np.random.default_rng(4).normal(size=tsaddle.saddle_size(ts))
    ref = jsaddle.apply_block_diag_pc(js, jpc, jnp.asarray(vec))
    got = tsaddle.apply_block_diag_pc(ts, tpc, torch.as_tensor(vec))
    assert rel_err(got, ref) < TOL
    # stacked right-hand sides (lockstep) apply column by column
    stacked = tsaddle.apply_block_diag_pc(
        ts, tpc, torch.as_tensor(np.stack([vec, 2 * vec])))
    assert rel_err(stacked[1], 2 * to_np(ref)) < TOL


def test_saddle_operator_matches_jax():
    js, jst, ts, tst, _, _ = shells_scene(3, seed=2)
    vec = np.random.default_rng(5).normal(size=tsaddle.saddle_size(ts))
    jop = jsaddle.make_linear_operator(js, jst, m_dense=None)
    top = tsaddle.make_linear_operator(ts, tst)
    assert rel_err(top(torch.as_tensor(vec)), jop(jnp.asarray(vec))) < 1e-12
    lock = tsaddle.make_lockstep_operator(ts, tst)
    out = lock(torch.as_tensor(np.stack([vec, -vec])))
    assert rel_err(out[1], -np.asarray(jop(jnp.asarray(vec)))) < 1e-12


def test_solve_mobility_problem_matches_jax():
    js, jst, ts, tst, _, _ = shells_scene(3, seed=0)
    jsol = jsolvers.solve_mobility_problem(js, jst, tol=1e-12)
    tsol = tsolvers.solve_mobility_problem(ts, tst, tol=1e-12)
    assert tsol.converged
    assert rel_err(tsol.velocities, jsol.velocities) < TOL
    assert rel_err(tsol.lam, jsol.lam) < TOL


def test_lockstep_solve_matches_single_solves():
    js, jst, ts, tst, _, _ = shells_scene(3, seed=3)
    rng = np.random.default_rng(6)
    n = tsaddle.saddle_size(ts)
    rhs = rng.normal(size=(2, n))
    jsol = jsolvers.solve_mobility_problem_lockstep(
        js, jst, rhs=jnp.asarray(rhs), tol=1e-12)
    tsol = tsolvers.solve_mobility_problem_lockstep(
        ts, tst, rhs=torch.as_tensor(rhs), tol=1e-12)
    assert tsol.converged
    assert rel_err(tsol.velocities, jsol.velocities) < TOL
    single = tsolvers.solve_mobility_problem(ts, tst,
                                             rhs=torch.as_tensor(rhs[1]),
                                             tol=1e-12)
    assert rel_err(single.velocities, tsol.velocities[1]) < TOL


def test_force_torque_and_rhs_match_jax():
    js, jst, ts, tst, _, _ = shells_scene(4, seed=5)
    from rigidmultiblobswall_tpu.models import kinematics as jkin
    from rigidmultiblobswall_tpu_torch.models import kinematics as tkin

    rng = np.random.default_rng(7)
    noise = rng.normal(size=3 * ts.num_blobs)
    noise_ft = rng.normal(size=(ts.num_bodies, 6))
    jr = jsolvers.build_rhs(js, jst, jkin.blob_positions(js, jst),
                            noise_slip=jnp.asarray(noise),
                            noise_ft=jnp.asarray(noise_ft))
    tr = tsolvers.build_rhs(ts, tst, tkin.blob_positions(ts, tst),
                            noise_slip=torch.as_tensor(noise),
                            noise_ft=torch.as_tensor(noise_ft))
    assert rel_err(tr, jr) < 1e-12
