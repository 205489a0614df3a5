"""Krylov recycling of the PyTorch port (ops/gmres.py: RecycleState,
refresh_recycle, gmres_deflated, harvest_recycle and gmres_lockstep's
recycle warm start) against the JAX package, float64 on the CPU, on one
fixed right-preconditioned operator: a dense, nonsymmetric, well
conditioned 60 x 60 matrix with a diagonal preconditioner, restarted
every 10 iterations so that solves run several cycles. Solutions and
residuals agree to 1e-9 relative, iteration counts are equal. The
recycle directions come from SVDs, whose singular vectors are fixed only
up to sign: rows are compared after aligning each pair's sign (a refresh
flips a row of U and of C together, a harvest a row of U). The harvest
is held to JAX's on the same inputs, to 1e-6: its matrix G carries the
JAX design's padding BIG = 1e8, so any SVD gives G's smallest singular
directions only to ~1e-16 x 1e8 (measured 3e-8 between the two
packages); and two solves' last Krylov bases agree only to ~1e-6, since
the last cycle starts from a residual computed with cancellation."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rigidmultiblobswall_tpu.ops import gmres as jg
from rigidmultiblobswall_tpu_torch.models import solvers as tsol
from rigidmultiblobswall_tpu_torch.ops import gmres as tg

from torch_parity import shells_scene, to_np

N, K, RESTART = 60, 4, 10


def _problem(seed=0):
    rng = np.random.default_rng(seed)
    A = 2.0 * np.eye(N) + rng.normal(size=(N, N)) / np.sqrt(N)
    # a few slow modes for the recycling to find
    A[:3, :3] = np.diag([0.2, 0.3, 0.4])
    d = 1.0 / np.abs(np.diag(A))
    b = rng.normal(size=N)
    return A, d, b


def _ops(A, d):
    jA, jd = jnp.asarray(A), jnp.asarray(d)
    tA, td = torch.as_tensor(A), torch.as_tensor(d)
    return ((lambda v: jA @ v), (lambda v: jd * v),
            (lambda v: tA @ v), (lambda v: td * v))


def _to_port(rec):
    return tg.RecycleState(U=torch.tensor(np.asarray(rec.U)),
                           C=torch.tensor(np.asarray(rec.C)),
                           valid=bool(rec.valid))


def _rel(got, ref):
    got, ref = to_np(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


def _aligned(got, ref, by):
    """got's rows times the sign that aligns got[by]'s rows with ref[by]'s."""
    s = np.sign(np.sum(to_np(getattr(got, by)) * np.asarray(getattr(ref,
                                                                    by)),
                       axis=1))
    s[s == 0] = 1.0
    return to_np(got.U) * s[:, None], to_np(got.C) * (
        s[:, None] if by == "C" else 1.0)


def _jax_states(A, d, b):
    """A valid recycle state, harvested from one deflated solve from the
    empty state and refreshed, as the JAX package makes them."""
    jmv, jM, _, _ = _ops(A, d)
    rec0 = jg.RecycleState.empty(K, N, jnp.float64)
    _, rec1 = jg.gmres_deflated(jmv, jnp.asarray(b), rec0, tol=1e-10,
                                restart=RESTART, maxiter=200, M=jM,
                                collect_basis=True)
    rec2 = jg.refresh_recycle(lambda Y: jnp.stack([jmv(jM(y)) for y in Y]),
                              rec1)
    return rec0, rec1, rec2


def test_refresh_matches_jax():
    A, d, b = _problem()
    _, _, tmv, tM = _ops(A, d)
    rec0, rec1, rec2 = _jax_states(A, d, b)
    assert bool(rec1.valid) and bool(rec2.valid)
    t2 = tg.refresh_recycle(lambda Y: torch.stack([tmv(tM(y)) for y in Y]),
                            _to_port(rec1))
    assert t2.valid
    U2, C2 = _aligned(t2, rec2, "C")
    assert _rel(C2, rec2.C) < 1e-9 and _rel(U2, rec2.U) < 1e-9
    # an invalid state comes back as it is, without a sweep
    assert not tg.refresh_recycle(None, _to_port(rec0)).valid


@pytest.mark.parametrize("valid, j_used", [(True, 6), (False, 10),
                                           (True, 0)])
def test_harvest_matches_jax(valid, j_used):
    """harvest_recycle on the same inputs (an orthonormal basis, a raw
    Hessenberg, projections Bp): a valid state with an unfinished cycle,
    an invalid one with a full cycle, and no cycle at all."""
    rng = np.random.default_rng(8)
    m = RESTART
    V = np.linalg.qr(rng.normal(size=(N, m + 1)))[0].T
    H = np.triu(rng.normal(size=(m + 1, m)), -1) + 3 * np.eye(m + 1, m)
    H[np.arange(1, m + 1), np.arange(m)] = np.abs(
        H[np.arange(1, m + 1), np.arange(m)]) + 0.1
    Bp = rng.normal(size=(m, K))
    rec = jg.RecycleState(U=jnp.asarray(rng.normal(size=(K, N))),
                          C=jnp.asarray(rng.normal(size=(K, N))),
                          valid=jnp.asarray(valid))
    jrec = jg.harvest_recycle(rec, jnp.asarray(V), jnp.asarray(H),
                              jnp.asarray(Bp), j_used, K)
    trec = tg.harvest_recycle(_to_port(rec),
                              torch.as_tensor(V) if j_used else None, H, Bp,
                              j_used, K)
    assert trec.valid and bool(jrec.valid)
    U, C = _aligned(trec, jrec, "U")
    assert _rel(U, jrec.U) < 1e-6
    assert np.array_equal(C, np.asarray(rec.C))


@pytest.mark.parametrize("warm", [False, True])
def test_gmres_deflated_matches_jax(warm):
    """A second right-hand side deflated through the refreshed state (and
    harvested anew), cold and from a warm start."""
    A, d, b = _problem()
    jmv, jM, tmv, tM = _ops(A, d)
    _, _, rec2 = _jax_states(A, d, b)
    b2 = np.random.default_rng(5).normal(size=N)
    x0 = 0.1 * np.ones(N) if warm else None
    jres, jrec = jg.gmres_deflated(
        jmv, jnp.asarray(b2), rec2, tol=1e-10, restart=RESTART, maxiter=200,
        M=jM, collect_basis=True, x0=None if x0 is None else jnp.asarray(x0))
    tres, trec = tg.gmres_deflated(
        tmv, torch.as_tensor(b2), _to_port(rec2), tol=1e-10,
        restart=RESTART, maxiter=200, M=tM, collect_basis=True,
        x0=None if x0 is None else torch.as_tensor(x0))
    assert tres.iterations == int(jres.iterations)
    assert tres.converged and bool(jres.converged)
    assert _rel(tres.x, jres.x) < 1e-9
    assert abs(tres.residual_norm - float(jres.residual_norm)) < 1e-9 * float(
        jnp.linalg.norm(jnp.asarray(b2)))
    # the harvest keeps C until the next refresh
    assert trec.valid and torch.equal(trec.C, _to_port(rec2).C)
    # the deflation pays: fewer iterations than the undeflated solve
    plain = tg.gmres(tmv, torch.as_tensor(b2), tol=1e-10, restart=RESTART,
                     maxiter=200, M=tM)
    assert tres.iterations < plain.iterations


def test_lockstep_recycle_warm_start_matches_jax():
    """gmres_lockstep with a recycle warm start and its basis collected,
    and the harvest from column 0's last cycle."""
    A, d, b = _problem()
    jmv, jM, tmv, tM = _ops(A, d)
    _, _, rec2 = _jax_states(A, d, b)
    B = np.random.default_rng(6).normal(size=(2, N))
    jres, (jV, jH, jj) = jg.gmres_lockstep(
        lambda Y: Y @ jnp.asarray(A).T, jnp.asarray(B), tol=1e-10,
        restart=RESTART, maxiter=200, M=lambda Y: Y * jnp.asarray(d),
        recycle=rec2, collect_basis=True)
    tres, (tV, tH, tj) = tg.gmres_lockstep(
        lambda Y: Y @ torch.as_tensor(A).T, torch.as_tensor(B), tol=1e-10,
        restart=RESTART, maxiter=200, M=lambda Y: Y * torch.as_tensor(d),
        recycle=_to_port(rec2), collect_basis=True)
    assert tres.iterations == int(jres.iterations) and tj == int(jj)
    assert np.all(tres.converged) and bool(jnp.all(jres.converged))
    assert _rel(tres.x, jres.x) < 1e-9
    np.testing.assert_allclose(tres.residual_norm,
                               np.asarray(jres.residual_norm), rtol=0,
                               atol=1e-12 * np.abs(B).max())
    assert tV.shape == jV.shape and tH.shape == jH.shape


def test_refresh_recycle_on_the_saddle_operator():
    """solvers.refresh_recycle: one lockstep sweep of the k columns at a
    configuration, with A~ U' = C and C orthonormal afterwards."""
    _, _, ts, tst, _, _ = shells_scene(3, seed=2)
    from rigidmultiblobswall_tpu_torch.models import saddle as tsad

    n = tsad.saddle_size(ts)
    g = torch.Generator().manual_seed(1)
    rec = tg.RecycleState(U=torch.randn((6, n), generator=g,
                                        dtype=torch.float64),
                          C=torch.zeros((6, n), dtype=torch.float64),
                          valid=True)
    out = tsol.refresh_recycle(ts, tst, rec)
    pc = tsad.build_block_diag_pc(ts, tst)
    op = tsad.make_linear_operator(ts, tst)
    AU = torch.stack([op(tsad.apply_block_diag_pc(ts, pc, u))
                      for u in out.U])
    assert out.valid
    assert _rel(AU, out.C) < 1e-10
    assert _rel(out.C @ out.C.T, torch.eye(6, dtype=torch.float64)) < 1e-12
