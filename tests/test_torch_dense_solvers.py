"""The solvers of the PyTorch port on the materialized engine and the
dense-algebra utilities against the JAX package, float64 on the CPU:
solve_mobility_problem with m_dense='auto' (the materialized matrix)
against the matrix-free engine and JAX's solve, and solve_body_mobility,
solve_mobility_problem_dense and solve_resistance against JAX, all to
1e-9 relative."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rigidmultiblobswall_tpu.models import solvers as jsol
from rigidmultiblobswall_tpu_torch.models import solvers as tsol

from torch_parity import rel_err, shells_scene

TOL = 1e-9


@pytest.mark.parametrize("domain", ["single_wall", "no_wall"])
def test_materialized_solve_matches_matrix_free_and_jax(domain):
    js, jst, ts, tst, _, _ = shells_scene(4, seed=20, domain=domain)
    dense = tsol.solve_mobility_problem(ts, tst, m_dense="auto")
    free = tsol.solve_mobility_problem(ts, tst, m_dense=None)
    ref = jsol.solve_mobility_problem(js, jst, m_dense="auto")
    assert dense.converged and dense.iterations == free.iterations
    assert rel_err(dense.velocities, free.velocities) <= TOL
    assert rel_err(dense.velocities, ref.velocities) <= TOL
    assert rel_err(dense.lam, ref.lam) <= TOL


@pytest.mark.parametrize("domain", ["single_wall", "no_wall"])
def test_body_mobility_matches_jax(domain):
    js, jst, ts, tst, _, _ = shells_scene(3, seed=21, domain=domain)
    got = tsol.solve_body_mobility(ts, tst)
    ref = jsol.solve_body_mobility(js, jst)
    assert got.shape == (18, 18)
    assert rel_err(got, ref) <= TOL
    assert rel_err(tsol.dense_blob_mobility(ts, tst),
                   jsol.dense_blob_mobility(js, jst)) <= TOL
    assert rel_err(tsol._dense_K(ts, tst), jsol._dense_K(js, jst)) <= TOL


def test_dense_mobility_solve_matches_jax_and_gmres():
    js, jst, ts, tst, _, _ = shells_scene(3, seed=22)
    v, N = tsol.solve_mobility_problem_dense(ts, tst)
    v_ref, N_ref = jsol.solve_mobility_problem_dense(js, jst)
    assert rel_err(v, v_ref) <= TOL and rel_err(N, N_ref) <= TOL
    # the dense algebra and the preconditioned GMRES solve agree
    assert rel_err(v, tsol.solve_mobility_problem(ts, tst).velocities) <= TOL


def test_resistance_matches_jax():
    js, jst, ts, tst, _, _ = shells_scene(3, seed=23)
    u = np.random.default_rng(24).normal(size=(3, 6))
    got = tsol.solve_resistance(ts, tst, torch.as_tensor(u))
    ref = jsol.solve_resistance(js, jst, jnp.asarray(u))
    assert got.shape == (3, 6) and rel_err(got, ref) <= TOL
    # resistance inverts the body mobility
    N = tsol.solve_body_mobility(ts, tst)
    assert rel_err(N @ got.reshape(-1), u.reshape(-1)) <= TOL
