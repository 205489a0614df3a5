"""Articulated bodies in the PyTorch port against the JAX package, float64
on the CPU: three instances of a three-body chain of 8-blob shells above
the wall whose links hold every kind of row, a self-constraint (body 0's
point pinned, p == q), a ball joint whose length oscillates in t (the
twelve expression columns of a .const line, compiled by each package's
own input reader), and a redundant weld (two ball joints between bodies
1 and 2, which makes C N C^T exactly singular).

The constraint products, the right-hand side, the violation, the dense
C, the centre-of-mass correction, the saddle operator with its
constraint rows and the articulated preconditioner agree to 1e-12; the
solve at a time t takes the same GMRES sweeps and agrees to 1e-10; both
multibody schemes run three steps through make_stepper with equal
counts, on the materialized and the matrix-free engine, and with
update_PC = 2.

The nonlinear projection solves damped normal equations, (J^T J + 1e-12
I) dx = J^T r, whose J has a null space (7 unknowns a body against 3
rows a joint and one a body): a rounding of J^T r there comes back
multiplied by 1e12, so each Gauss-Newton iteration leaves ~eps / 1e-12
= 2.2e-4 of its residual r as noise in the null space, in either
package (one ulp of input moves JAX's own result that much). Its results
and the schemes' positions are held to 1e-12 (1e-9 of the displacement
for the schemes) plus 4 x 2.2e-4 of the residuals the projections
started from; the projection's iteration counts must be equal and both
packages' results must meet the constraints to its tolerance."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rigidmultiblobswall_tpu.io import input_file as jinput
from rigidmultiblobswall_tpu.models import articulated as jart
from rigidmultiblobswall_tpu.models import integrators as jint
from rigidmultiblobswall_tpu.models import saddle as jsad
from rigidmultiblobswall_tpu.models import solvers as jsol
from rigidmultiblobswall_tpu.models import system as jsys
from rigidmultiblobswall_tpu_torch.io import input_file as tinput
from rigidmultiblobswall_tpu_torch.models import articulated as tart
from rigidmultiblobswall_tpu_torch.models import integrators as tint
from rigidmultiblobswall_tpu_torch.models import saddle as tsad
from rigidmultiblobswall_tpu_torch.models import solvers as tsol
from rigidmultiblobswall_tpu_torch.models import system as tsys

from torch_parity import shell_vertices, to_np

# the Gauss-Newton noise a unit of residual leaves: eps64 / the damping
GN_NOISE = np.finfo(np.float64).eps / 1e-12
PAIRS = np.array([[0, 0], [0, 1], [1, 2], [1, 2]])
LINKS = np.array([[0, 0, -0.5, 0, 0, -0.5],
                  [0.6, 0, 0, -0.6, 0, 0],
                  [0.5, 0, 0, -0.5, 0, 0],
                  [0.5, 0.3, 0, -0.5, 0.3, 0]])
EXTRA = [[], ["0.6 + 0.1*sin(3*t)", "0", "0", "-0.6", "0", "0",
              "0.3*cos(3*t)", "0", "0", "0", "0", "0"], [], []]
TIMES = (0.0, 0.37)


def chain_scene(count=3, seed=0, **overrides):
    """Returns (jax_system, jax_state, port_system, port_state, pos,
    quat): `count` chains of three 8-blob shells at x0, x0 + 1.2 e_x and
    x0 + 2.2 e_x, consistent with the links at t = 0."""
    rng = np.random.default_rng(seed)
    x0 = np.stack([rng.uniform(-3, 3, count), rng.uniform(-3, 3, count),
                   rng.uniform(1.8, 2.2, count)], axis=1)
    pos = np.concatenate([x0, x0 + [1.2, 0, 0], x0 + [2.2, 0, 0]])
    quat = np.tile([1.0, 0, 0, 0], (3 * count, 1))
    kw = dict(eta=1.0, blob_radius=0.12, g=1.0, domain="single_wall",
              repulsion_strength_wall=1.0, debye_length_wall=0.5,
              solver_tolerance=1e-10)
    kw.update(overrides)
    types = tuple(jsys.BodyType(name=f"chain_sub{j}",
                                ref_config=shell_vertices(8, 0.4),
                                count=count) for j in range(3))
    art = dict(name="chain", count=count, sub_type_indices=(0, 1, 2),
               pairs_local=PAIRS, links=LINKS)
    js = jsys.System(types=types, articulated=(jart.ArticulatedType(
        **art, links_fn=jinput._compile_links_fn(EXTRA, LINKS)),), **kw)
    # from_reference refuses a JAX links_fn: carry the constant links and
    # give the port its own hook from the same expressions
    ts, tst = tsys.from_reference(
        dataclasses.replace(js, articulated=(jart.ArticulatedType(**art),)),
        pos, quat, device="cpu")
    ts = dataclasses.replace(ts, articulated=(dataclasses.replace(
        ts.articulated[0],
        links_fn=tinput.compile_links_fn(EXTRA, LINKS)),))
    return js, jsys.make_state(pos, quat), ts, tst, pos, quat


def _perturbed(pos, quat, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    q = quat + scale * rng.normal(size=quat.shape)
    return (pos + scale * rng.normal(size=pos.shape),
            q / np.linalg.norm(q, axis=1, keepdims=True))


def _close(got, ref, tol=1e-12):
    got, ref = to_np(got), np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(np.abs(ref).max(), 1.0)
    assert np.abs(got - ref).max() <= tol * scale


@pytest.mark.parametrize("t", TIMES)
def test_constraint_functions_match_jax(t):
    js, jst, ts, tst, pos, quat = chain_scene()
    # a rotated configuration, so the lab-frame links are not the body's
    pp, qq = _perturbed(pos, quat, 1)
    jst, tst = jsys.make_state(pp, qq), tsys.make_state(pp, qq, device="cpu")
    rng = np.random.default_rng(2)
    U = rng.normal(size=(2, ts.num_bodies, 6))
    phi = rng.normal(size=(2, tart.num_constraints(ts), 3))
    _close(tart.C_mul(ts, tst, torch.tensor(U[0]), t),
           jart.C_mul(js, jst, jnp.asarray(U[0]), t))
    _close(tart.CT_mul(ts, tst, torch.tensor(phi[0]), t),
           jart.CT_mul(js, jst, jnp.asarray(phi[0]), t))
    # stacked right-hand sides (the lockstep operator's)
    _close(tart.C_mul(ts, tst, torch.tensor(U), t),
           np.stack([jart.C_mul(js, jst, jnp.asarray(u), t) for u in U]))
    _close(tart.CT_mul(ts, tst, torch.tensor(phi), t),
           np.stack([jart.CT_mul(js, jst, jnp.asarray(p), t) for p in phi]))
    _close(tart.constraint_rhs(ts, tst, t), jart.constraint_rhs(js, jst, t))
    _close(tart.constraint_violation(ts, tst, t),
           jart.constraint_violation(js, jst, t))
    _close(tart.dense_C_per_instance(ts, ts.articulated[0], tst, t),
           jart.dense_C_per_instance(js, js.articulated[0], jst, t))
    # the links move with t, and B is the links' derivative
    assert np.abs(np.asarray(jart.constraint_rhs(js, jst, t))).max() > 0.1


def test_center_of_mass_correction_matches_jax():
    js, jst, ts, tst, pos, quat = chain_scene()
    pp, qq = _perturbed(pos, quat, 3)
    vel = np.random.default_rng(4).normal(size=(ts.num_bodies, 6))
    for frac in (1.0, 0.5):
        jc = jart.correct_center_of_mass(
            js, jsys.make_state(pp, qq), jst, jnp.asarray(vel), 0.01,
            time=0.2, midpoint_fraction=frac)
        tc = tart.correct_center_of_mass(
            ts, tsys.make_state(pp, qq, device="cpu"), tst,
            torch.tensor(vel), 0.01, time=0.2, midpoint_fraction=frac)
        _close(tc.pos, jc.pos)
        _close(tc.quat, jc.quat)


@pytest.mark.parametrize("scale", [0.05, 1e-4])
def test_nonlinear_projection_matches_jax(scale):
    js, jst, ts, tst, pos, quat = chain_scene()
    pp, qq = _perturbed(pos, quat, 5, scale)
    t = 0.2
    r0 = np.abs(np.asarray(jart.constraint_violation(
        js, jsys.make_state(pp, qq), t))).max()
    jp = jart.nonlinear_projection(js, jsys.make_state(pp, qq), t)
    tart.GN_ITERATIONS.clear()
    tp = tart.nonlinear_projection(ts, tsys.make_state(pp, qq, device="cpu"),
                                   t)
    assert tart.GN_ITERATIONS[0] >= 1
    _assert_jax_needs(js, pp, qq, t, tart.GN_ITERATIONS[0])
    bound = 1e-12 + 4 * GN_NOISE * r0
    np.testing.assert_allclose(to_np(tp.pos), np.asarray(jp.pos),
                               atol=bound, rtol=0)
    np.testing.assert_allclose(to_np(tp.quat), np.asarray(jp.quat),
                               atol=bound, rtol=0)
    # the loop tests the constraint rows before theta is normalized, which
    # rescales the rotated links by |theta|^2 = 1 + O(tol)
    for state, g in ((tp, tart.constraint_violation(ts, tp, t)),
                     (jp, jart.constraint_violation(js, jp, t))):
        assert np.abs(to_np(g)).max() <= 1e-7
        assert np.allclose(np.linalg.norm(to_np(state.quat), axis=1), 1.0,
                           atol=1e-14)


def test_projection_iterations_match_jax():
    """The per-instance masking: instances that start consistent take no
    iteration while the perturbed one takes several, in both packages
    (JAX's count from its own loop on the same residual)."""
    js, jst, ts, tst, pos, quat = chain_scene()
    pp, qq = pos.copy(), quat.copy()
    bodies = [0, 3, 6]                    # instance 0's three sub-bodies
    pp[bodies], qq[bodies] = _perturbed(pos[bodies], quat[bodies], 6)
    tart.GN_ITERATIONS.clear()
    tp = tart.nonlinear_projection(ts, tsys.make_state(pp, qq, device="cpu"),
                                   0.0)
    jp = jart.nonlinear_projection(js, jsys.make_state(pp, qq), 0.0)
    # the unperturbed instances are left exactly where they were
    others = [b for b in range(9) if b not in bodies]
    assert np.array_equal(to_np(tp.pos)[others], pp[others])
    assert np.array_equal(np.asarray(jp.pos)[others], pp[others])
    _assert_jax_needs(js, pp, qq, 0.0, tart.GN_ITERATIONS[0])


def _assert_jax_needs(js, pos, quat, t, k):
    """JAX's projection takes k iterations too: capped at k iterations it
    returns its uncapped result bit for bit, capped at k - 1 it does
    not."""
    def run(cap):
        return np.asarray(jart.nonlinear_projection(
            js, jsys.make_state(pos, quat), t, max_iter=cap).pos)

    full = run(20)
    assert np.array_equal(run(k), full)
    assert not np.array_equal(run(k - 1), full)


@pytest.mark.parametrize("t", TIMES)
def test_operator_and_preconditioner_match_jax(t):
    js, jst, ts, tst, pos, quat = chain_scene()
    pp, qq = _perturbed(pos, quat, 7, 0.02)
    jst, tst = jsys.make_state(pp, qq), tsys.make_state(pp, qq, device="cpu")
    n = tsad.saddle_size(ts)
    assert n == jsad.saddle_size(js) == 3 * 72 + 6 * 9 + 3 * 12
    vec = np.random.default_rng(8).normal(size=(2, n))
    jop = jsad.make_linear_operator(js, jst, time=t, m_dense=None)
    top = tsad.make_linear_operator(ts, tst, time=t, m_dense=None)
    ref = np.stack([np.asarray(jop(jnp.asarray(v))) for v in vec])
    _close(top(torch.tensor(vec[0])), ref[0])
    lock = tsad.make_lockstep_operator(ts, tst, time=t, m_dense=None)
    _close(lock(torch.tensor(vec)), ref)
    jpc = jsad.build_block_diag_pc(js, jst, time=t)
    tpc = tsad.build_block_diag_pc(ts, tst, time=t)
    _close(tpc.per_articulated[0].C, jpc.per_articulated[0].C)
    _close(tpc.per_articulated[0].G, jpc.per_articulated[0].G, 1e-10)
    ref_pc = np.stack([np.asarray(jsad.apply_block_diag_pc(
        js, jpc, jnp.asarray(v))) for v in vec])
    _close(tsad.apply_block_diag_pc(ts, tpc, torch.tensor(vec[0])),
           ref_pc[0], 1e-10)
    _close(tsad.apply_block_diag_pc(ts, tpc, torch.tensor(vec)), ref_pc,
           1e-10)


def test_preconditioner_of_a_redundant_weld_matches_jax():
    """At the start configuration the weld's two joints are consistent,
    so C N C^T is singular (rank 11 of 12): G is its pseudo-inverse at
    jnp.linalg.pinv's cutoff, not an inverse full of rounding."""
    js, jst, ts, tst, _, _ = chain_scene()
    jG = np.asarray(jsad.build_block_diag_pc(js, jst).per_articulated[0].G)
    tG = to_np(tsad.build_block_diag_pc(ts, tst).per_articulated[0].G)
    assert [np.linalg.matrix_rank(g) for g in tG] == [11] * 3
    _close(tG, jG, 1e-10)


@pytest.mark.parametrize("engine", ["materialized", "matrix_free"])
def test_solve_matches_jax(engine):
    js, jst, ts, tst, _, _ = chain_scene()
    kw = dict(m_dense=None) if engine == "matrix_free" else {}
    jsol_ = jsol.solve_mobility_problem(js, jst, time=0.3, **kw)
    tsol_ = tsol.solve_mobility_problem(ts, tst, time=0.3, **kw)
    assert tsol_.iterations == int(jsol_.iterations)
    assert tsol_.converged
    for got, ref in ((tsol_.velocities, jsol_.velocities),
                     (tsol_.phi, jsol_.phi), (tsol_.lam, jsol_.lam)):
        err = np.abs(to_np(got) - np.asarray(ref)).max()
        assert err <= 1e-10 * np.abs(np.asarray(ref)).max()
    # the constrained velocities move the joints as the links prescribe
    _close(tart.C_mul(ts, tst, tsol_.velocities, 0.3),
           tart.constraint_rhs(ts, tst, 0.3), 1e-8)


def _projection_inputs(monkeypatch):
    """Record the largest constraint residual every port projection starts
    from."""
    seen = []
    project = tart.nonlinear_projection

    def recorded(system, state, time=0.0, **kw):
        seen.append(float(tart.constraint_violation(system, state, time)
                          .abs().max()))
        return project(system, state, time, **kw)

    monkeypatch.setattr(tart, "nonlinear_projection", recorded)
    return seen


FE = "articulated_deterministic_forward_euler"
MIDPOINT = "articulated_deterministic_midpoint"


@pytest.mark.parametrize("scheme, engine, update_pc", [
    (FE, "materialized", 1), (FE, "matrix_free", 1), (FE, "materialized", 2),
    (MIDPOINT, "materialized", 1), (MIDPOINT, "matrix_free", 1)])
def test_scheme_matches_jax(monkeypatch, scheme, engine, update_pc):
    if engine == "matrix_free":
        monkeypatch.setattr(jsad, "MATERIALIZE_BUDGET_BYTES", 0)
        monkeypatch.setattr(tsad, "MATERIALIZE_BUDGET_BYTES", 0)
    seen = _projection_inputs(monkeypatch)
    js, jst, ts, tst, pos, _ = chain_scene()
    dt = 1e-3
    jstep = jax.jit(jint.make_stepper(js, scheme, dt, update_PC=update_pc))
    tstep = tint.make_stepper(ts, scheme, dt, update_PC=update_pc)
    if update_pc > 1:
        jc = jint.init_carry_with_pc(js, jst)
        tc = tint.init_carry_with_pc(ts, tst)
    else:
        jc, tc = jint.init_carry(js, state=jst), tint.init_carry(ts, state=tst)
    s, t = jst, tst
    for i in range(3):
        s, jc, jaux = jstep(s, jax.random.PRNGKey(i), jc)
        t, tc, taux = tstep(t, None, tc)
        assert taux.det_iterations == int(jaux.det_iterations)
        assert taux.rejections == int(jaux.rejections) == 0
        assert taux.solves_converged
    inner = tc[0] if update_pc > 1 else tc
    assert inner.step_idx == 3
    disp = np.abs(np.asarray(s.pos) - pos).max()
    assert disp > 1e-3
    bound = 1e-9 * disp + 4 * GN_NOISE * sum(seen)
    np.testing.assert_allclose(to_np(t.pos), np.asarray(s.pos), atol=bound,
                               rtol=0)
    np.testing.assert_allclose(to_np(t.quat), np.asarray(s.quat),
                               atol=1e-9 + 4 * GN_NOISE * sum(seen), rtol=0)
    assert np.abs(to_np(tart.constraint_violation(ts, t, 3 * dt))).max() \
        <= 1e-7
