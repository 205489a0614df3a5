"""Articulated single-blob bodies (the articulated rollers) in the
PyTorch port against the JAX package, float64 on the CPU: dumbbells of
two single blobs joined by one ball link above the wall, with the
`articulated_dumbbells` example's physics (a = 0.5, link 2.5, g = 1,
wall repulsion 1.0 / 0.2). The constrained solve on the grand mobility
(kernel K1 grand on the card) takes the same GMRES sweeps and agrees to
1e-10, with and without a time-dependent link; both roller schemes run
three steps through make_stepper with equal counts and positions within
1e-9 of the displacement."""

import dataclasses

import jax
import numpy as np
import pytest

from rigidmultiblobswall_tpu.io import input_file as jinput
from rigidmultiblobswall_tpu.models import articulated as jart
from rigidmultiblobswall_tpu.models import integrators as jint
from rigidmultiblobswall_tpu.models import solvers as jsol
from rigidmultiblobswall_tpu.models import system as jsys
from rigidmultiblobswall_tpu_torch.io import input_file as tinput
from rigidmultiblobswall_tpu_torch.models import articulated as tart
from rigidmultiblobswall_tpu_torch.models import integrators as tint
from rigidmultiblobswall_tpu_torch.models import solvers as tsol
from rigidmultiblobswall_tpu_torch.models import system as tsys

from torch_parity import to_np

LINK = 2.5
LINKS = np.array([[LINK / 2, 0, 0, -LINK / 2, 0, 0]])
# the link's length breathing in t: six components and their derivatives
EXTRA = [["1.25 + 0.2*sin(5*t)", "0", "0", "-1.25", "0", "0",
          "cos(5*t)", "0", "0", "0", "0", "0"]]


def dumbbell_scene(count=6, seed=0, moving_link=False):
    """Returns (jax_system, jax_state, port_system, port_state, pos)."""
    rng = np.random.default_rng(seed)
    p0 = np.stack([rng.uniform(-6, 6, count), rng.uniform(-6, 6, count),
                   rng.uniform(1.0, 2.0, count)], axis=1)
    pos = np.concatenate([p0, p0 + [LINK, 0, 0]])
    quat = np.tile([1.0, 0, 0, 0], (2 * count, 1))
    types = tuple(jsys.BodyType(name=f"dumbbell_sub{j}",
                                ref_config=np.zeros((1, 3)), count=count)
                  for j in range(2))
    art = dict(name="dumbbell", count=count, sub_type_indices=(0, 1),
               pairs_local=np.array([[0, 1]]), links=LINKS)
    kw = dict(eta=1.0, blob_radius=0.5, g=1.0, domain="single_wall",
              repulsion_strength_wall=1.0, debye_length_wall=0.2,
              solver_tolerance=1e-10)
    jfn = jinput._compile_links_fn(EXTRA, LINKS) if moving_link else None
    js = jsys.System(types=types, articulated=(
        jart.ArticulatedType(**art, links_fn=jfn),), **kw)
    ts, tst = tsys.from_reference(
        dataclasses.replace(js, articulated=(jart.ArticulatedType(**art),)),
        pos, quat, device="cpu")
    if moving_link:
        ts = dataclasses.replace(ts, articulated=(dataclasses.replace(
            ts.articulated[0],
            links_fn=tinput.compile_links_fn(EXTRA, LINKS)),))
    return js, jsys.make_state(pos, quat), ts, tst, pos


@pytest.mark.parametrize("moving_link, t", [(False, 0.0), (True, 0.1)])
def test_single_blob_solve_matches_jax(moving_link, t):
    js, jst, ts, tst, _ = dumbbell_scene(moving_link=moving_link)
    jsol_ = jsol.solve_mobility_problem_single_blob(js, jst, time=t)
    tsol_ = tsol.solve_mobility_problem_single_blob(ts, tst, time=t)
    assert tsol_.iterations == int(jsol_.iterations)
    assert tsol_.converged
    for got, ref in ((tsol_.velocities, jsol_.velocities),
                     (tsol_.phi, jsol_.phi)):
        ref = np.asarray(ref)
        assert np.abs(to_np(got) - ref).max() <= 1e-10 * np.abs(ref).max()
    # C U = B: the link's prescribed rate of change
    B = to_np(tart.constraint_rhs(ts, tst, t))
    CU = to_np(tart.C_mul(ts, tst, tsol_.velocities, t))
    assert np.abs(CU - B).max() <= 1e-8 * max(np.abs(B).max(), 1.0)
    assert np.abs(B).max() > 0.1 if moving_link else not B.any()


@pytest.mark.parametrize("moving_link", [False, True])
@pytest.mark.parametrize("scheme", [
    "articulated_deterministic_forward_euler_rollers",
    "articulated_deterministic_midpoint_rollers"])
def test_roller_scheme_matches_jax(scheme, moving_link):
    js, jst, ts, tst, pos = dumbbell_scene(moving_link=moving_link)
    dt = 0.01
    jstep = jax.jit(jint.make_stepper(js, scheme, dt))
    jc = jint.init_carry(js, state=jst)
    tstep = tint.make_stepper(ts, scheme, dt)
    tc = tint.init_carry(ts, state=tst)
    s, t = jst, tst
    for i in range(3):
        s, jc, jaux = jstep(s, jax.random.PRNGKey(i), jc)
        t, tc, taux = tstep(t, None, tc)
        assert taux.det_iterations == int(jaux.det_iterations)
        assert taux.rejections == int(jaux.rejections) == 0
    disp = np.abs(np.asarray(s.pos) - pos).max()
    assert disp > 1e-3
    np.testing.assert_allclose(to_np(t.pos), np.asarray(s.pos),
                               atol=1e-9 * disp, rtol=0)
    np.testing.assert_allclose(to_np(t.quat), np.asarray(s.quat),
                               atol=1e-9, rtol=0)
    assert np.abs(to_np(tart.constraint_violation(ts, t, 3 * dt))).max() \
        <= 1e-7
