"""Bodies with prescribed kinematics (obstacles) in the PyTorch port
against the JAX package, float64 on the CPU, on tests/test_saddle.py's
scene (a free 12-blob shell beside an obstacle shell), here with a
nonzero prescribed velocity: the saddle operator's prescribed rows, the
block-diagonal preconditioner, the M = I per-body solver of GDC-RFD and
a mobility solve (the obstacle's velocity exactly the prescribed one),
to 1e-12 x max|ref|; build_system on an input file with an `obstacle`
line; and the scheme/obstacle check, which refuses exactly the JAX
package's eight schemes with its message.

The port's preconditioner solves a prescribed body's block exactly, U = F
+ K^T lambda, where the JAX package's leaves F out (see the port's
saddle.apply_block_diag_pc): on a vector whose prescribed body rows are
zero, as every cold solve's Krylov vectors are, the two agree; on any
vector they differ by exactly those rows."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rigidmultiblobswall_tpu.io import input_file as jinput
from rigidmultiblobswall_tpu.models import integrators as jint
from rigidmultiblobswall_tpu.models import saddle as jsad
from rigidmultiblobswall_tpu.models import solvers as jsol
from rigidmultiblobswall_tpu.models import system as jsys
from rigidmultiblobswall_tpu_torch.io import input_file as tinput
from rigidmultiblobswall_tpu_torch.models import kinematics as tkin
from rigidmultiblobswall_tpu_torch.models import saddle as tsad
from rigidmultiblobswall_tpu_torch.models import solvers as tsol
from rigidmultiblobswall_tpu_torch.models import system as tsys

from torch_parity import shell_vertices, to_np

TOL = 1e-12
V_OBST = [0.1, -0.2, 0.05, 0.3, 0.0, -0.1]


def _scene():
    ref = shell_vertices(12, 0.5)
    free = jsys.BodyType(name="free", ref_config=ref, count=1)
    obst = jsys.BodyType(name="wallpart", ref_config=ref, count=1,
                         prescribed_kinematics=True,
                         prescribed_velocity=[V_OBST], is_obstacle=True)
    js = jsys.System(types=(free, obst), eta=1.0, blob_radius=0.15,
                     domain="single_wall", g=1.0, solver_tolerance=1e-12)
    pos = np.array([[0.0, 0.0, 1.5], [1.8, 0.0, 1.5]])
    quat = np.array([[1.0, 0, 0, 0], [0.8, 0.6, 0, 0]])
    ts, tst = tsys.from_reference(js, pos, quat, device="cpu")
    return js, jsys.make_state(pos, quat), ts, tst


def _rel(got, ref):
    got, ref = to_np(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def test_system_carries_the_prescribed_fields():
    js, _, ts, _ = _scene()
    assert [t.prescribed_kinematics for t in ts.types] == [False, True]
    assert [t.is_obstacle for t in ts.types] == [False, True]
    np.testing.assert_array_equal(ts.prescribed_body_mask,
                                  js.prescribed_body_mask)
    np.testing.assert_array_equal(ts.prescribed_velocities,
                                  js.prescribed_velocities)
    np.testing.assert_array_equal(tsad.blob_prescribed_mask(ts),
                                  np.asarray(jsad.blob_prescribed_mask(js)))


def test_operator_and_preconditioner_match_jax():
    js, jst, ts, tst = _scene()
    n = tsad.saddle_size(ts)
    v = np.random.default_rng(4).normal(size=n)
    jop = jsad.make_linear_operator(js, jst)
    assert _rel(tsad.make_linear_operator(ts, tst)(torch.as_tensor(v)),
                jop(jnp.asarray(v))) < TOL
    # the lockstep operator applies the same rows to each column
    V = np.stack([v, 2.0 * v[::-1]])
    got = tsad.make_lockstep_operator(ts, tst)(torch.as_tensor(V))
    assert _rel(got[1], jop(jnp.asarray(V[1]))) < TOL
    jpc = jsad.build_block_diag_pc(js, jst)
    tpc = tsad.build_block_diag_pc(ts, tst)
    obst = slice(3 * ts.num_blobs + 6, n)        # the obstacle's U rows
    ref = np.asarray(jsad.apply_block_diag_pc(js, jpc, jnp.asarray(v)))
    got = to_np(tsad.apply_block_diag_pc(ts, tpc, torch.as_tensor(v)))
    # the port's exact prescribed block adds F on the obstacle's U rows
    ref_exact = ref.copy()
    ref_exact[obst] += v[obst]
    assert _rel(got, ref_exact) < TOL
    # with those rows zero (every cold solve's Krylov vectors) they agree
    v0 = v.copy()
    v0[obst] = 0.0
    assert _rel(tsad.apply_block_diag_pc(ts, tpc, torch.as_tensor(v0)),
                jsad.apply_block_diag_pc(js, jpc, jnp.asarray(v0))) < TOL


def test_identity_saddle_solver_matches_jax():
    js, jst, ts, tst = _scene()
    v = np.random.default_rng(5).normal(size=tsad.saddle_size(ts))
    got = tsad.apply_identity_saddle_solver(ts, tst, torch.as_tensor(v))
    ref = jsad.apply_identity_saddle_solver(js, jst, jnp.asarray(v))
    assert _rel(got, ref) < TOL


def test_solve_with_an_obstacle_matches_jax():
    js, jst, ts, tst = _scene()
    jsolution = jsol.solve_mobility_problem(js, jst)
    tsolution = tsol.solve_mobility_problem(ts, tst)
    assert tsolution.converged and bool(jsolution.converged)
    assert tsolution.iterations == int(jsolution.iterations)
    assert _rel(tsolution.velocities, jsolution.velocities) < 1e-10
    assert _rel(tsolution.lam, jsolution.lam) < 1e-10
    assert torch.equal(tsolution.velocities[1],
                       torch.tensor(V_OBST, dtype=torch.float64))
    # the lockstep solve writes the prescribed velocity too
    rhs = tsol.build_rhs(ts, tst, tkin.blob_positions(ts, tst))
    lock = tsol.solve_mobility_problem_lockstep(
        ts, tst, rhs=torch.stack([rhs, 0.5 * rhs]))
    assert torch.equal(lock.velocities[:, 1],
                       torch.tensor([V_OBST] * 2, dtype=torch.float64))
    assert _rel(lock.velocities[0], jsolution.velocities) < 1e-10


def _write_input(d, scheme, obstacle=True):
    ref = shell_vertices(12, 0.5)
    with open(d / "shell.vertex", "w") as f:
        f.write("12\n" + "".join("%.16g %.16g %.16g\n" % tuple(x)
                                 for x in ref))
    for name, rows in (("free", [[0, 0, 1.5, 1, 0, 0, 0],
                                 [1.7, 0, 1.5, 1, 0, 0, 0]]),
                       ("wall", [[0.8, 1.6, 0.7, 0.8, 0.6, 0, 0]])):
        with open(d / f"{name}.clones", "w") as f:
            f.write(f"{len(rows)}\n" + "".join(
                " ".join(str(v) for v in r) + "\n" for r in rows))
    text = (f"scheme {scheme}\ndt 0.001\nn_steps 2\neta 1.0\ng 1.0\n"
            "blob_radius 0.15\nkT 0.0\noutput_name run\n"
            "structure shell.vertex free.clones\n")
    if obstacle:
        text += "obstacle shell.vertex wall.clones\n"
    (d / "input.dat").write_text(text)
    return d / "input.dat"


def test_build_system_with_an_obstacle_matches_jax(tmp_path):
    inp = _write_input(tmp_path, "stochastic_Slip_Mid")
    js, jst = jinput.build_system(jinput.read_input(inp), base_dir=tmp_path)
    ts, tst = tinput.build_system(tinput.read_input(inp), base_dir=tmp_path,
                                  device="cpu")
    assert [(t.name, t.count, t.prescribed_kinematics, t.is_obstacle)
            for t in ts.types] == [
        (t.name, t.count, t.prescribed_kinematics, t.is_obstacle)
        for t in js.types] == [("free", 2, False, False),
                               ("wall", 1, True, True)]
    np.testing.assert_array_equal(ts.prescribed_velocities,
                                  js.prescribed_velocities)
    np.testing.assert_array_equal(to_np(tst.pos), np.asarray(jst.pos))
    np.testing.assert_array_equal(to_np(tst.quat), np.asarray(jst.quat))


@pytest.mark.parametrize("scheme", sorted(
    set(jint.available_schemes()) | {"mobility", "body_mobility",
                                     "resistance"}))
def test_scheme_obstacle_check_matches_jax(tmp_path, scheme):
    """An input with an obstacle line is refused for exactly the schemes
    the JAX package refuses, with its message."""
    inp = _write_input(tmp_path, scheme)
    try:
        jinput.read_input(inp)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tinput.read_input(inp)
        assert str(got.value) == str(e)
        assert scheme in tinput._NO_OBSTACLE_SCHEMES
    else:
        assert tinput.read_input(inp).obstacles_ID == ["wall"]
        assert scheme not in tinput._NO_OBSTACLE_SCHEMES
    # without obstacles every scheme passes the check
    tinput.read_input(_write_input(tmp_path, scheme, obstacle=False))


def test_the_check_refuses_eight_schemes():
    assert len(set(tinput._NO_OBSTACLE_SCHEMES)) == 8
