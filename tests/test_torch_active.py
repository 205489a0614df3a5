"""Active slip and body-body Yukawa forces in the PyTorch port against the
JAX package, float64 on the CPU, and the input reader's new entries:
the lab-frame active slip of a squirmer-like tangential slip field, the
right-hand side with it, three deterministic Adams-Bashforth steps of
slip-driven shells (equal GMRES counts, positions within 1e-9 of the
displacement), the Yukawa force between body centers in an open and a
periodic box, and build_system on an input with a .slip file, an
articulated entry whose .const holds time-dependent links (its links
evaluated at several t), nonlinear_solver_tolerance and
body_body_force_torque_implementation."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rigidmultiblobswall_tpu.io import input_file as jinput
from rigidmultiblobswall_tpu.models import integrators as jint
from rigidmultiblobswall_tpu.models import kinematics as jkin
from rigidmultiblobswall_tpu.models import solvers as jsol
from rigidmultiblobswall_tpu.models import system as jsys
from rigidmultiblobswall_tpu.ops import forces as jforces
from rigidmultiblobswall_tpu_torch.io import input_file as tinput
from rigidmultiblobswall_tpu_torch.models import articulated as tart
from rigidmultiblobswall_tpu_torch.models import integrators as tint
from rigidmultiblobswall_tpu_torch.models import kinematics as tkin
from rigidmultiblobswall_tpu_torch.models import solvers as tsol
from rigidmultiblobswall_tpu_torch.models import system as tsys
from rigidmultiblobswall_tpu_torch.ops import forces as tforces

from torch_parity import shell_vertices, to_np


def squirmer_slip(ref, b1=1.0):
    """The tangential squirmer slip B1 sin(theta) e_theta of a shell about
    its z axis, in the body frame, (nb, 3)."""
    r = ref / np.linalg.norm(ref, axis=1, keepdims=True)
    theta = np.arccos(np.clip(r[:, 2], -1, 1))
    phi = np.arctan2(r[:, 1], r[:, 0])
    e_theta = np.stack([np.cos(theta) * np.cos(phi),
                        np.cos(theta) * np.sin(phi), -np.sin(theta)], axis=1)
    return b1 * np.sin(theta)[:, None] * e_theta


def active_scene(n_bodies=4, seed=0, yukawa=False, **overrides):
    """n_bodies 12-blob squirmer shells above the wall beside two passive
    ones. Returns (jax_system, jax_state, port_system, port_state, pos)."""
    rng = np.random.default_rng(seed)
    n = n_bodies + 2
    pos = np.stack([1.8 * (np.arange(n) % 3), 1.8 * (np.arange(n) // 3),
                    np.full(n, 1.0)], axis=1)
    pos[:, :2] += rng.uniform(-0.2, 0.2, (n, 2))
    quat = rng.normal(size=(n, 4))
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    ref = shell_vertices(12, 0.5)
    types = (jsys.BodyType(name="squirmer", ref_config=ref, count=n_bodies,
                           slip_ref=squirmer_slip(ref)),
             jsys.BodyType(name="passive", ref_config=ref, count=2))
    kw = dict(eta=1.0, blob_radius=0.2, kT=0.0, g=0.0, domain="single_wall",
              repulsion_strength_wall=0.1, debye_length_wall=0.25,
              repulsion_strength=0.5, debye_length=0.5,
              solver_tolerance=1e-10,
              body_body_force_method="yukawa" if yukawa else "none")
    kw.update(overrides)
    js = jsys.System(types=types, **kw)
    ts, tst = tsys.from_reference(js, pos, quat, device="cpu")
    return js, jsys.make_state(pos, quat), ts, tst, pos


def test_active_slip_matches_jax():
    js, jst, ts, tst, _ = active_scene()
    ref = np.asarray(jkin.active_slip(js, jst))
    got = to_np(tkin.active_slip(ts, tst))
    assert np.abs(got - ref).max() <= 1e-14
    assert np.abs(ref[:48]).max() > 0.5 and not ref[48:].any()


def test_build_rhs_with_slip_matches_jax():
    js, jst, ts, tst, _ = active_scene(yukawa=True)
    rj = np.asarray(jsol.build_rhs(js, jst, jkin.blob_positions(js, jst)))
    rt = to_np(tsol.build_rhs(ts, tst, tkin.blob_positions(ts, tst)))
    assert np.abs(rt - rj).max() <= 1e-13 * np.abs(rj).max()


@pytest.mark.parametrize("yukawa", [False, True])
def test_adams_bashforth_with_slip_matches_jax(yukawa):
    js, jst, ts, tst, pos = active_scene(yukawa=yukawa)
    scheme, dt = "deterministic_adams_bashforth", 0.01
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
    assert disp > 1e-3                       # the squirmers swim
    np.testing.assert_allclose(to_np(t.pos), np.asarray(s.pos),
                               atol=1e-9 * disp, rtol=0)
    np.testing.assert_allclose(to_np(t.quat), np.asarray(s.quat),
                               atol=1e-9, rtol=0)


@pytest.mark.parametrize("box", [(0.0, 0.0, 0.0), (7.0, 7.0, 0.0),
                                 (6.0, 6.5, 7.0)])
def test_body_body_yukawa_matches_jax(box):
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 6, (40, 3))
    x[5] = x[4]                              # a pair at r = 0 adds nothing
    kw = dict(repulsion_strength=0.7, debye_length=0.8, periodic_length=box)
    ref = np.asarray(jforces.body_body_forces_torques(jnp.asarray(x), **kw))
    got = to_np(tforces.body_body_forces_torques(torch.tensor(x), **kw))
    assert np.abs(got - ref).max() <= 1e-13 * np.abs(ref).max()
    assert not ref[:, 3:].any() and np.abs(ref).max() > 0.01
    js, jst, ts, tst, _ = active_scene(yukawa=True)
    fj = np.asarray(jsol.force_torque_calculator(
        js, jst, jkin.blob_positions(js, jst)))
    ft = to_np(tsol.force_torque_calculator(
        ts, tst, tkin.blob_positions(ts, tst)))
    assert np.abs(ft - fj).max() <= 1e-13 * np.abs(fj).max()


def _write_inputs(d):
    """A structure with a .slip file and an articulated chain of two shells
    whose .const carries one constant and one time-dependent link."""
    ref = shell_vertices(12, 0.5)
    with open(d / "shell.vertex", "w") as f:
        f.write("12\n" + "".join("%.16g %.16g %.16g\n" % tuple(x)
                                 for x in ref))
    with open(d / "shell.slip", "w") as f:
        f.write("12\n" + "".join("%.16g %.16g %.16g\n" % tuple(x)
                                 for x in squirmer_slip(ref)))
    (d / "pair.list_vertex").write_text("shell.vertex\nshell.vertex\n")
    (d / "pair.const").write_text(
        "2\n2\n"
        "0 1  0.7 0 0  -0.7 0 0\n"
        "0 1  0 0.7 0  0 -0.7 0  0 0.7+0.1*sin(2*pi*t) 0 0 -0.7 0 "
        "0 0.2*pi*cos(2*pi*t) 0 0 0 0\n")
    (d / "pair.clones").write_text(
        "4\n0 0 2 1 0 0 0\n1.4 0 2 1 0 0 0\n5 5 2 1 0 0 0\n6.4 5 2 1 0 0 0\n")
    (d / "swim.clones").write_text(
        "2\n3 -3 1.5 1 0 0 0\n-3 3 1.5 0 1 0 0\n")
    inp = d / "input.dat"
    inp.write_text(
        "scheme articulated_deterministic_forward_euler\ndt 0.01\n"
        "n_steps 2\nblob_radius 0.2\n"
        "nonlinear_solver_tolerance 1e-9\n"
        "body_body_force_torque_implementation python\n"
        "structure shell.vertex swim.clones shell.slip\n"
        "articulated pair.list_vertex pair.clones pair.const shell.slip\n")
    return inp


def test_build_system_reads_slip_const_and_options(tmp_path, monkeypatch):
    inp = _write_inputs(tmp_path)
    # the .list_vertex entries resolve against the working directory
    monkeypatch.chdir(tmp_path)
    js, jst = jinput.build_system(jinput.read_input(str(inp)),
                                  base_dir=str(tmp_path))
    ts, tst = tinput.build_system(tinput.read_input(str(inp)),
                                  base_dir=str(tmp_path), device="cpu")
    assert [t.name for t in ts.types] == [t.name for t in js.types] == [
        "swim", "pair_sub0", "pair_sub1"]
    for tt, jt in zip(ts.types, js.types):
        assert tt.count == jt.count
        np.testing.assert_array_equal(tt.ref_config, jt.ref_config)
        np.testing.assert_array_equal(tt.slip_ref, jt.slip_ref)
    assert ts.nonlinear_solver_tolerance == js.nonlinear_solver_tolerance \
        == 1e-9
    assert ts.body_body_force_method == js.body_body_force_method == "yukawa"
    np.testing.assert_array_equal(to_np(tst.pos), np.asarray(jst.pos))
    np.testing.assert_array_equal(to_np(tst.quat), np.asarray(jst.quat))
    (ta,), (ja,) = ts.articulated, js.articulated
    assert (ta.name, ta.count, ta.sub_type_indices) == (
        ja.name, ja.count, ja.sub_type_indices) == ("pair", 2, (1, 2))
    np.testing.assert_array_equal(ta.pairs_local, ja.pairs_local)
    np.testing.assert_array_equal(ta.links, ja.links)
    for t in (0.0, 0.125, 0.3, 1.7):
        for got, ref in zip(tart.links_at_time(ta, t, tst.pos),
                            ja.links_fn(t)):
            np.testing.assert_allclose(to_np(got), np.asarray(ref),
                                       atol=1e-15, rtol=0)
    # the active slip of both entries reaches the right-hand side
    rj = np.asarray(jsol.build_rhs(js, jst, jkin.blob_positions(js, jst),
                                   time=0.3))
    rt = to_np(tsol.build_rhs(ts, tst, tkin.blob_positions(ts, tst),
                              time=0.3))
    assert np.abs(rt - rj).max() <= 1e-13 * np.abs(rj).max()
    assert np.abs(to_np(tkin.active_slip(ts, tst))).max() > 0.5
    # without the option the body-body force stays off, as in JAX
    text = inp.read_text().replace(
        "body_body_force_torque_implementation python\n", "")
    inp.write_text(text)
    ts2, _ = tinput.build_system(tinput.read_input(str(inp)),
                                 base_dir=str(tmp_path), device="cpu")
    assert ts2.body_body_force_method == "none"
    assert ts2.nonlinear_solver_tolerance == 1e-9
    os.remove(tmp_path / "shell.slip")
    with pytest.raises(FileNotFoundError):
        tinput.build_system(tinput.read_input(str(inp)),
                            base_dir=str(tmp_path), device="cpu")
