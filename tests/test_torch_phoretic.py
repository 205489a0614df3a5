"""The phoretic path of the PyTorch port against the JAX package, float64
on the CPU, on inputs made from a numpy seed: the four Laplace layer
operators (wall on and off, self mask on and off, on-surface and
off-surface targets, a blob on the wall with its own image at zero
distance) and the two fused sums to 1e-12 x max|ref|; the chunked plain
versions against unchunked ones to 1e-13; the background concentration,
the lab-frame normals, the phoretic slip (equal GMRES iterations, slip to
1e-10) and the off-surface concentration; the Stokes layers (pressure
open, above the wall and in a periodic box; the RPY and the Gimbutas
double layers; the dense double layer) to 1e-12; the source-target
product in every branch (wall, open, free surface, image boxes,
zero-radius tracers) to 1e-12; the velocity-field grid and its VTK
files; 8 Janus shells x 3 steps of deterministic forward Euler,
stochastic Slip-Trapz (kT 0.05, JAX's normals fed) and Slip-Mid DLA
against JAX's stepper to 1e-9 of the displacement; build_system with
.Laplace files; config_from_reference."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rigidmultiblobswall_tpu.io import input_file as jinput
from rigidmultiblobswall_tpu.models import fields as jfields
from rigidmultiblobswall_tpu.models import integrators as jint
from rigidmultiblobswall_tpu.models import phoretic as jph
from rigidmultiblobswall_tpu.models import system as jsys
from rigidmultiblobswall_tpu.ops import laplace as jl
from rigidmultiblobswall_tpu.ops import mobility as jmob
from rigidmultiblobswall_tpu.ops import stokes_layers as jsl
from rigidmultiblobswall_tpu_torch.io import input_file as tinput
from rigidmultiblobswall_tpu_torch.models import fields as tfields
from rigidmultiblobswall_tpu_torch.models import integrators as tint
from rigidmultiblobswall_tpu_torch.models import phoretic as tph
from rigidmultiblobswall_tpu_torch.models import system as tsys
from rigidmultiblobswall_tpu_torch.ops import laplace as tl
from rigidmultiblobswall_tpu_torch.ops import mobility as tmob
from rigidmultiblobswall_tpu_torch.ops import stokes_layers as tsl

from torch_parity import feed_jax_noise, to_np

OPS = {"S": (jl.single_layer, tl.single_layer, tl.single_layer_plain,
             False),
       "D": (jl.double_layer, tl.double_layer, tl.double_layer_plain, True),
       "dD": (jl.deriv_double_layer, tl.deriv_double_layer,
              tl.deriv_double_layer_plain, True),
       "T": (jl.dipole, tl.dipole, tl.dipole_plain, False)}
# the example's Janus shell: the 12 icosahedron directions at R = 0.7921
JANUS_LAPLACE = "examples/phoretic_janus/shell12_janus.Laplace"
JANUS_R = 0.7921


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def _layer_inputs(seed=0, n=41, n_off=23):
    """Sources above the wall (one on the wall, one duplicated: a zero
    distance and a zero image distance), unit normals, a field, weights,
    and off-surface targets (one on a source)."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(0, 3, (n, 3))
    r[0, 2] = 0.0
    r[1] = r[2]
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    tgt = rng.uniform(-0.5, 3.5, (n_off, 3))
    tgt[:, 2] = np.abs(tgt[:, 2])
    tgt[4] = r[7]
    return (r, tgt, nrm, rng.normal(size=n), rng.uniform(0.1, 1.0, n),
            rng.uniform(0.0, 5.0, n), rng.uniform(0.0, 1.0, n))


def _close(got, ref, tol):
    got, ref = to_np(got), to_np(ref)
    assert got.shape == ref.shape
    assert np.abs(ref).max() > 0
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


@pytest.mark.parametrize("self_interaction", [True, False])
@pytest.mark.parametrize("wall", [False, True])
@pytest.mark.parametrize("op", list(OPS))
def test_laplace_operator_matches_jax(op, wall, self_interaction):
    r, tgt, nrm, c, w, _, _ = _layer_inputs()
    jf, tf, _, normals = OPS[op]
    extra = (nrm,) if normals else ()
    kw = dict(wall=wall, self_interaction=self_interaction)
    for targets in (r, tgt):
        ref = jf(jnp.asarray(r), jnp.asarray(targets), jnp.asarray(c),
                 jnp.asarray(w), *map(jnp.asarray, extra), **kw)
        got = tf(_t(r), _t(targets), _t(c), _t(w), *map(_t, extra), **kw)
        _close(got, ref, 1e-12)


@pytest.mark.parametrize("wall", [False, True])
def test_fused_sums_match_jax_composition(wall):
    """bvp_operator and surface_gradient against the JAX package's
    phoretic_slip operator and gradient terms."""
    r, _, nrm, c, w, k, q = _layer_inputs(1)
    dc = 0.7
    J = jnp.asarray
    x = 0.5 * J(c)
    x = x - jl.double_layer(J(r), J(r), J(c), J(w), J(nrm), wall=wall)
    ref = x + jl.single_layer(J(r), J(r), J(k) * J(c) / dc, J(w), wall=wall)
    _close(tl.bvp_operator(_t(r), _t(c), _t(w), _t(nrm), _t(k), dc,
                           wall=wall), ref, 1e-12)
    g = 2.0 * jl.deriv_double_layer(J(r), J(r), J(c), J(w), J(nrm),
                                    wall=wall)
    ref = g - 2.0 * jl.dipole(J(r), J(r), (J(q) - J(k) * J(c)) / dc, J(w),
                              wall=wall)
    _close(tl.surface_gradient(_t(r), _t(c), _t(w), _t(nrm), _t(k), _t(q),
                               dc, wall=wall), ref, 1e-12)


@pytest.mark.parametrize("op", list(OPS) + ["bvp", "grad"])
def test_chunked_plain_matches_unchunked(op, monkeypatch):
    r, tgt, nrm, c, w, k, q = _layer_inputs(2)
    args = [_t(x) for x in (r, tgt, nrm, c, w, k, q)]
    r, tgt, nrm, c, w, k, q = args
    row_bytes = 3 * r.shape[0] * r.element_size()
    for wall in (False, True):
        if op == "bvp":
            run = lambda: tl.bvp_operator_plain(  # noqa: E731
                r, c, w, nrm, k, 0.7, wall=wall)
        elif op == "grad":
            run = lambda: tl.surface_gradient_plain(  # noqa: E731
                r, c, w, nrm, k, q, 0.7, wall=wall)
        else:
            plain, normals = OPS[op][2], OPS[op][3]
            extra = (nrm,) if normals else ()
            run = lambda: plain(r, tgt, c, w, *extra,  # noqa: E731
                                wall=wall)
        monkeypatch.setattr(tl, "PLAIN_CHUNK_BYTES", 10 ** 6 * row_bytes)
        whole = run()
        for ch in (1, 5, 17):
            monkeypatch.setattr(tl, "PLAIN_CHUNK_BYTES", ch * row_bytes)
            assert tl._chunk_rows(10 ** 6, r.shape[0], r.element_size()) == ch
            _close(run(), whole, 1e-13)


def test_chunk_rows_bound_the_temporary():
    rows = tl._chunk_rows(49152, 49152, 4)
    assert 3 * rows * 49152 * 4 <= tl.PLAIN_CHUNK_BYTES
    assert tl._chunk_rows(10, 10, 8) == 10


def test_plan_slices_cover_the_sources():
    for nt, ns in ((49152, 49152), (1024, 49152), (32768, 49152),
                   (100, 3000), (7, 5)):
        slices, per = tl.plan_slices(nt, ns, 132)
        tiles = -(-ns // 128)
        assert slices * per >= tiles > (slices - 1) * per
        assert slices * nt * 24 <= 1 << 26 or slices == 1


# ---------------------------------------------------------------------------
# The phoretic model
# ---------------------------------------------------------------------------


def janus_chemistry():
    """The phoretic_janus example's chemistry (its .Laplace file) and the
    shell it describes, R times its normals."""
    chem = jph.Chemistry.from_laplace_file(
        __file__.rsplit("tests/", 1)[0] + JANUS_LAPLACE)
    return chem, JANUS_R * np.asarray(chem.normals_ref)


def janus_scene(n=8, seed=0, wall=True, background=(1.0,), dc=1.0,
                **overrides):
    """n Janus shells above the wall (or in the open) with the example's
    chemistry, beside two inert shells. Returns (jax_system, jax_state,
    port_system, port_state, jax_cfg, port_cfg, pos)."""
    chem, ref = janus_chemistry()
    rng = np.random.default_rng(seed)
    m = n + 2
    pos = np.stack([2.6 * (np.arange(m) % 4), 2.6 * (np.arange(m) // 4),
                    np.full(m, 1.6)], axis=1)
    pos += rng.uniform(-0.2, 0.2, (m, 3))
    quat = rng.normal(size=(m, 4))
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    types = (jsys.BodyType(name="janus", ref_config=ref, count=n),
             jsys.BodyType(name="inert", ref_config=ref, count=2))
    kw = dict(eta=1.0, blob_radius=0.416, kT=0.0, g=0.0,
              domain="single_wall" if wall else "no_wall",
              repulsion_strength_wall=0.1, debye_length_wall=0.25,
              solver_tolerance=1e-10)
    kw.update(overrides)
    bg = np.hstack([background, np.zeros(9 - len(background))])
    jcfg = jph.PhoreticConfig(chemistry=(chem, None), background=bg,
                              diffusion_coefficient=dc)
    tcfg = tph.config_from_reference(jcfg)

    def jslip(system, state):
        return jph.phoretic_slip(system, state, jcfg)[0]

    js = jsys.System(types=types, slip_fn=jslip, **kw)
    jbase = jsys.System(types=types, **kw)
    ts, tst = tsys.from_reference(jbase, pos, quat, device="cpu")
    import dataclasses

    ts = dataclasses.replace(ts, slip_fn=tph.make_slip_fn(tcfg))
    return js, jsys.make_state(pos, quat), ts, tst, jcfg, tcfg, pos


def test_config_from_reference():
    *_, jcfg, tcfg, _ = janus_scene(background=(1.0, 0.1, -0.2, 0.3, 0.05))
    assert tcfg.chemistry[1] is None
    chem = tcfg.chemistry[0]
    for name in ("normals_ref", "reaction_rate", "emitting_rate",
                 "surface_mobility", "weights"):
        np.testing.assert_array_equal(getattr(chem, name),
                                      getattr(jcfg.chemistry[0], name))
    np.testing.assert_array_equal(tcfg.background, jcfg.background)
    assert tcfg.diffusion_coefficient == jcfg.diffusion_coefficient


def test_background_concentration_and_lab_normals_match_jax():
    js, jst, ts, tst, jcfg, tcfg, _ = janus_scene(
        background=(0.5, 0.1, -0.2, 0.3, 0.05, -0.07, 0.02, 0.11, -0.04))
    r = np.random.default_rng(4).uniform(-2, 2, (30, 3))
    cj, gj = jph.background_concentration(jcfg.background, jnp.asarray(r))
    ct, gt = tph.background_concentration(tcfg.background, _t(r))
    _close(ct, cj, 1e-14)
    _close(gt, gj, 1e-14)
    nj = jph.lab_normals(js, jst, jcfg.chemistry)
    nt = tph.lab_normals(ts, tst, tcfg.chemistry)
    _close(nt, nj, 1e-14)
    assert not to_np(nt)[96:].any()


@pytest.mark.parametrize("wall", [True, False])
def test_phoretic_slip_matches_jax(wall):
    js, jst, ts, tst, jcfg, tcfg, _ = janus_scene(
        wall=wall, background=(1.0, 0.2, 0.0, -0.1), dc=0.8)
    sj, cj, itj = jph.phoretic_slip(js, jst, jcfg)
    st, ct, itt = tph.phoretic_slip(ts, tst, tcfg)
    assert itt == int(itj) and itt > 3
    _close(ct, cj, 1e-10)
    _close(st, sj, 1e-10)
    # the cached-fields path of the System's hook gives the same slip
    _close(ts.slip_fn(ts, tst), st, 1e-15)


def test_concentration_field_matches_jax():
    js, jst, ts, tst, jcfg, tcfg, _ = janus_scene(background=(1.0, 0.1))
    x = np.random.default_rng(5).uniform(-1, 9, (50, 3))
    x[:, 2] = np.abs(x[:, 2]) + 0.1
    cj, sj = jph.concentration_field(js, jst, jcfg, x)
    ct, st = tph.concentration_field(ts, tst, tcfg, x)
    _close(st, sj, 1e-10)
    _close(ct, cj, 1e-10)
    ct2, _ = tph.concentration_field(ts, tst, tcfg, x, c=st)
    _close(ct2, ct, 1e-15)


# ---------------------------------------------------------------------------
# Stokes layers and the source-target product
# ---------------------------------------------------------------------------


def _stokes_inputs(seed=6, n=30, n_t=21):
    rng = np.random.default_rng(seed)
    r = rng.uniform(0, 3, (n, 3))
    r[:, 2] += 0.2
    tgt = rng.uniform(0, 3, (n_t, 3))
    tgt[3] = r[4]
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return r, tgt, nrm, rng.normal(size=(n, 3)), rng.uniform(0.1, 1, n)


@pytest.mark.parametrize("wall, box", [(False, (0.0, 0.0, 0.0)),
                                       (True, (0.0, 0.0, 0.0)),
                                       (False, (3.5, 4.0, 5.0)),
                                       (True, (3.5, 3.5, 0.0))])
def test_pressure_stokeslet_matches_jax(wall, box):
    r, tgt, _, f, _ = _stokes_inputs()
    ref = jsl.pressure_stokeslet(jnp.asarray(r), jnp.asarray(tgt),
                                 jnp.asarray(f), wall=wall,
                                 periodic_length=box)
    got = tsl.pressure_stokeslet(_t(r), _t(tgt), _t(f), wall=wall,
                                 periodic_length=box)
    _close(got, ref, 1e-12)


@pytest.mark.parametrize("wall", [False, True])
def test_double_layers_match_jax(wall):
    r, tgt, nrm, v, w = _stokes_inputs()
    J = jnp.asarray
    ref = jsl.double_layer_source_target(J(r), J(tgt), J(nrm), J(v), J(w),
                                         wall=wall)
    got = tsl.double_layer_source_target(_t(r), _t(tgt), _t(nrm), _t(v),
                                         _t(w), wall=wall)
    _close(got, ref, 1e-12)
    ref = jsl.double_layer_rpy_source_target(J(r), J(tgt), J(nrm), J(v),
                                             J(w), 0.3)
    got = tsl.double_layer_rpy_source_target(_t(r), _t(tgt), _t(nrm), _t(v),
                                             _t(w), 0.3)
    _close(got, ref, 1e-12)


def test_double_layer_dense_matches_jax():
    r, tgt, nrm, _, w = _stokes_inputs()
    J = jnp.asarray
    ref = jsl.double_layer_dense(J(r), J(tgt), J(nrm), J(w))
    got = tsl.double_layer_dense(_t(r), _t(tgt), _t(nrm), _t(w))
    _close(got, ref, 1e-12)
    self_blocks = tsl.double_layer_dense(_t(r), _t(r), _t(nrm), _t(w))
    assert not to_np(self_blocks)[:3, :3].any()


@pytest.mark.parametrize("case", ["wall", "open", "free_surface", "boxes",
                                  "tracers"])
def test_source_target_matvec_matches_jax(case):
    rng = np.random.default_rng(8)
    n, nt = 26, 19
    r = rng.uniform(0, 3, (n, 3))
    r[:, 2] = rng.uniform(0.05, 2.0, n)            # blobs below their radius
    tgt = rng.uniform(0, 3, (nt, 3))
    tgt[:, 2] = rng.uniform(0.02, 2.5, nt)
    tgt[2] = r[3]                                 # a target on a source
    f = rng.normal(size=(n, 3))
    b = rng.uniform(0.1, 0.4, n)
    a = rng.uniform(0.05, 0.3, nt)
    kw = {"wall": dict(wall=True), "open": dict(wall=False),
          "free_surface": dict(domain="free_surface"),
          "boxes": dict(wall=True, periodic_length=(3.2, 2.9, 0.0)),
          "tracers": dict(wall=True)}[case]
    if case == "tracers":
        a[::2] = 0.0
    ref = jmob.source_target_matvec(jnp.asarray(r), jnp.asarray(tgt),
                                    jnp.asarray(f), jnp.asarray(b),
                                    jnp.asarray(a), 0.9, row_tile=5, **kw)
    for tile in (None, 4):
        got = tmob.source_target_matvec(_t(r), _t(tgt), _t(f), _t(b), _t(a),
                                        0.9, row_tile=tile, **kw)
        _close(got, ref, 1e-12)


def test_velocity_field_grid_and_vtk_match_jax(tmp_path):
    spec = [-2.0, 6.0, 4, -1.0, 5.0, 3, 0.5, 3.5, 2]
    cj, mj, nj = jfields.velocity_field_grid(spec)
    ct, mt, nt = tfields.velocity_field_grid(spec)
    np.testing.assert_array_equal(ct, cj)
    np.testing.assert_array_equal(nt, nj)
    for a, b in zip(mt, mj):
        np.testing.assert_array_equal(a, b)
    js, jst, ts, tst, jcfg, tcfg, _ = janus_scene(n=2)
    lam = np.random.default_rng(9).normal(size=(js.num_blobs, 3))
    vj = jfields.plot_velocity_field_to_vtk(spec, js, jst, jnp.asarray(lam),
                                            str(tmp_path / "jax"), 0.1)
    vt = tfields.plot_velocity_field_to_vtk(spec, ts, tst, _t(lam),
                                            str(tmp_path / "port"), 0.1)
    _close(vt, vj, 1e-12)
    cj = jfields.plot_concentration_field_to_vtk(spec, js, jst, jcfg,
                                                 str(tmp_path / "jax"))
    ct = tfields.plot_concentration_field_to_vtk(spec, ts, tst, tcfg,
                                                 str(tmp_path / "port"))
    _close(ct, cj, 1e-10)
    for suffix in (".velocity_field.vtk", ".concentration_field.vtk"):
        a = read_vtk(tmp_path / ("port" + suffix))
        b = read_vtk(tmp_path / ("jax" + suffix))
        assert a.keys() == b.keys()
        for key in a:
            _close(a[key], b[key], 1e-5)     # %g keeps six digits


def read_vtk(path):
    """The sections of a legacy-VTK rectilinear grid as arrays: the
    dimensions, the three coordinate lines and each variable."""
    lines = open(path).read().splitlines()
    assert lines[0] == "# vtk DataFile Version 3.0"
    out = {"DIMENSIONS": np.array(lines[4].split()[1:], dtype=float)}
    i = 5
    while i < len(lines):
        head = lines[i].split()
        if head[0].endswith("_COORDINATES"):
            out[head[0]] = np.array(lines[i + 1].split(), dtype=float)
            i += 2
        elif head[0] == "CELL_DATA":
            n = int(head[1])
            out["CELL_DATA"] = np.array([n], dtype=float)
            i += 1
        elif head[0] in ("SCALARS", "VECTORS"):
            skip = 2 if head[0] == "SCALARS" else 1
            rows = lines[i + skip:i + skip + n]
            out[head[1]] = np.array([r.split() for r in rows], dtype=float)
            i += skip + n
        else:
            raise AssertionError(f"unexpected VTK line {lines[i]!r}")
    return out


# ---------------------------------------------------------------------------
# Phoretic dynamics against JAX's stepper
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scheme, kT", [("deterministic_forward_euler", 0.0),
                                        ("stochastic_Slip_Trapz", 0.05),
                                        ("stochastic_Slip_Mid_DLA", 0.05)])
def test_janus_steps_match_jax(monkeypatch, scheme, kT):
    js, jst, ts, tst, _, _, pos = janus_scene(kT=kT)
    keys = [jax.random.PRNGKey(40 + i) for i in range(3)]
    if kT > 0:
        feed_jax_noise(monkeypatch, keys, scheme, js)
    dt = 0.01
    jstep = jax.jit(jint.make_stepper(js, scheme, dt))
    jc = jint.init_carry(js, state=jst)
    tstep = tint.make_stepper(ts, scheme, dt)
    tc = tint.init_carry(ts, state=tst)
    gen = torch.Generator().manual_seed(0)
    s, t = jst, tst
    for k in keys:
        s, jc, jaux = jstep(s, k, jc)
        t, tc, taux = tstep(t, gen, tc)
        assert taux.det_iterations == int(jaux.det_iterations)
        assert taux.rejections == int(jaux.rejections) == 0
    disp = np.abs(np.asarray(s.pos) - pos).max()
    assert disp > 1e-3                          # the Janus shells swim
    np.testing.assert_allclose(to_np(t.pos), np.asarray(s.pos),
                               atol=1e-9 * disp, rtol=0)
    np.testing.assert_allclose(to_np(t.quat), np.asarray(s.quat),
                               atol=1e-9, rtol=0)


# ---------------------------------------------------------------------------
# Input files
# ---------------------------------------------------------------------------


def _janus_input(d, extra=""):
    chem, ref = janus_chemistry()
    with open(d / "shell.vertex", "w") as f:
        f.write("12\n")
        for x in ref:
            f.write("%.16g %.16g %.16g\n" % tuple(x))
    with open(d / "shell.clones", "w") as f:
        f.write("2\n0 0 1.5 1 0 0 0\n2.5 0 1.6 0 1 0 0\n")
    (d / "shell.Laplace").write_text(open(
        __file__.rsplit("tests/", 1)[0] + JANUS_LAPLACE).read())
    with open(d / "input.dat", "w") as f:
        f.write("scheme deterministic_forward_euler\nblob_radius 0.416\n"
                "background_Laplace 1 0.5\ndiffusion_coefficient 2\n"
                "structure shell.vertex shell.clones shell.Laplace\n"
                "structure shell.vertex shell.clones\n" + extra)
    return d / "input.dat"


def test_build_system_reads_laplace_files(tmp_path):
    inp = _janus_input(tmp_path)
    jcfg = jinput.read_input(inp)
    jsystem, jstate = jinput.build_system(jcfg, base_dir=tmp_path)
    tcfg = tinput.read_input(inp)
    tsystem, tstate = tinput.build_system(tcfg, base_dir=tmp_path,
                                          device="cpu")
    np.testing.assert_array_equal(tcfg.background_laplace,
                                  jcfg.background_laplace)
    assert tcfg.diffusion_coefficient == 2.0
    assert tcfg.phoretic_cfg.chemistry[1] is None
    assert tsystem.slip_fn is not None
    tstate = tsys.make_state(to_np(tstate.pos), to_np(tstate.quat),
                             device="cpu")
    _close(tsystem.slip_fn(tsystem, tstate),
           jsystem.slip_fn(jsystem, jstate), 1e-10)


def test_read_input_refuses_a_long_background(tmp_path):
    inp = _janus_input(tmp_path, "background_Laplace 1 2 3 4 5 6 7 8 9 10\n")
    with pytest.raises(ValueError, match="at most 9 values"):
        tinput.read_input(inp)
