"""Per-blob and mixed blob radii on the pairwise domains of the PyTorch
port against the JAX package, float64 on the CPU (1e-10 unless stated):

- System: from_reference carries each type's blob_radii; build_system
  reads them from four-column .vertex files (structures, obstacles and
  articulated sub-bodies) as the JAX build_system does.
- The products: mobility_radii_trans_times_force, its stacked form and
  dense_mobility_radii on single_wall and no_wall (the plain version of
  kernel P1); the different-radii blocks are reciprocal, M(j, i) =
  M(i, j)^T, to 1e-13 (P1's symmetric sweep rests on it), and P1's
  condensed block (csrc/pair_radii.cu's arithmetic, emulated in numpy)
  is the plain block.
- The saddle operator, the block-diagonal preconditioner,
  dense_blob_mobility and the velocity field with per-blob source radii;
  the matrix-free engine never materializes with mixed radii; the wall
  spectral engine refuses them as JAX does.
- The path: forward Euler and Slip-Trapz steps of a 4-shell bidisperse
  scene against JAX's stepper, the Slip-Trapz step on JAX's normals fed;
  the CLI's dynamic and mobility runs on a four-column scene.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rigidmultiblobswall_tpu import cli as jcli
from rigidmultiblobswall_tpu.io import input_file as jinput
from rigidmultiblobswall_tpu.models import fields as jfields
from rigidmultiblobswall_tpu.models import integrators as jint
from rigidmultiblobswall_tpu.models import saddle as jsad
from rigidmultiblobswall_tpu.models import solvers as jsol
from rigidmultiblobswall_tpu.models import system as jsys
from rigidmultiblobswall_tpu.ops import mobility as jmob
from rigidmultiblobswall_tpu_torch import cli as tcli
from rigidmultiblobswall_tpu_torch.io import input_file as tinput
from rigidmultiblobswall_tpu_torch.models import fields as tfields
from rigidmultiblobswall_tpu_torch.models import integrators as tint
from rigidmultiblobswall_tpu_torch.models import saddle as tsad
from rigidmultiblobswall_tpu_torch.models import solvers as tsol
from rigidmultiblobswall_tpu_torch.models import system as tsys
from rigidmultiblobswall_tpu_torch.ops import mobility as tmob
from rigidmultiblobswall_tpu_torch.ops import mobility_cuda as tmc
from rigidmultiblobswall_tpu_torch.ops import rpy as trpy

from torch_parity import feed_jax_noise, shell_vertices, to_np

TOL = 1e-10
ETA = 1.3


def _rel(got, ref):
    ref = np.asarray(ref)
    return float(np.abs(to_np(got) - ref).max() / np.abs(ref).max())


def _blobs(n=40, seed=0):
    """Blobs above the wall with radii in [0.08, 0.3]: some below their
    radius, a coincident pair of unequal radii, a pair one inside the
    other and overlapping pairs."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(0, 3, (n, 3))
    r[:, 2] = rng.uniform(0.05, 2, n)
    rad = rng.uniform(0.08, 0.3, n)
    r[3] = r[2]
    r[5] = r[4] + 0.01
    rad[4], rad[5] = 0.1, 0.3
    r[7] = r[6] + 0.2
    return r, rad, rng.normal(size=(n, 3))


def _bidisperse(n_bodies=4, seed=0, kT=0.0, domain="single_wall", **kw):
    """Shells of radius 0.5 (blob radius 0.131, the System's) alternating
    with 1.2x shells of blob radius 0.157 (the type's blob_radii), in
    bench.py's multibody physics. Returns (jax_system, jax_state,
    port_system, port_state)."""
    rng = np.random.default_rng(seed)
    n_big = n_bodies // 2
    n_small = n_bodies - n_big
    pos = np.stack([1.7 * np.arange(n_bodies), 0.5 * np.arange(n_bodies),
                    np.full(n_bodies, 1.0)], axis=1)
    pos[:, :2] += rng.uniform(-0.2, 0.2, (n_bodies, 2))
    # type order: the small shells, then the big ones
    pos = np.concatenate([pos[0::2], pos[1::2]])
    quat = rng.normal(size=(n_bodies, 4))
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    small = jsys.BodyType(name="shell", ref_config=shell_vertices(12, 0.5),
                          count=n_small)
    big = jsys.BodyType(name="big", ref_config=shell_vertices(12, 0.6),
                        count=n_big, blob_radii=np.full(12, 0.157))
    sk = dict(eta=1.0, blob_radius=0.131, kT=kT, g=0.1, domain=domain,
              repulsion_strength_wall=0.2, debye_length_wall=0.2,
              repulsion_strength=0.2, debye_length=0.2,
              solver_tolerance=1e-12)
    sk.update(kw)
    js = jsys.System(types=(small, big), **sk)
    ts, tst = tsys.from_reference(js, pos, quat, device="cpu")
    return js, jsys.make_state(pos, quat), ts, tst


def test_from_reference_carries_radii():
    js, _, ts, _ = _bidisperse()
    assert ts.has_mixed_radii and js.has_mixed_radii
    assert ts.types[0].blob_radii is None
    np.testing.assert_array_equal(ts.types[1].blob_radii,
                                  js.types[1].blob_radii)
    np.testing.assert_array_equal(ts.blob_radii, js.blob_radii)
    # radii equal to blob_radius are no mixture
    same = dataclasses.replace(js, types=(dataclasses.replace(
        js.types[1], blob_radii=np.full(12, 0.131)),) + js.types[:1])
    assert not tsys.from_reference(same, device="cpu").has_mixed_radii


def _vertex(path, ref, radii=None):
    with open(path, "w") as f:
        f.write(f"{len(ref)}\n")
        for k, x in enumerate(ref):
            cols = tuple(x) + (() if radii is None else (radii[k],))
            f.write(" ".join("%.16g" % v for v in cols) + "\n")


def _clones(path, pos):
    with open(path, "w") as f:
        f.write(f"{len(pos)}\n")
        for p in pos:
            f.write(" ".join("%.16g" % v for v in (*p, 1.0, 0.0, 0.0, 0.0))
                    + "\n")


def test_build_system_reads_four_column_vertex_files(tmp_path):
    """A structure, an obstacle and a two-body articulated entry, each from
    a four-column .vertex file: the same types and radii as the JAX
    build_system."""
    rng = np.random.default_rng(2)
    _vertex(tmp_path / "a.vertex", shell_vertices(12, 0.5),
            rng.uniform(0.1, 0.2, 12))
    _vertex(tmp_path / "b.vertex", shell_vertices(6, 0.4),
            np.full(6, 0.15))
    _vertex(tmp_path / "c.vertex", shell_vertices(6, 0.3))
    _clones(tmp_path / "a.clones", [[0, 0, 1.0], [2, 0, 1.0]])
    _clones(tmp_path / "b.clones", [[0, 3, 1.0]])
    _clones(tmp_path / "d.clones", [[5, 0, 1.0], [6, 0, 1.0]])
    (tmp_path / "d.list_vertex").write_text(
        f"{tmp_path / 'b.vertex'}\n{tmp_path / 'c.vertex'}\n")
    (tmp_path / "d.const").write_text(
        "2\n1\n0 1 0.5 0 0 -0.5 0 0\n")
    (tmp_path / "input.dat").write_text(
        "scheme deterministic_forward_euler\ndt 0.001\nn_steps 1\n"
        "blob_radius 0.131\neta 1.0\n"
        "structure a.vertex a.clones\nobstacle b.vertex b.clones\n"
        "articulated d.list_vertex d.clones d.const\n")
    inp = str(tmp_path / "input.dat")
    js, _ = jinput.build_system(jinput.read_input(inp), str(tmp_path))
    ts, _ = tinput.build_system(tinput.read_input(inp), str(tmp_path),
                                device="cpu")
    assert [t.name for t in ts.types] == [t.name for t in js.types]
    for tt, jt in zip(ts.types, js.types):
        assert (tt.blob_radii is None) == (jt.blob_radii is None), tt.name
        if jt.blob_radii is not None:
            np.testing.assert_array_equal(tt.blob_radii, jt.blob_radii)
    np.testing.assert_array_equal(ts.blob_radii, js.blob_radii)
    assert ts.has_mixed_radii == js.has_mixed_radii is True


@pytest.mark.parametrize("domain", ["single_wall", "no_wall"])
def test_radii_products_match_jax(domain):
    r, rad, v = _blobs()
    ref = jmob.mobility_radii_trans_times_force(
        jnp.asarray(r), jnp.asarray(v), jnp.asarray(rad), ETA, domain=domain)
    got = tmob.mobility_radii_trans_times_force(
        torch.tensor(r), torch.tensor(v), torch.tensor(rad), ETA,
        domain=domain)
    assert _rel(got, ref) < TOL
    dref = jmob.dense_mobility_radii(jnp.asarray(r), jnp.asarray(rad), ETA,
                                     domain=domain)
    dgot = tmob.dense_mobility_radii(torch.tensor(r), torch.tensor(rad),
                                     ETA, domain=domain)
    assert _rel(dgot, dref) < TOL
    # the dense matrix is the product's, and symmetric
    assert _rel(dgot @ torch.tensor(v).reshape(-1), np.asarray(ref).ravel()
                ) < TOL
    assert float((dgot - dgot.T).abs().max() / dgot.abs().max()) < 1e-13
    # batched bodies: (c, nb, 3) -> (c, 3nb, 3nb)
    rb = torch.tensor(r[:36]).reshape(3, 12, 3)
    batched = tmob.dense_mobility_radii(rb, torch.tensor(rad[:36]).reshape(
        3, 12), ETA, domain=domain)
    one = tmob.dense_mobility_radii(rb[1], torch.tensor(rad[12:24]), ETA,
                                    domain=domain)
    assert torch.equal(batched[1], one)


@pytest.mark.parametrize("wall", [True, False])
def test_radii_blocks_are_reciprocal(wall):
    """M(j, i) = M(i, j)^T for the different-radii blocks at 1e-13: the
    wall's terms 3 and 4 trade (a^2, z_s) for (b^2, z_t) under the swap,
    so kernel P1 may condense each unordered pair once."""
    r, rad, _ = _blobs(60, seed=3)
    r[:, 2] = np.maximum(r[:, 2], rad)
    d = torch.tensor(r[:, None] - r[None])
    a = torch.tensor(rad)
    z = torch.tensor(r[:, 2])
    m = trpy.rpy_tt_radii(d, a[:, None], a[None])
    if wall:
        m = m + trpy.wall_tt_radii(d[..., 0], d[..., 1], z[:, None] + z[None],
                                   z[:, None], z[None], a[:, None], a[None])
    asym = m - m.transpose(0, 1).transpose(-1, -2)
    assert float(asym.abs().max() / m.abs().max()) < 1e-13


def _p1_block(d, zt, zs, at, as_, wall):
    """csrc/pair_radii.cu's condense() in numpy (its operations in its
    order, float64): the five scalars (A, S, P, Q, zz) of the pair's block
    expanded to 3 x 3."""
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    xy2 = dx * dx + dy * dy
    r2_raw = xy2 + dz * dz
    zero = ~(r2_raw > 0)
    r2 = np.where(zero, 1.0, r2_raw)
    invr = 1.0 / np.sqrt(r2)
    r = r2 * invr
    invr2 = invr * invr
    invr3 = invr2 * invr
    at2, as2 = at * at, as_ * as_
    s2 = at2 + as2
    inv_ab = 1.0 / (at * as_)
    c1_far = (1 + s2 * invr2 * (1 / 3)) * invr
    c2_far = (1 - s2 * invr2) * invr3
    dif = as_ - at
    dd2 = dif * dif
    q = dd2 + 3 * r2
    c1_mid = (0.5 * (at + as_) - q * q * invr3 / 32) * (4 / 3 * inv_ab)
    w = dd2 - r2
    c2_mid = w * w * invr3 * invr2 * (0.125 * inv_ab)
    c1_in = 4 / 3 * np.minimum(at, as_) * inv_ab
    far = ~zero & (r > at + as_)
    mid = ~zero & ~far & (r > np.abs(dif))
    c1 = np.where(far, c1_far, np.where(mid, c1_mid, c1_in))
    c2 = np.where(far, c2_far, np.where(mid, c2_mid, 0.0))
    A, S, P, Q, Z = c1, c2, c2 * dz, c2 * dz, c1 + c2 * dz * dz
    if wall:
        Rz = zt + zs
        W = 1 / np.sqrt(Rz * Rz + xy2)
        u = W * W
        W3 = W * u
        W5 = W3 * u
        W7 = W5 * u
        W9 = W7 * u
        Rz2, xy3 = Rz * Rz, zt * zs
        ca, cb = 2 / 3 * at2, 2 / 3 * as2
        cab = ca * as2
        t1c1 = (1 + s2 * u / 3) * W
        t1c2 = (1 - s2 * u) * W3
        Aw, Sw, Pw, Qw = -t1c1, -t1c2, t1c2 * Rz, -t1c2 * Rz
        Zw = t1c1 + t1c2 * Rz2
        Aw = Aw - 2 * xy3 * W3
        Sw = Sw + 6 * xy3 * W5
        p2 = 6 * xy3 * Rz * W5
        Pw = Pw - 2 * zt * W3 - p2
        Qw = Qw + 2 * zs * W3 + p2
        Zw = Zw + 2 * (xy3 * (W3 - 3 * Rz2 * W5) - W - Rz * (zt + zs) * W3)
        f5, f7 = 3 * W5, 15 * Rz2 * W7
        ga, gb = ca * zs, cb * zt
        Aw = Aw + (ga + gb) * 3 * Rz * W5
        Sw = Sw - (ga + gb) * 15 * Rz * W7
        Pw = Pw + ca * (f5 * Rz - zs * (f5 - f7)) - gb * (f5 - f7)
        Qw = Qw + ga * (f5 - f7) - cb * (f5 * Rz - zt * (f5 - f7))
        zz34 = -W3 + f5 * Rz2
        zzh = 9 * Rz * W5 - 15 * Rz2 * Rz * W7
        Zw = Zw + ca * (zz34 - zs * zzh) + cb * (zz34 - zt * zzh)
        Aw = Aw + cab * (W5 - 5 * Rz2 * W7)
        Sw = Sw - cab * (5 * W7 - 35 * Rz2 * W9)
        p5 = cab * Rz * (15 * W7 - 35 * Rz2 * W9)
        Pw = Pw + p5
        Qw = Qw - p5
        Zw = Zw + cab * (-3 * W5 + 30 * Rz2 * W7 - 35 * Rz2 * Rz2 * W9)
        A, S, P, Q, Z = A + Aw, S + Sw, P + Pw, Q + Qw, Z + Zw
    m = np.zeros(dx.shape + (3, 3))
    m[..., 0, 0] = A + S * dx * dx
    m[..., 1, 1] = A + S * dy * dy
    m[..., 0, 1] = m[..., 1, 0] = S * dx * dy
    m[..., 0, 2], m[..., 1, 2] = P * dx, P * dy
    m[..., 2, 0], m[..., 2, 1] = Q * dx, Q * dy
    m[..., 2, 2] = Z
    return m


@pytest.mark.parametrize("wall", [True, False])
def test_p1_condensed_block_is_the_plain_block(wall):
    """Kernel P1's condensing (the three RPY regimes as selects, the five
    wall terms folded into A, S, P, Q and zz) gives the plain blocks of
    every pair, self pairs and one blob inside another included."""
    r, rad, _ = _blobs(60, seed=4)
    r[:, 2] = np.maximum(r[:, 2], rad)
    d = r[:, None] - r[None]
    z = r[:, 2]
    ones = np.ones(d.shape[:2])
    got = _p1_block(d, z[:, None] * ones, z[None] * ones, rad[:, None] * ones,
                    rad[None] * ones, wall)
    dt, a, zt = torch.tensor(d), torch.tensor(rad), torch.tensor(z)
    ref = trpy.rpy_tt_radii(dt, a[:, None], a[None])
    if wall:
        ref = ref + trpy.wall_tt_radii(dt[..., 0], dt[..., 1],
                                       zt[:, None] + zt[None], zt[:, None],
                                       zt[None], a[:, None], a[None])
    assert _rel(got, ref) < 1e-13


def test_stacked_products_are_the_single_ones():
    """mobility_radii_multi over B = 3 (a pair and a single on the card)
    equals three single products, and the wrapper's plain version is the
    source-target product."""
    r, rad, _ = _blobs()
    rng = np.random.default_rng(9)
    v = torch.tensor(rng.normal(size=(3, r.shape[0], 3)))
    rt, at = torch.tensor(r), torch.tensor(rad)
    multi = tmob.mobility_radii_multi(rt, v, at, ETA)
    for b in range(3):
        assert torch.equal(multi[b], tmob.mobility_radii_trans_times_force(
            rt, v[b], at, ETA))
    with pytest.raises(NotImplementedError, match="item 4"):
        tmob.mobility_radii_multi(rt, v, at, ETA, domain="free_surface")
    with pytest.raises(NotImplementedError, match="item 4"):
        tmob.mobility_radii_multi(rt, v, at, ETA,
                                  periodic_length=(5.0, 5.0, 0.0))
    assert tmc.RADII_MAX_RHS == 2


def _r_blobs(js, jst):
    from rigidmultiblobswall_tpu.models import kinematics as jkin

    return jkin.blob_positions(js, jst)


def test_saddle_operator_and_pc_match_jax():
    js, jst, ts, tst = _bidisperse()
    n = jsad.saddle_size(js)
    x = np.random.default_rng(5).normal(size=n)
    jop = jsad.make_linear_operator(js, jst, m_dense=jsad.maybe_dense_mobility(
        js, _r_blobs(js, jst)))
    top = tsad.make_linear_operator(ts, tst, m_dense=tsad.maybe_dense_mobility(
        ts, tsad.kin.blob_positions(ts, tst)))
    assert _rel(top(torch.tensor(x)), jop(jnp.asarray(x))) < TOL
    jpc = jsad.build_block_diag_pc(js, jst)
    tpc = tsad.build_block_diag_pc(ts, tst)
    assert _rel(tpc.per_type[1].chol, jpc.per_type[1].chol) < TOL
    assert _rel(tsad.apply_block_diag_pc(ts, tpc, torch.tensor(x)),
                jsad.apply_block_diag_pc(js, jpc, jnp.asarray(x))) < TOL
    # the lockstep operator: the pair in one product
    X = np.random.default_rng(6).normal(size=(2, n))
    lock = tsad.make_lockstep_operator(ts, tst)(torch.tensor(X))
    for b in range(2):
        assert _rel(lock[b], jop(jnp.asarray(X[b]))) < TOL


def test_matrix_free_engine_never_materializes(monkeypatch):
    """With mixed radii the pairwise engine is matrix-free (kernel P1) even
    far below MATERIALIZE_BUDGET_BYTES: no dense builder runs, and a
    solve's products take the radii path."""
    js, jst, ts, tst = _bidisperse()
    calls = []

    def spy(*a, **k):
        calls.append(1)
        raise AssertionError("materialized with mixed radii")

    monkeypatch.setattr(tsad, "dense_mobility", spy)
    monkeypatch.setattr(tmc, "dense_tt", spy)
    assert tsad.maybe_dense_mobility(ts, tsad.kin.blob_positions(ts, tst)
                                     ) is None
    seen = []
    real = tmob.mobility_radii_multi
    monkeypatch.setattr(tmob, "mobility_radii_multi",
                        lambda *a, **k: seen.append(a[1].shape[0])
                        or real(*a, **k))
    sol = tsol.solve_mobility_problem(ts, tst)
    assert sol.converged and not calls and len(seen) > 1


def test_wall_spectral_refuses_radii_as_jax_does():
    js, jst, ts, tst = _bidisperse(domain="single_wall_spectral",
                                   periodic_length=(8.0, 8.0, 0.0),
                                   spectral_wall_height=3.0)
    with pytest.raises(NotImplementedError, match="WALL spectral"):
        jsad.maybe_dense_mobility(js, _r_blobs(js, jst))
    with pytest.raises(NotImplementedError, match="WALL spectral"):
        tsad.maybe_dense_mobility(ts, tsad.kin.blob_positions(ts, tst))


@pytest.mark.parametrize("domain", ["single_wall", "no_wall"])
def test_dense_blob_mobility_and_body_mobility_match_jax(domain):
    js, jst, ts, tst = _bidisperse(domain=domain)
    assert _rel(tsol.dense_blob_mobility(ts, tst),
                jsol.dense_blob_mobility(js, jst)) < TOL
    assert _rel(tsol.solve_body_mobility(ts, tst),
                jsol.solve_body_mobility(js, jst)) < TOL


def test_velocity_field_takes_per_blob_source_radii():
    js, jst, ts, tst = _bidisperse()
    rng = np.random.default_rng(8)
    lam = rng.normal(size=(js.num_blobs, 3))
    grid = rng.uniform(0, 4, (30, 3))
    ref = jfields.evaluate_velocity_field(js, jst, jnp.asarray(lam), grid,
                                          tracer_radius=0.05)
    got = tfields.evaluate_velocity_field(ts, tst, torch.tensor(lam), grid,
                                          tracer_radius=0.05)
    assert _rel(got, ref) < TOL
    # not the single-radius field
    uniform = tmob.source_target_matvec(
        tsad.kin.blob_positions(ts, tst), torch.tensor(grid),
        torch.tensor(lam), 0.131, 0.05, ts.eta)
    assert _rel(uniform, ref) > 1e-4


def _keys(n):
    return [jax.random.PRNGKey(200 + i) for i in range(n)]


@pytest.mark.parametrize("scheme, kT", [
    ("deterministic_forward_euler", 0.0), ("stochastic_Slip_Trapz", 0.05)])
def test_steps_match_jax(monkeypatch, scheme, kT):
    """Two steps of a 4-shell bidisperse scene (two radii), the JAX step's
    normals fed to the port: final positions to 1e-9 of the displacement,
    equal GMRES and Lanczos counts."""
    js, jst, ts, tst = _bidisperse(kT=kT)
    keys = _keys(2)
    if kT > 0:
        feed_jax_noise(monkeypatch, keys, scheme, js)
    jstep = jax.jit(jint.make_stepper(js, scheme, 2e-3,
                                      lanczos_tolerance=1e-10))
    jc = jint.init_carry(js, state=jst)
    s = jst
    for k in keys:
        s, jc, jaux = jstep(s, k, jc)
    tstep = tint.make_stepper(ts, scheme, 2e-3, lanczos_tolerance=1e-10)
    tc = tint.init_carry(ts, state=tst)
    t = tst
    gen = torch.Generator().manual_seed(0)
    for _ in keys:
        t, tc, taux = tstep(t, gen, tc)
    disp = np.abs(np.asarray(s.pos) - np.asarray(jst.pos)).max()
    assert disp > 1e-4
    np.testing.assert_allclose(to_np(t.pos), np.asarray(s.pos),
                               atol=1e-9 * disp, rtol=0)
    np.testing.assert_allclose(to_np(t.quat), np.asarray(s.quat), atol=1e-9,
                               rtol=0)
    assert taux.det_iterations == int(jaux.det_iterations)
    assert taux.stoch_iterations == int(jaux.stoch_iterations)
    assert taux.rejections == 0


def _write_radii_scene(d, scheme):
    """Two small and two big shells, each from a four-column .vertex
    file."""
    d.mkdir(parents=True, exist_ok=True)
    _vertex(d / "small.vertex", shell_vertices(12, 0.5), np.full(12, 0.131))
    _vertex(d / "big.vertex", shell_vertices(12, 0.6), np.full(12, 0.157))
    _clones(d / "small.clones", [[0.0, 0.0, 1.0], [3.2, 0.3, 1.1]])
    _clones(d / "big.clones", [[1.6, 0.2, 0.95], [4.8, 0.1, 1.05]])
    (d / "input.dat").write_text(
        f"scheme {scheme}\ndt 0.002\nn_steps 3\nn_save 3\neta 1.0\ng 0.1\n"
        "blob_radius 0.131\nkT 0.0\nsolver_tolerance 1e-12\n"
        "repulsion_strength_wall 0.2\ndebye_length_wall 0.2\n"
        "repulsion_strength 0.2\ndebye_length 0.2\n"
        "blob_blob_force_implementation python\nseed 1\noutput_name run\n"
        "structure small.vertex small.clones\n"
        "structure big.vertex big.clones\n")
    return d / "input.dat"


@pytest.mark.parametrize("scheme", ["deterministic_forward_euler",
                                    "mobility"])
def test_cli_runs_four_column_scenes_like_jax(tmp_path, monkeypatch, scheme):
    out = {}
    for name, main, argv in (("jax", jcli.main, []),
                             ("torch", tcli.main,
                              ["--f64", "--device", "cpu"])):
        inp = _write_radii_scene(tmp_path / name, scheme)
        monkeypatch.chdir(tmp_path / name)
        main(["--input-file", str(inp)] + argv)
        out[name] = tmp_path / name
    if scheme == "mobility":
        names = ("run.velocity.dat", "run.force.dat")
    else:
        names = ("run.small.00000003.clones", "run.big.00000003.clones")
    for fname in names:
        ref = np.loadtxt(out["jax"] / fname, skiprows=0 if scheme ==
                         "mobility" else 1)
        got = np.loadtxt(out["torch"] / fname, skiprows=0 if scheme ==
                         "mobility" else 1)
        np.testing.assert_allclose(got, ref, atol=1e-9 * np.abs(ref).max(),
                                   rtol=0)
