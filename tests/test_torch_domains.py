"""The in_plane and free_surface domains of the PyTorch port against the
JAX package, float64 on the CPU, on the same numpy inputs:

- the blocks (ops/rpy.py free_surface_tt, rpy_tt_in_plane,
  wall_tt_in_plane, the z-coupling mask) to 1e-13, and the in-plane
  identity the port's products rest on: JAX's masked blocks are P M P,
  P = diag(1, 1, 0), of the wall's blocks;
- the pair products (K1's plain version): in_plane tt and tr, and
  free_surface tt, open and with (L, L, 0) and (L, L, L) boxes, one and
  two right-hand sides, to 1e-12 of max|ref| against pairwise_matvec;
  the free surface's blocks are reciprocal, M(j, i) = M(i, j)^T (K1's and
  K3's symmetric sweeps rest on it), and its image at R = 0 is JAX's
  coincident pair;
- the dense builders against dense_mobility_tiled and _dense (the plain
  version of kernel K3's free-surface instance, and the wall K3 with its
  z rows and columns zeroed for in_plane);
- the saddle operator and the preconditioner, solve_mobility_problem on
  both domains (JAX's test_in_plane_domain_solvable case: v_z = 0), the
  wall-overlap rejection and the velocity field;
- forward Euler and Slip-Trapz steps on both engines against JAX's
  stepper, JAX's normals fed;
- the two CLI input files of chip_smoke.py phase 21f (a
  numba_free_surface implementation line; domain in_plane with tree
  blob-blob forces) through both CLIs.
The CUDA instances run only on the card (tests/test_torch_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rigidmultiblobswall_tpu import cli as jcli
from rigidmultiblobswall_tpu.models import fields as jfields
from rigidmultiblobswall_tpu.models import kinematics as jkin
from rigidmultiblobswall_tpu.models import saddle as jsad
from rigidmultiblobswall_tpu.models import solvers as jsol
from rigidmultiblobswall_tpu.ops import mobility as jmob
from rigidmultiblobswall_tpu.ops import rpy as jrpy
from rigidmultiblobswall_tpu_torch import cli as tcli
from rigidmultiblobswall_tpu_torch.models import fields as tfields
from rigidmultiblobswall_tpu_torch.models import kinematics as tkin
from rigidmultiblobswall_tpu_torch.models import saddle as tsad
from rigidmultiblobswall_tpu_torch.models import solvers as tsol
from rigidmultiblobswall_tpu_torch.ops import mobility as tmob
from rigidmultiblobswall_tpu_torch.ops import mobility_cuda as tmc
from rigidmultiblobswall_tpu_torch.ops import pair_kernels as tpk
from rigidmultiblobswall_tpu_torch.ops import rpy as trpy

from torch_parity import random_blobs, rel_err, shells_scene, to_np

A, ETA = 0.3, 0.9
DOMAIN_COUPLINGS = [("in_plane", "tt"), ("in_plane", "tr"),
                    ("free_surface", "tt")]
BOXES = [(0.0, 0.0, 0.0), (3.1, 2.7, 0.0), (3.1, 2.7, 3.4)]
BOX_IDS = ["open", "xy", "xyz"]


def _surface_blobs(n=31, seed=3):
    """random_blobs with blobs at z = 0 (one pair coincident on the plane,
    its image at R = 0), below a, and a coincident pair above."""
    r, v = random_blobs(n=n, seed=seed)
    r[4, 2] = 0.0
    r[5] = r[4]
    r[7] = r[6]
    r[8, 2] = 0.2
    return r, v


def _geometry(r, shift):
    q = np.array(r)
    if shift:
        q[:, 2] = np.maximum(q[:, 2], A)
    q /= A
    d = q[:, None, :] - q[None, :, :]
    return d, q[:, 2][:, None], q[:, 2][None, :], np.eye(len(q), dtype=bool)


def test_blocks_match_jax():
    r, _ = _surface_blobs()
    d, zt, zs, eye = _geometry(r, shift=False)
    rz = zt + zs
    ref = jrpy.free_surface_tt(jnp.asarray(d), jnp.asarray(rz),
                               jnp.asarray(eye))
    got = trpy.free_surface_tt(torch.as_tensor(d), torch.as_tensor(rz),
                               torch.as_tensor(eye))
    assert rel_err(got, ref) < 1e-13
    d, zt, zs, eye = _geometry(r, shift=True)
    hs = np.broadcast_to(zs, d.shape[:2])
    ref = jrpy.rpy_tt_in_plane(jnp.asarray(d), jnp.asarray(eye))
    got = trpy.rpy_tt_in_plane(torch.as_tensor(d), torch.as_tensor(eye))
    assert rel_err(got, ref) < 1e-13
    ref = jrpy.wall_tt_in_plane(jnp.asarray(d[..., 0]), jnp.asarray(
        d[..., 1]), jnp.asarray(zt + zs), jnp.asarray(hs), jnp.asarray(eye))
    got = trpy.wall_tt_in_plane(torch.as_tensor(d[..., 0]), torch.as_tensor(
        d[..., 1]), torch.as_tensor(zt + zs), torch.as_tensor(hs),
        torch.as_tensor(eye))
    assert rel_err(got, ref) < 1e-13
    assert np.array_equal(to_np(trpy.z_coupling_mask(torch.float64)),
                          np.asarray(jrpy._z_coupling_mask(jnp.float64)))


@pytest.mark.parametrize("coupling", ["tt", "tr"])
def test_in_plane_blocks_are_the_projected_wall_blocks(coupling):
    """JAX's in_plane block (its mask) equals P M_wall P, P = diag(1, 1,
    0): the port zeroes v_z before K1's wall instance and u_z after it."""
    r, _ = _surface_blobs()
    d, zt, zs, eye = _geometry(r, shift=True)
    ref = np.asarray(jmob._block(coupling, "in_plane", jnp.asarray(d),
                                 jnp.asarray(zt), jnp.asarray(zs),
                                 jnp.asarray(eye)))
    wall = tpk.block(coupling, torch.as_tensor(d), torch.as_tensor(zt),
                     torch.as_tensor(zs), torch.as_tensor(eye), "wall")
    P = torch.diag(torch.tensor([1.0, 1.0, 0.0], dtype=torch.float64))
    assert rel_err(P @ wall @ P, ref) < 1e-13
    got = tmob._block(coupling, "in_plane", torch.as_tensor(d),
                      torch.as_tensor(zt), torch.as_tensor(zs),
                      torch.as_tensor(eye))
    assert rel_err(got, ref) < 1e-13


def test_free_surface_blocks_are_reciprocal():
    """M(j, i) = M(i, j)^T with the image: K1's symmetric sweep and a
    pair's box sum apply one condensed block both ways."""
    r, _ = _surface_blobs()
    d, zt, zs, eye = _geometry(r, shift=False)
    m = to_np(tpk.block("tt", torch.as_tensor(d), torch.as_tensor(zt),
                        torch.as_tensor(zs), torch.as_tensor(eye),
                        "free_surface"))
    assert np.abs(m - m.transpose(1, 0, 3, 2)).max() < 1e-13 * np.abs(
        m).max()
    # both blobs on the plane, one above the other: the image at R = 0 is
    # the coincident pair, 0, so the block is the direct pair's alone
    assert np.allclose(m[4, 5], to_np(trpy.rpy_tt(
        torch.as_tensor(d[4:5, 5:6]), torch.zeros((1, 1), dtype=bool)))[0,
                                                                        0],
        rtol=0, atol=1e-15)


@pytest.mark.parametrize("L", BOXES, ids=BOX_IDS)
@pytest.mark.parametrize("domain, coupling", DOMAIN_COUPLINGS)
def test_products_match_jax(domain, coupling, L):
    r, _ = _surface_blobs()
    rng = np.random.default_rng(12)
    v = rng.normal(size=(2, r.shape[0], 3))
    ref = np.stack([np.asarray(jmob.pairwise_matvec(
        jnp.asarray(r), jnp.asarray(r), jnp.asarray(v[b]), ETA, A,
        coupling=coupling, domain=domain, periodic_length=L,
        method="generic")) for b in range(2)])
    got = tmob.pairwise_matvec_multi(torch.as_tensor(r), None,
                                     torch.as_tensor(v), ETA, A,
                                     coupling=coupling, domain=domain,
                                     periodic_length=L)
    assert rel_err(got, ref) < 1e-12
    if domain == "in_plane":
        assert not to_np(got)[..., 2].any()
    # targets other than the sources (K1's sliced sweep on the card)
    tgt, _ = random_blobs(n=9, seed=5)
    ref = np.asarray(jmob.pairwise_matvec(
        jnp.asarray(r), jnp.asarray(tgt), jnp.asarray(v[0]), ETA, A,
        coupling=coupling, domain=domain, periodic_length=L,
        self_interaction=False, method="generic"))
    got = tmob.pairwise_matvec(torch.as_tensor(r), torch.as_tensor(tgt),
                               torch.as_tensor(v[0]), ETA, A,
                               coupling=coupling, domain=domain,
                               periodic_length=L, self_interaction=False)
    assert rel_err(got, ref) < 1e-12


def test_domains_refuse_what_jax_refuses():
    r = torch.zeros((2, 3), dtype=torch.float64)
    for coupling, domain in (("rr", "in_plane"), ("rt", "in_plane"),
                             ("tr", "free_surface"),
                             ("rr", "free_surface")):
        with pytest.raises(NotImplementedError, match=domain):
            tmob.pairwise_matvec(r, None, r, 1.0, 1.0, coupling=coupling,
                                 domain=domain)
    for domain in ("in_plane", "free_surface"):
        with pytest.raises(NotImplementedError):
            tmob.grand_mobility_matvec(r, r, r, 1.0, 1.0, domain=domain)
    with pytest.raises(NotImplementedError, match="in_plane"):
        tmob.dense_mobility_radii(r, torch.ones(2, dtype=torch.float64),
                                  1.0, domain="in_plane")


@pytest.mark.parametrize("L", BOXES[:2], ids=BOX_IDS[:2])
@pytest.mark.parametrize("domain", ["in_plane", "free_surface"])
def test_dense_builders_match_jax(domain, L):
    r, _ = _surface_blobs(n=23, seed=8)
    n = r.shape[0]
    planes = np.asarray(jmob.dense_mobility_tiled(
        jnp.asarray(r), ETA, A, domain=domain, periodic_length=L))
    ref = planes.transpose(2, 0, 3, 1).reshape(3 * n, 3 * n)
    got = tmob.dense_mobility_tiled(torch.as_tensor(r), ETA, A,
                                    domain=domain, periodic_length=L)
    assert rel_err(got, ref) < 1e-12
    # K3's plain version in the domain's mode, and the saddle's engine
    # (in_plane: the wall matrix with its z rows and columns zeroed)
    ts = shells_scene(2, domain=domain, periodic_length=L, eta=ETA,
                      blob_radius=A)[2]
    engine = tsad.dense_mobility(ts, torch.as_tensor(r))
    assert rel_err(engine, ref) < 1e-12
    if domain == "free_surface":
        k3 = tmc.dense_tt_plain(torch.as_tensor(r), ETA, A,
                                mode="free_surface", periodic_length=L)
        assert rel_err(k3, ref) < 1e-12
    if L == BOXES[0]:
        ref = np.asarray(jmob.dense_mobility(jnp.asarray(r), ETA, A,
                                             domain=domain))
        got = tmob.dense_mobility(torch.as_tensor(np.stack([r, r])), ETA, A,
                                  domain=domain)
        assert rel_err(got[1], ref) < 1e-12


@pytest.mark.parametrize("engine", ["dense", "free"])
@pytest.mark.parametrize("domain", ["in_plane", "free_surface"])
def test_saddle_and_solve_match_jax(monkeypatch, domain, engine):
    """The block-diagonal PC (in_plane on the single-wall blocks), the
    saddle operator and solve_mobility_problem on three shells, each
    engine; in_plane's body velocities have v_z = 0."""
    js, jst, ts, tst, _, _ = shells_scene(3, seed=4, domain=domain)
    if engine == "free":
        monkeypatch.setattr(jsad, "MATERIALIZE_BUDGET_BYTES", 0)
        monkeypatch.setattr(tsad, "MATERIALIZE_BUDGET_BYTES", 0)
    jpc = jsad.build_block_diag_pc(js, jst)
    tpc = tsad.build_block_diag_pc(ts, tst)
    assert rel_err(tpc.per_type[0].m_inv, jpc.per_type[0].m_inv) < 1e-10
    jsoln = jsol.solve_mobility_problem(js, jst)
    tsoln = tsol.solve_mobility_problem(ts, tst)
    assert rel_err(tsoln.velocities, jsoln.velocities) < 1e-9
    if domain == "in_plane":
        assert np.abs(to_np(tsoln.velocities)[:, 2]).max() < 1e-12


def test_in_plane_domain_solvable():
    """The JAX package's tests/test_saddle.py case: two shells on
    in_plane, a finite solve with v_z ~ 0, equal to JAX's."""
    from rigidmultiblobswall_tpu.models.system import (BodyType, System,
                                                       make_state)
    from rigidmultiblobswall_tpu_torch.models import system as tsys

    from torch_parity import shell_vertices

    rng = np.random.default_rng(8)
    t = BodyType(name="shell", ref_config=shell_vertices(12, 0.5), count=2)
    js = System(types=(t,), eta=1.0, blob_radius=0.15, domain="in_plane",
                g=1.0, solver_tolerance=1e-12)
    pos = rng.uniform(-2, 2, (2, 3))
    pos[:, 2] = rng.uniform(1.0, 2.5, 2)
    quat = rng.normal(size=(2, 4))
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    ref = np.asarray(jsol.solve_mobility_problem(
        js, make_state(pos, quat)).velocities)
    ts, tst = tsys.from_reference(js, pos, quat, device="cpu")
    v = to_np(tsol.solve_mobility_problem(ts, tst).velocities)
    assert np.all(np.isfinite(v))
    assert np.allclose(v[:, 2], 0.0, atol=1e-7)
    # gravity lies along the projected axis: both solves give v ~ 1e-12,
    # equal to the solver's tolerance
    assert np.abs(v - ref).max() < 1e-12


@pytest.mark.parametrize("domain", ["in_plane", "free_surface"])
def test_rejection_and_velocity_field_match_jax(domain):
    """The wall-overlap rejection (both domains keep blobs above z = 0)
    and the velocity field (in_plane: the wall's image system, as the
    JAX package's fields.py takes it; free_surface: unbounded)."""
    js, jst, ts, tst, pos, quat = shells_scene(2, seed=6, domain=domain)
    assert tkin.valid_configuration(ts, tst) == bool(
        jkin.valid_configuration(js, jst))
    low = pos.copy()
    low[0, 2] = 0.3
    from rigidmultiblobswall_tpu.models.system import make_state
    from rigidmultiblobswall_tpu_torch.models.system import \
        make_state as tmake
    jlow = make_state(low, quat)
    tlow = tmake(low, quat, device="cpu")
    assert not tkin.valid_configuration(ts, tlow)
    assert bool(jkin.valid_configuration(js, jlow)) is False
    rng = np.random.default_rng(2)
    lam = rng.normal(size=(js.num_blobs, 3))
    grid = rng.uniform(0, 3, (10, 3))
    ref = np.asarray(jfields.evaluate_velocity_field(js, jst, lam, grid))
    got = tfields.evaluate_velocity_field(ts, tst, torch.as_tensor(lam),
                                          grid)
    assert rel_err(got, ref) < 1e-12


STEP_TOL = 1e-9


# in_plane's Slip-Trapz at kT = 0: with noise, its random finite
# difference puts a slip with z components on blobs whose mobility has no
# z rows, the saddle system is inconsistent, and GMRES runs to its cap in
# both packages (their iterates then differ at the solver's rounding)
@pytest.mark.parametrize("engine", ["dense", "free"])
@pytest.mark.parametrize("domain, scheme, kT", [
    ("in_plane", "deterministic_forward_euler", 0.0),
    ("in_plane", "stochastic_Slip_Trapz", 0.0),
    ("free_surface", "deterministic_forward_euler", 0.0),
    ("free_surface", "stochastic_Slip_Trapz", 0.05)])
def test_steps_match_jax(monkeypatch, domain, scheme, kT, engine):
    """Two steps of forward Euler and Slip-Trapz on three shells, each
    engine, JAX's normals fed: positions to 1e-9 of the displacement,
    equal GMRES counts; in_plane bodies keep their heights."""
    from rigidmultiblobswall_tpu.models import integrators as jint
    from rigidmultiblobswall_tpu_torch.models import integrators as tint

    from torch_parity import feed_jax_noise

    js, jst, ts, tst, _, _ = shells_scene(3, seed=5, kT=kT, domain=domain)
    if engine == "free":
        monkeypatch.setattr(jsad, "MATERIALIZE_BUDGET_BYTES", 0)
        monkeypatch.setattr(tsad, "MATERIALIZE_BUDGET_BYTES", 0)
    keys = [jax.random.PRNGKey(400 + i) for i in range(2)]
    if kT > 0:
        feed_jax_noise(monkeypatch, keys, scheme, js)
    jstep = jax.jit(jint.make_stepper(js, scheme, 2e-3,
                                      lanczos_tolerance=1e-10))
    jc, s = jint.init_carry(js, state=jst), jst
    for k in keys:
        s, jc, jaux = jstep(s, k, jc)
    tstep = tint.make_stepper(ts, scheme, 2e-3, lanczos_tolerance=1e-10)
    tc, t = tint.init_carry(ts, state=tst), tst
    gen = torch.Generator().manual_seed(0)
    for _ in keys:
        t, tc, taux = tstep(t, gen, tc)
    disp = np.abs(np.asarray(s.pos) - np.asarray(jst.pos)).max()
    assert disp > 1e-6
    np.testing.assert_allclose(to_np(t.pos), np.asarray(s.pos),
                               atol=STEP_TOL * disp, rtol=0)
    np.testing.assert_allclose(to_np(t.quat), np.asarray(s.quat),
                               atol=STEP_TOL, rtol=0)
    assert taux.det_iterations == int(jaux.det_iterations)
    if domain == "in_plane":
        np.testing.assert_allclose(to_np(t.pos)[:, 2], to_np(tst.pos)[:, 2],
                                   atol=1e-12, rtol=0)


def test_in_plane_slip_trapz_noise_runs_to_the_cap_as_in_jax(monkeypatch):
    """in_plane's Slip-Trapz at kT > 0, JAX's normals fed: the random
    finite difference slips blobs along z, where the projected mobility
    has no rows, so the saddle system is inconsistent and GMRES runs to
    its cap in both packages (chip_smoke.py phase 21 logs such runs NOT
    CONVERGED): the same iteration count, neither converged."""
    from rigidmultiblobswall_tpu.models import integrators as jint
    from rigidmultiblobswall_tpu_torch.models import integrators as tint

    from torch_parity import feed_jax_noise

    js, jst, ts, tst, _, _ = shells_scene(3, seed=5, kT=0.05,
                                          domain="in_plane",
                                          solver_tolerance=1e-8)
    key = jax.random.PRNGKey(400)
    feed_jax_noise(monkeypatch, [key], "stochastic_Slip_Trapz", js)
    jstep = jax.jit(jint.make_stepper(js, "stochastic_Slip_Trapz", 2e-3,
                                      lanczos_tolerance=1e-10))
    _, _, jaux = jstep(jst, key, jint.init_carry(js, state=jst))
    tstep = tint.make_stepper(ts, "stochastic_Slip_Trapz", 2e-3,
                              lanczos_tolerance=1e-10)
    _, _, taux = tstep(tst, torch.Generator().manual_seed(0),
                       tint.init_carry(ts, state=tst))
    assert taux.det_iterations == int(jaux.det_iterations)
    assert not taux.solves_converged and not bool(jaux.solves_converged)


def test_free_surface_box_sum_is_indefinite_as_in_jax():
    """The free surface's blob mobility summed over the 3 x 3 boxes of an
    (L, L, 0) box at chip_smoke.py's lattice packing (4 x 4 x 4 twelve-blob
    shells at spacing 1.6 from height 2 in a (6.4, 6.4, 0) box): the
    port's equals JAX's dense_mobility_tiled to 1e-12, and both have
    negative eigenvalues (each image's in-plane far field adds to the
    blob's own, a 1/r sum cut at the boxes), while the wall's in the same
    box and the open free surface's are positive definite. So the saddle
    solves of the free surface in such a box stop at GMRES's cap in both
    packages (chip_smoke.py phase 21 logs them NOT CONVERGED)."""
    from rigidmultiblobswall_tpu.models import system as jsys
    from rigidmultiblobswall_tpu_torch.models import system as tsys

    from torch_parity import shell_vertices

    idx = np.arange(64)
    pos = np.stack([(idx % 4) * 1.6, (idx // 4 % 4) * 1.6,
                    2.0 + idx // 16 * 1.6], axis=1)
    quat = np.random.default_rng(21).normal(size=(64, 4))
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    t = jsys.BodyType(name="shell12", ref_config=shell_vertices(), count=64)
    js = jsys.System(types=(t,), eta=1.0, blob_radius=0.131,
                     domain="free_surface")
    ts, tst = tsys.from_reference(js, pos, quat, device="cpu")
    r = tkin.blob_positions(ts, tst)
    box = (6.4, 6.4, 0.0)
    n3 = 3 * r.shape[0]

    def smallest(m):
        m = torch.as_tensor(np.asarray(m))
        return float(torch.linalg.eigvalsh(0.5 * (m + m.T))[0])

    planes = np.asarray(jmob.dense_mobility_tiled(
        jnp.asarray(to_np(r)), 1.0, 0.131, domain="free_surface",
        periodic_length=box))
    ref = planes.transpose(2, 0, 3, 1).reshape(n3, n3)
    got = tmob.dense_mobility_tiled(r, 1.0, 0.131, domain="free_surface",
                                    periodic_length=box)
    assert rel_err(got, ref) < 1e-12
    assert smallest(ref) < 0 and smallest(got) < 0
    for domain, L in (("single_wall", box),
                      ("free_surface", (0.0, 0.0, 0.0))):
        m = tmob.dense_mobility_tiled(r, 1.0, 0.131, domain=domain,
                                      periodic_length=L)
        assert smallest(m) > 0


@pytest.mark.parametrize("domain", ["in_plane", "free_surface"])
def test_steps_in_a_box_match_jax(domain):
    """Two forward Euler steps of three shells in an (L, L, 0) box on the
    matrix-free engine (K1's image instances on the card): positions to
    1e-9 of the displacement and the GMRES counts JAX's (the free
    surface's box sums converge more slowly than the wall's, in both)."""
    from rigidmultiblobswall_tpu.models import integrators as jint
    from rigidmultiblobswall_tpu_torch.models import integrators as tint

    js, jst, ts, tst, _, _ = shells_scene(3, seed=9, domain=domain,
                                          periodic_length=(4.1, 4.1, 0.0))
    jstep = jax.jit(jint.make_stepper(js, "deterministic_forward_euler",
                                      2e-3))
    jc, s = jint.init_carry(js, state=jst), jst
    tstep = tint.make_stepper(ts, "deterministic_forward_euler", 2e-3)
    tc, t = tint.init_carry(ts, state=tst), tst
    gen = torch.Generator().manual_seed(0)
    for k in range(2):
        s, jc, jaux = jstep(s, jax.random.PRNGKey(k), jc)
        t, tc, taux = tstep(t, gen, tc)
        assert taux.det_iterations == int(jaux.det_iterations)
    disp = np.abs(np.asarray(s.pos) - np.asarray(jst.pos)).max()
    assert disp > 1e-6
    np.testing.assert_allclose(to_np(t.pos), np.asarray(s.pos),
                               atol=1e-9 * disp, rtol=0)


def _cli_both(tmp_path, monkeypatch, replace, scheme="stochastic_Slip_Trapz",
              n_bodies=4, kT=0.0):
    from test_torch_cli import _write_scene

    out = {}
    for name, main, argv in (("jax", jcli.main, []),
                             ("torch", tcli.main,
                              ["--f64", "--device", "cpu"])):
        d = tmp_path / name
        inp = _write_scene(d, scheme, n_bodies=n_bodies, kT=kT)
        text = inp.read_text()
        for a, b in replace:
            assert a in text
            text = text.replace(a, b)
        inp.write_text(text)
        monkeypatch.chdir(d)
        main(["--input-file", str(inp)] + argv)
        out[name] = d
    return out


# (scheme, replacements) of chip_smoke.py phase 21f's two input files;
# in_plane steps by forward Euler there (Slip-Trapz's random finite
# difference runs its solve to GMRES's cap in both packages)
CLI_CASES = {
    "free_surface": ("stochastic_Slip_Trapz", [(
        "blob_blob_force_implementation python",
        "blob_blob_force_implementation python\n"
        "mobility_vector_prod_implementation numba_free_surface")]),
    "in_plane_tree": ("deterministic_forward_euler", [(
        "blob_blob_force_implementation python",
        "blob_blob_force_implementation tree\ndomain in_plane")]),
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_inputs_match_jax(tmp_path, monkeypatch, case):
    """chip_smoke.py phase 21f's two input files at four shells through
    both CLIs: the same final .clones (1e-10 of the displacement)."""
    from test_torch_cli import N_STEPS, _clones

    scheme, replace = CLI_CASES[case]
    out = _cli_both(tmp_path, monkeypatch, replace, scheme=scheme)
    final = "run.shell.%08d.clones" % N_STEPS
    ref = _clones(out["jax"] / final)
    got = _clones(out["torch"] / final)
    start = _clones(out["torch"] / "run.shell.00000000.clones")
    disp = np.abs(ref[:, :3] - start[:, :3]).max()
    assert disp > 1e-5
    np.testing.assert_allclose(got, ref, atol=1e-10 * max(disp, 1.0),
                               rtol=0)
    if case == "in_plane_tree":
        np.testing.assert_allclose(got[:, 2], start[:, 2], atol=1e-12,
                                   rtol=0)
