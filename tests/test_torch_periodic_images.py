"""Pseudo-periodic image boxes of the direct engine (the PyTorch port's
single_wall and no_wall domains with a periodic_length) against the JAX
package, float64 on the CPU, on the same numpy inputs:

- the tt, tr, rt, rr and grand products (K1's plain version with boxes)
  with (L, L, 0) on both domains and (L, L, L) on no_wall, to 1e-12
  relative; a product onto other targets (K1's sliced sweep);
- the materialized matrix (K3's plain version) against JAX's component
  planes, and the brute-force oracle of the JAX package's
  tests/test_mobility.py;
- the premise of K1's symmetric image sweep (the box sum is reciprocal,
  so a pair's box sum, or each box's block, applied both ways gives the
  product), emulated in numpy;
- the multibody steppers on both engines, the rollers and lubrication
  steps, an MCMC chain and the small-box force fallback.
The CUDA instances run only on the card (tests/test_torch_cuda.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rigidmultiblobswall_tpu.ops import mobility as jmob
from rigidmultiblobswall_tpu_torch.ops import mobility as tmob
from rigidmultiblobswall_tpu_torch.ops import mobility_cuda as tmc
from rigidmultiblobswall_tpu_torch.ops import pair_kernels as tpk

from torch_parity import random_blobs, rel_err, shells_scene, to_np

A, ETA = 0.3, 0.9
# (domain, periodic_length): the quasi-2D box above the wall, the same box
# without the wall, and a box periodic on all three axes (27 boxes)
BOXES = [("single_wall", (3.1, 2.7, 0.0)), ("no_wall", (3.1, 2.7, 0.0)),
         ("no_wall", (3.1, 2.7, 3.4))]
BOX_IDS = ["wall-xy", "open-xy", "open-xyz"]


def _jax_product(coupling, r, tgt, v, domain, L, self_interaction=True):
    return np.asarray(jmob.pairwise_matvec(
        jnp.asarray(r), jnp.asarray(tgt), jnp.asarray(v), ETA, A,
        coupling=coupling, domain=domain, periodic_length=L,
        self_interaction=self_interaction, method="generic"))


@pytest.mark.parametrize("domain, L", BOXES, ids=BOX_IDS)
@pytest.mark.parametrize("coupling", ["tt", "tr", "rt", "rr"])
def test_products_match_jax(coupling, domain, L):
    """The square product of each coupling, one and two right-hand sides
    (the pair runs as one stacked call)."""
    r, _ = random_blobs(n=29, seed=11)
    rng = np.random.default_rng(12)
    v = rng.normal(size=(2, r.shape[0], 3))
    ref = np.stack([_jax_product(coupling, r, r, v[b], domain, L)
                    for b in range(2)])
    rt = torch.as_tensor(r)
    got = tmob.pairwise_matvec_multi(rt, None, torch.as_tensor(v), ETA, A,
                                     coupling=coupling, domain=domain,
                                     periodic_length=L)
    assert rel_err(got, ref) < 1e-12
    single = tmob.pairwise_matvec(rt, None, torch.as_tensor(v[0]), ETA, A,
                                  coupling=coupling, domain=domain,
                                  periodic_length=L)
    assert rel_err(single, ref[0]) < 1e-12
    # the images change the product
    open_ = _jax_product(coupling, r, r, v[0], domain, (0.0, 0.0, 0.0))
    assert rel_err(single, open_) > 1e-3


@pytest.mark.parametrize("domain, L", BOXES, ids=BOX_IDS)
def test_grand_product_matches_jax(domain, L):
    r, _ = random_blobs(n=23, seed=13)
    rng = np.random.default_rng(14)
    f, t = rng.normal(size=(2, r.shape[0], 3))
    u_ref, w_ref = jmob.grand_mobility_matvec(
        jnp.asarray(r), jnp.asarray(f), jnp.asarray(t), ETA, A,
        domain=domain, periodic_length=L)
    u, w = tmob.grand_mobility_matvec(
        torch.as_tensor(r), torch.as_tensor(f), torch.as_tensor(t), ETA, A,
        domain=domain, periodic_length=L)
    assert rel_err(u, np.asarray(u_ref)) < 1e-12
    assert rel_err(w, np.asarray(w_ref)) < 1e-12


@pytest.mark.parametrize("domain, L", BOXES, ids=BOX_IDS)
def test_other_targets_match_jax(domain, L):
    """Targets other than the sources (self_interaction off: K1's sliced
    sweep on the card), targets outside the home box included."""
    r, v = random_blobs(n=31, seed=4)
    tgt, _ = random_blobs(n=13, seed=5)
    tgt[:4, :2] += np.array([7.0, -5.0])
    ref = _jax_product("tt", r, tgt, v, domain, L, self_interaction=False)
    got = tmob.pairwise_matvec(torch.as_tensor(r), torch.as_tensor(tgt),
                               torch.as_tensor(v), ETA, A, domain=domain,
                               periodic_length=L, self_interaction=False)
    assert rel_err(got, ref) < 1e-12


@pytest.mark.parametrize("domain, L", BOXES, ids=BOX_IDS)
def test_dense_matrix_matches_jax(domain, L):
    """K3's plain version with images against JAX's component planes
    (JAX tests/test_materialized.py:29-33): M[3i+a, 3j+b] = planes[a, b,
    i, j]; symmetric, so K4's upper-triangle product holds; its product
    is the matrix-free one."""
    r, v = random_blobs(n=17, seed=6)
    planes = np.asarray(jmob.dense_mobility_tiled(
        jnp.asarray(r), ETA, A, domain=domain, periodic_length=L))
    ref = planes.transpose(2, 0, 3, 1).reshape(3 * len(r), 3 * len(r))
    rt = torch.as_tensor(r)
    got = tmc.dense_tt(rt, ETA, A,
                       mode=tmob.DOMAIN_MODE[domain],
                       periodic_length=L)
    assert rel_err(got, ref) < 1e-12
    assert rel_err(got, ref.T) < 1e-12
    u = tmc.symm_matvec(got, torch.as_tensor(v))
    u_free = tmob.mobility_trans_times_force(rt, torch.as_tensor(v), ETA, A,
                                             domain=domain,
                                             periodic_length=L)
    assert rel_err(u, to_np(u_free)) < 1e-12


def test_periodic_minimum_image_brute_force():
    """The JAX package's brute-force oracle (tests/test_mobility.py:168-200):
    min-image + neighbor box sweep of the no-wall tt kernel in numpy."""
    L = np.array([5.0, 4.0, 0.0])
    rng = np.random.default_rng(14)
    n = 6
    r = rng.uniform(0, 4, (n, 3))
    v = rng.normal(size=(n, 3))
    u = tmob.mobility_trans_times_force(
        torch.as_tensor(r), torch.as_tensor(v), ETA, A, domain="no_wall",
        periodic_length=tuple(L))

    def rpy_block(d):
        r2 = d @ d
        if r2 == 0:
            return (4.0 / 3.0) * np.eye(3)
        rr = np.sqrt(r2)
        if rr > 2:
            c1 = (1 + 2 / (3 * r2)) / rr
            c2 = (1 - 2 / r2) / r2 / rr
        else:
            c1 = (4 / 3) * (1 - 9 * rr / 32)
            c2 = (4 / 3) * (3 / 32) / rr
        return c1 * np.eye(3) + c2 * np.outer(d, d)

    expected = np.zeros((n, 3))
    boxes = [(bx, by, 0) for bx in (-1, 0, 1) for by in (-1, 0, 1)]
    for i in range(n):
        for j in range(n):
            dphys = r[i] - r[j]
            for axis in range(3):
                if L[axis] > 0:
                    c = dphys[axis]
                    dphys[axis] = c - np.trunc(
                        c / L[axis] + 0.5 * np.sign(c)) * L[axis]
            for box in boxes:
                if i == j and box == (0, 0, 0):
                    M = rpy_block(np.zeros(3))
                else:
                    M = rpy_block((dphys + np.array(box) * L) / A)
                expected[i] += M @ v[j] / (8 * np.pi * ETA * A)
    assert rel_err(u, expected) < 1e-12


def _box_sum(coupling, d, zt, zs, L, offsets, wall):
    """sum over the boxes of the block at min_image(d) + b L (one pair,
    no self pair), float64 (3, 3) or (6, 6)."""
    d0 = tpk.min_image(torch.as_tensor(d)[None], L)
    zt_ = torch.tensor([[zt]], dtype=torch.float64)
    zs_ = torch.tensor([[zs]], dtype=torch.float64)
    no = torch.zeros((1, 1), dtype=torch.bool)
    m = 0
    for box in offsets:
        db = d0 + torch.tensor(box, dtype=torch.float64) * torch.tensor(
            L, dtype=torch.float64)
        m = m + tpk.block(coupling, db[:, None, :], zt_, zs_, no,
                          tpk.wall_mode(wall))[0, 0]
    return m.numpy()


@pytest.mark.parametrize("coupling", ["tt", "rr", "grand", "tr"])
@pytest.mark.parametrize("domain, L", BOXES, ids=BOX_IDS)
def test_box_sum_is_reciprocal(coupling, domain, L):
    """The premise of K1's symmetric image sweep: with d = q_i - q_j,
    sum_b M(d + bL; z_i, z_j) = (sum_b M(-d + bL; z_j, z_i))^T (tr's
    transpose is rt's block of the pair), since min_image is odd in d and
    the box list is symmetric; per box the wall tt block is not
    symmetric."""
    wall = domain == "single_wall"
    Ln = tuple(x / A for x in L)
    offsets = tpk.box_offsets(L)
    rng = np.random.default_rng(21)
    other = {"tr": "rt"}.get(coupling, coupling)
    for _ in range(5):
        d = rng.uniform(-12, 12, 3)
        zi, zj = rng.uniform(1.0, 9.0, 2)
        if wall:
            d[2] = zi - zj
        fwd = _box_sum(coupling, d, zi, zj, Ln, offsets, wall)
        back = _box_sum(other, -d, zj, zi, Ln, offsets, wall)
        assert np.abs(fwd - back.T).max() < 1e-13 * np.abs(fwd).max()
    if wall:
        m = tpk.block("tt", torch.tensor([[[0.7, -0.4, 0.5]]]),
                      torch.tensor([[3.0]]), torch.tensor([[2.5]]),
                      torch.zeros((1, 1), dtype=torch.bool), "wall")[0, 0]
        assert (m - m.T).abs().max() > 1e-4


@pytest.mark.parametrize("coupling", ["tt", "tr", "rt", "rr", "grand"])
@pytest.mark.parametrize("domain, L", BOXES, ids=BOX_IDS)
def test_symmetric_image_sweep_emulated(coupling, domain, L):
    """K1's symmetric image sweep in numpy (csrc/pair_blocks.cuh sym_kernel
    with ImageBoxes): each unordered pair i < j condenses the block M(d +
    bL; z_i, z_j) of each box once; tt and rr sum the pair's boxes into
    one block M (BlockSum) and add M v_j to i and M^T v_i to j, the others
    add each box's M v_j to i and the pair's other block transposed (grand:
    M^T; tr: M_rt^T; rt: M_tr^T) to j; the diagonal runs every box
    directed, the self block in the home box only. It equals the plain
    product at 1e-12."""
    wall = domain == "single_wall"
    r, _ = random_blobs(n=11, seed=15)
    q, _ = tmob._normalized(torch.as_tensor(r), A, wall, torch.float64)
    nc = tpk.NCOMP[coupling]
    rng = np.random.default_rng(16)
    v = torch.as_tensor(rng.normal(size=(len(r), nc)))
    boxes = tpk.image_boxes(L, A)
    Ln, offsets = boxes
    other = {"tr": "rt", "rt": "tr"}.get(coupling, coupling)
    d0 = tpk.min_image(q[:, None, :] - q[None, :, :], Ln)
    Lt = torch.tensor(Ln, dtype=torch.float64)
    out = torch.zeros((len(r), nc), dtype=torch.float64)
    no = torch.zeros((1, 1), dtype=torch.bool)
    for i in range(len(r)):
        zi = q[i, 2].reshape(1, 1)
        for j in range(i, len(r)):
            zj = q[j, 2].reshape(1, 1)
            block_sum = 0
            for box in offsets:
                d = (d0[i, j] + torch.tensor(box, dtype=torch.float64)
                     * Lt)[None, None]
                if i == j:
                    self_ = torch.full((1, 1), box == (0, 0, 0))
                    out[i] += tpk.block(coupling, d, zi, zi, self_,
                                        tpk.wall_mode(wall))[0, 0] @ v[i]
                    continue
                m = tpk.block(coupling, d, zi, zj, no,
                              tpk.wall_mode(wall))[0, 0]
                if coupling in ("tt", "rr"):
                    block_sum = block_sum + m
                    continue
                out[i] += m @ v[j]
                m_o = (m if other == coupling else
                       tpk.block(other, d, zi, zj, no, tpk.wall_mode(wall))[0,
                                                                            0])
                out[j] += m_o.T @ v[i]
            if i != j and coupling in ("tt", "rr"):
                out[i] += block_sum @ v[j]
                out[j] += block_sum.T @ v[i]
    ref = tpk.pair_plain(q, q, v, coupling=coupling, mode=tpk.wall_mode(wall),
                         self_interaction=True, boxes=boxes)
    assert rel_err(out, to_np(ref)) < 1e-12


# ---------------------------------------------------------------------------
# The paths that ride on the image boxes
# ---------------------------------------------------------------------------

STEP_TOL = 1e-9
L_SHELLS = 4.1


def _step_both(monkeypatch, scheme, engine, domain, L, kT, n_steps=2):
    """n_steps of `scheme` on three shells in the box L, JAX's stepper and
    the port's, JAX's normals fed; engine "dense" (the 3 shells' matrix
    fits the budget: K3/K4) or "free" (the budget at 0: K1)."""
    from rigidmultiblobswall_tpu.models import integrators as jint
    from rigidmultiblobswall_tpu.models import saddle as jsad
    from rigidmultiblobswall_tpu_torch.models import integrators as tint
    from rigidmultiblobswall_tpu_torch.models import saddle as tsad
    from torch_parity import feed_jax_noise

    js, jst, ts, tst, _, _ = shells_scene(3, seed=5, kT=kT, domain=domain,
                                          periodic_length=L)
    if engine == "free":
        monkeypatch.setattr(jsad, "MATERIALIZE_BUDGET_BYTES", 0)
        monkeypatch.setattr(tsad, "MATERIALIZE_BUDGET_BYTES", 0)
    r_t = tsad.maybe_dense_mobility(
        ts, torch.zeros((ts.num_blobs, 3), dtype=torch.float64) + 1.0)
    assert (r_t is None) == (engine == "free")
    keys = [jax.random.PRNGKey(300 + i) for i in range(n_steps)]
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
    return jst, s, jaux, t, taux


@pytest.mark.parametrize("engine", ["dense", "free"])
@pytest.mark.parametrize("scheme, kT", [
    ("deterministic_forward_euler", 0.0), ("stochastic_Slip_Trapz", 0.05)])
def test_multibody_steps_match_jax(monkeypatch, scheme, kT, engine):
    """Forward Euler and Slip-Trapz on three shells above the wall in an
    (L, L, 0) box, each engine: positions to 1e-9 of the displacement,
    orientations to 1e-9, equal GMRES counts."""
    jst, jfinal, jaux, tfinal, taux = _step_both(
        monkeypatch, scheme, engine, "single_wall", (L_SHELLS, L_SHELLS, 0.0),
        kT)
    disp = np.abs(np.asarray(jfinal.pos) - np.asarray(jst.pos)).max()
    assert disp > 1e-5
    np.testing.assert_allclose(to_np(tfinal.pos), np.asarray(jfinal.pos),
                               atol=STEP_TOL * disp, rtol=0)
    np.testing.assert_allclose(to_np(tfinal.quat), np.asarray(jfinal.quat),
                               atol=STEP_TOL, rtol=0)
    assert taux.det_iterations == int(jaux.det_iterations)
    assert taux.rejections == int(jaux.rejections) == 0


def test_fully_periodic_open_box_step_matches_jax(monkeypatch):
    """no_wall in an (L, L, L) box (27 image boxes, JAX
    tests/test_integrators.py:64-85's domain), forward Euler with gravity,
    the materialized engine."""
    L = (L_SHELLS,) * 3
    jst, jfinal, jaux, tfinal, taux = _step_both(
        monkeypatch, "deterministic_forward_euler", "dense", "no_wall", L,
        0.0)
    disp = np.abs(np.asarray(jfinal.pos) - np.asarray(jst.pos)).max()
    assert disp > 1e-5
    np.testing.assert_allclose(to_np(tfinal.pos), np.asarray(jfinal.pos),
                               atol=STEP_TOL * disp, rtol=0)


def test_system_accepts_boxes_on_the_direct_domains():
    """single_wall and no_wall take a periodic_length; per-blob radii with
    images, in_plane and linked cells in a partly periodic box (formerly
    refused, each naming its item) build as the JAX package builds them;
    in_plane with per-blob radii stays refused (the port differs from
    JAX there on purpose)."""
    from rigidmultiblobswall_tpu.models import system as jsys
    from rigidmultiblobswall_tpu_torch.models import system as tsys

    t = tsys.BodyType(name="s", ref_config=np.zeros((1, 3)), count=1)
    for dom, L in (("single_wall", (5.0, 5.0, 0.0)),
                   ("no_wall", (5.0, 5.0, 5.0)),
                   ("in_plane", (5.0, 5.0, 0.0)),
                   ("free_surface", (5.0, 5.0, 0.0))):
        assert tsys.System(types=(t,), domain=dom,
                           periodic_length=L).periodic_length == L
    mixed = tsys.BodyType(name="m", ref_config=np.zeros((2, 3)), count=1,
                          blob_radii=np.array([1.0, 1.5]))
    jmixed = jsys.BodyType(name="m", ref_config=np.zeros((2, 3)), count=1,
                           blob_radii=np.array([1.0, 1.5]))
    for dom in ("single_wall", "free_surface"):
        js = jsys.System(types=(jmixed,), domain=dom,
                         periodic_length=(5.0, 5.0, 0.0))
        ts = tsys.from_reference(js, device="cpu")
        assert ts.has_mixed_radii and ts.domain == dom
        assert ts.periodic_length == (5.0, 5.0, 0.0)
    js = jsys.System(types=(jsys.BodyType(
        name="s", ref_config=np.zeros((1, 3)), count=1),),
        periodic_length=(5.0, 5.0, 0.0),
        blob_blob_force_method="neighbor_list")
    assert tsys.from_reference(js, device="cpu").blob_blob_force_method == (
        "neighbor_list")
    with pytest.raises(NotImplementedError, match="in_plane"):
        tsys.System(types=(mixed,), domain="in_plane")


@pytest.mark.parametrize("scheme", ["stochastic_adams_bashforth_rollers",
                                    "deterministic_forward_euler_rollers"])
@pytest.mark.parametrize("domain, L", BOXES[:2], ids=BOX_IDS[:2])
def test_roller_steps_match_jax(monkeypatch, scheme, domain, L):
    """Rollers in an (L, L, 0) box (prescribed spin: the lockstep rr and tr
    products, grand in the Lanczos noise, rt in the RFD), JAX's normals
    fed: positions to 1e-9 of the displacement, equal counts."""
    from test_torch_rollers import _positions, _run_both, _suspensions

    jsus, tsus = _suspensions(domain=domain, periodic_length=L)
    assert tsus.periodic_length == L
    r0 = _positions(seed=2)
    jfinal, tfinal, iters = _run_both(jsus, tsus, scheme, r0, monkeypatch)
    disp = np.abs(jfinal - r0).max()
    assert disp > 1e-4
    np.testing.assert_allclose(tfinal, jfinal, atol=STEP_TOL * disp, rtol=0)
    for jit, tit in iters:
        assert tit == jit


def _lub_ft_calcs(L):
    """The JAX CLI's lubrication forces (cli.py:296-323) in the box L, and
    the port's make_ft_calc."""
    from rigidmultiblobswall_tpu.ops import forces as jforces
    from rigidmultiblobswall_tpu_torch.models import lubrication as tlub
    from test_torch_lubrication import FORCES

    def jft(pos):
        f = jforces.blob_external_forces(
            pos, g=FORCES["g"], blob_radius=1.0,
            repulsion_strength_wall=FORCES["repulsion_strength_wall"],
            debye_length_wall=FORCES["debye_length_wall"])
        f = f + jforces.blob_blob_forces(
            pos, repulsion_strength=FORCES["repulsion_strength"],
            debye_length=FORCES["debye_length"], blob_radius=1.0,
            periodic_length=L)
        return jnp.concatenate([f, jnp.zeros_like(f)], axis=1)

    return jft, tlub.make_ft_calc(a=1.0, periodic_length=L, **FORCES)


def test_lubrication_steps_match_jax(monkeypatch):
    """Lubrication in an (L, L, 0) box: three trapezoidal steps (omega,
    cut_torque) of 16 spheres whose lattice wraps across the box edges, so
    Delta_R's neighbor pairs, the jump check and the grand mobility take
    the minimum image and the image boxes; JAX's normals fed."""
    from rigidmultiblobswall_tpu.models import lubrication as jlub
    from rigidmultiblobswall_tpu_torch.models import lubrication as tlub
    from test_torch_lubrication import (_cluster, _feed, _solvers,
                                        _step_normals)

    L = (8.2, 8.3, 0.0)
    jsol, tsol = _solvers(16, max_neighbors=12, periodic_length=L)
    pos = _cluster(16, seed=9, spacing=2.1, z0=1.08)
    # the lattice spans 6.3: its last column sits 1.9 from the first
    # across the x edge, inside the lubrication cutoff
    keys = [jax.random.PRNGKey(400 + i) for i in range(3)]
    feed = _feed(monkeypatch, [z for k in keys for z in _step_normals(
        "trapezoidal", k, 16, jsol.kT)])
    jft, tft = _lub_ft_calcs(L)
    jstep = jax.jit(lambda p, q, k: jlub.step_trapezoidal(
        jsol, p, q, k, jft, omega=25.0, cut_torque=0.2))
    quat0 = np.tile([1.0, 0, 0, 0], (16, 1))
    jp, jq = jnp.asarray(pos), jnp.asarray(quat0)
    tp, tq = torch.as_tensor(pos), torch.as_tensor(quat0)
    for k in keys:
        jp, jq, ja = jstep(jp, jq, k)
        tp, tq, ta = tlub.step_trapezoidal(tsol, tp, tq, None, tft,
                                           omega=25.0, cut_torque=0.2)
        assert (ta.det_iterations, ta.stoch_iterations) == (
            int(ja.det_iterations), int(ja.stoch_iterations))
        assert int(ta.rejections_jump) == int(ja.rejections_jump) == 0
    assert next(feed, None) is None
    disp = np.abs(np.asarray(jp) - pos).max()
    assert disp > 1e-5
    np.testing.assert_allclose(to_np(tp), np.asarray(jp), atol=1e-9 * disp,
                               rtol=0)
    np.testing.assert_allclose(to_np(tq), np.asarray(jq), atol=1e-9, rtol=0)
    # the box changes Delta_R: a pair across the edge is in range
    open_ = tlub.compute_delta_r_blocks(
        dataclasses.replace(tsol, periodic_length=(0.0, 0.0, 0.0)),
        torch.as_tensor(pos))
    boxed = tlub.compute_delta_r_blocks(tsol, torch.as_tensor(pos))
    assert int(boxed.offdiag.abs().sum(dim=(2, 3)).gt(0).sum()) > int(
        open_.offdiag.abs().sum(dim=(2, 3)).gt(0).sum())


def test_lubrication_jump_check_takes_the_minimum_image():
    """A sphere that leaves the box on one side and comes back on the
    other has moved by its minimum image, not by L."""
    from rigidmultiblobswall_tpu_torch.models import lubrication as tlub

    _, tsol = __import__("test_torch_lubrication")._solvers(
        2, periodic_length=(6.0, 6.0, 0.0))
    old = torch.tensor([[0.1, 3.0, 1.2], [3.0, 3.0, 1.2]],
                       dtype=torch.float64)
    new = old.clone()
    new[0, 0] = 5.95
    wall_bad, jump_bad = tlub._check_jump(tsol, new, old)
    assert not bool(wall_bad) and not bool(jump_bad)
    _, open_sol = __import__("test_torch_lubrication")._solvers(2)
    assert bool(tlub._check_jump(open_sol, new, old)[1])


def test_mcmc_chain_matches_jax():
    """A 20-step chain (10 burn-in) of shells and rods above the wall in an
    (L, L, 0) box on JAX's draws: the energy takes the minimum image only
    (JAX mcmc.py:43), as M1's minimum-image instance does on the card."""
    from rigidmultiblobswall_tpu.models import mcmc as jmcmc
    from rigidmultiblobswall_tpu_torch.models import mcmc as tmcmc
    from test_torch_mcmc import (L_BOX, _assert_states_close,
                                 _jax_chain_keys, _jax_step_draws, _scene)

    js, jst, ts, tst = _scene("wall", coincident=False,
                              periodic_length=(L_BOX, L_BOX, 0.0))
    assert ts.domain == "single_wall" and ts.periodic_length[0] == L_BOX
    e_t = float(tmcmc.total_energy(ts, tst))
    assert abs(e_t - float(jmcmc.total_energy(js, jst))) <= 1e-12 * abs(e_t)
    key = jax.random.PRNGKey(8)
    kw = dict(n_steps=10, save_every=3, initial_step=-10)
    jmc, jtraj, jen = jmcmc.run_mcmc(js, jst, key, **kw)
    draws = [_jax_step_draws(k, ts.num_bodies)
             for k in _jax_chain_keys(key, **kw)]
    tmc_, ttraj, ten = tmcmc.run_mcmc(ts, tst, draws=draws, **kw)
    _assert_states_close(ttraj, jtraj)
    _assert_states_close(tmc_.state, jmc.state)
    np.testing.assert_allclose(to_np(ten), np.asarray(jen), rtol=1e-12,
                               atol=0)
    assert int(tmc_.accepted) == int(jmc.accepted) > 0


@pytest.mark.parametrize("L", [(3.0, 3.0, 3.0), (40.0, 40.0, 3.0)])
def test_small_box_forces_fall_back_to_the_direct_sweep(L):
    """A periodic axis under 4 cells of the cutoff: the linked-cell forces
    are the direct periodic sweep (K2's image boxes), as in JAX
    (forces.py:144-151); its overflow count is 0 and the capacity sizing
    leaves the system as it is."""
    from rigidmultiblobswall_tpu.ops import forces as jforces
    from rigidmultiblobswall_tpu_torch.models import system as tsys
    from rigidmultiblobswall_tpu_torch.ops import forces as tforces

    kw = dict(repulsion_strength=0.3, debye_length=0.25, blob_radius=0.2,
              periodic_length=L, cutoff=1.0)
    rng = np.random.default_rng(17)
    r = rng.uniform(0, 3.0, (40, 3))
    ref = np.asarray(jforces.blob_blob_forces_neighbor_list(
        jnp.asarray(r), **kw))
    got = tforces.blob_blob_forces_neighbor_list(torch.as_tensor(r), **kw)
    assert rel_err(got, ref) < 1e-12
    direct = tforces.blob_blob_forces(
        torch.as_tensor(r), **{k: v for k, v in kw.items() if k != "cutoff"})
    assert torch.equal(got, direct)
    t = tsys.BodyType(name="s", ref_config=np.zeros((1, 3)), count=40)
    system = tsys.System(types=(t,), domain="no_wall", periodic_length=L,
                         blob_blob_force_method="neighbor_list",
                         blob_blob_cutoff=1.0, blob_blob_cell_capacity=8,
                         repulsion_strength=0.3, debye_length=0.25,
                         blob_radius=0.2)
    assert tforces.neighbor_list_overflow(system, torch.as_tensor(r)) == 0
    assert tforces.auto_force_cell_capacity(system, r) is system
