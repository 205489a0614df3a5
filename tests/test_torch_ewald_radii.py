"""The mixed-radii mode of the PyTorch port's spectral Ewald engine
(ops/ewald.py with EwaldParams.radii, the plain version of kernel P2)
against the JAX package's, float64 on the CPU:

- Host side: default_params(radii=...) picks JAX's grid, r_cut and xi;
  the per-group-pair Chebyshev tables, the self coefficients and the
  piece edges are JAX's to 1e-14; the self coefficients are computed once
  (one quadrature a radius, not one a round of the K loop), and a fit
  whose K loop ends above its target warns.
- make_plan(group_of=...): the per-particle self term, the group shape
  factors; update_plan keeps the groups on both branches.
- The products at 1e-12 relative: the radii wave product, the near field
  (P2's plain version; the JAX XLA sweep's radii branch) and matvec_multi
  (B = 2), wave_sqrt_noise fed JAX's grid noise; a one-group plan against
  the uniform engine; a periodic_spectral bidisperse Slip-Trapz step
  against JAX's stepper.
Parity scenes keep their radius gaps away from the span between 1e-10
and 1e-3 r_cut, where the fits lose accuracy in both packages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rigidmultiblobswall_tpu.models import integrators as jint
from rigidmultiblobswall_tpu.models import saddle as jsad
from rigidmultiblobswall_tpu.models import system as jsys
from rigidmultiblobswall_tpu.ops import ewald as jew
from rigidmultiblobswall_tpu_torch.models import integrators as tint
from rigidmultiblobswall_tpu_torch.models import saddle as tsad
from rigidmultiblobswall_tpu_torch.models import system as tsys
from rigidmultiblobswall_tpu_torch.ops import cell_kernels as tck
from rigidmultiblobswall_tpu_torch.ops import ewald as tew

from torch_parity import shell_vertices, to_np

ETA = 1.3
BOX = (18.0, 18.0, 18.0)
RADII = (0.25, 0.45)
# tol 1e-3 with a 64 grid cap: 4 near-field cells a side in this box
TOL, GRID_MAX = 1e-3, 64


def _rel(got, ref):
    ref = np.asarray(ref)
    return float(np.abs(to_np(got) - ref).max() / np.abs(ref).max())


def _params(radii=RADII, **kw):
    kw = dict(dict(tol=TOL, grid_max=GRID_MAX, radii=radii), **kw)
    return (jew.default_params(max(radii), ETA, BOX, **kw),
            tew.default_params(max(radii), ETA, BOX, **kw))


def _scene(n=120, seed=0, n_groups=2):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1.0, BOX[0] + 1.0, (n, 3))
    pos[5] = pos[4] + 0.05               # one inside the other
    pos[7] = pos[6] + 0.5                # overlapping
    groups = rng.integers(0, n_groups, n).astype(np.int32)
    return pos, groups, rng.normal(size=(n, 6))


def _plans(pj, pt, pos, groups):
    return (jew.make_plan(dataclasses.replace(pj, near_impl="xla"),
                          jnp.asarray(pos), group_of=jnp.asarray(groups)),
            tew.make_plan(pt, torch.tensor(pos),
                          group_of=torch.tensor(groups)))


def test_default_params_with_radii_match_jax():
    pj, pt = _params()
    assert (pt.grid, pt.r_cut, pt.xi, pt.support, pt.radii) == (
        pj.grid, pj.r_cut, pj.xi, pj.support, pj.radii)
    assert pt.radii == RADII and pt.a == max(RADII)


@pytest.mark.parametrize("radii", [RADII, (0.2, 0.3, 0.45)])
def test_host_tables_match_jax(radii):
    pj, pt = _params(radii)
    cj, sj = jew._host_cheb_radii(pj)
    ct, st = tew._host_cheb_radii(pt)
    assert ct.shape == cj.shape == (len(radii), len(radii), 3, 2,
                                    cj.shape[-1])
    np.testing.assert_allclose(ct, cj, rtol=0, atol=1e-14 * np.abs(cj).max())
    np.testing.assert_allclose(st, sj, rtol=0, atol=1e-14 * np.abs(sj).max())
    edges = tew.radii_edge_table(pt)
    for g in range(len(radii)):
        for h in range(len(radii)):
            e = jew._radii_pair_edges(pj, min(g, h), max(g, h))
            np.testing.assert_allclose(edges[g, h, :2], e[1:3], rtol=1e-15)
            for i in range(3):
                np.testing.assert_allclose(
                    edges[g, h, 2 + 2 * i:4 + 2 * i],
                    (0.5 * (e[i] + e[i + 1]), 2 / (e[i + 1] - e[i])),
                    rtol=1e-15)


def test_self_coefficients_once_and_a_missed_fit_warns(monkeypatch):
    """ADVICE's findings on _host_cheb_radii: the self coefficients are one
    quadrature a radius, whatever the rounds of the K loop; a loop that
    ends above its target says so (a radius gap under the 1e-3 r_cut edge
    floor, at a tolerance no 32-term fit meets)."""
    _, pt = _params((0.25, 0.25 + 1e-4), tol=1e-9, grid_max=0)
    calls = []
    real = tew.pair_remainder_radii

    def spy(r, ag, ah, eta, xi):
        calls.append(np.asarray(r).shape)
        return real(r, ag, ah, eta, xi)

    monkeypatch.setattr(tew, "pair_remainder_radii", spy)
    with pytest.warns(RuntimeWarning, match="above the target"):
        coeffs, selfs = tew._host_cheb_radii(pt)
    assert coeffs.shape[-1] == 32                 # the loop ran out
    assert calls.count((1,)) == 2 == len(selfs)   # once a radius
    tew._host_cheb_radii.cache_clear()


def test_plans_carry_groups_like_jax():
    pj, pt = _params()
    pos, groups, _ = _scene()
    plj, plt = _plans(pj, pt, pos, groups)
    np.testing.assert_array_equal(to_np(plt.group_of), np.asarray(
        plj.group_of))
    assert _rel(plt.self_coeff, plj.self_coeff) < 1e-14
    assert _rel(plt.gsinc, plj.gsinc) < 1e-13
    assert _rel(plt.kernel, plj.kernel) < 1e-12
    # refresh and rebuild keep the groups
    near = tew.update_plan(plt, torch.tensor(pos + 1e-3))
    assert near.sort_pos is plt.sort_pos and near.group_of is plt.group_of
    far = tew.update_plan(plt, torch.tensor(np.roll(pos, 3, axis=0)))
    assert far.sort_pos is not plt.sort_pos
    assert torch.equal(far.group_of, plt.group_of)
    assert far.cheb_radii is not None and far.gsinc is not None
    with pytest.raises(ValueError, match="group_of"):
        tew.make_plan(pt, torch.tensor(pos))


@pytest.mark.parametrize("n_rhs", [1, 2])
def test_products_match_jax(n_rhs):
    pj, pt = _params((0.2, 0.3, 0.45))
    pos, groups, f = _scene(n_groups=3)
    plj, plt = _plans(pj, pt, pos, groups)
    fb = f[:, :3 * n_rhs]
    for name in ("real_matvec", "wave_matvec"):
        ref = getattr(jew, name)(plj, jnp.asarray(fb))
        got = getattr(tew, name)(plt, torch.tensor(fb))
        assert _rel(got, ref) < 1e-12, name
    stack = fb.reshape(-1, n_rhs, 3).transpose(1, 0, 2)
    assert _rel(tew.matvec_multi(plt, torch.tensor(stack)),
                jew.matvec_multi(plj, jnp.asarray(stack))) < 1e-12


def test_near_field_takes_b2_as_two_sums():
    """P2's plain version at B = 2 is its two B = 1 sums."""
    _, pt = _params()
    pos, groups, f = _scene(seed=2)
    plt = tew.make_plan(pt, torch.tensor(pos), group_of=torch.tensor(groups))
    args = (plt.positions, None, plt.group_of, plt.cell_table,
            plt.cell_dims, pt.box, plt.params.cell_capacity, plt.cheb_radii,
            plt.radii_edges)
    ft = torch.tensor(f)

    def rows(fv):
        return tck.near_rpy_radii(args[0], fv, *args[2:], r_cut=pt.r_cut)

    both = rows(ft)
    assert _rel(both[:, :3], rows(ft[:, :3].contiguous())) < 1e-14
    assert _rel(both[:, 3:], rows(ft[:, 3:].contiguous())) < 1e-14


def test_wave_sqrt_noise_matches_jax_with_its_draws():
    pj, pt = _params()
    pos, groups, _ = _scene()
    plj, plt = _plans(pj, pt, pos, groups)
    key = jax.random.PRNGKey(3)
    ref = jew.wave_sqrt_noise(plj, key)
    w = np.asarray(jax.random.normal(key, (3,) + pj.grid))
    got = tew.wave_sqrt_noise(plt, torch.tensor(w))
    assert _rel(got, ref) < 1e-12


def test_one_group_plan_matches_uniform_engine():
    """One radius group is the uniform engine (per-group sinc and three
    pieces against sinc^2 and two), to the fits' accuracy."""
    a = 0.4
    pu = tew.default_params(a, ETA, BOX, tol=1e-4, grid_max=96)
    pr = tew.default_params(a, ETA, BOX, tol=1e-4, grid_max=96, radii=(a,))
    pos, _, f = _scene()
    ft = torch.tensor(f[:, :3])
    uu = tew.matvec(tew.make_plan(pu, torch.tensor(pos)), ft)
    ur = tew.matvec(tew.make_plan(pr, torch.tensor(pos),
                                  group_of=torch.zeros(len(pos),
                                                       dtype=torch.int32)),
                    ft)
    # each fit within 0.05 tol of its scale
    assert float(torch.linalg.norm(uu - ur) / torch.linalg.norm(uu)) < 1e-5


def _bidisperse_box(kT=0.0):
    """Four shells (blob radius 0.131) and four 1.2x shells (blob radius
    0.157) in a 6.4 box, tolerance 0.2, linked-cell forces."""
    L = 6.4
    rng = np.random.default_rng(4)
    idx = np.arange(8)
    pos = (np.stack([idx % 2, (idx // 2) % 2, idx // 4], axis=1) * 3.2
           + 1.6 + rng.uniform(-0.2, 0.2, (8, 3)))
    quat = rng.normal(size=(8, 4))
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    small = jsys.BodyType(name="shell", ref_config=shell_vertices(12, 0.5),
                          count=4)
    big = jsys.BodyType(name="big", ref_config=shell_vertices(12, 0.6),
                        count=4, blob_radii=np.full(12, 0.157))
    js = jsys.System(
        types=(small, big), eta=1.0, blob_radius=0.131, kT=kT, g=0.1,
        domain="periodic_spectral", periodic_length=(L,) * 3,
        spectral_tol=0.2, spectral_grid_max=32, repulsion_strength=0.2,
        debye_length=0.2, blob_blob_force_method="neighbor_list",
        blob_blob_cutoff=0.79, blob_blob_cell_capacity=16,
        solver_tolerance=1e-12)
    jst = jsys.make_state(pos, quat)
    ts, tst = tsys.from_reference(js, pos, quat, device="cpu")
    ts = tsad.exact_spectral_capacities(ts, tst)
    js = dataclasses.replace(
        js, spectral_cell_capacity=ts.spectral_cell_capacity)
    return js, jst, ts, tst


def test_saddle_builds_the_radii_plan_like_jax():
    js, jst, ts, tst = _bidisperse_box()
    pt, pj = tsad.spectral_params(ts), jsad.spectral_params(js)
    assert (pt.radii, pt.a, pt.grid, pt.r_cut) == (pj.radii, pj.a, pj.grid,
                                                   pj.r_cut)
    vals, groups = tsad.radii_groups(ts)
    jvals, jgroups = jsad.radii_groups(js)
    assert vals == jvals
    np.testing.assert_array_equal(groups, jgroups)
    plan = tsad.maybe_dense_mobility(ts, tsad.kin.blob_positions(ts, tst))
    assert plan.gsinc.shape[0] == 2 and plan.cheb_radii is not None
    many = dataclasses.replace(ts, types=(dataclasses.replace(
        ts.types[1], blob_radii=np.linspace(0.14, 0.16, 12)),)
        + ts.types[:1])
    with pytest.raises(NotImplementedError, match="distinct blob radii"):
        tsad.radii_groups(many)


def test_bidisperse_spectral_step_matches_jax():
    """Two Slip-Trapz steps at kT = 0 of the bidisperse box on the
    mixed-radii plan: final positions to 1e-9 of the displacement, equal
    GMRES counts."""
    js, jst, ts, tst = _bidisperse_box()
    scheme, dt = "stochastic_Slip_Trapz", 2e-3
    keys = [jax.random.PRNGKey(100 + i) for i in range(2)]
    jstep = jax.jit(jint.make_stepper(js, scheme, dt,
                                      lanczos_tolerance=1e-10))
    jc, s = jint.init_carry(js, state=jst), jst
    for k in keys:
        s, jc, jaux = jstep(s, k, jc)
    tstep = tint.make_stepper(ts, scheme, dt, lanczos_tolerance=1e-10)
    tc, t = tint.init_carry(ts, state=tst), tst
    gen = torch.Generator().manual_seed(0)
    for _ in keys:
        t, tc, taux = tstep(t, gen, tc)
    disp = np.abs(np.asarray(s.pos) - np.asarray(jst.pos)).max()
    assert disp > 1e-5
    np.testing.assert_allclose(to_np(t.pos), np.asarray(s.pos), rtol=0,
                               atol=1e-9 * disp)
    assert taux.det_iterations == int(jaux.det_iterations)
    assert taux.capacity_overflows == int(jaux.capacity_overflows) == 0
