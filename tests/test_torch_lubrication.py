"""The lubrication-corrected sphere path of the PyTorch port
(models/lubrication.py) against the JAX package, float64 on the CPU
(every grand product runs K1's plain version here, every pair force
K2's):

- the port's copy of the tables equals the JAX package's arrays, and
  both read the same reference-format text tables;
- every resistance scalar function and small matrix at radii in each
  branch (the AT asymptotics below 2.006, the inverted WS mobility to
  2.1, JO beyond, past the tables' ends, gaps under debye_cut) and at
  wall heights on both sides of 1.01 and 1.1 and past the tables, to
  1e-12 of the largest value;
- the Delta_R blocks, dense-masked and on the neighbor list (overflow
  at max_neighbors = 1 included), their products and the preconditioner,
  on 19 spheres near the wall and one isolated above them;
- the solves (lub_solve, lub_rfd_solve, torque_from_omega) to 1e-9 with
  equal GMRES counts; the noise right-hand sides with the JAX normals
  fed in;
- 3 Euler-Maruyama and 3 trapezoidal steps (omega 25, cut_torque 0.2)
  on 16 spheres with the JAX steppers' normals fed in: positions to
  1e-9 of the displacement, the same solver and rejection counts on
  every step; one step forced into a wall rejection, one into a jump
  rejection;
- `from_reference` and the refusal of periodic boxes.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rigidmultiblobswall_tpu.models import lubrication as jlub
from rigidmultiblobswall_tpu.ops import forces as jforces
from rigidmultiblobswall_tpu_torch.models import lubrication as tlub

from torch_parity import to_np

TOL = 1e-12
SOLVE_TOL = 1e-9
TABLES_J = jlub.LubricationTables.load_packaged()
TABLES_T = tlub.LubricationTables.load_packaged()
MF = (6.0 * np.pi * 0.957e-3, 6.0 * np.pi * 0.957e-3,
      6.0 * np.pi * 0.957e-3)
# the Uniform_Rollers physics (examples/lubrication_rollers)
FORCES = dict(g=0.0025395, repulsion_strength=0.0165677856,
              debye_length=0.1, repulsion_strength_wall=0.0165677856,
              debye_length_wall=0.1)


def _rel(got, ref):
    got, ref = to_np(got), np.asarray(ref)
    scale = np.abs(ref).max()
    return float(np.abs(got - ref).max() / (scale if scale > 0 else 1.0))


def _solvers(n, **kw):
    base = dict(num_bodies=n, eta=0.957e-3, a=1.0, kT=0.0041419464,
                dt=1e-3, cutoff=4.5, cutoff_wall=4.5, debye_cut=1e-2,
                rf_delta=1e-3, solver_tolerance=1e-10, lanczos_max_iter=40,
                tables=TABLES_J)
    base.update(kw)
    jsol = jlub.LubSolver(**base)
    return jsol, tlub.from_reference(jsol, device="cpu")


def _cluster(n=20, seed=5, spacing=2.05, z0=1.05):
    """n spheres on a jittered square lattice near the wall: close pairs
    in every branch, heights on both sides of 1.01 and 1.1."""
    rng = np.random.default_rng(seed)
    side = int(np.ceil(np.sqrt(n)))
    idx = np.arange(n)
    pos = np.stack([(idx % side) * spacing, (idx // side) * spacing,
                    np.full(n, z0)], axis=1)
    pos[:, :2] += rng.uniform(-0.04, 0.04, (n, 2))
    pos[:, 2] += rng.uniform(0.0, 0.15, n)
    return pos


def _unit(rng, shape):
    v = rng.normal(size=shape + (3,))
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def test_tables_copy_equals_jax():
    for f in dataclasses.fields(tlub.LubricationTables):
        got = getattr(TABLES_T, f.name)
        assert got.dtype == np.float64
        assert np.array_equal(got, getattr(TABLES_J, f.name)), f.name
    # the port reads its own copy, not the JAX package's file
    assert "rigidmultiblobswall_tpu_torch" in tlub._PACKAGED_TABLES


def _write_reference_tables(d, t):
    """The tables in the reference text format (Resistance_Coefs/*.txt):
    pair tables alternate 11 and 12 rows of (x, 5 scalars); the wall
    mobility table runs from far to near."""
    def pair(name, x, s11, s12):
        rows = np.empty((2 * len(x), 6))
        rows[0::2] = np.column_stack([x, s11])
        rows[1::2] = np.column_stack([x, s12])
        np.savetxt(d / name, rows, fmt="%.17g")

    pair("mob_scalars_WS.txt", t.ws_x, t.ws_11, t.ws_12)
    pair("res_scalars_JO.txt", t.jo_x, t.jo_11, t.jo_12)
    pair("res_scalars_MB_1.txt", t.mb_x, t.mb_11, t.mb_12)
    np.savetxt(d / "mob_scalars_wall_MB_2562_eig_thresh.txt",
               np.column_stack([t.wall_sup_x, t.wall_sup])[::-1],
               fmt="%.17g")
    np.savetxt(d / "res_scalars_wall_MB.txt",
               np.column_stack([t.wall_mb_x, t.wall_mb]), fmt="%.17g")


def test_text_tables_and_env_override(tmp_path, monkeypatch):
    _write_reference_tables(tmp_path, TABLES_T)
    jt = jlub.LubricationTables.load_from_dir(str(tmp_path))
    monkeypatch.setenv("RMB_TPU_LUB_TABLES", str(tmp_path))
    tt = tlub.LubricationTables.load()
    for f in dataclasses.fields(tlub.LubricationTables):
        assert np.array_equal(getattr(tt, f.name), getattr(jt, f.name))
        assert np.array_equal(getattr(tt, f.name),
                              getattr(TABLES_T, f.name)), f.name
    monkeypatch.delenv("RMB_TPU_LUB_TABLES")
    with pytest.raises(FileNotFoundError):
        tlub.LubricationTables.load(str(tmp_path / "missing"))


# radii: gaps under debye_cut, the AT branch (with a small debye_cut),
# WS, the 2.1 switch, JO, past the WS (2.2) and JO (5.001) table ends
RADII = np.array([1.97, 2.0004, 2.003, 2.0055, 2.009, 2.012, 2.05, 2.0999,
                  2.1001, 2.15, 2.3, 3.0, 4.2, 4.99, 5.2, 7.0])
# heights (units of a): inside the wall, under debye_cut, both sides of
# 1.01 and 1.1, past the wall_sup (10.02) and wall_mb (13.5) table ends
HEIGHTS = np.array([0.9, 1.0, 1.004, 1.0099, 1.0101, 1.05, 1.0999, 1.1001,
                    1.5, 3.0, 9.9, 10.5, 13.0, 14.0, 20.0])


@pytest.mark.parametrize("debye_cut", [1e-2, 1e-4])
def test_pair_functions_match_jax(debye_cut):
    rng = np.random.default_rng(1)
    r_hat = _unit(rng, (len(RADII),))
    rt, ht = torch.as_tensor(RADII), torch.as_tensor(r_hat)
    rj, hj = jnp.asarray(RADII), jnp.asarray(r_hat)
    dt = TABLES_T.to("cpu")
    for x, t11, t12 in (("ws_x", "ws_11", "ws_12"),
                        ("jo_x", "jo_11", "jo_12"),
                        ("mb_x", "mb_11", "mb_12")):
        for col in (t11, t12):
            assert _rel(tlub._interp_scalars(getattr(dt, x), getattr(dt, col),
                                             rt),
                        jlub._interp_scalars(getattr(TABLES_J, x),
                                             getattr(TABLES_J, col), rj)) \
                <= TOL, col
    r_at = np.maximum(RADII, 2.0 + 1e-6)
    got = tlub._at_scalars(torch.as_tensor(r_at), torch.float64)
    ref = jlub._at_scalars(jnp.asarray(r_at), jnp.float64)
    assert max(_rel(g, r) for g, r in zip(got, ref)) <= TOL
    s11, s12 = rng.normal(size=(2, len(RADII), 5))
    assert _rel(tlub._pair_matrix(torch.as_tensor(s11), torch.as_tensor(s12),
                                  ht, MF),
                jlub._pair_matrix(jnp.asarray(s11), jnp.asarray(s12), hj,
                                  MF)) <= TOL
    for name in ("pair_resistance_sup", "pair_resistance_mb"):
        got = getattr(tlub, name)(rt, ht, MF, dt, debye_cut)
        ref = getattr(jlub, name)(rj, hj, MF, TABLES_J, debye_cut)
        # the branches: every block is compared, each to its own scale
        for k in range(len(RADII)):
            assert _rel(got[k], ref[k]) <= TOL, (name, RADII[k])


@pytest.mark.parametrize("debye_cut", [1e-2, 1e-4])
def test_wall_functions_match_jax(debye_cut):
    ht, hj = torch.as_tensor(HEIGHTS), jnp.asarray(HEIGHTS)
    dt = TABLES_T.to("cpu")
    for name in ("wall_resistance_sup", "wall_resistance_mb"):
        got = getattr(tlub, name)(ht, MF, dt, debye_cut, torch.float64)
        ref = getattr(jlub, name)(hj, MF, TABLES_J, debye_cut, jnp.float64)
        for k in range(len(HEIGHTS)):
            assert _rel(got[k], ref[k]) <= TOL, (name, HEIGHTS[k])
    rng = np.random.default_rng(2)
    v = rng.normal(size=(5, 7))
    assert _rel(tlub._wall_6x6(*torch.as_tensor(v), MF, torch.float64),
                jlub._wall_6x6(*jnp.asarray(v), MF, jnp.float64)) <= TOL


@functools.lru_cache(maxsize=None)
def _blocks(max_neighbors):
    """The 20-sphere cluster, its last sphere lifted past the wall cutoff
    and every neighbor (isolated: the preconditioner's bypass)."""
    jsol, tsol = _solvers(20, max_neighbors=max_neighbors)
    pos = _cluster()
    pos[-1, 2] = 8.0
    jb = jax.jit(lambda p: jlub.compute_blocks(jsol, p))(jnp.asarray(pos))
    tb = tlub.compute_blocks(tsol, torch.as_tensor(pos))
    return jsol, tsol, pos, jb, tb


@pytest.mark.parametrize("max_neighbors", [None, 16, 1])
def test_delta_r_blocks_match_jax(max_neighbors):
    _, _, _, jb, tb = _blocks(max_neighbors)
    names = (("diag", "offdiag", "diag_sup", "diag_mb")
             if max_neighbors is None else
             ("diag", "off", "diag_sup", "diag_mb"))
    for name in names:
        assert _rel(getattr(tb, name), getattr(jb, name)) <= TOL, name
    assert np.array_equal(to_np(tb.isolated), np.asarray(jb.isolated))
    assert to_np(tb.isolated).tolist() == [False] * 19 + [True]
    if max_neighbors is None:
        assert isinstance(tb, tlub.DeltaRBlocks) and int(tb.overflow) == 0
        return
    assert np.array_equal(to_np(tb.idx), np.asarray(jb.idx))
    assert np.array_equal(to_np(tb.mask), np.asarray(jb.mask))
    assert int(tb.overflow) == int(jb.overflow)
    assert (int(tb.overflow) > 0) == (max_neighbors == 1)


def test_sparse_blocks_equal_dense():
    """At a capacity that holds every neighbor the sparse blocks are the
    dense ones."""
    _, _, _, _, dense = _blocks(None)
    _, _, _, _, sparse = _blocks(16)
    assert int(sparse.overflow) == 0
    x = torch.as_tensor(np.random.default_rng(3).normal(size=120))
    assert _rel(tlub.delta_r_mult(sparse, x),
                to_np(tlub.delta_r_mult(dense, x))) <= TOL


@pytest.mark.parametrize("max_neighbors", [None, 16])
def test_delta_r_products_and_pc_match_jax(max_neighbors):
    jsol, tsol, _, jb, tb = _blocks(max_neighbors)
    rng = np.random.default_rng(4)
    x = rng.normal(size=120)
    xt, xj = torch.as_tensor(x), jnp.asarray(x)
    assert _rel(tlub.delta_r_mult(tb, xt), jlub.delta_r_mult(jb, xj)) <= TOL
    v = rng.normal(size=60)
    for rows, cols in ((slice(3, 6), slice(0, 3)), (slice(0, 3),
                                                    slice(0, 3))):
        assert _rel(tlub.delta_r_sub_mult(tb, torch.as_tensor(v), rows,
                                          cols),
                    jlub.delta_r_sub_mult(jb, jnp.asarray(v), rows,
                                          cols)) <= TOL
    assert _rel(tlub.make_lub_pc(tsol, tb)(xt),
                jlub.make_lub_pc(jsol, jb)(xj)) <= 1e-11


SOLVES = {
    "lub_solve X Xm x0": lambda lub, sol, p, b, a: lub.lub_solve(
        sol, p, b, X=a["X"], Xm=a["Xm"], x0=a["x0"]),
    "lub_solve Xm": lambda lub, sol, p, b, a: lub.lub_solve(
        sol, p, b, Xm=a["Xm"]),
    "lub_rfd_solve": lambda lub, sol, p, b, a: lub.lub_rfd_solve(
        sol, p, b, a["X"]),
    "torque_from_omega (3,)": lambda lub, sol, p, b, a:
        lub.torque_from_omega(sol, p, b, a["omega3"], a["F"]),
    "torque_from_omega (B,3) cut": lambda lub, sol, p, b, a:
        lub.torque_from_omega(sol, p, b, a["omegaB"], a["F"],
                              cut_torque=0.05),
}


@pytest.mark.parametrize("case", list(SOLVES))
def test_solves_match_jax(case):
    """Each solve to 1e-9 with the same GMRES count (the JAX side jitted,
    as its steppers run it)."""
    jsol, tsol, pos, jb, tb = _blocks(16)
    rng = np.random.default_rng(5)
    args = dict(X=rng.normal(size=120), Xm=rng.normal(size=120),
                x0=rng.normal(size=120), F=rng.normal(size=(20, 3)) * 1e-3,
                omega3=np.array([1.0, 20.0, 0.5]),
                omegaB=rng.normal(size=(20, 3)) * 10)
    call = SOLVES[case]
    got = call(tlub, tsol, torch.as_tensor(pos), tb,
               {k: torch.as_tensor(v) for k, v in args.items()})
    ref = jax.jit(lambda p, b, a: call(jlub, jsol, p, b, a))(
        jnp.asarray(pos), jb, {k: jnp.asarray(v) for k, v in args.items()})
    assert got[-1] == int(ref[-1]) and got[-1] > 0
    for g, r in zip(got[:-1], ref[:-1]):
        assert _rel(g, r) <= SOLVE_TOL
    if "cut" in case:
        T = got[0]
        assert float(torch.linalg.norm(T, dim=1).max()) <= 0.05 * (1 + 1e-12)


def test_omega_conventions():
    """A scalar spins about y, a (3,) vector is broadcast, a (B,3) array
    is per body (Lub_Solver.py:927-929)."""
    om = tlub._omega_per_body(25.0, 4, torch.float64, "cpu")
    assert torch.equal(om, torch.tensor([[0.0, 25.0, 0.0]] * 4,
                                        dtype=torch.float64))
    om = tlub._omega_per_body((1.0, 2.0, 3.0), 4, torch.float64, "cpu")
    assert om.shape == (4, 3) and torch.equal(om[3], torch.tensor(
        [1.0, 2.0, 3.0], dtype=torch.float64))
    per = np.arange(12.0).reshape(4, 3)
    assert np.array_equal(to_np(tlub._omega_per_body(per, 4, torch.float64,
                                                     "cpu")), per)


def _feed(monkeypatch, normals):
    """Make the port draw the given normals, in order."""
    feed = iter(normals)

    def draws(generator, shape, like):
        z = next(feed)
        assert z.shape == tuple(shape)
        return torch.as_tensor(z, dtype=like.dtype, device=like.device)

    monkeypatch.setattr(tlub, "draw_normal", draws)
    return feed


def _normal(key, n):
    return np.array(jax.random.normal(key, (n,), dtype=jnp.float64))


def test_noise_rhs_match_jax(monkeypatch):
    jsol, tsol, pos, jb, tb = _blocks(16)
    pt, pj = torch.as_tensor(pos), jnp.asarray(pos)
    key = jax.random.PRNGKey(7)
    k1, k2 = jax.random.split(key)
    feed = _feed(monkeypatch, [_normal(k1, 120), _normal(k2, 120),
                               _normal(key, 120)])
    got = tlub.mobility_root_rhs(tsol, pt, tb, None)
    ref = jax.jit(lambda p, b, k: jlub.mobility_root_rhs(jsol, p, b, k))(
        pj, jb, key)
    assert got[2] == int(ref[2]) and got[2] > 0
    assert _rel(got[0], ref[0]) <= SOLVE_TOL
    assert _rel(got[1], ref[1]) <= SOLVE_TOL
    got = tlub.rfd_rhs(tsol, pt, tb, None)
    ref = jax.jit(lambda p, b, k: jlub.rfd_rhs(jsol, p, b, k))(pj, jb, key)
    assert got[2] == int(ref[2]) and got[2] > 0 and int(got[3]) == 0
    assert _rel(got[0], ref[0]) <= 1e-8 and _rel(got[1], ref[1]) <= 1e-8
    assert next(feed, None) is None


def _jax_ft_calc(a=1.0, firm=0.0, firm_delta=1e-2, **kw):
    """The JAX CLI's force composition (cli.py:296-323)."""
    p = dict(FORCES, **kw)
    debye_firm = 2.0 * a * firm_delta / np.log(1e1)

    def ft_calc(pos):
        f = jforces.blob_external_forces(
            pos, g=p["g"], blob_radius=a,
            repulsion_strength_wall=p["repulsion_strength_wall"],
            debye_length_wall=p["debye_length_wall"])
        f = f + jforces.blob_blob_forces(
            pos, repulsion_strength=p["repulsion_strength"],
            debye_length=p["debye_length"], blob_radius=a)
        if firm > 0:
            f = f + jforces.blob_external_forces(
                pos, g=0.0, blob_radius=a * (1.0 - firm_delta),
                repulsion_strength_wall=firm, debye_length_wall=debye_firm)
            f = f + jforces.blob_blob_forces(
                pos, repulsion_strength=firm, debye_length=debye_firm,
                blob_radius=a * (1.0 - firm_delta))
        return jnp.concatenate([f, jnp.zeros_like(f)], axis=1)

    return ft_calc


def test_ft_calc_matches_jax():
    pos = _cluster(16, seed=2, spacing=2.02, z0=0.995)
    for firm in (0.0, 0.0163):
        got = tlub.make_ft_calc(a=1.0, repulsion_strength_firm=firm,
                                firm_delta=1e-2, **FORCES)(
            torch.as_tensor(pos))
        ref = _jax_ft_calc(firm=firm)(jnp.asarray(pos))
        assert _rel(got, ref) <= TOL


def _step_normals(scheme, key, n, kT):
    """The normals one JAX step draws from its key, in the port's order
    (W1 and W2 of the two Lanczos roots, then W of the RFD)."""
    k1, k2 = jax.random.split(key)
    if scheme == "em" and kT <= 0:
        return []
    w1, w2 = jax.random.split(k1)
    return [_normal(w1, 6 * n), _normal(w2, 6 * n), _normal(k2, 6 * n)]


def _run_steps(scheme, jsol, tsol, pos, monkeypatch, n_steps=3,
               omega=None, cut_torque=None, forces=None):
    forces = forces or {}
    keys = [jax.random.PRNGKey(200 + i) for i in range(n_steps)]
    feed = _feed(monkeypatch, [z for k in keys for z in _step_normals(
        scheme, k, jsol.num_bodies, jsol.kT)])
    jft = _jax_ft_calc(**forces)
    tft = tlub.make_ft_calc(a=1.0, **dict(FORCES, **forces))
    if scheme == "em":
        jstep = jax.jit(lambda p, q, k: jlub.step_euler_maruyama(
            jsol, p, q, k, jft))

        def tstep(p, q):
            return tlub.step_euler_maruyama(tsol, p, q, None, tft)
    else:
        jstep = jax.jit(lambda p, q, k: jlub.step_trapezoidal(
            jsol, p, q, k, jft, omega=omega, cut_torque=cut_torque))

        def tstep(p, q):
            return tlub.step_trapezoidal(tsol, p, q, None, tft, omega=omega,
                                         cut_torque=cut_torque)
    quat0 = np.tile([1.0, 0, 0, 0], (len(pos), 1))
    jp, jq = jnp.asarray(pos), jnp.asarray(quat0)
    tp, tq = torch.as_tensor(pos), torch.as_tensor(quat0)
    counts = []
    for k in keys:
        jp, jq, ja = jstep(jp, jq, k)
        tp, tq, ta = tstep(tp, tq)
        counts.append(((int(ja.det_iterations), int(ja.stoch_iterations),
                        int(ja.rejections_wall), int(ja.rejections_jump)),
                       (ta.det_iterations, ta.stoch_iterations,
                        int(ta.rejections_wall), int(ta.rejections_jump))))
        assert int(ta.neighbor_overflow) == 0
    assert next(feed, None) is None
    return (np.asarray(jp), np.asarray(jq)), (to_np(tp), to_np(tq)), counts


@pytest.mark.parametrize("scheme", ["em", "trapezoidal"])
def test_steps_match_jax(scheme, monkeypatch):
    jsol, tsol = _solvers(16, max_neighbors=12)
    pos = _cluster(16, seed=9, spacing=2.1, z0=1.08)
    kw = (dict(omega=25.0, cut_torque=0.2) if scheme == "trapezoidal"
          else {})
    (jp, jq), (tp, tq), counts = _run_steps(scheme, jsol, tsol, pos,
                                            monkeypatch, **kw)
    disp = np.abs(jp - pos).max()
    assert disp > 1e-5
    np.testing.assert_allclose(tp, jp, atol=1e-9 * disp, rtol=0)
    np.testing.assert_allclose(tq, jq, atol=1e-9, rtol=0)
    for j, t in counts:
        assert t == j and t[0] > 0 and t[1] > 0


@pytest.mark.parametrize("case", ["wall", "jump"])
def test_rejections_match_jax(case, monkeypatch):
    """A step pushed through the wall (strong gravity) or more than 2a
    up (gravity reversed) keeps the old state and counts one rejection of
    its kind, as in the JAX package (kT = 0: no noise drawn)."""
    jsol, tsol = _solvers(4, kT=0.0, dt=50.0)
    forces = dict(g=1.0 if case == "wall" else -1.0)
    pos = np.array([[0.0, 0.0, 1.3], [2.4, 0.0, 1.3], [0.0, 2.4, 1.3],
                    [2.4, 2.4, 1.3]])
    (jp, _), (tp, _), counts = _run_steps("em", jsol, tsol, pos,
                                          monkeypatch, n_steps=1,
                                          forces=forces)
    (j, t), = counts
    assert t == j
    want = (1, 0) if case == "wall" else (0, 1)
    assert t[2:] == want
    np.testing.assert_array_equal(tp, pos)
    np.testing.assert_array_equal(jp, pos)


def test_from_reference_and_refusals():
    jsol, tsol = _solvers(5, max_neighbors=3, use_pc=False)
    for f in dataclasses.fields(tsol):
        if f.name not in ("tables", "device", "device_tables"):
            assert getattr(tsol, f.name) == getattr(jsol, f.name), f.name
    assert tsol.device == torch.device("cpu")
    for f in dataclasses.fields(tlub.LubricationTables):
        assert np.array_equal(getattr(tsol.tables, f.name),
                              getattr(jsol.tables, f.name))
        got = getattr(tsol.device_tables, f.name)
        assert got.dtype == torch.float64 and got.device.type == "cpu"
        assert torch.equal(got, torch.as_tensor(getattr(jsol.tables,
                                                        f.name)))
    assert tsol.mob_factor == pytest.approx(jsol.mob_factor, rel=1e-15)
    # a periodic box (formerly refused) carries across, and its Delta_R
    # blocks match JAX's on the same positions (a pair across the x edge)
    jbox, tbox = _solvers(4, periodic_length=(10.0, 10.0, 0.0))
    assert tbox.periodic_length == jbox.periodic_length
    pos = np.array([[0.2, 0.0, 1.2], [9.6, 0.3, 1.3], [4.0, 4.0, 1.1],
                    [6.1, 4.2, 1.25]])
    jb = jlub.compute_delta_r_blocks(jbox, jnp.asarray(pos))
    tb = tlub.compute_delta_r_blocks(tbox, torch.as_tensor(pos))
    assert _rel(tb.offdiag, jb.offdiag) <= TOL
    assert _rel(tb.diag, jb.diag) <= TOL
    assert float(tb.offdiag[0, 1].abs().max()) > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tlub.LubSolver(num_bodies=4)
