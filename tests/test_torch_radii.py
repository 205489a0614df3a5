"""Per-blob and mixed blob radii on the pairwise domains of the PyTorch
port against the JAX package, float64 on the CPU (1e-10 unless stated):

- System: from_reference carries each type's blob_radii; build_system
  reads them from four-column .vertex files (structures, obstacles and
  articulated sub-bodies) as the JAX build_system does.
- The products: mobility_radii_trans_times_force, its stacked form and
  dense_mobility_radii on single_wall and no_wall (the plain version of
  kernel P1); the different-radii blocks are reciprocal, M(j, i) =
  M(i, j)^T, to 1e-13 (P1's symmetric sweep rests on it), and P1's
  condensed block (csrc/pair_radii.cu's arithmetic, emulated in numpy) is
  the plain block, on its far path and its full path; an emulated warp
  rotation takes the far path exactly when its 32 pairs are far, with the
  same bits for a far pair on either path.
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


def _p1_condense(d, zt, zs, at, as_, wall, full):
    """csrc/pair_radii.cu's make_target, make_geo and condense<T, WALL,
    FULL> in numpy (their operations in their order, float64; 1/a staged
    by the exact division): the pair's far flag and the five scalars (A, S,
    P, Q, zz) of its block."""
    # the target's terms, formed once a tile
    ia, a2 = 1 / at, at * at
    ca, z23 = 2 / 3 * a2, 2 / 3 * zt
    # the geometry and the regime
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    xy2 = dx * dx + dy * dy
    r2 = xy2 + dz * dz
    sum_ = at + as_
    far = r2 > sum_ * sum_
    # the far RPY form (r^2 = 0 gives inf and NaN, never selected)
    b2 = as_ * as_
    s2 = a2 + b2
    with np.errstate(divide="ignore", invalid="ignore"):
        invr = 1 / np.sqrt(r2)
        invr2 = invr * invr
        invr3 = invr2 * invr
        x = s2 * invr2
        c1 = (1 + x * (1 / 3)) * invr
        c2 = invr3 - x * invr3
        if full:
            dif = as_ - at
            dd2 = dif * dif
            inv_ab = ia * (1 / as_)
            q = dd2 + 3 * r2
            c1_mid = (0.5 * (at + as_) - q * q * invr3 * (1 / 32)) * (
                4 / 3 * inv_ab)
            w = dd2 - r2
            c2_mid = w * w * invr3 * invr2 * (0.125 * inv_ab)
            c1_in = 4 / 3 * np.minimum(ia, 1 / as_)
            mid = r2 > dd2
            c1 = np.where(far, c1, np.where(mid, c1_mid, c1_in))
            c2 = np.where(far, c2, np.where(mid, c2_mid, 0.0))
    p = c2 * dz
    A, S, P, Q, Z = c1, c2, p, p, p * dz + c1
    if wall:
        # each entry by Horner's rule in u = 1/R^2, e = Rz^2 u
        Rz = zt + zs
        Rz2 = Rz * Rz
        W = 1 / np.sqrt(Rz2 + xy2)
        u = W * W
        W3 = W * u
        e = Rz2 * u
        x2 = 2 * (zt * zs)
        h = s2 * (1 / 3)
        K, M = h + x2, h - x2
        G = ca * zs + b2 * z23
        GR = G * Rz
        cab = ca * b2
        cabe = cab * e
        b15 = 15 * GR - 35 * cabe
        bA = (3 * GR + cab) - 5 * cabe
        A = W * (u * (u * bA - K) - 1) + A
        bS = b15 + 5 * cab
        S = W3 * (u * (3 * K - u * bS) - 1) + S
        D = (a2 - b2) * Rz
        E = 3 * (x2 * Rz + G)
        F = (Rz * u) * (u * (b15 + 15 * cab))
        P = W3 * (u * (D - E) + (F - dz)) + P
        Q = W3 * (u * (D + E) - (F + dz)) + Q
        bZ = GR * (15 * e - 9) + cab * ((30 - 35 * e) * e - 3)
        Z = W * (u * (u * bZ + (3 * e - 1) * M) - (1 + e)) + Z
    return far, np.stack([A, S, P, Q, Z], axis=-1)


def _p1_expand(d, c):
    """The 3 x 3 block of the five condensed scalars c (..., 5)."""
    dx, dy = d[..., 0], d[..., 1]
    A, S, P, Q, Z = np.moveaxis(c, -1, 0)
    m = np.zeros(dx.shape + (3, 3))
    m[..., 0, 0] = A + S * dx * dx
    m[..., 1, 1] = A + S * dy * dy
    m[..., 0, 1] = m[..., 1, 0] = S * dx * dy
    m[..., 0, 2], m[..., 1, 2] = P * dx, P * dy
    m[..., 2, 0], m[..., 2, 1] = Q * dx, Q * dy
    m[..., 2, 2] = Z
    return m


def _plain_blocks(r, rad, ti, si, wall):
    """The plain blocks M(r_t, r_s; a_t, a_s) of the pairs (ti, si)."""
    d = torch.tensor(r[ti] - r[si])
    a, z = torch.tensor(rad), torch.tensor(r[:, 2])
    ref = trpy.rpy_tt_radii(d, a[ti], a[si])
    if wall:
        ref = ref + trpy.wall_tt_radii(d[..., 0], d[..., 1], z[ti] + z[si],
                                       z[ti], z[si], a[ti], a[si])
    return ref.numpy()


@pytest.mark.parametrize("wall", [True, False])
def test_p1_condensed_block_is_the_plain_block(wall):
    """Kernel P1's condensing (the far form with the overlapping and inside
    regimes selected over it, the wall terms by Horner's rule in 1/R^2,
    the staged 1/a) gives the plain blocks of every pair, self pairs and
    one blob inside another included, and the far path alone gives them
    for the far pairs."""
    r, rad, _ = _blobs(60, seed=4)
    r[:, 2] = np.maximum(r[:, 2], rad)
    ti, si = np.indices((60, 60))
    d = r[ti] - r[si]
    z = r[:, 2]
    far, c = _p1_condense(d, z[ti], z[si], rad[ti], rad[si], wall, True)
    ref = _plain_blocks(r, rad, ti, si, wall)
    assert _rel(_p1_expand(d, c), ref) < 1e-13
    assert 0 < far.sum() < far.size - 60
    _, c_far = _p1_condense(d, z[ti], z[si], rad[ti], rad[si], wall, False)
    assert _rel(_p1_expand(d[far], c_far[far]), ref[far]) < 1e-13


def _warp_scene(inside, seed):
    """A warp's 32 targets and a quarter's 32 sources (rows 0-31 and
    32-63) above the wall, radii in [0.1, 0.3], far apart but for `inside`:
    'none'; 'one' (target 3 overlapping source 32 + 7); 'all' (all 64 within
    0.05 of a point, so every pair is inside contact); 'coincident' (target
    9 at source 32 + 20)."""
    rng = np.random.default_rng(seed)
    rad = rng.uniform(0.1, 0.3, 64)
    idx = np.arange(64)
    r = np.stack([idx % 4, (idx // 4) % 4, idx // 16], axis=1) * 0.8 + 0.4
    r = r + rng.uniform(-0.05, 0.05, (64, 3))
    if inside == "one":
        r[32 + 7] = r[3] + (0.3, 0.0, 0.0)
        rad[3], rad[32 + 7] = 0.2, 0.25
    elif inside == "all":
        r = np.array([1.0, 1.0, 0.6]) + rng.uniform(-0.025, 0.025, (64, 3))
    elif inside == "coincident":
        r[32 + 20] = r[9]
    return r, rad


def _boxes_far(rt, at, rs, as_):
    """csrc/pair_radii.cu's boxes_far on the two tiles' rows: their
    bounding boxes further apart than their largest radii add up to, with
    the kernel's margin."""
    gap = np.maximum(np.maximum(rt.min(0) - rs.max(0), rs.min(0) - rt.max(0)),
                     0)
    s = at.max() + as_.max()
    return (gap * gap).sum() > s * s * 1.0001


@pytest.mark.parametrize("wall", [True, False])
@pytest.mark.parametrize("inside", ["none", "one", "all", "coincident"])
def test_p1_warp_vote_paths(wall, inside):
    """One rotation of P1's sweep off the diagonal tile, emulated: at each
    of the 32 steps lane l pairs target l with source (l + step) mod 32 and
    the warp takes the far path only when all 32 pairs are far. The far
    path's block equals the full path's bit for bit on every far pair
    (float64); every step holding a pair inside contact or a coincident
    pair takes the full path, and the tile box test (which sends every step
    of a tile pair down the far path) never passes such a warp; and the
    sums, M_ij v_j to the target and the transposed block M_ij^T v_i to
    the source, are the plain products of M(i, j) and M(j, i) to
    1e-13."""
    r, rad = _warp_scene(inside, seed=7)
    r[:, 2] = np.maximum(r[:, 2], rad)
    z = r[:, 2]
    v = np.random.default_rng(8).normal(size=(64, 3))
    lanes = np.arange(32)
    acc_t = np.zeros((32, 3))
    acc_s = np.zeros((32, 3))
    full_steps = []
    for step in range(32):
        ti, si = lanes, 32 + (lanes + step) % 32
        d = r[ti] - r[si]
        args = (d, z[ti], z[si], rad[ti], rad[si], wall)
        far, c_full = _p1_condense(*args, True)
        _, c_far = _p1_condense(*args, False)
        assert np.array_equal(c_far[far], c_full[far])
        gap = np.linalg.norm(d, axis=-1) - rad[ti] - rad[si]
        assert np.array_equal(far, gap > 0)
        m = _p1_expand(d, c_far if far.all() else c_full)
        if not far.all():
            full_steps.append(step)
        acc_t += np.einsum("lab,lb->la", m, v[si])
        acc_s[si - 32] += np.einsum("lba,lb->la", m, v[ti])
    want = {"none": [], "one": [(7 - 3) % 32], "all": list(range(32)),
            "coincident": [(20 - 9) % 32]}[inside]
    assert full_steps == want
    # the tile box test never sends a pair inside contact down the far path
    if _boxes_far(r[:32], rad[:32], r[32:], rad[32:]):
        assert not full_steps
    if inside == "none":   # apart along z, the two tiles' boxes are far
        r_apart = r[32:] + (0.0, 0.0, 4.0)
        assert _boxes_far(r[:32], rad[:32], r_apart, rad[32:])
    ti, si = np.indices((32, 32))
    m_ts = _plain_blocks(r, rad, ti, si + 32, wall)
    m_st = _plain_blocks(r, rad, si + 32, ti, wall)
    ref_t = np.einsum("tsab,sb->ta", m_ts, v[32:])
    ref_s = np.einsum("stab,tb->sa", m_st.transpose(1, 0, 2, 3), v[:32])
    assert _rel(acc_t, ref_t) < 1e-13
    assert _rel(acc_s, ref_s) < 1e-13


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
    # the free surface and the image boxes (formerly refused here): the
    # JAX package's source-target product on the same inputs
    for domain, box in (("free_surface", (0.0, 0.0, 0.0)),
                        ("single_wall", (5.0, 5.0, 0.0))):
        multi = tmob.mobility_radii_multi(rt, v, at, ETA, domain=domain,
                                          periodic_length=box)
        for b in range(3):
            ref = np.asarray(jmob.mobility_radii_trans_times_force(
                jnp.asarray(r), jnp.asarray(v[b].numpy()),
                jnp.asarray(rad), ETA, domain=domain, periodic_length=box))
            assert _rel(multi[b], ref) < 1e-12
    # in_plane stays refused: the JAX package's radii products treat it as
    # an unbounded domain
    with pytest.raises(NotImplementedError, match="in_plane"):
        tmob.mobility_radii_multi(rt, v, at, ETA, domain="in_plane")
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


# the radii products with image boxes (P1's image-box instance on the
# card) and on the free surface (its free-surface instance)
RADII_BOXES = [("single_wall", (3.1, 2.7, 0.0)), ("no_wall", (3.1, 2.7, 0.0)),
               ("no_wall", (3.1, 2.7, 3.4)), ("free_surface", (0.0, 0.0, 0.0)),
               ("free_surface", (3.1, 2.7, 0.0)),
               ("free_surface", (3.1, 2.7, 3.4))]


@pytest.mark.parametrize("domain, box", RADII_BOXES)
def test_radii_images_and_free_surface_match_jax(domain, box):
    """mobility_radii_multi (B = 2, the plain version of P1) against the
    JAX package's source_target_matvec through
    mobility_radii_trans_times_force, blobs on and near the plane
    included; the free surface's radii blocks are reciprocal."""
    r, rad, _ = _blobs(seed=17)
    r[3, 2] = 0.0
    r[4] = r[3]
    rng = np.random.default_rng(18)
    v = rng.normal(size=(2, r.shape[0], 3))
    got = tmob.mobility_radii_multi(torch.tensor(r), torch.tensor(v),
                                    torch.tensor(rad), ETA, domain=domain,
                                    periodic_length=box)
    for b in range(2):
        ref = np.asarray(jmob.mobility_radii_trans_times_force(
            jnp.asarray(r), jnp.asarray(v[b]), jnp.asarray(rad), ETA,
            domain=domain, periodic_length=box))
        assert _rel(got[b], ref) < 1e-12
    if domain == "free_surface" and box[0] == 0.0:
        m = to_np(tmob.dense_mobility_radii(torch.tensor(r),
                                            torch.tensor(rad), ETA,
                                            domain=domain))
        assert np.abs(m - m.T).max() < 1e-13 * np.abs(m).max()
        ref = np.asarray(jmob.dense_mobility_radii(
            jnp.asarray(r), jnp.asarray(rad), ETA, domain=domain))
        assert _rel(m, ref) < 1e-12


@pytest.mark.parametrize("domain, box", [("single_wall", (3.6, 3.6, 0.0)),
                                         ("free_surface", (0.0, 0.0, 0.0))])
def test_radii_steps_in_boxes_and_on_the_free_surface_match_jax(domain, box):
    """Two forward Euler steps of the 4-shell bidisperse scene in an
    (L, L, 0) box above the wall and on the free surface: positions to
    1e-9 of the displacement, equal GMRES counts."""
    js, jst, ts, tst = _bidisperse(domain=domain, periodic_length=box)
    scheme = "deterministic_forward_euler"
    jstep = jax.jit(jint.make_stepper(js, scheme, 2e-3))
    jc, s = jint.init_carry(js, state=jst), jst
    tstep = tint.make_stepper(ts, scheme, 2e-3)
    tc, t = tint.init_carry(ts, state=tst), tst
    gen = torch.Generator().manual_seed(0)
    for k in _keys(2):
        s, jc, jaux = jstep(s, k, jc)
        t, tc, taux = tstep(t, gen, tc)
    disp = np.abs(np.asarray(s.pos) - np.asarray(jst.pos)).max()
    assert disp > 1e-5
    np.testing.assert_allclose(to_np(t.pos), np.asarray(s.pos),
                               atol=1e-9 * disp, rtol=0)
    assert taux.det_iterations == int(jaux.det_iterations)


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
