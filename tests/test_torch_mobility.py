"""Kernel K1 path of the PyTorch port against the JAX package.

- float64: the rpy.py blocks of every coupling, and the port's mobility
  products (CPU tensors take K1's plain version) against
  mobility.pairwise_matvec(method="generic") at 1e-12 relative, couplings
  tt/tr/rt/rr, wall and no_wall, one and two right-hand sides (tt also
  five and six, which run in groups of two), and the grand product
  against grand_mobility_matvec;
- float32: K1's plain version of every coupling against the Pallas
  kernel run in interpret mode, at the JAX package's own f32 bound
  (3e-6 x max|ref|, tests/test_pair_kernels.py).
The kernel itself runs only on the card (tests/test_torch_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rigidmultiblobswall_tpu.ops import mobility as jmob, pair_kernels as jpk
from rigidmultiblobswall_tpu.ops import rpy as jrpy
from rigidmultiblobswall_tpu_torch.ops import mobility as tmob
from rigidmultiblobswall_tpu_torch.ops import pair_kernels as tpk
from rigidmultiblobswall_tpu_torch.ops import rpy as trpy

from torch_parity import random_blobs, rel_err, to_np

A, ETA = 0.3, 0.9


# 5 and 6: stacks wider than K1's instances run in groups of two
@pytest.mark.parametrize("n_rhs", [1, 2, 5, 6])
@pytest.mark.parametrize("domain", ["single_wall", "no_wall"])
def test_pairwise_matvec_matches_jax_generic(domain, n_rhs):
    r, _ = random_blobs()
    rng = np.random.default_rng(3)
    v = rng.normal(size=(n_rhs, r.shape[0], 3))
    ref = np.stack([np.asarray(jmob.pairwise_matvec(
        jnp.asarray(r), jnp.asarray(r), jnp.asarray(v[b]), ETA, A,
        domain=domain, method="generic")) for b in range(n_rhs)])
    rt = torch.as_tensor(r)
    got = tmob.pairwise_matvec_multi(rt, rt, torch.as_tensor(v), ETA, A,
                                     domain=domain)
    assert rel_err(got, ref) < 1e-12
    if n_rhs == 1:
        single = tmob.mobility_trans_times_force(rt, torch.as_tensor(v[0]),
                                                 ETA, A, domain=domain)
        assert rel_err(single, ref[0]) < 1e-12


def test_source_target_product_matches_jax_generic():
    """Distinct targets and sources (self_interaction=False)."""
    r, v = random_blobs(n=31, seed=4)
    tgt, _ = random_blobs(n=13, seed=5)
    ref = jmob.pairwise_matvec(jnp.asarray(r), jnp.asarray(tgt),
                               jnp.asarray(v), ETA, A, method="generic",
                               self_interaction=False)
    got = tmob.pairwise_matvec(torch.as_tensor(r), torch.as_tensor(tgt),
                               torch.as_tensor(v), ETA, A,
                               self_interaction=False)
    assert rel_err(got, ref) < 1e-12


@pytest.mark.parametrize("n_rhs", [1, 2])
@pytest.mark.parametrize("wall", [True, False])
def test_plain_k1_matches_pallas_kernel_f32(wall, n_rhs):
    r, _ = random_blobs()
    rng = np.random.default_rng(8)
    v = rng.normal(size=(r.shape[0], 3 * n_rhs)).astype(np.float32)
    q = np.array(r)
    if wall:
        q[:, 2] = np.maximum(q[:, 2], A)
    q = (q / A).astype(np.float32)
    ref = np.asarray(jpk.pair_matvec_pallas(
        jnp.asarray(q), jnp.asarray(q), jnp.asarray(v), coupling="tt",
        wall=wall, self_interaction=True, interpret=True))
    qt = torch.as_tensor(q)
    got = tpk.pair_matvec(qt, qt, torch.as_tensor(v), coupling="tt",
                          mode=tpk.wall_mode(wall), self_interaction=True)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(to_np(got), ref,
                               atol=3e-6 * np.abs(ref).max(), rtol=0)


def test_coincident_blobs_and_self_pair():
    """Coincident distinct blobs get no core term; the self pair keeps
    the wall self-mobility (JAX generic engine as oracle)."""
    r = np.array([[0.0, 0.0, 0.5], [0.0, 0.0, 0.5], [0.4, 0.1, 0.2]])
    v = np.random.default_rng(0).normal(size=(3, 3))
    for domain in ("single_wall", "no_wall"):
        ref = jmob.pairwise_matvec(jnp.asarray(r), jnp.asarray(r),
                                   jnp.asarray(v), ETA, A, domain=domain,
                                   method="generic")
        got = tmob.pairwise_matvec(torch.as_tensor(r), torch.as_tensor(r),
                                   torch.as_tensor(v), ETA, A, domain=domain)
        assert rel_err(got, ref) < 1e-12


@pytest.mark.parametrize("domain", ["single_wall", "no_wall"])
def test_dense_mobility_matches_jax(domain):
    r, _ = random_blobs(n=12, seed=2)
    ref = np.asarray(jmob.dense_mobility(jnp.asarray(r), ETA, A,
                                         domain=domain))
    got = tmob.dense_mobility(torch.as_tensor(r), ETA, A, domain=domain)
    assert rel_err(got, ref) < 1e-12
    # batched over bodies: one dense block per leading index
    batch = tmob.dense_mobility(torch.as_tensor(np.stack([r, r + 1.0])),
                                ETA, A, domain=domain)
    assert rel_err(batch[0], ref) < 1e-12


def test_unported_couplings_and_domains_raise():
    """in_plane's tr and free_surface's tt (formerly refused here) match
    the JAX package's products; the couplings those domains lack stay
    refused, as JAX refuses them; the pseudo-periodic image boxes
    (formerly refused here) match the JAX package on the same inputs."""
    r = torch.zeros((2, 3), dtype=torch.float64)
    rb, vb = random_blobs(n=15, seed=21)
    for coupling, domain in (("tr", "in_plane"), ("tt", "free_surface")):
        ref = np.asarray(jmob.pairwise_matvec(
            jnp.asarray(rb), jnp.asarray(rb), jnp.asarray(vb), 1.0, 1.0,
            coupling=coupling, domain=domain, method="generic"))
        got = tmob.pairwise_matvec(torch.as_tensor(rb), None,
                                   torch.as_tensor(vb), 1.0, 1.0,
                                   coupling=coupling, domain=domain)
        assert rel_err(got, ref) < 1e-12
    with pytest.raises(NotImplementedError):
        tmob.pairwise_matvec(r, r, r, 1.0, 1.0, coupling="rr",
                             domain="in_plane")
    with pytest.raises(NotImplementedError):
        tmob.pairwise_matvec(r, r, r, 1.0, 1.0, coupling="tr",
                             domain="free_surface")
    # the two coincident blobs at z = 0: above the wall fully damped (zero,
    # as in JAX), without the wall their images and self blocks
    rj = jnp.zeros((2, 3))
    ones, onesj = torch.ones_like(r), jnp.ones((2, 3))
    for domain in ("single_wall", "no_wall"):
        box = dict(periodic_length=(5.0, 5.0, 0.0), domain=domain)
        ref = np.asarray(jmob.pairwise_matvec(rj, rj, onesj, 1.0, 1.0,
                                              method="generic", **box))
        got = tmob.pairwise_matvec(r, r, ones, 1.0, 1.0, **box)
        ref_u, ref_w = (np.asarray(x) for x in jmob.grand_mobility_matvec(
            rj, onesj, onesj, 1.0, 1.0, **box))
        u, w = tmob.grand_mobility_matvec(r, ones, ones, 1.0, 1.0, **box)
        for t, want in ((got, ref), (u, ref_u), (w, ref_w)):
            if domain == "single_wall":
                assert not want.any() and not t.any()
            else:
                assert rel_err(t, want) < 1e-12
    with pytest.raises(ValueError):
        tmob.pairwise_matvec(r, r, r, 1.0, 1.0, coupling="grand")


def _pair_geometry():
    """Pair geometry of random_blobs in units of a, self pairs on the
    diagonal, heights shifted to max(z, a) as the products use them."""
    r, _ = random_blobs()
    q = np.array(r)
    q[:, 2] = np.maximum(q[:, 2], A)
    q /= A
    d = q[:, None, :] - q[None, :, :]
    eye = np.eye(q.shape[0], dtype=bool)
    return d, q[:, 2][:, None] + q[:, 2][None, :], q[:, 2], eye


@pytest.mark.parametrize("name", ["rpy_rr", "rpy_cross"])
def test_unbounded_blocks_match_jax(name):
    d, _, _, eye = _pair_geometry()
    ref = getattr(jrpy, name)(jnp.asarray(d), jnp.asarray(eye))
    got = getattr(trpy, name)(torch.as_tensor(d), torch.as_tensor(eye))
    assert rel_err(got, ref) < 1e-12


@pytest.mark.parametrize("name, height", [
    ("wall_rr", "source"), ("wall_rot_force", "source"),
    ("wall_trans_torque", "target"), ("_wall_cross_core", "target")])
def test_wall_blocks_match_jax(name, height):
    d, rz, z, eye = _pair_geometry()
    h = z[:, None] if height == "target" else z[None, :]
    h = np.broadcast_to(h, rz.shape).copy()
    args = (d[..., 0], d[..., 1], rz, h)
    if name != "_wall_cross_core":
        args += (eye,)
    ref = getattr(jrpy, name)(*map(jnp.asarray, args))
    got = getattr(trpy, name)(*map(torch.as_tensor, args))
    assert rel_err(got, ref) < 1e-12


@pytest.mark.parametrize("n_rhs", [1, 2])
@pytest.mark.parametrize("domain", ["single_wall", "no_wall"])
@pytest.mark.parametrize("coupling", ["tr", "rt", "rr"])
def test_coupling_products_match_jax_generic(coupling, domain, n_rhs):
    r, _ = random_blobs()
    rng = np.random.default_rng(5)
    v = rng.normal(size=(n_rhs, r.shape[0], 3))
    ref = np.stack([np.asarray(jmob.pairwise_matvec(
        jnp.asarray(r), jnp.asarray(r), jnp.asarray(v[b]), ETA, A,
        coupling=coupling, domain=domain, method="generic"))
        for b in range(n_rhs)])
    rt = torch.as_tensor(r)
    got = tmob.pairwise_matvec_multi(rt, rt, torch.as_tensor(v), ETA, A,
                                     coupling=coupling, domain=domain)
    assert rel_err(got, ref) < 1e-12
    square = {"tr": tmob.mobility_trans_times_torque,
              "rt": tmob.mobility_rot_times_force,
              "rr": tmob.mobility_rot_times_torque}[coupling]
    assert rel_err(square(rt, torch.as_tensor(v[0]), ETA, A,
                          domain=domain), ref[0]) < 1e-12


@pytest.mark.parametrize("domain", ["single_wall", "no_wall"])
def test_grand_mobility_matches_jax(domain):
    r, f = random_blobs(n=29, seed=9)
    t = np.random.default_rng(10).normal(size=f.shape)
    u_ref, w_ref = jmob.grand_mobility_matvec(
        jnp.asarray(r), jnp.asarray(f), jnp.asarray(t), ETA, A,
        domain=domain)
    u, w = tmob.grand_mobility_matvec(
        torch.as_tensor(r), torch.as_tensor(f), torch.as_tensor(t), ETA, A,
        domain=domain)
    assert rel_err(u, u_ref) < 1e-12 and rel_err(w, w_ref) < 1e-12


@pytest.mark.parametrize("coupling, n_rhs", [
    ("tr", 1), ("tr", 2), ("rt", 1), ("rr", 1), ("rr", 2), ("grand", 1)])
@pytest.mark.parametrize("wall", [True, False])
def test_plain_k1_couplings_match_pallas_kernel_f32(coupling, n_rhs, wall):
    r, _ = random_blobs()
    nc = tpk.NCOMP[coupling]
    v = np.random.default_rng(8).normal(
        size=(r.shape[0], nc * n_rhs)).astype(np.float32)
    q = np.array(r)
    if wall:
        q[:, 2] = np.maximum(q[:, 2], A)
    q = (q / A).astype(np.float32)
    ref = np.asarray(jpk.pair_matvec_pallas(
        jnp.asarray(q), jnp.asarray(q), jnp.asarray(v), coupling=coupling,
        wall=wall, self_interaction=True, interpret=True))
    qt = torch.as_tensor(q)
    got = tpk.pair_matvec(qt, qt, torch.as_tensor(v), coupling=coupling,
                          mode=tpk.wall_mode(wall), self_interaction=True)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(to_np(got), ref,
                               atol=3e-6 * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("coupling", ["tr", "rt", "rr"])
def test_coincident_blobs_and_self_pair_other_couplings(coupling):
    """Coincident distinct blobs and blobs below a: the rr core is 1 at
    the self pair and 0 at coincident blobs, the cross core 0 at both, and
    the wall self terms stay (JAX generic engine as oracle)."""
    r = np.array([[0.0, 0.0, 0.5], [0.0, 0.0, 0.5], [0.4, 0.1, 0.2],
                  [0.9, -0.3, 0.05]])
    v = np.random.default_rng(0).normal(size=(4, 3))
    for domain in ("single_wall", "no_wall"):
        ref = jmob.pairwise_matvec(jnp.asarray(r), jnp.asarray(r),
                                   jnp.asarray(v), ETA, A, coupling=coupling,
                                   domain=domain, method="generic")
        got = tmob.pairwise_matvec(torch.as_tensor(r), torch.as_tensor(r),
                                   torch.as_tensor(v), ETA, A,
                                   coupling=coupling, domain=domain)
        assert rel_err(got, ref) < 1e-12
