"""Kernel K1 path of the PyTorch port against the JAX package.

- float64: the port's mobility products (CPU tensors take K1's plain
  version) against mobility.pairwise_matvec(method="generic") at 1e-12
  relative, wall and no_wall, one and two right-hand sides;
- float32: K1's plain version against the Pallas kernel run in interpret
  mode, at the JAX package's own f32 bound (3e-6 x max|ref|,
  tests/test_pair_kernels.py).
The kernel itself runs only on the card (tests/test_torch_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rigidmultiblobswall_tpu.ops import mobility as jmob, pair_kernels as jpk
from rigidmultiblobswall_tpu_torch.ops import mobility as tmob
from rigidmultiblobswall_tpu_torch.ops import pair_kernels as tpk

from torch_parity import random_blobs, rel_err, to_np

A, ETA = 0.3, 0.9


@pytest.mark.parametrize("n_rhs", [1, 2])
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
    got = tpk.pair_tt(qt, qt, torch.as_tensor(v), wall=wall,
                      self_interaction=True)
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
    r = torch.zeros((2, 3), dtype=torch.float64)
    with pytest.raises(NotImplementedError):
        tmob.pairwise_matvec(r, r, r, 1.0, 1.0, coupling="rr")
    with pytest.raises(NotImplementedError):
        tmob.pairwise_matvec(r, r, r, 1.0, 1.0, domain="free_surface")
    with pytest.raises(NotImplementedError):
        tmob.pairwise_matvec(r, r, r, 1.0, 1.0,
                             periodic_length=(5.0, 5.0, 0.0))
