"""Kernel K2 path of the PyTorch port (blob forces) against the JAX
package: float64 at 1e-12 against the generic sweep, float32 against the
Pallas force kernel in interpret mode at 3e-6 x max|ref|."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rigidmultiblobswall_tpu.ops import forces as jforces
from rigidmultiblobswall_tpu.ops import mobility_pallas as jmp
from rigidmultiblobswall_tpu_torch.ops import forces as tforces
from rigidmultiblobswall_tpu_torch.ops import mobility_cuda as tmc

from torch_parity import random_blobs, rel_err, to_np

KW = dict(repulsion_strength=0.7, debye_length=0.25, blob_radius=0.3)


def _blobs(n=41, seed=11):
    r, _ = random_blobs(n=n, seed=seed)
    r[5] = r[4]  # coincident pair: contributes nothing
    return r


def test_blob_blob_forces_match_jax_generic():
    r = _blobs()
    ref = jforces.blob_blob_forces(jnp.asarray(r), **KW)
    got = tforces.blob_blob_forces(torch.as_tensor(r), **KW)
    assert rel_err(got, ref) < 1e-12


def test_plain_k2_matches_pallas_kernel_f32():
    r = _blobs().astype(np.float32)
    ref = np.asarray(jmp.blob_blob_forces_pallas(jnp.asarray(r),
                                                 interpret=True, **KW))
    got = tmc.blob_blob_forces(torch.as_tensor(r), **KW)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(to_np(got), ref,
                               atol=3e-6 * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("g, eps_wall", [(0.1, 0.2), (0.0, 0.0)])
def test_blob_external_forces_match_jax(g, eps_wall):
    r = _blobs()
    kw = dict(g=g, blob_radius=0.3, repulsion_strength_wall=eps_wall,
              debye_length_wall=0.2)
    ref = np.asarray(jforces.blob_external_forces(jnp.asarray(r), **kw))
    got = to_np(tforces.blob_external_forces(torch.as_tensor(r), **kw))
    np.testing.assert_allclose(got, ref, atol=1e-12 * max(
        np.abs(ref).max(), 1.0), rtol=0)


def test_zero_strength_and_periodic():
    r = torch.as_tensor(_blobs())
    assert torch.all(tforces.blob_blob_forces(
        r, repulsion_strength=0.0) == 0)
    with pytest.raises(NotImplementedError):
        tforces.blob_blob_forces(r, repulsion_strength=1.0,
                                 periodic_length=(4.0, 4.0, 4.0))
