"""Parity of the PyTorch port's quaternion and rigid-body kinematics with
the JAX package, float64 on the CPU, at 1e-12."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rigidmultiblobswall_tpu.models import kinematics as jkin
from rigidmultiblobswall_tpu.ops import quaternion as jquat
from rigidmultiblobswall_tpu_torch.models import kinematics as tkin
from rigidmultiblobswall_tpu_torch.models.system import State
from rigidmultiblobswall_tpu_torch.ops import quaternion as tquat

from torch_parity import shells_scene, to_np

TOL = 1e-12


def _quats(n=9, seed=3):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=1, keepdims=True)


@pytest.mark.parametrize("name", ["multiply", "rotation_matrix", "rotate",
                                  "from_rotation", "to_rotation_vector",
                                  "step", "inverse"])
def test_quaternion_ops_match_jax(name):
    rng = np.random.default_rng(5)
    q, r = _quats(9, 1), _quats(9, 2)
    x = rng.normal(size=(9, 3))
    # one zero rotation vector exercises the smooth phi = 0 branch
    phi = np.concatenate([np.zeros((1, 3)), rng.normal(size=(8, 3))])
    args = {"multiply": (q, r), "rotation_matrix": (q,), "rotate": (q, x),
            "from_rotation": (phi,), "to_rotation_vector": (q,),
            "step": (q, phi, 0.3), "inverse": (q,)}[name]
    ref = getattr(jquat, name)(*[jnp.asarray(a) if isinstance(a, np.ndarray)
                                 else a for a in args])
    got = getattr(tquat, name)(*[torch.as_tensor(a) if isinstance(
        a, np.ndarray) else a for a in args])
    np.testing.assert_allclose(to_np(got), np.asarray(ref), rtol=0,
                               atol=TOL)


def test_identity_and_normalize():
    q = tquat.identity((2, 3))
    assert q.shape == (2, 3, 4) and torch.all(q[..., 0] == 1.0)
    v = torch.as_tensor(np.random.default_rng(0).normal(size=(5, 4)))
    np.testing.assert_allclose(
        to_np(tquat.normalize(v)), np.asarray(jquat.normalize(v.numpy())),
        atol=TOL)


def test_blob_positions_and_K_products_match_jax():
    js, jst, ts, tst, _, _ = shells_scene(4, seed=2)
    rng = np.random.default_rng(9)
    U = rng.normal(size=(ts.num_bodies, 6))
    lam = rng.normal(size=(ts.num_blobs, 3))
    np.testing.assert_allclose(to_np(tkin.blob_positions(ts, tst)),
                               np.asarray(jkin.blob_positions(js, jst)),
                               atol=TOL)
    np.testing.assert_allclose(
        to_np(tkin.K_mul(ts, tst, torch.as_tensor(U))),
        np.asarray(jkin.K_mul(js, jst, jnp.asarray(U))), atol=TOL)
    np.testing.assert_allclose(
        to_np(tkin.KT_mul(ts, tst, torch.as_tensor(lam))),
        np.asarray(jkin.KT_mul(js, jst, jnp.asarray(lam))), atol=TOL)
    np.testing.assert_allclose(to_np(tkin.K_dense(ts, tst, 0)),
                               np.asarray(jkin.K_dense(js, jst, 0)),
                               atol=TOL)


def test_batched_K_products_match_per_rhs():
    """Stacked right-hand sides (the lockstep operator) give the per-RHS
    products."""
    _, _, ts, tst, _, _ = shells_scene(3, seed=4)
    rng = np.random.default_rng(1)
    U = torch.as_tensor(rng.normal(size=(2, ts.num_bodies, 6)))
    lam = torch.as_tensor(rng.normal(size=(2, ts.num_blobs, 3)))
    for b in range(2):
        np.testing.assert_allclose(to_np(tkin.K_mul(ts, tst, U)[b]),
                                   to_np(tkin.K_mul(ts, tst, U[b])),
                                   atol=TOL)
        np.testing.assert_allclose(to_np(tkin.KT_mul(ts, tst, lam)[b]),
                                   to_np(tkin.KT_mul(ts, tst, lam[b])),
                                   atol=TOL)


@pytest.mark.parametrize("dz", [0.0, -0.6])
def test_advance_and_valid_configuration_match_jax(dz):
    js, jst, ts, tst, _, _ = shells_scene(3, seed=6)
    rng = np.random.default_rng(2)
    vel = rng.normal(size=(3, 6))
    vel[:, 2] += dz / 0.1
    jnew = jkin.advance(jst, jnp.asarray(vel), 0.1)
    tnew = tkin.advance(tst, torch.as_tensor(vel), 0.1)
    np.testing.assert_allclose(to_np(tnew.pos), np.asarray(jnew.pos),
                               atol=TOL)
    np.testing.assert_allclose(to_np(tnew.quat), np.asarray(jnew.quat),
                               atol=TOL)
    valid = tkin.valid_configuration(ts, tnew)
    assert valid == bool(jkin.valid_configuration(js, jnew))
    assert valid == (dz == 0.0)
    assert isinstance(tnew, State)
