"""The materialized mobility engine of the PyTorch port against the JAX
package, float64 on the CPU (JAX in x64): the plain versions of kernels K3
(`mobility_cuda.dense_tt_plain`) and K4 (`mobility_cuda.symm_matvec_plain`)
against JAX's row-tiled builder, its Pallas kernels in interpret mode and
its einsum, and the saddle products on the materialized engine against
the matrix-free one and against JAX's. The port's layout is the
interleaved (3N, 3N) matrix; JAX's (3,3,N,N) planes are permuted to it
(M[3i+a, 3j+b] = planes[a, b, i, j])."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rigidmultiblobswall_tpu.models import kinematics as jkin
from rigidmultiblobswall_tpu.models import saddle as jsad
from rigidmultiblobswall_tpu.ops import mobility as jmob
from rigidmultiblobswall_tpu.ops import mobility_pallas
from rigidmultiblobswall_tpu_torch.models import kinematics as tkin
from rigidmultiblobswall_tpu_torch.models import saddle as tsad
from rigidmultiblobswall_tpu_torch.ops import mobility as tmob
from rigidmultiblobswall_tpu_torch.ops import mobility_cuda as mc

from torch_parity import shells_scene, to_np

ETA, A = 0.8, 0.3
DOMAINS = ["single_wall", "no_wall"]


def _blobs(n, seed):
    """Blob positions with blobs below a, a coincident pair, and N not a
    multiple of the kernels' tiles."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(0, 4, (n, 3))
    r[:, 2] = rng.uniform(0.05, 3, n)
    r[9] = r[8]
    return r


def _interleave(planes):
    """JAX (3,3,N,N) planes -> the port's (3N, 3N) matrix."""
    p = np.asarray(planes)
    n = p.shape[2]
    return p.transpose(2, 0, 3, 1).reshape(3 * n, 3 * n)


def _max_rel(got, ref):
    got, ref = to_np(got), to_np(ref)
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("domain", DOMAINS)
@pytest.mark.parametrize("n", [100, 260])
def test_k3_plain_matches_jax_tiled(n, domain):
    r = _blobs(n, seed=n)
    ref = _interleave(jmob.dense_mobility_tiled(jnp.asarray(r), ETA, A,
                                                domain=domain))
    got = mc.dense_tt(torch.as_tensor(r), ETA, A,
                      mode=tmob.DOMAIN_MODE[domain])
    assert got.shape == (3 * n, 3 * n)
    assert _max_rel(got, ref) <= 1e-12
    # the row tiles of the plain builder do not change a bit of it
    tiled = tmob.dense_mobility_tiled(torch.as_tensor(r), ETA, A,
                                      domain=domain, row_tile=7)
    assert torch.equal(tiled, got)


@pytest.mark.parametrize("domain", DOMAINS)
def test_k3_plain_matches_jax_pallas_interpret(domain):
    """dense_tt_pallas (interpret mode) with the scaling its caller
    applies (saddle.py:130-139). The Pallas kernel computes in float32,
    so the bound is the float32 one, 3e-6 x max|ref|."""
    n = 100
    r = jnp.asarray(_blobs(n, seed=3))
    wall = domain == "single_wall"
    q = (jmob.shift_heights(r, A) if wall else r) * (1.0 / A)
    planes = mobility_pallas.dense_tt_pallas(q, q, wall=wall,
                                             self_interaction=True,
                                             interpret=True)
    planes = planes.astype(jnp.float64) / (8.0 * np.pi * ETA * A)
    if wall:
        damp = jmob.damping_factors(r, A)
        planes = planes * damp[None, None, :, None] * damp[None, None, None, :]
    got = mc.dense_tt(torch.as_tensor(np.array(r)), ETA, A,
                      mode=tmob.pair_kernels.wall_mode(wall))
    assert _max_rel(got, _interleave(planes)) <= 3e-6


@pytest.mark.parametrize("n, domain", [(100, "single_wall"), (260, "no_wall"),
                                       (256, "single_wall")])
def test_k4_plain_matches_jax_symm_planes(n, domain):
    """The full product against JAX's upper-triangle Pallas product
    (interpret mode) in float64 and float32, and against its einsum."""
    r = _blobs(n, seed=40 + n)
    v = np.random.default_rng(41).normal(size=(n, 3))
    planes = jmob.dense_mobility_tiled(jnp.asarray(r), ETA, A, domain=domain)
    m = torch.as_tensor(_interleave(planes))
    got = mc.symm_matvec(m, torch.as_tensor(v))
    ref_sym = mobility_pallas.symm_planes_matvec(planes, jnp.asarray(v),
                                                 tile=128, interpret=True)
    ref_ein = jnp.einsum("abij,jb->ia", planes, jnp.asarray(v))
    assert _max_rel(got, ref_sym) <= 1e-12
    assert _max_rel(got, ref_ein) <= 1e-12
    p32 = planes.astype(jnp.float32)
    ref32 = mobility_pallas.symm_planes_matvec(
        p32, jnp.asarray(v, jnp.float32), tile=128, interpret=True)
    got32 = mc.symm_matvec(torch.as_tensor(_interleave(p32)),
                           torch.as_tensor(v, dtype=torch.float32))
    assert _max_rel(got32, np.asarray(ref32, np.float64)) <= 3e-6


def _scene_engines(seed=10):
    js, jst, ts, tst, _, _ = shells_scene(4, seed=seed)
    r_t = tkin.blob_positions(ts, tst)
    m_t = tsad.maybe_dense_mobility(ts, r_t)
    r_j = jkin.blob_positions(js, jst)
    return js, r_j, ts, r_t, m_t


def test_mobility_apply_dense_matches_matrix_free_and_jax():
    js, r_j, ts, r_t, m_t = _scene_engines()
    assert m_t.shape == (3 * ts.num_blobs,) * 2
    v = np.random.default_rng(11).normal(size=(ts.num_blobs, 3))
    got = tsad._mobility_apply(ts, r_t, m_t, torch.as_tensor(v))
    free = tsad._mobility_apply(ts, r_t, None, torch.as_tensor(v))
    planes = jsad.maybe_dense_mobility(js, r_j)
    ref = jsad._mobility_apply(js, r_j, planes, jnp.asarray(v))
    assert _max_rel(got, free) <= 1e-12
    assert _max_rel(got, ref) <= 1e-12


def test_mobility_apply_multi_dense_matches_matrix_free_and_jax():
    js, r_j, ts, r_t, m_t = _scene_engines(seed=12)
    v = np.random.default_rng(13).normal(size=(2, ts.num_blobs, 3))
    got = tsad._mobility_apply_multi(ts, r_t, m_t, torch.as_tensor(v))
    free = tsad._mobility_apply_multi(ts, r_t, None, torch.as_tensor(v))
    planes = jsad.maybe_dense_mobility(js, r_j)
    ref = jsad._mobility_apply_multi(js, r_j, planes, jnp.asarray(v))
    assert got.shape == (2, ts.num_blobs, 3)
    assert _max_rel(got, free) <= 1e-12
    assert _max_rel(got, ref) <= 1e-12


def test_engine_choice_follows_the_budget(monkeypatch):
    """Within the budget the engine is the matrix, above it (budget 0)
    matrix-free; a refresh with build=False takes the matrix-free sweep,
    with build=True it rebuilds at the new configuration."""
    _, _, ts, r_t, m_t = _scene_engines()
    assert 9 * r_t.shape[0] ** 2 * 8 <= tsad.MATERIALIZE_BUDGET_BYTES
    assert isinstance(m_t, torch.Tensor)
    assert tsad.refresh_dense_mobility(ts, m_t, r_t, build=False) is None
    r_new = r_t + 0.01
    assert torch.equal(tsad.refresh_dense_mobility(ts, m_t, r_new),
                       mc.dense_tt(r_new, ts.eta, ts.blob_radius, mode="wall"))
    monkeypatch.setattr(tsad, "MATERIALIZE_BUDGET_BYTES", 0)
    assert tsad.maybe_dense_mobility(ts, r_t) is None


def test_plain_builder_refuses_images():
    """The image boxes and the free surface (formerly refused here) give
    JAX's component planes on the same inputs; a coupling a domain lacks
    stays refused, as JAX refuses it."""
    r = torch.as_tensor(_blobs(20, seed=1))
    for domain, box in (("single_wall", (8.0, 8.0, 0.0)),
                        ("free_surface", (0.0, 0.0, 0.0)),
                        ("free_surface", (8.0, 8.0, 0.0))):
        got = tmob.dense_mobility_tiled(r, ETA, A, domain=domain,
                                        periodic_length=box)
        planes = np.asarray(jmob.dense_mobility_tiled(
            jnp.asarray(r.numpy()), ETA, A, domain=domain,
            periodic_length=box))
        ref = planes.transpose(2, 0, 3, 1).reshape(60, 60)
        assert np.abs(to_np(got) - ref).max() <= 1e-12 * np.abs(ref).max()
    with pytest.raises(NotImplementedError, match="free_surface"):
        tmob.dense_mobility_tiled(r, ETA, A, domain="free_surface",
                                  coupling="rr")
