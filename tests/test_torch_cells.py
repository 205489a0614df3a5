"""Linked cells and the linked-cell blob forces (kernel K5's plain
version) of the PyTorch port against the JAX package on the CPU: the
cell tables, slots and overflow counts equal JAX's exactly (an
overflowing cell included); the plain K5 in float32 matches the Pallas
cell sweep run in interpret mode to 2e-6 x max|ref|, and the neighbor-list
forces in float64 the JAX generic path to 1e-12; the capacity sizing and
the overflow count equal JAX's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rigidmultiblobswall_tpu.models import system as jsys
from rigidmultiblobswall_tpu.ops import cells as jcells
from rigidmultiblobswall_tpu.ops import forces as jforces
from rigidmultiblobswall_tpu_torch.models import system as tsys
from rigidmultiblobswall_tpu_torch.ops import cell_kernels, cells as tcells
from rigidmultiblobswall_tpu_torch.ops import forces as tforces

from torch_parity import shell_vertices, to_np

L = 10.0
FORCE_KW = dict(repulsion_strength=0.3, debye_length=0.25, blob_radius=0.2,
                periodic_length=(L, L, L), cutoff=2.0, grid_dim=16)


def _blobs(n=300, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    r = rng.uniform(-0.5 * L, 1.5 * L, (n, 3))      # wraps around the box
    r[7] = r[6]                                       # a coincident pair
    r[9] = r[8] + 0.05                                # closer than 2a
    return r.astype(dtype)


@pytest.mark.parametrize("dims, cap", [((5, 5, 5), 8), ((4, 6, 5), 3)])
def test_cell_bin_matches_jax(dims, cap):
    r = _blobs()
    pos = r - np.floor(r / L) * L
    ref = jcells.cell_bin(jnp.asarray(pos), jnp.asarray([L] * 3), dims, cap)
    got = tcells.cell_bin(torch.as_tensor(pos), (L, L, L), dims, cap)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(to_np(b), np.asarray(a))
    if cap == 3:
        assert int(got[3]) > 0                        # cells overflowed


@pytest.mark.parametrize("dims", [(4, 4, 4), (5, 4, 7)])
def test_stencil_tables_match_jax(dims):
    np.testing.assert_array_equal(to_np(tcells.neighbor_table(dims)),
                                  np.asarray(jcells.neighbor_table(dims)))
    np.testing.assert_array_equal(to_np(tcells.wrap_counts(dims)),
                                  np.asarray(jcells.wrap_counts(dims)))


def test_plain_k5_f32_matches_pallas_interpret():
    r = _blobs(seed=1, dtype=np.float32)
    kw = {k: FORCE_KW[k] for k in ("repulsion_strength", "debye_length",
                                   "blob_radius")}
    dims, cap = (5, 5, 5), 32
    ref = np.asarray(jforces._neighbor_forces_pallas(
        jnp.asarray(r), (L, L, L), dims, cap, **kw))
    got = tforces.blob_blob_forces_neighbor_list(
        torch.as_tensor(r), cell_capacity=cap, **FORCE_KW)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(to_np(got), ref, rtol=0,
                               atol=2e-6 * np.abs(ref).max())


def test_neighbor_list_forces_f64_match_jax_generic():
    r = _blobs(seed=2)
    ref = np.asarray(jforces.blob_blob_forces_neighbor_list(
        jnp.asarray(r), cell_capacity=64, **FORCE_KW))
    got = tforces.blob_blob_forces_neighbor_list(
        torch.as_tensor(r), cell_capacity=64, **FORCE_KW)
    np.testing.assert_allclose(to_np(got), ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())


def test_overflowing_cell_drops_particle_rows():
    """A particle beyond its cell's capacity is neither source nor target:
    its row is zero, and the plain sweep equals the one over the kept
    particles alone."""
    r = _blobs(seed=3)
    pos = r - np.floor(r / L) * L
    dims, cap = (5, 5, 5), 2
    table, slot, _, n_dropped = tcells.cell_bin(torch.as_tensor(pos),
                                                (L, L, L), dims, cap)
    jdrop = jcells.cell_bin(jnp.asarray(pos), jnp.asarray([L] * 3), dims,
                            cap)[3]
    assert int(n_dropped) == int(jdrop) > 0
    got = tforces.blob_blob_forces_neighbor_list(
        torch.as_tensor(r), cell_capacity=cap, **FORCE_KW)
    dropped = to_np(slot) == np.prod(dims) * cap
    assert np.all(to_np(got)[dropped] == 0.0)
    kept = ~dropped
    ref = tforces.blob_blob_forces_neighbor_list(
        torch.as_tensor(r[kept]), cell_capacity=64, **FORCE_KW)
    np.testing.assert_allclose(to_np(got)[kept], to_np(ref), rtol=0,
                               atol=1e-12 * np.abs(to_np(ref)).max())


def _systems(cap, **kw):
    t = jsys.BodyType(name="s", ref_config=shell_vertices(12, 0.5), count=1)
    js = jsys.System(types=(t,), domain="periodic_spectral",
                     periodic_length=(L, L, L),
                     blob_blob_force_method="neighbor_list",
                     blob_blob_cutoff=2.0, blob_blob_cell_capacity=cap,
                     repulsion_strength=0.3, debye_length=0.25,
                     blob_radius=0.2, **kw)
    return js, tsys.from_reference(js, device="cpu")


@pytest.mark.parametrize("cap", [8, 200])
def test_capacity_sizing_and_overflow_match_jax(cap):
    r = _blobs(600, seed=4, dtype=np.float32)
    js, ts = _systems(cap)
    jsized = jforces.auto_force_cell_capacity(js, jnp.asarray(r))
    tsized = tforces.auto_force_cell_capacity(ts, torch.as_tensor(r))
    assert tsized.blob_blob_cell_capacity == jsized.blob_blob_cell_capacity
    assert tforces.neighbor_list_overflow(ts, torch.as_tensor(r)) == int(
        jforces.neighbor_list_overflow(js, jnp.asarray(r)))
    if cap == 8:
        assert tforces.neighbor_list_overflow(ts, torch.as_tensor(r)) > 0


def test_open_boxes_and_small_boxes_raise():
    """A partly periodic box (formerly refused) gives the JAX package's
    generic linked-cell forces; a box under 4 cells falls back to the
    direct sweep; a bad launch still raises."""
    r = torch.as_tensor(_blobs(20))
    kw = dict(FORCE_KW, periodic_length=(L, L, 0.0))
    ref = np.asarray(jforces.blob_blob_forces_neighbor_list(
        jnp.asarray(r.numpy()), **kw))
    got = to_np(tforces.blob_blob_forces_neighbor_list(r, **kw))
    assert np.abs(ref).max() > 0
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()
    # a box under 4 cells of the cutoff (formerly refused) takes the
    # direct periodic sweep, as the JAX package does
    small = dict(FORCE_KW, cutoff=3.0)
    ref = np.asarray(jforces.blob_blob_forces_neighbor_list(
        jnp.asarray(r.numpy()), **small))
    got = to_np(tforces.blob_blob_forces_neighbor_list(r, **small))
    assert np.abs(ref).max() > 0
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()
    # a z extent shapes only xy-periodic wall slabs (the wall-slab branch,
    # tests/test_torch_wall_spectral.py); a periodic box ignores it, as
    # the JAX package does
    assert torch.equal(
        tforces.blob_blob_forces_neighbor_list(r, z_extent=2.0, **FORCE_KW),
        tforces.blob_blob_forces_neighbor_list(r, **FORCE_KW))
    assert tsys.System(types=(), domain="no_wall",
                       blob_blob_force_method="neighbor_list"
                       ).blob_blob_force_method == "neighbor_list"
    with pytest.raises(ValueError):
        cell_kernels.nl_forces(r.float().to("meta"), None, (4, 4, 4),
                               (L, L, L), 4, eps_over_b=1.0, inv_b=1.0,
                               two_a=1.0)
