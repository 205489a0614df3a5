"""Linked-cell blob forces in open and partly periodic boxes (the
PyTorch port's open layout, kernel K5's open instance on the card, its
plain version here) against the JAX package's generic linked-cell path,
float64 on the CPU, on the same numpy inputs:

- the forces (blob_blob_forces_neighbor_list) to 1e-12 of max|ref| in an
  open box and in boxes periodic on one or two axes, with ample capacity
  and with a forced overflow, where a blob beyond its cell's capacity is
  dropped as a source only and keeps its own row;
- the binning (cells.open_frame, open_cell_ids, cell_members): the
  generic path's cells, a stable sort of the cell ids;
- auto_force_cell_capacity and neighbor_list_overflow (0 for the open
  layouts) equal to JAX's;
- the open instance's plain version in a fully periodic box equals the
  periodic instance's (the two frames agree where both apply);
- a forward Euler step with tree forces in a partly periodic box against
  JAX's stepper.
The CUDA instance runs only on the card (tests/test_torch_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rigidmultiblobswall_tpu.models import system as jsys
from rigidmultiblobswall_tpu.ops import forces as jforces
from rigidmultiblobswall_tpu_torch.models import system as tsys
from rigidmultiblobswall_tpu_torch.ops import cell_kernels, cells
from rigidmultiblobswall_tpu_torch.ops import forces as tforces

from torch_parity import shell_vertices, shells_scene, to_np

L = 10.0
LAW = dict(repulsion_strength=0.3, debye_length=0.25, blob_radius=0.2)
BOXES = [(0.0, 0.0, 0.0), (L, L, 0.0), (L, 0.0, L), (0.0, L, 0.0)]
BOX_IDS = ["open", "xy", "xz", "y"]


def _blobs(n=500, seed=0):
    """A slab of blobs (a monolayer-like z range) with a coincident pair
    and a pair closer than 2a; on the periodic axes some outside the
    box."""
    rng = np.random.default_rng(seed)
    r = np.empty((n, 3))
    r[:, :2] = rng.uniform(-0.3 * L, 1.3 * L, (n, 2))
    r[:, 2] = rng.uniform(0.4, 2.5, n)
    r[7] = r[6]
    r[9] = r[8] + 0.05
    return r


def _forces_both(r, L3, cap, grid_dim=8, cutoff=2.0):
    kw = dict(LAW, periodic_length=L3, cutoff=cutoff, grid_dim=grid_dim,
              cell_capacity=cap)
    ref = np.asarray(jforces.blob_blob_forces_neighbor_list(
        jnp.asarray(r), **kw))
    got = to_np(tforces.blob_blob_forces_neighbor_list(torch.as_tensor(r),
                                                       **kw))
    return got, ref


@pytest.mark.parametrize("cap", [200, 4])
@pytest.mark.parametrize("L3", BOXES, ids=BOX_IDS)
def test_forces_match_jax(L3, cap):
    """Ample capacity (200) and a forced overflow (4 a cell)."""
    r = _blobs()
    got, ref = _forces_both(r, L3, cap)
    assert np.abs(ref).max() > 0
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()
    if cap == 4:
        pos, dims, table, dropped, frame, members = (
            tforces.open_force_cells(torch.as_tensor(r), L3, 2.0, 8, cap))
        assert int(dropped) > 0
        # a dropped blob is no source but keeps its row, as on the JAX
        # package's generic path
        listed = set(int(i) for i in table if int(i) < r.shape[0])
        lost = [i for i in range(r.shape[0]) if i not in listed]
        assert len(lost) == int(dropped)
        assert np.abs(got[lost]).max() > 0


def test_binning_is_the_generic_paths():
    """Cells of edge max(extent / n, cutoff) (1 + 1e-6) from the data's
    minimum on an open axis, L / n on a periodic one, clipped; the members
    of each cell in the stable order of the cell ids."""
    r = _blobs(seed=3)
    L3, dims, rc = (L, 0.0, 0.0), (5, 8, 8), 2.0
    pos = torch.as_tensor(r).clone()
    pos[:, 0] = pos[:, 0] - torch.floor(pos[:, 0] / L) * L
    lo, edge = cells.open_frame(pos, L3, dims, rc)
    cid = cells.open_cell_ids(pos, L3, dims, lo, edge)
    x = r.copy()
    x[:, 0] = x[:, 0] - np.floor(x[:, 0] / L) * L
    want = []
    for a in range(3):
        if L3[a] > 0:
            c = np.floor(x[:, a] / (L3[a] / dims[a]))
        else:
            m = x[:, a].min()
            cs = max((x[:, a].max() - m) / dims[a], rc) * (1.0 + 1e-6)
            c = np.floor((x[:, a] - m) / cs)
        want.append(np.clip(c, 0, dims[a] - 1).astype(int))
    want = (want[0] * dims[1] + want[1]) * dims[2] + want[2]
    assert np.array_equal(to_np(cid), want)
    order, starts = cells.cell_members(cid, int(np.prod(dims)))
    assert np.array_equal(to_np(order), np.argsort(want, kind="stable"))
    assert np.array_equal(to_np(starts)[1:],
                          np.cumsum(np.bincount(want,
                                                minlength=np.prod(dims))))


def _systems(L3, cap):
    t = jsys.BodyType(name="s", ref_config=shell_vertices(12, 0.5), count=1)
    js = jsys.System(types=(t,), domain="single_wall", periodic_length=L3,
                     blob_blob_force_method="neighbor_list",
                     blob_blob_cutoff=2.0, blob_blob_grid_dim=8,
                     blob_blob_cell_capacity=cap, **LAW)
    return js, tsys.from_reference(js, device="cpu")


@pytest.mark.parametrize("cap", [8, 400])
@pytest.mark.parametrize("L3", BOXES[:2], ids=BOX_IDS[:2])
def test_capacity_sizing_and_overflow_match_jax(L3, cap):
    r = _blobs(seed=4)
    js, ts = _systems(L3, cap)
    jsized = jforces.auto_force_cell_capacity(js, jnp.asarray(r))
    tsized = tforces.auto_force_cell_capacity(ts, torch.as_tensor(r))
    assert tsized.blob_blob_cell_capacity == jsized.blob_blob_cell_capacity
    # the open layouts are not monitored (JAX returns 0); the dropped
    # count says what the binning drops
    assert tforces.neighbor_list_overflow(ts, torch.as_tensor(r)) == int(
        jforces.neighbor_list_overflow(js, jnp.asarray(r))) == 0
    dropped = tforces.force_cells_dropped(ts, torch.as_tensor(r))
    assert (dropped > 0) == (cap == 8)
    assert tforces.force_cells_dropped(tsized, torch.as_tensor(r)) == 0


def test_open_frame_in_a_periodic_box_is_the_periodic_instance():
    """The open instance's plain version with every axis periodic (its
    frame wraps them all) equals the periodic instance's plain version
    where neither drops a blob: the two frames agree where both apply."""
    r = _blobs(seed=5)
    box = (L, L, L)
    pos = torch.as_tensor(r - np.floor(r / L) * L)
    dims = (5, 5, 5)
    law = dict(eps_over_b=1.2, inv_b=4.0, two_a=0.4)
    table, _, cid, dropped = cells.cell_bin(pos, torch.as_tensor(box), dims,
                                            64)
    assert int(dropped) == 0
    lo, edge = cells.open_frame(pos, box, dims, 2.0)
    assert torch.equal(cells.open_cell_ids(pos, box, dims, lo, edge), cid)
    ref = cell_kernels.nl_forces_plain(pos, table, dims, box, 64, **law)
    got = cell_kernels.nl_forces_open_plain(
        pos, table, dims, box, cells.cell_members(cid, 125), 64, **law)
    assert torch.abs(got - ref).max() <= 1e-12 * torch.abs(ref).max()


def test_small_periodic_axis_falls_back_to_the_direct_sweep():
    """A partly periodic box under 4 cells of the cutoff takes the direct
    periodic sweep, as the JAX package does."""
    r = _blobs(n=120, seed=6)
    got, ref = _forces_both(r, (6.0, 0.0, 0.0), 32)
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()


def test_forward_euler_with_tree_forces_matches_jax():
    """Two forward Euler steps of three shells with linked-cell forces in
    an (L, L, 0) box above the wall and in an open one: positions to
    1e-9 of the displacement."""
    from rigidmultiblobswall_tpu.models import integrators as jint
    from rigidmultiblobswall_tpu_torch.models import integrators as tint

    for L3 in ((4.8, 4.8, 0.0), (0.0, 0.0, 0.0)):
        js, jst, ts, tst, _, _ = shells_scene(
            3, seed=7, periodic_length=L3,
            blob_blob_force_method="neighbor_list", blob_blob_cutoff=1.1,
            blob_blob_grid_dim=4, blob_blob_cell_capacity=64)
        jstep = jax.jit(jint.make_stepper(js, "deterministic_forward_euler",
                                          2e-3))
        jc, s = jint.init_carry(js, state=jst), jst
        tstep = tint.make_stepper(ts, "deterministic_forward_euler", 2e-3)
        tc, t = tint.init_carry(ts, state=tst), tst
        gen = torch.Generator().manual_seed(0)
        for k in range(2):
            s, jc, _ = jstep(s, jax.random.PRNGKey(k), jc)
            t, tc, _ = tstep(t, gen, tc)
        disp = np.abs(np.asarray(s.pos) - np.asarray(jst.pos)).max()
        assert disp > 1e-6
        np.testing.assert_allclose(to_np(t.pos), np.asarray(s.pos),
                                   atol=1e-9 * disp, rtol=0)
