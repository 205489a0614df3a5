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
from rigidmultiblobswall_tpu_torch.ops import pair_kernels as tpk

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
    """Zero strength gives zero forces, with or without periodic images;
    a fully periodic box takes the periodic sweep (formerly refused), the
    JAX package's own at 1e-12."""
    r = torch.as_tensor(_blobs())
    assert torch.all(tforces.blob_blob_forces(
        r, repulsion_strength=0.0) == 0)
    assert torch.all(tforces.blob_blob_forces(
        r, repulsion_strength=0.0, periodic_length=(4.0, 4.0, 4.0)) == 0)
    kw = dict(KW, periodic_length=(4.0, 4.0, 4.0))
    ref = jforces.blob_blob_forces(jnp.asarray(to_np(r)), **kw)
    assert rel_err(tforces.blob_blob_forces(r, **kw), ref) < 1e-12


# periodic cases: a large xy box (the rollers' layout, images far beyond
# the force's range) and a small one (L ~ 5 a, a long Debye length) where
# the image boxes carry a large share of the force
PERIODIC_CASES = {
    "large_xy": ((60.0, 60.0, 0.0), dict(KW)),
    "small_xy": ((1.5, 1.5, 0.0), dict(KW, debye_length=1.0)),
    "small_xyz": ((1.6, 1.4, 1.5), dict(KW, debye_length=0.8)),
}


def _periodic_blobs(L, n=37, seed=5):
    rng = np.random.default_rng(seed)
    r = rng.uniform(-0.5, 1.5, (n, 3)) * np.where(np.asarray(L) > 0, L,
                                                  4.0)
    r[7] = r[6]                      # coincident pair
    r[9] = r[8] + [L[0], 0.0, 0.0]   # a blob on another's periodic image
    return r


@pytest.mark.parametrize("case", sorted(PERIODIC_CASES))
def test_periodic_blob_blob_forces_match_jax(case):
    L, kw = PERIODIC_CASES[case]
    r = _periodic_blobs(L)
    ref = np.asarray(jforces.blob_blob_forces(jnp.asarray(r),
                                              periodic_length=L, **kw))
    got = tforces.blob_blob_forces(torch.as_tensor(r), periodic_length=L,
                                   **kw)
    assert rel_err(got, ref) < 1e-12
    # the kernel sums the home box alone only in the large box
    boxes = tmc.image_boxes(L, kw["debye_length"], kw["blob_radius"],
                            torch.float32)
    assert len(boxes) == (1 if case == "large_xy" else
                          len(tpk.box_offsets(L)))


def _home_box_sweep(r, L, kw):
    """The plain sweep's home box alone: the minimum image, no other
    box."""
    n = r.shape[0]
    d = tpk.min_image(r[:, None, :] - r[None, :, :], L)
    r2 = torch.sum(d * d, -1)
    skip = torch.eye(n, dtype=torch.bool)
    rn = torch.sqrt(torch.where(skip | (r2 == 0), 1.0, r2))
    eob, b = kw["repulsion_strength"] / kw["debye_length"], kw["debye_length"]
    two_a = 2 * kw["blob_radius"]
    mag = torch.where(rn > two_a, eob * torch.exp(-(rn - two_a) / b) / rn,
                      eob / rn)
    return torch.sum(torch.where(skip, 0.0, mag)[..., None] * d, 1)


def test_periodic_image_skip_is_exact():
    """The boxes image_boxes drops contribute exactly 0 in float32: in
    the large box the home box alone equals the sweep over all nine
    boxes bit for bit; in the small box the images change the forces."""
    for case, same in (("large_xy", True), ("small_xy", False)):
        L, kw = PERIODIC_CASES[case]
        r = torch.as_tensor(_periodic_blobs(L), dtype=torch.float32)
        full = tmc.blob_blob_forces_plain(r, periodic_length=L, **kw)
        assert torch.equal(_home_box_sweep(r, L, kw), full) == same, case


def test_periodic_forces_row_subset():
    """The plain version's `rows` option (chip_smoke's check at full size)
    computes the same rows as the full sweep."""
    L, kw = PERIODIC_CASES["small_xy"]
    r = torch.as_tensor(_periodic_blobs(L))
    full = tmc.blob_blob_forces_plain(r, periodic_length=L, **kw)
    part = tmc.blob_blob_forces_plain(r, periodic_length=L, rows=range(5, 17),
                                      **kw)
    assert torch.equal(part[5:17], full[5:17])
    assert torch.all(part[:5] == 0) and torch.all(part[17:] == 0)


def _half_box_scene(L, dtype, n_ulps=3):
    """Pairs of blobs whose x separation is half the box and a few ulps
    either way (the separations the minimum image's rounding decides),
    each beside a third blob inside 2a of the first."""
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    half = np_dtype(L[0] / 2)
    xs, up, down = [half], half, half
    for _ in range(n_ulps):
        up, down = np.nextafter(up, np_dtype(np.inf)), np.nextafter(
            down, np_dtype(0))
        xs += [up, down]
    rows = []
    for k, x in enumerate(xs):
        y = np_dtype(0.1 * k)
        rows += [(0.0, y, 1.0), (x, y, 1.0), (0.4, y + 0.1, 1.1)]
    return torch.as_tensor(np.asarray(rows, dtype=np_dtype))


def _one_box_image(d, L):
    """The one-box kernel's minimum image (csrc/blob_forces.cu
    OneBoxPairs): d - round(d (1/L)) L on each periodic axis, 1/L rounded
    to d's dtype, round to the nearest with ties to even."""
    d = d.clone()
    for axis, L_a in enumerate(L):
        if L_a > 0:
            inv_L = torch.tensor(1.0 / L_a, dtype=d.dtype)
            d[..., axis] = d[..., axis] - torch.round(
                d[..., axis] * inv_L) * L_a
    return d


def _forces_of_images(d0, L, debye_length):
    """blob_blob_forces_plain's law written out over the image boxes,
    from the home box's displacements d0 (N, N, 3) in one row tile."""
    eps_over_b = KW["repulsion_strength"] / debye_length
    two_a = 2.0 * KW["blob_radius"]
    self_pair = torch.eye(d0.shape[0], dtype=torch.bool)
    acc = torch.zeros_like(d0[:, 0])
    for box in tpk.box_offsets(L):
        home = box == (0, 0, 0)
        skip = self_pair if home else torch.zeros_like(self_pair)
        d = d0 if home else d0 + torch.as_tensor(
            box, dtype=d0.dtype) * torch.as_tensor(L, dtype=d0.dtype)
        r2 = torch.sum(d * d, dim=-1)
        rnorm = torch.sqrt(torch.where(skip | (r2 == 0.0),
                                       torch.ones_like(r2), r2))
        mag = torch.where(
            rnorm > two_a,
            eps_over_b * torch.exp(-(rnorm - two_a) / debye_length) / rnorm,
            eps_over_b / rnorm)
        mag = torch.where(skip, torch.zeros_like(mag), mag)
        acc += torch.sum(mag[..., None] * d, dim=1)
    return acc


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_one_box_minimum_image_at_half_a_box(dtype):
    """The one-box kernel's minimum image, d - round(d (1/L)) L, picks
    another image than the JAX package's d - trunc(d/L + sign(d)/2) L for
    pairs at half a box; in a box where image_boxes keeps the home box
    alone, both images of such a pair lie beyond the force's range, so
    the forces are the same bit for bit. In a small box, where every box
    is summed and the kernel keeps the division, they differ."""
    for case, (L, b) in (("one_box", ((400.0, 400.0, 0.0), 0.25)),
                         ("small", ((1.5, 1.5, 0.0), 1.0))):
        r = _half_box_scene(L, dtype)
        d = r[:, None, :] - r[None, :, :]
        picked = _one_box_image(d, L)
        assert not torch.equal(picked, tpk.min_image(d, L))
        kw = dict(KW, debye_length=b, periodic_length=L)
        boxes = tmc.image_boxes(L, b, KW["blob_radius"], dtype)
        by_division = tmc.blob_blob_forces_plain(r, **kw)
        by_reciprocal = _forces_of_images(picked, L, b)
        if case == "one_box":
            assert boxes == [(0, 0, 0)]
            assert torch.abs(by_division).max() > 0
            assert torch.equal(by_reciprocal, by_division)
        else:
            assert len(boxes) == 9
            assert torch.equal(_forces_of_images(tpk.min_image(d, L), L, b),
                               by_division)
            assert not torch.allclose(by_reciprocal, by_division)
