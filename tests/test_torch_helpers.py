"""Public helpers of the JAX package that the port now has too, each
against the JAX package's: io/scene.read_velocity_file, the dense
ops/mobility.rotne_prager_tensor and single_wall_fluid_mobility,
single_wall_self_mobility_with_rotation, the available_schemes of
models/integrators and models/rollers, and models/saddle.num_constraints
(float64 on the CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rigidmultiblobswall_tpu.io import scene as jscene
from rigidmultiblobswall_tpu.models import integrators as jint
from rigidmultiblobswall_tpu.models import rollers as jrol
from rigidmultiblobswall_tpu.models import saddle as jsaddle
from rigidmultiblobswall_tpu.ops import mobility as jmob
from rigidmultiblobswall_tpu_torch.io import scene as tscene
from rigidmultiblobswall_tpu_torch.models import integrators as tint
from rigidmultiblobswall_tpu_torch.models import rollers as trol
from rigidmultiblobswall_tpu_torch.models import saddle as tsaddle
from rigidmultiblobswall_tpu_torch.ops import mobility as tmob

from torch_parity import random_blobs, rel_err, shells_scene


def test_read_velocity_file_matches_jax(tmp_path):
    """Comments, blank lines, extra columns and rows past the count are
    read as the JAX package reads them."""
    rng = np.random.default_rng(0)
    v = rng.normal(size=(4, 7))
    with open(tmp_path / "v.dat", "w") as f:
        f.write("3  # bodies\n\n")
        for row in v:
            f.write(" ".join("%.17g" % x for x in row) + "\n")
    got = tscene.read_velocity_file(str(tmp_path / "v.dat"))
    ref = jscene.read_velocity_file(str(tmp_path / "v.dat"))
    assert got.shape == ref.shape == (3, 6)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("name", ["rotne_prager_tensor",
                                  "single_wall_fluid_mobility"])
def test_dense_mobilities_match_jax(name):
    r, _ = random_blobs(n=23, seed=4)
    r[3] = r[2]
    ref = np.asarray(getattr(jmob, name)(jnp.asarray(r), 0.9, 0.3))
    got = getattr(tmob, name)(torch.as_tensor(r), 0.9, 0.3)
    assert got.shape == ref.shape == (69, 69)
    assert rel_err(got, ref) < 1e-12


def test_single_wall_self_mobility_with_rotation_matches_jax():
    h = np.array([0.1, 0.3, 0.31, 1.0, 2.5, 10.0])
    ref = np.asarray(jmob.single_wall_self_mobility_with_rotation(
        jnp.asarray(h), 0.9, 0.3))
    got = tmob.single_wall_self_mobility_with_rotation(torch.as_tensor(h),
                                                       0.9, 0.3)
    assert got.shape == ref.shape == (6, 6, 6)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-14, atol=1e-15)
    one = tmob.single_wall_self_mobility_with_rotation(2.5, 0.9, 0.3)
    assert torch.equal(one, got[4])


@pytest.mark.parametrize("pair", ["integrators", "rollers"])
def test_available_schemes_match_jax(pair):
    jmod, tmod = {"integrators": (jint, tint), "rollers": (jrol, trol)}[pair]
    assert tmod.available_schemes() == tuple(tmod._SCHEMES)
    assert set(tmod.available_schemes()) == set(jmod.available_schemes())


def test_num_constraints_matches_jax():
    """No constraint in a free system; the articulated systems' count is
    held against JAX in tests/test_torch_articulated.py, and here the
    saddle module's name against the articulated module's."""
    js, _, ts, _, _, _ = shells_scene()
    assert tsaddle.num_constraints(ts) == jsaddle.num_constraints(js) == 0
    from test_torch_articulated import chain_scene

    js, _, ts, _ = chain_scene()[:4]
    assert tsaddle.num_constraints(ts) == jsaddle.num_constraints(js) > 0
    assert tsaddle.saddle_size(ts) == jsaddle.saddle_size(js)
