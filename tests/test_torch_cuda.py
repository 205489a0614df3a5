"""Hand-written CUDA kernels K1 and K2 against their plain PyTorch
versions, on the card. Every test here is marked `gpu` and skips when no
CUDA device is present. The file imports no JAX, so the machine with the
card runs it without the repository's JAX conftest:

    python -m pytest --noconftest -q -m gpu tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from rigidmultiblobswall_tpu_torch.ops import mobility_cuda as mc
from rigidmultiblobswall_tpu_torch.ops import pair_kernels as pk

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _scene(n, seed=0, a=0.3):
    rng = np.random.default_rng(seed)
    r = np.empty((n, 3))
    r[:, :2] = rng.uniform(0, 20, (n, 2))
    r[:, 2] = rng.uniform(0.05, 4, n)   # includes blobs below a
    q = r.copy()
    q[:, 2] = np.maximum(q[:, 2], a)
    return r, q / a


@pytest.mark.parametrize("dtype, bound", [(torch.float32, 3e-6),
                                          (torch.float64, 1e-12)])
@pytest.mark.parametrize("n_rhs", [1, 2])
@pytest.mark.parametrize("wall", [True, False])
def test_k1_matches_plain(cuda, wall, n_rhs, dtype, bound):
    r, q = _scene(1000)
    q = q if wall else r / 0.3
    v = np.random.default_rng(1).normal(size=(1000, 3 * n_rhs))
    qt = torch.as_tensor(q, dtype=dtype, device=cuda)
    vt = torch.as_tensor(v, dtype=dtype, device=cuda)
    before = pk.LAUNCHES
    got = pk.pair_tt(qt, qt, vt, wall=wall, self_interaction=True)
    torch.cuda.synchronize()
    assert pk.LAUNCHES > before
    ref = pk.pair_tt_plain(qt.double(), qt.double(), vt.double(), wall=wall,
                           self_interaction=True)
    err = (got.double() - ref).abs().max().item()
    assert err <= bound * ref.abs().max().item()


def test_k1_ragged_source_target(cuda):
    _, q = _scene(300, seed=2)
    qt = torch.as_tensor(q, device=cuda)
    v = torch.randn(300, 3, dtype=torch.float64, device=cuda)
    got = pk.pair_tt(qt, qt[:77].contiguous(), v, wall=True,
                     self_interaction=False)
    ref = pk.pair_tt_plain(qt, qt[:77], v, wall=True,
                           self_interaction=False)
    assert (got - ref).abs().max().item() <= 1e-12 * ref.abs().max().item()


@pytest.mark.parametrize("dtype, bound", [(torch.float32, 3e-6),
                                          (torch.float64, 1e-12)])
def test_k2_matches_plain(cuda, dtype, bound):
    r, _ = _scene(1500, seed=3)
    r[7] = r[6]
    rt = torch.as_tensor(r, dtype=dtype, device=cuda)
    kw = dict(repulsion_strength=0.7, debye_length=0.25, blob_radius=0.3)
    before = mc.LAUNCHES
    got = mc.blob_blob_forces(rt, **kw)
    torch.cuda.synchronize()
    assert mc.LAUNCHES == before + 1
    ref = mc.blob_blob_forces_plain(rt.double(), **kw)
    err = (got.double() - ref).abs().max().item()
    assert err <= bound * ref.abs().max().item()


def test_wrappers_reject_bad_input(cuda):
    q = torch.zeros((4, 3), device=cuda)
    with pytest.raises(ValueError):
        pk.pair_tt(q, q, torch.zeros((4, 3), device=cuda).t(), wall=True,
                   self_interaction=True)
    with pytest.raises(ValueError):
        pk.pair_tt(q, q, q.double(), wall=True, self_interaction=True)
    with pytest.raises(ValueError):
        pk.pair_tt(q, q, torch.zeros((4, 9), device=cuda), wall=True,
                   self_interaction=True)
    with pytest.raises(TypeError):
        mc.blob_blob_forces(q.half(), repulsion_strength=1.0,
                            debye_length=1.0, blob_radius=1.0)
