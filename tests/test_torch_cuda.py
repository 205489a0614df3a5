"""Hand-written CUDA kernels K1 (every coupling) and K2 against their
plain PyTorch versions, on the card. Every test here is marked `gpu` and
skips when no CUDA device is present. The file imports no JAX, so the
machine with the card runs it without the repository's JAX conftest:

    python -m pytest --noconftest -q -m gpu tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from rigidmultiblobswall_tpu_torch.ops import mobility_cuda as mc
from rigidmultiblobswall_tpu_torch.ops import pair_kernels as pk

pytestmark = pytest.mark.gpu

# (coupling, B) of every K1 template instance
INSTANCES = [("tt", 1), ("tt", 2), ("tr", 1), ("tr", 2), ("rt", 1),
             ("rr", 1), ("rr", 2), ("grand", 1)]


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


def _k1_vs_plain(cuda, coupling, n_rhs, wall, dtype, q_src, q_tgt,
                 self_interaction):
    nc = pk.NCOMP[coupling]
    v = np.random.default_rng(1).normal(size=(q_src.shape[0], nc * n_rhs))
    qs = torch.as_tensor(q_src, dtype=dtype, device=cuda)
    qt = torch.as_tensor(q_tgt, dtype=dtype, device=cuda)
    vt = torch.as_tensor(v, dtype=dtype, device=cuda)
    before = pk.LAUNCHES[coupling]
    got = pk.pair_matvec(qs, qt, vt, coupling=coupling, wall=wall,
                         self_interaction=self_interaction)
    torch.cuda.synchronize()
    assert pk.LAUNCHES[coupling] == before + 1
    ref = pk.pair_plain(qs.double(), qt.double(), vt.double(),
                        coupling=coupling, wall=wall,
                        self_interaction=self_interaction)
    assert got.shape == ref.shape
    return (got.double() - ref).abs().max().item() / ref.abs().max().item()


@pytest.mark.parametrize("dtype, bound", [(torch.float32, 3e-6),
                                          (torch.float64, 1e-12)])
@pytest.mark.parametrize("n_rhs", [1, 2])
@pytest.mark.parametrize("wall", [True, False])
def test_k1_matches_plain(cuda, wall, n_rhs, dtype, bound):
    r, q = _scene(1000)
    q = q if wall else r / 0.3
    assert _k1_vs_plain(cuda, "tt", n_rhs, wall, dtype, q, q, True) <= bound


@pytest.mark.parametrize("dtype, bound", [(torch.float32, 3e-6),
                                          (torch.float64, 1e-12)])
@pytest.mark.parametrize("wall", [True, False])
@pytest.mark.parametrize("coupling, n_rhs",
                         [i for i in INSTANCES if i[0] != "tt"])
def test_k1_couplings_match_plain(cuda, coupling, n_rhs, wall, dtype,
                                  bound):
    r, q = _scene(1000, seed=4)
    q = q if wall else r / 0.3
    q[5] = q[4]                          # coincident distinct blobs
    assert _k1_vs_plain(cuda, coupling, n_rhs, wall, dtype, q, q,
                        True) <= bound


def test_k1_ragged_source_target(cuda):
    _, q = _scene(300, seed=2)
    qt = torch.as_tensor(q, device=cuda)
    v = torch.randn(300, 3, dtype=torch.float64, device=cuda)
    got = pk.pair_matvec(qt, qt[:77].contiguous(), v, coupling="tt",
                         wall=True, self_interaction=False)
    ref = pk.pair_plain(qt, qt[:77], v, coupling="tt", wall=True,
                        self_interaction=False)
    assert (got - ref).abs().max().item() <= 1e-12 * ref.abs().max().item()


@pytest.mark.parametrize("coupling, n_rhs",
                         [i for i in INSTANCES if i[0] != "tt"])
def test_k1_couplings_ragged_source_target(cuda, coupling, n_rhs):
    """Target and source counts that are not multiples of the 128-row
    tile, without the self pair."""
    _, q = _scene(301, seed=3)
    assert _k1_vs_plain(cuda, coupling, n_rhs, True, torch.float64, q,
                        q[:77], False) <= 1e-12


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
        pk.pair_matvec(q, q, torch.zeros((4, 3), device=cuda).t(),
                       coupling="tt", wall=True, self_interaction=True)
    with pytest.raises(ValueError):
        pk.pair_matvec(q, q, q.double(), coupling="tt", wall=True,
                       self_interaction=True)
    with pytest.raises(ValueError):
        pk.pair_matvec(q, q, torch.zeros((4, 9), device=cuda),
                       coupling="tt", wall=True, self_interaction=True)
    with pytest.raises(TypeError):
        mc.blob_blob_forces(q.half(), repulsion_strength=1.0,
                            debye_length=1.0, blob_radius=1.0)


@pytest.mark.parametrize("coupling", ["tr", "rt", "rr", "grand"])
def test_k1_coupling_wrappers_reject_bad_input(cuda, coupling):
    q = torch.zeros((4, 3), device=cuda)
    nc = pk.NCOMP[coupling]
    too_many = pk.MAX_RHS[coupling] + 1
    bad = [torch.zeros((4, nc * too_many), device=cuda),   # B not built
           torch.zeros((4, nc + 1), device=cuda),          # ragged columns
           torch.zeros((5, nc), device=cuda),              # rows != Ns
           torch.zeros((nc, 4), device=cuda).t()]          # not contiguous
    for vec in bad:
        with pytest.raises(ValueError):
            pk.pair_matvec(q, q, vec, coupling=coupling, wall=True,
                           self_interaction=True)
    with pytest.raises(TypeError):
        pk.pair_matvec(q.half(), q.half(),
                       torch.zeros((4, nc), device=cuda).half(),
                       coupling=coupling, wall=True, self_interaction=True)
