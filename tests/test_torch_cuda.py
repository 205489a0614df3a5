"""Hand-written CUDA kernels K1 (every coupling, open and on the
pseudo-periodic image boxes), K2 (open and periodic), K3 (open and on the
image boxes), K4, K5, K6, K7, K8, L1 (every Laplace operator) and M1 (the MCMC pair
energy, both mask flavours, batches, its small-configuration instance)
against their plain PyTorch versions, on the card, and the 16-sphere
lubrication step on K1 grand and K2 and an MCMC chain on M1 against the
CPU; P1 (the radii pair product) and P2 (the mixed-radii near field: its
pair list and the list product) against theirs. Every test here is
marked `gpu` and skips when no CUDA device is present. The file imports no JAX, so the
machine with the card runs it without the repository's JAX conftest:

    python -m pytest --noconftest -q -m gpu tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from rigidmultiblobswall_tpu_torch.ops import cell_kernels as ck
from rigidmultiblobswall_tpu_torch.ops import cells, ewald
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
    before = pk.launches(coupling)
    got = pk.pair_matvec(qs, qt, vt, coupling=coupling,
                         mode=pk.wall_mode(wall),
                         self_interaction=self_interaction)
    torch.cuda.synchronize()
    assert pk.launches(coupling) == before + 1
    ref = pk.pair_plain(qs.double(), qt.double(), vt.double(),
                        coupling=coupling, mode=pk.wall_mode(wall),
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


@pytest.mark.parametrize("dtype, bound", [(torch.float32, 3e-6),
                                          (torch.float64, 1e-12)])
def test_pairwise_matvec_multi_six_columns(cuda, dtype, bound):
    """A stack of 6 right-hand sides (a Krylov recycle refresh's k
    columns) runs as three K1 tt B = 2 launches, in order, and equals the
    plain version column by column."""
    from rigidmultiblobswall_tpu_torch.ops import mobility as mob

    r, _ = _scene(1000)
    v = np.random.default_rng(2).normal(size=(6, 1000, 3))
    rt = torch.as_tensor(r, dtype=dtype, device=cuda)
    vt = torch.as_tensor(v, dtype=dtype, device=cuda)
    before = dict(pk.LAUNCHES)
    got = mob.pairwise_matvec_multi(rt, None, vt, 1.0, 0.3)
    torch.cuda.synchronize()
    assert pk.LAUNCHES["tt", 2] == before["tt", 2] + 3
    assert pk.LAUNCHES["tt", 1] == before["tt", 1]
    ref = mob.pairwise_matvec_multi(rt.double().cpu(), None,
                                    vt.double().cpu(), 1.0, 0.3)
    assert got.shape == (6, 1000, 3)
    assert ((got.double().cpu() - ref).abs().max() / ref.abs().max()
            <= bound)


def test_k1_ragged_source_target(cuda):
    _, q = _scene(300, seed=2)
    qt = torch.as_tensor(q, device=cuda)
    v = torch.randn(300, 3, dtype=torch.float64, device=cuda)
    got = pk.pair_matvec(qt, qt[:77].contiguous(), v, coupling="tt",
                         mode="wall", self_interaction=False)
    ref = pk.pair_plain(qt, qt[:77], v, coupling="tt", mode="wall",
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


def _k1_rel(cuda, coupling, n_rhs, dtype, q_src, q_tgt, square, sub=None,
            self_interaction=True, wall=True, seed=1):
    """K1 (square: the call with q_tgt None) against its plain version in
    float64 on the first `sub` target rows."""
    nc = pk.NCOMP[coupling]
    v = np.random.default_rng(seed).normal(size=(q_src.shape[0], nc * n_rhs))
    qs = torch.as_tensor(q_src, dtype=dtype, device=cuda)
    qt = torch.as_tensor(q_tgt, dtype=dtype, device=cuda)
    vt = torch.as_tensor(v, dtype=dtype, device=cuda)
    kw = dict(coupling=coupling, mode=pk.wall_mode(wall),
              self_interaction=self_interaction)
    got = pk.pair_matvec(qs, None if square else qt, vt, **kw)
    torch.cuda.synchronize()
    sub = qt.shape[0] if sub is None else sub
    ref = pk.pair_plain(qs.double(), qt[:sub].double(), vt.double(), **kw)
    return ((got[:sub].double() - ref).abs().max().item()
            / ref.abs().max().item())


def _plan(cuda, coupling, n_rhs, dtype, n_src, n_tgt):
    q = torch.ones((n_src, 3), dtype=dtype, device=cuda)
    v = torch.ones((n_src, pk.NCOMP[coupling] * n_rhs), dtype=dtype,
                   device=cuda)
    return pk.launch_plan(coupling, q, q[:n_tgt], v, mode="wall")


@pytest.mark.parametrize("dtype, bound", [(torch.float32, 3e-6),
                                          (torch.float64, 1e-12)])
@pytest.mark.parametrize("square", [False, True])
@pytest.mark.parametrize("n, n_slices", [(77, 1), (384, 3), (1000, 8)])
@pytest.mark.parametrize("coupling, n_rhs", INSTANCES)
def test_k1_instances_across_slices(cuda, coupling, n_rhs, n, n_slices,
                                    square, dtype, bound):
    """Every K1 instance with N below one tile, on slice edges (384
    sources in three one-tile slices) and off them (1000 in eight, 104 in
    the last), self_interaction across slices, blobs below a (heights
    exactly a after the shift) and a coincident pair; the square call
    (the symmetric sweep) and the call with two tensors (the sliced
    sweep)."""
    _, q = _scene(n, seed=9)
    q[5] = q[4]
    assert _plan(cuda, coupling, n_rhs, dtype, n, n)[0] == n_slices
    assert _k1_rel(cuda, coupling, n_rhs, dtype, q, q, square) <= bound


@pytest.mark.parametrize("dtype, bound", [(torch.float32, 3e-6),
                                          (torch.float64, 1e-12)])
@pytest.mark.parametrize("coupling, n_rhs", INSTANCES)
def test_k1_slices_of_several_tiles(cuda, coupling, n_rhs, dtype, bound):
    """17,000 blobs, the sliced sweep: slices of several tiles, the last
    ragged, self pairs across slices."""
    _, q = _scene(17000, seed=6, a=0.05)
    n_slices, tiles = _plan(cuda, coupling, n_rhs, dtype, 17000, 17000)
    assert n_slices > 1 and tiles > 1
    assert _k1_rel(cuda, coupling, n_rhs, dtype, q, q, False,
                   sub=256) <= bound


@pytest.mark.parametrize("coupling, n_rhs", INSTANCES)
def test_k1_ragged_across_slices(cuda, coupling, n_rhs):
    """Nt != Ns, neither a multiple of the tile, sources in three
    slices."""
    _, q = _scene(301, seed=3)
    assert _plan(cuda, coupling, n_rhs, torch.float64, 301, 77)[0] == 3
    assert _k1_rel(cuda, coupling, n_rhs, torch.float64, q, q[:77],
                   False) <= 1e-12


@pytest.mark.parametrize("coupling", ["tt", "tr", "rt", "rr", "grand"])
def test_k1_bit_identical_on_repeat(cuda, coupling):
    """17,000 blobs, square: the symmetric sweep (groups of two tiles)
    and the sliced sweep sum their slices in a fixed order, so two
    launches of each agree bit for bit; the two sweeps agree within the
    f32 bound."""
    _, q = _scene(17000, seed=5, a=0.05)
    qt = torch.as_tensor(q, dtype=torch.float32, device=cuda)
    vt = torch.randn((17000, pk.NCOMP[coupling]), device=cuda,
                     generator=torch.Generator(device=cuda).manual_seed(3))
    kw = dict(coupling=coupling, mode="wall", self_interaction=True)
    a = pk.pair_matvec(qt, None, vt, **kw)
    b = pk.pair_matvec(qt, None, vt, **kw)
    sliced = pk.pair_matvec(qt, qt, vt, **kw)
    again = pk.pair_matvec(qt, qt, vt, **kw)
    assert torch.equal(a, b) and torch.equal(sliced, again)
    assert (a - sliced).abs().max().item() <= (
        3e-6 * sliced.abs().max().item())


@pytest.mark.parametrize("dtype, bound", [(torch.float32, 3e-6),
                                          (torch.float64, 1e-12)])
@pytest.mark.parametrize("self_interaction", [True, False])
@pytest.mark.parametrize("wall", [True, False])
@pytest.mark.parametrize("n", [77, 128, 300, 1000, 17000])
@pytest.mark.parametrize("coupling, n_rhs", INSTANCES)
def test_k1_symmetric_sweep(cuda, coupling, n_rhs, n, wall, self_interaction,
                            dtype, bound):
    """The square products (q_tgt None) of every coupling and B on the
    symmetric sweep: N below a tile, on a tile edge and off it, and 17,000 blobs in
    groups of two tiles (the last group one tile, ragged); blobs below
    a, a coincident pair in the same tile and one across tiles; with and
    without self pairs; against the plain version on the first 512
    targets, and against the sliced sweep on all."""
    r, q = _scene(n, seed=11, a=0.3 if n < 10000 else 0.05)
    q = q if wall else r / 0.3
    q[5] = q[4]
    q[n - 1] = q[3]
    if n == 17000:
        n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
        assert pk.plan_groups(n, n_sm)[1] > 1
    qt = torch.as_tensor(q, dtype=dtype, device=cuda)
    v = np.random.default_rng(2).normal(size=(n, pk.NCOMP[coupling] * n_rhs))
    vt = torch.as_tensor(v, dtype=dtype, device=cuda)
    kw = dict(coupling=coupling, mode=pk.wall_mode(wall),
              self_interaction=self_interaction)
    before = pk.LAUNCHES[coupling, n_rhs]
    sym_before = pk.SYM_LAUNCHES[coupling, n_rhs]
    got = pk.pair_matvec(qt, None, vt, **kw)
    sliced = pk.pair_matvec(qt, qt, vt, **kw)
    torch.cuda.synchronize()
    assert pk.LAUNCHES[coupling, n_rhs] == before + 2
    assert pk.SYM_LAUNCHES[coupling, n_rhs] == sym_before + 1
    sub = min(n, 512)
    ref = pk.pair_plain(qt.double(), qt[:sub].double(), vt.double(), **kw)
    scale = ref.abs().max().item()
    assert (got[:sub].double() - ref).abs().max().item() <= bound * scale
    scale = sliced.double().abs().max().item()
    assert (got.double() - sliced.double()).abs().max().item() <= (
        bound * scale)


def test_k1_never_takes_the_plain_path(cuda, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("pair_plain called for a CUDA tensor")

    monkeypatch.setattr(pk, "pair_plain", refuse)
    q = torch.rand((300, 3), device=cuda) * 10 + 1
    for coupling, n_rhs in INSTANCES:
        v = torch.rand((300, pk.NCOMP[coupling] * n_rhs), device=cuda)
        for q_tgt in (q, None):
            pk.pair_matvec(q, q_tgt, v, coupling=coupling, mode="wall",
                           self_interaction=True)
    torch.cuda.synchronize()


# the image boxes of K1 and K3: (wall, box in units of a) above the wall
# periodic in x and y (9 boxes), and without it periodic on all three
# axes (27 boxes); the scenes span about twice the box
IMAGE_BOXES = [(True, (23.0, 19.0, 0.0)), (False, (23.0, 19.0, 21.0))]


def _image_scene(n, seed=0, a=0.3):
    """_scene spread over [0, 40] a in x and y (the boxes' images of every
    pair in play), a coincident pair."""
    rng = np.random.default_rng(seed)
    r = np.empty((n, 3))
    r[:, :2] = rng.uniform(0, 12, (n, 2))
    r[:, 2] = rng.uniform(0.05, 4, n)
    if n > 5:
        r[5] = r[4]
    q = r.copy()
    q[:, 2] = np.maximum(q[:, 2], a)
    return r, q / a


@pytest.mark.parametrize("dtype, bound", [(torch.float32, 3e-6),
                                          (torch.float64, 1e-12)])
@pytest.mark.parametrize("square", [True, False])
@pytest.mark.parametrize("wall, L", IMAGE_BOXES)
@pytest.mark.parametrize("n", [2, 300])
@pytest.mark.parametrize("coupling, n_rhs", INSTANCES)
def test_k1_image_boxes_match_plain(cuda, coupling, n_rhs, n, wall, L,
                                    square, dtype, bound):
    """Every K1 instance's image-box instance, on the symmetric sweep (the
    square call) and the sliced sweep: two blobs (one tile: the self
    blocks and each blob's own images in the diagonal pass) and 300
    (ragged tiles, a coincident pair), against the
    plain version in float64, counted in IMAGE_LAUNCHES and not in
    LAUNCHES."""
    r, q = _image_scene(n, seed=21)
    q = q if wall else r / 0.3
    boxes = (L, pk.box_offsets(L))
    nc = pk.NCOMP[coupling]
    v = np.random.default_rng(22).normal(size=(n, nc * n_rhs))
    qt = torch.as_tensor(q, dtype=dtype, device=cuda)
    vt = torch.as_tensor(v, dtype=dtype, device=cuda)
    kw = dict(coupling=coupling, mode=pk.wall_mode(wall),
              self_interaction=True,
              boxes=boxes)
    sweep = "sym" if square else "sliced"
    before, open_before = dict(pk.IMAGE_LAUNCHES), dict(pk.LAUNCHES)
    got = pk.pair_matvec(qt, None if square else qt, vt, **kw)
    torch.cuda.synchronize()
    assert (pk.IMAGE_LAUNCHES[coupling, n_rhs, sweep]
            == before[coupling, n_rhs, sweep] + 1)
    assert pk.LAUNCHES == open_before
    ref = pk.pair_plain(qt.double(), qt.double(), vt.double(), **kw)
    scale = ref.abs().max().item()
    assert (got.double() - ref).abs().max().item() <= bound * scale
    # the images matter
    plain_open = pk.pair_plain(qt.double(), qt.double(), vt.double(),
                               **dict(kw, boxes=None))
    assert (plain_open - ref).abs().max().item() > 1e-3 * scale


@pytest.mark.parametrize("coupling, n_rhs", [("tt", 1), ("tt", 2),
                                             ("grand", 1), ("tr", 2),
                                             ("rr", 1), ("rr", 2)])
def test_k1_image_boxes_groups_and_repeat(cuda, coupling, n_rhs):
    """17,000 blobs in an (L, L, 0) box: the symmetric sweep in groups of
    several tiles and the sliced sweep in several slices, float32, against
    the plain version in float64 on the first 256 targets, each twice
    bit-identical."""
    _, q = _image_scene(17000, seed=23, a=0.05)     # 240 a a side
    L = (144.0, 144.0, 0.0)
    boxes = (L, pk.box_offsets(L))
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert pk.plan_groups(17000, n_sm)[1] > 1
    qt = torch.as_tensor(q, dtype=torch.float32, device=cuda)
    vt = torch.randn((17000, pk.NCOMP[coupling] * n_rhs), device=cuda,
                     generator=torch.Generator(device=cuda).manual_seed(4))
    kw = dict(coupling=coupling, mode="wall", self_interaction=True,
              boxes=boxes)
    ref = pk.pair_plain(qt.double(), qt[:256].double(), vt.double(), **kw)
    for q_tgt in (None, qt):
        got = pk.pair_matvec(qt, q_tgt, vt, **kw)
        assert torch.equal(got, pk.pair_matvec(qt, q_tgt, vt, **kw))
        err = (got[:256].double() - ref).abs().max().item()
        assert err <= 3e-6 * ref.abs().max().item()


def test_k1_image_boxes_rejected(cuda):
    """A box list without a periodic axis, with more than 27 boxes, or
    without the home box first is refused before any launch."""
    q = torch.rand((10, 3), device=cuda) + 1.0
    v = torch.rand((10, 3), device=cuda)
    for boxes in (((0.0, 0.0, 0.0), [(0, 0, 0)]),
                  ((5.0, 5.0, 5.0), [(0, 0, 0)] * 28),
                  ((5.0, 5.0, 0.0), [(1, 0, 0), (0, 0, 0)])):
        with pytest.raises(ValueError, match="image boxes"):
            pk.pair_matvec(q, None, v, coupling="tt", mode="wall",
                           self_interaction=True, boxes=boxes)


# the image policies of K1 and K3 (ops/pair_kernels.py plane_far): (wall,
# box in units of a, whether the in-plane far policy takes it); the scenes
# hold pairs at the half-box tie
IMAGE_POLICIES = {"plane_wall": (True, (23.0, 19.0, 0.0), True),
                  "plane_open": (False, (23.0, 19.0, 0.0), True),
                  "plane_margin": (True, (4.05, 4.2, 0.0), True),
                  "general_L3": (True, (3.0, 3.0, 0.0), False),
                  "general_z": (False, (23.0, 19.0, 21.0), False)}


def _tie_scene(n, L, seed, a=0.3):
    """_image_scene with pairs at the half-box tie on x and on y (in
    units of a, as the kernels and the plain version form d)."""
    r, q = _image_scene(n, seed=seed, a=a)
    q[1, 0] = q[0, 0] + 0.5 * L[0]
    q[2, 1] = q[0, 1] - 0.5 * L[1]
    r[1, 0], r[2, 1] = q[1, 0] * a, q[2, 1] * a
    return r, q


@pytest.mark.parametrize("dtype, bound", [(torch.float32, 3e-6),
                                          (torch.float64, 1e-12)])
@pytest.mark.parametrize("square", [True, False])
@pytest.mark.parametrize("policy", sorted(IMAGE_POLICIES))
@pytest.mark.parametrize("coupling, n_rhs", [("tt", 1), ("tt", 2),
                                             ("rr", 1), ("rr", 2),
                                             ("tr", 1), ("tr", 2),
                                             ("rt", 1), ("grand", 1)])
def test_k1_image_policies_match_plain(cuda, coupling, n_rhs, policy,
                                       square, dtype, bound):
    """The diagonal couplings' box sums (BlockSum) and the cross and grand
    couplings' per-box applies on both sweeps under each policy: the
    in-plane far one above the wall, without it and at its margin (L / a
    just above 4.04), the general one at L / a = 3 and for a box periodic
    in z; 300 blobs with a coincident pair and ties, against the plain
    version in float64, twice bit-identical."""
    wall, L, plane = IMAGE_POLICIES[policy]
    r, q = _tie_scene(300, L, seed=25)
    q = q if wall else r / 0.3
    boxes = (L, pk.box_offsets(L))
    assert pk.plane_far(boxes) == plane
    v = np.random.default_rng(26).normal(
        size=(300, pk.NCOMP[coupling] * n_rhs))
    qt = torch.as_tensor(q, dtype=dtype, device=cuda)
    vt = torch.as_tensor(v, dtype=dtype, device=cuda)
    kw = dict(coupling=coupling, mode=pk.wall_mode(wall),
              self_interaction=True,
              boxes=boxes)
    got = pk.pair_matvec(qt, None if square else qt, vt, **kw)
    again = pk.pair_matvec(qt, None if square else qt, vt, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    ref = pk.pair_plain(qt.double(), qt.double(), vt.double(), **kw)
    assert ((got.double() - ref).abs().max().item()
            <= bound * ref.abs().max().item())


@pytest.mark.parametrize("dtype, bound", [(torch.float32, 3e-6),
                                          (torch.float64, 1e-12)])
@pytest.mark.parametrize("n", [33, 100, 1000])
@pytest.mark.parametrize("policy", ["open_wall", "open"]
                         + sorted(IMAGE_POLICIES))
def test_k3_triangle_is_an_exact_transpose(cuda, policy, n, dtype, bound):
    """K3 on the upper triangle of tiles, the lower written as the exact
    transpose (bit for bit), open and under each image policy, N off the
    tile edges (32 blobs a float32 tile, 16 a float64 one); against the
    plain builder in float64, twice bit-identical."""
    if policy.startswith("open"):
        wall, L = policy == "open_wall", (0.0, 0.0, 0.0)
    else:
        wall, L, _ = IMAGE_POLICIES[policy]
    r, _ = _tie_scene(n, L, seed=27) if L[0] else _image_scene(n, seed=27)
    box = tuple(x * 0.3 for x in L)
    rt = torch.as_tensor(r, dtype=dtype, device=cuda)
    got = mc.dense_tt(rt, 0.8, 0.3, mode=pk.wall_mode(wall),
                      periodic_length=box)
    again = mc.dense_tt(rt, 0.8, 0.3, mode=pk.wall_mode(wall),
                        periodic_length=box)
    torch.cuda.synchronize()
    assert torch.equal(got, got.T)
    assert torch.equal(got, again)
    ref = mc.dense_tt_plain(rt.double(), 0.8, 0.3,
                            mode=pk.wall_mode(wall),
                            periodic_length=box)
    err = (got.double() - ref).abs().max().item()
    assert err <= bound * ref.abs().max().item()


@pytest.mark.parametrize("dtype, bound", [(torch.float32, 3e-6),
                                          (torch.float64, 1e-12)])
@pytest.mark.parametrize("wall, L", IMAGE_BOXES)
@pytest.mark.parametrize("n", [1, 100, 260])
def test_k3_image_boxes_match_plain(cuda, n, wall, L, dtype, bound):
    """K3's image-box instance against the plain builder with images in
    float64: the self block's images (one blob: the tt self block and its
    images are even in d, never zero), N below and off the
    block edges, a coincident pair; counted apart from the open K3."""
    r, _ = _image_scene(n, seed=24)
    box = tuple(x * 0.3 for x in L)                  # physical units
    rt = torch.as_tensor(r, dtype=dtype, device=cuda)
    before = dict(mc.DENSE_TT_LAUNCHES)
    got = mc.dense_tt(rt, 0.8, 0.3, mode=pk.wall_mode(wall),
                      periodic_length=box)
    torch.cuda.synchronize()
    key = (pk.wall_mode(wall), True)
    assert mc.DENSE_TT_LAUNCHES == {**before, key: before[key] + 1}
    ref = mc.dense_tt_plain(rt.double(), 0.8, 0.3,
                            mode=pk.wall_mode(wall),
                            periodic_length=box)
    assert got.shape == ref.shape == (3 * n, 3 * n)
    err = (got.double() - ref).abs().max().item()
    assert err <= bound * ref.abs().max().item()


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


@pytest.mark.parametrize("dtype, bound", [(torch.float32, 3e-6),
                                          (torch.float64, 1e-12)])
@pytest.mark.parametrize("n", [1, 2, 77, 128, 129, 1000, 17000])
def test_k2_symmetric_sweep(cuda, n, dtype, bound):
    """K2 on the symmetric sweep: N below one tile, on a tile edge and off
    it, and 17,000 blobs in groups of two tiles (ragged last group); a
    coincident pair in one tile and one across tiles, pairs inside 2a;
    against the plain version (the first 512 rows at 17,000) and twice
    bit-identical."""
    r, _ = _scene(n, seed=8, a=0.3 if n < 10000 else 0.05)
    if n > 5:
        r[5] = r[4]
        r[n - 1] = r[3]
    if n == 17000:
        n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
        assert pk.plan_groups(n, n_sm)[1] > 1
    rt = torch.as_tensor(r, dtype=dtype, device=cuda)
    kw = dict(repulsion_strength=0.7, debye_length=0.25, blob_radius=0.3)
    before = mc.LAUNCHES
    got = mc.blob_blob_forces(rt, **kw)
    again = mc.blob_blob_forces(rt, **kw)
    torch.cuda.synchronize()
    assert mc.LAUNCHES == before + 2 and torch.equal(got, again)
    assert bool(torch.isfinite(got).all())
    if n == 1:
        assert bool((got == 0).all())
        return
    sub = min(n, 512)
    ref = mc.blob_blob_forces_plain(rt.double(), **kw)[:sub]
    err = (got[:sub].double() - ref).abs().max().item()
    assert err <= bound * ref.abs().max().item()


def test_k2_never_takes_the_plain_path(cuda, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("blob_blob_forces_plain called for a CUDA "
                             "tensor")

    monkeypatch.setattr(mc, "blob_blob_forces_plain", refuse)
    mc.blob_blob_forces(torch.rand((300, 3), device=cuda) * 10,
                        repulsion_strength=1.0, debye_length=0.2,
                        blob_radius=0.3)
    torch.cuda.synchronize()


def test_wrappers_reject_bad_input(cuda):
    q = torch.zeros((4, 3), device=cuda)
    with pytest.raises(ValueError):
        pk.pair_matvec(q, q, torch.zeros((4, 3), device=cuda).t(),
                       coupling="tt", mode="wall", self_interaction=True)
    with pytest.raises(ValueError):
        pk.pair_matvec(q, q, q.double(), coupling="tt", mode="wall",
                       self_interaction=True)
    with pytest.raises(ValueError):
        pk.pair_matvec(q, q, torch.zeros((4, 9), device=cuda),
                       coupling="tt", mode="wall", self_interaction=True)
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
            pk.pair_matvec(q, q, vec, coupling=coupling, mode="wall",
                           self_interaction=True)
    with pytest.raises(TypeError):
        pk.pair_matvec(q.half(), q.half(),
                       torch.zeros((4, nc), device=cuda).half(),
                       coupling=coupling, mode="wall", self_interaction=True)


# ---------------------------------------------------------------------------
# K5 (linked-cell forces) and K6 (near-field RPY) on the cells of a
# periodic box
# ---------------------------------------------------------------------------

BOUNDS = [(torch.float32, 3e-6), (torch.float64, 1e-12)]


def _cell_scene(cuda, n, L, dims, cap, dtype, seed=0):
    rng = np.random.default_rng(seed)
    r = rng.uniform(0, L, (n, 3))
    r[7] = r[6]                              # a coincident pair
    r[9] = r[8] + 0.05                       # closer than 2a
    pos = torch.as_tensor(r, dtype=dtype, device=cuda)
    table, slot, _, dropped = cells.cell_bin(pos, (L, L, L), dims, cap)
    return pos, table, slot, int(dropped)


def _k5(cuda, n, L, dims, cap, dtype, seed=0):
    pos, table, slot, dropped = _cell_scene(cuda, n, L, dims, cap, dtype,
                                            seed)
    kw = dict(eps_over_b=0.2 / 0.25, inv_b=1 / 0.25, two_a=0.4)
    before = ck.LAUNCHES["nl_forces"]
    got = ck.nl_forces(pos, table, dims, (L, L, L), cap, **kw)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["nl_forces"] == before + 1
    ref = ck.nl_forces_plain(pos.double(), table, dims, (L, L, L), cap,
                             **kw)
    err = (got.double() - ref).abs().max().item() / ref.abs().max().item()
    return err, got, slot, dropped


@pytest.mark.parametrize("dtype, bound", BOUNDS)
@pytest.mark.parametrize("dims", [(6, 6, 6), (4, 4, 4)])
def test_k5_matches_plain(cuda, dims, dtype, bound):
    L = 12.0
    err, _, _, dropped = _k5(cuda, 1500, L, dims, 64, dtype)
    assert dropped == 0 and err <= bound


def test_k5_overflowing_cell_rows_are_zero(cuda):
    dims, cap = (5, 5, 5), 4
    err, got, slot, dropped = _k5(cuda, 900, 10.0, dims, cap,
                                  torch.float64, seed=1)
    assert dropped > 0 and err <= 1e-12
    gone = slot == 125 * cap
    assert bool((got[gone] == 0).all())


def _k6(cuda, n_rhs, dtype, n=1500, L=12.0, cap=64, seed=2):
    p = ewald.default_params(0.3, 1.0, (L, L, L), tol=1e-4,
                             cell_capacity=cap)     # r_cut 1.8
    dims = tuple(int(L // p.r_cut) for _ in range(3))
    pos, table, slot, dropped = _cell_scene(cuda, n, L, dims, cap, dtype,
                                            seed)
    cheb = torch.as_tensor(ewald._host_cheb(p)[0], dtype=dtype,
                           device=cuda).contiguous()
    f = torch.as_tensor(np.random.default_rng(3).normal(
        size=(n, 3 * n_rhs)), dtype=dtype, device=cuda)
    kw = dict(two_a=2 * p.a, r_cut=p.r_cut)
    key = f"near_rpy_b{n_rhs}"
    before = ck.LAUNCHES[key]
    got = ck.near_rpy(pos, f, table, dims, p.box, cap, cheb, **kw)
    torch.cuda.synchronize()
    assert ck.LAUNCHES[key] == before + 1
    ref = ck.near_rpy_plain(pos.double(), f.double(), table, dims, p.box,
                            cap, cheb.double(), **kw)
    err = (got.double() - ref).abs().max().item() / ref.abs().max().item()
    return err, got, slot, dropped, dims


@pytest.mark.parametrize("dtype, bound", BOUNDS)
@pytest.mark.parametrize("n_rhs", [1, 2])
def test_k6_matches_plain(cuda, n_rhs, dtype, bound):
    err, _, _, dropped, dims = _k6(cuda, n_rhs, dtype)
    assert dropped == 0 and min(dims) >= 4 and err <= bound


def test_k6_exactly_four_cells_and_overflow(cuda):
    err, got, slot, dropped, dims = _k6(cuda, 2, torch.float64, n=2500,
                                        L=7.3, cap=6, seed=4)
    assert dims == (4, 4, 4) and dropped > 0 and err <= 1e-12
    assert bool((got[slot == 64 * 6] == 0).all())


def _u32_bound(cap):
    """float32 rounding of a row summed over a stencil of 27 cap sources,
    relative to its magnitude."""
    return float(np.finfo(np.float32).eps / 2 * np.sqrt(27 * cap))


def _dense_cells(cuda, dtype, n, L, dims, cap, cluster=0, seed=7):
    """n random blobs in a periodic box (a coincident pair, a pair closer
    than 2a), the first `cluster` packed into one 0.5-wide cube; the cell
    table at cap (no blob dropped)."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(0, L, (n, 3))
    if n > 9:
        r[7] = r[6]
        r[9] = r[8] + 0.05
    if cluster:
        r[:cluster] = [1.0, 1.0, 1.0] + rng.uniform(-0.25, 0.25,
                                                   (cluster, 3))
    pos = torch.as_tensor(r, dtype=dtype, device=cuda)
    table, _, _, dropped = cells.cell_bin(pos, (L, L, L), dims, cap)
    assert int(dropped) == 0
    ids = table.reshape(-1, cap).long()
    live = (ids < n).sum(1)
    stencil = live[cells.neighbor_table(dims, device=cuda)].sum(1)
    return pos, table, int(live.max()), int(stencil.max())


def _k6_vs_plain_twice(cuda, pos, table, dims, L, cap, n_rhs, dtype):
    """K6 against its plain version in float64, and a second launch
    bit-identical to the first; returns max err / max|ref|."""
    p = ewald.default_params(0.3, 1.0, (L, L, L), tol=1e-4,
                             cell_capacity=cap)
    assert min(L / d for d in dims) >= p.r_cut
    cheb = torch.as_tensor(ewald._host_cheb(p)[0], dtype=dtype,
                           device=cuda).contiguous()
    f = torch.as_tensor(np.random.default_rng(3).normal(
        size=(pos.shape[0], 3 * n_rhs)), dtype=dtype, device=cuda)
    kw = dict(two_a=2 * p.a, r_cut=p.r_cut)
    got = ck.near_rpy(pos, f, table, dims, p.box, cap, cheb, **kw)
    again = ck.near_rpy(pos, f, table, dims, p.box, cap, cheb, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    ref = ck.near_rpy_plain(pos.double(), f.double(), table, dims, p.box,
                            cap, cheb.double(), **kw)
    return _rel_err(got, ref)


def _rel_err(got, ref):
    """max err / max|ref| (the max error itself when every row is 0)."""
    err = (got.double() - ref).abs().max().item()
    scale = ref.abs().max().item()
    return err / scale if scale > 0 else err


def _k5_vs_plain_twice(cuda, pos, table, dims, box, cap, guard_z=False):
    kw = dict(eps_over_b=0.2 / 0.25, inv_b=1 / 0.25, two_a=0.4)
    got = ck.nl_forces(pos, table, dims, box, cap, guard_z=guard_z, **kw)
    again = ck.nl_forces(pos, table, dims, box, cap, guard_z=guard_z, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    ref = ck.nl_forces_plain(pos.double(), table, dims, box, cap, **kw)
    return _rel_err(got, ref)


def _cell_bound(dtype, cap):
    return _u32_bound(cap) if dtype == torch.float32 else 1e-12


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_rhs", [1, 2])
def test_k6_dense_cells_and_long_stencils(cuda, n_rhs, dtype):
    """12,000 blobs in 6^3 cells at cap 128: ~56 targets a cell, far more
    than a block has warps, and stencils longer than one staged tile (768
    sources in float32, 512 in float64); against the float64 plain version
    and twice bit-identical."""
    L, dims, cap = 12.0, (6, 6, 6), 128
    pos, table, most, longest = _dense_cells(cuda, dtype, 12000, L, dims,
                                             cap)
    assert most > 8 and longest > 1024
    err = _k6_vs_plain_twice(cuda, pos, table, dims, L, cap, n_rhs, dtype)
    assert err <= _cell_bound(dtype, cap)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_rhs", [1, 2])
def test_k6_cells_beyond_one_target_chunk(cuda, n_rhs, dtype):
    """300 blobs packed into one cell: a block stages its targets in
    chunks (kTgt of csrc/cell_sweep.cuh, 128) and walks its stencil once a
    chunk; against the plain version and twice bit-identical."""
    L, dims, cap = 12.0, (6, 6, 6), 320
    pos, table, most, _ = _dense_cells(cuda, dtype, 1500, L, dims, cap,
                                       cluster=300)
    assert most > 2 * 128
    err = _k6_vs_plain_twice(cuda, pos, table, dims, L, cap, n_rhs, dtype)
    assert err <= _cell_bound(dtype, cap)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 2, 3, 77, 1001])
def test_k6_ragged_n(cuda, n, dtype):
    """Blob counts that fill no tile, warp or target pair evenly."""
    L, dims, cap = 12.0, (6, 6, 6), 64
    pos, table, _, _ = _dense_cells(cuda, dtype, n, L, dims, cap)
    for n_rhs in (1, 2):
        if n == 1:                       # no pair: the rows stay zero
            p = ewald.default_params(0.3, 1.0, (L, L, L), tol=1e-4,
                                     cell_capacity=cap)
            cheb = torch.as_tensor(ewald._host_cheb(p)[0], dtype=dtype,
                                   device=cuda).contiguous()
            got = ck.near_rpy(pos, torch.ones((1, 3 * n_rhs), dtype=dtype,
                                              device=cuda), table, dims,
                              p.box, cap, cheb, two_a=2 * p.a,
                              r_cut=p.r_cut)
            assert bool((got == 0).all())
            continue
        err = _k6_vs_plain_twice(cuda, pos, table, dims, L, cap, n_rhs,
                                 dtype)
        assert err <= _cell_bound(dtype, cap)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k5_dense_cells_and_long_stencils(cuda, dtype):
    """12,000 blobs in 4^3 cells at cap 256: ~190 targets a cell (more
    than one target chunk) and stencils of ~5,000 sources, longer than one
    staged tile (2048 in float32, 1024 in float64); twice bit-identical."""
    L, dims, cap = 12.0, (4, 4, 4), 256
    pos, table, most, longest = _dense_cells(cuda, dtype, 12000, L, dims,
                                             cap)
    assert most > 128 and longest > 2048
    err = _k5_vs_plain_twice(cuda, pos, table, dims, (L, L, L), cap)
    assert err <= _cell_bound(dtype, cap)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 2, 3, 77, 1001])
def test_k5_ragged_n(cuda, n, dtype):
    """Blob counts that fill no tile, warp or target pair evenly (odd
    cells pair their last target with a far one)."""
    L, dims, cap = 12.0, (6, 6, 6), 64
    pos, table, _, _ = _dense_cells(cuda, dtype, n, L, dims, cap)
    if n == 1:                           # no pair: the row stays zero
        got = ck.nl_forces(pos, table, dims, (L, L, L), cap,
                           eps_over_b=1.0, inv_b=4.0, two_a=0.4)
        assert bool((got == 0).all())
        return
    err = _k5_vs_plain_twice(cuda, pos, table, dims, (L, L, L), cap)
    assert err <= _cell_bound(dtype, cap)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k5_wall_slab_dense_and_repeat(cuda, dtype):
    """The wall-slab layout (z clipped below an empty guard layer) with
    dense cells and stencils longer than one tile, twice bit-identical."""
    from rigidmultiblobswall_tpu_torch.ops import forces

    rng = np.random.default_rng(13)
    L, n, cap = 12.0, 9000, 512
    r = np.empty((n, 3))
    r[:, :2] = rng.uniform(0, L, (n, 2))
    r[:, 2] = rng.uniform(0.2, 3.5, n)
    pos, dims, box, table, dropped = forces._force_cells(
        torch.as_tensor(r, dtype=dtype, device=cuda), (L, L, 0.0), 2.1, 16,
        cap, 3.0)
    assert int(dropped) == 0 and dims[2] == 3
    ids = table.reshape(-1, cap).long()
    stencil = (ids < n).sum(1)[cells.neighbor_table(dims,
                                                    device=cuda)].sum(1)
    assert int(stencil.max()) > 2048
    err = _k5_vs_plain_twice(cuda, pos, table, dims, box, cap, guard_z=True)
    assert err <= _cell_bound(dtype, cap)


def test_cell_wrappers_reject_bad_input(cuda):
    dims, cap, L = (4, 4, 4), 4, 8.0
    pos, table, _, _ = _cell_scene(cuda, 50, L, dims, cap, torch.float32)
    kw5 = dict(eps_over_b=1.0, inv_b=1.0, two_a=0.5)
    with pytest.raises(ValueError):                    # wrong device
        ck.nl_forces(pos.to("meta"), table, dims, (L,) * 3, cap, **kw5)
    with pytest.raises(TypeError):                     # dtype
        ck.nl_forces(pos.half(), table, dims, (L,) * 3, cap, **kw5)
    with pytest.raises(ValueError):                    # table dtype
        ck.nl_forces(pos, table.long(), dims, (L,) * 3, cap, **kw5)
    with pytest.raises(ValueError):                    # too few cells
        ck.nl_forces(pos, table[:27 * cap].contiguous(), (3, 3, 3),
                     (L,) * 3, cap, **kw5)
    with pytest.raises(ValueError):                    # not contiguous
        ck.nl_forces(torch.zeros((3, 50), device=cuda).t(), table, dims,
                     (L,) * 3, cap, **kw5)
    cheb = torch.zeros((2, 2, 8), device=cuda)
    kw6 = dict(two_a=0.5, r_cut=1.9)
    for f in (torch.zeros((50, 9), device=cuda),          # B = 3
              torch.zeros((50, 4), device=cuda),          # ragged
              torch.zeros((49, 3), device=cuda),          # rows
              torch.zeros((3, 50), device=cuda).t(),      # not contiguous
              torch.zeros((50, 3), device=cuda).double()):  # mixed dtype
        with pytest.raises(ValueError):
            ck.near_rpy(pos, f, table, dims, (L,) * 3, cap, cheb, **kw6)
    with pytest.raises(ValueError):                    # K > 32
        ck.near_rpy(pos, torch.zeros((50, 3), device=cuda), table, dims,
                    (L,) * 3, cap, torch.zeros((2, 2, 33), device=cuda),
                    **kw6)


# ---------------------------------------------------------------------------
# K3 (materialized tt mobility) and K4 (upper-triangle symmetric product)
# ---------------------------------------------------------------------------


def _dense_scene(cuda, n, dtype, seed=5):
    """Raw blob positions (blobs below a, a coincident pair) on the card."""
    r, _ = _scene(n, seed=seed)
    r[:, :2] *= 0.25                     # denser: near pairs in every tile
    if n > 9:
        r[9] = r[8]
    return torch.as_tensor(r, dtype=dtype, device=cuda)


@pytest.mark.parametrize("dtype, bound", BOUNDS)
@pytest.mark.parametrize("wall", [True, False])
@pytest.mark.parametrize("n", [40, 100, 260])
def test_k3_matches_plain(cuda, n, wall, dtype, bound):
    """N below one 16 x 32 block, and N not a multiple of either edge."""
    r = _dense_scene(cuda, n, dtype)
    key = (pk.wall_mode(wall), False)
    before = mc.DENSE_TT_LAUNCHES[key]
    got = mc.dense_tt(r, 0.8, 0.3, mode=pk.wall_mode(wall))
    torch.cuda.synchronize()
    assert mc.DENSE_TT_LAUNCHES[key] == before + 1
    ref = mc.dense_tt_plain(r.double(), 0.8, 0.3,
                            mode=pk.wall_mode(wall))
    assert got.shape == ref.shape == (3 * n, 3 * n)
    err = (got.double() - ref).abs().max().item()
    assert err <= bound * ref.abs().max().item()


@pytest.mark.parametrize("dtype, bound", BOUNDS)
@pytest.mark.parametrize("n", [40, 100, 256, 260])
def test_k4_matches_plain_reads_upper_tiles_only(cuda, n, dtype, bound):
    """K4 against the full product for one right-hand side and a stack of
    three (a B = 2 and a B = 1 launch), bit-identical on repeat, and blind
    to the strictly-lower tiles (overwritten by NaN)."""
    r = _dense_scene(cuda, n, dtype, seed=6)
    m = mc.dense_tt(r, 1.0, 0.3, mode="wall")
    v = torch.as_tensor(np.random.default_rng(7).normal(size=(n, 3)),
                        dtype=dtype, device=cuda)
    before = mc.SYMM_LAUNCHES
    got = mc.symm_matvec(m, v)
    torch.cuda.synchronize()
    assert mc.SYMM_LAUNCHES == before + 1
    ref = mc.symm_matvec_plain(m.double(), v.double())
    err = (got.double() - ref).abs().max().item()
    assert got.shape == (n, 3) and err <= bound * ref.abs().max().item()
    assert torch.equal(mc.symm_matvec(m, v), got)
    v2 = torch.as_tensor(np.random.default_rng(8).normal(size=(3, n, 3)),
                         dtype=dtype, device=cuda)
    got2 = mc.symm_matvec(m, v2)             # launches of B = 2 and B = 1
    ref2 = mc.symm_matvec_plain(m.double(), v2.double())
    err2 = (got2.double() - ref2).abs().max().item()
    assert got2.shape == (3, n, 3) and err2 <= bound * ref2.abs().max().item()
    t = 3 * mc.SYMM_TILE
    for i0 in range(t, 3 * n, t):
        m[i0:i0 + t, :i0] = float("nan")
    assert torch.equal(mc.symm_matvec(m, v), got)
    assert torch.equal(mc.symm_matvec(m, v2), got2)


def test_dense_wrappers_reject_bad_input(cuda):
    r = torch.zeros((4, 3), device=cuda)
    m = torch.zeros((12, 12), device=cuda)
    with pytest.raises(TypeError):
        mc.dense_tt(r.half(), 1.0, 1.0, mode="wall")
    with pytest.raises(ValueError):
        mc.dense_tt(torch.zeros((3, 4), device=cuda).t(), 1.0, 1.0,
                    mode="wall")
    with pytest.raises(ValueError):
        mc.dense_tt(torch.zeros((4, 2), device=cuda), 1.0, 1.0, mode="wall")
    for mm, vv in ((m, r.double()),                          # mixed dtype
                   (torch.zeros((12, 9), device=cuda), r),    # not square
                   (m, torch.zeros((5, 3), device=cuda)),     # rows
                   (torch.zeros((12, 24), device=cuda)[:, ::2], r)):
        with pytest.raises(ValueError):
            mc.symm_matvec(mm, vv)
    with pytest.raises(ValueError):                          # wrong device
        mc.symm_matvec(m.to("meta"), r.to("meta"))


# ---------------------------------------------------------------------------
# K7 (the spectral wall engine's near field) and K5 on a wall slab
# ---------------------------------------------------------------------------

# f32: the JAX package's own bound for its f32 K7 against its XLA sweep
WALL_BOUNDS = [(torch.float32, 2e-5), (torch.float64, 1e-12)]


def _wall_plan(cuda, dtype, cap, n=1500, seed=6, cluster=0):
    """A 12 x 12 wall slab of n blobs, some below a and some above the
    slab top (clipped), one coincident pair; the plan with cell capacity
    cap (6 x 6 x 5 cells; at 6000 blobs and cap 256 a cell holds up to
    ~120 reals and a stencil up to ~2,700 sources). The first `cluster`
    blobs go into a 0.5-wide cube (300 of them: 327 reals in one cell)."""
    from rigidmultiblobswall_tpu_torch.ops import ewald_wall as ew

    a, L, z_hi = 0.3, 12.0, 3.0
    rng = np.random.default_rng(seed)
    r = np.empty((n, 3))
    r[:, :2] = rng.uniform(0, L, (n, 2))
    r[:, 2] = rng.uniform(0.3 * a, 1.2 * z_hi, n)
    if n > 7:
        r[7] = r[6]
    if cluster:
        r[:cluster] = [5.0, 5.0, 1.0] + rng.uniform(-0.25, 0.25,
                                                   (cluster, 3))
    p = dataclasses.replace(ew.default_wall_params(a, 1.0, (L, L), z_hi),
                            cell_capacity=cap)
    return ew.make_wall_plan(p, torch.as_tensor(r, dtype=dtype, device=cuda))


def _k7(cuda, n_rhs, dtype, cap=96, seed=6, n=1500, cluster=0):
    from rigidmultiblobswall_tpu_torch.ops import ewald_wall as ew

    plan = _wall_plan(cuda, dtype, cap, n=n, seed=seed, cluster=cluster)
    args, kw = ew.near_args(plan)
    n = plan.n_real
    f = torch.as_tensor(np.random.default_rng(3).normal(size=(n, 3 * n_rhs)),
                        dtype=dtype, device=cuda)
    key = f"wall_near_b{n_rhs}"
    before = ck.LAUNCHES[key]
    got = ck.wall_near(plan.pos_all, f, *args, cz_range=ew._kept_layers(
        plan.params, plan.cell_dims), **kw)
    torch.cuda.synchronize()
    assert ck.LAUNCHES[key] == before + 1
    dargs = tuple(x.double() if torch.is_tensor(x) and x.is_floating_point()
                  else x for x in args)
    ref = ck.wall_near_plain(plan.pos_all.double(), f.double(), *dargs, **kw)
    err = (got.double() - ref).abs().max().item() / ref.abs().max().item()
    return err, got, plan


@pytest.mark.parametrize("dtype, bound", WALL_BOUNDS)
@pytest.mark.parametrize("n_rhs", [1, 2])
def test_k7_matches_plain(cuda, n_rhs, dtype, bound):
    err, _, plan = _k7(cuda, n_rhs, dtype)
    assert int(plan.n_dropped_cells) == 0 and int(plan.n_clipped) > 0
    assert plan.cell_dims[2] >= 3 and err <= bound


@pytest.mark.parametrize("dtype, bound", WALL_BOUNDS)
@pytest.mark.parametrize("n_rhs", [1, 2])
def test_k7_dense_cells_and_long_stencils(cuda, n_rhs, dtype, bound):
    """6000 blobs at cap 256: target cells with far more real targets than
    a block has warps, and stencils longer than one staged tile (1408
    sources in float32, 1024 in float64; some longer than 2048); against
    the plain version, and twice bit-identical."""
    from rigidmultiblobswall_tpu_torch.ops import ewald_wall as ew

    err, got, plan = _k7(cuda, n_rhs, dtype, cap=256, n=6000)
    assert int(plan.n_dropped_cells) == 0 and err <= bound
    dims, cap = plan.cell_dims, plan.params.cell_capacity
    ids = plan.cell_table.reshape(-1, cap).long()
    stencil = (ids < 2 * plan.n_real).sum(1)[
        cells.neighbor_table(dims, device=cuda)].sum(1)
    assert int((ids < plan.n_real).sum(1).max()) > 8
    assert int(stencil.max()) > 2048
    args, kw = ew.near_args(plan)
    f = torch.as_tensor(np.random.default_rng(3).normal(
        size=(plan.n_real, 3 * n_rhs)), dtype=dtype, device=cuda)
    again = ck.wall_near(plan.pos_all, f, *args, cz_range=ew._kept_layers(
        plan.params, dims), **kw)
    assert torch.equal(got, again)


@pytest.mark.parametrize("dtype, bound", WALL_BOUNDS)
@pytest.mark.parametrize("n_rhs", [1, 2])
def test_k7_cells_beyond_one_target_chunk(cuda, n_rhs, dtype, bound):
    """327 real targets in one cell: a block stages them in chunks (kTgt
    of csrc/wall_near.cu, 128) and walks its stencil once a chunk. At cap
    400 against the plain version; at cap 2100 (more slots a cell than
    the staged targets could hold at once) bit-identical to cap 400."""
    from rigidmultiblobswall_tpu_torch.ops import ewald_wall as ew

    err, got, plan = _k7(cuda, n_rhs, dtype, cap=400, cluster=300)
    ids = plan.cell_table.reshape(-1, 400).long()
    assert int(plan.n_dropped_cells) == 0 and err <= bound
    assert int((ids < plan.n_real).sum(1).max()) > 2 * 128
    wide = _wall_plan(cuda, dtype, 2100, cluster=300)
    args, kw = ew.near_args(wide)
    f = torch.as_tensor(np.random.default_rng(3).normal(
        size=(wide.n_real, 3 * n_rhs)), dtype=dtype, device=cuda)
    again = ck.wall_near(wide.pos_all, f, *args, cz_range=ew._kept_layers(
        wide.params, wide.cell_dims), **kw)
    assert int(wide.n_dropped_cells) == 0 and torch.equal(got, again)


def test_k7_overflowing_cell_rows_are_zero(cuda):
    err, got, plan = _k7(cuda, 2, torch.float64, cap=8, seed=1)
    assert int(plan.n_dropped_cells) > 0 and err <= 1e-12
    n = plan.n_real
    gone = plan.cell_slot[:n] == plan.cell_table.shape[0]
    assert bool(gone.any()) and bool((got[gone] == 0).all())


def test_k7_wrapper_rejects_bad_input(cuda):
    from rigidmultiblobswall_tpu_torch.ops import ewald_wall as ew

    plan = _wall_plan(cuda, torch.float32, 96, n=200)
    args, kw = ew.near_args(plan)
    n = plan.n_real
    layers = ew._kept_layers(plan.params, plan.cell_dims)
    for f in (torch.zeros((n, 9), device=cuda),           # B = 3
              torch.zeros((n, 4), device=cuda),           # ragged
              torch.zeros((n + 1, 3), device=cuda),       # rows
              torch.zeros((n, 3), device=cuda).double()):  # mixed dtype
        with pytest.raises(ValueError):
            ck.wall_near(plan.pos_all, f, *args, cz_range=layers, **kw)
    f = torch.zeros((n, 3), device=cuda)
    with pytest.raises(ValueError):                       # z layers
        ck.wall_near(plan.pos_all, f, *args,
                     cz_range=(0, plan.cell_dims[2]), **kw)
    long_img = torch.zeros((2, 10, 33), device=cuda)      # Ki > 32
    with pytest.raises(ValueError):
        ck.wall_near(plan.pos_all, f, *args[:5], long_img, cz_range=layers,
                     **kw)


@pytest.mark.parametrize("dtype, bound", BOUNDS)
@pytest.mark.parametrize("z_extent", [3.0, 2.0])
def test_k5_wall_slab_matches_plain(cuda, z_extent, dtype, bound):
    """The wall-slab forces' layout (z clipped below an empty guard layer;
    3 z cells at z_extent 3, 2 at z_extent 2) through K5 and its plain
    version."""
    from rigidmultiblobswall_tpu_torch.ops import forces

    rng = np.random.default_rng(11)
    L, n, a, b = 12.0, 1200, 0.3, 0.05
    r = np.empty((n, 3))
    r[:, :2] = rng.uniform(0, L, (n, 2))
    r[:, 2] = rng.uniform(0.2, z_extent + 0.5, n)        # some clipped
    rc = 2 * a + 30 * b
    pos, dims, box, table, dropped = forces._force_cells(
        torch.as_tensor(r, dtype=dtype, device=cuda), (L, L, 0.0), rc, 16,
        128, z_extent)
    assert int(dropped) == 0 and dims[2] == (3 if z_extent == 3.0 else 2)
    kw = dict(eps_over_b=0.7 / b, inv_b=1 / b, two_a=2 * a)
    before = ck.LAUNCHES["nl_forces"]
    got = ck.nl_forces(pos, table, dims, box, 128, guard_z=True, **kw)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["nl_forces"] == before + 1
    ref = ck.nl_forces_plain(pos.double(), table, dims, box, 128, **kw)
    err = (got.double() - ref).abs().max().item()
    assert err <= bound * ref.abs().max().item()


# K8: the rot near field of the wall engine, per instance: (forces,
# torques, want_v, want_w) of the call that forms it
ROT_INSTANCES = {"grand": (True, True, True, True),
                 "rt": (True, False, False, True),
                 "tr": (False, True, True, False),
                 "rr": (False, True, False, True)}


def _k8(cuda, which, dtype, cap=96, seed=6, n=1500, cluster=0):
    """K8's instance `which` on _wall_plan's slab against its plain version
    in float64 with the same outputs asked for: (max err / max|ref|, the
    kernel's rows, the plan, a relaunch). The call launches that instance
    alone, and the half of the rows it does not form stays zero."""
    from rigidmultiblobswall_tpu_torch.ops import ewald_wall as ew
    from rigidmultiblobswall_tpu_torch.ops import ewald_wall_rot as ewr

    plan = _wall_plan(cuda, dtype, cap, n=n, seed=seed, cluster=cluster)
    cheb, _ = ewr._host_cheb_rot(plan.params)
    args, kw = ewr.near_args(plan, torch.as_tensor(cheb, dtype=dtype,
                                                   device=cuda))
    rng = np.random.default_rng(3)
    has_f, has_t, want_v, want_w = ROT_INSTANCES[which]
    kw.update(want_v=want_v, want_w=want_w)
    f, t = (torch.as_tensor(rng.normal(size=(plan.n_real, 3)), dtype=dtype,
                            device=cuda) if has else None
            for has in (has_f, has_t))
    layers = ew._kept_layers(plan.params, plan.cell_dims)
    before = dict(ck.LAUNCHES)
    got = ck.wall_rot_near(plan.pos_all, f, t, *args, cz_range=layers, **kw)
    again = ck.wall_rot_near(plan.pos_all, f, t, *args, cz_range=layers,
                             **kw)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in ck.LAUNCHES.items()
            if v != before[k]} == {f"wall_rot_near_{which}": 2}
    dargs = tuple(x.double() if torch.is_tensor(x) and x.is_floating_point()
                  else x for x in args)
    ref = ck.wall_rot_near_plain(
        plan.pos_all.double(), None if f is None else f.double(),
        None if t is None else t.double(), *dargs, **kw)
    if not want_v:
        assert bool((got[:, :3] == 0).all())
    if not want_w:
        assert bool((got[:, 3:] == 0).all())
    err = (got.double() - ref).abs().max().item() / max(
        ref.abs().max().item(), 1e-300)
    return err, got, plan, again


@pytest.mark.parametrize("dtype, bound", WALL_BOUNDS)
@pytest.mark.parametrize("which", sorted(ROT_INSTANCES))
def test_k8_matches_plain(cuda, which, dtype, bound):
    err, got, plan, again = _k8(cuda, which, dtype)
    assert int(plan.n_dropped_cells) == 0 and int(plan.n_clipped) > 0
    assert err <= bound and torch.equal(got, again)


@pytest.mark.parametrize("dtype, bound", WALL_BOUNDS)
@pytest.mark.parametrize("which", sorted(ROT_INSTANCES))
def test_k8_dense_cells_and_long_stencils(cuda, which, dtype, bound):
    """6000 blobs at cap 256: cells with many more real targets than a
    block has warps, stencils longer than one staged tile (1024 sources);
    against the plain version and twice bit-identical."""
    err, got, plan, again = _k8(cuda, which, dtype, cap=256, n=6000)
    dims, cap = plan.cell_dims, plan.params.cell_capacity
    ids = plan.cell_table.reshape(-1, cap).long()
    stencil = (ids < 2 * plan.n_real).sum(1)[
        cells.neighbor_table(dims, device=cuda)].sum(1)
    assert int(plan.n_dropped_cells) == 0 and int(stencil.max()) > 2048
    assert err <= bound and torch.equal(got, again)


@pytest.mark.parametrize("dtype, bound", WALL_BOUNDS)
@pytest.mark.parametrize("which", sorted(ROT_INSTANCES))
def test_k8_cells_beyond_one_target_chunk(cuda, which, dtype, bound):
    """327 real targets in one cell (a block stages them in chunks of
    128) at cap 400."""
    err, got, plan, again = _k8(cuda, which, dtype, cap=400, cluster=300)
    ids = plan.cell_table.reshape(-1, 400).long()
    assert int((ids < plan.n_real).sum(1).max()) > 2 * 128
    assert int(plan.n_dropped_cells) == 0 and err <= bound
    assert torch.equal(got, again)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [1, 2, 3, 77])
def test_k8_ragged_n(cuda, n, dtype):
    """A handful of rollers: mostly empty cells, targets alone in their
    cells; every instance against the plain version."""
    bound = dict(WALL_BOUNDS)[dtype]
    for which in ROT_INSTANCES:
        err, got, plan, again = _k8(cuda, which, dtype, n=n, seed=n)
        assert got.shape == (n, 6) and torch.equal(got, again)
        assert err <= bound


@pytest.mark.parametrize("dtype, bound", WALL_BOUNDS)
@pytest.mark.parametrize("which", ["ft", "t"])
def test_k8_calls_of_two_products(cuda, which, dtype, bound):
    """A call with torques that asks for both outputs launches tr and rr
    (or, with forces too, grand); the rows against the plain version and
    against the sum of the one-output calls (each adds into its own half,
    so the sum is exact)."""
    from rigidmultiblobswall_tpu_torch.ops import ewald_wall as ew
    from rigidmultiblobswall_tpu_torch.ops import ewald_wall_rot as ewr

    plan = _wall_plan(cuda, dtype, 96, n=1500, seed=6)
    cheb, _ = ewr._host_cheb_rot(plan.params)
    args, kw = ewr.near_args(plan, torch.as_tensor(cheb, dtype=dtype,
                                                   device=cuda))
    kw["cz_range"] = ew._kept_layers(plan.params, plan.cell_dims)
    rng = np.random.default_rng(5)
    f = torch.as_tensor(rng.normal(size=(plan.n_real, 3)), dtype=dtype,
                        device=cuda) if which == "ft" else None
    t = torch.as_tensor(rng.normal(size=(plan.n_real, 3)), dtype=dtype,
                        device=cuda)
    before = dict(ck.LAUNCHES)
    got = ck.wall_rot_near(plan.pos_all, f, t, *args, **kw)
    launched = {k: v - before[k] for k, v in ck.LAUNCHES.items()
                if v != before[k]}
    assert launched == ({"wall_rot_near_grand": 1} if f is not None else
                        {"wall_rot_near_tr": 1, "wall_rot_near_rr": 1})
    v = ck.wall_rot_near(plan.pos_all, f, t, *args, want_w=False, **kw)
    w = ck.wall_rot_near(plan.pos_all, f, t, *args, want_v=False, **kw)
    assert not v[:, 3:].any() and not w[:, :3].any()
    if f is None:
        assert torch.equal(got, v + w)
    kw.pop("cz_range")
    dargs = tuple(x.double() if torch.is_tensor(x) and x.is_floating_point()
                  else x for x in args)
    ref = ck.wall_rot_near_plain(
        plan.pos_all.double(), None if f is None else f.double(), t.double(),
        *dargs, **kw)
    for rows in (got, v + w):
        err = (rows.double() - ref).abs().max().item()
        assert err <= bound * ref.abs().max().item()


def test_k8_launch_error_raises(cuda, monkeypatch):
    """A launch the kernel refuses (K above its table's 48 terms, let
    through the wrapper's check) raises; nothing falls back to the plain
    version."""
    from rigidmultiblobswall_tpu_torch.ops import ewald_wall as ew
    from rigidmultiblobswall_tpu_torch.ops import ewald_wall_rot as ewr

    def refuse(*args, **kwargs):
        raise AssertionError("wall_rot_near_plain called for CUDA tensors")

    plan = _wall_plan(cuda, torch.float32, 96, n=200)
    args, kw = ewr.near_args(plan, torch.zeros((2, 3, 60), device=cuda))
    t = torch.zeros((plan.n_real, 3), device=cuda)
    layers = ew._kept_layers(plan.params, plan.cell_dims)
    with pytest.raises(ValueError):                       # K > 48
        ck.wall_rot_near(plan.pos_all, None, t, *args, cz_range=layers,
                         **kw)
    monkeypatch.setattr(ck, "MAX_CHEB_ROT", 64)
    monkeypatch.setattr(ck, "wall_rot_near_plain", refuse)
    with pytest.raises(RuntimeError, match="CUDA error"):
        ck.wall_rot_near(plan.pos_all, None, t, *args, cz_range=layers,
                         **kw)
    with pytest.raises(ValueError):                       # rows
        ck.wall_rot_near(plan.pos_all, None, t[1:], *args[:4],
                         args[4][..., :24], args[5], cz_range=layers, **kw)


# periodic K2: boxes where the kernel sums the home box alone (large; in
# float32 its one-box instance, in float64 all boxes), all nine xy boxes
# (small, long Debye length) and all 27 (fully periodic)
PERIODIC_BOXES = {"large_xy": ((60.0, 60.0, 0.0), 0.25),
                  "large_xyz": ((60.0, 60.0, 60.0), 0.25),
                  "small_xy": ((1.5, 1.5, 0.0), 1.0),
                  "small_xyz": ((1.6, 1.4, 1.5), 0.8)}


@pytest.mark.parametrize("dtype, bound", [(torch.float32, 3e-6),
                                          (torch.float64, 1e-12)])
@pytest.mark.parametrize("n", [1, 2, 77, 129, 1000])
@pytest.mark.parametrize("box", sorted(PERIODIC_BOXES))
def test_k2_periodic_matches_plain(cuda, box, n, dtype, bound):
    """K2's periodic instance: ragged N (below a tile, off a tile edge),
    blobs outside the box, a coincident pair (a blob on another's periodic
    image is left out: its rounded minimum image, of any sign, decides the
    direction of a force of full size, as does a pair at half a box);
    against the plain version (every box) and twice bit-identical."""
    L, b = PERIODIC_BOXES[box]
    rng = np.random.default_rng(n)
    # each periodic coordinate below 0.45 of the box plus a whole box in
    # {-1, 0, 1}: every minimum image is needed and none is near half a
    # box, where the image a rounding picks decides the boxes summed
    Lv = np.asarray(L)
    frac = rng.uniform(0.0, 0.45, (n, 3)) + rng.integers(-1, 2, (n, 3))
    r = np.where(Lv > 0, frac * Lv, rng.uniform(-2.0, 6.0, (n, 3)))
    if n > 5:
        r[5] = r[4]
    rt = torch.as_tensor(r, dtype=dtype, device=cuda)
    kw = dict(repulsion_strength=0.7, debye_length=b, blob_radius=0.3,
              periodic_length=L)
    before, one_before = mc.PERIODIC_LAUNCHES, mc.ONE_BOX_LAUNCHES
    got = mc.blob_blob_forces(rt, **kw)
    again = mc.blob_blob_forces(rt, **kw)
    torch.cuda.synchronize()
    assert mc.PERIODIC_LAUNCHES == before + 2 and torch.equal(got, again)
    one_box = len(mc.image_boxes(L, b, 0.3, dtype)) == 1
    assert mc.ONE_BOX_LAUNCHES == one_before + 2 * one_box
    ref = mc.blob_blob_forces_plain(rt.double(), **kw)
    err = (got.double() - ref).abs().max().item()
    # one blob: the kernel skips the self pair in every box, the plain
    # version sums its images, which cancel to rounding; measure both
    # against the law's scale eps/b
    scale = ref.abs().max().item() if n > 1 else 0.7 / b
    if dtype == torch.float32:
        # a float32 displacement rounds at u32 |r|, coordinates up to ~1.45
        # L here; the force moves by that over b (K2's 3e-6 holds at
        # coordinates of a few b)
        bound = max(bound, float(np.finfo(np.float32).eps / 2) * 4
                    * float(np.abs(r).max()) / b)
    assert err <= bound * scale
    if n == 1:
        assert bool((got == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("L", [(400.0, 400.0, 0.0), (400.0, 400.0, 400.0)])
def test_k2_one_box_at_half_a_box(cuda, L, dtype):
    """The one-box instance (an open z axis, and fully periodic) on pairs
    at half a box and a few ulps either way, where its minimum image picks
    another image than the division's (tests/test_torch_forces.py's
    scene): the same forces as the plain version within the K2 bound,
    twice bit-identical."""
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    up = down = np_dtype(L[0] / 2)
    xs = [up]
    for _ in range(3):
        up = np.nextafter(up, np_dtype(np.inf))
        down = np.nextafter(down, np_dtype(0))
        xs += [up, down]
    rows = []
    for k, x in enumerate(xs):
        rows += [(0.0, 0.1 * k, 1.0), (x, 0.1 * k, 1.0),
                 (0.4, 0.1 * k + 0.1, 1.1)]
    r = torch.as_tensor(np.asarray(rows, dtype=np_dtype), device=cuda)
    kw = dict(repulsion_strength=0.7, debye_length=0.25, blob_radius=0.3,
              periodic_length=L)
    assert mc.image_boxes(L, 0.25, 0.3, dtype) == [(0, 0, 0)]
    before = mc.ONE_BOX_LAUNCHES
    got = mc.blob_blob_forces(r, **kw)
    again = mc.blob_blob_forces(r, **kw)
    torch.cuda.synchronize()
    assert mc.ONE_BOX_LAUNCHES == before + 2 and torch.equal(got, again)
    ref = mc.blob_blob_forces_plain(r.double(), **kw)
    bound = 3e-6 if dtype == torch.float32 else 1e-12
    assert (got.double() - ref).abs().max() <= bound * ref.abs().max()


def _lub_run(device, dtype, n_steps=3, tol=1e-12, kT=0.0041419464):
    """16 spheres near the wall (spacing 2.1 a, heights 1.08-1.23 a), the
    Uniform_Rollers physics: n_steps stochastic trapezoidal steps with
    omega 25 and cut_torque 0.2, the noise drawn on the host (the same on
    both devices). Returns the final positions (float64, host)."""
    from rigidmultiblobswall_tpu_torch.models import lubrication as lub

    rng = np.random.default_rng(9)
    idx = np.arange(16)
    pos = np.stack([(idx % 4) * 2.1, (idx // 4) * 2.1, np.full(16, 1.08)],
                   axis=1)
    pos[:, :2] += rng.uniform(-0.04, 0.04, (16, 2))
    pos[:, 2] += rng.uniform(0.0, 0.15, 16)
    sol = lub.LubSolver(num_bodies=16, eta=0.957e-3, a=1.0,
                        kT=kT, dt=1e-3, solver_tolerance=tol,
                        max_neighbors=12, device=device)
    ft_calc = lub.make_ft_calc(
        a=1.0, g=0.0025395, repulsion_strength=0.0165677856,
        debye_length=0.1, repulsion_strength_wall=0.0165677856,
        debye_length_wall=0.1, repulsion_strength_firm=0.0163)
    p = torch.as_tensor(pos, dtype=dtype, device=device)
    q = torch.tensor([[1.0, 0, 0, 0]] * 16, dtype=dtype, device=device)
    gen = torch.Generator().manual_seed(4)
    for _ in range(n_steps):
        p, q, aux = lub.step_trapezoidal(sol, p, q, gen, ft_calc,
                                         omega=25.0, cut_torque=0.2)
        assert aux.det_iterations > 0 and int(aux.neighbor_overflow) == 0
    return pos, p.double().cpu().numpy()


def test_lubrication_step_on_card_matches_cpu(cuda):
    """The 16-sphere lubrication step on the card (K1 grand, K2) against
    the CPU's plain versions: float64 to 1e-9 of the displacement (the
    same host-drawn noise), float32 at kT = 0 to 1e-2 of it (float32 draws
    differ); both kernels launched."""
    pos, ref = _lub_run("cpu", torch.float64)
    grand, k2 = pk.launches("grand"), mc.LAUNCHES
    _, got64 = _lub_run(cuda, torch.float64)
    assert pk.launches("grand") > grand and mc.LAUNCHES > k2
    _, ref0 = _lub_run("cpu", torch.float64, kT=0.0)
    _, got32 = _lub_run(cuda, torch.float32, tol=1e-5, kT=0.0)
    disp, disp0 = np.abs(ref - pos).max(), np.abs(ref0 - pos).max()
    assert disp > 1e-5 and disp0 > 1e-5
    assert np.abs(got64 - ref).max() <= 1e-9 * disp
    assert np.abs(got32 - ref0).max() <= 1e-2 * disp0


def _chain_run(device, dtype, n_steps=2, tol=1e-10):
    """Four chains of three 8-blob shells joined by ball joints above the
    wall, articulated_deterministic_forward_euler on `device`. Returns
    (start, final positions as float64 numpy)."""
    from rigidmultiblobswall_tpu_torch.models import articulated as art
    from rigidmultiblobswall_tpu_torch.models import integrators
    from rigidmultiblobswall_tpu_torch.models.system import (BodyType,
                                                            System,
                                                            make_state)

    rng = np.random.default_rng(2)
    i = np.arange(8) + 0.5
    ph, th = np.arccos(1 - 2 * i / 8), np.pi * (1 + 5 ** 0.5) * i
    shell = 0.4 * np.stack([np.cos(th) * np.sin(ph),
                            np.sin(th) * np.sin(ph), np.cos(ph)], axis=1)
    count = 4
    chain = art.ArticulatedType(
        name="chain", count=count, sub_type_indices=(0, 1, 2),
        pairs_local=np.array([[0, 1], [1, 2]]),
        links=np.array([[0.6, 0, 0, -0.6, 0, 0]] * 2))
    system = System(
        types=tuple(BodyType(name=f"chain_sub{j}", ref_config=shell,
                             count=count) for j in range(3)),
        articulated=(chain,), eta=1.0, blob_radius=0.12, g=1.0,
        repulsion_strength_wall=1.0, debye_length_wall=0.5,
        repulsion_strength=0.5, debye_length=0.3, solver_tolerance=tol)
    x0 = np.stack([rng.uniform(-4, 4, count), rng.uniform(-4, 4, count),
                   np.full(count, 2.0)], axis=1)
    pos = np.concatenate([x0, x0 + [1.2, 0, 0], x0 + [2.4, 0, 0]])
    state = make_state(pos, np.tile([1.0, 0, 0, 0], (3 * count, 1)),
                       dtype=dtype, device=device)
    step = integrators.make_stepper(
        system, "articulated_deterministic_forward_euler", 2e-3)
    carry = integrators.init_carry(system, state=state)
    for _ in range(n_steps):
        state, carry, aux = step(state, None, carry)
        assert aux.det_iterations > 0 and aux.rejections == 0
        assert float(art.constraint_violation(system, state).abs().max()) \
            <= 1e-7
    return pos, state.pos.double().cpu().numpy()


def test_articulated_forward_euler_on_card_matches_cpu(cuda):
    """Articulated forward Euler of four three-shell chains on the card
    (the materialized engine at this size, K3 and K4; K2 for the blob
    forces) against the CPU's plain versions, float64: the positions to
    1e-9 of the displacement (the centre-of-mass solve places an open
    chain on its joints, so the projection takes no iteration and adds
    no rounding spread), the constraints met after each step; K2, K3 and
    K4 launched."""
    pos, ref = _chain_run("cpu", torch.float64)
    before = (mc.LAUNCHES, sum(mc.DENSE_TT_LAUNCHES.values()),
              mc.SYMM_LAUNCHES)
    _, got = _chain_run(cuda, torch.float64)
    assert mc.LAUNCHES > before[0]
    assert sum(mc.DENSE_TT_LAUNCHES.values()) > before[1]
    assert mc.SYMM_LAUNCHES > before[2]
    disp = np.abs(ref - pos).max()
    assert disp > 1e-4
    assert np.abs(got - ref).max() <= 1e-9 * disp


# kernel L1 (csrc/laplace_layers.cu): every operator against its plain
# version, wall and self mask on and off, float32 and float64
L1_OPS = ("S", "D", "dD", "T", "bvp", "grad")


def _l1_inputs(device, dtype, n=1500, n_off=700, seed=11):
    """Blobs above the wall (one on it, two coincident), unit normals, the
    fields and off-surface targets (one on a blob)."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(0, 12, (n, 3))
    r[:, 2] = rng.uniform(0, 4, n)
    r[0, 2] = 0.0
    r[1] = r[2]
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    tgt = rng.uniform(0, 12, (n_off, 3))
    tgt[5] = r[9]
    cols = (r, tgt, nrm, rng.normal(size=n), rng.uniform(0.1, 1, n),
            rng.uniform(0, 5, n), rng.uniform(0, 1, n))
    return [torch.as_tensor(x, dtype=dtype, device=device) for x in cols]


def _l1_call(lap, op, r, tgt, nrm, c, w, k, q, *, wall, self_interaction,
             plain=False):
    sfx = "_plain" if plain else ""
    if op == "bvp":
        return getattr(lap, "bvp_operator" + sfx)(r, c, w, nrm, k, 0.7,
                                                  wall=wall)
    if op == "grad":
        return getattr(lap, "surface_gradient" + sfx)(r, c, w, nrm, k, q,
                                                      0.7, wall=wall)
    fn = {"S": "single_layer", "D": "double_layer",
          "dD": "deriv_double_layer", "T": "dipole"}[op] + sfx
    extra = (nrm,) if op in ("D", "dD") else ()
    return getattr(lap, fn)(r, tgt, c, w, *extra, wall=wall,
                            self_interaction=self_interaction)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("op", L1_OPS)
def test_l1_matches_plain_bit_identical_on_repeat(cuda, op, dtype):
    """Each L1 instance (wall on and off, self mask on and off; the fused
    sums take the blobs as targets with the self mask on) against its
    plain version in float64: float64 within 1e-12, float32 within
    u32 sqrt(N) or twice the float32 plain version's own error, whichever
    is larger, both times max|ref|; twice bit-identical; one launch
    counted a call."""
    from rigidmultiblobswall_tpu_torch.ops import laplace as lap

    args = _l1_inputs(cuda, dtype)
    ref_args = [a.double() for a in args]
    bound = 1e-12 if dtype == torch.float64 else 2 ** -24 * 1500 ** 0.5
    fused = op in ("bvp", "grad")
    for wall in (False, True):
        for self_interaction in ((True,) if fused else (True, False)):
            kw = dict(wall=wall, self_interaction=self_interaction)
            before = lap.launches(op)
            got = _l1_call(lap, op, *args, **kw)
            again = _l1_call(lap, op, *args, **kw)
            torch.cuda.synchronize()
            assert lap.launches(op) == before + 2
            assert torch.equal(got, again)
            ref = _l1_call(lap, op, *ref_args, **kw, plain=True)
            scale = ref.abs().max()
            err = (got.double() - ref).abs().max() / scale
            tol = bound
            if dtype == torch.float32:
                plain = _l1_call(lap, op, *args, **kw, plain=True)
                tol = max(bound, 2 * float((plain.double() - ref).abs().max()
                                           / scale))
            assert err <= tol, (op, wall, self_interaction, float(err))


def test_l1_refuses_mixed_dtypes(cuda):
    from rigidmultiblobswall_tpu_torch.ops import laplace as lap

    r, tgt, nrm, c, w, k, q = _l1_inputs(cuda, torch.float32, n=200,
                                         n_off=10)
    with pytest.raises(ValueError, match="mixed"):
        lap.single_layer(r, tgt, c.double(), w)


def _l1_sym_inputs(device, dtype, n, seed=12):
    """_l1_inputs' blobs (one on the wall, a coincident pair in its first
    tile) with two more coincident blobs in the first and last tiles (in
    different tile groups when there are several) and two on the wall at
    the same x, y (a zero image distance between distinct blobs)."""
    r, _, nrm, c, w, k, q = _l1_inputs("cpu", torch.float64, n=n, n_off=8,
                                       seed=seed)
    r[5] = r[n - 3]
    r[10] = r[n - 20]
    r[10, 2] = r[n - 20, 2] = 0.0
    return [x.to(device=device, dtype=dtype) for x in (r, nrm, c, w, k, q)]


def _l1_tol(lap, op, args, kw, ref, dtype, n):
    """Today's bound: float64 1e-12, float32 u32 sqrt(N) or twice the
    float32 plain version's own error, both times max|ref|."""
    if dtype == torch.float64:
        return 1e-12
    plain = _l1_call(lap, op, *args, **kw, plain=True)
    scale = ref.abs().max()
    return max(2 ** -24 * n ** 0.5,
               2 * float((plain.double() - ref).abs().max() / scale))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [100, 1500, 20000])
@pytest.mark.parametrize("op", L1_OPS)
def test_l1_symmetric_matches_plain_bit_identical_on_repeat(cuda, op, n,
                                                            dtype):
    """The symmetric sweep (the fused sums, and S, D, dD and T called with
    r_tgt the same tensor as r_src) at N of one tile group (100), of
    several ragged groups of one tile (1500) and of ragged groups of two
    tiles (20,000 on 132 SMs), with coincident blobs in different groups
    and distinct blobs at a zero image distance: against the float64
    plain version within today's bounds, wall and self mask on and off,
    twice bit-identical, every launch on the symmetric sweep."""
    from rigidmultiblobswall_tpu_torch.ops import laplace as lap

    r, nrm, c, w, k, q = _l1_sym_inputs(cuda, dtype, n)
    args = (r, r, nrm, c, w, k, q)
    ref_r = r.double()
    ref_args = (ref_r, ref_r) + tuple(a.double() for a in args[2:])
    fused = op in ("bvp", "grad")
    for wall in (False, True):
        for self_interaction in ((True,) if fused else (True, False)):
            kw = dict(wall=wall, self_interaction=self_interaction)
            before = sum(lap.SYM_LAUNCHES.values())
            got = _l1_call(lap, op, *args, **kw)
            again = _l1_call(lap, op, *args, **kw)
            torch.cuda.synchronize()
            assert sum(lap.SYM_LAUNCHES.values()) == before + 2
            assert torch.equal(got, again)
            ref = _l1_call(lap, op, *ref_args, **kw, plain=True)
            err = (got.double() - ref).abs().max() / ref.abs().max()
            tol = _l1_tol(lap, op, args, kw, ref, dtype, n)
            assert err <= tol, (op, n, wall, self_interaction, float(err))


def test_l1_takes_the_symmetric_sweep_for_the_same_tensor_only(cuda):
    """r_tgt is r_src takes the symmetric sweep; an equal copy of the
    blobs as targets takes the directed sweep, and the two agree within
    the float32 bound."""
    from rigidmultiblobswall_tpu_torch.ops import laplace as lap

    n = 1500
    r, nrm, c, w, k, q = _l1_sym_inputs(cuda, torch.float32, n)
    copy = r.clone()
    for op in L1_OPS:
        kw = dict(wall=True, self_interaction=True)
        sym, total = sum(lap.SYM_LAUNCHES.values()), lap.launches(op)
        got = _l1_call(lap, op, r, r, nrm, c, w, k, q, **kw)
        assert sum(lap.SYM_LAUNCHES.values()) == sym + 1
        assert lap.launches(op) == total + 1
        if op in ("bvp", "grad"):
            continue
        directed = _l1_call(lap, op, r, copy, nrm, c, w, k, q, **kw)
        torch.cuda.synchronize()
        assert sum(lap.SYM_LAUNCHES.values()) == sym + 1
        assert lap.launches(op) == total + 2
        ref = _l1_call(lap, op, *(a.double() for a in (r, r, nrm, c, w, k,
                                                        q)), **kw,
                       plain=True)
        scale = ref.abs().max()
        tol = _l1_tol(lap, op, (r, r, nrm, c, w, k, q), kw, ref,
                      torch.float32, n)
        assert (got.double() - directed.double()).abs().max() / scale \
            <= 2 * tol


# M1, the MCMC pair energy: open, the wall slab periodic in x and y, and a
# fully periodic box
M1_BOXES = {"open": (0.0, 0.0, 0.0), "xy": (7.0, 7.0, 0.0),
            "xyz": (7.0, 6.0, 5.0)}
M1_LAW = dict(repulsion_strength=0.7, debye_length=0.25, blob_radius=0.2)


def _m1_scene(cuda, n, n_conf=1, seed=0):
    """n_conf random configurations of n blobs in a 7 x 7 x 4 box with a
    coincident distinct pair (when n > 5)."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(0, 7, (n_conf, n, 3))
    r[..., 2] *= 4 / 7
    if n > 5:
        r[:, 5] = r[:, 4]
    return torch.as_tensor(r, device=cuda)


def _m1_term_bound(r, kw):
    """What float32 rounding of each term's inputs allows M1: 2^-22 (the
    relative error of ex2.approx and of r from rsqrt.approx) of each term
    times (2 + its exponent's magnitude ln 2), summed over the unordered
    pairs of r (1, n, 3) in float64."""
    d = pk.min_image(r[0][:, None, :] - r[0][None, :, :],
                     kw["periodic_length"])
    iu = torch.triu_indices(r.shape[1], r.shape[1], 1, device=r.device)
    dist = d.norm(dim=-1)[iu[0], iu[1]]
    eps, b, two_a = (kw["repulsion_strength"], kw["debye_length"],
                     2 * kw["blob_radius"])
    u = torch.where(dist > two_a, eps * torch.exp(-(dist - two_a) / b),
                    eps + eps * (two_a - dist) / b)
    expo = (dist - two_a).abs() / b
    return float((u * (2 + expo)).sum()) * 2.0 ** -22


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("coincident", ["zero", "one"])
@pytest.mark.parametrize("n", [2, 77, 129, 1000, 3000])
@pytest.mark.parametrize("box", sorted(M1_BOXES))
def test_m1_matches_plain_bit_identical_on_repeat(cuda, box, n, coincident,
                                                  dtype):
    """M1 against its float64 plain version: float64 to 1e-12 relative,
    float32 within u32 sqrt(pairs), twice the float32 plain version's
    error or the rounding of its terms' inputs (_m1_term_bound); float64
    out, twice bit-identical, one launch a call."""
    r = _m1_scene(cuda, n).to(dtype)
    kw = dict(M1_LAW, periodic_length=M1_BOXES[box], coincident=coincident)
    before = mc.ENERGY_LAUNCHES
    got = mc.blob_pair_energy(r, **kw)
    again = mc.blob_pair_energy(r, **kw)
    torch.cuda.synchronize()
    assert mc.ENERGY_LAUNCHES == before + 2
    assert got.dtype == torch.float64 and got.shape == (1,)
    assert torch.equal(got, again)
    ref = mc.blob_blob_energy_plain(r.double(), **kw)
    err = float((got - ref).abs().max() / ref.abs().max())
    if dtype == torch.float64:
        assert err <= 1e-12
    else:
        plain = float((mc.blob_blob_energy_plain(r, **kw) - ref).abs().max()
                      / ref.abs().max())
        pairs = n * (n - 1) / 2
        bound = max(2 ** -24 * pairs ** 0.5, 2 * plain,
                    _m1_term_bound(r.double(), kw) / float(ref.abs().max()))
        assert err <= bound, (err, plain, bound)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("coincident", ["zero", "one"])
@pytest.mark.parametrize("per", [2, 3])
@pytest.mark.parametrize("box", sorted(M1_BOXES))
def test_m1_multi_tile_groups_match_plain(cuda, box, per, coincident, dtype,
                                          monkeypatch):
    """Groups of several tiles, as at 49,152 blobs (128 groups of 3): 1000
    blobs in groups of 2 tiles (4 groups) or 3 (3 groups, the last of 2
    tiles), so a block sweeps several tile pairs and a diagonal group
    pair starts each row at its own tile; float64 to 1e-12 relative,
    float32 within the rounding of its terms' inputs (_m1_term_bound) or
    twice the float32 plain version's error."""
    n = 1000
    plans = []

    def plan(n_blobs, n_sm):
        tiles = -(-n_blobs // 128)
        plans.append((-(-tiles // per), per))
        return plans[-1]

    monkeypatch.setattr(pk, "plan_groups", plan)
    r = _m1_scene(cuda, n, seed=per).to(dtype)
    kw = dict(M1_LAW, periodic_length=M1_BOXES[box], coincident=coincident)
    got = mc.blob_pair_energy(r, **kw)
    again = mc.blob_pair_energy(r, **kw)
    torch.cuda.synchronize()
    assert plans == [(4 if per == 2 else 3, per)] * 2
    assert torch.equal(got, again)
    ref = mc.blob_blob_energy_plain(r.double(), **kw)
    err = float((got - ref).abs().max() / ref.abs().max())
    if dtype == torch.float64:
        assert err <= 1e-12
    else:
        plain = float((mc.blob_blob_energy_plain(r, **kw) - ref).abs().max()
                      / ref.abs().max())
        bound = max(2 * plain,
                    _m1_term_bound(r.double(), kw) / float(ref.abs().max()))
        assert err <= bound, (err, plain, bound)


@pytest.mark.parametrize("n_conf, n", [(4096, 12), (70000, 3), (3, 300)])
def test_m1_batches_match_plain(cuda, n_conf, n):
    """Batches of configurations (the rejection sampler's 4096 shells, one
    past the grid's 65,535 rows, a few of several tiles) against the plain
    version, float64 to 1e-12 of each configuration's energy."""
    r = _m1_scene(cuda, n, n_conf, seed=n_conf)
    kw = dict(M1_LAW, periodic_length=M1_BOXES["xy"], coincident="one")
    got = mc.blob_pair_energy(r, **kw)
    ref = mc.blob_blob_energy_plain(r, **kw)
    assert got.shape == (n_conf,)
    assert float(((got - ref).abs() / ref.abs().clamp(min=1e-300)).max()) \
        <= 1e-12


def test_m1_launch_error_raises(cuda, monkeypatch):
    """A launch the kernel refuses (tile groups that do not cover the
    blobs) raises; nothing falls back to the plain version."""
    def refuse(*args, **kwargs):
        raise AssertionError("blob_blob_energy_plain called for CUDA "
                             "tensors")

    monkeypatch.setattr(mc, "blob_blob_energy_plain", refuse)
    monkeypatch.setattr(pk, "plan_groups", lambda n, n_sm: (1, 1))
    with pytest.raises(RuntimeError, match="CUDA error"):
        mc.blob_pair_energy(_m1_scene(cuda, 300), **M1_LAW)


def test_mcmc_chain_on_card_matches_cpu(cuda):
    """20 burn-in and 20 chain steps of 8 shells above the wall on the
    same draws fed, card float64 against the CPU: the same accepts, and
    frames and energies to 1e-9."""
    from rigidmultiblobswall_tpu_torch.models import mcmc
    from rigidmultiblobswall_tpu_torch.models.system import (BodyType,
                                                             System,
                                                             make_state)

    rng = np.random.default_rng(3)
    ref = rng.normal(size=(12, 3))
    ref *= 0.5 / np.linalg.norm(ref, axis=1, keepdims=True)
    system = System(types=(BodyType(name="s", ref_config=ref, count=8),),
                    blob_radius=0.2, kT=0.3, g=0.5,
                    repulsion_strength_wall=0.4, debye_length_wall=0.3,
                    repulsion_strength=0.7, debye_length=0.25)
    pos = np.stack([1.1 * np.arange(8), np.zeros(8), np.full(8, 0.8)], 1)
    quat = np.tile([1.0, 0, 0, 0], (8, 1))
    gen = torch.Generator().manual_seed(0)
    draws = [mcmc.draw(system, gen, torch.float64, "cpu") for _ in range(40)]
    out = {}
    for dev in ("cpu", cuda):
        state = make_state(pos, quat, device=dev)
        fed = [mcmc.Draws(*(x.to(dev) for x in d)) for d in draws]
        before = mc.ENERGY_LAUNCHES
        out[str(dev)] = mcmc.run_mcmc(system, state, n_steps=20,
                                      save_every=5, initial_step=-20,
                                      draws=fed)
        if dev == cuda:
            assert mc.ENERGY_LAUNCHES == before + 41
    (cm, ct, ce), (gm, gt, ge) = out["cpu"], out[str(cuda)]
    assert int(gm.accepted) == int(cm.accepted) > 0
    assert torch.allclose(gt.pos.cpu(), ct.pos, rtol=0, atol=1e-9)
    assert torch.allclose(ge.cpu(), ce, rtol=1e-9, atol=0)


def _radii_scene(n, seed=0):
    """Blobs above the wall with radii in [0.08, 0.3]: a coincident pair of
    unequal radii, one blob inside another, an overlapping pair."""
    rng = np.random.default_rng(seed)
    r = np.empty((n, 3))
    r[:, :2] = rng.uniform(0, 0.4 * n ** 0.5, (n, 2))
    r[:, 2] = rng.uniform(0.05, 4, n)
    rad = rng.uniform(0.08, 0.3, n)
    if n > 9:
        r[5] = r[4]
        r[7], rad[6], rad[7] = r[6] + 0.01, 0.1, 0.3
        r[9] = r[8] + 0.2
    return r, rad


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("wall", [True, False])
@pytest.mark.parametrize("n_rhs", [1, 2])
@pytest.mark.parametrize("n", [1, 100, 129, 3000, 20000])
def test_p1_matches_plain_bit_identical_on_repeat(cuda, n, n_rhs, wall,
                                                  dtype):
    """P1 against the source-target product in float64 (the first 500
    targets): float64 to 1e-12, float32 to 3e-6 x max|ref| (the JAX
    package's f32 bound), twice bit-identical; one launch counted."""
    r, rad = _radii_scene(n)
    v = np.random.default_rng(1).normal(size=(n_rhs, n, 3))
    args = [torch.as_tensor(x, dtype=dtype, device=cuda) for x in (r, v, rad)]
    key = (n_rhs, pk.wall_mode(wall), False)
    before = mc.RADII_LAUNCHES[key]
    got = mc.radii_matvec(*args[:2], args[2], 1.3,
                          domain=("single_wall" if wall else "no_wall"))
    again = mc.radii_matvec(*args[:2], args[2], 1.3,
                            domain=("single_wall" if wall else "no_wall"))
    torch.cuda.synchronize()
    assert mc.RADII_LAUNCHES[key] == before + 2
    assert torch.equal(got, again)
    sub = min(n, 500)
    from rigidmultiblobswall_tpu_torch.ops import mobility as mob

    r64, v64, a64 = (x.double() for x in args)
    ref = torch.stack([mob.source_target_matvec(
        r64, r64[:sub], vb, a64, a64[:sub], 1.3, wall=wall) for vb in v64])
    bound = 1e-12 if dtype == torch.float64 else 3e-6
    err = (got[:, :sub].double() - ref).abs().max() / ref.abs().max()
    assert err <= bound, float(err)


def test_p1_refuses_what_it_does_not_take(cuda):
    r = torch.zeros((4, 3), device=cuda)
    a = torch.full((4,), 0.1, device=cuda)
    with pytest.raises(ValueError, match="B in 1..2"):
        mc.radii_matvec(r, torch.zeros((3, 4, 3), device=cuda), a, 1.0,
                        domain="single_wall")
    with pytest.raises(ValueError, match="shapes"):
        mc.radii_matvec(r, torch.zeros((1, 4, 3), device=cuda), a[:3], 1.0,
                        domain="single_wall")


def _far_scene(n, seed):
    """n blobs on a jittered cubic lattice of spacing 0.7 above the wall,
    radii in [0.08, 0.3]: every pair of distinct blobs is at least 0.64
    apart, outside contact."""
    rng = np.random.default_rng(seed)
    side = int(np.ceil(n ** (1 / 3)))
    idx = np.arange(n)
    r = np.stack([idx % side, (idx // side) % side, idx // side ** 2],
                 axis=1) * 0.7
    r = r + rng.uniform(-0.03, 0.03, (n, 3))
    r[:, 2] += 0.2
    return r, rng.uniform(0.08, 0.3, n)


# pairs inside contact placed across the symmetric sweep's tiles at 20,000
# blobs (79 groups of two 128-blob tiles): 5 and 300 coincident (tile 0 of
# group 0 against tile 2 of group 1), 127 overlapping 128 (tiles 0 and 1 of
# group 0), 40 inside 200 (warp 1 of tile 0 against quarter 2 of tile 1),
# 1000 and 19000 coincident (groups 3 and 74)
STRADDLING = ((5, 300, (0.0, 0.0, 0.0), 0.12, 0.28),
              (127, 128, (0.2, 0.0, 0.0), 0.15, 0.25),
              (40, 200, (0.0, 0.02, 0.01), 0.1, 0.3),
              (1000, 19000, (0.0, 0.0, 0.0), 0.2, 0.2))


def _straddling_scene(n, seed):
    """_far_scene with STRADDLING's pairs moved into contact."""
    r, rad = _far_scene(n, seed)
    for i, j, d, ai, aj in STRADDLING:
        r[j] = r[i] + d
        rad[i], rad[j] = ai, aj
    return r, rad


def _contacts(r, rad, dev):
    """The number of unordered pairs of distinct blobs inside contact,
    r_ij <= a_i + a_j."""
    rt = torch.as_tensor(r, device=dev)
    at = torch.as_tensor(rad, device=dev)
    count = 0
    for i0 in range(0, len(r), 2000):
        gap = (torch.cdist(rt[i0:i0 + 2000], rt) - at[i0:i0 + 2000, None]
               - at[None])
        rows = torch.arange(i0, min(i0 + 2000, len(r)), device=dev)
        gap[rows - i0, rows] = float("inf")
        count += int((gap <= 0).sum())
    return count // 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("wall", [True, False])
@pytest.mark.parametrize("n_rhs", [1, 2])
@pytest.mark.parametrize("scene", ["far", "straddling"])
def test_p1_far_and_full_paths_match_plain(cuda, scene, n_rhs, wall, dtype):
    """P1 where every pair of distinct blobs is far (every step of the
    rotation on the far path) and where pairs inside contact, coincident
    ones included, straddle tiles and tile groups off the diagonal (their
    steps on the full path), at 20,000 blobs: against the float64
    source-target product on the rows of those pairs and 256 others,
    float64 to 1e-13 x max|ref|, float32 within max(u32 sqrt(N), twice the
    float32 plain version's error) as chip_smoke.py's phase 3 holds it;
    twice bit-identical."""
    from rigidmultiblobswall_tpu_torch.ops import mobility as mob

    n = 20000
    # STRADDLING's placement across tiles and groups is that of this plan,
    # the H100 SXM's (132 SMs), which radii_matvec takes from the card
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert pk.plan_groups(n, n_sm) == (79, 2), n_sm
    r, rad = (_far_scene if scene == "far" else _straddling_scene)(n, 3)
    assert _contacts(r, rad, cuda) == (0 if scene == "far" else 4)
    v = np.random.default_rng(4).normal(size=(n_rhs, n, 3))
    args = [torch.as_tensor(x, dtype=dtype, device=cuda) for x in (r, v, rad)]
    got = mc.radii_matvec(*args[:2], args[2], 1.3,
                          domain=("single_wall" if wall else "no_wall"))
    again = mc.radii_matvec(*args[:2], args[2], 1.3,
                            domain=("single_wall" if wall else "no_wall"))
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    rows = sorted({k for pair in STRADDLING for k in pair[:2]}
                  | set(range(0, n, n // 256)))
    rows = torch.tensor(rows, device=cuda)

    def plain(dt):
        rr, vv, aa = (x.to(dt) for x in args)
        return torch.stack([mob.source_target_matvec(
            rr, rr[rows], vb, aa, aa[rows], 1.3, wall=wall) for vb in vv])

    ref = plain(torch.float64)
    scale = ref.abs().max()
    err = (got[:, rows].double() - ref).abs().max() / scale
    if dtype == torch.float64:
        assert err <= 1e-13, float(err)
    else:
        p32 = (plain(torch.float32).double() - ref).abs().max() / scale
        bound = max(float(np.finfo(np.float32).eps / 2 * np.sqrt(n)),
                    2 * float(p32))
        assert err <= bound, (float(err), bound)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_rhs", [1, 2])
@pytest.mark.parametrize("radii", [(0.25, 0.45), (0.2, 0.3, 0.45),
                                   (0.1, 0.15, 0.2, 0.25, 0.3, 0.35, 0.4,
                                    0.45)])
def test_p2_matches_plain_bit_identical_on_repeat(cuda, radii, n_rhs, dtype):
    """P2 against its float64 plain version on a random periodic box (a
    coincident pair, one blob inside another) for G = 2, 3 and 8 groups:
    float64 to 1e-12, float32 to 3e-6 x max|ref|, twice bit-identical."""
    rng = np.random.default_rng(len(radii))
    n, L = 2000, 14.0
    r = rng.uniform(0, L, (n, 3))
    r[7] = r[6]
    r[9] = r[8] + 0.05
    groups = rng.integers(0, len(radii), n).astype(np.int32)
    # tolerance 1e-3: the tables of 36 group pairs in a few seconds
    p = ewald.default_params(max(radii), 1.0, (L, L, L), tol=1e-3,
                             cell_capacity=64, radii=radii)
    plan = ewald.make_plan(p, torch.as_tensor(r, dtype=dtype, device=cuda),
                           group_of=torch.as_tensor(groups, device=cuda))
    assert int(plan.n_dropped_cells) == 0
    f = torch.as_tensor(rng.normal(size=(n, 3 * n_rhs)), dtype=dtype,
                        device=cuda)
    args = (plan.positions, f, plan.group_of, plan.cell_table,
            plan.cell_dims, p.box, plan.params.cell_capacity)
    before = ck.LAUNCHES[f"near_rpy_radii_b{n_rhs}"]
    got = ck.near_rpy_radii(*args, plan.cheb_radii, plan.radii_edges,
                            r_cut=p.r_cut)
    again = ck.near_rpy_radii(*args, plan.cheb_radii, plan.radii_edges,
                              r_cut=p.r_cut)
    torch.cuda.synchronize()
    assert ck.LAUNCHES[f"near_rpy_radii_b{n_rhs}"] == before + 2
    assert torch.equal(got, again)
    ref = ck.near_rpy_radii_plain(
        plan.positions.double(), f.double(), *args[2:],
        plan.cheb_radii.double(), plan.radii_edges, r_cut=p.r_cut)
    bound = 1e-12 if dtype == torch.float64 else 3e-6
    err = (got.double() - ref).abs().max() / ref.abs().max()
    assert err <= bound, float(err)


def _p2_plan(cuda, radii, dtype, n=2000, seed=None):
    """make_plan on a random periodic box of n blobs in len(radii) groups
    (a coincident pair, one blob inside another), tolerance 1e-3."""
    rng = np.random.default_rng(len(radii) if seed is None else seed)
    L = 14.0
    r = rng.uniform(0, L, (n, 3))
    r[7] = r[6]
    r[9] = r[8] + 0.05
    groups = rng.integers(0, len(radii), n).astype(np.int32)
    p = ewald.default_params(max(radii), 1.0, (L, L, L), tol=1e-3,
                             cell_capacity=64, radii=radii)
    plan = ewald.make_plan(p, torch.as_tensor(r, dtype=dtype, device=cuda),
                           group_of=torch.as_tensor(groups, device=cuda))
    assert int(plan.n_dropped_cells) == 0
    return plan, rng


def _pair_keys(pairs):
    tid, sid, wrap = ck.decode_pairs(pairs)
    return [(int(t), int(s), tuple(w)) for t, s, w in
            zip(tid.tolist(), sid.tolist(), wrap.tolist())]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("radii", [(0.25, 0.45), (0.2, 0.3, 0.45)])
def test_p2_list_matches_plain_list(cuda, radii, dtype):
    """The kernel's list against the plain list's on the same positions:
    the same entries in the same order, but for pairs whose r^2 lies
    within 4 ulps of r_cut^2 in the positions' type (the kernel forms r^2
    with two FMAs, the plain version without): none in float64, at most 3
    in float32. The plan on the card carries the kernel's list."""
    plan, _ = _p2_plan(cuda, radii, dtype)
    p = plan.params
    got = plan.radii_pairs
    assert got is not None and got.positions is plan.positions
    before = ck.LAUNCHES["near_radii_pairs"]
    again = ck.near_radii_pairs(plan.positions, plan.group_of,
                                plan.cell_table, plan.cell_dims, p.box,
                                p.cell_capacity, r_cut=p.r_cut)
    assert ck.LAUNCHES["near_radii_pairs"] == before + 1
    assert torch.equal(got.offsets, again.offsets)
    assert torch.equal(got.entries, again.entries)
    ref = ck.near_radii_pairs_plain(
        plan.positions, plan.group_of, plan.cell_table, plan.cell_dims,
        p.box, p.cell_capacity, r_cut=p.r_cut)
    kg, kr = _pair_keys(got), _pair_keys(ref)
    differ = set(kg) ^ set(kr)
    assert len(differ) <= (0 if dtype == torch.float64 else 3), len(differ)
    ulp = torch.finfo(dtype).eps
    pos = plan.positions.double()
    for t, s, w in differ:
        d = pos[t] - pos[s] - torch.tensor(
            [wa * La for wa, La in zip(w, p.box)], dtype=torch.float64,
            device=cuda)
        assert abs(float(d @ d) / p.r_cut ** 2 - 1.0) <= 4 * ulp
    assert [k for k in kg if k not in differ] == \
        [k for k in kr if k not in differ]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_rhs", [1, 2])
@pytest.mark.parametrize("radii", [(0.25, 0.45), (0.2, 0.3, 0.45)])
def test_p2_list_product_matches_plain(cuda, radii, n_rhs, dtype):
    """The list product against its float64 plain version over the same
    list: float64 to 1e-12, float32 to 3e-6 x max|ref|, twice
    bit-identical, one product launch a call; the stateless call (its own
    list) gives the same bits as the plan's cached list, and a refreshed
    plan lists its new positions."""
    plan, rng = _p2_plan(cuda, radii, dtype, seed=10 + len(radii))
    p = plan.params
    f = torch.as_tensor(rng.normal(size=(plan.positions.shape[0],
                                         3 * n_rhs)), dtype=dtype,
                        device=cuda)
    args = (plan.positions, f, plan.group_of, plan.cell_table,
            plan.cell_dims, p.box, p.cell_capacity, plan.cheb_radii,
            plan.radii_edges)
    before = dict(ck.LAUNCHES)
    got = ck.near_rpy_radii(*args, r_cut=p.r_cut, pairs=plan.radii_pairs)
    again = ck.near_rpy_radii(*args, r_cut=p.r_cut, pairs=plan.radii_pairs)
    torch.cuda.synchronize()
    key = f"near_rpy_radii_b{n_rhs}"
    assert ck.LAUNCHES[key] == before[key] + 2
    assert ck.LAUNCHES["near_radii_pairs"] == before["near_radii_pairs"]
    assert torch.equal(got, again)
    assert torch.equal(got, ck.near_rpy_radii(*args, r_cut=p.r_cut))
    assert ck.LAUNCHES["near_radii_pairs"] == before["near_radii_pairs"] + 1
    pairs64 = dataclasses.replace(
        plan.radii_pairs, positions=plan.positions.double())
    ref = ck.near_rpy_radii_pairs_plain(pairs64, f.double(),
                                        plan.cheb_radii.double(),
                                        plan.radii_edges, p.box,
                                        r_cut=p.r_cut)
    bound = 1e-12 if dtype == torch.float64 else 3e-6
    err = (got.double() - ref).abs().max() / ref.abs().max()
    assert err <= bound, float(err)
    # the refresh branch: new positions, a new list, the same bits as the
    # stateless call there
    moved = plan.positions + 1e-3
    near = ewald.update_plan(plan, moved)
    assert near.sort_pos is plan.sort_pos
    assert near.radii_pairs.positions is near.positions
    fresh = ck.near_rpy_radii(near.positions, f, *args[2:], r_cut=p.r_cut)
    assert torch.equal(ck.near_rpy_radii(
        near.positions, f, *args[2:], r_cut=p.r_cut,
        pairs=near.radii_pairs), fresh)
    assert torch.equal(ewald.real_matvec(near, f),
                       fresh + near.self_coeff * f)
    with pytest.raises(ValueError, match="other positions"):
        ck.near_rpy_radii(near.positions, f, *args[2:], r_cut=p.r_cut,
                          pairs=plan.radii_pairs)


def _energy_kernels(fn):
    """The names of the CUDA kernels fn() runs (torch.profiler), from a
    second call: the first, outside the profiler's window, builds and
    loads the library and its kernels' modules."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.key for e in prof.key_averages()
            if "energy" in e.key or "partials" in e.key
            for _ in range(e.count)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("coincident", ["zero", "one"])
@pytest.mark.parametrize("box", sorted(M1_BOXES))
@pytest.mark.parametrize("n", [2, 3, 12, 31, 32, 33, 128])
def test_m1_small_instance_matches_plain(cuda, n, box, coincident, dtype):
    """M1's small instance (up to 128 blobs a configuration, one warp
    each; blob_pair_energy takes it up to ENERGY_SMALL_MAX) on 37
    configurations against its float64 plain version: float64 to 1e-12 of
    each configuration's energy, float32 within u32 sqrt(pairs), twice the
    float32 plain version's error or the rounding of its terms' inputs
    (_m1_term_bound), relative to the largest energy; twice bit-identical,
    one launch a call counted once."""
    r = _m1_scene(cuda, n, n_conf=37, seed=n).to(dtype)
    kw = dict(M1_LAW, periodic_length=M1_BOXES[box], coincident=coincident)
    before = mc.ENERGY_LAUNCHES
    got = mc.energy_kernel(r, **kw, small=True)
    again = mc.energy_kernel(r, **kw, small=True)
    torch.cuda.synchronize()
    assert mc.ENERGY_LAUNCHES == before + 2
    assert got.dtype == torch.float64 and got.shape == (37,)
    assert torch.equal(got, again)
    ref = mc.blob_blob_energy_plain(r.double(), **kw)
    if dtype == torch.float64:
        err = ((got - ref).abs() / ref.abs().clamp(min=1e-300)).max()
        assert float(err) <= 1e-12
        return
    scale = float(ref.abs().max())
    err = float((got - ref).abs().max()) / scale
    plain = float((mc.blob_blob_energy_plain(r, **kw) - ref).abs().max())
    terms = max(_m1_term_bound(r[p:p + 1].double(), kw)
                for p in range(r.shape[0]))
    bound = max(2 ** -24 * (n * (n - 1) / 2) ** 0.5, 2 * plain / scale,
                terms / scale)
    assert err <= bound, (err, bound)


def test_m1_small_instance_is_one_launch(cuda):
    """The rejection sampler's batch (4096 twelve-blob configurations) runs
    one kernel, the small instance, and ENERGY_SMALL_MAX + 1 blobs the
    tile sweep and its sum of partials: the instance follows n alone."""
    kw = dict(M1_LAW, periodic_length=M1_BOXES["xy"], coincident="one")
    small = _m1_scene(cuda, 12, n_conf=4096).float()
    names = _energy_kernels(lambda: mc.blob_pair_energy(small, **kw))
    assert len(names) == 1 and "energy_small_kernel" in names[0], names
    big = _m1_scene(cuda, mc.ENERGY_SMALL_MAX + 1, n_conf=2).float()
    names = _energy_kernels(lambda: mc.blob_pair_energy(big, **kw))
    assert len(names) == 2 and not any("small" in x for x in names), names


# ---------------------------------------------------------------------------
# The free surface, in_plane, P1's image boxes and K5's open instance
# ---------------------------------------------------------------------------

FS_POLICIES = {"open": None, "plane": (23.0, 19.0, 0.0),
               "general": (23.0, 19.0, 21.0), "general_L3": (3.0, 3.0, 0.0)}


def _surface_scene(n, seed, L=None):
    """_image_scene (or _tie_scene in a box) with its heights raw: blobs
    on the plane (one pair coincident there, its image at R = 0) and
    below a."""
    r, _ = _tie_scene(n, L, seed) if L else _image_scene(n, seed=seed)
    if n > 12:
        r[10, 2] = 0.0
        r[11] = r[10]
    return r / 0.3


@pytest.mark.parametrize("dtype, bound", [(torch.float32, 3e-6),
                                          (torch.float64, 1e-12)])
@pytest.mark.parametrize("square", [True, False])
@pytest.mark.parametrize("policy", sorted(FS_POLICIES))
@pytest.mark.parametrize("n_rhs", [1, 2])
def test_k1_free_surface_matches_plain(cuda, n_rhs, policy, square, dtype,
                                       bound):
    """K1's free-surface tt instance, both sweeps, open and under each
    image policy, against the plain version in float64, twice
    bit-identical, counted under "tt_fs"."""
    L = FS_POLICIES[policy]
    q = _surface_scene(300, 31, L)
    boxes = None if L is None else (L, pk.box_offsets(L))
    v = np.random.default_rng(32).normal(size=(300, 3 * n_rhs))
    qt = torch.as_tensor(q, dtype=dtype, device=cuda)
    vt = torch.as_tensor(v, dtype=dtype, device=cuda)
    kw = dict(coupling="tt", mode="free_surface", self_interaction=True,
              boxes=boxes)
    before = (dict(pk.LAUNCHES), dict(pk.IMAGE_LAUNCHES))
    got = pk.pair_matvec(qt, None if square else qt, vt, **kw)
    again = pk.pair_matvec(qt, None if square else qt, vt, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    ref = pk.pair_plain(qt.double(), qt.double(), vt.double(), **kw)
    assert ((got.double() - ref).abs().max().item()
            <= bound * ref.abs().max().item())
    if boxes is None:
        assert pk.LAUNCHES["tt_fs", n_rhs] == before[0]["tt_fs", n_rhs] + 2
    else:
        key = ("tt_fs", n_rhs, "sym" if square else "sliced")
        assert pk.IMAGE_LAUNCHES[key] == before[1][key] + 2
    assert pk.LAUNCHES["tt", n_rhs] == before[0]["tt", n_rhs]


@pytest.mark.parametrize("coupling", ["tt", "tr"])
@pytest.mark.parametrize("L", [(0.0, 0.0, 0.0), (6.9, 5.7, 0.0)])
def test_in_plane_products_on_the_wall_instance(cuda, L, coupling):
    """in_plane's products on K1's wall instance between the projections:
    u_z exactly 0 and the rest the CPU's float64 product."""
    from rigidmultiblobswall_tpu_torch.ops import mobility as mob

    r, _ = _image_scene(400, seed=33)
    v = np.random.default_rng(34).normal(size=(2, 400, 3))
    kw = dict(coupling=coupling, domain="in_plane", periodic_length=L)
    got = mob.pairwise_matvec_multi(
        torch.as_tensor(r, dtype=torch.float32, device=cuda), None,
        torch.as_tensor(v, dtype=torch.float32, device=cuda), 0.8, 0.3,
        **kw)
    ref = mob.pairwise_matvec_multi(torch.as_tensor(r), None,
                                    torch.as_tensor(v), 0.8, 0.3, **kw)
    assert not got[..., 2].any()
    assert ((got.double().cpu() - ref).abs().max().item()
            <= 3e-6 * ref.abs().max().item())


@pytest.mark.parametrize("dtype, bound", [(torch.float32, 3e-6),
                                          (torch.float64, 1e-12)])
@pytest.mark.parametrize("policy", sorted(FS_POLICIES))
@pytest.mark.parametrize("n", [33, 260])
def test_k3_free_surface_matches_plain(cuda, n, policy, dtype, bound):
    """K3's free-surface instance, open and under each image policy: the
    exact transpose of itself, against the plain builder in float64,
    twice bit-identical, counted in DENSE_TT_LAUNCHES."""
    L = FS_POLICIES[policy]
    r = _surface_scene(n, 35, L) * 0.3
    box = (0.0, 0.0, 0.0) if L is None else tuple(x * 0.3 for x in L)
    rt = torch.as_tensor(r, dtype=dtype, device=cuda)
    key = ("free_surface", L is not None)
    before = mc.DENSE_TT_LAUNCHES[key]
    got = mc.dense_tt(rt, 0.8, 0.3, mode="free_surface", periodic_length=box)
    again = mc.dense_tt(rt, 0.8, 0.3, mode="free_surface",
                        periodic_length=box)
    torch.cuda.synchronize()
    assert torch.equal(got, got.T) and torch.equal(got, again)
    assert mc.DENSE_TT_LAUNCHES[key] == before + 2
    ref = mc.dense_tt_plain(rt.double(), 0.8, 0.3, mode="free_surface",
                            periodic_length=box)
    err = (got.double() - ref).abs().max().item()
    assert err <= bound * ref.abs().max().item()


def _p1_box_scene(n, raised):
    """_radii_scene spread over twice the area, a coincident pair on the
    plane; `raised`: every blob lifted by 0.35, above the largest radius
    (0.3), so P1's free-surface z test settles every image far."""
    r, rad = _radii_scene(n, seed=36)
    r[:, :2] *= 2.0
    r[20, 2] = 0.0
    r[21] = r[20]
    if raised:
        r[:, 2] += 0.35
    return r, rad


@pytest.mark.parametrize("raised", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("box", [(0.0, 0.0, 0.0), (9.0, 8.0, 0.0),
                                 (9.0, 8.0, 7.0), (1.0, 1.0, 0.0)])
@pytest.mark.parametrize("domain", ["single_wall", "no_wall",
                                    "free_surface"])
@pytest.mark.parametrize("n_rhs", [1, 2])
def test_p1_images_and_free_surface_match_plain(cuda, n_rhs, domain, box,
                                                dtype, raised):
    """P1's image-box instance (the in-plane policy at (9, 8, 0), the
    general one at (1, 1, 0), under its far margin, and for a box
    periodic in z) and its free-surface instance against the
    source-target product in float64: float64 to 1e-12, float32 to 3e-6
    x max|ref|, twice bit-identical. The free surface's in-plane instance
    with blobs below their radius (its tile z test refused: the home
    box's image by its regime) and with every blob raised above it (the
    test passed: the image in the far form)."""
    from rigidmultiblobswall_tpu_torch.ops import mobility as mob

    n = 700
    r, rad = _p1_box_scene(n, raised)
    v = np.random.default_rng(37).normal(size=(n_rhs, n, 3))
    args = [torch.as_tensor(x, dtype=dtype, device=cuda) for x in (r, v, rad)]
    kw = dict(domain=domain, periodic_length=box)
    mode = {"single_wall": "wall", "no_wall": "open",
            "free_surface": "free_surface"}[domain]
    key = (n_rhs, mode, box[0] > 0)
    before = mc.RADII_LAUNCHES[key]
    got = mc.radii_matvec(*args, 1.3, **kw)
    again = mc.radii_matvec(*args, 1.3, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert mc.RADII_LAUNCHES[key] == before + 2
    sub = 300
    r64, v64, a64 = (x.double() for x in args)
    ref = torch.stack([mob.source_target_matvec(
        r64, r64[:sub], vb, a64, a64[:sub], 1.3, domain=domain,
        periodic_length=box) for vb in v64])
    bound = 1e-12 if dtype == torch.float64 else 3e-6
    err = (got[:, :sub].double() - ref).abs().max() / ref.abs().max()
    assert err <= bound, float(err)


def _fs_tile_scene(n, seed, cols=6):
    """Blobs of unit radius in the sweeps' 128-row tiles, each tile a 5 x 5
    x 3 cell of a grid of cells 8 apart with `cols` columns, heights in
    [1.2, 4.2], so that most tile pairs pass the open free surface's far
    test (boxes 3 apart, images beyond 2.4); tile 2 holds a blob below its
    radius (its tile pairs refused by images_far), tile 5's cell overlaps
    tile 4's (refused by boxes_far), tile 3 a coincident pair and tile 4 a
    coincident pair on the plane (its image at R = 0), tile 6 a blob at z
    = 1 (its image touching), and the last tile is ragged."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) // 128
    r = np.empty((n, 3))
    r[:, 0] = 8.0 * (t % cols) + rng.uniform(0, 5, n)
    r[:, 1] = 8.0 * (t // cols) + rng.uniform(0, 5, n)
    r[:, 2] = rng.uniform(1.2, 4.2, n)
    r[t == 5, 0] -= 6.0
    r[2 * 128 + 7, 2] = 0.5
    r[3 * 128 + 1] = r[3 * 128]
    r[4 * 128 + 3, 2] = 0.0
    r[4 * 128 + 4] = r[4 * 128 + 3]
    r[6 * 128 + 9, 2] = 1.0
    return r


@pytest.mark.parametrize("dtype, bound", [(torch.float32, 3e-6),
                                          (torch.float64, 1e-12)])
@pytest.mark.parametrize("n, rows", [(1842, None), (40000, 1024)])
@pytest.mark.parametrize("n_rhs", [1, 2])
def test_k1_free_surface_two_targets_match_plain(cuda, n_rhs, n, rows,
                                                 dtype, bound):
    """K1 tt_fs's open symmetric sweep, two targets a lane with the tile
    far test (csrc/pair_blocks.cuh sym2_kernel), on _fs_tile_scene (far
    tile pairs, pairs refused by each test, coincident pairs, a ragged
    tile; at 40,000 blobs groups of two tiles) against the plain version
    in float64 on every row or the leading `rows`, twice bit-identical,
    counted in LAUNCHES and SYM_LAUNCHES."""
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    if n == 40000:
        assert pk.plan_groups(n, n_sm)[1] > 1
    q = _fs_tile_scene(n, 40, cols=6 if n < 5000 else 18)
    v = np.random.default_rng(41).normal(size=(n, 3 * n_rhs))
    qt = torch.as_tensor(q, dtype=dtype, device=cuda)
    vt = torch.as_tensor(v, dtype=dtype, device=cuda)
    kw = dict(coupling="tt", mode="free_surface", self_interaction=True)
    before = (pk.LAUNCHES["tt_fs", n_rhs], pk.SYM_LAUNCHES["tt_fs", n_rhs])
    got = pk.pair_matvec(qt, None, vt, **kw)
    again = pk.pair_matvec(qt, None, vt, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert (pk.LAUNCHES["tt_fs", n_rhs], pk.SYM_LAUNCHES["tt_fs", n_rhs]) == (
        before[0] + 2, before[1] + 2)
    k = rows or n
    ref = pk.pair_plain(qt.double(), qt[:k].double(), vt.double(), **kw)
    assert ((got[:k].double() - ref).abs().max().item()
            <= bound * ref.abs().max().item())


@pytest.mark.parametrize("dtype, bound", [(torch.float32, 3e-6),
                                          (torch.float64, 1e-12)])
@pytest.mark.parametrize("n, rows", [(1842, None), (40000, 1024)])
@pytest.mark.parametrize("n_rhs", [1, 2])
def test_p1_free_surface_two_targets_match_plain(cuda, n_rhs, n, rows,
                                                 dtype, bound):
    """P1's open free surface, two targets a lane with the tile far test
    (csrc/pair_radii.cu radii_sym2_kernel), on _fs_tile_scene scaled to
    radii in [0.08, 0.3] (times 0.3): tile 2's blob below the plane (its
    tile pairs refused by above_plane), tile 5's cell over tile 4's, tile
    3 a coincident pair of unequal radii and one blob inside another,
    against the source-target product in float64 on every row or the
    leading `rows`, twice bit-identical, counted in RADII_LAUNCHES."""
    from rigidmultiblobswall_tpu_torch.ops import mobility as mob

    r = _fs_tile_scene(n, 42, cols=6 if n < 5000 else 18) * 0.3
    r[2 * 128 + 7, 2] = -0.1
    rad = np.random.default_rng(43).uniform(0.08, 0.3, n)
    rad[3 * 128], rad[3 * 128 + 1] = 0.1, 0.3
    r[3 * 128 + 5] = r[3 * 128 + 2] + 0.01
    rad[3 * 128 + 2], rad[3 * 128 + 5] = 0.3, 0.1
    v = np.random.default_rng(44).normal(size=(n_rhs, n, 3))
    args = [torch.as_tensor(x, dtype=dtype, device=cuda) for x in (r, v, rad)]
    key = (n_rhs, "free_surface", False)
    before = mc.RADII_LAUNCHES[key]
    got = mc.radii_matvec(*args, 1.3, domain="free_surface")
    again = mc.radii_matvec(*args, 1.3, domain="free_surface")
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert mc.RADII_LAUNCHES[key] == before + 2
    k = rows or n
    r64, v64, a64 = (x.double() for x in args)
    ref = torch.stack([mob.source_target_matvec(
        r64, r64[:k], vb, a64, a64[:k], 1.3, domain="free_surface")
        for vb in v64])
    err = (got[:, :k].double() - ref).abs().max() / ref.abs().max()
    assert err <= bound, float(err)


@pytest.mark.parametrize("dtype, bound", [(torch.float32, 3e-6),
                                          (torch.float64, 1e-12)])
@pytest.mark.parametrize("n_rhs", [1, 2])
def test_wall_images_match_plain_beside_the_free_surface(cuda, n_rhs,
                                                         dtype, bound):
    """The wall's in-plane image instances, whose code the free surface's
    box sums left as it was, on the free-surface tests' scenes: K1 tt
    (the symmetric sweep, BlockSum) and P1 (min_blocks 4, the far boxes in
    a loop) against their plain versions, twice bit-identical."""
    from rigidmultiblobswall_tpu_torch.ops import mobility as mob

    L = FS_POLICIES["plane"]
    boxes = (L, pk.box_offsets(L))
    assert pk.plane_far(boxes)
    q = _surface_scene(300, 31, L)
    q[:, 2] = np.maximum(q[:, 2], 1.0)
    v = np.random.default_rng(32).normal(size=(300, 3 * n_rhs))
    qt = torch.as_tensor(q, dtype=dtype, device=cuda)
    vt = torch.as_tensor(v, dtype=dtype, device=cuda)
    kw = dict(coupling="tt", mode="wall", self_interaction=True, boxes=boxes)
    got = pk.pair_matvec(qt, None, vt, **kw)
    assert torch.equal(got, pk.pair_matvec(qt, None, vt, **kw))
    ref = pk.pair_plain(qt.double(), qt.double(), vt.double(), **kw)
    assert ((got.double() - ref).abs().max().item()
            <= bound * ref.abs().max().item())
    for raised in (False, True):
        r, rad = _p1_box_scene(700, raised)
        vr = np.random.default_rng(37).normal(size=(n_rhs, 700, 3))
        args = [torch.as_tensor(x, dtype=dtype, device=cuda)
                for x in (r, vr, rad)]
        kw = dict(domain="single_wall", periodic_length=(9.0, 8.0, 0.0))
        got = mc.radii_matvec(*args, 1.3, **kw)
        assert torch.equal(got, mc.radii_matvec(*args, 1.3, **kw))
        r64, v64, a64 = (x.double() for x in args)
        ref = torch.stack([mob.source_target_matvec(
            r64, r64[:300], vb, a64, a64[:300], 1.3, **kw) for vb in v64])
        err = (got[:, :300].double() - ref).abs().max() / ref.abs().max()
        assert err <= bound, float(err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("cap", [512, 6])
@pytest.mark.parametrize("L3", [(0.0, 0.0, 0.0), (30.0, 30.0, 0.0),
                                (30.0, 0.0, 0.0)])
def test_k5_open_matches_plain(cuda, L3, cap, dtype):
    """K5's open instance in an open and a partly periodic box, with ample
    capacity and with overflowing cells (whose extra blobs keep their own
    rows), against its plain version in float64, twice bit-identical."""
    from rigidmultiblobswall_tpu_torch.ops import forces

    rng = np.random.default_rng(38)
    n = 6000
    r = np.empty((n, 3))
    r[:, :2] = rng.uniform(-2.0, 32.0, (n, 2))
    r[:, 2] = rng.uniform(0.2, 2.0, n)
    r[7] = r[6]
    pos, dims, table, dropped, frame, members = forces.open_force_cells(
        torch.as_tensor(r, dtype=dtype, device=cuda), L3, 1.9, 16, cap)
    assert (int(dropped) > 0) == (cap == 6)
    law = dict(eps_over_b=0.2 / 0.25, inv_b=1 / 0.25, two_a=0.4)
    before = ck.LAUNCHES["nl_forces_open"]
    got = ck.nl_forces_open(pos, table, dims, L3, frame, members, cap,
                            **law)
    again = ck.nl_forces_open(pos, table, dims, L3, frame, members, cap,
                              **law)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert ck.LAUNCHES["nl_forces_open"] == before + 2
    ref = ck.nl_forces_open_plain(pos.double(), table, dims, L3, members,
                                  cap, **law)
    # float32: the JAX package's f32 bound (3e-6 x max|ref|) where the
    # stencil's sum rounds below it (each term's approximate rsqrt and
    # exp2 set that floor at a small capacity)
    bound = (max(3e-6, _cell_bound(dtype, cap)) if dtype == torch.float32
             else _cell_bound(dtype, cap))
    assert _rel_err(got, ref) <= bound


# ---------------------------------------------------------------------------
# The rank-share instances of K1, K6, K7 and P2 (parallel/mesh.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype, bound", [(torch.float32, 3e-6),
                                          (torch.float64, 1e-12)])
@pytest.mark.parametrize("coupling, n_rhs, mode, images", [
    ("tt", 1, "wall", False), ("tt", 2, "wall", False),
    ("grand", 1, "wall", False), ("tr", 2, "open", False),
    ("rt", 1, "wall", False), ("rr", 2, "wall", False),
    ("tt", 2, "free_surface", False), ("tt", 1, "free_surface", True),
    ("tt", 1, "wall", True), ("grand", 1, "wall", True)])
def test_k1_rank_shares_sum_to_the_product(cuda, coupling, n_rhs, mode,
                                           images, dtype, bound):
    """The symmetric sweep over three ranks' group pairs sums to the full
    launch, each share matches its plain version (the plain sweep over
    the same group pairs), and the sliced sweep over a share of the rows
    with row0 puts the self pairs on their own rows."""
    r, q = _scene(1500, seed=5)
    nc = pk.NCOMP[coupling]
    rng = np.random.default_rng(6)
    qs = torch.as_tensor(q, dtype=dtype, device=cuda)
    v = torch.as_tensor(rng.normal(size=(1500, nc * n_rhs)), dtype=dtype,
                        device=cuda)
    boxes = pk.image_boxes((60.0, 60.0, 0.0), 1.0) if images else None
    kw = dict(coupling=coupling, mode=mode, self_interaction=True,
              boxes=boxes)
    total = pk.group_pairs(qs)
    shares = [(total * k // 3, total * (k + 1) // 3) for k in range(3)]
    parts = [pk.pair_matvec(qs, None, v, pairs=s, **kw) for s in shares]
    full = pk.pair_matvec(qs, None, v, **kw)
    assert _rel_err(sum(parts), full) <= bound
    plain = pk.pair_share_plain(qs.double(), v.double(), pairs=shares[1],
                                **kw)
    assert _rel_err(parts[1], plain) <= bound
    r0 = 500
    rows = pk.pair_matvec(qs, qs[r0:1100].contiguous(), v, row0=r0, **kw)
    ref = pk.pair_plain(qs.double(), qs[r0:1100].double(), v.double(),
                        row0=r0, **kw)
    assert _rel_err(rows, ref) <= bound


def test_cell_rank_shares_sum_exactly(cuda):
    """K6 over cell ranges, P2 over target ranges and K7 over column ranges
    write disjoint rows: the shares of three ranks sum to the full launch
    bit for bit, and a share leaves the other rows zero."""
    from rigidmultiblobswall_tpu_torch.ops import ewald_wall

    rng = np.random.default_rng(9)
    L, n = 20.0, 6000
    pos = torch.as_tensor(rng.uniform(0, L, (n, 3)), dtype=torch.float32,
                          device=cuda)
    f = torch.as_tensor(rng.normal(size=(n, 6)), dtype=torch.float32,
                        device=cuda)
    plan = ewald.make_plan(ewald.default_params(0.131, 1.0, (L,) * 3,
                                                tol=1e-3, grid_max=64), pos)
    p = plan.params
    C = int(np.prod(plan.cell_dims))
    args = (plan.positions, f, plan.cell_table, plan.cell_dims, p.box,
            p.cell_capacity, plan.cheb)
    kw = dict(two_a=2 * p.a, r_cut=p.r_cut)
    parts = [ck.near_rpy(*args, cells_range=(C * k // 3, C * (k + 1) // 3),
                         **kw) for k in range(3)]
    assert torch.equal(sum(parts), ck.near_rpy(*args, **kw))
    assert not bool(parts[0][parts[1].abs().sum(dim=1) > 0].any())
    pr = ewald.default_params(0.157, 1.0, (L,) * 3, tol=1e-3, grid_max=64,
                              radii=(0.131, 0.157))
    grp = torch.as_tensor(rng.integers(0, 2, n), dtype=torch.int32,
                          device=cuda)
    planr = ewald.make_plan(pr, pos, group_of=grp)
    call = (planr.positions, f, planr.group_of, planr.cell_table,
            planr.cell_dims, pr.box, planr.params.cell_capacity,
            planr.cheb_radii, planr.radii_edges)
    parts = [ck.near_rpy_radii(*call, r_cut=pr.r_cut, pairs=planr.radii_pairs,
                               targets=(n * k // 3, n * (k + 1) // 3))
             for k in range(3)]
    assert torch.equal(sum(parts), ck.near_rpy_radii(
        *call, r_cut=pr.r_cut, pairs=planr.radii_pairs))
    assert not bool(parts[0][n // 3:].any())
    wp = ewald_wall.default_wall_params(0.131, 1.0, (L, L), z_hi=2.6,
                                        tol=1e-3)
    posw = torch.as_tensor(np.stack([rng.uniform(0, L, n),
                                     rng.uniform(0, L, n),
                                     rng.uniform(0.2, 2.4, n)], 1),
                           dtype=torch.float32, device=cuda)
    wplan = ewald_wall.make_wall_plan(wp, posw)
    nx, ny, _ = wplan.cell_dims
    wargs, wkw = ewald_wall.near_args(wplan)
    cz = ewald_wall._kept_layers(wplan.params, wplan.cell_dims)
    parts = [ck.wall_near(wplan.pos_all, f, *wargs, cz_range=cz,
                          columns=(nx * ny * k // 3, nx * ny * (k + 1) // 3),
                          **wkw) for k in range(3)]
    assert torch.equal(sum(parts), ck.wall_near(wplan.pos_all, f, *wargs,
                                                cz_range=cz, **wkw))
