"""The rot-coupling stage of the spectral wall engine in the PyTorch port
(ops/ewald_wall_rot.py, kernel K8's plain version) against the JAX
package, float64 on the CPU, on the 20-roller scene of
tests/test_wall_rot_engine.py (9 x 9 box, a = 0.3) at tolerance 1e-4:

- the host tables (the rot remainders' Chebyshev fit and self term, the
  rot polish kernels) equal the JAX package's to 1e-12;
- grand_near (K8's plain version plus the rr self term) against
  grand_near_xla for (f, t), (f, None) and (None, t), 1e-10 x max|ref|,
  and with each output selection (want_v / want_w): the kept half at
  1e-10, the other exactly zero;
- rot_wave and grand_matvec against the JAX package's, 1e-9 x max|ref|
  (the JAX package's float32 z-DFT matrices swapped for float64 ones, as
  tests/test_torch_wall_spectral.py does), grand_matvec with each output
  selection; grand_matvec's symmetry and its single-block products;
- the generated header csrc/wall_img_terms.cuh equals a fresh emission,
  and the rot channels read only the radial values K8 stages;
- K8's padded Clenshaw series (tables zero-padded to whole groups of
  kGroup terms) equal the unpadded ones bit for bit, in float32 and
  float64, in the plain version's order and in the kernel's;
- a CPU model of K8's split walk (csrc/wall_rot_near.cu on
  csrc/cell_sweep.cuh's split_walk) reproduces the plain sweep at 1e-12
  for each instance and evaluates each pair inside r_cut once.
"""

import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rigidmultiblobswall_tpu.ops import _wall_channels_gen as jgen
from rigidmultiblobswall_tpu.ops import ewald_wall as jew
from rigidmultiblobswall_tpu.ops import ewald_wall_rot as jewr
from rigidmultiblobswall_tpu_torch.ops import _emit_wall_cuh
from rigidmultiblobswall_tpu_torch.ops import cell_kernels as ck
from rigidmultiblobswall_tpu_torch.ops import cells
from rigidmultiblobswall_tpu_torch.ops import ewald_wall as tew
from rigidmultiblobswall_tpu_torch.ops import ewald_wall_rot as tewr

from torch_parity import jax_zdft64, to_np

A, ETA, LBOX = 0.3, 1.2, 9.0
CSRC = Path(ck.__file__).resolve().parents[1] / "csrc"
LANES = 32
VARIANTS = {"ft": (True, True), "f": (True, False), "t": (False, True)}
# output selections (want_v, want_w) of each variant that form an output
SELECTIONS = [(which, want) for which in sorted(VARIANTS)
              for want in ("v", "w", "vw")
              if ck.rot_products(*VARIANTS[which], "v" in want, "w" in want)]


@functools.lru_cache(maxsize=None)
def _jax_zdft_real64(params):
    """The JAX rot stage's real-plane z-DFT in float64 (the package stores
    it in float32, as its tt matrices)."""
    gz = params.grid[2]
    _, _, (ra, rb) = jew._z_plane_ranges(params)
    m = np.exp(-2j * np.pi * np.outer(np.arange(ra, rb), np.arange(gz)) / gz)
    return m.real, m.imag


@pytest.fixture(scope="module")
def scene():
    """Both packages' plans and rot tables at the 20-roller scene, with
    the JAX package's z-DFT matrices in float64."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jew, "_host_zdft", jax_zdft64)
    mp.setattr(jewr, "_host_zdft_real", _jax_zdft_real64)
    rng = np.random.default_rng(3)
    n = 20
    pos = np.stack([rng.uniform(0, LBOX, n), rng.uniform(0, LBOX, n),
                    rng.uniform(1.4 * A, 3.2 * A, n)], axis=1)
    f, t = rng.normal(size=(n, 3)), rng.normal(size=(n, 3))
    kw = dict(z_hi=3.4 * A, tol=1e-4)
    pj = jew.default_wall_params(A, ETA, (LBOX, LBOX), near_impl="xla", **kw)
    pt = tew.default_wall_params(A, ETA, (LBOX, LBOX), **kw)
    out = dict(pos=pos, f=f, t=t, jparams=pj, tparams=pt,
               jplan=jew.make_wall_plan(pj, jnp.asarray(pos)),
               jtab=jewr.rot_tables_device(pj, jnp.float64),
               tplan=tew.make_wall_plan(pt, torch.as_tensor(pos)),
               ttab=tewr.rot_tables(pt, torch.float64, "cpu"))
    yield out
    mp.undo()


def _args(s, which, torch_side):
    has_f, has_t = VARIANTS[which]
    conv = torch.as_tensor if torch_side else jnp.asarray
    return (conv(s["f"]) if has_f else None, conv(s["t"]) if has_t else None)


def _rel(got, ref):
    scale = max(np.abs(np.asarray(r)).max() for r in ref)
    return max(np.abs(to_np(g) - np.asarray(r)).max()
               for g, r in zip(got, ref)) / scale


def test_host_tables_match_jax(scene):
    pj, pt = scene["jparams"], scene["tparams"]
    cj, sj = jewr._host_cheb_rot(pj)
    ct, st = tewr._host_cheb_rot(pt)
    assert ct.shape == cj.shape and ct.shape[:2] == (2, 3)
    assert np.abs(ct - cj).max() <= 1e-12 * np.abs(cj).max()
    assert abs(st - sj) <= 1e-12 * abs(sj)
    for a, b in zip(tewr._host_rot_polish(pt), jewr._host_rot_polish(pj)):
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1e-12 * np.abs(b).max()


@pytest.mark.parametrize("which", sorted(VARIANTS))
def test_grand_near_matches_jax(scene, which):
    ref = jewr.grand_near_xla(scene["jplan"], *_args(scene, which, False),
                              scene["jtab"])
    got = tewr.grand_near(scene["tplan"], *_args(scene, which, True),
                          scene["ttab"])
    assert _rel(got, ref) <= 1e-10


@pytest.mark.parametrize("which, want", SELECTIONS)
def test_grand_near_output_selection_matches_jax(scene, which, want):
    """The kept half against grand_near_xla at 1e-10 x its max; the half
    not asked for exactly zero."""
    ref = jewr.grand_near_xla(scene["jplan"], *_args(scene, which, False),
                              scene["jtab"])
    got = tewr.grand_near(scene["tplan"], *_args(scene, which, True),
                          scene["ttab"], want_v="v" in want,
                          want_w="w" in want)
    kept = [k for k, name in enumerate("vw") if name in want]
    assert _rel([got[k] for k in kept], [ref[k] for k in kept]) <= 1e-10
    for k in set(range(2)) - set(kept):
        assert bool((got[k] == 0).all())


@pytest.mark.parametrize("which", sorted(VARIANTS))
def test_rot_wave_matches_jax(scene, which):
    ref = jewr.rot_wave(scene["jplan"], *_args(scene, which, False),
                        scene["jtab"])
    got = tewr.rot_wave(scene["tplan"], *_args(scene, which, True),
                        scene["ttab"])
    assert _rel(got, ref) <= 1e-9


def test_grand_matvec_matches_jax(scene):
    ref = jewr.grand_matvec(scene["jplan"], *_args(scene, "ft", False),
                            scene["jtab"])
    got = tewr.grand_matvec(scene["tplan"], *_args(scene, "ft", True),
                            scene["ttab"])
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert np.abs(to_np(g) - r).max() <= 1e-9 * np.abs(r).max()


@pytest.mark.parametrize("which, want", [
    sel for sel in SELECTIONS if sel[1] != "vw"])
def test_grand_matvec_output_selection_matches_jax(scene, which, want):
    """A product that forms one output (the rollers' tr, rt and rr, and
    the others the flags allow) against the same output of the JAX
    package's full product, 1e-9 x its max; the other output is None."""
    ref = jewr.grand_matvec(scene["jplan"], *_args(scene, which, False),
                            scene["jtab"])
    got = tewr.grand_matvec(scene["tplan"], *_args(scene, which, True),
                            scene["ttab"], want_v=want == "v",
                            want_w=want == "w")
    k = "vw".index(want)
    assert got[1 - k] is None
    r = np.asarray(ref[k])
    assert np.abs(to_np(got[k]) - r).max() <= 1e-9 * np.abs(r).max()


def test_grand_matvec_symmetry_and_blocks(scene):
    """<(f1, t1), M (f2, t2)> = <(f2, t2), M (f1, t1)>, the f-only and
    t-only products add to the full one, and a product that forms one
    output alone gives that output."""
    plan, tab = scene["tplan"], scene["ttab"]
    f1, t1 = _args(scene, "ft", True)
    rng = np.random.default_rng(9)
    f2, t2 = (torch.as_tensor(rng.normal(size=f1.shape)) for _ in range(2))
    v1, w1 = tewr.grand_matvec(plan, f1, t1, tab)
    v2, w2 = tewr.grand_matvec(plan, f2, t2, tab)
    lhs = float(torch.sum(v1 * f2) + torch.sum(w1 * t2))
    rhs = float(torch.sum(v2 * f1) + torch.sum(w2 * t1))
    # the asymmetry is the engine's truncation: tests/test_wall_rot_engine.py
    # holds 0.2 tol at tol 1e-5; this scene's tol is 1e-4 (measured 1e-5)
    assert abs(lhs - rhs) < 0.2 * 1e-4 * max(abs(lhs), abs(rhs))
    vf, wf = tewr.grand_matvec(plan, f1, None, tab)
    vt, wt = tewr.grand_matvec(plan, None, t1, tab)
    assert torch.allclose(vf + vt, v1, atol=1e-11)
    assert torch.allclose(wf + wt, w1, atol=1e-11)
    # one output alone (the rollers' tr, rt and rr products) is the same,
    # and the output not formed is None
    for f, t, want, ref in ((None, t1, "v", vt), (None, t1, "w", wt),
                            (f1, None, "w", wf)):
        got = tewr.grand_matvec(plan, f, t, tab, want_v=want == "v",
                                want_w=want == "w")
        k = "vw".index(want)
        assert got[1 - k] is None
        assert torch.allclose(got[k], ref, rtol=0, atol=1e-14)


def test_emitted_header_is_fresh():
    """The committed header equals a fresh emission of the four generated
    functions; the rot channels read only c2_1, c2_2 and c2_3, the three
    series K8 stages (csrc/wall_rot_near.cu kImgFirst = 6)."""
    text = _emit_wall_cuh.emit()
    assert _emit_wall_cuh.HEADER.read_text() == text
    for fn in (jgen.img_terms, jgen.img_terms_rt, jgen.img_terms_tr,
               jgen.img_terms_rr):
        assert f"void {fn.__name__}(" in text
    reads = {c for fn in (tewr.gen.img_terms_rt, tewr.gen.img_terms_tr,
                          tewr.gen.img_terms_rr)
             for c in _emit_wall_cuh.radial_reads(fn)}
    assert reads == {"c2_1", "c2_2", "c2_3"}
    src = (CSRC / "wall_rot_near.cu").read_text()
    first = int(re.search(r"constexpr int kImgFirst = (\d+);", src)[1])
    assert _emit_wall_cuh.RADIAL[first:first + 3] == ("c2_1", "c2_2", "c2_3")


# ---------------------------------------------------------------------------
# K8's padded Clenshaw series
# ---------------------------------------------------------------------------


def _clenshaw_kernel_order(coeffs, t, group):
    """K8's Clenshaw (csrc/wall_rot_near.cu clenshaw): the table zero-padded
    to whole groups, the groups from the top, b = 2t b1 + (c_k - b2) a term
    (the kernel's fma rounds the product and the sum once; this model
    rounds both), closed by t b1 + (c_0 - b2)."""
    c = ck.pad_terms(coeffs, group)
    t2 = t + t
    b1 = torch.zeros_like(t)
    b2 = torch.zeros_like(t)
    for k in range(c.shape[-1] - 1, 0, -1):
        b1, b2 = t2 * b1 + (c[k] - b2), b1
    return t * b1 + (c[0] - b2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("K", [24, 32, 40, 48])
def test_padded_clenshaw_is_bit_identical(K, dtype):
    """A table zero-padded at the top to whole groups of kGroup terms gives
    the unpadded sums bit for bit: at the rot fit's K (already whole
    groups) and at K - 1, K - 3 and K - 7 terms (padded by 1, 3 and 7),
    at t over [-1, 1] and its ends, in the plain version's order
    (_clenshaw) and in the kernel's (fma order, rounded twice)."""
    rng = np.random.default_rng(K)
    t = torch.as_tensor(np.concatenate([rng.uniform(-1, 1, 4000),
                                        [-1.0, 1.0, 0.0, -0.0]]), dtype=dtype)
    for k in (K, K - 1, K - 3, K - 7):
        c = torch.as_tensor(rng.normal(size=k) * 0.5 ** np.arange(k),
                            dtype=dtype)
        padded = ck.pad_terms(c, GROUP)
        assert padded.shape[-1] % GROUP == 0
        assert padded.shape[-1] - k == -k % GROUP
        assert torch.equal(ck._clenshaw(padded, t), ck._clenshaw(c, t))
        assert torch.equal(_clenshaw_kernel_order(c, t, GROUP),
                           _clenshaw_kernel_order(c, t, 1))


# ---------------------------------------------------------------------------
# K8's split walk, modelled on the CPU
# ---------------------------------------------------------------------------


def _kernel_constants():
    """kSrc (float64), kRing, kMaxRot and kGroup of
    csrc/wall_rot_near.cu, kTgt and the warps a block of
    csrc/cell_sweep.cuh."""
    text = (CSRC / "wall_rot_near.cu").read_text()
    sweep = (CSRC / "cell_sweep.cuh").read_text()
    tile = re.search(r"cellk::Walk<T, (\d+), (\d+)>", text)
    return (int(tile[2]),
            int(re.search(r"constexpr int kRing = (\d+);", text)[1]),
            int(re.search(r"constexpr int kMaxRot = (\d+);", text)[1]),
            int(re.search(r"constexpr int kTgt = (\d+);", sweep)[1]),
            int(re.search(r"constexpr int kThreads = (\d+);", sweep)[1])
            // 32,
            int(re.search(r"constexpr int kGroup = (\d+);", text)[1]))


TILE, RING, MAX_ROT, CHUNK, WARPS, GROUP = _kernel_constants()
# K8's instances: (forces, torques, want_v, want_w) of the call each forms
INSTANCES = {"grand": (True, True, True, True),
             "rt": (True, False, False, True),
             "tr": (False, True, True, False),
             "rr": (False, True, False, True)}


@functools.lru_cache(maxsize=None)
def _slab():
    """A 12 x 12 slab of 300 rollers (a cluster near the wall among them),
    float64, and its rot tables' Chebyshev fit."""
    import dataclasses

    a, L, z_hi, n = 0.3, 12.0, 3.0, 300
    rng = np.random.default_rng(21)
    r = np.empty((n, 3))
    r[:, :2] = rng.uniform(0, L, (n, 2))
    r[:, 2] = rng.uniform(0.3 * a, 1.2 * z_hi, n)
    r[:80] = [6.1, 5.9, 0.7] + rng.uniform(-0.6, 0.6, (80, 3))
    r[81] = r[80]
    p = dataclasses.replace(tew.default_wall_params(a, 1.0, (L, L), z_hi),
                            cell_capacity=40)
    plan = tew.make_wall_plan(p, torch.as_tensor(r))
    assert int(plan.n_dropped_cells) == 0
    cheb, _ = tewr._host_cheb_rot(p)
    return plan, torch.as_tensor(cheb), torch.as_tensor(
        rng.normal(size=(n, 6)))


def _xor_tree(v):
    lanes = np.arange(LANES)
    for o in (16, 8, 4, 2, 1):
        v = v + v[lanes ^ o]
    return v[0]


def _split_stencil(ids, nbr, shift, pos, c, n, n2):
    """The stencil of cell c in stage_split's order: the real sources of
    its 27 cells (in the stencil's order), then their image sources; the
    ids, positions at the cells' shifts and the count of reals."""
    live = [ids[nb][ids[nb] < n2] for nb in nbr[c]]
    parts = [[(s[s < n], k) for k, s in enumerate(live)],
             [(s[s >= n], k) for k, s in enumerate(live)]]
    s_ids = np.concatenate([s for part in parts for s, _ in part])
    s_pos = np.concatenate([pos[s] + shift[c, k] for part in parts
                            for s, k in part])
    return s_ids, s_pos, sum(s.size for s, _ in parts[0])


def _walk_instance(inst, tile, chunk):
    """One K8 instance's schedule on the slab: (rows (N, 6), evaluated
    (target, source) pairs). The schedule records its batches; the pairs
    are evaluated in one call and the batches replayed in order."""
    plan, cheb, ft = _slab()
    has_f, has_t, want_v, want_w = INSTANCES[inst]
    args, kw = tewr.near_args(plan, cheb)
    table, dims, box, cap, cheb, img_cheb = args
    z0 = kw.pop("z0")
    pos = plan.pos_all.numpy()
    n, n2 = plan.n_real, pos.shape[0]
    ids = table.reshape(-1, cap).long().numpy()
    nbr = cells.neighbor_table(dims).numpy()
    shift = cells.wrap_counts(dims).numpy() * np.asarray(box)
    lo, hi = tew._kept_layers(plan.params, dims)
    rc2 = plan.params.r_cut ** 2
    entries, events = [], []
    for c in range(ids.shape[0]):
        if not lo <= c % dims[2] <= hi:
            continue
        targets = ids[c][ids[c] < n]
        if targets.size == 0:
            continue
        s_ids, s_pos, n_r = _split_stencil(ids, nbr, shift, pos, c, n, n2)
        for t0 in range(0, targets.size, chunk):
            t_chunk = targets[t0:t0 + chunk]
            for s0 in range(0, s_ids.size, tile):
                sid, spos = s_ids[s0:s0 + tile], s_pos[s0:s0 + tile]
                m = sid.size
                re_ = min(max(n_r - s0, 0), m)
                image = pos[sid, 2] + z0 < 0
                assert not image[:re_].any() and image[re_:].all()

                def entry(tid, j):
                    entries.append((tid, sid[j], spos[j]))
                    return len(entries) - 1

                def steps(start, end):
                    """The halves of 32 candidates of a part's 64-steps."""
                    for c0 in range(start, end, 2 * LANES):
                        yield [np.arange(h, min(h + LANES, m))
                               for h in (c0, c0 + LANES)]

                for warp in range(WARPS):
                    ring_i = []
                    for tt in range(warp, t_chunk.size, WARPS):
                        tid = int(t_chunk[tt])
                        r2 = ((pos[tid] - spos) ** 2).sum(-1)
                        inside = (r2 > 0) & (r2 < rc2)
                        # the real part: a real step's rows past re_ are
                        # images, which its z test drops
                        ring_r = []
                        for halves in steps(0, re_):
                            for j in halves:
                                ring_r += j[inside[j] & ~image[j]].tolist()
                            assert len(ring_r) <= RING
                            while len(ring_r) >= LANES:
                                events.append(("real", tid, [
                                    entry(tid, j) for j in ring_r[:LANES]]))
                                del ring_r[:LANES]
                        if ring_r:
                            events.append(("real", tid, [entry(tid, j)
                                                         for j in ring_r]))
                        events.append(("done", tid))
                        # the image part
                        for halves in steps(re_, m):
                            for j in halves:
                                ring_i += [(tid, jj) for jj in
                                           j[inside[j]].tolist()]
                            assert len(ring_i) <= RING
                            while len(ring_i) >= LANES:
                                events.append(("image", [
                                    (t_, entry(t_, j)) for t_, j in
                                    ring_i[:LANES]]))
                                del ring_i[:LANES]
                    if ring_i:
                        events.append(("image", [(t_, entry(t_, j))
                                                 for t_, j in ring_i]))
    tgt = np.array([e[0] for e in entries])
    src = np.array([e[1] for e in entries])
    src_pos = np.array([e[2] for e in entries])
    twin = torch.as_tensor(src % n)
    rows = ck.wall_rot_pair_rows(
        torch.as_tensor(pos[tgt] - src_pos), torch.as_tensor(pos[src, 2] + z0),
        torch.as_tensor(pos[tgt, 2] + z0),
        ft[:, :3][twin] if has_f else None,
        ft[:, 3:][twin] if has_t else None, cheb, img_cheb, want_v=want_v,
        want_w=want_w, **kw).numpy()
    out = np.zeros((n, 6))
    acc = {}
    for ev in events:
        if ev[0] == "real":
            lanes = np.zeros((LANES, 6))
            lanes[:len(ev[2])] = rows[ev[2]]
            acc[ev[1]] = acc.get(ev[1], 0.0) + lanes
        elif ev[0] == "done":
            out[ev[1]] += _xor_tree(acc.pop(ev[1], np.zeros((LANES, 6))))
        else:
            te = np.full(LANES, -1)
            te[:len(ev[1])] = [t_ for t_, _ in ev[1]]
            assert np.all(np.diff(te[:len(ev[1])]) >= 0)
            lanes = np.zeros((LANES, 6))
            lanes[:len(ev[1])] = rows[[e for _, e in ev[1]]]
            for t0 in np.unique(te[:len(ev[1])]):
                out[t0] += _xor_tree(np.where((te == t0)[:, None], lanes,
                                              0.0))
    return out, list(zip(tgt.tolist(), src.tolist()))


def _walk(which, tile=TILE, chunk=CHUNK, want="vw"):
    """A K8 call on the slab, strengths `which`, outputs `want`: the
    schedules of its instances (ck.rot_instances), each adding into its own
    half of the rows. Returns (rows, the pairs each instance evaluated)."""
    has_f, has_t = VARIANTS[which]
    out, visits = 0.0, []
    for inst in ck.rot_instances(has_f, has_t, "v" in want, "w" in want):
        rows, pairs = _walk_instance(inst, tile, chunk)
        out, visits = out + rows, visits + [pairs]
    return out, visits


def _plain(which, want="vw"):
    plan, cheb, ft = _slab()
    has_f, has_t = VARIANTS[which]
    args, kw = tewr.near_args(plan, cheb)
    return ck.wall_rot_near_plain(plan.pos_all,
                                  ft[:, :3] if has_f else None,
                                  ft[:, 3:] if has_t else None, *args,
                                  want_v="v" in want, want_w="w" in want,
                                  **kw).numpy()


def test_model_reads_the_kernel_constants():
    assert (TILE, RING, MAX_ROT, CHUNK, WARPS) == (1024, 128, 48, 128, 8)
    assert ck.MAX_CHEB_ROT == MAX_ROT
    assert GROUP == ck.ROT_GROUP == 8
    src = (CSRC / "wall_rot_near.cu").read_text()
    names = re.findall(r"ROT_ENTRY\(wall_rot_near_f32_(\w+),", src)
    assert names == list(INSTANCES)
    assert {f"wall_rot_near_{i}" for i in INSTANCES} <= set(ck.LAUNCHES)


def _check_walk(which, tile, chunk, want="vw"):
    ref = _plain(which, want)
    plan, _, _ = _slab()
    args, _ = tew.near_args(plan)
    _, inside, img = ck.wall_pair_counts(plan.pos_all, *args[:4],
                                         plan.params.r_cut, plan.params.z0)
    out, visits = _walk(which, tile, chunk, want)
    assert np.abs(out - ref).max() <= 1e-12 * np.abs(ref).max()
    for pairs in visits:
        assert len(pairs) == len(set(pairs)) == inside
        assert sum(1 for _, s in pairs if s >= plan.n_real) == img > 0
    return out


@pytest.mark.parametrize("which, tile, chunk", [
    ("ft", TILE, CHUNK), ("f", TILE, CHUNK), ("t", TILE, CHUNK),
    ("ft", 96, 8)])
def test_walk_reproduces_the_plain_sweep(which, tile, chunk):
    """The walk at the float64 kernel's tile, and at a tile of 96 sources
    with chunks of 8 targets (stencils in several tiles, real and image
    parts split across tiles, cells in several chunks), against the plain
    sweep at 1e-12; each pair inside r_cut once an instance."""
    _check_walk(which, tile, chunk)


@pytest.mark.parametrize("inst", sorted(INSTANCES))
def test_walk_per_instance(inst):
    """Each instance alone (the calls the wall rollers' products make), at
    a tile of 96 sources and chunks of 8 targets, against the plain sweep
    with the same outputs asked for; the half it does not form is zero."""
    has_f, has_t, want_v, want_w = INSTANCES[inst]
    which = "ft" if has_f and has_t else ("f" if has_f else "t")
    want = "v" * want_v + "w" * want_w
    assert ck.rot_instances(has_f, has_t, want_v, want_w) == (inst,)
    out = _check_walk(which, 96, 8, want)
    if not want_v:
        assert not out[:, :3].any()
    if not want_w:
        assert not out[:, 3:].any()
