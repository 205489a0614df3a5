"""Kernels K1, K2, K5, K6, K7, K8, L1, P1, P2 and M1 at the main paths'
shapes on a CUDA card.

    python3 tools/torch_profile_kernels.py \
        [--kernels k1,k2,k5,k6,k7,k8,l1,p1,p2,m1,k1img,k3img,k1fs,k3fs,
                   p1img,k5open,fsopen] [--plain-whole]
    python3 tools/torch_profile_kernels.py --root DIR --baseline
        # only the times of the paths' calls, with the package (and
        # chip_smoke.py) of another checkout DIR, e.g. the parent commit
        # unpacked with `git archive` into a directory that .gitignore
        # lists

Times are CUDA events, the mean of 10 launches after a warm-up, float32:
- k1 (csrc/pair_blocks.cuh): tt at 49,152 blobs (B = 1 and 2) and at
  12,288 blobs, and grand, rr, tr and rt (rr and tr with B = 1 and 2) at
  32,768 rollers, as the paths call them (the square product, on the
  symmetric sweep over ops/pair_kernels.py plan_groups' groups); but for
  --baseline also on the sliced sweep at
  launch_plan's slice count (the two-tensor call) and at a list of slice
  counts, with the largest difference to the path's call;
- k2 (csrc/blob_forces.cu): 49,152 blobs, 12,288 blobs, 32,768 rollers,
  and the periodic instance at the wall rollers' 32,768 in their box
  (chip_smoke.py phase 11) as the path calls it; but for --baseline also
  the image boxes' instance with the home box alone at the same shape
  (the minimum image by division), with its difference to the path's
  call;
- k5 (csrc/nl_forces.cu): the periodic spectral path's force cells (98,304
  blobs, chip_smoke.py phase 8) and the wall path's wall-slab force cells
  (phase 10); but for --baseline also each layout's work (candidate pairs,
  targets a cell, stencils against the staged tile, kSrc read from the
  source), the error of the kernel and of the float32 plain version
  against the float64 plain version on the first 256 cells, and whether
  two launches are bit-identical;
- k6 (csrc/near_rpy.cu): B = 1 and 2 at the periodic spectral path's plan
  (98,304 blobs, phase 8); but for --baseline also the plan's work (as
  k5's, and the pairs inside r_cut), and the errors and repeat as k5's;
- k7 (csrc/wall_near.cu): B = 1 and 2 at the wall path's plan (98,304
  blobs, chip_smoke.py phase 10); but for --baseline also the plan's work
  (candidates, pairs inside r_cut, image pairs), its stencils against the
  staged tile (kSrc, read from the source), and on the first 256 cells
  the error of the kernel and of the float32 plain version against the
  float64 plain version (what the float32 formulation alone costs);
- k8 (csrc/wall_rot_near.cu): each product of the wall rollers' engine
  (grand, rt, tr, rr) at the path's plan (32,768 rollers, chip_smoke.py
  phase 11, the automatic cell capacity; K and Ki printed), as the path
  calls it (the wrapper) and its kernel alone (the C entry point, 20
  launches, free of the wrapper's host time); with a checkout whose
  wrapper takes no output flags, the instance of the strengths present:
  (f, t), (f), (t), (t). But for --baseline also the plan's work, the
  kernel with no pair inside r_cut (the stencil, the staging and the
  candidate filter alone) and with the images out of reach (real pairs
  only), the host's time to enqueue the path's call, the kernel at other
  series lengths (the rot table zero-padded or cut to K' terms, the image
  series to Ki'), whose slopes are the cost of one Clenshaw term, and,
  where `ncu` is on the machine, its warp stall reasons of one launch of
  each product;
- l1 (csrc/laplace_layers.cu): each instance of the phoretic path at
  chip_smoke.py phase 15's shapes (49,152 blobs, the 64 x 64 x 8
  concentration grid, the wall on), as the path calls it: the BVP
  operator, the single layer and the surface gradient on the symmetric
  sweep, the field's D and S on the directed sweep; but for --baseline
  also each one's plan and bound, and dD and T (not on the path) on the
  symmetric sweep;
- p1 (csrc/pair_radii.cu): B = 1 and 2 at chip_smoke.py phase 18's shape
  (49,152 blobs of two radii above the wall) as the path calls it; but
  for --baseline also its plan, the pairs inside contact, its bound and
  the all-regime one (chip_smoke.py p1_bound);
- p2 (csrc/near_radii.cu): at chip_smoke.py phase 19's plan (98,304 blobs
  of two radius groups), the list build and the product over the plan's
  list, B = 1 and 2, as the path calls them (with an older checkout whose
  P2 walks the stencil, that walk); but for --baseline also the plan's
  work, the list's size, both bounds and the stateless call;
- m1 (csrc/blob_energy.cu): the rejection sampler's batch (4096 twelve-blob
  configurations) as the path calls it; but for --baseline also the
  floor an empty launch sets, and the small instance beside the tile
  sweep at n = 12 to 128 blobs and 4096, 64 and 1 configurations.
- k1img (csrc/pair_blocks.cuh, the image-box instances): K1 at chip_smoke.py
  phase 20's shapes and boxes as the paths call them (tt B = 1 and 2 at
  20a's 49,152 blobs, tt at 20b's 12,288, grand, tr, rr (B = 1 and 2) and
  rt at 20c's 32,768 rollers, grand at 20d's 4096 spheres) and the open
  tt at 49,152 blobs beside them, with each instance's policy (PlaneBoxes
  or ImageBoxes); but for --baseline also each one's resident blocks an
  SM and bound (chip_smoke.py img_k1_record's count);
- k3img (csrc/dense_tt.cu): K3 with images at 20b's 12,288 blobs in its
  box and the open K3 at 12,288 blobs; but for --baseline also their
  resident blocks an SM (where the library has dense_tt_shape) and
  bounds.
- k1fs (csrc/pair_fs.cu): K1's free-surface tt at chip_smoke.py phase
  21a's 49,152 blobs (B = 1 and 2), open and in 20a's (25.6, 25.6, 0) box,
  beside the wall's tt instance on the same inputs; k3fs
  (csrc/dense_tt.cu): K3's free-surface instance at 21d's 12,288 blobs,
  open and in 20b's box; p1img (csrc/pair_radii.cu): P1's image boxes at
  21c's bidisperse monolayer in (102.4, 102.4, 0) (B = 1 and 2) and its
  free surface at 21e's scene (open, and in 20a's box at B = 1 and 2); k5open
  (csrc/nl_forces.cu): K5's open instance at 21b's monolayer (open box)
  and 21c's (partly periodic), the capacity sized as the paths size it;
  their bounds are chip_smoke.py phase 21's. k1fs and p1img print each
  float32 instance's error against its float64 plain version on the first
  ERR_ROWS target rows, over max|ref|. With --plain-whole, k1fs and
  p1img also time each instance's plain version over its whole sweep
  once (the image boxes' take 0.5-3 min each: chip_smoke.py times them
  on their first row tiles alone).
- fsopen (csrc/pair_fs.cu, csrc/pair_radii.cu): the open free-surface
  sweeps, each alternating with the instances beside it on the same
  inputs: K1 tt_fs open, the wall's open tt and tt_fs images at 21a's
  49,152 blobs, P1 free surface open, the open wall P1 and the free
  surface's P1 images at 21e's bidisperse scene, B = 1 and 2; but for
  --baseline also the open free-surface instances' bounds, a repeat
  check and their float32 error on the first ERR_ROWS rows.
For alternating runs against another tree, run the tool once a tree in
turns (--root DIR --baseline, then --baseline here, and again): each
process prints its times; the SASS of a tree is counted by a run without
--baseline, with --root for the other tree.
But for --baseline it prints the ptxas registers and spills of the chosen
kernels' instances (when this process built the library) and
counts, per instance of the chosen kernels in the library's SASS
(cuobjdump), the MUFU.EX2, MUFU.RSQ and MUFU.RCP instructions, the FRND
and F2I conversions (which run at the MUFU's rate) and the subroutine
calls (for fsopen also each pair loop's far path, its instructions a pair in
all and by class: FP32, MUFU, SHFL, branch or predicate, other;
for k1img, k3img and the image instances of k1fs, k3fs and p1img also
the instructions a box on the far path:
the shortest path through each pair loop, an inner loop over the boxes
taken 9 times, over the boxes its MUFU.RSQ count; for k8 also the LDS,
FFMA, FADD and FMUL of each loop of its
instances' SASS: the Clenshaw loops; for l1, of the path's float32 wall
instances, each pair loop's MUFU, SHFL, LDS, FFMA,
FADD, FMUL and FSEL a pair, a pair counted by its two MUFU.RSQ, the real
source's and the image's; for p1, each path through each pair loop, its
instructions and those ops a pair); --sass-out (default
build/kernels_sass.txt) receives
the counts and those instances' listing. Checks against the plain
versions are chip_smoke.py's and the card tests'.
"""

import argparse
import dataclasses
import inspect
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]

# name fragments of each kernel's instances (ptxas lines and SASS
# functions); K3 shares K1's tt condensing
INSTANCES = {"k1": ("pair_kernel<", "sym_kernel<", "slice_sum", "dense_tt"),
             "k2": ("force_",),
             "k5": ("nl_forces",),
             "k6": ("near_rpy",),
             "k7": ("wall_near",),
             "k8": ("wall_rot_near",),
             # the path's float32 wall instances: the symmetric sweep's BVP
             # operator (4), single layer (0) and gradient (5), the
             # directed sweep's D (1) and S without the mask
             "l1": ("l1_sym<float, 4, true", "l1_sym<float, 0, true",
                    "l1_sym<float, 5, true",
                    "l1_directed<float, 1, true, false",
                    "l1_directed<float, 0, true, false"),
             "p1": ("radii_sym_kernel<",),
             "p2": ("pairs_kernel<", "product_kernel<"),
             "m1": ("energy_small_kernel<", "energy_kernel<"),
             # the float32 wall image instances of K1 on both sweeps (the
             # policy PlaneBoxes or, in an older tree, ImageBoxes) and K3
             "k1img": tuple(
                 f"kernel<float, pairk::{c}, {b}, true, pairk::{g}"
                 for c, b in (("DiagCoupling<false>", 1),
                              ("DiagCoupling<false>", 2),
                              ("DiagCoupling<true>", 1),
                              ("DiagCoupling<true>", 2),
                              ("CrossCoupling<true, 2>", 1),
                              ("CrossCoupling<true, 2>", 2),
                              ("CrossCoupling<false, 1>", 1),
                              ("Grand", 1))
                 for g in ("PlaneBoxes", "ImageBoxes")),
             "k3img": ("dense_tt_kernel<float, true",),
             "k1fs": ("pairk::FreeSurface",),
             "k3fs": ("dense_tt_kernel<float, false, pairk::OpenBox<float>, "
                      "true", "dense_tt_kernel<float, false, "
                      "pairk::PlaneBoxes<float>, true"),
             "p1img": ("radii_sym_kernel<float, 1, 1, pairk::",
                       "radii_sym_kernel<float, 2, 1, pairk::",
                       "radii_sym_kernel<float, 1, 2, ",
                       "radii_sym_kernel<float, 2, 2, "),
             "k5open": ("nl_forces_kernel<float, true",),
             # the open symmetric sweeps of the free surface and their
             # neighbours: the wall's tt (B = 1, 2), K1 tt_fs on one target
             # a lane (sym_kernel) or two (sym2_kernel), P1's free surface
             # and open wall on one target a lane or two (radii_sym2_kernel)
             "fsopen": tuple(
                 f"sym_kernel<float, pairk::{c}, {b}, true, pairk::OpenBox"
                 for c in ("DiagCoupling<false>", "FreeSurface")
                 for b in (1, 2))
             + ("pairk::sym2_kernel<float",
                "radii_sym_kernel<float, 1, 2, RadiiOpen",
                "radii_sym_kernel<float, 2, 2, RadiiOpen",
                "radii_sym_kernel<float, 1, 1, RadiiOpen",
                "radii_sym2_kernel<float")}

# slice counts K1's sliced sweep is timed at, per shape
SWEEP = {"tt49k": (8, 24, 48, 96),
         "tt49k_b2": (24, 48),
         "tt12k": (24, 48, 96),
         "grand": (8, 16, 32, 64)}


# ---------------------------------------------------------------- K1


def k1_scenes(cs, dev):
    """(name, coupling, q, v) at the main paths' shapes, float32."""
    from rigidmultiblobswall_tpu_torch.models import kinematics as kin
    from rigidmultiblobswall_tpu_torch.models.system import make_state
    from rigidmultiblobswall_tpu_torch.ops import mobility as mob

    out = []
    g = torch.Generator(device=dev).manual_seed(1)
    for n_shells, tag in ((cs.N_SHELLS, "tt49k"), (cs.N_DENSE, "tt12k")):
        pos, quat = cs.lattice(n_shells)
        system = cs.bench_system(n_shells)
        state = make_state(pos, quat, dtype=torch.float32, device=dev)
        r = kin.blob_positions(system, state).contiguous()
        q = (mob.shift_heights(r, cs.A_BENCH) / cs.A_BENCH).contiguous()
        n = q.shape[0]
        out.append((tag, "tt", q, torch.randn((n, 3), generator=g,
                                              device=dev)))
        if tag == "tt49k":
            out.append(("tt49k_b2", "tt", q, torch.randn(
                (n, 6), generator=g, device=dev)))
    r = torch.as_tensor(cs.roller_lattice(cs.N_ROLLERS), device=dev)
    q = (mob.shift_heights(r, cs.A_ROLLER) / cs.A_ROLLER).contiguous()
    n = q.shape[0]
    for tag, coupling, nv in (("grand", "grand", 6), ("rr", "rr", 3),
                              ("rr_b2", "rr", 6), ("tr", "tr", 3),
                              ("tr_b2", "tr", 6), ("rt", "rt", 3)):
        out.append((tag, coupling, q, torch.randn((n, nv), generator=g,
                                                  device=dev)))
    return out


def sliced(pk, lib, coupling, q, v, want):
    """The sliced sweep of the square product in `want` slices (rounded
    to whole tiles a slice), launched through the C entry point; returns
    (out, S, tiles_per_slice)."""
    n, nv = v.shape
    s_tiles = -(-n // pk.TILE)
    tiles = -(-s_tiles // min(want, s_tiles))
    n_slices = -(-s_tiles // tiles)
    out = torch.empty_like(v)
    ws = torch.empty((n_slices, n, nv), dtype=v.dtype, device=v.device)
    name = f"pair_{coupling}_f32"
    err = getattr(lib, name)(
        q.data_ptr(), q.data_ptr(), v.data_ptr(), out.data_ptr(),
        ws.data_ptr(), n, n, nv // pk.NCOMP[coupling], n_slices, tiles, 1, 1,
        0, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{name}: CUDA error {err}")
    return out, n_slices, tiles


def profile_k1(cs, dev, detail):
    """Prints each shape's time as the paths call it and, with detail,
    on the sliced sweep at SWEEP's slice counts."""
    from rigidmultiblobswall_tpu_torch.ops import pair_kernels as pk

    for tag, coupling, q, v in k1_scenes(cs, dev):
        kw = dict(coupling=coupling, mode="wall", self_interaction=True)
        n_rhs = v.shape[1] // pk.NCOMP[coupling]
        head = f"  K1 {tag} {q.shape[0]} x B={n_rhs}"
        ms = cs.cuda_ms(lambda: pk.pair_matvec(q, None, v, **kw), 10)
        if not detail:
            print(f"{head}: {ms:.3f} ms", flush=True)
            continue
        n_sm = torch.cuda.get_device_properties(
            q.device).multi_processor_count
        g, per = pk.plan_groups(q.shape[0], n_sm)
        print(f"{head} symmetric sweep, {g} groups of {per} tiles: "
              f"{ms:.3f} ms", flush=True)
        path = pk.pair_matvec(q, None, v, **kw).double()
        s, tiles = pk.launch_plan(coupling, q, q, v, mode="wall")
        ms = cs.cuda_ms(lambda: pk.pair_matvec(q, q, v, **kw), 10)
        rel = ((pk.pair_matvec(q, q, v, **kw).double() - path).abs()
               .max() / path.abs().max()).item()
        print(f"{head} sliced sweep at the plan's S={s} ({tiles} tiles "
              f"a slice): {ms:.3f} ms, max diff to the path's call / "
              f"max {rel:.2e}", flush=True)
        lib = pk._build.library()
        for want in SWEEP.get(tag, ()):
            ms = cs.cuda_ms(lambda: sliced(pk, lib, coupling, q, v, want),
                            10)
            out, s, tiles = sliced(pk, lib, coupling, q, v, want)
            rel = ((out.double() - path).abs().max()
                   / path.abs().max()).item()
            print(f"{head} S={s} ({tiles} tiles a slice): {ms:.3f} ms, "
                  f"max diff to the path's call / max {rel:.2e}", flush=True)


# ------------------------------------------------- K1's and K3's images


def k1img_scenes(cs, dev):
    """(tag, coupling, q, v, L) at chip_smoke.py phase 20's shapes and
    boxes (L in units of a; None for the open tt beside them), float32."""
    from rigidmultiblobswall_tpu_torch.models import kinematics as kin
    from rigidmultiblobswall_tpu_torch.models.system import make_state
    from rigidmultiblobswall_tpu_torch.ops import mobility as mob

    out = []
    g = torch.Generator(device=dev).manual_seed(20)
    for n_shells, box, tags in ((cs.N_SHELLS, cs.L_PSEUDO,
                                 ("tt49k", "tt49k_b2", "tt49k_open")),
                                (cs.N_DENSE, cs.L_PSEUDO_DENSE,
                                 ("tt12k",))):
        pos, quat = cs.lattice(n_shells)
        state = make_state(pos, quat, dtype=torch.float32, device=dev)
        r = kin.blob_positions(cs.bench_system(n_shells), state)
        q = (mob.shift_heights(r, cs.A_BENCH) / cs.A_BENCH).contiguous()
        L = (box / cs.A_BENCH, box / cs.A_BENCH, 0.0)
        for tag in tags:
            nv = 6 if tag.endswith("b2") else 3
            out.append((tag, "tt", q, torch.randn(
                (q.shape[0], nv), generator=g, device=dev),
                None if tag.endswith("open") else L))
    r = torch.as_tensor(cs.roller_lattice(cs.N_ROLLERS), device=dev)
    q = (mob.shift_heights(r, cs.A_ROLLER) / cs.A_ROLLER).contiguous()
    L = (cs.L_PSEUDO_ROLLERS / cs.A_ROLLER,) * 2 + (0.0,)
    for tag, coupling, nv in (("grand", "grand", 6), ("tr", "tr", 3),
                              ("tr_b2", "tr", 6), ("rr", "rr", 3),
                              ("rr_b2", "rr", 6), ("rt", "rt", 3)):
        out.append((tag, coupling, q, torch.randn(
            (q.shape[0], nv), generator=g, device=dev), L))
    p = torch.as_tensor(cs.lub_lattice(cs.N_LUB), device=dev)
    q = mob.shift_heights(p, 1.0).contiguous()
    out.append(("grand_lub", "grand", q, torch.randn(
        (q.shape[0], 6), generator=g, device=dev),
        (cs.L_PSEUDO_LUB, cs.L_PSEUDO_LUB, 0.0)))
    return out


def image_policy(pk, boxes):
    """(images argument of the shape entries, policy name) of a box list:
    PlaneBoxes where this tree has the in-plane policy and takes it."""
    if boxes is None:
        return 0, "open"
    if hasattr(pk, "plane_far") and pk.plane_far(boxes):
        return 2, "PlaneBoxes"
    return 1, "ImageBoxes"


def profile_k1img(cs, dev, detail):
    """K1's image instances at phase 20's shapes as the paths call them
    (the square product, the symmetric sweep), 10 launches a time, and
    the open tt at 49,152 blobs; with detail their resident blocks and
    bounds (chip_smoke.py img_k1_record's count)."""
    from rigidmultiblobswall_tpu_torch.ops import pair_kernels as pk

    for tag, coupling, q, v, L in k1img_scenes(cs, dev):
        boxes = None if L is None else (L, pk.box_offsets(L))
        kw = dict(coupling=coupling, mode="wall", self_interaction=True,
                  boxes=boxes)
        n, nc = q.shape[0], pk.NCOMP[coupling]
        n_rhs = v.shape[1] // nc
        images, policy = image_policy(pk, boxes)
        ms = cs.cuda_ms(lambda: pk.pair_matvec(q, None, v, **kw), 10)
        head = f"  K1img {tag} {n} x B={n_rhs} ({policy})"
        if not detail:
            print(f"{head}: {ms:.3f} ms", flush=True)
            continue
        blocks = pk._resident_blocks(coupling, False, n_rhs, "wall",
                                     images if hasattr(pk, "plane_far")
                                     else bool(images))
        apply = cs.K1_APPLY_FLOPS[coupling]
        per_pair = (cs.K1_PAIR_FLOPS[coupling]
                    + cs.K1_SYM_EXTRA_FLOPS.get(coupling, 0) - apply
                    + 2 * apply * n_rhs) / 2
        n_boxes = 1 if boxes is None else len(boxes[1])
        periodic = 0 if L is None else sum(1 for x in L if x > 0)
        rec = cs.bound_record(4 * n * (3 + 2 * nc * n_rhs),
                              n * n * (n_boxes * per_pair
                                       + cs.K1_IMAGE_FLOPS * periodic / 2))
        print(f"{head}: {ms:.3f} ms, bound {rec['bound_ms']:.3f} ms "
              f"({rec['bound_by']}, {rec['bound_ms'] / ms:.1%}), "
              f"{blocks} resident blocks an SM", flush=True)


def profile_k3img(cs, dev, detail):
    """K3 with images at 20b's 12,288 blobs in its box and the open K3
    at 12,288 blobs, 5 launches a time; with detail their resident
    blocks (where the library has dense_tt_shape) and bounds."""
    import ctypes

    from rigidmultiblobswall_tpu_torch.models import kinematics as kin
    from rigidmultiblobswall_tpu_torch.models.system import make_state
    from rigidmultiblobswall_tpu_torch.ops import mobility_cuda as mc
    from rigidmultiblobswall_tpu_torch.ops import pair_kernels as pk

    box = (cs.L_PSEUDO_DENSE, cs.L_PSEUDO_DENSE, 0.0)
    system = cs.bench_system(cs.N_DENSE)
    pos, quat = cs.lattice(cs.N_DENSE)
    state = make_state(pos, quat, dtype=torch.float32, device=dev)
    r = kin.blob_positions(system, state).contiguous()
    n = r.shape[0]
    lib = pk._build.library()
    for tag, L in (("images", box), ("open", (0.0, 0.0, 0.0))):
        images, policy = image_policy(pk, pk.image_boxes(L, cs.A_BENCH))
        ms = cs.cuda_ms(lambda: mc.dense_tt(r, system.eta, cs.A_BENCH,
                                            mode="wall", periodic_length=L),
                        5)
        torch.cuda.empty_cache()
        head = f"  K3img {tag} {n} blobs ({policy})"
        if not detail:
            print(f"{head}: {ms:.3f} ms", flush=True)
            continue
        blocks = "n/a (no dense_tt_shape)"
        if hasattr(lib, "dense_tt_shape"):
            b = ctypes.c_int(0)
            pk._build.check("dense_tt_shape", lib.dense_tt_shape(
                0, images, 1, ctypes.byref(b)))
            blocks = b.value
        n3 = 3 * n
        n_boxes = 9 if images else 1
        rec = cs.bound_record(4 * (n3 * n3 + n3), n * (n + 1) // 2 * (
            n_boxes * cs.K3_PAIR_FLOPS
            + (2 * cs.K1_IMAGE_FLOPS if images else 0)))
        print(f"{head}: {ms:.3f} ms, bound {rec['bound_ms']:.3f} ms "
              f"({rec['bound_by']}, {rec['bound_ms'] / ms:.1%}), {blocks} "
              f"resident blocks an SM", flush=True)


# ------------------------------------------- phase 21's new instances


def _fs_scene(cs, dev):
    """21a's 49,152 blobs (phase 6's lattice) in units of a, raw heights."""
    from rigidmultiblobswall_tpu_torch.models import kinematics as kin
    from rigidmultiblobswall_tpu_torch.models.system import make_state

    system = cs.bench_system(cs.N_SHELLS, domain="free_surface")
    pos, quat = cs.lattice(cs.N_SHELLS)
    state = make_state(pos, quat, dtype=torch.float32, device=dev)
    return (kin.blob_positions(system, state) / cs.A_BENCH).contiguous()


# --plain-whole: time the plain versions of k1fs and p1img whole
PLAIN_WHOLE = False


def plain_whole(cs, fn):
    """The plain version's whole sweep, timed once, as a log fragment
    (empty without --plain-whole)."""
    if not PLAIN_WHOLE:
        return ""
    ms = cs.cuda_ms(fn, 1, warmup=False)
    torch.cuda.empty_cache()
    return f"; plain f32 whole sweep {ms:.1f} ms"


# the target rows k1fs and p1img hold against the float64 plain version
ERR_ROWS = 1024


def rel_err(got, ref):
    """max |got - ref| / max |ref| over ref's rows (got's first rows)."""
    rows = got[..., :ref.shape[-2], :].double()
    return ((rows - ref).abs().max() / ref.abs().max()).item()


def profile_k1fs(cs, dev, detail):
    """K1's free-surface tt at 21a's shape, open and in 20a's box, beside
    the wall's tt instance (alternating, chip_smoke.py alternating_ms)."""
    from rigidmultiblobswall_tpu_torch.ops import pair_kernels as pk

    q = _fs_scene(cs, dev)
    n = q.shape[0]
    g = torch.Generator(device=dev).manual_seed(21)
    La = tuple(x / cs.A_BENCH for x in (cs.L_FS_IMAGES,) * 2) + (0.0,)
    for n_rhs in (1, 2):
        v = torch.randn((n, 3 * n_rhs), generator=g, device=dev)
        for L in (None, La):
            boxes = None if L is None else (L, pk.box_offsets(L))
            kw = dict(coupling="tt", self_interaction=True, boxes=boxes)
            fs, wall = cs.alternating_ms([
                lambda: pk.pair_matvec(q, None, v, mode="free_surface", **kw),
                lambda: pk.pair_matvec(q, None, v, mode="wall", **kw)])
            tag = "open" if L is None else "images"
            plain = plain_whole(cs, lambda: pk.pair_plain(
                q, q, v, mode="free_surface", **kw))
            err = rel_err(
                pk.pair_matvec(q, None, v, mode="free_surface", **kw),
                pk.pair_plain(q.double(), q[:ERR_ROWS].double(), v.double(),
                              mode="free_surface", **kw))
            print(f"  K1fs {tag} {n} x B={n_rhs}: {fs:.3f} ms (the wall's "
                  f"tt {wall:.3f} ms){plain}; f32 err / max|ref| {err:.3e}",
                  flush=True)


def profile_k3fs(cs, dev, detail):
    """K3's free-surface instance at 21d's 12,288 blobs, open and in 20b's
    box, beside the wall's K3 (alternating)."""
    from rigidmultiblobswall_tpu_torch.models import kinematics as kin
    from rigidmultiblobswall_tpu_torch.models.system import make_state
    from rigidmultiblobswall_tpu_torch.ops import mobility_cuda as mc

    system = cs.bench_system(cs.N_DENSE, domain="free_surface")
    pos, quat = cs.lattice(cs.N_DENSE)
    state = make_state(pos, quat, dtype=torch.float32, device=dev)
    r = kin.blob_positions(system, state).contiguous()
    for tag, L in (("open", (0.0, 0.0, 0.0)),
                   ("images", (cs.L_PSEUDO_DENSE, cs.L_PSEUDO_DENSE, 0.0))):
        fs, wall = cs.alternating_ms([
            lambda: mc.dense_tt(r, 1.0, cs.A_BENCH, mode="free_surface",
                                periodic_length=L),
            lambda: mc.dense_tt(r, 1.0, cs.A_BENCH, mode="wall",
                                periodic_length=L)])
        torch.cuda.empty_cache()
        print(f"  K3fs {tag} {r.shape[0]} blobs: {fs:.3f} ms (the wall's K3 "
              f"{wall:.3f} ms)", flush=True)


def profile_p1img(cs, dev, detail):
    """P1's image boxes at 21c's bidisperse monolayer in its box (B = 1
    and 2) and its free surface at 21e's scene, open and in 20a's box,
    beside the open wall instance (alternating)."""
    from rigidmultiblobswall_tpu_torch.models import kinematics as kin
    from rigidmultiblobswall_tpu_torch.models.system import make_state
    from rigidmultiblobswall_tpu_torch.ops import mobility as mob
    from rigidmultiblobswall_tpu_torch.ops import mobility_cuda as mc

    g = torch.Generator(device=dev).manual_seed(21)
    mpos, mquat = cs.alternate(*cs.monolayer())
    epos, equat = cs.alternate(*cs.lattice(cs.N_SHELLS))
    box_c = (cs.L_MONOLAYER, cs.L_MONOLAYER, 0.0)
    box_e = (cs.L_FS_IMAGES, cs.L_FS_IMAGES, 0.0)
    for tag, pos, quat, domain, box, rhs in (
            ("images", mpos, mquat, "single_wall", box_c, (1, 2)),
            ("free surface", epos, equat, "free_surface", (0.0,) * 3, (1,)),
            ("free surface images", epos, equat, "free_surface", box_e,
             (1, 2))):
        system = cs.radii_system(len(pos))
        state = make_state(pos, quat, dtype=torch.float32, device=dev)
        r = kin.blob_positions(system, state).contiguous()
        radii = torch.tensor(system.blob_radii, dtype=torch.float32,
                             device=dev)
        for n_rhs in rhs:
            v = torch.randn((n_rhs, r.shape[0], 3), generator=g, device=dev)
            ms, open_ms = cs.alternating_ms([
                lambda: mc.radii_matvec(r, v, radii, 1.0, domain=domain,
                                        periodic_length=box),
                lambda: mc.radii_matvec(r, v, radii, 1.0,
                                        domain="single_wall")])
            plain = plain_whole(cs, lambda: mc.radii_matvec_plain(
                r, v, radii, 1.0, domain=domain, periodic_length=box))
            rd, k = r.double(), ERR_ROWS
            err = rel_err(
                mc.radii_matvec(r, v, radii, 1.0, domain=domain,
                                periodic_length=box),
                torch.stack([mob.source_target_matvec(
                    rd, rd[:k], vb.double(), radii.double(),
                    radii[:k].double(), 1.0, domain=domain,
                    periodic_length=box) for vb in v]))
            print(f"  P1 {tag} {r.shape[0]} x B={n_rhs} in {box}: {ms:.3f} "
                  f"ms (the open wall instance {open_ms:.3f} ms){plain}; "
                  f"f32 err / max|ref| {err:.3e}", flush=True)


def profile_fsopen(cs, dev, detail):
    """The open free-surface sweeps and the instances beside them, each
    alternating with the others on the same inputs (chip_smoke.py
    alternating_ms): K1 tt_fs open, the wall's open tt and tt_fs images at
    21a's 49,152 blobs (B = 1 and 2); P1 free surface open, the open wall
    instance and the free surface's images at 21e's bidisperse scene (B =
    1 and 2). But for --baseline also each open free-surface instance's
    bound and share (chip_smoke.py's counts), whether two launches are
    bit-identical and its float32 error against its float64 plain version
    on the first ERR_ROWS target rows."""
    from rigidmultiblobswall_tpu_torch.models import kinematics as kin
    from rigidmultiblobswall_tpu_torch.models.system import make_state
    from rigidmultiblobswall_tpu_torch.ops import mobility as mob
    from rigidmultiblobswall_tpu_torch.ops import mobility_cuda as mc
    from rigidmultiblobswall_tpu_torch.ops import pair_kernels as pk

    g = torch.Generator(device=dev).manual_seed(26)
    q = _fs_scene(cs, dev)
    n = q.shape[0]
    pairs = n * (n + 1) // 2
    La = tuple(x / cs.A_BENCH for x in (cs.L_FS_IMAGES,) * 2) + (0.0,)
    img = (La, pk.box_offsets(La))
    for n_rhs in (1, 2):
        v = torch.randn((n, 3 * n_rhs), generator=g, device=dev)
        fs = dict(coupling="tt", mode="free_surface", self_interaction=True)

        def call(**kw):
            return pk.pair_matvec(q, None, v, **dict(fs, **kw))

        ms, wall, images = cs.alternating_ms([
            call, lambda: call(mode="wall"), lambda: call(boxes=img)])
        line = (f"  K1 tt_fs open {n} x B={n_rhs}: {ms:.3f} ms; the wall's "
                f"open tt {wall:.3f} ms; tt_fs images {images:.3f} ms")
        if detail:
            rec = cs.bound_record(
                4 * n * (3 + 6 * n_rhs),
                pairs * (cs.K1_FS_CONDENSE_FLOPS
                         + 2 * cs.K1_APPLY_FLOPS["tt"] * n_rhs),
                pairs * cs.K1_FS_MUFU)
            got = call()
            same = torch.equal(got, call())
            err = rel_err(got, pk.pair_plain(
                q.double(), q[:ERR_ROWS].double(), v.double(), **fs))
            line += (f"; bound {rec['bound_ms']:.3f} ms "
                     f"({rec['bound_ms'] / ms:.1%}), repeat bit-identical "
                     f"{same}, f32 err / max|ref| {err:.3e}")
        print(line, flush=True)
    system = cs.radii_system(cs.N_SHELLS, domain="free_surface")
    pos, quat = cs.alternate(*cs.lattice(cs.N_SHELLS))
    state = make_state(pos, quat, dtype=torch.float32, device=dev)
    r = kin.blob_positions(system, state).contiguous()
    radii = torch.tensor(system.blob_radii, dtype=torch.float32, device=dev)
    n = r.shape[0]
    pairs = n * (n + 1) // 2
    box = (cs.L_FS_IMAGES, cs.L_FS_IMAGES, 0.0)
    for n_rhs in (1, 2):
        v = torch.randn((n_rhs, n, 3), generator=g, device=dev)

        def call(**kw):
            return mc.radii_matvec(r, v, radii, 1.0,
                                   **dict(dict(domain="free_surface"), **kw))

        ms, wall, images = cs.alternating_ms([
            call, lambda: call(domain="single_wall"),
            lambda: call(periodic_length=box)])
        line = (f"  P1 free surface open {n} x B={n_rhs}: {ms:.3f} ms; the "
                f"open wall instance {wall:.3f} ms; free surface images "
                f"{images:.3f} ms")
        if detail:
            rec = cs.bound_record(
                4 * n * (5 + 6 * n_rhs),
                pairs * (cs.P1_FAR_FLOPS[False] + cs.P1_FS_FLOPS
                         + cs.P1_APPLY_FLOPS * n_rhs),
                pairs * (cs.P1_PAIR_MUFU[False] + 1))
            got = call()
            same = torch.equal(got, call())
            rd, k = r.double(), ERR_ROWS
            err = rel_err(got, torch.stack([mob.source_target_matvec(
                rd, rd[:k], vb.double(), radii.double(), radii[:k].double(),
                1.0, domain="free_surface") for vb in v]))
            line += (f"; bound {rec['bound_ms']:.3f} ms "
                     f"({rec['bound_ms'] / ms:.1%}), repeat bit-identical "
                     f"{same}, f32 err / max|ref| {err:.3e}")
        print(line, flush=True)


def profile_k5open(cs, dev, detail):
    """K5's open instance at 21b's monolayer (open box) and 21c's (partly
    periodic), the capacity sized as the paths size it."""
    from rigidmultiblobswall_tpu_torch.models import kinematics as kin
    from rigidmultiblobswall_tpu_torch.models.system import make_state
    from rigidmultiblobswall_tpu_torch.ops import cell_kernels as ck
    from rigidmultiblobswall_tpu_torch.ops import forces

    mpos, mquat = cs.monolayer()
    system = cs.bench_system(len(mpos), domain="in_plane")
    state = make_state(mpos, mquat, dtype=torch.float32, device=dev)
    r = kin.blob_positions(system, state).contiguous()
    law = dict(eps_over_b=1.0, inv_b=5.0, two_a=2 * cs.A_BENCH)
    for tag, L3 in (("open", (0.0, 0.0, 0.0)),
                    ("partly periodic", (cs.L_MONOLAYER,) * 2 + (0.0,))):
        sized = forces.auto_force_cell_capacity(dataclasses.replace(
            system, periodic_length=L3,
            blob_blob_force_method="neighbor_list",
            blob_blob_cutoff=cs.MONOLAYER_CUTOFF,
            blob_blob_grid_dim=cs.MONOLAYER_GRID), r)
        cap = sized.blob_blob_cell_capacity
        pos, dims, table, _, frame, members = forces.open_force_cells(
            r, L3, cs.MONOLAYER_CUTOFF, cs.MONOLAYER_GRID, cap)
        ms = cs.cuda_ms(lambda: ck.nl_forces_open(
            pos, table, dims, L3, frame, members, cap, **law), 10)
        print(f"  K5open {tag} {r.shape[0]} blobs, dims {dims}, cap {cap}: "
              f"{ms:.4f} ms", flush=True)


# ---------------------------------------------------------------- K2


def profile_k2(cs, dev, detail):
    from rigidmultiblobswall_tpu_torch.models import kinematics as kin
    from rigidmultiblobswall_tpu_torch.models.system import make_state
    from rigidmultiblobswall_tpu_torch.ops import mobility_cuda as mc

    scenes = []
    for n_shells, tag in ((cs.N_SHELLS, "multibody"),
                          (cs.N_DENSE, "multibody-12k")):
        pos, quat = cs.lattice(n_shells)
        state = make_state(pos, quat, dtype=torch.float32, device=dev)
        r = kin.blob_positions(cs.bench_system(n_shells), state)
        scenes.append((tag, r.contiguous(), cs.A_BENCH))
    r = torch.as_tensor(cs.roller_lattice(cs.N_ROLLERS), device=dev)
    scenes.append(("rollers", r.contiguous(), cs.A_ROLLER))
    kw = dict(repulsion_strength=0.2, debye_length=0.2)
    for tag, r, a in scenes:
        ms = cs.cuda_ms(lambda: mc.blob_blob_forces(r, blob_radius=a, **kw),
                        10)
        print(f"  K2 {tag} {r.shape[0]} blobs f32: {ms:.3f} ms", flush=True)
    # periodic: the wall rollers' box, as phase 11 calls it
    sus = cs.wall_roller_suspension(cs.N_ROLLERS)
    kw = dict(repulsion_strength=sus.repulsion_strength,
              debye_length=sus.debye_length, blob_radius=sus.blob_radius,
              periodic_length=sus.periodic_length)
    r = torch.as_tensor(cs.roller_lattice(cs.N_ROLLERS), device=dev)
    n_boxes = len(mc.image_boxes(sus.periodic_length, sus.debye_length,
                                 sus.blob_radius, torch.float32))
    ms = cs.cuda_ms(lambda: mc.blob_blob_forces(r, **kw), 10)
    head = (f"  K2 periodic wall-rollers {r.shape[0]} f32 box "
            f"{sus.periodic_length} ({n_boxes} box)")
    print(f"{head}, the path's call: {ms:.3f} ms", flush=True)
    if detail:
        path = mc.blob_blob_forces(r, **kw).double()
        ms = cs.cuda_ms(lambda: boxes_instance(mc, r, kw), 10)
        rel = ((boxes_instance(mc, r, kw).double() - path).abs().max()
               / path.abs().max()).item()
        print(f"{head}, the image boxes' instance with the home box alone "
              f"(division): {ms:.3f} ms, max diff to the path's call / max "
              f"{rel:.2e}", flush=True)


def boxes_instance(mc, r, kw):
    """K2's image-boxes instance over the home box alone, launched
    through its C entry point."""
    import ctypes

    from rigidmultiblobswall_tpu_torch.ops import pair_kernels as pk

    n = r.shape[0]
    groups, per = pk.plan_groups(n, pk._n_sm(r))
    out = torch.empty_like(r)
    ws = torch.empty((groups, n, 3), dtype=r.dtype, device=r.device)
    law = mc.force_law(kw["repulsion_strength"], kw["debye_length"],
                       kw["blob_radius"])
    L = (ctypes.c_double * 3)(*kw["periodic_length"])
    err = mc._build.library().blob_forces_periodic_f32(
        r.data_ptr(), out.data_ptr(), ws.data_ptr(), n, groups, per, *law,
        L, 1, (ctypes.c_double * 3)(0.0, 0.0, 0.0),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"blob_forces_periodic_f32: CUDA error {err}")
    return out


# ----------------------------------------------------------- K5 and K6


def tile_f32(source):
    """Sources a float32 block of csrc/<source> stages a tile:
    Walk<float>::kSrc in the checkout that runs."""
    from rigidmultiblobswall_tpu_torch.ops import cell_kernels as ck

    text = (Path(ck.__file__).resolve().parents[1] / "csrc"
            / source).read_text()
    return int(re.search(r"cellk::Walk<T, (\d+), \d+>", text)[1])


def periodic_scene(cs, dev):
    """The periodic spectral path's plan (K6) and force cells (K5) at its
    first configuration, float32, sized as chip_smoke.py phase 8 sizes
    them: (plan, (pos, table, dims, box, cap) of the force cells)."""
    from rigidmultiblobswall_tpu_torch.models import kinematics as kin
    from rigidmultiblobswall_tpu_torch.models import saddle
    from rigidmultiblobswall_tpu_torch.models.system import make_state
    from rigidmultiblobswall_tpu_torch.ops import forces

    system = cs.spectral_system(cs.N_SPECTRAL, cs.L_SPECTRAL)
    pos, quat = cs.spectral_lattice(cs.N_SPECTRAL, cs.SPECTRAL_SIDE)
    state = make_state(pos, quat, dtype=torch.float32, device=dev)
    system = saddle.auto_spectral_capacities(system, state)
    r = kin.blob_positions(system, state)
    system = forces.auto_force_cell_capacity(system, r)
    fcap = system.blob_blob_cell_capacity
    fpos, dims, box, table, _ = forces._force_cells(
        r, system.periodic_length, system.blob_blob_cutoff,
        system.blob_blob_grid_dim, fcap)
    return saddle.maybe_dense_mobility(system, r), (fpos, table, dims, box,
                                                    fcap)


def wall_force_scene(cs, dev):
    """The wall path's wall-slab force cells at its first configuration,
    float32, sized as chip_smoke.py phase 10 sizes them."""
    from rigidmultiblobswall_tpu_torch.models import kinematics as kin
    from rigidmultiblobswall_tpu_torch.models import saddle
    from rigidmultiblobswall_tpu_torch.models.system import make_state
    from rigidmultiblobswall_tpu_torch.ops import forces

    system = cs.wall_system(cs.N_WALL, cs.L_WALL)
    pos, quat = cs.wall_lattice(cs.N_WALL, cs.WALL_SIDE)
    state = make_state(pos, quat, dtype=torch.float32, device=dev)
    system = saddle.auto_wall_height(system, state)
    r = kin.blob_positions(system, state)
    system = forces.auto_force_cell_capacity(system, r)
    fcap = system.blob_blob_cell_capacity
    fpos, dims, box, table, _ = forces._force_cells(
        r, system.periodic_length, system.blob_blob_cutoff,
        system.blob_blob_grid_dim, fcap, forces.force_z_extent(system))
    return fpos, table, dims, box, fcap


def print_cells(tag, pos, table, dims, box, cap, tile, r_cut=math.inf):
    """A layout's work: targets a cell, stencils against the float32 tile,
    candidate pairs (and those inside r_cut)."""
    from rigidmultiblobswall_tpu_torch.ops import cell_kernels as ck
    from rigidmultiblobswall_tpu_torch.ops import cells

    ids = table.reshape(-1, cap).long()
    live = (ids < pos.shape[0]).sum(1)
    stencil = live[cells.neighbor_table(dims, device=ids.device)].sum(1)
    cand, inside = ck.pair_counts(pos, table, dims, box, cap, r_cut)
    print(f"  {tag}: cells {tuple(dims)} x cap {cap}; targets a cell mean "
          f"{live.float().mean().item():.1f}, max {int(live.max())}; "
          f"stencil sources mean {stencil.float().mean().item():.1f}, max "
          f"{int(stencil.max())}, over one tile ({tile}): "
          f"{int((stencil > tile).sum())} cells; {cand} candidate pairs"
          + (f", {inside} inside r_cut" if math.isfinite(r_cut) else ""),
          flush=True)


def error_line(got, ref, plain32, rows):
    scale = ref[rows].abs().max().item()
    err = (got.double()[rows] - ref[rows]).abs().max().item()
    err32 = (plain32.double()[rows] - ref[rows]).abs().max().item()
    return (f"; first 256 cells vs plain f64: kernel f32 {err / scale:.3e},"
            f" plain f32 {err32 / scale:.3e} x max|ref|")


def profile_k5(cs, dev, detail):
    from rigidmultiblobswall_tpu_torch.ops import cell_kernels as ck

    _, periodic = periodic_scene(cs, dev)
    kw = dict(eps_over_b=0.2 / 0.2, inv_b=1 / 0.2, two_a=2 * cs.A_BENCH)
    sub = (0, 256)
    for tag, (pos, table, dims, box, cap), guard in (
            ("periodic box", periodic, False),
            ("wall slab", wall_force_scene(cs, dev), True)):
        run = (lambda: ck.nl_forces(pos, table, dims, box, cap,
                                    guard_z=guard, **kw))
        ms = cs.cuda_ms(run, 10)
        line = f"  K5 {tag} {pos.shape[0]} blobs f32: {ms:.3f} ms"
        if detail:
            print_cells(f"K5 {tag}", pos, table, dims, box, cap,
                        tile_f32("nl_forces.cu"))
            got = run()
            same = torch.equal(got, run())
            ref = ck.nl_forces_plain(pos.double(), table, dims, box, cap,
                                     cells_range=sub, **kw)
            plain32 = ck.nl_forces_plain(pos, table, dims, box, cap,
                                         cells_range=sub, **kw)
            rows = cs._rows_of(table, pos.shape[0], cap, sub)
            line += (error_line(got, ref, plain32, rows)
                     + f"; repeat bit-identical {same}")
        print(line, flush=True)


def profile_k6(cs, dev, detail):
    from rigidmultiblobswall_tpu_torch.ops import cell_kernels as ck

    plan, _ = periodic_scene(cs, dev)
    p = plan.params
    cap = p.cell_capacity
    args = (plan.cell_table, plan.cell_dims, p.box, cap, plan.cheb)
    kw = dict(two_a=2 * p.a, r_cut=p.r_cut)
    if detail:
        print(f"  K6 plan: K {plan.cheb.shape[2]}, r_cut {p.r_cut:.4f}",
              flush=True)
        print_cells("K6", plan.positions, *args[:4],
                    tile_f32("near_rpy.cu"), p.r_cut)
    n = plan.positions.shape[0]
    g = torch.Generator(device=dev).manual_seed(4)
    sub = (0, 256)
    for n_rhs in (1, 2):
        f = torch.randn((n, 3 * n_rhs), generator=g, device=dev)
        run = (lambda: ck.near_rpy(plan.positions, f, *args, **kw))
        ms = cs.cuda_ms(run, 10)
        line = f"  K6 {n} blobs B={n_rhs} f32: {ms:.3f} ms"
        if detail:
            got = run()
            same = torch.equal(got, run())
            dargs = args[:4] + (plan.cheb.double(),)
            ref = ck.near_rpy_plain(plan.positions.double(), f.double(),
                                    *dargs, cells_range=sub, **kw)
            plain32 = ck.near_rpy_plain(plan.positions, f, *args,
                                        cells_range=sub, **kw)
            rows = cs._rows_of(plan.cell_table, n, cap, sub)
            line += (error_line(got, ref, plain32, rows)
                     + f"; repeat bit-identical {same}")
        print(line, flush=True)


# ---------------------------------------------------------------- K7


def wall_plan(cs, dev):
    """The wall path's plan at its first configuration, float32."""
    from rigidmultiblobswall_tpu_torch.models import kinematics as kin
    from rigidmultiblobswall_tpu_torch.models import saddle
    from rigidmultiblobswall_tpu_torch.models.system import make_state

    system = cs.wall_system(cs.N_WALL, cs.L_WALL)
    pos, quat = cs.wall_lattice(cs.N_WALL, cs.WALL_SIDE)
    state = make_state(pos, quat, dtype=torch.float32, device=dev)
    system = saddle.auto_spectral_capacities(system, state)
    return saddle.maybe_dense_mobility(system,
                                       kin.blob_positions(system, state))


def print_k7_plan(plan):
    """The plan's work and its stencils against the float32 tile."""
    from rigidmultiblobswall_tpu_torch.ops import cell_kernels as ck
    from rigidmultiblobswall_tpu_torch.ops import cells, ewald_wall

    p, dims = plan.params, plan.cell_dims
    cap = p.cell_capacity
    args, _ = ewald_wall.near_args(plan)
    cand, inside, img = ck.wall_pair_counts(plan.pos_all, *args[:4],
                                            p.r_cut, p.z0)
    ids = plan.cell_table.reshape(-1, cap).long()
    live = (ids < plan.pos_all.shape[0]).sum(1)
    stencil = live[cells.neighbor_table(dims, device=ids.device)].sum(1)
    lo, hi = ewald_wall._kept_layers(p, dims)
    cz = torch.arange(ids.shape[0], device=ids.device) % dims[2]
    keep = (cz >= lo) & (cz <= hi)
    stencil, targets = stencil[keep], (ids < plan.n_real).sum(1)[keep]
    tile = tile_f32("wall_near.cu")
    print(f"  K7 plan: cells {dims} x cap {cap}, K "
          f"{plan.near_tables.cheb.shape[2]}, Ki "
          f"{plan.near_tables.img_cheb.shape[2]}, {stencil.numel()} target "
          f"cells; stencil sources mean {stencil.float().mean().item():.1f}, "
          f"max {int(stencil.max())}, over one tile ({tile}): "
          f"{int((stencil > tile).sum())} cells; real targets a cell max "
          f"{int(targets.max())}; {cand} candidate pairs, {inside} inside "
          f"r_cut, {img} with an image source", flush=True)


def profile_k7(cs, dev, detail):
    from rigidmultiblobswall_tpu_torch.ops import cell_kernels as ck
    from rigidmultiblobswall_tpu_torch.ops import ewald_wall

    plan = wall_plan(cs, dev)
    if detail:
        print_k7_plan(plan)
    args, kw = ewald_wall.near_args(plan)
    layers = ewald_wall._kept_layers(plan.params, plan.cell_dims)
    n = plan.n_real
    g = torch.Generator(device=dev).manual_seed(4)
    sub = (0, 256)
    for n_rhs in (1, 2):
        f = torch.randn((n, 3 * n_rhs), generator=g, device=dev)
        ms = cs.cuda_ms(lambda: ck.wall_near(plan.pos_all, f, *args,
                                             cz_range=layers, **kw), 10)
        line = f"  K7 {n} blobs B={n_rhs} f32: {ms:.3f} ms"
        if detail:
            got = ck.wall_near(plan.pos_all, f, *args, cz_range=layers, **kw)
            dargs = tuple(x.double() if torch.is_tensor(x)
                          and x.is_floating_point() else x for x in args)
            ref = ck.wall_near_plain(plan.pos_all.double(), f.double(),
                                     *dargs, cells_range=sub, **kw)
            plain32 = ck.wall_near_plain(plan.pos_all, f, *args,
                                         cells_range=sub, **kw)
            rows = cs._rows_of(plan.cell_table, n, plan.params.cell_capacity,
                               sub)
            scale = ref[rows].abs().max().item()
            err = (got.double()[rows] - ref[rows]).abs().max().item()
            err32 = (plain32.double()[rows] - ref[rows]).abs().max().item()
            line += (f"; first {sub[1]} cells vs plain f64: kernel f32 "
                     f"{err / scale:.3e}, plain f32 {err32 / scale:.3e} x "
                     f"max|ref|")
        print(line, flush=True)


# ---------------------------------------------------------------- K8

# the wall rollers' products: (forces, torques, want_v, want_w)
K8_PRODUCTS = {"grand": (True, True, True, True),
               "rt": (True, False, False, True),
               "tr": (False, True, True, False),
               "rr": (False, True, False, True)}


def wall_rollers_plan(cs, dev):
    """The wall rollers' plan and rot tables at the path's first
    configuration (chip_smoke.py phase 11), float32."""
    from rigidmultiblobswall_tpu_torch.models import rollers

    sus = cs.wall_roller_suspension(cs.N_ROLLERS)
    r = torch.as_tensor(cs.roller_lattice(cs.N_ROLLERS), device=dev)
    carry = rollers.init_carry(sus, positions=r)
    return carry.plan, carry.rot_tables


def k8_products(cs, dev):
    """(plan, tables, {product: (path, raw)}) at the wall rollers' plan:
    path() calls K8 as the path calls that product (the wrapper, with its
    checks and output allocation), raw(cheb, img, pos, r_cut) launches the
    product's instance alone through its C entry point (into one output
    that it adds into), on the given tables, positions and cutoff."""
    from rigidmultiblobswall_tpu_torch.ops import _build
    from rigidmultiblobswall_tpu_torch.ops import cell_kernels as ck
    from rigidmultiblobswall_tpu_torch.ops import ewald_wall as ew
    from rigidmultiblobswall_tpu_torch.ops import ewald_wall_rot as ewr

    plan, tables = wall_rollers_plan(cs, dev)
    args, kw = ewr.near_args(plan, tables.cheb)
    table, dims, box, cap = args[:4]
    kw["cz_range"] = ew._kept_layers(plan.params, plan.cell_dims)
    # a checkout whose wrapper takes no output flags has one instance a
    # set of strengths
    flags = "want_v" in inspect.signature(ck.wall_rot_near).parameters
    g = torch.Generator(device=dev).manual_seed(4)
    n = plan.n_real
    f, t = (torch.randn((n, 3), generator=g, device=dev) for _ in range(2))
    out = torch.zeros((n, 6), device=dev)
    lib = _build.library()
    stream = torch.cuda.current_stream().cuda_stream
    calls = {}
    for prod, (has_f, has_t, want_v, want_w) in K8_PRODUCTS.items():
        extra = dict(want_v=want_v, want_w=want_w) if flags else {}
        inst = prod if flags else "f" * has_f + "t" * has_t
        fn = getattr(lib, f"wall_rot_near_f32_{inst}")

        def path(has_f=has_f, has_t=has_t, extra=extra):
            return ck.wall_rot_near(plan.pos_all, f if has_f else None,
                                    t if has_t else None, *args, **kw,
                                    **extra)

        def raw(cheb, img, pos=plan.pos_all, r_cut=kw["r_cut"], fn=fn,
                has_f=has_f, has_t=has_t):
            err = fn(pos.data_ptr(), f.data_ptr() if has_f else None,
                     t.data_ptr() if has_t else None, table.data_ptr(),
                     cheb.data_ptr(), img.data_ptr(), out.data_ptr(), n,
                     *(int(d) for d in dims), int(cap), cheb.shape[2],
                     img.shape[2], *kw["cz_range"], *(float(L) for L in box),
                     kw["two_a"], r_cut, kw["z0"], kw["a"], kw["pref_c"],
                     kw["pref_r"], *kw["img_range"], stream)
            if err:
                raise RuntimeError(f"K8 {prod}: CUDA error {err}")
        calls[prod] = (path, raw)
    return plan, tables, args, calls


def series(table, k):
    """A Chebyshev table (pieces, series, K) cut or zero-padded to k
    terms."""
    out = table.new_zeros(table.shape[:2] + (k,))
    m = min(k, table.shape[2])
    out[..., :m] = table[..., :m]
    return out.contiguous()


def profile_k8(cs, dev, detail):
    from rigidmultiblobswall_tpu_torch.ops import cell_kernels as ck

    plan, tables, args, calls = k8_products(cs, dev)
    p = plan.params
    cheb, img = args[4], args[5]
    K, Ki = cheb.shape[2], img.shape[2]
    n = plan.n_real
    if detail:
        cand, inside, n_img = ck.wall_pair_counts(plan.pos_all, *args[:4],
                                                  p.r_cut, p.z0)
        cap = p.cell_capacity
        ids = plan.cell_table.reshape(-1, cap).long()
        targets = (ids < n).sum(1)
        print(f"  K8 plan: cells {plan.cell_dims} x cap {cap}, K {K}, Ki "
              f"{Ki}; {int((targets > 0).sum())} cells with real targets, "
              f"mean {targets[targets > 0].float().mean().item():.1f}, max "
              f"{int(targets.max())}; {cand} candidate pairs of the real "
              f"targets, {inside} inside r_cut, {n_img} with an image "
              f"source", flush=True)
    # the images moved out of every real target's reach (real pairs only)
    far = plan.pos_all.clone()
    far[n:, 2] -= 1e4
    for prod, (path, raw) in calls.items():
        ms = cs.cuda_ms(path, 10)
        alone = cs.cuda_ms(lambda: raw(cheb, img), 20)
        line = (f"  K8 {prod} {n} rollers f32 (K {K}, Ki {Ki}): the path's "
                f"call {ms:.3f} ms, the kernel alone {alone:.3f} ms")
        if detail:
            # where the kernel's time goes: no pair inside r_cut (the
            # stencil, the staging and the candidate filter alone), real
            # pairs only; and the host's time to enqueue the path's call
            none = cs.cuda_ms(lambda: raw(cheb, img, r_cut=1e-3), 20)
            reals = cs.cuda_ms(lambda: raw(cheb, img, pos=far), 20)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                path()
            host = (time.perf_counter() - t0) / 10 * 1e3
            torch.cuda.synchronize()
            line += (f"; no pair {none:.3f} ms, real pairs only "
                     f"{reals:.3f} ms, the path's call enqueued in "
                     f"{host:.3f} ms")
            # the cost of a Clenshaw term: the kernel at other series
            # lengths (the tables' values matter only to the results)
            kt = {k: series(cheb, k) for k in (8, 16, 48)}
            it = {k: series(img, k) for k in (4, 12, 32)}
            kt = {k: cs.cuda_ms(lambda: raw(c, img), 20)
                  for k, c in kt.items()}
            it = {k: cs.cuda_ms(lambda: raw(cheb, c), 20)
                  for k, c in it.items()}
            line += ("; K' " + ", ".join(f"{k} {v:.3f}"
                                         for k, v in kt.items())
                     + f" ms ({(kt[48] - kt[8]) / 40 * 1e3:.2f} us a term);"
                     " Ki' " + ", ".join(f"{k} {v:.3f}"
                                         for k, v in it.items())
                     + f" ms ({(it[32] - it[4]) / 28 * 1e3:.2f} us a term)")
        print(line, flush=True)
    if detail:
        k8_stalls()


def k8_stalls():
    """Where `ncu` is on the machine: the warp stall reasons of one launch
    of each product (a child process of this tool under ncu)."""
    tool = shutil.which("ncu") or "/usr/local/cuda/bin/ncu"
    if not os.path.exists(tool):
        print("  K8 warp stall reasons: no ncu on this machine", flush=True)
        return
    cmd = [tool, "--kernel-name", "regex:wall_rot_near", "--launch-count",
           str(len(K8_PRODUCTS)), "--section", "WarpStateStats",
           sys.executable, __file__, "--kernels", "k8", "--ncu-child"]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=600)
        text = out.stdout + out.stderr
    except subprocess.TimeoutExpired:
        text = "ncu timed out"
    keep = [ln for ln in text.splitlines()
            if "wall_rot_near" in ln or "Stall" in ln or "stall" in ln
            or "==ERROR==" in ln or "==WARNING==" in ln]
    print("  K8 warp stall reasons (ncu):", flush=True)
    for ln in keep[:80] or text.splitlines()[-10:]:
        print(f"    {ln.strip()}", flush=True)


def k8_ncu_child(cs, dev):
    """One launch of each product, for ncu."""
    _, _, _, calls = k8_products(cs, dev)
    for path, _ in calls.values():
        path()
    torch.cuda.synchronize()


# ---------------------------------------------------------------- L1

# (operator, targets the sources) of the phoretic path's L1 calls
L1_PATH = (("bvp", True), ("S", True), ("grad", True), ("D", False),
           ("S", False))


def l1_scene(cs, dev):
    """chip_smoke.py phase 15's shapes, as its phase_l1_kernels makes
    them: the 4096 Janus shells' blobs and lab normals, the 64 x 64 x 8
    concentration grid and the fields, float32."""
    from rigidmultiblobswall_tpu_torch.models import fields
    from rigidmultiblobswall_tpu_torch.models import kinematics as kin
    from rigidmultiblobswall_tpu_torch.models import phoretic
    from rigidmultiblobswall_tpu_torch.models.system import make_state

    system, cfg = cs.phoretic_system(cs.N_SHELLS)
    pos, quat = cs.lattice(cs.N_SHELLS)
    state = make_state(pos, quat, dtype=torch.float32, device=dev)
    rb = kin.blob_positions(system, state).contiguous()
    nb = phoretic.lab_normals(system, state, cfg.chemistry).contiguous()
    grid = torch.as_tensor(fields.velocity_field_grid(cs.CONC_GRID)[0],
                           dtype=torch.float32, device=dev)
    g = torch.Generator(device=dev).manual_seed(15)
    return rb, nb, grid, cs.l1_inputs(rb, nb, g)


def profile_l1(cs, dev, detail):
    """Prints each path instance's time as the path calls it and, with
    detail, its plan and bound (and dD and T on the symmetric sweep)."""
    from rigidmultiblobswall_tpu_torch.ops import laplace as lap
    from rigidmultiblobswall_tpu_torch.ops import pair_kernels as pk

    rb, nb, grid, (c, w, k, q) = l1_scene(cs, dev)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    ns = rb.shape[0]
    cases = L1_PATH + ((("dD", True), ("T", True)) if detail else ())
    for op, on_surface in cases:
        tgt = rb if on_surface else grid
        kw = dict(wall=True, self_interaction=on_surface)
        a = (rb, tgt, nb, c, w, k, q)
        head = (f"  L1 {op} {ns} blobs" if on_surface else
                f"  L1 {op} {ns} blobs, {tgt.shape[0]} grid points")
        ms = cs.cuda_ms(lambda: cs.l1_call(lap, op, *a, **kw), 10)
        if not detail:
            print(f"{head}: {ms:.3f} ms", flush=True)
            continue
        bound = cs.l1_bound(op, ns, tgt.shape[0], True, on_surface)
        share = (f"bound {bound['bound_ms']:.3f} ms, "
                 f"{bound['bound_ms'] / ms:.1%}")
        if not on_surface:
            s, per = lap.plan_slices(tgt.shape[0], ns, n_sm)
            print(f"{head}, directed sweep, {s} slices of {per} tiles: "
                  f"{ms:.3f} ms, {share}", flush=True)
            continue
        g, per = pk.plan_groups(ns, n_sm)
        print(f"{head}, symmetric sweep, {g} groups of {per} tiles: "
              f"{ms:.3f} ms, {share}", flush=True)


# ---------------------------------------------------------------- P1

def p1_scene(cs, dev):
    """chip_smoke.py phase 18's blobs and radii (4096 bidisperse shells,
    49,152 blobs), float32."""
    from rigidmultiblobswall_tpu_torch.models import kinematics as kin
    from rigidmultiblobswall_tpu_torch.models.system import make_state

    system = cs.radii_system(cs.N_SHELLS)
    pos, quat = cs.alternate(*cs.lattice(cs.N_SHELLS))
    state = make_state(pos, quat, dtype=torch.float32, device=dev)
    rb = kin.blob_positions(system, state).contiguous()
    return rb, torch.tensor(system.blob_radii, dtype=torch.float32,
                            device=dev)


def profile_p1(cs, dev, detail):
    """Prints P1's time at phase 18's shape, B = 1 and 2, as the path calls
    it (mobility_cuda.radii_matvec) and, with detail, its plan and both
    bounds (chip_smoke.py p1_bound)."""
    from rigidmultiblobswall_tpu_torch.ops import mobility_cuda as mc
    from rigidmultiblobswall_tpu_torch.ops import pair_kernels as pk

    rb, radii = p1_scene(cs, dev)
    nb = rb.shape[0]
    g = torch.Generator(device=dev).manual_seed(18)
    vs = {b: torch.randn((b, nb, 3), generator=g, device=dev)
          for b in (1, 2)}
    # an older checkout's chip_smoke.py (--root) may lack P1's bounds, and
    # its radii_matvec may take the wall flag in place of the domain
    detail = detail and hasattr(cs, "p1_bound")
    kw = (dict(domain="single_wall")
          if "domain" in inspect.signature(mc.radii_matvec).parameters
          else dict(wall=True))
    for n_rhs, v in vs.items():
        ms = cs.cuda_ms(lambda: mc.radii_matvec(rb, v, radii, 1.0, **kw),
                        10)
        head = f"  P1 {nb} blobs B={n_rhs} f32 wall"
        if not detail:
            print(f"{head}: {ms:.3f} ms", flush=True)
            continue
        _, contacts = cs.blob_contacts(rb, radii)
        rec, every = cs.p1_bound(nb, contacts, n_rhs)
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        groups, per = pk.plan_groups(nb, n_sm)
        print(f"{head}, symmetric sweep, {groups} groups of {per} tiles, "
              f"{contacts} pairs inside contact: {ms:.3f} ms, bound "
              f"{rec['bound_ms']:.3f} ms ({rec['bound_by']}), "
              f"{rec['bound_ms'] / ms:.1%}; the all-regime count "
              f"{every['bound_ms']:.3f} ms, {every['bound_ms'] / ms:.1%}",
              flush=True)


# ---------------------------------------------------------------- P2


def p2_plan(cs, dev):
    """chip_smoke.py phase 19's plan (98,304 blobs of two radius groups in
    phase 8's box), float32, sized as that phase sizes it."""
    from rigidmultiblobswall_tpu_torch.models import kinematics as kin
    from rigidmultiblobswall_tpu_torch.models import saddle
    from rigidmultiblobswall_tpu_torch.models.system import make_state

    system = cs.radii_spectral_system(cs.N_SPECTRAL, cs.L_SPECTRAL)
    pos, quat = cs.alternate(*cs.spectral_lattice(cs.N_SPECTRAL,
                                                  cs.SPECTRAL_SIDE))
    state = make_state(pos, quat, dtype=torch.float32, device=dev)
    system = saddle.auto_spectral_capacities(system, state)
    return saddle.maybe_dense_mobility(system,
                                       kin.blob_positions(system, state))


def profile_p2(cs, dev, detail):
    """Prints P2's times at phase 19's plan as the path calls it: the
    list build (a plan's, once a configuration) and the product over the
    plan's list, B = 1 and 2; with a checkout whose P2 has no list (the
    walk), the stateless product. With detail also the plan's work
    (candidates, pairs inside r_cut, the list's length) and the bounds
    (chip_smoke.py p2_list_bound, p2_product_bound)."""
    from rigidmultiblobswall_tpu_torch.ops import cell_kernels as ck

    plan = p2_plan(cs, dev)
    p = plan.params
    n = plan.positions.shape[0]
    listed = hasattr(ck, "near_radii_pairs")
    args = (plan.cell_table, plan.cell_dims, p.box, p.cell_capacity)
    g = torch.Generator(device=dev).manual_seed(19)
    head = f"  P2 {n} blobs G={len(p.radii)}"
    if listed:
        def build():
            return ck.near_radii_pairs(plan.positions, plan.group_of, *args,
                                       r_cut=p.r_cut)

        ms = cs.cuda_ms(build, 10)
        line = f"{head} list build f32: {ms:.3f} ms"
        if detail:
            parts = device_parts(build, 10)
            line += (f" (device {sum(parts.values()):.3f} ms a build: "
                     + ", ".join(f"{k} {v:.4f}" for k, v in parts.items())
                     + ")")
            cand, inside = ck.pair_counts(plan.positions, *args, p.r_cut)
            n_list = int(plan.radii_pairs.offsets[-1])
            rec = cs.p2_list_bound(n, cand, n_list, plan.cell_table)
            line += (f"; {cand} candidates, {inside} pairs inside r_cut, "
                     f"{n_list} listed ({4 * (n + 1 + n_list) / 2 ** 20:.1f}"
                     f" MiB); bound {rec['bound_ms']:.4f} ms "
                     f"({rec['bound_by']}), {rec['bound_ms'] / ms:.1%}")
        print(line, flush=True)
    for n_rhs in (1, 2):
        f = torch.randn((n, 3 * n_rhs), generator=g, device=dev)
        call = (plan.positions, f, plan.group_of, *args, plan.cheb_radii,
                plan.radii_edges)
        kw = dict(r_cut=p.r_cut)
        if listed:
            kw["pairs"] = plan.radii_pairs
        def product(call=call, kw=kw):
            return ck.near_rpy_radii(*call, **kw)

        ms = cs.cuda_ms(product, 10)
        line = (f"{head} {'list product' if listed else 'walk'} "
                f"B={n_rhs} f32: {ms:.3f} ms")
        if detail:
            line += f" (device {device_ms(product, 10):.3f})"
        if detail and listed:
            cand, inside = ck.pair_counts(plan.positions, *args, p.r_cut)
            rec = cs.p2_product_bound(n, inside, int(
                plan.radii_pairs.offsets[-1]), plan.cheb_radii.shape[-1],
                n_rhs)
            both = cs.cuda_ms(lambda: ck.near_rpy_radii(
                *call, r_cut=p.r_cut), 10)
            line += (f"; bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}),"
                     f" {rec['bound_ms'] / ms:.1%}; the stateless call "
                     f"(build and product) {both:.3f} ms")
        print(line, flush=True)


# ---------------------------------------------------------------- M1


def profile_m1(cs, dev, detail):
    """Prints M1's time on batches of n-blob configurations of one shell's
    box (chip_smoke.py shell_batch's box, uniform blobs), as the path
    calls it (mobility_cuda.blob_pair_energy), and with detail each
    instance on the same batch (the small instance and the tile sweep,
    mobility_cuda.energy_kernel): the crossover of the fixed rule
    ENERGY_SMALL_MAX; also the floor an empty launch of the library sets.
    With a checkout that has one instance, the path's call only."""
    from rigidmultiblobswall_tpu_torch.ops import _build
    from rigidmultiblobswall_tpu_torch.ops import mobility_cuda as mc

    kw = dict(repulsion_strength=0.2, debye_length=0.2,
              blob_radius=cs.A_BENCH, coincident="one")
    both = detail and hasattr(mc, "energy_kernel")
    if both:
        lib = _build.library()
        stream = torch.cuda.current_stream(dev).cuda_stream
        floor = cs.cuda_ms(lambda: _build.check(
            "launch_floor", lib.launch_floor(stream)), 20)
        print(f"  M1 an empty launch: {floor:.4f} ms", flush=True)
    rb = cs.shell_batch(cs.N_MCMC_BATCH)
    ms = cs.cuda_ms(lambda: mc.blob_pair_energy(rb, **kw), 20)
    busy = device_ms(lambda: mc.blob_pair_energy(rb, **kw), 20)
    print(f"  M1 batch {cs.N_MCMC_BATCH} x 12 f32 as the path calls it: "
          f"{ms:.4f} ms a call, its kernels {busy:.4f} ms of device time",
          flush=True)
    rm = m1_scene(cs, dev)
    ms = cs.cuda_ms(lambda: mc.blob_pair_energy(rm, **kw), 10)
    print(f"  M1 {rm.shape[1]} blobs f32 as the path calls it: {ms:.3f} ms",
          flush=True)
    if not both:
        return
    g = torch.Generator(device=dev).manual_seed(16)
    box = 5.0 * (2 * 0.5 + 2 * cs.A_BENCH)
    for n_conf in (cs.N_MCMC_BATCH, 64, 1):
        for n in (12, 32, 48, 64, 80, 96, 128):
            r = torch.rand((n_conf, n, 3), generator=g, device=dev) * box
            t = {}
            for small in (True, False):
                def call(small=small):
                    return mc.energy_kernel(
                        r, **kw, periodic_length=(0.0, 0.0, 0.0),
                        small=small)
                t[small] = (cs.cuda_ms(call, 20), device_ms(call, 20))
            print(f"  M1 {n_conf} x {n} f32: small {t[True][0]:.4f} ms a "
                  f"call ({t[True][1]:.4f} device), tile sweep "
                  f"{t[False][0]:.4f} ({t[False][1]:.4f})", flush=True)


def m1_scene(cs, dev):
    """chip_smoke.py phase 16's blobs: phase 6's 4096 shells (49,152
    blobs) as one configuration, float32."""
    from rigidmultiblobswall_tpu_torch.models import kinematics as kin
    from rigidmultiblobswall_tpu_torch.models.system import make_state

    system = cs.bench_system(cs.N_SHELLS)
    pos, quat = cs.lattice(cs.N_SHELLS)
    state = make_state(pos, quat, dtype=torch.float32, device=dev)
    return kin.blob_positions(system, state)[None].contiguous()


def device_parts(fn, reps):
    """The device time of each CUDA kernel fn() runs, ms a call by kernel
    name (torch.profiler), after a warm-up call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    parts = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if us > 0:
            name = (e.key.replace("(anonymous namespace)::", "")
                    .split("(")[0].replace("void ", "").split("<")[0]
                    .strip())
            parts[name] = parts.get(name, 0.0) + us / 1e3 / reps
    return parts


def device_ms(fn, reps):
    """The device time of fn()'s CUDA kernels, ms a call."""
    return sum(device_parts(fn, reps).values())


PROFILES = {"k1": profile_k1, "k2": profile_k2, "k5": profile_k5,
            "k6": profile_k6, "k7": profile_k7, "k8": profile_k8,
            "l1": profile_l1, "p1": profile_p1, "p2": profile_p2,
            "m1": profile_m1, "k1img": profile_k1img,
            "k3img": profile_k3img, "k1fs": profile_k1fs,
            "k3fs": profile_k3fs, "p1img": profile_p1img,
            "k5open": profile_k5open, "fsopen": profile_fsopen}


# ------------------------------------------------------- ptxas and SASS


def ptxas_lines(cs, build_log, kernels):
    frags = [f for k in kernels for f in INSTANCES[k]]
    return [line for line in cs.ptxas_report(build_log)
            if any(f in line for f in frags)]


def sass_counts(lib_path, kernels, out_path):
    """Per instance of the chosen kernels: MUFU.EX2, MUFU.RSQ, MUFU.RCP,
    FRND, F2I and CALL counts in the library's SASS; writes the counts and those
    instances' listing to out_path and returns the count lines."""
    frags = [f for k in kernels for f in INSTANCES[k]]
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                         text=True)
    sections, name = {}, None
    for line in out.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            sections[name] = []
        elif name is not None:
            sections[name].append(line)
    mangled = list(sections)
    names = mangled
    if mangled and shutil.which("c++filt"):
        dem = subprocess.run(["c++filt"], input="\n".join(mangled),
                             capture_output=True, text=True).stdout
        # "void (anonymous namespace)::force_sym_kernel<float>(...)" ->
        # "void force_sym_kernel<float>"
        names = [d.replace("(anonymous namespace)::", "").split("(", 1)[0]
                 for d in dem.splitlines()]
    counts, listing = [], []
    loops_of = {k: set(INSTANCES[k]) for k in ("k8", "l1", "p1", "k1img",
                                                "k3img", "k1fs", "k3fs",
                                                "p1img", "fsopen")
                if k in kernels}
    for name, key in zip(names, mangled):
        if not any(f in name for f in frags):
            continue
        body = sections[key]
        calls = sorted({ln.split("CALL", 1)[1].split(";")[0].strip()
                        for ln in body if "CALL" in ln})
        counts.append(
            f"{name}: ex2 {sum('MUFU.EX2' in ln for ln in body)}, rsq "
            f"{sum('MUFU.RSQ' in ln for ln in body)}, rcp "
            f"{sum('MUFU.RCP' in ln for ln in body)}, frnd "
            f"{sum('FRND' in ln for ln in body)}, f2i "
            f"{sum('F2I' in ln for ln in body)}, calls "
            f"{sum('CALL' in ln for ln in body)} {calls}")
        if any(f in name for f in loops_of.get("k8", ())):
            counts += [f"  {ln}" for ln in sass_loops(body)]
        if any(f in name for f in loops_of.get("l1", ())):
            counts += [f"  {ln}" for ln in sass_pair_loops(body)]
        if any(f in name for f in loops_of.get("p1", ())):
            counts += [f"  {ln}" for ln in sass_step_paths(body)]
        if any(f in name for k in ("k1img", "k3img", "k1fs", "k3fs",
                                   "p1img")
               for f in loops_of.get(k, ())) and "Boxes" in name:
            counts += [f"  {ln}" for ln in sass_box_paths(body)]
        if any(f in name for f in loops_of.get("fsopen", ())):
            counts += [f"  {ln}" for ln in sass_pair_paths(body)]
        listing += [f"Function : {name} ({key})"] + body
    if not counts:
        counts = [f"no instance found (cuobjdump exit {out.returncode}: "
                  f"{out.stderr.strip()[:200]})"]
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    Path(out_path).write_text("\n".join(counts + [""] + listing) + "\n")
    return counts


SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                       r"([A-Z][A-Z0-9_.]*)([^;]*);")
LOOP_OPS = ("LDS", "FFMA", "FADD", "FMUL", "MUFU")


def sass_loops(body):
    """The loops of a SASS listing that load shared memory and multiply-add
    (backward branches; the Clenshaw loops among them): per loop its
    length in instructions and its LDS (by width), FFMA, FADD, FMUL and
    MUFU counts."""
    instrs = []
    for ln in body:
        m = SASS_LINE.search(ln)
        if m:
            instrs.append((int(m.group(1), 16), m.group(2), m.group(3)))
    out = []
    for addr, op, rest in instrs:
        if op != "BRA":
            continue
        target = re.search(r"0x([0-9a-f]+)", rest)
        if target is None or int(target.group(1), 16) > addr:
            continue
        lo = int(target.group(1), 16)
        ops = [o for a, o, _ in instrs if lo <= a <= addr]
        hist = {k: sum(o.split(".")[0] == k for o in ops) for k in LOOP_OPS}
        if hist["LDS"] == 0 or hist["FFMA"] == 0:
            continue
        widths = sorted({o for o in ops if o.startswith("LDS")})
        out.append(f"loop {lo:#x}-{addr:#x}: {len(ops)} instructions, "
                   + ", ".join(f"{k} {v}" for k, v in hist.items())
                   + f" ({', '.join(widths)})")
    return out or ["no loop with LDS and FFMA"]


PAIR_OPS = ("MUFU", "SHFL", "LDS", "FFMA", "FADD", "FMUL", "FSEL")


def sass_pair_loops(body):
    """The pair loops of an L1 instance's SASS (backward branches over
    MUFU.RSQ): per loop its instructions and its PAIR_OPS a pair, a pair
    counted by its two MUFU.RSQ (the real source's and the image's), and
    the LDS widths."""
    instrs = []
    for ln in body:
        m = SASS_LINE.search(ln)
        if m:
            instrs.append((int(m.group(1), 16), m.group(2), m.group(3)))
    out = []
    for addr, op, rest in instrs:
        if op != "BRA":
            continue
        target = re.search(r"0x([0-9a-f]+)", rest)
        if target is None or int(target.group(1), 16) > addr:
            continue
        lo = int(target.group(1), 16)
        ops = [o for a, o, _ in instrs if lo <= a <= addr]
        rsq = sum(o.startswith("MUFU.RSQ") for o in ops)
        if rsq == 0:
            continue
        pairs = rsq / 2
        hist = {k: sum(o.split(".")[0] == k for o in ops) / pairs
                for k in PAIR_OPS}
        widths = sorted({o for o in ops if o.startswith("LDS")})
        out.append(f"loop {lo:#x}-{addr:#x}: {pairs:g} pairs, "
                   f"{len(ops) / pairs:.1f} instructions a pair: "
                   + ", ".join(f"{k} {v:.2f}" for k, v in hist.items())
                   + f" ({', '.join(widths)})")
    return out or ["no loop with MUFU.RSQ"]


STEP_OPS = PAIR_OPS + ("VOTE",)
PRED_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?"
                       r"([A-Z][A-Z0-9_.]*)([^;]*);")


def sass_step_paths(body):
    """P1's pair loops, one pair a thread an iteration (the innermost loops
    holding MUFU.RSQ): the rotation's (SHFL; "voted" where it holds the
    warp vote, VOTE) and the diagonal tile's (LDS). Each path through a
    loop's body from its head to its back branch, by the branches taken,
    with its instructions a pair and STEP_OPS; in the voted rotation the
    shortest path is the far one, the longest the full one."""
    instrs = []
    for ln in body:
        m = PRED_LINE.search(ln)
        if m:
            instrs.append((int(m.group(1), 16), bool(m.group(2)),
                           m.group(3), m.group(4)))
    index = {a: k for k, (a, _, _, _) in enumerate(instrs)}

    def target(k):
        _, _, op, rest = instrs[k]
        t = re.search(r"0x([0-9a-f]+)", rest)
        if op.split(".")[0] != "BRA" or t is None:
            return None
        return index.get(int(t.group(1), 16))

    out = []
    for hi in range(len(instrs)):
        lo = target(hi)
        if lo is None or lo > hi:
            continue
        ops = [o for _, _, o, _ in instrs[lo:hi + 1]]
        inner = any((t := target(k)) is not None and lo <= t < k
                    for k in range(lo, hi))
        if inner or not any(o.startswith("MUFU.RSQ") for o in ops):
            continue
        kind = ("rotation" if any(o.startswith("SHFL") for o in ops)
                else "diagonal tile")
        if any(o.startswith("VOTE") for o in ops):
            kind += ", voted"
        paths, stack = set(), [(lo, ())]
        while stack and len(paths) < 64:
            k, path = stack.pop()
            while lo <= k <= hi:
                path = path + (instrs[k][2],)
                t = target(k)
                if instrs[k][2].split(".")[0] == "EXIT":
                    break
                if t is None:
                    k += 1
                    continue
                if k == hi or t <= k:
                    break   # the back branch
                pred, rest = instrs[k][1], instrs[k][3]
                if pred or re.match(r"\s*!?U?P\d", rest):
                    stack.append((k + 1, path))
                k = t
            paths.add(path)
        for path in sorted(paths, key=len):
            hist = {o: sum(x.split(".")[0] == o for x in path)
                    for o in STEP_OPS}
            out.append(f"{kind} loop {instrs[lo][0]:#x}-{instrs[hi][0]:#x}"
                       f", a path: {len(path)} instructions a pair: "
                       + ", ".join(f"{o} {v}" for o, v in hist.items()))
    return out or ["no pair loop (MUFU.RSQ)"]


def sass_box_paths(body, n_boxes=9, rsq_per_box=2):
    """The far path of each pair loop of an image instance (wall: two
    MUFU.RSQ a box, r's and R's). The pair loops are the innermost loops
    holding MUFU.RSQ, but for those holding a single box's (box loops, one
    box an iteration), which stand for their trips inside their enclosing
    loop, the pair loop: n_boxes each (an older tree's, two in a rotation
    unrolled twice), less the boxes the pair loop condenses outside them
    (PlaneBoxes' loop form: the home box, then a loop over eight). Per
    pair loop the shortest of the paths from its head to its back branch
    that condense every box (the most MUFU.RSQ: a branch past a skipped
    pair's work is not taken, nor one out of the loop), its instructions
    and MUFU.RSQ, and the instructions a box: the path's count over its
    boxes (its MUFU.RSQ / rsq_per_box)."""
    instrs = []
    for ln in body:
        m = PRED_LINE.search(ln)
        if m:
            instrs.append((int(m.group(1), 16), bool(m.group(2)),
                           m.group(3), m.group(4)))
    index = {a: k for k, (a, _, _, _) in enumerate(instrs)}

    def target(k):
        t = re.search(r"0x([0-9a-f]+)", instrs[k][3])
        if instrs[k][2].split(".")[0] != "BRA" or t is None:
            return None
        return index.get(int(t.group(1), 16))

    def is_rsq(k):
        return instrs[k][2].startswith("MUFU.RSQ")

    loops = sorted((target(k), k) for k in range(len(instrs))
                   if target(k) is not None and target(k) < k)
    rsq_loops = [(lo, hi) for lo, hi in loops
                 if any(is_rsq(k) for k in range(lo, hi + 1))]
    innermost = [(lo, hi) for lo, hi in rsq_loops
                 if not any(lo <= a and b <= hi and (a, b) != (lo, hi)
                            for a, b in rsq_loops)]

    def shortest(lo, hi, inner):
        """(instructions, MUFU.RSQ) of the shortest full path from lo
        through the back branch at hi; inner maps the head of each inner
        loop to (its back branch, trips, instructions, MUFU.RSQ)."""
        best = {hi + 1: (0, 0)}
        skip = set()
        for ilo, (ihi, _, _, _) in inner.items():
            skip.update(range(ilo + 1, ihi + 1))
        for k in range(hi, lo - 1, -1):
            if k in inner:
                ihi, trips, c_in, q_in = inner[k]
                c, q = best.get(ihi + 1, (math.inf, 0))
                best[k] = (c + trips * c_in, q + trips * q_in)
                continue
            if k in skip:
                continue
            own = (1, 1 if is_rsq(k) else 0)
            if k == hi:
                best[k] = own
                continue
            op = instrs[k][2].split(".")[0]
            t = target(k)
            conditional = (instrs[k][1]
                           or re.match(r"\s*!?U?P\d", instrs[k][3]))
            if op == "EXIT":
                cands = []
            elif t is None:
                cands = [k + 1]
            else:
                cands = [t] if lo <= t <= hi else []
                if conditional:
                    cands.append(k + 1)
            # the most boxes (a branch past the work, a skipped pair, is
            # not a far path), then the fewest instructions
            c, q = min((best.get(x, (math.inf, 0)) for x in cands),
                       key=lambda cq: (-cq[1], cq[0]),
                       default=(math.inf, 0))
            best[k] = (c + own[0], q + own[1])
        return best[lo]

    pair_loops = {}
    for lo, hi in innermost:
        if sum(is_rsq(k) for k in range(lo, hi + 1)) > rsq_per_box:
            pair_loops.setdefault((lo, hi), {})
            continue
        outer = [(a, b) for a, b in loops
                 if a <= lo and hi <= b and (a, b) != (lo, hi)]
        if outer:
            c, q = shortest(lo, hi, {})
            pair_loops.setdefault(min(outer, key=lambda ab: ab[1] - ab[0]),
                                  {})[lo] = (hi, n_boxes, c, q)
    out = []
    for (lo, hi), inner in sorted(pair_loops.items()):
        if inner:
            # boxes condensed outside the box loops (a home box before a
            # loop over the others) leave the loops fewer trips
            _, q_out = shortest(lo, hi, {a: (b, 0, c, q) for a, (b, _, c, q)
                                         in inner.items()})
            trips = n_boxes - q_out // (rsq_per_box * len(inner))
            inner = {a: (b, trips, c, q) for a, (b, _, c, q) in inner.items()}
        cost, q = shortest(lo, hi, inner)
        ops = [instrs[k][2] for k in range(lo, hi + 1)]
        kind = ("rotation" if any(o.startswith("SHFL") for o in ops)
                else "directed")
        boxes = q / rsq_per_box
        per_box = f"{cost / boxes:.1f}" if boxes else "n/a"
        loops_in = ", ".join(f"{instrs[a][0]:#x}-{instrs[b[0]][0]:#x}"
                             for a, b in sorted(inner.items()))
        trips = next(iter(inner.values()))[1] if inner else 0
        out.append(f"{kind} pair loop {instrs[lo][0]:#x}-{instrs[hi][0]:#x}"
                   + (f" (box loops {loops_in}, {trips} trips each)"
                      if inner else "")
                   + f": far path {cost} instructions, {q} MUFU.RSQ, "
                   f"{boxes:g} boxes, {per_box} instructions a box")
    return out or ["no pair loop (MUFU.RSQ)"]


# the classes sass_pair_paths counts a pair: the float32 pipe, the
# special functions, the shuffles, and the branches, predicates, votes and
# selects around them; every other instruction is "other" (integer,
# moves, loads)
OP_CLASSES = {"FP32": ("FFMA", "FADD", "FMUL", "FMNMX", "FSWZADD"),
              "MUFU": ("MUFU",),
              "SHFL": ("SHFL",),
              "branch/predicate": ("BRA", "BSSY", "BSYNC", "FSETP", "ISETP",
                                   "PLOP3", "PSETP", "VOTE", "VOTEU", "FSEL",
                                   "SEL", "P2R", "R2P", "WARPSYNC", "BMOV")}


def op_class(op):
    base = op.split(".")[0]
    for name, ops in OP_CLASSES.items():
        if base in ops:
            return name
    return "other"


def sass_pair_paths(body, rsq_per_pair=2):
    """The far path of each pair loop of an open sweep (the innermost
    loops holding MUFU.RSQ: the rotation's, with SHFL, and the diagonal
    tile's): the shortest of the paths from its head to its back branch
    that take the most MUFU.RSQ (a branch past a pair's work, or out of the
    loop, is not taken; the near and zero forms sit behind branches), its
    pairs (MUFU.RSQ / rsq_per_pair: r's and the image's R's), and its
    instructions a pair, in all and by OP_CLASSES."""
    instrs = []
    for ln in body:
        m = PRED_LINE.search(ln)
        if m:
            instrs.append((int(m.group(1), 16), bool(m.group(2)),
                           m.group(3), m.group(4)))
    index = {a: k for k, (a, _, _, _) in enumerate(instrs)}

    def target(k):
        t = re.search(r"0x([0-9a-f]+)", instrs[k][3])
        if instrs[k][2].split(".")[0] != "BRA" or t is None:
            return None
        return index.get(int(t.group(1), 16))

    loops = sorted((target(k), k) for k in range(len(instrs))
                   if target(k) is not None and target(k) < k)
    rsq_loops = [(lo, hi) for lo, hi in loops
                 if any(instrs[k][2].startswith("MUFU.RSQ")
                        for k in range(lo, hi + 1))]
    out = []
    for lo, hi in rsq_loops:
        # not innermost, or an out-of-line block's branch back into a loop
        # (it starts inside another loop and ends past it)
        if any((lo <= a and b <= hi or a < lo <= b < hi) and (a, b) != (lo, hi)
               for a, b in rsq_loops):
            continue
        # best[k]: (MUFU.RSQ, instructions, class counts) of the best path
        # from k through the back branch
        best = {hi + 1: (0, 0, {})}
        for k in range(hi, lo - 1, -1):
            op = instrs[k][2]
            own_q = 1 if op.startswith("MUFU.RSQ") else 0
            t = target(k)
            conditional = (instrs[k][1]
                           or re.match(r"\s*!?U?P\d", instrs[k][3]))
            if k == hi or op.split(".")[0] == "EXIT":
                cands = [hi + 1] if k == hi else []
            elif t is None:
                cands = [k + 1]
            else:
                cands = [t] if lo <= t <= hi and t > k else []
                if conditional:
                    cands.append(k + 1)
            opts = [best[x] for x in cands if x in best]
            if not opts:
                continue
            q, c, hist = min(opts, key=lambda v: (-v[0], v[1]))
            hist = dict(hist)
            cls = op_class(op)
            hist[cls] = hist.get(cls, 0) + 1
            best[k] = (q + own_q, c + 1, hist)
        if lo not in best:
            continue
        q, c, hist = best[lo]
        ops = [instrs[k][2] for k in range(lo, hi + 1)]
        kind = ("rotation" if any(o.startswith("SHFL") for o in ops)
                else "diagonal tile")
        if any(o.startswith("VOTE") for o in ops):
            kind += ", voted"
        pairs = q / rsq_per_pair
        if not pairs:
            continue
        out.append(f"{kind} loop {instrs[lo][0]:#x}-{instrs[hi][0]:#x}: "
                   f"far path {c} instructions, {pairs:g} pairs, "
                   f"{c / pairs:.1f} a pair: "
                   + ", ".join(f"{name} {hist.get(name, 0) / pairs:.2f}"
                               for name in (*OP_CLASSES, "other")))
    return out or ["no pair loop (MUFU.RSQ)"]


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--root", default=str(ROOT))
    p.add_argument("--kernels", default="k1,k2,k5,k6,k7,k8,l1,p1,p2,m1",
                   help="comma-separated subset of k1, k2, k5, k6, k7, k8, "
                        "l1, p1, p2, m1, k1img, k3img, k1fs, k3fs, p1img, "
                        "k5open, fsopen")
    p.add_argument("--ncu-child", action="store_true",
                   help=argparse.SUPPRESS)
    p.add_argument("--baseline", action="store_true",
                   help="only the times of the paths' calls")
    p.add_argument("--plain-whole", action="store_true",
                   help="k1fs and p1img: also time each instance's plain "
                        "version over its whole sweep")
    p.add_argument("--sass-out",
                   default=str(ROOT / "build" / "kernels_sass.txt"),
                   help="where the SASS counts and listing go")
    args = p.parse_args()
    global PLAIN_WHOLE
    PLAIN_WHOLE = args.plain_whole
    kernels = [k.strip() for k in args.kernels.split(",") if k.strip()]
    bad = [k for k in kernels if k not in PROFILES]
    if bad:
        raise SystemExit(f"torch_profile_kernels: unknown kernels {bad}")
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_kernels: needs a CUDA card")
    sys.path.insert(0, args.root)
    import chip_smoke as cs
    from rigidmultiblobswall_tpu_torch.ops import _build

    print(cs.smi(), flush=True)
    print(f"package from {Path(_build.__file__).resolve().parents[1]}",
          flush=True)
    dev = torch.device("cuda")
    lib = _build.library()
    if args.ncu_child:
        k8_ncu_child(cs, dev)
        return
    detail = not args.baseline
    if detail:
        if _build.build_log:
            for line in ptxas_lines(cs, _build.build_log, kernels):
                print(f"  ptxas {line}", flush=True)
        else:
            print("library reused: no ptxas report in this process",
                  flush=True)
    for k in kernels:
        PROFILES[k](cs, dev, detail)
    if detail:
        print(f"SASS (MUFU.EX2, MUFU.RSQ, MUFU.RCP, calls; listing in "
              f"{args.sass_out}):", flush=True)
        for line in sass_counts(lib._name, kernels, args.sass_out):
            print(f"  {line}", flush=True)


if __name__ == "__main__":
    main()
