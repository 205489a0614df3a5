// Kernel K1, the free surface's tt coupling: the translation-translation
// mobility above a slip plane at z = 0, RPY plus its image reflected in
// the plane (pair_blocks.cuh fs_condense), for B = 1 or 2 stacked
// right-hand sides, in the open domain and in the pseudo-periodic image
// boxes (ImageBoxes, PlaneBoxes as with_boxes picks them).
//
// Replaces the Pallas TPU kernel rigidmultiblobswall_tpu/ops/pair_kernels.py
// (_pair_kernel; wrapper pair_matvec_pallas) for the domain the JAX
// package runs on its generic tiled path (ops/mobility.py:56-77 _block's
// free_surface branch, rpy.free_surface_tt :466; XLA there).
//
// What bounds it: as tt's instances, float32 instruction issue. The image
// adds one rsqrt, the far RPY form (~8 operations) and its fold into the
// condensed block (~6) to the open core, against the wall polynomial's
// ~45; the heights are neither shifted nor damped (the caller's
// ops/mobility.py passes them raw). Every product of the paths is square,
// so the symmetric sweep serves them; the sliced sweep is there for the
// two-tensor calls and the plan's occupancy query. On the one-target
// symmetric sweep (sym_kernel) a pair's far path issued 72 SASS
// instructions at B = 1 (98 at B = 2): 51 float32, 2 MUFU, 9 shuffles of
// the rotating source and 9 branches and predicates of the near and
// zero flags (tools/torch_profile_kernels.py --kernels fsopen, PERF.md
// §6), against ~47 float32 operations of the pair's own work.
//
// Design of the open sweep (pair_blocks.cuh sym2_kernel, which the
// coupling's kFreeSurface takes without image boxes): blocks of 64 threads
// over the same 128-row tiles, two targets a lane, so each shuffle of a
// rotating source's position, vector and running sum serves two pairs; a
// tile pair whose bounding boxes lie more than 2 apart and whose lowest
// heights add up to more than 2 (boxes_far and images_far) takes the far
// form with every flag the constant false, no branch a pair; and the
// coefficients in five instructions each (fs_condense2). Its far path issues
// 54.2 instructions a pair at B = 1 (77.2 at B = 2; 47 and 67 of them
// float32), at 12 blocks an SM and 80 registers (B = 2: 10 and 96, ~5 %
// faster than 12; Shape2), the step loop unrolled by two.
//
// Design of the image boxes under PlaneBoxes (the paths' boxes), where a
// pair's nine boxes are ~90 % of its work: z is never imaged, so dz and Rz
// are the same in every box, and a box's block differs from the next only
// by its coefficients (c1, c2 of the pair, e1, e2 of its image) and its
// in-plane offsets. So no box is condensed: every box adds its four
// coefficients into the sums pair_blocks.cuh FsMoments keeps (sum_blocks'
// free-surface branch), and dz and Rz are folded in once a pair when the
// sum closes into the pair's one block, applied both ways. A far box
// costs its r^2 and |R|^2 (on the offsets' squares, formed once a column
// and a row), two rsqrt, the two far RPY forms (pair_blocks.cuh rpy_far,
// by explicit multiply-adds) and the sums' add, where condensing it and
// adding the block cost ~48 SASS instructions. The home box keeps its near
// and zero forms (tt_near, fs_image_near) and adds into the same sums. The
// instances keep the image boxes' 6 resident blocks an SM (80 registers):
// 4, 5 and 8 run no faster (PERF.md §6).

#include "pair_blocks.cuh"

// pair_tt_fs_f32 / _f64 (the sliced sweep), pair_tt_fs_img_f32 / _f64
// (its image boxes), pair_tt_fs_shape: as pair_tt's, with the free
// surface's domain code 2 in place of the wall flag (any other refused)
PAIRK_ENTRY(pair_tt_fs, pairk::FreeSurface)
// pair_tt_fs_sym_f32 / _f64 and pair_tt_fs_sym_img_f32 / _f64: the
// symmetric sweep (two targets a lane, sym2_kernel) and its image boxes
PAIRK_SYM_ENTRY(pair_tt_fs_sym, pairk::FreeSurface)
