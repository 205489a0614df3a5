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
// two-tensor calls and the plan's occupancy query.

#include "pair_blocks.cuh"

// pair_tt_fs_f32 / _f64 (the sliced sweep), pair_tt_fs_img_f32 / _f64
// (its image boxes), pair_tt_fs_shape: as pair_tt's, with the free
// surface's domain code 2 in place of the wall flag (any other refused)
PAIRK_ENTRY(pair_tt_fs, pairk::FreeSurface)
// pair_tt_fs_sym_f32 / _f64 and pair_tt_fs_sym_img_f32 / _f64: the
// symmetric sweep and its image boxes
PAIRK_SYM_ENTRY(pair_tt_fs_sym, pairk::FreeSurface)
