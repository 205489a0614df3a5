// Kernel K1, coupling tt: the translation-translation mobility product
// (RPY core plus Swan-Brady single-wall corrections) for B = 1 or 2
// stacked right-hand sides. The per-pair math and the sliced sweep are in
// pair_blocks.cuh, shared with the other couplings (pair_couplings.cu).
//
// Replaces the Pallas TPU kernel rigidmultiblobswall_tpu/ops/pair_kernels.py
// (_pair_kernel, coupling "tt"; wrapper pair_matvec_pallas).
//
// The square product (targets = sources), which is every tt product of
// the paths, also has the symmetric sweep of
// pair_blocks.cuh (sym_kernel): the tt mobility is symmetric, so each
// unordered pair is condensed once and applied both ways.
//
// Each sweep also has its image-box instance (pair_blocks.cuh ImageBoxes):
// the pseudo-periodic boxes of a periodic_length on the single_wall and
// no_wall domains, the minimum image and then every box of the list.

#include "pair_blocks.cuh"

// pair_tt_f32 / pair_tt_f64: q_src (n_src,3), q_tgt (n_tgt,3),
// vec (n_src,3*n_rhs) b-major columns, out (n_tgt,3*n_rhs), the slice
// workspace; n_rhs 1 or 2; pair_tt_img_f32 / _f64: the image boxes;
// pair_tt_shape: the launch shape
PAIRK_ENTRY(pair_tt, pairk::TT)
// pair_tt_sym_f32 / _f64: the symmetric sweep, n_rhs 1 or 2, and its image
// boxes, pair_tt_sym_img_f32 / _f64
PAIRK_SYM_ENTRY(pair_tt_sym, pairk::TT)
