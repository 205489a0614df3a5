// Kernel K1, couplings tr, rt, rr and grand: the trans-rot, rot-trans and
// rot-rot mobility products (RPY core plus Swan-Brady single-wall
// corrections), and the grand product (U, W a) = M (F, T / a) of all four
// blocks in one pass over the pair geometry. The per-pair math and the
// kernel template are in pair_blocks.cuh, shared with pair_tt.cu.
//
// Replaces the Pallas TPU kernel rigidmultiblobswall_tpu/ops/pair_kernels.py
// (_pair_kernel, couplings "tr", "rt", "rr", "grand"; wrapper
// pair_matvec_pallas).
//
// Template instances are the ones the rollers path launches: tr and rr
// with B = 1 or 2 (the lockstep torque solve and its trailing M_tr
// products), rt and grand with B = 1; each with and without the wall, in
// float32 and float64, on the sliced sweep (a product with its own target
// set) and on the symmetric sweep (the square product, which is every
// product of the rollers path); each of these also in its image-box
// instance (NAME_img_f32 / _f64, pair_blocks.cuh ImageBoxes), the
// pseudo-periodic boxes of a periodic_length on the direct engine.

#include "pair_blocks.cuh"

// vec (n_src,3*n_rhs) -> out (n_tgt,3*n_rhs); tr and rr take n_rhs 1 or 2
PAIRK_ENTRY(pair_tr, pairk::TR)
PAIRK_ENTRY(pair_rt, pairk::RT)
PAIRK_ENTRY(pair_rr, pairk::RR)
// vec (n_src,6) = (F, T/a) -> out (n_tgt,6) = (U, W a) before prefactors
PAIRK_ENTRY(pair_grand, pairk::Grand)
// the symmetric sweep of the square products: tr and rr n_rhs 1 or 2, rt
// and grand (the rollers' Lanczos) 1
PAIRK_SYM_ENTRY(pair_tr_sym, pairk::TR)
PAIRK_SYM_ENTRY(pair_rt_sym, pairk::RT)
PAIRK_SYM_ENTRY(pair_rr_sym, pairk::RR)
PAIRK_SYM_ENTRY(pair_grand_sym, pairk::Grand)
