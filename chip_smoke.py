#!/usr/bin/env python
"""Smoke test of the PyTorch + CUDA port (rigidmultiblobswall_tpu_torch)
on one NVIDIA card.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises, so the exit code
is non-zero and no result line is printed):
  1. device: requires CUDA (never falls back to the CPU); prints the
     card's name and power limit from nvidia-smi;
  2. build: compiles kernel K1 (csrc/pair_tt.cu, csrc/pair_couplings.cu
     on csrc/pair_blocks.cuh), K2 and its periodic instance
     (csrc/blob_forces.cu), K3 (csrc/dense_tt.cu), K4 (csrc/symm_planes.cu),
     K5, K6, K7 and K8 (csrc/nl_forces.cu, csrc/near_rpy.cu,
     csrc/wall_near.cu, csrc/wall_rot_near.cu on csrc/cell_sweep.cuh) and
     L1, the Laplace layer sums (csrc/laplace_layers.cu), M1, the
     MCMC pair energy (csrc/blob_energy.cu), P1, the radii pair product
     (csrc/pair_radii.cu), and P2, the mixed-radii near field's pair list
     and list product (csrc/near_radii.cu), K1's and K3's image-box
     instances among them, with one nvcc per source,
     all started together,
     into build/kernels/; prints the ptxas registers and spills of every
     kernel instance;
  3. kernels against their plain PyTorch versions on the card: every K1
     coupling and template instance and K2 on a random ~3000-blob scene
     with blobs below a, K1 tt (B = 1 and 2) and K2 at the 49,152-blob
     shape of the Slip-Trapz path, K1 tr/rt/rr/grand at the 32,768-roller
     shape of the rollers path, K1 tt at the 12,288 blobs of the
     materialized path, and K1 grand and K2 at the 4096 spheres of the
     lubrication path; each K1 instance at full size called as its path
     calls it (the square product, on the symmetric sweep), twice
     bit-identical,
     its bound on the unordered pairs (the record's) and the directed
     pairs' in the log; tr (B = 1, 2), rt and rr (B = 1, 2) at the
     32,768 rollers also in the open domain and in float64;
     K2 at full size on its symmetric sweep, twice bit-identical, its
     bound on the unordered pairs (the record's) and, in the log only,
     the directed pairs'; prints kernel and plain times;
  4. slice parity on the card (kernels) against the CPU (plain versions,
     float64): 8 shells x 3 Slip-Trapz steps at kT = 0, 16 rollers x 3
     steps of deterministic and stochastic Adams-Bashforth, and 16
     spheres x 3 lubrication trapezoidal steps (omega, cut_torque) with
     the same normals fed to every run (float64 to 1e-9 of the
     displacement, float32 to 1e-2);
  5. the CLI entry point on a generated 64-shell input file, on a
     generated 64-roller input file and on a generated 16-sphere
     lubrication input with the firm terms on (card float64 against CPU
     float64 at kT = 0);
  6. the Slip-Trapz path at full width: bench.py's multibody
     configuration, 4096 twelve-blob shells = 49,152 blobs, float32
     through make_stepper/init_carry, one warm-up step and three timed
     steps, with the kernels' launch counts over the run;
  7. the rollers path at full width: bench.py's rollers configuration,
     32,768 rollers, stochastic_adams_bashforth_rollers in float32, one
     warm-up step and three timed steps, with the launch count of every
     K1 coupling (and of tr's and rr's B = 2 instances) and of K2 over the
     run, every square product on the symmetric sweep;
  8. the periodic spectral path at full width: bench.py's spectral
     configuration, 8192 twelve-blob shells = 98,304 blobs in a periodic
     box, the spectral Ewald engine with linked-cell forces, float32,
     capacities sized at the start as bench.py sizes them; first K5 and
     K6 at its shapes against their plain versions (the first 256 target
     cells, float64) and twice bit-identical, K5's bound the larger of its
     float32 operations and its special functions (an rsqrt and an exp2
     a candidate pair at 16 a clock an SM), then one warm-up step and
     three timed steps with
     the launch counts of K1, K2, K5 and K6 (B = 1 / 2) over the run;
     last, the same configuration through the CLI (its ms per step).
  9. the materialized path at full width (multibody-12k-dense): 1024
     twelve-blob shells = 12,288 blobs, bench.py's multibody physics,
     float32; stochastic_Slip_Trapz and stochastic_adams_bashforth, one
     warm-up and three timed steps each, on the materialized engine (K3
     builds, K4 products) and again with MATERIALIZE_BUDGET_BYTES = 0
     (matrix-free on K1); ms/step, solver counts, launches per step and
     peak device memory of each.
 10. the wall spectral path at full width: bench.py's spectral_wall
     configuration, 8192 twelve-blob shells = 98,304 blobs in two layers
     above the wall in an xy-periodic box, the spectral wall engine with
     the wall-slab linked-cell forces, float32, slab height and
     capacities sized as bench.py sizes them; the host tables (timed),
     K7 (B = 1 and 2, twice bit-identical, float32 and float64; its
     bound on the pairs inside r_cut (the record's) and, in the log only,
     the 27-cell algorithm's)
     and the wall-slab K5 (its own record, bound and launches) at its
     shapes against their plain versions (the first 256 cells, float64),
     each twice bit-identical, then one warm-up step
     and three timed steps with the launch counts, drops and clipped
     blobs (which must be 0).
 11. the rollers on the wall engine at full width: bench.py's rollers
     configuration with BENCH_ROLLER_DOMAIN=single_wall_spectral, 32,768
     rollers in a 291.2 x 291.2 box, slab top 1.8, tolerance 1e-4, grid at
     most 512, the automatic cell capacity, float32; the plan and rot tables
     (timed), K8 (each variant of present forces and torques, the cells of
     the first 256 xy columns against the float64 plain version, the
     float32 plain version's error beside it, twice bit-identical) and
     periodic K2 (its one-box instance, the first 1024 rows against the
     float64 plain version over every image box) at its shapes, then one
     warm-up step and three
     timed steps through make_stepper: ms/step, solver counts,
     rejections, overlaps, plan drops (0), peak device memory and the
     launches of K8, K7 and periodic K2 (each must run, periodic K2 on its
     one-box instance; no other engine's kernel may).
 12. the lubrication path at full width (lubrication-4k): bench.py's
     lubrication configuration (BASELINE config 5), 4096 spheres of radius
     1 on a 64 x 64 lattice at spacing 2.4 and height 1.3, Uniform_Rollers
     physics, neighbor-list Delta_R (12 a sphere), tolerance 2e-4, float32;
     one Delta_R assembly timed by CUDA events, then one warm-up step and
     three timed steps of step_trapezoidal with omega 25 and cut_torque
     0.2: ms/step, GMRES and Lanczos iterations, rejections, neighbor
     overflow (0), peak device memory and the launches of K1 grand and K2
     (each must run; no other engine's kernel may).
 13. the remaining multibody schemes, obstacles and Krylov recycling at
     full width (multibody-49k-schemes): bench.py's multibody
     configuration (4096 shells, 49,152 blobs, float32, matrix-free) with
     phase 6's Lanczos and GMRES settings; stochastic first-order RFD,
     traction EM and AB, Slip-Mid and GDC-RFD, one warm-up and two timed
     steps each (ms/step, GMRES and Lanczos counts, rejections, the
     launches of K1 tt B = 1 and 2 and of K2: each kernel of the scheme
     must run, K3 and K4 must not); 512 of the shells an obstacle type
     under Slip-Mid and GDC-RFD, two steps each (the obstacles
     bit-identical, the free shells moved); and deterministic
     Adams-Bashforth at kT = 0 for 6 steps with recycle_k = 6 and without
     (each step's GMRES sweeps; steps 2-6 must take fewer recycled; the
     refresh timed, three K1 tt B = 2 launches; the final positions
     within 10 x the solver tolerance of the displacement).
 14. articulated bodies, active slip and body-body forces at full width,
     float32, one warm-up and three timed steps each at phase 6's solver
     settings: multibody-49k-articulated (1024 chains of four twelve-blob
     shells, 4096 shells, 49,152 blobs, 3072 ball joints, direct blob
     forces, matrix-free: K1 tt and K2, not K3/K4) under
     articulated_deterministic_forward_euler and _midpoint, the midpoint
     again with the chains' first joint breathing in t (.const
     expressions); rollers-32k-articulated (16,384 single-blob dumbbells,
     32,768 rollers, the articulated_dumbbells example's physics: K1
     grand) under both roller schemes; multibody-49k-active (4096 squirmer
     shells, the slip B1 sin(theta) read from a generated .slip file, the
     Yukawa body-body force) under deterministic_adams_bashforth at kT =
     0. Each logs ms/step, GMRES sweeps per step and per solve,
     Gauss-Newton iterations per projection, the largest constraint
     violation after the last projection (within the bound that float32
     rounding of the state leaves), the launches, finite positions and 0
     rejections. Phase 3 holds K1 tt and K2 at the chains' 49,152 blobs
     and K1 grand at the dumbbells' 32,768 rollers to their plain
     versions for phase 14's three kernel records.
 15. the phoretic path at full width (multibody-49k-phoretic): phase 6's
     scene (4096 shells, 49,152 blobs, direct forces, tolerance 2e-4,
     float32) with every shell a Janus particle (a generated .Laplace
     chemistry: radial normals, weights 4 pi (0.5)^2 / 12, k = 5 and q = 0
     above the body-frame equator, k = 0 and q = 1 below, surface
     mobility 5; background_Laplace 1) under deterministic forward Euler
     and stochastic Slip-Trapz, one warm-up and three timed steps each:
     ms/step, the Stokes GMRES sweeps and Lanczos iterations, the
     Laplace GMRES iterations of every solve (each must converge below
     maxiter 1000), peak device memory and the launches (L1's BVP
     operator, single layer and surface gradient, K1 tt and K2 must run;
     K1's other couplings, K3/K4 and K5-K8 must not); one phoretic_slip
     call read directly, and the concentration field on a 64 x 64 x 8
     grid over the suspension through L1 with the self mask off, timed.
     Every L1 launch whose targets are its sources (the BVP operator,
     the single layer of the right-hand side, the surface gradient) must
     take L1's symmetric sweep (ops/laplace.py SYM_LAUNCHES), the
     field's must not.
     Phase 3 checks every L1 operator (S, D, dD, T, the fused BVP
     operator and surface gradient) against its float64 plain version on
     a random ~3000-blob scene above the wall (wall on and off, self mask
     on and off, float32 and float64, twice bit-identical; float32 within
     u32 sqrt(N) or twice the float32 plain version's error, which it
     prints beside it), S, D, dD and T both with off-surface targets (the
     directed sweep) and with the blobs as targets (the symmetric sweep),
     and at phase 15's shapes (every target of the fused sums, the first
     1024 of the others), with five kernel records (the BVP operator, the
     right-hand side's single layer, the surface gradient, and the
     concentration field's double and single layers at its 32,768 grid
     points), each naming its design and plan (tile groups or source
     slices), each bound the larger of its float32 operations at 67
     TFLOP/s and its rsqrts at 16 a clock an SM, on the unordered pairs
     where the targets are the sources; phase 4 runs 8 Janus shells x 3 steps of forward
     Euler (kT 0) and Slip-Trapz (kT 0.05, the same normals fed) and 16
     rollers with a torque_fn hook, card against CPU (float64 to 1e-9 of
     the displacement, float32 to 1e-2); phase 5 runs generated inputs
     through the CLI, card float64 against CPU float64: Janus shells under
     forward Euler, body_mobility with a .Laplace file, mobility with
     plot_velocity_field, tracer_radius and plot_concentration_field (the
     VTK files' numbers), and a torch user_defined_functions.py with
     body_force_torque_fn and postprocess.
 16. the MCMC path at full width (multibody-49k-mcmc): phase 6's scene
     (4096 shells, 49,152 blobs above the wall, bench.py's physics at kT
     0.05) in float32: run_mcmc with 100 adaptive burn-in steps and 200
     chain steps saved every 20, under torch.cuda.set_sync_debug_mode(
     "error") (no host sync in the run): ms per step, acceptance, the
     final proposal size, M1's launches (one a step and one at the start;
     no other kernel), and the final energy against the plain version's
     energy of the final state (float64 sums on the same float32 blobs,
     within the rounding of the terms' inputs or twice the float32 plain
     version's error of the pair energy); then run_rejection_sampler on one shell (kT 1) with
     n_estimate 100,000 and 20,000 proposals in batches of 4096:
     proposals per second and M1's launches. Phase 3 checks M1 against its
     float64 plain version on the random ~3000-blob scene (a coincident
     distinct pair) in the open domain, an xy-periodic and a fully
     periodic box, both mask flavours (a coincident pair dropped, as
     forces.blob_blob_energy, or at r = 1, as mcmc.total_energy), float64
     to 1e-12 and float32 within the rounding of its terms' inputs
     (2^-22 (2 + |r - 2a| / b) of each term, summed) or twice the float32
     plain version's error (each printed), twice bit-identical; and at
     phase 16's shapes, the 49,152 blobs (128 groups of 3 tiles) and a
     batch of 4096 twelve-blob configurations, float32 and float64 (to
     1e-12) alike, each timed in float32 with its plain version and its
     bound (two kernel records); phase 4 runs a 64-shell chain (10 burn-in and 40
     steps) card float64 against CPU float64 on the same draws fed (1e-9);
     phase 5 runs body_mcmc, MCMC and body_mcmc_rejection on generated
     inputs through the CLI, card float64 against CPU float64 on the same
     seed (the same files under the JAX CLI's names, frame counts and
     shapes, .MCMC_info fields), and examples/mcmc/inputMCMC.dat on the
     card with generated vertex and clones files.
 17. the inextensible fibers (models/fibers.py) at full width, float32:
     17a, fibers-4k-batched, the fibers example's twin
     (rigidmultiblobswall_tpu_torch.examples.fibers_run) at 4096 free
     fibers of 31 links (131,072 blobs), per-fiber hydrodynamics, no
     wall, backward-Euler noise, its kT, k_bend and dt: the twin's own
     run (4 steps, its end-to-end file), then one warm-up and three timed
     steps: ms per step, peak device memory, |t| - 1 under 1e-5, and no K
     kernel launched (batched per-fiber matrices, LU and Cholesky); 17b,
     fibers-carpet-32k, a 32 x 32 carpet of fibers of 31 links clamped
     above the wall (32,768 blobs; length 2, a = ds / 2, spacing 0.5,
     bases at 1.5 a, t_fix +z, each tilted 0.3 rad off +z), full
     hydrodynamics, Crank-Nicolson noise, 17a's kT, k_bend and dt,
     tolerance 1e-4: one warm-up and three timed steps, ms per step,
     GMRES and Lanczos iterations and K1 tt launches per step, every
     solve converged, every K1 tt launch on the symmetric sweep
     (pair_kernels.SYM_LAUNCHES), no other kernel, finite positions,
     unmoved clamped bases, unit tangents, the lowest blob. Phase 3 holds
     K1 tt at the carpet's 32,768 blobs to its plain version (the kernel
     record "K1 pair_tt in fibers"); phase 4 runs one deterministic
     full-mode step of an 8 x 8 carpet card float32 against CPU float64;
     phase 5 runs the periodic suspension example's twin
     (rigidmultiblobswall_tpu_torch.examples.periodic_suspension_run) at
     its default 64 bodies and 50 steps.
 18. per-blob radii at full width (multibody-49k-radii): phase 6's
     lattice and physics (4096 shells above the wall, 49,152 blobs, direct
     forces, tolerance 2e-4, float32) with bench.py's shell (radius 0.5,
     blob radius 0.131) and a 1.2x shell (radius 0.6, blob radius 0.157)
     alternating on the lattice, each read from a four-column .vertex
     file; deterministic forward Euler and stochastic Slip-Trapz, one
     warm-up and three timed steps each: ms/step, GMRES sweeps, Lanczos
     iterations, rejections (0), peak device memory and the launches (P1,
     B = 1 and for Slip-Trapz B = 2, and K2 must run; K1, K3 and K4 must
     not); the smallest blob surface gap of the scene. Phase 3 holds P1,
     the radii pair product (csrc/pair_radii.cu), to its float64 plain
     version on a random ~3000-blob scene with radii in [0.08, 0.3] (wall
     on and off, every RPY regime: far, overlapping, one blob inside
     another, coincident; B = 1 and 2; float32 within 3e-6 x max|ref| or
     twice the float32 plain version's error, float64 to 1e-12; twice
     bit-identical) and at phase 18's 49,152 blobs (two kernel records,
     B = 1 and 2; the bound counts the far form for the pairs outside
     contact and the full one for those inside and the self pairs, and
     the log adds the share of the all-regime count); phase 4 runs 8
     shells of the mixture x 3 steps of forward Euler and Slip-Trapz card
     against CPU, phase 5 a four-column input through the CLI
     (Slip-Trapz, mobility, body_mobility).
 19. mixed radii on the spectral engine at full width
     (spectral-98k-radii): phase 8's box (8192 shells, 98,304 blobs, L =
     33.6, tolerance 1e-4, grid at most 256, linked-cell forces, float32)
     with phase 18's mixture, two radius groups; the plan's host tables
     timed, P2 (the mixed-radii near field, csrc/near_radii.cu: the
     plan's pair list and the product over it) at its shape against its
     float64 plain versions (the first 256 target cells; the product with
     B = 1 and 2, twice bit-identical; the build and the products timed
     apart, a kernel record each), then one warm-up and three timed
     Slip-Trapz steps: ms/step, iterations, overflows (0), peak device
     memory and the launches (P2's builds and products and K5 must run,
     K6 must not). Phase 3 also holds P2 on a random 3000-blob periodic
     box of three radius groups, with its build and product timed.
 20. the direct engine's pseudo-periodic image boxes at
     full width, float32, each path on K1's and K3's image-box instances
     (csrc/pair_blocks.cuh, csrc/dense_tt.cu; every box of phase 20 takes
     the in-plane far policy, PlaneBoxes), K2's periodic
     instances and M1's minimum image, no open K1 or K3 launch:
     20a multibody-49k-pseudo-periodic (phase 6's scene in a (25.6, 25.6,
     0) box, the lattice's own period; forward Euler and Slip-Trapz,
     matrix-free), 20b multibody-12k-dense-pseudo-periodic (phase 9's
     scene in (17.6, 17.6, 0), one materialized Slip-Trapz step), 20c
     rollers-32k-pseudo-periodic (phase 7's rollers in (291.2, 291.2, 0),
     stochastic and deterministic Adams-Bashforth), 20d
     lubrication-4k-pseudo-periodic (phase 12's spheres in (153.6, 153.6,
     0), step_trapezoidal), 20e an MCMC chain on 20a's scene, and 20f the
     .random_state round trip through the CLI on the card (4 steps
     against 2 + 2 restarted from the .clones and .random_state, float64,
     the same frames); ms a step, solver counts and launches of each.
     Each image instance on these paths is first held against its plain
     version in float64 at the path's shape (the first 1024 target rows;
     K3 the whole matrix) within 3e-6 x max|ref|, twice bit-identical,
     with its time, the plain version's (the whole sweep where its
     first rows predict under PLAIN_WHOLE_S, else plain_rows_ms), its
     bound (each unordered pair's boxes condensed once) and its
     registers, K3's lower
     triangle the exact transpose of its upper; the sliced sweep's
     instance at 20a's sources in the log. Phase 3 holds the same
     instances at 300 blobs under each image policy (the in-plane far one
     above the wall, at its margin and without the wall; the general one
     at L/a = 3 and periodic in z), both sweeps, K3 included, and checks
     the open K3 at 12,288 blobs its exact transpose too.
 21. the last single-device domains at full width, float32
     (phase_domains): in_plane, free_surface, per-blob radii in image
     boxes and on the free surface, linked-cell forces in open and partly
     periodic boxes. 21k holds every new instance at small shapes in
     float32 and float64 (K1's free-surface tt, B = 1, 2, open and under
     both image policies, both sweeps; in_plane tt and tr on the wall
     instances, u_z exactly 0; K3's free-surface instance; P1's image
     boxes and free surface; K5's open instance with overflowing cells),
     twice bit-identical, then at its path's shape against its float64
     plain version, timed over five rounds alternating with the wall's
     (or open) instance of the same sweep, the plain version's whole
     sweep timed where it takes under PLAIN_WHOLE_S (else plain_ms null
     and plain_rows_ms, its time on its first plain_rows target rows, in
     the record); 21a multibody-49k-free-surface
     (forward Euler and Slip-Trapz, one Slip-Trapz step in 20a's box),
     21b monolayer-49k-in-plane (64 x 64 shells at height 2.0, open box,
     linked-cell forces; every K1 product's u_z exactly 0, the bodies' z
     velocities within the solver tolerance, no cell overflowing), 21c
     that monolayer bidisperse in (102.4, 102.4, 0) above the wall (P1
     images, K5 partly periodic), 21d phase 9's 1024 shells on the free
     surface (open and in 20b's box) and in_plane, materialized, 21e
     phase 18's scene on the free surface (forward Euler and one
     Slip-Trapz step open, forward Euler in 20a's box; the runs in a box
     and 21d's in_plane at CAPPED_MAXITER GMRES sweeps a solve), 21f two
     64-shell input files through the CLI, card float64 against CPU
     float64 to 1e-10 of the displacement.
 22. multiple devices (phase_multi_device; parallel/): the rank-share
     instances first, in this process (K1's symmetric sweep over a
     rank's group pairs, tt B = 1, 2 at 49,152 blobs and grand at 32,768
     rollers; its sliced sweep over rank 1's rows with row0; K6 over
     cells at spectral-98k, K7 over columns at spectral-wall-98k, P2 over
     targets at spectral-98k-radii): the shares summed against the full
     launch (K1 within P22_TOL, the others bit for bit), a share against
     its float64 plain version, its time, its plain version's and its
     bound (the full instance's, scaled to the share). Then two gloo
     ranks sharing the card (parallel/spawn.py, phase22_rank) run phase
     22's products (K1 tt B = 1, 2, tt on two tensors, grand,
     spectral-98k B = 1, 2, spectral-98k-radii, spectral-wall-98k B = 1,
     2) and one forward-Euler and one Slip-Trapz step of phase 6's
     scene, held to the same run in this process (D = 1: products within
     P22_TOL x max|ref|, the wall's within P22_TOL_WALL, steps within
     P22_STEP_TOL, solver counts within one), rank 0 the products again
     over a one-rank NCCL group; then parallel.dryrun.dryrun_multichip(2)
     at the JAX entry point's sizes. The log holds D = 1 and D = 2 ms a
     product and a step and the bytes each collective moved; the
     records' launches are the ranks'. Two ranks on one card measure the
     decomposition's overhead, not scaling.
Phase 4 also runs 8 shells x 3 steps of each of phase 13's five schemes
at kT = 0.05 and 6 shells beside 2 obstacle shells under Slip-Mid and
GDC-RFD (the obstacles unchanged) on the card against the CPU with the
same normals fed, and phase 5 a generated input with an `obstacle` entry
through the CLI, card float64 against CPU float64. Phase 4 runs 8
four-shell chains (K3/K4, K2) under both multibody articulated schemes
(the midpoint also with the breathing joint) and 16 dumbbells (K1 grand)
under both roller schemes, 3 steps, card f64 and f32 against CPU f64;
phase 5 runs the articulated_dumbbells example (10 steps) and a generated
8-squirmer input with a .slip file and the Yukawa force through the CLI,
card float64 against CPU float64.
Phase 3 also checks K5 and K6 on a random periodic box of ~3000 blobs,
K7, K8 and the wall-slab K5 on a random ~3000-blob wall slab (K5, K6, K7
and K8 twice bit-identical), periodic K2 on 1001 blobs in small boxes
(all 9 or 27 image boxes: its image boxes' instance) and in a large
fully periodic box (its one-box instance),
and K3 and K4 (float32 and float64, N below one tile and N off the tile
edges; K4 bit-identical on repeat and blind to NaN in its strictly-lower
tiles) at small N and at the 12,288 blobs of phase 9; phase 4 the
spectral slice (27 shells, Slip-Trapz) and the wall spectral slice (8
shells, on K7 and K5) on the card against the CPU (the 8-shell
single_wall slice runs on K3/K4) and 16 rollers on the wall engine (K8,
K7 and periodic K2); phase 5 the CLI on generated
periodic_spectral and single_wall_spectral inputs and the body_mobility
and resistance modes on a generated 64-shell input (card float64 against
CPU float64).
The line before the last holds the per-kernel JSON record (time, plain
version's time, and the bound: the larger of the bytes moved at 3.35 TB/s
and the operations at 67 TFLOP/s, the H100's published float32 peak, or for
K5, L1 and M1 their special functions at 16 a clock an SM, whichever
is larger; K2, K7, L1 and M1 also name their design, L1 its plan; K8,
L1 and M1 have a record per instance; P1 and P2 name their plan and
registers, P1 with a record per B, P2 one for its build and one per B;
M1's batch carries the floor an empty launch sets; K1's and K3's
image-box instances a record each at phase 20's shapes, phase 21's
instances at theirs, and phase 22's rank-share instances at its);
the last line is {"ok": true, "device": {...}}.
"""

import concurrent.futures
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
N_SHELLS = 4096
N_ROLLERS = 32768
DEVICE = "cuda"
A_BENCH = 0.131
A_ROLLER = 0.5
# (coupling, B) of the K1 template instances besides tt's B = 1 and 2
K1_COUPLING_INSTANCES = [("tr", 1), ("tr", 2), ("rt", 1), ("rr", 1),
                         ("rr", 2), ("grand", 1)]
# bench.py's spectral path: 8192 shells on the 21-per-side lattice
N_SPECTRAL = 8192
SPECTRAL_SIDE = 21
L_SPECTRAL = SPECTRAL_SIDE * 1.6
# bench.py's spectral_wall path: 8192 shells in two layers on a 64-per-side
# square lattice above the wall
N_WALL = 8192
WALL_SIDE = 64
L_WALL = WALL_SIDE * 1.6
# the H100 SXM's published peaks (NVIDIA data sheet; 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# the special-function unit (MUFU: rsqrt, exp2): 16 results a clock an SM
# (the CUDA programming guide's throughput table, compute capability 9.0)
# on 132 SMs at the H100 SXM's 1.98 GHz boost clock
PEAK_SFU_PER_S = 16 * 132 * 1.98e9
# float32 operations per pair, counted from the kernels' sources (an FMA
# as 2, a rsqrt or exp as 1): K1 condenses a block in ~70 and applies it
# in ~10 per right-hand side (grand: four blocks from one geometry); K2
# and K5 ~22 (distance, rsqrt, exp, three FMAs); K6, for each pair inside
# r_cut, 8 for the distance, 6 + 6 K for the two Clenshaw series and 18
# per right-hand side (pairs of the 27-cell stencil beyond r_cut are the
# cell list's work, not the function's: they enter only the algorithm
# bound that the log prints beside it)
K1_PAIR_FLOPS = {"tt": 80, "tr": 80, "rt": 80, "rr": 80, "grand": 320}
# of which applying the condensed blocks to one right-hand side (~10 a
# block): each further right-hand side adds it again, and the symmetric
# sweep condenses each unordered pair once and applies it both ways
K1_APPLY_FLOPS = {"tt": 10, "tr": 10, "rt": 10, "rr": 10, "grand": 40}
# what the symmetric sweep adds to an unordered pair's condensing: tr's
# and rt's source share is the pair's other cross block, whose own terms
# beyond the shared ones are K, G3 and H at the other height, three FMAs
# (csrc/pair_blocks.cuh cross_block); tt, rr and grand apply their own
# blocks transposed
K1_SYM_EXTRA_FLOPS = {"tr": 6, "rt": 6}
FORCE_PAIR_FLOPS = 22
# of which applying the magnitude to one blob (three FMAs): K2's symmetric
# sweep forms each unordered pair's magnitude once and applies it to both
FORCE_APPLY_FLOPS = 6
# special functions of a K2 or K5 pair's magnitude: one rsqrt and one exp2
# (both sums are antisymmetric, so the function needs one magnitude an
# unordered pair)
FORCE_PAIR_MUFU = 2
# K7, for each pair inside r_cut, K6's count with the mirror (1 per
# right-hand side); a pair with an image source adds the image series'
# domain map (~12), ten Ki-term Clenshaw series (3 each a term) and, per
# right-hand side, img_terms (its operations counted from
# csrc/wall_img_terms.cuh, header_flops()) and the prefactor (6)
K7_IMG_PAIR_FLOPS = 12
# K8, each instance counting its own products' work (K8_INSTANCES): for
# each real-source pair inside r_cut the distance and the piece map (10),
# the K-term Clenshaw series its products read (3 each a term: gamma_r
# for tr and rt, alpha_r and beta_r for rr), rt's cross product and its
# scaling (12), tr's (12) and the rr block (18); for each image-source
# pair the distance (8), the image series' domain map
# (K7_IMG_PAIR_FLOPS), the Ki-term series its channels read (c2_1 and
# c2_2 for rr, c2_1..c2_3 for rt and tr) and the generated channels
# (img_terms_rt, _tr, _rr; counted from csrc/wall_img_terms.cuh) with
# their prefactors (6 each)
K8_REAL_PAIR_FLOPS = 10
# periodic K2's one-box instance: the minimum image d - round(d (1/L)) L
# on each periodic axis, a multiply, two adds and a multiply-add (5 with
# the FMA as 2), before the magnitude; no special function (the image
# boxes' instance adds a division and a conversion on each axis)
K2_MIN_IMAGE_FLOPS = 5
# bench.py's rollers path on the wall-spectral engine (BENCH_ROLLER_DOMAIN
# =single_wall_spectral): 32,768 rollers in a 291.2 x 291.2 box (182 a
# side at spacing 1.6), slab top 1.8, tolerance 1e-4, grid at most 512
# K3: tt's ~70 per pair to condense plus ~20 to expand and scale the 3x3
# block; K4: two FMAs per matrix value read (the row and the transposed
# product)
K3_PAIR_FLOPS = 90
# the materialized path: 1024 shells = 12,288 blobs, 5.06 GiB a matrix in
# float32, within the 6 GiB budget
N_DENSE = 1024
# bench.py's lubrication path (BASELINE config 5, the reference's
# Uniform_Rollers): 4096 spheres of radius 1 on a 64 x 64 lattice at
# spacing 2.4 a and height 1.3 a, with the Uniform_Rollers forces
N_LUB = 4096
LUB_FORCES = dict(g=0.0025395, repulsion_strength=0.0165677856,
                  debye_length=0.1, repulsion_strength_wall=0.0165677856,
                  debye_length_wall=0.1)


def log(msg):
    print(msg, flush=True)


def smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps, warmup=True):
    """Mean device time of fn() over reps launches (CUDA events), after
    one warm-up call unless warmup is False."""
    if warmup:
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def shell_vertices(n=12, radius=0.5):
    """bench.py's 12-blob Fibonacci shell."""
    i = np.arange(n) + 0.5
    phi = np.arccos(1 - 2 * i / n)
    theta = np.pi * (1 + 5 ** 0.5) * i
    return radius * np.stack([np.cos(theta) * np.sin(phi),
                              np.sin(theta) * np.sin(phi),
                              np.cos(phi)], axis=1)


def lattice(n_bodies, seed=0):
    """bench.py's multibody lattice above the wall and its quaternions
    (float32 from numpy seed 0)."""
    side = int(np.ceil(n_bodies ** (1 / 3)))
    idx = np.arange(n_bodies)
    pos = np.stack([(idx % side) * 1.6, ((idx // side) % side) * 1.6,
                    2.0 + (idx // (side * side)) * 1.6],
                   axis=1).astype(np.float32)
    rng = np.random.default_rng(seed)
    quat = rng.normal(size=(n_bodies, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    return pos, quat


def bench_system(n_bodies, **overrides):
    from rigidmultiblobswall_tpu_torch.models.system import BodyType, System

    kw = dict(eta=1.0, blob_radius=A_BENCH, kT=0.05, g=0.1,
              domain="single_wall", repulsion_strength_wall=0.2,
              debye_length_wall=0.2, repulsion_strength=0.2,
              debye_length=0.2, blob_blob_force_method="direct",
              solver_tolerance=2e-4)
    kw.update(overrides)
    t = BodyType(name="shell12", ref_config=shell_vertices(), count=n_bodies)
    return System(types=(t,), **kw)


def roller_lattice(n, seed=0):
    """bench.py's rollers lattice at z = 1.2 with in-plane jitter (float32
    from numpy seed 0)."""
    side = int(np.ceil(n ** 0.5))
    idx = np.arange(n)
    rng = np.random.default_rng(seed)
    r0 = np.stack([(idx % side) * 1.6, (idx // side) * 1.6,
                   np.full(n, 1.2)], axis=1).astype(np.float32)
    r0[:, :2] += rng.uniform(-0.1, 0.1, size=(n, 2))
    return r0


def roller_suspension(n, **overrides):
    """bench.py's rollers configuration for n rollers."""
    from rigidmultiblobswall_tpu_torch.models.rollers import RollerSuspension

    kw = dict(num_rollers=n, eta=1.0, blob_radius=A_ROLLER, kT=0.05, g=0.2,
              domain="single_wall", repulsion_strength=0.2,
              debye_length=0.2, repulsion_strength_wall=0.2,
              debye_length_wall=0.2, solver_tolerance=2e-4,
              free_kinematics=False, omega_one_roller=(0.0, 10.0, 0.0),
              lanczos_max_iter=24)
    kw.update(overrides)
    return RollerSuspension(**kw)


def lub_lattice(n, seed=0):
    """bench.py's lubrication lattice: spacing 2.4 a, height 1.3 a, with
    +-0.05 a in-plane jitter (float32 from numpy seed 0)."""
    side = int(np.ceil(n ** 0.5))
    idx = np.arange(n)
    rng = np.random.default_rng(seed)
    pos = np.stack([(idx % side) * 2.4, (idx // side) * 2.4,
                    np.full(n, 1.3)], axis=1).astype(np.float32)
    pos[:, :2] += rng.uniform(-0.05, 0.05, size=(n, 2))
    return pos


def lub_solver(n, device, **overrides):
    """bench.py's lubrication solver (Uniform_Rollers physics, tolerance
    2e-4, 12 neighbors a sphere) for n spheres on `device`."""
    from rigidmultiblobswall_tpu_torch.models.lubrication import LubSolver

    kw = dict(num_bodies=n, eta=0.957e-3, a=1.0, kT=0.0041419464, dt=1e-3,
              cutoff=4.5, cutoff_wall=4.5, debye_cut=1e-2, rf_delta=1e-3,
              solver_tolerance=2e-4, max_neighbors=12, device=device)
    kw.update(overrides)
    return LubSolver(**kw)


def lub_ft_calc(**overrides):
    """bench.py's lubrication forces (bench.py:276-283): gravity, wall
    Yukawa and K2's pair repulsion on the sphere centers."""
    from rigidmultiblobswall_tpu_torch.models.lubrication import make_ft_calc

    return make_ft_calc(a=1.0, **dict(LUB_FORCES, **overrides))


def ptxas_report(build_log):
    """One line per compiled kernel instance: its (demangled) name,
    registers, and spill stores/loads, from nvcc's -Xptxas=-v output."""
    entries, name, spill = [], None, ""
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill stores" in line and name is not None:
            spill = line.strip()
        elif "Used" in line and "registers" in line and name is not None:
            regs = line.split("Used", 1)[1].split(",")[0].strip()
            entries.append((name, regs, spill))
            name, spill = None, ""
    if entries and shutil.which("c++filt"):
        out = subprocess.run(["c++filt"], input="\n".join(
            e[0] for e in entries), capture_output=True, text=True)
        if out.returncode == 0:
            names = out.stdout.splitlines()
            entries = [(n.replace("(anonymous namespace)::", "")
                        .split("(", 1)[0], r, sp)
                       for n, (_, r, sp) in zip(names, entries)]
    return [f"{n}: {r}; {sp}" for n, r, sp in entries]


def check(cond, what):
    if not cond:
        raise AssertionError(f"chip_smoke: {what}")


def bound_record(nbytes, flops, mufu=0):
    """The least time the card could take, the largest of nbytes moved at
    the memory rate, flops at the float32 peak and mufu special functions
    at the special-function unit's rate, as the kernel record's bound_ms /
    bound_by (operations for either of the last two). No single PyTorch
    call computes these pair sums (PERF.md), so library_ms is None."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = max(flops / PEAK_F32_FLOPS, mufu / PEAK_SFU_PER_S) * 1e3
    ms, by = ((t_bytes, "bytes") if t_bytes >= t_ops
              else (t_ops, "operations"))
    return dict(bound_ms=ms, bound_by=by, library_ms=None)


def k5_bound(n, table, cand, nonself):
    """K5's bound record at this layout (positions in, forces out, the
    table) and its log text. The sum is antisymmetric, so the function
    needs one magnitude a pair of distinct blobs of the stencil (nonself /
    2 of the nonself directed pairs), applied to both; the log adds the
    float32 and special-function times and the bound of the cand directed
    candidate pairs that the full-stencil sweep evaluates."""
    nbytes = 4 * n * 6 + table.numel() * 4
    pairs = nonself // 2
    rec = bound_record(nbytes, pairs * (FORCE_PAIR_FLOPS + FORCE_APPLY_FLOPS),
                       pairs * FORCE_PAIR_MUFU)
    directed = bound_record(nbytes, cand * FORCE_PAIR_FLOPS,
                            cand * FORCE_PAIR_MUFU)
    f32_ms = pairs * (FORCE_PAIR_FLOPS + FORCE_APPLY_FLOPS) / PEAK_F32_FLOPS
    sfu_ms = pairs * FORCE_PAIR_MUFU / PEAK_SFU_PER_S
    return rec, (f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}, "
                 f"{pairs} unordered pairs: float32 {f32_ms * 1e3:.4f} ms, "
                 f"special functions {sfu_ms * 1e3:.4f} ms; directed "
                 f"candidate pairs {directed['bound_ms']:.4f} ms)")


def k1_vs_plain(pk, coupling, qt, vt, wall):
    """K1 against its plain version in float64 on a square scene, called
    as the paths call it (q_tgt None: tt and grand on their symmetric
    sweep) and with two tensors (the sliced sweep); returns (max err /
    max|ref|, timing text for float32)."""
    kw = dict(coupling=coupling, mode=pk.wall_mode(wall),
              self_interaction=True)
    ref = pk.pair_plain(qt.double(), qt.double(), vt.double(), **kw)
    rel = 0.0
    for q_tgt in (None, qt):
        got = pk.pair_matvec(qt, q_tgt, vt, **kw)
        torch.cuda.synchronize()
        rel = max(rel, ((got.double() - ref).abs().max()
                        / ref.abs().max()).item())
    times = ""
    if qt.dtype == torch.float32:
        ms = cuda_ms(lambda: pk.pair_matvec(qt, None, vt, **kw), 10)
        plain_ms = cuda_ms(lambda: pk.pair_plain(qt, qt, vt, **kw), 3)
        times = f"; kernel {ms:.3f} ms, plain {plain_ms:.2f} ms"
    return rel, times


def k1_full_record(pk, coupling, q, v, sub, bound, what):
    """K1 at a path's full shape (float32, wall, self pairs), called as the
    path calls it (the square product): the first `sub` target rows
    against the plain version in float64, twice bit-identical, the
    kernel's time on the symmetric sweep and the plain version's; returns
    the kernel record. Its bound counts each right-hand side's apply step
    beyond the first, and each unordered pair condensed once (with tr's
    and rt's other cross block) and applied both ways; the log prints the
    directed pairs' bound beside it."""
    n = q.shape[0]
    nc = pk.NCOMP[coupling]
    n_rhs = v.shape[1] // nc
    kw = dict(coupling=coupling, mode="wall", self_interaction=True)
    apply = K1_APPLY_FLOPS[coupling]
    directed = K1_PAIR_FLOPS[coupling] + apply * (n_rhs - 1)
    # the group pairs of the upper triangle, summed over G slices
    n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
    n_slices, tiles = pk.plan_groups(n, n_sm)
    sweep = f"the symmetric sweep ({n_slices} groups of {tiles} tiles)"
    per_pair = (K1_PAIR_FLOPS[coupling] + K1_SYM_EXTRA_FLOPS.get(
        coupling, 0) - apply + 2 * apply * n_rhs) / 2
    # the square product, as the paths call it
    got = pk.pair_matvec(q, None, v, **kw)
    again = pk.pair_matvec(q, None, v, **kw)
    torch.cuda.synchronize()
    same = torch.equal(got, again)
    ref = pk.pair_plain(q.double(), q[:sub].double(), v.double(), **kw)
    err = (got[:sub].double() - ref).abs().max().item()
    rel = err / ref.abs().max().item()
    ms = cuda_ms(lambda: pk.pair_matvec(q, None, v, **kw), 10)
    # the plain version once at full size (seconds)
    plain_ms = cuda_ms(lambda: pk.pair_plain(q, q, v, **kw), 1, warmup=False)
    nbytes = 4 * n * (3 + 2 * nc * n_rhs)
    rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, slices=n_slices,
               **bound_record(nbytes, n * n * per_pair))
    directed_ms = bound_record(nbytes, n * n * directed)["bound_ms"]
    log(f"K1 {coupling} {what} B={n_rhs} f32, {sweep}: first {sub} "
        f"target rows vs plain f64 max err "
        f"{err:.3e}, / max|ref| = {rel:.3e} (bound u32*sqrt(N) = "
        f"{bound:.2e}); repeat bit-identical {same}; kernel {ms:.3f} ms, "
        f"bound {rec['bound_ms']:.3f} ms ({rec['bound_by']}, "
        f"{rec['bound_ms'] / ms:.1%} of it; directed pairs "
        f"{directed_ms:.3f} ms, {directed_ms / ms:.1%}), plain f32 "
        f"{plain_ms:.1f} ms")
    check(rel <= bound, f"K1 {coupling} B={n_rhs} disagrees at {what} "
          f"({rel:.3e})")
    check(same, f"K1 {coupling} B={n_rhs} not bit-identical on repeat at "
          f"{what}")
    return rec


def k1_instances_at(pk, coupling, q, v, sub, what):
    """The instances of a K1 coupling that k1_full_record does not time, at
    a path's full shape, as the path calls them (the square product): the
    open domain in float32, and both in float64; the first `sub` target
    rows against the plain version in float64 (float32 within u32
    sqrt(N), float64 within 1e-12, times max|ref|), twice
    bit-identical."""
    n = q.shape[0]
    n_rhs = v.shape[1] // pk.NCOMP[coupling]
    bounds = {torch.float32: u32_sqrt(n), torch.float64: 1e-12}
    for wall in (True, False):
        kw = dict(coupling=coupling, mode=pk.wall_mode(wall),
                  self_interaction=True)
        ref = pk.pair_plain(q.double(), q[:sub].double(), v.double(), **kw)
        for dtype, bound in bounds.items():
            if wall and dtype == torch.float32:
                continue                       # k1_full_record's
            qd, vd = q.to(dtype), v.to(dtype)
            got = pk.pair_matvec(qd, None, vd, **kw)
            same = torch.equal(got, pk.pair_matvec(qd, None, vd, **kw))
            rel = ((got[:sub].double() - ref).abs().max()
                   / ref.abs().max()).item()
            log(f"K1 {coupling} {what} B={n_rhs} wall={wall} {dtype}, the "
                f"square call: first {sub} target rows vs plain f64 / "
                f"max|ref| = {rel:.3e} (bound {bound:.2e}); repeat "
                f"bit-identical {same}")
            check(rel <= bound, f"K1 {coupling} B={n_rhs} wall={wall} "
                  f"{dtype} disagrees at {what} ({rel:.3e})")
            check(same, f"K1 {coupling} B={n_rhs} wall={wall} {dtype} not "
                  f"bit-identical on repeat at {what}")


def phase_kernels(pk, mc, mob, kin, make_state):
    """Phase 3: K1/K2 against their plain versions; returns the records
    for the kernel JSON line (launches filled in by phase 6)."""
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(0)
    n, a = 3000, 0.3
    r = np.empty((n, 3))
    r[:, :2] = rng.uniform(0, 20, (n, 2))
    r[:, 2] = rng.uniform(0.05, 4, n)       # includes blobs below a
    q_wall = r.copy()
    q_wall[:, 2] = np.maximum(q_wall[:, 2], a)
    q_wall /= a
    # f32 bound: the JAX package's own (tests/test_pair_kernels.py:49)
    bounds = {torch.float32: 3e-6, torch.float64: 1e-12}
    for n_rhs in (1, 2):
        v = rng.normal(size=(n, 3 * n_rhs))
        for wall in (True, False):
            q = q_wall if wall else r / a
            for dtype, bound in bounds.items():
                qt = torch.as_tensor(q, dtype=dtype, device=dev)
                vt = torch.as_tensor(v, dtype=dtype, device=dev)
                rel, times = k1_vs_plain(pk, "tt", qt, vt, wall)
                log(f"K1 {n} blobs B={n_rhs} wall={wall} {dtype}: "
                    f"max err / max|ref| = {rel:.3e} (bound {bound:g})"
                    + times)
                check(rel <= bound, f"K1 disagrees with plain ({rel:.3e})")
    # the other couplings and their instances on the same scene, with a
    # coincident distinct pair
    rng_c = np.random.default_rng(1)
    qc, rc = q_wall.copy(), r.copy()
    qc[5], rc[5] = qc[4], rc[4]
    for coupling, n_rhs in K1_COUPLING_INSTANCES:
        v = rng_c.normal(size=(n, pk.NCOMP[coupling] * n_rhs))
        for wall in (True, False):
            q = qc if wall else rc / a
            for dtype, bound in bounds.items():
                qt = torch.as_tensor(q, dtype=dtype, device=dev)
                vt = torch.as_tensor(v, dtype=dtype, device=dev)
                rel, times = k1_vs_plain(pk, coupling, qt, vt, wall)
                log(f"K1 {coupling} {n} blobs B={n_rhs} wall={wall} "
                    f"{dtype}: max err / max|ref| = {rel:.3e} (bound "
                    f"{bound:g})" + times)
                check(rel <= bound, f"K1 {coupling} disagrees with plain "
                      f"({rel:.3e})")
    kw = dict(repulsion_strength=0.2, debye_length=0.2, blob_radius=a)
    for dtype, bound in bounds.items():
        rt = torch.as_tensor(r, dtype=dtype, device=dev)
        got = mc.blob_blob_forces(rt, **kw)
        torch.cuda.synchronize()
        ref = mc.blob_blob_forces_plain(rt.double(), **kw)
        rel = ((got.double() - ref).abs().max() / ref.abs().max()).item()
        times = ""
        if dtype == torch.float32:
            ms = cuda_ms(lambda: mc.blob_blob_forces(rt, **kw), 10)
            plain_ms = cuda_ms(lambda: mc.blob_blob_forces_plain(rt, **kw), 3)
            times = f"; kernel {ms:.3f} ms, plain {plain_ms:.2f} ms"
        log(f"K2 {n} blobs {dtype}: max err / max|ref| = {rel:.3e} "
            f"(bound {bound:g})" + times)
        check(rel <= bound, f"K2 disagrees with plain ({rel:.3e})")

    # the main path's shapes: 49,152 blobs of the 4096-shell lattice, in
    # units of a with shifted heights, as ops/mobility.py hands them to K1
    pos, quat = lattice(N_SHELLS)
    system = bench_system(N_SHELLS)
    state = make_state(pos, quat, dtype=torch.float32, device=dev)
    r_blobs = kin.blob_positions(system, state).contiguous()
    nb = r_blobs.shape[0]
    q = (mob.shift_heights(r_blobs, A_BENCH) / A_BENCH).contiguous()
    g = torch.Generator(device=dev).manual_seed(1)
    sub = 1024
    # f32 sums over 49,152 terms: rounding grows like eps32 * sqrt(N)
    # relative to the sum's magnitude; bound = 6e-8 * sqrt(49152) = 1.3e-5
    bound_main = float(np.finfo(np.float32).eps / 2 * np.sqrt(nb))
    records = {}
    for n_rhs in (1, 2):
        v = torch.randn((nb, 3 * n_rhs), generator=g, device=dev)
        rec = k1_full_record(pk, "tt", q, v, sub, bound_main, f"{nb} blobs")
        records["tt" if n_rhs == 1 else "tt_b2"] = rec
    kw = dict(repulsion_strength=0.2, debye_length=0.2, blob_radius=A_BENCH)
    records["K2"] = k2_full_record(pk, mc, r_blobs, kw, bound_main,
                                   f"{nb} blobs")
    return records


def k2_full_record(pk, mc, r, kw, bound, what):
    """K2 at a path's full shape (float32, no periodic box): against the
    plain version in float64, twice bit-identical, the kernel's time on
    its symmetric sweep and the plain version's; returns the kernel
    record. Its bound counts each unordered pair's magnitude once,
    applied to both blobs; the log prints the directed pairs' beside
    it."""
    n = r.shape[0]
    got = mc.blob_blob_forces(r, **kw)
    again = mc.blob_blob_forces(r, **kw)
    torch.cuda.synchronize()
    same = torch.equal(got, again)
    ref = mc.blob_blob_forces_plain(r.double(), **kw)
    err = (got.double() - ref).abs().max().item()
    rel = err / ref.abs().max().item()
    ms = cuda_ms(lambda: mc.blob_blob_forces(r, **kw), 10)
    plain_ms = cuda_ms(lambda: mc.blob_blob_forces_plain(r, **kw), 1)
    n_sm = torch.cuda.get_device_properties(r.device).multi_processor_count
    groups, per = pk.plan_groups(n, n_sm)
    pairs = n * (n - 1) // 2
    rec = bound_record(4 * 3 * n * 2,
                       pairs * (FORCE_PAIR_FLOPS + FORCE_APPLY_FLOPS),
                       pairs * FORCE_PAIR_MUFU)
    directed = bound_record(4 * 3 * n * 2, n * n * FORCE_PAIR_FLOPS,
                            n * n * FORCE_PAIR_MUFU)
    log(f"K2 {what} f32, the symmetric sweep ({groups} groups of {per} "
        f"tiles), vs plain f64: max err {err:.3e}, / max|ref| = {rel:.3e} "
        f"(bound {bound:.2e}); repeat bit-identical {same}; kernel "
        f"{ms:.3f} ms, plain f32 {plain_ms:.1f} ms; bound "
        f"{rec['bound_ms']:.3f} ms ({rec['bound_by']}, "
        f"{rec['bound_ms'] / ms:.1%} of it; directed pairs "
        f"{directed['bound_ms']:.3f} ms)")
    check(rel <= bound, f"K2 disagrees at {what} ({rel:.3e})")
    check(same, f"K2 not bit-identical on repeat at {what}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                design="symmetric sweep (redesigned)", **rec)


def phase_roller_kernels(pk, mob):
    """Phase 3, rollers path shapes: K1 tr (B = 1, 2), rt, rr (B = 1, 2)
    and grand on the 32,768 rollers of bench.py's lattice (heights
    shifted, units of a), as the path calls them (the square product),
    first 1024 target rows against the plain version in float64: each
    record in float32 with the wall (k1_full_record), and tr, rt and rr
    also in the open domain and in float64 (k1_instances_at). Returns the
    records for the kernel JSON line (B = 2 under "<coupling>_b2")."""
    dev = torch.device(DEVICE)
    r = torch.as_tensor(roller_lattice(N_ROLLERS), device=dev)
    q = (mob.shift_heights(r, A_ROLLER) / A_ROLLER).contiguous()
    n = q.shape[0]
    g = torch.Generator(device=dev).manual_seed(2)
    sub = 1024
    bound = u32_sqrt(n)
    records = {}
    what = f"{n} rollers"
    for coupling, n_rhs in K1_COUPLING_INSTANCES:
        v = torch.randn((n, pk.NCOMP[coupling] * n_rhs), generator=g,
                        device=dev)
        rec = k1_full_record(pk, coupling, q, v, sub, bound, what)
        records[coupling if n_rhs == 1 else f"{coupling}_b2"] = rec
        if coupling != "grand":
            k1_instances_at(pk, coupling, q, v, sub, what)
    return records


def phase_lub_kernels(pk, mc, mob):
    """Phase 3, lubrication path shapes: K1 grand and K2 on the 4096
    spheres of bench.py's lubrication lattice (heights shifted, units of
    a = 1), float32, against their plain versions in float64 (K1 grand
    the first 1024 target rows). Returns the records for the kernel JSON
    line."""
    dev = torch.device(DEVICE)
    r = torch.as_tensor(lub_lattice(N_LUB), device=dev)
    q = (mob.shift_heights(r, 1.0) / 1.0).contiguous()
    g = torch.Generator(device=dev).manual_seed(6)
    bound = u32_sqrt(N_LUB)
    v = torch.randn((N_LUB, pk.NCOMP["grand"]), generator=g, device=dev)
    what = f"{N_LUB} spheres"
    grand = k1_full_record(pk, "grand", q, v, 1024, bound, what)
    kw = dict(repulsion_strength=LUB_FORCES["repulsion_strength"],
              debye_length=LUB_FORCES["debye_length"], blob_radius=1.0)
    return {"grand_lub": grand,
            "K2_lub": k2_full_record(pk, mc, r, kw, bound, what)}


def host_normals(seed):
    """A draw_normal that takes every normal from one host generator in
    float64 and casts it to the caller's dtype and device: the same
    numbers reach a float32 and a float64 run."""
    gen = torch.Generator().manual_seed(seed)

    def draw(generator, shape, like):
        z = torch.randn(shape, generator=gen, dtype=torch.float64)
        return z.to(dtype=like.dtype, device=like.device)

    return draw


def run_lub_steps(dtype, device, tol, n=16, n_steps=3):
    """n spheres of bench.py's lubrication lattice (float64 start), three
    stochastic trapezoidal steps with omega 25 and cut_torque 0.2, the
    normals of host_normals(7). Returns (start, final positions, aux)."""
    from rigidmultiblobswall_tpu_torch.models import lubrication as lub

    pos = lub_lattice(n, seed=5).astype(np.float64)
    sol = lub_solver(n, device, solver_tolerance=tol)
    ft_calc = lub_ft_calc()
    p = torch.as_tensor(pos, dtype=dtype, device=device)
    qt = torch.tensor([[1.0, 0.0, 0.0, 0.0]] * n, dtype=dtype,
                      device=device)
    draw, lub.draw_normal = lub.draw_normal, host_normals(7)
    try:
        for _ in range(n_steps):
            p, qt, aux = lub.step_trapezoidal(sol, p, qt, None, ft_calc,
                                              omega=25.0, cut_torque=0.2)
    finally:
        lub.draw_normal = draw
    return pos, p.double().cpu().numpy(), aux


def phase_lub_parity(pk, mc):
    """Phase 4, lubrication: 16 spheres x 3 trapezoidal steps with omega
    and cut_torque, the same normals fed to every run: card float64
    against CPU float64 (bound 1e-9 of the displacement) and card float32
    against CPU float64 (1e-2); K1 grand and K2 run on the card."""
    pk.LAUNCHES.update(dict.fromkeys(pk.LAUNCHES, 0))
    mc.LAUNCHES = 0
    pos, ref, _ = run_lub_steps(torch.float64, "cpu", 1e-12)
    _, got64, aux = run_lub_steps(torch.float64, DEVICE, 1e-12)
    _, got32, _ = run_lub_steps(torch.float32, DEVICE, 1e-5)
    launches = {"K1 grand": pk.launches("grand"), "K2": mc.LAUNCHES}
    disp = np.abs(ref - pos).max()
    e64 = np.abs(got64 - ref).max() / disp
    e32 = np.abs(got32 - ref).max() / disp
    log(f"lubrication parity, 16 spheres x 3 trapezoidal steps (omega 25, "
        f"cut_torque 0.2; max displacement {disp:.3e}), max error / max "
        f"displacement: GPU f64 vs CPU f64 {e64:.3e} (bound 1e-9), GPU f32 "
        f"vs CPU f64 {e32:.3e} (bound 1e-2); gmres {aux.det_iterations}, "
        f"lanczos {aux.stoch_iterations}; launches {launches}")
    check(disp > 0 and e64 <= 1e-9 and e32 <= 1e-2, "lubrication parity")
    check(min(launches.values()) > 0, "the lubrication slice did not run "
          f"on K1 grand and K2: {launches}")


def run_steps(system, pos, quat, dtype, device, n_steps, tol):
    from rigidmultiblobswall_tpu_torch.models import integrators
    from rigidmultiblobswall_tpu_torch.models.system import make_state

    state = make_state(pos, quat, dtype=dtype, device=device)
    step = integrators.make_stepper(system, "stochastic_Slip_Trapz", 1e-3,
                                    tolerance=tol, lanczos_tolerance=1e-8)
    carry = integrators.init_carry(system, state=state)
    gen = torch.Generator().manual_seed(3)
    for _ in range(n_steps):
        state, carry, aux = step(state, gen, carry)
    return state.pos.double().cpu().numpy(), aux


def phase_slice_parity(mc):
    """Phase 4: 8 shells, kT = 0, 3 steps, card against CPU; the 96 blobs
    take the materialized engine (K3, K4)."""
    reset_dense(mc)
    pos, quat = lattice(8, seed=5)
    system = bench_system(8, kT=0.0)
    pos64, quat64 = pos.astype(np.float64), quat.astype(np.float64)
    ref, _ = run_steps(system, pos64, quat64, torch.float64, "cpu", 3, 1e-12)
    got64, aux = run_steps(system, pos64, quat64, torch.float64, DEVICE, 3,
                           1e-12)
    got32, _ = run_steps(system, pos64, quat64, torch.float32, DEVICE, 3,
                         1e-5)
    # errors relative to the largest displacement over the 3 steps, not
    # to the positions: a wrong step must not hide under max|pos|
    disp = np.abs(ref - pos64).max()
    e64 = np.abs(got64 - ref).max() / disp
    e32 = np.abs(got32 - ref).max() / disp
    log(f"slice parity, 8 shells x 3 Slip-Trapz steps (max displacement "
        f"{disp:.3e}), max error / max displacement: GPU f64 vs CPU f64 "
        f"{e64:.3e} (bound 1e-9), GPU f32 vs CPU f64 {e32:.3e} (bound "
        f"1e-2); gmres {aux.det_iterations}, lanczos {aux.stoch_iterations}; "
        f"launches {dense_launches(mc)}")
    check(disp > 0 and e64 <= 1e-9 and e32 <= 1e-2, "slice parity")
    check(min(dense_launches(mc).values()) > 0,
          "the 8-shell slice did not run on K3/K4")


def run_roller_steps(sus, r0, scheme, dtype, device, n_steps=3):
    from rigidmultiblobswall_tpu_torch.models import rollers

    r = torch.as_tensor(r0, dtype=dtype, device=device)
    step = rollers.make_stepper(sus, scheme, 1e-3)
    carry = rollers.init_carry(sus, positions=r)
    gen = torch.Generator().manual_seed(3)     # host: same noise everywhere
    for _ in range(n_steps):
        r, carry, aux = step(r, gen, carry)
    return r.double().cpu().numpy(), aux


def phase_roller_parity():
    """Phase 4, rollers: 16 rollers x 3 steps of each Adams-Bashforth
    scheme, GPU f64 against CPU f64 at kT = 0.05 (the same host-drawn
    noise) and GPU f32 against CPU f64 at kT = 0."""
    r0 = roller_lattice(16, seed=5).astype(np.float64)
    for scheme in ("deterministic_adams_bashforth_rollers",
                   "stochastic_adams_bashforth_rollers"):
        sus64 = roller_suspension(16, solver_tolerance=1e-12)
        ref, _ = run_roller_steps(sus64, r0, scheme, torch.float64, "cpu")
        got64, aux = run_roller_steps(sus64, r0, scheme, torch.float64,
                                      DEVICE)
        sus0 = roller_suspension(16, kT=0.0, solver_tolerance=1e-12)
        ref0, _ = run_roller_steps(sus0, r0, scheme, torch.float64, "cpu")
        got32, _ = run_roller_steps(
            roller_suspension(16, kT=0.0, solver_tolerance=1e-5), r0,
            scheme, torch.float32, DEVICE)
        disp, disp0 = np.abs(ref - r0).max(), np.abs(ref0 - r0).max()
        e64 = np.abs(got64 - ref).max() / disp
        e32 = np.abs(got32 - ref0).max() / disp0
        log(f"rollers parity, 16 rollers x 3 steps of {scheme} (max "
            f"displacement {disp:.3e} at kT = 0.05, {disp0:.3e} at kT = 0), "
            f"max error / max displacement: GPU f64 vs CPU f64 {e64:.3e} "
            f"(bound 1e-9), GPU f32 vs CPU f64 at kT = 0 {e32:.3e} (bound "
            f"1e-2); gmres {aux.det_iterations}, lanczos "
            f"{aux.stoch_iterations}")
        check(disp > 0 and disp0 > 0 and e64 <= 1e-9 and e32 <= 1e-2,
              f"rollers parity ({scheme})")


def phase_cli():
    """Phase 5: the CLI on a generated 64-shell input file, 3 steps."""
    from rigidmultiblobswall_tpu_torch import cli

    pos, quat = lattice(64, seed=0)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as d:
        inp = write_shell_input(d, pos, quat, (
            "scheme stochastic_Slip_Trapz\ndt 0.001\nn_steps 3\nn_save 3\n"
            "solver_tolerance 2e-4\n"))
        os.chdir(d)
        try:
            t0 = time.perf_counter()
            cli.main(["--input-file", inp, "--device", DEVICE])
            secs = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
        final = np.loadtxt(os.path.join(d, "run.shell.00000003.clones"),
                           skiprows=1)
        info = dict(line.split() for line in
                    open(os.path.join(d, "run.info")).read().splitlines())
    det = int(info["deterministic_iterations_count"])
    sto = int(info["stochastic_iterations_count"])
    log(f"CLI 64 shells x 3 steps: {secs:.2f} s, final clones "
        f"{final.shape}, gmres {det}, lanczos {sto}")
    check(final.shape == (64, 7) and np.all(np.isfinite(final)),
          "CLI clones not finite")
    check(det > 0 and sto > 0, "CLI ran no solver iterations")


def phase_roller_cli():
    """Phase 5, rollers: the CLI on a generated 64-roller input file with
    the options of examples/rollers/inputfile.dat, 3 steps."""
    from rigidmultiblobswall_tpu_torch import cli
    from rigidmultiblobswall_tpu_torch.io import scene

    pos = roller_lattice(64, seed=0) * np.float32(2.0)   # spacing 3.2 a
    pos[:, 2] = 1.2
    quat = np.tile([1.0, 0.0, 0.0, 0.0], (64, 1))
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "blob.vertex"), "w") as f:
            f.write("1\n0 0 0\n")
        scene.write_clones_file(os.path.join(d, "rollers.clones"), pos, quat)
        inp = os.path.join(d, "input.dat")
        with open(inp, "w") as f:
            f.write("scheme stochastic_adams_bashforth_rollers\ndt 0.002\n"
                    "n_steps 3\nn_save 3\neta 1.0\nblob_radius 1.0\n"
                    "kT 0.05\ng 1.0\nrepulsion_strength_wall 1.0\n"
                    "debye_length_wall 0.1\nrepulsion_strength 1.0\n"
                    "debye_length 0.1\nfree_kinematics False\n"
                    "omega_one_roller 0 10.0 0\nhydro_interactions 1\n"
                    "seed 2\ndomain single_wall\noutput_name run_rollers\n"
                    "structure blob.vertex rollers.clones\n")
        os.chdir(d)
        try:
            t0 = time.perf_counter()
            cli.main(["--input-file", inp, "--device", DEVICE])
            secs = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
        final = np.loadtxt(os.path.join(
            d, "run_rollers.rollers.00000003.clones"), skiprows=1)
        info = dict(line.split() for line in open(os.path.join(
            d, "run_rollers.info")).read().splitlines())
    log(f"rollers CLI 64 rollers x 3 steps: {secs:.2f} s, final clones "
        f"{final.shape}, .info {info}")
    check(final.shape == (64, 7) and np.all(np.isfinite(final)),
          "rollers CLI clones not finite")
    check(int(info["deterministic_iterations_count"]) > 0
          and int(info["stochastic_iterations_count"]) > 0,
          "rollers CLI ran no solver iterations")


def phase_lub_cli():
    """Phase 5, lubrication: the CLI on a generated 16-sphere lubrication
    input (trapezoidal, omega 25 and cut_torque 0.2, the firm terms on) at
    kT = 0, 3 steps, card float64 against CPU float64: the same .clones
    (1e-9 of the displacement) and deterministic .info counts."""
    from rigidmultiblobswall_tpu_torch import cli
    from rigidmultiblobswall_tpu_torch.io import scene

    pos = lub_lattice(16, seed=1).astype(np.float64)
    pos[:, 2] = 1.2
    quat = np.tile([1.0, 0.0, 0.0, 0.0], (16, 1))
    cwd = os.getcwd()
    out = {}
    with tempfile.TemporaryDirectory() as d:
        for name, device in (("host", "cpu"), ("card", DEVICE)):
            dd = os.path.join(d, name)
            os.makedirs(dd)
            with open(os.path.join(dd, "sphere.vertex"), "w") as f:
                f.write("1\n0 0 0\n")
            scene.write_clones_file(os.path.join(dd, "spheres.clones"), pos,
                                    quat)
            inp = os.path.join(dd, "input.dat")
            with open(inp, "w") as f:
                f.write("scheme lubrication_trapezoidal\ndt 0.001\n"
                        "n_steps 3\nn_save 3\neta 0.957e-3\n"
                        "blob_radius 1.0\nkT 0.0\ng 0.0025395\n"
                        "repulsion_strength 0.0165677856\ndebye_length 0.1\n"
                        "repulsion_strength_wall 0.0165677856\n"
                        "debye_length_wall 0.1\nsolver_tolerance 1e-12\n"
                        "seed 0\nomega 25.0\ncut_torque 0.2\n"
                        "max_neighbors 12\nLub_Cut 4.5\n"
                        "repulsion_strength_firm 0.0163\nfirm_delta 1e-2\n"
                        "output_name run\n"
                        "structure sphere.vertex spheres.clones\n")
            os.chdir(dd)
            try:
                t0 = time.perf_counter()
                cli.main(["--input-file", inp, "--device", device, "--f64"])
                secs = time.perf_counter() - t0
            finally:
                os.chdir(cwd)
            final = np.loadtxt(os.path.join(dd, "run.spheres.00000003.clones"),
                               skiprows=1)
            info = dict(line.split() for line in open(os.path.join(
                dd, "run.info")).read().splitlines())
            out[name] = (final, info, secs)
    (ref, info_ref, _), (got, info, secs) = out["host"], out["card"]
    disp = np.abs(ref[:, :3] - pos).max()
    err = np.abs(got - ref).max() / disp
    log(f"lubrication CLI 16 spheres x 3 steps (firm terms on, kT = 0): "
        f"{secs:.2f} s on the card, max error / max displacement GPU f64 vs "
        f"CPU f64 {err:.3e} (bound 1e-9; displacement {disp:.3e}), .info "
        f"{info} (CPU {info_ref})")
    check(got.shape == (16, 7) and np.all(np.isfinite(got)),
          "lubrication CLI clones not finite")
    check(disp > 0 and err <= 1e-9, "lubrication CLI card vs CPU")
    for key in ("num_rejections_wall", "num_rejections_jump",
                "deterministic_iterations_count"):
        check(info[key] == info_ref[key], f"lubrication CLI {key}")
    check(int(info["deterministic_iterations_count"]) > 0,
          "lubrication CLI ran no GMRES iterations")


def phase_main_path(pk, mc):
    """Phase 6: bench.py's multibody step at 4096 shells, float32."""
    from rigidmultiblobswall_tpu_torch.models import integrators
    from rigidmultiblobswall_tpu_torch.models.system import make_state

    dev = torch.device(DEVICE)
    system = bench_system(N_SHELLS)
    pos, quat = lattice(N_SHELLS)
    state = make_state(pos, quat, dtype=torch.float32, device=dev)
    step = integrators.make_stepper(
        system, "stochastic_Slip_Trapz", 1e-3, lanczos_tolerance=5e-4,
        lanczos_max_iter=32, lanczos_check_every=4, gmres_restart=60,
        gmres_maxiter=300, max_rejections=3)
    carry = integrators.init_carry(system, state=state)
    gen = torch.Generator().manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    pk.LAUNCHES.update(dict.fromkeys(pk.LAUNCHES, 0))
    mc.LAUNCHES = 0
    reset_dense(mc)
    t0 = time.perf_counter()
    state, carry, aux = step(state, gen, carry)       # warm-up
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    log(f"main path warm-up step: {warm_s * 1e3:.1f} ms, gmres "
        f"{aux.det_iterations}, lanczos {aux.stoch_iterations}, rejections "
        f"{aux.rejections}")
    n_timed = 3
    det, sto, rej = [], [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_timed):
        state, carry, aux = step(state, gen, carry)
        det.append(aux.det_iterations)
        sto.append(aux.stoch_iterations)
        rej.append(aux.rejections)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / n_timed * 1e3
    launches = {"K1 tt": pk.LAUNCHES["tt", 1],
                "K1 tt B=2": pk.LAUNCHES["tt", 2], "K2": mc.LAUNCHES}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    p = state.pos
    log(f"main path {system.num_blobs} blobs ({N_SHELLS} shells) "
        f"stochastic_Slip_Trapz f32: {ms:.1f} ms/step over {n_timed} steps; "
        f"gmres {det}, lanczos {sto}, rejections {rej}, peak device memory "
        f"{peak:.2f} GiB, launches over the 4 steps {launches}")
    check(bool(torch.isfinite(p).all()), "positions not finite")
    check(p.shape == (N_SHELLS, 3), "positions shape")
    check(min(det) > 0 and min(sto) > 0, "no GMRES or Lanczos iterations")
    check(all(v > 0 for v in launches.values()),
          f"a kernel was not launched on the main path: {launches}")
    # 87 GB of matrix at 49,152 blobs: above the budget, matrix-free
    check(max(dense_launches(mc).values()) == 0,
          f"K3/K4 launched above the budget: {dense_launches(mc)}")
    return launches


def phase_rollers_path(pk, mc):
    """Phase 7: bench.py's rollers step at 32,768 rollers, float32."""
    from rigidmultiblobswall_tpu_torch.models import rollers

    dev = torch.device(DEVICE)
    sus = roller_suspension(N_ROLLERS)
    r = torch.as_tensor(roller_lattice(N_ROLLERS), device=dev)
    step = rollers.make_stepper(sus, "stochastic_adams_bashforth_rollers",
                                1e-3, max_rejections=3)
    carry = rollers.init_carry(sus, positions=r)
    gen = torch.Generator().manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pk.LAUNCHES.update(dict.fromkeys(pk.LAUNCHES, 0))
    pk.SYM_LAUNCHES.update(dict.fromkeys(pk.SYM_LAUNCHES, 0))
    mc.LAUNCHES = 0
    t0 = time.perf_counter()
    r, carry, aux = step(r, gen, carry)               # warm-up
    torch.cuda.synchronize()
    log(f"rollers path warm-up step: "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms, gmres "
        f"{aux.det_iterations}, lanczos {aux.stoch_iterations}, rejections "
        f"{aux.rejections}, wall overlaps {aux.wall_overlaps}")
    n_timed = 3
    det, sto, rej, ovl = [], [], [], []
    t0 = time.perf_counter()
    for _ in range(n_timed):
        r, carry, aux = step(r, gen, carry)
        det.append(aux.det_iterations)
        sto.append(aux.stoch_iterations)
        rej.append(aux.rejections)
        ovl.append(aux.wall_overlaps)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / n_timed * 1e3
    # each coupling's launches over every B, and those of the B = 2
    # instances of tr and rr (the lockstep torque solve; the path runs tr
    # and rr with B = 2 only)
    launches = {f"K1 {c}": pk.launches(c) for c in pk.NCOMP}
    launches.update({f"K1 {c} B=2": pk.LAUNCHES[c, 2] for c in ("tr", "rr")})
    launches["K2"] = mc.LAUNCHES
    sym = {f"K1 {c} B={b}": (pk.SYM_LAUNCHES[c, b], n)
           for (c, b), n in pk.LAUNCHES.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"rollers path {N_ROLLERS} rollers stochastic_adams_bashforth_"
        f"rollers f32: {ms:.1f} ms/step over {n_timed} steps; gmres sweeps "
        f"{det}, lanczos {sto}, rejections {rej}, wall overlaps {ovl}, peak "
        f"device memory {peak:.2f} GiB, launches over the 4 steps "
        f"{launches}; on the symmetric sweep (of all) {sym}")
    check(bool(torch.isfinite(r).all()), "roller positions not finite")
    check(r.shape == (N_ROLLERS, 3), "roller positions shape")
    check(min(det) > 0 and min(sto) > 0, "no GMRES or Lanczos iterations")
    check(all(v > 0 for v in launches.values()),
          f"a kernel was not launched on the rollers path: {launches}")
    # every product of the path is square: each coupling runs its
    # symmetric instances only
    check(all(n_sym == n for n_sym, n in sym.values()),
          f"a square product left the symmetric sweep: {sym}")
    return launches

def wall_roller_suspension(n, **overrides):
    """bench.py's rollers configuration on domain single_wall_spectral for
    n rollers, at the automatic near-field cell capacity."""
    side = int(np.ceil(n ** 0.5))
    kw = dict(domain="single_wall_spectral",
              periodic_length=(side * 1.6, side * 1.6, 0.0),
              spectral_wall_height=1.8, spectral_tol=1e-4,
              spectral_grid_max=512)
    kw.update(overrides)
    return roller_suspension(n, **kw)


def u32_sqrt(n_terms):
    """f32 rounding of a sum of n_terms relative to its magnitude."""
    return float(np.finfo(np.float32).eps / 2 * np.sqrt(n_terms))


def k5_vs_plain(ck, pos, table, dims, box, cap, kw, cells_range=None,
                guard_z=False):
    """K5 against its plain version in float64 (on cells_range, or every
    cell), and a second launch against the first; returns (max abs error,
    max|ref|, bit-identical on repeat)."""
    got = ck.nl_forces(pos, table, dims, box, cap, guard_z=guard_z, **kw)
    same = torch.equal(got, ck.nl_forces(pos, table, dims, box, cap,
                                         guard_z=guard_z, **kw))
    torch.cuda.synchronize()
    ref = ck.nl_forces_plain(pos.double(), table, dims, box, cap,
                             cells_range=cells_range, **kw)
    rows = _rows_of(table, pos.shape[0], cap, cells_range)
    err = (got.double()[rows] - ref[rows]).abs().max().item()
    return err, ref[rows].abs().max().item(), same


def k6_vs_plain(ck, plan, f, cells_range=None):
    """K6 against its plain version in float64 on the plan's cells, and a
    second launch against the first; returns (max abs error, max|ref|,
    bit-identical on repeat)."""
    p = plan.params
    args = (plan.cell_table, plan.cell_dims, p.box, p.cell_capacity)
    kw = dict(two_a=2 * p.a, r_cut=p.r_cut)
    got = ck.near_rpy(plan.positions, f, *args, plan.cheb, **kw)
    same = torch.equal(got, ck.near_rpy(plan.positions, f, *args, plan.cheb,
                                        **kw))
    torch.cuda.synchronize()
    ref = ck.near_rpy_plain(plan.positions.double(), f.double(), *args,
                            plan.cheb.double(), cells_range=cells_range,
                            **kw)
    rows = _rows_of(plan.cell_table, f.shape[0], p.cell_capacity,
                    cells_range)
    err = (got.double()[rows] - ref[rows]).abs().max().item()
    return err, ref[rows].abs().max().item(), same


def _rows_of(table, n, cap, cells_range):
    """Particle ids held by the cells of cells_range (every particle the
    table holds when None)."""
    lo, hi = cells_range if cells_range is not None else (
        0, table.shape[0] // cap)
    ids = table[lo * cap:hi * cap].long()
    return ids[ids < n]


def k6_flops(ck, plan, n_rhs):
    """Operations of one K6 sweep at this plan's data (see
    K1_PAIR_FLOPS): those of the function, counted on the pairs inside
    r_cut, and those of the 27-cell algorithm, which also tests every
    other candidate pair of the stencil (8 each). Returns (function
    operations, algorithm operations, candidate pairs, inside pairs)."""
    p = plan.params
    cand, inside = ck.pair_counts(plan.positions, plan.cell_table,
                                  plan.cell_dims, p.box, p.cell_capacity,
                                  p.r_cut)
    K = plan.cheb.shape[2]
    flops = inside * (8 + 6 + 6 * K + 18 * n_rhs)
    return flops, flops + 8 * (cand - inside), cand, inside


def header_flops(name="img_terms"):
    """Operations of one call of the generated function `name`, counted
    from csrc/wall_img_terms.cuh: every binary + - * of its body (the
    header writes a sum or difference with spaces, a product as * with or
    without them)."""
    path = os.path.join(ROOT, "rigidmultiblobswall_tpu_torch", "csrc",
                        "wall_img_terms.cuh")
    body = open(path).read().split(f"void {name}(", 1)[1]
    body = body.split("{", 1)[1].split("\n}", 1)[0]
    return sum(body.count(op) for op in (" + ", " - ", "*"))


def k7_flops(ck, plan, n_rhs):
    """Operations of one K7 sweep at this plan's data (see
    K7_IMG_PAIR_FLOPS), counted on the real targets' pairs inside r_cut;
    the 27-cell algorithm also tests every other candidate pair (8 each).
    Returns (function operations, algorithm operations, candidate pairs,
    inside pairs, pairs with an image source)."""
    from rigidmultiblobswall_tpu_torch.ops import ewald_wall

    p = plan.params
    args, _ = ewald_wall.near_args(plan)
    cand, inside, img = ck.wall_pair_counts(plan.pos_all, *args[:4],
                                            p.r_cut, p.z0)
    K, Ki = args[4].shape[2], args[5].shape[2]
    flops = (inside * (8 + 6 + 6 * K + 19 * n_rhs)
             + img * (K7_IMG_PAIR_FLOPS + 30 * Ki
                      + (header_flops() + 6) * n_rhs))
    return flops, flops + 8 * (cand - inside), cand, inside, img


def k7_vs_plain(ck, plan, f, cells_range=None):
    """K7 against its plain version in float64 on the plan's cells (the
    real particles' rows there)."""
    from rigidmultiblobswall_tpu_torch.ops import ewald_wall

    args, kw = ewald_wall.near_args(plan)
    got = ck.wall_near(plan.pos_all, f, *args, cz_range=ewald_wall
                       ._kept_layers(plan.params, plan.cell_dims), **kw)
    torch.cuda.synchronize()
    dargs = tuple(x.double() if torch.is_tensor(x) and x.is_floating_point()
                  else x for x in args)
    ref = ck.wall_near_plain(plan.pos_all.double(), f.double(), *dargs,
                             cells_range=cells_range, **kw)
    rows = _rows_of(plan.cell_table, plan.n_real, plan.params.cell_capacity,
                    cells_range)
    err = (got.double()[rows] - ref[rows]).abs().max().item()
    return err, ref[rows].abs().max().item()


def phase_wall_kernels(ck):
    """Phase 3, K7 and K5 on a random 14 x 14 wall slab of 3000 blobs
    (blobs below a, blobs above the slab top that the plan clips, a
    coincident pair, a pair closer than 2a): K7 with B = 1 and 2, float32
    at 2e-5 x max|ref| (the JAX package's bound for its float32 K7) and
    float64 at 1e-12, and K5 on the wall-slab forces' layout (z clipped
    below an empty guard layer), float32 at 3e-6 and float64 at 1e-12,
    against the plain versions in float64."""
    from rigidmultiblobswall_tpu_torch.ops import ewald_wall, forces

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(12)
    n, L, a, z_hi = 3000, 14.0, 0.3, 3.0
    r = np.empty((n, 3))
    r[:, :2] = rng.uniform(0, L, (n, 2))
    r[:, 2] = rng.uniform(0.3 * a, 1.2 * z_hi, n)
    r[7] = r[6]
    r[9] = r[8] + 0.3 * a
    f6 = rng.normal(size=(n, 6))
    p = dataclasses.replace(ewald_wall.default_wall_params(
        a, 1.0, (L, L), z_hi, tol=1e-4), cell_capacity=96)
    for dtype, bound_rel in ((torch.float32, 2e-5), (torch.float64, 1e-12)):
        plan = ewald_wall.make_wall_plan(
            p, torch.as_tensor(r, dtype=dtype, device=dev))
        check(int(plan.n_dropped_cells) == 0 and int(plan.n_clipped) > 0,
              "K7 scene overflows or clips nothing")
        for n_rhs in (1, 2):
            f = torch.as_tensor(f6[:, :3 * n_rhs], dtype=dtype,
                                device=dev).contiguous()
            err, scale = k7_vs_plain(ck, plan, f)
            times = ""
            if dtype == torch.float32:
                args, kw = ewald_wall.near_args(plan)
                ms = cuda_ms(lambda: ewald_wall.near_matvec(plan, f), 10)
                plain_ms = cuda_ms(lambda: ck.wall_near_plain(
                    plan.pos_all, f, *args, **kw), 3)
                times = f"; kernel {ms:.3f} ms, plain {plain_ms:.2f} ms"
            log(f"K7 {n} blobs cells {plan.cell_dims} cap {p.cell_capacity} "
                f"B={n_rhs} {dtype}: max err / max|ref| = {err / scale:.3e} "
                f"(bound {bound_rel:g})" + times)
            check(err <= bound_rel * scale, f"K7 disagrees ({err / scale})")
    rc, fcap = 2 * a + 30 * 0.05, 64
    kw5 = dict(eps_over_b=0.7 / 0.05, inv_b=1 / 0.05, two_a=2 * a)
    for dtype, bound_rel in ((torch.float32, 3e-6), (torch.float64, 1e-12)):
        pos, dims, box, table, dropped = forces._force_cells(
            torch.as_tensor(r, dtype=dtype, device=dev), (L, L, 0.0), rc, 16,
            fcap, z_hi)
        check(int(dropped) == 0, "wall-slab K5 scene overflows")
        got = ck.nl_forces(pos, table, dims, box, fcap, guard_z=True, **kw5)
        same = torch.equal(got, ck.nl_forces(pos, table, dims, box, fcap,
                                             guard_z=True, **kw5))
        torch.cuda.synchronize()
        ref = ck.nl_forces_plain(pos.double(), table, dims, box, fcap, **kw5)
        err, scale = (got.double() - ref).abs().max().item(), \
            ref.abs().max().item()
        log(f"K5 wall slab {n} blobs cells {dims} cap {fcap} {dtype}: max "
            f"err / max|ref| = {err / scale:.3e} (bound {bound_rel:g}); "
            f"repeat bit-identical {same}")
        check(err <= bound_rel * scale, f"wall-slab K5 disagrees "
              f"({err / scale})")
        check(same, "wall-slab K5 not bit-identical on repeat")


def phase_cell_kernels(ck, cells, ewald):
    """Phase 3, K5 and K6 on a random periodic box of 3000 blobs (a
    coincident pair, blobs closer than 2a, capacity without overflow):
    K6 with B = 1 and 2 and K5, float32 at 3e-6 x max|ref| and float64 at
    1e-12 against the plain versions in float64."""
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(4)
    n, L, a, cap = 3000, 14.0, 0.3, 48
    r = rng.uniform(0, L, (n, 3))
    r[7] = r[6]
    r[9] = r[8] + 0.3 * a
    f6 = rng.normal(size=(n, 6))
    p = ewald.default_params(a, 1.0, (L, L, L), tol=1e-4, cell_capacity=cap)
    box = (L, L, L)
    kw5 = dict(eps_over_b=0.2 / 0.2, inv_b=1 / 0.2, two_a=2 * a)
    dims5 = (7, 7, 7)
    # f32 bound: the JAX package's own for its f32 kernels
    for dtype, bound_rel in ((torch.float32, 3e-6), (torch.float64, 1e-12)):
        pos = torch.as_tensor(r, dtype=dtype, device=dev)
        plan = ewald.make_plan(p, pos)
        check(int(plan.n_dropped_cells) == 0, "K6 scene overflows")
        for n_rhs in (1, 2):
            f = torch.as_tensor(f6[:, :3 * n_rhs], dtype=dtype,
                                device=dev).contiguous()
            err, scale, same = k6_vs_plain(ck, plan, f)
            times = ""
            if dtype == torch.float32:
                ms = cuda_ms(lambda: ewald.real_matvec(plan, f), 10)
                plain_ms = cuda_ms(lambda: ck.near_rpy_plain(
                    plan.positions, f, plan.cell_table, plan.cell_dims, box,
                    cap, plan.cheb, two_a=2 * a, r_cut=p.r_cut), 3)
                times = f"; kernel {ms:.3f} ms, plain {plain_ms:.2f} ms"
            log(f"K6 {n} blobs cells {plan.cell_dims} cap {cap} B={n_rhs} "
                f"{dtype}: max err / max|ref| = {err / scale:.3e} (bound "
                f"{bound_rel:g}); repeat bit-identical {same}" + times)
            check(err <= bound_rel * scale, f"K6 disagrees ({err / scale})")
            check(same, f"K6 B={n_rhs} not bit-identical on repeat")
        table, _, _, dropped = cells.cell_bin(pos, box, dims5, cap)
        check(int(dropped) == 0, "K5 scene overflows")
        err, scale, same = k5_vs_plain(ck, pos, table, dims5, box, cap, kw5)
        times = ""
        if dtype == torch.float32:
            ms = cuda_ms(lambda: ck.nl_forces(pos, table, dims5, box, cap,
                                              **kw5), 10)
            plain_ms = cuda_ms(lambda: ck.nl_forces_plain(
                pos, table, dims5, box, cap, **kw5), 3)
            times = f"; kernel {ms:.3f} ms, plain {plain_ms:.2f} ms"
        log(f"K5 {n} blobs cells {dims5} cap {cap} {dtype}: max err / "
            f"max|ref| = {err / scale:.3e} (bound {bound_rel:g}); repeat "
            f"bit-identical {same}" + times)
        check(err <= bound_rel * scale, f"K5 disagrees ({err / scale})")
        check(same, "K5 not bit-identical on repeat")


def spectral_lattice(n_bodies, side, seed=0):
    """bench.py's periodic lattice: spacing 1.6 from z0 = 0.8, jitter
    +-0.25 on every axis, then the quaternions (float32, numpy seed)."""
    idx = np.arange(n_bodies)
    pos = np.stack([(idx % side) * 1.6, ((idx // side) % side) * 1.6,
                    0.8 + (idx // (side * side)) * 1.6],
                   axis=1).astype(np.float32)
    rng = np.random.default_rng(seed)
    pos += rng.uniform(-0.25, 0.25, size=pos.shape).astype(np.float32)
    quat = rng.normal(size=(n_bodies, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    return pos, quat


def spectral_system(n_bodies, L, **overrides):
    """bench.py's spectral configuration: a periodic box of twelve-blob
    shells on the spectral Ewald engine, linked-cell repulsion."""
    from rigidmultiblobswall_tpu_torch.models.system import BodyType, System

    kw = dict(eta=1.0, blob_radius=A_BENCH, kT=0.05, g=0.0,
              domain="periodic_spectral", periodic_length=(L, L, L),
              spectral_tol=1e-4, spectral_grid_max=256,
              repulsion_strength=0.2, debye_length=0.2,
              blob_blob_force_method="neighbor_list",
              blob_blob_cutoff=2 * A_BENCH + 12 * 0.2,
              blob_blob_grid_dim=32, blob_blob_cell_capacity=96,
              solver_tolerance=2e-4)
    kw.update(overrides)
    t = BodyType(name="shell12", ref_config=shell_vertices(), count=n_bodies)
    return System(types=(t,), **kw)


def phase_spectral_parity():
    """Phase 4, spectral: 27 shells in a 4.8 box (6 near-field cells a
    side; force cutoff 1.2 for 4 force cells) x 3 Slip-Trapz steps, GPU
    f64 against CPU f64 at kT = 0.05 (the same host-drawn noise), GPU f32
    against CPU f64 at kT = 0."""
    pos, quat = spectral_lattice(27, 3, seed=5)
    pos64, quat64 = pos.astype(np.float64), quat.astype(np.float64)
    L = 3 * 1.6
    out = {}
    for kT in (0.05, 0.0):
        for dtype, device, tol in ((torch.float64, "cpu", 1e-12),
                                   (torch.float64, DEVICE, 1e-12),
                                   (torch.float32, DEVICE, 1e-5)):
            if kT > 0 and dtype == torch.float32:
                continue
            system = spectral_system(27, L, kT=kT, blob_blob_cutoff=1.2)
            out[kT, dtype, device] = run_steps(system, pos64, quat64, dtype,
                                               device, 3, tol)
    ref, _ = out[0.05, torch.float64, "cpu"]
    got64, aux = out[0.05, torch.float64, DEVICE]
    ref0, _ = out[0.0, torch.float64, "cpu"]
    got32, _ = out[0.0, torch.float32, DEVICE]
    disp, disp0 = np.abs(ref - pos64).max(), np.abs(ref0 - pos64).max()
    e64 = np.abs(got64 - ref).max() / disp
    e32 = np.abs(got32 - ref0).max() / disp0
    log(f"spectral parity, 27 shells x 3 Slip-Trapz steps (max displacement "
        f"{disp:.3e} at kT = 0.05, {disp0:.3e} at kT = 0), max error / max "
        f"displacement: GPU f64 vs CPU f64 {e64:.3e} (bound 1e-9), GPU f32 "
        f"vs CPU f64 at kT = 0 {e32:.3e} (bound 1e-2); gmres "
        f"{aux.det_iterations}, lanczos {aux.stoch_iterations}, overflows "
        f"{aux.capacity_overflows}")
    check(disp > 0 and disp0 > 0 and e64 <= 1e-9 and e32 <= 1e-2,
          "spectral parity")


def write_spectral_input(d, pos, quat, settings,
                         domain="periodic_spectral"):
    """A spectral-domain input file of twelve-blob shells with tree
    (linked-cell) blob forces in directory d; returns its path."""
    from rigidmultiblobswall_tpu_torch.io import scene

    with open(os.path.join(d, "shell.vertex"), "w") as f:
        f.write("12\n")
        for x in shell_vertices():
            f.write("%.16g %.16g %.16g\n" % tuple(x))
    scene.write_clones_file(os.path.join(d, "shell.clones"), pos, quat)
    inp = os.path.join(d, "input.dat")
    with open(inp, "w") as f:
        f.write(settings + "scheme stochastic_Slip_Trapz\ndt 0.001\neta 1.0\n"
                "g 0.0\nblob_radius 0.131\nkT 0.05\nsolver_tolerance 2e-4\n"
                f"repulsion_strength 0.2\ndomain {domain}\n"
                "spectral_tolerance 1e-4\nblob_blob_force_implementation "
                "tree\nseed 1\noutput_name run\n"
                "structure shell.vertex shell.clones\n")
    return inp


def run_spectral_cli(d, inp, n_steps, n_bodies):
    """The CLI on inp, run from d on the card; checks the final clones
    and .info and returns (seconds of cli.main, .info)."""
    from rigidmultiblobswall_tpu_torch import cli

    cwd = os.getcwd()
    os.chdir(d)
    try:
        t0 = time.perf_counter()
        cli.main(["--input-file", inp, "--device", DEVICE])
        secs = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    final = np.loadtxt(os.path.join(d, "run.shell.%08d.clones" % n_steps),
                       skiprows=1)
    info = dict(line.split() for line in
                open(os.path.join(d, "run.info")).read().splitlines())
    check(final.shape == (n_bodies, 7) and np.all(np.isfinite(final)),
          "spectral CLI clones not finite")
    check(int(info["deterministic_iterations_count"]) > 0
          and int(info["capacity_overflow_steps"]) == 0,
          "spectral CLI ran no solver iterations or overflowed")
    return secs, info


def phase_spectral_cli():
    """Phase 5, spectral: the CLI on a generated 27-shell periodic_spectral
    input with tree (linked-cell) blob forces, 3 steps on the card."""
    pos, quat = spectral_lattice(27, 3, seed=0)
    with tempfile.TemporaryDirectory() as d:
        inp = write_spectral_input(d, pos, quat, (
            "n_steps 3\nn_save 3\ndebye_length 0.03\n"
            "periodic_length 4.8 4.8 4.8\n"))
        secs, info = run_spectral_cli(d, inp, 3, 27)
    log(f"spectral CLI 27 shells x 3 steps: {secs:.2f} s, .info {info}")


def phase_spectral_cli_full():
    """Phase 8, CLI: bench.py's spectral configuration through the CLI,
    which draws its noise on the card. Its input file cannot name a force
    cutoff, so the linked cells take the reference's default 2a + 30 b
    (6.262 here, 5 force cells a side) in place of the 2a + 12 b of the
    library run. Runs of 1 and 5 steps; a quarter of the difference of
    their cli.main times is the CLI's time per step."""
    pos, quat = spectral_lattice(N_SPECTRAL, SPECTRAL_SIDE)
    secs = {}
    with tempfile.TemporaryDirectory() as d:
        for n_steps in (1, 5):
            inp = write_spectral_input(d, pos, quat, (
                f"n_steps {n_steps}\nn_save {n_steps}\ndebye_length 0.2\n"
                f"periodic_length {L_SPECTRAL!r} {L_SPECTRAL!r} "
                f"{L_SPECTRAL!r}\nspectral_grid_max 256\n"))
            secs[n_steps], info = run_spectral_cli(d, inp, n_steps,
                                                   N_SPECTRAL)
    ms = (secs[5] - secs[1]) / 4 * 1e3
    log(f"spectral CLI {N_SPECTRAL} shells f32, force cutoff 2a + 30 b: "
        f"cli.main {secs[1]:.2f} s for 1 step, {secs[5]:.2f} s for 5, "
        f"{ms:.1f} ms/step; .info of the 5 steps {info}")


def phase_spectral_path(pk, mc, ck):
    """Phase 8: bench.py's spectral step at 8192 shells, float32. Checks
    K5 and K6 at its shapes first, then drives the path."""
    from rigidmultiblobswall_tpu_torch.models import integrators, saddle
    from rigidmultiblobswall_tpu_torch.models import kinematics as kin
    from rigidmultiblobswall_tpu_torch.models.system import make_state
    from rigidmultiblobswall_tpu_torch.ops import cells, forces

    dev = torch.device(DEVICE)
    system = spectral_system(N_SPECTRAL, L_SPECTRAL)
    pos, quat = spectral_lattice(N_SPECTRAL, SPECTRAL_SIDE)
    state = make_state(pos, quat, dtype=torch.float32, device=dev)
    t0 = time.perf_counter()
    system = saddle.auto_spectral_capacities(system, state, log=log)
    r_blobs = kin.blob_positions(system, state)
    system = forces.auto_force_cell_capacity(system, r_blobs, log=log)
    log(f"spectral capacities sized in {time.perf_counter() - t0:.2f} s")
    n = system.num_blobs
    plan = saddle.maybe_dense_mobility(system, r_blobs)
    p = plan.params
    cap = p.cell_capacity
    log(f"spectral plan: grid {p.grid}, r_cut {p.r_cut:.4f}, xi "
        f"{p.xi:.4f}, support {p.support}, Chebyshev terms "
        f"{plan.cheb.shape[2]}, cells {plan.cell_dims} x cap {cap}, "
        f"dropped {int(plan.n_dropped_cells)}")

    # K6 at the path's shape: the first 256 target cells against the plain
    # version in float64; f32 sums of up to 27 cap terms
    g = torch.Generator(device=dev).manual_seed(4)
    sub = (0, 256)
    records = {}
    bound_rel = u32_sqrt(27 * cap)
    for n_rhs in (1, 2):
        f = torch.randn((n, 3 * n_rhs), generator=g, device=dev)
        err, scale, same = k6_vs_plain(ck, plan, f, cells_range=sub)
        ms = cuda_ms(lambda: ck.near_rpy(
            plan.positions, f, plan.cell_table, plan.cell_dims, p.box, cap,
            plan.cheb, two_a=2 * p.a, r_cut=p.r_cut), 10)
        plain_ms = cuda_ms(lambda: ck.near_rpy_plain(
            plan.positions, f, plan.cell_table, plan.cell_dims, p.box, cap,
            plan.cheb, two_a=2 * p.a, r_cut=p.r_cut), 1, warmup=False)
        flops, algo_flops, cand, inside = k6_flops(ck, plan, n_rhs)
        nbytes = 4 * (n * 3 + 2 * n * 3 * n_rhs) + plan.cell_table.numel() * 4
        rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   **bound_record(nbytes, flops))
        algo = bound_record(nbytes, algo_flops)
        log(f"K6 {n} blobs B={n_rhs} f32, first {sub[1]} target cells vs "
            f"plain f64: max err {err:.3e}, / max|ref| = {err / scale:.3e} "
            f"(bound u32*sqrt(27 cap) = {bound_rel:.2e}); repeat "
            f"bit-identical {same}; kernel {ms:.3f} "
            f"ms, plain f32 {plain_ms:.1f} ms; {cand} candidate pairs, "
            f"{inside} inside r_cut; bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']}; the 27-cell algorithm's "
            f"{algo['bound_ms']:.4f} ms)")
        check(err <= bound_rel * scale, f"K6 disagrees at {n} blobs")
        check(same, f"K6 B={n_rhs} not bit-identical on repeat at {n} "
              "blobs")
        if n_rhs == 1:
            records["K6"] = rec

    # K5 at the path's shape
    L = system.periodic_length
    rc = system.blob_blob_cutoff
    dims = forces.neighbor_cell_dims(L, rc, system.blob_blob_grid_dim)
    fcap = system.blob_blob_cell_capacity
    box = torch.as_tensor(L, dtype=r_blobs.dtype, device=dev)
    fpos = (r_blobs - torch.floor(r_blobs / box) * box).contiguous()
    table, _, _, dropped = cells.cell_bin(fpos, box, dims, fcap)
    check(int(dropped) == 0, "force cells overflow")
    kw5 = dict(eps_over_b=0.2 / 0.2, inv_b=1 / 0.2, two_a=2 * A_BENCH)
    err, scale, same = k5_vs_plain(ck, fpos, table, dims, L, fcap, kw5,
                                   cells_range=sub)
    bound5 = u32_sqrt(27 * fcap)
    ms = cuda_ms(lambda: ck.nl_forces(fpos, table, dims, L, fcap, **kw5), 10)
    plain_ms = cuda_ms(lambda: ck.nl_forces_plain(fpos, table, dims, L, fcap,
                                                  **kw5), 1, warmup=False)
    cand, nonself = ck.pair_counts(fpos, table, dims, L, fcap)
    rec5, bound_text = k5_bound(n, table, cand, nonself)
    records["K5"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **rec5)
    log(f"K5 {n} blobs f32 cells {dims} x cap {fcap}, first {sub[1]} target "
        f"cells vs plain f64: max err {err:.3e}, / max|ref| = "
        f"{err / scale:.3e} (bound u32*sqrt(27 cap) = {bound5:.2e}); repeat "
        f"bit-identical {same}; kernel {ms:.3f} ms, plain "
        f"f32 {plain_ms:.1f} ms; {cand} candidate pairs; {bound_text}")
    check(err <= bound5 * scale, f"K5 disagrees at {n} blobs")
    check(same, f"K5 not bit-identical on repeat at {n} blobs")
    del plan

    # the path: one warm-up step and three timed steps; the noise is drawn
    # on the card (a host generator would draw the 3 x 256^3 grid noise
    # on the CPU)
    step = integrators.make_stepper(
        system, "stochastic_Slip_Trapz", 1e-3, lanczos_tolerance=5e-4,
        lanczos_max_iter=32, lanczos_check_every=4, gmres_restart=60,
        gmres_maxiter=300, max_rejections=3)
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pk.LAUNCHES.update(dict.fromkeys(pk.LAUNCHES, 0))
    mc.LAUNCHES = 0
    ck.LAUNCHES.update(dict.fromkeys(ck.LAUNCHES, 0))
    t0 = time.perf_counter()
    carry = integrators.init_carry(system, state=state)
    state, carry, aux = step(state, gen, carry)           # warm-up
    torch.cuda.synchronize()
    log(f"spectral path plan + warm-up step: "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms, gmres "
        f"{aux.det_iterations}, lanczos {aux.stoch_iterations}, rejections "
        f"{aux.rejections}, overflows {aux.capacity_overflows}")
    n_timed = 3
    det, sto, ovf = [], [], [aux.capacity_overflows]
    t0 = time.perf_counter()
    for _ in range(n_timed):
        state, carry, aux = step(state, gen, carry)
        det.append(aux.det_iterations)
        sto.append(aux.stoch_iterations)
        ovf.append(aux.capacity_overflows)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / n_timed * 1e3
    launches = {"K5": ck.LAUNCHES["nl_forces"],
                "K6 B=1": ck.LAUNCHES["near_rpy_b1"],
                "K6 B=2": ck.LAUNCHES["near_rpy_b2"],
                "K1": sum(pk.LAUNCHES.values()), "K2": mc.LAUNCHES}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    p_out = state.pos
    log(f"spectral path {n} blobs ({N_SPECTRAL} shells) stochastic_Slip_"
        f"Trapz f32: {ms:.1f} ms/step over {n_timed} steps; gmres {det}, "
        f"lanczos {sto}, capacity overflows {ovf}, peak device memory "
        f"{peak:.2f} GiB, launches over the 4 steps {launches}")
    check(bool(torch.isfinite(p_out).all()), "spectral positions not finite")
    check(p_out.shape == (N_SPECTRAL, 3), "spectral positions shape")
    check(min(det) > 0 and min(sto) > 0, "no GMRES or Lanczos iterations")
    check(max(ovf) == 0, f"capacity overflows on the spectral path: {ovf}")
    check(launches["K5"] > 0 and launches["K6 B=1"] > 0
          and launches["K6 B=2"] > 0,
          f"K5 or K6 not launched on the spectral path: {launches}")
    records["K5"]["launches"] = launches["K5"]
    records["K6"]["launches"] = launches["K6 B=1"] + launches["K6 B=2"]
    return records


def wall_lattice(n_bodies, side, seed=0):
    """bench.py's spectral_wall lattice: two layers at z = 0.8 and 2.0 of
    spacing 1.6 with in-plane jitter +-0.25, then the quaternions
    (float32, numpy seed)."""
    idx = np.arange(n_bodies)
    pos = np.stack([(idx % side) * 1.6, ((idx // side) % side) * 1.6,
                    0.8 + (idx // (side * side)) * 1.2],
                   axis=1).astype(np.float32)
    rng = np.random.default_rng(seed)
    pos[:, :2] += rng.uniform(-0.25, 0.25,
                              size=(n_bodies, 2)).astype(np.float32)
    quat = rng.normal(size=(n_bodies, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    return pos, quat


def wall_system(n_bodies, L, **overrides):
    """bench.py's spectral_wall configuration: twelve-blob shells above the
    wall in an xy-periodic box on the spectral wall engine, linked-cell
    repulsion in the wall slab."""
    from rigidmultiblobswall_tpu_torch.models.system import BodyType, System

    kw = dict(eta=1.0, blob_radius=A_BENCH, kT=0.05, g=0.1,
              domain="single_wall_spectral", periodic_length=(L, L, 0.0),
              spectral_tol=1e-4, spectral_grid_max=512,
              repulsion_strength=0.2, debye_length=0.2,
              repulsion_strength_wall=0.2, debye_length_wall=0.2,
              blob_blob_force_method="neighbor_list",
              blob_blob_cutoff=2 * A_BENCH + 12 * 0.2,
              blob_blob_grid_dim=32, blob_blob_cell_capacity=96,
              solver_tolerance=2e-4)
    kw.update(overrides)
    t = BodyType(name="shell12", ref_config=shell_vertices(), count=n_bodies)
    return System(types=(t,), **kw)


def phase_wall_parity(ck):
    """Phase 4, wall spectral: 8 shells in a 3.2 x 3.2 slab (4 near-field
    cells a side at tolerance 1e-3; force cutoff 0.8 for 4 force cells) x
    3 Slip-Trapz steps, GPU f64 against CPU f64 at kT = 0.05 (the same
    host-drawn noise), GPU f32 against CPU f64 at kT = 0; K7 (B = 1 and
    2) and K5 run on the card."""
    pos, quat = wall_lattice(8, 2, seed=5)
    pos64, quat64 = pos.astype(np.float64), quat.astype(np.float64)
    out = {}
    ck.LAUNCHES.update(dict.fromkeys(ck.LAUNCHES, 0))
    for kT in (0.05, 0.0):
        for dtype, device, tol in ((torch.float64, "cpu", 1e-12),
                                   (torch.float64, DEVICE, 1e-12),
                                   (torch.float32, DEVICE, 1e-5)):
            if kT > 0 and dtype == torch.float32:
                continue
            system = wall_system(8, 3.2, kT=kT, blob_blob_cutoff=0.8,
                                 spectral_tol=1e-3, spectral_wall_height=3.25,
                                 spectral_cell_capacity=32)
            out[kT, dtype, device] = run_steps(system, pos64, quat64, dtype,
                                               device, 3, tol)
    ref, _ = out[0.05, torch.float64, "cpu"]
    got64, aux = out[0.05, torch.float64, DEVICE]
    ref0, _ = out[0.0, torch.float64, "cpu"]
    got32, _ = out[0.0, torch.float32, DEVICE]
    disp, disp0 = np.abs(ref - pos64).max(), np.abs(ref0 - pos64).max()
    e64 = np.abs(got64 - ref).max() / disp
    e32 = np.abs(got32 - ref0).max() / disp0
    log(f"wall spectral parity, 8 shells x 3 Slip-Trapz steps (max "
        f"displacement {disp:.3e} at kT = 0.05, {disp0:.3e} at kT = 0), max "
        f"error / max displacement: GPU f64 vs CPU f64 {e64:.3e} (bound "
        f"1e-9), GPU f32 vs CPU f64 at kT = 0 {e32:.3e} (bound 1e-2); gmres "
        f"{aux.det_iterations}, lanczos {aux.stoch_iterations}, overflows "
        f"{aux.capacity_overflows}; launches {ck.LAUNCHES}")
    check(disp > 0 and disp0 > 0 and e64 <= 1e-9 and e32 <= 1e-2,
          "wall spectral parity")
    check(min(ck.LAUNCHES[k] for k in ("nl_forces", "wall_near_b1",
                                       "wall_near_b2")) > 0,
          "the wall slice did not run on K7 (B = 1 and 2) and K5")


def phase_wall_cli():
    """Phase 5, wall spectral: the CLI on a generated 8-shell
    single_wall_spectral input (tolerance 1e-3) with tree (linked-cell)
    blob forces (debye length 0.015: 4 force cells of 2a + 30 b), 3 steps
    on the card."""
    pos, quat = wall_lattice(8, 2, seed=0)
    with tempfile.TemporaryDirectory() as d:
        inp = write_spectral_input(d, pos, quat, (
            "n_steps 3\nn_save 3\ndebye_length 0.015\n"
            "periodic_length 3.2 3.2 0\nspectral_tolerance 1e-3\n"),
            domain="single_wall_spectral")
        secs, info = run_spectral_cli(d, inp, 3, 8)
    log(f"wall spectral CLI 8 shells x 3 steps: {secs:.2f} s, .info {info}")


def phase_wall_path(pk, mc, ck):
    """Phase 10: bench.py's spectral_wall step at 8192 shells (98,304
    blobs), float32. Sizes the slab height and capacities as bench.py
    does, builds the host tables (timed), checks K7 (B = 1 and 2) and the
    wall-slab K5 at the path's shapes, then drives the path: one warm-up
    step and three timed steps."""
    from rigidmultiblobswall_tpu_torch.models import integrators, saddle
    from rigidmultiblobswall_tpu_torch.models import kinematics as kin
    from rigidmultiblobswall_tpu_torch.models.system import make_state
    from rigidmultiblobswall_tpu_torch.ops import ewald_wall, forces

    dev = torch.device(DEVICE)
    system = wall_system(N_WALL, L_WALL)
    pos, quat = wall_lattice(N_WALL, WALL_SIDE)
    state = make_state(pos, quat, dtype=torch.float32, device=dev)
    t0 = time.perf_counter()
    system = saddle.auto_spectral_capacities(system, state, log=log)
    r_blobs = kin.blob_positions(system, state)
    system = forces.auto_force_cell_capacity(system, r_blobs, log=log)
    log(f"wall slab height and capacities sized in "
        f"{time.perf_counter() - t0:.2f} s")
    n = system.num_blobs
    t0 = time.perf_counter()
    plan = saddle.maybe_dense_mobility(system, r_blobs)
    p = plan.params
    tables, near = plan.tables, plan.near_tables
    factors = ewald_wall.noise_factors(p, torch.float32, dev)
    torch.cuda.synchronize()
    log(f"wall host tables (Chebyshev, polish kernels, noise factors) and "
        f"device multipliers built in {time.perf_counter() - t0:.2f} s")
    cap = p.cell_capacity
    pz, pk_ = p.noise_orders()
    log(f"wall plan: grid {p.grid}, r_cut {p.r_cut:.4f}, xi {p.xi:.4f}, "
        f"support {p.support}, z_hi {p.z_hi:.4f}, Chebyshev terms "
        f"{near.cheb.shape[2]} (image series {near.img_cheb.shape[2]}), "
        f"cells {plan.cell_dims} x cap {cap}, target layers "
        f"{ewald_wall._kept_layers(p, plan.cell_dims)}, dropped "
        f"{int(plan.n_dropped_cells)}, clipped {int(plan.n_clipped)}; "
        f"{tables.polish_idx.shape[0]} polish columns, noise orders "
        f"({pz}, {pk_}), {factors[0].shape[0]} wave-noise modes")

    # K7 at the path's shape: the first 256 cells against the plain
    # version in float64
    g = torch.Generator(device=dev).manual_seed(4)
    sub = (0, 256)
    records = {}
    bound_rel = 2e-5
    args, kw = ewald_wall.near_args(plan)
    layers = ewald_wall._kept_layers(p, plan.cell_dims)
    for n_rhs in (1, 2):
        f = torch.randn((n, 3 * n_rhs), generator=g, device=dev)
        err, scale = k7_vs_plain(ck, plan, f, cells_range=sub)
        same = torch.equal(*(ck.wall_near(plan.pos_all, f, *args,
                                          cz_range=layers, **kw)
                             for _ in range(2)))
        ms = cuda_ms(lambda: ck.wall_near(plan.pos_all, f, *args,
                                          cz_range=layers, **kw), 10)
        plain_ms = cuda_ms(lambda: ck.wall_near_plain(
            plan.pos_all, f, *args, **kw), 1, warmup=False)
        flops, algo_flops, cand, inside, img = k7_flops(ck, plan, n_rhs)
        nbytes = (4 * (2 * n * 3 + 2 * n * 3 * n_rhs)
                  + plan.cell_table.numel() * 4
                  + 4 * (near.cheb.numel() + near.img_cheb.numel()))
        rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   **bound_record(nbytes, flops))
        algo = bound_record(nbytes, algo_flops)
        log(f"K7 {n} blobs B={n_rhs} f32, first {sub[1]} cells vs plain "
            f"f64: max err {err:.3e}, / max|ref| = {err / scale:.3e} (bound "
            f"{bound_rel:g}); repeat bit-identical {same}; kernel "
            f"{ms:.3f} ms, plain f32 {plain_ms:.1f} "
            f"ms; {cand} candidate pairs of the real targets, {inside} "
            f"inside r_cut, {img} of them with an image source; bound "
            f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}; the 27-cell "
            f"algorithm's {algo['bound_ms']:.4f} ms)")
        check(err <= bound_rel * scale, f"K7 disagrees at {n} blobs")
        check(same, f"K7 B={n_rhs} not bit-identical on repeat at {n} blobs")
        records[f"K7 B={n_rhs}"] = rec
    # and in float64 at the same shape, at 1e-12
    plan64 = ewald_wall.make_wall_plan(p, r_blobs.double())
    for n_rhs in (1, 2):
        f = torch.randn((n, 3 * n_rhs), generator=g, device=dev,
                        dtype=torch.float64)
        err, scale = k7_vs_plain(ck, plan64, f, cells_range=sub)
        log(f"K7 {n} blobs B={n_rhs} f64, first {sub[1]} cells vs plain "
            f"f64: max err / max|ref| = {err / scale:.3e} (bound 1e-12)")
        check(err <= 1e-12 * scale, f"K7 B={n_rhs} f64 disagrees at {n} "
              "blobs")
    del plan64

    # K5 at the path's shape, on the wall slab
    rc = system.blob_blob_cutoff
    fcap = system.blob_blob_cell_capacity
    fpos, dims, box, table, dropped = forces._force_cells(
        r_blobs, system.periodic_length, rc, system.blob_blob_grid_dim, fcap,
        forces.force_z_extent(system))
    check(int(dropped) == 0, "wall-slab force cells overflow")
    kw5 = dict(eps_over_b=0.2 / 0.2, inv_b=1 / 0.2, two_a=2 * A_BENCH)
    err, scale, same = k5_vs_plain(ck, fpos, table, dims, box, fcap, kw5,
                                   cells_range=sub, guard_z=True)
    bound5 = u32_sqrt(27 * fcap)
    ms5 = cuda_ms(lambda: ck.nl_forces(fpos, table, dims, box, fcap,
                                       guard_z=True, **kw5), 10)
    plain5 = cuda_ms(lambda: ck.nl_forces_plain(fpos, table, dims, box, fcap,
                                                **kw5), 1, warmup=False)
    cand, nonself = ck.pair_counts(fpos, table, dims, box, fcap)
    rec5, bound_text = k5_bound(n, table, cand, nonself)
    k5_wall = dict(max_abs_err=err, ms=ms5, plain_ms=plain5, **rec5)
    log(f"K5 wall slab {n} blobs f32 cells {dims} x cap {fcap}, first "
        f"{sub[1]} target cells vs plain f64: max err / max|ref| = "
        f"{err / scale:.3e} (bound u32*sqrt(27 cap) = {bound5:.2e}); repeat "
        f"bit-identical {same}; kernel {ms5:.3f} ms, plain f32 "
        f"{plain5:.1f} ms; {cand} candidate pairs; {bound_text}")
    check(err <= bound5 * scale, f"wall-slab K5 disagrees at {n} blobs")
    check(same, f"wall-slab K5 not bit-identical on repeat at {n} blobs")
    del plan, fpos, table

    # the path: one warm-up step and three timed steps, the noise drawn on
    # the card
    step = integrators.make_stepper(
        system, "stochastic_Slip_Trapz", 1e-3, lanczos_tolerance=5e-4,
        lanczos_max_iter=32, lanczos_check_every=4, gmres_restart=60,
        gmres_maxiter=300, max_rejections=3)
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pk.LAUNCHES.update(dict.fromkeys(pk.LAUNCHES, 0))
    mc.LAUNCHES = 0
    ck.LAUNCHES.update(dict.fromkeys(ck.LAUNCHES, 0))
    t0 = time.perf_counter()
    carry = integrators.init_carry(system, state=state)
    state, carry, aux = step(state, gen, carry)           # warm-up
    torch.cuda.synchronize()
    log(f"wall path plan + warm-up step: "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms, gmres "
        f"{aux.det_iterations}, lanczos {aux.stoch_iterations}, rejections "
        f"{aux.rejections}, overflows {aux.capacity_overflows}")
    n_timed = 3
    det, sto, ovf = [], [], [aux.capacity_overflows]
    drops, clipped = [], []
    t0 = time.perf_counter()
    for _ in range(n_timed):
        state, carry, aux = step(state, gen, carry)
        det.append(aux.det_iterations)
        sto.append(aux.stoch_iterations)
        ovf.append(aux.capacity_overflows)
        drops.append(int(carry.plan.n_dropped_cells))
        clipped.append(int(carry.plan.n_clipped))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / n_timed * 1e3
    launches = {"K7 B=1": ck.LAUNCHES["wall_near_b1"],
                "K7 B=2": ck.LAUNCHES["wall_near_b2"],
                "K5": ck.LAUNCHES["nl_forces"],
                "K6": ck.LAUNCHES["near_rpy_b1"] + ck.LAUNCHES["near_rpy_b2"],
                "K1": sum(pk.LAUNCHES.values()), "K2": mc.LAUNCHES}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    p_out = state.pos
    log(f"wall path {n} blobs ({N_WALL} shells) stochastic_Slip_Trapz f32: "
        f"{ms:.1f} ms/step over {n_timed} steps; gmres {det}, lanczos "
        f"{sto}, near-field cell drops {drops}, clipped {clipped}, capacity "
        f"overflows (drops + clipped + force cells) {ovf}, peak device "
        f"memory {peak:.2f} GiB, launches over the 4 steps {launches}")
    check(bool(torch.isfinite(p_out).all()), "wall positions not finite")
    check(p_out.shape == (N_WALL, 3), "wall positions shape")
    check(float(p_out[:, 2].min()) > 0, "a body crossed the wall")
    check(min(det) > 0 and min(sto) > 0, "no GMRES or Lanczos iterations")
    check(max(ovf) == 0 and max(drops) == 0 and max(clipped) == 0,
          f"drops or clipped blobs on the wall path: {ovf}")
    check(min(launches["K7 B=1"], launches["K7 B=2"], launches["K5"]) > 0,
          f"K7 or K5 not launched on the wall path: {launches}")
    check(launches["K6"] == 0 and launches["K1"] == 0 and launches["K2"] == 0,
          f"another engine's kernel ran on the wall path: {launches}")
    rec = records["K7 B=1"]
    rec["max_abs_err"] = max(rec["max_abs_err"],
                             records["K7 B=2"]["max_abs_err"])
    rec["launches"] = launches["K7 B=1"] + launches["K7 B=2"]
    rec["design"] = "compacted walk (redesigned)"
    k5_wall["launches"] = launches["K5"]
    return rec, k5_wall


# K8's instances: (forces, torques, want_v, want_w) of the call each
# forms, its real-pair operations beyond the series (K8_REAL_PAIR_FLOPS),
# the rot and image series it reads and the generated channels
K8_INSTANCES = {"grand": (True, True, True, True),
                "rt": (True, False, False, True),
                "tr": (False, True, True, False),
                "rr": (False, True, False, True)}
K8_WORK = {"grand": (42, 3, 3, ("rt", "tr", "rr")),
           "rt": (12, 1, 3, ("rt",)),
           "tr": (12, 1, 3, ("tr",)),
           "rr": (18, 2, 2, ("rr",))}


def k8_flops(ck, plan, cheb, inst):
    """Operations of one launch of K8's instance `inst` at this plan's data
    (see K8_REAL_PAIR_FLOPS), counted on the real targets' pairs inside
    r_cut; the 27-cell algorithm also tests every other candidate pair (8
    each). Returns (function operations, algorithm operations, candidate
    pairs, inside pairs, pairs with an image source)."""
    from rigidmultiblobswall_tpu_torch.ops import ewald_wall_rot as ewr

    p = plan.params
    args, _ = ewr.near_args(plan, cheb)
    cand, inside, img = ck.wall_pair_counts(plan.pos_all, *args[:4],
                                            p.r_cut, p.z0)
    K, Ki = args[4].shape[2], args[5].shape[2]
    extra, n_rot, n_img, channels = K8_WORK[inst]
    per_real = K8_REAL_PAIR_FLOPS + 3 * K * n_rot + extra
    per_img = (8 + K7_IMG_PAIR_FLOPS + 3 * Ki * n_img
               + sum(header_flops(f"img_terms_{c}") + 6 for c in channels))
    flops = (inside - img) * per_real + img * per_img
    return flops, flops + 8 * (cand - inside), cand, inside, img


def k8_vs_plain(ck, plan, cheb, inst, g, cells_range=None):
    """K8's instance `inst`, called as its product calls it (want_v,
    want_w), against the plain version in float64 on the cells of
    cells_range (every cell when None), on random strengths: (max abs
    error, max|ref|, the float32 plain version's max abs error against the
    same reference, bit-identical on repeat, the kernel's call). Fails
    unless the call launched `inst` alone and left the half of the rows it
    does not form zero."""
    from rigidmultiblobswall_tpu_torch.ops import ewald_wall as ew
    from rigidmultiblobswall_tpu_torch.ops import ewald_wall_rot as ewr

    dev = plan.pos_all.device
    dtype = plan.pos_all.dtype
    n = plan.n_real
    has_f, has_t, want_v, want_w = K8_INSTANCES[inst]
    f, t = (torch.randn((n, 3), generator=g, device=dev, dtype=dtype)
            if has else None for has in (has_f, has_t))
    args, kw = ewr.near_args(plan, cheb)
    kw.update(want_v=want_v, want_w=want_w)
    layers = ew._kept_layers(plan.params, plan.cell_dims)

    def call():
        return ck.wall_rot_near(plan.pos_all, f, t, *args, cz_range=layers,
                                **kw)

    before = dict(ck.LAUNCHES)
    got = call()
    launched = {k: v - before[k] for k, v in ck.LAUNCHES.items()
                if v != before[k]}
    check(launched == {f"wall_rot_near_{inst}": 1},
          f"K8 ({inst}) launched {launched}")
    same = torch.equal(got, call())
    torch.cuda.synchronize()
    lo, hi = (0 if want_v else 3), (6 if want_w else 3)
    rest = torch.cat([got[:, :lo], got[:, hi:]], dim=1)
    check(bool(got[:, lo:hi].any()) and not bool(rest.any()),
          f"K8 ({inst}) formed the wrong half of the rows")
    dargs = tuple(x.double() if torch.is_tensor(x) and x.is_floating_point()
                  else x for x in args)
    ref = ck.wall_rot_near_plain(
        plan.pos_all.double(), None if f is None else f.double(),
        None if t is None else t.double(), *dargs, cells_range=cells_range,
        **kw)
    rows = _rows_of(plan.cell_table, n, plan.params.cell_capacity,
                    cells_range)
    err = (got.double()[rows] - ref[rows]).abs().max().item()
    err_plain = err
    if dtype == torch.float32:
        plain32 = ck.wall_rot_near_plain(plan.pos_all, f, t, *args,
                                         cells_range=cells_range, **kw)
        err_plain = (plain32.double()[rows] - ref[rows]).abs().max().item()
    return err, ref[rows].abs().max().item(), err_plain, same, call


def periodic_scene(n, box, seed=3):
    """n blobs for periodic K2 checks: each periodic coordinate a random
    fraction below 0.45 of the box plus a random whole box in {-1, 0, 1}
    (so every pair's minimum image is needed, and none lies near half a
    box, where the image chosen by a rounding decides which boxes are
    summed); open axes uniform in [-2, 6); one coincident pair."""
    rng = np.random.default_rng(seed)
    L = np.asarray(box, dtype=np.float64)
    frac = rng.uniform(0.0, 0.45, (n, 3)) + rng.integers(-1, 2, (n, 3))
    r = np.where(L > 0, frac * L, rng.uniform(-2.0, 6.0, (n, 3)))
    if n > 5:
        r[5] = r[4]
    return r


def force_abs_scale(r, rows, *, repulsion_strength, debye_length,
                    blob_radius, periodic_length):
    """max over the rows of sum_j |F_ij| (every image box), float64: the
    scale of a force sum's rounding where its terms cancel (a lattice's
    neighbors nearly balance, so max|F_i| alone understates it). A pair's
    |F| is (eps/b) exp(-max(r - 2a, 0)/b), 0 at r = 0."""
    from rigidmultiblobswall_tpu_torch.ops.pair_kernels import (
        box_offsets, min_image)

    r = r.double()
    L = torch.as_tensor(periodic_length, dtype=r.dtype, device=r.device)
    eob = repulsion_strength / debye_length
    scale = 0.0
    for i0 in range(rows.start, rows.stop, 128):
        d0 = min_image(r[i0:min(i0 + 128, rows.stop), None] - r[None],
                       periodic_length)
        total = torch.zeros(d0.shape[0], dtype=r.dtype, device=r.device)
        for box in box_offsets(periodic_length):
            rn = torch.linalg.norm(d0 + torch.as_tensor(
                box, dtype=r.dtype, device=r.device) * L, dim=-1)
            mag = eob * torch.exp(-torch.clamp(rn - 2 * blob_radius, min=0)
                                  / debye_length)
            total += torch.where(rn > 0, mag, torch.zeros_like(mag)).sum(1)
        scale = max(scale, total.max().item())
    return scale


def phase_rot_kernels(ck, mc):
    """Phase 3, K8 and periodic K2 on small scenes: K8 (each instance:
    grand, rt, tr, rr) on the random 3000-blob wall slab of
    phase_wall_kernels, float32 at 2e-5 x max|ref| (K7's bound on the same
    image series) and float64 at 1e-12 against the plain version in
    float64, twice bit-identical; periodic K2 with 1001 blobs in a small
    box (1.5 x 1.5, Debye length 1: all nine image boxes) and fully
    periodic (27 boxes), on its image boxes' instance, and in a large
    fully periodic box (60^3, Debye length 0.25: the home box alone in
    float32, on its one-box instance without an open axis), float32 at
    max(3e-6, u32 4 max|r| / b) and float64 at 1e-12, twice
    bit-identical."""
    from rigidmultiblobswall_tpu_torch.ops import ewald_wall as ew
    from rigidmultiblobswall_tpu_torch.ops import ewald_wall_rot as ewr

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(12)
    n, L, a, z_hi = 3000, 14.0, 0.3, 3.0
    r = np.empty((n, 3))
    r[:, :2] = rng.uniform(0, L, (n, 2))
    r[:, 2] = rng.uniform(0.3 * a, 1.2 * z_hi, n)
    r[7] = r[6]
    r[9] = r[8] + 0.3 * a
    p = dataclasses.replace(ew.default_wall_params(a, 1.0, (L, L), z_hi,
                                                   tol=1e-4),
                            cell_capacity=96)
    cheb, _ = ewr._host_cheb_rot(p)
    g = torch.Generator(device=dev).manual_seed(8)
    for dtype, bound_rel in ((torch.float32, 2e-5), (torch.float64, 1e-12)):
        plan = ew.make_wall_plan(p, torch.as_tensor(r, dtype=dtype,
                                                    device=dev))
        cheb_d = torch.as_tensor(cheb, dtype=dtype, device=dev)
        check(int(plan.n_dropped_cells) == 0, "K8 scene overflows")
        for inst in K8_INSTANCES:
            err, scale, err32, same, _ = k8_vs_plain(ck, plan, cheb_d, inst,
                                                     g)
            log(f"K8 {n} blobs cells {plan.cell_dims} cap {p.cell_capacity} "
                f"({inst}) {dtype}: max err / max|ref| = {err / scale:.3e} "
                f"(bound {bound_rel:g}; plain version in the same dtype "
                f"{err32 / scale:.3e}); repeat bit-identical {same}")
            check(err <= bound_rel * scale, f"K8 ({inst}) disagrees "
                  f"({err / scale})")
            check(same, f"K8 ({inst}) not bit-identical on repeat")
    for box, b in (((1.5, 1.5, 0.0), 1.0), ((1.6, 1.4, 1.5), 0.8),
                   ((60.0, 60.0, 60.0), 0.25)):
        r = periodic_scene(1001, box)
        kw = dict(repulsion_strength=0.7, debye_length=b, blob_radius=0.3,
                  periodic_length=box)
        for dtype, bound_rel in ((torch.float32, 3e-6),
                                 (torch.float64, 1e-12)):
            rt = torch.as_tensor(r, dtype=dtype, device=dev)
            one_box = mc.ONE_BOX_LAUNCHES
            got = mc.blob_blob_forces(rt, **kw)
            same = torch.equal(got, mc.blob_blob_forces(rt, **kw))
            ref = mc.blob_blob_forces_plain(rt.double(), **kw)
            err = (got.double() - ref).abs().max().item()
            scale = ref.abs().max().item()
            n_boxes = len(mc.image_boxes(box, b, 0.3, dtype))
            instance = ("one-box" if mc.ONE_BOX_LAUNCHES == one_box + 2
                        else "image boxes'")
            if dtype == torch.float32:
                # a float32 displacement rounds at u32 |r|, coordinates up
                # to ~1.45 L: the force moves by that over b (the card
                # tests' bound; 3e-6 holds at coordinates of a few b)
                bound_rel = max(bound_rel, u32_sqrt(1) * 4
                                * float(np.abs(r).max()) / b)
            log(f"K2 periodic 1001 blobs box {box} ({n_boxes} boxes, the "
                f"{instance} instance) {dtype}: max err / max|ref| = "
                f"{err / scale:.3e} (bound {bound_rel:g}); repeat "
                f"bit-identical {same}")
            check((instance == "one-box") == (n_boxes == 1),
                  f"periodic K2 took the {instance} instance with "
                  f"{n_boxes} boxes")
            check(err <= bound_rel * scale, f"periodic K2 disagrees in box "
                  f"{box} ({err / scale})")
            check(same, "periodic K2 not bit-identical on repeat")


def phase_wall_roller_parity():
    """Phase 4, rollers on the wall-spectral engine: 16 rollers in a 14 x
    14 box (tests/test_torch_rollers.py's scene, tolerance 1e-3) x 3 steps
    of stochastic_adams_bashforth_rollers, GPU f64 against CPU f64 at
    kT = 2e-3 (the same host-drawn noise) and GPU f32 against CPU f64 at
    kT = 0; K8 and periodic K2 run on the card."""
    from rigidmultiblobswall_tpu_torch.ops import cell_kernels as ck
    from rigidmultiblobswall_tpu_torch.ops import mobility_cuda as mc

    n, L = 16, 14.0
    rng = np.random.default_rng(11)
    r0 = np.stack([rng.uniform(0, L, n), rng.uniform(0, L, n),
                   rng.uniform(0.55, 1.2, n)], axis=1)
    common = dict(eta=0.9, blob_radius=0.5, g=0.05, repulsion_strength=0.1,
                  debye_length=0.2, repulsion_strength_wall=0.1,
                  debye_length_wall=0.2, omega_one_roller=(0.0, 4.0, 0.0),
                  lanczos_max_iter=12, periodic_length=(L, L, 0.0),
                  spectral_tol=1e-3, spectral_wall_height=1.4,
                  spectral_cell_capacity=0)
    scheme = "stochastic_adams_bashforth_rollers"
    ck.LAUNCHES.update(dict.fromkeys(ck.LAUNCHES, 0))
    mc.PERIODIC_LAUNCHES = 0
    sus64 = wall_roller_suspension(n, kT=2e-3, solver_tolerance=1e-12,
                                   **common)
    ref, _ = run_roller_steps(sus64, r0, scheme, torch.float64, "cpu")
    got64, aux = run_roller_steps(sus64, r0, scheme, torch.float64, DEVICE)
    sus0 = wall_roller_suspension(n, kT=0.0, solver_tolerance=1e-12,
                                  **common)
    ref0, _ = run_roller_steps(sus0, r0, scheme, torch.float64, "cpu")
    got32, _ = run_roller_steps(
        wall_roller_suspension(n, kT=0.0, solver_tolerance=1e-5, **common),
        r0, scheme, torch.float32, DEVICE)
    disp, disp0 = np.abs(ref - r0).max(), np.abs(ref0 - r0).max()
    e64 = np.abs(got64 - ref).max() / disp
    e32 = np.abs(got32 - ref0).max() / disp0
    launches = {k: ck.LAUNCHES[k] for k in ("wall_near_b1", *(
        f"wall_rot_near_{inst}" for inst in K8_INSTANCES))}
    launches["K2 periodic"] = mc.PERIODIC_LAUNCHES
    log(f"wall-spectral rollers parity, 16 rollers x 3 steps of {scheme} "
        f"(max displacement {disp:.3e} at kT = 2e-3, {disp0:.3e} at kT = "
        f"0), max error / max displacement: GPU f64 vs CPU f64 {e64:.3e} "
        f"(bound 1e-9), GPU f32 vs CPU f64 at kT = 0 {e32:.3e} (bound "
        f"1e-2); gmres {aux.det_iterations}, lanczos {aux.stoch_iterations};"
        f" launches {launches}")
    check(disp > 0 and disp0 > 0 and e64 <= 1e-9 and e32 <= 1e-2,
          "wall-spectral rollers parity")
    check(min(launches.values()) > 0, "the wall-spectral rollers slice did "
          f"not run on K7 (B = 1), K8 (every instance) and periodic K2: "
          f"{launches}")


def phase_wall_rollers_path(pk, mc, ck):
    """Phase 11: bench.py's rollers step on the wall-spectral engine at
    32,768 rollers, float32. Builds the plan and the host and device
    tables (timed), checks K8 (each instance) and periodic K2 at the path's
    shapes, then drives the path through make_stepper: one warm-up step
    and three timed steps. Returns the kernel records."""
    from rigidmultiblobswall_tpu_torch.models import rollers
    from rigidmultiblobswall_tpu_torch.ops import ewald_wall_rot as ewr

    dev = torch.device(DEVICE)
    sus = wall_roller_suspension(N_ROLLERS)
    r = torch.as_tensor(roller_lattice(N_ROLLERS), device=dev)
    n = N_ROLLERS
    t0 = time.perf_counter()
    carry = rollers.init_carry(sus, positions=r)
    plan, tables = carry.plan, carry.rot_tables
    torch.cuda.synchronize()
    t_rot = time.perf_counter() - t0
    t0 = time.perf_counter()
    tt_tables = plan.tables
    torch.cuda.synchronize()
    t_tt = time.perf_counter() - t0
    p = plan.params
    log(f"wall rollers plan: grid {p.grid}, r_cut {p.r_cut:.4f} "
        f"({p.r_cut / p.a:.1f} a), xi {p.xi:.4f}, support {p.support}, cells "
        f"{plan.cell_dims} x cap {p.cell_capacity}, dropped "
        f"{int(plan.n_dropped_cells)}, clipped {int(plan.n_clipped)}; rot "
        f"remainder terms {tables.cheb.shape[2]}, image series "
        f"{plan.near_tables.img_cheb.shape[2]}, "
        f"{tt_tables.polish_idx.shape[0]} polish columns; image multiplier "
        f"columns rt {len(tables.mult_rt)}, tr {len(tables.mult_tr)}, rr "
        f"{len(tables.mult_rr)}; rot tables {tables.nbytes() / 2 ** 30:.2f} "
        f"GiB on the device; plan + rot tables built in {t_rot:.2f} s "
        f"(host Chebyshev fit and polish kernels included), tt tables in "
        f"{t_tt:.2f} s")
    check(int(plan.n_dropped_cells) == 0, "wall rollers plan drops points "
          f"at the automatic cell capacity {p.cell_capacity}")

    # K8 at the path's plan: the cells of the first 256 xy columns (the
    # reals and images share the lowest z layer) against the plain version
    # in float64, each instance as its product calls it
    g = torch.Generator(device=dev).manual_seed(5)
    sub = (0, 256 * plan.cell_dims[2])
    records = {}
    bound_rel = 2e-5
    nbytes0 = (4 * 2 * n * 3 + 4 * n * 6 + plan.cell_table.numel() * 4
               + 4 * (tables.cheb.numel() + plan.near_tables.img_cheb.numel()))
    for inst, (has_f, has_t, want_v, want_w) in K8_INSTANCES.items():
        err, scale, err32, same, call = k8_vs_plain(ck, plan, tables.cheb,
                                                    inst, g,
                                                    cells_range=sub)
        ms = cuda_ms(call, 10)
        f_, t_ = (torch.randn((n, 3), generator=g, device=dev)
                  if has else None for has in (has_f, has_t))
        args, kw = ewr.near_args(plan, tables.cheb)
        plain_ms = cuda_ms(lambda: ck.wall_rot_near_plain(
            plan.pos_all, f_, t_, *args, want_v=want_v, want_w=want_w,
            **kw), 1, warmup=False)
        flops, algo_flops, cand, inside, img = k8_flops(ck, plan,
                                                        tables.cheb, inst)
        # positions, the strengths read, the table and tables in; the
        # half of the rows formed out
        nbytes = (nbytes0 - 4 * n * 3 * (2 - want_v - want_w)
                  + 4 * n * 3 * (has_f + has_t))
        rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   **bound_record(nbytes, flops))
        algo = bound_record(nbytes, algo_flops)
        log(f"K8 ({inst}) {n} rollers f32, first {sub[1]} cells vs plain "
            f"f64: max err {err:.3e}, / max|ref| = {err / scale:.3e} (bound "
            f"{bound_rel:g}; plain f32 {err32 / scale:.3e}); repeat "
            f"bit-identical {same}; kernel {ms:.3f} ms, plain f32 "
            f"{plain_ms:.1f} ms; {cand} candidate pairs of the real targets, "
            f"{inside} inside r_cut, {img} of them with an image source; "
            f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}, "
            f"{rec['bound_ms'] / ms:.1%} of it; the 27-cell algorithm's "
            f"{algo['bound_ms']:.4f} ms)")
        check(err <= bound_rel * scale, f"K8 ({inst}) disagrees at {n} "
              "rollers")
        check(same, f"K8 ({inst}) not bit-identical on repeat at {n} "
              "rollers")
        records[f"K8 {inst}"] = rec

    # periodic K2 at the path's shape: the first 1024 rows against the
    # plain version in float64 (every image box; the kernel sums those of
    # image_boxes, here the home box alone: its one-box instance)
    kw2 = dict(repulsion_strength=sus.repulsion_strength,
               debye_length=sus.debye_length, blob_radius=sus.blob_radius,
               periodic_length=sus.periodic_length)
    one_box = mc.ONE_BOX_LAUNCHES
    got = mc.blob_blob_forces(r, **kw2)
    same = torch.equal(got, mc.blob_blob_forces(r, **kw2))
    check(mc.ONE_BOX_LAUNCHES == one_box + 2, "periodic K2 did not take its "
          "one-box instance at the wall rollers' shape")
    rows = range(0, 1024)
    ref = mc.blob_blob_forces_plain(r.double(), rows=rows, **kw2)[:1024]
    err = (got[:1024].double() - ref).abs().max().item()
    # the lattice's neighbor forces nearly cancel: the rounding scale is
    # the sum of the pair forces' sizes, not max|F|; and a pair across the
    # periodic edge takes its float32 displacement from coordinates and a
    # box near L: its rounding, ~u32 2 L, moves the force by that over b
    scale = force_abs_scale(r, rows, **kw2)
    rel = err / scale
    ref32 = mc.blob_blob_forces_plain(r, rows=rows, **kw2)[:1024]
    rel32 = (ref32.double() - ref).abs().max().item() / scale
    bound_k2 = float(np.finfo(np.float32).eps / 2) * 4 * max(
        sus.periodic_length) / sus.debye_length
    ms = cuda_ms(lambda: mc.blob_blob_forces(r, **kw2), 10)
    plain_ms = cuda_ms(lambda: mc.blob_blob_forces_plain(r, **kw2), 1,
                       warmup=False)
    n_boxes = len(mc.image_boxes(sus.periodic_length, sus.debye_length,
                                 sus.blob_radius, torch.float32))
    pairs = n * (n - 1) // 2 * n_boxes
    n_axes = sum(float(L) > 0 for L in sus.periodic_length)
    rec = bound_record(4 * 3 * n * 2,
                       pairs * (FORCE_PAIR_FLOPS + FORCE_APPLY_FLOPS)
                       + n * (n - 1) // 2 * K2_MIN_IMAGE_FLOPS * n_axes,
                       pairs * FORCE_PAIR_MUFU)
    log(f"K2 periodic {n} rollers f32 box {sus.periodic_length} ({n_boxes} "
        f"of {len(pk.box_offsets(sus.periodic_length))} image boxes summed: "
        f"the one-box instance), "
        f"first 1024 rows vs plain f64 (every box): max err {err:.3e}, / "
        f"max_i sum_j |F_ij| = {rel:.3e} (bound u32 4 L / b = "
        f"{bound_k2:.2e}; the plain version in f32 {rel32:.3e}; / max|ref| "
        f"{err / ref.abs().max().item():.3e}); repeat bit-identical "
        f"{same}; kernel {ms:.3f} ms, plain f32 {plain_ms:.1f} ms; bound "
        f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}, "
        f"{rec['bound_ms'] / ms:.1%} of it)")
    check(rel <= bound_k2, f"periodic K2 disagrees at {n} rollers")
    check(same, f"periodic K2 not bit-identical on repeat at {n} rollers")
    records["K2 periodic"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                  **rec)

    # the path: one warm-up step and three timed steps
    step = rollers.make_stepper(sus, "stochastic_adams_bashforth_rollers",
                                1e-3, max_rejections=3)
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pk.LAUNCHES.update(dict.fromkeys(pk.LAUNCHES, 0))
    ck.LAUNCHES.update(dict.fromkeys(ck.LAUNCHES, 0))
    mc.LAUNCHES = 0
    mc.PERIODIC_LAUNCHES = 0
    mc.ONE_BOX_LAUNCHES = 0
    t0 = time.perf_counter()
    r, carry, aux = step(r, gen, carry)               # warm-up
    torch.cuda.synchronize()
    log(f"wall rollers path warm-up step: "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms, gmres "
        f"{aux.det_iterations}, lanczos {aux.stoch_iterations}, rejections "
        f"{aux.rejections}, wall overlaps {aux.wall_overlaps}")
    n_timed = 3
    det, sto, rej, ovl = [aux.det_iterations], [aux.stoch_iterations], \
        [aux.rejections], [aux.wall_overlaps]
    drops = [aux.plan_drops]
    t0 = time.perf_counter()
    for _ in range(n_timed):
        r, carry, aux = step(r, gen, carry)
        det.append(aux.det_iterations)
        sto.append(aux.stoch_iterations)
        rej.append(aux.rejections)
        ovl.append(aux.wall_overlaps)
        drops.append(aux.plan_drops)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / n_timed * 1e3
    drops.append(int(carry.plan.n_dropped_cells))     # at the last positions
    launches = {f"K8 {inst}": ck.LAUNCHES[f"wall_rot_near_{inst}"]
                for inst in K8_INSTANCES}
    launches["K7"] = ck.LAUNCHES["wall_near_b1"] + ck.LAUNCHES["wall_near_b2"]
    launches["K2 periodic"] = mc.PERIODIC_LAUNCHES
    others = {"K1": sum(pk.LAUNCHES.values()), "K2": mc.LAUNCHES,
              "K5": ck.LAUNCHES["nl_forces"],
              "K6": ck.LAUNCHES["near_rpy_b1"] + ck.LAUNCHES["near_rpy_b2"]}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"wall rollers path {n} rollers stochastic_adams_bashforth_rollers "
        f"f32: {ms:.1f} ms/step over {n_timed} steps (after a warm-up); "
        f"gmres sweeps {det}, lanczos {sto}, rejections {rej}, wall "
        f"overlaps {ovl}, plan drops {drops} (RollerAux.plan_drops from "
        f"the warm-up on, then the final plan's), peak device "
        f"memory {peak:.2f} GiB, launches over the 4 steps {launches}, "
        f"other engines' kernels {others}")
    check(bool(torch.isfinite(r).all()), "wall roller positions not finite")
    check(r.shape == (n, 3), "wall roller positions shape")
    check(min(det) > 0 and min(sto) > 0 and max(sto) <= sus.lanczos_max_iter,
          "GMRES or Lanczos iterations out of range")
    check(max(drops) == 0, f"plan drops on the wall rollers path: {drops}")
    check(all(v > 0 for v in launches.values()),
          f"a kernel was not launched on the wall rollers path: {launches}")
    check(all(v == 0 for v in others.values()),
          f"another engine's kernel ran on the wall rollers path: {others}")
    check(mc.ONE_BOX_LAUNCHES == mc.PERIODIC_LAUNCHES,
          f"periodic K2 left its one-box instance on the wall rollers path "
          f"({mc.ONE_BOX_LAUNCHES} of {mc.PERIODIC_LAUNCHES})")
    for inst in K8_INSTANCES:
        records[f"K8 {inst}"]["launches"] = launches[f"K8 {inst}"]
    records["K2 periodic"]["launches"] = launches["K2 periodic"]
    return records


def phase_lub_path(pk, mc, ck):
    """Phase 12: bench.py's lubrication step (BASELINE config 5) at 4096
    spheres, float32: one Delta_R assembly timed by CUDA events, then one
    warm-up step and three timed steps of step_trapezoidal with omega 25
    and cut_torque 0.2 through the library entry points. Fails on a
    neighbor overflow, non-finite positions or a step without GMRES
    iterations (bench.py's _INVALID conditions), or when K1 grand or K2
    did not run or another engine's kernel did. Returns the launches."""
    from rigidmultiblobswall_tpu_torch.models import lubrication as lub

    dev = torch.device(DEVICE)
    sol = lub_solver(N_LUB, dev)
    ft_calc = lub_ft_calc()
    p = torch.as_tensor(lub_lattice(N_LUB), device=dev)
    qt = torch.tensor([[1.0, 0.0, 0.0, 0.0]] * N_LUB, dtype=torch.float32,
                      device=dev)
    blocks = lub.compute_blocks(sol, p)
    overflow0 = int(blocks.overflow)
    n_pairs = int(blocks.mask.sum())
    del blocks
    assembly_ms = cuda_ms(lambda: lub.compute_blocks(sol, p), 3)
    log(f"lubrication Delta_R assembly at {N_LUB} spheres (neighbor list, "
        f"K = {sol.max_neighbors}): {assembly_ms:.3f} ms between CUDA events "
        f"(the host's launch gaps included), "
        f"{n_pairs} directed pairs inside the cutoff, overflow {overflow0}")

    def step(p, qt, gen):
        return lub.step_trapezoidal(sol, p, qt, gen, ft_calc, omega=25.0,
                                    cut_torque=0.2)

    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the earlier phases' cached device tables stay allocated
    base = torch.cuda.memory_allocated()
    pk.LAUNCHES.update(dict.fromkeys(pk.LAUNCHES, 0))
    ck.LAUNCHES.update(dict.fromkeys(ck.LAUNCHES, 0))
    mc.LAUNCHES = 0
    mc.PERIODIC_LAUNCHES = 0
    reset_dense(mc)
    t0 = time.perf_counter()
    p, qt, aux = step(p, qt, gen)                     # warm-up
    torch.cuda.synchronize()
    log(f"lubrication path warm-up step: "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms, gmres "
        f"{aux.det_iterations}, lanczos {aux.stoch_iterations}")
    auxes = [aux]
    n_timed = 3
    t0 = time.perf_counter()
    for _ in range(n_timed):
        p, qt, aux = step(p, qt, gen)
        auxes.append(aux)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / n_timed * 1e3
    det = [a.det_iterations for a in auxes]
    sto = [a.stoch_iterations for a in auxes]
    rej = [int(a.rejections_wall) + int(a.rejections_jump) for a in auxes]
    ovf = [int(a.neighbor_overflow) for a in auxes]
    launches = {"K1 grand": pk.launches("grand"), "K2": mc.LAUNCHES}
    others = {"K1 other couplings": sum(
        n for (c, _), n in pk.LAUNCHES.items() if c != "grand"),
        "K2 periodic": mc.PERIODIC_LAUNCHES,
        "K3/K4": sum(dense_launches(mc).values()),
        "K5-K8": sum(ck.LAUNCHES.values())}
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    log(f"lubrication path {N_LUB} spheres step_trapezoidal (omega 25, "
        f"cut_torque 0.2) f32: {ms:.1f} ms/step over {n_timed} steps "
        f"(after a warm-up); gmres {det}, lanczos {sto}, rejections {rej}, "
        f"neighbor overflow {ovf} (warm-up first), peak device memory "
        f"{peak:.2f} GiB above the {base / 2 ** 30:.2f} GiB held at the "
        f"phase's start, launches over the 4 steps {launches}, other "
        f"engines' kernels {others}")
    check(bool(torch.isfinite(p).all()), "lubrication positions not finite")
    check(p.shape == (N_LUB, 3), "lubrication positions shape")
    check(min(det) > 0, "a lubrication step ran no GMRES iterations")
    check(overflow0 == 0 and max(ovf) == 0,
          f"neighbor overflow on the lubrication path: {ovf}")
    check(all(v > 0 for v in launches.values()),
          f"a kernel was not launched on the lubrication path: {launches}")
    check(all(v == 0 for v in others.values()),
          f"another engine's kernel ran on the lubrication path: {others}")
    return launches


def _nan_lower_tiles(m, tile):
    """Overwrite the strictly-lower (3 tile)-edge tiles of m with NaN."""
    t = 3 * tile
    for i0 in range(t, m.shape[0], t):
        m[i0:i0 + t, :i0] = float("nan")


def _chunked_err(got, ref_fn, n_rows, chunk=3072):
    """max |got - ref| over row chunks (ref_fn(r0, r1) gives the float64
    reference rows) and max |ref|, without a full float64 copy."""
    err = scale = 0.0
    for r0 in range(0, n_rows, chunk):
        r1 = min(r0 + chunk, n_rows)
        ref = ref_fn(r0, r1)
        err = max(err, (got[r0:r1].double() - ref).abs().max().item())
        scale = max(scale, ref.abs().max().item())
    return err, scale


def phase_dense_kernels_small(mc):
    """Phase 3, K3 and K4 at small N: 40 blobs (below one K4 tile and one
    K3 block edge), 100 and 260 (off every tile edge), with blobs below a
    and a coincident pair, wall and open, float32 at 3e-6 x max|ref| and
    float64 at 1e-12 against the plain versions in float64; K4 with B = 1
    and 2 twice on the same input bit-identical, and unchanged with its
    strictly-lower tiles overwritten by NaN."""
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(8)
    for n in (40, 100, 260):
        r = np.empty((n, 3))
        r[:, :2] = rng.uniform(0, 5, (n, 2))
        r[:, 2] = rng.uniform(0.05, 4, n)
        r[9] = r[8]
        v = rng.normal(size=(n, 3))
        v2 = rng.normal(size=(2, n, 3))
        for dtype, bound in ((torch.float32, 3e-6), (torch.float64, 1e-12)):
            rt = torch.as_tensor(r, dtype=dtype, device=dev)
            vt = torch.as_tensor(v, dtype=dtype, device=dev)
            v2t = torch.as_tensor(v2, dtype=dtype, device=dev)
            for wall in (True, False):
                mode = mc.pair_kernels.wall_mode(wall)
                m = mc.dense_tt(rt, 1.0, 0.3, mode=mode)
                torch.cuda.synchronize()
                ref = mc.dense_tt_plain(rt.double(), 1.0, 0.3, mode=mode)
                e3 = ((m.double() - ref).abs().max() / ref.abs().max()).item()
                u = mc.symm_matvec(m, vt)
                torch.cuda.synchronize()
                uref = mc.symm_matvec_plain(m.double(), vt.double())
                e4 = ((u.double() - uref).abs().max()
                      / uref.abs().max()).item()
                u2 = mc.symm_matvec(m, v2t)            # B = 2
                torch.cuda.synchronize()
                uref2 = mc.symm_matvec_plain(m.double(), v2t.double())
                e42 = ((u2.double() - uref2).abs().max()
                       / uref2.abs().max()).item()
                same = (torch.equal(mc.symm_matvec(m, vt), u)
                        and torch.equal(mc.symm_matvec(m, v2t), u2))
                _nan_lower_tiles(m, mc.SYMM_TILE)
                blind = (torch.equal(mc.symm_matvec(m, vt), u)
                         and torch.equal(mc.symm_matvec(m, v2t), u2))
                log(f"K3/K4 {n} blobs wall={wall} {dtype}: max err / "
                    f"max|ref| K3 {e3:.3e}, K4 {e4:.3e}, K4 B=2 {e42:.3e} "
                    f"(bound {bound:g}); K4 repeat bit-identical {same}, NaN "
                    f"lower tiles unchanged {blind}")
                check(e3 <= bound and e4 <= bound and e42 <= bound,
                      f"K3/K4 disagree with plain ({e3:.3e}, {e4:.3e}, "
                      f"{e42:.3e})")
                check(same and blind, "K4 not deterministic or read a "
                      "strictly-lower tile")


# the image policies phase 3 holds K1's and K3's image instances to
# (ops/pair_kernels.py plane_far): (wall, box in units of a, whether the
# in-plane far policy takes it)
IMAGE_POLICIES = {"in-plane above the wall": (True, (23.0, 19.0, 0.0), True),
                  "in-plane at its margin": (True, (4.05, 4.2, 0.0), True),
                  "in-plane, no wall": (False, (23.0, 19.0, 0.0), True),
                  "general, L/a = 3": (True, (3.0, 3.0, 0.0), False),
                  "general, periodic in z": (False, (23.0, 19.0, 21.0),
                                             False)}
# the couplings held under every policy: the diagonal ones (box sums) and
# the cross and grand ones (per-box applies)
IMAGE_COUPLINGS = (("tt", 1), ("tt", 2), ("rr", 1), ("rr", 2), ("tr", 1),
                   ("tr", 2), ("rt", 1), ("grand", 1))


def image_scene(n, L, a=0.3, seed=12):
    """n blobs over 40 a in x and y with heights to 4 (some below a), a
    coincident pair and pairs at the half-box tie on x and on y (in
    units of a): (r, q) with q the shifted heights in units of a."""
    rng = np.random.default_rng(seed)
    r = np.empty((n, 3))
    r[:, :2] = rng.uniform(0, 12, (n, 2))
    r[:, 2] = rng.uniform(0.05, 4, n)
    r[5] = r[4]
    if L[0] > 0:
        r[1, 0] = r[0, 0] + 0.5 * L[0] * a
        r[2, 1] = r[0, 1] - 0.5 * L[1] * a
    q = r.copy()
    q[:, 2] = np.maximum(q[:, 2], a)
    return r, q / a


def phase_image_kernels_small(pk, mc):
    """Phase 3, K1's and K3's image instances at 300 blobs under each
    policy of IMAGE_POLICIES (the in-plane far one, PlaneBoxes, and the
    general one, ImageBoxes): K1 tt, rr and tr with B = 1 and 2, rt and
    grand under every policy, on the symmetric sweep and the sliced
    sweep; K3 with images and open. float32 against the plain version in
    float64 within 3e-6 x max|ref| (float64 K1 at 1e-12), twice
    bit-identical; K3's lower triangle the exact transpose of its
    upper."""
    dev = torch.device(DEVICE)
    n = 300
    worst = 0.0
    for policy, (wall, L, plane) in IMAGE_POLICIES.items():
        boxes = (L, pk.box_offsets(L))
        check(pk.plane_far(boxes) == plane, f"plane_far({L})")
        r, q = image_scene(n, L)
        q = q if wall else r / 0.3
        errs = []
        for coupling, n_rhs in IMAGE_COUPLINGS:
            v = np.random.default_rng(13).normal(
                size=(n, pk.NCOMP[coupling] * n_rhs))
            kw = dict(coupling=coupling, mode=pk.wall_mode(wall),
                      self_interaction=True,
                      boxes=boxes)
            for dtype, bound in ((torch.float32, 3e-6),
                                 (torch.float64, 1e-12)):
                qt = torch.as_tensor(q, dtype=dtype, device=dev)
                vt = torch.as_tensor(v, dtype=dtype, device=dev)
                ref = pk.pair_plain(qt.double(), qt.double(), vt.double(),
                                    **kw)
                for q_tgt in (None, qt):
                    got = pk.pair_matvec(qt, q_tgt, vt, **kw)
                    same = torch.equal(got, pk.pair_matvec(qt, q_tgt, vt,
                                                           **kw))
                    torch.cuda.synchronize()
                    rel = ((got.double() - ref).abs().max()
                           / ref.abs().max()).item()
                    sweep = "sym" if q_tgt is None else "sliced"
                    errs.append(f"{coupling} B={n_rhs} {sweep}"
                                f"{'' if dtype == torch.float32 else ' f64'}"
                                f" {rel:.2e}")
                    check(rel <= bound and same, f"K1 {coupling} images "
                          f"B={n_rhs} {sweep} {dtype} under {policy}: "
                          f"{rel:.3e}, repeat bit-identical {same}")
                    if dtype == torch.float32:
                        worst = max(worst, rel)
        rt = torch.as_tensor(r, dtype=torch.float32, device=dev)
        box = tuple(x * 0.3 for x in L)
        m = mc.dense_tt(rt, 0.8, 0.3, mode=pk.wall_mode(wall),
                        periodic_length=box)
        same = torch.equal(m, mc.dense_tt(rt, 0.8, 0.3,
                                          mode=pk.wall_mode(wall),
                                          periodic_length=box))
        transposed = torch.equal(m, m.T)
        ref = mc.dense_tt_plain(rt.double(), 0.8, 0.3,
                                mode=pk.wall_mode(wall),
                                periodic_length=box)
        e3 = ((m.double() - ref).abs().max() / ref.abs().max()).item()
        geom = "PlaneBoxes" if plane else "ImageBoxes"
        log(f"K1/K3 images {n} blobs, {policy} {L} ({geom}), "
            f"f32 unless marked, vs plain f64 / max|ref|: K1 "
            f"{', '.join(errs)}; K3 {e3:.2e}, its lower triangle the exact "
            f"transpose {transposed}, repeat bit-identical {same}")
        check(e3 <= 3e-6 and transposed and same, f"K3 images under "
              f"{policy}: {e3:.3e}, transpose {transposed}, repeat {same}")
        worst = max(worst, e3)
    for wall in (True, False):
        r, _ = image_scene(n, (0.0, 0.0, 0.0))
        rt = torch.as_tensor(r, dtype=torch.float32, device=dev)
        m = mc.dense_tt(rt, 0.8, 0.3, mode=pk.wall_mode(wall))
        check(torch.equal(m, m.T), f"open K3 wall={wall}: not its exact "
              "transpose")
    log(f"K1/K3 image instances at {n} blobs: worst float32 error "
        f"{worst:.3e} of max|ref| (bound 3e-6); open K3 its exact "
        "transpose")


def exact_transpose(m, chunk=3072):
    """Whether the (3N, 3N) matrix m equals its transpose bit for bit,
    compared by row blocks (no copy of the matrix)."""
    for r0 in range(0, m.shape[0], chunk):
        r1 = min(r0 + chunk, m.shape[0])
        if not torch.equal(m[r0:r1], m[:, r0:r1].T):
            return False
    return True


def phase_dense_kernels(pk, mc, mob, kin, make_state):
    """Phase 3 at the materialized path's shape: 12,288 blobs of the
    1024-shell lattice, float32. K3 against its plain version in float64,
    K4 with B = 1 and B = 2 against the float64 product of the same
    float32 matrix, both twice bit-identical and blind to NaN lower tiles
    (3e-6 x max|ref|); the times of K3, K4, the
    plain versions, torch.mv (K4's library call), K4 with B = 2 beside
    torch.matmul on the same pair, and K1 tt at the same shape. Returns
    the kernel records."""
    dev = torch.device(DEVICE)
    system = bench_system(N_DENSE)
    pos, quat = lattice(N_DENSE)
    state = make_state(pos, quat, dtype=torch.float32, device=dev)
    r = kin.blob_positions(system, state).contiguous()
    n = r.shape[0]
    n3 = 3 * n
    eta, a = system.eta, A_BENCH
    records = {}
    m = mc.dense_tt(r, eta, a, mode="wall")
    torch.cuda.synchronize()
    ref = mc.dense_tt_plain(r.double(), eta, a, mode="wall")
    err, scale = _chunked_err(m, lambda r0, r1: ref[r0:r1], n3)
    del ref
    transposed = exact_transpose(m)
    ms = cuda_ms(lambda: mc.dense_tt(r, eta, a, mode="wall"), 5)
    plain_ms = cuda_ms(lambda: mc.dense_tt_plain(r, eta, a, mode="wall"), 1,
                       warmup=False)
    # the matrix is symmetric: the function needs each unordered pair's
    # block once (the bytes term writes the whole matrix)
    records["K3"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         **bound_record(4 * (n3 * n3 + n3),
                                        n * (n + 1) // 2 * K3_PAIR_FLOPS))
    log(f"K3 {n} blobs f32 vs plain f64: max err {err:.3e}, / max|ref| = "
        f"{err / scale:.3e} (bound 3e-6); lower triangle the exact "
        f"transpose {transposed}; kernel {ms:.3f} ms, plain f32 "
        f"{plain_ms:.1f} ms, bound {records['K3']['bound_ms']:.3f} ms "
        f"({records['K3']['bound_by']}, "
        f"{records['K3']['bound_ms'] / ms:.1%} of it); matrix "
        f"{m.numel() * 4 / 2**30:.2f} GiB")
    check(err <= 3e-6 * scale, f"K3 disagrees at {n} blobs")
    check(transposed, f"K3 at {n} blobs: not its exact transpose")

    g = torch.Generator(device=dev).manual_seed(6)
    v = torch.randn((n, 3), generator=g, device=dev)
    u = mc.symm_matvec(m, v)
    torch.cuda.synchronize()
    vd = v.double().reshape(-1)
    err, scale = _chunked_err(u.reshape(-1, 1),
                              lambda r0, r1: (m[r0:r1].double() @ vd)[:, None],
                              n3)
    # B = 2, the lockstep sweeps' instance, against the float64 product of
    # the same float32 matrix with both columns
    V2 = torch.randn((2, n, 3), generator=g, device=dev)
    u2 = mc.symm_matvec(m, V2)
    torch.cuda.synchronize()
    V2d = V2.double().reshape(2, n3).T
    err2, scale2 = _chunked_err(u2.reshape(2, n3).T,
                                lambda r0, r1: m[r0:r1].double() @ V2d, n3)
    ms = cuda_ms(lambda: mc.symm_matvec(m, v), 20)
    plain_ms = cuda_ms(lambda: mc.symm_matvec_plain(m, v), 20)
    lib_ms = cuda_ms(lambda: torch.mv(m, v.reshape(-1)), 20)
    k4b2_ms = cuda_ms(lambda: mc.symm_matvec(m, V2), 20)
    V2t = V2.reshape(2, n3).T
    mm_ms = cuda_ms(lambda: torch.matmul(m, V2t), 20)
    q = (mob.shift_heights(r, a) / a).contiguous()
    records["tt_12k"] = k1_full_record(pk, "tt", q, v, 1024, u32_sqrt(n),
                                       f"{n} blobs")
    upper = n3 * (n3 + 1) // 2
    # max_abs_err is the larger of the B = 1 and B = 2 instances' errors
    rec = dict(max_abs_err=max(err, err2), ms=ms, plain_ms=plain_ms,
               **bound_record(4 * (upper + 2 * n3), 4 * upper))
    rec["library_ms"] = lib_ms
    records["K4"] = rec
    same = (torch.equal(mc.symm_matvec(m, v), u)
            and torch.equal(mc.symm_matvec(m, V2), u2))
    _nan_lower_tiles(m, mc.SYMM_TILE)
    blind = (torch.equal(mc.symm_matvec(m, v), u)
             and torch.equal(mc.symm_matvec(m, V2), u2))
    log(f"K4 {n} blobs f32 vs plain f64: max err {err:.3e}, / max|ref| = "
        f"{err / scale:.3e}, B = 2 max err {err2:.3e}, / max|ref| = "
        f"{err2 / scale2:.3e} (bound 3e-6); kernel {ms:.3f} ms, plain "
        f"(torch.mv) {plain_ms:.3f} ms, library torch.mv {lib_ms:.3f} ms, "
        f"bound {rec['bound_ms']:.3f} ms ({rec['bound_by']}); B = 2: K4 "
        f"{k4b2_ms:.3f} ms, torch.matmul {mm_ms:.3f} ms; K1 tt matrix-free "
        f"product {records['tt_12k']['ms']:.3f} ms; B = 1 and 2 "
        f"repeat bit-identical {same}, NaN lower tiles unchanged {blind}")
    check(err <= 3e-6 * scale and err2 <= 3e-6 * scale2,
          f"K4 disagrees at {n} blobs (B = 1 {err / scale:.3e}, B = 2 "
          f"{err2 / scale2:.3e})")
    check(same and blind, "K4 not deterministic or read a lower tile")
    return records


def write_shell_input(d, pos, quat, settings):
    """An input file of twelve-blob shells above the wall in directory d
    with bench.py's multibody physics; returns its path."""
    from rigidmultiblobswall_tpu_torch.io import scene

    with open(os.path.join(d, "shell.vertex"), "w") as f:
        f.write("12\n")
        for x in shell_vertices():
            f.write("%.16g %.16g %.16g\n" % tuple(x))
    scene.write_clones_file(os.path.join(d, "shell.clones"), pos, quat)
    inp = os.path.join(d, "input.dat")
    with open(inp, "w") as f:
        f.write(settings + "eta 1.0\ng 0.1\nblob_radius 0.131\nkT 0.05\n"
                "repulsion_strength_wall 0.2\ndebye_length_wall 0.2\n"
                "repulsion_strength 0.2\ndebye_length 0.2\n"
                "blob_blob_force_implementation python\nseed 1\n"
                "output_name run\nstructure shell.vertex shell.clones\n")
    return inp


def phase_dense_cli():
    """Phase 5, the static dense modes: body_mobility and resistance on a
    generated 64-shell input, on the card in float64 against the CPU in
    float64 (1e-9 x max|ref|)."""
    from rigidmultiblobswall_tpu_torch import cli

    pos, quat = lattice(64, seed=2)
    u = np.random.default_rng(9).normal(size=(64, 6))
    cwd = os.getcwd()
    outs = {}
    with tempfile.TemporaryDirectory() as d:
        np.savetxt(os.path.join(d, "velocity.dat"), u)
        for scheme, names in (("body_mobility", ("body_mobility",
                                                 "body_slip_mobility")),
                              ("resistance", ("force",))):
            inp = write_shell_input(d, pos, quat, (
                f"scheme {scheme}\nvelocity_file velocity.dat\n"))
            os.chdir(d)
            try:
                for device in (DEVICE, "cpu"):
                    t0 = time.perf_counter()
                    cli.main(["--input-file", inp, "--f64", "--device",
                              device])
                    secs = time.perf_counter() - t0
                    for name in names:
                        outs[name, device] = np.loadtxt(f"run.{name}.dat")
                    log(f"CLI {scheme} 64 shells f64 on {device}: "
                        f"{secs:.2f} s")
            finally:
                os.chdir(cwd)
    for name in ("body_mobility", "body_slip_mobility", "force"):
        got, ref = outs[name, DEVICE], outs[name, "cpu"]
        rel = np.abs(got - ref).max() / np.abs(ref).max()
        log(f"CLI .{name}.dat {got.shape}: card vs CPU max err / max|ref| "
            f"= {rel:.3e} (bound 1e-9)")
        check(np.all(np.isfinite(got)) and rel <= 1e-9,
              f"CLI .{name}.dat card vs CPU")


def run_dense_path(system, scheme, pos, quat, pk, mc, n_timed=3):
    """One warm-up and n_timed steps of `scheme` at the configuration;
    returns the per-step records and the kernels' launch counts."""
    from rigidmultiblobswall_tpu_torch.models import integrators
    from rigidmultiblobswall_tpu_torch.models.system import make_state

    dev = torch.device(DEVICE)
    state = make_state(pos, quat, dtype=torch.float32, device=dev)
    step = integrators.make_stepper(
        system, scheme, 1e-3, lanczos_tolerance=5e-4, lanczos_max_iter=32,
        lanczos_check_every=4, gmres_restart=60, gmres_maxiter=300,
        max_rejections=3)
    carry = integrators.init_carry(system, state=state)
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pk.LAUNCHES.update(dict.fromkeys(pk.LAUNCHES, 0))
    mc.LAUNCHES = 0
    reset_dense(mc)
    t0 = time.perf_counter()
    state, carry, aux = step(state, gen, carry)           # warm-up
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    det, sto, rej = [aux.det_iterations], [aux.stoch_iterations], \
        [aux.rejections]
    t0 = time.perf_counter()
    for _ in range(n_timed):
        state, carry, aux = step(state, gen, carry)
        det.append(aux.det_iterations)
        sto.append(aux.stoch_iterations)
        rej.append(aux.rejections)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / n_timed * 1e3
    launches = dict(dense_launches(mc), K1_tt=pk.launches("tt"),
                    K2=mc.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(bool(torch.isfinite(state.pos).all()),
          f"{scheme}: positions not finite")
    check(min(det) > 0 and min(sto) > 0, f"{scheme}: no solver iterations")
    return dict(ms=ms, warm_ms=warm_ms, det=det, sto=sto, rej=rej,
                peak=peak), launches


def phase_dense_path(pk, mc):
    """Phase 9, multibody-12k-dense: bench.py's multibody configuration at
    1024 shells (12,288 blobs), float32, Slip-Trapz and stochastic AB on
    the materialized engine and again matrix-free (budget 0). The engines'
    GMRES sweeps agree within one per solve and their Lanczos iterations
    within one check interval (4). Returns the launch counts of the
    materialized Slip-Trapz run (4 steps)."""
    from rigidmultiblobswall_tpu_torch.models import saddle

    system = bench_system(N_DENSE)
    pos, quat = lattice(N_DENSE)
    budget = saddle.MATERIALIZE_BUDGET_BYTES
    n_solves = {"stochastic_Slip_Trapz": 2, "stochastic_adams_bashforth": 3}
    out = {}
    try:
        for scheme in n_solves:
            for engine, b in (("materialized", budget), ("matrix-free", 0)):
                saddle.MATERIALIZE_BUDGET_BYTES = b
                rec, launches = run_dense_path(system, scheme, pos, quat, pk,
                                               mc)
                out[scheme, engine] = rec, launches
                per_step = {k: v / 4 for k, v in launches.items()}
                log(f"dense path {system.num_blobs} blobs ({N_DENSE} shells) "
                    f"{scheme} f32, {engine}: {rec['ms']:.1f} ms/step over 3 "
                    f"steps (warm-up {rec['warm_ms']:.1f} ms); gmres "
                    f"{rec['det']}, lanczos {rec['sto']}, rejections "
                    f"{rec['rej']}; launches per step {per_step}; peak "
                    f"device memory {rec['peak']:.2f} GiB")
    finally:
        saddle.MATERIALIZE_BUDGET_BYTES = budget
    for scheme, k in n_solves.items():
        dense, free = out[scheme, "materialized"], out[scheme, "matrix-free"]
        check(min(dense[1]["dense_tt"], dense[1]["symm_matvec"]) > 0,
              f"{scheme}: K3/K4 not launched on the materialized path")
        check(max(free[1]["dense_tt"], free[1]["symm_matvec"]) == 0,
              f"{scheme}: K3/K4 launched with a zero budget")
        check(dense[1]["K1_tt"] > 0, f"{scheme}: K1 tt not launched on the "
              "materialized path")
        dd = [abs(x - y) for x, y in zip(dense[0]["det"], free[0]["det"])]
        ds = [abs(x - y) for x, y in zip(dense[0]["sto"], free[0]["sto"])]
        check(max(dd) <= k and max(ds) <= 4,
              f"{scheme}: engines' solver counts differ (gmres {dd}, "
              f"lanczos {ds})")
    return out["stochastic_Slip_Trapz", "materialized"][1]


# ---------------------------------------------------------------------------
# The remaining multibody schemes, obstacles and Krylov recycling (ROADMAP
# Queue 1, item 17): phase 4's parity, phase 5's obstacle CLI, phase 13
# ---------------------------------------------------------------------------

ITEM17_SCHEMES = ("stochastic_first_order_RFD", "stochastic_traction_EM",
                  "stochastic_traction_AB", "stochastic_Slip_Mid",
                  "stochastic_GDC_RFD")
# the schemes whose paired solves share a lockstep loop (K1 tt B = 2)
LOCKSTEP_SCHEMES = ("stochastic_traction_AB", "stochastic_Slip_Mid")
# phase 13's obstacles: the last 512 of the 4096 shells
N_OBSTACLES = 512


def obstacle_system(n_free, n_obst, **overrides):
    """bench_system's physics with the last n_obst shells an obstacle type
    (prescribed zero velocity)."""
    from rigidmultiblobswall_tpu_torch.models.system import BodyType

    system = bench_system(n_free, **overrides)
    obst = BodyType(name="obstacle", ref_config=shell_vertices(),
                    count=n_obst, prescribed_kinematics=True,
                    is_obstacle=True)
    return dataclasses.replace(system, types=system.types + (obst,))


def run_scheme_steps(system, scheme, pos, quat, dtype, device, n_steps,
                     tol):
    """n_steps of `scheme` from (pos, quat) with every normal drawn by
    host_normals(11) (the same numbers in float32 and float64, on the
    card and the CPU). Returns the final state as float64 numpy and the
    last StepAux."""
    from rigidmultiblobswall_tpu_torch.models import integrators
    from rigidmultiblobswall_tpu_torch.models.system import make_state

    state = make_state(pos, quat, dtype=dtype, device=device)
    step = integrators.make_stepper(system, scheme, 1e-3, tolerance=tol,
                                    lanczos_tolerance=1e-8)
    carry = integrators.init_carry(system, state=state)
    draw, integrators.draw_normal = (integrators.draw_normal,
                                     host_normals(11))
    try:
        for _ in range(n_steps):
            state, carry, aux = step(state, None, carry)
    finally:
        integrators.draw_normal = draw
    return (state.pos.double().cpu().numpy(),
            state.quat.double().cpu().numpy(), aux)


def scheme_parity_case(system, scheme, what, n_free=None):
    """3 steps card f64 and card f32 against CPU f64, the same normals fed
    to every run; errors over the largest displacement. With n_free, the
    bodies past it are obstacles: their positions and orientations must
    come back unchanged."""
    n = system.num_bodies
    pos, quat = lattice(n, seed=5)
    pos64, quat64 = pos.astype(np.float64), quat.astype(np.float64)
    ref, ref_q, _ = run_scheme_steps(system, scheme, pos64, quat64,
                                     torch.float64, "cpu", 3, 1e-12)
    got64, got64_q, aux = run_scheme_steps(system, scheme, pos64, quat64,
                                           torch.float64, DEVICE, 3, 1e-12)
    got32, _, _ = run_scheme_steps(system, scheme, pos64, quat64,
                                   torch.float32, DEVICE, 3, 1e-5)
    disp = np.abs(ref - pos64).max()
    e64 = np.abs(got64 - ref).max() / disp
    e32 = np.abs(got32 - ref).max() / disp
    log(f"{what} parity, {scheme} x 3 steps (max displacement {disp:.3e}), "
        f"max error / max displacement: GPU f64 vs CPU f64 {e64:.3e} (bound "
        f"1e-9), GPU f32 vs CPU f64 {e32:.3e} (bound 1e-2); gmres "
        f"{aux.det_iterations}, lanczos {aux.stoch_iterations}, rejections "
        f"{aux.rejections}")
    check(disp > 0 and e64 <= 1e-9 and e32 <= 1e-2,
          f"{what} parity ({scheme})")
    if n_free is not None:
        for name, got, start in (("card", got64, pos64), ("CPU", ref, pos64),
                                 ("card", got64_q, quat64),
                                 ("CPU", ref_q, quat64)):
            check(np.array_equal(got[n_free:], start[n_free:]),
                  f"{what}: an obstacle moved ({scheme}, {name})")


def phase_scheme_parity(pk, mc):
    """Phase 4, item 17: 8 shells x 3 steps of each of the five schemes at
    kT = 0.05 (the materialized engine, K3 and K4, with K1 tt for the
    matrix-free RFD products and K2 for the forces), and 6 free shells
    beside 2 obstacle shells under Slip-Mid and GDC-RFD."""
    pk.LAUNCHES.update(dict.fromkeys(pk.LAUNCHES, 0))
    mc.LAUNCHES = 0
    reset_dense(mc)
    for scheme in ITEM17_SCHEMES:
        scheme_parity_case(bench_system(8), scheme, "8 shells")
    for scheme in ("stochastic_Slip_Mid", "stochastic_GDC_RFD"):
        scheme_parity_case(obstacle_system(6, 2), scheme,
                           "6 shells + 2 obstacles", n_free=6)
    launches = dict(dense_launches(mc), K1_tt=pk.launches("tt"),
                    K2=mc.LAUNCHES)
    log(f"item-17 parity launches {launches}")
    check(min(launches.values()) > 0,
          f"the item-17 parity did not run on K1 tt, K2, K3 and K4: "
          f"{launches}")


def phase_obstacle_cli():
    """Phase 5, obstacles: the CLI on a generated input of 6 shells and an
    `obstacle` entry of 2 shells, stochastic_Slip_Mid at kT = 0, 3 steps,
    card float64 against CPU float64: the same .clones of both IDs (1e-9
    of the displacement) and the obstacles where they started."""
    from rigidmultiblobswall_tpu_torch import cli
    from rigidmultiblobswall_tpu_torch.io import scene

    pos, quat = lattice(8, seed=4)
    pos, quat = pos.astype(np.float64), quat.astype(np.float64)
    cwd = os.getcwd()
    out = {}
    with tempfile.TemporaryDirectory() as d:
        for name, device in (("host", "cpu"), ("card", DEVICE)):
            dd = os.path.join(d, name)
            os.makedirs(dd)
            inp = write_shell_input(dd, pos[:6], quat[:6], (
                "scheme stochastic_Slip_Mid\ndt 0.001\nn_steps 3\n"
                "n_save 3\nsolver_tolerance 1e-12\n"
                "obstacle shell.vertex wall.clones\n"))
            scene.write_clones_file(os.path.join(dd, "wall.clones"),
                                    pos[6:], quat[6:])
            with open(inp) as f:
                text = f.read().replace("kT 0.05", "kT 0.0")
            with open(inp, "w") as f:
                f.write(text)
            os.chdir(dd)
            try:
                t0 = time.perf_counter()
                cli.main(["--input-file", inp, "--device", device, "--f64"])
                secs = time.perf_counter() - t0
            finally:
                os.chdir(cwd)
            out[name] = {(sid, i): np.loadtxt(os.path.join(
                dd, f"run.{sid}.{i:08d}.clones"), skiprows=1)
                for sid in ("shell", "wall") for i in (0, 3)}, secs
    (ref, _), (got, secs) = out["host"], out["card"]
    disp = np.abs(ref["shell", 3][:, :3] - ref["shell", 0][:, :3]).max()
    err = max(np.abs(got[k] - ref[k]).max() for k in got) / disp
    log(f"obstacle CLI 6 shells + 2 obstacles x 3 Slip-Mid steps (kT = 0): "
        f"{secs:.2f} s on the card, max error / max displacement GPU f64 vs "
        f"CPU f64 {err:.3e} (bound 1e-9; displacement {disp:.3e})")
    check(disp > 0 and err <= 1e-9, "obstacle CLI card vs CPU")
    for k in ("host", "card"):
        check(np.array_equal(out[k][0]["wall", 3], out[k][0]["wall", 0]),
              f"obstacle CLI ({k}): an obstacle moved")


def run_scheme_path(system, scheme, state, pk, mc, n_steps, recycle_k=0,
                    warmup=True):
    """bench.py's multibody stepper settings (phase 6's Lanczos and GMRES)
    on `scheme` from `state`: with warmup one untimed step first, then
    n_steps timed. Returns the final state, the per-step (GMRES, Lanczos,
    rejections) of the timed steps, ms per timed step, and the launches
    over all of them (the warm-up included)."""
    from rigidmultiblobswall_tpu_torch.models import integrators

    step = integrators.make_stepper(
        system, scheme, 1e-3, lanczos_tolerance=5e-4, lanczos_max_iter=32,
        lanczos_check_every=4, gmres_restart=60, gmres_maxiter=300,
        max_rejections=3, recycle_k=recycle_k)
    carry = integrators.init_carry(system, state=state)
    gen = torch.Generator(device=state.pos.device).manual_seed(0)
    pk.LAUNCHES.update(dict.fromkeys(pk.LAUNCHES, 0))
    mc.LAUNCHES = 0
    reset_dense(mc)
    if warmup:
        state, carry, _ = step(state, gen, carry)
    torch.cuda.synchronize()
    counts = []
    t0 = time.perf_counter()
    for _ in range(n_steps):
        state, carry, aux = step(state, gen, carry)
        counts.append((aux.det_iterations, aux.stoch_iterations,
                       aux.rejections))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / n_steps * 1e3
    launches = {"K1 tt": pk.LAUNCHES["tt", 1],
                "K1 tt B=2": pk.LAUNCHES["tt", 2], "K2": mc.LAUNCHES,
                **dense_launches(mc)}
    check(bool(torch.isfinite(state.pos).all()),
          f"{scheme}: positions not finite")
    return state, counts, ms, launches, carry


def phase_item17_path(pk, mc):
    """Phase 13, multibody-49k-schemes: bench.py's multibody configuration
    (4096 twelve-blob shells, 49,152 blobs, float32, matrix-free) through
    make_stepper/init_carry: each of the five schemes (one warm-up and two
    timed steps); 512 of the shells an obstacle type under Slip-Mid and
    GDC-RFD (two steps each; the obstacles bit-identical); and
    deterministic Adams-Bashforth at kT = 0 (BASELINE config 3's physics)
    for 6 steps with recycle_k = 6 and without."""
    from rigidmultiblobswall_tpu_torch.models import saddle, solvers
    from rigidmultiblobswall_tpu_torch.models import kinematics as kin
    from rigidmultiblobswall_tpu_torch.models.system import make_state

    t_phase = time.perf_counter()
    dev = torch.device(DEVICE)
    pos, quat = lattice(N_SHELLS)
    system = bench_system(N_SHELLS)
    out = {}
    for scheme in ITEM17_SCHEMES:
        state = make_state(pos, quat, dtype=torch.float32, device=dev)
        _, counts, ms, launches, _ = run_scheme_path(system, scheme, state,
                                                     pk, mc, 2)
        out[scheme] = ms
        log(f"item-17 path {system.num_blobs} blobs {scheme} f32: {ms:.1f} "
            f"ms/step over 2 steps; (gmres, lanczos, rejections) per step "
            f"{counts}; launches over the 3 steps {launches}")
        want = ["K1 tt", "K2"] + (["K1 tt B=2"] if scheme in LOCKSTEP_SCHEMES
                                  else [])
        check(all(launches[k] > 0 for k in want),
              f"{scheme}: a kernel of its path did not run: {launches}")
        check(max(dense_launches(mc).values()) == 0,
              f"{scheme}: K3/K4 launched above the budget")
        check(min(c[0] for c in counts) > 0, f"{scheme}: no GMRES iterations")

    n_free = N_SHELLS - N_OBSTACLES
    osys = obstacle_system(n_free, N_OBSTACLES)
    for scheme in ("stochastic_Slip_Mid", "stochastic_GDC_RFD"):
        state0 = make_state(pos, quat, dtype=torch.float32, device=dev)
        state, counts, ms, launches, _ = run_scheme_path(
            osys, scheme, state0, pk, mc, 2, warmup=False)
        still = (torch.equal(state.pos[n_free:], state0.pos[n_free:])
                 and torch.equal(state.quat[n_free:], state0.quat[n_free:]))
        moved = float((state.pos[:n_free] - state0.pos[:n_free]).abs().max())
        log(f"item-17 obstacles {n_free} shells + {N_OBSTACLES} obstacles "
            f"{scheme} f32: {ms:.1f} ms/step over 2 steps; (gmres, lanczos, "
            f"rejections) per step {counts}; obstacles bit-identical "
            f"{still}, free bodies' largest move {moved:.3e}; launches "
            f"{launches}")
        check(still, f"{scheme}: an obstacle moved")
        check(moved > 0, f"{scheme}: the free bodies did not move")
        check(launches["K1 tt"] > 0 and launches["K2"] > 0,
              f"{scheme} with obstacles: K1 tt or K2 did not run")

    det_system = bench_system(N_SHELLS, kT=0.0)
    runs = {}
    for k in (6, 0):
        state = make_state(pos, quat, dtype=torch.float32, device=dev)
        state, counts, ms, launches, carry = run_scheme_path(
            det_system, "deterministic_adams_bashforth", state, pk, mc, 6,
            recycle_k=k, warmup=False)
        runs[k] = state, [c[0] for c in counts], ms, launches, carry
        log(f"item-17 recycling deterministic_adams_bashforth kT = 0 "
            f"recycle_k = {k}: {ms:.1f} ms/step over 6 steps; GMRES sweeps "
            f"per step {runs[k][1]}; launches {launches}")
    rec_state, rec_its, _, rec_launches, rec_carry = runs[6]
    plain_state, plain_its, _, _, _ = runs[0]
    # the refresh of the last recycle state at the final configuration:
    # one 6-column lockstep sweep (three K1 tt B = 2 launches) and a QR and
    # SVD on the card, timed by CUDA events; and the 6-column mobility
    # product alone
    r = kin.blob_positions(det_system, rec_state)
    before = pk.LAUNCHES["tt", 2]
    refresh_ms = cuda_ms(lambda: solvers.refresh_recycle(
        det_system, rec_state, rec_carry.recycle, m_dense=None), 3)
    refresh_launches = (pk.LAUNCHES["tt", 2] - before) // 4
    lam6 = rec_carry.recycle.U[:, :3 * det_system.num_blobs].reshape(
        6, -1, 3).contiguous()
    multi_ms = cuda_ms(lambda: saddle._mobility_apply_multi(
        det_system, r, None, lam6), 3)
    single_ms = cuda_ms(lambda: saddle._mobility_apply(
        det_system, r, None, lam6[0]), 3)
    disp = float((plain_state.pos - torch.as_tensor(
        pos, device=dev)).abs().max())
    diff = float((rec_state.pos - plain_state.pos).abs().max())
    tol = det_system.solver_tolerance
    log(f"item-17 recycling: GMRES sweeps over steps 2-6 {sum(rec_its[1:])} "
        f"recycled against {sum(plain_its[1:])} plain; the refresh "
        f"{refresh_ms:.3f} ms with {refresh_launches} K1 tt B=2 launches "
        f"(the 6-column mobility product {multi_ms:.3f} ms, one B = 1 "
        f"product {single_ms:.3f} ms); final position difference "
        f"{diff:.3e} = {diff / disp:.3e} of the displacement {disp:.3e} "
        f"(solver tolerance {tol:g}; bound 10 x that, as the JAX package's "
        f"own recycling test holds it)")
    check(sum(rec_its[1:]) < sum(plain_its[1:]),
          "recycling did not cut the GMRES sweeps over steps 2-6")
    check(refresh_launches == 3 and rec_launches["K1 tt B=2"] > 0,
          f"the refresh did not run as three K1 tt B = 2 launches "
          f"({refresh_launches})")
    check(diff <= 10 * tol * disp, "the recycled run left the plain one")
    log(f"phase 13: {time.perf_counter() - t_phase:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Articulated bodies, active slip and body-body forces (ROADMAP Queue 1,
# item 18): phase 4's parity, phase 5's CLIs, phase 14 with its kernel
# records
# ---------------------------------------------------------------------------

# multibody-49k-articulated: 1024 chains of four shells (4096 shells,
# 49,152 blobs, 3072 ball joints), the shells on bench.py's lattice
# spacing, each chain along x
N_CHAINS = 1024
CHAIN_BODIES = 4
CHAIN_LINKS = np.array([[0.8, 0, 0, -0.8, 0, 0]] * (CHAIN_BODIES - 1))
# the time-dependent run: the chains' first joint breathes in t (its six
# link components and their derivatives, as a .const line writes them)
BREATHING_LINK = ["0.8 + 0.05*sin(20*t)", "0", "0", "-0.8", "0", "0",
                  "cos(20*t)", "0", "0", "0", "0", "0"]
# rollers-32k-articulated: 16,384 single-blob dumbbells (32,768 rollers)
# with the articulated_dumbbells example's physics
N_DUMBBELLS = 16384
DUMBBELL_LINK = 2.5
# the squirmer's tangential slip amplitude B1 (slip B1 sin(theta) e_theta)
SQUIRMER_B1 = 1.0
# what float32 rounding of a projected state leaves in a constraint
# g = x_p + R_p l_p - x_q - R_q l_q, evaluated in float64 from the float32
# state: half an ulp of each position (2^-24 |x| relative, two of them)
# and of each quaternion component, R quadratic in q (at most 4 half-ulps
# of |l| a side), over the projection's own tolerance (1e-8, met before
# theta is renormalized: 1e-7 with the link lengths here)
U32_HALF = 2.0 ** -24


def violation_bound(state, links):
    x = float(state.pos.abs().max())
    return U32_HALF * (2 * x + 8 * float(np.abs(links).max())) + 1e-7


def chain_system(n_chains, moving=False, **overrides):
    """bench_system's physics on n_chains chains of four twelve-blob
    shells joined by ball joints (sub-body j of every chain one type); with
    moving, the first joint's length oscillates in t."""
    from rigidmultiblobswall_tpu_torch.io.input_file import compile_links_fn
    from rigidmultiblobswall_tpu_torch.models.articulated import (
        ArticulatedType)
    from rigidmultiblobswall_tpu_torch.models.system import BodyType

    base = bench_system(1, **overrides)
    types = tuple(BodyType(name=f"chain_sub{j}", ref_config=shell_vertices(),
                           count=n_chains) for j in range(CHAIN_BODIES))
    extra = [BREATHING_LINK] + [[]] * (CHAIN_BODIES - 2)
    art = ArticulatedType(
        name="chain", count=n_chains, sub_type_indices=tuple(range(4)),
        pairs_local=np.array([[j, j + 1] for j in range(CHAIN_BODIES - 1)]),
        links=CHAIN_LINKS,
        links_fn=compile_links_fn(extra, CHAIN_LINKS) if moving else None)
    return dataclasses.replace(base, types=types, articulated=(art,))


def chain_lattice(n_chains):
    """The chains' positions, type-major (sub-body j of every chain, then
    j + 1), on bench.py's lattice spacing 1.6 from height 2: four chains a
    row along x, rows along y, layers along z; identity orientations, so
    the body-frame links are the lab-frame ones."""
    idx = np.arange(n_chains)
    side = int(np.ceil(np.sqrt(n_chains / 4)))
    origin = np.stack([(idx % 4) * CHAIN_BODIES * 1.6,
                       ((idx // 4) % side) * 1.6,
                       2.0 + (idx // (4 * side)) * 1.6], axis=1)
    pos = np.concatenate([origin + [1.6 * j, 0, 0]
                          for j in range(CHAIN_BODIES)])
    quat = np.tile([1.0, 0, 0, 0], (len(pos), 1))
    return pos, quat


def dumbbell_system(n, **overrides):
    """The articulated_dumbbells example's physics (a = 0.5, link 2.5,
    g = 1, wall repulsion 1.0 / 0.2, no blob-blob forces) on n
    single-blob dumbbells, phase 6's solver tolerance."""
    from rigidmultiblobswall_tpu_torch.models.articulated import (
        ArticulatedType)
    from rigidmultiblobswall_tpu_torch.models.system import BodyType, System

    kw = dict(eta=1.0, blob_radius=A_ROLLER, kT=0.0, g=1.0,
              domain="single_wall", repulsion_strength_wall=1.0,
              debye_length_wall=0.2, blob_blob_force_method="none",
              solver_tolerance=2e-4)
    kw.update(overrides)
    links = np.array([[DUMBBELL_LINK / 2, 0, 0, -DUMBBELL_LINK / 2, 0, 0]])
    types = tuple(BodyType(name=f"dumbbell_sub{j}",
                           ref_config=np.zeros((1, 3)), count=n)
                  for j in range(2))
    art = ArticulatedType(name="dumbbell", count=n, sub_type_indices=(0, 1),
                          pairs_local=np.array([[0, 1]]), links=links)
    return System(types=types, articulated=(art,), **kw)


def dumbbell_lattice(n, seed=0):
    """n dumbbells along x on a square lattice (4.0 along x, 1.6 along y)
    at height 1.5 with +-0.1 in-plane jitter, type-major."""
    side = int(np.ceil(np.sqrt(n)))
    idx = np.arange(n)
    rng = np.random.default_rng(seed)
    p0 = np.stack([(idx % side) * 4.0, (idx // side) * 1.6,
                   np.full(n, 1.5)], axis=1)
    p0[:, :2] += rng.uniform(-0.1, 0.1, size=(n, 2))
    pos = np.concatenate([p0, p0 + [DUMBBELL_LINK, 0, 0]])
    return pos, np.tile([1.0, 0, 0, 0], (2 * n, 1))


def squirmer_slip(ref, b1=SQUIRMER_B1):
    """The tangential squirmer slip B1 sin(theta) e_theta of a shell about
    its z axis, in the body frame."""
    r = ref / np.linalg.norm(ref, axis=1, keepdims=True)
    theta = np.arccos(np.clip(r[:, 2], -1, 1))
    phi = np.arctan2(r[:, 1], r[:, 0])
    e_theta = np.stack([np.cos(theta) * np.cos(phi),
                        np.cos(theta) * np.sin(phi), -np.sin(theta)], axis=1)
    return b1 * np.sin(theta)[:, None] * e_theta


def write_slip_file(path, slip):
    with open(path, "w") as f:
        f.write(f"{len(slip)}\n")
        for s in slip:
            f.write("%.16g %.16g %.16g\n" % tuple(s))


def active_system(n, **overrides):
    """bench_system at kT = 0 with the body-body Yukawa force and every
    shell a squirmer, its slip read back from a generated .slip file."""
    from rigidmultiblobswall_tpu_torch.io import scene

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "shell.slip")
        write_slip_file(path, squirmer_slip(shell_vertices()))
        slip = scene.read_slip_file(path)
    system = bench_system(n, kT=0.0, body_body_force_method="yukawa",
                          **overrides)
    return dataclasses.replace(system, types=(dataclasses.replace(
        system.types[0], slip_ref=slip),))


def run_articulated_steps(system, scheme, pos, quat, dtype, device, n_steps,
                          tol, dt=1e-3):
    """n_steps of a deterministic scheme from (pos, quat); returns the
    final positions as float64 numpy and the last StepAux."""
    from rigidmultiblobswall_tpu_torch.models import integrators
    from rigidmultiblobswall_tpu_torch.models.system import make_state

    state = make_state(pos, quat, dtype=dtype, device=device)
    step = integrators.make_stepper(system, scheme, dt, tolerance=tol)
    carry = integrators.init_carry(system, state=state)
    for _ in range(n_steps):
        state, carry, aux = step(state, None, carry)
    return state.pos.double().cpu().numpy(), aux


def articulated_parity_case(system, scheme, pos, quat, what, dt=1e-3):
    """3 steps card f64 and card f32 against CPU f64; errors over the
    largest displacement."""
    ref, _ = run_articulated_steps(system, scheme, pos, quat, torch.float64,
                                   "cpu", 3, 1e-12, dt)
    got64, aux = run_articulated_steps(system, scheme, pos, quat,
                                       torch.float64, DEVICE, 3, 1e-12, dt)
    got32, _ = run_articulated_steps(system, scheme, pos, quat,
                                     torch.float32, DEVICE, 3, 1e-5, dt)
    disp = np.abs(ref - pos).max()
    e64 = np.abs(got64 - ref).max() / disp
    e32 = np.abs(got32 - ref).max() / disp
    log(f"{what} parity, {scheme} x 3 steps (max displacement {disp:.3e}), "
        f"max error / max displacement: GPU f64 vs CPU f64 {e64:.3e} (bound "
        f"1e-9), GPU f32 vs CPU f64 {e32:.3e} (bound 1e-2); gmres "
        f"{aux.det_iterations}, rejections {aux.rejections}")
    check(disp > 0 and e64 <= 1e-9 and e32 <= 1e-2,
          f"{what} parity ({scheme})")


def phase_articulated_parity(pk, mc):
    """Phase 4, item 18: 8 four-shell chains (384 blobs: the materialized
    engine, K3 and K4, and K2) under both multibody articulated schemes,
    the midpoint also with the breathing joint, and 16 single-blob
    dumbbells (K1 grand) under both roller schemes, 3 steps each."""
    pk.LAUNCHES.update(dict.fromkeys(pk.LAUNCHES, 0))
    mc.LAUNCHES = 0
    reset_dense(mc)
    pos, quat = chain_lattice(8)
    for scheme, moving in (("articulated_deterministic_forward_euler", False),
                           ("articulated_deterministic_midpoint", False),
                           ("articulated_deterministic_midpoint", True)):
        articulated_parity_case(chain_system(8, moving=moving, kT=0.0),
                                scheme, pos, quat, "8 chains"
                                + (" (breathing joint)" if moving else ""))
    pos, quat = dumbbell_lattice(16, seed=5)
    for scheme in ("articulated_deterministic_forward_euler_rollers",
                   "articulated_deterministic_midpoint_rollers"):
        articulated_parity_case(dumbbell_system(16), scheme, pos, quat,
                                "16 dumbbells", dt=1e-2)
    launches = dict(dense_launches(mc), K1_grand=pk.launches("grand"),
                    K2=mc.LAUNCHES)
    log(f"articulated parity launches {launches}")
    check(min(launches.values()) > 0,
          f"the articulated parity did not run on K1 grand, K2, K3 and K4: "
          f"{launches}")


def run_cli_pair(make_inputs, argv_extra=()):
    """The port's CLI in float64 on the CPU and on the card, each in its
    own copy of the inputs that make_inputs(d) writes (returning the
    input file's name), run from that directory. Returns {name: (dir's
    files as {file: text}, seconds)}."""
    from rigidmultiblobswall_tpu_torch import cli

    cwd = os.getcwd()
    out = {}
    with tempfile.TemporaryDirectory() as d:
        for name, device in (("host", "cpu"), ("card", DEVICE)):
            dd = os.path.join(d, name)
            os.makedirs(dd)
            inp = make_inputs(dd)
            os.chdir(dd)
            try:
                t0 = time.perf_counter()
                cli.main(["--input-file", inp, "--device", device, "--f64",
                          *argv_extra])
                secs = time.perf_counter() - t0
            finally:
                os.chdir(cwd)
            out[name] = ({f: open(os.path.join(dd, f)).read()
                          for f in os.listdir(dd)}, secs)
    return out


def clones_error(out, files, start):
    """The largest card-vs-CPU difference over the .clones files, and the
    CPU run's largest displacement from `start`."""
    err = disp = 0.0
    for f in files:
        ref = np.loadtxt(out["host"][0][f].splitlines(), skiprows=1)
        got = np.loadtxt(out["card"][0][f].splitlines(), skiprows=1)
        err = max(err, np.abs(got - ref).max())
        disp = max(disp, np.abs(ref[:, :3] - start[:, :3]).max())
    return err, disp


def phase_articulated_cli():
    """Phase 5, item 18: the articulated_dumbbells example (its own
    rollers scheme, n_steps cut to 10, saved every 5) through the CLI
    from a copy of its directory (its .list_vertex resolves against the
    working directory), card float64 against CPU float64: the same
    .clones of the articulated ID and .info counters."""
    src = os.path.join(ROOT, "examples", "articulated_dumbbells")

    def inputs(dd):
        for f in os.listdir(src):
            shutil.copyfile(os.path.join(src, f), os.path.join(dd, f))
        with open(os.path.join(dd, "inputfile.dat")) as f:
            lines = [ln for ln in f.read().splitlines()
                     if ln.split()[:1] not in (["n_steps"], ["n_save"])]
        with open(os.path.join(dd, "inputfile.dat"), "w") as f:
            f.write("\n".join(lines + ["n_steps 10", "n_save 5"]) + "\n")
        return "inputfile.dat"

    out = run_cli_pair(inputs)
    start = np.loadtxt(os.path.join(src, "dumbbells.clones"), skiprows=1)
    files = [f"run_dumbbells.dumbbells.{k:08d}.clones" for k in (0, 5, 10)]
    err, disp = clones_error(out, files, start)
    info = out["card"][0]["run_dumbbells.info"]
    log(f"articulated_dumbbells CLI (10 steps): {out['card'][1]:.2f} s on "
        f"the card, max error / max displacement GPU f64 vs CPU f64 "
        f"{err / disp:.3e} (bound 1e-9; displacement {disp:.3e}); .info "
        f"equal {info == out['host'][0]['run_dumbbells.info']}")
    check(disp > 0 and err <= 1e-9 * disp, "articulated CLI card vs CPU")
    check(info == out["host"][0]["run_dumbbells.info"],
          "articulated CLI .info differs between the card and the CPU")


def phase_slip_cli():
    """Phase 5, active slip: a generated input of 8 squirmer shells (a
    generated .slip file) with the body-body Yukawa force,
    deterministic_adams_bashforth at kT = 0, 3 steps, card float64 against
    CPU float64."""
    pos, quat = lattice(8, seed=6)
    pos, quat = pos.astype(np.float64), quat.astype(np.float64)

    def inputs(dd):
        write_slip_file(os.path.join(dd, "shell.slip"),
                        squirmer_slip(shell_vertices()))
        inp = write_shell_input(dd, pos, quat, (
            "scheme deterministic_adams_bashforth\ndt 0.01\nn_steps 3\n"
            "n_save 3\nsolver_tolerance 1e-12\n"
            "body_body_force_torque_implementation python\n"))
        with open(inp) as f:
            text = f.read().replace("kT 0.05", "kT 0.0").replace(
                "structure shell.vertex shell.clones",
                "structure shell.vertex shell.clones shell.slip")
        with open(inp, "w") as f:
            f.write(text)
        return inp

    out = run_cli_pair(inputs)
    err, disp = clones_error(out, ["run.shell.00000003.clones"],
                             np.concatenate([pos, quat], axis=1))
    log(f"squirmer CLI 8 shells x 3 AB steps (.slip, Yukawa): "
        f"{out['card'][1]:.2f} s on the card, max error / max displacement "
        f"GPU f64 vs CPU f64 {err / disp:.3e} (bound 1e-9; displacement "
        f"{disp:.3e})")
    check(disp > 1e-3 and err <= 1e-9 * disp, "squirmer CLI card vs CPU")


def phase_articulated_kernels(pk, mc, mob, kin, make_state):
    """Phase 3 at phase 14's shapes: K1 tt and K2 at the 1024 chains'
    49,152 blobs and K1 grand at the 16,384 dumbbells' 32,768 rollers, as
    the paths call them, against their plain versions (k1_full_record,
    k2_full_record). Returns the records."""
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(14)
    pos, quat = chain_lattice(N_CHAINS)
    system = chain_system(N_CHAINS)
    r = kin.blob_positions(system, make_state(pos, quat, dtype=torch.float32,
                                              device=dev)).contiguous()
    n = r.shape[0]
    bound = u32_sqrt(n)
    q = (mob.shift_heights(r, A_BENCH) / A_BENCH).contiguous()
    v = torch.randn((n, 3), generator=g, device=dev)
    records = {"tt": k1_full_record(pk, "tt", q, v, 1024, bound,
                                    f"{n} blobs in chains")}
    kw = dict(repulsion_strength=0.2, debye_length=0.2, blob_radius=A_BENCH)
    records["K2"] = k2_full_record(pk, mc, r, kw, bound,
                                   f"{n} blobs in chains")
    pos, _ = dumbbell_lattice(N_DUMBBELLS)
    r = torch.as_tensor(pos, dtype=torch.float32, device=dev)
    q = (mob.shift_heights(r, A_ROLLER) / A_ROLLER).contiguous()
    v = torch.randn((q.shape[0], 6), generator=g, device=dev)
    records["grand"] = k1_full_record(pk, "grand", q, v, 1024,
                                      u32_sqrt(q.shape[0]),
                                      f"{q.shape[0]} rollers in dumbbells")
    return records


def run_articulated_path(system, scheme, pos, quat, pk, mc, n_timed=3):
    """One warm-up and n_timed timed steps of `scheme` at phase 6's solver
    settings in float32 from (pos, quat). Returns (final state, per timed
    step (GMRES sweeps, rejections), ms/step, Gauss-Newton iterations of
    every projection over the run, launches over the run)."""
    from rigidmultiblobswall_tpu_torch.models import articulated as art
    from rigidmultiblobswall_tpu_torch.models import integrators
    from rigidmultiblobswall_tpu_torch.models.system import make_state

    state = make_state(pos, quat, dtype=torch.float32,
                       device=torch.device(DEVICE))
    step = integrators.make_stepper(system, scheme, 1e-3, gmres_restart=60,
                                    gmres_maxiter=300, max_rejections=3)
    carry = integrators.init_carry(system, state=state)
    pk.LAUNCHES.update(dict.fromkeys(pk.LAUNCHES, 0))
    mc.LAUNCHES = 0
    reset_dense(mc)
    art.GN_ITERATIONS.clear()
    state, carry, _ = step(state, None, carry)
    torch.cuda.synchronize()
    counts = []
    t0 = time.perf_counter()
    for _ in range(n_timed):
        state, carry, aux = step(state, None, carry)
        counts.append((aux.det_iterations, aux.rejections))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / n_timed * 1e3
    launches = {"K1 tt": pk.LAUNCHES["tt", 1], "K1 grand": pk.launches(
        "grand"), "K1 other": sum(n for (c, b), n in pk.LAUNCHES.items()
                                  if c not in ("tt", "grand") or b != 1),
                "K2": mc.LAUNCHES, **dense_launches(mc)}
    check(bool(torch.isfinite(state.pos).all()
               and torch.isfinite(state.quat).all()),
          f"{scheme}: positions not finite")
    check(all(c[1] == 0 for c in counts), f"{scheme}: rejections {counts}")
    return state, counts, ms, list(art.GN_ITERATIONS), launches, carry


def phase_articulated_path(pk, mc):
    """Phase 14, item 18 at full width, float32, one warm-up and three
    timed steps each: multibody-49k-articulated (1024 four-shell chains,
    49,152 blobs, 3072 ball joints; FE and midpoint, the midpoint again
    with the breathing joint), rollers-32k-articulated (16,384 dumbbells,
    32,768 rollers; FE and midpoint rollers) and multibody-49k-active
    (4096 squirmer shells with the Yukawa body-body force,
    deterministic_adams_bashforth at kT = 0). Returns the launches of K1
    tt, K1 grand and K2 over the phase."""
    from rigidmultiblobswall_tpu_torch.models import articulated as art
    from rigidmultiblobswall_tpu_torch.models.system import State

    t_phase = time.perf_counter()
    total = {"K1 tt": 0, "K1 grand": 0, "K2": 0}
    chains = ("multibody-49k-articulated", chain_system, chain_lattice,
              N_CHAINS, ("K1 tt", "K2"))
    rollers = ("rollers-32k-articulated", dumbbell_system, dumbbell_lattice,
               N_DUMBBELLS, ("K1 grand",))
    # (cell, scheme, the breathing joint, solves a step)
    runs = [(chains, "articulated_deterministic_forward_euler", False, 1),
            (chains, "articulated_deterministic_midpoint", False, 2),
            (chains, "articulated_deterministic_midpoint", True, 2),
            (rollers, "articulated_deterministic_forward_euler_rollers",
             False, 1),
            (rollers, "articulated_deterministic_midpoint_rollers", False,
             2)]
    for (cell, make_system, make_pos, n, want), scheme, moving, solves in runs:
        system = make_system(n, moving=True) if moving else make_system(n)
        pos, quat = make_pos(n)
        state, counts, ms, gn, launches, carry = run_articulated_path(
            system, scheme, pos, quat, pk, mc)
        t_end = carry.step_idx * 1e-3
        st64 = State(pos=state.pos.double(), quat=state.quat.double())
        viol = float(art.constraint_violation(system, st64, t_end)
                     .abs().max())
        links = art.links_at_time(system.articulated[0], t_end, st64.pos)[0]
        bound = violation_bound(state, links.cpu().numpy())
        log(f"{cell} {scheme}{' (breathing joint)' if moving else ''} f32: "
            f"{ms:.1f} ms/step over 3 steps; GMRES sweeps per step "
            f"{[c[0] for c in counts]} ({solves} solve(s) a step: "
            f"{[c[0] / solves for c in counts]} a solve); Gauss-Newton "
            f"iterations per projection over the 4 steps {gn}; largest "
            f"constraint violation {viol:.3e} (bound from float32 rounding "
            f"{bound:.3e}); rejections {[c[1] for c in counts]}; launches "
            f"{launches}")
        check(viol <= bound, f"{cell} {scheme}: constraint violation "
              f"{viol:.3e} above {bound:.3e}")
        check(all(launches[k] > 0 for k in want),
              f"{cell} {scheme}: a kernel of its path did not run: "
              f"{launches}")
        check(launches["dense_tt"] == 0 and launches["symm_matvec"] == 0,
              f"{cell} {scheme}: K3/K4 launched above the budget")
        check(max(gn) < 20, f"{cell} {scheme}: a projection did not "
              f"converge ({gn})")
        for k in total:
            total[k] += launches[k]
    # multibody-49k-active: AB at kT = 0 from bench.py's lattice
    system = active_system(N_SHELLS)
    pos, quat = lattice(N_SHELLS)
    state, counts, ms, _, launches, _ = run_articulated_path(
        system, "deterministic_adams_bashforth", pos, quat, pk, mc)
    moved = float((state.pos - torch.as_tensor(pos, device=state.pos.device))
                  .abs().max())
    log(f"multibody-49k-active deterministic_adams_bashforth (squirmer slip "
        f"B1 = {SQUIRMER_B1}, Yukawa body-body forces) f32: {ms:.1f} "
        f"ms/step over 3 steps; GMRES sweeps per step "
        f"{[c[0] for c in counts]}; largest move over the 4 steps "
        f"{moved:.3e}; launches {launches}")
    check(launches["K1 tt"] > 0 and launches["K2"] > 0,
          f"multibody-49k-active: K1 tt or K2 did not run: {launches}")
    check(moved > 0, "multibody-49k-active: the squirmers did not move")
    for k in ("K1 tt", "K2"):
        total[k] += launches[k]
    log(f"phase 14: {time.perf_counter() - t_phase:.1f} s")
    return total


# ---------------------------------------------------------------------------
# The user hooks and the phoretic path (ROADMAP Queue 1, item 18, bullets
# 1-3): phase 3's L1 checks and records, phase 4's parity, phase 5's CLIs,
# phase 15
# ---------------------------------------------------------------------------

L1_OPS = ("S", "D", "dD", "T", "bvp", "grad")
# float32 operations of a pair's term (an FMA as 2), counted from the JAX
# package's formulas (ops/laplace.py, models/phoretic.py): the geometry,
# the displacement and |d|^2 (8) for the real pair, and z_i + z_j and
# |R|^2 from the real pair's dx^2 + dy^2 (3) for its image; then each
# operator's work, split into what depends only on the pair (the same for
# (i, j) and (j, i)) and what each direction adds. S: the multiply-add
# (0 + 2); D: 1/r^3 (2) + r.n, its scale and the multiply-add (8); bvp:
# D's and S's on one 1/r (2 + 10); T: 1/r^3 (2) + the scaled field and
# three multiply-adds (7); dD: 1/r^2, 1/r^3, -3/r^2 and the five L
# components with L_zz (19) + L n and three multiply-adds (21); grad: dD's
# and T's on one 1/r^3 (19 + 28). One rsqrt a pair (MUFU.RSQ), the real
# pair's and the image's.
L1_REAL_GEOM_FLOPS = 8
L1_IMAGE_GEOM_FLOPS = 3
L1_PAIR_FLOPS = {"S": 0, "D": 2, "bvp": 2, "T": 2, "dD": 19, "grad": 19}
L1_DIR_FLOPS = {"S": 2, "D": 8, "bvp": 10, "T": 7, "dD": 21, "grad": 28}
# bytes a source and a target of each operator (float32): positions 12,
# normals 12 (D, dD, bvp, grad), the field and the weights 8, the rates 4
# each (bvp k; grad k and q); a target's position (12, not re-read by the
# fused sums, whose targets are the sources) and its 1 or 3 outputs
L1_SRC_BYTES = {"S": 20, "D": 32, "dD": 32, "T": 20, "bvp": 36, "grad": 40}
L1_TGT_BYTES = {"S": 16, "D": 16, "dD": 24, "T": 24, "bvp": 4, "grad": 12}
# the Janus chemistry of phase 15's shells (examples/phoretic_janus'
# split): the upper half (body-frame z >= 0) reacts, the lower half emits
JANUS_MOBILITY = 5.0
# phase 15's concentration grid: 64 x 64 x 8 cells over the 4096-shell
# lattice (x, y in [0, 24], z in [2, 26])
CONC_GRID = (-1.0, 25.0, 64, -1.0, 25.0, 64, 1.0, 27.0, 8)
# phase 15's Laplace GMRES: the JAX package's maxiter and restart
LAPLACE_MAXITER = 1000


def write_laplace_file(path, ref, mobility=JANUS_MOBILITY):
    """A .Laplace file for a shell of blobs ref (nb, 3): radial normals,
    weights 4 pi R^2 / nb, k = 5 and q = 0 above the body-frame equator,
    k = 0 and q = 1 below it, surface mobility `mobility`."""
    R = np.linalg.norm(ref, axis=1)
    n = ref / R[:, None]
    w = 4 * np.pi * R.mean() ** 2 / len(ref)
    with open(path, "w") as f:
        for ni in n:
            k, q = (5.0, 0.0) if ni[2] >= 0 else (0.0, 1.0)
            f.write(" ".join("%.16g" % v for v in (*ni, k, q, mobility, w))
                    + "\n")


def janus_config(ref=None, background=(1.0,)):
    """The port's PhoreticConfig of a generated Janus .Laplace file for the
    shell ref (bench.py's shell by default), read back as build_system
    reads one."""
    from rigidmultiblobswall_tpu_torch.models import phoretic

    ref = shell_vertices() if ref is None else ref
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "shell.Laplace")
        write_laplace_file(path, ref)
        chem = phoretic.Chemistry.from_laplace_file(path)
    bg = np.hstack([background, np.zeros(9 - len(background))])
    return phoretic.PhoreticConfig(chemistry=(chem,), background=bg,
                                   diffusion_coefficient=1.0)


def phoretic_system(n, **overrides):
    """bench_system with every shell a Janus particle: the System's
    slip_fn is the phoretic slip (models/phoretic.make_slip_fn)."""
    from rigidmultiblobswall_tpu_torch.models import phoretic

    cfg = janus_config()
    system = bench_system(n, **overrides)
    return dataclasses.replace(system, slip_fn=phoretic.make_slip_fn(cfg)), \
        cfg


def l1_call(lap, op, r, tgt, nrm, c, w, k, q, *, wall, self_interaction,
            plain=False, rows=None):
    """L1's operator `op` as the path calls it (the fused sums on the blobs
    with the self mask on), or its plain version; `rows` limits the plain
    versions of the unfused operators to the first targets."""
    dc = 1.0
    if op == "bvp":
        fn = lap.bvp_operator_plain if plain else lap.bvp_operator
        return fn(r, c, w, nrm, k, dc, wall=wall)
    if op == "grad":
        fn = lap.surface_gradient_plain if plain else lap.surface_gradient
        return fn(r, c, w, nrm, k, q, dc, wall=wall)
    name = {"S": "single_layer", "D": "double_layer",
            "dD": "deriv_double_layer", "T": "dipole"}[op]
    extra = (nrm,) if op in ("D", "dD") else ()
    if plain:
        t = tgt if rows is None else tgt[:rows]
        return getattr(lap, name + "_plain")(
            r, t, c, w, *extra, wall=wall, self_interaction=self_interaction)
    return getattr(lap, name)(r, tgt, c, w, *extra, wall=wall,
                              self_interaction=self_interaction)


def l1_pair_work(op, ns, nt, wall, on_surface):
    """(float32 operations, rsqrts) that L1's operator `op` needs over nt
    targets and ns sources, with each pair's real term and, with wall, its
    image term (the masked pairs are a handful). On the surface (targets
    are the sources, the self mask on) 1/r, 1/R and |d|^2 are symmetric in
    (i, j): each unordered pair's geometry and rsqrt count once, real and
    image, its per-direction work twice, and each blob's own image once;
    off the surface every (target, source) pair counts."""
    real = L1_REAL_GEOM_FLOPS + L1_PAIR_FLOPS[op]
    image = L1_IMAGE_GEOM_FLOPS + L1_PAIR_FLOPS[op]
    per_dir = L1_DIR_FLOPS[op]
    if not on_surface:
        pairs = nt * ns
        flops = pairs * (real + per_dir)
        if wall:
            flops += pairs * (image + per_dir)
        return flops, pairs * (2 if wall else 1)
    pairs = ns * (ns - 1) // 2
    flops = pairs * (real + 2 * per_dir)
    rsqrt = pairs
    if wall:
        flops += pairs * (image + 2 * per_dir) + ns * (image + per_dir)
        rsqrt += pairs + ns
    return flops, rsqrt


def l1_bound(op, ns, nt, wall, on_surface):
    """L1's bound record for `op` (l1_pair_work): the larger of its float32
    operations at 67 TFLOP/s and its rsqrts at 16 a clock an SM, or its
    bytes at 3.35 TB/s."""
    nbytes = ns * L1_SRC_BYTES[op] + nt * L1_TGT_BYTES[op]
    return bound_record(nbytes, *l1_pair_work(op, ns, nt, wall, on_surface))


def l1_inputs(r, nrm, g):
    """The fields of an L1 check on blobs r with normals nrm: a
    concentration near 1, the weights and rates of the Janus chemistry
    (tiled), all on r's device and dtype."""
    n = r.shape[0]
    up = nrm[:, 2] >= 0
    like = dict(dtype=r.dtype, device=r.device)
    c = 1.0 + 0.1 * torch.randn(n, generator=g, device=r.device).to(r.dtype)
    w = torch.full((n,), float(4 * np.pi * 0.25 / 12), **like)
    k = torch.where(up, 5.0, 0.0).to(r.dtype)
    q = torch.where(up, 0.0, 1.0).to(r.dtype)
    return c, w, k, q


def l1_check(lap, op, args, wall, self_interaction, what, rows=None):
    """One L1 instance against its float64 plain version (every target, or
    the first `rows`), twice bit-identical; float64 runs within 1e-12,
    float32 within u32 sqrt(Ns) or twice the float32 plain version's own
    error, both times max|ref|. Returns (max abs error, the float32 plain
    version's, ref scale)."""
    kw = dict(wall=wall, self_interaction=self_interaction)
    got = l1_call(lap, op, *args, **kw)
    again = l1_call(lap, op, *args, **kw)
    torch.cuda.synchronize()
    same = torch.equal(got, again)
    ref = l1_call(lap, op, *[a.double() for a in args], **kw, plain=True,
                  rows=rows)
    sub = ref.shape[0]
    scale = float(ref.abs().max())
    err = float((got[:sub].double() - ref).abs().max())
    f32 = args[0].dtype == torch.float32
    plain_err = None
    bound = 1e-12
    if f32:
        plain = l1_call(lap, op, *args, **kw, plain=True, rows=rows)
        plain_err = float((plain.double() - ref).abs().max())
        bound = max(2 ** -24 * args[0].shape[0] ** 0.5,
                    2 * plain_err / scale)
    log(f"L1 {op} {what} wall={wall} self={self_interaction} "
        f"{args[0].dtype}: first {sub} targets vs plain f64 max err "
        f"{err:.3e}, / max|ref| = {err / scale:.3e} (bound {bound:.2e})"
        + (f"; float32 plain version {plain_err / scale:.3e}" if f32
           else "") + f"; repeat bit-identical {same}")
    check(err <= bound * scale, f"L1 {op} disagrees at {what} (wall={wall}"
          f", self={self_interaction}, {args[0].dtype}): {err / scale:.3e}")
    check(same, f"L1 {op} not bit-identical on repeat at {what}")
    return err, plain_err, scale


def phase_l1_kernels():
    """Phase 3, L1: every operator on a random ~3000-blob scene above the
    wall (a blob on the wall, a coincident pair, off-surface targets for
    the unfused operators on the directed sweep and the blobs themselves
    on the symmetric sweep), wall on and off, self mask on and off,
    float32 and float64; then at phase 15's 49,152 blobs (every target of
    the fused sums, the first 1024 of the others), each instance as the
    path calls it, timed with its plain version and its bound: the BVP operator, the single layer of the
    right-hand side and the surface gradient (the self mask on), and the
    double and single layers of the concentration field at its 32,768
    grid points (the self mask off). Returns the records."""
    from rigidmultiblobswall_tpu_torch.models import fields
    from rigidmultiblobswall_tpu_torch.models import kinematics as kin
    from rigidmultiblobswall_tpu_torch.models import phoretic
    from rigidmultiblobswall_tpu_torch.models.system import make_state
    from rigidmultiblobswall_tpu_torch.ops import laplace as lap
    from rigidmultiblobswall_tpu_torch.ops.pair_kernels import _n_sm, \
        plan_groups

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(15)
    n, n_off = 3000, 1200
    r = rng.uniform(0, 20, (n, 3))
    r[:, 2] = rng.uniform(0, 4, n)
    r[0, 2] = 0.0
    r[1] = r[2]
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    tgt = rng.uniform(0, 20, (n_off, 3))
    tgt[7] = r[11]
    g = torch.Generator(device=dev).manual_seed(15)
    for dtype in (torch.float32, torch.float64):
        rt, tt, nt_ = (torch.as_tensor(x, dtype=dtype, device=dev)
                       for x in (r, tgt, nrm))
        args = (rt, tt, nt_, *l1_inputs(rt, nt_, g))
        on_surface = (rt, rt) + args[2:]
        for op in L1_OPS:
            fused = op in ("bvp", "grad")
            for wall in (True, False):
                for self_interaction in ((True,) if fused else (True, False)):
                    l1_check(lap, op, args, wall, self_interaction,
                             f"{n} blobs" + ("" if fused else
                                             f", {n_off} targets"))
                    if not fused:   # the blobs as targets: symmetric
                        l1_check(lap, op, on_surface, wall,
                                 self_interaction, f"{n} blobs")

    # phase 15's shapes: the 4096 Janus shells' blobs and lab normals, and
    # the concentration grid
    system, cfg = phoretic_system(N_SHELLS)
    pos, quat = lattice(N_SHELLS)
    state = make_state(pos, quat, dtype=torch.float32, device=dev)
    rb = kin.blob_positions(system, state).contiguous()
    nb = phoretic.lab_normals(system, state, cfg.chemistry).contiguous()
    grid = torch.as_tensor(fields.velocity_field_grid(CONC_GRID)[0],
                           dtype=torch.float32, device=dev)
    args = (rb, grid, nb, *l1_inputs(rb, nb, g))
    ns = rb.shape[0]
    records = {}
    for op, self_interaction, key in (("bvp", True, "bvp"), ("S", True, "S"),
                                      ("grad", True, "grad"),
                                      ("D", False, "D_off"),
                                      ("S", False, "S_off"),
                                      ("dD", True, None), ("T", True, None)):
        off = not self_interaction
        what = (f"{ns} blobs, {grid.shape[0]} grid points" if off
                else f"{ns} blobs")
        a = args if off else (rb, rb) + args[2:]
        fused = op in ("bvp", "grad")
        err, _, scale = l1_check(lap, op, a, True, self_interaction, what,
                                 rows=None if fused else 1024)
        kw = dict(wall=True, self_interaction=self_interaction)
        ms = cuda_ms(lambda: l1_call(lap, op, *a, **kw), 10)
        nt = a[1].shape[0]
        bound = l1_bound(op, ns, nt, True, not off)
        # the directed bound: every (target, source) pair evaluated, as
        # the kernel's sweep does
        directed = l1_bound(op, ns, nt, True, False)["bound_ms"]
        if key is None:      # not on the path: its time in the log only
            log(f"L1 {op} {what} f32 (not on the path): kernel {ms:.3f} ms, "
                f"bound {bound['bound_ms']:.3f} ms (directed "
                f"{directed:.3f} ms)")
            continue
        plain_ms = cuda_ms(lambda: l1_call(lap, op, *a, **kw, plain=True),
                           1, warmup=False)
        if off:
            design = "directed sweep, one target a thread (redesigned)"
            plan = "%d slices of %d tiles" % lap.plan_slices(nt, ns,
                                                             _n_sm(rb))
        else:
            design = ("symmetric sweep, sources broadcast from shared "
                      "memory, reduce-scatter of their sums (redesigned)")
            plan = "%d groups of %d tiles" % plan_groups(ns, _n_sm(rb))
        rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, design=design,
                   plan=plan, **bound)
        log(f"L1 {op} {what} f32, {design}, {plan}: kernel {ms:.3f} ms, "
            f"bound {rec['bound_ms']:.3f} ms ({rec['bound_by']}, "
            f"{rec['bound_ms'] / ms:.1%} of it; directed {directed:.3f} ms, "
            f"{directed / ms:.1%}), plain f32 {plain_ms:.1f} ms"
            f"; max|ref| {scale:.3e}")
        records[key] = rec
    return records


def run_phoretic_steps(system, scheme, pos, quat, dtype, device, tol,
                       n_steps=3):
    """n_steps of `scheme` on a phoretic system from (pos, quat), the
    normals of host_normals(11) (the same numbers on the CPU and the
    card). Returns the final positions as float64 numpy and the last
    aux."""
    from rigidmultiblobswall_tpu_torch.models import integrators
    from rigidmultiblobswall_tpu_torch.models.system import make_state

    system = dataclasses.replace(system, solver_tolerance=tol)
    state = make_state(pos, quat, dtype=dtype, device=device)
    step = integrators.make_stepper(system, scheme, 1e-2, tolerance=tol,
                                    lanczos_tolerance=1e-8)
    carry = integrators.init_carry(system, state=state)
    draw, integrators.draw_normal = (integrators.draw_normal,
                                     host_normals(11))
    try:
        for _ in range(n_steps):
            state, carry, aux = step(state, None, carry)
    finally:
        integrators.draw_normal = draw
    return state.pos.double().cpu().numpy(), aux


def phase_phoretic_parity(pk, mc):
    """Phase 4, item 18: 8 Janus shells above the wall (96 blobs, the
    materialized engine and L1) x 3 steps of deterministic forward Euler
    at kT = 0 and of stochastic Slip-Trapz at kT = 0.05, the same normals
    fed; and 16 rollers with a torque_fn hook under stochastic
    Adams-Bashforth (free kinematics). Card float64 against CPU float64
    (1e-9 of the displacement) and card float32 against CPU float64
    (1e-2)."""
    from rigidmultiblobswall_tpu_torch.ops import laplace as lap

    for key in lap.LAUNCHES:
        lap.LAUNCHES[key] = 0
    pos, quat = lattice(8, seed=7)
    pos, quat = pos.astype(np.float64), quat.astype(np.float64)
    for scheme, kT in (("deterministic_forward_euler", 0.0),
                       ("stochastic_Slip_Trapz", 0.05)):
        system, _ = phoretic_system(8, kT=kT)
        ref, _ = run_phoretic_steps(system, scheme, pos, quat,
                                    torch.float64, "cpu", 1e-12)
        got64, aux = run_phoretic_steps(system, scheme, pos, quat,
                                        torch.float64, DEVICE, 1e-12)
        got32, _ = run_phoretic_steps(system, scheme, pos, quat,
                                      torch.float32, DEVICE, 1e-5)
        disp = np.abs(ref - pos).max()
        e64 = np.abs(got64 - ref).max() / disp
        e32 = np.abs(got32 - ref).max() / disp
        log(f"phoretic parity, 8 Janus shells x 3 {scheme} steps (kT {kT}; "
            f"max displacement {disp:.3e}), max error / max displacement: "
            f"GPU f64 vs CPU f64 {e64:.3e} (bound 1e-9), GPU f32 vs CPU f64 "
            f"{e32:.3e} (bound 1e-2); gmres {aux.det_iterations}")
        check(disp > 1e-3 and e64 <= 1e-9 and e32 <= 1e-2,
              f"phoretic parity ({scheme})")
    launches = {op: lap.launches(op) for op in ("bvp", "S", "grad")}
    log(f"phoretic parity L1 launches {launches}")
    check(min(launches.values()) > 0, f"the phoretic slice did not run on "
          f"L1: {launches}")

    def torque_fn(sus, r):
        zero = 0.0 * r[:, 0]
        return torch.stack([zero, 20.0 + 2.0 * r[:, 2], zero], dim=1)

    r0 = roller_lattice(16, seed=5).astype(np.float64)
    scheme = "stochastic_adams_bashforth_rollers"
    sus64 = roller_suspension(16, solver_tolerance=1e-12,
                              free_kinematics=True, torque_fn=torque_fn)
    ref, _ = run_roller_steps(sus64, r0, scheme, torch.float64, "cpu")
    got64, _ = run_roller_steps(sus64, r0, scheme, torch.float64, DEVICE)
    sus0 = dataclasses.replace(sus64, kT=0.0)
    ref0, _ = run_roller_steps(sus0, r0, scheme, torch.float64, "cpu")
    got32, _ = run_roller_steps(dataclasses.replace(sus0,
                                                    solver_tolerance=1e-5),
                                r0, scheme, torch.float32, DEVICE)
    disp, disp0 = np.abs(ref - r0).max(), np.abs(ref0 - r0).max()
    e64 = np.abs(got64 - ref).max() / disp
    e32 = np.abs(got32 - ref0).max() / disp0
    log(f"roller hook parity, 16 rollers x 3 steps of {scheme} with a "
        f"torque_fn (max displacement {disp:.3e} at kT = 0.05, {disp0:.3e} "
        f"at kT = 0), max error / max "
        f"displacement: GPU f64 vs CPU f64 {e64:.3e} (bound 1e-9), GPU f32 "
        f"vs CPU f64 at kT = 0 {e32:.3e} (bound 1e-2)")
    check(disp > 0 and e64 <= 1e-9 and e32 <= 1e-2, "roller hook parity")


def read_vtk_text(text):
    """The numbers of a legacy-VTK rectilinear grid's text, in order."""
    nums = []
    for line in text.splitlines()[4:]:
        for tok in line.split():
            try:
                nums.append(float(tok))
            except ValueError:
                pass
    return np.array(nums)


def phoretic_inputs(dd, pos, quat, settings, hooks=None):
    """write_shell_input with a Janus .Laplace file on the structure (and
    a user_defined_functions.py)."""
    write_laplace_file(os.path.join(dd, "shell.Laplace"), shell_vertices())
    if hooks is not None:
        with open(os.path.join(dd, "user_defined_functions.py"), "w") as f:
            f.write(hooks)
    inp = write_shell_input(dd, pos, quat, settings)
    with open(inp) as f:
        text = f.read().replace(
            "structure shell.vertex shell.clones",
            "structure shell.vertex shell.clones shell.Laplace")
    with open(inp, "w") as f:
        f.write(text)
    return inp


HOOKS_TORCH = """import dataclasses

import torch


def body_force_torque_fn(system, state, r_blobs):
    z = state.pos[:, 2]
    zero = 0.0 * z
    return torch.stack([zero, 0.02 * z, zero, zero, zero, 0.3 + 0.1 * z],
                       dim=1)


def postprocess(system, state, step):
    pos = state.pos.clone()
    pos[:, 0] += 1e-3 * (step + 1)
    return dataclasses.replace(state, pos=pos)
"""


def phase_phoretic_cli():
    """Phase 5, item 18: generated inputs through the CLI, card float64
    against CPU float64: 8 Janus shells (a .Laplace file) x 3 forward
    Euler steps at kT = 0; body_mobility with the .Laplace file (its
    double-layer slip mobility); mobility with plot_velocity_field,
    tracer_radius and plot_concentration_field (the VTK files' numbers);
    and 8 plain shells x 3 Slip-Trapz steps at kT = 0 with a torch
    user_defined_functions.py defining body_force_torque_fn and
    postprocess."""
    pos, quat = lattice(8, seed=8)
    pos, quat = pos.astype(np.float64), quat.astype(np.float64)
    start = np.concatenate([pos, quat], axis=1)
    grid = "plot_velocity_field -1 5 6 -1 5 6 0.5 4.5 4\n" \
        "plot_concentration_field -1 5 6 -1 5 6 0.5 4.5 4\n"
    cases = [
        ("Janus shells x 3 forward Euler steps", lambda dd: phoretic_inputs(
            dd, pos, quat, "scheme deterministic_forward_euler\ndt 0.01\n"
            "n_steps 3\nn_save 3\nsolver_tolerance 1e-12\n"
            "background_Laplace 1\n"), ["run.shell.00000003.clones"]),
        ("body_mobility with a .Laplace file", lambda dd: phoretic_inputs(
            dd, pos, quat, "scheme body_mobility\nsolver_tolerance 1e-12\n"),
         ["run.body_slip_mobility_double_layer.dat"]),
        ("mobility with the velocity and concentration fields",
         lambda dd: phoretic_inputs(
             dd, pos, quat, "scheme mobility\nsolver_tolerance 1e-12\n"
             "tracer_radius 0.1\nbackground_Laplace 1 0.1\n" + grid),
         ["run.velocity_field.vtk", "run.concentration_field.vtk"]),
        ("user_defined_functions.py x 3 Slip-Trapz steps",
         lambda dd: phoretic_hook_input(dd, pos, quat),
         ["run.shell.00000003.clones"])]
    for what, make, files in cases:
        out = run_cli_pair(make)
        for f in files:
            a, b = out["card"][0][f], out["host"][0][f]
            if f.endswith(".clones"):
                err, disp = clones_error(out, [f], start)
                rel = err / disp
                ok = disp > 1e-3 and rel <= 1e-9
            else:
                x = (read_vtk_text(a) if f.endswith(".vtk")
                     else np.loadtxt(a.splitlines()))
                y = (read_vtk_text(b) if f.endswith(".vtk")
                     else np.loadtxt(b.splitlines()))
                # the VTK writer keeps six digits (%g)
                tol = 1e-5 if f.endswith(".vtk") else 1e-9
                rel = np.abs(x - y).max() / np.abs(y).max()
                ok = x.shape == y.shape and rel <= tol
            log(f"phoretic CLI, {what}: {f} GPU f64 vs CPU f64 relative "
                f"error {rel:.3e} ({out['card'][1]:.2f} s on the card)")
            check(ok, f"phoretic CLI card vs CPU ({what}, {f})")


def phoretic_hook_input(dd, pos, quat):
    with open(os.path.join(dd, "user_defined_functions.py"), "w") as f:
        f.write(HOOKS_TORCH)
    inp = write_shell_input(dd, pos, quat, (
        "scheme stochastic_Slip_Trapz\ndt 0.002\nn_steps 3\nn_save 3\n"
        "solver_tolerance 1e-12\n"))
    with open(inp) as f:
        text = f.read().replace("kT 0.05", "kT 0.0")
    with open(inp, "w") as f:
        f.write(text)
    return inp


def run_phoretic_path(system, scheme, pos, quat, pk, mc, solves):
    """One warm-up and three timed steps of `scheme` on the phoretic
    system, float32, phase 6's solver settings; each Laplace GMRES solve's
    (iterations, converged) recorded. Returns (state, per timed step
    (Stokes sweeps, Lanczos iterations, rejections), ms/step, Laplace
    solves over the run, launches, peak GiB)."""
    from rigidmultiblobswall_tpu_torch.models import integrators, phoretic
    from rigidmultiblobswall_tpu_torch.models.system import make_state
    from rigidmultiblobswall_tpu_torch.ops import cell_kernels as ck
    from rigidmultiblobswall_tpu_torch.ops import laplace as lap

    dev = torch.device(DEVICE)
    state = make_state(pos, quat, dtype=torch.float32, device=dev)
    step = integrators.make_stepper(
        system, scheme, 1e-3, lanczos_tolerance=5e-4, lanczos_max_iter=32,
        lanczos_check_every=4, gmres_restart=60, gmres_maxiter=300,
        max_rejections=3)
    carry = integrators.init_carry(system, state=state)
    gen = torch.Generator().manual_seed(0)
    laplace_solves = []
    gmres = phoretic.gmres

    def recorded(*a, **kw):
        res = gmres(*a, **kw)
        laplace_solves.append((res.iterations, bool(res.converged)))
        return res

    phoretic.gmres = recorded
    try:
        torch.cuda.reset_peak_memory_stats()
        pk.LAUNCHES.update(dict.fromkeys(pk.LAUNCHES, 0))
        mc.LAUNCHES = mc.PERIODIC_LAUNCHES = 0
        reset_dense(mc)
        ck.LAUNCHES.update(dict.fromkeys(ck.LAUNCHES, 0))
        for key in lap.LAUNCHES:
            lap.LAUNCHES[key] = lap.SYM_LAUNCHES[key] = 0
        state, carry, _ = step(state, gen, carry)          # warm-up
        torch.cuda.synchronize()
        counts = []
        t0 = time.perf_counter()
        for _ in range(3):
            state, carry, aux = step(state, gen, carry)
            counts.append((aux.det_iterations, aux.stoch_iterations,
                           aux.rejections))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 3 * 1e3
    finally:
        phoretic.gmres = gmres
    launches = {"L1 bvp": lap.launches("bvp"), "L1 S": lap.launches("S"),
                "L1 grad": lap.launches("grad"),
                "L1 other": lap.launches("D") + lap.launches("dD")
                + lap.launches("T"),
                "K1 tt": pk.LAUNCHES["tt", 1], "K1 tt B=2": pk.LAUNCHES["tt", 2],
                "K1 other": sum(n for (c, _), n in pk.LAUNCHES.items()
                                if c != "tt"),
                "K2": mc.LAUNCHES, "K2 periodic": mc.PERIODIC_LAUNCHES,
                "K3/K4": sum(dense_launches(mc).values()),
                "K5-K8": sum(ck.LAUNCHES.values()),
                "L1 symmetric": sum(lap.SYM_LAUNCHES.values())}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(bool(torch.isfinite(state.pos).all()
               and torch.isfinite(state.quat).all()),
          f"phoretic {scheme}: positions not finite")
    check(all(c[2] == 0 for c in counts), f"phoretic {scheme}: rejections "
          f"{counts}")
    check(len(laplace_solves) == 4 * solves, f"phoretic {scheme}: "
          f"{len(laplace_solves)} Laplace solves over 4 steps, not "
          f"{4 * solves}")
    check(all(ok and it < LAPLACE_MAXITER for it, ok in laplace_solves),
          f"phoretic {scheme}: a Laplace solve did not converge: "
          f"{laplace_solves}")
    check(launches["L1 symmetric"] == launches["L1 bvp"] + launches["L1 S"]
          + launches["L1 grad"], f"phoretic {scheme}: an L1 launch on the "
          f"blobs left the symmetric sweep: {launches}")
    want = ("L1 bvp", "L1 S", "L1 grad", "K1 tt", "K2")
    check(all(launches[k] > 0 for k in want)
          and all(launches[k] == 0 for k in ("L1 other", "K1 other",
                                             "K2 periodic", "K3/K4",
                                             "K5-K8")),
          f"phoretic {scheme}: launches {launches}")
    return state, counts, ms, laplace_solves, launches, peak


def phase_phoretic_path(pk, mc):
    """Phase 15, multibody-49k-phoretic: phase 6's scene (4096 shells,
    49,152 blobs above the wall, direct forces, tolerance 2e-4, float32)
    with every shell a Janus particle (a generated .Laplace chemistry,
    background_Laplace 1): deterministic forward Euler (one phoretic solve
    a step) and stochastic Slip-Trapz (two), one warm-up and three timed
    steps each; one phoretic_slip call read directly; the concentration
    field on a 64 x 64 x 8 grid through L1 with the self mask off.
    Returns the launches over the phase."""
    from rigidmultiblobswall_tpu_torch.models import fields, phoretic
    from rigidmultiblobswall_tpu_torch.models.system import make_state
    from rigidmultiblobswall_tpu_torch.ops import laplace as lap

    t_phase = time.perf_counter()
    pos, quat = lattice(N_SHELLS)
    total = {}
    for scheme, solves, kT in (("deterministic_forward_euler", 1, 0.0),
                               ("stochastic_Slip_Trapz", 2, 0.05)):
        system, cfg = phoretic_system(N_SHELLS, kT=kT)
        state, counts, ms, solves_log, launches, peak = run_phoretic_path(
            system, scheme, pos, quat, pk, mc, solves)
        moved = float((state.pos - torch.as_tensor(
            pos, device=state.pos.device)).abs().max())
        log(f"multibody-49k-phoretic {scheme} (kT {kT}) f32: {ms:.1f} "
            f"ms/step over 3 steps; Stokes GMRES sweeps and Lanczos "
            f"iterations per timed step {[c[:2] for c in counts]}; Laplace "
            f"GMRES iterations of each solve over the 4 steps "
            f"{[it for it, _ in solves_log]} (maxiter {LAPLACE_MAXITER}, all "
            f"converged); largest move {moved:.3e}; peak device memory "
            f"{peak:.2f} GiB; launches over the 4 steps {launches}")
        check(moved > 0, f"phoretic {scheme}: the shells did not move")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    # one phoretic_slip call read directly, at the final state
    t0 = time.perf_counter()
    slip, c, iters = phoretic.phoretic_slip(system, state, cfg)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    log(f"phoretic_slip at 49,152 blobs: {iters} GMRES iterations, "
        f"{secs * 1e3:.1f} ms; |slip| max {float(slip.abs().max()):.3e}, "
        f"c in [{float(c.min()):.3f}, {float(c.max()):.3f}]")
    check(0 < iters < LAPLACE_MAXITER and bool(torch.isfinite(slip).all()),
          "phoretic_slip did not converge at 49,152 blobs")
    # the concentration field on the grid, the self mask off
    off = (lap.LAUNCHES["D", False], lap.LAUNCHES["S", False])
    sym = sum(lap.SYM_LAUNCHES.values())
    coords = fields.velocity_field_grid(CONC_GRID)[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    c_grid, _ = phoretic.concentration_field(system, state, cfg, coords,
                                             c=c)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launched = (lap.LAUNCHES["D", False] - off[0],
                lap.LAUNCHES["S", False] - off[1])
    log(f"concentration field on {coords.shape[0]} grid points (64 x 64 x "
        f"8): {secs * 1e3:.1f} ms; c in [{float(c_grid.min()):.3f}, "
        f"{float(c_grid.max()):.3f}]; L1 D and S with the self mask off "
        f"launched {launched}")
    check(c_grid.shape == (coords.shape[0],)
          and bool(torch.isfinite(c_grid).all()),
          "the concentration field is not finite")
    check(launched == (1, 1), "the concentration field did not run on L1")
    check(sum(lap.SYM_LAUNCHES.values()) == sym, "the concentration field "
          "took L1's symmetric sweep")
    total["L1 D off"], total["L1 S off"] = launched
    log(f"phase 15: {time.perf_counter() - t_phase:.1f} s")
    return total


# ---------------------------------------------------------------------------
# The MCMC sampler and its pair energy, kernel M1 (ROADMAP Queue 1, item 18;
# Queue 2, M1): phase 3's M1 checks and records, phase 4's chain card
# against CPU, phase 5's MCMC modes through the CLI and phase 16
# ---------------------------------------------------------------------------

# float32 operations of an M1 unordered pair (csrc/blob_energy.cu
# pair_energy with forcek::energy), an FMA as 2 and a rsqrt or exp2 as 1:
# the difference (3), r^2 (5), the rsqrt and r = r^2 rsqrt (2), 2a - r (1),
# c t and its min (2), the exp2 (1), t / b and its max (2), the add and
# the product by eps (2), the tile sum (1)
ENERGY_PAIR_FLOPS = 19
# the truncation-form minimum image on each periodic axis: a division, the
# half's add, the truncation and the multiply-add back (5)
ENERGY_IMAGE_FLOPS = 5
# its special functions: one rsqrt and one exp2 an unordered pair
ENERGY_PAIR_MUFU = 2
# the rejection sampler's batch (models/mcmc.py REJECTION_BATCH): 4096
# proposals of one twelve-blob shell
N_MCMC_BATCH = 4096
# phase 3's boxes on the ~3000-blob scene (20 x 20 in-plane, heights to 4)
M1_BOXES = {"open": (0.0, 0.0, 0.0), "xy periodic": (20.0, 20.0, 0.0),
            "periodic": (20.0, 20.0, 8.0)}


def m1_bound(n, n_conf, box=(0.0, 0.0, 0.0)):
    """M1's bound record for n_conf configurations of n blobs (positions
    in, one float64 energy out; each unordered pair's law once) and its
    unordered pairs."""
    pairs = n_conf * n * (n - 1) // 2
    axes = sum(1 for L in box if L > 0)
    rec = bound_record(
        4 * 3 * n * n_conf + 8 * n_conf,
        pairs * (ENERGY_PAIR_FLOPS + ENERGY_IMAGE_FLOPS * axes),
        pairs * ENERGY_PAIR_MUFU)
    return rec, pairs


def m1_term_bound(mc, r, kw):
    """What float32 rounding of each term's inputs allows M1 on each
    configuration of r (P, n, 3), (P,) float64: 2^-22 (the relative error
    of ex2.approx and of r from rsqrt.approx) of each term times (2 + its
    exponent's magnitude |r - 2a| / b), summed over the unordered pairs in
    float64 (tests/test_torch_cuda.py _m1_term_bound), in the plain
    version's chunks."""
    from rigidmultiblobswall_tpu_torch.ops.pair_kernels import min_image

    r = r.double()
    n_conf, n = r.shape[0], r.shape[1]
    eps, b = kw["repulsion_strength"], kw["debye_length"]
    two_a = 2.0 * kw["blob_radius"]
    box = kw.get("periodic_length", (0.0, 0.0, 0.0))
    per, tile = mc._energy_rows(n, n_conf)
    ids = torch.arange(n, device=r.device)
    out = torch.zeros(n_conf, dtype=torch.float64, device=r.device)
    for p0 in range(0, n_conf, per):
        rp = r[p0:p0 + per]
        for i0 in range(0, n, tile):
            ri = rp[:, i0:i0 + tile]
            dist = min_image(ri[:, :, None, :] - rp[:, None, :, :],
                             box).norm(dim=-1)
            u = torch.where(dist > two_a, eps * torch.exp(-(dist - two_a) / b),
                            eps + eps * (two_a - dist) / b)
            term = u * (2.0 + (dist - two_a).abs() / b)
            live = ids[None, :] > ids[i0:i0 + ri.shape[1], None]
            out[p0:p0 + per] += torch.where(live, term, 0.0).sum(dim=(1, 2))
    return out * 2.0 ** -22


def m1_vs_plain(mc, r, kw):
    """M1 on r (P, n, 3) against its float64 plain version, twice
    bit-identical; float64 within 1e-12, float32 within the rounding of
    its terms' inputs (m1_term_bound) or twice the float32 plain
    version's error, each relative to the largest energy. Returns (max
    abs err, relative err, bound, repeat bit-identical, text of the
    float32 bound's parts)."""
    got = mc.blob_pair_energy(r, **kw)
    again = mc.blob_pair_energy(r, **kw)
    torch.cuda.synchronize()
    same = torch.equal(got, again)
    ref = mc.blob_blob_energy_plain(r.double(), **kw)
    scale = ref.abs().max().item()
    err = (got - ref).abs().max().item()
    plain_txt = ""
    if r.dtype == torch.float32:
        plain_rel = ((mc.blob_blob_energy_plain(r, **kw) - ref).abs().max()
                     .item() / scale)
        term_rel = m1_term_bound(mc, r, kw).max().item() / scale
        bound = max(term_rel, 2 * plain_rel)
        plain_txt = (f", term rounding {term_rel:.3e}, plain f32 "
                     f"{plain_rel:.3e}")
    else:
        bound = 1e-12
    return err, err / scale, bound, same, plain_txt


def shell_batch(n_conf, seed=0):
    """n_conf random configurations of one bench.py shell (positions
    uniform in the rejection sampler's box, uniform orientations), their
    blobs (n_conf, 12, 3) in float32 on the card."""
    from rigidmultiblobswall_tpu_torch.ops import quaternion as quat

    rng = np.random.default_rng(seed)
    box = 5.0 * (2 * 0.5 + 2 * A_BENCH)
    pos = torch.as_tensor(rng.uniform(0, box, (n_conf, 1, 3)))
    q = torch.as_tensor(rng.normal(size=(n_conf, 4)))
    R = quat.rotation_matrix(q / q.norm(dim=1, keepdim=True))
    blobs = pos + torch.einsum("pij,nj->pni", R,
                               torch.as_tensor(shell_vertices()))
    return blobs.to(torch.float32).to(DEVICE).contiguous()


def phase_m1_kernels(pk, mc, kin, make_state):
    """Phase 3, M1: the pair energy against its float64 plain version on a
    random ~3000-blob scene (blobs below a, a coincident distinct pair) in
    the open domain (the wall's instance too), an xy-periodic and a fully
    periodic box, both mask flavours, float32 and float64, twice
    bit-identical; then at phase 16's shapes in total_energy's flavour,
    float32 as the chain calls it and float64: the 49,152 blobs of phase
    6's scene (several tiles a group) and the rejection sampler's batch of
    4096 twelve-blob configurations, each timed in float32 with its plain
    version and its bound; the batch takes the small instance, timed
    beside the tile sweep on the same batch and an empty launch. Returns
    the two records."""
    from rigidmultiblobswall_tpu_torch.ops import _build

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(0)
    n = 3000
    r = np.empty((1, n, 3))
    r[0, :, :2] = rng.uniform(0, 20, (n, 2))
    r[0, :, 2] = rng.uniform(0.05, 4, n)
    r[0, 5] = r[0, 4]
    law = dict(repulsion_strength=0.2, debye_length=0.2, blob_radius=0.3)
    for box_name, box in M1_BOXES.items():
        for coincident in mc.COINCIDENT:
            kw = dict(law, periodic_length=box, coincident=coincident)
            for dtype in (torch.float32, torch.float64):
                rt = torch.as_tensor(r, dtype=dtype, device=dev)
                err, rel, bound, same, plain_txt = m1_vs_plain(mc, rt, kw)
                log(f"M1 {n} blobs {box_name} coincident={coincident} "
                    f"{dtype}: max err {err:.3e}, / max|ref| = {rel:.3e} "
                    f"(bound {bound:.2e}{plain_txt}); repeat bit-identical "
                    f"{same}")
                check(rel <= bound, f"M1 disagrees with plain at {n} blobs "
                      f"{box_name} {coincident} {dtype} ({rel:.3e})")
                check(same, f"M1 not bit-identical on repeat ({box_name}, "
                      f"{coincident}, {dtype})")

    system = bench_system(N_SHELLS)
    pos, quat = lattice(N_SHELLS)
    state = make_state(pos, quat, dtype=torch.float32, device=dev)
    r_main = kin.blob_positions(system, state)[None].contiguous()
    shapes = (("M1", r_main, f"{r_main.shape[1]} blobs"),
              ("M1_batch", shell_batch(N_MCMC_BATCH),
               f"{N_MCMC_BATCH} x 12 blobs"))
    records = {}
    kw = dict(repulsion_strength=0.2, debye_length=0.2,
              blob_radius=A_BENCH, coincident="one")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for key, rb, what in shapes:
        n_conf, nb = rb.shape[0], rb.shape[1]
        err, rel, bound, same, plain_txt = m1_vs_plain(mc, rb, kw)
        ms = cuda_ms(lambda: mc.blob_pair_energy(rb, **kw), 10)
        plain_ms = cuda_ms(lambda: mc.blob_blob_energy_plain(rb, **kw), 1)
        rec, pairs = m1_bound(nb, n_conf)
        groups, per = pk.plan_groups(nb, n_sm)
        f32_ms = pairs * ENERGY_PAIR_FLOPS / PEAK_F32_FLOPS * 1e3
        sfu_ms = pairs * ENERGY_PAIR_MUFU / PEAK_SFU_PER_S * 1e3
        small = nb <= mc.ENERGY_SMALL_MAX
        if small:
            # the small instance beside the tile sweep on the same batch,
            # and the floor an empty launch of the library sets
            tile_ms = cuda_ms(lambda: mc.energy_kernel(
                rb, **kw, periodic_length=(0.0, 0.0, 0.0), small=False), 10)
            lib = _build.library()
            stream = torch.cuda.current_stream(dev).cuda_stream
            floor_ms = cuda_ms(lambda: _build.check(
                "launch_floor", lib.launch_floor(stream)), 10)
            design = (f"the small instance, one warp a configuration, "
                      f"{n_conf} configurations in one launch (the tile "
                      f"sweep {tile_ms:.4f} ms; an empty launch "
                      f"{floor_ms:.4f} ms)")
            rec.update(launch_floor_ms=floor_ms, tile_sweep_ms=tile_ms)
        else:
            design = (f"{groups} tile groups of {per} tiles, "
                      f"{groups * (groups + 1) // 2} group pairs x {n_conf} "
                      f"configurations")
        log(f"M1 {what} f32 ({design}) vs plain f64: max err {err:.3e}, / "
            f"max|ref| = {rel:.3e} (bound {bound:.2e}{plain_txt}); repeat "
            f"bit-identical {same}; kernel {ms:.3f} ms, plain f32 "
            f"{plain_ms:.1f} ms; bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']}, {pairs} unordered pairs: float32 "
            f"{f32_ms:.4f} ms at {ENERGY_PAIR_FLOPS} a pair, special "
            f"functions {sfu_ms:.4f} ms at {ENERGY_PAIR_MUFU} a pair; "
            f"{rec['bound_ms'] / ms:.1%} of it)")
        check(rel <= bound, f"M1 disagrees at {what} ({rel:.3e})")
        check(same, f"M1 not bit-identical on repeat at {what}")
        # the float64 instance on the same blobs: at 49,152 blobs the only
        # shape whose groups hold several tiles
        err64, rel64, bound64, same64, _ = m1_vs_plain(mc, rb.double(), kw)
        log(f"M1 {what} f64 vs plain f64: max err {err64:.3e}, / max|ref| "
            f"= {rel64:.3e} (bound {bound64:.0e}); repeat bit-identical "
            f"{same64}")
        check(rel64 <= bound64, f"M1 f64 disagrees at {what} ({rel64:.3e})")
        check(same64, f"M1 f64 not bit-identical on repeat at {what}")
        records[key] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            design=("one warp a configuration, fixed-order float64 sums"
                    if small else "symmetric sweep over tile groups, "
                    "fixed-order float64 sums"), **rec)
    return records


def phase_mcmc_parity(mc):
    """Phase 4, MCMC: 64 shells of phase 6's lattice, 10 adaptive burn-in
    steps and a 40-step chain saved every 10, on the same draws fed (made
    on the CPU from a seed), the card (M1) in float64 against the CPU (the
    plain version) in float64: the same accepts, frames and energies to
    1e-9."""
    from rigidmultiblobswall_tpu_torch.models import mcmc
    from rigidmultiblobswall_tpu_torch.models.system import make_state

    system = bench_system(64)
    pos, quat = lattice(64, seed=4)
    gen = torch.Generator().manual_seed(4)
    draws = [mcmc.draw(system, gen, torch.float64, "cpu") for _ in range(50)]
    out = {}
    for dev in ("cpu", DEVICE):
        state = make_state(pos.astype(np.float64), quat.astype(np.float64),
                           device=dev)
        fed = [mcmc.Draws(*(x.to(dev) for x in d)) for d in draws]
        before = mc.ENERGY_LAUNCHES
        t0 = time.perf_counter()
        out[dev] = mcmc.run_mcmc(system, state, n_steps=40, save_every=10,
                                 initial_step=-10, draws=fed)
        out[dev + " s"] = time.perf_counter() - t0
        out[dev + " launches"] = mc.ENERGY_LAUNCHES - before
    (cm, ct, ce), (gm, gt, ge) = out["cpu"], out[DEVICE]
    err = max((gt.pos.cpu() - ct.pos).abs().max().item(),
              (gt.quat.cpu() - ct.quat).abs().max().item())
    e_err = ((ge.cpu() - ce).abs() / ce.abs()).max().item()
    moved = (ct.pos[-1] - torch.as_tensor(pos, dtype=torch.float64)
             ).abs().max().item()
    log(f"MCMC 64 shells x (10 burn-in + 40) steps, same draws, card f64 "
        f"({out[DEVICE + ' s']:.2f} s, {out[DEVICE + ' launches']} M1 "
        f"launches) vs CPU f64 ({out['cpu s']:.2f} s): accepted "
        f"{int(gm.accepted)} / {int(cm.accepted)}, frames {tuple(gt.pos.shape)}"
        f", max frame error {err:.3e} (bound 1e-9), energy relative error "
        f"{e_err:.3e} (bound 1e-9), largest move {moved:.3e}")
    check(int(gm.accepted) == int(cm.accepted) > 0, "MCMC accepts differ")
    check(out[DEVICE + " launches"] == 51, "MCMC chain did not run on M1")
    check(err <= 1e-9 and e_err <= 1e-9 and moved > 0, "MCMC card vs CPU")


def mcmc_inputs(scheme, save_clones, n_bodies, n_steps, kT):
    """make_inputs for run_cli_pair: a generated input of n_bodies shells
    of phase 6's physics (kT given) under an MCMC scheme, 10 burn-in steps
    then n_steps saved every 10 (n_estimate 2000 for the rejection
    sampler)."""
    pos, quat = lattice(n_bodies, seed=5)

    def inputs(dd):
        inp = write_shell_input(dd, pos, quat, (
            f"scheme {scheme}\nn_steps {n_steps}\nn_save 10\n"
            f"initial_step -10\nsave_clones {save_clones}\n"
            "n_estimate 2000\n"))
        with open(inp) as f:
            text = f.read().replace("kT 0.05", f"kT {kT}")
        with open(inp, "w") as f:
            f.write(text)
        return inp
    return inputs


def config_frames(text):
    """A .config file's frames, [(n, 7) arrays]."""
    lines = text.splitlines()
    frames, i = [], 0
    while i < len(lines):
        n = int(lines[i])
        frames.append(np.array([ln.split() for ln in lines[i + 1:i + 1 + n]],
                               dtype=float).reshape(n, 7))
        i += 1 + n
    return frames


def phase_mcmc_cli(mc):
    """Phase 5, MCMC: body_mcmc (one .config file) and MCMC (.clones
    files) on a generated 16-shell input, 10 burn-in and 40 chain steps,
    and body_mcmc_rejection (2 shells, 400 proposals, kT 1) through the
    CLI, card float64 against CPU float64 on the same seed
    (the two devices' generators draw differently): the same files
    (JAX's names: <output>.<type>.config or .<type>.<step>.clones, and
    .MCMC_info), frames (count, shape, finite, above the wall) and
    .MCMC_info fields; then examples/mcmc/inputMCMC.dat on the card in
    float32, its structure line pointed at a generated vertex file (a
    twelve-blob shell of radius 1) and clones file (16 shells)."""
    from rigidmultiblobswall_tpu_torch import cli

    for scheme, save, n_bodies, n_steps, kT in (
            ("body_mcmc", "one_file", 16, 40, 0.05),
            ("MCMC", "one_file_per_step", 16, 40, 0.05),
            ("body_mcmc_rejection", "one_file", 2, 400, 1.0)):
        out = run_cli_pair(mcmc_inputs(scheme, save, n_bodies, n_steps, kT))
        names = {k: set(v[0]) for k, v in out.items()}
        info = {k: dict(ln.split(" = ") for ln in
                        v[0]["run.MCMC_info"].splitlines())
                for k, v in out.items()}
        frames = {}
        for k, (files, _) in out.items():
            if save == "one_file":
                frames[k] = config_frames(files["run.shell.config"])
            else:
                frames[k] = [np.loadtxt(files[f].splitlines(), skiprows=1)
                             for f in sorted(files) if f.endswith(".clones")
                             and f.startswith("run.shell.")]
        want = {"MCMC": ["run.shell.%08d.clones" % s for s in (0, 10, 20,
                                                             30)]}
        log(f"MCMC CLI {scheme} {n_bodies} shells: {out['card'][1]:.2f} s "
            f"on the "
            f"card, {out['host'][1]:.2f} s on the CPU; frames "
            f"{len(frames['card'])} / {len(frames['host'])}; MCMC_info card "
            f"{info['card']}, CPU {info['host']}")
        check(names["card"] == names["host"], f"MCMC CLI {scheme}: files "
              f"{names['card'] ^ names['host']}")
        check(all(n in names["card"] for n in want.get(scheme, [])),
              f"MCMC CLI {scheme}: .clones names")
        check(list(info["card"]) == list(info["host"]),
              f"MCMC CLI {scheme}: .MCMC_info fields")
        if scheme != "body_mcmc_rejection":
            check(len(frames["card"]) == len(frames["host"]) == 4,
                  f"MCMC CLI {scheme}: frame count")
        check(len(frames["card"]) > 0 and all(
            f.shape == (n_bodies, 7) and np.all(np.isfinite(f)) and
            np.all(f[:, 2] > 0) for f in frames["card"]),
            f"MCMC CLI {scheme}: frames")
    # the example input, on the card in float32
    src = os.path.join(ROOT, "examples", "mcmc", "inputMCMC.dat")
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as d:
        with open(src) as f:
            text = [("structure shell.vertex shell.clones")
                    if ln.startswith("structure") else ln
                    for ln in f.read().splitlines()]
        with open(os.path.join(d, "inputMCMC.dat"), "w") as f:
            f.write("\n".join(text) + "\n")
        with open(os.path.join(d, "shell.vertex"), "w") as f:
            f.write("12\n")
            for x in shell_vertices(12, 1.0):
                f.write("%.16g %.16g %.16g\n" % tuple(x))
        with open(os.path.join(d, "shell.clones"), "w") as f:
            f.write("16\n")
            for i in range(16):
                f.write("%g %g 1.5 1 0 0 0\n" % (3.0 * (i % 4),
                                                  3.0 * (i // 4)))
        os.chdir(d)
        try:
            before = mc.ENERGY_LAUNCHES
            t0 = time.perf_counter()
            cli.main(["--input-file", "inputMCMC.dat", "--device", DEVICE])
            secs = time.perf_counter() - t0
            launches = mc.ENERGY_LAUNCHES - before
        finally:
            os.chdir(cwd)
        frames = config_frames(open(os.path.join(d, "run.shell.config"))
                               .read())
        info = open(os.path.join(d, "run.MCMC_info")).read()
    log(f"examples/mcmc/inputMCMC.dat on the card (f32, generated vertex "
        f"and clones files, 16 shells): {secs:.2f} s, {len(frames)} frames, "
        f"{launches} M1 launches; {' '.join(info.split())}")
    check(len(frames) == 10 and all(f.shape == (16, 7) and
                                    np.all(np.isfinite(f)) for f in frames),
          "the MCMC example's frames")
    check(launches == 301, f"the MCMC example made {launches} M1 launches")


def phase_mcmc_path(pk, mc):
    """Phase 16, multibody-49k-mcmc: the MCMC path at full width, phase
    6's scene (4096 shells, 49,152 blobs above the wall, bench.py's
    physics, kT 0.05) in float32 on the card: run_mcmc with 100 adaptive
    burn-in steps and 200 chain steps saved every 20, under
    torch.cuda.set_sync_debug_mode("error") (the chain makes no host sync
    between saved frames, nor anywhere in the run); ms per step,
    acceptance, the final d, M1's launches (one a step and one at the
    start; no other kernel), and the final energy against the plain
    version's energy of the final state (float64 sums on the same float32
    blobs; within the rounding of the terms' inputs, m1_term_bound, or
    twice the float32 plain version's error). Then run_rejection_sampler on one shell (kT 1) with
    n_estimate 100,000 and 20,000 proposals, in float32: proposals per
    second. Returns M1's launches of each."""
    from rigidmultiblobswall_tpu_torch.models import kinematics as kin
    from rigidmultiblobswall_tpu_torch.models import mcmc
    from rigidmultiblobswall_tpu_torch.models.system import make_state
    from rigidmultiblobswall_tpu_torch.ops import cell_kernels as ck

    t_phase = time.perf_counter()
    dev = torch.device(DEVICE)
    system = bench_system(N_SHELLS)
    pos, quat = lattice(N_SHELLS)
    state = make_state(pos, quat, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    n_burn, n_chain, save = 100, 200, 20
    pk.LAUNCHES.update(dict.fromkeys(pk.LAUNCHES, 0))
    mc.LAUNCHES = mc.PERIODIC_LAUNCHES = mc.ENERGY_LAUNCHES = 0
    reset_dense(mc)
    ck.LAUNCHES.update(dict.fromkeys(ck.LAUNCHES, 0))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        final, traj, energies = mcmc.run_mcmc(
            system, state, gen, n_steps=n_chain, save_every=save,
            initial_step=-n_burn)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = mc.ENERGY_LAUNCHES
    others = {"K1": sum(pk.LAUNCHES.values()), "K2": mc.LAUNCHES
              + mc.PERIODIC_LAUNCHES,
              "K3/K4": sum(dense_launches(mc).values()),
              "K5-K8": sum(ck.LAUNCHES.values())}
    moves = n_burn + n_chain
    accepted = int(final.accepted)
    # the plain version's energy of the final state, on the chain's own
    # float32 blobs: the one-body terms and the pair sum in float64
    energy = mcmc._Energy(system)
    rb = kin.blob_positions(system, final.state)
    kw = dict(repulsion_strength=system.repulsion_strength,
              debye_length=system.debye_length,
              blob_radius=system.blob_radius, coincident="one")
    one_body = float(energy.one_body(rb[None])[0])
    pair_ref = float(mc.blob_blob_energy_plain(rb[None].double(), **kw)[0])
    pair_f32 = float(mc.blob_blob_energy_plain(rb[None], **kw)[0])
    e_chain = float(final.energy)
    e_ref = one_body + pair_ref
    rel = abs(e_chain - e_ref) / abs(pair_ref)
    term = float(m1_term_bound(mc, rb[None], kw)[0])
    bound = max(term, 2 * abs(pair_f32 - pair_ref)) / abs(pair_ref)
    z_min = float(traj.pos[..., 2].min())
    log(f"multibody-49k-mcmc {system.num_blobs} blobs f32: {moves} steps "
        f"({n_burn} burn-in) in {secs:.3f} s, {secs / moves * 1e3:.3f} ms "
        f"per step; acceptance {accepted / moves:.4f} ({accepted} moves); "
        f"final d {float(final.max_translation):.6g} (start "
        f"{0.1 * system.blob_radius:.6g}); frames {tuple(traj.pos.shape)}, "
        f"lowest center {z_min:.4f}; M1 launches {launches} (other kernels "
        f"{others}); no host sync in the run; final energy {e_chain:.10g} "
        f"against the plain version's {e_ref:.10g} (one-body {one_body:.10g}"
        f", pairs {pair_ref:.10g}): relative to the pair energy {rel:.3e} "
        f"(bound {bound:.2e}: term rounding {term / abs(pair_ref):.3e}, "
        f"plain f32 pairs {pair_f32:.10g})")
    check(launches == moves + 1, f"M1 launched {launches} times over "
          f"{moves} MCMC steps (one a step and one at the start)")
    check(all(v == 0 for v in others.values()), f"MCMC launched {others}")
    check(0 < accepted < moves, f"MCMC accepted {accepted} of {moves}")
    check(traj.pos.shape == (n_chain // save, N_SHELLS, 3)
          and bool(torch.isfinite(traj.pos).all())
          and bool(torch.isfinite(energies).all()), "MCMC frames")
    check(rel <= bound, f"MCMC final energy {e_chain} against the plain "
          f"version's {e_ref} ({rel:.3e})")

    # the rejection sampler on one shell, 4096 proposals a launch
    one = bench_system(1, kT=1.0)
    n_est, n_prop = 100000, 20000
    before = mc.ENERGY_LAUNCHES
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    check(mcmc.REJECTION_BATCH == N_MCMC_BATCH, "the rejection sampler's "
          f"batch is {mcmc.REJECTION_BATCH}, phase 3 timed {N_MCMC_BATCH}")
    res = mcmc.run_rejection_sampler(
        one, torch.Generator(device=dev).manual_seed(1), n_steps=n_prop,
        n_estimate=n_est, dtype=torch.float32, device=dev)
    n_acc = int(res.accepted.sum())
    secs_rej = time.perf_counter() - t0
    batch_launches = mc.ENERGY_LAUNCHES - before
    want = -(-n_est // N_MCMC_BATCH) + -(-n_prop // N_MCMC_BATCH)
    log(f"rejection sampler, one shell, n_estimate {n_est}, {n_prop} "
        f"proposals, batches of {N_MCMC_BATCH}: {secs_rej:.3f} s, "
        f"{(n_est + n_prop) / secs_rej:.0f} proposals per second, "
        f"{batch_launches} M1 launches, accepted {n_acc}, minimum energy "
        f"{float(res.minimum_energy):.6g}")
    check(batch_launches == want, f"the rejection sampler made "
          f"{batch_launches} M1 launches, not {want}")
    check(0 < n_acc < n_prop and bool(torch.isfinite(res.energies).all()),
          "the rejection sampler's result")
    log(f"phase 16: {time.perf_counter() - t_phase:.1f} s")
    return {"M1": launches, "M1_batch": batch_launches}


# ---------------------------------------------------------------------------
# The inextensible fibers (ROADMAP Queue 1, item 18): phase 3's K1 tt
# record at the carpet's shape, phase 4's carpet card against CPU, phase
# 5's periodic suspension twin, phase 17
# ---------------------------------------------------------------------------

# the fibers example's physics (examples/fibers/run.py): fibers of length
# 2 and 31 links, a = ds / 2, kT 0.004142, k_bend = 4 x 2 x kT, dt = ds^3 /
# (m0 k_bend)
FIBER_LINKS = 31
FIBER_KT = 0.004142
# 17a: 4096 free fibers, 131,072 blobs
N_FREE_FIBERS = 4096
# 17b: a carpet of 32 x 32 fibers clamped above the wall, 32,768 blobs, at
# lattice spacing 0.5 with bases at 1.5 a, each tilted 0.3 rad off +z
CARPET_SIDE = 32
CARPET_SPACING = 0.5
CARPET_TILT = 0.3
# phase 4's carpet (8 x 8, 2048 blobs) and its solver tolerance
CARPET_PARITY_SIDE = 8
CARPET_PARITY_TOL = 1e-5


def carpet(side, dtype, device, **overrides):
    """(suspension, state, dt) of a side x side carpet of clamped fibers
    above the wall in the fibers example's physics: full hydrodynamics,
    Crank-Nicolson noise, tolerance 1e-4."""
    from rigidmultiblobswall_tpu_torch.models import fibers as fib

    ds = 2.0 / FIBER_LINKS
    a = ds / 2.0
    kw = dict(num_fibers=side * side, num_links=FIBER_LINKS, ds=ds, a=a,
              k_bend=8.0 * FIBER_KT, kT=FIBER_KT, impl_c=0.5, clamp=True,
              t_fix=(0.0, 0.0, 1.0), hydrodynamics="full",
              domain="single_wall", solver_tolerance=1e-4)
    kw.update(overrides)
    sus = fib.FiberSuspension(**kw)
    idx = np.arange(side * side)
    x0 = np.stack([(idx % side) * CARPET_SPACING,
                   (idx // side) * CARPET_SPACING,
                   np.full(side * side, 1.5 * a)], axis=1)
    tilt = [np.sin(CARPET_TILT), 0.0, np.cos(CARPET_TILT)]
    state = fib.straight_fiber_state(sus, x0, tilt, dtype=dtype,
                                     device=device)
    return sus, state, (ds ** 3 / sus.m0) / sus.k_bend


def phase_fiber_kernels(pk, mob):
    """Phase 3 at phase 17b's shape: K1 tt at the carpet's 32,768 blobs
    (lengths in units of the fibers' a, the wall's shifted heights), as
    the full mode calls it (the square product), against its plain
    version (k1_full_record). Returns the record."""
    from rigidmultiblobswall_tpu_torch.models import fibers as fib

    dev = torch.device(DEVICE)
    sus, state, _ = carpet(CARPET_SIDE, torch.float32, dev)
    r = fib.blob_positions(sus, state).reshape(-1, 3)
    q = (mob.shift_heights(r, sus.a) / sus.a).contiguous()
    g = torch.Generator(device=dev).manual_seed(17)
    v = torch.randn((q.shape[0], 3), generator=g, device=dev)
    return k1_full_record(pk, "tt", q, v, 1024, u32_sqrt(q.shape[0]),
                          f"{q.shape[0]} blobs in fibers")


def fiber_step_positions(dtype, device):
    """One deterministic full-mode step of phase 4's carpet at tolerance
    CARPET_PARITY_TOL: (start, end) blob positions as float64 numpy, and
    the step's aux."""
    from rigidmultiblobswall_tpu_torch.models import fibers as fib

    sus, state, dt = carpet(CARPET_PARITY_SIDE, dtype, device, kT=0.0,
                            solver_tolerance=CARPET_PARITY_TOL)
    new, aux = fib.make_stepper(sus, dt)(state)
    return (fib.blob_positions(sus, state).double().cpu().numpy(),
            fib.blob_positions(sus, new).double().cpu().numpy(), aux)


def phase_fiber_parity():
    """Phase 4, fibers: one deterministic full-mode step of an 8 x 8
    carpet (2048 blobs, K1 tt on the card), card float32 against CPU
    float64. The bound on the largest position error: each position a
    sum of L + 1 = 32 float32 terms (x0 and the links), rounded at most
    half an ulp of max|x| a term, in the start and the end state (2^-24
    max|x| 2 (L + 1)), plus the solve's accuracy, 10 x the tolerance of
    the largest displacement."""
    start64, end64, aux64 = fiber_step_positions(torch.float64, "cpu")
    start32, end32, aux32 = fiber_step_positions(torch.float32, DEVICE)
    disp = np.abs(end64 - start64).max()
    err = np.abs(end32 - end64).max()
    bound = (2.0 ** -24 * np.abs(end64).max() * 2 * (FIBER_LINKS + 1)
             + 10 * CARPET_PARITY_TOL * disp)
    side = CARPET_PARITY_SIDE
    log(f"fibers parity, {side} x {side} clamped carpet "
        f"({side ** 2 * (FIBER_LINKS + 1)} blobs), one deterministic "
        f"full-mode step at tolerance {CARPET_PARITY_TOL}: max displacement "
        f"{disp:.4e}, card f32 vs CPU f64 max error {err:.3e} = "
        f"{err / disp:.3e} of it (bound {bound:.3e} = {bound / disp:.3e} "
        f"of it); GMRES "
        f"{aux32.iterations} (f64 {aux64.iterations}), converged "
        f"{aux32.converged}")
    check(disp > 0 and err <= bound and aux32.converged and aux64.converged,
          f"fibers parity: error {err:.3e} above {bound:.3e}")


def phase_twin_cli():
    """Phase 5, the periodic suspension example's twin at its default size
    (64 shells, 50 Slip-Trapz steps on the spectral engine) through its
    main(): its two summary lines, finite counts."""
    import contextlib
    import io

    from rigidmultiblobswall_tpu_torch.examples import periodic_suspension_run

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        periodic_suspension_run.main([])
    lines = buf.getvalue().splitlines()
    log(f"periodic_suspension_run (64 shells, 50 steps) on the card in "
        f"{time.perf_counter() - t0:.1f} s: {lines[-2]}; {lines[-1]}")
    check(lines[-2].startswith("64 bodies, 50 steps: det iters ")
          and lines[-1].startswith("g(r): first peak at r = "),
          f"periodic_suspension_run printed {lines[-2:]}")


def _reset_counts(pk, mc, ck, lap):
    pk.LAUNCHES.update(dict.fromkeys(pk.LAUNCHES, 0))
    pk.IMAGE_LAUNCHES.update(dict.fromkeys(pk.IMAGE_LAUNCHES, 0))
    mc.RADII_LAUNCHES.update(dict.fromkeys(mc.RADII_LAUNCHES, 0))
    pk.SYM_LAUNCHES.update(dict.fromkeys(pk.SYM_LAUNCHES, 0))
    mc.LAUNCHES = mc.PERIODIC_LAUNCHES = mc.ENERGY_LAUNCHES = 0
    mc.ONE_BOX_LAUNCHES = 0
    reset_dense(mc)
    ck.LAUNCHES.update(dict.fromkeys(ck.LAUNCHES, 0))
    lap.LAUNCHES.update(dict.fromkeys(lap.LAUNCHES, 0))


def reset_dense(mc):
    """Sets the launch counts of K3 (by instance) and K4 to 0."""
    mc.DENSE_TT_LAUNCHES.update(dict.fromkeys(mc.DENSE_TT_LAUNCHES, 0))
    mc.SYMM_LAUNCHES = 0


def dense_launches(mc):
    """K3's launches outside image boxes (any domain mode) and K4's."""
    return {"dense_tt": sum(k for (_, img), k in mc.DENSE_TT_LAUNCHES.items()
                            if not img),
            "symm_matvec": mc.SYMM_LAUNCHES}


def dense_image_launches(mc):
    """K3's launches in image boxes (any domain mode)."""
    return sum(k for (_, img), k in mc.DENSE_TT_LAUNCHES.items() if img)


def p1_open_launches(mc):
    """P1's launches outside image boxes on the wall and in the open
    domain, by B (phase 18's instances)."""
    return {b: sum(k for (kb, m, img), k in mc.RADII_LAUNCHES.items()
                   if kb == b and m != "free_surface" and not img)
            for b in range(1, mc.RADII_MAX_RHS + 1)}


def _other_launches(pk, mc, ck, lap, allowed=()):
    """Launches of every kernel but those in `allowed` ((coupling, B) keys
    of K1)."""
    return {"K1": sum(n for k, n in pk.LAUNCHES.items() if k not in allowed),
            "K2": mc.LAUNCHES + mc.PERIODIC_LAUNCHES,
            "K3/K4": sum(mc.DENSE_TT_LAUNCHES.values()) + mc.SYMM_LAUNCHES,
            "K5-K8": sum(ck.LAUNCHES.values()),
            "L1": sum(lap.LAUNCHES.values()), "M1": mc.ENERGY_LAUNCHES,
            "P1": sum(mc.RADII_LAUNCHES.values())}


def _timed_steps(step, state, gen, n):
    """Host-clock ms of n steps, each bracketed by torch.cuda.synchronize(),
    with the last (state, aux) appended."""
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, aux = step(state, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times + [(state, aux)]


def _fmt(times):
    return ", ".join(f"{t:.1f}" for t in times)


def phase_fiber_path(pk, mc):
    """Phase 17: 17a, the fibers example's twin at 4096 free fibers
    (batched hydrodynamics: no K kernel), and 17b, the 32 x 32 clamped
    carpet on full hydrodynamics (K1 tt on its symmetric sweep in every
    product), float32, one warm-up and three timed steps each. Returns
    K1 tt's launches over 17b's steps."""
    from rigidmultiblobswall_tpu_torch.examples import fibers_run
    from rigidmultiblobswall_tpu_torch.models import fibers as fib
    from rigidmultiblobswall_tpu_torch.ops import cell_kernels as ck
    from rigidmultiblobswall_tpu_torch.ops import laplace as lap

    t_phase = time.perf_counter()
    dev = torch.device(DEVICE)

    # 17a: the twin's own run, then its stepper timed
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "end_to_end_distances.txt")
        t0 = time.perf_counter()
        fibers_run.main(["--fibers", str(N_FREE_FIBERS), "--links",
                         str(FIBER_LINKS), "--steps", "4", "--save-every",
                         "2", "--output", out])
        twin_s = time.perf_counter() - t0
        e2e = np.loadtxt(out)
    check(e2e.shape == (2, N_FREE_FIBERS) and np.isfinite(e2e).all()
          and e2e.max() <= 2.0 + 1e-4, f"fibers_run wrote {e2e.shape}")
    sus, state, dt = fibers_run.build(N_FREE_FIBERS, FIBER_LINKS, FIBER_KT,
                                      dtype=torch.float32, device=dev)
    step = fib.make_stepper(sus, dt)
    gen = torch.Generator(device=dev).manual_seed(17)
    _reset_counts(pk, mc, ck, lap)
    held = torch.cuda.memory_allocated()
    reserved = torch.cuda.memory_reserved() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    state, _ = step(state, gen)
    step_ms = _timed_steps(step, state, gen, 3)
    state, aux = step_ms.pop()
    ms_a = sum(step_ms) / 3
    peak_a = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
    # the same steps with the caching allocator emptied: earlier phases
    # leave it holding blocks of their own sizes
    torch.cuda.empty_cache()
    empty_ms = _timed_steps(step, state, gen, 3)
    state, aux = empty_ms.pop()
    others = _other_launches(pk, mc, ck, lap)
    unit = float((torch.linalg.norm(state.t, dim=-1) - 1).abs().max())
    pos = fib.blob_positions(sus, state)
    log(f"fibers-4k-batched (17a) {sus.num_blobs} blobs f32, the fibers "
        f"example's physics (backward-Euler noise, dt {dt:.4e}): the twin's "
        f"4-step run {twin_s:.1f} s (mean end-to-end {e2e[-1].mean():.4f}); "
        f"{ms_a:.1f} ms/step over 3 steps ({_fmt(step_ms)}; after "
        f"torch.cuda.empty_cache() {_fmt(empty_ms)}), peak device memory "
        f"{peak_a:.2f} GiB above the {held / 2 ** 30:.2f} GiB earlier phases "
        f"hold ({reserved:.2f} GiB reserved), max ||t| - 1| {unit:.2e}, "
        f"residual {float(aux.residual):.2e}, launches {others}")
    check(unit < 1e-5 and bool(torch.isfinite(pos).all())
          and bool(aux.converged), "fibers-4k-batched: state or solve")
    check(all(n == 0 for n in others.values()),
          f"fibers-4k-batched launched {others}")

    # 17b: the carpet on K1 tt
    sus, state, dt = carpet(CARPET_SIDE, torch.float32, dev)
    step = fib.make_stepper(sus, dt)
    gen = torch.Generator(device=dev).manual_seed(18)
    x0 = state.x0.clone()
    _reset_counts(pk, mc, ck, lap)
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    state, aux = step(state, gen)                       # warm-up
    warm = pk.LAUNCHES["tt", 1]
    torch.cuda.synchronize()
    per_step = []
    t0 = time.perf_counter()
    for _ in range(3):
        before = pk.LAUNCHES["tt", 1]
        state, aux = step(state, gen)
        per_step.append((aux.iterations, aux.lanczos_iterations,
                         bool(aux.converged),
                         pk.LAUNCHES["tt", 1] - before))
    torch.cuda.synchronize()
    ms_b = (time.perf_counter() - t0) / 3 * 1e3
    peak_b = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
    launches = pk.LAUNCHES["tt", 1]
    sym = pk.SYM_LAUNCHES["tt", 1]
    others = _other_launches(pk, mc, ck, lap, allowed=(("tt", 1),))
    pos = fib.blob_positions(sus, state)
    unit = float((torch.linalg.norm(state.t, dim=-1) - 1).abs().max())
    z_min = float(pos[..., 2].min())
    log(f"fibers-carpet-32k (17b) {sus.num_blobs} blobs f32, {CARPET_SIDE} "
        f"x {CARPET_SIDE} clamped fibers, full hydrodynamics, "
        f"Crank-Nicolson, tolerance {sus.solver_tolerance}: {ms_b:.1f} ms/step over 3 steps; (GMRES, "
        f"Lanczos iterations, converged, K1 tt launches) per step "
        f"{per_step}, warm-up {warm} launches; K1 tt {launches} launches "
        f"over the 4 steps, {sym} on the symmetric sweep; other kernels "
        f"{others}; peak device memory {peak_b:.2f} GiB above what earlier "
        f"phases hold; max ||t| - 1| "
        f"{unit:.2e}; lowest blob {z_min:.4f} (a = {sus.a:.4f})")
    check(all(c for _, _, c, _ in per_step), "fibers-carpet-32k: a solve "
          f"did not converge: {per_step}")
    check(all(k == 3 + g + lz for g, lz, _, k in per_step),
          f"fibers-carpet-32k: K1 tt launches a step {per_step} are not "
          "the right-hand side, both Lanczos chains, the two RFD products "
          "and the GMRES iterations")
    check(launches > 0 and sym == launches, f"fibers-carpet-32k: {sym} of "
          f"{launches} K1 tt launches on the symmetric sweep")
    check(all(n == 0 for n in others.values()),
          f"fibers-carpet-32k launched {others}")
    check(bool(torch.isfinite(pos).all()) and unit < 1e-5 and z_min > 0,
          "fibers-carpet-32k: state")
    check(torch.equal(state.x0, x0), "fibers-carpet-32k: a clamped base "
          "moved")
    log(f"phase 17: {time.perf_counter() - t_phase:.1f} s")
    return {"K1 tt": launches}


# ---------------------------------------------------------------------------
# Per-blob and mixed blob radii (ROADMAP Queue 1, items 4 and 15): phase
# 3's P1 and P2 against their plain versions, phase 4's bidisperse slice,
# phase 5's four-column CLI inputs, phases 18 and 19
# ---------------------------------------------------------------------------

# the two shells of the mixture: bench.py's (radius 0.5, blob radius
# 0.131) and a 1.2x one (radius 0.6, blob radius 0.157)
RADII_SHELLS = ((0.5, A_BENCH), (0.6, 0.157))
# P1's float32 operations per unordered pair, counted from
# csrc/pair_radii.cu (an FMA as 2): make_geo 11 and the far RPY form of
# condense 13 for a pair outside contact (the far path, condense<FULL =
# false>), 27 more for the overlapping and inside regimes selected over it
# (the full path: the pairs inside contact and the self pairs), the wall
# image system 80 on either path; applying the block both ways (diag_apply
# and diag_apply_t, 18 each) per right-hand side; its special functions:
# the rsqrt of r^2 and, with the wall, of R^2
P1_FAR_FLOPS = {True: 104, False: 24}
P1_NEAR_FLOPS = 27
P1_APPLY_FLOPS = 36
P1_PAIR_MUFU = {True: 2, False: 1}
# the all-regime count: every pair's three RPY regimes ~56 and five wall
# terms ~124 term by term, a reciprocal beside the two rsqrt; the bound
# that P1's shares were taken against before the far path, kept so that
# shares of the two designs compare
P1_ALL_REGIMES_FLOPS = 180
P1_ALL_REGIMES_MUFU = 3


def p1_bound(n, contacts, n_rhs, wall=True):
    """P1's bound records over n blobs with `contacts` unordered pairs of
    distinct blobs inside contact: (the bound of these inputs, the far
    form for the pairs outside contact and the full one for those inside
    and the n self pairs; the bound by the all-regime count)."""
    pairs = n * (n + 1) // 2
    near = contacts + n
    flops = (pairs * (P1_FAR_FLOPS[wall] + P1_APPLY_FLOPS * n_rhs)
             + near * P1_NEAR_FLOPS)
    nbytes = 4 * n * (4 + 2 * 3 * n_rhs)
    rec = bound_record(nbytes, flops, pairs * P1_PAIR_MUFU[wall])
    every = bound_record(nbytes, pairs * (P1_ALL_REGIMES_FLOPS
                                          + P1_APPLY_FLOPS * n_rhs),
                         pairs * P1_ALL_REGIMES_MUFU)
    return rec, every


# P2 beyond K6's per-pair count: the piece map (two compares, a select and
# the (mid, 2 / width) multiply-add)
P2_PIECE_FLOPS = 6
# P2's list (csrc/near_radii.cu pairs_kernel), an FMA as 2: a candidate's
# three differences, r^2 (5) and its compare with r_cut^2
P2_LIST_CAND_FLOPS = 9


def p2_product_bound(n, inside, listed, K, n_rhs):
    """P2's product bound record: the pairs inside r_cut at K6's count
    with the piece map (8 + 6 + 6 + 6K + 18 B operations), against the
    bytes of the list (offsets and entries), the rows (N, 4), the
    strengths in and the rows out, each once."""
    flops = inside * (8 + P2_PIECE_FLOPS + 6 + 6 * K + 18 * n_rhs)
    nbytes = 4 * (n + 1 + listed) + 4 * n * (4 + 2 * 3 * n_rhs)
    return bound_record(nbytes, flops)


def p2_list_bound(n, cand, listed, table):
    """P2's list bound record: every candidate pair of the stencils tested
    once (P2_LIST_CAND_FLOPS), against the bytes of the positions, groups
    and cell table read once and of the offsets, entries and rows (N, 4)
    written once."""
    nbytes = 4 * n * (3 + 1) + 4 * table.numel() + 4 * (n + 1 + listed) \
        + 16 * n
    return bound_record(nbytes, cand * P2_LIST_CAND_FLOPS)


def instance_registers(report, *needles):
    """The ptxas line of the kernel instance whose name holds every needle
    (the registers and spills of the build), or "not in this build's
    report" when the library was reused."""
    for line in report:
        if all(n in line for n in needles):
            return line.split(": ", 1)[1]
    return "not in this build's report"


def radii_vertex_files(d):
    """The mixture's two four-column .vertex files in directory d; returns
    their paths (small, big)."""
    paths = []
    for name, (radius, a) in zip(("small", "big"), RADII_SHELLS):
        path = os.path.join(d, f"{name}.vertex")
        with open(path, "w") as f:
            f.write("12\n")
            for x in shell_vertices(12, radius):
                f.write("%.16g %.16g %.16g %.16g\n" % (*x, a))
        paths.append(path)
    return paths


def radii_system(n_bodies, **overrides):
    """bench_system's physics with the mixture, read from its four-column
    .vertex files: the first n_bodies // 2 bodies the small shells, the
    rest the big ones."""
    from rigidmultiblobswall_tpu_torch.io import scene
    from rigidmultiblobswall_tpu_torch.models.system import BodyType

    system = bench_system(n_bodies, **overrides)
    n_small = n_bodies - n_bodies // 2
    with tempfile.TemporaryDirectory() as d:
        refs = [scene.read_vertex_file(p) for p in radii_vertex_files(d)]
    types = tuple(BodyType(name=name, ref_config=ref[:, :3], count=count,
                           blob_radii=ref[:, 3])
                  for name, ref, count in zip(
                      ("shell", "big"), refs, (n_small, n_bodies - n_small)))
    return dataclasses.replace(system, types=types)


def alternate(pos, quat):
    """A lattice's bodies in the mixture's type order: the even sites (the
    small shells) first, then the odd ones, so neighbors alternate."""
    order = np.concatenate([np.arange(0, len(pos), 2),
                            np.arange(1, len(pos), 2)])
    return pos[order], quat[order]


def blob_contacts(r, radii):
    """The smallest surface gap r_ij - a_i - a_j over the distinct blob
    pairs (negative where blobs overlap) and the number of unordered pairs
    of distinct blobs inside contact (gap <= 0), in row chunks on the
    card."""
    gap, contacts = float("inf"), 0
    for i0 in range(0, r.shape[0], 4096):
        d = torch.cdist(r[i0:i0 + 4096].double(), r.double())
        d = d - radii[i0:i0 + 4096, None].double() - radii[None].double()
        idx = torch.arange(i0, min(i0 + 4096, r.shape[0]), device=r.device)
        d[idx - i0, idx] = float("inf")
        gap = min(gap, float(d.min()))
        contacts += int((d <= 0).sum())
    return gap, contacts // 2


def p1_vs_plain(mc, r, v, radii, wall, sub=None):
    """P1 against its float64 plain version (the source-target product,
    the first `sub` targets), twice bit-identical; with float32 inputs also
    the float32 plain version's error. Returns (max err, max|ref|, plain
    f32 err or None, bit-identical)."""
    domain = "single_wall" if wall else "no_wall"
    got = mc.radii_matvec(r, v, radii, 1.0, domain=domain)
    same = torch.equal(got, mc.radii_matvec(r, v, radii, 1.0,
                                            domain=domain))
    torch.cuda.synchronize()
    rt = r if sub is None else r[:sub]
    at = radii if sub is None else radii[:sub]

    def plain(dtype):
        from rigidmultiblobswall_tpu_torch.ops import mobility as mob

        return torch.stack([mob.source_target_matvec(
            r.to(dtype), rt.to(dtype), vb.to(dtype), radii.to(dtype),
            at.to(dtype), 1.0, wall=wall) for vb in v])

    ref = plain(torch.float64)
    got = got if sub is None else got[:, :sub]
    err = (got.double() - ref).abs().max().item()
    p32 = None
    if r.dtype == torch.float32:
        p32 = (plain(torch.float32).double() - ref).abs().max().item()
    return err, ref.abs().max().item(), p32, same


def phase_radii_kernels(mc, report):
    """Phase 3, P1 and P2. P1 against its float64 plain version on a random
    ~3000-blob scene above the wall with radii in [0.08, 0.3] (blobs below
    their radius; a coincident pair of unequal radii, one blob inside
    another, overlapping pairs), wall on and off, B = 1 and 2, float64 to
    1e-12 and float32 within 3e-6 x max|ref| or twice the float32 plain
    version's error (printed beside it), each twice bit-identical; then at
    phase 18's shape (49,152 blobs, the first 1024 targets), B = 1 and 2,
    timed with its plain version and its bound. Returns P1's two records
    (P2 is phase_p2_small's and phase 19's)."""
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(0)
    n = 3000
    r = np.empty((n, 3))
    r[:, :2] = rng.uniform(0, 20, (n, 2))
    r[:, 2] = rng.uniform(0.05, 4, n)
    rad = rng.uniform(0.08, 0.3, n)
    r[5] = r[4]                                  # coincident, unequal radii
    r[7], rad[6], rad[7] = r[6] + 0.01, 0.1, 0.3  # one inside the other
    r[9] = r[8] + 0.2                            # overlapping
    for n_rhs in (1, 2):
        v = rng.normal(size=(n_rhs, n, 3))
        for wall in (True, False):
            for dtype in (torch.float32, torch.float64):
                args = [torch.as_tensor(x, dtype=dtype, device=dev)
                        for x in (r, v, rad)]
                err, scale, p32, same = p1_vs_plain(mc, args[0], args[1],
                                                    args[2], wall)
                bound = (1e-12 if dtype == torch.float64
                         else max(3e-6, 2 * p32 / scale))
                plain_txt = ("" if p32 is None else
                             f", the f32 plain version's {p32 / scale:.3e}")
                log(f"P1 {n} blobs B={n_rhs} wall={wall} {dtype}: max err / "
                    f"max|ref| = {err / scale:.3e} (bound {bound:.2e}"
                    f"{plain_txt}); repeat bit-identical {same}")
                check(err <= bound * scale, f"P1 disagrees with plain "
                      f"({err / scale:.3e}, B={n_rhs}, wall={wall}, {dtype})")
                check(same, f"P1 not bit-identical on repeat (B={n_rhs}, "
                      f"wall={wall}, {dtype})")

    # phase 18's shape
    from rigidmultiblobswall_tpu_torch.models import kinematics as kin
    from rigidmultiblobswall_tpu_torch.models.system import make_state
    from rigidmultiblobswall_tpu_torch.ops import pair_kernels as pk

    system = radii_system(N_SHELLS)
    pos, quat = alternate(*lattice(N_SHELLS))
    state = make_state(pos, quat, dtype=torch.float32, device=dev)
    rb = kin.blob_positions(system, state).contiguous()
    radii = torch.tensor(system.blob_radii, dtype=torch.float32, device=dev)
    nb = rb.shape[0]
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    groups, per = pk.plan_groups(nb, n_sm)
    gap, contacts = blob_contacts(rb, radii)
    log(f"P1 at phase 18's shape: smallest blob surface gap {gap:.4f}, "
        f"{contacts} pairs of distinct blobs inside contact")
    g = torch.Generator(device=dev).manual_seed(18)
    sub = 1024
    records = {}
    for n_rhs in (1, 2):
        v = torch.randn((n_rhs, nb, 3), generator=g, device=dev)
        err, scale, p32, same = p1_vs_plain(mc, rb, v, radii, True, sub)
        bound = max(u32_sqrt(nb), 2 * p32 / scale)
        ms = cuda_ms(lambda: mc.radii_matvec(rb, v, radii, 1.0,
                                             domain="single_wall"),
                     10)
        plain_ms = cuda_ms(lambda: mc.radii_matvec_plain(
            rb, v, radii, 1.0, domain="single_wall"), 1, warmup=False)
        pairs = nb * (nb + 1) // 2
        rec, every = p1_bound(nb, contacts, n_rhs)
        regs = instance_registers(report, "radii_sym_kernel",
                                  f"<float, {n_rhs}, 1, ", "RadiiOpen")
        plan = f"{groups} tile groups of {per} tiles"
        log(f"P1 {nb} blobs (phase 18's mixture) B={n_rhs} f32, the "
            f"symmetric sweep ({plan}): first {sub} target rows vs plain "
            f"f64 max err {err:.3e}, / max|ref| = {err / scale:.3e} (bound "
            f"{bound:.2e}: u32 sqrt(N) or twice the f32 plain version's "
            f"{p32 / scale:.3e}); repeat bit-identical {same}; kernel "
            f"{ms:.3f} ms, plain f32 {plain_ms:.1f} ms; bound "
            f"{rec['bound_ms']:.3f} ms ({rec['bound_by']}, {pairs} unordered "
            f"pairs, {contacts} of distinct blobs inside contact: "
            f"{P1_FAR_FLOPS[True] + P1_APPLY_FLOPS * n_rhs} operations and "
            f"{P1_PAIR_MUFU[True]} special functions a pair, "
            f"{P1_NEAR_FLOPS} more a pair inside contact or self; "
            f"{rec['bound_ms'] / ms:.1%} of it); the all-regime count "
            f"({P1_ALL_REGIMES_FLOPS + P1_APPLY_FLOPS * n_rhs} operations a "
            f"pair) {every['bound_ms']:.3f} ms, "
            f"{every['bound_ms'] / ms:.1%} of it; "
            f"ptxas {regs}")
        check(err <= bound * scale, f"P1 disagrees at {nb} blobs B={n_rhs}")
        check(same, f"P1 not bit-identical on repeat at {nb} blobs")
        records[n_rhs] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                              registers=regs, plan=plan, **rec)
    return records


def p2_vs_plain(ck, plan, f, cells_range=None):
    """P2's product over the plan's list against the float64 plain sweep
    (the walk's plain version) on the plan's cells (or cells_range),
    twice bit-identical and bit-identical to the stateless call (its own
    list); with float32 inputs also the float32 plain version's error.
    Returns (max err, max|ref|, plain f32 err or None, bit-identical)."""
    p = plan.params
    args = (plan.cell_table, plan.cell_dims, p.box, p.cell_capacity)
    call = (plan.positions, f, plan.group_of, *args, plan.cheb_radii,
            plan.radii_edges)
    got = ck.near_rpy_radii(*call, r_cut=p.r_cut, pairs=plan.radii_pairs)
    same = (torch.equal(got, ck.near_rpy_radii(*call, r_cut=p.r_cut,
                                               pairs=plan.radii_pairs))
            and torch.equal(got, ck.near_rpy_radii(*call, r_cut=p.r_cut)))
    torch.cuda.synchronize()
    def plain(dtype):
        return ck.near_rpy_radii_plain(
            plan.positions.to(dtype), f.to(dtype), plan.group_of, *args,
            plan.cheb_radii.to(dtype), plan.radii_edges, r_cut=p.r_cut,
            cells_range=cells_range)

    ref = plain(torch.float64)
    rows = _rows_of(plan.cell_table, f.shape[0], p.cell_capacity,
                    cells_range)
    err = (got.double()[rows] - ref[rows]).abs().max().item()
    p32 = None
    if f.dtype == torch.float32:
        p32 = (plain(torch.float32).double()[rows]
               - ref[rows]).abs().max().item()
    return err, ref[rows].abs().max().item(), p32, same


def p2_list_vs_plain(ck, plan, cells_range=None):
    """P2's list (the plan's, and a second build bit-identical to it)
    against the plain list's in float64 on the plan's cells (or
    cells_range): the same entries in the same order but for pairs within
    the positions' rounding of r_cut (|r^2 / r_cut^2 - 1| <= 8 ulps), each
    counted. Returns (pairs of those targets in the list, pairs that
    differ, the largest |r - r_cut| of one of them (0 when none), the
    second build bit-identical)."""
    p = plan.params
    got = plan.radii_pairs
    again = ck.near_radii_pairs(plan.positions, plan.group_of,
                                plan.cell_table, plan.cell_dims, p.box,
                                p.cell_capacity, r_cut=p.r_cut)
    same = (torch.equal(got.offsets, again.offsets)
            and torch.equal(got.entries, again.entries))
    ref = ck.near_radii_pairs_plain(
        plan.positions.double(), plan.group_of, plan.cell_table,
        plan.cell_dims, p.box, p.cell_capacity, r_cut=p.r_cut,
        cells_range=cells_range)
    rows = _rows_of(plan.cell_table, plan.positions.shape[0],
                    p.cell_capacity, cells_range)
    mine = torch.zeros(plan.positions.shape[0], dtype=torch.bool,
                       device=rows.device)
    mine[rows] = True

    n = plan.positions.shape[0]

    def keys(pairs):
        """(target, image code, source) of each pair of those targets, as
        one int64, in the list's order"""
        tid, sid, wrap = ck.decode_pairs(pairs)
        keep = mine[tid]
        code = ((wrap[keep, 0] + 1) * 9 + (wrap[keep, 1] + 1) * 3
                + wrap[keep, 2] + 1)
        return (tid[keep] * 27 + code) * n + sid[keep]

    kg, kr = keys(got), keys(ref)
    differ = torch.cat([kg[~torch.isin(kg, kr)], kr[~torch.isin(kr, kg)]])
    worst = 0.0
    if differ.numel():
        tid, sid = differ // n // 27, differ % n
        code = differ // n % 27
        wrap = torch.stack([code // 9, code // 3 % 3, code % 3], 1) - 1
        pos = plan.positions.double()
        d = pos[tid] - pos[sid] - wrap.double() * torch.tensor(
            p.box, dtype=torch.float64, device=pos.device)
        r = d.norm(dim=1)
        worst = float((r - p.r_cut).abs().max())
        ulps = float(((r / p.r_cut) ** 2 - 1).abs().max()) / float(
            torch.finfo(plan.positions.dtype).eps)
        check(ulps <= 8, f"P2 list: a pair {ulps:.1f} ulps from r_cut "
              "differs from the plain list")
    common_g = kg[torch.isin(kg, kr)]
    common_r = kr[torch.isin(kr, kg)]
    check(torch.equal(common_g, common_r), "P2 list: the order of the "
          "pairs differs from the plain list's")
    return kg.numel(), int(differ.numel()), worst, same


def p2_list_text(listed, differ, worst, same):
    return (f"{listed} pairs, {differ} differing from the plain list "
            f"(float64) within rounding of r_cut (largest |r - r_cut| "
            f"{worst:.3e}); a second build bit-identical {same}")


def phase_p2_small(ck, ewald):
    """Phase 3, P2 on a random periodic box of 3000 blobs in three radius
    groups (a coincident pair, a pair one inside the other): the plan's
    pair list against the plain list's in float64, then the product
    over it with B = 1 and 2, float32 at 3e-6 x max|ref| (or twice the
    float32 plain version's error, printed beside it) and float64 at
    1e-12 against the plain sweep in float64, twice bit-identical and
    bit-identical to the stateless call; in float32 the build and the
    product (B = 1) timed apart beside their plain versions and bounds."""
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(5)
    n, L = 3000, 14.0
    r = rng.uniform(0, L, (n, 3))
    r[7] = r[6]
    r[9] = r[8] + 0.05
    groups = rng.integers(0, 3, n).astype(np.int32)
    p = ewald.default_params(0.45, 1.0, (L, L, L), tol=1e-4,
                             cell_capacity=64, radii=(0.2, 0.3, 0.45))
    f6 = rng.normal(size=(n, 6))
    for dtype, bound in ((torch.float32, 3e-6), (torch.float64, 1e-12)):
        plan = ewald.make_plan(p, torch.as_tensor(r, dtype=dtype,
                                                  device=dev),
                               group_of=torch.as_tensor(groups, device=dev))
        check(int(plan.n_dropped_cells) == 0, "P2 scene overflows")
        listed, differ, worst, same = p2_list_vs_plain(ck, plan)
        log(f"P2 list {n} blobs G=3 {dtype}: "
            f"{p2_list_text(listed, differ, worst, same)}")
        check(same, f"P2 list {dtype} not bit-identical on repeat")
        for n_rhs in (1, 2):
            f = torch.as_tensor(f6[:, :3 * n_rhs], dtype=dtype,
                                device=dev).contiguous()
            err, scale, p32, same = p2_vs_plain(ck, plan, f)
            bound_b = bound if p32 is None else max(bound, 2 * p32 / scale)
            plain_txt = ("" if p32 is None else
                         f", the f32 plain version's {p32 / scale:.3e}")
            log(f"P2 {n} blobs G=3 cells {plan.cell_dims} B={n_rhs} {dtype}"
                f" (K={plan.cheb_radii.shape[-1]}): max err / max|ref| = "
                f"{err / scale:.3e} (bound {bound_b:.2e}{plain_txt}); repeat "
                f"bit-identical {same}")
            check(err <= bound_b * scale, f"P2 disagrees ({err / scale:.3e})")
            check(same, f"P2 B={n_rhs} {dtype} not bit-identical on repeat")
        if dtype == torch.float32:
            p2_timed(ck, plan, f6, what=f"{n} blobs G=3")


def p2_timed(ck, plan, f_np, what, rhs=(1,)):
    """P2's build and product (each B of rhs) on this plan, timed apart
    (CUDA events) beside their plain versions (the plain list build and the
    plain product over the same list, float32) and their bounds; logs
    them and returns (build record, {B: product record}, (candidates,
    inside, listed))."""
    p = plan.params
    n = plan.positions.shape[0]
    args = (plan.positions, plan.group_of, plan.cell_table, plan.cell_dims,
            p.box, p.cell_capacity)
    build_ms = cuda_ms(lambda: ck.near_radii_pairs(*args, r_cut=p.r_cut), 10)
    build_plain_ms = cuda_ms(lambda: ck.near_radii_pairs_plain(
        *args, r_cut=p.r_cut), 1, warmup=False)
    cand, inside = ck.pair_counts(plan.positions, plan.cell_table,
                                  plan.cell_dims, p.box, p.cell_capacity,
                                  p.r_cut)
    listed = int(plan.radii_pairs.offsets[-1])
    build = p2_list_bound(n, cand, listed, plan.cell_table)
    log(f"P2 list {what} f32: build {build_ms:.3f} ms (count and fill), "
        f"plain {build_plain_ms:.1f} ms; {cand} candidate pairs, {listed} "
        f"listed ({inside} inside r_cut by pair_counts), "
        f"{4 * (n + 1 + listed) / 2 ** 20:.1f} MiB; bound "
        f"{build['bound_ms']:.4f} ms ({build['bound_by']}, "
        f"{build['bound_ms'] / build_ms:.1%} of it)")
    build.update(ms=build_ms, plain_ms=build_plain_ms)
    K = plan.cheb_radii.shape[-1]
    products = {}
    for n_rhs in rhs:
        f = torch.as_tensor(f_np[:, :3 * n_rhs], dtype=plan.positions.dtype,
                            device=plan.positions.device).contiguous()
        call = (plan.positions, f, plan.group_of, plan.cell_table,
                plan.cell_dims, p.box, p.cell_capacity, plan.cheb_radii,
                plan.radii_edges)
        ms = cuda_ms(lambda: ck.near_rpy_radii(
            *call, r_cut=p.r_cut, pairs=plan.radii_pairs), 10)
        plain_ms = cuda_ms(lambda: ck.near_rpy_radii_pairs_plain(
            plan.radii_pairs, f, plan.cheb_radii, plan.radii_edges, p.box,
            r_cut=p.r_cut), 1, warmup=False)
        rec = p2_product_bound(n, inside, listed, K, n_rhs)
        log(f"P2 product {what} B={n_rhs} f32: {ms:.3f} ms, plain over the "
            f"list {plain_ms:.1f} ms; bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']}, {inside} pairs inside r_cut at "
            f"{8 + P2_PIECE_FLOPS + 6 + 6 * K + 18 * n_rhs} operations, "
            f"K = {K}; {rec['bound_ms'] / ms:.1%} of it)")
        rec.update(ms=ms, plain_ms=plain_ms)
        products[n_rhs] = rec
    return build, products, (cand, inside, listed)


def phase_radii_parity(mc):
    """Phase 4, radii: 8 shells of the mixture above the wall x 3 steps of
    forward Euler and Slip-Trapz, card f64 and f32 against CPU f64 with the
    same normals fed (scheme_parity_case: 1e-9 and 1e-2 of the
    displacement); P1 runs on the card."""
    before = sum(mc.RADII_LAUNCHES.values())
    for scheme in ("deterministic_forward_euler", "stochastic_Slip_Trapz"):
        scheme_parity_case(radii_system(8), scheme, "bidisperse 8 shells")
    launches = sum(mc.RADII_LAUNCHES.values()) - before
    log(f"bidisperse parity: P1 launched {launches} times")
    check(launches > 0, "the bidisperse slice did not run on P1")


def write_radii_input(d, pos, quat, settings):
    """A bench.py-physics input of the mixture in directory d: two
    structure lines, each with its four-column .vertex file; returns its
    path."""
    from rigidmultiblobswall_tpu_torch.io import scene

    radii_vertex_files(d)
    half = len(pos) - len(pos) // 2
    for name, sl in (("small", slice(0, half)), ("big", slice(half, None))):
        scene.write_clones_file(os.path.join(d, f"{name}.clones"), pos[sl],
                                quat[sl])
    inp = os.path.join(d, "input.dat")
    with open(inp, "w") as f:
        f.write(settings + "eta 1.0\ng 0.1\nblob_radius 0.131\n"
                "repulsion_strength_wall 0.2\ndebye_length_wall 0.2\n"
                "repulsion_strength 0.2\ndebye_length 0.2\n"
                "blob_blob_force_implementation python\nseed 1\n"
                "output_name run\nstructure small.vertex small.clones\n"
                "structure big.vertex big.clones\n")
    return inp


def phase_radii_cli():
    """Phase 5, radii: the CLI on a generated 16-shell input of the mixture
    (four-column .vertex files): 3 Slip-Trapz steps at kT = 0, mobility
    and body_mobility, card float64 against CPU float64 (the .clones to
    1e-9 of the displacement, the .dat files to 1e-9 x max|ref|)."""
    from rigidmultiblobswall_tpu_torch import cli

    pos, quat = alternate(*lattice(16, seed=3))
    pos = pos.astype(np.float64)
    cwd = os.getcwd()
    outs = {}
    runs = (("stochastic_Slip_Trapz", "dt 0.002\nn_steps 3\nn_save 3\n"
             "kT 0.0\nsolver_tolerance 1e-12\n",
             ("small.00000003.clones", "big.00000003.clones")),
            ("mobility", "kT 0.0\nsolver_tolerance 1e-12\n",
             ("velocity.dat",)),
            ("body_mobility", "kT 0.0\n", ("body_mobility.dat",)))
    with tempfile.TemporaryDirectory() as d:
        for scheme, settings, names in runs:
            inp = write_radii_input(d, pos, quat,
                                    f"scheme {scheme}\n" + settings)
            os.chdir(d)
            try:
                for device in (DEVICE, "cpu"):
                    t0 = time.perf_counter()
                    cli.main(["--input-file", inp, "--f64", "--device",
                              device])
                    secs = time.perf_counter() - t0
                    for name in names:
                        outs[name, device] = np.loadtxt(
                            f"run.{name}",
                            skiprows=1 if name.endswith("clones") else 0)
                    log(f"CLI {scheme} 16 shells of the mixture f64 on "
                        f"{device}: {secs:.2f} s")
            finally:
                os.chdir(cwd)
    half = len(pos) - len(pos) // 2
    disp = max(np.abs(outs["small.00000003.clones", "cpu"][:, :3]
                      - pos[:half]).max(),
               np.abs(outs["big.00000003.clones", "cpu"][:, :3]
                      - pos[half:]).max())
    for name in ("small.00000003.clones", "big.00000003.clones",
                 "velocity.dat", "body_mobility.dat"):
        got, ref = outs[name, DEVICE], outs[name, "cpu"]
        scale = disp if name.endswith("clones") else np.abs(ref).max()
        rel = np.abs(got - ref).max() / scale
        log(f"CLI radii {name} {got.shape}: card vs CPU max err / "
            f"{'max displacement' if name.endswith('clones') else 'max|ref|'}"
            f" = {rel:.3e} (bound 1e-9)")
        check(np.all(np.isfinite(got)) and scale > 0 and rel <= 1e-9,
              f"CLI radii {name} card vs CPU")


def phase_radii_path(pk, mc, ck, lap):
    """Phase 18, multibody-49k-radii: phase 6's lattice and physics (4096
    shells above the wall, direct forces, tolerance 2e-4, float32) with
    the mixture alternating on the lattice, from its four-column .vertex
    files; deterministic forward Euler and stochastic Slip-Trapz, one
    warm-up and three timed steps each, matrix-free on P1 (B = 1, and B = 2
    for Slip-Trapz's lockstep pair) and K2, never K1 tt, K3 or K4. Returns
    P1's launches over the phase by B."""
    from rigidmultiblobswall_tpu_torch.models import integrators
    from rigidmultiblobswall_tpu_torch.models import kinematics as kin
    from rigidmultiblobswall_tpu_torch.models.system import make_state

    t_phase = time.perf_counter()
    dev = torch.device(DEVICE)
    system = radii_system(N_SHELLS)
    pos, quat = alternate(*lattice(N_SHELLS))
    state0 = make_state(pos, quat, dtype=torch.float32, device=dev)
    r0 = kin.blob_positions(system, state0)
    radii = torch.tensor(system.blob_radii, dtype=torch.float32, device=dev)
    gap, _ = blob_contacts(r0, radii)
    log(f"multibody-49k-radii: {system.num_blobs} blobs, {N_SHELLS // 2} "
        f"shells (blob radius {RADII_SHELLS[0][1]}) and {N_SHELLS // 2} 1.2x "
        f"shells (blob radius {RADII_SHELLS[1][1]}) alternating on phase 6's "
        f"lattice; smallest blob surface gap {gap:.4f}")
    total = {1: 0, 2: 0}
    for scheme in ("deterministic_forward_euler", "stochastic_Slip_Trapz"):
        step = integrators.make_stepper(
            system, scheme, 1e-3, lanczos_tolerance=5e-4,
            lanczos_max_iter=32, lanczos_check_every=4, gmres_restart=60,
            gmres_maxiter=300, max_rejections=3)
        state = state0
        carry = integrators.init_carry(system, state=state)
        gen = torch.Generator().manual_seed(0)
        _reset_counts(pk, mc, ck, lap)
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, carry, aux = step(state, gen, carry)     # warm-up
        torch.cuda.synchronize()
        warm_ms = (time.perf_counter() - t0) * 1e3
        det, sto, rej, times = [], [], [], []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, carry, aux = step(state, gen, carry)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            det.append(aux.det_iterations)
            sto.append(aux.stoch_iterations)
            rej.append(aux.rejections)
        peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
        p1 = p1_open_launches(mc)
        others = _other_launches(pk, mc, ck, lap)
        log(f"multibody-49k-radii {scheme} f32: {sum(times) / 3:.1f} ms/step "
            f"over 3 steps ({_fmt(times)}; warm-up {warm_ms:.1f}); gmres "
            f"{det}, lanczos {sto}, rejections {rej}; peak device memory "
            f"{peak:.2f} GiB above what earlier phases hold; launches over "
            f"the 4 steps P1 {p1}, other kernels {others}")
        check(bool(torch.isfinite(state.pos).all()),
              f"multibody-49k-radii {scheme}: positions not finite")
        check(min(det) > 0 and max(rej) == 0,
              f"multibody-49k-radii {scheme}: gmres {det}, rejections {rej}")
        check(p1[1] > 0 and others["K2"] > 0, f"multibody-49k-radii "
              f"{scheme}: P1 or K2 not launched ({p1}, {others})")
        check(others["K1"] == 0 and others["K3/K4"] == 0,
              f"multibody-49k-radii {scheme}: K1 or K3/K4 launched "
              f"({others})")
        if scheme == "stochastic_Slip_Trapz":
            check(min(sto) > 0 and p1[2] > 0, "multibody-49k-radii: no "
                  f"Lanczos iterations or no P1 B = 2 launch ({sto}, {p1})")
        for b in total:
            total[b] += p1[b]
    log(f"phase 18: {time.perf_counter() - t_phase:.1f} s")
    return total


def radii_spectral_system(n_bodies, L, **overrides):
    """spectral_system's physics (phase 8) with the mixture: the first
    n_bodies // 2 bodies the small shells, the rest the big ones."""
    system = spectral_system(n_bodies, L, **overrides)
    mix = radii_system(n_bodies)
    return dataclasses.replace(system, types=mix.types)


def phase_radii_spectral_path(pk, mc, ck, lap, report):
    """Phase 19, spectral-98k-radii: phase 8's box (8192 shells, 98,304
    blobs, L = 33.6, tolerance 1e-4, grid at most 256, linked-cell forces)
    with the mixture alternating on its lattice, G = 2, float32: the plan
    and its host tables (timed), P2 at its shape: the plan's pair list
    against the plain list's in float64 (the first 256 target cells),
    the product over it against the float64 plain sweep (B = 1 and 2,
    float32 within u32 sqrt(27 cap) or twice the float32 plain version's
    error, twice bit-identical), the build and the products timed apart
    with their plain versions and bounds; then one warm-up and three timed
    Slip-Trapz steps: ms/step, iterations, peak memory, launches (P2's
    builds and products and K5 must run, K6 must not). Returns P2's
    records (the build, B = 1, B = 2) with their launches over the steps."""
    from rigidmultiblobswall_tpu_torch.models import integrators, saddle
    from rigidmultiblobswall_tpu_torch.models import kinematics as kin
    from rigidmultiblobswall_tpu_torch.models.system import make_state
    from rigidmultiblobswall_tpu_torch.ops import forces

    t_phase = time.perf_counter()
    dev = torch.device(DEVICE)
    system = radii_spectral_system(N_SPECTRAL, L_SPECTRAL)
    pos, quat = alternate(*spectral_lattice(N_SPECTRAL, SPECTRAL_SIDE))
    state = make_state(pos, quat, dtype=torch.float32, device=dev)
    t0 = time.perf_counter()
    system = saddle.auto_spectral_capacities(system, state, log=log)
    r_blobs = kin.blob_positions(system, state)
    system = forces.auto_force_cell_capacity(system, r_blobs, log=log)
    log(f"spectral-98k-radii: capacities and the radii plan's host tables "
        f"in {time.perf_counter() - t0:.2f} s")
    n = system.num_blobs
    plan = saddle.maybe_dense_mobility(system, r_blobs)
    p = plan.params
    log(f"spectral-98k-radii plan: radii {p.radii}, grid {p.grid}, r_cut "
        f"{p.r_cut:.4f}, Chebyshev terms {plan.cheb_radii.shape[-1]} a piece, "
        f"cells {plan.cell_dims} x cap {p.cell_capacity}, dropped "
        f"{int(plan.n_dropped_cells)}")
    g = torch.Generator(device=dev).manual_seed(19)
    sub = (0, 256)
    listed, differ, worst, same = p2_list_vs_plain(ck, plan, sub)
    log(f"P2 list {n} blobs f32, first {sub[1]} target cells: "
        f"{p2_list_text(listed, differ, worst, same)}")
    check(same, f"P2 list not bit-identical on repeat at {n} blobs")
    f_all = torch.randn((n, 6), generator=g, device=dev)
    errs = {}
    for n_rhs in (1, 2):
        f = f_all[:, :3 * n_rhs].contiguous()
        err, scale, p32, same = p2_vs_plain(ck, plan, f, cells_range=sub)
        bound_rel = max(u32_sqrt(27 * p.cell_capacity), 2 * p32 / scale)
        log(f"P2 {n} blobs B={n_rhs} f32, first {sub[1]} target cells vs "
            f"plain f64: max err {err:.3e}, / max|ref| = {err / scale:.3e} "
            f"(bound {bound_rel:.2e}: u32 sqrt(27 cap) or twice the f32 "
            f"plain version's {p32 / scale:.3e}); repeat bit-identical "
            f"{same}")
        check(err <= bound_rel * scale, f"P2 disagrees at {n} blobs")
        check(same, f"P2 B={n_rhs} not bit-identical on repeat at {n} blobs")
        errs[n_rhs] = err
    build, products, _ = p2_timed(ck, plan, f_all.cpu().numpy(),
                                  f"{n} blobs", rhs=(1, 2))
    plan_txt = (f"{plan.cell_dims} cells x cap {p.cell_capacity}, G = "
                f"{len(p.radii)}")
    records = {"build": dict(
        max_abs_err=worst, registers=instance_registers(
            report, "pairs_kernel<float, true>"),
        plan=f"one block a target cell, {plan_txt}, {listed} pairs of the "
             f"first {sub[1]} cells checked, {differ} within rounding of "
             f"r_cut", **build)}
    for n_rhs, rec in products.items():
        records[n_rhs] = dict(
            max_abs_err=errs[n_rhs], registers=instance_registers(
                report, "product_kernel", f"<float, {n_rhs}>"),
            plan=f"one warp a target over the plan's list, {plan_txt}",
            **rec)
    for key, rec in records.items():
        log(f"P2 {key} ptxas {rec['registers']}")
    del plan

    step = integrators.make_stepper(
        system, "stochastic_Slip_Trapz", 1e-3, lanczos_tolerance=5e-4,
        lanczos_max_iter=32, lanczos_check_every=4, gmres_restart=60,
        gmres_maxiter=300, max_rejections=3)
    gen = torch.Generator(device=dev).manual_seed(0)
    _reset_counts(pk, mc, ck, lap)
    held = torch.cuda.memory_allocated()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    carry = integrators.init_carry(system, state=state)
    state, carry, aux = step(state, gen, carry)           # warm-up
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    det, sto, ovf, times = [], [], [aux.capacity_overflows], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, carry, aux = step(state, gen, carry)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        det.append(aux.det_iterations)
        sto.append(aux.stoch_iterations)
        ovf.append(aux.capacity_overflows)
    peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
    launches = {"P2 B=1": ck.LAUNCHES["near_rpy_radii_b1"],
                "P2 B=2": ck.LAUNCHES["near_rpy_radii_b2"],
                "P2 build": ck.LAUNCHES["near_radii_pairs"],
                "K5": ck.LAUNCHES["nl_forces"],
                "K6": ck.LAUNCHES["near_rpy_b1"] + ck.LAUNCHES["near_rpy_b2"]}
    others = _other_launches(pk, mc, ck, lap)
    log(f"spectral-98k-radii stochastic_Slip_Trapz f32: "
        f"{sum(times) / 3:.1f} ms/step over 3 steps ({_fmt(times)}; plan + "
        f"warm-up {warm_ms:.1f}); gmres {det}, lanczos {sto}, capacity "
        f"overflows {ovf}; peak device memory {peak:.2f} GiB above what "
        f"earlier phases hold; launches over the 4 steps {launches}, all "
        f"kernels {others}")
    check(bool(torch.isfinite(state.pos).all()),
          "spectral-98k-radii: positions not finite")
    check(min(det) > 0 and min(sto) > 0 and max(ovf) == 0,
          f"spectral-98k-radii: gmres {det}, lanczos {sto}, overflows {ovf}")
    check(min(launches["P2 B=1"], launches["P2 B=2"], launches["P2 build"],
              launches["K5"]) > 0,
          f"spectral-98k-radii: P2 or K5 not launched ({launches})")
    check(launches["K6"] == 0, f"spectral-98k-radii: K6 launched "
          f"({launches})")
    records["build"]["launches"] = launches["P2 build"]
    for n_rhs in (1, 2):
        records[n_rhs]["launches"] = launches[f"P2 B={n_rhs}"]
    log(f"phase 19: {time.perf_counter() - t_phase:.1f} s")
    return records


# ---------------------------------------------------------------------------
# Pseudo-periodic image boxes of the direct engine (ROADMAP Queue 1, item
# 4) and the .random_state restart (item 11): phase 20
# ---------------------------------------------------------------------------

# the boxes: each lattice's own period in x and y, so the images continue
# it (20a: 16 shells a side at 1.6; 20b: phase 9's 11; 20c: phase 7's 182
# rollers, the box phase 11 runs; 20d: phase 12's 64 spheres at 2.4)
L_PSEUDO = 16 * 1.6
L_PSEUDO_DENSE = 11 * 1.6
L_PSEUDO_ROLLERS = 182 * 1.6
L_PSEUDO_LUB = 64 * 2.4
# the image instances' float32 bound against the float64 plain version (the
# JAX package's, tests/test_pair_kernels.py:49)
IMG_BOUND = 3e-6
# the minimum image a pair takes in float64 on each periodic axis: a
# difference, a multiply-add, a truncation and a multiply-add, counted as
# two float32 operations each (the H100's float64 rate is half its float32
# one, 34 TFLOP/s)
K1_IMAGE_FLOPS = 8
# the diagonal couplings' box sum (csrc/pair_blocks.cuh BlockSum): adding a
# box's condensed block (two multiplies, two adds, seven FMAs), closing the
# sum once a pair (two adds) and applying the closed 3 x 3 block (nine FMAs)
# to one right-hand side, once each way. A pair's boxes summed so need
# fewer operations than applying each box both ways from B = 2 on: the
# recount beside the bound above (the smaller of the two ways)
K1_BOX_SUM_FLOPS = 18
K1_BOX_CLOSE_FLOPS = 2
K1_BLOCK_APPLY_FLOPS = 18


def xy_box(L):
    return (float(L), float(L), 0.0)


def img_k1_record(pk, coupling, q, v, L, sub, what, report):
    """An image-box instance of K1 at a path's full shape (float32, wall,
    self pairs; q in units of a, L the box in units of a), called as the
    path calls it (the square product, the symmetric sweep): the first
    `sub` target rows against the plain version in float64 within
    IMG_BOUND x max|ref|, twice bit-identical, its time, the plain
    version's (plain_fields: the whole sweep where its first `sub` rows
    predict under PLAIN_WHOLE_S, else those rows' time), its registers.
    The bound counts each box of
    each unordered pair condensed once (tr's and rt's other cross block
    with it) and applied both ways, and the pair's minimum image."""
    n = q.shape[0]
    nc = pk.NCOMP[coupling]
    n_rhs = v.shape[1] // nc
    boxes = (L, pk.box_offsets(L))
    kw = dict(coupling=coupling, mode="wall", self_interaction=True,
              boxes=boxes)
    got = pk.pair_matvec(q, None, v, **kw)
    again = pk.pair_matvec(q, None, v, **kw)
    torch.cuda.synchronize()
    same = torch.equal(got, again)
    ref = pk.pair_plain(q.double(), q[:sub].double(), v.double(), **kw)
    err = (got[:sub].double() - ref).abs().max().item()
    rel = err / ref.abs().max().item()
    ms = cuda_ms(lambda: pk.pair_matvec(q, None, v, **kw), 5)
    plain = plain_fields(lambda k: pk.pair_plain(q, q[:k], v, **kw), n, sub)
    apply = K1_APPLY_FLOPS[coupling]
    per_pair = (K1_PAIR_FLOPS[coupling] + K1_SYM_EXTRA_FLOPS.get(coupling, 0)
                - apply + 2 * apply * n_rhs) / 2
    n_boxes = len(boxes[1])
    periodic = sum(1 for x in L if x > 0)
    flops = n * n * (n_boxes * per_pair + K1_IMAGE_FLOPS * periodic / 2)
    nbytes = 4 * n * (3 + 2 * nc * n_rhs)
    rec = dict(max_abs_err=err, ms=ms, **plain,
               **bound_record(nbytes, flops))
    if coupling in ("tt", "rr"):
        # the recount: the same function with a pair's boxes summed first
        summed = (n_boxes * (K1_PAIR_FLOPS[coupling] - apply
                             + K1_BOX_SUM_FLOPS) + K1_BOX_CLOSE_FLOPS
                  + 2 * K1_BLOCK_APPLY_FLOPS * n_rhs) / 2
        rec["recount_ms"] = bound_record(nbytes, n * n * (
            min(n_boxes * per_pair, summed)
            + K1_IMAGE_FLOPS * periodic / 2))["bound_ms"]
    n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
    groups, tiles = pk.plan_groups(n, n_sm)
    geom = "PlaneBoxes" if pk.plane_far(boxes) else "ImageBoxes"
    regs = instance_registers(
        report, "sym_kernel<float",
        {"tt": "DiagCoupling<false>", "rr": "DiagCoupling<true>",
         "tr": "CrossCoupling<true", "rt": "CrossCoupling<false",
         "grand": "Grand"}[coupling], f", {n_rhs}, true, pairk::{geom}")
    rec["registers"] = regs
    log(f"K1 {coupling} images {what} B={n_rhs} f32, {n_boxes} boxes of "
        f"{L} ({geom}), the symmetric sweep ({groups} groups of {tiles} "
        f"tiles): first "
        f"{sub} target rows vs plain f64 max err {err:.3e}, / max|ref| = "
        f"{rel:.3e} (bound {IMG_BOUND:.0e}); repeat bit-identical {same}; "
        f"kernel {ms:.3f} ms, bound {rec['bound_ms']:.3f} ms "
        f"({rec['bound_by']}, {rec['bound_ms'] / ms:.1%} of it), "
        f"{plain_text(rec)}; registers {regs}")
    check(rel <= IMG_BOUND, f"K1 {coupling} images B={n_rhs} disagrees at "
          f"{what} ({rel:.3e})")
    check(same, f"K1 {coupling} images B={n_rhs} not bit-identical on "
          f"repeat at {what}")
    return rec


def img_k1_sliced_check(pk, q, v, L, sub, what):
    """The sliced sweep's image-box instance (no path of phase 20 takes it:
    every product there is square) at a path's sources: the first `sub`
    rows as targets of a two-tensor call, against the plain version in
    float64."""
    boxes = (L, pk.box_offsets(L))
    kw = dict(coupling="tt", mode="wall", self_interaction=True, boxes=boxes)
    got = pk.pair_matvec(q, q[:sub].contiguous(), v, **kw)
    torch.cuda.synchronize()
    ref = pk.pair_plain(q.double(), q[:sub].double(), v.double(), **kw)
    rel = ((got.double() - ref).abs().max() / ref.abs().max()).item()
    n_rhs = v.shape[1] // 3
    log(f"K1 tt images {what} B={n_rhs}, the sliced sweep ({sub} targets): "
        f"vs plain f64 / max|ref| = {rel:.3e} (bound {IMG_BOUND:.0e})")
    check(rel <= IMG_BOUND, f"K1 tt images B={n_rhs}, sliced, disagrees at "
          f"{what}")


def _img_launches(pk):
    """The image instances' launches by (coupling, B), every sweep, and
    those on the sliced sweep."""
    out = {}
    for (c, b, _), n in pk.IMAGE_LAUNCHES.items():
        if n:
            key = f"K1 {c} images" + ("" if b == 1 else f" B={b}")
            out[key] = out.get(key, 0) + n
    sliced = sum(n for (_, _, s), n in pk.IMAGE_LAUNCHES.items()
                 if s == "sliced")
    return out, sliced


def _img_steps(step, state, gen, carry, n_timed):
    """One warm-up and n_timed steps of step(state, gen, carry) -> (state,
    carry, aux) (host clock, each bracketed by a synchronize); returns
    (state, carry, ms list, aux list)."""
    times, auxes = [], []
    for k in range(n_timed + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, carry, aux = step(state, gen, carry)
        torch.cuda.synchronize()
        if k:
            times.append((time.perf_counter() - t0) * 1e3)
        auxes.append(aux)
    return state, carry, times, auxes


def phase_pseudo_periodic(pk, mc, ck, lap, mob, kin, report):
    """Phase 20, the direct engine's pseudo-periodic image boxes and the
    .random_state restart at full width, float32 (each path on K1's and
    K3's image-box instances, K2's periodic instances and M1's minimum
    image; no open K1 or K3 launch may run):
      20a multibody-49k-pseudo-periodic: phase 6's scene (4096 shells,
          49,152 blobs) in a (25.6, 25.6, 0) box, matrix-free, forward
          Euler and Slip-Trapz, one warm-up and two timed steps each;
      20b multibody-12k-dense-pseudo-periodic: phase 9's 1024 shells in a
          (17.6, 17.6, 0) box, one Slip-Trapz step on the materialized
          engine (K3's image instance and K4);
      20c rollers-32k-pseudo-periodic: phase 7's 32,768 rollers in a
          (291.2, 291.2, 0) box, stochastic and deterministic
          Adams-Bashforth, one warm-up and two timed steps each;
      20d lubrication-4k-pseudo-periodic: phase 12's 4096 spheres in a
          (153.6, 153.6, 0) box, step_trapezoidal, one warm-up and two
          timed steps;
      20e a 100 + 100-step MCMC chain on 20a's scene (M1's minimum
          image), its final energy against the plain version's;
      20f the .random_state round trip through the CLI on the card: a
          4-step run against 2 steps restarted from its .clones and
          .random_state for 2 more (float64, the same frames).
    Each image instance on these paths is held against its plain version
    at the path's shape (img_k1_record; K3 on the whole matrix) first.
    Returns (records, launches) for the kernel JSON line."""
    from rigidmultiblobswall_tpu_torch.models import integrators, lubrication
    from rigidmultiblobswall_tpu_torch.models import mcmc, rollers, saddle
    from rigidmultiblobswall_tpu_torch.models.system import make_state

    t_phase = time.perf_counter()
    dev = torch.device(DEVICE)
    records, launches = {}, {}
    g = torch.Generator(device=dev).manual_seed(20)

    # 20a: the kernels at the path's shape, then the two schemes
    box = xy_box(L_PSEUDO)
    system = bench_system(N_SHELLS, periodic_length=box)
    pos, quat = lattice(N_SHELLS)
    state = make_state(pos, quat, dtype=torch.float32, device=dev)
    r = kin.blob_positions(system, state).contiguous()
    n = r.shape[0]
    q = (mob.shift_heights(r, A_BENCH) / A_BENCH).contiguous()
    La = tuple(x / A_BENCH for x in box)
    what = f"{n} blobs"
    for n_rhs in (1, 2):
        v = torch.randn((n, 3 * n_rhs), generator=g, device=dev)
        records["tt" if n_rhs == 1 else "tt_b2"] = img_k1_record(
            pk, "tt", q, v, La, 1024, what, report)
    for vs in (v[:, :3].contiguous(), v):
        img_k1_sliced_check(pk, q, vs, La, 512, what)
    check(saddle.maybe_dense_mobility(system, r) is None,
          "20a: 49,152 blobs materialized")
    a_launches = {}
    for scheme in ("deterministic_forward_euler", "stochastic_Slip_Trapz"):
        st = make_state(pos, quat, dtype=torch.float32, device=dev)
        step = integrators.make_stepper(
            system, scheme, 1e-3, lanczos_tolerance=5e-4,
            lanczos_max_iter=32, lanczos_check_every=4, gmres_restart=60,
            gmres_maxiter=300, max_rejections=3)
        carry = integrators.init_carry(system, state=st)
        _reset_counts(pk, mc, ck, lap)
        st, carry, times, auxes = _img_steps(
            step, st, torch.Generator(device=dev).manual_seed(0), carry, 2)
        img, sliced = _img_launches(pk)
        open_k1 = sum(pk.LAUNCHES.values())
        for k, v_ in img.items():
            a_launches[k] = a_launches.get(k, 0) + v_
        log(f"20a multibody-49k-pseudo-periodic {n} blobs in {box} {scheme} "
            f"f32: {_fmt(times)} ms/step (after a warm-up); gmres "
            f"{[a.det_iterations for a in auxes]}, lanczos "
            f"{[a.stoch_iterations for a in auxes]}, rejections "
            f"{[a.rejections for a in auxes]}; launches over the 3 steps "
            f"{img}, K2 periodic {mc.PERIODIC_LAUNCHES} (one-box "
            f"{mc.ONE_BOX_LAUNCHES}); open K1 {open_k1}, K2 {mc.LAUNCHES}, "
            f"K3/K4 {sum(dense_launches(mc).values())}, K3 images "
            f"{dense_image_launches(mc)}")
        check(bool(torch.isfinite(st.pos).all()), f"20a {scheme}: positions")
        check(min(a.det_iterations for a in auxes) > 0, f"20a {scheme}: "
              "no GMRES iterations")
        check(img.get("K1 tt images", 0) > 0 and mc.PERIODIC_LAUNCHES > 0,
              f"20a {scheme}: K1 tt images or periodic K2 not launched")
        check(open_k1 == 0 and mc.LAUNCHES == 0 and sliced == 0
              and sum(dense_launches(mc).values()) == 0
              and dense_image_launches(mc) == 0,
              f"20a {scheme}: an open or sliced kernel ran")
        if scheme == "stochastic_Slip_Trapz":
            check(img.get("K1 tt images B=2", 0) > 0,
                  "20a Slip-Trapz: K1 tt images B=2 not launched")
    launches.update(a_launches)

    # 20e: MCMC on 20a's scene (before its state moves on)
    st = make_state(pos, quat, dtype=torch.float32, device=dev)
    _reset_counts(pk, mc, ck, lap)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    final, traj, energies = mcmc.run_mcmc(
        system, st, torch.Generator(device=dev).manual_seed(3),
        n_steps=100, save_every=20, initial_step=-100)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    rb = kin.blob_positions(system, final.state)
    kw = dict(repulsion_strength=system.repulsion_strength,
              debye_length=system.debye_length,
              blob_radius=system.blob_radius, periodic_length=box,
              coincident="one")
    # phase 16's check: the plain version's energy of the final state on
    # the chain's own float32 blobs (pairs under the minimum image)
    one_body = float(mcmc._Energy(system).one_body(rb[None])[0])
    pair_ref = float(mc.blob_blob_energy_plain(rb[None].double(), **kw)[0])
    pair_f32 = float(mc.blob_blob_energy_plain(rb[None], **kw)[0])
    e_ref = one_body + pair_ref
    rel = abs(float(final.energy) - e_ref) / abs(pair_ref)
    bound = max(float(m1_term_bound(mc, rb[None], kw)[0]),
                2 * abs(pair_f32 - pair_ref)) / abs(pair_ref)
    log(f"20e MCMC on 20a's scene in {box}: 200 steps (100 burn-in) in "
        f"{secs:.3f} s, {secs / 200 * 1e3:.3f} ms a step, accepted "
        f"{int(final.accepted)}; M1 launches {mc.ENERGY_LAUNCHES}, K1 "
        f"{sum(pk.LAUNCHES.values()) + sum(pk.IMAGE_LAUNCHES.values())}; "
        f"final energy {float(final.energy):.10g} against the plain "
        f"version's {e_ref:.10g} (pairs {pair_ref:.10g}): relative to the "
        f"pair energy {rel:.3e} (bound {bound:.2e})")
    check(mc.ENERGY_LAUNCHES == 201, f"20e: M1 launched "
          f"{mc.ENERGY_LAUNCHES} times over 200 steps")
    check(0 < int(final.accepted) < 200 and bool(
        torch.isfinite(energies).all()), "20e: the chain")
    check(rel <= bound, f"20e: final energy against the plain version "
          f"({rel:.3e})")

    # 20b: K3's image instance and K1 tt's at 12,288 blobs, one step
    box = xy_box(L_PSEUDO_DENSE)
    system = bench_system(N_DENSE, periodic_length=box)
    pos, quat = lattice(N_DENSE)
    st = make_state(pos, quat, dtype=torch.float32, device=dev)
    r = kin.blob_positions(system, st).contiguous()
    n = r.shape[0]
    n3 = 3 * n
    eta = system.eta
    m = mc.dense_tt(r, eta, A_BENCH, mode="wall", periodic_length=box)
    torch.cuda.synchronize()
    ref = mc.dense_tt_plain(r.double(), eta, A_BENCH, mode="wall",
                            periodic_length=box)
    err, scale = _chunked_err(m, lambda r0, r1: ref[r0:r1], n3)
    del ref
    transposed = exact_transpose(m)
    same = torch.equal(m, mc.dense_tt(r, eta, A_BENCH, mode="wall",
                                      periodic_length=box))
    del m
    ms = cuda_ms(lambda: mc.dense_tt(r, eta, A_BENCH, mode="wall",
                                     periodic_length=box), 3)
    plain_ms = cuda_ms(lambda: mc.dense_tt_plain(
        r, eta, A_BENCH, mode="wall", periodic_length=box), 1, warmup=False)
    n_boxes = len(pk.box_offsets(box))
    # the box-summed matrix is symmetric too: each unordered pair's box sum
    # and minimum image once
    records["K3"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         **bound_record(4 * (n3 * n3 + n3),
                                        n * (n + 1) // 2 * (
                                            n_boxes * K3_PAIR_FLOPS
                                            + 2 * K1_IMAGE_FLOPS)))
    geom = ("PlaneBoxes" if pk.plane_far(pk.image_boxes(box, A_BENCH))
            else "ImageBoxes")
    regs = instance_registers(report, "dense_tt_kernel<float, true", geom)
    records["K3"]["registers"] = regs
    log(f"K3 images {n} blobs in {box} ({geom}) f32 vs plain f64: max err "
        f"{err:.3e}, / max|ref| = {err / scale:.3e} (bound "
        f"{IMG_BOUND:.0e}); lower triangle the exact transpose "
        f"{transposed}, repeat bit-identical {same}; kernel {ms:.3f} ms, "
        f"bound "
        f"{records['K3']['bound_ms']:.3f} ms ({records['K3']['bound_by']}, "
        f"{records['K3']['bound_ms'] / ms:.1%} of it), plain f32 "
        f"{plain_ms:.1f} ms; registers {regs}")
    check(err <= IMG_BOUND * scale, f"K3 images disagree at {n} blobs")
    check(transposed and same, f"K3 images at {n} blobs: exact transpose "
          f"{transposed}, repeat bit-identical {same}")
    q = (mob.shift_heights(r, A_BENCH) / A_BENCH).contiguous()
    v = torch.randn((n, 3), generator=g, device=dev)
    records["tt_12k"] = img_k1_record(
        pk, "tt", q, v, tuple(x / A_BENCH for x in box), 1024, f"{n} blobs",
        report)
    step = integrators.make_stepper(
        system, "stochastic_Slip_Trapz", 1e-3, lanczos_tolerance=5e-4,
        lanczos_max_iter=32, lanczos_check_every=4, gmres_restart=60,
        gmres_maxiter=300, max_rejections=3)
    carry = integrators.init_carry(system, state=st)
    _reset_counts(pk, mc, ck, lap)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    st, carry, aux = step(st, torch.Generator(device=dev).manual_seed(0),
                          carry)
    torch.cuda.synchronize()
    b_ms = (time.perf_counter() - t0) * 1e3
    img, _ = _img_launches(pk)
    dense = dict(dense_launches(mc),
                 dense_tt_images=dense_image_launches(mc))
    log(f"20b multibody-12k-dense-pseudo-periodic {n} blobs in {box} "
        f"stochastic_Slip_Trapz f32, materialized: one step {b_ms:.1f} ms "
        f"(the first: builds included); gmres {aux.det_iterations}, lanczos "
        f"{aux.stoch_iterations}, rejections {aux.rejections}; launches "
        f"{dense}, {img}, K2 periodic {mc.PERIODIC_LAUNCHES}; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    check(bool(torch.isfinite(st.pos).all()), "20b: positions")
    check(dense["dense_tt_images"] > 0 and dense["symm_matvec"] > 0
          and dense["dense_tt"] == 0 and sum(pk.LAUNCHES.values()) == 0,
          f"20b: K3 images / K4 not launched, or an open K1/K3 ran "
          f"({dense})")
    launches["K3 images"] = dense["dense_tt_images"]
    launches["K1 tt images 12k"] = img.get("K1 tt images", 0)
    del st, carry

    # 20c: the rollers' kernels at 32,768 rollers, then both schemes
    box = xy_box(L_PSEUDO_ROLLERS)
    r0 = torch.as_tensor(roller_lattice(N_ROLLERS), device=dev)
    q = (mob.shift_heights(r0, A_ROLLER) / A_ROLLER).contiguous()
    La = tuple(x / A_ROLLER for x in box)
    what = f"{N_ROLLERS} rollers"
    for coupling, n_rhs in (("grand", 1), ("tr", 1), ("tr", 2), ("rr", 1),
                            ("rr", 2), ("rt", 1)):
        v = torch.randn((N_ROLLERS, pk.NCOMP[coupling] * n_rhs),
                        generator=g, device=dev)
        records[coupling if n_rhs == 1 else f"{coupling}_b2"] = (
            img_k1_record(pk, coupling, q, v, La, 1024, what, report))
    sus = roller_suspension(N_ROLLERS, periodic_length=box)
    c_launches = {}
    for scheme in ("stochastic_adams_bashforth_rollers",
                   "deterministic_adams_bashforth_rollers"):
        step = rollers.make_stepper(sus, scheme, 1e-3, max_rejections=3)
        _reset_counts(pk, mc, ck, lap)
        rr_, _, times, auxes = _img_steps(
            step, r0.clone(), torch.Generator(device=dev).manual_seed(0),
            rollers.init_carry(sus, positions=r0), 2)
        img, sliced = _img_launches(pk)
        for k, v_ in img.items():
            c_launches[k] = c_launches.get(k, 0) + v_
        log(f"20c rollers-32k-pseudo-periodic {N_ROLLERS} rollers in {box} "
            f"{scheme} f32: {_fmt(times)} ms/step (after a warm-up); gmres "
            f"{[a.det_iterations for a in auxes]}, lanczos "
            f"{[a.stoch_iterations for a in auxes]}, rejections "
            f"{[a.rejections for a in auxes]}, wall overlaps "
            f"{[a.wall_overlaps for a in auxes]}; launches {img}, K2 "
            f"periodic {mc.PERIODIC_LAUNCHES}; open K1 "
            f"{sum(pk.LAUNCHES.values())}")
        check(bool(torch.isfinite(rr_).all()), f"20c {scheme}: positions")
        check(sum(pk.LAUNCHES.values()) == 0 and sliced == 0
              and mc.LAUNCHES == 0, f"20c {scheme}: an open or sliced "
              "kernel ran")
        check(mc.PERIODIC_LAUNCHES > 0, f"20c {scheme}: periodic K2 not "
              "launched")
    for k in ("K1 grand images", "K1 tr images", "K1 tr images B=2",
              "K1 rr images", "K1 rr images B=2", "K1 rt images",
              "K1 tt images"):
        check(c_launches.get(k, 0) > 0, f"20c: {k} not launched "
              f"({c_launches})")
    launches.update({k: v_ for k, v_ in c_launches.items()
                     if k != "K1 tt images"})

    # 20d: lubrication, K1 grand's image instance at 4096 spheres
    box = xy_box(L_PSEUDO_LUB)
    p = torch.as_tensor(lub_lattice(N_LUB), device=dev)
    q = (mob.shift_heights(p, 1.0) / 1.0).contiguous()
    v = torch.randn((N_LUB, 6), generator=g, device=dev)
    records["grand_lub"] = img_k1_record(pk, "grand", q, v, box, 1024,
                                         f"{N_LUB} spheres", report)
    sol = lub_solver(N_LUB, dev, periodic_length=box)
    ft_calc = lub_ft_calc(periodic_length=box)
    qt = torch.tensor([[1.0, 0.0, 0.0, 0.0]] * N_LUB, dtype=torch.float32,
                      device=dev)
    _reset_counts(pk, mc, ck, lap)
    p, qt, times, auxes = _img_steps(
        lambda p, gen, qt: lubrication.step_trapezoidal(
            sol, p, qt, gen, ft_calc, omega=25.0, cut_torque=0.2),
        p, torch.Generator(device=dev).manual_seed(0), qt, 2)
    img, sliced = _img_launches(pk)
    ovf = [int(a.neighbor_overflow) for a in auxes]
    log(f"20d lubrication-4k-pseudo-periodic {N_LUB} spheres in {box} "
        f"step_trapezoidal f32: {_fmt(times)} ms/step (after a warm-up); "
        f"gmres {[a.det_iterations for a in auxes]}, lanczos "
        f"{[a.stoch_iterations for a in auxes]}, rejections "
        f"{[int(a.rejections_wall) + int(a.rejections_jump) for a in auxes]}"
        f", neighbor overflow {ovf}; launches {img}, K2 periodic "
        f"{mc.PERIODIC_LAUNCHES} (one-box {mc.ONE_BOX_LAUNCHES}); open K1 "
        f"{sum(pk.LAUNCHES.values())}")
    check(bool(torch.isfinite(p).all()) and max(ovf) == 0,
          "20d: positions or neighbor overflow")
    check(img.get("K1 grand images", 0) > 0 and mc.PERIODIC_LAUNCHES > 0
          and sum(pk.LAUNCHES.values()) == 0 and mc.LAUNCHES == 0,
          f"20d: K1 grand images / periodic K2 not launched, or an open "
          f"kernel ran ({img})")
    launches["K1 grand images lub"] = img.get("K1 grand images", 0)

    # 20f: the .random_state round trip through the CLI on the card
    phase_random_state_cli(L_PSEUDO)
    # each instance's time, share of its bound and registers (kept out of
    # the kernel JSON line's records)
    for key, rec in records.items():
        recount = rec.pop("recount_ms", None)
        recount = ("" if recount is None else f"; recounted with a pair's "
                   f"boxes summed {recount:.3f} ms, {recount / rec['ms']:.1%}")
        log(f"phase 20 {key}: {rec['ms']:.3f} ms, "
            f"{rec['bound_ms'] / rec['ms']:.1%} of its bound "
            f"{rec['bound_ms']:.3f} ms ({rec['bound_by']}){recount}; "
            f"registers {rec.pop('registers')}")
    log(f"phase 20: {time.perf_counter() - t_phase:.1f} s")
    return records, launches


def phase_random_state_cli(L):
    """20f: a generated 64-shell input in an (L, L, 0) box through the CLI
    on the card in float64 (Slip-Trapz at kT 0.05): 4 steps against 2
    restarted from the first 2 steps' .clones and .random_state (the
    run's generator on the card and torch's default generators); the
    frames agree (bit-identical is logged) and the file's header names the
    port."""
    from rigidmultiblobswall_tpu_torch import cli

    pos, quat = lattice(64, seed=0)
    cwd = os.getcwd()
    settings = ("scheme stochastic_Slip_Trapz\ndt 0.001\nn_save 2\n"
                f"solver_tolerance 1e-8\nperiodic_length {L} {L} 0\n")
    frames = {}
    with tempfile.TemporaryDirectory() as d:
        for name, n_steps, extra in (("whole", 4, ""), ("first", 2, ""),
                                     ("second", 2, "random_state "
                                      "first.random_state\n")):
            dd = os.path.join(d, name)
            os.makedirs(dd)
            inp = write_shell_input(dd, pos, quat,
                                    settings + f"n_steps {n_steps}\n" + extra)
            if name == "second":
                shutil.copy(os.path.join(d, "first",
                                         "run.shell.00000002.clones"),
                            os.path.join(dd, "shell.clones"))
                shutil.copy(os.path.join(d, "first", "run.random_state"),
                            os.path.join(dd, "first.random_state"))
            os.chdir(dd)
            try:
                cli.main(["--input-file", inp, "--f64", "--device", DEVICE])
            finally:
                os.chdir(cwd)
            for k in (0, 2, 4):
                f = os.path.join(dd, "run.shell.%08d.clones" % k)
                if os.path.exists(f):
                    frames[name, k] = np.loadtxt(f, skiprows=1)
        with open(os.path.join(d, "whole", "run.random_state")) as f:
            header = f.readline().strip()
            roles = [line.split()[:3] for line in f]
    ref, got = frames["whole", 4], frames["second", 2]
    disp = np.abs(ref[:, :3] - frames["whole", 0][:, :3]).max()
    err = np.abs(got - ref).max()
    log(f"20f the .random_state round trip on the card (64 shells in "
        f"({L}, {L}, 0), Slip-Trapz kT 0.05, f64): 4 steps against 2 + 2 "
        f"restarted, max difference {err:.3e} of a displacement "
        f"{disp:.3e} (bit-identical {err == 0}); generators {roles}")
    check(header == cli.RANDOM_STATE_HEADER, "20f: the file's header")
    check(disp > 1e-5 and err <= 1e-10 * disp, f"20f: the restarted run's "
          f"frame differs from the whole run's ({err:.3e})")
    check(np.array_equal(frames["first", 2], frames["whole", 2]),
          "20f: the first two steps differ")


L_FS_IMAGES = 16 * 1.6          # 20a's box: phase 6's lattice period
MONOLAYER_SIDE = 64             # 21b, 21c: 64 x 64 shells, 4096 of them
MONOLAYER_SPACING = 1.6
MONOLAYER_HEIGHT = 2.0
L_MONOLAYER = MONOLAYER_SIDE * MONOLAYER_SPACING
# 21b's linked cells: bench physics' cutoff 2a + 30 b and grid_dim
MONOLAYER_CUTOFF = 2 * A_BENCH + 30 * 0.2
MONOLAYER_GRID = 16
# the free surface's tt block condensed from one pair geometry (an FMA as
# 2, csrc/pair_blocks.cuh fs_condense): the geometry with the image's
# height and |R|^2 13, the RPY core 11, the image's far form and its fold
# into the condensed block 16; applied as K1's (K1_APPLY_FLOPS), two
# rsqrt a pair
K1_FS_CONDENSE_FLOPS = 40
K1_FS_MUFU = 2
# P1's free surface beyond its open far path (P1_FAR_FLOPS[False]): the
# image's |R|^2 (3), its far RPY form (13) and its fold into the block
# (8); one more rsqrt
P1_FS_FLOPS = 24
# a box's condensed block added into a pair's box sum (csrc/pair_blocks.cuh
# BlockSum.add: two multiplies, two adds, seven FMAs), and P1's closed
# block applied both ways (nine FMAs each way) per right-hand side
P1_BOX_SUM_FLOPS = 18
P1_BLOCK_APPLY_FLOPS = 36
# the free surface's PlaneBoxes box sum as the kernels now form it, by its
# coefficients (csrc/pair_blocks.cuh FsMoments; P1's csrc/pair_radii.cu
# fs_box_sum), an FMA as 2: a box's x^2 + y^2, r^2 and |R|^2 (3), the
# pair's and its image's far RPY forms (8 each) and FsMoments.add (21);
# their close once a pair, dz and Rz folded in (20), and P1's s2 = a^2 +
# b^2 once a pair (an FMA). The recount beside the bound above, which
# counts every box condensed and added into the block
FS_MOMENT_BOX_FLOPS = 40
FS_MOMENT_CLOSE_FLOPS = 20
P1_S2_FLOPS = 2


def k5_bound_f32(cap):
    """K5's float32 bound against its float64 plain version: a row's sum
    over a stencil of 27 cap sources rounds by u32 sqrt(27 cap) of its
    magnitude, and each term's approximate rsqrt and exp2 (~2 ulp) set a
    floor of IMG_BOUND that a small capacity's short sums reach."""
    return max(IMG_BOUND, float(np.finfo(np.float32).eps / 2
                                * np.sqrt(27 * cap)))


def alternating_ms(fns, rounds=5):
    """Mean device time of each function over `rounds` rounds that run
    every function once in turn, each run between CUDA events (after one
    warm-up of each)."""
    for fn in fns:
        fn()
    total = [0.0] * len(fns)
    for _ in range(rounds):
        for k, fn in enumerate(fns):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            torch.cuda.synchronize()
            total[k] += e0.elapsed_time(e1)
    return [t / rounds for t in total]


# the longest plain sweep phases 20 and 21 time whole: an instance's plain
# version is first timed on its first `rows` target rows, and only where
# those predict a whole sweep under this many seconds is the whole sweep
# timed (once) as its plain_ms
PLAIN_WHOLE_S = 10.0


def plain_fields(fn, n, rows):
    """The plain version's fields of a phase 21 record: plain_ms, its time
    over all n target rows (fn(n), one timed call), where its first `rows`
    rows (fn(rows), timed first) take under PLAIN_WHOLE_S * rows / n
    seconds; else plain_ms None, and the time measured on those rows as
    plain_rows_ms beside plain_rows (the whole sweep takes minutes at
    these shapes, more than the run's time limit leaves)."""
    rows = min(rows, n)
    part = cuda_ms(lambda: fn(rows), 1, warmup=False)
    if rows == n:
        return dict(plain_ms=part)
    if part * n / rows < PLAIN_WHOLE_S * 1e3:
        return dict(plain_ms=cuda_ms(lambda: fn(n), 1, warmup=False))
    return dict(plain_ms=None, plain_rows=rows, plain_rows_ms=part)


def plain_text(rec):
    """The plain version's time as a log fragment."""
    if rec["plain_ms"] is not None:
        return f"plain f32 {rec['plain_ms']:.1f} ms"
    return (f"plain f32 not timed whole: {rec['plain_rows_ms']:.1f} ms on "
            f"its first {rec['plain_rows']} target rows")


def monolayer(n_side=MONOLAYER_SIDE, spacing=MONOLAYER_SPACING,
              height=MONOLAYER_HEIGHT, seed=0):
    """n_side^2 shells on a square lattice at one height (float32, numpy
    seed), their quaternions random."""
    idx = np.arange(n_side * n_side)
    pos = np.stack([(idx % n_side) * spacing, (idx // n_side) * spacing,
                    np.full(idx.shape, height)], axis=1).astype(np.float32)
    rng = np.random.default_rng(seed)
    quat = rng.normal(size=(len(idx), 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    return pos, quat


def fs_k1_check(pk, q, v, boxes, sub, what, bound):
    """K1's free-surface instance on the square call (the paths' sweep)
    against its plain version in float64 on the first `sub` target rows,
    within bound x max|ref|, twice bit-identical."""
    kw = dict(coupling="tt", mode="free_surface", self_interaction=True,
              boxes=boxes)
    got = pk.pair_matvec(q, None, v, **kw)
    same = torch.equal(got, pk.pair_matvec(q, None, v, **kw))
    ref = pk.pair_plain(q.double(), q[:sub].double(), v.double(), **kw)
    err = (got[:sub].double() - ref).abs().max().item()
    rel = err / ref.abs().max().item()
    n_rhs = v.shape[1] // 3
    log(f"K1 tt_fs {what} B={n_rhs} {q.dtype}: first {sub} target rows vs "
        f"plain f64 / max|ref| = {rel:.3e} (bound {bound:.0e}); repeat "
        f"bit-identical {same}")
    check(rel <= bound and same, f"K1 tt_fs {what} B={n_rhs} {q.dtype}: "
          f"{rel:.3e}, bit-identical {same}")
    return err


def fs_k1_record(pk, q, v, L, report, what):
    """K1's free-surface instance at a path's full shape in float32 (the
    home box with L None, else its image boxes), timed alternating with
    the wall's tt instance on the same inputs; its bound counts each
    unordered pair's free-surface block condensed once (each box's, and
    the pair's minimum image, with boxes) and applied both ways."""
    n = q.shape[0]
    n_rhs = v.shape[1] // 3
    boxes = None if L is None else (L, pk.box_offsets(L))
    err = fs_k1_check(pk, q, v, boxes, 1024, what, IMG_BOUND)
    fs = dict(coupling="tt", mode="free_surface", self_interaction=True,
              boxes=boxes)
    wall = dict(fs, mode="wall")
    ms, wall_ms = alternating_ms([lambda: pk.pair_matvec(q, None, v, **fs),
                                  lambda: pk.pair_matvec(q, None, v,
                                                         **wall)])
    rows = max(1, pk._default_row_tile(n, n, 4, 3, pk.PLAIN_TILE_BYTES)) * 2
    plain = plain_fields(lambda k: pk.pair_plain(q, q[:k], v, **fs), n, rows)
    apply = K1_APPLY_FLOPS["tt"]
    geom = ("OpenBox" if boxes is None else "PlaneBoxes"
            if pk.plane_far(boxes) else "ImageBoxes")
    pairs = n * (n + 1) // 2
    nbytes = 4 * n * (3 + 6 * n_rhs)
    recount = None
    if boxes is None:
        per_pair = K1_FS_CONDENSE_FLOPS + 2 * apply * n_rhs
        mufu = K1_FS_MUFU
    else:
        nb = len(boxes[1])
        periodic = sum(1 for x in L if x > 0)
        per_pair = (nb * (K1_FS_CONDENSE_FLOPS + K1_BOX_SUM_FLOPS)
                    + K1_BOX_CLOSE_FLOPS + 2 * K1_BLOCK_APPLY_FLOPS * n_rhs
                    + K1_IMAGE_FLOPS * periodic)
        mufu = nb * K1_FS_MUFU
        if geom == "PlaneBoxes":
            recount = pairs * (nb * FS_MOMENT_BOX_FLOPS
                               + FS_MOMENT_CLOSE_FLOPS
                               + 2 * K1_BLOCK_APPLY_FLOPS * n_rhs
                               + K1_IMAGE_FLOPS * periodic)
    rec = dict(max_abs_err=err, ms=ms, **plain,
               **bound_record(nbytes, pairs * per_pair, pairs * mufu))
    if recount is not None:
        rec["recount_ms"] = bound_record(nbytes, recount,
                                         pairs * mufu)["bound_ms"]
    rec["registers"] = (instance_registers(
        report, f"pairk::sym2_kernel<float, {n_rhs}>") if boxes is None
        else instance_registers(report, "sym_kernel<float, pairk::FreeSurface",
                                f", {n_rhs}, true", geom))
    log(f"K1 tt_fs {what} B={n_rhs} f32 ({geom}): kernel {ms:.3f} ms "
        f"(the wall's tt instance {wall_ms:.3f} ms, alternating), bound "
        f"{rec['bound_ms']:.3f} ms ({rec['bound_by']}, "
        f"{rec['bound_ms'] / ms:.1%} of it), {plain_text(rec)}; registers "
        f"{rec['registers']}")
    return rec


def radii_mode_record(mc, mob, pk, r, v, radii, domain, box, report, what,
                      n_rhs):
    """P1's image-box or free-surface instance at a path's full shape in
    float32 against its float64 plain version on the first 1024 targets
    (within IMG_BOUND x max|ref|), twice bit-identical, timed alternating
    with the open wall instance on the same inputs. The bound counts each
    unordered pair once: its far form (the free surface's image with it)
    per box, the box sum and the closed block's apply both ways, the
    minimum image; the pairs inside contact take the full path."""
    n = r.shape[0]
    kw = dict(domain=domain, periodic_length=box)
    got = mc.radii_matvec(r, v, radii, 1.0, **kw)
    same = torch.equal(got, mc.radii_matvec(r, v, radii, 1.0, **kw))
    sub = 1024
    ref = torch.stack([mob.source_target_matvec(
        r.double(), r[:sub].double(), vb.double(), radii.double(),
        radii[:sub].double(), 1.0, domain=domain, periodic_length=box)
        for vb in v])
    err = (got[:, :sub].double() - ref).abs().max().item()
    rel = err / ref.abs().max().item()
    log(f"P1 {domain} in {box} {what} B={n_rhs} f32: first {sub} targets vs "
        f"plain f64 / max|ref| = {rel:.3e} (bound {IMG_BOUND:.0e}); repeat "
        f"bit-identical {same}")
    check(rel <= IMG_BOUND and same, f"P1 {domain} {box} B={n_rhs} at "
          f"{what}: {rel:.3e}, bit-identical {same}")
    ms, open_ms = alternating_ms([
        lambda: mc.radii_matvec(r, v, radii, 1.0, **kw),
        lambda: mc.radii_matvec(r, v, radii, 1.0, domain="single_wall")])
    plain = plain_fields(lambda k: torch.stack([
        mob.source_target_matvec(r, r[:k], vb, radii, radii[:k], 1.0,
                                 domain=domain, periodic_length=box)
        for vb in v]), n, 2 * pk._default_row_tile(n, n, 4))
    wall = domain == "single_wall"
    far = P1_FAR_FLOPS[wall] + (P1_FS_FLOPS if domain == "free_surface"
                                else 0)
    mufu = P1_PAIR_MUFU[wall] + (domain == "free_surface")
    periodic = sum(1 for x in box if x > 0)
    nb = len(pk.box_offsets(box))
    if periodic:
        per_pair = (nb * (far + P1_BOX_SUM_FLOPS) + K1_BOX_CLOSE_FLOPS
                    + P1_BLOCK_APPLY_FLOPS * n_rhs
                    + K1_IMAGE_FLOPS * periodic)
    else:
        per_pair = far + P1_APPLY_FLOPS * n_rhs
    pairs = n * (n + 1) // 2
    nbytes = 4 * n * (5 + 6 * n_rhs)
    rec = dict(max_abs_err=err, ms=ms, **plain,
               **bound_record(nbytes, pairs * per_pair, pairs * nb * mufu))
    geom = ("RadiiOpen" if not periodic else "PlaneBoxes"
            if min(box[0], box[1]) > 4.04 * float(radii.max())
            and box[2] == 0 else "ImageBoxes")
    if domain == "free_surface" and geom == "PlaneBoxes":
        recount = pairs * (nb * FS_MOMENT_BOX_FLOPS + FS_MOMENT_CLOSE_FLOPS
                           + P1_S2_FLOPS + P1_BLOCK_APPLY_FLOPS * n_rhs
                           + K1_IMAGE_FLOPS * periodic)
        rec["recount_ms"] = bound_record(nbytes, recount,
                                         pairs * nb * mufu)["bound_ms"]
    code = pk.MODE_CODE[mob.DOMAIN_MODE[domain]]
    rec["registers"] = (instance_registers(
        report, f"radii_sym2_kernel<float, {n_rhs}>")
        if domain == "free_surface" and not periodic else instance_registers(
            report, "radii_sym_kernel", f"<float, {n_rhs}, {code}, ", geom))
    log(f"P1 {domain} in {box} {what} B={n_rhs} f32 ({geom}): kernel "
        f"{ms:.3f} ms (the open wall instance {open_ms:.3f} ms, "
        f"alternating), bound {rec['bound_ms']:.3f} ms ({rec['bound_by']}, "
        f"{rec['bound_ms'] / ms:.1%} of it), {plain_text(rec)}; registers "
        f"{rec['registers']}")
    return rec


def k5_open_record(ck, forces, r, L3, cap, report, what):
    """K5's open instance at a path's layout in float32 against its plain
    version in float64 (the u32 sqrt(27 cap) bound of the cell sweeps),
    twice bit-identical, timed; returns its record and the layout's
    overflow."""
    pos, dims, table, dropped, frame, members = forces.open_force_cells(
        r, L3, MONOLAYER_CUTOFF, MONOLAYER_GRID, cap)
    law = dict(eps_over_b=0.2 / 0.2, inv_b=1 / 0.2, two_a=2 * A_BENCH)
    got = ck.nl_forces_open(pos, table, dims, L3, frame, members, cap, **law)
    same = torch.equal(got, ck.nl_forces_open(pos, table, dims, L3, frame,
                                              members, cap, **law))
    ref = ck.nl_forces_open_plain(pos.double(), table, dims, L3, members,
                                  cap, **law)
    err = (got.double() - ref).abs().max().item()
    rel = err / ref.abs().max().item()
    bound = k5_bound_f32(cap)
    ms = cuda_ms(lambda: ck.nl_forces_open(pos, table, dims, L3, frame,
                                           members, cap, **law), 10)
    plain_ms = cuda_ms(lambda: ck.nl_forces_open_plain(
        pos, table, dims, L3, members, cap, **law), 1, warmup=False)
    # the work: every blob against the listed blobs of its stencil's
    # valid cells
    n = pos.shape[0]
    listed = (table.reshape(-1, cap) < n).sum(1).reshape(*dims).double()
    occ = (members[1][1:] - members[1][:-1]).reshape(*dims).double()
    stencil = torch.zeros_like(listed)
    for ox in (-1, 0, 1):
        for oy in (-1, 0, 1):
            for oz in (-1, 0, 1):
                s = listed
                for ax, o in ((0, ox), (1, oy), (2, oz)):
                    if o == 0:
                        continue
                    # s[c] = listed[c + o], wrapped; an open axis's edge
                    # cell has no neighbor past it
                    s = torch.roll(s, shifts=-o, dims=ax)
                    if L3[ax] <= 0:
                        idx = [slice(None)] * 3
                        idx[ax] = slice(-1, None) if o > 0 else slice(0, 1)
                        s[tuple(idx)] = 0
                stencil += s
    cand = int((occ * stencil).sum())
    rec, text = k5_bound(n, table, cand, cand - n)
    rec.update(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    rec["registers"] = instance_registers(report, "nl_forces_kernel<float, "
                                          "true>")
    log(f"K5 open {what} {n} blobs in {L3}, dims {dims}, cap {cap} f32: vs "
        f"plain f64 max err {err:.3e}, / max|ref| = {rel:.3e} (bound "
        f"{bound:.2e}); repeat bit-identical {same}; dropped {int(dropped)}; "
        f"{cand} candidate pairs ({cand / n:.0f} a blob); kernel {ms:.4f} "
        f"ms, plain f32 {plain_ms:.1f} ms; {text}, "
        f"{rec['bound_ms'] / ms:.1%} of it; registers {rec['registers']}")
    check(rel <= bound and same, f"K5 open {what}: {rel:.3e}, "
          f"bit-identical {same}")
    return rec, int(dropped)


def phase_domains_small(pk, mc, ck, forces, mob):
    """21k at small shapes: every new instance against its plain version in
    float32 (IMG_BOUND x max|ref|; K5 the u32 sqrt(27 cap) bound) and
    float64 (1e-12), twice bit-identical: K1 free-surface tt (B = 1, 2,
    the open box, ImageBoxes, PlaneBoxes, both sweeps), in_plane tt and
    tr on the wall instances (u_z exactly 0), K3 free-surface (open and
    both policies), P1 images (B = 1, 2, both policies, the wall and the
    open domain) and free-surface (open and images), K5 open and partly
    periodic with overflowing cells."""
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(21)
    n = 2000
    r = np.empty((n, 3))
    r[:, :2] = rng.uniform(0, 12, (n, 2))
    r[:, 2] = rng.uniform(0.05, 4, n)
    r[5] = r[4]
    r[10, 2] = 0.0
    r[11] = r[10]
    bounds = {torch.float32: IMG_BOUND, torch.float64: 1e-12}
    for L in (None, (40.0, 40.0, 0.0), (40.0, 40.0, 13.0), (3.0, 3.0, 0.0)):
        boxes = None if L is None else (L, pk.box_offsets(L))
        for n_rhs in (1, 2):
            v = rng.normal(size=(n, 3 * n_rhs))
            for dtype, bound in bounds.items():
                q = torch.as_tensor(r / 0.3, dtype=dtype, device=dev)
                vt = torch.as_tensor(v, dtype=dtype, device=dev)
                fs_k1_check(pk, q, vt, boxes, n, f"{n} blobs in {L}", bound)
                kw = dict(coupling="tt", mode="free_surface",
                          self_interaction=True, boxes=boxes)
                sliced = pk.pair_matvec(q, q[:300].contiguous(), vt, **kw)
                ref = pk.pair_plain(q.double(), q[:300].double(),
                                    vt.double(), **kw)
                rel = ((sliced.double() - ref).abs().max()
                       / ref.abs().max()).item()
                check(rel <= bound, f"K1 tt_fs sliced in {L} B={n_rhs} "
                      f"{dtype}: {rel:.3e}")
    for coupling in ("tt", "tr"):
        for L in ((0.0, 0.0, 0.0), (12.0, 12.0, 0.0)):
            v = rng.normal(size=(2, n, 3))
            kw = dict(coupling=coupling, domain="in_plane",
                      periodic_length=L)
            ref = mob.pairwise_matvec_multi(
                torch.as_tensor(r, device=dev), None,
                torch.as_tensor(v, device=dev), 0.8, 0.3, **kw)
            for dtype, bound in bounds.items():
                got = mob.pairwise_matvec_multi(
                    torch.as_tensor(r, dtype=dtype, device=dev), None,
                    torch.as_tensor(v, dtype=dtype, device=dev), 0.8, 0.3,
                    **kw)
                rel = ((got.double() - ref).abs().max()
                       / ref.abs().max()).item()
                log(f"in_plane {coupling} {n} blobs in {L} {dtype} on the "
                    f"wall instance: vs f64 / max|ref| = {rel:.3e} (bound "
                    f"{bound:.0e}); u_z exactly 0 {not got[..., 2].any()}")
                check(rel <= bound and not got[..., 2].any(),
                      f"in_plane {coupling} {L} {dtype}: {rel:.3e}")
    for L in ((0.0, 0.0, 0.0), (12.0, 12.0, 0.0), (12.0, 12.0, 4.0)):
        for dtype, bound in bounds.items():
            rt = torch.as_tensor(r[:700], dtype=dtype, device=dev)
            m = mc.dense_tt(rt, 0.8, 0.3, mode="free_surface",
                            periodic_length=L)
            same = torch.equal(m, mc.dense_tt(rt, 0.8, 0.3,
                                              mode="free_surface",
                                              periodic_length=L))
            ref = mc.dense_tt_plain(rt.double(), 0.8, 0.3,
                                    mode="free_surface", periodic_length=L)
            rel = ((m.double() - ref).abs().max() / ref.abs().max()).item()
            log(f"K3 dense_tt_fs 700 blobs in {L} {dtype}: vs plain f64 / "
                f"max|ref| = {rel:.3e} (bound {bound:.0e}); exact transpose "
                f"{torch.equal(m, m.T)}, repeat bit-identical {same}")
            check(rel <= bound and same and torch.equal(m, m.T),
                  f"K3 dense_tt_fs {L} {dtype}: {rel:.3e}")
    rad = rng.uniform(0.08, 0.3, n)
    rp = r.copy()
    rp[:, :2] *= 0.5
    for domain, L in (("single_wall", (9.0, 8.0, 0.0)),
                      ("no_wall", (9.0, 8.0, 0.0)),
                      ("single_wall", (1.0, 1.0, 0.0)),
                      ("no_wall", (9.0, 8.0, 7.0)),
                      ("free_surface", (0.0, 0.0, 0.0)),
                      ("free_surface", (9.0, 8.0, 0.0)),
                      ("free_surface", (9.0, 8.0, 7.0))):
        for n_rhs in (1, 2):
            v = rng.normal(size=(n_rhs, n, 3))
            for dtype, bound in bounds.items():
                args = [torch.as_tensor(x, dtype=dtype, device=dev)
                        for x in (rp, v, rad)]
                kw = dict(domain=domain, periodic_length=L)
                got = mc.radii_matvec(*args, 1.0, **kw)
                same = torch.equal(got, mc.radii_matvec(*args, 1.0, **kw))
                ref = mc.radii_matvec_plain(*(x.double() for x in args),
                                            1.0, **kw)
                rel = ((got.double() - ref).abs().max()
                       / ref.abs().max()).item()
                log(f"P1 {domain} {n} blobs in {L} B={n_rhs} {dtype}: vs "
                    f"plain f64 / max|ref| = {rel:.3e} (bound {bound:.0e}); "
                    f"repeat bit-identical {same}")
                check(rel <= bound and same, f"P1 {domain} {L} B={n_rhs} "
                      f"{dtype}: {rel:.3e}")
    for L3 in ((0.0, 0.0, 0.0), (30.0, 30.0, 0.0)):
        for cap in (256, 6):
            rr = np.empty((6000, 3))
            rr[:, :2] = rng.uniform(-2.0, 32.0, (6000, 2))
            rr[:, 2] = rng.uniform(0.2, 2.0, 6000)
            for dtype in bounds:
                pos, dims, table, dropped, frame, members = (
                    forces.open_force_cells(
                        torch.as_tensor(rr, dtype=dtype, device=dev), L3,
                        1.9, 16, cap))
                law = dict(eps_over_b=1.0, inv_b=4.0, two_a=0.4)
                got = ck.nl_forces_open(pos, table, dims, L3, frame,
                                        members, cap, **law)
                same = torch.equal(got, ck.nl_forces_open(
                    pos, table, dims, L3, frame, members, cap, **law))
                ref = ck.nl_forces_open_plain(pos.double(), table, dims, L3,
                                              members, cap, **law)
                rel = ((got.double() - ref).abs().max()
                       / ref.abs().max()).item()
                bound = (1e-12 if dtype == torch.float64 else k5_bound_f32(
                    cap))
                log(f"K5 open 6000 blobs in {L3} cap {cap} {dtype}: dropped "
                    f"{int(dropped)}; vs plain f64 / max|ref| = {rel:.3e} "
                    f"(bound {bound:.2e}); repeat bit-identical {same}")
                check(rel <= bound and same, f"K5 open {L3} cap {cap} "
                      f"{dtype}: {rel:.3e}")


GMRES_MAXITER = 300
# GMRES's cap in the smoke's runs whose solves stop at the cap on the
# reference's semantics (the free surface in a box, in_plane's Slip-Trapz
# at 21d): they check that their kernels launch on the path and that the
# step stays finite, and rank nothing (their launches are of solves that
# do not converge); tools/torch_phase_times.py --phases 21 runs them at
# GMRES_MAXITER
CAPPED_MAXITER = 60


def _domain_steps(system, scheme, pos, quat, n_steps,
                  maxiter=GMRES_MAXITER):
    """n_steps of `scheme` (float32 on the card) with GMRES capped at
    maxiter sweeps a solve, each timed on the host clock between
    synchronizes (the first includes the engine's builds); returns (final
    state, ms list, aux list)."""
    from rigidmultiblobswall_tpu_torch.models import integrators
    from rigidmultiblobswall_tpu_torch.models.system import make_state

    dev = torch.device(DEVICE)
    st = make_state(pos, quat, dtype=torch.float32, device=dev)
    step = integrators.make_stepper(
        system, scheme, 1e-3, lanczos_tolerance=5e-4, lanczos_max_iter=32,
        lanczos_check_every=4, gmres_restart=60, gmres_maxiter=maxiter,
        max_rejections=3)
    carry = integrators.init_carry(system, state=st)
    gen = torch.Generator(device=dev).manual_seed(0)
    times, auxes = [], []
    for _ in range(n_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, carry, aux = step(st, gen, carry)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        auxes.append(aux)
    return st, times, auxes


# why some of phase 21's runs stop at GMRES's cap, as the JAX package's
# do on the same semantics (tests/test_torch_domains.py)
CAPPED_BOX_FS = ("the free surface's 3 x 3 box sum is indefinite at the "
                 "lattice's packing")
CAPPED_IN_PLANE = ("Slip-Trapz's random finite difference slips blobs "
                   "along z, where the projected mobility has no rows: "
                   "the saddle system is inconsistent")


def _converged(auxes, what, capped=None, maxiter=GMRES_MAXITER):
    """Whether each step's solves converged (each GMRES residual under the
    solver tolerance), as a log fragment. A run with `capped` None fails
    the check if one did not; `capped` names why a run's solves may stop
    at GMRES's cap (maxiter), logged with the run marked NOT CONVERGED
    (its step times are then of solves cut at the cap)."""
    conv = [bool(a.solves_converged) for a in auxes]
    if capped is None:
        check(all(conv), f"{what}: a solve did not converge ({conv})")
    if all(conv):
        return f"converged {conv}"
    return (f"converged {conv}, NOT CONVERGED: GMRES at its cap of "
            f"{maxiter} a solve, since {capped}")


def _launch_counts(pk, mc, ck):
    """The launches of the instances phase 21 follows, by record name."""
    out = {f"K1 tt_fs B={b}": pk.LAUNCHES["tt_fs", b] for b in (1, 2)}
    out.update({f"K1 tt_fs images B={b}": pk.IMAGE_LAUNCHES["tt_fs", b,
                                                             "sym"]
                for b in (1, 2)})
    out.update({f"K1 tt B={b}": pk.LAUNCHES["tt", b] for b in (1, 2)})
    out["K3 fs"] = mc.DENSE_TT_LAUNCHES["free_surface", False]
    out["K3 fs images"] = mc.DENSE_TT_LAUNCHES["free_surface", True]
    out["K3"] = mc.DENSE_TT_LAUNCHES["wall", False]
    out["K4"] = mc.SYMM_LAUNCHES
    for (b, m, img), k in mc.RADII_LAUNCHES.items():
        if k:
            out[f"P1 {m}{' images' if img else ''} B={b}"] = k
    out["K5 open"] = ck.LAUNCHES["nl_forces_open"]
    out["K2"] = mc.LAUNCHES
    out["K2 periodic"] = mc.PERIODIC_LAUNCHES
    return {k: v for k, v in out.items() if v}


def phase_domains(pk, mc, ck, lap, mob, kin, report):
    """Phase 21, the last single-device domains at full width, float32
    (21f float64): in_plane and free_surface on the direct engine,
    per-blob radii in image boxes and on the free surface, and linked-cell
    forces in open and partly periodic boxes (K1's free-surface tt
    instance, open and in image boxes; in_plane on K1's wall instances
    between projections; K3's free-surface instance; P1's image-box and
    free-surface instances; K5's open instance):
      21k the kernel checks at small shapes (phase_domains_small), and
          each instance at its path's shape against its plain version,
          timed over five alternating runs;
      21a free_surface on phase 6's scene (4096 shells, 49,152 blobs),
          matrix-free, forward Euler and Slip-Trapz, then one Slip-Trapz
          step in phase 20a's (25.6, 25.6, 0) box;
      21b the in_plane monolayer: the 4096 shells on a 64 x 64 lattice at
          spacing 1.6 and height 2.0 in an open box, linked-cell forces
          (cutoff 2a + 30 b, grid_dim 16, the capacity sized at the
          start), forward Euler and Slip-Trapz; every K1 product's u_z
          exactly 0, the bodies' z velocities within the solver tolerance
          of the largest in-plane one, no cell overflowing;
      21c that monolayer in (102.4, 102.4, 0) above the wall with phase
          18's bidisperse shells: one forward Euler and one Slip-Trapz
          step (P1's image boxes, K5 partly periodic);
      21d phase 9's 1024 shells under free_surface (open, and in phase
          20b's (17.6, 17.6, 0) box) and under in_plane, one materialized
          Slip-Trapz step each;
      21e phase 18's bidisperse scene under free_surface, two forward
          Euler steps and one Slip-Trapz step (P1 free surface B = 2),
          then forward Euler in 20a's box;
      21f two 64-shell input files through the CLI on the card and on the
          CPU in float64 (a numba_free_surface implementation line;
          domain in_plane with tree forces), to 1e-10.
    Every run's solves must converge, but for the free surface's in a box
    and in_plane's Slip-Trapz, whose saddle systems are indefinite or
    inconsistent on the JAX package's semantics (CAPPED_BOX_FS,
    CAPPED_IN_PLANE): their runs are logged NOT CONVERGED where GMRES
    stops at its cap, CAPPED_MAXITER in the free surface's boxes (21a,
    21d, 21e) and at 21d's in_plane step. Returns (records, launches) for
    the kernel JSON line."""
    from rigidmultiblobswall_tpu_torch.models import solvers
    from rigidmultiblobswall_tpu_torch.models.system import make_state
    from rigidmultiblobswall_tpu_torch.ops import forces

    t_phase = time.perf_counter()
    dev = torch.device(DEVICE)
    records, launches = {}, {}
    g = torch.Generator(device=dev).manual_seed(21)

    phase_domains_small(pk, mc, ck, forces, mob)
    log(f"21k small shapes: {time.perf_counter() - t_phase:.1f} s")

    # 21a: free_surface on phase 6's scene
    system = bench_system(N_SHELLS, domain="free_surface")
    pos, quat = lattice(N_SHELLS)
    st = make_state(pos, quat, dtype=torch.float32, device=dev)
    r = kin.blob_positions(system, st).contiguous()
    n = r.shape[0]
    q = (r / A_BENCH).contiguous()
    box = xy_box(L_FS_IMAGES)
    La = tuple(x / A_BENCH for x in box)
    for n_rhs in (1, 2):
        v = torch.randn((n, 3 * n_rhs), generator=g, device=dev)
        records[f"fs_b{n_rhs}"] = fs_k1_record(pk, q, v, None, report,
                                               f"{n} blobs")
        fs_k1_check(pk, q.double(), v.double(), None, 256, f"{n} blobs",
                    1e-12)
        records[f"fs_img_b{n_rhs}"] = fs_k1_record(pk, q, v, La, report,
                                                   f"{n} blobs in {box}")
        fs_k1_check(pk, q.double(), v.double(), (La, pk.box_offsets(La)),
                    128, f"{n} blobs in {box}", 1e-12)
    a_launches = {}
    for scheme, sys_, n_steps in (
            ("deterministic_forward_euler", system, 3),
            ("stochastic_Slip_Trapz", system, 3),
            ("stochastic_Slip_Trapz",
             bench_system(N_SHELLS, domain="free_surface",
                          periodic_length=box), 1)):
        cap = GMRES_MAXITER if sys_ is system else CAPPED_MAXITER
        _reset_counts(pk, mc, ck, lap)
        st, times, auxes = _domain_steps(sys_, scheme, pos, quat, n_steps,
                                         cap)
        counts = _launch_counts(pk, mc, ck)
        for k, v_ in counts.items():
            a_launches[k] = a_launches.get(k, 0) + v_
        where = "" if sys_ is system else f" in {box}"
        conv = _converged(auxes, f"21a {scheme}{where}",
                          None if sys_ is system else CAPPED_BOX_FS, cap)
        log(f"21a multibody-49k-free-surface{where} {n} blobs {scheme} f32: "
            f"{_fmt(times)} ms/step (the first with the engine's set-up); "
            f"gmres "
            f"{[a.det_iterations for a in auxes]}, {conv}, lanczos "
            f"{[a.stoch_iterations for a in auxes]}, rejections "
            f"{[a.rejections for a in auxes]}; launches {counts}")
        check(bool(torch.isfinite(st.pos).all()), f"21a {scheme}: positions")
        check(min(a.det_iterations for a in auxes) > 0, f"21a {scheme}: no "
              "GMRES iterations")
        want = ("K1 tt_fs B=1" if sys_ is system
                else "K1 tt_fs images B=1")
        check(counts.get(want, 0) > 0 and counts.get("K2", 0) + counts.get(
            "K2 periodic", 0) > 0 and "K1 tt B=1" not in counts,
              f"21a {scheme}{where}: {want} or K2 not launched, or the "
              f"wall's tt ran ({counts})")
        if scheme == "stochastic_Slip_Trapz":
            want = want.replace("B=1", "B=2")
            check(counts.get(want, 0) > 0, f"21a Slip-Trapz{where}: {want} "
                  "not launched")
    launches.update(a_launches)
    log(f"21a: {time.perf_counter() - t_phase:.1f} s")

    # 21b: the in_plane monolayer, open box, linked-cell forces
    mpos, mquat = monolayer()
    system = bench_system(len(mpos), domain="in_plane",
                          blob_blob_force_method="neighbor_list",
                          blob_blob_cutoff=MONOLAYER_CUTOFF,
                          blob_blob_grid_dim=MONOLAYER_GRID)
    st = make_state(mpos, mquat, dtype=torch.float32, device=dev)
    r = kin.blob_positions(system, st).contiguous()
    n = r.shape[0]
    system = forces.auto_force_cell_capacity(system, r, log=log)
    cap = system.blob_blob_cell_capacity
    records["K5_open"], dropped = k5_open_record(
        ck, forces, r, (0.0, 0.0, 0.0), cap, report, "21b")
    check(dropped == 0, "21b: a cell overflowed at the start")
    uz = []
    orig = mob.pairwise_matvec_multi

    def spy(*a, **k):
        out = orig(*a, **k)
        if k.get("domain") == "in_plane":
            uz.append(out[..., 2].abs().max())
        return out

    b_launches = {}
    mob.pairwise_matvec_multi = spy
    try:
        for scheme in ("deterministic_forward_euler",
                       "stochastic_Slip_Trapz"):
            _reset_counts(pk, mc, ck, lap)
            st, times, auxes = _domain_steps(system, scheme, mpos, mquat, 2)
            counts = _launch_counts(pk, mc, ck)
            for k, v_ in counts.items():
                b_launches[k] = b_launches.get(k, 0) + v_
            rb = kin.blob_positions(system, st)
            over = forces.force_cells_dropped(system, rb)
            dz = float((st.pos[:, 2] - MONOLAYER_HEIGHT).abs().max())
            conv = _converged(auxes, f"21b {scheme}", CAPPED_IN_PLANE if
                              scheme == "stochastic_Slip_Trapz" else None)
            log(f"21b monolayer-49k-in-plane {n} blobs in an open box, "
                f"linked cells (cap {cap}) {scheme} f32: {_fmt(times)} "
                f"ms/step (the first with the set-up); gmres "
                f"{[a.det_iterations for a in auxes]}, {conv}, lanczos "
                f"{[a.stoch_iterations for a in auxes]}, rejections "
                f"{[a.rejections for a in auxes]}; launches {counts}; cells "
                f"overflowing {over}; largest height change {dz:.3e}")
            check(bool(torch.isfinite(st.pos).all()) and over == 0,
                  f"21b {scheme}: positions or overflow ({over})")
            check(counts.get("K1 tt B=1", 0) > 0
                  and counts.get("K5 open", 0) > 0,
                  f"21b {scheme}: K1 tt (wall) or K5 open not launched "
                  f"({counts})")
    finally:
        mob.pairwise_matvec_multi = orig
    largest_uz = float(torch.stack(uz).max()) if uz else float("nan")
    check(uz and largest_uz == 0.0, f"21b: a K1 product's u_z was not 0 "
          f"({largest_uz}, {len(uz)} products)")
    st = make_state(mpos, mquat, dtype=torch.float32, device=dev)
    sol = solvers.solve_mobility_problem(system, st, restart=60,
                                         maxiter=300)
    U = sol.velocities
    vz = float(U[:, 2].abs().max())
    vxy = float(U[:, :2].abs().max())
    log(f"21b: {len(uz)} in_plane products, largest |u_z| {largest_uz}; "
        f"the solve's bodies: largest |v_z| {vz:.3e} against the largest "
        f"in-plane {vxy:.3e} (bound {system.solver_tolerance:.0e} of it)")
    check(vz <= system.solver_tolerance * vxy, f"21b: body z velocity "
          f"{vz:.3e} over {system.solver_tolerance} x {vxy:.3e}")
    launches.update({f"21b {k}": v_ for k, v_ in b_launches.items()})
    log(f"21b: {time.perf_counter() - t_phase:.1f} s")

    # 21c: the bidisperse monolayer in (102.4, 102.4, 0) above the wall
    box = xy_box(L_MONOLAYER)
    system = radii_system(len(mpos), periodic_length=box,
                          blob_blob_force_method="neighbor_list",
                          blob_blob_cutoff=MONOLAYER_CUTOFF,
                          blob_blob_grid_dim=MONOLAYER_GRID)
    cpos, cquat = alternate(mpos, mquat)
    st = make_state(cpos, cquat, dtype=torch.float32, device=dev)
    r = kin.blob_positions(system, st).contiguous()
    n = r.shape[0]
    radii = torch.tensor(system.blob_radii, dtype=torch.float32, device=dev)
    system = forces.auto_force_cell_capacity(system, r, log=log)
    cap = system.blob_blob_cell_capacity
    records["K5_partly"], dropped = k5_open_record(
        ck, forces, r, box, cap, report, "21c")
    check(dropped == 0, "21c: a cell overflowed at the start")
    for n_rhs in (1, 2):
        v = torch.randn((n_rhs, n, 3), generator=g, device=dev)
        records[f"p1_img_b{n_rhs}"] = radii_mode_record(
            mc, mob, pk, r, v, radii, "single_wall", box, report, f"{n} blobs",
            n_rhs)
    c_launches = {}
    for scheme in ("deterministic_forward_euler", "stochastic_Slip_Trapz"):
        _reset_counts(pk, mc, ck, lap)
        st, times, auxes = _domain_steps(system, scheme, cpos, cquat, 1)
        counts = _launch_counts(pk, mc, ck)
        for k, v_ in counts.items():
            c_launches[k] = c_launches.get(k, 0) + v_
        over = forces.force_cells_dropped(system,
                                          kin.blob_positions(system, st))
        conv = _converged(auxes, f"21c {scheme}")
        log(f"21c monolayer-49k-radii-pseudo-periodic {n} blobs in {box} "
            f"{scheme} f32: one step {_fmt(times)} ms (with the set-up); "
            f"gmres {[a.det_iterations for a in auxes]}, {conv}, "
            f"lanczos {[a.stoch_iterations for a in auxes]}; launches "
            f"{counts}; cells overflowing {over}")
        check(bool(torch.isfinite(st.pos).all()) and over == 0,
              f"21c {scheme}: positions or overflow")
        check(counts.get("P1 wall images B=1", 0) > 0
              and counts.get("K5 open", 0) > 0, f"21c {scheme}: P1 images "
              f"or K5 open not launched ({counts})")
    launches.update({f"21c {k}": v_ for k, v_ in c_launches.items()})
    log(f"21c: {time.perf_counter() - t_phase:.1f} s")

    # 21d: phase 9's 1024 shells, materialized
    pos_d, quat_d = lattice(N_DENSE)
    st = make_state(pos_d, quat_d, dtype=torch.float32, device=dev)
    sys_fs = bench_system(N_DENSE, domain="free_surface")
    r = kin.blob_positions(sys_fs, st).contiguous()
    nd = r.shape[0]
    n3 = 3 * nd
    m = mc.dense_tt(r, 1.0, A_BENCH, mode="free_surface")
    ref = mc.dense_tt_plain(r.double(), 1.0, A_BENCH, mode="free_surface")
    err, scale = _chunked_err(m, lambda r0, r1: ref[r0:r1], n3)
    del ref
    transposed = exact_transpose(m)
    same = torch.equal(m, mc.dense_tt(r, 1.0, A_BENCH, mode="free_surface"))
    del m
    ms, wall_ms = alternating_ms([
        lambda: mc.dense_tt(r, 1.0, A_BENCH, mode="free_surface"),
        lambda: mc.dense_tt(r, 1.0, A_BENCH, mode="wall")])
    plain_ms = cuda_ms(lambda: mc.dense_tt_plain(
        r, 1.0, A_BENCH, mode="free_surface"), 1, warmup=False)
    rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
               **bound_record(4 * (n3 * n3 + n3), nd * (nd + 1) // 2 * (
                   K1_FS_CONDENSE_FLOPS + K3_PAIR_FLOPS - 70),
                   nd * (nd + 1) // 2 * K1_FS_MUFU))
    rec["registers"] = instance_registers(report, "dense_tt_kernel<float, "
                                          "false, pairk::OpenBox<float>, "
                                          "true>")
    records["K3_fs"] = rec
    log(f"K3 dense_tt_fs {nd} blobs f32 vs plain f64: max err {err:.3e}, / "
        f"max|ref| = {err / scale:.3e} (bound {IMG_BOUND:.0e}); exact "
        f"transpose {transposed}, repeat bit-identical {same}; kernel "
        f"{ms:.3f} ms (the wall's K3 {wall_ms:.3f} ms, alternating), bound "
        f"{rec['bound_ms']:.3f} ms ({rec['bound_by']}, "
        f"{rec['bound_ms'] / ms:.1%} of it), plain f32 {plain_ms:.1f} ms; "
        f"registers {rec['registers']}")
    check(err <= IMG_BOUND * scale and transposed and same,
          f"K3 dense_tt_fs at {nd} blobs")
    dbox = xy_box(L_PSEUDO_DENSE)
    m = mc.dense_tt(r, 1.0, A_BENCH, mode="free_surface",
                    periodic_length=dbox)
    ref = mc.dense_tt_plain(r.double(), 1.0, A_BENCH, mode="free_surface",
                            periodic_length=dbox)
    err, scale = _chunked_err(m, lambda r0, r1: ref[r0:r1], n3)
    del ref
    transposed = exact_transpose(m)
    del m
    ms, img_wall_ms = alternating_ms([
        lambda: mc.dense_tt(r, 1.0, A_BENCH, mode="free_surface",
                            periodic_length=dbox),
        lambda: mc.dense_tt(r, 1.0, A_BENCH, mode="wall",
                            periodic_length=dbox)])
    plain_ms = cuda_ms(lambda: mc.dense_tt_plain(
        r, 1.0, A_BENCH, mode="free_surface", periodic_length=dbox), 1,
        warmup=False)
    nbx = len(pk.box_offsets(dbox))
    rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
               **bound_record(4 * (n3 * n3 + n3), nd * (nd + 1) // 2 * (
                   nbx * (K1_FS_CONDENSE_FLOPS + K1_BOX_SUM_FLOPS)
                   + K3_PAIR_FLOPS - 70 + 2 * K1_IMAGE_FLOPS),
                   nd * (nd + 1) // 2 * nbx * K1_FS_MUFU))
    rec["registers"] = instance_registers(report, "dense_tt_kernel<float, "
                                          "false, pairk::PlaneBoxes<float>, "
                                          "true>")
    records["K3_fs_img"] = rec
    log(f"K3 dense_tt_fs images {nd} blobs in {dbox} f32 vs plain f64: max "
        f"err {err:.3e}, / max|ref| = {err / scale:.3e}; exact transpose "
        f"{transposed}; kernel {ms:.3f} ms (the wall's K3 images "
        f"{img_wall_ms:.3f} ms, alternating), bound {rec['bound_ms']:.3f} "
        f"ms ({rec['bound_by']}, {rec['bound_ms'] / ms:.1%} of it), plain "
        f"f32 {plain_ms:.1f} ms; registers {rec['registers']}")
    check(err <= IMG_BOUND * scale and transposed, f"K3 dense_tt_fs images "
          f"at {nd} blobs")
    d_launches = {}
    for name, sys_ in (("free_surface", sys_fs),
                       ("free_surface in a box",
                        bench_system(N_DENSE, domain="free_surface",
                                     periodic_length=dbox)),
                       ("in_plane", bench_system(N_DENSE,
                                                 domain="in_plane"))):
        capped = {"free_surface": None,
                  "free_surface in a box": CAPPED_BOX_FS,
                  "in_plane": CAPPED_IN_PLANE}[name]
        cap = GMRES_MAXITER if capped is None else CAPPED_MAXITER
        _reset_counts(pk, mc, ck, lap)
        torch.cuda.reset_peak_memory_stats()
        st, times, auxes = _domain_steps(sys_, "stochastic_Slip_Trapz",
                                         pos_d, quat_d, 1, cap)
        counts = _launch_counts(pk, mc, ck)
        for k, v_ in counts.items():
            d_launches[k] = d_launches.get(k, 0) + v_
        conv = _converged(auxes, f"21d {name}", capped, cap)
        log(f"21d multibody-12k-dense {name} {nd} blobs "
            f"stochastic_Slip_Trapz f32, materialized: one step "
            f"{_fmt(times)} ms (the builds included); gmres "
            f"{[a.det_iterations for a in auxes]}, {conv}, lanczos "
            f"{[a.stoch_iterations for a in auxes]}; launches {counts}; "
            f"peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        check(bool(torch.isfinite(st.pos).all()), f"21d {name}: positions")
        want = {"free_surface": "K3 fs", "free_surface in a box":
                "K3 fs images", "in_plane": "K3"}[name]
        check(counts.get(want, 0) > 0 and counts.get("K4", 0) > 0,
              f"21d {name}: {want} or K4 not launched ({counts})")
    launches.update({f"21d {k}": v_ for k, v_ in d_launches.items()})
    log(f"21d: {time.perf_counter() - t_phase:.1f} s")

    # 21e: phase 18's bidisperse scene on the free surface
    system = radii_system(N_SHELLS, domain="free_surface")
    epos, equat = alternate(*lattice(N_SHELLS))
    st = make_state(epos, equat, dtype=torch.float32, device=dev)
    r = kin.blob_positions(system, st).contiguous()
    n = r.shape[0]
    radii = torch.tensor(system.blob_radii, dtype=torch.float32, device=dev)
    box = xy_box(L_FS_IMAGES)
    v = torch.randn((2, n, 3), generator=g, device=dev)
    records["p1_fs"] = radii_mode_record(
        mc, mob, pk, r, v[:1], radii, "free_surface", (0.0, 0.0, 0.0),
        report, f"{n} blobs", 1)
    records["p1_fs_b2"] = radii_mode_record(
        mc, mob, pk, r, v, radii, "free_surface", (0.0, 0.0, 0.0), report,
        f"{n} blobs", 2)
    records["p1_fs_img"] = radii_mode_record(
        mc, mob, pk, r, v[:1], radii, "free_surface", box, report,
        f"{n} blobs", 1)
    e_launches = {}
    # two forward Euler steps and one Slip-Trapz step (its lockstep pair
    # on P1 free surface B = 2), then forward Euler in the box
    for sys_, scheme, n_steps in (
            (system, "deterministic_forward_euler", 2),
            (system, "stochastic_Slip_Trapz", 1),
            (radii_system(N_SHELLS, domain="free_surface",
                          periodic_length=box),
             "deterministic_forward_euler", 1)):
        cap = GMRES_MAXITER if sys_ is system else CAPPED_MAXITER
        _reset_counts(pk, mc, ck, lap)
        st, times, auxes = _domain_steps(sys_, scheme, epos, equat, n_steps,
                                         cap)
        counts = _launch_counts(pk, mc, ck)
        for k, v_ in counts.items():
            e_launches[k] = e_launches.get(k, 0) + v_
        where = "" if sys_ is system else f" in {box}"
        conv = _converged(auxes, f"21e {scheme}{where}",
                          None if sys_ is system else CAPPED_BOX_FS, cap)
        log(f"21e multibody-49k-radii-free-surface{where} {n} blobs {scheme} "
            f"f32: {_fmt(times)} ms/step (the first with the set-up); "
            f"gmres "
            f"{[a.det_iterations for a in auxes]}, {conv}, lanczos "
            f"{[a.stoch_iterations for a in auxes]}; launches {counts}")
        check(bool(torch.isfinite(st.pos).all()), f"21e{where}: positions")
        want = "P1 free_surface B=1" if sys_ is system else (
            "P1 free_surface images B=1")
        if scheme == "stochastic_Slip_Trapz":
            want = "P1 free_surface B=2"
        check(counts.get(want, 0) > 0, f"21e {scheme}{where}: {want} not "
              f"launched ({counts})")
    launches.update({f"21e {k}": v_ for k, v_ in e_launches.items()})
    log(f"21e: {time.perf_counter() - t_phase:.1f} s")

    # 21f: the CLI
    phase_domains_cli()
    for key, rec in records.items():
        recount = rec.pop("recount_ms", None)
        recount = ("" if recount is None else f"; recounted by the box "
                   f"sum's coefficients {recount:.4f} ms, "
                   f"{recount / rec['ms']:.1%}")
        log(f"phase 21 {key}: {rec['ms']:.4f} ms, "
            f"{rec['bound_ms'] / rec['ms']:.1%} of its bound "
            f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}){recount}; "
            f"registers {rec.pop('registers')}")
    log(f"phase 21: {time.perf_counter() - t_phase:.1f} s")
    return records, launches


def phase_domains_cli():
    """21f: two generated 64-shell input files (bench physics at kT 0,
    solver tolerance 1e-12) through the CLI on the card and on the CPU in
    float64, 3 steps: one selecting the free surface by a
    numba_free_surface implementation line (phase 6's lattice,
    Slip-Trapz), one with domain in_plane and tree blob-blob forces (21b's
    monolayer at 8 x 8 shells, forward Euler: Slip-Trapz's random finite
    difference puts a z slip on blobs without z mobility, and its solve
    runs GMRES to the cap, as the JAX package's does); the .clones agree
    to 1e-10 of the displacement."""
    for name, extra in (
            ("free_surface", "mobility_vector_prod_implementation "
             "numba_free_surface\n"),
            ("in_plane_tree", "domain in_plane\n"
             "blob_blob_force_implementation tree\n")):
        pos, quat = (lattice(64, seed=4) if name == "free_surface"
                     else monolayer(8, seed=4))
        scheme = ("stochastic_Slip_Trapz" if name == "free_surface"
                  else "deterministic_forward_euler")
        pos = pos.astype(np.float64)

        def make(dd):
            inp = write_shell_input(dd, pos, quat, (
                f"scheme {scheme}\ndt 0.002\nn_steps 3\nn_save 3\n"
                "solver_tolerance 1e-12\n" + extra))
            text = open(inp).read().replace("kT 0.05", "kT 0.0")
            if "tree" in extra:
                text = text.replace(
                    "blob_blob_force_implementation python\n", "")
            open(inp, "w").write(text)
            return "input.dat"

        out = run_cli_pair(make)
        err, disp = clones_error(out, ["run.shell.00000003.clones"], pos)
        log(f"21f CLI {name} 64 shells {scheme} f64: card "
            f"{out['card'][1]:.2f} s, "
            f"CPU {out['host'][1]:.2f} s; card vs CPU max err {err:.3e}, "
            f"largest displacement {disp:.3e} (bound 1e-10 of it)")
        check(disp > 0 and err <= 1e-10 * disp, f"21f CLI {name}: "
              f"{err:.3e} of {disp:.3e}")


# ---------------------------------------------------------------------------
# Phase 22: multiple devices (rigidmultiblobswall_tpu_torch/parallel)
# ---------------------------------------------------------------------------

# two gloo ranks share the one card (NCCL puts one rank on a card); one
# NCCL rank (world size 1) runs the products through the same code
N_RANKS = 2
# D = 2 against D = 1: products within P22_TOL x max|ref| (the wall
# products within K7's float32 bound, the JAX package's 2e-5), steps within
# the JAX entry point's _assert_parity tolerance
P22_TOL = 3e-6
P22_TOL_WALL = 2e-5
P22_STEP_TOL = 5e-5
P22_REPS = 3
# the group's collective timeout and the ranks' run limit (s)
P22_TIMEOUT_S = 120.0
P22_RUN_S = 420.0
SHARE_SRC = {"K1": "rigidmultiblobswall_tpu_torch/csrc/pair_tt.cu",
             "grand": "rigidmultiblobswall_tpu_torch/csrc/pair_couplings.cu",
             "K6": "rigidmultiblobswall_tpu_torch/csrc/near_rpy.cu",
             "K7": "rigidmultiblobswall_tpu_torch/csrc/wall_near.cu",
             "P2": "rigidmultiblobswall_tpu_torch/csrc/near_radii.cu"}


def p22_scenes(dev):
    """Phase 22's inputs on `dev`, built alike on every rank and in the
    parent from numpy seeds: phase 6's scene (49,152 blobs) with B = 1
    and 2 vectors, phase 7's 32,768 rollers with forces and torques, and
    the systems of phases 8 (spectral-98k), 19 (spectral-98k-radii) and 10
    (spectral-wall-98k) with their plans (capacities sized as there) and
    forces. float32."""
    from rigidmultiblobswall_tpu_torch.models import saddle
    from rigidmultiblobswall_tpu_torch.models import kinematics as kin
    from rigidmultiblobswall_tpu_torch.models.system import make_state
    from rigidmultiblobswall_tpu_torch.ops import forces

    rng = np.random.default_rng(22)
    system = bench_system(N_SHELLS)
    state = make_state(*lattice(N_SHELLS), dtype=torch.float32, device=dev)
    r = kin.blob_positions(system, state)
    n = r.shape[0]

    def vec(*shape):
        return torch.as_tensor(rng.normal(size=shape), dtype=torch.float32,
                               device=dev)

    out = dict(system=system, state=state, r=r, v1=vec(1, n, 3),
               v2=vec(2, n, 3),
               rollers=torch.as_tensor(roller_lattice(N_ROLLERS),
                                       device=dev),
               f_roll=vec(N_ROLLERS, 3), t_roll=vec(N_ROLLERS, 3))
    for key, sys_, (pos, quat) in (
            ("spectral", spectral_system(N_SPECTRAL, L_SPECTRAL),
             spectral_lattice(N_SPECTRAL, SPECTRAL_SIDE)),
            ("radii", radii_spectral_system(N_SPECTRAL, L_SPECTRAL),
             alternate(*spectral_lattice(N_SPECTRAL, SPECTRAL_SIDE))),
            ("wall", wall_system(N_WALL, L_WALL),
             wall_lattice(N_WALL, WALL_SIDE))):
        st = make_state(pos, quat, dtype=torch.float32, device=dev)
        sys_ = saddle.auto_spectral_capacities(sys_, st)
        rb = kin.blob_positions(sys_, st)
        sys_ = forces.auto_force_cell_capacity(sys_, rb)
        out[key] = saddle.maybe_dense_mobility(sys_, rb)
        out[f"f_{key}"] = vec(2, rb.shape[0], 3)
    return out


def p22_products(sc):
    """(name, fn(mesh)) of phase 22's products on the scenes `sc`: K1 tt
    square B = 1 and 2 (the group-pair shares), tt on two tensors (the row
    share, row0), grand on the rollers, spectral-98k B = 1 and 2 (K6's
    cells, the distributed FFT), spectral-98k-radii (P2's targets, the
    wave replicated), spectral-wall-98k B = 1 and 2 (K7's columns, the
    ky-padded transpose)."""
    from rigidmultiblobswall_tpu_torch.ops import ewald, ewald_wall
    from rigidmultiblobswall_tpu_torch.ops import mobility as mob

    kw = dict(domain="single_wall")
    r = sc["r"]
    return [
        ("K1 tt B=1", lambda m: mob.pairwise_matvec_multi(
            r, None, sc["v1"], 1.0, A_BENCH, mesh=m, **kw)),
        ("K1 tt B=2", lambda m: mob.pairwise_matvec_multi(
            r, None, sc["v2"], 1.0, A_BENCH, mesh=m, **kw)),
        ("K1 tt two tensors", lambda m: mob.pairwise_matvec(
            r, r, sc["v1"][0], 1.0, A_BENCH, mesh=m, **kw)),
        ("K1 grand", lambda m: torch.cat(mob.grand_mobility_matvec(
            sc["rollers"], sc["f_roll"], sc["t_roll"], 1.0, A_ROLLER,
            mesh=m, **kw), dim=1)),
        ("spectral-98k B=1", lambda m: ewald.matvec(
            sc["spectral"], sc["f_spectral"][0], mesh=m)),
        ("spectral-98k B=2", lambda m: ewald.matvec_multi(
            sc["spectral"], sc["f_spectral"], mesh=m)),
        ("spectral-98k-radii B=1", lambda m: ewald.matvec(
            sc["radii"], sc["f_radii"][0], mesh=m)),
        ("spectral-wall-98k B=1", lambda m: ewald_wall.matvec(
            sc["wall"], sc["f_wall"][0], mesh=m)),
        ("spectral-wall-98k B=2", lambda m: ewald_wall.matvec_multi(
            sc["wall"], sc["f_wall"], mesh=m)),
    ]


def _synced_ms(fn, reps):
    """Host-clock ms a call of fn() over reps calls after one warm-up,
    bracketed by torch.cuda.synchronize() (a collective's host staging
    runs outside the stream, so CUDA events would not see it)."""
    out = fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3 / reps


def p22_run(mesh, sc, steps=True):
    """Phase 22's products (each timed over P22_REPS calls after a
    warm-up) and, with steps, one forward-Euler and one Slip-Trapz step of
    phase 6's scene from its start (each run twice, the second timed),
    under `mesh` (None: one device). Returns numpy outputs, ms, and the
    steps' positions, solver counts and ms."""
    from rigidmultiblobswall_tpu_torch.models import integrators

    res = {}
    for name, fn in p22_products(sc):
        out, ms = _synced_ms(lambda: fn(mesh), P22_REPS)
        res[name] = dict(out=out.float().cpu().numpy(), ms=ms)
    if not steps:
        return res
    system = dataclasses.replace(sc["system"], mesh=mesh)
    for scheme in ("deterministic_forward_euler", "stochastic_Slip_Trapz"):
        step = integrators.make_stepper(
            system, scheme, 1e-3, lanczos_tolerance=5e-4,
            lanczos_max_iter=32, lanczos_check_every=4, gmres_restart=60,
            gmres_maxiter=300, max_rejections=3)
        # the same step twice from phase 6's start, the second timed
        for _ in range(2):
            carry = integrators.init_carry(system, state=sc["state"])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _, aux = step(sc["state"],
                                 torch.Generator().manual_seed(22), carry)
            torch.cuda.synchronize()
        res[scheme] = dict(out=state.pos.cpu().numpy(),
                           ms=(time.perf_counter() - t0) * 1e3,
                           counts=(aux.det_iterations, aux.stoch_iterations))
    return res


def phase22_rank(mesh, payload):
    """The ranks' part of phase 22 (a parallel/spawn.py target): the
    scenes, the products and steps under the gloo mesh, and on rank 0 one
    NCCL rank (a one-rank group) running the products through the same
    code. Returns rank 0's outputs and the phase's counts."""
    from rigidmultiblobswall_tpu_torch.ops import ewald, ewald_wall
    from rigidmultiblobswall_tpu_torch.parallel import dryrun as pdry
    from rigidmultiblobswall_tpu_torch.parallel import mesh as pmesh

    t0 = time.perf_counter()
    sc = p22_scenes(mesh.device)
    scenes_s = time.perf_counter() - t0
    run = p22_run(mesh, sc)
    res = dict(run=run, scenes_s=scenes_s,
               counts={k: list(v) for k, v in pmesh.COUNTS.items()},
               share_launches=pdry.share_launches(),
               replicated=dict(spectral=dict(ewald.REPLICATED_WAVE),
                               wall=dict(ewald_wall.REPLICATED_WAVE)))
    group = torch.distributed.new_group([0], backend="nccl")
    if mesh.rank == 0:
        pmesh.reset_counts()
        nccl = pmesh.Mesh(group, 0, 1, mesh.device)
        res["nccl"] = p22_run(nccl, sc, steps=False)
        res["nccl_counts"] = {k: list(v) for k, v in pmesh.COUNTS.items()}
    torch.distributed.barrier()
    return res


def share_plain_fields(fn, total, part):
    """A rank-share record's plain fields, as plain_fields: plain_ms, the
    plain version over the whole share (fn(total), one timed call) where
    its first `part` units (fn(part), timed first) predict under
    PLAIN_WHOLE_S; else plain_ms None and that part's time as
    plain_part_ms beside plain_part."""
    part = min(part, total)
    t = cuda_ms(lambda: fn(part), 1, warmup=False)
    if part == total:
        return dict(plain_ms=t)
    if t * total / part < PLAIN_WHOLE_S * 1e3:
        return dict(plain_ms=cuda_ms(lambda: fn(total), 1, warmup=False))
    return dict(plain_ms=None, plain_part=part, plain_part_ms=t)


def k1_share_records(pk, mob, sc):
    """K1's rank-share instances at phase 22's shapes, float32 on the
    wall: the symmetric sweep over each rank's group pairs (tt B = 1 and
    2 at 49,152 blobs, grand at 32,768 rollers) and the sliced sweep over
    rank 1's rows (tt, row0 = N/2). Each: the ranks' shares summed against
    the full launch (P22_TOL x max|ref|), a share's rows against the plain
    version in float64 (u32 sqrt(N); rank 0's partial holds group 0's rows
    whole, rank 1's rows are its own), twice bit-identical, its time, its
    plain version's over the whole share, and the full instance's bound
    scaled to the share."""
    records = {}
    q_b = mob._normalized(sc["r"], A_BENCH, True, torch.float32)[0]
    q_r = mob._normalized(sc["rollers"], A_ROLLER, True, torch.float32)[0]
    g = torch.Generator(device=q_b.device).manual_seed(221)
    for key, coupling, q, n_rhs in (("tt", "tt", q_b, 1),
                                    ("tt_b2", "tt", q_b, 2),
                                    ("grand", "grand", q_r, 1)):
        n = q.shape[0]
        nc = pk.NCOMP[coupling]
        v = torch.randn((n, nc * n_rhs), generator=g, device=q.device)
        kw = dict(coupling=coupling, mode="wall", self_interaction=True)
        groups, per = pk.group_plan(q)
        total = groups * (groups + 1) // 2
        shares = [(total * k // N_RANKS, total * (k + 1) // N_RANKS)
                  for k in range(N_RANKS)]
        parts = [pk.pair_matvec(q, None, v, pairs=s, **kw) for s in shares]
        full = pk.pair_matvec(q, None, v, **kw)
        sum_rel = ((sum(parts) - full).abs().max()
                   / full.abs().max()).item()
        same = torch.equal(parts[0], pk.pair_matvec(q, None, v,
                                                    pairs=shares[0], **kw))
        rows = min(per * pk.TILE, n)
        ref = pk.pair_plain(q.double(), q[:rows].double(), v.double(), **kw)
        err = (parts[0][:rows].double() - ref).abs().max().item()
        rel = err / ref.abs().max().item()
        ms = cuda_ms(lambda: pk.pair_matvec(q, None, v, pairs=shares[0],
                                            **kw), 10)
        plain_ms = cuda_ms(lambda: pk.pair_share_plain(
            q, v, pairs=shares[0], **kw), 1, warmup=False)
        # the share's directed pairs: a diagonal group pair's na^2, an
        # off-diagonal one's 2 na nb, at k1_full_record's cost a pair
        size = [min(n, (i + 1) * per * pk.TILE) - i * per * pk.TILE
                for i in range(groups)]
        directed = 0
        for p in range(*shares[0]):
            ga, gb = pk.group_pair(p, groups)
            directed += size[ga] * size[gb] * (1 if ga == gb else 2)
        apply = K1_APPLY_FLOPS[coupling]
        per_pair = (K1_PAIR_FLOPS[coupling] + K1_SYM_EXTRA_FLOPS.get(
            coupling, 0) - apply + 2 * apply * n_rhs) / 2
        nbytes = 4 * n * (3 + 2 * nc * n_rhs)
        rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   **bound_record(nbytes, directed * per_pair))
        log(f"phase 22 K1 {coupling} B={n_rhs} rank share, {n} blobs, "
            f"group pairs {shares[0]} of {total} ({groups} groups of {per} "
            f"tiles): shares summed vs full launch / max|ref| = "
            f"{sum_rel:.3e} (tol {P22_TOL:g}); group 0's {rows} rows vs "
            f"plain f64 {rel:.3e} (bound {u32_sqrt(n):.2e}); repeat "
            f"bit-identical {same}; {ms:.3f} ms, bound {rec['bound_ms']:.3f} "
            f"ms ({rec['bound_by']}, {rec['bound_ms'] / ms:.1%}), "
            f"{plain_text_share(rec)}")
        check(sum_rel <= P22_TOL, f"K1 {coupling} B={n_rhs} shares do not "
              "sum to the full product")
        check(rel <= u32_sqrt(n), f"K1 {coupling} B={n_rhs} share disagrees "
              "with its plain version")
        check(same, f"K1 {coupling} B={n_rhs} share not bit-identical")
        records[key] = rec
    # the sliced sweep over rank 1's rows
    n = q_b.shape[0]
    v = torch.randn((n, 3), generator=g, device=q_b.device)
    kw = dict(coupling="tt", mode="wall", self_interaction=True)
    r0 = n // 2
    qt = q_b[r0:].contiguous()
    got = pk.pair_matvec(q_b, qt, v, row0=r0, **kw)
    full = pk.pair_matvec(q_b, q_b, v, **kw)[r0:]
    sum_rel = ((got - full).abs().max() / full.abs().max()).item()
    sub = 1024
    ref = pk.pair_plain(q_b.double(), qt[:sub].double(), v.double(),
                        row0=r0, **kw)
    err = (got[:sub].double() - ref).abs().max().item()
    rel = err / ref.abs().max().item()
    same = torch.equal(got, pk.pair_matvec(q_b, qt, v, row0=r0, **kw))
    ms = cuda_ms(lambda: pk.pair_matvec(q_b, qt, v, row0=r0, **kw), 10)
    plain = share_plain_fields(lambda k: pk.pair_plain(
        q_b, qt[:k], v, row0=r0, **kw), n - r0, 1024)
    rec = dict(max_abs_err=err, ms=ms, **plain, **bound_record(
        4 * (n * 6 + (n - r0) * 6), (n - r0) * n * K1_PAIR_FLOPS["tt"]))
    log(f"phase 22 K1 tt rank share on two tensors, rows [{r0}, {n}) of "
        f"{n} (row0 {r0}): vs the full sliced launch's rows / max|ref| = "
        f"{sum_rel:.3e} (tol {P22_TOL:g}); first {sub} rows vs plain f64 "
        f"{rel:.3e} (bound {u32_sqrt(n):.2e}); repeat bit-identical {same}; "
        f"{ms:.3f} ms, bound {rec['bound_ms']:.3f} ms ({rec['bound_by']}, "
        f"{rec['bound_ms'] / ms:.1%}), {plain_text_share(rec)}")
    check(sum_rel <= P22_TOL, "K1 tt row share disagrees with the full "
          "launch's rows")
    check(rel <= u32_sqrt(n), "K1 tt row share disagrees with its plain "
          "version")
    check(same, "K1 tt row share not bit-identical")
    records["tt_rows"] = rec
    return records


def plain_text_share(rec):
    if rec["plain_ms"] is not None:
        return f"plain f32 {rec['plain_ms']:.1f} ms"
    return (f"plain f32 {rec['plain_part_ms']:.1f} ms on its first "
            f"{rec['plain_part']} units (the whole share is not timed)")


def cell_share_records(ck, sc):
    """K6's, P2's and K7's rank-share instances at phase 22's shapes
    (spectral-98k, spectral-98k-radii, spectral-wall-98k), float32: the
    ranks' shares (K6 cells, P2 targets, K7 (x, y) columns) summed must
    equal the full launch bit for bit (disjoint rows, the others zero);
    rank 1's share's first rows against the plain version in float64; its
    time, its plain version's, and the full instance's bound scaled by its
    share of the targets."""
    from rigidmultiblobswall_tpu_torch.ops import ewald_wall

    records = {}
    g = torch.Generator(device=sc["r"].device).manual_seed(222)
    # K6
    plan = sc["spectral"]
    p = plan.params
    n = plan.positions.shape[0]
    cap = p.cell_capacity
    C = int(np.prod(plan.cell_dims))
    args = (plan.cell_table, plan.cell_dims, p.box, cap)
    kw = dict(two_a=2 * p.a, r_cut=p.r_cut)
    for n_rhs in (1, 2):
        f = torch.randn((n, 3 * n_rhs), generator=g, device=g.device)
        shares = [(C * k // N_RANKS, C * (k + 1) // N_RANKS)
                  for k in range(N_RANKS)]
        parts = [ck.near_rpy(plan.positions, f, *args, plan.cheb,
                             cells_range=s, **kw) for s in shares]
        exact = torch.equal(sum(parts), ck.near_rpy(
            plan.positions, f, *args, plan.cheb, **kw))
        c0 = shares[1][0]
        sub = (c0, c0 + 256)
        got = ck.near_rpy(plan.positions, f, *args, plan.cheb,
                          cells_range=sub, **kw)
        ref = ck.near_rpy_plain(plan.positions.double(), f.double(), *args,
                                plan.cheb.double(), cells_range=sub, **kw)
        rows = _rows_of(plan.cell_table, n, cap, sub)
        err = (got.double()[rows] - ref[rows]).abs().max().item()
        scale = ref[rows].abs().max().item()
        ms = cuda_ms(lambda: ck.near_rpy(plan.positions, f, *args,
                                         plan.cheb, cells_range=shares[1],
                                         **kw), 10)
        plain = share_plain_fields(lambda k: ck.near_rpy_plain(
            plan.positions, f, *args, plan.cheb, cells_range=(c0, c0 + k),
            **kw), shares[1][1] - c0, 256)
        frac = len(_rows_of(plan.cell_table, n, cap, shares[1])) / n
        flops = k6_flops(ck, plan, n_rhs)[0] * frac
        nbytes = (4 * (n * 3 + 2 * n * 3 * n_rhs)
                  + plan.cell_table.numel() * 4) * frac
        rec = dict(max_abs_err=err, ms=ms, **plain,
                   **bound_record(nbytes, flops))
        bound = u32_sqrt(27 * cap)
        log(f"phase 22 K6 B={n_rhs} rank share, cells {shares[1]} of {C} "
            f"({frac:.1%} of the targets): shares summed bit-identical to "
            f"the full launch {exact}; cells {sub} vs plain f64 / max|ref| "
            f"{err / scale:.3e} (bound {bound:.2e}); {ms:.4f} ms, bound "
            f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}, "
            f"{rec['bound_ms'] / ms:.1%}), {plain_text_share(rec)}")
        check(exact, f"K6 B={n_rhs} shares do not sum to the full launch")
        check(err <= bound * scale, f"K6 B={n_rhs} share disagrees")
        records[f"K6_b{n_rhs}"] = rec
    # P2
    plan = sc["radii"]
    p = plan.params
    n = plan.positions.shape[0]
    f = torch.randn((n, 3), generator=g, device=g.device)
    call = (plan.positions, f, plan.group_of, plan.cell_table,
            plan.cell_dims, p.box, p.cell_capacity, plan.cheb_radii,
            plan.radii_edges)
    shares = [(n * k // N_RANKS, n * (k + 1) // N_RANKS)
              for k in range(N_RANKS)]
    parts = [ck.near_rpy_radii(*call, r_cut=p.r_cut, pairs=plan.radii_pairs,
                               targets=s) for s in shares]
    exact = torch.equal(sum(parts), ck.near_rpy_radii(
        *call, r_cut=p.r_cut, pairs=plan.radii_pairs))
    t0 = shares[1][0]
    sub = (t0, t0 + 2048)
    ref = ck.near_rpy_radii_pairs_plain(
        plan.radii_pairs, f.double(), plan.cheb_radii.double(),
        plan.radii_edges, p.box, r_cut=p.r_cut, targets=sub)
    err = (parts[1][sub[0]:sub[1]].double()
           - ref[sub[0]:sub[1]]).abs().max().item()
    scale = ref[sub[0]:sub[1]].abs().max().item()
    ms = cuda_ms(lambda: ck.near_rpy_radii(
        *call, r_cut=p.r_cut, pairs=plan.radii_pairs, targets=shares[1]), 10)
    plain = share_plain_fields(lambda k: ck.near_rpy_radii_pairs_plain(
        plan.radii_pairs, f, plan.cheb_radii, plan.radii_edges, p.box,
        r_cut=p.r_cut, targets=(t0, t0 + k)), shares[1][1] - t0, 4096)
    offsets = plan.radii_pairs.offsets.long()
    listed = int(offsets[shares[1][1]] - offsets[t0])
    frac = (shares[1][1] - t0) / n
    rec = dict(max_abs_err=err, ms=ms, **plain, **p2_product_bound(
        shares[1][1] - t0, listed, listed, plan.cheb_radii.shape[-1], 1))
    bound = u32_sqrt(27 * p.cell_capacity)
    log(f"phase 22 P2 rank share, targets {shares[1]} of {n} ({listed} "
        f"listed pairs): shares summed bit-identical to the full launch "
        f"{exact}; targets {sub} vs plain f64 / max|ref| {err / scale:.3e} "
        f"(bound {bound:.2e}); {ms:.4f} ms, bound {rec['bound_ms']:.4f} ms "
        f"({rec['bound_by']}, {rec['bound_ms'] / ms:.1%}), "
        f"{plain_text_share(rec)}")
    check(exact, "P2 shares do not sum to the full launch")
    check(err <= bound * scale, "P2 share disagrees")
    records["P2"] = rec
    # K7
    plan = sc["wall"]
    n = plan.n_real
    wargs, wkw = ewald_wall.near_args(plan)
    nx, ny, nz = plan.cell_dims
    cz = ewald_wall._kept_layers(plan.params, plan.cell_dims)
    cols = nx * ny
    shares = [(cols * k // N_RANKS, cols * (k + 1) // N_RANKS)
              for k in range(N_RANKS)]
    dargs = tuple(x.double() if torch.is_tensor(x) and x.is_floating_point()
                  else x for x in wargs)
    cap = plan.params.cell_capacity
    for n_rhs in (1, 2):
        f = torch.randn((n, 3 * n_rhs), generator=g, device=g.device)
        parts = [ck.wall_near(plan.pos_all, f, *wargs, cz_range=cz,
                              columns=s, **wkw) for s in shares]
        exact = torch.equal(sum(parts), ck.wall_near(
            plan.pos_all, f, *wargs, cz_range=cz, **wkw))
        k0 = shares[1][0]
        sub = (k0 * nz, (k0 + 16) * nz)
        got = ck.wall_near(plan.pos_all, f, *wargs, cz_range=cz,
                           columns=(k0, k0 + 16), **wkw)
        ref = ck.wall_near_plain(plan.pos_all.double(), f.double(), *dargs,
                                 cells_range=sub, **wkw)
        rows = _rows_of(plan.cell_table, n, cap, sub)
        err = (got.double()[rows] - ref[rows]).abs().max().item()
        scale = ref[rows].abs().max().item()
        ms = cuda_ms(lambda: ck.wall_near(plan.pos_all, f, *wargs,
                                          cz_range=cz, columns=shares[1],
                                          **wkw), 10)
        plain = share_plain_fields(lambda k: ck.wall_near_plain(
            plan.pos_all, f, *wargs, cells_range=(k0 * nz, (k0 + k) * nz),
            **wkw), shares[1][1] - k0, 16)
        frac = len(_rows_of(plan.cell_table, n, cap,
                            (k0 * nz, shares[1][1] * nz))) / n
        flops = k7_flops(ck, plan, n_rhs)[0] * frac
        nbytes = (4 * (2 * n * 3 + 2 * n * 3 * n_rhs)
                  + plan.cell_table.numel() * 4) * frac
        rec = dict(max_abs_err=err, ms=ms, **plain,
                   **bound_record(nbytes, flops))
        log(f"phase 22 K7 B={n_rhs} rank share, columns {shares[1]} of "
            f"{cols} ({frac:.1%} of the real targets): shares summed "
            f"bit-identical to the full launch {exact}; 16 columns vs plain "
            f"f64 / max|ref| {err / scale:.3e} (bound 2e-05); {ms:.4f} ms, "
            f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}, "
            f"{rec['bound_ms'] / ms:.1%}), {plain_text_share(rec)}")
        check(exact, f"K7 B={n_rhs} shares do not sum to the full launch")
        check(err <= 2e-5 * scale, f"K7 B={n_rhs} share disagrees")
        records[f"K7_b{n_rhs}"] = rec
    return records


def phase_multi_device(pk, mob, ck):
    """Phase 22: the multi-device paths (parallel/), ranks D = 2 sharing
    the card over gloo against D = 1 on the same inputs, and one NCCL rank.
    The rank-share kernel records first (in this process); then the
    ranks (parallel/spawn.py) run phase 22's products (K1 tt B = 1 and 2,
    tt on two tensors, grand; spectral-98k B = 1 and 2, spectral-98k-radii,
    spectral-wall-98k B = 1 and 2) and one forward-Euler and one
    Slip-Trapz step of phase 6's scene, while this process runs them
    unsharded; then parallel.dryrun.dryrun_multichip(2) at the JAX entry
    point's sizes. Two ranks on one card measure the decomposition and its
    collectives, not scaling. Returns the records and the ranks' launches
    of each rank-share instance over the phase."""
    from rigidmultiblobswall_tpu_torch.parallel import dryrun as pdry
    from rigidmultiblobswall_tpu_torch.parallel import spawn as pspawn

    t_phase = time.perf_counter()
    dev = torch.device(DEVICE)
    t0 = time.perf_counter()
    sc = p22_scenes(dev)
    log(f"phase 22 scenes and plans in {time.perf_counter() - t0:.1f} s")
    records = k1_share_records(pk, mob, sc)
    records.update(cell_share_records(ck, sc))
    log(f"phase 22 records: {time.perf_counter() - t_phase:.1f} s")

    # the ranks, started now: they build their scenes while this process
    # runs the unsharded twins
    t0 = time.perf_counter()
    pool = concurrent.futures.ThreadPoolExecutor(1)
    ranks = pool.submit(pspawn.spawn, N_RANKS, "chip_smoke:phase22_rank",
                        None, backend="gloo", device="cuda:0",
                        timeout_s=P22_TIMEOUT_S, run_s=P22_RUN_S)
    single = p22_run(None, sc)
    del sc
    torch.cuda.empty_cache()
    res = ranks.result()
    pool.shutdown()
    log(f"phase 22 ranks: {time.perf_counter() - t0:.1f} s (their scenes "
        f"and plans {res['scenes_s']:.1f} s)")
    run, nccl = res["run"], res["nccl"]
    for name, ref in single.items():
        got = run[name]
        scale = max(np.abs(ref["out"]).max(), 1.0 if "counts" in ref
                    else 0.0)
        rel = float(np.abs(got["out"] - ref["out"]).max() / scale)
        tol = (P22_STEP_TOL if "counts" in ref else
               P22_TOL_WALL if "wall" in name else P22_TOL)
        text = (f"phase 22 {name}: D=1 {ref['ms']:.2f} ms, D={N_RANKS} "
                f"{got['ms']:.2f} ms; D={N_RANKS} vs D=1 / max|ref| "
                f"{rel:.3e} (tol {tol:g})")
        if name in nccl:
            nrel = float(np.abs(nccl[name]["out"] - ref["out"]).max()
                         / scale)
            text += (f"; NCCL D=1 {nccl[name]['ms']:.2f} ms, vs D=1 "
                     f"{nrel:.3e}")
            check(nrel <= tol, f"phase 22 {name}: the NCCL rank disagrees")
        if "counts" in ref:
            diff = [abs(a - b) for a, b in zip(got["counts"], ref["counts"])]
            text += (f"; gmres, lanczos D=1 {ref['counts']}, D={N_RANKS} "
                     f"{got['counts']}" + (f" (differ by {diff})"
                                           if any(diff) else ""))
            check(max(diff) <= 1, f"phase 22 {name}: solver counts differ "
                  f"by more than one: {ref['counts']} {got['counts']}")
        log(text)
        check(np.all(np.isfinite(got["out"])), f"phase 22 {name} not finite")
        check(rel <= tol, f"phase 22 {name}: D={N_RANKS} disagrees with D=1")
    for label, counts in (("gloo", res["counts"]),
                          ("NCCL", res["nccl_counts"])):
        log(f"phase 22 collectives ({label}, rank 0): " + ", ".join(
            f"{k} {c} calls {b / 2 ** 20:.1f} MiB" for k, (c, b) in
            counts.items()))
    log(f"phase 22 replicated wave products: {res['replicated']}")
    check(res["replicated"]["wall"]["grid"] == 0
          and res["replicated"]["spectral"]["grid"] == 0,
          "phase 22: a wave part ran replicated on a divisible grid")
    t0 = time.perf_counter()
    dry = pdry.dryrun_multichip(N_RANKS, device="cuda:0", run_s=P22_RUN_S)
    for which, r in dry["paths"].items():
        log(f"phase 22 dryrun_multichip({N_RANKS}) {which}: rel "
            f"{r['rel']:.3e} (tol 5e-05), counts {r['counts']} (single rank "
            f"{r['counts_single']}), {r['s'] * 1e3:.0f} ms (single rank "
            f"{r['s_single'] * 1e3:.0f} ms)")
    log(f"phase 22 dryrun: {time.perf_counter() - t0:.1f} s")
    launches = dict(res["share_launches"])
    for k, v in dry["share_launches"].items():
        launches[k] = launches.get(k, 0) + v
    log(f"phase 22 rank-share launches (rank 0): {launches}")
    log(f"phase 22: {time.perf_counter() - t_phase:.1f} s")
    return records, launches


def main():
    # phase 1: device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this smoke test runs only on a CUDA card")
    sys.path.insert(0, ROOT)
    from rigidmultiblobswall_tpu_torch.models import kinematics as kin
    from rigidmultiblobswall_tpu_torch.models.system import make_state
    from rigidmultiblobswall_tpu_torch.ops import _build
    from rigidmultiblobswall_tpu_torch.ops import cell_kernels as ck
    from rigidmultiblobswall_tpu_torch.ops import cells, ewald
    from rigidmultiblobswall_tpu_torch.ops import mobility as mob
    from rigidmultiblobswall_tpu_torch.ops import mobility_cuda as mc
    from rigidmultiblobswall_tpu_torch.ops import pair_kernels as pk

    card = smi()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, "TF32 is on")

    # phase 2: build
    t0 = time.perf_counter()
    _build.library()
    report = ptxas_report(_build.build_log)
    log(f"build: {time.perf_counter() - t0:.2f} s (nvcc, one process per "
        f"source: {_build.build_seconds:.2f} s), {len(report)} kernel "
        f"instances{'' if report else ' (library reused)'}")
    for line in report:
        log(f"  ptxas {line}")

    records = phase_kernels(pk, mc, mob, kin, make_state)   # phase 3
    records.update(phase_roller_kernels(pk, mob))
    records.update(phase_lub_kernels(pk, mc, mob))
    phase_cell_kernels(ck, cells, ewald)
    phase_wall_kernels(ck)
    phase_rot_kernels(ck, mc)
    phase_dense_kernels_small(mc)
    phase_image_kernels_small(pk, mc)
    records.update(phase_dense_kernels(pk, mc, mob, kin, make_state))
    art_records = phase_articulated_kernels(pk, mc, mob, kin, make_state)
    l1_records = phase_l1_kernels()
    m1_records = phase_m1_kernels(pk, mc, kin, make_state)
    fiber_record = phase_fiber_kernels(pk, mob)
    p1_records = phase_radii_kernels(mc, report)
    phase_p2_small(ck, ewald)
    phase_slice_parity(mc)                                  # phase 4
    phase_roller_parity()
    phase_spectral_parity()
    phase_wall_parity(ck)
    phase_wall_roller_parity()
    phase_lub_parity(pk, mc)
    phase_scheme_parity(pk, mc)
    phase_articulated_parity(pk, mc)
    phase_phoretic_parity(pk, mc)
    phase_mcmc_parity(mc)
    phase_fiber_parity()
    phase_radii_parity(mc)
    phase_cli()                                             # phase 5
    phase_roller_cli()
    phase_spectral_cli()
    phase_wall_cli()
    phase_dense_cli()
    phase_lub_cli()
    phase_obstacle_cli()
    phase_articulated_cli()
    phase_slip_cli()
    phase_phoretic_cli()
    phase_mcmc_cli(mc)
    phase_twin_cli()
    phase_radii_cli()
    launches = phase_main_path(pk, mc)                      # phase 6
    # K1 tt and K2 keep their Slip-Trapz counts; the rollers path (which
    # runs them too, and checks that) supplies the other couplings'
    rollers_launches = phase_rollers_path(pk, mc)           # phase 7
    launches.update({k: n for k, n in rollers_launches.items()
                     if k not in launches})
    spectral = phase_spectral_path(pk, mc, ck)              # phase 8
    phase_spectral_cli_full()
    dense_launches = phase_dense_path(pk, mc)               # phase 9
    k7, k5_wall = phase_wall_path(pk, mc, ck)               # phase 10
    rot = phase_wall_rollers_path(pk, mc, ck)               # phase 11
    lub_launches = phase_lub_path(pk, mc, ck)               # phase 12
    phase_item17_path(pk, mc)                               # phase 13
    art_launches = phase_articulated_path(pk, mc)           # phase 14
    l1_launches = phase_phoretic_path(pk, mc)               # phase 15
    m1_launches = phase_mcmc_path(pk, mc)                   # phase 16
    fiber_launches = phase_fiber_path(pk, mc)               # phase 17
    from rigidmultiblobswall_tpu_torch.ops import laplace as lap
    p1_launches = phase_radii_path(pk, mc, ck, lap)         # phase 18
    p2_records = phase_radii_spectral_path(pk, mc, ck, lap, report)  # 19
    img_records, img_launches = phase_pseudo_periodic(      # phase 20
        pk, mc, ck, lap, mob, kin, report)
    dom_records, dom_launches = phase_domains(              # phase 21
        pk, mc, ck, lap, mob, kin, report)
    p22_records, p22_launches = phase_multi_device(pk, mob, ck)  # 22

    k1_src = {"tt": "rigidmultiblobswall_tpu_torch/csrc/pair_tt.cu"}
    # each record counts the launches of its own instance (rt and grand
    # have B = 1 only); the rollers path runs tr and rr with B = 2 only,
    # so their B = 1 records (phase 3) stay in the log
    kernels = [dict(name=f"K1 pair_{c}" + ("" if b == 1 else f" B={b}"),
                    route="cuda",
                    source=k1_src.get(
                        c, "rigidmultiblobswall_tpu_torch/csrc/"
                        "pair_couplings.cu"),
                    replaces="rigidmultiblobswall_tpu/ops/pair_kernels.py:254",
                    launches=launches[f"K1 {c}" + ("" if b == 1
                                                   else f" B={b}")],
                    **records[c if b == 1 else f"{c}_b2"])
               for c, b in (("tt", 1), ("rt", 1), ("grand", 1), ("tt", 2),
                            ("tr", 2), ("rr", 2))]
    kernels.append(dict(
        name=f"K1 pair_tt at {N_DENSE * 12} blobs", route="cuda",
        source=k1_src["tt"],
        replaces="rigidmultiblobswall_tpu/ops/pair_kernels.py:254",
        launches=dense_launches["K1_tt"], **records["tt_12k"]))
    kernels.append(dict(
        name="K2 blob_forces", route="cuda",
        source="rigidmultiblobswall_tpu_torch/csrc/blob_forces.cu",
        replaces="rigidmultiblobswall_tpu/ops/mobility_pallas.py:180",
        launches=launches["K2"], **records["K2"]))
    kernels.append(dict(
        name="K3 dense_tt", route="cuda",
        source="rigidmultiblobswall_tpu_torch/csrc/dense_tt.cu",
        replaces="rigidmultiblobswall_tpu/ops/mobility_pallas.py:81",
        launches=dense_launches["dense_tt"], **records["K3"]))
    kernels.append(dict(
        name="K4 symm_planes", route="cuda",
        source="rigidmultiblobswall_tpu_torch/csrc/symm_planes.cu",
        replaces="rigidmultiblobswall_tpu/ops/mobility_pallas.py:259",
        launches=dense_launches["symm_matvec"], **records["K4"]))
    kernels.append(dict(
        name="K5 nl_forces", route="cuda",
        source="rigidmultiblobswall_tpu_torch/csrc/nl_forces.cu",
        replaces="rigidmultiblobswall_tpu/ops/forces.py:271",
        **spectral["K5"]))
    kernels.append(dict(
        name="K5 nl_forces wall slab", route="cuda",
        source="rigidmultiblobswall_tpu_torch/csrc/nl_forces.cu",
        replaces="rigidmultiblobswall_tpu/ops/forces.py:271", **k5_wall))
    kernels.append(dict(
        name="K6 near_rpy", route="cuda",
        source="rigidmultiblobswall_tpu_torch/csrc/near_rpy.cu",
        replaces="rigidmultiblobswall_tpu/ops/ewald.py:1375",
        **spectral["K6"]))
    kernels.append(dict(
        name="K7 wall_near", route="cuda",
        source="rigidmultiblobswall_tpu_torch/csrc/wall_near.cu",
        replaces="rigidmultiblobswall_tpu/ops/ewald_wall.py:942", **k7))
    for inst in K8_INSTANCES:
        kernels.append(dict(
            name=f"K8 wall_rot_near {inst}", route="cuda",
            source="rigidmultiblobswall_tpu_torch/csrc/wall_rot_near.cu",
            replaces="rigidmultiblobswall_tpu/ops/ewald_wall_rot.py:153",
            **rot[f"K8 {inst}"]))
    kernels.append(dict(
        name="K2 blob_forces periodic", route="cuda",
        source="rigidmultiblobswall_tpu_torch/csrc/blob_forces.cu",
        replaces="rigidmultiblobswall_tpu/ops/forces.py:48",
        **rot["K2 periodic"]))
    kernels.append(dict(
        name=f"K1 pair_grand at {N_LUB} spheres", route="cuda",
        source="rigidmultiblobswall_tpu_torch/csrc/pair_couplings.cu",
        replaces="rigidmultiblobswall_tpu/ops/pair_kernels.py:254",
        launches=lub_launches["K1 grand"], **records["grand_lub"]))
    kernels.append(dict(
        name=f"K2 blob_forces at {N_LUB} spheres", route="cuda",
        source="rigidmultiblobswall_tpu_torch/csrc/blob_forces.cu",
        replaces="rigidmultiblobswall_tpu/ops/mobility_pallas.py:180",
        launches=lub_launches["K2"], **records["K2_lub"]))
    # phase 14's kernels, measured at its chains' and dumbbells' shapes,
    # with their launches over the phase (K1 tt and K2: the chains and the
    # squirmers)
    for name, key, src, rep_line, launch in (
            ("K1 pair_tt in chains", "tt", k1_src["tt"],
             "pair_kernels.py:254", "K1 tt"),
            ("K2 blob_forces in chains", "K2",
             "rigidmultiblobswall_tpu_torch/csrc/blob_forces.cu",
             "mobility_pallas.py:180", "K2"),
            ("K1 pair_grand in dumbbells", "grand",
             "rigidmultiblobswall_tpu_torch/csrc/pair_couplings.cu",
             "pair_kernels.py:254", "K1 grand")):
        kernels.append(dict(
            name=name, route="cuda", source=src,
            replaces=f"rigidmultiblobswall_tpu/ops/{rep_line}",
            launches=art_launches[launch], **art_records[key]))
    # L1's instances on phase 15's path, timed at its shapes, with their
    # launches over the phase
    lap_src = "rigidmultiblobswall_tpu/ops/laplace.py"
    for key, name, rep_line, launch in (
            ("bvp", "L1 laplace bvp_operator",
             "rigidmultiblobswall_tpu/models/phoretic.py:115", "L1 bvp"),
            ("S", "L1 laplace single_layer", f"{lap_src}:28", "L1 S"),
            ("grad", "L1 laplace surface_gradient",
             "rigidmultiblobswall_tpu/models/phoretic.py:126", "L1 grad"),
            ("D_off", "L1 laplace double_layer off-surface",
             f"{lap_src}:46", "L1 D off"),
            ("S_off", "L1 laplace single_layer off-surface",
             f"{lap_src}:28", "L1 S off")):
        kernels.append(dict(
            name=name, route="cuda",
            source="rigidmultiblobswall_tpu_torch/csrc/laplace_layers.cu",
            replaces=rep_line, launches=l1_launches[launch],
            **l1_records[key]))
    # M1 on phase 16's path: the chain at 49,152 blobs and the rejection
    # sampler's batches, with their launches over the phase
    for key, name, rep_line in (
            ("M1", "M1 blob_energy",
             "rigidmultiblobswall_tpu/ops/forces.py:506"),
            ("M1_batch", f"M1 blob_energy batch {N_MCMC_BATCH} x 12",
             "rigidmultiblobswall_tpu/models/mcmc.py:25")):
        kernels.append(dict(
            name=name, route="cuda",
            source="rigidmultiblobswall_tpu_torch/csrc/blob_energy.cu",
            replaces=rep_line, launches=m1_launches[key],
            **m1_records[key]))
    # K1 tt on phase 17b's carpet, timed at its 32,768 blobs, with its
    # launches over 17b's four steps
    kernels.append(dict(
        name="K1 pair_tt in fibers", route="cuda", source=k1_src["tt"],
        replaces="rigidmultiblobswall_tpu/ops/pair_kernels.py:254",
        launches=fiber_launches["K1 tt"], **fiber_record))
    # P1 at phase 18's shape (B = 1 and 2) with its launches over phase 18,
    # and P2 at phase 19's with its launches over phase 19's steps
    for n_rhs in (1, 2):
        kernels.append(dict(
            name="P1 pair_radii" + ("" if n_rhs == 1 else " B=2"),
            route="cuda",
            source="rigidmultiblobswall_tpu_torch/csrc/pair_radii.cu",
            replaces="rigidmultiblobswall_tpu/ops/mobility.py:540",
            launches=p1_launches[n_rhs], **p1_records[n_rhs]))
    for key, name in (("build", "P2 near_radii_pairs (the list build)"),
                      (1, "P2 near_rpy_radii (the list product)"),
                      (2, "P2 near_rpy_radii B=2 (the list product)")):
        kernels.append(dict(
            name=name, route="cuda",
            source="rigidmultiblobswall_tpu_torch/csrc/near_radii.cu",
            replaces="rigidmultiblobswall_tpu/ops/ewald.py:1222",
            **p2_records[key]))
    # the image-box instances of K1 and K3 at phase 20's shapes, with their
    # launches over 20a (tt), 20b (K3, tt at 12,288 blobs), 20c (the
    # rollers' couplings) and 20d (grand at 4096 spheres); the XLA paths of
    # the JAX package they replace
    k1_img = "rigidmultiblobswall_tpu/ops/mobility.py:239"
    for key, name, src, launch in (
            ("tt", "K1 pair_tt images", k1_src["tt"], "K1 tt images"),
            ("tt_b2", "K1 pair_tt images B=2", k1_src["tt"],
             "K1 tt images B=2"),
            ("tt_12k", f"K1 pair_tt images at {N_DENSE * 12} blobs",
             k1_src["tt"], "K1 tt images 12k"),
            ("grand", "K1 pair_grand images", None, "K1 grand images"),
            ("tr", "K1 pair_tr images", None, "K1 tr images"),
            ("tr_b2", "K1 pair_tr images B=2", None, "K1 tr images B=2"),
            ("rr", "K1 pair_rr images", None, "K1 rr images"),
            ("rr_b2", "K1 pair_rr images B=2", None, "K1 rr images B=2"),
            ("rt", "K1 pair_rt images", None, "K1 rt images"),
            ("grand_lub", f"K1 pair_grand images at {N_LUB} spheres", None,
             "K1 grand images lub")):
        kernels.append(dict(
            name=name, route="cuda",
            source=src or "rigidmultiblobswall_tpu_torch/csrc/"
            "pair_couplings.cu", replaces=k1_img,
            launches=img_launches[launch], **img_records[key]))
    kernels.append(dict(
        name="K3 dense_tt images", route="cuda",
        source="rigidmultiblobswall_tpu_torch/csrc/dense_tt.cu",
        replaces="rigidmultiblobswall_tpu/ops/mobility.py:649",
        launches=img_launches["K3 images"], **img_records["K3"]))
    # phase 21's new instances at their paths' shapes, with their launches
    # over the path that runs them: K1's free-surface tt (21a), K3's
    # free-surface instance (21d), P1's image boxes (21c) and free surface
    # (21e), K5's open instance (21b open, 21c partly periodic); the JAX
    # package's functions they replace (XLA there, but K1's and K5's Pallas
    # kernels on the TPU's own domains)
    fs_src = "rigidmultiblobswall_tpu_torch/csrc/pair_fs.cu"
    p1_src = "rigidmultiblobswall_tpu_torch/csrc/pair_radii.cu"
    k3_src = "rigidmultiblobswall_tpu_torch/csrc/dense_tt.cu"
    k5_src = "rigidmultiblobswall_tpu_torch/csrc/nl_forces.cu"
    for key, name, src, rep, launch in (
            ("fs_b1", "K1 pair_tt_fs", fs_src,
             "rigidmultiblobswall_tpu/ops/rpy.py:466", "K1 tt_fs B=1"),
            ("fs_b2", "K1 pair_tt_fs B=2", fs_src,
             "rigidmultiblobswall_tpu/ops/rpy.py:466", "K1 tt_fs B=2"),
            ("fs_img_b1", "K1 pair_tt_fs images", fs_src, k1_img,
             "K1 tt_fs images B=1"),
            ("fs_img_b2", "K1 pair_tt_fs images B=2", fs_src, k1_img,
             "K1 tt_fs images B=2"),
            ("K3_fs", "K3 dense_tt_fs", k3_src,
             "rigidmultiblobswall_tpu/ops/mobility.py:617", "21d K3 fs"),
            ("K3_fs_img", "K3 dense_tt_fs images", k3_src,
             "rigidmultiblobswall_tpu/ops/mobility.py:649",
             "21d K3 fs images"),
            ("p1_img_b1", "P1 pair_radii images", p1_src,
             "rigidmultiblobswall_tpu/ops/mobility.py:479",
             "21c P1 wall images B=1"),
            ("p1_img_b2", "P1 pair_radii images B=2", p1_src,
             "rigidmultiblobswall_tpu/ops/mobility.py:479",
             "21c P1 wall images B=2"),
            ("p1_fs", "P1 pair_radii free surface", p1_src,
             "rigidmultiblobswall_tpu/ops/mobility.py:493",
             "21e P1 free_surface B=1"),
            ("p1_fs_b2", "P1 pair_radii free surface B=2", p1_src,
             "rigidmultiblobswall_tpu/ops/mobility.py:493",
             "21e P1 free_surface B=2"),
            ("p1_fs_img", "P1 pair_radii free surface images", p1_src,
             "rigidmultiblobswall_tpu/ops/mobility.py:493",
             "21e P1 free_surface images B=1"),
            ("K5_open", "K5 nl_forces open", k5_src,
             "rigidmultiblobswall_tpu/ops/forces.py:186", "21b K5 open"),
            ("K5_partly", "K5 nl_forces open, partly periodic", k5_src,
             "rigidmultiblobswall_tpu/ops/forces.py:186", "21c K5 open")):
        kernels.append(dict(name=name, route="cuda", source=src,
                            replaces=rep, launches=dom_launches.get(launch, 0),
                            **dom_records[key]))
        check(kernels[-1]["launches"] > 0, f"phase 21: {name} was not "
              "launched on its path")
    # phase 22's rank-share instances at its shapes, with the ranks'
    # launches over the phase (rank 0's; every rank launches as many)
    for key, name, src, rep, launch in (
            ("tt", "K1 pair_tt rank share (group pairs)", SHARE_SRC["K1"],
             "rigidmultiblobswall_tpu/ops/pair_kernels.py:254",
             "K1 tt B=1 sym"),
            ("tt_b2", "K1 pair_tt rank share (group pairs) B=2",
             SHARE_SRC["K1"],
             "rigidmultiblobswall_tpu/ops/pair_kernels.py:254",
             "K1 tt B=2 sym"),
            ("grand", "K1 pair_grand rank share (group pairs)",
             SHARE_SRC["grand"],
             "rigidmultiblobswall_tpu/ops/pair_kernels.py:254",
             "K1 grand B=1 sym"),
            ("tt_rows", "K1 pair_tt rank share (rows from row0)",
             SHARE_SRC["K1"],
             "rigidmultiblobswall_tpu/ops/pair_kernels.py:254",
             "K1 tt B=1 sliced"),
            ("K6_b1", "K6 near_rpy rank share (cells)", SHARE_SRC["K6"],
             "rigidmultiblobswall_tpu/ops/ewald.py:1375", "near_rpy_b1"),
            ("K6_b2", "K6 near_rpy rank share (cells) B=2", SHARE_SRC["K6"],
             "rigidmultiblobswall_tpu/ops/ewald.py:1375", "near_rpy_b2"),
            ("P2", "P2 near_rpy_radii rank share (targets)",
             SHARE_SRC["P2"], "rigidmultiblobswall_tpu/ops/ewald.py:1222",
             "near_rpy_radii_b1"),
            ("K7_b1", "K7 wall_near rank share (columns)", SHARE_SRC["K7"],
             "rigidmultiblobswall_tpu/ops/ewald_wall.py:942",
             "wall_near_b1"),
            ("K7_b2", "K7 wall_near rank share (columns) B=2",
             SHARE_SRC["K7"], "rigidmultiblobswall_tpu/ops/ewald_wall.py:942",
             "wall_near_b2")):
        kernels.append(dict(name=name, route="cuda", source=src,
                            replaces=rep, launches=p22_launches.get(launch, 0),
                            **p22_records[key]))
        check(kernels[-1]["launches"] > 0, f"phase 22: {name} was not "
              "launched by the ranks")
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
