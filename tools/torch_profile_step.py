"""Where the device time of one multibody step of the PyTorch port goes
(Slip-Trapz, or the scheme --scheme names; with --phoretic every shell a
Janus particle, chip_smoke.py's phase 15, its Laplace solves on L1).

Drives chip_smoke.py's main-path configuration (bench.py's `multibody`
scene, 4096 twelve-blob shells = 49,152 blobs, float32; for the
articulated multibody schemes chip_smoke.py's phase 14 chains, the
shells in four-shell chains) on a CUDA card:
one warm-up step, a few unprofiled steps timed on the host clock around
`torch.cuda.synchronize()`, then one step under torch.profiler (CUDA
activity). Prints the card's name and power limit, the unprofiled
ms/step with iteration counts, and per-kernel device time, launch count
and share of the profiled step; the device's busy time against the
step's wall time gives its idle share. For the articulated schemes it
first times the parts of a forward Euler step on the host clock, each
bracketed by `torch.cuda.synchronize()`: the preconditioner's build, the
constrained GMRES solve, the update with the centre-of-mass correction,
and the nonlinear projection.

With --mcmc it profiles the MCMC chain of chip_smoke.py's phase 16
instead (the same scene, kT 0.05, every body moved a step): ten warm-up
moves, --steps moves timed on the host clock, then --steps moves under
the profiler, with each kernel's launches a move.

With --fibers it profiles a step of chip_smoke.py's phase 17 instead:
17b's 32 x 32 clamped carpet (32,768 blobs, full hydrodynamics,
Crank-Nicolson), then 17a's 4096 free fibers (131,072 blobs, batched
hydrodynamics, backward Euler), one warm-up and --steps timed steps each,
then one step under the profiler: busy and idle share, and the shares of
K1, the batched LU (factor and solves) and the batched Cholesky.

With --radii it profiles chip_smoke.py's phase 18 scene instead: the
same lattice with bench.py's shell and a 1.2x shell (blob radius 0.157)
alternating, every product on kernel P1.

Usage: python3 tools/torch_profile_step.py [n_shells] [--steps N]
       [--scheme NAME] [--phoretic | --mcmc | --fibers | --radii]
"""

import argparse
import os
import sys
import time
from collections import defaultdict

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from rigidmultiblobswall_tpu_torch.models import articulated  # noqa: E402
from rigidmultiblobswall_tpu_torch.models import integrators  # noqa: E402
from rigidmultiblobswall_tpu_torch.models import kinematics  # noqa: E402
from rigidmultiblobswall_tpu_torch.models import saddle, solvers  # noqa: E402
from rigidmultiblobswall_tpu_torch.models.system import make_state  # noqa: E402


def _self_device_us(evt):
    # the attribute's name changed across torch releases
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return getattr(evt, name)
    return 0.0


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def articulated_parts(system, state, dt=1e-3):
    """Host-clock times of an articulated forward Euler step's parts at
    `state`, with the Gauss-Newton iterations of its projection."""
    pc, pc_ms = _timed(lambda: saddle.build_block_diag_pc(system, state))
    sol, solve_ms = _timed(lambda: solvers.solve_mobility_problem(
        system, state, pc=pc, m_dense=None, maxiter=300))
    moved, com_ms = _timed(lambda: articulated.correct_center_of_mass(
        system, kinematics.advance(state, sol.velocities, dt), state,
        sol.velocities, dt, time=dt))
    articulated.GN_ITERATIONS.clear()
    _, proj_ms = _timed(lambda: articulated.nonlinear_projection(
        system, moved, time=dt, tol=system.nonlinear_solver_tolerance))
    print(f"articulated FE step parts (host clock): PC build {pc_ms:.1f} ms, "
          f"solve {solve_ms:.1f} ms ({sol.iterations} GMRES sweeps), "
          f"update and centre-of-mass correction {com_ms:.1f} ms, "
          f"projection {proj_ms:.1f} ms (Gauss-Newton iterations "
          f"{list(articulated.GN_ITERATIONS)})", flush=True)


def _device_kernels(prof):
    """{kernel name: [device ms, launches]} of the profiled region: the
    events with device time and no host time."""
    per_kernel = defaultdict(lambda: [0.0, 0])
    for evt in prof.key_averages():
        dev_us = _self_device_us(evt)
        if dev_us > 0 and evt.self_cpu_time_total == 0:
            per_kernel[evt.key][0] += dev_us / 1e3
            per_kernel[evt.key][1] += evt.count
    return per_kernel


def _print_kernels(per_kernel, busy_ms, per=1):
    """The eight largest kernels by device time, then the rest, with
    their launches divided by `per`."""
    rows = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])
    top, rest = rows[:8], rows[8:]
    for name, (ms, count) in top:
        print(f"  {ms:9.2f} ms {100 * ms / busy_ms:5.1f} % "
              f"{count / per:7.2f} x {name[:90]}")
    rest_ms = sum(ms for _, (ms, _) in rest)
    print(f"  {rest_ms:9.2f} ms {100 * rest_ms / busy_ms:5.1f} % "
          f"{sum(c for _, (_, c) in rest) / per:7.2f} x  ({len(rest)} other "
          "kernels)")


def mcmc_profile(n_shells, steps, dev):
    """Host-clock ms a move of the MCMC chain on phase 16's scene, then
    `steps` moves under the profiler: device busy time and idle share,
    launches a move."""
    from rigidmultiblobswall_tpu_torch.models import mcmc

    system = chip_smoke.bench_system(n_shells)
    pos, quat = chip_smoke.lattice(n_shells)
    state = make_state(pos, quat, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    kernel = mcmc.make_mcmc_kernel(system)
    mc = mcmc.init_mcmc(system, state, energy=kernel.energy)
    for _ in range(10):
        mc = kernel(mc, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        mc = kernel(mc, gen)
    torch.cuda.synchronize()
    print(f"unprofiled MCMC ({system.num_blobs} blobs f32): "
          f"{(time.perf_counter() - t0) * 1e3 / steps:.3f} ms a move over "
          f"{steps} moves", flush=True)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            mc = kernel(mc, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    per_kernel = _device_kernels(prof)
    busy_ms = sum(ms for ms, _ in per_kernel.values())
    launches = sum(c for _, c in per_kernel.values())
    print(f"profiled MCMC, {steps} moves: wall {wall_ms / steps:.3f} ms a "
          f"move, device busy {busy_ms / steps:.3f} ms a move, idle share "
          f"{1 - busy_ms / wall_ms:.3f} (an upper bound: the profiler slows "
          f"the host); {launches / steps:.2f} device launches a move "
          f"({len(per_kernel)} kernels)", flush=True)
    if busy_ms == 0:
        raise SystemExit("torch_profile_step: the profiler saw no device time")
    _print_kernels(per_kernel, busy_ms, per=steps)


# kernel-name fragments of each share the fibers profile reports: K1's
# sweeps and its slice sum, the batched LU's factor, pivots and
# triangular solves, the batched Cholesky
FIBER_SHARES = {"K1": ("sym_kernel", "pair_kernel", "slice_sum_kernel"),
                "batched LU": ("getrf", "getrs", "laswp", "trsm", "lu_"),
                "batched Cholesky": ("potrf",)}


def fibers_profile(steps, dev):
    """Host-clock ms a step and one profiled step of phase 17b's carpet and
    phase 17a's free fibers: busy time, idle share, and the shares of K1,
    the batched LU and the batched Cholesky."""
    from rigidmultiblobswall_tpu_torch.examples import fibers_run
    from rigidmultiblobswall_tpu_torch.models import fibers as fib

    cells = [("fibers-carpet-32k (17b)", lambda: chip_smoke.carpet(
        chip_smoke.CARPET_SIDE, torch.float32, dev)),
        ("fibers-4k-batched (17a)", lambda: fibers_run.build(
            chip_smoke.N_FREE_FIBERS, chip_smoke.FIBER_LINKS,
            chip_smoke.FIBER_KT, dtype=torch.float32, device=dev))]
    for cell, build in cells:
        sus, state, dt = build()
        step = fib.make_stepper(sus, dt)
        gen = torch.Generator(device=dev).manual_seed(0)
        state, _ = step(state, gen)
        for _ in range(steps):
            (state, aux), ms = _timed(lambda: step(state, gen))
            print(f"unprofiled {cell} step: {ms:.1f} ms, gmres "
                  f"{aux.iterations}, lanczos {aux.lanczos_iterations}",
                  flush=True)
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            state, aux = step(state, gen)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        per_kernel = _device_kernels(prof)
        busy_ms = sum(ms for ms, _ in per_kernel.values())
        if busy_ms == 0:
            raise SystemExit("torch_profile_step: the profiler saw no "
                             "device time")
        shares = {k: sum(ms for name, (ms, _) in per_kernel.items()
                         if any(f in name.lower() for f in frags))
                  for k, frags in FIBER_SHARES.items()}
        print(f"profiled {cell} step ({sus.num_blobs} blobs f32): wall "
              f"{wall_ms:.1f} ms, device busy {busy_ms:.1f} ms, idle share "
              f"{1 - busy_ms / wall_ms:.3f} (an upper bound: the profiler "
              f"slows the host); gmres {aux.iterations}, lanczos "
              f"{aux.lanczos_iterations}; "
              + ", ".join(f"{k} {ms:.2f} ms ({100 * ms / busy_ms:.1f} %)"
                          for k, ms in shares.items()), flush=True)
        _print_kernels(per_kernel, busy_ms)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("n_shells", type=int, nargs="?", default=chip_smoke.N_SHELLS)
    p.add_argument("--steps", type=int, default=3,
                   help="unprofiled timed steps after the warm-up")
    p.add_argument("--scheme", default="stochastic_Slip_Trapz",
                   help="the integrators scheme to profile")
    p.add_argument("--phoretic", action="store_true",
                   help="Janus shells: the phoretic slip every step")
    p.add_argument("--mcmc", action="store_true",
                   help="phase 16's MCMC chain, --steps moves a run")
    p.add_argument("--fibers", action="store_true",
                   help="phase 17's carpet and free fibers, a step each")
    p.add_argument("--radii", action="store_true",
                   help="phase 18's mixture of two blob radii (kernel P1)")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_step: needs a CUDA card")
    print(chip_smoke.smi(), flush=True)

    dev = torch.device("cuda")
    if args.mcmc:
        mcmc_profile(args.n_shells, args.steps, dev)
        return
    if args.fibers:
        fibers_profile(args.steps, dev)
        return
    if args.scheme.startswith("articulated_"):
        n_chains = args.n_shells // chip_smoke.CHAIN_BODIES
        system = chip_smoke.chain_system(n_chains)
        pos, quat = chip_smoke.chain_lattice(n_chains)
    elif args.phoretic:
        kT = 0.0 if args.scheme.startswith("deterministic") else 0.05
        system, _ = chip_smoke.phoretic_system(args.n_shells, kT=kT)
        pos, quat = chip_smoke.lattice(args.n_shells)
    elif args.radii:
        system = chip_smoke.radii_system(args.n_shells)
        pos, quat = chip_smoke.alternate(*chip_smoke.lattice(args.n_shells))
    else:
        system = chip_smoke.bench_system(args.n_shells)
        pos, quat = chip_smoke.lattice(args.n_shells)
    state = make_state(pos, quat, dtype=torch.float32, device=dev)
    step = integrators.make_stepper(
        system, args.scheme, 1e-3, lanczos_tolerance=5e-4,
        lanczos_max_iter=32, lanczos_check_every=4, gmres_restart=60,
        gmres_maxiter=300, max_rejections=3)
    carry = integrators.init_carry(system, state=state)
    gen = torch.Generator().manual_seed(0)
    state, carry, _ = step(state, gen, carry)          # warm-up and build
    torch.cuda.synchronize()

    if args.scheme.startswith("articulated_"):
        for _ in range(2):
            articulated_parts(system, state)
    for _ in range(args.steps):
        t0 = time.perf_counter()
        state, carry, aux = step(state, gen, carry)
        torch.cuda.synchronize()
        print(f"unprofiled step: {(time.perf_counter() - t0) * 1e3:.1f} ms, "
              f"gmres {aux.det_iterations}, lanczos {aux.stoch_iterations}, "
              f"rejections {aux.rejections}", flush=True)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, carry, aux = step(state, gen, carry)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    per_kernel = _device_kernels(prof)
    busy_ms = sum(ms for ms, _ in per_kernel.values())
    print(f"profiled {args.scheme} step ({system.num_blobs} blobs): wall "
          f"{wall_ms:.1f} ms, "
          f"device busy {busy_ms:.1f} ms, idle share {1 - busy_ms / wall_ms:.3f}"
          f" (an upper bound: the profiler slows the host); gmres "
          f"{aux.det_iterations}, "
          f"lanczos {aux.stoch_iterations}", flush=True)
    if busy_ms == 0:
        raise SystemExit("torch_profile_step: the profiler saw no device time")
    _print_kernels(per_kernel, busy_ms)


if __name__ == "__main__":
    main()
