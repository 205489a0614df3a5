"""Where the device time of one wall-spectral Slip-Trapz step of the
PyTorch port goes.

Drives chip_smoke.py's phase-10 configuration (bench.py's `spectral_wall`
scene: 8192 twelve-blob shells = 98,304 blobs in two layers above the
wall in an xy-periodic box, the spectral wall engine with the wall-slab
linked-cell forces, float32, slab height and capacities sized at the
start) on a CUDA card: the host tables (timed), one warm-up step, a few
unprofiled steps timed on the host clock around `torch.cuda.synchronize()`,
then one step under torch.profiler (CUDA activity). Prints the card's name
and power limit, the unprofiled ms/step with iteration counts, the
device's busy time and idle share in the profiled step, the top kernels,
and the device time grouped by what it serves (K7, K5, FFT, the spread's
index_add_, the interpolation's gathers, the image multipliers'
elementwise products, the rest).

Usage: python3 tools/torch_profile_wall.py [n_shells] [--steps N]
"""

import argparse
import math
import os
import sys
import time
from collections import defaultdict

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from rigidmultiblobswall_tpu_torch.models import (  # noqa: E402
    integrators, kinematics as kin, saddle)
from rigidmultiblobswall_tpu_torch.models.system import (  # noqa: E402
    make_state)
from rigidmultiblobswall_tpu_torch.ops import (  # noqa: E402
    cell_kernels, forces)

# kernel-name fragments per group, first match wins
GROUPS = (("K7 wall_near", ("wall_near",)), ("K5 nl_forces", ("nl_forces",)),
          ("FFT (cuFFT)", ("fft", "FFT")),
          ("spread: index_add_", ("index_add", "indexFuncLarge",
                                  "indexFuncSmall")),
          ("interpolate/gathers", ("index_elementwise", "gather",
                                   "indexSelect")),
          ("complex multiply-adds (multipliers)", ("addcmul", "complex")),
          ("reductions", ("reduce",)))


def _self_device_us(evt):
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return getattr(evt, name)
    return 0.0


def main():
    p = argparse.ArgumentParser()
    p.add_argument("n_shells", type=int, nargs="?",
                   default=chip_smoke.N_WALL)
    p.add_argument("--steps", type=int, default=3,
                   help="unprofiled timed steps after the warm-up")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_wall: needs a CUDA card")
    print(chip_smoke.smi(), flush=True)

    dev = torch.device("cuda")
    side = math.ceil((args.n_shells / 2) ** 0.5 - 1e-9)   # bench.py's
    system = chip_smoke.wall_system(args.n_shells, side * 1.6)
    pos, quat = chip_smoke.wall_lattice(args.n_shells, side)
    state = make_state(pos, quat, dtype=torch.float32, device=dev)
    system = saddle.auto_spectral_capacities(system, state, log=print)
    system = forces.auto_force_cell_capacity(
        system, kin.blob_positions(system, state), log=print)
    t0 = time.perf_counter()
    carry = integrators.init_carry(system, state=state)
    plan = carry.plan
    _ = plan.tables, plan.near_tables
    torch.cuda.synchronize()
    print(f"plan, host tables and device multipliers: "
          f"{time.perf_counter() - t0:.2f} s; grid {plan.params.grid}, "
          f"cells {plan.cell_dims} x cap {plan.params.cell_capacity}",
          flush=True)
    step = integrators.make_stepper(
        system, "stochastic_Slip_Trapz", 1e-3, lanczos_tolerance=5e-4,
        lanczos_max_iter=32, lanczos_check_every=4, gmres_restart=60,
        gmres_maxiter=300, max_rejections=3)
    gen = torch.Generator(device=dev).manual_seed(0)
    state, carry, _ = step(state, gen, carry)          # warm-up
    torch.cuda.synchronize()

    for _ in range(args.steps):
        t0 = time.perf_counter()
        state, carry, aux = step(state, gen, carry)
        torch.cuda.synchronize()
        print(f"unprofiled step: {(time.perf_counter() - t0) * 1e3:.1f} ms, "
              f"gmres {aux.det_iterations}, lanczos {aux.stoch_iterations}, "
              f"overflows {aux.capacity_overflows}", flush=True)

    cell_kernels.LAUNCHES.update(dict.fromkeys(cell_kernels.LAUNCHES, 0))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, carry, aux = step(state, gen, carry)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    per_kernel = defaultdict(lambda: [0.0, 0])
    for evt in prof.key_averages():
        dev_us = _self_device_us(evt)
        if dev_us > 0 and evt.self_cpu_time_total == 0:
            per_kernel[evt.key][0] += dev_us / 1e3
            per_kernel[evt.key][1] += evt.count
    busy_ms = sum(ms for ms, _ in per_kernel.values())
    print(f"profiled step ({system.num_blobs} blobs): wall {wall_ms:.1f} ms, "
          f"device busy {busy_ms:.1f} ms, idle share "
          f"{1 - busy_ms / wall_ms:.3f} (an upper bound: the profiler slows "
          f"the host); gmres {aux.det_iterations}, lanczos "
          f"{aux.stoch_iterations}", flush=True)
    if busy_ms == 0:
        raise SystemExit("torch_profile_wall: the profiler saw no device "
                         "time")
    rows = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])
    for name, (ms, count) in rows[:15]:
        print(f"  {ms:9.2f} ms {100 * ms / busy_ms:5.1f} % {count:5d} x "
              f"{name[:90]}")
    groups = defaultdict(lambda: [0.0, 0])
    for name, (ms, count) in rows:
        label = next((g for g, keys in GROUPS
                      if any(k in name for k in keys)), "everything else")
        groups[label][0] += ms
        groups[label][1] += count
    print("by group:")
    for label, (ms, count) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"  {ms:9.2f} ms {100 * ms / busy_ms:5.1f} % {count:5d} x "
              f"{label}")
    print(f"K5/K7 launches in the profiled step: {cell_kernels.LAUNCHES}")


if __name__ == "__main__":
    main()
