"""Where the device time of one periodic-spectral Slip-Trapz step of the
PyTorch port goes.

Drives chip_smoke.py's phase-8 configuration (bench.py's `spectral`
scene: 8192 twelve-blob shells = 98,304 blobs in a periodic box, the
spectral Ewald engine with linked-cell forces, float32, capacities sized
at the start) on a CUDA card: one warm-up step, a few unprofiled steps
timed on the host clock around `torch.cuda.synchronize()`, then one step
under torch.profiler (CUDA activity). Prints the card's name and power
limit, the unprofiled ms/step with iteration counts, the device's busy
time and idle share in the profiled step, the top kernels, and the
device time grouped by what it serves (K6, or P2's list product and
list build, K5, FFT, the spread's index_add_, the interpolation's
gathers, the rest). With --radii the scene is chip_smoke.py's phase 19:
the same box with bench.py's shell and a 1.2x shell (blob radius 0.157)
alternating, on the mixed-radii plan (near field on kernel P2, G = 2
channel blocks gridded).

Usage: python3 tools/torch_profile_spectral.py [n_shells] [--steps N]
       [--radii]
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
from rigidmultiblobswall_tpu_torch.ops import forces  # noqa: E402

# kernel-name fragments per group, first match wins
GROUPS = (("K6 near_rpy", ("near_rpy",)),
          ("P2 list product", ("product_kernel",)),
          ("P2 list build", ("pairs_kernel",)),
          ("K5 nl_forces", ("nl_forces",)),
          ("FFT (cuFFT)", ("fft", "FFT")),
          ("spread: index_add_", ("index_add", "indexFuncLarge",
                                  "indexFuncSmall")),
          ("interpolate/gathers", ("index_elementwise", "gather",
                                   "indexSelect")),
          ("reductions", ("reduce",)))


def _self_device_us(evt):
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return getattr(evt, name)
    return 0.0


def main():
    p = argparse.ArgumentParser()
    p.add_argument("n_shells", type=int, nargs="?",
                   default=chip_smoke.N_SPECTRAL)
    p.add_argument("--steps", type=int, default=3,
                   help="unprofiled timed steps after the warm-up")
    p.add_argument("--radii", action="store_true",
                   help="phase 19's mixture of two blob radii (kernel P2)")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_spectral: needs a CUDA card")
    print(chip_smoke.smi(), flush=True)

    dev = torch.device("cuda")
    side = math.ceil(args.n_shells ** (1 / 3) - 1e-9)   # bench.py's lattice
    if args.radii:
        system = chip_smoke.radii_spectral_system(args.n_shells, side * 1.6)
        pos, quat = chip_smoke.alternate(
            *chip_smoke.spectral_lattice(args.n_shells, side))
    else:
        system = chip_smoke.spectral_system(args.n_shells, side * 1.6)
        pos, quat = chip_smoke.spectral_lattice(args.n_shells, side)
    state = make_state(pos, quat, dtype=torch.float32, device=dev)
    system = saddle.auto_spectral_capacities(system, state, log=print)
    system = forces.auto_force_cell_capacity(
        system, kin.blob_positions(system, state), log=print)
    step = integrators.make_stepper(
        system, "stochastic_Slip_Trapz", 1e-3, lanczos_tolerance=5e-4,
        lanczos_max_iter=32, lanczos_check_every=4, gmres_restart=60,
        gmres_maxiter=300, max_rejections=3)
    carry = integrators.init_carry(system, state=state)
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
        raise SystemExit("torch_profile_spectral: the profiler saw no "
                         "device time")
    rows = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])
    for name, (ms, count) in rows[:12]:
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


if __name__ == "__main__":
    main()
