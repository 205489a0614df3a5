"""Where the device time of one roller step of the PyTorch port goes.

Drives chip_smoke.py's rollers configuration (bench.py's `rollers` path:
32,768 rollers, stochastic_adams_bashforth_rollers, float32) on a CUDA
card, on the direct engine (domain single_wall) or, with --domain
single_wall_spectral, on the wall-spectral engine (bench.py's
BENCH_ROLLER_DOMAIN=single_wall_spectral: K8, K7, periodic K2, the
gridding and the FFTs): one warm-up step, a few unprofiled steps timed
on the host clock around `torch.cuda.synchronize()`, then one step under
torch.profiler (CUDA activity). Prints the card's name and power limit,
the unprofiled ms/step with iteration counts, and per-kernel device time,
launch count and share of the profiled step, grouped by what runs it;
the device's busy time against the step's wall time gives its idle
share.

Usage: python3 tools/torch_profile_rollers.py [n_rollers] [--steps N]
           [--domain single_wall|single_wall_spectral]
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
from rigidmultiblobswall_tpu_torch.models import rollers  # noqa: E402


def _self_device_us(evt):
    # the attribute's name changed across torch releases
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return getattr(evt, name)
    return 0.0


# kernel-name fragments -> what runs them (the port's kernels by their
# CUDA names; PyTorch's own by the operation); tools/
# torch_profile_lubrication.py groups with these too
GROUPS = (("wall_rot_near", "K8 rot near field"),
          ("wall_near", "K7 tt near field"),
          ("force_sym_kernel", "K2 blob forces"),
          ("slice_sum", "K1/K2 slice sums"),
          ("pair_", "K1 pair products"),
          ("pairk::", "K1 pair products"),
          ("addcmul", "image multipliers (addcmul_)"),
          ("indexfunc", "gridding: spread (index_add_)"),
          ("index_elementwise", "gridding: interpolate (gather)"),
          ("gather", "gridding: interpolate (gather)"),
          ("fft", "FFTs (cuFFT)"),
          ("r2c", "FFTs (cuFFT)"),
          ("c2r", "FFTs (cuFFT)"),
          ("fill", "zero fills"),
          ("sort", "sorts (neighbor selection)"),
          ("getr", "batched LU inverses (12x12)"),
          ("potr", "batched Cholesky (6x6, 3x3)"),
          ("trsm", "batched triangular solves"),
          ("magma", "batched dense algebra (MAGMA)"),
          ("catarray", "concatenations"),
          ("reduce", "reductions"),
          ("gemm", "matrix products"),
          ("gemv", "matrix products"),
          ("elementwise", "other elementwise"))


def _group(name):
    low = name.lower()
    for frag, label in GROUPS:
        if frag in low:
            return label
    return "other"


def _aux_line(aux):
    return (f"gmres sweeps {aux.det_iterations}, lanczos "
            f"{aux.stoch_iterations}, rejections {aux.rejections}")


def main():
    p = argparse.ArgumentParser()
    p.add_argument("n_rollers", type=int, nargs="?",
                   default=chip_smoke.N_ROLLERS)
    p.add_argument("--steps", type=int, default=3,
                   help="unprofiled timed steps after the warm-up")
    p.add_argument("--domain", default="single_wall",
                   choices=("single_wall", "single_wall_spectral"))
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_rollers: needs a CUDA card")
    print(chip_smoke.smi(), flush=True)

    sus = (chip_smoke.wall_roller_suspension(args.n_rollers)
           if args.domain == "single_wall_spectral"
           else chip_smoke.roller_suspension(args.n_rollers))
    r = torch.as_tensor(chip_smoke.roller_lattice(args.n_rollers),
                        device="cuda")
    step = rollers.make_stepper(sus, "stochastic_adams_bashforth_rollers",
                                1e-3, max_rejections=3)
    t0 = time.perf_counter()
    carry = rollers.init_carry(sus, positions=r)
    gen = torch.Generator().manual_seed(0)
    r, carry, _ = step(r, gen, carry)           # warm-up and build
    torch.cuda.synchronize()
    print(f"domain {args.domain}: init_carry and warm-up step "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.synchronize()

    for _ in range(args.steps):
        t0 = time.perf_counter()
        r, carry, aux = step(r, gen, carry)
        torch.cuda.synchronize()
        print(f"unprofiled step: {(time.perf_counter() - t0) * 1e3:.1f} ms, "
              + _aux_line(aux), flush=True)

    def profiled():
        nonlocal r, carry
        r, carry, aux = step(r, gen, carry)
        return _aux_line(aux)

    profile_step(profiled, f"{args.n_rollers} rollers, {args.domain}")


ACTIVITIES = [torch.profiler.ProfilerActivity.CPU,
              torch.profiler.ProfilerActivity.CUDA]


def device_kernels(prof):
    """{kernel name: [device ms, launches]} of a profile: the events with
    device time and no host time."""
    per_kernel = defaultdict(lambda: [0.0, 0])
    for evt in prof.key_averages():
        dev_us = _self_device_us(evt)
        if dev_us > 0 and evt.self_cpu_time_total == 0:
            per_kernel[evt.key][0] += dev_us / 1e3
            per_kernel[evt.key][1] += evt.count
    return per_kernel


def profile_step(run, label):
    """Run one step (run() -> a text of its solver counts) under
    torch.profiler (CUDA activity) and print its wall and device busy
    time, idle share, top kernels and the kernels grouped by what runs
    them."""
    with torch.profiler.profile(activities=ACTIVITIES) as prof:
        t0 = time.perf_counter()
        counts = run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    per_kernel = device_kernels(prof)
    busy_ms = sum(ms for ms, _ in per_kernel.values())
    print(f"profiled step ({label}): wall {wall_ms:.1f} ms, "
          f"device busy {busy_ms:.1f} ms, idle share "
          f"{1 - busy_ms / wall_ms:.3f} (an upper bound: the profiler slows "
          f"the host); " + counts, flush=True)
    if busy_ms == 0:
        raise SystemExit("profile_step: the profiler saw no device time")
    rows = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])
    top, rest = rows[:12], rows[12:]
    for name, (ms, count) in top:
        print(f"  {ms:9.2f} ms {100 * ms / busy_ms:5.1f} % {count:5d} x "
              f"{name[:90]}")
    rest_ms = sum(ms for _, (ms, _) in rest)
    print(f"  {rest_ms:9.2f} ms {100 * rest_ms / busy_ms:5.1f} % "
          f"{sum(c for _, (_, c) in rest):5d} x  ({len(rest)} other kernels)")
    groups = defaultdict(lambda: [0.0, 0])
    for name, (ms, count) in rows:
        groups[_group(name)][0] += ms
        groups[_group(name)][1] += count
    print("by what runs them:")
    for what, (ms, count) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"  {ms:9.2f} ms {100 * ms / busy_ms:5.1f} % {count:5d} x "
              f"{what}")


if __name__ == "__main__":
    main()
