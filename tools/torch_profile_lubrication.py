"""Where the device time of one lubrication step of the PyTorch port goes.

Drives chip_smoke.py's phase 12 configuration (bench.py's `lubrication`
path, BASELINE config 5: 4096 spheres, step_trapezoidal with omega 25 and
cut_torque 0.2, neighbor-list Delta_R, float32) on a CUDA card: one
warm-up step, a few unprofiled steps timed on the host clock around
`torch.cuda.synchronize()`, then one step under torch.profiler (CUDA
activity); before them one Delta_R assembly, timed between CUDA events
and profiled (its device busy time and launches).
Prints the card's name and power limit, the unprofiled ms/step with
iteration counts, and per-kernel device time, launch count and share of
the profiled step, grouped by what runs it; the device's busy time
against the step's wall time gives its idle share.

Usage: python3 tools/torch_profile_lubrication.py [n_spheres] [--steps N]
"""

import argparse
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from rigidmultiblobswall_tpu_torch.models import (  # noqa: E402
    lubrication as lub)
from torch_profile_rollers import (ACTIVITIES, device_kernels,  # noqa: E402
                                   profile_step)


def _aux_line(aux):
    return (f"gmres {aux.det_iterations}, lanczos {aux.stoch_iterations}, "
            f"rejections {int(aux.rejections_wall + aux.rejections_jump)}, "
            f"neighbor overflow {int(aux.neighbor_overflow)}")


def main():
    p = argparse.ArgumentParser()
    p.add_argument("n_spheres", type=int, nargs="?",
                   default=chip_smoke.N_LUB)
    p.add_argument("--steps", type=int, default=3,
                   help="unprofiled timed steps after the warm-up")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_lubrication: needs a CUDA card")
    print(chip_smoke.smi(), flush=True)

    dev = torch.device("cuda")
    sol = chip_smoke.lub_solver(args.n_spheres, dev)
    ft_calc = chip_smoke.lub_ft_calc()
    r = torch.as_tensor(chip_smoke.lub_lattice(args.n_spheres), device=dev)
    q = torch.tensor([[1.0, 0.0, 0.0, 0.0]] * args.n_spheres,
                     dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def step(r, q):
        return lub.step_trapezoidal(sol, r, q, gen, ft_calc, omega=25.0,
                                    cut_torque=0.2)

    t0 = time.perf_counter()
    r, q, _ = step(r, q)                        # warm-up
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    span_ms = chip_smoke.cuda_ms(lambda: lub.compute_blocks(sol, r), 3)
    with torch.profiler.profile(activities=ACTIVITIES) as prof:
        t0 = time.perf_counter()
        lub.compute_blocks(sol, r)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_kernels(prof)
    print(f"warm-up step {warm_s:.2f} s; one Delta_R "
          f"assembly: {span_ms:.3f} ms between CUDA events, profiled "
          f"{wall_ms:.3f} ms wall, device busy "
          f"{sum(ms for ms, _ in kernels.values()):.3f} ms in "
          f"{sum(n for _, n in kernels.values())} launches", flush=True)
    for _ in range(args.steps):
        t0 = time.perf_counter()
        r, q, aux = step(r, q)
        torch.cuda.synchronize()
        print(f"unprofiled step: {(time.perf_counter() - t0) * 1e3:.1f} ms, "
              + _aux_line(aux), flush=True)

    def profiled():
        nonlocal r, q
        r, q, aux = step(r, q)
        return _aux_line(aux)

    profile_step(profiled, f"{args.n_spheres} spheres, lubrication "
                 "trapezoidal")


if __name__ == "__main__":
    main()
