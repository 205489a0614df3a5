#!/usr/bin/env python
"""Where the materialized mobility engine stops paying on the card.

    python3 tools/torch_dense_budget.py [n_shells ...]

For each count of twelve-blob shells (default 1024, 2048 and 2560, i.e.
12,288, 24,576 and 30,720 blobs) on chip_smoke.py's lattice with bench.py's
multibody physics (float32, GMRES 2e-4, Lanczos 5e-4 checked every 4),
runs stochastic_Slip_Trapz for one warm-up and two timed steps on the
materialized engine (kernels K3 and K4; the budget raised to hold the
matrix) and on the matrix-free engine (budget 0, kernel K1), and prints
ms/step, solver counts and peak device memory of each, with the time of
one K3 build, one K4 product and one K1 product at that size. A Slip-Trapz
step keeps two matrices live, so 30,720 blobs (2 x 34 GB) is the largest
count an 80 GB card holds. Needs a CUDA card.
"""

import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv):
    if not torch.cuda.is_available():
        raise SystemExit("torch_dense_budget: needs a CUDA card")
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from rigidmultiblobswall_tpu_torch.models import kinematics as kin
    from rigidmultiblobswall_tpu_torch.models import saddle
    from rigidmultiblobswall_tpu_torch.models.system import make_state
    from rigidmultiblobswall_tpu_torch.ops import mobility as mob
    from rigidmultiblobswall_tpu_torch.ops import mobility_cuda as mc
    from rigidmultiblobswall_tpu_torch.ops import pair_kernels as pk

    print(cs.smi(), flush=True)
    dev = torch.device("cuda")
    budget = saddle.MATERIALIZE_BUDGET_BYTES
    for n_shells in [int(x) for x in argv] or [1024, 2048, 2560]:
        system = cs.bench_system(n_shells)
        pos, quat = cs.lattice(n_shells)
        state = make_state(pos, quat, dtype=torch.float32, device=dev)
        r = kin.blob_positions(system, state).contiguous()
        n = r.shape[0]
        m = mc.dense_tt(r, system.eta, system.blob_radius, mode="wall")
        v = torch.randn((n, 3), device=dev)
        q = (mob.shift_heights(r, system.blob_radius)
             / system.blob_radius).contiguous()
        k3 = cs.cuda_ms(lambda: mc.dense_tt(r, system.eta, system.blob_radius,
                                            mode="wall"), 3, warmup=False)
        k4 = cs.cuda_ms(lambda: mc.symm_matvec(m, v), 10)
        k1 = cs.cuda_ms(lambda: pk.pair_matvec(q, None, v, coupling="tt",
                                               mode="wall",
                                               self_interaction=True), 10)
        del m
        # a matrix-sized block left cached would not fit the next one
        torch.cuda.empty_cache()
        print(f"{n} blobs: matrix {9 * n * n * 4 / 2**30:.2f} GiB; K3 "
              f"{k3:.3f} ms, K4 {k4:.3f} ms, K1 tt {k1:.3f} ms", flush=True)
        try:
            for engine, b in (("materialized", 1 << 62), ("matrix-free", 0)):
                saddle.MATERIALIZE_BUDGET_BYTES = b
                torch.cuda.empty_cache()
                t0 = time.perf_counter()
                rec, launches = cs.run_dense_path(
                    system, "stochastic_Slip_Trapz", pos, quat, pk, mc,
                    n_timed=2)
                print(f"  {engine}: {rec['ms']:.1f} ms/step (warm-up "
                      f"{rec['warm_ms']:.1f}); gmres {rec['det']}, lanczos "
                      f"{rec['sto']}; launches over 3 steps {launches}; peak "
                      f"{rec['peak']:.2f} GiB; "
                      f"{time.perf_counter() - t0:.1f} s", flush=True)
        finally:
            saddle.MATERIALIZE_BUDGET_BYTES = budget


if __name__ == "__main__":
    main(sys.argv[1:])
