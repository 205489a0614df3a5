"""Step times of chip_smoke.py's phase 6 (multibody-49k, Slip-Trapz),
phase 8 (spectral-98k, Slip-Trapz on K6), phase 15 (multibody-49k-phoretic:
forward Euler and Slip-Trapz, the concentration field), phase 16
(multibody-49k-mcmc: the chain's ms a step on M1 and the rejection
sampler's proposals a second on M1's batch), phase 18 (multibody-49k-radii:
forward Euler and Slip-Trapz on kernel P1), phase 19
(spectral-98k-radii: Slip-Trapz on kernel P2) and phase 21's free-surface
steps (21a: forward Euler and Slip-Trapz on K1 tt_fs, then one Slip-Trapz
step in 20a's box on its image instance; 21e: forward Euler and
Slip-Trapz on P1's free-surface instance (B = 1 and the lockstep pair's
B = 2), then one forward Euler step in the box; the box's solves stop at
GMRES's cap, GMRES_MAXITER here, as chip_smoke.py logs them) on a CUDA
card, for the
package and chip_smoke.py of one checkout, in one process:

    python3 tools/torch_phase_times.py [--root DIR] [--phases 6,15,18,21]

DIR defaults to this checkout; another one (e.g. the parent commit
unpacked with `git archive` into a directory that .gitignore lists)
builds its own kernels into its own build/kernels/. Each phase runs as
chip_smoke.py runs it, with its checks; its log lines, which carry the
ms/step, the solver counts and the launches, are printed as they come,
then one summary line `phase times <root>: ...` (ms a step; phase 16's
chain in ms a step and its sampler in proposals a second). To compare two
checkouts, run them in turns in one chip call (parent, change, change,
parent): step times are host-clock and spread between calls.
"""

import argparse
import os
import re
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def free_surface_steps(cs, log, pk, mc, ck, lap):
    """Phase 21's free-surface runs as chip_smoke.py phase_domains runs
    them (21a, 21e), each logged with its ms a step, GMRES and Lanczos
    counts, whether its solves converged, and its launches."""
    box = cs.xy_box(cs.L_FS_IMAGES)
    pos, quat = cs.lattice(cs.N_SHELLS)
    epos, equat = cs.alternate(*cs.lattice(cs.N_SHELLS))
    fe, st = "deterministic_forward_euler", "stochastic_Slip_Trapz"
    runs = (("21a", cs.bench_system(cs.N_SHELLS, domain="free_surface"),
             fe, pos, quat, 3, ""),
            ("21a", cs.bench_system(cs.N_SHELLS, domain="free_surface"),
             st, pos, quat, 3, ""),
            ("21a", cs.bench_system(cs.N_SHELLS, domain="free_surface",
                                    periodic_length=box),
             st, pos, quat, 1, f" in {box}"),
            ("21e", cs.radii_system(cs.N_SHELLS, domain="free_surface"),
             fe, epos, equat, 2, ""),
            ("21e", cs.radii_system(cs.N_SHELLS, domain="free_surface"),
             st, epos, equat, 2, ""),
            ("21e", cs.radii_system(cs.N_SHELLS, domain="free_surface",
                                    periodic_length=box),
             fe, epos, equat, 1, f" in {box}"))
    for name, system, scheme, p, q, n_steps, where in runs:
        cs._reset_counts(pk, mc, ck, lap)
        state, times, auxes = cs._domain_steps(system, scheme, p, q,
                                               n_steps)
        log(f"{name}{where} {scheme}: {cs._fmt(times)} ms/step (the first "
            f"with the set-up); gmres {[a.det_iterations for a in auxes]}, "
            f"converged {[bool(a.solves_converged) for a in auxes]}, lanczos "
            f"{[a.stoch_iterations for a in auxes]}; launches "
            f"{cs._launch_counts(pk, mc, ck)}; positions finite "
            f"{bool(torch.isfinite(state.pos).all())}")
        del state, auxes
        torch.cuda.empty_cache()


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--root", default=str(ROOT))
    p.add_argument("--phases", default="6,15",
                   help="comma-separated subset of 6, 8, 15, 16, 18, 19 "
                        "and 21")
    args = p.parse_args()
    phases = [x.strip() for x in args.phases.split(",") if x.strip()]
    if not set(phases) <= {"6", "8", "15", "16", "18", "19", "21"}:
        raise SystemExit(f"torch_phase_times: unknown phases {phases}")
    if not torch.cuda.is_available():
        raise SystemExit("torch_phase_times: needs a CUDA card")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    os.chdir(root)
    import chip_smoke as cs
    from rigidmultiblobswall_tpu_torch.ops import _build
    from rigidmultiblobswall_tpu_torch.ops import cell_kernels as ck
    from rigidmultiblobswall_tpu_torch.ops import laplace as lap
    from rigidmultiblobswall_tpu_torch.ops import mobility_cuda as mc
    from rigidmultiblobswall_tpu_torch.ops import pair_kernels as pk

    lines = []

    def log(msg):
        lines.append(msg)
        print(msg, flush=True)

    cs.log = log
    log(cs.smi())
    t0 = time.perf_counter()
    _build.library()
    log(f"package from {root}: library ready in "
        f"{time.perf_counter() - t0:.1f} s")
    if "6" in phases:
        cs.phase_main_path(pk, mc)
    if "8" in phases:
        cs.phase_spectral_path(pk, mc, ck)
    if "15" in phases:
        cs.phase_phoretic_path(pk, mc)
    if "16" in phases:
        cs.phase_mcmc_path(pk, mc)
    if "18" in phases:
        cs.phase_radii_path(pk, mc, ck, lap)
    if "19" in phases:
        cs.phase_radii_spectral_path(pk, mc, ck, lap,
                                     cs.ptxas_report(_build.build_log))
    if "21" in phases:
        free_surface_steps(cs, log, pk, mc, ck, lap)
    patterns = (
        r"(main path|multibody-49k-(?:phoretic|radii) \w+"
        r"|spectral path|spectral-98k-radii) .*?: ([0-9.]+) ms/step",
        r"(multibody-49k-mcmc) .*? ([0-9.]+) ms per step",
        r"(rejection sampler), .*? s, ([0-9]+) proposals per second",
        r"(21[ae](?: in \(.*?\))? \w+): ([0-9., ]+) ms/step")
    summary = []
    for line in lines:
        for pat in patterns:
            m = re.match(pat, line)
            if m:
                summary.append(f"{m.group(1)} {m.group(2)}")
    print(f"phase times {root}: " + "; ".join(summary), flush=True)


if __name__ == "__main__":
    main()
