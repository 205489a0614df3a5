#!/usr/bin/env python
"""Smoke test of the PyTorch + CUDA port (rigidmultiblobswall_tpu_torch)
on one NVIDIA card.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises, so the exit code
is non-zero and no result line is printed):
  1. device: requires CUDA (never falls back to the CPU); prints the
     card's name and power limit from nvidia-smi;
  2. build: compiles kernels K1 (csrc/pair_tt.cu) and K2
     (csrc/blob_forces.cu) with nvcc into build/kernels/;
  3. kernels against their plain PyTorch versions on the card: a random
     ~3000-blob scene with blobs below a, and the 49,152-blob shape of
     the main path; prints kernel and plain times;
  4. slice parity: 8 shells, 3 Slip-Trapz steps at kT = 0, on the card
     (kernels) against the CPU (plain versions, float64);
  5. the CLI entry point on a generated 64-shell input file;
  6. the main path at full width: bench.py's multibody configuration,
     4096 twelve-blob shells = 49,152 blobs, stochastic_Slip_Trapz in
     float32 through make_stepper/init_carry, one warm-up step and three
     timed steps, with the kernels' launch counts over the run.
The line before the last holds the per-kernel JSON record; the last line
is {"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
N_SHELLS = 4096
DEVICE = "cuda"
A_BENCH = 0.131


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


def cuda_ms(fn, reps):
    """Mean device time of fn() over reps launches (CUDA events), after
    one warm-up call."""
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


def check(cond, what):
    if not cond:
        raise AssertionError(f"chip_smoke: {what}")


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
                got = pk.pair_tt(qt, qt, vt, wall=wall, self_interaction=True)
                torch.cuda.synchronize()
                ref = pk.pair_tt_plain(qt.double(), qt.double(), vt.double(),
                                       wall=wall, self_interaction=True)
                rel = ((got.double() - ref).abs().max()
                       / ref.abs().max()).item()
                times = ""
                if dtype == torch.float32:
                    ms = cuda_ms(lambda: pk.pair_tt(
                        qt, qt, vt, wall=wall, self_interaction=True), 10)
                    plain_ms = cuda_ms(lambda: pk.pair_tt_plain(
                        qt, qt, vt, wall=wall, self_interaction=True), 3)
                    times = f"; kernel {ms:.3f} ms, plain {plain_ms:.2f} ms"
                log(f"K1 {n} blobs B={n_rhs} wall={wall} {dtype}: "
                    f"max err / max|ref| = {rel:.3e} (bound {bound:g})"
                    + times)
                check(rel <= bound, f"K1 disagrees with plain ({rel:.3e})")
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
        got = pk.pair_tt(q, q, v, wall=True, self_interaction=True)
        torch.cuda.synchronize()
        ref = pk.pair_tt_plain(q.double(), q[:sub].double(), v.double(),
                               wall=True, self_interaction=True)
        err = (got[:sub].double() - ref).abs().max().item()
        rel = err / ref.abs().max().item()
        ms = cuda_ms(lambda: pk.pair_tt(q, q, v, wall=True,
                                        self_interaction=True), 10)
        plain_ms = cuda_ms(lambda: pk.pair_tt_plain(
            q, q, v, wall=True, self_interaction=True), 1)
        log(f"K1 {nb} blobs B={n_rhs} f32, first {sub} target rows vs plain "
            f"f64: max err {err:.3e}, / max|ref| = {rel:.3e} (bound "
            f"u32*sqrt(N) = {bound_main:.2e}); kernel {ms:.3f} ms, plain "
            f"f32 {plain_ms:.1f} ms")
        check(rel <= bound_main, f"K1 disagrees at {nb} blobs ({rel:.3e})")
        if n_rhs == 1:
            records["K1"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    kw = dict(repulsion_strength=0.2, debye_length=0.2, blob_radius=A_BENCH)
    got = mc.blob_blob_forces(r_blobs, **kw)
    torch.cuda.synchronize()
    ref = mc.blob_blob_forces_plain(r_blobs.double(), **kw)
    err = (got.double() - ref).abs().max().item()
    rel = err / ref.abs().max().item()
    ms = cuda_ms(lambda: mc.blob_blob_forces(r_blobs, **kw), 10)
    plain_ms = cuda_ms(lambda: mc.blob_blob_forces_plain(r_blobs, **kw), 1)
    log(f"K2 {nb} blobs f32 vs plain f64: max err {err:.3e}, / max|ref| = "
        f"{rel:.3e} (bound {bound_main:.2e}); kernel {ms:.3f} ms, plain f32 "
        f"{plain_ms:.1f} ms")
    check(rel <= bound_main, f"K2 disagrees at {nb} blobs ({rel:.3e})")
    records["K2"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    return records


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


def phase_slice_parity():
    """Phase 4: 8 shells, kT = 0, 3 steps, card against CPU."""
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
        f"1e-2); gmres {aux.det_iterations}, lanczos {aux.stoch_iterations}")
    check(disp > 0 and e64 <= 1e-9 and e32 <= 1e-2, "slice parity")


def phase_cli():
    """Phase 5: the CLI on a generated 64-shell input file, 3 steps."""
    from rigidmultiblobswall_tpu_torch import cli
    from rigidmultiblobswall_tpu_torch.io import scene

    pos, quat = lattice(64, seed=0)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "shell.vertex"), "w") as f:
            f.write("12\n")
            for x in shell_vertices():
                f.write("%.16g %.16g %.16g\n" % tuple(x))
        scene.write_clones_file(os.path.join(d, "shell.clones"), pos, quat)
        inp = os.path.join(d, "input.dat")
        with open(inp, "w") as f:
            f.write("scheme stochastic_Slip_Trapz\ndt 0.001\nn_steps 3\n"
                    "n_save 3\neta 1.0\ng 0.1\nblob_radius 0.131\nkT 0.05\n"
                    "solver_tolerance 2e-4\nrepulsion_strength_wall 0.2\n"
                    "debye_length_wall 0.2\nrepulsion_strength 0.2\n"
                    "debye_length 0.2\nblob_blob_force_implementation "
                    "python\nseed 1\noutput_name run\n"
                    "structure shell.vertex shell.clones\n")
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
    pk.LAUNCHES = 0
    mc.LAUNCHES = 0
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
    launches = {"K1": pk.LAUNCHES, "K2": mc.LAUNCHES}
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
    return launches


def main():
    # phase 1: device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this smoke test runs only on a CUDA card")
    sys.path.insert(0, ROOT)
    from rigidmultiblobswall_tpu_torch.models import kinematics as kin
    from rigidmultiblobswall_tpu_torch.models.system import make_state
    from rigidmultiblobswall_tpu_torch.ops import _build
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
    regs = [l.split(":", 1)[1].strip() for l in _build.build_log.splitlines()
            if "registers" in l]
    log(f"build: {time.perf_counter() - t0:.2f} s (nvcc "
        f"{_build.build_seconds:.2f} s), {len(regs)} kernel instances; "
        f"ptxas: {regs[0] if regs else 'library reused'}")

    records = phase_kernels(pk, mc, mob, kin, make_state)   # phase 3
    phase_slice_parity()                                    # phase 4
    phase_cli()                                             # phase 5
    launches = phase_main_path(pk, mc)                      # phase 6

    src = {"K1": ("pair_tt", "rigidmultiblobswall_tpu_torch/csrc/pair_tt.cu",
                  "rigidmultiblobswall_tpu/ops/pair_kernels.py:254"),
           "K2": ("blob_forces",
                  "rigidmultiblobswall_tpu_torch/csrc/blob_forces.cu",
                  "rigidmultiblobswall_tpu/ops/mobility_pallas.py:180")}
    kernels = [dict(name=f"{k} {src[k][0]}", route="cuda", source=src[k][1],
                    replaces=src[k][2], launches=launches[k], **records[k])
               for k in ("K1", "K2")]
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
