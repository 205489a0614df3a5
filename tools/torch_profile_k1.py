"""Launch shapes of kernel K1 (csrc/pair_blocks.cuh) on a CUDA card.

At the main paths' shapes (chip_smoke.py's scenes, float32): tt at 49,152
blobs (B = 1 and 2) and at 12,288 blobs, and grand, rr, tr and rt at
32,768 rollers. It prints the ptxas registers and spills of every K1
instance (when this process built the library), times each shape as the
paths call it (the square product: tt and grand on the symmetric sweep
over ops/pair_kernels.py plan_groups' groups, the others on the sliced
sweep at launch_plan's slice count) and on the sliced sweep at a list of
slice counts (CUDA events, mean of 10 launches after a warm-up), holding
the sliced sweep's output to the path's. Last it counts, in the
library's SASS (cuobjdump), the MUFU.RSQ/MUFU.RCP instructions and
subroutine calls of every K1 instance (a float32 IEEE division shows as
MUFU.RCP with a call to its slow path) and writes the full listing to
--sass-out (default build/k1_sass.txt).

    python3 tools/torch_profile_k1.py
    python3 tools/torch_profile_k1.py --root DIR --baseline
        # only the times of the paths' calls, with the package (and
        # chip_smoke.py) of another checkout DIR, e.g. the parent commit
        # unpacked with `git archive` into a directory that .gitignore
        # lists
"""

import argparse
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]

# slice counts the sliced sweep is timed at, per shape
SWEEP = {"tt49k": (8, 24, 48, 96),
         "tt49k_b2": (24, 48),
         "tt12k": (24, 48, 96),
         "grand": (8, 16, 32, 64)}


def scenes(cs, dev):
    """(name, coupling, q, v) at the main paths' shapes, float32."""
    from rigidmultiblobswall_tpu_torch.models import kinematics as kin
    from rigidmultiblobswall_tpu_torch.models.system import make_state
    from rigidmultiblobswall_tpu_torch.ops import mobility as mob

    out = []
    g = torch.Generator(device=dev).manual_seed(1)
    for n_shells, tag in ((cs.N_SHELLS, "tt49k"), (cs.N_DENSE, "tt12k")):
        pos, quat = cs.lattice(n_shells)
        system = cs.bench_system(n_shells)
        state = make_state(pos, quat, dtype=torch.float32, device=dev)
        r = kin.blob_positions(system, state).contiguous()
        q = (mob.shift_heights(r, cs.A_BENCH) / cs.A_BENCH).contiguous()
        n = q.shape[0]
        out.append((tag, "tt", q, torch.randn((n, 3), generator=g,
                                              device=dev)))
        if tag == "tt49k":
            out.append(("tt49k_b2", "tt", q, torch.randn(
                (n, 6), generator=g, device=dev)))
    r = torch.as_tensor(cs.roller_lattice(cs.N_ROLLERS), device=dev)
    q = (mob.shift_heights(r, cs.A_ROLLER) / cs.A_ROLLER).contiguous()
    n = q.shape[0]
    for tag, coupling, nv in (("grand", "grand", 6), ("rr", "rr", 3),
                              ("rr_b2", "rr", 6), ("tr", "tr", 3),
                              ("tr_b2", "tr", 6), ("rt", "rt", 3)):
        out.append((tag, coupling, q, torch.randn((n, nv), generator=g,
                                                  device=dev)))
    return out


def sliced(pk, lib, coupling, q, v, want):
    """The sliced sweep of the square product in `want` slices (rounded
    to whole tiles a slice), launched through the C entry point; returns
    (out, S, tiles_per_slice)."""
    n, nv = v.shape
    s_tiles = -(-n // pk.TILE)
    tiles = -(-s_tiles // min(want, s_tiles))
    n_slices = -(-s_tiles // tiles)
    out = torch.empty_like(v)
    ws = torch.empty((n_slices, n, nv), dtype=v.dtype, device=v.device)
    name = f"pair_{coupling}_f32"
    err = getattr(lib, name)(
        q.data_ptr(), q.data_ptr(), v.data_ptr(), out.data_ptr(),
        ws.data_ptr(), n, n, nv // pk.NCOMP[coupling], n_slices, tiles, 1, 1,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{name}: CUDA error {err}")
    return out, n_slices, tiles


def time_shapes(cs, pk, shapes, baseline=False):
    """Prints each shape's time as the paths call it and, unless
    baseline, on the sliced sweep at SWEEP's slice counts."""
    for tag, coupling, q, v in shapes:
        kw = dict(coupling=coupling, wall=True, self_interaction=True)
        n_rhs = v.shape[1] // pk.NCOMP[coupling]
        head = f"  {tag} {q.shape[0]} x B={n_rhs}"
        if baseline:
            ms = cs.cuda_ms(lambda: pk.pair_matvec(q, q, v, **kw), 10)
            print(f"{head}: {ms:.3f} ms", flush=True)
            continue
        ms = cs.cuda_ms(lambda: pk.pair_matvec(q, None, v, **kw), 10)
        path = pk.pair_matvec(q, None, v, **kw)
        if coupling in pk.SYMMETRIC:
            n_sm = torch.cuda.get_device_properties(
                q.device).multi_processor_count
            g, per = pk.plan_groups(q.shape[0], n_sm)
            label = f"symmetric sweep, {g} groups of {per} tiles"
        else:
            s, tiles = pk.launch_plan(coupling, q, q, v, wall=True)
            label = f"plan S={s} ({tiles} tiles a slice)"
        print(f"{head} {label}: {ms:.3f} ms", flush=True)
        lib = pk._build.library()
        for want in SWEEP.get(tag, ()):
            ms = cs.cuda_ms(lambda: sliced(pk, lib, coupling, q, v, want),
                            10)
            out, s, tiles = sliced(pk, lib, coupling, q, v, want)
            rel = ((out.double() - path.double()).abs().max()
                   / path.double().abs().max()).item()
            print(f"{head} S={s} ({tiles} tiles a slice): {ms:.3f} ms, "
                  f"max diff to the path's call / max {rel:.2e}", flush=True)
            if not rel <= 3e-6:
                raise SystemExit(f"the sliced sweep disagrees on {tag}")


def sass_counts(lib_path, log_path):
    """Per K1 instance: MUFU.RSQ, MUFU.RCP and CALL counts in the SASS."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                         text=True)
    text = out.stdout + out.stderr
    Path(log_path).parent.mkdir(parents=True, exist_ok=True)
    Path(log_path).write_text(text)
    counts, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = dict(rsq=0, rcp=0, call=0, calls=set())
        elif name is not None:
            c = counts[name]
            c["rsq"] += "MUFU.RSQ" in line
            c["rcp"] += "MUFU.RCP" in line
            if "CALL" in line:
                c["call"] += 1
                c["calls"].add(line.split("CALL", 1)[1].strip()[:60])
    names = list(counts)
    if names and shutil.which("c++filt"):
        dem = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True).stdout
        names = [d.split("(", 1)[0] for d in dem.splitlines()]
    return [(n, c) for n, c in zip(names, counts.values())
            if "pair_kernel" in n or "sym_kernel" in n or "slice_sum" in n
            or "dense_tt" in n]


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--root", default=str(ROOT))
    p.add_argument("--baseline", action="store_true",
                   help="only the times of the paths' calls")
    p.add_argument("--sass-out", default=str(ROOT / "build" / "k1_sass.txt"),
                   help="where the library's SASS listing goes")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_k1: needs a CUDA card")
    sys.path.insert(0, args.root)
    import chip_smoke as cs
    from rigidmultiblobswall_tpu_torch.ops import _build
    from rigidmultiblobswall_tpu_torch.ops import pair_kernels as pk

    print(cs.smi(), flush=True)
    print(f"package from {Path(pk.__file__).resolve().parents[1]}",
          flush=True)
    dev = torch.device("cuda")
    shapes = scenes(cs, dev)
    lib = _build.library()
    if args.baseline:
        time_shapes(cs, pk, shapes, baseline=True)
        return
    if _build.build_log:
        for line in cs.ptxas_report(_build.build_log):
            if any(k in line for k in ("pair_kernel<float", "sym_kernel<float",
                                       "dense_tt")):
                print(f"  ptxas {line}", flush=True)
    else:
        print("library reused: no ptxas report in this process", flush=True)
    time_shapes(cs, pk, shapes)
    print("SASS (MUFU.RSQ, MUFU.RCP, calls):", flush=True)
    for name, c in sass_counts(lib._name, args.sass_out):
        print(f"  {name}: rsq {c['rsq']}, rcp {c['rcp']}, calls {c['call']} "
              f"{sorted(c['calls'])}", flush=True)


if __name__ == "__main__":
    main()
