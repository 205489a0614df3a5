"""Run a function on the ranks of a fresh process group, one process a
rank, and collect rank 0's result.

    result = spawn(world_size, "package.module:function", payload,
                   backend="gloo", device="cpu")

starts `world_size` processes of `python -m
rigidmultiblobswall_tpu_torch.parallel.spawn`, each of which joins the
group through a FileStore in a temporary directory (mesh.init_ranks, with
the group's timeout), calls function(mesh, payload) and leaves the group;
rank 0 pickles the return value, which spawn returns. A rank that fails,
or a run past `run_s` seconds, fails the whole run: every process is
stopped and the ranks' error output is raised. Payloads and results are
pickled, so pass numpy arrays and plain values. The processes import the
port and torch alone.
"""

from __future__ import annotations

import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def spawn(world_size, target, payload=None, *, backend="gloo", device=None,
          timeout_s=None, run_s=600.0, threads=None, workdir=None):
    """target(mesh, payload) on `world_size` new ranks; rank 0's return.
    device: the ranks' device ("cpu", "cuda:0", or None for mesh's
    default); timeout_s: the group's collective timeout (mesh.TIMEOUT_S
    when None); threads: torch's intra-op threads a rank (default: the
    cores shared out, at least 1)."""
    from . import mesh as mesh_mod

    timeout_s = mesh_mod.TIMEOUT_S if timeout_s is None else timeout_s
    threads = threads or max(1, (os.cpu_count() or 1) // int(world_size))
    tmp = Path(tempfile.mkdtemp(prefix="rmw_ranks_", dir=workdir))
    with open(tmp / "payload.pkl", "wb") as fh:
        pickle.dump(payload, fh)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    env["OMP_NUM_THREADS"] = str(threads)
    procs = []
    for rank in range(int(world_size)):
        log = open(tmp / f"rank{rank}.log", "w")
        procs.append((log, subprocess.Popen(
            [sys.executable, "-m", "rigidmultiblobswall_tpu_torch.parallel."
             "spawn", str(tmp), str(rank), str(world_size), backend, target,
             device or "", str(timeout_s), str(threads)],
            cwd=str(ROOT), env=env, stdout=log, stderr=subprocess.STDOUT)))
    deadline = time.monotonic() + run_s
    failed = []
    try:
        for rank, (_, proc) in enumerate(procs):
            left = max(deadline - time.monotonic(), 0.0)
            try:
                rc = proc.wait(timeout=left)
            except subprocess.TimeoutExpired:
                rc = "timeout"
            if rc != 0:
                failed.append((rank, rc))
                break
    finally:
        for log, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    try:
        if failed:
            tails = "\n".join(
                f"--- rank {r} ---\n"
                + (tmp / f"rank{r}.log").read_text()[-4000:]
                for r in range(int(world_size)))
            raise RuntimeError(f"spawn({world_size}, {target}): rank "
                               f"{failed[0][0]} ended with {failed[0][1]}\n"
                               f"{tails}")
        with open(tmp / "result.pkl", "rb") as fh:
            return pickle.load(fh)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _main(argv):
    tmp, rank, world, backend, target, device, timeout_s, threads = argv
    import importlib

    import torch

    from . import mesh as mesh_mod

    torch.set_num_threads(int(threads))
    mesh = mesh_mod.init_ranks(int(world), int(rank), Path(tmp) / "store",
                               backend=backend, timeout_s=float(timeout_s),
                               device=device or None)
    try:
        with open(Path(tmp) / "payload.pkl", "rb") as fh:
            payload = pickle.load(fh)
        module, name = target.split(":")
        result = getattr(importlib.import_module(module), name)(mesh,
                                                                payload)
        if mesh.rank == 0:
            with open(Path(tmp) / "result.tmp", "wb") as fh:
                pickle.dump(result, fh)
            os.replace(Path(tmp) / "result.tmp", Path(tmp) / "result.pkl")
    finally:
        mesh_mod.close()


if __name__ == "__main__":
    _main(sys.argv[1:])
