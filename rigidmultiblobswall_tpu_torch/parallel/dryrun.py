"""The multi-device entry point, the port's twin of the JAX package's
`__graft_entry__.dryrun_multichip`, and a runner of sharded products.

`dryrun_multichip(n_ranks)` starts `n_ranks` ranks (parallel/spawn.py,
gloo, on `device`, default the card; the ranks may share one card) and
runs on them the five paths of the JAX function, at its sizes and with
its schemes, each under the mesh and against its single-rank twin
(mesh=None, on rank 0) from the same inputs and the same generator seeds:

- multibody single_wall, 2 n shells of 12 blobs, stochastic Slip-Trapz;
- periodic_spectral, 2 n shells, stochastic EM (grid 64, divisible by the
  ranks: the distributed FFT);
- rollers, 4 n of them above the wall, stochastic Adams-Bashforth;
- lubrication, 4 n spheres, the stochastic trapezoidal step with a
  prescribed spin;
- single_wall_spectral, 2 n shells, stochastic EM.

Each path's final positions must agree to `tol` relative to max(|x|, 1)
(the JAX function's 5e-5 by default). Returns, per path, the relative
difference, both runs' solver counts and times, and the ranks' launches
of the kernels' rank-share instances and collective counts.

`products(mesh, cases)` runs a list of pairwise, grand, spectral and wall
products under a mesh (or none) on numpy inputs and returns their
outputs, and optionally their times; the CPU tests and the chip smoke
drive the ranks with it.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from . import mesh as mesh_mod
from .spawn import spawn

PATHS = ("multibody single_wall", "periodic_spectral", "rollers",
         "lubrication", "single_wall_spectral")


def _shell(n=12, radius=0.5):
    i = np.arange(n) + 0.5
    phi = np.arccos(1 - 2 * i / n)
    theta = np.pi * (1 + 5 ** 0.5) * i
    return radius * np.stack([np.cos(theta) * np.sin(phi),
                              np.sin(theta) * np.sin(phi),
                              np.cos(phi)], axis=1)


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1.0))


def _gen(seed, device):
    return torch.Generator(device=device).manual_seed(int(seed))


def _body_path(mesh, n, which, dtype, device):
    from ..models import integrators
    from ..models.system import BodyType, System, make_state

    count = 2 * n
    t = BodyType(name="shell12", ref_config=_shell(), count=count)
    quat = np.tile(np.array([1.0, 0, 0, 0]), (count, 1))
    idx = np.arange(count)
    kw = dict(lanczos_tolerance=1e-3, lanczos_max_iter=8, gmres_maxiter=60,
              max_rejections=2)
    if which == "multibody single_wall":
        system = System(types=(t,), eta=1.0, blob_radius=0.131, kT=0.05,
                        g=0.1, domain="single_wall",
                        repulsion_strength_wall=0.2, debye_length_wall=0.2,
                        solver_tolerance=1e-3, mesh=mesh)
        side = int(np.ceil(count ** 0.5))
        pos = np.stack([(idx % side) * 1.6, (idx // side) * 1.6,
                        np.full(count, 2.0)], axis=1)
        scheme, seed = "stochastic_Slip_Trapz", 0
    else:
        side = int(np.ceil(count ** (1 / 3)))
        if which == "periodic_spectral":
            L = max(side * 1.6, 5.0)
            system = System(
                types=(t,), eta=1.0, blob_radius=0.131, kT=0.05, g=0.0,
                domain="periodic_spectral", periodic_length=(L, L, L),
                spectral_tol=1e-3, spectral_grid_max=64,
                spectral_cell_capacity=32, solver_tolerance=1e-3, mesh=mesh)
            z = 0.8 + (idx // (side * side)) * 1.6
            seed = 1
        else:
            L = max(side * 1.6, 6.6)
            system = System(
                types=(t,), eta=1.0, blob_radius=0.131, kT=0.05, g=0.1,
                domain="single_wall_spectral", periodic_length=(L, L, 0.0),
                spectral_wall_height=2.6, spectral_tol=1e-3,
                spectral_grid_max=48, repulsion_strength_wall=0.2,
                debye_length_wall=0.2, solver_tolerance=1e-3, mesh=mesh)
            z = 1.0 + (idx // (side * side)) * 0.9
            seed = 4
        pos = np.stack([(idx % side) * 1.6, ((idx // side) % side) * 1.6,
                        z], axis=1)
        scheme = "stochastic_EM"
    state = make_state(pos, quat, dtype=dtype, device=device)
    step = integrators.make_stepper(system, scheme, 1e-3, **kw)
    carry = integrators.init_carry(system, state=state)
    new, _, aux = step(state, _gen(seed, device), carry)
    return new.pos, (aux.det_iterations, aux.stoch_iterations)


def _roller_path(mesh, n, dtype, device):
    from ..models import rollers

    n_roll = 4 * n
    sus = rollers.RollerSuspension(
        mesh=mesh, num_rollers=n_roll, eta=1.0, blob_radius=0.5, kT=0.05,
        g=0.2, domain="single_wall", repulsion_strength=0.2,
        debye_length=0.2, repulsion_strength_wall=0.2,
        debye_length_wall=0.2, solver_tolerance=1e-3, free_kinematics=False,
        omega_one_roller=(0.0, 5.0, 0.0), lanczos_max_iter=8)
    idx = np.arange(n_roll)
    r0 = torch.as_tensor(np.stack([(idx % 4) * 1.6, (idx // 4) * 1.6,
                                   np.full(n_roll, 1.2)], axis=1),
                         dtype=dtype, device=device)
    step = rollers.make_stepper(sus, "stochastic_adams_bashforth_rollers",
                                1e-3, max_rejections=2)
    r1, _, aux = step(r0, _gen(2, device),
                      rollers.init_carry(sus, dtype=dtype, device=device))
    return r1, (aux.det_iterations, aux.stoch_iterations)


def _lub_path(mesh, n, dtype, device):
    from ..models import lubrication as lub
    from ..ops import forces as force_ops

    n_lub = 4 * n
    sol = lub.LubSolver(
        num_bodies=n_lub, eta=1e-3, a=1.0, kT=4e-3, dt=1e-3, cutoff=4.5,
        cutoff_wall=4.5, debye_cut=1e-2, rf_delta=1e-3,
        solver_tolerance=1e-3, max_neighbors=8, mesh=mesh, device=device)

    def ft_calc(p):
        f = force_ops.blob_external_forces(
            p, g=2.5e-3, blob_radius=1.0, repulsion_strength_wall=1.6e-2,
            debye_length_wall=0.1)
        return torch.cat([f, torch.zeros_like(f)], dim=1)

    idx = np.arange(n_lub)
    p0 = torch.as_tensor(np.stack([(idx % 4) * 2.4, (idx // 4) * 2.4,
                                   np.full(n_lub, 1.3)], axis=1),
                         dtype=dtype, device=device)
    q0 = torch.tensor([1.0, 0, 0, 0], dtype=dtype,
                      device=device).repeat(n_lub, 1)
    p1, _, aux = lub.step_trapezoidal(sol, p0, q0, _gen(3, device), ft_calc,
                                      omega=25.0, cut_torque=0.2)
    return p1, (int(aux.det_iterations), int(aux.stoch_iterations))


def _path(mesh, which, n, dtype, device):
    if which == "rollers":
        return _roller_path(mesh, n, dtype, device)
    if which == "lubrication":
        return _lub_path(mesh, n, dtype, device)
    return _body_path(mesh, n, which, dtype, device)


def dryrun_rank(mesh, payload):
    """One rank of dryrun_multichip: every path under the mesh, and on
    rank 0 its single-rank twin, held to payload["tol"]."""
    n, tol = payload["n_ranks"], payload["tol"]
    dtype = getattr(torch, payload["dtype"])
    out = {}
    for which in payload.get("paths", PATHS):
        t0 = time.perf_counter()
        x, its = _path(mesh, which, n, dtype, mesh.device)
        t_mesh = time.perf_counter() - t0
        if mesh.rank != 0:
            continue
        t0 = time.perf_counter()
        x1, its1 = _path(None, which, n, dtype, mesh.device)
        t_single = time.perf_counter() - t0
        rel = _rel(x.cpu().numpy(), x1.cpu().numpy())
        if not (np.all(np.isfinite(x.cpu().numpy())) and rel <= tol):
            raise AssertionError(f"{which}: sharded vs single-rank mismatch "
                                 f"rel={rel:.3e} (tol {tol:g})")
        out[which] = dict(rel=rel, counts=its, counts_single=its1,
                          s=t_mesh, s_single=t_single,
                          pos=x.cpu().numpy(), pos_single=x1.cpu().numpy())
    # the twins (mesh=None) launch no rank-share instance
    return dict(paths=out, share_launches=share_launches(),
                counts={k: list(v) for k, v in mesh_mod.COUNTS.items()})


def dryrun_multichip(n_ranks, device=None, *, dtype="float32", tol=5e-5,
                     paths=PATHS, run_s=900.0, workdir=None):
    """Run the five paths on n_ranks gloo ranks on `device` (default the
    card), each against its single-rank twin (the module's docstring);
    raises when a path disagrees or a rank fails, else returns rank 0's
    results: {"paths": per path, "share_launches", "counts"}."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: dryrun_multichip runs on the "
                               "card unless the caller passes device='cpu'")
        device = "cuda:0"
    return spawn(int(n_ranks), "rigidmultiblobswall_tpu_torch.parallel."
                 "dryrun:dryrun_rank",
                 dict(n_ranks=int(n_ranks), tol=float(tol), dtype=dtype,
                      paths=tuple(paths)),
                 backend="gloo", device=str(device), run_s=run_s,
                 workdir=workdir)


# ---------------------------------------------------------------------------
# Sharded products on numpy inputs
# ---------------------------------------------------------------------------


def _t(x, device, dtype=None):
    return None if x is None else torch.as_tensor(
        np.asarray(x), device=device, dtype=dtype).contiguous()


def _product(mesh, case, device):
    """A closure computing the product of `case` (the tensors made once)."""
    from ..ops import ewald, ewald_wall
    from ..ops import mobility as mob

    kind = case["kind"]
    if kind in ("pairwise", "grand"):
        r = _t(case["r"], device)
        kw = dict(domain=case.get("domain", "single_wall"),
                  periodic_length=tuple(case.get("periodic_length",
                                                 (0.0, 0.0, 0.0))),
                  mesh=mesh)
        if kind == "grand":
            f, tq = _t(case["f"], device), _t(case["t"], device)
            return lambda: torch.cat(mob.grand_mobility_matvec(
                r, f, tq, case["eta"], case["a"], **kw), dim=1)
        r_tgt, v = _t(case.get("r_tgt"), device), _t(case["v"], device)
        return lambda: mob.pairwise_matvec_multi(
            r, r_tgt, v, case["eta"], case["a"],
            coupling=case.get("coupling", "tt"),
            self_interaction=case.get("self_interaction", True), **kw)
    pos, f = _t(case["pos"], device), _t(case["f"], device)
    if kind == "spectral":
        params = ewald.default_params(**case["params"])
        group_of = _t(case.get("group_of"), device)
        plan = ewald.make_plan(params, pos, group_of=group_of)
        mod = ewald
    elif kind == "wall":
        params = ewald_wall.default_wall_params(**case["params"])
        plan = ewald_wall.make_wall_plan(params, pos)
        mod = ewald_wall
    else:
        raise ValueError(f"unknown product kind {kind!r}")
    if f.ndim == 3:
        return lambda: mod.matvec_multi(plan, f, mesh=mesh)
    return lambda: mod.matvec(plan, f, mesh=mesh)


def share_launches():
    """This process's launches of the kernels' rank-share instances: K1's
    by (instance, B, sweep), K6's, K7's and P2's by name, G1's and G2's on
    the rank's x planes by instance."""
    from ..ops import cell_kernels, grid_kernels, pair_kernels

    out = {f"K1 {c} B={b} {s}": v
           for (c, b, s), v in pair_kernels.SHARE_LAUNCHES.items() if v}
    out.update({k: v for k, v in cell_kernels.SHARE_LAUNCHES.items() if v})
    out.update({k: v for k, v in grid_kernels.SHARE_LAUNCHES.items() if v})
    return out


def products(mesh, cases):
    """Run `cases` (dicts: kind "pairwise" (r, r_tgt or absent, v (B, N,
    3), eta, a, coupling, domain, periodic_length, self_interaction),
    "grand" (r, f, t, eta, a, domain, periodic_length), "spectral"
    (params: ewald.default_params' keywords, pos, f (N, 3) or (B, N, 3),
    group_of) or "wall" (params: ewald_wall.default_wall_params'
    keywords, pos, f)) under `mesh` (None: one device, `device` of the
    case, default the CPU). A case with reps > 0 is also timed: reps
    calls after one warm-up, ms a call. Returns per case {"out": numpy,
    "ms": float or None}, the collectives' counts, the rank-share
    launches and the products whose wave ran replicated. Also the target
    of a parallel/spawn.py run."""
    from ..ops import ewald, ewald_wall

    results = []
    for case in cases:
        device = (mesh.device if mesh is not None
                  else torch.device(case.get("device", "cpu")))
        fn = _product(mesh, case, device)
        out = fn()
        ms = None
        reps = int(case.get("reps", 0))
        if reps:
            sync = (torch.cuda.synchronize if device.type == "cuda"
                    else (lambda: None))
            sync()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            sync()
            ms = 1e3 * (time.perf_counter() - t0) / reps
        results.append(dict(out=out.cpu().numpy(), ms=ms))
    return dict(results=results,
                counts={k: list(v) for k, v in mesh_mod.COUNTS.items()},
                replicated_wave=dict(spectral=dict(ewald.REPLICATED_WAVE),
                                     wall=dict(ewald_wall.REPLICATED_WAVE)),
                share_launches=share_launches())



def skip_collective_rank(mesh, payload):
    """spawn target of the mismatch check: rank 0 enters an all_gather
    that rank 1 leaves out (rank 1 waits payload["wait_s"] and returns).
    Rank 0's collective must fail at the group's timeout, not hang."""
    if mesh.rank == 0:
        mesh_mod.all_gather_rows(mesh, torch.zeros((4, 3),
                                                   device=mesh.device))
        return "rank 0 passed a collective that rank 1 left out"
    time.sleep(float(payload["wait_s"]))
    return None
