"""Command-line entry point:
`python -m rigidmultiblobswall_tpu_torch.cli --input-file X.dat`.

Counterpart of rigidmultiblobswall_tpu/cli.py for the ported modes, with
the same input files and output formats:
  - scheme 'mobility': one static solve, writes .velocity.dat and
    .force.dat, and with plot_velocity_field (and tracer_radius) the
    .velocity_field.vtk of the solve's blob forces, with
    plot_concentration_field and a .Laplace file the
    .concentration_field.vtk (models/fields.py);
  - scheme 'resistance': the force-torques of prescribed body velocities
    (velocity_file, zero without one), .force.dat;
  - scheme 'body_mobility': the (6B, 6B) body mobility and the body slip
    mobility N K^T M^{-1}, .body_mobility.dat and .body_slip_mobility.dat,
    and with a .Laplace file (its normals and weights) the double-layer
    correction N K^T M^{-1} (I/2 + D), .body_slip_mobility_double_layer.dat;
  - the dynamic schemes of models/integrators.py (every multibody scheme
    of the JAX package, the articulated ones and the articulated rollers
    included): per-step .clones (or one .config file with save_clones
    one_file) for each structure, obstacle and articulated ID
    (`obstacle` entries stay at their prescribed, zero, velocity; an
    articulated ID's file holds its bodies in the clones file's order,
    instance by instance), .info (iteration and rejection counters) and
    .time; a phoretic run (.Laplace files) solves the Laplace BVP every
    step (kernel L1 on the card) and, with plot_concentration_field,
    writes .<step>.concentration_field.vtk with every saved frame;
    options save_blobs_mobility and save_body_mobility dump the dense
    blob and body mobilities with every saved frame; save_velocities
    writes every step's body velocities to .velocities.dat; update_PC > 1
    refactors the preconditioner every update_PC steps; call_HydroGrid
    True samples the blobs' two-species structure factors
    (utils/analysis.StructureFactor on cells and green_particles) every
    sample_HydroGrid steps and writes .structure_factors.dat every
    save_HydroGrid steps and at the end;
  - schemes 'body_mcmc' / 'MCMC': Metropolis-Hastings sampling
    (models/mcmc.py, the pair energy on kernel M1), adaptive burn-in for a
    negative initial_step, frames every n_save moves in .config
    (save_clones one_file) or .clones files, and .MCMC_info; scheme
    'body_mcmc_rejection': the rejection sampler (option n_estimate), the
    accepted proposals in .config and .MCMC_info;
  - the roller schemes (`*_rollers`, models/rollers.py; the reference's
    main_rollers.py): options free_kinematics, omega_one_roller and
    hydro_interactions, .clones every n_save steps and .info with the
    invalid-configuration, deterministic and stochastic iteration, and
    wall-overlap counters;
  - the lubrication schemes (models/lubrication.py, the reference's
    Lubrication_Examples scripts, e.g. Uniform_Rollers; a `lubrication*`
    scheme whose name holds "euler" takes the Euler-Maruyama step, any
    other the stochastic trapezoidal one): single spheres of radius
    blob_radius, options omega and cut_torque (trapezoidal only),
    Lub_Cut or lub_cutoff, lub_cutoff_wall, max_neighbors, firm_delta,
    repulsion_strength_firm and lubrication_tables_dir; .clones every
    n_save steps and .info with the wall and jump rejection and the
    iteration counters; a periodic_length runs the pseudo-periodic image
    boxes.
Every run also writes .inputfile, .git (the package's commit, from `git
rev-parse HEAD`; empty outside a git checkout, absent where git cannot
run) and .bodies_info. Runs on the card in
float32 by default (`--f64` for float64) and raises without CUDA;
`--device cpu` runs the plain PyTorch versions of the kernels. Dynamic
runs size the spectral engine's cell capacity (single_wall_spectral: after
its slab height, saddle.auto_wall_height) and the linked-cell force
capacity at the start, as the JAX CLI does, and report steps that still
dropped particles, or clipped them at the wall slab's top, in .info
(capacity_overflow_steps).

A user_defined_functions.py in the working directory, or else in the
input file's directory, may define torch hooks on the port's System and
State, called where the JAX CLI calls its own:
  blob_force_fn(system, state, r_blobs) -> (N, 3) extra blob forces,
  body_force_torque_fn(system, state, r_blobs) -> (B, 6) extra body forces
    and torques (it replaces the built-in body-body Yukawa force),
  slip_fn(system, state) -> (N, 3) slip added to the active slip,
  preprocess(system, state, step) -> State and postprocess(system, state,
    step) -> State around each step of a dynamic run.
A file written for the JAX package (it imports jax) or for the reference
ends the run with a pointer to these signatures.

A dynamic run writes <output>.random_state at its end, the state of every
generator it draws from: the run's noise generator (on its device) and
torch's default generators of the CPU and, on the card, of the device,
which user hooks may draw from. An input with `random_state <file>`
restores them at the start, before the first draw, so a run stopped and
restarted from its .clones and .random_state draws what one uninterrupted
run draws. The file is text, a header line naming the port and its
generators, then one line a generator (its role, its device, the length
of its state and the state's bytes); a file of the JAX CLI (the uint32
words of a JAX PRNG key) or one of other generators is refused: the port's
generators are torch's, so neither CLI can take the other's state.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from .io import input_file as input_mod, scene
from .models import integrators, kinematics as kin, lubrication as lub
from .models import fields, mcmc, phoretic, rollers, saddle, solvers
from .models.system import resolve_device
from .ops import forces as force_ops
from .ops import stokes_layers
from .utils.analysis import StructureFactor


HOOK_SIGNATURES = (
    "the PyTorch port's hooks are torch functions of its System and State: "
    "blob_force_fn(system, state, r_blobs) -> (N, 3), "
    "body_force_torque_fn(system, state, r_blobs) -> (B, 6), "
    "slip_fn(system, state) -> (N, 3), and preprocess / postprocess("
    "system, state, step) -> State (see the docstring of "
    "rigidmultiblobswall_tpu_torch/cli.py)")
# modules whose import marks a hook file written for another package: the
# JAX package's (kept from loading here even where they are installed), or
# the reference's hook API
_JAX_MODULES = ("jax", "jaxlib", "rigidmultiblobswall_tpu")
_FOREIGN_MODULES = _JAX_MODULES + ("multi_bodies_functions", "numexpr",
                                   "pycuda", "body", "mobility")


def load_user_functions(system, input_file):
    """The user_defined_functions.py of the working directory, or else of
    the input file's directory, loaded as the JAX CLI loads it: its
    blob_force_fn, body_force_torque_fn and slip_fn go onto the System (a
    body_force_torque_fn turns the body-body Yukawa force off, as the
    reference's override replaces it). Returns (system, module or None).
    A file that imports jax, the JAX package or the reference's modules
    ends in SystemExit with the port's hook signatures."""
    import importlib.util

    for udf_dir in (os.getcwd(), os.path.dirname(os.path.abspath(input_file))):
        udf = os.path.join(udf_dir, "user_defined_functions.py")
        if not os.path.isfile(udf):
            continue
        spec = importlib.util.spec_from_file_location(
            "user_defined_functions", udf)
        module = importlib.util.module_from_spec(spec)
        # a JAX module already imported in this process (the tests import
        # the JAX package), or any of its submodules, must fail to import
        # here as well
        blocked = {name: sys.modules.get(name) for name in list(sys.modules)
                   if name.split(".")[0] in _JAX_MODULES}
        blocked.update({name: None for name in _JAX_MODULES
                        if name not in blocked})
        try:
            for name in blocked:
                sys.modules[name] = None
            spec.loader.exec_module(module)
        except ImportError as e:
            if e.name is not None and e.name.split(".")[0] in _FOREIGN_MODULES:
                raise SystemExit(
                    f"error: could not load {udf}: it imports {e.name}, "
                    f"which the PyTorch port does not run; {HOOK_SIGNATURES}")
            raise SystemExit(f"error: could not load {udf}: {e}")
        finally:
            for name, mod in blocked.items():
                if mod is None:
                    sys.modules.pop(name, None)
                else:
                    sys.modules[name] = mod
        sys.modules[spec.name] = module
        hooks = {name: getattr(module, name)
                 for name in ("blob_force_fn", "body_force_torque_fn",
                              "slip_fn") if hasattr(module, name)}
        if "body_force_torque_fn" in hooks:
            hooks["body_body_force_method"] = "none"
        if hooks:
            system = dataclasses.replace(system, **hooks)
        print("Loaded user_defined_functions from", udf)
        return system, module
    return system, None


def _write_git_commit(path):
    """Stamp the package's git commit (`git rev-parse HEAD` run in this
    package's directory; empty outside a checkout) into `path`, for
    provenance, as the JAX CLI and the reference's multi_bodies.py do;
    every failure is ignored."""
    try:
        commit = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True,
            cwd=os.path.dirname(os.path.abspath(__file__))).stdout.decode()
        with open(path, "w") as f:
            f.write(commit)
    except Exception:
        pass


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Rigid multiblob dynamics, PyTorch + CUDA port")
    parser.add_argument("--input-file", dest="input_file", type=str,
                        default="data.main")
    parser.add_argument("--print-residual", action="store_true")
    parser.add_argument("--f64", action="store_true",
                        help="run in float64 (default float32)")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the "
                             "plain PyTorch versions of the kernels)")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    dtype = torch.float64 if args.f64 else torch.float32

    cfg = input_mod.read_input(args.input_file)
    shutil.copyfile(args.input_file, cfg.output_name + ".inputfile")
    _write_git_commit(cfg.output_name + ".git")
    # scene-file paths resolve relative to the input file's directory
    system, state = input_mod.build_system(
        cfg, base_dir=os.path.dirname(os.path.abspath(args.input_file)),
        dtype=dtype, device=device)
    system, user_mod = load_user_functions(system, args.input_file)

    with open(cfg.output_name + ".bodies_info", "w") as f:
        f.write("num_of_body_types  %d\n" % len(system.types))
        f.write("body_names         %s\n" % [t.name for t in system.types])
        f.write("body_types         %s\n" % [t.count for t in system.types])
        f.write("num_bodies         %d\n" % system.num_bodies)
        f.write("num_blobs          %d\n" % system.num_blobs)

    start_time = time.time()
    if cfg.scheme == "mobility":
        force_torque = None
        if cfg.force_file is not None:
            force_torque = torch.as_tensor(
                np.loadtxt(cfg.force_file).reshape(system.num_bodies, 6),
                dtype=dtype, device=device)
        sol = solvers.solve_mobility_problem(
            system, state, force_torque=force_torque,
            verbose=args.print_residual)
        np.savetxt(cfg.output_name + ".velocity.dat",
                   sol.velocities.cpu().numpy().reshape(-1, 6),
                   delimiter="  ")
        force = kin.KT_mul(system, state, sol.lam).cpu().numpy()
        np.savetxt(cfg.output_name + ".force.dat", force, delimiter="  ")
        print("Time to solve mobility problem =", time.time() - start_time)
        if cfg.plot_velocity_field is not None:
            fields.plot_velocity_field_to_vtk(
                cfg.plot_velocity_field, system, state, sol.lam,
                cfg.output_name, tracer_radius=cfg.tracer_radius)
        if (cfg.plot_concentration_field is not None
                and cfg.phoretic_cfg is not None):
            fields.plot_concentration_field_to_vtk(
                cfg.plot_concentration_field, system, state,
                cfg.phoretic_cfg, cfg.output_name)
    elif cfg.scheme == "resistance":
        velocity = np.zeros((system.num_bodies, 6))
        if cfg.velocity_file is not None:
            velocity = np.loadtxt(cfg.velocity_file).reshape(
                system.num_bodies, 6)
        force = solvers.solve_resistance(
            system, state, torch.as_tensor(velocity, dtype=dtype,
                                           device=device))
        np.savetxt(cfg.output_name + ".force.dat", force.cpu().numpy(),
                   delimiter="  ")
        print("Time to solve resistance problem =", time.time() - start_time)
    elif cfg.scheme == "body_mobility":
        N = solvers.solve_body_mobility(system, state)
        np.savetxt(cfg.output_name + ".body_mobility.dat", N.cpu().numpy(),
                   delimiter="  ")
        # slip mobility N K^T M^{-1}
        M = solvers.dense_blob_mobility(system, state)
        K = solvers._dense_K(system, state)
        slip_mob = N @ K.T @ torch.linalg.inv(M)
        np.savetxt(cfg.output_name + ".body_slip_mobility.dat",
                   slip_mob.cpu().numpy(), delimiter="  ")
        if cfg.phoretic_cfg is not None:
            # the double-layer slip correction of a .Laplace file's normals
            # and weights
            pcfg = cfg.phoretic_cfg
            r_blobs = kin.blob_positions(system, state)
            normals = phoretic.lab_normals(system, state, pcfg.chemistry)
            weights = phoretic._gather(system, pcfg.chemistry, "weights",
                                       r_blobs.dtype, r_blobs.device)
            D = stokes_layers.double_layer_dense(r_blobs, r_blobs, normals,
                                                 weights)
            I2pD = 0.5 * torch.eye(D.shape[0], dtype=D.dtype,
                                   device=D.device) + D
            np.savetxt(cfg.output_name
                       + ".body_slip_mobility_double_layer.dat",
                       (slip_mob @ I2pD).cpu().numpy(), delimiter="  ")
        print("Time to compute body mobility =", time.time() - start_time)
    elif cfg.scheme in ("body_mcmc", "MCMC"):
        _run_mcmc(cfg, system, state)
    elif cfg.scheme == "body_mcmc_rejection":
        _run_rejection(cfg, system, state)
    elif cfg.scheme.startswith("lubrication"):
        _run_lubrication(cfg, system, state, args)
    elif (cfg.scheme.endswith("_rollers")
          and not cfg.scheme.startswith("articulated_")):
        _run_rollers(cfg, system, state)
    else:
        _run_dynamic(cfg, system, state, args, start_time, user_mod)

    with open(cfg.output_name + ".time", "w") as f:
        f.write(str(time.time() - start_time) + "\n")
    print("\n\n\n# End")


def _generator(cfg, state):
    """The noise generator, seeded from the input file, on the state's
    device: every draw happens where the simulation runs (on the card,
    the spectral grid noise alone is 3 x 256^3 normals a step)."""
    return torch.Generator(device=state.pos.device).manual_seed(
        cfg.seed if cfg.seed is not None else 0)


RANDOM_STATE_HEADER = ("# rigidmultiblobswall_tpu_torch random_state v1: "
                       "torch.Generator states, one a line: role device "
                       "n_bytes bytes")


def _run_generators(generator):
    """{role: generator} of a dynamic run: its noise generator and torch's
    default generators of the CPU and, for a run on the card, of its
    device."""
    gens = {"run": generator, "torch_cpu": torch.default_generator}
    if generator.device.type == "cuda":
        index = generator.device.index
        gens["torch_cuda"] = torch.cuda.default_generators[
            torch.cuda.current_device() if index is None else index]
    return gens


def write_random_state(path, generator):
    """Write the states of the run's generators (_run_generators) to
    path, as text."""
    lines = [RANDOM_STATE_HEADER]
    for role, gen in _run_generators(generator).items():
        b = gen.get_state().tolist()
        lines.append(f"{role} {gen.device} {len(b)} "
                     + " ".join(map(str, b)))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def read_random_state(path, generator):
    """Restore the run's generators (_run_generators) from a file of
    write_random_state; a file of another kind (the JAX CLI's key words),
    of other generators or devices, or of a wrong length raises
    ValueError and restores nothing."""
    with open(path) as f:
        lines = f.read().splitlines()
    if not lines or lines[0] != RANDOM_STATE_HEADER:
        raise ValueError(
            f"random_state {path}: not a .random_state file of the PyTorch "
            f"port (its first line must be {RANDOM_STATE_HEADER!r}); a file "
            "of the JAX CLI holds a JAX PRNG key, which torch's generators "
            "cannot take")
    gens = _run_generators(generator)
    states = {}
    for line in lines[1:]:
        words = line.split()
        if len(words) < 3 or not words[2].isdigit():
            raise ValueError(f"random_state {path}: malformed line "
                             f"{line[:60]!r}")
        role, device, n = words[0], words[1], int(words[2])
        if role not in gens or str(gens[role].device) != device:
            raise ValueError(
                f"random_state {path}: generator {role} on {device}; this "
                "run draws from " + ", ".join(
                    f"{r} on {g.device}" for r, g in gens.items()))
        want = gens[role].get_state().numel()
        if n != want or len(words) != 3 + n:
            raise ValueError(
                f"random_state {path}: generator {role} holds "
                f"{len(words) - 3} bytes (header {n}); its state is {want}")
        states[role] = torch.tensor([int(x) for x in words[3:]],
                                    dtype=torch.uint8)
    if set(states) != set(gens):
        raise ValueError(f"random_state {path}: generators {sorted(states)}; "
                         f"this run draws from {sorted(gens)}")
    for role, st in states.items():
        gens[role].set_state(st)


def _write_config_frame(f, pos, quat):
    """One frame of a .config file: the body count, then x y z and the
    quaternion of each body."""
    f.write("%d\n" % len(pos))
    for x, q in zip(pos, quat):
        f.write("%s %s %s %s %s %s %s\n" % (
            x[0], x[1], x[2], q[0], q[1], q[2], q[3]))


def _run_mcmc(cfg, system, state):
    """Metropolis-Hastings sampling (the JAX CLI's body_mcmc / MCMC
    branch): a negative initial_step runs adaptive burn-in; frames every
    n_save moves into .<type>.config (save_clones one_file) or
    .<type>.<step>.clones, and .MCMC_info."""
    mc, traj, energies = mcmc.run_mcmc(
        system, state, _generator(cfg, state), n_steps=cfg.n_steps,
        save_every=cfg.n_save, initial_step=min(cfg.initial_step, 0))
    pos, quat = traj.pos.cpu().numpy(), traj.quat.cpu().numpy()
    offs = system.body_offsets
    for s_idx in range(energies.shape[0]):
        for i, t in enumerate(system.types):
            pos_i = pos[s_idx, offs[i]:offs[i + 1]]
            quat_i = quat[s_idx, offs[i]:offs[i + 1]]
            if cfg.save_clones == "one_file":
                name = "%s.%s.config" % (cfg.output_name, t.name)
                with open(name, "w" if s_idx == 0 else "a") as f:
                    _write_config_frame(f, pos_i, quat_i)
            else:
                scene.write_clones_file(
                    "%s.%s.%08d.clones" % (cfg.output_name, t.name,
                                           s_idx * cfg.n_save),
                    pos_i, quat_i)
    n_total = cfg.n_steps - min(cfg.initial_step, 0)
    with open(cfg.output_name + ".MCMC_info", "w") as f:
        f.write("acceptance ratio = %s\n"
                % (int(mc.accepted) / max(n_total, 1)))
        f.write("accepted_moves = %d\n" % int(mc.accepted))
        f.write("final max_translation = %s\n" % float(mc.max_translation))
        f.write("final energy = %s\n" % float(mc.energy))


def _run_rejection(cfg, system, state):
    """The independent-sample rejection sampler (the JAX CLI's
    body_mcmc_rejection branch): the accepted proposals into
    .<type>.config, and .MCMC_info. Option n_estimate, default
    max(n_steps // 100, 100000)."""
    n_estimate = int(cfg.options.get(
        "n_estimate", max(cfg.n_steps // 100, 100000)))
    res = mcmc.run_rejection_sampler(
        system, _generator(cfg, state), n_steps=cfg.n_steps,
        n_estimate=n_estimate, dtype=state.pos.dtype,
        device=state.pos.device)
    accepted = res.accepted.cpu().numpy()
    pos = res.states.pos.cpu().numpy()
    quat = res.states.quat.cpu().numpy()
    offs = system.body_offsets
    for i, t in enumerate(system.types):
        with open("%s.%s.config" % (cfg.output_name, t.name), "w") as f:
            for s_idx in np.nonzero(accepted)[0]:
                _write_config_frame(f, pos[s_idx, offs[i]:offs[i + 1]],
                                    quat[s_idx, offs[i]:offs[i + 1]])
    with open(cfg.output_name + ".MCMC_info", "w") as f:
        f.write("acceptance ratio = %s\n"
                % (accepted.sum() / max(cfg.n_steps, 1)))
        f.write("accepted_moves = %d\n" % accepted.sum())
        f.write("minimum_energy = %s\n" % float(res.minimum_energy))


def _run_rollers(cfg, system, state):
    """Minimally-resolved rollers: one single-blob body per roller."""
    opts = cfg.options
    sus = rollers.RollerSuspension(
        num_rollers=system.num_bodies, eta=cfg.eta,
        blob_radius=cfg.blob_radius, kT=cfg.kT, g=cfg.g, domain=cfg.domain,
        periodic_length=tuple(cfg.periodic_length),
        repulsion_strength=cfg.repulsion_strength,
        debye_length=cfg.debye_length,
        repulsion_strength_wall=cfg.repulsion_strength_wall,
        debye_length_wall=cfg.debye_length_wall,
        solver_tolerance=cfg.solver_tolerance, rf_delta=cfg.rf_delta,
        free_kinematics=opts.get("free_kinematics", "True") == "True",
        omega_one_roller=tuple(
            float(x) for x in opts.get("omega_one_roller", "0 0 0").split()),
        hydro_interactions=bool(int(opts.get("hydro_interactions", 1))))
    generator = _generator(cfg, state)
    step = rollers.make_stepper(sus, cfg.scheme, cfg.dt)
    positions = state.pos
    carry = rollers.init_carry(sus, positions=positions)
    name = system.types[0].name
    quat0 = state.quat.cpu().numpy()

    def save(step_idx):
        scene.write_clones_file(
            "%s.%s.%08d.clones" % (cfg.output_name, name, step_idx),
            positions.cpu().numpy(), quat0)

    det_iters = stoch_iters = rejections = overlaps = 0
    for step_idx in range(cfg.initial_step, cfg.n_steps):
        if step_idx % cfg.n_save == 0:
            save(step_idx)
        positions, carry, aux = step(positions, generator, carry)
        det_iters += aux.det_iterations
        stoch_iters += aux.stoch_iterations
        rejections += aux.rejections
        overlaps += aux.wall_overlaps
    save(cfg.n_steps)
    with open(cfg.output_name + ".info", "w") as f:
        f.write("invalid_configuration_count      %d\n" % rejections)
        f.write("deterministic_iterations_count   %d\n" % det_iters)
        f.write("stochastic_iterations_count      %d\n" % stoch_iters)
        f.write("wall_overlaps                    %d\n" % overlaps)


def _run_lubrication(cfg, system, state, args):
    """Lubrication-corrected spheres (the JAX CLI's lubrication branch):
    bodies are single spheres of radius blob_radius."""
    opts = cfg.options
    tables = lub.LubricationTables.load(opts.get("lubrication_tables_dir"))
    max_nb = opts.get("max_neighbors")
    # the reference's option name is Lub_Cut (read_input.py:96, default
    # 4.5); lub_cutoff[_wall] are the JAX CLI's aliases
    lub_cut = float(opts.get("Lub_Cut", opts.get("lub_cutoff", 4.5)))
    firm_delta = float(opts.get("firm_delta", 1e-2))
    sol = lub.LubSolver(
        num_bodies=system.num_bodies, eta=cfg.eta, a=cfg.blob_radius,
        kT=cfg.kT, dt=cfg.dt, cutoff=lub_cut,
        cutoff_wall=float(opts.get("lub_cutoff_wall", lub_cut)),
        debye_cut=firm_delta, rf_delta=cfg.rf_delta,
        periodic_length=tuple(cfg.periodic_length),
        solver_tolerance=cfg.solver_tolerance,
        max_neighbors=int(max_nb) if max_nb is not None else None,
        tables=tables, device=state.pos.device)
    omega = float(opts["omega"]) if "omega" in opts else None
    cut_torque = (float(opts["cut_torque"]) if "cut_torque" in opts
                  else None)
    ft_calc = lub.make_ft_calc(
        a=cfg.blob_radius, g=cfg.g,
        repulsion_strength=cfg.repulsion_strength,
        debye_length=cfg.debye_length,
        repulsion_strength_wall=cfg.repulsion_strength_wall,
        debye_length_wall=cfg.debye_length_wall,
        repulsion_strength_firm=float(opts.get("repulsion_strength_firm",
                                               0.0)),
        firm_delta=firm_delta, periodic_length=tuple(cfg.periodic_length))
    if "euler" in cfg.scheme:
        def step(pos, quats, generator):
            return lub.step_euler_maruyama(sol, pos, quats, generator,
                                           ft_calc)
    else:
        def step(pos, quats, generator):
            return lub.step_trapezoidal(sol, pos, quats, generator, ft_calc,
                                        omega=omega, cut_torque=cut_torque)

    generator = _generator(cfg, state)
    pos, quats = state.pos, state.quat
    name = system.types[0].name

    def save(step_idx):
        scene.write_clones_file(
            "%s.%s.%08d.clones" % (cfg.output_name, name, step_idx),
            pos.cpu().numpy(), quats.cpu().numpy())

    det_iters = stoch_iters = rej_wall = rej_jump = 0
    for step_idx in range(cfg.initial_step, cfg.n_steps):
        if (step_idx % cfg.n_save) == 0 and step_idx >= 0:
            save(step_idx)
        pos, quats, aux = step(pos, quats, generator)
        det_iters += aux.det_iterations
        stoch_iters += aux.stoch_iterations
        rej_wall += int(aux.rejections_wall)
        rej_jump += int(aux.rejections_jump)
        overflow = int(aux.neighbor_overflow)
        if overflow > 0:
            print("WARNING: step %d dropped %d neighbors past max_neighbors"
                  % (step_idx, overflow), file=sys.stderr)
        if args.print_residual:
            print("lubrication step %d: gmres its %d, lanczos its %d"
                  % (step_idx, aux.det_iterations, aux.stoch_iterations))
    save(cfg.n_steps)
    with open(cfg.output_name + ".info", "w") as f:
        f.write("num_rejections_wall              %d\n" % rej_wall)
        f.write("num_rejections_jump              %d\n" % rej_jump)
        f.write("deterministic_iterations_count   %d\n" % det_iters)
        f.write("stochastic_iterations_count      %d\n" % stoch_iters)


def _run_dynamic(cfg, system, state, args, start_time, user_mod=None):
    generator = _generator(cfg, state)
    if cfg.random_state is not None:
        read_random_state(cfg.random_state, generator)
    # the wall slab's height and the fixed capacities sized from the
    # initial configuration (no-ops for the pairwise engine and the direct
    # forces)
    system = saddle.auto_spectral_capacities(system, state, log=print)
    system = force_ops.auto_force_cell_capacity(
        system, kin.blob_positions(system, state), log=print)
    gmres_maxiter = 1000
    step = integrators.make_stepper(system, cfg.scheme, cfg.dt,
                                    tolerance=cfg.solver_tolerance,
                                    gmres_maxiter=gmres_maxiter,
                                    update_PC=cfg.update_PC,
                                    verbose=args.print_residual)
    carry = (integrators.init_carry_with_pc(system, state)
             if cfg.update_PC > 1
             else integrators.init_carry(system, state=state))

    def save_mobilities(step_idx, state):
        """The dense blob and body mobilities of a saved frame."""
        want_blobs = cfg.options.get("save_blobs_mobility") == "True"
        want_body = cfg.options.get("save_body_mobility") == "True"
        if not (want_blobs or want_body):
            return
        M = solvers.dense_blob_mobility(system, state)
        if want_blobs:
            np.savetxt("%s.blobs_mobility.%08d.dat" % (cfg.output_name,
                                                       step_idx),
                       M.cpu().numpy(), delimiter="  ")
        if want_body:
            K = solvers._dense_K(system, state)
            N = torch.linalg.pinv(K.T @ torch.linalg.inv(M) @ K)
            np.savetxt("%s.body_mobility.%08d.dat" % (cfg.output_name,
                                                      step_idx),
                       N.cpu().numpy(), delimiter="  ")

    # articulated groups are stored type-major (sub-body j of every
    # instance is one type); their files hold one ID's bodies in the
    # clones file's order, instance-major, as the JAX CLI writes them
    art_sub_types = {i for art in system.articulated
                     for i in art.sub_type_indices}

    def frames(state):
        offs = system.body_offsets
        pos = state.pos.cpu().numpy()
        quat = state.quat.cpu().numpy()
        for i, t in enumerate(system.types):
            if i not in art_sub_types:
                sl = slice(offs[i], offs[i + 1])
                yield t.name, pos[sl], quat[sl]
        for art in system.articulated:
            p = np.stack([pos[offs[i]:offs[i + 1]]
                          for i in art.sub_type_indices], axis=1)
            q = np.stack([quat[offs[i]:offs[i + 1]]
                          for i in art.sub_type_indices], axis=1)
            yield art.name, p.reshape(-1, 3), q.reshape(-1, 4)

    def save_clones(step_idx, state):
        for name_i, pos_i, quat_i in frames(state):
            if cfg.save_clones == "one_file":
                name = "%s.%s.config" % (cfg.output_name, name_i)
                mode = "w" if step_idx == cfg.initial_step else "a"
                with open(name, mode) as f:
                    _write_config_frame(f, pos_i, quat_i)
            else:
                scene.write_clones_file(
                    "%s.%s.%08d.clones" % (cfg.output_name, name_i, step_idx),
                    pos_i, quat_i)

    def save_concentration_field(step_idx, state):
        """The off-surface concentration of a phoretic run's saved frame."""
        if (cfg.plot_concentration_field is not None
                and cfg.phoretic_cfg is not None):
            fields.plot_concentration_field_to_vtk(
                cfg.plot_concentration_field, system, state,
                cfg.phoretic_cfg, cfg.output_name,
                suffix=".%08d" % step_idx)

    # the structure factors of the call_HydroGrid option (the reference's
    # HydroGrid coupling, read_input.py:86-93 option names)
    sk = None
    if cfg.options.get("call_HydroGrid", "False") == "True":
        cells = [int(x) for x in cfg.options.get("cells", "1 1").split()]
        green = [int(x) for x in
                 cfg.options.get("green_particles", "0 0").split()]
        sk = StructureFactor(system.periodic_length[0],
                             system.periodic_length[1], cells, green,
                             system.num_blobs)
    sk_sample = int(cfg.options.get("sample_HydroGrid", 1))
    sk_save = int(cfg.options.get("save_HydroGrid", 0))
    sk_name = cfg.output_name + ".structure_factors.dat"

    det_iters = stoch_iters = rejections = unconverged_steps = 0
    overflow_steps = 0
    save_velocities = cfg.options.get("save_velocities", "False") == "True"
    velocities_log = []
    for step_idx in range(cfg.initial_step, cfg.n_steps):
        if (step_idx % cfg.n_save) == 0 and step_idx >= 0:
            print("Integrator = %s, step = %d, wallclock = %.2fs" % (
                cfg.scheme, step_idx, time.time() - start_time))
            save_clones(step_idx, state)
            save_concentration_field(step_idx, state)
            save_mobilities(step_idx, state)
        if sk is not None and (step_idx % sk_sample) == 0:
            sk.sample(kin.blob_positions(system, state).cpu().numpy())
            if sk_save > 0 and step_idx > 0 and step_idx % sk_save == 0:
                sk.save(sk_name)
        if user_mod is not None and hasattr(user_mod, "preprocess"):
            state = user_mod.preprocess(system, state, step_idx)
        state, carry, aux = step(state, generator, carry)
        if user_mod is not None and hasattr(user_mod, "postprocess"):
            state = user_mod.postprocess(system, state, step_idx)
        det_iters += aux.det_iterations
        stoch_iters += aux.stoch_iterations
        rejections += aux.rejections
        if not aux.solves_converged:
            unconverged_steps += 1
            print("WARNING: step %d had a GMRES solve stop before "
                  "tolerance (maxiter=%d)" % (step_idx, gmres_maxiter),
                  file=sys.stderr)
        if aux.capacity_overflows > 0:
            overflow_steps += 1
            print("WARNING: step %d dropped %d entries from fixed-"
                  "capacity layouts (grow spectral_cell_capacity or "
                  "blob_blob_cell_capacity)"
                  % (step_idx, aux.capacity_overflows), file=sys.stderr)
        if save_velocities:
            velocities_log.append(aux.velocities.cpu().numpy())
    save_clones(cfg.n_steps, state)
    save_mobilities(cfg.n_steps, state)
    if sk is not None and sk.n_samples > 0:
        sk.save(sk_name)
    if velocities_log:
        np.savetxt(cfg.output_name + ".velocities.dat",
                   np.stack(velocities_log).reshape(len(velocities_log), -1))
    with open(cfg.output_name + ".info", "w") as f:
        f.write("invalid_configuration_count      %d\n" % rejections)
        f.write("deterministic_iterations_count   %d\n" % det_iters)
        f.write("stochastic_iterations_count      %d\n" % stoch_iters)
        f.write("unconverged_solve_steps          %d\n" % unconverged_steps)
        f.write("capacity_overflow_steps          %d\n" % overflow_steps)
    write_random_state(cfg.output_name + ".random_state", generator)


if __name__ == "__main__":
    main()
