"""Reference-compatible input-file parser and System construction.

Counterpart of rigidmultiblobswall_tpu/io/input_file.py: `read_input`
parses the whitespace-separated key-value format with '#' comments and
repeated structure entries; `build_system` builds the port's System and
initial State from the referenced .vertex/.clones files.

Domains: single_wall, no_wall, periodic_spectral and
single_wall_spectral (periodic_length Lx Ly 0; both spectral domains read
spectral_tolerance, spectral_grid_max and spectral_cell_capacity, and
the wall slab's height is sized at the start of a run,
saddle.auto_wall_height); a tree/neighbor blob_blob_force_implementation
selects the linked-cell forces. `save_velocities True` makes a dynamic
run write .velocities.dat (cli.py). The lubrication schemes' options
(omega, cut_torque, Lub_Cut or lub_cutoff, lub_cutoff_wall,
max_neighbors, firm_delta, repulsion_strength_firm and
lubrication_tables_dir) stay in `options`, read by the CLI's lubrication
branch as the JAX CLI reads them. `obstacle` entries become body types
with prescribed kinematics (zero velocity) after the free structures,
and a scheme the reference does not run with obstacles is refused with
the JAX package's ValueError. Not ported yet, and refused with
NotImplementedError rather than ignored: articulated bodies, .slip and
.Laplace files, per-blob radii and body-body forces (ROADMAP Queue 1,
items 4, 15 and 18), and the options random_state,
plot_velocity_field, plot_concentration_field, tracer_radius and
call_HydroGrid True (item 11; the fields with item 18's
models/fields.py), which `read_input` refuses.
"""

from __future__ import annotations

import dataclasses
import ntpath
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..models.system import BodyType, System, make_state, resolve_device
from . import scene


@dataclasses.dataclass
class InputConfig:
    options: dict
    structures: List[List[str]]          # [vertex, clones, (extras)]
    structures_ID: List[str]
    obstacles: List[List[str]]
    obstacles_ID: List[str]
    articulated: List[List[str]]

    # scalars with the reference defaults
    n_steps: int = 0
    initial_step: int = 0
    n_save: int = 1
    dt: float = 0.0
    eta: float = 1.0
    g: float = 1.0
    blob_radius: float = 1.0
    kT: float = 1.0
    scheme: str = "deterministic_forward_euler"
    output_name: str = "run"
    seed: Optional[int] = None
    repulsion_strength_wall: float = 1.0
    debye_length_wall: float = 1.0
    repulsion_strength: float = 1.0
    debye_length: float = 1.0
    solver_tolerance: float = 1e-8
    rf_delta: float = 1e-3
    periodic_length: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    update_PC: int = 1
    domain: str = "single_wall"
    save_clones: str = "one_file_per_step"
    force_file: Optional[str] = None
    velocity_file: Optional[str] = None


def read_input(path) -> InputConfig:
    options = {}
    structures, obstacles, articulated = [], [], []
    with open(path, "r") as f:
        for line in f:
            if "#" in line:
                line = line.split("#", 1)[0]
            line = line.strip()
            if not line:
                continue
            key, value = line.split(None, 1)
            if key == "structure":
                structures.append(value.split())
            elif key == "obstacle":
                obstacles.append(value.split())
            elif key == "articulated":
                articulated.append(value.split())
            else:
                options[key] = value

    def _id(files):
        tail = ntpath.split(files[1])[1]
        return tail[:-7] if tail.endswith(".clones") else tail

    _refuse_unported_options(options)
    cfg = InputConfig(options=options, structures=structures,
                      structures_ID=[_id(s) for s in structures],
                      obstacles=obstacles,
                      obstacles_ID=[_id(s) for s in obstacles],
                      articulated=articulated)
    g = options.get
    cfg.n_steps = int(g("n_steps") or 0)
    cfg.initial_step = int(g("initial_step") or 0)
    cfg.n_save = int(g("n_save") or 1)
    cfg.dt = float(g("dt") or 0.0)
    cfg.eta = float(g("eta") or 1.0)
    cfg.g = float(g("g") or 1.0)
    cfg.blob_radius = float(g("blob_radius") or 1.0)
    cfg.kT = float(g("kT") or 1.0)
    cfg.scheme = str(g("scheme") or "deterministic_forward_euler")
    cfg.output_name = str(g("output_name") or "run")
    cfg.seed = int(g("seed")) if g("seed") else None
    cfg.repulsion_strength_wall = float(g("repulsion_strength_wall") or 1.0)
    cfg.debye_length_wall = float(g("debye_length_wall") or 1.0)
    cfg.repulsion_strength = float(g("repulsion_strength") or 1.0)
    cfg.debye_length = float(g("debye_length") or 1.0)
    cfg.solver_tolerance = float(g("solver_tolerance") or 1e-8)
    cfg.rf_delta = float(g("rf_delta") or 1e-3)
    cfg.periodic_length = tuple(
        float(x) for x in (g("periodic_length") or "0 0 0").split())
    cfg.update_PC = int(g("update_PC") or 1)
    # the reference also encodes the domain in the kernel-implementation
    # names; honor that when no explicit domain option is given
    impl = " ".join([g("mobility_vector_prod_implementation") or "",
                     g("mobility_blobs_implementation") or ""])
    if g("domain"):
        cfg.domain = str(g("domain"))
    elif "free_surface" in impl:
        cfg.domain = "free_surface"
    elif "no_wall" in impl:
        cfg.domain = "no_wall"
    else:
        cfg.domain = "single_wall"
    cfg.save_clones = str(g("save_clones") or "one_file_per_step")
    cfg.force_file = g("force_file")
    cfg.velocity_file = g("velocity_file")

    # restart rewiring: start from the saved frame of initial_step
    if cfg.initial_step > 0:
        for k, struct in enumerate(cfg.structures):
            struct[1] = (f"{cfg.output_name}.{cfg.structures_ID[k]}."
                         f"{str(cfg.initial_step).zfill(8)}.clones")

    # schemes the reference does not run with obstacles
    if cfg.obstacles and cfg.scheme in _NO_OBSTACLE_SCHEMES:
        raise ValueError(
            f"Obstacles are not implemented for scheme: {cfg.scheme}")
    return cfg


_NO_OBSTACLE_SCHEMES = (
    "deterministic_forward_euler_dense_algebra",
    "stochastic_first_order_RFD",
    "stochastic_adams_bashforth",
    "stochastic_first_order_RFD_dense_algebra",
    "stochastic_traction_EM",
    "Fixman",
    "stochastic_traction_AB",
    "stochastic_Slip_Mid_DLA")


# options the JAX CLI acts on that the port does not support yet, and the
# ROADMAP item that ports each
_UNPORTED_OPTIONS = {
    "random_state": "the .random_state restart (ROADMAP Queue 1, item 11)",
    "plot_velocity_field": "vtk velocity fields (ROADMAP Queue 1, item 11, "
                           "with item 18's models/fields.py)",
    "plot_concentration_field": "vtk concentration fields (ROADMAP Queue 1, "
                                "item 11, with item 18's models/fields.py)",
    "tracer_radius": "the tracers of the vtk velocity field (ROADMAP Queue "
                     "1, item 11, with item 18's models/fields.py)",
}


def _refuse_unported_options(options):
    for key, what in _UNPORTED_OPTIONS.items():
        if key in options:
            raise NotImplementedError(
                f"input option {key!r}: {what} is not ported yet; the "
                "PyTorch port refuses it rather than ignore it")
    if options.get("call_HydroGrid", "False") == "True":
        raise NotImplementedError(
            "input option 'call_HydroGrid True': the structure factors are "
            "not ported yet (ROADMAP Queue 1, item 11); the PyTorch port "
            "refuses it rather than ignore it")


def build_system(cfg: InputConfig, base_dir=".", dtype=torch.float64,
                 device=None):
    """Build (System, State) from an InputConfig; each structure entry
    becomes one BodyType group, and then each obstacle entry one with
    prescribed kinematics. The State lies on `device` (default the
    card; device="cpu" runs on the CPU)."""
    device = resolve_device(device)
    if cfg.articulated:
        raise NotImplementedError("articulated bodies are not ported yet "
                                  "(ROADMAP Queue 1, item 18)")

    def _resolve(p):
        return p if os.path.isabs(p) else os.path.join(base_dir, p)

    types, locations, quaternions = [], [], []
    entries = ([(f, n, False) for f, n in zip(cfg.structures,
                                              cfg.structures_ID)]
               + [(f, n, True) for f, n in zip(cfg.obstacles,
                                               cfg.obstacles_ID)])
    for files, name, is_obstacle in entries:
        if files[2:]:
            raise NotImplementedError(
                f"structure {name}: extra files {files[2:]} (.slip/.Laplace) "
                "are not ported yet (ROADMAP Queue 1, item 18)")
        ref = scene.read_vertex_file(_resolve(files[0]))
        if ref.shape[1] == 4 and not np.allclose(ref[:, 3], cfg.blob_radius):
            raise NotImplementedError(
                f"structure {name}: per-blob radii are not ported yet "
                "(ROADMAP Queue 1, item 4)")
        nbod, loc, quat = scene.read_clones_file(_resolve(files[1]))
        types.append(BodyType(name=name, ref_config=ref[:, :3], count=nbod,
                              prescribed_kinematics=is_obstacle,
                              is_obstacle=is_obstacle))
        locations.append(loc)
        quaternions.append(quat)

    bb_impl = cfg.options.get("blob_blob_force_implementation", "None")
    if bb_impl == "None":
        bb_method = "none"
    elif "tree" in bb_impl or "neighbor" in bb_impl:
        # the reference's kd-tree backends map to the linked cells
        bb_method = "neighbor_list"
    else:
        bb_method = "direct"
    if cfg.options.get("body_body_force_torque_implementation",
                       "None") != "None":
        raise NotImplementedError("body-body forces are not ported yet "
                                  "(ROADMAP Queue 1, item 18)")

    system = System(
        types=tuple(types), eta=cfg.eta, blob_radius=cfg.blob_radius,
        kT=cfg.kT, g=cfg.g, domain=cfg.domain,
        periodic_length=tuple(cfg.periodic_length),
        spectral_tol=float(cfg.options.get("spectral_tolerance", 1e-4)),
        spectral_grid_max=int(cfg.options.get("spectral_grid_max", 256)),
        spectral_cell_capacity=int(
            cfg.options.get("spectral_cell_capacity", 0)),
        repulsion_strength=cfg.repulsion_strength,
        debye_length=cfg.debye_length,
        repulsion_strength_wall=cfg.repulsion_strength_wall,
        debye_length_wall=cfg.debye_length_wall,
        blob_blob_force_method=bb_method,
        solver_tolerance=cfg.solver_tolerance, rf_delta=cfg.rf_delta)
    state = make_state(np.concatenate(locations, axis=0),
                       np.concatenate(quaternions, axis=0), dtype=dtype,
                       device=device)
    return system, state
