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
the JAX package's ValueError. `articulated` entries (list_vertex clones
const [slip]) become one body type per sub-body after the obstacles,
stored type-major as the JAX package stores them (sub-body j of every
instance is one type), with their links and, where a .const line carries
twelve expressions in t, its time-dependent links (compile_links_fn);
.slip files on structure and articulated entries give the types an
active slip; the options nonlinear_solver_tolerance and
body_body_force_torque_implementation (any value but None turns the
body-body Yukawa force on) are read. A structure or obstacle entry's
.Laplace file gives its type a chemistry (models/phoretic.Chemistry);
with any, build_system sets the System's slip_fn to the phoretic slip
and the config's phoretic_cfg, with the options background_Laplace (at
most 9 values) and diffusion_coefficient. The options plot_velocity_field,
plot_concentration_field (9 values: x0 x1 nx y0 y1 ny z0 z1 nz) and
tracer_radius are read for the CLI's VTK fields (models/fields.py). Not
ported yet, and refused with NotImplementedError rather than ignored:
per-blob radii (ROADMAP Queue 1, items 4 and 15), a .Laplace file on an
articulated entry (the JAX package reads only its .slip), and the option
random_state (item 11), which `read_input` refuses. The options
call_HydroGrid, cells, green_particles, sample_HydroGrid and
save_HydroGrid stay in `options`, read by the CLI's dynamic loop.
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
    articulated_ID: List[str]

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
    tracer_radius: float = 0.0
    plot_velocity_field: Optional[np.ndarray] = None
    plot_concentration_field: Optional[np.ndarray] = None
    # phoretic coupling: the background concentration's 9 coefficients and
    # the diffusion coefficient Dc
    background_laplace: Optional[np.ndarray] = None
    diffusion_coefficient: float = 1.0
    # set by build_system when any structure carries a .Laplace file
    phoretic_cfg: object = None


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
                      articulated=articulated,
                      articulated_ID=[_id(s) for s in articulated])
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
    cfg.tracer_radius = float(g("tracer_radius") or 0.0)
    if g("plot_velocity_field"):
        cfg.plot_velocity_field = _floats(g("plot_velocity_field"))
    if g("plot_concentration_field"):
        cfg.plot_concentration_field = _floats(g("plot_concentration_field"))
    background = _floats(g("background_Laplace") or "")
    if background.size > 9:
        raise ValueError(
            "background_Laplace takes at most 9 values "
            f"(got {background.size}): constant, gradient (3), "
            "upper-triangular Hessian (5)")
    cfg.background_laplace = np.hstack([background,
                                        np.zeros(9 - background.size)])
    cfg.diffusion_coefficient = float(g("diffusion_coefficient") or 1.0)

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


def _floats(text):
    return np.array([float(x) for x in text.split()], dtype=np.float64)


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
}


def _refuse_unported_options(options):
    for key, what in _UNPORTED_OPTIONS.items():
        if key in options:
            raise NotImplementedError(
                f"input option {key!r}: {what} is not ported yet; the "
                "PyTorch port refuses it rather than ignore it")


# the names of the link expressions' math environment (the JAX
# package's, on numpy in place of jax.numpy, at a host float t)
_LINK_ENV = {name: getattr(np, name) for name in
             ("sin", "cos", "tan", "exp", "sqrt", "abs", "arctan2", "where")}
_LINK_ENV["pi"] = np.pi


def compile_links_fn(extra, links):
    """The time hook of a .const file's link expressions: extra holds,
    per constraint, its strings after the six links; a constraint with
    twelve (six link components and their six time derivatives, in t)
    follows them, one with fewer keeps its constant links. Returns
    links_fn(t) -> (links (nc, 6), deriv (nc, 6)) as float64 arrays,
    evaluated on the host float t."""
    compiled = [[compile(e, f"<link{k}>", "eval") for e in exprs[:12]]
                if len(exprs) >= 12 else None
                for k, exprs in enumerate(extra)]
    links = np.asarray(links, np.float64).reshape(-1, 6)

    def links_fn(t):
        out_l, out_d = links.copy(), np.zeros_like(links)
        for k, exprs in enumerate(compiled):
            if exprs is not None:
                vals = [float(eval(e, dict(_LINK_ENV), {"t": t}))
                        for e in exprs]
                out_l[k], out_d[k] = vals[:6], vals[6:12]
        return out_l, out_d

    return links_fn


def _extras(files, resolve):
    """The body-frame slip (the last .slip) and the chemistry (the last
    .Laplace) of a structure entry's extra files, each None without one,
    as the JAX package reads them."""
    slip = chem = None
    for f in files:
        if f.endswith(".slip"):
            slip = scene.read_slip_file(resolve(f))
        elif f.endswith(".Laplace"):
            from ..models.phoretic import Chemistry

            chem = Chemistry.from_laplace_file(resolve(f))
    return slip, chem


def _slip(files, resolve):
    """The body-frame slip of an articulated entry's extra files (its
    first .slip), or None; a .Laplace file is refused (the JAX package
    ignores it there)."""
    for f in files:
        if f.endswith(".Laplace"):
            raise NotImplementedError(
                f"{f}: a .Laplace file on an articulated entry; the phoretic "
                "slip applies to structure and obstacle entries")
    slips = [f for f in files if f.endswith(".slip")]
    return scene.read_slip_file(resolve(slips[0])) if slips else None


def build_system(cfg: InputConfig, base_dir=".", dtype=torch.float64,
                 device=None):
    """Build (System, State) from an InputConfig; each structure entry
    becomes one BodyType group, then each obstacle entry one with
    prescribed kinematics, then each articulated entry one group per
    sub-body. Scene files resolve against base_dir; the vertex files
    that a .list_vertex file names resolve against the working directory
    (scene.read_vertex_file_list). The State lies on `device` (default
    the card; device="cpu" runs on the CPU)."""
    from ..models.articulated import ArticulatedType

    device = resolve_device(device)

    def _resolve(p):
        return p if os.path.isabs(p) else os.path.join(base_dir, p)

    def _check_radii(ref, name):
        if ref.shape[1] == 4 and not np.allclose(ref[:, 3], cfg.blob_radius):
            raise NotImplementedError(
                f"structure {name}: per-blob radii are not ported yet "
                "(ROADMAP Queue 1, item 4)")

    types, locations, quaternions, chemistries = [], [], [], []
    entries = ([(f, n, False) for f, n in zip(cfg.structures,
                                              cfg.structures_ID)]
               + [(f, n, True) for f, n in zip(cfg.obstacles,
                                               cfg.obstacles_ID)])
    for files, name, is_obstacle in entries:
        ref = scene.read_vertex_file(_resolve(files[0]))
        _check_radii(ref, name)
        nbod, loc, quat = scene.read_clones_file(_resolve(files[1]))
        slip, chem = _extras(files[2:], _resolve)
        types.append(BodyType(name=name, ref_config=ref[:, :3], count=nbod,
                              prescribed_kinematics=is_obstacle,
                              is_obstacle=is_obstacle, slip_ref=slip))
        chemistries.append(chem)
        locations.append(loc)
        quaternions.append(quat)

    articulated = []
    for files, name in zip(cfg.articulated, cfg.articulated_ID):
        refs = scene.read_vertex_file_list(_resolve(files[0]))
        n_total, locs, quats = scene.read_clones_file(_resolve(files[1]))
        nb_art, _, pairs, links, extra = scene.read_constraints_file(
            _resolve(files[2]))
        slip = _slip(files[3:], _resolve)
        n_inst = n_total // nb_art
        locs = locs.reshape(n_inst, nb_art, 3)
        quats = quats.reshape(n_inst, nb_art, 4)
        sub = []
        for j in range(nb_art):
            _check_radii(refs[j], name)
            sub.append(len(types))
            types.append(BodyType(name=f"{name}_sub{j}",
                                  ref_config=refs[j][:, :3], count=n_inst,
                                  slip_ref=slip))
            locations.append(locs[:, j])
            quaternions.append(quats[:, j])
        articulated.append(ArticulatedType(
            name=name, count=n_inst, sub_type_indices=tuple(sub),
            pairs_local=pairs, links=links,
            links_fn=(compile_links_fn(extra, links) if any(extra)
                      else None)))

    bb_impl = cfg.options.get("blob_blob_force_implementation", "None")
    if bb_impl == "None":
        bb_method = "none"
    elif "tree" in bb_impl or "neighbor" in bb_impl:
        # the reference's kd-tree backends map to the linked cells
        bb_method = "neighbor_list"
    else:
        bb_method = "direct"
    bbody = cfg.options.get("body_body_force_torque_implementation", "None")

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
        body_body_force_method="none" if bbody == "None" else "yukawa",
        solver_tolerance=cfg.solver_tolerance, rf_delta=cfg.rf_delta,
        articulated=tuple(articulated),
        nonlinear_solver_tolerance=float(
            cfg.options.get("nonlinear_solver_tolerance", 1e-8)))
    if any(c is not None for c in chemistries):
        # the phoretic coupling: every step solves the Laplace BVP and
        # adds its slip
        from ..models import phoretic

        chemistries += [None] * (len(types) - len(chemistries))
        pcfg = phoretic.PhoreticConfig(
            chemistry=tuple(chemistries), background=cfg.background_laplace,
            diffusion_coefficient=cfg.diffusion_coefficient)
        system = dataclasses.replace(system,
                                     slip_fn=phoretic.make_slip_fn(pcfg))
        cfg.phoretic_cfg = pcfg
    state = make_state(np.concatenate(locations, axis=0),
                       np.concatenate(quaternions, axis=0), dtype=dtype,
                       device=device)
    return system, state
