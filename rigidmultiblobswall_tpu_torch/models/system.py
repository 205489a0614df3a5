"""Static system description and dynamic state (PyTorch).

Counterpart of rigidmultiblobswall_tpu/models/system.py. Frozen
dataclasses take the place of the JAX pytrees:

  * `BodyType` / `System` - static geometry and physics parameters, host
    numpy and Python scalars, independent of device and dtype. Bodies are
    grouped by type so per-body work batches over each group.
  * `State` - body locations (B, 3) and unit quaternions (B, 4) as
    tensors, in type-group order; the device and dtype of a run are the
    state's.

The port covers the direct pairwise engine (`domain` 'single_wall',
'no_wall', 'in_plane' (the single wall with the z components projected
away) or 'free_surface' (a slip plane at z = 0), open or with the
pseudo-periodic image boxes of a `periodic_length`), the
triply-periodic spectral Ewald engine (`domain` 'periodic_spectral') and
the xy-periodic spectral wall engine (`domain` 'single_wall_spectral',
slab top `spectral_wall_height`), with per-blob radii on the pairwise
domains but in_plane and on the periodic spectral engine
(`BodyType.blob_radii`; the mobility takes them, the forces keep
`blob_radius`), with the default force set: direct or linked-cell
blob-blob repulsion and the body-body Yukawa force, bodies with
prescribed kinematics (obstacles), active slip (`BodyType.slip_ref`),
articulated bodies (`System.articulated`, a tuple of
models/articulated.ArticulatedType) and the user hooks
(`blob_force_fn`, `body_force_torque_fn`, `slip_fn`: torch functions of
the port's System and State, called where the JAX package calls its
own). Fields the JAX System
carries for other engines and models are not present; `from_reference`
refuses a JAX system that sets them. `System.mesh`, a parallel/mesh.Mesh
of several ranks, splits the pairwise products and the spectral
products across them (`mobility_kwargs` carries it, as the JAX
package's does).

Entry points put their tensors on the card unless the caller passes
device="cpu"; without CUDA they raise rather than fall back.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

DOMAINS = ("single_wall", "no_wall", "in_plane", "free_surface",
           "periodic_spectral", "single_wall_spectral")
BLOB_BLOB_METHODS = ("direct", "none", "neighbor_list")
# 'python' is the reference's backend name; both select the one Yukawa law
BODY_BODY_METHODS = ("none", "python", "yukawa")


def resolve_device(device=None) -> torch.device:
    """The device of a run: the card unless the caller names another. No
    silent fallback: asking for the card without CUDA raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card by "
                           "default; pass device='cpu' (--device cpu on the "
                           "command line) to run the plain PyTorch versions "
                           "on the CPU")
    return dev


def _freeze(arr):
    a = np.asarray(arr, dtype=np.float64)
    a.setflags(write=False)
    return a


@dataclasses.dataclass(frozen=True)
class BodyType:
    """A group of rigid bodies sharing one reference configuration:
    ref_config (nb, 3) blob coordinates at orientation (1,0,0,0) about
    the body center. A type with prescribed kinematics (an obstacle of an
    input file) moves with prescribed_velocity (count, 6), zero when
    None, whatever the forces on it. slip_ref (nb, 3) is an active slip
    in the body frame (a .slip file), rotated with the body. blob_radii
    (nb,) are the blobs' hydrodynamic radii (a .vertex file's fourth
    column), the System's blob_radius when None."""

    name: str
    ref_config: np.ndarray
    count: int
    prescribed_kinematics: bool = False
    prescribed_velocity: Optional[np.ndarray] = None
    is_obstacle: bool = False
    slip_ref: Optional[np.ndarray] = None
    blob_radii: Optional[np.ndarray] = None

    def __post_init__(self):
        object.__setattr__(self, "ref_config",
                           _freeze(np.reshape(self.ref_config, (-1, 3))))
        if self.blob_radii is not None:
            object.__setattr__(self, "blob_radii",
                               _freeze(np.reshape(self.blob_radii, (-1,))))
        if self.slip_ref is not None:
            object.__setattr__(self, "slip_ref",
                               _freeze(np.reshape(self.slip_ref, (-1, 3))))
        if self.prescribed_velocity is not None:
            object.__setattr__(
                self, "prescribed_velocity",
                _freeze(np.reshape(self.prescribed_velocity,
                                   (self.count, 6))))

    @property
    def num_blobs(self) -> int:
        return self.ref_config.shape[0]

    @property
    def body_length(self) -> float:
        """Max pairwise blob distance (the RFD length scale less 2a)."""
        r = self.ref_config
        return float(np.linalg.norm(r[:, None, :] - r[None, :, :],
                                    axis=-1).max())


@dataclasses.dataclass(frozen=True)
class System:
    """Immutable problem description."""

    types: Tuple[BodyType, ...]
    eta: float = 1.0
    blob_radius: float = 1.0
    kT: float = 0.0
    g: float = 0.0
    domain: str = "single_wall"
    periodic_length: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    # spectral engines (ops/ewald.default_params, ops/ewald_wall.
    # default_wall_params): accuracy target, per-axis FFT grid cap (r_cut
    # inflates when it binds), and near-field slots per cell (0 = auto;
    # overflow is counted)
    spectral_tol: float = 1e-4
    spectral_grid_max: int = 256
    spectral_cell_capacity: int = 0
    # single_wall_spectral slab top: the wall engine's z grid is static,
    # so the maximum blob height is declared (saddle.auto_wall_height
    # grows it; blobs above it are clipped and counted)
    spectral_wall_height: float = 0.0
    repulsion_strength: float = 0.0
    debye_length: float = 1.0
    repulsion_strength_wall: float = 0.0
    debye_length_wall: float = 1.0
    # blob-blob pair forces: 'direct' O(N^2) sweep, 'neighbor_list'
    # linked cells (fully periodic boxes), or 'none'; neighbor-list
    # cutoff (0 = 2a + 30 debye), cells per axis cap and slots per cell
    blob_blob_force_method: str = "direct"
    blob_blob_cutoff: float = 0.0
    blob_blob_grid_dim: int = 16
    blob_blob_cell_capacity: int = 32
    # body-body Yukawa force between body centers ('none', the reference's
    # default, or 'yukawa' / 'python'), with repulsion_strength and
    # debye_length
    body_body_force_method: str = "none"
    solver_tolerance: float = 1e-8
    rf_delta: float = 1e-3
    # articulated-body constraint groups (models/articulated.
    # ArticulatedType) and the tolerance of their nonlinear projection
    articulated: Tuple = ()
    nonlinear_solver_tolerance: float = 1e-8
    # user hooks, optional callables on the port's System and State and
    # torch tensors: blob_force_fn(system, state, r_blobs) -> (N, 3) extra
    # blob forces, body_force_torque_fn(system, state, r_blobs) -> (B, 6)
    # extra body forces and torques, slip_fn(system, state) -> (N, 3) slip
    # added to the active slip (the phoretic slip: models/phoretic.
    # make_slip_fn)
    blob_force_fn: Optional[Callable] = None
    body_force_torque_fn: Optional[Callable] = None
    slip_fn: Optional[Callable] = None
    # parallel/mesh.Mesh; None (or one rank) = one device
    mesh: Optional[object] = dataclasses.field(default=None, compare=False)

    def __post_init__(self):
        object.__setattr__(self, "types", tuple(self.types))
        object.__setattr__(self, "articulated", tuple(self.articulated))
        if self.body_body_force_method not in BODY_BODY_METHODS:
            raise ValueError(f"body_body_force_method "
                             f"{self.body_body_force_method!r}; one of "
                             f"{BODY_BODY_METHODS}")
        object.__setattr__(self, "periodic_length",
                           tuple(float(x) for x in self.periodic_length))
        if self.domain not in DOMAINS:
            raise NotImplementedError(
                f"domain {self.domain!r}: the port covers {DOMAINS}")
        periodic = [L > 0 for L in self.periodic_length]
        if self.domain == "periodic_spectral":
            if not all(periodic):
                raise ValueError("periodic_spectral needs periodic_length > "
                                 "0 on all three axes")
        elif self.domain == "single_wall_spectral":
            if periodic != [True, True, False]:
                raise ValueError("single_wall_spectral needs periodic_length "
                                 "> 0 on x and y and 0 on z (the wall engine "
                                 "is doubly periodic in-plane)")
        elif self.domain == "in_plane" and self.has_mixed_radii:
            raise NotImplementedError(
                "per-blob radii on in_plane: the JAX package's radii "
                "products treat in_plane as an unbounded domain (no wall, "
                "no projection), so the port refuses them rather than run "
                "other physics (ROADMAP Queue 3, differs on purpose)")
        if self.blob_blob_force_method not in BLOB_BLOB_METHODS:
            raise ValueError(f"blob_blob_force_method "
                             f"{self.blob_blob_force_method!r}; one of "
                             f"{BLOB_BLOB_METHODS}")

    @property
    def num_bodies(self) -> int:
        return sum(t.count for t in self.types)

    @property
    def mobility_kwargs(self):
        """The pairwise products' keyword arguments: the domain, the
        periodic length and, when set, the mesh."""
        kw = dict(domain=self.domain, periodic_length=self.periodic_length)
        if self.mesh is not None:
            kw["mesh"] = self.mesh
        return kw

    @property
    def num_blobs(self) -> int:
        return sum(t.count * t.num_blobs for t in self.types)

    @property
    def body_offsets(self) -> Tuple[int, ...]:
        offs = [0]
        for t in self.types:
            offs.append(offs[-1] + t.count)
        return tuple(offs)

    @property
    def blob_offsets(self) -> Tuple[int, ...]:
        offs = [0]
        for t in self.types:
            offs.append(offs[-1] + t.count * t.num_blobs)
        return tuple(offs)

    def body_slice(self, i: int) -> slice:
        offs = self.body_offsets
        return slice(offs[i], offs[i + 1])

    def blob_slice(self, i: int) -> slice:
        offs = self.blob_offsets
        return slice(offs[i], offs[i + 1])

    @property
    def prescribed_body_mask(self) -> np.ndarray:
        """(B,) bool: bodies with prescribed kinematics (obstacles)."""
        mask = np.zeros(self.num_bodies, dtype=bool)
        for i, t in enumerate(self.types):
            if t.prescribed_kinematics:
                mask[self.body_slice(i)] = True
        mask.setflags(write=False)
        return mask

    @property
    def prescribed_velocities(self) -> np.ndarray:
        """(B, 6) prescribed velocities (zero for free bodies)."""
        v = np.zeros((self.num_bodies, 6))
        for i, t in enumerate(self.types):
            if t.prescribed_velocity is not None:
                v[self.body_slice(i)] = t.prescribed_velocity
        v.setflags(write=False)
        return v

    @property
    def blob_radii(self) -> np.ndarray:
        """(N,) per-blob radii (blob_radius where a type sets none)."""
        out = np.empty(self.num_blobs)
        for i, t in enumerate(self.types):
            rad = (t.blob_radii if t.blob_radii is not None
                   else np.full(t.num_blobs, self.blob_radius))
            out[self.blob_slice(i)] = np.tile(rad, t.count)
        out.setflags(write=False)
        return out

    @property
    def has_mixed_radii(self) -> bool:
        """True when a type carries blob radii other than blob_radius: the
        mobility then takes the per-radius products (kernel P1 on the
        pairwise domains, the mixed-radii spectral engine on
        periodic_spectral), as the JAX package decides."""
        return any(t.blob_radii is not None
                   and not np.allclose(t.blob_radii, self.blob_radius)
                   for t in self.types)


@dataclasses.dataclass(frozen=True)
class State:
    """Dynamic state: all bodies concatenated in type-group order."""

    pos: torch.Tensor   # (B, 3)
    quat: torch.Tensor  # (B, 4), unit, scalar first


def make_state(positions, quaternions, dtype=torch.float64,
               device=None) -> State:
    """State on `device` (default the card; see resolve_device)."""
    device = resolve_device(device)
    pos = torch.as_tensor(positions, dtype=dtype,
                          device=device).reshape(-1, 3).contiguous()
    quat = torch.as_tensor(quaternions, dtype=dtype,
                           device=device).reshape(-1, 4).contiguous()
    return State(pos=pos, quat=quat)


def from_reference(ref_system, positions=None, quaternions=None, *,
                   dtype=torch.float64, device=None, mesh=None):
    """Carry a JAX-package `System` (and optionally its `State` arrays,
    passed as numpy) across to the port's objects on `device` (default
    the card) and `dtype`.

    Reads the reference system's attributes without importing JAX; each
    type's blob_radii come across. Features the port does not cover yet
    raise NotImplementedError, and
    so do a user hook (blob_force_fn, body_force_torque_fn, slip_fn) and
    an articulated type with a `links_fn`: JAX-traced closures the port
    cannot run (the port's System takes torch hooks of its own;
    time-dependent links come to each package from its own build_system
    and one .const file). The JAX System's TPU gridding knobs (spectral_bucket_capacity,
    spectral_plane_batch, spectral_precision) have no counterpart: the
    port grids without segment layouts or matrix units, so they are
    ignored. A JAX mesh cannot cross to torch: the port's System takes
    `mesh` (a parallel/mesh.Mesh, or None for one device) whatever the
    reference's. Returns the System, or (System, State) when positions
    are given."""
    for name in ("blob_force_fn", "body_force_torque_fn", "slip_fn"):
        if getattr(ref_system, name, None) is not None:
            raise NotImplementedError(
                f"user hook {name}: the JAX system's hook is a JAX-traced "
                "closure the port cannot run; give the port's System its "
                f"own torch hook (System(..., {name}=...))")
    from .articulated import ArticulatedType

    articulated = []
    for a in getattr(ref_system, "articulated", ()):
        if getattr(a, "links_fn", None) is not None:
            raise NotImplementedError(
                f"articulated type {a.name}: its links_fn is a JAX-traced "
                "closure; build time-dependent links from the .const file "
                "with the port's io/input_file.build_system")
        articulated.append(ArticulatedType(
            name=a.name, count=int(a.count),
            sub_type_indices=tuple(int(i) for i in a.sub_type_indices),
            pairs_local=np.asarray(a.pairs_local),
            links=np.asarray(a.links)))
    system = System(
        types=tuple(BodyType(
            name=t.name, ref_config=np.asarray(t.ref_config),
            count=int(t.count),
            blob_radii=getattr(t, "blob_radii", None),
            prescribed_kinematics=bool(getattr(t, "prescribed_kinematics",
                                               False)),
            prescribed_velocity=getattr(t, "prescribed_velocity", None),
            is_obstacle=bool(getattr(t, "is_obstacle", False)),
            slip_ref=getattr(t, "slip_ref", None))
            for t in ref_system.types),
        eta=float(ref_system.eta),
        blob_radius=float(ref_system.blob_radius),
        kT=float(ref_system.kT),
        g=float(ref_system.g),
        domain=ref_system.domain,
        periodic_length=tuple(ref_system.periodic_length),
        spectral_tol=float(ref_system.spectral_tol),
        spectral_grid_max=int(ref_system.spectral_grid_max),
        spectral_cell_capacity=int(ref_system.spectral_cell_capacity),
        spectral_wall_height=float(ref_system.spectral_wall_height),
        repulsion_strength=float(ref_system.repulsion_strength),
        debye_length=float(ref_system.debye_length),
        repulsion_strength_wall=float(ref_system.repulsion_strength_wall),
        debye_length_wall=float(ref_system.debye_length_wall),
        blob_blob_force_method=ref_system.blob_blob_force_method,
        blob_blob_cutoff=float(ref_system.blob_blob_cutoff),
        blob_blob_grid_dim=int(ref_system.blob_blob_grid_dim),
        blob_blob_cell_capacity=int(ref_system.blob_blob_cell_capacity),
        body_body_force_method=getattr(ref_system, "body_body_force_method",
                                       "none"),
        solver_tolerance=float(ref_system.solver_tolerance),
        rf_delta=float(ref_system.rf_delta),
        articulated=tuple(articulated),
        nonlinear_solver_tolerance=float(getattr(
            ref_system, "nonlinear_solver_tolerance", 1e-8)),
        mesh=mesh,
    )
    if positions is None:
        return system
    return system, make_state(positions, quaternions, dtype=dtype,
                              device=device)
