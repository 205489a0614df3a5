"""Minimally-resolved roller suspensions (PyTorch): one blob per body
with grand (trans-rot) mobility coupling.

Counterpart of rigidmultiblobswall_tpu/models/rollers.py. State is the
blob positions (N,3); bodies spin either freely (free_kinematics=True,
zero torque) or with a prescribed angular velocity, in which case the
torque solves M_rr T = omega - M_rt F by unpreconditioned GMRES.

Two product engines, as in the JAX package:
- the direct O(N^2) engine (domains single_wall and no_wall, open or with
  the pseudo-periodic image boxes of a periodic_length): every
  hydrodynamic product is kernel K1 (ops/pair_kernels.py) in one of its
  couplings: grand in each Lanczos iteration, rr (B = 2) in each lockstep
  GMRES iteration, tr (B = 2) for the torque velocities, rt for the omega
  right-hand side and the RFD drift, tt for the force velocities; with a
  periodic_length each runs K1's image-box instance; the blob-blob forces
  are kernel K2 (its periodic instance in a periodic box);
- the O(N log N) wall-spectral engine (domain single_wall_spectral,
  periodic_length (Lx, Ly, 0) and a slab top spectral_wall_height): tt by
  ops/ewald_wall.py (near field kernel K7), the rot blocks by
  ops/ewald_wall_rot.py (near field kernel K8), one right-hand side a
  product (the lockstep solves' rr and tr run one product per side); the
  blob-blob forces are K2's periodic instance (minimum image and image
  boxes). The plan (cells, gridding planes) is carried across steps in
  RollerCarry and refreshed at each configuration, as the JAX package
  carries it; the rot tables ride along.

With hydro_interactions off, the closed-form Swan-Brady self mobilities
with wall damping are used instead.

All nine schemes of the JAX package; `make_stepper` wraps each in the
bounded wall-rejection retry on body centers z < 0, as a host loop. All
noise comes from `draw_normal` and an explicit torch.Generator, drawn in
the order the JAX package draws it from its key. The hooks force_fn(sus,
r) and torque_fn(sus, r) (torch functions, (N, 3) each) add blob forces
and prescribe the torques where the JAX package applies its own.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch

from ..ops import ewald_wall, ewald_wall_rot
from ..ops import forces as force_ops
from ..ops import mobility as mob
from ..ops.gmres import gmres, gmres_lockstep
from ..ops.lanczos import stochastic_forcing_lanczos
from ..parallel import mesh as mesh_mod
from .integrators import draw_normal
from .system import DOMAINS


@dataclasses.dataclass(frozen=True)
class RollerSuspension:
    """Static description of a roller suspension (N single-blob bodies).

    domain="single_wall_spectral" routes every product through the wall
    engine (ops/ewald_wall.py, ops/ewald_wall_rot.py); it needs
    periodic_length x, y > 0 and spectral_wall_height > 0, checked when
    the engine is first built, as in the JAX package."""

    num_rollers: int
    eta: float = 1.0
    blob_radius: float = 1.0
    kT: float = 0.0
    g: float = 0.0
    domain: str = "single_wall"
    spectral_tol: float = 1e-4
    spectral_grid_max: int = 512
    spectral_wall_height: float = 0.0
    spectral_cell_capacity: int = 0
    periodic_length: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    repulsion_strength: float = 0.0
    debye_length: float = 1.0
    repulsion_strength_wall: float = 0.0
    debye_length_wall: float = 1.0
    solver_tolerance: float = 1e-8
    rf_delta: float = 1e-3
    free_kinematics: bool = True
    omega_one_roller: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    hydro_interactions: bool = True
    lanczos_max_iter: int = 64
    # hooks, torch functions of the suspension and the positions r (N, 3):
    # the prescribed torque torque_fn(sus, r) -> (N, 3) (zero without one)
    # and extra blob forces force_fn(sus, r) -> (N, 3)
    torque_fn: Optional[Callable] = None
    force_fn: Optional[Callable] = None
    # parallel/mesh.Mesh: the pairwise products split across its ranks
    mesh: Optional[object] = dataclasses.field(default=None, compare=False)

    def __post_init__(self):
        object.__setattr__(self, "periodic_length",
                           tuple(float(x) for x in self.periodic_length))
        object.__setattr__(self, "omega_one_roller",
                           tuple(float(x) for x in self.omega_one_roller))
        if self.domain not in DOMAINS:
            raise NotImplementedError(
                f"domain {self.domain!r}: the rollers port covers {DOMAINS}")

    @property
    def mobility_kwargs(self):
        kw = dict(domain=self.domain, periodic_length=self.periodic_length)
        if self.mesh is not None:
            kw["mesh"] = self.mesh
        return kw


class RollerAux(NamedTuple):
    velocities: torch.Tensor
    torques: torch.Tensor
    det_iterations: int
    stoch_iterations: int
    rejections: int
    wall_overlaps: int
    # wall-spectral domain: points the near-field plan at the step's
    # configuration left out of full cells (their near field is missing);
    # must be 0, else raise spectral_cell_capacity
    plan_drops: int = 0


class RollerCarry(NamedTuple):
    velocities_prev: torch.Tensor
    first_step: bool
    # the wall-spectral engine's plan, carried across steps and refreshed
    # at each accepted configuration, and its rot tables
    plan: object = None
    rot_tables: object = None


def init_carry(sus: RollerSuspension, dtype=torch.float64, positions=None,
               device=None) -> RollerCarry:
    """The first step's carry; for the wall-spectral domain with positions,
    the engine's plan at them and its rot tables (host tables built once
    per params)."""
    plan = tables = None
    if positions is not None:
        dtype, device = positions.dtype, positions.device
        if sus.domain == "single_wall_spectral":
            params = _roller_spectral_params(sus)
            plan = ewald_wall.make_wall_plan(params, positions)
            tables = ewald_wall_rot.rot_tables(params, dtype, device)
    return RollerCarry(
        velocities_prev=torch.zeros((sus.num_rollers, 3), dtype=dtype,
                                    device=device),
        first_step=True, plan=plan, rot_tables=tables)


def from_reference(ref_sus, mesh=None) -> RollerSuspension:
    """Carry a JAX-package `RollerSuspension` across to the port's, its
    spectral fields included. A JAX mesh cannot cross to torch: the port's
    suspension takes `mesh` (a parallel/mesh.Mesh, or None) whatever the
    reference's. spectral_bucket_capacity, a TPU gridding knob, has no
    counterpart here (the port grids without segment layouts). A
    suspension with a force or torque hook is refused: its hook is a
    JAX-traced closure the port cannot run (the port's RollerSuspension
    takes torch hooks of its own)."""
    for hook in ("torque_fn", "force_fn"):
        if getattr(ref_sus, hook, None) is not None:
            raise NotImplementedError(
                f"roller hook {hook}: the JAX suspension's hook is a "
                "JAX-traced closure the port cannot run; give the port's "
                f"RollerSuspension its own torch hook ({hook}=...)")
    fields = {f.name: getattr(ref_sus, f.name)
              for f in dataclasses.fields(RollerSuspension)
              if f.name not in ("torque_fn", "force_fn", "mesh")}
    return RollerSuspension(**fields, mesh=mesh)


# ---------------------------------------------------------------------------
# Forces and closed-form Swan-Brady self mobilities
# ---------------------------------------------------------------------------


def roller_forces(sus: RollerSuspension, r):
    f = force_ops.blob_external_forces(
        r, g=sus.g, blob_mass=1.0, blob_radius=sus.blob_radius,
        repulsion_strength_wall=sus.repulsion_strength_wall,
        debye_length_wall=sus.debye_length_wall)
    f = f + force_ops.blob_blob_forces(
        r, repulsion_strength=sus.repulsion_strength,
        debye_length=sus.debye_length, blob_radius=sus.blob_radius,
        periodic_length=sus.periodic_length)
    if sus.force_fn is not None:
        f = f + sus.force_fn(sus, r)
    return f


def roller_torques(sus: RollerSuspension, r):
    if sus.torque_fn is not None:
        return sus.torque_fn(sus, r).reshape(sus.num_rollers, 3)
    return torch.zeros((sus.num_rollers, 3), dtype=r.dtype, device=r.device)


# ---------------------------------------------------------------------------
# Grand-mobility product engines (direct O(N^2) vs wall-spectral)
# ---------------------------------------------------------------------------


def _roller_spectral_params(sus: RollerSuspension):
    """The wall engine's parameters of a single_wall_spectral suspension
    (the JAX package's rules and messages)."""
    Lx, Ly = sus.periodic_length[0], sus.periodic_length[1]
    if not (Lx > 0 and Ly > 0):
        raise ValueError("single_wall_spectral rollers need "
                         "periodic_length > 0 on x and y")
    if sus.spectral_wall_height <= 0:
        raise ValueError("single_wall_spectral rollers need "
                         "spectral_wall_height > 0 (slab top)")
    return ewald_wall.default_wall_params(
        sus.blob_radius, sus.eta, (Lx, Ly), z_hi=sus.spectral_wall_height,
        tol=sus.spectral_tol, grid_max=sus.spectral_grid_max,
        cell_capacity=sus.spectral_cell_capacity)


class _DirectEngine:
    """Product closures on the pairwise kernels at configuration r."""

    def __init__(self, sus, r):
        self.sus, self.r = sus, r
        self.kw = sus.mobility_kwargs

    def at(self, r_new):
        return _DirectEngine(self.sus, r_new)

    def _square(self, product, v):
        return product(self.r, v, self.sus.eta, self.sus.blob_radius,
                       **self.kw)

    def tt(self, f):
        return self._square(mob.mobility_trans_times_force, f)

    def tr(self, t):
        return self._square(mob.mobility_trans_times_torque, t)

    def rt(self, f):
        return self._square(mob.mobility_rot_times_force, f)

    def rr(self, t):
        return self._square(mob.mobility_rot_times_torque, t)

    def grand(self, f, t):
        return mob.grand_mobility_matvec(self.r, f, t, self.sus.eta,
                                         self.sus.blob_radius, **self.kw)

    def _multi(self, coupling, T):
        """(B, n, 3) -> (B, n, 3) products in one condensed sweep."""
        return mob.pairwise_matvec_multi(
            self.r, None, T, self.sus.eta, self.sus.blob_radius,
            coupling=coupling, self_interaction=True, **self.kw)

    def rr_multi(self, T):
        return self._multi("rr", T)

    def tr_multi(self, T):
        return self._multi("tr", T)


class _WallSpectralEngine:
    """Product closures on the O(N log N) wall engine at configuration r:
    a plan (built at r, or a caller's) and the rot tables."""

    def __init__(self, sus, r, plan=None, tables=None):
        self.sus = sus
        params = _roller_spectral_params(sus)
        self.plan = (plan if plan is not None
                     else ewald_wall.make_wall_plan(params, r))
        self.tables = (tables if tables is not None
                       else ewald_wall_rot.rot_tables(params, r.dtype,
                                                      r.device))

    def at(self, r_new):
        return _WallSpectralEngine(
            self.sus, r_new,
            plan=ewald_wall.update_wall_plan(self.plan, r_new),
            tables=self.tables)

    def tt(self, f):
        return ewald_wall.matvec(self.plan, f)

    # tr, rt and rr use one output of the grand product; the JAX package
    # forms the other (and rt's tt product) and discards it
    def tr(self, t):
        return ewald_wall_rot.grand_matvec(self.plan, None, t, self.tables,
                                           want_w=False)[0]

    def rt(self, f):
        return ewald_wall_rot.grand_matvec(self.plan, f, None, self.tables,
                                           want_v=False)[1]

    def rr(self, t):
        return ewald_wall_rot.grand_matvec(self.plan, None, t, self.tables,
                                           want_v=False)[1]

    def grand(self, f, t):
        return ewald_wall_rot.grand_matvec(self.plan, f, t, self.tables)

    def rr_multi(self, T):
        return torch.stack([self.rr(T[b]) for b in range(T.shape[0])])

    def tr_multi(self, T):
        return torch.stack([self.tr(T[b]) for b in range(T.shape[0])])


def _engine(sus: RollerSuspension, r, carry=None):
    """The product engine at r: the wall-spectral one (on the carry's plan
    refreshed at r, when the carry holds one) or the direct one."""
    if sus.domain == "single_wall_spectral":
        plan = getattr(carry, "plan", None)
        if plan is not None:
            plan = ewald_wall.update_wall_plan(plan, r)
        return _WallSpectralEngine(sus, r, plan=plan,
                                   tables=getattr(carry, "rot_tables", None))
    return _DirectEngine(sus, r)


def swan_brady_self_mobilities(sus: RollerSuspension, z):
    """Closed-form single-wall self mobilities with overlap damping
    (quaternion_integrator_rollers.py:1016-1064)."""
    a, eta = sus.blob_radius, sus.eta
    f_tt = 1.0 / (6.0 * math.pi * eta * a)
    f_rr = 1.0 / (6.0 * math.pi * eta * a ** 3)
    f_rt = 1.0 / (6.0 * math.pi * eta * a ** 2)
    h = z / a
    he = torch.clamp(h, min=1.0)
    damping = torch.clamp(h, 0.0, 1.0)
    return dict(
        tt_para=f_tt * (1.0 - 9.0 / (16.0 * he) + 2.0 / (16.0 * he ** 3)
                        - 1.0 / (16.0 * he ** 5)) * damping,
        tt_perp=f_tt * (1.0 - 9.0 / (8.0 * he) + 1.0 / (2.0 * he ** 3)
                        - 1.0 / (8.0 * he ** 5)) * damping,
        rt_para=f_rt * (3.0 / (32.0 * he ** 4)) * damping,
        rr_para=f_rr * (0.75 - 15.0 / (64.0 * he ** 3)) * damping,
        rr_perp=f_rr * (0.75 - 3.0 / (32.0 * he ** 3)) * damping,
        d_tt_perp=f_tt * (9.0 / (8.0 * he ** 2) - 1.5 / he ** 4
                          + 5.0 / (8.0 * he ** 6)) * damping)


def _omega(sus, r):
    return torch.tensor(sus.omega_one_roller, dtype=r.dtype,
                        device=r.device).expand(sus.num_rollers, 3)


def _uncorrelated_noise(sus, r, z, dt_eff):
    """sqrt(2 kT / dt_eff) times the closed-form self-mobility square
    roots applied to z (n, 3)."""
    mus = swan_brady_self_mobilities(sus, r[:, 2])
    fd = math.sqrt(2.0 * sus.kT / dt_eff)
    return torch.stack([fd * torch.sqrt(mus["tt_para"]) * z[:, 0],
                        fd * torch.sqrt(mus["tt_para"]) * z[:, 1],
                        fd * torch.sqrt(mus["tt_perp"]) * z[:, 2]], dim=1)


# ---------------------------------------------------------------------------
# Deterministic velocity (+ constrained-omega torque solve)
# ---------------------------------------------------------------------------


def deterministic_velocity_and_torque(sus: RollerSuspension, r, *,
                                      x0_torque=None, eng=None,
                                      gmres_restart=20, gmres_maxiter=1000):
    """(v, T, gmres_iters) per quaternion_integrator_rollers.py:905-982."""
    force = roller_forces(sus, r)
    if not sus.hydro_interactions:
        return _deterministic_uncorrelated(sus, r, force)
    if eng is None:
        eng = _engine(sus, r)

    if not sus.free_kinematics:
        rhs = (_omega(sus, r) - eng.rt(force)).reshape(-1)
        rhs_norm = torch.linalg.norm(rhs)
        safe = torch.where(rhs_norm > 0, rhs_norm, torch.ones_like(rhs_norm))
        res = gmres(lambda t: eng.rr(t.reshape(-1, 3)).reshape(-1),
                    rhs / safe, x0=x0_torque, tol=sus.solver_tolerance,
                    restart=gmres_restart, maxiter=gmres_maxiter)
        torque = (res.x * rhs_norm).reshape(sus.num_rollers, 3)
        iters = res.iterations
    else:
        torque = roller_torques(sus, r)
        iters = 0
    return eng.tt(force) + eng.tr(torque), torque, iters


def _deterministic_uncorrelated(sus: RollerSuspension, r, force):
    """Closed-form uncorrelated mobilities
    (quaternion_integrator_rollers.py:985-1079)."""
    mus = swan_brady_self_mobilities(sus, r[:, 2])
    fx, fy, fz = force[:, 0], force[:, 1], force[:, 2]
    if not sus.free_kinematics:
        omega = _omega(sus, r)

        def safe_inv(x):
            return torch.where(x > 0, 1.0 / torch.where(x > 0, x,
                                                        torch.ones_like(x)),
                               torch.zeros_like(x))

        inv_para = safe_inv(mus["rr_para"])
        torque = torch.stack([
            inv_para * (omega[:, 0] + mus["rt_para"] * fy),
            inv_para * (omega[:, 1] - mus["rt_para"] * fx),
            safe_inv(mus["rr_perp"]) * omega[:, 2]], dim=1)
    else:
        torque = roller_torques(sus, r)
    velocity = torch.stack([
        mus["tt_para"] * fx + mus["rt_para"] * torque[:, 1],
        mus["tt_para"] * fy - mus["rt_para"] * torque[:, 0],
        mus["tt_perp"] * fz], dim=1)
    return velocity, torque, 0


# ---------------------------------------------------------------------------
# Stochastic velocity
# ---------------------------------------------------------------------------


def _rfd_div(sus, r, dx, product):
    """(kT/(delta a)) * [P(r+dx/2) dx - P(r-dx/2) dx] for product P and
    the random displacement dx (n, 3)."""
    shift = sus.rf_delta * sus.blob_radius * 0.5
    plus = product(r + dx * shift, dx)
    minus = product(r - dx * shift, dx)
    return (sus.kT / (sus.rf_delta * sus.blob_radius)) * (plus - minus)


def _grand_noise_and_drift(sus, r, generator, dt, eng):
    """Lanczos noise sqrt(2 kT/dt) M_grand^{1/2} z, and the RFD drifts
    div M_tt, div M_rt of one shared random displacement. Returns
    (noise_t, noise_r, div_M_tt, div_M_rt, lanczos_iters)."""
    n = sus.num_rollers

    def grand(ft):
        u, w = eng.grand(ft[:3 * n].reshape(n, 3), ft[3 * n:].reshape(n, 3))
        return torch.cat([u.reshape(-1), w.reshape(-1)])

    z = draw_normal(generator, (6 * n,), r)
    noise = stochastic_forcing_lanczos(
        grand, z, factor=math.sqrt(2.0 * sus.kT / dt),
        tolerance=sus.solver_tolerance, max_iter=sus.lanczos_max_iter)
    if sus.kT > 0 and sus.domain != "no_wall":
        dx = draw_normal(generator, (n, 3), r)
        div_M_tt = _rfd_div(sus, r, dx, lambda rr, d: eng.at(rr).tt(d))
        div_M_rt = _rfd_div(sus, r, dx, lambda rr, d: eng.at(rr).rt(d))
    else:
        div_M_tt = div_M_rt = torch.zeros_like(r)
    return (noise.noise[:3 * n].reshape(n, 3),
            noise.noise[3 * n:].reshape(n, 3), div_M_tt, div_M_rt,
            noise.iterations)


def stochastic_velocity(sus: RollerSuspension, r, generator, dt, *,
                        eng=None, gmres_restart=20, gmres_maxiter=1000):
    """Full grand-mobility stochastic velocity with RFD drift terms
    (quaternion_integrator_rollers.py:1082-1200). Returns
    (v_stoch, lanczos_iters, gmres_iters)."""
    n = sus.num_rollers
    if eng is None:
        eng = _engine(sus, r)
    noise_t, noise_r, div_M_tt, div_M_rt, it_l = _grand_noise_and_drift(
        sus, r, generator, dt, eng)

    if not sus.free_kinematics:
        rhs = (-noise_r - div_M_rt).reshape(-1)
        rhs_norm = torch.linalg.norm(rhs)
        safe = torch.where(rhs_norm > 0, rhs_norm, torch.ones_like(rhs_norm))
        res = gmres(lambda t: eng.rr(t.reshape(-1, 3)).reshape(-1),
                    rhs / safe, tol=sus.solver_tolerance,
                    restart=gmres_restart, maxiter=gmres_maxiter)
        torque = (res.x * rhs_norm).reshape(n, 3)
        iters = res.iterations
    else:
        torque = torch.zeros_like(r)
        iters = 0
    return eng.tr(torque) + noise_t + div_M_tt, it_l, iters


def det_stoch_velocity_lockstep(sus: RollerSuspension, r, generator, dt, *,
                                x0_torque=None, eng=None,
                                gmres_restart=20, gmres_maxiter=1000):
    """Fused deterministic + stochastic update for constrained-omega
    rollers with hydrodynamic interactions: the torque solves
    M_rr T = omega - M_rt F and M_rr T = -noise_r - div M_rt share the
    configuration, so one lockstep Krylov loop advances both with one
    B = 2 rr sweep per iteration, and the two trailing M_tr products share
    one B = 2 tr sweep.

    Returns (v_det, torque_det, v_stoch, gmres_sweeps, lanczos_iters)."""
    n = sus.num_rollers
    force = roller_forces(sus, r)
    if eng is None:
        eng = _engine(sus, r)
    noise_t, noise_r, div_M_tt, div_M_rt, it_l = _grand_noise_and_drift(
        sus, r, generator, dt, eng)

    rhs_det = (_omega(sus, r) - eng.rt(force)).reshape(-1)
    rhs_st = (-noise_r - div_M_rt).reshape(-1)
    B = torch.stack([rhs_det, rhs_st])
    norms = torch.linalg.norm(B, dim=1)
    safe = torch.where(norms > 0, norms, torch.ones_like(norms))
    x0 = None
    if x0_torque is not None:
        x0 = torch.stack([x0_torque.reshape(-1) / safe[0],
                          torch.zeros_like(rhs_det)])
    res = gmres_lockstep(
        lambda T: eng.rr_multi(T.reshape(2, n, 3)).reshape(2, -1),
        B / safe[:, None], x0=x0, tol=sus.solver_tolerance,
        restart=gmres_restart, maxiter=gmres_maxiter)
    T = res.x * norms[:, None]
    torque_det = T[0].reshape(n, 3)
    tr = eng.tr_multi(torch.stack([torque_det, T[1].reshape(n, 3)]))
    v_det = eng.tt(force) + tr[0]
    v_st = tr[1] + noise_t + div_M_tt
    return v_det, torque_det, v_st, res.iterations, it_l


def stochastic_linear_velocity(sus: RollerSuspension, r, generator, dt, *,
                               with_drift=True, eng=None):
    """Free-kinematics M_tt-only noise (+ RFD drift)
    (quaternion_integrator_rollers.py:1203-1260, :1315-1353). Returns
    (v, lanczos_iters)."""
    n = sus.num_rollers
    if not sus.hydro_interactions:
        z = draw_normal(generator, (n, 3), r)
        v = _uncorrelated_noise(sus, r, z, dt)
        if with_drift:
            mus = swan_brady_self_mobilities(sus, r[:, 2])
            v[:, 2] = v[:, 2] + sus.kT * mus["d_tt_perp"]
        return v, 0

    if eng is None:
        eng = _engine(sus, r)
    z = draw_normal(generator, (3 * n,), r)
    noise = stochastic_forcing_lanczos(
        lambda f: eng.tt(f.reshape(-1, 3)).reshape(-1), z,
        factor=math.sqrt(2.0 * sus.kT / dt), tolerance=sus.solver_tolerance,
        max_iter=sus.lanczos_max_iter)
    v = noise.noise.reshape(n, 3)
    if with_drift and sus.kT > 0 and sus.domain != "no_wall":
        dx = draw_normal(generator, (n, 3), r)
        v = v + _rfd_div(sus, r, dx, lambda rr, d: eng.at(rr).tt(d))
    return v, noise.iterations


# ---------------------------------------------------------------------------
# Schemes + stepper. Each scheme is attempt(sus, dt, generator, r, carry)
# -> (r_new, v_det, torque, det_iters, stoch_iters).
# ---------------------------------------------------------------------------


def _adams_bashforth(v, carry):
    return v if carry.first_step else 1.5 * v - 0.5 * carry.velocities_prev


def _carried_engine(sus, r, carry):
    """The engine the JAX package's first-order and Adams-Bashforth
    schemes build from the carry (hydrodynamics on)."""
    return _engine(sus, r, carry) if sus.hydro_interactions else None


def _scheme_forward_euler(sus, dt, generator, r, carry):
    v, t, it = deterministic_velocity_and_torque(
        sus, r, eng=_carried_engine(sus, r, carry))
    return r + dt * v, v, t, it, 0


def _scheme_adams_bashforth(sus, dt, generator, r, carry):
    v, t, it = deterministic_velocity_and_torque(
        sus, r, eng=_carried_engine(sus, r, carry))
    return r + dt * _adams_bashforth(v, carry), v, t, it, 0


def _det_and_stoch(sus, dt, generator, r, carry):
    """Deterministic and stochastic velocities of the first-order and
    Adams-Bashforth schemes: (v, t, vs, det_iters, stoch_iters)."""
    eng = _carried_engine(sus, r, carry)
    if sus.free_kinematics:
        v, t, it = deterministic_velocity_and_torque(sus, r, eng=eng)
        vs, it_l = stochastic_linear_velocity(sus, r, generator, dt, eng=eng)
        return v, t, vs, it, it_l
    if sus.hydro_interactions:
        return det_stoch_velocity_lockstep(sus, r, generator, dt, eng=eng)
    v, t, it = deterministic_velocity_and_torque(sus, r)
    vs, it_l, it_g = stochastic_velocity(sus, r, generator, dt)
    return v, t, vs, it + it_g, it_l


def _scheme_stochastic_first_order(sus, dt, generator, r, carry):
    v, t, vs, it, it_l = _det_and_stoch(sus, dt, generator, r, carry)
    return r + dt * (v + vs), v, t, it, it_l


def _scheme_stochastic_adams_bashforth(sus, dt, generator, r, carry):
    v, t, vs, it, it_l = _det_and_stoch(sus, dt, generator, r, carry)
    return r + dt * (_adams_bashforth(v, carry) + vs), v, t, it, it_l


def _thermal_drift(sus, r, generator):
    """kT div_t(M_tt) via centered RFD
    (quaternion_integrator_rollers.py:1404-1434)."""
    if sus.kT <= 0 or sus.domain == "no_wall":
        return torch.zeros_like(r)
    dx = draw_normal(generator, tuple(r.shape), r)
    eng = _engine(sus, r)
    return _rfd_div(sus, r, dx, lambda rr, d: eng.at(rr).tt(d))


def _noise_shape(sus):
    n = sus.num_rollers
    return (3 * n,) if sus.hydro_interactions else (n, 3)


def _noise_velocity(sus, r, z, dt_eff):
    """sqrt(2 kT / dt_eff) M_tt^{1/2} z without drift, both hydro modes;
    z has `_noise_shape(sus)`. Returns (noise (n, 3), lanczos_iters)."""
    if not sus.hydro_interactions:
        return _uncorrelated_noise(sus, r, z, dt_eff), 0
    eng = _engine(sus, r)
    res = stochastic_forcing_lanczos(
        lambda f: eng.tt(f.reshape(-1, 3)).reshape(-1), z,
        factor=math.sqrt(2.0 * sus.kT / dt_eff),
        tolerance=sus.solver_tolerance, max_iter=sus.lanczos_max_iter)
    return res.noise.reshape(sus.num_rollers, 3), res.iterations


def _scheme_stochastic_mid_point(sus, dt, generator, r, carry):
    """Midpoint with centered-RFD drift
    (quaternion_integrator_rollers.py:495-574)."""
    drift = _thermal_drift(sus, r, generator)
    v1, t, it1 = deterministic_velocity_and_torque(sus, r)
    vs1, itl1 = _noise_velocity(
        sus, r, draw_normal(generator, _noise_shape(sus), r), 0.5 * dt)
    r_mid = r + 0.5 * dt * (v1 + vs1)
    v2, _, it2 = deterministic_velocity_and_torque(sus, r_mid)
    vs2, itl2 = _noise_velocity(
        sus, r_mid, draw_normal(generator, _noise_shape(sus), r), 0.5 * dt)
    v = v2 + drift + 0.5 * (vs1 + vs2)
    return r + dt * v, v2, t, it1 + it2, itl1 + itl2


def _scheme_stochastic_mid_point_v2(sus, dt, generator, r, carry):
    """Midpoint variant: both noises drawn at the initial configuration
    (quaternion_integrator_rollers.py:577-656)."""
    drift = _thermal_drift(sus, r, generator)
    v1, t, it1 = deterministic_velocity_and_torque(sus, r)
    vs1, itl1 = _noise_velocity(
        sus, r, draw_normal(generator, _noise_shape(sus), r), 0.5 * dt)
    vs2, itl2 = _noise_velocity(
        sus, r, draw_normal(generator, _noise_shape(sus), r), 0.5 * dt)
    r_mid = r + 0.5 * dt * (v1 + vs1)
    v2, _, it2 = deterministic_velocity_and_torque(sus, r_mid)
    v = v2 + drift + 0.5 * (vs1 + vs2)
    return r + dt * v, v2, t, it1 + it2, itl1 + itl2


def _scheme_stochastic_trapezoidal(sus, dt, generator, r, carry):
    """Trapezoidal with centered-RFD drift
    (quaternion_integrator_rollers.py:659-735)."""
    drift = _thermal_drift(sus, r, generator)
    v1, t, it1 = deterministic_velocity_and_torque(sus, r)
    vs, itl = _noise_velocity(
        sus, r, draw_normal(generator, _noise_shape(sus), r), dt)
    v2, _, it2 = deterministic_velocity_and_torque(sus, r + dt * (v1 + vs))
    v = 0.5 * (v1 + v2) + drift + vs
    return r + dt * v, v2, t, it1 + it2, itl


def _scheme_stochastic_GDC(sus, dt, generator, r, carry):
    """Generalized drifter-corrector: the divergence of the Brownian
    velocity is estimated by a z finite difference of the noise (the same
    random vector at both configurations) and enters as a time rescaling
    (quaternion_integrator_rollers.py:369-493)."""
    z = draw_normal(generator, _noise_shape(sus), r)
    dz = torch.zeros_like(r)
    dz[:, 2] = sus.rf_delta * sus.blob_radius
    vs_n, itl1 = _noise_velocity(sus, r, z, dt)
    vs_fd, itl2 = _noise_velocity(sus, r + dz, z, dt)
    div = (vs_fd[:, 2] - vs_n[:, 2]) / (sus.rf_delta * sus.blob_radius)
    if sus.hydro_interactions:
        correction = 1.0 + 0.5 * dt * torch.sum(div)
    else:
        correction = (1.0 + 0.5 * dt * div)[:, None]
    v_det, t, it = deterministic_velocity_and_torque(sus, r)
    return r + dt * (v_det + vs_n) * correction, v_det, t, it, itl1 + itl2


def _scheme_stochastic_EM(sus, dt, generator, r, carry):
    v, t, it = deterministic_velocity_and_torque(sus, r)
    vs, it_l = stochastic_linear_velocity(sus, r, generator, dt,
                                          with_drift=False)
    return r + dt * (v + vs), v, t, it, it_l


_SCHEMES = {
    "deterministic_forward_euler_rollers": _scheme_forward_euler,
    "deterministic_adams_bashforth_rollers": _scheme_adams_bashforth,
    "stochastic_first_order_rollers": _scheme_stochastic_first_order,
    "stochastic_adams_bashforth_rollers": _scheme_stochastic_adams_bashforth,
    "stochastic_EM_rollers": _scheme_stochastic_EM,
    "stochastic_mid_point_rollers": _scheme_stochastic_mid_point,
    "stochastic_mid_point_version_2_rollers": _scheme_stochastic_mid_point_v2,
    "stochastic_trapezoidal_rollers": _scheme_stochastic_trapezoidal,
    "stochastic_GDC_rollers": _scheme_stochastic_GDC,
}


def available_schemes():
    """The names of the roller schemes make_stepper runs."""
    return tuple(_SCHEMES)


def make_stepper(sus: RollerSuspension, scheme: str, dt: float, *,
                 max_rejections: int = 50):
    """step(positions (N,3), generator, carry) -> (positions, carry,
    RollerAux). A step whose roller centers end below the wall retries
    with fresh noise, at most max_rejections attempts; the last candidate
    is returned and the retries reported in RollerAux.rejections. On the
    wall-spectral domain the carry holds the plan (built at r when it
    holds none), refreshed at the accepted positions; its cell drops at
    r are reported in RollerAux.plan_drops. Under sus.mesh every rank
    runs the step: its decisions are rank 0's (parallel/mesh.replicated),
    and every rank leaves it with rank 0's positions."""
    if scheme not in _SCHEMES:
        raise ValueError(f"unknown roller scheme {scheme!r}; "
                         f"available: {sorted(_SCHEMES)}")
    body_fn = _SCHEMES[scheme]
    wall = sus.domain in ("single_wall", "single_wall_spectral")

    def step(r, generator: torch.Generator, carry: RollerCarry):
        with mesh_mod.replicated(sus.mesh):
            r_new, carry, aux = run_step(r, generator, carry)
            if mesh_mod.is_sharded(sus.mesh):
                r_new = mesh_mod.broadcast(sus.mesh, r_new)
        return r_new, carry, aux

    def run_step(r, generator, carry):
        if sus.domain == "single_wall_spectral" and carry.plan is None:
            built = init_carry(sus, positions=r)
            carry = carry._replace(plan=built.plan,
                                   rot_tables=built.rot_tables)
        drops = 0 if carry.plan is None else int(carry.plan.n_dropped_cells)
        attempts = 0
        while True:
            r_new, v, t, det_it, st_it = body_fn(sus, dt, generator, r,
                                                 carry)
            attempts += 1
            ok = not wall or mesh_mod.host_float(r_new[:, 2].min()) >= 0.0
            if ok or attempts >= max_rejections:
                break
        overlaps = (int((r_new[:, 2] < sus.blob_radius).sum())
                    if wall else 0)
        aux = RollerAux(velocities=v, torques=t, det_iterations=int(det_it),
                        stoch_iterations=int(st_it), rejections=attempts - 1,
                        wall_overlaps=overlaps, plan_drops=drops)
        plan = carry.plan
        if plan is not None:
            # next step's refresh then measures one step's drift only
            plan = ewald_wall.update_wall_plan(plan, r_new)
        return r_new, RollerCarry(velocities_prev=v, first_step=False,
                                  plan=plan, rot_tables=carry.rot_tables), aux

    return step


def simulate(sus: RollerSuspension, positions, generator, *, scheme, dt,
             n_steps, save_every=1, **kw):
    """n_steps steps from positions; returns (final positions, trajectory
    (n_steps // save_every, N, 3) of every save_every-th configuration,
    and the RollerAux of each saved step)."""
    step = make_stepper(sus, scheme, dt, **kw)
    carry = init_carry(sus, positions=positions)
    r = positions
    traj: List[torch.Tensor] = []
    auxs: List[RollerAux] = []
    for i in range(n_steps // save_every * save_every):
        r, carry, aux = step(r, generator, carry)
        if (i + 1) % save_every == 0:
            traj.append(r)
            auxs.append(aux)
    return (r, torch.stack(traj) if traj else r.new_zeros((0, *r.shape)),
            auxs)
