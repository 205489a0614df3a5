"""Temporal integrators for rigid multiblob Brownian dynamics (PyTorch).

Counterpart of rigidmultiblobswall_tpu/models/integrators.py. Each scheme
is a function `attempt(generator, state, carry)`; `make_stepper` wraps it
in the bounded wall-rejection retry (a host loop in place of the JAX
`lax.while_loop`), which redraws the Brownian increments on every retry.

Ported schemes:
  deterministic_forward_euler
  deterministic_adams_bashforth
  stochastic_Slip_Trapz          (the reference's recommended scheme)
The others, `update_PC > 1` and Krylov recycling wait for ROADMAP
Queue 1, item 17.

On periodic_spectral the carry holds the engine's plan across steps:
each step refreshes it at its start configuration (a full rebuild past
the drift budget), the RFD product and the corrector use it refreshed at
their own configurations, and the noise is the positively-split sample
(closed-form wave part plus Lanczos on the near field alone).

All noise comes from `draw_normal` and an explicit torch.Generator, in
the order W_slip, grid noise (spectral), Lanczos z.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from ..ops import ewald
from ..ops import forces as force_ops
from ..ops.lanczos import stochastic_forcing_lanczos
from . import kinematics as kin
from . import saddle, solvers
from .system import State, System, resolve_device

# schemes of the JAX package that the port has not taken over yet
_NOT_PORTED = (
    "articulated_deterministic_forward_euler_rollers",
    "articulated_deterministic_midpoint_rollers",
    "articulated_deterministic_forward_euler",
    "articulated_deterministic_midpoint",
    "deterministic_forward_euler_dense_algebra",
    "stochastic_adams_bashforth", "stochastic_first_order_RFD_dense_algebra",
    "Fixman", "stochastic_GDC_RFD", "stochastic_Slip_Mid",
    "stochastic_Slip_Mid_DLA", "stochastic_traction_AB",
    "deterministic_midpoint", "stochastic_EM", "stochastic_first_order_RFD",
    "stochastic_traction_EM",
)


class StepAux(NamedTuple):
    velocities: torch.Tensor  # (B,6) velocities used for the update
    det_iterations: int       # GMRES iterations this step
    stoch_iterations: int     # Lanczos iterations this step
    rejections: int           # wall-rejection retries this step
    solves_converged: bool = True
    capacity_overflows: int = 0  # particles the plan's cells (as of its
    #                              last full sort) and the linked-cell
    #                              force layout drop at the step's start


class Carry(NamedTuple):
    velocities_prev: torch.Tensor  # (B,6), for Adams-Bashforth
    first_step: bool
    plan: object = None   # the spectral engine's plan, carried across
    #                       steps (None for the pairwise engine)


def init_carry(system: System, dtype=torch.float64, state=None,
               device=None) -> Carry:
    """Carry of the first step; with `state`, on its device and dtype and
    with the spectral plan built at its configuration."""
    plan = None
    if state is not None:
        dtype, device = state.pos.dtype, state.pos.device
        if saddle.is_spectral(system):
            plan = saddle.maybe_dense_mobility(
                system, kin.blob_positions(system, state))
    else:
        device = resolve_device(device)
    return Carry(velocities_prev=torch.zeros((system.num_bodies, 6),
                                             dtype=dtype, device=device),
                 first_step=True, plan=plan)


def draw_normal(generator, shape, like):
    """Standard normal draws of `shape` from `generator`, returned on the
    device and in the dtype of `like`. Draws happen on the generator's
    device, so one seed gives the same noise on the CPU and the card."""
    z = torch.randn(shape, generator=generator, dtype=like.dtype,
                    device=generator.device)
    return z.to(like.device)


def _noise_slip(system, state, pc, generator, factor, tolerance, max_iter,
                check_every=1, plan=None):
    """sqrt(2 kT/dt) M^{1/2} W by preconditioned Lanczos.

    periodic_spectral: the positively-split sample instead, the closed-form
    wave part (ewald.wave_sqrt_noise of grid white noise) plus Lanczos on
    the near-field operator alone of the step's plan; independent
    parts add in covariance."""
    if saddle.is_spectral(system):
        w = draw_normal(generator, (3, *plan.params.grid), state.pos)
        uw = ewald.wave_sqrt_noise(plan, w).reshape(-1)
        z = draw_normal(generator, (3 * system.num_blobs,), state.pos)
        res = stochastic_forcing_lanczos(
            lambda f: ewald.real_matvec(plan, f.reshape(-1, 3)).reshape(-1),
            z, factor=factor, tolerance=tolerance, max_iter=max_iter,
            check_every=check_every)
        return res.noise + factor * uw, res.iterations
    mobility_pc, L_mult = saddle.make_noise_pc(system, state, pc,
                                               m_dense=plan)
    z = draw_normal(generator, (3 * system.num_blobs,), state.pos)
    res = stochastic_forcing_lanczos(mobility_pc, z, factor=factor,
                                     tolerance=tolerance, max_iter=max_iter,
                                     L_mult=L_mult, check_every=check_every)
    return res.noise, res.iterations


def _deterministic_forward_euler(system, dt, solver_kw, lanczos_kw,
                                 generator, state, carry, plan):
    sol = solvers.solve_mobility_problem(system, state, m_dense=plan,
                                         **solver_kw)
    new_state = kin.advance(state, sol.velocities, dt)
    return (new_state, sol.velocities, sol.iterations, 0,
            kin.valid_configuration(system, new_state), sol.converged)


def _deterministic_adams_bashforth(system, dt, solver_kw, lanczos_kw,
                                   generator, state, carry, plan):
    sol = solvers.solve_mobility_problem(system, state, m_dense=plan,
                                         **solver_kw)
    v_ab = (sol.velocities if carry.first_step
            else 1.5 * sol.velocities - 0.5 * carry.velocities_prev)
    new_state = kin.advance(state, v_ab, dt)
    return (new_state, sol.velocities, sol.iterations, 0,
            kin.valid_configuration(system, new_state), sol.converged)


def _stochastic_slip_trapz(system, dt, solver_kw, lanczos_kw, generator,
                           state, carry, plan):
    """Stochastic trapezoidal with slip-level thermal drift: 3 rigid solves
    (the first two in one lockstep loop) + 1 Lanczos + 2 M products + 2
    K^T products."""
    pc = saddle.build_block_diag_pc(system, state)
    factor = math.sqrt(2.0 * system.kT / dt)
    kT_over_delta = 2.0 * system.kT / system.rf_delta

    W_slip = draw_normal(generator, (system.num_blobs, 3), state.pos)
    r_blobs = kin.blob_positions(system, state)
    MxW = saddle._mobility_apply(system, r_blobs, plan, W_slip)
    KTxW = kin.KT_mul(system, state, W_slip)

    noise1, it_l = _noise_slip(system, state, pc, generator, factor,
                               plan=plan, **lanczos_kw)

    # the rigid solve and the RFD solve share the configuration: one
    # lockstep Krylov loop, one pair sweep per iteration for both columns
    rhs1 = solvers.build_rhs(system, state, r_blobs, noise_slip=noise1)
    rhs_rfd = torch.zeros_like(rhs1)
    rhs_rfd[:3 * system.num_blobs] = -W_slip.reshape(-1)
    lock_kw = {k: v for k, v in solver_kw.items() if k != "verbose"}
    sol_pair = solvers.solve_mobility_problem_lockstep(
        system, state, rhs=torch.stack([rhs1, rhs_rfd]), pc=pc,
        m_dense=plan, **lock_kw)
    lam1, v1 = sol_pair.lam[0], sol_pair.velocities[0]
    W_RFD = sol_pair.velocities[1]

    rfd_state = kin.advance(state, W_RFD, system.rf_delta)
    # the RFD product at the rf_delta-displaced configuration on the same
    # engine as MxW (a mismatch would be amplified by 1/rf_delta): the
    # spectral plan refreshed there, else one matrix-free sweep
    r_rfd = kin.blob_positions(system, rfd_state)
    m_rfd = saddle.refresh_dense_mobility(system, plan, r_rfd)
    M_rfd_xW = saddle._mobility_apply(system, r_rfd, m_rfd, W_slip)
    KT_rfd_xW = kin.KT_mul(system, rfd_state, W_slip)

    rand_slip_cor = noise1 + kT_over_delta * (M_rfd_xW - MxW).reshape(-1)
    rand_ft_cor = -kT_over_delta * (KT_rfd_xW - KTxW)

    predictor = kin.advance(state, v1, dt)
    ok_pred = kin.valid_configuration(system, predictor)
    # warm-start the corrector from the predictor solution, on the
    # step-start engine refreshed at the predictor
    m_pred = saddle.refresh_dense_mobility(
        system, plan, kin.blob_positions(system, predictor))
    x0 = torch.cat([lam1.reshape(-1), v1.reshape(-1)])
    sol2 = solvers.solve_mobility_problem(system, predictor, pc=pc,
                                          noise_slip=rand_slip_cor,
                                          noise_ft=rand_ft_cor, x0=x0,
                                          m_dense=m_pred, **solver_kw)
    velocities = 0.5 * (v1 + sol2.velocities)
    new_state = kin.advance(state, velocities, dt)
    ok = ok_pred and kin.valid_configuration(system, new_state)
    # the lockstep pair counts its batched sweeps once
    iters = sol_pair.iterations + sol2.iterations
    return (new_state, velocities, iters, it_l, ok,
            sol_pair.converged and bool(sol2.converged))


_SCHEMES = {
    "deterministic_forward_euler": _deterministic_forward_euler,
    "deterministic_adams_bashforth": _deterministic_adams_bashforth,
    "stochastic_Slip_Trapz": _stochastic_slip_trapz,
}


def make_stepper(system: System, scheme: str, dt: float, *,
                 tolerance: float = None,
                 lanczos_tolerance: float = 1e-6,
                 lanczos_max_iter: int = 64,
                 lanczos_check_every: int = 1,
                 gmres_restart: int = 60,
                 gmres_maxiter: int = 1000,
                 max_rejections: int = 50,
                 update_PC: int = 1,
                 verbose: bool = False) -> Callable:
    """Build step(state, generator, carry) -> (state, carry, StepAux).

    The wall-rejection loop retries the whole step with fresh Brownian
    increments, at most max_rejections attempts; a scheme that still lands
    invalid returns its last candidate and reports the retries in
    StepAux.rejections."""
    if scheme in _NOT_PORTED:
        raise NotImplementedError(
            f"scheme {scheme!r} is not ported yet (ROADMAP Queue 1, "
            "item 17); ported: " + ", ".join(_SCHEMES))
    if scheme not in _SCHEMES:
        raise ValueError(f"unknown scheme {scheme!r}; "
                         f"available: {sorted(_SCHEMES)}")
    if update_PC != 1:
        raise NotImplementedError("update_PC > 1 is not ported yet (ROADMAP "
                                  "Queue 1, item 17)")
    body_fn = _SCHEMES[scheme]
    solver_kw = dict(tol=tolerance, restart=gmres_restart,
                     maxiter=gmres_maxiter)
    if verbose:
        solver_kw["verbose"] = True
    lanczos_kw = dict(tolerance=lanczos_tolerance, max_iter=lanczos_max_iter,
                      check_every=lanczos_check_every)

    def step(state: State, generator: torch.Generator, carry: Carry):
        # the step's engine, resolved once here: the carried plan at this
        # step's start configuration (built here when the carry has none)
        plan = None
        if saddle.is_spectral(system):
            r0 = kin.blob_positions(system, state)
            plan = (saddle.maybe_dense_mobility(system, r0)
                    if carry.plan is None
                    else saddle.refresh_dense_mobility(system, carry.plan,
                                                       r0))
        attempts = 0
        while True:
            (new_state, velocities, det_it, st_it, ok,
             conv) = body_fn(system, dt, solver_kw, lanczos_kw, generator,
                             state, carry, plan)
            attempts += 1
            if ok or attempts >= max_rejections:
                break
        overflows = force_ops.neighbor_list_overflow(
            system, kin.blob_positions(system, state))
        if plan is not None:
            overflows += int(plan.n_dropped_cells)
        new_carry = Carry(velocities_prev=velocities, first_step=False,
                          plan=plan)
        aux = StepAux(velocities=velocities, det_iterations=int(det_it),
                      stoch_iterations=int(st_it), rejections=attempts - 1,
                      solves_converged=bool(conv),
                      capacity_overflows=overflows)
        return new_state, new_carry, aux

    return step
