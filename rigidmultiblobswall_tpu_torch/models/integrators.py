"""Temporal integrators for rigid multiblob Brownian dynamics (PyTorch).

Counterpart of rigidmultiblobswall_tpu/models/integrators.py. Each scheme
is a function `attempt(generator, state, carry)`; `make_stepper` wraps it
in the bounded wall-rejection retry (a host loop in place of the JAX
`lax.while_loop`), which redraws the Brownian increments on every retry.

Ported schemes:
  deterministic_forward_euler
  deterministic_adams_bashforth
  deterministic_midpoint
  stochastic_EM
  stochastic_first_order_RFD
  stochastic_traction_EM
  stochastic_adams_bashforth
  stochastic_traction_AB
  stochastic_Slip_Trapz          (the reference's recommended scheme)
  stochastic_Slip_Mid
  stochastic_GDC_RFD
  deterministic_forward_euler_dense_algebra
  stochastic_first_order_RFD_dense_algebra
  Fixman
  stochastic_Slip_Mid_DLA
  articulated_deterministic_forward_euler
  articulated_deterministic_midpoint
  articulated_deterministic_forward_euler_rollers   (single-blob bodies)
  articulated_deterministic_midpoint_rollers
with bodies of prescribed kinematics (obstacles), `update_PC > 1` (the
preconditioner refactored every update_PC steps; the carry of
`init_carry_with_pc`) and Krylov recycling (`init_carry(recycle_k=k)`,
or `make_stepper(recycle_k=k)`: the carry holds an ops/gmres.RecycleState
that deterministic forward Euler and Adams-Bashforth and Slip-Trapz
refresh once a step, deflate their solves with and harvest anew).

The articulated schemes solve with the constraint rows, move the bodies,
re-centre each instance (articulated.correct_center_of_mass) and project
it onto its constraints (articulated.nonlinear_projection). The carry's
step_idx (0 at the start, one more each step, also under update_PC > 1)
gives time-dependent links their time: t = step_idx dt at the step's
start, + dt/2 at the midpoint and + dt after. As in the JAX package they
factor their own preconditioner at the solve's time, also under
update_PC > 1 (whose cached preconditioner, factored at t = 0 links, they
leave unused), and the rollers' schemes solve on the grand mobility
(solvers.solve_mobility_problem_single_blob).

`simulate` runs the time loop (the JAX package's lax.scan, a host loop
here). Each attempt takes its mobility engine at the step's start
configuration (`_get_m_dense`): on the spectral domains the carry holds
the engine's plan across steps, each step refreshes it at its start
configuration (a full rebuild past the drift budget), the RFD products
and correctors use it refreshed at their own configurations, and the
noise is the positively-split sample: on periodic_spectral the
closed-form wave part plus Lanczos on the near field alone; on
single_wall_spectral the closed-form sample of the wave modes' positive
parts plus Lanczos on the near field less the sampler's defect, the
carry holding the noise factor tables on the device. The pairwise
domains build the materialized matrix within
saddle.MATERIALIZE_BUDGET_BYTES (kernel K3), rebuild it at a corrector's
configuration, and take the matrix-free sweep for single RFD products,
as the JAX package does; the carry holds no matrix.

All noise comes from `draw_normal` and an explicit torch.Generator, in
the order the JAX scheme splits its key (Slip-Trapz: W_slip, grid noise
(spectral), Lanczos z). Where the JAX scheme draws twice from one key
(GDC-RFD's midpoint noise on the pairwise domains), the port passes the
first draw on instead of drawing again.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from ..ops import ewald, ewald_wall
from ..ops import forces as force_ops
from ..ops.gmres import RecycleState
from ..ops import quaternion as quat
from ..ops.lanczos import stochastic_forcing_lanczos
from ..parallel import mesh as mesh_mod
from . import articulated as art_mod
from . import kinematics as kin
from . import saddle, solvers
from .system import State, System, resolve_device


class StepAux(NamedTuple):
    velocities: torch.Tensor  # (B,6) velocities used for the update
    det_iterations: int       # GMRES iterations this step
    stoch_iterations: int     # Lanczos iterations this step
    rejections: int           # wall-rejection retries this step
    solves_converged: bool = True
    capacity_overflows: int = 0  # particles the plan's cells (as of its
    #                              last full sort) and the linked-cell
    #                              force layout drop at the step's start,
    #                              plus, on the wall engine, the blobs its
    #                              slab and force cells clip


class Carry(NamedTuple):
    velocities_prev: torch.Tensor  # (B,6), for Adams-Bashforth
    first_step: bool
    plan: object = None   # the spectral engine's plan, carried across
    #                       steps (None for the pairwise engine)
    noise_factors: object = None  # single_wall_spectral: the wave noise
    #                       factor tables (ewald_wall.noise_factors), built
    #                       once and kept on the device; None otherwise
    recycle: object = None  # the Krylov recycle state (ops/gmres.
    #                       RecycleState) carried across steps; None when
    #                       recycling is off
    step_idx: int = 0     # steps taken, for time-dependent constraints


def init_carry(system: System, dtype=torch.float64, state=None,
               device=None, recycle_k: int = 0) -> Carry:
    """Carry of the first step; with `state`, on its device and dtype, with
    the spectral plan built at its configuration and, on
    single_wall_spectral at kT > 0, the noise factor tables. recycle_k > 0
    starts an empty Krylov recycle state of k directions."""
    plan = factors = None
    if state is not None:
        dtype, device = state.pos.dtype, state.pos.device
        if saddle.is_spectral(system):
            plan = saddle.maybe_dense_mobility(
                system, kin.blob_positions(system, state))
        if saddle.is_wall_spectral(system) and system.kT > 0:
            factors = ewald_wall.noise_factors(plan.params, dtype, device)
    else:
        device = resolve_device(device)
    rec = (RecycleState.empty(recycle_k, saddle.saddle_size(system), dtype,
                              device) if recycle_k > 0 else None)
    return Carry(velocities_prev=torch.zeros((system.num_bodies, 6),
                                             dtype=dtype, device=device),
                 first_step=True, plan=plan, noise_factors=factors,
                 recycle=rec)


def draw_normal(generator, shape, like):
    """Standard normal draws of `shape` from `generator`, returned on the
    device and in the dtype of `like`. Draws happen on the generator's
    device, so one seed gives the same noise on the CPU and the card."""
    z = torch.randn(shape, generator=generator, dtype=like.dtype,
                    device=generator.device)
    return z.to(like.device)


def _noise_slip(system, state, pc, generator, factor, tolerance, max_iter,
                check_every=1, plan=None, factors=None, z=None):
    """sqrt(2 kT/dt) M^{1/2} W by preconditioned Lanczos; on the pairwise
    domains from the given normals z when there are some.

    periodic_spectral: the positively-split sample instead, the closed-form
    wave part (ewald.wave_sqrt_noise of grid white noise) plus Lanczos on
    the near-field operator alone of the step's plan; independent
    parts add in covariance.
    single_wall_spectral: the damped closed-form sample of the wave modes'
    positive parts (ewald_wall.wave_sqrt_noise of (3 pz, gx, gy) white
    noise, with the carry's factor tables) plus Lanczos on D (M_near -
    Delta) D, Delta the sampler's defect: the covariances add to
    D (M_near + M_wave) D, D the overlap damping."""
    if saddle.is_wall_spectral(system):
        p = plan.params
        pz = p.noise_orders()[0]
        d = plan.damp[:, None]
        w = draw_normal(generator, (3 * pz, p.grid[0], p.grid[1]),
                        state.pos)
        uw = (d * ewald_wall.wave_sqrt_noise(plan, w, factors)).reshape(-1)
        z = draw_normal(generator, (3 * system.num_blobs,), state.pos)

        def near_minus_defect(f):
            f3 = d * f.reshape(-1, 3)
            out = (ewald_wall.near_matvec(plan, f3)
                   - ewald_wall.wave_defect_matvec(plan, f3, factors))
            return (d * out).reshape(-1)

        res = stochastic_forcing_lanczos(
            near_minus_defect, z, factor=factor, tolerance=tolerance,
            max_iter=max_iter, check_every=check_every)
        return res.noise + factor * uw, res.iterations
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
    if z is None:
        z = draw_normal(generator, (3 * system.num_blobs,), state.pos)
    res = stochastic_forcing_lanczos(mobility_pc, z, factor=factor,
                                     tolerance=tolerance, max_iter=max_iter,
                                     L_mult=L_mult, check_every=check_every)
    return res.noise, res.iterations


def body_lengths(system: System, like):
    """(B,) RFD length scale per body (body length + 2a), on the device
    and in the dtype of `like`."""
    return torch.cat([
        torch.full((t.count,), t.body_length + 2.0 * system.blob_radius,
                   dtype=like.dtype, device=like.device)
        for t in system.types])


def _get_pc(system, state, pc):
    """The stepper's cached preconditioner when update_PC > 1, else one
    factored at this state."""
    return pc if pc is not None else saddle.build_block_diag_pc(system, state)


def _get_m_dense(system, r_blobs, plan):
    """The step-start engine: the carried spectral plan (refreshed at this
    configuration by the stepper), else built at r_blobs: the
    materialized matrix within the budget, or None (matrix-free)."""
    if plan is not None:
        return plan
    return saddle.maybe_dense_mobility(system, r_blobs)


def _free_mask(system, like):
    """(B, 1) 1.0 for the free bodies, 0.0 for the prescribed ones."""
    return torch.as_tensor(~system.prescribed_body_mask, dtype=like.dtype,
                           device=like.device)[:, None]


def _det_recycle(system, state, carry, m_dense, pc=None):
    """(the carried recycle state refreshed at this configuration, one
    batched sweep of its k columns; the preconditioner it used), or
    (None, pc) when recycling is off. A preconditioner factored here
    serves the step's solve too (the JAX package factors the same one
    twice)."""
    if carry.recycle is None:
        return None, pc
    if pc is None:
        pc = saddle.build_block_diag_pc(system, state)
    return solvers.refresh_recycle(system, state, carry.recycle, pc=pc,
                                   m_dense=m_dense), pc


def _rfd_displacements(system, generator, state):
    """The random body displacement W (B,6) of the RFD schemes with its
    length-scaled displacement and conjugate force."""
    W = draw_normal(generator, (system.num_bodies, 6), state.pos)
    lengths = body_lengths(system, state.pos)[:, None]
    disp = torch.cat([W[:, :3] * lengths, W[:, 3:]], dim=1)
    force_rfd = torch.cat([W[:, :3] / lengths, W[:, 3:]], dim=1)
    return W, disp, force_rfd


def _displaced(state, W, disp, delta):
    """The state moved by delta along the RFD displacement."""
    return State(pos=state.pos + delta * disp[:, :3],
                 quat=quat.step(state.quat, W[:, 3:], delta))


def _deterministic_forward_euler(system, dt, solver_kw, lanczos_kw,
                                 generator, state, carry, plan, pc):
    m_dense = _get_m_dense(system, kin.blob_positions(system, state), plan)
    rec, pc = _det_recycle(system, state, carry, m_dense)
    sol = solvers.solve_mobility_problem(
        system, state, m_dense=m_dense, pc=pc, recycle=rec,
        collect_recycle=rec is not None, **solver_kw)
    new_state = kin.advance(state, sol.velocities, dt)
    return (new_state, sol.velocities, sol.iterations, 0,
            kin.valid_configuration(system, new_state), sol.converged,
            sol.recycle)


def _deterministic_adams_bashforth(system, dt, solver_kw, lanczos_kw,
                                   generator, state, carry, plan, pc):
    m_dense = _get_m_dense(system, kin.blob_positions(system, state), plan)
    rec, pc = _det_recycle(system, state, carry, m_dense)
    sol = solvers.solve_mobility_problem(
        system, state, m_dense=m_dense, pc=pc, recycle=rec,
        collect_recycle=rec is not None, **solver_kw)
    v_ab = (sol.velocities if carry.first_step
            else 1.5 * sol.velocities - 0.5 * carry.velocities_prev)
    new_state = kin.advance(state, v_ab, dt)
    return (new_state, sol.velocities, sol.iterations, 0,
            kin.valid_configuration(system, new_state), sol.converged,
            sol.recycle)


def _deterministic_midpoint(system, dt, solver_kw, lanczos_kw, generator,
                            state, carry, plan, pc):
    pc = _get_pc(system, state, pc)
    m_dense = _get_m_dense(system, kin.blob_positions(system, state), plan)
    sol1 = solvers.solve_mobility_problem(system, state, pc=pc,
                                          m_dense=m_dense, **solver_kw)
    mid = kin.advance(state, sol1.velocities, 0.5 * dt)
    ok_mid = kin.valid_configuration(system, mid)
    m_mid = saddle.refresh_dense_mobility(system, m_dense,
                                          kin.blob_positions(system, mid))
    x0 = torch.cat([sol1.lam.reshape(-1), sol1.velocities.reshape(-1)])
    sol2 = solvers.solve_mobility_problem(system, mid, pc=pc, x0=x0,
                                          m_dense=m_mid, **solver_kw)
    new_state = kin.advance(state, sol2.velocities, dt)
    ok = ok_mid and kin.valid_configuration(system, new_state)
    return (new_state, sol2.velocities, sol1.iterations + sol2.iterations,
            0, ok, bool(sol1.converged) and bool(sol2.converged))


def _stochastic_EM(system, dt, solver_kw, lanczos_kw, generator, state,
                   carry, plan, pc):
    pc = _get_pc(system, state, pc)
    factor = math.sqrt(2.0 * system.kT / dt)
    # one engine per step, shared by the noise Lanczos and the solve
    m_dense = _get_m_dense(system, kin.blob_positions(system, state), plan)
    noise, it_l = _noise_slip(system, state, pc, generator, factor,
                              plan=m_dense, factors=carry.noise_factors,
                              **lanczos_kw)
    sol = solvers.solve_mobility_problem(system, state, pc=pc,
                                         noise_slip=noise, m_dense=m_dense,
                                         **solver_kw)
    new_state = kin.advance(state, sol.velocities, dt)
    return (new_state, sol.velocities, sol.iterations, it_l,
            kin.valid_configuration(system, new_state), sol.converged)


def _stochastic_slip_trapz(system, dt, solver_kw, lanczos_kw, generator,
                           state, carry, plan, pc):
    """Stochastic trapezoidal with slip-level thermal drift: 3 rigid solves
    (the first two in one lockstep loop) + 1 Lanczos + 2 M products + 2
    K^T products."""
    pc = _get_pc(system, state, pc)
    factor = math.sqrt(2.0 * system.kT / dt)
    kT_over_delta = 2.0 * system.kT / system.rf_delta

    W_slip = draw_normal(generator, (system.num_blobs, 3), state.pos)
    r_blobs = kin.blob_positions(system, state)
    m_dense = _get_m_dense(system, r_blobs, plan)
    MxW = saddle._mobility_apply(system, r_blobs, m_dense, W_slip)
    KTxW = kin.KT_mul(system, state, W_slip)

    noise1, it_l = _noise_slip(system, state, pc, generator, factor,
                               plan=m_dense, factors=carry.noise_factors,
                               **lanczos_kw)

    # the carried recycle state, refreshed once at the step's start; every
    # solve of the step warm-starts (lockstep) or deflates with it
    rec, _ = _det_recycle(system, state, carry, m_dense, pc=pc)

    # the rigid solve and the RFD solve share the configuration: one
    # lockstep Krylov loop, one engine sweep per iteration for both columns
    rhs1 = solvers.build_rhs(system, state, r_blobs, noise_slip=noise1)
    rhs_rfd = torch.zeros_like(rhs1)
    rhs_rfd[:3 * system.num_blobs] = -W_slip.reshape(-1)
    lock_kw = {k: v for k, v in solver_kw.items() if k != "verbose"}
    sol_pair = solvers.solve_mobility_problem_lockstep(
        system, state, rhs=torch.stack([rhs1, rhs_rfd]), pc=pc,
        m_dense=m_dense, recycle=rec, collect_recycle=rec is not None,
        **lock_kw)
    lam1, v1 = sol_pair.lam[0], sol_pair.velocities[0]
    W_RFD = sol_pair.velocities[1] * _free_mask(system, state.pos)

    rfd_state = kin.advance(state, W_RFD, system.rf_delta)
    # the RFD product at the rf_delta-displaced configuration: the spectral
    # plan refreshed there; the pairwise domains take one matrix-free
    # sweep rather than a matrix built for one product
    r_rfd = kin.blob_positions(system, rfd_state)
    m_rfd = saddle.refresh_dense_mobility(system, m_dense, r_rfd,
                                          build=False)
    M_rfd_xW = saddle._mobility_apply(system, r_rfd, m_rfd, W_slip)
    KT_rfd_xW = kin.KT_mul(system, rfd_state, W_slip)

    rand_slip_cor = noise1 + kT_over_delta * (M_rfd_xW - MxW).reshape(-1)
    rand_ft_cor = -kT_over_delta * (KT_rfd_xW - KTxW)

    predictor = kin.advance(state, v1, dt)
    ok_pred = kin.valid_configuration(system, predictor)
    # warm-start the corrector from the predictor solution, on the engine
    # rebuilt (spectral: refreshed) at the predictor
    m_pred = saddle.refresh_dense_mobility(
        system, m_dense, kin.blob_positions(system, predictor))
    x0 = torch.cat([lam1.reshape(-1), v1.reshape(-1)])
    # the corrector is warm-started and deflated; the harvest is the
    # lockstep solve's (the corrector's Krylov space is nearly empty)
    sol2 = solvers.solve_mobility_problem(system, predictor, pc=pc,
                                          noise_slip=rand_slip_cor,
                                          noise_ft=rand_ft_cor, x0=x0,
                                          m_dense=m_pred, recycle=rec,
                                          **solver_kw)
    velocities = 0.5 * (v1 + sol2.velocities)
    new_state = kin.advance(state, velocities, dt)
    ok = ok_pred and kin.valid_configuration(system, new_state)
    # the lockstep pair counts its batched sweeps once
    iters = sol_pair.iterations + sol2.iterations
    rec_out = sol_pair.recycle if sol_pair.recycle is not None else rec
    return (new_state, velocities, iters, it_l, ok,
            sol_pair.converged and bool(sol2.converged), rec_out)


def _stochastic_first_order_RFD(system, dt, solver_kw, lanczos_kw,
                                generator, state, carry, plan, pc):
    """EM + RFD thermal drift kT div N by two extra solves at the
    +-delta/2 displaced configurations (the residual trick)."""
    pc = _get_pc(system, state, pc)
    factor = math.sqrt(2.0 * system.kT / dt)
    n3 = 3 * system.num_blobs
    # one engine at the step start; the +-delta/2 configurations refresh
    # it (spectral) or build their own ("auto")
    m_dense = _get_m_dense(system, kin.blob_positions(system, state), plan)
    noise, it_l = _noise_slip(system, state, pc, generator, factor,
                              plan=m_dense, factors=carry.noise_factors,
                              **lanczos_kw)
    sol = solvers.solve_mobility_problem(system, state, pc=pc,
                                         noise_slip=noise, m_dense=m_dense,
                                         **solver_kw)

    W, disp, force_rfd = _rfd_displacements(system, generator, state)
    delta = system.rf_delta
    rhs_rfd = torch.cat([torch.zeros_like(noise[:n3]),
                         -force_rfd.reshape(-1)])
    spectral = saddle.is_spectral(system)
    state_minus = _displaced(state, W, disp, -0.5 * delta)
    m_minus = (saddle.refresh_dense_mobility(
        system, m_dense, kin.blob_positions(system, state_minus))
        if spectral else "auto")
    sol_minus = solvers.solve_mobility_problem(system, state_minus, pc=pc,
                                               rhs=rhs_rfd, m_dense=m_minus,
                                               **solver_kw)
    state_plus = _displaced(state, W, disp, 0.5 * delta)
    r_plus = kin.blob_positions(system, state_plus)
    m_plus = (saddle.refresh_dense_mobility(system, m_dense, r_plus)
              if spectral else None)
    op_plus = saddle.make_linear_operator(system, state_plus, r_plus,
                                          m_dense=m_plus)
    x_minus = torch.cat([sol_minus.lam.reshape(-1),
                         sol_minus.velocities.reshape(-1)])
    # residual trick: N(x+) rhs - N(x-) rhs to O(delta)
    sol_drift = solvers.solve_mobility_problem(
        system, state_plus, pc=pc, rhs=rhs_rfd - op_plus(x_minus),
        m_dense=m_plus if spectral else "auto", **solver_kw)

    velocities = sol.velocities + (system.kT / delta) * sol_drift.velocities
    new_state = kin.advance(state, velocities, dt)
    iters = sol.iterations + sol_minus.iterations + sol_drift.iterations
    conv = (bool(sol.converged) and bool(sol_minus.converged)
            and bool(sol_drift.converged))
    return (new_state, velocities, iters, it_l,
            kin.valid_configuration(system, new_state), conv)


def _stochastic_traction_EM(system, dt, solver_kw, lanczos_kw, generator,
                            state, carry, plan, pc):
    """EM with the RFD drift taken at the traction level: 2 rigid solves +
    1 Lanczos + 2 M products + 4 K products."""
    pc = _get_pc(system, state, pc)
    factor = math.sqrt(2.0 * system.kT / dt)
    kT_over_delta = 2.0 * system.kT / system.rf_delta

    W_slip = draw_normal(generator, (system.num_blobs, 3), state.pos)
    r_blobs = kin.blob_positions(system, state)
    # one engine at the step start, shared by the M products, the RFD
    # solve, the noise and the drift-corrected solve; both sides of the
    # RFD difference take the same engine (a mismatch would be amplified
    # by 1/rf_delta)
    m_dense = _get_m_dense(system, r_blobs, plan)
    MxW = saddle._mobility_apply(system, r_blobs, m_dense, W_slip)
    KTxW = kin.KT_mul(system, state, W_slip)

    # the rigid-body motion consistent with W_slip displaces the RFD state
    rhs_rfd = torch.cat([-W_slip.reshape(-1),
                         torch.zeros(6 * system.num_bodies,
                                     dtype=W_slip.dtype,
                                     device=W_slip.device)])
    sol_rfd = solvers.solve_mobility_problem(system, state, rhs=rhs_rfd,
                                             pc=pc, m_dense=m_dense,
                                             **solver_kw)
    rfd_state = kin.advance(state, sol_rfd.velocities, system.rf_delta)
    r_rfd = kin.blob_positions(system, rfd_state)
    m_rfd = saddle.refresh_dense_mobility(system, m_dense, r_rfd,
                                          build=False)
    M_rfd_xW = saddle._mobility_apply(system, r_rfd, m_rfd, W_slip)
    KT_rfd_xW = kin.KT_mul(system, rfd_state, W_slip)

    noise, it_l = _noise_slip(system, state, pc, generator, factor,
                              plan=m_dense, factors=carry.noise_factors,
                              **lanczos_kw)
    rand_slip = noise + kT_over_delta * (M_rfd_xW - MxW).reshape(-1)
    rand_ft = -kT_over_delta * (KT_rfd_xW - KTxW)
    sol = solvers.solve_mobility_problem(system, state, pc=pc,
                                         noise_slip=rand_slip,
                                         noise_ft=rand_ft, m_dense=m_dense,
                                         **solver_kw)
    new_state = kin.advance(state, sol.velocities, dt)
    return (new_state, sol.velocities, sol_rfd.iterations + sol.iterations,
            it_l, kin.valid_configuration(system, new_state),
            bool(sol_rfd.converged) and bool(sol.converged))


def _stochastic_slip_mid(system, dt, solver_kw, lanczos_kw, generator,
                         state, carry, plan, pc):
    """Stochastic midpoint with slip-level drift: 3 rigid solves (the
    first two in one lockstep loop) + 2 Lanczos."""
    pc = _get_pc(system, state, pc)
    n3 = 3 * system.num_blobs

    W_slip = draw_normal(generator, (system.num_blobs, 3), state.pos)
    r_blobs = kin.blob_positions(system, state)
    # one engine at the step start, shared by the M products, the noise
    # Lanczos and the lockstep solve
    m_dense = _get_m_dense(system, r_blobs, plan)
    MxW = saddle._mobility_apply(system, r_blobs, m_dense, W_slip)
    KTxW = kin.KT_mul(system, state, W_slip)

    mobility_pc, L_mult = saddle.make_noise_pc(system, state, pc,
                                               r_blobs=r_blobs,
                                               m_dense=m_dense)
    W1 = draw_normal(generator, (n3,), state.pos)
    Wcor = W1 + draw_normal(generator, (n3,), state.pos)
    noise_W1 = stochastic_forcing_lanczos(
        mobility_pc, W1, factor=math.sqrt(4.0 * system.kT / dt),
        L_mult=L_mult, **lanczos_kw)
    noise_Wcor = stochastic_forcing_lanczos(
        mobility_pc, Wcor, factor=math.sqrt(system.kT / dt), L_mult=L_mult,
        **lanczos_kw)

    # the midpoint solve and the RFD solve share the configuration: one
    # lockstep Krylov loop
    rhs_mid = solvers.build_rhs(system, state, r_blobs,
                                noise_slip=noise_W1.noise)
    rhs_rfd = torch.zeros_like(rhs_mid)
    rhs_rfd[:n3] = -W_slip.reshape(-1)
    lock_kw = {k: v for k, v in solver_kw.items() if k != "verbose"}
    sol_pair = solvers.solve_mobility_problem_lockstep(
        system, state, rhs=torch.stack([rhs_mid, rhs_rfd]), pc=pc,
        m_dense=m_dense, **lock_kw)
    lam_mid, v_mid = sol_pair.lam[0], sol_pair.velocities[0]
    W_RFD = sol_pair.velocities[1] * _free_mask(system, state.pos)

    rfd_state = kin.advance(state, W_RFD, system.rf_delta)
    r_rfd = kin.blob_positions(system, rfd_state)
    m_rfd = saddle.refresh_dense_mobility(system, m_dense, r_rfd,
                                          build=False)
    M_rfd_xW = saddle._mobility_apply(system, r_rfd, m_rfd, W_slip)
    KT_rfd_xW = kin.KT_mul(system, rfd_state, W_slip)

    kT_over_delta = system.kT / system.rf_delta
    rand_slip_cor = (noise_Wcor.noise
                     + kT_over_delta * (M_rfd_xW - MxW).reshape(-1))
    rand_ft_cor = -kT_over_delta * (KT_rfd_xW - KTxW)

    mid = kin.advance(state, v_mid, 0.5 * dt)
    ok_mid = kin.valid_configuration(system, mid)
    m_mid = saddle.refresh_dense_mobility(system, m_dense,
                                          kin.blob_positions(system, mid))
    x0 = torch.cat([lam_mid.reshape(-1), v_mid.reshape(-1)])
    sol_cor = solvers.solve_mobility_problem(system, mid, pc=pc,
                                             noise_slip=rand_slip_cor,
                                             noise_ft=rand_ft_cor, x0=x0,
                                             m_dense=m_mid, **solver_kw)
    new_state = kin.advance(state, sol_cor.velocities, dt)
    ok = ok_mid and kin.valid_configuration(system, new_state)
    return (new_state, sol_cor.velocities,
            sol_pair.iterations + sol_cor.iterations,
            noise_W1.iterations + noise_Wcor.iterations, ok,
            sol_pair.converged and bool(sol_cor.converged))


def _stochastic_traction_AB(system, dt, solver_kw, lanczos_kw, generator,
                            state, carry, plan, pc):
    """Adams-Bashforth with traction-level RFD: 3 rigid solves (two in one
    lockstep loop) + 1 Lanczos. The carry keeps the deterministic
    velocity alone."""
    pc = _get_pc(system, state, pc)
    n3 = 3 * system.num_blobs
    delta = system.rf_delta
    lengths = body_lengths(system, state.pos)[:, None]

    rfd_noise = draw_normal(generator, (system.num_bodies, 6), state.pos)
    W = torch.cat([rfd_noise[:, :3] * (system.kT / lengths),
                   rfd_noise[:, 3:] * system.kT], dim=1)
    rhs_rand = torch.cat([torch.zeros(n3, dtype=W.dtype, device=W.device),
                          -W.reshape(-1)])
    r_blobs = kin.blob_positions(system, state)
    # one engine at the step start, shared by the RFD solve, the M
    # products, the noise Lanczos and the lockstep solve
    m_dense = _get_m_dense(system, r_blobs, plan)
    sol_rfd = solvers.solve_mobility_problem(system, state, rhs=rhs_rand,
                                             pc=pc, m_dense=m_dense,
                                             **solver_kw)
    U_RFD, Lam_RFD = sol_rfd.velocities, sol_rfd.lam
    MxLam = saddle._mobility_apply(system, r_blobs, m_dense, Lam_RFD)
    KTxLam = kin.KT_mul(system, state, Lam_RFD)
    KxU = kin.K_mul(system, state, U_RFD)

    rfd_state = State(
        pos=state.pos + delta * lengths * rfd_noise[:, :3],
        quat=quat.step(state.quat, rfd_noise[:, 3:], delta))
    r_rfd = kin.blob_positions(system, rfd_state)
    m_rfd = saddle.refresh_dense_mobility(system, m_dense, r_rfd,
                                          build=False)
    DxM = saddle._mobility_apply(system, r_rfd, m_rfd, Lam_RFD) - MxLam
    DxKT = kin.KT_mul(system, rfd_state, Lam_RFD) - KTxLam
    DxK = kin.K_mul(system, rfd_state, U_RFD) - KxU

    noise, it_l = _noise_slip(system, state, pc, generator,
                              math.sqrt(2.0 * system.kT / dt), plan=m_dense,
                              factors=carry.noise_factors, **lanczos_kw)
    rand_slip = (DxM - DxK).reshape(-1) / delta
    rand_ft = -DxKT / delta

    # the drift-corrected solve and the noise solve share the
    # configuration: one lockstep Krylov loop
    rhs_new = solvers.build_rhs(system, state, r_blobs,
                                noise_slip=rand_slip, noise_ft=rand_ft)
    rhs_noise = torch.zeros_like(rhs_new)
    rhs_noise[:n3] = -noise
    lock_kw = {k: v for k, v in solver_kw.items() if k != "verbose"}
    sol_pair = solvers.solve_mobility_problem_lockstep(
        system, state, rhs=torch.stack([rhs_new, rhs_noise]), pc=pc,
        m_dense=m_dense, **lock_kw)
    v_det, v_noise = sol_pair.velocities[0], sol_pair.velocities[1]
    v_ab = (v_det + v_noise if carry.first_step
            else 1.5 * v_det + v_noise - 0.5 * carry.velocities_prev)
    new_state = kin.advance(state, v_ab, dt)
    return (new_state, v_det, sol_rfd.iterations + sol_pair.iterations,
            it_l, kin.valid_configuration(system, new_state),
            bool(sol_rfd.converged) and sol_pair.converged)


def _unpc_noise(system, state, generator, factor, tolerance, max_iter,
                check_every=1, plan=None):
    """Plain factor M^{1/2} z (no preconditioner) for the GDC-RFD scheme;
    returns (noise, iterations, z)."""
    r_blobs = kin.blob_positions(system, state)

    def mtt(v):
        return saddle._mobility_apply(system, r_blobs, plan,
                                      v.reshape(-1, 3)).reshape(-1)

    z = draw_normal(generator, (3 * system.num_blobs,), state.pos)
    res = stochastic_forcing_lanczos(mtt, z, factor=factor,
                                     tolerance=tolerance, max_iter=max_iter,
                                     check_every=check_every)
    return res.noise, res.iterations, z


def _stochastic_GDC_RFD(system, dt, solver_kw, lanczos_kw, generator, state,
                        carry, plan, pc):
    """Generalized drifter-corrector: 1 constrained solve + 3 Lanczos + 2
    exact M = I solves. Its preconditioner is factored at the midpoint
    (update_PC's cached one is not used, as in the JAX package)."""
    factor = math.sqrt(2.0 * system.kT / dt)
    delta = system.rf_delta
    zeros_b = torch.zeros(6 * system.num_bodies, dtype=state.pos.dtype,
                          device=state.pos.device)

    m_start = _get_m_dense(system, kin.blob_positions(system, state), plan)
    noise_n, it1, z = _unpc_noise(system, state, generator, factor,
                                  plan=m_start, **lanczos_kw)
    U_n = saddle.split_saddle_vector(
        system, saddle.apply_identity_saddle_solver(
            system, state, torch.cat([-noise_n, zeros_b])))[1]

    # one-sided RFD of the unconstrained velocity's divergence, the same
    # z at the displaced configuration
    W = draw_normal(generator, (system.num_bodies, 6), state.pos)
    lengths = body_lengths(system, state.pos)[:, None]
    rfd_state = State(pos=state.pos + delta * lengths * W[:, :3],
                      quat=quat.step(state.quat, W[:, 3:], delta))
    r_rfd = kin.blob_positions(system, rfd_state)
    m_rfd = (saddle.refresh_dense_mobility(system, m_start, r_rfd,
                                           build=False)
             if saddle.is_spectral(system) else None)

    def mtt_rfd(v):
        return saddle._mobility_apply(system, r_rfd, m_rfd,
                                      v.reshape(-1, 3)).reshape(-1)

    res_rfd = stochastic_forcing_lanczos(mtt_rfd, z, factor=factor,
                                         **lanczos_kw)
    U_rfd = saddle.split_saddle_vector(
        system, saddle.apply_identity_saddle_solver(
            system, rfd_state, torch.cat([-res_rfd.noise, zeros_b])))[1]
    dU = U_rfd - U_n
    div = (torch.sum(dU[:, :3] * W[:, :3] / (delta * lengths))
           + torch.sum(dU[:, 3:] * W[:, 3:]) / delta)

    mid = kin.advance(state, U_n, 0.5 * dt)
    ok_mid = kin.valid_configuration(system, mid)
    pc_mid = saddle.build_block_diag_pc(system, mid)
    m_mid = saddle.refresh_dense_mobility(system, m_start,
                                          kin.blob_positions(system, mid))
    # the JAX scheme draws the midpoint noise from z's key again: the
    # pairwise domains take the same z; the spectral ones split the key
    # and draw anew
    noise_mid, it3 = _noise_slip(
        system, mid, pc_mid, generator, factor, plan=m_mid,
        factors=carry.noise_factors,
        z=None if saddle.is_spectral(system) else z, **lanczos_kw)
    sol_mid = solvers.solve_mobility_problem(system, mid, pc=pc_mid,
                                             noise_slip=noise_mid,
                                             m_dense=m_mid, **solver_kw)
    correction = 1.0 + 0.5 * dt * div
    new_state = kin.advance(state, sol_mid.velocities * correction, dt)
    ok = ok_mid and kin.valid_configuration(system, new_state)
    return (new_state, sol_mid.velocities, sol_mid.iterations,
            it1 + res_rfd.iterations + it3, ok, sol_mid.converged)


def _dense_sqrt_mul(N, z, factor):
    """factor N^{1/2} z by a dense eigendecomposition."""
    w, q = torch.linalg.eigh(N)
    w = torch.sqrt(torch.clamp(w, min=0.0))
    return factor * (q @ (w * (q.T @ z)))


def _stochastic_adams_bashforth(system, dt, solver_kw, lanczos_kw,
                                generator, state, carry, plan, pc):
    """AB2 deterministic + EM noise + RFD drift (two solves at the
    +-delta/2 displaced configurations)."""
    pc = _get_pc(system, state, pc)
    factor = math.sqrt(2.0 * system.kT / dt)
    n3 = 3 * system.num_blobs

    r_blobs = kin.blob_positions(system, state)
    # one engine at the step start, shared by the noise Lanczos and the
    # lockstep solve
    m_dense = _get_m_dense(system, r_blobs, plan)
    noise, it_l = _noise_slip(system, state, pc, generator, factor,
                              plan=m_dense, factors=carry.noise_factors,
                              **lanczos_kw)
    rhs_det = solvers.build_rhs(system, state, r_blobs)
    rhs_stoch = torch.zeros_like(rhs_det)
    rhs_stoch[:n3] = -noise.reshape(-1)
    lock_kw = {k: v for k, v in solver_kw.items() if k != "verbose"}
    sol_pair = solvers.solve_mobility_problem_lockstep(
        system, state, rhs=torch.stack([rhs_stoch, rhs_det]), pc=pc,
        m_dense=m_dense, **lock_kw)
    v_stoch, v_det = sol_pair.velocities[0], sol_pair.velocities[1]

    W, disp, force_rfd = _rfd_displacements(system, generator, state)
    delta = system.rf_delta
    rhs_rfd = torch.cat([torch.zeros_like(rhs_det[:n3]),
                         -force_rfd.reshape(-1)])
    # the +-delta/2 engines: spectral plans refresh; the pairwise domains
    # build their own ("auto"), so at most two matrices are live
    spectral = saddle.is_spectral(system)
    state_minus = _displaced(state, W, disp, -0.5 * delta)
    m_minus = (saddle.refresh_dense_mobility(
        system, m_dense, kin.blob_positions(system, state_minus))
        if spectral else "auto")
    sol_minus = solvers.solve_mobility_problem(system, state_minus, pc=pc,
                                               rhs=rhs_rfd, m_dense=m_minus,
                                               **solver_kw)
    state_plus = _displaced(state, W, disp, 0.5 * delta)
    r_plus = kin.blob_positions(system, state_plus)
    m_plus = (saddle.refresh_dense_mobility(system, m_dense, r_plus)
              if spectral else None)
    op_plus = saddle.make_linear_operator(system, state_plus, r_plus,
                                          m_dense=m_plus)
    x_minus = torch.cat([sol_minus.lam.reshape(-1),
                         sol_minus.velocities.reshape(-1)])
    # residual trick: N(x+) rhs - N(x-) rhs to O(delta)
    sol_drift = solvers.solve_mobility_problem(
        system, state_plus, pc=pc, rhs=rhs_rfd - op_plus(x_minus),
        m_dense=m_plus if spectral else "auto", **solver_kw)
    v_stoch = v_stoch + (system.kT / delta) * sol_drift.velocities

    v_ab = (v_det if carry.first_step
            else 1.5 * v_det - 0.5 * carry.velocities_prev)
    new_state = kin.advance(state, v_ab + v_stoch, dt)
    iters = (sol_pair.iterations + sol_minus.iterations
             + sol_drift.iterations)
    conv = (sol_pair.converged and bool(sol_minus.converged)
            and bool(sol_drift.converged))
    # the carry keeps the deterministic velocity alone
    return (new_state, v_det, iters, it_l,
            kin.valid_configuration(system, new_state), conv)


def _deterministic_forward_euler_dense(system, dt, solver_kw, lanczos_kw,
                                       generator, state, carry, plan, pc):
    v, _ = solvers.solve_mobility_problem_dense(system, state)
    new_state = kin.advance(state, v, dt)
    return (new_state, v, 0, 0, kin.valid_configuration(system, new_state),
            True)


def _stochastic_first_order_RFD_dense(system, dt, solver_kw, lanczos_kw,
                                      generator, state, carry, plan, pc):
    """Dense-algebra RFD scheme: N^{1/2} noise and kT/delta (N(x + delta
    W) - N(x)) F_rfd drift."""
    v, N = solvers.solve_mobility_problem_dense(system, state)
    z = draw_normal(generator, (6 * system.num_bodies,), state.pos)
    v = v + _dense_sqrt_mul(N, z, math.sqrt(2.0 * system.kT / dt)).reshape(
        system.num_bodies, 6)
    W, disp, force_rfd = _rfd_displacements(system, generator, state)
    delta = system.rf_delta
    N_plus = solvers.solve_body_mobility(system,
                                         _displaced(state, W, disp, delta))
    v = v + (system.kT / delta) * ((N_plus - N) @ force_rfd.reshape(-1)
                                   ).reshape(system.num_bodies, 6)
    new_state = kin.advance(state, v, dt)
    return (new_state, v, 0, 0, kin.valid_configuration(system, new_state),
            True)


def _dense_pieces(system, state):
    """Dense solve ingredients of the DLA schemes: velocities and the dense
    M, R = M^{-1}, K and N = pinv(K^T R K)."""
    r_blobs = kin.blob_positions(system, state)
    slip = kin.active_slip(system, state)
    if system.slip_fn is not None:
        slip = slip + system.slip_fn(system, state).reshape(slip.shape)
    FT = solvers.force_torque_calculator(system, state, r_blobs)
    M = solvers.dense_blob_mobility(system, state)
    K = solvers._dense_K(system, state)
    R = torch.linalg.inv(M)
    N = torch.linalg.pinv(K.T @ (R @ K))
    v = N @ (FT.reshape(-1) - K.T @ (R @ slip.reshape(-1)))
    return v, N, M, R, K


def _stochastic_slip_mid_dla(system, dt, solver_kw, lanczos_kw, generator,
                             state, carry, plan, pc):
    """Slip-midpoint scheme with dense linear algebra: predictor noise
    N K^T M^{-1} M^{1/2} W1 at sqrt(4kT/dt), RFD displacement
    W_RFD = N K^T M^{-1} W_slip probing the divergence of M and K^T, and a
    corrector with the summed increment Wcor = W1 + W1'."""
    B = system.num_bodies
    n3 = 3 * system.num_blobs
    delta = system.rf_delta
    v_mid, N, M, R, K = _dense_pieces(system, state)

    W1 = draw_normal(generator, (n3,), state.pos)
    W_slip = draw_normal(generator, (n3,), state.pos)
    Wcor = W1 + draw_normal(generator, (n3,), state.pos)

    W_RFD = N @ (K.T @ (R @ W_slip))
    MxW_slip = M @ W_slip
    KTxW_slip = K.T @ W_slip
    Mhalf_W1 = _dense_sqrt_mul(M, W1, 1.0)
    Mhalf_Wcor = _dense_sqrt_mul(M, Wcor, 1.0)
    v_mid = v_mid + math.sqrt(4.0 * system.kT / dt) * (
        N @ (K.T @ (R @ Mhalf_W1)))

    # the RFD configuration: displace by W_RFD delta and difference M, K^T
    rfd_state = kin.advance(state, W_RFD.reshape(B, 6), delta)
    DxM = solvers.dense_blob_mobility(system, rfd_state) @ W_slip - MxW_slip
    DxKT = solvers._dense_K(system, rfd_state).T @ W_slip - KTxW_slip

    mid = kin.advance(state, v_mid.reshape(B, 6), 0.5 * dt)
    ok_mid = kin.valid_configuration(system, mid)
    v_new, N2, _, R2, K2 = _dense_pieces(system, mid)
    rhs_cor = (-(system.kT / delta) * DxKT
               + K2.T @ (R2 @ (math.sqrt(system.kT / dt) * Mhalf_Wcor
                               + (system.kT / delta) * DxM)))
    v_new = (v_new + N2 @ rhs_cor).reshape(B, 6)
    new_state = kin.advance(state, v_new, dt)
    ok = ok_mid and kin.valid_configuration(system, new_state)
    return new_state, v_new, 0, 0, ok, True


def _fixman(system, dt, solver_kw, lanczos_kw, generator, state, carry,
            plan, pc):
    """Fixman midpoint with dense algebra."""
    B = system.num_bodies
    v_mid, N = solvers.solve_mobility_problem_dense(system, state)
    W1 = draw_normal(generator, (6 * B,), state.pos)
    W_cor = W1 + draw_normal(generator, (6 * B,), state.pos)
    Nhalf_W1 = _dense_sqrt_mul(N, W1, math.sqrt(4.0 * system.kT / dt))
    Nhalf_Wcor = _dense_sqrt_mul(N, W_cor, math.sqrt(system.kT / dt))
    Ninvhalf_cor = torch.linalg.pinv(N) @ Nhalf_Wcor
    v_mid = v_mid + Nhalf_W1.reshape(B, 6)
    mid = kin.advance(state, v_mid, 0.5 * dt)
    ok_mid = kin.valid_configuration(system, mid)
    v_new, N_new = solvers.solve_mobility_problem_dense(system, mid)
    v_new = v_new + (N_new @ Ninvhalf_cor).reshape(B, 6)
    new_state = kin.advance(state, v_new, dt)
    ok = ok_mid and kin.valid_configuration(system, new_state)
    return new_state, v_new, 0, 0, ok, True


def _articulated_update(system, state, velocities, dt, t_end, fraction=1.0):
    """Advance state by velocities over fraction dt, re-centre each
    articulated instance and project it onto its constraints at t_end."""
    moved = kin.advance(state, velocities, fraction * dt)
    moved = art_mod.correct_center_of_mass(system, moved, state, velocities,
                                           dt, time=t_end,
                                           midpoint_fraction=fraction)
    return art_mod.nonlinear_projection(
        system, moved, time=t_end, tol=system.nonlinear_solver_tolerance)


def _articulated_deterministic_forward_euler(system, dt, solver_kw,
                                             lanczos_kw, generator, state,
                                             carry, plan, pc):
    """Forward Euler for articulated bodies: the constrained solve at t,
    the update at t + dt."""
    t_now = carry.step_idx * dt
    m_dense = _get_m_dense(system, kin.blob_positions(system, state), plan)
    sol = solvers.solve_mobility_problem(system, state, time=t_now,
                                         m_dense=m_dense, **solver_kw)
    new = _articulated_update(system, state, sol.velocities, dt, t_now + dt)
    return (new, sol.velocities, sol.iterations, 0,
            kin.valid_configuration(system, new), sol.converged)


def _articulated_deterministic_midpoint(system, dt, solver_kw, lanczos_kw,
                                        generator, state, carry, plan, pc):
    """Midpoint for articulated bodies: the half step's configuration is
    re-centred and projected at t + dt/2, its solve warm-started from the
    first one's [lam, U, phi]."""
    t_now = carry.step_idx * dt
    m_dense = _get_m_dense(system, kin.blob_positions(system, state), plan)
    sol1 = solvers.solve_mobility_problem(system, state, time=t_now,
                                          m_dense=m_dense, **solver_kw)
    mid = _articulated_update(system, state, sol1.velocities, dt,
                              t_now + 0.5 * dt, fraction=0.5)
    x0 = torch.cat([sol1.lam.reshape(-1), sol1.velocities.reshape(-1),
                    sol1.phi.reshape(-1)])
    m_mid = saddle.refresh_dense_mobility(system, m_dense,
                                          kin.blob_positions(system, mid))
    sol2 = solvers.solve_mobility_problem(system, mid, time=t_now + 0.5 * dt,
                                          x0=x0, m_dense=m_mid, **solver_kw)
    new = _articulated_update(system, state, sol2.velocities, dt, t_now + dt)
    return (new, sol2.velocities, sol1.iterations + sol2.iterations, 0,
            kin.valid_configuration(system, new),
            bool(sol1.converged) and bool(sol2.converged))


def _articulated_single_blob_scheme(midpoint):
    """Forward Euler or midpoint of articulated single-blob bodies (the
    articulated rollers): the articulated update driven by the constrained
    solve on the grand mobility. Every body type must hold one blob."""

    def scheme(system, dt, solver_kw, lanczos_kw, generator, state, carry,
               plan, pc):
        t_now = carry.step_idx * dt
        sol = solvers.solve_mobility_problem_single_blob(
            system, state, time=t_now, **solver_kw)
        iters, conv = sol.iterations, bool(sol.converged)
        if midpoint:
            mid = _articulated_update(system, state, sol.velocities, dt,
                                      t_now + 0.5 * dt, fraction=0.5)
            sol = solvers.solve_mobility_problem_single_blob(
                system, mid, time=t_now + 0.5 * dt, **solver_kw)
            iters += sol.iterations
            conv = conv and bool(sol.converged)
        new = _articulated_update(system, state, sol.velocities, dt,
                                  t_now + dt)
        return (new, sol.velocities, iters, 0,
                kin.valid_configuration(system, new), conv)

    return scheme


_SCHEMES = {
    "deterministic_forward_euler": _deterministic_forward_euler,
    "deterministic_adams_bashforth": _deterministic_adams_bashforth,
    "deterministic_midpoint": _deterministic_midpoint,
    "stochastic_EM": _stochastic_EM,
    "stochastic_first_order_RFD": _stochastic_first_order_RFD,
    "stochastic_traction_EM": _stochastic_traction_EM,
    "stochastic_adams_bashforth": _stochastic_adams_bashforth,
    "stochastic_traction_AB": _stochastic_traction_AB,
    "stochastic_Slip_Trapz": _stochastic_slip_trapz,
    "stochastic_Slip_Mid": _stochastic_slip_mid,
    "stochastic_GDC_RFD": _stochastic_GDC_RFD,
    "deterministic_forward_euler_dense_algebra":
        _deterministic_forward_euler_dense,
    "stochastic_first_order_RFD_dense_algebra":
        _stochastic_first_order_RFD_dense,
    "Fixman": _fixman,
    "stochastic_Slip_Mid_DLA": _stochastic_slip_mid_dla,
    "articulated_deterministic_forward_euler":
        _articulated_deterministic_forward_euler,
    "articulated_deterministic_midpoint":
        _articulated_deterministic_midpoint,
    "articulated_deterministic_forward_euler_rollers":
        _articulated_single_blob_scheme(midpoint=False),
    "articulated_deterministic_midpoint_rollers":
        _articulated_single_blob_scheme(midpoint=True),
}


def available_schemes():
    """The names of the multibody schemes make_stepper runs."""
    return tuple(_SCHEMES)


def make_stepper(system: System, scheme: str, dt: float, *,
                 tolerance: float = None,
                 lanczos_tolerance: float = 1e-6,
                 lanczos_max_iter: int = 64,
                 lanczos_check_every: int = 1,
                 gmres_restart: int = 60,
                 gmres_maxiter: int = 1000,
                 max_rejections: int = 50,
                 update_PC: int = 1,
                 recycle_k: int = 0,
                 verbose: bool = False) -> Callable:
    """Build step(state, generator, carry) -> (state, carry, StepAux).

    The wall-rejection loop retries the whole step with fresh Brownian
    increments, at most max_rejections attempts; a scheme that still lands
    invalid returns its last candidate and reports the retries in
    StepAux.rejections. With update_PC > 1 the carry is
    `init_carry_with_pc`'s (Carry, preconditioner, step index), and the
    preconditioner is refactored at steps whose index is a multiple of
    update_PC; the schemes that solve at several configurations reuse it
    there. Krylov recycling runs when the carry holds a recycle state
    (init_carry(recycle_k=k)); with recycle_k > 0 a carry without one
    starts an empty one of k directions at the first step. Every attempt
    of a step starts from the step's recycle state, and the carry keeps
    the last attempt's. Under system.mesh every rank runs the step: its
    decisions are rank 0's (parallel/mesh.replicated), and every rank
    leaves it with rank 0's state."""
    if scheme not in _SCHEMES:
        raise ValueError(f"unknown scheme {scheme!r}; "
                         f"available: {sorted(_SCHEMES)}")
    body_fn = _SCHEMES[scheme]
    solver_kw = dict(tol=tolerance, restart=gmres_restart,
                     maxiter=gmres_maxiter)
    if verbose:
        solver_kw["verbose"] = True
    lanczos_kw = dict(tolerance=lanczos_tolerance, max_iter=lanczos_max_iter,
                      check_every=lanczos_check_every)

    def run(state: State, generator: torch.Generator, carry: Carry, pc):
        with mesh_mod.replicated(system.mesh):
            new_state, new_carry, aux = run_step(state, generator, carry, pc)
            if mesh_mod.is_sharded(system.mesh):
                new_state = State(
                    pos=mesh_mod.broadcast(system.mesh, new_state.pos),
                    quat=mesh_mod.broadcast(system.mesh, new_state.quat))
        return new_state, new_carry, aux

    def run_step(state: State, generator: torch.Generator, carry: Carry,
                 pc):
        # the spectral engine, resolved once here: the carried plan at this
        # step's start configuration (built here when the carry has none);
        # the pairwise engines are built by the attempt. The wall engine's
        # noise factors likewise (its Lanczos needs them at kT = 0 too)
        plan = None
        if saddle.is_spectral(system):
            r0 = kin.blob_positions(system, state)
            plan = (saddle.maybe_dense_mobility(system, r0)
                    if carry.plan is None
                    else saddle.refresh_dense_mobility(system, carry.plan,
                                                       r0))
        if saddle.is_wall_spectral(system) and carry.noise_factors is None:
            carry = carry._replace(noise_factors=ewald_wall.noise_factors(
                plan.params, state.pos.dtype, state.pos.device))
        if recycle_k > 0 and carry.recycle is None:
            carry = carry._replace(recycle=RecycleState.empty(
                recycle_k, saddle.saddle_size(system), state.pos.dtype,
                state.pos.device))
        attempts = 0
        while True:
            res = body_fn(system, dt, solver_kw, lanczos_kw, generator,
                          state, carry, plan, pc)
            # a scheme without recycling passes the state through
            (new_state, velocities, det_it, st_it, ok, conv,
             rec_out) = res if len(res) == 7 else (*res, carry.recycle)
            attempts += 1
            if ok or attempts >= max_rejections:
                break
        overflows = force_ops.neighbor_list_overflow(
            system, kin.blob_positions(system, state))
        if plan is not None:
            overflows += int(plan.n_dropped_cells)
        if saddle.is_wall_spectral(system):
            overflows += int(plan.n_clipped)      # blobs above the slab
        new_carry = Carry(velocities_prev=velocities, first_step=False,
                          plan=plan, noise_factors=carry.noise_factors,
                          recycle=rec_out, step_idx=carry.step_idx + 1)
        aux = StepAux(velocities=velocities, det_iterations=int(det_it),
                      stoch_iterations=int(st_it), rejections=attempts - 1,
                      solves_converged=bool(conv),
                      capacity_overflows=overflows)
        return new_state, new_carry, aux

    if update_PC > 1:
        def step(state: State, generator: torch.Generator, carry):
            inner, pc, step_idx = carry
            if step_idx % update_PC == 0:
                pc = saddle.build_block_diag_pc(system, state)
            new_state, inner, aux = run(state, generator, inner, pc)
            return new_state, (inner, pc, step_idx + 1), aux

        return step

    def step(state: State, generator: torch.Generator, carry: Carry):
        return run(state, generator, carry, None)

    return step


def simulate(system: System, state: State, generator, *, scheme: str,
             dt: float, n_steps: int, save_every: int = 1, **stepper_kw):
    """The time loop: n_steps // save_every * save_every steps of
    make_stepper(system, scheme, dt, **stepper_kw) from `state` (a carry
    from init_carry at it). Returns (final state, the trajectory of every
    save_every-th state as a State of stacked (n_saves, B, 3) and (n_saves,
    B, 4) tensors, the StepAux of each saved step)."""
    step = make_stepper(system, scheme, dt, **stepper_kw)
    carry = init_carry(system, state=state)
    saved, auxs = [], []
    for i in range(n_steps // save_every * save_every):
        state, carry, aux = step(state, generator, carry)
        if (i + 1) % save_every == 0:
            saved.append(state)
            auxs.append(aux)
    traj = State(
        pos=torch.stack([s.pos for s in saved]) if saved
        else state.pos.new_zeros((0, *state.pos.shape)),
        quat=torch.stack([s.quat for s in saved]) if saved
        else state.quat.new_zeros((0, *state.quat.shape)))
    return state, traj, auxs


def init_carry_with_pc(system: System, state: State):
    """Carry of a stepper built with update_PC > 1: (Carry, the
    preconditioner factored at `state`, step index 0)."""
    return (init_carry(system, state=state),
            saddle.build_block_diag_pc(system, state), 0)
