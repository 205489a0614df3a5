"""Mobility solves: force assembly, right-hand side and preconditioned
GMRES on the saddle system (PyTorch).

Counterpart of rigidmultiblobswall_tpu/models/solvers.py:
`force_torque_calculator`, `build_rhs`, `solve_mobility_problem` and
`solve_mobility_problem_lockstep` (m_dense='auto' takes the
configuration's engine from saddle.maybe_dense_mobility: the materialized
matrix within its budget), and the dense-algebra utilities of small
systems: `dense_blob_mobility`, `solve_body_mobility`,
`solve_mobility_problem_dense` and `solve_resistance`, with bodies of
prescribed kinematics (the right-hand side's rewrite, the prescribed
velocity written over the solution) and Krylov recycling (`recycle=` and
`collect_recycle=` on both solves, `refresh_recycle`), articulated
bodies (the constraint rows at `time=`, their forces in
MobilitySolution.phi) and the single-blob articulated solve on the grand
mobility (`solve_mobility_problem_single_blob`, kernel K1 grand on the
card). Active slip (BodyType.slip_ref) and the slip_fn hook enter the
right-hand side, and the body-body Yukawa force and the blob_force_fn and
body_force_torque_fn hooks the force assembly.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops import forces as force_ops
from ..ops import gmres as gmres_mod
from ..ops import mobility as mob
from ..ops.gmres import gmres, gmres_lockstep
from ..parallel import mesh as mesh_mod
from . import articulated as art_mod
from . import kinematics as kin
from . import saddle
from .system import State, System


class MobilitySolution(NamedTuple):
    lam: torch.Tensor         # (N,3) constraint forces on blobs
    velocities: torch.Tensor  # (B,6)
    iterations: int
    residual_norm: object
    converged: object = True  # GMRES reached tolerance (every RHS)
    recycle: object = None    # the harvested ops/gmres.RecycleState
    #                           (collect_recycle)
    phi: torch.Tensor = None  # (C,3) articulated constraint forces


def _replicated(solve):
    """The solve's host decisions are rank 0's under system.mesh
    (parallel/mesh.replicated), so every rank iterates alike."""
    @functools.wraps(solve)
    def wrapped(system, *args, **kw):
        with mesh_mod.replicated(system.mesh):
            return solve(system, *args, **kw)

    return wrapped


def force_torque_calculator(system: System, state: State, r_blobs):
    """Default force assembly: one-blob external forces plus blob-blob
    repulsion (direct sweep or linked cells; on single_wall_spectral the
    linked cells of the slab below spectral_wall_height) and the
    blob_force_fn hook, aggregated through K^T, plus the body-body Yukawa
    force between body centers when body_body_force_method asks for it
    and the body_force_torque_fn hook. Returns (B,6)."""
    f_blobs = force_ops.blob_external_forces(
        r_blobs, g=system.g, blob_mass=1.0, blob_radius=system.blob_radius,
        repulsion_strength_wall=system.repulsion_strength_wall,
        debye_length_wall=system.debye_length_wall)
    if system.blob_blob_force_method == "neighbor_list":
        f_blobs = f_blobs + force_ops.blob_blob_forces_neighbor_list(
            r_blobs, repulsion_strength=system.repulsion_strength,
            debye_length=system.debye_length,
            blob_radius=system.blob_radius,
            periodic_length=system.periodic_length,
            cutoff=system.blob_blob_cutoff or None,
            grid_dim=system.blob_blob_grid_dim,
            cell_capacity=system.blob_blob_cell_capacity,
            z_extent=force_ops.force_z_extent(system))
    elif system.blob_blob_force_method == "direct":
        f_blobs = f_blobs + force_ops.blob_blob_forces(
            r_blobs, repulsion_strength=system.repulsion_strength,
            debye_length=system.debye_length,
            blob_radius=system.blob_radius,
            periodic_length=system.periodic_length)
    if system.blob_force_fn is not None:
        f_blobs = f_blobs + system.blob_force_fn(system, state, r_blobs)
    ft = kin.KT_mul(system, state, f_blobs)
    if system.body_body_force_method != "none":
        ft = ft + force_ops.body_body_forces_torques(
            state.pos, repulsion_strength=system.repulsion_strength,
            debye_length=system.debye_length,
            periodic_length=system.periodic_length)
    if system.body_force_torque_fn is not None:
        ft = ft + system.body_force_torque_fn(system, state, r_blobs)
    return ft


def build_rhs(system: System, state: State, r_blobs, slip=None,
              force_torque=None, noise_slip=None, noise_ft=None, time=0.0):
    """RHS = [slip - noise, -(F + noise_FT), B], flat; B, the prescribed
    link velocities at `time`, only with articulated bodies. The slip
    defaults to the bodies' active slip plus the slip_fn hook's. A
    prescribed body's rows take its
    K U in the slip and a zero force (the operator's prescribed rows,
    saddle._finish)."""
    if slip is None:
        slip = kin.active_slip(system, state)
        if system.slip_fn is not None:
            slip = slip + system.slip_fn(system, state).reshape(
                system.num_blobs, 3)
    slip = slip.reshape(system.num_blobs, 3)
    if force_torque is None:
        force_torque = force_torque_calculator(system, state, r_blobs)
    force_torque = force_torque.reshape(system.num_bodies, 6)
    if noise_ft is not None:
        force_torque = force_torque + noise_ft.reshape(system.num_bodies, 6)
    prescribed = saddle._prescribed_masks(system, state.pos)
    if prescribed is not None:
        blob_mask, body_mask = prescribed
        KU = kin.K_mul(system, state, _prescribed_velocities(system, slip))
        slip = slip + blob_mask * KU
        force_torque = torch.where(body_mask > 0, 0.0, force_torque)
    if noise_slip is not None:
        slip = slip - noise_slip.reshape(system.num_blobs, 3)
    return torch.cat([slip.reshape(-1), -force_torque.reshape(-1),
                      art_mod.constraint_rhs(system, state,
                                             time).reshape(-1)])


def _prescribed_velocities(system: System, like):
    return torch.tensor(system.prescribed_velocities, dtype=like.dtype,
                        device=like.device)


def _impose_prescribed(system: System, U):
    """The solution's velocities U (..., B, 6) with the prescribed bodies'
    rows set to their prescribed velocity."""
    if not system.prescribed_body_mask.any():
        return U
    mask = torch.tensor(system.prescribed_body_mask, device=U.device)[:, None]
    return torch.where(mask, _prescribed_velocities(system, U), U)


@_replicated
def solve_mobility_problem(system: System, state: State, *, rhs=None,
                           slip=None, force_torque=None, noise_slip=None,
                           noise_ft=None,
                           pc: Optional[saddle.BlockDiagPC] = None, x0=None,
                           tol: Optional[float] = None, restart: int = 60,
                           maxiter: int = 1000, m_dense="auto",
                           verbose: bool = False, recycle=None,
                           collect_recycle: bool = False, time=0.0
                           ) -> MobilitySolution:
    """Preconditioned GMRES solve of the saddle system on the unit-norm
    right-hand side. x0 is in physical units (e.g. a previous solution
    [lam, U, phi] used as a warm start). The constraint rows, their
    right-hand side and the preconditioner take the links at `time`.
    m_dense: 'auto' asks
    saddle.maybe_dense_mobility for the configuration's engine; or pass
    the engine (a spectral plan, the materialized matrix, or None for the
    matrix-free pairwise engine). recycle: an ops/gmres.RecycleState for
    GCRO deflation (ops/gmres.gmres_deflated); collect_recycle also
    harvests the next state from this solve (returned in .recycle)."""
    r_blobs = kin.blob_positions(system, state)
    if isinstance(m_dense, str) and m_dense == "auto":
        m_dense = saddle.maybe_dense_mobility(system, r_blobs)
    if rhs is None:
        rhs = build_rhs(system, state, r_blobs, slip=slip,
                        force_torque=force_torque, noise_slip=noise_slip,
                        noise_ft=noise_ft, time=time)
    if pc is None:
        pc = saddle.build_block_diag_pc(system, state, time=time)
    operator = saddle.make_linear_operator(system, state, r_blobs,
                                           m_dense=m_dense, time=time)
    tol = system.solver_tolerance if tol is None else tol
    rhs_norm = torch.linalg.norm(rhs)
    safe_norm = torch.where(rhs_norm > 0, rhs_norm, torch.ones_like(rhs_norm))
    if x0 is not None:
        x0 = x0 / safe_norm
    rec_new = None

    def pc_apply(v):
        return saddle.apply_block_diag_pc(system, pc, v)

    if recycle is not None:
        result, rec_new = gmres_mod.gmres_deflated(
            operator, rhs / safe_norm, recycle, x0=x0, tol=tol,
            restart=restart, maxiter=maxiter, M=pc_apply,
            collect_basis=collect_recycle)
    else:
        result = gmres(operator, rhs / safe_norm, x0=x0, tol=tol,
                       restart=restart, maxiter=maxiter, verbose=verbose,
                       M=pc_apply)
    lam, U, phi = saddle.split_saddle_vector(system, result.x * rhs_norm)
    return MobilitySolution(lam=lam, velocities=_impose_prescribed(system, U),
                            iterations=result.iterations,
                            residual_norm=result.residual_norm,
                            converged=result.converged, recycle=rec_new,
                            phi=phi)


@_replicated
def solve_mobility_problem_lockstep(system: System, state: State, *, rhs,
                                    pc: Optional[saddle.BlockDiagPC] = None,
                                    x0=None, tol: Optional[float] = None,
                                    restart: int = 60, maxiter: int = 1000,
                                    m_dense="auto", recycle=None,
                                    collect_recycle: bool = False
                                    ) -> MobilitySolution:
    """Solve the saddle system for a stack of right-hand sides (nrhs, n)
    at one configuration, sharing every pair sweep across the stack.
    Fields carry a leading nrhs axis; `iterations` counts batched
    sweeps. recycle warm-starts every column from the recycle directions;
    with collect_recycle the next state is harvested from column 0's
    last Krylov cycle."""
    r_blobs = kin.blob_positions(system, state)
    if isinstance(m_dense, str) and m_dense == "auto":
        m_dense = saddle.maybe_dense_mobility(system, r_blobs)
    if pc is None:
        pc = saddle.build_block_diag_pc(system, state)
    operator = saddle.make_lockstep_operator(system, state, r_blobs,
                                             m_dense=m_dense)
    tol = system.solver_tolerance if tol is None else tol
    rhs_norm = torch.linalg.norm(rhs, dim=1)
    safe_norm = torch.where(rhs_norm > 0, rhs_norm, torch.ones_like(rhs_norm))
    if x0 is not None:
        x0 = x0 / safe_norm[:, None]
    collect = recycle is not None and collect_recycle
    result = gmres_lockstep(
        operator, rhs / safe_norm[:, None], x0=x0, tol=tol, restart=restart,
        maxiter=maxiter,
        M=lambda v: saddle.apply_block_diag_pc(system, pc, v),
        recycle=recycle, collect_basis=collect)
    rec_new = None
    if collect:
        result, (V0, Hraw0, j_used) = result
        k = recycle.U.shape[0]
        rec_new = gmres_mod.harvest_recycle(
            recycle, V0, Hraw0, np.zeros((Hraw0.shape[1], k)), j_used, k)
    lam, U, phi = saddle.split_saddle_vector(system,
                                             result.x * rhs_norm[:, None])
    return MobilitySolution(lam=lam, velocities=_impose_prescribed(system, U),
                            iterations=result.iterations,
                            residual_norm=result.residual_norm,
                            converged=bool(result.converged.all()),
                            recycle=rec_new, phi=phi)


def refresh_recycle(system: System, state: State, rec, *, pc=None,
                    m_dense="auto"):
    """Re-biorthonormalize a RecycleState at this configuration with one
    lockstep sweep of its k columns (ops/gmres.refresh_recycle): k / 2
    K1 tt launches on the matrix-free engine. An invalid state (no harvest
    yet) comes back as it is."""
    if not rec.valid:
        return rec
    r_blobs = kin.blob_positions(system, state)
    if isinstance(m_dense, str) and m_dense == "auto":
        m_dense = saddle.maybe_dense_mobility(system, r_blobs)
    if pc is None:
        pc = saddle.build_block_diag_pc(system, state)
    operator = saddle.make_lockstep_operator(system, state, r_blobs,
                                             m_dense=m_dense)
    return gmres_mod.refresh_recycle(
        lambda Y: operator(saddle.apply_block_diag_pc(system, pc, Y)), rec)


def _self_mobility(system: System, like):
    """(6,) the free-space self grand mobility's diagonal, 1/(6 pi eta a)
    three times and 1/(8 pi eta a^3) three times."""
    eta, a = system.eta, system.blob_radius
    f_tt = 1.0 / (6.0 * math.pi * eta * a)
    f_rr = 1.0 / (8.0 * math.pi * eta * a ** 3)
    return torch.tensor([f_tt] * 3 + [f_rr] * 3, dtype=like.dtype,
                        device=like.device)


def _single_blob_articulated_pc(system: System, state: State, time=0.0):
    """The constraint resistance G = pinv(C N0 C^T) of every instance, N0
    the diagonal free-space self grand mobility; one (count, 3nc, 3nc)
    tensor per articulated type."""
    n0 = _self_mobility(system, state.pos)
    Gs = []
    for art in system.articulated:
        C = art_mod.dense_C_per_instance(system, art, state, time)
        n0_full = n0.repeat(art.num_bodies)
        Gs.append(art_mod.pinv_like_jax(
            torch.einsum("kij,j,kmj->kim", C, n0_full, C)))
    return Gs


def _grand_matvec(system: System, r, ft):
    """M_grand (F, T) for single-blob bodies at r, ft (B, 6) -> (B, 6):
    kernel K1 grand on the card."""
    u, w = mob.grand_mobility_matvec(
        r, ft[:, 0:3], ft[:, 3:6], system.eta, system.blob_radius,
        **system.mobility_kwargs)
    return torch.cat([u, w], dim=1)


@_replicated
def solve_mobility_problem_single_blob(system: System, state: State, *,
                                       tol=None, restart: int = 60,
                                       maxiter: int = 1000, time=0.0,
                                       verbose: bool = False
                                       ) -> MobilitySolution:
    """Constrained mobility solve of articulated single-blob bodies (the
    articulated rollers). A single blob has no torque arm, so the
    blob-level saddle operator loses the rotational coupling; the solve
    takes the 6N grand mobility instead. Unknowns x = (phi, U):

        U + M_grand C^T phi = M_grand F_ext
        C U                 = B

    preconditioned by each instance's constraint resistance
    G = pinv(C N0 C^T), N0 the diagonal self mobility. Every product is
    one K1 grand launch on the card."""
    r = state.pos
    nb = system.num_bodies
    nc3 = 3 * art_mod.num_constraints(system)
    offs = art_mod.constraint_offsets(system)
    links = art_mod.operator_links(system, state, time)

    ft = force_torque_calculator(system, state, r)
    U_unc = _grand_matvec(system, r, ft)
    B = art_mod.constraint_rhs(system, state, time)
    rhs = torch.cat([U_unc.reshape(-1), B.reshape(-1)])

    def operator(vec):
        phi = vec[:nc3].reshape(-1, 3)
        U = vec[nc3:].reshape(nb, 6)
        Fc = art_mod.CT_mul(system, state, phi, links=links)
        res_U = _grand_matvec(system, r, Fc) + U
        res_C = art_mod.C_mul(system, state, U, links=links)
        return torch.cat([res_U.reshape(-1), res_C.reshape(-1)])

    Gs = _single_blob_articulated_pc(system, state, time)
    m0 = _self_mobility(system, r)

    def pc(vec):
        rU = vec[:6 * nb].reshape(nb, 6)
        rB = vec[6 * nb:].reshape(-1, 3)
        CU = art_mod.C_mul(system, state, rU, links=links) - rB
        phi = torch.cat([
            torch.einsum("kij,kj->ki", Gs[ia], CU[offs[ia]:offs[ia + 1]]
                         .reshape(art.count, -1)).reshape(-1, 3)
            for ia, art in enumerate(system.articulated)], dim=0)
        U = rU - m0[None, :] * art_mod.CT_mul(system, state, phi,
                                              links=links)
        return torch.cat([phi.reshape(-1), U.reshape(-1)])

    tol = system.solver_tolerance if tol is None else tol
    rhs_norm = torch.linalg.norm(rhs)
    safe_norm = torch.where(rhs_norm > 0, rhs_norm, torch.ones_like(rhs_norm))
    result = gmres(operator, rhs / safe_norm, tol=tol, restart=restart,
                   maxiter=maxiter, verbose=verbose, M=pc)
    sol = result.x * rhs_norm
    return MobilitySolution(lam=r.new_zeros((nb, 3)),
                            velocities=sol[nc3:].reshape(nb, 6),
                            iterations=result.iterations,
                            residual_norm=result.residual_norm,
                            converged=result.converged,
                            phi=sol[:nc3].reshape(-1, 3))


# ---------------------------------------------------------------------------
# Dense-algebra solves (small systems, the static CLI modes and the
# dense-algebra schemes); torch.linalg in place of jnp.linalg
# ---------------------------------------------------------------------------


def dense_blob_mobility(system: System, state: State):
    """The (3N, 3N) blob mobility of the state: kernel K3 on the card, or
    with mixed blob radii mob.dense_mobility_radii (plain PyTorch, as the
    JAX package builds it in XLA)."""
    r_blobs = kin.blob_positions(system, state)
    if system.has_mixed_radii:
        return mob.dense_mobility_radii(
            r_blobs, torch.tensor(system.blob_radii, dtype=r_blobs.dtype,
                                  device=r_blobs.device),
            system.eta, domain=system.domain)
    return saddle.dense_mobility(system, r_blobs)


def _dense_K(system: System, state: State):
    """Global dense K, (3N, 6B), block diagonal per body. Only the dense
    utility solves use it; products use kin.K_mul / kin.KT_mul."""
    K = torch.zeros((3 * system.num_blobs, 6 * system.num_bodies),
                    dtype=state.pos.dtype, device=state.pos.device)
    for i, t in enumerate(system.types):
        Kt = kin.K_dense(system, state, i)  # (c, 3nb, 6)
        b0 = system.body_offsets[i]
        n0 = system.blob_offsets[i]
        for c in range(t.count):
            r0 = 3 * (n0 + c * t.num_blobs)
            K[r0:r0 + 3 * t.num_blobs, 6 * (b0 + c):6 * (b0 + c + 1)] = Kt[c]
    return K


def solve_body_mobility(system: System, state: State):
    """(6B, 6B) body mobility N = pinv(K^T M^{-1} K)."""
    M = dense_blob_mobility(system, state)
    K = _dense_K(system, state)
    return torch.linalg.pinv(K.T @ torch.linalg.solve(M, K))


def solve_mobility_problem_dense(system: System, state: State, slip=None,
                                 force_torque=None):
    """Dense-algebra mobility solve: (velocities (B,6), body mobility N
    (6B,6B))."""
    r_blobs = kin.blob_positions(system, state)
    if slip is None:
        slip = kin.active_slip(system, state)
    if force_torque is None:
        force_torque = force_torque_calculator(system, state, r_blobs)
    M = dense_blob_mobility(system, state)
    K = _dense_K(system, state)
    FT = force_torque.reshape(-1) - K.T @ torch.linalg.solve(
        M, slip.reshape(-1))
    N = torch.linalg.pinv(K.T @ torch.linalg.solve(M, K))
    return (N @ FT).reshape(system.num_bodies, 6), N


def solve_resistance(system: System, state: State, velocities, slip=None):
    """Resistance problem F = K^T M^{-1} (K U + slip); (B,6)
    force-torques."""
    if slip is None:
        slip = kin.active_slip(system, state)
    M = dense_blob_mobility(system, state)
    KU = kin.K_mul(system, state, velocities.reshape(-1, 6))
    lam = torch.linalg.solve(M, (KU + slip.reshape(-1, 3)).reshape(-1))
    return kin.KT_mul(system, state, lam.reshape(-1, 3))
