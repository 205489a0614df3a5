"""Matrix-free saddle-point operator and block-diagonal preconditioner
(PyTorch).

Counterpart of rigidmultiblobswall_tpu/models/saddle.py. Mobility problem
for rigid multiblob suspensions (Delong et al. 2015):

    |  M   -K    0  | |lambda|   | slip |
    | -K^T  0   C^T | |  U   | = | -F   |
    |  0    C    0  | | phi  |   |  B   |

solved by right-preconditioned GMRES with an exact per-body
preconditioner; the constraint rows C and their forces phi exist for
articulated bodies (models/articulated.py) only, whose preconditioner
adds each instance's constraint resistance G = pinv(C N C^T). Bodies are
batched per type: one batched Cholesky per type, and the preconditioner
applies as batched matrix products. The Lanczos noise preconditioner
P = U_chol^{-1}, M ~= U_chol^T U_chol, reuses the same factorization.

The mobility engine of a configuration is `m_dense`:
  - the materialized (3N, 3N) matrix of the pairwise domains when its
    9 N^2 values fit MATERIALIZE_BUDGET_BYTES (kernel K3 builds it on the
    card, ops/mobility.dense_mobility_tiled on the CPU; single products
    and the stacked pairs of the lockstep solves run kernel K4);
  - None for the matrix-free pairwise engine (kernel K1), above the
    budget;
  with a periodic_length both hold the pseudo-periodic image boxes (K3's
  and K1's image-box instances), as the JAX package's engine choice does
  (saddle.py:120-143);
  - an ops/ewald.SpectralPlan for domain 'periodic_spectral', an
    ops/ewald_wall.WallPlan for 'single_wall_spectral', built once per
    configuration and refreshed for nearby ones.
With mixed blob radii (System.has_mixed_radii) the pairwise domains are
always matrix-free, on kernel P1 (ops/mobility.mobility_radii_multi), and
periodic_spectral builds the mixed-radii plan (per-group shape factors,
ops/ewald with group_of); single_wall_spectral refuses them, as the JAX
package does.
Bodies with prescribed kinematics (obstacles) get an identity row on
their U and their K U moved back out of the blob rows, and the
preconditioner's exact resistance solve for their type. The constraint
rows, the right-hand side's B and the articulated preconditioner take
the links at a `time=` (time-dependent links).
"""

from __future__ import annotations

from typing import NamedTuple

import dataclasses
import os

import numpy as np
import torch

from ..ops import cell_kernels, cells, ewald, ewald_wall
from ..ops import mobility as mob
from ..ops import mobility_cuda
from . import articulated as art_mod
from . import kinematics as kin
from .system import State, System


SPECTRAL_DOMAINS = ("periodic_spectral", "single_wall_spectral")


def is_spectral(system: System) -> bool:
    """True for the engines that carry a positions plan."""
    return system.domain in SPECTRAL_DOMAINS


def is_wall_spectral(system: System) -> bool:
    return system.domain == "single_wall_spectral"


def spectral_params(system: System):
    """The parameters of a spectral System's engine (host): ops/ewald's
    for periodic_spectral, ops/ewald_wall's for single_wall_spectral."""
    if is_wall_spectral(system):
        if system.spectral_wall_height <= 0:
            raise ValueError(
                "single_wall_spectral needs spectral_wall_height > 0 (slab "
                "top; use saddle.auto_wall_height(system, state))")
        return ewald_wall.default_wall_params(
            system.blob_radius, system.eta, system.periodic_length[:2],
            z_hi=system.spectral_wall_height, tol=system.spectral_tol,
            grid_max=system.spectral_grid_max,
            cell_capacity=system.spectral_cell_capacity)
    if not is_spectral(system):
        return None
    radii_kw, a_eff = {}, system.blob_radius
    if system.has_mixed_radii:
        vals, _ = radii_groups(system)
        # r_cut and the grid sized by the largest radius
        radii_kw, a_eff = {"radii": vals}, max(vals)
    return ewald.default_params(
        a_eff, system.eta, system.periodic_length,
        tol=system.spectral_tol, grid_max=system.spectral_grid_max,
        cell_capacity=system.spectral_cell_capacity, **radii_kw)


def radii_groups(system: System):
    """(distinct blob radii rounded to 10 digits, per-blob group index
    (N,) int32) of the mixed-radii spectral engine (host numpy)."""
    vals, groups = np.unique(np.round(system.blob_radii, 10),
                             return_inverse=True)
    # one block of wave channels a radius, and P2's table, take at most
    # cell_kernels.MAX_GROUPS (the JAX package's limit)
    if len(vals) > cell_kernels.MAX_GROUPS:
        raise NotImplementedError(
            f"{len(vals)} distinct blob radii: the spectral mixed-radii "
            "engine carries one wave channel block per distinct radius; "
            "use the pairwise domains for continuously-distributed radii")
    return tuple(float(v) for v in vals), groups.astype(np.int32)


def num_constraints(system: System) -> int:
    """Articulated constraints of the system (models/articulated.py)."""
    return art_mod.num_constraints(system)


def saddle_size(system: System) -> int:
    return (3 * system.num_blobs + 6 * system.num_bodies
            + 3 * num_constraints(system))


def split_saddle_vector(system: System, vec):
    """(..., n) -> lam (..., N, 3), U (..., B, 6), phi (..., C, 3) (C = 0
    without articulated bodies)."""
    n3 = 3 * system.num_blobs
    nb6 = 6 * system.num_bodies
    batch = vec.shape[:-1]
    lam = vec[..., :n3].reshape(*batch, system.num_blobs, 3)
    U = vec[..., n3:n3 + nb6].reshape(*batch, system.num_bodies, 6)
    phi = vec[..., n3 + nb6:].reshape(*batch, -1, 3)
    return lam, U, phi


# budget for materializing (3N, 3N): a Slip-Trapz step keeps two
# configurations' matrices live (the step start and the predictor); the
# JAX package's default and variable (saddle.py:77-81). 6 GiB holds
# 12,288 blobs in float32 (5.06 GiB a matrix).
MATERIALIZE_BUDGET_BYTES = int(os.environ.get("RMW_MATERIALIZE_BUDGET",
                                              6 << 30))


def dense_mobility(system: System, r_blobs):
    """The materialized (3N, 3N) mobility of a pairwise-domain
    configuration, with no budget check: kernel K3 on the card in the
    domain's mode (its image-box instance with a periodic_length;
    in_plane: the wall instance with the z rows and columns zeroed on the
    device, the P M P of its blocks), the plain builder on the CPU."""
    m = mobility_cuda.dense_tt(r_blobs.contiguous(), system.eta,
                               system.blob_radius,
                               mode=mob.DOMAIN_MODE[system.domain],
                               periodic_length=system.periodic_length)
    if system.domain == "in_plane":
        m[2::3] = 0.0
        m[:, 2::3] = 0.0
    return m


def maybe_dense_mobility(system: System, r_blobs):
    """The per-configuration mobility engine: a SpectralPlan for
    periodic_spectral, a WallPlan for single_wall_spectral; for the
    pairwise domains the materialized (3N, 3N) matrix (dense_mobility)
    when its 9 N^2 values fit MATERIALIZE_BUDGET_BYTES, else None, the
    matrix-free engine (e.g. 49,152 blobs: 87 GB in float32). With mixed
    radii: the mixed-radii plan on periodic_spectral, None (kernel P1) on
    the pairwise domains whatever the budget, and the JAX package's
    refusal on single_wall_spectral."""
    if system.has_mixed_radii and is_wall_spectral(system):
        raise NotImplementedError(
            "per-blob radii are not supported by the WALL spectral engine "
            "yet (nor by the JAX package's); use domain='periodic_spectral' "
            "or the pairwise domains (single_wall/no_wall)")
    if is_wall_spectral(system):
        return ewald_wall.make_wall_plan(spectral_params(system), r_blobs)
    if is_spectral(system):
        group_of = None
        if system.has_mixed_radii:
            group_of = torch.as_tensor(radii_groups(system)[1],
                                       device=r_blobs.device)
        return ewald.make_plan(spectral_params(system), r_blobs,
                               group_of=group_of)
    if system.has_mixed_radii:
        return None
    n = r_blobs.shape[0]
    if 9 * n * n * r_blobs.element_size() > MATERIALIZE_BUDGET_BYTES:
        return None
    return dense_mobility(system, r_blobs)


def refresh_dense_mobility(system: System, m_dense, r_new, *, build=True):
    """The engine for a configuration near the one m_dense was built at: a
    spectral plan refreshes (ops/ewald.update_plan, a full rebuild past
    its drift budget); the pairwise domains rebuild at r_new (build=True)
    or take the matrix-free sweep (build=False, for a single product
    that a build would not amortize)."""
    if is_wall_spectral(system):
        return ewald_wall.update_wall_plan(_plan(system, m_dense), r_new)
    if is_spectral(system):
        return ewald.update_plan(_plan(system, m_dense), r_new)
    return maybe_dense_mobility(system, r_new) if build else None


def _plan(system, m_dense):
    """The spectral plan m_dense, which the caller resolves once per
    configuration (the integrators at the step's start, solvers at
    m_dense='auto'); nothing below builds one."""
    kind = (ewald_wall.WallPlan if is_wall_spectral(system)
            else ewald.SpectralPlan)
    if not isinstance(m_dense, kind):
        raise ValueError(f"{system.domain} products need the "
                         "configuration's plan as m_dense "
                         "(saddle.maybe_dense_mobility), got "
                         f"{type(m_dense).__name__}")
    return m_dense


def _mobility_apply(system, r_blobs, m_dense, lam):
    """M lam for lam (N, 3) (or flat) -> (N, 3) on the engine m_dense
    (a SpectralPlan, the materialized matrix, or None for the matrix-free
    pairwise engine)."""
    if is_wall_spectral(system):
        return ewald_wall.matvec(_plan(system, m_dense), lam.reshape(-1, 3),
                                 mesh=system.mesh)
    if is_spectral(system):
        return ewald.matvec(_plan(system, m_dense), lam.reshape(-1, 3),
                            mesh=system.mesh)
    if m_dense is not None:
        # kernel K4 on the card, in both dtypes (the JAX package's cut at
        # n >= 1024 and float32, saddle.py:426-427, was the TPU's)
        return mobility_cuda.symm_matvec(m_dense, lam.reshape(-1, 3))
    if system.has_mixed_radii:
        return _radii_product(system, r_blobs, lam.reshape(1, -1, 3))[0]
    return mob.mobility_trans_times_force(
        r_blobs, lam.reshape(-1, 3), system.eta, system.blob_radius,
        **system.mobility_kwargs)


def _mobility_apply_multi(system, r_blobs, m_dense, lam):
    """Stacked M products, lam (b, N, 3) -> (b, N, 3), one engine sweep."""
    if is_wall_spectral(system):
        return ewald_wall.matvec_multi(_plan(system, m_dense), lam,
                                       mesh=system.mesh)
    if is_spectral(system):
        return ewald.matvec_multi(_plan(system, m_dense), lam,
                                  mesh=system.mesh)
    if m_dense is not None:
        # kernel K4 with two right-hand sides a launch: one read of the
        # upper triangle serves the lockstep pair (JAX's einsum,
        # saddle.py:460-463; cuBLAS's n = 2 matmul of the full matrix
        # measured 8x slower, PERF.md)
        return mobility_cuda.symm_matvec(m_dense, lam)
    if system.has_mixed_radii:
        # kernel P1 takes the lockstep pair in one launch (the JAX package
        # vmaps one product a right-hand side)
        return _radii_product(system, r_blobs, lam)
    return mob.pairwise_matvec_multi(
        r_blobs, None, lam, system.eta, system.blob_radius,
        coupling="tt", self_interaction=True, **system.mobility_kwargs)


def _radii_product(system, r_blobs, lam):
    """The matrix-free products with per-blob radii, lam (b, N, 3)."""
    radii = torch.tensor(system.blob_radii, dtype=r_blobs.dtype,
                         device=r_blobs.device)
    return mob.mobility_radii_multi(r_blobs, lam, radii, system.eta,
                                    domain=system.domain,
                                    periodic_length=system.periodic_length)


def blob_prescribed_mask(system: System) -> np.ndarray:
    """(N,) 1.0 where the parent body has prescribed kinematics (host)."""
    mask = np.zeros(system.num_blobs)
    for i, t in enumerate(system.types):
        if t.prescribed_kinematics:
            mask[system.blob_slice(i)] = 1.0
    return mask


def _prescribed_masks(system: System, like):
    """The blob (N, 1) and body (B, 1) masks of the prescribed rows on
    the device and in the dtype of `like`, or None without any."""
    if not system.prescribed_body_mask.any():
        return None
    kw = dict(dtype=like.dtype, device=like.device)
    return (torch.tensor(blob_prescribed_mask(system), **kw)[:, None],
            torch.tensor(system.prescribed_body_mask, **kw)[:, None])


def _finish(system, state, rel, vec, m_lam, prescribed=None, links=None):
    """[M lam - K U; -K^T lam + C^T phi; C U] from the mobility product,
    for any leading batch dimensions (the constraint rows with `links`,
    art_mod.operator_links, when the system has articulated bodies); with
    `prescribed` (_prescribed_masks) the prescribed bodies' rows become an
    identity on U and their K U leaves the blob rows."""
    lam, U, phi = split_saddle_vector(system, vec)
    KU = kin.K_mul(system, state, U, rel=rel)
    res_blobs = m_lam - KU
    res_bodies = -kin.KT_mul(system, state, lam, rel=rel)
    parts = [res_blobs, res_bodies]
    if links is not None:
        parts = [res_blobs,
                 res_bodies + art_mod.CT_mul(system, state, phi,
                                             links=links),
                 art_mod.C_mul(system, state, U, links=links)]
    if prescribed is not None:
        blob_mask, body_mask = prescribed
        parts[0] = parts[0] + blob_mask * KU
        parts[1] = parts[1] + body_mask * U
    batch = vec.shape[:-1]
    return torch.cat([p.reshape(*batch, -1) for p in parts], dim=-1)


def _constraint_links(system, state, time):
    """The lab-frame links of the operator's constraint rows at `time`, or
    None without articulated bodies."""
    if not art_mod.num_constraints(system):
        return None
    return art_mod.operator_links(system, state, time)


def make_linear_operator(system: System, state: State, r_blobs=None,
                         m_dense=None, time=0.0):
    """vec -> saddle operator action (flat in, flat out); the constraint
    rows take the links at `time`."""
    rel = kin.all_rel_positions(system, state)
    if r_blobs is None:
        r_blobs = kin.blob_positions(system, state, rel=rel)
    prescribed = _prescribed_masks(system, state.pos)
    links = _constraint_links(system, state, time)

    def operator(vec):
        lam = split_saddle_vector(system, vec)[0]
        return _finish(system, state, rel, vec,
                       _mobility_apply(system, r_blobs, m_dense, lam),
                       prescribed, links)

    return operator


def make_lockstep_operator(system: System, state: State, r_blobs=None,
                           m_dense=None, time=0.0):
    """Saddle operator over a (nrhs, n) stack: ONE shared mobility sweep
    feeds the per-RHS K and C algebra. Pairs with
    ops/gmres.gmres_lockstep."""
    rel = kin.all_rel_positions(system, state)
    if r_blobs is None:
        r_blobs = kin.blob_positions(system, state, rel=rel)
    prescribed = _prescribed_masks(system, state.pos)
    links = _constraint_links(system, state, time)

    def operator(Y):
        lam = split_saddle_vector(system, Y)[0]
        m_lam = _mobility_apply_multi(system, r_blobs, m_dense, lam)
        return _finish(system, state, rel, Y, m_lam, prescribed, links)

    return operator


class TypePC(NamedTuple):
    """Per-type batched preconditioner factors."""

    chol: torch.Tensor      # (c, 3nb, 3nb) upper Cholesky, M = U^T U
    chol_inv: torch.Tensor  # (c, 3nb, 3nb) U^{-1}
    m_inv: torch.Tensor     # (c, 3nb, 3nb)
    K: torch.Tensor         # (c, 3nb, 6)
    N_body: torch.Tensor    # (c, 6, 6) = (K^T M^{-1} K)^{-1}


class ArticulatedPC(NamedTuple):
    """Per articulated-type batched constraint factors."""

    C: torch.Tensor  # (count, 3nc, 6nb)
    G: torch.Tensor  # (count, 3nc, 3nc) = pinv(C N C^T)


class BlockDiagPC(NamedTuple):
    per_type: tuple
    per_articulated: tuple = ()


def _collinear(ref_config) -> bool:
    """True when the blobs of a reference configuration lie on one line
    (K^T M^{-1} K is then rank 5 and needs the pseudo-inverse)."""
    cfg = np.asarray(ref_config, np.float64)
    cfg = cfg - cfg.mean(axis=0)
    sv = np.linalg.svd(cfg, compute_uv=False) if len(cfg) > 1 else [0.0]
    return len(sv) < 2 or sv[1] <= 1e-9 * max(sv[0], 1e-30)


def _build_articulated_pc(system: System, state: State, per_type,
                          time=0.0):
    """The constraint resistance G = pinv(C N C^T) of every articulated
    instance, N the block-diagonal body mobility of its sub-bodies,
    batched per articulated type. pinv, not inv: a redundant link set
    makes C N C^T exactly singular (art_mod.pinv_like_jax)."""
    out = []
    for art in system.articulated:
        C = art_mod.dense_C_per_instance(system, art, state, time)
        CN = torch.cat([
            torch.einsum("cik,ckl->cil", C[:, :, 6 * j:6 * j + 6],
                         per_type[tj].N_body)
            for j, tj in enumerate(art.sub_type_indices)], dim=-1)
        G = art_mod.pinv_like_jax(torch.einsum("cik,cjk->cij", CN, C))
        out.append(ArticulatedPC(C=C, G=G))
    return tuple(out)


def build_block_diag_pc(system: System, state: State,
                        time=0.0) -> BlockDiagPC:
    """Factor every body's blob mobility (the dense single-body mobility
    in the system's domain without images; periodic_spectral bodies take
    the open-boundary blocks, single_wall_spectral bodies the wall
    blocks), batched per type, a type with radii of its own other than
    blob_radius on its per-blob radii (mob.dense_mobility_radii); with
    articulated bodies, each instance's constraint resistance at the links
    of `time`. in_plane bodies take the single-wall blocks."""
    # the in_plane mobility is singular in z: its PC factors the
    # single-wall blocks (the JAX package's saddle.py:605-612)
    pc_domain = {"in_plane": "single_wall",
                 "periodic_spectral": "no_wall",
                 "single_wall_spectral": "single_wall"}.get(system.domain,
                                                            system.domain)
    per_type = []
    for i, t in enumerate(system.types):
        rel = kin.blob_rel_positions(system, state, i)
        pos, _ = kin.type_arrays(system, state, i)
        r_body = rel + pos[:, None, :]
        if (t.blob_radii is not None
                and not np.allclose(t.blob_radii, system.blob_radius)):
            M = mob.dense_mobility_radii(
                r_body, torch.tensor(t.blob_radii, dtype=r_body.dtype,
                                     device=r_body.device),
                system.eta, domain=pc_domain)
        else:
            M = mob.dense_mobility(r_body, system.eta, system.blob_radius,
                                   domain=pc_domain)
        chol = torch.linalg.cholesky(M, upper=True)
        eye = torch.eye(3 * t.num_blobs, dtype=M.dtype,
                        device=M.device).expand_as(M)
        chol_inv = torch.linalg.solve_triangular(chol, eye, upper=True)
        m_inv = torch.einsum("cij,ckj->cik", chol_inv, chol_inv)
        K = kin.K_dense(system, state, i)
        KtMinvK = torch.einsum("cni,cnm,cmj->cij", K, m_inv, K)
        if t.num_blobs >= 3 and not _collinear(t.ref_config):
            N_body = torch.linalg.inv(KtMinvK)
        else:
            N_body = torch.linalg.pinv(KtMinvK)
        per_type.append(TypePC(chol=chol, chol_inv=chol_inv, m_inv=m_inv,
                               K=K, N_body=N_body))
    per_art = (_build_articulated_pc(system, state, per_type, time)
               if system.articulated else ())
    return BlockDiagPC(per_type=tuple(per_type), per_articulated=per_art)


def apply_block_diag_pc(system: System, pc: BlockDiagPC, vec):
    """Apply the saddle preconditioner to vec (..., n) = [slip, F]: per
    body, solve the isolated mobility problem exactly. A prescribed body's
    block is [[M, 0], [-K^T, I]] (saddle._finish), solved exactly:
    lambda = M^{-1} slip, U = F + K^T lambda. The JAX package drops the F
    (saddle.py:678-682), which leaves A P singular on the prescribed
    bodies' rows: a cold-start solve never has anything there and takes
    the same steps either way, but a warm start whose U holds the
    prescribed velocity (the Slip-Trapz and Slip-Mid correctors) puts a
    residual there that the JAX solve cannot reduce, and it stops at
    maxiter unconverged.

    With articulated bodies (pc.per_articulated), each instance's
    unconstrained velocities U are then corrected by its constraint
    forces Phi = G (B - C U): the bodies by N C^T Phi and the blobs by
    M^{-1} K N C^T Phi."""
    lam, F, B = split_saddle_vector(system, vec)
    batch = vec.shape[:-1]
    lam_out, body_out = [], []
    for i, t in enumerate(system.types):
        p = pc.per_type[i]
        c, nb = t.count, t.num_blobs
        slip = lam[..., system.blob_slice(i), :].reshape(*batch, c, 3 * nb)
        Fb = F[..., system.body_slice(i), :]
        if t.prescribed_kinematics:
            lam_t = torch.einsum("cij,...cj->...ci", p.m_inv, slip)
            Y = Fb + torch.einsum("cni,...cn->...ci", p.K, lam_t)
        else:
            lam_tilde = torch.einsum("cij,...cj->...ci", p.m_inv, slip)
            rhs = -Fb - torch.einsum("cni,...cn->...ci", p.K, lam_tilde)
            Y = torch.einsum("cij,...cj->...ci", p.N_body, rhs)
            KY = torch.einsum("cni,...ci->...cn", p.K, Y)
            lam_t = torch.einsum("cij,...cj->...ci", p.m_inv, slip + KY)
        lam_out.append(lam_t.reshape(*batch, c * nb * 3))
        body_out.append(Y.reshape(*batch, c * 6))
    if not pc.per_articulated:
        return torch.cat(lam_out + body_out, dim=-1)
    lam_full = torch.cat(lam_out, dim=-1).reshape(*batch, system.num_blobs,
                                                  3)
    body_full = torch.cat(body_out, dim=-1).reshape(*batch,
                                                    system.num_bodies, 6)
    phi_out = []
    offs = art_mod.constraint_offsets(system)
    for ia, art in enumerate(system.articulated):
        apc = pc.per_articulated[ia]
        nb_a, nc_a = art.num_bodies, art.num_constraints
        U_unc = art_mod._instance_bodies(system, art, body_full).reshape(
            *batch, art.count, 6 * nb_a)
        CU = torch.einsum("cij,...cj->...ci", apc.C, U_unc)
        B_a = B[..., offs[ia]:offs[ia + 1], :].reshape(*batch, art.count,
                                                        3 * nc_a)
        Phi = torch.einsum("cij,...cj->...ci", apc.G, B_a - CU)
        Fc = torch.einsum("cji,...cj->...ci", apc.C, Phi).reshape(
            *batch, art.count, nb_a, 6)
        for j, tj in enumerate(art.sub_type_indices):
            p = pc.per_type[tj]
            NFc = torch.einsum("cij,...cj->...ci", p.N_body, Fc[..., j, :])
            body_full[..., system.body_slice(tj), :] += NFc
            lam_corr = torch.einsum(
                "cij,...cj->...ci", p.m_inv,
                torch.einsum("cni,...ci->...cn", p.K, NFc))
            lam_full[..., system.blob_slice(tj), :] += lam_corr.reshape(
                *batch, -1, 3)
        phi_out.append(Phi.reshape(*batch, -1))
    return torch.cat([lam_full.reshape(*batch, -1),
                      body_full.reshape(*batch, -1)] + phi_out, dim=-1)


def apply_identity_saddle_solver(system: System, state: State, vec):
    """Exact per-body solve of the saddle system with M = I, [I -K; -K^T
    0] [lam; U] = [slip; -F]: the unconstrained mobility solver of the
    GDC-RFD scheme. vec = [slip, F] flat; returns [lam, U]."""
    lam, F, _ = split_saddle_vector(system, vec)
    lam_out, body_out = [], []
    for i, t in enumerate(system.types):
        c, nb = t.count, t.num_blobs
        slip = lam[system.blob_slice(i)].reshape(c, 3 * nb)
        Fb = F[system.body_slice(i)]
        K = kin.K_dense(system, state, i)
        N = torch.linalg.pinv(torch.einsum("cni,cnj->cij", K, K))
        rhs = -Fb - torch.einsum("cni,cn->ci", K, slip)
        Y = torch.einsum("cij,cj->ci", N, rhs)
        lam_out.append((slip + torch.einsum("cni,ci->cn", K, Y)).reshape(-1))
        body_out.append(Y.reshape(-1))
    return torch.cat(lam_out + body_out)


def make_noise_pc(system: System, state: State, pc: BlockDiagPC,
                  r_blobs=None, m_dense=None):
    """Operators for the preconditioned Lanczos noise:
      mobility_pc(w) = P^T M P w   with per-body P = U_chol^{-1}
      L_mult(w)      = U_chol^T w
    so that L sqrt(P^T M P) z has covariance M."""
    if r_blobs is None:
        r_blobs = kin.blob_positions(system, state)

    def _apply_per_body(vec, which):
        out = []
        for i, t in enumerate(system.types):
            p = pc.per_type[i]
            c, nb = t.count, t.num_blobs
            w = vec.reshape(system.num_blobs, 3)[system.blob_slice(i)]
            w = w.reshape(c, 3 * nb)
            if which == "P":
                r = torch.einsum("cij,cj->ci", p.chol_inv, w)
            elif which == "PT":
                r = torch.einsum("cji,cj->ci", p.chol_inv, w)
            else:  # "L": U^T w
                r = torch.einsum("cji,cj->ci", p.chol, w)
            out.append(r.reshape(c * nb * 3))
        return torch.cat(out)

    def mobility_pc(w):
        y = _apply_per_body(w, "P").reshape(system.num_blobs, 3)
        my = _mobility_apply(system, r_blobs, m_dense, y)
        return _apply_per_body(my.reshape(-1), "PT")

    def L_mult(w):
        return _apply_per_body(w, "L")

    return mobility_pc, L_mult


def exact_spectral_capacities(system: System, state, *, margin=1.25,
                              log=None):
    """Size the spectral engine's near-field cell capacity from the actual
    occupancy at this configuration (host numpy): max occupancy x margin,
    rounded up to 8, when the System's is unset or smaller. `margin`
    covers drift between full plan rebuilds. The wall engine bins the
    combined real + image set of its plan (ewald_wall.make_wall_plan).
    No-op for other domains."""
    if not is_spectral(system):
        return system
    p = spectral_params(system)
    r = np.asarray(kin.blob_positions(system, state).detach().cpu().numpy(),
                   np.float64)
    if is_wall_spectral(system):
        Lx, Ly = p.box_xy
        xy = r[:, :2] - np.floor(r[:, :2] / [Lx, Ly]) * [Lx, Ly]
        z = np.clip(r[:, 2], p.a, p.z_hi)
        pos = np.concatenate([
            np.concatenate([xy, (z - p.z0)[:, None]], axis=1),
            np.concatenate([xy, (-z - p.z0)[:, None]], axis=1)])
        csize_z = ewald_wall.Z_CELL_SLACK * p.r_cut
        nz_data = max(int(np.ceil(p.data_extent / csize_z)), 2)
        dims = (max(int(Lx // p.r_cut), 1), max(int(Ly // p.r_cut), 1),
                nz_data + 1)
        box = np.asarray([Lx, Ly, dims[2] * csize_z])
    else:
        box = np.asarray(p.box)
        pos = r - np.floor(r / box) * box
        dims = tuple(max(int(L // p.r_cut), 1) for L in p.box)
    occ = int(np.bincount(cells.host_cell_ids(pos, box, dims)).max())
    cell_cap = -(-int(occ * margin) // 8) * 8
    if log is not None:
        log(f"exact capacities: cell max_occ={occ} -> cap={cell_cap}")
    if 0 < system.spectral_cell_capacity >= cell_cap:
        return system
    return dataclasses.replace(
        system, spectral_cell_capacity=max(cell_cap,
                                           system.spectral_cell_capacity))


def auto_wall_height(system: System, state, *, margin=1.3, log=None):
    """Set a single_wall_spectral System's spectral_wall_height from the
    current maximum blob height times a drift margin (host, at start-up).
    No-op for other domains or when the height is already high enough."""
    if not is_wall_spectral(system):
        return system
    z_max = float(kin.blob_positions(system, state)[:, 2].max())
    z_hi = margin * max(z_max, 2.0 * system.blob_radius)
    if system.spectral_wall_height >= z_hi:
        return system
    if log is not None:
        log(f"wall slab: z_max {z_max:.3g} -> spectral_wall_height "
            f"{z_hi:.3g}")
    return dataclasses.replace(system, spectral_wall_height=z_hi)


def auto_spectral_capacities(system: System, state, *, max_rounds=5,
                             log=None):
    """Grow the spectral engine's cell capacity until a plan at this
    configuration drops no particle (over-capacity cells would drop
    near-field pairs): the wall slab's height first (auto_wall_height),
    the exact host sizing, then plans built and checked, +8 slots a round
    (the wall engine: x 5/4 and at least +8, since slab layouts can
    misestimate the occupied-cell mean). The port's gridding drops
    nothing, so the cells are the only drop count. No-op for other
    domains."""
    if not is_spectral(system):
        return system
    system = auto_wall_height(system, state, log=log)
    system = exact_spectral_capacities(system, state, log=log)
    r_blobs = kin.blob_positions(system, state)
    for _ in range(max_rounds):
        plan = maybe_dense_mobility(system, r_blobs)
        drops = int(plan.n_dropped_cells)
        if log is not None:
            log(f"spectral plan: grid={plan.params.grid} "
                f"r_cut={plan.params.r_cut:.2f} "
                f"cell_cap={plan.params.cell_capacity} dropped={drops}")
        if drops == 0:
            return system
        cap_now = plan.params.cell_capacity
        system = dataclasses.replace(
            system, spectral_cell_capacity=(
                -(-max(cap_now + 8, cap_now * 5 // 4) // 8) * 8
                if is_wall_spectral(system) else cap_now + 8))
    raise ValueError(f"spectral cell capacity still dropping {drops} "
                     f"particles after {max_rounds} rounds of growth")
