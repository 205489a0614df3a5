"""Lubrication-corrected dynamics for sphere suspensions near a wall
(PyTorch).

Counterpart of rigidmultiblobswall_tpu/models/lubrication.py (the
reference's Lub_Solver and Lubrication_Class; BASELINE config 5, the
Uniform_Rollers example):

- the tabulated resistance scalars (Wang-Swan, Jeffrey-Onishi,
  multiblob-consistent, wall) are interpolated linearly, with the analytic
  near-field asymptotics; `LubSolver` moves the tables to its device once;
- the correction Delta_R = R_Sup - R_MB is assembled per step as per-pair
  6x6 blocks, dense-masked over all pairs (O(B^2) blocks: 9.7 GB a block
  array at 4096 spheres in float32) or on a fixed-capacity neighbor list
  (`max_neighbors`, O(B K) blocks, with an overflow count kept on the
  device);
- U = (I + M dR)^{-1}(X + M Xm) by right-preconditioned GMRES, the grand
  RPY wall mobility M applied matrix-free by kernel K1 (grand coupling,
  ops/mobility.grand_mobility_matvec) and a batched 6x6 Cholesky of the
  R_Sup block diagonal as preconditioner;
- `torque_from_omega` solves for the torques that hold every sphere's
  angular velocity at omega (the prescribed-spin mode, optional torque
  cutoff);
- Brownian noise by Lanczos roots of Delta_R and M and RFD drift, with
  Euler-Maruyama and stochastic trapezoidal steps and a single-shot wall
  and jump rejection (a rejected step keeps the old state).

The new algebra (blocks, neighbor selection, block-sparse products,
batched factorizations) is plain PyTorch, as it is XLA in the JAX
package; the forces of `make_ft_calc` run kernel K2. Every normal comes
from `draw_normal` and an explicit torch.Generator, in the order the JAX
steppers draw them from their keys. In a pseudo-periodic box
(`periodic_length`) the pair geometry of Delta_R and the jump check take
the minimum image, the grand mobility K1's image-box instance and the
forces K2's periodic instance, as in the JAX package.

The tables are the port's own copy of the packaged .npz
(rigidmultiblobswall_tpu_torch/data/lubrication_tables.npz);
RMB_TPU_LUB_TABLES, or a directory given to `LubricationTables.load`,
reads reference-format text tables instead.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops import forces as force_ops
from ..ops import mobility as mob
from ..ops import quaternion as quat
from ..ops.gmres import gmres
from ..ops.lanczos import stochastic_forcing_lanczos
from ..ops.pair_kernels import min_image
from ..parallel import mesh as mesh_mod
from .integrators import draw_normal
from .system import resolve_device

_PACKAGED_TABLES = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "data", "lubrication_tables.npz")


def _read_pair_table(path):
    """Alternating 11/12 rows of (x, X_A, Y_A, Y_B, X_C, Y_C)
    (Lubrication_Class.cc:62-100)."""
    with open(path) as f:
        vals = np.array(f.read().split(), dtype=np.float64)
    vals = vals[: (len(vals) // 6) * 6].reshape(-1, 6)
    rows_11 = vals[0::2]
    rows_12 = vals[1::2]
    return rows_11[:, 0].copy(), rows_11[:, 1:].copy(), rows_12[:, 1:].copy()


def _read_wall_table(path, reverse=False):
    with open(path) as f:
        vals = np.array(f.read().split(), dtype=np.float64)
    vals = vals[: (len(vals) // 6) * 6].reshape(-1, 6)
    if reverse:
        vals = vals[::-1]
    return vals[:, 0].copy(), vals[:, 1:].copy()


@dataclasses.dataclass(frozen=True, eq=False)
class LubricationTables:
    """The resistance-scalar tables: float64 numpy arrays on the host, or
    float64 tensors on a device (`to`)."""

    ws_x: np.ndarray
    ws_11: np.ndarray
    ws_12: np.ndarray
    jo_x: np.ndarray
    jo_11: np.ndarray
    jo_12: np.ndarray
    mb_x: np.ndarray
    mb_11: np.ndarray
    mb_12: np.ndarray
    wall_sup_x: np.ndarray
    wall_sup: np.ndarray
    wall_mb_x: np.ndarray
    wall_mb: np.ndarray

    @classmethod
    def load(cls, directory=None):
        """Tables from `directory` (reference text format) when given or
        when RMB_TPU_LUB_TABLES is set; the packaged .npz otherwise."""
        directory = directory or os.environ.get("RMB_TPU_LUB_TABLES")
        if directory is None:
            return cls.load_packaged()
        return cls.load_from_dir(directory)

    @classmethod
    def load_packaged(cls):
        with np.load(_PACKAGED_TABLES) as z:
            return cls(**{k: z[k].copy() for k in z.files})

    @classmethod
    def load_from_dir(cls, directory):
        ws = _read_pair_table(os.path.join(directory, "mob_scalars_WS.txt"))
        jo = _read_pair_table(os.path.join(directory, "res_scalars_JO.txt"))
        mb = _read_pair_table(os.path.join(directory, "res_scalars_MB_1.txt"))
        wsup = _read_wall_table(
            os.path.join(directory,
                         "mob_scalars_wall_MB_2562_eig_thresh.txt"),
            reverse=True)
        wmb = _read_wall_table(
            os.path.join(directory, "res_scalars_wall_MB.txt"))
        return cls(ws_x=ws[0], ws_11=ws[1], ws_12=ws[2],
                   jo_x=jo[0], jo_11=jo[1], jo_12=jo[2],
                   mb_x=mb[0], mb_11=mb[1], mb_12=mb[2],
                   wall_sup_x=wsup[0], wall_sup=wsup[1],
                   wall_mb_x=wmb[0], wall_mb=wmb[1])

    def to(self, device) -> "LubricationTables":
        return LubricationTables(**{
            f.name: torch.as_tensor(getattr(self, f.name),
                                    dtype=torch.float64, device=device)
            for f in dataclasses.fields(self)})


# ---------------------------------------------------------------------------
# Resistance scalars and small matrices
# ---------------------------------------------------------------------------


def _interp_scalars(x_grid, table, r):
    """Linear interpolation of the 5 scalar columns at r, in the tables'
    float64; edge values clamp to the first/last row
    (Lubrication_Class.cc:141-230)."""
    r = r.to(x_grid.dtype)
    idx = torch.clamp(torch.searchsorted(x_grid, r.contiguous()) - 1, 0,
                      x_grid.shape[0] - 2)
    xl = x_grid[idx]
    xr = x_grid[idx + 1]
    w = torch.clamp((r - xl) / (xr - xl), 0.0, 1.0)
    vals = table[idx] * (1 - w[..., None]) + table[idx + 1] * w[..., None]
    vals = torch.where((r < x_grid[0])[..., None], table[0], vals)
    vals = torch.where((r > x_grid[-1])[..., None], table[-1], vals)
    return vals  # (..., 5): X_A, Y_A, Y_B, X_C, Y_C


def _pair_matrix(scal_11, scal_12, r_hat, mob_factor):
    """The 12x12 two-sphere matrix from 2x5 scalars
    (Lubrication_Class.cc:165-252). r_hat (..., 3)."""
    X11A, Y11A, Y11B, X11C, Y11C = scal_11.unbind(-1)
    X12A, Y12A, Y12B, X12C, Y12C = scal_12.unbind(-1)
    mf0, mf1, mf2 = mob_factor

    sq = r_hat[..., :, None] * r_hat[..., None, :]
    eye = torch.eye(3, dtype=r_hat.dtype, device=r_hat.device)
    sh = eye - sq
    zeros = torch.zeros_like(r_hat[..., 0])
    # vortMat in the reference after the -1 flip equals +[r_hat x]
    rx, ry, rz = r_hat.unbind(-1)
    vort = torch.stack([
        torch.stack([zeros, -rz, ry], dim=-1),
        torch.stack([rz, zeros, -rx], dim=-1),
        torch.stack([-ry, rx, zeros], dim=-1),
    ], dim=-2)

    def A(x, y):
        return mf0 * (x[..., None, None] * sq + y[..., None, None] * sh)

    def B(y, sign):
        return sign * mf1 * y[..., None, None] * vort

    def C(x, y):
        return mf2 * (x[..., None, None] * sq + y[..., None, None] * sh)

    row0 = [A(X11A, Y11A), B(Y11B, -1.0), A(X12A, Y12A), B(Y12B, 1.0)]
    row1 = [B(Y11B, 1.0), C(X11C, Y11C), B(Y12B, 1.0), C(X12C, Y12C)]
    row2 = [A(X12A, Y12A), B(Y12B, -1.0), A(X11A, Y11A), B(Y11B, 1.0)]
    row3 = [B(Y12B, -1.0), C(X12C, Y12C), B(Y11B, -1.0), C(X11C, Y11C)]
    rows = [torch.cat(r, dim=-1) for r in (row0, row1, row2, row3)]
    return torch.cat(rows, dim=-2)  # (..., 12, 12)


def _at_scalars(r_norm, dtype):
    """Analytic near-field (asymptotic) two-sphere resistance scalars
    (Lubrication_Class.cc:253-306)."""
    eps = r_norm - 2.0
    le = torch.log(1.0 / eps)
    X11A = 0.995419 + 0.25 / eps + 0.225 * le + 0.0267857 * eps * le
    X12A = -0.350153 - 0.25 / eps - 0.225 * le - 0.0267857 * eps * le
    Y11A = 0.998317 + 0.166667 * le
    Y12A = -0.273652 - 0.166667 * le
    Y11B = -(2.0 / 3.0) * (0.23892 - 0.25 * le - 0.125 * eps * le)
    Y12B = -(2.0 / 3.0) * (-0.162268e-2 + 0.25 * le + 0.125 * eps * le)
    X11C = (4.0 / 3.0) * (1.0518 - 0.125 * eps * le)
    X12C = (4.0 / 3.0) * (-0.150257 + 0.125 * eps * le)
    Y11C = (4.0 / 3.0) * (0.702834 + 0.2 * le + 0.188 * eps * le)
    Y12C = (4.0 / 3.0) * (-0.27464e-1 + 0.05 * le + 0.062 * eps * le)
    s11 = torch.stack([X11A, Y11A, Y11B, X11C, Y11C], dim=-1)
    s12 = torch.stack([X12A, Y12A, Y12B, X12C, Y12C], dim=-1)
    return s11.to(dtype), s12.to(dtype)


def pair_resistance_sup(r_norm, r_hat, mob_factor, tables, debye_cut):
    """Exact ('super') pair resistance: AT asymptotics for r < 2.006, the
    inverse of the interpolated WS mobility for r < 2.1, interpolated JO
    resistance otherwise (Lubrication_Class.cc:481-525). All three
    branches are evaluated for every pair and one is selected, as in the
    JAX package; the 12x12 inverses take no error check (no host sync;
    a singular unselected block is discarded)."""
    dtype = r_hat.dtype
    eps = r_norm - 2.0
    r_norm = torch.where(eps < debye_cut, 2.0 + debye_cut, r_norm)

    AT_cut = 2.0 + 0.006 - 1e-8
    WS_cut = 2.0 + 0.1 + 1e-8

    # branch 1: analytic asymptotics
    s11_at, s12_at = _at_scalars(torch.clamp(r_norm, min=2.0 + 1e-8), dtype)
    R_at = _pair_matrix(s11_at, s12_at, r_hat, mob_factor)

    # branch 2: inverse of the WS mobility (the scalars are mobilities:
    # assembled with reciprocal prefactors, then inverted)
    s11_ws = _interp_scalars(tables.ws_x, tables.ws_11, r_norm).to(dtype)
    s12_ws = _interp_scalars(tables.ws_x, tables.ws_12, r_norm).to(dtype)
    inv_factor = tuple(1.0 / f for f in mob_factor)
    M_ws = _pair_matrix(s11_ws, s12_ws, r_hat, inv_factor)
    R_ws = torch.linalg.inv_ex(M_ws).inverse

    # branch 3: interpolated JO resistance
    s11_jo = _interp_scalars(tables.jo_x, tables.jo_11, r_norm).to(dtype)
    s12_jo = _interp_scalars(tables.jo_x, tables.jo_12, r_norm).to(dtype)
    R_jo = _pair_matrix(s11_jo, s12_jo, r_hat, mob_factor)

    sel_at = (r_norm <= AT_cut)[..., None, None]
    sel_ws = ((r_norm > AT_cut) & (r_norm <= WS_cut))[..., None, None]
    return torch.where(sel_at, R_at, torch.where(sel_ws, R_ws, R_jo))


def pair_resistance_mb(r_norm, r_hat, mob_factor, tables, debye_cut):
    """Multiblob-consistent pair resistance (interpolated MB tables,
    Lubrication_Class.cc:527-552)."""
    dtype = r_hat.dtype
    eps = r_norm - 2.0
    r_norm = torch.where(eps < debye_cut, 2.0 + debye_cut, r_norm)
    s11 = _interp_scalars(tables.mb_x, tables.mb_11, r_norm).to(dtype)
    s12 = _interp_scalars(tables.mb_x, tables.mb_12, r_norm).to(dtype)
    return _pair_matrix(s11, s12, r_hat, mob_factor)


def wall_resistance_sup(h, mob_factor, tables, debye_cut, dtype):
    """Wall resistance from resolved-sphere mobility tables with near-field
    lubrication asymptotics (Lubrication_Class.cc:307-411). h = z/a."""
    eps0 = h - 1.0
    eps = torch.clamp(eps0, min=debye_cut)
    h_eff = 1.0 + eps
    s = _interp_scalars(tables.wall_sup_x, tables.wall_sup, h_eff)
    Xa_t, Ya_t, Yb_t, Xc_t, Yc_t = s.to(dtype).unbind(-1)
    # far-field closed forms beyond the table (:336-342)
    far = h_eff > tables.wall_sup_x[-1].to(dtype)
    Xa_t = torch.where(far, 1.0 - (9.0 / 8.0) / h_eff, Xa_t)
    Ya_t = torch.where(far, 1.0 - (9.0 / 16.0) / h_eff, Ya_t)
    Yb_t = torch.where(far, 0.0, Yb_t)
    Xc_t = torch.where(far, 0.75, Xc_t)
    Yc_t = torch.where(far, 0.75, Yc_t)

    le = torch.log(eps)
    Xa_asym = 1.0 / eps - 0.2 * le + 0.971280
    Ya_asym = -(8.0 / 15.0) * le + 0.9588
    Yb_asym = (4.0 / 3.0) * (-(-(0.1) * le - 0.1895) - 0.4576 * eps)
    Xc_asym = (4.0 / 3.0) * (1.2020569 - 3.0 * (math.pi ** 2 / 6.0 - 1.0)
                             * eps)
    Yc_asym = (4.0 / 3.0) * (-0.4 * le + 0.3817 + 1.4578 * eps)

    denom = Ya_t * Yc_t - Yb_t * Yb_t
    RXa = 1.0 / Xa_t
    RYa = Yc_t / denom
    RYb = -Yb_t / denom
    RXc = 1.0 / Xc_t
    RYc = Ya_t / denom

    Xa = torch.where(h_eff > 1.1, RXa, Xa_asym)
    Ya = torch.where(h_eff > 1.01, RYa, Ya_asym)
    Yb = torch.where(h_eff > 1.1, RYb, Yb_asym)
    Xc = torch.where(h_eff > 1.01, RXc, Xc_asym)
    Yc = torch.where(h_eff > 1.1, RYc, Yc_asym)
    XcPlus = torch.clamp(Xc - 4.0 / 3.0, min=0.0)
    YcPlus = torch.clamp(Yc - 4.0 / 3.0, min=0.0)
    return _wall_6x6(Xa, Ya, Yb, YcPlus, XcPlus, mob_factor, dtype)


def wall_resistance_mb(h, mob_factor, tables, debye_cut, dtype):
    """Wall resistance from multiblob resistance tables
    (Lubrication_Class.cc:413-479). h = z/a."""
    eps = torch.clamp(h - 1.0, min=debye_cut)
    h_eff = 1.0 + eps
    s = _interp_scalars(tables.wall_mb_x, tables.wall_mb, h_eff)
    Xa, Ya, Yb, Xc, Yc = s.to(dtype).unbind(-1)
    far = h_eff > tables.wall_mb_x[-1].to(dtype)
    Xa = torch.where(far, 1.0 / (1.0 - (9.0 / 8.0) / h_eff), Xa)
    Ya = torch.where(far, 1.0 / (1.0 - (9.0 / 16.0) / h_eff), Ya)
    Yb = torch.where(far, 0.0, Yb)
    Xc = torch.where(far, 4.0 / 3.0, Xc)
    Yc = torch.where(far, 4.0 / 3.0, Yc)
    return _wall_6x6(Xa, Ya, Yb, Yc - 4.0 / 3.0, Xc - 4.0 / 3.0,
                     mob_factor, dtype)


def _wall_6x6(Xa, Ya, Yb, YcPlus, XcPlus, mob_factor, dtype):
    """Rows per Lubrication_Class.cc:392-404: diag(Ya-1, Ya-1, Xa-1) on
    translation, (YcPlus, YcPlus, XcPlus) on rotation, +-Yb coupling."""
    mf0, mf1, mf2 = mob_factor
    z = torch.zeros_like(Xa)
    rows = [
        torch.stack([mf0 * (Ya - 1.0), z, z, z, mf1 * Yb, z], dim=-1),
        torch.stack([z, mf0 * (Ya - 1.0), z, -mf1 * Yb, z, z], dim=-1),
        torch.stack([z, z, mf0 * (Xa - 1.0), z, z, z], dim=-1),
        torch.stack([z, -mf1 * Yb, z, mf2 * YcPlus, z, z], dim=-1),
        torch.stack([mf1 * Yb, z, z, z, mf2 * YcPlus, z], dim=-1),
        torch.stack([z, z, z, z, z, mf2 * XcPlus], dim=-1),
    ]
    return torch.stack(rows, dim=-2).to(dtype)


# ---------------------------------------------------------------------------
# The solver, Delta_R block assembly and application
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class LubSolver:
    """Static configuration (Lub_Solver.py:29-96) and the tables on the
    solver's device (the card unless `device` names another; moved once,
    at construction). tables None loads `LubricationTables.load()`."""

    num_bodies: int
    eta: float = 1.0
    a: float = 1.0
    kT: float = 0.0
    dt: float = 1e-3
    cutoff: float = 4.5           # pair cutoff in units of a (Lub_Cut)
    cutoff_wall: float = 4.5      # wall cutoff in units of a
    debye_cut: float = 1e-2       # firm_delta: clamp of the gap
    rf_delta: float = 1e-3
    periodic_length: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    solver_tolerance: float = 1e-6
    lanczos_max_iter: int = 100
    # if set, Delta_R is assembled on a fixed-capacity neighbor list
    # (O(B K) memory); None keeps the dense-masked O(B^2) blocks
    max_neighbors: Optional[int] = None
    use_pc: bool = True           # precondition (I + M dR) like Lub_Solver
    tables: Optional[LubricationTables] = None
    device: Optional[object] = None
    # parallel/mesh.Mesh: the wall mobility products split across its ranks
    mesh: Optional[object] = dataclasses.field(default=None, compare=False)
    # the tables as tensors on the device, set at construction
    device_tables: LubricationTables = dataclasses.field(
        default=None, init=False, repr=False)

    def __post_init__(self):
        object.__setattr__(self, "periodic_length",
                           tuple(float(x) for x in self.periodic_length))
        if self.tables is None:
            object.__setattr__(self, "tables", LubricationTables.load())
        device = resolve_device(self.device)
        object.__setattr__(self, "device", device)
        object.__setattr__(self, "device_tables", self.tables.to(device))

    @property
    def mobility_kwargs(self):
        kw = dict(domain="single_wall", periodic_length=self.periodic_length)
        if self.mesh is not None:
            kw["mesh"] = self.mesh
        return kw

    @property
    def mob_factor(self):
        return (6.0 * math.pi * self.eta * self.a,
                6.0 * math.pi * self.eta * self.a ** 2,
                6.0 * math.pi * self.eta * self.a ** 3)


def from_reference(ref_sol, device=None, mesh=None) -> LubSolver:
    """Carry a JAX-package `LubSolver` and its tables (numpy) across to
    the port's, on `device` (default the card). A JAX mesh cannot cross to
    torch: the port's solver takes `mesh` (a parallel/mesh.Mesh, or None)
    whatever the reference's."""
    tables = ref_sol.tables
    if tables is not None:
        tables = LubricationTables(**{
            f.name: np.asarray(getattr(tables, f.name), np.float64)
            for f in dataclasses.fields(LubricationTables)})
    skip = ("tables", "device", "device_tables", "mesh")
    fields = {f.name: getattr(ref_sol, f.name)
              for f in dataclasses.fields(LubSolver) if f.name not in skip}
    return LubSolver(**fields, tables=tables, device=device, mesh=mesh)


class DeltaRBlocks(NamedTuple):
    diag: torch.Tensor      # (B,6,6) summed self blocks + wall blocks
    offdiag: torch.Tensor   # (B,B,6,6) masked pair coupling blocks
    diag_sup: torch.Tensor  # (B,6,6) R_Sup diagonal blocks (for the PC)
    diag_mb: torch.Tensor   # (B,6,6) R_MB diagonal blocks (for the PC)
    isolated: torch.Tensor  # (B,) no neighbors and far from the wall
    overflow: torch.Tensor  # () int32, always 0 (no capacity)


class SparseDeltaR(NamedTuple):
    """Delta_R on a fixed-capacity neighbor list: O(B K) memory
    (Lub_Solver.py:98-186, Lubrication_Class.cc:554-700)."""

    idx: torch.Tensor       # (B,K) neighbor indices (self-padded)
    mask: torch.Tensor      # (B,K) True where a real in-range neighbor
    diag: torch.Tensor      # (B,6,6) Delta_R diagonal blocks incl. wall
    off: torch.Tensor       # (B,K,6,6) Delta_R coupling blocks j->idx[j,k]
    diag_sup: torch.Tensor  # (B,6,6)
    diag_mb: torch.Tensor   # (B,6,6)
    isolated: torch.Tensor  # (B,)
    overflow: torch.Tensor  # () int32: true neighbors beyond capacity K


def _wall_blocks(sol: LubSolver, pos, dtype):
    """(W_sup, W_mb, wall_on) per body."""
    h = pos[:, 2] / sol.a
    W_sup = wall_resistance_sup(h, sol.mob_factor, sol.device_tables,
                                sol.debye_cut, dtype)
    W_mb = wall_resistance_mb(h, sol.mob_factor, sol.device_tables,
                              sol.debye_cut, dtype)
    wall_on = h < sol.cutoff_wall
    on = wall_on[:, None, None]
    return (torch.where(on, W_sup, 0.0), torch.where(on, W_mb, 0.0),
            wall_on)


def compute_delta_r_blocks(sol: LubSolver, pos) -> DeltaRBlocks:
    """Delta_R = R_Sup - R_MB as per-pair blocks (Set_R_Mats,
    Lub_Solver.py:98-275). Dense-masked over all pairs; use
    `compute_delta_r_sparse` (sol.max_neighbors) for large B."""
    dtype = pos.dtype
    B = sol.num_bodies

    d = min_image(pos[:, None, :] - pos[None, :, :],
                  sol.periodic_length) / sol.a
    r2 = torch.sum(d * d, dim=-1)
    self_mask = torch.eye(B, dtype=torch.bool, device=pos.device)
    r_norm = torch.sqrt(torch.where(self_mask, 4.0, r2))
    # reference: r_hat = -(r_j - r_k)/|.| points from j to k
    r_hat = -d / r_norm[..., None]
    in_range = (~self_mask) & (r_norm < sol.cutoff)

    R_sup = pair_resistance_sup(r_norm, r_hat, sol.mob_factor,
                                sol.device_tables, sol.debye_cut)
    R_mb = pair_resistance_mb(r_norm, r_hat, sol.mob_factor,
                              sol.device_tables, sol.debye_cut)
    keep = in_range[..., None, None]
    R_sup = torch.where(keep, R_sup, 0.0)
    R_mb = torch.where(keep, R_mb, 0.0)
    dR = R_sup - R_mb

    diag = torch.sum(dR[:, :, 0:6, 0:6], dim=1)      # sum_k jj blocks
    offdiag = dR[:, :, 0:6, 6:12]                    # jk blocks

    W_sup, W_mb, wall_on = _wall_blocks(sol, pos, dtype)
    diag_sup = torch.sum(R_sup[:, :, 0:6, 0:6], dim=1) + W_sup
    diag_mb = torch.sum(R_mb[:, :, 0:6, 0:6], dim=1) + W_mb
    diag = diag + W_sup - W_mb
    isolated = (~torch.any(in_range, dim=1)) & (~wall_on)
    return DeltaRBlocks(
        diag=diag, offdiag=offdiag, diag_sup=diag_sup, diag_mb=diag_mb,
        isolated=isolated,
        overflow=torch.zeros((), dtype=torch.int32, device=pos.device))


def compute_delta_r_sparse(sol: LubSolver, pos) -> SparseDeltaR:
    """Delta_R on a fixed-capacity neighbor list (K = sol.max_neighbors).

    The neighbor search is an O(B^2) distance sweep (only (B,B) scalars,
    never (B,B,6,6) blocks) keeping the K nearest in-range bodies per row
    by a stable sort, as the JAX package does; `overflow` counts the true
    neighbors dropped past capacity, on the device, so a caller can fail
    loudly without a host sync inside the step."""
    K = int(sol.max_neighbors)
    dtype = pos.dtype
    B = sol.num_bodies
    dev = pos.device

    L = sol.periodic_length
    d_all = min_image(pos[:, None, :] - pos[None, :, :], L) / sol.a
    r2 = torch.sum(d_all * d_all, dim=-1)
    self_mask = torch.eye(B, dtype=torch.bool, device=dev)
    in_range = (~self_mask) & (r2 < sol.cutoff * sol.cutoff)
    counts = torch.sum(in_range, dim=1)
    overflow = torch.clamp(torch.max(counts) - K, min=0).to(torch.int32)

    r2_sort = torch.where(in_range, r2, math.inf)
    order = torch.argsort(r2_sort, dim=1, stable=True)[:, :K]    # (B,K)
    mask = torch.gather(in_range, 1, order)                      # (B,K)
    idx = torch.where(mask, order,
                      torch.arange(B, device=dev)[:, None])      # self-pad

    pos_k = pos[idx]                                             # (B,K,3)
    d = min_image(pos[:, None, :] - pos_k, L) / sol.a
    r_norm = torch.sqrt(torch.where(mask, torch.sum(d * d, dim=-1), 16.0))
    r_hat = -d / r_norm[..., None]

    R_sup = pair_resistance_sup(r_norm, r_hat, sol.mob_factor,
                                sol.device_tables, sol.debye_cut)
    R_mb = pair_resistance_mb(r_norm, r_hat, sol.mob_factor,
                              sol.device_tables, sol.debye_cut)
    keep = mask[..., None, None]
    R_sup = torch.where(keep, R_sup, 0.0)
    R_mb = torch.where(keep, R_mb, 0.0)
    dR = R_sup - R_mb

    W_sup, W_mb, wall_on = _wall_blocks(sol, pos, dtype)
    diag_sup = torch.sum(R_sup[:, :, 0:6, 0:6], dim=1) + W_sup
    diag_mb = torch.sum(R_mb[:, :, 0:6, 0:6], dim=1) + W_mb
    diag = torch.sum(dR[:, :, 0:6, 0:6], dim=1) + W_sup - W_mb
    off = dR[:, :, 0:6, 6:12]
    isolated = (~torch.any(mask, dim=1)) & (~wall_on)
    return SparseDeltaR(idx=idx, mask=mask, diag=diag, off=off,
                        diag_sup=diag_sup, diag_mb=diag_mb,
                        isolated=isolated, overflow=overflow)


def compute_blocks(sol: LubSolver, pos):
    """Dense-masked or neighbor-list Delta_R per sol.max_neighbors."""
    if sol.max_neighbors is not None:
        return compute_delta_r_sparse(sol, pos)
    return compute_delta_r_blocks(sol, pos)


def delta_r_mult(blocks, X):
    """Delta_R @ X for X (6B,) in interleaved [F_1 T_1 F_2 T_2 ...]
    layout (dense-masked or neighbor-list blocks)."""
    B = blocks.diag.shape[0]
    x = X.reshape(B, 6)
    out = torch.einsum("bij,bj->bi", blocks.diag, x)
    if isinstance(blocks, SparseDeltaR):
        xk = x[blocks.idx] * blocks.mask[..., None]
        out = out + torch.einsum("bkij,bkj->bi", blocks.off, xk)
    else:
        out = out + torch.einsum("bkij,kj->bi", blocks.offdiag, x)
    return out.reshape(-1)


def delta_r_sub_mult(blocks, v3, rows=slice(3, 6), cols=slice(0, 3)):
    """Apply a 3x3 sub-block family of Delta_R (e.g. the rot-trans
    coupling of the Torque_from_Omega preconditioner,
    Lub_Solver.py:962-975) to a (3B,) vector."""
    B = blocks.diag.shape[0]
    v = v3.reshape(B, 3)
    out = torch.einsum("bij,bj->bi", blocks.diag[:, rows, cols], v)
    if isinstance(blocks, SparseDeltaR):
        vk = v[blocks.idx] * blocks.mask[..., None]
        out = out + torch.einsum("bkij,bkj->bi",
                                 blocks.off[:, :, rows, cols], vk)
    else:
        out = out + torch.einsum("bkij,kj->bi",
                                 blocks.offdiag[:, :, rows, cols], v)
    return out.reshape(-1)


def _cholesky(A):
    """Batched lower Cholesky factors without an error check (no host
    sync); a block that is not positive definite gets NaN factors, as
    jnp.linalg.cholesky gives."""
    chol, info = torch.linalg.cholesky_ex(A)
    return torch.where((info == 0)[:, None, None], chol, math.nan)


def make_lub_pc(sol: LubSolver, blocks):
    """Right preconditioner for (I + M dR) (Lub_Solver.py:541-588, IpMDR_PC
    :426-443): PC(X) = R_MB,diag (R_Sup,diag + small I)^{-1} X, with a
    batched 6x6 Cholesky of the R_Sup block diagonal; identity on isolated
    bodies (where R_MB = 0 and the reference bypasses too)."""
    small = 6.0 * math.pi * sol.eta * sol.a * sol.solver_tolerance
    A = blocks.diag_sup + small * torch.eye(
        6, dtype=blocks.diag_sup.dtype, device=blocks.diag_sup.device)
    chol = _cholesky(A)
    iso = blocks.isolated[:, None]

    def pc(X):
        x = X.reshape(-1, 6)
        y = torch.cholesky_solve(x[..., None], chol)[..., 0]
        y = torch.einsum("bij,bj->bi", blocks.diag_mb, y)
        return torch.where(iso, x, y).reshape(-1)

    return pc


def wall_mobility_mult(sol: LubSolver, pos, X):
    """Grand RPY wall mobility times an interleaved (F,T) vector
    (Lub_Solver.py:277-307): one kernel K1 grand product (its image-box
    instance in a pseudo-periodic box)."""
    B = sol.num_bodies
    ft = X.reshape(B, 6)
    u, w = mob.grand_mobility_matvec(pos, ft[:, 0:3], ft[:, 3:6], sol.eta,
                                     sol.a, **sol.mobility_kwargs)
    return torch.cat([u, w], dim=1).reshape(-1)


def _normalized(rhs):
    """(|rhs|, the divisor that normalizes rhs: |rhs|, or 1 for a zero
    rhs)."""
    rhs_norm = torch.linalg.norm(rhs)
    safe = torch.where(rhs_norm > 0, rhs_norm, torch.ones_like(rhs_norm))
    return rhs_norm, safe


def lub_solve(sol: LubSolver, pos, blocks, X=None, Xm=None,
              x0=None, maxiter=1000, restart=100):
    """U = (I + M dR)^{-1} (X + M Xm) by right-preconditioned GMRES
    (Lubrucation_solve, Lub_Solver.py:518-604). Returns (U, iterations)."""
    n = 6 * sol.num_bodies
    rhs = torch.zeros(n, dtype=pos.dtype, device=pos.device)
    if Xm is not None:
        rhs = rhs + wall_mobility_mult(sol, pos, Xm.reshape(-1))
    if X is not None:
        rhs = rhs + X.reshape(-1)

    def op(v):
        return v + wall_mobility_mult(sol, pos, delta_r_mult(blocks, v))

    pc = make_lub_pc(sol, blocks) if sol.use_pc else None
    rhs_norm, safe = _normalized(rhs)
    if x0 is not None:
        x0 = x0 / safe
    res = gmres(op, rhs / safe, x0=x0, tol=sol.solver_tolerance,
                restart=restart, maxiter=maxiter, M=pc)
    return res.x * rhs_norm, res.iterations


def lub_rfd_solve(sol: LubSolver, pos, blocks, X, maxiter=1000,
                  restart=100):
    """(I + dR M)^{-1} X, the transposed system (Lub_Solver.py:478-517)."""
    def op(v):
        return v + delta_r_mult(blocks, wall_mobility_mult(sol, pos, v))

    rhs_norm, safe = _normalized(X)
    res = gmres(op, X.reshape(-1) / safe, tol=sol.solver_tolerance,
                restart=restart, maxiter=maxiter)
    return res.x * rhs_norm, res.iterations


def _omega_per_body(omega, B, dtype, device):
    """omega as (B, 3): a scalar spins about y_hat (the reference
    convention, Lub_Solver.py:927-929), a (3,) vector is broadcast, a
    (B, 3) array is per body."""
    omega = torch.as_tensor(omega, dtype=dtype, device=device)
    if omega.ndim == 0:
        zero = torch.zeros_like(omega)
        omega = torch.stack([zero, omega, zero])
    if omega.ndim == 1:
        omega = omega.reshape(-1, 3)[-1]
    return omega.expand(B, 3)


def torque_from_omega(sol: LubSolver, pos, blocks, omega, F,
                      cut_torque=None, maxiter=100, restart=100):
    """Torques that (approximately) constrain every body's angular
    velocity to `omega` given forces F (Torque_from_Omega,
    Lub_Solver.py:890-1025; the Uniform_Rollers example).

    Solves for (V, T): -(I + M dR) [V; 0] + M [0; T] = (I + M dR)[0; w]
    - M [F; 0], preconditioned with batched 3x3 Cholesky factors of
    (6 pi eta a I + dR_tt) (:962-975). Returns (T, VO_guess, iterations)."""
    B = sol.num_bodies
    dtype = pos.dtype
    omega = _omega_per_body(omega, B, dtype, pos.device)
    F = F.reshape(B, 3).to(dtype)
    c1 = 6.0 * math.pi * sol.eta * sol.a
    c2 = 8.0 * math.pi * sol.eta * sol.a ** 3

    def ipmdr(v):
        return v + wall_mobility_mult(sol, pos, delta_r_mult(blocks, v))

    def pack(V, T):
        return torch.cat([V, T], dim=1).reshape(-1)

    zeros3 = torch.zeros((B, 3), dtype=dtype, device=pos.device)
    rhs = ipmdr(pack(zeros3, omega)) - wall_mobility_mult(
        sol, pos, pack(F, zeros3))

    def op(vt):
        x = vt.reshape(B, 6)
        V, T = x[:, 0:3], x[:, 3:6]
        return ipmdr(pack(-V, zeros3)) + wall_mobility_mult(
            sol, pos, pack(zeros3, T))

    # PC: V-block from batched (c1 I + dR_tt,diag) factors; T-block
    # c2 ab_rot + dR_rt V (Lub_Solver.py:955-975)
    Vmat = blocks.diag[:, 0:3, 0:3] + c1 * torch.eye(3, dtype=dtype,
                                                     device=pos.device)
    chol = _cholesky(Vmat)

    def pc(ab):
        x = ab.reshape(B, 6)
        a = -c1 * x[:, 0:3]
        v = torch.cholesky_solve(a[..., None], chol)[..., 0]
        t = c2 * x[:, 3:6] + delta_r_sub_mult(blocks, v.reshape(-1)).reshape(
            B, 3)
        return pack(v, t)

    rhs_norm, safe = _normalized(rhs)
    x0 = pack(zeros3, c2 * omega) / safe
    res = gmres(op, rhs / safe, x0=x0, tol=sol.solver_tolerance,
                restart=restart, maxiter=maxiter, M=pc)
    vt = (res.x * rhs_norm).reshape(B, 6)
    T = vt[:, 3:6]
    if cut_torque is not None:
        Tn = torch.linalg.norm(T, dim=1)
        pos_n = Tn > 0
        scale = torch.where(
            pos_n, torch.clamp(Tn, max=cut_torque)
            / torch.where(pos_n, Tn, torch.ones_like(Tn)),
            torch.ones_like(Tn))
        T = T * scale[:, None]
    vo_guess = pack(vt[:, 0:3], omega)
    return T, vo_guess, res.iterations


def mobility_root_rhs(sol: LubSolver, pos, blocks, generator):
    """sqrt(2kT/dt) (dR^{1/2} W1, M^{1/2} W2) via Lanczos on the shifted
    Delta_R and on M (Lub_Solver.py:373-407). Draws W1, then W2. Returns
    (root_xm, root_x, lanczos iterations)."""
    n = 6 * sol.num_bodies
    W1 = draw_normal(generator, (n,), pos)
    W2 = draw_normal(generator, (n,), pos)
    small = 6.0 * math.pi * sol.eta * sol.a * sol.solver_tolerance
    factor = math.sqrt(2.0 * sol.kT / sol.dt)

    res_dr = stochastic_forcing_lanczos(
        lambda v: delta_r_mult(blocks, v) + small * v, W1, factor=factor,
        tolerance=sol.solver_tolerance, max_iter=sol.lanczos_max_iter)
    res_m = stochastic_forcing_lanczos(
        lambda v: wall_mobility_mult(sol, pos, v), W2, factor=factor,
        tolerance=sol.solver_tolerance, max_iter=sol.lanczos_max_iter)
    return res_dr.noise, res_m.noise, res_dr.iterations + res_m.iterations


def _rfd_positions(sol: LubSolver, pos, W):
    """Qp, Qm = pos +- (rf_delta / 2) W_trans."""
    Wrfd = W.reshape(sol.num_bodies, 6)[:, 0:3]
    return (pos + (sol.rf_delta / 2.0) * Wrfd,
            pos - (sol.rf_delta / 2.0) * Wrfd)


def rfd_rhs(sol: LubSolver, pos, blocks, generator):
    """The RFD divergence RHS pair (Lub_Mobility_RFD_RHS,
    Lub_Solver.py:309-342), one normal W drawn. Returns (RHS_Xm, RHS_X,
    gmres iterations, the largest neighbor overflow at Qp and Qm)."""
    W = draw_normal(generator, (6 * sol.num_bodies,), pos)
    Qp, Qm = _rfd_positions(sol, pos, W)

    blocks_p = compute_blocks(sol, Qp)
    blocks_m = compute_blocks(sol, Qm)

    UWrfd, its = lub_rfd_solve(sol, pos, blocks, W)
    MUW = wall_mobility_mult(sol, pos, UWrfd)
    rhs_xm = (delta_r_mult(blocks_m, MUW)
              - delta_r_mult(blocks_p, MUW)) / sol.rf_delta

    MpW = wall_mobility_mult(sol, Qp, UWrfd)
    MmW = wall_mobility_mult(sol, Qm, UWrfd)
    rhs_x = (MpW - MmW) / sol.rf_delta
    return rhs_xm, rhs_x, its, torch.maximum(blocks_p.overflow,
                                             blocks_m.overflow)


# ---------------------------------------------------------------------------
# Time stepping
# ---------------------------------------------------------------------------


class LubStepAux(NamedTuple):
    velocities: torch.Tensor
    det_iterations: int
    stoch_iterations: int
    rejections_wall: torch.Tensor    # () int32, on the device
    rejections_jump: torch.Tensor    # () int32, on the device
    # the largest neighbor-list overflow over the step's Delta_R
    # assemblies, () int32 on the device; must stay 0, else raise
    # max_neighbors
    neighbor_overflow: torch.Tensor


def make_ft_calc(*, a, g, repulsion_strength, debye_length,
                 repulsion_strength_wall, debye_length_wall,
                 repulsion_strength_firm=0.0, firm_delta=1e-2,
                 periodic_length=(0.0, 0.0, 0.0)):
    """ft_calc(pos) -> (B, 6) interleaved force-torques of the
    Uniform_Rollers composition (the JAX CLI's, cli.py:296-323): gravity,
    wall Yukawa and pair soft repulsion on the sphere centers (kernel
    K2), and with repulsion_strength_firm > 0 the firm wall and pair terms
    (main_rollers.py:141-143): the same Yukawa forms at the effective
    radius a (1 - firm_delta) with Debye length 2 a firm_delta / ln 10;
    the pair terms under the minimum image and the image boxes of
    periodic_length (K2's periodic instance)."""
    debye_firm = 2.0 * a * firm_delta / math.log(1e1)

    def ft_calc(pos):
        f = force_ops.blob_external_forces(
            pos, g=g, blob_radius=a,
            repulsion_strength_wall=repulsion_strength_wall,
            debye_length_wall=debye_length_wall)
        f = f + force_ops.blob_blob_forces(
            pos, repulsion_strength=repulsion_strength,
            debye_length=debye_length, blob_radius=a,
            periodic_length=periodic_length)
        if repulsion_strength_firm > 0.0:
            f = f + force_ops.blob_external_forces(
                pos, g=0.0, blob_radius=a * (1.0 - firm_delta),
                repulsion_strength_wall=repulsion_strength_firm,
                debye_length_wall=debye_firm)
            f = f + force_ops.blob_blob_forces(
                pos, repulsion_strength=repulsion_strength_firm,
                debye_length=debye_firm, blob_radius=a * (1.0 - firm_delta),
                periodic_length=periodic_length)
        return torch.cat([f, torch.zeros_like(f)], dim=1)

    return ft_calc


def _check_jump(sol: LubSolver, pos_new, pos_old):
    """Wall + max-displacement rejection (Lub_Solver.py:1027-1079), as
    device booleans."""
    wall_bad = torch.any(pos_new[:, 2] < 0.0)
    disp = min_image(pos_new - pos_old, sol.periodic_length)
    jump_bad = torch.any(torch.linalg.norm(disp, dim=1) > 2.0 * sol.a)
    return wall_bad, jump_bad


def _accept(sol, pos, quats, pos_new, quat_new):
    """(positions, quaternions, wall_bad, jump_bad): a rejected step keeps
    the old state (single-shot, as the reference), selected on the
    device."""
    wall_bad, jump_bad = _check_jump(sol, pos_new, pos)
    reject = wall_bad | jump_bad
    return (torch.where(reject, pos, pos_new),
            torch.where(reject, quats, quat_new), wall_bad, jump_bad)


def _on_mesh(step):
    """The step under sol.mesh: every rank runs it, its decisions are rank
    0's (parallel/mesh.replicated), and every rank leaves it with rank 0's
    positions and orientations."""
    @functools.wraps(step)
    def wrapped(sol, pos, quats, *args, **kw):
        with mesh_mod.replicated(sol.mesh):
            pos_out, quat_out, aux = step(sol, pos, quats, *args, **kw)
            if mesh_mod.is_sharded(sol.mesh):
                pos_out = mesh_mod.broadcast(sol.mesh, pos_out)
                quat_out = mesh_mod.broadcast(sol.mesh, quat_out)
        return pos_out, quat_out, aux

    return wrapped


@_on_mesh
def step_euler_maruyama(sol: LubSolver, pos, quats, generator, ft_calc):
    """Lubrication-corrected EM step (Update_Bodies, Lub_Solver.py:641-663,
    :722-747). ft_calc(pos) -> (B,6) interleaved. With kT > 0 draws W1 and
    W2 (the roots), then W (the RFD)."""
    blocks = compute_blocks(sol, pos)
    overflow = blocks.overflow
    FT = ft_calc(pos).reshape(-1)
    stoch_its = 0
    if sol.kT > 0:
        root_xm, root_x, it_l = mobility_root_rhs(sol, pos, blocks,
                                                  generator)
        drift_xm, drift_x, _, ovf = rfd_rhs(sol, pos, blocks, generator)
        overflow = torch.maximum(overflow, ovf)
        rhs_xm = root_xm + sol.kT * drift_xm + FT
        rhs_x = root_x + sol.kT * drift_x
        stoch_its = it_l
    else:
        rhs_xm = FT
        rhs_x = None
    vel, its = lub_solve(sol, pos, blocks, X=rhs_x, Xm=rhs_xm)
    v = vel.reshape(sol.num_bodies, 6)
    pos_new = pos + sol.dt * v[:, 0:3]
    quat_new = quat.step(quats, v[:, 3:6], sol.dt)
    pos_out, quat_out, wall_bad, jump_bad = _accept(sol, pos, quats,
                                                    pos_new, quat_new)
    aux = LubStepAux(velocities=v, det_iterations=its,
                     stoch_iterations=stoch_its,
                     rejections_wall=wall_bad.to(torch.int32),
                     rejections_jump=(jump_bad & ~wall_bad).to(torch.int32),
                     neighbor_overflow=overflow)
    return pos_out, quat_out, aux


@_on_mesh
def step_trapezoidal(sol: LubSolver, pos, quats, generator, ft_calc,
                     omega=None, cut_torque=None):
    """Stochastic trapezoidal update (Update_Bodies_Trap,
    Lub_Solver.py:749-888). If `omega` is given, per-body torques that
    constrain the angular velocity are solved for and injected before the
    predictor (and reused in the corrector, the reference's
    second_order=False path, :838-851), optionally norm-capped at
    `cut_torque`: the Uniform_Rollers prescribed-spin mode. Draws W1 and
    W2 (the roots), then W (the RFD of M)."""
    B = sol.num_bodies
    blocks = compute_blocks(sol, pos)
    FT = ft_calc(pos).reshape(-1)
    vo_guess = None
    torque_its = 0
    if omega is not None:
        ftr = FT.reshape(B, 6)
        T_omega, vo_guess, torque_its = torque_from_omega(
            sol, pos, blocks, omega, ftr[:, 0:3], cut_torque=cut_torque)
        FT = torch.cat([ftr[:, 0:3], ftr[:, 3:6] + T_omega],
                       dim=1).reshape(-1)

    root_xm, root_x, it_l = mobility_root_rhs(sol, pos, blocks, generator)
    m_half = root_x + wall_mobility_mult(sol, pos, root_xm)

    vel_p, its1 = lub_solve(sol, pos, blocks, X=m_half, Xm=FT, x0=vo_guess)
    vp = vel_p.reshape(B, 6)
    pos_mid = pos + sol.dt * vp[:, 0:3]

    blocks_mid = compute_blocks(sol, pos_mid)

    # RFD drift for M (Lub_Solver.py:810-822)
    W = draw_normal(generator, (6 * B,), pos)
    Qp, Qm = _rfd_positions(sol, pos, W)
    d_m = (2.0 * sol.kT / sol.rf_delta) * (
        wall_mobility_mult(sol, Qp, W) - wall_mobility_mult(sol, Qm, W))

    FT_c = ft_calc(pos_mid).reshape(-1)
    if omega is not None:
        ftc = FT_c.reshape(B, 6)
        FT_c = torch.cat([ftc[:, 0:3], ftc[:, 3:6] + T_omega],
                         dim=1).reshape(-1)
    vel_c, its2 = lub_solve(sol, pos_mid, blocks_mid, X=d_m + m_half,
                            Xm=FT_c, x0=vel_p)
    v = 0.5 * (vel_p + vel_c).reshape(B, 6)

    pos_new = pos + sol.dt * v[:, 0:3]
    quat_new = quat.step(quats, v[:, 3:6], sol.dt)
    pos_out, quat_out, wall_bad, jump_bad = _accept(sol, pos, quats,
                                                    pos_new, quat_new)
    aux = LubStepAux(velocities=v, det_iterations=its1 + its2 + torque_its,
                     stoch_iterations=it_l,
                     rejections_wall=wall_bad.to(torch.int32),
                     rejections_jump=(jump_bad & ~wall_bad).to(torch.int32),
                     neighbor_overflow=torch.maximum(blocks.overflow,
                                                     blocks_mid.overflow))
    return pos_out, quat_out, aux
