"""Inextensible-fiber (Kirchhoff rod) suspensions (PyTorch).

Counterpart of rigidmultiblobswall_tpu/models/fibers.py: F fibers, each a
chain of B = L+1 blobs joined by L inextensible links of length ds,
evolved by overdamped Stokesian dynamics with semi-implicit bending and a
midpoint stochastic scheme. Per step the rigid-motion rates ``om`` (base
velocity w of a free fiber + two rotation rates a link) and the link
tensions ``theta`` solve the square system

    K om + impl M D4 (K om) - M B theta = RHS,  impl = impl_c dt k_bend / ds^3,

with K the rates -> blob velocities map (a cumulative sum along the
link axis), B the tensions -> blob forces map, D4 the biharmonic stencil
and M the blob mobility.

Two hydrodynamics modes, as in the JAX package:
- "batched" (per-fiber hydrodynamics only): M is the per-fiber dense
  (F, 3B, 3B) mobility (`ops/mobility.dense_mobility` batched over
  fibers), the system matrix is factored by batched LU and solved once,
  the noise M^{1/2} W is an exact batched Cholesky;
- "full" (all pairs): every product is `ops/mobility.pairwise_matvec`
  over all F B blobs with r_tgt None, the square product, which on the
  card is kernel K1 tt on its symmetric sweep; the system is solved by
  GMRES right-preconditioned with the batched LU of the per-fiber
  matrices, and the noise is the Lanczos square root.

Every entry point works on the device of its tensors; the ones that make
tensors (`straight_fiber_state`, `from_reference`, `d4_matrix`,
`d2t_matrix`) run on the card unless the caller names another device.
Randomness comes from an explicit torch.Generator, drawn in the order the
JAX package splits its key (k1, k2, k3); `FiberDraws` feeds a step its
draws instead (the JAX package's own, in tests).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops import mobility as mob
from ..ops.gmres import gmres
from ..ops.lanczos import stochastic_forcing_lanczos
from .system import resolve_device


@dataclasses.dataclass(frozen=True)
class FiberSuspension:
    """Static description of F identical-length fibers with L links.

    k_bend: bending stiffness (kappa); persistence length = k_bend / kT.
    impl_c: implicitness of the bending solve, 0.5 Crank-Nicolson, 1.0
    backward Euler. clamp: fibers anchored at their first blob with ghost
    tangent t_fix. hydrodynamics: "batched" (per-fiber mobility only) or
    "full" (all pairs). force_fn: a torch hook (sus, positions (F, B, 3))
    -> blob forces (F, B, 3)."""

    num_fibers: int
    num_links: int
    ds: float
    a: float
    k_bend: float
    eta: float = 1.0
    kT: float = 0.0
    impl_c: float = 0.5
    clamp: bool = False
    t_fix: Tuple[float, float, float] = (0.0, 0.0, 1.0)
    hydrodynamics: str = "batched"
    domain: str = "no_wall"
    solver_tolerance: float = 1e-4
    gmres_restart: int = 100
    gmres_maxiter: int = 300
    rf_delta_factor: float = 0.05  # delta = factor * ds^{3/2}
    force_fn: Optional[Callable] = None

    def __post_init__(self):
        if self.num_links < 3:
            raise ValueError("fibers need at least 3 links (the bending "
                             "stencil boundary rows assume it; same as "
                             "the reference)")
        if self.hydrodynamics not in ("batched", "full"):
            raise ValueError(f"hydrodynamics={self.hydrodynamics!r}")
        if self.domain not in ("no_wall", "single_wall"):
            raise ValueError(f"domain={self.domain!r}")

    @property
    def num_blobs_per_fiber(self) -> int:
        return self.num_links + 1

    @property
    def num_blobs(self) -> int:
        return self.num_fibers * self.num_blobs_per_fiber

    @property
    def n_om(self) -> int:
        # free: base velocity (3) + 2 rates a link; clamp: rates only
        return 2 * self.num_links + (0 if self.clamp else 3)

    @property
    def n_theta(self) -> int:
        # clamp adds a 3-vector reaction force at the anchored blob
        return self.num_links + (3 if self.clamp else 0)

    @property
    def m0(self) -> float:
        return 1.0 / (6.0 * math.pi * self.eta * self.a)


class FiberState(NamedTuple):
    x0: torch.Tensor  # (F, 3) first-blob positions
    t: torch.Tensor   # (F, L, 3) unit link tangents
    u: torch.Tensor   # (F, L, 3) bishop-frame normal
    v: torch.Tensor   # (F, L, 3) bishop-frame binormal (= t x u)


class FiberAux(NamedTuple):
    tensions: torch.Tensor
    rates: torch.Tensor
    iterations: object       # GMRES iterations (1 for the batched solve)
    residual: object
    converged: object
    lanczos_iterations: object = 0  # both noise chains' (full mode)


class FiberDraws(NamedTuple):
    """The normals of one stochastic step: w1 (F, 3B) for M^{1/2} W1, w2
    (F, 3B) under Crank-Nicolson or (F, B-2, 3) under backward Euler, and
    w_rfd (F, B, 3) for the random finite difference."""
    w1: torch.Tensor
    w2: torch.Tensor
    w_rfd: torch.Tensor


def from_reference(ref_sus, ref_state=None, *, dtype=torch.float64,
                   device=None):
    """Carry a JAX-package `FiberSuspension` (and optionally its
    `FiberState`, read as numpy arrays) across to the port's on `device`
    (default the card) and `dtype`. A suspension with a force_fn is
    refused: its hook is a JAX-traced closure the port cannot run (give
    the port's FiberSuspension a torch hook of its own). Returns the
    suspension, or (suspension, FiberState) when a state is given."""
    if getattr(ref_sus, "force_fn", None) is not None:
        raise NotImplementedError(
            "fiber hook force_fn: the JAX suspension's hook is a JAX-traced "
            "closure the port cannot run; give the port's FiberSuspension "
            "its own torch hook (force_fn=...)")
    fields = {f.name: getattr(ref_sus, f.name)
              for f in dataclasses.fields(FiberSuspension)
              if f.name != "force_fn"}
    fields["t_fix"] = tuple(float(x) for x in fields["t_fix"])
    sus = FiberSuspension(**fields)
    if ref_state is None:
        return sus
    dev = resolve_device(device)
    state = FiberState(*(torch.as_tensor(np.array(x), dtype=dtype,
                                         device=dev) for x in ref_state))
    return sus, state


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _dot(a, b):
    return torch.sum(a * b, dim=-1, keepdim=True)


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------


def bishop_frame(t, u0=None):
    """Parallel-transport (bishop) frame along each fiber: u_0 given (or
    the unit vector normal to t_0 from whichever of x, y is less parallel
    to it), then u_{k+1} = R(t_k -> t_{k+1}) u_k; v = t x u.

    t: (F, L, 3) unit tangents. Returns (u, v) with the same shape. A
    loop over the links: it runs when a state is built, never in a
    step."""
    if u0 is None:
        t0 = t[:, 0, :]
        seed = t.new_tensor([1.0, 0.0, 0.0]).expand_as(t0)
        alt = t.new_tensor([0.0, 1.0, 0.0]).expand_as(t0)
        par = torch.abs(_dot(seed, t0))
        seed = torch.where(par > 0.9, alt, seed)
        u0 = seed - _dot(seed, t0) * t0
        u0 = u0 / torch.linalg.norm(u0, dim=-1, keepdim=True)
    us = [u0]
    for k in range(t.shape[1] - 1):
        t_k, t_kp, u_k = t[:, k], t[:, k + 1], us[-1]
        cos_th = _dot(t_k, t_kp)
        rot = _cross(t_k, t_kp)
        us.append(u_k + _cross(rot, u_k)
                  + _cross(rot, _cross(rot, u_k)) / (1.0 + cos_th))
    u = torch.stack(us, dim=1)
    return u, _cross(t, u)


def blob_positions(sus: FiberSuspension, state: FiberState):
    """(F, B, 3): x0 + ds cumsum(t)."""
    steps = sus.ds * torch.cumsum(state.t, dim=1)
    x0 = state.x0[:, None, :]
    return torch.cat([x0, x0 + steps], dim=1)


def end_to_end_distance(sus: FiberSuspension, state: FiberState):
    """(F,) |x_B - x_0| = ds |sum_j t_j|."""
    return sus.ds * torch.linalg.norm(state.t.sum(dim=1), dim=-1)


def straight_fiber_state(sus: FiberSuspension, x0, direction, *,
                         dtype=torch.float64, device=None):
    """All fibers straight along `direction`, first blobs at x0 ((3,) or
    (F, 3)), on `device` (default the card)."""
    dev = resolve_device(device)
    d = np.asarray(direction, dtype=np.float64)
    d = d / np.linalg.norm(d)
    t = torch.as_tensor(d, dtype=dtype, device=dev).expand(
        sus.num_fibers, sus.num_links, 3).contiguous()
    u, v = bishop_frame(t)
    x0 = torch.as_tensor(np.asarray(x0, dtype=np.float64), dtype=dtype,
                         device=dev).reshape(-1, 3).expand(
                             sus.num_fibers, 3).contiguous()
    return FiberState(x0=x0, t=t, u=u, v=v)


# ---------------------------------------------------------------------------
# Elasticity: bending energy, force, and the D4 stencil
# ---------------------------------------------------------------------------


def bending_energy(sus: FiberSuspension, t):
    """E = (k_bend / 2 ds) sum_j |t_j - t_{j-1}|^2 over every fiber, with
    the ghost joint (t_fix, t_0) of clamped fibers."""
    diff = t[:, 1:] - t[:, :-1]
    e = torch.sum(diff * diff)
    if sus.clamp:
        ghost = t[:, 0] - t.new_tensor(sus.t_fix)
        e = e + torch.sum(ghost * ghost)
    return 0.5 * sus.k_bend / sus.ds * e


def bending_force(sus: FiberSuspension, t):
    """F = -dE/dX as a tangent stencil, (F, B, 3): the JAX package's rows,
    boundary and clamp rows included."""
    F, L, _ = t.shape
    f_c = sus.k_bend / sus.ds ** 2
    z = t.new_zeros((F, 1, 3))
    tm2 = torch.cat([z, z, t[:, :-1]], dim=1)   # t_{j-2}
    tm1 = torch.cat([z, t], dim=1)              # t_{j-1}
    tp0 = torch.cat([t, z], dim=1)              # t_j
    tp1 = torch.cat([t[:, 1:], z, z], dim=1)    # t_{j+1}
    g = f_c * (tp1 - 3.0 * tp0 + 3.0 * tm1 - tm2)
    # boundary rows (blobs 0, 1, L-1, L); L >= 3 enforced at build
    g[:, 0] = f_c * (t[:, 1] - t[:, 0])
    g[:, 1] = f_c * (t[:, 2] - 3.0 * t[:, 1] + 2.0 * t[:, 0])
    g[:, L - 1] = -f_c * (t[:, L - 3] - 3.0 * t[:, L - 2]
                          + 2.0 * t[:, L - 1])
    g[:, L] = f_c * (t[:, L - 1] - t[:, L - 2])
    if sus.clamp:
        t_fix = t.new_tensor(sus.t_fix)
        g[:, 0] = 0.0
        g[:, 1] = f_c * (t[:, 2] - 3.0 * t[:, 1] + 3.0 * t[:, 0] - t_fix)
    return -g


def _d2(n_blobs):
    """(B-2, B) second difference."""
    d2 = np.zeros((n_blobs - 2, n_blobs))
    for i in range(n_blobs - 2):
        d2[i, i], d2[i, i + 1], d2[i, i + 2] = 1.0, -2.0, 1.0
    return d2


@functools.lru_cache(maxsize=64)
def _d4(n_blobs, clamp, dtype, device):
    s = _d2(n_blobs).T @ _d2(n_blobs)
    if clamp:
        # the clamp energy |x_1 - x_0 - ds t_fix|^2 adds (e1 - e0)(e1 -
        # e0)^T; row 0 (the anchored blob) is zeroed
        s[1, 0] -= 1.0
        s[1, 1] += 1.0
        s[0, :] = 0.0
    return torch.as_tensor(s, dtype=dtype, device=device)


@functools.lru_cache(maxsize=64)
def _d2t(n_blobs, dtype, device):
    return torch.as_tensor(_d2(n_blobs).T.copy(), dtype=dtype, device=device)


def d4_matrix(sus: FiberSuspension, dtype=torch.float64, device=None):
    """(B, B) biharmonic stencil S with free/clamped boundary rows,
    without the `impl` prefactor; it acts componentwise, D4 X = S X.
    Cached per device and dtype (a step makes no host copy)."""
    return _d4(sus.num_blobs_per_fiber, sus.clamp, dtype,
               resolve_device(device))


def d2t_matrix(sus: FiberSuspension, dtype=torch.float64, device=None):
    """(B, B-2) transposed second difference of the backward-Euler noise
    D2^T W."""
    return _d2t(sus.num_blobs_per_fiber, dtype, resolve_device(device))


def _apply_stencil(s, x):
    """S X componentwise: s (B, B), x (..., B, 3)."""
    return torch.einsum("bc,...cd->...bd", s, x)


# ---------------------------------------------------------------------------
# Kinematic operators K, Kinv, B. Each takes leading batch dimensions
# before the fiber axis (k_dense and b_dense apply them to a basis).
# ---------------------------------------------------------------------------


def split_om(sus: FiberSuspension, om):
    """om (..., F, n_om) -> (w (..., F, 3) or None, rates (..., F, L, 2))."""
    lead = om.shape[:-1]
    if sus.clamp:
        return None, om.reshape(*lead, sus.num_links, 2)
    return om[..., :3], om[..., 3:].reshape(*lead, sus.num_links, 2)


def merge_om(sus: FiberSuspension, w, rates):
    flat = rates.reshape(*rates.shape[:-2], 2 * sus.num_links)
    if sus.clamp:
        return flat
    return torch.cat([w, flat], dim=-1)


def apply_K(sus: FiberSuspension, om, u, v):
    """Blob velocities from rates: vel_0 = w (0 if clamped), vel_{j+1} =
    vel_j + ds (om_v_j u_j - om_u_j v_j). om (..., F, n_om) -> (..., F, B,
    3)."""
    w, rates = split_om(sus, om)
    txom = rates[..., 1:2] * u - rates[..., 0:1] * v   # Omega_j x t_j
    steps = sus.ds * torch.cumsum(txom, dim=-2)
    if w is None:
        w = om.new_zeros((*om.shape[:-1], 3))
    w = w[..., None, :]
    return torch.cat([w, w + steps], dim=-2)


def apply_Kinv(sus: FiberSuspension, vel, u, v):
    """Pseudo-inverse of K: Dp_j = (vel_{j+1} - vel_j)/ds; om_u = -v . Dp,
    om_v = u . Dp; base velocity vel_0 (free fibers). vel (..., F, B, 3)
    -> om (..., F, n_om)."""
    dp = (vel[..., 1:, :] - vel[..., :-1, :]) / sus.ds
    om_u = -torch.sum(v * dp, dim=-1)
    om_v = torch.sum(u * dp, dim=-1)
    return merge_om(sus, vel[..., 0, :], torch.stack([om_u, om_v], dim=-1))


def split_theta(sus: FiberSuspension, theta):
    """theta (..., F, n_theta) -> (reaction (..., F, 3) or None, tensions
    (..., F, L))."""
    if sus.clamp:
        return theta[..., :3], theta[..., 3:]
    return None, theta


def apply_B(sus: FiberSuspension, theta, t):
    """Blob forces from link tensions: f_j = theta_{j-1} t_{j-1} -
    theta_j t_j (one-sided at the ends); a clamped fiber's blob 0 takes
    the free reaction force. theta (..., F, n_theta) -> (..., F, B, 3)."""
    reaction, tens = split_theta(sus, theta)
    tt = tens[..., None] * t
    z = tt.new_zeros((*tt.shape[:-2], 1, 3))
    f = torch.cat([z, tt], dim=-2) - torch.cat([tt, z], dim=-2)
    if sus.clamp:
        f = torch.cat([reaction[..., None, :], f[..., 1:, :]], dim=-2)
    return f


def apply_BT(sus: FiberSuspension, vel, t):
    """(B^T vel)_j = t_j . (vel_{j+1} - vel_j); a clamped fiber's reaction
    rows prepend vel_0 and its theta_0 row loses the vel_0 term. vel
    (..., F, B, 3) -> (..., F, n_theta)."""
    bt = torch.sum(t * (vel[..., 1:, :] - vel[..., :-1, :]), dim=-1)
    if sus.clamp:
        first = bt[..., :1] + torch.sum(t[..., 0, :] * vel[..., 0, :],
                                        dim=-1)[..., None]
        return torch.cat([vel[..., 0, :], first, bt[..., 1:]], dim=-1)
    return bt


def k_dense(sus: FiberSuspension, u, v):
    """(F, 3B, n_om) dense K: apply_K once on the identity basis as a
    leading batch dimension."""
    F = sus.num_fibers
    eye = torch.eye(sus.n_om, dtype=u.dtype, device=u.device)
    cols = apply_K(sus, eye[:, None, :].expand(sus.n_om, F, sus.n_om), u, v)
    return cols.reshape(sus.n_om, F, -1).permute(1, 2, 0)


def b_dense(sus: FiberSuspension, t):
    """(F, 3B, n_theta) dense B, apply_B once on the identity basis."""
    F = sus.num_fibers
    eye = torch.eye(sus.n_theta, dtype=t.dtype, device=t.device)
    cols = apply_B(sus, eye[:, None, :].expand(sus.n_theta, F, sus.n_theta),
                   t)
    return cols.reshape(sus.n_theta, F, -1).permute(1, 2, 0)


# ---------------------------------------------------------------------------
# Mobility
# ---------------------------------------------------------------------------


def mobility_dense_batched(sus: FiberSuspension, pos):
    """Per-fiber dense blob mobility (F, 3B, 3B): RPY, or wall-corrected
    Swan-Brady with the overlap regularization for 'single_wall' (the
    preconditioner's mobility, and all of 'batched' mode's)."""
    return mob.dense_mobility(pos, sus.eta, sus.a, domain=sus.domain,
                              coupling="tt")


def _bmv(m, x):
    """Batched matrix-vector product (F, n, n) x (F, n) -> (F, n)."""
    return torch.matmul(m, x[..., None])[..., 0]


def mobility_matvec(sus: FiberSuspension, pos, f, *, m_batched=None):
    """M f over all blobs; f and the result (F, B, 3). Full mode: the
    square product over all F B blobs (kernel K1 tt, symmetric sweep)."""
    if sus.hydrodynamics == "batched":
        if m_batched is None:
            m_batched = mobility_dense_batched(sus, pos)
        return _bmv(m_batched, f.reshape(sus.num_fibers, -1)).reshape(
            f.shape)
    out = mob.pairwise_matvec(pos.reshape(-1, 3), None, f.reshape(-1, 3),
                              sus.eta, sus.a, coupling="tt",
                              domain=sus.domain)
    return out.reshape(f.shape)


def draw_w1(sus: FiberSuspension, generator, dtype, device):
    """W ~ N(0, I) of shape (F, 3B), the noise of sqrt_mobility_noise."""
    return torch.randn((sus.num_fibers, 3 * sus.num_blobs_per_fiber),
                       generator=generator, dtype=dtype, device=device)


def sqrt_mobility_noise(sus: FiberSuspension, pos, generator=None, *,
                        w=None, m_batched=None, lanczos_max_iter=64):
    """M^{1/2} W with W ~ N(0, I) (w (F, 3B), or drawn from `generator`):
    exact batched Cholesky in 'batched' mode (a failed factorization
    raises), Lanczos in 'full' mode. Returns ((F, B, 3), iterations)."""
    if w is None:
        w = draw_w1(sus, generator, pos.dtype, pos.device)
    if sus.hydrodynamics == "batched":
        if m_batched is None:
            m_batched = mobility_dense_batched(sus, pos)
        chol, info = torch.linalg.cholesky_ex(m_batched)
        if bool((info != 0).any()):
            bad = torch.nonzero(info).flatten().tolist()
            raise RuntimeError(f"fiber mobility not positive definite: the "
                               f"Cholesky factorization failed for fibers "
                               f"{bad[:8]}{' ...' if len(bad) > 8 else ''}")
        return _bmv(chol, w).reshape(sus.num_fibers, -1, 3), 0

    flat = pos.reshape(-1, 3)

    def matvec(x):
        return mob.pairwise_matvec(flat, None, x.reshape(-1, 3), sus.eta,
                                   sus.a, coupling="tt",
                                   domain=sus.domain).reshape(-1)

    res = stochastic_forcing_lanczos(
        matvec, w.reshape(-1), tolerance=sus.solver_tolerance,
        max_iter=lanczos_max_iter)
    return res.noise.reshape(sus.num_fibers, -1, 3), res.iterations


# ---------------------------------------------------------------------------
# Frame rotation (the state update)
# ---------------------------------------------------------------------------


def frame_rot(sus: FiberSuspension, state: FiberState, om, delta):
    """Rotate every link frame by delta Omega_j (Omega_j = om_u u_j + om_v
    v_j) by Rodrigues' formula, translate x0 by delta w, and
    re-orthonormalize (t normalized, u projected and normalized, v = t x
    u)."""
    w, rates = split_om(sus, om)
    omega = rates[..., 0:1] * state.u + rates[..., 1:2] * state.v
    mag = torch.linalg.norm(omega, dim=-1, keepdim=True)
    axis = omega / torch.clamp(mag, min=1e-30)
    theta = delta * mag
    c, s = torch.cos(theta), torch.sin(theta)

    def rot(x):
        return c * x + s * _cross(axis, x) + (1.0 - c) * _dot(axis, x) * axis

    t = rot(state.t)
    u = rot(state.u)
    t = t / torch.linalg.norm(t, dim=-1, keepdim=True)
    u = u - _dot(u, t) * t
    u = u / torch.linalg.norm(u, dim=-1, keepdim=True)
    x0 = state.x0 if w is None else state.x0 + delta * w
    return FiberState(x0=x0, t=t, u=u, v=_cross(t, u))


# ---------------------------------------------------------------------------
# The linear system and its preconditioner
# ---------------------------------------------------------------------------


def system_matrix_batched(sus: FiberSuspension, impl, state: FiberState,
                          *, m_batched=None):
    """(F, 3B, 3B) per-fiber matrix [K + impl M_f D4 K | -M_f B] in (om,
    theta) column order: the whole operator in 'batched' mode, the
    block-diagonal preconditioner in 'full' mode."""
    if m_batched is None:
        m_batched = mobility_dense_batched(sus, blob_positions(sus, state))
    kd = k_dense(sus, state.u, state.v)         # (F, 3B, n_om)
    bd = b_dense(sus, state.t)                  # (F, 3B, n_theta)
    s = d4_matrix(sus, dtype=kd.dtype, device=kd.device)
    F, B = sus.num_fibers, sus.num_blobs_per_fiber
    kd3 = kd.reshape(F, B, 3, sus.n_om)
    d4k = torch.einsum("bc,fcdn->fbdn", s, kd3).reshape(kd.shape)
    left = kd + impl * torch.matmul(m_batched, d4k)
    right = -torch.matmul(m_batched, bd)
    return torch.cat([left, right], dim=2)


def apply_system(sus: FiberSuspension, impl, state: FiberState, x, *,
                 m_batched=None):
    """The operator on x = (om | theta) flattened (F 3B,) -> the
    velocity-space residual vector (F 3B,)."""
    x = x.reshape(sus.num_fibers, -1)
    om, theta = x[:, :sus.n_om], x[:, sus.n_om:]
    kom = apply_K(sus, om, state.u, state.v)     # (F, B, 3)
    s = d4_matrix(sus, dtype=x.dtype, device=x.device)
    btheta = apply_B(sus, theta, state.t)
    pos = blob_positions(sus, state)
    mf = mobility_matvec(sus, pos, impl * _apply_stencil(s, kom) - btheta,
                         m_batched=m_batched)
    return (kom + mf).reshape(-1)


def factor_pc(sus: FiberSuspension, impl, state: FiberState, *,
              m_batched=None):
    """Batched LU of the per-fiber system matrices; returns pc(x), the
    per-fiber solve of a flat vector, for right-preconditioned GMRES."""
    mat = system_matrix_batched(sus, impl, state, m_batched=m_batched)
    lu, piv = torch.linalg.lu_factor(mat)

    def pc(x):
        xs = x.reshape(sus.num_fibers, -1, 1)
        return torch.linalg.lu_solve(lu, piv, xs).reshape(-1)

    return pc


def solve_fiber_system(sus: FiberSuspension, impl, state: FiberState, rhs,
                       *, m_batched=None, x0=None):
    """Solve [K + impl M D4 K, -M B] (om, theta) = rhs, rhs (F, B, 3).

    'batched': one exact solve by the factored matrices and a residual
    check by one operator application (converged below 10 tol; the
    residual and the flag stay on the device). 'full': GMRES with the
    batched LU as right preconditioner. Returns (om (F, n_om), theta (F,
    n_theta), (iterations, residual, converged))."""
    pc = factor_pc(sus, impl, state, m_batched=m_batched)
    b = rhs.reshape(-1)
    if sus.hydrodynamics == "batched":
        x = pc(b)
        its = 1
        r = apply_system(sus, impl, state, x, m_batched=m_batched) - b
        resid = torch.linalg.norm(r) / torch.clamp(torch.linalg.norm(b),
                                                   min=1e-300)
        converged = resid < 10 * sus.solver_tolerance
    else:
        def matvec(y):
            return apply_system(sus, impl, state, y, m_batched=m_batched)

        res = gmres(matvec, b, x0=x0, tol=sus.solver_tolerance,
                    restart=sus.gmres_restart, maxiter=sus.gmres_maxiter,
                    M=pc)
        x, its, resid, converged = (res.x, res.iterations,
                                    res.residual_norm, res.converged)
    xs = x.reshape(sus.num_fibers, -1)
    return xs[:, :sus.n_om], xs[:, sus.n_om:], (its, resid, converged)


# ---------------------------------------------------------------------------
# Random finite difference (thermal drift)
# ---------------------------------------------------------------------------


def draw_w_rfd(sus: FiberSuspension, generator, dtype, device):
    """W ~ N(0, I) of shape (F, B, 3), the noise of m_rfd."""
    return torch.randn((sus.num_fibers, sus.num_blobs_per_fiber, 3),
                       generator=generator, dtype=dtype, device=device)


def m_rfd(sus: FiberSuspension, state: FiberState, generator=None, *,
          w=None):
    """kT-free RFD vector (1/delta)(M(q+) - M(q-)) W, q+- the state rotated
    by +-delta/2 Kinv(W), W (F, B, 3) given or drawn from `generator`;
    multiply by kT at the use site."""
    if w is None:
        w = draw_w_rfd(sus, generator, state.x0.dtype, state.x0.device)
    delta = sus.rf_delta_factor * sus.ds ** 1.5
    om_w = apply_Kinv(sus, w, state.u, state.v)
    sp = frame_rot(sus, state, om_w, 0.5 * delta)
    sm = frame_rot(sus, state, om_w, -0.5 * delta)
    mp = mobility_matvec(sus, blob_positions(sus, sp), w)
    mm = mobility_matvec(sus, blob_positions(sus, sm), w)
    return (mp - mm) / delta


# ---------------------------------------------------------------------------
# Time stepping
# ---------------------------------------------------------------------------


def _is_cn(sus: FiberSuspension):
    return abs(sus.impl_c - 1.0) > 1e-5


def draw(sus: FiberSuspension, generator, dtype, device) -> FiberDraws:
    """One stochastic step's normals from `generator`, in the order the
    JAX package splits its key: w1 (k1), w2 (k2), w_rfd (k3)."""
    w1 = draw_w1(sus, generator, dtype, device)
    w2 = (draw_w1(sus, generator, dtype, device) if _is_cn(sus)
          else torch.randn((sus.num_fibers, sus.num_blobs_per_fiber - 2, 3),
                           generator=generator, dtype=dtype, device=device))
    return FiberDraws(w1, w2, draw_w_rfd(sus, generator, dtype, device))


def make_stepper(sus: FiberSuspension, dt: float, *,
                 lanczos_max_iter: int = 64):
    """step(state, generator=None, draws=None) -> (state, FiberAux).

    Deterministic (kT = 0) semi-implicit step, or the stochastic midpoint
    scheme: a predictor half step rotated by the Brownian velocity, the
    solve at the midpoint configuration, and the full-dt rotation from
    the original state. impl_c selects Crank-Nicolson (0.5) or
    backward-Euler (1.0) noise; `draws` (FiberDraws) replaces the
    generator's."""
    impl = sus.impl_c * dt * sus.k_bend / sus.ds ** 3
    cn = _is_cn(sus)
    batched = sus.hydrodynamics == "batched"

    def step(state: FiberState, generator=None, draws=None):
        pos = blob_positions(sus, state)
        m_b = mobility_dense_batched(sus, pos) if batched else None
        f = bending_force(sus, state.t)
        if sus.force_fn is not None:
            f = f + sus.force_fn(sus, pos)
        rhs = mobility_matvec(sus, pos, f, m_batched=m_b)
        state_h = state
        lanczos = 0

        if sus.kT > 0.0:
            if not cn and sus.clamp:
                raise NotImplementedError(
                    "backward-Euler noise for clamped fibers (matches the "
                    "reference, c_fibers_obj.cpp:1341)")
            if draws is None:
                draws = draw(sus, generator, pos.dtype, pos.device)
            mhw1, its1 = sqrt_mobility_noise(
                sus, pos, w=draws.w1, m_batched=m_b,
                lanczos_max_iter=lanczos_max_iter)
            rfd = sus.kT * m_rfd(sus, state, w=draws.w_rfd)
            lanczos += its1
            if cn:
                c1 = 2.0 * math.sqrt(sus.kT / dt)
                bi_half = c1 * mhw1
                mhw2, its2 = sqrt_mobility_noise(
                    sus, pos, w=draws.w2, m_batched=m_b,
                    lanczos_max_iter=lanczos_max_iter)
                lanczos += its2
                bi = math.sqrt(sus.kT / dt) * (mhw1 - mhw2)
            else:
                c1 = math.sqrt(2.0 * sus.kT / dt)
                bi_half = c1 * mhw1
                d2t = d2t_matrix(sus, dtype=pos.dtype, device=pos.device)
                md2w = mobility_matvec(sus, pos,
                                       _apply_stencil(d2t, draws.w2),
                                       m_batched=m_b)
                bi = c1 * (mhw1 + math.sqrt(0.5 * impl) * md2w)
            rhs = rhs + rfd + bi
            om_half = apply_Kinv(sus, bi_half, state.u, state.v)
            state_h = frame_rot(sus, state, om_half, 0.5 * dt)

        # solve at the (midpoint) configuration
        m_b_h = (mobility_dense_batched(sus, blob_positions(sus, state_h))
                 if batched else None)
        om, theta, (its, resid, conv) = solve_fiber_system(
            sus, impl, state_h, rhs, m_batched=m_b_h)
        new_state = frame_rot(sus, state, om, dt)
        return new_state, FiberAux(tensions=theta, rates=om, iterations=its,
                                   residual=resid, converged=conv,
                                   lanczos_iterations=lanczos)

    return step


def _stack(values, device):
    return torch.stack([torch.as_tensor(v, device=device) for v in values])


def simulate(sus: FiberSuspension, state: FiberState, generator=None, *,
             dt, n_steps, save_every=1, draws=None, **kw):
    """The time loop: n_steps // save_every * save_every steps. Returns
    (final state, the saved states stacked (n_saves, F, ...), the
    FiberAux of each save's last step stacked). `draws` (an iterable of
    FiberDraws, one a step) replaces the generator's."""
    step = make_stepper(sus, dt, **kw)
    draws = iter(draws) if draws is not None else None
    saved, auxs = [], []
    for i in range(n_steps // save_every * save_every):
        state, aux = step(state, generator,
                          None if draws is None else next(draws))
        if (i + 1) % save_every == 0:
            saved.append(state)
            auxs.append(aux)
    dev = state.x0.device
    if not saved:
        raise ValueError(f"n_steps {n_steps} < save_every {save_every}: "
                         "nothing to save")
    traj = FiberState(*(torch.stack(parts) for parts in zip(*saved)))
    aux = FiberAux(*(_stack(parts, dev) for parts in zip(*auxs)))
    return state, traj, aux


# ---------------------------------------------------------------------------
# Stresslet measurement (rheology)
# ---------------------------------------------------------------------------


def fiber_stresslet(sus: FiberSuspension, pos, lam):
    """Per-fiber first moment S = sum_k (r_k - COM) lam_k^T, (F, 3, 3)."""
    com = pos.mean(dim=1, keepdim=True)
    return torch.einsum("fkd,fke->fde", pos - com,
                        lam.reshape(sus.num_fibers, -1, 3))


def _lstsq_min_norm(a, b):
    """The SVD minimum-norm least-squares solution of a x = b for each
    batch entry ((..., n, n), (..., n)), keeping the singular values s > 0
    with s >= eps max(n) s_max, jnp.linalg.lstsq's default rcond.
    torch.linalg.lstsq on CUDA has only the full-rank 'gels' driver, so
    the solve goes through the SVD on every device."""
    u, s, vh = torch.linalg.svd(a)
    rcond = torch.finfo(a.dtype).eps * max(a.shape[-2:])
    keep = (s > 0) & (s >= rcond * s[..., :1])
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, 1.0), 0.0)
    utb = torch.matmul(u.transpose(-1, -2), b[..., None])[..., 0]
    return torch.matmul(vh.transpose(-1, -2), (s_inv * utb)[..., None])[..., 0]


def constraint_forces(sus: FiberSuspension, state: FiberState, f):
    """Rigid-link constraint forces lambda for applied blob forces f:
    lambda = M^-1 K N (K^T f) - f with N = (K^T M^-1 K)^+ (minimum-norm
    least squares), per-fiber dense algebra. Returns (F, B, 3)."""
    pos = blob_positions(sus, state)
    m_b = mobility_dense_batched(sus, pos)
    kd = k_dense(sus, state.u, state.v)
    ff = f.reshape(sus.num_fibers, -1)
    minv_k = torch.linalg.solve(m_b, kd)
    kt = kd.transpose(-1, -2)
    n_inv = torch.matmul(kt, minv_k)
    y = _lstsq_min_norm(n_inv, _bmv(kt, ff))
    lam = _bmv(minv_k, y) - ff
    return lam.reshape(sus.num_fibers, -1, 3)


def stresslet_deterministic(sus: FiberSuspension, state: FiberState):
    """Stresslet of the bending-force-loaded suspension: S(lambda(F_bend))."""
    f = bending_force(sus, state.t)
    lam = constraint_forces(sus, state, f)
    return fiber_stresslet(sus, blob_positions(sus, state), lam)
