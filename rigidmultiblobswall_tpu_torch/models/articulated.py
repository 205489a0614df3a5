"""Articulated rigid bodies: ball-joint constraints between bodies
(PyTorch).

Counterpart of rigidmultiblobswall_tpu/models/articulated.py:

  * constraints live in `ArticulatedType` groups: `count` identical
    articulated instances, each with `num_bodies` sub-bodies and
    `num_constraints` ball joints. Sub-body j of every instance forms one
    `BodyType` group, so everything batches over instances.
  * C-matrix products are batched products over lab-frame link vectors
    (C U = v_p + w_p x l_p - v_q - w_q x l_q, the q side dropped for a
    self-constraint p == q), over any leading batch dimensions (the
    lockstep solves' stacks). C is materialized per instance only for the
    preconditioner's constraint resistance G = pinv(C N C^T).
  * the post-step nonlinear projection is a batched damped Gauss-Newton
    over x = (dq in R^3, theta in R^4 per body) with the residual
    [A dq + R(th_p) l_p - R(th_q) l_q + (q_p - q_q); |th|^2 - 1], the
    Jacobian from torch.func.jacfwd under torch.func.vmap. Each instance
    stops at its own convergence (its update is masked from then on, as
    under the JAX package's vmapped while_loop), one host check an
    iteration.

The projection, the centre-of-mass solve and the preconditioner's pinv
run in float64 whatever the state's dtype, and their results are cast
back: in float32, with positions of O(10-100), the projection's 1e-8
tolerance is out of reach and every call would spend its 20 iterations.

Time-dependent links (the expression columns of a .const file) come as a
host hook `links_fn(t) -> (links (nc, 6), deriv (nc, 6))` on a float t
(io/input_file.compile_links_fn).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..ops import quaternion as quat
from .system import State, System

# the Gauss-Newton iterations of the last nonlinear_projection calls (the
# largest over its instances, one entry a call and articulated type), in
# call order; a caller that reports them clears it first
GN_ITERATIONS = collections.deque(maxlen=1024)


@dataclasses.dataclass(frozen=True, eq=False)
class ArticulatedType:
    """`count` identical articulated instances.

    sub_type_indices: indices into System.types of the BodyType groups
    holding sub-body 0..num_bodies-1 (each has count = this count).
    pairs_local: (nc, 2) local sub-body indices of each constraint.
    links: (nc, 6) body-frame link vectors (p side, then q side).
    links_fn: optional host hook, float t -> (links (nc, 6), deriv
    (nc, 6)) as arrays.
    """

    name: str
    count: int
    sub_type_indices: Tuple[int, ...]
    pairs_local: np.ndarray
    links: np.ndarray
    links_fn: Optional[Callable] = None

    def __post_init__(self):
        p = np.asarray(self.pairs_local, dtype=int).reshape(-1, 2)
        l = np.asarray(self.links, dtype=float).reshape(-1, 6)
        p.setflags(write=False)
        l.setflags(write=False)
        object.__setattr__(self, "pairs_local", p)
        object.__setattr__(self, "links", l)
        object.__setattr__(self, "sub_type_indices",
                           tuple(self.sub_type_indices))

    @property
    def num_bodies(self) -> int:
        return len(self.sub_type_indices)

    @property
    def num_constraints(self) -> int:
        return self.pairs_local.shape[0]


def num_constraints(system: System) -> int:
    return sum(a.count * a.num_constraints for a in system.articulated)


def constraint_offsets(system: System):
    offs = [0]
    for a in system.articulated:
        offs.append(offs[-1] + a.count * a.num_constraints)
    return tuple(offs)


def _batch(x):
    """The leading batch dimensions of x beyond a (rows, k) block."""
    return tuple(x.shape[:-2]) if x.ndim >= 3 else ()


def _instance_bodies(system: System, art: ArticulatedType, arr):
    """Per-instance sub-body values of arr (..., B, k): (..., count, nb,
    k)."""
    return torch.stack([arr[..., system.body_slice(tj), :]
                        for tj in art.sub_type_indices], dim=-2)


def _set_instance_bodies(system: System, art: ArticulatedType, arr, vals):
    """arr (B, k) with the sub-bodies' rows replaced by vals (count, nb,
    k)."""
    arr = arr.clone()
    for j, tj in enumerate(art.sub_type_indices):
        arr[system.body_slice(tj)] = vals[:, j].to(arr.dtype)
    return arr


def _index(idx, like):
    """Host indices (a read-only numpy array) as a long tensor on the
    device of `like`."""
    return torch.tensor(np.array(idx), dtype=torch.long, device=like.device)


def links_at_time(art: ArticulatedType, time, like):
    """(links, deriv) (nc, 6) at time `time` (a host float), on the device
    and in the dtype of `like`."""
    kw = dict(dtype=like.dtype, device=like.device)
    if art.links_fn is not None:
        links, deriv = art.links_fn(float(time))
        return (torch.as_tensor(np.asarray(links, np.float64),
                                **kw).reshape(-1, 6),
                torch.as_tensor(np.asarray(deriv, np.float64),
                                **kw).reshape(-1, 6))
    links = torch.tensor(np.array(art.links), **kw)
    return links, torch.zeros_like(links)


def lab_frame_links(system: System, art: ArticulatedType, state: State,
                    time=0.0):
    """The links (and their time derivatives) rotated to the lab frame:
    lp, lq, dp, dq, each (count, nc, 3)."""
    links, deriv = links_at_time(art, time, state.pos)
    q_inst = _instance_bodies(system, art, state.quat)   # (count, nb, 4)
    qp = q_inst[:, _index(art.pairs_local[:, 0], q_inst)]
    qq = q_inst[:, _index(art.pairs_local[:, 1], q_inst)]

    def rot(q, v):
        return quat.rotate(q, v.expand(*q.shape[:-1], 3))

    return (rot(qp, links[:, 0:3]), rot(qq, links[:, 3:6]),
            rot(qp, deriv[:, 0:3]), rot(qq, deriv[:, 3:6]))


def operator_links(system: System, state: State, time=0.0):
    """The (lp, lq) of every articulated type at (state, time), for the
    `links=` of C_mul / CT_mul in an operator applied every Krylov
    iteration."""
    return tuple(lab_frame_links(system, art, state, time)[:2]
                 for art in system.articulated)


def _self_mask(art, like):
    """(nc, 1) True for the self-constraints (p == q)."""
    self_c = art.pairs_local[:, 0] == art.pairs_local[:, 1]
    return torch.as_tensor(self_c, device=like.device)[:, None]


def C_mul(system: System, state: State, U, time=0.0, links=None):
    """C U: body velocities (..., B, 6) -> constraint velocities
    (..., C_total, 3): v_p + w_p x l_p - v_q - w_q x l_q; for a
    self-constraint (p == q) the q side is dropped."""
    batch = _batch(U)
    U = U.reshape(*batch, system.num_bodies, 6)
    links = operator_links(system, state, time) if links is None else links
    out = []
    for art, (lp, lq) in zip(system.articulated, links):
        U_inst = _instance_bodies(system, art, U)     # (..., count, nb, 6)
        Up = U_inst[..., _index(art.pairs_local[:, 0], U), :]
        Uq = U_inst[..., _index(art.pairs_local[:, 1], U), :]
        vp = Up[..., 0:3] + torch.linalg.cross(Up[..., 3:6],
                                               lp.expand_as(Up[..., 3:6]),
                                               dim=-1)
        vq = Uq[..., 0:3] + torch.linalg.cross(Uq[..., 3:6],
                                               lq.expand_as(Uq[..., 3:6]),
                                               dim=-1)
        val = torch.where(_self_mask(art, U), vp, vp - vq)
        out.append(val.reshape(*batch, -1, 3))
    if not out:
        return U.new_zeros((*batch, 0, 3))
    return torch.cat(out, dim=-2)


def CT_mul(system: System, state: State, phi, time=0.0, links=None):
    """C^T phi: constraint forces (..., C_total, 3) -> body force-torques
    (..., B, 6): p gets (phi, l_p x phi), q gets (-phi, -l_q x phi) (none
    for a self-constraint)."""
    batch = _batch(phi)
    phi = phi.reshape(*batch, -1, 3)
    links = operator_links(system, state, time) if links is None else links
    out = phi.new_zeros((*batch, system.num_bodies, 6))
    offs = constraint_offsets(system)
    for ia, (art, (lp, lq)) in enumerate(zip(system.articulated, links)):
        nc = art.num_constraints
        phi_a = phi[..., offs[ia]:offs[ia + 1], :].reshape(
            *batch, art.count, nc, 3)
        fp = torch.cat([phi_a, torch.linalg.cross(lp.expand_as(phi_a),
                                                  phi_a, dim=-1)], dim=-1)
        fq = -torch.cat([phi_a, torch.linalg.cross(lq.expand_as(phi_a),
                                                   phi_a, dim=-1)], dim=-1)
        fq = torch.where(_self_mask(art, phi), torch.zeros_like(fq), fq)
        contrib = phi.new_zeros((*batch, art.count, art.num_bodies, 6))
        dim = contrib.ndim - 2
        contrib.index_add_(dim, _index(art.pairs_local[:, 0], phi), fp)
        contrib.index_add_(dim, _index(art.pairs_local[:, 1], phi), fq)
        for j, tj in enumerate(art.sub_type_indices):
            out[..., system.body_slice(tj), :] += contrib[..., j, :]
    return out


def constraint_rhs(system: System, state: State, time=0.0):
    """The prescribed link velocity B = -(dl_p - dl_q) in the lab frame,
    (C_total, 3)."""
    out = [(-(dp - dq)).reshape(-1, 3) for dp, dq in (
        lab_frame_links(system, art, state, time)[2:]
        for art in system.articulated)]
    if not out:
        return state.pos.new_zeros((0, 3))
    return torch.cat(out, dim=0)


def constraint_violation(system: System, state: State, time=0.0):
    """g = q_p + R_p l_p - q_q - R_q l_q, (C_total, 3)."""
    out = []
    for art in system.articulated:
        lp, lq, _, _ = lab_frame_links(system, art, state, time)
        pos = _instance_bodies(system, art, state.pos)
        xp = pos[:, _index(art.pairs_local[:, 0], pos)]
        xq = pos[:, _index(art.pairs_local[:, 1], pos)]
        out.append((xp + lp - xq - lq).reshape(-1, 3))
    if not out:
        return state.pos.new_zeros((0, 3))
    return torch.cat(out, dim=0)


def _cross_mat(v):
    """[v]x for v (..., 3): (..., 3, 3) with [v]x w = v x w."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], dim=-1),
        torch.stack([v[..., 2], z, -v[..., 0]], dim=-1),
        torch.stack([-v[..., 1], v[..., 0], z], dim=-1),
    ], dim=-2)


def dense_C_per_instance(system: System, art: ArticulatedType, state: State,
                         time=0.0):
    """Dense C (count, 3 nc, 6 nb) of each instance, for the articulated
    preconditioner."""
    lp, lq, _, _ = lab_frame_links(system, art, state, time)
    nc, nb = art.num_constraints, art.num_bodies
    C = state.pos.new_zeros((art.count, 3 * nc, 6 * nb))
    eye = torch.eye(3, dtype=C.dtype, device=C.device)
    for k in range(nc):
        p, q = int(art.pairs_local[k, 0]), int(art.pairs_local[k, 1])
        rows = slice(3 * k, 3 * k + 3)
        C[:, rows, 6 * p:6 * p + 3] += eye
        C[:, rows, 6 * p + 3:6 * p + 6] -= _cross_mat(lp[:, k])
        if p != q:
            C[:, rows, 6 * q:6 * q + 3] -= eye
            C[:, rows, 6 * q + 3:6 * q + 6] += _cross_mat(lq[:, k])
    return C


def pinv_like_jax(a):
    """Batched pseudo-inverse with jnp.linalg.pinv's cutoff, singular
    values at or below 10 max(m, n) eps s_max dropped (torch's default is
    ten times lower): a redundant link set, e.g. a weld written as two
    ball joints, makes C N C^T exactly singular, and its rounding-level
    singular values must go. Computed in float64 with eps of a's own
    dtype (the precision its entries carry), returned in a's dtype."""
    m, n = a.shape[-2:]
    rtol = 10 * max(m, n) * torch.finfo(a.dtype).eps
    return torch.linalg.pinv(a.double(), rtol=rtol).to(a.dtype)


# ---------------------------------------------------------------------------
# Kinematic post-processing: centre-of-mass tracking and the nonlinear
# projection
# ---------------------------------------------------------------------------


def _connectivity_pinv(art: ArticulatedType):
    """The constraint connectivity A (3nc, 3nb) and its pinv (host
    numpy)."""
    nc, nb = art.num_constraints, art.num_bodies
    A = np.zeros((3 * nc, 3 * nb))
    for i in range(nc):
        p, q = art.pairs_local[i]
        A[3 * i:3 * i + 3, 3 * p:3 * p + 3] += np.eye(3)
        A[3 * i:3 * i + 3, 3 * q:3 * q + 3] += -np.eye(3)
    return A, np.linalg.pinv(A)


def correct_center_of_mass(system: System, state: State, old_state: State,
                           velocities, dt, time=0.0,
                           midpoint_fraction=1.0) -> State:
    """Re-centre each articulated instance: its centre of mass moves with
    the mean body velocity from old_state; the relative positions come
    from the connectivity solve of the lab-frame links at (state, time).
    Float64 inside, the state's dtype out."""
    pos = state.pos
    U = velocities.reshape(system.num_bodies, 6).double()
    for art in system.articulated:
        _, Ainv = _connectivity_pinv(art)
        lp, lq, _, _ = lab_frame_links(system, art, state, time)
        b = (lq - lp).double().reshape(art.count, 3 * art.num_constraints)
        q_rel = torch.einsum("ij,cj->ci", torch.as_tensor(
            Ainv, dtype=torch.float64, device=pos.device), b)
        q_rel = q_rel.reshape(art.count, art.num_bodies, 3)
        pos_old = _instance_bodies(system, art, old_state.pos).double()
        u_cm = torch.mean(_instance_bodies(system, art, U)[..., 0:3], dim=1)
        cm_new = torch.mean(pos_old, dim=1) + dt * midpoint_fraction * u_cm
        new = q_rel + (cm_new - torch.mean(q_rel, dim=1))[:, None, :]
        pos = _set_instance_bodies(system, art, pos, new)
    return State(pos=pos, quat=state.quat)


def nonlinear_projection(system: System, state: State, time=0.0, *,
                         tol=1e-8, max_iter=20) -> State:
    """Batched damped Gauss-Newton enforcing the ball-joint constraints
    exactly. Unknowns per body: dq (3) and a correction quaternion theta
    (4); residual rows: 3 per constraint and |theta|^2 - 1 per body. An
    instance iterates while its largest constraint residual exceeds tol,
    at most max_iter times; the centre-of-mass shift of dq is removed
    before it is applied. Float64 inside, the state's dtype out; the
    iterations of each call go to GN_ITERATIONS."""
    pos, qs = state.pos, state.quat
    dev, f64 = pos.device, torch.float64
    for art in system.articulated:
        nb, nc = art.num_bodies, art.num_constraints
        A = torch.as_tensor(_connectivity_pinv(art)[0], dtype=f64,
                            device=dev)
        lp, lq, _, _ = lab_frame_links(system, art, state, time)
        lp, lq = lp.double(), lq.double()
        pos_inst = _instance_bodies(system, art, pos).double()
        quat_inst = _instance_bodies(system, art, qs)
        pi = _index(art.pairs_local[:, 0], pos)
        qi = _index(art.pairs_local[:, 1], pos)

        def residual(x, pos_i, lp_i, lq_i):
            dq = x[:3 * nb].reshape(nb, 3)
            th = x[3 * nb:].reshape(nb, 4)
            Rp = quat.rotation_matrix(th[pi])
            Rq = quat.rotation_matrix(th[qi])
            g = (A @ dq.reshape(-1)).reshape(nc, 3)
            g = g + torch.einsum("kij,kj->ki", Rp, lp_i)
            g = g - torch.einsum("kij,kj->ki", Rq, lq_i)
            g = g + pos_i[pi] - pos_i[qi]
            unit = torch.sum(th * th, dim=1) - 1.0
            return torch.cat([g.reshape(-1), unit])

        res_all = torch.func.vmap(residual)
        jac_all = torch.func.vmap(torch.func.jacfwd(residual))
        x = torch.zeros((art.count, 7 * nb), dtype=f64, device=dev)
        x[:, 3 * nb::4] = 1.0
        it = torch.zeros(art.count, dtype=torch.long, device=dev)
        eye = 1e-12 * torch.eye(7 * nb, dtype=f64, device=dev)
        while True:
            r = res_all(x, pos_inst, lp, lq)
            active = ((r[:, :3 * nc].abs().amax(dim=1) > tol)
                      & (it < max_iter))
            if not bool(active.any()):
                break
            J = jac_all(x, pos_inst, lp, lq)
            JT = J.transpose(1, 2)
            dx = torch.linalg.solve(JT @ J + eye, (JT @ r[..., None]))[..., 0]
            x = torch.where(active[:, None], x - dx, x)
            it = it + active.long()
        GN_ITERATIONS.append(int(it.max()))
        dq = x[:, :3 * nb].reshape(art.count, nb, 3)
        th = quat.normalize(x[:, 3 * nb:].reshape(art.count, nb, 4))
        dq = dq - torch.mean(dq, dim=1, keepdim=True)   # CM-preserving
        pos = _set_instance_bodies(system, art, pos, pos_inst + dq)
        qs = _set_instance_bodies(system, art, qs,
                                  quat.multiply(th, quat_inst.double()))
    return State(pos=pos, quat=qs)
