"""Phoretic (chemically active) bodies: the Laplace boundary-integral solve
coupled to slip (PyTorch).

Counterpart of rigidmultiblobswall_tpu/models/phoretic.py: solve

    (I/2 - D + S k/Dc) c = c_background + S (emitting_rate / Dc)

by GMRES (ops/gmres.gmres, restart 200, maxiter 1000, the system's
solver tolerance), compute the surface concentration gradient and turn it
into the phoretic slip u_slip = M_s (I - n n^T) grad c. On the card the
operator and the gradient are one sweep of kernel L1 each
(ops/laplace.bvp_operator, surface_gradient).

Per-blob chemistry (body-frame normals, reaction and emission rates,
surface mobility, quadrature weights) comes from .Laplace files, one
`Chemistry` per body type (None for an inert type), gathered in
`PhoreticConfig`. `make_slip_fn` is the System's slip hook
(`System.slip_fn`); `config_from_reference` carries a JAX-package
PhoreticConfig across.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..ops import laplace
from ..ops import quaternion as quat
from ..ops.gmres import gmres
from . import kinematics as kin
from .system import State, System


@dataclasses.dataclass(frozen=True)
class Chemistry:
    """Per-blob chemical data of one body type (.Laplace file columns:
    normal (3), reaction_rate, emitting_rate, surface_mobility, weight)."""

    normals_ref: np.ndarray       # (nb, 3) body frame
    reaction_rate: np.ndarray     # (nb,)
    emitting_rate: np.ndarray     # (nb,)
    surface_mobility: np.ndarray  # (nb,)
    weights: np.ndarray           # (nb,)

    @classmethod
    def from_laplace_file(cls, path):
        data = np.loadtxt(path)
        return cls(normals_ref=data[:, 0:3], reaction_rate=data[:, 3],
                   emitting_rate=data[:, 4], surface_mobility=data[:, 5],
                   weights=data[:, 6])


class PhoreticConfig(NamedTuple):
    chemistry: tuple              # one Chemistry (or None) per body type
    background: np.ndarray        # 9 coefficients: constant, gradient (3),
    #                               upper-triangular Hessian (5)
    diffusion_coefficient: float = 1.0


def config_from_reference(ref_cfg) -> PhoreticConfig:
    """The port's PhoreticConfig of a JAX-package PhoreticConfig (its
    Chemistry arrays, background and Dc, read as numpy)."""
    chem = tuple(None if c is None else Chemistry(
        **{f.name: np.array(getattr(c, f.name), dtype=np.float64)
           for f in dataclasses.fields(Chemistry)})
        for c in ref_cfg.chemistry)
    return PhoreticConfig(
        chemistry=chem,
        background=np.array(ref_cfg.background, dtype=np.float64),
        diffusion_coefficient=float(ref_cfg.diffusion_coefficient))


def _gather(system: System, chem_tuple, attr, dtype, device=None):
    """A per-blob column of every type's chemistry, tiled over its bodies
    (zero for a type without one), (N,)."""
    out = []
    for t, chem in zip(system.types, chem_tuple):
        if chem is None:
            out.append(np.zeros(t.count * t.num_blobs))
        else:
            out.append(np.tile(getattr(chem, attr), t.count))
    return torch.as_tensor(np.concatenate(out), dtype=dtype, device=device)


def lab_normals(system: System, state: State, chem_tuple, normals_ref=None):
    """Body-frame normals rotated to the lab frame, (N, 3); normals_ref
    (one tensor or None per type) skips the host copies."""
    dtype, device = state.pos.dtype, state.pos.device
    out = []
    for i, (t, chem) in enumerate(zip(system.types, chem_tuple)):
        if chem is None:
            out.append(torch.zeros((t.count * t.num_blobs, 3), dtype=dtype,
                                   device=device))
            continue
        ref = (normals_ref[i] if normals_ref is not None
               else torch.as_tensor(chem.normals_ref, dtype=dtype,
                                    device=device))
        _, q = kin.type_arrays(system, state, i)
        n = torch.einsum("cij,nj->cni", quat.rotation_matrix(q), ref)
        out.append(n.reshape(-1, 3))
    return torch.cat(out, dim=0)


def background_concentration(background, r):
    """c_b(r) up to quadratic terms and its gradient."""
    bg = torch.as_tensor(background, dtype=r.dtype, device=r.device)
    H = torch.zeros((3, 3), dtype=r.dtype, device=r.device)
    H[0, 0], H[0, 1], H[0, 2] = bg[4], bg[5], bg[6]
    H[1, 1], H[1, 2] = bg[7], bg[8]
    H[2, 2] = -bg[4] - bg[7]
    H = H + H.T - torch.diag(torch.diag(H))
    c = bg[0] + r @ bg[1:4]
    c = c + torch.einsum("ik,kj,ij->i", r, H, r)
    grad = 4.0 * r @ H + 2.0 * bg[1:4]
    return c, grad


class _Fields(NamedTuple):
    """The gathered chemistry of one device and dtype."""

    normals_ref: tuple   # per type: (nb, 3) tensor or None
    background: torch.Tensor
    k_rate: torch.Tensor
    q_rate: torch.Tensor
    mobility: torch.Tensor
    weights: torch.Tensor


def _fields(system: System, cfg: PhoreticConfig, dtype, device):
    g = lambda a: _gather(system, cfg.chemistry, a, dtype, device)  # noqa
    return _Fields(
        normals_ref=tuple(None if c is None else torch.as_tensor(
            c.normals_ref, dtype=dtype, device=device)
            for c in cfg.chemistry),
        background=torch.as_tensor(np.asarray(cfg.background, np.float64),
                                   dtype=dtype, device=device),
        k_rate=g("reaction_rate"), q_rate=g("emitting_rate"),
        mobility=g("surface_mobility"), weights=g("weights"))


def phoretic_slip(system: System, state: State, cfg: PhoreticConfig, *,
                  tol=None, maxiter=1000, restart=200, fields=None):
    """Solve the Laplace BVP and return (slip (N, 3), concentration (N,),
    GMRES iterations). `fields` (from `_fields`) reuses gathered chemistry
    tensors."""
    dtype, device = state.pos.dtype, state.pos.device
    if fields is None:
        fields = _fields(system, cfg, dtype, device)
    r = kin.blob_positions(system, state)
    wall = system.domain == "single_wall"
    normals = lab_normals(system, state, cfg.chemistry, fields.normals_ref)
    k_rate, q_rate, w = fields.k_rate, fields.q_rate, fields.weights
    dc = cfg.diffusion_coefficient

    c_bg, grad_bg = background_concentration(fields.background, r)
    rhs = c_bg + laplace.single_layer(r, r, q_rate / dc, w, wall=wall)

    def operator(c):
        return laplace.bvp_operator(r, c, w, normals, k_rate, dc, wall=wall)

    tol = system.solver_tolerance if tol is None else tol
    res = gmres(operator, rhs, tol=tol, maxiter=maxiter, restart=restart)
    c = res.x

    grad_c = grad_bg + laplace.surface_gradient(r, c, w, normals, k_rate,
                                                q_rate, dc, wall=wall)
    nn_grad = torch.einsum("ik,ik->i", normals, grad_c)
    slip = fields.mobility[:, None] * (grad_c - normals * nn_grad[:, None])
    return slip, c, res.iterations


def make_slip_fn(cfg: PhoreticConfig):
    """The System's slip hook of a phoretic configuration: slip_fn(system,
    state) -> (N, 3), the phoretic slip. The gathered chemistry tensors are
    built once per device and dtype, at the first call on each."""
    cache = {}

    def slip_fn(system, state):
        dtype, device = state.pos.dtype, state.pos.device
        if (dtype, device) not in cache:
            cache[dtype, device] = _fields(system, cfg, dtype, device)
        slip, _, _ = phoretic_slip(system, state, cfg,
                                   fields=cache[dtype, device])
        return slip

    return slip_fn


def concentration_field(system: System, state: State, cfg: PhoreticConfig,
                        targets, *, c=None, tol=None):
    """Exterior concentration at off-surface points,

        c(x) = c_bg(x) + D[c](x) - S[(k c - q)/Dc](x),

    the boundary-integral representation whose exterior surface limit
    reproduces the solved surface concentration (the JAX package's
    working replacement for the reference's undefined plotting helper).
    With c None the BVP is solved first. The layers run with the self mask
    off: the targets are not blobs. Returns (c at targets (P,),
    c_surface (N,))."""
    dtype, device = state.pos.dtype, state.pos.device
    fields = _fields(system, cfg, dtype, device)
    if c is None:
        _, c, _ = phoretic_slip(system, state, cfg, tol=tol, fields=fields)
    r = kin.blob_positions(system, state)
    wall = system.domain == "single_wall"
    normals = lab_normals(system, state, cfg.chemistry, fields.normals_ref)
    dc = cfg.diffusion_coefficient
    tgt = torch.as_tensor(targets, dtype=dtype, device=device)

    c_t, _ = background_concentration(fields.background, tgt)
    c_t = c_t + laplace.double_layer(r, tgt, c, fields.weights, normals,
                                     wall=wall, self_interaction=False)
    c_t = c_t - laplace.single_layer(
        r, tgt, (fields.k_rate * c - fields.q_rate) / dc, fields.weights,
        wall=wall, self_interaction=False)
    return c_t, c
