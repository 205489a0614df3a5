"""Blob-level translation mobility products and the dense mobility
matrix (PyTorch).

Counterpart of rigidmultiblobswall_tpu/ops/mobility.py for coupling 'tt'
in the domains 'single_wall' and 'no_wall' without periodic images.
Every O(N^2) product goes through `pair_kernels.pair_tt`: kernel K1 on a
CUDA tensor, its plain PyTorch version (the JAX package's generic tiled
path) on a CPU tensor. The SFM engine (mobility_sfm.py) is not ported.

Wall overlap regularization: products use z_eff = max(z, a) and
M <- B^T M(z_eff) B with the diagonal damping B_ii = min(z_i/a, 1).
"""

from __future__ import annotations

import math

import torch

from . import pair_kernels, rpy


def shift_heights(r_vectors, blob_radius):
    """z_effective = max(z, a)."""
    return torch.cat([r_vectors[..., :2],
                      torch.clamp(r_vectors[..., 2:3], min=blob_radius)],
                     dim=-1)


def damping_factors(r_vectors, blob_radius):
    """Per-blob damping B_ii = min(z/a, 1)."""
    return torch.clamp(r_vectors[..., 2] / blob_radius, max=1.0)


def _check_supported(coupling, domain, periodic_length):
    if coupling != "tt":
        raise NotImplementedError(
            f"coupling {coupling!r}: only 'tt' is ported (tr/rt/rr/grand "
            "wait for K1's other couplings, ROADMAP Queue 2)")
    if domain not in ("single_wall", "no_wall"):
        raise NotImplementedError(
            f"domain {domain!r} is not ported yet (ROADMAP Queue 1, item 4)")
    if any(float(L) > 0 for L in periodic_length):
        raise NotImplementedError("pseudo-periodic image boxes are not "
                                  "ported yet (ROADMAP Queue 1, item 4)")


def _block(coupling, domain, d, zt, zs, self_mask):
    """3x3 mobility block for d = (r_t - r_s)/a and heights zt, zs in
    units of a."""
    _check_supported(coupling, domain, ())
    m = rpy.rpy_tt(d, self_mask)
    if domain == "single_wall":
        m = m + rpy.wall_tt(d[..., 0], d[..., 1], zt + zs, zs, self_mask)
    return m


def pairwise_matvec_multi(r_src, r_tgt, vec, eta, a, *, coupling="tt",
                          domain="single_wall",
                          periodic_length=(0.0, 0.0, 0.0),
                          self_interaction=True):
    """Stacked products u_b = M v_b, vec (B, Ns, 3) -> (B, Nt, 3), sharing
    one pair sweep across the B right-hand sides."""
    _check_supported(coupling, domain, periodic_length)
    n_rhs, n_src = vec.shape[0], r_src.shape[0]
    n_tgt = r_tgt.shape[0]
    dtype = torch.promote_types(r_src.dtype, vec.dtype)
    v = vec.reshape(n_rhs, n_src, 3).to(dtype)
    r_src = r_src.to(dtype)
    r_tgt = r_tgt.to(dtype)
    wall = domain == "single_wall"
    if wall:
        damp_t = damping_factors(r_tgt, a)
        v = v * damping_factors(r_src, a)[None, :, None]
        r_src = shift_heights(r_src, a)
        r_tgt = shift_heights(r_tgt, a)
    inva = 1.0 / a
    V = v.permute(1, 0, 2).reshape(n_src, 3 * n_rhs).contiguous()
    out = pair_kernels.pair_tt((r_src * inva).contiguous(),
                               (r_tgt * inva).contiguous(), V, wall=wall,
                               self_interaction=self_interaction)
    out = out * (1.0 / (8.0 * math.pi * eta * a))
    if wall:
        out = out * damp_t[:, None]
    return out.reshape(n_tgt, n_rhs, 3).permute(1, 0, 2)


def pairwise_matvec(r_src, r_tgt, vec, eta, a, *, coupling="tt",
                    domain="single_wall", periodic_length=(0.0, 0.0, 0.0),
                    self_interaction=True):
    """u_i = sum_j M^tt_ij v_j over all (target, source) pairs.

    r_src (Ns,3), r_tgt (Nt,3), vec (Ns,3) -> (Nt,3). self_interaction
    must be True when r_src is r_tgt (square product)."""
    v = vec.reshape(1, r_src.shape[0], 3)
    return pairwise_matvec_multi(
        r_src, r_tgt, v, eta, a, coupling=coupling, domain=domain,
        periodic_length=periodic_length,
        self_interaction=self_interaction)[0]


def mobility_trans_times_force(r_vectors, vec, eta, a, **kw):
    """Square translation product: blob velocities from blob forces."""
    return pairwise_matvec(r_vectors, r_vectors, vec, eta, a,
                           coupling="tt", self_interaction=True, **kw)


def dense_mobility(r_vectors, eta, a, domain="single_wall", coupling="tt"):
    """Dense (3N, 3N) mobility with overlap regularization, for any leading
    batch dimensions: (..., N, 3) -> (..., 3N, 3N). Builds the per-body
    preconditioner blocks."""
    n = r_vectors.shape[-2]
    batch = r_vectors.shape[:-2]
    wall = domain == "single_wall"
    if wall:
        damp = damping_factors(r_vectors, a)
        r_vectors = shift_heights(r_vectors, a)
    q = r_vectors * (1.0 / a)
    d = q[..., :, None, :] - q[..., None, :, :]
    self_mask = torch.eye(n, dtype=torch.bool, device=q.device)
    zt = q[..., :, None, 2]
    zs = q[..., None, :, 2]
    m = _block(coupling, domain, d, zt, zs, self_mask.expand(d.shape[:-1]))
    m = m * (1.0 / (8.0 * math.pi * eta * a))
    if wall:
        m = m * damp[..., :, None, None, None] * damp[..., None, :, None, None]
    # (..., N, N, 3, 3) -> (..., 3N, 3N)
    return m.transpose(-3, -2).reshape(*batch, 3 * n, 3 * n)
