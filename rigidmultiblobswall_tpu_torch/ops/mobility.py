"""Blob-level mobility products and the dense mobility matrix (PyTorch).

Counterpart of rigidmultiblobswall_tpu/ops/mobility.py for the couplings
'tt', 'tr', 'rt', 'rr' and the grand (trans + rot) product, in the domains
'single_wall' and 'no_wall' (every coupling), 'in_plane' (tt and tr) and
'free_surface' (tt), open or with the pseudo-periodic image boxes of a
periodic_length (the minimum image, then the +-1 boxes on each periodic
axis). Every O(N^2) product goes through `pair_kernels.pair_matvec`:
kernel K1 (its image-box instance with a periodic_length) on a CUDA
tensor, its plain PyTorch version (the JAX package's generic tiled path)
on a CPU tensor, in the domain mode `DOMAIN_MODE` names. The in-plane
domain is the single wall with the z components projected away: its
blocks are P M P, P = diag(1, 1, 0), so its products zero v_z before K1's
wall instance and u_z after it. The free surface (a slip plane at z = 0)
adds to each tt block its image reflected in the plane, without the
height shift and the damping. `dense_mobility_tiled` materializes the tt
operator of one configuration (the plain version of kernel K3,
ops/mobility_cuda.py).
`source_target_matvec` is the source-target product of velocity fields,
with per-blob radii, image boxes and the free surface (plain PyTorch, as
it is XLA there). The square product with per-blob radii,
`mobility_radii_trans_times_force` (and its stacked form), runs kernel P1
on a CUDA tensor (ops/mobility_cuda.radii_matvec; its image-box and
free-surface instances) and `source_target_matvec` on a CPU tensor;
`dense_mobility_radii` materializes it for the preconditioner blocks and
the dense solves. Per-blob radii on 'in_plane' are refused: the JAX
package's radii products treat that domain as unbounded (no wall, no
projection), which is not the in-plane physics. The SFM engine
(mobility_sfm.py) is not ported.

A `mesh` (parallel/mesh.py) of several ranks splits the pair products:
a square product's symmetric sweep by group pairs, each rank's partial
summed by `all_reduce_sum` (each unordered pair computed once across the
mesh, where the JAX package's row split computes it twice), a two-tensor
product by target rows, gathered by `all_gather_rows`; both on kernel
K1's rank-share instances on the card. The radii products and the dense
matrices take no mesh, as in the JAX package.

Wall overlap regularization (single_wall, in_plane): products use z_eff =
max(z, a) and M <- B^T M(z_eff) B with the diagonal damping B_ii =
min(z_i/a, 1).
"""

from __future__ import annotations

import math

import torch

from . import pair_kernels, rpy

_PREF_POW = {"tt": 1, "tr": 2, "rt": 2, "rr": 3}

# the K1 domain mode of each pairwise domain (pair_kernels.MODES)
DOMAIN_MODE = {"single_wall": "wall", "no_wall": "open",
               "in_plane": "wall", "free_surface": "free_surface"}
# the couplings each domain has (the JAX package's _block)
_DOMAIN_COUPLINGS = {"in_plane": ("tt", "tr"), "free_surface": ("tt",)}


def shift_heights(r_vectors, blob_radius):
    """z_effective = max(z, a)."""
    return torch.cat([r_vectors[..., :2],
                      torch.clamp(r_vectors[..., 2:3], min=blob_radius)],
                     dim=-1)


def damping_factors(r_vectors, blob_radius):
    """Per-blob damping B_ii = min(z/a, 1)."""
    return torch.clamp(r_vectors[..., 2] / blob_radius, max=1.0)


def _check_supported(coupling, domain):
    if coupling not in _PREF_POW:
        raise ValueError(f"unknown coupling {coupling!r}")
    if domain not in DOMAIN_MODE:
        raise NotImplementedError(
            f"domain {domain!r}: the pair products cover "
            f"{tuple(DOMAIN_MODE)}")
    allowed = _DOMAIN_COUPLINGS.get(domain)
    if allowed is not None and coupling not in allowed:
        raise NotImplementedError(
            "in_plane supports 'tt' and 'tr' only" if domain == "in_plane"
            else "free_surface only supports 'tt'")


def _regularized(domain):
    """Whether the domain takes the wall's height shift and damping."""
    return domain in ("single_wall", "in_plane")


def _block(coupling, domain, d, zt, zs, self_mask):
    """3x3 mobility block for d = (r_t - r_s)/a and heights zt, zs in
    units of a (in_plane: the wall block with its z row and column
    zeroed)."""
    _check_supported(coupling, domain)
    m = pair_kernels.block(coupling, d, zt, zs, self_mask,
                           DOMAIN_MODE[domain])
    if domain == "in_plane":
        m = m * rpy.z_coupling_mask(m.dtype, m.device)
    return m


def _normalized(r_vectors, a, wall, dtype):
    """(q = r_eff / a contiguous, damping or None) for the kernel."""
    r = r_vectors.to(dtype)
    damp = None
    if wall:
        damp = damping_factors(r, a)
        r = shift_heights(r, a)
    return (r * (1.0 / a)).contiguous(), damp


def _sharded(q_src, q_tgt, V, group, *, mesh, **kw):
    """pair_kernels.pair_matvec over the columns of V in groups of
    `group`, on this rank's share of the mesh (module docstring), the
    result replicated."""
    from ..parallel import mesh as mesh_mod

    cols = range(0, V.shape[1], group)
    if not mesh_mod.is_sharded(mesh):
        return torch.cat([pair_kernels.pair_matvec(
            q_src, q_tgt, V[:, c0:c0 + group].contiguous(), **kw)
            for c0 in cols], dim=1)
    if q_tgt is None:
        pairs = mesh.share(pair_kernels.group_pairs(q_src))
        partial = torch.cat([pair_kernels.pair_matvec(
            q_src, None, V[:, c0:c0 + group].contiguous(), pairs=pairs,
            **kw) for c0 in cols], dim=1)
        return mesh_mod.all_reduce_sum(mesh, partial)
    n_tgt = q_tgt.shape[0]

    def rows(row0, n_local):
        out = V.new_zeros((n_local, V.shape[1]))
        hi = min(row0 + n_local, n_tgt)
        if hi > row0:
            q = q_tgt[row0:hi].contiguous()
            out[:hi - row0] = torch.cat([pair_kernels.pair_matvec(
                q_src, q, V[:, c0:c0 + group].contiguous(), row0=row0,
                **kw) for c0 in cols], dim=1)
        return out

    return mesh_mod.sharded_rows_apply(mesh, rows, n_tgt)[:n_tgt]


def pairwise_matvec_multi(r_src, r_tgt, vec, eta, a, *, coupling="tt",
                          domain="single_wall",
                          periodic_length=(0.0, 0.0, 0.0),
                          self_interaction=True, mesh=None):
    """Stacked products u_b = M v_b, vec (B, Ns, 3) -> (B, Nt, 3), sharing
    one pair sweep across the B right-hand sides. r_tgt None: the square
    product, targets = sources (K1 tt then takes its symmetric sweep). A
    stack wider than the kernel's instances (pair_kernels.MAX_RHS, e.g.
    the k columns of a Krylov recycle refresh) runs as consecutive groups
    of MAX_RHS right-hand sides, in order, one K1 launch each. A
    periodic_length with an axis L > 0 sums the image boxes (K1's image-box
    instance on the card). in_plane: K1's wall instance between the
    projections v_z = 0 and u_z = 0. A mesh of several ranks splits the
    sweep (module docstring); every rank gets the whole result."""
    _check_supported(coupling, domain)
    boxes = pair_kernels.image_boxes(periodic_length, a)
    n_rhs, n_src = vec.shape[0], r_src.shape[0]
    n_tgt = n_src if r_tgt is None else r_tgt.shape[0]
    dtype = torch.promote_types(r_src.dtype, vec.dtype)
    wall = _regularized(domain)
    q_src, damp_s = _normalized(r_src, a, wall, dtype)
    q_tgt, damp_t = ((None, damp_s) if r_tgt is None
                     else _normalized(r_tgt, a, wall, dtype))
    v = vec.reshape(n_rhs, n_src, 3).to(dtype)
    if wall:
        v = v * damp_s[None, :, None]
    V = v.permute(1, 0, 2).reshape(n_src, 3 * n_rhs)
    if domain == "in_plane":
        V = V.clone()
        V[:, 2::3] = 0.0
    out = _sharded(q_src, q_tgt, V, 3 * pair_kernels.MAX_RHS[coupling],
                   mesh=mesh, coupling=coupling, mode=DOMAIN_MODE[domain],
                   self_interaction=self_interaction, boxes=boxes)
    out = out * (1.0 / (8.0 * math.pi * eta * a ** _PREF_POW[coupling]))
    if wall:
        out = out * damp_t[:, None]
    if domain == "in_plane":
        out[:, 2::3] = 0.0
    return out.reshape(n_tgt, n_rhs, 3).permute(1, 0, 2)


def pairwise_matvec(r_src, r_tgt, vec, eta, a, *, coupling="tt",
                    domain="single_wall", periodic_length=(0.0, 0.0, 0.0),
                    self_interaction=True, mesh=None):
    """u_i = sum_j M^{coupling}_ij v_j over all (target, source) pairs.

    r_src (Ns,3), r_tgt (Nt,3) or None for the square product (targets =
    sources), vec (Ns,3) -> (Nt,3); mesh as pairwise_matvec_multi's."""
    v = vec.reshape(1, r_src.shape[0], 3)
    return pairwise_matvec_multi(
        r_src, r_tgt, v, eta, a, coupling=coupling, domain=domain,
        periodic_length=periodic_length,
        self_interaction=self_interaction, mesh=mesh)[0]


def _square_product(coupling):
    def product(r_vectors, vec, eta, a, **kw):
        return pairwise_matvec(r_vectors, None, vec, eta, a,
                               coupling=coupling, self_interaction=True, **kw)

    return product


mobility_trans_times_force = _square_product("tt")
mobility_trans_times_torque = _square_product("tr")
mobility_rot_times_force = _square_product("rt")
mobility_rot_times_torque = _square_product("rr")


def mobility_trans_times_force_torque(r_vectors, force, torque, eta, a, **kw):
    return (mobility_trans_times_force(r_vectors, force, eta, a, **kw)
            + mobility_trans_times_torque(r_vectors, torque, eta, a, **kw))


def mobility_rot_times_force_torque(r_vectors, force, torque, eta, a, **kw):
    return (mobility_rot_times_force(r_vectors, force, eta, a, **kw)
            + mobility_rot_times_torque(r_vectors, torque, eta, a, **kw))


def grand_mobility_matvec(r_vectors, force, torque, eta, a, *,
                          domain="single_wall",
                          periodic_length=(0.0, 0.0, 0.0), mesh=None):
    """(U, W) = M_grand (F, T) for single-blob bodies (rollers path): the
    four coupling blocks in ONE K1 pass over the pair geometry
    (mobility.py:386-409). T enters scaled by 1/a and W leaves scaled by
    a, so the kernel's sums see magnitudes of one order. A periodic_length
    with an axis L > 0 sums the image boxes (K1 grand's image-box
    instance). The rot couplings exist on single_wall and no_wall only.
    A mesh of several ranks splits the sweep by group pairs."""
    if domain not in ("single_wall", "no_wall"):
        _check_supported("rr", domain)
    n = r_vectors.shape[0]
    dtype = torch.promote_types(r_vectors.dtype, force.dtype)
    wall = domain == "single_wall"
    q, damp = _normalized(r_vectors, a, wall, dtype)
    F = force.reshape(n, 3).to(dtype)
    T = torque.reshape(n, 3).to(dtype)
    if wall:
        F = F * damp[:, None]
        T = T * damp[:, None]
    vin = torch.cat([F, T * (1.0 / a)], dim=1).contiguous()
    out = _sharded(q, None, vin, 6, mesh=mesh, coupling="grand",
                   mode=pair_kernels.wall_mode(wall), self_interaction=True,
                   boxes=pair_kernels.image_boxes(periodic_length, a))
    pref = 1.0 / (8.0 * math.pi * eta * a)
    u = out[:, :3] * pref
    w = out[:, 3:] * (pref / a)
    if wall:
        u = u * damp[:, None]
        w = w * damp[:, None]
    return u, w


def dense_mobility(r_vectors, eta, a, domain="single_wall", coupling="tt"):
    """Dense (3N, 3N) mobility with overlap regularization, for any leading
    batch dimensions: (..., N, 3) -> (..., 3N, 3N). Builds the per-body
    preconditioner blocks."""
    n = r_vectors.shape[-2]
    batch = r_vectors.shape[:-2]
    wall = _regularized(domain)
    if wall:
        damp = damping_factors(r_vectors, a)
        r_vectors = shift_heights(r_vectors, a)
    q = r_vectors * (1.0 / a)
    d = q[..., :, None, :] - q[..., None, :, :]
    self_mask = torch.eye(n, dtype=torch.bool, device=q.device)
    zt = q[..., :, None, 2]
    zs = q[..., None, :, 2]
    m = _block(coupling, domain, d, zt, zs, self_mask.expand(d.shape[:-1]))
    m = m * (1.0 / (8.0 * math.pi * eta * a ** _PREF_POW[coupling]))
    if wall:
        m = m * damp[..., :, None, None, None] * damp[..., None, :, None, None]
    # (..., N, N, 3, 3) -> (..., 3N, 3N)
    return m.transpose(-3, -2).reshape(*batch, 3 * n, 3 * n)


def rotne_prager_tensor(r_vectors, eta, a):
    """Dense unbounded RPY trans-trans mobility (3N, 3N)."""
    return dense_mobility(r_vectors, eta, a, domain="no_wall")


def single_wall_fluid_mobility(r_vectors, eta, a):
    """Dense single-wall (Swan-Brady) trans-trans mobility (3N, 3N),
    including the overlap regularization."""
    return dense_mobility(r_vectors, eta, a, domain="single_wall")


def single_wall_self_mobility_with_rotation(height, eta, a):
    """6x6 single-blob self mobility (translation and rotation blocks with
    their coupling) above the wall, from the Swan-Brady expansions (the
    reference's mobility.py:739-774); height a tensor of z coordinates
    (...) -> (..., 6, 6), or a number (float64)."""
    if not isinstance(height, torch.Tensor):
        height = torch.as_tensor(height, dtype=torch.float64)
    h = height / a
    he = torch.clamp(h, min=1.0)
    damp = torch.clamp(h, 0.0, 1.0)
    f_tt = 1.0 / (6.0 * math.pi * eta * a)
    f_rr = 1.0 / (6.0 * math.pi * eta * a ** 3)
    f_rt = 1.0 / (6.0 * math.pi * eta * a ** 2)
    tt_para = f_tt * (1 - 9 / (16 * he) + 2 / (16 * he ** 3)
                      - 1 / (16 * he ** 5)) * damp
    tt_perp = f_tt * (1 - 9 / (8 * he) + 1 / (2 * he ** 3)
                      - 1 / (8 * he ** 5)) * damp
    rr_para = f_rr * (0.75 - 15 / (64 * he ** 3)) * damp
    rr_perp = f_rr * (0.75 - 3 / (32 * he ** 3)) * damp
    rt_para = f_rt * (3 / (32 * he ** 4)) * damp
    z = torch.zeros_like(he)
    rows = [
        torch.stack([tt_para, z, z, z, rt_para, z], dim=-1),
        torch.stack([z, tt_para, z, -rt_para, z, z], dim=-1),
        torch.stack([z, z, tt_perp, z, z, z], dim=-1),
        torch.stack([z, -rt_para, z, rr_para, z, z], dim=-1),
        torch.stack([rt_para, z, z, z, rr_para, z], dim=-1),
        torch.stack([z, z, z, z, z, rr_perp], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def dense_mobility_tiled(r_vectors, eta, a, *, domain="single_wall",
                         coupling="tt", periodic_length=(0.0, 0.0, 0.0),
                         row_tile=None):
    """Materialize the mobility of one configuration, (N,3) -> (3N, 3N)
    interleaved (row 3i+a, column 3j+b), with the overlap regularization,
    the 1/(8 pi eta a^k) factor and the damping folded in, built in row
    tiles so the peak memory beside the result stays bounded.

    Counterpart of mobility.py:dense_mobility_tiled, which returns (3,3,N,N)
    component planes: those avoid the TPU's padding of a minor length-3
    axis; here the interleaved matrix serves the stacked products as one
    matmul. The plain version of kernel K3 (ops/mobility_cuda.dense_tt).
    A periodic_length with an axis L > 0 sums every image box into each
    block after the minimum image, the self block in the home box only
    (JAX mobility.py:618-680)."""
    _check_supported(coupling, domain)
    n = r_vectors.shape[0]
    wall = _regularized(domain)
    q, damp = _normalized(r_vectors, a, wall, r_vectors.dtype)
    if row_tile is None:
        row_tile = pair_kernels._default_row_tile(
            n, n, q.element_size(),
            budget_bytes=pair_kernels.PLAIN_TILE_BYTES)
    boxes = pair_kernels.image_boxes(periodic_length, a)
    L, offsets = boxes if boxes is not None else ((0.0, 0.0, 0.0),
                                                  [(0, 0, 0)])
    Lvec = torch.tensor(L, dtype=q.dtype, device=q.device)
    src_ids = torch.arange(n, device=q.device)
    zs = q[:, 2][None, :]
    pref = 1.0 / (8.0 * math.pi * eta * a ** _PREF_POW[coupling])
    out = torch.empty((3 * n, 3 * n), dtype=q.dtype, device=q.device)
    for i0 in range(0, n, row_tile):
        qt = q[i0:i0 + row_tile]
        rows = torch.arange(i0, i0 + qt.shape[0], device=q.device)
        d0 = qt[:, None, :] - q[None, :, :]
        if boxes is not None:
            d0 = pair_kernels.min_image(d0, L)
        m = None
        for box in offsets:
            home = box == (0, 0, 0)
            self_mask = (rows[:, None] == src_ids[None, :]) & home
            d = d0 if home else d0 + torch.tensor(
                box, dtype=q.dtype, device=q.device) * Lvec
            mb = _block(coupling, domain, d, qt[:, 2][:, None], zs,
                        self_mask)
            m = mb if m is None else m + mb
        m = m * pref
        if wall:
            m = (m * damp[i0:i0 + qt.shape[0], None, None, None]
                 * damp[None, :, None, None])
        out[3 * i0:3 * (i0 + qt.shape[0])] = m.transpose(1, 2).reshape(
            3 * qt.shape[0], 3 * n)
    return out


# ---------------------------------------------------------------------------
# Source-target products with per-blob radii (velocity fields)
# ---------------------------------------------------------------------------


def source_target_matvec(r_src, r_tgt, vec, radius_src, radius_tgt, eta, *,
                         wall=True, domain=None,
                         periodic_length=(0.0, 0.0, 0.0), row_tile=None):
    """u_i = sum_j M_tt(target_i, source_j) f_j with per-blob radii: the
    physical-units RPY of unequal radii plus, for domain 'single_wall', the
    finite-size wall image system with per-blob-radius overlap
    regularization (targets of zero radius, tracers, are never damped), or
    for domain 'free_surface' the reflected image; summed over the image
    boxes of periodic_length after the minimum image.

    Counterpart of the JAX package's source_target_matvec, whose lax.map
    row tiles become chunks of row_tile targets (default: a (chunk, Ns, 3,
    3) block within 64 MiB). Plain PyTorch, as it is XLA there."""
    box_offsets, min_image = pair_kernels.box_offsets, pair_kernels.min_image

    if domain is not None:
        wall = domain == "single_wall"
    else:
        domain = "single_wall" if wall else "no_wall"
    free_surface = domain == "free_surface"
    periodic_length = tuple(float(x) for x in periodic_length)
    n_src, n_tgt = r_src.shape[0], r_tgt.shape[0]
    dtype = torch.promote_types(r_src.dtype, vec.dtype)
    dev = r_src.device
    vec = vec.reshape(n_src, 3).to(dtype)
    r_src, r_tgt = r_src.to(dtype), r_tgt.to(dtype)
    radius_src = torch.broadcast_to(
        torch.as_tensor(radius_src, dtype=dtype, device=dev), (n_src,))
    radius_tgt = torch.broadcast_to(
        torch.as_tensor(radius_tgt, dtype=dtype, device=dev), (n_tgt,))

    if wall:
        damp_s = torch.clamp(r_src[:, 2] / radius_src, max=1.0)
        pos = radius_tgt > 0
        damp_t = torch.where(pos, torch.clamp(
            r_tgt[:, 2] / torch.where(pos, radius_tgt, 1.0), max=1.0), 1.0)
        r_src = torch.cat([r_src[:, :2], torch.maximum(
            r_src[:, 2], radius_src)[:, None]], dim=1)
        r_tgt = torch.cat([r_tgt[:, :2], torch.maximum(
            r_tgt[:, 2], radius_tgt)[:, None]], dim=1)
        vec = vec * damp_s[:, None]

    if row_tile is None:
        row_tile = pair_kernels._default_row_tile(n_src, n_tgt,
                                                  torch.finfo(dtype).bits // 8)
    offsets = box_offsets(periodic_length)
    Lvec = torch.tensor(periodic_length, dtype=dtype, device=dev)
    zs = r_src[:, 2]
    bs = radius_src[None, :]
    refl = torch.tensor([1.0, 1.0, -1.0], dtype=dtype, device=dev)
    out = torch.empty((n_tgt, 3), dtype=dtype, device=dev)
    for i0 in range(0, n_tgt, row_tile):
        rt = r_tgt[i0:i0 + row_tile]
        at = radius_tgt[i0:i0 + row_tile][:, None]
        d0 = min_image(rt[:, None, :] - r_src[None, :, :], periodic_length)
        acc = torch.zeros((rt.shape[0], 3), dtype=dtype, device=dev)
        for box in offsets:
            d = d0 if box == (0, 0, 0) else d0 + torch.tensor(
                box, dtype=dtype, device=dev) * Lvec
            m = rpy.rpy_tt_radii(d, at, bs)
            if wall:
                rz = rt[:, 2][:, None] + zs[None, :]
                m = m + rpy.wall_tt_radii(d[..., 0], d[..., 1], rz,
                                          rt[:, 2][:, None], zs[None, :],
                                          at, bs)
            elif free_surface:
                rz = rt[:, 2][:, None] + zs[None, :]
                d_img = torch.cat([d[..., :2], rz[..., None]], dim=-1)
                m = m + rpy.rpy_tt_radii(d_img, at, bs) * refl
            acc = acc + torch.einsum("tsab,sb->ta", m, vec)
        out[i0:i0 + rt.shape[0]] = acc
    out = out / (8.0 * math.pi * eta)
    if wall:
        out = out * damp_t[:, None]
    return out


# ---------------------------------------------------------------------------
# Square products and dense matrices with per-blob radii
# ---------------------------------------------------------------------------


RADII_DOMAINS = ("single_wall", "no_wall", "free_surface")


def _check_radii(domain):
    if domain not in RADII_DOMAINS:
        raise NotImplementedError(
            f"per-blob radii on domain {domain!r}: the port covers "
            f"{RADII_DOMAINS}" + (
                "; on in_plane the JAX package's radii products drop the "
                "wall and the projection, so the port refuses them rather "
                "than run other physics" if domain == "in_plane" else ""))


def mobility_radii_multi(r_vectors, vec, radii, eta, *,
                         domain="single_wall",
                         periodic_length=(0.0, 0.0, 0.0)):
    """Stacked square tt products with per-blob radii, vec (B, N, 3) ->
    (B, N, 3): kernel P1 on a CUDA tensor (ops/mobility_cuda.radii_matvec,
    B = 1 or 2 a launch, wider stacks in consecutive pairs; its image-box
    instance with a periodic_length, its free-surface instance on
    free_surface), the source-target product with sources = targets on a
    CPU tensor (its r = 0 branch is the self mobility 4/(3 a))."""
    from .mobility_cuda import RADII_MAX_RHS, radii_matvec

    _check_radii(domain)
    radii = torch.broadcast_to(torch.as_tensor(
        radii, dtype=r_vectors.dtype, device=r_vectors.device),
        (r_vectors.shape[0],))
    return torch.cat([radii_matvec(r_vectors, vec[b0:b0 + RADII_MAX_RHS],
                                   radii, eta, domain=domain,
                                   periodic_length=periodic_length)
                      for b0 in range(0, vec.shape[0], RADII_MAX_RHS)])


def mobility_radii_trans_times_force(r_vectors, vec, radii, eta, *,
                                     domain="single_wall",
                                     periodic_length=(0.0, 0.0, 0.0)):
    """The square tt product with per-blob radii (the JAX package's
    mobility_radii_trans_times_force), (N, 3) -> (N, 3)."""
    n = r_vectors.shape[0]
    return mobility_radii_multi(r_vectors, vec.reshape(1, n, 3), radii, eta,
                                domain=domain,
                                periodic_length=periodic_length)[0]


def dense_mobility_radii(r_vectors, radii, eta, *, domain="single_wall"):
    """Dense (3N, 3N) tt mobility with per-blob radii, for any leading
    batch dimensions ((..., N, 3) -> (..., 3N, 3N)): the product of
    mobility_radii_trans_times_force materialized, for the per-body
    preconditioner blocks and the dense solves (plain PyTorch, as it is
    XLA in the JAX package); free_surface adds the reflected image. No
    periodic images."""
    _check_radii(domain)
    n = r_vectors.shape[-2]
    batch = r_vectors.shape[:-2]
    dtype = r_vectors.dtype
    radii = torch.broadcast_to(torch.as_tensor(
        radii, dtype=dtype, device=r_vectors.device), (*batch, n))
    wall = domain == "single_wall"
    if wall:
        damp = torch.clamp(r_vectors[..., 2] / radii, max=1.0)
        r_vectors = torch.cat([r_vectors[..., :2], torch.maximum(
            r_vectors[..., 2], radii)[..., None]], dim=-1)
    d = r_vectors[..., :, None, :] - r_vectors[..., None, :, :]
    at = radii[..., :, None]
    bs = radii[..., None, :]
    m = rpy.rpy_tt_radii(d, at, bs)
    zt = r_vectors[..., :, None, 2]
    zs = r_vectors[..., None, :, 2]
    if wall:
        m = m + rpy.wall_tt_radii(d[..., 0], d[..., 1], zt + zs, zt, zs, at,
                                  bs)
    elif domain == "free_surface":
        d_img = torch.cat([d[..., :2], (zt + zs)[..., None]], dim=-1)
        refl = torch.tensor([1.0, 1.0, -1.0], dtype=dtype,
                            device=r_vectors.device)
        m = m + rpy.rpy_tt_radii(d_img, at, bs) * refl
    m = m / (8.0 * math.pi * eta)
    if wall:
        m = m * damp[..., :, None, None, None] * damp[..., None, :, None, None]
    return m.transpose(-3, -2).reshape(*batch, 3 * n, 3 * n)
