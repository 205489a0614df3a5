"""Kernels G1 and G2: the spectral gridding on the card.

- G1 `grid_spread`: S f, every point's (N, C) forces spread with the
  separable ES window of support P into a channel-major (C, nxl, gy, gz)
  grid, by atomic adds; counterpart of the XLA gridding of
  rigidmultiblobswall_tpu/ops/ewald.py (`spread`, `_spread_planes`);
  CUDA source `csrc/gridding.cu`.
- G2 `grid_interpolate`: S^T u, its exact transpose, the rows (N, C) read
  from that grid in place, each row's sum in a fixed order (bit-identical
  on repeat); counterpart of `interpolate` and `_interp_rows` there.

Both take the stamps of ops/ewald.py's plain versions (`spread_plain`,
`interpolate_plain`): the x planes from the sort-time positions, y and z
from the current ones, every index modulo the grid; `ids` (the rows of
the positions the points are, forces and rows then (len(ids), C)) and
`planes` (x0, nx), the slab of those x planes alone. The kernels take
the points in the order of their sort-time x (`walk`, an argsort a
call): the warps in flight then stamp few x planes, and G1's atomic adds
land in fewer lines (at 98,304 image points and C = 18, 5.0 ms against
9.9 in the callers' order). `params` is the
plan's EwaldParams (the wall engine's `grid_params()` view: its z period
spans the mirrored image points at negative z): `grid`, `box`, `support`
and `es_beta`, the spacing box / grid.

The wrappers take CUDA tensors alone (ops/ewald.py calls the plain
versions on the CPU) and raise on anything else, and on a dtype, shape,
contiguity or range the kernels do not take. C is 3 per right-hand side
or moment (the engines pass 3, 6, 9 and 18); a call launches one kernel
a block of its C channels (instances of 18, 9, 6 and 3 channels, the
largest first: one launch for every C the engines pass) and counts each
launch in `LAUNCHES` under its instance ("grid_spread_c3", ...);
a launch on a slab of x planes (a rank's share) counts also in
`SHARE_LAUNCHES`.
"""

from __future__ import annotations

import torch

from . import _build

CHANNEL_BLOCKS = (18, 9, 6, 3)         # csrc/gridding.cu's instances
MAX_SUPPORT = 16                       # csrc/gridding.cu kMaxP

# kernel launches made by the wrappers in this process, by instance
LAUNCHES = {f"{k}_c{c}": 0 for k in ("grid_spread", "grid_interpolate")
            for c in CHANNEL_BLOCKS}
# launches on a slab of x planes (planes given)
SHARE_LAUNCHES = dict(LAUNCHES)


def channel_blocks(C):
    """The kernel instances a call of C channels (a multiple of 3)
    launches, as (first channel, channels) pairs, the largest instance
    first."""
    out, c0 = [], 0
    while c0 < C:
        ct = next(b for b in CHANNEL_BLOCKS if b <= C - c0)
        out.append((c0, ct))
        c0 += ct
    return out


def _channels(what, C):
    if C % 3:
        raise ValueError(f"{what}: {C} channels, not a multiple of 3")
    return C


def _check(what, positions, sort_pos, data, params, ids, planes):
    """Raise on what the kernels do not take; returns (n points, nxl, x0,
    ids as a contiguous int64 tensor or None)."""
    dtype = positions.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{what}: dtype {dtype} (float32/float64 only)")
    for name, t in (("positions", positions), ("sort_pos", sort_pos),
                    ("data", data)):
        if t.dtype != dtype or t.device != positions.device:
            raise ValueError(f"{what}: {name} is {t.dtype} on {t.device}, "
                             f"expected {dtype} on {positions.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
    N = positions.shape[0]
    if positions.ndim != 2 or positions.shape[1] != 3 or (
            sort_pos.shape != positions.shape):
        raise ValueError(f"{what}: positions and sort_pos must be (N, 3), "
                         f"got {tuple(positions.shape)} and "
                         f"{tuple(sort_pos.shape)}")
    if ids is not None:
        if (ids.ndim != 1 or ids.device != positions.device
                or ids.dtype not in (torch.int32, torch.int64)):
            raise ValueError(f"{what}: ids must be a 1-D integer tensor on "
                             f"{positions.device}")
        ids = ids.to(torch.int64).contiguous()
    n = N if ids is None else ids.shape[0]
    gx, gy, gz = (int(g) for g in params.grid)
    P = int(params.support)
    if not 1 <= P <= min(MAX_SUPPORT, gx, gy, gz):
        raise ValueError(f"{what}: support {P} (at most {MAX_SUPPORT} and "
                         f"the grid {params.grid})")
    x0, nxl = (0, gx) if planes is None else (int(planes[0]), int(planes[1]))
    if not (0 <= x0 and 1 <= nxl and x0 + nxl <= gx):
        raise ValueError(f"{what}: planes {planes} outside the grid's "
                         f"{gx} x planes")
    if max(n, N) * 3 >= 2 ** 31:
        raise ValueError(f"{what}: too many points for 32-bit counts")
    if positions.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {positions.device} "
                         "(the plain versions are ops/ewald.py's "
                         "spread_plain and interpolate_plain)")
    return n, nxl, x0, ids


def walk(sort_pos, ids):
    """The points a launch takes, in the order of their sort-time x:
    (their rows of the positions, their rows of the forces or outputs)."""
    xs = sort_pos[:, 0] if ids is None else sort_pos[ids, 0]
    rows = torch.argsort(xs, stable=True)
    return (rows if ids is None else ids[rows]).contiguous(), rows


def _launch(kind, positions, sort_pos, ids, src, dst, n, C, params, x0,
            nxl, src_step, dst_step, share):
    """One launch a channel block: src and dst advance by src_step and
    dst_step elements a channel."""
    if n == 0:
        return
    ids, rows = walk(sort_pos, ids)
    lib = _build.library()
    t = "f32" if positions.dtype == torch.float32 else "f64"
    gx, gy, gz = (int(g) for g in params.grid)
    stream = torch.cuda.current_stream(positions.device).cuda_stream
    esize = positions.element_size()
    for c0, ct in channel_blocks(C):
        name = f"grid_{'spread' if kind == 'grid_spread' else 'interp'}" \
               f"_{t}_c{ct}"
        err = getattr(lib, name)(
            positions.data_ptr(), sort_pos.data_ptr(),
            ids.data_ptr(), rows.data_ptr(),
            src.data_ptr() + c0 * src_step * esize,
            dst.data_ptr() + c0 * dst_step * esize, n, C, gx, gy, gz, x0,
            nxl, int(params.support), *(float(L) for L in params.box),
            float(params.es_beta), stream)
        _build.check(name, err)
        LAUNCHES[f"{kind}_c{ct}"] += 1
        if share:
            SHARE_LAUNCHES[f"{kind}_c{ct}"] += 1


def grid_spread(positions, sort_pos, forces, params, ids=None, planes=None):
    """G1: (n, C) forces -> (C, nxl, gy, gz) grid (n = len(ids), or every
    position; nxl = planes[1], or gx). forces contiguous, of the
    positions' dtype."""
    C = _channels("grid_spread", forces.shape[-1])
    n, nxl, x0, ids = _check("grid_spread", positions, sort_pos, forces,
                             params, ids, planes)
    if forces.ndim != 2 or forces.shape[0] != n:
        raise ValueError(f"grid_spread: forces must be ({n}, C), got "
                         f"{tuple(forces.shape)}")
    _, gy, gz = (int(g) for g in params.grid)
    grid = torch.zeros((C, nxl, gy, gz), dtype=forces.dtype,
                       device=forces.device)
    _launch("grid_spread", positions, sort_pos, ids, forces, grid, n, C,
            params, x0, nxl, 1, nxl * gy * gz, planes is not None)
    return grid


def grid_interpolate(positions, sort_pos, ug, params, ids=None, planes=None):
    """G2: (C, nxl, gy, gz) grid -> (n, C) rows (n = len(ids), or every
    position). ug contiguous, of the positions' dtype."""
    C = _channels("grid_interpolate", ug.shape[0])
    n, nxl, x0, ids = _check("grid_interpolate", positions, sort_pos, ug,
                             params, ids, planes)
    _, gy, gz = (int(g) for g in params.grid)
    if ug.ndim != 4 or tuple(ug.shape[1:]) != (nxl, gy, gz):
        raise ValueError(f"grid_interpolate: ug must be (C, {nxl}, {gy}, "
                         f"{gz}), got {tuple(ug.shape)}")
    out = torch.empty((n, C), dtype=ug.dtype, device=ug.device)
    _launch("grid_interpolate", positions, sort_pos, ids, ug, out, n, C,
            params, x0, nxl, nxl * gy * gz, 1, planes is not None)
    return out
