"""Multi-device execution: the O(N^2) and grid work of a product split
across the ranks of a torch.distributed process group.

Counterpart of rigidmultiblobswall_tpu/parallel/mesh.py, whose contract
this keeps: positions and vectors are replicated on every rank, each rank
computes its share of a product's pair sweep or grid work on its card,
and a collective brings the result back replicated. Body-level work (the
K products, the 6x6 solves, the GMRES and Lanczos recurrences) runs
redundantly on every rank.

- `Mesh` holds the process group, this rank, the group's size and the
  rank's device. `make_mesh` wraps an initialised group (a mesh over a
  group, of one rank too, runs its share and the collectives); a mesh of
  one rank needs none (the products' plain path), a larger one without
  an initialised group raises. `init_ranks` starts a group through a
  FileStore (no TCP port to choose), with a timeout, so that a rank that
  skips a collective makes the others fail rather than hang.
- `sharded_rows_apply` is the JAX function's contract: ceil-divided rows,
  `fn(row0, n_local, *args)` on every rank, the padded shards gathered.
- The collectives: `all_gather_rows`, `all_reduce_sum` (the partials
  gathered and added in rank order on every rank, so that every rank holds
  the same bits whatever the backend's reduction order), `all_to_all` of a
  split axis and `broadcast`. Each counts its calls and the bytes it moved
  (`COUNTS`). They take CUDA tensors on both backends: gloo, which lets
  several ranks share one card, moves them through host memory itself
  (each of these four collectives, on the H100).
- Replicated control flow: two processes do not share one program as the
  JAX package's devices do, and a rank whose atomics add in another order
  would take another GMRES branch and leave the next collective unmatched.
  Inside `replicated(mesh)` every value the host reads from the device to
  take a decision (`host`) is rank 0's, broadcast.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

# the group's timeout: a collective that a rank skipped fails after it
TIMEOUT_S = 120.0

# (calls, bytes) per collective since the last reset_counts()
COUNTS = {name: [0, 0] for name in ("all_gather", "all_reduce_sum",
                                    "all_to_all", "broadcast")}


def reset_counts():
    for v in COUNTS.values():
        v[0] = v[1] = 0


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A 1-D mesh of ranks: the process group (None for a single rank
    without one), this rank, the number of ranks and the rank's
    device."""

    group: Optional[object]
    rank: int
    size: int
    device: torch.device

    def rows(self, n):
        """(row0, n_local): this rank's ceil-divided share of n rows, the
        JAX function's; the last shares may run past n (padding)."""
        per = -(-int(n) // self.size)
        return self.rank * per, per

    def share(self, total):
        """[lo, hi): this rank's contiguous share of `total` work items,
        balanced to within one."""
        total = int(total)
        return (total * self.rank // self.size,
                total * (self.rank + 1) // self.size)


def _default_device(rank, size, device):
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: a mesh runs on the card unless "
                           "the caller passes device='cpu'")
    count = torch.cuda.device_count()
    local = int(os.environ.get("LOCAL_RANK", rank))
    # ranks that share one card (more ranks than cards) all take card 0
    return torch.device(f"cuda:{local}" if size <= count else "cuda:0")


def make_mesh(n=None, group=None, device=None) -> Mesh:
    """A Mesh over the initialised torch.distributed group `group` (the
    default group when None) on `device` (default this rank's card:
    cuda:LOCAL_RANK, or cuda:0 when the ranks share one card). n, when
    given, must be the group's size. Without an initialised group only a
    mesh of one rank exists: n > 1 raises."""
    if not dist.is_initialized():
        if n is not None and int(n) > 1:
            raise RuntimeError(f"make_mesh({n}): no torch.distributed "
                               "process group is initialised (init_ranks)")
        if group is not None:
            raise RuntimeError("make_mesh: a group without an initialised "
                               "torch.distributed")
        return Mesh(None, 0, 1, _default_device(0, 1, device))
    group = dist.group.WORLD if group is None else group
    size = dist.get_world_size(group)
    rank = dist.get_rank(group)
    if n is not None and int(n) != size:
        raise ValueError(f"make_mesh({n}): the group has {size} ranks")
    return Mesh(group, rank, size, _default_device(rank, size, device))


def init_ranks(world_size, rank, store_path, backend="gloo",
               timeout_s=TIMEOUT_S, device=None) -> Mesh:
    """Initialise the default process group of `world_size` ranks through
    a FileStore at store_path (one path a run, on a file system every rank
    sees) with a timeout, and return this rank's Mesh. backend "gloo"
    (CPU or CUDA tensors; several ranks may share one card) or "nccl"
    (one card a rank)."""
    store = dist.FileStore(str(store_path), int(world_size))
    kw = {}
    if backend == "nccl":
        dev = _default_device(rank, world_size, device)
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    dist.init_process_group(
        backend, store=store, rank=int(rank), world_size=int(world_size),
        timeout=datetime.timedelta(seconds=float(timeout_s)), **kw)
    return make_mesh(world_size, device=device)


def close():
    """Destroy the default process group, if any."""
    if dist.is_initialized():
        dist.destroy_process_group()


def is_sharded(mesh) -> bool:
    """True for a mesh over a process group (a product then takes its
    rank's share and the collectives; a group of one rank runs the same
    code over the whole), False for None or a one-rank mesh without a
    group."""
    return mesh is not None and mesh.group is not None


def _nbytes(t):
    return t.numel() * t.element_size()


def _real(t):
    return torch.view_as_real(t) if t.is_complex() else t


def all_gather_rows(mesh, local):
    """The ranks' row blocks `local` (equal shapes) stacked in rank order,
    (size * rows, ...)."""
    if not is_sharded(mesh):
        return local
    x = _real(local.contiguous())
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    COUNTS["all_gather"][0] += 1
    COUNTS["all_gather"][1] += _nbytes(x) * mesh.size
    full = torch.cat(parts)
    return torch.view_as_complex(full) if local.is_complex() else full


def all_reduce_sum(mesh, partial):
    """sum over ranks of `partial`, added in rank order on every rank (all
    ranks hold the same bits, whatever the backend's reduction order)."""
    if not is_sharded(mesh):
        return partial
    parts = all_gather_rows(mesh, partial[None])
    COUNTS["all_gather"][0] -= 1
    COUNTS["all_gather"][1] -= _nbytes(_real(partial)) * mesh.size
    COUNTS["all_reduce_sum"][0] += 1
    COUNTS["all_reduce_sum"][1] += _nbytes(_real(partial)) * mesh.size
    out = parts[0].clone()
    for r in range(1, mesh.size):
        out += parts[r]
    return out


def all_to_all(mesh, t, split_dim, concat_dim):
    """Split t along split_dim into `size` equal chunks, send chunk r to
    rank r, and concatenate the chunks received along concat_dim in rank
    order (the tiled all_to_all of jax.lax)."""
    if not is_sharded(mesh):
        return t
    if t.shape[split_dim] % mesh.size:
        raise ValueError(f"all_to_all: axis {split_dim} of {tuple(t.shape)} "
                         f"does not split into {mesh.size}")
    src = torch.stack(torch.chunk(t, mesh.size, dim=split_dim)).contiguous()
    x = _real(src)
    y = torch.empty_like(x)
    dist.all_to_all_single(y, x, group=mesh.group)
    COUNTS["all_to_all"][0] += 1
    COUNTS["all_to_all"][1] += _nbytes(x)
    if t.is_complex():
        y = torch.view_as_complex(y)
    return torch.cat(y.unbind(0), dim=concat_dim)


def broadcast(mesh, t, src=0):
    """Rank src's t on every rank (a new tensor)."""
    if not is_sharded(mesh):
        return t
    x = _real(t.detach().clone().contiguous())
    dist.broadcast(x, src=src, group=mesh.group)
    COUNTS["broadcast"][0] += 1
    COUNTS["broadcast"][1] += _nbytes(x)
    return torch.view_as_complex(x) if t.is_complex() else x


def sharded_rows_apply(mesh, fn, n_rows, *args):
    """Run fn(row0, n_local, *args) -> (n_local, ...) rows on every rank
    with the rows ceil-divided across the mesh, and gather them: returns
    (size * n_local, ...), the padded rows past n_rows included (the JAX
    function's contract). All args are replicated."""
    if mesh is None:
        return fn(0, int(n_rows), *args)
    row0, per = mesh.rows(n_rows)
    return all_gather_rows(mesh, fn(row0, per, *args))


# ---------------------------------------------------------------------------
# Replicated control flow
# ---------------------------------------------------------------------------

_ACTIVE = []


@contextlib.contextmanager
def replicated(mesh):
    """Within the block, `host` reads rank 0's values under `mesh` (a
    no-op for None or a single rank). The steppers and the solvers' entry
    points enter it with their system's mesh."""
    _ACTIVE.append(mesh)
    try:
        yield
    finally:
        _ACTIVE.pop()


def host(t) -> np.ndarray:
    """t read to the host as float64 numpy for a decision: inside a
    `replicated` block of a sharded mesh, rank 0's value, so every rank
    decides alike."""
    m = _ACTIVE[-1] if _ACTIVE else None
    if is_sharded(m):
        t = broadcast(m, t)
    return t.detach().double().cpu().numpy()


def host_float(t) -> float:
    return float(host(t))


def host_bool(t) -> bool:
    return bool(host(torch.as_tensor(t).to(torch.float64)) != 0)
