"""Multi-device execution on torch.distributed (parallel/mesh.py) and its
end-to-end check (parallel/dryrun.py)."""

from . import mesh  # noqa: F401
