"""Blob force kernels (PyTorch).

Counterpart of rigidmultiblobswall_tpu/ops/forces.py:
`blob_external_forces` and the direct `blob_blob_forces`. The direct
pair sweep runs kernel K2 (ops/mobility_cuda.py) on a CUDA tensor and its
plain version on a CPU tensor. The linked-cell variant, body-body Yukawa
forces and periodic images are still to be ported (ROADMAP Queue 1,
items 14 and 18).

Physics: gravity plus the wall repulsion of
U(z) = U0 + U0 (a-z)/b for z < a, U0 exp(-(z-a)/b) otherwise, and the
blob-blob repulsion of U(r) = U0 + U0 (2a-r)/b for r < 2a,
U0 exp(-(r-2a)/b) otherwise.
"""

from __future__ import annotations

import torch

from . import mobility_cuda


def blob_external_forces(r_vectors, *, g=0.0, blob_mass=1.0, blob_radius=1.0,
                         repulsion_strength_wall=0.0, debye_length_wall=1.0):
    """Gravity + wall repulsion per blob, (N,3)."""
    h = r_vectors[:, 2]
    amp = repulsion_strength_wall / debye_length_wall
    fz = torch.where(h > blob_radius,
                     amp * torch.exp(-(h - blob_radius) / debye_length_wall),
                     torch.full_like(h, amp))
    f = torch.zeros_like(r_vectors)
    f[:, 2] = -g * blob_mass + fz
    return f


def blob_blob_forces(r_vectors, *, repulsion_strength=0.0, debye_length=1.0,
                     blob_radius=1.0, periodic_length=(0.0, 0.0, 0.0)):
    """Pairwise soft repulsion, direct O(N^2) sweep, (N,3) -> (N,3)."""
    if any(float(L) > 0 for L in periodic_length):
        raise NotImplementedError("periodic blob-blob forces are not "
                                  "ported yet (ROADMAP Queue 1, item 14)")
    if repulsion_strength == 0.0:
        return torch.zeros_like(r_vectors)
    return mobility_cuda.blob_blob_forces(
        r_vectors.contiguous(), repulsion_strength=repulsion_strength,
        debye_length=debye_length, blob_radius=blob_radius)
