"""Matrix-free square-root action M^{1/2} z by the Lanczos algorithm
(PyTorch, host loop).

Counterpart of rigidmultiblobswall_tpu/ops/lanczos.py
(`stochastic_forcing_lanczos`): Ando et al. (J. Chem. Phys. 137, 064106,
2012) with full reorthogonalization, convergence on the relative change
of successive noise iterates, and an optional preconditioner map L
applied to the output.

The Lanczos basis and the tridiagonal coefficients stay on the device;
the host reads them only at a convergence check, every `check_every`
iterations, where the small tridiagonal eigenproblem is solved on the
host in float64. Those reads go through parallel/mesh.host (rank 0's
values under a mesh of several ranks).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..parallel.mesh import host, host_float


class LanczosResult(NamedTuple):
    noise: torch.Tensor
    iterations: int
    converged: bool


def stochastic_forcing_lanczos(mobility_mult: Callable, z: torch.Tensor, *,
                               factor=1.0, tolerance: float = 1e-6,
                               max_iter: int = 64,
                               L_mult: Optional[Callable] = None,
                               check_every: int = 1) -> LanczosResult:
    """Return factor * M^{1/2} z for a flat vector z.

    mobility_mult: v -> M v for the SPD operator M. L_mult: optional map
    applied to the result (preconditioned variant). check_every: compute
    the noise and test convergence only every k-th iteration (and at the
    last one)."""
    n = z.shape[0]
    m = int(max_iter)
    v_norm = torch.linalg.norm(z)
    safe_v_norm = torch.where(v_norm > 0, v_norm, torch.ones_like(v_norm))
    V = torch.zeros((m + 1, n), dtype=z.dtype, device=z.device)
    V[0] = z / safe_v_norm
    h_diag = torch.zeros(m, dtype=z.dtype, device=z.device)
    h_sup = torch.zeros(m, dtype=z.dtype, device=z.device)
    e0 = torch.zeros_like(z)
    e0[0] = 1.0
    eps = float(torch.finfo(z.dtype).eps)

    def tridiag_noise(i):
        """noise_i = v_norm factor V^T Q sqrt(L)+ Q^T e1 over the leading
        (i+1) block of the tridiagonal matrix."""
        d = host(h_diag[:i + 1])
        s = host(h_sup[:i])
        T = np.diag(d) + np.diag(s, -1) + np.diag(s, 1)
        lam, Q = np.linalg.eigh(T)
        coeff = Q @ (np.sqrt(np.maximum(lam, 0.0)) * Q[0, :])
        c = torch.as_tensor(coeff, dtype=z.dtype, device=z.device)
        return (V[:i + 1].T @ c) * (v_norm * factor)

    noise = torch.zeros_like(z)
    converged = False
    i = 0
    while i < m and not converged:
        vi = V[i]
        w = mobility_mult(vi)
        if i > 0:
            w = w - h_sup[i - 1] * V[i - 1]
        hd = torch.dot(w, vi)
        w = w - hd * vi
        hs = torch.linalg.norm(w)
        w = torch.where(hs > 0, w / torch.where(hs > 0, hs,
                                                torch.ones_like(hs)), e0)
        h_diag[i] = hd
        h_sup[i] = hs
        # full reorthogonalization against the built basis
        Vb = V[:i + 1]
        w = w - Vb.T @ (Vb @ w)
        V[i + 1] = w
        if (i + 1) % check_every == 0 or i + 1 >= m:
            new = tridiag_noise(i)
            old_norm = host_float(torch.linalg.norm(noise))
            diff = host_float(torch.linalg.norm(new - noise))
            converged = i > 0 and diff / max(old_norm, eps) < tolerance
            noise = new
        i += 1
    if not host_float(v_norm) > 0:
        noise = torch.zeros_like(noise)
    if L_mult is not None:
        noise = L_mult(noise)
    return LanczosResult(noise=noise, iterations=i, converged=converged)
