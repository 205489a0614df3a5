"""Restarted GMRES with right preconditioning (PyTorch, host loops).

Counterpart of rigidmultiblobswall_tpu/ops/gmres.py: `gmres` and
`gmres_lockstep` (deflation and Krylov recycling are still to be ported,
ROADMAP Queue 1, item 17). Right preconditioning solves A M(y) = b and
returns x = M(y), so convergence is judged on the true residual.

The Arnoldi vectors live on the device of b; the small Hessenberg
algebra (Givens rotations, the triangular solve) runs on the host in
float64. That costs one device-to-host sync per iteration, to read the
new Hessenberg column: a known cost of this first port (PERF.md).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch


class GmresResult(NamedTuple):
    x: torch.Tensor
    residual_norm: object   # float, or (nrhs,) numpy array for lockstep
    iterations: int
    converged: object       # bool, or (nrhs,) numpy bool array


def _identity(v):
    return v


def _givens(h, cs, sn, g, j):
    """Apply the stored rotations to Hessenberg column h (float64 numpy,
    length >= j+2), then the new rotation annihilating h[j+1]. Updates
    cs, sn, g in place; returns (h, denom)."""
    for i in range(j):
        hi, hip = h[i], h[i + 1]
        h[i] = cs[i] * hi + sn[i] * hip
        h[i + 1] = -sn[i] * hi + cs[i] * hip
    hj, hjp = h[j], h[j + 1]
    denom = float(np.sqrt(hj * hj + hjp * hjp))
    c, s = (hj / denom, hjp / denom) if denom > 0 else (1.0, 0.0)
    h[j] = c * hj + s * hjp
    h[j + 1] = 0.0
    cs[j], sn[j] = c, s
    gj = g[j]
    g[j], g[j + 1] = c * gj, -s * gj
    return h, denom


def _triangular_coeffs(R, g, j):
    """Least-squares coefficients of the first j Arnoldi vectors. A zero
    diagonal (Krylov breakdown) gets a unit diagonal and a zero g entry,
    so that direction contributes nothing instead of 0/0."""
    Rm = R[:j, :j].copy()
    gm = g[:j].copy()
    dz = np.diag(Rm) == 0.0
    Rm[dz, dz] = 1.0
    gm[dz] = 0.0
    return np.linalg.solve(Rm, gm) if j else gm


def gmres(matvec: Callable, b: torch.Tensor, *, x0: Optional[torch.Tensor] = None,
          tol: float = 1e-8, atol: float = 0.0, restart: int = 60,
          maxiter: int = 1000, M: Optional[Callable] = None,
          verbose: bool = False) -> GmresResult:
    """Solve matvec(x) = b for a flat vector b. M applies the
    preconditioner (an approximation of A^{-1}), on the right."""
    n = b.shape[0]
    M = M or _identity
    cold_start = x0 is None
    if cold_start:
        x0 = torch.zeros_like(b)
    m = int(min(restart, n, maxiter))
    max_cycles = max(1, -(-maxiter // m))
    target = max(tol * float(torch.linalg.norm(b)), atol)

    def a_tilde(y):
        return matvec(M(y))

    # skip the A*0 product on a cold start (one pair sweep at scale)
    r0 = b if cold_start else b - matvec(x0)
    y = torch.zeros_like(b)
    r, rnorm = r0, float(torch.linalg.norm(r0))
    iters = cycles = 0
    while cycles < max_cycles and rnorm > target:
        V = torch.zeros((m + 1, n), dtype=b.dtype, device=b.device)
        V[0] = r / (rnorm if rnorm > 0 else 1.0)
        R = np.zeros((m + 1, m))
        cs, sn = np.zeros(m), np.zeros(m)
        g = np.zeros(m + 1)
        g[0] = rnorm
        res, j = rnorm, 0
        while j < m and res > target:
            w = a_tilde(V[j])
            # classical Gram-Schmidt, applied twice for stability
            Vj = V[:j + 1]
            h1 = Vj @ w
            w = w - Vj.T @ h1
            h2 = Vj @ w
            w = w - Vj.T @ h2
            wnorm_t = torch.linalg.norm(w)
            hcol = torch.cat([h1 + h2, wnorm_t[None]]).double().cpu().numpy()
            wnorm = float(hcol[-1])
            if wnorm > 0:
                V[j + 1] = w / wnorm_t
            h = np.zeros(m + 1)
            h[:j + 2] = hcol
            h, denom = _givens(h, cs, sn, g, j)
            # denom == 0: the Krylov space closed without the residual
            # reaching zero; keep the previous estimate
            if denom > 0:
                res = abs(g[j + 1])
            if verbose:
                print(f"gmres iteration {j}, residual {res}")
            R[:, j] = h
            j += 1
        ym = _triangular_coeffs(R, g, j)
        y = y + V[:j].T @ torch.as_tensor(ym, dtype=b.dtype, device=b.device)
        iters += j
        cycles += 1
        # trust the Givens estimate when it converged; a restart always
        # recomputes the true residual
        if res <= target:
            rnorm = res
        else:
            r = r0 - a_tilde(y)
            rnorm = float(torch.linalg.norm(r))
    x = x0 + M(y)
    return GmresResult(x=x, residual_norm=rnorm, iterations=iters,
                       converged=rnorm <= target)


def gmres_lockstep(matvec: Callable, b: torch.Tensor, *,
                   x0: Optional[torch.Tensor] = None, tol: float = 1e-8,
                   atol: float = 0.0, restart: int = 60, maxiter: int = 1000,
                   M: Optional[Callable] = None) -> GmresResult:
    """Solve matvec(X) = b for a stack b (nrhs, n): one Arnoldi process
    per right-hand side, all advanced by ONE operator call per iteration,
    so the pair sweep is shared across the stack. Runs until every column
    meets its own target; converged columns keep iterating harmlessly.
    `iterations` counts the batched sweeps."""
    nrhs, n = b.shape
    M = M or _identity
    cold_start = x0 is None
    if cold_start:
        x0 = torch.zeros_like(b)
    m = int(min(restart, n, maxiter))
    max_cycles = max(1, -(-maxiter // m))
    b_norm = torch.linalg.norm(b, dim=1).double().cpu().numpy()
    target = np.maximum(tol * b_norm, atol)

    def a_tilde(Y):
        return matvec(M(Y))

    r0 = b if cold_start else b - matvec(x0)
    y = torch.zeros_like(b)
    r = r0
    rnorm = torch.linalg.norm(r0, dim=1).double().cpu().numpy()
    iters = cycles = 0
    while cycles < max_cycles and np.any(rnorm > target):
        V = torch.zeros((nrhs, m + 1, n), dtype=b.dtype, device=b.device)
        safe = torch.as_tensor(np.where(rnorm > 0, rnorm, 1.0),
                               dtype=b.dtype, device=b.device)
        V[:, 0] = r / safe[:, None]
        R = np.zeros((nrhs, m + 1, m))
        cs, sn = np.zeros((nrhs, m)), np.zeros((nrhs, m))
        g = np.zeros((nrhs, m + 1))
        g[:, 0] = rnorm
        res = rnorm.copy()
        j = 0
        while j < m and np.any(res > target):
            w = a_tilde(V[:, j])
            Vj = V[:, :j + 1]
            h1 = torch.einsum("bkn,bn->bk", Vj, w)
            w = w - torch.einsum("bkn,bk->bn", Vj, h1)
            h2 = torch.einsum("bkn,bn->bk", Vj, w)
            w = w - torch.einsum("bkn,bk->bn", Vj, h2)
            wnorm_t = torch.linalg.norm(w, dim=1)
            hcol = torch.cat([h1 + h2, wnorm_t[:, None]],
                             dim=1).double().cpu().numpy()
            wsafe = torch.where(wnorm_t > 0, wnorm_t, torch.ones_like(wnorm_t))
            V[:, j + 1] = torch.where(wnorm_t[:, None] > 0, w / wsafe[:, None],
                                      torch.zeros_like(w))
            for c in range(nrhs):
                h = np.zeros(m + 1)
                h[:j + 2] = hcol[c]
                h, denom = _givens(h, cs[c], sn[c], g[c], j)
                # per column: a no-progress rotation (zero RHS column or
                # singular operator) keeps the previous estimate
                if denom > 0:
                    res[c] = abs(g[c, j + 1])
                R[c, :, j] = h
            j += 1
        ym = np.stack([_triangular_coeffs(R[c], g[c], j)
                       for c in range(nrhs)])
        y = y + torch.einsum("bkn,bk->bn", V[:, :j],
                             torch.as_tensor(ym, dtype=b.dtype,
                                             device=b.device))
        iters += j
        cycles += 1
        if np.all(res <= target):
            rnorm = res
        else:
            r = r0 - a_tilde(y)
            rnorm = torch.linalg.norm(r, dim=1).double().cpu().numpy()
    x = x0 + M(y)
    return GmresResult(x=x, residual_norm=rnorm, iterations=iters,
                       converged=rnorm <= target)
