"""Restarted GMRES with right preconditioning (PyTorch, host loops).

Counterpart of rigidmultiblobswall_tpu/ops/gmres.py: `gmres`,
`gmres_lockstep` and the Krylov recycling of GCRO-style deflation
(`RecycleState`, `refresh_recycle`, `gmres_deflated`,
`harvest_recycle`). Right preconditioning solves A M(y) = b and returns
x = M(y), so convergence is judged on the true residual.

The Arnoldi vectors live on the device of b; the small Hessenberg
algebra (Givens rotations, the triangular solve) runs on the host in
float64. That costs one device-to-host sync per iteration, to read the
new Hessenberg column (with the deflated solve's projections onto C in
the same read): a known cost of this first port (PERF.md). The
recycling's small SVDs run in float64 whatever the Krylov dtype.

Every value the host reads to take a decision goes through
parallel/mesh.host: under a mesh of several ranks (inside
mesh.replicated) it is rank 0's, so every rank iterates alike.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..parallel.mesh import host, host_float


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
    target = max(tol * host_float(torch.linalg.norm(b)), atol)

    def a_tilde(y):
        return matvec(M(y))

    # skip the A*0 product on a cold start (one pair sweep at scale)
    r0 = b if cold_start else b - matvec(x0)
    y = torch.zeros_like(b)
    r, rnorm = r0, host_float(torch.linalg.norm(r0))
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
            hcol = host(torch.cat([h1 + h2, wnorm_t[None]]))
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
            rnorm = host_float(torch.linalg.norm(r))
    x = x0 + M(y)
    return GmresResult(x=x, residual_norm=rnorm, iterations=iters,
                       converged=rnorm <= target)


def gmres_lockstep(matvec: Callable, b: torch.Tensor, *,
                   x0: Optional[torch.Tensor] = None, tol: float = 1e-8,
                   atol: float = 0.0, restart: int = 60, maxiter: int = 1000,
                   M: Optional[Callable] = None, recycle=None,
                   collect_basis: bool = False):
    """Solve matvec(X) = b for a stack b (nrhs, n): one Arnoldi process
    per right-hand side, all advanced by ONE operator call per iteration,
    so the pair sweep is shared across the stack. Runs until every column
    meets its own target; converged columns keep iterating harmlessly.
    `iterations` counts the batched sweeps.

    recycle: a RecycleState used as a warm start, y0 = (C r0) U per
    column; every cycle then ends on the true residual (C was refreshed
    once per step and the estimate cannot see its drift), and a solve
    the warm start finished recomputes it once. collect_basis also
    returns column 0's last cycle (V, raw Hessenberg, its length) for
    `harvest_recycle`."""
    nrhs, n = b.shape
    M = M or _identity
    cold_start = x0 is None
    if cold_start:
        x0 = torch.zeros_like(b)
    m = int(min(restart, n, maxiter))
    max_cycles = max(1, -(-maxiter // m))
    b_norm = host(torch.linalg.norm(b, dim=1))
    target = np.maximum(tol * b_norm, atol)

    def a_tilde(Y):
        return matvec(M(Y))

    r0 = b if cold_start else b - matvec(x0)
    y = torch.zeros_like(b)
    r = r0
    if recycle is not None and recycle.valid:
        alpha0 = r0 @ recycle.C.T
        y = alpha0 @ recycle.U
        r = r0 - alpha0 @ recycle.C
    rnorm = host(torch.linalg.norm(r, dim=1))
    iters = cycles = 0
    basis = (None, np.zeros((m + 1, m)), 0)
    while cycles < max_cycles and np.any(rnorm > target):
        V = torch.zeros((nrhs, m + 1, n), dtype=b.dtype, device=b.device)
        safe = torch.as_tensor(np.where(rnorm > 0, rnorm, 1.0),
                               dtype=b.dtype, device=b.device)
        V[:, 0] = r / safe[:, None]
        R = np.zeros((nrhs, m + 1, m))
        # column 0's raw (pre-Givens) Hessenberg, for harvest_recycle
        Hraw0 = np.zeros((m + 1, m))
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
            hcol = host(torch.cat([h1 + h2, wnorm_t[:, None]], dim=1))
            wsafe = torch.where(wnorm_t > 0, wnorm_t, torch.ones_like(wnorm_t))
            V[:, j + 1] = torch.where(wnorm_t[:, None] > 0, w / wsafe[:, None],
                                      torch.zeros_like(w))
            Hraw0[:j + 2, j] = hcol[0]
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
        basis = (V[0], Hraw0, j)
        if recycle is None and np.all(res <= target):
            rnorm = res
        else:
            r = r0 - a_tilde(y)
            rnorm = host(torch.linalg.norm(r, dim=1))
    if recycle is not None and iters == 0:
        # the warm start did all the work: its projected residual cannot
        # see the recycle drift, so take the true one
        rnorm = host(torch.linalg.norm(r0 - a_tilde(y), dim=1))
    x = x0 + M(y)
    result = GmresResult(x=x, residual_norm=rnorm, iterations=iters,
                         converged=rnorm <= target)
    return (result, basis) if collect_basis else result


# ---------------------------------------------------------------------------
# Krylov subspace recycling (GCRO-style deflation across solves and steps)
# ---------------------------------------------------------------------------


class RecycleState(NamedTuple):
    """Recycled deflation subspace, carried across the solves of a step
    and across steps.

    U: (k, n) directions in the right-preconditioned y-space;
    C: (k, n) orthonormal rows with A~ U ~= C (refreshed once per step by
       one batched k-column sweep, `refresh_recycle`);
    valid: False until the first harvest (solves then run undeflated)."""

    U: torch.Tensor
    C: torch.Tensor
    valid: bool

    @staticmethod
    def empty(k, n, dtype=torch.float32, device=None):
        z = torch.zeros((k, n), dtype=dtype, device=device)
        return RecycleState(U=z, C=z.clone(), valid=False)


def refresh_recycle(a_tilde_multi: Callable, rec: RecycleState
                    ) -> RecycleState:
    """Re-biorthonormalize the recycle pair at a (drifted) operator: with
    A~ U^T = W S Vh, keep the directions with S > 1e-4 S[0], C = W^T and
    U' = S^-1 Vh U (so A~ U' = C), and zero the deficient slots (a zero
    row is inert in every deflation formula). One batched operator
    application, a_tilde_multi (k, n) -> (k, n). An invalid state is
    returned as it is, without the sweep (its refresh changes nothing).

    The SVD of the tall (n, k) product is a QR in float64 followed by the
    float64 SVD of its (k, k) factor."""
    if not rec.valid:
        return rec
    AU = a_tilde_multi(rec.U)
    Q, Rq = torch.linalg.qr(AU.T.double())
    Wr, S, Vh = torch.linalg.svd(Rq)
    s = host(S)
    keep = s > 1e-4 * max(s[0], 1e-30)
    if not keep.any():
        return rec._replace(valid=False)
    keep_t = torch.as_tensor(keep, device=Q.device)
    sinv = torch.where(keep_t, 1.0 / torch.where(keep_t, S, 1.0), 0.0)
    C = ((Q @ Wr) * keep_t[None, :]).T
    Unew = ((sinv[:, None] * Vh) @ rec.U.double()) * keep_t[:, None]
    return RecycleState(U=Unew.to(rec.U.dtype), C=C.to(rec.C.dtype),
                        valid=True)


def _deflate_setup(rec: RecycleState, r0):
    """Initial GCRO projection: y0 = alpha0 U, r = r0 - alpha0 C with
    alpha0 = C r0 (both zero for an invalid state)."""
    if not rec.valid:
        return torch.zeros_like(r0), r0
    alpha0 = rec.C @ r0
    return alpha0 @ rec.U, r0 - alpha0 @ rec.C


def gmres_deflated(matvec: Callable, b: torch.Tensor, rec: RecycleState, *,
                   x0: Optional[torch.Tensor] = None, tol: float = 1e-8,
                   atol: float = 0.0, restart: int = 60, maxiter: int = 1000,
                   M: Optional[Callable] = None, collect_basis: bool = False,
                   harvest_k: int = 0):
    """Right-preconditioned GMRES with GCRO deflation through `rec`;
    returns (GmresResult, RecycleState or None).

    The operator is deflated by projecting C out ((I - C C^T) A~), the
    solution is corrected through U, and every cycle ends on the
    explicitly recomputed true residual (C drifts with the operator, and
    the Givens estimate cannot see it); those sweeps are not counted in
    `iterations`, as in the JAX package. With collect_basis the new
    RecycleState is harvested from the old U and the last cycle's Krylov
    basis (harvest_recycle, harvest_k or k directions)."""
    n = b.shape[0]
    M = M or _identity
    cold_start = x0 is None
    if cold_start:
        x0 = torch.zeros_like(b)
    k = rec.U.shape[0]
    m = int(min(restart, n, maxiter))
    max_cycles = max(1, -(-maxiter // m))
    target = max(tol * host_float(torch.linalg.norm(b)), atol)
    C = rec.C if rec.valid else None

    def a_tilde(y):
        return matvec(M(y))

    r0 = b if cold_start else b - matvec(x0)
    y, r = _deflate_setup(rec, r0)
    rnorm = host_float(torch.linalg.norm(r))
    iters = cycles = 0
    basis = (None, np.zeros((m + 1, m)), np.zeros((m, k)), 0)
    while cycles < max_cycles and rnorm > target:
        V = torch.zeros((m + 1, n), dtype=b.dtype, device=b.device)
        V[0] = r / (rnorm if rnorm > 0 else 1.0)
        R = np.zeros((m + 1, m))
        Hraw = np.zeros((m + 1, m))
        Bp = np.zeros((m, k))
        cs, sn = np.zeros(m), np.zeros(m)
        g = np.zeros(m + 1)
        g[0] = rnorm
        res, j = rnorm, 0
        while j < m and res > target:
            w = a_tilde(V[j])
            if C is not None:
                cc = C @ w
                w = w - cc @ C
            Vj = V[:j + 1]
            h1 = Vj @ w
            w = w - Vj.T @ h1
            h2 = Vj @ w
            w = w - Vj.T @ h2
            wnorm_t = torch.linalg.norm(w)
            parts = [h1 + h2, wnorm_t[None]]
            if C is not None:
                parts.append(cc)
            # one read: the Hessenberg column and the projections onto C
            hcol = host(torch.cat(parts))
            if hcol[j + 1] > 0:
                V[j + 1] = w / wnorm_t
            if C is not None:
                Bp[j] = hcol[j + 2:]
            h = np.zeros(m + 1)
            h[:j + 2] = hcol[:j + 2]
            Hraw[:, j] = h
            h, denom = _givens(h, cs, sn, g, j)
            if denom > 0:
                res = abs(g[j + 1])
            R[:, j] = h
            j += 1
        ym = _triangular_coeffs(R, g, j)
        ym_t = torch.as_tensor(ym, dtype=b.dtype, device=b.device)
        y = y + V[:j].T @ ym_t
        if C is not None:
            # GCRO correction: remove the C-components the inner solution
            # pushed back in, through U
            y = y - torch.as_tensor(Bp[:j].T @ ym, dtype=b.dtype,
                                    device=b.device) @ rec.U
        iters += j
        cycles += 1
        basis = (V, Hraw, Bp, j)
        r = r0 - a_tilde(y)
        rnorm = host_float(torch.linalg.norm(r))
    if iters == 0 and rec.valid:
        # the deflation did all the work: the projected residual cannot
        # see the operator's drift, so take the true one once
        rnorm = host_float(torch.linalg.norm(r0 - a_tilde(y)))
    x = x0 + M(y)
    result = GmresResult(x=x, residual_norm=rnorm, iterations=iters,
                         converged=rnorm <= target)
    if not collect_basis:
        return result, None
    V, Hraw, Bp, j_used = basis
    return result, harvest_recycle(rec, V, Hraw, Bp, j_used,
                                   harvest_k or k)


def harvest_recycle(rec: RecycleState, V, Hraw, Bp, j_used, k
                    ) -> RecycleState:
    """New recycle directions from the union of the old U and the last
    Krylov cycle: with Q = [V_{m+1}, C^T] orthonormal,
      A~ [U, V_m] = Q G,  G = [[0, Hraw], [I_k, Bp^T]],
    so the smallest right-singular directions of G span the slowest modes
    seen so far. V (m+1, n) on the device (None when no cycle ran), Hraw
    (m+1, m) and Bp (m, k_old) host arrays. Unused Krylov columns, and
    the U block of an invalid state, get a large diagonal (BIG) so the
    SVD never selects them; directions whose singular value reaches the
    BIG scale are zeroed. G's SVD runs in float64. C stays as it is until
    the next refresh_recycle."""
    m = Hraw.shape[1]
    kold = rec.U.shape[0]
    used = np.arange(m) < j_used
    BIG = 1e8
    # U slots take part only when valid and non-degenerate (zero rows of
    # a partial harvest must not come back as fake smallest directions)
    u_live = (rec.valid
              & (host(torch.linalg.norm(rec.U, dim=1)) > 1e-20))
    G = np.zeros((m + 1 + kold, kold + m))
    G[m + 1:, :kold] = np.diag(np.where(u_live, 1.0, BIG))
    G[:m + 1, kold:] = np.where(used[None, :], Hraw, 0.0)
    G[m + 1:, kold:] = np.where(used[:, None], Bp, 0.0).T
    # each unused Krylov column gets BIG on its own row (row j for column
    # kold + j), apart from the used columns' rows and the U rows
    G[np.arange(m), kold + np.arange(m)] += BIG * (~used)
    _, svals, Vt = torch.linalg.svd(torch.from_numpy(G), full_matrices=False)
    Z = Vt[-k:] * (svals[-k:] < 0.5 * BIG)[:, None]
    Z = Z.to(dtype=rec.U.dtype, device=rec.U.device)
    Unew = Z[:, :kold] @ rec.U
    if V is not None:
        Unew = Unew + Z[:, kold:] @ V[:m]
    return RecycleState(U=Unew, C=rec.C, valid=True)
