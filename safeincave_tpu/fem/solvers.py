"""Jitted matrix-free Krylov solvers (CG and BiCGStab) with Jacobi
preconditioning, plus a mixed-precision iterative-refinement driver.

Replaces PETSc KSP (reference Simulators.py:1075-1086; examples use
cg/bicg/bcgs + ASM/ILU at rtol=1e-12, max_it=100-200).  The operator is a
closure performing the masked stiffness action; the whole iteration runs in a
``lax.while_loop`` on device, so one linear solve is a single XLA program with
no host round-trips.

Convergence: relative residual ||r|| <= rtol * ||b|| (+ atol), like KSP's
default left-preconditioned residual test but on the true residual.

Mixed precision: an f64 Krylov iteration moves twice the bytes of an f32
one and runs at half the vector rate on the GPU.  :func:`ir_solve`
therefore runs the Krylov iterations in **float32** and wraps them in a
**float64 defect-correction (iterative refinement) loop**: each outer pass
computes the true f64 residual r = b - A x, solves A d = r / ||r|| in f32 to
a loose tolerance, and updates x += ||r|| d in f64.  The final residual test
is the same f64 criterion as the straight-f64 path, so accuracy is preserved
while nearly all FLOPs run in f32.  The restart-per-pass
structure also doubles as BiCGStab breakdown recovery.
"""
from __future__ import annotations

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp


def _vdot(a, b):
    return jnp.vdot(a.reshape(-1), b.reshape(-1))


def cg_solve(A: Callable, b, x0, M_inv, rtol=1e-12, atol=0.0, maxiter=200):
    """Preconditioned conjugate gradients for SPD operators.

    Parameters
    ----------
    A : callable(x) -> Ax
    M_inv : callable(r) -> preconditioned residual (e.g. Jacobi)

    Returns (x, iterations, final_residual_norm).
    """
    b_norm = jnp.sqrt(_vdot(b, b))
    tol2 = jnp.maximum(rtol * b_norm, atol) ** 2

    r0 = b - A(x0)
    z0 = M_inv(r0)
    p0 = z0
    rz0 = _vdot(r0, z0)

    def cond(carry):
        x, r, z, p, rz, k = carry
        rr = _vdot(r, r)
        return (rr > tol2) & (k < maxiter) & jnp.isfinite(rr)

    def body(carry):
        x, r, z, p, rz, k = carry
        Ap = A(p)
        pAp = _vdot(p, Ap)
        alpha = rz / jnp.where(pAp != 0, pAp, 1.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M_inv(r)
        rz_new = _vdot(r, z)
        beta = rz_new / jnp.where(rz != 0, rz, 1.0)
        p = z + beta * p
        return x, r, z, p, rz_new, k + 1

    x, r, _, _, _, k = jax.lax.while_loop(cond, body,
                                          (x0, r0, z0, p0, rz0, 0))
    return x, k, jnp.sqrt(_vdot(r, r))


def bicgstab_solve(A: Callable, b, x0, M_inv, rtol=1e-12, atol=0.0,
                   maxiter=200):
    """Preconditioned BiCGStab for (mildly) non-symmetric operators.

    Needed because the consistent tangent CT with Desai/Munson-Dawson ISV
    coupling is non-symmetric (rank-one H term), which is why the reference
    examples run PETSc bicg/bcgs rather than cg.

    Breakdown (rho or omega collapsing relative to the residual scale) stops
    the iteration instead of silently looping on garbage; the caller
    (:func:`ir_solve` or the nonlinear loop) restarts from the true residual,
    which is the standard BiCGStab restart cure.
    """
    b_norm = jnp.sqrt(_vdot(b, b))
    tol2 = jnp.maximum(rtol * b_norm, atol) ** 2
    eps = jnp.finfo(b.dtype).eps

    r0 = b - A(x0)
    rhat = r0

    def cond(carry):
        x, r, p, v, rho, alpha, omega, k, broke = carry
        rr = _vdot(r, r)
        return (rr > tol2) & (k < maxiter) & (~broke) & jnp.isfinite(rr)

    def body(carry):
        x, r, p, v, rho, alpha, omega, k, broke = carry
        rr = _vdot(r, r)
        rho_new = _vdot(rhat, r)
        broke = jnp.abs(rho_new) < eps * eps * rr
        beta = (rho_new / jnp.where(rho != 0, rho, 1.0)) * \
               (alpha / jnp.where(omega != 0, omega, 1.0))
        p = r + beta * (p - omega * v)
        phat = M_inv(p)
        v = A(phat)
        denom = _vdot(rhat, v)
        alpha = rho_new / jnp.where(denom != 0, denom, 1.0)
        s = r - alpha * v
        shat = M_inv(s)
        t = A(shat)
        tt = _vdot(t, t)
        broke = broke | (tt == 0)
        omega = _vdot(t, s) / jnp.where(tt != 0, tt, 1.0)
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        return x, r, p, v, rho_new, alpha, omega, k + 1, broke

    init = (x0, r0, jnp.zeros_like(b), jnp.zeros_like(b),
            jnp.asarray(1.0, b.dtype), jnp.asarray(1.0, b.dtype),
            jnp.asarray(1.0, b.dtype), 0, jnp.asarray(False))
    x, r, *_, k, _ = jax.lax.while_loop(cond, body, init)
    return x, k, jnp.sqrt(_vdot(r, r))


def ir_solve(A_hi: Callable, A_lo: Callable, b, x0, M_inv_lo,
             inner_solve: Callable = bicgstab_solve,
             rtol=1e-12, atol=0.0, inner_rtol=3e-5, inner_maxiter=300,
             max_passes=12):
    """Mixed-precision defect correction: f32 Krylov under f64 refinement.

    Each pass solves ``A_lo d = r / ||r||`` in the low precision (so the
    inner right-hand side is always O(1), well inside f32 range), then
    applies ``x += ||r|| d`` and recomputes the **true f64 residual**.
    Converges when ``||r|| <= max(rtol ||b||, atol)`` -- the identical
    criterion a straight f64 Krylov solve uses -- or when a pass stops
    making progress (stagnation guard: each pass must at least halve the
    residual; f32 roundoff limits a pass to ~1e-6 reduction anyway, so
    stagnation means the preconditioned operator is too ill-conditioned
    for f32 and the caller sees the honest final residual).

    Returns (x, total_inner_iterations, final_f64_residual_norm).
    """
    lo = jnp.float32
    b_norm = jnp.sqrt(_vdot(b, b))
    tol = jnp.maximum(rtol * b_norm, atol)

    r0 = b - A_hi(x0)
    rnorm0 = jnp.sqrt(_vdot(r0, r0))

    def cond(carry):
        x, r, rnorm, rnorm_prev, k_tot, passes = carry
        return ((rnorm > tol) & (passes < max_passes)
                & (rnorm < 0.5 * rnorm_prev) & jnp.isfinite(rnorm))

    def body(carry):
        x, r, rnorm, rnorm_prev, k_tot, passes = carry
        scale = jnp.where(rnorm > 0, rnorm, 1.0)
        rhs = (r / scale).astype(lo)
        d, k, _ = inner_solve(A_lo, rhs, jnp.zeros_like(rhs), M_inv_lo,
                              rtol=inner_rtol, maxiter=inner_maxiter)
        # accept the pass only if it actually REDUCED the true residual: a
        # broken-down or diverged inner solve can return finite garbage, and
        # keeping it would hand the caller a corrupted iterate (the
        # stagnation guard would then exit with x far worse than x0)
        d_ok = jnp.isfinite(_vdot(d, d))
        x_try = jnp.where(d_ok, x + scale * d.astype(b.dtype), x)
        r_try = b - A_hi(x_try)
        rn_try = jnp.sqrt(_vdot(r_try, r_try))
        improved = jnp.isfinite(rn_try) & (rn_try < rnorm)
        x = jnp.where(improved, x_try, x)
        r = jnp.where(improved, r_try, r)
        rn = jnp.where(improved, rn_try, rnorm)
        return x, r, rn, rnorm, k_tot + k, passes + 1

    # rnorm_prev starts at +inf so the first pass always runs
    init = (x0, r0, rnorm0, jnp.asarray(jnp.inf, b.dtype), 0, 0)
    x, r, rnorm, _, k_tot, _ = jax.lax.while_loop(cond, body, init)
    return x, k_tot, rnorm
