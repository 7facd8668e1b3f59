"""Custom batched dense linear algebra for the f64 constitutive math.

The reference inverts (N,6,6) tangents with torch ``linalg.inv``
(/root/reference/safeincave/MaterialProps.py:292-309) and takes 3x3
eigenvalues with ``eigvalsh`` (:1872-1885).  These replacements are fully
vectorized elementwise code with the reference's singularity semantics,
and compile on any backend:

* :func:`inv6x6` - batched Gauss-Jordan with partial pivoting + singularity
  mask (used for consistent tangents; the mask drives the reference's
  elastic-fallback semantics).
* :func:`eigvalsh3x3` - analytic trigonometric eigenvalues of symmetric 3x3
  batches (ascending order), deterministic and much faster than an iterative
  eigensolver.
"""
from __future__ import annotations

from . import jax_setup  # noqa: F401
import jax.numpy as jnp


def inv6x6(M: jnp.ndarray, pivot_tol: float = 1e-30):
    """Invert a batch of 6x6 matrices by Gauss-Jordan with partial pivoting.

    Parameters
    ----------
    M : (..., 6, 6) array
    pivot_tol : float
        A matrix is flagged singular when any pivot magnitude falls below
        ``pivot_tol * max|M|`` for that batch entry.

    Returns
    -------
    inv : (..., 6, 6) array
        Inverse where ``ok``; garbage (but finite-ish) elsewhere.
    ok : (...,) bool array
        False where the matrix was detected singular/non-finite.
    """
    n = 6
    batch_shape = M.shape[:-2]

    # normalize to O(1), so pivots and products stay far from the
    # exponent limits of either precision
    raw_scale = jnp.max(jnp.abs(M), axis=(-2, -1))
    ok = jnp.isfinite(raw_scale) & (raw_scale > 0)
    norm = jnp.where(raw_scale > 0, raw_scale, 1.0)
    M = M / norm[..., None, None]

    eye = jnp.broadcast_to(jnp.eye(n, dtype=M.dtype), M.shape)
    aug = jnp.concatenate([M, eye], axis=-1)  # (..., 6, 12)
    scale = jnp.ones_like(raw_scale)
    rows = jnp.arange(n)

    for k in range(n):
        col = aug[..., :, k]
        # only rows >= k are pivot candidates
        cand = jnp.where(rows >= k, jnp.abs(col), -1.0)
        p = jnp.argmax(cand, axis=-1)  # (...,)
        # swap rows k and p: row index k reads from p, row index p reads from k
        p_exp = p[..., None]
        perm = jnp.broadcast_to(rows, batch_shape + (n,))
        perm = jnp.where(rows == k, p_exp, jnp.where(perm == p_exp, k, perm))
        aug = jnp.take_along_axis(aug, perm[..., None], axis=-2)

        piv = aug[..., k, k]
        ok = ok & (jnp.abs(piv) > pivot_tol * scale) & jnp.isfinite(piv)
        piv_safe = jnp.where(jnp.abs(piv) > 0, piv, 1.0)
        pivot_row = aug[..., k, :] / piv_safe[..., None]
        factors = aug[..., :, k]
        elim = aug - factors[..., None] * pivot_row[..., None, :]
        aug = jnp.where((rows == k)[..., None], pivot_row[..., None, :], elim)

    return aug[..., :, n:] / norm[..., None, None], ok


def inv6x6_fast(M: jnp.ndarray, pivot_tol: float = 1e-30):
    """Batched 6x6 inverse in stacked (6, 6, E) layout, unpivoted.

    The hot-path variant of :func:`inv6x6` for the consistent-tangent
    compliance ``C_inv + dt(1-theta) G``: after per-element normalization
    these matrices are O(1), symmetric-positive-definite-ish with positive
    diagonals, so diagonal (unpivoted) Gauss-Jordan is stable - and the
    elimination runs as ~40 full-lane VPU ops on (6, 12, E) arrays instead
    of per-element micro-ops + take_along_axis row-swap gathers.  Any
    element whose running pivot degenerates is flagged ``ok=False`` and the
    caller applies the reference's elastic fallback
    (MaterialProps.py:293-309), which also covers would-need-pivoting cases.

    Parameters / returns match :func:`inv6x6` ((E, 6, 6) in/out).
    """
    n = 6
    Mt = jnp.transpose(M, (1, 2, 0))                      # (6, 6, E)
    raw = jnp.max(jnp.abs(Mt), axis=(0, 1))               # (E,)
    ok = jnp.isfinite(raw) & (raw > 0)
    norm = jnp.where(raw > 0, raw, 1.0)
    Mt = Mt / norm
    eye = jnp.broadcast_to(jnp.eye(n, dtype=M.dtype)[:, :, None],
                           (n, n, Mt.shape[-1]))
    aug = jnp.concatenate([Mt, eye], axis=1)              # (6, 12, E)
    for k in range(n):
        piv = aug[k, k]
        ok = ok & (jnp.abs(piv) > pivot_tol) & jnp.isfinite(piv)
        row_k = aug[k] / jnp.where(jnp.abs(piv) > 0, piv, 1.0)  # (12, E)
        factors = aug[:, k]                               # (6, E)
        aug = aug - factors[:, None, :] * row_k[None, :, :]
        aug = aug.at[k].set(row_k)
    inv = jnp.transpose(aug[:, n:, :], (2, 0, 1)) / norm[:, None, None]
    return inv, ok


def solve6x6(M: jnp.ndarray, b: jnp.ndarray):
    """Solve batched 6x6 systems via :func:`inv6x6` (convenience)."""
    inv, ok = inv6x6(M)
    return jnp.einsum("...ij,...j->...i", inv, b), ok


def inv3x3(M: jnp.ndarray) -> jnp.ndarray:
    """Closed-form (adjugate) inverse of batched 3x3 matrices.

    The input is normalized by its max magnitude first: raw adjugate
    determinants of stiffness-scale blocks (entries ~1e15) would overflow
    float32 (the f32 fixed-point phase calls this too).  After
    normalization all intermediates are O(1).
    """
    s = jnp.max(jnp.abs(M), axis=(-2, -1), keepdims=True)
    s = jnp.where(s > 0, s, 1.0)
    M = M / s
    a = M[..., 0, 0]; b = M[..., 0, 1]; c = M[..., 0, 2]
    d = M[..., 1, 0]; e = M[..., 1, 1]; f = M[..., 1, 2]
    g = M[..., 2, 0]; h = M[..., 2, 1]; i = M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv_det = 1.0 / jnp.where(det != 0, det, 1.0)
    row0 = jnp.stack([A, -(b * i - c * h), b * f - c * e], axis=-1)
    row1 = jnp.stack([B, a * i - c * g, -(a * f - c * d)], axis=-1)
    row2 = jnp.stack([C, -(a * h - b * g), a * e - b * d], axis=-1)
    inv = jnp.stack([row0, row1, row2], axis=-2) * inv_det[..., None, None]
    return inv / s


def eigvalsh3x3(A: jnp.ndarray) -> jnp.ndarray:
    """Analytic eigenvalues of batched symmetric 3x3 matrices, ascending.

    Trigonometric (Cardano) method; replaces torch ``eigvalsh`` used by the
    Matsuoka-Nakai model (reference MaterialProps.py:1872-1885).
    """
    a00 = A[..., 0, 0]
    a11 = A[..., 1, 1]
    a22 = A[..., 2, 2]
    a01 = A[..., 0, 1]
    a02 = A[..., 0, 2]
    a12 = A[..., 1, 2]

    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = b00 ** 2 + b11 ** 2 + b22 ** 2 + 2.0 * (a01 ** 2 + a02 ** 2 + a12 ** 2)
    p = jnp.sqrt(jnp.maximum(p2 / 6.0, 0.0))
    p_safe = jnp.where(p > 0, p, 1.0)

    # det(B) / 2 with B = (A - q I) / p
    detB = (b00 * (b11 * b22 - a12 ** 2)
            - a01 * (a01 * b22 - a12 * a02)
            + a02 * (a01 * a12 - b11 * a02))
    r = detB / (2.0 * p_safe ** 3)
    r = jnp.clip(r, -1.0, 1.0)

    phi = jnp.arccos(r) / 3.0
    e_max = q + 2.0 * p * jnp.cos(phi)
    e_min = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)
    e_mid = 3.0 * q - e_max - e_min

    isotropic = p2 <= 1e-300
    e_max = jnp.where(isotropic, q, e_max)
    e_mid = jnp.where(isotropic, q, e_mid)
    e_min = jnp.where(isotropic, q, e_min)
    return jnp.stack([e_min, e_mid, e_max], axis=-1)
