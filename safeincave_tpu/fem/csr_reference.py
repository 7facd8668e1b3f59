"""Host reference for the momentum stiffness action: a scipy CSR matrix.

Independent of :class:`~safeincave_tpu.fem.kernels.MomentumKernel` and of
every device operator (cumsum, block-DIA, block-ELL): element geometry is
recomputed from the node coordinates in float64 numpy, each element's
12x12 stiffness is ``V B^T diag(w) CT B`` with the tensorial Voigt strain
basis ``B`` and energy weights ``w = (1, 1, 1, 2, 2, 2)``, and the blocks
are summed into a (3N, 3N) CSR matrix with DOF ``3 * node + component``.
The tests and ``chip_smoke.py`` compare the device operators against it.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

_W = np.array([1.0, 1.0, 1.0, 2.0, 2.0, 2.0])


def tet_gradients(points, conn):
    """Shape-function gradients (E, 4, 3) and volumes (E,) of P1 tets."""
    p = np.asarray(points, dtype=np.float64)[np.asarray(conn)]   # (E,4,3)
    J = np.stack([p[:, 1] - p[:, 0], p[:, 2] - p[:, 0], p[:, 3] - p[:, 0]],
                 axis=1)                                         # rows e_k
    Jinv = np.linalg.inv(J)                                      # (E,3,3)
    g123 = np.transpose(Jinv, (0, 2, 1))                         # grad N_k
    grad = np.concatenate([-g123.sum(axis=1, keepdims=True), g123], axis=1)
    vol = np.abs(np.linalg.det(J)) / 6.0
    return grad, vol


def strain_basis(grad):
    """B (E, 6, 12): Voigt strain [xx, yy, zz, xy, xz, yz] (tensorial
    shear) of the element displacement vector ordered (node, component)."""
    E = grad.shape[0]
    B = np.zeros((E, 6, 4, 3))
    for a in range(4):
        gx, gy, gz = grad[:, a, 0], grad[:, a, 1], grad[:, a, 2]
        B[:, 0, a, 0] = gx
        B[:, 1, a, 1] = gy
        B[:, 2, a, 2] = gz
        B[:, 3, a, 0] = 0.5 * gy
        B[:, 3, a, 1] = 0.5 * gx
        B[:, 4, a, 0] = 0.5 * gz
        B[:, 4, a, 2] = 0.5 * gx
        B[:, 5, a, 1] = 0.5 * gz
        B[:, 5, a, 2] = 0.5 * gy
    return B.reshape(E, 6, 12)


def stiffness_csr(points, conn, CT):
    """Assembled (3N, 3N) float64 CSR stiffness for per-element Voigt
    tangents ``CT`` of shape (E, 6, 6), without boundary conditions."""
    conn = np.asarray(conn, dtype=np.int64)
    n_nodes = np.asarray(points).shape[0]
    grad, vol = tet_gradients(points, conn)
    B = strain_basis(grad)
    CT = np.asarray(CT, dtype=np.float64)
    Ke = np.einsum("eki,k,ekl,elj,e->eij", B, _W, CT, B, vol,
                   optimize=True)                                # (E,12,12)
    dof = (3 * conn[:, :, None] + np.arange(3)).reshape(-1, 12)  # (E,12)
    rows = np.repeat(dof, 12, axis=1).reshape(-1)
    cols = np.tile(dof, (1, 12)).reshape(-1)
    A = sp.coo_matrix((Ke.reshape(-1), (rows, cols)),
                      shape=(3 * n_nodes, 3 * n_nodes))
    return A.tocsr()


def apply(A, u):
    """``A @ u`` for nodal vectors u of shape (N, 3), in float64."""
    u = np.asarray(u, dtype=np.float64)
    return (A @ u.reshape(-1)).reshape(-1, 3)


def relative_error(y, y_ref):
    """max |y - y_ref| / max |y_ref| (the smoke and tests' metric)."""
    y = np.asarray(y, dtype=np.float64)
    y_ref = np.asarray(y_ref, dtype=np.float64)
    return float(np.abs(y - y_ref).max() / np.abs(y_ref).max())
