"""RCM band ordering (mesh/reorder.band_order): a valid permutation that
does not widen the node-graph bandwidth."""
import numpy as np

from safeincave_tpu.mesh.boxgen import GridBox
from safeincave_tpu.mesh.reorder import band_order


def _mesh(nx=6):
    g = GridBox(Lx=1.0, Ly=1.0, Lz=1.0, nx=nx, ny=nx, nz=nx)
    return np.asarray(g.conn), g.n_nodes


def test_band_order_is_permutation():
    conn, N = _mesh(4)
    perm, eorder = band_order(conn, N)
    assert sorted(perm) == list(range(N))
    assert sorted(eorder) == list(range(conn.shape[0]))


def test_band_order_reduces_bandwidth():
    conn, N = _mesh(8)
    perm, eorder = band_order(conn, N)
    inv = np.empty(N, np.int64)
    inv[perm] = np.arange(N)
    conn_b = inv[conn]
    bw = max(np.abs(conn_b[:, a] - conn_b[:, b]).max()
             for a in range(4) for b in range(4))
    bw0 = max(np.abs(conn[:, a] - conn[:, b]).max()
              for a in range(4) for b in range(4))
    assert bw <= bw0
