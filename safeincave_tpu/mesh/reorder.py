"""Mesh reordering for memory locality and spatial partitioning.

The reference never needed this (PETSc assembles sparse matrices), but for
matrix-free gather/scatter the element/node ordering controls memory
locality and the quality of contiguous-chunk sharding (SURVEY.md 7.3:
"mesh reordering for locality is a new, load-bearing preprocessing step").

* ``morton``: Z-order curve over element centroids - good cache behavior for
  single-device gathers.
* ``rcb``: recursive coordinate bisection into ``nparts`` spatially compact
  equal-size blocks - contiguous element chunks then map 1:1 onto devices, so
  the sharded assembly's cross-device node overlap is minimized.
* ``band``: RCM node ordering + min-node element sort (:func:`band_order`)
  - small node-graph bandwidth, so element gathers touch nearby nodes and
  contiguous node ids form compact 2-level coarse aggregates.

Nodes are renumbered by first touch in the new element order (``band``
instead dictates the node order directly).
"""
from __future__ import annotations

import numpy as np

from .grid import Grid
from .native import morton_order, node_first_touch, rcb_partition


def band_order(conn: np.ndarray, n_nodes: int):
    """RCM node permutation + min-node element order.

    Returns (node_perm, elem_order) where ``node_perm[new] = old`` and
    ``elem_order[new] = old``.
    """
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    r = np.repeat(conn, conn.shape[1], axis=1).reshape(-1)
    c = np.tile(conn, (1, conn.shape[1])).reshape(-1)
    A = coo_matrix((np.ones_like(r, dtype=np.int8), (r, c)),
                   shape=(n_nodes, n_nodes)).tocsr()
    perm = np.asarray(reverse_cuthill_mckee(A, symmetric_mode=True))
    inv = np.empty(n_nodes, np.int64)
    inv[perm] = np.arange(n_nodes)
    conn_new = inv[conn]
    elem_order = np.argsort(conn_new.min(axis=1), kind="stable")
    return perm, elem_order


def _field_data(grid) -> dict:
    fd = {}
    for dim, names in grid.dolfin_tags.items():
        for name, tag in names.items():
            fd[name] = (tag, dim)
    return fd


def reorder_arrays(points, tets, tet_tags, tris, tri_tags,
                   method: str = "morton", nparts: int | None = None):
    """Reorder raw mesh arrays before Grid construction.

    Returns (points, tets, tet_tags, tris, tri_tags, parts) with elements in
    locality order (Morton / RCB over centroids) and nodes renumbered by
    first touch; ``parts`` is the per-element RCB partition id (None for
    morton).  Used by the grid handlers' ``reorder=`` option so loaded
    meshes get gather/scatter locality by default.
    """
    centroids = points[tets].mean(axis=1)
    if method == "rcb":
        if not nparts or nparts < 1:
            raise ValueError("rcb reordering needs nparts >= 1")
        parts, order = rcb_partition(centroids, nparts)
        parts = parts[order]
    elif method == "morton":
        order = morton_order(centroids)
        parts = None
    elif method == "band":
        node_old, order = band_order(tets, points.shape[0])
        nperm = np.empty(points.shape[0], np.int64)
        nperm[node_old] = np.arange(points.shape[0])   # old -> new
        tets_new = nperm[tets[order]].astype(np.int32)
        points_new = np.empty_like(points)
        points_new[nperm] = points
        tris_new = nperm[tris].astype(np.int32) if tris.shape[0] else tris
        return (points_new, tets_new, tet_tags[order], tris_new, tri_tags,
                None)
    else:
        raise ValueError(f"unknown reorder method {method!r}")

    tets_new = tets[order]
    nperm = node_first_touch(tets_new, points.shape[0])
    points_new = np.empty_like(points)
    points_new[nperm] = points
    tets_new = nperm[tets_new].astype(np.int32)
    tris_new = nperm[tris].astype(np.int32) if tris.shape[0] else tris
    return points_new, tets_new, tet_tags[order], tris_new, tri_tags, parts


def reordered_grid(grid, method: str = "morton", nparts: int | None = None):
    """Return (new_grid, elem_order, node_perm).

    ``elem_order[new_pos] = old_elem_index``;
    ``node_perm[old_node] = new_node``.  Element-wise fields for the new grid
    are obtained as ``field[elem_order]``; nodal fields via
    ``new[node_perm] = old``.
    """
    if method == "rcb":
        if not nparts or nparts < 1:
            raise ValueError("rcb reordering needs nparts >= 1")
        parts, order = rcb_partition(grid.centroids, nparts)
    elif method == "morton":
        order = morton_order(grid.centroids)
        parts = None
    elif method == "band":
        node_old, order = band_order(grid.conn, grid.n_nodes)
        nperm = np.empty(grid.n_nodes, np.int64)
        nperm[node_old] = np.arange(grid.n_nodes)
        conn_new = grid.conn[order]
        tags_new = grid.elem_tags[order]
        parts = None
    else:
        raise ValueError(f"unknown reorder method {method!r}")

    if method != "band":
        conn_new = grid.conn[order]
        tags_new = grid.elem_tags[order]
        nperm = node_first_touch(conn_new, grid.n_nodes)

    points_new = np.empty_like(grid.points)
    points_new[nperm] = grid.points
    conn_new = nperm[conn_new].astype(np.int32)
    tris_new = nperm[grid.tris].astype(np.int32)

    g2 = Grid(points_new, conn_new, tags_new, tris_new, grid.tri_tags,
              _field_data(grid))
    g2.reorder_method = method
    if parts is not None:
        g2.elem_parts = parts[order]
    g2.elem_order = np.asarray(order)
    g2.node_perm = np.asarray(nperm)
    return g2, np.asarray(order), np.asarray(nperm)
