"""Grid: tags, regions, boundaries, and fully vectorized geometry precompute.

JAX replacement for the reference grid layer
(/root/reference/safeincave/Grid.py:27-579).  The reference's O(n) Python
loops over cells (volumes :161-170, node-element stencil :172-196, smoother
:198-242) become numpy gather/segment operations computed once at load time;
the scipy CSR smoothing matrices become flat (index, weight) arrays applied
with ``jax.ops.segment_sum`` inside jitted code.
"""
from __future__ import annotations

import os

import numpy as np
import jax
import jax.numpy as jnp

from .msh_io import read_msh, MshData


def _tet_geometry(points: np.ndarray, conn: np.ndarray):
    """Volumes, centroids, and P1 shape-function gradients for all tets.

    grad_N has shape (E, 4, 3): row a is the (constant) gradient of the
    barycentric shape function of local node a.
    """
    p = points[conn]                       # (E, 4, 3)
    e1 = p[:, 1] - p[:, 0]
    e2 = p[:, 2] - p[:, 0]
    e3 = p[:, 3] - p[:, 0]
    # Jacobian J columns are the edge vectors; det = 6 * signed volume
    det = (e1 * np.cross(e2, e3)).sum(axis=1)
    volumes = np.abs(det) / 6.0
    # inverse transpose of J via cross products: rows of J^{-1}
    c1 = np.cross(e2, e3)
    c2 = np.cross(e3, e1)
    c3 = np.cross(e1, e2)
    inv_det = 1.0 / det
    # grad of barycentric coords 1..3 (rows of J^{-1}); grad N_0 = -(sum)
    g1 = c1 * inv_det[:, None]
    g2 = c2 * inv_det[:, None]
    g3 = c3 * inv_det[:, None]
    g0 = -(g1 + g2 + g3)
    grad_N = np.stack([g0, g1, g2, g3], axis=1)
    centroids = p.mean(axis=1)
    return volumes, centroids, grad_N


def _facet_geometry(points, tris, tets, tet_centroids):
    """Areas, outward unit normals, and owner tets for boundary triangles.

    Outward orientation is fixed by the owning tetrahedron (the dolfinx
    FacetNormal the reference relies on for Neumann terms,
    MomentumEquation.py:240-253).
    """
    # match each boundary tri to the tet that contains all 3 of its nodes
    faces = tets[:, [[1, 2, 3], [0, 3, 2], [0, 1, 3], [0, 2, 1]]]  # (E,4,3)
    faces_flat = np.sort(faces.reshape(-1, 3), axis=1)
    order = np.lexsort(faces_flat.T[::-1])
    faces_sorted = faces_flat[order]
    owner_sorted = np.repeat(np.arange(tets.shape[0]), 4)[order]

    tris_sorted_nodes = np.sort(tris, axis=1)
    idx = np.searchsorted(
        faces_sorted.view([('', faces_sorted.dtype)] * 3).ravel(),
        tris_sorted_nodes.view([('', tris_sorted_nodes.dtype)] * 3).ravel())
    idx = np.clip(idx, 0, faces_sorted.shape[0] - 1)
    matched = (faces_sorted[idx] == tris_sorted_nodes).all(axis=1)
    if not matched.all():
        raise ValueError("boundary triangle without owning tetrahedron")
    owners = owner_sorted[idx]

    a = points[tris[:, 0]]
    b = points[tris[:, 1]]
    c = points[tris[:, 2]]
    nvec = 0.5 * np.cross(b - a, c - a)    # area-weighted normal
    areas = np.linalg.norm(nvec, axis=1)
    normals = nvec / areas[:, None]
    face_cent = (a + b + c) / 3.0
    outward = ((face_cent - tet_centroids[owners]) * normals).sum(axis=1)
    normals = np.where(outward[:, None] >= 0, normals, -normals)
    return areas, normals, owners


class Grid:
    """Core mesh container + geometry; built from raw arrays."""

    def __init__(self, points, tets, tet_tags, tris, tri_tags, field_data):
        self.points = np.asarray(points, dtype=np.float64)
        self.conn = np.asarray(tets, dtype=np.int32)
        self.elem_tags = np.asarray(tet_tags, dtype=np.int32)
        self.tris = np.asarray(tris, dtype=np.int32)
        self.tri_tags = np.asarray(tri_tags, dtype=np.int32)

        self.n_nodes = self.points.shape[0]
        self.n_elems = self.conn.shape[0]
        self.domain_dim = 3
        self.boundary_dim = 2
        # locality ordering applied to this grid, if any ("band"/"morton"/
        # "rcb"); equations use it to auto-select the matvec backend
        self.reorder_method: str | None = getattr(self, "reorder_method",
                                                  None)

        # gmsh physical-name table: {dim: {name: tag}}  (reference Grid.py:306-313)
        self.dolfin_tags = {1: {}, 2: {}, 3: {}}
        for name, (tag, dim) in field_data.items():
            if dim in self.dolfin_tags:
                self.dolfin_tags[dim][name] = tag
        self.tags = self.dolfin_tags

        self._build_box_dimensions()
        self._extract_grid_data()
        self._load_boundaries()
        self._build_geometry()
        self._build_smoother()

    # ------------------------------------------------------------------ #
    def _build_box_dimensions(self):
        """Bounding-box extents (reference Grid.py:371-390)."""
        mins = self.points.min(axis=0)
        maxs = self.points.max(axis=0)
        self.Lx, self.Ly, self.Lz = (maxs - mins).tolist()

    def _extract_grid_data(self):
        """Region name -> cell indices (reference Grid.py:496-536)."""
        self.region_names = self.get_subdomain_names()
        self.n_regions = len(self.region_names)
        self.tags_dict = {self.dolfin_tags[3][n]: n for n in self.region_names}
        self.region_indices = {}
        for name in self.region_names:
            tag = self.dolfin_tags[3][name]
            self.region_indices[name] = np.where(self.elem_tags == tag)[0]
        self.subdomain_tags = {name: [] for name in self.region_names}

    def _load_boundaries(self):
        """Boundary name -> facet indices (reference Grid.py:337-368)."""
        self.boundary_tags = {}
        for name in self.get_boundary_names():
            tag = self.dolfin_tags[2][name]
            self.boundary_tags[name] = np.where(self.tri_tags == tag)[0]

    def _build_geometry(self):
        self.volumes, self.centroids, self.grad_N = _tet_geometry(
            self.points, self.conn)
        if self.tris.shape[0]:
            self.tri_areas, self.tri_normals, self.tri_owners = \
                _facet_geometry(self.points, self.tris, self.conn,
                                self.centroids)
        else:
            self.tri_areas = np.zeros(0)
            self.tri_normals = np.zeros((0, 3))
            self.tri_owners = np.zeros(0, dtype=np.int64)

    def _build_smoother(self):
        """Node<->element averaging as (index, weight) arrays.

        Replaces the scipy CSR operators A_csr (volume-weighted cell->node),
        B_csr (uniform node->cell) and smoother = B@A of reference
        Grid.py:198-242 with segment-sum-ready flat arrays.
        """
        flat_nodes = self.conn.reshape(-1).astype(np.int64)      # (4E,)
        flat_elems = np.repeat(np.arange(self.n_elems), 4)
        vol_sum_at_node = np.zeros(self.n_nodes)
        np.add.at(vol_sum_at_node, flat_nodes, self.volumes[flat_elems])
        # host-resident (numpy): captured by jitted closures, where device
        # arrays would force a d2h fetch at lowering (fem/kernels.py note)
        self.smooth_node_idx = flat_nodes
        self.smooth_elem_idx = flat_elems
        self.smooth_weights = self.volumes[flat_elems] / vol_sum_at_node[flat_nodes]

    # ------------------------------------------------------------------ #
    # Smoothing operators (pure JAX, usable inside jit)
    # ------------------------------------------------------------------ #
    def elems_to_nodes(self, q_elems: jnp.ndarray) -> jnp.ndarray:
        """Volume-weighted element->node average (reference A_csr)."""
        vals = self.smooth_weights * q_elems[self.smooth_elem_idx]
        return jax.ops.segment_sum(vals, self.smooth_node_idx,
                                   num_segments=self.n_nodes)

    def nodes_to_elems(self, q_nodes: jnp.ndarray) -> jnp.ndarray:
        """Uniform node->element average (reference B_csr)."""
        return q_nodes[np.asarray(self.conn)].mean(axis=1)

    def smooth_elems(self, q_elems: jnp.ndarray) -> jnp.ndarray:
        """Element smoother = B @ A (reference ``smoother``)."""
        return self.nodes_to_elems(self.elems_to_nodes(q_elems))

    # ------------------------------------------------------------------ #
    # Reference-compatible tag queries (Grid.py:392-494)
    # ------------------------------------------------------------------ #
    def get_boundaries(self):
        return self.tri_tags

    def get_subdomains(self):
        return self.elem_tags

    def get_boundary_names(self):
        return list(self.dolfin_tags[2].keys())

    def get_subdomain_names(self):
        return list(self.dolfin_tags[3].keys())

    def get_boundary_tag(self, name):
        if name is None:
            return None
        return self.dolfin_tags[self.boundary_dim][name]

    def get_boundary_tags(self, name):
        if name is None:
            return None
        return self.boundary_tags[name]

    def get_subdomain_tag(self, name):
        return self.dolfin_tags[self.domain_dim][name]

    def get_parameter(self, param):
        """Scalar / per-region / per-element parameter expansion
        (reference Grid.py:538-579)."""
        if isinstance(param, (int, float)):
            return jnp.full(self.n_elems, float(param), dtype=jnp.float64)
        if isinstance(param, dict):
            # region-keyed dict {region_name: value} (config-layer idiom for
            # heterogeneous per-region parameter blocks)
            out = np.zeros(self.n_elems)
            missing = [r for r in self.region_indices if r not in param]
            if missing:
                raise Exception(f"Parameter dict missing regions: {missing}")
            for region, idx in self.region_indices.items():
                out[idx] = float(param[region])
            return jnp.asarray(out)
        param_arr = np.asarray(param)
        if param_arr.shape[0] == self.n_regions and self.n_regions != self.n_elems:
            out = np.zeros(self.n_elems)
            for i, region in enumerate(self.region_indices.keys()):
                out[self.region_indices[region]] = param_arr[i]
            return jnp.asarray(out)
        elif param_arr.shape[0] == self.n_elems:
            return jnp.asarray(param_arr, dtype=jnp.float64)
        elif param_arr.shape[0] == self.n_regions:
            out = np.zeros(self.n_elems)
            for i, region in enumerate(self.region_indices.keys()):
                out[self.region_indices[region]] = param_arr[i]
            return jnp.asarray(out)
        raise Exception("Size of parameter list does not match neither "
                        "# of elements nor # of regions.")


class GridHandlerGMSH(Grid):
    """Load a gmsh ``.msh`` into a :class:`Grid` (reference Grid.py:27-113).

    ``reorder="morton"`` (or ``"rcb"`` with ``nparts``) renumbers elements
    along a space-filling curve and nodes by first touch before geometry
    build - the locality preprocessing the matrix-free gather/scatter
    kernels want (SURVEY.md 7.3); the reference never needed it because
    PETSc assembles sparse matrices.
    """

    def __init__(self, geometry_name: str, grid_folder: str,
                 reorder: str | None = None, nparts: int | None = None):
        self.grid_folder = grid_folder
        self.geometry_name = geometry_name
        path = os.path.join(grid_folder, f"{geometry_name}.msh")
        data: MshData = read_msh(path)
        points, tets, tet_tags = data.points, data.tets, data.tet_tags
        tris, tri_tags = data.tris, data.tri_tags
        self.elem_parts = None
        self.reorder_method = reorder or None
        if reorder:
            from .reorder import reorder_arrays
            points, tets, tet_tags, tris, tri_tags, parts = reorder_arrays(
                points, tets, tet_tags, tris, tri_tags,
                method=reorder, nparts=nparts)
            self.elem_parts = parts
        super().__init__(points, tets, tet_tags, tris, tri_tags,
                         data.field_data)
