"""Assembled block-DIA (offset) stiffness operator: the zero-gather SpMV.

Replaces: PETSc MatAIJ assembly + MatMult in the reference
(/root/reference/safeincave/MomentumEquation.py:1008-1025) for meshes
whose node numbering is (quasi-)structured.

Why this format exists next to block-ELL (fem/blockell.py):

* Every general sparse layout pays an unstructured gather for the
  neighbour values of ``u``.
* On a structured (lexicographic) node numbering the column offsets
  ``j - i`` of ALL node pairs collapse to a handful of distinct values
  (15 for the GridBox Kuhn tet split, independent of resolution, at 97%
  slot fill at 500k tets).  Storing one value plane per offset turns the
  matvec into

      y[c, i] = sum_d sum_c' vals[d, 3c+c', i] * u[c', i + off_d]

  — shifts are STATIC slices of a zero-padded ``u``; there is no gather,
  no scatter, no index traffic at all.  The matvec streams ``9 |D|``
  value planes once, as one XLA-fused elementwise multiply-accumulate.
* Assembly: when the connectivity is recognisably cell-structured
  (:class:`StructuredPlan`, e.g. any natural-order GridBox) the element
  block rows land as 96 STATIC strided slice-adds — cells of one
  (tet-type, local-a, local-b) combo all write the same offset plane at
  a constant lattice shift, so assembly is scatter-free and runs at
  memory rate.  Otherwise one row-granular scatter-add keyed by
  (offset index, node) is used (correct everywhere, slower at scale).

``DIAPlan`` refuses meshes whose ordering is not offset-structured (too
many distinct offsets or low slot fill) so callers fall back to the
cumsum kernel — real gmsh cavern meshes stay on it; regular-box
production grids (SURVEY.md 6: the reference's 1e5-1e6-tet PETSc MPI
regime) get this one.

Padding contract: ``u`` is zero-padded by the extreme offsets on both
sides; slots for pairs that do not exist hold exact zeros from assembly,
so out-of-range shifted reads multiply against zero coefficients.  The
assembled value planes are stored node-axis-last: shape ``(Dn*9, N)``,
row ``d*9 + 3c + c2``.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from .blockell import element_block_rows, element_block_comp_rows


class DIAPlan:
    """Static offset tables for one mesh (host numpy, built once)."""

    def __init__(self, conn: np.ndarray, n_nodes: int,
                 max_offsets: int = 96, min_fill: float = 0.4):
        conn = np.asarray(conn, dtype=np.int64)
        E = conn.shape[0]
        self.n_nodes = n_nodes
        self.n_elems = E

        # contribution row r in (ab)-major layout: r = (4a + b) * E + e
        rows = np.arange(16 * E)
        a_r = (rows // E) // 4
        b_r = (rows // E) % 4
        e_r = rows % E
        i_r = conn[e_r, a_r]
        j_r = conn[e_r, b_r]
        d_r = j_r - i_r

        offsets = np.unique(d_r)
        n_pairs = len(np.unique(i_r * (2 * n_nodes + 1) + d_r))
        fill = n_pairs / (len(offsets) * n_nodes)
        if len(offsets) > max_offsets or fill < min_fill:
            raise ValueError(
                f"node numbering is not offset-structured: {len(offsets)} "
                f"distinct column offsets at {fill:.2f} slot fill (need "
                f"<= {max_offsets} at >= {min_fill}); keep the cumsum "
                f"kernel for this mesh")
        self.offsets = offsets.astype(np.int64)          # sorted
        self.Dn = len(offsets)
        self.fill = fill
        self.n_pairs = n_pairs
        d_idx = np.searchsorted(offsets, d_r)
        self.row_slot = (d_idx * n_nodes + i_r).astype(np.int32)  # (16E,)

    def nbytes(self, itemsize=8):
        return self.Dn * 9 * self.n_nodes * itemsize


class StructuredPlan:
    """(tet-type, a, b) -> (offset plane, lattice shift) table.

    Inferred from the connectivity alone: holds exactly when the mesh is
    a natural-order cell-major box split into a fixed per-cell tet
    pattern sharing one base corner (the GridBox Kuhn split,
    mesh/boxgen.py:18-26).  Every (t, a, b) combo then contributes to ONE
    offset plane at ONE constant (di, dj, dk) lattice shift, making
    assembly 16*T static strided slice-adds with no scatter.
    """

    def __init__(self, conn: np.ndarray, n_nodes: int,
                 offsets: np.ndarray):
        conn = np.asarray(conn, dtype=np.int64)
        E = conn.shape[0]
        if E % 6 != 0:
            raise ValueError("not a 6-tets-per-cell mesh")
        H = E // 6
        base = conn[0::6, 0]                      # cell base corner ids
        # per (t, a): node = base + delta[t, a] for ALL cells, else refuse
        delta = np.empty((6, 4), dtype=np.int64)
        for t in range(6):
            for a in range(4):
                d = conn[t::6, a] - base
                if d.min() != d.max():
                    raise ValueError("cell-node shifts are not constant")
                delta[t, a] = d[0]
        # recover lattice dims from the base-id run structure
        steps = np.diff(base)
        if H > 1 and steps.min() < 1:
            raise ValueError("cells are not lexicographic")
        nz = int(np.argmax(steps != 1)) + 1 if (steps != 1).any() else H
        if H % nz:
            raise ValueError("cells are not lexicographic")
        rem = H // nz
        # try the factorizations of the remaining H / nz = nx * ny
        ok = None
        for ny in range(1, rem + 1):
            if rem % ny:
                continue
            nx = rem // ny
            sy = nz + 1
            sx = (ny + 1) * (nz + 1)
            I, J, K = np.meshgrid(np.arange(nx), np.arange(ny),
                                  np.arange(nz), indexing="ij")
            expect = (I.ravel() * (ny + 1) + J.ravel()) * (nz + 1) + K.ravel()
            if np.array_equal(base, expect):
                ok = (nx, ny, nz, sx, sy)
                break
        if ok is None:
            raise ValueError("cell bases do not form a box lattice")
        self.nx, self.ny, self.nz, sx, sy = ok
        if n_nodes != (self.nx + 1) * (self.ny + 1) * (self.nz + 1):
            raise ValueError("node count does not match the lattice")
        # decode per-(t,a) corner shifts (di, dj, dk) in {0, 1}
        corner = np.empty((6, 4, 3), dtype=np.int64)
        for t in range(6):
            for a in range(4):
                d = delta[t, a]
                di, r = divmod(d, sx)
                dj, dk = divmod(r, sy)
                if not (0 <= di <= 1 and 0 <= dj <= 1 and 0 <= dk <= 1):
                    raise ValueError("cell shift is not a unit corner")
                corner[t, a] = (di, dj, dk)
        # (t, a, b) -> (d_idx, target corner of a)
        off_list = offsets.tolist()
        self.table = []
        for t in range(6):
            for a in range(4):
                for b in range(4):
                    d = int(delta[t, b] - delta[t, a])
                    self.table.append((t, a, b, off_list.index(d),
                                       tuple(int(x) for x in corner[t, a])))


class BlockDIA:
    """Device-side assembled offset operator for one mesh.

    ``assemble`` produces the node-axis-last value planes ``(Dn*9, N)``;
    ``matvec`` applies them as static-sliced shift copies + one fused
    multiply-accumulate, in whatever float dtype the planes carry.
    """

    def __init__(self, kern, max_offsets: int = 96, min_fill: float = 0.4):
        self.plan = DIAPlan(np.asarray(kern.grid.conn), kern.n_nodes,
                            max_offsets=max_offsets, min_fill=min_fill)
        p = self.plan
        # host-resident (numpy): captured by jitted closures, where device
        # arrays would force a d2h fetch at lowering (fem/kernels.py note)
        self._row_slot = np.asarray(p.row_slot)              # (16E,)
        # SoA geometry: gradient components (4, 3, E) and volumes (E,)
        self._gn = np.moveaxis(np.asarray(kern.grid.grad_N), 0, -1)
        self._vol = np.asarray(kern.grid.volumes)
        self._lo = int(-p.offsets.min())                     # left pad
        self._hi = int(p.offsets.max())                      # right pad
        try:
            self._sp = StructuredPlan(np.asarray(kern.grid.conn),
                                      kern.n_nodes, p.offsets)
        except ValueError:
            self._sp = None

    # ------------------------------------------------------------------ #
    @property
    def structured(self):
        """True when the scatter-free strided assembly is active.

        Structured meshes assemble cheaply enough in f32 that the
        mixed-precision solver assembles ONLY the f32 operator from f32
        element math and keeps the exact-f64 action matrix-free (one f64
        matvec per refinement pass instead of an f64 assembly per
        linearized solve).
        """
        return self._sp is not None

    def assemble(self, CT_soa):
        """CT (6,6,E) -> offset planes (Dn*9, N), dtype of CT.

        Structured meshes: 96 static strided slice-adds (scatter-free,
        memory rate).  General offset-structured meshes: one row-granular
        scatter-add keyed by (offset, node).  One assembly serves all
        Krylov matvecs of the linearized solve in both precisions (the
        f32 operator is a cast of this output).
        """
        p = self.plan
        if self._sp is not None:
            v = element_block_comp_rows(CT_soa, self._gn,
                                        self._vol)           # (144, E)
            planes = self._assemble_structured(v)            # (Dn*9, N)
        else:
            v = element_block_rows(CT_soa, self._gn,
                                   self._vol)                # (16E, 9)
            flat = jnp.zeros((p.Dn * p.n_nodes, 9), dtype=v.dtype)
            flat = flat.at[self._row_slot].add(v)
            flat = flat.reshape(p.Dn, p.n_nodes, 9)
            planes = jnp.transpose(flat, (0, 2, 1))          # (Dn, 9, N)
            planes = planes.reshape(p.Dn * 9, p.n_nodes)
        return planes

    def _assemble_structured(self, v):
        """Scatter-free assembly: spread + static shift-adds.

        Every array keeps the big (cell/node) axis as the minor
        dimension — chained .at[].add scatters and any (..., 9)-minor
        layout multiply the device-memory footprint at 500k tets.

        1. restack (144, E) t-major -> (864, H), cells lane-minor
        2. "spread" cell-flat -> node-flat: insert the zero cell planes
           at i=nx / j=ny / k=nz with three pad+reshape steps, after
           which padded-cell m and its base node share one flat index
        3. each (t, a, b) combo adds its 9 comp rows into offset plane
           d(t,a,b) at the constant flat shift delta(t,a) — a static
           lane slice, no index traffic
        """
        sp, p = self._sp, self.plan
        nx, ny, nz = sp.nx, sp.ny, sp.nz
        N = p.n_nodes
        sy, sx = nz + 1, (ny + 1) * (nz + 1)
        E = v.shape[1]
        V = jnp.concatenate(
            [jax.lax.slice(v, (0, t), (144, E), (1, 6))
             for t in range(6)], axis=0)                     # (864, H)
        V = V.reshape(864 * nx * ny, nz)
        V = jnp.pad(V, ((0, 0), (0, 1)))
        V = V.reshape(864 * nx, ny * (nz + 1))
        V = jnp.pad(V, ((0, 0), (0, nz + 1)))
        V = V.reshape(864, nx * (ny + 1) * (nz + 1))
        V = jnp.pad(V, ((0, 0), (0, sx)))                    # (864, N)
        dmax = sx + sy + 1
        Vp = jnp.pad(V, ((0, 0), (dmax, 0)))
        planes = [None] * p.Dn
        for (t, a, b, d_idx, (di, dj, dk)) in sp.table:
            delta = di * sx + dj * sy + dk
            r0 = t * 144 + (4 * a + b) * 9
            sl = jax.lax.slice(Vp, (r0, dmax - delta),
                               (r0 + 9, dmax - delta + N))
            planes[d_idx] = sl if planes[d_idx] is None \
                else planes[d_idx] + sl
        return jnp.concatenate(planes, axis=0)               # (Dn*9, N)

    # ------------------------------------------------------------------ #
    def _shift_stack(self, u):
        """(N, 3) -> (Dn*3, N): one shifted copy of uT per offset."""
        p = self.plan
        up = jnp.pad(u.T, ((0, 0), (self._lo, self._hi)))
        return jnp.concatenate(
            [jax.lax.dynamic_slice_in_dim(up, self._lo + int(off),
                                          p.n_nodes, 1)
             for off in p.offsets])

    def matvec(self, vals, u):
        """Stiffness action A @ u: pure shift-multiply-accumulate.

        ``vals`` from :meth:`assemble` (any float dtype, possibly cast);
        ``u`` (N, 3).  No gather: each offset term reads a static slice
        of the zero-padded ``u``, and XLA fuses the whole sum into one
        elementwise kernel.
        """
        p = self.plan
        ush = self._shift_stack(u.astype(vals.dtype))        # (Dn*3, N)
        acc = [None, None, None]
        for di in range(p.Dn):
            for c in range(3):
                for c2 in range(3):
                    term = vals[di * 9 + 3 * c + c2] * ush[di * 3 + c2]
                    acc[c] = term if acc[c] is None else acc[c] + term
        return jnp.stack(acc, axis=-1)                       # (N, 3)
