"""Matrix-free element kernels for CG1 tetrahedra, laid out structure-of-arrays.

The momentum stiffness action replaces UFL-form assembly + PETSc MatAIJ
(reference MomentumEquation.py:1008-1011): for each element,

    gather u -> strain (Voigt 6) -> sigma = CT @ eps -> nodal forces -> scatter

Layout notes:

* Arrays shaped (E, 3) / (E, 6, 6) would turn the einsums into E batched
  micro-matmuls.  The hot path therefore runs **structure-of-arrays**: every
  small tensor index is unrolled in Python and each component is a flat
  (E,) vector, so XLA fuses the whole element kernel into elementwise code.
* Assembly uses a **cumsum scatter** instead of a scatter-add:
  contributions are gathered once into destination-sorted order (static
  permutation), prefix-summed, and each node's sum read off as a
  difference of two boundary rows - one gather + one dense scan, with a
  deterministic summation order (no atomics).  The f32 prefix sum carries
  ~3e-6 relative rounding noise at cavern scale.
* ``prep()`` transposes CT to (6, 6, E) once per linear solve so the Krylov
  loop never touches strided (E, 6, 6) slices.

Energy bookkeeping: with tensorial Voigt storage,
sigma : eps(v) = sigma_v . diag(1,1,1,2,2,2) . eps_v, handled implicitly by
contracting the full symmetric tensors.

The heat kernel provides the P1 mass/stiffness actions for the implicit heat
step (reference HeatEquation.py:343-356) using exact closed-form tet
integrals: consistent mass M_ab = V (1 + delta_ab) / 20, stiffness
K_ab = k V grad_Na . grad_Nb, facet (Robin) mass  A (1 + delta_ab) / 12.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..utils import tensor_to_voigt, voigt_to_tensor

# Voigt index -> tensor (i, j), tensorial convention [xx,yy,zz,xy,xz,yz]
_V2T = ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))


def _device_tet_geometry(points, conn):
    """grad_N (E,4,3) f64 + volumes (E,) f64 derived IN-TRACE from the
    small points/conn constants, replicating mesh/grid._tet_geometry's
    term order exactly (bitwise-identical results on the CPU backend).

    Rationale: inlining the precomputed (4,3,E) f64 gradient array as a
    jit closure constant puts ~4.6 MB of dense literal text into the
    lowered module PER CALL SITE (and into every serialized executable of
    the persistent compile cache).  Deriving geometry in-trace from points
    (130 KB) + conn keeps the modules small; XLA CSE merges the repeated
    derivations and loop-invariant code motion keeps them out of the
    Krylov/fixed-point loop bodies.
    """
    p = jnp.asarray(points)[conn]                    # (E, 4, 3)
    e1 = p[:, 1] - p[:, 0]
    e2 = p[:, 2] - p[:, 0]
    e3 = p[:, 3] - p[:, 0]
    c1 = jnp.cross(e2, e3)
    c2 = jnp.cross(e3, e1)
    c3 = jnp.cross(e1, e2)
    ec = e1 * c1
    det = (ec[:, 0] + ec[:, 1]) + ec[:, 2]           # numpy pairwise order
    vol = jnp.abs(det) / 6.0
    inv_det = 1.0 / det
    g1 = c1 * inv_det[:, None]
    g2 = c2 * inv_det[:, None]
    g3 = c3 * inv_det[:, None]
    g0 = -(g1 + g2 + g3)
    grad_N = jnp.stack([g0, g1, g2, g3], axis=1)     # (E, 4, 3)
    return grad_N, vol


class MomentumKernel:
    """Vector CG1 elasticity operator pieces for one mesh."""

    def __init__(self, grid):
        # Geometry stays HOST-resident (numpy): these arrays are captured by
        # jitted solve closures, and captured *device* arrays would force a
        # device-to-host fetch per constant at lowering time.
        self.grid = grid
        self.points = np.asarray(grid.points)                     # (N, 3)
        self.conn = np.asarray(grid.conn, dtype=np.int32)         # (E, 4)
        self.grad_N = np.asarray(grid.grad_N)                     # (E, 4, 3)
        self.vol = np.asarray(grid.volumes)                       # (E,)
        # SoA geometry with the element axis last;
        # these host copies serve EAGER consumers (preconditioner builds,
        # assembled-operator plans) - traced code paths derive geometry
        # in-trace via _geom()/_device_geom() to keep lowered modules small
        # (see _device_tet_geometry)
        self._gN_s = np.moveaxis(np.asarray(grid.grad_N), 0, -1)  # (4, 3, E)
        self._gN_s32 = self._gN_s.astype(np.float32)
        self.vol32 = self.vol.astype(np.float32)
        self.n_nodes = grid.n_nodes
        self.n_elems = grid.n_elems
        # Voigt <-> tensor mixing tensors for stacked (…, E) contractions
        t2v = np.zeros((6, 3, 3))
        v2t = np.zeros((3, 3, 6))
        for p, (i, j) in enumerate(_V2T):
            if i == j:
                t2v[p, i, j] = 1.0
            else:
                t2v[p, i, j] = t2v[p, j, i] = 0.5  # symmetric average
            v2t[i, j, p] = v2t[j, i, p] = 1.0
        self._t2v = t2v
        self._v2t = v2t

        # static cumsum-scatter plan: (e, a) contributions sorted by
        # destination node; per-node sums are boundary differences of the
        # prefix sum.  Contribution k in sorted order is (elem, a) =
        # (perm[k] % E, perm[k] // E) for the a-major (4, E) flat layout.
        flat = np.asarray(grid.conn).T.reshape(-1)                # a-major
        perm = np.argsort(flat, kind="stable")
        flat_sorted = flat[perm]
        starts = np.searchsorted(flat_sorted, np.arange(grid.n_nodes))
        ends = np.searchsorted(flat_sorted, np.arange(grid.n_nodes),
                               side="right")
        self._scat_perm = np.asarray(perm, dtype=np.int32)
        self._scat_starts = np.asarray(starts, dtype=np.int32)
        self._scat_ends = np.asarray(ends, dtype=np.int32)
        self.blockell = None      # optional assembled block-ELL backend
        self.dia = None           # optional assembled block-DIA backend

    def enable_dia(self, max_offsets: int = 96, min_fill: float = 0.4):
        """Switch the Krylov stiffness action (BOTH precisions) to the
        assembled block-DIA operator (fem/dia.py): one on-device assembly
        per linearized solve (scatter-free strided adds on recognised
        box lattices), then every matvec is a zero-gather
        shift-multiply-accumulate streaming the offset value planes.
        Raises ValueError when the node numbering is not offset-structured
        (keep the cumsum kernel there); structured GridBox numberings
        qualify with 15 offsets at ~97% fill."""
        from .dia import BlockDIA
        self.dia = BlockDIA(self, max_offsets=max_offsets,
                            min_fill=min_fill)
        return self.dia

    def enable_blockell(self, G: int = 8):
        """Switch the Krylov stiffness action (BOTH precisions) to the
        assembled block-ELL operator (fem/blockell.py): one on-device
        assembly per linearized solve, then every matvec is a single
        batched dense matmul + one (Gn*K)-row gather instead of the
        element formulation.  Works with any node
        ordering; band ordering keeps K (neighbour groups) small."""
        from .blockell import BlockELL
        bell = BlockELL(self, G=G)
        # a poorly ordered mesh inflates K (neighbour groups per group) and
        # with it the dense (3G, K*3G, Gn) block tensor - refuse early
        # rather than silently exhaust device memory during the per-solve
        # assemble
        budget = 4 << 30   # 4 GiB of f64 blocks is already unreasonable
        if bell.plan.nbytes(8) > budget:
            raise ValueError(
                f"block-ELL plan needs {bell.plan.nbytes(8) / 2**30:.1f} GiB "
                f"(K={bell.plan.K} neighbour groups at G={G}); the mesh is "
                f"not locality-ordered - rebuild the grid with "
                f"reorder='band' (or 'morton') before enable_blockell")
        self.blockell = bell
        return self.blockell

    def _device_geom(self):
        """(grad_N (E,4,3), vol (E,)) f64, derived in-trace (see
        _device_tet_geometry for why this replaces the host constants on
        every traced path)."""
        return _device_tet_geometry(self.points, self.conn)

    def _geom(self, dtype):
        gN, vol = self._device_geom()
        gN_s = jnp.moveaxis(gN, 0, -1)                            # (4, 3, E)
        if dtype == jnp.float32:
            return gN_s.astype(jnp.float32), vol.astype(jnp.float32)
        return gN_s, vol

    # -- stacked-SoA building blocks (all shapes (..., E)) --------------- #
    def _gather_u(self, u):
        """u at element nodes, stacked (4, 3, E)."""
        return jnp.transpose(u[self.conn], (1, 2, 0))

    def _strain_stacked(self, ue_s, gN):
        """Voigt strain (6, E) from stacked element displacements."""
        grad = (ue_s[:, :, None, :] * gN[:, None, :, :]).sum(0)   # (3,3,E)
        eps = 0.5 * (grad + jnp.swapaxes(grad, 0, 1))
        t2v = self._t2v.astype(ue_s.dtype)
        return (t2v[:, :, :, None] * eps[None]).sum((1, 2))       # (6,E)

    def _forces_stacked(self, sv_s, gN, vol):
        """Element nodal forces (4, 3, E) from Voigt stress (6, E)."""
        v2t = self._v2t.astype(sv_s.dtype)
        sig = (v2t[:, :, :, None] * sv_s[None, None]).sum(2)      # (3,3,E)
        return (sig[None] * gN[:, None, :, :]).sum(2) * vol       # (4,3,E)

    def _scatter(self, fe_s):
        """Assemble nodal forces from stacked (4, 3, E) contributions.

        Cumsum scatter: one gather into destination-sorted order + a prefix
        sum + boundary differences (see module docstring)."""
        flat = jnp.transpose(fe_s, (0, 2, 1)).reshape(-1, 3)      # a-major
        fs = flat[self._scat_perm]
        cs = jnp.cumsum(fs, axis=0)
        cs = jnp.concatenate([jnp.zeros((1, 3), dtype=fs.dtype), cs], axis=0)
        return cs[self._scat_ends] - cs[self._scat_starts]

    # ------------------------------------------------------------------ #
    def prep(self, CT: jnp.ndarray):
        """Transpose CT (E,6,6) to contiguous (6,6,E), once per linear solve
        (Krylov iterations then run pure elementwise code).  Idempotent."""
        if CT.shape == (6, 6, self.n_elems):
            return CT
        return jnp.transpose(CT, (1, 2, 0))

    @staticmethod
    def apply66(M_soa, v):
        """(E,6) result of the batched 6x6 apply M @ v with M in (6,6,E)
        stacked layout and v in (E,6) — the elementwise replacement for
        einsum('nij,nj->ni', M, v), which XLA would lower to E tiny
        matmuls."""
        return (M_soa * v.T[None]).sum(1).T

    def strain(self, u: jnp.ndarray) -> jnp.ndarray:
        """Total strain eps(u) projected to DG0, Voigt (E, 6).

        Exact for P1 displacements (the gradient is element-constant), which
        is what the reference's project(epsilon(u), DG0) computes
        (MomentumEquation.py:326-341).
        """
        gN, _ = self._geom(u.dtype)
        return self._strain_stacked(self._gather_u(u), gN).T

    def internal_force(self, sigma_v: jnp.ndarray) -> jnp.ndarray:
        """Nodal forces f_ai = int sigma : eps(v_ai) = V sigma_ij dNa/dx_j."""
        gN, vol = self._geom(sigma_v.dtype)
        return self._scatter(self._forces_stacked(sigma_v.T, gN, vol))

    def matvec(self, CT_soa, u: jnp.ndarray) -> jnp.ndarray:
        """Stiffness action A(CT) @ u, no boundary conditions.

        ``CT_soa`` must come from :meth:`prep` ((6,6,E)); raw (E,6,6) arrays
        are accepted (and transposed on the fly) for API compatibility.
        """
        if CT_soa.shape != (6, 6, self.n_elems):
            CT_soa = self.prep(CT_soa)
        gN, vol = self._geom(u.dtype)
        ev = self._strain_stacked(self._gather_u(u), gN)          # (6,E)
        sv = (CT_soa * ev[None]).sum(1)                           # (6,E)
        return self._scatter(self._forces_stacked(sv, gN, vol))

    def diagonal(self, CT: jnp.ndarray) -> jnp.ndarray:
        """diag(A) as an (n_nodes, 3) array (Jacobi preconditioner)."""
        g = self.grad_N                                           # (E, 4, 3)
        E3 = jnp.eye(3, dtype=g.dtype)
        # unit-displacement strain basis eps6[e, a, i, :] for node a, dir i
        gi = g[:, :, None, :]                                     # (E,4,1,3)
        ei = E3[None, None, :, :]                                 # (1,1,3,3)
        xx = ei[..., 0] * gi[..., 0]
        yy = ei[..., 1] * gi[..., 1]
        zz = ei[..., 2] * gi[..., 2]
        xy = 0.5 * (ei[..., 0] * gi[..., 1] + ei[..., 1] * gi[..., 0])
        xz = 0.5 * (ei[..., 0] * gi[..., 2] + ei[..., 2] * gi[..., 0])
        yz = 0.5 * (ei[..., 1] * gi[..., 2] + ei[..., 2] * gi[..., 1])
        eps6 = jnp.stack([xx, yy, zz, xy, xz, yz], axis=-1)       # (E,4,3,6)
        sig6 = jnp.einsum("ekl,eail->eaik", CT, eps6)
        w = jnp.asarray([1., 1., 1., 2., 2., 2.])
        d_e = jnp.einsum("eaik,eaik,k,e->eai", sig6, eps6, w, self.vol)
        return jax.ops.segment_sum(d_e.reshape(-1, 3),
                                   self.conn.reshape(-1),
                                   num_segments=self.n_nodes)

    def block_diagonal(self, CT: jnp.ndarray) -> jnp.ndarray:
        """Nodal 3x3 diagonal blocks of A (block-Jacobi preconditioner).

        Roughly halves Krylov iteration counts vs scalar Jacobi on
        elasticity; stands in for the reference's PETSc ASM/ILU setup
        (examples/mechanics/4_cavern/main.py:33-37)."""
        g = self.grad_N
        E3 = jnp.eye(3, dtype=g.dtype)
        gi = g[:, :, None, :]
        ei = E3[None, None, :, :]
        xx = ei[..., 0] * gi[..., 0]
        yy = ei[..., 1] * gi[..., 1]
        zz = ei[..., 2] * gi[..., 2]
        xy = 0.5 * (ei[..., 0] * gi[..., 1] + ei[..., 1] * gi[..., 0])
        xz = 0.5 * (ei[..., 0] * gi[..., 2] + ei[..., 2] * gi[..., 0])
        yz = 0.5 * (ei[..., 1] * gi[..., 2] + ei[..., 2] * gi[..., 1])
        eps6 = jnp.stack([xx, yy, zz, xy, xz, yz], axis=-1)       # (E,4,3,6)
        sig6 = jnp.einsum("ekl,eajl->eajk", CT, eps6)
        w = jnp.asarray([1., 1., 1., 2., 2., 2.])
        blk = jnp.einsum("eajk,eaik,k,e->eaij", sig6, eps6, w, self.vol)
        return jax.ops.segment_sum(blk.reshape(-1, 3, 3),
                                   self.conn.reshape(-1),
                                   num_segments=self.n_nodes)

    def body_force(self, density: jnp.ndarray, g_vec) -> jnp.ndarray:
        """int rho g . v dx  with DG0 rho, P1 v: V rho g / 4 to each node
        (reference MomentumEquation.py:255-275)."""
        g_vec = jnp.asarray(g_vec, dtype=jnp.float64)
        f_e = (density * self.vol / 4.0)[:, None] * g_vec[None, :]  # (E, 3)
        f = jnp.repeat(f_e[:, None, :], 4, axis=1).reshape(-1, 3)
        return jax.ops.segment_sum(f, self.conn.reshape(-1),
                                   num_segments=self.n_nodes)


class HeatKernel:
    """Scalar P1 heat operator pieces."""

    def __init__(self, grid):
        # host geometry for eager consumers; traced paths derive in-trace
        # (same module-size rationale as MomentumKernel / see
        # _device_tet_geometry)
        self.grid = grid
        self.points = np.asarray(grid.points)
        self.conn = np.asarray(grid.conn, dtype=np.int32)
        self.grad_N = np.asarray(grid.grad_N)
        self.vol = np.asarray(grid.volumes)
        self.grad_N32 = self.grad_N.astype(np.float32)
        self.vol32 = self.vol.astype(np.float32)
        self.n_nodes = grid.n_nodes
        self.n_elems = grid.n_elems
        # consistent P1 tet mass: V (1 + delta_ab) / 20
        self._mass_local = (np.ones((4, 4)) + np.eye(4)) / 20.0

    def _geom(self, dtype):
        gN, vol = _device_tet_geometry(self.points, self.conn)
        if dtype == jnp.float32:
            return gN.astype(jnp.float32), vol.astype(jnp.float32)
        return gN, vol

    def mass_apply(self, coef: jnp.ndarray, T: jnp.ndarray) -> jnp.ndarray:
        """(coef * T, v) with DG0 coef, P1 T and v."""
        _, vol = self._geom(T.dtype)
        T_e = T[self.conn]                                        # (E, 4)
        m = jnp.einsum("ab,eb,e->ea", self._mass_local.astype(T.dtype),
                       T_e, coef.astype(T.dtype) * vol)
        return jax.ops.segment_sum(m.reshape(-1), self.conn.reshape(-1),
                                   num_segments=self.n_nodes)

    def stiffness_apply(self, k: jnp.ndarray, T: jnp.ndarray) -> jnp.ndarray:
        """(k grad T, grad v) with DG0 conductivity."""
        grad_N, vol = self._geom(T.dtype)
        T_e = T[self.conn]
        gT = jnp.einsum("ea,eai->ei", T_e, grad_N)                # (E, 3)
        f = jnp.einsum("ei,eai,e->ea", gT, grad_N,
                       k.astype(T.dtype) * vol)
        return jax.ops.segment_sum(f.reshape(-1), self.conn.reshape(-1),
                                   num_segments=self.n_nodes)

    def mass_diagonal(self, coef: jnp.ndarray) -> jnp.ndarray:
        _, vol = self._geom(coef.dtype)
        d = (coef * vol)[:, None] * jnp.full((1, 4), 2.0 / 20.0)
        return jax.ops.segment_sum(d.reshape(-1), self.conn.reshape(-1),
                                   num_segments=self.n_nodes)

    def stiffness_diagonal(self, k: jnp.ndarray) -> jnp.ndarray:
        gN, vol = self._geom(k.dtype)
        d = jnp.einsum("eai,eai,e->ea", gN, gN, k * vol)
        return jax.ops.segment_sum(d.reshape(-1), self.conn.reshape(-1),
                                   num_segments=self.n_nodes)

    def nodes_to_elems(self, T: jnp.ndarray) -> jnp.ndarray:
        """DG0 projection of a P1 field = vertex average
        (reference HeatEquation.py:286-301)."""
        return T[self.conn].mean(axis=1)
