"""Assembled block-ELL stiffness operator: a gather-once SpMV.

Replaces: PETSc MatAIJ assembly + MatMult in the reference
(/root/reference/safeincave/MomentumEquation.py:1008-1025).

Why assembled, and why this layout:

* A matrix-free matvec gathers and scatters 4E element rows on every
  Krylov iteration.  The assembled form does the gather work ONCE per
  linearized solve (assembly) and makes every Krylov iteration a dense
  streaming op.
* Nodes are grouped into blocks of ``G`` (default 8) consecutive
  band-ordered nodes.  Group ``g`` couples to the ``K`` groups that share
  an element with it: the operator is a dense (3G, K*3G, Gn) tensor
  ``B`` with the GROUP index last (Gn is hundreds-to-thousands, the long
  contiguous axis of every elementwise op), and

      y[i, g] = sum_c B[i, c, g] * U[c, g]

  with ``U`` the gathered neighbour values - a broadcast-multiply-reduce
  that streams ``B`` once, plus one (Gn*K)-row gather of u groups.  The
  elementwise form (no einsum/dot) is memory-bound in BOTH precisions.
* Assembly stays on device and elementwise: per-element 12x12 stiffness
  contributions are computed SoA over (E,)-lane vectors exploiting the
  3-nonzero sparsity of the P1 strain basis (~650 full-lane FMAs), then
  permuted into destination-pair-sorted order (one static-permutation
  gather), reduced by the cumsum-scatter trick, and window-scattered
  (one (3,3) patch per distinct node pair) into the block tensor.  One
  assembly serves all Krylov matvecs of the linearized solve in both
  precisions (the f32 operator is a cast of the f64 assembly).

Padding contract: group ``Gn`` (one past the last real group) is an
all-zero "ghost" u group, so ELL slots beyond a group's true neighbour
count gather zeros and contribute nothing.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

# tensorial-Voigt nonzero pattern of the P1 strain basis: unit displacement
# of a node in direction i excites Voigt components nz[i] with gradient
# component g[l] and weight c (eps = c * grad_N[l]):   (p, l, c)
_NZ = (
    ((0, 0, 1.0), (3, 1, 0.5), (4, 2, 0.5)),   # i = x -> xx, xy, xz
    ((1, 1, 1.0), (3, 0, 0.5), (5, 2, 0.5)),   # i = y -> yy, xy, yz
    ((2, 2, 1.0), (4, 0, 0.5), (5, 1, 0.5)),   # i = z -> zz, xz, yz
)
_W = (1.0, 1.0, 1.0, 2.0, 2.0, 2.0)            # Voigt contraction weights


def element_block_rows(CT_soa, gn, vol):
    """Per-element 3x3 stiffness blocks k[a,b] as rows (16E, 9).

    Row (4a + b)*E + e holds k_e[a, i, b, j] = V_e sum_p w_p eps[a,i,p]
    sig[b,j,p] at component column 3i + j — fully elementwise on (E,)-lane
    vectors (no dots), exploiting
    the 3-nonzero sparsity of the P1 strain basis.  Shared by every
    assembled-operator backend (block-ELL, block-DIA).
    """
    dt = CT_soa.dtype
    gn = gn.astype(dt)                                   # (4, 3, E)
    vol = vol.astype(dt)
    # sig[b][j][p] = sum_l CT[p, l] * eps[b, j, l]  (3 nonzero l terms)
    sig = [[None] * 3 for _ in range(4)]
    for b in range(4):
        for j in range(3):
            s = None
            for (l_p, l_l, c) in _NZ[j]:
                term = CT_soa[:, l_p] * (c * gn[b, l_l])[None, :]
                s = term if s is None else s + term
            sig[b][j] = s                                # (6, E)
    vrows = []
    for a in range(4):
        for b in range(4):
            comps = []
            for i in range(3):
                for j in range(3):
                    s = None
                    for (l_p, l_l, c) in _NZ[i]:
                        term = ((_W[l_p] * c) * gn[a, l_l]
                                * sig[b][j][l_p])
                        s = term if s is None else s + term
                    comps.append(s * vol)                # (E,)
            vrows.append(jnp.stack(comps, axis=-1))      # (E, 9)
    return jnp.concatenate(vrows, axis=0)                # (16E, 9)


def element_block_comp_rows(CT_soa, gn, vol):
    """Per-element 3x3 stiffness blocks as comp-major rows (144, E).

    Row (4a + b) * 9 + (3i + j) holds the same k_e[a, i, b, j] values as
    :func:`element_block_rows`, but with the ELEMENT axis as the minor
    dimension, so no array has a 9-wide minor dimension.  Used by the
    structured block-DIA assembly.
    """
    dt = CT_soa.dtype
    gn = gn.astype(dt)                                   # (4, 3, E)
    vol = vol.astype(dt)
    sig = [[None] * 3 for _ in range(4)]
    for b in range(4):
        for j in range(3):
            s = None
            for (l_p, l_l, c) in _NZ[j]:
                term = CT_soa[:, l_p] * (c * gn[b, l_l])[None, :]
                s = term if s is None else s + term
            sig[b][j] = s                                # (6, E)
    rows = []
    for a in range(4):
        for b in range(4):
            for i in range(3):
                for j in range(3):
                    s = None
                    for (l_p, l_l, c) in _NZ[i]:
                        term = ((_W[l_p] * c) * gn[a, l_l]
                                * sig[b][j][l_p])
                        s = term if s is None else s + term
                    rows.append(s * vol)                 # (E,)
    return jnp.stack(rows, axis=0)                       # (144, E)


class BlockELLPlan:
    """Static tables for one mesh (host numpy, built once)."""

    def __init__(self, conn: np.ndarray, n_nodes: int, G: int = 8):
        conn = np.asarray(conn, dtype=np.int64)
        E = conn.shape[0]
        self.G = G
        self.n_nodes = n_nodes
        self.n_elems = E
        Gn = -(-n_nodes // G)
        self.Gn = Gn

        # contribution row r in (ab)-major layout: r = (4a + b) * E + e
        rows = np.arange(16 * E)
        a_r = (rows // E) // 4
        b_r = (rows // E) % 4
        e_r = rows % E
        i_r = conn[e_r, a_r]
        j_r = conn[e_r, b_r]

        # group adjacency (ELL slots) from the distinct group pairs
        gi_r, gj_r = i_r // G, j_r // G
        gp_keys = np.unique(gi_r * Gn + gj_r)                # sorted
        gp_g = gp_keys // Gn
        # slot s of pair (g, h): rank of h among g's neighbours
        first = np.searchsorted(gp_g, np.arange(Gn))
        gp_slot = np.arange(len(gp_keys)) - first[gp_g]
        K = int(gp_slot.max()) + 1
        self.K = K
        nbr = np.full((Gn, K), Gn, dtype=np.int32)     # ghost group = Gn
        nbr[gp_g, gp_slot] = gp_keys % Gn
        self.nbr = nbr

        # contribution row -> flat (g, k, li, lj) slot of the scatter
        # layout (Gn, K, G, G, 3, 3); one row-granular scatter-add per
        # contribution row assembles the whole operator
        slot_r = gp_slot[np.searchsorted(gp_keys, gi_r * Gn + gj_r)]
        self.row_slot = (((gi_r * K + slot_r) * G + (i_r % G)) * G
                         + (j_r % G)).astype(np.int32)       # (16E,)
        self.n_slots = Gn * K * G * G
        self.n_pairs = int(len(np.unique(i_r * n_nodes + j_r)))

    def nbytes(self, itemsize=8):
        return self.Gn * self.K * (3 * self.G) ** 2 * itemsize


class BlockELL:
    """Device-side assembled operator for one mesh."""

    def __init__(self, kern, G: int = 8):
        self.plan = BlockELLPlan(np.asarray(kern.grid.conn),
                                 kern.n_nodes, G=G)
        p = self.plan
        # host-resident (numpy): captured by jitted closures, where device
        # arrays would force a d2h fetch at lowering (fem/kernels.py note)
        self._nbr = np.asarray(p.nbr)
        self._row_slot = np.asarray(p.row_slot)              # (16E,)
        # SoA geometry: gradient components (4, 3, E) and volumes (E,)
        self._gn = np.moveaxis(np.asarray(kern.grid.grad_N), 0, -1)
        self._vol = np.asarray(kern.grid.volumes)
        self.Gn, self.K, self.G = p.Gn, p.K, p.G

    # ------------------------------------------------------------------ #
    def assemble(self, CT_soa):
        """CT (6,6,E) -> block tensor (3G, K*3G, Gn), dtype of CT.

        Fully elementwise on (E,) vectors (no dots): ~650 FMAs, one static
        permutation gather (16E rows), a cumsum segment reduction and one
        (3,3)-window scatter per distinct node pair.
        """
        p = self.plan
        dt = CT_soa.dtype
        v = element_block_rows(CT_soa, self._gn, self._vol)  # (16E, 9)
        # row scatter-add into the flat slot layout (the only XLA scatter
        # form that runs at the ~8 ns/row rate), then one transpose into
        # the lanes-last matvec layout
        flat = jnp.zeros((p.n_slots, 9), dtype=dt)
        flat = flat.at[self._row_slot].add(v)
        t = flat.reshape(p.Gn, p.K, p.G, p.G, 3, 3)
        blocks = jnp.transpose(t, (2, 4, 1, 3, 5, 0)).reshape(
            3 * p.G, p.K * 3 * p.G, p.Gn)
        return blocks

    def matvec(self, blocks, u):
        """Stiffness action A @ u: one gather + a broadcast-mul-reduce.

        ``blocks`` from :meth:`assemble` (any float dtype); ``u`` (N, 3).
        """
        p = self.plan
        dt = blocks.dtype
        G3 = 3 * p.G
        pad = p.Gn * p.G - p.n_nodes
        ug = jnp.concatenate(
            [u.astype(dt).reshape(-1),
             jnp.zeros(3 * pad + G3, dtype=dt)]).reshape(p.Gn + 1, G3)
        un = ug[self._nbr]                                   # (Gn, K, 3G)
        U = jnp.transpose(un.reshape(p.Gn, p.K * G3), (1, 0))  # (K3G, Gn)
        y = (blocks * U[None, :, :]).sum(axis=1)             # (3G, Gn)
        return (jnp.transpose(y, (1, 0)).reshape(-1)[:3 * p.n_nodes]
                .reshape(-1, 3))
