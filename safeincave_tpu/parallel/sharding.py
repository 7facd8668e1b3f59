"""SPMD domain decomposition over a JAX device mesh.

JAX replacement for the reference's MPI parallelism (SURVEY.md 2.2;
reference Grid.py:275-283 partitions cells via dolfinx and keeps ghost layers
so constitutive work is communication-free, communicating only at
assembly/solve through PETSc ghost updates).

Here the same structure maps onto XLA collectives:

* **element axis 'e'**: all per-element arrays (connectivity, gradients,
  tangents, stresses, ISV states) are sharded; the constitutive update -
  the FLOP-heavy part - is embarrassingly parallel with zero communication,
  exactly like the reference's redundant ghost-cell computation.
* **nodal fields are replicated**: each device scatter-adds its element
  contributions into a full-size nodal vector and a single ``lax.psum`` over
  the mesh axis replaces PETSc's ``ghostUpdate(ADD, REVERSE)`` +
  ``scatter_forward``.  XLA hands the psum to the collective library
  (NCCL on GPUs), over the cards' interconnect.
* global reductions (CG dot products, convergence norms) are psums, standing
  in for ``comm.allreduce`` (reference Simulators.py:433-436).

Elements are padded with zero-volume cells to a multiple of the device count;
padded cells have zero stress/volume so they contribute nothing to forces,
norms, or rates (every constitutive model guards the zero-stress state).
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..utils import tensor_to_voigt, voigt_to_tensor


def make_device_mesh(n_devices: int | None = None, axis: str = "e") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def _pad_elem_array(arr, n_pad, mode="edge"):
    """Pad the leading (element) axis.

    ``mode='edge'`` replicates the last real element so padded cells carry
    finite, physically plausible data (their volume is zeroed separately, so
    they contribute nothing); ``mode='zero'`` pads with zeros.  Edge padding
    matters: a NaN anywhere in a padded element's constitutive state would
    poison the psum-assembled residual since 0 * NaN = NaN.
    """
    arr = np.asarray(arr)
    if n_pad == 0:
        return arr
    pad_width = [(0, n_pad)] + [(0, 0)] * (arr.ndim - 1)
    if mode == "edge":
        return np.pad(arr, pad_width, mode="edge")
    return np.pad(arr, pad_width, constant_values=0)


class ShardedMomentumKernel:
    """Drop-in replacement for :class:`fem.kernels.MomentumKernel` whose
    actions run under ``shard_map``: local gather/einsum/segment-sum followed
    by ``psum('e')``."""

    def __init__(self, grid, mesh: Mesh, axis: str = "e"):
        self.grid = grid
        self.mesh = mesh
        self.axis = axis
        D = mesh.devices.size
        E = grid.n_elems
        self.n_elems_orig = E
        self.n_pad = (-E) % D
        self.n_elems = E + self.n_pad
        self.n_nodes = grid.n_nodes

        spec_e = NamedSharding(mesh, P(axis))
        # padded cells: conn -> node 0 (gather target irrelevant), grad_N
        # edge-replicated (rows sum to zero => padded strain is exactly 0),
        # volume 0 (no force/diagonal/body contribution)
        self.conn = jax.device_put(
            _pad_elem_array(np.asarray(grid.conn, dtype=np.int32),
                            self.n_pad, mode="zero"), spec_e)
        self.grad_N = jax.device_put(
            _pad_elem_array(grid.grad_N, self.n_pad, mode="edge"), spec_e)
        self.vol = jax.device_put(
            _pad_elem_array(grid.volumes, self.n_pad, mode="zero"), spec_e)
        # f32 geometry for the mixed-precision Krylov path
        self.grad_N32 = self.grad_N.astype(jnp.float32)
        self.vol32 = self.vol.astype(jnp.float32)

        ax = axis
        n_nodes = self.n_nodes

        def _strain_local(u, conn, grad_N):
            u_e = u[conn]
            grad_u = jnp.einsum("eai,eaj->eij", u_e, grad_N)
            eps = 0.5 * (grad_u + jnp.swapaxes(grad_u, -1, -2))
            return tensor_to_voigt(eps)

        def _force_local(sigma_v, conn, grad_N, vol):
            sig = voigt_to_tensor(sigma_v)
            f_e = jnp.einsum("eij,eaj,e->eai", sig, grad_N, vol)
            f = jax.ops.segment_sum(f_e.reshape(-1, 3), conn.reshape(-1),
                                    num_segments=n_nodes)
            return jax.lax.psum(f, ax)

        def _diag_local(CT, conn, grad_N, vol):
            E3 = jnp.eye(3, dtype=grad_N.dtype)
            gi = grad_N[:, :, None, :]
            ei = E3[None, None, :, :]
            xx = ei[..., 0] * gi[..., 0]
            yy = ei[..., 1] * gi[..., 1]
            zz = ei[..., 2] * gi[..., 2]
            xy = 0.5 * (ei[..., 0] * gi[..., 1] + ei[..., 1] * gi[..., 0])
            xz = 0.5 * (ei[..., 0] * gi[..., 2] + ei[..., 2] * gi[..., 0])
            yz = 0.5 * (ei[..., 1] * gi[..., 2] + ei[..., 2] * gi[..., 1])
            eps6 = jnp.stack([xx, yy, zz, xy, xz, yz], axis=-1)
            sig6 = jnp.einsum("ekl,eail->eaik", CT, eps6)
            w = jnp.asarray([1., 1., 1., 2., 2., 2.])
            d_e = jnp.einsum("eaik,eaik,k,e->eai", sig6, eps6, w, vol)
            d = jax.ops.segment_sum(d_e.reshape(-1, 3), conn.reshape(-1),
                                    num_segments=n_nodes)
            return jax.lax.psum(d, ax)

        def _blockdiag_local(CT, conn, grad_N, vol):
            E3 = jnp.eye(3, dtype=grad_N.dtype)
            gi = grad_N[:, :, None, :]
            ei = E3[None, None, :, :]
            xx = ei[..., 0] * gi[..., 0]
            yy = ei[..., 1] * gi[..., 1]
            zz = ei[..., 2] * gi[..., 2]
            xy = 0.5 * (ei[..., 0] * gi[..., 1] + ei[..., 1] * gi[..., 0])
            xz = 0.5 * (ei[..., 0] * gi[..., 2] + ei[..., 2] * gi[..., 0])
            yz = 0.5 * (ei[..., 1] * gi[..., 2] + ei[..., 2] * gi[..., 1])
            eps6 = jnp.stack([xx, yy, zz, xy, xz, yz], axis=-1)
            sig6 = jnp.einsum("ekl,eajl->eajk", CT, eps6)
            w = jnp.asarray([1., 1., 1., 2., 2., 2.])
            blk = jnp.einsum("eajk,eaik,k,e->eaij", sig6, eps6, w, vol)
            d = jax.ops.segment_sum(blk.reshape(-1, 3, 3), conn.reshape(-1),
                                    num_segments=n_nodes)
            return jax.lax.psum(d, ax)

        def _body_local(density, g_vec, conn, vol):
            f_e = (density * vol / 4.0)[:, None] * g_vec[None, :]
            f = jnp.repeat(f_e[:, None, :], 4, axis=1).reshape(-1, 3)
            out = jax.ops.segment_sum(f, conn.reshape(-1),
                                      num_segments=n_nodes)
            return jax.lax.psum(out, ax)

        Pe, Pr = P(ax), P()  # sharded-by-element vs replicated
        self._strain = shard_map(_strain_local, mesh=mesh,
                                 in_specs=(Pr, Pe, Pe), out_specs=Pe)
        self._force = shard_map(_force_local, mesh=mesh,
                                in_specs=(Pe, Pe, Pe, Pe), out_specs=Pr)
        self._diag = shard_map(_diag_local, mesh=mesh,
                               in_specs=(Pe, Pe, Pe, Pe), out_specs=Pr)
        self._blockdiag = shard_map(_blockdiag_local, mesh=mesh,
                                    in_specs=(Pe, Pe, Pe, Pe), out_specs=Pr)
        self._body = shard_map(_body_local, mesh=mesh,
                               in_specs=(Pe, Pr, Pe, Pe), out_specs=Pr)

    # -- MomentumKernel API -------------------------------------------- #
    def prep(self, CT):
        """No SoA prep on the sharded path (psum assembly keeps the
        (E, 6, 6) layout); kept for API compatibility with MomentumKernel."""
        return CT

    @staticmethod
    def apply66(M, v):
        """einsum fallback for the (E,6,6) layout (MomentumKernel.apply66
        counterpart)."""
        return jnp.einsum("nij,nj->ni", M, v)

    def _geom(self, dtype):
        if dtype == jnp.float32:
            return self.grad_N32, self.vol32
        return self.grad_N, self.vol

    def strain(self, u):
        grad_N, _ = self._geom(u.dtype)
        return self._strain(u, self.conn, grad_N)

    def internal_force(self, sigma_v):
        grad_N, vol = self._geom(sigma_v.dtype)
        return self._force(sigma_v, self.conn, grad_N, vol)

    def matvec(self, CT, u):
        return self.internal_force(
            jnp.einsum("eij,ej->ei", CT, self.strain(u)))

    def diagonal(self, CT):
        return self._diag(CT, self.conn, self.grad_N, self.vol)

    def block_diagonal(self, CT):
        return self._blockdiag(CT, self.conn, self.grad_N, self.vol)

    def body_force(self, density, g_vec):
        g_vec = jnp.asarray(g_vec, dtype=jnp.float64)
        return self._body(density, g_vec, self.conn, self.vol)


class ShardedHeatKernel:
    """Element-sharded counterpart of :class:`fem.kernels.HeatKernel`:
    local scalar P1 assembly per shard + ``psum`` over the mesh axis
    (the heat-equation analog of the reference's PETSc ghost updates,
    HeatEquation.py:354-361).  Nodal temperature stays replicated; the DG0
    projection (``nodes_to_elems``, the TM coupling path,
    HeatEquation.py:286-301) returns an element-sharded array that feeds the
    momentum equation's sharded constitutive update directly."""

    def __init__(self, grid, mesh: Mesh, axis: str = "e"):
        self.grid = grid
        self.mesh = mesh
        self.axis = axis
        D = mesh.devices.size
        E = grid.n_elems
        self.n_elems_orig = E
        self.n_pad = (-E) % D
        self.n_elems = E + self.n_pad
        self.n_nodes = grid.n_nodes

        spec_e = NamedSharding(mesh, P(axis))
        self.conn = jax.device_put(
            _pad_elem_array(np.asarray(grid.conn, dtype=np.int32),
                            self.n_pad, mode="zero"), spec_e)
        self.grad_N = jax.device_put(
            _pad_elem_array(grid.grad_N, self.n_pad, mode="edge"), spec_e)
        self.vol = jax.device_put(
            _pad_elem_array(grid.volumes, self.n_pad, mode="zero"), spec_e)
        self.grad_N32 = self.grad_N.astype(jnp.float32)
        self.vol32 = self.vol.astype(jnp.float32)
        mass_local = jnp.asarray((np.ones((4, 4)) + np.eye(4)) / 20.0)

        ax = axis
        n_nodes = self.n_nodes

        def _mass_local_f(coefv, T, conn):
            T_e = T[conn]
            m = jnp.einsum("ab,eb,e->ea", mass_local.astype(T.dtype), T_e,
                           coefv.astype(T.dtype))
            out = jax.ops.segment_sum(m.reshape(-1), conn.reshape(-1),
                                      num_segments=n_nodes)
            return jax.lax.psum(out, ax)

        def _stiff_local(kv, T, conn, grad_N):
            T_e = T[conn]
            gT = jnp.einsum("ea,eai->ei", T_e, grad_N)
            f = jnp.einsum("ei,eai,e->ea", gT, grad_N, kv.astype(T.dtype))
            out = jax.ops.segment_sum(f.reshape(-1), conn.reshape(-1),
                                      num_segments=n_nodes)
            return jax.lax.psum(out, ax)

        def _mass_diag_local(coefv, conn):
            d = coefv[:, None] * jnp.full((1, 4), 2.0 / 20.0)
            out = jax.ops.segment_sum(d.reshape(-1), conn.reshape(-1),
                                      num_segments=n_nodes)
            return jax.lax.psum(out, ax)

        def _stiff_diag_local(kv, conn, grad_N):
            d = jnp.einsum("eai,eai,e->ea", grad_N, grad_N, kv)
            out = jax.ops.segment_sum(d.reshape(-1), conn.reshape(-1),
                                      num_segments=n_nodes)
            return jax.lax.psum(out, ax)

        Pe, Pr = P(ax), P()
        self._mass = shard_map(_mass_local_f, mesh=mesh,
                               in_specs=(Pe, Pr, Pe), out_specs=Pr)
        self._stiff = shard_map(_stiff_local, mesh=mesh,
                                in_specs=(Pe, Pr, Pe, Pe), out_specs=Pr)
        self._mass_diag = shard_map(_mass_diag_local, mesh=mesh,
                                    in_specs=(Pe, Pe), out_specs=Pr)
        self._stiff_diag = shard_map(_stiff_diag_local, mesh=mesh,
                                     in_specs=(Pe, Pe, Pe), out_specs=Pr)

    def _geom(self, dtype):
        if dtype == jnp.float32:
            return self.grad_N32, self.vol32
        return self.grad_N, self.vol

    # -- HeatKernel API -------------------------------------------------- #
    def mass_apply(self, coef, T):
        _, vol = self._geom(T.dtype)
        return self._mass(coef.astype(T.dtype) * vol, T, self.conn)

    def stiffness_apply(self, k, T):
        grad_N, vol = self._geom(T.dtype)
        return self._stiff(k.astype(T.dtype) * vol, T, self.conn, grad_N)

    def mass_diagonal(self, coef):
        return self._mass_diag(coef * self.vol, self.conn)

    def stiffness_diagonal(self, k):
        return self._stiff_diag(k * self.vol, self.conn, self.grad_N)

    def nodes_to_elems(self, T):
        return T[self.conn].mean(axis=1)


def shard_tm(eq, heat, mesh: Mesh | None = None, axis: str = "e",
             mode: str = "halo"):
    """Shard a coupled thermo-mechanical pair over a device mesh.

    ``shard_equation`` for the momentum equation plus the heat-equation
    counterpart: element-sharded heat assembly (psum'd, replicated nodal T)
    and the element-sharded DG0 coupling projection.  The reference runs the
    same TM loop unchanged under mpirun (Simulators.py:177-265); here the
    fused TM driver (momentum.solve_tm_time_steps) compiles into one SPMD
    program over the mesh."""
    if mesh is None:
        mesh = make_device_mesh(axis=axis)
    shard_equation(eq, mesh=mesh, axis=axis, mode=mode)
    heat.kernel = ShardedHeatKernel(heat.grid, mesh, axis)
    heat.n_elems = heat.kernel.n_elems
    # heat material fields: if the shared Material was already padded by
    # shard_equation, re-reading refreshes the references; an independent
    # material is padded here
    spec_e = NamedSharding(mesh, P(axis))
    n_pad = heat.kernel.n_pad
    for name in ("k", "rho", "cp"):
        arr = np.asarray(getattr(heat, name))
        if arr.shape[0] != heat.kernel.n_elems:
            arr = _pad_elem_array(arr, n_pad, mode="edge")
        setattr(heat, name, jax.device_put(arr, spec_e))
    # invalidate jitted programs built on the unsharded kernel
    heat._jit_step = None
    heat._jit_step_key = None
    heat._jit_msteps = None
    heat._jit_msteps_key = None
    eq._jit_tm_msteps = None
    eq._jit_tm_key = None
    return eq, heat


def shard_equation(eq, mesh: Mesh | None = None, axis: str = "e",
                   mode: str = "halo"):
    """Convert an assembled :class:`LinearMomentum` to SPMD execution.

    Pads every per-element array (kernel geometry, material operators and
    parameters, element ISV states, stress/strain fields) to a multiple of
    the device count and places them with a NamedSharding over ``axis``.
    Nodal fields stay replicated at step boundaries; the constitutive work
    is communication-free either way.

    ``mode`` selects the linear-solve communication pattern:

    * ``"halo"`` (default, the production scaling path): the Krylov loop
      runs on owner-sharded padded vectors with O(interface) halo exchange
      per matvec and psum'd dot products - the device-mesh analog of the
      reference's PETSc ghost updates (MomentumEquation.py:915-922);
      layout conversion happens once per solve.
    * ``"psum"``: each matvec scatter-adds into a replicated nodal vector
      and psums it - O(n_nodes * D) comm per matvec.  Simpler, fine for a
      few devices / small meshes; kept as the baseline and for tests.
    """
    if mesh is None:
        mesh = make_device_mesh(axis=axis)
    kern = ShardedMomentumKernel(eq.grid, mesh, axis)
    n_pad = kern.n_pad
    eq.kernel = kern
    eq.n_elems_orig = kern.n_elems_orig
    eq.n_elems = kern.n_elems

    spec_e = NamedSharding(mesh, P(axis))

    def pad_put(arr, mode="edge"):
        return jax.device_put(_pad_elem_array(arr, n_pad, mode), spec_e)

    # equation element fields: zero stress/strain on padded cells is safe -
    # every constitutive model guards the zero-stress state
    eq.sig_v = pad_put(eq.sig_v, mode="zero")
    eq.eps_tot_v = pad_put(eq.eps_tot_v, mode="zero")
    eq.eps_rhs_v = pad_put(eq.eps_rhs_v, mode="zero")
    eq.Temp = pad_put(eq.Temp)
    eq.T0 = pad_put(eq.T0)

    # material operators/parameters: edge-replicate real element data so the
    # padded constitutive math stays finite
    mat = eq.mat
    mat.n_elems = kern.n_elems
    for name in ("C", "C_inv", "C_tilde", "C_tilde_inv", "density"):
        if hasattr(mat, name):
            setattr(mat, name, pad_put(getattr(mat, name)))
    mat._CT_el = None
    for elem in mat.elems_ne + mat.elems_e + mat.elems_th:
        elem.n_elems = kern.n_elems
        if getattr(elem, "params", None):
            elem.params = {k: pad_put(v) for k, v in elem.params.items()}
        if hasattr(elem, "C1"):
            elem.C1 = pad_put(elem.C1)
    for elem in mat.elems_ne:
        elem.state = {k: pad_put(v) for k, v in elem.state.items()}
    for elem in mat.elems_th:
        elem.alpha = pad_put(elem.alpha)
    for elem in mat.elems_e:
        for name in ("E", "nu", "C", "C_inv", "C_tilde", "C_tilde_inv", "K"):
            if hasattr(elem, name):
                setattr(elem, name, pad_put(getattr(elem, name)))

    if mode == "halo":
        from .halo import HaloMomentumSolver
        eq._halo = HaloMomentumSolver(eq.grid, mesh, axis=axis)
    else:
        eq._halo = None

    # invalidate jit caches (kernel changed).  This includes the TM
    # multi-step driver (its closure captures the pre-sharding kernel), the
    # fused commit, and the lazily-built f32 shadow arrays on the material /
    # elements, which would otherwise keep their unpadded shapes.
    eq._jit_solve = None
    eq._jit_step = None
    eq._jit_step_key = None
    eq._jit_msteps = None
    eq._jit_tm_msteps = None
    eq._jit_tm_key = None
    eq._jit_commit = None
    eq._jit_commit_key = None
    eq._precond = None
    for obj in [mat] + mat.elems_ne + mat.elems_e + mat.elems_th:
        for cache in ("_params32", "_C1_32", "_C_inv32"):
            # the lazy builders test hasattr, so the stale entries must be
            # deleted, not set to None (material.py additionally accepts None)
            if hasattr(obj, cache):
                delattr(obj, cache)
    mat._C_inv32 = None
    return eq
