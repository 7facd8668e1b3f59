"""Transient heat diffusion: P1 temperature, implicit (backward-Euler) step.

Reference: /root/reference/safeincave/HeatEquation.py:34-366.  One step:

    a(dT, v) = (rho cp / dt)(dT, v) + (k grad dT, grad v) + sum h (dT, v)_G
    L(v)     = (rho cp / dt)(T_old, v) + neumann + sum h T_inf (v)_G

solved matrix-free with Jacobi-CG (operator is SPD).
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from .kernels import HeatKernel
from .solvers import cg_solve, ir_solve
from .momentum import SolverSettings


class HeatDiffusion:
    def __init__(self, grid):
        self.grid = grid
        self.kernel = HeatKernel(grid)
        self.n_elems = grid.n_elems
        self.n_nodes = grid.n_nodes
        self.T = jnp.asarray(np.zeros(self.n_nodes))
        self.T_old = jnp.asarray(np.zeros(self.n_nodes))
        self.solver = SolverSettings(method="cg")
        self.solver_stats = (0, 0.0)

    def set_material(self, material):
        self.mat = material
        self.initialize()

    def initialize(self):
        self.k = self.mat.k
        self.rho = self.mat.density
        self.cp = self.mat.cp

    def set_solver(self, solver: SolverSettings):
        self.solver = solver

    def set_boundary_conditions(self, bc):
        self.bc = bc

    def set_initial_T(self, T_field):
        T = jnp.asarray(T_field, dtype=jnp.float64)
        if T.ndim == 0:
            T = jnp.full(self.n_nodes, T)
        self.T = T
        self.T_old = T

    def update_T_old(self):
        self.T_old = self.T

    def get_T_elems(self):
        """Project nodal T to DG0 (vertex average), reference :286-301."""
        return self.kernel.nodes_to_elems(self.T)

    def _make_step_core(self):
        """Unjitted closure for one implicit heat step (BC arrays, assembly,
        Jacobi-CG).  Mixed precision like the momentum solve: f32 CG
        iterations under f64 defect correction (fem/solvers.ir_solve); the
        Robin facet term is tiny and stays f64 inside the f32 operator.
        Reused by the jitted single step and the fused TM multi-step driver.
        """
        kern = self.kernel
        bc = self.bc
        rtol, maxiter = self.solver.rtol, self.solver.max_it
        mixed = self.solver.precision == "mixed"

        def _step(T, T_old, k, rho, cp, t, dt):
            mask, T_bc = bc.dirichlet_arrays(t)
            b_neumann = bc.neumann_rhs(t)
            b_robin = bc.robin_rhs(t)
            coef = rho * cp / dt

            def A_full(x):
                robin = bc.robin_operator_apply(
                    x.astype(jnp.float64)).astype(x.dtype)
                return (kern.mass_apply(coef, x)
                        + kern.stiffness_apply(k, x) + robin)

            def Aop(x):
                # masked operator with identity on Dirichlet dofs
                m = mask.astype(x.dtype)
                return m * A_full(m * x) + (1.0 - m) * x

            diag = mask * (kern.mass_diagonal(coef)
                           + kern.stiffness_diagonal(k)
                           + bc.robin_diagonal()) + (1.0 - mask)
            diag = jnp.where(jnp.abs(diag) > 0, diag, 1.0)

            def M_inv(r):
                return r / diag.astype(r.dtype)

            b = kern.mass_apply(coef, T_old) + b_neumann + b_robin
            b_eff = mask * (b - A_full(T_bc)) + (1.0 - mask) * T_bc
            x0 = mask * T + (1.0 - mask) * T_bc
            if mixed:
                return ir_solve(Aop, Aop, b_eff, x0, M_inv,
                                inner_solve=cg_solve, rtol=rtol,
                                inner_rtol=self.solver.inner_rtol,
                                inner_maxiter=maxiter,
                                max_passes=self.solver.max_passes)
            return cg_solve(Aop, b_eff, x0, M_inv,
                            rtol=rtol, maxiter=maxiter)

        return _step

    def _build_jit_step(self):
        core = self._make_step_core()

        @jax.jit
        def _step(T, T_old, k, rho, cp, t, dt):
            x, iters, res = core(T, T_old, k, rho, cp, t, dt)
            # packed stats: one device->host transfer per step
            return x, jnp.stack([iters.astype(jnp.float64), res])

        return _step

    def solve(self, t, dt):
        """Assemble and solve one implicit step (reference :304-365)."""
        key = (id(self.bc), self.solver.rtol, self.solver.max_it,
               self.solver.precision)
        if getattr(self, "_jit_step_key", None) != key:
            self._jit_step = self._build_jit_step()
            self._jit_step_key = key
        x, statsvec = self._jit_step(self.T, self.T_old, self.k, self.rho,
                                     self.cp, t, dt)
        stats = np.asarray(statsvec)
        self.solver_stats = (int(stats[0]), float(stats[1]))
        self.T = x
        self.update_T_old()

    def solve_steps(self, ts, dts):
        """Advance len(ts) implicit heat steps in ONE device dispatch
        (lax.scan over the jitted step; chunks padded to a canonical length
        so all sizes share one executable).  Returns (K, 2) per-step
        [cg_iters, residual]."""
        key = (id(self.bc), self.solver.rtol, self.solver.max_it,
               self.solver.precision, "msteps")
        if getattr(self, "_jit_msteps_key", None) != key:
            core = self._make_step_core()

            @jax.jit
            def _msteps(T, T_old, k, rho, cp, ts, dts, n_real):
                def one(carry, tdi):
                    T, T_old = carry
                    t, dt, i = tdi
                    active = i < n_real

                    def run(_):
                        x, iters, res = core(T, T_old, k, rho, cp, t, dt)
                        return (x, x), jnp.stack(
                            [iters.astype(jnp.float64), res])

                    def skip(_):
                        return (T, T_old), jnp.zeros(2)

                    return jax.lax.cond(active, run, skip, None)

                idx = jnp.arange(ts.shape[0], dtype=jnp.int64)
                (T_f, T_old_f), rows = jax.lax.scan(one, (T, T_old),
                                                    (ts, dts, idx))
                return T_f, T_old_f, rows

            self._jit_msteps = _msteps
            self._jit_msteps_key = key
        n_real = len(ts)
        k_pad = max(64, -(-n_real // 64) * 64)
        ts = np.concatenate([np.asarray(ts, dtype=np.float64),
                             np.full(k_pad - n_real, ts[-1])])
        dts = np.concatenate([np.asarray(dts, dtype=np.float64),
                              np.full(k_pad - n_real, dts[-1])])
        T, T_old, rows = self._jit_msteps(self.T, self.T_old, self.k,
                                          self.rho, self.cp,
                                          jnp.asarray(ts), jnp.asarray(dts),
                                          n_real)
        self.T = T
        self.T_old = T_old
        stats = np.asarray(rows)[:n_real]
        if n_real:
            self.solver_stats = (int(stats[-1, 0]), float(stats[-1, 1]))
        return stats
