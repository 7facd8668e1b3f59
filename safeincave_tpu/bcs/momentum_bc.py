"""Momentum boundary conditions.

Reference: /root/reference/safeincave/MomentumBC.py.  Dirichlet BCs become
per-component node masks + value arrays (matrix-free symmetric elimination
replaces PETSc ``apply_lifting``/``set_bc``); Neumann BCs (with the
hydrostatic-column pressure ``-p(t) + rho g (H - x_i)``) are assembled exactly
over boundary triangles with the linear-integrand rule
``int f N_a dA = A/12 (2 f_a + f_b + f_c)``.

Every ``update_*(t)`` / ``*_arrays(t)`` entry point is traceable in ``t``
(schedules interpolate with ``jnp.interp``), so BC updates can live inside a
fully jitted time step.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp


class GeneralBC:
    def __init__(self):
        self.boundary_name = None
        self.type = None
        self.values = None
        self.time_values = None


class DirichletBC(GeneralBC):
    """Time-dependent essential BC on one displacement component
    (reference MomentumBC.py:52-83)."""

    def __init__(self, boundary_name: str, component: int, values, time_values):
        self.boundary_name = boundary_name
        self.type = "dirichlet"
        self.values = np.asarray(values, dtype=np.float64)
        self.time_values = np.asarray(time_values, dtype=np.float64)
        self.component = component


class NeumannBC(GeneralBC):
    """Traction/pressure BC with hydrostatic column
    (reference MomentumBC.py:85-135)."""

    def __init__(self, boundary_name: str, direction: int, density: float,
                 ref_pos: float, values, time_values, g: float = -9.81):
        self.boundary_name = boundary_name
        self.type = "neumann"
        self.values = np.asarray(values, dtype=np.float64)
        self.time_values = np.asarray(time_values, dtype=np.float64)
        self.direction = direction
        self.density = density
        self.ref_pos = ref_pos
        self.gravity = g


class BcHandler:
    """Organizes BCs and produces mask/value/RHS arrays at a given time
    (reference MomentumBC.py:138-277)."""

    def __init__(self, equation):
        self.eq = equation
        self.grid = equation.grid
        self.dirichlet_boundaries = []
        self.neumann_boundaries = []
        self._dirichlet_meta = []   # (node_indices, component, times, values)
        self._neumann_meta = []
        self._jit_dirichlet = None
        self._jit_neumann = None

    def reset_boundary_conditions(self):
        self.dirichlet_boundaries = []
        self.neumann_boundaries = []
        self._dirichlet_meta = []
        self._neumann_meta = []
        self._jit_dirichlet = None
        self._jit_neumann = None

    def add_boundary_condition(self, bc: GeneralBC):
        self._jit_dirichlet = None
        self._jit_neumann = None
        grid = self.grid
        # Meta arrays stay HOST-resident (numpy): they are captured by the
        # jitted update_* closures, and a captured *device* array forces a
        # device-to-host fetch at lowering time (mlir ir_constant -> _value);
        # numpy constants lower without touching the device.
        if bc.type == "dirichlet":
            self.dirichlet_boundaries.append(bc)
            facets = grid.get_boundary_tags(bc.boundary_name)
            nodes = np.unique(grid.tris[facets].reshape(-1))
            self._dirichlet_meta.append(
                (np.asarray(nodes), bc.component,
                 np.asarray(bc.time_values), np.asarray(bc.values)))
        elif bc.type == "neumann":
            self.neumann_boundaries.append(bc)
            facets = np.asarray(grid.get_boundary_tags(bc.boundary_name))
            tris = grid.tris[facets]                       # (F, 3)
            self._neumann_meta.append(dict(
                tris=np.asarray(tris),
                areas=np.asarray(grid.tri_areas[facets]),
                normals=np.asarray(grid.tri_normals[facets]),
                coords=np.asarray(grid.points[tris]),      # (F, 3, 3)
                direction=bc.direction,
                density=bc.density,
                ref_pos=bc.ref_pos,
                gravity=bc.gravity,
                times=np.asarray(bc.time_values),
                values=np.asarray(bc.values),
            ))
        else:
            raise Exception(f"Boundary type {bc.type} not supported.")

    @property
    def all_zero_dirichlet(self) -> bool:
        """Static: every Dirichlet schedule is identically zero (the usual
        fixed-support case).  Lets the solver skip the lifting matvec
        A @ u_bc entirely (a full f64 stiffness action per linear solve)."""
        return all(np.all(np.asarray(bc.values) == 0.0)
                   for bc in self.dirichlet_boundaries)

    # ------------------------------------------------------------------ #
    # Traceable array builders
    # ------------------------------------------------------------------ #
    def dirichlet_arrays(self, t):
        """(mask, u_bc): mask is 1 on free dofs, 0 on constrained; u_bc holds
        the prescribed values (0 elsewhere).  Later BCs overwrite earlier ones
        on shared nodes, matching sequential PETSc ``set_bc``."""
        n = self.grid.n_nodes
        mask = jnp.ones((n, 3), dtype=jnp.float64)
        u_bc = jnp.zeros((n, 3), dtype=jnp.float64)
        for nodes, comp, times, values in self._dirichlet_meta:
            val = jnp.interp(t, times, values)
            mask = mask.at[nodes, comp].set(0.0)
            u_bc = u_bc.at[nodes, comp].set(val)
        return mask, u_bc

    def neumann_rhs(self, t):
        """Assembled surface-traction RHS vector (n_nodes, 3) at time t."""
        n = self.grid.n_nodes
        f = jnp.zeros((n, 3), dtype=jnp.float64)
        for m in self._neumann_meta:
            p = -jnp.interp(t, m["times"], m["values"])
            x_i = m["coords"][:, :, m["direction"]]        # (F, 3)
            v = p + m["density"] * m["gravity"] * (m["ref_pos"] - x_i)
            # int v N_a dA over each triangle, exact for linear v
            w = (m["areas"] / 12.0)[:, None] * (2.0 * v + jnp.roll(v, 1, axis=1)
                                                + jnp.roll(v, 2, axis=1))
            contrib = w[:, :, None] * m["normals"][:, None, :]  # (F, 3, 3)
            f = f + jax.ops.segment_sum(contrib.reshape(-1, 3),
                                        m["tris"].reshape(-1),
                                        num_segments=n)
        return f

    # ------------------------------------------------------------------ #
    # Reference-compatible mutating API (Simulators call these per step)
    # ------------------------------------------------------------------ #
    def update_dirichlet(self, t):
        if self._jit_dirichlet is None:
            self._jit_dirichlet = jax.jit(self.dirichlet_arrays)
        self.mask, self.u_bc = self._jit_dirichlet(t)

    def update_neumann(self, t):
        if self._jit_neumann is None:
            self._jit_neumann = jax.jit(self.neumann_rhs)
        self.b_neumann = self._jit_neumann(t)
