"""Block-DIA assembled operator vs the matrix-free element kernel.

The offset-plane matvec must reproduce kern.matvec exactly (same
operator, different evaluation order) to f64 roundoff on structured
GridBox numberings, and DIAPlan must refuse orderings whose column
offsets do not collapse (Morton), so the auto-selection can never route
an unstructured mesh onto the shift kernel.
"""
import numpy as np
import jax.numpy as jnp
import pytest

import safeincave_tpu as sc
from safeincave_tpu.fem.kernels import MomentumKernel
from safeincave_tpu.fem.dia import BlockDIA, DIAPlan


def _random_ct(E, rng):
    A = rng.normal(size=(E, 6, 6))
    CT = np.einsum("eij,ekj->eik", A, A) + 6 * np.eye(6)[None]
    return jnp.asarray(np.moveaxis(CT, 0, -1))


def test_matches_matrix_free():
    grid = sc.GridBox(Lx=1.0, Ly=2.0, Lz=3.0, nx=4, ny=3, nz=5)
    kern = MomentumKernel(grid)
    dia = BlockDIA(kern)
    assert dia.plan.Dn <= 27           # lexicographic stencil offsets
    assert dia._sp is not None         # GridBox is recognised structured
    rng = np.random.default_rng(0)
    CT = _random_ct(grid.n_elems, rng)
    u = jnp.asarray(rng.normal(size=(grid.n_nodes, 3)))

    y_ref = np.asarray(kern.matvec(CT, u))
    vals = dia.assemble(CT)
    y = np.asarray(dia.matvec(vals, u))
    np.testing.assert_allclose(y, y_ref, rtol=1e-12,
                               atol=1e-12 * np.abs(y_ref).max())
    # f32 cast path
    y32 = np.asarray(dia.matvec(vals.astype(jnp.float32),
                                u.astype(jnp.float32)))
    np.testing.assert_allclose(y32, y_ref, rtol=2e-4,
                               atol=2e-4 * np.abs(y_ref).max())


def test_structured_assembly_matches_scatter():
    """The 96-strided-add structured assembly and the general scatter
    assembly are the same operator to f64 roundoff."""
    grid = sc.GridBox(Lx=2.0, Ly=1.0, Lz=1.5, nx=5, ny=4, nz=3)
    kern = MomentumKernel(grid)
    dia = BlockDIA(kern)
    assert dia._sp is not None
    assert (dia._sp.nx, dia._sp.ny, dia._sp.nz) == (5, 4, 3)
    rng = np.random.default_rng(1)
    CT = _random_ct(grid.n_elems, rng)
    vals_structured = np.asarray(dia.assemble(CT))
    dia._sp = None                     # force the scatter path
    vals_scatter = np.asarray(dia.assemble(CT))
    np.testing.assert_allclose(vals_structured, vals_scatter,
                               rtol=1e-12,
                               atol=1e-12 * np.abs(vals_scatter).max())


def test_refuses_unstructured_numbering():
    from safeincave_tpu.mesh.reorder import reordered_grid
    grid = sc.GridBox(Lx=1.0, Ly=1.0, Lz=1.0, nx=5, ny=5, nz=5)
    grid_m, _, _ = reordered_grid(grid, method="morton")
    with pytest.raises(ValueError, match="offset-structured"):
        DIAPlan(np.asarray(grid_m.conn), grid_m.n_nodes)


def test_solver_path_matches_default():
    """End-to-end: a time step solved with enable_dia_matvec matches the
    default matrix-free path to solver tolerance."""
    def build():
        grid = sc.GridBox(Lx=10.0, Ly=10.0, Lz=10.0, nx=3, ny=3, nz=3)
        eq = sc.LinearMomentum(grid, theta=0.5)
        eq.set_solver(sc.SolverSettings(method="bicgstab", rtol=1e-12,
                                        precond="jacobi"))
        n = eq.n_elems
        one = np.ones(n)
        mat = sc.Material(n)
        mat.set_density(2200.0 * one)
        mat.add_to_elastic(sc.Spring(102e9 * one, 0.3 * one))
        mat.add_to_non_elastic(sc.DislocationCreep(1.9e-20 * one,
                                                   51600 * one, 3.0 * one))
        eq.set_material(mat)
        eq.set_T0(298.0 * one)
        eq.set_T(298.0 * one)
        eq.build_body_force([0.0, 0.0, -9.81])
        bc = sc.MomentumBC.BcHandler(eq)
        tv = [0.0, 1e12]
        for nm, comp in [("WEST", 0), ("SOUTH", 1), ("BOTTOM", 2)]:
            bc.add_boundary_condition(
                sc.MomentumBC.DirichletBC(nm, comp, [0.0, 0.0], tv))
        bc.add_boundary_condition(sc.MomentumBC.NeumannBC(
            "TOP", 2, 0.0, 0.0, [10e6, 10e6], tv, g=0.0))
        eq.set_boundary_conditions(bc)
        eps = eq.compute_total_strain()
        eq.compute_elastic_stress(eps)
        eq.compute_eps_ne_rate(eq.sig_v, 0.0)
        eq.update_eps_ne_rate_old()
        return eq

    eq_a = build()
    eq_a.solve_time_step(3600.0, 3600.0, tol=1e-9, maxiter=30)
    eq_b = build()
    eq_b.enable_dia_matvec()
    eq_b.solve_time_step(3600.0, 3600.0, tol=1e-9, maxiter=30)
    np.testing.assert_allclose(np.asarray(eq_b.u), np.asarray(eq_a.u),
                               rtol=1e-8, atol=1e-12)
