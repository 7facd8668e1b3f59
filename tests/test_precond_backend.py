"""Preconditioner modes and the accelerator operator/precision choices.

The dense preconditioner and the accelerator auto-selection are chosen only
off the CPU, so these tests force them: ``precond="dense"`` explicitly, and
``jax.default_backend`` monkeypatched to ``"gpu"`` for the choices keyed
off the backend.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import safeincave_tpu as sc
from safeincave_tpu.fem.momentum import build_preconditioner
from safeincave_tpu.mesh.reorder import reordered_grid

momBC = sc.MomentumBC


def _elastic_eq(grid, precond="auto", **kw):
    eq = sc.LinearMomentum(grid, theta=0.5, **kw)
    eq.set_solver(sc.SolverSettings(method="bicgstab", rtol=1e-12,
                                    precond=precond))
    n = eq.n_elems
    one = np.ones(n)
    mat = sc.Material(n)
    mat.set_density(2200.0 * one)
    mat.add_to_elastic(sc.Spring(102e9 * one, 0.3 * one))
    eq.set_material(mat)
    eq.set_T0(298.0 * one)
    eq.set_T(298.0 * one)
    eq.build_body_force([0.0, 0.0, -9.81])
    bc = momBC.BcHandler(eq)
    tv = [0.0, 1e12]
    for nm, comp in (("WEST", 0), ("SOUTH", 1), ("BOTTOM", 2)):
        bc.add_boundary_condition(momBC.DirichletBC(nm, comp, [0., 0.], tv))
    bc.add_boundary_condition(momBC.NeumannBC("TOP", 2, 0.0, 0.0,
                                              [10e6, 10e6], tv, g=0.0))
    eq.set_boundary_conditions(bc)
    eq.bc.update_dirichlet(0.0)
    eq.bc.update_neumann(0.0)
    return eq


def _box():
    return sc.GridBox(Lx=10.0, Ly=10.0, Lz=10.0, nx=3, ny=3, nz=4)


@pytest.fixture(scope="module")
def u_direct():
    """Elastic solution from a dense direct solve of the masked system."""
    from safeincave_tpu.fem import csr_reference as ref
    eq = _elastic_eq(_box())
    A = ref.stiffness_csr(eq.grid.points, eq.grid.conn,
                          np.asarray(eq.mat.C)).toarray()
    m = np.asarray(eq.bc.mask).reshape(-1)
    b = np.asarray(eq.b_body + eq.bc.b_neumann).reshape(-1)
    Am = A * m[:, None] * m[None, :] + np.diag(1.0 - m)
    return np.linalg.solve(Am, m * b).reshape(-1, 3)


@pytest.mark.parametrize("precond", ["dense", "2level", "jacobi"])
def test_elastic_solve_converges_for_every_precond(precond, u_direct):
    """Every preconditioner mode solves the elastic BVP to the same u
    (``dense`` is the accelerator default at cavern scale)."""
    eq = _elastic_eq(_box(), precond=precond)
    eq.solve_elastic_response()
    iters, res = eq.solver_stats
    assert np.isfinite(res) and iters > 0
    np.testing.assert_allclose(np.asarray(eq.u), u_direct, rtol=0,
                               atol=1e-9 * np.abs(u_direct).max())


@pytest.fixture
def on_gpu(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")


@pytest.mark.parametrize("case", ["band_keeps_cumsum", "natural_gets_dia",
                                  "fp32_phase_on"])
def test_accelerator_auto_selection(on_gpu, case):
    if case == "band_keeps_cumsum":
        grid, _, _ = reordered_grid(_box(), method="band")
        eq = sc.LinearMomentum(grid, theta=0.5)
        assert eq.kernel.dia is None and eq.kernel.blockell is None
        assert not hasattr(eq.kernel, "band")
    elif case == "natural_gets_dia":
        eq = sc.LinearMomentum(_box(), theta=0.5)
        assert eq.kernel.dia is not None and eq.kernel.dia.structured
    else:
        assert sc.SolverSettings().fp32_enabled()
        assert not sc.SolverSettings(fp32_phase=False).fp32_enabled()


@pytest.mark.parametrize("max_dofs,expect", [(10_000, "dense"),
                                             (10, "2level")])
def test_auto_precond_respects_dense_gate(on_gpu, max_dofs, expect):
    eq = _elastic_eq(_box())
    n3 = 3 * eq.n_nodes
    settings = sc.SolverSettings(precond="auto", dense_max_dofs=max_dofs)
    P, apply = build_preconditioner(eq.kernel, eq.mat.C, eq.bc.mask,
                                    settings)
    if expect == "dense":
        assert len(P) == 1 and P[0].shape == (n3, n3)
    else:
        assert len(P) == 2 and P[1].shape[0] < n3
    r = jnp.ones((eq.n_nodes, 3))
    assert np.isfinite(np.asarray(apply(P, r, eq.bc.mask))).all()
