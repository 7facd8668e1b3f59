"""Device stiffness operators against the independent host CSR reference
(safeincave_tpu/fem/csr_reference.py), the same comparison chip_smoke.py
makes at full size on the GPU."""
import jax.numpy as jnp
import numpy as np
import pytest

import safeincave_tpu as sc
from safeincave_tpu.fem import csr_reference as ref
from safeincave_tpu.fem.blockell import BlockELL
from safeincave_tpu.fem.dia import BlockDIA
from safeincave_tpu.fem.kernels import MomentumKernel
from safeincave_tpu.mesh.reorder import reordered_grid

BOUND = {"float64": 1e-12, "float32": 1e-5}


def _problem(grid, seed=0):
    rng = np.random.default_rng(seed)
    n = grid.n_elems
    mat = sc.Material(n)
    mat.add_to_elastic(sc.Spring(rng.uniform(30e9, 110e9, n),
                                 0.3 * np.ones(n)))
    C = np.asarray(mat.C)
    u = rng.normal(size=(grid.n_nodes, 3))
    y_ref = ref.apply(ref.stiffness_csr(grid.points, grid.conn, C), u)
    return MomentumKernel(grid), C, u, y_ref


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_cumsum_matvec_matches_csr(dtype):
    grid, _, _ = reordered_grid(sc.GridBox(Lx=2.0, Ly=1.0, Lz=3.0,
                                           nx=4, ny=3, nz=5), method="band")
    kern, C, u, y_ref = _problem(grid)
    y = kern.matvec(kern.prep(jnp.asarray(C, dtype)), jnp.asarray(u, dtype))
    assert ref.relative_error(y, y_ref) <= BOUND[dtype]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_dia_matvec_matches_csr(dtype):
    grid = sc.GridBox(Lx=600.0, Ly=600.0, Lz=800.0, nx=5, ny=4, nz=6)
    kern, C, u, y_ref = _problem(grid, seed=1)
    dia = BlockDIA(kern)
    assert dia.structured
    vals = dia.assemble(kern.prep(jnp.asarray(C, dtype)))
    assert vals.shape == (9 * dia.plan.Dn, grid.n_nodes)
    y = dia.matvec(vals, jnp.asarray(u, dtype))
    assert y.dtype == jnp.dtype(dtype)
    assert ref.relative_error(y, y_ref) <= BOUND[dtype]


def test_blockell_matvec_matches_csr():
    grid, _, _ = reordered_grid(sc.GridBox(nx=3, ny=4, nz=3), method="band")
    kern, C, u, y_ref = _problem(grid, seed=2)
    bell = BlockELL(kern)
    y = bell.matvec(bell.assemble(kern.prep(jnp.asarray(C))), jnp.asarray(u))
    assert ref.relative_error(y, y_ref) <= BOUND["float64"]


def test_csr_reference_is_symmetric_with_rigid_nullspace():
    """The reference itself: symmetric, and rigid translations are in its
    null space (sum of nodal forces of every element is zero)."""
    grid = sc.GridBox(nx=2, ny=2, nz=3)
    _, C, _, _ = _problem(grid, seed=3)
    A = ref.stiffness_csr(grid.points, grid.conn, C)
    assert abs(A - A.T).max() <= 1e-12 * abs(A).max()
    for comp in range(3):
        t = np.zeros((grid.n_nodes, 3))
        t[:, comp] = 1.0
        assert np.abs(ref.apply(A, t)).max() <= 1e-12 * abs(A).max()
