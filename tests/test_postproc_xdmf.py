"""XDMF reader tests: own-output round-trip + reference (dolfinx) layout.

The reference post-processing stack reads dolfinx XDMFFile time series with
meshio (PostProcessingTools.py:192-374); postproc.read_xdmf must consume
both that layout and the framework's own writer output so users migrating
from SafeInCave can keep reading their archives.
"""
import os

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")   # XDMF needs the [io] extra

import safeincave_tpu as sc
import safeincave_tpu.postproc as pp

momBC = sc.MomentumBC


def _dolfinx_fixture(tmp_path):
    """Write a tiny time series in the dolfinx XDMFFile layout by hand."""
    pts = np.array([[0., 0., 0.], [1., 0., 0.], [0., 1., 0.], [0., 0., 1.],
                    [1., 1., 1.]])
    topo = np.array([[0, 1, 2, 3], [1, 2, 3, 4]], dtype=np.int64)
    u0 = np.arange(15, dtype=float).reshape(5, 3)
    u1 = u0 + 100.0
    q0 = np.array([1.5, 2.5])
    with h5py.File(tmp_path / "u.h5", "w") as h5:
        h5["/Mesh/mesh/topology"] = topo
        h5["/Mesh/mesh/geometry"] = pts
        h5["/Function/u/0"] = u0
        h5["/Function/u/1"] = u1
        h5["/Function/q/0"] = q0
        h5["/Function/q/1"] = q0 * 2
    grids = ""
    for k, t in enumerate((0.0, 3600.0)):
        grids += f"""
      <Grid Name="u" GridType="Uniform">
        <xi:include xpointer="xpointer(/Xdmf/Domain/Grid[@Name='mesh']/*[self::Topology or self::Geometry])" />
        <Time Value="{t}" />
        <Attribute Name="u" AttributeType="Vector" Center="Node">
          <DataItem Dimensions="5 3" Format="HDF">u.h5:/Function/u/{k}</DataItem>
        </Attribute>
        <Attribute Name="q" AttributeType="Scalar" Center="Cell">
          <DataItem Dimensions="2" Format="HDF">u.h5:/Function/q/{k}</DataItem>
        </Attribute>
      </Grid>"""
    xml = f"""<?xml version="1.0"?>
<!DOCTYPE Xdmf SYSTEM "Xdmf.dtd" []>
<Xdmf Version="3.0" xmlns:xi="http://www.w3.org/2001/XInclude">
  <Domain>
    <Grid Name="mesh" GridType="Uniform">
      <Topology TopologyType="Tetrahedron" NumberOfElements="2">
        <DataItem Dimensions="2 4" NumberType="Int" Format="HDF">u.h5:/Mesh/mesh/topology</DataItem>
      </Topology>
      <Geometry GeometryType="XYZ">
        <DataItem Dimensions="5 3" Format="HDF">u.h5:/Mesh/mesh/geometry</DataItem>
      </Geometry>
    </Grid>
    <Grid Name="u" GridType="Collection" CollectionType="Temporal">{grids}
    </Grid>
  </Domain>
</Xdmf>"""
    path = tmp_path / "u.xdmf"
    path.write_text(xml)
    return str(path), pts, topo, u0, u1, q0


class TestReferenceLayout:
    def test_read_dolfinx_layout(self, tmp_path):
        path, pts, topo, u0, u1, q0 = _dolfinx_fixture(tmp_path)
        points, topology, times, fields = pp.read_xdmf(path)
        np.testing.assert_allclose(points, pts)
        np.testing.assert_array_equal(topology, topo)
        np.testing.assert_allclose(times, [0.0, 3600.0])
        np.testing.assert_allclose(fields["u"]["values"][0], u0)
        np.testing.assert_allclose(fields["u"]["values"][1], u1)
        assert fields["q"]["center"] == "Cell"

    def test_reference_signatures(self, tmp_path):
        path, pts, topo, u0, u1, q0 = _dolfinx_fixture(tmp_path)
        points, times, vec = pp.read_node_vector_xdmf(path)
        assert vec.shape == (2, 5, 3)
        cents, times, sca = pp.read_cell_scalar_xdmf(path)
        np.testing.assert_allclose(sca[0], q0)
        np.testing.assert_allclose(cents, pts[topo].mean(axis=1))


class TestOwnOutputRoundTrip:
    def test_own_writer_readable(self, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        grid = sc.GridBox(nx=2, ny=2, nz=2)
        eq = sc.LinearMomentum(grid, theta=0.5)
        n = eq.n_elems
        import jax.numpy as jnp
        one = jnp.ones(n)
        mat = sc.Material(n)
        mat.set_density(2000.0 * one)
        mat.add_to_elastic(sc.Spring(1e9 * one, 0.3 * one))
        eq.set_material(mat)
        eq.set_T0(298.0 * one)
        eq.set_T(298.0 * one)
        eq.build_body_force([0.0, 0.0, 0.0])
        bc = momBC.BcHandler(eq)
        tv = [0.0, 1e9]
        bc.add_boundary_condition(momBC.DirichletBC("BOTTOM", 2, [0., 0.],
                                                    tv))
        bc.add_boundary_condition(momBC.NeumannBC("TOP", 2, 0.0, 0.0,
                                                  [1e6, 1e6], tv, g=0.0))
        eq.set_boundary_conditions(bc)

        out = sc.SaveFields(eq)
        out.set_output_folder("out")
        out.add_output_field("u", "Displacement (m)")
        out.add_output_field("q_elems", "Von Mises (Pa)")
        tc = sc.TimeController(dt=1.0, initial_time=0.0, final_time=2.0,
                               time_unit="hour")
        sc.Simulator_M(eq, tc, [out]).run()

        # the generic reader consumes our own writer's layout
        points, topo, times, fields = pp.read_xdmf(
            os.path.join("out", "u", "u.xdmf"))
        assert points.shape == (grid.n_nodes, 3)
        assert fields["u"]["values"].shape[0] == len(times) == 3
        pts2, times2, vec = pp.read_node_vector_xdmf(
            os.path.join("out", "u", "u.xdmf"))
        np.testing.assert_allclose(vec[-1].reshape(-1, 3),
                                   np.asarray(eq.u), rtol=1e-12)
