"""XDMF/HDF5 time-series output.

Reference: /root/reference/safeincave/OutputHandler.py:31-202 (``SaveFields``:
one XDMFFile per registered field under ``{out}/{field}/{field}.xdmf``, mesh
written once, ``write_function(field, t)`` per save, source ``.msh`` copied to
``{out}/mesh/``).  This implementation writes the same directory layout with
h5py + hand-emitted XDMF3 XML (ParaView-compatible); no dolfinx/meshio
dependency.

Fields are looked up as attributes on the equation object at save time, so
user subclasses can expose extra DG0/CG1 fields exactly like the reference's
``run_after_solve`` idiom (examples/mechanics/1_triaxial/main.py:13-24).
"""
from __future__ import annotations

import os
import shutil

import numpy as np


def require_h5py():
    """Import h5py on first use: only the XDMF/HDF5 writers and readers
    need it, so the solver itself runs without it."""
    try:
        import h5py
    except ImportError as exc:
        raise ImportError(
            "XDMF/HDF5 output needs the 'h5py' package "
            "(pip install 'safeincave-tpu[io]')") from exc
    return h5py


def _field_layout(arr, n_nodes, n_elems):
    """(center, attr_type, flat_shape) for an output array."""
    if arr.shape[0] == n_nodes:
        center = "Node"
    elif arr.shape[0] == n_elems:
        center = "Cell"
    else:
        raise ValueError(f"field first dim {arr.shape[0]} matches neither "
                         f"nodes ({n_nodes}) nor cells ({n_elems})")
    if arr.ndim == 1:
        return center, "Scalar", (arr.shape[0],)
    if arr.ndim == 2 and arr.shape[1] == 3:
        return center, "Vector", arr.shape
    if arr.ndim == 3 and arr.shape[1:] == (3, 3):
        return center, "Tensor", (arr.shape[0], 9)
    if arr.ndim == 2 and arr.shape[1] == 6:
        return center, "Tensor6", (arr.shape[0], 6)
    raise ValueError(f"unsupported field shape {arr.shape}")


class SaveFields:
    """Register fields on an equation and write XDMF time series."""

    def __init__(self, eq, save_every: int = 1):
        """``save_every=N`` keeps only every N-th save call (plus the first),
        the nobian scripts' SparseSaveFields idiom
        (/root/reference/examples/mechanics/nobian/Simulation/
        Munsondawson.py:235-247)."""
        self.eq = eq
        self.grid = eq.grid
        self.fields: list[tuple[str, str]] = []
        self.output_folder = "output"
        self.save_every = save_every
        self._call_count = 0
        self._handles = {}
        self._times = {}

    def set_output_folder(self, folder: str):
        self.output_folder = folder

    def add_output_field(self, field_name: str, label: str):
        self.fields.append((field_name, label))

    # ------------------------------------------------------------------ #
    def initialize(self):
        for field_name, _ in self.fields:
            fdir = os.path.join(self.output_folder, field_name)
            os.makedirs(fdir, exist_ok=True)
            h5path = os.path.join(fdir, f"{field_name}.h5")
            h5 = require_h5py().File(h5path, "w")
            h5.create_dataset("Mesh/geometry", data=np.asarray(self.grid.points))
            h5.create_dataset("Mesh/topology",
                              data=np.asarray(self.grid.conn, dtype=np.int64))
            self._handles[field_name] = h5
            self._times[field_name] = []

    def _get_field(self, field_name):
        """Fetch a field, slicing off device-count padding on element
        arrays from sharded runs (parallel/sharding.py pads n_elems to a
        multiple of the device count; the grid keeps the true count)."""
        arr = np.asarray(getattr(self.eq, field_name))
        n_true = getattr(self.eq, "n_elems_orig", self.grid.n_elems)
        if (arr.shape[0] == getattr(self.eq, "n_elems", -1)
                and arr.shape[0] > n_true):
            arr = arr[:n_true]
        return arr

    def calls_until_next_keep(self) -> int:
        """How many ``save_fields`` calls until one actually writes (>= 1).

        Lets the fused multi-step driver (Simulator_M) size device-side
        chunks so every write still happens at exactly the step it would
        have in the per-step flow."""
        j = (1 - self._call_count) % self.save_every
        return j if j else self.save_every

    def skip_calls(self, k: int):
        """Account ``k`` save calls whose steps ran fused on device (their
        intermediate fields were never materialized).  Only valid for calls
        that would NOT have written (the driver aligns chunks so keeps land
        on real ``save_fields`` calls)."""
        assert k < self.calls_until_next_keep(), \
            "fused chunk crossed a save boundary"
        self._call_count += k

    def save_fields(self, t: float):
        keep = (self._call_count % self.save_every == 0)
        self._call_count += 1
        if not keep:
            return
        for field_name, label in self.fields:
            arr = self._get_field(field_name)
            h5 = self._handles[field_name]
            step = len(self._times[field_name])
            center, attr_type, flat_shape = _field_layout(
                arr, self.grid.n_nodes, self.grid.n_elems)
            h5.create_dataset(f"Function/{field_name}/{step}",
                              data=arr.reshape(flat_shape))
            self._times[field_name].append(float(t))
            h5.flush()

    def save_mesh(self):
        """Finalize: emit XDMF XML and copy the source mesh for provenance."""
        for field_name, label in self.fields:
            arr = self._get_field(field_name)
            self._write_xdmf(field_name, arr)
            self._handles[field_name].close()
        mesh_dir = os.path.join(self.output_folder, "mesh")
        os.makedirs(mesh_dir, exist_ok=True)
        src_folder = getattr(self.grid, "grid_folder", None)
        src_name = getattr(self.grid, "geometry_name", None)
        if src_folder and src_name:
            src = os.path.join(src_folder, f"{src_name}.msh")
            if os.path.isfile(src):
                shutil.copy(src, mesh_dir)

    # ------------------------------------------------------------------ #
    def _write_xdmf(self, field_name: str, sample: np.ndarray):
        n_nodes = self.grid.n_nodes
        n_elems = self.grid.n_elems
        center, attr_type, flat_shape = _field_layout(sample, n_nodes, n_elems)
        xdmf_attr = {"Scalar": "Scalar", "Vector": "Vector",
                     "Tensor": "Tensor", "Tensor6": "Tensor6"}[attr_type]
        dims = " ".join(str(d) for d in flat_shape)
        h5name = f"{field_name}.h5"
        times = self._times[field_name]

        grids = []
        for step, t in enumerate(times):
            grids.append(f"""
      <Grid Name="step_{step}" GridType="Uniform">
        <xi:include xpointer="xpointer(//Grid[@Name='mesh']/*[self::Topology or self::Geometry])"/>
        <Time Value="{t}"/>
        <Attribute Name="{field_name}" AttributeType="{xdmf_attr}" Center="{center}">
          <DataItem Dimensions="{dims}" Format="HDF" DataType="Float" Precision="8">{h5name}:/Function/{field_name}/{step}</DataItem>
        </Attribute>
      </Grid>""")

        xml = f"""<?xml version="1.0"?>
<!DOCTYPE Xdmf SYSTEM "Xdmf.dtd" []>
<Xdmf Version="3.0" xmlns:xi="http://www.w3.org/2001/XInclude">
  <Domain>
    <Grid Name="mesh" GridType="Uniform">
      <Topology TopologyType="Tetrahedron" NumberOfElements="{n_elems}">
        <DataItem Dimensions="{n_elems} 4" Format="HDF" DataType="Int">{h5name}:/Mesh/topology</DataItem>
      </Topology>
      <Geometry GeometryType="XYZ">
        <DataItem Dimensions="{n_nodes} 3" Format="HDF" DataType="Float" Precision="8">{h5name}:/Mesh/geometry</DataItem>
      </Geometry>
    </Grid>
    <Grid Name="{field_name}_series" GridType="Collection" CollectionType="Temporal">{"".join(grids)}
    </Grid>
  </Domain>
</Xdmf>
"""
        path = os.path.join(self.output_folder, field_name,
                            f"{field_name}.xdmf")
        with open(path, "w") as f:
            f.write(xml)
