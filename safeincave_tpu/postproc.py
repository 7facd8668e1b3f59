"""Post-processing: standalone readers for XDMF/HDF5 outputs
plus point-probe and smoothing helpers.

Reference: /root/reference/safeincave/PostProcessingTools.py (meshio-based
XDMF time-series readers :192-374, duplicate numpy smoother :23-107, point
lookup :109-189).  Two entry levels:

* folder-based helpers working directly on the h5 layout written by
  :class:`safeincave_tpu.output.SaveFields`;
* :func:`read_xdmf` - a generic XDMF-XML + HDF5 time-series reader (no
  meshio/dolfinx needed) that also understands the **reference's dolfinx
  XDMFFile layout**, so outputs produced by the original SafeInCave stack
  are readable here, and path-based wrappers with the reference's signatures
  (read_cell_tensor/read_cell_scalar/read_node_scalar/read_node_vector on an
  .xdmf path, PostProcessingTools.py:192-374).
"""
from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np

from .output.xdmf import require_h5py


# ---------------------------------------------------------------------------
# Generic XDMF time-series reader (ours + dolfinx/reference layout)
# ---------------------------------------------------------------------------
def _load_dataitem(text: str, base_dir: str, h5_cache: dict) -> np.ndarray:
    """Resolve 'file.h5:/group/path' HeavyData references."""
    fname, path = text.strip().split(":", 1)
    fpath = os.path.join(base_dir, fname)
    if fpath not in h5_cache:
        h5_cache[fpath] = require_h5py().File(fpath, "r")
    return h5_cache[fpath][path][()]


def read_xdmf(xdmf_path: str):
    """Read any temporal-collection XDMF3 file written by this framework or
    by dolfinx's XDMFFile (the reference output format).

    Returns ``(points, topology, times, fields)`` where ``fields`` maps
    attribute name -> {"center": "Node"|"Cell", "values": (n_steps, ...)}.
    """
    base_dir = os.path.dirname(os.path.abspath(xdmf_path))
    # strip the xi: namespace prefix so ElementTree parses xpointer includes
    with open(xdmf_path) as f:
        xml_text = f.read()
    root = ET.fromstring(xml_text)
    h5_cache: dict = {}
    try:
        # mesh: the first Grid containing Topology+Geometry DataItems
        points = topology = None
        for grid in root.iter("Grid"):
            topo = grid.find("Topology")
            geom = grid.find("Geometry")
            if topo is not None and geom is not None:
                t_item = topo.find("DataItem")
                g_item = geom.find("DataItem")
                if t_item is not None and g_item is not None:
                    topology = _load_dataitem(t_item.text, base_dir,
                                              h5_cache).astype(np.int64)
                    points = np.asarray(
                        _load_dataitem(g_item.text, base_dir, h5_cache),
                        dtype=np.float64)
                    break
        if points is None:
            raise ValueError(f"no mesh Grid found in {xdmf_path}")

        times = []
        series: dict[str, dict] = {}
        for coll in root.iter("Grid"):
            if coll.get("GridType") != "Collection":
                continue
            for step_grid in coll.findall("Grid"):
                t_el = step_grid.find("Time")
                if t_el is not None:
                    times.append(float(t_el.get("Value")))
                for attr in step_grid.findall("Attribute"):
                    name = attr.get("Name")
                    center = attr.get("Center", "Node")
                    item = attr.find("DataItem")
                    arr = np.asarray(_load_dataitem(item.text, base_dir,
                                                    h5_cache))
                    series.setdefault(name, {"center": center,
                                             "values": []})
                    series[name]["values"].append(arr)
        fields = {k: {"center": v["center"],
                      "values": np.stack(v["values"])}
                  for k, v in series.items()}
        return (points, topology, np.asarray(times, dtype=float), fields)
    finally:
        for fh in h5_cache.values():
            fh.close()


def _single_field(fields: dict, center: str):
    for name, rec in fields.items():
        if rec["center"].lower() == center:
            return name, rec["values"]
    raise ValueError(f"no {center}-centered field found")


def compute_cell_centroids(topology, points):
    """Reference PostProcessingTools.compute_cell_centroids."""
    return points[topology].mean(axis=1)


def read_cell_tensor_xdmf(xdmf_field_path: str):
    """Reference signature (:192-236): (centroids, time_list, tensor
    (n_steps, n_cells, 3, 3)) from any compatible XDMF file."""
    points, topo, times, fields = read_xdmf(xdmf_field_path)
    _, vals = _single_field(fields, "cell")
    n_cells = topo.shape[0]
    vals = vals.reshape(vals.shape[0], n_cells, 3, 3)
    return compute_cell_centroids(topo, points), times, vals


def read_cell_scalar_xdmf(xdmf_field_path: str):
    """Reference signature (:239-283)."""
    points, topo, times, fields = read_xdmf(xdmf_field_path)
    _, vals = _single_field(fields, "cell")
    return (compute_cell_centroids(topo, points), times,
            vals.reshape(vals.shape[0], topo.shape[0]))


def read_node_scalar_xdmf(xdmf_field_path: str):
    """Reference signature (:286-330)."""
    points, topo, times, fields = read_xdmf(xdmf_field_path)
    _, vals = _single_field(fields, "node")
    return points, times, vals.reshape(vals.shape[0], points.shape[0])


def read_node_vector_xdmf(xdmf_field_path: str):
    """Reference signature (:333-374)."""
    points, topo, times, fields = read_xdmf(xdmf_field_path)
    _, vals = _single_field(fields, "node")
    return points, times, vals.reshape(vals.shape[0], points.shape[0], -1)


def read_timeseries(output_folder: str, field_name: str):
    """Read a saved field time series.

    Returns (times, values, points, topology) where values has shape
    (n_steps, ...) matching the saved field layout.
    """
    h5path = os.path.join(output_folder, field_name, f"{field_name}.h5")
    with require_h5py().File(h5path, "r") as h5:
        points = h5["Mesh/geometry"][()]
        topology = h5["Mesh/topology"][()]
        grp = h5[f"Function/{field_name}"]
        steps = sorted(grp.keys(), key=int)
        values = np.stack([grp[s][()] for s in steps])
    times = _read_times(output_folder, field_name)
    if times is None or len(times) != values.shape[0]:
        times = np.arange(values.shape[0], dtype=float)
    return times, values, points, topology


def _read_times(output_folder, field_name):
    xdmf = os.path.join(output_folder, field_name, f"{field_name}.xdmf")
    if not os.path.isfile(xdmf):
        return None
    times = []
    with open(xdmf) as f:
        for line in f:
            line = line.strip()
            if line.startswith("<Time Value="):
                times.append(float(line.split('"')[1]))
    return np.asarray(times) if times else None


# ---------------------------------------------------------------------------
# Reference-compatible helpers (PostProcessingTools.py names)
# ---------------------------------------------------------------------------
def read_cell_scalar(output_folder, field_name):
    t, v, _, _ = read_timeseries(output_folder, field_name)
    return t, v


def read_cell_tensor(output_folder, field_name):
    t, v, _, _ = read_timeseries(output_folder, field_name)
    if v.ndim == 3 and v.shape[-1] == 9:
        v = v.reshape(v.shape[0], v.shape[1], 3, 3)
    return t, v


def read_node_scalar(output_folder, field_name):
    return read_cell_scalar(output_folder, field_name)


def read_node_vector(output_folder, field_name):
    t, v, _, _ = read_timeseries(output_folder, field_name)
    return t, v


def find_closest_node(points: np.ndarray, xyz) -> int:
    """Index of the mesh node closest to ``xyz`` (reference :109-189)."""
    d = np.linalg.norm(points - np.asarray(xyz)[None, :], axis=1)
    return int(np.argmin(d))


def find_closest_cell(points: np.ndarray, topology: np.ndarray, xyz) -> int:
    centroids = points[topology].mean(axis=1)
    d = np.linalg.norm(centroids - np.asarray(xyz)[None, :], axis=1)
    return int(np.argmin(d))


def probe_node_series(output_folder, field_name, xyz):
    """Time series of a nodal field at the node closest to ``xyz``."""
    t, v, points, _ = read_timeseries(output_folder, field_name)
    idx = find_closest_node(points, xyz)
    return t, v[:, idx]


def probe_cell_series(output_folder, field_name, xyz):
    """Time series of a cell field at the cell closest to ``xyz``."""
    t, v, points, topo = read_timeseries(output_folder, field_name)
    idx = find_closest_cell(points, topo, xyz)
    return t, v[:, idx]


def build_smoother(points: np.ndarray, topology: np.ndarray):
    """Volume-weighted cell->node and uniform node->cell averaging matrices
    as (apply_to_cells, apply_to_nodes) callables (reference :23-107)."""
    n_nodes = points.shape[0]
    n_elems = topology.shape[0]
    p = points[topology]
    e1 = p[:, 1] - p[:, 0]
    e2 = p[:, 2] - p[:, 0]
    e3 = p[:, 3] - p[:, 0]
    vol = np.abs((e1 * np.cross(e2, e3)).sum(axis=1)) / 6.0

    flat_nodes = topology.reshape(-1)
    flat_elems = np.repeat(np.arange(n_elems), 4)
    vol_sum = np.zeros(n_nodes)
    np.add.at(vol_sum, flat_nodes, vol[flat_elems])
    w = vol[flat_elems] / vol_sum[flat_nodes]

    def cells_to_nodes(q):
        out = np.zeros(n_nodes)
        np.add.at(out, flat_nodes, w * np.asarray(q)[flat_elems])
        return out

    def nodes_to_cells(q):
        return np.asarray(q)[topology].mean(axis=1)

    return cells_to_nodes, nodes_to_cells
