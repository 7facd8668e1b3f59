"""Console/log observability.

Reference: /root/reference/safeincave/ScreenOutput.py (singleton
``ScreenPrinter``: banner, mesh info, solver config, constitutive list,
outputs table, live per-step rows, transcript persisted to log.txt).  The MPI
rank gating becomes a ``jax.process_index() == 0`` check.
"""
from __future__ import annotations

import os
import time

import jax


def _is_main_process() -> bool:
    try:
        return jax.process_index() == 0
    except Exception:
        return True


class ScreenPrinter:
    """Step-table printer + log accumulator (reference ScreenOutput.py:26-571)."""

    _instance = None

    def __new__(cls, *args, **kwargs):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    @classmethod
    def reset_instance(cls):
        cls._instance = None

    def __init__(self, grid=None, solver=None, mat=None, outputs=None,
                 time_unit: str = "second"):
        self.grid = grid
        self.solver = solver
        self.mat = mat
        self.outputs = outputs or []
        self.time_unit = time_unit
        self.lines: list[str] = []
        self.t_start = time.time()
        self.header = ["step", f"dt ({time_unit})", f"t/t_final ({time_unit})",
                       "iters", "error"]
        self._emit_banner()

    # ------------------------------------------------------------------ #
    def _log(self, text: str = ""):
        self.lines.append(text)
        if _is_main_process():
            print(text, flush=True)

    def _emit_banner(self):
        self._log("=" * 78)
        self._log("  safeincave-tpu  |  salt-cavern geomechanics in JAX")
        self._log("=" * 78)
        if self.grid is not None:
            self._log(f"  mesh: {self.grid.n_nodes} nodes, "
                      f"{self.grid.n_elems} tets, "
                      f"{len(self.grid.get_boundary_names())} boundaries, "
                      f"{self.grid.n_regions} regions")
            devs = jax.devices()
            self._log(f"  devices: {len(devs)} x {devs[0].platform}")
            self._emit_partition_table(devs)
        if self.solver is not None:
            method = getattr(self.solver, "method", str(self.solver))
            rtol = getattr(self.solver, "rtol", "")
            self._log(f"  linear solver: {method} (jacobi), rtol={rtol}")
        if self.mat is not None and getattr(self.mat, "elems_ne", None) is not None:
            names = ", ".join(e.name for e in self.mat.elems_ne) or "none"
            self._log(f"  inelastic elements: {names}")
        for out in self.outputs:
            for field_name, label in getattr(out, "fields", []):
                self._log(f"  output: {field_name}  ({label})")
        self._log("-" * 78)
        self._log("  " + " | ".join(f"{h:>18s}" for h in self.header))
        self._log("-" * 78)

    def _emit_partition_table(self, devs):
        """Per-partition element/node counts (the reference's send/recv
        partition table, ScreenOutput.py:179-210).  Partition metadata
        comes from the grid's RCB parts when a reordered/partitioned grid
        is in use; single-device grids list one partition."""
        parts = getattr(self.grid, "elem_parts", None)
        if parts is None:
            return
        import numpy as np
        parts = np.asarray(parts)
        conn = np.asarray(self.grid.conn)
        self._log("  partitions:   #     elements     nodes(touched)")
        for d in range(int(parts.max()) + 1):
            sel = parts == d
            n_nodes_d = len(np.unique(conn[sel]))
            self._log(f"               {d + 1:2d}   {int(sel.sum()):9d}"
                      f"     {n_nodes_d:9d}")

    def print_row(self, row):
        cells = []
        for v in row:
            if isinstance(v, float):
                cells.append(f"{v:>18.6g}")
            else:
                cells.append(f"{str(v):>18s}")
        self._log("  " + " | ".join(cells))

    def start_timer(self):
        self.t_start = time.time()

    def close(self):
        elapsed = time.time() - self.t_start
        self._log("-" * 78)
        self._log(f"  wall-clock: {elapsed:.2f} s")
        if _is_main_process():
            for out in self.outputs:
                folder = getattr(out, "output_folder", None)
                if folder:
                    os.makedirs(folder, exist_ok=True)
                    with open(os.path.join(folder, "log.txt"), "w") as f:
                        f.write("\n".join(self.lines) + "\n")
