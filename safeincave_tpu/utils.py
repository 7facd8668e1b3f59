"""Tensor/Voigt utilities, unit constants, and small helpers.

JAX re-design of the reference utility layer
(/root/reference/safeincave/Utils.py:34-343).  The reference splits tensor
algebra between UFL symbolic expressions and batched torch; here everything is
batched JAX on arrays.

Voigt convention (identical to the reference, Utils.py:171-227):
    order  = [xx, yy, zz, xy, xz, yz]
    **tensorial** shear storage - NO engineering factors.  A 6x6 operator
    ``M`` contracted with a symmetric tensor in this convention is a plain
    matvec ``M @ v``; any factor-of-2 bookkeeping for shear lives inside the
    operator itself (see materials.base).
"""
from __future__ import annotations

import json
from typing import Callable

from . import jax_setup  # noqa: F401  (enables x64 before any tracing)
import jax.numpy as jnp
import numpy as np

# ---------------------------------------------------------------------------
# Unit constants (reference Utils.py:34-40)
# ---------------------------------------------------------------------------
GPa = 1e9
MPa = 1e6
kPa = 1e3
minute = 60
hour = 60 * minute
day = 24 * hour
year = 365 * day

# Voigt index pairs (i, j) for [xx, yy, zz, xy, xz, yz]
VOIGT_I = np.array([0, 1, 2, 0, 0, 1])
VOIGT_J = np.array([0, 1, 2, 1, 2, 2])

# Column/row scaling turning a single-entry derivative into the full symmetric
# tensor contraction:  df/dS : dS  =  sum_k  colfac[k] * df/dS_voigt[k] * dS_voigt[k]
# host-side constant: device arrays must not be created at import time
# (importing the package would then require an initialized backend)
# float32 on purpose: the values (1, 2) are exact in every float width, and
# numpy float32 * jax float64 still promotes to float64 - while float32
# computations (the mixed-precision fixed-point phase) stay float32 instead
# of being silently upcast by a float64 constant
VOIGT_WEIGHT = np.asarray([1.0, 1.0, 1.0, 2.0, 2.0, 2.0], dtype=np.float32)


def read_json(file_name: str) -> dict:
    """Read a JSON file into a dict (reference Utils.py:42-58)."""
    with open(file_name, "r") as j_file:
        return json.load(j_file)


def save_json(data: dict, file_name: str) -> None:
    """Save a dict as indented JSON (reference Utils.py:60-81)."""
    with open(file_name, "w") as f:
        json.dump(data, f, indent=4)


# ---------------------------------------------------------------------------
# Voigt maps (batched).  Shapes: tensor (..., 3, 3) <-> voigt (..., 6)
# ---------------------------------------------------------------------------
def tensor_to_voigt(e: jnp.ndarray) -> jnp.ndarray:
    """Map symmetric (..., 3, 3) tensors to (..., 6) tensorial-Voigt vectors.

    Mirrors reference Utils.py:171-197 (upper-triangular entries, no
    engineering shear factors).
    """
    return jnp.stack(
        [e[..., 0, 0], e[..., 1, 1], e[..., 2, 2],
         e[..., 0, 1], e[..., 0, 2], e[..., 1, 2]],
        axis=-1,
    )


def voigt_to_tensor(s: jnp.ndarray) -> jnp.ndarray:
    """Map (..., 6) tensorial-Voigt vectors to symmetric (..., 3, 3) tensors.

    Mirrors reference Utils.py:199-227.
    """
    xx, yy, zz, xy, xz, yz = (s[..., k] for k in range(6))
    row0 = jnp.stack([xx, xy, xz], axis=-1)
    row1 = jnp.stack([xy, yy, yz], axis=-1)
    row2 = jnp.stack([xz, yz, zz], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)


def dotdot(C_voigt: jnp.ndarray, eps: jnp.ndarray) -> jnp.ndarray:
    """sigma = C : eps for batched Voigt operators.

    Accepts ``eps`` either as (..., 6) Voigt or (..., 3, 3) tensor and returns
    the same layout.  Equivalent to reference ``dotdot_torch``
    (Utils.py:251-283): a plain batched matvec in tensorial Voigt.
    """
    if eps.shape[-1] == 6 and eps.ndim == C_voigt.ndim - 1:
        return jnp.einsum("...ij,...j->...i", C_voigt, eps)
    eps_v = tensor_to_voigt(eps)
    sig_v = jnp.einsum("...ij,...j->...i", C_voigt, eps_v)
    return voigt_to_tensor(sig_v)


def dev_voigt(s: jnp.ndarray) -> jnp.ndarray:
    """Deviatoric part of a (..., 6) Voigt tensor."""
    mean = (s[..., 0] + s[..., 1] + s[..., 2]) / 3.0
    out = s.at[..., 0].add(-mean)
    out = out.at[..., 1].add(-mean)
    out = out.at[..., 2].add(-mean)
    return out


def trace_voigt(s: jnp.ndarray) -> jnp.ndarray:
    return s[..., 0] + s[..., 1] + s[..., 2]


def norm_voigt(s: jnp.ndarray) -> jnp.ndarray:
    """Frobenius norm of the symmetric tensor represented by (..., 6) Voigt."""
    sq = s * s
    return jnp.sqrt(sq[..., 0] + sq[..., 1] + sq[..., 2]
                    + 2.0 * (sq[..., 3] + sq[..., 4] + sq[..., 5]))


def von_mises_voigt(s: jnp.ndarray) -> jnp.ndarray:
    """Von Mises equivalent stress q = sqrt(3 J2) from (..., 6) Voigt."""
    xx, yy, zz, xy, xz, yz = (s[..., k] for k in range(6))
    return jnp.sqrt(0.5 * ((xx - yy) ** 2 + (xx - zz) ** 2 + (yy - zz) ** 2
                           + 6.0 * (xy ** 2 + xz ** 2 + yz ** 2)))


# ---------------------------------------------------------------------------
# Field sampling helpers (reference Utils.py:285-343, vectorized)
# ---------------------------------------------------------------------------
Fn = Callable[[float, float, float], float]


def create_field_nodes(grid, fun: Fn) -> jnp.ndarray:
    """Sample ``fun(x, y, z)`` at every mesh node (vectorized when possible)."""
    xyz = np.asarray(grid.points)
    try:
        vals = fun(xyz[:, 0], xyz[:, 1], xyz[:, 2])
        vals = np.broadcast_to(np.asarray(vals, dtype=np.float64), (xyz.shape[0],))
    except Exception:
        vals = np.array([fun(x, y, z) for x, y, z in xyz], dtype=np.float64)
    return jnp.asarray(vals)


def create_field_elems(grid, fun: Fn) -> jnp.ndarray:
    """Sample ``fun`` at tetrahedron centroids (vectorized when possible)."""
    cent = np.asarray(grid.centroids)
    try:
        vals = fun(cent[:, 0], cent[:, 1], cent[:, 2])
        vals = np.broadcast_to(np.asarray(vals, dtype=np.float64), (cent.shape[0],))
    except Exception:
        vals = np.array([fun(x, y, z) for x, y, z in cent], dtype=np.float64)
    return jnp.asarray(vals)


def find_grid(name: str, fallback: str | None = None) -> str:
    """Locate a grid fixture directory by name.

    Prefers the reference checkout's grids/ (full-resolution meshes) when
    mounted; otherwise falls back to the repo-owned fixtures under
    ``grids/`` (generated by grids/make_fixtures.py), using ``fallback``
    as the repo-side name when the reference mesh has no committed twin.

    Set ``SAFEINCAVE_NO_REFERENCE=1`` to ignore the reference mount even
    when present (CI mode proving the framework is self-contained:
    ``SAFEINCAVE_NO_REFERENCE=1 pytest -m "not slow"``).
    """
    import os as _os
    no_ref = _os.environ.get("SAFEINCAVE_NO_REFERENCE", "") == "1"
    ref = _os.path.join("/root", "reference", "grids", name)
    if not no_ref and _os.path.isfile(_os.path.join(ref, "geom.msh")):
        return ref
    repo_grids = _os.path.join(_os.path.dirname(_os.path.dirname(
        _os.path.abspath(__file__))), "grids")
    for cand in ([fallback] if fallback else []) + [name]:
        d = _os.path.join(repo_grids, cand)
        if _os.path.isfile(_os.path.join(d, "geom.msh")):
            return d
    # procedural shape library: any reference cavern_<family>_<vol>_3D name
    # is synthesized on demand (mesh/cavern_gen.py catalog) into grids/ -
    # the framework-owned answer to the reference's 43 committed gmsh
    # directories, with no gmsh install and no binary blobs in the repo
    from .mesh.cavern_gen import parse_grid_name, synthesize_grid
    if parse_grid_name(name) is not None:
        return synthesize_grid(name, repo_grids)
    raise FileNotFoundError(
        f"grid {name!r} not found (reference unmounted, no repo fixture, "
        f"and not a catalog shape; run grids/make_fixtures.py)")
