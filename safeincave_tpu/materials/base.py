"""Shared machinery for inelastic constitutive elements.

Functional re-design of the reference ``NonElasticElement`` ABC
(/root/reference/safeincave/MaterialProps.py:543-789).

Every element keeps its per-element state in a dict of JAX arrays
(``self.state``) with Voigt ``(N, 6)`` strain storage:

==============  =========  =====================================================
key             shape      meaning (reference attribute)
==============  =========  =====================================================
``rate``        (N, 6)     eps_ne_rate
``rate_old``    (N, 6)     eps_ne_rate_old
``eps_old``     (N, 6)     eps_ne_old
``eps_k``       (N, 6)     eps_ne_k (theta-scheme predictor)
``G``           (N, 6, 6)  tangent-like operator G = E - H/h
``B``           (N, 6)     ISV driving term B (3x3 in the reference)
==============  =========  =====================================================

plus model-specific internal state variables (Desai: alpha/qsi/...,
Munson-Dawson: zeta/...).

The OO methods mirror the reference API (``compute_G_B``,
``compute_eps_ne_rate``, ...) by delegating to pure ``f_*`` functions that map
``state -> state``; the jitted simulation step uses the ``f_*`` functions
directly on state pytrees.

Tangent operators
-----------------
The reference builds ``E = d(eps_ne_rate)/d(sigma)`` by 12 finite-difference
rate evaluations with a factor 2 on shear columns
(MaterialProps.py:640-675).  Because every rate law reads only the
upper-triangular stress entries, that FD equals the derivative w.r.t. the
tensorial-Voigt stress vector with shear columns doubled.  Here it is computed
exactly: ``E = vmap(jacfwd(rate_one)) * diag_col(1,1,1,2,2,2)``.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..utils import (VOIGT_WEIGHT, tensor_to_voigt, voigt_to_tensor)


def apply66(M, v):
    """Batched Voigt 6x6 apply M @ v for M (E,6,6), v (E,6), full-lane.

    einsum('nij,nj->ni', ...) lowers to E tiny matmuls; transposing to the
    stacked (6,6,E) layout and doing a broadcast-multiply-reduce keeps the
    element axis as the long contiguous axis (see fem/kernels.py module
    docstring).
    """
    return (jnp.transpose(M, (1, 2, 0)) * v.T[None]).sum(1).T


def _as_voigt(stress) -> jnp.ndarray:
    """Accept (N, 3, 3) tensors (reference API) or (N, 6) Voigt arrays."""
    stress = jnp.asarray(stress, dtype=jnp.float64)
    if stress.ndim >= 2 and stress.shape[-1] == 3 and stress.shape[-2] == 3:
        return tensor_to_voigt(stress)
    return stress


class NonElasticElement:
    """Base for inelastic mechanisms (creep / viscoelastic / viscoplastic)."""

    def __init__(self, n_elems: int, name: str):
        self.n_elems = n_elems
        self.name = name
        self.params: dict = {}
        z6 = jnp.asarray(np.zeros((n_elems, 6)))
        self.state: dict = {
            "rate": z6,
            "rate_old": z6,
            "eps_old": z6,
            "eps_k": z6,
            "G": jnp.asarray(np.zeros((n_elems, 6, 6))),
            "B": z6,
        }

    # ------------------------------------------------------------------ #
    # Model hooks (override in subclasses)
    # ------------------------------------------------------------------ #
    def _rate_one(self, sv6, isv, T, p):
        """Per-element strain rate: (6,) Voigt -> (6,) Voigt.

        ``isv`` is a dict of per-element internal scalars (possibly empty),
        ``p`` the per-element parameter dict.
        """
        raise NotImplementedError

    def _isv_slice(self, state):
        """Internal variables (dict of (N,) arrays) consumed by `_rate_one`."""
        return {}

    # ------------------------------------------------------------------ #
    # Batched rate + exact tangent helpers
    # ------------------------------------------------------------------ #
    def _p(self, dtype):
        """Parameter dict matched to the compute dtype.

        The stored parameters are float64 numpy; multiplying them into a
        float32 computation would silently promote everything back to
        float64.  The mixed-precision fixed-point
        phase therefore computes with a float32 shadow of the parameters.
        """
        if dtype == jnp.float32:
            if not hasattr(self, "_params32"):
                self._params32 = {k: np.asarray(v, dtype=np.float32)
                                  for k, v in self.params.items()}
            return self._params32
        return self.params

    def _rate_batched(self, sv6, isv, T):
        return jax.vmap(self._rate_one, in_axes=(0, 0, 0, 0))(
            sv6, isv, T, self._p(sv6.dtype))

    def _E_exact(self, sv6, isv, T):
        """Exact E = d(rate)/d(sigma_voigt) with doubled shear columns.

        Replaces the FD probe of reference MaterialProps.py:640-675.
        """
        jac = jax.vmap(jax.jacfwd(self._rate_one, argnums=0),
                       in_axes=(0, 0, 0, 0))(sv6, isv, T, self._p(sv6.dtype))
        return jac * VOIGT_WEIGHT  # broadcasts over trailing (column) axis

    # ------------------------------------------------------------------ #
    # Pure-functional API (state pytree -> state pytree)
    # ------------------------------------------------------------------ #
    def f_rate_value(self, state, sv6, phi1, T):
        """Rate without state mutation (the reference's return_eps_ne=True)."""
        return self._rate_batched(sv6, self._isv_slice(state), T)

    def f_rate(self, state, sv6, phi1, T):
        """Compute and store the rate (reference compute_eps_ne_rate)."""
        new = dict(state)
        new["rate"] = self.f_rate_value(state, sv6, phi1, T)
        return new

    def f_tangent(self, state, sv6, T, dt, theta):
        """Assemble G (and B) - reference compute_G_B (MaterialProps.py:707-728).

        Default: B = 0, H/h = 0 (no internal state variable coupling), so
        ``G = E``.
        """
        new = dict(state)
        new["G"] = self._E_exact(sv6, self._isv_slice(state), T)
        new["B"] = jnp.zeros_like(state["B"])
        return new

    def f_eps_k(self, state, phi1, phi2):
        """theta-scheme predictor (reference compute_eps_ne_k, :586-605)."""
        new = dict(state)
        new["eps_k"] = (state["eps_old"] + phi1 * state["rate_old"]
                        + phi2 * state["rate"])
        return new

    def f_update_eps_old(self, state, sv6, sv6_k, phi2):
        """Corrector for committed inelastic strain (reference :607-628).

        eps_old <- eps_k + phi2 * G:(sigma - sigma_k) - phi2 * B
        (G already carries the doubled shear columns, so the contraction is a
        plain Voigt matvec, exactly like ``dotdot_torch``.)
        """
        new = dict(state)
        dG = apply66(state["G"], sv6 - sv6_k)
        new["eps_old"] = state["eps_k"] + phi2 * dG - phi2 * state["B"]
        return new

    def f_rate_to_old(self, state):
        new = dict(state)
        new["rate_old"] = state["rate"]
        return new

    def f_increment_isv(self, state, sv6, sv6_k, dt):
        """Linearized ISV increment inside the global iteration (default: none)."""
        return state

    def f_commit_isv(self, state):
        """Commit ISVs at the end of a converged step (default: none)."""
        return state

    # ------------------------------------------------------------------ #
    # Volumetric/deviatoric splits (reference :730-789), Voigt-native
    # ------------------------------------------------------------------ #
    def f_T_IT(self, state):
        G = state["G"]
        colsum = G[:, 0, :] + G[:, 1, :] + G[:, 2, :]         # (N, 6)
        T_v = colsum * jnp.asarray([1., 1., 1., 0.5, 0.5, 0.5])
        IT = jnp.zeros_like(G)
        for r in range(3):
            IT = IT.at[:, r, :].set(colsum)
        new = dict(state)
        new["T"] = T_v
        new["IT"] = IT
        return new

    def f_Bvol_Tvol(self, state):
        new = dict(state)
        new["T_vol"] = state["T"][:, 0] + state["T"][:, 1] + state["T"][:, 2]
        new["B_vol"] = state["B"][:, 0] + state["B"][:, 1] + state["B"][:, 2]
        return new

    def f_Gtilde_Btilde(self, state):
        new = dict(state)
        new["G_tilde"] = state["G"] - state["IT"] / 3.0
        vol = state["B_vol"][:, None] / 3.0
        iso = jnp.asarray([1., 1., 1., 0., 0., 0.])
        new["B_tilde"] = state["B"] - vol * iso
        return new

    # ------------------------------------------------------------------ #
    # Reference-compatible mutating API
    # ------------------------------------------------------------------ #
    def compute_G_B(self, stress, dt, theta, Temp):
        self.state = self.f_tangent(self.state, _as_voigt(stress),
                                    jnp.asarray(Temp), dt, theta)

    def compute_eps_ne_rate(self, stress, phi1, Temp, return_eps_ne=False):
        sv6 = _as_voigt(stress)
        if return_eps_ne:
            return voigt_to_tensor(self.f_rate_value(self.state, sv6, phi1,
                                                     jnp.asarray(Temp)))
        self.state = self.f_rate(self.state, sv6, phi1, jnp.asarray(Temp))

    def compute_eps_ne_k(self, phi1, phi2):
        self.state = self.f_eps_k(self.state, phi1, phi2)

    def update_eps_ne_old(self, stress, stress_k, phi2):
        self.state = self.f_update_eps_old(self.state, _as_voigt(stress),
                                           _as_voigt(stress_k), phi2)

    def update_eps_ne_rate_old(self):
        self.state = self.f_rate_to_old(self.state)

    def increment_internal_variables(self, stress, stress_k, dt):
        self.state = self.f_increment_isv(self.state, _as_voigt(stress),
                                          _as_voigt(stress_k), dt)

    def update_internal_variables(self):
        self.state = self.f_commit_isv(self.state)

    def compute_T_IT(self):
        self.state = self.f_T_IT(self.state)

    def compute_Bvol_Tvol(self):
        self.state = self.f_Bvol_Tvol(self.state)

    def compute_Gtilde_Btilde(self):
        self.state = self.f_Gtilde_Btilde(self.state)

    # ------------------------------------------------------------------ #
    # Reference-style attribute views (tensor layout for tests / outputs)
    # ------------------------------------------------------------------ #
    @property
    def eps_ne_rate(self):
        return voigt_to_tensor(self.state["rate"])

    @property
    def eps_ne_rate_old(self):
        return voigt_to_tensor(self.state["rate_old"])

    @property
    def eps_ne_old(self):
        return voigt_to_tensor(self.state["eps_old"])

    @property
    def eps_ne_k(self):
        return voigt_to_tensor(self.state["eps_k"])

    @property
    def G(self):
        return self.state["G"]

    @property
    def B(self):
        return voigt_to_tensor(self.state["B"])
