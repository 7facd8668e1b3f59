"""Creep and viscoelastic elements.

Reference models:
* Viscoelastic (Kelvin-Voigt)   /root/reference/safeincave/MaterialProps.py:795-885
* DislocationCreep              :890-961
* PressureSolutionCreep         :964-1034
* MunsonDawsonCreep             :1971-2346

All rates are per-element pure functions of the tensorial-Voigt stress
(SafeInCave sign convention, Pa); tangents are exact autodiff Jacobians where
the reference used finite differences.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..linalg import inv6x6_fast
from ..utils import VOIGT_WEIGHT, voigt_to_tensor
from .base import NonElasticElement, apply66, _as_voigt
from .elastic import isotropic_C

_R_GAS = 8.32  # gas constant value used by the reference (MaterialProps.py:915)


# float32 constant: exact values, and float64 inputs still promote to
# float64 while float32 (mixed-precision phase) inputs stay float32
_ISO6_DEV = np.asarray([1., 1., 1., 0., 0., 0.], dtype=np.float32)


def _dev6(sv6):
    mean = (sv6[0] + sv6[1] + sv6[2]) / 3.0
    return sv6 - mean * _ISO6_DEV


def _von_mises6(sv6):
    xx, yy, zz, xy, xz, yz = sv6
    return jnp.sqrt(0.5 * ((xx - yy) ** 2 + (xx - zz) ** 2 + (yy - zz) ** 2
                           + 6.0 * (xy ** 2 + xz ** 2 + yz ** 2)))


def _von_mises6_floor(sv6, floor):
    """Von Mises with a floor applied *inside* the sqrt so the derivative is
    finite at zero deviatoric stress (sqrt(max(x, f^2)) == max(sqrt(x), f)).

    In float32 the squared floor must stay above the underflow threshold or
    the guard silently vanishes (1e-30^2 flushes to 0) and the autodiff
    derivative at zero deviatoric stress becomes NaN."""
    if sv6.dtype == jnp.float32:
        floor = max(floor, 1e-15)
    xx, yy, zz, xy, xz, yz = sv6
    arg = 0.5 * ((xx - yy) ** 2 + (xx - zz) ** 2 + (yy - zz) ** 2
                 + 6.0 * (xy ** 2 + xz ** 2 + yz ** 2))
    return jnp.sqrt(jnp.maximum(arg, floor * floor))


class DislocationCreep(NonElasticElement):
    """Power-law creep: rate = A exp(-Q/RT) q^(n-1) s  (reference :890-961)."""

    def __init__(self, A, Q, n, name: str = "creep"):
        A = np.asarray(A, dtype=np.float64)
        super().__init__(A.shape[0], name)
        self.params = {
            "A": A,
            "Q": np.asarray(Q, dtype=np.float64),
            "n": np.asarray(n, dtype=np.float64),
        }
        self.R = _R_GAS

    def _rate_one(self, sv6, isv, T, p):
        dev = _dev6(sv6)
        # tiny floor keeps d(q^(n-1))/d(sigma) finite at zero deviatoric
        # stress (the reference's FD probe is finite there too); the floor is
        # far below any physical stress so rates are unchanged.
        q = _von_mises6_floor(sv6, 1e-30)
        # log-space: q**(n-1) alone can exceed the float32 exponent range
        # (~1e38) of the f32 fixed-point phase for n >= 5.5 at cavern
        # stresses
        A_bar = jnp.exp(jnp.log(p["A"]) - p["Q"] / _R_GAS / T
                        + (p["n"] - 1.0) * jnp.log(q))
        return A_bar * dev


class PressureSolutionCreep(NonElasticElement):
    """Linear creep: rate = (A/(d^3 T)) exp(-Q/RT) s  (reference :964-1034)."""

    def __init__(self, A, d, Q, name: str = "creep"):
        A = np.asarray(A, dtype=np.float64)
        super().__init__(A.shape[0], name)
        self.params = {
            "A": A,
            "d": np.asarray(d, dtype=np.float64),
            "Q": np.asarray(Q, dtype=np.float64),
        }
        self.R = _R_GAS

    def _rate_one(self, sv6, isv, T, p):
        dev = _dev6(sv6)
        A_bar = (p["A"] / p["d"] ** 3 / T) * jnp.exp(-p["Q"] / _R_GAS / T)
        return A_bar * dev


class Viscoelastic(NonElasticElement):
    """Kelvin-Voigt viscoelasticity (reference :795-885).

    rate = G : (sigma - C1 : (eps_old + phi1 * rate_old)), with the
    closed-form tangent E = (eta I + phi2 C1)^-1 (reference :861-885).
    """

    def __init__(self, eta, E, nu, name: str = "kelvin_voigt"):
        E = np.asarray(E, dtype=np.float64)
        super().__init__(E.shape[0], name)
        self.params = {
            "eta": np.asarray(eta, dtype=np.float64),
            "E": E,
            "nu": np.asarray(nu, dtype=np.float64),
        }
        self.C1 = isotropic_C(E, self.params["nu"])

    def _C1_for(self, dtype):
        if dtype == jnp.float32:
            if not hasattr(self, "_C1_32"):
                self._C1_32 = self.C1.astype(jnp.float32)
            return self._C1_32
        return self.C1

    def f_tangent(self, state, sv6, T, dt, theta):
        phi2 = dt * (1 - theta)
        p = self._p(sv6.dtype)
        eye = jnp.eye(6, dtype=sv6.dtype)
        mat = p["eta"][:, None, None] * eye + phi2 * self._C1_for(sv6.dtype)
        E_op, _ = inv6x6_fast(mat)
        new = dict(state)
        new["G"] = E_op
        new["B"] = jnp.zeros_like(state["B"])
        return new

    def f_rate_value(self, state, sv6, phi1, T):
        hist = state["eps_old"] + phi1 * state["rate_old"]
        drive = sv6 - apply66(self._C1_for(sv6.dtype), hist)
        return apply66(state["G"], drive)


class MunsonDawsonCreep(NonElasticElement):
    """Munson-Dawson transient + steady-state creep with ISV zeta.

    Reference: MaterialProps.py:1971-2346.  The zeta update is linearized into
    the global iteration with the same (r, h, Q, P) consistent-tangent pattern
    as ViscoplasticDesai, but with exact derivatives instead of FD probes.
    Stress enters in Pa (no MPa scaling, no sign flip) exactly as in the
    reference ``_compute_md_fields`` (:2095-2155).
    """

    H_MIN = 1e-12  # ill-conditioning guard on h = dr/dzeta (reference :2262)

    def __init__(self, A, Q, n, K0, c, m, alpha_w, beta_w, delta, mu,
                 name: str = "creep_munson_dawson"):
        A = np.asarray(A, dtype=np.float64)
        super().__init__(A.shape[0], name)
        as64 = lambda x: np.asarray(x, dtype=np.float64)
        self.params = {
            "A": A, "Q": as64(Q), "n": as64(n), "K0": as64(K0), "c": as64(c),
            "m": as64(m), "alpha_w": as64(alpha_w), "beta_w": as64(beta_w),
            "delta": as64(delta), "mu": as64(mu),
        }
        self.R = _R_GAS
        import numpy as _np
        n_el = self.n_elems
        z = jnp.asarray(_np.zeros(n_el))
        ones = jnp.asarray(_np.ones(n_el))
        self.state.update({
            "zeta": z,
            "zeta_old": z,
            "F": ones,
            "eps_t_star": ones,
            "r": z,
            "h": ones,
            "P": jnp.asarray(_np.zeros((n_el, 6))),
            "h_small": jnp.asarray(_np.zeros(n_el, dtype=bool)),
        })

    # -- per-element physics (reference _compute_md_fields :2095-2155) ----- #
    @staticmethod
    def _md_fields_one(sv6, zeta, T, p):
        dev = _dev6(sv6)
        # 1 Pa floor (:2131), applied inside the sqrt for a finite derivative
        sigma_safe = _von_mises6_floor(sv6, 1.0)
        mu_safe = jnp.maximum(p["mu"], 1.0)

        # log-space steady-state rate (sigma^n alone can overflow float32)
        epsdot_ss = jnp.exp(jnp.log(p["A"]) - p["Q"] / (_R_GAS * T)
                            + p["n"] * jnp.log(sigma_safe))

        ratio = jnp.maximum(sigma_safe / mu_safe, 1e-30)
        eps_t_star = p["K0"] * jnp.exp(p["c"] * T) * ratio ** p["m"]
        # float32: 1e-50 flushes to zero and zeta/eps_t_star would blow up
        e_floor = 1e-50 if sv6.dtype != jnp.float32 else 1e-30
        eps_t_star = jnp.maximum(eps_t_star, e_floor)

        delta_cap = p["alpha_w"] + p["beta_w"] * jnp.log10(ratio)
        r_arg2 = (1.0 - zeta / eps_t_star) ** 2
        exp_hard = jnp.clip(delta_cap * r_arg2, -50.0, 50.0)     # (:2150)
        exp_recov = jnp.clip(-p["delta"] * r_arg2, -50.0, 50.0)
        F = jnp.where(zeta <= eps_t_star, jnp.exp(exp_hard), jnp.exp(exp_recov))
        return dev, sigma_safe, epsdot_ss, eps_t_star, F

    @staticmethod
    def _rate_one_static(sv6, zeta, T, p):
        dev, sigma_safe, epsdot_ss, _, F = MunsonDawsonCreep._md_fields_one(
            sv6, zeta, T, p)
        return (F * epsdot_ss) * (1.5 / sigma_safe) * dev

    @staticmethod
    def _residue_one(sv6, zeta, zeta_old, T, dt, p):
        """Backward-Euler residue r = zeta - zeta_old - (F-1) epsdot_ss dt (:2157-2169)."""
        _, _, epsdot_ss, _, F = MunsonDawsonCreep._md_fields_one(sv6, zeta, T, p)
        return zeta - zeta_old - (F - 1.0) * epsdot_ss * dt

    # -- element protocol -------------------------------------------------- #
    def _isv_slice(self, state):
        return {"zeta": state["zeta"]}

    def _rate_one(self, sv6, isv, T, p):
        return self._rate_one_static(sv6, isv["zeta"], T, p)

    def f_rate(self, state, sv6, phi1, T):
        new = dict(state)
        rate, eps_t_star, F = jax.vmap(
            lambda s, z, t, p: (
                self._rate_one_static(s, z, t, p),
                self._md_fields_one(s, z, t, p)[3],
                self._md_fields_one(s, z, t, p)[4],
            ),
            in_axes=(0, 0, 0, 0))(sv6, state["zeta"], T,
                                  self._p(sv6.dtype))
        new["rate"] = rate
        new["eps_t_star"] = eps_t_star
        new["F"] = F
        return new

    def f_tangent(self, state, sv6, T, dt, theta):
        """Exact (r, h, Q, P) consistent tangent (reference :2217-2292)."""
        zeta, zeta_old = state["zeta"], state["zeta_old"]

        def res_of_zeta(s, z, zo, t, p):
            return self._residue_one(s, z, zo, t, dt, p)

        pp = self._p(sv6.dtype)
        r = jax.vmap(res_of_zeta, in_axes=(0, 0, 0, 0, 0))(
            sv6, zeta, zeta_old, T, pp)
        h = jax.vmap(jax.grad(res_of_zeta, argnums=1), in_axes=(0, 0, 0, 0, 0))(
            sv6, zeta, zeta_old, T, pp)
        Q = jax.vmap(jax.jacfwd(self._rate_one_static, argnums=1),
                     in_axes=(0, 0, 0, 0))(sv6, zeta, T, pp)
        P = jax.vmap(jax.grad(res_of_zeta, argnums=0), in_axes=(0, 0, 0, 0, 0))(
            sv6, zeta, zeta_old, T, pp)

        h_small = jnp.abs(h) < self.H_MIN
        h = jnp.where(h_small, 1.0, h)
        B = (r / h)[:, None] * Q

        # H = Q (outer) P in tensorial Voigt with doubled shear columns (:2294-2346)
        H = Q[:, :, None] * (P * VOIGT_WEIGHT)[:, None, :]
        H_over_h = H / h[:, None, None]

        E = self._E_exact(sv6, {"zeta": zeta}, T)

        zero = h_small[:, None]
        B = jnp.where(zero, 0.0, B)
        P = jnp.where(zero, 0.0, P)
        H_over_h = jnp.where(h_small[:, None, None], 0.0, H_over_h)

        new = dict(state)
        new["G"] = E - H_over_h
        new["B"] = B
        new["r"] = r
        new["h"] = h
        new["P"] = P
        new["h_small"] = h_small
        return new

    def f_increment_isv(self, state, sv6, sv6_k, dt):
        """delta_zeta = -(r + P:(sigma - sigma_k)) / h, clamped >= 0 (:2071-2089)."""
        dsig = sv6 - sv6_k
        pd = jnp.sum(state["P"] * VOIGT_WEIGHT * dsig, axis=-1)
        delta = -(state["r"] + pd) / state["h"]
        delta = jnp.where(state["h_small"], 0.0, delta)
        new = dict(state)
        new["zeta"] = jnp.maximum(state["zeta"] + delta, 0.0)
        return new

    def f_commit_isv(self, state):
        new = dict(state)
        new["zeta_old"] = state["zeta"]
        return new

    # -- reference-style views --------------------------------------------- #
    @property
    def zeta(self):
        return self.state["zeta"]

    @property
    def zeta_old(self):
        return self.state["zeta_old"]

    @property
    def F(self):
        return self.state["F"]

    @property
    def P(self):
        return voigt_to_tensor(self.state["P"])

    @property
    def r(self):
        return self.state["r"]

    @property
    def h(self):
        return self.state["h"]

    # reference-compatible helpers
    def update_internal_variables(self):
        self.state = self.f_commit_isv(self.state)

    def compute_residue(self, stress, zeta, Temp, dt):
        sv6 = _as_voigt(stress)
        return jax.vmap(self._residue_one, in_axes=(0, 0, 0, 0, None, 0))(
            sv6, jnp.asarray(zeta), self.state["zeta_old"],
            jnp.asarray(Temp), dt, self.params)
