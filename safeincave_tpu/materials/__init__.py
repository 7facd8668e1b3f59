"""Constitutive suite: batched, differentiable, Voigt-native JAX models.

Re-design of /root/reference/safeincave/MaterialProps.py for JAX:
state lives in tensorial-Voigt ``(N, 6)`` arrays, tangent operators are exact
``jacfwd`` Jacobians instead of finite differences, and every model exposes a
pure-functional core (``f_*`` methods on explicit state pytrees) so the whole
constitutive update can run inside a single jitted simulation step.
"""
from .base import NonElasticElement
from .elastic import Spring, Thermoelastic
from .material import Material
from .creep import DislocationCreep, PressureSolutionCreep, Viscoelastic, MunsonDawsonCreep
from .viscoplastic import ViscoplasticDesai, MohrCoulombViscoplastic, MatsuokaNakaiViscoplastic

__all__ = [
    "NonElasticElement", "Spring", "Thermoelastic", "Material",
    "DislocationCreep", "PressureSolutionCreep", "Viscoelastic",
    "MunsonDawsonCreep", "ViscoplasticDesai", "MohrCoulombViscoplastic",
    "MatsuokaNakaiViscoplastic",
]
