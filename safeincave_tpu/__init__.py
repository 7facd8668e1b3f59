"""safeincave_tpu - 3D salt-cavern geomechanics framework in JAX.

A from-scratch JAX/XLA re-design with the capabilities of SafeInCave
(reference mounted at /root/reference): tetrahedral FEM for quasi-static
momentum balance with a rich inelastic constitutive suite, one-way coupled
transient heat diffusion, matrix-free Krylov solvers, and SPMD sharding over
JAX device meshes in place of MPI domain decomposition.

Public API mirrors the reference package ``safeincave.__init__``
(/root/reference/safeincave/__init__.py:14-58) so reference users can migrate
with minimal changes.
"""
from . import jax_setup  # noqa: F401  (must run before any JAX tracing)

__version__ = "0.1.0"

from . import utils as Utils  # noqa: N812  (reference-compatible alias)
from .utils import GPa, MPa, kPa, minute, hour, day, year
from .materials import (
    Material, NonElasticElement, Spring, Thermoelastic,
    Viscoelastic, DislocationCreep, PressureSolutionCreep,
    ViscoplasticDesai, MohrCoulombViscoplastic, MatsuokaNakaiViscoplastic,
    MunsonDawsonCreep,
)
from .timecontrol import (TimeControllerBase, TimeController,
                          TimeControllerParabolic, TimeControllerFromList,
                          AdaptiveTimeController, build_time_list_by_dp_limit)
from .mesh import Grid, GridHandlerGMSH, GridBox, GridBoxRegions
from .fem import (LinearMomentumBase, LinearMomentum, HeatDiffusion,
                  SolverSettings)
from .bcs import MomentumBC, HeatBC
from .output import SaveFields, ScreenPrinter
from .simulators import Simulator_M, Simulator_Mout, Simulator_T, Simulator_TM
from .config import Simulator_GUI, run_from_json
from .matpoint import MaterialPointSimulator, TriaxialSimulator, calibrate
from .checkpoint import save_checkpoint, load_checkpoint
from .metrics import StepMetrics
from . import postproc as PostProcessingTools  # noqa: N812

__all__ = [
    "Utils", "GPa", "MPa", "kPa", "minute", "hour", "day", "year",
    "Material", "NonElasticElement", "Spring", "Thermoelastic",
    "Viscoelastic", "DislocationCreep", "PressureSolutionCreep",
    "ViscoplasticDesai", "MohrCoulombViscoplastic",
    "MatsuokaNakaiViscoplastic", "MunsonDawsonCreep",
    "TimeControllerBase", "TimeController", "TimeControllerParabolic",
    "TimeControllerFromList", "AdaptiveTimeController",
    "build_time_list_by_dp_limit",
    "Grid", "GridHandlerGMSH", "GridBox", "GridBoxRegions",
    "LinearMomentumBase", "LinearMomentum", "HeatDiffusion", "SolverSettings",
    "MomentumBC", "HeatBC", "SaveFields", "ScreenPrinter",
    "Simulator_M", "Simulator_Mout", "Simulator_T", "Simulator_TM",
    "Simulator_GUI", "run_from_json", "MaterialPointSimulator",
    "TriaxialSimulator", "calibrate",
    "PostProcessingTools", "save_checkpoint", "load_checkpoint", "StepMetrics",
]
