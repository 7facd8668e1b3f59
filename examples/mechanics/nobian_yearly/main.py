"""Full yearly production scenario: equilibrium -> 365-day CSV operation.

This is the reference's nobian production workflow end-to-end
(/root/reference/examples/mechanics/nobian/Simulation/run_interlayer.py:
163-236 stage flow, :396-763 CSV operational years, :1194-1241 per-region
constitutive masking) on the rebuilt JAX stack:

* heterogeneous cavern mesh: revolved cavern profile + two dipping
  interlayer bands (CI scale: generated in-process by GridCavern;
  ``--full``: the repo-owned 38k-tet grids/cavern_interlayer_1200
  production mesh with its Overburden cap);
* dislocation-creep salt + Mohr-Coulomb viscoplastic interlayers, masked
  per region (the reference's zero-prefactor idiom);
* stage 1 geostatic equilibrium: constant brine-column cavern pressure,
  coarse dt, creep rates settling (run_interlayer.py equilibrium stage);
* stage 2 operation: a full 365-day hourly CSV pressure year
  (data/operational_year.csv, `druk_mpa` column, decimal commas) applied
  with schedules.build_csv_pressure_schedule in 'stretch' or 'repeat'
  mode, hydrostatic depth correction on the cavern wall;
* StepMetrics JSONL + sparse XDMF saves + periodic checkpoints; fused
  multi-step device dispatches between output boundaries;
* ``--resume <ckpt>`` restarts mid-year from a checkpoint and continues
  to year end (capability the reference lacks; checkpoint.py).

Run (CI scale, ~2 min CPU):     python main.py --days 365 --dt-days 2
Full scale (GPU, documented):   python main.py --full --days 365
                                  --dt-hours 6
Resume:                         python main.py --resume output/
                                  nobian_yearly/checkpoint.npz
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "..", ".."))

import safeincave_tpu as sc
import safeincave_tpu.schedules as schedules
from safeincave_tpu.metrics import StepMetrics
from safeincave_tpu.utils import GPa, MPa, day, hour, find_grid

momBC = sc.MomentumBC
HERE = os.path.dirname(os.path.abspath(__file__))
CSV = os.path.join(HERE, "data", "operational_year.csv")


def build(full=False, mesh_n=8):
    """Mesh + material + equation (region-masked constitutive suite)."""
    if full:
        grid = sc.GridHandlerGMSH("geom", find_grid("cavern_interlayer_1200"),
                                  reorder="band")
    else:
        from safeincave_tpu.mesh.cavern_gen import (GridCavern,
                                                    InterlayerBand)
        grid = GridCavern(L=450.0, H=660.0, n=mesh_n,
                          interlayers=[InterlayerBand(250.0, 40.0,
                                                      dip_deg=8.0),
                                       InterlayerBand(430.0, 35.0,
                                                      dip_deg=-5.0)],
                          overburden_from=560.0)
    regions = grid.get_subdomain_names()

    def per_region(salt_val, inter_val, over_val):
        return np.asarray(grid.get_parameter(
            {r: (inter_val if "nterlayer" in r
                 else over_val if "verburden" in r else salt_val)
             for r in regions}))

    n = grid.n_elems
    one = np.ones(n)
    inter = per_region(0.0, 1.0, 0.0)
    salt = per_region(1.0, 0.0, 0.0)

    eq = sc.LinearMomentum(grid, theta=0.5)
    eq.set_solver(sc.SolverSettings(method="bicgstab", rtol=1e-12,
                                    max_it=400, coarse_agg=8))

    mat = sc.Material(n)
    mat.set_density(per_region(2200.0, 2900.0, 2500.0))
    mat.add_to_elastic(sc.Spring(per_region(102, 70, 35) * GPa,
                                 per_region(0.30, 0.27, 0.25)))
    mat.add_to_non_elastic(sc.Viscoelastic(
        per_region(105e11, 105e13, 105e13), 10 * GPa * one, 0.32 * one))
    # dislocation creep in the salt only (zero prefactor masks the
    # interlayers and overburden - run_interlayer.py:1194-1241 idiom)
    mat.add_to_non_elastic(sc.DislocationCreep(
        1.9e-20 * salt, 51600 * one, 3.0 * one, name="ds_creep"))
    # Mohr-Coulomb viscoplastic interlayers (zero fluidity elsewhere)
    mat.add_to_non_elastic(sc.MohrCoulombViscoplastic(
        mu_1=1e-9 * inter, N_1=1.0 * one, cohesion=4.0 * one,
        friction_angle=np.radians(35.0) * one,
        dilation_angle=0.0 * one, sigma_t=1.0 * one,
        name="mc_interlayer"))
    eq.set_material(mat)
    eq.set_T0(298.0 * one)
    eq.set_T(298.0 * one)
    eq.build_body_force([0.0, 0.0, 0.0])
    return grid, eq


def set_bcs(eq, grid, t_vals, p_vals, p_top_pa):
    """Roller sides, overburden load on Top, schedule on the cavern wall
    with the hydrostatic gas-column depth correction (reference
    applied_pressure idiom: p(t) + rho g (H_ref - z), 4_cavern
    conventions: rho ~ 8 kg/m3 gas column, reference at the cavern top)."""
    names = grid.get_boundary_names()
    cav_tris = grid.tris[grid.get_boundary_tags("Cavern")]
    z_cav_top = float(grid.points[np.unique(cav_tris)][:, 2].max())
    bc = momBC.BcHandler(eq)
    tv = [0.0, max(t_vals[-1], 1.0)]
    for nm, comp in (("West", 0), ("East", 0), ("South", 1), ("North", 1),
                     ("Bottom", 2)):
        if nm in names:
            bc.add_boundary_condition(momBC.DirichletBC(nm, comp,
                                                        [0., 0.], tv))
    if "Top" in names:
        bc.add_boundary_condition(momBC.NeumannBC(
            "Top", 2, 0.0, 0.0, [p_top_pa, p_top_pa], tv, g=0.0))
    bc.add_boundary_condition(momBC.NeumannBC(
        "Cavern", 2, 8.02, z_cav_top, list(p_vals), list(t_vals), g=-9.81))
    eq.set_boundary_conditions(bc)


def run_equilibrium(eq, grid, out_root, p_eq_pa, days=30.0, dt_days=5.0):
    """Stage 1: geostatic equilibrium at constant cavern pressure."""
    tc = sc.TimeController(dt=dt_days, initial_time=0.0, final_time=days,
                           time_unit="day")
    set_bcs(eq, grid, [0.0, tc.t_final], [p_eq_pa, p_eq_pa], 15 * MPa)
    out = sc.SaveFields(eq)
    out.set_output_folder(os.path.join(out_root, "equilibrium"))
    out.add_output_field("u", "Displacement (m)")
    sim = sc.Simulator_M(eq, tc, [out], compute_elastic_response=True)
    sim.run()


def run_operation(eq, grid, out_root, days, dt_hours, mode, resume_from=None,
                  save_every=8, checkpoint_every=32, elastic_init=False):
    """Stage 2: the CSV operational year (optionally resumed mid-year)."""
    tc = sc.TimeController(dt=dt_hours, initial_time=0.0,
                           final_time=days * 24.0, time_unit="hour")
    # rescale the raw 6-14 MPa record into the 7-12 MPa permit window
    # (run_interlayer.py:674-681 rescale workflow): the cavern band must
    # stay comfortably below the 15 MPa overburden or the roof goes into
    # tension and the MC cut-off flow cannot settle
    t_vals, p_vals = schedules.build_csv_pressure_schedule(
        tc, CSV, days=days, mode=mode, total_cycles=1,
        rescale=True, rescale_min=7.0, rescale_max=12.0)
    # 15 MPa overburden keeps the 6-14 MPa operational window
    # sub-lithostatic (a super-lithostatic cavern drives the MC
    # interlayers into tension cut-off flow and grinds convergence)
    set_bcs(eq, grid, t_vals, p_vals, 15 * MPa)

    ckpt = os.path.join(out_root, "checkpoint.npz")
    if resume_from:
        sc.load_checkpoint(resume_from, eq, tc)
        print(f"resumed from {resume_from} at t={tc.t/hour:.1f} h "
              f"(step {tc.step_counter})")

    # sparse XDMF saves: SaveFields(save_every=N) keeps every N-th call
    # (the reference Munsondawson.py:235-247 sparse-output idiom), and its
    # calls_until_next_keep() lets the fused-chunk planner align device
    # dispatches with write boundaries
    out = sc.SaveFields(eq, save_every=save_every)
    out.set_output_folder(os.path.join(out_root, "operation"))
    out.add_output_field("u", "Displacement (m)")
    out.add_output_field("q_elems", "Von Mises (Pa)")
    metrics = StepMetrics(os.path.join(out_root, "metrics.jsonl"))
    sim = sc.Simulator_M(eq, tc, [out],
                         compute_elastic_response=(elastic_init
                                                   and not resume_from),
                         metrics=metrics,
                         checkpoint_every=checkpoint_every,
                         checkpoint_path=ckpt)
    sim.run()
    metrics.close()
    return metrics.summary()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--days", type=float, default=365.0)
    ap.add_argument("--dt-hours", type=float, default=None)
    ap.add_argument("--dt-days", type=float, default=2.0,
                    help="CI-scale step (used when --dt-hours not given)")
    ap.add_argument("--mode", choices=["stretch", "repeat", "direct"],
                    default="direct")
    ap.add_argument("--mesh-n", type=int, default=8,
                    help="CI-scale mesh resolution")
    ap.add_argument("--full", action="store_true",
                    help="run on grids/cavern_interlayer_1200 (GPU scale)")
    ap.add_argument("--resume", default=None,
                    help="checkpoint .npz to resume the operation stage from")
    ap.add_argument("--skip-equilibrium", action="store_true")
    ap.add_argument("--out", default=os.path.join(HERE, "output",
                                                  "nobian_yearly"))
    args = ap.parse_args(argv)
    dt_hours = args.dt_hours or args.dt_days * 24.0

    grid, eq = build(full=args.full, mesh_n=args.mesh_n)
    p_eq = 10 * MPa
    did_equilibrium = not (args.resume or args.skip_equilibrium)
    if did_equilibrium:
        run_equilibrium(eq, grid, args.out, p_eq)
    summary = run_operation(eq, grid, args.out, args.days, dt_hours,
                            args.mode, resume_from=args.resume,
                            elastic_init=not did_equilibrium)
    print("operation summary:", summary)
    return summary


if __name__ == "__main__":
    main()
