"""Fused multi-step driver (LinearMomentum.solve_time_steps).

Must reproduce the single-step path (solve_time_step + commit_time_step per
step) to f64 fusion-noise level (the same math compiled into one scanned
program reassociates differently, ~1e-13 relative), and must stop at the
first non-converged step leaving that step's entry state (the dt-retry
restore point)."""
import numpy as np
import jax.numpy as jnp
import pytest

import safeincave_tpu as sc
momBC = sc.MomentumBC


def _build(maxiter_cap=None):
    grid = sc.GridBox(Lx=1.0, Ly=1.0, Lz=1.0, nx=3, ny=3, nz=3)
    eq = sc.LinearMomentum(grid, theta=0.5)
    eq.set_solver(sc.SolverSettings(method="bicgstab", rtol=1e-12,
                                    max_it=200, precision="f64"))
    n = eq.n_elems
    one = np.ones(n)
    mat = sc.Material(n)
    mat.set_density(2000.0 * one)
    mat.add_to_elastic(sc.Spring(102e9 * one, 0.3 * one))
    mat.add_to_non_elastic(sc.Viscoelastic(105e11 * one, 10e9 * one,
                                           0.32 * one))
    mat.add_to_non_elastic(sc.DislocationCreep(1.9e-20 * one, 51600 * one,
                                               3.0 * one))
    mat.add_to_non_elastic(sc.ViscoplasticDesai(
        mu_1=5.3665857009859815e-11 * one, N_1=3.1 * one,
        a_1=1.965018496922832e-05 * one, eta=0.8275682807874163 * one,
        n=3.0 * one, beta_1=0.0048 * one, beta=0.995 * one, m=-0.5 * one,
        gamma=0.095 * one, sigma_t=5.0 * one, alpha_0=0.0022 * one))
    eq.set_material(mat)
    eq.set_T0(298.0 * one)
    eq.set_T(298.0 * one)
    eq.build_body_force([0.0, 0.0, 0.0])

    bc = momBC.BcHandler(eq)
    tv = [0.0, 1e9]
    MPa = 1e6
    bc.add_boundary_condition(momBC.DirichletBC("WEST", 0, [0., 0.], tv))
    bc.add_boundary_condition(momBC.DirichletBC("SOUTH", 1, [0., 0.], tv))
    bc.add_boundary_condition(momBC.DirichletBC("BOTTOM", 2, [0., 0.], tv))
    for name in ("EAST", "NORTH"):
        bc.add_boundary_condition(momBC.NeumannBC(name, 2, 0.0, 0.0,
                                                  [4 * MPa, 8 * MPa], tv,
                                                  g=0.0))
    bc.add_boundary_condition(momBC.NeumannBC("TOP", 2, 0.0, 0.0,
                                              [10 * MPa, 14 * MPa], tv,
                                              g=0.0))
    eq.set_boundary_conditions(bc)

    eq.bc.update_dirichlet(0.0)
    eq.bc.update_neumann(0.0)
    eq.solve_elastic_response()
    eps = eq.compute_total_strain()
    eq.compute_elastic_stress(eps)
    eq.compute_eps_ne_rate(eq.sig_v, 0.0)
    eq.update_eps_ne_rate_old()
    return eq


DT = 3600.0
TS = [DT, 2 * DT, 3 * DT, 4 * DT]


def _run_single(eq):
    rows = []
    for t in TS:
        ite, err = eq.solve_time_step(t, DT, tol=1e-8, maxiter=40)
        eq.commit_time_step(DT)
        rows.append((ite, err))
    return rows


class TestFusedMultiStep:
    def test_matches_single_step_path(self):
        eq_a = _build()
        rows_a = _run_single(eq_a)

        eq_b = _build()
        stats = eq_b.solve_time_steps(TS, [DT] * len(TS), tol=1e-8,
                                      maxiter=40)
        assert stats.shape == (len(TS), 6)
        assert (stats[:, 5] == 1.0).all(), stats

        for (ite, err), row in zip(rows_a, stats):
            assert int(row[0]) == ite
            assert np.isclose(row[1], err, rtol=1e-12, atol=1e-300)

        def close(a, b, msg):
            a, b = np.asarray(a, dtype=np.float64), np.asarray(b,
                                                               dtype=np.float64)
            scale = max(np.abs(a).max(), np.abs(b).max(), 1e-300)
            np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-10 * scale,
                                       err_msg=msg)

        close(eq_a.u, eq_b.u, "u")
        close(eq_a.sig_v, eq_b.sig_v, "sig_v")
        close(eq_a.eps_tot_v, eq_b.eps_tot_v, "eps_tot_v")
        for ea, eb in zip(eq_a.mat.elems_ne, eq_b.mat.elems_ne):
            for key in ea.state:
                close(ea.state[key], eb.state[key], f"{ea.name}.{key}")

    def test_failure_keeps_entry_state_and_skips_rest(self):
        eq = _build()
        # step 2 cannot converge in 1 iteration at tight tol -> chunk must
        # stop there with step-2-entry state and mark 3/4 as not run
        stats1 = eq.solve_time_steps(TS[:1], [DT], tol=1e-8, maxiter=40)
        assert stats1[0, 5] == 1.0
        u_entry = np.asarray(eq.u).copy()
        sig_entry = np.asarray(eq.sig_v).copy()
        alpha_entry = np.asarray(eq.mat.elems_ne[-1].state["alpha"]).copy()

        stats = eq.solve_time_steps(TS[1:], [DT] * 3, tol=1e-14, maxiter=1)
        assert stats[0, 5] == 0.0
        assert (stats[1:, 5] == 0.0).all()
        # skipped steps ran zero iterations
        assert (stats[1:, 0] == 0.0).all()
        np.testing.assert_array_equal(np.asarray(eq.u), u_entry)
        np.testing.assert_array_equal(np.asarray(eq.sig_v), sig_entry)
        np.testing.assert_array_equal(
            np.asarray(eq.mat.elems_ne[-1].state["alpha"]), alpha_entry)

        # and the normal path still succeeds from the preserved entry state
        stats2 = eq.solve_time_steps(TS[1:], [DT] * 3, tol=1e-8, maxiter=40)
        assert (stats2[:, 5] == 1.0).all()


class TestFp32Phase:
    """Mixed-precision fixed-point sweep (SolverSettings.fp32_phase).

    Early iterations run in f32, the finish in f64 with the frozen history
    restored exactly - so converged states satisfy the same f64 criterion
    and must agree with the pure-f64 path to ~tol-level differences."""

    def test_matches_f64_path(self):
        import safeincave_tpu as sc

        eq_a = _build()
        for t in TS:
            eq_a.solve_time_step(t, DT, tol=1e-8, maxiter=40)
            eq_a.commit_time_step(DT)

        eq_b = _build()
        eq_b.set_solver(sc.SolverSettings(method="bicgstab", rtol=1e-12,
                                          max_it=200, precision="f64",
                                          fp32_phase=True))
        for t in TS:
            ite, err = eq_b.solve_time_step(t, DT, tol=1e-8, maxiter=40)
            assert err <= 1e-8 and np.isfinite(err)
            eq_b.commit_time_step(DT)

        for attr in ("u", "sig_v", "eps_tot_v"):
            a = np.asarray(getattr(eq_a, attr))
            b = np.asarray(getattr(eq_b, attr))
            scale = max(np.abs(a).max(), 1e-300)
            np.testing.assert_allclose(b, a, rtol=2e-7, atol=2e-7 * scale,
                                       err_msg=attr)
        # ISVs converge to the same implicit solution
        a = np.asarray(eq_a.mat.elems_ne[-1].state["alpha"])
        b = np.asarray(eq_b.mat.elems_ne[-1].state["alpha"])
        np.testing.assert_allclose(b, a, rtol=1e-5, err_msg="alpha")


class TestAdaptiveRtol:
    """adaptive_rtol=True (the bench headline regime) must track the
    always-tight path: loose early solves shape the iteration path only
    (convergence is declared on a tight iteration), and the loose-mode
    rollback net in momentum._make_fp demotes any misbehaving adaptive
    iteration (stalled Krylov solve, stress blow-up, non-finite) to the
    proven tight-only path from the step-entry state.  Regression for the
    cavern600 yield-onset false convergence: a stalled 800-iteration solve
    left the strain unchanged, err read 0, and the poisoned commit NaNed
    the following step."""

    def test_matches_tight_path(self):
        import safeincave_tpu as sc

        eq_t = _build()
        for t in TS:
            ite, err = eq_t.solve_time_step(t, DT, tol=1e-8, maxiter=40)
            assert err <= 1e-8 and np.isfinite(err)
            eq_t.commit_time_step(DT)

        eq_a = _build()
        eq_a.set_solver(sc.SolverSettings(method="bicgstab", rtol=1e-12,
                                          max_it=200, precision="f64",
                                          adaptive_rtol=True))
        for t in TS:
            ite, err = eq_a.solve_time_step(t, DT, tol=1e-8, maxiter=40)
            assert err <= 1e-8 and np.isfinite(err)
            eq_a.commit_time_step(DT)

        for attr in ("u", "sig_v", "eps_tot_v"):
            a = np.asarray(getattr(eq_a, attr))
            b = np.asarray(getattr(eq_t, attr))
            scale = max(np.abs(b).max(), 1e-300)
            np.testing.assert_allclose(a, b, rtol=2e-7, atol=2e-7 * scale,
                                       err_msg=attr)
        a = np.asarray(eq_a.mat.elems_ne[-1].state["alpha"])
        b = np.asarray(eq_t.mat.elems_ne[-1].state["alpha"])
        np.testing.assert_allclose(a, b, rtol=1e-5, err_msg="alpha")


class TestLagTangent:
    """lag_tangent=True (modified-Newton) must track the always-fresh path:
    lagged tangents shape the iteration path only - convergence is declared
    exclusively on a fresh-tangent tight iteration, so the committed fields
    satisfy the identical f64 fixed-point criterion and agree to ~tol-level
    iteration noise (the G:(sigma-sigma_k) corrector terms vanish at the
    fixed point)."""

    def test_matches_fresh_path(self):
        import safeincave_tpu as sc

        eq_f = _build()
        for t in TS:
            ite, err = eq_f.solve_time_step(t, DT, tol=1e-8, maxiter=40)
            assert err <= 1e-8 and np.isfinite(err)
            eq_f.commit_time_step(DT)

        eq_l = _build()
        eq_l.set_solver(sc.SolverSettings(method="bicgstab", rtol=1e-12,
                                          max_it=200, precision="f64",
                                          lag_tangent=True))
        iters_lag = 0
        for t in TS:
            ite, err = eq_l.solve_time_step(t, DT, tol=1e-8, maxiter=40)
            assert err <= 1e-8 and np.isfinite(err)
            iters_lag += ite
            eq_l.commit_time_step(DT)

        for attr in ("u", "sig_v", "eps_tot_v"):
            a = np.asarray(getattr(eq_l, attr))
            b = np.asarray(getattr(eq_f, attr))
            scale = max(np.abs(b).max(), 1e-300)
            np.testing.assert_allclose(a, b, rtol=2e-7, atol=2e-7 * scale,
                                       err_msg=attr)
        a = np.asarray(eq_l.mat.elems_ne[-1].state["alpha"])
        b = np.asarray(eq_f.mat.elems_ne[-1].state["alpha"])
        np.testing.assert_allclose(a, b, rtol=1e-5, err_msg="alpha")


class TestF32Polymorphism:
    """Every constitutive element must compute natively in f32 when fed f32
    state/stress - a single strong-typed f64 constant (numpy scalar, f64
    jnp literal) silently promotes the whole mixed-precision phase back to
    f64."""

    @pytest.mark.slow
    def test_all_elements_stay_f32(self):
        import jax
        import jax.numpy as jnp
        import safeincave_tpu as sc

        n = 4
        one = np.ones(n)
        elems = [
            sc.Viscoelastic(105e11 * one, 10e9 * one, 0.32 * one),
            sc.DislocationCreep(1.9e-20 * one, 51600 * one, 3.0 * one),
            sc.PressureSolutionCreep(1e-15 * one, 5e-3 * one, 51600 * one),
            sc.ViscoplasticDesai(
                mu_1=5.3665857009859815e-11 * one, N_1=3.1 * one,
                a_1=1.965018496922832e-05 * one,
                eta=0.8275682807874163 * one, n=3.0 * one,
                beta_1=0.0048 * one, beta=0.995 * one, m=-0.5 * one,
                gamma=0.095 * one, sigma_t=5.0 * one, alpha_0=0.0022 * one),
            sc.MunsonDawsonCreep(
                A=1.0e-6 * one, Q=51600 * one, n=5.0 * one, K0=6.0e5 * one,
                c=9.0e-3 * one, m=3.0 * one, alpha_w=-13.2 * one,
                beta_w=-7.7 * one, delta=0.58 * one, mu=12.4e9 * one),
            sc.MohrCoulombViscoplastic(
                mu_1=1e-10 * one, N_1=3.0 * one, cohesion=1.0 * one,
                friction_angle=0.5 * one, dilation_angle=0.3 * one,
                sigma_t=5.0 * one),
            sc.MatsuokaNakaiViscoplastic(
                mu_1=1e-10 * one, N_1=3.0 * one, cohesion=1.0 * one,
                friction_angle=0.5 * one, dilation_angle=0.3 * one,
                sigma_t=5.0 * one),
        ]
        rng = np.random.default_rng(0)
        sv32 = jnp.asarray(-1e7 * (np.eye(3).ravel()[None, [0, 4, 8, 1, 2, 5]]
                                   + 0.1 * rng.normal(size=(n, 6))),
                           dtype=jnp.float32)
        T32 = jnp.asarray(298.0 * one, dtype=jnp.float32)
        dt32 = jnp.asarray(3600.0, dtype=jnp.float32)

        for e in elems:
            st32 = {k: (v.astype(jnp.float32)
                        if jnp.issubdtype(v.dtype, jnp.floating) else v)
                    for k, v in e.state.items()}
            st = e.f_tangent(st32, sv32, T32, dt32, 0.5)
            st = e.f_eps_k(st, dt32 * 0.5, dt32 * 0.5)
            st = e.f_increment_isv(st, sv32, sv32, dt32)
            st = e.f_rate(st, sv32, dt32 * 0.5, T32)
            for k, v in st.items():
                if jnp.issubdtype(v.dtype, jnp.floating):
                    assert v.dtype == jnp.float32, \
                        f"{e.name}.{k} leaked {v.dtype}"


class TestFusedSimulator:
    """Simulator_M with fused chunks == per-step flow (same writes, same
    fields), with sparse outputs (save_every > 1)."""

    def _run(self, tmp_path, fused, sub):
        import h5py
        import safeincave_tpu as sc

        eq = _build()
        out = sc.SaveFields(eq, save_every=4)
        out.set_output_folder(str(tmp_path / sub))
        out.add_output_field("u", "Displacement (m)")
        out.add_output_field("q_elems", "von Mises (Pa)")
        tc = sc.TimeController(dt=1.0, initial_time=0.0, final_time=10.0,
                               time_unit="hour")
        sim = sc.Simulator_M(eq, tc, [out], compute_elastic_response=False,
                             fused_steps=fused)
        sim.run()
        h5 = h5py.File(tmp_path / sub / "u" / "u.h5", "r")
        series = {k: np.asarray(h5[f"Function/u/{k}"])
                  for k in h5["Function/u"]}
        h5.close()
        return np.asarray(eq.u), series, tc.step_counter

    def _run_tm(self, tmp_path, fused, sub):
        import h5py
        import safeincave_tpu as sc
        heatBC = sc.HeatBC

        eq = _build()
        n = eq.n_elems
        one = np.ones(n)
        mat = eq.mat
        mat.set_specific_heat_capacity(850.0 * one)
        mat.set_thermal_conductivity(7.0 * one)
        mat.add_to_thermoelastic(sc.Thermoelastic(44e-6 * one))
        heat = sc.HeatDiffusion(eq.grid)
        heat.set_solver(sc.SolverSettings(method="cg", rtol=1e-12,
                                          max_it=200, precision="f64"))
        heat.set_material(mat)
        heat.set_initial_T(298.0 * np.ones(eq.grid.n_nodes))
        bc_h = heatBC.BcHandler(heat)
        tv = [0.0, 1e9]
        bc_h.add_boundary_condition(heatBC.DirichletBC("TOP", [308., 308.],
                                                       tv))
        bc_h.add_boundary_condition(heatBC.RobinBC("BOTTOM", [288., 288.],
                                                   5.0, tv))
        heat.set_boundary_conditions(bc_h)
        eq._jit_step = None   # material gained a thermoelastic element

        out = sc.SaveFields(eq, save_every=3)
        out.set_output_folder(str(tmp_path / sub))
        out.add_output_field("u", "Displacement (m)")
        tc = sc.TimeController(dt=1.0, initial_time=0.0, final_time=7.0,
                               time_unit="hour")
        sim = sc.Simulator_TM(eq, heat, tc, [out],
                              compute_elastic_response=False,
                              fused_steps=fused)
        sim.run()
        h5 = h5py.File(tmp_path / sub / "u" / "u.h5", "r")
        series = sorted(h5["Function/u"])
        h5.close()
        return (np.asarray(eq.u), np.asarray(heat.T),
                np.asarray(eq.sig_v), series)

    def test_tm_fused_matches_per_step_flow(self, tmp_path):
        u_ref, T_ref, s_ref, ser_ref = self._run_tm(tmp_path, 1, "tm_ref")
        u_fus, T_fus, s_fus, ser_fus = self._run_tm(tmp_path, "auto",
                                                    "tm_fused")
        assert ser_ref == ser_fus
        for a, b, nm in ((u_ref, u_fus, "u"), (T_ref, T_fus, "T"),
                         (s_ref, s_fus, "sig")):
            scale = max(np.abs(a).max(), 1e-300)
            np.testing.assert_allclose(b, a, rtol=1e-9, atol=1e-9 * scale,
                                       err_msg=nm)

    def test_fused_matches_per_step_flow(self, tmp_path):
        u_ref, series_ref, steps_ref = self._run(tmp_path, 1, "per_step")
        u_fus, series_fus, steps_fus = self._run(tmp_path, "auto", "fused")
        assert steps_ref == steps_fus
        assert sorted(series_ref) == sorted(series_fus), \
            "fused run wrote a different set of save points"
        scale = np.abs(u_ref).max()
        np.testing.assert_allclose(u_fus, u_ref, rtol=1e-10,
                                   atol=1e-10 * scale)
        for k in series_ref:
            s = max(np.abs(series_ref[k]).max(), 1e-300)
            np.testing.assert_allclose(series_fus[k], series_ref[k],
                                       rtol=1e-9, atol=1e-9 * s,
                                       err_msg=f"save point {k}")
