"""Simulation drivers: mechanics-only, thermal, coupled thermo-mechanics.

Reference: /root/reference/safeincave/Simulators.py.  The drivers reproduce
the reference's control flow exactly:

* ``Simulator_M`` (:273-541): theta-scheme time loop, fixed-point iteration
  (tol 1e-8, <= 40 iters), dt-halving retry (<= 3) with full ISV
  snapshot/restore on divergence or NaN, diagnostic dump after exhausted
  retries, commit-only-if-converged.
* ``Simulator_TM`` (:57-270): heat step then momentum fixed-point
  (tol 1e-6, <= 20 iters) with one-way T coupling; no dt-retry.
* ``Simulator_T`` (:544-639): heat-only loop.
* ``Simulator_Mout`` (:646-839): legacy no-retry mechanics loop.

Each linear solve / constitutive update is a jitted XLA program; the outer
convergence control stays host-side (one scalar sync per iteration), exactly
the host/device split the reference has with PETSc.
"""
from __future__ import annotations

import os
import time
from abc import ABC, abstractmethod

import numpy as np
import jax.numpy as jnp

from .checkpoint import save_checkpoint
from .metrics import StepMetrics
from .output.screen import ScreenPrinter
from .utils import voigt_to_tensor


class Simulator(ABC):
    @abstractmethod
    def run(self):
        ...


class Simulator_M(Simulator):
    """Mechanics-only driver with dt-halving retry (reference :273-541)."""

    def __init__(self, eq_mom, t_control, outputs,
                 compute_elastic_response: bool = True,
                 metrics: StepMetrics | None = None,
                 checkpoint_every: int = 0,
                 checkpoint_path: str = "checkpoint.npz",
                 fused_steps: int | str = "auto"):
        self.eq_mom = eq_mom
        self.t_control = t_control
        self.outputs = outputs
        self.compute_elastic_response = compute_elastic_response
        self.metrics = metrics
        self.checkpoint_every = checkpoint_every
        self.checkpoint_path = checkpoint_path
        self.fused_steps = fused_steps
        ScreenPrinter.reset_instance()
        self.screen = ScreenPrinter(eq_mom.grid, eq_mom.solver, eq_mom.mat,
                                    outputs, t_control.time_unit)

    # hooks for subclasses (KSP-log idiom of the nobian scripts)
    tol = 1e-8
    maxiter = 40
    max_dt_cuts = 3

    # ------------------------------------------------------------------ #
    def _plan_chunk_size(self) -> int:
        """Steps to advance in ONE fused device dispatch.

        Host attention is only needed at output/checkpoint boundaries
        (field writes, dt-retry dispatching), so between boundaries the
        time loop runs as a single jitted multi-step program
        (eq.solve_time_steps): one dispatch and one stats sync per chunk
        instead of per step.  Chunking is semantically transparent: per-step
        stats still surface, writes land on the same steps, and a
        non-converged step hands back its entry state for the usual
        dt-retry.  Returns 1 (the reference per-step flow) whenever
        fusing would change observable behavior."""
        cap = self.fused_steps
        if cap == "auto":
            cap = 64
            # an adaptive controller can only change dt at chunk
            # boundaries (all steps inside a chunk share the dt planned at
            # entry), so bound the feedback latency to a few steps
            if hasattr(self.t_control, "feedback"):
                cap = 4
        if not cap or cap <= 1:
            return 1
        eq = self.eq_mom
        if not hasattr(eq, "solve_time_steps"):
            return 1
        # user per-step extension hooks must keep firing per step
        from .fem.momentum import LinearMomentumBase
        if type(eq).run_after_solve is not LinearMomentumBase.run_after_solve:
            return 1
        # instance-level wrapping of the step (the nobian KSP-log idiom,
        # reference Munsondawson.py:288-310) expects one call per step
        if ("solve_time_step" in eq.__dict__
                or "solve_time_steps" in eq.__dict__):
            return 1
        for output in self.outputs:
            fn = getattr(output, "calls_until_next_keep", None)
            if fn is None:
                return 1
            cap = min(cap, fn())
        if self.checkpoint_every:
            s0 = self.t_control.step_counter
            cap = min(cap, self.checkpoint_every
                      - s0 % self.checkpoint_every)
        return max(int(cap), 1)

    def _run_fused_chunk(self, chunk: int) -> bool:
        """Advance up to ``chunk`` steps in one fused device dispatch.

        Returns True when every planned step converged (outputs, metrics,
        screen rows and checkpoints fully accounted).  Returns False when a
        step failed: the equation then holds that step's ENTRY state and the
        time controller is rewound so the caller's per-step dt-retry flow
        re-attempts exactly that step (reference Simulators.py:441-503
        semantics)."""
        eq, tc = self.eq_mom, self.t_control
        s0, t0 = tc.step_counter, tc.t
        ts, dts = [], []
        while tc.keep_looping() and len(ts) < chunk:
            tc.advance_time()
            ts.append(tc.t)
            dts.append(tc.dt)
        if not ts:
            return True
        t_wall0 = time.time()
        stats = eq.solve_time_steps(ts, dts, tol=self.tol,
                                    maxiter=self.maxiter)
        chunk_wall = time.time() - t_wall0
        conv = (stats[:, 5] > 0.5).astype(int)
        n_ok = int(conv.cumprod().sum())     # converged prefix length
        for k in range(n_ok):
            step_no = s0 + 1 + k
            if self.metrics is not None:
                # the chunk runs as ONE dispatch: report each step's share
                # of the chunk wall-clock, flagged as fused
                self.metrics.record(step_no, ts[k], dts[k],
                                    int(stats[k, 0]), float(stats[k, 1]),
                                    wall_s=chunk_wall / max(n_ok, 1),
                                    fused=True,
                                    converged=True, dt_cuts=0,
                                    krylov=int(stats[k, 3]),
                                    krylov_total=int(stats[k, 2]),
                                    lin_res=float(stats[k, 4]))
            current_time = "%.3f" % (ts[k] / tc.time_conversion)
            self.screen.print_row([
                step_no, dts[k] / tc.time_conversion,
                f"{current_time} / {tc.t_final / tc.time_conversion}",
                int(stats[k, 0]), float(stats[k, 1]),
            ])
        if n_ok and hasattr(tc, "feedback"):
            # adaptive controller: adapt the NEXT chunk's dt from this
            # chunk's mean fixed-point work.  On a partial failure report
            # one dt cut so the controller shrinks before the per-step
            # retry re-attempts the failed step (a fast-converging prefix
            # must not grow dt into a solve that just failed).
            tc.feedback(float(stats[:n_ok, 0].mean()),
                        dt_cuts=0 if n_ok == len(ts) else 1)
        if n_ok == len(ts):
            for output in self.outputs:
                output.skip_calls(n_ok - 1)
            self._save_derived_and_outputs(ts[-1])
            if (self.checkpoint_every
                    and tc.step_counter % self.checkpoint_every == 0):
                save_checkpoint(self.checkpoint_path, eq, tc)
            return True
        # failed at planned step n_ok: account its predecessors' save calls,
        # rewind the controller to the failed step
        for output in self.outputs:
            output.skip_calls(n_ok)
        tc.step_counter = s0 + n_ok
        tc.t = ts[n_ok - 1] if n_ok else t0
        return False

    def run(self):
        eq = self.eq_mom
        tc = self.t_control
        # Checkpoint resume: tc.step_counter > 0 means load_checkpoint
        # restored mid-run state, including the committed rate/rate_old
        # arrays.  Re-initializing the rates here would clobber them (the
        # Kelvin-Voigt rate depends on phi1 = theta*t, which is only ~0 at a
        # fresh start), breaking exact continuation.
        resumed = tc.step_counter > 0

        for output in self.outputs:
            output.initialize()

        eq.bc.update_dirichlet(tc.t)
        eq.bc.update_neumann(tc.t)

        if self.compute_elastic_response and not resumed:
            eq.solve_elastic_response()
            eps_tot = eq.compute_total_strain()
            stress = eq.compute_elastic_stress(eps_tot)
        else:
            eps_tot = eq.compute_total_strain()
            stress = eq.sig_v

        if not resumed:
            eq.compute_eps_ne_rate(stress, tc.t)
            eq.update_eps_ne_rate_old()
            self._save_derived_and_outputs(0.0)

        while tc.keep_looping():
            chunk = self._plan_chunk_size()
            fused_failed = False
            if chunk > 1:
                all_converged = self._run_fused_chunk(chunk)
                # on failure eq holds the failed step's ENTRY state - refresh
                # the locals so the retry path backs up the right state
                stress = eq.sig_v
                eps_tot = eq.eps_tot_v
                if all_converged:
                    continue
                fused_failed = True
            # chunk of 1, or a fused step failed to converge (tc rewound to
            # it): run the reference per-step flow with dt-halving retry
            tc.advance_time()
            t, dt = tc.t, tc.dt

            stress_backup = stress
            eps_backup = eps_tot
            u_backup = eq.u
            eq.save_internal_state()

            def restore_step_state():
                """Full rollback to the pre-attempt state.

                solve_time_step reads eq.sig_v / eq.eps_tot_v / eq.u (the
                displacement doubles as the Krylov initial guess), so a
                retry must reset the equation fields too, not just the
                Python locals - otherwise the halved-dt attempt restarts
                from the poisoned (possibly NaN) state.  Mirrors reference
                Simulators.py:441-503.
                """
                eq.sig_v = stress_backup
                eq.eps_tot_v = eps_backup
                eq.u = u_backup
                eq._last_sv_k = stress_backup
                eq.restore_internal_state()

            dt_current = dt
            dt_cut = 0
            step_converged = False
            ite, error = 0, 2 * self.tol
            stress_k = stress

            while not step_converged and dt_cut <= self.max_dt_cuts:
                # fused fixed-point solve: the whole inner loop of reference
                # Simulators.py:404-438 runs as one jitted XLA program.
                # Retries run pure-f64 (no f32 sweep): if the mixed-precision
                # path contributed to the failure, the retry must not repeat
                # it deterministically.  A step that just failed inside a
                # fused chunk already ran the fp32+f64 path at this exact
                # state - re-attempting it identically is a guaranteed-wasted
                # solve, so the first host attempt after a fused failure is
                # pure-f64 too.
                eq._fp32_disable = dt_cut > 0 or fused_failed
                ite, error = eq.solve_time_step(t, dt_current, tol=self.tol,
                                                maxiter=self.maxiter)
                stress = eq.sig_v
                eps_tot = eq.eps_tot_v
                stress_k = eq._last_sv_k

                if not np.isnan(error) and error <= self.tol:
                    step_converged = True
                else:
                    dt_cut += 1
                    if dt_cut <= self.max_dt_cuts:
                        import sys
                        print(f"[SOLVER] Step {tc.step_counter}: "
                              f"{'NaN' if np.isnan(error) else 'no convergence'} "
                              f"after {ite} iters - halving dt, "
                              f"retry {dt_cut}/{self.max_dt_cuts}",
                              file=sys.stderr)
                        dt_current = dt_current / 2
                        restore_step_state()
                        stress = stress_backup
                        eps_tot = eps_backup
                    else:
                        self._dump_diagnostics(t, dt_current)
                        restore_step_state()
                        stress = stress_backup
                        eps_tot = eps_backup
                        stress_k = stress_backup

            # the retry loop runs pure-f64; restore the mixed-precision
            # default so later direct eq.solve_time_step calls (and the next
            # fused chunk) get the f32 sweep back (mirrors Simulator_TM)
            eq._fp32_disable = False

            if step_converged:
                # fused single-dispatch commit (== update_internal_variables
                # + update_eps_ne_rate_old + update_eps_ne_old)
                eq.commit_time_step(dt_current, stress, stress_k)
                if hasattr(tc, "feedback"):
                    tc.feedback(ite, dt_cuts=dt_cut)

            self._save_derived_and_outputs(t)
            if self.metrics is not None:
                # solver_stats/krylov_total come from the fused step's
                # carried counters (last linear solve iters + residual,
                # total Krylov iters over the fixed-point loop)
                self.metrics.record(tc.step_counter, t, dt_current, ite, error,
                                    converged=step_converged,
                                    dt_cuts=dt_cut,
                                    krylov=eq.solver_stats[0],
                                    krylov_total=eq.krylov_total,
                                    lin_res=eq.solver_stats[1])
            if (self.checkpoint_every
                    and tc.step_counter % self.checkpoint_every == 0):
                save_checkpoint(self.checkpoint_path, eq, tc)
            current_time = "%.3f" % (t / tc.time_conversion)
            self.screen.print_row([
                tc.step_counter,
                tc.dt / tc.time_conversion,
                f"{current_time} / {tc.t_final / tc.time_conversion}",
                ite,
                error,
            ])

        self.screen.close()
        if self.metrics is not None:
            self.metrics.close()
        for output in self.outputs:
            output.save_mesh()

    # ------------------------------------------------------------------ #
    def _save_derived_and_outputs(self, t):
        eq = self.eq_mom
        eq.compute_p_elems()
        eq.compute_q_elems()
        eq.compute_p_nodes()
        eq.compute_q_nodes()
        for output in self.outputs:
            output.save_fields(t)

    def _dump_diagnostics(self, t, dt):
        """NaN diagnostic dump (reference Simulators.py:463-503), npz format."""
        import sys
        eq = self.eq_mom
        diag = {
            "step": self.t_control.step_counter,
            "t": t,
            "dt": dt,
            "stress": np.asarray(voigt_to_tensor(eq.sig_v)),
            "eps_tot": np.asarray(voigt_to_tensor(eq.eps_tot_v)),
            "C_inv": np.asarray(eq.mat.C_inv),
        }
        if hasattr(eq.mat, "G"):
            diag["G_total"] = np.asarray(eq.mat.G)
        for idx, e in enumerate(eq.mat.elems_ne):
            prefix = f"elem_{idx}_{e.name}"
            diag[f"{prefix}_eps_ne_rate"] = np.asarray(e.state["rate"])
            diag[f"{prefix}_G"] = np.asarray(e.state["G"])
            diag[f"{prefix}_B"] = np.asarray(e.state["B"])
            for key in ("alpha", "qsi", "Fvp", "r", "h", "zeta"):
                if key in e.state:
                    diag[f"{prefix}_{key}"] = np.asarray(e.state[key])
        path = os.path.join(os.getcwd(), "nan_diagnostic.npz")
        np.savez(path, **diag)
        print(f"[SOLVER] All {self.max_dt_cuts} retries failed at step "
              f"{self.t_control.step_counter}. Diagnostic saved to {path}",
              file=sys.stderr)


class Simulator_Mout(Simulator_M):
    """Legacy mechanics driver without dt-retry (reference :646-839)."""
    max_dt_cuts = 0


class Simulator_T(Simulator):
    """Thermal-only driver (reference :544-639)."""

    def __init__(self, eq_heat, t_control, outputs,
                 compute_elastic_response: bool = True,
                 fused_steps: int | str = "auto"):
        self.eq_heat = eq_heat
        self.t_control = t_control
        self.outputs = outputs
        self.fused_steps = fused_steps
        ScreenPrinter.reset_instance()
        self.screen = ScreenPrinter(eq_heat.grid, eq_heat.solver, eq_heat.mat,
                                    outputs, t_control.time_unit)

    def _plan_chunk_size(self) -> int:
        cap = 64 if self.fused_steps == "auto" else self.fused_steps
        if not cap or cap <= 1:
            return 1
        heat = self.eq_heat
        if not hasattr(heat, "solve_steps") or "solve" in heat.__dict__:
            return 1
        for output in self.outputs:
            fn = getattr(output, "calls_until_next_keep", None)
            if fn is None:
                return 1
            cap = min(cap, fn())
        return max(int(cap), 1)

    def run(self):
        tc = self.t_control
        for output in self.outputs:
            output.initialize()
        for output in self.outputs:
            output.save_fields(0)

        while tc.keep_looping():
            chunk = self._plan_chunk_size()
            if chunk > 1:
                s0 = tc.step_counter
                ts, dts = [], []
                while tc.keep_looping() and len(ts) < chunk:
                    tc.advance_time()
                    ts.append(tc.t)
                    dts.append(tc.dt)
                stats = self.eq_heat.solve_steps(ts, dts)
                for k in range(len(ts)):
                    current_time = "%.3f" % (ts[k] / tc.time_conversion)
                    self.screen.print_row([
                        s0 + 1 + k, dts[k] / tc.time_conversion,
                        f"{current_time} / "
                        f"{tc.t_final / tc.time_conversion}",
                        int(stats[k, 0]), float(stats[k, 1]),
                    ])
                for output in self.outputs:
                    output.skip_calls(len(ts) - 1)
                for output in self.outputs:
                    output.save_fields(ts[-1])
                continue
            tc.advance_time()
            t, dt = tc.t, tc.dt
            self.eq_heat.solve(t, dt)
            for output in self.outputs:
                output.save_fields(t)
            current_time = "%.3f" % (t / tc.time_conversion)
            self.screen.print_row([
                tc.step_counter, tc.dt / tc.time_conversion,
                f"{current_time} / {tc.t_final / tc.time_conversion}", 0, 0,
            ])

        self.screen.close()
        for output in self.outputs:
            output.save_mesh()


class Simulator_TM(Simulator):
    """One-way coupled thermo-mechanics (reference :57-270)."""

    tol = 1e-6
    maxiter = 20
    max_dt_cuts = 3

    def __init__(self, eq_mom, eq_heat, t_control, outputs,
                 compute_elastic_response: bool = True,
                 fused_steps: int | str = "auto"):
        self.eq_mom = eq_mom
        self.eq_heat = eq_heat
        self.t_control = t_control
        self.outputs = outputs
        self.compute_elastic_response = compute_elastic_response
        self.fused_steps = fused_steps
        ScreenPrinter.reset_instance()
        self.screen = ScreenPrinter(eq_mom.grid, eq_mom.solver, eq_mom.mat,
                                    outputs, t_control.time_unit)

    # ------------------------------------------------------------------ #
    def _plan_chunk_size(self) -> int:
        """Steps per fused TM dispatch (see Simulator_M._plan_chunk_size;
        a chunk commits only its converged prefix - a failed step rewinds
        to the per-step dt-retry flow)."""
        cap = self.fused_steps
        if cap == "auto":
            cap = 64
        if not cap or cap <= 1:
            return 1
        eq, heat = self.eq_mom, self.eq_heat
        if not hasattr(eq, "solve_tm_time_steps"):
            return 1
        from .fem.momentum import LinearMomentumBase
        if type(eq).run_after_solve is not LinearMomentumBase.run_after_solve:
            return 1
        if ("solve_time_step" in eq.__dict__
                or "solve_tm_time_steps" in eq.__dict__
                or "solve" in heat.__dict__):
            return 1
        for output in self.outputs:
            fn = getattr(output, "calls_until_next_keep", None)
            if fn is None:
                return 1
            cap = min(cap, fn())
        return max(int(cap), 1)

    def _run_fused_chunk(self, chunk: int) -> bool:
        """Advance up to ``chunk`` fused TM steps.  Returns True when every
        planned step converged; on a failed step the equation AND heat field
        hold that step's ENTRY state, the controller is rewound to it, and
        the caller's per-step dt-retry flow re-attempts it."""
        eq, heat, tc = self.eq_mom, self.eq_heat, self.t_control
        s0, t0 = tc.step_counter, tc.t
        ts, dts = [], []
        while tc.keep_looping() and len(ts) < chunk:
            tc.advance_time()
            ts.append(tc.t)
            dts.append(tc.dt)
        if not ts:
            return True
        stats = eq.solve_tm_time_steps(heat, ts, dts, tol=self.tol,
                                       maxiter=self.maxiter)
        conv = (stats[:, 5] > 0.5).astype(int)
        n_ok = int(conv.cumprod().sum())
        for k in range(n_ok):
            current_time = "%.3f" % (ts[k] / tc.time_conversion)
            self.screen.print_row([
                s0 + 1 + k, dts[k] / tc.time_conversion,
                f"{current_time} / {tc.t_final / tc.time_conversion}",
                int(stats[k, 2]), float(stats[k, 3]),
            ])
        if n_ok == len(ts):
            for output in self.outputs:
                output.skip_calls(n_ok - 1)
            self._save_derived_and_outputs(ts[-1])
            return True
        for output in self.outputs:
            output.skip_calls(n_ok)
        tc.step_counter = s0 + n_ok
        tc.t = ts[n_ok - 1] if n_ok else t0
        return False

    def run(self):
        eq = self.eq_mom
        heat = self.eq_heat
        tc = self.t_control

        for output in self.outputs:
            output.initialize()

        T_elems = heat.get_T_elems()
        eq.set_T0(T_elems)

        eq.bc.update_dirichlet(tc.t)
        eq.bc.update_neumann(tc.t)

        if self.compute_elastic_response:
            eq.solve_elastic_response()
            eps_tot = eq.compute_total_strain()
            stress = eq.compute_elastic_stress(eps_tot)
        else:
            eps_tot = eq.compute_total_strain()
            stress = eq.sig_v

        T_elems = heat.get_T_elems()
        eq.set_T(T_elems)
        eq.set_T0(T_elems)

        eq.compute_eps_ne_rate(stress, tc.t)
        eq.update_eps_ne_rate_old()

        self._save_derived_and_outputs(0.0)

        while tc.keep_looping():
            chunk = self._plan_chunk_size()
            fused_failed = False
            if chunk > 1:
                if self._run_fused_chunk(chunk):
                    continue
                fused_failed = True
            tc.advance_time()
            t, dt = tc.t, tc.dt

            eq.bc.update_dirichlet(t)
            eq.bc.update_neumann(t)

            # dt-halving retry net around the coupled step (beyond the
            # reference Simulator_TM, which commits unconditionally -
            # Simulators.py:177-265; the hardening linearization can
            # overshoot under large thermal-stress increments and the only
            # cure is a smaller dt, exactly like Simulator_M's retry)
            stress_backup, eps_backup, u_backup = eq.sig_v, eq.eps_tot_v, eq.u
            T_backup, T_old_backup = heat.T, heat.T_old
            eq.save_internal_state()

            def restore():
                eq.sig_v, eq.eps_tot_v, eq.u = (stress_backup, eps_backup,
                                                u_backup)
                eq._last_sv_k = stress_backup
                eq.restore_internal_state()
                heat.T, heat.T_old = T_backup, T_old_backup

            dt_current = dt
            dt_cut = 0
            step_converged = False
            ite, error = 0, 2 * self.tol
            while not step_converged and dt_cut <= self.max_dt_cuts:
                eq._fp32_disable = dt_cut > 0 or fused_failed
                heat.solve(t, dt_current)
                eq.set_T(heat.get_T_elems())
                ite, error = eq.solve_time_step(t, dt_current, tol=self.tol,
                                                maxiter=self.maxiter)
                if not np.isnan(error) and error <= self.tol:
                    step_converged = True
                else:
                    dt_cut += 1
                    restore()
                    if dt_cut <= self.max_dt_cuts:
                        import sys
                        print(f"[SOLVER] TM step {tc.step_counter}: "
                              f"{'NaN' if np.isnan(error) else 'no convergence'}"
                              f" after {ite} iters - halving dt, "
                              f"retry {dt_cut}/{self.max_dt_cuts}",
                              file=sys.stderr)
                        dt_current = dt_current / 2
            eq._fp32_disable = False

            if step_converged:
                eq.commit_time_step(dt_current, eq.sig_v, eq._last_sv_k)

            self._save_derived_and_outputs(t)
            current_time = "%.3f" % (t / tc.time_conversion)
            self.screen.print_row([
                tc.step_counter, tc.dt / tc.time_conversion,
                f"{current_time} / {tc.t_final / tc.time_conversion}",
                ite, error,
            ])

        self.screen.close()
        for output in self.outputs:
            output.save_mesh()

    def _save_derived_and_outputs(self, t):
        eq = self.eq_mom
        eq.compute_p_elems()
        eq.compute_q_elems()
        eq.compute_p_nodes()
        eq.compute_q_nodes()
        for output in self.outputs:
            output.save_fields(t)
