"""Smoke test of the cavern solver on an NVIDIA GPU.

    python chip_smoke.py          # one card: device, kernels, mechanics, tm
    python chip_smoke.py --four   # four cards: the halo SPMD path only

Drives the production path once through the user entry points at the
repo's real fixture sizes and checks it against independent references:

* device    - JAX devices, compile-cache directory, and the card's name and
              power limit from nvidia-smi;
* kernels   - the stiffness actions (matrix-free cumsum, block-DIA,
              block-ELL) against a float64 scipy CSR matrix assembled on
              the host (safeincave_tpu/fem/csr_reference.py), plus the
              device time of the f32 cumsum and DIA matvecs;
* mechanics - the benchmark's headline scenario (bench.build) through
              Simulator_M with the GPU defaults, against the same scenario
              on the CPU device in pure f64 with always-tight settings;
* tm        - the interlayer-1200 thermomechanical scenario
              (bench.build_tm_cyclic) through Simulator_TM, against the same
              scenario on the same card in pure f64 with the 2-level
              preconditioner.

Each phase prints one JSON line.  A failed phase or a comparison outside
its bound exits non-zero.  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Timings are smoke timings of one run, not benchmark results.  Without a
GPU the script exits non-zero; there is no CPU fallback.
"""
import argparse
import contextlib
import glob
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

F64_BOUND = 1e-12      # max-abs error / max |y|, float64 operators
# float32 operators: the cumsum scatter's f32 prefix sum carries ~3e-6
# relative rounding noise at cavern scale (fem/kernels.py)
F32_BOUND = 1e-5
U_BOUND = 1e-6         # relative max-abs, converged fields across settings
T_BOUND = 1e-8         # relative max-abs, temperature
DT = 3600.0


class PhaseFailed(Exception):
    pass


_T0 = time.time()


def emit(phase, **fields):
    print(json.dumps({"phase": phase, "elapsed_s": time.time() - _T0,
                      **fields}, default=_jsonable), flush=True)


def _jsonable(x):
    if isinstance(x, np.generic):
        return x.item()
    return str(x)


def rel_err(a, b):
    """max |a - b| / max |b| (csr_reference.relative_error)."""
    from safeincave_tpu.fem.csr_reference import relative_error
    return relative_error(a, b)


class Checks:
    """Measured errors beside their bounds; fails the phase at the end."""

    def __init__(self):
        self.rows = []

    def add(self, name, err, bound):
        self.rows.append({"check": name, "err": err, "bound": bound,
                          "ok": bool(np.isfinite(err) and err <= bound)})

    def require(self, name, ok, detail=""):
        self.rows.append({"check": name, "ok": bool(ok), "detail": detail})

    def raise_if_failed(self, phase):
        bad = [r["check"] for r in self.rows if not r["ok"]]
        if bad:
            raise PhaseFailed(f"{phase}: failed checks {bad}")


# ---------------------------------------------------------------------- #
def nvidia_smi():
    """``name, power.limit`` of each card, read by a child process that
    does not import JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def phase_device():
    import jax
    from safeincave_tpu import jax_setup

    smi = nvidia_smi()
    for line in smi:
        print(line, flush=True)
    d = jax.devices()[0]
    rec = {"devices": [str(x) for x in jax.devices()],
           "kind": d.device_kind, "jax": jax.__version__,
           "compile_cache": jax_setup.CACHE_DIR, "nvidia_smi": smi}
    emit("device", **rec)
    return rec


# ---------------------------------------------------------------------- #
def elastic_tangent(n_elems, seed=0):
    """Per-element isotropic elastic C (E, 6, 6) with Young's moduli drawn
    in [30, 110] GPa (the repo's salt/interlayer/overburden range)."""
    import safeincave_tpu as sc
    rng = np.random.default_rng(seed)
    E = rng.uniform(30e9, 110e9, size=n_elems)
    mat = sc.Material(n_elems)
    mat.add_to_elastic(sc.Spring(E, 0.3 * np.ones(n_elems)))
    return np.asarray(mat.C)


def device_time_us(fn, args, reps=20):
    """Device busy time of one call of ``jax.jit(fn)``, from a profiler
    trace: the union of kernel intervals on the GPU streams over ``reps``
    calls, divided by ``reps``.  Returns (us, trace line names)."""
    import jax
    f = jax.jit(fn)
    jax.block_until_ready(f(*args))                 # compile + warm up
    with tempfile.TemporaryDirectory() as d:
        jax.profiler.start_trace(d)
        try:
            out = None
            for _ in range(reps):
                out = f(*args)
            jax.block_until_ready(out)
        finally:
            jax.profiler.stop_trace()
        paths = glob.glob(os.path.join(d, "plugins", "profile", "*",
                                       "*.xplane.pb"))
        if not paths:
            raise PhaseFailed("profiler wrote no xplane.pb")
        pd = jax.profiler.ProfileData.from_file(paths[0])
        names, spans = [], []
        for plane in pd.planes:
            if not plane.name.startswith("/device:GPU:0"):
                continue
            lines = list(plane.lines)
            names = [ln.name for ln in lines]
            streams = [ln for ln in lines if ln.name.startswith("Stream")]
            for ln in streams or lines:
                spans += [(e.start_ns, e.end_ns) for e in ln.events]
    if not spans:
        raise PhaseFailed(f"no GPU events in the trace (lines {names})")
    spans.sort()
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return busy / reps / 1e3, names


def phase_kernels(meshes=None, box=None, timing=True):
    """Stiffness actions against the host CSR reference.

    ``meshes``: [(label, grid)] for the cumsum matvec (block-ELL too on the
    first); ``box``: a natural-order GridBox for block-DIA.  Defaults are
    the real fixtures: cavern_proxy_600 and cavern_interlayer_1200 (both
    band-reordered, as the benchmark loads them) and the 511k-tet
    GridBox(nx=44) of bench_matvec_scale."""
    import jax
    import jax.numpy as jnp
    import safeincave_tpu as sc
    import bench
    from safeincave_tpu.fem import csr_reference as ref
    from safeincave_tpu.fem.blockell import BlockELL
    from safeincave_tpu.fem.dia import BlockDIA
    from safeincave_tpu.fem.kernels import MomentumKernel
    from safeincave_tpu.utils import find_grid

    if meshes is None:
        meshes = [(name, sc.GridHandlerGMSH("geom", find_grid(name),
                                            reorder="band"))
                  for name in ("cavern_proxy_600", "cavern_interlayer_1200")]
    if box is None:
        box = sc.GridBox(Lx=600.0, Ly=600.0, Lz=800.0, nx=44, ny=44, nz=44)
    checks = Checks()
    out = {}
    rng = np.random.default_rng(1)
    mv = jax.jit(lambda k, CT, u: k.matvec(CT, u), static_argnums=0)

    for i, (label, grid) in enumerate(meshes + [("box", box)]):
        kern = MomentumKernel(grid)
        C = elastic_tangent(grid.n_elems, seed=i)
        A = ref.stiffness_csr(grid.points, grid.conn, C)
        u = rng.normal(size=(grid.n_nodes, 3))
        y_ref = ref.apply(A, u)
        info = {"nodes": grid.n_nodes, "tets": grid.n_elems,
                "dofs": 3 * grid.n_nodes}
        for dt in (jnp.float64, jnp.float32):
            name = np.dtype(dt).name
            bound = F64_BOUND if dt == jnp.float64 else F32_BOUND
            CTd = kern.prep(jnp.asarray(C, dt))
            ud = jnp.asarray(u, dt)
            if label == "box":
                dia = BlockDIA(kern)
                y = jax.jit(dia.matvec)(dia.assemble(CTd), ud)
                checks.add(f"box block-DIA {name}", rel_err(y, y_ref), bound)
                info["dia_offsets"] = dia.plan.Dn
                continue
            checks.add(f"{label} cumsum {name}",
                       rel_err(mv(kern, CTd, ud), y_ref), bound)
            if i == 0:
                bell = BlockELL(kern)
                blocks = bell.assemble(CTd)
                y = jax.jit(bell.matvec)(blocks, ud)
                checks.add(f"{label} block-ELL {name}", rel_err(y, y_ref),
                           bound)
        out[label] = info

    if timing:
        hbm = bench.device_peaks(jax.devices()[0].device_kind)["hbm_gbps"]
        label, grid = meshes[0]
        kern = MomentumKernel(grid)
        CT32 = kern.prep(jnp.asarray(elastic_tangent(grid.n_elems),
                                     jnp.float32))
        u32 = jnp.asarray(rng.normal(size=(grid.n_nodes, 3)), jnp.float32)
        us, lines = device_time_us(kern.matvec, (CT32, u32))
        nbytes = bench.matvec_bytes(grid.n_elems, grid.n_nodes, 4)
        out["cumsum_f32_timing"] = {
            "mesh": label, "device_us": us, "bytes": nbytes,
            "bytes_over_peak_us": nbytes / (hbm * 1e9) * 1e6,
            "peak_gbps": hbm, "trace_lines": lines}

        kern = MomentumKernel(box)
        dia = BlockDIA(kern)
        vals32 = dia.assemble(kern.prep(jnp.asarray(
            elastic_tangent(box.n_elems), jnp.float32)))
        ub = jnp.asarray(rng.normal(size=(box.n_nodes, 3)), jnp.float32)
        us_dia, _ = device_time_us(dia.matvec, (vals32, ub))
        dia_bytes = (dia.plan.Dn * 9 + 6) * box.n_nodes * 4
        big = jnp.ones((64 * 1024 * 1024,), jnp.float32)     # 256 MB
        us_copy, _ = device_time_us(lambda x: x * 1.0000001, (big,))
        copy_gbps = 2 * big.size * 4 / (us_copy * 1e3)
        dia_gbps = dia_bytes / (us_dia * 1e3)
        out["dia_f32_timing"] = {
            "mesh": "box", "device_us": us_dia, "bytes": dia_bytes,
            "gbps": dia_gbps, "copy_gbps": copy_gbps,
            "share_of_copy": dia_gbps / copy_gbps,
            "bytes_over_peak_us": dia_bytes / (hbm * 1e9) * 1e6}
    emit("kernels", checks=checks.rows, **out)
    checks.raise_if_failed("kernels")
    return out


# ---------------------------------------------------------------------- #
def pure_f64_solver(sc):
    """Always-tight pure-f64 settings: the CPU-path reference."""
    return sc.SolverSettings(method="bicgstab", rtol=1e-12, max_it=2000,
                             coarse_agg=8, precision="f64",
                             fp32_phase=False, precond="2level")


def _quiet():
    """The simulators print their step tables to stdout; keep stdout for
    this script's JSON lines."""
    return contextlib.redirect_stdout(sys.stderr)


def _memory(compiled):
    ma = compiled.memory_analysis()
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes",
            "alias_size_in_bytes")
    return {k: getattr(ma, k, None) for k in keys} if ma is not None else None


def _peak_bytes():
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def _hours(first, n):
    """Times of ``n`` hourly steps, the first ending at hour ``first``."""
    return [DT * (first + k) for k in range(n)]


def _padded(ts):
    """``ts`` and its dts padded to the fused drivers' canonical 64."""
    import jax.numpy as jnp
    tp = np.full(64, ts[-1])
    tp[:len(ts)] = ts
    return jnp.asarray(tp), jnp.asarray(np.full(64, DT))


def _timed_precond(eq):
    import jax
    t0 = time.time()
    P, _ = eq._get_precond()
    jax.block_until_ready(P)
    return time.time() - t0


def run_mechanics(eq, n_steps):
    """Equilibrium stage + ``n_steps`` hourly steps through Simulator_M."""
    import safeincave_tpu as sc
    tc = sc.TimeController(dt=DT, initial_time=0.0, final_time=n_steps * DT)
    metrics = sc.StepMetrics()
    with _quiet():
        sc.Simulator_M(eq, tc, [], metrics=metrics).run()
    return metrics.records


def phase_mechanics(grid=None, n_steps=10, ref_device=None):
    """Headline scenario on the default device with its default settings,
    against the CPU device in pure f64 (``ref_device``)."""
    import jax
    import safeincave_tpu as sc
    import bench

    checks = Checks()
    with _quiet():
        eq = bench.build(grid)
    settings = {"precision": eq.solver.precision,
                "fp32_phase": eq.solver.fp32_enabled(),
                "precond": eq.solver.precond,
                "operator": "dia" if eq.kernel.dia is not None else "cumsum"}
    p_build_s = _timed_precond(eq)
    t0 = time.time()
    recs = run_mechanics(eq, n_steps)
    first_s = time.time() - t0
    checks.require("all steps converged",
                   len(recs) == n_steps and all(r["converged"] for r in recs),
                   f"{len(recs)} records")
    u, sig = np.asarray(eq.u), np.asarray(eq.sig_v)

    # smoke timing: the same compiled fused program, n_steps more steps
    # (informational: a step it leaves unconverged is reported, and the
    # Simulator_M run above is what the checks judge)
    ts = _hours(n_steps + 1, n_steps)
    t0 = time.time()
    rows = eq.solve_time_steps(ts, [DT] * n_steps, tol=1e-8, maxiter=40)
    jax.block_until_ready(eq.u)
    step_s = (time.time() - t0) / n_steps
    states = [e.state for e in eq.mat.elems_ne]
    P, _ = eq._get_precond()
    mem = _memory(eq._jit_msteps.lower(
        states, eq.sig_v, eq.eps_tot_v, eq.u, eq._u_last_step, eq.b_body,
        eq.Temp, eq.T0, *_padded(ts), n_steps, 1e-8, 40, P).compile())

    ref_device = ref_device or jax.devices("cpu")[0]
    with jax.default_device(ref_device), _quiet():
        eq_ref = bench.build(grid, auto_backend=False,
                             solver=pure_f64_solver(sc))
    with jax.default_device(ref_device):
        recs_ref = run_mechanics(eq_ref, n_steps)
    checks.require("reference steps converged",
                   all(r["converged"] for r in recs_ref))
    checks.add("u vs pure-f64 reference", rel_err(u, eq_ref.u), U_BOUND)
    checks.add("stress vs pure-f64 reference", rel_err(sig, eq_ref.sig_v),
               U_BOUND)
    out = {
        "nodes": eq.n_nodes, "dofs": 3 * eq.n_nodes, "settings": settings,
        "reference_device": str(ref_device),
        "precond_build_s": p_build_s,
        "first_run_s": first_s,
        "setup_s": first_s - n_steps * step_s,
        "smoke_ms_per_step": 1e3 * step_s,
        "timing_steps_converged": int((rows[:, 5] > 0.5).sum()),
        "fp_iters_per_step": [r["fp_iters"] for r in recs],
        "krylov_iters_per_step": [r["krylov_total"] for r in recs],
        "fused_step_memory": mem, "peak_bytes_in_use": _peak_bytes()}
    emit("mechanics", checks=checks.rows, **out)
    checks.raise_if_failed("mechanics")
    return out


# ---------------------------------------------------------------------- #
def build_tm(grid=None, reference=False):
    """(eq, heat) of the interlayer-1200 TM scenario; ``reference`` swaps
    in pure-f64 solves and the 2-level preconditioner."""
    import safeincave_tpu as sc
    import bench
    with _quiet():
        eq, heat = bench.build_tm_cyclic(
            "cavern_interlayer_1200", None, "tm", grid=grid,
            auto_backend=not reference,
            solver=pure_f64_solver(sc) if reference else None)
    if reference:
        heat.set_solver(sc.SolverSettings(method="cg", rtol=1e-12,
                                          max_it=2000, precision="f64"))
    return eq, heat


def run_tm(eq, heat, n_steps):
    import safeincave_tpu as sc
    tc = sc.TimeController(dt=DT, initial_time=0.0, final_time=n_steps * DT)
    with _quiet():
        sc.Simulator_TM(eq, heat, tc, []).run()


def phase_tm(grid=None, n_steps=3):
    """Interlayer-1200 TM through Simulator_TM with the GPU defaults,
    against pure f64 with the 2-level preconditioner on the same card."""
    import jax

    checks = Checks()
    eq, heat = build_tm(grid)
    p_build_s = _timed_precond(eq)
    t0 = time.time()
    run_tm(eq, heat, n_steps)
    first_s = time.time() - t0
    u, T = np.asarray(eq.u), np.asarray(heat.T)

    # smoke timing (informational, as in phase_mechanics)
    ts = _hours(n_steps + 1, n_steps)
    t0 = time.time()
    rows = eq.solve_tm_time_steps(heat, ts, [DT] * n_steps, tol=1e-6,
                                  maxiter=20)
    jax.block_until_ready(eq.u)
    step_s = (time.time() - t0) / n_steps
    states = [e.state for e in eq.mat.elems_ne]
    P, _ = eq._get_precond()
    mem = _memory(eq._jit_tm_msteps.lower(
        states, eq.sig_v, eq.eps_tot_v, eq.u, eq._u_last_step, eq.b_body,
        heat.T, heat.T_old, heat.k, heat.rho, heat.cp, eq.T0, *_padded(ts),
        n_steps, 1e-6, 20, P).compile())

    eq_ref, heat_ref = build_tm(grid, reference=True)
    run_tm(eq_ref, heat_ref, n_steps)
    checks.add("u vs pure-f64 2-level reference", rel_err(u, eq_ref.u),
               U_BOUND)
    checks.add("T vs pure-f64 reference", rel_err(T, heat_ref.T), T_BOUND)
    out = {
        "nodes": eq.n_nodes, "dofs": 3 * eq.n_nodes,
        "precond": eq.solver.precond, "precond_build_s": p_build_s,
        "first_run_s": first_s, "setup_s": first_s - n_steps * step_s,
        "smoke_ms_per_step": 1e3 * step_s,
        "timing_steps_converged": int((rows[:, 5] > 0.5).sum()),
        "fp_iters_per_step": rows[:, 2].tolist(),
        "krylov_iters_per_step": rows[:, 4].tolist(),
        "heat_cg_iters_per_step": rows[:, 0].tolist(),
        "fused_step_memory": mem, "peak_bytes_in_use": _peak_bytes()}
    emit("tm", checks=checks.rows, **out)
    checks.raise_if_failed("tm")
    return out


# ---------------------------------------------------------------------- #
def _devices_of(x):
    return {str(d) for d in x.sharding.device_set}


def phase_four(grid=None, n_devices=4, n_steps=2):
    """Halo SPMD path over ``n_devices`` cards against one card, in one
    process: interlayer-1200 mechanics (fused steps) and shard_tm."""
    import jax
    import bench
    from safeincave_tpu.parallel import (make_device_mesh, shard_equation,
                                         shard_tm)

    if len(jax.devices()) < n_devices:
        raise PhaseFailed(f"needs {n_devices} devices, found "
                          f"{len(jax.devices())}")
    checks = Checks()
    ts = _hours(1, n_steps)
    dts = [DT] * n_steps
    out = {"devices": n_devices}

    results = {}
    for mode in ("one", "sharded"):
        eq, _ = build_tm(grid)
        if mode == "sharded":
            shard_equation(eq, make_device_mesh(n_devices), mode="halo")
            out["halo_rows_per_device_per_matvec"] = \
                eq._halo.plan.comm_volume_per_matvec()
            out["nodes"] = eq.n_nodes
            devs = _devices_of(eq.sig_v)
            checks.require("mechanics state spans all devices",
                           len(devs) == n_devices, sorted(devs))
        eq.bc.update_dirichlet(0.0)
        eq.bc.update_neumann(0.0)
        eq.solve_elastic_response()
        eps = eq.compute_total_strain()
        eq.compute_elastic_stress(eps)
        eq.compute_eps_ne_rate(eq.sig_v, 0.0)
        eq.update_eps_ne_rate_old()
        t0 = time.time()
        rows = eq.solve_time_steps(ts, dts, tol=1e-8, maxiter=40)
        jax.block_until_ready(eq.u)
        results[mode] = (np.asarray(eq.u), rows, time.time() - t0)
        checks.require(f"mechanics {mode} converged",
                       (rows[:, 5] > 0.5).all())
    checks.add("mechanics u sharded vs one card",
               rel_err(results["sharded"][0], results["one"][0]), U_BOUND)
    out["mechanics_fp_iters"] = {m: r[1][:, 0].tolist()
                                 for m, r in results.items()}
    out["mechanics_first_call_s"] = {m: r[2] for m, r in results.items()}

    results = {}
    for mode in ("one", "sharded"):
        eq, heat = build_tm(grid)
        if mode == "sharded":
            shard_tm(eq, heat, make_device_mesh(n_devices))
            devs = _devices_of(eq.sig_v) | _devices_of(heat.k)
            checks.require("tm state spans all devices",
                           len(devs) == n_devices, sorted(devs))
        with _quiet():
            bench.init_tm(eq, heat)
        t0 = time.time()
        rows = eq.solve_tm_time_steps(heat, ts, dts, tol=1e-6, maxiter=20)
        jax.block_until_ready(eq.u)
        results[mode] = (np.asarray(eq.u), np.asarray(heat.T), rows,
                         time.time() - t0)
        checks.require(f"tm {mode} converged", (rows[:, 5] > 0.5).all())
    checks.add("tm u sharded vs one card",
               rel_err(results["sharded"][0], results["one"][0]), U_BOUND)
    checks.add("tm T sharded vs one card",
               rel_err(results["sharded"][1], results["one"][1]), T_BOUND)
    out["tm_fp_iters"] = {m: r[2][:, 2].tolist() for m, r in results.items()}
    out["tm_first_call_s"] = {m: r[3] for m, r in results.items()}
    emit("four", checks=checks.rows, **out)
    checks.raise_if_failed("four")
    return out


# ---------------------------------------------------------------------- #
def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card halo SPMD path")
    args = ap.parse_args(argv)

    import jax
    if jax.default_backend() != "gpu":
        print(f"chip_smoke: no GPU (JAX default backend is "
              f"{jax.default_backend()!r}); this smoke needs a CUDA GPU",
              file=sys.stderr)
        return 2
    try:
        import safeincave_tpu  # noqa: F401  (x64, compile cache)
        import bench  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: run from the repository root ({exc})",
              file=sys.stderr)
        return 2

    try:
        phase_device()
        if args.four:
            phase_four()
        else:
            phase_kernels()
            phase_mechanics()
            phase_tm()
    except Exception as exc:  # noqa: BLE001 - report, exit non-zero
        emit("error", error=f"{type(exc).__name__}: {exc}")
        import traceback
        traceback.print_exc()
        return 1
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
