"""Benchmark: wall-clock per converged time step on the cavern meshes.

The workload mirrors the reference's operation-stage regime
(examples/mechanics/4_cavern + 1_triaxial): the repo's cavern_proxy_600
mesh (band-reordered), full constitutive suite (elastic + Kelvin-Voigt +
dislocation creep + Desai), theta = 0.5, fixed-point tol 1e-8 / max 40,
Krylov rtol 1e-12 (mixed precision: f32 Krylov under f64 defect
correction, see safeincave_tpu/fem/solvers.py:ir_solve).

Needs a CUDA GPU: with no GPU it exits non-zero.  One process drives the
card.  Reports (stderr): per-step wall-clock of the production fused
driver (Simulator_M auto-fuses all steps between output boundaries into
one device dispatch; convergence control runs on device) and of the
reference-style per-step host-sync loop, fixed-point iters/step, Krylov
iters/step, matvec bandwidth against the card's peak (``PEAKS``), the
TM configurations, and MDOF/s.  Every timing names the card.
Output (stdout): ONE json line with the headline cell
(metric, value, unit, vs_baseline, device).  A section that raises makes
the run exit non-zero.

``vs_baseline`` compares against a documented reference estimate of 2.0 s per
nonlinear time step for SafeInCave's FEniCSx/PETSc CPU stack on this mesh
class: the reference re-assembles A and b and re-solves at rtol=1e-12 every
fixed-point iteration (~3 iterations/step) and rebuilds FD tangents with 12
rate sweeps per model per iteration (reference MomentumEquation.py:640-675,
:1008-1025); ~0.5-0.7 s per assemble+solve on a 16kDOF tet mesh on a CPU
node is typical for that stack, giving ~2 s/step (SURVEY.md 6; no published
numbers exist - BASELINE.md records "published: {}").
``vs_baseline_measured`` divides by baseline_measured.json (this framework's
own pure-f64 path on one CPU core, tools/measure_baseline.py).
"""
import json
import os
import sys
import time

import numpy as np

REFERENCE_SECONDS_PER_STEP = 2.0  # documented estimate, see module docstring

# Published peaks per JAX ``device_kind`` (NVIDIA H100 data sheet, dense
# rates without sparsity, at the card's full power limit): device-memory
# bandwidth in GB/s, f32 and f64 vector (non-tensor-core) rates in TFLOP/s.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_gbps": 3350.0, "f32_tflops": 67.0,
                              "f64_tflops": 34.0},          # SXM5
    "NVIDIA H100 PCIe": {"hbm_gbps": 2000.0, "f32_tflops": 51.0,
                         "f64_tflops": 26.0},
}


def device_peaks(kind):
    """Peak rates of a device kind; an unknown kind is an error, not a
    default."""
    try:
        return PEAKS[kind]
    except KeyError:
        raise KeyError(f"no published peaks for device kind {kind!r}; "
                       f"add it to bench.PEAKS with its source") from None


def require_gpu():
    """The first JAX device, which must be a CUDA GPU."""
    import jax
    if jax.default_backend() != "gpu":
        raise SystemExit(f"no GPU: JAX's default backend is "
                         f"{jax.default_backend()!r}; this needs a CUDA GPU")
    return jax.devices()[0]


def device_record():
    import jax
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def load_measured_baseline():
    """Measured CPU-backend baseline (tools/measure_baseline.py output).

    The committed baseline_measured.json holds per-config s/step measured by
    running THIS framework's per-step, pure-f64, always-tight path on the
    CPU backend - a PETSc-CPU-node proxy that is generous to the reference
    (exact autodiff tangents and a stronger preconditioner than the
    reference's FD-probe + ASM/ILU stack).  See the JSON's "notes" field
    for the host caveats."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "baseline_measured.json")
    if os.path.isfile(path):
        with open(path) as f:
            return json.load(f)
    return {}


MEASURED = load_measured_baseline()


def measured_ratio(key, per_step_s):
    entry = MEASURED.get(key)
    if not entry:
        return None
    return entry["s_per_step"] / per_step_s


def headline_grid():
    """cavern_proxy_600 (3,360 nodes), band (RCM) reordered."""
    import safeincave_tpu as sc
    from safeincave_tpu.utils import find_grid
    return sc.GridHandlerGMSH("geom", find_grid("cavern_proxy_600"),
                              reorder="band")


def build(grid=None, auto_backend=True, solver=None):
    """The headline mechanics scenario on ``grid`` (default:
    :func:`headline_grid`).  ``solver`` overrides the SolverSettings."""
    import safeincave_tpu as sc
    momBC = sc.MomentumBC

    if grid is None:
        grid = headline_grid()
    log(f"mesh: {grid.n_nodes} nodes, {grid.n_elems} tets, "
        f"reorder={getattr(grid, 'reorder_method', None)}")
    names = grid.get_boundary_names()

    eq = sc.LinearMomentum(grid, theta=0.5, auto_backend=auto_backend)
    # BiCGStab: fewer, more productive iterations than CG on this tangent
    # despite 2 matvecs/iteration.  max_it is the per-refinement-pass f32
    # Krylov cap; coarse_agg=8 trades a slightly larger dense coarse space
    # for fewer iterations.  adaptive_rtol and lag_tangent stay OFF (the
    # library defaults), so the benchmarked config is exactly what a user
    # of the documented API gets; BENCH_LAG_TANGENT=1 / BENCH_ADAPTIVE_RTOL=1
    # switch them on for A/B runs.
    if solver is None:
        lag = os.environ.get("BENCH_LAG_TANGENT", "0") == "1"
        adaptive = os.environ.get("BENCH_ADAPTIVE_RTOL", "0") == "1"
        solver = sc.SolverSettings(method="bicgstab", rtol=1e-12,
                                   max_it=400, coarse_agg=8,
                                   lag_tangent=lag, adaptive_rtol=adaptive)
    eq.set_solver(solver)
    n = eq.n_elems
    one = np.ones(n)
    mat = sc.Material(n)
    mat.set_density(2200.0 * one)
    mat.add_to_elastic(sc.Spring(102e9 * one, 0.3 * one))
    mat.add_to_non_elastic(sc.Viscoelastic(105e11 * one, 10e9 * one, 0.32 * one))
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
    tv = [0.0, 1e12]
    MPa = 1e6

    def has(name):
        return name in names

    # generic lithostatic-ish loading adapted to available boundary names
    fixed = [("WEST", 0), ("SOUTH", 1), ("BOTTOM", 2),
             ("West", 0), ("South", 1), ("Bottom", 2)]
    loaded = ["EAST", "NORTH", "TOP", "East", "North", "Top",
              "Cavern", "CAVERN", "Wall", "WALL"]
    n_dir = 0
    for nm, comp in fixed:
        if has(nm):
            bc.add_boundary_condition(momBC.DirichletBC(nm, comp,
                                                        [0., 0.], tv))
            n_dir += 1
    if n_dir == 0:  # unknown naming: pin the first boundary in all components
        nm = names[0]
        for comp in range(3):
            bc.add_boundary_condition(momBC.DirichletBC(nm, comp,
                                                        [0., 0.], tv))
    # cyclic pressure schedule (the reference operation-stage regime:
    # examples/mechanics/4_cavern cyclic cavern loading).  A 24 h sinus
    # keeps every benchmark window doing comparable nonlinear work - with a
    # constant load the creep transient decays and later steps converge in
    # 1 fixed-point iteration, which would flatter whichever execution mode
    # is measured later.
    t_sched = np.arange(0.0, 400 * 3600.0, 3600.0)
    p_sched = 10 * MPa + 4 * MPa * np.sin(2 * np.pi * t_sched / (24 * 3600.0))
    for nm in loaded:
        if has(nm):
            bc.add_boundary_condition(momBC.NeumannBC(
                nm, 2, 0.0, 0.0, list(p_sched), list(t_sched), g=0.0))
    eq.set_boundary_conditions(bc)
    # default: no enable_* call - the benchmark measures the library
    # default exactly as a user gets it.  BENCH_BACKEND=blockell|dia
    # forces an assembled operator for A/B experiments.
    forced = os.environ.get("BENCH_BACKEND", "")
    if forced:
        getattr(eq, f"enable_{forced}_matvec")()
        log(f"matvec backend: {forced} (BENCH_BACKEND override)")
    elif eq.kernel.dia is not None:
        log("matvec backend: block-DIA (auto-selected)")
    else:
        log("matvec backend: matrix-free cumsum (library default)")
    return eq


def bench_matvec(eq):
    """Matrix-free cumsum matvec bandwidth against the card's peak
    (BASELINE.md SpMV row)."""
    import jax.numpy as jnp
    kern = eq.kernel
    E, N = kern.n_elems, kern.n_nodes
    hbm = device_peaks(device_record()["kind"])["hbm_gbps"]

    for dtype, fbytes in ((jnp.float32, 4), (jnp.float64, 8)):
        CT = kern.prep(eq.mat.C.astype(dtype))   # once, as the Krylov loop does
        u = jnp.asarray(np.random.default_rng(0).normal(size=(N, 3)),
                        dtype=dtype)
        dt_iter = timed_loop(lambda v, CT=CT: kern.matvec(CT, v), u,
                             iters=200 if dtype == jnp.float32 else 50)
        gbps = matvec_bytes(E, N, fbytes) / dt_iter / 1e9
        mdofs = 3 * N / dt_iter / 1e6
        log(f"matvec[{np.dtype(dtype).name}]: {dt_iter*1e6:.0f} us "
            f"({mdofs:.0f} MDOF/s, ~{gbps:.0f} GB/s = "
            f"{100*gbps/hbm:.1f}% of the {hbm:.0f} GB/s peak)")


def matvec_bytes(E, N, fbytes):
    """Bytes one matrix-free matvec moves at least: per element the
    gathered u (12 values), grad_N (12), vol (1), CT (36) and the scattered
    forces (12); per node the read and written vectors."""
    return (12 + 12 + 1 + 36 + 12) * fbytes * E + 2 * 3 * fbytes * N


def bench_tm(eq_mech, n_steps=5):
    """Second config (BASELINE.md): coupled thermomechanics on the same
    mesh - heat step + momentum fixed point per step (reference
    Simulator_TM regime, tol 1e-6 / <= 20 iters).

    Material set matches the reference's OWN TM cavern config
    (examples/thermomechanics/2_cavern/main.py:71-100): Spring + Kelvin +
    DislocationCreep + PressureSolutionCreep + Thermoelastic - NO Desai
    (the reference does not run viscoplastic hardening in its TM stage;
    its FD-secant hardening linearization is fragile under thermal-stress
    increments at dt=1h)."""
    import jax
    import jax.numpy as jnp
    import safeincave_tpu as sc
    heatBC = sc.HeatBC

    grid = eq_mech.grid
    n = grid.n_elems
    one = np.ones(n)
    heat = sc.HeatDiffusion(grid)
    heat.set_solver(sc.SolverSettings(method="cg", rtol=1e-12, max_it=400))

    eq = sc.LinearMomentum(grid, theta=0.5)
    eq.set_solver(eq_mech.solver)
    mat = sc.Material(n)
    mat.set_density(2200.0 * one)
    mat.add_to_elastic(sc.Spring(102e9 * one, 0.3 * one))
    mat.add_to_non_elastic(sc.Viscoelastic(105e11 * one, 10e9 * one,
                                           0.32 * one))
    mat.add_to_non_elastic(sc.DislocationCreep(1.9e-20 * one, 51600 * one,
                                               3.0 * one, name="ds_creep"))
    mat.add_to_non_elastic(sc.PressureSolutionCreep(1e-22 * one, 1e-2 * one,
                                                    51600 * one,
                                                    name="ps_creep"))
    mat.add_to_thermoelastic(sc.Thermoelastic(44e-6 * one))
    mat.set_specific_heat_capacity(850.0 * one)
    mat.set_thermal_conductivity(7.0 * one)
    eq.set_material(mat)
    eq.build_body_force([0.0, 0.0, 0.0])
    # the BC handler is grid-based (facet tables), so the mechanical
    # loading carries over to the TM equation on the same mesh
    eq.set_boundary_conditions(eq_mech.bc)
    heat.set_material(mat)
    heat.set_initial_T(298.0 * jnp.ones(grid.n_nodes))

    # thermal BCs RAMP from the initial temperature (the reference TM
    # cavern example drives a smooth gas-temperature schedule,
    # examples/thermomechanics/2_cavern/main.py:269-349) - an instantaneous
    # Dirichlet jump would be a ~20 MPa/step thermal-stress shock that no
    # hardening linearization survives at dt=1h
    bc_h = heatBC.BcHandler(heat)
    names = grid.get_boundary_names()
    hr = 3600.0
    if "Top" in names:
        bc_h.add_boundary_condition(heatBC.DirichletBC(
            "Top", [298., 293., 293.], [0.0, 12 * hr, 1e12]))
    if "Cavern" in names:
        bc_h.add_boundary_condition(heatBC.RobinBC(
            "Cavern", [298., 283., 283.], 5.0, [0.0, 24 * hr, 1e12]))
    heat.set_boundary_conditions(bc_h)

    # initial state: elastic response + initial creep rates at T0
    T_el = heat.get_T_elems()
    eq.set_T0(T_el)
    eq.set_T(T_el)
    eq.bc.update_dirichlet(0.0)
    eq.bc.update_neumann(0.0)
    eq.solve_elastic_response()
    eps = eq.compute_total_strain()
    eq.compute_elastic_stress(eps)
    eq.compute_eps_ne_rate(eq.sig_v, 0.0)
    eq.update_eps_ne_rate_old()

    dt = 3600.0

    def run_tm(ts_list, dts_list):
        """Fused TM chunks with dt-halving retry for failed steps - the
        retry reuses the SAME compiled fused program (single-step chunk at
        dt/2), so no extra compile lands on the budget."""
        rows, retries = [], 0
        pending = list(zip(ts_list, dts_list))
        while pending:
            ts = [p[0] for p in pending]
            ds = [p[1] for p in pending]
            stats = eq.solve_tm_time_steps(heat, ts, ds, tol=1e-6,
                                           maxiter=20)
            conv = (stats[:, 5] > 0.5).astype(int)
            n_ok = int(conv.cumprod().sum())
            rows.extend(stats[:n_ok])
            if n_ok == len(pending):
                break
            t_f, d_f = pending[n_ok]
            ok = False
            for cut in (2, 4, 8):
                sub = eq.solve_tm_time_steps(heat, [t_f], [d_f / cut],
                                             tol=1e-6, maxiter=20)
                retries += 1
                if sub[0, 5] > 0.5:
                    rows.append(sub[0])
                    ok = True
                    break
            if not ok:
                log(f"TM step at t={t_f/3600:.0f}h failed at dt/8 - "
                    f"aborting TM section")
                break
            pending = pending[n_ok + 1:]
        return np.asarray(rows), retries

    t0 = time.time()
    run_tm([dt], [dt])
    import jax as _jax
    _jax.block_until_ready(eq.u)
    log(f"TM first fused step (incl. compile): {time.time()-t0:.2f}s")
    n_tm = 20
    t0 = time.time()
    stats, retries = run_tm([(k + 2) * dt for k in range(n_tm)],
                            [dt] * n_tm)
    _jax.block_until_ready(eq.u)
    per = (time.time() - t0) / max(len(stats), 1)
    log(f"TM config (fused driver): {per*1000:.1f} ms/step over "
        f"{len(stats)} steps ({stats[:, 2].mean():.1f} fp-iters/step, "
        f"{stats[:, 4].mean():.0f} krylov-iters/step, heat "
        f"{stats[:, 0].mean():.0f} cg-iters/step, {retries} dt-retries, "
        f"err={stats[-1, 3]:.1e})")


def timed_loop(step, x, iters=200, calls=3):
    """Per-iteration wall-clock of ``step`` inside one on-device fori_loop
    (each iteration renormalizes, so the carry stays finite), amortizing
    the dispatch of one jit call over ``iters`` iterations; the best of
    ``calls`` calls."""
    import jax
    import jax.numpy as jnp

    f = jax.jit(lambda x: jax.lax.fori_loop(
        0, iters,
        lambda _, v: (lambda w: w / jnp.sqrt(
            jnp.vdot(w.reshape(-1), w.reshape(-1))))(step(v)), x))
    jax.block_until_ready(f(x))             # compile
    best = float("inf")
    for _ in range(calls):
        t0 = time.time()
        jax.block_until_ready(f(x))
        best = min(best, (time.time() - t0) / iters)
    return best


def bench_matvec_scale(nx=44):
    """SpMV bandwidth at PRODUCTION scale (BASELINE.md SpMV row).

    The cavern meshes are small (24-33k tets): one matvec touches ~7 MB,
    so wall-clock there is op-count/latency, not bandwidth.  This section
    measures where the roofline argument applies: a ~500k-tet box
    (~50 MB/matvec), the scale the reference targets with PETSc MPI runs
    (SURVEY.md 6: reference grids go to 10^5-10^6 tets multi-node).

    The measured operator is the production one for this regime: the
    block-DIA offset operator (fem/dia.py) that LinearMomentum
    auto-selects on natural-ordered structured grids, plus its
    scatter-free structured assembly, with the matrix-free cumsum kernel
    for contrast.  Bytes
    are counted two ways: "streamed" = the value planes + u actually
    moved (Dn*9*N + 6N), and "effective" = true-nonzero bytes only
    (n_pairs*9 + 6N; the honest number, discounting the 3.5% slot
    padding)."""
    import jax
    import jax.numpy as jnp
    import safeincave_tpu as sc
    from safeincave_tpu.fem.kernels import MomentumKernel
    from safeincave_tpu.fem.dia import BlockDIA

    grid = sc.GridBox(Lx=600.0, Ly=600.0, Lz=800.0, nx=nx, ny=nx, nz=nx)
    kern = MomentumKernel(grid)
    E, N = kern.n_elems, kern.n_nodes
    one = np.ones(E)
    mat = sc.Material(E)
    mat.add_to_elastic(sc.Spring(102e9 * one, 0.3 * one))

    dia = BlockDIA(kern)
    p = dia.plan
    hbm = device_peaks(device_record()["kind"])["hbm_gbps"]
    log(f"[scale] box mesh: {N} nodes, {E} tets, {3*N} dofs; "
        f"DIA {p.Dn} offsets at {p.fill:.3f} fill, structured assembly: "
        f"{dia.structured}")

    # ceiling calibration: the bandwidth this card achieves on a pure
    # streaming copy (r+w) through XLA, measured in the same run; the
    # matvec's share of it says more than its share of the published peak
    big = jnp.ones((32 * 1024 * 1024,), jnp.float32)      # 128 MB
    sc_ = jnp.float32(1.0000001)
    fcopy = jax.jit(lambda x: jax.lax.fori_loop(
        0, 100, lambda _, v: v * sc_, x))
    jax.block_until_ready(fcopy(big))
    t0 = time.time()
    jax.block_until_ready(fcopy(big))
    dt_copy = (time.time() - t0) / 100
    ceiling = 2 * big.size * 4 / dt_copy / 1e9
    log(f"[scale] streaming-copy calibration: {ceiling:.0f} GB/s achieved "
        f"({100*ceiling/hbm:.0f}% of the {hbm:.0f} GB/s peak)")
    CT64 = kern.prep(mat.C)
    vals64 = dia.assemble(CT64)
    rng = np.random.default_rng(0)

    best_gbps = 0.0
    for dtype, fbytes in ((jnp.float32, 4), (jnp.float64, 8)):
        vals = vals64.astype(dtype)
        u = jnp.asarray(rng.normal(size=(N, 3)), dtype=dtype)
        dt_iter = timed_loop(lambda v, vals=vals: dia.matvec(vals, v), u,
                             iters=500 if dtype == jnp.float32 else 100)
        streamed = (p.Dn * 9 * N + 6 * N) * fbytes
        effective = (p.n_pairs * 9 + 6 * N) * fbytes
        name = np.dtype(dtype).name
        log(f"[scale] matvec[block-DIA {name}]: "
            f"{dt_iter*1e6:.0f} us ({3*N/dt_iter/1e6:.0f} MDOF/s, "
            f"{streamed/dt_iter/1e9:.0f} GB/s streamed = "
            f"{100*streamed/dt_iter/1e9/hbm:.0f}% of peak / "
            f"{100*streamed/dt_iter/1e9/ceiling:.0f}% of measured ceiling, "
            f"{effective/dt_iter/1e9:.0f} GB/s effective)")
        if dtype == jnp.float32:
            best_gbps = streamed / dt_iter / 1e9

    # assembly cost (once per linearized solve; f32 is the production
    # mixed-precision path, fem/momentum.py solve_lin)
    for dtype in (jnp.float32, jnp.float64):
        CTd = CT64.astype(dtype)
        fa = jax.jit(lambda c: jax.lax.fori_loop(
            0, 10, lambda i, acc: acc + dia.assemble(c).sum(),
            jnp.zeros((), dtype)))
        jax.block_until_ready(fa(CTd))
        t0 = time.time()
        jax.block_until_ready(fa(CTd))
        log(f"[scale] assemble[{np.dtype(dtype).name}]: "
            f"{(time.time()-t0)/10*1e3:.1f} ms "
            f"(scatter-free strided, once per linearized solve)")

    # matrix-free cumsum kernel for contrast (the small-mesh default)
    CT32 = kern.prep(mat.C.astype(jnp.float32))
    u32 = jnp.asarray(rng.normal(size=(N, 3)), dtype=jnp.float32)
    dt_iter = timed_loop(lambda v: kern.matvec(CT32, v), u32, iters=20)
    log(f"[scale] matvec[matrix-free cumsum f32]: {dt_iter*1e6:.0f} us "
        f"({3*N/dt_iter/1e6:.0f} MDOF/s) - gather/scatter-bound, "
        f"why the assembled operator owns this regime")
    return best_gbps


def build_tm_cyclic(grid_name, fallback, label, reorder="band", *,
                    grid=None, auto_backend=True, solver=None):
    """BASELINE configs 4-5 builder: coupled-TM cyclic loading on the
    1200-class / interlayer meshes (TM regime
    examples/thermomechanics/2_cavern/main.py:269-349).  Returns (eq, heat).

    Single-region meshes (cavern_regular_1200_3D) get the KV + dislocation-
    creep suite; meshes with Interlayer_* regions get the reference nobian
    heterogeneous regime (run_interlayer.py:1194-1241,1617-1680):
    dislocation creep in the salt (prefactor zeroed on interlayers) +
    Mohr-Coulomb viscoplastic interlayers (fluidity zeroed on salt) - the
    reference's own per-cell masking idiom.  (Munson-Dawson salt needs the
    reference's equilibrium warm-start to converge from a cold state - see
    tests/golden_configs.build_interlayer_tm - so the benchmarked TM-cyclic
    regime uses the DC-salt scenario.)  ``grid`` replaces the named mesh;
    ``solver`` overrides the momentum SolverSettings."""
    import jax.numpy as jnp
    import safeincave_tpu as sc
    from safeincave_tpu.utils import find_grid
    momBC = sc.MomentumBC
    heatBC = sc.HeatBC

    if grid is None:
        path = find_grid(grid_name, fallback=fallback)
        grid = sc.GridHandlerGMSH("geom", path, reorder=reorder)
    regions = grid.get_subdomain_names()
    log(f"[{label}] mesh: {grid.n_nodes} nodes, {grid.n_elems} tets, "
        f"regions={regions}")
    has_inter = any("nterlayer" in r for r in regions)

    # region-keyed parameters (reference get_parameter idiom); the repo-
    # owned cavern_interlayer_1200 mesh adds an "Overburden" cap region
    # (non-salt rock: stiffer KV, no dislocation creep, no MC flow)
    def per_region(salt_val, inter_val, over_val=None):
        if over_val is None:
            over_val = salt_val
        return np.asarray(grid.get_parameter(
            {r: (inter_val if "nterlayer" in r
                 else over_val if "verburden" in r else salt_val)
             for r in regions}))

    n = grid.n_elems
    one = np.ones(n)
    inter = per_region(0.0, 1.0, 0.0)
    over = per_region(0.0, 0.0, 1.0)
    salt = 1.0 - inter - over
    eq = sc.LinearMomentum(grid, theta=0.5, auto_backend=auto_backend)
    # same solver regime as the headline config: always-tight solves
    eq.set_solver(solver or sc.SolverSettings(method="bicgstab", rtol=1e-12,
                                              max_it=400, coarse_agg=8))
    mat = sc.Material(n)
    mat.set_density(2200.0 * salt + 2900.0 * inter + 2500.0 * over)
    E = 102e9 * salt + 70e9 * inter + 35e9 * over
    nu = 0.30 * salt + 0.27 * inter + 0.25 * over
    mat.add_to_elastic(sc.Spring(E, nu))
    mat.add_to_non_elastic(sc.Viscoelastic(
        per_region(105e11, 105e13, 105e13), 10e9 * one, 0.32 * one))
    if has_inter:
        # salt creep masked off the interlayers AND the overburden cap
        # (run_interlayer.py per-cell masking idiom)
        mat.add_to_non_elastic(sc.DislocationCreep(
            1.9e-20 * salt, 51600 * one, 3.0 * one, name="ds_creep"))
        # Mohr-Coulomb interlayers (run_interlayer.py:1617-1660)
        mat.add_to_non_elastic(sc.MohrCoulombViscoplastic(
            mu_1=1e-9 * inter, N_1=1.0 * one, cohesion=4.0 * one,
            friction_angle=np.radians(35.0) * one,
            dilation_angle=0.0 * one, sigma_t=1.0 * one))
    else:
        mat.add_to_non_elastic(sc.DislocationCreep(
            1.9e-20 * one, 51600 * one, 3.0 * one, name="ds_creep"))
    mat.add_to_thermoelastic(sc.Thermoelastic(44e-6 * one))
    mat.set_specific_heat_capacity(850.0 * one)
    mat.set_thermal_conductivity(7.0 * one)
    eq.set_material(mat)
    T0 = 298.0
    eq.set_T0(T0 * one)
    eq.set_T(T0 * one)
    eq.build_body_force([0.0, 0.0, 0.0])

    names = grid.get_boundary_names()
    bc = momBC.BcHandler(eq)
    tv = [0.0, 1e12]
    MPa = 1e6
    for nm, comp in (("West", 0), ("South", 1), ("Bottom", 2),
                     ("WEST", 0), ("SOUTH", 1), ("BOTTOM", 2)):
        if nm in names:
            bc.add_boundary_condition(momBC.DirichletBC(nm, comp,
                                                        [0., 0.], tv))
    t_sched = np.arange(0.0, 400 * 3600.0, 3600.0)
    if has_inter:
        # overburden above the cavern-pressure band keeps the state
        # compressive (MC tension cut-off flow cannot settle otherwise)
        p_sched = 8 * MPa + 2 * MPa * np.sin(2 * np.pi * t_sched
                                             / (24 * 3600.0))
        for nm in ("Top", "TOP"):
            if nm in names:
                bc.add_boundary_condition(momBC.NeumannBC(
                    nm, 2, 0.0, 0.0, [15 * MPa, 15 * MPa], tv, g=0.0))
        if "Cavern" in names:
            bc.add_boundary_condition(momBC.NeumannBC(
                "Cavern", 2, 0.0, 0.0, list(p_sched), list(t_sched),
                g=0.0))
    else:
        p_sched = 10 * MPa + 4 * MPa * np.sin(2 * np.pi * t_sched
                                              / (24 * 3600.0))
        for nm in ("Top", "TOP", "Cavern"):
            if nm in names:
                bc.add_boundary_condition(momBC.NeumannBC(
                    nm, 2, 0.0, 0.0, list(p_sched), list(t_sched), g=0.0))
    eq.set_boundary_conditions(bc)

    heat = sc.HeatDiffusion(grid)
    heat.set_solver(sc.SolverSettings(method="cg", rtol=1e-12, max_it=400))
    heat.set_material(mat)
    heat.set_initial_T(T0 * jnp.ones(grid.n_nodes))
    bc_h = heatBC.BcHandler(heat)
    hr = 3600.0
    if "Top" in names:
        bc_h.add_boundary_condition(heatBC.DirichletBC(
            "Top", [T0, 293., 293.], [0.0, 12 * hr, 1e12]))
    if "Cavern" in names:
        bc_h.add_boundary_condition(heatBC.RobinBC(
            "Cavern", [T0, 283., 283.], 5.0, [0.0, 24 * hr, 1e12]))
    heat.set_boundary_conditions(bc_h)
    return eq, heat


def init_tm(eq, heat, label=""):
    """Elastic response + initial creep rates at T0 (the TM init sequence)."""
    import jax
    T_el = heat.get_T_elems()
    eq.set_T0(T_el)
    eq.set_T(T_el)
    eq.bc.update_dirichlet(0.0)
    eq.bc.update_neumann(0.0)
    t0 = time.time()
    eq.solve_elastic_response()
    jax.block_until_ready(eq.u)
    if label:
        log(f"[{label}] elastic solve (incl. compile): {time.time()-t0:.1f}s")
    eps = eq.compute_total_strain()
    eq.compute_elastic_stress(eps)
    eq.compute_eps_ne_rate(eq.sig_v, 0.0)
    eq.update_eps_ne_rate_old()


def bench_tm_cyclic(grid_name, fallback, label, baseline_key=None,
                    n_steps=10):
    """Timed fused-driver run of a build_tm_cyclic config, with the
    measured-CPU-baseline ratio when baseline_measured.json has the row."""
    import jax

    eq, heat = build_tm_cyclic(grid_name, fallback, label)
    init_tm(eq, heat, label)

    dt = 3600.0
    t0 = time.time()
    stats = eq.solve_tm_time_steps(heat, [dt], [dt], tol=1e-6, maxiter=20)
    jax.block_until_ready(eq.u)
    log(f"[{label}] TM first fused step (incl. compile): "
        f"{time.time()-t0:.1f}s (conv={int(stats[0, 5])})")
    t0 = time.time()
    stats = eq.solve_tm_time_steps(
        heat, [(k + 2) * dt for k in range(n_steps)], [dt] * n_steps,
        tol=1e-6, maxiter=20)
    jax.block_until_ready(eq.u)
    conv = (stats[:, 5] > 0.5)
    n_ok = int(conv.astype(int).cumprod().sum())
    per = (time.time() - t0) / max(n_ok, 1)
    ratio = measured_ratio(baseline_key, per) if baseline_key else None
    vs = (f", vs measured CPU baseline "
          f"{MEASURED[baseline_key]['s_per_step']:.2f} s/step = "
          f"{ratio:.1f}x" if ratio else "")
    log(f"[{label}] TM cyclic (fused driver): {per*1000:.1f} ms/step over "
        f"{n_ok}/{n_steps} steps ({stats[:n_ok, 2].mean():.1f} "
        f"fp-iters/step, {stats[:n_ok, 4].mean():.0f} krylov-iters/step, "
        f"heat {stats[:n_ok, 0].mean():.0f} cg-iters/step){vs}")


def main():
    """Headline cell first, then every other section; one process."""
    import jax
    import safeincave_tpu  # noqa: F401  (x64)

    require_gpu()
    device = device_record()
    device_peaks(device["kind"])

    def section(name):
        log(f"section: {name} (timings below on {device['kind']})")

    eq = build()
    dofs = eq.n_nodes * 3
    log(f"devices: {jax.devices()}  dofs: {dofs}")

    eq.bc.update_dirichlet(0.0)
    eq.bc.update_neumann(0.0)
    t0 = time.time()
    eq.solve_elastic_response()
    jax.block_until_ready(eq.u)
    log(f"elastic solve (incl. compile): {time.time() - t0:.2f}s, "
        f"krylov iters={eq.solver_stats[0]}, res={eq.solver_stats[1]:.2e}")
    eps = eq.compute_total_strain()
    eq.compute_elastic_stress(eps)
    eq.compute_eps_ne_rate(eq.sig_v, 0.0)
    eq.update_eps_ne_rate_old()

    dt = 3600.0
    n_steps = 20

    # production driver: Simulator_M auto-fuses the steps between output/
    # checkpoint boundaries into one device dispatch (solve_time_steps);
    # per-step convergence control runs ON DEVICE with identical
    # commit-only-if-converged semantics, the host syncs once per chunk.
    # A step the chunk could not converge is re-attempted pure-f64 from its
    # preserved entry state - exactly Simulator_M's retry flow - and counts
    # toward the measured wall-clock.
    def run_chunk(ts_list):
        rows, retries = [], 0
        pending = list(ts_list)
        while pending:
            stats = eq.solve_time_steps(pending, [dt] * len(pending),
                                        tol=1e-8, maxiter=40)
            conv = (stats[:, 5] > 0.5).astype(int)
            n_ok = int(conv.cumprod().sum())
            rows.extend(stats[:n_ok])
            if n_ok == len(pending):
                break
            eq._fp32_disable = True     # retry the failed step pure-f64
            ite, errv = eq.solve_time_step(pending[n_ok], dt, tol=1e-8,
                                           maxiter=40)
            eq._fp32_disable = False
            if not errv <= 1e-8:
                raise RuntimeError(f"f64 retry failed: err={errv:.3e}")
            eq.commit_time_step(dt)
            rows.append(np.asarray([ite, errv, eq.krylov_total,
                                    eq.solver_stats[0], eq.solver_stats[1],
                                    1.0]))
            retries += 1
            pending = pending[n_ok + 1:]
        return np.asarray(rows), retries

    t0 = time.time()
    run_chunk([(k + 1) * dt for k in range(n_steps)])
    jax.block_until_ready(eq.u)
    log(f"first fused chunk ({n_steps} steps, incl. compile): "
        f"{time.time() - t0:.2f}s")
    t0 = time.time()
    s2, retries = run_chunk([(n_steps + 1 + k) * dt for k in range(n_steps)])
    jax.block_until_ready(eq.u)
    elapsed = time.time() - t0
    per_step = elapsed / n_steps
    log(f"{n_steps} steps (fused driver) on {device['kind']}: "
        f"{elapsed:.3f}s ({per_step*1000:.1f} ms/step, "
        f"{s2[:, 0].mean():.1f} fp-iters/step, "
        f"{s2[:, 2].mean():.0f} krylov-iters/step, {retries} f64 retries), "
        f"final err={s2[-1, 1]:.2e}")

    headline = {
        "metric": "newton_step_wallclock_cavern600",
        "value": per_step,
        "unit": "s/step",
        "vs_baseline": REFERENCE_SECONDS_PER_STEP / per_step,
        "device": device,
    }
    r = measured_ratio("cavern600_mech", per_step)
    if r:
        headline["vs_baseline_measured"] = r
    print(json.dumps(headline), flush=True)

    section("matvec roofline at scale (500k-tet box)")
    bench_matvec_scale()
    # BASELINE configs 4-5: 1200-class TM cyclic + interlayer multi-material
    # (grids/cavern_interlayer_1200: 6 regions incl. Overburden)
    for grid_name, label, bkey in (
            ("cavern_proxy_1200", "regular1200-TM", "regular1200_tm"),
            ("cavern_interlayer_1200", "interlayer1200-TM",
             "interlayer1200_tm"),
            ("cavern_interlayer_proxy", "interlayer600-TM",
             "interlayer600_tm")):
        section(label)
        bench_tm_cyclic(grid_name, None, label, baseline_key=bkey)
    section("matvec roofline (cavern600)")
    bench_matvec(eq)
    section("TM coupled config (cavern600)")
    bench_tm(eq)
    section("per-step host-sync comparison")
    bench_hostsync(eq, dt, n_steps)


def bench_hostsync(eq, dt, n_steps):
    """Reference-style per-step host-controlled loop (comparison mode):
    one dispatch and one host sync per step."""
    import jax
    t_base = (2 * n_steps + 2) * dt
    t0 = time.time()
    ite, err = eq.solve_time_step(t_base, dt, tol=1e-8, maxiter=40)
    jax.block_until_ready(eq.u)
    log(f"first per-step solve (incl. compile): {time.time()-t0:.2f}s, "
        f"iters={ite}, err={err:.2e}, krylov_total={eq.krylov_total}")
    eq.commit_time_step(dt)

    iters_total = 0
    kry_total = 0
    t0 = time.time()
    for k in range(n_steps):
        t = t_base + (k + 1) * dt
        ite, err = eq.solve_time_step(t, dt, tol=1e-8, maxiter=40)
        iters_total += ite
        kry_total += eq.krylov_total
        eq.commit_time_step(dt)
    jax.block_until_ready(eq.u)
    elapsed = time.time() - t0
    log(f"{n_steps} steps (per-step host sync): {elapsed:.3f}s "
        f"({elapsed/n_steps*1000:.1f} ms/step, "
        f"{iters_total/n_steps:.1f} fp-iters/step, "
        f"{kry_total/n_steps:.0f} krylov-iters/step), final err={err:.2e}, "
        f"last-solve res={eq.solver_stats[1]:.2e}")


if __name__ == "__main__":
    main()
