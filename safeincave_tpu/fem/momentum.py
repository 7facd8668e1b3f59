"""Linear momentum equation: matrix-free theta-scheme thermo-inelastic solver.

Reference: /root/reference/safeincave/MomentumEquation.py:36-1029.  One
linearized step is:

    CT  = (C_inv + dt(1-theta) G)^-1                       (consistent tangent)
    eps_rhs = eps_ne_k + eps_th - dt(1-theta)(B + G:sigma_k)
    a(du, v) = <CT eps(du), eps(v)>          (matrix-free stiffness action)
    L(v)     = body + neumann + <CT eps_rhs, eps(v)>
    solve via preconditioned Krylov with Dirichlet masking/lifting

All state is Voigt (N, 6) per element; the linear solve is a single jitted
``lax.while_loop``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp

from ..linalg import inv3x3
from ..utils import VOIGT_WEIGHT, voigt_to_tensor
from ..materials.base import _as_voigt
from .kernels import MomentumKernel
from .solvers import cg_solve, bicgstab_solve, ir_solve


@dataclass
class SolverSettings:
    """Krylov settings (stands in for PETSc KSP config,
    reference Simulators.py:1052-1086).

    ``precision="mixed"`` (the default) runs the Krylov iterations in
    f32 under an f64 defect-correction loop (see fem/solvers.py:ir_solve);
    the convergence criterion is still the f64 relative residual ``rtol``.
    ``precision="f64"`` runs everything in f64 (bit-closest to the PETSc
    reference).
    """
    method: str = "bicgstab"   # "cg" | "bicg" | "bicgstab" | "bcgs" | "gmres"
    rtol: float = 1e-12
    max_it: int = 2000          # per-pass Krylov iteration cap
    precision: str = "mixed"    # "mixed" | "f64"
    # f32 pass target: safely above the f32 matvec noise floor (the cumsum
    # assembly adds ~3e-6 relative noise); the f64 refinement loop supplies
    # the remaining decades at ~one cheap pass per 1e-4 reduction
    inner_rtol: float = 1e-4
    max_passes: int = 12        # defect-correction passes (mixed only)
    # "dense" = full dense inverse of the (constant) masked elastic
    # operator, built once per wiring and applied as one dense matvec per
    # Krylov iteration - since CT is an O(dt/eta) perturbation of C, the
    # preconditioned iteration converges in a handful of steps.  Memory is
    # (3 n_nodes)^2 f32, so it is gated by dense_max_dofs; "auto" (default)
    # picks dense below the gate and 2level above.
    # "2level" = block-Jacobi smoother + dense coarse-space correction over
    # contiguous node aggregates (stands in for the reference's ASM/ILU,
    # far stronger than Jacobi for 3D elasticity); "jacobi" = nodal blocks
    precond: str = "auto"       # "auto" | "dense" | "2level" | "jacobi"
    dense_max_dofs: int = 30_000   # dense-inverse gate (~3.6 GB f32 at 30k)
    # Store/apply the dense inverse in bfloat16: halves the device-memory
    # bytes of the dominant per-Krylov-iteration term, at the cost of an
    # 8-bit mantissa (more Krylov iterations).  Off by default; useful when
    # memory capacity (not time) gates the dense P.
    precond_bf16: bool = False
    coarse_agg: int = 16        # nodes per coarse aggregate
    # adaptive_rtol=True solves the linearized systems only ~2 decades
    # tighter than the fixed-point error (Eisenstat-Walker), converging to
    # full-rtol solves with hysteresis.  Worth it when the linear solve
    # dominates an iteration (very large meshes / weak preconditioning);
    # at cavern-bench scale a tight solve costs barely more than a loose
    # one while the gate costs ~2 extra fixed-point iterations of tangent
    # + ISV work, so the default is the reference's always-tight semantics
    # (PETSc rtol=1e-12 every iteration, Simulators.py:1075-1086).
    adaptive_rtol: bool = False
    # lag_tangent=True rebuilds the consistent tangent suite (G, CT, B and
    # the ISV linearization scalars) only when needed - first f64 iteration,
    # an iteration whose error failed to contract under the lagged tangent,
    # or a convergence candidate (err within 10x of tol) - instead of every
    # fixed-point iteration like the reference (MomentumEquation.py:799-820).
    # Every solve stays tight (rtol), and convergence is only declared on a
    # FRESH-tangent iteration, so committed fields satisfy the identical
    # f64 fixed-point criterion; the lag shapes the iteration path (changes
    # fields by O(tol) iteration noise), not the fixed point - the tangent's
    # G:(sigma-sigma_k) corrector terms vanish at convergence.  Off by
    # default to keep golden trajectories bit-identical; the benchmark
    # regime enables it (tangent rebuild+CT inversion is a top per-step
    # cost at cavern scale).
    lag_tangent: bool = False
    # fp32_phase="auto" runs the EARLY fixed-point iterations of each time
    # step entirely in float32 (tangents, assembly, Krylov, stress/ISV
    # updates) while the strain-change error is above fp32_switch, then
    # finishes in float64.  Convergence is only ever declared after a
    # float64 iteration with a full-rtol solve, so converged states satisfy
    # the same f64 criterion as the pure-f64 path; the f32 sweep only
    # shortens the road there.  "auto" enables it on accelerators (f32
    # runs at twice the f64 rate there) and disables it on CPU (keeps
    # trajectories bit-comparable to the reference for the golden tests).
    # Set True/False to force.
    fp32_phase: object = "auto"
    fp32_switch: float = 1e-4

    def fp32_enabled(self) -> bool:
        if self.fp32_phase == "auto":
            return jax.default_backend() != "cpu"
        return bool(self.fp32_phase)

    def solve_fn(self):
        return cg_solve if self.method == "cg" else bicgstab_solve


def _block_jacobi_arrays(kern, CT, mask):
    """Masked nodal 3x3 block inverses (the Jacobi smoother data)."""
    blk = kern.block_diagonal(CT)
    blk = blk * mask[:, :, None] * mask[:, None, :]
    blk = blk + (1.0 - mask)[:, :, None] * jnp.eye(3, dtype=blk.dtype)[None]
    return inv3x3(blk)


def _blk_apply(inv, r):
    """(N,3,3) block apply in stacked full-lane form."""
    inv_t = jnp.transpose(inv, (1, 2, 0)).astype(r.dtype)     # (3,3,N)
    return (inv_t * r.T[None]).sum(1).T


def _coarse_space(kern, CT, mask, G, agg_of_node=None):
    """Dense coarse operator over node aggregates.

    Default aggregates are G consecutive node ids (nodes are Morton/band
    ordered by mesh/reorder.py, so they are spatially compact, and the
    restriction is a pure reshape-sum with no indexed memory ops in the
    Krylov loop).  ``agg_of_node`` (n_nodes,) overrides the aggregate
    assignment for callers whose restriction is a segment-sum anyway
    (parallel/halo.halo_two_level Morton-sorts internally).  The coarse
    matrix R A R^T is assembled from the per-element 12x12 stiffness
    (Dirichlet rows/cols masked at the fine level) and inverted densely in
    f32; it is a preconditioner, so f32 is ample.

    Returns (coarse_inv (3n_agg, 3n_agg) f32, n_agg, pad).
    """
    n_nodes = kern.n_nodes
    if agg_of_node is None:
        n_agg = -(-n_nodes // G)
    else:
        n_agg = int(np.asarray(agg_of_node).max()) + 1
    pad = n_agg * G - n_nodes

    Ke = _element_stiffness(kern, CT)
    # fine-level Dirichlet elimination (the masked operator's coarse image)
    mrows = mask[kern.conn]                                    # (E,4,3)
    Ke = Ke * mrows[:, :, :, None, None] * mrows[:, None, None, :, :]

    if agg_of_node is None:
        agg = kern.conn // G                                   # (E,4)
    else:
        agg = jnp.asarray(agg_of_node)[kern.conn]
    pair = (agg[:, :, None] * n_agg + agg[:, None, :])         # (E,4,4)
    flat = jnp.transpose(Ke, (0, 1, 3, 2, 4)).reshape(-1, 3, 3)
    Ac = jax.ops.segment_sum(flat, pair.reshape(-1),
                             num_segments=n_agg * n_agg)
    Ac = Ac.reshape(n_agg, n_agg, 3, 3).transpose(0, 2, 1, 3)
    Ac = Ac.reshape(3 * n_agg, 3 * n_agg).astype(jnp.float32)
    # Condition the f32 inversion: scale to O(1), regularize the diagonal
    # (empty/Dirichlet-only aggregate rows become identity; near-singular
    # aggregates - e.g. non-locality-ordered meshes where "G consecutive
    # ids" are spatially scattered unions - get a bounded inverse), and
    # SYMMETRIZE the result.  An unsymmetrized f32 LU inverse of an
    # ill-conditioned Ac can be several-percent asymmetric, which silently
    # turns the preconditioner indefinite and makes CG/BiCGStab diverge
    # outright (observed on the raw gmsh-ordered cavern mesh).
    d = jnp.diagonal(Ac)
    scale = jnp.maximum(jnp.abs(d).max(), 1e-30)
    Acs = Ac / scale + 1e-6 * jnp.eye(Ac.shape[0], dtype=jnp.float32)
    inv = jnp.linalg.inv(Acs)
    inv = 0.5 * (inv + inv.T) / scale
    return inv, n_agg, pad


def _two_level_apply(blk_inv, coarse_inv, mask, r, n_agg, G, pad):
    """Additive two-level preconditioner: block-Jacobi + coarse correction."""
    z = _blk_apply(blk_inv, r)
    rp = jnp.pad(r * mask, ((0, pad), (0, 0)))
    rc = rp.reshape(n_agg, G, 3).sum(axis=1).astype(jnp.float32)
    zc = (coarse_inv @ rc.reshape(-1)).reshape(n_agg, 3)
    zf = jnp.repeat(zc, G, axis=0)[:r.shape[0]].astype(r.dtype)
    return z + zf * mask


def build_preconditioner(kern, C, mask, settings: SolverSettings):
    """(P, apply) for the masked operator, where ``P`` is a pytree of
    concrete preconditioner arrays and ``apply(P, r, mask)`` the (dtype-
    polymorphic) application.  P is threaded through the jitted solvers as
    an ARGUMENT - closing over it would embed gigabyte-scale constants
    (the dense inverse) into every executable.

    Built from the **constant elastic stiffness C** and the (static)
    Dirichlet mask, so it is computed eagerly once per wiring: the
    consistent tangent CT only perturbs C by the per-step creep
    compliance, and a slightly lagged preconditioner costs a few extra
    Krylov iterations while saving all per-solve setup.  The dense/coarse
    modes need the unsharded kernel's global geometry; the SPMD path keeps
    pure block-Jacobi (its psum'd blocks are already global).
    """
    local = hasattr(kern, "_scat_perm")   # unsharded kernel => global view
    mode = settings.precond
    if mode == "auto":
        # the dense inverse is an accelerator design (one dense matvec per
        # apply, O(n^3) f32 build done once per wiring); on the CPU backend
        # that build costs minutes at cavern scale, while the 2-level
        # scheme is a few percent as expensive and plenty strong
        on_accel = jax.default_backend() != "cpu"
        mode = ("dense" if local and on_accel and 3 * kern.n_nodes <=
                settings.dense_max_dofs else "2level")

    if mode == "dense" and local:
        inv = _dense_inverse_precond(kern, C, mask)
        if settings.precond_bf16:
            inv = inv.astype(jnp.bfloat16)

        def apply_dense(P, r, m):
            (inv,) = P
            x = jnp.matmul(inv, r.reshape(-1).astype(inv.dtype),
                           preferred_element_type=jnp.float32)
            return x.reshape(-1, 3).astype(r.dtype)

        return (inv,), apply_dense

    blk_inv = _block_jacobi_arrays(kern, C, mask)
    if mode == "2level" and local:
        G = settings.coarse_agg
        coarse_inv, n_agg, pad = _coarse_space(kern, C, mask, G)

        def apply_2l(P, r, m):
            blk_inv, coarse_inv = P
            return _two_level_apply(blk_inv, coarse_inv, m.astype(r.dtype),
                                    r, n_agg, G, pad)

        return (blk_inv, coarse_inv), apply_2l

    def apply_bj(P, r, m):
        (blk_inv,) = P
        return _blk_apply(blk_inv, r)

    return (blk_inv,), apply_bj


def _element_stiffness(kern, C):
    """Per-element 12x12 stiffness blocks Ke (E, 4, 3, 4, 3), f64, eager."""
    g = kern.grad_N
    E3 = jnp.eye(3, dtype=g.dtype)
    gi = g[:, :, None, :]
    ei = E3[None, None, :, :]
    xx = ei[..., 0] * gi[..., 0]
    yy = ei[..., 1] * gi[..., 1]
    zz = ei[..., 2] * gi[..., 2]
    xy = 0.5 * (ei[..., 0] * gi[..., 1] + ei[..., 1] * gi[..., 0])
    xz = 0.5 * (ei[..., 0] * gi[..., 2] + ei[..., 2] * gi[..., 0])
    yz = 0.5 * (ei[..., 1] * gi[..., 2] + ei[..., 2] * gi[..., 1])
    eps6 = jnp.stack([xx, yy, zz, xy, xz, yz], axis=-1)       # (E,4,3,6)
    w = jnp.asarray([1., 1., 1., 2., 2., 2.], dtype=g.dtype)
    sig6 = jnp.einsum("ekl,ebjl->ebjk", C, eps6)
    return jnp.einsum("ebjk,eaik,k,e->eaibj", sig6, eps6, w, kern.vol)


def _dense_inverse_precond(kern, C, mask):
    """Dense f32 inverse of the masked elastic operator (once per wiring).

    The assembled matrix is (3 n_nodes)^2; assembly happens host-side in
    numpy (np.add.at over the element blocks), the inverse on-device in f32
    (preconditioner precision is irrelevant to the converged solution -
    the Krylov residual test stays f64).  Each apply is then a single
    memory-bound dense matvec.  This stands in for PETSc's strong ASM/ILU
    preconditioning at cavern-mesh scale (16k-23k DOFs): trading device
    memory for iteration count.
    """
    n = kern.n_nodes
    Ke = _element_stiffness(kern, C)                          # device, f64
    # flat scatter indices, built host-side (14 MB of int32 vs shipping the
    # gigabyte-scale assembled matrix through the host<->device link)
    conn = np.asarray(kern.grid.conn)
    dof = (3 * conn[:, :, None].astype(np.int64)
           + np.arange(3)[None, None, :])                     # (E,4,3)
    rows = np.repeat(dof.reshape(-1, 12), 12, axis=1).reshape(-1)
    cols = np.tile(dof.reshape(-1, 12), (1, 12)).reshape(-1)
    flat_idx = (rows * (3 * n) + cols).astype(np.int64)

    @jax.jit
    def _assemble(Ke, m):
        A = jnp.zeros((3 * n) * (3 * n), dtype=jnp.float32)
        A = A.at[flat_idx].add(Ke.reshape(-1).astype(jnp.float32))
        A = A.reshape(3 * n, 3 * n)
        A = A * m[:, None] * m[None, :]
        d = jnp.diagonal(A)
        scale = jnp.abs(d).max()
        A = A / scale
        A = A + jnp.diag(1.0 - m)
        return A, scale

    A32, scale = _assemble(Ke, jnp.asarray(mask).reshape(-1)
                           .astype(jnp.float32))
    return jnp.linalg.inv(A32) / scale


def _make_masked_solver(kern, settings: SolverSettings, apply_M,
                        zero_dirichlet: bool = False):
    """Build solve_lin(CT, b, mask, u_bc, x0, rtol, P)
    -> (x, iters, res, b_eff_norm).

    ``b_eff_norm`` is the norm of the RHS actually solved (force RHS plus
    the Dirichlet lifting term), so callers can scale divergence gates
    correctly even for displacement-driven steps where ``||mask*b|| ~ 0``.

    Applies Dirichlet conditions by masking + lifting (the matrix-free
    equivalent of PETSc apply_lifting/set_bc, reference
    MomentumEquation.py:908-922) and dispatches to the configured
    mixed-precision or straight-f64 Krylov solve.  ``rtol`` is traced so the
    nonlinear loop can adapt it per iteration; ``P`` carries the prebuilt
    preconditioner arrays (build_preconditioner), applied via ``apply_M``.
    ``zero_dirichlet=True`` (static, from BcHandler.all_zero_dirichlet)
    drops the lifting matvec A @ u_bc - a full f64 stiffness action per
    solve that is identically zero for homogeneous supports.
    """
    solve = settings.solve_fn()
    mixed = settings.precision == "mixed"

    def solve_lin(CT, b, mask, u_bc, x0, rtol, P):
        CT_hi = kern.prep(CT)
        # assembled operators (one on-device assembly per linearized
        # solve, every matvec in BOTH precisions then a dense streaming
        # op): block-DIA (zero-gather shifts, fem/dia.py) when the node
        # numbering is offset-structured, else block-ELL (fem/blockell.py)
        bell = getattr(kern, "dia", None) or getattr(kern, "blockell", None)
        # structured block-DIA: f32 assembly is ~16x cheaper than the
        # f64-emulated one, and the f64 action is only needed once per
        # refinement pass - keep it matrix-free and assemble f32 only
        dia_structured = bell is not None and getattr(bell, "structured",
                                                      False)
        if bell is not None and not dia_structured:
            blocks_hi = bell.assemble(CT_hi)

            def mv_hi(x):
                return bell.matvec(blocks_hi, x)
        else:
            def mv_hi(x):
                return kern.matvec(CT_hi, x)

        def Aop(x):
            return mask * mv_hi(mask * x) + (1.0 - mask) * x

        def M_inv(r):
            return apply_M(P, r, mask)

        if zero_dirichlet:
            b_eff = mask * b
        else:
            b_eff = (mask * (b - mv_hi(u_bc))
                     + (1.0 - mask) * u_bc)
        b_eff_norm = jnp.sqrt(jnp.vdot(b_eff.reshape(-1),
                                       b_eff.reshape(-1)))
        if mixed:
            mask32 = mask.astype(jnp.float32)
            if dia_structured:
                blocks_lo = bell.assemble(kern.prep(
                    CT.astype(jnp.float32)))

                def Aop32(x):
                    return (mask32 * bell.matvec(blocks_lo, mask32 * x)
                            + (1.0 - mask32) * x)
            elif bell is not None:
                blocks_lo = blocks_hi.astype(jnp.float32)

                def Aop32(x):
                    return (mask32 * bell.matvec(blocks_lo, mask32 * x)
                            + (1.0 - mask32) * x)
            else:
                CT_lo = kern.prep(CT.astype(jnp.float32))

                def Aop32(x):
                    return (mask32 * kern.matvec(CT_lo, mask32 * x)
                            + (1.0 - mask32) * x)

            def M_inv32(r):
                return apply_M(P, r, mask32)

            x, k, res = ir_solve(Aop, Aop32, b_eff, x0, M_inv32,
                                 inner_solve=solve, rtol=rtol,
                                 inner_rtol=settings.inner_rtol,
                                 inner_maxiter=settings.max_it,
                                 max_passes=settings.max_passes)
            # ultimate fallback: when the f32-inner passes stagnate above
            # the target (ill-conditioned / strongly non-normal tangents,
            # e.g. widespread Desai yielding), finish in pure f64 from the
            # best mixed iterate.  Compiled once, executed only on
            # stagnation, so the common case keeps native-f32 speed while
            # robustness matches the all-f64 path.
            need_f64 = res > rtol * b_eff_norm

            def f64_finish(_):
                x2, k2, res2 = solve(Aop, b_eff, x, M_inv, rtol=rtol,
                                     maxiter=settings.max_it)
                # keep whichever iterate has the smaller residual (the f64
                # solver can itself break down on a hostile system)
                better = jnp.isfinite(res2) & (res2 < res)
                return (jnp.where(better, x2, x), k + k2,
                        jnp.where(better, res2, res))

            x, k, res = jax.lax.cond(need_f64, f64_finish,
                                     lambda _: (x, k, res), None)
            return x, k, res, b_eff_norm
        x, k, res = solve(Aop, b_eff, x0, M_inv, rtol=rtol,
                          maxiter=settings.max_it)
        return x, k, res, b_eff_norm

    return solve_lin


class LinearMomentumBase:
    """Common fields, invariant smoothing, ISV orchestration
    (reference MomentumEquation.py:36-701)."""

    def __init__(self, grid, theta: float):
        self.grid = grid
        self.theta = theta
        self.kernel = MomentumKernel(grid)
        self.n_elems = grid.n_elems
        self.n_nodes = grid.n_nodes

        self.T0 = jnp.asarray(np.zeros(self.n_elems))
        self.Temp = jnp.asarray(np.zeros(self.n_elems))
        self.u = jnp.asarray(np.zeros((self.n_nodes, 3)))
        self.sig_v = jnp.asarray(np.zeros((self.n_elems, 6)))
        self.eps_tot_v = jnp.asarray(np.zeros((self.n_elems, 6)))
        self.q_nodes = jnp.asarray(np.zeros(self.n_nodes))
        self.q_elems = jnp.asarray(np.zeros(self.n_elems))
        self.p_nodes = jnp.asarray(np.zeros(self.n_nodes))
        self.p_elems = jnp.asarray(np.zeros(self.n_elems))
        self.b_body = jnp.asarray(np.zeros((self.n_nodes, 3)))
        self.solver = SolverSettings()
        self.solver_stats = (0, 0.0)
        self.krylov_total = 0

    # -- wiring ----------------------------------------------------------- #
    def set_material(self, material):
        self.mat = material
        self.initialize()

    def set_T(self, T):
        self.Temp = jnp.asarray(T, dtype=jnp.float64)

    def set_T0(self, T0):
        self.T0 = jnp.asarray(T0, dtype=jnp.float64)

    def set_solver(self, solver: SolverSettings):
        self.solver = solver

    def set_boundary_conditions(self, bc):
        self.bc = bc

    def build_body_force(self, g: list):
        self.g_vec = list(g)
        self.b_body = self.kernel.body_force(self.mat.density, g)

    # -- invariants + smoothing (reference :287-324, 944-976) -------------- #
    def _q_dg0(self):
        s = self.sig_v
        I1 = s[:, 0] + s[:, 1] + s[:, 2]
        I2 = (s[:, 0] * s[:, 1] + s[:, 1] * s[:, 2] + s[:, 0] * s[:, 2]
              - s[:, 3] ** 2 - s[:, 4] ** 2 - s[:, 5] ** 2)
        J2 = I1 ** 2 / 3.0 - I2
        return jnp.sqrt(jnp.maximum(3.0 * J2, 0.0))

    def compute_q_nodes(self):
        self.q_nodes = self.grid.elems_to_nodes(self._q_dg0())

    def compute_q_elems(self):
        self.q_elems = self.grid.smooth_elems(self._q_dg0())

    def compute_p_nodes(self):
        p = (self.sig_v[:, 0] + self.sig_v[:, 1] + self.sig_v[:, 2]) / 3.0
        self.p_nodes = self.grid.elems_to_nodes(p)

    def compute_p_elems(self):
        p = (self.sig_v[:, 0] + self.sig_v[:, 1] + self.sig_v[:, 2]) / 3.0
        self.p_elems = self.grid.smooth_elems(p)

    # -- strain / ISV orchestration (reference :326-454) ------------------- #
    def compute_total_strain(self):
        self.eps_tot_v = self.kernel.strain(self.u)
        return self.eps_tot_v

    def compute_eps_th(self):
        eps_th = jnp.zeros((self.n_elems, 6), dtype=jnp.float64)
        dT = self.Temp - self.T0
        for elem_th in self.mat.elems_th:
            eps_th = eps_th + elem_th.eps_th_voigt(dT)
        return eps_th

    def compute_eps_ne_k(self, dt):
        eps_k = jnp.zeros((self.n_elems, 6), dtype=jnp.float64)
        for e in self.mat.elems_ne:
            e.compute_eps_ne_k(dt * self.theta, dt * (1 - self.theta))
            eps_k = eps_k + e.state["eps_k"]
        return eps_k

    def compute_eps_ne_rate(self, stress, dt):
        sv = _as_voigt(stress)
        for e in self.mat.elems_ne:
            e.state = e.f_rate(e.state, sv, dt * self.theta, self.Temp)

    def update_eps_ne_rate_old(self):
        for e in self.mat.elems_ne:
            e.update_eps_ne_rate_old()

    def update_eps_ne_old(self, stress, stress_k, dt):
        sv, sv_k = _as_voigt(stress), _as_voigt(stress_k)
        for e in self.mat.elems_ne:
            e.state = e.f_update_eps_old(e.state, sv, sv_k,
                                         dt * (1 - self.theta))

    def increment_internal_variables(self, stress, stress_k, dt):
        sv, sv_k = _as_voigt(stress), _as_voigt(stress_k)
        for e in self.mat.elems_ne:
            e.state = e.f_increment_isv(e.state, sv, sv_k, dt)

    def update_internal_variables(self):
        for e in self.mat.elems_ne:
            e.state = e.f_commit_isv(e.state)

    # -- dt-retry snapshots (reference :456-494) --------------------------- #
    def save_internal_state(self):
        self._saved_state = [dict(e.state) for e in self.mat.elems_ne]

    def restore_internal_state(self):
        for e, st in zip(self.mat.elems_ne, self._saved_state):
            e.state = dict(st)

    def run_after_solve(self):
        """User extension hook (reference :510-518)."""
        pass

    # -- tensor views ------------------------------------------------------ #
    @property
    def sig(self):
        return voigt_to_tensor(self.sig_v)

    @property
    def eps_tot(self):
        return voigt_to_tensor(self.eps_tot_v)


class LinearMomentum(LinearMomentumBase):
    """Concrete formulation (reference MomentumEquation.py:707-1029).

    Two execution paths:

    * the reference-compatible mutating methods (``solve``,
      ``compute_stress``, ...) for users porting reference scripts;
    * :meth:`solve_time_step` - the whole fixed-point iteration of
      reference Simulators.py:404-438 as ONE jitted ``lax.while_loop``
      program (tangents, RHS, Krylov solve, stress/ISV updates, error norm),
      cached per (material, bc, solver) wiring.  This is the fast path:
      a single device dispatch per time step.
    """

    def __init__(self, grid, theta: float, auto_backend: bool = True):
        super().__init__(grid, theta)
        self.eps_rhs_v = jnp.asarray(np.zeros((self.n_elems, 6)))
        self._jit_solve = None
        self._jit_step = None
        self._jit_step_key = None
        self._jit_msteps = None
        self._precond = None
        # Operator auto-selection on accelerators: an offset-structured
        # node numbering (regular boxes) gets the zero-gather block-DIA
        # operator (fem/dia.py, both precisions); every other numbering,
        # reordered meshes included, keeps the matrix-free cumsum kernel.
        # This is a choice of operator by mesh numbering, not of device.
        # Opt out with auto_backend=False.
        if auto_backend and jax.default_backend() != "cpu":
            if getattr(grid, "reorder_method", None) in (None, "natural"):
                try:
                    self.kernel.enable_dia()
                except ValueError:
                    pass   # unstructured numbering: keep the cumsum kernel

    def set_solver(self, solver):
        super().set_solver(solver)
        self._jit_solve = None
        self._jit_step = None
        self._jit_msteps = None
        self._precond = None

    def set_boundary_conditions(self, bc):
        super().set_boundary_conditions(bc)
        self._jit_step = None
        self._jit_msteps = None
        self._precond = None

    def initialize(self):
        self.C = self.mat.C

    def enable_dia_matvec(self, max_offsets: int = 96,
                          min_fill: float = 0.4):
        """Route the Krylov stiffness action (both precisions) through the
        assembled block-DIA operator (fem/dia.py): one on-device assembly
        per linearized solve, then every matvec is a zero-gather
        shift-multiply-accumulate streaming the offset value planes.
        Requires an offset-structured node numbering (regular
        GridBox grids qualify; raises ValueError otherwise).  Converged
        results are identical (same operator, same f64 residual tests)."""
        self.kernel.enable_dia(max_offsets=max_offsets, min_fill=min_fill)
        self._jit_solve = None
        self._jit_step = None
        self._jit_step_key = None
        self._jit_msteps = None
        self._jit_tm_msteps = None
        self._jit_tm_key = None
        self._jit_commit = None

    def enable_blockell_matvec(self, G: int = 8):
        """Route the Krylov stiffness action (both precisions) through the
        assembled block-ELL operator (fem/blockell.py): one on-device
        assembly per linearized solve, then every matvec is a batched
        dense matmul + one small gather instead of the element
        formulation's per-element gather and scatter.  Any node ordering works;
        band (RCM) ordering keeps the neighbour-group count K small.
        Converged results are identical (same operator, same f64
        residual tests)."""
        self.kernel.enable_blockell(G=G)
        self._jit_solve = None
        self._jit_step = None
        self._jit_step_key = None
        self._jit_msteps = None
        self._jit_tm_msteps = None
        self._jit_tm_key = None
        self._jit_commit = None

    def compute_CT(self, stress_k, dt):
        sv_k = _as_voigt(stress_k)
        states = [e.state for e in self.mat.elems_ne]
        states, G, B6 = self.mat.f_tangent_all(states, sv_k, self.Temp, dt,
                                               self.theta)
        for e, st in zip(self.mat.elems_ne, states):
            e.state = st
        self.mat.G = G
        self.mat.B6 = B6
        self.mat.CT = self.mat.f_CT(G, dt, self.theta)

    def compute_elastic_stress(self, eps_e):
        ev = _as_voigt(eps_e)
        self.sig_v = jnp.einsum("nij,nj->ni", self.mat.C, ev)
        return self.sig_v

    def compute_stress(self, eps_tot, *_):
        ev = _as_voigt(eps_tot)
        self.sig_v = jnp.einsum("nij,nj->ni", self.mat.CT,
                                ev - self.eps_rhs_v)
        return self.sig_v

    def compute_eps_rhs(self, dt, stress_k):
        sv_k = _as_voigt(stress_k)
        eps_ne_k = self.compute_eps_ne_k(dt)
        eps_th = self.compute_eps_th()
        G_sk = jnp.einsum("nij,nj->ni", self.mat.G, sv_k)
        self.eps_rhs_v = (eps_ne_k + eps_th
                          - dt * (1 - self.theta) * (self.mat.B6 + G_sk))

    # ------------------------------------------------------------------ #
    def _get_precond(self):
        """(P, apply): constant preconditioner arrays built eagerly from C +
        the static Dirichlet mask (see build_preconditioner).  In halo mode
        the blocks live in the padded owner-sharded layout."""
        if self._precond is None:
            if not hasattr(self.bc, "mask"):
                self.bc.update_dirichlet(0.0)
            halo = getattr(self, "_halo", None)
            if halo is not None:
                from ..parallel.halo import (halo_block_jacobi,
                                             halo_two_level)
                if self.solver.precond == "jacobi":
                    self._precond = halo_block_jacobi(halo, self.mat.C,
                                                      self.bc.mask)
                else:
                    # default ("auto"/"2level"/"dense"): block-Jacobi
                    # smoother + replicated dense coarse correction, so
                    # Krylov iteration counts stay flat as device count and
                    # mesh size grow (the sharded stand-in for the
                    # reference's ASM/ILU, Simulators.py:1075-1086)
                    self._precond = halo_two_level(halo, self.mat.C,
                                                   self.bc.mask,
                                                   G=self.solver.coarse_agg)
            else:
                self._precond = build_preconditioner(
                    self.kernel, self.mat.C, self.bc.mask, self.solver)
        return self._precond

    def _make_solver(self, apply_M):
        """Masked linear solver bound to the execution mode: halo
        (owner-sharded Krylov, O(interface) comm per matvec) when
        shard_equation(..., mode='halo') installed one, else the kernel
        path (single-device SoA or replicated-psum SPMD)."""
        zero_dir = getattr(self.bc, "all_zero_dirichlet", False)
        halo = getattr(self, "_halo", None)
        if halo is not None:
            from ..parallel.halo import make_halo_masked_solver
            return make_halo_masked_solver(halo, self.solver, apply_M,
                                           zero_dirichlet=zero_dir)
        return _make_masked_solver(self.kernel, self.solver, apply_M,
                                   zero_dirichlet=zero_dir)

    def _get_jit_solve(self):
        """Cached jitted masked Krylov solve (CT, b, mask, u_bc, x0, P
        traced)."""
        if self._jit_solve is None:
            P, apply_M = self._get_precond()
            solve_lin = self._make_solver(apply_M)
            rtol = self.solver.rtol

            @jax.jit
            def _solve(CT, b, mask, u_bc, x0, P):
                return solve_lin(CT, b, mask, u_bc, x0, rtol, P)

            self._jit_solve = _solve
        return self._jit_solve

    def _linear_solve(self, CT, b):
        """Solve a(CT) u = b with Dirichlet masking + lifting."""
        mask, u_bc = self.bc.mask, self.bc.u_bc
        x0 = mask * self.u + (1.0 - mask) * u_bc
        P, _ = self._get_precond()
        x, iters, res, _ = self._get_jit_solve()(CT, b, mask, u_bc, x0, P)
        self.solver_stats = (int(iters), float(res))
        return x

    def solve_elastic_response(self):
        """Purely elastic BVP (reference :892-923)."""
        b = self.b_body + self.bc.b_neumann
        self.u = self._linear_solve(self.mat.C, b)
        self.run_after_solve()

    def solve(self, stress_k, t, dt):
        """One linearized inelastic step (reference :978-1028)."""
        self.compute_CT(stress_k, dt)
        self.compute_eps_rhs(dt, stress_k)
        b_rhs = self.kernel.internal_force(
            jnp.einsum("nij,nj->ni", self.mat.CT, self.eps_rhs_v))
        b = self.b_body + self.bc.b_neumann + b_rhs
        self.u = self._linear_solve(self.mat.CT, b)
        self.run_after_solve()

    # ------------------------------------------------------------------ #
    # Fused jitted time step (fast path)
    # ------------------------------------------------------------------ #
    def _make_fp(self):
        """Closure running ONE time step's full fixed-point iteration
        (the inner loop of reference Simulators.py:404-438) on device:
        tangent -> CT -> eps_rhs -> assemble -> Krylov -> strain -> stress ->
        ISV increment -> rates -> strain-change error, in ``lax.while_loop``
        until tol/maxiter/NaN.  Shared by the single-step program
        (:meth:`_build_jit_step`) and the fused multi-step driver
        (:meth:`_build_jit_msteps`).

        Returns ``fp(states, sv, eps_v, u0, b_ext, mask, u_bc, eps_th, Temp,
        dt, tol, maxiter, enabled, P) -> (states, sv, eps_v, u, sv_k, ite,
        err, (kry_tot, kry_last, lin_res))``.  ``enabled=False`` makes the
        whole call inert (zero iterations - used to skip the remainder of a
        fused chunk after a non-converged step).
        """
        mat = self.mat
        kern = self.kernel
        theta = self.theta
        elems_ne = list(mat.elems_ne)
        trivial_error = (theta == 1.0) or (len(elems_ne) == 0)
        adaptive = self.solver.adaptive_rtol
        # modified-Newton tangent lagging with always-tight solves (the
        # adaptive path has its own rebuild policy tied to loose/tight)
        lag = self.solver.lag_tangent and not adaptive and not trivial_error
        _, apply_M = self._get_precond()
        solve_lin = self._make_solver(apply_M)
        halo = getattr(self, "_halo", None)
        rtol_floor = self.solver.rtol
        w_err = jnp.asarray([1., 1., 1., 2., 2., 2.])
        use_fp32 = (not trivial_error) and self.solver.fp32_enabled()
        fp32_switch = self.solver.fp32_switch
        solve_raw = self.solver.solve_fn()
        max_it = self.solver.max_it
        inner_rtol = self.solver.inner_rtol
        zero_dir = getattr(self.bc, "all_zero_dirichlet", False)

        def _phase32(states, sv, eps_v, u, b_ext, mask, u_bc, eps_th, Temp,
                     dt, maxiter, enabled, P):
            """f32 sweep of the fixed-point iteration while the strain-change
            error is above ``fp32_switch``.  Same update sequence as the f64
            body; the materials layer computes natively in f32 (see
            materials/base._p).  Exits leaving at least one iteration of
            budget for the mandatory f64 finish."""
            f32 = jnp.float32

            def dn(tree):
                return jax.tree_util.tree_map(
                    lambda a: a.astype(f32)
                    if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)

            def up(tree):
                return jax.tree_util.tree_map(
                    lambda a: a.astype(jnp.float64)
                    if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)

            b32, mask32, ubc32 = b_ext.astype(f32), mask.astype(f32), \
                u_bc.astype(f32)
            eps_th32, Temp32 = eps_th.astype(f32), Temp.astype(f32)
            # dt arrives as a traced f64 scalar; multiplying it into the f32
            # body would silently promote everything back to f64
            dt = jnp.asarray(dt).astype(f32)

            def solve32(CT, b, x0, rtol):
                """Defect-correction solve on the f32-rounded operator.

                A raw f32 BiCGStab can diverge on the Desai-coupled
                (non-normal) tangent; restarting each pass from an f64
                residual - the exact structure of the production ir_solve -
                is the standard cure and costs one f64 matvec per pass.
                The operator itself stays the f32 tangent; only the
                residual arithmetic runs f64.  In halo mode the same
                structure runs on owner-sharded padded vectors with
                O(interface) exchange per matvec.
                """
                if halo is not None:
                    return _halo_solve32(CT, b, x0, rtol)
                CT64 = CT.astype(jnp.float64)
                mask64 = mask32.astype(jnp.float64)
                ubc64 = ubc32.astype(jnp.float64)

                bell = (getattr(kern, "dia", None)
                        or getattr(kern, "blockell", None))
                if bell is not None and getattr(bell, "structured", False):
                    # structured block-DIA: f32-only assembly; exact-f64
                    # action stays matrix-free (see _make_masked_solver)
                    blocks32 = bell.assemble(CT)

                    def mv64(x):
                        return kern.matvec(CT64, x)

                    def Aop_lo(x):
                        return (mask32 * bell.matvec(blocks32, mask32 * x)
                                + (1.0 - mask32) * x)
                elif bell is not None:
                    blocks64 = bell.assemble(CT64)
                    blocks32 = blocks64.astype(jnp.float32)

                    def mv64(x):
                        return bell.matvec(blocks64, x)

                    def Aop_lo(x):
                        return (mask32 * bell.matvec(blocks32, mask32 * x)
                                + (1.0 - mask32) * x)
                else:
                    def mv64(x):
                        return kern.matvec(CT64, x)

                    def Aop_lo(x):
                        return (mask32 * kern.matvec(CT, mask32 * x)
                                + (1.0 - mask32) * x)

                def Aop_hi(x):
                    return (mask64 * mv64(mask64 * x)
                            + (1.0 - mask64) * x)

                def M_inv(r):
                    return apply_M(P, r, mask32)

                b64 = b.astype(jnp.float64)
                if zero_dir:
                    b_eff = mask64 * b64
                else:
                    b_eff = (mask64 * (b64 - mv64(ubc64))
                             + (1.0 - mask64) * ubc64)
                x, k, res = ir_solve(Aop_hi, Aop_lo, b_eff,
                                     x0.astype(jnp.float64), M_inv,
                                     inner_solve=solve_raw, rtol=rtol,
                                     inner_rtol=inner_rtol,
                                     inner_maxiter=max_it, max_passes=4)
                return x.astype(f32), k, res.astype(f32)

            def _halo_solve32(CT, b, x0, rtol):
                # CT is the f32 tangent in global element order (the
                # sharded kernel's prep is the identity)
                CT_l64 = halo.ct_to_local_traced(CT.astype(jnp.float64))
                CT_l32 = halo.ct_to_local_traced(CT)
                mp = halo.to_padded(mask32.astype(jnp.float64))
                mp32 = mp.astype(f32)
                up64 = halo.to_padded(ubc32.astype(jnp.float64))
                bp = halo.to_padded(b.astype(jnp.float64))
                x0p = halo.to_padded(x0.astype(jnp.float64))

                def Aop_hi(x):
                    return (mp * halo.matvec_pad(CT_l64, mp * x, mp)
                            + (1.0 - mp) * x)

                def Aop_lo(x):
                    return (mp32 * halo.matvec_pad(CT_l32, mp32 * x, mp32)
                            + (1.0 - mp32) * x)

                def M_inv(r):
                    return apply_M(P, r, mp32)

                if zero_dir:
                    b_eff = mp * bp
                else:
                    b_eff = (mp * (bp - halo.matvec_pad(CT_l64, up64, mp))
                             + (1.0 - mp) * up64)
                x, k, res = ir_solve(Aop_hi, Aop_lo, b_eff, x0p, M_inv,
                                     inner_solve=solve_raw, rtol=rtol,
                                     inner_rtol=inner_rtol,
                                     inner_maxiter=max_it, max_passes=4)
                return (halo.from_padded(x).astype(f32), k,
                        res.astype(f32))

            def body(carry):
                states, sv, eps_v, u, ite, err_prev, stats, _ = carry
                sv_k = sv
                new_states, G, B6 = mat.f_tangent_all(states, sv_k, Temp32,
                                                      dt, theta)
                CT = kern.prep(mat.f_CT(G, dt, theta))
                eps_ne_k = jnp.zeros_like(eps_th32)
                states2 = []
                for e, st in zip(elems_ne, new_states):
                    st = e.f_eps_k(st, dt * theta, dt * (1 - theta))
                    eps_ne_k = eps_ne_k + st["eps_k"]
                    states2.append(st)
                G_sk = kern.apply66(kern.prep(G), sv_k)
                eps_rhs = (eps_ne_k + eps_th32
                           - dt * (1 - theta) * (B6 + G_sk))
                # solve only as tight as this iteration needs (the f64
                # defect-correction structure of solve32 makes sub-f32-floor
                # targets reachable, but they would be wasted work here)
                lin_rtol = jnp.clip(0.05 * err_prev, 1e-6, 1e-2)
                b = b32 + kern.internal_force(kern.apply66(CT, eps_rhs))
                x0 = mask32 * u + (1.0 - mask32) * ubc32
                u_new, kry, lin_res = solve32(CT, b, x0, lin_rtol)
                # f32 BiCGStab can break down or diverge: accept the iterate
                # only if it is finite AND actually reduced the residual,
                # else keep x0 (the error then stagnates and the sweep hands
                # off to the f64 phase)
                b_norm = jnp.sqrt(jnp.vdot(b.reshape(-1), b.reshape(-1)))
                u_ok = (jnp.isfinite(jnp.vdot(u_new.reshape(-1),
                                              u_new.reshape(-1)))
                        & jnp.isfinite(lin_res) & (lin_res < 0.5 * b_norm))
                u_new = jnp.where(u_ok, u_new, x0)
                eps_new = kern.strain(u_new)
                sv_new = kern.apply66(CT, eps_new - eps_rhs)
                states3 = []
                for e, st in zip(elems_ne, states2):
                    st = e.f_increment_isv(st, sv_new, sv_k, dt)
                    st = e.f_rate(st, sv_new, dt * theta, Temp32)
                    states3.append(st)
                diff = jnp.sqrt((((eps_new - eps_v) ** 2)
                                 * VOIGT_WEIGHT).sum())
                ref = jnp.sqrt(((eps_new ** 2) * VOIGT_WEIGHT).sum())
                err = (diff / ref).astype(jnp.float64)
                # non-finite stress => exit the f32 sweep (the caller then
                # rolls the whole sweep back and the f64 phase starts clean)
                err = jnp.where(jnp.isfinite(sv_new).all(), err, jnp.inf)
                # stagnation exit: f32 arithmetic bottoms out around the
                # matvec noise floor; once an iteration stops at least
                # halving the error, hand off to the f64 phase instead of
                # spinning here
                prog = err < 0.5 * err_prev
                kry_tot, _, _ = stats
                stats = (kry_tot + kry, kry,
                         jnp.asarray(0.0, dtype=jnp.float64))
                return (states3, sv_new, eps_new, u_new, ite + 1, err, stats,
                        prog)

            def cond(carry):
                *_, ite, err, stats, prog = carry
                # short budget: a healthy sweep needs 1-3 iterations, and
                # the mandatory f64 finish must keep most of maxiter
                return ((err > fp32_switch)
                        & (ite < jnp.minimum(maxiter - 2, 6))
                        & jnp.isfinite(err) & prog & enabled)

            init = (dn(states), sv.astype(f32), eps_v.astype(f32),
                    u.astype(f32),
                    jnp.asarray(0, dtype=jnp.int64),
                    jnp.asarray(1.0, dtype=jnp.float64),
                    (jnp.asarray(0, dtype=jnp.int64),
                     jnp.asarray(0, dtype=jnp.int64),
                     jnp.asarray(0.0, dtype=jnp.float64)),
                    jnp.asarray(True))
            (states_o, sv_o, eps_o, u_o, ite, err, stats, _) = \
                jax.lax.while_loop(cond, body, init)
            return (up(states_o), sv_o.astype(jnp.float64),
                    eps_o.astype(jnp.float64), u_o.astype(jnp.float64),
                    ite, err, stats)

        # state keys that are FROZEN during the fixed-point loop (committed
        # history; only the end-of-step commit writes them).  After the f32
        # sweep they are restored from the original f64 inputs so the f64
        # finish solves the exact same problem as a pure-f64 run - the f32
        # phase only provides a better starting iterate.
        _FROZEN = ("eps_old", "rate_old", "qsi_old", "zeta_old")

        def fp(states, sv, eps_v, u, b_ext, mask, u_bc, eps_th, Temp, dt,
               tol, maxiter, enabled, P, fp32_on=True):
            # step-entry snapshot: the loose-mode safety net in the f64 body
            # rolls the loop back here (the proven pure-tight starting point)
            # when an adaptive iteration misbehaves, and the stress scale
            # anchors its blow-up detector.
            entry = (states, sv, eps_v, u)
            sv_scale = jnp.abs(sv).max()
            if use_fp32:
                orig = (states, sv, eps_v, u)
                (states, sv, eps_v, u, ite0, err0, stats0) = _phase32(
                    states, sv, eps_v, u, b_ext, mask, u_bc, eps_th, Temp,
                    dt, maxiter, enabled & jnp.asarray(fp32_on), P)
                states = [
                    {k: (o[k] if k in _FROZEN else st[k]) for k in st}
                    for o, st in zip(orig[0], states)]
                # health gate: the f32 sweep is a best-effort accelerator.
                # If ANY of its outputs went non-finite OR physically absurd
                # (an f32 Krylov breakdown can leave finite-but-enormous
                # iterates whose f64 continuation overflows through
                # exp(beta_1*I1s) etc.), discard the sweep entirely and let
                # the f64 phase run from the original state - the result is
                # then exactly the pure-f64 path.
                leaves = jax.tree_util.tree_leaves((states, sv, eps_v, u))
                # accept ONLY a sweep that genuinely contracted to the
                # switch threshold: one that exited via stagnation or the
                # iteration cap may sit anywhere in state space, and a
                # gate-passing but basin-escaping iterate can derail the f64
                # finish (observed: a step its own entry state solves in 3
                # f64 iterations failed after such a sweep)
                ok0 = jnp.isfinite(err0) & (err0 <= fp32_switch)
                # physically-absurd bounds (1 GPa stress, 50 % strain): a
                # partially-garbage sweep iterate can hide in the global
                # error norm yet still blow up the f64 continuation through
                # the constitutive exponentials within a couple iterations
                ok0 = ok0 & (jnp.abs(sv).max() < 1e9)
                ok0 = ok0 & (jnp.abs(eps_v).max() < 0.5)
                # hardening ISVs must not run away from their committed
                # values: per-step creep increments are tiny, so a >30%
                # excursion means the sweep overshot the implicit solution
                for o, st in zip(orig[0], states):
                    for kk in ("alpha", "zeta"):
                        if kk in st:
                            ok0 = ok0 & (jnp.abs(st[kk] - o[kk])
                                         <= 0.3 * jnp.abs(o[kk])
                                         + 1e-6).all()
                for a in leaves:
                    if jnp.issubdtype(a.dtype, jnp.floating):
                        ok0 = ok0 & jnp.isfinite(a).all()
                (states, sv, eps_v, u) = jax.tree_util.tree_map(
                    lambda new, old: jnp.where(ok0, new, old),
                    (states, sv, eps_v, u), orig)
                ite0 = jnp.where(ok0, ite0, 0)
                err0 = jnp.where(ok0, err0, 1.0)
            else:
                ite0 = jnp.asarray(0, dtype=jnp.int64)
                err0 = jnp.asarray(1.0, dtype=jnp.float64)
                stats0 = (jnp.asarray(0, dtype=jnp.int64),
                          jnp.asarray(0, dtype=jnp.int64),
                          jnp.asarray(0.0, dtype=jnp.float64))

            def body(carry):
                (states, sv, eps_v, u, _, ite, err_prev, stats, was_tight,
                 tan) = carry
                have, G_p, CT_p, B6_c, sv_lin, contracted = tan
                sv_k = sv
                # Adaptive inner tolerance (Eisenstat-Walker flavor): while
                # the fixed-point error is large, the linearized system only
                # needs to be solved ~2 decades tighter than it; once the
                # outer error reaches tol the solve drops to the full rtol
                # (with hysteresis: stay tight once tight), and convergence
                # is only declared after an iteration whose solve was tight,
                # so the converged fields carry rtol-level solver noise like
                # the reference's always-1e-12 PETSc trajectory.
                if trivial_error or not adaptive:
                    tight = jnp.asarray(True)
                    lin_rtol = jnp.asarray(rtol_floor, dtype=jnp.float64)
                else:
                    tight = was_tight | (err_prev <= 10.0 * tol)
                    lin_rtol = jnp.where(
                        tight, rtol_floor,
                        jnp.clip(0.05 * err_prev, rtol_floor, 1e-4))

                # consistent tangents + CT (reference MomentumEquation.py
                # :799-820), LAGGED between rebuilds (modified-Newton).  The
                # reference rebuilds the full tangent suite every fixed-point
                # iteration; here a rebuild happens only (a) on the first
                # f64 iteration, (b) when the error failed to contract under
                # the lagged tangent, and (c) on every TIGHT iteration - and
                # convergence can only be declared on a tight iteration, so
                # the committed fields always come from a fresh consistent
                # linearization (identical final-iteration semantics; the
                # tangent only shapes the iteration path, not the fixed
                # point, because the G:(sigma-sigma_k) corrector terms
                # vanish at convergence).  Disabled (always fresh) when
                # adaptive_rtol is off - the golden/default path is
                # bit-identical to the always-fresh program.
                def fresh(_):
                    new_states, G, B6n = mat.f_tangent_all(states, sv_k,
                                                           Temp, dt, theta)
                    return (new_states, kern.prep(G),
                            kern.prep(mat.f_CT(G, dt, theta)), B6n, sv_k)

                if trivial_error or not (adaptive or lag):
                    rebuild = jnp.asarray(True)
                    new_states, G_p, CT, B6, sv_lin = fresh(None)
                else:
                    if adaptive:
                        rebuild = (~have) | tight | (~contracted)
                    else:
                        # lag mode: rebuild on the first f64 iteration, on
                        # contraction failure, and when the previous error
                        # entered the convergence neighborhood (so the
                        # declaring iteration always runs a fresh tangent)
                        rebuild = ((~have) | (~contracted)
                                   | (err_prev <= 10.0 * tol))

                    def stale(_):
                        return (states, G_p, CT_p, B6_c, sv_lin)

                    new_states, G_p, CT, B6, sv_lin = jax.lax.cond(
                        rebuild, fresh, stale, None)
                # eps_rhs (reference :868-890) - linearized about sv_lin,
                # the stress at which the (possibly lagged) tangent was built
                eps_ne_k = jnp.zeros_like(eps_th)
                states2 = []
                for e, st in zip(elems_ne, new_states):
                    st = e.f_eps_k(st, dt * theta, dt * (1 - theta))
                    eps_ne_k = eps_ne_k + st["eps_k"]
                    states2.append(st)
                G_sk = kern.apply66(G_p, sv_lin)
                eps_rhs = eps_ne_k + eps_th - dt * (1 - theta) * (B6 + G_sk)
                # assemble + masked Krylov solve (reference :1008-1025)
                b = b_ext + kern.internal_force(kern.apply66(CT, eps_rhs))
                x0 = mask * u + (1.0 - mask) * u_bc
                u_new, kry, lin_res, lin_bnorm = solve_lin(
                    CT, b, mask, u_bc, x0, lin_rtol, P)
                # solve-acceptance gates: BiCGStab can DIVERGE outright on a
                # near-singular tangent (e.g. Perzyna-softened elements with
                # collapsed hardening make CT locally ~0 and the elastic
                # preconditioner useless), and it can also STALL: exit its
                # budget with the iterate ~= x0 (observed at Desai yield
                # onset: 800 iterations, relative residual 2e-3 against a
                # requested 1e-4).  A stalled solve leaves the strain
                # unchanged, so the strain-change error reads ~0 - a failed
                # solve masquerading as a converged fixed point - and the
                # poisoned commit NaNs the next step.  Divergence and a
                # TIGHT-mode stall fail the step cleanly (err=inf ->
                # dt-retry); a LOOSE-mode stall is handled by the rollback
                # net below.  Gates scale by the norm of the RHS actually
                # solved (force RHS + Dirichlet lifting), so
                # displacement-driven steps with ~zero force RHS do not
                # collapse the threshold to 1e-30.  Tight solves get 4
                # decades of slack above rtol_floor (1e-9-level residuals
                # are physically converged; only a genuinely stuck solve
                # fails); loose solves, being easy 1e-4-level targets, get
                # one decade.
                rel_res = lin_res / (lin_bnorm + 1e-300)
                stalled = ~(rel_res
                            <= jnp.where(tight, 1e4, 10.0) * lin_rtol)
                solve_ok = (jnp.isfinite(lin_res)
                            & (lin_res <= 10.0 * lin_bnorm + 1e-30)
                            & ~(tight & stalled)
                            & jnp.isfinite(jnp.vdot(u_new.reshape(-1),
                                                    u_new.reshape(-1))))
                # strain, stress (reference :844-866)
                eps_new = kern.strain(u_new)
                sv_new = kern.apply66(CT, eps_new - eps_rhs)
                # ISV increments + rates (reference Simulators.py:421-425).
                # The ISV linearization (r, h, P) lives at sv_lin, so the
                # increment's P:(sigma - sigma_k) term expands about sv_lin
                # (== sv_k on fresh iterations, i.e. reference semantics).
                states3 = []
                for e, st in zip(elems_ne, states2):
                    st = e.f_increment_isv(st, sv_new, sv_lin, dt)
                    st = e.f_rate(st, sv_new, dt * theta, Temp)
                    states3.append(st)
                if trivial_error:
                    err = jnp.asarray(0.0, dtype=jnp.float64)
                else:
                    diff = jnp.sqrt((((eps_new - eps_v) ** 2) * w_err).sum())
                    ref = jnp.sqrt(((eps_new ** 2) * w_err).sum())
                    err = diff / ref
                # fold stress health into the error: a non-finite stress with
                # a frozen displacement (e.g. a NaN RHS makes the Krylov
                # solve a 0-iteration no-op) would otherwise read as
                # "converged" on the strain-change criterion.  err=inf exits
                # the loop as a failed step -> dt-retry.  Same for a
                # diverged linear solve (see solve_ok above).
                err = jnp.where(jnp.isfinite(sv_new).all() & solve_ok,
                                err, jnp.inf)
                # loose-mode safety net: near yield onset the fixed-point
                # map amplifies rtol-level solve error explosively - one
                # loose iterate can blow the stress 10x (observed: |sv|max
                # 1.3e7 -> 1.4e8 in a single 1e-4-rtol iteration WHILE the
                # strain-change norm still contracted, so the error
                # criterion cannot catch it).  Any loose iteration that
                # stalls its solve, blows the stress past 3x the entry
                # scale, or goes non-finite ROLLS the loop BACK to the
                # step-entry state and continues tight-only - exactly the
                # proven pure-f64 path, at the cost of the wasted loose
                # iterations.  Tight iterations are never rolled back
                # (reference semantics: they fail hard via err=inf above).
                sv_blow = jnp.abs(sv_new).max() > 3.0 * sv_scale + 1e7
                bad = (~tight) & (stalled | sv_blow | ~jnp.isfinite(err))

                def roll(new, old):
                    return jnp.where(bad, old, new)

                states3 = jax.tree_util.tree_map(roll, states3, entry[0])
                sv_new = roll(sv_new, entry[1])
                eps_new = roll(eps_new, entry[2])
                u_new = roll(u_new, entry[3])
                sv_k = roll(sv_k, entry[1])
                err = jnp.where(bad, jnp.asarray(1.0, dtype=jnp.float64),
                                err)
                kry_tot, _, _ = stats
                stats = (kry_tot + kry, kry, lin_res)
                tan = ((have | rebuild) & ~bad, G_p, CT, B6, sv_lin,
                       jnp.where(bad, True, err < 0.7 * err_prev))
                # convergence may only be declared after an iteration that
                # was BOTH tight and fresh-tangent (identical final-iteration
                # semantics to the reference's always-fresh loop); in the
                # always-fresh path this reduces to `tight` as before
                return (states3, sv_new, eps_new, u_new, sv_k, ite + 1, err,
                        stats, (tight & rebuild) | bad, tan)

            def cond(carry):
                *_, ite, err, stats, was_tight, tan = carry
                return (((((err > tol) | (~was_tight)) & (ite < maxiter)
                          & jnp.isfinite(err))
                         | (ite == 0)) & enabled)

            tan0 = (jnp.asarray(False),
                    kern.prep(jnp.zeros((kern.n_elems, 6, 6))),
                    kern.prep(jnp.zeros((kern.n_elems, 6, 6))),
                    jnp.zeros((kern.n_elems, 6)), sv,
                    jnp.asarray(True))
            init = (states, sv, eps_v, u, sv, ite0, err0, stats0,
                    jnp.asarray(False), tan0)
            out = jax.lax.while_loop(cond, body, init)
            return out[:8]

        return fp

    def _build_jit_step(self):
        """One full fixed-point time-step solve as a single XLA program."""
        bc = self.bc
        kern = self.kernel
        elems_th = list(self.mat.elems_th)
        fp = self._make_fp()

        @jax.jit
        def _step(states, sv, eps_v, u, b_body, Temp, T0, t, dt, tol,
                  maxiter, P, fp32_on=True):
            mask, u_bc = bc.dirichlet_arrays(t)
            b_ext = b_body + bc.neumann_rhs(t)
            eps_th = jnp.zeros((kern.n_elems, 6), dtype=jnp.float64)
            for th in elems_th:
                eps_th = eps_th + th.eps_th_voigt(Temp - T0)

            (states_f, sv_f, eps_f, u_f, sv_k_f, ite, err, stats) = fp(
                states, sv, eps_v, u, b_ext, mask, u_bc, eps_th, Temp, dt,
                tol, maxiter, jnp.asarray(True), P,
                fp32_on=jnp.asarray(fp32_on))
            kry_tot, kry_last, lin_res = stats
            # one packed stats vector => ONE device->host transfer per step
            # (each individual int()/float() would be its own round trip)
            statsvec = jnp.stack([ite.astype(jnp.float64), err,
                                  kry_tot.astype(jnp.float64),
                                  kry_last.astype(jnp.float64), lin_res])
            return states_f, sv_f, eps_f, u_f, sv_k_f, statsvec

        return _step

    def _build_jit_msteps(self):
        """Fused multi-step driver: K time steps in ONE device dispatch.

        A production run that only needs host attention at output/checkpoint
        boundaries advances many steps per program, paying one dispatch and
        one host sync per chunk instead of per step.  Semantics per step
        are identical to ``solve_time_step`` + ``commit_time_step`` with the
        reference's commit-only-if-converged guard (Simulators.py:505-517):

        * each step runs the full fixed-point iteration, then commits its
          ISVs device-side IFF it converged;
        * on the first non-converged step the chunk goes inert: the carry
          keeps that step's ENTRY state (exactly the dt-retry restore point,
          reference Simulators.py:441-503) and all later steps are skipped
          (their while-loops run zero iterations);
        * per-step stats [iters, err, krylov_total, krylov_last, lin_res,
          converged] are stacked and fetched with one transfer.
        """
        bc = self.bc
        kern = self.kernel
        theta = self.theta
        elems_ne = list(self.mat.elems_ne)
        elems_th = list(self.mat.elems_th)
        fp = self._make_fp()

        def commit(states, sv, sv_k, dt):
            out = []
            for e, st in zip(elems_ne, states):
                st = e.f_commit_isv(st)
                st = e.f_rate_to_old(st)
                st = e.f_update_eps_old(st, sv, sv_k, dt * (1 - theta))
                out.append(st)
            return out

        @jax.jit
        def _msteps(states, sv, eps_v, u, u_prev, b_body, Temp, T0, ts, dts,
                    n_real, tol, maxiter, P):
            eps_th = jnp.zeros((kern.n_elems, 6), dtype=jnp.float64)
            for th in elems_th:
                eps_th = eps_th + th.eps_th_voigt(Temp - T0)

            def one_step(carry, t_dt_i):
                states, sv, eps_v, u, u_prev, failed = carry
                t, dt, i = t_dt_i
                # steps beyond n_real are padding (chunks are padded to one
                # canonical length so every chunk size shares ONE compiled
                # program - the scan length is baked into the executable)
                active = (~failed) & (i < n_real)
                mask, u_bc = bc.dirichlet_arrays(t)
                b_ext = b_body + bc.neumann_rhs(t)
                # Krylov initial guess: linear time extrapolation from the
                # previous committed step (matches solve_time_step's host
                # logic; only the solver x0, never accuracy)
                x0 = u + (u - u_prev)
                (st_n, sv_n, eps_n, u_n, sv_k, ite, err, stats) = fp(
                    states, sv, eps_v, x0, b_ext, mask, u_bc, eps_th, Temp,
                    dt, tol, maxiter, active, P)
                conv = active & jnp.isfinite(err) & (err <= tol)

                def on_conv(_):
                    return (commit(st_n, sv_n, sv_k, dt), sv_n, eps_n, u_n,
                            u, failed)

                def on_fail(_):
                    # keep the step's ENTRY state: the dt-retry restore point
                    return (states, sv, eps_v, u, u_prev, jnp.asarray(True))

                new_carry = jax.lax.cond(conv, on_conv, on_fail, None)
                kry_tot, kry_last, lin_res = stats
                row = jnp.stack([ite.astype(jnp.float64), err,
                                 kry_tot.astype(jnp.float64),
                                 kry_last.astype(jnp.float64), lin_res,
                                 conv.astype(jnp.float64)])
                return new_carry, row

            init = (states, sv, eps_v, u, u_prev, jnp.asarray(False))
            idx = jnp.arange(ts.shape[0], dtype=jnp.int64)
            carry, rows = jax.lax.scan(one_step, init, (ts, dts, idx))
            states_f, sv_f, eps_f, u_f, u_prev_f, failed = carry
            return states_f, sv_f, eps_f, u_f, u_prev_f, rows

        return _msteps

    def _build_jit_tm_msteps(self, heat):
        """Fused coupled thermo-mechanical multi-step driver.

        One scanned program per chunk: implicit heat step -> nodal-to-DG0
        temperature coupling -> momentum fixed-point iteration -> ISV commit
        (reference Simulator_TM order, Simulators.py:177-265; the reference
        TM loop commits unconditionally - no dt-retry - and so does this).
        Index masking pads chunks to one canonical length (see
        _build_jit_msteps).
        """
        bc = self.bc
        kern = self.kernel
        hkern = heat.kernel
        theta = self.theta
        elems_ne = list(self.mat.elems_ne)
        elems_th = list(self.mat.elems_th)
        fp = self._make_fp()
        hstep = heat._make_step_core()

        def commit(states, sv, sv_k, dt):
            out = []
            for e, st in zip(elems_ne, states):
                st = e.f_commit_isv(st)
                st = e.f_rate_to_old(st)
                st = e.f_update_eps_old(st, sv, sv_k, dt * (1 - theta))
                out.append(st)
            return out

        @jax.jit
        def _tm(states, sv, eps_v, u, u_prev, b_body, T, T_old, hk, hrho,
                hcp, T0, ts, dts, n_real, tol, maxiter, P):
            def one(carry, tdi):
                states, sv, eps_v, u, u_prev, T, T_old, failed = carry
                t, dt, i = tdi
                # commit-only-if-converged, like the mechanics multi-step
                # driver: on the first non-converged step the chunk goes
                # inert and the carry keeps that step's ENTRY state
                # (including the heat field) as the dt-retry restore point
                active = (~failed) & (i < n_real)

                def run_heat(_):
                    x, it, res = hstep(T, T_old, hk, hrho, hcp, t, dt)
                    return x, it.astype(jnp.float64), res

                def skip_heat(_):
                    return T, jnp.asarray(0.0), jnp.asarray(0.0)

                T_new, h_it, h_res = jax.lax.cond(active, run_heat,
                                                  skip_heat, None)
                Temp = hkern.nodes_to_elems(T_new)
                eps_th = jnp.zeros((kern.n_elems, 6), dtype=jnp.float64)
                for th in elems_th:
                    eps_th = eps_th + th.eps_th_voigt(Temp - T0)
                mask, u_bc = bc.dirichlet_arrays(t)
                b_ext = b_body + bc.neumann_rhs(t)
                x0 = u + (u - u_prev)
                (st_n, sv_n, eps_n, u_n, sv_k, ite, err, stats) = fp(
                    states, sv, eps_v, x0, b_ext, mask, u_bc, eps_th, Temp,
                    dt, tol, maxiter, active, P)
                conv = active & jnp.isfinite(err) & (err <= tol)

                def on_conv(_):
                    return (commit(st_n, sv_n, sv_k, dt), sv_n, eps_n, u_n,
                            u, T_new, T_new, failed)

                def on_fail(_):
                    return (states, sv, eps_v, u, u_prev, T, T_old,
                            failed | active)

                new_carry = jax.lax.cond(conv, on_conv, on_fail, None)
                kry_tot, _, _ = stats
                row = jnp.stack([h_it, h_res, ite.astype(jnp.float64), err,
                                 kry_tot.astype(jnp.float64),
                                 conv.astype(jnp.float64)])
                return new_carry, row

            idx = jnp.arange(ts.shape[0], dtype=jnp.int64)
            init = (states, sv, eps_v, u, u_prev, T, T_old,
                    jnp.asarray(False))
            carry, rows = jax.lax.scan(one, init, (ts, dts, idx))
            return carry[:7], rows

        return _tm

    def solve_tm_time_steps(self, heat, ts, dts, tol=1e-6, maxiter=20):
        """Advance up to len(ts) coupled TM steps (heat + momentum + commit)
        in ONE device dispatch.  Mutates this equation AND ``heat``.

        Commit-only-if-converged: on the first step whose fixed point does
        not reach ``tol`` the equation AND heat field are left at that
        step's ENTRY state (the dt-retry restore point) and the remaining
        steps are skipped.  Returns a (K, 6) array of per-step rows
        ``[heat_iters, heat_res, fp_iters, error, krylov_total, converged]``
        (after the first converged=0 row the remaining steps did not run).
        """
        key = (id(self.mat), id(self.bc), self.solver.method,
               self.solver.rtol, self.solver.max_it, self.solver.precision,
               self.solver.precond, self.solver.coarse_agg,
               self.solver.adaptive_rtol,
               self.solver.fp32_enabled(), self.solver.fp32_switch, len(self.mat.elems_ne),
               len(self.mat.elems_th), id(heat), id(heat.bc),
               heat.solver.rtol, heat.solver.max_it, heat.solver.precision)
        if getattr(self, "_jit_tm_msteps", None) is None or \
                self._jit_tm_key != key:
            self._jit_tm_msteps = self._build_jit_tm_msteps(heat)
            self._jit_tm_key = key
        states = [e.state for e in self.mat.elems_ne]
        u_prev = getattr(self, "_u_last_step", None)
        if u_prev is None:
            u_prev = self.u
        P, _ = self._get_precond()
        n_real = len(ts)
        k_pad = max(64, -(-n_real // 64) * 64)
        ts = np.concatenate([np.asarray(ts, dtype=np.float64),
                             np.full(k_pad - n_real, ts[-1])])
        dts = np.concatenate([np.asarray(dts, dtype=np.float64),
                              np.full(k_pad - n_real, dts[-1])])
        carry, rows = self._jit_tm_msteps(
            states, self.sig_v, self.eps_tot_v, self.u, u_prev, self.b_body,
            heat.T, heat.T_old, heat.k, heat.rho, heat.cp, self.T0,
            jnp.asarray(ts), jnp.asarray(dts), n_real, tol, maxiter, P)
        states, sv, eps_v, u, u_prev_f, T, T_old = carry
        for e, st in zip(self.mat.elems_ne, states):
            e.state = st
        self.sig_v = sv
        self.eps_tot_v = eps_v
        self.u = u
        self._u_last_step = u_prev_f
        self._last_sv_k = sv
        heat.T = T
        heat.T_old = T_old
        self.Temp = heat.get_T_elems()
        stats = np.asarray(rows)[:n_real]   # one transfer for the chunk
        done = stats[:, 5] > 0.5
        if done.any():
            last = int(np.nonzero(done)[0][-1])
            heat.solver_stats = (int(stats[last, 0]), float(stats[last, 1]))
            self.krylov_total = int(stats[last, 4])
        else:
            heat.solver_stats = (0, float("nan"))
            self.krylov_total = 0
        self.run_after_solve()
        return stats

    def commit_time_step(self, dt, stress=None, stress_k=None):
        """Fused commit phase of a converged step: ISV commit + rate_old
        rollover + inelastic-strain corrector as ONE jitted program.

        Equivalent to the reference sequence ``update_internal_variables();
        update_eps_ne_rate_old(); update_eps_ne_old(sigma, sigma_k, dt)``
        (reference Simulators.py:509-517) but with a single device dispatch
        instead of ~3 per element.
        """
        sv = _as_voigt(self.sig_v if stress is None else stress)
        sv_k = _as_voigt(getattr(self, "_last_sv_k", sv)
                         if stress_k is None else stress_k)
        commit_key = (id(self.mat), len(self.mat.elems_ne), self.theta)
        if getattr(self, "_jit_commit", None) is None or \
                self._jit_commit_key != commit_key:
            elems_ne = list(self.mat.elems_ne)
            theta = self.theta

            @jax.jit
            def _commit(states, sv, sv_k, dt):
                out = []
                for e, st in zip(elems_ne, states):
                    st = e.f_commit_isv(st)
                    st = e.f_rate_to_old(st)
                    st = e.f_update_eps_old(st, sv, sv_k,
                                            dt * (1 - theta))
                    out.append(st)
                return out

            self._jit_commit = _commit
            self._jit_commit_key = commit_key
        states = [e.state for e in self.mat.elems_ne]
        states = self._jit_commit(states, sv, sv_k, jnp.asarray(dt))
        for e, st in zip(self.mat.elems_ne, states):
            e.state = st

    def solve_time_step(self, t, dt, tol=1e-8, maxiter=40):
        """Run the full fixed-point iteration for one time step (fused).

        Returns (iterations, error).  Mutates u / stress / strain / element
        states; the last iteration's sigma_k is kept for the commit phase
        (reference Simulators.py:517).  Per-step Krylov work is surfaced in
        ``solver_stats`` (last solve's iterations, residual) and
        ``krylov_total`` (summed over the fixed-point iterations).
        """
        key = (id(self.mat), id(self.bc), self.solver.method,
               self.solver.rtol, self.solver.max_it, self.solver.precision,
               self.solver.precond, self.solver.coarse_agg,
               self.solver.adaptive_rtol,
               self.solver.fp32_enabled(), self.solver.fp32_switch,
               len(self.mat.elems_ne), len(self.mat.elems_th))
        if self._jit_step is None or self._jit_step_key != key:
            self._jit_step = self._build_jit_step()
            self._jit_step_key = key
        states = [e.state for e in self.mat.elems_ne]
        # Krylov initial guess: linear time extrapolation from the previous
        # committed step (u is ONLY the solver x0 - the fixed-point error
        # baseline is eps_tot_v - so a bad guess costs iterations, never
        # accuracy).  On a dt-retry self.u is restored to the committed
        # state, making the extrapolation a no-op.
        u_prev = getattr(self, "_u_last_step", None)
        u0 = self.u if u_prev is None else self.u + (self.u - u_prev)
        self._u_last_step = self.u
        P, _ = self._get_precond()
        # a dt-retry (Simulator sets _fp32_disable) reruns the step as the
        # pure-f64 path - traced flag, so no recompile
        fp32_on = not getattr(self, "_fp32_disable", False)
        (states, sv, eps_v, u, sv_k, statsvec) = self._jit_step(
            states, self.sig_v, self.eps_tot_v, u0, self.b_body,
            self.Temp, self.T0, t, dt, tol, maxiter, P, fp32_on)
        for e, st in zip(self.mat.elems_ne, states):
            e.state = st
        self.sig_v = sv
        self.eps_tot_v = eps_v
        self.u = u
        self._last_sv_k = sv_k
        stats = np.asarray(statsvec)   # ONE host transfer for all 5 scalars
        self.krylov_total = int(stats[2])
        self.solver_stats = (int(stats[3]), float(stats[4]))
        self.run_after_solve()
        return int(stats[0]), float(stats[1])

    def solve_time_steps(self, ts, dts, tol=1e-8, maxiter=40):
        """Advance up to ``len(ts)`` fused time steps in ONE device dispatch.

        Each step runs the full fixed-point iteration and commits its ISVs
        device-side iff it converged (reference commit-only-if-converged,
        Simulators.py:505-517); on the first non-converged step the equation
        state is left at that step's ENTRY (the dt-retry restore point) and
        the remaining steps are skipped.  Use for spans where the host needs
        no per-step attention (between output/checkpoint boundaries) - one
        dispatch + one stats transfer replaces K of each.

        Returns a ``(K, 6)`` float array with per-step rows
        ``[iterations, error, krylov_total, krylov_last, lin_res, converged]``
        (``converged`` is 0/1; after the first 0 all later rows are 0 and
        those steps did not execute).
        """
        key = (id(self.mat), id(self.bc), self.solver.method,
               self.solver.rtol, self.solver.max_it, self.solver.precision,
               self.solver.precond, self.solver.coarse_agg,
               self.solver.adaptive_rtol,
               self.solver.fp32_enabled(), self.solver.fp32_switch,
               len(self.mat.elems_ne), len(self.mat.elems_th))
        if self._jit_msteps is None or self._jit_step_key != key:
            # keep the single-step cache in sync (shared key)
            self._jit_step = self._build_jit_step()
            self._jit_msteps = self._build_jit_msteps()
            self._jit_step_key = key
        states = [e.state for e in self.mat.elems_ne]
        u_prev = getattr(self, "_u_last_step", None)
        if u_prev is None:
            u_prev = self.u
        P, _ = self._get_precond()
        # pad to a canonical length: the scan length is part of the compiled
        # program, so without padding every distinct chunk size (truncated
        # final chunks, save-boundary alignment) would recompile the whole
        # multi-step program
        n_real = len(ts)
        k_pad = max(64, -(-n_real // 64) * 64)
        ts = np.concatenate([np.asarray(ts, dtype=np.float64),
                             np.full(k_pad - n_real, ts[-1])])
        dts = np.concatenate([np.asarray(dts, dtype=np.float64),
                              np.full(k_pad - n_real, dts[-1])])
        (states, sv, eps_v, u, u_prev_f, rows) = self._jit_msteps(
            states, self.sig_v, self.eps_tot_v, self.u, u_prev, self.b_body,
            self.Temp, self.T0, jnp.asarray(ts), jnp.asarray(dts),
            n_real, tol, maxiter, P)
        for e, st in zip(self.mat.elems_ne, states):
            e.state = st
        self.sig_v = sv
        self.eps_tot_v = eps_v
        self.u = u
        self._u_last_step = u_prev_f
        # the committed state IS the last converged state; sigma_k of the
        # last converged step is not carried out of the fused program, and
        # the commit already consumed it - keep sigma as the fallback for
        # any caller that reads _last_sv_k afterwards
        self._last_sv_k = sv
        stats = np.asarray(rows)[:n_real]   # ONE host transfer for K steps
        done = stats[:, 5] > 0.5
        if done.any():
            last = int(np.nonzero(done)[0][-1])
            self.krylov_total = int(stats[last, 2])
            self.solver_stats = (int(stats[last, 3]), float(stats[last, 4]))
        else:
            # no step converged: don't leave counters from an older solve
            # for external readers (metrics, screen rows)
            self.krylov_total = 0
            self.solver_stats = (0, float("nan"))
        self.run_after_solve()
        return stats
