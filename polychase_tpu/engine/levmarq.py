"""Batched Levenberg–Marquardt on the device.

Rebuild of the reference's generic LM machinery
(cpp/pnp/lev_marq.h:99-389, itself modeled on PoseLib's lm_impl.h).  The
design inverts the reference's per-residual TBB loop: residuals and
Jacobians are evaluated for *all* observations at once with ``vmap``-style
batched math, normal equations are reduced with einsums, and
the outer LM iteration is a ``lax.while_loop`` so the whole solve is one XLA
program — no host round-trips per iteration.

Semantics preserved from the reference:

- damping: diagonal replaced by ``clamp(diag, 1e-6, 1e32) · (1 + λ)``
  (cpp/pnp/lev_marq.h:296-314);
- Nielsen λ schedule: on acceptance with gain ratio ρ > 0,
  ``λ ← λ · max(1/3, 1 − (2ρ−1)³)``; on rejection ``λ ← min(λ·v, λmax)``,
  ``v ← 2v`` (cpp/pnp/lev_marq.h:179-214);
- termination on gradient norm, step norm, max iterations, or λ saturation
  after a failed step (cpp/pnp/lev_marq.h:146-228).

Improvement over the reference: the damped system is Jacobi-equilibrated
(symmetric scaling to unit diagonal) before the Cholesky solve, which fixes
the float32 ill-conditioning failure the reference documents in
cpp/examples/levmarq_ill_conditioned_float32_issue.cpp without needing
float64.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

_HI = jax.lax.Precision.HIGHEST

# Loss types (mirrors BundleOptions::LossType, cpp/pnp/types.h:203-207)
TRIVIAL = 0
HUBER = 1
CAUCHY = 2


class BundleOptions(NamedTuple):
    """Solver options (cpp/pnp/types.h:200-215).

    ``loss_type`` must be a static Python int (dispatch happens at trace
    time).  ``max_allowed_parallelism`` has no meaning here (XLA owns the
    parallelism) and is accepted for API compatibility only.
    """

    max_iterations: int = 100
    loss_type: int = HUBER
    loss_scale: float = 1.0
    gradient_tol: float = 1e-10
    step_tol: float = 1e-8
    initial_lambda: float = 1e-5
    min_lambda: float = 1e-10
    max_lambda: float = 1e10
    max_allowed_parallelism: int = 8
    verbose: bool = False
    # Relative function tolerance on ACCEPTED steps (Ceres-style
    # `function_tolerance`): stop once an accepted step improves the
    # cost by less than ``function_tol * cost``.  0.0 (the default)
    # disables it, reproducing the reference's termination exactly
    # (cpp/pnp/lev_marq.h:146-227 has only gradient/step/λ-saturation
    # exits).  The reference runs f32 like us, so after convergence its
    # loop also burns a λ-doubling rejection tail (~7-9 iterations that
    # can never change the parameters — each rejection only scales λ)
    # before `step_norm < step_tol` fires; on CPU those tail iterations
    # are nanoseconds, inside a device `lax.while_loop` each is a trip
    # of kernel launches.  The tracker opts in (engine/tracker.py,
    # POLYCHASE_TRACK_FTOL).
    function_tol: float = 0.0


class BundleStats(NamedTuple):
    """Solver telemetry (cpp/pnp/types.h:217-225)."""

    iterations: jax.Array
    initial_cost: jax.Array
    cost: jax.Array
    lambda_: jax.Array
    invalid_steps: jax.Array
    step_norm: jax.Array
    grad_norm: jax.Array


# ---------------------------------------------------------------------------
# Robust losses (cpp/pnp/robust_loss.h:47-104; PoseLib BSD)
# ---------------------------------------------------------------------------


def loss_value(loss_type: int, scale, r2):
    """ρ(r²) for the given loss; elementwise over r2."""
    if loss_type == TRIVIAL:
        return r2
    if loss_type == HUBER:
        thr2 = scale * scale
        r = jnp.sqrt(jnp.maximum(r2, 0))
        return jnp.where(r2 <= thr2, r2, scale * (2.0 * r - scale))
    if loss_type == CAUCHY:
        thr2 = scale * scale
        return thr2 * jnp.log1p(r2 / thr2)
    raise ValueError(f"unknown loss type {loss_type}")


def loss_weight(loss_type: int, scale, r2):
    """IRLS weight w(r²) = ρ'(r²); elementwise over r2."""
    if loss_type == TRIVIAL:
        return jnp.ones_like(r2)
    if loss_type == HUBER:
        thr2 = scale * scale
        r = jnp.sqrt(jnp.maximum(r2, 1e-30))
        return jnp.where(r2 <= thr2, 1.0, scale / r)
    if loss_type == CAUCHY:
        inv_thr2 = 1.0 / (scale * scale)
        return jnp.maximum(1.18e-38, 1.0 / (1.0 + r2 * inv_thr2))
    raise ValueError(f"unknown loss type {loss_type}")


# ---------------------------------------------------------------------------
# Damped, equilibrated Cholesky solve
# ---------------------------------------------------------------------------


def damped_cholesky_solve(JtJ, Jtr, lam):
    """Solve ``(JtJ with damped diagonal) step = -Jtr``.

    Matches the reference damping (clamped diag × (1+λ),
    cpp/pnp/lev_marq.h:296-314) but adds symmetric Jacobi equilibration so a
    float32 factorization stays stable on ill-conditioned problems.

    Returns ``(step, ok)`` where ok is a scalar bool (factorization and
    solve produced finite values).
    """
    diag = jnp.clip(jnp.diagonal(JtJ), 1e-6, 1e32)
    damped_diag = diag * (1.0 + lam)
    n = JtJ.shape[0]
    A = JtJ.at[jnp.arange(n), jnp.arange(n)].set(damped_diag)

    # Symmetric equilibration: D A D with D = diag(1/sqrt(damped_diag)).
    d = 1.0 / jnp.sqrt(damped_diag)
    As = A * d[:, None] * d[None, :]
    bs = Jtr * d

    L = jnp.linalg.cholesky(As)
    y = jax.scipy.linalg.solve_triangular(L, bs, lower=True)
    x = jax.scipy.linalg.solve_triangular(L.T, y, lower=False)
    step = -(x * d)
    ok = jnp.all(jnp.isfinite(L)) & jnp.all(jnp.isfinite(step))
    return jnp.where(ok, step, 0.0), ok


def damped_block_tridiag_solve(JtJ, Jtr, lam, *, nb: int, bs: int):
    """Banded variant of :func:`damped_cholesky_solve`.

    The BA normal matrix is block-banded: with the ±{1,2,4,8} skip
    pattern an edge couples frames at most 8 apart, so grouping 8 frames
    per super-block makes the system block-TRIDIAGONAL with ``nb``
    diagonal blocks of size ``bs``.  A dense Cholesky of the full
    (nb·bs)² matrix is ~3.8 GFLOP and a sequential panel chain per
    refine LM iteration at 250 frames;
    the block-tridiagonal factorization is a ``lax.scan`` of nb small
    Cholesky/triangular steps — ~40× less work at 250 frames.

    Inputs are the FULL dense (nb·bs,)² system (same damping +
    equilibration as the dense path); zero-padded trailing rows must
    carry zero Jtr.  Returns ``(step, ok)``.
    """
    n = nb * bs
    assert JtJ.shape == (n, n), (JtJ.shape, nb, bs)
    diag = jnp.clip(jnp.diagonal(JtJ), 1e-6, 1e32)
    damped_diag = diag * (1.0 + lam)
    A = JtJ.at[jnp.arange(n), jnp.arange(n)].set(damped_diag)
    d = 1.0 / jnp.sqrt(damped_diag)
    As = A * d[:, None] * d[None, :]
    b = (Jtr * d).reshape(nb, bs)

    blocks = As.reshape(nb, bs, nb, bs)
    ii = jnp.arange(nb)
    D = blocks[ii, :, ii, :]                      # (nb, bs, bs)
    E = blocks[ii[1:], :, ii[:-1], :]             # (nb-1, bs, bs) sub-diag
    E_ext = jnp.concatenate([E, jnp.zeros((1, bs, bs), As.dtype)])

    solve_tri = jax.scipy.linalg.solve_triangular

    def factor(carry, inp):
        CCt = carry
        D_i, E_i = inp
        L = jnp.linalg.cholesky(D_i - CCt)
        # C_i = E_i · L^{-T}; carry C_i·C_iᵀ into the next block.
        Ct = solve_tri(L, E_i.T, lower=True)      # = C_iᵀ
        return jnp.matmul(Ct.T, Ct, precision=_HI), (L, Ct)

    _, (L_all, Ct_all) = jax.lax.scan(
        factor, jnp.zeros((bs, bs), As.dtype), (D, E_ext)
    )

    Ct_prev = jnp.concatenate(
        [jnp.zeros((1, bs, bs), As.dtype), Ct_all[:-1]]
    )

    def forward(y_prev, inp):
        L_i, Ctp, b_i = inp
        y = solve_tri(
            L_i, b_i - jnp.matmul(Ctp.T, y_prev, precision=_HI), lower=True
        )
        return y, y

    _, y_all = jax.lax.scan(
        forward, jnp.zeros((bs,), As.dtype), (L_all, Ct_prev, b)
    )

    def backward(x_next, inp):
        L_i, Ct_i, y_i = inp
        x = solve_tri(
            L_i.T, y_i - jnp.matmul(Ct_i, x_next, precision=_HI), lower=False
        )
        return x, x

    _, x_all = jax.lax.scan(
        backward, jnp.zeros((bs,), As.dtype), (L_all, Ct_all, y_all),
        reverse=True,
    )

    step = -(x_all.reshape(n) * d)
    ok = jnp.all(jnp.isfinite(L_all)) & jnp.all(jnp.isfinite(step))
    return jnp.where(ok, step, 0.0), ok


# ---------------------------------------------------------------------------
# Generic dense LM driver
# ---------------------------------------------------------------------------


class LMProblem(NamedTuple):
    """Functional problem description, the batched analogue of the
    ``LevMarqDenseProblem`` concept (cpp/pnp/lev_marq.h:23-51).

    - ``residuals(params) -> (res, valid, weight)``: res (N, L); valid/weight
      (N,).  Invalid residuals contribute ``inf`` cost if ``invalid_is_inf``
      (the reference's behind-camera convention, cpp/pnp/pnp_problem.h:52-61)
      or are dropped otherwise.
    - ``residuals_jac(params) -> (res, J, valid, weight)``: J (N, L, P).
    - ``step(params, dp) -> params`` with dp (P,).
    - ``normalize``: divide cost / normal equations by the valid count
      (``kShouldNormalize``).
    """

    residuals: Callable
    residuals_jac: Callable
    step: Callable
    num_params: int
    normalize: bool = False
    invalid_is_inf: bool = True


def _total_cost(problem: LMProblem, opts: BundleOptions, params):
    res, valid, weight = problem.residuals(params)
    r2 = jnp.sum(res * res, axis=-1)
    cost_i = weight * loss_value(opts.loss_type, opts.loss_scale, r2)
    if problem.invalid_is_inf:
        cost_i = jnp.where(valid, cost_i, jnp.inf)
        num_valid = res.shape[0]
    else:
        cost_i = jnp.where(valid, cost_i, 0.0)
        num_valid = jnp.maximum(jnp.sum(valid), 1)
    total = jnp.sum(cost_i)
    if problem.normalize:
        total = total / num_valid
    return total


def _normal_equations(problem: LMProblem, opts: BundleOptions, params):
    res, J, valid, weight = problem.residuals_jac(params)
    r2 = jnp.sum(res * res, axis=-1)
    w = weight * loss_weight(opts.loss_type, opts.loss_scale, r2)
    w = jnp.where(valid, w, 0.0)
    hi = jax.lax.Precision.HIGHEST
    JtJ = jnp.einsum("nlp,nlq,n->pq", J, J, w, precision=hi)
    Jtr = jnp.einsum("nlp,nl,n->p", J, res, w, precision=hi)
    if problem.normalize:
        num_valid = jnp.maximum(jnp.sum(valid), 1)
        JtJ = JtJ / num_valid
        Jtr = Jtr / num_valid
    return JtJ, Jtr


class _LMState(NamedTuple):
    params: object
    cost: jax.Array
    lam: jax.Array
    v: jax.Array
    JtJ: jax.Array
    Jtr: jax.Array
    grad_norm: jax.Array
    step_norm: jax.Array
    iterations: jax.Array
    invalid_steps: jax.Array
    done: jax.Array


def lm_solve(problem: LMProblem, params0, opts: BundleOptions):
    """Run LM to convergence.  Returns ``(params, BundleStats)``.

    The whole loop is jit-compatible; call under ``jax.jit`` with
    ``problem``/``opts`` static (close over them).
    """
    f32 = jnp.float32
    init_cost = _total_cost(problem, opts, params0)
    JtJ0, Jtr0 = _normal_equations(problem, opts, params0)

    state = _LMState(
        params=params0,
        cost=init_cost,
        lam=f32(opts.initial_lambda),
        v=f32(2.0),
        JtJ=JtJ0,
        Jtr=Jtr0,
        grad_norm=jnp.linalg.norm(Jtr0),
        step_norm=f32(-1.0),
        iterations=jnp.int32(0),
        invalid_steps=jnp.int32(0),
        done=jnp.linalg.norm(Jtr0) < opts.gradient_tol,
    )

    def cond(s: _LMState):
        return (~s.done) & (s.iterations < opts.max_iterations)

    def body(s: _LMState):
        step, solve_ok = damped_cholesky_solve(s.JtJ, s.Jtr, s.lam)
        step_norm = jnp.linalg.norm(step)

        params_new = problem.step(s.params, step)
        cost_new = _total_cost(problem, opts, params_new)

        improved = solve_ok & (cost_new < s.cost)
        tiny_step = solve_ok & (step_norm < opts.step_tol)

        # Nielsen update on acceptance (cpp/pnp/lev_marq.h:179-197)
        actual = cost_new - s.cost
        expected = jnp.dot(
            step, 2.0 * s.Jtr + jnp.dot(s.JtJ, step, precision=_HI),
            precision=_HI,
        )
        rho = actual / expected
        factor = jnp.maximum(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
        lam_accept = jnp.where(
            rho > 0,
            jnp.clip(s.lam * factor, opts.min_lambda, opts.max_lambda),
            s.lam,
        )

        # Rejection / solve-failure: λ ← min(λ·v, λmax), v ← 2v
        lam_saturated = s.lam >= opts.max_lambda
        lam_reject = jnp.minimum(opts.max_lambda, s.lam * s.v)

        accept = improved & ~tiny_step

        params_out = jax.tree.map(
            lambda new, old: jnp.where(accept, new, old), params_new, s.params
        )
        cost_out = jnp.where(accept, cost_new, s.cost)
        lam_out = jnp.where(accept, lam_accept, lam_reject)
        v_out = jnp.where(accept, 2.0, 2.0 * s.v)
        invalid = s.invalid_steps + jnp.where(improved | tiny_step, 0, 1)

        # Rebuild normal equations only when the step was accepted — a
        # real branch (lax.cond), so rejected iterations skip the whole
        # residual/Jacobian sweep like the reference
        # (cpp/pnp/lev_marq.h:216-228).
        JtJ_out, Jtr_out = jax.lax.cond(
            accept,
            lambda p: _normal_equations(problem, opts, p),
            lambda _: (s.JtJ, s.Jtr),
            params_out,
        )
        grad_norm = jnp.linalg.norm(Jtr_out)

        done = (
            tiny_step
            | (accept & (grad_norm < opts.gradient_tol))
            | (~improved & ~tiny_step & lam_saturated)
        )
        if opts.function_tol > 0.0:
            # Two stagnation exits, both scaled by the current cost:
            # - an ACCEPTED step that only shaved |actual| <= ftol·cost
            #   is at the noise floor — nothing meaningful is left;
            # - a REJECTED step whose attempted move changed the cost by
            #   <= ftol·cost is the λ-doubling tail: every subsequent
            #   step is strictly smaller (λ only grows while rejecting,
            #   J/r are frozen), so it changes the cost even less and
            #   can only be rejected or accepted-within-tolerance.
            # Rejected iterations never touch the parameters, so the
            # second exit returns bit-identical params to running the
            # tail out; the first bounds the final accepted refinement
            # by ftol·cost.
            stagnated = jnp.abs(actual) <= opts.function_tol * s.cost
            done = done | ((accept | (~improved & ~tiny_step)) & stagnated)

        return _LMState(
            params=params_out,
            cost=cost_out,
            lam=lam_out,
            v=v_out,
            JtJ=JtJ_out,
            Jtr=Jtr_out,
            grad_norm=grad_norm,
            step_norm=step_norm,
            iterations=s.iterations + 1,
            invalid_steps=invalid,
            done=done,
        )

    final = jax.lax.while_loop(cond, body, state)

    stats = BundleStats(
        iterations=final.iterations,
        initial_cost=init_cost,
        cost=final.cost,
        lambda_=final.lam,
        invalid_steps=final.invalid_steps,
        step_norm=final.step_norm,
        grad_norm=final.grad_norm,
    )
    return final.params, stats
