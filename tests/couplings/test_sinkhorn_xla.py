"""The XLA Sinkhorn fixed point: the tolerance gate and the unroll knob.

``sinkhorn_log`` / ``unbalanced_sinkhorn_log`` run a ``lax.fori_loop``
(``tol == 0``) or a bounded ``lax.while_loop`` that exits once the potential
update drops below ``tol``, checked every ``unroll`` iterations. The gate
must land on the same fixed point, and unrolling must not change the result.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torchebm_tpu.couplings.ot import sinkhorn_log, unbalanced_sinkhorn_log


def _cost(key, n, m):
    a = jax.random.normal(key, (n, 2))
    b = jax.random.normal(jax.random.fold_in(key, 1), (m, 2)) + 1.0
    c = jnp.sum((a[:, None] - b[None]) ** 2, -1)
    return c / jnp.max(c)


@pytest.mark.parametrize("shape", [(96, 96), (64, 160)])
def test_tol_gate_matches_full_run(shape):
    c = _cost(jax.random.PRNGKey(3), *shape)
    full = sinkhorn_log(c, reg=0.1, n_iters=2000)
    gated = sinkhorn_log(c, reg=0.1, n_iters=2000, tol=1e-6, unroll=4)
    np.testing.assert_allclose(np.asarray(gated), np.asarray(full), atol=1e-4)


@pytest.mark.parametrize("unroll", [2, 3, 8])
def test_unroll_is_exact(unroll):
    c = _cost(jax.random.PRNGKey(4), 40, 72)
    a = sinkhorn_log(c, reg=0.05, n_iters=64, unroll=1)
    b = sinkhorn_log(c, reg=0.05, n_iters=64, unroll=unroll)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("unroll", [1, 4])
def test_unbalanced_unroll_and_gate(unroll):
    c = _cost(jax.random.PRNGKey(5), 64, 96)
    full = unbalanced_sinkhorn_log(c, reg=0.1, reg_marginal=0.5, n_iters=1500)
    gated = unbalanced_sinkhorn_log(
        c, reg=0.1, reg_marginal=0.5, n_iters=1500, tol=1e-6, unroll=unroll
    )
    np.testing.assert_allclose(np.asarray(gated), np.asarray(full), atol=1e-4)


def test_gated_plan_marginals_are_uniform():
    """A tol-gated exit still leaves a plan with uniform marginals to the
    tolerance's scale."""
    c = _cost(jax.random.PRNGKey(2), 128, 128)
    plan = jnp.exp(sinkhorn_log(c, reg=0.05, n_iters=500, tol=1e-5, unroll=4))
    np.testing.assert_allclose(np.asarray(plan.sum(1)), np.full(128, 1 / 128), rtol=2e-3)
    np.testing.assert_allclose(np.asarray(plan.sum(0)), np.full(128, 1 / 128), rtol=2e-3)


def test_partial_block_respects_cap():
    """n_iters not a multiple of unroll: the trailing partial block runs only
    while unconverged, and never past the cap (tol=0 equivalent at huge tol
    would exit at the first check)."""
    c = _cost(jax.random.PRNGKey(6), 32, 48)
    capped = sinkhorn_log(c, reg=0.05, n_iters=10, tol=1e-30, unroll=4)
    exact = sinkhorn_log(c, reg=0.05, n_iters=10)
    np.testing.assert_allclose(np.asarray(capped), np.asarray(exact), rtol=1e-6, atol=1e-6)


def test_under_jit_matches_eager():
    c = _cost(jax.random.PRNGKey(7), 32, 128)
    f = jax.jit(lambda x: sinkhorn_log(x, reg=0.05, n_iters=40, tol=1e-3))
    ref = sinkhorn_log(c, reg=0.05, n_iters=40, tol=1e-3)
    np.testing.assert_allclose(np.asarray(f(c)), np.asarray(ref), rtol=1e-4, atol=1e-5)
