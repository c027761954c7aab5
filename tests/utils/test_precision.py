"""Mixed-precision policy tests (reference ``base_module.py:143-176`` parity).

The bf16 policy must (a) keep params/optimizer state in f32, (b) run
compute in bf16, (c) preserve integer conditioning dtypes, and (d) train to
the same place as f32 within bf16 resolution — the reference asserts its AMP
path falls back gracefully; here the equivalent guarantee is loss-curve
parity.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from torchebm_tpu.core import WrappedEnergy
from torchebm_tpu.interpolants import LinearInterpolant
from torchebm_tpu.losses import ContrastiveDivergence
from torchebm_tpu.models import MLPEnergy, MLPVelocityField
from torchebm_tpu.samplers import LangevinDynamics
from torchebm_tpu.utils import bf16_policy, cast_floating, f32_policy


def test_cast_floating_preserves_integers():
    tree = {"x": jnp.ones((3,), jnp.float32), "label": jnp.arange(3), "flag": jnp.array(True)}
    out = cast_floating(tree, jnp.bfloat16)
    assert out["x"].dtype == jnp.bfloat16
    assert out["label"].dtype == tree["label"].dtype
    assert out["flag"].dtype == jnp.bool_


def test_policy_wrap_autocasts():
    policy = bf16_policy()
    seen = {}

    def fn(x, label=None):
        seen["x"] = x.dtype
        seen["label"] = label.dtype
        return x.sum()

    out = policy.wrap(fn)(jnp.ones((4,), jnp.float32), label=jnp.arange(4))
    assert seen["x"] == jnp.bfloat16
    assert seen["label"] == jnp.int32  # ints never cast
    assert out.dtype == jnp.float32  # output back to f32


def test_f32_policy_is_identity():
    x = jnp.ones((2,), jnp.float32)
    assert f32_policy().wrap(lambda a: a)(x).dtype == jnp.float32


def _fit_cd(dtype, key, n_steps=40):
    """Train a tiny CD energy at the given compute dtype; return the loss curve."""
    net = MLPEnergy(hidden_dims=(32, 32), dtype=dtype)
    params = net.init(key, jnp.zeros((1, 2)))
    energy = WrappedEnergy(fn=net.apply, params=params)
    cd = ContrastiveDivergence(
        model=energy,
        sampler=LangevinDynamics(energy, step_size=0.05, fused="off"),
        k_steps=5,
    )
    opt = optax.adam(3e-3)
    opt_state = opt.init(params)

    @jax.jit
    def step(p, s, x, k):
        (loss, _), g = jax.value_and_grad(lambda pp: cd(pp, x, k), has_aux=True)(p)
        upd, s = opt.update(g, s)
        return optax.apply_updates(p, upd), s, loss

    data_key = jax.random.fold_in(key, 99)
    losses, p = [], params
    for i in range(n_steps):
        k = jax.random.fold_in(key, i)
        x = jnp.array([1.0, -1.0]) + 0.3 * jax.random.normal(data_key, (64, 2))
        p, opt_state, loss = step(p, opt_state, x, k)
        losses.append(float(loss))
    return np.array(losses), p


def test_bf16_params_stay_f32(key):
    net = MLPEnergy(dtype=jnp.bfloat16)
    params = net.init(key, jnp.zeros((1, 2)))
    for leaf in jax.tree_util.tree_leaves(params):
        assert leaf.dtype == jnp.float32  # master weights
    out = net.apply(params, jnp.ones((4, 2)))
    assert out.dtype == jnp.float32  # loss-facing output back in f32


def test_bf16_cd_training_parity(key):
    """bf16 compute reaches the same loss region as f32 (same seeds)."""
    l32, _ = _fit_cd(jnp.float32, key)
    l16, _ = _fit_cd(jnp.bfloat16, key)
    # both curves decrease and end near each other (bf16 has ~3 decimal digits)
    assert l16[-5:].mean() < l16[:5].mean()
    assert abs(l32[-5:].mean() - l16[-5:].mean()) < 0.25 * (abs(l32[-5:].mean()) + 1.0)


def test_bf16_flow_matching_loss_close(key):
    """One flow-matching loss evaluation: bf16 within bf16 resolution of f32."""
    net32 = MLPVelocityField(hidden_dims=(64, 64))
    params = net32.init(key, jnp.zeros((1, 2)), jnp.zeros((1,)))
    net16 = MLPVelocityField(hidden_dims=(64, 64), dtype=jnp.bfloat16)
    x1 = jax.random.normal(jax.random.fold_in(key, 1), (128, 2))
    interp = LinearInterpolant()

    def loss_with(net):
        k0, kt = jax.random.split(jax.random.fold_in(key, 2))
        x0 = jax.random.normal(k0, x1.shape)
        t = jax.random.uniform(kt, (x1.shape[0],))
        xt, ut = interp.interpolate(x0, x1, t)
        return float(jnp.mean(jnp.square(net.apply(params, xt, t) - ut)))

    l32, l16 = loss_with(net32), loss_with(net16)
    assert abs(l32 - l16) < 0.05 * (abs(l32) + 1.0)
