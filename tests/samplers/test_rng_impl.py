"""RNG-implementation upgrade (`_upgrade_key`) and scan-unroll contracts.

Switching the chain's generator (threefry -> XLA `rbg` bits) must be
invisible semantically: `auto` keeps threefry, explicit impls are respected,
and `unroll` is pure codegen (bitwise-identical chains).
"""

import jax
import jax.numpy as jnp
import pytest

from torchebm_tpu.core import GaussianEnergy
from torchebm_tpu.samplers import LangevinDynamics
from torchebm_tpu.samplers.base import _upgrade_key

ENERGY = GaussianEnergy.standard(2)


def test_auto_keeps_threefry_key():
    key = jax.random.PRNGKey(0)
    assert _upgrade_key(key, "auto") is key


def test_threefry_pin_is_noop():
    key = jax.random.key(0)
    assert _upgrade_key(key, "threefry") is key


def test_explicit_rbg_upgrades_raw_key():
    key = jax.random.PRNGKey(0)
    up = _upgrade_key(key, "rbg")
    assert jnp.issubdtype(up.dtype, jax.dtypes.prng_key)
    assert "rbg" in str(jax.random.key_impl(up))
    # 2-word threefry data duplicated into the 4-word rbg layout
    data = jax.random.key_data(up)
    assert data.shape == (4,)
    assert bool(jnp.all(data[:2] == data[2:]))


def test_explicit_rbg_upgrades_typed_threefry_key():
    up = _upgrade_key(jax.random.key(7), "rbg")
    assert "rbg" in str(jax.random.key_impl(up))


def test_typed_nondefault_key_respected():
    key = jax.random.key(3, impl="rbg")
    assert _upgrade_key(key, "rbg") is key
    assert _upgrade_key(key, "auto") is key


def test_env_override(monkeypatch):
    monkeypatch.setenv("TORCHEBM_RNG_IMPL", "threefry")
    key = jax.random.PRNGKey(0)
    assert _upgrade_key(key, "rbg") is key


def test_sampler_runs_with_rbg_key():
    """End-to-end: the shared scan accepts an rbg-typed key."""
    sampler = LangevinDynamics(ENERGY, step_size=0.1, fused="off")
    key = _upgrade_key(jax.random.PRNGKey(0), "rbg")
    out = sampler.sample(key, dim=2, n_samples=64, n_steps=50)
    assert out.shape == (64, 2)
    assert bool(jnp.all(jnp.isfinite(out)))


def test_rbg_sampling_statistics():
    """rbg noise is real noise: N(0,I) Langevin moments match the target."""
    sampler = LangevinDynamics(ENERGY, step_size=0.1, fused="off")
    key = _upgrade_key(jax.random.PRNGKey(42), "rbg")
    out = sampler.sample(key, dim=2, n_samples=4096, n_steps=400)
    assert float(jnp.max(jnp.abs(jnp.mean(out, 0)))) < 0.15
    assert float(jnp.max(jnp.abs(jnp.var(out, 0) - 1.0))) < 0.2


@pytest.mark.parametrize("thin", [1, 3])
def test_unroll_is_pure_codegen(thin):
    """unroll>1 must produce the bitwise-identical chain (same per-step keys)."""
    key = jax.random.PRNGKey(5)
    kw = dict(dim=2, n_samples=16, n_steps=10, thin=thin, return_trajectory=True)
    base = LangevinDynamics(ENERGY, step_size=0.05, fused="off").sample(key, **kw)
    unrolled = LangevinDynamics(ENERGY, step_size=0.05, fused="off", unroll=4).sample(key, **kw)
    assert bool(jnp.all(base == unrolled))


# --------------------------------------------------------------- noise_block


def _nb_sampler(**kw):
    return LangevinDynamics(ENERGY, step_size=0.1, fused="off", **kw)


def test_noise_block_moments():
    """Block-drawn noise is real noise: N(0,I) Langevin moments match."""
    out = _nb_sampler(noise_block=4).sample(
        jax.random.PRNGKey(0), dim=2, n_samples=4096, n_steps=402  # remainder=2
    )
    assert float(jnp.max(jnp.abs(jnp.mean(out, 0)))) < 0.15
    assert float(jnp.max(jnp.abs(jnp.var(out, 0) - 1.0))) < 0.2


def test_noise_block_reproducible():
    key = jax.random.PRNGKey(1)
    s = _nb_sampler(noise_block=8)
    a = s.sample(key, dim=2, n_samples=8, n_steps=17)
    b = s.sample(key, dim=2, n_samples=8, n_steps=17)
    assert bool(jnp.all(a == b))
    c = s.sample(jax.random.PRNGKey(2), dim=2, n_samples=8, n_steps=17)
    assert not bool(jnp.all(a == c))


def test_noise_block_zero_noise_equals_generic_path():
    """With noise_scale=0 the stream is irrelevant: block path must equal the
    generic scan bitwise — pins scheduler indexing, clamp, gradient wiring."""
    from torchebm_tpu.core import CosineScheduler

    key = jax.random.PRNGKey(3)
    kw = dict(step_size=CosineScheduler(start_value=0.1, end_value=0.01, n_steps=20),
              noise_scale=0.0, clamp=(-0.8, 0.8), fused="off")
    x0 = 2.0 * jnp.ones((8, 2))
    a = LangevinDynamics(ENERGY, **kw).sample(key, x=x0, n_steps=19)
    b = LangevinDynamics(ENERGY, noise_block=4, **kw).sample(key, x=x0, n_steps=19)
    assert bool(jnp.all(a == b))


def test_noise_block_falls_back_for_trajectory():
    s = _nb_sampler(noise_block=4)
    traj = s.sample(jax.random.PRNGKey(0), dim=2, n_samples=4, n_steps=8,
                    return_trajectory=True)
    assert traj.shape == (4, 8, 2)


def test_noise_block_falls_back_for_thin():
    out = _nb_sampler(noise_block=4).sample(
        jax.random.PRNGKey(0), dim=2, n_samples=4, n_steps=9, thin=3
    )
    assert out.shape == (4, 2)


def test_noise_block_validation():
    with pytest.raises(ValueError, match="noise_block"):
        _nb_sampler(noise_block=0)


def test_noise_block_works_under_jit():
    s = _nb_sampler(noise_block=4)
    f = jax.jit(lambda k: s.sample(k, dim=2, n_samples=8, n_steps=12))
    assert f(jax.random.PRNGKey(0)).shape == (8, 2)
