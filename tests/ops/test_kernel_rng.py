"""The whole-chain kernel's counter-based generator.

``threefry2x32`` is plain elementwise uint32 arithmetic that runs both inside
the kernel and outside it; these tests pin it bit for bit to JAX's own
threefry2x32, pin the kernel's in-kernel draws to their ``jnp`` twin
(``kernel_normals``), and check the Box–Muller normals' moments and
independence.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax._src import prng

from torchebm_tpu.ops import fused_langevin, kernel_normals, langevin_chain, threefry2x32


@pytest.mark.parametrize(
    "k0,k1", [(0, 0), (123, 456), (2**32 - 1, 7), (0xDEADBEEF, 0x12345678)]
)
def test_threefry_matches_jax_bit_for_bit(k0, k1):
    counts = jnp.arange(64, dtype=jnp.uint32) * jnp.uint32(2654435761)
    want = np.asarray(prng.threefry_2x32(jnp.array([k0, k1], jnp.uint32), counts))
    b0, b1 = threefry2x32(k0, k1, counts[:32], counts[32:])
    np.testing.assert_array_equal(np.concatenate([b0, b1]), want)


@pytest.mark.parametrize("block", [16, 32])
@pytest.mark.parametrize("d", [1, 2, 3, 8])
def test_in_kernel_draws_equal_jnp_twin(d, block, monkeypatch):
    """With a flat target (barrier 0) and unit noise coefficient the kernel's
    trajectory is the running sum of its draws, which must be the twin's
    draws: same words, same Box–Muller, independent of the block size."""
    monkeypatch.setattr(fused_langevin, "DEFAULT_BLOCK", block)
    n, steps, seed = 40, 6, 2024
    traj, _ = langevin_chain(
        jnp.zeros((n, d)), ("doublewell", 0.0, 1.0), steps, 0.5, 1.0,
        thin=1, seed=seed, interpret=True,
    )
    z = kernel_normals(seed, n, d, jnp.arange(steps))
    np.testing.assert_allclose(np.asarray(traj), np.asarray(jnp.cumsum(z, axis=0)), atol=1e-6)


def _draws(seed=7, n=4096, d=4, steps=64):
    return np.asarray(kernel_normals(seed, n, d, jnp.arange(steps))).reshape(-1, d)


def test_normal_moments():
    z = _draws()
    assert abs(z.mean()) < 0.01
    assert abs(z.var() - 1.0) < 0.01
    assert abs(np.mean(z**4) - 3.0) < 0.05  # Gaussian kurtosis
    assert abs(np.mean(np.abs(z) < 1.0) - 0.6827) < 0.005


@pytest.mark.parametrize("axis", ["pair", "coordinate", "step", "chain"])
def test_draws_are_uncorrelated(axis):
    """Cosine and sine outputs of one pair, two pairs, consecutive steps and
    neighbouring chains must all be uncorrelated."""
    z = np.asarray(kernel_normals(11, 2048, 4, jnp.arange(32)))  # (T, n, d)
    if axis == "pair":  # coords 0 and 2 come from the same two words
        a, b = z[..., 0], z[..., 2]
    elif axis == "coordinate":
        a, b = z[..., 0], z[..., 1]
    elif axis == "step":
        a, b = z[:-1], z[1:]
    else:
        a, b = z[:, :-1], z[:, 1:]
    r = np.corrcoef(a.ravel(), b.ravel())[0, 1]
    assert abs(r) < 0.01, r


def test_seeds_give_different_streams():
    a = kernel_normals(1, 64, 2, jnp.arange(4))
    b = kernel_normals(2, 64, 2, jnp.arange(4))
    assert float(jnp.mean(jnp.abs(a - b))) > 0.5
    np.testing.assert_array_equal(np.asarray(a), np.asarray(kernel_normals(1, 64, 2, jnp.arange(4))))
