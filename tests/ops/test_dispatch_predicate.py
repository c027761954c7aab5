"""``ops.kernels_enabled``: the one predicate that decides the kernel path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torchebm_tpu.ops import FUSED_MODES, kernel_words, kernels_enabled, threefry2x32


def test_modes():
    assert FUSED_MODES == ("auto", "off", "force")
    assert kernels_enabled("off") is False
    assert kernels_enabled("auto") is (jax.default_backend() == "gpu")


def test_force_raises_off_gpu():
    if jax.default_backend() == "gpu":
        assert kernels_enabled("force") is True
    else:
        with pytest.raises(RuntimeError, match="needs a GPU"):
            kernels_enabled("force")


@pytest.mark.parametrize("bad", ["on", "", "FORCE"])
def test_unknown_mode_raises(bad):
    with pytest.raises(ValueError, match="fused must be one of"):
        kernels_enabled(bad)


@pytest.mark.parametrize("d", [1, 2, 5, 64])
def test_kernel_words_match_twin_bit_for_bit(d):
    """The words kernel runs the chain kernel's own generator code."""
    n, steps, seed = 45, 3, 31337
    w0, w1 = kernel_words(seed, n, d, steps, interpret=True)
    t = jnp.arange(steps, dtype=jnp.uint32)[:, None, None]
    c = jnp.arange(n, dtype=jnp.uint32)[None, :, None]
    j = jnp.arange((d + 1) // 2, dtype=jnp.uint32)[None, None, :]
    b0, b1 = threefry2x32(seed, c, t, j)
    np.testing.assert_array_equal(np.asarray(w0), np.asarray(b0))
    np.testing.assert_array_equal(np.asarray(w1), np.asarray(b1))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["d2_8gaussians", "d64_k16"])
def test_compiled_kernel_matches_reference_on_gpu(case, gpu):
    """On the card: the compiled kernel against the plain reference, at
    ``chip_smoke.py``'s two widths and tolerance (d=64 means close enough
    that the responsibilities mix)."""
    from torchebm_tpu.core import GaussianMixtureEnergy
    from torchebm_tpu.ops import mixture_langevin_chain, reference_chain
    from torchebm_tpu.ops.fused_langevin import PARITY_ATOL, PARITY_BULK_ATOL, parity_errors

    if case == "d2_8gaussians":
        mix = GaussianMixtureEnergy.eight_gaussians()
    else:
        mix = GaussianMixtureEnergy.create(
            0.25 * jax.random.normal(jax.random.PRNGKey(2), (16, 64)), scale=1.0)
    n, d, steps = 4096, mix.means.shape[1], 1000
    x0 = mix.sample(jax.random.PRNGKey(0), n)
    noise = jax.random.normal(jax.random.PRNGKey(1), (steps, n, d))
    got = mixture_langevin_chain(x0, mix.means, steps, 0.01, 1.0, scale=float(mix.scale),
                                 log_weights=mix.log_weights, noise=noise)
    with jax.default_matmul_precision("highest"):
        want = reference_chain(mix.gradient, x0, steps, 0.01, 1.0, noise)
    worst, bulk = parity_errors(got, want)
    assert worst <= PARITY_ATOL and bulk <= PARITY_BULK_ATOL, (worst, bulk)


def test_parity_errors_take_each_chains_largest_difference():
    from torchebm_tpu.ops.fused_langevin import parity_errors

    want = np.zeros((2000, 3), np.float32)
    got = want.copy()
    got[:, 1] = 1e-6  # every chain off by 1e-6 in one coordinate
    got[7, 2] = 5e-4  # one chain passing a saddle
    worst, bulk = parity_errors(got, want)
    assert worst == pytest.approx(5e-4)
    assert bulk == pytest.approx(1e-6)
