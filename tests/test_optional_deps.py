"""The library's main path imports only JAX, numpy, scipy, optax, chex and
einops: with flax, orbax and sklearn blocked from import, the package
imports, a Langevin chain runs and one DiT train step runs."""

import os
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent(
    """
    import importlib.abc, sys

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in {"flax", "orbax", "sklearn"}:
                raise ImportError(f"{name} is blocked")
            return None

    sys.meta_path.insert(0, Block())

    import jax, jax.numpy as jnp, optax
    import torchebm_tpu as tt
    from torchebm_tpu.core import GaussianMixtureEnergy
    from torchebm_tpu.interpolants import LinearInterpolant
    from torchebm_tpu.models import ConditionalTransformer2D
    from torchebm_tpu.samplers import LangevinDynamics

    out = LangevinDynamics(GaussianMixtureEnergy.eight_gaussians(), step_size=0.05).sample(
        jax.random.PRNGKey(0), dim=2, n_samples=64, n_steps=20)
    assert out.shape == (64, 2) and bool(jnp.all(jnp.isfinite(out)))

    net = ConditionalTransformer2D(in_channels=1, out_channels=1, input_size=8, patch_size=4,
                                   embed_dim=32, depth=1, num_heads=2, cond_dim=8)
    x1 = jax.random.normal(jax.random.PRNGKey(1), (4, 1, 8, 8))
    params = net.init(jax.random.PRNGKey(2), x1, jnp.zeros((4, 8)))
    opt = optax.adamw(1e-3)
    state = opt.init(params)

    def loss(p, k):
        x0 = jax.random.normal(k, x1.shape)
        t = jax.random.uniform(k, (4,))
        xt, ut = LinearInterpolant().interpolate(x0, x1, t)
        return jnp.mean((net.apply(p, xt, t[:, None] * jnp.ones((1, 8))) - ut) ** 2)

    l, g = jax.value_and_grad(loss)(params, jax.random.PRNGKey(3))
    u, state = opt.update(g, state, params)
    params = optax.apply_updates(params, u)
    assert bool(jnp.isfinite(l))
    assert not any(m.split(".")[0] in {"flax", "orbax", "sklearn"} for m in sys.modules)
    print("ok")
    """
)


def test_main_path_runs_without_flax_orbax_sklearn():
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


@pytest.mark.parametrize("module", ["orbax", "sklearn"])
def test_optional_imports_stay_lazy(module):
    """Checkpointing (orbax) and the digits fallback (sklearn) import their
    dependency only when called."""
    code = (
        "import sys, torchebm_tpu, torchebm_tpu.utils, torchebm_tpu.datasets, "
        "torchebm_tpu.core.trainer; "
        f"print(any(m.split('.')[0] == {module!r} for m in sys.modules))"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "False"
