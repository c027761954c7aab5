"""``enable_compile_cache``: the environment's directory wins, else a fixed
directory in the checkout."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CODE = (
    "import jax; from torchebm_tpu.utils.compile_cache import enable_compile_cache as e; "
    "p = e(); print(p); print(jax.config.jax_compilation_cache_dir)"
)


def _run(env_dir):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    out = subprocess.run([sys.executable, "-c", CODE], cwd="/", env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.split()


def test_env_dir_wins_and_nothing_else_is_set(tmp_path):
    returned, configured = _run(str(tmp_path))
    assert returned == str(tmp_path) and configured == str(tmp_path)


def test_default_is_the_checkout_cache():
    from torchebm_tpu.utils.compile_cache import CHECKOUT_CACHE

    returned, configured = _run(None)
    assert returned == configured == CHECKOUT_CACHE
    assert CHECKOUT_CACHE == os.path.join(ROOT, ".jax_cache")


def test_checkout_cache_is_gitignored():
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_library_import_sets_no_cache():
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    code = ("import jax, torchebm_tpu, torchebm_tpu.samplers, torchebm_tpu.models; "
            "print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], cwd="/", env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "None"
