"""Animated integrator-vs-exact scenes (GIF + PNG still).

The rendered analogue of the reference's announcement animations
(``examples/90-showcase/02-integrator-ode/main.py``: mp4/gif scenes racing
integrators against ground truth) — re-staged on this library's integrator
API. Every plotted curve is the genuine per-step output of ``step()``.

Scenes:

``oscillator``
    Undamped harmonic oscillator q'' = -q (exact q = cos t). Forward Euler
    (order 1) visibly spirals outward — it doesn't conserve energy — while
    Heun (2) and RK4 (4) hug the exact curve: the classic order-of-accuracy
    story.

``riemannian``
    A non-separable Hamiltonian with position-dependent metric
    M(x) = 1 + x² (the RMHMC setting). The separable ``LeapfrogIntegrator``
    ignores the metric and integrates the wrong dynamics; the
    ``GeneralisedLeapfrogIntegrator`` solves the implicit geometry-aware
    updates and tracks a fine-step reference.

Outputs land next to this file: ``<scene>.gif`` + ``<scene>.png``. Smoke
runs render the PNG stills only (no GIF encoding).
"""

import sys, os
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", ".."))
import _common

smoke = _common.setup()

import jax

# Rendering example: it reads a scalar back per integrator step for the
# animation frames, so host round trips would dominate — always CPU.
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
from matplotlib.animation import FuncAnimation, PillowWriter

from torchebm_tpu.integrators import (
    EulerMaruyamaIntegrator,
    GeneralisedLeapfrogIntegrator,
    HeunIntegrator,
    LeapfrogIntegrator,
    RK4Integrator,
)

HERE = os.path.dirname(os.path.abspath(__file__))


def drive_ode(integ, h, n_steps, **kw):
    """Per-step q(t) trace of a {x, p} system via repeated step() calls."""
    state = {"x": jnp.array([[1.0]]), "p": jnp.array([[0.0]])}
    qs = [1.0]
    for _ in range(n_steps):
        state = integ.step(state, h, **kw)
        qs.append(float(state["x"][0, 0]))
    return jnp.asarray(qs)


def scene_oscillator(n_steps, h=0.3):
    """q'' = -q as a first-order system; exact solution cos t."""
    t = jnp.arange(n_steps + 1) * h
    exact = jnp.cos(t)
    # drive the Hamiltonian form through the symplectic API surrogates:
    # x' = p, p' = -x. Euler/Heun/RK4 integrate the stacked (q, p) state.
    curves = {"exact": exact}

    def stacked_drift(z, _t):
        q, p = z[..., 0:1], z[..., 1:2]
        return jnp.concatenate([p, -q], axis=-1)

    for name, integ in (
        ("euler (1st)", EulerMaruyamaIntegrator()),
        ("heun (2nd)", HeunIntegrator()),
        ("rk4 (4th)", RK4Integrator()),
    ):
        kw = dict(drift=stacked_drift)
        if integ.family == "sde":
            kw.update(key=jax.random.PRNGKey(0), noise_scale=0.0)
        z = {"x": jnp.array([[1.0, 0.0]])}
        qs = [1.0]
        for _ in range(n_steps):
            z = integ.step(z, h, **kw)
            qs.append(float(z["x"][0, 0]))
        curves[name] = jnp.asarray(qs)
    return t, curves


def scene_riemannian(n_steps, h=0.1):
    """Non-separable H = U(x) + p²/(2M(x)) with M(x) = 1 + x²."""
    t = jnp.arange(n_steps + 1) * h

    def force(x, p, _t):
        # -dH/dx for U = x²/2, kinetic p²/(2(1+x²))
        return -x + (p**2) * x / (1.0 + x**2) ** 2

    def velocity(x, p, _t):
        return p / (1.0 + x**2)

    def drive(integ, steps, hh, generalised):
        state = {"x": jnp.array([[1.2]]), "p": jnp.array([[0.0]])}
        qs = [1.2]
        for _ in range(steps):
            if generalised:
                state = integ.step(state, hh, force=force, velocity=velocity)
            else:
                state = integ.step(state, hh, drift=lambda x, _t: -x)
            qs.append(float(state["x"][0, 0]))
        return jnp.asarray(qs)

    # fine-step generalised run as ground truth
    ref_fine = drive(GeneralisedLeapfrogIntegrator(), n_steps * 10, h / 10, True)
    curves = {
        "exact (fine ref)": ref_fine[::10],
        "leapfrog (wrong dynamics)": drive(LeapfrogIntegrator(), n_steps, h, False),
        "generalised leapfrog": drive(
            GeneralisedLeapfrogIntegrator(), n_steps, h, True
        ),
    }
    return t, curves


def render(scene, t, curves, gif):
    fig, ax = plt.subplots(figsize=(8, 4.5))
    ax.set_title(f"integrators vs exact — {scene}")
    ax.set_xlabel("t")
    ax.set_ylabel("q(t)")
    styles = {"exact": dict(lw=2.5, color="black", zorder=5)}
    lines = {}
    for name in curves:
        style = styles.get(name.split(" ")[0], {})
        if name.startswith("exact"):
            style = dict(lw=2.5, color="black", zorder=5)
        (lines[name],) = ax.plot([], [], label=name, **style)
    lo = min(float(jnp.min(c)) for c in curves.values())
    hi = max(float(jnp.max(c)) for c in curves.values())
    pad = 0.1 * (hi - lo)
    ax.set_xlim(0, float(t[-1]))
    ax.set_ylim(lo - pad, hi + pad)
    ax.legend(loc="upper right", fontsize=8)

    def update(frame):
        for name, line in lines.items():
            line.set_data(t[: frame + 1], curves[name][: frame + 1])
        return list(lines.values())

    n_frames = len(t)
    update(n_frames - 1)
    still = os.path.join(HERE, f"{scene}.png")
    fig.savefig(still, dpi=110)
    print(f"wrote {still}")
    if gif:
        anim = FuncAnimation(fig, update, frames=range(0, n_frames, 2), blit=True)
        out = os.path.join(HERE, f"{scene}.gif")
        anim.save(out, writer=PillowWriter(fps=20))
        print(f"wrote {out}")
    plt.close(fig)


def main():
    n_steps = 20 if smoke else 80
    gif = not smoke
    t, curves = scene_oscillator(n_steps)
    # sanity: RK4 tracks cos t, Euler drifts
    err_rk4 = float(jnp.max(jnp.abs(curves["rk4 (4th)"] - curves["exact"])))
    err_euler = float(jnp.max(jnp.abs(curves["euler (1st)"] - curves["exact"])))
    print(f"oscillator: max|err| rk4 {err_rk4:.2e}  euler {err_euler:.2e}")
    assert err_rk4 < 5e-3 and err_euler > 10 * err_rk4
    render("oscillator", t, curves, gif)

    t, curves = scene_riemannian(n_steps)
    err_gl = float(jnp.max(jnp.abs(curves["generalised leapfrog"] - curves["exact (fine ref)"])))
    err_lf = float(jnp.max(jnp.abs(curves["leapfrog (wrong dynamics)"] - curves["exact (fine ref)"])))
    print(f"riemannian: max|err| generalised {err_gl:.2e}  separable {err_lf:.2e}")
    assert err_gl < err_lf
    render("riemannian", t, curves, gif)
    print("OK")


if __name__ == "__main__":
    main()
