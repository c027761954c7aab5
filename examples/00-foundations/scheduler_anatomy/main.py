"""Scheduler anatomy: stateless step -> value maps under jit.

Mirrors the reference's scheduler lesson
(``examples/00-foundations/03-schedulers/01-scheduler-anatomy``). The torch
library mutates a step counter per scheduler (``base_scheduler.py:73-279``);
this design makes every schedule a pure function ``value(step)`` so the
step index can live in the sampler's scan carry — no state, no recompiles,
and annealing runs entirely on-device.
"""

import sys, os
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", ".."))
import _common

smoke = _common.setup()

import jax
import jax.numpy as jnp

from torchebm_tpu.core import (
    ConstantScheduler,
    CosineScheduler,
    ExponentialDecayScheduler,
    GaussianEnergy,
    LinearScheduler,
    TemperatureScheduler,
    WarmupScheduler,
    sched_value,
)
from torchebm_tpu.samplers import LangevinDynamics


def sparkline(vals, width=60):
    blocks = "▁▂▃▄▅▆▇█"
    v = jnp.asarray(vals)
    v = (v - v.min()) / (v.max() - v.min() + 1e-12)
    idx = jnp.linspace(0, len(vals) - 1, width).astype(int)
    return "".join(blocks[int(x * (len(blocks) - 1))] for x in v[idx])


def main():
    steps = jnp.arange(1000)
    schedules = {
        "constant(0.1)": ConstantScheduler(0.1),
        "exp decay .997 floor 1e-3": ExponentialDecayScheduler(0.1, 0.997, min_value=1e-3),
        "linear 0.1 -> 0.01 over 800": LinearScheduler(0.1, 0.01, 800),
        "cosine 0.1 -> 0.001 over 800": CosineScheduler(0.1, 0.001, 800),
        "warmup(100) x cosine": WarmupScheduler(CosineScheduler(0.1, 0.001, 800), 100),
        "EM temperature sqrt(eps(t))": TemperatureScheduler(
            epsilon_max=0.25, tau_star=0.3, n_steps=1000
        ),
    }
    # Schedules vectorize over the step axis — one vmap evaluates the whole
    # curve (the torch design needs a 1000-iteration step() loop).
    for name, s in schedules.items():
        vals = jax.vmap(s.value)(steps)
        print(f"{name:32s} {sparkline(vals)}  [{float(vals[0]):.4f} .. {float(vals[-1]):.4f}]")

    # sched_value accepts bare floats OR schedulers — every sampler/loss knob
    # (step_size, noise_scale, ...) is declared Union[float, BaseScheduler].
    print("sched_value(0.05, any_step) =", float(sched_value(0.05, 123)))

    # A scheduled sampler: annealed Langevin, the schedule advances inside the
    # compiled scan (step index in the carry), not by host-side mutation.
    e = GaussianEnergy.standard(2)
    annealed = LangevinDynamics(
        e,
        step_size=CosineScheduler(0.1, 0.005, 500),
        noise_scale=LinearScheduler(1.0, 0.2, 500),
    )
    x = annealed.sample(jax.random.PRNGKey(0), dim=2, n_samples=2048,
                        n_steps=_common.n(500, 20))
    print(f"annealed Langevin on N(0,I): mean {jnp.mean(x):+.3f} "
          f"std {jnp.std(x):.3f} (std < 1: late-time noise_scale 0.2 tempers)")
    print("OK")


if __name__ == "__main__":
    main()
