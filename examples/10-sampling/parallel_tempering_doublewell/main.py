"""Replica-exchange (parallel-tempered) Langevin on a bimodal double well.

Plain Langevin chains started in one well stay trapped behind the energy
barrier; a temperature ladder whose hot replicas diffuse freely ferries
states across via Metropolis swap moves, so the cold chain recovers BOTH
modes. The whole ladder — every temperature, every swap sweep — runs as one
compiled XLA program with the replicas as an extra batch axis.

The reference library only sketches this (stub at
``torchebm/losses/contrastive_divergence.py:246-263``).
"""

import sys, os
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", ".."))
import _common

smoke = _common.setup()

import jax
import jax.numpy as jnp

from torchebm_tpu.core import DoubleWellEnergy
from torchebm_tpu.samplers import LangevinDynamics, ParallelTemperingLangevin


def main():
    key = jax.random.PRNGKey(0)
    energy = DoubleWellEnergy(barrier_height=8.0, b=1.0)

    n_chains = 64 if smoke else 4096
    n_steps = _common.n(2000, 200)
    x0 = -jnp.ones((n_chains, 1))  # everyone starts in the LEFT well

    plain = LangevinDynamics(energy, step_size=0.005)
    stuck = plain.sample(key, x=x0, n_steps=n_steps)
    print(f"plain Langevin  : right-well fraction "
          f"{float(jnp.mean(stuck > 0)):.3f}  (trapped; should be ~0)")

    pt = ParallelTemperingLangevin(
        energy,
        temperatures=(1.0, 3.0, 9.0, 27.0, 81.0),
        step_size=0.005,
        swap_every=5,
    )
    mixed, diag = pt.sample(key, x=x0, n_steps=n_steps, return_diagnostics=True)
    frac = float(jnp.mean(mixed > 0))
    print(f"parallel temper : right-well fraction {frac:.3f}  (mixed; target ~0.5)")
    print(f"swap acceptance : {float(diag['swap_acceptance_rate'][-1]):.3f}")
    if not smoke:
        assert 0.3 < frac < 0.7, "cold chain failed to mix"

    # The same ladder on a mixture target: every temperature steps in the
    # same compiled program, exchanges are branch-free selects.
    from torchebm_tpu.core import GaussianMixtureEnergy

    mix = GaussianMixtureEnergy.eight_gaussians(radius=4.0, scale=0.3)
    pt_mix = ParallelTemperingLangevin(
        mix, temperatures=(1.0, 1.6, 2.56, 4.1), step_size=0.05, swap_every=5
    )
    x0_ring = jnp.tile(jnp.array([[4.0, 0.0]]), (n_chains, 1))  # one mode
    cold = pt_mix.sample(jax.random.fold_in(key, 1), x=x0_ring, n_steps=n_steps)
    ang = jnp.arctan2(cold[:, 1], cold[:, 0])
    occupied = int(jnp.sum(jnp.histogram(ang, bins=8, range=(-3.15, 3.15))[0] > 0))
    print(f"8gaussians ladder: modes occupied {occupied}/8 "
          f"(started all chains in ONE mode)")
    if not smoke:
        assert occupied >= 6, "tempered ladder failed to spread over the ring"
    print("OK")


if __name__ == "__main__":
    main()
