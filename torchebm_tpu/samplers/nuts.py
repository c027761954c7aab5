r"""No-U-Turn Sampler (NUTS) — iterative multinomial tree building under jit.

Build addition beyond the reference (TorchEBM has no NUTS): Hoffman & Gelman
(2014) dynamic trajectory lengths with the modern refinements used by Stan and
numpyro — **multinomial** state sampling along the trajectory (not slice
sampling), the **generalized** U-turn criterion on accumulated momentum
(Betancourt 2017), and **biased progressive** sampling at the doubling level
so new subtrees are favored.

Design: the recursive tree of the paper is replaced by the
iterative formulation — an outer ``lax.while_loop`` over doublings and an
inner ``lax.while_loop`` over the :math:`2^{\text{depth}}` leapfrog steps of
each new subtree, with a **checkpoint stack** of size ``max_tree_depth`` that
reproduces every within-subtree U-turn check of the recursive algorithm
(a left-edge state is pushed once per subtree it roots; a leaf with ``m``
trailing one-bits closes ``m`` subtrees and checks/pops ``m`` checkpoints).
The single-chain transition is ``vmap``-ped over chains, so one compiled
program advances every chain in lockstep (masked where a chain's tree has
already terminated).

Supports scalar/diagonal mass matrices (velocities :math:`v = r/m` enter the
U-turn dot products, Stan's :math:`\rho^\top M^{-1} r` criterion) and the
same dual-averaging warmup as :class:`HamiltonianMonteCarlo`.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Any, Dict, Optional, Tuple, Union

import jax
import jax.numpy as jnp
from ..core import struct

from ..core.energies import Energy
from ..core.schedulers import BaseScheduler, sched_init, sched_value
from .base import BaseSampler
from .hmc import DualAveragingState, dual_averaging_update

Array = jax.Array

__all__ = ["NoUTurnSampler"]


def _trailing_ones(n: Array) -> Array:
    """Number of trailing 1-bits of int32 ``n``, closed form.

    Trailing ones of ``n`` = trailing zeros of ``n+1`` =
    ``popcount((m & -m) - 1)`` with ``m = n+1`` — one fused elementwise
    expression instead of a per-leaf ``while_loop`` (which under vmap ran as
    its own masked lockstep loop, several kernels per iteration)."""
    m = n + 1
    return jax.lax.population_count((m & -m) - 1)


@struct.dataclass
class NoUTurnSampler(BaseSampler):
    """NUTS sampler with multinomial sampling and dual-averaging warmup.

    ``max_tree_depth`` bounds trajectories at :math:`2^{\text{depth}}-1`
    leapfrog steps. Diagnostics add ``acceptance_rate`` (mean MH statistic
    over trajectory states, the dual-averaging signal) and ``tree_depth``
    (mean doublings per transition).
    """

    model: Energy = None
    step_size: Union[float, BaseScheduler] = 0.1
    max_tree_depth: int = struct.field(pytree_node=False, default=10)
    mass: Optional[Union[float, Array]] = None
    target_accept: float = struct.field(pytree_node=False, default=0.8)
    divergence_threshold: float = struct.field(pytree_node=False, default=1000.0)
    #: names of ``model_kwargs`` entries that are batch-SHARED (closed over by
    #: every chain) even when their leading dimension equals the chain count.
    #: NUTS vmaps the transition over chains, so it must decide per leaf
    #: whether to slice along axis 0 (the library's per-chain conditioning
    #: contract: leading dim == n_chains) or broadcast; a shared (n, m)
    #: data/feature matrix whose first dimension coincidentally equals
    #: n_chains would otherwise be silently sliced per chain. List such
    #: kwargs here to pin them shared.
    shared_kwargs: Tuple[str, ...] = struct.field(pytree_node=False, default=())

    def __post_init__(self):
        if not 1 <= self.max_tree_depth <= 12:
            raise ValueError("max_tree_depth must be in [1, 12]")

    # ------------------------------------------------------------ energetics

    def _u(self, x: Array, model_kwargs) -> Array:
        """Potential of a single (unbatched) state."""
        return jnp.clip(self.energy_of(x[None], model_kwargs)[0], -1e10, 1e10)

    def _grad_u(self, x: Array, model_kwargs) -> Array:
        return self.gradient_of(x[None], model_kwargs)[0]

    def _mass_vec(self, x: Array) -> Array:
        if self.mass is None:
            return jnp.ones_like(x)
        m = jnp.asarray(self.mass, x.dtype)
        return jnp.broadcast_to(m, x.shape)

    def _kinetic(self, r: Array, m: Array) -> Array:
        return 0.5 * jnp.sum(r * r / m)

    # ---------------------------------------------------------- one NUTS move

    def _transition(self, x: Array, key: Array, eps, model_kwargs):
        """One NUTS transition for a single chain (vmapped by ``step``).

        Returns ``(x_new, accept_stat, depth, diverged)``.
        """
        d = x.shape[0]
        m = self._mass_vec(x)
        max_depth = self.max_tree_depth

        k_mom, k_tree = jax.random.split(key)
        r0 = jax.random.normal(k_mom, (d,), x.dtype) * jnp.sqrt(m)
        h0 = self._u(x, model_kwargs) + self._kinetic(r0, m)

        def leapfrog(xx, rr, direction, g=None):
            e = direction * eps
            g = self._grad_u(xx, model_kwargs) if g is None else g
            r_half = rr - 0.5 * e * g
            x_new = xx + e * r_half / m
            g_new = self._grad_u(x_new, model_kwargs)
            r_new = r_half - 0.5 * e * g_new
            return x_new, r_new, g_new

        def is_turning(p_sum, r_left, r_right):
            v_sum = p_sum  # dot with velocities of the ends
            return jnp.logical_or(
                jnp.dot(v_sum, r_left / m) < 0.0, jnp.dot(v_sum, r_right / m) < 0.0
            )

        # -------------------------------------------------- subtree builder
        def build_subtree(z_start, direction, depth, key_sub):
            """2^depth leapfrog steps from z_start with checkpointed U-turn
            checks; returns the subtree summary."""
            n_leaves = jnp.int32(2) ** depth

            def cond(s):
                return jnp.logical_and(
                    s["i"] < n_leaves,
                    jnp.logical_not(jnp.logical_or(s["turning"], s["diverging"])),
                )

            def body(s):
                xx, rr, gg = s["x"], s["r"], s["g"]
                xx, rr, gg = leapfrog(xx, rr, direction, gg)
                h = self._u(xx, model_kwargs) + self._kinetic(rr, m)
                delta = h - h0
                diverging = delta > self.divergence_threshold
                logw_leaf = -h
                # progressive multinomial within the subtree
                logw_new = jnp.logaddexp(s["logw"], logw_leaf)
                u = jax.random.uniform(jax.random.fold_in(key_sub, s["i"]))
                take = jnp.log(u) < (logw_leaf - logw_new)
                x_prop = jnp.where(take, xx, s["x_prop"])
                acc = s["acc"] + jnp.minimum(1.0, jnp.exp(-delta))

                i = s["i"]
                # push: an even leaf roots subtrees of sizes 2^1..2^c where
                # c = trailing zeros of i (depth copies for i == 0). Every
                # pushed slot stores the same (rr, cum) pair, so the whole
                # push is ONE masked scatter per array (out-of-range indices
                # dropped) instead of max_depth sequential .at[].set calls.
                i_safe = jnp.where(i == 0, 2, i)
                tz = _trailing_ones(jnp.bitwise_not(i_safe))  # trailing zeros
                c = jnp.where(i == 0, depth, jnp.minimum(tz, depth))
                c = jnp.where((i & 1) == 0, c, 0)
                lanes = jnp.arange(max_depth, dtype=jnp.int32)
                slots = s["p"] + lanes
                # Masked lanes target the extra (max_depth-th) row — a
                # write-only scratch row that pops never read (pop slots are
                # clipped to max_depth-1); mode="drop" only guards genuinely
                # out-of-range slots when p + lane overflows the array.
                push_idx = jnp.where(lanes < c, slots, max_depth)
                ckpt = s["ckpt"].at[push_idx].set(
                    jnp.broadcast_to(
                        jnp.concatenate([rr, s["cum"]]), (max_depth, 2 * d)
                    ),
                    mode="drop",
                )
                p = s["p"] + c

                cum = s["cum"] + rr

                # check/pop: an odd leaf with t trailing ones closes t
                # subtrees. All max_depth candidate checkpoints are gathered
                # at once and the U-turn dots batched over that axis.
                t_ones = jnp.where((i & 1) == 1, _trailing_ones(i), 0)
                js = lanes + 1  # 1..max_depth
                slot = jnp.clip(p - js, 0, max_depth - 1)
                popped = ckpt[slot]  # (max_depth, 2d): [r_left | cum_left]
                r_l = popped[:, :d]
                p_sub = cum[None, :] - popped[:, d:]
                turn_j = jnp.logical_or(
                    jnp.sum(p_sub * (r_l / m[None, :]), axis=-1) < 0.0,
                    jnp.sum(p_sub * (rr / m)[None, :], axis=-1) < 0.0,
                )
                turning = jnp.logical_or(
                    s["turning"], jnp.any(jnp.logical_and(js <= t_ones, turn_j))
                )
                p = p - t_ones

                return {
                    "x": xx, "r": rr, "g": gg, "cum": cum,
                    "ckpt": ckpt, "p": p,
                    "x_prop": x_prop, "logw": logw_new,
                    "turning": turning, "diverging": diverging,
                    "acc": acc, "i": i + 1,
                }

            x0s, r0s, g0s = z_start
            init = {
                "x": x0s, "r": r0s, "g": g0s, "cum": jnp.zeros_like(x0s),
                "ckpt": jnp.zeros((max_depth + 1, 2 * d), x0s.dtype),
                "p": jnp.int32(0),
                "x_prop": x0s, "logw": jnp.float32(-jnp.inf),
                "turning": jnp.bool_(False), "diverging": jnp.bool_(False),
                "acc": jnp.float32(0.0), "i": jnp.int32(0),
            }
            return jax.lax.while_loop(cond, body, init)

        # -------------------------------------------------- doubling loop
        def cond(t):
            return jnp.logical_and(
                t["depth"] < max_depth,
                jnp.logical_not(jnp.logical_or(t["turning"], t["diverging"])),
            )

        def body(t):
            key_dir, key_sub, key_merge, key_next = jax.random.split(t["key"], 4)
            go_right = jax.random.bernoulli(key_dir)
            direction = jnp.where(go_right, 1.0, -1.0).astype(x.dtype)
            z_start = (
                jnp.where(go_right, t["x_right"], t["x_left"]),
                jnp.where(go_right, t["r_right"], t["r_left"]),
                jnp.where(go_right, t["g_right"], t["g_left"]),
            )
            sub = build_subtree(z_start, direction, t["depth"], key_sub)

            ok = jnp.logical_not(jnp.logical_or(sub["turning"], sub["diverging"]))
            # biased progressive sampling at the doubling level
            u = jax.random.uniform(key_merge)
            take = jnp.logical_and(
                ok, jnp.log(u) < jnp.minimum(0.0, sub["logw"] - t["logw"])
            )
            x_prop = jnp.where(take, sub["x_prop"], t["x_prop"])
            logw = jnp.logaddexp(t["logw"], jnp.where(ok, sub["logw"], -jnp.inf))

            # merged-tree extremes and U-turn check across the whole tree
            x_left = jnp.where(go_right, t["x_left"], sub["x"])
            r_left = jnp.where(go_right, t["r_left"], sub["r"])
            g_left = jnp.where(go_right, t["g_left"], sub["g"])
            x_right = jnp.where(go_right, sub["x"], t["x_right"])
            r_right = jnp.where(go_right, sub["r"], t["r_right"])
            g_right = jnp.where(go_right, sub["g"], t["g_right"])
            p_sum = t["p_sum"] + sub["cum"]
            turning_tree = jnp.where(ok, is_turning(p_sum, r_left, r_right), False)

            return {
                "x_left": x_left, "r_left": r_left, "g_left": g_left,
                "x_right": x_right, "r_right": r_right, "g_right": g_right,
                "x_prop": x_prop, "logw": logw, "p_sum": p_sum,
                "depth": t["depth"] + 1,
                "turning": jnp.logical_or(sub["turning"], turning_tree),
                "diverging": sub["diverging"],
                "acc_sum": t["acc_sum"] + sub["acc"],
                "n_leaves": t["n_leaves"] + sub["i"].astype(jnp.float32),
                "key": key_next,
            }

        g0 = self._grad_u(x, model_kwargs)
        tree0 = {
            "x_left": x, "r_left": r0, "g_left": g0,
            "x_right": x, "r_right": r0, "g_right": g0,
            "x_prop": x, "logw": -h0, "p_sum": r0,
            "depth": jnp.int32(0),
            "turning": jnp.bool_(False), "diverging": jnp.bool_(False),
            "acc_sum": jnp.float32(0.0), "n_leaves": jnp.float32(0.0),
            "key": k_tree,
        }
        tree = jax.lax.while_loop(cond, body, tree0)
        accept_stat = tree["acc_sum"] / jnp.maximum(tree["n_leaves"], 1.0)
        return tree["x_prop"], accept_stat, tree["depth"].astype(jnp.float32), tree["diverging"]

    def _transition_batch(self, x: Array, key: Array, eps, model_kwargs):
        keys = jax.random.split(key, x.shape[0])
        # Per-chain conditioning (leaves with a leading chains axis, the
        # library contract) must ride the vmap: each single-chain transition
        # sees its own length-1 slice, matching _u/_grad_u's x[None] lift.
        # Batch-independent kwargs stay closed over. The leading-dim test is
        # a heuristic — a batch-shared leaf whose first dimension happens to
        # equal n_chains is indistinguishable from per-chain conditioning by
        # shape alone; ``shared_kwargs`` names such leaves explicitly.
        n = x.shape[0]
        shared = set(self.shared_kwargs)
        unknown = shared.difference(model_kwargs)
        if unknown and model_kwargs:
            raise ValueError(
                f"shared_kwargs names {sorted(unknown)} not present in "
                f"model_kwargs {sorted(model_kwargs)}"
            )
        batched = {
            k: k not in shared and jnp.ndim(v) >= 1 and jnp.shape(v)[0] == n
            for k, v in model_kwargs.items()
        }
        in_axes_mk = {k: (0 if b else None) for k, b in batched.items()}

        def one(xi, ki, mki):
            mk1 = {k: (v[None] if batched[k] else v) for k, v in mki.items()}
            return self._transition(xi, ki, eps, mk1)

        xs, accs, depths, divs = jax.vmap(one, in_axes=(0, 0, in_axes_mk))(
            x, keys, model_kwargs
        )
        return xs, jnp.mean(accs), jnp.mean(depths), jnp.mean(divs.astype(jnp.float32))

    # ---------------------------------------------------------------- hooks

    def init_carry(self, x0, key, model_kwargs):
        return {
            "x": x0,
            "accept_rate": jnp.float32(0.0),
            "tree_depth": jnp.float32(0.0),
            "divergence_rate": jnp.float32(0.0),
        }

    def step(self, carry, i, key, model_kwargs):
        eps = sched_value(self.step_size, i)
        x_new, acc, depth, div = self._transition_batch(carry["x"], key, eps, model_kwargs)
        out = dict(carry)
        out["x"] = x_new
        out["accept_rate"] = acc
        out["tree_depth"] = depth
        out["divergence_rate"] = div
        return out

    def extra_diagnostics(self, carry, model_kwargs):
        return {
            "acceptance_rate": carry["accept_rate"],
            "tree_depth": carry["tree_depth"],
            "divergence_rate": carry["divergence_rate"],
        }

    # ---------------------------------------------------------------- warmup

    def warmup(
        self,
        key: Array,
        x: Optional[Array] = None,
        dim: Optional[Union[int, Tuple[int, ...]]] = None,
        n_warmup: int = 500,
        n_samples: int = 1,
        *,
        adapt_mass: bool = False,
        model_kwargs: Optional[Dict[str, Any]] = None,
    ):
        """Dual-averaging step-size warmup — the same contract as
        :meth:`HamiltonianMonteCarlo.warmup`, including ``adapt_mass``.

        Returns ``(warmed x, adapted step_size)``; with ``adapt_mass=True``
        additionally estimates a Stan-style diagonal mass matrix from the
        per-dimension posterior variance pooled over all chains and the second
        half of warmup, returning ``(warmed x, adapted step_size, mass)``::

            x, eps, mass = nuts.warmup(key, dim=2, n_samples=64, adapt_mass=True)
            tuned = nuts.replace(step_size=eps, mass=mass)
        """
        model_kwargs = model_kwargs or {}
        key_init, key_run = jax.random.split(key)
        x0 = self._init_state(key_init, x, dim, n_samples)
        eps0 = sched_init(self.step_size)
        mu = jnp.float32(math.log(10.0 * eps0))
        x_f, da_f, var = _nuts_warmup_impl(
            self, x0, key_run, n_warmup, self.target_accept, mu,
            DualAveragingState.init(eps0), model_kwargs,
        )
        eps = float(jnp.exp(da_f.log_eps_bar))
        if adapt_mass:
            return x_f, eps, 1.0 / jnp.clip(var, 1e-8, 1e8)
        return x_f, eps


@partial(jax.jit, static_argnames=("n_warmup", "target_accept"))
def _nuts_warmup_impl(sampler, x0, key, n_warmup, target_accept, mu, da0, model_kwargs):
    collect_from = n_warmup // 2  # skip the transient for the variance window

    def body(carry, i):
        x, da, s1, s2, n = carry
        x_new, acc, _, _ = sampler._transition_batch(
            x, jax.random.fold_in(key, i), jnp.exp(da.log_eps), model_kwargs
        )
        da = dual_averaging_update(da, acc, target_accept, mu)
        flat = x_new.reshape(x_new.shape[0], -1)
        take = (i >= collect_from).astype(x0.dtype)
        s1 = s1 + take * jnp.sum(flat, axis=0)
        s2 = s2 + take * jnp.sum(flat * flat, axis=0)
        n = n + take * flat.shape[0]
        return (x_new, da, s1, s2, n), None

    flat_d = x0.reshape(x0.shape[0], -1).shape[-1]
    carry0 = (x0, da0, jnp.zeros(flat_d, x0.dtype), jnp.zeros(flat_d, x0.dtype),
              jnp.float32(0.0))
    (x_f, da_f, s1, s2, n), _ = jax.lax.scan(body, carry0, jnp.arange(n_warmup))
    n = jnp.maximum(n, 2.0)
    var = s2 / n - jnp.square(s1 / n)
    return x_f, da_f, var.reshape(x0.shape[1:])
