r"""Whole-chain Langevin kernel for NVIDIA GPUs (Pallas, Triton route).

The reference's only kernel code is a Triton whole-chain Langevin kernel
(``torchebm/cuda/fused_langevin.py:65-88``, Philox draws at ``:34-62``).
This module is the same idea written for Hopper through
``pl.pallas_call(..., backend="triton")``:

- one chain per lane, a power-of-two block of chains per program, the
  grid over blocks of chains;
- the state is coordinate-major: a ``(2H, n)`` array whose rows ``[0, H)``
  hold coordinates ``[0, h)`` and rows ``[H, 2H)`` coordinates ``[h, d)``,
  with ``h = ceil(d / 2)`` and ``H`` the next power of two — loads and
  stores coalesce along the chains, and the two halves take the two
  outputs of one Box–Muller transform;
- the whole ``n_steps`` loop runs inside the kernel, each chain's state in
  registers; the target's parameters (mixture means and log-weights,
  K·d ≤ 1024) are read once per program when they fit in registers, else
  once per component and step from the L1-resident table;
- step size and noise come from a per-step ``(n_steps, 2)`` table
  ``[η_t, noise_scale_t·√(2η_t)]`` in global memory (constant and scheduled
  chains take the same path); an optional clamp is applied in-kernel;
- a trajectory stores every ``thin``-th state from inside the loop;
- Gaussian noise comes from a counter-based generator in the kernel:
  Threefry-2x32 (20 rounds) keyed by ``(seed, chain)`` with ``(step, pair)``
  as the counter, then Box–Muller on both output words. :func:`threefry2x32`
  is the same code on plain ``jnp`` arrays, so the generator has an exact
  twin outside the kernel.

Targets: :class:`~torchebm_tpu.core.energies.DoubleWellEnergy` (analytic
:math:`\nabla E = 4h\,x(x^2-b^2)`), isotropic
:class:`~torchebm_tpu.core.energies.GaussianMixtureEnergy` (responsibility-
weighted gradient, online softmax over components) and isotropic
:class:`~torchebm_tpu.core.energies.GaussianEnergy` (a one-component
mixture), with d ≤ 64 and K·d ≤ 1024. ``noise=`` replaces the generator
with injected noise for exact-parity tests against :func:`reference_chain`.

The kernel compiles only for a GPU; ``interpret=True`` runs it on any
backend through the Pallas interpreter (tests only).
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple, Union

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

Array = jax.Array

__all__ = [
    "threefry2x32",
    "normal_pair",
    "kernel_normals",
    "kernel_words",
    "langevin_chain",
    "reference_chain",
    "doublewell_langevin_chain",
    "doublewell_langevin_chain_trajectory",
    "mixture_langevin_chain",
    "mixture_langevin_chain_trajectory",
    "MAX_DIM",
    "MAX_K_TIMES_D",
    "PARITY_ATOL",
    "PARITY_BULK_ATOL",
    "parity_errors",
]

#: largest state dimension and mixture size (components × dimension) the
#: kernel takes; larger targets run on the compiled scan.
MAX_DIM = 64
MAX_K_TIMES_D = 1024
#: mixture tables up to this many floats (K·2H) are held in registers for
#: the whole chain; larger ones are re-read from L1 every step.
_PRELOAD_FLOATS = 64
#: chains per program (a power of two) and warps per program, read at every
#: call: one warp of 32 chains measured fastest on an H100 at 10,000 chains
#: (PERF.md, Findings) — it spreads the chains over every SM. The block sweep
#: in ``benchmarks/kernel_vs_scan.py`` sets them.
DEFAULT_BLOCK = 32
DEFAULT_WARPS = 1

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_TWO_PI = 2.0 * math.pi


def threefry2x32(k0, k1, c0, c1):
    """Threefry-2x32 with 20 rounds (Salmon et al. 2011) on uint32 arrays.

    Pure elementwise ``jnp`` arithmetic (add, shift, or, xor), so the same
    function runs inside the kernel and outside it; bit-identical to
    ``jax.random``'s threefry2x32 for the same key and counter words.
    """
    u = jnp.uint32
    k0, k1, c0, c1 = (jnp.asarray(v, u) for v in (k0, k1, c0, c1))
    ks = (k0, k1, k0 ^ k1 ^ u(_PARITY))
    x0 = c0 + ks[0]
    x1 = c1 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = (x1 << u(r)) | (x1 >> u(32 - r))
            x1 = x1 ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + u(i + 1)
    return x0, x1


def normal_pair(b0, b1) -> Tuple[Array, Array]:
    """Two standard normals from two uint32 words (Box–Muller, both outputs).

    The top 24 bits of each word make the uniforms: ``u1`` in ``(0, 1)``
    (offset by half a step, so ``log`` is finite), ``u2`` in ``[0, 1)``.
    """
    u1 = (b0 >> jnp.uint32(8)).astype(jnp.float32) * (1.0 / (1 << 24)) + (
        1.0 / (1 << 25)
    )
    u2 = (b1 >> jnp.uint32(8)).astype(jnp.float32) * (1.0 / (1 << 24))
    r = jnp.sqrt(-2.0 * jnp.log(u1))
    theta = _TWO_PI * u2
    return r * jnp.cos(theta), r * jnp.sin(theta)


def kernel_normals(seed, n_chains: int, d: int, steps) -> Array:
    """The kernel's noise for ``steps`` as a ``(len(steps), n_chains, d)``
    array, computed with plain ``jnp`` (the generator's twin).

    Chain ``c`` at step ``t`` draws pair ``j`` from
    ``threefry2x32(seed, c, t, j)``; coordinate ``j`` takes the cosine
    output and coordinate ``h + j`` the sine output, ``h = ceil(d / 2)``.
    """
    h = (d + 1) // 2
    t = jnp.asarray(steps, jnp.uint32)[:, None, None]
    c = jnp.arange(n_chains, dtype=jnp.uint32)[None, :, None]
    j = jnp.arange(h, dtype=jnp.uint32)[None, None, :]
    b0, b1 = threefry2x32(jnp.uint32(seed), c, t, j)
    z_lo, z_hi = normal_pair(b0, b1)
    return jnp.concatenate([z_lo, z_hi], axis=-1)[..., :d]


# ---------------------------------------------------------------------------
# layout helpers
# ---------------------------------------------------------------------------


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def _half_rows(d: int) -> Tuple[int, int]:
    """``(h, H)``: coordinates in the lower half, and its padded row count."""
    h = (d + 1) // 2
    return h, _next_pow2(h)


def _to_rows(x: Array, d: int, n_pad: int) -> Array:
    """``(..., n, d)`` chain-major -> ``(..., 2H, n_pad)`` kernel layout."""
    h, big_h = _half_rows(d)
    n = x.shape[-2]
    xt = jnp.swapaxes(x.astype(jnp.float32), -1, -2)  # (..., d, n)
    lead = [(0, 0)] * (xt.ndim - 2)
    lo = jnp.pad(xt[..., :h, :], lead + [(0, big_h - h), (0, n_pad - n)])
    hi = jnp.pad(xt[..., h:, :], lead + [(0, big_h - (d - h)), (0, n_pad - n)])
    return jnp.concatenate([lo, hi], axis=-2)


def _from_rows(t: Array, d: int, n: int) -> Array:
    """Inverse of :func:`_to_rows`."""
    h, big_h = _half_rows(d)
    xt = jnp.concatenate([t[..., :h, :n], t[..., big_h : big_h + d - h, :n]], axis=-2)
    return jnp.swapaxes(xt, -1, -2)


def _schedule_table(step_size, noise_scale, n_steps: int) -> Array:
    """``(n_steps, 2)`` float32 rows ``[η_t, noise_scale_t·√(2η_t)]``.

    Each argument is a scalar (constant chain) or an ``(n_steps,)`` schedule.
    """
    for name, p in (("step_size", step_size), ("noise_scale", noise_scale)):
        if jnp.ndim(p) not in (0, 1) or (jnp.ndim(p) == 1 and jnp.shape(p)[0] != n_steps):
            raise ValueError(
                f"{name} must be a scalar or a ({n_steps},) per-step schedule, "
                f"got shape {jnp.shape(p)}"
            )
    h = jnp.broadcast_to(jnp.asarray(step_size, jnp.float32), (n_steps,))
    ns = jnp.broadcast_to(jnp.asarray(noise_scale, jnp.float32), (n_steps,))
    return jnp.stack([h, ns * jnp.sqrt(2.0 * h)], axis=1)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------


def _mixture_terms(means_ref, lw_ref, big_h: int, n_comp: int):
    """Per-component ``(mu_lo, mu_hi, log_w)`` loaders: preloaded register
    values for small tables, in-loop loads otherwise."""
    if n_comp * 2 * big_h <= _PRELOAD_FLOATS:
        rows = [
            (means_ref[k, pl.ds(0, big_h)], means_ref[k, pl.ds(big_h, big_h)], lw_ref[k])
            for k in range(n_comp)
        ]
        return lambda k: rows[k], True
    return (
        lambda k: (
            means_ref[k, pl.ds(0, big_h)],
            means_ref[k, pl.ds(big_h, big_h)],
            lw_ref[k],
        ),
        False,
    )


def _mixture_grad(lo, hi, terms, static_k: bool, n_comp: int, inv_var: float):
    """Gradient of ``-log Σ_k w_k N(x; μ_k, σ²I)`` on the two half tiles,
    with an online softmax over the components."""
    b = lo.shape[1]

    def add(k, carry):
        m, den, num_lo, num_hi = carry
        mu_lo, mu_hi, lw = terms(k)
        dl = lo - mu_lo[:, None]
        dh = hi - mu_hi[:, None]
        logit = lw - (0.5 * inv_var) * (jnp.sum(dl * dl, axis=0) + jnp.sum(dh * dh, axis=0))
        m_new = jnp.maximum(m, logit)
        scale = jnp.exp(m - m_new)
        w = jnp.exp(logit - m_new)
        return (
            m_new,
            den * scale + w,
            num_lo * scale[None, :] + w[None, :] * mu_lo[:, None],
            num_hi * scale[None, :] + w[None, :] * mu_hi[:, None],
        )

    carry = (
        jnp.full((b,), -jnp.inf, jnp.float32),
        jnp.zeros((b,), jnp.float32),
        jnp.zeros_like(lo),
        jnp.zeros_like(hi),
    )
    if static_k:
        for k in range(n_comp):
            carry = add(k, carry)
    else:
        carry = jax.lax.fori_loop(0, n_comp, add, carry)
    _, den, num_lo, num_hi = carry
    inv_den = (1.0 / den)[None, :]
    return (lo - num_lo * inv_den) * inv_var, (hi - num_hi * inv_den) * inv_var


def _word_keys(seed, start, block: int, big_h: int):
    """The generator's per-lane key and pair-counter tiles for one program:
    ``k0 = seed``, ``k1 = chain index``, ``c1 = pair index`` (row)."""
    shape = (big_h, block)
    k0 = jnp.full(shape, seed, jnp.uint32)
    k1 = jnp.broadcast_to((start + jnp.arange(block)).astype(jnp.uint32)[None, :], shape)
    pair = jnp.broadcast_to(jnp.arange(big_h, dtype=jnp.uint32)[:, None], shape)
    return k0, k1, pair


def _words(keys, t):
    """The two uint32 words of every (pair, chain) lane at step ``t``."""
    k0, k1, pair = keys
    return threefry2x32(k0, k1, jnp.full(k0.shape, t.astype(jnp.uint32), jnp.uint32), pair)


def _chain_kernel(*refs, target, n_steps, thin, d, block, clamp, injected):
    """One program: ``block`` chains, all ``n_steps`` steps."""
    refs = list(refs)
    sched_ref = refs.pop(0)
    seed_ref = None if injected else refs.pop(0)
    noise_ref = refs.pop(0) if injected else None
    if target[0] == "mixture":
        means_ref, lw_ref = refs.pop(0), refs.pop(0)
    x_ref, out_ref = refs.pop(0), refs.pop(0)
    traj_ref = refs.pop(0) if thin else None

    h, big_h = _half_rows(d)
    pid = pl.program_id(0)
    start = pid * block
    cols = pl.ds(start, block)
    lo_valid = (jnp.arange(big_h) < h)[:, None]
    hi_valid = (jnp.arange(big_h) < d - h)[:, None]

    if target[0] == "mixture":
        n_comp, inv_var = target[1], target[2]
        terms, static_k = _mixture_terms(means_ref, lw_ref, big_h, n_comp)

        def grad(lo, hi):
            return _mixture_grad(lo, hi, terms, static_k, n_comp, inv_var)

    else:
        coef, b2 = 4.0 * target[1], target[2] * target[2]

        def grad(lo, hi):
            return coef * lo * (lo * lo - b2), coef * hi * (hi * hi - b2)

    if not injected:
        keys = _word_keys(seed_ref[0], start, block, big_h)

    def body(t, state):
        lo, hi = state
        eta = sched_ref[t, 0]
        coef_t = sched_ref[t, 1]
        g_lo, g_hi = grad(lo, hi)
        if injected:
            z_lo = noise_ref[t, pl.ds(0, big_h), cols]
            z_hi = noise_ref[t, pl.ds(big_h, big_h), cols]
        else:
            z_lo, z_hi = normal_pair(*_words(keys, t))
        lo = lo - eta * g_lo + coef_t * z_lo
        hi = hi - eta * g_hi + coef_t * z_hi
        if clamp is not None:
            lo = jnp.clip(lo, clamp[0], clamp[1])
            hi = jnp.clip(hi, clamp[0], clamp[1])
        lo = jnp.where(lo_valid, lo, 0.0)
        hi = jnp.where(hi_valid, hi, 0.0)
        if thin:
            done = t + 1  # t >= 0, so truncating rem/div are the floor ones
            every = jnp.int32(thin)

            @pl.when(jax.lax.rem(done, every) == 0)
            def _():
                kept = jax.lax.div(done, every) - 1
                traj_ref[kept, pl.ds(0, big_h), cols] = lo
                traj_ref[kept, pl.ds(big_h, big_h), cols] = hi

        return lo, hi

    lo, hi = jax.lax.fori_loop(
        0, n_steps, body, (x_ref[pl.ds(0, big_h), :], x_ref[pl.ds(big_h, big_h), :])
    )
    out_ref[pl.ds(0, big_h), :] = lo
    out_ref[pl.ds(big_h, big_h), :] = hi


@functools.partial(
    jax.jit,
    static_argnames=(
        "target", "n_steps", "thin", "clamp", "block", "num_warps", "interpret"
    ),
)
def _run(x0, sched, seed, noise, means, log_weights, *, target, n_steps, thin,
         clamp, block, num_warps, interpret):
    n, d = x0.shape
    _, big_h = _half_rows(d)
    rows = 2 * big_h
    n_pad = -(-n // block) * block
    grid = (n_pad // block,)

    args, in_specs = [sched], [None]
    injected = noise is not None
    if injected:
        args.append(_to_rows(noise, d, n_pad))
        in_specs.append(None)
    else:
        args.append(jnp.reshape(seed, (1,)).astype(jnp.uint32))
        in_specs.append(None)
    if target[0] == "mixture":
        k = means.shape[0]
        args += [_to_rows(means, d, k).T, log_weights.astype(jnp.float32)]  # (K, 2H)
        in_specs += [None, None]
    state_spec = pl.BlockSpec((rows, block), lambda i: (0, i))
    args.append(_to_rows(x0, d, n_pad))
    in_specs.append(state_spec)

    out_shape = [jax.ShapeDtypeStruct((rows, n_pad), jnp.float32)]
    out_specs = [state_spec]
    if thin:
        out_shape.append(jax.ShapeDtypeStruct((n_steps // thin, rows, n_pad), jnp.float32))
        out_specs.append(None)
    outs = pl.pallas_call(
        functools.partial(
            _chain_kernel,
            target=target,
            n_steps=n_steps,
            thin=thin,
            d=d,
            block=block,
            clamp=clamp,
            injected=injected,
        ),
        out_shape=out_shape,
        grid=grid,
        in_specs=[s if s is not None else pl.no_block_spec for s in in_specs],
        out_specs=[s if s is not None else pl.no_block_spec for s in out_specs],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps, num_stages=1),
        interpret=interpret,
        name="langevin_chain",
    )(*args)
    final = _from_rows(outs[0], d, n).astype(x0.dtype)
    if not thin:
        return final
    return _from_rows(outs[1], d, n).astype(x0.dtype), final


def _words_kernel(seed_ref, w0_ref, w1_ref, *, n_steps, big_h, block):
    """Writes the chain kernel's generator words for every step (tests)."""
    start = pl.program_id(0) * block
    keys = _word_keys(seed_ref[0], start, block, big_h)
    cols = pl.ds(start, block)

    def body(t, carry):
        b0, b1 = _words(keys, t)
        w0_ref[t, :, cols] = b0
        w1_ref[t, :, cols] = b1
        return carry

    jax.lax.fori_loop(0, n_steps, body, 0)


def kernel_words(seed, n_chains: int, d: int, n_steps: int, *,
                 interpret: bool = False) -> Tuple[Array, Array]:
    """The two uint32 words the chain kernel draws for pair ``j`` of chain
    ``c`` at step ``t``, as ``(n_steps, n_chains, h)`` arrays, computed by a
    kernel that runs the chain kernel's own generator code. Compare with
    ``threefry2x32(seed, c, t, j)`` to check the generator bit for bit."""
    return _kernel_words(seed, int(n_chains), int(d), int(n_steps), block=DEFAULT_BLOCK,
                         num_warps=DEFAULT_WARPS, interpret=bool(interpret))


@functools.partial(
    jax.jit, static_argnames=("n_chains", "d", "n_steps", "block", "num_warps", "interpret")
)
def _kernel_words(seed, n_chains, d, n_steps, *, block, num_warps, interpret):
    h, big_h = _half_rows(d)
    n_pad = -(-n_chains // block) * block
    words = pl.pallas_call(
        functools.partial(_words_kernel, n_steps=n_steps, big_h=big_h, block=block),
        out_shape=[jax.ShapeDtypeStruct((n_steps, big_h, n_pad), jnp.uint32)] * 2,
        grid=(n_pad // block,),
        in_specs=[pl.no_block_spec],
        out_specs=[pl.no_block_spec, pl.no_block_spec],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps, num_stages=1),
        interpret=interpret,
        name="langevin_chain_words",
    )(jnp.reshape(jnp.asarray(seed).astype(jnp.uint32), (1,)))
    return tuple(jnp.swapaxes(w[:, :h, :n_chains], 1, 2) for w in words)


def langevin_chain(
    x0: Array,
    target: tuple,
    n_steps: int,
    step_size: Union[float, Array],
    noise_scale: Union[float, Array] = 1.0,
    *,
    thin: int = 0,
    means: Optional[Array] = None,
    log_weights: Optional[Array] = None,
    seed=0,
    clamp: Optional[Tuple[float, float]] = None,
    noise: Optional[Array] = None,
    interpret: bool = False,
):
    """Run ``n_steps`` Langevin steps of every chain in one kernel launch.

    ``target`` is ``("mixture", K, 1/σ²)`` (with ``means`` (K, d) and
    ``log_weights`` (K,)) or ``("doublewell", barrier_height, b)``.
    ``thin > 0`` also returns the ``(n_steps // thin, n_chains, d)``
    trajectory of states after steps ``thin, 2·thin, …`` (as ``(traj,
    final)``). ``noise`` (``(n_steps, n_chains, d)``) replaces the in-kernel
    generator. Each program runs ``DEFAULT_BLOCK`` chains on
    ``DEFAULT_WARPS`` warps.
    """
    x0 = jnp.asarray(x0)
    if x0.ndim != 2:
        raise ValueError(f"x0 must be (n_chains, d), got shape {x0.shape}")
    n, d = x0.shape
    n_steps = int(n_steps)
    if d > MAX_DIM:
        raise ValueError(f"the chain kernel takes d <= {MAX_DIM}, got d={d}")
    if target[0] == "mixture":
        if means is None or means.shape != (target[1], d):
            raise ValueError(f"means must be ({target[1]}, {d})")
        if target[1] * d > MAX_K_TIMES_D:
            raise ValueError(f"the chain kernel takes K*d <= {MAX_K_TIMES_D}, got {target[1] * d}")
        if log_weights is None:
            log_weights = jnp.full((target[1],), -math.log(target[1]), jnp.float32)
    elif target[0] != "doublewell":
        raise ValueError(f"unknown kernel target {target[0]!r}")
    block = DEFAULT_BLOCK
    if block < 1 or block & (block - 1):
        raise ValueError(f"DEFAULT_BLOCK must be a power of two, got {block}")
    if thin and n_steps // thin < 1:
        raise ValueError("n_steps // thin must be >= 1 for trajectory output")
    if noise is not None and noise.shape != (n_steps, n, d):
        raise ValueError(f"noise must have shape {(n_steps, n, d)}, got {noise.shape}")
    sched = _schedule_table(step_size, noise_scale, n_steps)
    clamp = None if clamp is None else (float(clamp[0]), float(clamp[1]))
    return _run(
        x0,
        sched,
        jnp.asarray(seed).astype(jnp.uint32),
        noise,
        means,
        log_weights,
        target=tuple(float(v) if isinstance(v, float) else v for v in target),
        n_steps=n_steps,
        thin=int(thin),
        clamp=clamp,
        block=int(block),
        num_warps=int(DEFAULT_WARPS),
        interpret=bool(interpret),
    )


#: tolerances of the kernel against :func:`reference_chain` with the same
#: injected noise, float32, up to 1,000 steps, on each chain's largest
#: |difference| (see :func:`parity_errors`). Each step differs by about an
#: ulp (another summation order over d and K). Most chains keep it there;
#: a chain passing the saddle between two modes has it amplified along the
#: unstable direction for as long as it stays. 64 draws on an H100 (8
#: gaussians at d=2 and a mixing d=64, K=16 mixture, 4,096 and 10,000
#: chains) read: largest 3.0e-4, all at d=2; at most 3 chains of 10,000
#: over 1e-5; d=64 never over 1.5e-6. So the largest may reach
#: PARITY_ATOL (a 3x margin) and the 99.9th percentile PARITY_BULK_ATOL
#: (which allows 10 chains of 10,000 where 3 were seen).
PARITY_ATOL = 1e-3
PARITY_BULK_ATOL = 1e-5


def parity_errors(got, want) -> Tuple[float, float]:
    """``(largest, 99.9th percentile)`` over chains of each chain's largest
    ``|got - want|``, for ``(n_chains, d)`` states."""
    import numpy as np

    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max(axis=-1)
    return float(err.max()), float(np.quantile(err, 0.999))


def reference_chain(grad_fn, x0, n_steps, step_size, noise_scale, noise, *,
                    clamp=None, thin: int = 0):
    """Plain ``jnp`` Langevin chain with injected noise: the kernel's parity
    reference. ``x_{t+1} = clip(x_t - η_t ∇E(x_t) + c_t ε_t)`` with the same
    per-step table; returns what :func:`langevin_chain` returns."""
    sched = _schedule_table(step_size, noise_scale, int(n_steps))

    def step(x, inp):
        row, eps = inp
        x = x - row[0] * grad_fn(x) + row[1] * eps
        if clamp is not None:
            x = jnp.clip(x, clamp[0], clamp[1])
        return x, x

    final, states = jax.lax.scan(step, jnp.asarray(x0, jnp.float32), (sched, noise))
    if not thin:
        return final
    return states[thin - 1 :: thin][: int(n_steps) // thin], final


# -- per-target wrappers (the sampler dispatch rows call these) ---------------


def mixture_langevin_chain(x0, means, n_steps, step_size, noise_scale=1.0, *,
                           scale=1.0, log_weights=None, **kw):
    """Whole chain on an isotropic Gaussian mixture (K components, σ=scale)."""
    means = jnp.asarray(means, jnp.float32)
    target = ("mixture", int(means.shape[0]), 1.0 / float(scale) ** 2)
    return langevin_chain(x0, target, n_steps, step_size, noise_scale,
                          means=means, log_weights=log_weights, **kw)


def mixture_langevin_chain_trajectory(x0, means, n_steps, step_size,
                                      noise_scale=1.0, *, thin=1, **kw):
    """:func:`mixture_langevin_chain` that also returns every ``thin``-th
    state: ``(traj (n_steps//thin, n_chains, d), final)``."""
    if thin < 1:
        raise ValueError("thin must be >= 1")
    return mixture_langevin_chain(x0, means, n_steps, step_size, noise_scale,
                                  thin=int(thin), **kw)


def doublewell_langevin_chain(x0, n_steps, step_size, noise_scale=1.0, *,
                              barrier_height=2.0, b=1.0, **kw):
    """Whole chain on :math:`E(x) = h\\sum_i (x_i^2 - b^2)^2`."""
    target = ("doublewell", float(barrier_height), float(b))
    return langevin_chain(x0, target, n_steps, step_size, noise_scale, **kw)


def doublewell_langevin_chain_trajectory(x0, n_steps, step_size, noise_scale=1.0,
                                         *, thin=1, **kw):
    """:func:`doublewell_langevin_chain` that also returns every ``thin``-th
    state."""
    if thin < 1:
        raise ValueError("thin must be >= 1")
    return doublewell_langevin_chain(x0, n_steps, step_size, noise_scale,
                                     thin=int(thin), **kw)
