r"""Contrastive Divergence (CD-k / PCD) with a functional replay buffer.

Reference: ``torchebm/losses/contrastive_divergence.py:13-263`` and the buffer
machinery in ``torchebm/core/base_loss.py:152-393``. The torch design mutates
a registered buffer in place with a cached Python pointer; here the buffer is
an explicit :class:`ReplayBuffer` pytree threaded through the (jitted,
donatable) training step — the FIFO ring write, stratified reads, and
exploration noise are all pure array ops.

Call convention::

    cd = ContrastiveDivergence(model=e, sampler=LangevinDynamics(e, ...), k_steps=10)
    loss, (negatives, new_buffer) = cd(params, x, key, buffer)

For standard CD pass ``buffer=None`` (chains start at the data). For PCD
(``persistent=True``) create the buffer once with :meth:`init_buffer` — the
chunked MCMC warm-up stays outside the hot jitted path, mirroring the
reference (``base_loss.py:152-226``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
from ..core import struct

from ..core.energies import Energy
from ..core.module import warn_once
from ..samplers.base import BaseSampler
from .base import BaseLoss, inject_params

Array = jax.Array

__all__ = [
    "ReplayBuffer",
    "ContrastiveDivergence",
    "PersistentContrastiveDivergence",
    "ParallelTemperingCD",
]


@struct.dataclass
class ReplayBuffer:
    """PCD replay buffer: samples ring + write pointer (pure pytree state)."""

    samples: Array  # (buffer_size, *data_shape)
    ptr: Array  # int32 write pointer

    @property
    def size(self) -> int:
        return self.samples.shape[0]

    def push(self, batch: Array) -> "ReplayBuffer":
        """FIFO ring write with wraparound (reference ``base_loss.py:352-388``)."""
        n = batch.shape[0]
        idx = (self.ptr + jnp.arange(n)) % self.size
        return ReplayBuffer(
            samples=self.samples.at[idx].set(jax.lax.stop_gradient(batch)),
            ptr=(self.ptr + n) % self.size,
        )


@struct.dataclass
class ContrastiveDivergence(BaseLoss):
    r"""CD-k / PCD loss: :math:`\mathbb E[E(x)] - \mathbb E[E(x^-)]` + optional
    energy-magnitude regularization, with a sync-free non-finite guard
    (reference ``contrastive_divergence.py:157-223``)."""

    model: Energy = None
    sampler: BaseSampler = None
    k_steps: int = struct.field(pytree_node=False, default=10)
    persistent: bool = struct.field(pytree_node=False, default=False)
    buffer_size: int = struct.field(pytree_node=False, default=10_000)
    init_steps: int = struct.field(pytree_node=False, default=100)
    new_sample_ratio: float = struct.field(pytree_node=False, default=0.05)
    energy_reg_weight: float = struct.field(pytree_node=False, default=0.001)
    add_noise_to_real: bool = struct.field(pytree_node=False, default=False)
    noise_scale: float = struct.field(pytree_node=False, default=1e-4)

    # ------------------------------------------------------------- buffer

    def init_buffer(
        self,
        key: Array,
        data_shape: Tuple[int, ...],
        chunk_size: int = 1024,
        init_noise_scale: float = 0.01,
        params: Any = None,
    ) -> ReplayBuffer:
        """Noise-init the buffer, then (optionally) warm it up with chunked MCMC.

        Kept outside jit on purpose (one-time cost), like the reference keeps
        it out of the hot path.
        """
        if not self.persistent:
            raise ValueError("init_buffer is only meaningful for persistent=True")
        if self.buffer_size <= 0:
            raise ValueError(f"Replay buffer size must be positive, got {self.buffer_size}")
        k_noise, k_warm = jax.random.split(key)
        samples = (
            jax.random.normal(k_noise, (self.buffer_size, *data_shape), jnp.float32)
            * init_noise_scale
        )
        if self.init_steps > 0:
            sampler = self.sampler.replace(model=inject_params(self.sampler.model, params))
            chunk = min(self.buffer_size, chunk_size)
            updated = []
            for i in range(0, self.buffer_size, chunk):
                noise_chunk = samples[i : i + chunk]
                # Per-chunk failure fallback: a sampler error (bad params, OOM,
                # transient backend fault) keeps that chunk's noise instead of
                # aborting buffer init (reference base_loss.py:216-226).
                try:
                    out = sampler.sample(
                        jax.random.fold_in(k_warm, i),
                        x=noise_chunk,
                        n_steps=self.init_steps,
                    )
                    if out.shape != noise_chunk.shape:
                        warn_once(
                            "cd-init-buffer-shape",
                            "Sampler output shape mismatch during buffer init: "
                            f"expected {noise_chunk.shape}, got {out.shape}. "
                            f"Keeping noise for chunk {i}-{i + noise_chunk.shape[0]}.",
                            RuntimeWarning,
                        )
                        out = noise_chunk
                except Exception as e:  # noqa: BLE001 - mirror reference catch-all
                    warn_once(
                        "cd-init-buffer-error",
                        f"Error during buffer warm-up sampling for chunk "
                        f"{i}-{i + noise_chunk.shape[0]}: {e}. Keeping noise.",
                        RuntimeWarning,
                    )
                    out = noise_chunk
                updated.append(out)
            samples = jnp.concatenate(updated, axis=0)
        return ReplayBuffer(samples=samples, ptr=jnp.int32(0))

    def get_negative_samples(
        self,
        key: Array,
        batch_size: int,
        data_shape: Tuple[int, ...],
        buffer: Optional[ReplayBuffer] = None,
    ) -> Array:
        """Standalone negatives draw outside a loss call (eval/visualization).

        Reference ``base_loss.py:301-350``: non-persistent CD (or a missing
        buffer) returns ``N(0, I)`` noise; PCD mixes ``new_sample_ratio`` fresh
        noise rows with uniform random replay-buffer draws.
        """
        if not self.persistent or buffer is None:
            return jax.random.normal(key, (batch_size, *data_shape), jnp.float32)
        n_new = max(1, int(batch_size * self.new_sample_ratio))
        n_old = batch_size - n_new
        k_noise, k_idx = jax.random.split(key)
        fresh = jax.random.normal(k_noise, (n_new, *data_shape), jnp.float32)
        if n_old <= 0:
            return fresh
        indices = jax.random.randint(k_idx, (n_old,), 0, buffer.size)
        return jnp.concatenate([fresh, buffer.samples[indices]], axis=0)

    def _start_points(self, x: Array, buffer: Optional[ReplayBuffer], key: Array) -> Array:
        """Data starts (CD) or stratified buffer draws + exploration noise (PCD)
        (reference ``base_loss.py:228-299``)."""
        if not self.persistent:
            return jax.lax.stop_gradient(x)
        if buffer is None:
            raise ValueError(
                "persistent=True requires a ReplayBuffer state; create one with "
                "cd.init_buffer(key, data_shape) and thread it through calls."
            )
        batch = x.shape[0]
        k_idx, k_perm, k_noise = jax.random.split(key, 3)
        if buffer.size < batch:
            indices = jax.random.randint(k_idx, (batch,), 0, buffer.size)
        else:
            stride = buffer.size // batch
            base = jnp.arange(batch) * stride
            offset = jax.random.randint(k_idx, (batch,), 0, stride)
            indices = (base + offset) % buffer.size
        starts = buffer.samples[indices]

        if self.new_sample_ratio > 0.0:
            n_new = max(1, int(batch * self.new_sample_ratio))
            noise_idx = jax.random.permutation(k_perm, batch)[:n_new]
            noise = 0.01 * jax.random.normal(k_noise, (n_new, *x.shape[1:]), x.dtype)
            starts = starts.at[noise_idx].add(noise)
        return starts

    # --------------------------------------------------------------- call

    def __call__(
        self,
        params: Any,
        x: Array,
        key: Array,
        buffer: Optional[ReplayBuffer] = None,
        *,
        model_kwargs: Optional[Dict[str, Any]] = None,
    ):
        """Returns ``(loss, (negatives, new_buffer))``.

        ``new_buffer`` is ``None`` for non-persistent CD. Differentiable w.r.t.
        ``params`` (negatives are stop-gradient, exactly the CD estimator).
        """
        mk = model_kwargs or {}
        model = self._model(params)
        # Negatives are stop-gradient (the CD estimator), so cut tangents at
        # the chain's INPUT, not just its output: the whole k-step MCMC then
        # traces tangent-free under value_and_grad (no wasted JVP bookkeeping,
        # and kernel fast paths without autodiff rules stay usable).
        sampler = self.sampler.replace(
            model=inject_params(self.sampler.model, jax.lax.stop_gradient(params))
        )

        k_start, k_chain, k_real = jax.random.split(key, 3)
        starts = self._start_points(x, buffer, k_start)
        negatives = jax.lax.stop_gradient(
            sampler.sample(k_chain, x=starts, n_steps=self.k_steps, model_kwargs=mk)
        )

        new_buffer = buffer.push(negatives) if (self.persistent and buffer is not None) else None

        if self.add_noise_to_real:
            x_in = x + self.noise_scale * jax.random.normal(k_real, x.shape, x.dtype)
        else:
            x_in = x
        x_energy = model.energy(x_in, **mk)
        neg_energy = model.energy(negatives, **mk)

        loss = jnp.mean(x_energy) - jnp.mean(neg_energy)
        if self.energy_reg_weight > 0:
            loss = loss + self.energy_reg_weight * (
                jnp.mean(x_energy**2) + jnp.mean(neg_energy**2)
            )
        # Sync-free non-finite guard (reference contrastive_divergence.py:217-221)
        loss = jnp.where(jnp.isfinite(loss), loss, jnp.asarray(0.1, loss.dtype))
        return loss, (negatives, new_buffer)


def PersistentContrastiveDivergence(*args, **kwargs) -> ContrastiveDivergence:
    """PCD is delivered as ``ContrastiveDivergence(persistent=True)``.

    The reference ships a constructor-only stub class
    (``contrastive_divergence.py:226-244``); here the factory wires the real
    thing.
    """
    kwargs.setdefault("persistent", True)
    return ContrastiveDivergence(*args, **kwargs)


@struct.dataclass
class ParallelTemperingCD(BaseLoss):
    r"""CD with replica-exchange (parallel-tempered) Langevin negatives.

    The reference ships only a constructor stub for this
    (``contrastive_divergence.py:246-263``: an aspiration sketch that Gibbs-steps
    per-temperature chains in a host loop and swaps one random pair per sweep).
    This is a full implementation around
    :class:`~torchebm_tpu.samplers.ParallelTemperingLangevin`: negatives come
    from the **cold** chain of a replica ladder whose hot chains cross energy
    barriers plain Langevin negatives get stuck behind — the standard fix for
    CD on multimodal energies.

    Call convention matches :class:`ContrastiveDivergence`::

        ptcd = ParallelTemperingCD(model=e, sampler=ParallelTemperingLangevin(e, ...))
        loss, (negatives, new_buffer) = ptcd(params, x, key, buffer)

    With ``persistent=True`` the replay buffer keeps the **entire ladder**
    alive per slot (``(buffer_size, n_replicas, *data_shape)``) so every
    temperature's chain persists across training steps; create it with
    :meth:`init_buffer`. Non-persistent CD tiles the data batch across
    replicas as the start state (the stub's ``chains = [x_pos] * len(temps)``).
    """

    model: Energy = None
    sampler: Any = None  # ParallelTemperingLangevin
    k_steps: int = struct.field(pytree_node=False, default=10)
    persistent: bool = struct.field(pytree_node=False, default=False)
    buffer_size: int = struct.field(pytree_node=False, default=10_000)
    init_steps: int = struct.field(pytree_node=False, default=100)
    new_sample_ratio: float = struct.field(pytree_node=False, default=0.05)
    energy_reg_weight: float = struct.field(pytree_node=False, default=0.001)
    add_noise_to_real: bool = struct.field(pytree_node=False, default=False)
    noise_scale: float = struct.field(pytree_node=False, default=1e-4)

    def __post_init__(self):
        from ..samplers.parallel_tempering import ParallelTemperingLangevin

        if self.sampler is not None and not isinstance(
            self.sampler, ParallelTemperingLangevin
        ):
            raise TypeError(
                "ParallelTemperingCD needs a ParallelTemperingLangevin sampler; "
                f"got {type(self.sampler).__name__}. For single-temperature "
                "negatives use ContrastiveDivergence."
            )

    # ------------------------------------------------------------- buffer

    def init_buffer(
        self,
        key: Array,
        data_shape: Tuple[int, ...],
        chunk_size: int = 1024,
        init_noise_scale: float = 0.01,
        params: Any = None,
    ) -> ReplayBuffer:
        """Noise-init a ``(buffer_size, n_replicas, *data_shape)`` ladder
        buffer, then (optionally) warm it up with chunked replica-exchange MCMC
        outside jit (one-time cost, like :meth:`ContrastiveDivergence.init_buffer`)."""
        if not self.persistent:
            raise ValueError("init_buffer is only meaningful for persistent=True")
        if self.buffer_size <= 0:
            raise ValueError(f"Replay buffer size must be positive, got {self.buffer_size}")
        n_rep = self.sampler.n_replicas
        k_noise, k_warm = jax.random.split(key)
        samples = (
            jax.random.normal(
                k_noise, (self.buffer_size, n_rep, *data_shape), jnp.float32
            )
            * init_noise_scale
        )
        if self.init_steps > 0:
            sampler = self.sampler.replace(model=inject_params(self.sampler.model, params))
            chunk = min(self.buffer_size, chunk_size)
            updated = []
            for i in range(0, self.buffer_size, chunk):
                ladder = jnp.moveaxis(samples[i : i + chunk], 0, 1)  # (R, b, *ds)
                ladder, _ = sampler.run_replicas(
                    jax.random.fold_in(k_warm, i), ladder, self.init_steps
                )
                updated.append(jnp.moveaxis(ladder, 0, 1))
            samples = jnp.concatenate(updated, axis=0)
        return ReplayBuffer(samples=samples, ptr=jnp.int32(0))

    def _start_ladder(
        self, x: Array, buffer: Optional[ReplayBuffer], key: Array
    ) -> Array:
        """Start ladder ``(n_replicas, B, *data_shape)``: tiled data (CD) or
        stratified buffer draws + exploration noise (PCD)."""
        n_rep = self.sampler.n_replicas
        if not self.persistent:
            x = jax.lax.stop_gradient(x)
            return jnp.broadcast_to(x[None], (n_rep,) + x.shape)
        if buffer is None:
            raise ValueError(
                "persistent=True requires a ReplayBuffer state; create one with "
                "ptcd.init_buffer(key, data_shape) and thread it through calls."
            )
        batch = x.shape[0]
        k_idx, k_perm, k_noise = jax.random.split(key, 3)
        if buffer.size < batch:
            indices = jax.random.randint(k_idx, (batch,), 0, buffer.size)
        else:
            stride = buffer.size // batch
            base = jnp.arange(batch) * stride
            offset = jax.random.randint(k_idx, (batch,), 0, stride)
            indices = (base + offset) % buffer.size
        starts = jnp.moveaxis(buffer.samples[indices], 0, 1)  # (R, B, *ds)

        if self.new_sample_ratio > 0.0:
            n_new = max(1, int(batch * self.new_sample_ratio))
            noise_idx = jax.random.permutation(k_perm, batch)[:n_new]
            noise = 0.01 * jax.random.normal(
                k_noise, (self.sampler.n_replicas, n_new, *x.shape[1:]), x.dtype
            )
            starts = starts.at[:, noise_idx].add(noise)
        return starts

    # --------------------------------------------------------------- call

    def __call__(
        self,
        params: Any,
        x: Array,
        key: Array,
        buffer: Optional[ReplayBuffer] = None,
        *,
        model_kwargs: Optional[Dict[str, Any]] = None,
    ):
        """Returns ``(loss, (negatives, new_buffer))`` — negatives are the cold
        chain; ``new_buffer`` is ``None`` for non-persistent CD."""
        mk = model_kwargs or {}
        model = self._model(params)
        sampler = self.sampler.replace(model=inject_params(self.sampler.model, params))

        k_start, k_chain, k_real = jax.random.split(key, 3)
        starts = self._start_ladder(x, buffer, k_start)
        ladder, _ = sampler.run_replicas(
            k_chain, starts, self.k_steps, model_kwargs=mk
        )
        ladder = jax.lax.stop_gradient(ladder)
        negatives = ladder[0]

        new_buffer = (
            buffer.push(jnp.moveaxis(ladder, 0, 1))
            if (self.persistent and buffer is not None)
            else None
        )

        if self.add_noise_to_real:
            x_in = x + self.noise_scale * jax.random.normal(k_real, x.shape, x.dtype)
        else:
            x_in = x
        x_energy = model.energy(x_in, **mk)
        neg_energy = model.energy(negatives, **mk)

        loss = jnp.mean(x_energy) - jnp.mean(neg_energy)
        if self.energy_reg_weight > 0:
            loss = loss + self.energy_reg_weight * (
                jnp.mean(x_energy**2) + jnp.mean(neg_energy**2)
            )
        loss = jnp.where(jnp.isfinite(loss), loss, jnp.asarray(0.1, loss.dtype))
        return loss, (negatives, new_buffer)
