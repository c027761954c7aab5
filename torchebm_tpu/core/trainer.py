r"""Generic training loop + CD trainer.

Reference: ``torchebm/core/base_trainer.py:18-466``. JAX re-design:

- The mutable trainer state (params, optimizer state, EMA, step, loss state
  like the PCD replay buffer, PRNG key) is one explicit :class:`TrainState`
  pytree; the jitted ``train_step`` is a pure function ``(state, batch) ->
  (state, metrics)`` with the state donated — the functional analogue of the
  reference's ``optimizer.step()`` mutation.
- Gradient accumulation uses ``optax.MultiSteps`` (the reference hand-rolls
  ``loss/accum`` scaling, ``base_trainer.py:150-197``); AMP GradScaler has no
  analogue — bf16 keeps f32's exponent range and needs no loss scaling.
- Metrics stay device-resident per step and are reduced once per epoch
  (reference: "no ``.item()`` in the step", ``base_trainer.py:196-241``).
- Callback hooks mirror the reference: ``on_train_start/end``,
  ``on_epoch_start/end``, ``on_batch_start/end``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import logging

import jax
import jax.numpy as jnp
import optax
from . import struct

from ..losses.base import BaseLoss
from ..losses.contrastive_divergence import ContrastiveDivergence, ReplayBuffer
from ..utils.training import (
    latest_checkpoint_step,
    load_checkpoint,
    save_checkpoint,
    update_ema,
)

Array = jax.Array

__all__ = ["TrainState", "BaseTrainer", "ContrastiveDivergenceTrainer"]

logger = logging.getLogger(__name__)


@struct.dataclass
class TrainState:
    """Everything a training run needs to resume, as one pytree."""

    params: Any
    opt_state: Any
    step: Array  # int32
    key: Array
    ema_params: Any = None
    loss_state: Any = None  # e.g. PCD ReplayBuffer


def _split_batch(batch) -> Tuple[Array, Dict[str, Any]]:
    """Accepts ``x`` / ``(x, cond_dict)`` / ``{"data": x, ...cond}`` batches
    (reference ``base_trainer.py:115-148``)."""
    if isinstance(batch, dict):
        if "data" not in batch:
            raise ValueError("Dict batches must contain a 'data' key.")
        cond = {k: v for k, v in batch.items() if k != "data"}
        return batch["data"], cond
    if isinstance(batch, (tuple, list)):
        if len(batch) != 2 or not isinstance(batch[1], dict):
            raise ValueError("Tuple batches must be (data, cond_dict).")
        return batch[0], dict(batch[1])
    return batch, {}


class BaseTrainer:
    """Generic loop around a ``loss(params, x, key, [state], model_kwargs=...)``.

    Args:
        loss_fn: A :class:`~torchebm_tpu.losses.base.BaseLoss` (stateful losses
            like PCD return ``(loss, (aux, new_state))``) or any callable with
            the same signature.
        optimizer: An optax ``GradientTransformation``.
        ema_decay: Enable an EMA copy of the params when set.
        grad_accum_steps: Wraps the optimizer in ``optax.MultiSteps``.
        callbacks: Objects with any of ``on_{train,epoch,batch}_{start,end}``.
    """

    def __init__(
        self,
        loss_fn: Any,
        optimizer: optax.GradientTransformation,
        *,
        ema_decay: Optional[float] = None,
        grad_accum_steps: int = 1,
        callbacks: Iterable[Any] = (),
        stateful_loss: Optional[bool] = None,
    ):
        if grad_accum_steps < 1:
            raise ValueError("grad_accum_steps must be >= 1")
        self.loss_fn = loss_fn
        if grad_accum_steps > 1:
            optimizer = optax.MultiSteps(optimizer, every_k_schedule=grad_accum_steps)
        self.optimizer = optimizer
        self.ema_decay = ema_decay
        self.callbacks = list(callbacks)
        if stateful_loss is None:
            stateful_loss = isinstance(loss_fn, ContrastiveDivergence)
        self.stateful_loss = stateful_loss
        self._jitted_step = jax.jit(
            self._train_step, donate_argnums=(0,), static_argnums=(2,)
        )
        self._jitted_epoch = jax.jit(
            self._scan_epoch, donate_argnums=(0,), static_argnums=(2,)
        )

    # ------------------------------------------------------------------

    def init_state(self, params: Any, key: Array, loss_state: Any = None) -> TrainState:
        # Copy all inputs: train_step donates the state, and donating buffers
        # that alias arrays the caller still holds would delete them under the
        # caller's feet.
        copy = lambda tree: jax.tree_util.tree_map(jnp.array, tree)
        params = copy(params)
        return TrainState(
            params=params,
            opt_state=self.optimizer.init(params),
            step=jnp.int32(0),
            key=jnp.array(key),
            ema_params=copy(params) if self.ema_decay is not None else None,
            loss_state=copy(loss_state) if loss_state is not None else None,
        )

    def compute_metrics(self, loss: Array, aux: Any, params: Any, x: Array, mk) -> Dict[str, Array]:
        return {"loss": loss}

    @staticmethod
    def _param_shardings(params: Any) -> Optional[tuple]:
        """Hashable per-leaf ``NamedSharding`` tuple for ``params`` (leaf
        order), or None when nothing is mesh-sharded. Passed as a STATIC arg
        into the jitted step so the optimizer update cannot silently
        reshard/replicate fsdp-sharded parameters (XLA is free to pick output
        shardings unless constrained)."""
        from jax.sharding import NamedSharding

        leaves = jax.tree_util.tree_leaves(params)
        shardings = tuple(
            s if isinstance(s := getattr(a, "sharding", None), NamedSharding) else None
            for a in leaves
        )
        return shardings if any(s is not None for s in shardings) else None

    @staticmethod
    def _constrain(params: Any, shardings: Optional[tuple]) -> Any:
        if shardings is None:
            return params
        leaves, treedef = jax.tree_util.tree_flatten(params)
        return jax.tree_util.tree_unflatten(
            treedef,
            [
                jax.lax.with_sharding_constraint(l, s) if s is not None else l
                for l, s in zip(leaves, shardings)
            ],
        )

    def _train_step(
        self, state: TrainState, batch, shardings: Optional[tuple] = None
    ) -> Tuple[TrainState, Dict[str, Array]]:
        x, mk = _split_batch(batch)
        key, sub = jax.random.split(state.key)

        if self.stateful_loss:
            def lossf(p):
                loss, (aux, new_ls) = self.loss_fn(p, x, sub, state.loss_state, model_kwargs=mk)
                return loss, (aux, new_ls)

            (loss, (aux, new_loss_state)), grads = jax.value_and_grad(lossf, has_aux=True)(state.params)
        else:
            def lossf(p):
                return self.loss_fn(p, x, sub, model_kwargs=mk)

            loss, grads = jax.value_and_grad(lossf)(state.params)
            aux, new_loss_state = None, state.loss_state

        updates, opt_state = self.optimizer.update(grads, state.opt_state, state.params)
        params = self._constrain(optax.apply_updates(state.params, updates), shardings)
        ema = (
            self._constrain(
                update_ema(state.ema_params, params, self.ema_decay), shardings
            )
            if self.ema_decay is not None
            else None
        )
        metrics = self.compute_metrics(loss, aux, params, x, mk)
        new_state = TrainState(
            params=params,
            opt_state=opt_state,
            step=state.step + 1,
            key=key,
            ema_params=ema,
            loss_state=new_loss_state,
        )
        return new_state, metrics

    def train_step(self, state: TrainState, batch) -> Tuple[TrainState, Dict[str, Array]]:
        """One jitted, state-donating optimization step.

        Mesh-sharded parameters (e.g. :func:`~torchebm_tpu.parallel.fsdp_shard_params`)
        keep their shardings through the update — the input state's per-leaf
        ``NamedSharding``\\ s are read eagerly and pinned inside the step with
        ``with_sharding_constraint``.
        """
        return self._jitted_step(state, batch, self._param_shardings(state.params))

    # ------------------------------------------------------------------

    def _fire(self, hook: str, *args):
        for cb in self.callbacks:
            fn = getattr(cb, hook, None)
            if fn is not None:
                fn(self, *args)

    def train_epoch(self, state: TrainState, batches: Iterable[Any]) -> Tuple[TrainState, Dict[str, float]]:
        """One pass over ``batches``; returns host-side mean metrics (one sync)."""
        self._fire("on_epoch_start", state)
        accum: Dict[str, list] = {}
        for batch in batches:
            self._fire("on_batch_start", state, batch)
            state, metrics = self.train_step(state, batch)
            for k, v in metrics.items():
                accum.setdefault(k, []).append(v)
            self._fire("on_batch_end", state, metrics)
        # single host transfer per epoch (reference keeps metrics device-resident)
        reduced = {
            k: float(jnp.mean(jnp.stack(v))) for k, v in accum.items() if v
        }
        logger.info("epoch done (step=%d): %s", int(state.step), reduced)
        self._fire("on_epoch_end", state, reduced)
        return state, reduced

    def _scan_epoch(self, state: TrainState, batches, shardings: Optional[tuple] = None):
        def body(st, batch):
            return self._train_step(st, batch, shardings)

        state, metrics = jax.lax.scan(body, state, batches)
        return state, {k: jnp.mean(v) for k, v in metrics.items()}

    def train_epoch_scanned(
        self, state: TrainState, batches
    ) -> Tuple[TrainState, Dict[str, float]]:
        """One pass over a STACKED epoch of batches as ONE compiled program.

        ``batches`` is a pytree whose leaves carry a leading steps axis —
        ``x`` of shape ``(n_steps, batch, *event)``, or the ``(data, cond)``
        / dict batch forms with every leaf stacked the same way (e.g.
        ``data[: n * b].reshape(n, b, -1)``). The train step runs under
        ``lax.scan``, so the whole epoch costs one dispatch instead of one
        per step, which matters when a step is as short as the host's
        per-call dispatch. Semantics match :meth:`train_epoch` with
        the same batches exactly (same key sequence, same metrics); the
        difference is that per-batch callbacks cannot fire (no host control
        between steps) — epoch-level hooks still do.
        """
        self._fire("on_epoch_start", state)
        state, reduced_dev = self._jitted_epoch(
            state, batches, self._param_shardings(state.params)
        )
        reduced = {k: float(v) for k, v in reduced_dev.items()}
        logger.info("epoch done (step=%d): %s", int(state.step), reduced)
        self._fire("on_epoch_end", state, reduced)
        return state, reduced

    def train(
        self,
        state: TrainState,
        epochs: int,
        batch_iter_fn: Callable[[int], Iterable[Any]],
        *,
        ckpt_dir: Optional[str] = None,
        ckpt_every_epochs: int = 1,
    ) -> Tuple[TrainState, list]:
        """Multi-epoch driver: ``batch_iter_fn(epoch)`` yields an epoch's batches.

        With ``ckpt_dir`` set, a step-numbered checkpoint is written every
        ``ckpt_every_epochs`` epochs (and after the final one); resume with
        :meth:`restore` (reference ``base_trainer.py:199-350``).
        """
        self._fire("on_train_start", state)
        history = []
        for epoch in range(epochs):
            state, metrics = self.train_epoch(state, batch_iter_fn(epoch))
            history.append(metrics)
            if ckpt_dir is not None and (
                (epoch + 1) % max(ckpt_every_epochs, 1) == 0 or epoch == epochs - 1
            ):
                self.save(state, ckpt_dir)
        self._fire("on_train_end", state, history)
        return state, history

    # ------------------------------------------------------- checkpointing

    def save(self, state: TrainState, ckpt_dir: str) -> str:
        """Write the full :class:`TrainState` (params / optimizer / EMA / step /
        PRNG key / loss state, e.g. the PCD replay buffer) as a step-numbered
        Orbax checkpoint. Reference ``base_trainer.py:312-331``.

        When the params are mesh-sharded, scalar leaves (step counter, PRNG
        key) are first replicated onto the mesh — in a multi-process run
        Orbax refuses to serialize host-local single-device arrays, and a
        mesh-replicated scalar is the globally-consistent form anyway."""
        state = self._align_state_mesh(state)
        return save_checkpoint(
            ckpt_dir,
            int(state.step),
            state.params,
            ema_params=state.ema_params,
            opt_state=state.opt_state,
            extra={"key": state.key, "loss_state": state.loss_state},
        )

    def restore(
        self,
        ckpt_dir: str,
        template: TrainState,
        step: Optional[int] = None,
    ) -> TrainState:
        """Load a checkpoint back into a :class:`TrainState`.

        ``template`` supplies the pytree structure (struct dataclasses,
        optax named-tuples) the stored arrays are poured into — pass the state
        from :meth:`init_state` (or any same-shaped state). ``step=None``
        restores the latest checkpoint. Reference ``base_trainer.py:333-350``.
        """
        payload_t = {
            "step": 0,
            "params": template.params,
            "opt_state": template.opt_state,
            "extra": {"key": template.key, "loss_state": template.loss_state},
        }
        if template.ema_params is not None:
            payload_t["ema_params"] = template.ema_params
        payload = load_checkpoint(ckpt_dir, step, template=payload_t)
        state = TrainState(
            params=payload["params"],
            opt_state=payload["opt_state"],
            step=jnp.int32(payload["step"]),
            key=payload["extra"]["key"],
            ema_params=payload.get("ema_params"),
            loss_state=payload["extra"]["loss_state"],
        )
        return self._align_state_mesh(state)

    @staticmethod
    def _align_state_mesh(state: TrainState) -> TrainState:
        """Replicate non-mesh leaves onto the params' mesh after a restore.

        Orbax commits every restored array to its template sharding; scalar
        leaves restored without one (step counter, PRNG key) land on a single
        device, and a jitted step then rejects the mixed device sets. When the
        params are mesh-sharded, every leaf without a ``NamedSharding`` is
        replicated onto that mesh so the restored state is steppable as-is.
        """
        from jax.sharding import NamedSharding, PartitionSpec

        mesh = next(
            (
                s.mesh
                for leaf in jax.tree_util.tree_leaves(state.params)
                if isinstance(s := getattr(leaf, "sharding", None), NamedSharding)
            ),
            None,
        )
        if mesh is None:
            return state
        rep = NamedSharding(mesh, PartitionSpec())

        def fix(leaf):
            if isinstance(leaf, jax.Array) and not isinstance(
                leaf.sharding, NamedSharding
            ):
                if jax.process_count() > 1:
                    # multi-controller: device_put cannot cross hosts; build
                    # the replicated global array from the (identical)
                    # host-local value instead
                    import numpy as np
                    from jax.experimental import multihost_utils

                    return multihost_utils.host_local_array_to_global_array(
                        np.asarray(leaf), mesh, PartitionSpec()
                    )
                return jax.device_put(leaf, rep)
            return leaf

        return jax.tree_util.tree_map(fix, state)

    def restore_or_init(
        self,
        ckpt_dir: str,
        params: Any,
        key: Array,
        loss_state: Any = None,
    ) -> TrainState:
        """Resume from the latest checkpoint under ``ckpt_dir`` if one exists,
        else build a fresh state — the standard preemption-safe entry point."""
        template = self.init_state(params, key, loss_state)
        if latest_checkpoint_step(ckpt_dir) is None:
            return template
        return self.restore(ckpt_dir, template)


class ContrastiveDivergenceTrainer(BaseTrainer):
    """CD/PCD convenience trainer (reference ``base_trainer.py:353-466``).

    Builds the optimizer (Adam by default) around a
    :class:`~torchebm_tpu.losses.ContrastiveDivergence` loss and logs
    positive/negative energies alongside the loss.
    """

    def __init__(
        self,
        cd_loss: ContrastiveDivergence,
        learning_rate: float = 1e-3,
        optimizer: Optional[optax.GradientTransformation] = None,
        **kwargs,
    ):
        super().__init__(
            cd_loss,
            optimizer if optimizer is not None else optax.adam(learning_rate),
            stateful_loss=True,
            **kwargs,
        )

    def init_state(self, params, key, loss_state=None) -> TrainState:
        if loss_state is None and self.loss_fn.persistent:
            raise ValueError(
                "Persistent CD needs a ReplayBuffer: pass "
                "loss_state=cd.init_buffer(key, data_shape)."
            )
        return super().init_state(params, key, loss_state)

    def compute_metrics(self, loss, aux, params, x, mk):
        negatives = aux
        model = self.loss_fn._model(params)
        return {
            "loss": loss,
            "pos_energy": jnp.mean(model.energy(x, **(mk or {}))),
            "neg_energy": jnp.mean(model.energy(negatives, **(mk or {}))),
        }
