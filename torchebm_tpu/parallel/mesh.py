r"""Device-mesh plumbing: construction, batch/param shardings, multi-host init.

JAX replacement for the reference's torch.distributed stance
(``torchebm/distributed.py:1-21`` + the FSDP2 functional path,
``core/base_loss.py:439-622``). The design rule carries over: *components
never require an initialized distributed context*; every helper degrades to a
single-device no-op. Collectives only enter where the math is batch-global
(OT cost matrices, pooled diagnostics, buffer shuffles) — and under
``jit`` + ``NamedSharding`` XLA inserts them automatically.

Canonical axes:

- ``"data"`` — chains/batch sharding (the fundamental strategy: MCMC chains
  are a batch dimension).
- ``"fsdp"`` — optional 1-D parameter sharding (the reference's FSDP2/DTensor
  analogue; 1-D meshes only there too, ``base_loss.py:507-511``).
"""

from __future__ import annotations

import math
import os
from typing import Any, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

Array = jax.Array

__all__ = [
    "make_mesh",
    "batch_sharding",
    "replicated_sharding",
    "shard_batch",
    "replicate",
    "fsdp_shard_params",
    "init_distributed",
    "local_shard_bounds",
]


def make_mesh(
    axes: Sequence[str] = ("data",),
    shape: Optional[Sequence[int]] = None,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a mesh over all (or the given) devices.

    With ``shape=None`` all devices go to the first axis and the rest get 1.
    ``make_mesh(("data", "fsdp"), (4, 2))`` builds the standard 2-D
    chains×params layout.
    """
    devices = list(devices) if devices is not None else jax.devices()
    n = len(devices)
    if shape is None:
        shape = (n,) + (1,) * (len(axes) - 1)
    if math.prod(shape) != n:
        raise ValueError(f"Mesh shape {tuple(shape)} does not cover {n} devices.")
    dev_array = np.array(devices).reshape(tuple(shape))
    return Mesh(dev_array, tuple(axes))


def batch_sharding(mesh: Mesh, ndim: int, axis: str = "data") -> NamedSharding:
    """``NamedSharding`` that splits dim 0 over ``axis`` and replicates the rest."""
    return NamedSharding(mesh, P(axis, *([None] * (ndim - 1))))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(x: Any, mesh: Mesh, axis: str = "data") -> Any:
    """Place a batch pytree with dim-0 sharded over ``axis`` (chains-as-batch)."""
    return jax.tree_util.tree_map(
        lambda a: jax.device_put(a, batch_sharding(mesh, jnp.ndim(a), axis)), x
    )


def replicate(tree: Any, mesh: Mesh) -> Any:
    """Fully replicate a pytree over the mesh (the default for params)."""
    sharding = replicated_sharding(mesh)
    return jax.tree_util.tree_map(lambda a: jax.device_put(a, sharding), tree)


def fsdp_shard_params(params: Any, mesh: Mesh, axis: str = "fsdp", min_size: int = 2**14) -> Any:
    """1-D parameter sharding: split each large leaf's biggest divisible dim.

    The ``NamedSharding`` analogue of the reference's FSDP2 path (1-D meshes
    only). Leaves smaller than ``min_size`` elements, or with no dimension
    divisible by the axis size, stay replicated — XLA all-gathers sharded
    params where needed and the backward's summing reduce-scatter falls out of
    ``jax.grad`` automatically (no rescale trick required).
    """
    axis_size = mesh.shape[axis]

    def spec_for(a):
        if axis_size == 1 or jnp.size(a) < min_size:
            return P()
        dims = list(jnp.shape(a))
        order = sorted(range(len(dims)), key=lambda i: -dims[i])
        for i in order:
            if dims[i] % axis_size == 0:
                spec = [None] * len(dims)
                spec[i] = axis
                return P(*spec)
        return P()

    return jax.tree_util.tree_map(
        lambda a: jax.device_put(a, NamedSharding(mesh, spec_for(a))), params
    )


#: env vars whose presence marks a multi-host launch for auto-initialization.
#: JAX_* triples configure us explicitly; the rest are cluster schedulers
#: jax.distributed.initialize() itself knows how to auto-detect.
_EXPLICIT_ENV = ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID")
_AUTODETECT_ENV = (
    "COORDINATOR_ADDRESS",
    "SLURM_JOB_ID",
    "OMPI_COMM_WORLD_SIZE",
    "TORCHEBM_DISTRIBUTED",
)


def _distributed_client_active() -> bool:
    """Whether ``jax.distributed.initialize`` already ran in this process."""
    try:
        from jax._src import distributed as _jd

        return _jd.global_state.client is not None
    except Exception:  # private API moved: fall back to "not initialized"
        return False


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    **kwargs,
) -> Tuple[int, int]:
    """Initialize multi-host JAX (``jax.distributed``); no-op if single-process.

    Returns ``(process_index, process_count)``. Safe to call unconditionally —
    the reference's "helpers degrade to identity" rule
    (``torchebm/distributed.py:24-36``). Resolution order:

    1. already initialized → return current (rank, world);
    2. explicit kwargs (or the ``JAX_COORDINATOR_ADDRESS`` /
       ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID`` env triple) →
       ``jax.distributed.initialize(**explicit)``;
    3. a cluster environment is detected (Slurm/OpenMPI/``COORDINATOR_ADDRESS``
       or ``TORCHEBM_DISTRIBUTED=1``) → ``jax.distributed.initialize()`` with
       JAX's own auto-detection;
    4. otherwise: single-process, touch nothing.
    """
    if _distributed_client_active():
        return jax.process_index(), jax.process_count()

    env = os.environ
    if coordinator_address is None:
        coordinator_address = env.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None and env.get("JAX_NUM_PROCESSES"):
        num_processes = int(env["JAX_NUM_PROCESSES"])
    if process_id is None and env.get("JAX_PROCESS_ID"):
        process_id = int(env["JAX_PROCESS_ID"])
    explicit = {
        k: v
        for k, v in dict(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        ).items()
        if v is not None
    }
    explicit.update(kwargs)

    try:
        if explicit:
            jax.distributed.initialize(**explicit)
        elif any(env.get(v) for v in _AUTODETECT_ENV):
            jax.distributed.initialize()
    except RuntimeError:
        # Already initialized but _distributed_client_active() couldn't see it
        # (the private-API probe returned False after an upstream move):
        # degrade to reporting the live (rank, world) instead of crashing.
        pass
    return jax.process_index(), jax.process_count()


def local_shard_bounds(global_batch: int, process_index: Optional[int] = None) -> Tuple[int, int]:
    """``[start, end)`` rows of a global batch owned by this host (even split)."""
    pi = jax.process_index() if process_index is None else process_index
    pc = jax.process_count()
    if global_batch % pc != 0:
        raise ValueError(f"global batch {global_batch} not divisible by {pc} hosts")
    per = global_batch // pc
    return pi * per, (pi + 1) * per
