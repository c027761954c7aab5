"""Two-process jax.distributed spawn harness (CPU backend).

The JAX analogue of the reference's gloo-on-CPU harness
(``tests/distributed/dist_harness.py:1-103``): children run
``jax.distributed.initialize`` against a localhost coordinator, each with 2
virtual CPU devices, execute a payload function, and report results back via
per-rank JSON files. Faulthandler tracebacks surface on timeout/crash.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import textwrap

NPROC = 2
DEVICES_PER_PROC = 2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


_CHILD_TEMPLATE = """
import faulthandler, json, os, sys
faulthandler.enable()
sys.path.insert(0, {repo!r})

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count={devs}"
)
import jax
jax.config.update("jax_platforms", "cpu")
if {env_init!r}:
    # launcher-style env config; the library's init_distributed() picks it up
    os.environ["JAX_COORDINATOR_ADDRESS"] = {coord!r}
    os.environ["JAX_NUM_PROCESSES"] = str({nproc})
    os.environ["JAX_PROCESS_ID"] = str({rank})
    from torchebm_tpu.parallel import init_distributed
    rank, world = init_distributed()
    assert (rank, world) == ({rank}, {nproc}), (rank, world)
else:
    jax.distributed.initialize(
        coordinator_address={coord!r},
        num_processes={nproc},
        process_id={rank},
    )

{payload_src}

result = payload()
with open({out!r}, "w") as f:
    json.dump(result, f)
"""


def run_two_process(payload_src: str, timeout: int = 180, env_init: bool = False):
    """Spawn NPROC children executing ``payload()`` (defined by payload_src).

    ``payload()`` must return a JSON-serializable dict. Returns the per-rank
    result list ``[rank0, rank1]``. With ``env_init=True`` children configure
    the cluster via ``JAX_COORDINATOR_ADDRESS``/``JAX_NUM_PROCESSES``/
    ``JAX_PROCESS_ID`` env vars and go through the library's
    ``init_distributed()`` instead of calling ``jax.distributed.initialize``
    directly — the real multi-host launch path.
    """
    repo = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
    coord = f"localhost:{_free_port()}"
    with tempfile.TemporaryDirectory() as tmp:
        procs, outs = [], []
        for rank in range(NPROC):
            out = os.path.join(tmp, f"rank{rank}.json")
            outs.append(out)
            script = _CHILD_TEMPLATE.format(
                repo=repo,
                devs=DEVICES_PER_PROC,
                coord=coord,
                nproc=NPROC,
                rank=rank,
                env_init=env_init,
                payload_src=textwrap.dedent(payload_src),
                out=out,
            )
            env = dict(os.environ)
            env.pop("JAX_PLATFORMS", None)
            procs.append(
                subprocess.Popen(
                    [sys.executable, "-c", script],
                    stdout=subprocess.PIPE,
                    stderr=subprocess.PIPE,
                    text=True,
                    env=env,
                )
            )
        results = []
        errors = []
        for rank, p in enumerate(procs):
            try:
                stdout, stderr = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                raise RuntimeError(f"rank {rank} timed out after {timeout}s")
            if p.returncode != 0:
                errors.append(f"rank {rank} rc={p.returncode}\n{stdout}\n{stderr}")
                continue
            with open(outs[rank]) as f:
                results.append(json.load(f))
        if errors:
            raise RuntimeError("\n----\n".join(errors))
        return results
