"""Device-mesh helpers.

The reference's only parallelism is TBB threads on one host (SURVEY §2.5);
all multi-device structure here is new design.  Axis conventions:

- ``data``: the n-point axis of the spectral stage (kNN/LAE/Z rows, the
  (n, K) eigenvector store).  The analogue of sequence parallelism for this
  workload — n is the scaling axis.
- ``chain``: MCMC chains / SMC particles for the inference stack.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Multi-host runtime bootstrap (SURVEY §5 'distributed backend').

    Wires ``jax.distributed.initialize`` from explicit arguments or the
    environment (``FLGP_COORDINATOR``/``FLGP_NUM_PROCESSES``/
    ``FLGP_PROCESS_ID``); nothing is autodetected, so a multi-process run
    names its coordinator (e.g. ``localhost:<port>``), process count and
    process id.  Idempotent: returns False when no multi-process
    configuration is present (single-process mode), True once the global
    runtime is up.  After a True return ``jax.devices()`` spans every
    process and :func:`global_mesh` builds meshes over all of them.
    """
    coordinator_address = coordinator_address or os.environ.get("FLGP_COORDINATOR")
    if num_processes is None and "FLGP_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["FLGP_NUM_PROCESSES"])
    if process_id is None and "FLGP_PROCESS_ID" in os.environ:
        process_id = int(os.environ["FLGP_PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        return False
    # idempotence probe that does NOT touch the XLA backend (jax.process_count
    # would initialize it, after which jax.distributed.initialize refuses)
    if jax.distributed.is_initialized():
        return True
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def global_mesh(
    axis_names: Sequence[str] = ("data",),
    shape: Optional[Sequence[int]] = None,
) -> Mesh:
    """Mesh over ALL devices (every process's) in ``jax.devices()`` order,
    which groups each process's devices together.  No topology is assumed:
    the cards of one host are joined all to all, so the mesh follows the
    algorithm alone."""
    devices = jax.devices()
    if shape is None:
        shape = (len(devices),) + (1,) * (len(axis_names) - 1)
    return Mesh(np.asarray(devices).reshape(tuple(shape)), tuple(axis_names))


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Sequence[str] = ("data",),
    shape: Optional[Sequence[int]] = None,
) -> Mesh:
    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    devices = devices[:n_devices]
    if shape is None:
        shape = (n_devices,) + (1,) * (len(axis_names) - 1)
    return Mesh(np.asarray(devices).reshape(shape), axis_names)


def shard_rows(mesh: Mesh, x: jax.Array, axis: str = "data") -> jax.Array:
    """Place a row-major array with its leading axis sharded over ``axis``."""
    spec = P(axis, *([None] * (x.ndim - 1)))
    return jax.device_put(x, NamedSharding(mesh, spec))


def replicate(mesh: Mesh, x: jax.Array) -> jax.Array:
    return jax.device_put(x, NamedSharding(mesh, P()))


def pad_to_multiple(x, multiple: int, axis: int = 0):
    """Pad the leading axis to a device-count multiple; returns (padded, n)."""
    import jax.numpy as jnp

    n = x.shape[axis]
    pad = (-n) % multiple
    if pad == 0:
        return x, n
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return jnp.pad(x, widths), n
