"""Device-mesh construction: the Horovod/NCCL/MPI replacement.

The reference launches N ranks with ``mpirun`` over SLURM and communicates
via Horovod/NCCL (``dlmodels/color-information/run.sh:20-63``,
``train_img_horo.py:148-173,406-454``). In JAX this is all mesh +
collectives: ``jax.distributed.initialize()`` for multi-host bootstrap
(one process per host, seeing all of that host's GPUs) and a
``jax.sharding.Mesh`` whose axes follow the algorithm alone. The GPUs of one
host are joined all to all by NVLink, so no device order within a host is
faster than another; XLA lowers the collectives to NCCL (SURVEY.md
section 2.5).
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           auto: bool = False) -> None:
    """Multi-host bootstrap (replaces ``hvd.init()``/mpirun env wiring).

    No-op when called with no arguments on a single host. Pass coordinator
    address + process topology explicitly (``localhost:<port>`` for
    several processes on one host), or ``auto=True`` under a cluster
    manager that ``jax.distributed.initialize()`` can read the topology
    from (any partial argument set is forwarded as given).
    """
    explicit = (coordinator_address is not None or process_id is not None
                or (num_processes is not None and num_processes > 1))
    if auto or explicit:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )


def make_mesh(n_devices: Optional[int] = None, **axis_sizes: int) -> Mesh:
    """Build a named mesh over the first ``n_devices`` devices.

    ``axis_sizes`` are ordered and laid over ``jax.devices()`` in that
    order; across hosts put the cross-host axis FIRST, so that it is the
    one that leaves the host's NVLink domain. Example:
    ``make_mesh(8, data=2, tiles=4)``.
    Default: one 'data' axis spanning everything — the reference's pure
    data-parallel Horovod layout.
    """
    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    if not axis_sizes:
        axis_sizes = {"data": n_devices}
    sizes = list(axis_sizes.values())
    if int(np.prod(sizes)) != n_devices:
        raise ValueError(
            f"mesh axis sizes {axis_sizes} require "
            f"{int(np.prod(sizes))} devices but n_devices={n_devices}"
        )
    if len(devices) < n_devices:
        raise RuntimeError(
            f"need {n_devices} devices but the {devices[0].platform} "
            f"backend exposes only {len(devices)}; for a simulated mesh "
            "set XLA_FLAGS=--xla_force_host_platform_device_count=N and "
            'jax.config.update("jax_platforms", "cpu") before first use'
        )
    dev_array = np.asarray(devices[:n_devices]).reshape(sizes)
    return Mesh(dev_array, tuple(axis_sizes.keys()))


def local_data_shard(global_count: int, process_index: Optional[int] = None,
                     process_count: Optional[int] = None):
    """Per-host shard bounds for dataset partitioning.

    Mirrors the reference sampler's per-rank split
    (``data_utils.py:1``: ``test_per_worker = testims // hvd.size()`` etc.):
    contiguous, equal shards, remainder dropped — deterministic across hosts.
    """
    pi = jax.process_index() if process_index is None else process_index
    pc = jax.process_count() if process_count is None else process_count
    per = global_count // pc
    return pi * per, (pi + 1) * per
