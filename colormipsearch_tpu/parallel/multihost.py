"""Multi-host (multi-process) execution setup.

The reference scales across machines with LSF job arrays + shared Mongo
state (SURVEY.md 2d P3/P5: submitCDSBatch.sh:10-36 static grid blocks;
no in-process communication layer). This framework keeps that
restartable block model (distributed.block_for_process + the CLI's
--process-id/--process-count offsets) AND adds the layer the reference
never had: a single jitted computation spanning hosts via
jax.distributed + a global device mesh, with XLA collectives instead of
Mongo round-trips.

Usage (one command per host/process, mirroring a job array):

    CMS_COORDINATOR=host0:8476 CMS_NUM_PROCESSES=4 CMS_PROCESS_ID=$i \\
        python -m colormipsearch_tpu colorDepthSearch ... --jax-distributed

maybe_init_distributed() is a no-op for single-process runs, so the
same CLI works standalone.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import numpy as np

LOG = logging.getLogger(__name__)

_initialized = False


def maybe_init_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> bool:
    """Initialize jax.distributed from args or CMS_* env vars.

    Returns True when a multi-process runtime is active. Safe to call
    repeatedly; single-process (or unset) configurations are a no-op.
    Env vars: CMS_COORDINATOR (host:port), CMS_NUM_PROCESSES,
    CMS_PROCESS_ID (mirroring LSB_JOBINDEX-style job-array variables,
    submitCDSJob.sh:58-66).
    """
    global _initialized
    if _initialized:
        return True
    coordinator = coordinator or os.environ.get("CMS_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("CMS_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("CMS_PROCESS_ID", "0"))
    if not coordinator or num_processes <= 1:
        return False
    import jax
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)
    _initialized = True
    LOG.info("jax.distributed: process %d/%d, %d local / %d global devices",
             process_id, num_processes, jax.local_device_count(),
             jax.device_count())
    return True


def global_pair_mesh(mask_shards: Optional[int] = None):
    """Global ("mask", "target") mesh over ALL processes' devices.

    With N global devices, defaults to the most-square factorization
    with target-major ordering (cross-target collectives ride the
    faster axis). Single-process callers get the same mesh over local
    devices — identical code path either way.
    """
    import jax
    from jax.sharding import Mesh

    devices = np.asarray(jax.devices())
    n = devices.size
    if mask_shards is None:
        mask_shards = 1
        for m in range(int(np.sqrt(n)), 0, -1):
            if n % m == 0:
                mask_shards = m
                break
    assert n % mask_shards == 0
    return Mesh(devices.reshape(mask_shards, n // mask_shards),
                ("mask", "target"))


def distribute(mesh, spec, arr):
    """Build a GLOBAL jax.Array sharded per `spec` from a full numpy
    array available on every process (each process materializes only
    its addressable shards). This is how pair-sweep inputs cross the
    process boundary — the reference instead re-reads inputs per job
    from the shared filesystem."""
    import jax
    from jax.sharding import NamedSharding

    sharding = NamedSharding(mesh, spec)
    arr = np.asarray(arr)
    return jax.make_array_from_callback(arr.shape, sharding,
                                        lambda idx: arr[idx])


def process_block(n_items: int) -> tuple:
    """This process's contiguous block of a work list (the job-array
    offset semantics, submitCDSBatch.sh:19-33) based on CMS_PROCESS_*
    env vars. Returns (start, stop)."""
    num = int(os.environ.get("CMS_NUM_PROCESSES", "1"))
    pid = int(os.environ.get("CMS_PROCESS_ID", "0"))
    per = -(-n_items // num)
    return min(pid * per, n_items), min((pid + 1) * per, n_items)
