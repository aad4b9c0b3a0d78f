"""Multi-host initialization and block assignment.

Accelerator-native replacement for the reference's cross-process coordination
(SURVEY.md §2d-P3/P5): instead of LSF job arrays indexing static
(maskBlock, targetBlock) offsets through shell arithmetic
(scripts/submitCDSBatch.sh:10-36), hosts join a jax.distributed
coordination service and derive their static block of the pair grid
from their process index — same restartable offset semantics, with XLA
collectives replacing MongoDB-mediated reductions.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Optional

LOG = logging.getLogger(__name__)


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """jax.distributed.initialize from args or CMS_COORDINATOR_ADDRESS.
    Safe no-op for single-process runs."""
    import jax
    coordinator_address = coordinator_address or os.environ.get(
        "CMS_COORDINATOR_ADDRESS")
    if coordinator_address is None and num_processes is None:
        # single process
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id)
    LOG.info("distributed initialized: process %d / %d",
             jax.process_index(), jax.process_count())


@dataclass
class PairBlock:
    """A static block of the mask x target grid owned by one process
    (the LSF JOB_INDEX -> (maskBlock, targetBlock) mapping,
    submitCDSJob.sh:58-66)."""
    mask_offset: int
    mask_length: int
    target_offset: int
    target_length: int


def block_for_process(n_masks: int, n_targets: int,
                      process_id: int, process_count: int,
                      jobs_for_masks: Optional[int] = None) -> PairBlock:
    """Deterministic block assignment; restartable per-process with the
    same offsets (resume = re-run the failed process id)."""
    if jobs_for_masks is None:
        # squarest split of processes over the grid
        jobs_for_masks = 1
        for m in range(1, int(process_count ** 0.5) + 1):
            if process_count % m == 0:
                jobs_for_masks = m
    jobs_for_targets = process_count // jobs_for_masks
    mi = process_id % jobs_for_masks
    ti = process_id // jobs_for_masks
    mask_len = -(-n_masks // jobs_for_masks)
    target_len = -(-n_targets // jobs_for_targets)
    return PairBlock(
        mask_offset=mi * mask_len,
        mask_length=min(mask_len, max(0, n_masks - mi * mask_len)),
        target_offset=ti * target_len,
        target_length=min(target_len, max(0, n_targets - ti * target_len)),
    )
