"""Multi-device production two-phase sweep (prescreen + active-tile kernel).

The reference runs the SAME scoring algorithm locally and on the Spark
cluster (cmd/cdsprocess/SparkColorMIPSearchProcessor.java:27-84 vs
LocalColorMIPSearchProcessor.java:38-122). This module gives the
production engine the same property across local devices: targets are
block-partitioned over the local devices, and each device independently
runs the full two-phase pipeline on its shard — pack words, prescreen
bounds, one active-tile kernel launch over the survivor list — placed
per device via jax.default_device. The pair grid needs NO cross-device
collectives (every (mask, target) score is independent); per-mask
reductions (normalization maxima, best-match selection) happen after
the drain, on host for local runs or via process_allgather for
multi-host runs.

Scaling layers compose exactly like the reference's:
  process grid (jax.distributed / CMS_PROCESS_*) x local device grid
  x per-device two-phase pipeline,
so a host with four GPUs runs four single-device pipelines that share
only the host-side partition loop and the result writer.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Sequence, Tuple

import numpy as np

LOG = logging.getLogger(__name__)


def device_blocks(n: int, n_devices: int) -> List[Tuple[int, int]]:
    """Balanced contiguous (offset, length) blocks of n items over
    n_devices devices (first n % n_devices blocks get one extra)."""
    base, extra = divmod(n, n_devices)
    blocks, off = [], 0
    for d in range(n_devices):
        ln = base + (1 if d < extra else 0)
        blocks.append((off, ln))
        off += ln
    return blocks


class TwoPhaseSweep:
    """Two-phase exact sweep over every local device.

    engines: one ActiveTilePixelEngine per mask (shared CDS params);
      their tiles form one table, uploaded once per device.
    screen/u_matrix/thresholds: optional prescreen — u_matrix is the
      stacked [B, F] query feature matrix (numpy; uploaded once per
      device), thresholds the per-mask keep thresholds in pixels.

    The per-device loop enqueues pack + screen + the kernel launch for
    one shard before moving to the next device, so all devices' exact
    phases run concurrently; only the [B, T_shard] bounds pull
    synchronizes with a device mid-loop.
    """

    def __init__(self, engines: Sequence, screen=None,
                 u_matrix: Optional[np.ndarray] = None,
                 thresholds: Optional[np.ndarray] = None,
                 devices: Optional[Sequence] = None):
        import jax
        from ..cds.active_tile import TileScorer
        self.engines = list(engines)
        self.screen = screen
        self.u_matrix = u_matrix
        self.thresholds = thresholds
        self.devices = list(devices) if devices is not None \
            else jax.local_devices()
        self.scorer = TileScorer(self.engines,
                                 interpret=self.engines[0].interpret)
        self._u_dev = {}

    def _u_for(self, device):
        import jax
        got = self._u_dev.get(device)
        if got is None:
            got = jax.device_put(self.u_matrix, device)
            self._u_dev[device] = got
        return got

    def launch(self, targets_u8: np.ndarray, stage=None):
        """Enqueue the full two-phase sweep of one target batch on all
        local devices. Returns an opaque handle for collect(); nothing
        blocks except the per-device bounds pull, so a partition-
        pipelined caller overlaps the next batch's host pack with this
        batch's device compute."""
        import time
        tsz = targets_u8.shape[0]
        stage = stage if stage is not None else {}
        launched = []  # (device sums or None, pairs [P, 2])
        offsets = []
        n_screened = 0
        for dev, (off, ln) in zip(self.devices,
                                  device_blocks(tsz, len(self.devices))):
            if ln == 0:
                continue
            shard = targets_u8[off:off + ln]
            t0 = time.perf_counter()
            eng = self.engines[0]
            words = eng.pack_raw_words(shard, device=dev)
            packed = eng.pad_from_words(words, device=dev)
            if self.screen is not None:
                bounds = self.screen.bounds_from_words(
                    self._u_for(dev), words, device=dev)  # [B, ln]
                survivors = bounds > self.thresholds[:, None]
                n_screened += int((~survivors).sum())
            else:
                survivors = np.ones((len(self.engines), ln), bool)
            del words
            stage["pack+screen"] = stage.get("pack+screen", 0.0) \
                + time.perf_counter() - t0
            t0 = time.perf_counter()
            pairs = np.argwhere(survivors)  # mask-major (mask, target)
            launched.append((self.scorer.launch(packed, pairs, device=dev),
                             pairs))
            offsets.append(off)
            stage["launch"] = stage.get("launch", 0.0) \
                + time.perf_counter() - t0
        stage["screened"] = stage.get("screened", 0) + n_screened
        return tsz, launched, offsets

    def collect(self, handle):
        """Drain one launch()'s results (ALL devices) in one batched
        device_get; returns (scores int64 [B, T], mirrored bool [B, T])
        in the original target order."""
        tsz, launched, offsets = handle
        return self.scorer.collect(launched, len(self.engines), tsz,
                                   offsets)

    def sweep(self, targets_u8: np.ndarray, stage=None):
        """launch + collect in one call (no partition pipelining)."""
        return self.collect(self.launch(targets_u8, stage))
