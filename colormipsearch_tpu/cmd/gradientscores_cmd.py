"""gradientScores command: shape-score re-ranking of top CDS matches.

Counterpart of cmd/CalculateGradientScoresCmd.java:71-647: list masks
with matches -> read + filter matches -> select best
lines/samples/matches -> per-mask shape planes built once -> batched
device shape scoring -> per-mask normalization -> write updates + tags.
"""

from __future__ import annotations

import argparse
import logging
import time
from typing import List

import numpy as np

from ..cds.shape_kernel import finish_shape_scores, shape_score_kernel
from ..cds.shape_oracle import (TargetShapePlanes, build_query_shape_planes,
                                build_target_shape_planes)
from ..dataio import DataSourceParam, ScoresFilter
from ..mips import MIPsCache
from ..model import CDMatchEntity, ComputeFileType, ProcessingType
from ..results import (group_matches_by_mask, normalize_match_scores,
                       partition_collection, select_best_matches)
from .args import add_cds_params, add_common_args, excluded_regions_for

LOG = logging.getLogger(__name__)

_FLUSH_COUNT = 0


def _test_kill_hook() -> None:
    """Fault injection for the GA-phase kill-and-resume test
    (tests/test_kill_resume.py): SIGKILL after the Nth batched score
    flush when CMS_TEST_KILL_AFTER_GA_FLUSHES is set — emulates a GA
    grid job dying mid-run; the reference resubmits the same mask-block
    offsets and idempotent field updates converge
    (submitGAJob.sh:50-60, CalculateGradientScoresCmd.java:602-614)."""
    import os as _os
    n = _os.environ.get("CMS_TEST_KILL_AFTER_GA_FLUSHES")
    if not n:
        return
    global _FLUSH_COUNT
    _FLUSH_COUNT += 1
    if _FLUSH_COUNT >= int(n):
        import signal
        _os.kill(_os.getpid(), signal.SIGKILL)


def add_parser(subparsers) -> None:
    p = subparsers.add_parser("gradientScores",
                              help="gradient/shape score re-ranking")
    add_common_args(p)
    add_cds_params(p)
    p.add_argument("-md", "--matchesDir", default=None,
                   help="per-mask matches dir (from colorDepthSearch)")
    p.add_argument("--db", default=None,
                   help="read/write matches in this SQLite store")
    p.add_argument("--masks-mip-ids", nargs="*", default=None,
                   help="only process these mask MIP ids")
    p.add_argument("--nBestLines", type=int, default=-1)
    p.add_argument("--nBestSamplesPerLine", type=int, default=-1)
    p.add_argument("--nBestMatchesPerSample", type=int, default=-1)
    p.add_argument("--targetsPerBatch", type=int, default=128,
                   help="max targets scored per device step (batches "
                        "pad to pow2-ish buckets, so partial batches "
                        "cost their bucket, not the max; bigger batches "
                        "amortize per-dispatch latency)")
    p.add_argument("--planes-threads", type=int, default=0,
                   help="host threads building target planes "
                        "(decode + zgap dilation + plane algebra; "
                        "0 = cpu count). Only the host plane path "
                        "(CMS_DEVICE_PLANES=0) and decode use them; the "
                        "work parallelizes per target (the reference fans "
                        "the same work over its grid node cores, "
                        "CalculateGradientScoresCmd.java:233-268)")
    p.add_argument("--processing-tag", default=None)
    p.add_argument("--masks-tags", nargs="*", default=[],
                   help="only rescore masks carrying these tags "
                        "(AbstractGradientScoresArgs.java mask selectors)")
    p.add_argument("--masks-processing-tags", nargs="*", default=[],
                   metavar="STAGE=TAG",
                   help="only rescore masks stamped with these processing "
                        "tags (AbstractGradientScoresArgs.java:58)")
    p.add_argument("--cancel-previous-gradient-scores", action="store_true")
    p.add_argument("--use-bidirectional-matching", action="store_true",
                   help="accepted for command-line compatibility; 3D "
                        "bidirectional shape matching is not computed "
                        "(the reference declares but never uses this "
                        "flag either — CalculateGradientScoresCmd.java:"
                        "89-94 hard-codes it false; bidirectionalAreaGap "
                        "values arrive from an external pipeline)")
    p.add_argument("--computeZGapOnTheFly", action="store_true",
                   help="derive missing ZGap variants by 10px dilation")
    p.add_argument("--write-batch-size", type=int, default=10000,
                   help="flush score updates once this many matches are "
                        "pending (0 = one flush at the end); the "
                        "reference batches GA updates the same way "
                        "(CalculateGradientScoresCmd.java:602-614)")
    import os as _os
    p.add_argument("--process-id", type=int,
                   default=int(_os.environ.get("CMS_PROCESS_ID", -1)),
                   help="grid block index for multi-process GA sharding "
                        "(the reference shards mask mipIds over LSF job "
                        "arrays, submitGAJob.sh:50-60)")
    p.add_argument("--process-count", type=int,
                   default=int(_os.environ.get("CMS_PROCESS_COUNT", 0)),
                   help="total grid processes")
    p.set_defaults(func=run)


def _load_mask_image(mask, cache: MIPsCache):
    mip = cache.load_mip(mask, ComputeFileType.InputColorDepthImage)
    return mip.image


def run(args: argparse.Namespace) -> int:
    t_start = time.time()
    from .backends import matches_reader, matches_writer
    reader = matches_reader(args.db, args.matchesDir)
    ptags = {}
    for spec in getattr(args, "masks_processing_tags", []) or []:
        stage, _, tag = spec.partition("=")
        if tag:
            ptags.setdefault(stage, set()).add(tag)
    mask_selector = DataSourceParam(
        mip_ids=args.masks_mip_ids or [],
        tags=set(getattr(args, "masks_tags", []) or []),
        processing_tags=ptags)
    selector = DataSourceParam(mip_ids=args.masks_mip_ids or [])
    mask_locations = reader.list_match_locations([selector])
    LOG.info("found %d masks with matches", len(mask_locations))
    if args.process_count > 0 and args.process_id >= 0:
        # deterministic, restartable mask-mipId grid block: the sorted
        # location list is identical in every process, so the blocks
        # partition the GA work exactly like the reference's LSF job
        # arrays shard mask mipIds (submitGAJob.sh:50-60)
        from ..parallel.pallas_sweep import device_blocks
        blocks = device_blocks(len(mask_locations), args.process_count)
        off, ln = blocks[args.process_id]
        mask_locations = mask_locations[off:off + ln]
        LOG.info("process %d/%d owns %d masks (offset %d)",
                 args.process_id, args.process_count, ln, off)

    array_store = None
    if getattr(args, "array_cache", None):
        from ..imageproc.store import PackedArrayStore
        array_store = PackedArrayStore(args.array_cache)
    cache = MIPsCache(args.cacheSize, array_store=array_store)
    scores_filter = ScoresFilter()
    if args.pctPositivePixels:
        scores_filter.add("matchingRatio", args.pctPositivePixels / 100.0)

    updated: List[CDMatchEntity] = []
    planes_cache: dict = {}
    # ONE writer + batched update flushes across masks (was one
    # write_updates call per mask — thousands of small transactions on
    # the DB backend). FS-backend correctness:
    # pending lists always hold a mask's FULL match list, so the
    # grouped per-mask file rewrite never loses rows.
    writer = matches_writer(args.db, args.matchesDir)
    update_fields = ["gradientAreaGap", "highExpressionArea",
                     "normalizedScore"]
    pending_updates: List[CDMatchEntity] = []

    def flush_updates(force: bool = False):
        if not pending_updates:
            return
        if force or (args.write_batch_size > 0
                     and len(pending_updates) >= args.write_batch_size):
            writer.write_updates(pending_updates, update_fields)
            pending_updates.clear()
            _test_kill_hook()

    for mip_id in mask_locations:
        sel = DataSourceParam(mip_ids=[mip_id],
                              tags=mask_selector.tags,
                              processing_tags=mask_selector.processing_tags)
        matches = reader.read_matches_by_mask(
            sel,
            scores_filter=None if scores_filter.empty else scores_filter)
        if not matches:
            continue
        if args.cancel_previous_gradient_scores:
            for m in matches:
                m.reset_gradient_scores()
        selected = select_best_matches(matches, args.nBestLines,
                                       args.nBestSamplesPerLine,
                                       args.nBestMatchesPerSample)
        scored_for_mask: List[CDMatchEntity] = []
        # a single mip id may map to multiple mask entities
        # (NormalizeGradientScoresCmd.java:270-273)
        for mask_key, mask_matches in group_matches_by_mask(selected).items():
            mask = mask_matches[0].mask_image
            mask_img = _load_mask_image(mask, cache)
            if mask_img is None:
                LOG.warning("no CDM for mask %s", mip_id)
                continue
            excluded = excluded_regions_for(args, mask_img.height,
                                            mask_img.width)
            roi_mask = None
            if args.queryROIMaskName:
                # optional ROI mask restricting the scored region
                # (loadQueryROIMask, CalculateGradientScoresCmd.java:300-302;
                # applied in Shape2DMatch...java:201-218)
                from ..imageproc import load_image
                roi_mask = load_image(args.queryROIMaskName)
            border = getattr(args, "border", 0) or 0
            qplanes = _build_qplanes(mask_img, excluded, roi_mask, border)
            qplanes_m = None
            if roi_mask is not None and args.mirrorMask:
                # the reference mirrors the query but NOT the ROI, so the
                # mirrored orientation needs its own plane set
                from ..cds.shape_oracle import build_mirrored_query_shape_planes
                qplanes_m = build_mirrored_query_shape_planes(
                    mask_img, excluded, roi_mask, border)
            scored_for_mask.extend(score_mask_partitions(
                mask_matches, qplanes, cache, args, excluded,
                planes_cache, qplanes_m))
        # normalization runs over the selected+scored matches only
        # (CalculateGradientScoresCmd.java:213-247: normalizeScores over
        # allScoredMatches, grouped by mask entity internally)
        normalize_match_scores(scored_for_mask)
        updated.extend(scored_for_mask)
        tag = args.processing_tag or "gradientScore"
        for m in scored_for_mask:
            if m.mask_image is not None:
                m.mask_image.add_processed_tag(ProcessingType.GradientScore, tag)
            if m.matched_image is not None:
                m.matched_image.add_processed_tag(ProcessingType.GradientScore, tag)
        # queue the mask's FULL match list, the scored subset carrying
        # its updates (field-level updates on the DB backend;
        # whole-group rewrite on the FS backend)
        pending_updates.extend(matches)
        flush_updates()
        _n_masks_done[0] += 1
        if _n_masks_done[0] % 100 == 0:
            _log_ga_telemetry(cache, planes_cache, _n_masks_done[0])
    flush_updates(force=True)
    LOG.info("updated %d matches in %.1fs", len(updated), time.time() - t_start)
    return 0


_n_masks_done = [0]


def _log_ga_telemetry(cache, planes_cache, n_done: int) -> None:
    """Periodic memory attribution (the r5 dress rehearsal was
    OOM-killed with near-empty caches — the guard can only shrink what
    it can SEE, so make the consumers visible): host RSS, cache entry
    counts/bytes, and jax live-array totals."""
    try:
        import jax
        rss_kb = 0
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    rss_kb = int(line.split()[1])
        live = jax.live_arrays()
        live_b = sum(int(np.prod(a.shape)) * a.dtype.itemsize for a in live)
        with _CACHE_LOCK:
            n_planes = len(planes_cache)
            planes_b = sum(_planes_nbytes(p) for p in planes_cache.values())
        trimmed = _malloc_trim()
        LOG.info(
            "[ga-mem] masks=%d rss=%.1fGB images=%d planes=%d/%.2fGB "
            "jax_arrays=%d/%.2fGB trim=%s", n_done, rss_kb / 1e6,
            len(getattr(cache, "_cache", ())), n_planes, planes_b / 1e9,
            len(live), live_b / 1e9, trimmed)
    except Exception as e:  # pragma: no cover - diagnostics only
        LOG.debug("ga telemetry failed: %s", e)


def _malloc_trim() -> bool:
    from ..utils.memguard import malloc_trim
    return malloc_trim()


_PLANES_CACHE_MAX = 2048

# guards the plane cache for the one-partition lookahead overlap (the
# only concurrent writer); RLock because memguard relief runs inside an
# already-locked insert
import threading as _threading

_CACHE_LOCK = _threading.RLock()


def _prefetch_safely(targets, cache, args, excluded, planes_cache):
    """Lookahead-thread entry: a failed prefetch must never kill the
    run — the scoring path rebuilds misses itself."""
    try:
        _prefetch_planes(targets, cache, args, excluded, planes_cache)
    except Exception as e:  # pragma: no cover - diagnostics only
        LOG.warning("plane lookahead failed (will rebuild inline): %s", e)


def score_mask_partitions(mask_matches, qplanes, cache, args, excluded,
                          planes_cache, qplanes_m=None):
    """Score one mask's matches in targetsPerBatch partitions, with a
    ONE-PARTITION plane lookahead: partition i+1's decode + device
    plane build run on a side thread while i scores (the cold path is
    decode+upload bound; the plane cache is lock-guarded for exactly
    this overlap). Used by the CLI run loop and the bench."""
    import os as _os
    # default OFF; opt in with CMS_GRAD_LOOKAHEAD=1. Whether the extra
    # decode thread helps on a GPU host has not been measured.
    use_lookahead = _os.environ.get("CMS_GRAD_LOOKAHEAD", "0") == "1"
    scored_all = []
    parts = partition_collection(mask_matches, args.targetsPerBatch)
    lookahead = None
    for pi, part in enumerate(parts):
        if use_lookahead and pi + 1 < len(parts):
            nxt = [m.matched_image for m in parts[pi + 1]
                   if m.matched_image]
            lookahead = _threading.Thread(
                target=_prefetch_safely,
                args=(nxt, cache, args, excluded, planes_cache),
                daemon=True)
            lookahead.start()
        scored_all.extend(_score_batch(part, qplanes, cache, args,
                                       excluded, planes_cache, qplanes_m))
        if lookahead is not None:
            lookahead.join()
            lookahead = None
    return scored_all


def _planes_nbytes(planes) -> int:
    if planes is None or not hasattr(planes, "t_above"):
        return 0  # None (missing-file sentinel) or test doubles
    return sum(int(np.prod(a.shape)) * a.dtype.itemsize
               for a in (planes.t_above, planes.grad, planes.z_nonzero,
                         planes.z_slice))


_PLANES_CACHE_MB = int(__import__("os").environ
                       .get("CMS_PLANES_CACHE_MB", "4096"))


def _insert_plane(planes_cache: dict, key, planes) -> None:
    """Bounded LRU insert with a host memory-pressure reaction
    (AbstractCmd.java:52-62 analogue): device-resident plane sets are
    the run's dominant steady-state HBM+RAM consumer, so under low
    host memory the cache halves (more recomputation, never an OOM).
    The bound is BYTE-aware (CMS_PLANES_CACHE_MB, default 4 GB): plane
    sets are ~4.1 MB per production target, so an entry cap alone
    would not bound device memory."""
    with _CACHE_LOCK:
        budget = _PLANES_CACHE_MB << 20
        # recomputed per insert: <= ~1000 cheap attr reads, negligible
        # next to the per-target decode+upload this call sits behind
        size = sum(_planes_nbytes(p) for p in planes_cache.values()) \
            + _planes_nbytes(planes)
        while planes_cache and (len(planes_cache) >= _PLANES_CACHE_MAX
                                or size > budget):
            old = planes_cache.pop(next(iter(planes_cache)))  # LRU-oldest
            size -= _planes_nbytes(old)
        planes_cache[key] = planes

        def evict_half() -> int:
            n = len(planes_cache) // 2
            for _ in range(n):
                planes_cache.pop(next(iter(planes_cache)))
            return n

        from ..utils.memguard import shared_guard
        shared_guard().relieve(evict_half, "plane-cache")


def _planes_host(target, cache: MIPsCache, args, excluded):
    """HOST part of a target's shape planes (decode + optional zgap
    dilation + plane algebra) — pure per-target work, safe to fan over a
    thread pool (zlib / the native decode helpers and the native max
    filter release the GIL;
    MIPsCache is lock-protected). Fallback path: the default builds
    planes ON DEVICE from raw frames (_decode_raw + device block build),
    leaving the host only decode + upload."""
    cdm = cache.load_mip(target, ComputeFileType.InputColorDepthImage).image
    grad = cache.load_mip(target, ComputeFileType.GradientImage).image
    zgap = cache.load_mip(target, ComputeFileType.ZGapImage).image
    if cdm is None or grad is None or \
            (zgap is None and not args.computeZGapOnTheFly):
        return None
    return build_target_shape_planes(cdm, grad, zgap, args.maskThreshold,
                                     excluded)


def _upload_planes(planes):
    # keep the planes DEVICE-resident: each target uploads once and
    # every (mask, batch) pairing afterwards stacks/crops on device
    # (host<->device transfer dominates otherwise)
    import jax.numpy as jnp
    return TargetShapePlanes(
        t_above=jnp.asarray(planes.t_above),
        grad=jnp.asarray(planes.grad),
        z_nonzero=jnp.asarray(planes.z_nonzero),
        z_slice=jnp.asarray(planes.z_slice))


def _build_qplanes(mask_img, excluded, roi_mask, border: int):
    """Per-mask query shape planes: on DEVICE by default (two 60px/20px
    host dilations cost ~670 ms/mask serially — the dominant gradient
    phase cost at production mask counts, found by the r5 dress
    rehearsal), host oracle path for ROI-mask runs, non-RGB masks, or
    CMS_DEVICE_PLANES=0."""
    from ..imageproc.io import ImageKind
    if device_planes_enabled() and roi_mask is None \
            and mask_img.kind == ImageKind.RGB:
        from ..cds.shape_device import build_query_planes_device
        return build_query_planes_device(mask_img.pixels, excluded, border)
    return build_query_shape_planes(mask_img, excluded, roi_mask, border)


def device_planes_enabled() -> bool:
    """Default ON: target planes derive on device from raw u8 frames
    (the host plane build is per-target host work the device does in
    one jitted program). CMS_DEVICE_PLANES=0 selects the host NumPy path (the
    oracle path, kept for cross-checking and non-RGB edge cases)."""
    import os
    return os.environ.get("CMS_DEVICE_PLANES", "1") == "1"


def _decode_raw(target, cache: MIPsCache, args):
    """Decode a target's raw frames (thread-pool work). Returns
    (cdm u8 [H,W,3], (grad_arr, grad_is_rgb), zgap u8 [H,W,3] | None)
    or None when required files are missing, or the string "host" when
    the images need the host fallback path (non-RGB CDM/zgap)."""
    import numpy as np
    from ..imageproc.io import ImageKind
    cdm = cache.load_mip(target, ComputeFileType.InputColorDepthImage).image
    grad = cache.load_mip(target, ComputeFileType.GradientImage).image
    zgap = cache.load_mip(target, ComputeFileType.ZGapImage).image
    if cdm is None or grad is None or \
            (zgap is None and not args.computeZGapOnTheFly):
        return None
    if cdm.kind != ImageKind.RGB or \
            (zgap is not None and zgap.kind != ImageKind.RGB):
        return "host"
    if grad.kind == ImageKind.RGB:
        grad_raw = (grad.pixels, True)
    else:
        grad_raw = (grad.pixels.astype(np.uint16), False)
    zgap_px = zgap.pixels if zgap is not None else None
    return (cdm.pixels, grad_raw, zgap_px)


_PLANES_BLOCK = None


def _planes_block_size() -> int:
    global _PLANES_BLOCK
    if _PLANES_BLOCK is None:
        import os
        _PLANES_BLOCK = max(1, int(os.environ.get("CMS_PLANES_BLOCK", "16")))
    return _PLANES_BLOCK


_EXCLUDED_DEV = {}


def grad_devices():
    """Local devices the gradient phase spreads over (the reference
    fans GA jobs over LSF hosts, CalculateGradientScoresCmd.java:304-312;
    here one process drives EVERY local chip: plane-build blocks
    round-robin across devices and the fused batch scorer dispatches
    each device's resident planes on that device). CMS_GRAD_DEVICES
    caps the count (1 = the pre-r5 single-device behavior)."""
    import os

    import jax
    devs = jax.local_devices()
    cap = os.environ.get("CMS_GRAD_DEVICES")
    if cap:
        devs = devs[:max(1, min(int(cap), len(devs)))]
    return devs


def _excluded_device(excluded, device=None):
    """Upload the label-region mask once per (shape, device, contents)."""
    if excluded is None:
        return None
    import jax
    import jax.numpy as jnp
    import numpy as np
    key = (excluded.shape, device)
    cached = _EXCLUDED_DEV.get(key)
    if cached is not None and np.array_equal(cached[0], excluded):
        return cached[1]
    arr = excluded.astype(bool)
    dev = jnp.asarray(arr) if device is None else jax.device_put(arr, device)
    _EXCLUDED_DEV[key] = (np.array(excluded, dtype=bool), dev)
    return dev


def _build_planes_device(raws, args, excluded):
    """Batched device plane build: groups same-(shape, grad kind, zgap
    mode) raw frames into fixed-size blocks (one static shape -> one
    XLA compile), uploads the raw u8 frames, and runs
    build_target_planes_device. Returns [TargetShapePlanes | None] in
    input order."""
    import numpy as np
    from ..cds.shape_device import build_target_planes_device
    results = [None] * len(raws)
    groups = {}
    for i, raw in enumerate(raws):
        cdm, (grad_arr, grad_is_rgb), zgap_px = raw
        mode = "file" if zgap_px is not None else "otf"
        key = (cdm.shape, grad_is_rgb, mode)
        groups.setdefault(key, []).append(i)
    devs = grad_devices()
    block = _planes_block_size()
    for (shape, grad_is_rgb, mode), idxs in groups.items():
        for b0 in range(0, len(idxs), block):
            chunk = idxs[b0:b0 + block]
            pad = chunk + [chunk[-1]] * (block - len(chunk))
            cdm_b = np.stack([raws[i][0] for i in pad])
            grad_b = np.stack([raws[i][1][0] for i in pad])
            zgap_b = (np.stack([raws[i][2] for i in pad])
                      if mode == "file" else None)
            # round-robin blocks over local devices; planes stay
            # resident where built and score there (multi-device GA)
            device = None
            if len(devs) > 1:
                global _BLOCK_RR
                device = devs[_BLOCK_RR % len(devs)]
                _BLOCK_RR += 1
            t_above, grad, z_nonzero, z_slice = build_target_planes_device(
                cdm_b, grad_b, zgap_b, _excluded_device(excluded, device),
                thr=int(args.maskThreshold), zgap_mode=mode,
                grad_is_rgb=grad_is_rgb, device=device)
            for j, i in enumerate(chunk):
                results[i] = TargetShapePlanes(
                    t_above=t_above[j], grad=grad[j],
                    z_nonzero=z_nonzero[j], z_slice=z_slice[j])
    return results


_BLOCK_RR = 0


def _planes_pool(args):
    """Process-wide plane-build pool, sized by --planes-threads."""
    global _POOL
    if _POOL is None:
        import os
        from concurrent.futures import ThreadPoolExecutor
        n = getattr(args, "planes_threads", 0) or (os.cpu_count() or 2)
        _POOL = ThreadPoolExecutor(max_workers=n,
                                   thread_name_prefix="planes")
    return _POOL


_POOL = None


def _prefetch_planes(targets, cache, args, excluded, planes_cache):
    """Build all missing targets' planes concurrently. Default path:
    thread-pooled DECODE only, then batched raw-frame upload + ONE
    device dispatch per block derives the planes on the device
    (cds/shape_device.py) — the host plane algebra
    (slice-LUT gathers, zgap dilation) no longer runs on the host.
    CMS_DEVICE_PLANES=0 restores the host build."""
    seen = set()
    missing = []
    with _CACHE_LOCK:
        for t in targets:
            key = t.entity_id or t.mip_id
            if key not in planes_cache and key not in seen:
                seen.add(key)
                missing.append((key, t))
    if not missing:
        return
    pool = _planes_pool(args)
    if not device_planes_enabled():
        futs = [(key, pool.submit(_planes_host, t, cache, args, excluded))
                for key, t in missing]
        for key, fut in futs:
            planes = fut.result()
            if planes is not None:
                planes = _upload_planes(planes)
            _insert_plane(planes_cache, key, planes)
        return
    futs = [(key, t, pool.submit(_decode_raw, t, cache, args))
            for key, t in missing]
    device_keys, device_raws = [], []
    for key, t, fut in futs:
        raw = fut.result()
        if raw is None:
            _insert_plane(planes_cache, key, None)
        elif isinstance(raw, str):  # "host": non-RGB edge case
            planes = _planes_host(t, cache, args, excluded)
            _insert_plane(planes_cache, key,
                          _upload_planes(planes) if planes is not None
                          else None)
        else:
            device_keys.append(key)
            device_raws.append(raw)
    if device_raws:
        for key, planes in zip(device_keys,
                               _build_planes_device(device_raws, args,
                                                    excluded)):
            _insert_plane(planes_cache, key, planes)


def _target_planes_cached(target, cache: MIPsCache, args, excluded,
                          planes_cache: dict):
    """Per-target shape planes are pure functions of the target's files;
    cache them across masks (the reference re-derives lazy images per
    match; here the slice/grad planes are computed once per target).
    LRU eviction: a full-cache clear would trigger an O(everything)
    recompute spike mid-run."""
    key = target.entity_id or target.mip_id
    with _CACHE_LOCK:
        if key in planes_cache:
            planes_cache[key] = planes_cache.pop(key)  # refresh LRU
            return planes_cache[key]
    _prefetch_planes([target], cache, args, excluded, planes_cache)
    with _CACHE_LOCK:
        planes = planes_cache.get(key)
        if planes is not None:
            planes_cache[key] = planes_cache.pop(key)
    return planes


def _qplanes_device(qp, device=None):
    """Upload a mask's query planes once PER DEVICE (cached on the
    dataclass); the fused batch kernel reuses them across every batch
    of the mask on that device."""
    cache = getattr(qp, "_dev", None)
    if cache is None:
        cache = {}
        qp._dev = cache
    dev = cache.get(device)
    if dev is None:
        import jax
        import jax.numpy as jnp
        import numpy as np
        if qp.q_nonzero is None:
            # device-resident build (shape_device.build_query_planes_
            # device): planes live on one device already — replicate
            # device-to-device, never through the host
            src = next(iter(cache.values()))
            dev = (src if device is None
                   else tuple(jax.device_put(a, device) for a in src))
        else:
            arrs = (qp.q_nonzero, qp.q_slice.astype(np.int32),
                    qp.q_mask.astype(np.int32), qp.high_expr.astype(bool))
            if device is None:
                dev = tuple(jnp.asarray(a) for a in arrs)
            else:
                dev = tuple(jax.device_put(a, device) for a in arrs)
        cache[device] = dev
    return dev


def _pad_to_bucket(items: list, targets_per_batch: int) -> int:
    """Pad a batch IN PLACE to a pow2-ish BUCKET size so the jitted
    kernel sees few static T shapes (full batches pad to
    targets_per_batch; partials to their bucket). Returns the real
    (pre-pad) item count."""
    n_real = len(items)
    bucket = next((b for b in (16, 32, 64, 128, 256, 512)
                   if n_real <= b <= targets_per_batch),
                  targets_per_batch)
    bucket = max(bucket, min(n_real, targets_per_batch))
    while len(items) < bucket:
        items.append(items[-1])
    return n_real


def score_tplanes_batched(qplanes, tplanes, *, mirror: bool,
                          targets_per_batch: int, r0: int, r1: int):
    """Multi-device fused stacked scoring over already-built target
    planes (the production GA engine's device dispatch): group targets
    by the device their planes are RESIDENT on (plane-build blocks
    round-robin over grad_devices()), pad each group to a pow2-ish
    bucket, dispatch ONE fused shape_score_stacked per device — all
    dispatches queue async before any result is pulled — then finish
    host-side. Returns (gaps, high, use_m) aligned with tplanes order.
    With one device this is exactly the pre-r5 single-dispatch path."""
    from ..cds.shape_kernel import shape_score_stacked
    groups: dict = {}
    for i, t in enumerate(tplanes):
        devs_of = getattr(t.grad, "devices", None)
        dev = next(iter(t.grad.devices())) if callable(devs_of) else None
        groups.setdefault(dev, []).append(i)
    dispatched = []
    for dev, idxs in groups.items():
        sel = [tplanes[i] for i in idxs]
        n_real = _pad_to_bucket(sel, targets_per_batch)
        qd = _qplanes_device(qplanes, dev)
        out = shape_score_stacked(*qd,
                                  [t.t_above for t in sel],
                                  [t.grad for t in sel],
                                  [t.z_nonzero for t in sel],
                                  [t.z_slice for t in sel],
                                  r0=r0, r1=r1, mirror=mirror)
        dispatched.append((idxs, n_real, out))
    gaps_all = np.zeros(len(tplanes), dtype=np.int64)
    high_all = np.zeros(len(tplanes), dtype=np.int64)
    use_m_all = np.zeros(len(tplanes), dtype=bool)
    for idxs, n_real, out in dispatched:
        gaps, high, _score, use_m = finish_shape_scores(*out, mirror=mirror)
        gaps_all[idxs] = gaps[:n_real]
        high_all[idxs] = high[:n_real]
        use_m_all[idxs] = np.asarray(use_m)[:n_real]
    return gaps_all, high_all, use_m_all


def _score_batch(part, qplanes, cache: MIPsCache, args, excluded,
                 planes_cache: dict, qplanes_m=None):
    """Batched shape scoring for one mask's matches. qplanes_m carries
    the mirrored-orientation plane set for the ROI-mask case."""
    tplanes = []
    scored_matches = []
    want_shape = (qplanes.height, qplanes.width)
    _prefetch_planes([m.matched_image for m in part if m.matched_image],
                     cache, args, excluded, planes_cache)
    for m in part:
        planes = _target_planes_cached(m.matched_image, cache, args,
                                       excluded, planes_cache)
        if planes is None:
            # no negative score possible
            # (Shape2DMatchColorDepthSearchAlgorithm.java:155-158)
            m.gradient_area_gap = -1
            m.high_expression_area = -1
            continue
        if tuple(planes.grad.shape) != tuple(want_shape):
            # size mismatch vs the mask frame: skip rather than crash
            # the whole batch stack (per-pair failure isolation)
            LOG.warning("target %s planes %s mismatch mask frame %s — "
                        "skipped",
                        m.matched_image.mip_id if m.matched_image else "?",
                        tuple(planes.grad.shape), tuple(want_shape))
            m.gradient_area_gap = -1
            m.high_expression_area = -1
            continue
        tplanes.append(planes)
        scored_matches.append(m)
    if not tplanes:
        return []

    # crop to the query's active row band: outside it every gap /
    # high-expression term is provably zero (QueryShapePlanes
    # .active_row_range), typically a ~2x compute cut. NB the mirror
    # pass only flips columns, so row cropping is mirror-safe.
    import jax.numpy as jnp
    r0, r1 = qplanes.active_row_range()
    if qplanes_m is not None:
        # crop must cover the active rows of BOTH orientations
        m0, m1 = qplanes_m.active_row_range()
        r0, r1 = min(r0, m0), max(r1, m1)
    if qplanes_m is None:
        gaps, high, use_m = score_tplanes_batched(
            qplanes, tplanes, mirror=args.mirrorMask,
            targets_per_batch=args.targetsPerBatch, r0=r0, r1=r1)
        for i, m in enumerate(scored_matches):
            m.gradient_area_gap = int(gaps[i])
            m.high_expression_area = int(high[i])
            m.bidirectional_area_gap = None
        return scored_matches
    n_real = _pad_to_bucket(tplanes, args.targetsPerBatch)
    # ROI-mask path (rare): explicit stacked planes, two passes; runs
    # on one device (planes built on other devices migrate with ONE
    # pytree device_put — never per-target slice/put ops in a loop,
    # per-dispatch latency dominates small-op paths)
    dev0 = grad_devices()[0] if len(grad_devices()) > 1 else None
    plane_tuples = [(t.grad, t.z_nonzero, t.z_slice, t.t_above)
                    for t in tplanes]
    if dev0 is not None:
        import jax
        plane_tuples = jax.device_put(plane_tuples, dev0)
    grad = jnp.stack([p[0] for p in plane_tuples])[:, r0:r1]
    znz = jnp.stack([p[1] for p in plane_tuples])[:, r0:r1]
    zsl = jnp.stack([p[2] for p in plane_tuples])[:, r0:r1]
    tab = jnp.stack([p[3] for p in plane_tuples])[:, r0:r1]

    # exact ROI semantics: two identity-orientation passes, the
    # second with mirrored-query planes and flipped z planes
    def one_pass(qp_, g_, znz_, zsl_, tab_):
        out = shape_score_kernel(qp_.q_nonzero[r0:r1],
                                 qp_.q_slice[r0:r1],
                                 qp_.q_mask[r0:r1],
                                 qp_.high_expr[r0:r1],
                                 g_, znz_, zsl_, tab_, mirror=False)
        return finish_shape_scores(*out, mirror=False)
    g_i, h_i, s_i, _ = one_pass(qplanes, grad, znz, zsl, tab)
    g_m, h_m, s_m, _ = one_pass(qplanes_m, grad, znz[:, :, ::-1],
                                zsl[:, :, ::-1], tab)
    use_m = s_m < s_i
    gaps = np.where(use_m, g_m, g_i)
    high = np.where(use_m, h_m, h_i)
    gaps, high = gaps[:n_real], high[:n_real]
    use_m = np.asarray(use_m)[:n_real]
    for i, m in enumerate(scored_matches):
        m.gradient_area_gap = int(gaps[i])
        m.high_expression_area = int(high[i])
        m.bidirectional_area_gap = None
    return scored_matches
