"""colorDepthSearch command: the full mask x target pixel-match sweep.

Counterpart of cmd/ColorDepthSearchCmd.java:54-467 +
LocalColorMIPSearchProcessor.java:38-122, re-structured for an
accelerator: the reference iterates masks and fans targets over a
thread pool; here target batches are packed once onto the device and
stay resident while every mask is scored against them (SURVEY.md
2d-P1).
"""

from __future__ import annotations

import argparse
import getpass
import logging
import os
import time
from typing import List

import numpy as np

from ..cds.oracle import shift_ring_offsets
from ..cds.pixel_kernel import (pack_targets, prepare_query_planes,
                                z_tolerance_to_zt9)
from ..dataio import (DataSourceParam, JSONCDMIPsReader,
                      JSONCDSSessionWriter)
from ..mips import MIPsCache
from ..model import (CDMatchEntity, CDSSessionEntity, ComputeFileType,
                     ProcessingType)
from ..persist import TimebasedIdGenerator
from ..results import partition_collection
from .args import add_cds_params, add_common_args, excluded_regions_for, ListArg

LOG = logging.getLogger(__name__)

_FLUSH_COUNT = 0


def _test_kill_hook() -> None:
    """Fault injection for the kill-and-resume end-to-end test
    (tests/test_kill_resume.py): SIGKILL this process after the Nth
    incremental flush when CMS_TEST_KILL_AFTER_FLUSHES is set —
    emulates an LSF array job dying mid-partition, the failure mode the
    reference recovers from by resubmitting the same block offsets
    (submitCDSBatch.sh:14-25, ColorDepthSearchCmd.java:316-335)."""
    import os as _os
    n = _os.environ.get("CMS_TEST_KILL_AFTER_FLUSHES")
    if not n:
        return
    global _FLUSH_COUNT
    _FLUSH_COUNT += 1
    if _FLUSH_COUNT >= int(n):
        import signal
        _os.kill(_os.getpid(), signal.SIGKILL)


def add_parser(subparsers) -> None:
    p = subparsers.add_parser(
        "colorDepthSearch", help="pairwise color depth search")
    add_common_args(p)
    add_cds_params(p)
    p.add_argument("-m", "--masks", nargs="+", required=True,
                   help="mask MIPs: JSON file(s) 'path:offset:length', or "
                        "with --mips-storage db, library selector(s) "
                        "'library:offset:length'")
    p.add_argument("-i", "--targets", "--images", nargs="+", required=True,
                   help="target MIPs: JSON file(s) or (--mips-storage db) "
                        "library selector(s), 'name:offset:length'")
    p.add_argument("--mips-storage", choices=("file", "db"), default="file",
                   help="where mask/target MIP entities come from "
                        "(ColorDepthSearchCmd.java --mips-storage; the "
                        "reference defaults to DB — 'db' reads entities "
                        "from the --db store by library + selectors via "
                        "DBCDMIPsReader.java:30-60)")
    p.add_argument("--masks-index", type=int, default=0)
    p.add_argument("--masks-length", type=int, default=-1)
    p.add_argument("--targets-index", type=int, default=0)
    p.add_argument("--targets-length", type=int, default=-1)
    # neuron selectors, applied in-store for db reads and host-side for
    # file reads (ColorDepthSearchCmd.java:93-155 selector args)
    p.add_argument("-as", "--alignment-space", default=None)
    p.add_argument("--masks-tags", "--mask-tags", dest="masks_tags",
                   nargs="*", default=[])
    p.add_argument("--masks-excluded-tags", "--mask-excluded-tags",
                   dest="masks_excluded_tags", nargs="*", default=[])
    p.add_argument("--masks-terms", nargs="*", default=[])
    p.add_argument("--excluded-masks-terms", nargs="*", default=[])
    p.add_argument("--masks-datasets", nargs="*", default=[])
    p.add_argument("--masks-published-names", nargs="*", default=[])
    p.add_argument("--targets-tags", "--target-tags", dest="targets_tags",
                   nargs="*", default=[])
    p.add_argument("--targets-excluded-tags", "--target-excluded-tags",
                   dest="targets_excluded_tags", nargs="*", default=[])
    p.add_argument("--targets-terms", nargs="*", default=[])
    p.add_argument("--excluded-targets-terms", nargs="*", default=[])
    p.add_argument("--targets-datasets", nargs="*", default=[])
    p.add_argument("--targets-published-names", nargs="*", default=[])
    p.add_argument("--perMaskSubdir", default="masks")
    p.add_argument("--perTargetSubdir", default=None,
                   help="also write per-target grouped results")
    p.add_argument("--processing-tag", default=None)
    p.add_argument("--update-matches", action="store_true",
                   help="re-run mode: refresh pixel scores of existing "
                        "(mask, target) matches without clobbering their "
                        "gradient/normalized scores "
                        "(ColorDepthSearchCmd.java:395-401)")
    p.add_argument("--masks-processing-tags", nargs="*", default=[],
                   metavar="STAGE=TAG",
                   help="only process masks already stamped with these "
                        "processing tags, e.g. ColorDepthSearch=run1 "
                        "(AbstractGradientScoresArgs.java:58)")
    p.add_argument("--excluded-masks-processing-tags", nargs="*", default=[],
                   metavar="STAGE=TAG",
                   help="skip masks already stamped with these tags "
                        "(restartable 'process only what lacks tag X')")
    p.add_argument("--write-batch-size", type=int, default=0,
                   help="flush results every N masks (0 = at end)")
    p.add_argument("--db", default=None,
                   help="write matches to this SQLite store instead of JSON")
    p.add_argument("--process-id", type=int,
                   default=int(__import__("os").environ.get("CMS_PROCESS_ID", -1)),
                   help="grid block index for multi-process sweeps")
    p.add_argument("--process-count", type=int,
                   default=int(__import__("os").environ.get("CMS_PROCESS_COUNT", 0)),
                   help="total grid processes")
    p.add_argument("--jax-distributed", action="store_true",
                   help="join a jax.distributed multi-host runtime "
                        "(CMS_COORDINATOR/CMS_NUM_PROCESSES/CMS_PROCESS_ID) "
                        "so sweeps run on the GLOBAL device mesh instead "
                        "of per-process blocks")
    p.add_argument("--cdsConcurrency", type=int, default=0,
                   help="host decode-pool threads (0 = default 8; the "
                        "reference's compute concurrency knob, "
                        "CmdUtils.java:17-40 — compute itself runs on "
                        "the device here)")
    p.add_argument("--engine", choices=("auto", "dense", "pallas"),
                   default="auto",
                   help="scoring engine: 'pallas' = prescreen + active-tile "
                        "Pallas kernel (CUDA GPUs), 'dense' = full-frame "
                        "XLA; 'auto' picks pallas on a GPU, dense on a CPU")
    p.add_argument("--prescreen", choices=("on", "off"), default="on",
                   help="upper-bound screen before the exact kernel "
                        "(pallas engine only; results identical)")
    p.set_defaults(func=run)


def _pick_engine(kind: str, interpret: bool = False) -> str:
    """Resolve --engine for the platform JAX runs on. The kernel engine
    needs a CUDA GPU (or interpret mode, which tests request and which a
    GPU refuses); nothing switches engines silently."""
    import jax
    platform = jax.devices()[0].platform
    if interpret and platform == "gpu":
        raise SystemExit("CMS_PALLAS_INTERPRET=1 is for CPU tests; the "
                         "kernel compiles on this GPU")
    if kind == "auto":
        kind = "pallas" if platform == "gpu" else "dense"
    elif kind == "pallas" and platform != "gpu" and not interpret:
        raise SystemExit(f"--engine pallas needs a CUDA GPU; JAX runs on "
                         f"{platform!r} (use --engine dense)")
    LOG.info("scoring engine: %s on %s", kind, platform)
    return kind


def _filter_by_processing_tags(entities, include_specs, exclude_specs):
    """Restartable stage selection by processedTags stamps (SURVEY §5:
    'process only what lacks tag X'; AbstractGradientScoresArgs.java:58).
    Specs are STAGE=TAG with STAGE a ProcessingType name."""
    from ..model import ProcessingType

    def parse(specs):
        out = []
        for s in specs or []:
            stage, _, tag = s.partition("=")
            try:
                out.append((ProcessingType[stage], tag))
            except KeyError:
                LOG.warning("unknown processing stage %r in %r", stage, s)
        return out

    inc, exc = parse(include_specs), parse(exclude_specs)
    if not inc and not exc:
        return entities
    kept = [e for e in entities
            if all(e.has_processed_tag(pt, tag) for pt, tag in inc)
            and not any(e.has_processed_tag(pt, tag) for pt, tag in exc)]
    LOG.info("processing-tag filters kept %d/%d masks", len(kept),
             len(entities))
    return kept


def _side_selector(args, side: str) -> DataSourceParam:
    """Mask/target neuron selector from the CLI args
    (ColorDepthSearchCmd.readMIPs, :413-448)."""
    g = lambda name: getattr(args, f"{side}_{name}", None) or []
    return DataSourceParam(
        alignment_space=getattr(args, "alignment_space", None),
        names=list(g("published_names")),
        datasets=set(g("datasets")),
        tags=set(g("tags")),
        excluded_tags=set(g("excluded_tags")),
        annotations=set(g("terms")),
        excluded_annotations=set(getattr(
            args, f"excluded_{side}_terms", None) or []))


def _read_mips(args, files: List[str], index: int, length: int, side: str):
    """Read one side's MIP entities: JSON file lists, or store libraries
    when --mips-storage db (DBCDMIPsReader.java:30-60). Both paths apply
    the side's neuron selectors and keep only entities with an input CDM
    (ColorDepthSearchCmd.readMIPs:438-439)."""
    sel = _side_selector(args, side)
    entities = []
    if getattr(args, "mips_storage", "file") == "db":
        if not args.db:
            raise SystemExit("--mips-storage db requires --db")
        from ..dataio.db import DBCDMIPsReader
        from .backends import get_store
        reader = DBCDMIPsReader(get_store(args.db))
        for f in files:
            la = ListArg.parse(f)
            param = DataSourceParam(
                alignment_space=sel.alignment_space,
                libraries=[la.input], names=sel.names,
                datasets=sel.datasets, tags=sel.tags,
                excluded_tags=sel.excluded_tags,
                annotations=sel.annotations,
                excluded_annotations=sel.excluded_annotations,
                offset=la.offset, size=la.length)
            entities.extend(reader.read_mips(param))
    else:
        for f in files:
            la = ListArg.parse(f)
            param = DataSourceParam(offset=la.offset, size=la.length)
            mips = JSONCDMIPsReader(la.input).read_mips(param)
            entities.extend(e for e in mips if sel.matches_entity(e))
    entities = [e for e in entities
                if ComputeFileType.InputColorDepthImage in e.compute_files]
    param = DataSourceParam(offset=index, size=length)
    return param.apply_slice(entities)


def _load_target_images(targets, cache: MIPsCache, workers: int = 8):
    """Decode a target partition with a thread pool (zlib and the native
    decode helpers release the GIL). Counterpart of the reference's I/O-side
    parallelism (LocalColorMIPSearchProcessor's executor, P1/P4).

    Returns (pixel arrays, entities, failed) where failed is a list of
    (target, error message) — one corrupt/missing/mis-sized image must
    not kill the partition, and the failure must be REPORTED per pair
    downstream, exactly like the reference's per-pair Throwable capture
    into CDMatchEntity.errors (AbstractColorMIPSearchProcessor.java:
    58-85)."""
    from concurrent.futures import ThreadPoolExecutor

    def load(t):
        try:
            return t, cache.load_mip(t, ComputeFileType.InputColorDepthImage), None
        except Exception as e:  # decode/IO failure — capture, don't kill
            return t, None, f"{type(e).__name__}: {e}"

    loaded, entities, failed = [], [], []
    shape = None
    with ThreadPoolExecutor(max_workers=workers) as pool:
        for t, mip, err in pool.map(load, targets):
            if err is not None:
                LOG.warning("target %s failed to load: %s", t.mip_id, err)
                failed.append((t, err))
                continue
            if mip.image is None:
                LOG.warning("no input image for target %s", t.mip_id)
                failed.append((t, "no input image"))
                continue
            px = (mip.image.pixels if mip.image.pixels.ndim == 3
                  else np.repeat(mip.image.pixels[..., None], 3, axis=2))
            if shape is None:
                shape = px.shape
            elif px.shape != shape:
                LOG.warning("target %s has size %s, expected %s — skipped",
                            t.mip_id, px.shape, shape)
                failed.append((t, f"image size {px.shape} != mask size "
                                  f"{shape}"))
                continue
            loaded.append(px)
            entities.append(t)
    return loaded, entities, failed


def run(args: argparse.Namespace) -> int:
    import jax.numpy as jnp
    from ..parallel.sweep import local_pixel_sweep

    multi = False
    if getattr(args, "jax_distributed", False):
        from ..parallel.multihost import maybe_init_distributed
        multi = maybe_init_distributed()

    t_start = time.time()
    masks = _read_mips(args, args.masks, args.masks_index,
                       args.masks_length, "masks")
    targets = _read_mips(args, args.targets, args.targets_index,
                         args.targets_length, "targets")
    masks = _filter_by_processing_tags(
        masks, getattr(args, "masks_processing_tags", []),
        getattr(args, "excluded_masks_processing_tags", []))
    if args.process_count > 0 and args.process_id >= 0:
        # deterministic grid block, restartable per process id
        # (the LSF job-array mapping, submitCDSJob.sh:58-66)
        from ..parallel.distributed import block_for_process
        blk = block_for_process(len(masks), len(targets),
                                args.process_id, args.process_count)
        masks = masks[blk.mask_offset:blk.mask_offset + blk.mask_length]
        targets = targets[blk.target_offset:blk.target_offset + blk.target_length]
        LOG.info("process %d/%d owns block %s", args.process_id,
                 args.process_count, blk)
    LOG.info("read %d masks, %d targets", len(masks), len(targets))
    if not masks or not targets:
        LOG.warning("nothing to search")
        return 0

    idgen = TimebasedIdGenerator()
    session_id = idgen.generate_id()
    run_tag = args.processing_tag or str(session_id)

    array_store = None
    if getattr(args, "array_cache", None):
        from ..imageproc.store import PackedArrayStore
        array_store = PackedArrayStore(args.array_cache)
    cache = MIPsCache(args.cacheSize, array_store=array_store)
    zt9 = z_tolerance_to_zt9(args.pixColorFluctuation)
    shifts = jnp.asarray(np.asarray(shift_ring_offsets(args.xyShift),
                                    dtype=np.int32))
    pad = max(args.xyShift, 1)

    # persist session params for provenance (ColorDepthSearchCmd.java:255-278)
    if args.output_dir or args.db:
        session = CDSSessionEntity(
            entity_id=session_id, username=getpass.getuser(),
            params={"mirrorMask": args.mirrorMask,
                    "dataThreshold": args.dataThreshold,
                    "maskThreshold": args.maskThreshold,
                    "pixColorFluctuation": args.pixColorFluctuation,
                    "xyShift": args.xyShift,
                    "pctPositivePixels": args.pctPositivePixels},
            masks=[{"file": f} for f in args.masks],
            targets=[{"file": f} for f in args.targets])
        if args.db:
            from .backends import get_store
            get_store(args.db).create_session(session)
        else:
            JSONCDSSessionWriter(args.output_dir).create_session(session)

    all_matches: List[CDMatchEntity] = []
    target_parts = partition_collection(targets, args.processingPartitionSize)
    ratio_threshold = (args.pctPositivePixels or 0.0) / 100.0
    # hermetic CPU coverage of the kernel branch: tests ask for interpret
    interpret = os.environ.get("CMS_PALLAS_INTERPRET") == "1"
    engine_kind = _pick_engine(args.engine, interpret)

    # prepare query planes / engines once per mask, fanned over a host
    # thread pool (decode + tile decomposition is GIL-releasing NumPy
    # work; at production mask counts a serial loop costs minutes)
    def prep_one(mask):
        mip = cache.load_mip(mask, ComputeFileType.InputColorDepthImage)
        if mip.image is None:
            LOG.warning("no input image for mask %s", mask.mip_id)
            return None
        excluded = excluded_regions_for(args, mip.image.height,
                                        mip.image.width)
        if engine_kind == "pallas":
            from ..cds.active_tile import ActiveTilePixelEngine
            eng = ActiveTilePixelEngine(
                mip.image, args.maskThreshold, args.mirrorMask,
                args.dataThreshold, args.pixColorFluctuation, args.xyShift,
                excluded, interpret=interpret)
            return (mask, eng)
        return (mask, prepare_query_planes(
            mip.image, args.maskThreshold, excluded))

    from concurrent.futures import ThreadPoolExecutor
    t_prep = time.perf_counter()
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 2) as pool:
        prepared = [p for p in pool.map(prep_one, masks) if p is not None]
    LOG.info("prepared %d mask engines in %.1fs", len(prepared),
             time.perf_counter() - t_prep)

    use_screen = (engine_kind == "pallas" and args.prescreen == "on")
    sweep = None
    if engine_kind == "pallas" and prepared:
        from ..parallel.pallas_sweep import TwoPhaseSweep
        screen = None
        u_matrix = None
        thresholds = None
        if use_screen:
            from ..cds.prescreen import PairPrescreen
            first_eng = prepared[0][1]
            screen = PairPrescreen(zt9, args.xyShift,
                                   first_eng.tiles.height,
                                   first_eng.tiles.width)
            # one [B, F] feature matrix: bounds for ALL masks of a
            # partition are one matmul; uploaded once per device
            u_matrix = np.stack([screen.query_features(eng.planes.words)
                                 for _, eng in prepared])
            thresholds = np.array(
                [max(ratio_threshold * eng.tiles.query_size, 0.5)
                 for _, eng in prepared])
        # the production engine runs the SAME two-phase pipeline on every
        # local device (target shards); multi-process runs add a process
        # grid on top (reference parity: the same algorithm locally and
        # on the cluster, SparkColorMIPSearchProcessor.java:27-84)
        sweep = TwoPhaseSweep([eng for _, eng in prepared], screen,
                              u_matrix, thresholds)

    def _pallas_partition_scores(t_stack):
        """Two-phase scores for one target partition: [B, T] int64 +
        mirrored [B, T]. Multi-process runs sweep per-process target
        blocks and allgather the rows (one writer still persists)."""
        if not multi:
            return sweep.sweep(t_stack, stage_totals)
        import jax
        from jax.experimental import multihost_utils
        from ..parallel.pallas_sweep import device_blocks
        pc, pid = jax.process_count(), jax.process_index()
        blocks = device_blocks(t_stack.shape[0], pc)
        off, ln = blocks[pid]
        per = max((l for _, l in blocks), default=0)
        bsz = len(prepared)
        s = np.zeros((bsz, per), np.int64)
        m = np.zeros((bsz, per), np.int8)
        if ln:
            s_l, m_l = sweep.sweep(t_stack[off:off + ln], stage_totals)
            s[:, :ln] = s_l
            m[:, :ln] = m_l
        g_s, g_m = multihost_utils.process_allgather((s, m))
        out_s = np.zeros((bsz, t_stack.shape[0]), np.int64)
        out_m = np.zeros((bsz, t_stack.shape[0]), bool)
        for p, (o, l) in enumerate(blocks):
            out_s[:, o:o + l] = g_s[p][:, :l]
            out_m[:, o:o + l] = g_m[p][:, :l].astype(bool)
        return out_s, out_m

    def score_blocks(t_stack):
        """Yield (scores [B, T], mirrored [B, T], [(mask, query_size)])."""
        import jax
        if engine_kind == "pallas":
            t0 = time.perf_counter()
            scores, mirrored = _pallas_partition_scores(t_stack)
            stage_totals["score"] += time.perf_counter() - t0
            for bi_m, (mask, eng) in enumerate(prepared):
                yield (scores[bi_m][None], mirrored[bi_m][None],
                       [(mask, eng.tiles.query_size)])
        else:
            t0 = time.perf_counter()
            n_t_real = t_stack.shape[0]
            if multi:
                # pad targets to the global target axis so every chip
                # owns an equal shard
                from ..parallel.multihost import global_pair_mesh
                mesh = global_pair_mesh(mask_shards=1)
                nt = mesh.devices.shape[1]
                padt = (-n_t_real) % nt
                if padt:
                    t_stack = np.concatenate(
                        [t_stack, np.repeat(t_stack[-1:], padt, axis=0)])
            t_padded, t_flipped = pack_targets(
                jnp.asarray(t_stack), args.dataThreshold, pad)
            jax.block_until_ready((t_padded, t_flipped))
            if multi:
                t_padded = np.asarray(t_padded)
                t_flipped = np.asarray(t_flipped)
            stage_totals["pack"] += time.perf_counter() - t0
            for mask_block in partition_collection(prepared, args.maskBatchSize):
                t0 = time.perf_counter()
                # pad the final partial block to the fixed batch size so
                # the jitted kernel sees one static shape
                n_real = len(mask_block)
                padded_block = list(mask_block)
                while len(padded_block) < args.maskBatchSize:
                    padded_block.append(mask_block[-1])
                q_words_np = np.stack([qp.words for _, qp in padded_block])
                if multi:
                    # one jitted computation spanning every process's
                    # devices (SURVEY.md 2d-P2: the Spark-cluster
                    # replacement); scores gathered back to all hosts
                    from jax.experimental import multihost_utils
                    from jax.sharding import PartitionSpec as P
                    from ..parallel.multihost import distribute
                    from ..parallel.sweep import sharded_pixel_sweep
                    s_g, m_g, _ = sharded_pixel_sweep(
                        mesh,
                        distribute(mesh, P("mask", None, None), q_words_np),
                        distribute(mesh, P("target", None, None), t_padded),
                        distribute(mesh, P("target", None, None), t_flipped),
                        distribute(mesh, P(None, None), np.asarray(shifts)),
                        zt9, args.mirrorMask)
                    s = np.asarray(multihost_utils.process_allgather(
                        s_g, tiled=True))[:n_real, :n_t_real]
                    m = np.asarray(multihost_utils.process_allgather(
                        m_g, tiled=True))[:n_real, :n_t_real]
                else:
                    q_words = jnp.asarray(q_words_np)
                    s, m = local_pixel_sweep(
                        q_words, t_padded, t_flipped, shifts, zt9,
                        args.mirrorMask)
                    s, m = np.asarray(s)[:n_real], np.asarray(m)[:n_real]
                stage_totals["score"] += time.perf_counter() - t0
                yield (s, m,
                       [(mask, qp.query_size) for mask, qp in mask_block])

    # batched incremental flush to the DB backend
    # (ColorDepthSearchCmd.java:316-335 --write-batch-size; the grouped
    # JSON layout requires whole-mask files so the FS backend writes at
    # the end)
    flushed = 0

    def maybe_flush():
        nonlocal flushed
        if multi:
            import jax
            if jax.process_index() != 0:
                return  # one writer per fleet (reference: driver writes)
        if args.db and args.write_batch_size > 0 \
                and len(all_matches) - flushed >= args.write_batch_size:
            from .backends import matches_writer
            matches_writer(args.db, None, update_scores_only=args.update_matches).write(all_matches[flushed:])
            flushed = len(all_matches)
            _test_kill_hook()

    stage_totals = {"decode": 0.0, "pack": 0.0, "score": 0.0, "collect": 0.0}

    # decode prefetch: partition i+1's images decode on a host thread
    # while the device scores partition i (the reference overlaps decode
    # and compare inside one thread pool, CmdUtils.java:17-40; here the
    # device does the comparing so one look-ahead decode suffices)
    from concurrent.futures import ThreadPoolExecutor
    prefetcher = ThreadPoolExecutor(max_workers=1)

    def decode(part):
        return _load_target_images(part, cache,
                                   workers=args.cdsConcurrency or 8)

    def record_pair_errors(failed):
        """One error CDMatchEntity per (mask, failed target) pair so a
        bad image is persisted as a known-failed pair, never silently
        dropped (AbstractColorMIPSearchProcessor.java:80-83,
        LocalColorMIPSearchProcessor.java:106)."""
        for target, err in failed:
            for mask, _ in prepared:
                m = CDMatchEntity()
                m.mask_image = mask
                m.matched_image = target
                m.session_ref_id = str(session_id)
                m.match_found = False
                m.errors = err
                m.tags.add(run_tag)
                all_matches.append(m)

    pending_decode = None
    for pi, part in enumerate(target_parts):
        t0 = time.perf_counter()
        if pending_decode is None:
            t_imgs, t_entities, t_failed = decode(part)
        else:
            t_imgs, t_entities, t_failed = pending_decode.result()
        if pi + 1 < len(target_parts):
            pending_decode = prefetcher.submit(decode, target_parts[pi + 1])
        stage_totals["decode"] += time.perf_counter() - t0
        if t_failed:
            record_pair_errors(t_failed)
        if not t_imgs:
            maybe_flush()
            continue
        for scores_blk, mirrored_blk, block in score_blocks(np.stack(t_imgs)):
            for bi, (mask, query_size) in enumerate(block):
                qsize = max(query_size, 1)
                for ti, target in enumerate(t_entities):
                    pixels = int(scores_blk[bi, ti]) if query_size else 0
                    ratio = pixels / qsize if query_size else 0.0
                    # isMatch (ColorMIPSearch.java:42-46)
                    if not (pixels > 0 and ratio > ratio_threshold):
                        continue
                    m = CDMatchEntity()
                    m.mask_image = mask
                    m.matched_image = target
                    m.session_ref_id = str(session_id)
                    m.matching_pixels = pixels
                    m.matching_pixels_ratio = float(np.float32(ratio))
                    m.mirrored = bool(mirrored_blk[bi, ti])
                    m.match_found = True
                    m.tags.add(run_tag)
                    mask.add_processed_tag(ProcessingType.ColorDepthSearch, run_tag)
                    target.add_processed_tag(ProcessingType.ColorDepthSearch, run_tag)
                    all_matches.append(m)
        maybe_flush()
    prefetcher.shutdown(wait=False)

    n_groups = 0
    if multi:
        import jax
        if jax.process_index() != 0:
            LOG.info("process %d: results written by process 0",
                     jax.process_index())
            args = argparse.Namespace(**{**vars(args), "db": None,
                                         "output_dir": None})
    if args.db or args.output_dir:
        from .backends import matches_writer
        per_masks = (os.path.join(args.output_dir, args.perMaskSubdir)
                     if args.output_dir else None)
        per_targets = (os.path.join(args.output_dir, args.perTargetSubdir)
                       if args.output_dir and args.perTargetSubdir else None)
        writer = matches_writer(args.db, per_masks, per_targets,
                                update_scores_only=args.update_matches)
        if args.db and flushed:
            n_groups = writer.write(all_matches[flushed:]) if flushed < len(all_matches) else 0
        else:
            n_groups = writer.write(all_matches)
    if args.db:
        # stamp EVERY searched mip with the run's processing tag in the
        # store — matched or not — so restartable selection by
        # "lacks tag X" sees the whole processed block
        # (ColorDepthSearchCmd.java:346-358)
        from ..dataio.db import DBCDMIPsWriter
        from .backends import get_store
        DBCDMIPsWriter(get_store(args.db)).add_processing_tags(
            masks + targets, ProcessingType.ColorDepthSearch, {run_tag})
    LOG.info("stage times: %s",
             {k: round(v, 2) for k, v in stage_totals.items()})
    LOG.info("found %d matches (%d masks) in %.1fs",
             len(all_matches), n_groups, time.time() - t_start)
    return 0
