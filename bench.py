"""Benchmark: mask x target comparisons/s for the pixel-match sweep on
one CUDA GPU.

Production CDS configuration (cdsparams.sh:42-47): maskThreshold 20,
dataThreshold 20, xyShift 2 (9 shift variants), pixColorFluctuation 1,
mirror on — i.e. 18 scored variants per pair on full 1210x566 CDMs.
The reference publishes no benchmark numbers (BASELINE.md).

Prints one JSON line: {"metric", "value", "unit", "device"}, the device
as JAX reports it plus the card's power limit. Refuses to run without a
GPU: a CPU number is not a device metric.

Configs (argv[1]): default "twophase" (the production two-phase exact
search — prescreen bound pass + the exact active-tile kernel on the
survivors — over a synthetic diverse library built by rolling the
reference fixtures, which mimics real library diversity: most pairs
have no spatial overlap and are screened out, exactly as in
production). Also: "kernel" (raw exact pixel-match kernel, no screen),
"shape" (gradient re-rank kernel rate), "gradients" (end-to-end
gradientScores), "prescreen" (bound-pass rate alone).
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "tests", "fixtures", "cdsearch")


def _bench_shape():
    """Config 2 (BASELINE.md: gradient-score pass): shape/gradient
    re-ranking matches/s/chip, device-resident target planes."""
    import time
    import jax
    import jax.numpy as jnp
    from colormipsearch_tpu.imageproc import load_image, label_regions_mask
    from colormipsearch_tpu.cds.shape_oracle import (
        build_query_shape_planes, build_target_shape_planes)
    from colormipsearch_tpu.cds.shape_kernel import shape_score_kernel

    query = load_image(os.path.join(_FIXTURES, "ems", "12191_JRC2018U.tif"))
    excluded = label_regions_mask(query.height, query.width)
    qp = build_query_shape_planes(query, excluded)
    lms = sorted(os.listdir(os.path.join(_FIXTURES, "lms")))
    target = load_image(os.path.join(_FIXTURES, "lms", lms[0]))
    grad = load_image(os.path.join(
        _FIXTURES, "grad", lms[0].rsplit(".", 1)[0] + ".png"))
    tp = build_target_shape_planes(target, grad, None, 20, excluded)

    T = 64
    def rep(x):
        return jnp.asarray(np.broadcast_to(np.asarray(x)[None],
                                           (T,) + np.asarray(x).shape)).copy()
    r0, r1 = qp.active_row_range()
    crop = lambda x: x[:, r0:r1]
    args = [jnp.asarray(qp.q_nonzero[r0:r1]), jnp.asarray(qp.q_slice[r0:r1]),
            jnp.asarray(qp.q_mask[r0:r1]), jnp.asarray(qp.high_expr[r0:r1]),
            crop(rep(tp.grad)), crop(rep(tp.z_nonzero)),
            crop(rep(tp.z_slice)), crop(rep(tp.t_above))]
    jax.block_until_ready(args)
    out = shape_score_kernel(*args, mirror=True)
    jax.block_until_ready(out)
    best = 0.0
    for _ in range(5):
        t0 = time.perf_counter()
        jax.block_until_ready(shape_score_kernel(*args, mirror=True))
        best = max(best, T / (time.perf_counter() - t0))
    return {
        "metric": "shape/gradient re-rank kernel matches/s/chip (negativeRadius20+mirror, row-cropped, device-resident planes)",
        "value": round(best, 1),
        "unit": "matches/s",
    }


def _bench_gradients():
    """Config "gradients": END-TO-END shape/gradient re-ranking rate —
    matches/s/chip through the production gradientScores path: target
    CDM+grad decode (distinct files, thread-pool), shape-plane build,
    device upload, row-band-cropped kernel, score finish. This is the
    number the <1h full-precompute budget needs (the bare kernel rate in
    _bench_shape excludes decode/planes/upload)."""
    import argparse
    import shutil
    import tempfile
    import jax
    from colormipsearch_tpu.imageproc import load_image, label_regions_mask
    from colormipsearch_tpu.cds.shape_oracle import build_query_shape_planes
    from colormipsearch_tpu.cmd.gradientscores_cmd import score_mask_partitions
    from colormipsearch_tpu.model import (CDMatchEntity, ComputeFileType,
                                          EMNeuronEntity, FileData,
                                          LMNeuronEntity)
    from colormipsearch_tpu.mips import MIPsCache

    T = int(os.environ.get("CMS_BENCH_GRAD_T", "128"))
    lm_names = [n for n in sorted(os.listdir(os.path.join(_FIXTURES, "lms")))
                if os.path.exists(os.path.join(
                    _FIXTURES, "grad", n.rsplit(".", 1)[0] + ".png"))]
    tmp = tempfile.mkdtemp(prefix="cms_grad_bench_")
    try:
        matches = []
        em = EMNeuronEntity(entity_id=1, mip_id="em-1")
        em.compute_files[ComputeFileType.InputColorDepthImage] = \
            FileData.from_string(os.path.join(_FIXTURES, "ems",
                                              "12191_JRC2018U.tif"))
        for i in range(T):
            src = lm_names[i % len(lm_names)]
            stem = src.rsplit(".", 1)[0]
            cdm = os.path.join(tmp, f"t{i}.tif")
            grad = os.path.join(tmp, f"t{i}_grad.png")
            shutil.copy(os.path.join(_FIXTURES, "lms", src), cdm)
            shutil.copy(os.path.join(_FIXTURES, "grad", stem + ".png"),
                        grad)
            lm = LMNeuronEntity(entity_id=100 + i, mip_id=f"lm-{i}")
            lm.compute_files[ComputeFileType.InputColorDepthImage] = \
                FileData.from_string(cdm)
            lm.compute_files[ComputeFileType.GradientImage] = \
                FileData.from_string(grad)
            m = CDMatchEntity()
            m.mask_image, m.matched_image = em, lm
            matches.append(m)

        query = load_image(os.path.join(_FIXTURES, "ems",
                                        "12191_JRC2018U.tif"))
        excluded = label_regions_mask(query.height, query.width)
        qplanes = build_query_shape_planes(query, excluded)
        args = argparse.Namespace(
            maskThreshold=20, mirrorMask=True, computeZGapOnTheFly=True,
            targetsPerBatch=int(os.environ.get("CMS_GRAD_BATCH", "128")),
            queryROIMaskName=None)
        best = 0.0
        for rep in range(3):
            cache = MIPsCache(64)   # cold decode every rep (end-to-end)
            planes_cache = {}
            t0 = time.perf_counter()
            scored = score_mask_partitions(matches, qplanes, cache, args,
                                           excluded, planes_cache)
            dt = time.perf_counter() - t0
            assert len(scored) == T
            best = max(best, T / dt)
            _log(f"[gradients] rep{rep}: {dt:.2f}s "
                 f"rate={T / dt:,.0f} matches/s")
        golden = [m.gradient_area_gap for m in scored[:len(lm_names)]]
        _log(f"[gradients] gaps head: {golden}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {
        "metric": (f"end-to-end gradientScores matches/s/chip ({T} "
                   "targets, decode+planes+upload+kernel, "
                   "negativeRadius20+mirror, zgap-on-the-fly)"),
        "value": round(best, 1),
        "unit": "matches/s",
    }


def _bench_prescreen():
    """Config 3: prescreen bound-pass rate — (mask, target) pairs
    bounded per second (target features + bound matmul on device), the
    first phase of the production two-phase exact search."""
    import time
    import jax
    import numpy as np
    from colormipsearch_tpu.imageproc import load_image, label_regions_mask
    from colormipsearch_tpu.cds.active_tile import ActiveTilePixelEngine
    from colormipsearch_tpu.cds.prescreen import PairPrescreen
    from colormipsearch_tpu.cds.pixel_kernel import z_tolerance_to_zt9

    lms = sorted(os.listdir(os.path.join(_FIXTURES, "lms")))
    query = load_image(os.path.join(_FIXTURES, "ems", "12191_JRC2018U.tif"))
    excluded = label_regions_mask(query.height, query.width)
    engine = ActiveTilePixelEngine(query, 20, True, 20, 1.0, 2, excluded)
    B = int(os.environ.get("CMS_PRESCREEN_B", "64"))
    T = 256
    base = np.stack([load_image(os.path.join(_FIXTURES, "lms", n)).pixels
                     for n in lms])
    targets = np.tile(base, (T // len(base) + 1, 1, 1, 1))[:T]
    words = engine.pack_raw_words(targets)
    jax.block_until_ready(words)
    flipped = words[:, :, ::-1]

    screen = PairPrescreen(z_tolerance_to_zt9(1.0), 2,
                           engine.tiles.height, engine.tiles.width)
    u = np.broadcast_to(screen.query_features(engine.planes.words)[None],
                        (B, screen.query_features(engine.planes.words).shape[0])).copy()
    tfeats = screen.target_features(words, flipped)  # warm compile
    screen.bounds(u, tfeats)
    best = 0.0
    for _ in range(3):
        t0 = time.perf_counter()
        tfeats = screen.target_features(words, flipped)
        screen.bounds(u, tfeats)
        best = max(best, B * T / (time.perf_counter() - t0))
    return {
        "metric": f"prescreen bound pairs/s/chip ({B} masks x {T} targets, prod config)",
        "value": round(best, 1),
        "unit": "pairs/s",
    }


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def _bench_gradients_production():
    """Production-mode gradientScores number for the default bench
    detail: PRECOMPUTED zgap variant files
    (submitGAJob.sh:7-8 — production never dilates on the fly), warm
    plane cache across masks, plane build fanned over --planes-threads.
    Reports the warm END-TO-END match rate and the measured cold
    per-distinct-target host cost (the <1h budget's two inputs)."""
    import argparse
    import shutil
    import tempfile
    import numpy as np
    from colormipsearch_tpu.imageproc import load_image, label_regions_mask
    from colormipsearch_tpu.imageproc.io import write_tiff
    from colormipsearch_tpu.imageproc.filters import max_filter_rgb
    from colormipsearch_tpu.cds.shape_oracle import build_query_shape_planes
    from colormipsearch_tpu.cmd.gradientscores_cmd import score_mask_partitions
    from colormipsearch_tpu.model import (CDMatchEntity, ComputeFileType,
                                          EMNeuronEntity, FileData,
                                          LMNeuronEntity)
    from colormipsearch_tpu.mips import MIPsCache

    n_targets = int(os.environ.get("CMS_BENCH_GRAD_DISTINCT", "128"))
    n_masks = int(os.environ.get("CMS_BENCH_GRAD_MASKS", "4"))
    lm_names = [n for n in sorted(os.listdir(os.path.join(_FIXTURES, "lms")))
                if os.path.exists(os.path.join(
                    _FIXTURES, "grad", n.rsplit(".", 1)[0] + ".png"))]
    tmp = tempfile.mkdtemp(prefix="cms_grad_prod_")
    try:
        # distinct targets with PRECOMPUTED zgap files (10px dilation,
        # done once here exactly as the offline variant pipeline does)
        targets = []
        zgap_cache = {}
        for i in range(n_targets):
            src = lm_names[i % len(lm_names)]
            stem = src.rsplit(".", 1)[0]
            cdm = os.path.join(tmp, f"t{i}.tif")
            grad = os.path.join(tmp, f"t{i}_grad.png")
            zgap = os.path.join(tmp, f"t{i}_zgap.tif")
            shutil.copy(os.path.join(_FIXTURES, "lms", src), cdm)
            shutil.copy(os.path.join(_FIXTURES, "grad", stem + ".png"), grad)
            if src not in zgap_cache:
                px = load_image(cdm).pixels
                if px.ndim == 2:
                    px = np.repeat(px[..., None], 3, axis=2)
                zgap_cache[src] = max_filter_rgb(
                    np.ascontiguousarray(px[..., :3], dtype=np.uint8), 10)
            write_tiff(zgap, zgap_cache[src])
            lm = LMNeuronEntity(entity_id=100 + i, mip_id=f"lm-{i}")
            lm.compute_files[ComputeFileType.InputColorDepthImage] = \
                FileData.from_string(cdm)
            lm.compute_files[ComputeFileType.GradientImage] = \
                FileData.from_string(grad)
            lm.compute_files[ComputeFileType.ZGapImage] = \
                FileData.from_string(zgap)
            targets.append(lm)

        query = load_image(os.path.join(_FIXTURES, "ems",
                                        "12191_JRC2018U.tif"))
        excluded = label_regions_mask(query.height, query.width)
        qplanes = build_query_shape_planes(query, excluded)
        args = argparse.Namespace(
            maskThreshold=20, mirrorMask=True, computeZGapOnTheFly=False,
            targetsPerBatch=int(os.environ.get("CMS_GRAD_BATCH", "128")),
            queryROIMaskName=None, planes_threads=0)
        cache = MIPsCache(4096)
        planes_cache = {}

        def run_mask(mi):
            em = EMNeuronEntity(entity_id=1000 + mi, mip_id=f"em-{mi}")
            matches = []
            for t in targets:
                m = CDMatchEntity()
                m.mask_image, m.matched_image = em, t
                matches.append(m)
            t0 = time.perf_counter()
            scored = score_mask_partitions(matches, qplanes, cache, args,
                                           excluded, planes_cache)
            return len(scored), time.perf_counter() - t0

        # mask 0: cold pass INCLUDING one-time XLA compiles
        n0, cold_compile = run_mask(0)
        assert n0 == n_targets
        # second cold pass with fresh decode+plane caches but warm
        # compiles — the per-target cost production actually pays
        # (compiles amortize over 100K+ targets, not 24)
        cache = MIPsCache(4096)
        planes_cache.clear()
        n0, cold = run_mask(0)
        per_target_host = cold / n_targets
        # masks 1..n: warm passes (cache hits) -> end-to-end match rate
        warm_best = 0.0
        for mi in range(1, n_masks):
            n, dt = run_mask(mi)
            warm_best = max(warm_best, n / dt)
        _log(f"[grad-prod] cold {per_target_host*1e3:.0f} ms/target "
             f"(compile excluded; incl-compile pass "
             f"{cold_compile/n_targets*1e3:.0f} ms/target; precomputed "
             f"zgap, {os.cpu_count()} threads); warm "
             f"{warm_best:,.0f} matches/s")
        return {"gradient_matches_per_s": round(warm_best, 1),
                "gradient_cold_s_per_target": round(per_target_host, 4),
                "gradient_cold_incl_compile_s_per_target":
                    round(cold_compile / n_targets, 4)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _bench_twophase():
    """Headline config: the production two-phase exact search.

    TWO library variants are measured:
    - "adversarial" (the headline, conservative): rolled copies of the
      same 4 neurons as banded targets — coarse tile-space overlap with
      every mask, the worst case for the prescreen bound.
    - "realistic": masks AND targets are spatially-localized regional
      crops (different neurons occupy different brain regions, the
      production premise) — its survivor rate and rate are reported in
      the JSON detail next to the adversarial ones.
    Every surviving pair is scored EXACTLY by the active-tile kernel,
    and the prescreen's bound guarantees the screened-out pairs score
    below the production keep threshold (pctPositivePixels 1%), so
    results equal the exhaustive sweep."""
    B = int(os.environ.get("CMS_BENCH_B", "1024"))
    T = int(os.environ.get("CMS_BENCH_T", "512"))
    rounds = int(os.environ.get("CMS_BENCH_ROUNDS", "5"))
    best, best_stage, true_rate = _run_twophase_library(
        "adversarial", B, T, rounds)
    detail = {k: (round(v, 3) if isinstance(v, float) else v)
              for k, v in best_stage.items()}
    detail["true_match_rate"] = round(true_rate, 5)
    if os.environ.get("CMS_BENCH_REALISTIC", "1") == "1":
        r_best, r_stage, r_true = _run_twophase_library(
            "realistic", B, T, max(2, rounds - 2))
        detail["realistic"] = {
            "rate_pairs_per_s": round(r_best, 1),
            "survivor_rate": round(r_stage["survivor_rate"], 5),
            "true_match_rate": round(r_true, 5),
        }
    if os.environ.get("CMS_BENCH_GRAD_DETAIL", "1") == "1":
        detail.update(_bench_gradients_production())
    out = {
        "metric": (f"two-phase exact CDS pairs/s/chip ({B} masks x {T} "
                   "targets, prod config xyShift2+mirror+1% cut, "
                   "prescreen + active-tile kernel on the survivors; "
                   "value = ADVERSARIAL library, value_realistic = "
                   "regional-crop library)"),
        "value": round(best, 1),
        "unit": "pairs/s",
        # NB stage walls overlap the async device stream: "pack+screen"
        # includes device time serialized behind the queued exact
        # kernels, so it is NOT pure host pack cost (see ROADMAP)
        "detail": detail,
    }
    # both headline libraries as TOP-LEVEL value fields: the adversarial
    # and realistic numbers travel together
    if "realistic" in detail:
        out["value_realistic"] = detail["realistic"]["rate_pairs_per_s"]
    return out


def _run_twophase_library(kind: str, B: int, T: int, rounds: int):
    """Build one library variant and measure the two-phase sweep on it.
    Returns (best pairs/s, best stage dict, true match rate)."""
    import numpy as np
    from colormipsearch_tpu.imageproc import (Image, ImageKind, load_image,
                                              label_regions_mask)
    from colormipsearch_tpu.cds.active_tile import ActiveTilePixelEngine
    from colormipsearch_tpu.cds.prescreen import PairPrescreen
    from colormipsearch_tpu.cds.pixel_kernel import z_tolerance_to_zt9
    from colormipsearch_tpu.parallel.pallas_sweep import TwoPhaseSweep

    ems = sorted(os.listdir(os.path.join(_FIXTURES, "ems")))
    lms = sorted(os.listdir(os.path.join(_FIXTURES, "lms")))
    em_px = [load_image(os.path.join(_FIXTURES, "ems", n)).pixels
             for n in ems]
    lm_px = [load_image(os.path.join(_FIXTURES, "lms", n)).pixels
             for n in lms]
    h, w = em_px[0].shape[:2]
    excluded = label_regions_mask(h, w)

    # deterministic roll offsets; index 0 of each family is unrolled so
    # the reference golden pairs are present in the grid
    def roll(px, i):
        if i == 0:
            return px
        return np.roll(px, ((37 * i) % h, (151 * i) % w), axis=(0, 1))

    def band(px, i, bh=160, step=53):
        # keep one row band per rolled image (index 0 stays whole so the
        # golden pairs survive)
        if i == 0:
            return px
        b0 = (step * i) % (h - bh)
        out = np.zeros_like(px)
        out[b0:b0 + bh] = px[b0:b0 + bh]
        return out

    def mask_px(i):
        px = roll(em_px[i % len(em_px)], i // len(em_px))
        if kind == "realistic":
            # regional masks: a neuron occupies one part of the brain
            px = band(px, i, bh=224, step=71)
        return px

    def target_px(i):
        return band(roll(lm_px[i % len(lm_px)], i // len(lm_px)), i)

    t0 = time.perf_counter()
    engines = []
    for i in range(B):
        img = Image(kind=ImageKind.RGB, pixels=mask_px(i))
        engines.append(ActiveTilePixelEngine(img, 20, True, 20, 1.0, 2,
                                             excluded))
    _log(f"[twophase:{kind}] built {B} mask engines in "
         f"{time.perf_counter() - t0:.1f}s")
    targets = np.stack([target_px(i) for i in range(T)])

    screen = PairPrescreen(z_tolerance_to_zt9(1.0), 2, h, w)
    u_matrix = np.stack([screen.query_features(e.planes.words)
                         for e in engines])
    thr = np.maximum(
        0.01 * np.array([e.tiles.query_size for e in engines]), 0.5)
    sweep = TwoPhaseSweep(engines, screen, u_matrix, thr)

    # two-partition software pipeline: pack(p+1) under exact(p)
    TP = min(T, int(os.environ.get("CMS_BENCH_TPART", "256")))
    parts = [targets[i:i + TP] for i in range(0, T, TP)]

    def run_round():
        """Partition software pipeline: launch(p+1) — host pack and
        screen — overlaps the device's exact phase of p."""
        stage = {}
        scores, inflight = [], None
        for tgt in parts:
            nxt = sweep.launch(tgt, stage)
            if inflight is not None:
                t0 = time.perf_counter()
                scores.append(sweep.collect(inflight)[0])
                stage["drain"] = stage.get("drain", 0.0) \
                    + time.perf_counter() - t0
            inflight = nxt
        t0 = time.perf_counter()
        scores.append(sweep.collect(inflight)[0])
        stage["drain"] = stage.get("drain", 0.0) + time.perf_counter() - t0
        stage["survivor_rate"] = 1.0 - stage["screened"] / (B * T)
        return np.concatenate(scores, axis=1), stage

    scores, stage = run_round()  # warm-up / compile + golden check
    assert 439 in scores[0], ("golden score check failed", scores[0][:8])
    # screen tightness: fraction of pairs that TRULY pass the keep
    # threshold (survivor_rate - true_rate = the screen's slack)
    true_rate = float((scores > thr[:, None]).mean())
    _log(f"[twophase:{kind}] true match rate "
         f"{true_rate:.3%} vs survivors {stage['survivor_rate']:.3%}")
    best = 0.0
    best_stage = stage
    for _ in range(rounds):
        t0 = time.perf_counter()
        _, stage = run_round()
        dt = time.perf_counter() - t0
        if B * T / dt > best:
            best = B * T / dt
            best_stage = stage
        _log(f"[twophase:{kind}] round {dt:.2f}s  "
             f"pack+screen={stage['pack+screen']:.2f} "
             f"launch={stage['launch']:.2f} drain={stage['drain']:.2f} "
             f"survivors={stage['survivor_rate']:.3%} "
             f"rate={B * T / dt:,.0f} pairs/s")
    return best, best_stage, true_rate


def _device():
    """The device record every result carries; exits without a GPU."""
    import jax
    d = jax.devices()[0]
    if d.platform != "gpu":
        sys.exit(f"bench.py measures a CUDA GPU; JAX runs on {d.platform!r}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices()),
            "power_limit": smi.strip().splitlines()[0].split(",")[-1].strip()}


def main():
    from colormipsearch_tpu.utils.compile_cache import configure_compile_cache
    configure_compile_cache()
    device = _device()
    _log(f"[bench] device: {device}")
    config = sys.argv[1] if len(sys.argv) > 1 else "twophase"
    bench = {"twophase": _bench_twophase, "shape": _bench_shape,
             "gradients": _bench_gradients, "prescreen": _bench_prescreen,
             "kernel": _bench_kernel}[config]
    print(json.dumps({**bench(), "device": device}))


def _bench_kernel():
    """Config "kernel": the exact active-tile kernel alone, one mask
    against every fixture-tiled target (no screen)."""
    import jax
    from colormipsearch_tpu.imageproc import load_image, label_regions_mask
    from colormipsearch_tpu.cds.active_tile import ActiveTilePixelEngine

    fixtures = _FIXTURES
    lms = sorted(os.listdir(os.path.join(fixtures, "lms")))

    query = load_image(os.path.join(fixtures, "ems", "12191_JRC2018U.tif"))
    excluded = label_regions_mask(query.height, query.width)
    engine = ActiveTilePixelEngine(query, 20, True, 20, 1.0, 2, excluded)

    base = np.stack([load_image(os.path.join(fixtures, "lms", n)).pixels
                     for n in lms])
    T = 256
    targets = np.tile(base, (T // len(base) + 1, 1, 1, 1))[:T]

    packed = engine.prepare_targets(targets)
    jax.block_until_ready(packed)

    # warm up / compile + golden check (EM 12191 vs the fixture targets)
    scores, _, _ = engine.score_packed(packed)
    assert 439 in scores, "golden score check failed"

    # steady-state measurement
    best_rate = 0.0
    for _ in range(5):
        t0 = time.perf_counter()
        engine.score_packed(packed)
        dt = time.perf_counter() - t0
        best_rate = max(best_rate, T / dt)

    return {
        "metric": "pixel-match comparisons/s/chip (prod config: xyShift2+mirror, 1210x566, active-tile kernel)",
        "value": round(best_rate, 1),
        "unit": "pairs/s",
    }


if __name__ == "__main__":
    sys.exit(main())
