#!/usr/bin/env python
"""--array-cache re-run cold-path measurement.

The gradient phase's cold cost is host decode per distinct target
(not measured on the GPU host yet). `--array-cache DIR`
hangs a PackedArrayStore off MIPsCache (cmd/gradientscores_cmd.py:150-
154): the first run ingests every decoded compute file as .npy; RE-runs
then load memory-mapped arrays instead of decoding TIFF/PNG — the
role CachedMIPsUtils.java:19-112 plays in the reference's steady state.

This script measures, on one process with warm XLA compiles:
  1. cold, no cache        — the baseline decode-bound path
  2. cold, populating      — first --array-cache run (ingest writes)
  3. cold, RE-RUN          — second --array-cache run (the
                             steady-state number)
and verifies variant coverage: all three compute file types (CDM,
gradient, zgap) of every distinct target appear in the store.

Usage: python scripts/profile_array_cache.py [n_targets]
Prints one JSON line.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
FIXTURES = os.path.join(REPO, "tests", "fixtures", "cdsearch")


def main() -> None:
    import numpy as np
    from PIL import Image as PILImage
    from colormipsearch_tpu.imageproc import load_image, label_regions_mask
    from colormipsearch_tpu.imageproc.filters import max_filter_rgb
    from colormipsearch_tpu.imageproc.store import PackedArrayStore
    from colormipsearch_tpu.cds.shape_oracle import build_query_shape_planes
    from colormipsearch_tpu.cmd.gradientscores_cmd import \
        score_mask_partitions
    from colormipsearch_tpu.model import (CDMatchEntity, ComputeFileType,
                                          EMNeuronEntity, FileData,
                                          LMNeuronEntity)
    from colormipsearch_tpu.mips import MIPsCache

    n_targets = int(sys.argv[1]) if len(sys.argv) > 1 else 128
    lm_names = [n for n in sorted(os.listdir(os.path.join(FIXTURES, "lms")))
                if os.path.exists(os.path.join(
                    FIXTURES, "grad", n.rsplit(".", 1)[0] + ".png"))]
    tmp = tempfile.mkdtemp(prefix="cms_acache_")
    try:
        targets = []
        zgap_cache = {}
        for i in range(n_targets):
            src = lm_names[i % len(lm_names)]
            stem = src.rsplit(".", 1)[0]
            cdm = os.path.join(tmp, f"t{i}.tif")
            grad = os.path.join(tmp, f"t{i}_grad.png")
            zgap = os.path.join(tmp, f"t{i}_zgap.tif")
            shutil.copy(os.path.join(FIXTURES, "lms", src), cdm)
            shutil.copy(os.path.join(FIXTURES, "grad", stem + ".png"), grad)
            if src not in zgap_cache:
                px = load_image(cdm).pixels
                if px.ndim == 2:
                    px = np.repeat(px[..., None], 3, axis=2)
                zgap_cache[src] = max_filter_rgb(
                    np.ascontiguousarray(px[..., :3], dtype=np.uint8), 10)
            PILImage.fromarray(zgap_cache[src]).save(zgap)
            lm = LMNeuronEntity(entity_id=100 + i, mip_id=f"lm-{i}")
            lm.compute_files[ComputeFileType.InputColorDepthImage] = \
                FileData.from_string(cdm)
            lm.compute_files[ComputeFileType.GradientImage] = \
                FileData.from_string(grad)
            lm.compute_files[ComputeFileType.ZGapImage] = \
                FileData.from_string(zgap)
            targets.append(lm)

        query = load_image(os.path.join(FIXTURES, "ems",
                                        "12191_JRC2018U.tif"))
        excluded = label_regions_mask(query.height, query.width)
        qplanes = build_query_shape_planes(query, excluded)
        args = argparse.Namespace(
            maskThreshold=20, mirrorMask=True, computeZGapOnTheFly=False,
            targetsPerBatch=128, queryROIMaskName=None, planes_threads=0)

        def run_pass(cache):
            em = EMNeuronEntity(entity_id=1000, mip_id="em-0")
            matches = []
            for t in targets:
                m = CDMatchEntity()
                m.mask_image, m.matched_image = em, t
                matches.append(m)
            t0 = time.perf_counter()
            scored = score_mask_partitions(matches, qplanes, cache, args,
                                           excluded, {})
            assert len(scored) == n_targets
            return (time.perf_counter() - t0) / n_targets * 1e3, \
                [(m.gradient_area_gap, m.high_expression_area)
                 for m in scored]

        # warm the XLA compiles (excluded from every number, as in
        # bench.py's gradient detail — compiles amortize in production)
        run_pass(MIPsCache(4096))

        cold_ms, ref_scores = run_pass(MIPsCache(4096))
        store_dir = os.path.join(tmp, "acache")
        pop_ms, pop_scores = run_pass(
            MIPsCache(4096, array_store=PackedArrayStore(store_dir)))
        n_entries = len([f for f in os.listdir(store_dir)
                         if f.endswith(".npy")])
        rerun_ms, rerun_scores = run_pass(
            MIPsCache(4096, array_store=PackedArrayStore(store_dir)))
        assert pop_scores == ref_scores and rerun_scores == ref_scores, \
            "array-cache path changed scores"
        # variant coverage: CDM + gradient + zgap per distinct target
        assert n_entries == 3 * n_targets, \
            f"expected {3 * n_targets} store entries, found {n_entries}"
        print(json.dumps({
            "n_targets": n_targets,
            "cold_ms_per_target_no_cache": round(cold_ms, 1),
            "cold_ms_per_target_populating": round(pop_ms, 1),
            "cold_ms_per_target_rerun": round(rerun_ms, 1),
            "rerun_speedup_vs_cold": round(cold_ms / rerun_ms, 2),
            "store_entries": n_entries,
            "scores_bit_identical": True,
        }))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
