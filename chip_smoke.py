#!/usr/bin/env python3
"""On-card smoke test: the production pipeline on one CUDA GPU, checked.

    python chip_smoke.py              # phases 0-4 on one card
    python chip_smoke.py --chips 4    # phase 0 + the four-card phase 5

Runs in ONE process (a JAX process reserves most of a card's memory) and
stops at the first failure with a non-zero exit code. Phases:

0. Card: `nvidia-smi` name and power limit (read by a child process that
   does not use JAX), JAX's platform must be "gpu", the compile cache.
1. Goldens through the CLI (`cmd.main.main`, --engine auto) on the
   fixtures: colorDepthSearch -> gradientScores -> normalize -> export
   (pixel 439/426/414, gaps 21365/40696/33884, normalized 100/97.04/
   94.31), then the engine-level goldens 87/439/414/515/483/426.
2. A seeded library at production scale (128 masks x 512 targets,
   1210x566, rolled/banded from the fixture frames, written as TIFFs)
   through colorDepthSearch (partitions of 256) and gradientScores (top
   300 lines per mask) into one SQLite store; stored scores are checked
   against the NumPy oracles, and one whole partition against the dense
   XLA engine.
3. The kernel decision: the Triton kernel against its plain-XLA version
   on the same survivor list, both timed after warm-up.
4. The tests marked `chip`, in this process.
5. (--chips 4 only) the phase-2 library on four cards and on one:
   bit-identical scores, outputs on four distinct devices.

The last line of standard output is one JSON object,
{"ok": true, "device": {"platform", "kind", "count"}}; everything else
goes on earlier lines. Work files (about 2 GB of TIFFs) go to --workdir,
by default a temporary directory that is removed at the end.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sqlite3
import subprocess
import sys
import tempfile
import time

import numpy as np

# The library: a production partition holds 100-500 targets.
N_MASKS, N_TARGETS, PARTITION = 128, 512, 256
ORACLE_PAIRS, SHAPE_PAIRS = 96, 24

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "tests", "fixtures", "cdsearch")
CDS_ARGS = ["--maskThreshold", "20", "--dataThreshold", "20",
            "--pixColorFluctuation", "1", "--xyShift", "2", "--mirrorMask",
            "--pctPositivePixels", "1"]
LM_NAMES = [
    "VT033614_127B01_AE_01-20171124_64_H6-f-CH2_01",
    "BJD_127B01_AE_01-20171124_64_H6-40x-Brain-JRC2018_Unisex_20x_HR-2483089192251293794-CH2-01_CDM",
    "VT016795_115C08_AE_01-20200221_61_I2-m-CH1_01",
]
EM_NAME = "12191_JRC2018U"


def log(msg):
    print(msg, flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def stage(name):
    """Context manager printing a stage's wall time."""
    class _S:
        def __enter__(self):
            self.t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            self.dt = time.perf_counter() - self.t0
            if exc[0] is None:
                log(f"  {name}: {self.dt:.2f} s")
    return _S()


def write_entities(path, entities):
    from colormipsearch_tpu.dataio import JSONCDMIPsWriter
    w = JSONCDMIPsWriter(path)
    w.open()
    w.write(entities)
    w.close()


# --- phase 0 -----------------------------------------------------------

def phase0_card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    for line in smi.splitlines():
        log(f"card: {line}")
    import jax
    from colormipsearch_tpu.utils.compile_cache import configure_compile_cache
    devices = jax.devices()
    check(devices[0].platform == "gpu",
          f"JAX runs on {devices[0].platform!r}, not on a GPU")
    log(f"jax {jax.__version__}: {len(devices)} x {devices[0].device_kind}")
    log(f"compile cache: {configure_compile_cache()}")
    return smi.splitlines()[0]


# --- phase 1 -----------------------------------------------------------

def fixture_workspace(ws):
    """masks.json / targets.json over the golden fixtures (the layout of
    tests/test_cli_e2e.py::workspace)."""
    from colormipsearch_tpu.model import (ComputeFileType, EMNeuronEntity,
                                          FileData, Gender, LMNeuronEntity)
    em = EMNeuronEntity(entity_id=1001, mip_id="em-12191",
                        alignment_space="JRC2018_Unisex_20x_HR",
                        library_name="flyem_test", published_name="12191")
    em.compute_files[ComputeFileType.InputColorDepthImage] = \
        FileData.from_string(os.path.join(FIXTURES, "ems", f"{EM_NAME}.tif"))
    targets = []
    for i, name in enumerate(LM_NAMES):
        lm = LMNeuronEntity(entity_id=2001 + i, mip_id=f"lm-{i}",
                            alignment_space="JRC2018_Unisex_20x_HR",
                            library_name="flylight_test",
                            published_name=name.split("_")[0],
                            slide_code=f"sc-{i}", anatomical_area="Brain",
                            gender=Gender.f, objective="40x")
        files = {ComputeFileType.InputColorDepthImage: ("lms", ".tif"),
                 ComputeFileType.GradientImage: ("grad", ".png"),
                 ComputeFileType.ZGapImage: ("zgap", ".tif")}
        for ft, (sub, ext) in files.items():
            p = os.path.join(FIXTURES, sub, name + ext)
            if os.path.exists(p):
                lm.compute_files[ft] = FileData.from_string(p)
        targets.append(lm)
    write_entities(os.path.join(ws, "masks.json"), [em])
    write_entities(os.path.join(ws, "targets.json"), targets)


def phase1_goldens(work):
    from colormipsearch_tpu.cmd.main import main
    ws = os.path.join(work, "fixtures")
    os.makedirs(ws, exist_ok=True)
    fixture_workspace(ws)
    out = os.path.join(ws, "cdsresults")
    per_mask = os.path.join(out, "masks")
    result = os.path.join(per_mask, "em-12191.json")

    def results():
        with open(result) as f:
            return {r["image"]["mipId"]: r for r in json.load(f)["results"]}

    with stage("colorDepthSearch"):
        check(main(["colorDepthSearch", "-m", os.path.join(ws, "masks.json"),
                    "-i", os.path.join(ws, "targets.json"), *CDS_ARGS,
                    "--engine", "auto", "-od", out]) == 0, "cds rc")
    r = results()
    pix = [r[f"lm-{i}"]["matchingPixels"] for i in (0, 2, 1)]
    log(f"  pixel scores {pix} (want [439, 426, 414])")
    check(pix == [439, 426, 414] and r["lm-2"]["mirrored"] is True
          and r["lm-0"]["mirrored"] is False, "pixel goldens")
    with stage("gradientScores"):
        check(main(["gradientScores", "-md", per_mask, "--maskThreshold",
                    "20", "--mirrorMask", "--computeZGapOnTheFly"]) == 0,
              "ga rc")
    r = results()
    gaps = [r[f"lm-{i}"]["gradientAreaGap"] for i in (0, 2, 1)]
    log(f"  shape gaps {gaps} (want [21365, 40696, 33884])")
    check(gaps == [21365, 40696, 33884], "shape goldens")
    with stage("normalizeGradientScores"):
        check(main(["normalizeGradientScores", "-md", per_mask]) == 0,
              "normalize rc")
    r = results()
    norm = [round(r[f"lm-{i}"]["normalizedScore"], 2) for i in (0, 2, 1)]
    log(f"  normalized {norm} (want [100.0, 97.04, 94.31])")
    check(norm == [100.0, 97.04, 94.31], "normalized goldens")
    export = os.path.join(ws, "export")
    with stage("exportData"):
        check(main(["exportData", "--exported-result-type", "EM_CD_MATCHES",
                    "-md", per_mask, "-od", export]) == 0, "export rc")
    with open(os.path.join(export, "em-12191.json")) as f:
        exported = [x["normalizedScore"] for x in json.load(f)["results"]]
    check(exported == sorted(exported, reverse=True) and len(exported) == 3,
          "export order")
    engine_goldens()


def engine_goldens():
    """The reference's JUnit pixel goldens, scored by the production
    engine on the card."""
    from colormipsearch_tpu.cds.factory import create_pixel_match_engine
    from colormipsearch_tpu.imageproc import label_regions_mask, load_image
    lm = {n.split("_")[0]: os.path.join(FIXTURES, "lms", n)
          for n in os.listdir(os.path.join(FIXTURES, "lms"))}
    em = os.path.join(FIXTURES, "ems")
    cases = [  # (query, excluded regions, target, score, mirrored)
        ("1752016801-LPLC2-RT_18U.tif", "custom", lm["GMR"], 87, False),
        (f"{EM_NAME}.tif", "labels", lm["VT033614"], 439, False),
        (f"{EM_NAME}.tif", "labels", lm["BJD"], 414, False),
        (f"{EM_NAME}_FL.tif", "labels", lm["VT033614"], 515, False),
        (f"{EM_NAME}_FL.tif", "labels", lm["VT016795"], 483, False),
        (f"{EM_NAME}.tif", "labels", lm["VT016795"], 426, True)]
    got = []
    for qname, region, tpath, want, mirrored in cases:
        query = load_image(os.path.join(em, qname))
        h, w = query.shape
        if region == "custom":  # PixelMatchColorDepthSearchAlgorithmTest
            ys, xs = np.mgrid[0:h, 0:w]
            excluded = ((xs >= w - 260) & (ys < 90)) | ((xs < 330) & (ys < 100))
        else:
            excluded = label_regions_mask(h, w)
        eng = create_pixel_match_engine(
            query, 20, True, 20, 1.0, 2, excluded=excluded, engine="auto")
        s, _, m = eng.score_batch(load_image(tpath).pixels[None])
        got.append(int(s[0]))
        check(int(s[0]) == want and bool(m[0]) == mirrored,
              f"engine golden {qname} x {os.path.basename(tpath)}: "
              f"{int(s[0])} mirrored={bool(m[0])}, want {want}")
    log(f"  engine goldens {got} ({type(eng).__name__})")


# --- phase 2 -----------------------------------------------------------

class Library:
    """Seeded masks x targets at the fixtures' 1210x566, rolled and
    banded from the fixture frames (index 0 of each family unrolled, so
    the golden pairs are in the grid)."""

    def __init__(self, seed, n_masks, n_targets):
        from colormipsearch_tpu.imageproc import label_regions_mask, load_image
        rng = np.random.default_rng(seed)
        ems = sorted(os.listdir(os.path.join(FIXTURES, "ems")))
        em_px = [load_image(os.path.join(FIXTURES, "ems", n)).pixels
                 for n in ems]
        lm_px = [load_image(os.path.join(FIXTURES, "lms", n + ".tif")).pixels
                 for n in LM_NAMES]
        grad_px = [load_image(os.path.join(FIXTURES, "grad", n + ".png")
                              ).pixels for n in LM_NAMES]
        self.h, self.w = em_px[0].shape[:2]
        self.excluded = label_regions_mask(self.h, self.w)
        h, w = self.h, self.w

        def roll(px, i, dy, dx):
            return px if i == 0 else np.roll(px, (dy, dx), axis=(0, 1))

        self.masks = []
        for i in range(n_masks):
            dy, dx = rng.integers(0, h), rng.integers(0, w)
            self.masks.append(roll(em_px[i % len(em_px)], i // len(em_px),
                                   dy, dx))
        self.targets, self.grads = [], []
        for j in range(n_targets):
            k = j % len(lm_px)
            dy, dx = rng.integers(0, h), rng.integers(0, w)
            bh = int(rng.integers(120, 240))
            b0 = int(rng.integers(0, h - bh))
            t = roll(lm_px[k], j // len(lm_px), dy, dx)
            g = roll(grad_px[k], j // len(lm_px), dy, dx)
            if j >= len(lm_px):  # one row band per rolled target
                band = np.zeros(h, bool)
                band[b0:b0 + bh] = True
                t = np.where(band[:, None, None], t, 0).astype(np.uint8)
                g = np.where(band[:, None], g, 0).astype(np.uint16)
            self.targets.append(t)
            self.grads.append(g)
        self.targets = np.stack(self.targets)

    def write(self, ws):
        """TIFF files + masks.json / targets.json for the CLI."""
        from colormipsearch_tpu.imageproc.io import write_tiff
        from colormipsearch_tpu.model import (ComputeFileType, EMNeuronEntity,
                                              FileData, LMNeuronEntity)
        os.makedirs(os.path.join(ws, "img"), exist_ok=True)
        ems, lms = [], []
        for i, px in enumerate(self.masks):
            p = os.path.join(ws, "img", f"m{i}.tif")
            write_tiff(p, px)
            e = EMNeuronEntity(entity_id=100_000 + i, mip_id=f"m{i}",
                               alignment_space="JRC2018_Unisex_20x_HR",
                               library_name="smoke_em",
                               published_name=f"em{i}")
            e.compute_files[ComputeFileType.InputColorDepthImage] = \
                FileData.from_string(p)
            ems.append(e)
        for j, (px, g) in enumerate(zip(self.targets, self.grads)):
            p = os.path.join(ws, "img", f"t{j}.tif")
            pg = os.path.join(ws, "img", f"t{j}_grad.tif")
            write_tiff(p, px)
            write_tiff(pg, g)
            e = LMNeuronEntity(entity_id=200_000 + j, mip_id=f"t{j}",
                               alignment_space="JRC2018_Unisex_20x_HR",
                               library_name="smoke_lm",
                               published_name=f"line{j}",
                               slide_code=f"s{j}", anatomical_area="Brain")
            e.compute_files[ComputeFileType.InputColorDepthImage] = \
                FileData.from_string(p)
            e.compute_files[ComputeFileType.GradientImage] = \
                FileData.from_string(pg)
            lms.append(e)
        write_entities(os.path.join(ws, "masks.json"), ems)
        write_entities(os.path.join(ws, "targets.json"), lms)

    def sweep(self, devices=None):
        """The library-level two-phase sweep (what the CLI runs)."""
        from colormipsearch_tpu.cds.active_tile import ActiveTilePixelEngine
        from colormipsearch_tpu.cds.pixel_kernel import z_tolerance_to_zt9
        from colormipsearch_tpu.cds.prescreen import PairPrescreen
        from colormipsearch_tpu.imageproc.io import image_from_array
        from colormipsearch_tpu.parallel.pallas_sweep import TwoPhaseSweep
        engines = [ActiveTilePixelEngine(image_from_array(px), 20, True, 20,
                                         1.0, 2, self.excluded)
                   for px in self.masks]
        screen = PairPrescreen(z_tolerance_to_zt9(1.0), 2, self.h, self.w)
        u = np.stack([screen.query_features(e.planes.words) for e in engines])
        thr = np.maximum(0.01 * np.array([e.tiles.query_size
                                          for e in engines]), 0.5)
        return TwoPhaseSweep(engines, screen, u, thr, devices=devices)


def read_store(db):
    """{(mask mipId, target mipId): (pixels, mirrored, gap, high expr)}."""
    con = sqlite3.connect(db)
    rows = con.execute(
        "SELECT a.mip_id, b.mip_id, m.matching_pixels, m.mirrored, "
        "m.gradient_area_gap, m.high_expression_area FROM cd_matches m "
        "JOIN neuron_metadata a ON a.entity_id = m.mask_ref "
        "JOIN neuron_metadata b ON b.entity_id = m.matched_ref").fetchall()
    con.close()
    return {(r[0], r[1]): (r[2], bool(r[3]), r[4], r[5]) for r in rows}


def phase2_library(work, lib, card):
    from colormipsearch_tpu.cds.oracle import PixelMatchOracle
    from colormipsearch_tpu.cds.shape_oracle import ShapeScoreOracle
    from colormipsearch_tpu.cmd.main import main
    from colormipsearch_tpu.imageproc.io import image_from_array
    ws = os.path.join(work, "library")
    shutil.rmtree(ws, ignore_errors=True)
    os.makedirs(ws)
    B, T = len(lib.masks), len(lib.targets)
    log(f"  library: {B} masks x {T} targets at {lib.w}x{lib.h} = "
        f"{B * T} pairs, partitions of {PARTITION} ({card})")
    with stage("write TIFFs"):
        lib.write(ws)
    db = os.path.join(ws, "store.db")
    masks, targets = (os.path.join(ws, "masks.json"),
                      os.path.join(ws, "targets.json"))
    with stage("colorDepthSearch --engine auto") as s_cds:
        check(main(["colorDepthSearch", "-m", masks, "-i", targets,
                    *CDS_ARGS, "--engine", "auto", "--processingPartitionSize",
                    str(PARTITION), "--db", db]) == 0, "cds rc")
    log(f"  colorDepthSearch: {B * T / s_cds.dt:.0f} pairs/s end to end "
        f"incl. decode and compile ({card})")
    with stage("gradientScores (top 300 lines)"):
        check(main(["gradientScores", "--db", db, "--maskThreshold", "20",
                    "--mirrorMask", "--nBestLines", "300",
                    "--computeZGapOnTheFly"]) == 0, "ga rc")
    store = read_store(db)
    n_ga = sum(v[2] is not None for v in store.values())
    log(f"  stored matches {len(store)}, gradient-scored {n_ga}")
    check(n_ga > 0, "no gradient scores stored")

    sweep = lib.sweep()
    with stage("library-level two-phase sweep (first call)"):
        sweep.sweep(lib.targets)
    stage_t = {}
    with stage("library-level two-phase sweep (warm)"):
        scores, mirrored = sweep.sweep(lib.targets, stage_t)
    survivors = 1.0 - stage_t["screened"] / (B * T)
    log(f"  survivor share {survivors:.4f} of {B * T} pairs; stage walls "
        f"{ {k: round(v, 3) for k, v in stage_t.items()} }")

    # stored scores vs the f64 oracle: stored pairs, pairs the screen
    # rejected, and random pairs
    thr = 0.01
    rng = np.random.default_rng(1)
    keys = sorted(store)
    screened = np.argwhere(scores == 0)
    picks = [(int(k[0][1:]), int(k[1][1:]))
             for k in (keys[i] for i in rng.choice(
                 len(keys), min(ORACLE_PAIRS // 2, len(keys)), replace=False))]
    picks += [tuple(map(int, screened[i])) for i in rng.choice(
        len(screened), min(ORACLE_PAIRS // 4, len(screened)), replace=False)]
    picks += [(int(rng.integers(B)), int(rng.integers(T)))
              for _ in range(ORACLE_PAIRS - len(picks))]
    oracles = {}
    with stage(f"pixel oracle on {len(picks)} pairs"):
        for mi, tj in picks:
            if mi not in oracles:
                oracles[mi] = PixelMatchOracle(
                    image_from_array(lib.masks[mi]), 20, True, 20, 0.01, 2,
                    lib.excluded)
            want = oracles[mi].score(image_from_array(lib.targets[tj]))
            match = (want.matching_pixels > 0
                     and want.matching_pixels_ratio > thr)
            got = store.get((f"m{mi}", f"t{tj}"))
            if match:
                check(got is not None and got[0] == want.matching_pixels
                      and got[1] == want.mirrored,
                      f"pair m{mi} t{tj}: stored {got}, oracle {want}")
            else:
                check(got is None, f"pair m{mi} t{tj} stored {got} but "
                                   f"the oracle says no match {want}")
    n_rej = sum(1 for p in picks if scores[p] == 0)
    log(f"  stored pixel scores == cds/oracle.py on {len(picks)} pairs "
        f"({n_rej} rejected by the screen)")

    # one whole partition: dense XLA engine == two-phase engine
    dense_db = os.path.join(ws, "dense.db")
    with stage(f"colorDepthSearch --engine dense, {PARTITION} targets"):
        check(main(["colorDepthSearch", "-m", masks, "-i", targets,
                    *CDS_ARGS, "--engine", "dense", "--targets-length",
                    str(PARTITION), "--db", dense_db]) == 0, "dense rc")
    dense = {k: v[:2] for k, v in read_store(dense_db).items()}
    part = {k: v[:2] for k, v in store.items()
            if int(k[1][1:]) < PARTITION}
    check(dense == part, f"dense vs two-phase: {len(dense)} vs {len(part)} "
                         f"matches, {len(set(dense) ^ set(part))} differ")
    log(f"  partition 0: dense engine == two-phase engine on {B} x "
        f"{PARTITION} pairs ({len(part)} matches, bit-identical)")

    # stored gradient scores vs the shape oracle
    ga_keys = [k for k in keys if store[k][2] is not None]
    n_shape = min(SHAPE_PAIRS, len(ga_keys))
    with stage(f"shape oracle on {n_shape} matches"):
        for i in rng.choice(len(ga_keys), n_shape, replace=False):
            k = ga_keys[i]
            mi, tj = int(k[0][1:]), int(k[1][1:])
            want = ShapeScoreOracle(
                image_from_array(lib.masks[mi]), 20, True, lib.excluded
            ).score(image_from_array(lib.targets[tj]),
                    image_from_array(lib.grads[tj]), None)
            check(store[k][2:] == (want.gradient_area_gap,
                                   want.high_expression_area),
                  f"{k}: stored {store[k][2:]}, oracle {want}")
    log(f"  stored gradient scores == cds/shape_oracle.py on {n_shape} "
        f"matches")
    return sweep


# --- phase 3 -----------------------------------------------------------

def phase3_kernel(lib, sweep, card):
    """The Triton kernel against the plain-XLA gather version on the
    survivors of the first partition; both are the same computation."""
    import jax
    import jax.numpy as jnp
    from colormipsearch_tpu.cds import active_tile as at
    sc = sweep.scorer
    eng = sweep.engines[0]
    words = eng.pack_raw_words(lib.targets[:PARTITION])
    packed = eng.pad_from_words(words)
    bounds = sweep.screen.bounds_from_words(sweep.u_matrix, words)
    pairs = np.argwhere(bounds > sweep.thresholds[:, None])
    log(f"  {len(pairs)} survivors of {bounds.size} pairs")
    table = sc.table()
    kw = dict(shifts=sc.shifts, pad=sc.pad, zt9=sc.zt9, mirror=sc.mirror)
    padded = jnp.asarray(sc.pad_pairs(pairs))
    chunk = 256
    chunks = [jnp.asarray(sc.pad_pairs(pairs[i:i + chunk]))
              for i in range(0, len(pairs), chunk)]

    def kernel():
        return at.tile_sums(padded, *table, *packed, interpret=False, **kw)

    def plain():
        return [at.tile_sums_xla(c, *table, *packed, k_max=sc.k_max, **kw)
                for c in chunks]

    def timed(f, n=5):
        jax.block_until_ready(f())
        ts = []
        for _ in range(n):
            t0 = time.perf_counter()
            jax.block_until_ready(f())
            ts.append(time.perf_counter() - t0)
        return min(ts), float(np.median(ts))

    got = np.asarray(kernel())[:len(pairs)]
    want = np.concatenate([np.asarray(o)[:len(pairs[i * chunk:
                                                    (i + 1) * chunk])]
                           for i, o in enumerate(plain())])
    check(np.array_equal(got, want), "kernel != XLA version")
    tk, tx = timed(kernel), timed(plain)
    log(f"  Triton kernel: {tk[0] * 1e3:.2f} ms (median {tk[1] * 1e3:.2f}) "
        f"= {len(pairs) / tk[0]:.0f} survivor pairs/s ({card})")
    log(f"  plain XLA    : {tx[0] * 1e3:.2f} ms (median {tx[1] * 1e3:.2f}) "
        f"= {len(pairs) / tx[0]:.0f} survivor pairs/s ({card})")
    check(tk[0] < tx[0], "the plain-XLA version beat the kernel the engine "
                         "runs: revisit the kernel decision")
    log("  chosen end: kernel (the engine runs it)")
    mk = at.tile_sums.lower(padded, *table, *packed, interpret=False,
                            **kw).compile().memory_analysis()
    mx = at.tile_sums_xla.lower(chunks[0], *table, *packed, k_max=sc.k_max,
                                **kw).compile().memory_analysis()
    log(f"  kernel memory_analysis: {mk}")
    log(f"  XLA memory_analysis (one {chunk}-pair chunk): {mx}")


# --- phase 4 -----------------------------------------------------------

def phase4_chip_tests():
    import pytest

    class Outcomes:
        def __init__(self):
            self.seen = []

        def pytest_runtest_logreport(self, report):
            if report.when == "call" or report.outcome == "skipped":
                self.seen.append((report.nodeid, report.outcome))

    out = Outcomes()
    rc = pytest.main(["-q", "-m", "chip", "-p", "no:cacheprovider",
                      os.path.join(HERE, "tests")], plugins=[out])
    check(rc == 0, f"chip tests: pytest exit code {rc}")
    check(out.seen and all(o == "passed" for _, o in out.seen),
          f"chip tests did not all run and pass: {out.seen}")
    log(f"  {len(out.seen)} chip tests passed")


# --- phase 5 -----------------------------------------------------------

def phase5_four_cards(lib, card):
    import jax
    devices = jax.local_devices()
    check(len(devices) == 4, f"--chips 4 needs 4 local GPUs, JAX has "
                             f"{len(devices)}")
    four = lib.sweep(devices=devices)
    with stage("two-phase sweep on 4 cards (cold)"):
        handle = four.launch(lib.targets)
    homes = {next(iter(out.devices())) for out, _ in handle[1]
             if out is not None}
    check(homes == set(devices), f"outputs on {homes}, want all 4 cards")
    s4, m4 = four.collect(handle)
    with stage("two-phase sweep on 4 cards (warm)"):
        four.sweep(lib.targets)
    one = lib.sweep(devices=devices[:1])
    one.sweep(lib.targets)
    with stage("two-phase sweep on 1 card (warm)"):
        s1, m1 = one.sweep(lib.targets)
    check(np.array_equal(s4, s1) and np.array_equal(m4, m1),
          "4-card scores differ from 1-card scores")
    log(f"  CDS: 4-card == 1-card on {s1.size} pairs, outputs on "
        f"{len(homes)} devices ({card})")

    # gradient planes and scores spread over the cards (grad_devices)
    import colormipsearch_tpu.cmd.gradientscores_cmd as gc
    from colormipsearch_tpu.cds.shape_oracle import build_query_shape_planes
    from colormipsearch_tpu.imageproc.io import image_from_array
    raws = [(lib.targets[j], (lib.grads[j], False), None) for j in range(64)]
    qp = build_query_shape_planes(image_from_array(lib.masks[0]),
                                  lib.excluded)
    args = argparse.Namespace(maskThreshold=20)

    def ga(n):
        os.environ["CMS_GRAD_DEVICES"] = str(n)
        try:
            tp = gc._build_planes_device(raws, args, excluded=lib.excluded)
            out = gc.score_tplanes_batched(qp, tp, mirror=True,
                                           targets_per_batch=16, r0=0,
                                           r1=lib.h)
            return tp, [np.asarray(o) for o in out]
        finally:
            del os.environ["CMS_GRAD_DEVICES"]
    tp4, g4 = ga(4)
    _, g1 = ga(1)
    homes = {next(iter(t.grad.devices())) for t in tp4}
    check(len(homes) == 4, f"GA planes on {len(homes)} devices")
    check(all(np.array_equal(a, b) for a, b in zip(g4, g1)),
          "4-card GA scores differ from 1-card")
    log(f"  GA: 4-card == 1-card on 64 targets, planes on {len(homes)} "
        f"devices ({card})")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workdir", default=None,
                    help="keep work files here (default: a temporary "
                         "directory, removed at the end)")
    args = ap.parse_args(argv)
    # JAX must see the GPU platform before it loads (no CPU fallback); the
    # in-process pytest run of phase 4 inherits it.
    os.environ["JAX_PLATFORMS"] = "cuda"
    t_start = time.perf_counter()
    log("phase 0: card")
    card = phase0_card()
    if args.chips == 1:
        work = args.workdir or tempfile.mkdtemp(prefix="chip_smoke_")
        os.makedirs(work, exist_ok=True)
        try:
            log("phase 1: fixture goldens through the CLI")
            phase1_goldens(work)
            log("phase 2: production-scale library")
            lib = Library(args.seed, N_MASKS, N_TARGETS)
            sweep = phase2_library(work, lib, card)
        finally:
            if args.workdir is None:
                shutil.rmtree(work, ignore_errors=True)
        log("phase 3: kernel decision")
        phase3_kernel(lib, sweep, card)
        log("phase 4: tests marked chip")
        phase4_chip_tests()
    else:
        log("phase 5: four cards")
        lib = Library(args.seed, N_MASKS, N_TARGETS)
        phase5_four_cards(lib, card)
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    import jax
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
