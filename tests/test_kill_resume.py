"""Kill-and-resume end-to-end test.

The reference's operational recovery model: an LSF array job dies
mid-partition, the same block offsets are resubmitted, and pair-keyed
upserts + processing tags make the rerun converge to the uninterrupted
result (ColorDepthSearchCmd.java:316-335,395-401,
submitCDSBatch.sh:14-25). Here a real CLI subprocess is SIGKILLed after
its first incremental flush (mid-partition, no cleanup), the identical
command re-runs against the surviving store, and the final store must
be semantically identical to a never-interrupted run — same pair-keyed
match rows, scores, tags, and stamped neuron processing tags.
"""

import json
import os
import pathlib
import sqlite3
import subprocess
import sys

import pytest

FIXTURES = pathlib.Path(__file__).parent / "fixtures" / "cdsearch"

# volatile per-run fields: ids are time-based, sessions are per-run
_VOLATILE = {"entityId", "sessionRefId", "createdDate"}


def _build_workspace(tmp_path):
    from colormipsearch_tpu.dataio import JSONCDMIPsWriter
    from colormipsearch_tpu.model import (ComputeFileType, EMNeuronEntity,
                                          FileData, Gender, LMNeuronEntity)
    ems = []
    for i, name in enumerate(["12191_JRC2018U", "12191_JRC2018U_FL"]):
        em = EMNeuronEntity(entity_id=1001 + i, mip_id=f"em-{i}",
                            alignment_space="JRC2018_Unisex_20x_HR",
                            library_name="flyem_test",
                            published_name=f"em{i}")
        em.compute_files[ComputeFileType.InputColorDepthImage] = \
            FileData.from_string(str(FIXTURES / "ems" / f"{name}.tif"))
        ems.append(em)
    targets = []
    for i, p in enumerate(sorted((FIXTURES / "lms").glob("*.tif"))):
        lm = LMNeuronEntity(entity_id=2001 + i, mip_id=f"lm-{i}",
                            alignment_space="JRC2018_Unisex_20x_HR",
                            library_name="flylight_test",
                            published_name=p.stem.split("_")[0],
                            slide_code=f"sc-{i}", anatomical_area="Brain",
                            gender=Gender.f, objective="40x")
        lm.compute_files[ComputeFileType.InputColorDepthImage] = \
            FileData.from_string(str(p))
        grad = FIXTURES / "grad" / f"{p.stem}.png"
        if grad.exists():
            lm.compute_files[ComputeFileType.GradientImage] = \
                FileData.from_string(str(grad))
        targets.append(lm)
    for fname, ents in (("masks.json", ems), ("targets.json", targets)):
        w = JSONCDMIPsWriter(str(tmp_path / fname))
        w.open()
        w.write(ents)
        w.close()


def _search_cmd(tmp_path, db):
    return [sys.executable, "-m", "colormipsearch_tpu", "colorDepthSearch",
            "-m", str(tmp_path / "masks.json"),
            "-i", str(tmp_path / "targets.json"),
            "--maskThreshold", "20", "--dataThreshold", "20",
            "--pixColorFluctuation", "1", "--xyShift", "2", "--mirrorMask",
            "--pctPositivePixels", "1", "--engine", "dense",
            "--processingPartitionSize", "1", "--write-batch-size", "1",
            "--db", db, "--processing-tag", "killtest"]


def _run(cmd, extra_env=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.update(extra_env or {})
    return subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=600)


def _canonical_store(db):
    """Store contents with per-run volatile fields stripped: the
    semantic identity the resume guarantee is about."""
    con = sqlite3.connect(db)
    matches = []
    for (doc,) in con.execute("SELECT doc FROM cd_matches"):
        d = json.loads(doc)
        for k in _VOLATILE | {"id"}:  # top-level id = match entity id
            d.pop(k, None)
        matches.append(d)
    matches.sort(key=lambda d: (d.get("maskImageRefId", 0),
                                d.get("matchedImageRefId", 0)))
    neurons = []
    for (doc,) in con.execute("SELECT doc FROM neuron_metadata"):
        d = json.loads(doc)
        for k in _VOLATILE:
            d.pop(k, None)
        neurons.append(d)
    neurons.sort(key=lambda d: (d.get("class", ""), d.get("mipId", "")))
    con.close()
    return {"matches": matches, "neurons": neurons}


@pytest.mark.slow
def test_sigkill_mid_run_then_resume_converges(tmp_path):
    _build_workspace(tmp_path)

    # reference run: never interrupted
    clean_db = str(tmp_path / "clean.db")
    r = _run(_search_cmd(tmp_path, clean_db))
    assert r.returncode == 0, r.stderr[-2000:]
    clean = _canonical_store(clean_db)
    assert len(clean["matches"]) >= 4  # the workload produces matches

    # interrupted run: SIGKILL after the first incremental flush
    crash_db = str(tmp_path / "crash.db")
    r = _run(_search_cmd(tmp_path, crash_db),
             {"CMS_TEST_KILL_AFTER_FLUSHES": "1"})
    assert r.returncode == -9, (r.returncode, r.stderr[-2000:])
    partial = _canonical_store(crash_db)
    assert 0 < len(partial["matches"]) < len(clean["matches"]), \
        "the kill must land mid-run (some but not all matches persisted)"

    # resume: identical command, same store (the reference resubmits the
    # same block; pair-keyed upserts make it idempotent)
    r = _run(_search_cmd(tmp_path, crash_db))
    assert r.returncode == 0, r.stderr[-2000:]
    assert _canonical_store(crash_db) == clean


@pytest.mark.slow
def test_double_run_is_idempotent(tmp_path):
    """Two full uninterrupted runs over one store == one run (the
    degenerate resume case; upserts never duplicate pairs)."""
    _build_workspace(tmp_path)
    db = str(tmp_path / "twice.db")
    assert _run(_search_cmd(tmp_path, db)).returncode == 0
    once = _canonical_store(db)
    assert _run(_search_cmd(tmp_path, db)).returncode == 0
    assert _canonical_store(db) == once


def _ga_cmd(db):
    return [sys.executable, "-m", "colormipsearch_tpu", "gradientScores",
            "--db", db, "--maskThreshold", "20", "--mirrorMask",
            "--computeZGapOnTheFly", "--write-batch-size", "1",
            "--processing-tag", "gatest"]


@pytest.mark.slow
def test_ga_sigkill_then_resume_converges(tmp_path):
    """gradientScores killed after its first batched score flush, then
    re-run: the final store equals an uninterrupted GA run (batched
    field updates are idempotent; the reference resubmits the same GA
    block, CalculateGradientScoresCmd.java:602-614)."""
    _build_workspace(tmp_path)
    clean_db = str(tmp_path / "clean.db")
    r = _run(_search_cmd(tmp_path, clean_db))
    assert r.returncode == 0, r.stderr[-2000:]
    crash_db = str(tmp_path / "crash.db")
    r = _run(_search_cmd(tmp_path, crash_db))
    assert r.returncode == 0, r.stderr[-2000:]
    assert _canonical_store(crash_db) == _canonical_store(clean_db)

    r = _run(_ga_cmd(clean_db))
    assert r.returncode == 0, r.stderr[-2000:]
    clean = _canonical_store(clean_db)
    assert any(m.get("gradientAreaGap", -1) >= 0 for m in clean["matches"])

    r = _run(_ga_cmd(crash_db), {"CMS_TEST_KILL_AFTER_GA_FLUSHES": "1"})
    assert r.returncode == -9, (r.returncode, r.stderr[-2000:])
    partial = _canonical_store(crash_db)
    assert partial != clean, "the kill must land before GA completes"

    r = _run(_ga_cmd(crash_db))
    assert r.returncode == 0, r.stderr[-2000:]
    assert _canonical_store(crash_db) == clean


@pytest.mark.slow
def test_ga_grid_blocks_union_equals_single_run(tmp_path):
    """Two gradientScores grid-block processes (--process-id 0/1 of 2)
    over one store produce exactly the single-process result — the
    reference's LSF GA job-array semantics (submitGAJob.sh:50-60)."""
    _build_workspace(tmp_path)
    single_db = str(tmp_path / "single.db")
    blocks_db = str(tmp_path / "blocks.db")
    for db in (single_db, blocks_db):
        r = _run(_search_cmd(tmp_path, db))
        assert r.returncode == 0, r.stderr[-2000:]
    assert _canonical_store(single_db) == _canonical_store(blocks_db)

    r = _run(_ga_cmd(single_db))
    assert r.returncode == 0, r.stderr[-2000:]
    for pid in ("0", "1"):
        r = _run(_ga_cmd(blocks_db) + ["--process-id", pid,
                                       "--process-count", "2"])
        assert r.returncode == 0, r.stderr[-2000:]
    assert _canonical_store(blocks_db) == _canonical_store(single_db)
