"""Multi-process distributed sweep: 2 processes x 2 CPU devices with a
global mesh and gloo collectives, validating the jax.distributed layer
the reference never had (its cross-machine story is LSF job arrays +
shared Mongo state, SURVEY.md 2d P3/P5)."""

import os
import socket
import subprocess
import sys
import pathlib


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_global_sweep():
    port = _free_port()
    worker = pathlib.Path(__file__).parent / "mh_worker.py"
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(r), "2", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out)
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-3000:]}"
        assert "MULTIHOST SWEEP OK" in out


def test_process_block_env(monkeypatch):
    from colormipsearch_tpu.parallel.multihost import process_block
    monkeypatch.setenv("CMS_NUM_PROCESSES", "3")
    monkeypatch.setenv("CMS_PROCESS_ID", "2")
    assert process_block(10) == (8, 10)
    monkeypatch.setenv("CMS_PROCESS_ID", "0")
    assert process_block(10) == (0, 4)


def test_two_process_cli_sweep(tmp_path, fixtures_dir):
    """Full colorDepthSearch CLI across 2 jax.distributed processes:
    one global-mesh computation, rank-0 writes, golden scores exact."""
    import json
    ws = tmp_path
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).parent))
    from colormipsearch_tpu.dataio import JSONCDMIPsWriter
    from colormipsearch_tpu.model import (ComputeFileType, EMNeuronEntity,
                                          FileData, LMNeuronEntity)
    em = EMNeuronEntity(entity_id=1001, mip_id="em-12191",
                        alignment_space="JRC2018_Unisex_20x_HR",
                        library_name="flyem_test", published_name="12191")
    em.compute_files[ComputeFileType.InputColorDepthImage] = \
        FileData.from_string(str(fixtures_dir / "ems" / "12191_JRC2018U.tif"))
    targets = []
    for i, name in enumerate([
            "VT033614_127B01_AE_01-20171124_64_H6-f-CH2_01",
            "VT016795_115C08_AE_01-20200221_61_I2-m-CH1_01"]):
        lm = LMNeuronEntity(entity_id=2001 + i, mip_id=f"lm-{i}",
                            alignment_space="JRC2018_Unisex_20x_HR",
                            library_name="flylight_test",
                            published_name=name.split("_")[0])
        lm.compute_files[ComputeFileType.InputColorDepthImage] = \
            FileData.from_string(str(fixtures_dir / "lms" / f"{name}.tif"))
        targets.append(lm)
    for fname, ents in (("masks.json", [em]), ("targets.json", targets)):
        w = JSONCDMIPsWriter(str(ws / fname))
        w.open(); w.write(ents); w.close()

    port = _free_port()
    out = ws / "out"
    env_base = {k: v for k, v in os.environ.items()
                if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = []
    for r in range(2):
        env = dict(env_base, CMS_COORDINATOR=f"127.0.0.1:{port}",
                   CMS_NUM_PROCESSES="2", CMS_PROCESS_ID=str(r),
                   JAX_PLATFORMS="cpu")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "colormipsearch_tpu", "colorDepthSearch",
             "-m", str(ws / "masks.json"), "-i", str(ws / "targets.json"),
             "--maskThreshold", "20", "--dataThreshold", "20",
             "--pixColorFluctuation", "1", "--xyShift", "2", "--mirrorMask",
             "--jax-distributed", "-od", str(out)],
            cwd=str(pathlib.Path(__file__).parent.parent),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env))
    outs = []
    for p in procs:
        try:
            o, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            o, _ = p.communicate()
        outs.append(o)
    for r, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{o[-3000:]}"
    d = json.load(open(out / "masks" / "em-12191.json"))
    pix = sorted((r["matchingPixels"], r.get("mirrored", False))
                 for r in d["results"])
    assert pix == [(426, True), (439, False)]


def test_two_process_cli_sweep_pallas(tmp_path, fixtures_dir):
    """colorDepthSearch CLI across 2 jax.distributed processes with the
    PRODUCTION engine (kernel in interpret mode + prescreen): per-process
    target blocks, per-device two-phase pipelines, allgathered rows,
    rank-0 writes — golden scores exact."""
    import json
    ws = tmp_path
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).parent))
    from colormipsearch_tpu.dataio import JSONCDMIPsWriter
    from colormipsearch_tpu.model import (ComputeFileType, EMNeuronEntity,
                                          FileData, LMNeuronEntity)
    # TWO masks (same fixture image) so one kernel launch scores a
    # survivor list spanning several masks
    masks = []
    for mid in ("em-12191", "em-12191b"):
        em = EMNeuronEntity(entity_id=1001 + len(masks), mip_id=mid,
                            alignment_space="JRC2018_Unisex_20x_HR",
                            library_name="flyem_test",
                            published_name="12191")
        em.compute_files[ComputeFileType.InputColorDepthImage] = \
            FileData.from_string(
                str(fixtures_dir / "ems" / "12191_JRC2018U.tif"))
        masks.append(em)
    targets = []
    for i, name in enumerate([
            "VT033614_127B01_AE_01-20171124_64_H6-f-CH2_01",
            "VT016795_115C08_AE_01-20200221_61_I2-m-CH1_01"]):
        lm = LMNeuronEntity(entity_id=2001 + i, mip_id=f"lm-{i}",
                            alignment_space="JRC2018_Unisex_20x_HR",
                            library_name="flylight_test",
                            published_name=name.split("_")[0])
        lm.compute_files[ComputeFileType.InputColorDepthImage] = \
            FileData.from_string(str(fixtures_dir / "lms" / f"{name}.tif"))
        targets.append(lm)
    for fname, ents in (("masks.json", masks), ("targets.json", targets)):
        w = JSONCDMIPsWriter(str(ws / fname))
        w.open(); w.write(ents); w.close()

    port = _free_port()
    out = ws / "out"
    env_base = {k: v for k, v in os.environ.items()
                if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = []
    for r in range(2):
        env = dict(env_base, CMS_COORDINATOR=f"127.0.0.1:{port}",
                   CMS_NUM_PROCESSES="2", CMS_PROCESS_ID=str(r),
                   JAX_PLATFORMS="cpu", CMS_PALLAS_INTERPRET="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "colormipsearch_tpu", "colorDepthSearch",
             "-m", str(ws / "masks.json"), "-i", str(ws / "targets.json"),
             "--maskThreshold", "20", "--dataThreshold", "20",
             "--pixColorFluctuation", "1", "--xyShift", "2", "--mirrorMask",
             "--jax-distributed", "--engine", "pallas",
             "--prescreen", "on", "-od", str(out)],
            cwd=str(pathlib.Path(__file__).parent.parent),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env))
    outs = []
    for p in procs:
        try:
            o, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            o, _ = p.communicate()
        outs.append(o)
    for r, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{o[-3000:]}"
    for mid in ("em-12191", "em-12191b"):
        d = json.load(open(out / "masks" / f"{mid}.json"))
        pix = sorted((r["matchingPixels"], r.get("mirrored", False))
                     for r in d["results"])
        assert pix == [(426, True), (439, False)], mid


def test_two_process_ga_sharding(tmp_path, fixtures_dir):
    """gradientScores --process-id/--process-count mask-mipId grid
    blocks (submitGAJob.sh:50-60 parity): the union of two sharded GA
    CLI processes (concurrent, shared SQLite) equals the unsharded run
    field-for-field."""
    import json
    import sys
    from colormipsearch_tpu.cmd.main import main
    from colormipsearch_tpu.dataio import JSONCDMIPsWriter, DataSourceParam
    from colormipsearch_tpu.model import (ComputeFileType, EMNeuronEntity,
                                          FileData, LMNeuronEntity)

    masks = []
    for i, stem in enumerate(["12191_JRC2018U", "12191_JRC2018U_FL"]):
        em = EMNeuronEntity(entity_id=1001 + i, mip_id=f"em-{i}",
                            alignment_space="JRC2018_Unisex_20x_HR",
                            library_name="flyem_test",
                            published_name="12191")
        em.compute_files[ComputeFileType.InputColorDepthImage] = \
            FileData.from_string(str(fixtures_dir / "ems" / f"{stem}.tif"))
        masks.append(em)
    targets = []
    for i, name in enumerate([
            "VT033614_127B01_AE_01-20171124_64_H6-f-CH2_01",
            "VT016795_115C08_AE_01-20200221_61_I2-m-CH1_01"]):
        lm = LMNeuronEntity(entity_id=2001 + i, mip_id=f"lm-{i}",
                            alignment_space="JRC2018_Unisex_20x_HR",
                            library_name="flylight_test",
                            published_name=name.split("_")[0])
        lm.compute_files[ComputeFileType.InputColorDepthImage] = \
            FileData.from_string(str(fixtures_dir / "lms" / f"{name}.tif"))
        lm.compute_files[ComputeFileType.GradientImage] = \
            FileData.from_string(str(fixtures_dir / "grad" / f"{name}.png"))
        targets.append(lm)
    ws = tmp_path
    for fname, ents in (("masks.json", masks), ("targets.json", targets)):
        w = JSONCDMIPsWriter(str(ws / fname))
        w.open(); w.write(ents); w.close()

    db_u = str(ws / "unsharded.db")
    db_s = str(ws / "sharded.db")
    for db in (db_u, db_s):
        rc = main(["colorDepthSearch", "-m", str(ws / "masks.json"),
                   "-i", str(ws / "targets.json"),
                   "--maskThreshold", "20", "--dataThreshold", "20",
                   "--pixColorFluctuation", "1", "--xyShift", "2",
                   "--mirrorMask", "--db", db])
        assert rc == 0

    rc = main(["gradientScores", "--db", db_u, "--maskThreshold", "20",
               "--mirrorMask", "--computeZGapOnTheFly"])
    assert rc == 0

    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS",
                        "CMS_PROCESS_ID", "CMS_PROCESS_COUNT")}
    env["JAX_PLATFORMS"] = "cpu"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "colormipsearch_tpu", "gradientScores",
         "--db", db_s, "--maskThreshold", "20", "--mirrorMask",
         "--computeZGapOnTheFly",
         "--process-id", str(r), "--process-count", "2"],
        cwd=str(pathlib.Path(__file__).parent.parent),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for r in range(2)]
    for r, p in enumerate(procs):
        try:
            o, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            o, _ = p.communicate()
        assert p.returncode == 0, f"shard {r} failed:\n{o[-3000:]}"

    def snapshot(db):
        from colormipsearch_tpu.cmd import backends
        from colormipsearch_tpu.dataio.db import DBNeuronMatchesReader
        reader = DBNeuronMatchesReader(backends.get_store(db))
        out = {}
        for m in reader.read_matches_by_mask(DataSourceParam()):
            key = (m.mask_image.mip_id, m.matched_image.mip_id)
            out[key] = (m.gradient_area_gap, m.high_expression_area,
                        round(m.normalized_score or 0, 6))
        return out

    got_u, got_s = snapshot(db_u), snapshot(db_s)
    assert got_u == got_s
    assert any(g[0] is not None and g[0] >= 0 for g in got_u.values())
