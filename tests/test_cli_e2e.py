"""End-to-end CLI pipeline over the golden fixtures:
colorDepthSearch -> gradientScores -> normalizeGradientScores -> exportData.

Scores must reproduce the reference goldens through the full pipeline.
"""

import json
import os

import pytest

from colormipsearch_tpu.cmd.main import main
from colormipsearch_tpu.dataio import JSONCDMIPsWriter
from colormipsearch_tpu.model import (ComputeFileType, EMNeuronEntity,
                                      FileData, LMNeuronEntity)

LM_NAMES = [
    "VT033614_127B01_AE_01-20171124_64_H6-f-CH2_01",
    "BJD_127B01_AE_01-20171124_64_H6-40x-Brain-JRC2018_Unisex_20x_HR-2483089192251293794-CH2-01_CDM",
    "VT016795_115C08_AE_01-20200221_61_I2-m-CH1_01",
]
EM_NAME = "12191_JRC2018U"


@pytest.fixture(scope="module")
def workspace(tmp_path_factory, fixtures_dir):
    ws = tmp_path_factory.mktemp("cds-e2e")
    em = EMNeuronEntity(entity_id=1001, mip_id="em-12191",
                        alignment_space="JRC2018_Unisex_20x_HR",
                        library_name="flyem_test", published_name="12191")
    em.compute_files[ComputeFileType.InputColorDepthImage] = \
        FileData.from_string(str(fixtures_dir / "ems" / f"{EM_NAME}.tif"))

    targets = []
    for i, name in enumerate(LM_NAMES):
        from colormipsearch_tpu.model import Gender
        lm = LMNeuronEntity(entity_id=2001 + i, mip_id=f"lm-{i}",
                            alignment_space="JRC2018_Unisex_20x_HR",
                            library_name="flylight_test",
                            published_name=name.split("_")[0],
                            slide_code=f"sc-{i}",
                            anatomical_area="Brain",
                            gender=Gender.f, objective="40x")
        lm.compute_files[ComputeFileType.InputColorDepthImage] = \
            FileData.from_string(str(fixtures_dir / "lms" / f"{name}.tif"))
        grad = fixtures_dir / "grad" / f"{name}.png"
        if grad.exists():
            lm.compute_files[ComputeFileType.GradientImage] = \
                FileData.from_string(str(grad))
        zgap = fixtures_dir / "zgap" / f"{name}.tif"
        if zgap.exists():
            lm.compute_files[ComputeFileType.ZGapImage] = \
                FileData.from_string(str(zgap))
        targets.append(lm)

    for fname, ents in (("masks.json", [em]), ("targets.json", targets)):
        w = JSONCDMIPsWriter(str(ws / fname))
        w.open()
        w.write(ents)
        w.close()
    return ws


def test_full_pipeline(workspace, fixtures_dir):
    ws = str(workspace)
    out = os.path.join(ws, "cdsresults")

    # 1. colorDepthSearch with production params
    rc = main(["colorDepthSearch",
               "-m", os.path.join(ws, "masks.json"),
               "-i", os.path.join(ws, "targets.json"),
               "--maskThreshold", "20", "--dataThreshold", "20",
               "--pixColorFluctuation", "1", "--xyShift", "2",
               "--mirrorMask", "-od", out])
    assert rc == 0
    per_mask = os.path.join(out, "masks")
    with open(os.path.join(per_mask, "em-12191.json")) as f:
        doc = json.load(f)
    results = {r["image"]["mipId"]: r for r in doc["results"]}
    assert results["lm-0"]["matchingPixels"] == 439
    assert results["lm-1"]["matchingPixels"] == 414
    assert results["lm-2"]["matchingPixels"] == 426
    assert results["lm-2"]["mirrored"] is True
    # results sorted desc by matchingPixels
    pix = [r["matchingPixels"] for r in doc["results"]]
    assert pix == sorted(pix, reverse=True)

    # 2. gradientScores (zgap from file for BJD, on-the-fly for others)
    rc = main(["gradientScores", "-md", per_mask,
               "--maskThreshold", "20", "--mirrorMask",
               "--computeZGapOnTheFly"])
    assert rc == 0
    with open(os.path.join(per_mask, "em-12191.json")) as f:
        doc = json.load(f)
    results = {r["image"]["mipId"]: r for r in doc["results"]}
    assert results["lm-0"]["gradientAreaGap"] == 21365
    assert results["lm-0"]["highExpressionArea"] == 731
    assert results["lm-1"]["gradientAreaGap"] == 33884  # zgap file variant
    assert results["lm-1"]["highExpressionArea"] == 523
    assert results["lm-2"]["gradientAreaGap"] == 40696
    assert results["lm-2"]["highExpressionArea"] == 17253
    # normalization: all shape ratios clamp to 1 -> pixels ratio * 100
    assert results["lm-0"]["normalizedScore"] == pytest.approx(100.0)
    assert results["lm-2"]["normalizedScore"] == pytest.approx(426 / 439 * 100, rel=1e-5)

    # 3. standalone normalizeGradientScores is idempotent here
    rc = main(["normalizeGradientScores", "-md", per_mask])
    assert rc == 0
    with open(os.path.join(per_mask, "em-12191.json")) as f:
        doc2 = json.load(f)
    results2 = {r["image"]["mipId"]: r for r in doc2["results"]}
    assert results2["lm-0"]["normalizedScore"] == pytest.approx(
        results["lm-0"]["normalizedScore"])

    # 4. export
    export_dir = os.path.join(ws, "export")
    rc = main(["exportData", "--exported-result-type", "EM_CD_MATCHES",
               "-md", per_mask, "-od", export_dir])
    assert rc == 0
    with open(os.path.join(export_dir, "em-12191.json")) as f:
        exported = json.load(f)
    assert exported["inputImage"]["publishedName"] == "12191"
    scores = [r["normalizedScore"] for r in exported["results"]]
    assert scores == sorted(scores, reverse=True)


def test_lm_export_inverted(workspace):
    """LM_CD_MATCHES groups per LM target with the direction inverted
    (LMCDMatchesExporter over readMatchesByTarget). Runs after
    test_full_pipeline (module-scoped workspace already has scores)."""
    ws = str(workspace)
    per_mask = os.path.join(ws, "cdsresults", "masks")
    export_dir = os.path.join(ws, "lm_export")
    rc = main(["exportData", "--exported-result-type", "LM_CD_MATCHES",
               "-md", per_mask, "-od", export_dir])
    assert rc == 0
    files = sorted(os.listdir(export_dir))
    assert files == ["lm-0.json", "lm-1.json", "lm-2.json"]
    with open(os.path.join(export_dir, "lm-0.json")) as f:
        doc = json.load(f)
    assert doc["inputImage"]["mipId"] == "lm-0"
    assert doc["inputImage"]["type"] == "LMImage"
    assert all(r["image"]["type"] == "EMImage" for r in doc["results"])
    assert all(r["image"]["mipId"] == "em-12191" for r in doc["results"])


def test_pallas_engine_cli_branch(workspace, tmp_path, monkeypatch):
    """CLI pallas branch (prescreen + survivor-list kernel launch) in
    interpret mode on CPU — same goldens as the dense path."""
    monkeypatch.setenv("CMS_PALLAS_INTERPRET", "1")
    ws = str(workspace)
    out = str(tmp_path / "pallas_out")
    rc = main(["colorDepthSearch",
               "-m", os.path.join(ws, "masks.json"),
               "-i", os.path.join(ws, "targets.json"),
               "--maskThreshold", "20", "--dataThreshold", "20",
               "--pixColorFluctuation", "1", "--xyShift", "2",
               "--mirrorMask", "--engine", "pallas",
               "--pctPositivePixels", "1.0",
               "-od", out])
    assert rc == 0
    with open(os.path.join(out, "masks", "em-12191.json")) as f:
        doc = json.load(f)
    results = {r["image"]["mipId"]: r for r in doc["results"]}
    assert results["lm-0"]["matchingPixels"] == 439
    assert results["lm-1"]["matchingPixels"] == 414
    assert results["lm-2"]["matchingPixels"] == 426
    assert results["lm-2"]["mirrored"] is True


def test_gradient_border_cli(workspace, fixtures_dir):
    """--border threads from the CLI into the shape planes
    (AbstractColorDepthMatchArgs.java:24-25 ->
    CalculateGradientScoresCmd.java:478): the bordered run matches the
    bordered oracle and shrinks only the gap term."""
    from colormipsearch_tpu.cds.shape_oracle import ShapeScoreOracle
    from colormipsearch_tpu.imageproc import label_regions_mask, load_image
    ws = str(workspace)
    out = os.path.join(ws, "border_results")
    rc = main(["colorDepthSearch",
               "-m", os.path.join(ws, "masks.json"),
               "-i", os.path.join(ws, "targets.json"),
               "--maskThreshold", "20", "--dataThreshold", "20",
               "--pixColorFluctuation", "1", "--xyShift", "2",
               "--mirrorMask", "-od", out])
    assert rc == 0
    per_mask = os.path.join(out, "masks")
    rc = main(["gradientScores", "-md", per_mask,
               "--maskThreshold", "20", "--mirrorMask",
               "--computeZGapOnTheFly", "--border", "200"])
    assert rc == 0
    with open(os.path.join(per_mask, "em-12191.json")) as f:
        doc = json.load(f)
    results = {r["image"]["mipId"]: r for r in doc["results"]}
    query = load_image(fixtures_dir / "ems" / "12191_JRC2018U.tif")
    target = load_image(
        fixtures_dir / "lms" /
        "VT033614_127B01_AE_01-20171124_64_H6-f-CH2_01.tif")
    grad = load_image(
        fixtures_dir / "grad" /
        "VT033614_127B01_AE_01-20171124_64_H6-f-CH2_01.png")
    excluded = label_regions_mask(query.height, query.width)
    exp = ShapeScoreOracle(query, 20, True, excluded, border=200).score(
        target, grad, None)
    assert results["lm-0"]["gradientAreaGap"] == exp.gradient_area_gap
    assert results["lm-0"]["highExpressionArea"] == 731   # un-bordered
    assert exp.gradient_area_gap < 21365                  # border=0 value
