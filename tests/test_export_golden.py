"""Export golden-file comparison: byte-compare an
exported EM_CD_MATCHES pipeline (with JACS enrichment, URL
relativization and image-store mapping) against a checked-in golden
hand-derived from the reference's DTO rules, locking field names,
ordering and URL forms against drift.

Reference rules audited into the golden:
- inputImage / results[].image carry the AbstractNeuronMetadata DTO
  surface with the "type" discriminator EMImage/LMImage
  (dto/EMNeuronMetadata.java, dto/LMNeuronMetadata.java);
- results are CDMatchedTarget objects sorted desc by normalizedScore
  with best-per-(maskMIP,targetMIP) selection
  (cmd/dataexport/AbstractCDMatchesExporter.java:108-125);
- file URLs are relativized by path-component index and the per-neuron
  image store is resolved from alignmentSpace[:libraryName] mappings
  (cmd/dataexport/URLTransformer.java, ImageStoreMapping).
"""

import json
import pathlib

from colormipsearch_tpu.cmd.main import main
from colormipsearch_tpu.dataio import JSONNeuronMatchesWriter
from colormipsearch_tpu.model import (CDMatchEntity, ComputeFileType,
                                      EMNeuronEntity, FileData, FileType,
                                      Gender, LMNeuronEntity)

GOLDEN_DIR = pathlib.Path(__file__).parent / "fixtures" / "export_golden"


def _build_matches():
    em = EMNeuronEntity(entity_id=11, mip_id="em-A",
                        alignment_space="JRC2018_Unisex_20x_HR",
                        library_name="flyem_hemibrain_1_2_1",
                        published_name="1001")
    em.compute_files[ComputeFileType.InputColorDepthImage] = \
        FileData.from_string("/store/em/1001-A_CDM.tif")
    em.files[FileType.CDM] = \
        "https://s3/bucket/JRC2018_Unisex_20x_HR/flyem/1001-A_CDM.png"
    em.files[FileType.CDMThumbnail] = \
        "https://s3/bucket/JRC2018_Unisex_20x_HR/flyem/1001-A_CDM.jpg"
    matches = []
    rows = [("R11A11", 95.5, 400, 1234, 55, True, Gender.f),
            ("R22B22", 88.25, 380, 2100, 10, False, Gender.m)]
    for i, (name, score, pix, gap, hea, mirrored, g) in enumerate(rows):
        lm = LMNeuronEntity(entity_id=21 + i, mip_id=f"lm-{i}",
                            alignment_space="JRC2018_Unisex_20x_HR",
                            library_name="flylight_gen1_mcfo",
                            published_name=name,
                            slide_code=f"2019010{i}_1_A1",
                            anatomical_area="Brain", gender=g,
                            objective="40x")
        lm.compute_files[ComputeFileType.InputColorDepthImage] = \
            FileData.from_string(f"/store/lm/{name}_CDM.tif")
        lm.files[FileType.CDM] = \
            f"https://s3/bucket/JRC2018_Unisex_20x_HR/flylight/{name}_CDM.png"
        m = CDMatchEntity(entity_id=31 + i)
        m.mask_image, m.matched_image = em, lm
        m.matching_pixels = pix
        m.matching_pixels_ratio = pix / 17000
        m.normalized_score = score
        m.gradient_area_gap = gap
        m.high_expression_area = hea
        m.mirrored = mirrored
        m.match_found = True
        matches.append(m)
    return matches


def test_em_export_matches_golden_bytes(tmp_path):
    md = tmp_path / "masks"
    JSONNeuronMatchesWriter(str(md)).write(_build_matches())
    out = tmp_path / "out"
    rc = main(["exportData", "--exported-result-type", "EM_CD_MATCHES",
               "-md", str(md), "-od", str(out),
               "--jacs-mips-file", str(GOLDEN_DIR / "jacs_mips.json"),
               "--default-relative-url-index", "3",
               "--default-image-store", "fl:open_data:brain",
               "--image-stores-per-neuron-meta",
               "JRC2018_Unisex_20x_HR:flyem_hemibrain_1_2_1="
               "fl:hemibrain:v1.2.1"])
    assert rc == 0
    got = (out / "em-A.json").read_bytes()
    want = (GOLDEN_DIR / "em-A.golden.json").read_bytes()
    assert got == want, "export drifted from the golden DTO form"
    # independent spot checks so a regenerated golden can't silently
    # encode a wrong shape
    doc = json.loads(got)
    assert doc["inputImage"]["type"] == "EMImage"
    assert doc["inputImage"]["neuronType"] == "KC"  # via JACS enrichment
    assert doc["inputImage"]["files"]["CDM"] == "1001-A_CDM.png"
    assert doc["inputImage"]["files"]["store"] == "fl:hemibrain:v1.2.1"
    scores = [r["normalizedScore"] for r in doc["results"]]
    assert scores == sorted(scores, reverse=True)
    assert doc["results"][0]["image"]["slideCode"] == "20190100_1_A1"
