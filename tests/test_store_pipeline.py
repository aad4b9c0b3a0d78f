"""Store-only end-to-end pipeline: import -> store ->
search (store-backed MIP reads) -> gradientScores -> normalize ->
export, with NO JSON intermediary. The reference's production flow is
DB-centric end to end (CreateCDSDataInputCmd.java:237-260 via
DBCheckedCDMIPsWriter; ColorDepthSearchCmd.java:413-448 via
DBCDMIPsReader.java:30-60). Runs over both SQLite and the Mongo fake.
"""

import json
import os

import pytest

from colormipsearch_tpu.cmd import backends
from colormipsearch_tpu.cmd.main import main
from colormipsearch_tpu.dataio import DataSourceParam
from colormipsearch_tpu.dataio.db import DBNeuronMatchesReader
from colormipsearch_tpu.model import ComputeFileType, ProcessingType

AS = "JRC2018_Unisex_20x_HR"


def _cdm_base(e):
    fd = e.compute_files.get(ComputeFileType.InputColorDepthImage)
    return os.path.basename(fd.file_name or "") if fd else None


def _store_url(kind, tmp_path):
    if kind == "sqlite":
        return str(tmp_path / "nb.db")
    # Mongo fake: registered under a unique URI via the backends cache
    from test_db_mongo import make_store
    url = f"mongodb://fake-{tmp_path.name}"
    backends._stores[url] = make_store()
    return url


@pytest.mark.parametrize("kind", ["sqlite", "mongo"])
def test_store_only_pipeline(kind, tmp_path, fixtures_dir):
    db = _store_url(kind, tmp_path)

    # 1. import: EM masks and LM targets (with grad/zgap variants
    #    resolved by naming convention) straight into the store
    rc = main(["createColorDepthSearchDataInput", "--library", "flyem_test",
               "--cdm-location", str(fixtures_dir / "ems"),
               "-as", AS, "--db", db])
    assert rc == 0
    rc = main(["createColorDepthSearchDataInput",
               "--library", "flylight_test",
               "--cdm-location", str(fixtures_dir / "lms"),
               "--variant", f"grad:{fixtures_dir / 'grad'}",
               "--variant", f"zgap:{fixtures_dir / 'zgap'}",
               "-as", AS, "--db", db])
    assert rc == 0

    store = backends.get_store(db)
    ems = store.find_neurons(DataSourceParam(libraries=["flyem_test"]))
    lms = store.find_neurons(DataSourceParam(libraries=["flylight_test"]))
    assert len(ems) == 3 and len(lms) == 4
    # grad variants attached by the naming-convention lookup
    with_grad = [e for e in lms
                 if ComputeFileType.GradientImage in e.compute_files]
    assert len(with_grad) == 3

    # 2. search, masks/targets read FROM THE STORE by library selector
    #    (+ published-name narrowing to the golden mask)
    rc = main(["colorDepthSearch", "--mips-storage", "db", "--db", db,
               "-m", "flyem_test", "-i", "flylight_test",
               "-as", AS, "--masks-published-names", "12191",
               "--maskThreshold", "20", "--dataThreshold", "20",
               "--pixColorFluctuation", "1", "--xyShift", "2",
               "--mirrorMask", "--processing-tag", "e2e-run"])
    assert rc == 0

    reader = DBNeuronMatchesReader(store)
    mask_mips = reader.list_match_locations([DataSourceParam()])
    # two fixture masks share published name 12191 (plain + _FL); the
    # third (1752016801) must have been excluded by the selector
    assert len(mask_mips) == 2
    all_matches = reader.read_matches_by_mask(
        DataSourceParam(mip_ids=mask_mips))
    assert all(m.mask_image.published_name == "12191" for m in all_matches)
    matches = [m for m in all_matches
               if _cdm_base(m.mask_image) == "12191_JRC2018U.tif"]
    by_cdm = {_cdm_base(m.matched_image): m for m in matches}
    golden = {
        "VT033614_127B01_AE_01-20171124_64_H6-f-CH2_01.tif": (439, False),
        "BJD_127B01_AE_01-20171124_64_H6-40x-Brain-JRC2018_Unisex_20x_HR"
        "-2483089192251293794-CH2-01_CDM.tif": (414, False),
        "VT016795_115C08_AE_01-20200221_61_I2-m-CH1_01.tif": (426, True),
    }
    for name, (pix, mirrored) in golden.items():
        assert by_cdm[name].matching_pixels == pix, name
        assert by_cdm[name].mirrored == mirrored, name

    # processing tags stamped in the store for every searched mip
    ems2 = store.find_neurons(
        DataSourceParam(libraries=["flyem_test"], names=["12191"]))
    assert "e2e-run" in ems2[0].processed_tags.get(
        ProcessingType.ColorDepthSearch, set())

    # 3. gradient re-rank + 4. normalization, all in-store
    rc = main(["gradientScores", "--db", db,
               "--maskThreshold", "20", "--mirrorMask",
               "--computeZGapOnTheFly"])
    assert rc == 0
    rc = main(["normalizeGradientScores", "--db", db])
    assert rc == 0
    matches = [m for m in reader.read_matches_by_mask(
                   DataSourceParam(mip_ids=mask_mips))
               if _cdm_base(m.mask_image) == "12191_JRC2018U.tif"]
    by_cdm = {_cdm_base(m.matched_image): m for m in matches}
    gaps = {
        "VT033614_127B01_AE_01-20171124_64_H6-f-CH2_01.tif": 21365,
        "BJD_127B01_AE_01-20171124_64_H6-40x-Brain-JRC2018_Unisex_20x_HR"
        "-2483089192251293794-CH2-01_CDM.tif": 33884,
        "VT016795_115C08_AE_01-20200221_61_I2-m-CH1_01.tif": 40696,
    }
    for name, gap in gaps.items():
        assert by_cdm[name].gradient_area_gap == gap, name
    best = max(m.normalized_score or 0 for m in matches)
    assert best == pytest.approx(100.0)

    # 5. export from the store (EM_CD_MATCHES)
    out = tmp_path / "export"
    rc = main(["exportData", "--exported-result-type", "EM_CD_MATCHES",
               "--db", db, "-od", str(out), "--validation", "off"])
    assert rc == 0
    files = list(out.rglob("*.json"))
    assert files, "export produced no files"
    doc = json.loads(files[0].read_text())
    assert doc["results"], "export produced no results"
