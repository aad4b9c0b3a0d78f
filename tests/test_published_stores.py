"""Store-backed published-data DAOs.

The reference reads publishedLMImages / publishedURLs from Mongo
(dao/PublishedURLsDao.java, dao/PublishedLMImageDao.java, wired at
DaosProvider.java:82-88, consumed by cmd/dataexport/*); here the same
stores exist on BOTH backends (SQLite tables, Mongo collections
publishedURL / publishedLMImage) and a --db export reads them directly,
with JSON file args remaining the offline fallback.
"""

import json

import pytest

from colormipsearch_tpu.cmd.main import main
from colormipsearch_tpu.dataio.db import (DBNeuronMatchesWriter, SqliteStore)
from colormipsearch_tpu.model import (CDMatchEntity, ComputeFileType,
                                      EMNeuronEntity, FileData, FileType,
                                      Gender, LMNeuronEntity)

URL_DOCS = [
    {"_id": 11, "uploaded": {
        "cdm": "https://s3/pub/em/1001_CDM.png",
        "cdm_thumbnail": "https://s3/pub/em/1001_CDM.jpg",
        "skeletonswc": "https://s3/pub/em/1001.swc"}},
    {"id": 21, "uploaded": {"cdm": "https://s3/pub/lm/R11A11_CDM.png"}},
]

LM_IMAGE_DOCS = [
    {"sampleRef": "Sample#1", "slideCode": "20190100_1_A1",
     "objective": "40x", "alignmentSpace": "JRC2018_Unisex_20x_HR",
     "files": {"VisuallyLosslessStack": "https://s3/pub/stacks/a1.h5j",
               "Gal4Expression": "https://s3/pub/gal4/a1.png"}},
    {"sampleRef": "Sample#2", "slideCode": "20190101_1_A1",
     "objective": "40x", "alignmentSpace": "JRC2018_Unisex_20x_HR",
     "files": {"VisuallyLosslessStack": "https://s3/pub/stacks/a2.h5j"}},
]


def _build_matches():
    em = EMNeuronEntity(entity_id=11, mip_id="em-A",
                        alignment_space="JRC2018_Unisex_20x_HR",
                        library_name="flyem_hemibrain_1_2_1",
                        published_name="1001")
    em.compute_files[ComputeFileType.InputColorDepthImage] = \
        FileData.from_string("/store/em/1001-A_CDM.tif")
    em.files[FileType.CDM] = "https://s3/old/em/1001-A_CDM.png"
    matches = []
    for i, (name, score) in enumerate((("R11A11", 95.5), ("R22B22", 88.0))):
        lm = LMNeuronEntity(entity_id=21 + i, mip_id=f"lm-{i}",
                            alignment_space="JRC2018_Unisex_20x_HR",
                            library_name="flylight_gen1_mcfo",
                            published_name=name,
                            slide_code=f"2019010{i}_1_A1",
                            anatomical_area="Brain", gender=Gender.f,
                            objective="40x")
        lm.compute_files[ComputeFileType.InputColorDepthImage] = \
            FileData.from_string(f"/store/lm/{name}_CDM.tif")
        m = CDMatchEntity(entity_id=31 + i)
        m.mask_image, m.matched_image = em, lm
        m.matching_pixels = 400 - i
        m.matching_pixels_ratio = (400 - i) / 17000
        m.normalized_score = score
        m.gradient_area_gap = 1000 + i
        m.high_expression_area = 10
        m.match_found = True
        matches.append(m)
    return matches


def _fake_mongo_store():
    from tests.test_db_mongo import make_store
    return make_store()


def _roundtrip_published(store):
    assert store.upsert_published_urls(URL_DOCS) == 2
    assert store.upsert_published_lm_images(LM_IMAGE_DOCS) == 2
    urls = store.load_published_urls()
    assert urls["11"]["cdm"] == "https://s3/pub/em/1001_CDM.png"
    assert urls["21"] == {"cdm": "https://s3/pub/lm/R11A11_CDM.png"}
    stacks = store.load_published_lm_stacks()
    assert stacks["20190100_1_A1"]["Gal4Expression"] \
        == "https://s3/pub/gal4/a1.png"
    # natural-key upsert: replacing a record does not duplicate it
    store.upsert_published_urls([{"_id": 11, "uploaded": {"cdm": "u2"}}])
    assert store.load_published_urls()["11"] == {"cdm": "u2"}
    store.upsert_published_lm_images([dict(LM_IMAGE_DOCS[0],
                                           files={"VisuallyLosslessStack":
                                                  "v2"})])
    assert len(store.find_published_lm_images()) == 2
    assert store.load_published_lm_stacks()["20190100_1_A1"] == \
        {"VisuallyLosslessStack": "v2"}
    # selector reads (PublishedLMImageDao.getPublishedImages filters)
    got = store.find_published_lm_images(sample_refs=["Sample#2"])
    assert [d["slideCode"] for d in got] == ["20190101_1_A1"]
    assert store.find_published_lm_images(
        sample_refs=["Sample#2"], objective="63x") == []


def test_sqlite_published_roundtrip(tmp_path):
    _roundtrip_published(SqliteStore(str(tmp_path / "s.db")))


def test_mongo_published_roundtrip():
    _roundtrip_published(_fake_mongo_store())


@pytest.mark.parametrize("backend", ["sqlite", "mongo"])
def test_export_reads_published_data_from_store(tmp_path, backend):
    """test_export_golden variant with DB-sourced published data
    on both backends."""
    from colormipsearch_tpu.cmd import backends
    if backend == "sqlite":
        db = str(tmp_path / "store.db")
        store = backends.get_store(db)
    else:
        db = "mongodb://published-test/neuronbridge"
        store = _fake_mongo_store()
        backends._stores[db] = store
    store.upsert_published_urls(URL_DOCS)
    store.upsert_published_lm_images(LM_IMAGE_DOCS)
    matches = _build_matches()
    neurons = [matches[0].mask_image] + [m.matched_image for m in matches]
    store.upsert_neurons(neurons)
    DBNeuronMatchesWriter(store).write(matches)

    out = tmp_path / "out"
    rc = main(["exportData", "--exported-result-type", "EM_CD_MATCHES",
               "--db", db, "-od", str(out)])
    assert rc == 0
    doc = json.loads((out / "em-A.json").read_text())
    files = doc["inputImage"]["files"]
    # uploaded URLs from the publishedURL store replaced the files map
    assert files["CDM"] == "https://s3/pub/em/1001_CDM.png"
    assert files["CDMThumbnail"] == "https://s3/pub/em/1001_CDM.jpg"
    assert files["AlignedBodySWC"] == "https://s3/pub/em/1001.swc"
    by_name = {r["image"]["publishedName"]: r for r in doc["results"]}
    lm_files = by_name["R11A11"]["image"]["files"]
    # LM: uploaded CDM (by entity id) + stacks (by slide code)
    assert lm_files["CDM"] == "https://s3/pub/lm/R11A11_CDM.png"
    assert lm_files["VisuallyLosslessStack"] == \
        "https://s3/pub/stacks/a1.h5j"
    assert lm_files["Gal4Expression"] == "https://s3/pub/gal4/a1.png"
    assert by_name["R22B22"]["image"]["files"]["VisuallyLosslessStack"] \
        == "https://s3/pub/stacks/a2.h5j"


def test_export_file_args_take_precedence(tmp_path):
    """Explicit JSON file args override the store (offline fallback)."""
    from colormipsearch_tpu.cmd import backends
    db = str(tmp_path / "store.db")
    store = backends.get_store(db)
    store.upsert_published_urls(URL_DOCS)
    matches = _build_matches()
    store.upsert_neurons([matches[0].mask_image]
                         + [m.matched_image for m in matches])
    DBNeuronMatchesWriter(store).write(matches)
    override = tmp_path / "urls.json"
    override.write_text(json.dumps(
        [{"_id": 11, "uploaded": {"cdm": "https://s3/override/em.png"}}]))
    out = tmp_path / "out"
    rc = main(["exportData", "--exported-result-type", "EM_CD_MATCHES",
               "--db", db, "-od", str(out),
               "--published-urls", str(override)])
    assert rc == 0
    doc = json.loads((out / "em-A.json").read_text())
    assert doc["inputImage"]["files"]["CDM"] == "https://s3/override/em.png"
