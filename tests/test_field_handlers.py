"""Field-update handler variety: Set / Append
($addToSet|$push) / Remove ($pull|$pullAll) / Inc / SetOnCreate on both
store backends, matching the reference's handler-to-operator translation
(dao/AppendFieldValueHandler.java et al., MongoDaoHelper.java:255-295).
"""

import pytest

from colormipsearch_tpu.dataio.base import (AppendField, IncField,
                                            RemoveField, SetField,
                                            SetOnCreateField)
from colormipsearch_tpu.dataio.db import SqliteStore
from colormipsearch_tpu.model import EMNeuronEntity


def _stores(tmp_path):
    from tests.test_db_mongo import make_store
    return [("sqlite", SqliteStore(str(tmp_path / "s.db"))),
            ("mongo", make_store())]


def _seed(store):
    e = EMNeuronEntity(entity_id=5, mip_id="em-5", library_name="flyem",
                       published_name="n5")
    e.tags = {"a"}
    store.upsert_neurons([e])
    return e


def _neuron_doc(store):
    if isinstance(store, SqliteStore):
        import json
        row = store._conn.execute(
            "SELECT doc FROM neuron_metadata WHERE entity_id = 5"
        ).fetchone()
        return json.loads(row[0])
    d = dict(next(iter(store.neurons.find({"_id": 5}))))
    d.pop("_id", None)
    return d


@pytest.mark.parametrize("backend", ["sqlite", "mongo"])
def test_all_handler_kinds(tmp_path, backend):
    store = dict(_stores(tmp_path))[backend]
    _seed(store)

    # set
    assert store.update_entity_fields(
        "neurons", 5, {"publishedName": SetField("renamed")})
    assert _neuron_doc(store)["publishedName"] == "renamed"

    # append addToSet: dedupes, iterables fan out
    store.update_entity_fields(
        "neurons", 5, {"tags": AppendField({"a", "b", "c"})})
    assert sorted(_neuron_doc(store)["tags"]) == ["a", "b", "c"]
    # append push (no dedupe)
    store.update_entity_fields(
        "neurons", 5, {"history": AppendField("run1", add_to_set=False)})
    store.update_entity_fields(
        "neurons", 5, {"history": AppendField("run1", add_to_set=False)})
    assert _neuron_doc(store)["history"] == ["run1", "run1"]

    # remove scalar + iterable
    store.update_entity_fields("neurons", 5, {"tags": RemoveField("b")})
    assert sorted(_neuron_doc(store)["tags"]) == ["a", "c"]
    store.update_entity_fields(
        "neurons", 5, {"tags": RemoveField(["a", "c", "zz"])})
    assert _neuron_doc(store)["tags"] == []

    # inc (e.g. usage counters), starts from absent
    store.update_entity_fields("neurons", 5, {"useCount": IncField(2)})
    store.update_entity_fields("neurons", 5, {"useCount": IncField(3)})
    assert _neuron_doc(store)["useCount"] == 5

    # combined handlers in one update
    store.update_entity_fields(
        "neurons", 5, {"tags": AppendField(["x"]),
                       "useCount": IncField(1),
                       "libraryName": SetField("flyem2")})
    d = _neuron_doc(store)
    assert d["tags"] == ["x"] and d["useCount"] == 6 \
        and d["libraryName"] == "flyem2"

    # missing row without set_on_create: no-op
    assert not store.update_entity_fields(
        "neurons", 999, {"tags": AppendField(["x"])})

    # set_on_create: creates, then never overwrites
    assert store.update_entity_fields(
        "neurons", 7, {"libraryName": SetOnCreateField("libA"),
                       "tags": AppendField(["t"])})
    store.update_entity_fields(
        "neurons", 7, {"libraryName": SetOnCreateField("libB")})
    if isinstance(store, SqliteStore):
        import json
        row = store._conn.execute(
            "SELECT doc FROM neuron_metadata WHERE entity_id = 7"
        ).fetchone()
        d7 = json.loads(row[0])
    else:
        d7 = dict(next(iter(store.neurons.find({"_id": 7}))))
    assert d7["libraryName"] == "libA"
    assert d7["tags"] == ["t"]


def test_tag_cmd_uses_field_handlers(tmp_path):
    """The tag command's DB path updates tags server-side (update_one
    with operators), never whole-doc replaces."""
    from colormipsearch_tpu.cmd import backends
    from colormipsearch_tpu.cmd.main import main
    from tests.test_db_mongo import make_store
    db = "mongodb://tagtest/neuronbridge"
    store = make_store()
    backends._stores[db] = store
    e1 = EMNeuronEntity(entity_id=1, mip_id="em-1", library_name="flyem")
    e2 = EMNeuronEntity(entity_id=2, mip_id="em-2", library_name="other")
    store.upsert_neurons([e1, e2])
    store.neurons.op_log.clear()
    assert main(["tag", "--db", db, "--tag", "good", "validated",
                 "--library", "flyem"]) == 0
    assert store.neurons.op_log == ["update_one"]
    doc = dict(next(iter(store.neurons.find({"_id": 1}))))
    assert sorted(doc["tags"]) == ["good", "validated"]
    assert "tags" not in dict(next(iter(store.neurons.find({"_id": 2}))))
    assert main(["tag", "--db", db, "--remove", "--tag", "good",
                 "--library", "flyem"]) == 0
    assert dict(next(iter(store.neurons.find({"_id": 1}))))["tags"] \
        == ["validated"]


def test_bulk_match_tagging_by_refs(tmp_path):
    """validateDBData's --apply-error-tag-to-*-cdmatches path: one
    server-side update_many on Mongo; identical semantics on SQLite."""
    from colormipsearch_tpu.dataio.db import DBNeuronMatchesWriter
    from colormipsearch_tpu.model import CDMatchEntity, LMNeuronEntity
    from tests.test_db_mongo import make_store
    for store in (SqliteStore(str(tmp_path / "s.db")), make_store()):
        em = EMNeuronEntity(entity_id=1, mip_id="em-1")
        lm1 = LMNeuronEntity(entity_id=2, mip_id="lm-1")
        lm2 = LMNeuronEntity(entity_id=3, mip_id="lm-2")
        store.upsert_neurons([em, lm1, lm2])
        ms = []
        for i, lm in enumerate((lm1, lm2)):
            m = CDMatchEntity(entity_id=100 + i)
            m.mask_image, m.matched_image = em, lm
            m.matching_pixels = 10
            ms.append(m)
        DBNeuronMatchesWriter(store).write(ms)
        n = store.update_matches_fields_by_refs(
            mask_refs=[1], updates={"tags": AppendField({"bad"})})
        assert n == 2
        got = store.find_matches_by_mask_refs([1])
        assert all("bad" in m.tags for m in got)
        # target-side restriction hits only lm-1's match
        n = store.update_matches_fields_by_refs(
            matched_refs=[2], updates={"tags": AppendField({"worse"})})
        assert n == 1
        by_t = {m.matched_image.mip_id: m
                for m in store.find_matches_by_mask_refs([1])}
        assert "worse" in by_t["lm-1"].tags
        assert "worse" not in by_t["lm-2"].tags
        if not isinstance(store, SqliteStore):
            assert "update_many" in store.matches.op_log


def test_filedata_exists_zip_entries(tmp_path):
    import zipfile
    from colormipsearch_tpu.mips.loader import filedata_exists
    from colormipsearch_tpu.model.filedata import FileData, FileDataType
    zpath = tmp_path / "a.zip"
    with zipfile.ZipFile(zpath, "w") as zf:
        zf.writestr("dir/img1.png", b"x")
    assert filedata_exists(FileData(str(zpath), FileDataType.zipEntry,
                                    "dir/img1.png"))
    # basename fallback scan (NeuronMIPUtils.java:177-199)
    assert filedata_exists(FileData(str(zpath), FileDataType.zipEntry,
                                    "other/img1.png"))
    assert not filedata_exists(FileData(str(zpath), FileDataType.zipEntry,
                                        "missing.png"))
    assert not filedata_exists(FileData(str(tmp_path / "no.zip"),
                                        FileDataType.zipEntry, "img1.png"))
