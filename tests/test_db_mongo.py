"""Mongo DAO backend tests (CDMatchesMongoDaoITest analogue).

pymongo is not installed in this image, so MongoStore is exercised
against an in-process fake implementing the exact pymongo subset it
uses (replace_one/update_one/find/distinct/delete_many with equality,
$in and $lt filters). The scenarios mirror test_dataio_db.py so both
backends are pinned to the same DAO semantics.
"""

import json
import pathlib

from colormipsearch_tpu.dataio import DataSourceParam, ScoresFilter
from colormipsearch_tpu.dataio.db import (DBCDMIPsReader, DBCDMIPsWriter,
                                          DBNeuronMatchesReader,
                                          DBNeuronMatchesWriter)
from colormipsearch_tpu.dataio.db_mongo import MongoStore, open_store
from colormipsearch_tpu.model import CDMatchEntity, ProcessingType

FIXTURE = pathlib.Path(__file__).parent / "fixtures" / "cdsmatches" / "testcdsmatches.json"


# --- minimal pymongo-compatible fake -----------------------------------

def _resolve_path(doc, path):
    """Dotted-path lookup with Mongo array semantics: resolving through
    a list fans out over its elements."""
    vals = [doc]
    for part in path.split("."):
        nxt = []
        for v in vals:
            if isinstance(v, dict):
                nxt.append(v.get(part))
        vals = nxt
    return vals


def _field_matches(vals, cond):
    """Mongo field-condition semantics on the resolved value(s): a
    condition on an array field matches if ANY element matches; null in
    a $in list matches a missing field."""
    def each(pred):
        for v in vals:
            if isinstance(v, list):
                if any(pred(x) for x in v):
                    return True
            elif pred(v):
                return True
        return False

    if isinstance(cond, dict) and any(str(k).startswith("$")
                                      for k in cond):
        for op, arg in cond.items():
            if op == "$in":
                if not each(lambda v: v in arg):
                    return False
            elif op == "$nin":
                if each(lambda v: v in arg):
                    return False
            elif op == "$lt":
                if not each(lambda v: v is not None and v < arg):
                    return False
            elif op == "$gte":
                if not each(lambda v: v is not None and v >= arg):
                    return False
            elif op == "$all":
                flat = [x for v in vals
                        for x in (v if isinstance(v, list) else [v])]
                if not all(a in flat for a in arg):
                    return False
            else:
                raise NotImplementedError(op)
        return True
    return each(lambda v: v == cond)


def _matches_filter(doc, query):
    for key, cond in query.items():
        if key == "$and":
            if not all(_matches_filter(doc, q) for q in cond):
                return False
        elif key == "$or":
            if not any(_matches_filter(doc, q) for q in cond):
                return False
        elif key == "$nor":
            if any(_matches_filter(doc, q) for q in cond):
                return False
        elif not _field_matches(_resolve_path(doc, key), cond):
            return False
    return True


def _apply_update_ops(d, update, created):
    """Mongo update-operator semantics used by the DAO layer
    ($set/$setOnInsert/$inc/$addToSet/$push/$pull/$pullAll, with
    $each)."""
    for op, fields in update.items():
        if op == "$set":
            d.update(fields)
        elif op == "$setOnInsert":
            if created:
                d.update(fields)
        elif op == "$inc":
            for f, v in fields.items():
                d[f] = (d.get(f) or 0) + v
        elif op in ("$addToSet", "$push"):
            for f, v in fields.items():
                cur = list(d.get(f) or [])
                vals = (v["$each"] if isinstance(v, dict) and "$each" in v
                        else [v])
                for x in vals:
                    if op == "$push" or x not in cur:
                        cur.append(x)
                d[f] = cur
        elif op == "$pull":
            for f, v in fields.items():
                d[f] = [x for x in (d.get(f) or []) if x != v]
        elif op == "$pullAll":
            for f, v in fields.items():
                d[f] = [x for x in (d.get(f) or []) if x not in v]
        elif op == "$unset":
            for f in fields:
                d.pop(f, None)
        else:
            raise NotImplementedError(op)


class _FakeCollection:
    def __init__(self):
        self.docs = {}
        self.op_log = []  # ("replace_one" | "update_one" | ("bulk_write", n))
        self.find_log = []  # queries passed to find()

    def create_index(self, key):
        pass

    def find(self, query=None):
        self.find_log.append(query or {})
        return [dict(d) for d in self.docs.values()
                if _matches_filter(d, query or {})]

    def replace_one(self, flt, doc, upsert=False):
        self.op_log.append("replace_one")
        self._replace(flt, doc, upsert)

    def _replace(self, flt, doc, upsert):
        for _id, d in list(self.docs.items()):
            if _matches_filter(d, flt):
                self.docs[_id] = dict(doc, _id=d["_id"])
                return
        if upsert:
            self.docs[doc["_id"]] = dict(doc)

    def update_one(self, flt, update, upsert=False):
        self.op_log.append("update_one")
        self._update(flt, update, upsert)

    def _update(self, flt, update, upsert=False):
        for d in self.docs.values():
            if _matches_filter(d, flt):
                _apply_update_ops(d, update, created=False)
                return
        if upsert:
            doc = {k: v for k, v in flt.items()
                   if not str(k).startswith("$")}
            _apply_update_ops(doc, update, created=True)
            self.docs[doc["_id"]] = doc

    def bulk_write(self, ops, ordered=True):
        # pymongo-compatible: ops carry _filter/_doc/_upsert (UpdateOne
        # docs are {"$set": ...}; ReplaceOne docs are full replacements)
        self.op_log.append(("bulk_write", len(ops)))
        for op in ops:
            if any(k.startswith("$") for k in op._doc):
                self._update(op._filter, op._doc)
            else:
                self._replace(op._filter, op._doc, op._upsert)

    def distinct(self, key):
        return sorted({d.get(key) for d in self.docs.values()
                       if d.get(key) is not None})

    def update_many(self, flt, update):
        self.op_log.append("update_many")
        n = 0
        for d in self.docs.values():
            if _matches_filter(d, flt):
                _apply_update_ops(d, update, created=False)
                n += 1
        class R:
            modified_count = n
        return R()

    def delete_many(self, query):
        hit = [i for i, d in self.docs.items() if _matches_filter(d, query)]
        for i in hit:
            del self.docs[i]
        class R:
            deleted_count = len(hit)
        return R()


class _FakeDB(dict):
    def __missing__(self, key):
        self[key] = _FakeCollection()
        return self[key]


class _FakeClient:
    def __init__(self):
        self.dbs = {}

    def __getitem__(self, name):
        return self.dbs.setdefault(name, _FakeDB())

    def close(self):
        pass


def load_fixture_matches():
    with open(FIXTURE) as f:
        return [CDMatchEntity.from_dict(d) for d in json.load(f)]


def make_store():
    return MongoStore(client=_FakeClient(), database="neuronbridge")


def run_roundtrip_and_upsert(store):
    """DAO scenario shared by the hermetic fake and the env-gated real-
    Mongo itest (tests/test_db_mongo_itest.py)."""
    matches = load_fixture_matches()
    writer = DBNeuronMatchesWriter(store)
    assert writer.write(matches) == len(matches)

    reader = DBNeuronMatchesReader(store)
    mips = reader.list_match_locations([DataSourceParam()])
    assert mips
    read = reader.read_matches_by_mask(DataSourceParam(mip_ids=mips))
    assert len(read) == len(matches)
    pix = [m.matching_pixels for m in read]
    assert pix == sorted(pix, reverse=True)

    # idempotent re-run: replaceOne keyed on (mask_ref, matched_ref)
    assert writer.write(matches) == len(matches)
    read2 = reader.read_matches_by_mask(DataSourceParam(mip_ids=mips))
    assert len(read2) == len(matches)

    # score-only field update ($set path)
    for m in matches:
        m.normalized_score = 42.0
    writer.write_updates(matches, ["normalizedScore"])
    read3 = reader.read_matches_by_mask(DataSourceParam(mip_ids=mips))
    assert all(m.normalized_score == 42.0 for m in read3)

    flt = ScoresFilter().add("matchingPixels", 100)
    strong = reader.read_matches_by_mask(DataSourceParam(mip_ids=mips),
                                         scores_filter=flt)
    assert strong and all(m.matching_pixels >= 100 for m in strong)

    # delete below a pixel floor
    before = len(store.find_matches_by_mask_refs(
        store.matches.distinct("maskImageRefId")))
    deleted = store.delete_matches(max_pixels=100)
    assert deleted == before - len(strong)


def run_neuron_selectors(store):
    matches = load_fixture_matches()
    entities = [m.mask_image for m in matches] + [m.matched_image for m in matches]
    w = DBCDMIPsWriter(store)
    w.write(entities)
    w.add_processing_tags(entities[:3], ProcessingType.ColorDepthSearch, {"t1"})

    r = DBCDMIPsReader(store)
    em = r.read_mips(DataSourceParam(libraries=["FlyEM_Hemibrain_v1.2.1"]))
    assert em and all(e.library_name == "FlyEM_Hemibrain_v1.2.1" for e in em)
    tagged = [e for e in r.read_mips(DataSourceParam())
              if e.has_processed_tag(ProcessingType.ColorDepthSearch, "t1")]
    assert len(tagged) == len({e.entity_id for e in entities[:3]})
    assert store.distinct_neuron_values("library_name")


def test_mongo_roundtrip_and_upsert():
    run_roundtrip_and_upsert(make_store())


def test_mongo_neuron_selectors():
    run_neuron_selectors(make_store())


def test_open_store_dispatch(tmp_path):
    from colormipsearch_tpu.dataio.db import SqliteStore
    s = open_store(str(tmp_path / "x.db"))
    assert isinstance(s, SqliteStore)
    # mongodb:// requires pymongo, which is absent: clear error
    try:
        open_store("mongodb://localhost/neuronbridge")
        raise AssertionError("expected RuntimeError without pymongo")
    except RuntimeError as e:
        assert "pymongo" in str(e)


def test_bulk_write_round_trips():
    """Match upserts and score updates must go
    through bulk_write (one round trip per batch), never per-document
    replace_one/update_one (AbstractNeuronMatchesMongoDao.java:117+)."""
    store = make_store()
    matches = load_fixture_matches()
    DBNeuronMatchesWriter(store).write(matches)
    log = store.matches.op_log
    bulk = [e for e in log if isinstance(e, tuple) and e[0] == "bulk_write"]
    assert bulk == [("bulk_write", len(matches))]
    assert "replace_one" not in log and "update_one" not in log
    # neuron upserts are bulk too
    nlog = store.neurons.op_log
    assert all(isinstance(e, tuple) for e in nlog), nlog

    # score updates: one bulk per update batch
    store.matches.op_log.clear()
    for m in matches:
        m.gradient_area_gap = 7
    store.update_match_fields(matches, ["gradientAreaGap"])
    log = store.matches.op_log
    assert log == [("bulk_write", len(matches))]
    read = store.find_matches_by_mask_refs(
        sorted({m.mask_ref() for m in matches}))
    assert all(m.gradient_area_gap == 7 for m in read)

    # re-run score-only mode: UpdateOne ops inside ONE bulk
    store.matches.op_log.clear()
    for m in matches:
        m.matching_pixels = (m.matching_pixels or 0) + 1
    store.upsert_matches(matches, update_scores_only=True)
    log = store.matches.op_log
    assert log == [("bulk_write", len(matches))]

    # archive-on-delete uses a bulk archive write
    ids = [m.entity_id for m in matches[:3]]
    assert store.delete_matches_by_ids(ids) == 3
    arch_log = store._db["cdMatchesArchive"].op_log
    assert arch_log == [("bulk_write", 3)]


def run_ppp_and_pppm_urls(store):
    """Shared scenario (fake + real server): pppMatches upserts keep
    entity ids over natural-key re-imports, and the pppmURL store
    (PPPmURLs.java) round-trips keyed by those ids."""
    from colormipsearch_tpu.model import PPPMatchEntity
    ms = [PPPMatchEntity(source_em_name="em-A", source_lm_name=f"lm-{i}",
                         rank=float(i), cov_score=-100.0 - i)
          for i in range(3)]
    assert store.upsert_ppp_matches(ms) == 3
    ids = [m.entity_id for m in ms]
    assert all(i is not None for i in ids)
    # natural-key re-import preserves ids (pppmURL keys on them)
    ms2 = [PPPMatchEntity(source_em_name="em-A", source_lm_name=f"lm-{i}",
                          rank=float(i), cov_score=-200.0 - i)
           for i in range(3)]
    store.upsert_ppp_matches(ms2)
    assert [m.entity_id for m in ms2] == ids
    got = store.find_ppp_matches_by_em("em-A")
    assert [m.cov_score for m in got] == [-200.0, -201.0, -202.0]
    assert [m.entity_id for m in got] == ids
    docs = [{"_id": i, "uploadedFiles": {"RAW": f"https://s3/{i}_raw.png"},
             "uploadedThumbnails": {"CH": f"https://s3/{i}_ch.jpg"}}
            for i in ids[:2]]
    assert store.upsert_pppm_urls(docs) == 2
    found = store.find_pppm_urls_by_ids(ids)
    assert sorted(found) == sorted(str(i) for i in ids[:2])
    assert found[str(ids[0])]["uploadedFiles"]["RAW"].endswith("_raw.png")
    # upsert replaces
    store.upsert_pppm_urls([{"_id": ids[0], "uploadedFiles": {"RAW": "u2"}}])
    assert store.find_pppm_urls_by_ids([ids[0]])[str(ids[0])][
        "uploadedFiles"] == {"RAW": "u2"}
    assert store.find_pppm_urls_by_ids([]) == {}


def test_mongo_ppp_and_pppm_urls():
    run_ppp_and_pppm_urls(make_store())
