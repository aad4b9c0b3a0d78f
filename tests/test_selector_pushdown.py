"""Server-side selector pushdown.

The reference joins neurons server-side and filters matches in the DB
via NeuronSelectionHelper aggregation
(dao/mongo/AbstractNeuronMatchesMongoDao.java:117+); here the needed
neuron attrs are denormalized onto match docs at write time, so every
DataSourceParam / ScoresFilter becomes plain find-operators. These
tests prove (a) pushed reads return exactly what host-side filtering
would, (b) the filter really runs IN THE QUERY — the host predicates
are booby-trapped and must never be called on the pushed path.
"""

import pytest

from colormipsearch_tpu.dataio import DataSourceParam, ScoresFilter
from colormipsearch_tpu.dataio.db import DBNeuronMatchesReader, SqliteStore
from colormipsearch_tpu.dataio.db import DBNeuronMatchesWriter
from colormipsearch_tpu.model import (CDMatchEntity, EMNeuronEntity,
                                      LMNeuronEntity, ProcessingType)


def _seed(store):
    em = EMNeuronEntity(entity_id=1, mip_id="em-0",
                        alignment_space="AS1", library_name="flyem",
                        published_name="1001")
    lms = []
    specs = [
        # (name, lib, tags, datasets, ptags, pix, ratio, gap, norm)
        ("R11A11", "mcfo", {"validated"}, {"ds1"},
         {"GradientScore": {"ga-1"}}, 400, 0.03, 1200, 95.0),
        ("R22B22", "mcfo", {"junk"}, {"ds2"}, {}, 300, 0.02, -1, 80.0),
        ("R33C33", "sgal4", set(), {"ds1", "ds2"},
         {"ColorDepthSearch": {"cds-1"}}, 200, 0.011, None, 70.0),
        ("No Consensus", "sgal4", {"validated", "junk"}, set(), {},
         120, 0.005, 50, 60.0),
    ]
    matches = []
    for i, (name, lib, tags, ds, ptags, pix, ratio, gap, norm) \
            in enumerate(specs):
        lm = LMNeuronEntity(entity_id=10 + i, mip_id=f"lm-{i}",
                            alignment_space="AS1", library_name=lib,
                            published_name=name, slide_code=f"sc-{i}")
        lm.tags = set(tags)
        lm.dataset_labels = set(ds)
        for stage, st in ptags.items():
            lm.processed_tags[ProcessingType(stage)] = set(st)
        lms.append(lm)
        m = CDMatchEntity(entity_id=100 + i)
        m.mask_image, m.matched_image = em, lm
        m.matching_pixels = pix
        m.matching_pixels_ratio = ratio
        m.gradient_area_gap = gap
        m.normalized_score = norm
        m.match_found = True
        matches.append(m)
    store.upsert_neurons([em] + lms)
    DBNeuronMatchesWriter(store).write(matches)
    return matches


SELECTOR_CASES = [
    DataSourceParam(libraries=["mcfo"]),
    DataSourceParam(names=["R11A11", "R33C33"]),
    DataSourceParam(tags={"validated"}),
    DataSourceParam(tags={"ga-1"}),            # processing tags count
    DataSourceParam(excluded_tags={"junk"}),
    DataSourceParam(datasets={"ds1"}),
    DataSourceParam(valid_name_only=True),
    DataSourceParam(processing_tags={"GradientScore": {"ga-1"}}),
    DataSourceParam(neuron_class="LMNeuronEntity"),
    DataSourceParam(libraries=["mcfo", "sgal4"], excluded_tags={"junk"},
                    datasets={"ds1", "ds2"}),
]

SCORE_CASES = [
    ScoresFilter().add("matchingPixels", 150),
    ScoresFilter().add("matchingRatio", 0.015),
    ScoresFilter().add("gradientAreaGap|bidirectionalAreaGap", 0),
    ScoresFilter().add("gradientAreaGap|bidirectionalAreaGap", -1),
    ScoresFilter().add("normalizedScore", 75.0).add("matchingPixels", 1),
]


def _host_reference(matches, sel, sf):
    out = []
    for m in matches:
        if sel is not None and m.matched_image is not None \
                and not sel.matches_entity(m.matched_image):
            continue
        if sf is not None and not sf.empty and not sf.matches(m):
            continue
        out.append(m.matched_image.mip_id)
    return sorted(out)


def _boobytrap(sel, sf, monkeypatch):
    """Host predicates must NOT run on the pushed path."""
    if sel is not None:
        monkeypatch.setattr(
            sel, "matches_entity",
            lambda e: (_ for _ in ()).throw(
                AssertionError("selector filtered in Python")))
    if sf is not None:
        monkeypatch.setattr(
            sf, "matches",
            lambda m: (_ for _ in ()).throw(
                AssertionError("scores filtered in Python")))


@pytest.mark.parametrize("case", range(len(SELECTOR_CASES)))
def test_mongo_selector_pushdown(case, monkeypatch):
    from tests.test_db_mongo import make_store
    store = make_store()
    matches = _seed(store)
    sel = SELECTOR_CASES[case]
    want = _host_reference(matches, sel, None)
    _boobytrap(sel, None, monkeypatch)
    got = store.find_matches_by_mask_refs([1], target_selector=sel)
    assert sorted(m.matched_image.mip_id for m in got) == want
    q = store.matches.find_log[-1]
    assert "$and" in q, "selector did not reach the server query"


@pytest.mark.parametrize("case", range(len(SCORE_CASES)))
def test_mongo_scores_pushdown(case, monkeypatch):
    from tests.test_db_mongo import make_store
    store = make_store()
    matches = _seed(store)
    sf = SCORE_CASES[case]
    want = _host_reference(matches, None, sf)
    _boobytrap(None, sf, monkeypatch)
    got = store.find_matches_by_mask_refs([1], scores_filter=sf)
    assert sorted(m.matched_image.mip_id for m in got) == want
    assert "$and" in store.matches.find_log[-1]


@pytest.mark.parametrize("case", range(len(SCORE_CASES)))
def test_sqlite_scores_pushdown(tmp_path, case, monkeypatch):
    """SQLite pushes score filters into indexed SQL columns."""
    store = SqliteStore(str(tmp_path / "s.db"))
    matches = _seed(store)
    sf = SCORE_CASES[case]
    want = _host_reference(matches, None, sf)
    _boobytrap(None, sf, monkeypatch)
    got = store.find_matches_by_mask_refs([1], scores_filter=sf)
    assert sorted(m.matched_image.mip_id for m in got) == want


def test_sqlite_selector_equivalence(tmp_path):
    """SQLite applies target selectors inside the store (host-side is
    fine for the embedded backend) with identical semantics."""
    store = SqliteStore(str(tmp_path / "s.db"))
    matches = _seed(store)
    for sel in SELECTOR_CASES:
        want = _host_reference(matches, sel, None)
        got = store.find_matches_by_mask_refs([1], target_selector=sel)
        assert sorted(m.matched_image.mip_id for m in got) == want


def test_reader_level_pushdown(monkeypatch):
    """DBNeuronMatchesReader delegates both filters to the store."""
    from tests.test_db_mongo import make_store
    store = make_store()
    matches = _seed(store)
    sel = DataSourceParam(libraries=["mcfo"], excluded_tags={"junk"})
    sf = ScoresFilter().add("matchingPixels", 10)
    want = _host_reference(matches, sel, sf)
    _boobytrap(sel, sf, monkeypatch)
    got = DBNeuronMatchesReader(store).read_matches_by_mask(
        DataSourceParam(mip_ids=["em-0"]), target_selector=sel,
        scores_filter=sf)
    assert sorted(m.matched_image.mip_id for m in got) == want
