"""Native C++ indexing core: parity with the pure-Python pipeline."""

import json

import numpy as np
import pytest

from corpus import TEST_CONFIG, data_ndjson
from veloci_tpu.create import create_indices_from_str
from veloci_tpu.native import native_available

pytestmark = pytest.mark.skipif(
    not native_available(), reason="native library unavailable"
)


def _compare_builds(data: str, config: str) -> None:
    py = create_indices_from_str(data, config, use_native=False)
    nat = create_indices_from_str(data, config, use_native=True)

    assert nat.num_docs == py.num_docs
    assert set(nat.dictionaries) == set(py.dictionaries)
    for field in py.dictionaries:
        assert nat.dictionaries[field].terms == py.dictionaries[field].terms, field

    assert set(nat.key_value_stores) == set(py.key_value_stores)
    for path in py.key_value_stores:
        a, b = py.key_value_stores[path], nat.key_value_stores[path]
        assert type(a) is type(b), path
        if hasattr(a, "offsets"):
            np.testing.assert_array_equal(a.offsets, b.offsets, err_msg=path)
        np.testing.assert_array_equal(a.values, b.values, err_msg=path)

    assert set(nat.anchor_scores) == set(py.anchor_scores)
    for path in py.anchor_scores:
        a, b = py.anchor_scores[path], nat.anchor_scores[path]
        np.testing.assert_array_equal(a.offsets, b.offsets, err_msg=path)
        np.testing.assert_array_equal(a.anchors, b.anchors, err_msg=path)
        np.testing.assert_array_equal(a.scores, b.scores, err_msg=path)

    assert set(nat.phrase_indices) == set(py.phrase_indices)
    for path in py.phrase_indices:
        a, b = py.phrase_indices[path], nat.phrase_indices[path]
        np.testing.assert_array_equal(a.keys, b.keys, err_msg=path)
        np.testing.assert_array_equal(a.offsets, b.offsets, err_msg=path)
        np.testing.assert_array_equal(a.values, b.values, err_msg=path)

    assert set(nat.boost_stores) == set(py.boost_stores)
    for path in py.boost_stores:
        (av, ap), (bv, bp) = py.boost_stores[path], nat.boost_stores[path]
        np.testing.assert_array_equal(av, bv, err_msg=path)
        np.testing.assert_array_equal(ap, bp, err_msg=path)

    for field in py.columns:
        assert (
            nat.columns[field]["is_anchor_identity_column"]
            == py.columns[field]["is_anchor_identity_column"]
        ), field


def test_native_parity_main_corpus():
    _compare_builds(data_ndjson(), TEST_CONFIG)


def test_native_parity_unicode_and_escapes():
    docs = [
        {"t": "majestätischer Anblick (m)", "k": "意慾"},
        {"t": 'quote " and \\ backslash\nnewline\ttab', "k": "いよく"},
        {"t": "é́ combining", "nested": {"deep": [["a", "b"], ["c"]]}},
        {"num": 5.123, "int": 42, "neg": -17, "big": 1e30, "flag": True, "nil": None},
    ]
    data = "\n".join(json.dumps(d, ensure_ascii=False) for d in docs)
    _compare_builds(data, "{}")
    # also with ascii escapes in the input
    data_escaped = "\n".join(json.dumps(d, ensure_ascii=True) for d in docs)
    _compare_builds(data_escaped, "{}")


def test_native_parity_long_texts():
    long_text = "lorem ipsum " * 20
    docs = [{"text": long_text}, {"text": "short"}, {"text": long_text}]
    data = "\n".join(json.dumps(d) for d in docs)
    _compare_builds(data, "{}")


def test_native_parity_custom_separators():
    cfg = """
[custom.fulltext]
tokenize = true
tokenize_on_chars = ['§', '<']
[plain.fulltext]
tokenize = false
"""
    docs = [
        {"custom": "test§_ cool _", "plain": "no tokens here"},
        {"custom": "<<cool>>"},
    ]
    data = "\n".join(json.dumps(d, ensure_ascii=False) for d in docs)
    _compare_builds(data, cfg)


def test_native_parity_large_random():
    rng = np.random.default_rng(3)
    words = [f"w{i}" for i in range(200)]
    docs = []
    for i in range(500):
        docs.append(
            {
                "title": " ".join(rng.choice(words, size=int(rng.integers(1, 9)))),
                "tags": [str(w) for w in rng.choice(words, size=2)],
                "nested": {"vals": [" ".join(rng.choice(words, size=3))]},
                "ent_seq": str(i),
            }
        )
    data = "\n".join(json.dumps(d) for d in docs)
    _compare_builds(data, TEST_CONFIG)


def test_unpaired_surrogate_replaced():
    """An unpaired \\ud800 escape must not abort the native
    build with a UnicodeDecodeError — it decodes as U+FFFD."""
    import veloci_tpu.native as native

    if not native.native_available():
        import pytest

        pytest.skip("native lib unavailable")
    from veloci_tpu import Persistence, Request, search
    from veloci_tpu.create import create_indices_from_str

    data = '{"t": "ok \\ud800 tail"}\n{"t": "plain"}'
    pers = Persistence.from_built(
        create_indices_from_str(data, "{}", use_native=True)
    )
    req = Request.from_dict(
        {"search_req": {"search": {"terms": ["plain"], "path": "t"}}}
    )
    assert search(req, pers).num_hits == 1
    doc = pers.doc_loader.get_doc(0)
    assert "�" in doc or "ud800" in doc  # lossy-replaced, not crashed


def test_mt_ingest_bit_parity():
    """Multi-threaded chunked parse == single-threaded walker, bit for bit
    (term ids, leaf tables, id relations, phrase pairs, synthetic ids)."""
    import os

    import numpy as np

    import veloci_tpu.native as native

    if not native.native_available():
        import pytest

        pytest.skip("native lib unavailable")
    from veloci_tpu.create import create_indices_from_str
    from tests.corpus import TEST_CONFIG, data_ndjson

    # big enough to split into several chunks: repeat the corpus
    data = "\n".join([data_ndjson()] * 200)
    old = os.environ.get("VELOCI_INGEST_THREADS")
    try:
        os.environ["VELOCI_INGEST_THREADS"] = "1"
        a = create_indices_from_str(data, TEST_CONFIG, use_native=True)
        os.environ["VELOCI_INGEST_THREADS"] = "7"
        b = create_indices_from_str(data, TEST_CONFIG, use_native=True)
    finally:
        if old is None:
            os.environ.pop("VELOCI_INGEST_THREADS", None)
        else:
            os.environ["VELOCI_INGEST_THREADS"] = old
    assert a.num_docs == b.num_docs
    assert a.dictionaries.keys() == b.dictionaries.keys()
    for k in a.dictionaries:
        assert list(a.dictionaries[k].terms) == list(b.dictionaries[k].terms)
    for group in ("key_value_stores", "anchor_scores", "phrase_indices"):
        da, db = getattr(a, group), getattr(b, group)
        assert da.keys() == db.keys(), group
        for key in da:
            xa, xb = da[key], db[key]
            for attr in ("offsets", "anchors", "scores", "values", "keys", "data"):
                va = getattr(xa, attr, None)
                vb = getattr(xb, attr, None)
                if va is not None:
                    np.testing.assert_array_equal(va, vb, err_msg=f"{group}/{key}/{attr}")


def test_deeply_nested_document():
    """Nesting beyond the walker's initial per-depth pool size must not
    corrupt paths/terms (the pools are deques precisely so references held
    across recursive growth stay valid)."""
    import json

    from veloci_tpu import Persistence

    # depth 14 > the walker's initial pool of 8, while keeping the flattened
    # path short enough for a filesystem name (the Persistent matrix saves
    # every column to a file named by its path)
    doc = v = {}
    for i in range(14):
        v["l%d" % i] = {}
        v = v["l%d" % i]
    v["leaf"] = "deepterm hello"
    p = Persistence.create_from_str(json.dumps(doc), "{}")
    deep_field = ".".join("l%d" % i for i in range(14)) + ".leaf"
    assert "deepterm hello" in list(p.get_dictionary(deep_field).terms)


def test_baseline_engine_parity():
    """The single-core C++ baseline (native/baseline.cpp — the reference's
    resolve_token_to_anchor + top_n_sort hot path over the same arrays)
    must return the same top-k as the engine's host executor."""
    from veloci_tpu import Persistence, Request, search
    from veloci_tpu.native import baseline_available, baseline_exact_topk

    if not baseline_available():
        pytest.skip("native baseline unavailable")
    pers = Persistence.create_from_str(data_ndjson(), TEST_CONFIG)
    store = pers.anchor_scores["meanings.ger[].textindex.to_anchor_id_score"]
    dictionary = pers.get_dictionary("meanings.ger[]")

    terms = ["majestät", "majestätischer", "anblick", "aussehen"]
    tids = np.full((len(terms), 1), -1, dtype=np.int32)
    for i, t in enumerate(terms):
        ids = dictionary.get_ignore_case(t)
        tids[i, 0] = int(ids[0])
    tscs = np.full((len(terms), 1), 10.0, dtype=np.float32)
    tslots = np.zeros((len(terms), 1), dtype=np.int32)
    ids_b, sc_b, nh_b = baseline_exact_topk(
        store.offsets, store.anchors, store.scores, tids, tscs, tslots, 10
    )
    for i, t in enumerate(terms):
        ref = search(
            Request.from_dict(
                {"search_req": {"search": {"terms": [t], "path": "meanings.ger[]"}}}
            ),
            pers,
        )
        got_ids = [int(x) for x in ids_b[i][: nh_b[i]]][: len(ref.data)]
        assert got_ids == [h.id for h in ref.data], t
        got_scores = [float(x) for x in sc_b[i][: len(ref.data)]]
        for gs, ws in zip(got_scores, [h.score for h in ref.data]):
            assert gs == pytest.approx(ws, rel=1e-5), t
        assert int(nh_b[i]) == ref.num_hits, t

    # union across two distinct term slots == OR request
    tids2 = np.array(
        [[int(dictionary.get_ignore_case("majestätischer")[0]),
          int(dictionary.get_ignore_case("anblick")[0])]], dtype=np.int32
    )
    tscs2 = np.full((1, 2), 10.0, dtype=np.float32)
    tslots2 = np.array([[0, 1]], dtype=np.int32)
    ids_b, sc_b, nh_b = baseline_exact_topk(
        store.offsets, store.anchors, store.scores, tids2, tscs2, tslots2, 10
    )
    ref = search(
        Request.from_dict(
            {
                "search_req": {
                    "or": {
                        "queries": [
                            {"search": {"terms": ["majestätischer"], "path": "meanings.ger[]"}},
                            {"search": {"terms": ["anblick"], "path": "meanings.ger[]"}},
                        ]
                    }
                }
            }
        ),
        pers,
    )
    assert [int(x) for x in ids_b[0][: nh_b[0]]][: len(ref.data)] == [
        h.id for h in ref.data
    ]
    assert int(nh_b[0]) == ref.num_hits


def test_doc_store_native_byte_parity():
    """The one-pass C++ doc-store builder must produce BYTE-IDENTICAL blobs
    to the Python DocStoreWriter (same blocks, offsets, codec, framing)."""
    from veloci_tpu.doc_store import (
        DocLoader,
        DocStoreWriter,
        build_doc_store_native,
    )

    docs = [json.dumps({"t": f"doc {i} " + "x" * (i % 37)}) for i in range(5000)]
    docs.insert(100, "   ")  # whitespace-only lines are skipped
    docs.insert(200, "")
    data = "\n".join(docs)
    native_blob = build_doc_store_native(data)
    if native_blob is None:
        pytest.skip("native doc store unavailable")
    blob_n, num_docs_n, bytes_n = native_blob
    w = DocStoreWriter()
    w.add_docs(line for line in data.split("\n") if line.strip())
    blob_p = w.finish()
    assert num_docs_n == w.curr_id
    assert bytes_n == w.bytes_indexed
    assert blob_n == blob_p
    loader = DocLoader(blob_n)
    assert loader.num_docs == 5000
    assert json.loads(loader.get_doc(0))["t"].startswith("doc 0")
    assert json.loads(loader.get_doc(4999))["t"].startswith("doc 4999")


def test_fuzzy_baseline_engine_parity():
    """The single-core C++ fuzzy baseline (automaton-equivalent sorted-
    dictionary walk + resolve + top_n_sort, native/baseline.cpp
    vbl_fuzzy_topk) must find exactly the brute-force match set and return
    the engine's top-k."""
    from veloci_tpu import Persistence, Request, search
    from veloci_tpu.native import (
        baseline_available,
        baseline_fuzzy_index,
        baseline_fuzzy_topk,
    )
    from veloci_tpu.ops.levenshtein import (
        encode_query,
        levenshtein_distance_host,
    )

    if not baseline_available():
        pytest.skip("native baseline unavailable")
    pers = Persistence.create_from_str(data_ndjson(), TEST_CONFIG)
    field = "meanings.ger[]"
    store = pers.anchor_scores[field + ".textindex.to_anchor_id_score"]
    dictionary = pers.get_dictionary(field)
    idx = baseline_fuzzy_index(dictionary)
    assert idx is not None

    qterms = [("majestät", 1), ("majestätischer", 2), ("anblik", 2),
              ("ausehen", 1), ("urkunde", 2), ("zz", 1)]
    nq = len(qterms)
    queries = np.zeros((nq, 32), np.uint16)
    qlens = np.zeros(nq, np.int32)
    dists = np.zeros(nq, np.int32)
    for row, (t, d) in enumerate(qterms):
        q, ql = encode_query(t)
        queries[row], qlens[row], dists[row] = q, ql, d
    ids_b, sc_b, nh_b, nm_b = baseline_fuzzy_topk(
        idx, queries, qlens, dists,
        store.offsets, store.anchors, store.scores, 10,
    )

    for row, (t, d) in enumerate(qterms):
        # (a) match count == brute force over the dictionary
        brute = sum(
            1
            for term in dictionary.terms
            if len(term) <= 32
            and levenshtein_distance_host(t, term.lower()) <= d
        )
        assert int(nm_b[row]) == brute, (t, d)
        # (b) top-k ids/scores == the engine
        ref = search(
            Request.from_dict(
                {
                    "search_req": {
                        "search": {
                            "terms": [t],
                            "path": field,
                            "levenshtein_distance": d,
                        }
                    }
                }
            ),
            pers,
        )
        got_ids = [int(x) for x in ids_b[row][: len(ref.data)]]
        assert got_ids == [h.id for h in ref.data], (t, d)
        for gs, ws in zip(
            [float(x) for x in sc_b[row][: len(ref.data)]],
            [h.score for h in ref.data],
        ):
            assert gs == pytest.approx(ws, rel=1e-5), (t, d)
        assert int(nh_b[row]) == ref.num_hits, (t, d)
