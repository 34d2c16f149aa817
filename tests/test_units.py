"""Unit tests for core components (mirroring the reference's inline tests:
tokenizer src/tokenizer/mod.rs:32-77, doc store doc_store/src/lib.rs:64-185,
json flattener json_converter/src/lib.rs:168-224, path algebra
src/steps.rs:152-173, config parsing src/create/fields_config.rs:112-174,
expression src/expression.rs tests, levenshtein search_field.rs:734-744)."""

import json

import numpy as np
import pytest

from veloci_tpu.config import IndexCreationType, config_from_string
from veloci_tpu.doc_store import DocLoader, DocStoreWriter
from veloci_tpu.indices import Csr, TermDictionary, csr_from_pairs
from veloci_tpu.json_flatten import IDProvider, for_each_element, to_line_delimited
from veloci_tpu.ops.levenshtein import (
    levenshtein_distance_host,
    levenshtein_prefix_distance_host,
)
from veloci_tpu.search.boost import ScoreExpression
from veloci_tpu.tokenizer import GroupTokenizer, SimpleTokenizer
from veloci_tpu.utils import get_steps_to_anchor, normalize_text


def toks(tokenizer, text):
    return [t for t, _sep in tokenizer.iter(text)]


def test_tokenizer_grouped():
    t = GroupTokenizer()
    assert toks(t, "das \n ist ein txt, test") == [
        "das",
        " \n ",
        "ist",
        " ",
        "ein",
        " ",
        "txt",
        ", ",
        "test",
    ]


def test_tokenizer_simple():
    t = SimpleTokenizer()
    assert t.has_tokens("das \n ist ein txt, test")
    assert toks(t, "das \n ist ein txt, test") == [
        "das",
        " ",
        "\n",
        " ",
        "ist",
        " ",
        "ein",
        " ",
        "txt",
        ",",
        " ",
        "test",
    ]


def test_tokenizer_start_with_separator():
    t = GroupTokenizer()
    assert toks(t, " Taschenbuch (kartoniert)") == [
        " ",
        "Taschenbuch",
        " (",
        "kartoniert",
        ")",
    ]


def test_tokenizer_single_char_token():
    t = GroupTokenizer()
    assert toks(t, "T oll") == ["T", " ", "oll"]


def test_doc_store_roundtrip():
    w = DocStoreWriter()
    docs = ['{"test":"ok"}', '{"test2":"ok"}', '{"test3":"ok"}']
    for d in docs:
        w.add_doc(d)
    blob = w.finish()
    loader = DocLoader(blob)
    for i, d in enumerate(docs):
        assert loader.get_doc(i) == d


def test_doc_store_multi_block():
    w = DocStoreWriter()
    doc = '{"category": "superb", "tags": ["nice", "cool"] }'
    for _ in range(2640):
        w.add_doc(doc)
    blob = w.finish()
    loader = DocLoader(blob)
    for i in range(2640):
        assert loader.get_doc(i) == doc


def test_json_flattener_paths():
    seen = []
    ids_seen = []
    idp = IDProvider()
    for_each_element(
        [{"meanings": {"ger": ["karlo"]}}, {"a": "1"}],
        idp,
        lambda anchor, text, path, parent: seen.append((anchor, text, path, parent)),
        lambda anchor, path, vid, parent: ids_seen.append((anchor, path, vid, parent)),
    )
    assert seen == [(0, "karlo", "meanings.ger[]", 0), (1, "1", "a", 1)]
    assert ids_seen == [(0, "meanings.ger[]", 0, 0)]


def test_to_line_delimited():
    assert to_line_delimited('[{"a": "b"},{"c": "d"}]') == '{"a":"b"}\n{"c":"d"}\n'
    assert to_line_delimited('{  "a": "b"}{"c": "d"}') == '{"a":"b"}\n{"c":"d"}\n'


def test_steps_to_anchor():
    assert get_steps_to_anchor("meanings.ger[]") == [
        "meanings.ger[]",
        "meanings.ger[].textindex",
    ]
    assert get_steps_to_anchor("kanji[].text") == [
        "kanji[]",
        "kanji[].text.textindex",
    ]
    assert get_steps_to_anchor("commonness") == ["commonness.textindex"]


def test_config_from_json():
    cfg = config_from_string(
        json.dumps(
            {
                "MATNR": {
                    "facet": True,
                    "fulltext": {"tokenize": True},
                    "disabled_indices": [
                        "TokensToTextID",
                        "TokenToAnchorIDScore",
                        "PhrasePairToAnchor",
                        "TextIDToTokenIds",
                        "TextIDToParent",
                        "ParentToTextID",
                        "TextIDToAnchor",
                    ],
                },
                "ISMTITLE": {"fulltext": {"tokenize": True}, "features": ["Search"]},
                "ISMORIGTITLE": {
                    "fulltext": {"tokenize": True},
                    "disabled_features": ["Search"],
                },
                "ISMORIDCODE": {"fulltext": {"tokenize": False}},
            }
        )
    )
    cfg.features_to_indices()
    assert cfg.get("MATNR").facet
    assert not cfg.get("MATNR").is_index_enabled(IndexCreationType.TokensToTextID)
    assert cfg.get("ISMTITLE").is_index_enabled(IndexCreationType.TokenToAnchorIDScore)
    assert not cfg.get("ISMTITLE").is_index_enabled(IndexCreationType.TokensToTextID)
    assert not cfg.get("ISMORIDCODE").fulltext.tokenize


def test_config_from_toml():
    cfg = config_from_string(
        """
["*GLOBAL*"]
    features = ["All"]
["commonness"]
    facet = true
["commonness".boost]
    boost_type = "f32"
["meanings.ger[]"]
    stopwords = ["stopword"]
    ["meanings.ger[]".fulltext]
        tokenize = true
"""
    )
    cfg.features_to_indices()
    assert cfg.get("commonness").facet
    assert cfg.get("commonness").boost is not None


def test_expression():
    assert ScoreExpression("$SCORE + 2.0").get_score(10.0) == 12.0
    assert ScoreExpression("10.0 / $SCORE").get_score(10.0) == 1.0
    assert ScoreExpression("$SCORE * $SCORE").get_score(10.0) == 100.0


def test_expression_division_by_zero_is_ieee():
    """Defined semantics, silent: the reference evaluates `left / right` as
    Rust f32 (expression.rs:40) — x/0 = inf, 0/0 = NaN, no warning."""
    import warnings

    import numpy as np

    with warnings.catch_warnings():
        warnings.simplefilter("error")  # any RuntimeWarning fails the test
        assert ScoreExpression("$SCORE / 0.0").get_score(10.0) == float("inf")
        assert ScoreExpression("$SCORE / 0.0").get_score(-10.0) == float("-inf")
        assert np.isnan(ScoreExpression("$SCORE / 0.0").get_score(0.0))
        assert ScoreExpression("10.0 / $SCORE").get_score(0.0) == float("inf")


def test_boost_scalar_log_of_zero_is_ieee():
    """Zero-param Log boost on a 0 boost value: log10(0) = -inf in Rust f32
    (boost.rs:292-309) — defined and warning-free."""
    import warnings

    from veloci_tpu.query.request import RequestBoostPart
    from veloci_tpu.search.boost import apply_boost_scalar

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        b = RequestBoostPart(path="x", boost_fun="Log10", param=0)
        assert apply_boost_scalar(2.0, 0.0, b) == float("-inf")
        b2 = RequestBoostPart(path="x", boost_fun="Log2", param=0)
        assert apply_boost_scalar(2.0, 0.0, b2) == float("-inf")


def test_levenshtein_host():
    assert levenshtein_distance_host("a", "a") == 0
    assert levenshtein_distance_host("a", "b") == 1
    assert levenshtein_distance_host("", "a") == 1
    assert levenshtein_distance_host("aa", "a") == 1
    assert levenshtein_distance_host("a", "bbb") == 3
    assert levenshtein_prefix_distance_host("awe", "awesome") == 0
    assert levenshtein_prefix_distance_host("axe", "awesome") == 1


def test_levenshtein_sweep_matches_host():
    import jax.numpy as jnp

    from veloci_tpu.ops.levenshtein import encode_query, levenshtein_sweep

    terms = ["awesome", "awesam", "nice", "", "majestät", "a", "zz", "awe"]
    dictionary = TermDictionary(sorted(terms))
    chars, lengths = dictionary.char_matrix()
    for query in ["awesome", "awe", "majestat", "nize", "a"]:
        q, qlen = encode_query(query)
        dist, prefix_dist, is_prefix = levenshtein_sweep(
            jnp.asarray(chars), jnp.asarray(lengths), jnp.asarray(q), jnp.int32(qlen)
        )
        dist = np.asarray(dist)
        prefix_dist = np.asarray(prefix_dist)
        is_prefix = np.asarray(is_prefix)
        for i, t in enumerate(dictionary.terms):
            if not t:
                continue
            assert dist[i] == levenshtein_distance_host(query, t.lower()), (query, t)
            assert prefix_dist[i] == levenshtein_prefix_distance_host(
                query, t.lower()
            ), (query, t)
            assert bool(is_prefix[i]) == t.lower().startswith(query)


def test_csr_roundtrip():
    csr = csr_from_pairs([0, 0, 2, 2, 2], [5, 3, 1, 1, 2], 3, sort_and_dedup=True)
    assert list(csr.get_values(0)) == [3, 5]
    assert list(csr.get_values(1)) == []
    assert list(csr.get_values(2)) == [1, 2]
    assert list(csr.get_values_multi(np.array([0, 2]))) == [3, 5, 1, 2]


def test_normalize_text():
    assert normalize_text("Hello  (m) World") == "hello world"


def test_persistence_save_load(tmp_path):
    from veloci_tpu import Persistence, Request, search

    data = "\n".join(
        json.dumps(d)
        for d in [
            {"title": "die erbin", "commonness": 5},
            {"title": "der graf", "commonness": 10},
        ]
    )
    p = Persistence.create_from_str(data, "{}")
    p.save(str(tmp_path / "db"))
    p2 = Persistence.load(str(tmp_path / "db"))
    assert p2.num_docs == 2
    res = search(
        Request.from_dict(
            {"search_req": {"search": {"terms": ["erbin"], "path": "title"}}}
        ),
        p2,
    )
    assert len(res.data) == 1
    assert p2.doc_loader.get_doc(res.data[0].id) == json.dumps(
        {"title": "die erbin", "commonness": 5}
    )


def test_steps_between_field_paths():
    from veloci_tpu.utils import steps_between_field_paths

    assert steps_between_field_paths("meanings.ger[].text", "meanings.ger[].boost") == [
        "meanings.ger[].value_id_to_parent",
        "meanings.ger[].parent_to_value_id",
        "meanings.ger[].boost.parent_to_value_id",
    ]


def test_sweep_select_overflow_growth():
    """Device match selection grows its window when matches overflow."""
    import json

    from veloci_tpu import Persistence, Request, search

    # 2000 docs whose terms all match "common" within distance 1
    docs = [json.dumps({"t": f"common{i % 10}", "nr": str(i)}) for i in range(3000)]
    pers = Persistence.create_from_str("\n".join(docs), "{}")
    res = search(
        Request.from_dict(
            {
                "search_req": {
                    "search": {"terms": ["common1"], "path": "t", "levenshtein_distance": 1}
                },
                "top": 3000,
            }
        ),
        pers,
    )
    assert res.num_hits == 3000  # every doc matches within d=1


def test_lz_codec_roundtrip():
    """Native LZ block codec: roundtrip on text, runs, and random bytes."""
    import random

    from veloci_tpu.native import lz_available, lz_compress, lz_decompress

    if not lz_available():
        import pytest

        pytest.skip("native codec unavailable")
    random.seed(1234)
    cases = [
        b"",
        b"x",
        b"abcd" * 5000,
        bytes(random.getrandbits(8) for _ in range(20000)),
        ("der die das " * 2000).encode(),
        bytes(range(256)) * 100,
    ]
    for data in cases:
        comp = lz_compress(data)
        assert comp is not None
        assert lz_decompress(comp, len(data)) == data


def test_doc_store_codecs_interop(tmp_path, monkeypatch):
    """Blobs written with either codec load identically; legacy is rejected
    only when the magic is wrong."""
    import json

    from veloci_tpu.doc_store import DocLoader, DocStoreWriter

    docs = [json.dumps({"t": f"doc {i} " + "pad " * (i % 37)}) for i in range(4000)]

    blobs = {}
    for codec in ("zlib", "lz"):
        monkeypatch.setenv("VELOCI_DOCSTORE_CODEC", codec)
        w = DocStoreWriter()
        for d in docs:
            w.add_doc(d)
        blobs[codec] = w.finish()

    for codec, blob in blobs.items():
        loader = DocLoader(blob)
        assert loader.num_docs == len(docs)
        for i in (0, 1, 999, 2500, 3999):
            assert loader.get_doc(i) == docs[i]

    # lz blocks should be tagged as such
    assert blobs["lz"] != blobs["zlib"]


def test_spill_sorter_matches_argsort():
    """External sort (tiny chunks, many runs) == stable in-RAM argsort."""
    import numpy as np

    from veloci_tpu.spill import SpillSorter

    rng = np.random.default_rng(3)
    keys = rng.integers(0, 50, size=30_000, dtype=np.uint64)  # heavy duplicates
    vals = np.arange(30_000, dtype=np.uint64)  # payload encodes input order
    with SpillSorter(chunk_items=1024) as s:
        # feed in uneven slices
        i = 0
        for sz in (100, 5000, 1, 24899):
            s.add(keys[i : i + sz], vals[i : i + sz])
            i += sz
        k, v = s.finish()
        order = np.argsort(keys, kind="stable")
        np.testing.assert_array_equal(np.asarray(k), keys[order])
        np.testing.assert_array_equal(np.asarray(v), vals[order])


def test_spill_sorter_single_key():
    """A single key dominating whole blocks exercises the drain path."""
    import numpy as np

    from veloci_tpu.spill import SpillSorter

    keys = np.full(10_000, 7, dtype=np.uint64)
    keys[:3] = [1, 2, 3]
    keys[-2:] = [9, 11]
    vals = np.arange(10_000, dtype=np.uint64)
    with SpillSorter(chunk_items=1500) as s:
        s.add(keys, vals)
        k, v = s.finish()
        order = np.argsort(keys, kind="stable")
        np.testing.assert_array_equal(np.asarray(k), keys[order])
        np.testing.assert_array_equal(np.asarray(v), vals[order])


def test_spill_build_parity(monkeypatch):
    """Anchor-score packing through the spill path is bit-identical to the
    in-RAM path."""
    import numpy as np

    from veloci_tpu import create as create_mod
    from tests.corpus import TEST_CONFIG, data_ndjson

    built_ram = create_mod.create_indices_from_str(data_ndjson(), TEST_CONFIG)
    monkeypatch.setattr(create_mod._spill(), "SPILL_PAIRS", 1)
    monkeypatch.setattr(create_mod._spill(), "_BLOCK", 64)
    try:
        built_spill = create_mod.create_indices_from_str(data_ndjson(), TEST_CONFIG)
    finally:
        pass
    assert built_ram.anchor_scores.keys() == built_spill.anchor_scores.keys()
    for key, a in built_ram.anchor_scores.items():
        b = built_spill.anchor_scores[key]
        np.testing.assert_array_equal(a.offsets, b.offsets)
        np.testing.assert_array_equal(a.anchors, b.anchors)
        np.testing.assert_array_equal(a.scores, b.scores)


def test_fused_banded_fuzzy_parity():
    """fuzzy_search_topk_banded (the sweep kernel at Q=1, interpret mode)
    == XLA-sweep fused step."""
    import numpy as np
    import jax.numpy as jnp

    from veloci_tpu.ops.fuzzy_step import fuzzy_search_topk, fuzzy_search_topk_banded
    from veloci_tpu.ops.levenshtein import encode_query

    rng = np.random.default_rng(5)
    words = [f"w{i:03d}" for i in range(500)] + ["hello", "help", "hells"]
    n_pad = 1024
    chars = np.zeros((n_pad, 32), np.uint16)
    lens = np.zeros(n_pad, np.int32)
    for i, w in enumerate(words):
        for j, ch in enumerate(w[:32]):
            chars[i, j] = ord(ch)
        lens[i] = len(w)
    chars_t = np.ascontiguousarray(chars.T)
    num_docs = 2000
    nnz = 5000
    offs = np.zeros(n_pad + 2, np.int32)
    offs[1 : len(words) + 1] = np.sort(rng.integers(0, nnz, len(words)))
    offs[len(words) + 1 :] = nnz
    offs = np.maximum.accumulate(offs)
    anc = rng.integers(0, num_docs, nnz).astype(np.int32)
    sc = rng.random(nnz, np.float32)
    for term, d in [("w001", 1), ("hela", 2), ("w0x5", 2)]:
        q, ql = encode_query(term)
        a = fuzzy_search_topk(
            jnp.asarray(chars), jnp.asarray(lens), jnp.asarray(q), jnp.int32(ql),
            jnp.int32(d), jnp.asarray(offs), jnp.asarray(anc), jnp.asarray(sc),
            max_terms=64, capacity=2048, num_docs=num_docs, k=10,
        )
        b = fuzzy_search_topk_banded(
            jnp.asarray(chars_t), jnp.asarray(lens), jnp.asarray(q), jnp.int32(ql),
            jnp.int32(d), jnp.asarray(offs), jnp.asarray(anc), jnp.asarray(sc),
            max_terms=64, capacity=2048, num_docs=num_docs, k=10, interpret=True,
        )
        for x, y in zip(a, b):
            np.testing.assert_allclose(np.asarray(x), np.asarray(y), rtol=1e-6)


def test_spill_phrase_parity(monkeypatch):
    """Phrase packing through the two-pass external sort is bit-identical."""
    import numpy as np

    from veloci_tpu import create as create_mod
    from tests.corpus import TEST_CONFIG, data_ndjson

    built_ram = create_mod.create_indices_from_str(data_ndjson(), TEST_CONFIG)
    monkeypatch.setattr(create_mod._spill(), "SPILL_PAIRS", 1)
    built_spill = create_mod.create_indices_from_str(data_ndjson(), TEST_CONFIG)
    assert built_ram.phrase_indices.keys() == built_spill.phrase_indices.keys()
    assert len(built_ram.phrase_indices) > 0
    for key, a in built_ram.phrase_indices.items():
        b = built_spill.phrase_indices[key]
        np.testing.assert_array_equal(a.keys, b.keys)
        np.testing.assert_array_equal(a.offsets, b.offsets)
        np.testing.assert_array_equal(a.values, b.values)


def test_spill_csr_from_pairs_parity(monkeypatch):
    import numpy as np

    import veloci_tpu.spill as spill_mod
    from veloci_tpu.indices import csr_from_pairs

    rng = np.random.default_rng(11)
    keys = rng.integers(0, 200, 50_000)
    vals = rng.integers(0, 1000, 50_000).astype(np.uint32)
    ram = csr_from_pairs(keys, vals, 200, sort_and_dedup=True)
    monkeypatch.setattr(spill_mod, "SPILL_PAIRS", 1)
    sp = csr_from_pairs(keys, vals, 200, sort_and_dedup=True)
    np.testing.assert_array_equal(ram.offsets, sp.offsets)
    np.testing.assert_array_equal(ram.values, sp.values)


def test_batched_banded_fuzzy_parity():
    """batched_fuzzy_search_topk_banded (the sweep kernel, interpret mode)
    == per-query XLA step, including the total_postings overflow report."""
    import numpy as np
    import jax.numpy as jnp

    from veloci_tpu.ops.fuzzy_step import (
        batched_fuzzy_search_topk_banded,
        fuzzy_search_topk,
    )
    from veloci_tpu.ops.levenshtein import encode_query

    rng = np.random.default_rng(5)
    words = [f"w{i:03d}" for i in range(500)] + ["hello", "help", "hells"]
    n_pad = 1024
    chars = np.zeros((n_pad, 32), np.uint16)
    lens = np.zeros(n_pad, np.int32)
    for i, w in enumerate(words):
        for j, ch in enumerate(w[:32]):
            chars[i, j] = ord(ch)
        lens[i] = len(w)
    chars_t = np.ascontiguousarray(chars.T)
    num_docs = 2000
    nnz = 5000
    offs = np.zeros(n_pad + 2, np.int32)
    offs[1 : len(words) + 1] = np.sort(rng.integers(0, nnz, len(words)))
    offs[len(words) + 1 :] = nnz
    offs = np.maximum.accumulate(offs)
    anc = rng.integers(0, num_docs, nnz).astype(np.int32)
    sc = rng.random(nnz, np.float32)

    terms = [("w001", 1), ("hela", 2), ("w0x5", 2), ("help", 0)]
    queries = np.zeros((len(terms), 32), np.uint16)
    qlens = np.zeros(len(terms), np.int32)
    dists = np.zeros(len(terms), np.int32)
    for row, (t, d) in enumerate(terms):
        q, ql = encode_query(t)
        queries[row] = q
        qlens[row] = ql
        dists[row] = d
    got = batched_fuzzy_search_topk_banded(
        jnp.asarray(chars_t), jnp.asarray(lens), jnp.asarray(queries),
        jnp.asarray(qlens), jnp.asarray(dists),
        jnp.asarray(offs), jnp.asarray(anc), jnp.asarray(sc),
        max_terms=64, capacity=2048, num_docs=num_docs, k=10, interpret=True,
    )
    # the narrow Ukkonen band (band=2) must agree for d<=2 batches — the
    # band the serving paths compile for auto-lev traffic
    got2 = batched_fuzzy_search_topk_banded(
        jnp.asarray(chars_t), jnp.asarray(lens), jnp.asarray(queries),
        jnp.asarray(qlens), jnp.asarray(dists),
        jnp.asarray(offs), jnp.asarray(anc), jnp.asarray(sc),
        max_terms=64, capacity=2048, num_docs=num_docs, k=10, interpret=True,
        band=2,
    )
    for row, (t, d) in enumerate(terms):
        q, ql = encode_query(t)
        want = fuzzy_search_topk(
            jnp.asarray(chars), jnp.asarray(lens), jnp.asarray(q), jnp.int32(ql),
            jnp.int32(d), jnp.asarray(offs), jnp.asarray(anc), jnp.asarray(sc),
            max_terms=64, capacity=2048, num_docs=num_docs, k=10,
        )
        for x, y in zip(got, want):
            np.testing.assert_allclose(
                np.asarray(x)[row], np.asarray(y), rtol=1e-6
            )
        for x, y in zip(got2, want):
            np.testing.assert_allclose(
                np.asarray(x)[row], np.asarray(y), rtol=1e-6
            )


def test_explain_plan_renders_compiler_structure():
    """explain_plan shows the executed-plan structure: dedup cache reuse,
    the once-computed filter broadcast, the 1:n boost split and the chosen
    execution path."""
    from veloci_tpu import Persistence, Request
    from veloci_tpu.search.executor import explain_plan

    pers = Persistence.create_from_str(
        '{"a": "x y", "tags": ["t"], "common": "3"}', "{}"
    )
    req = Request.from_dict(
        {
            "search_req": {
                "or": {
                    "queries": [
                        {"search": {"terms": ["x"], "path": "a"}},
                        {"search": {"terms": ["y"], "path": "a"}},
                    ]
                }
            },
            # the filter reuses the same part as the first leaf -> dedup x2
            "filter": {"search": {"terms": ["x"], "path": "a"}},
            "boost": [{"path": "common", "boost_fun": "Log10", "param": 1}],
            "phrase_boosts": [
                {
                    "search1": {"terms": ["x"], "path": "a"},
                    "search2": {"terms": ["y"], "path": "a"},
                }
            ],
            "facets": [{"field": "tags[]"}],
        }
    )
    dot = explain_plan(req, pers)
    # the chosen path depends on the device threshold (the env matrix runs
    # this suite with VELOCI_DEVICE_MIN_DOCS=1, flipping it to device tree)
    assert (
        "execution path: host tree" in dot
        or "execution path: device tree" in dot
    )
    assert "reused x" in dot  # the FieldRequestCache dedup is visible
    assert "filter mask (computed ONCE, broadcast)" in dot
    assert "phrase_pair_to_anchor" in dot
    assert "facet counts" in dot
    assert "union" in dot
    assert dot.count("field_search") == 2  # x/a (reused) + y/a — deduped


def test_explain_plan_shows_1n_boost_split():
    from veloci_tpu import Persistence, Request
    from veloci_tpu.search.executor import explain_plan

    pers = Persistence.create_from_str('{"k": [{"t": "v", "c": "2"}]}', "{}")
    req = Request.from_dict(
        {
            "search_req": {"search": {"terms": ["v"], "path": "k[].t"}},
            "boost": [{"path": "k[].c", "boost_fun": "Log10", "param": 1}],
        }
    )
    dot = explain_plan(req, pers)
    assert "boost_to_anchor" in dot
    assert "apply_anchor_boost" in dot


def test_native_radix_sorts_match_numpy():
    """Fuzz the native LSD radix sorts (u64, u64-key/u32-payload stable,
    lexicographic pair) against numpy across sizes incl. empty/tiny."""
    import numpy as np

    from veloci_tpu import native

    if not native.native_available():
        import pytest

        pytest.skip("native lib unavailable")
    rng = np.random.default_rng(7)
    for n in [0, 1, 2, 5, 63, 1000, 40001]:
        a = rng.integers(0, 1 << 63, size=n, dtype=np.uint64)
        b = a.copy()
        assert native.sort_u64(a)
        assert np.array_equal(a, np.sort(b))
        k = rng.integers(0, 1 << 40, size=n, dtype=np.uint64)
        # few distinct keys -> exercises the stable (payload-order) contract
        k = k % 17 if n else k
        v = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
        k2, v2 = k.copy(), v.copy()
        assert native.sort_kv_u64_u32(k2, v2)
        order = np.argsort(k, kind="stable")
        assert np.array_equal(k2, k[order]) and np.array_equal(v2, v[order])
        k3, v3 = k.copy(), v.copy()
        assert native.lexsort_kv_u64_u32(k3, v3)
        order = np.lexsort((v, k))
        assert np.array_equal(k3, k[order]) and np.array_equal(v3, v[order])


def _edge_dictionary():
    """Dictionary + queries at the kernel's edge lengths (0, 1, 31, 32)."""
    import numpy as np

    from veloci_tpu.ops.levenshtein import encode_query

    words = (
        [f"w{i:03d}" for i in range(300)]
        + ["a", "ab", "hello", "help", "hells", "x" * 31, "x" * 32, "x" * 30]
        + ["xy" * 16, "y" + "x" * 31]
    )
    n_pad = 1024
    chars = np.zeros((n_pad, 32), np.uint16)
    lens = np.zeros(n_pad, np.int32)
    for i, w in enumerate(words):
        for j, ch in enumerate(w[:32]):
            chars[i, j] = ord(ch)
        lens[i] = len(w)
    qterms = ["", "a", "w01", "hela", "x" * 31, "x" * 32, "w0015", "xy" * 16]
    queries = np.zeros((len(qterms), 32), np.uint16)
    qlens = np.zeros(len(qterms), np.int32)
    for row, t in enumerate(qterms):
        queries[row], qlens[row] = encode_query(t)
    return chars, lens, queries, qlens


def test_dynlen_banded_batch_parity():
    """The banded sweep kernel (interpret mode) == levenshtein_sweep, bit
    for bit: distances wherever they are <= band (_BIG beyond), prefix
    flags everywhere, at query lengths 0, 1, 31 and 32, for both bands."""
    for band in (2, 4):
        _check_band_parity(band)


def _check_band_parity(band):
    import numpy as np
    import jax.numpy as jnp

    from veloci_tpu.ops.levenshtein import levenshtein_sweep
    from veloci_tpu.ops.pallas_levenshtein import _BIG, banded_sweep

    chars, lens, queries, qlens = _edge_dictionary()
    assert set(qlens.tolist()) >= {0, 1, 31, 32}
    dist, pref = banded_sweep(
        jnp.asarray(np.ascontiguousarray(chars.T)), jnp.asarray(lens),
        jnp.asarray(queries), jnp.asarray(qlens), band=band, interpret=True,
    )
    assert dist.dtype == jnp.int32 and pref.dtype == jnp.bool_
    for row in range(len(qlens)):
        d, _pd, p = levenshtein_sweep(
            jnp.asarray(chars), jnp.asarray(lens), jnp.asarray(queries[row]),
            jnp.int32(qlens[row]),
        )
        d = np.asarray(d)
        np.testing.assert_array_equal(
            np.asarray(dist[row]), np.where(d <= band, d, _BIG)
        )
        np.testing.assert_array_equal(np.asarray(pref[row]), np.asarray(p))


@pytest.mark.parametrize("q", [1, 3, 40])
def test_banded_sweep_pads_queries_and_terms(q):
    """Query and term axes that are not multiples of the kernel blocks pad
    inside the wrapper and slice back: shapes [Q, N] out, pad rows never
    leak into real rows. Q=1 is the single-query call."""
    import numpy as np
    import jax.numpy as jnp

    from veloci_tpu.ops.pallas_levenshtein import banded_sweep

    chars, lens, queries, qlens = _edge_dictionary()
    n = 700  # not a multiple of the 256-term block
    rows = np.arange(q) % len(qlens)
    dist, pref = banded_sweep(
        jnp.asarray(np.ascontiguousarray(chars[:n].T)), jnp.asarray(lens[:n]),
        jnp.asarray(queries[rows]), jnp.asarray(qlens[rows]), band=2,
        interpret=True,
    )
    assert dist.shape == (q, n) and pref.shape == (q, n)
    full, full_p = banded_sweep(
        jnp.asarray(np.ascontiguousarray(chars.T)), jnp.asarray(lens),
        jnp.asarray(queries), jnp.asarray(qlens), band=2, interpret=True,
    )
    np.testing.assert_array_equal(np.asarray(dist), np.asarray(full)[rows, :n])
    np.testing.assert_array_equal(np.asarray(pref), np.asarray(full_p)[rows, :n])


def test_banded_block_q_fills_the_card():
    """Queries per program grow only while the grid keeps enough programs
    to fill the card, and never past the query count."""
    from veloci_tpu.ops.pallas_levenshtein import _MIN_PROGRAMS, _block_q

    assert _block_q(1, 4096) == 1
    assert _block_q(128, 8) == 1  # small window: one query per program
    big = _block_q(128, 4096)  # 1M-term dictionary
    assert big == 16 and 4096 * (128 // big) >= _MIN_PROGRAMS
    for q, nb in [(64, 256), (128, 256), (3, 4096), (64, 1)]:
        bq = _block_q(q, nb)
        assert 1 <= bq <= max(q, 1)
        assert bq == 1 or nb * -(-q // bq) >= _MIN_PROGRAMS


@pytest.mark.parametrize(
    "platform,route", [("gpu", "kernel"), ("cpu", "xla"), ("metal", None)]
)
def test_sweep_route_by_platform(monkeypatch, platform, route):
    """gpu -> the kernel, cpu -> the XLA sweep, anything else -> an error
    (no silent fallback)."""
    import jax

    from veloci_tpu.ops import pallas_levenshtein as pk

    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    if route is None:
        with pytest.raises(RuntimeError, match=platform):
            pk.sweep_route()
        with pytest.raises(RuntimeError):
            pk.use_banded_kernel(2)
        return
    assert pk.sweep_route() == route
    assert pk.use_banded_kernel(2) is (route == "kernel")
    assert pk.use_banded_kernel(4) is (route == "kernel")
    # starts_with and distances past the widest band stay on the XLA sweep
    assert pk.use_banded_kernel(5) is False
    assert pk.use_banded_kernel(1, starts_with=True) is False


def test_sweep_kernel_error_propagates(monkeypatch):
    """With the kernel route chosen, a kernel failure fails the request: no
    degrade to the XLA sweep."""
    from veloci_tpu import Persistence, Request
    from veloci_tpu.ops import pallas_levenshtein as pk
    from veloci_tpu.search import executor as ex
    from veloci_tpu.search.field_search import prefetch_fuzzy_matches

    def boom(*_a, **_k):
        raise RuntimeError("kernel compile failed")

    monkeypatch.setattr(pk, "sweep_route", lambda: "kernel")
    monkeypatch.setattr(pk, "banded_sweep", boom)
    monkeypatch.setattr(ex, "SMALL_DOCS", 0)
    pers = Persistence.create_from_str(
        "\n".join('{"t": "hello w%d"}' % i for i in range(50)), "{}"
    )
    with pytest.raises(RuntimeError, match="kernel compile failed"):
        prefetch_fuzzy_matches(pers, [("t", "helo", 1, False)])
    req = Request.from_dict(
        {"search_req": {"search": {"terms": ["helo"], "path": "t",
                                   "levenshtein_distance": 1}}}
    )
    with pytest.raises(RuntimeError, match="kernel compile failed"):
        ex.search(req, pers)


def test_tokenizer_pieces_matches_iter():
    """GroupTokenizer.pieces (C-speed re.split) == iter() on adversarial
    inputs: leading/trailing/consecutive separators, unicode separators,
    empty text, separator-only text, regex-special separator chars."""
    import numpy as np

    from veloci_tpu.tokenizer import DEFAULT_SEPARATORS, GroupTokenizer

    cases = [
        "",
        " ",
        "   ",
        "a",
        "das \n ist",
        ", leading",
        "trailing ,",
        "a,b..c…d・e—f",
        "[bracket]{brace}<angle>'q'\"d\"“s™",
        "multi  space\t\ttabs\n\nnewlines",
        "ünï-cødé tøkens…",
    ]
    rng = np.random.default_rng(4)
    alphabet = list("abcXYZ09üé") + list(DEFAULT_SEPARATORS)
    for _ in range(200):
        n = int(rng.integers(0, 30))
        cases.append("".join(rng.choice(alphabet, size=n)))
    for seps in (None, [" ", ","], ["]", "[", "-"], ["x"]):
        tk = GroupTokenizer(seps)
        for text in cases:
            assert tk.pieces(text) == list(tk.iter(text)), (seps, text)


def test_block_gather_matches_element_gather():
    """The 16-row block posting gather (search_step._gather_postings packed
    path) must produce the same valid (anchor, score, slot) multiset as the
    per-element path — edge blocks mask misaligned head/tail elements to
    the pad sentinels. Randomized over ragged run profiles incl. empty
    runs, -1 pads and a dominant zipf head."""
    import jax.numpy as jnp

    from veloci_tpu.ops.search_step import _gather_postings

    rng = np.random.default_rng(7)
    for trial in range(8):
        nt = int(rng.integers(8, 60))
        counts = rng.integers(0, 50, size=nt)
        counts[rng.integers(0, nt)] = rng.integers(100, 300)
        off = np.zeros(nt + 2, np.int32)
        np.cumsum(counts, out=off[1 : nt + 1])
        off[nt + 1] = off[nt]
        nnz = int(off[nt])
        pad = ((nnz + 4096 + 127) // 128) * 128
        packed = np.zeros((pad, 2), np.int32)
        packed[:nnz, 0] = rng.integers(0, 1000, size=nnz)
        packed[:nnz, 1] = rng.random(nnz, dtype=np.float32).view(np.int32)
        tsel = rng.permutation(nt)[:8].astype(np.int32)
        tsel[0] = -1
        tsc = rng.random(8).astype(np.float32)
        tslot = rng.integers(0, 4, size=8).astype(np.int32)
        cap = 512
        a1, s1, sl1 = _gather_postings(
            jnp.asarray(off), None, None, jnp.asarray(tsel),
            jnp.asarray(tsc), cap, 1000, term_slots=jnp.asarray(tslot),
            packed=jnp.asarray(packed),
        )
        a2, s2, sl2 = _gather_postings(
            jnp.asarray(off), jnp.asarray(packed[:, 0].copy()),
            jnp.asarray(packed[:, 1].view(np.float32).copy()),
            jnp.asarray(tsel), jnp.asarray(tsc), cap, 1000,
            term_slots=jnp.asarray(tslot),
        )

        def multiset(a, s, sl):
            a, s, sl = np.asarray(a), np.asarray(s), np.asarray(sl)
            m = np.isfinite(s) & (a < 1000)
            return sorted(
                zip(a[m].tolist(), s[m].astype(np.float64).tolist(), sl[m].tolist())
            )

        assert multiset(a1, s1, sl1) == multiset(a2, s2, sl2), f"trial {trial}"
