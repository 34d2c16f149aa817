"""Canonical query-language shapes through the batched tree kernel.

The reference's primary user surface — ``GET /<db>/search?query=…`` — runs
free text through the query generator, which auto-assigns
levenshtein_distance 0/1/2 by term length and expands every term across all
searchable fields (reference src/query_generator.rs:85-99,
query_parser_to_veloci_request.rs:82-110). The resulting shapes are a flat
OR with FUZZY leaves (``"mein buch"``) and an AND of per-term ORs
(``"mein AND buch"``). Round 2 executed both per request; round 3 batches
them through the sorted tree kernel (`ops/tree_step.batched_tree_topk`)
with the fuzzy term sweeps bulk-primed by `prefetch_fuzzy_matches`.

Parity reference: the HOST executor (SMALL_DOCS forced high so `search`
takes the numpy tree path, not the same device kernels under test).
"""

import importlib

import pytest

from corpus import TEST_CONFIG, data_ndjson
from veloci_tpu import Persistence, Request, search
from veloci_tpu.query.generator import (
    SearchQueryGeneratorParameters as P,
    search_query,
)

batch_mod = importlib.import_module("veloci_tpu.search.batch")
ex_mod = importlib.import_module("veloci_tpu.search.executor")


@pytest.fixture(scope="module")
def pers():
    return Persistence.create_from_str(data_ndjson(), TEST_CONFIG)


def _host_search(monkeypatch, pers, req):
    """Per-request HOST executor (numpy tree) as the parity reference."""
    monkeypatch.setattr(batch_mod, "SMALL_DOCS", 1 << 60)
    monkeypatch.setattr(ex_mod, "SMALL_DOCS", 1 << 60)
    try:
        return search(req, pers)
    finally:
        monkeypatch.setattr(batch_mod, "SMALL_DOCS", 1)
        monkeypatch.setattr(ex_mod, "SMALL_DOCS", 1)


def _tuple(res):
    return (
        res.num_hits,
        [h.id for h in res.data],
        [round(float(h.score), 4) for h in res.data],
        {k: list(v) for k, v in (res.facets or {}).items()} or None,
    )


def _assert_parity(monkeypatch, pers, dicts_or_reqs, check_route=None):
    reqs = [
        Request.from_dict(d) if isinstance(d, dict) else d
        for d in dicts_or_reqs
    ]
    monkeypatch.setattr(batch_mod, "SMALL_DOCS", 1)
    monkeypatch.setattr(ex_mod, "SMALL_DOCS", 1)
    if check_route is not None:
        comb = pers.device_combined()
        batch_mod._prefetch_request_fuzzy(pers, reqs)
        for r in reqs:
            if check_route == "plain":
                assert batch_mod._plain_eligible(r, pers, comb) is not None, (
                    r.to_dict() if hasattr(r, "to_dict") else r
                )
            elif check_route == "generic":
                assert (
                    batch_mod._generic_eligible(r, pers, comb) is not None
                )
    got_batch = batch_mod.search_batch(
        [
            Request.from_dict(d) if isinstance(d, dict) else d
            for d in dicts_or_reqs
        ],
        pers,
    )
    for d, br in zip(dicts_or_reqs, got_batch):
        req2 = Request.from_dict(d) if isinstance(d, dict) else d
        ref = _host_search(monkeypatch, pers, req2)
        got, want = _tuple(br), _tuple(ref)
        assert got[0] == want[0], (d, got, want)
        assert got[1] == want[1], (d, got, want)
        for gs, ws in zip(got[2], want[2]):
            assert gs == pytest.approx(ws, rel=1e-4), (d, got, want)
        assert got[3] == want[3], (d, got, want)


FUZZY_TREE_REQUESTS = [
    # flat OR with fuzzy leaves across fields (the "mein buch" shape)
    {
        "search_req": {
            "or": {
                "queries": [
                    {
                        "search": {
                            "terms": ["majestat"],
                            "path": "meanings.ger[]",
                            "levenshtein_distance": 1,
                        }
                    },
                    {
                        "search": {
                            "terms": ["majestat"],
                            "path": "meanings.eng[]",
                            "levenshtein_distance": 1,
                        }
                    },
                    {
                        "search": {
                            "terms": ["anblick"],
                            "path": "meanings.ger[]",
                            "levenshtein_distance": 1,
                        }
                    },
                ]
            }
        }
    },
    # fuzzy + exact mixed OR
    {
        "search_req": {
            "or": {
                "queries": [
                    {
                        "search": {
                            "terms": ["majestat"],
                            "path": "meanings.ger[]",
                            "levenshtein_distance": 2,
                        }
                    },
                    {"search": {"terms": ["urge"], "path": "meanings.eng[]"}},
                ]
            }
        }
    },
    # AND of fuzzy leaves
    {
        "search_req": {
            "and": {
                "queries": [
                    {
                        "search": {
                            "terms": ["majestat"],
                            "path": "meanings.ger[]",
                            "levenshtein_distance": 1,
                        }
                    },
                    {
                        "search": {
                            "terms": ["majestik"],
                            "path": "meanings.eng[]",
                            "levenshtein_distance": 2,
                        }
                    },
                ]
            }
        }
    },
]

AND_OF_ORS_REQUESTS = [
    # the "mein AND buch" shape: AND of per-term field-expanded ORs
    {
        "search_req": {
            "and": {
                "queries": [
                    {
                        "or": {
                            "queries": [
                                {
                                    "search": {
                                        "terms": ["majestat"],
                                        "path": "meanings.ger[]",
                                        "levenshtein_distance": 1,
                                    }
                                },
                                {
                                    "search": {
                                        "terms": ["majestat"],
                                        "path": "meanings.eng[]",
                                        "levenshtein_distance": 1,
                                    }
                                },
                            ]
                        }
                    },
                    {
                        "or": {
                            "queries": [
                                {
                                    "search": {
                                        "terms": ["anblick"],
                                        "path": "meanings.ger[]",
                                        "levenshtein_distance": 1,
                                    }
                                },
                                {
                                    "search": {
                                        "terms": ["anblick"],
                                        "path": "meanings.eng[]",
                                        "levenshtein_distance": 1,
                                    }
                                },
                            ]
                        }
                    },
                ]
            }
        }
    },
    # mixed: AND of (leaf, OR-group), exact + fuzzy
    {
        "search_req": {
            "and": {
                "queries": [
                    {"search": {"terms": ["majestät"], "path": "meanings.ger[]"}},
                    {
                        "or": {
                            "queries": [
                                {
                                    "search": {
                                        "terms": ["majestik"],
                                        "path": "meanings.eng[]",
                                        "levenshtein_distance": 2,
                                    }
                                },
                                {"search": {"terms": ["urge"], "path": "meanings.eng[]"}},
                            ]
                        }
                    },
                ]
            }
        }
    },
]

TREE_WITH_EXTRAS = [
    # AND-of-ORs + boost column
    {
        **AND_OF_ORS_REQUESTS[0],
        "boost": [{"path": "commonness", "boost_fun": "Log10", "param": 1}],
    },
    # fuzzy flat OR + filter + facets
    {
        **FUZZY_TREE_REQUESTS[0],
        "filter": {"search": {"terms": ["1587680"], "path": "ent_seq"}},
        "facets": [{"field": "tags[]"}],
    },
    # fuzzy OR + phrase boost
    {
        **FUZZY_TREE_REQUESTS[0],
        "phrase_boosts": [
            {
                "search1": {"terms": ["majestätischer"], "path": "meanings.ger[]"},
                "search2": {"terms": ["anblick"], "path": "meanings.ger[]"},
            }
        ],
    },
]


def test_fuzzy_trees_take_plain_batch_path(pers, monkeypatch):
    _assert_parity(monkeypatch, pers, FUZZY_TREE_REQUESTS, check_route="plain")


def test_and_of_ors_take_plain_batch_path(pers, monkeypatch):
    _assert_parity(monkeypatch, pers, AND_OF_ORS_REQUESTS, check_route="plain")


def test_tree_with_extras_take_generic_batch_path(pers, monkeypatch):
    _assert_parity(monkeypatch, pers, TREE_WITH_EXTRAS, check_route="generic")


def test_generator_queries_batch(pers, monkeypatch):
    """End-to-end: free text through the generator (auto-levenshtein, field
    expansion) -> search_batch, against the host executor."""
    queries = [
        "majestat",  # len 8 -> distance 2 leaves on every field
        "majestat anblick",  # flat OR, two fuzzy terms
        "majestat AND anblick",  # AND of per-term ORs
        "urge",  # len 4 -> distance 1
        "will AND testo",
    ]
    reqs = [search_query(pers, P(search_term=q)) for q in queries]
    monkeypatch.setattr(batch_mod, "SMALL_DOCS", 1)
    monkeypatch.setattr(ex_mod, "SMALL_DOCS", 1)
    comb = pers.device_combined()
    batch_mod._prefetch_request_fuzzy(pers, reqs)
    for q, r in zip(queries, reqs):
        assert batch_mod._plain_eligible(r, pers, comb) is not None, q
    _assert_parity(
        monkeypatch, pers, [search_query(pers, P(search_term=q)) for q in queries]
    )


def test_single_fused_matches_host(pers, monkeypatch):
    """search() routes generator shapes through ONE fused program
    (search_single_fused) with host parity."""
    monkeypatch.setattr(batch_mod, "SMALL_DOCS", 1)
    monkeypatch.setattr(ex_mod, "SMALL_DOCS", 1)
    for d in FUZZY_TREE_REQUESTS + AND_OF_ORS_REQUESTS + TREE_WITH_EXTRAS:
        req = Request.from_dict(d)
        fused = batch_mod.search_single_fused(req, pers)
        assert fused is not None, d
        ref = _host_search(monkeypatch, pers, Request.from_dict(d))
        got, want = _tuple(fused), _tuple(ref)
        assert got[0] == want[0], (d, got, want)
        assert got[1] == want[1], (d, got, want)
        for gs, ws in zip(got[2], want[2]):
            assert gs == pytest.approx(ws, rel=1e-4), (d, got, want)


def test_prefetch_primes_memo(pers, monkeypatch):
    monkeypatch.setattr(batch_mod, "SMALL_DOCS", 1)
    monkeypatch.setattr(ex_mod, "SMALL_DOCS", 1)
    from veloci_tpu.search.field_search import _fuzzy_match_cache

    reqs = [Request.from_dict(d) for d in FUZZY_TREE_REQUESTS]
    _fuzzy_match_cache(pers).clear()
    batch_mod._prefetch_request_fuzzy(pers, reqs)
    memo = _fuzzy_match_cache(pers)
    assert ("meanings.ger[]", "majestat", 1, False) in memo
    assert ("meanings.eng[]", "majestat", 1, False) in memo
    # prefetched results equal the solo sweep results
    import numpy as np

    m, d, p = memo[("meanings.ger[]", "majestat", 1, False)]
    memo2 = dict(memo)
    memo.clear()
    m2, d2, p2 = ex_mod.get_term_ids_in_field.__globals__[
        "_match_fuzzy_device"
    ](pers, "meanings.ger[]", "majestat", 1, False)
    assert np.array_equal(m, m2) and np.array_equal(d, d2)
    assert np.array_equal(p, p2)


# ---------------------------------------------------------------- round 3:
# multi-chunk adaptive retries and the sort-capacity cap


@pytest.fixture(scope="module")
def big_fuzzy_pers():
    """700 docs sharing one term: any d=1 query near "buch" matches ~700
    postings — enough to overflow a 64-capacity pass 1 and trigger the
    adaptive re-dispatch."""
    import json

    docs = []
    for i in range(700):
        docs.append(
            json.dumps({"title": f"buch lesen w{i % 37}", "tag": f"t{i % 2}"})
        )
    docs.append(json.dumps({"title": "buchx lesen", "tag": "t0"}))
    # filters need the TextIDToAnchor index (reference feature gating:
    # features.rs:74-78 — disabled under the default feature set). NOTE the
    # filter term must be a full text value, not a bare token — reference
    # parity: "No Filter are possible on tokens" (search_field.rs:471)
    cfg = '["*GLOBAL*"]\nfeatures = ["All"]\n'
    return Persistence.create_from_str("\n".join(docs), cfg)


def _fuzzy_filter_req(term):
    return {
        "search_req": {
            "search": {
                "terms": [term],
                "path": "title",
                "levenshtein_distance": 1,
            }
        },
        "filter": {"search": {"terms": ["t0"], "path": "tag"}},
        "top": 10,
    }


def test_fuzzy_generic_multichunk_retry_answers_every_chunk(
    big_fuzzy_pers, monkeypatch
):
    """Regression: the fuzzy-generic runner's capacity retry callback
    late-bound the LAST chunk's dispatch closure, so with more than one
    chunk an overflowing earlier chunk re-dispatched the wrong queries and
    its own requests were never answered (results stayed None)."""
    pers = big_fuzzy_pers
    monkeypatch.setattr(batch_mod, "SMALL_DOCS", 1)
    monkeypatch.setattr(ex_mod, "SMALL_DOCS", 1)
    monkeypatch.setenv("VELOCI_FUZZY_CHUNK_Q", "1")  # one chunk per query
    pers._fuzzy_cap_hint = {"title": 64}  # force pass-1 overflow (~700 needed)
    reqs = [
        Request.from_dict(_fuzzy_filter_req(t))
        for t in ("buc", "bucj", "buch", "buchy")
    ]
    got = batch_mod.search_batch(reqs, pers)
    assert all(r is not None for r in got)
    pers._fuzzy_cap_hint = {}
    for t, br in zip(("buc", "bucj", "buch", "buchy"), got):
        ref = ex_mod.search(Request.from_dict(_fuzzy_filter_req(t)), pers)
        assert br.num_hits == ref.num_hits, t
        assert [h.id for h in br.data] == [h.id for h in ref.data], t
        for g, w in zip(br.data, ref.data):
            assert float(g.score) == pytest.approx(float(w.score), rel=1e-4)


def test_plain_fuzzy_multichunk_retry_parity(big_fuzzy_pers, monkeypatch):
    """Plain fuzzy chunks (one per query via VELOCI_FUZZY_CHUNK_Q) with a
    forced pass-1 overflow: every chunk's retries must emit its own rows
    and the sticky hints must not be corrupted across chunks."""
    pers = big_fuzzy_pers
    monkeypatch.setattr(batch_mod, "SMALL_DOCS", 1)
    monkeypatch.setattr(ex_mod, "SMALL_DOCS", 1)
    monkeypatch.setenv("VELOCI_FUZZY_VIA_TREE", "0")  # the fused ladder
    monkeypatch.setenv("VELOCI_FUZZY_CHUNK_Q", "1")
    pers._fuzzy_cap_hint = {"title": 64}
    dicts = [
        {
            "search_req": {
                "search": {
                    "terms": [t],
                    "path": "title",
                    "levenshtein_distance": 1,
                }
            },
            "top": 10,
        }
        for t in ("buc", "bucj", "buch")
    ]
    got = batch_mod.search_batch([Request.from_dict(d) for d in dicts], pers)
    assert all(r is not None for r in got)
    pers._fuzzy_cap_hint = {}
    for d, br in zip(dicts, got):
        ref = ex_mod.search(Request.from_dict(d), pers)
        assert br.num_hits == ref.num_hits, d
        assert [h.id for h in br.data] == [h.id for h in ref.data], d


def test_plain_fuzzy_via_tree_route_parity(big_fuzzy_pers, monkeypatch):
    """The DEFAULT route for plain single-leaf fuzzy: one windowed prefetch
    sweep, then the sorted tree kernel at each query's KNOWN posting-total
    bucket (no blind capacity ladder). Full parity with the host executor,
    and the fused ladder (`_run_fuzzy_group`) must not be touched."""
    pers = big_fuzzy_pers
    monkeypatch.setattr(batch_mod, "SMALL_DOCS", 1)
    monkeypatch.setattr(ex_mod, "SMALL_DOCS", 1)
    monkeypatch.setenv("VELOCI_FUZZY_VIA_TREE", "1")
    fused_calls: list = []
    orig = batch_mod._run_fuzzy_group
    monkeypatch.setattr(
        batch_mod,
        "_run_fuzzy_group",
        lambda *a, **k: (fused_calls.append(1), orig(*a, **k))[1],
    )
    dicts = [
        {
            "search_req": {
                "search": {
                    "terms": [t],
                    "path": "title",
                    "levenshtein_distance": 1,
                }
            },
            "top": 10,
        }
        for t in ("buc", "bucj", "buch", "lesen", "w3")
    ]
    got = batch_mod.search_batch([Request.from_dict(d) for d in dicts], pers)
    assert not fused_calls, "plain fuzzy should ride the tree path"
    assert all(r is not None for r in got)
    for d, br in zip(dicts, got):
        ref = _host_search(monkeypatch, pers, Request.from_dict(d))
        assert br.num_hits == ref.num_hits, d
        assert [h.id for h in br.data] == [h.id for h in ref.data], d
        for g, w in zip(br.data, ref.data):
            assert float(g.score) == pytest.approx(float(w.score), rel=1e-4)


def test_sort_capacity_cap_routes_to_dense_executor(big_fuzzy_pers, monkeypatch):
    """Queries whose posting totals exceed MAX_SORT_CAPACITY must fall back
    to the dense-plane executor (the variadic-sort kernels blow up the XLA
    compile at multi-million capacities) and still answer exactly."""
    import veloci_tpu.ops.postings as postings_mod

    pers = big_fuzzy_pers
    monkeypatch.setattr(batch_mod, "SMALL_DOCS", 1)
    monkeypatch.setattr(ex_mod, "SMALL_DOCS", 1)
    dicts = [
        # tree with a fuzzy leaf: ~700 postings > 256 -> generic-group fallback
        {
            "search_req": {
                "or": {
                    "queries": [
                        {
                            "search": {
                                "terms": ["buc"],
                                "path": "title",
                                "levenshtein_distance": 1,
                            }
                        },
                        {"search": {"terms": ["lesen"], "path": "title"}},
                    ]
                }
            },
            "top": 10,
        },
        # plain fuzzy single leaf: worst capped -> per-request dense path
        {
            "search_req": {
                "search": {
                    "terms": ["buch"],
                    "path": "title",
                    "levenshtein_distance": 1,
                }
            },
            "top": 10,
        },
    ]
    expected = [ex_mod.search(Request.from_dict(d), pers) for d in dicts]
    pers._fuzzy_cap_hint = {}
    monkeypatch.setattr(postings_mod, "MAX_SORT_CAPACITY", 256)
    got = batch_mod.search_batch([Request.from_dict(d) for d in dicts], pers)
    single = [
        batch_mod.search_single_fused(Request.from_dict(d), pers) for d in dicts
    ]
    pers._fuzzy_cap_hint = {}
    for d, br, ref in zip(dicts, got, expected):
        assert br is not None and br.num_hits == ref.num_hits, d
        assert [h.id for h in br.data] == [h.id for h in ref.data], d
    # the single-request front door declines (returns None) instead of
    # compiling an over-cap sort shape; executor.search then goes dense
    for d, sf, ref in zip(dicts, single, expected):
        if sf is not None:
            assert sf.num_hits == ref.num_hits, d


def test_all_runner_types_share_one_batch(pers, monkeypatch):
    """Every search_batch runner in ONE call — singles, plain trees,
    fuzzy-leaf trees, generic extras, plain fuzzy, fuzzy-generic and the
    per-request fallback — all draining through the shared sync pool, with
    full parity against the host executor."""
    from test_batch_generic import GENERIC_REQUESTS

    # pin the legacy route so the FUSED fuzzy runner is one of the types
    # sharing the pool (the default routes plain fuzzy via the tree kernel)
    monkeypatch.setenv("VELOCI_FUZZY_VIA_TREE", "0")

    dicts = [
        # single exact term (batched_single_term_topk)
        {"search_req": {"search": {"terms": ["urge"], "path": "meanings.eng[]"}}},
        # plain tree (sorted tree kernel)
        FUZZY_TREE_REQUESTS[0],
        AND_OF_ORS_REQUESTS[0],
        # generic extras (filters/boosts/facets)
        GENERIC_REQUESTS[0],
        GENERIC_REQUESTS[5],
        # plain single-leaf fuzzy (fused sweep kernel)
        {
            "search_req": {
                "search": {
                    "terms": ["majestat"],
                    "path": "meanings.ger[]",
                    "levenshtein_distance": 1,
                }
            }
        },
        # ineligible -> per-request fallback inside the same batch
        {
            "search_req": {"search": {"terms": ["urge"], "path": "meanings.eng[]"}},
            "why_found": True,
        },
    ]
    _assert_parity(monkeypatch, pers, dicts)


# ---------------------------------------------------------------------------
# Deep trees: OR-of-ANDs and depth-3 shapes through the deep
# tree kernel (tree_candidates_deep) — raw Request JSON surface, zero
# per-request fallbacks.

DEEP_TREE_REQUESTS = [
    # OR of ANDs (the shape the 2-level kernel rejects)
    {
        "search_req": {
            "or": {
                "queries": [
                    {"and": {"queries": [
                        {"search": {"terms": ["majestät"], "path": "meanings.ger[]"}},
                        {"search": {"terms": ["anblick"], "path": "meanings.ger[]"}},
                    ]}},
                    {"and": {"queries": [
                        {"search": {"terms": ["urkunde"], "path": "meanings.ger[]"}},
                        {"search": {"terms": ["urge"], "path": "meanings.eng[]"}},
                    ]}},
                ]
            }
        },
        "top": 10,
    },
    # mixed OR(leaf, AND(...)) — leaf rides as a singleton subtree
    {
        "search_req": {
            "or": {
                "queries": [
                    {"search": {"terms": ["aussehen"], "path": "meanings.ger[]"}},
                    {"and": {"queries": [
                        {"search": {"terms": ["majestät"], "path": "meanings.ger[]"}},
                        {"search": {"terms": ["anblick"], "path": "meanings.ger[]"}},
                    ]}},
                ]
            }
        },
        "top": 10,
    },
    # depth 3: OR( AND( leaf, OR(leaves) ), leaf )
    {
        "search_req": {
            "or": {
                "queries": [
                    {"and": {"queries": [
                        {"search": {"terms": ["majestät"], "path": "meanings.ger[]"}},
                        {"or": {"queries": [
                            {"search": {"terms": ["anblick"], "path": "meanings.ger[]"}},
                            {"search": {"terms": ["aussehen"], "path": "meanings.ger[]"}},
                        ]}},
                    ]}},
                    {"search": {"terms": ["urkunde"], "path": "meanings.ger[]"}},
                ]
            }
        },
        "top": 10,
    },
    # same representative term on two sibling subtrees (executor unions by
    # repr term with MAX across them — stage 4 of the deep kernel)
    {
        "search_req": {
            "or": {
                "queries": [
                    {"and": {"queries": [
                        {"search": {"terms": ["majestät"], "path": "meanings.ger[]"}},
                        {"search": {"terms": ["anblick"], "path": "meanings.ger[]"}},
                    ]}},
                    {"and": {"queries": [
                        {"search": {"terms": ["majestät"], "path": "meanings.ger[]"}},
                        {"search": {"terms": ["aussehen"], "path": "meanings.ger[]"}},
                    ]}},
                ]
            }
        },
        "top": 10,
    },
    # fuzzy + prefix leaves inside a deep tree
    {
        "search_req": {
            "or": {
                "queries": [
                    {"and": {"queries": [
                        {"search": {"terms": ["majestat"], "path": "meanings.ger[]",
                                    "levenshtein_distance": 1}},
                        {"or": {"queries": [
                            {"search": {"terms": ["anbl"], "path": "meanings.ger[]",
                                        "starts_with": True}},
                            {"search": {"terms": ["ausseh"], "path": "meanings.ger[]",
                                        "starts_with": True}},
                        ]}},
                    ]}},
                    {"and": {"queries": [
                        {"search": {"terms": ["urkunde"], "path": "meanings.ger[]"}},
                        {"search": {"terms": ["urge"], "path": "meanings.eng[]"}},
                    ]}},
                ]
            }
        },
        "top": 10,
    },
    # redundant nesting must normalize (OR(OR(AND(AND))) etc.)
    {
        "search_req": {
            "or": {
                "queries": [
                    {"or": {"queries": [
                        {"and": {"queries": [
                            {"and": {"queries": [
                                {"search": {"terms": ["majestät"], "path": "meanings.ger[]"}},
                                {"search": {"terms": ["anblick"], "path": "meanings.ger[]"}},
                            ]}},
                        ]}},
                    ]}},
                    {"search": {"terms": ["urkunde"], "path": "meanings.ger[]"}},
                ]
            }
        },
        "top": 10,
    },
]


def test_deep_trees_batch_with_parity(pers, monkeypatch):
    from veloci_tpu.search import stats as stats_mod

    monkeypatch.setattr(batch_mod, "SMALL_DOCS", 1)
    monkeypatch.setattr(ex_mod, "SMALL_DOCS", 1)
    stats_mod.reset()
    batch_mod.search_batch(
        [Request.from_dict(d) for d in DEEP_TREE_REQUESTS], pers
    )
    snap = stats_mod.snapshot()  # BEFORE the host oracle runs (it counts too)
    assert snap["paths"].get("per_request_fallback", 0) == 0, snap
    assert snap["paths"].get("batched_tree_deep", 0) >= len(DEEP_TREE_REQUESTS) - 1, snap
    _assert_parity(monkeypatch, pers, DEEP_TREE_REQUESTS)


def test_deep_tree_with_extras_batches(pers, monkeypatch):
    """Deep tree + filter + boost column + facet rides the treedeep generic
    signature (one fused program, no fallback)."""
    from veloci_tpu.search import stats as stats_mod

    req = {
        "search_req": DEEP_TREE_REQUESTS[0]["search_req"],
        "filter": {"search": {"terms": ["common"], "path": "tags[]"}},
        "boost": [{"path": "commonness", "boost_fun": "Log10", "param": 1}],
        "facets": [{"field": "commonness"}],
        "top": 10,
    }
    monkeypatch.setattr(batch_mod, "SMALL_DOCS", 1)
    monkeypatch.setattr(ex_mod, "SMALL_DOCS", 1)
    stats_mod.reset()
    batch_mod.search_batch([Request.from_dict(req)], pers)
    snap = stats_mod.snapshot()
    assert snap["paths"].get("per_request_fallback", 0) == 0, snap
    assert snap["paths"].get("batched_generic", 0) == 1, snap
    _assert_parity(monkeypatch, pers, [req])


def test_deep_trees_randomized_battery(pers, monkeypatch):
    """Randomized deep trees from the supported grammar (raw Request JSON):
    every one batches (0 per-request fallbacks) and matches the host
    executor."""
    import numpy as np

    from veloci_tpu.search import stats as stats_mod

    rng = np.random.default_rng(23)
    ger = pers.get_dictionary("meanings.ger[]")
    eng = pers.get_dictionary("meanings.eng[]")
    vocab = [
        (t, "meanings.ger[]") for t in ger.terms if 3 <= len(t) <= 12
    ][:40] + [
        (t, "meanings.eng[]") for t in eng.terms if 3 <= len(t) <= 12
    ][:40]

    def leaf():
        term, path = vocab[int(rng.integers(0, len(vocab)))]
        kind = rng.random()
        if kind < 0.2 and len(term) > 4:
            return {"search": {"terms": [term[:-1] + "x"], "path": path,
                               "levenshtein_distance": 1}}
        if kind < 0.35:
            return {"search": {"terms": [term[:4]], "path": path,
                               "starts_with": True}}
        if kind < 0.45:
            return {"search": {"terms": ["zzz_miss"], "path": path}}
        return {"search": {"terms": [term], "path": path}}

    def subtree():
        if rng.random() < 0.3:
            return leaf()
        children = []
        for _ in range(int(rng.integers(2, 4))):
            if rng.random() < 0.3:
                children.append(
                    {"or": {"queries": [leaf() for _ in range(int(rng.integers(2, 4)))]}}
                )
            else:
                children.append(leaf())
        return {"and": {"queries": children}}

    reqs = []
    for _ in range(24):
        children = [subtree() for _ in range(int(rng.integers(2, 5)))]
        if all("and" not in c for c in children):
            children.append(subtree())
        reqs.append({"search_req": {"or": {"queries": children}}, "top": 10})

    monkeypatch.setattr(batch_mod, "SMALL_DOCS", 1)
    monkeypatch.setattr(ex_mod, "SMALL_DOCS", 1)
    stats_mod.reset()
    batch_mod.search_batch([Request.from_dict(d) for d in reqs], pers)
    snap = stats_mod.snapshot()
    assert snap["paths"].get("per_request_fallback", 0) == 0, snap
    _assert_parity(monkeypatch, pers, reqs)


def test_sliced_gather_matches_compact_kernel():
    """batched_tree_topk(slice_widths=..., single_slot=...) must be
    bit-identical to the compact-gather general kernel on random CSRs —
    the slice ladder only changes HOW postings reach the sort (contiguous
    dynamic_slice windows with masked tails vs per-element gather), never
    the candidate set, scores, tie order, or num_hits."""
    import numpy as np
    import jax.numpy as jnp

    from veloci_tpu.ops.postings import bucket_size
    from veloci_tpu.ops.tree_step import batched_tree_topk

    rng = np.random.default_rng(7)
    num_docs = 5000
    nk = 40
    counts = rng.integers(1, 400, size=nk)
    counts[0] = 3000  # zipf head run
    offsets = np.zeros(nk + 2, np.int64)
    offsets[1 : nk + 1] = np.cumsum(counts)
    offsets[nk + 1] = offsets[nk]
    nnz = int(offsets[nk])
    slice_pad = bucket_size(int(counts.max()))
    anchors = np.full(nnz + slice_pad, num_docs, np.int32)
    scores = np.zeros(nnz + slice_pad, np.float32)
    for t in range(nk):
        a = np.sort(
            rng.choice(num_docs, size=counts[t], replace=False)
        ).astype(np.int32)
        anchors[offsets[t] : offsets[t + 1]] = a
        scores[offsets[t] : offsets[t + 1]] = (
            rng.integers(400, 2000, size=counts[t]).astype(np.float32) / 100
        )
    packed = np.zeros((nnz + slice_pad, 2), np.int32)
    packed[:, 0] = anchors
    packed[:, 1] = scores.view(np.int32) if False else np.frombuffer(
        scores.tobytes(), dtype=np.int32
    )
    offs_d = jnp.asarray(offsets.astype(np.int32))
    packed_d = jnp.asarray(packed)

    for trial, (sslot, qn, tmax) in enumerate(
        [(True, 6, 4), (True, 3, 8), (False, 5, 6)]
    ):
        t_pad = bucket_size(tmax, 8)
        tid = np.full((qn, t_pad), -1, np.int32)
        ts = np.zeros((qn, t_pad), np.float32)
        sl = np.zeros((qn, t_pad), np.int32)
        ng = np.ones(qn, np.int32)
        runs_max = 0
        cap_rest = 64
        tot_max = 1
        for q in range(qn):
            ids = rng.choice(nk, size=rng.integers(1, tmax + 1), replace=False)
            runs = sorted(
                ((int(counts[i]), int(i)) for i in ids), key=lambda t: -t[0]
            )
            tot_max = max(tot_max, sum(r for r, _ in runs))
            runs_max = max(runs_max, runs[0][0])
            for j, (r, gid) in enumerate(runs):
                tid[q, j] = gid
                ts[q, j] = float(rng.integers(1, 5))
                if not sslot:
                    # two groups, arbitrary slot_ins
                    sl[q, j] = ((j % 2) << 8) | (j // 2)
                if j:
                    cap_rest = max(cap_rest, bucket_size(max(r, 1), 64) << (j - 1))
            if not sslot:
                ng[q] = 2 if len(runs) > 1 else 1
        cap_big = bucket_size(max(runs_max, 1), 64)
        widths = (cap_big,) + tuple(
            min(max(cap_rest >> j, 64), cap_big) for j in range(t_pad - 1)
        )
        args = (
            offs_d, None, None, jnp.asarray(tid), jnp.asarray(ts),
            jnp.asarray(sl), jnp.asarray(ng), None, None, None, (), (),
        )
        kw = dict(
            num_docs=num_docs, k=10, boost_specs=(), has_phrase=False,
            packed=packed_d,
        )
        ref = batched_tree_topk(
            *args, capacity=bucket_size(tot_max), **kw
        )
        got = batched_tree_topk(
            *args, capacity=0, slice_widths=widths, single_slot=sslot, **kw
        )
        for name, r, g in zip(("ids", "scores", "hits"), ref[:3], got[:3]):
            np.testing.assert_array_equal(
                np.asarray(r), np.asarray(g),
                err_msg=f"trial {trial} {name} diverged",
            )


def test_slice_plan_ladder_fits_every_run():
    """The (cap_big, cap_rest) ladder must cover every run profile it is
    chosen for: widths[j] >= run_j after the descending reorder."""
    import numpy as np

    from veloci_tpu.ops.postings import bucket_size

    rng = np.random.default_rng(3)
    for _ in range(500):
        runs = sorted(
            rng.integers(1, 100000, size=rng.integers(1, 12)), reverse=True
        )
        cap_big = bucket_size(max(int(runs[0]), 1), 64)
        cap_rest = 64
        for j, r in enumerate(runs[1:]):
            cap_rest = max(cap_rest, bucket_size(max(int(r), 1), 64) << j)
        t_pad = bucket_size(len(runs), 8)
        widths = (cap_big,) + tuple(
            min(max(cap_rest >> j, 64), cap_big) for j in range(t_pad - 1)
        )
        for j, r in enumerate(runs):
            assert widths[j] >= r, (runs, widths)
