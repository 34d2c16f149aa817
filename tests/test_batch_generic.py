"""Batched generic path parity: filtered + boosted + faceted exact requests
executed through `search_batch`'s ONE-dispatch generic kernel
(`ops/generic_step.batched_generic_topk`) must match the per-request host
executor bit for bit on ids / num_hits / facets and to f32 tolerance on
scores.

This is the round-2 extension of the fused device paths to BASELINE.json
configs 3-5 (multi-term AND/OR, facets + filters, boost-by-indexed-data) —
the reference executes these through its plan DAG one request at a time
(src/plan_creator/execution_plan.rs:132-200); here a whole batch is one
vmapped XLA program."""

import numpy as np
import pytest

from corpus import TEST_CONFIG, TOKEN_VALUES, data_ndjson
from veloci_tpu import Persistence, Request, add_token_values_to_tokens, search

import importlib

batch_mod = importlib.import_module("veloci_tpu.search.batch")
ex_mod = importlib.import_module("veloci_tpu.search.executor")
_generic_eligible = batch_mod._generic_eligible
search_batch = batch_mod.search_batch


@pytest.fixture(scope="module")
def pers():
    p = Persistence.create_from_str(data_ndjson(), TEST_CONFIG)
    add_token_values_to_tokens(p, TOKEN_VALUES[0], TOKEN_VALUES[1])
    return p


GENERIC_REQUESTS = [
    # config 5: boost-by-indexed-data (Log10 / Log2 / Multiply / Add)
    {
        "search_req": {"search": {"terms": ["majestät"], "path": "meanings.ger[]"}},
        "boost": [{"path": "commonness", "boost_fun": "Log10", "param": 1}],
    },
    {
        "search_req": {"search": {"terms": ["boostemich"], "path": "meanings.ger[]"}},
        "boost": [{"path": "commonness", "boost_fun": "Log2", "param": 2}],
    },
    {
        "search_req": {"search": {"terms": ["urge"], "path": "meanings.eng[]"}},
        "boost": [{"path": "commonness", "boost_fun": "Multiply", "param": 2}],
    },
    {
        "search_req": {"search": {"terms": ["urge"], "path": "meanings.eng[]"}},
        "boost": [{"path": "commonness", "boost_fun": "Add", "param": 50}],
    },
    # boost chain: two columns in request order
    {
        "search_req": {"search": {"terms": ["majestät"], "path": "meanings.ger[]"}},
        "boost": [
            {"path": "commonness", "boost_fun": "Log10", "param": 1},
            {"path": "commonness", "boost_fun": "Multiply", "param": 0},
        ],
    },
    # config 4: filter subtrees (identity column + token filter + OR filter)
    {
        "search_req": {
            "or": {
                "queries": [
                    {"search": {"terms": ["majestät"], "path": "meanings.ger[]"}},
                    {"search": {"terms": ["urge"], "path": "meanings.eng[]"}},
                ]
            }
        },
        "filter": {"search": {"terms": ["1587690"], "path": "ent_seq"}},
    },
    {
        "search_req": {"search": {"terms": ["majestät"], "path": "meanings.ger[]"}},
        "filter": {
            "or": {
                "queries": [
                    {"search": {"terms": ["1587680"], "path": "ent_seq"}},
                    {"search": {"terms": ["1587690"], "path": "ent_seq"}},
                ]
            }
        },
    },
    # fuzzy filter leaf (filters resolve host-side: any leaf shape batches)
    {
        "search_req": {"search": {"terms": ["urge"], "path": "meanings.eng[]"}},
        "filter": {
            "search": {
                "terms": ["majestat"],
                "path": "meanings.ger[]",
                "levenshtein_distance": 1,
            }
        },
    },
    # config 4: facets (1:n tags[] + root commonness), with and without filter
    {
        "search_req": {"search": {"terms": ["will"], "path": "meanings.eng[]"}},
        "facets": [{"field": "tags[]"}, {"field": "commonness"}],
    },
    {
        "search_req": {"search": {"terms": ["will"], "path": "meanings.eng[]"}},
        "facets": [{"field": "tags[]", "top": 1}],
        "filter": {"search": {"terms": ["1587690"], "path": "ent_seq"}},
    },
    # config 3: AND tree + boost; OR tree + facet + boost combined
    {
        "search_req": {
            "and": {
                "queries": [
                    {"search": {"terms": ["majestät"], "path": "meanings.ger[]"}},
                    {"search": {"terms": ["majestic"], "path": "meanings.eng[]"}},
                ]
            }
        },
        "boost": [{"path": "commonness", "boost_fun": "Log10", "param": 1}],
    },
    {
        "search_req": {
            "or": {
                "queries": [
                    {"search": {"terms": ["will"], "path": "meanings.eng[]"}},
                    {"search": {"terms": ["urge"], "path": "meanings.eng[]"}},
                ]
            }
        },
        "boost": [{"path": "commonness", "boost_fun": "Log10", "param": 1}],
        "facets": [{"field": "tags[]"}],
        "filter": {"search": {"terms": ["will"], "path": "meanings.eng[]"}},
    },
    # phrase boosts (x5 anchor factor) — alone and stacked with boost+facet
    {
        "search_req": {
            "or": {
                "queries": [
                    {"search": {"terms": ["majestätischer"], "path": "meanings.ger[]"}},
                    {"search": {"terms": ["anblick"], "path": "meanings.ger[]"}},
                ]
            }
        },
        "phrase_boosts": [
            {
                "search1": {"terms": ["majestätischer"], "path": "meanings.ger[]"},
                "search2": {"terms": ["anblick"], "path": "meanings.ger[]"},
            }
        ],
    },
    {
        "search_req": {
            "or": {
                "queries": [
                    {"search": {"terms": ["majestätischer"], "path": "meanings.ger[]"}},
                    {"search": {"terms": ["anblick"], "path": "meanings.ger[]"}},
                ]
            }
        },
        "phrase_boosts": [
            {
                "search1": {"terms": ["majestätischer"], "path": "meanings.ger[]"},
                "search2": {"terms": ["anblick"], "path": "meanings.ger[]"},
            },
            {
                "search1": {"terms": ["majestätisches"], "path": "meanings.ger[]"},
                "search2": {"terms": ["aussehen"], "path": "meanings.ger[]"},
            },
        ],
        "boost": [{"path": "commonness", "boost_fun": "Log10", "param": 1}],
        "facets": [{"field": "tags[]"}],
    },
    # skip_when_score exemption
    {
        "search_req": {"search": {"terms": ["urge"], "path": "meanings.eng[]"}},
        "boost": [
            {
                "path": "commonness",
                "boost_fun": "Multiply",
                "param": 2,
                "skip_when_score": [10.0],
            }
        ],
    },
    # fuzzy leaf + extras -> the fused fuzzy-generic kernel
    {
        "search_req": {
            "search": {
                "terms": ["majestat"],
                "path": "meanings.ger[]",
                "levenshtein_distance": 1,
            }
        },
        "boost": [{"path": "commonness", "boost_fun": "Log10", "param": 1}],
    },
    {
        "search_req": {
            "search": {
                "terms": ["majestat"],
                "path": "meanings.ger[]",
                "levenshtein_distance": 2,
            }
        },
        "filter": {"search": {"terms": ["1587680"], "path": "ent_seq"}},
        "facets": [{"field": "tags[]"}],
    },
    # top/skip windows survive the batched path
    {
        "search_req": {"search": {"terms": ["will"], "path": "meanings.eng[]"}},
        "boost": [{"path": "commonness", "boost_fun": "Log10", "param": 1}],
        "top": 1,
    },
    {
        "search_req": {"search": {"terms": ["will"], "path": "meanings.eng[]"}},
        "boost": [{"path": "commonness", "boost_fun": "Log10", "param": 1}],
        "top": 1,
        "skip": 1,
    },
]


def _result_tuple(res):
    return (
        res.num_hits,
        [h.id for h in res.data],
        [round(float(h.score), 4) for h in res.data],
        {k: list(v) for k, v in (res.facets or {}).items()} or None,
    )


def test_generic_requests_are_batch_eligible(pers, monkeypatch):
    monkeypatch.setattr(batch_mod, "SMALL_DOCS", 1)
    monkeypatch.setattr(ex_mod, "SMALL_DOCS", 1)
    comb = pers.device_combined()
    for d in GENERIC_REQUESTS:
        req = Request.from_dict(d)
        assert _generic_eligible(req, pers, comb) is not None, d


def test_batch_generic_parity(pers, monkeypatch):
    # batch side: device kernels; reference side: per-request host executor
    monkeypatch.setattr(batch_mod, "SMALL_DOCS", 1)
    monkeypatch.setattr(ex_mod, "SMALL_DOCS", 1)
    reqs = [Request.from_dict(d) for d in GENERIC_REQUESTS]
    batch_res = search_batch(reqs, pers)
    for d, br in zip(GENERIC_REQUESTS, batch_res):
        ref = search(Request.from_dict(d), pers)
        got, want = _result_tuple(br), _result_tuple(ref)
        assert got[0] == want[0], (d, got, want)  # num_hits
        assert got[1] == want[1], (d, got, want)  # ids incl. tie order
        for gs, ws in zip(got[2], want[2]):
            assert gs == pytest.approx(ws, rel=1e-4), (d, got, want)
        assert got[3] == want[3], (d, got, want)  # facets exact


def test_batch_generic_mixed_with_fast_paths(pers, monkeypatch):
    """Generic, plain-exact and ineligible requests interleave correctly."""
    monkeypatch.setattr(batch_mod, "SMALL_DOCS", 1)
    monkeypatch.setattr(ex_mod, "SMALL_DOCS", 1)
    dicts = [
        {"search_req": {"search": {"terms": ["urge"], "path": "meanings.eng[]"}}},
        GENERIC_REQUESTS[0],
        # ineligible (why_found) -> per-request fallback inside search_batch
        {
            "search_req": {"search": {"terms": ["urge"], "path": "meanings.eng[]"}},
            "why_found": True,
        },
        GENERIC_REQUESTS[8],
    ]
    reqs = [Request.from_dict(d) for d in dicts]
    batch_res = search_batch(reqs, pers)
    for d, br in zip(dicts, batch_res):
        ref = search(Request.from_dict(d), pers)
        assert [h.id for h in br.data] == [h.id for h in ref.data]
        assert br.num_hits == ref.num_hits


PLAIN_TREE_REQUESTS = [
    # prefix leaf (starts_with): distance-based prefix scores per term
    {
        "search_req": {
            "search": {"terms": ["majest"], "path": "meanings.ger[]", "starts_with": True}
        }
    },
    # prefix + exact mixed OR across fields
    {
        "search_req": {
            "or": {
                "queries": [
                    {"search": {"terms": ["majest"], "path": "meanings.ger[]", "starts_with": True}},
                    {"search": {"terms": ["urge"], "path": "meanings.eng[]"}},
                ]
            }
        }
    },
    # AND of exact leaves (plain tree, no extras)
    {
        "search_req": {
            "and": {
                "queries": [
                    {"search": {"terms": ["majestät"], "path": "meanings.ger[]"}},
                    {"search": {"terms": ["majestic"], "path": "meanings.eng[]"}},
                ]
            }
        }
    },
    # prefix with extras -> generic kernel
    {
        "search_req": {
            "search": {"terms": ["majest"], "path": "meanings.ger[]", "starts_with": True}
        },
        "boost": [{"path": "commonness", "boost_fun": "Log10", "param": 1}],
        "facets": [{"field": "tags[]"}],
    },
]


def test_batch_plain_trees_parity(pers, monkeypatch):
    """Prefix / mixed / AND plain trees batch with host parity (leaf term
    ids AND scores come from the memoized field search, so prefix distance
    scoring is host-parity by construction)."""
    monkeypatch.setattr(batch_mod, "SMALL_DOCS", 1)
    monkeypatch.setattr(ex_mod, "SMALL_DOCS", 1)
    reqs = [Request.from_dict(d) for d in PLAIN_TREE_REQUESTS]
    batch_res = search_batch(reqs, pers)
    for d, br in zip(PLAIN_TREE_REQUESTS, batch_res):
        ref = search(Request.from_dict(d), pers)
        got, want = _result_tuple(br), _result_tuple(ref)
        assert got[0] == want[0], (d, got, want)
        assert got[1] == want[1], (d, got, want)
        for gs, ws in zip(got[2], want[2]):
            assert gs == pytest.approx(ws, rel=1e-4), (d, got, want)
        assert got[3] == want[3], (d, got, want)


def test_fuzzy_generic_row_level_redispatch(monkeypatch):
    """One hot row overflowing the optimistic capacity must re-dispatch
    ALONE: the other rows' sweeps are not re-executed (re-running the whole
    chunk was an earlier bug). Asserted via a dispatch spy on
    batched_fuzzy_generic_topk, plus full parity with the host executor."""
    import json
    import time

    import veloci_tpu.ops.fuzzy_step as fuzzy_step_mod

    docs = []
    for i in range(3000):
        title = f"w{i:05d}q" + (" hotterm" if i < 2500 else "")
        docs.append(json.dumps({"title": title}))
    p = Persistence.create_from_str("\n".join(docs), "{}")
    monkeypatch.setattr(batch_mod, "SMALL_DOCS", 1)
    monkeypatch.setattr(ex_mod, "SMALL_DOCS", 1)
    # force a tiny optimistic pass-1 capacity so the hot row overflows
    p._fuzzy_cap_hint = {"title": 64}

    calls = []
    real = fuzzy_step_mod.batched_fuzzy_generic_topk

    def spy(chars_arg, term_lens, queries, query_lens, *args, **kw):
        calls.append(
            (int((np.asarray(query_lens) > 0).sum()), kw.get("capacity"))
        )
        return real(chars_arg, term_lens, queries, query_lens, *args, **kw)

    monkeypatch.setattr(fuzzy_step_mod, "batched_fuzzy_generic_topk", spy)

    terms = [f"w{j * 37:05d}x" for j in range(63)] + ["hotterx"]
    reqs = [
        Request.from_dict(
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
        )
        for t in terms
    ]
    entries = [
        (qi, req, {"fuzzy": ("title", t, 1), "fkey": None, "panchors": None})
        for qi, (req, t) in enumerate(zip(reqs, terms))
    ]
    results = [None] * len(reqs)
    emit = batch_mod._make_emit(results, time.time_ns())
    fell_back = []
    batch_mod._run_fuzzy_generic_group(
        p,
        ("fz", "title", (), (), False, False),
        entries,
        emit,
        results,
        fallback=lambda qi, req: fell_back.append(qi),
    )

    assert not fell_back, fell_back
    assert len(calls) >= 2, calls
    first_rows, first_cap = calls[0]
    assert first_rows == 64 and first_cap == 64, calls
    # every retry dispatch carries ONLY the overflowing row
    for rows, cap in calls[1:]:
        assert rows == 1 and cap > 64, calls

    for req, res in zip(reqs, results):
        want = search(req, p)
        assert res is not None
        assert res.num_hits == want.num_hits
        assert [h.id for h in res.data] == [h.id for h in want.data]
        for a, b in zip(res.data, want.data):
            assert a.score == pytest.approx(b.score, rel=1e-5)


def test_length_window_variant_parity(monkeypatch):
    """Fuzzy sweeps over the length-window slice [qlen-d, qlen+d] of the
    length-sorted matrix (lev(a,b) >= |len(a)-len(b)|) must match the
    full-matrix host executor exactly — single-request, batched plain and
    batched generic (filtered) paths. LW_BLOCK is forced tiny so windows
    engage on this corpus (production granularity is 4096 rows). Reference
    parity target: the FST+automaton walk visits only reachable prefixes
    (search_field.rs:85-96); the length window is the dense-sweep analog."""
    import json

    import veloci_tpu.persistence as pers_mod

    monkeypatch.setattr(pers_mod, "LW_BLOCK", 16)
    monkeypatch.setattr(batch_mod, "SMALL_DOCS", 1)
    monkeypatch.setattr(ex_mod, "SMALL_DOCS", 1)

    # terms spanning lengths 2..24 so the length-sorted matrix has real
    # spread; several near-collision groups for each probe length
    docs = []
    words = []
    for i in range(400):
        base = "ab" + "x" * (i % 12)  # lengths 2..13
        words.append(base + str(i % 7))
    for i in range(40):
        words.append("w" * (14 + i % 10))  # long tail 14..23
    for i, w in enumerate(words):
        docs.append(json.dumps({"title": w, "tag": f"t{i % 2}"}))
    cfg = '["*GLOBAL*"]\nfeatures = ["All"]\n'
    p = Persistence.create_from_str("\n".join(docs), cfg)

    probes = [("abxx1", 1), ("abxxx", 2), ("abxxxxxxx3", 1), ("wwwwwwwwwwwwwww", 2), ("ab", 1)]
    reqs = [
        Request.from_dict(
            {
                "search_req": {
                    "search": {
                        "terms": [t],
                        "path": "title",
                        "levenshtein_distance": d,
                    }
                },
                "top": 20,
            }
        )
        for t, d in probes
    ]
    # host-oracle results BEFORE forcing device paths (full-matrix host walk)
    monkeypatch.setattr(batch_mod, "SMALL_DOCS", 1 << 60)
    monkeypatch.setattr(ex_mod, "SMALL_DOCS", 1 << 60)
    oracle = [search(Request.from_dict(r.to_dict() if hasattr(r, "to_dict") else {
        "search_req": {"search": {"terms": [t], "path": "title", "levenshtein_distance": d}},
        "top": 20}), p) for r, (t, d) in zip(reqs, probes)]
    monkeypatch.setattr(batch_mod, "SMALL_DOCS", 1)
    monkeypatch.setattr(ex_mod, "SMALL_DOCS", 1)

    got = search_batch(reqs, p)
    dev = p.device_field("title")
    assert getattr(dev, "_len_variants", None), "window path never engaged"
    for (t, d), o, g in zip(probes, oracle, got):
        assert g.num_hits == o.num_hits, (t, d)
        assert [h.id for h in g.data] == [h.id for h in o.data], (t, d)
        for a, b in zip(g.data, o.data):
            assert float(a.score) == pytest.approx(float(b.score), rel=1e-5)

    # filtered (fuzzy-generic runner) parity
    freqs = [
        Request.from_dict(
            {
                "search_req": {
                    "search": {
                        "terms": [t],
                        "path": "title",
                        "levenshtein_distance": d,
                    }
                },
                "filter": {"search": {"terms": ["t0"], "path": "tag"}},
                "top": 20,
            }
        )
        for t, d in probes
    ]
    monkeypatch.setattr(batch_mod, "SMALL_DOCS", 1 << 60)
    monkeypatch.setattr(ex_mod, "SMALL_DOCS", 1 << 60)
    oracle_f = [search(r, p) for r in freqs]
    monkeypatch.setattr(batch_mod, "SMALL_DOCS", 1)
    monkeypatch.setattr(ex_mod, "SMALL_DOCS", 1)
    got_f = search_batch(freqs, p)
    for (t, d), o, g in zip(probes, oracle_f, got_f):
        assert g.num_hits == o.num_hits, (t, d)
        assert [h.id for h in g.data] == [h.id for h in o.data], (t, d)


def test_why_found_requests_batch_with_parity(pers, monkeypatch):
    """why_found requests ride the fused kernels (0 per-request fallbacks):
    the kernel answers the search, the emitter attaches why_found metadata
    from host-known matches (exact bisects + memoized fuzzy sweeps). Full
    output parity — including why_found highlight fragments rendered via
    search_to_result_with_doc — against the per-request host executor.
    search_batch folds both suggest and why_found."""
    stats_mod = importlib.import_module("veloci_tpu.search.stats")
    search_to_result_with_doc = ex_mod.search_to_result_with_doc

    dicts = [
        {
            "search_req": {"search": {"terms": ["majestät"], "path": "meanings.ger[]"}},
            "why_found": True,
            "top": 5,
        },
        {  # fuzzy leaf: matches resolve via the prefetched sweep memo
            "search_req": {
                "search": {
                    "terms": ["majestat"],
                    "path": "meanings.ger[]",
                    "levenshtein_distance": 1,
                }
            },
            "why_found": True,
            "top": 5,
        },
        {  # OR tree + filter extras through the generic signature
            "search_req": {"or": {"queries": [
                {"search": {"terms": ["majestät"], "path": "meanings.ger[]"}},
                {"search": {"terms": ["urkunde"], "path": "meanings.ger[]"}},
            ]}},
            "boost": [{"path": "commonness", "boost_fun": "Log10", "param": 1}],
            "why_found": True,
            "top": 5,
        },
    ]
    reqs = [Request.from_dict(d) for d in dicts]
    monkeypatch.setattr(batch_mod, "SMALL_DOCS", 1)
    monkeypatch.setattr(ex_mod, "SMALL_DOCS", 1)
    stats_mod.reset()
    got = batch_mod.search_batch(reqs, pers)
    snap = stats_mod.snapshot()
    assert snap["paths"].get("per_request_fallback", 0) == 0, snap

    # host-oracle AFTER the snapshot (the oracle's own dispatches count too)
    monkeypatch.setattr(batch_mod, "SMALL_DOCS", 1 << 60)
    monkeypatch.setattr(ex_mod, "SMALL_DOCS", 1 << 60)
    for d, res in zip(dicts, got):
        req = Request.from_dict(d)
        want = search(req, pers)
        assert res.num_hits == want.num_hits, d
        assert [h.id for h in res.data] == [h.id for h in want.data], d
        # rendered why_found fragments must match exactly
        got_docs = search_to_result_with_doc(pers, res, req.select)
        want_docs = search_to_result_with_doc(pers, want, req.select)
        for a, b in zip(got_docs.data, want_docs.data):
            assert a.why_found == b.why_found, d


def test_length_window_edge_cases(monkeypatch):
    """Window boundary conditions: single-char queries (min_len <= 0),
    queries longer than every dictionary term (empty window -> 0 matches),
    exact-block-boundary windows, d clamped to len-1, and case-sensitive
    verification on the windowed candidate set — all must match the host
    executor exactly."""
    import json

    import veloci_tpu.persistence as pers_mod

    monkeypatch.setattr(pers_mod, "LW_BLOCK", 16)
    monkeypatch.setattr(batch_mod, "SMALL_DOCS", 1)
    monkeypatch.setattr(ex_mod, "SMALL_DOCS", 1)

    words = ["a", "ab", "abc", "abcd", "abcde"] + [
        "x" * k + str(i) for k in range(1, 11) for i in range(30)
    ]
    docs = [json.dumps({"title": w}) for w in words]
    p = Persistence.create_from_str("\n".join(docs), "{}")

    probes = [
        ("a", 2),      # d clamps to len-1 = 0
        ("ab", 1),     # min_len = 1
        ("b", 1),      # single char, d=1 -> window [0, 2] hits blk floor
        ("x" * 30, 2), # longer than every term + d -> empty window
        ("xxxx7", 1),
    ]

    def run_all(dev_paths: bool):
        v = 1 if dev_paths else (1 << 60)
        monkeypatch.setattr(batch_mod, "SMALL_DOCS", v)
        monkeypatch.setattr(ex_mod, "SMALL_DOCS", v)
        out = []
        for t, d in probes:
            req = Request.from_dict(
                {
                    "search_req": {
                        "search": {
                            "terms": [t],
                            "path": "title",
                            "levenshtein_distance": d,
                        }
                    },
                    "top": 50,
                }
            )
            out.append(search(req, p))
        return out

    want = run_all(dev_paths=False)
    monkeypatch.setattr(batch_mod, "SMALL_DOCS", 1)
    monkeypatch.setattr(ex_mod, "SMALL_DOCS", 1)
    got = batch_mod.search_batch(
        [
            Request.from_dict(
                {
                    "search_req": {
                        "search": {
                            "terms": [t],
                            "path": "title",
                            "levenshtein_distance": d,
                        }
                    },
                    "top": 50,
                }
            )
            for t, d in probes
        ],
        p,
    )
    for (t, d), o, g in zip(probes, want, got):
        assert g.num_hits == o.num_hits, (t, d, g.num_hits, o.num_hits)
        assert [h.id for h in g.data] == [h.id for h in o.data], (t, d)

    # case-sensitive verification through the windowed candidates
    docs2 = [json.dumps({"title": w}) for w in ("Fuchs", "fuchs", "fuchT")]
    p2 = Persistence.create_from_str("\n".join(docs2), "{}")
    req_cs = Request.from_dict(
        {
            "search_req": {
                "search": {
                    "terms": ["fuchs"],
                    "path": "title",
                    "levenshtein_distance": 1,
                    "ignore_case": False,
                }
            },
            "top": 10,
        }
    )
    monkeypatch.setattr(batch_mod, "SMALL_DOCS", 1 << 60)
    monkeypatch.setattr(ex_mod, "SMALL_DOCS", 1 << 60)
    want_cs = search(req_cs, p2)
    monkeypatch.setattr(batch_mod, "SMALL_DOCS", 1)
    monkeypatch.setattr(ex_mod, "SMALL_DOCS", 1)
    got_cs = search(req_cs, p2)
    assert got_cs.num_hits == want_cs.num_hits
    assert [h.id for h in got_cs.data] == [h.id for h in want_cs.data]
