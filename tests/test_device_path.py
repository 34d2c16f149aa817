"""Device-path parity: the full generic request surface (filters, every
boost family, phrase boosts, facets, term/text-locality boosts) executed
with the dense vector RESIDENT ON DEVICE must match the host numpy path.

This is the round-2 'extend the fused device path' coverage: the device
executor tree (device filter masks, device boost columns, scatter-applied
1:n/phrase/term boosts, on-device facet counts) runs on the virtual CPU
device backend here and on the GPU in production — the code path is
identical (jnp vs np dispatch in the executor)."""

import numpy as np
import pytest

from corpus import TEST_CONFIG, TOKEN_VALUES, data_ndjson
from veloci_tpu import (
    Persistence,
    Request,
    add_token_values_to_tokens,
    search,
)

import importlib

ex = importlib.import_module("veloci_tpu.search.executor")


@pytest.fixture(scope="module")
def pers():
    p = Persistence.create_from_str(data_ndjson(), TEST_CONFIG)
    add_token_values_to_tokens(p, TOKEN_VALUES[0], TOKEN_VALUES[1])
    return p


REQUESTS = [
    # plain leaf + OR + AND trees
    {"search_req": {"search": {"terms": ["urge"], "path": "meanings.eng[]"}}},
    {
        "search_req": {
            "or": {
                "queries": [
                    {"search": {"terms": ["urge"], "path": "meanings.eng[]"}},
                    {"search": {"terms": ["majestät"], "path": "meanings.ger[]"}},
                ]
            }
        }
    },
    {
        "search_req": {
            "and": {
                "queries": [
                    {"search": {"terms": ["majestät"], "path": "meanings.ger[]"}},
                    {"search": {"terms": ["majestaet"], "path": "meanings.ger[]"}},
                ]
            }
        }
    },
    # fuzzy leaf
    {
        "search_req": {
            "search": {
                "terms": ["urbge"],
                "path": "meanings.eng[]",
                "levenshtein_distance": 1,
            }
        }
    },
    # filter
    {
        "search_req": {"search": {"terms": ["majestät"], "path": "meanings.ger[]"}},
        "filter": {"search": {"terms": ["1586730"], "path": "ent_seq"}},
    },
    # anchor boost column (commonness), all five functions + expression
    *[
        {
            "search_req": {
                "search": {"terms": ["majestät"], "path": "meanings.ger[]"}
            },
            "boost": [{"path": "commonness", "boost_fun": fun, "param": 2}],
        }
        for fun in ("Log10", "Log2", "Multiply", "Add", "Replace")
    ],
    {
        "search_req": {"search": {"terms": ["majestät"], "path": "meanings.ger[]"}},
        "boost": [{"path": "commonness", "expression": "10 / $SCORE"}],
    },
    # 1:n boost attached to the field subtree (kanji[].commonness)
    {
        "search_req": {"search": {"terms": ["意慾"], "path": "kanji[].text"}},
        "boost": [
            {"path": "kanji[].commonness", "boost_fun": "Log10", "param": 1}
        ],
    },
    # 1:n boost with expression + skip_when_score (field1[].rank)
    {
        "search_req": {"search": {"terms": ["awesome"], "path": "field1[].text"}},
        "boost": [
            {"path": "commonness", "boost_fun": "Log10", "param": 1},
            {
                "path": "field1[].rank",
                "expression": "10 / $SCORE",
                "skip_when_score": [0],
            },
        ],
    },
    # phrase boost
    {
        "search_req": {
            "or": {
                "queries": [
                    {"search": {"terms": ["die"], "path": "meanings.ger[]"}},
                    {"search": {"terms": ["majestät"], "path": "meanings.ger[]"}},
                ]
            }
        },
        "phrase_boosts": [
            {
                "search1": {"terms": ["die"], "path": "meanings.ger[]"},
                "search2": {"terms": ["majestät"], "path": "meanings.ger[]"},
            }
        ],
    },
    # facets + filter + boost in one request
    {
        "search_req": {"search": {"terms": ["haus"], "path": "meanings.ger[]"}},
        "facets": [{"field": "tags[]"}],
        "boost": [{"path": "commonness", "boost_fun": "Log10", "param": 1}],
    },
    # term boost
    {
        "search_req": {
            "or": {
                "queries": [
                    {"search": {"terms": ["haus"], "path": "meanings.ger[]"}},
                    {"search": {"terms": ["majestät"], "path": "meanings.ger[]"}},
                ]
            }
        },
        "boost_term": [{"terms": ["urge"], "path": "meanings.eng[]", "boost": 3.0}],
    },
    # text locality
    {
        "search_req": {
            "or": {
                "queries": [
                    {"search": {"terms": ["die"], "path": "meanings.ger[]"}},
                    {"search": {"terms": ["majestät"], "path": "meanings.ger[]"}},
                ]
            }
        },
        "text_locality": True,
    },
    # skip/top windows
    {
        "search_req": {"search": {"terms": ["die"], "path": "meanings.ger[]"}},
        "top": 2,
        "skip": 1,
    },
]


@pytest.mark.parametrize("idx", range(len(REQUESTS)))
def test_device_path_matches_host(pers, monkeypatch, idx):
    req_json = REQUESTS[idx]
    monkeypatch.setattr(ex, "SMALL_DOCS", 1 << 30)  # host numpy path
    host = search(Request.from_dict(dict(req_json)), pers)
    monkeypatch.setattr(ex, "SMALL_DOCS", 1)  # device path end-to-end
    pers.invalidate_device_cache()
    dev = search(Request.from_dict(dict(req_json)), pers)
    assert dev.num_hits == host.num_hits, (idx, dev.num_hits, host.num_hits)
    assert [h.id for h in dev.data] == [h.id for h in host.data], idx
    np.testing.assert_allclose(
        [h.score for h in dev.data],
        [h.score for h in host.data],
        rtol=2e-6,
        err_msg=str(idx),
    )
    if host.facets:
        assert dev.facets == host.facets


def test_device_path_explain_falls_back(pers, monkeypatch):
    # explain forces the host snapshot collection; must still work with the
    # device threshold at 1
    monkeypatch.setattr(ex, "SMALL_DOCS", 1)
    req = Request.from_dict(
        {
            "search_req": {"search": {"terms": ["urge"], "path": "meanings.eng[]"}},
            "explain": True,
        }
    )
    res = search(req, pers)
    assert res.data and res.explain


def test_warmup_compiles_and_serves(pers, monkeypatch):
    """Persistence.warmup uploads bundles + compiles serving buckets; the
    next query answers correctly through the fused paths."""
    import importlib

    batch_mod = importlib.import_module("veloci_tpu.search.batch")
    ex_mod = importlib.import_module("veloci_tpu.search.executor")
    from veloci_tpu import Request, search

    monkeypatch.setattr(batch_mod, "SMALL_DOCS", 1)
    monkeypatch.setattr(ex_mod, "SMALL_DOCS", 1)
    secs = pers.warmup()
    assert secs >= 0.0
    res = search(
        Request.from_dict(
            {"search_req": {"search": {"terms": ["majestät"], "path": "meanings.ger[]"}}}
        ),
        pers,
    )
    assert res.num_hits >= 1
