"""Mesh batched serving parity: `search_batch` with a mesh attached routes
generic-eligible exact trees through ONE sharded program per group
(`MeshContext.generic_batch`) — per-shard dense planes, sharded boost
columns, facet matmul + psum, exact all_gather top-k merge. Results must match
the single-process host executor."""

import importlib

import numpy as np
import pytest

from corpus import TEST_CONFIG, TOKEN_VALUES, data_ndjson
from veloci_tpu import Persistence, Request, add_token_values_to_tokens, search
from veloci_tpu.parallel.mesh_executor import build_doc_mesh

batch_mod = importlib.import_module("veloci_tpu.search.batch")
ex_mod = importlib.import_module("veloci_tpu.search.executor")
from test_batch_generic import GENERIC_REQUESTS, _result_tuple


@pytest.fixture(scope="module")
def pers():
    p = Persistence.create_from_str(data_ndjson(), TEST_CONFIG)
    add_token_values_to_tokens(p, TOKEN_VALUES[0], TOKEN_VALUES[1])
    return p


PLAIN_REQUESTS = [
    # no extras: plain trees also batch through the sharded kernel on mesh
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
                    {"search": {"terms": ["majestic"], "path": "meanings.eng[]"}},
                ]
            }
        }
    },
]


def test_mesh_deep_tree_parity(pers, monkeypatch):
    """Deep (OR-of-ANDs / depth-3) trees ride the batched mesh route
    too: the meshdeep signature dispatches tree_dense_deep via
    MeshContext.generic_batch — no per-request fallback — and matches the
    host executor exactly, including with filter/boost/facet extras."""
    from test_batch_tree import DEEP_TREE_REQUESTS

    monkeypatch.setattr(batch_mod, "SMALL_DOCS", 1)
    monkeypatch.setattr(ex_mod, "SMALL_DOCS", 1)
    dicts = [dict(d) for d in DEEP_TREE_REQUESTS] + [
        {
            "search_req": DEEP_TREE_REQUESTS[0]["search_req"],
            "filter": {"search": {"terms": ["common"], "path": "tags[]"}},
            "boost": [
                {"path": "commonness", "boost_fun": "Log10", "param": 1}
            ],
            "facets": [{"field": "commonness"}],
            "top": 10,
        }
    ]
    refs = [search(Request.from_dict(d), pers) for d in dicts]

    fallbacks = []
    real_search = batch_mod.search
    monkeypatch.setattr(
        batch_mod, "search", lambda *a, **k: fallbacks.append(1) or real_search(*a, **k)
    )
    pers.attach_mesh(build_doc_mesh(8))
    try:
        batch_res = batch_mod.search_batch(
            [Request.from_dict(d) for d in dicts], pers
        )
    finally:
        pers.detach_mesh()
    assert not fallbacks, f"{len(fallbacks)} deep trees fell back per-request"
    for d, br, ref in zip(dicts, batch_res, refs):
        got, want = _result_tuple(br), _result_tuple(ref)
        assert got[0] == want[0], (d, got, want)
        assert got[1] == want[1], (d, got, want)
        for gs, ws in zip(got[2], want[2]):
            assert gs == pytest.approx(ws, rel=1e-4), (d, got, want)
        assert got[3] == want[3], (d, got, want)


def test_mesh_search_batch_parity(pers, monkeypatch):
    monkeypatch.setattr(batch_mod, "SMALL_DOCS", 1)
    monkeypatch.setattr(ex_mod, "SMALL_DOCS", 1)
    dicts = PLAIN_REQUESTS + GENERIC_REQUESTS
    # host reference first (no mesh attached)
    refs = [search(Request.from_dict(d), pers) for d in dicts]
    pers.attach_mesh(build_doc_mesh(8))
    try:
        batch_res = batch_mod.search_batch(
            [Request.from_dict(d) for d in dicts], pers
        )
    finally:
        pers.detach_mesh()
    for d, br, ref in zip(dicts, batch_res, refs):
        got, want = _result_tuple(br), _result_tuple(ref)
        assert got[0] == want[0], (d, got, want)  # num_hits
        assert got[1] == want[1], (d, got, want)  # ids incl. tie order
        for gs, ws in zip(got[2], want[2]):
            assert gs == pytest.approx(ws, rel=1e-4), (d, got, want)
        assert got[3] == want[3], (d, got, want)  # facets exact
