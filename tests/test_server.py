"""HTTP server tests — port of reference server/tests.rs."""

import json
import threading
import urllib.request

import pytest

from veloci_tpu import Persistence
from veloci_tpu.server import PERSISTENCES, make_server

TEST_DATA = '{"text": "hi there", "name": "fred", "boost": "me"}'
CONFIG = """
["*GLOBAL*"]
    features = ["All"]
"""


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    import veloci_tpu.server as server_mod

    base = tmp_path_factory.mktemp("dbs")
    db_dir = base / "test_http"
    pers = Persistence.create_from_str(TEST_DATA, CONFIG)
    pers.save(str(db_dir))
    old_base = server_mod.BASE_DIR
    server_mod.BASE_DIR = str(base)  # databases resolve under this dir
    srv = make_server("127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        yield (srv, "test_http")
    finally:
        srv.shutdown()
        PERSISTENCES.clear()
        server_mod.BASE_DIR = old_base


def _get(srv_db, path):
    srv, db = srv_db
    port = srv.server_address[1]
    url = f"http://127.0.0.1:{port}{path.replace('DB', urllib.request.quote(db, safe=''))}"
    with urllib.request.urlopen(url, timeout=30) as resp:
        return resp.status, resp.read().decode("utf-8")


def _post(srv_db, path, body):
    srv, db = srv_db
    port = srv.server_address[1]
    url = f"http://127.0.0.1:{port}{path.replace('DB', urllib.request.quote(db, safe=''))}"
    req = urllib.request.Request(
        url,
        data=json.dumps(body).encode("utf-8"),
        headers={"Content-Type": "application/json"},
        method="POST",
    )
    with urllib.request.urlopen(req, timeout=30) as resp:
        return resp.status, resp.read().decode("utf-8")


def test_get_version(server):
    status, body = _get(server, "/version")
    assert status == 200
    assert "0.8" in body


def test_get_request(server):
    status, body = _get(
        server,
        "/DB/search?query=fred&top=10&boost_fields=name-%3E2.5&boost_terms=boost:me-%3E2.0",
    )
    assert status == 200
    assert "name" in body


def test_get_suggest(server):
    status, body = _get(server, "/DB/suggest?query=fr&top=10")
    assert status == 200
    assert "fred" in body


def test_post_search_query_params(server):
    status, body = _post(
        server,
        "/DB/search_query_params",
        {
            "search_term": "fred",
            "top": 3,
            "skip": 0,
            "select": "name",
            "boost_fields": {"name": 2.50},
            "boost_terms": {"boost:me": 2.0},
            "why_found": True,
        },
    )
    assert status == 200
    assert "name" in body


def test_post_search_raw_request(server):
    status, body = _post(
        server,
        "/DB/search",
        {"search_req": {"search": {"terms": ["fred"], "path": "name"}}},
    )
    assert status == 200
    data = json.loads(body)
    assert data["num_hits"] == 1
    assert data["data"][0]["doc"]["name"] == "fred"


def test_get_doc_by_id(server):
    status, body = _get(server, "/DB/_id/0")
    assert status == 200
    assert json.loads(body)["name"] == "fred"


def test_get_idtree(server):
    status, body = _get(server, "/DB/_idtree/0")
    assert status == 200
    assert json.loads(body)["name"] == "fred"


def test_post_explain_plan(server):
    status, body = _post(
        server,
        "/DB/search_query_params/explain_plan",
        {"search_term": "fred"},
    )
    assert status == 200
    assert "digraph" in body


def test_search_batch_route(server):
    status, body = _post(
        server,
        "/DB/search_batch",
        [
            {"search_req": {"search": {"terms": ["fred"], "path": "name"}}},
            {"search_req": {"search": {"terms": ["hi"], "path": "text"}}},
        ],
    )
    assert status == 200
    data = json.loads(body)
    assert len(data) == 2
    assert data[0]["num_hits"] == 1
    assert data[1]["num_hits"] == 1


def test_post_request_invalid_field(server):
    """400 on a field filter matching nothing (reference server/tests.rs:90+)."""
    import urllib.error

    try:
        _post(
            server,
            "/DB/search_query_params",
            {"search_term": "fred", "fields": ["invalid"]},
        )
        raise AssertionError("expected HTTPError")
    except urllib.error.HTTPError as e:
        assert e.code == 400


def test_concurrent_requests(server):
    """ThreadingHTTPServer serves concurrently; shared per-persistence caches
    must stay consistent under parallel identical+distinct queries."""
    from concurrent.futures import ThreadPoolExecutor

    paths = [
        "/DB/search?query=hi&top=5",
        "/DB/search?query=there&top=5",
        "/DB/search?query=fred&top=5",
        "/DB/suggest?query=h",
    ] * 8

    def one(path):
        return _get(server, path)

    with ThreadPoolExecutor(max_workers=8) as pool:
        results = list(pool.map(one, paths))
    for (status, body), path in zip(results, paths):
        assert status == 200, path
        payload = json.loads(body)
        if "search" in path:
            assert payload["num_hits"] >= 1, path


def test_db_name_traversal_rejected(server):
    """'..%2F..%2Fpath' must not load arbitrary directories."""
    srv, _db = server
    port = srv.server_address[1]
    for evil in ("..%2F..%2Fetc", "..", "%2Fabs%2Fpath", "a%5Cb"):
        url = f"http://127.0.0.1:{port}/{evil}/search?query=x"
        try:
            with urllib.request.urlopen(url, timeout=30) as resp:
                status = resp.status
        except urllib.error.HTTPError as e:
            status = e.code
        assert status == 400, (evil, status)


def test_db_name_missing_is_400_not_500(server):
    srv, _db = server
    port = srv.server_address[1]
    url = f"http://127.0.0.1:{port}/no_such_db/search?query=x"
    try:
        with urllib.request.urlopen(url, timeout=30) as resp:
            status = resp.status
    except urllib.error.HTTPError as e:
        status = e.code
    assert status in (400, 404)


def test_stats_route(server):
    """GET /stats exposes fleet-level dispatch counters (round-3 serving
    observability: which execution path answered how much traffic, and why
    fallbacks happened)."""
    _get(server, "/DB/search?query=hi&top=5")
    status, body = _get(server, "/stats")
    assert status == 200
    payload = json.loads(body)
    assert payload["total_requests"] >= 1
    assert "paths" in payload and "fallback_reasons" in payload
    assert payload["fast_path_pct"] is None or 0 <= payload["fast_path_pct"] <= 100


def test_request_folding_under_concurrency(server):
    """32 parallel lone GET /search requests fold into micro-batches via the
    dispatcher thread; every response must still be correct and /stats must
    show folding activity."""
    from concurrent.futures import ThreadPoolExecutor

    from veloci_tpu.search import stats as stats_mod

    stats_mod.reset()
    paths = ["/DB/search?query=hi&top=5", "/DB/search?query=fred&top=5"] * 16

    def one(path):
        return _get(server, path)

    with ThreadPoolExecutor(max_workers=32) as pool:
        results = list(pool.map(one, paths))
    for (status, body), path in zip(results, paths):
        assert status == 200, path
        assert json.loads(body)["num_hits"] >= 1, path
    snap = stats_mod.snapshot()
    assert snap["paths"].get("fold_dispatches", 0) >= 1
