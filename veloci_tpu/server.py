"""HTTP API server.

Route surface mirrors the reference's rocket server
(server/rocket_server.rs:110-510):

* ``GET  /version``
* ``GET  /stats``                            (dispatch-path counters)
* ``GET  /<db>/search?query=...``            (query-generator params)
* ``POST /<db>/search``                      (raw `Request` JSON)
* ``POST /<db>/search_batch``                (list of requests, ONE dispatch)
* ``POST /<db>/search_query_params``         (`SearchQueryGeneratorParameters`)
* ``POST /<db>/search_query_params/explain_plan``
* ``GET  /<db>/suggest?query=...`` / ``POST /<db>/suggest``
* ``POST /<db>/highlight``                   (`RequestSearchPart`)
* ``GET  /<db>/_id/<id>``                    (doc store fetch)
* ``GET  /<db>/_idtree/<id>``                (reconstruction from indices)
* ``GET  /<db>/inspect/<path>/<id>``         (raw index reads)

Databases load lazily from disk on first touch (reference `ensure_database`,
rocket_server.rs:95-100) — the registry maps db name -> `Persistence`.
"""

from __future__ import annotations

import json
import os
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

from .error import VelociError
from .persistence import Persistence
from .query.generator import (
    SearchQueryGeneratorParameters,
    search_query,
    suggest_query,
)
from .query.request import Request, RequestSearchPart
from .search.executor import (
    explain_plan,
    search,
    search_to_result_with_doc,
    suggest,
)
from .search.field_search import highlight_field

__all__ = ["VelociServer", "make_server", "PERSISTENCES"]

PERSISTENCES: Dict[str, Persistence] = {}
_LOCK = threading.Lock()

# databases resolve under this directory; the decoded URL segment must stay
# inside it (rejects '/', '\\', '..' — a remote client must not be able to
# load arbitrary filesystem paths through GET /<db>/search)
BASE_DIR = os.environ.get("VELOCI_DB_DIR", ".")


def _resolve_db_path(database: str) -> str:
    if (
        not database
        or database in (".", "..")
        or "/" in database
        or "\\" in database
        or "\x00" in database
        or os.path.isabs(database)
    ):
        raise VelociError(f"invalid database name: {database!r}")
    base = os.path.realpath(BASE_DIR)
    path = os.path.realpath(os.path.join(base, database))
    if path != base and not path.startswith(base + os.sep):
        raise VelociError(f"invalid database name: {database!r}")
    if not os.path.isdir(path):
        raise VelociError(f"database not found: {database!r}")
    return path


def ensure_database(database: str, *, trusted_path: bool = False) -> Persistence:
    """Load (once) and return a database.

    ``trusted_path=True`` is for local callers (the CLI's positional
    database arguments); HTTP handlers always go through name validation.
    """
    with _LOCK:
        pers = PERSISTENCES.get(database)
        if pers is None:
            path = database if trusted_path else _resolve_db_path(database)
            pers = Persistence.load(path)
            if os.environ.get("VELOCI_WARMUP", "1") != "0":
                # upload device bundles + compile the serving buckets NOW
                # (persistent-cache hits after the first process) so the
                # first real query doesn't pay the compiles inline
                pers.warmup()
            PERSISTENCES[database] = pers
        return pers


def _csv(val: Optional[str]):
    if val is None:
        return None
    return [v for v in val.split(",") if v]


def _params_from_query(qs: Dict[str, str]) -> SearchQueryGeneratorParameters:
    """GET /search query params -> generator params (rocket_server.rs:176-244)."""

    def get(name, cast=None):
        v = qs.get(name)
        if v is None or cast is None:
            return v
        return cast(v)

    def get_bool(name):
        v = qs.get(name)
        return None if v is None else v.lower() == "true"

    boost_fields = None
    if qs.get("boost_fields"):
        boost_fields = {}
        for el in _csv(qs["boost_fields"]):
            field, _, val = el.partition("->")
            boost_fields[field] = float(val)
    boost_terms = None
    if qs.get("boost_terms"):
        boost_terms = {}
        for el in _csv(qs["boost_terms"]):
            term, _, val = el.partition("->")
            boost_terms[term] = float(val) if val else 2.0
    boost_queries = None
    if qs.get("boost_queries"):
        from .query.request import RequestBoostPart

        boost_queries = [
            RequestBoostPart.from_dict(b) for b in json.loads(qs["boost_queries"])
        ]

    stopwords = _csv(qs.get("stopwords"))
    return SearchQueryGeneratorParameters(
        search_term=qs.get("query", ""),
        top=get("top", int),
        skip=get("skip", int),
        operator=qs.get("operator"),
        levenshtein=get("levenshtein", int),
        levenshtein_auto_limit=get("levenshtein_auto_limit", int),
        facetlimit=get("facetlimit", int),
        why_found=get_bool("why_found"),
        phrase_pairs=get_bool("phrase_pairs"),
        text_locality=get_bool("text_locality"),
        facets=_csv(qs.get("facets")),
        stopword_lists=_csv(qs.get("stopword_lists")),
        stopwords=set(stopwords) if stopwords else None,
        fields=_csv(qs.get("fields")),
        boost_fields=boost_fields,
        boost_terms=boost_terms,
        explain=get_bool("explain"),
        boost_queries=boost_queries,
        filter=qs.get("filter"),
        select=qs.get("select"),
    )


# ---------------------------------------------------------------- folding
# Lone requests arriving concurrently fold into ONE batched dispatch: the
# dispatcher thread drains whatever queued while the previous batch was on
# the device (no artificial wait — zero added latency when idle, natural
# micro-batches under load). This is the serving-side answer to the
# per-request dispatch tail (each solo dispatch pays a full device round
# trip; a folded batch pays one for all). VELOCI_FOLD=0 disables.
import queue as _queue

_FOLD_ENABLED = os.environ.get("VELOCI_FOLD", "1") != "0"
_MAX_FOLD = int(os.environ.get("VELOCI_FOLD_MAX", "256"))
_fold_queue: Optional["_queue.Queue"] = None
_fold_thread: Optional[threading.Thread] = None
_fold_lock = threading.Lock()


class _FoldItem:
    __slots__ = ("pers", "request", "event", "result", "error", "kind")

    def __init__(self, pers, request, kind="search"):
        self.pers = pers
        self.request = request
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.kind = kind


def _fold_loop() -> None:  # pragma: no cover - exercised via threads in tests
    from .search.batch import search_batch
    from .search.executor import suggest_batch
    from .search.stats import count_path

    while True:
        item = _fold_queue.get()
        batch = [item]
        while len(batch) < _MAX_FOLD:
            try:
                batch.append(_fold_queue.get_nowait())
            except _queue.Empty:
                break
        by_pers: Dict[tuple, tuple] = {}
        for it in batch:
            by_pers.setdefault((id(it.pers), it.kind), (it.pers, []))[1].append(it)
        count_path("fold_dispatches")
        if len(batch) > 1:
            count_path("fold_folded_requests", len(batch))
        for (_pid, kind), (pers, items) in by_pers.items():
            try:
                if kind == "suggest":
                    res = suggest_batch(pers, [it.request for it in items])
                    for it, r in zip(items, res):
                        it.result = r
                elif len(items) == 1:
                    items[0].result = search(items[0].request, pers)
                else:
                    res = search_batch([it.request for it in items], pers)
                    for it, r in zip(items, res):
                        it.result = r
            except Exception as e:  # noqa: BLE001 - surfaced per request
                for it in items:
                    if it.result is None:
                        it.error = e
            for it in items:
                it.event.set()


def _folded(pers, request: Request, kind: str):
    global _fold_queue, _fold_thread
    if _fold_thread is None:
        with _fold_lock:
            if _fold_thread is None:
                _fold_queue = _queue.Queue()
                t = threading.Thread(
                    target=_fold_loop, daemon=True, name="veloci-fold"
                )
                t.start()
                _fold_thread = t
    item = _FoldItem(pers, request, kind)
    _fold_queue.put(item)
    item.event.wait()
    if item.error is not None:
        raise item.error
    return item.result


def _folded_search(pers, request: Request):
    if not _FOLD_ENABLED:
        return search(request, pers)
    return _folded(pers, request, "search")


def _folded_suggest(pers, request: Request):
    """Concurrent suggest requests fold like search does:
    queued items drain into ONE suggest_batch per dispatch round."""
    if not _FOLD_ENABLED:
        return suggest(pers, request)
    return _folded(pers, request, "suggest")


def _search_result_json(pers, request: Request) -> dict:
    res = _folded_search(pers, request)
    with_doc = search_to_result_with_doc(pers, res, request.select)
    return with_doc.to_dict()


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # quiet by default
        pass

    def _reply(self, obj, status=200, raw=False) -> None:
        body = (obj if raw else json.dumps(obj, ensure_ascii=False)).encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", "application/json" if not raw else "text/plain")
        self.send_header("Content-Length", str(len(body)))
        self.send_header("Access-Control-Allow-Origin", "*")
        self.end_headers()
        self.wfile.write(body)

    def _error(self, message: str, status=400) -> None:
        self._reply({"error": message}, status=status)

    def _body_json(self):
        length = int(self.headers.get("Content-Length", 0))
        return json.loads(self.rfile.read(length) or b"{}")

    # ------------------------------------------------------------------ GET
    def do_GET(self) -> None:  # noqa: N802
        try:
            parsed = urllib.parse.urlparse(self.path)
            qs = {k: v[0] for k, v in urllib.parse.parse_qs(parsed.query).items()}
            parts = [p for p in parsed.path.split("/") if p]
            if parsed.path == "/version":
                self._reply("0.8", raw=True)
                return
            if parsed.path == "/stats":
                from .search.stats import snapshot

                self._reply(snapshot())
                return
            if len(parts) == 2 and parts[1] == "search":
                pers = ensure_database(urllib.parse.unquote(parts[0]))
                params = _params_from_query(qs)
                request = search_query(pers, params)
                if qs.get("select"):
                    request.select = _csv(qs["select"])
                self._reply(_search_result_json(pers, request))
                return
            if len(parts) == 2 and parts[1] == "suggest":
                pers = ensure_database(urllib.parse.unquote(parts[0]))
                request = suggest_query(
                    qs.get("query", ""),
                    pers,
                    int(qs["top"]) if qs.get("top") else None,
                    int(qs["skip"]) if qs.get("skip") else None,
                    int(qs["levenshtein"]) if qs.get("levenshtein") else None,
                    _csv(qs.get("fields")),
                    int(qs["levenshtein_auto_limit"])
                    if qs.get("levenshtein_auto_limit")
                    else None,
                )
                self._reply(_folded_suggest(pers, request))
                return
            if len(parts) == 3 and parts[1] == "_id":
                pers = ensure_database(urllib.parse.unquote(parts[0]))
                self._reply(json.loads(pers.doc_loader.get_doc(int(parts[2]))))
                return
            if len(parts) == 3 and parts[1] == "_idtree":
                from .search.read_document import read_data

                pers = ensure_database(urllib.parse.unquote(parts[0]))
                self._reply(read_data(pers, int(parts[2]), pers.get_all_fields()))
                return
            if len(parts) == 4 and parts[1] == "inspect":
                pers = ensure_database(urllib.parse.unquote(parts[0]))
                store = pers.get_valueid_to_parent(urllib.parse.unquote(parts[2]))
                vals = store.get_values(int(parts[3]))
                self._reply([int(v) for v in vals])
                return
            self._error("not found", 404)
        except VelociError as e:
            self._error(str(e), 400)
        except Exception as e:  # pragma: no cover
            self._error(repr(e), 500)

    # ----------------------------------------------------------------- POST
    def do_POST(self) -> None:  # noqa: N802
        try:
            parsed = urllib.parse.urlparse(self.path)
            parts = [p for p in parsed.path.split("/") if p]
            if len(parts) >= 2:
                db = urllib.parse.unquote(parts[0])
                route = "/".join(parts[1:])
                pers = ensure_database(db)
                body = self._body_json()
                if route == "search":
                    request = Request.from_dict(body)
                    self._reply(_search_result_json(pers, request))
                    return
                if route == "search_batch":
                    # batched serving: eligible requests share ONE device
                    # dispatch (see search/batch.py)
                    from .search.batch import search_batch

                    requests = [Request.from_dict(b) for b in body]
                    batch_results = search_batch(requests, pers)
                    out = []
                    for req, res in zip(requests, batch_results):
                        with_doc = search_to_result_with_doc(pers, res, req.select)
                        out.append(with_doc.to_dict())
                    self._reply(out)
                    return
                if route == "search_query_params":
                    params = SearchQueryGeneratorParameters.from_dict(body)
                    request = search_query(pers, params)
                    if body.get("select"):
                        request.select = _csv(body["select"])
                    self._reply(_search_result_json(pers, request))
                    return
                if route == "search_query_params/explain_plan":
                    params = SearchQueryGeneratorParameters.from_dict(body)
                    request = search_query(pers, params)
                    self._reply(explain_plan(request, pers), raw=True)
                    return
                if route == "suggest":
                    request = Request.from_dict(body)
                    self._reply(_folded_suggest(pers, request))
                    return
                if route == "highlight":
                    part = RequestSearchPart.from_dict(body)
                    self._reply(highlight_field(pers, part))
                    return
            self._error("not found", 404)
        except VelociError as e:
            self._error(str(e), 400)
        except Exception as e:  # pragma: no cover
            self._error(repr(e), 500)


class VelociServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True


def make_server(host: str = "0.0.0.0", port: int = 3000) -> VelociServer:
    return VelociServer((host, port), _Handler)


def main() -> None:  # pragma: no cover
    import argparse

    ap = argparse.ArgumentParser(description="veloci_tpu HTTP server")
    ap.add_argument("databases", nargs="*", help="databases to preload")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=3000)
    args = ap.parse_args()
    for db in args.databases:
        ensure_database(db)
    server = make_server(args.host, args.port)
    print(f"Starting Server on {args.host}:{args.port} ...")
    server.serve_forever()


if __name__ == "__main__":  # pragma: no cover
    main()
