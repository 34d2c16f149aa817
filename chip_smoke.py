#!/usr/bin/env python3
"""Bring-up check: serve a 1M-document index from one NVIDIA GPU.

Drives the engine's main path through the entry points a user calls and
checks every answer:

1. Device: JAX must report a GPU (no CPU fallback). Prints the card's name
   and power limit, the JAX version, the compile-cache directory and
   whether the native indexer is used.
2. Build: a seeded 1M-doc jmdict-shaped corpus (``bench.build_corpus``:
   Zipf over a 40k vocabulary, 3-9-token titles, a 16-value ``cat`` facet,
   an f32 ``pop`` boost column) indexed by ``cli create_index`` in a
   CPU-pinned child that never opens the card.
3. Serve: ``cli serve`` as the only process on the card, started twice in
   a row; prints load + warm-up seconds for each start (the first finds the
   compile cache as it is, the second finds it filled by the first).
4. Queries over HTTP: exact, fuzzy ~1/~2, auto-levenshtein, AND/OR/attribute
   queries, POST /search with filter + Log10 boost + facet, one
   POST /search_batch of 128 fuzzy requests, suggest. Every answer must
   equal the plain host executor's (a CPU-pinned child on the same index,
   run beside the server):
   same ids in the same order, same num_hits and facets, scores within
   rtol 1e-5. ``GET /stats`` must show device routes and zero per-request
   fallbacks.
5. Kernel: the banded sweep kernel against ``levenshtein_sweep`` on the
   card, bit for bit, over the corpus dictionary and a synthetic 1M-term
   one, both bands, query lengths 0/1/31/32; then their timings.

``--four-cards`` runs only the mesh path instead: the same index and
battery through ``search()`` and ``search_batch`` with a 4-card document
mesh attached (``Persistence.attach_mesh``), compared exactly with the
single-card answers.

Usage (from the root of a checkout, on the GPU machine):
    python chip_smoke.py                 # one card
    python chip_smoke.py --four-cards    # four cards

The last stdout line is one JSON object:
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
Any failed phase exits non-zero without that line.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import signal
import socket
import subprocess
import sys
import time
import urllib.parse
import urllib.request

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, ".smoke")  # gitignored: corpus, index, logs
DB = "jmdict1m"
SCORE_RTOL = 1e-5  # scores are f32 elementwise products; no matmul touches them
CHILD_ENV_CPU = {"JAX_PLATFORMS": "cpu", "CUDA_VISIBLE_DEVICES": ""}
_CHILDREN: list = []


class SmokeFailure(Exception):
    pass


def say(*args) -> None:
    print(*args, flush=True)


def _env(**extra) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


def _run(cmd, timeout, env=None, cwd=REPO) -> str:
    proc = subprocess.run(
        cmd, capture_output=True, text=True, timeout=timeout,
        env=env or _env(), cwd=cwd,
    )
    if proc.returncode != 0:
        raise SmokeFailure(
            f"{' '.join(cmd[:4])} ... exited {proc.returncode}:\n"
            f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}"
        )
    return proc.stdout


# ---------------------------------------------------------------- phase 1
def phase_device(want_count: int) -> dict:
    code = (
        "import json, jax; d = jax.devices(); print(json.dumps({"
        "'platform': d[0].platform, 'kind': d[0].device_kind, "
        "'count': len(d), 'jax': jax.__version__}))"
    )
    out = _run([sys.executable, "-c", code], timeout=300)
    dev = json.loads(out.strip().splitlines()[-1])
    if dev["platform"] != "gpu":
        raise SmokeFailure(
            f"no GPU: JAX reports platform {dev['platform']!r} "
            f"({dev['kind']}); this check runs on an NVIDIA GPU only"
        )
    if dev["count"] < want_count:
        raise SmokeFailure(f"need {want_count} GPUs, JAX sees {dev['count']}")
    smi = _run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        timeout=60,
    ).strip().splitlines()
    for line in smi[:want_count]:
        say(f"card: {line}")
    say(f"jax {dev['jax']}: {dev['count']} x {dev['kind']}")
    cache = os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        REPO, ".jax_cache"
    )
    say(f"compile cache: {cache} ({_cache_entries(cache)} entries)")
    native = _run(
        [sys.executable, "-c",
         "from veloci_tpu import native; print(native.native_available())"],
        timeout=300, env=_env(**CHILD_ENV_CPU),
    ).strip().splitlines()[-1]
    say(f"native indexer: {'used' if native == 'True' else 'NOT available'}")
    return dev


def _cache_entries(path: str) -> int:
    try:
        return sum(1 for n in os.listdir(path) if n.endswith("-cache"))
    except OSError:
        return 0


# ---------------------------------------------------------------- phase 2
def phase_build(n_docs: int, seed: int) -> tuple:
    sys.path.insert(0, REPO)
    from bench import BENCH_CONFIG, build_corpus

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    t0 = time.time()
    corpus, vocab = build_corpus(n_docs, seed=seed)
    data = os.path.join(WORK, "data.ndjson")
    with open(data, "w") as f:
        f.write(corpus)
    with open(os.path.join(WORK, "config.toml"), "w") as f:
        f.write(BENCH_CONFIG)
    del corpus
    gen_s = time.time() - t0
    t0 = time.time()
    _run(
        [sys.executable, "-m", "veloci_tpu.cli", "create_index",
         "--data", data, "--target", os.path.join(WORK, DB),
         "--config", os.path.join(WORK, "config.toml")],
        timeout=900, env=_env(**CHILD_ENV_CPU),
    )
    build_s = time.time() - t0
    os.remove(data)
    size = sum(
        os.path.getsize(os.path.join(dp, f))
        for dp, _d, fs in os.walk(os.path.join(WORK, DB))
        for f in fs
    )
    say(
        f"build: {n_docs} docs generated in {gen_s:.1f}s, indexed in "
        f"{build_s:.1f}s (CPU child), index {size / 1e6:.1f} MB"
    )
    return [str(v) for v in vocab]


# ---------------------------------------------------------------- battery
def make_battery(vocab, n_batch: int = 128) -> list:
    """Request battery over the corpus vocabulary. Each item is one HTTP
    call: (kind, payload)."""
    import random

    rng = random.Random(7)
    common = vocab[:200]
    mid = vocab[200:5000]

    def typo(t: str) -> str:
        i = rng.randrange(1, len(t))
        return t[:i] + rng.choice("xyz") + t[i + 1 :]

    items = []
    for t in [common[0], common[7], rng.choice(mid), rng.choice(mid)]:
        items.append(("get_search", {"query": t, "levenshtein": "0", "top": "10"}))
    for d in (1, 2):
        for t in rng.sample(mid, 3):
            items.append(("get_search", {"query": f"{typo(t)}~{d}", "top": "10"}))
    for t in rng.sample(mid, 3) + [common[3]]:
        items.append(("get_search", {"query": typo(t), "top": "10"}))  # auto-lev
    a, b, c = rng.sample(common[:60], 3)
    for q in (f"{a} AND {b}", f"{a} OR {c}", f"title:{b}", f"title:({a} {b}) AND {c}"):
        items.append(("get_search", {"query": q, "levenshtein": "0", "top": "10"}))
    items.append(
        ("get_search", {"query": a, "top": "5", "skip": "3", "facets": "cat"})
    )
    for i, t in enumerate([common[1], rng.choice(mid), typo(rng.choice(mid))]):
        items.append(("post_search", {
            "search_req": {"search": {
                "terms": [t], "path": "title",
                "levenshtein_distance": 1 if i == 2 else 0,
            }},
            "filter": {"search": {"terms": [f"c{i * 5}"], "path": "cat"}},
            "boost": [{"path": "pop", "boost_fun": "Log10", "param": 1}],
            "facets": [{"field": "cat"}],
            "top": 10,
        }))
    batch = []
    for i in range(n_batch):
        t = typo(rng.choice(mid))
        batch.append({
            "search_req": {"search": {
                "terms": [t], "path": "title", "levenshtein_distance": 1 + i % 2,
            }},
            "top": 10,
        })
    items.append(("search_batch", batch))
    for t in [common[2][:3], rng.choice(mid)[:4]]:
        items.append(("get_suggest", {"query": t, "top": "10"}))
        items.append(("get_suggest", {"query": t, "top": "10", "levenshtein": "0"}))
    return items


def answer_in_process(pers, kind, payload, batched: bool):
    """One battery item through the library entry points the HTTP handlers
    call; JSON-shaped like the server's reply."""
    from veloci_tpu import Request, search, search_to_result_with_doc
    from veloci_tpu.query.generator import search_query, suggest_query
    from veloci_tpu.search.batch import search_batch
    from veloci_tpu.search.executor import suggest
    from veloci_tpu.server import _csv, _params_from_query

    def doc(req, res):
        return search_to_result_with_doc(pers, res, req.select).to_dict()

    if kind == "get_search":
        req = search_query(pers, _params_from_query(payload))
        return doc(req, search(req, pers))
    if kind == "post_search":
        req = Request.from_dict(dict(payload))
        return doc(req, search(req, pers))
    if kind == "search_batch":
        reqs = [Request.from_dict(dict(b)) for b in payload]
        res = search_batch(reqs, pers) if batched else [search(r, pers) for r in reqs]
        return [doc(q, r) for q, r in zip(reqs, res)]
    if kind == "get_suggest":
        lev = payload.get("levenshtein")
        req = suggest_query(
            payload["query"], pers, int(payload["top"]), None,
            int(lev) if lev is not None else None, _csv(payload.get("fields")),
        )
        return json.loads(json.dumps(suggest(pers, req)))
    raise ValueError(kind)


def answer_http(port: int, kind, payload):
    base = f"http://127.0.0.1:{port}/{DB}"
    if kind in ("get_search", "get_suggest"):
        route = "search" if kind == "get_search" else "suggest"
        return _http(f"{base}/{route}?{urllib.parse.urlencode(payload)}")
    route = "search" if kind == "post_search" else "search_batch"
    return _http(f"{base}/{route}", payload)


def _http(url, body=None, timeout=600):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        url, data=data, headers={"Content-Type": "application/json"}
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return json.loads(r.read())
    except urllib.error.HTTPError as e:
        raise SmokeFailure(f"{url}: HTTP {e.code}: {e.read()[:2000]!r}") from e


def compare(got, want, rtol: float, path="$") -> list:
    """Mismatches between two JSON answers: exact except floats (scores),
    which agree within ``rtol``; ``execution_time_ns`` is ignored."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            return [f"{path}: keys {sorted(got) if isinstance(got, dict) else got!r} != {sorted(want)}"]
        out = []
        for k in want:
            if k != "execution_time_ns":
                out += compare(got[k], want[k], rtol, f"{path}.{k}")
        return out
    if isinstance(want, list):
        if not isinstance(got, list) or len(got) != len(want):
            return [f"{path}: length {len(got) if isinstance(got, list) else got!r} != {len(want)}"]
        out = []
        for i, (g, w) in enumerate(zip(got, want)):
            out += compare(g, w, rtol, f"{path}[{i}]")
        return out
    if isinstance(want, float) and isinstance(got, (int, float)):
        if not math.isclose(got, want, rel_tol=rtol, abs_tol=0.0):
            return [f"{path}: {got!r} != {want!r}"]
        return []
    return [] if got == want else [f"{path}: {got!r} != {want!r}"]


def _hits(ans) -> int:
    if isinstance(ans, dict):
        return int(ans.get("num_hits", 0))
    return sum(_hits(a) for a in ans) if isinstance(ans, list) else 0


def check_answers(battery, got, want, rtol, label) -> None:
    bad = []
    by_kind: dict = {}
    for (kind, payload), g, w in zip(battery, got, want):
        mism = compare(g, w, rtol)
        if mism:
            bad.append(f"{kind} {json.dumps(payload)[:120]}: {mism[:3]}")
        n = _hits(w) if kind != "get_suggest" else len(w)
        by_kind.setdefault(kind, []).append(n)
    for kind, hits in by_kind.items():
        say(f"  {kind}: {len(hits)} calls, hits per call {hits}")
        if not any(hits):
            bad.append(f"{kind}: every call came back empty — nothing compared")
    if bad:
        raise SmokeFailure(f"{label}: {len(bad)} mismatches:\n" + "\n".join(bad[:20]))
    say(f"{label}: {len(battery)} calls agree")


# ---------------------------------------------------------------- phase 3/4
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_server(tag: str, timeout: float = 900.0):
    port = _free_port()
    log = open(os.path.join(WORK, f"serve_{tag}.log"), "w")
    t0 = time.time()
    proc = subprocess.Popen(
        [sys.executable, "-m", "veloci_tpu.cli", "serve", DB,
         "--host", "127.0.0.1", "--port", str(port)],
        cwd=WORK, env=_env(), stdout=log, stderr=subprocess.STDOUT,
    )
    _CHILDREN.append(proc)
    while True:
        if proc.poll() is not None:
            raise SmokeFailure(f"server ({tag}) exited {proc.returncode}:\n{_tail(log)}")
        try:
            with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/version", timeout=5
            ) as r:
                r.read()
            break
        except OSError:
            if time.time() - t0 > timeout:
                raise SmokeFailure(f"server ({tag}) not up after {timeout}s:\n{_tail(log)}")
            time.sleep(0.5)
    return proc, port, time.time() - t0


def stop(proc) -> None:
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def _tail(log) -> str:
    log.flush()
    with open(log.name) as f:
        return f.read()[-4000:]


def start_reference(battery, n_docs: int):
    """Start the plain host executor in a CPU-pinned child on the same
    index; it runs beside the server, which holds the card."""
    path = os.path.join(WORK, "battery.json")
    with open(path, "w") as f:
        json.dump(battery, f)
    log = open(os.path.join(WORK, "reference.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--reference", path],
        stdout=log, stderr=subprocess.STDOUT, cwd=REPO,
        env=_env(VELOCI_DEVICE_MIN_DOCS=str(10 * n_docs), **CHILD_ENV_CPU),
    )
    _CHILDREN.append(proc)
    return proc, log, path, time.time()


def reference_answers(ref, timeout: float = 900.0) -> list:
    """Wait for the child from :func:`start_reference`; its answers."""
    proc, log, path, t0 = ref
    proc.wait(timeout=timeout)
    if proc.returncode != 0:
        raise SmokeFailure(f"host reference exited {proc.returncode}:\n{_tail(log)}")
    with open(path + ".answers") as f:
        answers = json.load(f)
    say(
        f"reference: host executor (CPU child, beside the server) answered "
        f"in {time.time() - t0:.1f}s"
    )
    return answers


def run_reference(path: str) -> None:
    from veloci_tpu import Persistence

    with open(path) as f:
        battery = json.load(f)
    pers = Persistence.load(os.path.join(WORK, DB))
    out = [answer_in_process(pers, k, p, batched=False) for k, p in battery]
    with open(path + ".answers", "w") as f:
        json.dump(out, f)


def phase_serve_and_query(battery, ref) -> None:
    entries0 = _cache_entries(
        os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(REPO, ".jax_cache")
    )
    proc, port, first_s = start_server("first")
    stop(proc)
    say(f"serve: first start (cache had {entries0} entries) load + warm-up {first_s:.1f}s")
    proc, port, second_s = start_server("second")
    try:
        say(f"serve: second start (warm cache) load + warm-up {second_s:.1f}s")
        _http(f"http://127.0.0.1:{port}/stats")
        got, laps = [], {}
        for kind, payload in battery:
            t0 = time.time()
            got.append(answer_http(port, kind, payload))
            laps.setdefault(kind, []).append(round(time.time() - t0, 3))
        say(
            f"queries: {len(battery)} HTTP calls in {sum(map(sum, laps.values())):.1f}s; "
            f"seconds per call (first use of a shape compiles): {json.dumps(laps)}"
        )
        stats = _http(f"http://127.0.0.1:{port}/stats")
    finally:
        stop(proc)
    want = reference_answers(ref)
    check_answers(battery, got, want, SCORE_RTOL, "server vs host executor")
    paths = stats["paths"]
    say(f"stats: paths {paths}; fallback reasons {stats['fallback_reasons']}")
    if paths.get("per_request_fallback", 0):
        raise SmokeFailure(f"per-request fallbacks: {stats['fallback_reasons']}")
    device = {k: v for k, v in paths.items() if k.startswith(("fused_", "batched_"))}
    if not device.get("batched_fuzzy", 0) and not device.get("batched_tree", 0):
        raise SmokeFailure(f"battery missed the batched device routes: {paths}")
    if not sum(device.values()):
        raise SmokeFailure(f"no request took a device route: {paths}")


# ---------------------------------------------------------------- phase 5
def phase_kernel(pers) -> None:
    import numpy as np

    sys.path.insert(0, os.path.join(REPO, "tools"))
    import sweep_timing as st

    dicts = {
        f"corpus {f}": pers.get_dictionary(f).char_matrix_compact()[:2]
        for f in ("title", "ent_seq")
    }
    dicts["synthetic 1M"] = st.make_dictionary(1_000_000)
    for name, (c, l) in dicts.items():
        q, ql = st.make_queries(c, l, 32, lengths=st.EDGE_QUERY_LENGTHS)
        q2, ql2 = st.make_queries(c, l, 32, seed=3, lengths=range(3, 12))
        t0 = time.perf_counter()
        cells = st.check_parity(
            c, l, np.concatenate([q, q2]), np.concatenate([ql, ql2])
        )
        say(
            f"kernel parity: {name} ({len(l)} terms), bands 2 and 4, query "
            f"lengths 0/1/31/32 and 3-11: {cells} cells bit-identical "
            f"({time.perf_counter() - t0:.1f}s)"
        )
    for name in ("corpus title", "corpus ent_seq"):
        t = st.time_sweeps(*dicts[name])
        say(f"sweep alone, {name}: {json.dumps(t)}")
    for field, distance in (("title", 2), ("ent_seq", 1)):
        t = st.time_fuzzy_batch(pers, field, distance)
        say(f"batched fuzzy request end to end: {json.dumps(t)}")
    check_regex(pers)


def check_regex(pers) -> None:
    """The regex DFA sweep on the card against Python's ``re`` over the
    corpus title dictionary (lowercase terms: the case-folded DFA is exact
    there)."""
    import re

    import numpy as np

    from veloci_tpu.ops.regex_dfa import compile_dfa, regex_match_device
    from veloci_tpu.search.field_search import _rows_to_term_ids

    d = pers.get_dictionary("title")
    dev = pers.device_field("title")
    terms = d.terms
    for pattern in ("w1.*", "w[0-9]+a", ".*ccc", "w(12|3f).*", "[a-w]+", "w.b+"):
        for prefix in (False, True):
            dfa = compile_dfa(pattern, ignore_case=True)
            if dfa is None:
                raise SmokeFailure(f"regex {pattern!r} did not compile to a DFA")
            rows = np.flatnonzero(np.asarray(
                regex_match_device(dev.chars, dev.lengths, dfa, prefix=prefix)
            ))
            got = _rows_to_term_ids(dev, rows, len(terms))
            fn = re.compile(pattern, re.IGNORECASE)
            fn = fn.match if prefix else fn.fullmatch
            want = [i for i, t in enumerate(terms) if 0 < len(t) <= 32 and fn(t)]
            if got.tolist() != want:
                raise SmokeFailure(
                    f"regex {pattern!r} prefix={prefix}: {len(got)} device "
                    f"matches, {len(want)} by re"
                )
    say(f"regex sweep: 12 pattern checks over {len(terms)} terms agree with re")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true")
    ap.add_argument("--docs", type=int, default=1_000_000)
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--reference", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.reference:
        run_reference(args.reference)
        return 0
    if not os.path.isdir(os.path.join(REPO, "veloci_tpu")):
        say("chip_smoke: FAILED: run it from the root of a veloci_tpu checkout")
        return 2
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    cards = 4 if args.four_cards else 1
    try:
        phase_device(cards)
        vocab = phase_build(args.docs, args.seed)
        battery = make_battery(vocab)
        if args.four_cards:
            dev = phase_four_cards(battery)
        else:
            ref = start_reference(battery, args.docs)
            phase_serve_and_query(battery, ref)
            dev = phase_in_process_kernel()
    except (SmokeFailure, subprocess.TimeoutExpired, AssertionError) as e:
        say(f"chip_smoke: FAILED: {e}")
        return 1
    finally:
        for p in _CHILDREN:
            stop(p)
    say(json.dumps({"ok": True, "device": dev}))
    return 0


def _device_line(count_expected: int) -> dict:
    import jax

    d = jax.devices()
    if d[0].platform != "gpu" or len(d) < count_expected:
        raise SmokeFailure(f"in-process devices: {d}")
    return {"platform": d[0].platform, "kind": d[0].device_kind, "count": len(d)}


def phase_in_process_kernel() -> dict:
    from veloci_tpu import Persistence
    from veloci_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = _device_line(1)
    phase_kernel(Persistence.load(os.path.join(WORK, DB)))
    return dev


def phase_four_cards(battery) -> dict:
    """The sharded path users reach through Persistence.attach_mesh, against
    the single-card answers of the same process."""
    from veloci_tpu import Persistence
    from veloci_tpu.compile_cache import enable_compile_cache
    from veloci_tpu.parallel.mesh_executor import build_doc_mesh

    enable_compile_cache()
    dev = _device_line(4)
    pers = Persistence.load(os.path.join(WORK, DB))
    t0 = time.time()
    single = [answer_in_process(pers, k, p, batched=True) for k, p in battery]
    say(f"single card: {len(battery)} calls in {time.time() - t0:.1f}s")
    pers.attach_mesh(build_doc_mesh(4))
    t0 = time.time()
    sharded = [answer_in_process(pers, k, p, batched=True) for k, p in battery]
    say(f"4-card mesh: {len(battery)} calls in {time.time() - t0:.1f}s")
    check_answers(battery, sharded, single, 0.0, "4-card mesh vs single card")
    return dev


if __name__ == "__main__":
    sys.exit(main())
