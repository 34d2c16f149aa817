"""Command-line tools.

Mirrors the reference's veloci_bins (veloci_bins/src/bin/):

* ``create_index`` — build an index directory from an ndjson file + TOML/JSON
  config (create_index.rs:22-37)
* ``convert_json_to_line_delimited`` — arbitrary JSON -> ndjson
* ``create_test_index`` — build the bundled test corpora (jmdict-like
  synthetic / gutenberg text) (create_test_index.rs:19-31)
* ``test_large_search`` — N-doc repeat corpus smoke test
  (test_large_search.rs:23-45)
* ``test_very_large_index`` — 40M-pair spill-writer smoke at the default
  chunk threshold with bounded anonymous-RSS verification
  (test_very_large_index.rs:19-31)

Usage: ``python -m veloci_tpu.cli <command> [args]``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from .json_flatten import to_line_delimited
from .persistence import Persistence

__all__ = ["main"]


def cmd_create_index(args) -> None:
    config = Path(args.config).read_text() if args.config else "{}"
    data = Path(args.data).read_text()
    t0 = time.time()
    pers = Persistence.create_from_str(data, config)
    pers.save(args.target)
    print(
        f"created index {args.target!r}: {pers.num_docs} docs, "
        f"{pers.bytes_indexed} bytes indexed in {time.time() - t0:.1f}s"
    )


def cmd_convert(args) -> None:
    data = Path(args.input).read_bytes()
    out = to_line_delimited(data)
    if args.output:
        Path(args.output).write_text(out)
    else:
        sys.stdout.write(out)


def cmd_create_test_index(args) -> None:
    if args.corpus == "gutenberg":
        # one doc per paragraph of the provided text file
        text = Path(args.data).read_text()
        paragraphs = [p.strip() for p in text.split("\n\n") if p.strip()]
        docs = [json.dumps({"line": p, "nr": str(i)}) for i, p in enumerate(paragraphs)]
        data = "\n".join(docs)
        config = '{"line": {"fulltext": {"tokenize": true}}}'
        target = args.target or "gutenberg"
    else:  # jmdict-like synthetic corpus
        sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
        from bench import build_corpus

        data, _vocab = build_corpus(args.num_docs)
        config = "{}"
        target = args.target or "jmdict_like"
    pers = Persistence.create_from_str(data, config)
    pers.save(target)
    print(f"created {target!r}: {pers.num_docs} docs")


def cmd_test_large_search(args) -> None:
    """Repeat-corpus smoke test (reference test_large_search.rs:39-45)."""
    from .query.generator import SearchQueryGeneratorParameters, search_query
    from .search.executor import search

    doc = '{"type":"taschenbuch","title":"mein buch"}'
    data = "\n".join([doc] * args.num_docs)
    t0 = time.time()
    pers = Persistence.create_from_str(data, "{}")
    print(f"built {args.num_docs}-doc index in {time.time() - t0:.1f}s")
    t0 = time.time()
    req = search_query(pers, SearchQueryGeneratorParameters(search_term="buch"))
    res = search(req, pers)
    print(
        f"search 'buch' (cold: compile + H2D of the index): "
        f"{res.num_hits} hits in {(time.time() - t0) * 1e3:.1f}ms"
    )
    lat = []
    for _ in range(5):
        t0 = time.time()
        res = search(req, pers)
        lat.append((time.time() - t0) * 1e3)
    print(
        f"search 'buch' warm: {res.num_hits} hits, "
        f"p50 {sorted(lat)[len(lat) // 2]:.1f}ms over {len(lat)} runs"
    )


def cmd_test_very_large_index(args) -> None:
    """Writer-scale smoke test (reference test_very_large_index.rs:19-31):
    push ``--pairs`` pseudo-random (key, value) pairs through the external
    SpillSorter at its DEFAULT chunk threshold, merge, and verify the
    sorted stream — while asserting peak RSS stays bounded by the chunk
    buffer, not the total pair count (the bounded-RAM claim the spill
    machinery makes). Prints one summary line with anon_peak_mb for
    callers to assert on (anonymous RSS — ru_maxrss would also count
    reclaimable file-backed memmap pages and say nothing about the
    sorter's buffers)."""
    import resource

    def _anon_mb() -> float:
        try:
            with open("/proc/self/status") as f:
                for line in f:
                    if line.startswith("RssAnon:"):
                        return int(line.split()[1]) / 1024.0
        except OSError:
            pass
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0

    import numpy as np

    from .spill import SpillSorter

    pairs = args.pairs
    chunk = args.chunk_items
    gen_batch = 1_000_000
    rng = np.random.default_rng(42)
    t0 = time.time()
    key_sum = 0  # Python int, reduced mod 2^64 (intentional wraparound)
    anon_peak = _anon_mb()
    with SpillSorter(**({"chunk_items": chunk} if chunk else {})) as s:
        left = pairs
        while left > 0:
            n = min(gen_batch, left)
            keys = rng.integers(0, 1 << 62, size=n, dtype=np.uint64)
            vals = keys ^ np.uint64(0xDEADBEEF)
            key_sum = (key_sum + int(keys.sum(dtype=np.uint64))) & 0xFFFFFFFFFFFFFFFF
            s.add(keys, vals)
            left -= n
            anon_peak = max(anon_peak, _anon_mb())
        add_s = time.time() - t0
        t0 = time.time()
        sk, sv = s.finish()
        merge_s = time.time() - t0
        anon_peak = max(anon_peak, _anon_mb())
        # verify the merged stream block-wise (bounded RAM even here)
        blk = 4_000_000
        out_sum = 0
        prev_last = None
        count = 0
        for base in range(0, len(sk), blk):
            kb = np.asarray(sk[base : base + blk])
            vb = np.asarray(sv[base : base + blk])
            assert np.all(kb[1:] >= kb[:-1]), "merged stream not sorted"
            if prev_last is not None:
                assert kb[0] >= prev_last, "run boundary out of order"
            prev_last = kb[-1]
            assert np.all(vb == (kb ^ np.uint64(0xDEADBEEF))), "payload mismatch"
            out_sum = (out_sum + int(kb.sum(dtype=np.uint64))) & 0xFFFFFFFFFFFFFFFF
            count += len(kb)
        anon_peak = max(anon_peak, _anon_mb())
    assert count == pairs, (count, pairs)
    assert out_sum == key_sum, "key checksum mismatch"
    rss_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
    print(
        f"test_very_large_index ok: pairs={pairs} add={add_s:.1f}s "
        f"merge+verify={merge_s:.1f}s anon_peak_mb={anon_peak:.0f} "
        f"rss_mb={rss_mb:.0f} "
        f"pairs_per_s={pairs / max(add_s + merge_s, 1e-9):.0f}"
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="veloci_tpu", description=__doc__)
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("create_index", help="build an index from ndjson")
    p.add_argument("--data", "-d", required=True, help="ndjson data file")
    p.add_argument("--target", "-t", required=True, help="index directory")
    p.add_argument("--config", "-c", help="TOML/JSON fields config file")
    p.set_defaults(fn=cmd_create_index)

    p = sub.add_parser(
        "convert_json_to_line_delimited", help="arbitrary JSON -> ndjson"
    )
    p.add_argument("--input", "-i", required=True)
    p.add_argument("--output", "-o")
    p.set_defaults(fn=cmd_convert)

    p = sub.add_parser("create_test_index", help="build a test corpus index")
    p.add_argument("--corpus", choices=["jmdict", "gutenberg"], default="jmdict")
    p.add_argument("--data", help="text file for the gutenberg corpus")
    p.add_argument("--target", "-t")
    p.add_argument("--num-docs", type=int, default=100_000)
    p.set_defaults(fn=cmd_create_test_index)

    p = sub.add_parser("test_large_search", help="repeat-corpus smoke test")
    p.add_argument("--num-docs", type=int, default=1_000_000)
    p.set_defaults(fn=cmd_test_large_search)

    p = sub.add_parser(
        "test_very_large_index",
        help="40M-pair spill-writer smoke test (bounded-RAM external sort)",
    )
    p.add_argument("--pairs", type=int, default=40_000_000)
    p.add_argument(
        "--chunk-items", type=int, default=0,
        help="SpillSorter chunk size (0 = the default threshold)",
    )
    p.set_defaults(fn=cmd_test_very_large_index)

    p = sub.add_parser("serve", help="start the HTTP server")
    p.add_argument("databases", nargs="*")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=3000)

    def run_serve(args):
        from .server import ensure_database, make_server

        for db in args.databases:
            ensure_database(db, trusted_path=True)
        server = make_server(args.host, args.port)
        print(f"Starting Server on {args.host}:{args.port} ...")
        server.serve_forever()

    p.set_defaults(fn=run_serve)

    args = ap.parse_args(argv)
    # persistent executable cache: serving replicas and repeated CLI runs
    # start warm instead of recompiling
    from .compile_cache import enable_compile_cache

    enable_compile_cache()
    args.fn(args)


if __name__ == "__main__":  # pragma: no cover
    main()
