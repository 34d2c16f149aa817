"""Banded sweep kernel against the plain XLA sweep: parity and timing.

Parity: on the given dictionary, for both bands, the kernel's distances
must equal ``levenshtein_sweep``'s wherever those are <= band (``_BIG``
elsewhere) and its prefix flags must be equal, bit for bit.

Timing: the kernel for a whole query batch against the XLA sweep vmapped
over the chunks the serving path uses (``256e6 // (N * 33 * 4)`` queries
per dispatch), each ending in ``block_until_ready``.

Run on the GPU:  python tools/sweep_timing.py [--terms 1000000]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

EDGE_QUERY_LENGTHS = (0, 1, 31, 32)


def make_dictionary(n: int, seed: int = 7, alphabet: str = "abcdefghij"):
    """``n`` random terms of 1-32 chars: (chars [n, 32] u16, lens [n] i32)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 33, size=n).astype(np.int32)
    codes = np.frombuffer(alphabet.encode(), np.uint8).astype(np.uint16)
    chars = codes[rng.integers(0, len(codes), size=(n, 32))]
    chars[np.arange(32)[None, :] >= lens[:, None]] = 0
    return chars, lens


def make_queries(chars, lens, nq: int, seed: int = 11, lengths=None):
    """Queries cut from dictionary terms with one random substitution, so
    each has neighbours within a small distance. ``lengths`` fixes each
    query's length (a term is padded by repeating its last char)."""
    rng = np.random.default_rng(seed)
    queries = np.zeros((nq, 32), np.uint16)
    qlens = np.zeros(nq, np.int32)
    for r in range(nq):
        t = int(rng.integers(0, len(lens)))
        src = chars[t, : lens[t]]
        ql = int(lengths[r % len(lengths)]) if lengths is not None else len(src)
        if ql == 0:
            continue
        q = np.resize(src, ql).astype(np.uint16)
        q[int(rng.integers(0, ql))] = chars[int(rng.integers(0, len(lens))), 0]
        queries[r, :ql] = q
        qlens[r] = ql
    return queries, qlens


def xla_chunk(n: int) -> int:
    return max(1, int(256e6 // max(n * 33 * 4, 1)))


def _xla_batch(chars_j, lens_j, queries, qlens):
    import jax
    import jax.numpy as jnp

    from veloci_tpu.ops.levenshtein import levenshtein_sweep

    sweep = jax.vmap(lambda q, ql: levenshtein_sweep(chars_j, lens_j, q, ql))
    c = xla_chunk(chars_j.shape[0])
    outs = []
    for base in range(0, len(qlens), c):
        outs.append(
            sweep(jnp.asarray(queries[base : base + c]), jnp.asarray(qlens[base : base + c]))
        )
    return outs


def check_parity(chars, lens, queries, qlens, bands=(2, 4), interpret=False):
    """Raise AssertionError on any mismatch; return the number of
    (query, term) cells compared."""
    import jax.numpy as jnp

    from veloci_tpu.ops.pallas_levenshtein import _BIG, banded_sweep

    chars_j, lens_j = jnp.asarray(chars), jnp.asarray(lens)
    chars_t = jnp.asarray(np.ascontiguousarray(chars.T))
    ref = _xla_batch(chars_j, lens_j, queries, qlens)
    ref_d = np.concatenate([np.asarray(o[0]) for o in ref])
    ref_p = np.concatenate([np.asarray(o[2]) for o in ref])
    for band in bands:
        d, p = banded_sweep(
            chars_t, lens_j, jnp.asarray(queries), jnp.asarray(qlens),
            band=band, interpret=interpret,
        )
        want = np.where(ref_d <= band, ref_d, _BIG)
        bad = np.argwhere(np.asarray(d) != want)
        assert not len(bad), (
            f"band {band}: {len(bad)} distance mismatches, first (query, term) "
            f"{bad[:3].tolist()}"
        )
        assert np.array_equal(np.asarray(p), ref_p), f"band {band}: prefix flags"
    return len(bands) * ref_d.size


def _median_s(fn, reps: int) -> float:
    import jax

    jax.block_until_ready(fn())  # compile + first run
    laps = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        laps.append(time.perf_counter() - t0)
    return statistics.median(laps)


def time_sweeps(chars, lens, nqs=(64, 128), bands=(2, 4), reps=5, xla_reps=3):
    """Median seconds per batch: kernel per (band, nq), XLA per nq (the XLA
    sweep does not depend on the band)."""
    import jax.numpy as jnp

    from veloci_tpu.ops.pallas_levenshtein import banded_sweep

    chars_j, lens_j = jnp.asarray(chars), jnp.asarray(lens)
    chars_t = jnp.asarray(np.ascontiguousarray(chars.T))
    out = {"terms": int(len(lens)), "xla_chunk": xla_chunk(len(lens))}
    for nq in nqs:
        queries, qlens = make_queries(chars, lens, nq, lengths=range(4, 11))
        qj, qlj = jnp.asarray(queries), jnp.asarray(qlens)
        for band in bands:
            out[f"kernel_band{band}_q{nq}_s"] = _median_s(
                lambda: banded_sweep(chars_t, lens_j, qj, qlj, band=band), reps
            )
        out[f"xla_q{nq}_s"] = _median_s(
            lambda: _xla_batch(chars_j, lens_j, queries, qlens), xla_reps
        )
    return out


@contextlib.contextmanager
def xla_route():
    """Send every sweep of the block through the XLA sweep (the plain
    version the kernel is measured against)."""
    from veloci_tpu.ops import pallas_levenshtein as pk

    orig = pk.sweep_route
    pk.sweep_route = lambda: "xla"
    try:
        yield
    finally:
        pk.sweep_route = orig


def fuzzy_requests(pers, field: str, distance: int, n: int = 128, seed: int = 3):
    """``n`` single-leaf fuzzy requests on ``field``: dictionary terms of
    3-12 chars with one char substituted."""
    from veloci_tpu import Request

    rng = np.random.default_rng(seed)
    terms = [t for t in pers.get_dictionary(field).terms if 3 <= len(t) <= 12]
    out = []
    for t in rng.choice(terms, size=n):
        i = int(rng.integers(0, len(t)))
        t = t[:i] + ("7" if t[i] != "7" else "x") + t[i + 1 :]
        out.append(
            Request.from_dict(
                {
                    "search_req": {
                        "search": {
                            "terms": [t],
                            "path": field,
                            "levenshtein_distance": distance,
                        }
                    },
                    "top": 10,
                }
            )
        )
    return out


def time_fuzzy_batch(pers, field: str, distance: int, reps: int = 3):
    """Median seconds of ``search_batch`` over 128 fuzzy requests with the
    kernel route and with the XLA route (match memo cleared before every
    run, so each one sweeps). Both routes must give the same answers."""
    from veloci_tpu.search.batch import search_batch

    reqs = fuzzy_requests(pers, field, distance)

    def run():
        getattr(pers, "_fuzzy_match_memo", {}).clear()
        return search_batch(reqs, pers)

    def timed():
        res = run()  # compile + first run
        laps = []
        for _ in range(reps):
            t0 = time.perf_counter()
            run()
            laps.append(time.perf_counter() - t0)
        return statistics.median(laps), res

    kernel_s, res_k = timed()
    with xla_route():
        xla_s, res_x = timed()
    for a, b in zip(res_k, res_x):
        assert a.num_hits == b.num_hits and [h.id for h in a.data] == [
            h.id for h in b.data
        ], (field, a.num_hits, b.num_hits)
    return {
        "field": field,
        "terms": len(pers.get_dictionary(field)),
        "requests": len(reqs),
        "distance": distance,
        "hits": sum(r.num_hits for r in res_k),
        "kernel_s": kernel_s,
        "xla_s": xla_s,
    }


def tune(chars, lens, nq=128, band=2, reps=5):
    """Kernel seconds per batch over block widths and warp counts."""
    import jax.numpy as jnp

    from veloci_tpu.ops.pallas_levenshtein import banded_sweep

    lens_j = jnp.asarray(lens)
    chars_t = jnp.asarray(np.ascontiguousarray(chars.T))
    queries, qlens = make_queries(chars, lens, nq, lengths=range(4, 11))
    qj, qlj = jnp.asarray(queries), jnp.asarray(qlens)
    out = {}
    for bn in (128, 256, 512, 1024):
        for nw in (2, 4, 8):
            if bn // (32 * nw) < 1:
                continue
            out[f"bn{bn}_w{nw}"] = _median_s(
                lambda: banded_sweep(
                    chars_t, lens_j, qj, qlj, band=band, block_n=bn, num_warps=nw
                ),
                reps,
            )
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--terms", type=int, default=1_000_000)
    ap.add_argument("--window", type=int, default=65_536)
    ap.add_argument("--tune", action="store_true")
    args = ap.parse_args()
    import jax

    dev = jax.devices()[0]
    print(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())}")
    for n in (args.window, args.terms):
        chars, lens = make_dictionary(n)
        qs, qls = make_queries(chars, lens, 16, lengths=EDGE_QUERY_LENGTHS)
        t0 = time.perf_counter()
        cells = check_parity(chars, lens, qs, qls)
        print(f"parity ok: {n} terms, {cells} cells, {time.perf_counter() - t0:.1f}s")
        print(json.dumps(time_sweeps(chars, lens)))
        if args.tune:
            print(json.dumps({"terms": n, **tune(chars, lens)}))


if __name__ == "__main__":
    main()
