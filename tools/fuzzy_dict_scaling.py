"""Fuzzy dictionary-size scaling harness.

Measures the batched fuzzy serving kernel (`batched_fuzzy_search_topk*` —
sweep -> on-device select -> sorted-run resolve -> exact top-k, the program
`_run_fuzzy_group` dispatches) at growing dictionary sizes, full matrix vs
the per-row length-window variants, isolating how query cost scales with
|dictionary| (reference analog: the Levenshtein-automaton x FST walk of
search_field.rs:85-96 is sublinear in |dictionary|; the window is the dense
equivalent — lev(a,b) >= |len(a)-len(b)| bounds the reachable rows).

Synthetic dictionaries use diverse prefixes and a realistic length mix;
postings are small and constant-size so the rows isolate dictionary
scaling, not resolve scaling.

Run (on the GPU, or JAX_PLATFORMS=cpu for a mechanical smoke):

    python tools/fuzzy_dict_scaling.py [n_terms ...]   # default 125k..1M
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

NUM_DOCS = 100_000
N_QUERIES = int(os.environ.get("FDS_QUERIES", "128"))
TOP_K = 10
ALPHA = "abcdefghijklmnopqrstuvwxyz"


def gen_terms(n: int, seed: int = 7) -> list:
    """Sorted unique word-like terms, diverse prefixes, lengths ~4-14."""
    rng = np.random.default_rng(seed)
    lens = rng.choice(
        np.arange(4, 15), size=int(n * 1.35),
        p=np.array([4, 7, 10, 12, 13, 13, 12, 10, 8, 6, 5], float) / 100.0,
    )
    letters = rng.integers(0, 26, size=(len(lens), 16))
    terms = {"".join(ALPHA[c] for c in row[:ln]) for row, ln in zip(letters, lens)}
    out = sorted(terms)
    if len(out) < n:  # top up with numbered tails (still diverse prefixes)
        extra = {f"{t}{i}" for i, t in enumerate(out[: n - len(out)])}
        out = sorted(set(out) | extra)
    return out[:n]


def build_field(terms, seed: int = 11):
    """A DeviceField mirroring persistence.device_field's construction
    (persistence.py:666-725) with small synthetic postings."""
    from veloci_tpu.ops.postings import bucket_size
    from veloci_tpu.persistence import DeviceField, _round_up

    n = len(terms)
    max_l = 32
    chars = np.zeros((n, max_l), dtype=np.uint16)
    lengths = np.zeros(n, dtype=np.int32)
    for i, t in enumerate(terms):
        enc = [ord(c) for c in t[:max_l]]
        chars[i, : len(enc)] = enc
        lengths[i] = len(enc)
    n_pad = _round_up(max(n, 8), 1024)
    chars_p = np.zeros((n_pad, max_l), dtype=np.uint16)
    chars_p[:n] = chars
    lens_p = np.zeros(n_pad, dtype=np.int32)
    lens_p[:n] = lengths
    ids_p = np.full(n_pad, -1, dtype=np.int32)
    ids_p[:n] = np.arange(n, dtype=np.int32)

    rng = np.random.default_rng(seed)
    counts = 1 + (np.arange(n) * 7) % 8  # 1..8 postings per term, constant mix
    host_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=host_offsets[1:])
    nnz = int(host_offsets[-1])
    anchors = rng.integers(0, NUM_DOCS, size=nnz).astype(np.int32)
    scores = rng.uniform(0.05, 1.0, size=nnz).astype(np.float32)
    slice_pad = bucket_size(int(counts.max()))
    nnz_pad = _round_up(max(nnz, 8) + slice_pad, 128)
    anchors_p = np.full(nnz_pad, NUM_DOCS, dtype=np.int32)
    anchors_p[:nnz] = anchors
    scores_p = np.zeros(nnz_pad, dtype=np.float32)
    scores_p[:nnz] = scores
    offsets_p = np.zeros(n + 2, dtype=np.int32)
    offsets_p[: n + 1] = host_offsets
    offsets_p[n + 1] = host_offsets[-1]
    return DeviceField(
        chars_host=chars_p,
        lengths_host=lens_p,
        num_terms=n,
        offsets_host=offsets_p,
        anchors_host=anchors_p,
        scores01_host=scores_p,
        host_offsets=host_offsets,
        num_score_keys=n,
        sweep_ids_host=ids_p,
    )


def fuzzy_queries(terms, nq: int = N_QUERIES, seed: int = 23):
    from veloci_tpu.ops.levenshtein import encode_query

    rng = np.random.default_rng(seed)
    picks = rng.choice(len(terms), size=nq)
    qs = np.zeros((nq, 32), dtype=np.uint16)
    qlens = np.zeros(nq, dtype=np.int32)
    raw = []
    for row, i in enumerate(picks):
        t = terms[int(i)]
        if len(t) > 4:  # one substitution -> a genuine d<=2 fuzzy probe
            t = t[:2] + "q" + t[3:]
        raw.append(t)
        q, ql = encode_query(t)
        qs[row] = q
        qlens[row] = ql
    return raw, qs, qlens


def measure_scan(make_body, operands, n1=2, n2=8, reps=3):
    """bench.py's scan-depth differencing (hoist-proof via the carry
    perturbing the char matrix); median of positive samples."""
    import jax
    import jax.numpy as jnp
    from functools import partial

    @partial(jax.jit, static_argnames=("n",))
    def run(n, ops):
        def body(carry, _):
            return make_body(carry, ops), None

        carry, _ = jax.lax.scan(body, jnp.float32(0.0), None, length=n)
        return carry

    float(run(n1, operands))
    float(run(n2, operands))
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        float(run(n1, operands))
        w1 = time.perf_counter() - t0
        t0 = time.perf_counter()
        float(run(n2, operands))
        w2 = time.perf_counter() - t0
        if w2 > w1:
            samples.append((w2 - w1) / (n2 - n1))
    return float(np.median(samples)) if samples else float("nan")


def run_size(n_terms: int) -> dict:
    import jax.numpy as jnp

    from veloci_tpu.ops.fuzzy_step import (
        batched_fuzzy_search_topk,
        batched_fuzzy_search_topk_banded,
    )
    from veloci_tpu.ops.pallas_levenshtein import use_banded_kernel
    from veloci_tpu.ops.postings import MAX_SORT_CAPACITY, bucket_size

    terms = gen_terms(n_terms)
    dev = build_field(terms)
    raw, qs, qlens = fuzzy_queries(terms)
    dists = np.full(N_QUERIES, 2, dtype=np.int32)
    use_banded = use_banded_kernel(2)
    step_fn = (
        batched_fuzzy_search_topk_banded if use_banded else batched_fuzzy_search_topk
    )
    capacity = min(bucket_size(64 * 8), MAX_SORT_CAPACITY)  # 64 matches x <=8

    def one_mode(variant_of):
        # group rows by variant exactly like _run_fuzzy_group
        by_var: dict = {}
        for row, t in enumerate(raw):
            v = variant_of(t)
            by_var.setdefault(id(v), (v, []))[1].append(row)
        plan, ops = [], []
        for v, rows in by_var.values():
            plan.append(len(rows))
            ops.append(
                (
                    v.chars_t if use_banded else v.chars,
                    v.lengths,
                    v.sweep_ids,
                    v.offsets,
                    v.packed,
                    jnp.asarray(qs[rows]),
                    jnp.asarray(qlens[rows]),
                    jnp.asarray(dists[rows]),
                )
            )
        rows_swept = sum(
            v._chars_host.shape[0] * len(r) for v, r in by_var.values()
        )

        def body(carry, groups):
            off = (carry * jnp.float32(1e-20)).astype(jnp.uint16)
            acc = jnp.float32(0)
            for chars_o, lens_o, sweep_o, offs_o, packed_o, q_o, ql_o, d_o in groups:
                _ids, scores, _nh, _tm, _tp = step_fn(
                    chars_o + off[None, None], lens_o, q_o, ql_o, d_o,
                    offs_o, None, None,
                    max_terms=64, capacity=capacity, num_docs=NUM_DOCS,
                    k=TOP_K, packed=packed_o, sweep_ids=sweep_o,
                    **({"band": 2} if use_banded else {}),
                )
                acc = acc + scores[0, 0]
            return acc * jnp.float32(1e-12)

        per = measure_scan(body, tuple(ops))
        return per, len(by_var), rows_swept

    t0 = time.time()
    per_full, _, swept_full = one_mode(lambda t: dev)
    per_win, ngroups, swept_win = one_mode(
        lambda t: dev.length_window_variant(len(t) - 2, len(t) + 2)
    )
    return {
        "n_terms": n_terms,
        "full_ms_per_batch": round(per_full * 1e3, 2),
        "full_qps": round(N_QUERIES / per_full, 1),
        "window_ms_per_batch": round(per_win * 1e3, 2),
        "window_qps": round(N_QUERIES / per_win, 1),
        "window_groups": ngroups,
        "rows_swept_full": swept_full,
        "rows_swept_window": swept_win,
        "speedup": round(per_full / per_win, 2),
        "wall_s": round(time.time() - t0, 1),
    }


def main() -> None:
    import jax

    from veloci_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    backend = jax.default_backend()
    sizes = [int(s) for s in sys.argv[1:]] or [125_000, 250_000, 500_000, 1_000_000]
    print(f"backend={backend} queries={N_QUERIES} d=2 top{TOP_K}", flush=True)
    rows = []
    for n in sizes:
        r = run_size(n)
        rows.append(r)
        print(r, flush=True)
    print("\n| dict terms | full ms/batch | window ms/batch | speedup | window QPS |")
    print("|---|---|---|---|---|")
    for r in rows:
        print(
            f"| {r['n_terms']:,} | {r['full_ms_per_batch']} | "
            f"{r['window_ms_per_batch']} | {r['speedup']}x | {r['window_qps']} |"
        )


if __name__ == "__main__":
    main()
