"""Dissect the single-slot m-route resolve cost: gather vs sort vs the
dedup+top-k tail, at the exact shapes the fuzzy serving plan dispatches
(q tiers x t128 x pow2 capacities). Scan-depth differencing, one sync.

Run alone (one process per card):  python tools/resolve_prof.py
"""
import os, sys, time
from functools import partial

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax
import jax.numpy as jnp

print("backend:", jax.default_backend(), file=sys.stderr, flush=True)
_p = jnp.zeros(8); _p.block_until_ready()
t0 = time.perf_counter(); float(jnp.sum(_p))
print(f"first sync: {time.perf_counter()-t0:.1f}s", file=sys.stderr, flush=True)

NUM_DOCS = 100_000
T_PAD = 128
K = 10

# zipf postings, packed rows (the serving memory layout)
rng = np.random.default_rng(0)
nkeys = 40_000
ranks = np.arange(1, nkeys + 1, dtype=np.float64)
probs = (1.0 / ranks); probs /= probs.sum()
counts = np.maximum((probs * 600_000).astype(np.int64), 1)
nnz = int(counts.sum())
offsets = np.zeros(nkeys + 2, dtype=np.int32)
np.cumsum(counts, out=offsets[1 : nkeys + 1])
offsets[nkeys + 1] = offsets[nkeys]
anchors = rng.integers(0, NUM_DOCS, size=nnz).astype(np.int32)
scores01 = rng.random(nnz, dtype=np.float32)
pad = 1 << 17
packed = np.zeros((nnz + pad, 2), dtype=np.int32)
packed[:nnz, 0] = anchors
packed[:nnz, 1] = scores01.view(np.int32)
offs_d = jnp.asarray(offsets)
packed_d = jnp.asarray(packed)

from veloci_tpu.ops.search_step import _gather_postings
from veloci_tpu.ops.tree_step import tree_candidates_single, candidates_topk


def term_matrix(q_pad, cap):
    """~100 matched terms/row whose runs sum to <= cap (fuzzy-plan shape)."""
    tid = np.full((q_pad, T_PAD), -1, np.int32)
    tsc = np.zeros((q_pad, T_PAD), np.float32)
    host_off = offsets.astype(np.int64)
    for r in range(q_pad):
        tot, j = 0, 0
        for t in rng.permutation(nkeys)[: T_PAD * 3]:
            c = int(host_off[t + 1] - host_off[t])
            if tot + c > cap * 0.75 or j >= 100:
                break
            tid[r, j] = t; tsc[r, j] = 10.0
            tot += c; j += 1
    return jnp.asarray(tid), jnp.asarray(tsc)


def measure(make_body, operands, n1=3, n2=23, reps=3):
    @partial(jax.jit, static_argnames=("n",))
    def run(n, ops):
        def body(carry, _):
            return make_body(carry, ops), None
        carry, _ = jax.lax.scan(body, jnp.float32(0.0), None, length=n)
        return carry

    float(run(n1, operands)); float(run(n2, operands))
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter(); float(run(n1, operands)); w1 = time.perf_counter() - t0
        t0 = time.perf_counter(); float(run(n2, operands)); w2 = time.perf_counter() - t0
        if w2 > w1:
            samples.append((w2 - w1) / (n2 - n1))
    return float(np.median(samples)) * 1e3 if samples else float("nan")


def stage_bodies(cap):
    def gather_only(carry, ops):
        offs, pk, tid, tsc = ops
        off = (carry * jnp.float32(1e-20)).astype(jnp.int32)
        def one(tids, tscs):
            a, s, _sl = _gather_postings(
                offs, None, None, tids + off, tscs, cap, NUM_DOCS,
                term_slots=jnp.zeros_like(tids), packed=pk)
            return a[0].astype(jnp.float32) + s[0]
        return jnp.sum(jax.vmap(one)(tid, tsc)) * jnp.float32(1e-12)

    def gather_sort(carry, ops):
        offs, pk, tid, tsc = ops
        off = (carry * jnp.float32(1e-20)).astype(jnp.int32)
        def one(tids, tscs):
            a, s, _sl = _gather_postings(
                offs, None, None, tids + off, tscs, cap, NUM_DOCS,
                term_slots=jnp.zeros_like(tids), packed=pk)
            a_s, final = tree_candidates_single(a, s, NUM_DOCS)
            return a_s[0].astype(jnp.float32) + final[0]
        return jnp.sum(jax.vmap(one)(tid, tsc)) * jnp.float32(1e-12)

    def full(carry, ops):
        offs, pk, tid, tsc = ops
        off = (carry * jnp.float32(1e-20)).astype(jnp.int32)
        def one(tids, tscs):
            a, s, _sl = _gather_postings(
                offs, None, None, tids + off, tscs, cap, NUM_DOCS,
                term_slots=jnp.zeros_like(tids), packed=pk)
            a_s, final = tree_candidates_single(a, s, NUM_DOCS)
            ids, scores = candidates_topk(a_s, final, K)
            return scores[0] + ids[0].astype(jnp.float32)
        return jnp.sum(jax.vmap(one)(tid, tsc)) * jnp.float32(1e-12)

    return gather_only, gather_sort, full


print("q_pad cap      gather  +sort   full   (ms/dispatch)")
for q_pad, cap in [(64, 4096), (64, 8192), (16, 16384), (8, 32768), (8, 65536)]:
    tid, tsc = term_matrix(q_pad, cap)
    ops = (offs_d, packed_d, tid, tsc)
    g, gs, f = stage_bodies(cap)
    mg = measure(g, ops)
    mgs = measure(gs, ops)
    mf = measure(f, ops)
    print(f"q{q_pad:<4} c{cap:<7} {mg:6.2f} {mgs:6.2f} {mf:6.2f}", flush=True)
