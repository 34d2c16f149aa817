"""Measure per-iteration device time of the fused search kernels by
differencing two on-device scan depths (single D2H sync; its cost cancels).
Run alone: one process per card."""
import os, sys, time
import numpy as np
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax, jax.numpy as jnp
from functools import partial

print("backend:", jax.default_backend(), file=sys.stderr, flush=True)
_p = jnp.zeros(8); _p.block_until_ready()
t0 = time.perf_counter(); float(jnp.sum(_p))
print(f"first sync: {time.perf_counter()-t0:.1f}s", file=sys.stderr, flush=True)
t0 = time.perf_counter(); float(jnp.sum(_p))
print(f"sync rt: {(time.perf_counter()-t0)*1e3:.1f}ms", file=sys.stderr, flush=True)

# top_k tie stability on this backend
v, i = jax.lax.top_k(jnp.zeros(1000), 5)
print("topk all-ties idx (expect 0..4):", np.asarray(i), file=sys.stderr, flush=True)

NUM_DOCS = 100_000
CAP = 65536
Q = 200
TPAD = 8
K = 10

rng = np.random.default_rng(0)
nkeys = 40_000
ranks = np.arange(1, nkeys + 1, dtype=np.float64)
probs = (1.0 / ranks); probs /= probs.sum()
counts = np.maximum((probs * 600_000).astype(np.int64), 1)
nnz = int(counts.sum())
offsets = np.zeros(nkeys + 2, dtype=np.int32)
np.cumsum(counts, out=offsets[1:nkeys+1])
offsets[nkeys+1] = offsets[nkeys]
anchors = rng.integers(0, NUM_DOCS, size=nnz).astype(np.int32)
scores01 = rng.random(nnz, dtype=np.float32)
offs = jnp.asarray(offsets); anc = jnp.asarray(anchors); sc = jnp.asarray(scores01)

tids = np.full((Q, TPAD), -1, dtype=np.int32)
tids[:, 0] = rng.integers(0, 2000, size=Q)
tsc = np.zeros((Q, TPAD), dtype=np.float32); tsc[:, 0] = 10.0
btid = jnp.asarray(tids); btsc = jnp.asarray(tsc)
stid = jnp.asarray(tids[:, 0]); stsc = jnp.asarray(tsc[:, 0])

from veloci_tpu.ops.search_step import batched_search_topk, batched_single_term_topk
from veloci_tpu.ops.topk import topk_dense_exact

def measure(fn, label, n1=5, n2=25):
    try:
        @partial(jax.jit, static_argnames=("n",))
        def run(n):
            def body(carry, _):
                return fn(carry), None
            carry, _ = jax.lax.scan(body, jnp.float32(0.0), None, length=n)
            return carry
        float(run(n1)); float(run(n2))  # compile + warm
        t0 = time.perf_counter(); float(run(n1)); w1 = time.perf_counter() - t0
        t0 = time.perf_counter(); float(run(n2)); w2 = time.perf_counter() - t0
        per = (w2 - w1) / (n2 - n1)
        print(f"{label}: {per*1e3:.3f} ms/iter ({Q/per:.0f} QPS) (w1={w1*1e3:.0f} w2={w2*1e3:.0f})",
              file=sys.stderr, flush=True)
        return per
    except Exception as e:
        print(f"{label}: FAILED {type(e).__name__}: {e}", file=sys.stderr, flush=True)
        return None

def full(carry):
    ids, scores, nh = batched_search_topk(offs, anc, sc, btid, btsc * (1 + carry),
                                          capacity=CAP, num_docs=NUM_DOCS, k=K)
    return scores[0, 0] * jnp.float32(1e-12)
measure(full, "batched_search_topk 2stage (gather+scatter+2stage-topk)")

def single(carry):
    ids, scores, nh = batched_single_term_topk(offs, anc, sc, stid, stsc * (1 + carry),
                                               capacity=CAP, k=K)
    return scores[0, 0] * jnp.float32(1e-12)
measure(single, "batched_single_term_topk (scatter-free)")

dense_const = jnp.asarray(rng.random((Q, NUM_DOCS), dtype=np.float32))
def topk_only_flat(carry):
    scores, ids = jax.lax.top_k(dense_const * (1 + carry), K)
    return scores[0,0] * jnp.float32(1e-12)
measure(topk_only_flat, f"flat lax.top_k({K}) over [Q,100k]")

def topk_only_2s(carry):
    ids, scores = jax.vmap(lambda d: topk_dense_exact(d, K))(dense_const * (1 + carry))
    return scores[0,0] * jnp.float32(1e-12)
measure(topk_only_2s, f"2-stage topk_dense_exact({K}) over [Q,100k]")

def scatter_only(carry):
    s = jnp.broadcast_to(carry, (Q, CAP)) + 1.0
    a = jnp.broadcast_to(jnp.arange(CAP, dtype=jnp.int32) % NUM_DOCS, (Q, CAP))
    dense = jax.vmap(lambda aa, ss: jax.ops.segment_max(ss, aa, num_segments=NUM_DOCS+1))(a, s)
    return dense[0,0] * jnp.float32(1e-12)
measure(scatter_only, "scatter segment_max [Q,CAP]->[Q,100k]")
