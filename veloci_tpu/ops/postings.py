"""Posting-list resolution: matched terms -> dense per-document score vector.

Device replacement for `resolve_token_to_anchor`
(reference src/search/search_field.rs:400-504). Instead of iterating each
token's delta-compressed posting list and sort+dedup-ing hits, the matched
token ids drive a ragged CSR gather with **static padded shapes**, and the
per-anchor max-dedup becomes a `segment_max` into a dense ``[num_docs]``
vector. Downstream set ops (union / intersect / boosts) are then elementwise
over dense vectors — the XLA-friendly formulation of the whole query plan.

Shapes are bucketed (next power of two) so XLA compiles a small number of
program variants that are reused across queries.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "resolve_to_anchor_dense",
    "bucket_size",
    "gather_ragged",
    "fill_segments_i32",
    "fill_segments_f32",
]


def fill_segments_i32(values: jax.Array, out_starts: jax.Array, capacity: int):
    """Segment-constant fill: ``result[i] = values[seg(i)]`` where ``seg(i)``
    is the index of the last segment starting at or before position ``i``.

    ``values`` [T] int32, ``out_starts`` [T] int32 (non-decreasing segment
    start positions; duplicates = empty segments, the LAST duplicate wins).

    Replacement for ``values[searchsorted(out_starts, idx)]`` (a binary
    search + gather per element): one small scatter + one cumsum.
    Integer diffs telescope exactly, so the fill is bit-exact.
    """
    import jax.numpy as jnp

    t = values.shape[0]
    diffs = jnp.concatenate([values[:1], values[1:] - values[:-1]])
    pos = jnp.minimum(out_starts[:t], capacity)  # == capacity drops below
    acc = jnp.zeros(capacity, dtype=jnp.int32).at[pos].add(diffs, mode="drop")
    return jnp.cumsum(acc)


def fill_segments_f32(values: jax.Array, out_starts: jax.Array, capacity: int):
    """f32 variant of :func:`fill_segments_i32` — EXACT (the fill runs on the
    int32 bit patterns, whose diffs telescope without rounding)."""
    import jax
    import jax.numpy as jnp

    bits = jax.lax.bitcast_convert_type(values, jnp.int32)
    filled = fill_segments_i32(bits, out_starts, capacity)
    return jax.lax.bitcast_convert_type(filled, jnp.float32)


def bucket_size(n: int, minimum: int = 64) -> int:
    """Next power of two >= n (>= minimum) — bounds jit recompilations."""
    m = minimum
    while m < n:
        m *= 2
    return m


import os as _os

# Sorted-run / slice-window kernels are O(gathered postings): past this many
# postings the dense-plane executor (O(num_docs)) is both cheaper AND avoids
# multi-million-element variadic sorts that blow up the XLA compile (the 6M
# repeat-doc corpus SIGKILLed the remote compile helper at a 2^23 bucket).
# Queries over the cap route per-request through the plane kernels.
MAX_SORT_CAPACITY = int(_os.environ.get("VELOCI_MAX_SORT_CAPACITY", str(1 << 21)))


@partial(jax.jit, static_argnames=("capacity", "num_docs"))
def _resolve_kernel(
    offsets: jax.Array,  # [num_keys + 2] int32 (tail-padded)
    anchors: jax.Array,  # [nnz_pad] int32 (pad rows point at num_docs)
    scores01: jax.Array,  # [nnz_pad] float32 (index score / 100)
    term_ids: jax.Array,  # [T_pad] int32 (pad = -1)
    term_scores: jax.Array,  # [T_pad] float32
    capacity: int,
    num_docs: int,
    packed=None,  # [nnz_pad, 2] i32 rows replace anchors/scores01
):
    t_pad = term_ids.shape[0]
    valid_term = term_ids >= 0
    safe_ids = jnp.where(valid_term, term_ids, 0)
    starts = offsets[safe_ids]
    ends = offsets[safe_ids + 1]
    counts = jnp.where(valid_term, ends - starts, 0)
    out_starts = jnp.concatenate(
        [jnp.zeros(1, dtype=jnp.int32), jnp.cumsum(counts, dtype=jnp.int32)]
    )
    total = out_starts[t_pad]

    idx = jnp.arange(capacity, dtype=jnp.int32)
    seg = jnp.searchsorted(out_starts[1:], idx, side="right").astype(jnp.int32)
    seg = jnp.minimum(seg, t_pad - 1)
    in_range = idx < total
    src = starts[seg] + (idx - out_starts[seg])
    if packed is not None:
        src = jnp.where(in_range, src, packed.shape[0] - 1)
        rows = packed[src]  # ONE 8-byte row gather per posting
        a = jnp.where(in_range, rows[:, 0], num_docs)
        s01 = jax.lax.bitcast_convert_type(rows[:, 1], jnp.float32)
        s = jnp.where(in_range, s01 * term_scores[seg], -jnp.inf)
    else:
        src = jnp.where(in_range, src, anchors.shape[0] - 1)
        a = jnp.where(in_range, anchors[src], num_docs)
        s = jnp.where(in_range, scores01[src] * term_scores[seg], -jnp.inf)

    dense = jax.ops.segment_max(
        s, a, num_segments=num_docs + 1, indices_are_sorted=False
    )[:num_docs]
    return jnp.where(jnp.isfinite(dense), dense, 0.0)


def resolve_to_anchor_dense(
    dev_field,
    term_ids: np.ndarray,
    term_scores: np.ndarray,
    num_docs: int,
) -> jax.Array:
    """Host wrapper: compute capacity bucket from host offsets, pad, dispatch."""
    term_ids = np.asarray(term_ids, dtype=np.int64)
    term_scores = np.asarray(term_scores, dtype=np.float32)
    if dev_field.offsets is None or len(term_ids) == 0:
        return jnp.zeros(num_docs, dtype=jnp.float32)
    in_range = term_ids < dev_field.num_score_keys
    term_ids = np.where(in_range, term_ids, -1)
    ho = dev_field.host_offsets
    safe = np.where(term_ids >= 0, term_ids, 0)
    total = int(np.sum(np.where(term_ids >= 0, ho[safe + 1] - ho[safe], 0)))
    capacity = bucket_size(max(total, 1))
    t_pad = bucket_size(len(term_ids), 8)
    tid_p = np.full(t_pad, -1, dtype=np.int32)
    tid_p[: len(term_ids)] = term_ids.astype(np.int32)
    ts_p = np.zeros(t_pad, dtype=np.float32)
    ts_p[: len(term_scores)] = term_scores
    packed = dev_field.packed
    return _resolve_kernel(
        dev_field.offsets,
        None if packed is not None else dev_field.anchors,
        None if packed is not None else dev_field.scores01,
        jnp.asarray(tid_p),
        jnp.asarray(ts_p),
        capacity=capacity,
        num_docs=num_docs,
        packed=packed,
    )


@partial(jax.jit, static_argnames=("capacity", "num_segments"))
def masked_segment_count(
    pair_segments: jax.Array,  # [nnz] int32 — target bucket of each relation pair
    pair_sources: jax.Array,  # [nnz] int32 — source id of each relation pair
    source_mask: jax.Array,  # [num_sources] bool — which sources are "hit"
    capacity: int,
    num_segments: int,
):
    """Facet-count primitive: count relation pairs whose source is hit.

    Dense replacement for `count_values_for_ids`
    (reference src/persistence.rs:164, src/facet.rs:95-161): one masked
    segment-sum over the *entire* relation, instead of per-id gathers.
    """
    del capacity
    w = source_mask[pair_sources].astype(jnp.int32)
    return jax.ops.segment_sum(w, pair_segments, num_segments=num_segments)


def gather_ragged(
    offsets: np.ndarray, values: np.ndarray, keys: np.ndarray
) -> np.ndarray:
    """Host CSR multi-gather (numpy), for host-side joins."""
    keys = np.asarray(keys, dtype=np.int64)
    nk = len(offsets) - 1
    keys = keys[(keys >= 0) & (keys < nk)]
    starts = offsets[keys].astype(np.int64)
    ends = offsets[keys + 1].astype(np.int64)
    counts = ends - starts
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, dtype=values.dtype)
    out_starts = np.zeros(len(keys) + 1, dtype=np.int64)
    np.cumsum(counts, out=out_starts[1:])
    idx = np.arange(total, dtype=np.int64)
    seg = np.searchsorted(out_starts[1:], idx, side="right")
    return values[starts[seg] + (idx - out_starts[seg])]
