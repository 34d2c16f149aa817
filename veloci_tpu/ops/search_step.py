"""Fused device search steps: matched terms -> top-k documents in ONE XLA
program.

This is the device lowering of the reference's hot query path
(`ResolveTokenIdToAnchor` -> `Union` -> `top_n_sort`;
src/search/search_field.rs:400-504, set_op.rs:87-220, sort.rs:5-34): a ragged
CSR gather over the anchor-score postings, per-(term-slot, anchor) max via
segment reductions on a dense score plane, the distinct-terms^2 union boost,
and an exact two-stage top-k (ops/topk.py) — all fused by XLA, no host
round-trips.

The single-term kernels skip the dense plane entirely: a term's posting run
is already sorted by anchor with one entry per anchor (dedup-max happens at
index time, create.rs:418-448), so top-k over the gathered run IS the
answer — no scatter, no [num_docs] plane. That is the speed-of-light path
for the dominant query shape (one exact term).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .topk import topk_dense_exact, topk_positions

# block granularity of the packed-row posting gather (128 B per gather
# step; see the block branch of _gather_postings). Code in that branch
# hardcodes the matching shift (>> 4).
_BLOCK = 16

__all__ = [
    "exact_search_topk",
    "single_term_search_topk",
    "batched_single_term_topk",
    "union_search_topk",
    "batched_search_topk",
    "batched_union_search_topk",
    "intersect_search_topk",
]


def _single_term_impl(offsets, anchors, scores01, term_id, term_score, capacity, k,
                      packed=None):
    start = offsets[term_id]
    count = offsets[term_id + 1] - start
    # a term's posting run is CONTIGUOUS: a dynamic_slice is one contiguous
    # read instead of a per-element gather (the device arrays carry
    # >= capacity tail padding so the window never clamps). With ``packed`` ONE [capacity, 2] row slice
    # replaces both slices — and the separate anchors/scores01 arrays never
    # need to exist on device at all (half the posting H2D/HBM).
    if packed is not None:
        rows = jax.lax.dynamic_slice(packed, (start, 0), (capacity, 2))
        s_run = jax.lax.bitcast_convert_type(rows[:, 1], jnp.float32)
        a_run = rows[:, 0]
    else:
        s_run = jax.lax.dynamic_slice(scores01, (start,), (capacity,))
        a_run = None
    idx = jnp.arange(capacity, dtype=jnp.int32)
    in_r = idx < count
    # REVERSED orientation: position asc = anchor desc, so the stable
    # two-stage top-k ties prefer the higher anchor id (sort.rs:5-34 order)
    s = jnp.where(in_r, s_run * term_score, -jnp.inf)[::-1]
    pos, scores = topk_positions(s, k)
    # map reversed positions back to forward offsets; gather only k anchors
    fwd = jnp.where(jnp.isfinite(scores), (capacity - 1) - pos, 0)
    if a_run is None:
        a_run = jax.lax.dynamic_slice(anchors, (start,), (capacity,))
    ids = jnp.where(scores > 0, a_run[fwd], 0).astype(jnp.int32)
    num_hits = jnp.minimum(count, capacity)
    return ids, scores, num_hits


@partial(jax.jit, static_argnames=("capacity", "k"))
def single_term_search_topk(
    offsets: jax.Array,  # [num_keys + 2] int32
    anchors: jax.Array,  # [nnz_pad] int32 (None when packed is given)
    scores01: jax.Array,  # [nnz_pad] f32 (None when packed is given)
    term_id: jax.Array,  # scalar int32
    term_score: jax.Array,  # scalar f32
    capacity: int,
    k: int,
    packed=None,  # [nnz_pad, 2] i32 interleaved rows
):
    """One exact term -> top-k docs. Scatter-free, plane-free, exact ties.

    CONTRACT: the posting arrays must carry >= ``capacity`` elements of
    tail padding past the last real posting (``Persistence.device_field``
    guarantees this), so the slice window never clamps.
    """
    return _single_term_impl(
        offsets, anchors, scores01, term_id, term_score, capacity, k,
        packed=packed,
    )


@partial(jax.jit, static_argnames=("capacity", "k"))
def batched_single_term_topk(
    offsets: jax.Array,
    anchors: jax.Array,
    scores01: jax.Array,
    term_ids: jax.Array,  # [Q] int32
    term_scores: jax.Array,  # [Q] f32
    capacity: int,
    k: int,
    packed=None,
):
    """Throughput mode for the dominant query shape: Q single-term exact
    queries in ONE dispatch."""

    def one(tid, tsc):
        return _single_term_impl(
            offsets, anchors, scores01, tid, tsc, capacity, k, packed=packed
        )

    return jax.vmap(one)(term_ids, term_scores)


def _gather_postings(offsets, anchors, scores01, term_ids, term_scores,
                     capacity, num_docs, win=None, term_slots=None,
                     packed=None, term_ngs=None):
    """Concatenate the selected terms' posting runs into static [capacity]
    arrays (+ the matching term-slot segment vector).

    Lowerings:

    * ``packed`` ([nnz, 2] int32 interleaved (anchor, score-bits) rows,
      `DeviceField.packed`) — ONE 8-byte row gather per posting instead of
      two 4-byte gathers. Preferred when the caller holds a device
      bundle.
    * ``win=None`` — per-element gathers via scatter+cumsum source indices.
      Kept for callers whose arrays lack the packed form (ad-hoc tests,
      mesh shards).
    * ``win=W`` (static) — slice packing: each term's run is read with ONE
      contiguous ``dynamic_slice`` window of W elements and written forward
      with ``dynamic_update_slice`` at its output offset; each window's
      garbage tail is exactly overwritten by the next term's window, and the
      last tail lands in the buffer's extra W padding. Contiguous DMA both
      ways. CONTRACT: W >= every selected term's posting count, and the
      source arrays carry >= W tail padding (Persistence.device_field
      guarantees slice padding >= the field's largest run).
    """
    from .postings import fill_segments_f32, fill_segments_i32

    t_pad = term_ids.shape[0]
    valid = term_ids >= 0
    safe = jnp.where(valid, term_ids, 0)
    starts = jnp.where(valid, offsets[safe], 0)
    counts = jnp.where(valid, offsets[safe + 1] - starts, 0)
    out_starts_ex = jnp.cumsum(counts, dtype=jnp.int32) - counts  # exclusive
    total = out_starts_ex[t_pad - 1] + counts[t_pad - 1]
    idx = jnp.arange(capacity, dtype=jnp.int32)
    slots = (
        term_slots
        if term_slots is not None
        else jnp.arange(t_pad, dtype=jnp.int32)
    )
    if (
        win is None
        and packed is not None
        and packed.shape[0] % _BLOCK == 0
        and capacity % _BLOCK == 0
    ):
        # BLOCK gather: posting runs are CONTIGUOUS in ``packed``, so read
        # them at 16-row (128 B) granularity instead of 8 B elements (16x
        # fewer gather indices, and far less XLA compile for big
        # capacities). Each run is covered by ceil(count/16)+1 possibly-misaligned
        # blocks; edge elements outside [start, end) are masked to the
        # usual sentinels (anchor=num_docs, score=-inf), which every
        # downstream evaluator already excludes. Output width grows from
        # ``capacity`` to ``capacity + 16 * t_pad`` (the per-run slack),
        # which the downstream sort absorbs.
        B = _BLOCK
        ends = starts + counts
        b_starts = starts >> 4
        b_counts = jnp.where(counts > 0, ((ends + (B - 1)) >> 4) - b_starts, 0)
        out_b_ex = jnp.cumsum(b_counts, dtype=jnp.int32) - b_counts
        total_b = out_b_ex[t_pad - 1] + b_counts[t_pad - 1]
        # static block budget: blocks(run) = ceil((count + start%16)/16)
        # <= ceil(count/16) + 1, and sum(ceil(c_t/16)) <= cap/16 + t_real,
        # so cap/16 + 2*t_pad always covers (overflow would silently DROP
        # postings via the fill's mode="drop")
        nb = capacity // B + 2 * t_pad
        bidx = jnp.arange(nb, dtype=jnp.int32)
        src_b = bidx + fill_segments_i32(b_starts - out_b_ex, out_b_ex, nb)
        rs_fill = fill_segments_i32(starts, out_b_ex, nb)
        re_fill = fill_segments_i32(ends, out_b_ex, nb)
        slot_b = fill_segments_i32(slots, out_b_ex, nb)
        tsc_b = fill_segments_f32(term_scores, out_b_ex, nb)
        in_b = bidx < total_b
        src_b = jnp.clip(
            jnp.where(in_b, src_b, 0), 0, packed.shape[0] // B - 1
        )
        rows = packed.reshape(-1, B, 2)[src_b]  # [nb, B, 2] — 128B loads
        gidx = src_b[:, None] * B + jnp.arange(B, dtype=jnp.int32)[None, :]
        valid = (
            in_b[:, None] & (gidx >= rs_fill[:, None]) & (gidx < re_fill[:, None])
        )
        a = jnp.where(valid, rows[:, :, 0], num_docs).reshape(nb * B)
        s01 = jax.lax.bitcast_convert_type(rows[:, :, 1], jnp.float32)
        s = jnp.where(valid, s01 * tsc_b[:, None], -jnp.inf).reshape(nb * B)
        slot_fill = jnp.where(
            valid, slot_b[:, None], slots[t_pad - 1]
        ).reshape(nb * B)
        if term_ngs is not None:
            ng_b = fill_segments_f32(
                term_ngs.astype(jnp.float32), out_b_ex, nb
            )
            ng_fill = jnp.where(
                valid, ng_b[:, None], term_ngs[t_pad - 1]
            ).reshape(nb * B)
            return a, s, slot_fill, ng_fill
        return a, s, slot_fill
    if win is None:
        # segment mapping via scatter+cumsum fills instead of searchsorted
        # + small-table gathers
        slot_fill = fill_segments_i32(slots, out_starts_ex, capacity)
        src = idx + fill_segments_i32(starts - out_starts_ex, out_starts_ex, capacity)
        tsc_fill = fill_segments_f32(term_scores, out_starts_ex, capacity)
        in_range = idx < total
        if packed is not None:
            src = jnp.clip(jnp.where(in_range, src, 0), 0, packed.shape[0] - 1)
            rows = packed[src]  # [capacity, 2] — one 8B row load each
            a = jnp.where(in_range, rows[:, 0], num_docs)
            s01 = jax.lax.bitcast_convert_type(rows[:, 1], jnp.float32)
            s = jnp.where(in_range, s01 * tsc_fill, -jnp.inf)
        else:
            src = jnp.clip(jnp.where(in_range, src, 0), 0, anchors.shape[0] - 1)
            a = jnp.where(in_range, anchors[src], num_docs)
            s = jnp.where(in_range, scores01[src] * tsc_fill, -jnp.inf)
        slot_fill = jnp.where(in_range, slot_fill, slots[t_pad - 1])
        if term_ngs is not None:
            # per-row AND-gate count for the deep tree kernel: every posting
            # row carries its subtree's group count (tree_candidates_deep)
            ng_fill = fill_segments_f32(
                term_ngs.astype(jnp.float32), out_starts_ex, capacity
            )
            ng_fill = jnp.where(in_range, ng_fill, term_ngs[t_pad - 1])
            return a, s, slot_fill, ng_fill
        return a, s, slot_fill
    buf_a = jnp.full((capacity + win,), num_docs, dtype=jnp.int32)
    buf_s = jnp.full((capacity + win,), -jnp.inf, dtype=jnp.float32)
    buf_seg = jnp.zeros((capacity + win,), dtype=jnp.int32)
    buf_tsc = jnp.zeros((capacity + win,), dtype=jnp.float32)
    for t in range(t_pad):  # static unroll: t_pad is small (<= 16)
        if packed is not None:
            rows_win = jax.lax.dynamic_slice(packed, (starts[t], 0), (win, 2))
            a_win = rows_win[:, 0]
            s_win = jax.lax.bitcast_convert_type(rows_win[:, 1], jnp.float32)
        else:
            a_win = jax.lax.dynamic_slice(anchors, (starts[t],), (win,))
            s_win = jax.lax.dynamic_slice(scores01, (starts[t],), (win,))
        buf_a = jax.lax.dynamic_update_slice(buf_a, a_win, (out_starts_ex[t],))
        buf_s = jax.lax.dynamic_update_slice(buf_s, s_win, (out_starts_ex[t],))
        buf_seg = jax.lax.dynamic_update_slice(
            buf_seg, jnp.full((win,), slots[t]), (out_starts_ex[t],)
        )
        buf_tsc = jax.lax.dynamic_update_slice(
            buf_tsc, jnp.full((win,), term_scores[t]), (out_starts_ex[t],)
        )
    in_range = idx < total
    slot_fill = jnp.where(in_range, buf_seg[:capacity], slots[t_pad - 1])
    a = jnp.where(in_range, buf_a[:capacity], num_docs)
    s = jnp.where(
        in_range, buf_s[:capacity] * buf_tsc[:capacity], -jnp.inf
    )
    return a, s, slot_fill


def _gather_postings_sliced(
    offsets, term_ids, term_scores, widths, num_docs, term_slots, packed,
    term_ngs=None,
):
    """All-slice posting gather: term ``j`` is read with ONE contiguous
    ``lax.dynamic_slice`` of static ``widths[j]`` rows at a STATIC output
    offset (plain concatenation — no compaction, no per-element gather, no
    segment fills).

    Why: a per-element gather over ``[capacity]`` pays one index per
    posting at runtime and a compile time that grows with the capacity,
    while the same postings read as a few vmapped dynamic_slices are
    contiguous reads with a small program. Each term's ragged tail stays
    in place as masked padding (anchor=num_docs, score=-inf) — exactly the
    sentinels the sorted-run evaluators already exclude, so downstream
    code is unchanged; only the working width grows from ``capacity`` to
    ``sum(widths)``, which the downstream sort absorbs.

    The caller picks ``widths`` (host-side, static per dispatch) such that
    widths[j] >= term j's posting count for every query in the batch —
    see search/batch.py ``_slice_plan`` (terms pre-sorted by run length
    descending onto a geometric width ladder). CONTRACT: ``packed`` must
    carry >= max(widths) tail padding; `Persistence.device_combined` pads
    by bucket_size(largest run) and the planner clamps widths to the
    largest-run bucket, so the slice window never clamps.
    """
    t_pad = term_ids.shape[0]
    # a widths/term mismatch would silently DROP trailing term columns
    # (enumerate stops at the shorter sequence) — fail loudly instead
    assert len(widths) == t_pad, (
        f"slice widths ({len(widths)}) != term columns ({t_pad})"
    )
    slots = (
        term_slots
        if term_slots is not None
        else jnp.arange(t_pad, dtype=jnp.int32)
    )
    valid = term_ids >= 0
    safe = jnp.where(valid, term_ids, 0)
    starts = jnp.where(valid, offsets[safe], 0)
    counts = jnp.where(valid, offsets[safe + 1] - starts, 0)
    parts_a, parts_s, parts_slot, parts_ng = [], [], [], []
    for j, w in enumerate(widths):
        rows = jax.lax.dynamic_slice(packed, (starts[j], 0), (w, 2))
        m = jnp.arange(w, dtype=jnp.int32) < counts[j]
        parts_a.append(jnp.where(m, rows[:, 0], num_docs))
        s01 = jax.lax.bitcast_convert_type(rows[:, 1], jnp.float32)
        parts_s.append(jnp.where(m, s01 * term_scores[j], -jnp.inf))
        parts_slot.append(jnp.full((w,), slots[j], dtype=jnp.int32))
        if term_ngs is not None:
            parts_ng.append(
                jnp.full((w,), 1.0, dtype=jnp.float32) * term_ngs[j]
            )
    a = jnp.concatenate(parts_a)
    s = jnp.concatenate(parts_s)
    slot = jnp.concatenate(parts_slot)
    if term_ngs is not None:
        return a, s, slot, jnp.concatenate(parts_ng)
    return a, s, slot


@partial(jax.jit, static_argnames=("capacity", "num_docs", "k", "win"))
def exact_search_topk(
    offsets: jax.Array,  # [num_keys + 2] int32
    anchors: jax.Array,  # [nnz_pad] int32 (pad -> num_docs)
    scores01: jax.Array,  # [nnz_pad] f32
    term_ids: jax.Array,  # [T_pad] int32 (pad -1)
    term_scores: jax.Array,  # [T_pad] f32
    capacity: int,
    num_docs: int,
    k: int,
    win: int | None = None,
    packed=None,
):
    """Single-query search: resolve postings, dedup-max per anchor, top-k."""
    a, s, _seg = _gather_postings(
        offsets, anchors, scores01, term_ids, term_scores, capacity, num_docs,
        win=win, packed=packed,
    )
    dense = jax.ops.segment_max(s, a, num_segments=num_docs + 1)[:num_docs]
    dense = jnp.where(jnp.isfinite(dense), dense, 0.0)
    ids, scores = topk_dense_exact(dense, k)
    num_hits = jnp.sum(dense > 0, dtype=jnp.int32)
    return ids, scores, num_hits


@partial(jax.jit, static_argnames=("capacity", "num_docs", "k", "win"))
def batched_search_topk(
    offsets: jax.Array,
    anchors: jax.Array,
    scores01: jax.Array,
    term_ids: jax.Array,  # [Q, T_pad] int32 (pad -1)
    term_scores: jax.Array,  # [Q, T_pad] f32
    capacity: int,
    num_docs: int,
    k: int,
    win: int | None = None,
    packed=None,
):
    """Throughput mode: a batch of queries in ONE device dispatch.

    The serving-side analogue of the reference's per-request thread pool:
    queries batch into one `vmap`'d XLA program so device bandwidth, not
    dispatch latency, sets the throughput ceiling.
    """

    def one(tids, tscores):
        return exact_search_topk(
            offsets, anchors, scores01, tids, tscores,
            capacity=capacity, num_docs=num_docs, k=k, win=win, packed=packed,
        )

    return jax.vmap(one)(term_ids, term_scores)


def _union_impl(
    offsets, anchors, scores01, term_ids, term_scores, term_slots,
    capacity, num_docs, k, num_slots, win=None, packed=None,
):
    a, s, slot = _gather_postings(
        offsets, anchors, scores01, term_ids, term_scores, capacity, num_docs,
        win=win, term_slots=term_slots, packed=packed,
    )
    # plane key = slot * (num_docs+1) + anchor
    plane = slot * (num_docs + 1) + a
    per_slot = jax.ops.segment_max(
        s, plane, num_segments=num_slots * (num_docs + 1)
    ).reshape(num_slots, num_docs + 1)[:, :num_docs]
    per_slot = jnp.where(jnp.isfinite(per_slot), per_slot, 0.0)
    distinct = jnp.sum(per_slot >= 1e-5, axis=0).astype(jnp.float32)
    dense = jnp.sum(per_slot, axis=0) * distinct * distinct
    ids, scores = topk_dense_exact(dense, k)
    num_hits = jnp.sum(dense > 0, dtype=jnp.int32)
    return ids, scores, num_hits


@partial(jax.jit, static_argnames=("capacity", "num_docs", "k", "num_slots", "win"))
def union_search_topk(
    offsets: jax.Array,
    anchors: jax.Array,
    scores01: jax.Array,
    term_ids: jax.Array,  # [T_pad] int32
    term_scores: jax.Array,  # [T_pad] f32
    term_slots: jax.Array,  # [T_pad] int32 — distinct query-term index
    capacity: int,
    num_docs: int,
    k: int,
    num_slots: int,
    win: int | None = None,
    packed=None,
):
    """Multi-term OR: per-slot max, sum over slots * distinct^2, top-k.

    Mirrors union_hits_score (set_op.rs:87-220) with the per-term dense max
    expressed as ONE segment_max over a (slot, anchor) plane.
    """
    return _union_impl(
        offsets, anchors, scores01, term_ids, term_scores, term_slots,
        capacity, num_docs, k, num_slots, win=win, packed=packed,
    )


@partial(jax.jit, static_argnames=("capacity", "num_docs", "k", "num_slots", "win"))
def batched_union_search_topk(
    offsets: jax.Array,
    anchors: jax.Array,
    scores01: jax.Array,
    term_ids: jax.Array,  # [Q, T_pad] int32 (pad -1)
    term_scores: jax.Array,  # [Q, T_pad] f32
    term_slots: jax.Array,  # [Q, T_pad] int32
    capacity: int,
    num_docs: int,
    k: int,
    num_slots: int,
    win: int | None = None,
    packed=None,
):
    """Batched multi-term OR: the full union semantics (per-distinct-term max,
    distinct^2 boost) vmapped over a query batch — the serving kernel behind
    `search_batch` for generator-style queries that OR one term across many
    fields (term ids are then GLOBAL ids into the combined-field CSR)."""

    def one(tids, tscores, tslots):
        return _union_impl(
            offsets, anchors, scores01, tids, tscores, tslots,
            capacity, num_docs, k, num_slots, win=win, packed=packed,
        )

    return jax.vmap(one)(term_ids, term_scores, term_slots)


@partial(jax.jit, static_argnames=("capacity", "num_docs", "k", "num_slots", "win"))
def intersect_search_topk(
    offsets: jax.Array,
    anchors: jax.Array,
    scores01: jax.Array,
    term_ids: jax.Array,  # [T_pad] int32 (pad -1); may be GLOBAL combined ids
    term_scores: jax.Array,  # [T_pad] f32
    term_slots: jax.Array,  # [T_pad] int32 — one slot per AND leaf
    capacity: int,
    num_docs: int,
    k: int,
    num_slots: int,
    win: int | None = None,
    packed=None,
):
    """Multi-leaf AND: per-leaf max, keep anchors hit by EVERY leaf, score =
    sum over leaves — intersect_hits_score (set_op.rs:368-448) as one fused
    program."""
    a, s, slot = _gather_postings(
        offsets, anchors, scores01, term_ids, term_scores, capacity, num_docs,
        win=win, term_slots=term_slots, packed=packed,
    )
    plane = slot * (num_docs + 1) + a
    per_slot = jax.ops.segment_max(
        s, plane, num_segments=num_slots * (num_docs + 1)
    ).reshape(num_slots, num_docs + 1)[:, :num_docs]
    per_slot = jnp.where(jnp.isfinite(per_slot), per_slot, 0.0)
    all_hit = jnp.all(per_slot > 0, axis=0)
    dense = jnp.where(all_hit, jnp.sum(per_slot, axis=0), 0.0)
    ids, scores = topk_dense_exact(dense, k)
    num_hits = jnp.sum(dense > 0, dtype=jnp.int32)
    return ids, scores, num_hits
