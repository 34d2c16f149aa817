"""Fully-fused fuzzy search step: Levenshtein sweep -> term select ->
posting resolve -> top-k, in ONE XLA program (no host round trip). Returns
(ids, scores, num_hits, total_matches); callers fall back to the generic
path when total_matches exceeds the static ``max_terms`` selection window.

This is the device replacement for the reference's FST x Levenshtein-DFA
product walk followed by posting iteration (search_field.rs:277-504): the
query is swept against the whole packed dictionary, the best ``max_terms``
matches are selected on-device with `top_k`, and their postings resolve into
the dense score plane.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .levenshtein import MAX_QUERY_CHARS
from .topk import topk_dense_exact

_BIG = 1 << 20

__all__ = [
    "fuzzy_search_topk",
    "fuzzy_search_topk_banded",
    "batched_fuzzy_search_topk",
]


def _sweep(term_chars, term_lens, query, query_len):
    n, l = term_chars.shape
    js = jnp.arange(l + 1, dtype=jnp.int32)
    row0 = jnp.broadcast_to(js, (n, l + 1)).astype(jnp.int32)

    def step(row, i):
        qc = query[i].astype(jnp.int32)
        active = i < query_len
        cost = (term_chars.astype(jnp.int32) != qc).astype(jnp.int32)
        sub = jnp.concatenate(
            [jnp.full((n, 1), _BIG, dtype=jnp.int32), row[:, :-1] + cost], axis=1
        )
        base = jnp.minimum(row + 1, sub)
        base = base.at[:, 0].set(i + 1)
        carried = jax.lax.associative_scan(jnp.minimum, base - js[None, :], axis=1)
        new_row = carried + js[None, :]
        return jnp.where(active, new_row, row), None

    row, _ = jax.lax.scan(step, row0, jnp.arange(MAX_QUERY_CHARS, dtype=jnp.int32))
    dist = jnp.take_along_axis(row, term_lens[:, None].astype(jnp.int32), axis=1)[:, 0]
    pos = jnp.arange(l, dtype=jnp.int32)
    qfull = jnp.broadcast_to(query[:l].astype(jnp.int32), (n, l))
    eq = (term_chars.astype(jnp.int32) == qfull) | (pos[None, :] >= query_len)
    is_prefix = jnp.all(eq, axis=1) & (term_lens >= query_len)
    valid = term_lens > 0
    return jnp.where(valid, dist, _BIG), is_prefix & valid


def _select_resolve_sorted(
    dist, is_prefix, distance, offsets, anchors, scores01,
    max_terms, capacity, num_docs, packed=None, sweep_ids=None,
):
    """Shared tail: match -> term score -> on-device select -> resolve ->
    sorted-run candidates. `dist` may come from the XLA sweep or the banded
    sweep kernel.

    Replaces a dense-plane `segment_max` (a scatter into ``[num_docs]`` +
    a full-corpus top-k): the gathered
    postings sort ONCE by (anchor desc, score desc) — a vectorised bitonic
    network over ``[capacity]`` — and each anchor's first row IS its
    dedup-max (resolve_token_to_anchor's sort+dedup, search_field.rs:451-465).
    Cost is O(capacity), independent of corpus size.

    Returns (a_s, final, total_matches, total_postings): anchors in
    descending order and the per-anchor max score at each anchor's first
    position (0 elsewhere). Results are only valid when total_matches <=
    max_terms AND total_postings <= capacity — `capacity` is OPTIMISTIC
    (the static worst case, sum of the max_terms largest runs, is absurd
    for typical fuzzy matches); callers re-dispatch on overflow."""
    match = dist <= distance
    total_matches = jnp.sum(match, dtype=jnp.int32)

    # term-level score (get_default_score_for_distance, search_field.rs:27-33)
    df = dist.astype(jnp.float32)
    prefix_score = 2.0 / (jnp.log2(df + 1.0) + 0.2)
    plain_score = 2.0 / (df + 0.2)
    score = jnp.where(is_prefix, prefix_score, plain_score)
    masked = jnp.where(match, score, -jnp.inf)

    # select best max_terms matched terms on-device. The two-stage block
    # selection (ops/topk.topk_positions) replaces a flat
    # `lax.top_k(masked, 256)`; the block pass is one streaming max + a
    # small top_k
    from .topk import topk_positions

    sel_ids, sel_scores = topk_positions(masked, max_terms)
    sel_valid = jnp.isfinite(sel_scores)
    num_keys = offsets.shape[0] - 2
    if sweep_ids is not None:
        # compact sweep matrix: map row indices back to term ids (pad -1)
        sel_ids = sweep_ids[jnp.where(sel_valid, sel_ids, 0)]
    term_ids = jnp.where(
        sel_valid & (sel_ids >= 0) & (sel_ids < num_keys), sel_ids, -1
    ).astype(jnp.int32)
    term_scores = jnp.where(sel_valid, sel_scores, 0.0).astype(jnp.float32)

    # resolve postings. Segment mapping via scatter+cumsum fills
    # (ops/postings.py) instead of searchsorted + small-table gathers
    from .postings import fill_segments_f32, fill_segments_i32

    t_pad = max_terms
    valid = term_ids >= 0
    safe = jnp.where(valid, term_ids, 0)
    starts = jnp.where(valid, offsets[safe], 0)
    counts = jnp.where(valid, offsets[safe + 1] - starts, 0)
    out_starts = jnp.cumsum(counts, dtype=jnp.int32) - counts  # exclusive
    total = out_starts[t_pad - 1] + counts[t_pad - 1]
    total_postings = total
    idx = jnp.arange(capacity, dtype=jnp.int32)
    # src = idx + (start(seg) - out_start(seg)); term score filled per slot
    src = idx + fill_segments_i32(starts - out_starts, out_starts, capacity)
    tsc_fill = fill_segments_f32(term_scores, out_starts, capacity)
    in_range = idx < total
    if packed is not None:
        # interleaved [nnz, 2] rows: ONE 8-byte gather per posting
        src = jnp.clip(jnp.where(in_range, src, 0), 0, packed.shape[0] - 1)
        rows = packed[src]
        a = jnp.where(in_range, rows[:, 0], num_docs)
        s01 = jax.lax.bitcast_convert_type(rows[:, 1], jnp.float32)
        s = jnp.where(in_range, s01 * tsc_fill, -jnp.inf)
    else:
        src = jnp.clip(jnp.where(in_range, src, 0), 0, anchors.shape[0] - 1)
        a = jnp.where(in_range, anchors[src], num_docs)
        s = jnp.where(in_range, scores01[src] * tsc_fill, -jnp.inf)

    # single-slot sorted-run dedup-max: sort by (anchor desc, score desc);
    # each anchor's first row carries its max
    neg_a, neg_s = jax.lax.sort(((-1 - a).astype(jnp.int32), -s), num_keys=2)
    a_s = (-1 - neg_a).astype(jnp.int32)
    s_s = -neg_s
    new_anchor = jnp.concatenate(
        [jnp.ones(1, dtype=bool), a_s[1:] != a_s[:-1]]
    )
    cand = new_anchor & (a_s >= 0) & (a_s < num_docs) & jnp.isfinite(s_s)
    final = jnp.where(cand, s_s, jnp.float32(0.0))
    return a_s, final, total_matches, total_postings


def _candidates_topk(a_s, final, k):
    """Exact (score desc, id desc) top-k over the candidate vector —
    anchors are descending, so position-asc ties ARE id-desc
    (sort_by_score_and_id, search.rs:122-130)."""
    from .topk import topk_positions

    vals = jnp.where(final > 0, final, -jnp.inf)
    pos, scores = topk_positions(vals, k)
    ids = jnp.where(scores > 0, a_s[pos], 0).astype(jnp.int32)
    return ids, scores


def _select_resolve_topk(
    dist, is_prefix, distance, offsets, anchors, scores01,
    max_terms, capacity, num_docs, k, packed=None, sweep_ids=None,
):
    """`_select_resolve_sorted` + exact top-k; returns
    (ids, scores, num_hits, total_matches, total_postings)."""
    a_s, final, total_matches, total_postings = _select_resolve_sorted(
        dist, is_prefix, distance, offsets, anchors, scores01,
        max_terms, capacity, num_docs, packed=packed, sweep_ids=sweep_ids,
    )
    ids, scores = _candidates_topk(a_s, final, k)
    num_hits = jnp.sum(final > 0, dtype=jnp.int32)
    return ids, scores, num_hits, total_matches, total_postings


@partial(
    jax.jit,
    static_argnames=("max_terms", "capacity", "num_docs", "k"),
)
def fuzzy_search_topk(
    term_chars: jax.Array,  # [N_pad, L] uint16
    term_lens: jax.Array,  # [N_pad] int32
    query: jax.Array,  # [MAX_QUERY_CHARS] uint16
    query_len: jax.Array,  # scalar int32
    distance: jax.Array,  # scalar int32 (max edit distance)
    offsets: jax.Array,  # [num_keys + 2] int32
    anchors: jax.Array,  # [nnz_pad] int32
    scores01: jax.Array,  # [nnz_pad] f32
    max_terms: int,
    capacity: int,
    num_docs: int,
    k: int,
    packed=None,
    sweep_ids=None,
):
    dist, is_prefix = _sweep(term_chars, term_lens, query, query_len)
    return _select_resolve_topk(
        dist, is_prefix, distance, offsets, anchors, scores01,
        max_terms, capacity, num_docs, k, packed=packed, sweep_ids=sweep_ids,
    )


@partial(
    jax.jit,
    static_argnames=("max_terms", "capacity", "num_docs", "k", "interpret", "band"),
)
def fuzzy_search_topk_banded(
    chars_t: jax.Array,  # [L, N_pad] uint16 (transposed char matrix)
    term_lens: jax.Array,  # [N_pad] int32
    query: jax.Array,  # [MAX_QUERY_CHARS] uint16
    query_len: jax.Array,  # scalar int32
    distance: jax.Array,  # scalar int32 (<= 4, the kernel band)
    offsets: jax.Array,
    anchors: jax.Array,
    scores01: jax.Array,
    max_terms: int,
    capacity: int,
    num_docs: int,
    k: int,
    interpret: bool = False,
    packed=None,
    sweep_ids=None,
    band: int = 4,
):
    """Fused fuzzy step over the banded sweep kernel (a batch of one):
    exact distances within the +-band diagonal with no DP state in device
    memory, then the same select/resolve/top-k tail — still ONE program.
    ``band`` must be >= the runtime distance; d<=2 callers pass band=2 for
    ~45% less DP."""
    from .pallas_levenshtein import banded_sweep

    dist, is_prefix = banded_sweep(
        chars_t, term_lens, query[None], jnp.reshape(query_len, (1,)),
        band=band, interpret=interpret,
    )
    dist, is_prefix = dist[0], is_prefix[0]
    return _select_resolve_topk(
        dist, is_prefix, distance, offsets, anchors, scores01,
        max_terms, capacity, num_docs, k, packed=packed, sweep_ids=sweep_ids,
    )


@partial(
    jax.jit,
    static_argnames=("max_terms", "capacity", "num_docs", "k", "interpret", "band"),
)
def batched_fuzzy_search_topk_banded(
    chars_t: jax.Array,  # [L, N_pad] uint16 (transposed char matrix)
    term_lens: jax.Array,  # [N_pad] int32
    queries: jax.Array,  # [Q, MAX_QUERY_CHARS] uint16
    query_lens: jax.Array,  # [Q] int32
    distances: jax.Array,  # [Q] int32 (each <= 4, the kernel band)
    offsets: jax.Array,
    anchors: jax.Array,
    scores01: jax.Array,
    max_terms: int,
    capacity: int,
    num_docs: int,
    k: int,
    interpret: bool = False,
    packed=None,
    sweep_ids=None,
    band: int = 4,
):
    """A batch of fuzzy queries through ONE banded sweep kernel + vmapped
    select/resolve/top-k tail. The DP state stays in registers instead of
    device memory. ``band`` must be >= every runtime distance in the batch;
    d<=2 batches pass band=2 (~45% less DP)."""
    from .pallas_levenshtein import banded_sweep

    dist, is_prefix = banded_sweep(
        chars_t, term_lens, queries, query_lens, band=band, interpret=interpret
    )

    def tail(d, p, dd):
        return _select_resolve_topk(
            d, p, dd, offsets, anchors, scores01,
            max_terms, capacity, num_docs, k, packed=packed,
            sweep_ids=sweep_ids,
        )

    return jax.vmap(tail)(dist, is_prefix, distances)


@partial(
    jax.jit,
    static_argnames=("max_terms", "capacity", "num_docs", "k"),
)
def batched_fuzzy_search_topk(
    term_chars: jax.Array,  # [N_pad, L] uint16
    term_lens: jax.Array,  # [N_pad] int32
    queries: jax.Array,  # [Q, MAX_QUERY_CHARS] uint16
    query_lens: jax.Array,  # [Q] int32
    distances: jax.Array,  # [Q] int32
    offsets: jax.Array,
    anchors: jax.Array,
    scores01: jax.Array,
    max_terms: int,
    capacity: int,
    num_docs: int,
    k: int,
    packed=None,
    sweep_ids=None,
):
    """A batch of fuzzy queries in ONE dispatch (vmapped fuzzy_search_topk).

    DP state is [Q, N, L+1] i32 — callers chunk the batch so it stays within
    a fixed HBM budget (see search/batch.py)."""

    def one(q, ql, d):
        return fuzzy_search_topk(
            term_chars, term_lens, q, ql, d, offsets, anchors, scores01,
            max_terms=max_terms, capacity=capacity, num_docs=num_docs, k=k,
            packed=packed, sweep_ids=sweep_ids,
        )

    return jax.vmap(one)(queries, query_lens, distances)


@partial(
    jax.jit,
    static_argnames=(
        "max_terms", "capacity", "num_docs", "k", "banded", "boost_specs",
        "interpret", "band",
    ),
)
def batched_fuzzy_generic_topk(
    chars_arg: jax.Array,  # banded: [L, N_pad] chars_t; else [N_pad, L]
    term_lens: jax.Array,  # [N_pad] int32
    queries: jax.Array,  # [Q, MAX_QUERY_CHARS] uint16
    query_lens: jax.Array,  # [Q] int32
    distances: jax.Array,  # [Q] int32
    offsets: jax.Array,
    anchors: jax.Array,
    scores01: jax.Array,
    filter_masks,  # [NF, num_docs] bool | None (cached device masks)
    filter_idx,  # [Q] int32 into filter_masks | None
    phrase_anchors,  # [Q, P_pad] int32 (pad num_docs) | None
    boost_arrays,  # tuple of (bv, pres, expr_add|None)
    facet_mats,  # tuple of M [num_docs, G_i] f32
    max_terms: int,
    capacity: int,
    num_docs: int,
    k: int,
    banded: bool,
    boost_specs=(),
    interpret: bool = False,
    packed=None,
    sweep_ids=None,
    band: int = 4,
):
    """Fuzzy queries WITH filters / boost columns / phrase factors / facets
    in ONE program — the fuzzy leg of the batched generic path (BASELINE
    config 2 crossed with configs 3-5). Same sorted-run tail as the plain
    fuzzy kernels (cost O(capacity), no dense plane); extras read at the
    candidate anchors only. Same overflow contract (re-dispatch when
    total_matches > max_terms or total_postings > capacity)."""
    from .generic_step import _precompute_boost, facet_counts
    from .tree_step import _apply_boost_gathered

    if banded:
        from .pallas_levenshtein import banded_sweep

        dist, is_prefix = banded_sweep(
            chars_arg, term_lens, queries, query_lens, band=band,
            interpret=interpret,
        )
    else:

        def one_sweep(q, ql):
            return _sweep(chars_arg, term_lens, q, ql)

        dist, is_prefix = jax.vmap(one_sweep)(queries, query_lens)

    pre_boosts = tuple(
        _precompute_boost(bv, pres, spec + (expr_add,))
        for (bv, pres, expr_add), spec in zip(boost_arrays, boost_specs)
    )

    def tail(d, p, dd, fidx, panch):
        a_s, final, total_matches, total_postings = _select_resolve_sorted(
            d, p, dd, offsets, anchors, scores01,
            max_terms, capacity, num_docs, packed=packed,
            sweep_ids=sweep_ids,
        )
        safe = jnp.clip(a_s, 0, num_docs - 1)
        if fidx is not None:
            final = jnp.where(filter_masks[fidx][safe], final, 0.0)
        for pre in pre_boosts:
            final = _apply_boost_gathered(final, a_s, pre)
        if panch is not None:
            pf = (
                jnp.ones(num_docs + 1, dtype=jnp.float32)
                .at[jnp.clip(panch, 0, num_docs)]
                .multiply(jnp.float32(5.0))
            )
            final = final * pf[safe]
        num_hits = jnp.sum(final > 0, dtype=jnp.int32)
        if facet_mats:
            hit_row = (
                jnp.zeros(num_docs + 1, dtype=jnp.float32)
                .at[jnp.where(final > 0, a_s, num_docs)]
                .add(1.0, mode="drop")[:num_docs]
            )
            fc = tuple(facet_counts(hit_row, m) for m in facet_mats)
        else:
            fc = ()
        ids, scores = _candidates_topk(a_s, final, k)
        return ids, scores, num_hits, total_matches, total_postings, fc

    in_axes = (0, 0, 0, 0 if filter_idx is not None else None,
               0 if phrase_anchors is not None else None)
    return jax.vmap(tail, in_axes=in_axes)(
        dist, is_prefix, distances, filter_idx, phrase_anchors
    )
