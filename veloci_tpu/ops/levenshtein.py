"""Batched Levenshtein sweep over the packed term dictionary.

The reference intersects a Levenshtein DFA with its FST
(src/search/search_field.rs:54-99) and falls back to a full DP distance for
scoring (:705-732 `distance`). Here both collapse into ONE batched DP
sweep: the query is compared against *all* terms simultaneously as a
vectorised edit-distance DP over the padded ``[N, L]`` char matrix.

Row update trick: the classic DP row recurrence

    new[j] = min(new[j-1] + 1, old[j] + 1, old[j-1] + subst_cost)

has a sequential dependency through ``new[j-1]``; it is equivalent to

    base[j] = min(old[j] + 1, old[j-1] + cost)        (j >= 1), base[0] = i
    new[j]  = j + cummin_{k<=j}(base[k] - k)

and ``cummin`` is an associative scan — so each query character costs
O(log L) vector ops over the whole dictionary instead of O(L) sequential
steps. Total cost: ``MAX_QUERY * log2(L+1)`` fused elementwise passes over an
``[N, L+1]`` i32 array. This is the plain XLA version; on a GPU the
banded kernel (ops/pallas_levenshtein.py) serves every match within
distance 4.

Outputs per term:
* ``dist`` — true char-level Levenshtein distance (the scoring distance used
  by `get_default_score_for_distance`, search_field.rs:27-33),
* ``prefix_dist`` — min distance of the query against any term prefix (the
  ``starts_with()`` automaton semantics),
* ``is_prefix`` — whether the term starts with the query (the
  ``prefix_matches`` score-boost flag, search_field.rs:305-312).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["levenshtein_sweep", "MAX_QUERY_CHARS", "encode_query"]

MAX_QUERY_CHARS = 32
_BIG = np.int32(1 << 20)


def encode_query(query: str) -> tuple[np.ndarray, int]:
    """Query string -> padded uint16 codepoint vector + length."""
    q = np.zeros(MAX_QUERY_CHARS, dtype=np.uint16)
    n = min(len(query), MAX_QUERY_CHARS)
    for i, ch in enumerate(query[:n]):
        cp = ord(ch)
        q[i] = cp if cp <= 0xFFFF else 0xFFFD
    return q, n


@partial(jax.jit, donate_argnums=())
def levenshtein_sweep(
    term_chars: jax.Array,  # [N, L] uint16, 0-padded
    term_lens: jax.Array,  # [N] int32 (0 => masked/absent)
    query: jax.Array,  # [MAX_QUERY_CHARS] uint16
    query_len: jax.Array,  # scalar int32
):
    n, l = term_chars.shape
    js = jnp.arange(l + 1, dtype=jnp.int32)  # [L+1]

    # D[i=0][j] = j
    row0 = jnp.broadcast_to(js, (n, l + 1)).astype(jnp.int32)

    def step(row, i):
        qc = query[i].astype(jnp.int32)
        active = i < query_len
        cost = (term_chars.astype(jnp.int32) != qc).astype(jnp.int32)  # [N, L]
        sub = jnp.concatenate(
            [jnp.full((n, 1), _BIG, dtype=jnp.int32), row[:, :-1] + cost], axis=1
        )
        base = jnp.minimum(row + 1, sub)
        base = base.at[:, 0].set(i + 1)
        # new[j] = j + cummin(base - j)
        carried = jax.lax.associative_scan(jnp.minimum, base - js[None, :], axis=1)
        new_row = carried + js[None, :]
        return jnp.where(active, new_row, row), None

    row, _ = jax.lax.scan(step, row0, jnp.arange(MAX_QUERY_CHARS, dtype=jnp.int32))

    # distance at j = term_len
    dist = jnp.take_along_axis(row, term_lens[:, None].astype(jnp.int32), axis=1)[:, 0]
    # min distance over prefixes j <= term_len (starts_with automaton)
    masked = jnp.where(js[None, :] <= term_lens[:, None], row, _BIG)
    prefix_dist = jnp.min(masked, axis=1)
    # term starts with query?
    pos = jnp.arange(l, dtype=jnp.int32)
    qfull = jnp.broadcast_to(query[:l].astype(jnp.int32), (n, l))
    eq = (term_chars.astype(jnp.int32) == qfull) | (pos[None, :] >= query_len)
    is_prefix = jnp.all(eq, axis=1) & (term_lens >= query_len)
    valid = term_lens > 0
    return (
        jnp.where(valid, dist, _BIG),
        jnp.where(valid, prefix_dist, _BIG),
        is_prefix & valid,
    )


@partial(jax.jit, static_argnames=("max_matches",))
def select_matches(
    dist: jax.Array,  # [N] int32 distances (precomputed sweep)
    is_prefix: jax.Array,  # [N] bool
    crit: jax.Array,  # [N] int32 matching criterion (dist or prefix_dist)
    distance: jax.Array,  # scalar int32
    max_matches: int,
    remap=None,  # [N] int32 row -> term id (compact sweep matrix) | None
):
    """Top-M match selection from precomputed sweep outputs (device-side).

    Uses the two-stage block selection (ops/topk.topk_positions) instead of
    a flat `lax.top_k` over the whole dictionary."""
    from .topk import topk_positions

    match = crit <= distance
    total = jnp.sum(match, dtype=jnp.int32)
    key = jnp.where(match, dist, _BIG)
    sel_ids, neg = topk_positions(-key.astype(jnp.float32), max_matches)
    sel_match = jnp.isfinite(neg) & (-neg < _BIG)
    safe = jnp.where(sel_match, sel_ids, 0)
    sel_dist = jnp.where(sel_match, dist[safe], _BIG)
    sel_prefix = jnp.where(sel_match, is_prefix[safe], False)
    if remap is not None:
        sel_ids = jnp.where(sel_match, remap[safe], -1)
    else:
        sel_ids = jnp.where(sel_match, sel_ids, -1)
    return sel_ids, sel_dist, sel_prefix, total


@partial(jax.jit, static_argnames=("max_matches",))
def sweep_select(
    term_chars: jax.Array,  # [N, L] uint16
    term_lens: jax.Array,  # [N] int32
    query: jax.Array,  # [MAX_QUERY_CHARS] uint16
    query_len: jax.Array,  # scalar int32
    distance: jax.Array,  # scalar int32
    use_prefix_criterion: jax.Array,  # scalar bool (starts_with matching)
    max_matches: int,
    remap=None,
):
    """Sweep + ON-DEVICE match selection: only the best ``max_matches``
    matched terms (by distance) come back to the host — O(M) transfer
    instead of O(N).

    Returns (sel_ids [M] (-1 pad), sel_dist [M], sel_prefix [M] bool,
    total_matches scalar).
    """
    dist, prefix_dist, is_prefix = levenshtein_sweep(
        term_chars, term_lens, query, query_len
    )
    crit = jnp.where(use_prefix_criterion, prefix_dist, dist)
    return select_matches(dist, is_prefix, crit, distance, max_matches, remap=remap)


def levenshtein_distance_host(a: str, b: str) -> int:
    """Plain char-level Levenshtein (reference search_field.rs:705-732)."""
    if len(a) >= 255 or len(b) >= 255:
        return 255
    prev = list(range(len(a) + 1))
    for x, cb in enumerate(b):
        cur = [x + 1] + [0] * len(a)
        for y, ca in enumerate(a):
            cur[y + 1] = min(prev[y + 1] + 1, cur[y] + 1, prev[y] + (ca != cb))
        prev = cur
    return prev[len(a)]


def levenshtein_prefix_distance_host(query: str, candidate: str) -> int:
    """min over candidate prefixes P of lev(query, P) — starts_with() semantics."""
    # row over query positions; iterate candidate chars, track the minimum of
    # the final query row across all candidate prefixes
    prev = list(range(len(query) + 1))
    best = prev[-1]
    for x, cc in enumerate(candidate):
        cur = [x + 1] + [0] * len(query)
        for y, qc in enumerate(query):
            cur[y + 1] = min(prev[y + 1] + 1, cur[y] + 1, prev[y] + (qc != cc))
        prev = cur
        best = min(best, prev[-1])
    return best
