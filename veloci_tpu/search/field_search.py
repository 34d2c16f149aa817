"""Field-level term matching: exact / prefix / fuzzy / regex.

Device replacement for `get_term_ids_in_field`
(reference src/search/search_field.rs:277-398):

* exact & prefix (lev 0) — O(log N) binary search over the packed sorted
  dictionary (case-insensitive via the lowercase permutation),
* fuzzy (lev 1..4) — batched Levenshtein DP sweep on device
  (:mod:`veloci_tpu.ops.levenshtein`), replacing the FST × DFA product walk,
* regex — host regex over the term list (the reference intersects a dense
  regex DFA with the FST, search_field.rs:72-83).

Scoring: `get_default_score_for_distance` (search_field.rs:27-33) — the
distance is the TRUE char-level Levenshtein distance between the lowercased
candidate and query (the reference's `distance_dfa` resolves to it either via
the DFA or the DP fallback, :692-732).
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

import numpy as np

from ..create import TEXTINDEX, TOKEN_VALUES, BOOST_VALID_TO_VALUE
from ..ops.levenshtein import (
    MAX_QUERY_CHARS,
    encode_query,
    levenshtein_distance_host,
    levenshtein_prefix_distance_host,
)
from .result import FieldSearchResult

__all__ = [
    "get_term_ids_in_field",
    "get_default_score_for_distance",
    "prefetch_fuzzy_matches",
]

_F32 = np.float32

# The banded sweep kernel's ONLY row-count shape (see prefetch_fuzzy_matches
# and precompile_fuzzy_sweep): every batch pads its query axis to this, so
# each dictionary width compiles exactly one kernel.
BANDED_ROWS = 64


def get_default_score_for_distance(distance, prefix_matches):
    """Reference search_field.rs:27-33 (f32 arithmetic)."""
    distance = np.asarray(distance, dtype=_F32)
    with_prefix = _F32(2.0) / (np.log2(distance + _F32(1.0)) + _F32(0.2))
    without = _F32(2.0) / (distance + _F32(0.2))
    return np.where(prefix_matches, with_prefix, without).astype(_F32)


def _fuzzy_match_cache(persistence) -> dict:
    """Per-persistence memo of device fuzzy-match results keyed by
    (field, lower_term, distance, starts_with). Filled individually by
    :func:`_match_fuzzy_device` and in bulk by
    :func:`prefetch_fuzzy_matches` (the batched sweep — one dispatch per
    field per batch instead of one per leaf)."""
    memo = getattr(persistence, "_fuzzy_match_memo", None)
    if memo is None:
        memo = persistence._fuzzy_match_memo = {}
    return memo


def _long_term_extras(dictionary, lower_term, distance, starts_with):
    """Host fallback rows for terms longer than the sweep char matrix.

    Length pruning: lev(a, b) >= |len(a) - len(b)|, so a query shorter than
    (MIN_LONG_LEN - distance) can NEVER match a long term — corpora with
    untokenized text entries carry tens of thousands of >32-char dictionary
    terms, and without this guard every fuzzy query paid a host DP loop
    over all of them (observed: 56k long terms on the bench corpus).
    starts_with compares against term PREFIXES and is exempt."""
    from ..indices import MAX_TERM_CHARS

    if not starts_with and len(lower_term) + distance <= MAX_TERM_CHARS:
        return [], [], []
    extra_ids, extra_d, extra_p = [], [], []
    for tid in dictionary.long_term_ids():
        lo = dictionary.terms[tid].lower()
        d = (
            levenshtein_prefix_distance_host(lower_term, lo)
            if starts_with
            else levenshtein_distance_host(lower_term, lo)
        )
        if d <= distance:
            extra_ids.append(tid)
            extra_d.append(levenshtein_distance_host(lower_term, lo))
            extra_p.append(lo.startswith(lower_term))
    return extra_ids, extra_d, extra_p


def _postprocess_matches(
    dictionary, n, sel_ids, sel_dist, sel_prefix, lower_term, distance,
    starts_with,
):
    """Shared tail of the single and batched sweep paths: drop pad rows,
    sort by term id, append long-term host fallbacks."""
    sel_ids = np.asarray(sel_ids)
    keep = (sel_ids >= 0) & (sel_ids < n)
    matched = sel_ids[keep].astype(np.int64)
    dists = np.asarray(sel_dist)[keep].astype(np.int64)
    prefixes = np.asarray(sel_prefix)[keep]
    if dictionary.long_term_ids():
        extra_ids, extra_d, extra_p = _long_term_extras(
            dictionary, lower_term, distance, starts_with
        )
        if extra_ids:
            matched = np.concatenate([matched, np.asarray(extra_ids, np.int64)])
            dists = np.concatenate([dists, np.asarray(extra_d, np.int64)])
            prefixes = np.concatenate([prefixes, np.asarray(extra_p, bool)])
    order = np.argsort(matched, kind="stable")
    return matched[order], dists[order], prefixes[order]


def prefetch_fuzzy_matches(persistence, specs) -> None:
    """Batched fuzzy term matching for a request batch.

    ``specs`` is an iterable of (field, lower_term, distance, starts_with).
    Distinct uncached specs group by field and run through ONE batched sweep
    + on-device selection per field, with ONE host sync for all fields —
    the per-leaf dispatch + device-to-host sync that
    made generator-shaped queries (auto-levenshtein leaves,
    query_generator.rs:85-99) miss the batched serving paths amortises over
    the whole batch. Results land in the same memo
    :func:`_match_fuzzy_device` reads, so the memoized field searches that
    follow are cache hits."""
    import jax
    import jax.numpy as jnp

    from ..ops.levenshtein import levenshtein_sweep, select_matches
    from ..ops.pallas_levenshtein import banded_sweep, use_banded_kernel

    memo = _fuzzy_match_cache(persistence)
    if getattr(persistence, "mesh_ctx", None) is not None:
        # mesh: each match runs as its own sharded sweep (term-sharded
        # dictionary + all-gather); results land in the same memo
        for spec in set(specs):
            if spec not in memo and len(spec[1]) <= MAX_QUERY_CHARS - 1:
                _match_fuzzy_device(persistence, *spec)
        return
    by_field: Dict[str, list] = {}
    singles = []
    for field, lower_term, distance, starts_with in set(specs):
        key = (field, lower_term, distance, starts_with)
        if key in memo:
            continue
        if starts_with or len(lower_term) > MAX_QUERY_CHARS - 1:
            singles.append(key)  # prefix criterion / long query: solo path
            continue
        # lev(a,b) >= |len(a)-len(b)|: group per length-window sweep
        # variant (rounded windows -> a handful of cached variants; falls
        # back to the short/full matrix when a window wouldn't pay)
        v = persistence.device_field(field).length_window_variant(
            len(lower_term) - distance, len(lower_term) + distance
        )
        by_field.setdefault((field, id(v)), (v, []))[1].append(
            (lower_term, distance)
        )

    max_matches = 256
    pending = []  # (field, dev variant, items, device outputs)
    for (field, _vid), (dev, items) in by_field.items():
        n = dev.num_terms
        if n == 0 or dev.chars.shape[0] == 0:
            for lower_term, distance in items:
                e = np.empty(0, np.int64)
                memo[(field, lower_term, distance, False)] = (
                    e, np.empty(0, np.int64), np.empty(0, bool),
                )
            continue
        mm = min(max_matches, dev.chars.shape[0])
        use_banded = use_banded_kernel(max(d for _t, d in items))
        # the XLA sweep's DP state is [chunk, N, 33] i32 — chunk so it stays
        # within a fixed device-memory budget at multi-million-term
        # dictionaries. The kernel keeps its DP state in registers; its
        # chunks PAD to exactly BANDED_ROWS rows (pad rows carry distance
        # -1 -> zero matches) so each dictionary width compiles one shape
        n_pad = dev.chars.shape[0]
        chunk_q = (
            BANDED_ROWS
            if use_banded
            else max(1, int(512e6 // max(n_pad * 4 * 3, 1)))
        )
        for cbase in range(0, len(items), chunk_q):
            citems = items[cbase : cbase + chunk_q]
            if use_banded:
                rows_n = BANDED_ROWS
            else:
                rows_n = 8
                while rows_n < len(citems):
                    rows_n *= 2  # pow2 row buckets: <= 4 compile shapes
            queries = np.zeros((rows_n, MAX_QUERY_CHARS), dtype=np.uint16)
            qlens = np.zeros(rows_n, dtype=np.int32)
            dists_in = np.full(rows_n, -1, dtype=np.int32)
            for row, (lower_term, distance) in enumerate(citems):
                q, qlen = encode_query(lower_term)
                queries[row] = q
                qlens[row] = qlen
                dists_in[row] = distance
            if use_banded:
                dist_b, ispref_b = banded_sweep(
                    dev.chars_t, dev.lengths, jnp.asarray(queries),
                    jnp.asarray(qlens),
                    band=2 if max(d for _t, d in citems) <= 2 else 4,
                )
            else:
                dist_b, _pd, ispref_b = jax.vmap(
                    lambda q, ql: levenshtein_sweep(dev.chars, dev.lengths, q, ql)
                )(jnp.asarray(queries), jnp.asarray(qlens))
            remap_j = dev.sweep_ids
            out = jax.vmap(
                lambda d, p, dd: select_matches(
                    d, p, d, dd, max_matches=mm, remap=remap_j
                )
            )(dist_b, ispref_b, jnp.asarray(dists_in))
            pending.append((field, dev, citems, out))

    if pending:
        fetched = jax.device_get([p[3] for p in pending])  # ONE sync
        for (field, dev, items, _), (ids_b, dist_b, pref_b, total_b) in zip(
            pending, fetched
        ):
            dictionary = persistence.get_dictionary(field)
            for row, (lower_term, distance) in enumerate(items):
                if int(total_b[row]) > min(max_matches, dev.chars.shape[0]):
                    continue  # overflow: solo path re-runs with a grown window
                memo[(field, lower_term, distance, False)] = (
                    _postprocess_matches(
                        dictionary, dev.num_terms, ids_b[row], dist_b[row],
                        pref_b[row], lower_term, distance, False,
                    )
                )

    for field, lower_term, distance, starts_with in singles:
        if len(lower_term) > MAX_QUERY_CHARS - 1:
            continue  # host loop in get_term_ids_in_field handles these
        _match_fuzzy_device(persistence, field, lower_term, distance, starts_with)

    if len(memo) > 8192:
        memo.clear()


def precompile_fuzzy_sweep(dev_variant, band: int = 2):
    """Force-compile the banded sweep + selection for ONE dictionary
    variant's shape, returning the pending device outputs (caller batches
    the sync), so first serve does not pay the compile inline. No-op where
    the sweep takes the XLA route (it compiles in seconds). Matches
    prefetch_fuzzy_matches' serve-time shapes exactly: [BANDED_ROWS,
    MAX_QUERY_CHARS] queries over the variant's padded term axis,
    selection at min(256, width)."""
    import jax
    import jax.numpy as jnp

    from ..ops.levenshtein import select_matches
    from ..ops.pallas_levenshtein import banded_sweep, use_banded_kernel

    if not use_banded_kernel(band) or dev_variant.chars.shape[0] == 0:
        return None
    queries = np.zeros((BANDED_ROWS, MAX_QUERY_CHARS), dtype=np.uint16)
    queries[:, :3] = np.uint16(ord("a"))
    qlens = np.full(BANDED_ROWS, 3, dtype=np.int32)
    dists = np.full(BANDED_ROWS, -1, dtype=np.int32)  # pad rows: no matches
    dist_b, ispref_b = banded_sweep(
        dev_variant.chars_t, dev_variant.lengths, jnp.asarray(queries),
        jnp.asarray(qlens), band=band,
    )
    mm = min(256, dev_variant.chars.shape[0])
    remap_j = dev_variant.sweep_ids
    return jax.vmap(
        lambda d, p, dd: select_matches(
            d, p, d, dd, max_matches=mm, remap=remap_j
        )
    )(dist_b, ispref_b, jnp.asarray(dists))


def _match_fuzzy_device(persistence, field, lower_term, distance, starts_with):
    """Run the device sweep with ON-DEVICE match selection.

    Only the matched terms transfer to the host (O(matches), not O(dict)).
    Returns (matched_ids sorted asc, distances, is_prefix) — aligned arrays.
    """
    memo = _fuzzy_match_cache(persistence)
    mkey = (field, lower_term, distance, starts_with)
    hit = memo.get(mkey)
    if hit is not None:
        return hit
    mc = getattr(persistence, "mesh_ctx", None)
    if mc is not None:
        # mesh serving: term-sharded sweep + all-gather (sharded_fuzzy_match)
        dictionary = persistence.get_dictionary(field)
        ids, dists, prefixes = mc.fuzzy_match(
            field, lower_term, distance, starts_with
        )
        out = _postprocess_matches(
            dictionary, len(dictionary), ids, dists, prefixes, lower_term,
            distance, starts_with,
        )
        if len(memo) > 8192:
            memo.clear()
        memo[mkey] = out
        return out
    dev = persistence.device_field(field)
    dictionary = persistence.get_dictionary(field)
    n = dev.num_terms
    if n == 0:
        e = np.empty(0, np.int64)
        return e, np.empty(0, np.int64), np.empty(0, bool)
    # lev(a,b) >= |len(a)-len(b)|: sweep only the length-window slice
    # [qlen-d, qlen+d] of the length-sorted matrix (falls back to the
    # short/full variant when the window wouldn't pay or for starts_with)
    dev = dev.length_window_variant(
        len(lower_term) - distance, len(lower_term) + distance, starts_with
    )
    q, qlen = encode_query(lower_term)
    import jax.numpy as jnp

    from ..ops.levenshtein import select_matches, sweep_select
    from ..ops.pallas_levenshtein import banded_sweep, use_banded_kernel

    # the banded kernel serves non-starts_with matching within its band;
    # starts_with scoring needs full-term distances beyond the band
    use_banded = use_banded_kernel(distance, starts_with)
    max_matches = 256
    while True:
        mm = min(max_matches, dev.chars.shape[0])
        if use_banded:
            dist_d, ispref_d = banded_sweep(
                dev.chars_t, dev.lengths, jnp.asarray(q)[None],
                jnp.full((1,), qlen, jnp.int32),
                band=2 if distance <= 2 else 4,
            )
            sel_ids, sel_dist, sel_prefix, total = select_matches(
                dist_d[0], ispref_d[0], dist_d[0], jnp.int32(distance),
                max_matches=mm, remap=dev.sweep_ids,
            )
        else:
            sel_ids, sel_dist, sel_prefix, total = sweep_select(
                dev.chars,
                dev.lengths,
                jnp.asarray(q),
                jnp.int32(qlen),
                jnp.int32(distance),
                jnp.bool_(starts_with),
                max_matches=mm,
                remap=dev.sweep_ids,
            )
        total = int(total)
        if total <= max_matches or max_matches >= dev.chars.shape[0]:
            break
        while max_matches < total:
            max_matches *= 4
    matched, dists, prefixes = _postprocess_matches(
        dictionary, n, sel_ids, sel_dist, sel_prefix, lower_term, distance,
        starts_with,
    )
    if len(memo) > 8192:
        memo.clear()
    memo[mkey] = (matched, dists, prefixes)
    return matched, dists, prefixes


def get_term_ids_in_field(
    persistence,
    request,
    *,
    get_scores: bool = True,
    get_ids: bool = False,
    store_term_id_hits: bool = False,
    store_term_texts: bool = False,
    return_term: bool = False,
    return_term_lowercase: bool = False,
) -> FieldSearchResult:
    """Match the request's term against one field's dictionary."""
    path = request.path
    if not path.endswith(TEXTINDEX):
        path = path + TEXTINDEX
    field = path[: -len(TEXTINDEX)]
    result = FieldSearchResult(path=path, request=request)
    dictionary = persistence.get_dictionary(field)

    term = request.terms[0]
    lower_term = term.lower()
    ignore_case = request.ignore_case if request.ignore_case is not None else True
    distance = request.levenshtein_distance
    if distance is not None:
        # clamp to term length - 1 (search_field.rs:285-287)
        distance = min(distance, max(len(lower_term) - 1, 0))
    distance = distance or 0

    matched: np.ndarray
    aligned_dists: Optional[np.ndarray] = None  # per-matched distances
    aligned_prefixes: Optional[np.ndarray] = None

    if request.is_regex:
        matched = _match_regex(
            persistence, field, dictionary, term, ignore_case,
            bool(request.starts_with),
        )
    elif distance == 0 and not request.starts_with:
        if ignore_case:
            ids = dictionary.get_ignore_case(term)
        else:
            tid = dictionary.get(term)
            ids = [tid] if tid is not None else []
        matched = np.array(sorted(ids), dtype=np.int64)
    elif distance == 0 and request.starts_with:
        matched = dictionary.prefix_range_ids(term, ignore_case=ignore_case)
    else:
        if len(lower_term) > MAX_QUERY_CHARS - 1:
            # very long query: host loop
            crit_ids, crit_d, crit_p = [], [], []
            for i, t in enumerate(dictionary.terms):
                lo = t.lower()
                d = levenshtein_distance_host(lower_term, lo)
                is_p = lo.startswith(lower_term)
                if d <= distance or (request.starts_with and is_p):
                    crit_ids.append(i)
                    crit_d.append(d)
                    crit_p.append(is_p)
            matched = np.array(crit_ids, dtype=np.int64)
            aligned_dists = np.array(crit_d, dtype=np.int64)
            aligned_prefixes = np.array(crit_p, dtype=bool)
        else:
            matched, aligned_dists, aligned_prefixes = _match_fuzzy_device(
                persistence, field, lower_term, distance, request.starts_with
            )
        if not ignore_case:
            # case-sensitive verification on the candidate set
            keep = np.array(
                [
                    levenshtein_distance_host(term, dictionary.terms[int(tid)])
                    <= distance
                    for tid in matched
                ],
                dtype=bool,
            )
            matched = matched[keep]
            aligned_dists = aligned_dists[keep]
            aligned_prefixes = aligned_prefixes[keep]

    if get_ids:
        result.hits_ids = matched.copy()

    if get_scores and len(matched):
        should_check_prefix = request.starts_with or distance != 0
        if aligned_dists is not None:
            distances = aligned_dists
            prefix_matches = aligned_prefixes & should_check_prefix
        elif distance == 0 and request.starts_with and not request.is_regex:
            # prefix-range path, vectorised: every matched term starts with
            # the query by construction, so distance = |candidate| - |query|
            distances = (
                dictionary.char_lengths()[matched].astype(np.int64)
                - len(lower_term)
            )
            prefix_matches = np.full(len(matched), should_check_prefix)
        else:
            # exact / regex path: distance = |candidate| - |query| when
            # the candidate starts with the query, else true distance
            distances = np.empty(len(matched), dtype=np.int64)
            prefix_matches = np.zeros(len(matched), dtype=bool)
            for i, tid in enumerate(matched):
                lo = dictionary.terms[int(tid)].lower()
                if lo.startswith(lower_term):
                    distances[i] = len(lo) - len(lower_term)
                    prefix_matches[i] = should_check_prefix
                else:
                    distances[i] = levenshtein_distance_host(lower_term, lo)
        scores = get_default_score_for_distance(distances, prefix_matches)
        if request.boost is not None:
            scores = (scores * _F32(request.boost)).astype(_F32)
        result.term_ids = matched
        result.term_scores = scores

        # top-n pruning happens when the request itself has `top`
        # (search_field.rs:379-383) — sort by score desc, truncate
        if request.top is not None:
            top_n = request.top + (request.skip or 0)
            order = np.argsort(-scores.astype(np.float64), kind="stable")[:top_n]
            order = np.sort(order)
            result.term_ids = matched[order]
            result.term_scores = scores[order]

    if return_term or store_term_texts:
        # only the SURVIVING ids need their strings (top-n pruning above can
        # shrink thousands of prefix matches to `top`)
        keep = (
            result.term_ids
            if get_scores and result.term_ids is not None
            else matched
        )
        for tid in keep:
            t = dictionary.terms[int(tid)]
            result.terms[int(tid)] = t.lower() if return_term_lowercase else t

    if store_term_id_hits and len(result.term_ids):
        result.term_id_hits_in_field[path] = {
            request.terms[0]: [int(t) for t in result.term_ids]
        }
    if store_term_texts and result.terms:
        result.term_text_in_field[path] = list(result.terms.values())

    # token_value boost (search_field.rs:391-395): per-token boost column
    _apply_token_value_boost(persistence, request, result)
    return result


def _match_regex(
    persistence, field: str, dictionary, term: str, ignore_case: bool,
    starts_with: bool,
) -> np.ndarray:
    """Regex term matching: device DFA sweep as the O(N) prefilter, host
    verification of the (small) candidate set for bit-exact `re` parity.

    Device replacement for the reference's regex-DFA x FST intersection
    (search_field.rs:72-83): the pattern compiles to a class-alphabet DFA on
    the host and sweeps the dictionary char matrix as one-hot matmuls
    (ops/regex_dfa.py). The char matrix is lowercase, so the device runs a
    CASE-FOLDED DFA — a superset of any case-sensitive match — and the host
    re-verifies candidates plus the rows the matrix cannot represent (terms
    > 32 chars, the empty term). VELOCI_REGEX_DEVICE=0 disables, =1 forces.
    """
    import os as _os

    flags = re.IGNORECASE if ignore_case else 0
    try:
        pattern = re.compile(term, flags)
    except re.error:
        pattern = re.compile(re.escape(term), flags)
    fn = pattern.match if starts_with else pattern.fullmatch

    knob = _os.environ.get("VELOCI_REGEX_DEVICE", "")
    use_device = knob != "0" and (knob == "1" or len(dictionary) >= 512)
    if use_device and not any(ord(c) > 127 for c in term):
        from ..ops.regex_dfa import compile_dfa, regex_match_device

        dfa = compile_dfa(term, ignore_case=True)  # folded superset
        if dfa is not None:
            dev = persistence.device_field(field)
            m = np.asarray(
                regex_match_device(
                    dev.chars, dev.lengths, dfa, prefix=starts_with
                )
            )
            cand = _rows_to_term_ids(dev, np.flatnonzero(m), len(dictionary))
            extra = list(dictionary.long_term_ids())
            empty_id = dictionary.get("")
            if empty_id is not None:
                extra.append(empty_id)
            if extra:
                cand = np.unique(
                    np.concatenate([cand, np.asarray(extra, dtype=np.int64)])
                )
            return np.array(
                [i for i in cand if fn(dictionary.terms[int(i)])],
                dtype=np.int64,
            )
    return np.array(
        [i for i, t in enumerate(dictionary.terms) if fn(t)], dtype=np.int64
    )


def _rows_to_term_ids(dev, rows: np.ndarray, num_terms: int) -> np.ndarray:
    """Sweep-matrix rows -> dictionary term ids. The matrix is compact (no
    long or empty terms), so row r is term ``sweep_ids[r]``, not term r."""
    ids = dev._sweep_ids_host
    if ids is not None:
        rows = np.asarray(ids)[rows]
    return rows[(rows >= 0) & (rows < num_terms)].astype(np.int64)


def _apply_token_value_boost(persistence, request, result) -> None:
    if request.token_value is not None and len(result.term_ids):
        tv = request.token_value
        boost_path = tv.path
        if not boost_path.endswith(TOKEN_VALUES):
            boost_path = boost_path + TEXTINDEX + TOKEN_VALUES
        boost_path = boost_path + BOOST_VALID_TO_VALUE
        try:
            vals, present = persistence.get_boost(boost_path)
        except Exception:
            vals, present = None, None
        if vals is not None:
            from .boost import apply_boost_scalar

            scores = result.term_scores.copy()
            for i, tid in enumerate(result.term_ids):
                t = int(tid)
                if t < len(vals) and present[t]:
                    scores[i] = apply_boost_scalar(
                        scores[i], float(vals[t]), tv
                    )
            result.term_scores = scores


def resolve_token_hits_to_text_id(
    persistence, request, result, add_snippets: bool = False
):
    """Token-level hits -> text-id-level hits, optionally with snippets.

    Reference: resolve_token_hits_to_text_id (search_field.rs:519-608):
    each matched token maps to the text ids containing it via
    ``.tokens_to_text_id``; per text id the max token score wins; with
    ``add_snippets`` the text is reconstructed + highlighted from its token
    ids.
    """
    from ..create import TOKENS_TO_TEXT_ID
    from ..query.request import DEFAULT_SNIPPET_INFO
    from .highlight import highlight_document

    path = result.path
    field = path[: -len(TEXTINDEX)]
    if not persistence.tokenize_enabled(field):
        return result
    tta = persistence.key_value_stores.get(path + TOKENS_TO_TEXT_ID)
    if tta is None:
        return result

    token_hits = []  # (text_id, score, token_id)
    for tid, score in zip(result.term_ids, result.term_scores):
        parents = tta.get_values(int(tid))
        for p in parents:
            token_hits.append((int(p), float(score), int(tid)))
    token_hits.sort(key=lambda el: el[0])

    if token_hits:
        new_ids = []
        new_scores = []
        if add_snippets:
            pass  # only text-level hits remain (reference clears hits_scores)
        i = 0
        while i < len(token_hits):
            j = i
            group_tokens = []
            best = None
            text_id = token_hits[i][0]
            while j < len(token_hits) and token_hits[j][0] == text_id:
                _t, sc, tok = token_hits[j]
                if best is None or abs(sc) > abs(best):
                    best = sc
                group_tokens.append(tok)
                j += 1
            new_ids.append(text_id)
            new_scores.append(best)
            if add_snippets:
                snippet_info = request.snippet_info or DEFAULT_SNIPPET_INFO
                highlighted = highlight_document(
                    persistence, path, text_id, group_tokens, snippet_info
                )
                if highlighted is not None:
                    result.highlight[text_id] = highlighted
            i = j
        result.term_ids = np.asarray(new_ids, dtype=np.int64)
        result.term_scores = np.asarray(new_scores, dtype=_F32)
    return result


def highlight_field(persistence, request):
    """Field-level snippet search (reference search_field.rs:233-245
    `highlight`): returns [(snippet_text, score, id)] sorted by score."""
    from ..utils import normalize_text

    request.terms = [normalize_text(t) for t in request.terms]
    result = get_term_ids_in_field(persistence, request, get_scores=True)
    resolve_token_hits_to_text_id(persistence, request, result, add_snippets=True)
    out = []
    for tid, score in zip(result.term_ids, result.term_scores):
        text = result.highlight.get(int(tid))
        if text is not None:
            out.append((text, float(score), int(tid)))
    out.sort(key=lambda el: -el[1])
    skip = request.skip or 0
    out = out[skip:]
    if request.top is not None:
        out = out[: request.top]
    return out
