"""Top-level search execution: the query compiler + orchestrator.

The reference compiles a `Request` into a DAG of plan steps that exchange
`SearchFieldResult`s over crossbeam channels executed in rayon waves
(src/plan_creator/*, src/search.rs:143-228). The device execution model
replaces the channel dataflow with **dense per-document score vectors**:

* each field search resolves its matched terms into a dense ``[num_docs]``
  f32 vector on device (segment-max over the anchor-score postings),
* Union = per-term elementwise max, summed over distinct terms with the
  reference's ``distinct^2`` boost (set_op.rs:87-220),
* Intersect = all-positive mask * sum of scores (set_op.rs:368-448),
* filters = dense boolean masks (FilterResult / IntersectScoresWithIds),
* every boost family = an elementwise multiply/add on the dense vector,
* top-k = `lax.top_k` with exact (score desc, id desc) tie-break.

Field-search dedup mirrors `FieldRequestCache`
(plan_creator/execution_plan.rs:91-130).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

from ..trace import info_time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..create import TEXTINDEX
from ..error import InvalidRequestError, VelociError
from ..query.request import Request, RequestSearchPart, SearchRequest
from ..ops.postings import resolve_to_anchor_dense
from ..ops.topk import dense_to_hits
from . import boost as boost_mod
from .explain import ExplainNode, collect_explain
from .facet import get_facet
from .field_search import get_term_ids_in_field
from .highlight import highlight_on_original_document
from .read_document import read_data
from .result import DocWithHit, FieldSearchResult, Hit, SearchResult, SearchResultWithDoc
from .why_found import get_why_found

__all__ = ["search", "search_to_result_with_doc", "suggest", "explain_plan"]

_F32 = np.float32


@dataclass
class _FieldSearchFlags:
    get_scores: bool = False
    get_ids: bool = False
    store_term_id_hits: bool = False
    store_term_texts: bool = False


class _Ctx:
    def __init__(self, persistence, request: Request):
        self.persistence = persistence
        self.request = request
        self.num_docs = persistence.num_docs
        self.cache: Dict[tuple, FieldSearchResult] = {}
        self.explain = bool(request.explain)
        self.boost_log = []
        self.flags: Dict[tuple, _FieldSearchFlags] = {}
        self.parts: Dict[tuple, RequestSearchPart] = {}

    def register(self, part: RequestSearchPart, **kw) -> None:
        key = part.key()
        fl = self.flags.setdefault(key, _FieldSearchFlags())
        self.parts.setdefault(key, part)
        for k, v in kw.items():
            if v:
                setattr(fl, k, True)

    def run_field_searches(self) -> None:
        # per-persistence memo of term-match results (the reference's
        # field-level LRU, persistence.rs:66); keyed by request + flags
        memo = getattr(self.persistence, "_field_search_cache", None)
        if memo is None:
            memo = {}
            self.persistence._field_search_cache = memo
        for key, part in self.parts.items():
            fl = self.flags[key]
            mkey = (key, fl.get_scores, fl.get_ids, fl.store_term_id_hits, fl.store_term_texts)
            hit = memo.get(mkey)
            if hit is not None:
                self.cache[key] = hit
                continue
            res = get_term_ids_in_field(
                self.persistence,
                part,
                get_scores=fl.get_scores,
                get_ids=fl.get_ids,
                store_term_id_hits=fl.store_term_id_hits,
                store_term_texts=fl.store_term_texts,
            )
            if len(memo) > 4096:
                memo.clear()
            memo[mkey] = res
            self.cache[key] = res

    def result_for(self, part: RequestSearchPart) -> FieldSearchResult:
        return self.cache[part.key()]


def _collect_parts(ctx: _Ctx, request: Request) -> None:
    """Mirror collect_all_field_request_into_cache (execution_plan.rs:91-130)."""
    store_hits = request.why_found or request.text_locality
    if request.search_req is not None:
        for part in request.search_req.walk_parts():
            ctx.register(
                part,
                get_scores=True,
                store_term_id_hits=store_hits,
                store_term_texts=request.why_found,
            )
    if request.phrase_boosts:
        for pb in request.phrase_boosts:
            ctx.register(pb.search1, get_ids=True, get_scores=True)
            ctx.register(pb.search2, get_ids=True, get_scores=True)
    if request.filter is not None:
        for part in request.filter.walk_parts():
            ctx.register(part, get_ids=True)


def _jnp():
    import jax.numpy as jnp

    return jnp


def _is_host(x) -> bool:
    return isinstance(x, np.ndarray)


def _to_host(x) -> np.ndarray:
    return x if _is_host(x) else np.asarray(x, dtype=_F32)


# below this many documents the dense vectors live on the host: per-op
# device dispatch would dominate (numpy beats a device round-trip at this size)
import os as _os

SMALL_DOCS = int(_os.environ.get("VELOCI_DEVICE_MIN_DOCS", "65536"))


def _resolve_leaf_dense(ctx: _Ctx, part: RequestSearchPart):
    """Dense [num_docs] score vector for one leaf — on device for large
    indices (host materialisation lazily at the first host-only op), on host
    for small ones."""
    fsr = ctx.result_for(part)
    field = fsr.path[: -len(TEXTINDEX)]
    if ctx.num_docs < SMALL_DOCS:
        store = ctx.persistence.anchor_scores.get(
            fsr.path + ".to_anchor_id_score"
        )
        dense = np.zeros(ctx.num_docs, dtype=_F32)
        if store is None:
            return dense
        for tid, tscore in zip(fsr.term_ids, fsr.term_scores):
            anchors, scores = store.get_postings(int(tid))
            vals = (scores.astype(_F32) / _F32(100.0)) * _F32(tscore)
            np.maximum.at(dense, anchors.astype(np.int64), vals)
        return dense
    dev = ctx.persistence.device_field(field)
    return resolve_to_anchor_dense(dev, fsr.term_ids, fsr.term_scores, ctx.num_docs)


def _matching_1n_boost(part: RequestSearchPart, boosts) -> Optional[object]:
    """1:n boost attach check (plan_creator_search_part, execution_plan.rs:436-470)."""
    pos = part.path.rfind("[]")
    if pos < 0 or not boosts:
        return None
    end_obj = part.path[:pos]
    matches = []
    for b in boosts:
        bpos = b.path.rfind("[]")
        if bpos >= 0 and b.path[:bpos] == end_obj:
            matches.append(b)
    if not matches:
        return None
    if len(matches) > 1:
        raise InvalidRequestError("multiple 1:n boosts match a single field")
    return matches[0]


def _eval_scores(ctx: _Ctx, node: SearchRequest, boosts):
    """Evaluate the search tree -> (dense, repr term, repr path, explain node)."""
    if node.kind == SearchRequest.SEARCH:
        part = node.part
        dense = _resolve_leaf_dense(ctx, part)
        enode = ExplainNode("leaf", part=part) if ctx.explain else None
        if part.options and part.options.get("boost"):
            from ..query.request import RequestBoostPart

            boosts = list(boosts) + [
                RequestBoostPart.from_dict(b) for b in part.options["boost"]
            ]
        b1n = _matching_1n_boost(part, boosts)
        if b1n is not None:
            fsr = ctx.result_for(part)
            anchors, bvals = boost_mod.boost_to_anchor_values(
                ctx.persistence, fsr.path, b1n, fsr.term_ids
            )
            if not _is_host(dense) and not ctx.explain:
                # device path: the (anchor, value) lists are small; only the
                # scatter application touches the resident dense vector
                dense = boost_mod.apply_anchor_boost_values_device(
                    dense, anchors, bvals, b1n
                )
                return dense, part.terms[0], part.path, enode
            old = dense = _to_host(dense)
            dense = boost_mod.apply_anchor_boost_values(dense, anchors, bvals, b1n)
            if ctx.explain:
                entries = [dense.copy()]
                if b1n.boost_fun == "Log10":
                    # reference pushes the log10 factor BEFORE the final
                    # score for Log10 (boost.rs:292-309 + :371-374)
                    with np.errstate(divide="ignore", invalid="ignore"):
                        fac = np.where(
                            old > 0, dense / np.maximum(old, _F32(1e-30)), _F32(0.0)
                        ).astype(_F32)
                    entries.insert(0, fac)
                ctx.boost_log.append(((old > 0) & (dense != old), entries))
        return dense, part.terms[0], part.path, enode

    # merge node-level option boosts (merge_vec, execution_plan.rs:268-275)
    sub_boosts = list(boosts)
    if node.options and node.options.get("boost"):
        from ..query.request import RequestBoostPart

        sub_boosts += [RequestBoostPart.from_dict(b) for b in node.options["boost"]]

    children = [_eval_scores(ctx, q, sub_boosts) for q in node.queries]
    if not children:
        return np.zeros(ctx.num_docs, dtype=_F32), "", "", None
    if len(children) == 1:
        return children[0]

    if node.kind == SearchRequest.OR:
        # union_hits_score (set_op.rs:87-220): max per distinct term, sum in
        # sorted-term order, * distinct^2 — on device when all inputs are
        xp = np if any(_is_host(c[0]) for c in children) else _jnp()
        if xp is np:
            children = [(_to_host(c[0]), c[1], c[2], c[3]) for c in children]
        terms = sorted({t for _d, t, _p, _e in children})
        total = xp.zeros(ctx.num_docs, dtype=_F32)
        distinct = xp.zeros(ctx.num_docs, dtype=np.int32)
        for t in terms:
            vecs = [d for d, tt, _p, _e in children if tt == t]
            mx = vecs[0]
            for v in vecs[1:]:
                mx = xp.maximum(mx, v)
            total = (total + mx).astype(_F32)
            distinct = distinct + (mx >= _F32(1e-5)).astype(np.int32)
        df = distinct.astype(_F32)
        dense = (total * df * df).astype(_F32)
        enode = None
        if ctx.explain:
            enode = ExplainNode(
                "or",
                children=[c[3] for c in children],
                denses=[c[0] for c in children],
                terms=[c[1] for c in children],
            )
        return dense, children[0][1], children[0][2], enode

    if node.kind == SearchRequest.AND:
        # intersect_hits_score (set_op.rs:368-448)
        xp = np if any(_is_host(c[0]) for c in children) else _jnp()
        if xp is np:
            children = [(_to_host(c[0]), c[1], c[2], c[3]) for c in children]
        mask = None
        for d, _t, _p, _e in children:
            m = d > 0
            mask = m if mask is None else (mask & m)
        counts = [int((d > 0).sum()) for d, _t, _p, _e in children]
        shortest = int(np.argmin(counts))
        total = xp.zeros(ctx.num_docs, dtype=_F32)
        for i, (d, _t, _p, _e) in enumerate(children):
            if i != shortest:
                total = (total + d).astype(_F32)
        total = (total + children[shortest][0]).astype(_F32)
        dense = xp.where(mask, total, _F32(0.0)).astype(_F32)
        enode = (
            ExplainNode("and", children=[c[3] for c in children])
            if ctx.explain
            else None
        )
        return dense, children[0][1], children[0][2], enode

    raise InvalidRequestError(f"unknown node kind {node.kind}")


def _eval_ids(ctx: _Ctx, node: SearchRequest) -> np.ndarray:
    """ids-only evaluation for filters -> dense bool mask."""
    if node.kind == SearchRequest.SEARCH:
        fsr = ctx.result_for(node.part)
        anchors = boost_mod.resolve_ids_to_anchor(
            ctx.persistence, fsr.path, fsr.hits_ids
        )
        mask = np.zeros(ctx.num_docs, dtype=bool)
        anchors = anchors[(anchors >= 0) & (anchors < ctx.num_docs)]
        mask[anchors] = True
        return mask
    masks = [_eval_ids(ctx, q) for q in node.queries]
    if not masks:
        return np.zeros(ctx.num_docs, dtype=bool)
    out = masks[0]
    for m in masks[1:]:
        out = (out | m) if node.kind == SearchRequest.OR else (out & m)
    return out


def _eval_ids_device(ctx: _Ctx, node: SearchRequest):
    """Device variant of :func:`_eval_ids`: the (small) matched-anchor lists
    resolve on the host, only the [num_docs] mask materialises on device —
    the reference's FilterChannel broadcast becomes a resident bool vector."""
    import jax.numpy as jnp

    if node.kind == SearchRequest.SEARCH:
        fsr = ctx.result_for(node.part)
        anchors = boost_mod.resolve_ids_to_anchor(
            ctx.persistence, fsr.path, fsr.hits_ids
        )
        anchors = anchors[(anchors >= 0) & (anchors < ctx.num_docs)]
        mask = jnp.zeros(ctx.num_docs, dtype=bool)
        if len(anchors):
            mask = mask.at[jnp.asarray(anchors.astype(np.int32))].set(True)
        return mask
    masks = [_eval_ids_device(ctx, q) for q in node.queries]
    if not masks:
        return jnp.zeros(ctx.num_docs, dtype=bool)
    out = masks[0]
    for m in masks[1:]:
        out = (out | m) if node.kind == SearchRequest.OR else (out & m)
    return out


def _try_fast_path(request: Request, persistence, top: int) -> Optional[SearchResult]:
    """Fused device path for plain exact queries: host term lookup + ONE XLA
    program (resolve -> dense -> top-k -> hit count). Covers single-leaf and
    flat-OR exact requests without filters/boosts/facets/why-found."""
    if any(
        (
            request.filter,
            request.boost,
            request.boost_term,
            request.phrase_boosts,
            request.facets,
            request.why_found,
            request.text_locality,
            request.explain,
            request.suggest,
        )
    ):
        return None
    if persistence.num_docs < SMALL_DOCS:
        return None  # host execution path is faster at this size
    node = request.search_req
    is_and = False
    if node.kind == SearchRequest.SEARCH:
        leaves = [node.part]
    elif node.kind in (SearchRequest.OR, SearchRequest.AND) and all(
        q.kind == SearchRequest.SEARCH for q in node.queries
    ):
        leaves = [q.part for q in node.queries]
        is_and = node.kind == SearchRequest.AND
    else:
        return None
    for part in leaves:
        if (
            (part.levenshtein_distance or 0) != 0
            or part.starts_with
            or part.is_regex
            or part.token_value is not None
            or part.snippet
            or part.top is not None
            or part.skip is not None
            or (part.options or None)
            or part.ignore_case is False
        ):
            return None

    from ..ops.postings import bucket_size
    from ..ops.search_step import (
        intersect_search_topk,
        single_term_search_topk,
        union_search_topk,
    )
    import jax.numpy as jnp

    # host term lookup + slot assignment: OR groups by distinct term string
    # (set_op.rs:87-220); AND keeps one slot per leaf (set_op.rs:368-448,
    # every child contributes to the sum even when terms repeat)
    term_strings = sorted({p.terms[0] for p in leaves})
    slots = {t: i for i, t in enumerate(term_strings)}
    num_slots = len(leaves) if is_and else len(term_strings)
    tid_list: List[Tuple[str, int, float, int]] = []  # (field, tid, score, slot)
    fields = set()
    for li, part in enumerate(leaves):
        field = part.path
        if field.endswith(TEXTINDEX):
            field = field[: -len(TEXTINDEX)]
        fields.add(field)
        dictionary = persistence.get_dictionary(field)
        score = _F32(10.0)  # exact: distance 0 -> 2/0.2
        if part.boost is not None:
            score = _F32(score * _F32(part.boost))
        slot = li if is_and else slots[part.terms[0]]
        for tid in dictionary.get_ignore_case(part.terms[0]):
            tid_list.append((field, tid, float(score), slot))
    if len(fields) == 1:
        field = next(iter(fields))
        dev = persistence.device_field(field)
        base_of = {field: (0, dev.num_score_keys)}
    else:
        # multi-field OR: fuse over the combined global-key postings
        dev = persistence.device_combined()
        if dev is None or any(f not in dev.key_base for f in fields):
            return None
        base_of = dev.key_base
    if dev.offsets is None:
        return None

    num_docs = persistence.num_docs
    ho = dev.host_offsets
    gtid_list = []  # (global_tid, score, slot)
    for f, tid, sc, sl in tid_list:
        base, nk = base_of[f]
        if tid < nk:
            gtid_list.append((base + tid, sc, sl))
    total = sum(int(ho[g + 1] - ho[g]) for g, _s, _sl in gtid_list)
    capacity = bucket_size(max(total, 1))
    k_eff = min(num_docs, top)
    if len(gtid_list) == 1 and not is_and:
        # dominant query shape: ONE exact term -> scatter-free fused kernel
        g, sc0, _sl = gtid_list[0]
        # packed rows replace anchors/scores01 entirely: half the posting
        # H2D/HBM (the separate arrays never upload)
        ids, scores, num_hits = single_term_search_topk(
            dev.offsets,
            None,
            None,
            jnp.int32(g),
            jnp.float32(sc0),
            capacity=capacity,
            k=k_eff,
            packed=dev.packed,
        )
    else:
        t_pad = bucket_size(max(len(gtid_list), 1), 8)
        term_ids = np.full(t_pad, -1, dtype=np.int32)
        term_scores = np.zeros(t_pad, dtype=np.float32)
        term_slots = np.zeros(t_pad, dtype=np.int32)
        for j, (g, sc, sl) in enumerate(gtid_list[:t_pad]):
            term_ids[j] = g
            term_scores[j] = sc
            term_slots[j] = sl
        step = intersect_search_topk if is_and else union_search_topk
        # slice-packing window: >= the largest selected run (device arrays
        # carry that much tail padding) — contiguous DMA instead of gather
        win = bucket_size(
            max((int(ho[g + 1] - ho[g]) for g, _s, _sl in gtid_list), default=1)
        )
        ids, scores, num_hits = step(
            dev.offsets,
            None,
            None,
            jnp.asarray(term_ids),
            jnp.asarray(term_scores),
            jnp.asarray(term_slots),
            capacity=capacity,
            num_docs=num_docs,
            k=k_eff,
            num_slots=max(num_slots, 1),
            win=win,
            packed=dev.packed,
        )
    # the fused kernels return exact (score desc, id desc) order (two-stage
    # tie-proof selection, ops/topk.py) — just drop the misses.
    # ONE device_get: each separate np.asarray is its own D2H round-trip
    import jax

    ids, scores, num_hits = jax.device_get((ids, scores, num_hits))
    mask = scores > 0
    ids, scores = ids[mask], scores[mask]
    result = SearchResult()
    result.num_hits = int(num_hits)
    result.data = [Hit(int(i), float(s)) for i, s in zip(ids[:top], scores[:top])]
    return result


def _fuzzy_fast_eligible(request: Request, persistence, allow_extras: bool = False):
    """Eligibility for the fused fuzzy path -> (field, lower_term, distance)
    or None. Shared by search() and search_batch(). With ``allow_extras``
    filters / boost columns / facets / phrase boosts are permitted (the
    batched fuzzy-generic kernel fuses them; search/batch.py)."""
    extras = (
        request.filter,
        request.boost,
        request.phrase_boosts,
        request.facets,
    )
    if any(
        (
            request.boost_term,
            request.why_found,
            request.text_locality,
            request.explain,
            request.suggest,
        )
    ) or (any(extras) and not allow_extras):
        return None
    if persistence.num_docs < SMALL_DOCS:
        return None
    node = request.search_req
    if node is None or node.kind != SearchRequest.SEARCH:
        return None
    part = node.part
    distance = part.levenshtein_distance or 0
    if (
        distance <= 0
        or part.starts_with
        or part.is_regex
        or part.token_value is not None
        or part.snippet
        or part.top is not None
        or part.skip is not None
        or (part.options or None)
        or part.ignore_case is False
        or part.boost is not None
    ):
        return None
    term = part.terms[0].lower()
    from ..ops.levenshtein import MAX_QUERY_CHARS

    if len(term) > MAX_QUERY_CHARS - 1:
        return None
    field = part.path
    if field.endswith(TEXTINDEX):
        field = field[: -len(TEXTINDEX)]
    from ..indices import MAX_TERM_CHARS

    dictionary = persistence.get_dictionary(field)
    if dictionary.long_term_ids() and len(term) + distance > MAX_TERM_CHARS:
        # only a near-matrix-width query can reach a >32-char term at d<=4
        # (lev >= length difference); shorter queries provably cannot, so
        # the fused path stays available on corpora with long text entries
        return None
    dev = persistence.device_field(field)
    if dev.offsets is None:
        return None
    distance = min(distance, max(len(term) - 1, 0))
    if distance == 0:
        return None  # exact semantics — _try_fast_path territory
    return field, term, distance


def fuzzy_start_capacity(persistence, field: str) -> int:
    """Sticky per-field starting bucket for the optimistic fuzzy resolve —
    grows to whatever the last overflow needed, so steady-state traffic
    re-dispatches rarely."""
    caps = getattr(persistence, "_fuzzy_cap_hint", None)
    if caps is None:
        caps = persistence._fuzzy_cap_hint = {}
    # modest default: overflow re-dispatch is cheap (batch runners retry
    # only the overflowing rows), while over-provisioning costs EVERY query
    # (the sorted-run resolve is O(capacity))
    return caps.get(field, 4096)


def _try_fuzzy_fast_path(
    request: Request, persistence, top: int
) -> Optional[SearchResult]:
    """Fully-fused fuzzy path: ONE XLA program does the Levenshtein sweep,
    on-device term selection, posting resolve and top-k (fuzzy_search_topk).
    Engages for a single plain fuzzy leaf on a short-term dictionary."""
    el = _fuzzy_fast_eligible(request, persistence)
    if el is None:
        return None
    field, term, distance = el
    dev = persistence.device_field(field)
    from ..ops.levenshtein import encode_query

    from ..ops.fuzzy_step import fuzzy_search_topk, fuzzy_search_topk_banded

    import jax
    import jax.numpy as jnp

    num_docs = persistence.num_docs
    max_terms = 256
    q, qlen = encode_query(term)
    # short queries sweep the short matrix (terms longer than qlen+d can't
    # be within distance d)
    dev = dev.sweep_variant(qlen + distance)
    k_eff = min(num_docs, top)
    # the banded sweep kernel keeps the DP state in registers (the XLA
    # sweep moves it through device memory) — same routing as field_search
    from ..ops.pallas_levenshtein import use_banded_kernel

    use_banded = use_banded_kernel(distance)
    # OPTIMISTIC resolve capacity: the static worst case (sum of the
    # max_terms largest runs) makes the gather/scatter ~10-100x too big for
    # typical fuzzy matches; start small and re-dispatch on overflow (the
    # kernel reports the true posting total)
    from ..ops.postings import MAX_SORT_CAPACITY

    worst = min(dev.fuzzy_capacity(max_terms), MAX_SORT_CAPACITY)
    capacity = min(worst, fuzzy_start_capacity(persistence, field))
    while True:
        if use_banded:
            ids, scores, num_hits, total_matches, total_postings = (
                fuzzy_search_topk_banded(
                    dev.chars_t,
                    dev.lengths,
                    jnp.asarray(q),
                    jnp.int32(qlen),
                    jnp.int32(distance),
                    dev.offsets,
                    None,
                    None,
                    max_terms=max_terms,
                    capacity=capacity,
                    num_docs=num_docs,
                    k=k_eff,
                    packed=dev.packed,
                    sweep_ids=dev.sweep_ids,
                    band=2 if distance <= 2 else 4,
                )
            )
        else:
            ids, scores, num_hits, total_matches, total_postings = (
                fuzzy_search_topk(
                    dev.chars,
                    dev.lengths,
                    jnp.asarray(q),
                    jnp.int32(qlen),
                    jnp.int32(distance),
                    dev.offsets,
                    None,
                    None,
                    max_terms=max_terms,
                    capacity=capacity,
                    num_docs=num_docs,
                    k=k_eff,
                    packed=dev.packed,
                    sweep_ids=dev.sweep_ids,
                )
            )
        ids, scores, num_hits, total_matches, total_postings = jax.device_get(
            (ids, scores, num_hits, total_matches, total_postings)
        )
        if int(total_matches) > max_terms:
            return None  # selection window clipped — generic path decides
        if int(total_postings) <= capacity:
            break
        if capacity >= worst:
            # posting total past the sort cap — the dense-plane path is
            # exact and O(num_docs) there
            return None
        from ..ops.postings import bucket_size

        capacity = min(worst, bucket_size(int(total_postings)))
    from ..ops.postings import bucket_size as _bs

    # adapt down too (at most one bucket per dispatch — bounds thrash)
    persistence._fuzzy_cap_hint[field] = max(
        _bs(max(int(total_postings), 64)), capacity // 2
    )
    mask = scores > 0
    ids, scores = ids[mask], scores[mask]
    result = SearchResult()
    result.num_hits = int(num_hits)
    result.data = [Hit(int(i), float(s)) for i, s in zip(ids[:top], scores[:top])]
    return result


def search(request: Request, persistence, dense_only: bool = False) -> SearchResult:
    """Reference search::search (src/search.rs:143-228).

    ``dense_only`` skips every fused fast path and goes straight to the
    dense per-step executor — for callers that have ALREADY measured the
    query past the fused kernels' limits (posting totals over
    MAX_SORT_CAPACITY, clipped selection windows): re-probing would
    re-dispatch the sweep/capacity ladder for nothing."""
    start = time.time_ns()
    if request.search_req is None:
        raise InvalidRequestError("search_req is required in search")
    top = request.top if request.top is not None else 10

    from .stats import count_fallback, count_path, fallback_reason

    # mesh serving path: document-sharded dense execution over the attached
    # jax Mesh (explain falls back — it collects host score snapshots)
    if getattr(persistence, "mesh_ctx", None) is not None and not (
        request.explain or request.suggest
    ):
        from ..parallel.mesh_executor import mesh_search

        count_path("mesh_per_request")
        return mesh_search(request, persistence)

    skip0 = request.skip or 0
    if not dense_only:
        fast = _try_fast_path(request, persistence, top + skip0)
        if fast is not None:
            count_path("fused_exact")
        if fast is None:
            fast = _try_fuzzy_fast_path(request, persistence, top + skip0)
            if fast is not None:
                count_path("fused_fuzzy")
        if fast is not None:
            if skip0:
                fast.data = fast.data[skip0:]
            fast.data = fast.data[:top]
            fast.execution_time_ns = time.time_ns() - start
            return fast
        # canonical query-language shapes (fuzzy leaves, AND-of-ORs) and
        # filter/boost/facet/phrase extras: ONE fused program via the
        # batched tree machinery (a batch of one) instead of the per-step
        # walk
        from .batch import search_single_fused

        fast = search_single_fused(request, persistence)
        if fast is not None:
            count_path("fused_tree_single")
            fast.execution_time_ns = time.time_ns() - start
            return fast
    count_fallback(fallback_reason(request, persistence))

    tm = info_time("search")
    tm.__enter__()
    ctx = _Ctx(persistence, request)
    if not ctx.explain and request.search_req is not None:
        for part in request.search_req.walk_parts():
            if part.options and part.options.get("explain"):
                ctx.explain = True
                break
    _collect_parts(ctx, request)
    ctx.run_field_searches()

    boosts = list(request.boost or [])
    dense, _t, _p, enode = _eval_scores(ctx, request.search_req, boosts)
    if ctx.explain:
        # explain collects host-side score snapshots per step
        dense = _to_host(dense)

    # filter subtree (computed once, broadcast — reference FilterChannel);
    # on the device path the mask materialises directly in HBM
    if request.filter is not None:
        if _is_host(dense):
            filter_mask = _eval_ids(ctx, request.filter)
            dense = np.where(filter_mask, dense, _F32(0.0)).astype(_F32)
        else:
            import jax.numpy as jnp

            filter_mask = _eval_ids_device(ctx, request.filter)
            dense = jnp.where(filter_mask, dense, _F32(0.0))

    # anchor-level boosts (paths without []) — execution_plan.rs:168-183
    for b in boosts:
        if "[]" in b.path:
            continue
        from ..create import BOOST_VALID_TO_VALUE, TOKEN_VALUES

        boost_path = b.path
        if not boost_path.endswith(BOOST_VALID_TO_VALUE):
            boost_path = boost_path + BOOST_VALID_TO_VALUE
        if not _is_host(dense):
            bv_j, pres_j = persistence.device_boost(boost_path)
            dense = boost_mod.apply_boost_dense_device(dense, bv_j, pres_j, b)
            continue
        vals, present = persistence.get_boost(boost_path)
        old = dense = _to_host(dense)
        dense = boost_mod.apply_boost_dense(dense, vals, present, b)
        if ctx.explain:
            entries = [dense.copy()]
            if b.boost_fun == "Log10":
                # dual Log10 explain entries: factor then final score
                # (reference apply_boost, boost.rs:292-309 + :371-374)
                param = _F32(b.param or 0.0)
                bvfull = np.zeros(len(old), dtype=_F32)
                m = min(len(old), len(vals))
                bvfull[:m] = vals[:m]
                with np.errstate(divide="ignore", invalid="ignore"):
                    fac = np.log10(bvfull + param, dtype=_F32)
                entries.insert(0, fac)
            ctx.boost_log.append(((old > 0) & (dense != old), entries))

    # phrase boosts (plan_steps.rs:237-283)
    if request.phrase_boosts:
        groups: Dict[Tuple[str, str], List[np.ndarray]] = {}
        from ..create import PHRASE_PAIR_TO_ANCHOR

        for pb in request.phrase_boosts:
            if pb.search1.path != pb.search2.path:
                raise InvalidRequestError("phrase boost paths must match")
            r1 = ctx.result_for(pb.search1)
            r2 = ctx.result_for(pb.search2)
            path = r1.path + PHRASE_PAIR_TO_ANCHOR
            store = persistence.phrase_indices.get(path)
            if store is None:
                continue
            anchors = store.get_values_for_pairs(r1.hits_ids, r2.hits_ids)
            key = (pb.search1.terms[0], pb.search2.terms[0])
            groups.setdefault(key, []).append(anchors)
        group_arrays = [
            np.concatenate(v) if len(v) > 1 else v[0]
            for v in groups.values()
            if v
        ]
        if group_arrays:
            if _is_host(dense):
                dense = (
                    _to_host(dense)
                    * boost_mod.phrase_boost_factor(group_arrays, ctx.num_docs)
                ).astype(_F32)
                # boosts only apply to existing hits
                dense = np.where(dense > 0, dense, _F32(0.0))
            else:
                import jax.numpy as jnp

                factor = boost_mod.scatter_factor_device(
                    [np.unique(np.asarray(g, dtype=np.int64)) for g in group_arrays],
                    ctx.num_docs,
                    [5.0] * len(group_arrays),
                )
                dense = dense * factor
                dense = jnp.where(dense > 0, dense, _F32(0.0))

    # merge per-field metadata from the main tree (merge_term_id_hits)
    term_id_hits: Dict[str, Dict[str, List[int]]] = {}
    term_texts: Dict[str, List[str]] = {}
    for part in request.search_req.walk_parts():
        fsr = ctx.result_for(part)
        for path, m in fsr.term_id_hits_in_field.items():
            term_id_hits.setdefault(path, {}).update(m)
        for path, texts in fsr.term_text_in_field.items():
            term_texts.setdefault(path, []).extend(texts)

    result = SearchResult()

    # boost_term (boost.rs:89-196)
    if request.boost_term:
        def run_part(part, **kw):
            return get_term_ids_in_field(persistence, part, **kw)

        if _is_host(dense):
            factor = boost_mod.term_boost_factor(
                persistence, request.boost_term, ctx.num_docs, run_part
            )
            dense = (dense * factor).astype(_F32)
        else:
            dense = dense * boost_mod.term_boost_factor_device(
                persistence, request.boost_term, ctx.num_docs, run_part
            )

    # text locality (boost.rs:11-87)
    if request.text_locality:
        factor = boost_mod.text_locality_boost(
            persistence, term_id_hits, ctx.num_docs
        )
        if _is_host(dense):
            dense = (dense * factor).astype(_F32)
        else:
            import jax.numpy as jnp

            # factor computation is join-heavy host work either way; ship
            # the finished [num_docs] factor once
            dense = dense * jnp.asarray(factor)

    result.why_found_terms = term_texts

    if _is_host(dense):
        hit_mask = dense > 0
        result.num_hits = int(np.count_nonzero(hit_mask))
    else:
        result.num_hits = int((dense > 0).sum())
        hit_mask = None

    if request.facets:
        # device path counts on-chip (cached relation pairs + segment_sum);
        # host path uses the dense mask
        mask_arg = hit_mask if hit_mask is not None else dense
        result.facets = {
            f.field: get_facet(persistence, f, mask_arg) for f in request.facets
        }

    # top-n sort (sort.rs:5-34) + skip/top (search.rs:230-239)
    skip = request.skip or 0
    if _is_host(dense):
        ids, scores = dense_to_hits(dense, k=(top + skip) if top is not None else None)
    else:
        from ..ops.topk import top_k_scores

        ids, scores = top_k_scores(dense, (top + skip) if top is not None else ctx.num_docs)
    if skip:
        ids, scores = ids[skip:], scores[skip:]
    if top is not None:
        ids, scores = ids[:top], scores[:top]
    result.data = [Hit(int(i), float(s)) for i, s in zip(ids, scores)]

    if request.why_found and request.select is not None:
        anchor_ids = [h.id for h in result.data]
        result.why_found_info = get_why_found(persistence, anchor_ids, term_id_hits)

    if ctx.explain:
        result.explain = collect_explain(
            ctx, enode, [h.id for h in result.data], ctx.boost_log
        )

    result.execution_time_ns = time.time_ns() - start
    tm.__exit__(None, None, None)
    return result


def to_documents(persistence, hits: List[Hit], select, result: SearchResult):
    """Reference src/search.rs:65-102."""
    import json as _json

    tokens_set = {
        path: set(terms) for path, terms in result.why_found_terms.items()
    }
    docs = []
    for hit in hits:
        if select is not None:
            doc = read_data(persistence, hit.id, select)
            docs.append(
                DocWithHit(
                    doc=doc,
                    hit=hit,
                    explain=result.explain.get(hit.id),
                    why_found=result.why_found_info.get(hit.id, {}),
                )
            )
        else:
            doc_str = persistence.doc_loader.get_doc(hit.id)
            doc = _json.loads(doc_str)
            why = highlight_on_original_document(persistence, doc, tokens_set)
            docs.append(
                DocWithHit(
                    doc=doc, hit=hit, explain=result.explain.get(hit.id), why_found=why
                )
            )
    return docs


def search_to_result_with_doc(
    persistence, result: SearchResult, select=None
) -> SearchResultWithDoc:
    """Reference search::to_search_result (src/search.rs:104-111)."""
    return SearchResultWithDoc(
        data=to_documents(persistence, result.data, select, result),
        num_hits=result.num_hits,
        facets=result.facets,
        execution_time_ns=result.execution_time_ns,
    )


def _suggest_fast(persistence, request: Request):
    """Vectorised suggest for the canonical shape (every part: one term,
    starts_with, lev 0 after the length cap, ignore_case, no
    regex/snippet/token_value/options/part-level windowing) — the entire
    per-field select runs as a handful of numpy ops on the prefix range.

    Key observation: in the prefix path the score is a monotone-decreasing
    function of candidate LENGTH alone (distance = len - |prefix|,
    get_default_score_for_distance with the prefix branch), so the
    comparator (score desc, text desc) = (length asc, text desc) and the
    per-part top-K can be selected positionally in the lowercase-sorted
    slice without materialising any strings beyond the K winners. Per-part
    top-K is sufficient for the cross-part merged top-K (an element of the
    merged top-K must rank <= K in its best part). Ties and case-fold
    duplicates reproduce `suggest` exactly: equal-lowercase ids keep the
    smallest id (ascending iteration, strictly-greater replacement), and
    across parts the earlier part wins equal scores.

    Returns None when any part doesn't fit the shape (caller falls back).
    """
    if request.top is None:
        return None
    skip = request.skip or 0
    need = request.top + skip
    if need <= 0:
        return []
    from ..create import TEXTINDEX

    per_part: list = []
    for part in request.suggest:
        d = part.levenshtein_distance
        if d:
            d = min(d, max(len(part.terms[0].lower()) - 1, 0))
        if (
            len(part.terms) != 1
            or not part.starts_with
            or d
            or part.is_regex
            or part.snippet
            or (part.options or None)
            or part.token_value is not None
            or part.top is not None
            or part.skip is not None
            or part.ignore_case is False
        ):
            return None
        field = part.path
        if field.endswith(TEXTINDEX):
            field = field[: -len(TEXTINDEX)]
        try:
            dictionary = persistence.get_dictionary(field)
        except Exception:
            return None
        prefix = part.terms[0].lower()
        import bisect as _bisect

        arr = dictionary._lower_sorted
        i = _bisect.bisect_left(arr, prefix)
        j = _bisect.bisect_right(arr, prefix + "\U0010FFFF", lo=i)
        if j <= i:
            continue
        perm = dictionary.lower_perm_np[i:j]
        lens = dictionary.char_lengths()[perm]
        # (length asc, slice-position desc) == (score desc, text desc);
        # equal-lowercase duplicates are adjacent in the slice and stay
        # adjacent after the stable length sort
        pos = np.arange(len(perm))
        order = np.lexsort((-pos, lens))
        boost = np.float32(part.boost) if part.boost is not None else None
        sel: list = []  # (lower_term, score, tid) text-desc within length
        kept = 0
        prev_txt = None
        for oi in order:
            txt = arr[i + int(oi)]
            if prev_txt is not None and txt == prev_txt:
                # equal lowercase: keep the SMALLEST id (ascending-id
                # iteration with strictly-greater replacement in `suggest`)
                last = sel[-1]
                tid = int(perm[oi])
                if tid < last[2]:
                    sel[-1] = (last[0], last[1], tid)
                continue
            if kept >= need:
                break  # fresh text past the window: done (dups absorbed)
            dist = np.float32(int(lens[oi]) - len(prefix))
            score = np.float32(2.0) / (
                np.log2(dist + np.float32(1.0)) + np.float32(0.2)
            )
            if boost is not None:
                score = np.float32(score * boost)
            sel.append((txt, float(score), int(perm[oi])))
            prev_txt = txt
            kept += 1
        per_part.append(sel)

    merged: Dict[str, Tuple[float, int]] = {}
    for sel in per_part:
        for term, score, tid in sel:
            prev = merged.get(term)
            if prev is None or score > prev[0]:
                merged[term] = (score, tid)
    out = [(term, score, tid) for term, (score, tid) in merged.items()]
    out.sort(key=lambda el: el[0], reverse=True)
    out.sort(key=lambda el: -el[1])
    return out[skip : skip + request.top]


def suggest_batch(persistence, requests: List[Request]):
    """A batch of suggest requests (the server's fold dispatcher and the
    bench concurrency smoke): each rides the vectorised fast path when its
    shape allows, the reference-faithful path otherwise."""
    return [suggest(persistence, r) for r in requests]


def suggest(persistence, request: Request):
    """Reference search_field::suggest_multi (search_field.rs:194-219).

    The canonical prefix shape runs the vectorised fast path
    (:func:`_suggest_fast`); anything else fans per-field term sweeps over
    a thread pool (the reference's rayon par_iter; numpy / device dispatch
    release the GIL) and merges on the host."""
    if not request.suggest:
        raise VelociError("only suggest allowed in suggest function")
    fast = _suggest_fast(persistence, request)
    if fast is not None:
        return fast

    def one(part):
        return get_term_ids_in_field(
            persistence,
            part,
            get_scores=True,
            return_term=True,
            return_term_lowercase=True,
        )

    parts = list(request.suggest)
    if len(parts) > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=min(8, len(parts))) as pool:
            fsrs = list(pool.map(one, parts))
    else:
        fsrs = [one(p) for p in parts]

    merged: Dict[str, Tuple[float, int]] = {}
    for fsr in fsrs:
        for tid, score in zip(fsr.term_ids, fsr.term_scores):
            term = fsr.terms[int(tid)]
            prev = merged.get(term)
            if prev is None or score > prev[0]:
                merged[term] = (float(score), int(tid))
    out = [(term, score, tid) for term, (score, tid) in merged.items()]
    # the reference sorts by text DESC for the dedup pass, then (stable in
    # effect) by score desc — ties therefore order text-descending
    # (get_text_score_id_from_result, search_field.rs:160-192)
    out.sort(key=lambda el: el[0], reverse=True)
    out.sort(key=lambda el: -el[1])
    skip = request.skip or 0
    top = request.top
    out = out[skip:]
    if top is not None:
        out = out[:top]
    return out


def explain_plan(request: Request, persistence) -> str:
    """Render the EXECUTED plan as graphviz dot (reference plan.rs:81-125):
    the compiler's actual structure — deduplicated field searches with their
    reuse counts (the FieldRequestCache), the filter subtree computed once
    and broadcast, 1:n boost splits (ResolveTokenIdToAnchor ∥ BoostToAnchor
    → ApplyAnchorBoost), and which execution path the request takes
    (fused single-term / fused union / fused fuzzy / mesh / device tree /
    host tree)."""
    lines = ["digraph plan {"]

    # --- run the compiler's collection phase (dedup cache + flags) --------
    ctx = _Ctx(persistence, request)
    _collect_parts(ctx, request)
    refs: Dict[tuple, int] = {}

    def count_refs(node: Optional[SearchRequest]):
        if node is None:
            return
        for part in node.walk_parts():
            refs[part.key()] = refs.get(part.key(), 0) + 1

    count_refs(request.search_req)
    count_refs(request.filter)
    for pb in request.phrase_boosts or []:
        for p in (pb.search1, pb.search2):
            refs[p.key()] = refs.get(p.key(), 0) + 1

    # --- which execution path will run? -----------------------------------
    if getattr(persistence, "mesh_ctx", None) is not None:
        mode = f"mesh ({persistence.mesh_ctx.d} doc shards, all_gather top-k merge)"
    else:
        plain = not any(
            (
                request.filter, request.boost, request.boost_term,
                request.phrase_boosts, request.facets, request.why_found,
                request.text_locality, request.explain, request.suggest,
            )
        )
        big = persistence.num_docs >= SMALL_DOCS
        node = request.search_req
        flat = node is not None and (
            node.kind == SearchRequest.SEARCH
            or (
                node.kind in (SearchRequest.OR, SearchRequest.AND)
                and all(q.kind == SearchRequest.SEARCH for q in node.queries)
            )
        )
        fuzzy_leaf = (
            node is not None
            and node.kind == SearchRequest.SEARCH
            and (node.part.levenshtein_distance or 0) > 0
        )
        if plain and big and flat and not fuzzy_leaf:
            leaves = [node.part] if node.kind == SearchRequest.SEARCH else [
                q.part for q in node.queries
            ]
            if len(leaves) == 1:
                mode = "fused single-term kernel (dynamic_slice + 2-stage top-k)"
            elif node.kind == SearchRequest.AND:
                mode = "fused intersect kernel"
            else:
                mode = "fused union kernel"
        elif plain and big and fuzzy_leaf:
            mode = "fused fuzzy kernel (banded Pallas sweep + resolve + top-k)"
        elif big:
            mode = "device tree (dense vectors resident in HBM)"
        else:
            mode = "host tree (numpy dense vectors)"
    lines.append(f'  path [label="execution path: {mode}", shape=note];')

    # --- deduplicated field-search nodes (FieldRequestCache) --------------
    fs_name: Dict[tuple, str] = {}
    for i, (key, part) in enumerate(ctx.parts.items()):
        fl = ctx.flags[key]
        flags = "+".join(
            n for n, on in (
                ("scores", fl.get_scores),
                ("ids", fl.get_ids),
                ("term_hits", fl.store_term_id_hits),
            ) if on
        )
        reuse = refs.get(key, 1)
        reuse_txt = f", reused x{reuse}" if reuse > 1 else ""
        name = f"fs{i}"
        fs_name[key] = name
        lines.append(
            f'  {name} [label="field_search {part.path} {part.terms}'
            f' [{flags}{reuse_txt}]", shape=box];'
        )

    boosts = list(request.boost or [])

    def walk(node: SearchRequest) -> str:
        name = f"n{len(lines)}"
        if node.kind == SearchRequest.SEARCH:
            b1n = _matching_1n_boost(node.part, boosts)
            if b1n is not None:
                # the 1:n boost split (execution_plan.rs:439-443)
                lines.append(f'  {name} [label="resolve_to_anchor"];')
                lines.append(f"  {fs_name[node.part.key()]} -> {name};")
                bname = f"n{len(lines)}"
                lines.append(
                    f'  {bname} [label="boost_to_anchor {b1n.path}"];'
                )
                lines.append(f"  {fs_name[node.part.key()]} -> {bname};")
                aname = f"n{len(lines)}"
                lines.append(f'  {aname} [label="apply_anchor_boost"];')
                lines.append(f"  {name} -> {aname};")
                lines.append(f"  {bname} -> {aname};")
                return aname
            lines.append(f'  {name} [label="resolve_to_anchor"];')
            lines.append(f"  {fs_name[node.part.key()]} -> {name};")
            return name
        lines.append(
            f'  {name} [label="{"union" if node.kind == SearchRequest.OR else "intersect"}"];'
        )
        for q in node.queries:
            child = walk(q)
            lines.append(f"  {child} -> {name};")
        return name

    if request.search_req is not None:
        final = walk(request.search_req)
        if request.filter is not None:
            fchildren = [
                fs_name[p.key()] for p in request.filter.walk_parts()
            ]
            lines.append(
                '  filter [label="filter mask (computed ONCE, broadcast)", shape=box];'
            )
            for c in fchildren:
                lines.append(f"  {c} -> filter;")
            lines.append('  fstep [label="intersect scores with filter mask"];')
            lines.append("  filter -> fstep;")
            lines.append(f"  {final} -> fstep;")
            final = "fstep"
        for b in boosts:
            if "[]" in b.path:
                continue  # rendered as the 1:n split above
            name = f"n{len(lines)}"
            lines.append(
                f'  {name} [label="boost {b.path} {b.boost_fun or b.expression}"];'
            )
            lines.append(f"  {final} -> {name};")
            final = name
        for pb in request.phrase_boosts or []:
            name = f"n{len(lines)}"
            lines.append(
                f'  {name} [label="phrase_pair_to_anchor {pb.search1.terms[0]} {pb.search2.terms[0]}"];'
            )
            lines.append(f"  {fs_name[pb.search1.key()]} -> {name};")
            lines.append(f"  {fs_name[pb.search2.key()]} -> {name};")
            bname = f"n{len(lines)}"
            lines.append(f'  {bname} [label="boost_anchor_from_phrase"];')
            lines.append(f"  {name} -> {bname};")
            lines.append(f"  {final} -> {bname};")
            final = bname
        if request.boost_term:
            name = f"n{len(lines)}"
            lines.append(f'  {name} [label="term_boost (LRU-cached anchors)"];')
            lines.append(f"  {final} -> {name};")
            final = name
        if request.text_locality:
            name = f"n{len(lines)}"
            lines.append(f'  {name} [label="text_locality_boost"];')
            lines.append(f"  {final} -> {name};")
            final = name
        if request.facets:
            fields = ",".join(f.field for f in request.facets)
            lines.append(
                f'  facets [label="facet counts ({fields}): masked segment-sum"];'
            )
            lines.append(f"  {final} -> facets;")
        lines.append('  result [label="exact 2-stage top_k + fetch"];')
        lines.append(f"  {final} -> result;")
    lines.append("}")
    return "\n".join(lines)
