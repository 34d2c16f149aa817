"""True batched serving: many requests -> one device dispatch.

`search_batch` partitions a request batch into (a) single-term exact
queries (the scatter-free slice kernel, per-query capacity buckets),
(b) trees — SEARCH / flat OR / flat AND / AND-of-ORs over exact, prefix
AND fuzzy leaves — through the sorted tree kernel over the COMBINED
global-key postings (fuzzy leaf matches bulk-primed by ONE batched sweep
per field, `prefetch_fuzzy_matches`), (c) plain single-leaf fuzzy through
the fully-fused sweep kernels with adaptive window/capacity hints,
(d) filter/boost/facet/phrase-carrying requests through the same tree
kernel with extras, and (e) everything else per request (counted with a
reason in search/stats.py). With a mesh attached the groups dispatch as
sharded `shard_map` programs instead. This is the API behind the server's
``/search_batch`` route and the request-folding dispatcher — the
batched replacement for the reference's per-request thread pool.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..create import TEXTINDEX
from ..query.request import Request, SearchRequest
from .executor import SMALL_DOCS, _fuzzy_fast_eligible, search

# sticky fuzzy-capacity hints track this percentile of each batch's posting
# needs (bounded one bucket move per batch). Higher = fewer retry rounds
# (each retry round costs one device-to-host sync) at the price of a wider
# sorted-run resolve for everyone; tune with VELOCI_FUZZY_CAP_PCTL.
import os as _os

_CAP_PCTL = float(_os.environ.get("VELOCI_FUZZY_CAP_PCTL", "75"))
from .result import Hit, SearchResult

__all__ = ["search_batch", "search_single_fused"]

_MAX_SLOTS = 32  # distinct terms per OR group beyond this -> per request
_MAX_GROUPS = 32  # AND width beyond this -> per request
_MAX_FILTER_ANCHORS = 8192  # larger filter hit lists -> per-request path
_SORT_BUDGET_BYTES = 256 * 1024 * 1024  # per-chunk [Qc, capacity] sort state
_PLANE_BUDGET_BYTES = 256 * 1024 * 1024  # mesh/fuzzy dense-plane chunking


_MAX_LEAF_TERMS = 64  # exact/prefix leaves expanding past this -> per request
_MAX_LEAF_TERMS_FUZZY = 256  # fuzzy leaves matching past this -> per request
_MAX_QUERY_TERMS = 1024  # total resolved terms per query


def _leaf_ok(part) -> bool:
    """Leaf constraints for the batched tree paths. Exact, prefix AND fuzzy
    leaves qualify (case handling, token_value, per-term top-n pruning and
    the fuzzy term sweep all resolve through the memoized host field search,
    bulk-primed by `prefetch_fuzzy_matches`) — only regex, snippet and
    per-leaf option trees stay per-request."""
    return not (
        len(part.terms) != 1
        or part.is_regex
        or part.snippet
        or (part.options or None)
    )


def _leaf_gtids(persistence, comb, part, slot):
    """One leaf -> [(global_tid, f32 score, slot)] or None.

    Term ids AND scores come from the memoized field search (the same
    results the host executor resolves from), so prefix/fuzzy distance
    scoring, `boost`, `ignore_case`, token_value boosts and `top` pruning
    are host-parity by construction. Fuzzy leaves are primed in bulk by the
    batched sweep (`prefetch_fuzzy_matches`) before this runs."""
    from .field_search import get_term_ids_in_field

    f = part.path
    if f.endswith(TEXTINDEX):
        f = f[: -len(TEXTINDEX)]
    kb = comb.key_base.get(f)
    if kb is None:
        return None
    base, nk = kb

    memo = getattr(persistence, "_field_search_cache", None)
    if memo is None:
        memo = persistence._field_search_cache = {}
    mkey = (part.key(), True, False, False, False)
    fsr = memo.get(mkey)
    if fsr is None:
        fsr = get_term_ids_in_field(persistence, part, get_scores=True)
        if len(memo) > 4096:
            memo.clear()
        memo[mkey] = fsr
    cap = (
        _MAX_LEAF_TERMS_FUZZY
        if (part.levenshtein_distance or 0) > 0
        else _MAX_LEAF_TERMS
    )
    if len(fsr.term_ids) > cap:
        return None
    out = []
    for tid, score in zip(fsr.term_ids, fsr.term_scores):
        if int(tid) < nk:
            out.append((base + int(tid), float(score), slot))
    return out


def _node_groups(node):
    """Tree -> list of leaf groups under an implicit top-level AND, or None.

    The supported shapes are the reference plan compiler's post-simplify
    surface for the query generator (execution_plan.rs:272-387 over
    query_generator.rs:85-99 output):

    * SEARCH                  -> 1 group  [leaf]
    * OR of leaves            -> 1 group  [leaves]  (union)
    * AND of leaves/OR-groups -> 1 group per child  (intersect of unions)

    OR-of-ANDs and deeper nesting stay per-request.
    """
    if node is None:
        return None
    if node.kind == SearchRequest.SEARCH:
        return [[node.part]]
    if node.kind == SearchRequest.OR and all(
        q.kind == SearchRequest.SEARCH for q in node.queries
    ):
        return [[q.part for q in node.queries]]
    if node.kind == SearchRequest.AND:
        groups = []
        for q in node.queries:
            if q.kind == SearchRequest.SEARCH:
                groups.append([q.part])
            elif q.kind == SearchRequest.OR and all(
                c.kind == SearchRequest.SEARCH for c in q.queries
            ):
                groups.append([c.part for c in q.queries])
            else:
                return None
        return groups
    return None


def _tree_spec(persistence, comb, node):
    """Tree -> (gtids [(global_tid, score, packed_slot)], num_groups) or None.

    ``packed_slot = group << GROUP_SHIFT | slot_in_group`` where slots
    within a group are distinct term STRINGS (union groups by term,
    set_op.rs:87-220). One kernel shape covers flat OR (1 group), flat AND
    (one group per leaf) and the canonical AND-of-ORs.
    """
    from ..ops.tree_step import GROUP_SHIFT

    groups = _node_groups(node)
    if groups is None or len(groups) > _MAX_GROUPS:
        return None
    gtids = []
    for gi, parts in enumerate(groups):
        if not all(_leaf_ok(p) for p in parts):
            return None
        term_strings = sorted({p.terms[0] for p in parts})
        if len(term_strings) > _MAX_SLOTS:
            return None
        slots = {t: i for i, t in enumerate(term_strings)}
        for p in parts:
            g = _leaf_gtids(
                persistence, comb, p, (gi << GROUP_SHIFT) | slots[p.terms[0]]
            )
            if g is None:
                return None
            gtids.extend(g)
    if len(gtids) > _MAX_QUERY_TERMS:
        return None
    return gtids, len(groups)


def _normalize_node(node):
    """Flatten same-kind nesting and collapse single-child nodes — the host
    executor short-circuits ``len(children) == 1`` and the reference's
    `simplify()` flattens AND/OR (search_request.rs:8-72), so shapes that
    differ only by redundant nesting must map to the same spec."""
    if node is None or node.kind == SearchRequest.SEARCH:
        return node
    children = []
    for q in node.queries:
        qn = _normalize_node(q)
        if qn is None:
            continue
        if qn.kind == node.kind and not qn.options:
            children.extend(qn.queries)
        else:
            children.append(qn)
    if len(children) == 1 and not node.options:
        return children[0]
    return SearchRequest(node.kind, queries=children, options=node.options)


def _node_deep(node):
    """Deep-tree canonical form: ``OR( leaf | AND( leaf | OR(leaves) ) )``
    -> [(repr_term, groups)] per subtree, or None. This is the
    3-alternation surface (OR-of-ANDs, depth-3 trees) the 2-level kernel
    rejects; anything deeper (4+ alternations) stays per-request.

    ``repr_term`` is the subtree's LEFTMOST leaf term — the host executor's
    OR unions children grouped by their representative term
    (executor._eval_scores: children[0][1] propagates up)."""
    node = _normalize_node(node)
    if node is None or node.kind != SearchRequest.OR or node.options:
        return None
    if all(q.kind == SearchRequest.SEARCH for q in node.queries):
        return None  # flat OR: 2-level kernel territory
    supers = []
    for q in node.queries:
        if q.kind == SearchRequest.SEARCH:
            if not _leaf_ok(q.part):
                return None
            supers.append((q.part.terms[0], [[q.part]]))
            continue
        if q.kind != SearchRequest.AND or q.options:
            return None
        groups = []
        for c in q.queries:
            if c.kind == SearchRequest.SEARCH:
                if not _leaf_ok(c.part):
                    return None
                groups.append([c.part])
            elif (
                c.kind == SearchRequest.OR
                and not c.options
                and all(x.kind == SearchRequest.SEARCH for x in c.queries)
            ):
                parts = [x.part for x in c.queries]
                if not all(_leaf_ok(p) for p in parts):
                    return None
                groups.append(parts)
            else:
                return None
        first = q.queries[0]
        repr_term = (
            first.part.terms[0]
            if first.kind == SearchRequest.SEARCH
            else first.queries[0].part.terms[0]
        )
        supers.append((repr_term, groups))
    return supers


def _tree_spec_deep(persistence, comb, node):
    """Deep tree -> gtids [(global_tid, score, deep_packed_slot, ng)] or
    None. ``ng`` is the term's subtree group count (the AND gate
    tree_candidates_deep checks); encoding bounds per DEEP_* shifts."""
    from ..ops.tree_step import (
        DEEP_GROUP_SHIFT,
        DEEP_SUB_SHIFT,
        DEEP_TERM_SHIFT,
    )

    supers = _node_deep(node)
    if supers is None:
        return None
    terms_sorted = sorted({t for t, _g in supers})
    if len(terms_sorted) > (1 << (24 - DEEP_TERM_SHIFT)):
        return None
    term_slot = {t: i for i, t in enumerate(terms_sorted)}
    sub_count: dict = {}
    gtids = []
    for repr_term, groups in supers:
        ts = term_slot[repr_term]
        sub = sub_count.get(ts, 0)
        sub_count[ts] = sub + 1
        if sub >= (1 << (DEEP_TERM_SHIFT - DEEP_SUB_SHIFT)) or len(groups) > (
            1 << (DEEP_SUB_SHIFT - DEEP_GROUP_SHIFT)
        ):
            return None
        ng = len(groups)
        for gi, parts in enumerate(groups):
            term_strings = sorted({p.terms[0] for p in parts})
            if len(term_strings) > (1 << DEEP_GROUP_SHIFT):
                return None
            slots = {t: i for i, t in enumerate(term_strings)}
            for p in parts:
                packed = (
                    (ts << DEEP_TERM_SHIFT)
                    | (sub << DEEP_SUB_SHIFT)
                    | (gi << DEEP_GROUP_SHIFT)
                    | slots[p.terms[0]]
                )
                g = _leaf_gtids(persistence, comb, p, packed)
                if g is None:
                    return None
                gtids.extend((gid, sc, sl, ng) for gid, sc, sl in g)
    if len(gtids) > _MAX_QUERY_TERMS:
        return None
    return gtids


def _walk_fuzzy_specs(persistence, node, out) -> None:
    if node is None:
        return
    for part in node.walk_parts():
        d = part.levenshtein_distance or 0
        if d <= 0 or part.is_regex or len(part.terms) != 1:
            continue
        term = part.terms[0].lower()
        d = min(d, max(len(term) - 1, 0))
        if d <= 0:
            continue
        field = part.path
        if field.endswith(TEXTINDEX):
            field = field[: -len(TEXTINDEX)]
        out.add((field, term, d, bool(part.starts_with)))


def _prefetch_request_fuzzy(persistence, requests) -> None:
    """Bulk-prime the fuzzy match memo for every fuzzy leaf a batch's tree /
    filter / phrase searches will resolve — one batched sweep per field,
    one device sync total (`prefetch_fuzzy_matches`)."""
    from .field_search import prefetch_fuzzy_matches

    specs: set = set()
    for req in requests:
        _walk_fuzzy_specs(persistence, req.search_req, specs)
        _walk_fuzzy_specs(persistence, req.filter, specs)
        for pb in req.phrase_boosts or []:
            for part in (pb.search1, pb.search2):
                d = part.levenshtein_distance or 0
                if d > 0:
                    term = part.terms[0].lower()
                    d = min(d, max(len(term) - 1, 0))
                    if d > 0:
                        field = part.path
                        if field.endswith(TEXTINDEX):
                            field = field[: -len(TEXTINDEX)]
                        specs.add((field, term, d, bool(part.starts_with)))
    if specs:
        prefetch_fuzzy_matches(persistence, specs)


def _tree_spec_flat(persistence, comb, node):
    """Flat tree -> (gtids, num_slots, is_and) with UNPACKED slots — the
    round-2 spec shape still used by the mesh shard kernel. Fuzzy leaves
    qualify (their matches resolve through the memoized field search, which
    on a mesh runs the term-sharded sweep)."""
    if node is None:
        return None
    if node.kind == SearchRequest.SEARCH:
        leaves, is_and = [node.part], False
    elif node.kind in (SearchRequest.OR, SearchRequest.AND) and all(
        q.kind == SearchRequest.SEARCH for q in node.queries
    ):
        leaves = [q.part for q in node.queries]
        is_and = node.kind == SearchRequest.AND
    else:
        return None
    if not all(_leaf_ok(p) for p in leaves):
        return None
    if is_and:
        slot_of = list(range(len(leaves)))
        num_slots = len(leaves)
    else:
        term_strings = sorted({p.terms[0] for p in leaves})
        slots = {t: i for i, t in enumerate(term_strings)}
        slot_of = [slots[p.terms[0]] for p in leaves]
        num_slots = len(term_strings)
    if num_slots > 8:
        return None
    gtids = []
    for part, slot in zip(leaves, slot_of):
        g = _leaf_gtids(persistence, comb, part, slot)
        if g is None:
            return None
        gtids.extend(g)
    return gtids, num_slots, is_and


def _filter_tree_key(node) -> tuple:
    if node.kind == SearchRequest.SEARCH:
        return ("s", node.part.key())
    return (node.kind, tuple(_filter_tree_key(q) for q in node.queries))


def _filter_anchor_list(persistence, node) -> Optional[np.ndarray]:
    """Host-resolved filter anchors — exact parity with the executor's
    `_eval_ids` (reference FilterChannel semantics): the filter subtree
    evaluates ids-only on the host; only the anchor list ships to device.
    Memoized per persistence (requests in a batch share few distinct
    filters — the reference's FieldRequestCache, execution_plan.rs:91-130)."""
    from ..search import boost as boost_mod
    from .field_search import get_term_ids_in_field

    memo = getattr(persistence, "_filter_anchor_cache", None)
    if memo is None:
        memo = persistence._filter_anchor_cache = {}
    tkey = _filter_tree_key(node)
    hit = memo.get(tkey)
    if hit is not None:
        return hit

    num_docs = persistence.num_docs
    if node.kind == SearchRequest.SEARCH:
        fsr = get_term_ids_in_field(
            persistence, node.part, get_scores=False, get_ids=True
        )
        anchors = boost_mod.resolve_ids_to_anchor(
            persistence, fsr.path, fsr.hits_ids
        )
        anchors = anchors[(anchors >= 0) & (anchors < num_docs)]
        out = np.unique(anchors)
    else:
        subs = [_filter_anchor_list(persistence, q) for q in node.queries]
        if not subs:
            out = np.empty(0, dtype=np.int64)
        else:
            out = subs[0]
            for s in subs[1:]:
                out = (
                    np.union1d(out, s)
                    if node.kind == SearchRequest.OR
                    else np.intersect1d(out, s)
                )
    if len(memo) > 4096:
        memo.clear()
    memo[tkey] = out
    return out


def _filter_mask_stack(persistence, entries):
    """Stack of DISTINCT cached filter masks for a group + per-spec slot map.

    The stack is CANONICAL: distinct fkeys sort before stacking, so the
    same filter set arriving in any order reuses one cached device array;
    the row count pads to a bucket (all-False rows) so NF is not a jit
    recompile axis for the generic kernels."""
    import jax.numpy as jnp

    from ..ops.postings import bucket_size

    node_of: dict = {}
    for _qi, req, spec in entries:
        node_of.setdefault(spec["fkey"], req.filter)
    skey = tuple(sorted(node_of))
    fkey_slot = {k: i for i, k in enumerate(skey)}
    memo = getattr(persistence, "_filter_stack_dev", None)
    if memo is None:
        memo = persistence._filter_stack_dev = {}
    stack = memo.get(skey)
    if stack is None:
        masks = [_filter_mask_device(persistence, node_of[k])[1] for k in skey]
        nf_pad = bucket_size(len(masks), 4)
        num_docs = persistence.num_docs
        while len(masks) < nf_pad:
            masks.append(jnp.zeros(num_docs, dtype=bool))
        stack = jnp.stack(masks)
        if len(memo) > 128:
            memo.clear()
        memo[skey] = stack
    return stack, fkey_slot


def _filter_mask_device(persistence, node):
    """Device-resident [num_docs] bool mask for a filter subtree, built ONCE
    per distinct filter (scatter of the host-parity anchor set) and cached —
    the FilterChannel broadcast as a resident vector; per batch only mask
    INDICES ship to the kernel."""
    import jax.numpy as jnp

    memo = getattr(persistence, "_filter_mask_dev", None)
    if memo is None:
        memo = persistence._filter_mask_dev = {}
    tkey = _filter_tree_key(node)
    hit = memo.get(tkey)
    if hit is not None:
        return tkey, hit
    anchors = _filter_anchor_list(persistence, node)
    mask = jnp.zeros(persistence.num_docs, dtype=bool)
    if len(anchors):
        mask = mask.at[jnp.asarray(anchors.astype(np.int32))].set(True)
    if len(memo) > 512:
        memo.clear()
    memo[tkey] = mask
    return tkey, mask


def _generic_eligible(
    request: Request, persistence, comb, require_extras=True, flat=False
):
    """Batched generic-path eligibility: tree (exact / prefix / fuzzy
    leaves, flat or AND-of-ORs) + optional filter / anchor-level boost
    columns / fast-path facets / phrase boosts. Returns a per-request spec
    dict (with a hashable group signature) or None. The mesh path passes
    ``flat=True`` (its shard kernel still takes the round-2 flat spec) and
    ``require_extras=False``."""
    if comb is None or persistence.num_docs < SMALL_DOCS:
        return None
    # why_found is NOT a disqualifier: the kernel answers the search and
    # the emitter attaches why_found metadata from the host-known matches
    # (_attach_why_found) — a why_found-heavy workload still batches
    if any(
        (
            request.boost_term,
            request.text_locality,
            request.explain,
            request.suggest,
        )
    ):
        return None
    if require_extras and not (
        request.filter or request.boost or request.facets or request.phrase_boosts
    ):
        return None  # plain trees belong to the leaner exact/fuzzy kernels
    fuzzy = None
    num_groups = 1
    deep = False
    if flat:
        tree = _tree_spec_flat(persistence, comb, request.search_req)
        if tree is not None:
            gtids, num_slots, is_and = tree
        else:
            # deep (3-alternation) trees ride the mesh too:
            # same gtids spec as the single-chip sorted deep kernel; the
            # shard step evaluates it densely via tree_dense_deep
            dtree = _tree_spec_deep(persistence, comb, request.search_req)
            if dtree is not None:
                gtids, deep = dtree, True
                num_slots, is_and = 1, False
            else:
                fuzzy = _fuzzy_fast_eligible(
                    request, persistence, allow_extras=True
                )
                if fuzzy is None:
                    return None
                gtids, num_slots, is_and = [], 1, False
    else:
        num_slots, is_and = 0, False  # unused by the sorted tree kernel
        # tree first: fuzzy leaves resolve through the prefetched matches,
        # so extras-carrying fuzzy requests ride the sorted tree kernel
        # (exact host-known capacity buckets, cached filter masks). The
        # fully-fused in-program-sweep kernel remains for shapes the tree
        # spec rejects (e.g. leaves matching > _MAX_LEAF_TERMS_FUZZY terms)
        tree = _tree_spec(persistence, comb, request.search_req)
        if tree is not None:
            gtids, num_groups = tree
        else:
            dtree = _tree_spec_deep(persistence, comb, request.search_req)
            if dtree is not None:
                gtids, deep = dtree, True
            else:
                fuzzy = _fuzzy_fast_eligible(
                    request, persistence, allow_extras=True
                )
                if fuzzy is None:
                    return None
                gtids = []

    from ..create import BOOST_VALID_TO_VALUE

    boost_key = []
    for b in request.boost or []:
        if "[]" in b.path:
            return None  # 1:n boost chain -> per-request path
        bp = b.path
        if not bp.endswith(BOOST_VALID_TO_VALUE):
            bp = bp + BOOST_VALID_TO_VALUE
        if not persistence.has_index(bp):
            return None
        boost_key.append(
            (
                bp,
                b.boost_fun or "",
                float(b.param or 0.0),
                tuple(float(s) for s in (b.skip_when_score or ())),
                b.expression or "",
            )
        )

    from .facet import facet_matrix_host

    facet_fields = []
    for f in request.facets or []:
        if facet_matrix_host(persistence, f.field) is None:
            return None
        facet_fields.append(f.field)

    fanchors = None
    fkey = None
    if request.filter is not None:
        fanchors = _filter_anchor_list(persistence, request.filter)
        fkey = _filter_tree_key(request.filter)

    panchors = None
    if request.phrase_boosts:
        panchors = _phrase_anchor_list(persistence, request.phrase_boosts)
        if panchors is None or len(panchors) > _MAX_FILTER_ANCHORS:
            return None

    if fuzzy is not None:
        sig = (
            "fz",
            fuzzy[0],
            tuple(boost_key),
            tuple(facet_fields),
            fanchors is not None,
            panchors is not None,
        )
    elif flat and deep:
        sig = (
            "meshdeep",
            tuple(boost_key),
            tuple(facet_fields),
            fanchors is not None,
            panchors is not None,
        )
    elif flat:
        sig = (
            num_slots,
            is_and,
            tuple(boost_key),
            tuple(facet_fields),
            fanchors is not None,
            panchors is not None,
        )
    else:
        # sorted tree kernel: groups/slots are DYNAMIC — one program per
        # extras shape, not per tree shape; deep (3-alternation) trees get
        # their own compile (the extra scan stages cost the hot shapes
        # nothing)
        sig = (
            "treedeep" if deep else "tree",
            tuple(boost_key),
            tuple(facet_fields),
            fanchors is not None,
            panchors is not None,
        )
    return {
        "sig": sig,
        "gtids": gtids,
        "num_groups": num_groups,
        "num_slots": num_slots,
        "is_and": is_and,
        "fuzzy": fuzzy,
        "deep": deep,
        "fanchors": fanchors,
        "fkey": fkey,
        "panchors": panchors,
        "boost_key": tuple(boost_key),
        "facet_fields": tuple(facet_fields),
    }


def _phrase_anchor_list(persistence, phrase_boosts) -> Optional[np.ndarray]:
    """Phrase-pair anchors with group multiplicity: an anchor appearing in g
    distinct (term1, term2) groups appears g times (factor 5^g in-kernel) —
    mirrors the executor's grouped phrase application (search.rs phrase
    wiring + plan_steps.rs:262-283)."""
    from ..create import PHRASE_PAIR_TO_ANCHOR
    from .field_search import get_term_ids_in_field

    groups: dict = {}
    for pb in phrase_boosts:
        if pb.search1.path != pb.search2.path:
            return None
        r1 = get_term_ids_in_field(
            persistence, pb.search1, get_scores=False, get_ids=True
        )
        r2 = get_term_ids_in_field(
            persistence, pb.search2, get_scores=False, get_ids=True
        )
        path = r1.path + PHRASE_PAIR_TO_ANCHOR
        store = persistence.phrase_indices.get(path)
        if store is None:
            continue
        anchors = store.get_values_for_pairs(r1.hits_ids, r2.hits_ids)
        key = (pb.search1.terms[0], pb.search2.terms[0])
        groups.setdefault(key, []).append(anchors)
    parts = []
    for v in groups.values():
        if not v:
            continue
        merged = np.concatenate(v) if len(v) > 1 else v[0]
        parts.append(np.unique(np.asarray(merged, dtype=np.int64)))
    if not parts:
        return np.empty(0, dtype=np.int64)
    return np.concatenate(parts)


def _plain_eligible(request: Request, persistence, comb):
    """Plain-tree eligibility (no extras): SEARCH / flat OR / flat AND /
    AND-of-ORs over exact, prefix and fuzzy leaves -> (gtids, num_groups);
    OR-of-ANDs / depth-3 trees -> ("deep", gtids4); else None."""
    if persistence.num_docs < SMALL_DOCS:
        return None
    # why_found rides the plain kernels too (see _attach_why_found)
    if any(
        (
            request.filter,
            request.boost,
            request.boost_term,
            request.phrase_boosts,
            request.facets,
            request.text_locality,
            request.explain,
            request.suggest,
        )
    ):
        return None
    tree = _tree_spec(persistence, comb, request.search_req)
    if tree is not None:
        return tree
    deep = _tree_spec_deep(persistence, comb, request.search_req)
    if deep is not None:
        return ("deep", deep)
    return None


def _slice_bucket(runs):
    """(cap_big, cap_rest) pow2 pair for a DESC-sorted run-length profile:
    term j reads one contiguous dynamic_slice of ``_slice_widths(...)[j]``
    rows. cap_rest covers the ladder fit ``run_{j+1} <= cap_rest >> j``."""
    from ..ops.postings import bucket_size

    cap_big = bucket_size(max(runs[0], 1), 64)
    cap_rest = 64
    for j, r in enumerate(runs[1:]):
        b = bucket_size(max(int(r), 1), 64)
        if b > 64:
            # runs <= 64 fit ANY rung (the ladder floors at 64): requiring
            # cap_rest >= 64 << j for them exploded the key space and the
            # width sum for many-term profiles
            cap_rest = max(cap_rest, b << j)
    return cap_big, cap_rest


def _slice_widths(cap_big: int, cap_rest: int, t_pad: int):
    """Static per-term slice ladder (clamped to cap_big, which is <= the
    posting arrays' guaranteed tail padding)."""
    return (cap_big,) + tuple(
        min(max(cap_rest >> j, 64), cap_big) for j in range(t_pad - 1)
    )


def _cap_bucket(n: int, minimum: int = 256) -> int:
    """Capacity bucket: pow2 steps up to 4096, then x4 steps — each distinct
    capacity compiles its own kernel variant and the big-sort variants cost
    tens of seconds each, so the tail is coarse on purpose."""
    from ..ops.postings import bucket_size

    b = bucket_size(n, minimum)
    if b <= 4096:
        return b
    c = 4096
    while c < n:
        c *= 4
    return c


# past this many terms the geometric slice ladder can't fit a zipf run tail
# (fuzzy d=2 at 100k docs matches ~100 terms/query; the (cap_big, cap_rest)
# key space exploded into one fresh compile per generator query)
_MANY_TERMS = 24
_COMPACT_Q = 64  # fixed row shape for many-term compact dispatches
# multi-slot (tree_candidates) capacity ceiling: past this the segmented
# scans' compile time explodes — bigger multi-slot trees take the
# per-request dense executor instead
_MULTI_SLOT_CAP = 16384


def _cap_bucket_pow2(n: int, minimum: int = 2048) -> int:
    """Own-posting-total capacity for MANY-TERM compact resolves: pow2 to
    65536, then x4. Finer than `_cap_bucket`'s tail on purpose — the sort
    runtime scales with width, while the extra kernel variants are absorbed
    once by the warmup grid + persistent compile cache."""
    from ..ops.postings import bucket_size

    b = bucket_size(max(n, 1), minimum)
    if b <= 65536:
        return b
    c = 65536
    while c < n:
        c *= 4
    return c


def _resolve_plan_key(runs, tot: int, sslot: bool):
    """Sub-bucket key for one resolved entry (SHARED by `_run_generic_group`
    and bench.py's serving-route mirror — keep them identical).

    ``runs``: posting run lengths, DESC. Routes:
      * > _MANY_TERMS terms  -> ("m", own-tot pow2 capacity, t tier, sslot):
        per-element compact gather; a small warmup-precompilable grid.
      * slice ladder fits    -> ("s", cap_big, cap_rest, sslot)
      * else                 -> ("c", coarse capacity, sslot)
    """
    from ..ops.postings import MAX_SORT_CAPACITY, bucket_size

    t_n = len(runs)
    if t_n > 256:
        # t512/t1024 variants are very long compiles — route the rare
        # >256-term tree to the per-request dense executor instead of ever
        # compiling one inline
        return ("x",)
    if t_n > _MANY_TERMS:
        cap = _cap_bucket_pow2(tot)
        if not sslot and cap > _MULTI_SLOT_CAP:
            # the MULTI-SLOT tree evaluator's segmented scans at 65536+
            # are very long compiles, same class as the t512 cells.
            # Single-slot (scan-free) cells at the same width compile
            # quickly and stay eligible.
            return ("x",)
        # t tier floors at 128: the gather/fill cost scales with capacity,
        # not t_pad, so padding terms is near-free while halving the number
        # of kernel variants (tiers: 128/256)
        return ("m", cap, bucket_size(t_n, 128), sslot)
    cap_big, cap_rest = _slice_bucket(runs)
    t_pad_q = bucket_size(t_n, 8)
    if sum(_slice_widths(cap_big, cap_rest, t_pad_q)) <= MAX_SORT_CAPACITY:
        return ("s", cap_big, cap_rest, sslot)
    cap = min(_cap_bucket(max(tot, 1)), MAX_SORT_CAPACITY)
    if not sslot and cap > _MULTI_SLOT_CAP:
        return ("x",)  # same multi-slot compile cliff as the "m" route
    return ("c", cap, sslot)


def _why_found_meta(persistence, request):
    """(term_id_hits_in_field, term_text_in_field) for a request, built the
    way the host executor collects them during field search (executor.py's
    search walk): exact leaves bisect the dictionary, fuzzy leaves read the
    memoized device matches (bulk-primed by `_prefetch_request_fuzzy`), so
    a why_found request batching through the fused kernels pays only this
    cheap host walk — not a per-request executor run. Reference:
    search_field.rs stores term_id hits during get_term_ids_in_field;
    why_found.rs:11-49 consumes them."""
    from .field_search import get_term_ids_in_field

    term_id_hits: dict = {}
    term_texts: dict = {}
    for part in request.search_req.walk_parts():
        fsr = get_term_ids_in_field(
            persistence,
            part,
            get_scores=True,
            store_term_id_hits=True,
            store_term_texts=True,
        )
        for path, m in fsr.term_id_hits_in_field.items():
            term_id_hits.setdefault(path, {}).update(m)
        for path, texts in fsr.term_text_in_field.items():
            term_texts.setdefault(path, []).extend(texts)
    return term_id_hits, term_texts


def _attach_why_found(persistence, req, res) -> None:
    """Post-process a batched SearchResult for a why_found request (the
    executor's finalization, executor.py:878,909-911, on the kernel's
    top-k)."""
    from .why_found import get_why_found

    term_id_hits, term_texts = _why_found_meta(persistence, req)
    res.why_found_terms = term_texts
    if req.select is not None:
        res.why_found_info = get_why_found(
            persistence, [h.id for h in res.data], term_id_hits
        )


def _make_emit(results, start, persistence=None):
    """Shared result emitter: kernels return exact (score desc, id desc)
    order — window + wrap into a SearchResult."""
    import time

    def _emit(qi, req, ids, scores, num_hits, facets=None):
        mask = scores > 0
        ids, scores = ids[mask], scores[mask]
        top = req.top if req.top is not None else 10
        skip = req.skip or 0
        res = SearchResult()
        res.num_hits = int(num_hits)
        window = list(zip(ids, scores))[skip : skip + top]
        res.data = [Hit(int(i), float(s)) for i, s in window]
        if facets is not None:
            res.facets = facets
        if req.why_found and persistence is not None:
            _attach_why_found(persistence, req, res)
        res.execution_time_ns = time.time_ns() - start
        results[qi] = res

    return _emit


class _SyncPool:
    """Cross-runner D2H coalescing: runners append ``(device_outputs,
    callback)`` and :meth:`drain` fetches EVERY pending output with ONE
    ``jax.device_get`` per round — one device-to-host sync per round, no
    matter how many runner/field/capacity groups are in flight. Callbacks may append new work (the adaptive-capacity
    re-dispatch contract), which lands in the NEXT round, so fuzzy retries
    coalesce across fields and with the generic groups too."""

    def __init__(self) -> None:
        self.pending: list = []

    def add(self, outs, cb) -> None:
        self.pending.append((outs, cb))

    def drain(self) -> None:
        import jax

        while self.pending:
            batch, self.pending = self.pending, []
            fetched = jax.device_get([o for o, _cb in batch])
            for (_o, cb), f in zip(batch, fetched):
                cb(f)


def search_single_fused(request: Request, persistence) -> Optional[SearchResult]:
    """One request through the batched tree machinery (a batch of one).

    This is the per-request front door for the canonical query-language
    shapes — generator output with auto-levenshtein fuzzy leaves and
    AND-of-ORs (query_generator.rs:85-99), plus filter / boost / facet /
    phrase extras — ONE fused program instead of the executor's per-step
    walk. Returns None when the shape isn't covered (caller falls through
    to the full executor)."""
    import time

    start = time.time_ns()
    if getattr(persistence, "mesh_ctx", None) is not None:
        return None
    if persistence.num_docs < SMALL_DOCS:
        return None
    comb = persistence.device_combined()
    if comb is None:
        return None
    _prefetch_request_fuzzy(persistence, [request])
    results: List[Optional[SearchResult]] = [None]
    emit = _make_emit(results, start, persistence)
    tree = _plain_eligible(request, persistence, comb)
    if tree is not None:
        if tree[0] == "deep":
            spec = {
                "gtids": tree[1],
                "num_groups": 1,
                "fkey": None,
                "panchors": None,
                "deep": True,
            }
            _run_generic_group(
                persistence, comb, ("treedeep", (), (), False, False),
                [(0, request, spec)], emit,
            )
            return results[0]
        gtids, num_groups = tree
        spec = {
            "gtids": gtids,
            "num_groups": num_groups,
            "fkey": None,
            "panchors": None,
        }
        _run_generic_group(
            persistence, comb, ("tree", (), (), False, False),
            [(0, request, spec)], emit,
        )
        return results[0]
    gen = _generic_eligible(request, persistence, comb)
    if gen is None:
        return None
    if gen["sig"][0] == "fz":
        _run_fuzzy_generic_group(
            persistence, gen["sig"], [(0, request, gen)], emit, results,
            fallback=None,
        )
    else:
        _run_generic_group(
            persistence, comb, gen["sig"], [(0, request, gen)], emit
        )
    return results[0]


def search_batch(requests: List[Request], persistence) -> List[SearchResult]:
    """Answer a batch of requests; fast-path-eligible ones share one dispatch
    per distinct-term-count bucket (usually just one)."""
    import time

    import jax.numpy as jnp

    from ..ops.postings import bucket_size
    from ..ops.search_step import batched_single_term_topk

    start = time.time_ns()
    results: List[Optional[SearchResult]] = [None] * len(requests)

    mesh_ctx = getattr(persistence, "mesh_ctx", None)
    if mesh_ctx is not None:
        return _search_batch_mesh(requests, persistence, mesh_ctx, start)

    comb = persistence.device_combined() if persistence.num_docs >= SMALL_DOCS else None

    # plain single-leaf fuzzy -> the fully-fused sweep kernel (no host
    # matching at all); everything else gets its fuzzy leaves bulk-primed
    # by ONE batched sweep per field, then routes: single exact term ->
    # scatter-free slice kernel, trees -> the sorted tree kernel, extras ->
    # the generic/fuzzy-generic kernels, the rest per request
    singles: list = []  # (qi, req, gtids) with exactly one term id
    plain_entries: list = []  # [(qi, req, spec)] for the sorted tree kernel
    fuzzy_groups: dict = {}  # field -> [(qi, req, term, distance)]
    generic_groups: dict = {}  # sig -> [(qi, req, spec)]
    rest: list = []
    # Plain single-leaf fuzzy: by default ride the PREFETCH + tree-kernel
    # route (the generator-shape machinery) — matches come from ONE batched
    # windowed sweep per field, then the resolve dispatches at each query's
    # KNOWN posting capacity (same buckets as exact singles/trees), so there
    # is no blind capacity ladder, no overflow retries and no adaptive-hint
    # drift recompiling shapes between batches. VELOCI_FUZZY_VIA_TREE=0
    # reverts to the fully-fused sweep+resolve kernel (`_run_fuzzy_group`),
    # which also remains the route when no combined CSR exists.
    via_tree = comb is not None and _os.environ.get(
        "VELOCI_FUZZY_VIA_TREE", "1"
    ) != "0"
    for qi, req in enumerate(requests):
        fz = None if via_tree else _fuzzy_fast_eligible(req, persistence)
        if fz is not None:
            field, term, distance = fz
            fuzzy_groups.setdefault(field, []).append((qi, req, term, distance))
            continue
        rest.append((qi, req))
    if comb is not None and rest:
        _prefetch_request_fuzzy(persistence, [req for _qi, req in rest])
    deep_entries: list = []  # 3-alternation trees (deep kernel variant)
    for qi, req in rest:
        tree = _plain_eligible(req, persistence, comb) if comb is not None else None
        if tree is not None:
            if tree[0] == "deep":
                spec = {
                    "gtids": tree[1],
                    "num_groups": 1,
                    "fkey": None,
                    "panchors": None,
                    "deep": True,
                }
                deep_entries.append((qi, req, spec))
                continue
            gtids, num_groups = tree
            if len(gtids) == 1 and num_groups == 1:
                singles.append((qi, req, gtids))
            else:
                spec = {
                    "gtids": gtids,
                    "num_groups": num_groups,
                    "fkey": None,
                    "panchors": None,
                }
                plain_entries.append((qi, req, spec))
            continue
        gen = _generic_eligible(req, persistence, comb)
        if gen is not None:
            generic_groups.setdefault(gen["sig"], []).append((qi, req, gen))
        else:
            results[qi] = search(req, persistence)

    from .stats import count_path

    count_path("batched_single_term", len(singles))
    count_path("batched_tree", len(plain_entries))
    count_path("batched_tree_deep", len(deep_entries))
    for sig, entries in generic_groups.items():
        count_path(
            "batched_fuzzy_generic" if sig[0] == "fz" else "batched_generic",
            len(entries),
        )
    count_path("batched_fuzzy", sum(len(v) for v in fuzzy_groups.values()))

    num_docs = persistence.num_docs
    ho = comb.host_offsets if comb is not None else None
    _emit = _make_emit(results, start, persistence)
    pool = _SyncPool()

    if singles:
        # dominant shape: ONE term id per query -> scatter-free kernel.
        # Sub-bucket by each query's OWN posting count (zipfian: most
        # queries touch tens of postings; one shared capacity would make
        # every query pay for the batch's most common term). All buckets
        # dispatch asynchronously; ONE device_get syncs them all.
        sub: dict = {}
        for qi, req, gtids in singles:
            g = gtids[0][0]
            count = int(ho[g + 1] - ho[g])
            sub.setdefault(bucket_size(max(count, 1)), []).append(
                (qi, req, gtids)
            )
        pending_s = []
        for capacity, entries in sorted(sub.items()):
            max_k = 1
            for qi, req, _g in entries:
                top = req.top if req.top is not None else 10
                max_k = max(max_k, top + (req.skip or 0))
            k_eff = min(num_docs, max_k, capacity)
            q_pad = bucket_size(len(entries), 8)
            tid_arr = np.zeros(q_pad, dtype=np.int32)
            ts_arr = np.zeros(q_pad, dtype=np.float32)
            for row, (_qi, _req, gtids) in enumerate(entries):
                tid_arr[row] = gtids[0][0]
                ts_arr[row] = gtids[0][1]
            out = batched_single_term_topk(
                comb.offsets,
                None,
                None,
                jnp.asarray(tid_arr),
                jnp.asarray(ts_arr),
                capacity=capacity,
                k=k_eff,
                packed=comb.packed,
            )
            pending_s.append((entries, out))

        for entries, out in pending_s:

            def cb(fetched, entries=entries):
                ids_b, scores_b, hits_b = fetched
                for row, (qi, req, _g) in enumerate(entries):
                    _emit(qi, req, ids_b[row], scores_b[row], hits_b[row])

            pool.add(out, cb)

    def _per_request(qi, req):
        # already measured past the fused kernels' limits: go straight to
        # the dense per-step executor (no re-probing dispatches)
        results[qi] = search(req, persistence, dense_only=True)

    if plain_entries:
        _run_generic_group(
            persistence,
            comb,
            ("tree", (), (), False, False),
            plain_entries,
            _emit,
            pool=pool,
            fallback=_per_request,
        )

    if deep_entries:
        _run_generic_group(
            persistence,
            comb,
            ("treedeep", (), (), False, False),
            deep_entries,
            _emit,
            pool=pool,
            fallback=_per_request,
        )

    # generic batches (filter/boost/facet/phrase requests): one fused
    # program each — exact trees and fuzzy leaves take separate kernels
    for sig, entries in generic_groups.items():
        if sig[0] == "fz":
            _run_fuzzy_generic_group(
                persistence, sig, entries, _emit, results, pool=pool,
                fallback=_per_request,
            )
        else:
            _run_generic_group(
                persistence, comb, sig, entries, _emit, pool=pool,
                fallback=_per_request,
            )

    # fuzzy batches: one vmapped fused program per field chunk
    for field, entries in fuzzy_groups.items():
        _run_fuzzy_group(persistence, field, entries, results, start, pool=pool)

    # ONE device-to-host sync per round for EVERYTHING above (retries coalesce
    # across runners/fields into subsequent rounds)
    pool.drain()

    return results  # type: ignore[return-value]


def precompile_tree_grid(persistence, level: str = "fuzzy"):
    """Force-compile the many-term ("m"-route) tree-kernel grid NOW so the
    first fuzzy/generator serve never pays it inline (compiling these one
    by one at first serve stalls it; with the persistent compile cache
    every later process loads them from disk).

    The "m" route's shapes are fully key-determined — (capacity, t tier,
    q tier, slot mode, k=10) over THIS index's posting arrays — so a small
    static grid covers real traffic exactly. ``level``: "fuzzy" compiles
    the single-slot cells (plain fuzzy leaves, t tier 128 at 100k docs);
    "all" adds the multi-slot generator-tree cells (t 256/512).
    Returns the pending device outputs; the caller batches the sync."""
    import jax.numpy as jnp

    from ..ops.postings import MAX_SORT_CAPACITY
    from ..ops.tree_step import batched_tree_topk

    comb = persistence.device_combined()
    if comb is None:
        return []
    num_docs = persistence.num_docs
    cells = [  # (q_pad, t_pad, capacity, single_slot)
        *(
            (q, 128, cap, True)
            for cap in (2048, 4096, 8192, 16384, 32768, 65536)
            for q in (8, 16, 32, _COMPACT_Q)
        ),
    ]
    if level == "all":
        # NO t512 cells, and NO multi-slot cells past _MULTI_SLOT_CAP: a
        # t256 x c65536 multi-slot compile is one very long C call (signal
        # alarms can't interrupt it) — those trees route to the
        # per-request dense executor (_resolve_plan_key)
        cells += [
            (_COMPACT_Q, 128, 4096, False),
            (_COMPACT_Q, 128, 8192, False),
            (_COMPACT_Q, 128, 16384, False),
            (_COMPACT_Q, 256, 16384, False),
        ]
    import time as _time

    pending = []
    for q_pad, t_pad, capacity, sslot in cells:
        if capacity > MAX_SORT_CAPACITY:
            continue
        t_c = _time.time()
        tid = np.full((q_pad, t_pad), -1, dtype=np.int32)
        tid[:, 0] = 0
        out = batched_tree_topk(
            comb.offsets, None, None,
            jnp.asarray(tid),
            jnp.asarray(np.ones((q_pad, t_pad), dtype=np.float32)),
            jnp.asarray(np.zeros((q_pad, t_pad), dtype=np.int32)),
            jnp.asarray(np.ones(q_pad, dtype=np.int32)),
            None, None, None, (), (),
            capacity=capacity, num_docs=num_docs, k=10,
            boost_specs=(), has_phrase=False, packed=comb.packed,
            slice_widths=(), single_slot=sslot,
        )
        # the jit compile blocks HERE (dispatch), so this timing is the
        # cell's compile cost (sync later is ~free)
        pending.append(
            (
                (q_pad, t_pad, capacity, sslot, round(_time.time() - t_c, 1)),
                out,
            )
        )
    return pending


def _run_generic_group(
    persistence, comb, sig, entries, emit, pool=None, fallback=None
) -> None:
    """Dispatch one extras-signature group through the sorted tree kernel
    (`batched_tree_topk`) — cost O(capacity), independent of corpus size.

    Entries sub-group by their OWN capacity bucket (total postings of the
    query's terms, known exactly on the host — fuzzy leaves included, their
    matches are already resolved): under a zipfian term distribution most
    queries need a far smaller sort window than the group max. All
    sub-dispatches are issued asynchronously and synced through ``pool``
    (one D2H round trip shared with every OTHER runner in the batch); a
    local pool drains immediately for the single-request front door."""
    import jax
    import jax.numpy as jnp

    from ..ops.postings import bucket_size
    from ..ops.tree_step import batched_tree_topk
    from .facet import facet_matrix

    _tag, boost_key, facet_fields, has_filter, has_phrase = sig
    deep = _tag == "treedeep"  # 4-tuple gtids with per-subtree AND gates
    num_docs = persistence.num_docs
    ho = comb.host_offsets

    # distinct filter masks (cached device-resident); per query an index
    fmask_stack = None
    fkey_slot: dict = {}
    if has_filter:
        fmask_stack, fkey_slot = _filter_mask_stack(persistence, entries)

    boost_arrays, boost_specs = _boost_device_arrays(persistence, boost_key)
    facet_mats = tuple(facet_matrix(persistence, f)[0] for f in facet_fields)

    from ..ops.postings import MAX_SORT_CAPACITY

    # slice-plan sub-buckets: terms reorder by run length desc onto a
    # geometric width ladder (cap_big, cap_rest, cap_rest/2, ...) so EVERY
    # posting run is read with one contiguous dynamic_slice instead of a
    # per-element gather (slower at runtime and far slower to compile at
    # large capacities). Key = (cap_big, cap_rest, single_slot): a
    # bounded pow2 grid. Queries whose run profile defeats the ladder
    # (many equal large runs) fall back to the compact-gather bucketing.
    sub: dict = {}
    for qi, req, spec in entries:
        gtids = spec["gtids"]
        runs = sorted(
            ((int(ho[e[0] + 1] - ho[e[0]]), e) for e in gtids),
            key=lambda t: -t[0],
        )
        tot = sum(r for r, _e in runs)
        if not runs:
            sub.setdefault(("c", 256, False), []).append((qi, req, spec))
            continue
        if tot > MAX_SORT_CAPACITY:
            # posting total too large for the variadic-sort kernel (the
            # sort state explodes the XLA compile; the dense-plane executor
            # is O(num_docs) and cheaper anyway past ~num_docs/2 postings)
            if fallback is not None:
                fallback(qi, req)
            continue
        gt = [e for _r, e in runs]
        sslot = (
            not deep
            and not has_phrase
            and spec["num_groups"] == 1
            and len({e[2] for e in gt}) == 1
        )
        spec = dict(spec, gtids=gt)
        # route decision (ladder / many-term compact / coarse compact /
        # fallback) is shared with bench.py's serving-route mirror — keep
        # in one place. Ladder admission uses
        # the ACTUAL per-query _slice_widths sum (group assembly below may
        # pad t_pad up to the sub-group max, adding at most 64 * t_pad
        # more — negligible vs the 2M bound).
        key = _resolve_plan_key([r for r, _e in runs], tot, sslot)
        if key[0] == "x":
            if fallback is not None:
                fallback(qi, req)
            continue
        sub.setdefault(key, []).append((qi, req, spec))

    pending = []  # (chunk, device outputs)
    for key, sub_entries in sorted(sub.items()):
        max_terms, max_p, max_k = 1, 1, 1
        for qi, req, spec in sub_entries:
            max_terms = max(max_terms, len(spec["gtids"]))
            if has_phrase:
                max_p = max(max_p, len(spec["panchors"]))
            top = req.top if req.top is not None else 10
            max_k = max(max_k, top + (req.skip or 0))
        t_pad = bucket_size(max_terms, 8)
        p_pad = bucket_size(max_p, 64) if has_phrase else 0
        k_eff = min(num_docs, max_k)
        if key[0] == "s":
            _tag_s, cap_big, cap_rest, single_slot = key
            slice_widths = _slice_widths(cap_big, cap_rest, t_pad)
            capacity = 0
            total_w = sum(slice_widths)
        elif key[0] == "m":
            # many-term compact: the shape is FULLY determined by the key
            # (capacity, t tier, slot mode) + the fixed q tiers below, so
            # warmup can precompile the whole grid (precompile_tree_grid)
            _tag_m, capacity, t_pad, single_slot = key
            slice_widths = ()
            total_w = capacity
        else:
            slice_widths, single_slot = (), key[2]
            capacity = key[1]
            total_w = capacity
        # sort state is [Qc, total_w] x a handful of i32/f32 vectors
        chunk_q = max(1, int(_SORT_BUDGET_BYTES // max(total_w * 64, 1)))
        if key[0] == "m":
            chunk_q = min(chunk_q, _COMPACT_Q)

        for base in range(0, len(sub_entries), chunk_q):
            chunk = sub_entries[base : base + chunk_q]
            qc = len(chunk)
            q_pad = bucket_size(qc, 8)  # bound recompiles across batch sizes
            if key[0] == "m":
                if single_slot:
                    # pow2 q tiers (8/16/32/64): padded rows still pay the
                    # full [q_pad, capacity] sort (13 real queries in a
                    # 64-row tier waste 4.9x). Single-slot cells compile
                    # quickly, so the extra tiers are cheap and
                    # warmup-precompiled.
                    q_pad = min(bucket_size(qc, 8), _COMPACT_Q)
                else:
                    # multi-slot cells are slow compiles — exactly TWO
                    # row shapes (q8 front door, q64 batches)
                    q_pad = 8 if qc <= 8 else _COMPACT_Q
            tid_arr = np.full((q_pad, t_pad), -1, dtype=np.int32)
            ts_arr = np.zeros((q_pad, t_pad), dtype=np.float32)
            sl_arr = np.zeros((q_pad, t_pad), dtype=np.int32)
            ng_arr = np.ones(q_pad, dtype=np.int32)
            tng_arr = np.ones((q_pad, t_pad), dtype=np.int32) if deep else None
            fi_arr = np.zeros(q_pad, dtype=np.int32) if has_filter else None
            pa_arr = (
                np.full((q_pad, p_pad), num_docs, dtype=np.int32)
                if has_phrase
                else None
            )
            for row, (_qi, _req, spec) in enumerate(chunk):
                for j, entry in enumerate(spec["gtids"][:t_pad]):
                    tid_arr[row, j] = entry[0]
                    ts_arr[row, j] = entry[1]
                    sl_arr[row, j] = entry[2]
                    if deep:
                        tng_arr[row, j] = entry[3]
                ng_arr[row] = spec["num_groups"]
                if has_filter:
                    fi_arr[row] = fkey_slot[spec["fkey"]]
                if has_phrase:
                    pa = spec["panchors"]
                    pa_arr[row, : len(pa)] = pa.astype(np.int32)
            out = batched_tree_topk(
                comb.offsets,
                None,
                None,
                jnp.asarray(tid_arr),
                jnp.asarray(ts_arr),
                jnp.asarray(sl_arr),
                jnp.asarray(ng_arr),
                fmask_stack,
                jnp.asarray(fi_arr) if has_filter else None,
                jnp.asarray(pa_arr) if has_phrase else None,
                tuple(boost_arrays),
                facet_mats,
                capacity=capacity,
                num_docs=num_docs,
                k=k_eff,
                boost_specs=tuple(boost_specs),
                has_phrase=has_phrase,
                packed=comb.packed,
                deep=deep,
                term_ngs=jnp.asarray(tng_arr) if deep else None,
                slice_widths=slice_widths,
                single_slot=single_slot,
            )
            pending.append((chunk, out))

    if not pending:
        return
    local = pool is None
    if local:
        pool = _SyncPool()
    for chunk, out in pending:

        def cb(fetched, chunk=chunk):
            ids_b, scores_b, hits_b, fc_b = fetched
            for row, (qi, req, _spec) in enumerate(chunk):
                facets = (
                    _facets_of(persistence, req, facet_fields, fc_b, row)
                    if facet_fields
                    else None
                )
                emit(qi, req, ids_b[row], scores_b[row], hits_b[row], facets)

        pool.add(out, cb)
    if local:
        pool.drain()


def _boost_device_arrays(persistence, boost_key):
    """(bv, pres, expr_add) device triples + static specs for a boost chain."""
    from .boost import ScoreExpression, _expr_vec_jnp

    boost_arrays, boost_specs = [], []
    for bp, fun, param, skip, expr in boost_key:
        bv, pres = persistence.device_boost(bp)
        expr_add = _expr_vec_jnp(ScoreExpression(expr), bv) if expr else None
        boost_arrays.append((bv, pres, expr_add))
        boost_specs.append((fun, param, skip))
    return tuple(boost_arrays), tuple(boost_specs)


def _facets_of(persistence, req, facet_fields, fc_rows, row):
    from .facet import format_counts

    facets = {}
    for f_req in req.facets or []:
        fi = facet_fields.index(f_req.field)
        facets[f_req.field] = format_counts(
            persistence, f_req.field, fc_rows[fi][row], f_req.top
        )
    return facets


def _run_fuzzy_generic_group(
    persistence, sig, entries, emit, results, fallback=None, pool=None
) -> None:
    """Fuzzy leaf + filter/boost/facet/phrase extras: one fused program per
    chunk (ops/fuzzy_step.batched_fuzzy_generic_topk), with the plain fuzzy
    path's optimistic-capacity re-dispatch contract. ``fallback=None``
    leaves clipped entries as None (single-request mode — the caller's
    executor path handles them) instead of recursing into `search`.
    Dispatches and capacity retries sync through ``pool`` (shared with the
    whole batch when the caller passes one)."""
    import os

    import jax.numpy as jnp

    from ..ops.fuzzy_step import batched_fuzzy_generic_topk
    from ..ops.levenshtein import encode_query
    from ..ops.pallas_levenshtein import use_banded_kernel
    from ..ops.postings import bucket_size
    from .executor import fuzzy_start_capacity, search
    from .facet import facet_matrix

    from ..ops.postings import MAX_SORT_CAPACITY

    _tag, field, boost_key, facet_fields, has_filter, has_phrase = sig
    dev = persistence.device_field(field)
    num_docs = persistence.num_docs
    max_terms = 256
    # the fused fuzzy kernels sort [capacity]-wide — past MAX_SORT_CAPACITY
    # postings the dense-plane executor takes over (truncated rows fall back
    # per-request below)
    worst = min(dev.fuzzy_capacity(max_terms), MAX_SORT_CAPACITY)
    use_banded = use_banded_kernel(max(e[2]["fuzzy"][2] for e in entries))
    boost_arrays, boost_specs = _boost_device_arrays(persistence, boost_key)
    facet_mats = tuple(facet_matrix(persistence, f)[0] for f in facet_fields)

    n_pad, l = dev._chars_host.shape
    if use_banded:
        chunk_q = 128
    else:
        chunk_q = max(1, int(256e6 // max(n_pad * (l + 1) * 4, 1)))
    chunk_q = min(chunk_q, max(1, int(_PLANE_BUDGET_BYTES // max(num_docs * 4, 1))))
    chunk_q = max(1, int(os.environ.get("VELOCI_FUZZY_CHUNK_Q", chunk_q)))

    max_p = max((len(e[2]["panchors"]) for e in entries), default=1) if has_phrase else 0
    p_pad = bucket_size(max(max_p, 1), 64) if has_phrase else 0

    fmask_stack = None
    fkey_slot: dict = {}
    if has_filter:
        fmask_stack, fkey_slot = _filter_mask_stack(persistence, entries)

    local = pool is None
    if local:
        pool = _SyncPool()

    def process_chunk(chunk):
        # a FUNCTION per chunk (not loop-body closures): retry callbacks run
        # during pool.drain(), after the chunk loop has finished, so any
        # free-variable reference to loop-scoped state would resolve to the
        # LAST chunk's bindings and re-dispatch/emit the wrong queries
        #
        c0 = min(worst, fuzzy_start_capacity(persistence, field))

        def dispatch(rows, capacity, first, dv):
            """One fused dispatch for ``rows``; overflowing rows re-dispatch
            ALONE at their own capacity bucket (row-level, parity with the
            plain fuzzy runner — round 3 re-ran the whole chunk, so one hot
            row re-paid everyone's sweep). Rows pad to pow2 so retries of
            arbitrary subset sizes reuse a handful of compile shapes."""
            qc = len(rows)
            q_pad = bucket_size(qc, 8)
            queries = np.zeros((q_pad, 32), dtype=np.uint16)
            qlens = np.zeros(q_pad, dtype=np.int32)
            dists = np.zeros(q_pad, dtype=np.int32)
            fi_arr = np.zeros(q_pad, dtype=np.int32) if has_filter else None
            pa_arr = (
                np.full((q_pad, p_pad), num_docs, dtype=np.int32)
                if has_phrase
                else None
            )
            max_k = 1
            for row, (qi, req, spec) in enumerate(rows):
                _field, term, distance = spec["fuzzy"]
                q, qlen = encode_query(term)
                queries[row] = q
                qlens[row] = qlen
                dists[row] = distance
                if has_filter:
                    fi_arr[row] = fkey_slot[spec["fkey"]]
                if has_phrase:
                    pa = spec["panchors"]
                    pa_arr[row, : len(pa)] = pa.astype(np.int32)
                top = req.top if req.top is not None else 10
                max_k = max(max_k, top + (req.skip or 0))
            k_eff = min(num_docs, max_k)
            out = batched_fuzzy_generic_topk(
                dv.chars_t if use_banded else dv.chars,
                dv.lengths,
                jnp.asarray(queries),
                jnp.asarray(qlens),
                jnp.asarray(dists),
                dv.offsets,
                None,
                None,
                fmask_stack,
                jnp.asarray(fi_arr) if has_filter else None,
                jnp.asarray(pa_arr) if has_phrase else None,
                boost_arrays,
                facet_mats,
                max_terms=max_terms,
                capacity=capacity,
                num_docs=num_docs,
                k=k_eff,
                banded=use_banded,
                boost_specs=boost_specs,
                packed=dv.packed,
                sweep_ids=dv.sweep_ids,
                band=(2 if int(dists.max()) <= 2 else 4) if use_banded else 4,
            )

            def cb(fetched, rows=rows, capacity=capacity, first=first, dv=dv):
                ids_b, scores_b, hits_b, totals_b, post_b, fc_b = fetched
                if first and len(rows):
                    # sticky capacity hint tracks the workload's p75 (bounded
                    # one bucket move per batch) — a high-water mark pinned
                    # every later batch to the worst query ever seen
                    p75 = bucket_size(
                        max(int(np.percentile(post_b[: len(rows)], _CAP_PCTL)), 64)
                    )
                    if p75 > capacity:
                        persistence._fuzzy_cap_hint[field] = min(
                            worst, capacity * 2
                        )
                    elif p75 < capacity:
                        persistence._fuzzy_cap_hint[field] = max(
                            64, capacity // 2
                        )
                nxt: dict = {}
                for row, (qi, req, spec) in enumerate(rows):
                    need = int(post_b[row])
                    if int(totals_b[row]) > max_terms:
                        # selection window clipped — per-request path decides
                        if fallback is not None:
                            fallback(qi, req)
                        continue
                    if need <= capacity:
                        facets = (
                            _facets_of(
                                persistence, req, facet_fields, fc_b, row
                            )
                            if facet_fields
                            else None
                        )
                        emit(
                            qi, req, ids_b[row], scores_b[row], hits_b[row],
                            facets,
                        )
                    elif capacity >= worst:
                        # posting total past the sort cap: dense plane
                        if fallback is not None:
                            fallback(qi, req)
                    else:
                        nxt.setdefault(
                            min(worst, _cap_bucket(need)), []
                        ).append((qi, req, spec))
                for cap2, rows2 in sorted(nxt.items()):
                    dispatch(rows2, cap2, False, dv)

            pool.add(out, cb)

        # lev(a,b) >= |len(a)-len(b)|: rows group by their length-window
        # sweep variant (see _run_fuzzy_group) and dispatch per group
        by_var: dict = {}
        for row in chunk:
            _f, term, distance = row[2]["fuzzy"]
            v = dev.length_window_variant(
                len(term) - distance, len(term) + distance
            )
            by_var.setdefault(id(v), (v, []))[1].append(row)
        for v, rows in by_var.values():
            dispatch(rows, c0, True, v)

    for base in range(0, len(entries), chunk_q):
        process_chunk(entries[base : base + chunk_q])
    if local:
        pool.drain()


def _run_fuzzy_group(persistence, field, entries, results, start, pool=None) -> None:
    import os
    import time

    import jax.numpy as jnp

    from ..ops.fuzzy_step import (
        batched_fuzzy_search_topk,
        batched_fuzzy_search_topk_banded,
    )
    from ..ops.levenshtein import encode_query
    from ..ops.pallas_levenshtein import use_banded_kernel
    from ..ops.postings import bucket_size
    from .executor import fuzzy_start_capacity

    from ..ops.postings import MAX_SORT_CAPACITY

    dev = persistence.device_field(field)
    num_docs = persistence.num_docs
    max_terms = 256
    # sorted-run resolve is a [capacity]-wide sort: cap it; rows whose
    # posting total exceeds the cap fall back to the dense-plane executor
    worst = min(dev.fuzzy_capacity(max_terms), MAX_SORT_CAPACITY)
    use_banded = use_banded_kernel(max(e[3] for e in entries))
    # the banded kernel keeps its DP state in registers, so chunks can be
    # large; the XLA sweep materialises [Qc, N, L+1] i32 rows
    n_pad, l = dev._chars_host.shape
    if use_banded:
        chunk_q = 128
    else:
        chunk_q = max(1, int(256e6 // max(n_pad * (l + 1) * 4, 1)))
    chunk_q = max(1, int(os.environ.get("VELOCI_FUZZY_CHUNK_Q", chunk_q)))
    step = (
        batched_fuzzy_search_topk_banded if use_banded else batched_fuzzy_search_topk
    )
    # lev(a,b) >= |len(a)-len(b)|: each row sweeps only the length-window
    # slice [qlen-d, qlen+d] of the length-sorted matrix. Windows round to
    # LW_BLOCK rows / pow2 widths so a handful of cached variants (sharing
    # the posting uploads) cover all queries; when a window wouldn't pay
    # it degrades to the short (qlen+d <= SHORT_SWEEP_MAX) or full matrix.
    def row_variant(row) -> "object":
        _qi, _req, term, distance = row
        return dev.length_window_variant(
            len(term) - distance, len(term) + distance
        )

    def dispatch(chunk_rows, capacity, mt, dv=dev):
        """One fused dispatch for a list of (qi, req, term, distance)."""
        chars_arg = dv.chars_t if use_banded else dv.chars
        qc = len(chunk_rows)
        q_pad = bucket_size(qc, 8)
        queries = np.zeros((q_pad, 32), dtype=np.uint16)
        qlens = np.zeros(q_pad, dtype=np.int32)
        dists = np.zeros(q_pad, dtype=np.int32)
        max_k = 1
        for row, (qi, req, term, distance) in enumerate(chunk_rows):
            q, qlen = encode_query(term)
            queries[row] = q
            qlens[row] = qlen
            dists[row] = distance
            top = req.top if req.top is not None else 10
            max_k = max(max_k, top + (req.skip or 0))
        k_eff = min(num_docs, max_k)
        kw = {}
        if use_banded:
            # d<=2 chunks run the narrow +-2 Ukkonen band (~45% less DP);
            # auto-lev traffic is d<=2 so ONE band-2 compile covers it
            kw["band"] = 2 if int(dists.max()) <= 2 else 4
        return step(
            chars_arg,
            dv.lengths,
            jnp.asarray(queries),
            jnp.asarray(qlens),
            jnp.asarray(dists),
            dv.offsets,
            None,
            None,
            max_terms=mt,
            capacity=capacity,
            num_docs=num_docs,
            k=k_eff,
            packed=dv.packed,
            sweep_ids=dv.sweep_ids,
            **kw,
        )

    def emit_row(qi, req, ids, scores, nh):
        # kernel output is exact (score desc, id desc) — window + emit
        mask = scores > 0
        ids, scores = ids[mask], scores[mask]
        top = req.top if req.top is not None else 10
        skip = req.skip or 0
        res = SearchResult()
        res.num_hits = int(nh)
        window = list(zip(ids, scores))[skip : skip + top]
        res.data = [Hit(int(i), float(s)) for i, s in window]
        res.execution_time_ns = time.time_ns() - start
        results[qi] = res

    local = pool is None
    if local:
        pool = _SyncPool()

    def process_chunk(chunk):
        # a FUNCTION per chunk: retry callbacks run during pool.drain(),
        # after the chunk loop finished — loop-body closures would late-bind
        # the LAST chunk's needs/matches/finalize and re-run its rounds
        #
        # pass 1: everyone at the sticky per-field capacity hint and a SMALL
        # selection window. Optimistic under-provisioning is FINE — the
        # kernel reports each query's exact match count and posting total,
        # and only overflowing rows re-dispatch at their own bucket /
        # max_terms=256. The common zipfian case pays the small-capacity
        # cost (the sorted-run resolve AND the block select are
        # O(capacity) / O(window)), not the batch worst case.
        c0 = min(worst, fuzzy_start_capacity(persistence, field))
        mt_hints = getattr(persistence, "_fuzzy_mt_hint", None)
        if mt_hints is None:
            mt_hints = persistence._fuzzy_mt_hint = {}
        mt0 = mt_hints.get(field, 64)
        by_var: dict = {}
        for row in chunk:
            v = row_variant(row)
            by_var.setdefault(id(v), (v, []))[1].append(row)
        work = [(rows, c0, mt0, v) for v, rows in by_var.values()]
        needs: list = []
        matches: list = []

        def finalize():
            # sticky hints jump STRAIGHT to the workload's p75 bucket (the
            # one-bucket-per-batch walk converged over several batches, and
            # every intermediate hint value compiled its own kernel shape, so
            # later serving passes still paid fresh compiles; a direct set
            # reaches the fixed point in
            # one batch and an oscillating workload only alternates between
            # two ALREADY-COMPILED shapes): capacity AND the selection
            # window — a d=2-heavy workload where most queries match >64
            # terms should start wide instead of paying a retry round
            if needs:
                p75 = bucket_size(max(int(np.percentile(needs, _CAP_PCTL)), 64))
                if p75 != c0:
                    persistence._fuzzy_cap_hint[field] = min(worst, max(64, p75))
            if matches:
                p75m = int(np.percentile(matches, 75))
                mt_hints[field] = (
                    64 if p75m <= 64 else (128 if p75m <= 128 else 256)
                )

        def start_round(work):
            nxt: dict = {}
            vmap: dict = {}
            remaining = {"n": len(work)}
            for rows, cap, mt, dv in work:
                out = dispatch(rows, cap, mt, dv)

                def cb(fetched, rows=rows, cap=cap, mt=mt, dv=dv):
                    ids_b, scores_b, hits_b, totals_b, post_b = fetched
                    vmap[id(dv)] = dv
                    for row, (qi, req, term, distance) in enumerate(rows):
                        tm = int(totals_b[row])
                        need = int(post_b[row])
                        matches.append(tm)
                        if tm > 256:
                            # selection window clipped: every fused window
                            # is 256 too, so go straight to the dense path
                            results[qi] = search(
                                req, persistence, dense_only=True
                            )
                            continue
                        if tm > mt:
                            # more matches than the small window: retry wide
                            # (the posting total under the small window
                            # undercounts, so the retry capacity stays
                            # optimistic and may grow once more)
                            nxt.setdefault(
                                (
                                    min(worst, _cap_bucket(max(need, cap))),
                                    256,
                                    id(dv),
                                ),
                                [],
                            ).append((qi, req, term, distance))
                            continue
                        needs.append(need)
                        if need <= cap:
                            emit_row(
                                qi, req, ids_b[row], scores_b[row], hits_b[row]
                            )
                        elif cap >= worst:
                            # posting total past the sort cap: exact answer
                            # needs the dense-plane executor (skip the fast
                            # paths — they would re-run the same ladder)
                            results[qi] = search(
                                req, persistence, dense_only=True
                            )
                        else:
                            nxt.setdefault(
                                (
                                    min(worst, _cap_bucket(need)),
                                    mt,
                                    id(dv),
                                ),
                                [],
                            ).append((qi, req, term, distance))
                    remaining["n"] -= 1
                    if remaining["n"] == 0:
                        work2 = [
                            (rows2, cap2, mt2, vmap[vid])
                            for (cap2, mt2, vid), rows2 in sorted(nxt.items())
                        ]
                        if work2:
                            start_round(work2)
                        else:
                            finalize()

                pool.add(out, cb)

        start_round(work)

    for base in range(0, len(entries), chunk_q):
        process_chunk(entries[base : base + chunk_q])
    if local:
        pool.drain()


def _search_batch_mesh(requests, persistence, mc, start) -> List[SearchResult]:
    """Batched serving over the attached mesh: generic-eligible exact trees
    (with or without filter/boost/facet/phrase extras) group into ONE
    sharded program each (`MeshContext.generic_batch`); everything else
    falls back to per-request `search()` (which routes to mesh_search)."""
    import time

    from ..ops.postings import bucket_size
    from .facet import format_counts

    results: List[Optional[SearchResult]] = [None] * len(requests)
    comb = mc.combined()

    if comb is not None:
        # bulk-prime fuzzy leaves (term-sharded sweeps; one per distinct leaf)
        _prefetch_request_fuzzy(persistence, requests)
    groups: dict = {}
    for qi, req in enumerate(requests):
        spec = (
            _generic_eligible(
                req, persistence, comb, require_extras=False, flat=True
            )
            if comb is not None
            else None
        )
        if spec is None or spec["fuzzy"] is not None:
            results[qi] = search(req, persistence)
            continue
        groups.setdefault(spec["sig"], []).append((qi, req, spec))

    num_docs = persistence.num_docs
    pending = []  # (entries_chunk, facet_fields, device outputs)
    for sig, entries in groups.items():
        deep = sig[0] == "meshdeep"
        if deep:
            # deep (OR-of-ANDs / depth-3) trees: same uniform mesh route,
            # dense structure maps instead of flat slots
            _tag, boost_key, facet_fields, has_filter, has_phrase = sig
            num_slots, is_and = 1, False
        else:
            num_slots, is_and, boost_key, facet_fields, has_filter, has_phrase = sig
        ho = comb.host_offsets  # [D, num_keys + 2] per-shard offsets

        # distinct filter masks cached device-resident PER SHARD (the
        # FilterChannel broadcast as sharded vectors); per query an index —
        # no per-batch anchor shipping, no anchor-count ceiling
        fmask_stack = None
        fkey_slot: dict = {}
        if has_filter:
            node_of: dict = {}
            for _qi, req, spec in entries:
                node_of.setdefault(spec["fkey"], req.filter)
            skey = tuple(sorted(node_of))
            fkey_slot = {k: i for i, k in enumerate(skey)}
            fmask_stack = mc.filter_mask_stack(skey, node_of)

        # per-chip plane budget bounds the vmapped query count per dispatch
        if deep:
            plane_rows = bucket_size(
                max(
                    (
                        len({g[2] for g in spec["gtids"]})
                        for _qi, _req, spec in entries
                    ),
                    default=1,
                ),
                8,
            )
        else:
            plane_rows = num_slots
        plane_bytes = plane_rows * (mc.dps + 1) * 4 + mc.dps * 8
        chunk_q = max(1, int(_PLANE_BUDGET_BYTES // max(plane_bytes, 1)))

        for cbase in range(0, len(entries), chunk_q):
            chunk = entries[cbase : cbase + chunk_q]
            max_terms, max_total, max_p, max_k = 1, 1, 1, 1
            for qi, req, spec in chunk:
                gtids = spec["gtids"]
                max_terms = max(max_terms, len(gtids))
                if gtids:
                    safe = np.array([g[0] for g in gtids], dtype=np.int64)
                    per_shard = (ho[:, safe + 1] - ho[:, safe]).sum(axis=1)
                    max_total = max(max_total, int(per_shard.max()))
                if has_phrase:
                    max_p = max(max_p, len(spec["panchors"]))
                top = req.top if req.top is not None else 10
                max_k = max(max_k, top + (req.skip or 0))
            t_pad = bucket_size(max_terms, 8)
            capacity = bucket_size(max_total)
            p_pad = bucket_size(max_p, 64) if has_phrase else 0
            k_eff = min(num_docs, max_k)

            qc = len(chunk)
            q_pad = bucket_size(qc, 8)  # bound recompiles across batch sizes
            tid_arr = np.full((q_pad, t_pad), -1, dtype=np.int32)
            ts_arr = np.zeros((q_pad, t_pad), dtype=np.float32)
            sl_arr = np.zeros((q_pad, t_pad), dtype=np.int32)
            fi_arr = np.zeros(q_pad, dtype=np.int32) if has_filter else None
            pa_arr = (
                np.full((q_pad, p_pad), num_docs, dtype=np.int32)
                if has_phrase
                else None
            )
            deep_maps = None
            deep_terms = 0
            if deep:
                from ..ops.tree_step import (
                    DEEP_GROUP_SHIFT,
                    DEEP_SUB_SHIFT,
                    DEEP_TERM_SHIFT,
                )

                # compact per-query structure maps (plane -> group ->
                # subtree -> repr term); pads alias segment 0, which is
                # harmless — their planes carry no postings, so every
                # contribution is already zero
                s_max = g_max = ns_max = nt_max = 1
                decoded = []
                for _qi, _req, spec in chunk:
                    packs = sorted({g[2] for g in spec["gtids"]})
                    decoded.append(packs)
                    s_max = max(s_max, len(packs))
                    g_max = max(
                        g_max, len({p >> DEEP_GROUP_SHIFT for p in packs})
                    )
                    ns_max = max(
                        ns_max, len({p >> DEEP_SUB_SHIFT for p in packs})
                    )
                    nt_max = max(
                        nt_max, len({p >> DEEP_TERM_SHIFT for p in packs})
                    )
                s_pad = bucket_size(s_max, 8)
                g_pad = bucket_size(g_max, 8)
                ns_pad = bucket_size(ns_max, 8)
                deep_terms = bucket_size(nt_max, 8)
                num_slots = s_pad
                s2g = np.zeros((q_pad, s_pad), np.int32)
                g2s = np.zeros((q_pad, g_pad), np.int32)
                s2t = np.zeros((q_pad, ns_pad), np.int32)
                ngs = np.zeros((q_pad, ns_pad), np.float32)

            for row, (_qi, _req, spec) in enumerate(chunk):
                if deep:
                    packs = decoded[row]
                    plane_of = {p: i for i, p in enumerate(packs)}
                    group_of = {
                        g: i
                        for i, g in enumerate(
                            sorted({p >> DEEP_GROUP_SHIFT for p in packs})
                        )
                    }
                    sub_of = {
                        s: i
                        for i, s in enumerate(
                            sorted({p >> DEEP_SUB_SHIFT for p in packs})
                        )
                    }
                    term_of = {
                        t: i
                        for i, t in enumerate(
                            sorted({p >> DEEP_TERM_SHIFT for p in packs})
                        )
                    }
                    for p, i in plane_of.items():
                        s2g[row, i] = group_of[p >> DEEP_GROUP_SHIFT]
                    for g, i in group_of.items():
                        g2s[row, i] = sub_of[
                            g >> (DEEP_SUB_SHIFT - DEEP_GROUP_SHIFT)
                        ]
                    for sv, i in sub_of.items():
                        s2t[row, i] = term_of[
                            sv >> (DEEP_TERM_SHIFT - DEEP_SUB_SHIFT)
                        ]
                    for gid, sc, p, ng in spec["gtids"]:
                        ngs[row, sub_of[p >> DEEP_SUB_SHIFT]] = float(ng)
                    for j, (gid, sc, p, _ng) in enumerate(
                        spec["gtids"][:t_pad]
                    ):
                        tid_arr[row, j] = gid
                        ts_arr[row, j] = sc
                        sl_arr[row, j] = plane_of[p]
                else:
                    for j, (g, sc, sl) in enumerate(spec["gtids"][:t_pad]):
                        tid_arr[row, j] = g
                        ts_arr[row, j] = sc
                        sl_arr[row, j] = sl
                if has_filter:
                    fi_arr[row] = fkey_slot[spec["fkey"]]
                if has_phrase:
                    pa = spec["panchors"]
                    pa_arr[row, : len(pa)] = pa.astype(np.int32)

            if deep:
                deep_maps = (s2g, g2s, s2t, ngs)
            out = mc.generic_batch(
                tid_arr, ts_arr, sl_arr, fmask_stack, fi_arr, pa_arr,
                boost_key, facet_fields,
                num_slots=num_slots, is_and=is_and, k=k_eff, capacity=capacity,
                deep_maps=deep_maps, deep_terms=deep_terms,
            )
            pending.append((chunk, facet_fields, out))

    if pending:
        import jax

        fetched = jax.device_get([p[2] for p in pending])  # ONE sync
        for (chunk, facet_fields, _), (ids_r, scores_r, hits_r, counts_r) in zip(
            pending, fetched
        ):
            ids_b, scores_b, hits_b = ids_r[0], scores_r[0], hits_r[0]
            fc_b = list(counts_r)
            for row, (qi, req, _spec) in enumerate(chunk):
                mask = scores_b[row] > 0
                ids, scores = ids_b[row][mask], scores_b[row][mask]
                top = req.top if req.top is not None else 10
                skip = req.skip or 0
                res = SearchResult()
                res.num_hits = int(hits_b[row])
                window = list(zip(ids, scores))[skip : skip + top]
                res.data = [Hit(int(i), float(s)) for i, s in window]
                if facet_fields:
                    res.facets = _facets_of(
                        persistence, req, facet_fields, fc_b, row
                    )
                if req.why_found:
                    _attach_why_found(persistence, req, res)
                res.execution_time_ns = time.time_ns() - start
                results[qi] = res

    return results  # type: ignore[return-value]
