"""Sorted-run tree evaluation: the scatter-free, plane-free query kernel.

The dense generic kernels evaluate the query tree on a
``[num_slots, num_docs]`` score plane (`jax.ops.segment_max` scatter +
top-k over the whole corpus): a per-element scatter, and a plane of
``num_slots * num_docs`` f32 in device memory whose cost *scales with
corpus size* even when a query touches 500 postings.

This module replaces the plane with a **sorted-run** formulation whose cost
scales with ``capacity`` (the actual gathered postings):

1. gather the selected terms' posting runs into ``[capacity]`` arrays
   (`ops.search_step._gather_postings`),
2. ONE variadic `lax.sort` by ``(anchor desc, slot desc, score desc)`` —
   three int32/f32 operands, a fully vectorised bitonic network,
3. segmented scans (associative, O(log n) depth) extract
   - the max score per (anchor, slot)  — per-term dedup-max, the
     reference's sort+dedup in resolve_token_to_anchor
     (search_field.rs:451-465),
   - per (anchor, group): sum of slot maxima x distinct^2 — union
     semantics (set_op.rs:87-220),
   - per anchor: sum over groups, gated on every group hitting — intersect
     semantics (set_op.rs:368-448),
4. exact top-k by (score desc, id desc) directly over the candidate
   positions (anchors appear in descending order, so the stable block
   top-k's position-ascending tie rule IS id-descending).

Tree shapes supported by the ONE kernel (no per-shape recompiles):

* flat OR of leaves   — every slot in group 0,
* flat AND of leaves  — one group per leaf, slot_in 0,
* AND of OR-groups    — the canonical query-generator shape
  (``"a AND b"`` -> AND over per-term field-expanded ORs,
  query_generator.rs:85-99 + execution_plan.rs:272-387),

encoded per term as ``slot = group << GROUP_SHIFT | slot_in_group`` with a
*dynamic* per-query ``num_groups`` (a flat OR is "AND over 1 group").

Extras (same order of operations as `search()`, search.rs:143-228):
filter masks gather at candidate anchors; boost columns precompute their
per-doc factor once per batch and gather at candidates; phrase anchors ride
the SAME sort as pseudo-entries (slot sentinel) and become a segment count
-> ``5^g`` factor (BoostAnchorFromPhraseResults, plan_steps.rs:262-283);
facet counts scatter the final hit set into a dense row only when a query
actually requests facets.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .search_step import _gather_postings
from .topk import topk_positions

__all__ = [
    "batched_tree_topk",
    "tree_candidates",
    "tree_candidates_deep",
    "GROUP_SHIFT",
    "DEEP_GROUP_SHIFT",
    "DEEP_SUB_SHIFT",
    "DEEP_TERM_SHIFT",
]

GROUP_SHIFT = 8  # slot = group << 8 | slot_in_group; <= 256 slots per group
# deep (3-alternation) encoding, still one i32 below the phrase sentinel:
# slot = term_slot << 19 | subtree << 14 | group << 8 | slot_in
#   term_slot: distinct top-level repr terms (<= 32)
#   subtree:   same-term sibling subtrees under the top OR (<= 32)
#   group:     AND children within a subtree (<= 64)
#   slot_in:   distinct term strings within a leaf-OR group (<= 256)
DEEP_GROUP_SHIFT = 8
DEEP_SUB_SHIFT = 14
DEEP_TERM_SHIFT = 19
_PHRASE_SLOT = 1 << 24  # sorts before every real slot (slot desc order)
# plain numpy scalars, NOT jnp: this module is imported lazily from inside
# kernel bodies, so a module-level jnp scalar created during an active jit
# trace would cache a tracer (leaks into every later trace as a phantom
# const buffer -> "Execution supplied N buffers but compiled expected N+1")
_EPS = np.float32(1e-5)
_HIT_EPS = np.float32(1e-30)


def _seg_scan(values, resets):
    """Inclusive segmented sum: per position, the sum of ``values`` from the
    last position where ``resets`` is True (segment start) through here.
    Associative -> O(log n) depth."""

    def comb(x, y):
        fx, vx = x
        fy, vy = y
        return fx | fy, vy + jnp.where(fy, jnp.zeros_like(vx), vx)

    _f, v = jax.lax.associative_scan(comb, (resets, values))
    return v


def _seg_scan2(values_a, values_b, resets):
    """Two segmented sums sharing ONE reset vector in ONE associative scan.

    The tree evaluator's (sum, count) pairs always share their segment
    boundaries; fusing them halves the number of scan passes, and scan
    count is a first-order cost of both run and compile time."""

    def comb(x, y):
        fx, va, vb = x
        fy, wa, wb = y
        keep = jnp.where(fy, jnp.zeros_like(va), va)
        keepb = jnp.where(fy, jnp.zeros_like(vb), vb)
        return fx | fy, wa + keep, wb + keepb

    _f, a, b = jax.lax.associative_scan(comb, (resets, values_a, values_b))
    return a, b


def tree_candidates_single(
    a: jax.Array,  # [cap] int32 anchors (pad -> num_docs)
    s: jax.Array,  # [cap] f32 scores (pad -> -inf)
    num_docs: int,
):
    """Single-slot fast path: every posting row belongs to the SAME leaf
    slot (one fuzzy/prefix leaf's matched term variants), so the whole tree
    evaluation collapses to per-anchor dedup-max — the reference's
    resolve_token_to_anchor sort+dedup (search_field.rs:451-465) — with NO
    segmented scans: after the 2-operand (anchor desc, score desc) sort,
    each anchor's FIRST row is its max. distinct^2 = 1 for a single slot,
    so this equals `tree_candidates` with num_groups=1 and constant slots
    (parity-pinned in tests/test_batch_tree.py)."""
    neg_a, neg_s = jax.lax.sort(
        ((-1 - a).astype(jnp.int32), -s), num_keys=2
    )
    a_s = (-1 - neg_a).astype(jnp.int32)
    s_s = -neg_s
    new_anchor = jnp.concatenate(
        [jnp.ones(1, dtype=bool), a_s[1:] != a_s[:-1]]
    )
    # s_s >= _EPS mirrors tree_candidates' slot_hit gate (isfinite alone
    # admitted scores in (0, _EPS) the general kernel drops)
    cand = (
        new_anchor & (a_s >= 0) & (a_s < num_docs) & (s_s >= _EPS)
    )
    final = jnp.where(cand, s_s, jnp.float32(0.0))
    return a_s, final


def tree_candidates(
    a: jax.Array,  # [cap] int32 anchors (pad -> num_docs)
    s: jax.Array,  # [cap] f32 scores (pad -> -inf)
    slot: jax.Array,  # [cap] int32 packed group<<GROUP_SHIFT|slot_in
    num_docs: int,
    num_groups: jax.Array,  # scalar int32 (dynamic)
    phrase_count: Optional[jax.Array] = None,  # [cap] f32 marker (phrase rows)
):
    """Sorted-run tree evaluation -> (anchors_desc [cap], final [cap]).

    ``final`` is non-zero only at each anchor's last (candidate) position.
    When ``phrase_count`` is given, each anchor's final score multiplies by
    ``5^(#phrase markers in its segment)``.
    """
    neg_a = (-1 - a).astype(jnp.int32)
    neg_slot = (-1 - slot).astype(jnp.int32)
    neg_s = -s
    if phrase_count is None:
        neg_a, neg_slot, neg_s = jax.lax.sort(
            (neg_a, neg_slot, neg_s), num_keys=3
        )
        pcnt_in = None
    else:
        neg_a, neg_slot, neg_s, pcnt_in = jax.lax.sort(
            (neg_a, neg_slot, neg_s, phrase_count), num_keys=3
        )
    a_s = (-1 - neg_a).astype(jnp.int32)
    slot_s = (-1 - neg_slot).astype(jnp.int32)
    s_s = -neg_s
    group_s = slot_s >> GROUP_SHIFT

    true1 = jnp.ones(1, dtype=bool)
    new_anchor = jnp.concatenate([true1, a_s[1:] != a_s[:-1]])
    new_group = new_anchor | jnp.concatenate([true1, group_s[1:] != group_s[:-1]])
    new_slot = new_group | jnp.concatenate([true1, slot_s[1:] != slot_s[:-1]])

    # stage 1: per-(anchor, slot) max = first row of its run (score desc)
    slot_max = jnp.where(new_slot, s_s, jnp.float32(0.0))
    slot_hit = (new_slot & (s_s >= _EPS)).astype(jnp.float32)

    # stage 2: union within each (anchor, group): sum of slot maxima,
    # distinct count, score = sum * distinct^2 (set_op.rs:87-220)
    sum2, cnt2 = _seg_scan2(slot_max, slot_hit, new_group)
    is_g_end = jnp.concatenate([new_group[1:], true1])
    group_score = jnp.where(cnt2 > 0, sum2 * cnt2 * cnt2, jnp.float32(0.0))

    # stage 3: AND over groups per anchor (set_op.rs:368-448); a flat OR is
    # the single-group case
    contrib3 = jnp.where(is_g_end, group_score, jnp.float32(0.0))
    ghit3 = jnp.where(is_g_end & (group_score > 0), jnp.float32(1.0), jnp.float32(0.0))
    sum3, cnt3 = _seg_scan2(contrib3, ghit3, new_anchor)
    is_a_end = jnp.concatenate([new_anchor[1:], true1])
    final = jnp.where(
        cnt3 >= num_groups.astype(jnp.float32), sum3, jnp.float32(0.0)
    )
    if pcnt_in is not None:
        # phrase rows carry s = -inf -> they can never be slot maxima of a
        # real group (they sit in their own sentinel group, whose cnt2 = 0)
        pc = _seg_scan(pcnt_in, new_anchor)
        final = final * jnp.power(jnp.float32(5.0), pc)
    final = jnp.where(
        is_a_end & (a_s >= 0) & (a_s < num_docs), final, jnp.float32(0.0)
    )
    return a_s, final


def _seg_scan_max(values, resets):
    """Inclusive segmented max (identity 0 — tree scores are >= 0)."""

    def comb(x, y):
        fx, vx = x
        fy, vy = y
        return fx | fy, jnp.maximum(vy, jnp.where(fy, jnp.zeros_like(vx), vx))

    _f, v = jax.lax.associative_scan(comb, (resets, values))
    return v


def tree_candidates_deep(
    a: jax.Array,  # [cap] int32 anchors (pad -> num_docs)
    s: jax.Array,  # [cap] f32 scores (pad -> -inf)
    slot: jax.Array,  # [cap] int32 deep-packed (see DEEP_* shifts)
    ng: jax.Array,  # [cap] f32 — the row's SUBTREE group count (AND gate)
    num_docs: int,
    phrase_count: Optional[jax.Array] = None,
):
    """Three-alternation tree evaluation: the host
    executor's recursive composition (_eval_scores) as two more segmented
    stages over the same single sort.

    Per anchor:  OR( AND( OR(leaves) ... ) ... ) =
      stage 1  per (anchor, ..., slot): dedup-max            (resolve)
      stage 2  per (..., group): sum of slot maxima x distinct^2   (union)
      stage 3  per (..., subtree): sum over groups, gated on ALL ``ng``
               groups hitting                                (intersect)
      stage 4  per (anchor, term): MAX over same-repr-term subtrees —
               the executor unions children grouped by representative
               term (executor.py OR: max per distinct term)
      stage 5  per anchor: sum of term maxima x distinct^2        (union)
    """
    neg_a = (-1 - a).astype(jnp.int32)
    neg_slot = (-1 - slot).astype(jnp.int32)
    neg_s = -s
    if phrase_count is None:
        neg_a, neg_slot, neg_s, ng_s = jax.lax.sort(
            (neg_a, neg_slot, neg_s, ng), num_keys=3
        )
        pcnt_in = None
    else:
        neg_a, neg_slot, neg_s, ng_s, pcnt_in = jax.lax.sort(
            (neg_a, neg_slot, neg_s, ng, phrase_count), num_keys=3
        )
    a_s = (-1 - neg_a).astype(jnp.int32)
    slot_s = (-1 - neg_slot).astype(jnp.int32)
    s_s = -neg_s
    term_s = slot_s >> DEEP_TERM_SHIFT
    sub_s = slot_s >> DEEP_SUB_SHIFT
    group_s = slot_s >> DEEP_GROUP_SHIFT

    true1 = jnp.ones(1, dtype=bool)
    new_anchor = jnp.concatenate([true1, a_s[1:] != a_s[:-1]])
    new_term = new_anchor | jnp.concatenate([true1, term_s[1:] != term_s[:-1]])
    new_sub = new_term | jnp.concatenate([true1, sub_s[1:] != sub_s[:-1]])
    new_group = new_sub | jnp.concatenate([true1, group_s[1:] != group_s[:-1]])
    new_slot = new_group | jnp.concatenate([true1, slot_s[1:] != slot_s[:-1]])

    # stage 1: per-slot max = first row of its run (score desc)
    slot_max = jnp.where(new_slot, s_s, jnp.float32(0.0))
    slot_hit = (new_slot & (s_s >= _EPS)).astype(jnp.float32)

    # stage 2: union within each leaf-OR group
    sum2, cnt2 = _seg_scan2(slot_max, slot_hit, new_group)
    is_g_end = jnp.concatenate([new_group[1:], true1])
    group_score = jnp.where(cnt2 > 0, sum2 * cnt2 * cnt2, jnp.float32(0.0))

    # stage 3: AND over groups within a subtree, gated on ALL ng present
    contrib3 = jnp.where(is_g_end, group_score, jnp.float32(0.0))
    ghit3 = jnp.where(
        is_g_end & (group_score > 0), jnp.float32(1.0), jnp.float32(0.0)
    )
    sum3, cnt3 = _seg_scan2(contrib3, ghit3, new_sub)
    is_s_end = jnp.concatenate([new_sub[1:], true1])
    sub_score = jnp.where(cnt3 >= ng_s, sum3, jnp.float32(0.0))

    # stage 4: max over same-term subtrees
    contrib4 = jnp.where(is_s_end, sub_score, jnp.float32(0.0))
    term_max = _seg_scan_max(contrib4, new_term)
    is_t_end = jnp.concatenate([new_term[1:], true1])

    # stage 5: union over distinct terms per anchor
    contrib5 = jnp.where(is_t_end, term_max, jnp.float32(0.0))
    thit5 = jnp.where(
        is_t_end & (term_max >= _EPS), jnp.float32(1.0), jnp.float32(0.0)
    )
    sum5, cnt5 = _seg_scan2(contrib5, thit5, new_anchor)
    is_a_end = jnp.concatenate([new_anchor[1:], true1])
    final = sum5 * cnt5 * cnt5
    if pcnt_in is not None:
        pc = _seg_scan(pcnt_in, new_anchor)
        final = final * jnp.power(jnp.float32(5.0), pc)
    final = jnp.where(
        is_a_end & (a_s >= 0) & (a_s < num_docs), final, jnp.float32(0.0)
    )
    return a_s, final


def candidates_topk(a_s: jax.Array, final: jax.Array, k: int):
    """Exact (score desc, id desc) top-k over candidate positions.

    ``a_s`` is anchor-descending, so the stable selection's position-asc tie
    rule equals id-desc — the reference's sort_by_score_and_id
    (search.rs:122-130)."""
    vals = jnp.where(final > 0, final, -jnp.inf)
    pos, scores = topk_positions(vals, k)
    ids = jnp.where(scores > 0, a_s[pos], 0).astype(jnp.int32)
    return ids, scores


def _apply_boost_gathered(final, a_s, pre):
    """Gathered-candidate variant of generic_step._apply_boost: the per-doc
    factor arrays (precomputed once per batch) are read only at candidate
    anchors. Common modes use the presence-folded arrays — ONE gather per
    boost instead of three (gathers dominate kernel cost)."""
    mode, fac, pres, skip, expr_add, folded = pre
    safe = jnp.clip(a_s, 0, pres.shape[0] - 1)
    if folded is not None:
        m, a = folded
        boosted = final * m[safe] if m is not None else final
        if a is not None:
            boosted = boosted + a[safe]
        return jnp.where(
            final > 0, jnp.maximum(boosted, _HIT_EPS), final
        )
    fac_g = fac[safe] if fac is not None else None
    pres_g = pres[safe]
    if mode == "mul":
        boosted = final * fac_g
    elif mode == "add":
        boosted = final + fac_g
    elif mode == "replace":
        boosted = fac_g
    else:
        boosted = final
    if expr_add is not None:
        boosted = boosted + expr_add[safe]
    apply_mask = (final > 0) & pres_g
    for sv in skip:
        apply_mask &= jnp.abs(final - jnp.float32(sv)) >= 1e-5
    boosted = jnp.maximum(boosted, _HIT_EPS)
    return jnp.where(apply_mask, boosted, final)


@partial(
    jax.jit,
    static_argnames=(
        "capacity", "num_docs", "k", "boost_specs", "has_phrase", "deep",
        "slice_widths", "single_slot",
    ),
)
def batched_tree_topk(
    offsets: jax.Array,  # [num_keys + 2] int32 (combined-field CSR)
    anchors: jax.Array,  # [nnz_pad] int32 (pad -> num_docs)
    scores01: jax.Array,  # [nnz_pad] f32
    term_ids: jax.Array,  # [Q, T_pad] int32 (pad -1); GLOBAL combined ids
    term_scores: jax.Array,  # [Q, T_pad] f32
    term_slots: jax.Array,  # [Q, T_pad] int32 — group << GROUP_SHIFT | slot_in
    num_groups: jax.Array,  # [Q] int32 — groups that must all hit
    filter_masks: Optional[jax.Array],  # [NF, num_docs] bool | None (cached)
    filter_idx: Optional[jax.Array],  # [Q] int32 into filter_masks | None
    phrase_anchors: Optional[jax.Array],  # [Q, P_pad] int32 (pad num_docs) | None
    boost_arrays: Tuple,  # tuple of (bv [num_docs] f32, pres bool, expr_add|None)
    facet_mats: Tuple,  # tuple of M [num_docs, G_i] f32
    capacity: int,
    num_docs: int,
    k: int,
    boost_specs: Tuple = (),
    has_phrase: bool = False,
    packed: Optional[jax.Array] = None,  # [nnz_pad, 2] i32 interleaved rows
    deep: bool = False,
    term_ngs: Optional[jax.Array] = None,  # [Q, T_pad] i32 subtree AND gates
    slice_widths: Tuple[int, ...] = (),  # static per-term slice ladder
    single_slot: bool = False,  # all rows share one slot: scan-free dedup-max
):
    """A batch of tree queries -> (ids [Q,k], scores [Q,k], num_hits [Q],
    facet_counts tuple of [Q, G_i] i32) — ONE program, cost O(capacity),
    independent of corpus size.

    Order of operations matches `search()` (search.rs:143-228): tree ->
    filter -> boost columns (request order) -> phrase 5^g factors -> facet
    counts over the final hit set -> exact top-k.

    ``deep=True`` switches to the three-alternation evaluator
    (`tree_candidates_deep`): term_slots carry the deep packing, each term's
    ``term_ngs`` is its subtree's AND-gate group count, and ``num_groups``
    is ignored. A separate compile — the hot two-level shapes pay nothing.

    ``slice_widths`` (static, from the host `_slice_plan`) replaces the
    per-element posting gather with one contiguous dynamic_slice per term
    (contiguous reads, and a far smaller program to compile at large
    capacities).
    ``single_slot=True`` (every query is one leaf's term variants) skips
    the segmented scans entirely: dedup-max IS the sorted run's first row.
    """
    from .generic_step import _precompute_boost, facet_counts
    from .search_step import _gather_postings_sliced

    pre_boosts = tuple(
        _precompute_boost(bv, pres, spec + (expr_add,))
        for (bv, pres, expr_add), spec in zip(boost_arrays, boost_specs)
    )

    def one(tids, tscs, tslots, ng, tngs, fidx, panch):
        if slice_widths:
            out = _gather_postings_sliced(
                offsets, tids, tscs, slice_widths, num_docs,
                term_slots=tslots, packed=packed, term_ngs=tngs,
            )
            if deep:
                a, s, slot, ng_row = out
            else:
                a, s, slot = out
                ng_row = None
        elif deep:
            a, s, slot, ng_row = _gather_postings(
                offsets, anchors, scores01, tids, tscs, capacity, num_docs,
                term_slots=tslots, packed=packed, term_ngs=tngs,
            )
        else:
            a, s, slot = _gather_postings(
                offsets, anchors, scores01, tids, tscs, capacity, num_docs,
                term_slots=tslots, packed=packed,
            )
            ng_row = None
        pcnt = None
        if panch is not None:
            # phrase anchors ride the same sort as pseudo-entries
            p = panch.shape[0]
            a = jnp.concatenate([a, panch])
            s = jnp.concatenate([s, jnp.full((p,), -jnp.inf, jnp.float32)])
            slot = jnp.concatenate(
                [slot, jnp.full((p,), _PHRASE_SLOT, jnp.int32)]
            )
            if deep:
                # sentinel gate: the phrase pseudo-subtree can never pass
                ng_row = jnp.concatenate(
                    [ng_row, jnp.full((p,), 1e9, jnp.float32)]
                )
            pcnt = jnp.concatenate(
                [
                    jnp.zeros(a.shape[0] - p, jnp.float32),
                    jnp.where(panch < num_docs, 1.0, 0.0).astype(jnp.float32),
                ]
            )
        if deep:
            a_s, final = tree_candidates_deep(
                a, s, slot, ng_row, num_docs, pcnt
            )
        elif single_slot and pcnt is None:
            a_s, final = tree_candidates_single(a, s, num_docs)
        else:
            a_s, final = tree_candidates(a, s, slot, num_docs, ng, pcnt)
        if fidx is not None:
            safe = jnp.clip(a_s, 0, num_docs - 1)
            final = jnp.where(filter_masks[fidx][safe], final, 0.0)
        for pre in pre_boosts:
            final = _apply_boost_gathered(final, a_s, pre)
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
        ids, scores = candidates_topk(a_s, final, k)
        return ids, scores, num_hits, fc

    in_axes = (
        0, 0, 0, 0,
        0 if term_ngs is not None else None,
        0 if filter_idx is not None else None,
        0 if phrase_anchors is not None else None,
    )
    return jax.vmap(one, in_axes=in_axes)(
        term_ids, term_scores, term_slots, num_groups, term_ngs, filter_idx,
        phrase_anchors,
    )
