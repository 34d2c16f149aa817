"""Fused BATCHED generic search: tree + filter + boost columns + facets in
ONE XLA program, vmapped over a query batch.

This extends the fused exact kernels (ops/search_step.py) to the rest of the
request surface the reference executes through its plan DAG — filter
subtrees (`FilterChannel` broadcast, plan_creator/execution_plan.rs:137-173),
anchor-level boost columns (`add_boost`, src/search/boost.rs:283-379) and
facet counting (`AggregationCollector`, src/facet.rs:95-161) — so that a
batch of filtered + boosted + faceted queries (BASELINE configs 3-5) costs
ONE device dispatch instead of one executor walk per request.

Lowerings:

* the query tree evaluates on a per-slot dense plane (segment-max over the
  gathered posting runs) exactly like union/intersect_search_topk;
* filters are host-resolved anchor sets (exact parity with the host
  executor's `_eval_ids`) materialised ONCE per distinct filter as cached
  device-resident [num_docs] masks; per query only a mask index ships;
* boost columns are resident [num_docs] vectors; each boost family
  precomputes its per-doc factor ONCE per batch (loop-invariant outside the
  vmap) and applies as an elementwise select per query;
* facet counts are ONE matmul: hits [Q, num_docs] x relation matrix
  M [num_docs, G] (M[d,g] = #pairs d->g, precomputed), f32 operands at
  full f32 precision — exact integer counts, no scatter (`facet_counts`).
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .search_step import _gather_postings
from .topk import topk_dense_exact

__all__ = ["batched_generic_topk"]

# numpy, NOT jnp: imported lazily from inside kernel bodies — a jnp scalar
# created during an active trace caches a tracer (see tree_step._EPS note)
_HIT_EPS = np.float32(1e-30)


def facet_counts(hits, m):
    """Exact int32 facet counts ``hits @ m``: hit weights [..., num_docs]
    (0/1, or small integers) against the f32 relation matrix m
    [num_docs, G] at Precision.HIGHEST. Integer sums are exact in f32 below
    2^24. Not bf16: on an H100 the bf16 product with f32 accumulation lost
    1-2 counts per row once XLA fused the hit producer into the GEMM."""
    return jnp.dot(
        hits.astype(jnp.float32), m,
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    ).astype(jnp.int32)


def _precompute_boost(bv, pres, spec):
    """Per-doc boost factor arrays, computed once per batch.

    ``spec`` = (fun, param, skip_when_score tuple, expression add vector flag)
    mirroring RequestBoostPart (reference boost.rs:283-379); the expression
    add vector (if any) is precomputed by the caller and passed as ``bv_expr``
    inside spec position 3 (or None).

    For the common modes (mul/add, no skip_when_score) the presence mask
    FOLDS into the factor arrays (absent -> multiplier 1 / adder 0), so the
    gathered-candidate kernels read ONE array per boost instead of three —
    per-element gathers dominate these kernels.
    """
    fun, param, skip, expr_add = spec
    b = bv + jnp.float32(param or 0.0)
    if fun == "Log10":
        fac, mode = jnp.log10(b), "mul"
    elif fun == "Log2":
        fac, mode = jnp.log2(b), "mul"
    elif fun == "Multiply":
        fac, mode = b, "mul"
    elif fun == "Add":
        fac, mode = b, "add"
    elif fun == "Replace":
        fac, mode = b, "replace"
    else:
        fac, mode = None, "none"
    folded = None
    if not skip and mode in ("mul", "add", "none"):
        if mode == "mul":
            m = jnp.where(pres, fac, jnp.float32(1.0))
            a = (
                jnp.where(pres, expr_add, jnp.float32(0.0))
                if expr_add is not None
                else None
            )
        else:  # add / none
            base = fac if mode == "add" else jnp.zeros_like(bv)
            add_vec = base + expr_add if expr_add is not None else base
            m = None
            a = jnp.where(pres, add_vec, jnp.float32(0.0))
        folded = (m, a)
    return (mode, fac, pres, tuple(skip or ()), expr_add, folded)


def _apply_boost(dense, pre):
    """Elementwise boost application (apply_boost_dense_device parity:
    only existing hits with a present boost value are boosted;
    skip_when_score exempts listed scores; result floored at HIT_EPS)."""
    mode, fac, pres, skip, expr_add, _folded = pre
    if mode == "mul":
        boosted = dense * fac
    elif mode == "add":
        boosted = dense + fac
    elif mode == "replace":
        boosted = fac
    else:
        boosted = dense
    if expr_add is not None:
        boosted = boosted + expr_add
    apply_mask = (dense > 0) & pres
    for sv in skip:
        apply_mask &= jnp.abs(dense - jnp.float32(sv)) >= 1e-5
    boosted = jnp.maximum(boosted, _HIT_EPS)
    return jnp.where(apply_mask, boosted, dense)


def tree_dense(
    offsets, anchors, scores01, tids, tscs, tslots, capacity, nd, num_slots,
    is_and,
):
    """One query's tree -> dense [nd] score vector: gathered posting runs,
    per-slot segment-max plane, union (sum x distinct^2, set_op.rs:87-220)
    or intersect (all-hit mask x sum, set_op.rs:368-448). Shared by the
    single-chip kernel and the mesh shard step (there ``nd`` is the local
    docs-per-shard) so the set-op math exists exactly once."""
    a, s, slot = _gather_postings(
        offsets, anchors, scores01, tids, tscs, capacity, nd,
        term_slots=tslots,
    )
    plane = slot * (nd + 1) + a
    per_slot = jax.ops.segment_max(
        s, plane, num_segments=num_slots * (nd + 1)
    ).reshape(num_slots, nd + 1)[:, :nd]
    per_slot = jnp.where(jnp.isfinite(per_slot), per_slot, 0.0)
    if is_and:
        all_hit = jnp.all(per_slot > 0, axis=0)
        return jnp.where(all_hit, jnp.sum(per_slot, axis=0), 0.0)
    distinct = jnp.sum(per_slot >= 1e-5, axis=0).astype(jnp.float32)
    return jnp.sum(per_slot, axis=0) * distinct * distinct


def tree_dense_deep(
    offsets, anchors, scores01, tids, tscs, tplanes, s2g, g2s, s2t, ng_sub,
    capacity, nd, num_planes, num_groups, num_subs, num_terms,
):
    """One DEEP (3-alternation, OR-of-ANDs) query -> dense [nd] score
    vector: the dense-plane twin of ops/tree_step.tree_candidates_deep's
    five segmented stages (reference execution_plan.rs:272-387 treats
    arbitrary trees uniformly; the host composition is executor._eval_scores).

    Structure is DATA, not program: ``tplanes`` maps each term row to a
    compact leaf-slot plane index, ``s2g``/``g2s``/``s2t`` are per-query
    host-built maps plane->group, group->subtree, subtree->repr-term, and
    ``ng_sub`` is each subtree's AND-gate group count (pads point at
    discard segments / carry +inf gates).

      stage 1  per (plane, doc): dedup-max                       (resolve)
      stage 2  per group: sum of plane maxima x distinct^2        (union)
      stage 3  per subtree: sum over groups, ALL ``ng`` must hit  (intersect)
      stage 4  per repr term: MAX over same-term subtrees
      stage 5  per doc: sum of term maxima x distinct^2           (union)
    """
    a, s, plane_row = _gather_postings(
        offsets, anchors, scores01, tids, tscs, capacity, nd,
        term_slots=tplanes,
    )
    flat = plane_row * (nd + 1) + a
    per_plane = jax.ops.segment_max(
        s, flat, num_segments=num_planes * (nd + 1)
    ).reshape(num_planes, nd + 1)[:, :nd]
    per_plane = jnp.where(jnp.isfinite(per_plane), per_plane, 0.0)
    hit = (per_plane >= 1e-5).astype(jnp.float32)
    # stage 2: union within each leaf-OR group
    g_sum = jax.ops.segment_sum(per_plane, s2g, num_segments=num_groups)
    g_cnt = jax.ops.segment_sum(hit, s2g, num_segments=num_groups)
    g_score = jnp.where(g_cnt > 0, g_sum * g_cnt * g_cnt, 0.0)
    # stage 3: AND over a subtree's groups, gated on ALL ng hitting
    s_sum = jax.ops.segment_sum(g_score, g2s, num_segments=num_subs)
    s_cnt = jax.ops.segment_sum(
        (g_score > 0).astype(jnp.float32), g2s, num_segments=num_subs
    )
    sub_score = jnp.where(s_cnt >= ng_sub[:, None], s_sum, 0.0)
    # stage 4: max over same-repr-term subtrees
    t_max = jax.ops.segment_max(sub_score, s2t, num_segments=num_terms)
    t_max = jnp.where(jnp.isfinite(t_max), t_max, 0.0)
    # stage 5: union over distinct terms
    t_hit = jnp.sum((t_max >= 1e-5).astype(jnp.float32), axis=0)
    return jnp.sum(t_max, axis=0) * t_hit * t_hit


def phrase_factor(panch, nd):
    """Phrase-anchor x5 multiplicative factor over [nd] (an anchor present
    g times gets 5^g — BoostAnchorFromPhraseResults, plan_steps.rs:262-283);
    out-of-range/pad entries land in the discarded sentinel slot."""
    return (
        jnp.ones(nd + 1, dtype=jnp.float32)
        .at[jnp.clip(panch, 0, nd)]
        .multiply(jnp.float32(5.0))[:nd]
    )


@partial(
    jax.jit,
    static_argnames=("capacity", "num_docs", "k", "num_slots", "is_and", "boost_specs"),
)
def batched_generic_topk(
    offsets: jax.Array,  # [num_keys + 2] int32 (combined-field CSR)
    anchors: jax.Array,  # [nnz_pad] int32 (pad -> num_docs)
    scores01: jax.Array,  # [nnz_pad] f32
    term_ids: jax.Array,  # [Q, T_pad] int32 (pad -1); GLOBAL combined ids
    term_scores: jax.Array,  # [Q, T_pad] f32
    term_slots: jax.Array,  # [Q, T_pad] int32
    filter_masks: Optional[jax.Array],  # [NF, num_docs] bool | None (cached)
    filter_idx: Optional[jax.Array],  # [Q] int32 into filter_masks | None
    phrase_anchors: Optional[jax.Array],  # [Q, P_pad] int32 (pad num_docs) | None
    boost_arrays: Tuple,  # tuple of (bv [num_docs] f32, pres [num_docs] bool, expr_add|None)
    facet_mats: Tuple,  # tuple of M [num_docs, G_i] f32
    capacity: int,
    num_docs: int,
    k: int,
    num_slots: int,
    is_and: bool,
    boost_specs: Tuple,  # tuple of (fun, param, skip_tuple) — static
):
    """A batch of generic queries -> (ids [Q,k], scores [Q,k], num_hits [Q],
    facet_counts tuple of [Q, G_i] i32) in one program.

    Order of operations matches `search()` (reference search.rs:143-228):
    tree -> cached filter mask -> boost columns (in request order) -> phrase-anchor
    x5 factors (BoostAnchorFromPhraseResults, plan_steps.rs:262-283; an
    anchor hit by g phrase groups appears g times in its row -> factor 5^g)
    -> facet counts over the final hit set -> exact top-k (score desc,
    id desc ties).
    """
    pre_boosts = tuple(
        _precompute_boost(bv, pres, spec + (expr_add,))
        for (bv, pres, expr_add), spec in zip(boost_arrays, boost_specs)
    )

    def one(tids, tscs, tslots, fidx, panch):
        dense = tree_dense(
            offsets, anchors, scores01, tids, tscs, tslots, capacity,
            num_docs, num_slots, is_and,
        )
        if fidx is not None:
            # distinct filter masks are cached device-resident; per query
            # only a row index ships (the FilterChannel broadcast, built
            # once per filter — zero steady-state H2D)
            dense = jnp.where(filter_masks[fidx], dense, 0.0)
        for pre in pre_boosts:
            dense = _apply_boost(dense, pre)
        if panch is not None:
            dense = dense * phrase_factor(panch, num_docs)
        return dense

    in_axes = (0, 0, 0, 0 if filter_idx is not None else None,
               0 if phrase_anchors is not None else None)
    dense_b = jax.vmap(one, in_axes=in_axes)(
        term_ids, term_scores, term_slots, filter_idx, phrase_anchors
    )

    num_hits = jnp.sum(dense_b > 0, axis=1, dtype=jnp.int32)
    counts = tuple(facet_counts(dense_b > 0, m) for m in facet_mats)
    ids, scores = jax.vmap(lambda d: topk_dense_exact(d, k))(dense_b)
    return ids, scores, num_hits, counts
