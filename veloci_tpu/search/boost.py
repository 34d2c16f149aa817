"""Boost mechanics: field-data boosts, 1:n anchor-boost chains, term boosts,
phrase boosts, text-locality boosts — all as dense per-document vector ops.

Reference: src/search/boost.rs and src/expression.rs. Where the reference
walks sorted hit/boost iterators in lockstep (`apply_boost_from_iter`,
`apply_boost_values_anchor`), the device form aggregates boost
occurrences per anchor (product / sum / last, matching the sequential
semantics) and applies them to the dense score vector elementwise.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..create import (
    BOOST_VALID_TO_VALUE,
    TEXT_ID_TO_ANCHOR,
    TEXTINDEX,
    TOKENS_TO_TEXT_ID,
    VALUE_ID_TO_ANCHOR,
    VALUE_ID_TO_PARENT,
)
from ..error import VelociError
from ..indices import Csr, Direct

_F32 = np.float32

# Dense score vectors encode "no hit" as 0.0; boosts that produce a 0 or
# negative score (e.g. Log10(0 + 1)) must keep the hit alive, so boosted
# scores are floored to this epsilon (reference keeps explicit hit lists and
# so supports 0-scored hits; ranking among <=0 scores is not preserved).
HIT_EPS = _F32(1e-30)

__all__ = [
    "ScoreExpression",
    "apply_boost_scalar",
    "apply_boost_dense",
    "apply_boost_dense_device",
    "boost_to_anchor_values",
    "apply_anchor_boost_values",
    "apply_anchor_boost_values_device",
    "scatter_factor_device",
    "term_boost_factor",
    "term_boost_factor_device",
    "phrase_boost_factor",
    "text_locality_boost",
    "resolve_ids_to_anchor",
]


class ScoreExpression:
    """Tiny `x op y` interpreter with `$SCORE` (reference src/expression.rs)."""

    def __init__(self, expression: str):
        self.expression = expression
        ops: List = []
        current = ""
        for ch in expression:
            if ch == " ":
                try:
                    ops.append(float(current))
                except ValueError:
                    pass
                current = ""
                continue
            current += ch
            if current in ("+", "-", "/", "*", "$SCORE"):
                ops.append(current)
                current = ""
        try:
            ops.append(float(current))
        except ValueError:
            pass
        self.ops = ops

    def get_score(self, rank: float) -> float:
        """IEEE-754 f32 arithmetic exactly like the reference
        (expression.rs:26-46 evaluates `left / right` as Rust f32):
        division by zero yields +/-inf, 0/0 yields NaN — defined, silent
        semantics, not a warning."""

        def val(op):
            return rank if op == "$SCORE" else op

        left = _F32(val(self.ops[0]))
        right = _F32(val(self.ops[2]))
        op = self.ops[1]
        with np.errstate(divide="ignore", invalid="ignore"):
            if op == "/":
                return float(left / right)
            if op == "*":
                return float(left * right)
            if op == "+":
                return float(left + right)
            if op == "-":
                return float(left - right)
        raise VelociError(f"invalid expression {self.expression!r}")


def apply_boost_scalar(score: float, boost_value: float, boost_part) -> float:
    """Single-hit boost application (reference boost.rs:283-379 `apply_boost`)."""
    param = _F32(boost_part.param or 0.0)
    bv = _F32(boost_value) + param
    fun = boost_part.boost_fun
    score = _F32(score)
    # IEEE f32 like the reference: log of 0 is -inf, of negatives NaN
    # (Rust f32::log10, boost.rs:292-309) — defined, not a warning
    with np.errstate(divide="ignore", invalid="ignore"):
        if fun == "Log10":
            score = score * _F32(np.log10(bv))
        elif fun == "Log2":
            score = score * _F32(np.log2(bv))
        elif fun == "Multiply":
            score = score * bv
        elif fun == "Add":
            score = score + bv
        elif fun == "Replace":
            score = bv
    if boost_part.expression:
        score = score + _F32(ScoreExpression(boost_part.expression).get_score(boost_value))
    return float(score)


def apply_boost_dense(
    dense: np.ndarray,
    boost_vals: np.ndarray,
    present: np.ndarray,
    boost_part,
) -> np.ndarray:
    """Apply a boost column to a dense score vector.

    Reference `add_boost` (boost.rs:470+): only existing hits are boosted,
    hits with no boost value are unchanged, `skip_when_score` exempts hits
    whose score is within 1e-5 of a listed value.
    """
    dense = np.asarray(dense, dtype=_F32)
    n = len(dense)
    bv = np.zeros(n, dtype=_F32)
    pres = np.zeros(n, dtype=bool)
    m = min(n, len(boost_vals))
    bv[:m] = boost_vals[:m]
    pres[:m] = present[:m]

    param = _F32(boost_part.param or 0.0)
    b = bv + param
    fun = boost_part.boost_fun
    with np.errstate(divide="ignore", invalid="ignore"):
        if fun == "Log10":
            boosted = dense * np.log10(b, dtype=_F32)
        elif fun == "Log2":
            boosted = dense * np.log2(b, dtype=_F32)
        elif fun == "Multiply":
            boosted = dense * b
        elif fun == "Add":
            boosted = dense + b
        elif fun == "Replace":
            boosted = b.copy()
        else:
            boosted = dense.copy()
    if boost_part.expression:
        expr = ScoreExpression(boost_part.expression)
        # vectorised: expr is "x op y" over ($SCORE -> boost value)
        add = np.array([expr.get_score(float(v)) for v in bv], dtype=_F32) if n < 100000 else _expr_vec(expr, bv)
        boosted = boosted + add

    apply_mask = (dense > 0) & pres
    if boost_part.skip_when_score:
        for sv in boost_part.skip_when_score:
            apply_mask &= np.abs(dense - _F32(sv)) >= 1e-5
    boosted = np.maximum(boosted, HIT_EPS)
    return np.where(apply_mask, boosted, dense).astype(_F32)


def apply_boost_dense_device(dense, boost_vals_j, present_j, boost_part):
    """Device (jnp) mirror of :func:`apply_boost_dense` — the dense vector
    stays in HBM end-to-end (reference add_boost semantics; boost columns
    are uploaded once via ``Persistence.device_boost``)."""
    import jax.numpy as jnp

    param = _F32(boost_part.param or 0.0)
    b = boost_vals_j + param
    fun = boost_part.boost_fun
    if fun == "Log10":
        boosted = dense * jnp.log10(b)
    elif fun == "Log2":
        boosted = dense * jnp.log2(b)
    elif fun == "Multiply":
        boosted = dense * b
    elif fun == "Add":
        boosted = dense + b
    elif fun == "Replace":
        boosted = b
    else:
        boosted = dense
    if boost_part.expression:
        expr = ScoreExpression(boost_part.expression)
        boosted = boosted + _expr_vec_jnp(expr, boost_vals_j)
    apply_mask = (dense > 0) & present_j
    if boost_part.skip_when_score:
        for sv in boost_part.skip_when_score:
            apply_mask &= jnp.abs(dense - _F32(sv)) >= 1e-5
    boosted = jnp.maximum(boosted, HIT_EPS)
    return jnp.where(apply_mask, boosted, dense)


def apply_anchor_boost_values_device(dense, anchors, boost_vals, boost_part):
    """Device (jnp) mirror of :func:`apply_anchor_boost_values`: the small
    (anchor, value) lists stay host-side; only the scatter application runs
    on the dense device vector."""
    import jax.numpy as jnp

    if len(anchors) == 0:
        return dense
    n = dense.shape[0]
    keep = anchors < n
    anchors = np.asarray(anchors)[keep].astype(np.int32)
    boost_vals = np.asarray(boost_vals, dtype=_F32)[keep]
    param = _F32(boost_part.param or 0.0)
    b = boost_vals + param
    fun = boost_part.boost_fun
    hit_mask = dense > 0
    out = dense
    a_j = jnp.asarray(anchors)
    if fun in ("Log10", "Log2", "Multiply"):
        if fun == "Log10":
            with np.errstate(divide="ignore", invalid="ignore"):
                factors = np.log10(b, dtype=_F32)
        elif fun == "Log2":
            with np.errstate(divide="ignore", invalid="ignore"):
                factors = np.log2(b, dtype=_F32)
        else:
            factors = b
        acc = jnp.ones(n, dtype=jnp.float32).at[a_j].multiply(jnp.asarray(factors))
        out = jnp.where(hit_mask, out * acc, out)
    elif fun == "Add":
        acc = jnp.zeros(n, dtype=jnp.float32).at[a_j].add(jnp.asarray(b))
        out = jnp.where(hit_mask, out + acc, out)
    elif fun == "Replace":
        # "last occurrence wins" — dedup on host (XLA scatter order with
        # duplicate indices is unspecified)
        _, last_idx = np.unique(anchors[::-1], return_index=True)
        sel = len(anchors) - 1 - last_idx
        repl = jnp.full(n, jnp.nan, dtype=jnp.float32).at[
            jnp.asarray(anchors[sel])
        ].set(jnp.asarray(b[sel]))
        out = jnp.where(hit_mask & ~jnp.isnan(repl), repl, out)
    if boost_part.expression:
        expr = ScoreExpression(boost_part.expression)
        adds = _expr_vec(expr, boost_vals)
        acc = jnp.zeros(n, dtype=jnp.float32).at[a_j].add(jnp.asarray(adds))
        out = jnp.where(hit_mask, out + acc, out)
    out = jnp.where(hit_mask, jnp.maximum(out, HIT_EPS), out)
    return out


def scatter_factor_device(anchor_groups, num_docs: int, factor_per_group):
    """Multiplicative per-anchor factor built on device from small host
    anchor lists (phrase boosts, term boosts): ones.at[anchors] *= f."""
    import jax.numpy as jnp

    factor = jnp.ones(num_docs, dtype=jnp.float32)
    for anchors, f in zip(anchor_groups, factor_per_group):
        anchors = np.asarray(anchors, dtype=np.int64)
        anchors = anchors[anchors < num_docs]
        if len(anchors) == 0:
            continue
        if np.isscalar(f) or getattr(f, "ndim", 0) == 0:
            vals = jnp.full(len(anchors), _F32(f), dtype=jnp.float32)
        else:
            vals = jnp.asarray(np.asarray(f, dtype=_F32)[: len(anchors)])
        factor = factor.at[jnp.asarray(anchors.astype(np.int32))].multiply(vals)
    return factor


def _expr_vec_jnp(expr: ScoreExpression, ranks):
    import jax.numpy as jnp

    def val(op):
        return ranks if op == "$SCORE" else _F32(op)

    left, op, right = expr.ops[0], expr.ops[1], expr.ops[2]
    a, b = val(left), val(right)
    if op == "/":
        return a / b
    if op == "*":
        return a * b
    if op == "+":
        return a + b
    return a - b


def _expr_vec(expr: ScoreExpression, ranks: np.ndarray) -> np.ndarray:
    def val(op):
        return ranks.astype(_F32) if op == "$SCORE" else _F32(op)

    left, op, right = expr.ops[0], expr.ops[1], expr.ops[2]
    a, b = val(left), val(right)
    if op == "/":
        return (a / b).astype(_F32)
    if op == "*":
        return (a * b).astype(_F32)
    if op == "+":
        return (a + b).astype(_F32)
    return (a - b).astype(_F32)


def resolve_ids_to_anchor(persistence, path: str, ids: np.ndarray) -> np.ndarray:
    """Matched text ids -> anchor ids (ids-only path of
    `resolve_token_to_anchor`, search_field.rs:467-495)."""
    if len(ids) == 0:
        return np.empty(0, dtype=np.int64)
    if persistence.is_anchor_identity_column(path):
        return np.asarray(ids, dtype=np.int64)
    tia = persistence.key_value_stores.get(path + TEXT_ID_TO_ANCHOR)
    if tia is None:
        return np.empty(0, dtype=np.int64)
    return tia.get_values_multi(np.asarray(ids)).astype(np.int64)


def boost_to_anchor_values(
    persistence, field_path: str, boost_part, matched_term_ids: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """The 1:n boost chain (plan step `BoostToAnchor`, plan_steps.rs:207-233):

    token ids -> text ids -> parent value ids -> boost values -> anchors.
    Returns (anchors, boost_values) in parent-value-id order.
    """
    path = field_path if field_path.endswith(TEXTINDEX) else field_path + TEXTINDEX
    field = path[: -len(TEXTINDEX)]

    # resolve_token_hits_to_text_id_ids_only (search_field.rs:561-607)
    ids = np.asarray(matched_term_ids, dtype=np.int64)
    if persistence.tokenize_enabled(field):
        tta = persistence.key_value_stores.get(path + TOKENS_TO_TEXT_ID)
        if tta is not None:
            parts = []
            for tid in ids:
                vals = tta.get_values(int(tid))
                if len(vals):
                    parts.append(vals.astype(np.int64))
                else:
                    parts.append(np.array([tid], dtype=np.int64))
            ids = np.unique(np.concatenate(parts)) if parts else ids

    # text ids -> parent value ids (join_to_parent_ids, search.rs:286-315)
    v2p = persistence.key_value_stores.get(path + VALUE_ID_TO_PARENT)
    if v2p is None:
        return np.empty(0, np.int64), np.empty(0, _F32)
    value_ids = np.unique(v2p.get_values_multi(ids).astype(np.int64))

    # boost values (get_boost_ids_and_resolve_to_anchor, boost.rs:432-468)
    boost_field = boost_part.path
    for suffix in (BOOST_VALID_TO_VALUE,):
        if boost_field.endswith(suffix):
            boost_field = boost_field[: -len(suffix)]
    vals, present = persistence.get_boost(boost_field + BOOST_VALID_TO_VALUE)
    keep = value_ids[(value_ids < len(vals))]
    keep = keep[present[keep]]
    bvals = vals[keep].astype(_F32)

    # value id -> anchor via the BOOST field's .value_id_to_anchor
    # (get_boost_ids_and_resolve_to_anchor, boost.rs:455-468)
    v2a = persistence.key_value_stores.get(boost_field + VALUE_ID_TO_ANCHOR)
    if v2a is None:
        return np.empty(0, np.int64), np.empty(0, _F32)
    anchors = []
    out_vals = []
    for vid, bv in zip(keep, bvals):
        if isinstance(v2a, Direct):
            a = v2a.get_value(int(vid))
        else:
            vs = v2a.get_values(int(vid))
            a = int(vs[0]) if len(vs) else None
        if a is not None:
            anchors.append(a)
            out_vals.append(bv)
    return np.asarray(anchors, dtype=np.int64), np.asarray(out_vals, dtype=_F32)


def anchor_boost_accs(
    n: int, anchors: np.ndarray, boost_vals: np.ndarray, boost_part
):
    """Per-anchor accumulation planes for a 1:n boost: (facmul, addacc,
    repl) host arrays, each None when inactive. Shared by the host, device
    and mesh application paths so float semantics are identical."""
    anchors = np.asarray(anchors)
    keep = anchors < n
    anchors = anchors[keep]
    boost_vals = np.asarray(boost_vals, dtype=_F32)[keep]
    param = _F32(boost_part.param or 0.0)
    b = boost_vals + param
    fun = boost_part.boost_fun
    facmul = addacc = repl = None
    with np.errstate(divide="ignore", invalid="ignore"):
        if fun in ("Log10", "Log2", "Multiply"):
            if fun == "Log10":
                factors = np.log10(b, dtype=_F32)
            elif fun == "Log2":
                factors = np.log2(b, dtype=_F32)
            else:
                factors = b
            facmul = np.ones(n, dtype=_F32)
            np.multiply.at(facmul, anchors, factors)
        elif fun == "Add":
            addacc = np.zeros(n, dtype=_F32)
            np.add.at(addacc, anchors, b)
        elif fun == "Replace":
            repl = np.full(n, np.nan, dtype=_F32)
            repl[anchors] = b  # later occurrences overwrite = "last wins"
    if boost_part.expression:
        expr = ScoreExpression(boost_part.expression)
        adds = _expr_vec(expr, boost_vals)
        if addacc is None:
            addacc = np.zeros(n, dtype=_F32)
        np.add.at(addacc, anchors, adds)
    return facmul, addacc, repl


def apply_anchor_boost_values(
    dense: np.ndarray, anchors: np.ndarray, boost_vals: np.ndarray, boost_part
) -> np.ndarray:
    """Plan step `ApplyAnchorBoost` (apply_boost_values_anchor, boost.rs:255-281):
    each (anchor, boost_value) occurrence applies the boost function once."""
    dense = np.asarray(dense, dtype=_F32)
    if len(anchors) == 0:
        return dense
    n = len(dense)
    facmul, addacc, repl = anchor_boost_accs(n, anchors, boost_vals, boost_part)
    out = dense.copy()
    hit_mask = dense > 0
    if facmul is not None:
        out = np.where(hit_mask, out * facmul, out)
    if repl is not None:
        out = np.where(hit_mask & ~np.isnan(repl), repl, out)
    if addacc is not None:
        out = np.where(hit_mask, out + addacc, out)
    out = np.where(hit_mask, np.maximum(out, HIT_EPS), out)
    return out.astype(_F32)


def term_boost_factor(
    persistence, boost_terms, num_docs: int, field_search_fn
) -> np.ndarray:
    """Multiplicative per-anchor factor for `boost_term`
    (reference apply_boost_term, boost.rs:89-196): each term searched across
    its field, resolved to anchors ids-only; every occurrence multiplies the
    hit score by the part's boost (default 2.0). Resolved anchors are cached
    per part (reference `term_boost_cache`, persistence.rs:67)."""
    factor = np.ones(num_docs, dtype=_F32)
    cache = persistence.term_boost_cache
    for part in boost_terms:
        key = part.key()
        anchors = cache.get(key)
        if anchors is None:
            res = field_search_fn(part, get_scores=False, get_ids=True)
            anchors = resolve_ids_to_anchor(persistence, res.path, res.hits_ids)
            anchors = anchors[anchors < num_docs]
            if len(cache) > 512:
                cache.clear()
            cache[key] = anchors
        if len(anchors) == 0:
            continue
        boost_val = _F32(part.boost if part.boost is not None else 2.0)
        counts = np.bincount(anchors, minlength=num_docs)
        factor *= np.power(boost_val, counts.astype(_F32), dtype=_F32)
    return factor


def term_boost_factor_device(persistence, boost_terms, num_docs: int, field_search_fn):
    """Device mirror of :func:`term_boost_factor`: anchors resolve host-side
    (cached per part), counts scatter on device, factor = boost^counts with
    the same `power` formula as the host path."""
    import jax.numpy as jnp

    factor = jnp.ones(num_docs, dtype=jnp.float32)
    cache = persistence.term_boost_cache
    for part in boost_terms:
        key = part.key()
        anchors = cache.get(key)
        if anchors is None:
            res = field_search_fn(part, get_scores=False, get_ids=True)
            anchors = resolve_ids_to_anchor(persistence, res.path, res.hits_ids)
            anchors = anchors[anchors < num_docs]
            if len(cache) > 512:
                cache.clear()
            cache[key] = anchors
        if len(anchors) == 0:
            continue
        boost_val = _F32(part.boost if part.boost is not None else 2.0)
        counts = jnp.zeros(num_docs, dtype=jnp.float32).at[
            jnp.asarray(np.asarray(anchors, dtype=np.int32))
        ].add(1.0)
        factor = factor * jnp.power(boost_val, counts)
    return factor


def phrase_boost_factor(
    phrase_anchor_groups: List[np.ndarray], num_docs: int
) -> np.ndarray:
    """Per-anchor multiplicative factor from phrase-pair hits.

    Reference `BoostAnchorFromPhraseResults` (plan_steps.rs:262-283): groups
    (one per distinct phrase) each boost matching anchors by 5.0.
    """
    factor = np.ones(num_docs, dtype=_F32)
    for anchors in phrase_anchor_groups:
        anchors = np.unique(np.asarray(anchors, dtype=np.int64))
        anchors = anchors[anchors < num_docs]
        factor[anchors] *= _F32(5.0)
    return factor


def text_locality_boost(
    persistence, term_id_hits_in_field: Dict[str, Dict[str, List[int]]], num_docs: int
) -> np.ndarray:
    """Text-locality boost factor per anchor.

    Reference boost_text_locality / boost_text_locality_all (boost.rs:11-87):
    texts hit by multiple distinct query terms get `2 * n^2` (n = number of
    term hits landing in the same text); per anchor the reference's merge
    keeps the entry selected by its reversed comparator — i.e. the MINIMUM
    boost (boost.rs:25, faithfully reproduced).
    """
    all_anchors: List[np.ndarray] = []
    all_boosts: List[np.ndarray] = []
    for path, term_with_ids in term_id_hits_in_field.items():
        if len(term_with_ids) <= 1:
            continue
        tta = persistence.key_value_stores.get(path + TOKENS_TO_TEXT_ID)
        if tta is None:
            continue
        text_id_lists = []
        for _term, ids in term_with_ids.items():
            text_id_lists.append(tta.get_values_multi(np.asarray(ids, np.int64)))
        concat = np.concatenate(text_id_lists) if text_id_lists else np.empty(0, np.uint32)
        if len(concat) == 0:
            continue
        counts = np.bincount(concat.astype(np.int64))
        text_ids = np.flatnonzero(counts > 1)
        if len(text_ids) == 0:
            continue
        n_hits = counts[text_ids].astype(_F32)
        boosts = _F32(2.0) * n_hits * n_hits
        if persistence.is_anchor_identity_column(path):
            all_anchors.append(text_ids.astype(np.int64))
            all_boosts.append(boosts)
        else:
            tia = persistence.key_value_stores.get(path + TEXT_ID_TO_ANCHOR)
            if tia is None:
                continue
            for tid, bv in zip(text_ids, boosts):
                anchors = tia.get_values(int(tid))
                if len(anchors):
                    all_anchors.append(anchors.astype(np.int64))
                    all_boosts.append(np.full(len(anchors), bv, dtype=_F32))

    factor = np.ones(num_docs, dtype=_F32)
    if not all_anchors:
        return factor
    anchors = np.concatenate(all_anchors)
    boosts = np.concatenate(all_boosts)
    keep = anchors < num_docs
    anchors, boosts = anchors[keep], boosts[keep]
    best = np.full(num_docs, np.inf, dtype=_F32)
    np.minimum.at(best, anchors, boosts)
    has = np.isfinite(best)
    factor[has] = best[has]
    return factor
