"""Facet counting over column indices.

Reference: src/facet.rs. The device formulation: the (source -> target)
relation is a fixed pair list, so counting targets over a hit set is one
masked segment-sum / bincount over the whole relation — no per-id pointer
chasing (`count_values_for_ids` / `AggregationCollector`).

The fast path uses `.anchor_to_text_id` (1:n facet fields) or the root
field's `.parent_to_value_id`; the slow path composes the
`parent_to_value_id` join chain (facet.rs:31-93).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..create import ANCHOR_TO_TEXT_ID, PARENT_TO_VALUE_ID
from ..indices import Direct, EMPTY
from ..utils import get_steps_to_anchor

__all__ = ["get_facet", "facet_matrix", "format_counts"]

# batched-path gates: the dense relation matrix M [num_docs, G] f32 lives
# in device memory once per (persistence, field); cap its size so
# high-cardinality facets fall back to the per-request path
FACET_MAX_TARGETS = 512
FACET_MAX_BYTES = 256 * 1024 * 1024

# per-persistence device relation cache: (id(persistence), path) ->
# (sources_dev, targets_dev, num_targets)
_DEVICE_PAIRS: dict = {}


def _device_facet_counts(persistence, path: str, store, dense):
    """On-chip facet counting: counts = segment_sum(hit[src], target)."""
    import jax
    import jax.numpy as jnp

    key = (id(persistence), path)
    cached = _DEVICE_PAIRS.get(key)
    if cached is None:
        sources, targets = _pairs_of(store)
        num_targets = int(targets.max()) + 1 if len(targets) else 1
        cached = (
            jnp.asarray(sources.astype(np.int32)),
            jnp.asarray(targets.astype(np.int32)),
            num_targets,
        )
        if len(_DEVICE_PAIRS) > 256:
            _DEVICE_PAIRS.clear()
        _DEVICE_PAIRS[key] = cached
    sources_d, targets_d, num_targets = cached
    return _count_kernel(dense, sources_d, targets_d, num_targets)


def _count_kernel_impl(dense_v, src, tgt, num_targets):
    import jax
    import jax.numpy as jnp

    mask = dense_v > 0
    n = dense_v.shape[0]
    ok = src < n
    w = jnp.where(ok, mask[jnp.minimum(src, n - 1)], False).astype(jnp.int32)
    return jax.ops.segment_sum(w, tgt, num_segments=num_targets)


def _count_kernel(dense_v, src, tgt, num_targets):
    import jax

    global _COUNT_JIT
    if "_COUNT_JIT" not in globals() or _COUNT_JIT is None:
        _COUNT_JIT = jax.jit(_count_kernel_impl, static_argnames=("num_targets",))
    return _COUNT_JIT(dense_v, src, tgt, num_targets=num_targets)


_COUNT_JIT = None


def facet_matrix_host(persistence, field: str):
    """Host-side dense relation matrix (f32 [num_docs, G]) + G, or None —
    the un-uploaded form of :func:`facet_matrix` (the mesh path shards it
    over devices instead of uploading it whole)."""
    steps = get_steps_to_anchor(field)
    fast_anchor_path = steps[-1] + ANCHOR_TO_TEXT_ID
    if len(steps) == 1:
        path = steps[0] + PARENT_TO_VALUE_ID
    elif persistence.has_index(fast_anchor_path):
        path = fast_anchor_path
    else:
        return None
    store = persistence.key_value_stores.get(path)
    if store is None:
        return None
    key = (id(persistence), "\x02hostmat:" + path)
    cached = _DEVICE_PAIRS.get(key)
    if cached is not None:
        return None if cached == "ineligible" else cached
    def remember(value):
        if len(_DEVICE_PAIRS) > 256:
            _DEVICE_PAIRS.clear()
        _DEVICE_PAIRS[key] = value

    sources, targets = _pairs_of(store)
    num_docs = persistence.num_docs
    keep = sources < num_docs
    sources, targets = sources[keep], targets[keep]
    num_targets = int(targets.max()) + 1 if len(targets) else 1
    if (
        num_targets > FACET_MAX_TARGETS
        or num_docs * num_targets * 4 > FACET_MAX_BYTES
    ):
        # cache the verdict: eligibility probes run per request and must
        # not rebuild (and discard) the matrix each time
        remember("ineligible")
        return None
    m = np.zeros((num_docs, num_targets), dtype=np.float32)
    np.add.at(m, (sources, targets), 1.0)
    if len(sources) and float(m.max()) > 256.0:
        # the host copy is f16 (integers exact to 2^11); a doc with >256
        # pairs for one facet value is rare enough to take the per-request
        # exact path instead
        remember("ineligible")
        return None
    # store as f16 — half the resident host bytes of the f32 build array
    cached = (m.astype(np.float16), num_targets)
    remember(cached)
    return cached


def facet_matrix(persistence, field: str):
    """Device (f32) relation matrix for the batched facet matmul, or None.

    ``M[d, g]`` = number of (doc d -> facet value g) pairs in the fast-path
    relation — the same pairs `get_facet`'s fast path counts with a masked
    bincount (reference count_values_for_ids, facet.rs:95-161). Facet
    counting for a query batch is then ONE matmul: ``counts = hits @ M``
    at full f32 precision (ops/generic_step.facet_counts: exact integer
    counts). None when no fast-path relation exists or the matrix exceeds
    the cardinality/memory gates (FACET_MAX_TARGETS / FACET_MAX_BYTES).
    """
    host = facet_matrix_host(persistence, field)
    if host is None:
        return None
    m, num_targets = host
    key = (id(persistence), "\x02mat:" + field)
    cached = _DEVICE_PAIRS.get(key)
    if cached is not None:
        return cached
    import jax.numpy as jnp

    cached = (jnp.asarray(m.astype(np.float32)), num_targets)
    if len(_DEVICE_PAIRS) > 256:
        _DEVICE_PAIRS.clear()
    _DEVICE_PAIRS[key] = cached
    return cached


def format_counts(persistence, field: str, counts: np.ndarray, top) -> List[Tuple[str, int]]:
    """Counts-per-target-id -> [(value_text, count)] top-n, stable order
    (the shared tail of `get_facet`)."""
    steps = get_steps_to_anchor(field)
    value_ids = np.flatnonzero(counts)
    if len(value_ids) == 0:
        return []
    vals = counts[value_ids]
    order = np.argsort(-vals, kind="stable")
    if top is not None:
        order = order[:top]
    dictionary = persistence.get_dictionary(steps[-1])
    return [
        (dictionary.ord_to_term(int(value_ids[i])), int(vals[i])) for i in order
    ]


def _pairs_of(store) -> Tuple[np.ndarray, np.ndarray]:
    """(sources, targets) pair arrays of a relation column."""
    if isinstance(store, Direct):
        src = np.flatnonzero(store.values != EMPTY)
        return src.astype(np.int64), store.values[src].astype(np.int64)
    counts = np.diff(store.offsets).astype(np.int64)
    src = np.repeat(np.arange(store.num_keys, dtype=np.int64), counts)
    return src, store.values.astype(np.int64)


def get_facet(persistence, facet_req, hit_mask) -> List[Tuple[str, int]]:
    """Count facet values for the hit set; returns [(text, count)] top-n.

    ``hit_mask`` is either a host bool mask or a DEVICE dense score vector —
    in the device case the fast path counts on-chip against cached relation
    pairs (one masked segment-sum), transferring only the counts.
    """
    steps = get_steps_to_anchor(facet_req.field)
    top = facet_req.top
    on_device = not isinstance(hit_mask, np.ndarray)

    fast_anchor_path = steps[-1] + ANCHOR_TO_TEXT_ID
    if len(steps) == 1 or persistence.has_index(fast_anchor_path):
        path = (
            steps[0] + PARENT_TO_VALUE_ID if len(steps) == 1 else fast_anchor_path
        )
        store = persistence.key_value_stores.get(path)
        if store is None:
            return []
        if on_device:
            counts = np.asarray(
                _device_facet_counts(persistence, path, store, hit_mask)
            )
        else:
            sources, targets = _pairs_of(store)
            keep = sources < len(hit_mask)
            sources, targets = sources[keep], targets[keep]
            w = hit_mask[sources]
            counts = np.bincount(targets[w])
    else:
        if on_device:
            hit_mask = np.asarray(hit_mask) > 0
        # slow path: join anchor -> ... -> leaf values (facet.rs:75-93)
        ids = np.flatnonzero(hit_mask).astype(np.int64)
        for step in steps:
            store = persistence.key_value_stores.get(step + PARENT_TO_VALUE_ID)
            if store is None:
                return []
            ids = store.get_values_multi(ids).astype(np.int64)
        counts = np.bincount(ids) if len(ids) else np.zeros(0, np.int64)

    return format_counts(persistence, facet_req.field, counts, top)
