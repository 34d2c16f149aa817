"""Device top-k over dense score vectors with exact tie-breaking.

Result order parity with the reference requires sorting by
(score desc, id desc) — `sort_by_score_and_id`, src/search.rs:122-130.

A flat `lax.top_k` over the whole ``[num_docs]`` plane sorts the full
plane. The selection here is **two-stage and exact**:

1. reshape the plane into 128-wide blocks and take per-block maxima — one
   streaming pass over device memory,
2. `lax.top_k` over the tiny block-max vector picks the k candidate blocks
   (ties prefer the lower block index — `lax.top_k` is stable, which the
   proof below needs),
3. gather those blocks in position order and `lax.top_k` the candidates.

Exactness (incl. ties): rank elements by (value desc, position asc). If a
true top-k element x lived in a non-selected block B, each of the k selected
blocks S satisfies (bmax_S, pos_S) >= (bmax_B, pos_B) lexicographically, so
S's max element outranks x (greater value, or equal value at a strictly
earlier position since blocks are disjoint position ranges). That yields k
elements ranked above x — contradiction. Candidate blocks are re-sorted
into position order before stage 3 so the stable `top_k` tie-break remains
global position order.

(id desc) tie order is obtained by running the selection over the reversed
plane: position asc there = id desc. No overfetch, no host-side lexsort, no
fallback path.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "topk_positions",
    "topk_dense_exact",
    "top_k_scores",
    "dense_to_hits",
]

_BLOCK = 128


def topk_positions(vals: jax.Array, k: int, block: int | None = None):
    """Exact top-k of a 1-D vector by (value desc, position asc).

    Returns ``(positions int32[k], values[k])``. When fewer than ``k``
    entries exist (short vectors), the tail is padded with ``-inf`` values
    at position 0 — callers filter on a score threshold anyway. Traceable /
    vmap-safe; composes inside larger jitted programs.

    ``block`` balances the two stages (stage-2 candidate set is k*block):
    for large k the default narrows to 64, because the candidate top_k
    dominates there and halves with the block.
    """
    n = vals.shape[0]
    if block is None:
        block = 64 if k >= 128 else _BLOCK
    nb = max(1, -(-n // block))
    pad = nb * block - n
    v = jnp.pad(vals, (0, pad), constant_values=-jnp.inf) if pad else vals
    blocks = v.reshape(nb, block)
    bmax = blocks.max(axis=1)
    kb = min(k, nb)
    if kb >= nb:
        # degenerate: every block is a candidate — selection is one top_k
        kk = min(k, nb * block)
        cs, ci = jax.lax.top_k(v, kk)
        pos = ci
    else:
        _, bsel = jax.lax.top_k(bmax, kb)
        bsel = jnp.sort(bsel)  # candidate blocks back into position order
        cand = blocks[bsel].reshape(kb * block)
        kk = min(k, kb * block)
        cs, ci = jax.lax.top_k(cand, kk)
        pos = bsel[ci // block] * block + (ci % block)
    pos = jnp.where(jnp.isfinite(cs), pos, 0).astype(jnp.int32)
    if kk < k:
        pos = jnp.pad(pos, (0, k - kk))
        cs = jnp.pad(cs, (0, k - kk), constant_values=-jnp.inf)
    return pos, cs


def topk_dense_exact(dense: jax.Array, k: int, block: int = _BLOCK):
    """Exact top-k by (score desc, id desc) over a dense ``[n]`` score plane.

    Returns ``(ids int32[k], scores f32[k])``; entries beyond the real hit
    count carry non-positive scores (misses are 0.0, padding is -inf) and
    are filtered by callers.
    """
    n = dense.shape[0]
    pos, scores = topk_positions(dense[::-1], k, block=block)
    ids = (n - 1) - pos
    ids = jnp.where(jnp.isfinite(scores), ids, 0).astype(jnp.int32)
    return ids, scores


@partial(jax.jit, static_argnames=("k",))
def _topk_dense_kernel(dense: jax.Array, k: int):
    return topk_dense_exact(dense, k)


def top_k_scores(dense, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Top-k hits (ids, scores) ordered by (score desc, id desc).

    Device path used by the generic executor when the dense plane lives on
    the device. Exact — the two-stage selection already encodes the
    reference's tie-break, so no host re-sort is needed.
    """
    n = int(dense.shape[0])
    ids, scores = _topk_dense_kernel(dense, min(k, n))
    scores = np.asarray(scores)
    ids = np.asarray(ids)
    mask = scores > 0
    return ids[mask].astype(np.uint32), scores[mask]


def dense_to_hits(dense, k: int | None = None) -> Tuple[np.ndarray, np.ndarray]:
    """Exact: all hits ordered by (score desc, id desc) — host numpy path."""
    scores = np.asarray(dense)
    ids = np.flatnonzero(scores > 0)
    s = scores[ids]
    order = np.lexsort((-ids.astype(np.int64), -s.astype(np.float64)))
    if k is not None:
        order = order[:k]
    return ids[order].astype(np.uint32), s[order]
