"""Multi-chip index sharding and distributed query execution.

The reference is single-node shared-memory (its sharding exists only as
commented-out code, server/rocket_server.rs:41,102-108 — SURVEY.md §2.4).
Here sharding is first-class:

* **document sharding** (axis ``d``): the anchor-score postings are
  partitioned by anchor range; every device holds the full term dictionary
  (token-id space replicated) plus only its anchor range's postings. Each
  query resolves locally into a dense ``[docs_per_shard]`` score slice;
  per-shard top-k results merge with an ``all_gather`` — the
  replacement for the reference's k-merge of sorted hit lists
  (set_op.rs:159).
* **query-batch parallelism** (axis ``q``): independent queries execute as a
  batch `vmap`'d across the other mesh axis.
* facet counts reduce with a `psum` over ``d``.

All collectives run inside one `shard_map`-ped XLA program.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = [
    "ShardedPostings",
    "ShardedDictionary",
    "sharded_search_topk",
    "sharded_fuzzy_match",
    "build_mesh",
]

# per-shard length-window granularity (rows); pow2 widths bound the compile
# shapes exactly like persistence.LW_BLOCK does single-chip
import os as _os

LW_SHARD_BLOCK = int(_os.environ.get("VELOCI_LW_SHARD_BLOCK", "512"))


def build_mesh(n_docs_shards: int, n_query_shards: int = 1, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    n = n_docs_shards * n_query_shards
    assert len(devices) >= n, f"need {n} devices, have {len(devices)}"
    arr = np.array(devices[:n]).reshape(n_query_shards, n_docs_shards)
    return Mesh(arr, axis_names=("q", "d"))


class ShardedPostings:
    """Anchor-range-sharded postings for one field.

    Device ``i`` (along mesh axis ``d``) holds postings whose anchor lies in
    ``[i * docs_per_shard, (i+1) * docs_per_shard)``, with anchors localised
    to the shard. Arrays are stacked ``[D, ...]`` and placed with a
    NamedSharding over ``d`` so each row lives on its shard.
    """

    def __init__(
        self,
        offsets: np.ndarray,  # [num_keys + 1] global CSR offsets
        anchors: np.ndarray,  # [nnz] global anchor ids
        scores01: np.ndarray,  # [nnz] f32 (score / 100)
        num_docs: int,
        mesh: Mesh,
        axis: str = "d",
    ) -> None:
        d = mesh.shape[axis]
        self.mesh = mesh
        self.axis = axis
        self.num_shards = d
        self.num_docs = num_docs
        self.docs_per_shard = -(-num_docs // d)
        num_keys = len(offsets) - 1
        self.num_keys = num_keys

        counts = np.diff(offsets).astype(np.int64)
        keys = np.repeat(np.arange(num_keys, dtype=np.int64), counts)
        anchors = np.asarray(anchors, dtype=np.int64)
        scores01 = np.asarray(scores01, dtype=np.float32)
        shard_of = anchors // self.docs_per_shard

        per_shard = []
        max_nnz = 1
        for i in range(d):
            sel = shard_of == i
            k = keys[sel]
            a = (anchors[sel] - i * self.docs_per_shard).astype(np.int32)
            s = scores01[sel]
            off = np.zeros(num_keys + 2, dtype=np.int32)
            np.cumsum(np.bincount(k, minlength=num_keys), out=off[1 : num_keys + 1])
            off[num_keys + 1] = off[num_keys]
            per_shard.append((off, a, s))
            max_nnz = max(max_nnz, len(a))

        max_nnz = -(-max_nnz // 128) * 128
        off_stack = np.zeros((d, num_keys + 2), dtype=np.int32)
        a_stack = np.full((d, max_nnz), self.docs_per_shard, dtype=np.int32)
        s_stack = np.zeros((d, max_nnz), dtype=np.float32)
        for i, (off, a, s) in enumerate(per_shard):
            off_stack[i] = off
            a_stack[i, : len(a)] = a
            s_stack[i, : len(s)] = s
        self.max_nnz = max_nnz

        sharding = NamedSharding(mesh, P(axis, None))
        self.offsets = jax.device_put(off_stack, sharding)
        self.anchors = jax.device_put(a_stack, sharding)
        self.scores01 = jax.device_put(s_stack, sharding)


class ShardedDictionary:
    """Term-axis sharding of the fuzzy-sweep char matrix (the tensor-parallel
    analog: each device sweeps its slice of the dictionary; matches merge
    with an all_gather)."""

    def __init__(self, chars: np.ndarray, lengths: np.ndarray, mesh: Mesh, axis: str = "d"):
        d = mesh.shape[axis]
        n = chars.shape[0]
        per = -(-n // d)
        per = -(-per // 128) * 128
        n_pad = per * d
        chars_p = np.zeros((n_pad, chars.shape[1]), dtype=chars.dtype)
        chars_p[:n] = chars
        lens_p = np.zeros(n_pad, dtype=np.int32)
        lens_p[: len(lengths)] = lengths
        self.mesh = mesh
        self.axis = axis
        self.terms_per_shard = per
        self.num_terms = n
        sharding = NamedSharding(mesh, P(axis, None))
        self.chars = jax.device_put(chars_p.reshape(d, per, chars.shape[1]), sharding)
        self.lengths = jax.device_put(
            lens_p.reshape(d, per), NamedSharding(mesh, P(axis, None))
        )
        self._chars_host = chars_p
        self._lens_host = lens_p
        self._ls = None  # lazy locally-length-sorted layout

    def length_sorted(self):
        """Locally length-sorted layout for window pruning: each shard's
        slice sorted by term length (pads first), with a local-row -> GLOBAL
        term-id remap and per-shard length boundaries. Local sorting keeps
        the shards balanced — a GLOBAL length sort would concentrate each
        query's window rows on one device (lev(a,b) >= |len(a)-len(b)| makes
        windows length-contiguous)."""
        if self._ls is None:
            d = self.mesh.shape[self.axis]
            per = self.terms_per_shard
            max_l = self._chars_host.shape[1]
            chars3 = self._chars_host.reshape(d, per, max_l)
            lens2 = self._lens_host.reshape(d, per)
            chars_ls = np.empty_like(chars3)
            lens_ls = np.empty_like(lens2)
            remap = np.full((d, per), -1, dtype=np.int32)
            cum = np.empty((d, max_l + 2), dtype=np.int64)
            for s in range(d):
                order = np.argsort(lens2[s], kind="stable")
                chars_ls[s] = chars3[s][order]
                lens_ls[s] = lens2[s][order]
                gids = order + s * per
                remap[s] = np.where(gids < self.num_terms, gids, -1)
                cum[s] = np.searchsorted(lens_ls[s], np.arange(max_l + 2))
            sharding = NamedSharding(self.mesh, P(self.axis, None))
            self._ls = (
                jax.device_put(chars_ls, sharding),
                jax.device_put(lens_ls, sharding),
                jax.device_put(remap, sharding),
                cum,
            )
        return self._ls


def sharded_fuzzy_match(
    dictionary: ShardedDictionary,
    query: np.ndarray,  # [MAX_QUERY_CHARS] uint16
    query_len: int,
    distance: int,
    max_matches_per_shard: int = 256,
    starts_with: bool = False,
    min_len: Optional[int] = None,
    max_len: Optional[int] = None,
):
    """Distributed fuzzy term match: per-shard Levenshtein sweep + top-M
    select, all_gather of the per-shard matches. Returns
    (term_ids [D*M] global ids or -1, distances [D*M], is_prefix [D*M],
    total_matches). The mesh serving path feeds these into the same field
    search the single-chip path uses (field_search._match_fuzzy_device).

    With ``min_len``/``max_len`` set (and not ``starts_with``), each shard
    sweeps only its length-window slice [min_len, max_len] of the locally
    length-sorted layout (lev(a,b) >= |len(a)-len(b)|): a per-shard
    dynamic_slice at the shard's own boundary, one shared pow2 width so the
    program stays single-shape and the shards stay balanced."""
    from ..ops.levenshtein import sweep_select

    mesh = dictionary.mesh
    per = dictionary.terms_per_shard
    max_matches_per_shard = min(max_matches_per_shard, per)

    if min_len is not None and max_len is not None and not starts_with:
        from ..ops.postings import bucket_size

        chars_ls, lens_ls, remap_ls, cum = dictionary.length_sorted()
        max_l = cum.shape[1] - 2
        lo = cum[:, max(min(min_len, max_l + 1), 0)]
        hi = cum[:, max(min(max_len + 1, max_l + 1), 0)]
        blk = LW_SHARD_BLOCK
        lo_r = (lo // blk) * blk
        width = bucket_size(int(max(hi - lo_r)) if len(lo_r) else 1, blk)
        if width < 0.75 * per:
            width = min(width, per)
            mm = min(max_matches_per_shard, width)
            lo_dev = jax.device_put(
                lo_r.astype(np.int32), NamedSharding(mesh, P(dictionary.axis))
            )

            def step_w(chars, lens, remap, lo_s, q, qlen, dist):
                chars, lens = chars[0], lens[0]
                remap, lo_s = remap[0], lo_s[0]
                cw = jax.lax.dynamic_slice(
                    chars, (lo_s, 0), (width, chars.shape[1])
                )
                lw = jax.lax.dynamic_slice(lens, (lo_s,), (width,))
                rw = jax.lax.dynamic_slice(remap, (lo_s,), (width,))
                sel_ids, sel_dist, sel_prefix, total = sweep_select(
                    cw, lw, q, qlen, dist, jnp.bool_(False),
                    max_matches=mm, remap=rw,
                )
                all_ids = jax.lax.all_gather(sel_ids, "d").reshape(-1)
                all_dist = jax.lax.all_gather(sel_dist, "d").reshape(-1)
                all_prefix = jax.lax.all_gather(sel_prefix, "d").reshape(-1)
                all_total = jax.lax.psum(total, "d")
                return (
                    all_ids[None], all_dist[None], all_prefix[None],
                    all_total[None],
                )

            ax = dictionary.axis
            fn = jax.jit(
                jax.shard_map(
                    step_w,
                    mesh=mesh,
                    in_specs=(
                        P(ax, None, None), P(ax, None), P(ax, None), P(ax),
                        P(), P(), P(),
                    ),
                    out_specs=(
                        P(None, None), P(None, None), P(None, None), P(None),
                    ),
                    check_vma=False,
                )
            )
            ids, dists, prefixes, total = fn(
                chars_ls, lens_ls, remap_ls, lo_dev,
                jnp.asarray(query), jnp.int32(query_len), jnp.int32(distance),
            )
            return (
                np.asarray(ids[0]),
                np.asarray(dists[0]),
                np.asarray(prefixes[0]),
                int(total[0]),
            )

    def step(chars, lens, q, qlen, dist):
        chars, lens = chars[0], lens[0]
        sel_ids, sel_dist, sel_prefix, total = sweep_select(
            chars, lens, q, qlen, dist, jnp.bool_(starts_with),
            max_matches=max_matches_per_shard,
        )
        base = jax.lax.axis_index("d").astype(jnp.int32) * per
        gids = jnp.where(sel_ids >= 0, sel_ids + base, -1)
        all_ids = jax.lax.all_gather(gids, "d").reshape(-1)
        all_dist = jax.lax.all_gather(sel_dist, "d").reshape(-1)
        all_prefix = jax.lax.all_gather(sel_prefix, "d").reshape(-1)
        all_total = jax.lax.psum(total, "d")
        return all_ids[None], all_dist[None], all_prefix[None], all_total[None]

    fn = jax.jit(
        jax.shard_map(
            step,
            mesh=mesh,
            in_specs=(P("d", None, None), P("d", None), P(), P(), P()),
            out_specs=(P(None, None), P(None, None), P(None, None), P(None)),
            check_vma=False,
        )
    )
    ids, dists, prefixes, total = fn(
        dictionary.chars,
        dictionary.lengths,
        jnp.asarray(query),
        jnp.int32(query_len),
        jnp.int32(distance),
    )
    return (
        np.asarray(ids[0]),
        np.asarray(dists[0]),
        np.asarray(prefixes[0]),
        int(np.asarray(total[0])),
    )


def _local_resolve_dense(
    offsets, anchors, scores01, term_ids, term_scores, capacity: int, docs: int
):
    """Per-shard ragged gather -> dense [docs] score slice (trace-time body)."""
    t_pad = term_ids.shape[0]
    valid = term_ids >= 0
    safe = jnp.where(valid, term_ids, 0)
    starts = offsets[safe]
    counts = jnp.where(valid, offsets[safe + 1] - starts, 0)
    out_starts = jnp.concatenate(
        [jnp.zeros(1, dtype=jnp.int32), jnp.cumsum(counts, dtype=jnp.int32)]
    )
    total = out_starts[t_pad]
    idx = jnp.arange(capacity, dtype=jnp.int32)
    seg = jnp.minimum(
        jnp.searchsorted(out_starts[1:], idx, side="right").astype(jnp.int32),
        t_pad - 1,
    )
    in_range = idx < total
    src = jnp.where(in_range, starts[seg] + (idx - out_starts[seg]), 0)
    a = jnp.where(in_range, anchors[src], docs)
    s = jnp.where(in_range, scores01[src] * term_scores[seg], -jnp.inf)
    dense = jax.ops.segment_max(s, a, num_segments=docs + 1)[:docs]
    return jnp.where(jnp.isfinite(dense), dense, 0.0)


def sharded_search_topk(
    postings: ShardedPostings,
    term_ids: np.ndarray,  # [Q, T] int32, queries x matched terms (pad -1)
    term_scores: np.ndarray,  # [Q, T] f32
    capacity: int,
    k: int,
    facet_segments: Optional[np.ndarray] = None,  # [D, max_nnz] int32 or None
    num_facet_values: int = 0,
) -> Tuple[jax.Array, jax.Array, Optional[jax.Array]]:
    """Distributed batched search: per-shard resolve + top-k, all_gather merge.

    Returns (ids [Q, k] global doc ids, scores [Q, k], facet_counts or None).
    """
    mesh = postings.mesh
    docs = postings.docs_per_shard

    def step(offsets, anchors, scores01, tids, tscores):
        offsets, anchors, scores01 = offsets[0], anchors[0], scores01[0]
        tids, tscores = tids[0], tscores[0]

        def one_query(tid, tsc):
            dense = _local_resolve_dense(
                offsets, anchors, scores01, tid, tsc, capacity, docs
            )
            local_scores, local_ids = jax.lax.top_k(dense, min(k, docs))
            gids = local_ids + jax.lax.axis_index("d") * docs
            all_scores = jax.lax.all_gather(local_scores, "d")  # [D, k]
            all_ids = jax.lax.all_gather(gids, "d")
            merged_scores, pos = jax.lax.top_k(all_scores.reshape(-1), k)
            return all_ids.reshape(-1)[pos], merged_scores

        ids, scores = jax.vmap(one_query)(tids, tscores)
        # re-gather across the query axis so every host sees the full batch
        ids = jax.lax.all_gather(ids, "q").reshape(-1, k)
        scores = jax.lax.all_gather(scores, "q").reshape(-1, k)
        return ids[None], scores[None]

    q = mesh.shape["q"]
    qb = term_ids.shape[0]
    assert qb % q == 0, "query batch must divide the q axis"

    shard_q = NamedSharding(mesh, P("q", None, None))
    tids = jax.device_put(
        np.asarray(term_ids, dtype=np.int32).reshape(q, qb // q, -1), shard_q
    )
    tscores = jax.device_put(
        np.asarray(term_scores, dtype=np.float32).reshape(q, qb // q, -1), shard_q
    )

    fn = jax.jit(
        jax.shard_map(
            step,
            mesh=mesh,
            in_specs=(P("d", None), P("d", None), P("d", None), P("q", None, None), P("q", None, None)),
            out_specs=(P(None, None, None), P(None, None, None)),
            check_vma=False,  # outputs are replicated via the all_gathers
        )
    )
    ids, scores = fn(postings.offsets, postings.anchors, postings.scores01, tids, tscores)
    return ids[0], scores[0], None


def sharded_facet_counts(
    postings: ShardedPostings,
    pair_sources: jax.Array,  # [D, n_pairs] int32 local anchor of each pair
    pair_segments: jax.Array,  # [D, n_pairs] int32 facet value id
    hit_mask: jax.Array,  # [D, docs_per_shard] bool (sharded over d)
    num_values: int,
) -> jax.Array:
    """Facet counting with a psum over the doc shards."""
    mesh = postings.mesh

    def step(sources, segments, mask):
        sources, segments, mask = sources[0], segments[0], mask[0]
        w = mask[sources].astype(jnp.int32)
        local = jax.ops.segment_sum(w, segments, num_segments=num_values)
        total = jax.lax.psum(local, "d")
        return total[None]

    fn = jax.jit(
        jax.shard_map(
            step,
            mesh=mesh,
            in_specs=(P("d", None), P("d", None), P("d", None)),
            out_specs=P(None, None),
            check_vma=False,  # psum output is replicated
        )
    )
    return fn(pair_sources, pair_segments, hit_mask)[0]
