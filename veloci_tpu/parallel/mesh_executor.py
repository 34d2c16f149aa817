"""Mesh serving path: the FULL generic request surface executed over a
document-sharded `jax.sharding.Mesh` — reachable from ``search()``.

The dense-vector execution model shards naturally on the document axis:
every ``[num_docs]`` score/mask/factor vector becomes ``[D, docs_per_shard]``
with a ``NamedSharding(P("d", None))``. Per-shard work (posting resolve,
set ops, boosts, filters) is local — elementwise ops on sharded arrays need
no communication at all; the only collectives are the per-query top-k merge
(`all_gather`), the hit-count `psum`, and facet-count `psum` —
exactly the reference's k-merge/filter-broadcast seams (set_op.rs:159,
plan_steps.rs:357-366) mapped onto collectives.

Usage::

    mesh = build_mesh(n_docs_shards=8)
    persistence.attach_mesh(mesh)   # shards postings/boosts/facets lazily
    search(request, persistence)    # -> executes on the mesh

Scope: search trees (exact/fuzzy/prefix leaves through the host term match),
filters, every boost family, phrase boosts, term boosts, text locality,
facets, skip/top. `explain` falls back to the unsharded path (host
snapshots). Reference parity semantics identical to search/executor.py.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..create import TEXTINDEX, TO_ANCHOR_ID_SCORE

__all__ = ["MeshContext", "mesh_search", "build_doc_mesh"]

_F32 = np.float32


def build_doc_mesh(n_shards: int, devices=None):
    import jax
    from jax.sharding import Mesh

    devices = devices if devices is not None else jax.devices()
    assert len(devices) >= n_shards
    return Mesh(np.array(devices[:n_shards]), axis_names=("d",))


class _ShardedField:
    """Anchor-range-sharded postings of one field: device arrays [D, ...]
    with the shard axis laid over mesh axis ``d``."""

    def __init__(self, store, num_docs: int, mesh) -> None:
        import jax
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P

        d = mesh.shape["d"]
        dps = -(-num_docs // d)
        offsets = np.asarray(store.offsets, dtype=np.int64)
        anchors = np.asarray(store.anchors, dtype=np.int64)
        scores01 = store.scores.astype(np.float32) / np.float32(100.0)
        num_keys = store.num_keys
        counts = np.diff(offsets).astype(np.int64)
        keys = np.repeat(np.arange(num_keys, dtype=np.int64), counts)
        shard_of = anchors // dps

        per_shard = []
        max_nnz = 8
        for i in range(d):
            sel = shard_of == i
            k = keys[sel]
            a = (anchors[sel] - i * dps).astype(np.int32)
            s = scores01[sel]
            off = np.zeros(num_keys + 2, dtype=np.int32)
            np.cumsum(np.bincount(k, minlength=num_keys), out=off[1 : num_keys + 1])
            off[num_keys + 1] = off[num_keys]
            per_shard.append((off, a, s))
            max_nnz = max(max_nnz, len(a))
        max_nnz = -(-max_nnz // 128) * 128
        off_stack = np.zeros((d, num_keys + 2), dtype=np.int32)
        a_stack = np.full((d, max_nnz), dps, dtype=np.int32)
        s_stack = np.zeros((d, max_nnz), dtype=np.float32)
        for i, (off, a, s) in enumerate(per_shard):
            off_stack[i] = off
            a_stack[i, : len(a)] = a
            s_stack[i, : len(s)] = s
        self.host_offsets = off_stack  # for capacity sizing
        sh = NamedSharding(mesh, P("d", None))
        self.offsets = jax.device_put(off_stack, sh)
        self.anchors = jax.device_put(a_stack, sh)
        self.scores01 = jax.device_put(s_stack, sh)
        self.num_keys = num_keys


class MeshContext:
    """Per-persistence mesh state: sharded postings / boost columns / facet
    relations, all built lazily and cached."""

    def __init__(self, persistence, mesh) -> None:
        self.persistence = persistence
        self.mesh = mesh
        self.d = mesh.shape["d"]
        self.num_docs = persistence.num_docs
        self.dps = -(-self.num_docs // self.d)
        self.fields: Dict[str, _ShardedField] = {}
        self.boosts: Dict[str, tuple] = {}
        self.facet_rel: Dict[str, tuple] = {}
        self._sharding = None
        self._combined = None
        self._facet_mats: Dict[str, tuple] = {}
        self._generic_jit: Dict[tuple, object] = {}

    # ------------------------------------------------------------- plumbing
    def sharding(self):
        if self._sharding is None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            self._sharding = NamedSharding(self.mesh, P("d", None))
        return self._sharding

    def field(self, field: str) -> Optional[_ShardedField]:
        field = field[: -len(TEXTINDEX)] if field.endswith(TEXTINDEX) else field
        sf = self.fields.get(field)
        if sf is None:
            store = self.persistence.anchor_scores.get(
                field + TEXTINDEX + TO_ANCHOR_ID_SCORE
            )
            if store is None:
                return None
            sf = _ShardedField(store, self.num_docs, self.mesh)
            self.fields[field] = sf
        return sf

    def shard_host_vector(self, vec: np.ndarray, fill=0):
        """Host [num_docs] vector -> device [D, dps] with the d sharding."""
        import jax

        padded = np.full(self.d * self.dps, fill, dtype=vec.dtype)
        padded[: len(vec)] = vec[: self.num_docs]
        return jax.device_put(padded.reshape(self.d, self.dps), self.sharding())

    def boost_column(self, boost_path: str):
        cached = self.boosts.get(boost_path)
        if cached is None:
            vals, present = self.persistence.get_boost(boost_path)
            v = np.zeros(self.num_docs, dtype=np.float32)
            p = np.zeros(self.num_docs, dtype=bool)
            m = min(self.num_docs, len(vals))
            v[:m] = vals[:m]
            p[:m] = present[:m]
            cached = (self.shard_host_vector(v), self.shard_host_vector(p, fill=False))
            self.boosts[boost_path] = cached
        return cached

    def sharded_dict(self, field: str):
        """Term-axis-sharded fuzzy sweep dictionary (lazy, cached)."""
        cached = getattr(self, "_sharded_dicts", None)
        if cached is None:
            cached = self._sharded_dicts = {}
        sd = cached.get(field)
        if sd is None:
            from .sharding import ShardedDictionary

            dictionary = self.persistence.get_dictionary(field)
            chars, lengths = dictionary.char_matrix()
            sd = ShardedDictionary(chars, lengths, self.mesh)
            cached[field] = sd
        return sd

    def fuzzy_match(self, field: str, lower_term: str, distance: int,
                    starts_with: bool = False):
        """Mesh fuzzy term matching: per-shard sweep over the term-sharded
        dictionary, all_gather of the matches — the serving-path use of
        `sharded_fuzzy_match`.
        Returns (ids asc, dists, prefixes) over GLOBAL term ids."""
        from ..ops.levenshtein import encode_query
        from .sharding import sharded_fuzzy_match

        sd = self.sharded_dict(field)
        q, qlen = encode_query(lower_term)
        mm = 256
        while True:
            ids, dists, prefixes, total = sharded_fuzzy_match(
                sd, q, qlen, distance,
                max_matches_per_shard=mm, starts_with=starts_with,
                # lev(a,b) >= |len(a)-len(b)|: each shard sweeps only its
                # [qlen-d, qlen+d] slice of the locally length-sorted layout
                min_len=len(lower_term) - distance,
                max_len=len(lower_term) + distance,
            )
            # conservative: a global total <= mm guarantees no single shard
            # clipped its per-shard window
            if total <= mm or mm >= sd.terms_per_shard:
                break
            mm = min(sd.terms_per_shard, mm * 4)
        keep = ids >= 0
        ids, dists, prefixes = ids[keep], dists[keep], prefixes[keep]
        order = np.argsort(ids, kind="stable")
        return (
            ids[order].astype(np.int64),
            dists[order].astype(np.int64),
            prefixes[order].astype(bool),
        )

    def filter_mask_stack(self, skey: tuple, node_of: dict):
        """Stack of DISTINCT document-sharded filter masks [NF_pad, D, dps]
        (cached device-resident; per batch only mask indices ship) — the
        mesh twin of search/batch._filter_mask_stack. ``skey`` is the sorted
        tuple of filter tree keys; ``node_of`` maps key -> filter node."""
        import jax
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P

        from ..ops.postings import bucket_size
        from ..search.batch import _filter_anchor_list

        memo = getattr(self, "_filter_stacks", None)
        if memo is None:
            memo = self._filter_stacks = {}
        stack = memo.get(skey)
        if stack is None:
            masks = []
            for k in skey:
                anchors = _filter_anchor_list(self.persistence, node_of[k])
                m = np.zeros(self.d * self.dps, dtype=bool)
                m[anchors[anchors < self.num_docs]] = True
                masks.append(m.reshape(self.d, self.dps))
            nf_pad = bucket_size(len(masks), 4)
            while len(masks) < nf_pad:
                masks.append(np.zeros((self.d, self.dps), dtype=bool))
            arr = np.stack(masks, axis=0)  # [NF, D, dps]
            stack = jax.device_put(
                arr, NamedSharding(self.mesh, P(None, "d", None))
            )
            if len(memo) > 64:
                memo.clear()
            memo[skey] = stack
        return stack

    # ------------------------------------------------------------- kernels
    def resolve_leaf(self, field: str, term_ids, term_scores):
        """Matched term ids -> sharded dense [D, dps] score plane."""
        import jax
        import jax.numpy as jnp
        from jax.sharding import PartitionSpec as P

        from ..ops.postings import bucket_size
        from ..ops.search_step import _gather_postings

        sf = self.field(field)
        if sf is None:
            return self.zeros()
        term_ids = np.asarray(term_ids, dtype=np.int64)
        term_ids = np.where(term_ids < sf.num_keys, term_ids, -1)
        t_pad = bucket_size(max(len(term_ids), 1), 8)
        tid = np.full(t_pad, -1, dtype=np.int32)
        tid[: len(term_ids)] = term_ids.astype(np.int32)
        tsc = np.zeros(t_pad, dtype=np.float32)
        tsc[: len(term_scores)] = np.asarray(term_scores, dtype=np.float32)
        # capacity: the worst shard's total for these terms
        ho = sf.host_offsets
        safe = np.where(tid >= 0, tid, 0)
        tot = np.where(
            tid[None, :] >= 0, ho[:, safe + 1] - ho[:, safe], 0
        ).sum(axis=1)
        capacity = bucket_size(max(int(tot.max()), 1))
        tid_j, tsc_j = jnp.asarray(tid), jnp.asarray(tsc)
        dps = self.dps

        def step(offs, anc, sc):
            a, s, _seg = _gather_postings(
                offs[0], anc[0], sc[0], tid_j, tsc_j, capacity, dps
            )
            dense = jax.ops.segment_max(s, a, num_segments=dps + 1)[:dps]
            return jnp.where(jnp.isfinite(dense), dense, 0.0)[None]

        fn = jax.jit(
            jax.shard_map(
                step,
                mesh=self.mesh,
                in_specs=(P("d", None), P("d", None), P("d", None)),
                out_specs=P("d", None),
                check_vma=False,
            )
        )
        return fn(sf.offsets, sf.anchors, sf.scores01)

    def zeros(self):
        import jax
        import jax.numpy as jnp

        return jax.device_put(
            jnp.zeros((self.d, self.dps), jnp.float32), self.sharding()
        )

    def topk(self, dense, k: int):
        """Exact global top-k by (score desc, id desc): per-shard two-stage
        top-k, `all_gather`, stable merge (shards concatenated in
        REVERSE order so the stable top_k tie-break = global id desc)."""
        import jax
        import jax.numpy as jnp
        from jax.sharding import PartitionSpec as P

        from ..ops.topk import topk_dense_exact

        dps = self.dps
        kk = min(k, dps)

        def step(d):
            local = d[0]
            ids, scores = topk_dense_exact(local, kk)
            shard = jax.lax.axis_index("d").astype(jnp.int32)
            gids = ids + shard * dps
            s_all = jax.lax.all_gather(scores, "d")  # [D, kk]
            i_all = jax.lax.all_gather(gids, "d")
            s_flat = s_all[::-1].reshape(-1)
            i_flat = i_all[::-1].reshape(-1)
            km = min(k, s_flat.shape[0])
            ms, mi = jax.lax.top_k(s_flat, km)
            hits = jnp.sum(local > 0, dtype=jnp.int32)
            total = jax.lax.psum(hits, "d")
            return i_flat[mi][None], ms[None], total[None]

        fn = jax.jit(
            jax.shard_map(
                step,
                mesh=self.mesh,
                in_specs=(P("d", None),),
                out_specs=(P(None, None), P(None, None), P(None)),
                check_vma=False,
            )
        )
        ids, scores, num_hits = fn(dense)
        ids, scores, num_hits = jax.device_get((ids, scores, num_hits))
        return ids[0], scores[0], int(num_hits[0])

    def combined(self):
        """Document-sharded COMBINED global-key anchor-score CSR (the mesh
        twin of `Persistence.device_combined`): every searchable field's
        postings concatenated under global term ids, then anchor-range
        sharded over the mesh. Backs the batched generic path at capacity
        beyond one chip's HBM."""
        if self._combined is not None:
            return self._combined
        built = self.persistence.combined_host_csr()
        if built is None:
            return None
        ns, key_base = built
        # _ShardedField takes standard [num_keys + 1] offsets
        from types import SimpleNamespace

        ns = SimpleNamespace(
            offsets=ns.offsets[: ns.num_keys + 1],
            anchors=ns.anchors,
            scores=ns.scores,
            num_keys=ns.num_keys,
        )
        sf = _ShardedField(ns, self.num_docs, self.mesh)
        sf.key_base = key_base
        self._combined = sf
        return sf

    def facet_matrix_sharded(self, field: str):
        """Row-sharded facet relation matrix [D, dps, G] f32, or None."""
        cached = self._facet_mats.get(field)
        if cached is not None:
            return cached
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P

        from ..search.facet import facet_matrix_host

        host = facet_matrix_host(self.persistence, field)
        if host is None:
            return None
        m, num_targets = host
        padded = np.zeros((self.d * self.dps, num_targets), dtype=np.float32)
        padded[: m.shape[0]] = m
        stacked = padded.reshape(self.d, self.dps, num_targets)
        sh = NamedSharding(self.mesh, P("d", None, None))
        cached = (jax.device_put(stacked, sh), num_targets)
        self._facet_mats[field] = cached
        return cached

    def generic_batch(
        self,
        tid_arr: np.ndarray,  # [Q, T] int32 global combined ids (pad -1)
        tsc_arr: np.ndarray,  # [Q, T] f32
        sl_arr: np.ndarray,  # [Q, T] int32
        fmask_stack,  # [NF, D, dps] bool sharded over d | None (cached)
        fi_arr,  # [Q] int32 into fmask_stack | None
        pa_arr,  # [Q, P] int32 GLOBAL anchor ids (pad num_docs) | None
        boost_key: tuple,  # ((path, fun, param, skip, expr), ...)
        facet_fields: tuple,
        num_slots: int,
        is_and: bool,
        k: int,
        capacity: int,
        deep_maps=None,  # (s2g [Q,S], g2s [Q,G], s2t [Q,NS], ng [Q,NS]) | None
        deep_terms: int = 0,  # static NT for the deep stage-4/5 planes
    ):
        """A batch of filtered/boosted/faceted/phrase-boosted tree queries
        over the mesh in ONE shard_map program: per-shard local dense
        planes, cached per-shard filter masks (index per query — the
        FilterChannel broadcast as resident sharded vectors), elementwise
        boosts on sharded columns, local facet matmul + `psum`, exact
        per-shard top-k merged with `all_gather`. When the mesh has a
        ``q`` axis the query batch additionally splits across it (each q
        row evaluates its slice; results all_gather over ``q``) — the
        multichip twin of ops/generic_step.batched_generic_topk.

        With ``deep_maps`` the tree is a DEEP (3-alternation, OR-of-ANDs)
        spec: ``sl_arr`` carries compact leaf-plane indices and the maps
        carry the per-query plane->group->subtree->term structure
        (tree_dense_deep; execution_plan.rs:272-387)."""
        import jax
        import jax.numpy as jnp
        from jax.sharding import PartitionSpec as P

        from ..ops.topk import topk_dense_exact
        from ..ops.generic_step import (
            _apply_boost,
            _precompute_boost,
            facet_counts,
            phrase_factor,
            tree_dense,
            tree_dense_deep,
        )
        from ..search.boost import ScoreExpression, _expr_vec

        sf = self.combined()
        dps = self.dps
        d = self.d
        kk = min(k, dps)
        km = min(k, kk * d)
        qsh = (
            self.mesh.shape["q"]
            if "q" in self.mesh.axis_names and self.mesh.shape["q"] > 1
            else 1
        )
        if qsh > 1 and tid_arr.shape[0] % qsh:
            # pad the query batch to a q-axis multiple
            pad = qsh - tid_arr.shape[0] % qsh
            tid_arr = np.concatenate(
                [tid_arr, np.full((pad, tid_arr.shape[1]), -1, np.int32)]
            )
            tsc_arr = np.concatenate(
                [tsc_arr, np.zeros((pad, tsc_arr.shape[1]), np.float32)]
            )
            sl_arr = np.concatenate(
                [sl_arr, np.zeros((pad, sl_arr.shape[1]), np.int32)]
            )
            if fi_arr is not None:
                fi_arr = np.concatenate([fi_arr, np.zeros(pad, np.int32)])
            if pa_arr is not None:
                pa_arr = np.concatenate(
                    [
                        pa_arr,
                        np.full(
                            (pad, pa_arr.shape[1]), self.num_docs, np.int32
                        ),
                    ]
                )
            if deep_maps is not None:
                # pad queries have no postings -> zero planes; zero maps are
                # harmless (all contributions are already zero)
                deep_maps = tuple(
                    np.concatenate(
                        [m, np.zeros((pad, m.shape[1]), m.dtype)]
                    )
                    for m in deep_maps
                )

        boost_cols = []
        for bp, fun, param, skip, expr in boost_key:
            bv_sh, pres_sh = self.boost_column(bp)
            expr_add = None
            if expr:
                ekey = "\x01expr:" + bp + "\x00" + expr
                expr_add = self.boosts.get(ekey)
                if expr_add is None:
                    vals, present = self.persistence.get_boost(bp)
                    v = np.zeros(self.num_docs, dtype=np.float32)
                    v[: min(self.num_docs, len(vals))] = vals[: self.num_docs]
                    expr_add = self.shard_host_vector(
                        _expr_vec(ScoreExpression(expr), v)
                    )
                    self.boosts[ekey] = expr_add
            boost_cols.append((bv_sh, pres_sh, expr_add))
        boost_specs = tuple((fun, param, skip) for _bp, fun, param, skip, _e in boost_key)
        mats = [self.facet_matrix_sharded(f)[0] for f in facet_fields]

        jkey = (
            "generic",
            tid_arr.shape,
            tuple(fmask_stack.shape) if fmask_stack is not None else None,
            pa_arr.shape if pa_arr is not None else None,
            boost_key,  # full key: in_specs depend on expression presence
            tuple(facet_fields),
            num_slots,
            is_and,
            k,
            capacity,
            tuple(m.shape for m in deep_maps) if deep_maps else None,
            deep_terms,
        )
        fn = self._generic_jit.get(jkey)
        if fn is None:

            def step(offs, anc, sc, tids, tscs, slots, dmaps, fmasks, fidx,
                     pa, bcols, fmats):
                shard = jax.lax.axis_index("d").astype(jnp.int32)
                local_base = shard * dps
                pre_boosts = tuple(
                    _precompute_boost(
                        bv[0], pres[0], spec + (ea[0] if ea is not None else None,)
                    )
                    for (bv, pres, ea), spec in zip(bcols, boost_specs)
                )

                def one(tid, tsc, slot, dms, fi, panch):
                    if dms:
                        s2g, g2s, s2t, ngs = dms
                        dense = tree_dense_deep(
                            offs[0], anc[0], sc[0], tid, tsc, slot,
                            s2g, g2s, s2t, ngs, capacity, dps,
                            num_slots, g2s.shape[0], s2t.shape[0],
                            deep_terms,
                        )
                    else:
                        dense = tree_dense(
                            offs[0], anc[0], sc[0], tid, tsc, slot, capacity,
                            dps, num_slots, is_and,
                        )
                    if fi is not None:
                        # cached per-shard mask, selected by index
                        dense = jnp.where(fmasks[fi, 0], dense, 0.0)
                    for pre in pre_boosts:
                        dense = _apply_boost(dense, pre)
                    if panch is not None:
                        loc = panch - local_base
                        loc = jnp.where((loc >= 0) & (loc < dps), loc, dps)
                        dense = dense * phrase_factor(loc, dps)
                    return dense

                in_axes = (
                    0, 0, 0,
                    (0, 0, 0, 0) if dmaps else (),
                    0 if fidx is not None else None,
                    0 if pa is not None else None,
                )
                dense_b = jax.vmap(one, in_axes=in_axes)(
                    tids, tscs, slots, dmaps, fidx, pa
                )

                def tk(local):
                    ids, scores = topk_dense_exact(local, kk)
                    gids = ids + local_base
                    s_all = jax.lax.all_gather(scores, "d")  # [D, kk]
                    i_all = jax.lax.all_gather(gids, "d")
                    s_flat = s_all[::-1].reshape(-1)
                    i_flat = i_all[::-1].reshape(-1)
                    ms, mi = jax.lax.top_k(s_flat, km)
                    return i_flat[mi], ms

                ids_q, scores_q = jax.vmap(tk)(dense_b)
                hits_b = dense_b > 0
                num_hits = jax.lax.psum(
                    jnp.sum(hits_b, axis=1, dtype=jnp.int32), "d"
                )
                counts = tuple(
                    jax.lax.psum(facet_counts(hits_b, m[0]), "d")
                    for m in fmats
                )
                if qsh > 1:
                    # re-assemble the full batch across the q axis
                    ids_q = jax.lax.all_gather(ids_q, "q").reshape(
                        -1, ids_q.shape[-1]
                    )
                    scores_q = jax.lax.all_gather(scores_q, "q").reshape(
                        -1, scores_q.shape[-1]
                    )
                    num_hits = jax.lax.all_gather(num_hits, "q").reshape(-1)
                    counts = tuple(
                        jax.lax.all_gather(c, "q").reshape(-1, c.shape[-1])
                        for c in counts
                    )
                return ids_q[None], scores_q[None], num_hits[None], counts

            n_mats = len(mats)
            qspec2 = P("q", None) if qsh > 1 else P(None, None)
            qspec1 = P("q") if qsh > 1 else P(None)
            fn = jax.jit(
                jax.shard_map(
                    step,
                    mesh=self.mesh,
                    in_specs=(
                        P("d", None), P("d", None), P("d", None),  # CSR
                        qspec2, qspec2, qspec2,  # queries
                        tuple(qspec2 for _ in range(4))
                        if deep_maps is not None
                        else (),
                        P(None, "d", None) if fmask_stack is not None else None,
                        qspec1 if fi_arr is not None else None,
                        qspec2 if pa_arr is not None else None,
                        tuple(
                            (P("d", None), P("d", None),
                             P("d", None) if ea is not None else None)
                            for (_b, _p, ea) in boost_cols
                        ),
                        tuple(P("d", None, None) for _ in range(n_mats)),
                    ),
                    out_specs=(
                        P(None, None, None),
                        P(None, None, None),
                        P(None, None),
                        tuple(P(None, None) for _ in range(n_mats)),
                    ),
                    check_vma=False,
                )
            )
            if len(self._generic_jit) > 64:
                self._generic_jit.clear()
            self._generic_jit[jkey] = fn

        import jax.numpy as jnp

        # returns DEVICE arrays (leading broadcast dim still on ids/scores/
        # num_hits) — the caller batches the D2H sync across all groups
        return fn(
            sf.offsets, sf.anchors, sf.scores01,
            jnp.asarray(tid_arr), jnp.asarray(tsc_arr), jnp.asarray(sl_arr),
            tuple(jnp.asarray(m) for m in deep_maps)
            if deep_maps is not None
            else (),
            fmask_stack,
            jnp.asarray(fi_arr) if fi_arr is not None else None,
            jnp.asarray(pa_arr) if pa_arr is not None else None,
            tuple(boost_cols),
            tuple(mats),
        )

    def facet_counts(self, path: str, store, dense) -> np.ndarray:
        """Sharded facet counting: local masked segment-sum + psum over d."""
        import jax
        import jax.numpy as jnp
        from jax.sharding import PartitionSpec as P

        from ..search.facet import _pairs_of

        cached = self.facet_rel.get(path)
        if cached is None:
            sources, targets = _pairs_of(store)
            num_targets = int(targets.max()) + 1 if len(targets) else 1
            shard_of = sources // self.dps
            per = []
            mx = 8
            for i in range(self.d):
                sel = shard_of == i
                per.append(
                    (
                        (sources[sel] - i * self.dps).astype(np.int32),
                        targets[sel].astype(np.int32),
                    )
                )
                mx = max(mx, int(sel.sum()))
            mx = -(-mx // 128) * 128
            src = np.full((self.d, mx), self.dps, dtype=np.int32)
            tgt = np.zeros((self.d, mx), dtype=np.int32)
            for i, (s, t) in enumerate(per):
                src[i, : len(s)] = s
                tgt[i, : len(t)] = t
            cached = (
                jax.device_put(src, self.sharding()),
                jax.device_put(tgt, self.sharding()),
                num_targets,
            )
            self.facet_rel[path] = cached
        src_j, tgt_j, num_targets = cached
        dps = self.dps

        def step(src, tgt, d):
            src, tgt, local = src[0], tgt[0], d[0]
            mask = local > 0
            ok = src < dps
            w = jnp.where(ok, mask[jnp.minimum(src, dps - 1)], False).astype(
                jnp.int32
            )
            counts = jax.ops.segment_sum(w, tgt, num_segments=num_targets)
            return jax.lax.psum(counts, "d")[None]

        fn = jax.jit(
            jax.shard_map(
                step,
                mesh=self.mesh,
                in_specs=(P("d", None), P("d", None), P("d", None)),
                out_specs=P(None, None),
                check_vma=False,
            )
        )
        return np.asarray(fn(src_j, tgt_j, dense)[0])


# ---------------------------------------------------------------- search


def mesh_search(request, persistence):
    """Generic search over the attached mesh — mirrors executor.search()'s
    device path with sharded vectors. Returns a SearchResult."""
    import time

    import jax.numpy as jnp

    from ..error import InvalidRequestError
    from ..query.request import SearchRequest
    from ..search import boost as boost_mod
    from ..search.executor import _Ctx, _collect_parts, _matching_1n_boost
    from ..search.facet import get_facet
    from ..search.result import Hit, SearchResult
    from ..search.why_found import get_why_found
    from ..utils import get_steps_to_anchor
    from ..create import ANCHOR_TO_TEXT_ID, PARENT_TO_VALUE_ID

    start = time.time_ns()
    mc: MeshContext = persistence.mesh_ctx
    top = request.top if request.top is not None else 10
    skip = request.skip or 0

    ctx = _Ctx(persistence, request)
    _collect_parts(ctx, request)
    ctx.run_field_searches()

    boosts = list(request.boost or [])

    def eval_scores(node):
        if node.kind == SearchRequest.SEARCH:
            part = node.part
            fsr = ctx.result_for(part)
            field = fsr.path[: -len(TEXTINDEX)]
            dense = mc.resolve_leaf(field, fsr.term_ids, fsr.term_scores)
            sub = list(boosts)
            if part.options and part.options.get("boost"):
                from ..query.request import RequestBoostPart

                sub += [RequestBoostPart.from_dict(b) for b in part.options["boost"]]
            b1n = _matching_1n_boost(part, sub)
            if b1n is not None:
                anchors, bvals = boost_mod.boost_to_anchor_values(
                    persistence, fsr.path, b1n, fsr.term_ids
                )
                factor_like = _apply_anchor_boost_sharded(
                    mc, dense, anchors, bvals, b1n
                )
                dense = factor_like
            return dense, part.terms[0]
        children = [eval_scores(q) for q in node.queries]
        if not children:
            return mc.zeros(), ""
        if len(children) == 1:
            return children[0]
        if node.kind == SearchRequest.OR:
            terms = sorted({t for _d, t in children})
            total = mc.zeros()
            distinct = jnp.zeros((mc.d, mc.dps), jnp.int32)
            for t in terms:
                vecs = [d for d, tt in children if tt == t]
                mx = vecs[0]
                for v in vecs[1:]:
                    mx = jnp.maximum(mx, v)
                total = total + mx
                distinct = distinct + (mx >= _F32(1e-5)).astype(jnp.int32)
            df = distinct.astype(jnp.float32)
            return total * df * df, children[0][1]
        if node.kind == SearchRequest.AND:
            mask = None
            for d, _t in children:
                m = d > 0
                mask = m if mask is None else (mask & m)
            total = mc.zeros()
            for d, _t in children:
                total = total + d
            return jnp.where(mask, total, _F32(0.0)), children[0][1]
        raise InvalidRequestError(f"unknown node kind {node.kind}")

    dense, _t = eval_scores(request.search_req)

    # filter (host-resolved anchors -> sharded bool mask)
    if request.filter is not None:
        mask_host = _filter_mask_host(ctx, request.filter)
        dense = jnp.where(mc.shard_host_vector(mask_host, fill=False), dense, _F32(0.0))

    # anchor-level boost columns
    from ..create import BOOST_VALID_TO_VALUE

    for b in boosts:
        if "[]" in b.path:
            continue
        boost_path = b.path
        if not boost_path.endswith(BOOST_VALID_TO_VALUE):
            boost_path = boost_path + BOOST_VALID_TO_VALUE
        bv_j, pres_j = mc.boost_column(boost_path)
        dense = boost_mod.apply_boost_dense_device(dense, bv_j, pres_j, b)

    # phrase boosts
    if request.phrase_boosts:
        from ..create import PHRASE_PAIR_TO_ANCHOR

        groups: Dict[tuple, List[np.ndarray]] = {}
        for pb in request.phrase_boosts:
            if pb.search1.path != pb.search2.path:
                raise InvalidRequestError("phrase boost paths must match")
            r1 = ctx.result_for(pb.search1)
            r2 = ctx.result_for(pb.search2)
            store = persistence.phrase_indices.get(r1.path + PHRASE_PAIR_TO_ANCHOR)
            if store is None:
                continue
            anchors = store.get_values_for_pairs(r1.hits_ids, r2.hits_ids)
            groups.setdefault((pb.search1.terms[0], pb.search2.terms[0]), []).append(
                anchors
            )
        group_arrays = [
            np.concatenate(v) if len(v) > 1 else v[0] for v in groups.values() if v
        ]
        if group_arrays:
            factor = boost_mod.phrase_boost_factor(group_arrays, mc.num_docs)
            dense = dense * mc.shard_host_vector(factor)
            dense = jnp.where(dense > 0, dense, _F32(0.0))

    # term metadata for why_found / text locality
    term_id_hits: Dict[str, Dict[str, List[int]]] = {}
    term_texts: Dict[str, List[str]] = {}
    for part in request.search_req.walk_parts():
        fsr = ctx.result_for(part)
        for path, m in fsr.term_id_hits_in_field.items():
            term_id_hits.setdefault(path, {}).update(m)
        for path, texts in fsr.term_text_in_field.items():
            term_texts.setdefault(path, []).extend(texts)

    result = SearchResult()

    if request.boost_term:
        from ..search.field_search import get_term_ids_in_field

        def run_part(part, **kw):
            return get_term_ids_in_field(persistence, part, **kw)

        factor = boost_mod.term_boost_factor(
            persistence, request.boost_term, mc.num_docs, run_part
        )
        dense = dense * mc.shard_host_vector(factor)

    if request.text_locality:
        factor = boost_mod.text_locality_boost(persistence, term_id_hits, mc.num_docs)
        dense = dense * mc.shard_host_vector(factor)

    result.why_found_terms = term_texts

    ids, scores, num_hits = mc.topk(dense, top + skip)
    result.num_hits = num_hits

    if request.facets:
        facets = {}
        for f in request.facets:
            steps = get_steps_to_anchor(f.field)
            fast_anchor_path = steps[-1] + ANCHOR_TO_TEXT_ID
            path = (
                steps[0] + PARENT_TO_VALUE_ID
                if len(steps) == 1
                else fast_anchor_path
            )
            store = persistence.key_value_stores.get(path)
            if store is not None and (
                len(steps) == 1 or persistence.has_index(fast_anchor_path)
            ):
                counts = mc.facet_counts(path, store, dense)
                value_ids = np.flatnonzero(counts)
                vals = counts[value_ids]
                order = np.argsort(-vals, kind="stable")
                if f.top is not None:
                    order = order[: f.top]
                dictionary = persistence.get_dictionary(steps[-1])
                facets[f.field] = [
                    (dictionary.ord_to_term(int(value_ids[i])), int(vals[i]))
                    for i in order
                ]
            else:
                # slow join path: host mask
                import jax

                mask = np.asarray(jax.device_get(dense)).reshape(-1)[
                    : mc.num_docs
                ] > 0
                facets[f.field] = get_facet(persistence, f, mask)
        result.facets = facets

    mask = scores > 0
    ids, scores = np.asarray(ids)[mask], np.asarray(scores)[mask]
    ids, scores = ids[skip:], scores[skip:]
    result.data = [Hit(int(i), float(s)) for i, s in zip(ids[:top], scores[:top])]

    if request.why_found and request.select is not None:
        result.why_found_info = get_why_found(
            persistence, [h.id for h in result.data], term_id_hits
        )

    result.execution_time_ns = time.time_ns() - start
    return result


def _filter_mask_host(ctx, node) -> np.ndarray:
    from ..search.executor import _eval_ids

    return _eval_ids(ctx, node)


def _apply_anchor_boost_sharded(mc, dense, anchors, bvals, boost_part):
    """1:n boost on a sharded dense plane: the host builds the per-anchor
    accumulation planes ONCE (`anchor_boost_accs` — shared with the host
    path so float semantics are identical), then the composition runs
    elementwise on the sharded vector."""
    import jax.numpy as jnp

    from ..search.boost import HIT_EPS, anchor_boost_accs

    if len(anchors) == 0:
        return dense
    facmul, addacc, repl = anchor_boost_accs(
        mc.num_docs, anchors, bvals, boost_part
    )
    hit = dense > 0
    out = dense
    if facmul is not None:
        out = jnp.where(hit, out * mc.shard_host_vector(facmul), out)
    if repl is not None:
        r_j = mc.shard_host_vector(repl, fill=np.nan)
        out = jnp.where(hit & ~jnp.isnan(r_j), r_j, out)
    if addacc is not None:
        out = jnp.where(hit, out + mc.shard_host_vector(addacc), out)
    out = jnp.where(hit, jnp.maximum(out, HIT_EPS), out)
    return out
