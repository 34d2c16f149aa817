// Honest single-core CPU baseline: the reference engine's query hot path,
// re-implemented faithfully in C++ over the SAME index arrays the device
// serving path uses.
//
// This is the stand-in for running the Rust reference itself (no cargo in
// this image; jmdict is an LFS stub): per query it executes exactly the
// algorithm of reference src/search/search_field.rs:400-504
// (`resolve_token_to_anchor`: AnchorScoreIter posting scan, score =
// term_score * (u16_score / 100), sort_unstable by anchor id, dedup keeping
// the max) followed by src/search/sort.rs:5-34 (`top_n_sort`: threshold-
// pruned partial sort with a top_n + 200 buffer, final order score desc /
// id desc — `sort_by_score_and_id`, src/search.rs:122-130).
//
// It is deliberately ADVANTAGED versus the real reference: the posting
// arrays here are raw (no vint+delta decode, which the reference pays per
// element — token_to_anchor_score_vint.rs:127+), and the dictionary lookup
// is done once outside the timed loop. A device speedup against this
// number therefore understates the true gap.
//
// Built into libveloci_native.so next to the indexer (see
// veloci_tpu/native.py); exercised by bench.py as `vs_baseline_native_cpu`
// and parity-tested against the engine in tests/test_native.py.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Hit {
    uint32_t id;
    float score;
};

// sort_by_score_and_id (reference src/search.rs:122-130): score desc, then
// id desc.
inline bool score_id_less(const Hit& a, const Hit& b) {
    if (a.score != b.score) return a.score > b.score;
    return a.id > b.id;
}

// reference top_n_sort (src/search/sort.rs:5-34): threshold-pruned partial
// sort over a top_n + 200 buffer.
inline void top_n_sort(std::vector<Hit>& data, uint32_t top_n,
                       std::vector<Hit>& out) {
    float worst_score = -3.4e38f;
    out.clear();
    out.reserve(top_n * 5 + 1);
    const size_t buf = static_cast<size_t>(top_n) + 200;
    for (const Hit& el : data) {
        if (el.score < worst_score) continue;
        if (!out.empty() && out.size() == buf) {
            std::sort(out.begin(), out.end(), score_id_less);
            out.resize(top_n);
            worst_score = out.back().score;
        }
        out.push_back(el);
    }
    std::sort(out.begin(), out.end(), score_id_less);
    if (out.size() > top_n) out.resize(top_n);
}

}  // namespace

extern "C" {

// One batch of exact-term queries, single thread. Per query `t_per_q` term
// ids (pad -1) resolve against the CSR anchor-score index; union semantics
// for multi-term queries follow union_hits_score (set_op.rs:87-220): max
// per (distinct term slot, anchor), score = sum over slots * distinct^2.
// For the dominant single-term shape this degenerates to the plain
// resolve + sort + dedup + top_n_sort pipeline.
void vbl_exact_topk(const int64_t* offsets,      // [num_keys + 1]
                    const uint32_t* anchors,     // [nnz]
                    const uint16_t* scores,      // [nnz] (index score * 100)
                    const int32_t* term_ids,     // [nq * t_per_q], -1 pad
                    const float* term_scores,    // [nq * t_per_q]
                    const int32_t* term_slots,   // [nq * t_per_q]
                    int32_t nq, int32_t t_per_q, int32_t num_keys,
                    int32_t top_n,
                    uint32_t* out_ids,    // [nq * top_n]
                    float* out_scores,    // [nq * top_n]
                    int32_t* out_hits) {  // [nq]
    std::vector<Hit> hits;
    std::vector<Hit> merged;
    std::vector<Hit> topk;
    // per-slot hit lists for the (rare) multi-term case
    std::vector<std::vector<Hit>> per_slot;
    for (int32_t q = 0; q < nq; ++q) {
        int32_t distinct_slots = 0;
        for (int32_t t = 0; t < t_per_q; ++t) {
            int32_t slot = term_slots[q * t_per_q + t];
            if (term_ids[q * t_per_q + t] >= 0 && slot + 1 > distinct_slots)
                distinct_slots = slot + 1;
        }
        if (static_cast<size_t>(distinct_slots) > per_slot.size())
            per_slot.resize(distinct_slots);
        for (auto& v : per_slot) v.clear();

        // resolve_token_to_anchor per slot (search_field.rs:419-465)
        for (int32_t t = 0; t < t_per_q; ++t) {
            int32_t tid = term_ids[q * t_per_q + t];
            if (tid < 0 || tid >= num_keys) continue;
            float ts = term_scores[q * t_per_q + t];
            std::vector<Hit>& slot_hits = per_slot[term_slots[q * t_per_q + t]];
            int64_t s = offsets[tid], e = offsets[tid + 1];
            slot_hits.reserve(slot_hits.size() + static_cast<size_t>(e - s));
            for (int64_t i = s; i < e; ++i) {
                // final_score = hit.score * (el.score / 100)
                // (search_field.rs:426; u16 scores, the f16 contract)
                slot_hits.push_back(
                    Hit{anchors[i], ts * (static_cast<float>(scores[i]) / 100.0f)});
            }
        }
        for (int32_t sl = 0; sl < distinct_slots; ++sl) {
            std::vector<Hit>& v = per_slot[sl];
            std::sort(v.begin(), v.end(),
                      [](const Hit& a, const Hit& b) { return a.id < b.id; });
            // dedup keep max (search_field.rs:451-465)
            size_t w = 0;
            for (size_t i = 0; i < v.size(); ++i) {
                if (w > 0 && v[w - 1].id == v[i].id) {
                    if (v[i].score > v[w - 1].score) v[w - 1].score = v[i].score;
                } else {
                    v[w++] = v[i];
                }
            }
            v.resize(w);
        }

        const std::vector<Hit>* final_hits;
        if (distinct_slots <= 1) {
            final_hits = distinct_slots ? &per_slot[0] : &hits;
            if (!distinct_slots) hits.clear();
        } else {
            // union_hits_score (set_op.rs:87-220): k-merge by id, max per
            // slot, sum * distinct^2
            merged.clear();
            std::vector<size_t> pos(distinct_slots, 0);
            for (;;) {
                uint32_t min_id = 0xffffffffu;
                for (int32_t sl = 0; sl < distinct_slots; ++sl)
                    if (pos[sl] < per_slot[sl].size())
                        min_id = std::min(min_id, per_slot[sl][pos[sl]].id);
                if (min_id == 0xffffffffu) break;
                float sum = 0.0f;
                int32_t d = 0;
                for (int32_t sl = 0; sl < distinct_slots; ++sl) {
                    if (pos[sl] < per_slot[sl].size() &&
                        per_slot[sl][pos[sl]].id == min_id) {
                        float mx = per_slot[sl][pos[sl]].score;
                        sum += mx;
                        if (mx >= 1e-5f) ++d;
                        ++pos[sl];
                    }
                }
                merged.push_back(
                    Hit{min_id, sum * static_cast<float>(d) * static_cast<float>(d)});
            }
            final_hits = &merged;
        }

        top_n_sort(const_cast<std::vector<Hit>&>(*final_hits),
                   static_cast<uint32_t>(top_n), topk);
        out_hits[q] = static_cast<int32_t>(final_hits->size());
        for (int32_t i = 0; i < top_n; ++i) {
            if (static_cast<size_t>(i) < topk.size()) {
                out_ids[q * top_n + i] = topk[i].id;
                out_scores[q * top_n + i] = topk[i].score;
            } else {
                out_ids[q * top_n + i] = 0;
                out_scores[q * top_n + i] = 0.0f;
            }
        }
    }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Native doc-store builder: the whole write path of the compressed document
// store in one C++ pass (reference doc_store/src/lib.rs DocStoreWriter
// 84-166: ~16 KB blocks, per-block doc offsets, LZ compression). The Python
// writer (veloci_tpu/doc_store.py) remains the reference implementation and
// fallback; this produces BYTE-IDENTICAL body + index rows, so the blobs
// interchange freely (parity-tested in tests/test_native.py).

extern "C" {
int64_t vl_lz_compress(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap);
int64_t vl_lz_bound(int64_t n);

// Walk the ndjson buffer, split lines (a line is a document iff it has any
// non-whitespace), assemble blocks (offsets u32[n+1] + raw; flush AFTER a
// doc pushes the block past flush_threshold), LZ-compress each block and
// write the framed body: [codec u8][noffsets u32][payload_len u32][comp].
// index_rows receives (first_doc_id, start, end) per block. Returns the
// body size, or -1 if out_cap / max_blocks were insufficient.
int64_t vbl_doc_store_body(const char* buf, int64_t len,
                           int32_t flush_threshold, uint8_t* out,
                           int64_t out_cap, uint64_t* index_rows,
                           int64_t max_blocks, int64_t* n_blocks_out,
                           int64_t* num_docs_out,
                           int64_t* bytes_indexed_out) {
    std::vector<std::pair<const char*, int64_t>> lines;  // current block
    std::vector<uint8_t> payload;
    std::vector<uint8_t> comp;
    int64_t pos = 0;            // write position in out
    int64_t n_blocks = 0;
    int64_t curr_id = 0;
    int64_t bytes_indexed = 0;
    int64_t block_bytes = 0;
    int64_t first_id_in_block = 0;

    auto flush = [&]() -> bool {
        if (lines.empty()) return true;
        size_t n = lines.size();
        payload.clear();
        payload.resize(4 * (n + 1));
        uint32_t off = 0;
        std::memcpy(payload.data(), &off, 4);
        for (size_t i = 0; i < n; ++i) {
            off += static_cast<uint32_t>(lines[i].second);
            std::memcpy(payload.data() + 4 * (i + 1), &off, 4);
        }
        for (size_t i = 0; i < n; ++i)
            payload.insert(payload.end(),
                           reinterpret_cast<const uint8_t*>(lines[i].first),
                           reinterpret_cast<const uint8_t*>(lines[i].first) +
                               lines[i].second);
        comp.resize(static_cast<size_t>(vl_lz_bound(
            static_cast<int64_t>(payload.size()))));
        int64_t clen = vl_lz_compress(payload.data(),
                                      static_cast<int64_t>(payload.size()),
                                      comp.data(),
                                      static_cast<int64_t>(comp.size()));
        if (clen < 0) return false;
        int64_t need = 1 + 4 + 4 + clen;
        if (pos + need > out_cap || n_blocks >= max_blocks) return false;
        int64_t start = pos;
        out[pos++] = 1;  // codec: native LZ
        uint32_t noffsets = static_cast<uint32_t>(n + 1);
        std::memcpy(out + pos, &noffsets, 4);
        pos += 4;
        uint32_t plen = static_cast<uint32_t>(payload.size());
        std::memcpy(out + pos, &plen, 4);
        pos += 4;
        std::memcpy(out + pos, comp.data(), static_cast<size_t>(clen));
        pos += clen;
        index_rows[n_blocks * 3 + 0] = static_cast<uint64_t>(first_id_in_block);
        index_rows[n_blocks * 3 + 1] = static_cast<uint64_t>(start);
        index_rows[n_blocks * 3 + 2] = static_cast<uint64_t>(pos);
        ++n_blocks;
        lines.clear();
        block_bytes = 0;
        return true;
    };

    int64_t i = 0;
    while (i < len) {
        int64_t start = i;
        while (i < len && buf[i] != '\n') ++i;
        int64_t line_len = i - start;
        if (i < len) ++i;  // skip the newline
        bool has_content = false;
        for (int64_t j = start; j < start + line_len; ++j) {
            unsigned char c = static_cast<unsigned char>(buf[j]);
            if (c != ' ' && c != '\t' && c != '\r' && c != '\n' && c != '\f' &&
                c != '\v') {
                has_content = true;
                break;
            }
        }
        if (!has_content) continue;
        if (lines.empty()) first_id_in_block = curr_id;
        lines.emplace_back(buf + start, line_len);
        block_bytes += line_len;
        bytes_indexed += line_len;
        ++curr_id;
        if (block_bytes > flush_threshold && !flush()) return -1;
    }
    if (!flush()) return -1;
    *n_blocks_out = n_blocks;
    *num_docs_out = curr_id;
    *bytes_indexed_out = bytes_indexed;
    return pos;
}
}  // extern "C"

// ---------------------------------------------------------------------------
// Storage-faithful variant: the reference does NOT scan raw arrays — its
// anchor-score index is delta + varint compressed and decoded per query
// (TokenToAnchorScoreVintFlushing / AnchorScoreIter,
// src/indices/persistence_score/token_to_anchor_score_vint.rs:26-160). The
// vint variant below reproduces that storage contract (per-term blob:
// varint(count), then per posting varint(anchor_delta), varint(score)), so
// its throughput includes the decode cost the reference pays on every
// element.

namespace {

inline void write_varint(std::vector<uint8_t>& out, uint32_t v) {
    while (v >= 0x80) {
        out.push_back(static_cast<uint8_t>(v) | 0x80);
        v >>= 7;
    }
    out.push_back(static_cast<uint8_t>(v));
}

inline uint32_t read_varint(const uint8_t*& p) {
    uint32_t v = 0;
    int shift = 0;
    for (;;) {
        uint8_t b = *p++;
        v |= static_cast<uint32_t>(b & 0x7f) << shift;
        if (!(b & 0x80)) return v;
        shift += 7;
    }
}

}  // namespace

extern "C" {

// Encode the CSR arrays into the reference's storage shape. Returns the
// blob size; call once with blob=nullptr to size, then again to fill.
// blob_offsets has num_keys + 1 entries.
int64_t vbl_encode_vint(const int64_t* offsets, const uint32_t* anchors,
                        const uint16_t* scores, int32_t num_keys,
                        uint8_t* blob, int64_t* blob_offsets) {
    std::vector<uint8_t> buf;
    int64_t pos = 0;
    for (int32_t t = 0; t < num_keys; ++t) {
        buf.clear();
        int64_t s = offsets[t], e = offsets[t + 1];
        write_varint(buf, static_cast<uint32_t>(e - s));
        uint32_t prev = 0;
        for (int64_t i = s; i < e; ++i) {
            write_varint(buf, anchors[i] - prev);  // delta (ids ascend)
            write_varint(buf, scores[i]);
            prev = anchors[i];
        }
        if (blob_offsets) blob_offsets[t] = pos;
        if (blob) std::memcpy(blob + pos, buf.data(), buf.size());
        pos += static_cast<int64_t>(buf.size());
    }
    if (blob_offsets) blob_offsets[num_keys] = pos;
    return pos;
}

// Same query loop as vbl_exact_topk but over the vint-compressed blobs —
// the decode-per-element cost profile of the actual reference engine.
void vbl_exact_topk_vint(const uint8_t* blob, const int64_t* blob_offsets,
                         const int32_t* term_ids, const float* term_scores,
                         int32_t nq, int32_t t_per_q, int32_t num_keys,
                         int32_t top_n, uint32_t* out_ids, float* out_scores,
                         int32_t* out_hits) {
    std::vector<Hit> hits;
    std::vector<Hit> topk;
    for (int32_t q = 0; q < nq; ++q) {
        hits.clear();
        for (int32_t t = 0; t < t_per_q; ++t) {
            int32_t tid = term_ids[q * t_per_q + t];
            if (tid < 0 || tid >= num_keys) continue;
            float ts = term_scores[q * t_per_q + t];
            const uint8_t* p = blob + blob_offsets[tid];
            uint32_t count = read_varint(p);
            hits.reserve(hits.size() + count);
            uint32_t id = 0;
            for (uint32_t i = 0; i < count; ++i) {
                id += read_varint(p);
                uint32_t sc = read_varint(p);
                hits.push_back(Hit{id, ts * (static_cast<float>(sc) / 100.0f)});
            }
        }
        std::sort(hits.begin(), hits.end(),
                  [](const Hit& a, const Hit& b) { return a.id < b.id; });
        size_t w = 0;
        for (size_t i = 0; i < hits.size(); ++i) {
            if (w > 0 && hits[w - 1].id == hits[i].id) {
                if (hits[i].score > hits[w - 1].score)
                    hits[w - 1].score = hits[i].score;
            } else {
                hits[w++] = hits[i];
            }
        }
        hits.resize(w);
        top_n_sort(hits, static_cast<uint32_t>(top_n), topk);
        out_hits[q] = static_cast<int32_t>(hits.size());
        for (int32_t i = 0; i < top_n; ++i) {
            if (static_cast<size_t>(i) < topk.size()) {
                out_ids[q * top_n + i] = topk[i].id;
                out_scores[q * top_n + i] = topk[i].score;
            } else {
                out_ids[q * top_n + i] = 0;
                out_scores[q * top_n + i] = 0.0f;
            }
        }
    }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Fuzzy baseline: the reference's Levenshtein-automaton x FST product walk
// (search_field.rs:85-96, 298-300) as a single-core sorted-dictionary walk
// with shared-prefix incremental DP and dead-prefix skipping — when every
// extension of a prefix exceeds the distance budget, the walk binary-searches
// past ALL terms sharing that prefix, exactly the pruning the automaton gives
// the reference. Followed by the same resolve + dedup-max + top_n_sort tail
// as vbl_exact_topk (search_field.rs:400-504, sort.rs:5-34), with the term
// score from get_default_score_for_distance (search_field.rs:27-33).
//
// Input matrix must be LOWERCASED and LEX-SORTED by (chars row, len) —
// zero padding sorts shorter terms first, so raw row comparison is proper
// lexicographic order. row_tid maps each row to its dictionary term id.

extern "C" {

void vbl_fuzzy_topk(const uint16_t* chars,   // [m, L]
                    const int32_t* lens,     // [m]
                    const int32_t* row_tid,  // [m]
                    int32_t m, int32_t L,
                    const uint16_t* queries,  // [nq, 32]
                    const int32_t* qlens,     // [nq]
                    const int32_t* dists,     // [nq]
                    const int64_t* offsets, const uint32_t* anchors,
                    const uint16_t* scores, int32_t num_keys, int32_t nq,
                    int32_t top_n, uint32_t* out_ids, float* out_scores,
                    int32_t* out_hits, int32_t* out_matches) {
    struct Match {
        int32_t tid;
        int32_t dist;
        bool is_prefix;
    };
    std::vector<int32_t> rows;   // (L+1) stacked DP rows of width qlen+1
    std::vector<int32_t> rmin;   // per-depth row minimum
    std::vector<Match> matches;
    std::vector<Hit> hits;
    std::vector<Hit> topk;

    for (int32_t q = 0; q < nq; ++q) {
        const uint16_t* query = queries + q * 32;
        int32_t qlen = qlens[q];
        int32_t d = dists[q];
        int32_t w = qlen + 1;
        rows.assign(static_cast<size_t>(L + 1) * w, 0);
        rmin.assign(L + 1, 0);
        for (int32_t j = 0; j < w; ++j) rows[j] = j;  // depth-0 row
        rmin[0] = 0;
        matches.clear();

        int32_t i = 0;
        const uint16_t* prev = nullptr;  // previous term's chars row
        int32_t prev_valid = 0;          // rows valid up to this depth
        while (i < m) {
            const uint16_t* c = chars + static_cast<int64_t>(i) * L;
            int32_t len = lens[i];
            if (len <= 0) { ++i; prev = nullptr; prev_valid = 0; continue; }
            // shared-prefix reuse: rows up to lcp(prev, c) stay valid
            int32_t lcp = 0;
            if (prev) {
                int32_t cap = prev_valid < len ? prev_valid : len;
                while (lcp < cap && prev[lcp] == c[lcp]) ++lcp;
            }
            bool dead = false;
            int32_t depth = lcp;
            for (; depth < len; ++depth) {
                const int32_t* pr = rows.data() + static_cast<size_t>(depth) * w;
                int32_t* nr = rows.data() + static_cast<size_t>(depth + 1) * w;
                uint16_t tc = c[depth];
                int32_t mn = depth + 1;
                nr[0] = depth + 1;
                for (int32_t j = 1; j < w; ++j) {
                    int32_t cost = (query[j - 1] != tc) ? 1 : 0;
                    int32_t v = pr[j] + 1;            // delete (term char)
                    int32_t v2 = nr[j - 1] + 1;       // insert
                    int32_t v3 = pr[j - 1] + cost;    // substitute / copy
                    if (v2 < v) v = v2;
                    if (v3 < v) v = v3;
                    nr[j] = v;
                    if (v < mn) mn = v;
                }
                rmin[depth + 1] = mn;
                if (mn > d) {
                    // DEAD prefix c[:depth+1]: skip every term sharing it
                    int32_t plen = depth + 1;
                    int32_t lo = i + 1, hi = m;
                    while (lo < hi) {
                        int32_t mid = lo + (hi - lo) / 2;
                        const uint16_t* t = chars + static_cast<int64_t>(mid) * L;
                        // t <= prefix c[:plen] (t shares the prefix)?
                        bool shares = true;
                        for (int32_t j = 0; j < plen; ++j) {
                            if (t[j] != c[j]) { shares = false; break; }
                        }
                        if (shares) lo = mid + 1; else hi = mid;
                    }
                    i = lo;
                    prev = c;
                    prev_valid = plen;  // rows below the dead depth stay valid
                    dead = true;
                    break;
                }
            }
            if (!dead) {
                int32_t dist = rows[static_cast<size_t>(len) * w + qlen];
                if (dist <= d) {
                    bool is_prefix = len >= qlen;
                    if (is_prefix) {
                        for (int32_t j = 0; j < qlen; ++j)
                            if (c[j] != query[j]) { is_prefix = false; break; }
                    }
                    matches.push_back(Match{row_tid[i], dist, is_prefix});
                }
                prev = c;
                prev_valid = len;
                ++i;
            }
        }
        out_matches[q] = static_cast<int32_t>(matches.size());

        // resolve + dedup-max + top_n_sort (single slot: fuzzy leaf)
        hits.clear();
        for (const Match& mt : matches) {
            if (mt.tid < 0 || mt.tid >= num_keys) continue;
            float df = static_cast<float>(mt.dist);
            float ts = mt.is_prefix ? 2.0f / (std::log2(df + 1.0f) + 0.2f)
                                    : 2.0f / (df + 0.2f);
            int64_t s = offsets[mt.tid], e = offsets[mt.tid + 1];
            hits.reserve(hits.size() + static_cast<size_t>(e - s));
            for (int64_t p = s; p < e; ++p)
                hits.push_back(
                    Hit{anchors[p], ts * (static_cast<float>(scores[p]) / 100.0f)});
        }
        std::sort(hits.begin(), hits.end(),
                  [](const Hit& a, const Hit& b) { return a.id < b.id; });
        size_t wr = 0;
        for (size_t p = 0; p < hits.size(); ++p) {
            if (wr > 0 && hits[wr - 1].id == hits[p].id) {
                if (hits[p].score > hits[wr - 1].score)
                    hits[wr - 1].score = hits[p].score;
            } else {
                hits[wr++] = hits[p];
            }
        }
        hits.resize(wr);
        top_n_sort(hits, static_cast<uint32_t>(top_n), topk);
        out_hits[q] = static_cast<int32_t>(hits.size());
        for (int32_t p = 0; p < top_n; ++p) {
            if (static_cast<size_t>(p) < topk.size()) {
                out_ids[q * top_n + p] = topk[p].id;
                out_scores[q * top_n + p] = topk[p].score;
            } else {
                out_ids[q * top_n + p] = 0;
                out_scores[q * top_n + p] = 0.0f;
            }
        }
    }
}

}  // extern "C"
