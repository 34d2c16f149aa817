// veloci_tpu native indexing core.
//
// The host-side analogue of the reference's Rust indexing pipeline
// (json_converter + tokenizer + term counting; reference:
// json_converter/src/lib.rs, src/tokenizer/*, src/create/create_fulltext.rs).
// Parses an ndjson buffer, flattens documents into per-path text leaves and
// id relations, tokenizes with per-path separator sets, counts terms, sorts
// them and assigns ids — returning flat arrays that the Python side turns
// into packed columns with numpy (pass 3).
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image).
//
// Build: g++ -O2 -std=c++17 -shared -fPIC -o libveloci_native.so indexer.cpp

#include <algorithm>
#include <chrono>
#include <cmath>
#include <thread>
#include <cstdint>
#include <cstring>
#include <deque>
#include <memory>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

// ---------------------------------------------------------------- utf-8

inline int utf8_decode(const char* s, int64_t len, int64_t pos, uint32_t* cp) {
    unsigned char c = (unsigned char)s[pos];
    if (c < 0x80) { *cp = c; return 1; }
    if ((c >> 5) == 0x6 && pos + 1 < len) {
        *cp = ((c & 0x1F) << 6) | ((unsigned char)s[pos + 1] & 0x3F);
        return 2;
    }
    if ((c >> 4) == 0xE && pos + 2 < len) {
        *cp = ((c & 0x0F) << 12) | (((unsigned char)s[pos + 1] & 0x3F) << 6) |
              ((unsigned char)s[pos + 2] & 0x3F);
        return 3;
    }
    if ((c >> 3) == 0x1E && pos + 3 < len) {
        *cp = ((c & 0x07) << 18) | (((unsigned char)s[pos + 1] & 0x3F) << 12) |
              (((unsigned char)s[pos + 2] & 0x3F) << 6) |
              ((unsigned char)s[pos + 3] & 0x3F);
        return 4;
    }
    *cp = 0xFFFD;
    return 1;
}

void utf8_append(std::string& out, uint32_t cp) {
    if (cp < 0x80) {
        out.push_back((char)cp);
    } else if (cp < 0x800) {
        out.push_back((char)(0xC0 | (cp >> 6)));
        out.push_back((char)(0x80 | (cp & 0x3F)));
    } else if (cp < 0x10000) {
        out.push_back((char)(0xE0 | (cp >> 12)));
        out.push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
        out.push_back((char)(0x80 | (cp & 0x3F)));
    } else {
        out.push_back((char)(0xF0 | (cp >> 18)));
        out.push_back((char)(0x80 | ((cp >> 12) & 0x3F)));
        out.push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
        out.push_back((char)(0x80 | (cp & 0x3F)));
    }
}

// ---------------------------------------------------------------- JSON

// Minimal recursive-descent ndjson scanner. The document tree is never
// materialised: parse events drive the walker directly (see
// Walker::stream_value) — the reference's streaming json_converter
// (json_converter/src/lib.rs:69-138) has the same shape.

struct Parser {
    const char* s;
    int64_t n;
    int64_t i = 0;
    bool ok = true;

    void skip_ws() {
        while (i < n) {
            char c = s[i];
            if (c == ' ' || c == '\t' || c == '\n' || c == '\r') i++;
            else break;
        }
    }

    bool parse_string(std::string& out) {
        // assumes s[i] == '"'
        i++;
        out.clear();
        while (i < n) {
            // span scan: memchr (SIMD) to the closing quote, then check the
            // span for escapes — the no-escape common case is ONE append
            const char* q = (const char*)memchr(s + i, '"', (size_t)(n - i));
            if (!q) return false;
            int64_t qpos = q - s;
            const char* b =
                (const char*)memchr(s + i, '\\', (size_t)(qpos - i));
            if (!b) {
                out.append(s + i, (size_t)(qpos - i));
                i = qpos + 1;
                return true;
            }
            int64_t bpos = b - s;
            out.append(s + i, (size_t)(bpos - i));
            i = bpos;
            unsigned char c = (unsigned char)s[i];
            if (c == '\\') {
                i++;
                if (i >= n) return false;
                char e = s[i++];
                switch (e) {
                    case '"': out.push_back('"'); break;
                    case '\\': out.push_back('\\'); break;
                    case '/': out.push_back('/'); break;
                    case 'b': out.push_back('\b'); break;
                    case 'f': out.push_back('\f'); break;
                    case 'n': out.push_back('\n'); break;
                    case 'r': out.push_back('\r'); break;
                    case 't': out.push_back('\t'); break;
                    case 'u': {
                        if (i + 4 > n) return false;
                        uint32_t cp = 0;
                        for (int k = 0; k < 4; k++) {
                            char h = s[i + k];
                            cp <<= 4;
                            if (h >= '0' && h <= '9') cp |= h - '0';
                            else if (h >= 'a' && h <= 'f') cp |= h - 'a' + 10;
                            else if (h >= 'A' && h <= 'F') cp |= h - 'A' + 10;
                            else return false;
                        }
                        i += 4;
                        if (cp >= 0xD800 && cp <= 0xDBFF && i + 6 <= n &&
                            s[i] == '\\' && s[i + 1] == 'u') {
                            uint32_t lo = 0;
                            for (int k = 0; k < 4; k++) {
                                char h = s[i + 2 + k];
                                lo <<= 4;
                                if (h >= '0' && h <= '9') lo |= h - '0';
                                else if (h >= 'a' && h <= 'f') lo |= h - 'a' + 10;
                                else if (h >= 'A' && h <= 'F') lo |= h - 'A' + 10;
                                else { lo = 0xFFFFFFFF; break; }
                            }
                            if (lo >= 0xDC00 && lo <= 0xDFFF) {
                                cp = 0x10000 + ((cp - 0xD800) << 10) + (lo - 0xDC00);
                                i += 6;
                            }
                        }
                        // an unpaired surrogate would encode as invalid
                        // UTF-8 and break the Python-side decode; emit
                        // U+FFFD instead (lossy replacement)
                        if (cp >= 0xD800 && cp <= 0xDFFF) cp = 0xFFFD;
                        utf8_append(out, cp);
                        break;
                    }
                    default: return false;
                }
            } else {
                out.push_back((char)c);
                i++;
            }
        }
        return false;
    }

    // true/false/null/number -> stringified into `out` exactly as the
    // tree parser did (serde_json::Value rendering, json_converter
    // lib.rs:6-14): 1 = text scalar, 0 = null, -1 = parse error
    int parse_scalar(std::string& out) {
        char c = s[i];
        if (c == 't' && i + 4 <= n && memcmp(s + i, "true", 4) == 0) {
            out.assign("true");
            i += 4;
            return 1;
        }
        if (c == 'f' && i + 5 <= n && memcmp(s + i, "false", 5) == 0) {
            out.assign("false");
            i += 5;
            return 1;
        }
        if (c == 'n' && i + 4 <= n && memcmp(s + i, "null", 4) == 0) {
            i += 4;
            return 0;
        }
        // number: slice the raw token, then normalise like serde/python
        int64_t start = i;
        if (s[i] == '-') i++;
        bool is_float = false;
        while (i < n) {
            char d = s[i];
            if ((d >= '0' && d <= '9')) { i++; continue; }
            if (d == '.' || d == 'e' || d == 'E' || d == '+' || d == '-') {
                is_float = true;
                i++;
                continue;
            }
            break;
        }
        if (i == start) return -1;
        if (!is_float) {
            out.assign(s + start, (size_t)(i - start));  // ints verbatim
        } else {
            // shortest round-trip double formatting (matches repr/serde);
            // strtod stops at the delimiter, no copy needed
            double v = strtod(s + start, nullptr);
            char buf[40];
            for (int prec = 1; prec <= 17; prec++) {
                snprintf(buf, sizeof(buf), "%.*g", prec, v);
                if (strtod(buf, nullptr) == v) break;
            }
            out.assign(buf);
            // python repr always shows a fraction for integral floats
            if (out.find('.') == std::string::npos &&
                out.find('e') == std::string::npos &&
                out.find("inf") == std::string::npos &&
                out.find("nan") == std::string::npos) {
                out += ".0";
            }
        }
        return 1;
    }
};

// ---------------------------------------------------------------- config

// ------------------------------------------------------- term interning
// Open-addressing string-interning map over a chunked byte arena — the
// stand-in for the reference's `inohashmap` (src/create.rs:50).
// One FNV-1a hash + linear probe per token, zero per-term heap nodes, no
// per-token std::string allocation (tokens are looked up as raw byte
// ranges straight out of the leaf text).

struct TermArena {
    std::vector<std::unique_ptr<char[]>> blocks;
    size_t cap = 0, used = 0;
    const char* add(const char* s, size_t len) {
        if (blocks.empty() || used + len > cap) {
            cap = std::max<size_t>(1 << 16, len);
            blocks.emplace_back(new char[cap]);
            used = 0;
        }
        char* dst = blocks.back().get() + used;
        memcpy(dst, s, len);
        used += len;
        return dst;
    }
};

struct TermMap {
    TermArena arena;
    std::vector<uint32_t> slots;       // handle+1; 0 = empty
    std::vector<const char*> key_ptr;  // handle -> term bytes (arena)
    std::vector<uint32_t> key_len;
    std::vector<uint32_t> counts;
    uint64_t mask = 0;

    static inline uint64_t hash_bytes(const char* s, size_t n) {
        uint64_t h = 1469598103934665603ull;
        for (size_t i = 0; i < n; i++) {
            h ^= (uint8_t)s[i];
            h *= 1099511628211ull;
        }
        return h;
    }
    void rehash(size_t want) {
        size_t cap = 16;
        while (cap < want * 2) cap <<= 1;
        std::vector<uint32_t> ns(cap, 0);
        for (uint32_t h = 0; h < (uint32_t)key_ptr.size(); h++) {
            uint64_t idx = hash_bytes(key_ptr[h], key_len[h]) & (cap - 1);
            while (ns[idx]) idx = (idx + 1) & (cap - 1);
            ns[idx] = h + 1;
        }
        slots.swap(ns);
        mask = cap - 1;
    }
    // add `cnt` occurrences of the term bytes, returning its stable handle
    int32_t add(const char* s, size_t n, uint32_t cnt) {
        if (key_ptr.size() * 2 >= slots.size()) rehash(key_ptr.size() + 8);
        uint64_t idx = hash_bytes(s, n) & mask;
        while (true) {
            uint32_t v = slots[idx];
            if (!v) {
                key_ptr.push_back(arena.add(s, n));
                key_len.push_back((uint32_t)n);
                counts.push_back(cnt);
                slots[idx] = (uint32_t)key_ptr.size();
                return (int32_t)key_ptr.size() - 1;
            }
            uint32_t h = v - 1;
            if (key_len[h] == n && memcmp(key_ptr[h], s, n) == 0) {
                counts[h] += cnt;
                return (int32_t)h;
            }
            idx = (idx + 1) & mask;
        }
    }
    size_t size() const { return key_ptr.size(); }
    // lexicographic byte order == std::string < == python sorted()
    inline bool key_less(uint32_t a, uint32_t b) const {
        size_t la = key_len[a], lb = key_len[b];
        int c = memcmp(key_ptr[a], key_ptr[b], la < lb ? la : lb);
        return c < 0 || (c == 0 && la < lb);
    }
};

// separator membership: ASCII bitmap fast path (the per-codepoint
// unordered_set probe dominated the tokenizer; DEFAULT_SEPERATORS is ASCII)
struct SepSet {
    bool ascii[128] = {false};
    std::unordered_set<uint32_t> wide;
    bool has_wide = false;
    inline bool contains(uint32_t cp) const {
        if (cp < 128) return ascii[cp];
        return has_wide && wide.count(cp) > 0;
    }
    void insert(uint32_t cp) {
        if (cp < 128) {
            ascii[cp] = true;
        } else {
            wide.insert(cp);
            has_wide = true;
        }
    }
};

typedef int32_t (*PathConfigCb)(const char* path, int32_t path_len,
                                uint8_t* tokenize,
                                int32_t* do_not_store_longer_than,
                                char* separators_buf, int32_t* separators_len);

struct PathConfig {
    bool tokenize = true;
    int32_t max_store_len = 64;
    SepSet separators;
};

// ---------------------------------------------------------------- per-path state

// packed .to_anchor_id_score index (built on demand by vl_pack_scores)
struct PackedScores {
    std::vector<uint64_t> offsets;  // [num_keys + 1]
    std::vector<uint32_t> anchors;
    std::vector<uint16_t> scores;
};

struct PathState {
    std::string name;
    PathConfig config;
    TermMap tmap;
    uint32_t large_text_counter = 0;  // pass-1 count (reference TermDataInPath)

    // per-(leaf, token) first-position groups (emitted during tokenize;
    // replaces the reference's calculate_and_add_token_score_in_doc grouping)
    std::vector<int32_t> grp_token_refs;
    std::vector<uint32_t> grp_first_pos;
    std::vector<uint32_t> grp_leaf;
    std::vector<uint32_t> grp_token_ids;  // resolved
    // phrase pairs (prev-nonsep chain), resolved in finalize
    std::vector<int32_t> pair_a_refs;
    std::vector<int32_t> pair_b_refs;
    std::vector<uint32_t> pair_anchor;
    std::vector<uint32_t> pair_a_ids;
    std::vector<uint32_t> pair_b_ids;

    // leaf table (encounter order)
    std::vector<uint32_t> leaf_anchor;
    std::vector<uint32_t> leaf_parent;
    std::vector<int64_t> leaf_text_id;  // resolved after id assignment
    std::vector<int32_t> leaf_term_ref;  // -1 => large text
    std::vector<uint32_t> leaf_ntokens;
    std::vector<int64_t> leaf_tok_offsets;  // [num_leaves+1]
    std::vector<uint32_t> token_ids;  // resolved after id assignment
    std::vector<int32_t> token_refs;  // interned term handle per token
    std::vector<uint8_t> token_is_sep;

    // sorted output
    std::string terms_blob;
    std::vector<uint32_t> occurrences;
    uint32_t num_terms = 0;
    PackedScores* packed_scores = nullptr;

    ~PathState() { delete packed_scores; }
};

struct IdPathState {
    std::string name;
    std::vector<uint32_t> value_id;
    std::vector<uint32_t> parent_id;
    std::vector<uint32_t> anchor_id;
    uint32_t counter = 0;
};


struct IndexResult {
    std::vector<PathState*> paths;
    std::unordered_map<std::string, int32_t> path_index;
    std::vector<IdPathState*> id_paths;
    std::unordered_map<std::string, int32_t> id_path_index;
    std::unordered_map<std::string, uint32_t> id_alloc;  // per-id-space counts (mt merge)
    int64_t num_docs = 0;
    std::string error;

    ~IndexResult() {
        for (auto* p : paths) delete p;
        for (auto* p : id_paths) delete p;
    }
};

// token handle: intern a term into the path's term map, returning a stable
// pointer-based handle recorded for later id resolution
inline int32_t intern_term(PathState& ps, const char* s, size_t n) {
    return ps.tmap.add(s, n, 1);
}

// tokenize `text`, appending (handle, is_sep) pairs; returns token count.
// Reference: SimpleTokenizerGroupTokenIter (simple_tokenizer_group.rs).
uint32_t tokenize_count(PathState& ps, const std::string& text) {
    const auto& sep = ps.config.separators;
    int64_t len = (int64_t)text.size();
    int64_t pos = 0;
    int64_t last_returned = 0;
    bool last_was_sep_run = false;
    uint32_t count = 0;
    bool any_sep_boundary = false;

    auto emit = [&](int64_t from, int64_t to, bool is_sep) {
        int32_t h = intern_term(ps, text.data() + from, (size_t)(to - from));
        ps.token_refs.push_back(h);
        ps.token_is_sep.push_back(is_sep ? 1 : 0);
        count++;
    };

    while (pos < len) {
        uint32_t cp;
        int adv;
        unsigned char c0 = (unsigned char)text[(size_t)pos];
        if (c0 < 0x80) {
            cp = c0;
            adv = 1;
        } else {
            adv = utf8_decode(text.data(), len, pos, &cp);
        }
        bool is_sep = sep.contains(cp);
        if (is_sep) {
            if (pos == 0) {
                last_was_sep_run = true;
            } else if (!last_was_sep_run) {
                emit(last_returned, pos, false);
                any_sep_boundary = true;
                last_was_sep_run = true;
                last_returned = pos;
            }
        } else if (last_was_sep_run) {
            emit(last_returned, pos, true);
            any_sep_boundary = true;
            last_was_sep_run = false;
            last_returned = pos;
        }
        pos += adv;
    }
    if (last_returned != len) {
        emit(last_returned, len, last_was_sep_run);
    }
    (void)any_sep_boundary;
    return count;
}

struct Walker {
    IndexResult* res;
    PathConfigCb config_cb;
    std::unordered_map<std::string, uint32_t> id_counters;  // IDProvider
    std::vector<std::pair<int32_t, uint32_t>> scratch_pairs;

    PathState& path_state(const std::string& path) {
        auto it = res->path_index.find(path);
        if (it != res->path_index.end()) return *res->paths[it->second];
        auto* ps = new PathState();
        ps->name = path;
        // fetch config from python
        uint8_t tokenize = 1;
        int32_t max_len = 64;
        char sepbuf[1024];
        int32_t seplen = (int32_t)sizeof(sepbuf);
        config_cb(path.data(), (int32_t)path.size(), &tokenize, &max_len,
                  sepbuf, &seplen);
        ps->config.tokenize = tokenize != 0;
        ps->config.max_store_len = max_len;
        int64_t p = 0;
        while (p < seplen) {
            uint32_t cp;
            int adv = utf8_decode(sepbuf, seplen, p, &cp);
            ps->config.separators.insert(cp);
            p += adv;
        }
        res->path_index.emplace(path, (int32_t)res->paths.size());
        res->paths.push_back(ps);
        return *ps;
    }

    IdPathState& id_path_state(const std::string& path) {
        auto it = res->id_path_index.find(path);
        if (it != res->id_path_index.end()) return *res->id_paths[it->second];
        auto* ps = new IdPathState();
        ps->name = path;
        res->id_path_index.emplace(path, (int32_t)res->id_paths.size());
        res->id_paths.push_back(ps);
        return *ps;
    }

    uint32_t provide_id(const std::string& path) {
        auto it = id_counters.find(path);
        if (it == id_counters.end()) {
            id_counters.emplace(path, 0);
            return 0;
        }
        return ++it->second;
    }

    void text_leaf(uint32_t anchor, const std::string& text,
                   const std::string& path, uint32_t parent) {
        PathState& ps = path_state(path);
        ps.leaf_anchor.push_back(anchor);
        ps.leaf_parent.push_back(parent);
        if (ps.leaf_tok_offsets.empty()) ps.leaf_tok_offsets.push_back(0);

        bool is_large = (int64_t)text.size() > ps.config.max_store_len;
        if (is_large) {
            ps.large_text_counter++;
            ps.leaf_term_ref.push_back(-1);
        } else {
            ps.leaf_term_ref.push_back(intern_term(ps, text.data(), text.size()));
        }

        uint32_t ntok = 0;
        uint32_t leaf_idx = (uint32_t)(ps.leaf_anchor.size() - 1);
        if (ps.config.tokenize) {
            size_t before = ps.token_refs.size();
            ntok = tokenize_count(ps, text);
            if (ntok <= 1) {
                // single token == whole text: reference skips token emission
                // (has_tokens() false); undo the interned token count? No —
                // pass 1 counts tokens only when has_tokens() is true, i.e.
                // more than one token. Roll back.
                for (size_t k = before; k < ps.token_refs.size(); k++) {
                    uint32_t h = (uint32_t)ps.token_refs[k];
                    if (ps.tmap.counts[h] > 0) ps.tmap.counts[h]--;
                }
                ps.token_refs.resize(before);
                ps.token_is_sep.resize(before);
                ntok = 0;
            } else {
                // per-leaf (token -> first pos) groups, sorted by (handle, pos)
                size_t n = ps.token_refs.size() - before;
                scratch_pairs.clear();
                for (size_t k = 0; k < n; k++) {
                    scratch_pairs.emplace_back(ps.token_refs[before + k],
                                               (uint32_t)k);
                }
                std::sort(scratch_pairs.begin(), scratch_pairs.end());
                int32_t prev_h = -1;
                for (auto& hp : scratch_pairs) {
                    if (hp.first != prev_h) {
                        ps.grp_token_refs.push_back(hp.first);
                        ps.grp_first_pos.push_back(hp.second);
                        ps.grp_leaf.push_back(leaf_idx);
                        prev_h = hp.first;
                    }
                }
                // phrase pairs: consecutive non-separator tokens
                int32_t prev_tok = -1;
                for (size_t k = 0; k < n; k++) {
                    if (!ps.token_is_sep[before + k]) {
                        int32_t h = ps.token_refs[before + k];
                        if (prev_tok >= 0) {
                            ps.pair_a_refs.push_back(prev_tok);
                            ps.pair_b_refs.push_back(h);
                            ps.pair_anchor.push_back(ps.leaf_anchor[leaf_idx]);
                        }
                        prev_tok = h;
                    }
                }
            }
        }
        ps.leaf_ntokens.push_back(ntok);
        ps.leaf_tok_offsets.push_back((int64_t)ps.token_refs.size());
    }

    // fused parse+walk: consumes one JSON value from the scanner and emits
    // leaves/ids directly — no document tree, no per-node heap churn.
    // Per-depth string pools are reused across documents. std::deque keeps
    // element addresses STABLE across growth — callers hold references into
    // the pools while recursing, and a vector resize at depth >= initial
    // capacity would dangle them.
    std::deque<std::string> key_pool;
    std::deque<std::string> path_pool;
    std::string text_scratch;

    bool stream_value(Parser& p, uint32_t anchor, uint32_t parent,
                      const std::string& current_path,
                      const std::string& el_name, size_t depth) {
        static const std::string kEmpty;
        p.skip_ws();
        if (p.i >= p.n) return false;
        if (depth >= key_pool.size()) {
            key_pool.resize(depth + 8);
            path_pool.resize(depth + 8);
        }
        char c = p.s[p.i];
        if (c == '"') {
            if (!p.parse_string(text_scratch)) return false;
            std::string& path = path_pool[depth];
            path.assign(current_path);
            path.append(el_name);
            text_leaf(anchor, text_scratch, path, parent);
            return true;
        }
        if (c == '[') {
            p.i++;
            std::string& path = path_pool[depth];
            path.assign(current_path);
            path.append(el_name);
            path.append("[]");
            p.skip_ws();
            if (p.i < p.n && p.s[p.i] == ']') {
                p.i++;
                return true;
            }
            IdPathState& ips = id_path_state(path);
            while (p.i < p.n) {
                uint32_t vid = provide_id(path);
                ips.value_id.push_back(vid);
                ips.parent_id.push_back(parent);
                ips.anchor_id.push_back(anchor);
                if (!stream_value(p, anchor, vid, path, kEmpty, depth + 1))
                    return false;
                p.skip_ws();
                if (p.i < p.n && p.s[p.i] == ',') { p.i++; continue; }
                if (p.i < p.n && p.s[p.i] == ']') { p.i++; return true; }
                return false;
            }
            return false;
        }
        if (c == '{') {
            p.i++;
            std::string& path = path_pool[depth];
            path.assign(current_path);
            path.append(el_name);
            if (!path.empty()) path += '.';
            p.skip_ws();
            if (p.i < p.n && p.s[p.i] == '}') {
                p.i++;
                return true;
            }
            while (p.i < p.n) {
                p.skip_ws();
                if (p.i >= p.n || p.s[p.i] != '"') return false;
                std::string& key = key_pool[depth];
                if (!p.parse_string(key)) return false;
                p.skip_ws();
                if (p.i >= p.n || p.s[p.i] != ':') return false;
                p.i++;
                if (!stream_value(p, anchor, parent, path, key, depth + 1))
                    return false;
                p.skip_ws();
                if (p.i < p.n && p.s[p.i] == ',') { p.i++; continue; }
                if (p.i < p.n && p.s[p.i] == '}') { p.i++; return true; }
                return false;
            }
            return false;
        }
        int sc = p.parse_scalar(text_scratch);
        if (sc < 0) return false;
        if (sc == 1) {
            std::string& path = path_pool[depth];
            path.assign(current_path);
            path.append(el_name);
            text_leaf(anchor, text_scratch, path, parent);
        }
        return true;
    }
};

// resolve interned handles to sorted term ids; build terms blob
void finalize_path(PathState& ps) {
    // order handles by term bytes (== codepoint order == python sorted())
    size_t n = ps.tmap.size();
    // prune zero-count terms (rolled-back single-token texts that never
    // appeared elsewhere)
    std::vector<uint32_t> order;
    order.reserve(n);
    for (uint32_t h = 0; h < n; h++) {
        if (ps.tmap.counts[h] > 0) order.push_back(h);
    }
    std::sort(order.begin(), order.end(), [&](uint32_t a, uint32_t b) {
        return ps.tmap.key_less(a, b);
    });
    std::vector<uint32_t> handle_to_id(n, 0xFFFFFFFFu);
    ps.occurrences.resize(order.size());
    size_t blob_size = 0;
    for (size_t r = 0; r < order.size(); r++) blob_size += ps.tmap.key_len[order[r]] + 1;
    ps.terms_blob.reserve(blob_size);
    for (size_t r = 0; r < order.size(); r++) {
        uint32_t h = order[r];
        handle_to_id[h] = (uint32_t)r;
        ps.occurrences[r] = ps.tmap.counts[h];
        if (r) ps.terms_blob.push_back('\0');
        ps.terms_blob.append(ps.tmap.key_ptr[h], ps.tmap.key_len[h]);
    }
    ps.num_terms = (uint32_t)order.size();

    // leaf text ids: normal -> sorted id; large -> reference get_text_info
    // formula continuing from the pass-1 counter (create.rs:141-160)
    uint32_t large_counter = ps.large_text_counter;
    ps.leaf_text_id.resize(ps.leaf_term_ref.size());
    for (size_t i = 0; i < ps.leaf_term_ref.size(); i++) {
        int32_t h = ps.leaf_term_ref[i];
        if (h < 0) {
            large_counter++;
            ps.leaf_text_id[i] = (int64_t)ps.num_terms + 1 + large_counter;
        } else {
            ps.leaf_text_id[i] = handle_to_id[(uint32_t)h];
        }
    }
    // token ids
    ps.token_ids.resize(ps.token_refs.size());
    for (size_t i = 0; i < ps.token_refs.size(); i++) {
        ps.token_ids[i] = handle_to_id[(uint32_t)ps.token_refs[i]];
    }
    ps.grp_token_ids.resize(ps.grp_token_refs.size());
    for (size_t i = 0; i < ps.grp_token_refs.size(); i++) {
        ps.grp_token_ids[i] = handle_to_id[(uint32_t)ps.grp_token_refs[i]];
    }
    ps.pair_a_ids.resize(ps.pair_a_refs.size());
    ps.pair_b_ids.resize(ps.pair_b_refs.size());
    for (size_t i = 0; i < ps.pair_a_refs.size(); i++) {
        ps.pair_a_ids[i] = handle_to_id[(uint32_t)ps.pair_a_refs[i]];
        ps.pair_b_ids[i] = handle_to_id[(uint32_t)ps.pair_b_refs[i]];
    }
    ps.grp_token_refs.clear(); ps.grp_token_refs.shrink_to_fit();
    ps.pair_a_refs.clear(); ps.pair_a_refs.shrink_to_fit();
    ps.pair_b_refs.clear(); ps.pair_b_refs.shrink_to_fit();
    // release intermediates
    ps.tmap = TermMap();
    ps.token_refs.clear();
    ps.token_refs.shrink_to_fit();
}

// ------------------------------------------------- anchor-score packing
// The hot .to_anchor_id_score index built natively: entry generation
// (text-level exact entries + per-(leaf, token) group entries), index-time
// scoring (EXACT float32 port of calculate_score.rs:34-49 / the numpy
// formulas in create.py:calculate_token_score_for_entry), sort by
// (id, anchor), dedup to max score + min(count,5) multi-hit bonus
// (create.rs:418-448), CSR emission.

static inline uint32_t score_entry(float pos, float occ, float ntok,
                                   bool is_exact) {
    float score = is_exact ? 400.0f : 2000.0f / (log2f(pos + 10.0f) + 10.0f);
    float occ_mod = log10f(occ + 1000.0f) - 2.0f;
    occ_mod = occ_mod - (occ_mod - 1.0f) * 0.7f;
    score = score / occ_mod;
    float tl_mod = log10f(ntok + 10.0f);
    tl_mod = tl_mod - (tl_mod - 1.0f) * 0.7f;
    score = score / tl_mod;
    return (uint32_t)score;
}

static void pack_scores(PathState& ps) {
    if (ps.packed_scores) return;
    auto* out = new PackedScores();
    size_t n_text = ps.leaf_text_id.size();
    size_t n_grp = ps.grp_token_ids.size();
    std::vector<std::pair<uint64_t, uint32_t>> entries;
    entries.reserve(n_text + n_grp);
    // text-level exact entries (create_native.py: pos=-1 marker, occ from
    // occurrences for real ids / 1 for synthetic large-text ids, ntok=1)
    for (size_t i = 0; i < n_text; i++) {
        int64_t id = ps.leaf_text_id[i];
        float occ = (id >= 0 && id < (int64_t)ps.num_terms)
                        ? (float)ps.occurrences[(size_t)id]
                        : 1.0f;
        uint32_t sc = score_entry(0.0f, occ, 1.0f, true);
        entries.emplace_back(((uint64_t)id << 32) | ps.leaf_anchor[i], sc);
    }
    // token group entries
    for (size_t g = 0; g < n_grp; g++) {
        uint32_t tid = ps.grp_token_ids[g];
        uint32_t leaf = ps.grp_leaf[g];
        float occ = (float)ps.occurrences[tid];
        float ntok = (float)ps.leaf_ntokens[leaf];
        uint32_t sc =
            score_entry((float)ps.grp_first_pos[g], occ, ntok, false);
        entries.emplace_back(
            ((uint64_t)tid << 32) | ps.leaf_anchor[leaf], sc);
    }
    std::sort(entries.begin(), entries.end(),
              [](const auto& a, const auto& b) { return a.first < b.first; });
    // group: max + bonus
    int64_t max_id = -1;
    size_t i = 0, n = entries.size();
    out->anchors.reserve(n);
    out->scores.reserve(n);
    std::vector<std::pair<int64_t, uint32_t>> per_key_counts;  // (id, count)
    while (i < n) {
        uint64_t key = entries[i].first;
        uint32_t best = entries[i].second;
        size_t j = i + 1;
        while (j < n && entries[j].first == key) {
            if (entries[j].second > best) best = entries[j].second;
            j++;
        }
        uint64_t cnt = j - i;
        uint32_t bonus = cnt > 1 ? (uint32_t)(cnt < 5 ? cnt : 5) : 0;
        uint32_t fin = best + bonus;
        int64_t id = (int64_t)(key >> 32);
        out->anchors.push_back((uint32_t)(key & 0xFFFFFFFFu));
        out->scores.push_back((uint16_t)(fin < 0xFFFF ? fin : 0xFFFF));
        if (id != max_id) {
            per_key_counts.emplace_back(id, 1);
            max_id = id;
        } else {
            per_key_counts.back().second++;
        }
        i = j;
    }
    int64_t nkeys = max_id + 1;
    out->offsets.assign((size_t)(nkeys + 1), 0);
    for (auto& kc : per_key_counts) out->offsets[(size_t)kc.first + 1] = kc.second;
    for (size_t k = 1; k < out->offsets.size(); k++)
        out->offsets[k] += out->offsets[k - 1];
    ps.packed_scores = out;
}

}  // namespace


// ---------------------------------------------------------------------------
// Block codec: LZ4-format-style byte LZ (token = lit-nibble|match-nibble,
// 255-run length extension, 16-bit LE match offset, min match 4). Same
// latency class as the reference's LZ4 doc-store blocks
// (doc_store/src/lib.rs:131-149) without an external dependency. The format
// is ours end-to-end (DocStoreWriter/DocLoader are the only producers and
// consumers); the decoder is fully bounds-checked.
namespace vlz {

static inline uint32_t read32(const uint8_t* p) {
    uint32_t v;
    memcpy(&v, p, 4);
    return v;
}
static inline uint32_t hash32(uint32_t v) { return (v * 2654435761u) >> 16; }

static int64_t compress(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap) {
    if (n < 0 || n > INT32_MAX) return -1;
    int64_t op = 0;
    auto emit_run = [&](int64_t len) -> bool {
        while (len >= 255) {
            if (op >= cap) return false;
            dst[op++] = 255;
            len -= 255;
        }
        if (op >= cap) return false;
        dst[op++] = (uint8_t)len;
        return true;
    };
    // generation-stamped match table, reused across calls: the doc store
    // compresses thousands of 16 KB blocks, and a fresh 256 KB table fill
    // per block costs more than the matching itself
    struct MatchTable {
        std::vector<uint64_t> slots;  // (generation << 32) | pos
        uint32_t gen = 0;
        MatchTable() : slots((size_t)1 << 16, 0) {}
    };
    static thread_local MatchTable mt;
    mt.gen++;
    if (mt.gen == 0) {  // u32 wrap: hard reset once every 4B calls
        std::fill(mt.slots.begin(), mt.slots.end(), 0);
        mt.gen = 1;
    }
    const uint64_t gen_tag = (uint64_t)mt.gen << 32;
    uint64_t* table = mt.slots.data();
    int64_t ip = 0, anchor = 0;
    const int64_t mflimit = n - 12;
    while (ip <= mflimit && ip >= 0) {
        uint32_t h = hash32(read32(src + ip));
        uint64_t slot = table[h];
        int64_t cand = (slot >> 32) == mt.gen ? (int64_t)(uint32_t)slot : -1;
        table[h] = gen_tag | (uint32_t)ip;
        if (cand >= 0 && ip - cand <= 65535 && read32(src + cand) == read32(src + ip)) {
            int64_t mlen = 4;
            while (ip + mlen < n - 5 && src[cand + mlen] == src[ip + mlen]) mlen++;
            int64_t lit = ip - anchor;
            if (op >= cap) return -1;
            int64_t tok_pos = op++;
            uint8_t t_lit = lit >= 15 ? 15 : (uint8_t)lit;
            uint8_t t_ml = (mlen - 4) >= 15 ? 15 : (uint8_t)(mlen - 4);
            dst[tok_pos] = (uint8_t)((t_lit << 4) | t_ml);
            if (lit >= 15 && !emit_run(lit - 15)) return -1;
            if (op + lit > cap) return -1;
            memcpy(dst + op, src + anchor, (size_t)lit);
            op += lit;
            if (op + 2 > cap) return -1;
            uint16_t off = (uint16_t)(ip - cand);
            dst[op++] = (uint8_t)(off & 0xff);
            dst[op++] = (uint8_t)(off >> 8);
            if ((mlen - 4) >= 15 && !emit_run(mlen - 4 - 15)) return -1;
            ip += mlen;
            anchor = ip;
            if (ip - 2 > 0 && ip - 2 <= mflimit)
                table[hash32(read32(src + ip - 2))] = gen_tag | (uint32_t)(ip - 2);
        } else {
            ip++;
        }
    }
    int64_t lit = n - anchor;
    if (op >= cap) return -1;
    uint8_t t_lit = lit >= 15 ? 15 : (uint8_t)lit;
    dst[op++] = (uint8_t)(t_lit << 4);
    if (lit >= 15 && !emit_run(lit - 15)) return -1;
    if (op + lit > cap) return -1;
    memcpy(dst + op, src + anchor, (size_t)lit);
    op += lit;
    return op;
}

static int64_t decompress(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap) {
    int64_t ip = 0, op = 0;
    while (ip < n) {
        uint8_t token = src[ip++];
        int64_t lit = token >> 4;
        if (lit == 15) {
            uint8_t b;
            do {
                if (ip >= n) return -1;
                b = src[ip++];
                lit += b;
            } while (b == 255);
        }
        if (ip + lit > n || op + lit > cap) return -1;
        memcpy(dst + op, src + ip, (size_t)lit);
        ip += lit;
        op += lit;
        if (ip >= n) break;  // final sequence carries literals only
        if (ip + 2 > n) return -1;
        int64_t off = (int64_t)src[ip] | ((int64_t)src[ip + 1] << 8);
        ip += 2;
        if (off == 0 || off > op) return -1;
        int64_t mlen = token & 15;
        if (mlen == 15) {
            uint8_t b;
            do {
                if (ip >= n) return -1;
                b = src[ip++];
                mlen += b;
            } while (b == 255);
        }
        mlen += 4;
        if (op + mlen > cap) return -1;
        const uint8_t* m = dst + op - off;
        if (off >= mlen) {
            memcpy(dst + op, m, (size_t)mlen);
        } else {
            for (int64_t i = 0; i < mlen; i++) dst[op + i] = m[i];
        }
        op += mlen;
    }
    return op;
}

}  // namespace vlz

// parse a byte range into `res` WITHOUT finalizing; fills res->id_alloc
// with the number of ids allocated per id-space (used by the merge)
static void parse_range(const char* data, int64_t len, PathConfigCb cb,
                        IndexResult* res) {
    Walker w{res, cb, {}};
    Parser p{data, len};
    static const std::string kEmpty;
    while (true) {
        p.skip_ws();
        if (p.i >= p.n) break;
        uint32_t anchor = w.provide_id("");
        if (!w.stream_value(p, anchor, anchor, kEmpty, kEmpty, 0)) {
            res->error = "json parse error at byte " + std::to_string(p.i);
            break;
        }
        res->num_docs++;
    }
    for (auto& kv : w.id_counters) res->id_alloc[kv.first] = kv.second + 1;
}

// id-space of the values that `path` rows point at as parents: the nearest
// enclosing array path, or "" (the anchor/doc space). For an id path (which
// itself ends in "[]"), the trailing "[]" is stripped first.
static std::string parent_space(const std::string& path, bool is_id_path) {
    std::string s = path;
    if (is_id_path && s.size() >= 2 && s.compare(s.size() - 2, 2, "[]") == 0)
        s.resize(s.size() - 2);
    size_t pos = s.rfind("[]");
    if (pos == std::string::npos) return "";
    return s.substr(0, pos + 2);
}

// merged-intern: add `cnt` occurrences of `key`, returning the merged handle
static inline int32_t intern_add(PathState& ps, const char* key, size_t len,
                                 uint32_t cnt) {
    return ps.tmap.add(key, len, cnt);
}

// Merge per-chunk parse results into one, offsetting every id space by the
// chunk bases. The merged result finalizes exactly like the single-threaded
// path, so term ids / text ids / synthetic large-text ids are bit-identical
// (terms sort globally; leaves concatenate in document order).
static IndexResult* merge_results(std::vector<IndexResult*>& chunks) {
    auto* m = new IndexResult();
    size_t nc = chunks.size();
    // running id-space bases per chunk
    std::vector<std::unordered_map<std::string, uint32_t>> base_at(nc);
    std::unordered_map<std::string, uint32_t> running;
    for (size_t c = 0; c < nc; c++) {
        base_at[c] = running;
        for (auto& kv : chunks[c]->id_alloc) running[kv.first] += kv.second;
        m->num_docs += chunks[c]->num_docs;
        if (m->error.empty() && !chunks[c]->error.empty())
            m->error = chunks[c]->error;
    }
    auto base_of = [&](size_t c, const std::string& space) -> uint32_t {
        auto it = base_at[c].find(space);
        return it == base_at[c].end() ? 0u : it->second;
    };

    // text paths, first-encounter order across chunks
    for (size_t c = 0; c < nc; c++) {
        for (auto* s : chunks[c]->paths) {
            if (m->path_index.count(s->name)) continue;
            auto* mp = new PathState();
            mp->name = s->name;
            mp->config = s->config;
            mp->leaf_tok_offsets.push_back(0);
            m->path_index.emplace(s->name, (int32_t)m->paths.size());
            m->paths.push_back(mp);
        }
        for (auto* s : chunks[c]->id_paths) {
            if (m->id_path_index.count(s->name)) continue;
            auto* mp = new IdPathState();
            mp->name = s->name;
            m->id_path_index.emplace(s->name, (int32_t)m->id_paths.size());
            m->id_paths.push_back(mp);
        }
    }

    std::vector<int32_t> hmap;
    for (size_t c = 0; c < nc; c++) {
        uint32_t doc_base = base_of(c, "");
        for (auto* s : chunks[c]->paths) {
            PathState& mp = *m->paths[m->path_index.at(s->name)];
            uint32_t pbase = base_of(c, parent_space(s->name, false));
            // remap interned handles
            hmap.assign(s->tmap.size(), -1);
            for (size_t h = 0; h < s->tmap.size(); h++) {
                hmap[h] = intern_add(mp, s->tmap.key_ptr[h],
                                     s->tmap.key_len[h], s->tmap.counts[h]);
            }
            uint32_t leaf_base = (uint32_t)mp.leaf_anchor.size();
            int64_t tok_base = (int64_t)mp.token_refs.size();
            for (size_t i = 0; i < s->leaf_anchor.size(); i++) {
                mp.leaf_anchor.push_back(s->leaf_anchor[i] + doc_base);
                mp.leaf_parent.push_back(s->leaf_parent[i] + pbase);
                int32_t h = s->leaf_term_ref[i];
                mp.leaf_term_ref.push_back(h < 0 ? -1 : hmap[(size_t)h]);
                mp.leaf_ntokens.push_back(s->leaf_ntokens[i]);
                mp.leaf_tok_offsets.push_back(s->leaf_tok_offsets[i + 1] + tok_base);
            }
            for (size_t i = 0; i < s->token_refs.size(); i++) {
                mp.token_refs.push_back(hmap[(size_t)s->token_refs[i]]);
                mp.token_is_sep.push_back(s->token_is_sep[i]);
            }
            for (size_t i = 0; i < s->grp_token_refs.size(); i++) {
                mp.grp_token_refs.push_back(hmap[(size_t)s->grp_token_refs[i]]);
                mp.grp_first_pos.push_back(s->grp_first_pos[i]);
                mp.grp_leaf.push_back(s->grp_leaf[i] + leaf_base);
            }
            for (size_t i = 0; i < s->pair_a_refs.size(); i++) {
                mp.pair_a_refs.push_back(hmap[(size_t)s->pair_a_refs[i]]);
                mp.pair_b_refs.push_back(hmap[(size_t)s->pair_b_refs[i]]);
                mp.pair_anchor.push_back(s->pair_anchor[i] + doc_base);
            }
            mp.large_text_counter += s->large_text_counter;
        }
        for (auto* s : chunks[c]->id_paths) {
            IdPathState& mp = *m->id_paths[m->id_path_index.at(s->name)];
            uint32_t own_base = base_of(c, s->name);
            uint32_t pbase = base_of(c, parent_space(s->name, true));
            for (size_t i = 0; i < s->value_id.size(); i++) {
                mp.value_id.push_back(s->value_id[i] + own_base);
                mp.parent_id.push_back(s->parent_id[i] + pbase);
                mp.anchor_id.push_back(s->anchor_id[i] + doc_base);
            }
        }
        delete chunks[c];
        chunks[c] = nullptr;
    }
    return m;
}

// ------------------------------------------------------------ radix sort
// LSD byte-radix sorts used by the Python packing passes (csr_from_pairs /
// _pack_phrase): these replace numpy's comparison sorts in the index-build
// hot loop (reference BufferedIndexWriter sorts its spill parts the same
// way conceptually, buffered_index_writer/src/lib.rs:245-270). Stable;
// passes whose byte is constant across the array are skipped.

static void radix_pass_u64(const uint64_t* in, uint64_t* out, int64_t n,
                           int shift, const int64_t* hist) {
    int64_t pos[256];
    int64_t run = 0;
    for (int b = 0; b < 256; b++) {
        pos[b] = run;
        run += hist[b];
    }
    for (int64_t i = 0; i < n; i++) {
        out[pos[(in[i] >> shift) & 0xFF]++] = in[i];
    }
}

static void radix_sort_u64(uint64_t* data, int64_t n) {
    if (n < 2) return;
    std::vector<uint64_t> tmp((size_t)n);
    uint64_t* a = data;
    uint64_t* b = tmp.data();
    // one histogram sweep for all 8 byte positions
    int64_t hist[8][256] = {};
    for (int64_t i = 0; i < n; i++) {
        uint64_t v = a[i];
        for (int p = 0; p < 8; p++) hist[p][(v >> (p * 8)) & 0xFF]++;
    }
    for (int p = 0; p < 8; p++) {
        // skip pass if every element shares this byte
        bool constant = false;
        for (int bkt = 0; bkt < 256; bkt++) {
            if (hist[p][bkt] == n) { constant = true; break; }
        }
        if (constant) continue;
        radix_pass_u64(a, b, n, p * 8, hist[p]);
        std::swap(a, b);
    }
    if (a != data) memcpy(data, a, (size_t)n * sizeof(uint64_t));
}

// stable sort of (key, val) pairs by key (byte-radix), payload carried along
static void radix_sort_u64_kv(uint64_t* keys, uint32_t* vals, int64_t n) {
    if (n < 2) return;
    std::vector<uint64_t> ktmp((size_t)n);
    std::vector<uint32_t> vtmp((size_t)n);
    uint64_t *ka = keys, *kb = ktmp.data();
    uint32_t *va = vals, *vb = vtmp.data();
    int64_t hist[8][256] = {};
    for (int64_t i = 0; i < n; i++) {
        uint64_t v = keys[i];
        for (int p = 0; p < 8; p++) hist[p][(v >> (p * 8)) & 0xFF]++;
    }
    for (int p = 0; p < 8; p++) {
        bool constant = false;
        for (int bkt = 0; bkt < 256; bkt++) {
            if (hist[p][bkt] == n) { constant = true; break; }
        }
        if (constant) continue;
        int64_t pos[256];
        int64_t run = 0;
        for (int bkt = 0; bkt < 256; bkt++) {
            pos[bkt] = run;
            run += hist[p][bkt];
        }
        int shift = p * 8;
        for (int64_t i = 0; i < n; i++) {
            int64_t dst = pos[(ka[i] >> shift) & 0xFF]++;
            kb[dst] = ka[i];
            vb[dst] = va[i];
        }
        std::swap(ka, kb);
        std::swap(va, vb);
    }
    if (ka != keys) memcpy(keys, ka, (size_t)n * sizeof(uint64_t));
    if (va != vals) memcpy(vals, va, (size_t)n * sizeof(uint32_t));
}

extern "C" {

// in-place stable LSD radix sort of u64
void vl_radix_sort_u64(uint64_t* data, int64_t n) { radix_sort_u64(data, n); }

// stable sort by u64 key carrying a u32 payload
void vl_radix_sort_u64_kv32(uint64_t* keys, uint32_t* vals, int64_t n) {
    radix_sort_u64_kv(keys, vals, n);
}

// pack a CSR from (key, value) pairs entirely natively — the whole
// csr_from_pairs body (sort + optional pair-dedup + bincount + prefix sum)
// without round-tripping intermediates through numpy.
//   mode 0: stable sort by key (values keep insertion order per key)
//   mode 1: sort by the combined (key << 32 | value) u64 and dedup exact
//           pairs (caller guarantees key < 2^31)
// keys/values are modified in place; the first m entries survive. offsets
// (u64[num_keys + 1]) is fully written. Returns m, or -1 if a key is out
// of [0, num_keys).
int64_t vl_pack_csr(uint64_t* keys, uint32_t* values, int64_t n,
                    int64_t num_keys, int32_t mode, uint64_t* offsets) {
    int64_t m = n;
    if (mode == 1) {
        std::vector<uint64_t> combo((size_t)n);
        for (int64_t i = 0; i < n; i++)
            combo[(size_t)i] = (keys[i] << 32) | values[i];
        radix_sort_u64(combo.data(), n);
        m = 0;
        for (int64_t i = 0; i < n; i++) {
            if (i && combo[(size_t)i] == combo[(size_t)i - 1]) continue;
            keys[m] = combo[(size_t)i] >> 32;
            values[m] = (uint32_t)(combo[(size_t)i] & 0xFFFFFFFFu);
            m++;
        }
    } else {
        radix_sort_u64_kv(keys, values, n);
    }
    memset(offsets, 0, (size_t)(num_keys + 1) * sizeof(uint64_t));
    for (int64_t i = 0; i < m; i++) {
        if ((int64_t)keys[i] >= num_keys) return -1;
        offsets[keys[i] + 1]++;
    }
    for (int64_t k = 0; k < num_keys; k++) offsets[k + 1] += offsets[k];
    return m;
}

void vl_lexsort_u64_u32(uint64_t* keys, uint32_t* vals, int64_t n);

// phrase-pair index packing: lexicographic (key, value) sort, exact-pair
// dedup, unique-key compaction + offsets — stream_iter_to_phrase_index
// semantics in one native call. keys/values in place (first m values and
// first nk keys survive); offsets u64[n + 1] (first nk + 1 valid).
// Returns m; *out_nkeys = nk.
int64_t vl_pack_phrase(uint64_t* keys, uint32_t* values, int64_t n,
                       uint64_t* offsets, int64_t* out_nkeys) {
    if (n > 1) {
        vl_lexsort_u64_u32(keys, values, n);
    }
    int64_t m = 0;
    for (int64_t i = 0; i < n; i++) {
        if (i && keys[i] == keys[i - 1] && values[i] == values[i - 1]) continue;
        keys[m] = keys[i];
        values[m] = values[i];
        m++;
    }
    int64_t nk = 0;
    offsets[0] = 0;
    for (int64_t i = 0; i < m; i++) {
        if (i == 0 || keys[i] != keys[nk - 1]) {
            keys[nk] = keys[i];
            offsets[nk + 1] = offsets[nk];
            nk++;
        }
        offsets[nk]++;
    }
    *out_nkeys = nk;
    return m;
}

// lexicographic (key, val) sort: stable radix by val then stable by key —
// equivalent to np.lexsort((vals, keys)) applied to both arrays
void vl_lexsort_u64_u32(uint64_t* keys, uint32_t* vals, int64_t n) {
    if (n < 2) return;
    // pass 1: stable sort both arrays by the 32-bit val
    std::vector<uint64_t> kt((size_t)n);
    std::vector<uint32_t> vt((size_t)n);
    int64_t hist[4][256] = {};
    for (int64_t i = 0; i < n; i++) {
        uint32_t v = vals[i];
        for (int p = 0; p < 4; p++) hist[p][(v >> (p * 8)) & 0xFF]++;
    }
    uint64_t* ka = keys;
    uint64_t* kb = kt.data();
    uint32_t* va = vals;
    uint32_t* vb = vt.data();
    for (int p = 0; p < 4; p++) {
        bool constant = false;
        for (int bkt = 0; bkt < 256; bkt++) {
            if (hist[p][bkt] == n) { constant = true; break; }
        }
        if (constant) continue;
        int64_t pos[256];
        int64_t run = 0;
        for (int bkt = 0; bkt < 256; bkt++) {
            pos[bkt] = run;
            run += hist[p][bkt];
        }
        int shift = p * 8;
        for (int64_t i = 0; i < n; i++) {
            int64_t dst = pos[(va[i] >> shift) & 0xFF]++;
            kb[dst] = ka[i];
            vb[dst] = va[i];
        }
        std::swap(ka, kb);
        std::swap(va, vb);
    }
    if (ka != keys) memcpy(keys, ka, (size_t)n * sizeof(uint64_t));
    if (va != vals) memcpy(vals, va, (size_t)n * sizeof(uint32_t));
    // pass 2: stable sort by key
    radix_sort_u64_kv(keys, vals, n);
}

void* vl_index_ndjson(const char* data, int64_t len, PathConfigCb cb) {
    auto* res = new IndexResult();
    const bool prof = getenv("VELOCI_NATIVE_PROF") != nullptr;
    auto t0 = std::chrono::steady_clock::now();
    parse_range(data, len, cb, res);
    auto t1 = std::chrono::steady_clock::now();
    for (auto* ps : res->paths) finalize_path(*ps);
    auto t2 = std::chrono::steady_clock::now();
    if (prof) {
        auto ms = [](auto a, auto b) {
            return std::chrono::duration<double, std::milli>(b - a).count();
        };
        fprintf(stderr, "[vl prof] parse %.1fms finalize %.1fms\n",
                ms(t0, t1), ms(t1, t2));
    }
    return res;
}

// multi-threaded variant: chunk the ndjson at line boundaries, parse chunks
// in parallel (the reference pipelines parsing on a producer thread,
// fast_lines.rs:12-35, and converts with rayon, create.rs:612-614), then
// merge + finalize. Bit-identical output to vl_index_ndjson.
void* vl_index_ndjson_mt(const char* data, int64_t len, PathConfigCb cb,
                         int32_t nthreads) {
    if (nthreads <= 0) {
        unsigned hc = std::thread::hardware_concurrency();
        nthreads = (int32_t)(hc == 0 ? 4 : hc);
        if (nthreads > 16) nthreads = 16;
        // auto mode: don't spin threads for small inputs
        const int64_t MIN_CHUNK = 1 << 20;
        if (len / nthreads < MIN_CHUNK) nthreads = (int32_t)(len / MIN_CHUNK);
    }
    if (nthreads <= 1) return vl_index_ndjson(data, len, cb);

    // split at newline boundaries (ndjson: one document per line)
    std::vector<int64_t> bounds;
    bounds.push_back(0);
    for (int32_t t = 1; t < nthreads; t++) {
        int64_t target = len * t / nthreads;
        if (target < bounds.back()) target = bounds.back();
        while (target < len && data[target] != '\n') target++;
        if (target < len) target++;  // past the newline
        if (target > bounds.back()) bounds.push_back(target);
    }
    bounds.push_back(len);

    size_t nchunks = bounds.size() - 1;
    std::vector<IndexResult*> chunks(nchunks);
    for (size_t c = 0; c < nchunks; c++) chunks[c] = new IndexResult();
    std::vector<std::thread> threads;
    threads.reserve(nchunks);
    for (size_t c = 0; c < nchunks; c++) {
        threads.emplace_back([&, c]() {
            parse_range(data + bounds[c], bounds[c + 1] - bounds[c], cb,
                        chunks[c]);
        });
    }
    for (auto& t : threads) t.join();
    IndexResult* merged = merge_results(chunks);
    for (auto* ps : merged->paths) finalize_path(*ps);
    return merged;
}

const char* vl_error(void* r) { return ((IndexResult*)r)->error.c_str(); }
int64_t vl_num_docs(void* r) { return ((IndexResult*)r)->num_docs; }
int32_t vl_num_paths(void* r) { return (int32_t)((IndexResult*)r)->paths.size(); }

int64_t vl_path_name(void* r, int32_t p, const char** out) {
    auto& ps = *((IndexResult*)r)->paths[p];
    *out = ps.name.data();
    return (int64_t)ps.name.size();
}
int64_t vl_terms_blob(void* r, int32_t p, const char** out) {
    auto& ps = *((IndexResult*)r)->paths[p];
    *out = ps.terms_blob.data();
    return (int64_t)ps.terms_blob.size();
}
int64_t vl_num_terms(void* r, int32_t p) {
    return ((IndexResult*)r)->paths[p]->num_terms;
}
const uint32_t* vl_term_occurrences(void* r, int32_t p) {
    return ((IndexResult*)r)->paths[p]->occurrences.data();
}
int64_t vl_num_leaves(void* r, int32_t p) {
    return (int64_t)((IndexResult*)r)->paths[p]->leaf_anchor.size();
}
const uint32_t* vl_leaf_anchor(void* r, int32_t p) {
    return ((IndexResult*)r)->paths[p]->leaf_anchor.data();
}
const uint32_t* vl_leaf_parent(void* r, int32_t p) {
    return ((IndexResult*)r)->paths[p]->leaf_parent.data();
}
const int64_t* vl_leaf_text_id(void* r, int32_t p) {
    return ((IndexResult*)r)->paths[p]->leaf_text_id.data();
}
const uint32_t* vl_leaf_ntokens(void* r, int32_t p) {
    return ((IndexResult*)r)->paths[p]->leaf_ntokens.data();
}
const int64_t* vl_leaf_tok_offsets(void* r, int32_t p) {
    auto& ps = *((IndexResult*)r)->paths[p];
    if (ps.leaf_tok_offsets.empty()) ps.leaf_tok_offsets.push_back(0);
    return ps.leaf_tok_offsets.data();
}
const uint32_t* vl_tokens(void* r, int32_t p) {
    return ((IndexResult*)r)->paths[p]->token_ids.data();
}
int64_t vl_num_tokens(void* r, int32_t p) {
    return (int64_t)((IndexResult*)r)->paths[p]->token_ids.size();
}
const uint8_t* vl_token_is_sep(void* r, int32_t p) {
    return ((IndexResult*)r)->paths[p]->token_is_sep.data();
}
int64_t vl_large_text_count(void* r, int32_t p) {
    return ((IndexResult*)r)->paths[p]->large_text_counter;
}
int64_t vl_num_groups(void* r, int32_t p) {
    return (int64_t)((IndexResult*)r)->paths[p]->grp_token_ids.size();
}
const uint32_t* vl_grp_token(void* r, int32_t p) {
    return ((IndexResult*)r)->paths[p]->grp_token_ids.data();
}
const uint32_t* vl_grp_pos(void* r, int32_t p) {
    return ((IndexResult*)r)->paths[p]->grp_first_pos.data();
}
const uint32_t* vl_grp_leaf(void* r, int32_t p) {
    return ((IndexResult*)r)->paths[p]->grp_leaf.data();
}
int64_t vl_num_phrase_pairs(void* r, int32_t p) {
    return (int64_t)((IndexResult*)r)->paths[p]->pair_a_ids.size();
}
const uint32_t* vl_pair_a(void* r, int32_t p) {
    return ((IndexResult*)r)->paths[p]->pair_a_ids.data();
}
const uint32_t* vl_pair_b(void* r, int32_t p) {
    return ((IndexResult*)r)->paths[p]->pair_b_ids.data();
}
const uint32_t* vl_pair_anchor(void* r, int32_t p) {
    return ((IndexResult*)r)->paths[p]->pair_anchor.data();
}

int32_t vl_num_id_paths(void* r) {
    return (int32_t)((IndexResult*)r)->id_paths.size();
}
int64_t vl_id_path_name(void* r, int32_t p, const char** out) {
    auto& ps = *((IndexResult*)r)->id_paths[p];
    *out = ps.name.data();
    return (int64_t)ps.name.size();
}
int64_t vl_num_id_pairs(void* r, int32_t p) {
    return (int64_t)((IndexResult*)r)->id_paths[p]->value_id.size();
}
const uint32_t* vl_id_value(void* r, int32_t p) {
    return ((IndexResult*)r)->id_paths[p]->value_id.data();
}
const uint32_t* vl_id_parent(void* r, int32_t p) {
    return ((IndexResult*)r)->id_paths[p]->parent_id.data();
}
const uint32_t* vl_id_anchor(void* r, int32_t p) {
    return ((IndexResult*)r)->id_paths[p]->anchor_id.data();
}


int64_t vl_lz_bound(int64_t n) { return n + n / 255 + 16; }
int64_t vl_lz_compress(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap) {
    return vlz::compress(src, n, dst, cap);
}
int64_t vl_lz_decompress(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap) {
    return vlz::decompress(src, n, dst, cap);
}

void vl_free(void* r) { delete (IndexResult*)r; }

// anchor-score packing (built on demand, cached on the path state)
int64_t vl_pack_scores(void* r, int32_t p) {
    PathState& ps = *((IndexResult*)r)->paths[p];
    pack_scores(ps);
    return (int64_t)ps.packed_scores->anchors.size();
}
int64_t vl_score_num_keys(void* r, int32_t p) {
    PathState& ps = *((IndexResult*)r)->paths[p];
    if (!ps.packed_scores) return 0;
    return (int64_t)ps.packed_scores->offsets.size() - 1;
}
const uint64_t* vl_score_offsets(void* r, int32_t p) {
    return ((IndexResult*)r)->paths[p]->packed_scores->offsets.data();
}
const uint32_t* vl_score_anchors(void* r, int32_t p) {
    return ((IndexResult*)r)->paths[p]->packed_scores->anchors.data();
}
const uint16_t* vl_score_values(void* r, int32_t p) {
    return ((IndexResult*)r)->paths[p]->packed_scores->scores.data();
}

}  // extern "C"
