"""ctypes bindings for the native indexing core (native/indexer.cpp).

Loads (building on demand with g++ if needed) ``libveloci_native.so`` and
exposes :func:`index_ndjson`, which parses + flattens + tokenizes + counts an
ndjson corpus in C++ and returns numpy arrays per field path. The pure-Python
pipeline in :mod:`veloci_tpu.create` remains the reference implementation and
fallback; parity between the two is covered by tests.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

import numpy as np

__all__ = [
    "native_available",
    "index_ndjson",
    "NativePath",
    "NativeIdPath",
    "lz_available",
    "lz_compress",
    "lz_decompress",
]

_LIB: Optional[ctypes.CDLL] = None
_LIB_TRIED = False

_NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"


def _tune_malloc() -> None:
    """Keep large allocations on the (warm) sbrk heap instead of fresh mmaps.

    Index builds churn through multi-MB scratch buffers (radix-sort temps,
    numpy copies). glibc serves allocations over 128 KB from fresh mmap
    pages, and on virtualized hosts first-touch faults can cost ~57 us/page
    (measured on the dev VM: a 200 MB fresh-page walk = 11 s) — dwarfing
    the actual sort work. Raising M_MMAP_THRESHOLD and M_TRIM_THRESHOLD
    keeps freed blocks pooled for reuse, trading retained RSS for not
    re-faulting the same pages every build (A/B at 200k docs: 2.3 s ->
    1.7 s warm). ``VELOCI_MALLOC_TUNE=0`` opts out."""
    if os.environ.get("VELOCI_MALLOC_TUNE", "1") == "0":
        return
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3
        libc.mallopt(M_MMAP_THRESHOLD, 1 << 30)
        libc.mallopt(M_TRIM_THRESHOLD, 1 << 30)
    except Exception:  # pragma: no cover - tuning is best-effort
        pass


_tune_malloc()


def _source_digest(src: Path) -> str:
    import hashlib

    return hashlib.sha256(src.read_bytes()).hexdigest()[:16]


_SOURCES = ("indexer.cpp", "baseline.cpp")
# -march=native: the indexer/doc-store/baseline run on the build host only
# (the cached .so is keyed by source + flags, rebuilt per machine)
_CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")


def _so_path() -> Path:
    """Build-cache location keyed by a CONTENT hash of the C++ sources.

    The library is never committed and never trusted by mtime (checkout
    mtimes are meaningless): a given source text maps to exactly one cached
    binary, so staleness detection is content-based. The default cache is
    ``native/build/`` in the checkout (gitignored); VELOCI_NATIVE_CACHE
    overrides it.
    """
    import hashlib

    h = hashlib.sha256()
    h.update(" ".join(_CXX_FLAGS).encode())
    for name in _SOURCES:
        src = _NATIVE_DIR / name
        if src.exists():
            h.update(src.read_bytes())
    digest = h.hexdigest()[:16] if (_NATIVE_DIR / _SOURCES[0]).exists() else "nosrc"
    cache = Path(os.environ.get("VELOCI_NATIVE_CACHE", _NATIVE_DIR / "build"))
    return cache / f"libveloci_native-{digest}.so"

_CONFIG_CB = ctypes.CFUNCTYPE(
    ctypes.c_int32,
    ctypes.POINTER(ctypes.c_char),  # path (NOT c_char_p: keep the raw pointer)
    ctypes.c_int32,  # path_len
    ctypes.POINTER(ctypes.c_uint8),  # tokenize out
    ctypes.POINTER(ctypes.c_int32),  # do_not_store_longer_than out
    ctypes.POINTER(ctypes.c_char),  # separators buf (writable)
    ctypes.POINTER(ctypes.c_int32),  # separators len in/out
)


def _build_lib(so_path: Path) -> bool:
    srcs = [_NATIVE_DIR / name for name in _SOURCES if (_NATIVE_DIR / name).exists()]
    if not srcs:
        return False
    try:
        so_path.parent.mkdir(parents=True, exist_ok=True)
        tmp = so_path.with_suffix(".tmp.so")
        subprocess.run(
            ["g++", *_CXX_FLAGS, "-o", str(tmp)] + [str(s) for s in srcs],
            check=True,
            capture_output=True,
        )
        os.replace(tmp, so_path)  # atomic: parallel builders race safely
        return True
    except Exception:
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _LIB_TRIED
    if _LIB is not None or _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    if os.environ.get("VELOCI_TPU_NO_NATIVE"):
        return None
    so_path = _so_path()
    if not so_path.exists():
        if not _build_lib(so_path):
            return None
    try:
        lib = ctypes.CDLL(str(so_path))
    except OSError:
        return None
    lib.vl_index_ndjson.restype = ctypes.c_void_p
    lib.vl_index_ndjson.argtypes = [ctypes.c_char_p, ctypes.c_int64, _CONFIG_CB]
    lib.vl_index_ndjson_mt.restype = ctypes.c_void_p
    lib.vl_index_ndjson_mt.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int64,
        _CONFIG_CB,
        ctypes.c_int32,
    ]
    lib.vl_error.restype = ctypes.c_char_p
    lib.vl_error.argtypes = [ctypes.c_void_p]
    lib.vl_num_docs.restype = ctypes.c_int64
    lib.vl_num_docs.argtypes = [ctypes.c_void_p]
    lib.vl_num_paths.restype = ctypes.c_int32
    lib.vl_num_paths.argtypes = [ctypes.c_void_p]
    for name, restype in [
        ("vl_path_name", ctypes.c_int64),
        ("vl_terms_blob", ctypes.c_int64),
    ]:
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.POINTER(ctypes.c_char_p)]
    for name, restype in [
        ("vl_num_terms", ctypes.c_int64),
        ("vl_num_leaves", ctypes.c_int64),
        ("vl_num_tokens", ctypes.c_int64),
        ("vl_large_text_count", ctypes.c_int64),
        ("vl_num_id_pairs", ctypes.c_int64),
        ("vl_num_groups", ctypes.c_int64),
        ("vl_num_phrase_pairs", ctypes.c_int64),
    ]:
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    for name, ptr_t in [
        ("vl_term_occurrences", ctypes.c_uint32),
        ("vl_leaf_anchor", ctypes.c_uint32),
        ("vl_leaf_parent", ctypes.c_uint32),
        ("vl_leaf_text_id", ctypes.c_int64),
        ("vl_leaf_ntokens", ctypes.c_uint32),
        ("vl_leaf_tok_offsets", ctypes.c_int64),
        ("vl_tokens", ctypes.c_uint32),
        ("vl_token_is_sep", ctypes.c_uint8),
        ("vl_grp_token", ctypes.c_uint32),
        ("vl_grp_pos", ctypes.c_uint32),
        ("vl_grp_leaf", ctypes.c_uint32),
        ("vl_pair_a", ctypes.c_uint32),
        ("vl_pair_b", ctypes.c_uint32),
        ("vl_pair_anchor", ctypes.c_uint32),
        ("vl_id_value", ctypes.c_uint32),
        ("vl_id_parent", ctypes.c_uint32),
        ("vl_id_anchor", ctypes.c_uint32),
    ]:
        fn = getattr(lib, name)
        fn.restype = ctypes.POINTER(ptr_t)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.vl_pack_scores.restype = ctypes.c_int64
    lib.vl_pack_scores.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.vl_score_num_keys.restype = ctypes.c_int64
    lib.vl_score_num_keys.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    for name, ptr_t in [
        ("vl_score_offsets", ctypes.c_uint64),
        ("vl_score_anchors", ctypes.c_uint32),
        ("vl_score_values", ctypes.c_uint16),
    ]:
        fn = getattr(lib, name)
        fn.restype = ctypes.POINTER(ptr_t)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.vl_num_id_paths.restype = ctypes.c_int32
    lib.vl_num_id_paths.argtypes = [ctypes.c_void_p]
    lib.vl_id_path_name.restype = ctypes.c_int64
    lib.vl_id_path_name.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_char_p),
    ]
    lib.vl_free.restype = None
    for name in ("vl_lz_compress", "vl_lz_decompress"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.c_char_p,
            ctypes.c_int64,
        ]
    lib.vl_lz_bound.restype = ctypes.c_int64
    lib.vl_lz_bound.argtypes = [ctypes.c_int64]
    lib.vl_free.argtypes = [ctypes.c_void_p]
    lib.vl_radix_sort_u64.restype = None
    lib.vl_radix_sort_u64.argtypes = [
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_int64,
    ]
    for name in ("vl_radix_sort_u64_kv32", "vl_lexsort_u64_u32"):
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = [
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.c_int64,
        ]
    _LIB = lib
    return _LIB


def native_available() -> bool:
    return _load() is not None


@dataclass
class NativePath:
    name: str
    terms: List[str]
    occurrences: np.ndarray  # uint32 [num_terms]
    large_text_count: int
    leaf_anchor: np.ndarray  # uint32 [L]
    leaf_parent: np.ndarray  # uint32 [L]
    leaf_text_id: np.ndarray  # int64 [L]
    leaf_ntokens: np.ndarray  # uint32 [L]
    leaf_tok_offsets: np.ndarray  # int64 [L+1]
    tokens: np.ndarray  # uint32 [T]
    token_is_sep: np.ndarray  # uint8 [T]
    grp_token: np.ndarray  # uint32 [G] — per-(leaf, token) groups
    grp_pos: np.ndarray  # uint32 [G] — first position within the leaf
    grp_leaf: np.ndarray  # uint32 [G]
    pair_a: np.ndarray  # uint32 [P] — phrase pairs
    pair_b: np.ndarray  # uint32 [P]
    pair_anchor: np.ndarray  # uint32 [P]
    # natively packed .to_anchor_id_score (offsets u64, anchors u32,
    # scores u16) when the caller requested it — None otherwise
    packed_scores: Optional[tuple] = None


@dataclass
class NativeIdPath:
    name: str
    value_id: np.ndarray
    parent_id: np.ndarray
    anchor_id: np.ndarray


def _copy_array(ptr, count, dtype):
    if count == 0:
        return np.empty(0, dtype=dtype)
    return np.ctypeslib.as_array(ptr, shape=(count,)).astype(dtype, copy=True)


def index_ndjson(data: str, get_path_config, score_paths=None) -> tuple:
    """Run the native pipeline. ``get_path_config(path) -> (tokenize,
    do_not_store_longer_than, separators_str)``.

    ``score_paths(name, n_entries) -> bool`` (optional): when it returns
    True for a path, the hot `.to_anchor_id_score` index is packed IN C++
    (entry generation + f32 scoring + sort + dedup/bonus + CSR) and
    attached as ``NativePath.packed_scores`` — the single most expensive
    numpy stage moved native.

    Returns (num_docs, [NativePath], [NativeIdPath]).
    """
    lib = _load()
    assert lib is not None, "native library unavailable"

    def cb(path, path_len, tokenize_out, max_len_out, sep_buf, sep_len):
        p = ctypes.string_at(path, path_len).decode("utf-8")
        tokenize, max_len, separators = get_path_config(p)
        tokenize_out[0] = 1 if tokenize else 0
        max_len_out[0] = int(max_len)
        enc = separators.encode("utf-8")
        cap = sep_len[0]
        enc = enc[:cap]
        ctypes.memmove(sep_buf, enc, len(enc))
        sep_len[0] = len(enc)
        return 0

    cb_ref = _CONFIG_CB(cb)
    raw = data.encode("utf-8")
    # chunked multi-threaded parse (the C call releases the GIL; the config
    # callback re-acquires it briefly per new path). VELOCI_INGEST_THREADS=1
    # forces the single-threaded walker; 0/unset auto-sizes to the cores.
    nthreads = int(os.environ.get("VELOCI_INGEST_THREADS", "0"))
    handle = lib.vl_index_ndjson_mt(raw, len(raw), cb_ref, nthreads)
    try:
        err = lib.vl_error(handle)
        if err:
            raise ValueError(err.decode("utf-8"))
        num_docs = lib.vl_num_docs(handle)
        paths: List[NativePath] = []
        for p in range(lib.vl_num_paths(handle)):
            out = ctypes.c_char_p()
            nlen = lib.vl_path_name(handle, p, ctypes.byref(out))
            name = ctypes.string_at(out, nlen).decode("utf-8")
            blen = lib.vl_terms_blob(handle, p, ctypes.byref(out))
            blob = ctypes.string_at(out, blen)
            nt = lib.vl_num_terms(handle, p)
            # terms stay a lazy blob-backed sequence: decoding 100k+ Python
            # strings is pure build-time overhead; the first dictionary
            # access (a query) forces it
            terms = _LazyTerms(blob, int(nt))
            nl = lib.vl_num_leaves(handle, p)
            ntk = lib.vl_num_tokens(handle, p)
            packed = None
            if score_paths is not None:
                n_entries = nl + lib.vl_num_groups(handle, p)
                if score_paths(name, int(n_entries)):
                    nnz = lib.vl_pack_scores(handle, p)
                    nk = lib.vl_score_num_keys(handle, p)
                    packed = (
                        _copy_array(lib.vl_score_offsets(handle, p), nk + 1, np.uint64),
                        _copy_array(lib.vl_score_anchors(handle, p), nnz, np.uint32),
                        _copy_array(lib.vl_score_values(handle, p), nnz, np.uint16),
                    )
            paths.append(
                NativePath(
                    name=name,
                    terms=terms,
                    occurrences=_copy_array(
                        lib.vl_term_occurrences(handle, p), nt, np.uint32
                    ),
                    large_text_count=lib.vl_large_text_count(handle, p),
                    leaf_anchor=_copy_array(lib.vl_leaf_anchor(handle, p), nl, np.uint32),
                    leaf_parent=_copy_array(lib.vl_leaf_parent(handle, p), nl, np.uint32),
                    leaf_text_id=_copy_array(lib.vl_leaf_text_id(handle, p), nl, np.int64),
                    leaf_ntokens=_copy_array(lib.vl_leaf_ntokens(handle, p), nl, np.uint32),
                    leaf_tok_offsets=_copy_array(
                        lib.vl_leaf_tok_offsets(handle, p), nl + 1, np.int64
                    ),
                    tokens=_copy_array(lib.vl_tokens(handle, p), ntk, np.uint32),
                    token_is_sep=_copy_array(lib.vl_token_is_sep(handle, p), ntk, np.uint8),
                    grp_token=_copy_array(
                        lib.vl_grp_token(handle, p), lib.vl_num_groups(handle, p), np.uint32
                    ),
                    grp_pos=_copy_array(
                        lib.vl_grp_pos(handle, p), lib.vl_num_groups(handle, p), np.uint32
                    ),
                    grp_leaf=_copy_array(
                        lib.vl_grp_leaf(handle, p), lib.vl_num_groups(handle, p), np.uint32
                    ),
                    pair_a=_copy_array(
                        lib.vl_pair_a(handle, p), lib.vl_num_phrase_pairs(handle, p), np.uint32
                    ),
                    pair_b=_copy_array(
                        lib.vl_pair_b(handle, p), lib.vl_num_phrase_pairs(handle, p), np.uint32
                    ),
                    pair_anchor=_copy_array(
                        lib.vl_pair_anchor(handle, p), lib.vl_num_phrase_pairs(handle, p), np.uint32
                    ),
                    packed_scores=packed,
                )
            )
        id_paths: List[NativeIdPath] = []
        for p in range(lib.vl_num_id_paths(handle)):
            out = ctypes.c_char_p()
            nlen = lib.vl_id_path_name(handle, p, ctypes.byref(out))
            name = ctypes.string_at(out, nlen).decode("utf-8")
            npairs = lib.vl_num_id_pairs(handle, p)
            id_paths.append(
                NativeIdPath(
                    name=name,
                    value_id=_copy_array(lib.vl_id_value(handle, p), npairs, np.uint32),
                    parent_id=_copy_array(lib.vl_id_parent(handle, p), npairs, np.uint32),
                    anchor_id=_copy_array(lib.vl_id_anchor(handle, p), npairs, np.uint32),
                )
            )
        return num_docs, paths, id_paths
    finally:
        lib.vl_free(handle)


# ------------------------------------------------------------------ LZ codec
def lz_available() -> bool:
    lib = _load()
    return lib is not None and hasattr(lib, "vl_lz_compress")


def lz_compress(data: bytes) -> Optional[bytes]:
    """Compress with the native LZ4-style block codec; None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    cap = int(lib.vl_lz_bound(len(data)))
    dst = ctypes.create_string_buffer(cap)
    n = lib.vl_lz_compress(data, len(data), dst, cap)
    if n <= 0:
        return None
    return dst.raw[:n]


def lz_decompress(data: bytes, raw_size: int) -> bytes:
    lib = _load()
    if lib is None:
        raise RuntimeError("native LZ codec unavailable for decompression")
    dst = ctypes.create_string_buffer(max(raw_size, 1))
    n = lib.vl_lz_decompress(data, len(data), dst, raw_size)
    if n != raw_size:
        raise ValueError(f"corrupt LZ block (got {n}, want {raw_size})")
    return dst.raw[:raw_size]


# ---------------------------------------------------------------- radix sort
def sort_u64(arr) -> bool:
    """In-place stable LSD radix sort of a contiguous uint64 array; False if
    the native lib is unavailable (callers fall back to np.sort)."""
    import numpy as np

    lib = _load()
    if lib is None or not hasattr(lib, "vl_radix_sort_u64"):
        return False
    if not (arr.dtype == np.uint64 and arr.flags.c_contiguous):
        return False
    lib.vl_radix_sort_u64(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), len(arr)
    )
    return True


def sort_kv_u64_u32(keys, vals) -> bool:
    """In-place stable sort of (keys u64, payload u32) by key."""
    import numpy as np

    lib = _load()
    if lib is None or not hasattr(lib, "vl_radix_sort_u64_kv32"):
        return False
    if not (
        keys.dtype == np.uint64
        and vals.dtype == np.uint32
        and keys.flags.c_contiguous
        and vals.flags.c_contiguous
        and len(keys) == len(vals)
    ):
        return False
    lib.vl_radix_sort_u64_kv32(
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        len(keys),
    )
    return True


def lexsort_kv_u64_u32(keys, vals) -> bool:
    """In-place lexicographic (key, val) sort — np.lexsort((vals, keys))
    applied to both arrays."""
    import numpy as np

    lib = _load()
    if lib is None or not hasattr(lib, "vl_lexsort_u64_u32"):
        return False
    if not (
        keys.dtype == np.uint64
        and vals.dtype == np.uint32
        and keys.flags.c_contiguous
        and vals.flags.c_contiguous
        and len(keys) == len(vals)
    ):
        return False
    lib.vl_lexsort_u64_u32(
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        len(keys),
    )
    return True


def pack_csr(keys, vals, num_keys: int, sort_and_dedup: bool):
    """Whole-CSR pack in C++: sort (+ optional exact-pair dedup) + offsets.

    ``keys`` (u64, contiguous, scratch — clobbered) and ``vals`` (u32,
    contiguous, clobbered) of equal length; returns ``(offsets u64
    [num_keys+1], values u32 [m])`` (``values`` is a trimmed view of
    ``vals``) or None if the native lib is unavailable. sort_and_dedup
    requires keys < 2^31 (combined-u64 sort) — caller checks.
    """
    import numpy as np

    lib = _load()
    if lib is None or not hasattr(lib, "vl_pack_csr"):
        return None
    if not (
        keys.dtype == np.uint64
        and vals.dtype == np.uint32
        and keys.flags.c_contiguous
        and vals.flags.c_contiguous
        and len(keys) == len(vals)
    ):
        return None
    if lib.vl_pack_csr.argtypes is None:
        p64 = ctypes.POINTER(ctypes.c_uint64)
        p32 = ctypes.POINTER(ctypes.c_uint32)
        lib.vl_pack_csr.restype = ctypes.c_int64
        lib.vl_pack_csr.argtypes = [p64, p32, ctypes.c_int64, ctypes.c_int64,
                                    ctypes.c_int32, p64]
    offsets = np.empty(num_keys + 1, dtype=np.uint64)
    m = lib.vl_pack_csr(
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        len(keys),
        num_keys,
        1 if sort_and_dedup else 0,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
    )
    if m < 0:
        raise ValueError("pack_csr: key out of range")
    return offsets, vals[:m]


def pack_phrase(keys, vals):
    """Whole phrase-index pack in C++: lexicographic sort, pair dedup,
    unique-key compaction + offsets. ``keys`` u64 / ``vals`` u32 clobbered
    in place; returns ``(uniq_keys, offsets, values)`` views or None."""
    import numpy as np

    lib = _load()
    if lib is None or not hasattr(lib, "vl_pack_phrase"):
        return None
    if not (
        keys.dtype == np.uint64
        and vals.dtype == np.uint32
        and keys.flags.c_contiguous
        and vals.flags.c_contiguous
        and len(keys) == len(vals)
    ):
        return None
    if lib.vl_pack_phrase.argtypes is None:
        p64 = ctypes.POINTER(ctypes.c_uint64)
        p32 = ctypes.POINTER(ctypes.c_uint32)
        lib.vl_pack_phrase.restype = ctypes.c_int64
        lib.vl_pack_phrase.argtypes = [p64, p32, ctypes.c_int64, p64,
                                       ctypes.POINTER(ctypes.c_int64)]
    offsets = np.empty(len(keys) + 1, dtype=np.uint64)
    nk = ctypes.c_int64(0)
    m = lib.vl_pack_phrase(
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        len(keys),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        ctypes.byref(nk),
    )
    nk = nk.value
    return keys[:nk].copy(), offsets[: nk + 1].copy(), vals[:m].copy()


# ------------------------------------------------------- CPU baseline engine
def baseline_available() -> bool:
    lib = _load()
    return lib is not None and hasattr(lib, "vbl_exact_topk")


def baseline_exact_topk(
    offsets: np.ndarray,  # uint64/int64 [num_keys + 1]
    anchors: np.ndarray,  # uint32 [nnz]
    scores: np.ndarray,  # uint16 [nnz]
    term_ids: np.ndarray,  # int32 [nq, t_per_q] (-1 pad)
    term_scores: np.ndarray,  # float32 [nq, t_per_q]
    term_slots: np.ndarray,  # int32 [nq, t_per_q]
    top_n: int,
):
    """Single-core reference-style query loop (native/baseline.cpp): the
    honest CPU baseline for `vs_baseline_native_cpu` — AnchorScoreIter scan,
    sort+dedup-max, top_n_sort exactly as reference
    search_field.rs:400-504 + sort.rs:5-34. Returns (ids [nq, top_n],
    scores [nq, top_n], num_hits [nq]) or None if the library is missing."""
    lib = _load()
    if lib is None or not hasattr(lib, "vbl_exact_topk"):
        return None
    offsets = np.ascontiguousarray(offsets.astype(np.int64, copy=False))
    anchors = np.ascontiguousarray(anchors, dtype=np.uint32)
    scores = np.ascontiguousarray(scores, dtype=np.uint16)
    term_ids = np.ascontiguousarray(term_ids, dtype=np.int32)
    term_scores = np.ascontiguousarray(term_scores, dtype=np.float32)
    term_slots = np.ascontiguousarray(term_slots, dtype=np.int32)
    nq, t_per_q = term_ids.shape
    out_ids = np.zeros((nq, top_n), dtype=np.uint32)
    out_scores = np.zeros((nq, top_n), dtype=np.float32)
    out_hits = np.zeros(nq, dtype=np.int32)
    lib.vbl_exact_topk(
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        anchors.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        scores.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        term_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        term_scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        term_slots.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int32(nq),
        ctypes.c_int32(t_per_q),
        ctypes.c_int32(len(offsets) - 1),
        ctypes.c_int32(top_n),
        out_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        out_scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out_hits.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return out_ids, out_scores, out_hits


class _LazyTerms:
    """Blob-backed term sequence: defers the utf-8 decode + NUL split of the
    native term blob until first access (queries force it; builds never do).

    NB: decode by term COUNT, not blob truthiness — a single empty term
    ("" is a valid text value) yields an empty blob."""

    __slots__ = ("_blob", "_n", "_list")

    def __init__(self, blob: bytes, n: int):
        self._blob, self._n, self._list = blob, n, None

    def __len__(self) -> int:
        return self._n

    def _force(self):
        if self._list is None:
            self._list = (
                self._blob.decode("utf-8").split("\x00") if self._n else []
            )
            assert len(self._list) == self._n, (len(self._list), self._n)
            self._blob = b""
        return self._list

    def __getitem__(self, i):
        return self._force()[i]

    def __iter__(self):
        return iter(self._force())


class VintBaselineIndex:
    """Reference-storage (delta+varint) encoding of an anchor-score CSR for
    the vint baseline (`vbl_exact_topk_vint`) — see native/baseline.cpp."""

    def __init__(self, blob, blob_offsets, num_keys):
        self.blob = blob
        self.blob_offsets = blob_offsets
        self.num_keys = num_keys


def baseline_encode_vint(offsets, anchors, scores) -> Optional[VintBaselineIndex]:
    lib = _load()
    if lib is None or not hasattr(lib, "vbl_encode_vint"):
        return None
    offsets = np.ascontiguousarray(offsets.astype(np.int64, copy=False))
    anchors = np.ascontiguousarray(anchors, dtype=np.uint32)
    scores = np.ascontiguousarray(scores, dtype=np.uint16)
    num_keys = len(offsets) - 1
    lib.vbl_encode_vint.restype = ctypes.c_int64
    size = lib.vbl_encode_vint(
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        anchors.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        scores.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        ctypes.c_int32(num_keys),
        None,
        None,
    )
    blob = np.zeros(max(int(size), 1), dtype=np.uint8)
    blob_offsets = np.zeros(num_keys + 1, dtype=np.int64)
    lib.vbl_encode_vint(
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        anchors.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        scores.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        ctypes.c_int32(num_keys),
        blob.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        blob_offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return VintBaselineIndex(blob, blob_offsets, num_keys)


def baseline_exact_topk_vint(index: VintBaselineIndex, term_ids, term_scores, top_n):
    """Single-core query loop over the reference's compressed storage shape
    (decode cost included) — the honest reference-engine stand-in."""
    lib = _load()
    if lib is None or not hasattr(lib, "vbl_exact_topk_vint"):
        return None
    term_ids = np.ascontiguousarray(term_ids, dtype=np.int32)
    term_scores = np.ascontiguousarray(term_scores, dtype=np.float32)
    nq, t_per_q = term_ids.shape
    out_ids = np.zeros((nq, top_n), dtype=np.uint32)
    out_scores = np.zeros((nq, top_n), dtype=np.float32)
    out_hits = np.zeros(nq, dtype=np.int32)
    lib.vbl_exact_topk_vint(
        index.blob.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        index.blob_offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        term_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        term_scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int32(nq),
        ctypes.c_int32(t_per_q),
        ctypes.c_int32(index.num_keys),
        ctypes.c_int32(top_n),
        out_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        out_scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out_hits.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return out_ids, out_scores, out_hits


class FuzzyBaselineIndex:
    """Lex-sorted lowercase char matrix for the native fuzzy baseline walk
    (`vbl_fuzzy_topk`, native/baseline.cpp): the single-core stand-in for
    the reference's Levenshtein-automaton x FST walk
    (search_field.rs:85-96)."""

    def __init__(self, chars, lens, row_tid):
        self.chars = chars  # [m, L] uint16, lex-sorted rows
        self.lens = lens  # [m] int32
        self.row_tid = row_tid  # [m] int32 -> dictionary term id


def baseline_fuzzy_index(dictionary) -> Optional[FuzzyBaselineIndex]:
    """Build the sorted matrix from a TermDictionary's compact char matrix."""
    if _load() is None:
        return None
    chars, lens, ids = dictionary.char_matrix_compact()
    # rows are zero-padded, so raw row comparison == lexicographic order with
    # shorter terms first (the contract vbl_fuzzy_topk's prefix skip needs)
    order = np.lexsort(tuple(chars[:, j] for j in range(chars.shape[1] - 1, -1, -1)))
    return FuzzyBaselineIndex(
        np.ascontiguousarray(chars[order], dtype=np.uint16),
        np.ascontiguousarray(lens[order], dtype=np.int32),
        np.ascontiguousarray(ids[order], dtype=np.int32),
    )


def baseline_fuzzy_topk(
    index: FuzzyBaselineIndex,
    queries: np.ndarray,  # [nq, 32] uint16 lowercased (encode_query rows)
    qlens: np.ndarray,  # [nq] int32
    dists: np.ndarray,  # [nq] int32
    offsets: np.ndarray,
    anchors: np.ndarray,
    scores: np.ndarray,
    top_n: int,
):
    """Single-core fuzzy query loop: automaton-equivalent dictionary walk +
    resolve + dedup-max + top_n_sort. Returns (ids [nq, top_n], scores,
    num_hits [nq], num_matches [nq]) or None without the native library."""
    lib = _load()
    if lib is None or not hasattr(lib, "vbl_fuzzy_topk"):
        return None
    chars = index.chars
    m, L = chars.shape
    queries = np.ascontiguousarray(queries, dtype=np.uint16)
    qlens = np.ascontiguousarray(qlens, dtype=np.int32)
    dists = np.ascontiguousarray(dists, dtype=np.int32)
    offsets = np.ascontiguousarray(offsets.astype(np.int64, copy=False))
    anchors = np.ascontiguousarray(anchors, dtype=np.uint32)
    scores = np.ascontiguousarray(scores, dtype=np.uint16)
    nq = queries.shape[0]
    out_ids = np.zeros((nq, top_n), dtype=np.uint32)
    out_scores = np.zeros((nq, top_n), dtype=np.float32)
    out_hits = np.zeros(nq, dtype=np.int32)
    out_matches = np.zeros(nq, dtype=np.int32)
    lib.vbl_fuzzy_topk(
        chars.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        index.lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        index.row_tid.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int32(m),
        ctypes.c_int32(L),
        queries.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        qlens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        dists.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        anchors.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        scores.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        ctypes.c_int32(len(offsets) - 1),
        ctypes.c_int32(nq),
        ctypes.c_int32(top_n),
        out_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        out_scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out_hits.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out_matches.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return out_ids, out_scores, out_hits, out_matches


def doc_store_body(data: bytes, flush_threshold: int):
    """One-pass native doc-store body builder (native/baseline.cpp
    vbl_doc_store_body). Returns (body bytes, index_rows uint64 [B,3],
    num_docs, bytes_indexed) or None if the library is unavailable."""
    lib = _load()
    if lib is None or not hasattr(lib, "vbl_doc_store_body"):
        return None
    n = len(data)
    nlines = data.count(b"\n") + 1
    out_cap = n + n // 64 + 16 * nlines + (1 << 16)
    max_blocks = nlines + 2
    out = np.zeros(out_cap, dtype=np.uint8)
    idx = np.zeros(max_blocks * 3, dtype=np.uint64)
    n_blocks = ctypes.c_int64(0)
    num_docs = ctypes.c_int64(0)
    bytes_indexed = ctypes.c_int64(0)
    lib.vbl_doc_store_body.restype = ctypes.c_int64
    size = lib.vbl_doc_store_body(
        data,
        ctypes.c_int64(n),
        ctypes.c_int32(flush_threshold),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(out_cap),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        ctypes.c_int64(max_blocks),
        ctypes.byref(n_blocks),
        ctypes.byref(num_docs),
        ctypes.byref(bytes_indexed),
    )
    if size < 0:
        return None
    rows = idx[: n_blocks.value * 3].reshape(-1, 3)
    return (
        out[:size].tobytes(),
        rows,
        int(num_docs.value),
        int(bytes_indexed.value),
    )
