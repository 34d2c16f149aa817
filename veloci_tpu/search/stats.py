"""Serving observability: fleet-level dispatch counters.

The reference records per-query `execution_time_ns` (src/search.rs:226);
an operator of the device serving path additionally needs to know WHICH
execution path answered each request — the fused kernels answer in tens of
microseconds, the per-request executor in tens of milliseconds, and round 2
demoted requests silently (`_MAX_SLOTS` & friends). Every dispatch point
counts itself here; fallbacks record a reason. Exposed over HTTP as
``GET /stats`` (server.py) and resettable for tests/benchmarks.
"""

from __future__ import annotations

import threading
import time
from collections import Counter
from typing import Dict

__all__ = [
    "count_path",
    "count_fallback",
    "record_latency",
    "snapshot",
    "reset",
    "fallback_reason",
]

_LOCK = threading.Lock()
_PATHS: Counter = Counter()
_FALLBACKS: Counter = Counter()
_LATENCY_NS: Counter = Counter()  # total ns per path
_START = time.time()


def count_path(path: str, n: int = 1) -> None:
    with _LOCK:
        _PATHS[path] += n


def count_fallback(reason: str, n: int = 1) -> None:
    with _LOCK:
        _PATHS["per_request_fallback"] += n
        _FALLBACKS[reason] += n


def record_latency(path: str, ns: int) -> None:
    with _LOCK:
        _LATENCY_NS[path] += ns


def snapshot() -> Dict:
    with _LOCK:
        total = sum(_PATHS.values())
        fast = total - _PATHS.get("per_request_fallback", 0)
        return {
            "uptime_s": round(time.time() - _START, 1),
            "total_requests": total,
            "fast_path_requests": fast,
            "fast_path_pct": round(100.0 * fast / total, 2) if total else None,
            "paths": dict(_PATHS),
            "fallback_reasons": dict(_FALLBACKS),
            "latency_ms_total": {
                k: round(v / 1e6, 3) for k, v in _LATENCY_NS.items()
            },
        }


def reset() -> None:
    with _LOCK:
        _PATHS.clear()
        _FALLBACKS.clear()
        _LATENCY_NS.clear()


def fallback_reason(request, persistence) -> str:
    """Classify WHY a request missed every batched/fused path — the coarse
    demotion taxonomy an operator needs when QPS collapses. Mirrors the
    eligibility gates in search/batch.py and search/executor.py."""
    from .batch import _MAX_GROUPS, _MAX_SLOTS, _node_groups
    from .executor import SMALL_DOCS

    if persistence.num_docs < SMALL_DOCS:
        return "small_index_host_path"
    for flag in ("explain", "why_found", "suggest", "text_locality", "boost_term"):
        if getattr(request, flag, None):
            return flag
    from .batch import _node_deep

    groups = _node_groups(request.search_req)
    if groups is None:
        if _node_deep(request.search_req) is not None:
            return "deep_tree_leaf_or_width"  # deep shape, a bound tripped
        return "tree_shape"  # 4+ alternation nesting / unsupported nodes
    if len(groups) > _MAX_GROUPS:
        return "and_width"
    for parts in groups:
        terms = {p.terms[0] for p in parts}
        if len(terms) > _MAX_SLOTS:
            return "or_width"
        for p in parts:
            if p.is_regex:
                return "regex_leaf"
            if p.snippet:
                return "snippet_leaf"
            if p.options:
                return "leaf_options"
            if len(p.terms) != 1:
                return "multi_term_leaf"
    for b in request.boost or []:
        if "[]" in b.path:
            return "boost_1n_chain"
    if request.filter is not None:
        for p in request.filter.walk_parts():
            if p.is_regex:
                return "regex_filter"
    return "leaf_expansion_or_index"  # leaf term overflow / missing index
