"""Device regex term matching: host regex->DFA compilation + a batched
DFA sweep over the dictionary char matrix.

The reference intersects a dense regex DFA with the FST
(src/search/search_field.rs:72-83). Here the host compiles the pattern (a
practical regex subset) to a DFA over CHARACTER EQUIVALENCE CLASSES, and the
device advances all terms' states in lockstep — one `lax.scan` over the 32
char positions where each step is C small one-hot matmuls
(``state_oh @ T[c]`` selected by the per-term class) instead of a
per-element table walk (one gather per term per char).

Unsupported syntax (backrefs, lookaround, {m,n}, huge DFAs) returns None
from :func:`compile_dfa` and the caller falls back to the host `re` scan —
semantics stay identical either way (full match; prefix match for
starts_with).
"""

from __future__ import annotations

from functools import partial
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

import jax
import numpy as np

__all__ = ["compile_dfa", "CompiledDfa", "regex_match_device"]

MAX_STATES = 64
MAX_CLASSES = 30
_MAX_CP = 0xFFFF  # the char matrix stores uint16 code units


class CompiledDfa:
    def __init__(self, boundaries, trans, accept, dead):
        self.boundaries = boundaries  # u32 [C-1] class = searchsorted-style
        self.trans = trans  # i32 [C, S]
        self.accept = accept  # bool [S]
        self.dead = dead  # int: the absorbing reject state


# ----------------------------------------------------------------- parser
# regex subset -> NFA (Thompson). Node = (op, args)


class _ParseError(Exception):
    pass


_CLASS_SHORTHANDS = {
    "d": [(ord("0"), ord("9"))],
    "w": [(ord("a"), ord("z")), (ord("A"), ord("Z")), (ord("0"), ord("9")),
          (ord("_"), ord("_"))],
    "s": [(9, 13), (32, 32)],
}


def _parse(pattern: str):
    pos = 0

    def peek():
        return pattern[pos] if pos < len(pattern) else None

    def take():
        nonlocal pos
        c = pattern[pos]
        pos += 1
        return c

    def parse_alt():
        branches = [parse_concat()]
        while peek() == "|":
            take()
            branches.append(parse_concat())
        return ("alt", branches) if len(branches) > 1 else branches[0]

    def parse_concat():
        items = []
        while peek() not in (None, "|", ")"):
            items.append(parse_repeat())
        if not items:
            return ("empty",)
        return ("cat", items) if len(items) > 1 else items[0]

    def parse_repeat():
        atom = parse_atom()
        while peek() in ("*", "+", "?"):
            op = take()
            if op == "*":
                atom = ("star", atom)
            elif op == "+":
                atom = ("cat", [atom, ("star", atom)])
            else:
                atom = ("alt", [atom, ("empty",)])
        if peek() == "{":
            raise _ParseError("{m,n} not supported")
        return atom

    def parse_atom():
        c = peek()
        if c is None:
            raise _ParseError("unexpected end")
        if c == "(":
            take()
            if peek() == "?":  # (?:...) group or any (?...) extension
                take()
                if peek() == ":":
                    take()
                else:
                    raise _ParseError("(?...) extensions not supported")
            inner = parse_alt()
            if peek() != ")":
                raise _ParseError("unbalanced paren")
            take()
            return inner
        if c == ")":
            raise _ParseError("unbalanced paren")
        if c == "[":
            return parse_class()
        if c == ".":
            take()
            return ("ranges", [(0, _MAX_CP)])
        if c == "\\":
            take()
            e = take()
            if e in _CLASS_SHORTHANDS:
                return ("ranges", list(_CLASS_SHORTHANDS[e]))
            if e in ("D", "W", "S"):
                return ("ranges", _complement(_CLASS_SHORTHANDS[e.lower()]))
            if e == "b":
                raise _ParseError("\\b not supported")
            return ("ranges", [(ord(e), ord(e))])
        if c in ("^", "$"):
            raise _ParseError("anchors not supported (matching is anchored)")
        take()
        return ("ranges", [(ord(c), ord(c))])

    def parse_class():
        take()  # [
        neg = False
        if peek() == "^":
            take()
            neg = True
        ranges: List[Tuple[int, int]] = []
        first = True
        while True:
            c = peek()
            if c is None:
                raise _ParseError("unterminated class")
            if c == "]" and not first:
                take()
                break
            first = False
            if c == "\\":
                take()
                e = take()
                if e in _CLASS_SHORTHANDS:
                    ranges.extend(_CLASS_SHORTHANDS[e])
                    continue
                lo = ord(e)
            else:
                lo = ord(take())
            if peek() == "-" and pos + 1 < len(pattern) and pattern[pos + 1] != "]":
                take()
                hi_c = take()
                hi = ord(take()) if hi_c == "\\" else ord(hi_c)
                ranges.append((lo, hi))
            else:
                ranges.append((lo, lo))
        if neg:
            ranges = _complement(ranges)
        return ("ranges", ranges)

    ast = parse_alt()
    if pos != len(pattern):
        raise _ParseError("trailing input")
    return ast


def _complement(ranges):
    pts = sorted((lo, hi) for lo, hi in ranges)
    out = []
    cur = 0
    for lo, hi in pts:
        if lo > cur:
            out.append((cur, lo - 1))
        cur = max(cur, hi + 1)
    if cur <= _MAX_CP:
        out.append((cur, _MAX_CP))
    return out


def _casefold_ranges(ranges):
    out = list(ranges)
    for lo, hi in ranges:
        # ASCII case folding; non-ASCII folding handled per-char below cap
        a, b = max(lo, ord("a")), min(hi, ord("z"))
        if a <= b:
            out.append((a - 32, b - 32))
        a, b = max(lo, ord("A")), min(hi, ord("Z"))
        if a <= b:
            out.append((a + 32, b + 32))
    return out


# ---------------------------------------------------- NFA + subset construction


def _build_nfa(ast, ignore_case: bool):
    """Thompson construction: states with eps edges + ranged edges."""
    eps: List[List[int]] = []
    edges: List[List[Tuple[Tuple[int, int], int]]] = []

    def new_state():
        eps.append([])
        edges.append([])
        return len(eps) - 1

    def build(node, s_in):
        op = node[0]
        if op == "empty":
            return s_in
        if op == "ranges":
            ranges = node[1]
            if ignore_case:
                ranges = _casefold_ranges(ranges)
            s_out = new_state()
            for r in ranges:
                edges[s_in].append((r, s_out))
            return s_out
        if op == "cat":
            cur = s_in
            for child in node[1]:
                cur = build(child, cur)
            return cur
        if op == "alt":
            s_out = new_state()
            for child in node[1]:
                b_in = new_state()
                eps[s_in].append(b_in)
                b_out = build(child, b_in)
                eps[b_out].append(s_out)
            return s_out
        if op == "star":
            s_loop = new_state()
            s_out = new_state()
            eps[s_in].append(s_loop)
            eps[s_in].append(s_out)
            body_out = build(node[1], s_loop)
            eps[body_out].append(s_loop)
            eps[body_out].append(s_out)
            return s_out
        raise _ParseError(f"unknown node {op}")

    start = new_state()
    final = build(ast, start)
    return eps, edges, start, final


def compile_dfa(pattern: str, ignore_case: bool = False) -> Optional[CompiledDfa]:
    """Compile to a class-alphabet DFA; None when unsupported/too large."""
    try:
        ast = _parse(pattern)
        eps, edges, start, final = _build_nfa(ast, ignore_case)
    except _ParseError:
        return None

    # character equivalence classes from every edge's range endpoints
    bounds: Set[int] = set()
    for es in edges:
        for (lo, hi), _t in es:
            bounds.add(lo)
            bounds.add(hi + 1)
    boundaries = sorted(b for b in bounds if 0 < b <= _MAX_CP + 1)
    if len(boundaries) + 1 > MAX_CLASSES:
        return None
    nclasses = len(boundaries) + 1

    def class_of(cp: int) -> int:
        return int(np.searchsorted(boundaries, cp, side="right"))

    # representative char per class (for edge evaluation)
    reps = [0] + boundaries

    def eclose(states: FrozenSet[int]) -> FrozenSet[int]:
        stack = list(states)
        seen = set(states)
        while stack:
            s = stack.pop()
            for t in eps[s]:
                if t not in seen:
                    seen.add(t)
                    stack.append(t)
        return frozenset(seen)

    start_set = eclose(frozenset([start]))
    dfa_index: Dict[FrozenSet[int], int] = {start_set: 0}
    dfa_states = [start_set]
    trans_rows: List[List[int]] = []
    i = 0
    while i < len(dfa_states):
        cur = dfa_states[i]
        row = []
        for c in range(nclasses):
            rep = reps[c]
            nxt = set()
            for s in cur:
                for (lo, hi), t in edges[s]:
                    if lo <= rep <= hi:
                        nxt.add(t)
            nset = eclose(frozenset(nxt)) if nxt else frozenset()
            j = dfa_index.get(nset)
            if j is None:
                j = len(dfa_states)
                if j >= MAX_STATES:
                    return None
                dfa_index[nset] = j
                dfa_states.append(nset)
            row.append(j)
        trans_rows.append(row)
        i += 1

    n_states = len(dfa_states)
    trans = np.zeros((nclasses, n_states), dtype=np.int32)
    for s, row in enumerate(trans_rows):
        for c, t in enumerate(row):
            trans[c, s] = t
    accept = np.array([final in st for st in dfa_states], dtype=bool)
    dead = dfa_index.get(frozenset(), -1)
    return CompiledDfa(
        np.asarray(boundaries, dtype=np.uint32), trans, accept, dead
    )


# --------------------------------------------------------------- device sweep


@partial(jax.jit, static_argnames=("num_classes", "num_states", "prefix"))
def _sweep_kernel(
    chars, lengths, boundaries, trans_oh, accept, num_classes, num_states, prefix
):
    import jax
    import jax.numpy as jnp

    n, l = chars.shape
    ch = chars.astype(jnp.int32)
    # class id per (term, pos): #boundaries <= c — a handful of broadcast
    # compares, no gathers
    cls = jnp.zeros((n, l), dtype=jnp.int32)
    for b in range(num_classes - 1):
        cls = cls + (ch >= boundaries[b]).astype(jnp.int32)

    oh0 = jnp.zeros((n, num_states), dtype=jnp.float32).at[:, 0].set(1.0)
    lens = lengths.astype(jnp.int32)

    def step(carry, j):
        oh, acc_prefix = carry
        c_j = cls[:, j]
        nxt = jnp.zeros_like(oh)
        for c in range(num_classes):  # C one-hot matmuls
            sel = (c_j == c).astype(jnp.float32)[:, None]
            # 0/1 operands with one nonzero product per output are exact
            # even in TF32; HIGHEST keeps the GPU's f32 product in full
            # f32 so the result does not rest on that argument
            nxt = nxt + sel * jnp.dot(
                oh, trans_oh[c], precision=jax.lax.Precision.HIGHEST
            )
        active = (j < lens)[:, None]
        oh = jnp.where(active, nxt, oh)
        if prefix:
            acc_prefix = acc_prefix | (
                ((oh * accept[None, :]).sum(axis=1) > 0) & (j < lens)
            )
        return (oh, acc_prefix), None

    (oh, acc_prefix), _ = jax.lax.scan(
        step, (oh0, jnp.zeros((n,), dtype=bool)), jnp.arange(l, dtype=jnp.int32)
    )
    full = (oh * accept[None, :]).sum(axis=1) > 0
    matched = (acc_prefix | full) if prefix else full
    # zero-length patterns match empty prefixes; padding rows (len 0) never
    matched = matched & (lens > 0)
    if prefix:
        start_accepts = accept[0] > 0  # empty-prefix match
        matched = matched | (start_accepts & (lens > 0))
    return matched


def regex_match_device(chars, lengths, dfa: CompiledDfa, prefix: bool = False):
    """Matched-term bool vector [N] for a compiled DFA over the device char
    matrix. ``prefix=True`` = `re.match` semantics (starts_with); otherwise
    `re.fullmatch`."""
    import jax.numpy as jnp

    num_classes = len(dfa.boundaries) + 1
    num_states = dfa.trans.shape[1]
    # one-hot transition matrices [C, S, S]
    t_oh = np.zeros((num_classes, num_states, num_states), dtype=np.float32)
    for c in range(num_classes):
        for s in range(num_states):
            t_oh[c, s, dfa.trans[c, s]] = 1.0
    return _sweep_kernel(
        chars,
        lengths,
        jnp.asarray(dfa.boundaries.astype(np.int32)),
        jnp.asarray(t_oh),
        jnp.asarray(dfa.accept.astype(np.float32)),
        num_classes=num_classes,
        num_states=num_states,
        prefix=prefix,
    )
