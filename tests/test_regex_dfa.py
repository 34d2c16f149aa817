"""Device regex matching: the class-alphabet DFA sweep must agree with
Python `re` (the host oracle) for fullmatch and prefix (starts_with)
semantics, and the device path must be reachable from real requests."""

import re

import numpy as np
import pytest

from veloci_tpu.ops.regex_dfa import compile_dfa, regex_match_device

TERMS = [
    "",
    "a",
    "ab",
    "abc",
    "abd",
    "b",
    "ba",
    "aab",
    "aaab",
    "xyz",
    "x1z",
    "x22z",
    "hello_world",
    "hello",
    "help",
    "HELLO",
    "foo.bar",
    "foobar",
    "foo1bar",
    "123",
    "12a",
    "a" * 31,
    "snake_case_name",
    "camelCaseName",
    "tree",
    "trees",
    "treehouse",
]

PATTERNS = [
    "abc",
    "ab.",
    "a*b",
    "a+b",
    "ab?c?",
    "(ab|ba)",
    "a(b|c)d?",
    "[abx][byz]",
    "[a-c]+",
    "[^a-c]+",
    "x[0-9]+z",
    r"\d+",
    r"\w+",
    r"[a-z]+_[a-z]+",
    "hel(lo|p)",
    "tree.*",
    "foo.bar",
    r"foo\.bar",
    "(a|b)*",
]


def _matrix(terms):
    mat = np.zeros((len(terms), 32), dtype=np.uint16)
    lens = np.zeros(len(terms), dtype=np.int32)
    for i, t in enumerate(terms):
        lo = t.lower()
        if len(lo) > 32:
            continue
        lens[i] = len(lo)
        for j, ch in enumerate(lo):
            mat[i, j] = min(ord(ch), 0xFFFF)
    return mat, lens


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("prefix", [False, True])
def test_dfa_matches_re(pattern, prefix):
    dfa = compile_dfa(pattern, ignore_case=True)
    assert dfa is not None, pattern
    mat, lens = _matrix(TERMS)
    got = np.asarray(regex_match_device(mat, lens, dfa, prefix=prefix))
    rx = re.compile(pattern, re.IGNORECASE)
    fn = rx.match if prefix else rx.fullmatch
    # case folding closes NEGATED classes over case-swap, which widens them:
    # the DFA is then a SUPERSET prefilter (the integration always verifies
    # candidates with `re`); for negation-free patterns it is exact.
    exact = "[^" not in pattern
    for i, t in enumerate(TERMS):
        want = bool(fn(t.lower()))
        if len(t) == 0:
            continue  # zero-length rows are indistinguishable from padding
        if exact:
            assert bool(got[i]) == want, (pattern, t, prefix)
        elif want:
            assert bool(got[i]), ("prefilter dropped a match", pattern, t)


def test_unsupported_syntax_returns_none():
    for pattern in ["a{2,3}", r"\bword", "(?=x)", "(?P<g>a)", "a$"]:
        assert compile_dfa(pattern) is None, pattern


def test_regex_through_search_device_path(monkeypatch):
    """test_code_search semantics through the device DFA prefilter."""
    from veloci_tpu import Persistence, Request, search

    monkeypatch.setenv("VELOCI_REGEX_DEVICE", "1")
    lines = [
        '{"code": "fn get_%d(x) { return x + %d }"}' % (i, i) for i in range(50)
    ] + ['{"code": "struct FooBar { field: u32 }"}']
    config = '{"code": {"fulltext": {"tokenize_on_chars": [" ", "(", ")", "{", "}", ":", "+"]}}}'
    pers = Persistence.create_from_str("\n".join(lines), config)

    req = Request.from_dict(
        {
            "search_req": {
                "search": {
                    "terms": ["get_[0-9]+"],
                    "path": "code",
                    "is_regex": True,
                }
            },
            "top": 100,
        }
    )
    dev_res = search(req, pers)
    monkeypatch.setenv("VELOCI_REGEX_DEVICE", "0")
    pers.invalidate_device_cache()
    host_res = search(req, pers)
    assert dev_res.num_hits == host_res.num_hits == 50
    assert [h.id for h in dev_res.data] == [h.id for h in host_res.data]


def test_regex_case_sensitive_verification(monkeypatch):
    """Case-sensitive regex: the folded device prefilter + host verify must
    equal the pure-host result."""
    from veloci_tpu import Persistence, Request, search

    lines = ['{"t": "FooBar"}', '{"t": "foobar"}', '{"t": "FOOBAR"}']
    pers = Persistence.create_from_str("\n".join(lines), "{}")
    req = Request.from_dict(
        {
            "search_req": {
                "search": {
                    "terms": ["Foo[A-Z][a-z]+"],
                    "path": "t",
                    "is_regex": True,
                    "ignore_case": False,
                }
            }
        }
    )
    monkeypatch.setenv("VELOCI_REGEX_DEVICE", "1")
    dev_res = search(req, pers)
    monkeypatch.setenv("VELOCI_REGEX_DEVICE", "0")
    pers._field_search_cache = {}
    host_res = search(req, pers)
    assert dev_res.num_hits == host_res.num_hits == 1
    assert [h.id for h in dev_res.data] == [h.id for h in host_res.data]


def test_device_regex_maps_compact_rows_to_term_ids(monkeypatch):
    """Long (>32 char) terms are absent from the compact sweep matrix, so
    sweep rows shift against term ids; device matches must map back
    through the sweep ids (a term after a long one was missed)."""
    import re

    from veloci_tpu import Persistence
    from veloci_tpu.search.field_search import _match_regex

    monkeypatch.setenv("VELOCI_REGEX_DEVICE", "1")
    words = ["a" * 40, "abc", "b" * 35, "abd", "zzz", "abx", "c" * 33, "aby"]
    p = Persistence.create_from_str(
        "\n".join('{"t": "%s"}' % w for w in words),
        '{"t": {"fulltext": {"tokenize": false}}}',
    )
    d = p.get_dictionary("t")
    for pattern in ("ab.", "a.*", ".*"):
        want = [i for i, t in enumerate(d.terms) if re.fullmatch(pattern, t)]
        got = _match_regex(p, "t", d, pattern, True, False)
        assert got.tolist() == want, (pattern, got.tolist(), want)
