"""Frozen-golden parity: request -> top-10 results pinned in goldens.json.

Ranking/scoring semantics must not drift silently.
The Rust reference itself cannot run in this image (no cargo/rustc;
jmdict.json is an LFS stub — see BASELINE.md), so the goldens pin the
engine's verified behavior from the ported reference suite. Regenerate
deliberately with tools/make_goldens.py after an INTENDED semantic change.
"""

import json
import os

import pytest

from corpus import TEST_CONFIG, TOKEN_VALUES, data_ndjson
from veloci_tpu import Persistence, Request, add_token_values_to_tokens, search
from veloci_tpu.query.generator import SearchQueryGeneratorParameters, search_query

GOLDENS = json.load(
    open(os.path.join(os.path.dirname(__file__), "goldens.json"))
)


@pytest.fixture(scope="module")
def pers():
    p = Persistence.create_from_str(data_ndjson(), TEST_CONFIG)
    add_token_values_to_tokens(p, TOKEN_VALUES[0], TOKEN_VALUES[1])
    return p


@pytest.fixture(scope="module")
def synth():
    from bench import build_corpus

    corpus, _vocab = build_corpus(5000)
    return Persistence.create_from_str(corpus, "{}")


def _check(res, entry):
    assert res.num_hits == entry["num_hits"]
    got = [[h.id, round(float(h.score), 4)] for h in res.data[:10]]
    assert got == [list(x) for x in entry["top"]]
    if entry.get("facets"):
        got_f = {k: [list(t) for t in v] for k, v in (res.facets or {}).items()}
        want_f = {k: [list(t) for t in v] for k, v in entry["facets"].items()}
        assert got_f == want_f


@pytest.mark.parametrize("i", range(len(GOLDENS["entries"])))
def test_golden(i, pers, synth):
    entry = GOLDENS["entries"][i]
    if entry["kind"] == "request":
        res = search(Request.from_dict(dict(entry["request"])), pers)
        _check(res, entry)
    elif entry["kind"] == "query":
        req = search_query(
            pers, SearchQueryGeneratorParameters(search_term=entry["query"])
        )
        _check(res=search(req, pers), entry=entry)
    else:
        res = search(
            Request.from_dict(
                {"search_req": {"search": {"terms": [entry["term"]], "path": "title"}}}
            ),
            synth,
        )
        _check(res, entry)
