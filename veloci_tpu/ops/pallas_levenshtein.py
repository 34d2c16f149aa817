"""Banded Levenshtein dictionary sweep as a Pallas kernel for NVIDIA GPUs
(Triton route), and the one place that decides which sweep a request runs.

The XLA sweep (ops/levenshtein.py) moves a ``[Q, N, 33]`` int32 DP state
through device memory at every one of its query-character steps. Matching
only needs distances up to d <= 4, and any edit path that leaves the
``|i - j| <= band`` diagonal costs more than ``band`` (Ukkonen), so the DP
here keeps just the ``2 * band + 1`` band cells per (query, term) in
registers across the loop over query characters.

Layout: the char matrix is transposed to ``chars_t [32, N] uint16`` so each
character row loads contiguously along the term axis. One program owns a
block of ``block_n`` terms and ``block_q`` queries; it loops over its
queries, and for each one runs a ``fori_loop`` to that query's own length.
The band's char rows roll: each step loads one new row of the block and
drops the oldest. The prefix flag falls out of the same loop: the band's
diagonal cell compares chars[i - 1] with query char i - 1. Programs share
nothing.

Output contract: ``dist[q, t]`` is the exact distance where it is <= band,
``_BIG`` otherwise (and for empty/pad terms); ``is_prefix[q, t]`` says the
term starts with the query.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from .levenshtein import MAX_QUERY_CHARS

__all__ = ["D_BAND", "banded_sweep", "sweep_route", "use_banded_kernel"]

_BIG = np.int32(1 << 20)
L = 32  # term width == indices.MAX_TERM_CHARS
D_BAND = 4  # widest band compiled; distances above it take the XLA sweep
BLOCK_N = 256
# enough programs for four waves over an H100's 132 SMs before programs
# start sharing a term block across several queries
_MIN_PROGRAMS = 4 * 132
_MAX_BLOCK_Q = 16


def sweep_route() -> str:
    """``"kernel"`` on a GPU, ``"xla"`` on the CPU (tests). Any other
    platform is an error: no silent fallback to a sweep nobody measured."""
    platform = jax.default_backend()
    if platform == "gpu":
        return "kernel"
    if platform == "cpu":
        return "xla"
    raise RuntimeError(f"no Levenshtein sweep route for platform {platform!r}")


def use_banded_kernel(max_distance: int, starts_with: bool = False) -> bool:
    """Whether a sweep at ``max_distance`` runs the banded kernel. The XLA
    sweep keeps ``starts_with`` (it needs full-term distances beyond the
    band) and distances above ``D_BAND``."""
    return (
        sweep_route() == "kernel" and not starts_with and max_distance <= D_BAND
    )


def _sweep_kernel(band, q_ref, ql_ref, chars_ref, len_ref, dist_ref, pre_ref):
    """q_ref [bq, 32] i32, ql_ref [bq] i32, chars_ref [32, bn] u16,
    len_ref [bn] i32 -> dist_ref [bq, bn] i32, pre_ref [bq, bn] i8."""
    w = 2 * band + 1
    bq, bn = dist_ref.shape
    lens = len_ref[...]
    big = jnp.full((bn,), _BIG, jnp.int32)

    def char_row(r):
        return chars_ref[jnp.clip(r, 0, L - 1), :].astype(jnp.int32)

    def one_query(qi, carry):
        qlen = jnp.minimum(ql_ref[qi], MAX_QUERY_CHARS)
        # b[k] = D[i][i + k - band]; row i = 0 is D[0][j] = j
        b0 = tuple(
            jnp.full((bn,), k - band, jnp.int32) if k >= band else big
            for k in range(w)
        )
        # cell k of step i reads chars[i + k - band - 1]; carry the w - 1
        # rows step i shares with step i - 1
        rows0 = tuple(char_row(k - band) for k in range(w - 1))
        pre0 = jnp.ones((bn,), jnp.int32)

        def step(i, state):
            b, rows, pre = state
            rows = rows + (char_row(i + band - 1),)
            qc = q_ref[qi, i - 1]
            # the diagonal cell's row is chars[i - 1]: the prefix test
            pre = pre & (rows[band] == qc).astype(jnp.int32)
            prev = big
            new = []
            for k in range(w):
                j = i + k - band
                cost = (rows[k] != qc).astype(jnp.int32)
                up = b[k + 1] + 1 if k + 1 < w else big
                val = jnp.minimum(jnp.minimum(up, b[k] + cost), prev + 1)
                val = jnp.where(j == 0, i, val)
                val = jnp.where((j < 0) | (j > L), _BIG, val)
                val = jnp.minimum(val, _BIG)
                prev = val
                new.append(val)
            return tuple(new), rows[1:], pre

        b, _, pre = jax.lax.fori_loop(1, qlen + 1, step, (b0, rows0, pre0))
        off = lens - qlen + band  # band cell of the term end
        dist = big
        for k in range(w):
            dist = jnp.where(off == k, b[k], dist)
        valid = lens > 0
        dist_ref[qi, :] = jnp.where(valid & (dist <= band), dist, _BIG)
        pre_ref[qi, :] = (
            pre * (valid & (lens >= qlen)).astype(jnp.int32)
        ).astype(jnp.int8)
        return carry

    jax.lax.fori_loop(0, bq, one_query, 0)


def _block_q(q: int, n_blocks: int) -> int:
    """Queries per program: 1 while that leaves too few programs for the
    card, else the most (up to 16) that keeps ``_MIN_PROGRAMS`` — a program
    re-reads its term block from L1/L2 for each of its queries."""
    bq = 1
    while (
        bq < _MAX_BLOCK_Q
        and bq * 2 <= q
        and n_blocks * pl.cdiv(q, bq * 2) >= _MIN_PROGRAMS
    ):
        bq *= 2
    return bq


@functools.partial(
    jax.jit, static_argnames=("band", "block_n", "num_warps", "interpret")
)
def banded_sweep(
    chars_t: jax.Array,  # [L, N] uint16
    term_lens: jax.Array,  # [N] int32 (0 = pad)
    queries: jax.Array,  # [Q, MAX_QUERY_CHARS] uint16
    query_lens: jax.Array,  # [Q] int32
    band: int = D_BAND,
    block_n: int = BLOCK_N,
    num_warps: int = 4,
    interpret: bool = False,
):
    """Banded sweep of ``Q`` queries over ``N`` terms in one kernel.

    Returns ``(dist [Q, N] int32, is_prefix [Q, N] bool)``; ``band`` must
    be >= every distance the caller matches against (a d <= 2 batch passes
    band=2 for ~45% less DP than band=4)."""
    l, n = chars_t.shape
    assert l == L, chars_t.shape
    q = queries.shape[0]
    n_pad = pl.cdiv(n, block_n) * block_n
    bq = _block_q(q, n_pad // block_n)
    q_pad = pl.cdiv(q, bq) * bq
    chars_p = jnp.pad(chars_t, ((0, 0), (0, n_pad - n)))
    lens_p = jnp.pad(term_lens.astype(jnp.int32), (0, n_pad - n))
    q_p = jnp.pad(queries.astype(jnp.int32), ((0, q_pad - q), (0, 0)))
    ql_p = jnp.pad(query_lens.astype(jnp.int32), (0, q_pad - q))
    dist, is_prefix = pl.pallas_call(
        functools.partial(_sweep_kernel, band),
        grid=(q_pad // bq, n_pad // block_n),  # query groups vary fastest
        in_specs=[
            pl.BlockSpec((bq, MAX_QUERY_CHARS), lambda g, t: (g, 0)),
            pl.BlockSpec((bq,), lambda g, t: (g,)),
            pl.BlockSpec((L, block_n), lambda g, t: (0, t)),
            pl.BlockSpec((block_n,), lambda g, t: (t,)),
        ],
        out_specs=[
            pl.BlockSpec((bq, block_n), lambda g, t: (g, t)),
            pl.BlockSpec((bq, block_n), lambda g, t: (g, t)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((q_pad, n_pad), jnp.int32),
            jax.ShapeDtypeStruct((q_pad, n_pad), jnp.int8),
        ],
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=num_warps, num_stages=1),
        interpret=interpret,
        name=f"levenshtein_band{band}",
    )(q_p, ql_p, chars_p, lens_p)
    return dist[:q, :n], is_prefix[:q, :n] != 0
