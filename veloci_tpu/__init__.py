"""veloci_tpu — a full-text search engine on one or more accelerators.

A from-scratch rebuild of the capabilities of the reference engine
(PSeitz/veloci, a Rust single-node search library) in JAX: immutable
columnar indices resident in device memory, batched Levenshtein dictionary
sweeps (a Pallas kernel on NVIDIA GPUs), dense per-document score vectors
with XLA-fused set ops and boosts, and `jax.sharding`-based multi-device
sharding (per-shard top-k merged with collectives).

Public surface:

* :func:`create_indices_from_str` / :class:`Persistence` — index build + store
* :func:`search` / :func:`search_to_result_with_doc` / :func:`suggest`
* :mod:`veloci_tpu.query` — request model, query-language parser, generator
* :mod:`veloci_tpu.server` — HTTP API matching the reference's routes
"""

from .create import add_token_values_to_tokens, create_indices_from_str  # noqa: F401
from .error import VelociError  # noqa: F401
from .json_flatten import to_line_delimited  # noqa: F401
from .persistence import Persistence  # noqa: F401
from .query.request import (  # noqa: F401
    FacetRequest,
    Request,
    RequestBoostPart,
    RequestPhraseBoost,
    RequestSearchPart,
    SearchRequest,
)
from .search import (  # noqa: F401
    search,
    search_to_result_with_doc,
)
from .search.executor import explain_plan, suggest  # noqa: F401

__version__ = "0.1.0"
