"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Mirrors the reference's env-matrix strategy (same suite against multiple
backends, SURVEY.md §4): unit/integration tests run on CPU, Pallas kernels
in interpret mode; the sharding tests use the 8 virtual devices. The GPU
path is exercised by ``chip_smoke.py`` on the card.
"""

import os

# Force CPU before any backend initialisation: the tests never take a GPU
# (a JAX process reserves most of the card's memory when it first uses it).
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402


@pytest.fixture(scope="session")
def jax_devices():
    import jax

    return jax.devices()


# ---------------------------------------------------------------------------
# Whole-suite env matrix (reference .github/workflows/rust.yml:27-34 runs the
# ENTIRE suite under {default, Persistent, Persistent+FlushThreshold=20,
# Transient}). `tools/run_matrix.sh` drives the same matrix here:
#
#   PersistenceType=Persistent  -> every in-process build round-trips through
#                                  save() + mmap load() (this hook)
#   VELOCI_SPILL_PAIRS=1        -> all index packing goes through the
#                                  external-sort spill machinery (read at
#                                  import by veloci_tpu.spill)
#   VELOCI_DEVICE_MIN_DOCS=1    -> integration modules execute the device
#                                  paths (read at import by the executor)
# ---------------------------------------------------------------------------
if os.environ.get("PersistenceType") == "Persistent":
    import tempfile

    from veloci_tpu.persistence import Persistence as _P

    _orig_create = _P.create_from_str.__func__

    def _persistent_create(cls, data_str, indices="{}", **kw):
        built = _orig_create(cls, data_str, indices, **kw)
        d = tempfile.mkdtemp(prefix="veloci_matrix_")
        built.save(d)
        return _P.load(d)

    _P.create_from_str = classmethod(_persistent_create)
