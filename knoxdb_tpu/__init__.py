"""knoxdb_tpu — a vectorized columnar query engine in JAX.

A from-scratch JAX/XLA/Pallas implementation of the capability set of the
reference embedded analytics database (blockwatch-cc/knoxdb, surveyed in
SURVEY.md): compressed column packs with decode fused into the scan,
vectorized predicate filters compiled from AND/OR condition trees, zone-map
and bloom pack pruning, MVCC with WAL-backed journal/merge, aggregation,
sort/top-k and joins — scaled over device meshes with jax.sharding collectives.
"""

from . import config  # noqa: F401  (enables x64, sets pack geometry)
from .types import FieldType, FilterMode, IndexType, OrderType, JoinType

__version__ = "0.1.0"

__all__ = [
    "FieldType", "FilterMode", "IndexType", "OrderType", "JoinType",
    "knox", "create_database", "open_database",
]


def __getattr__(name):
    # lazy SDK surface: knoxdb_tpu.create_database(...) without importing
    # the engine stack at package import time. importlib, NOT
    # `from . import knox`: the fromlist path re-enters this __getattr__
    # while the submodule import is in flight -> infinite recursion on
    # `from knoxdb_tpu import knox`
    if name in ("knox", "create_database", "open_database"):
        import importlib
        mod = importlib.import_module(".knox", __name__)
        return mod if name == "knox" else getattr(mod, name)
    raise AttributeError(name)
