from . import distributed
from .distributed import initialize, make_global_factor_mesh, process_info
from .mesh import FACTOR_AXIS, FactorMesh, factor_sharding, make_factor_mesh
from .sharded import all_gather_rows, all_sum, reducer, row_block, shard_solve, sharded_quadratic

__all__ = [
    "FACTOR_AXIS",
    "FactorMesh",
    "all_gather_rows",
    "all_sum",
    "distributed",
    "factor_sharding",
    "initialize",
    "make_factor_mesh",
    "make_global_factor_mesh",
    "process_info",
    "reducer",
    "row_block",
    "shard_solve",
    "sharded_quadratic",
]
