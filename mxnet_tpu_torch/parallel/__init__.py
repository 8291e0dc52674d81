"""Parallelism over a mesh of positions.

Counterpart of ``mxnet_tpu/parallel``: meshes with 'data', 'model', 'seq'
and 'pipe' axes (``mesh``), group2ctx placement lowered to partition specs
(``placement``), ring and Ulysses attention over the 'seq' axis
(``ring``) and the GPipe schedule over the 'pipe' axis (``pipeline``). A
training step over a mesh runs every position's shard in one process,
node by node in lock step (``executor``), with the collectives between
positions explicit and differentiable.
"""
from .mesh import (make_mesh, data_parallel_mesh, current_mesh, MeshScope,
                   replicate, shard_batch, grad_sync, data_axis_size,
                   superbatch_sharding, parse_mesh_axes, mesh_from_spec,
                   check_axis_divides, Mesh, MeshArray, NamedSharding, P)
from . import ring  # noqa: F401
from . import placement  # noqa: F401
from .pipeline import pipeline_apply, pipeline_spmd  # noqa: F401
