"""Data parallelism over a mesh of replicas.

Counterpart of ``mxnet_tpu/parallel``: the 'data' axis (``mesh``). A
training step over a 'data' mesh runs every replica's shard of the batch
in one process, node by node in lock step (``executor``), with the
batch-axis reductions (BatchNorm's statistics, loss normalisation) and the
gradients summed across replicas. The model, seq and pipe axes
(``placement``, ``ring``, ``pipeline``) are ROADMAP.md A.7b.
"""
from .mesh import (make_mesh, data_parallel_mesh, current_mesh, MeshScope,
                   replicate, shard_batch, grad_sync, data_axis_size,
                   superbatch_sharding, parse_mesh_axes, mesh_from_spec,
                   check_axis_divides, Mesh, MeshArray, NamedSharding, P)
