"""Graph execution: lowers a Symbol DAG to a function on tensors.

Counterpart of ``mxnet_tpu/executor.py:_build_graph_runner``. The JAX
package traces the same walk into one XLA program; here each op runs
eagerly on the tensors' device, and autograd records the training
forward. The ``Executor`` class, placement (``ctx_group``) and the
sharding hook come in a later slice; the arguments that select them raise.

The Conv1x1->BatchNorm fusion pass is the JAX package's, under the same
knob: ``MXTPU_FUSE_CONV_BN`` ``"0"`` (the default) leaves the graph as it
is; ``"1"`` or ``"interpret"`` route every pure NHWC 1x1 Convolution that
feeds a channel-last batch-statistics BatchNorm onto
``ops/matmul_stats.py``, which emits the convolution's output and the
BatchNorm's sum and sum of squares in one pass. Fusion happens only in
training, as in the JAX package. On CUDA tensors the pair runs the CUDA
kernel; on CPU tensors its plain version.
"""
from __future__ import annotations

import numpy as np
import torch

from .base import MXNetError, env_str
from .ops import matmul_stats as _ms
from .ops.registry import OpContext
from .symbol import _topo

#: MXTPU_FUSE_CONV_BN spellings: "0" off; "1" and "interpret" both fuse
FUSE_MODES = ("0", "1", "interpret")


def fuse_mode():
    """The ``MXTPU_FUSE_CONV_BN`` setting (default ``"0"``)."""
    mode = env_str("MXTPU_FUSE_CONV_BN", "0")
    if mode not in FUSE_MODES:
        raise MXNetError("MXTPU_FUSE_CONV_BN must be one of %s, got %r"
                         % (", ".join(FUSE_MODES), mode))
    return mode


def fusion_pairs(nodes):
    """The fusion pass over topologically ordered ``nodes``: returns
    ``(fused_convs, bn_stats_src)``, the Convolution nodes to run on the
    kernel by id, and for each consuming BatchNorm's id its producer's."""
    fused_convs, bn_stats_src = {}, {}
    for node in nodes:
        if node.is_variable or node.op.name != "BatchNorm":
            continue
        if not node.inputs or not _ms.bn_fusable(node.attrs):
            continue
        src, src_idx = node.inputs[0]
        if (src_idx == 0 and not src.is_variable
                and src.op.name == "Convolution"
                and _ms.conv1x1_fusable(src.attrs)):
            fused_convs[id(src)] = src
            bn_stats_src[id(node)] = id(src)
    return fused_convs, bn_stats_src


def node_generator(key, index, device):
    """The random stream of node ``index`` in a run keyed by ``key``: a
    ``torch.Generator`` on ``device`` seeded from both, so each node of
    each step draws its own numbers and a run replays from its key."""
    seed = np.random.SeedSequence([int(key), int(index)]).generate_state(
        1, np.uint64)[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & 0x7FFF_FFFF_FFFF_FFFF)
    return gen


def _build_graph_runner(symbol, placement=None, node_constraint=None):
    """Lower the symbol DAG to ``run(arg_vals, aux_vals, rng=None,
    is_train=False) -> (outputs, aux_updates)``. Nodes run in topological
    order over an environment keyed by (node, output index); aux state is
    looked up as ``"<node>_<aux>"`` and its updates come back under the
    same names. ``rng`` is an integer key: ops that declared ``needs_rng``
    get :func:`node_generator` of it and their node index. Returns
    ``(run, nodes)``."""
    if placement is not None:
        raise MXNetError("_build_graph_runner: placement (ctx_group model "
                         "parallelism) is not ported yet")
    if node_constraint is not None:
        raise MXNetError("_build_graph_runner: node_constraint (the "
                         "sharding hook) is not ported yet")
    nodes = _topo(symbol._out_nodes())
    fused_convs, bn_stats_src = ({}, {}) if fuse_mode() == "0" \
        else fusion_pairs(nodes)

    def run(arg_vals, aux_vals, rng=None, is_train=False):
        use_fusion = bool(fused_convs) and is_train
        env = {}
        stats_env = {}
        aux_updates = {}
        for k, node in enumerate(nodes):
            if node.is_variable:
                if node.name not in arg_vals:
                    raise MXNetError("graph runner: no value for %r"
                                     % node.name)
                env[(id(node), 0)] = arg_vals[node.name]
                continue
            ins = [env[(id(n), i)] for n, i in node.inputs]
            aux_names = node.op.list_aux(node.attrs)
            aux_in = [aux_vals["%s_%s" % (node.name, a)] for a in aux_names]
            if use_fusion and id(node) in fused_convs:
                y, stats_env[id(node)] = _ms.apply_conv1x1_stats(ins[0],
                                                                 ins[1])
                outs, aux_up = (y,), None
            else:
                gen = None
                if node.op.needs_rng and rng is not None:
                    gen = node_generator(rng, k, ins[0].device)
                fused_stats = (stats_env.get(bn_stats_src.get(id(node)))
                               if use_fusion else None)
                op_ctx = OpContext(is_train=is_train, rng=gen,
                                   fused_stats=fused_stats)
                outs, aux_up = node.op.apply(op_ctx, node.attrs, ins, aux_in)
            for i, o in enumerate(outs):
                env[(id(node), i)] = o
            if aux_up is not None:
                for a, u in zip(aux_names, aux_up):
                    aux_updates["%s_%s" % (node.name, a)] = u
        outputs = [env[(id(n), i)] for n, i in symbol._outputs]
        return outputs, aux_updates

    return run, nodes
