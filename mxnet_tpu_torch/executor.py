"""Graph execution: lowers a Symbol DAG to a function on tensors.

Counterpart of ``mxnet_tpu/executor.py:_build_graph_runner``, forward only
and in inference mode. The JAX package traces the same walk into one XLA
program; here each op runs eagerly on the tensors' device. The training
parts (``is_train``, the Conv1x1->BatchNorm fusion pass, placement and
sharding hooks) and the ``Executor`` class come in a later slice.
"""
from __future__ import annotations

from .base import MXNetError
from .ops.registry import OpContext
from .symbol import _topo


def _build_graph_runner(symbol):
    """Lower the symbol DAG to ``run(arg_vals: dict, aux_vals: dict) ->
    list of output tensors``. Nodes run in topological order over an
    environment keyed by (node, output index); aux state is looked up as
    ``"<node>_<aux>"``. Returns ``(run, nodes)``."""
    nodes = _topo(symbol._out_nodes())
    op_ctx = OpContext(is_train=False)

    def run(arg_vals, aux_vals):
        env = {}
        for node in nodes:
            if node.is_variable:
                if node.name not in arg_vals:
                    raise MXNetError("graph runner: no value for %r"
                                     % node.name)
                env[(id(node), 0)] = arg_vals[node.name]
                continue
            ins = [env[(id(n), i)] for n, i in node.inputs]
            aux_in = [aux_vals["%s_%s" % (node.name, a)]
                      for a in node.op.list_aux(node.attrs)]
            outs = node.op.apply(op_ctx, node.attrs, ins, aux_in)
            for i, o in enumerate(outs):
                env[(id(node), i)] = o
        return [env[(id(n), i)] for n, i in symbol._outputs]

    return run, nodes
