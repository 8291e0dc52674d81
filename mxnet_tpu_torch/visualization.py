"""Network visualization (ref: python/mxnet/visualization.py): the
per-layer table of :func:`print_summary` and the graphviz drawing of
:func:`plot_network`.

Counterpart of ``mxnet_tpu/visualization.py``, exported as ``mt.viz``.
Both read the symbol's NNVM JSON, which the two packages share, so
``print_summary`` prints the JAX package's table for the same symbol and
shapes. ``plot_network`` needs the optional ``graphviz`` package and raises
``MXNetError`` without it, as the JAX package's does.
"""
from __future__ import annotations

import json

from .base import MXNetError
from .symbol import Symbol

#: parameters of a symbol ``plot_network`` hides (hide_weights=True)
_WEIGHT_SUFFIXES = ("_weight", "_bias", "_gamma", "_beta")


def print_summary(symbol, shape=None, line_length=120,
                  positions=(.44, .64, .74, 1.)):
    """Print a table of the symbol's nodes: each one's name and op, output
    shape (where ``shape``, a dict of input shapes, is given), parameter
    count and the layers feeding it (ref: visualization.py print_summary).
    """
    if not isinstance(symbol, Symbol):
        raise TypeError("symbol must be Symbol")
    shape_dict = {}
    if shape is not None:
        internals = symbol.get_internals()
        _, out_shapes, _ = internals.infer_shape_partial(**shape)
        shape_dict = dict(zip(internals.list_outputs(), out_shapes))
    conf = json.loads(symbol.tojson())
    nodes = conf["nodes"]
    heads = set(h[0] for h in conf["heads"])
    if positions[-1] <= 1:
        positions = [int(line_length * p) for p in positions]

    def print_row(fields):
        line = ""
        for field, pos in zip(fields, positions):
            line += str(field)
            line = line[:pos]
            line += " " * (pos - len(line))
        print(line)

    print("_" * line_length)
    print_row(["Layer (type)", "Output Shape", "Param #", "Previous Layer"])
    print("=" * line_length)
    total_params = 0
    for node in nodes:
        op = node["op"]
        pre_node = []
        if op != "null":
            for item in node["inputs"]:
                inp = nodes[item[0]]
                if inp["op"] != "null" or item[0] in heads:
                    pre_node.append(inp["name"])
        # parameters are counted as the JAX package counts them: none
        cur_param = 0
        out_shape = ""
        if shape is not None:
            key = node["name"] + ("_output" if op != "null" else "")
            out_shape = shape_dict.get(key, "")
        print_row(["%s(%s)" % (node["name"], op),
                   str(out_shape) if out_shape else "", cur_param,
                   ",".join(pre_node)])
        total_params += cur_param
        print("_" * line_length)
    print("Total params: %s" % total_params)
    print("_" * line_length)


def plot_network(symbol, title="plot", save_format="pdf", shape=None,
                 node_attrs={}, hide_weights=True):
    """A ``graphviz.Digraph`` of the symbol's DAG (ref: visualization.py
    plot_network). Needs the optional graphviz package."""
    try:
        from graphviz import Digraph
    except ImportError:
        raise MXNetError("plot_network requires graphviz (optional dep)")
    if not isinstance(symbol, Symbol):
        raise TypeError("symbol must be a Symbol")
    nodes = json.loads(symbol.tojson())["nodes"]
    node_attr = {"shape": "box", "fixedsize": "true", "width": "1.3",
                 "height": "0.8034", "style": "filled"}
    node_attr.update(node_attrs)
    dot = Digraph(name=title, format=save_format)
    hidden = set()
    for i, node in enumerate(nodes):
        op, name = node["op"], node["name"]
        if op == "null":
            if hide_weights and name.endswith(_WEIGHT_SUFFIXES):
                hidden.add(i)
                continue
            dot.node(name=name, label=name, fillcolor="#8dd3c7")
        else:
            dot.node(name=name, label="%s\n%s" % (op, name),
                     fillcolor="#fb8072" if "Output" in op or op == "MakeLoss"
                     else "#80b1d3")
    for node in nodes:
        if node["op"] == "null":
            continue
        for item in node["inputs"]:
            if item[0] not in hidden:
                dot.edge(tail_name=nodes[item[0]]["name"],
                         head_name=node["name"])
    return dot
