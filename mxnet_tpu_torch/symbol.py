"""Symbol: the declarative graph layer.

Counterpart of ``mxnet_tpu/symbol.py`` (ref: python/mxnet/symbol.py, nnvm
Symbol/Graph): a pure-Python DAG over registry ops with the reference's
auto-naming (``NameManager``), ``Group``, ``get_internals``, shape and
dtype inference, composition and NNVM JSON save/load, including the
upgrade of pre-0.9 legacy JSON. The same model built in either package
gives the same JSON and the same parameter names. The graph runs through
``executor._build_graph_runner``; ``bind``/``simple_bind`` make an
:class:`executor.Executor`.
"""
from __future__ import annotations

import json
import sys
import threading

import numpy as np

from .base import MXNetError, attr_tuple
from .ops import registry as _reg


# ---------------------------------------------------------------------------
# naming (ref: python/mxnet/name.py)
# ---------------------------------------------------------------------------
class NameManager(object):
    _current = threading.local()

    def __init__(self):
        self._counter = {}
        self._old = None

    def get(self, name, hint):
        if name:
            return name
        if hint not in self._counter:
            self._counter[hint] = 0
        name = "%s%d" % (hint, self._counter[hint])
        self._counter[hint] += 1
        return name

    def __enter__(self):
        self._old = getattr(NameManager._current, "value", None)
        NameManager._current.value = self
        return self

    def __exit__(self, *a):
        NameManager._current.value = self._old


def _current_nm():
    nm = getattr(NameManager._current, "value", None)
    if nm is None:
        nm = NameManager()
        NameManager._current.value = nm
    return nm


class Prefix(NameManager):
    """A NameManager that prefixes every name it gives out (ref:
    python/mxnet/name.py Prefix)."""

    def __init__(self, prefix):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        name = super().get(name, hint)
        return self._prefix + name


class AttrScope(object):
    """``with AttrScope(ctx_group='dev1'):`` attaches attributes to the
    symbols built inside it; nested scopes merge, the inner value winning
    (ref: python/mxnet/attribute.py). ``ctx_group`` drives group2ctx model
    parallelism (``parallel.placement``)."""
    _current = threading.local()

    def __init__(self, **kwargs):
        self._attr = {str(k): str(v) for k, v in kwargs.items()}
        self._old = None

    def get(self, attr):
        out = dict(self._attr)
        if attr:
            out.update(attr)
        return out

    def __enter__(self):
        self._old = getattr(AttrScope._current, "value", None)
        base = self._old._attr if self._old else {}
        merged = dict(base)
        merged.update(self._attr)
        self._attr = merged
        AttrScope._current.value = self
        return self

    def __exit__(self, *a):
        AttrScope._current.value = self._old


def _current_attrs(attr=None):
    sc = getattr(AttrScope._current, "value", None)
    return sc.get(attr) if sc else dict(attr or {})


# ---------------------------------------------------------------------------
# graph node
# ---------------------------------------------------------------------------
class _Node(object):
    __slots__ = ("op", "name", "attrs", "inputs", "_user_attr")

    def __init__(self, op, name, attrs=None, inputs=None, user_attr=None):
        self.op = op                  # OpDef or None (variable)
        self.name = name
        self.attrs = dict(attrs or {})
        self.inputs = list(inputs or [])   # list of (node, out_index)
        self._user_attr = dict(user_attr or {})

    @property
    def is_variable(self):
        return self.op is None

    def num_outputs(self):
        return 1 if self.is_variable else self.op.num_outputs(self.attrs)

    def output_names(self):
        if self.is_variable:
            return [self.name]
        outs = self.op.list_outputs(self.attrs)
        if len(outs) == 1:
            return ["%s_output" % self.name]
        return ["%s_%s" % (self.name, o) for o in outs]


def _topo(nodes_out):
    """Stable topological order of all nodes reachable from output nodes."""
    order, seen = [], set()

    def visit(node):
        if id(node) in seen:
            return
        seen.add(id(node))
        for inp, _ in node.inputs:
            visit(inp)
        order.append(node)

    for n in nodes_out:
        visit(n)
    return order


class Symbol(object):
    """A (multi-)output slice of the graph."""

    def __init__(self, outputs):
        self._outputs = list(outputs)  # list of (node, out_index)

    # -- identity -------------------------------------------------------
    @property
    def name(self):
        if len(self._outputs) == 1:
            return self._outputs[0][0].name
        return None

    def __repr__(self):
        return "<Symbol %s>" % (self.name or "Grouped")

    def __iter__(self):
        return (self[i] for i in range(len(self)))

    def __len__(self):
        return len(self.list_outputs())

    def __getitem__(self, index):
        if isinstance(index, str):
            names = self.list_outputs()
            if index not in names:
                raise MXNetError("output %r not found in %s" % (index, names))
            index = names.index(index)
        return Symbol([self._outputs[index]])

    def __copy__(self):
        return Symbol(list(self._outputs))

    def __deepcopy__(self, memo):
        return load_json(self.tojson())

    # -- arithmetic composition (ref: python/mxnet/symbol.py) -----------
    def _binary(self, opname, other, reverse=False):
        if isinstance(other, Symbol):
            lhs, rhs = (other, self) if reverse else (self, other)
            return _create("broadcast_" + opname, [lhs, rhs], {})
        if np.isscalar(other):
            if reverse and opname in ("sub", "div", "power", "mod"):
                return _create({"sub": "_rminus_scalar", "div": "_rdiv_scalar",
                                "power": "_rpower_scalar",
                                "mod": "_rmod_scalar"}[opname],
                               [self], {"scalar": other})
            return _create("_%s_scalar" % opname, [self], {"scalar": other})
        raise MXNetError("unsupported operand %r" % (other,))

    def __add__(self, o): return self._binary("add", o)
    def __radd__(self, o): return self._binary("add", o)
    def __sub__(self, o): return self._binary("sub", o)
    def __rsub__(self, o): return self._binary("sub", o, reverse=True)
    def __mul__(self, o): return self._binary("mul", o)
    def __rmul__(self, o): return self._binary("mul", o)
    def __truediv__(self, o): return self._binary("div", o)
    def __rtruediv__(self, o): return self._binary("div", o, reverse=True)
    def __pow__(self, o): return self._binary("power", o)
    def __neg__(self): return _create("negative", [self], {})

    # -- listing --------------------------------------------------------
    def _out_nodes(self):
        return [n for n, _ in self._outputs]

    def list_arguments(self):
        return [n.name for n in _topo(self._out_nodes()) if n.is_variable]

    def list_outputs(self):
        return [node.output_names()[idx] for node, idx in self._outputs]

    def list_auxiliary_states(self):
        aux = []
        for node in _topo(self._out_nodes()):
            if not node.is_variable:
                for a in node.op.list_aux(node.attrs):
                    aux.append("%s_%s" % (node.name, a))
        return aux

    def get_internals(self):
        outs = []
        for node in _topo(self._out_nodes()):
            for i in range(node.num_outputs()):
                outs.append((node, i))
        return Symbol(outs)

    def get_children(self):
        kids = []
        for node, _ in self._outputs:
            kids.extend(node.inputs)
        return Symbol(kids) if kids else None

    # -- attributes -----------------------------------------------------
    def attr(self, key):
        if len(self._outputs) == 1:
            return self._outputs[0][0]._user_attr.get(key, None)
        return None

    def attr_dict(self):
        out = {}
        for node in _topo(self._out_nodes()):
            if node._user_attr:
                out[node.name] = dict(node._user_attr)
        return out

    def list_attr(self):
        if len(self._outputs) == 1:
            return dict(self._outputs[0][0]._user_attr)
        return {}

    def _set_attr(self, **kwargs):
        for node, _ in self._outputs:
            node._user_attr.update({k: str(v) for k, v in kwargs.items()})

    # -- composition (ref: symbol.py __call__/_compose) ----------------
    def __call__(self, *args, **kwargs):
        s = self.__copy__()
        s._compose(*args, **kwargs)
        return s

    def _compose(self, *args, **kwargs):
        """Substitute symbols for arguments, by position or by name; the
        graph above them is copied, the substituted subgraphs are shared."""
        name = kwargs.pop("name", None)
        if args and kwargs:
            raise MXNetError("compose only accepts input Symbols "
                             "either as positional or keyword arguments")
        arg_names = self.list_arguments()
        repl = {}
        for n, a in zip(arg_names, args):
            repl[n] = a._outputs[0]
        for k, v in kwargs.items():
            if k not in arg_names:
                raise MXNetError("compose: %r is not an argument" % k)
            repl[k] = v._outputs[0]
        memo = {}

        def rewrite(node):
            # a replaced variable maps to a (node, idx) pair, any other node
            # to a (possibly new) _Node
            if id(node) in memo:
                return memo[id(node)]
            if node.is_variable and node.name in repl:
                memo[id(node)] = repl[node.name]
                return memo[id(node)]
            fixed = []
            for (n, i) in node.inputs:
                r = rewrite(n)
                fixed.append(r if isinstance(r, tuple) else (r, i))
            new = _Node(node.op, node.name, node.attrs, fixed,
                        node._user_attr)
            memo[id(node)] = new
            return new

        new_outputs = []
        for node, idx in self._outputs:
            r = rewrite(node)
            new_outputs.append(r if isinstance(r, tuple) else (r, idx))
        self._outputs = new_outputs
        if name and len(self._outputs) == 1:
            self._outputs[0][0].name = name

    # -- inference ------------------------------------------------------
    def infer_shape(self, *args, **kwargs):
        """Shapes of (arguments, outputs, aux states) given input shapes
        by position or name; raises when an argument stays unknown."""
        return self._infer_shape_impl(False, *args, **kwargs)

    def infer_shape_partial(self, *args, **kwargs):
        """As :meth:`infer_shape`, with None for what stays unknown."""
        return self._infer_shape_impl(True, *args, **kwargs)

    def _infer_shape_impl(self, partial, *args, **kwargs):
        arg_names = self.list_arguments()
        known = {}
        if args:
            for n, s in zip(arg_names, args):
                if s is not None:
                    known[n] = tuple(s)
        for k, v in kwargs.items():
            if v is not None:
                known[k] = tuple(v)
        node_out_shapes = {}   # (id(node), idx) -> shape
        var_shapes = dict(known)
        aux_shapes = {}
        for node in _topo(self._out_nodes()):
            if node.is_variable:
                sh = var_shapes.get(node.name)
                if sh is None and "__shape__" in node._user_attr:
                    sh = attr_tuple(node._user_attr["__shape__"])
                    var_shapes[node.name] = sh
                node_out_shapes[(id(node), 0)] = sh
                continue
            in_shapes = [node_out_shapes.get((id(inp), idx))
                         for (inp, idx) in node.inputs]
            try:
                full_in, outs, aux = node.op.infer_shape(node.attrs,
                                                         in_shapes)
            except MXNetError:
                if not partial:
                    raise
                for i in range(node.num_outputs()):
                    node_out_shapes[(id(node), i)] = None
                continue
            for (inp, idx), sh in zip(node.inputs, full_in):
                if inp.is_variable and sh is not None:
                    prev = var_shapes.get(inp.name)
                    if prev is not None and tuple(prev) != tuple(sh):
                        raise MXNetError(
                            "shape mismatch for %s: %s vs %s"
                            % (inp.name, prev, sh))
                    var_shapes[inp.name] = tuple(sh)
                    node_out_shapes[(id(inp), 0)] = tuple(sh)
            for i, sh in enumerate(outs):
                node_out_shapes[(id(node), i)] = tuple(sh)
            for aname, ash in zip(node.op.list_aux(node.attrs), aux):
                aux_shapes["%s_%s" % (node.name, aname)] = tuple(ash)
        arg_out = []
        for n in arg_names:
            sh = var_shapes.get(n)
            if sh is None and not partial:
                raise MXNetError("cannot infer shape of argument %r "
                                 "(provide it to infer_shape)" % n)
            arg_out.append(sh)
        out_shapes = [node_out_shapes.get((id(n), i)) for n, i in self._outputs]
        aux_out = [aux_shapes.get(a) for a in self.list_auxiliary_states()]
        return arg_out, out_shapes, aux_out

    def infer_type(self, *args, **kwargs):
        """Forward dtype propagation over the DAG (ref: nnvm InferType;
        per-op rules on ``OpDef.infer_type``). Unknown dtypes default to
        float32 after propagation, so one typed input (bf16 data, int32
        label) types the whole network. Dtypes are numpy dtypes."""
        return self._infer_type_impl(False, *args, **kwargs)

    def infer_type_partial(self, *args, **kwargs):
        """As :meth:`infer_type`, with None for what stays unknown."""
        return self._infer_type_impl(True, *args, **kwargs)

    def _infer_type_impl(self, partial, *args, **kwargs):
        arg_names = self.list_arguments()
        var_types = {n: np.dtype(t) for n, t in zip(arg_names, args)
                     if t is not None}
        var_types.update({k: np.dtype(v) for k, v in kwargs.items()
                          if v is not None})
        node_out = {}       # (id(node), idx) -> dtype | None
        aux_types = {}
        # two sweeps: dtypes one layer settles (shared weights, data typed
        # by a later op) reach layers visited earlier
        for _sweep in range(2):
            for node in _topo(self._out_nodes()):
                if node.is_variable:
                    dt = var_types.get(node.name)
                    if dt is None and "__dtype__" in node._user_attr:
                        dt = np.dtype(node._user_attr["__dtype__"])
                        var_types[node.name] = dt
                    node_out[(id(node), 0)] = dt
                    continue
                in_types = [node_out.get((id(inp), idx))
                            for (inp, idx) in node.inputs]
                try:
                    full_in, outs, aux = node.op.infer_type(node.attrs,
                                                            in_types)
                except MXNetError:
                    if not partial:
                        raise
                    for i in range(node.num_outputs()):
                        node_out[(id(node), i)] = None
                    continue
                for (inp, idx), dt in zip(node.inputs, full_in):
                    if inp.is_variable and dt is not None:
                        prev = var_types.get(inp.name)
                        if prev is not None and np.dtype(prev) != np.dtype(dt):
                            raise MXNetError(
                                "type mismatch for %s: %s vs %s"
                                % (inp.name, prev, dt))
                        var_types[inp.name] = np.dtype(dt)
                        node_out[(id(inp), 0)] = np.dtype(dt)
                for i, dt in enumerate(outs):
                    node_out[(id(node), i)] = (np.dtype(dt)
                                               if dt is not None else None)
                for aname, adt in zip(node.op.list_aux(node.attrs), aux):
                    aux_types["%s_%s" % (node.name, aname)] = (
                        np.dtype(adt) if adt is not None else None)
        dflt = None if partial else np.dtype(np.float32)
        return ([var_types.get(n) or dflt for n in arg_names],
                [node_out.get((id(n), i)) or dflt for n, i in self._outputs],
                [aux_types.get(a) or dflt
                 for a in self.list_auxiliary_states()])

    # -- serialization (ref: nnvm JSON save; legacy_json_util.cc) -------
    def tojson(self):
        """Emit reference NNVM graph JSON: 3-element ``[id, idx, version]``
        inputs, ``arg_nodes``/``node_row_ptr``/``heads``, op params and user
        attrs merged into one stringified ``attrs`` dict, and a top-level
        ``attrs.mxnet_version``."""
        nodes = _topo(self._out_nodes())
        nid = {id(n): i for i, n in enumerate(nodes)}
        jnodes, arg_nodes, row_ptr = [], [], [0]
        for i, n in enumerate(nodes):
            jn = {
                "op": "null" if n.is_variable else n.op.name,
                "name": n.name,
                "inputs": [[nid[id(inp)], idx, 0] for inp, idx in n.inputs],
            }
            merged = {k: str(v) for k, v in n.attrs.items()}
            # hidden keys are stored wrapped in the reference
            # (c_api_symbolic.cc kReplacedHiddenKeys)
            merged.update({("__%s__" % k if k in _HIDDEN_KEYS else k): str(v)
                           for k, v in n._user_attr.items()})
            if merged:
                jn["attrs"] = merged
            jnodes.append(jn)
            if n.is_variable:
                arg_nodes.append(i)
            row_ptr.append(row_ptr[-1] + n.num_outputs())
        heads = [[nid[id(n)], idx, 0] for n, idx in self._outputs]
        return json.dumps({"nodes": jnodes, "arg_nodes": arg_nodes,
                           "node_row_ptr": row_ptr, "heads": heads,
                           "attrs": {"mxnet_version": ["int", 905]}},
                          indent=2)

    def save(self, fname):
        with open(fname, "w") as f:
            f.write(self.tojson())

    # -- binding (executor.py) ------------------------------------------
    def bind(self, ctx, args, args_grad=None, grad_req="write",
             aux_states=None, group2ctx=None, shared_exec=None):
        """An :class:`executor.Executor` over the given arrays."""
        from .executor import Executor
        return Executor(self, ctx, args, args_grad, grad_req, aux_states,
                        group2ctx=group2ctx, shared_exec=shared_exec)

    def simple_bind(self, ctx, grad_req="write", type_dict=None,
                    group2ctx=None, shared_exec=None, **kwargs):
        """Allocate every array from the inferred shapes and dtypes on
        ``ctx``, then bind."""
        from .executor import simple_bind as _sb
        return _sb(self, ctx, grad_req=grad_req, type_dict=type_dict,
                   group2ctx=group2ctx, shared_exec=shared_exec, **kwargs)

    def eval(self, ctx=None, **kwargs):
        """Forward on the given arrays; returns the outputs."""
        from .context import current_context
        ex = self.bind(ctx or current_context(), kwargs)
        return ex.forward()


# ---------------------------------------------------------------------------
# constructors
# ---------------------------------------------------------------------------

def Variable(name, attr=None, shape=None, lr_mult=None, wd_mult=None,
             dtype=None, init=None):
    """Create a variable symbol (ref: symbol.py Variable)."""
    if not isinstance(name, str):
        raise MXNetError("Variable name must be a string")
    user_attr = _current_attrs(attr)
    if shape is not None:
        user_attr["__shape__"] = str(tuple(shape))
    if lr_mult is not None:
        user_attr["__lr_mult__"] = str(lr_mult)
    if wd_mult is not None:
        user_attr["__wd_mult__"] = str(wd_mult)
    if dtype is not None:
        user_attr["__dtype__"] = str(np.dtype(dtype))
    if init is not None:
        user_attr["__init__"] = init if isinstance(init, str) else init.dumps()
    node = _Node(None, name, user_attr=user_attr)
    return Symbol([(node, 0)])


def Group(symbols):
    outs = []
    for s in symbols:
        outs.extend(s._outputs)
    return Symbol(outs)


def load(fname):
    with open(fname) as f:
        return load_json(f.read())


# Attr keys the reference stores double-underscore-wrapped on migration
# (ref: src/c_api/c_api_symbolic.cc:20 kHiddenKeys,
# src/nnvm/legacy_json_util.cc UpgradeJSON_FixParsing).
_HIDDEN_KEYS = ("ctx_group", "lr_mult", "wd_mult", "force_mirroring",
                "mirror_stage")


def _split_attrs(raw):
    """Split a loaded NNVM node attr dict into (op attrs, user attrs),
    migrating hidden keys to the form the consumers read (``__lr_mult__``
    etc.; ``ctx_group`` stays plain)."""
    op_attrs, user = {}, {}
    for k, v in raw.items():
        if k.startswith("__") and k.endswith("__"):
            inner = k[2:-2]
            user["ctx_group" if inner == "ctx_group" else k] = v
        elif k in _HIDDEN_KEYS:
            user["ctx_group" if k == "ctx_group" else "__%s__" % k] = v
        else:
            op_attrs[k] = v
    return op_attrs, user


def load_json(json_str):
    """Parse symbol JSON. Accepts (a) current NNVM graph JSON (3-element
    inputs, merged ``attrs``), (b) pre-0.9 legacy JSON (``param`` dicts,
    2-element inputs, missing input variables, suffix-style hidden keys —
    upgrade rules from src/nnvm/legacy_json_util.cc), and (c) the JAX
    package's early 2-tuple format."""
    data = json.loads(json_str)
    if "mxnet_tpu_version" in data:            # the JAX package's early format
        nodes = []
        for jn in data["nodes"]:
            if jn["op"] == "null":
                node = _Node(None, jn["name"],
                             user_attr=jn.get("user_attrs", {}))
            else:
                node = _Node(_reg.get(jn["op"]), jn["name"],
                             jn.get("attrs", {}),
                             user_attr=jn.get("user_attrs", {}))
            node.inputs = [(nodes[i], idx) for i, idx in jn["inputs"]]
            nodes.append(node)
        return Symbol([(nodes[i], idx) for i, idx in data["heads"]])

    nodes = []
    for jn in data["nodes"]:
        raw = dict(jn.get("attrs") or jn.get("attr") or jn.get("param") or {})
        if "attrs" not in jn and "attr" in jn and "param" in jn:
            raw.update(jn["param"])            # 0.8 stores both
        op_attrs, user = _split_attrs(raw)
        opname = jn["op"]
        if opname == "null":
            # a variable has no op params: every remaining attr is a user
            # attr
            user.update(op_attrs)
            node = _Node(None, jn["name"], user_attr=user)
        else:
            if not _reg.exists(opname):
                raise MXNetError("load_json: unknown operator %r" % opname)
            node = _Node(_reg.get(opname), jn["name"], op_attrs,
                         user_attr=user)
        node.inputs = [(nodes[e[0]], e[1]) for e in jn["inputs"]]
        nodes.append(node)

    # legacy upgrades (ref: legacy_json_util.cc): suffix hidden keys
    # ("weight_lr_mult" -> __lr_mult__ on the weight input variable) and
    # input variables absent from pre-0.9 graphs
    for node in nodes:
        if node.is_variable:
            continue
        arg_names = node.op.list_inputs(node.attrs)
        for k in list(node.attrs):
            for key in _HIDDEN_KEYS:
                if k.endswith("_" + key):
                    arg = k[:-(len(key) + 1)]
                    if arg in arg_names:
                        i = arg_names.index(arg)
                        if (i < len(node.inputs)
                                and node.inputs[i][0].is_variable):
                            dst = ("ctx_group" if key == "ctx_group"
                                   else "__%s__" % key)
                            node.inputs[i][0]._user_attr[dst] = \
                                node.attrs.pop(k)
                    break
        if len(node.inputs) < len(arg_names):
            for aname in arg_names[len(node.inputs):]:
                var = _Node(None, "%s_%s" % (node.name, aname),
                            user_attr=dict(node._user_attr))
                node.inputs.append((var, 0))
    return Symbol([(nodes[e[0]], e[1]) for e in data["heads"]])


# ---------------------------------------------------------------------------
# op constructors: symbol-space function per registered op
# ---------------------------------------------------------------------------

def _create(op_name, input_syms, attrs, name=None, user_attr=None):
    opdef = _reg.get(op_name)
    hint = opdef.name.lower().lstrip("_")
    node_name = _current_nm().get(name, hint)
    user_attr = _current_attrs(user_attr)
    node = _Node(opdef, node_name, attrs, user_attr=user_attr)
    in_names = opdef.list_inputs(attrs)
    inputs = []
    for i, iname in enumerate(in_names):
        if i < len(input_syms) and input_syms[i] is not None:
            s = input_syms[i]
            if not isinstance(s, Symbol):
                raise MXNetError("input %d of %s must be Symbol, got %r"
                                 % (i, op_name, type(s)))
            inputs.append(s._outputs[0])
        else:
            var = _Node(None, "%s_%s" % (node_name, iname))
            inputs.append((var, 0))
    node.inputs = inputs
    return Symbol([(node, i) for i in range(node.num_outputs())])


def _make_sym_func(opdef):
    def sym_func(*args, **kwargs):
        name = kwargs.pop("name", None)
        attr = kwargs.pop("attr", None)
        # split kwargs into symbol inputs vs attrs
        sym_kwargs = {k: v for k, v in kwargs.items() if isinstance(v, Symbol)}
        attrs = {k: v for k, v in kwargs.items() if not isinstance(v, Symbol)}
        input_syms = list(args)
        if sym_kwargs:
            if input_syms:
                raise MXNetError(
                    "%s: pass inputs either positionally or by name"
                    % opdef.name)
            if (opdef.var_inputs_attr is not None
                    and opdef.var_inputs_attr not in attrs):
                attrs[opdef.var_inputs_attr] = len(sym_kwargs)
            input_syms = [sym_kwargs.get(n) for n in opdef.list_inputs(attrs)]
        elif (opdef.var_inputs_attr is not None
              and opdef.var_inputs_attr not in attrs):
            attrs[opdef.var_inputs_attr] = len(input_syms)
        return _create(opdef.name, input_syms, attrs, name=name,
                       user_attr=attr)
    sym_func.__name__ = opdef.name
    sym_func.__doc__ = "symbolic operator %s" % opdef.name
    return sym_func


def _init_symbol_module():
    mod = sys.modules[__name__]
    for name in _reg.list_ops():
        setattr(mod, name, _make_sym_func(_reg.get(name)))


_init_symbol_module()
