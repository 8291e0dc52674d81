"""Continuous-batching decode loop for the transformer LM, with its four
legs: sampling, quantized weights, the prefix cache and speculative
decoding.

Counterpart of ``mxnet_tpu/serving/decode.py``. Each sequence wants one
token per model pass, sequences finish at different times, and throughput
comes from keeping every batch slot busy:

* the KV cache, ``(layers, slots, heads, rows, head_dim)`` float32 for K
  and for V, plus each slot's RNG seed, is device state. Where the JAX
  package donates it to one compiled program a step, the port updates it
  in place (indexed assignment) from a decode body of plain torch ops run
  on the loop's device;
* sequences occupy slots: a new request joins any free slot mid-stream,
  its prompt teacher-forced through the same decode body one token a
  step, over whatever the retired occupant left in the cache (positions
  past ``pos`` are masked, so stale rows are unreachable);
* the host supplies the next tokens and reads back the sampled token ids:
  one ``(slots,)`` int32 vector a step, never the logits.

**Sampling** (per request ``temperature``/``top_k``/``top_p``/``seed``)
happens on the device through :mod:`.sampling`: the uniform of a slot's
sample at cache position ``p`` is a pure function of ``(seed, p)``, so a
stream is fixed by its seed whoever rides beside it, and
``temperature=0`` is bitwise the greedy argmax.

**Quantized weights** (``quantize=``/``MXTPU_SERVE_QUANT``: ``none`` |
``bf16`` | ``int8``): stored as :mod:`.quantize` stores them, widened to
float32 inside each step; :meth:`DecodeLoop.weight_bytes` reports the
resident bytes.

**Prefix cache** (``prefix_cache=``/``MXTPU_SERVE_PREFIX_CACHE``, on by
default; capacity ``MXTPU_SERVE_PREFIX_MAX``, least recently used first
out): ``generate(..., prefix_len=L)`` names ``prompt[:L]`` a shared
prefix. The first sequence to decode it has its KV slab copied out on the
device; later joins copy the slab into their slot and skip teacher-forcing
those L positions.

**Speculative decoding** (``spec_k=``/``MXTPU_SERVE_SPEC_K`` with
``draft_params=``): each round a small draft LM proposes K tokens through
K+1 single-token passes, then one target verify body samples all K+1
positions with the same (seed, position) uniforms the single-token body
would have used, running, position by position, the same tensor ops at
the same shapes as the single-token body. Acceptance is exact prefix
matching, so the stream is token-identical to target-only decoding.

Every cache carries one trash row past ``max_len`` (``rows = max_len +
1``), which speculative windows past a retiring sequence's last position
write and no valid query attends. The JAX package adds it only to a
speculative loop; the port keeps it in every loop, so a speculative and a
plain loop run their token pass at the same shapes, and on the card the
same matrix-product kernels, which keeps their outputs equal bit for bit.
Float32 products run with cuBLAS's TF32 switch held off
(:func:`~mxnet_tpu_torch.ops.nn.matmul_precision`).

Fault sites: ``serve.decode_die`` at the top of every loop iteration,
``serve.sample`` before every sampled-decode dispatch,
``serve.spec_verify`` before each verify dispatch. A raising kind kills
the loop thread, which sheds every sequence in flight and queued with
:class:`ServingClosedError`.

``contexts=`` makes a model-parallel loop over a 'model' mesh of positions,
resolved as ``ServingEngine`` resolves it (an int N puts N positions on
``device``, a list one on each entry's torch device; positions may share
one). ``num_heads`` (and ``draft_num_heads``) must divide over the
positions. Each parameter leaf is laid out by the placement rule
(``quantize.place_leaf``: the first dimension the positions divide, an int8
scale along its payload's split); the KV caches split over heads, so each
position holds ``(layers, slots, heads / N, max_len + 1, head_dim)`` of K
and of V; the seeds are replicated, one copy a device. The token pass keeps
the residual stream replicated: each matrix product computes its output
slice per position from its weight's shard over the whole contraction,
and the slices are gathered; the qkv product's output is gathered whole,
each position takes its heads of Q, K and V, attends over its cache shard,
and the heads' outputs are gathered before ``attn_out``. No reduction
spans positions. Embedding rows are taken from the position holding them.
Layer norms, sampling and the other elementwise work of replicated values
run once a device. Prefix slabs are ``(layers, heads, rows, head_dim)``
split over heads, taken out and put back per position, and the
speculative verify body and the draft run sharded the same way.

:meth:`DecodeLoop.memory_report` prices the loop's programs under the JAX
package's names (the token pass ``step[slots=S,len=L]``, or with
speculation ``verify[slots=S,win=W]`` and ``draft[slots=S,len=L]``, and
with the prefix cache ``prefix_get[...]``/``prefix_put[...]`` for the
target and the draft) by :mod:`mxnet_tpu_torch.memcheck`'s shape-only dry
run over fake copies of the parameters, the slot vectors and the KV
caches; the live cache is never touched. ``MXTPU_MEMCHECK=warn|error``
audits them at construction, before the loop's thread starts, and
:meth:`DecodeLoop.priced` prices a loop without building it.

Each of those programs is registered with ``tracecheck`` under the same
name when the loop is built, and :meth:`DecodeLoop.check` audits them:
``tracecheck``'s static lints and, with ``memory=True``, the memory lints
over :meth:`memory_report` plus a ``resident-set`` lint over the set (the
draft and target co-residency under speculation), and with ``comms=True``
the communication lints over :meth:`DecodeLoop.comms_report` (each
program's collective inventory from ``commscheck``'s dry run: a sharded
loop's gathers along 'model' each token, none on one device).
``MXTPU_COMMSCHECK=warn|error`` audits those at construction too.
"""
from __future__ import annotations

import collections
import logging
import queue
import threading
import time

import numpy as np
import torch

from ..base import MXNetError, env_int, env_str
from ..obs import trace as _obs
from ..ops.attention import layer_norm
from ..ops.nn import matmul_precision
from ..parallel import mesh as _mesh
from ..tracecheck import unique_name
from .batcher import REQUEST_IDS, ServingClosedError, Settleable
from .engine import (_audit_load_comms, _audit_load_memory, _check,
                     _comms_reports, _dry_run, _model_mesh, _sync)
from .health import ServingHealth, SERVING_HEALTH
from .quantize import (_as_tensor, dequant_tree, is_quantized_leaf,
                       place_leaf, quantize_array, quantize_tree,
                       resolve_mode, tree_bytes)
from .sampling import position_uniforms, sample_rows, validate_sampling


def _build_token_pass(num_layers, num_heads):
    """One position a slot through every layer, reading and writing the
    (layers, slots, heads, rows, head_dim) KV cache in place; returns the
    logits. Matches ``models/transformer.py`` op for op (pre-LN blocks,
    qkv packing, 1/sqrt(d) scaling), so greedy decoding agrees with the
    full forward. The single-token body runs it once, the verify body
    once a window position, so a position computes the same ops either
    way. The write position is clamped to the last cache row (the trash
    row), and the embedding position to the last row of the positional
    table, as the JAX package's gather clamps it: a speculative window
    that starts within ``spec_k`` of ``max_len`` reaches positions past a
    ``max_len``-row table, whose samples are never committed."""

    def token_pass(ck, cv, params, tokens, pos):
        nslots = tokens.shape[0]
        rows = ck.shape[3]
        dev = tokens.device
        wpos = torch.clamp_max(pos, rows - 1)
        pos_table = params["pos_embed_weight"]
        x = (params["tok_embed_weight"][tokens]
             + pos_table[torch.clamp_max(wpos, pos_table.shape[0] - 1)])
        embed = x.shape[1]
        d = embed // num_heads
        scale = 1.0 / float(np.sqrt(d))
        sidx = torch.arange(nslots, device=dev)
        tmask = (torch.arange(rows, device=dev)[None, None, :]
                 <= pos[:, None, None])
        neg = torch.tensor(-1e30, dtype=torch.float32, device=dev)
        for i in range(num_layers):
            pre = "layer%d" % i
            a = layer_norm(x, params[pre + "_ln1_gamma"],
                           params[pre + "_ln1_beta"])
            qkv = (a @ params[pre + "_attn_qkv_weight"].t()
                   + params[pre + "_attn_qkv_bias"])
            qkv = qkv.reshape(nslots, 3, num_heads, d)
            q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]     # (slots, H, D)
            ck[i][sidx, :, wpos, :] = k
            cv[i][sidx, :, wpos, :] = v
            s = torch.einsum("shd,shtd->sht", q, ck[i]) * scale
            s = torch.where(tmask, s, neg)
            w = torch.softmax(s, dim=-1)
            o = torch.einsum("sht,shtd->shd", w, cv[i]).reshape(nslots,
                                                                embed)
            o = (o @ params[pre + "_attn_out_weight"].t()
                 + params[pre + "_attn_out_bias"])
            x = x + o
            f = layer_norm(x, params[pre + "_ln2_gamma"],
                           params[pre + "_ln2_beta"])
            f = torch.clamp_min(f @ params[pre + "_ffn_fc1_weight"].t()
                                + params[pre + "_ffn_fc1_bias"], 0.0)
            f = (f @ params[pre + "_ffn_fc2_weight"].t()
                 + params[pre + "_ffn_fc2_bias"])
            x = x + f
        x = layer_norm(x, params["final_ln_gamma"], params["final_ln_beta"])
        return x @ params["lm_head_weight"].t() + params["lm_head_bias"]

    return token_pass


class _Positions(object):
    """The positions of a 'model' mesh as the sharded bodies use them. A
    value is a :class:`~mxnet_tpu_torch.parallel.mesh.MeshArray`:
    replicated (one tensor a device, shared by the positions there) or
    split along 'model'. :meth:`rep` runs a function of replicated values
    once a device; :meth:`linear` and :meth:`rows` are the sharded
    weight's products and lookups."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.devs = mesh.replica_devices()

    def index(self, r):
        """Position ``r``'s index along 'model'."""
        return self.mesh.coords(r)[_mesh.AXIS_MODEL]

    def rep(self, fn, *vals):
        """``fn`` of replicated values (MeshArrays, or constants passed as
        they are) once on each device: a replicated MeshArray."""
        done, parts = {}, []
        for r, d in enumerate(self.devs):
            if d not in done:
                done[d] = fn(*[v.parts[r] if isinstance(v, _mesh.MeshArray)
                               else v for v in vals])
            parts.append(done[d])
        return _mesh.MeshArray(self.mesh, parts)

    def whole(self, v):
        """``v`` gathered whole on every position (counted)."""
        return _mesh.reshard(v, ())

    def linear(self, x, w, b):
        """``x @ w.T + b`` for replicated ``x``: with ``w`` split along its
        output dimension each position computes its slice over the whole
        contraction and the slices are gathered; otherwise ``w`` is
        gathered whole and the product runs once a device."""
        if w.spec[0] != _mesh.AXIS_MODEL or b.spec[0] != _mesh.AXIS_MODEL:
            return self.rep(lambda x_, w_, b_: x_ @ w_.t() + b_, x,
                            self.whole(w), self.whole(b))
        parts = [x.parts[r] @ w.parts[r].t() + b.parts[r]
                 for r in range(len(self.devs))]
        return self.whole(_mesh.MeshArray(self.mesh, parts,
                                          spec=(None, _mesh.AXIS_MODEL)))

    def rows(self, table, idx):
        """``table[idx]`` for replicated indices: where the table splits
        along its rows, each index takes its row from the position holding
        it (a select, no arithmetic; counted as one gather)."""
        if table.spec[0] != _mesh.AXIS_MODEL:
            return self.rep(lambda t, i: t[i], self.whole(table), idx)
        _mesh._count("all_gather")
        n = table.parts[0].shape[0]
        done, parts = {}, []
        for r, d in enumerate(self.devs):
            if d not in done:
                i = idx.parts[r]
                out = None
                for q, dq in enumerate(self.devs):
                    lo = self.index(q) * n
                    got = table.parts[q][torch.clamp(i.to(dq) - lo, 0, n - 1)]
                    got = got.to(d)
                    out = got if out is None else torch.where(
                        ((i >= lo) & (i < lo + n))[:, None], got, out)
                done[d] = out
            parts.append(done[d])
        # what moves is each index's row from the position holding it, not
        # the table
        _mesh._note("all-gather", _mesh._nbytes(parts[0]), len(self.devs),
                    (_mesh.AXIS_MODEL,), (), parts)
        return _mesh.MeshArray(self.mesh, parts)


def _build_sharded_token_pass(num_layers, num_heads, mesh):
    """The token pass of :func:`_build_token_pass` over a 'model' mesh
    (see the module's note), op for op the same on each value: ``ck`` and
    ``cv`` are MeshArrays split over heads, ``params`` MeshArrays laid out
    by the placement rule, ``tokens`` and ``pos`` replicated; returns the
    replicated logits."""
    ps = _Positions(mesh)
    hn = num_heads // len(ps.devs)

    def token_pass(ck, cv, params, tokens, pos):
        nslots = tokens.parts[0].shape[0]
        rows = ck.parts[0].shape[3]
        wpos = ps.rep(lambda p: torch.clamp_max(p, rows - 1), pos)
        pos_table = params["pos_embed_weight"]
        x = ps.rep(torch.add, ps.rows(params["tok_embed_weight"], tokens),
                   ps.rows(pos_table, ps.rep(
                       lambda w: torch.clamp_max(w, pos_table.shape[0] - 1),
                       wpos)))
        embed = x.parts[0].shape[1]
        d = embed // num_heads
        scale = 1.0 / float(np.sqrt(d))
        sidx = ps.rep(lambda t: torch.arange(nslots, device=t.device), x)
        tmask = ps.rep(lambda p: torch.arange(rows, device=p.device)[
            None, None, :] <= p[:, None, None], pos)
        neg = ps.rep(lambda t: torch.tensor(-1e30, dtype=torch.float32,
                                            device=t.device), x)

        def norm(v, pre):
            return ps.rep(layer_norm, v, ps.whole(params[pre + "_gamma"]),
                          ps.whole(params[pre + "_beta"]))

        for i in range(num_layers):
            pre = "layer%d" % i
            a = norm(x, pre + "_ln1")
            qkv = ps.linear(a, params[pre + "_attn_qkv_weight"],
                            params[pre + "_attn_qkv_bias"])
            heads = []
            for r in range(len(ps.devs)):
                hs = slice(ps.index(r) * hn, (ps.index(r) + 1) * hn)
                q5 = qkv.parts[r].reshape(nslots, 3, num_heads, d)
                q, k, v = q5[:, 0, hs], q5[:, 1, hs], q5[:, 2, hs]
                ck.parts[r][i][sidx.parts[r], :, wpos.parts[r], :] = k
                cv.parts[r][i][sidx.parts[r], :, wpos.parts[r], :] = v
                s_ = torch.einsum("shd,shtd->sht", q, ck.parts[r][i]) * scale
                s_ = torch.where(tmask.parts[r], s_, neg.parts[r])
                w = torch.softmax(s_, dim=-1)
                heads.append(torch.einsum("sht,shtd->shd", w,
                                          cv.parts[r][i]))
            o = ps.whole(_mesh.MeshArray(mesh, heads,
                                         spec=(None, _mesh.AXIS_MODEL)))
            o = ps.linear(ps.rep(lambda t: t.reshape(nslots, embed), o),
                          params[pre + "_attn_out_weight"],
                          params[pre + "_attn_out_bias"])
            x = ps.rep(torch.add, x, o)
            f = norm(x, pre + "_ln2")
            f = ps.rep(lambda t: torch.clamp_min(t, 0.0), ps.linear(
                f, params[pre + "_ffn_fc1_weight"],
                params[pre + "_ffn_fc1_bias"]))
            f = ps.linear(f, params[pre + "_ffn_fc2_weight"],
                          params[pre + "_ffn_fc2_bias"])
            x = ps.rep(torch.add, x, f)
        x = norm(x, "final_ln")
        return ps.linear(x, params["lm_head_weight"], params["lm_head_bias"])

    return ps, token_pass


def _build_decode_fn(num_layers, num_heads, mesh=None):
    """The single-token decode body: one position a slot, sampled on the
    device. Updates ``state`` in place and returns the ``(slots,)`` int32
    next tokens (position 0's, over a mesh, where the arguments are
    replicated MeshArrays)."""
    if mesh is not None:
        ps, token_pass = _build_sharded_token_pass(num_layers, num_heads,
                                                   mesh)

        def sharded_decode_fn(state, params, tokens, pos, temp, top_k,
                              top_p, fresh_seed, reseed):
            seeds = ps.rep(torch.where, reseed, fresh_seed, state["seed"])
            ps.rep(lambda cur, new: cur.copy_(new), state["seed"], seeds)
            logits = token_pass(state["k"], state["v"],
                                dequant_tree(params), tokens, pos)
            u = ps.rep(position_uniforms, seeds, pos)
            return ps.rep(sample_rows, logits, u, temp, top_k,
                          top_p).parts[0]

        return sharded_decode_fn
    token_pass = _build_token_pass(num_layers, num_heads)

    def decode_fn(state, params, tokens, pos, temp, top_k, top_p,
                  fresh_seed, reseed):
        seeds = torch.where(reseed, fresh_seed, state["seed"])
        state["seed"].copy_(seeds)
        logits = token_pass(state["k"], state["v"], dequant_tree(params),
                            tokens, pos)
        u = position_uniforms(seeds, pos)
        return sample_rows(logits, u, temp, top_k, top_p)

    return decode_fn


def _build_verify_fn(num_layers, num_heads, window, mesh=None):
    """The speculative verify body: ``window`` positions a slot through
    the same per-position pass as the single-token body, one after the
    other (position j attends the rows the positions before it wrote),
    each sampled with its own (seed, position) uniform. Returns the
    ``(slots, window)`` samples."""
    if mesh is not None:
        ps, token_pass = _build_sharded_token_pass(num_layers, num_heads,
                                                   mesh)

        def sharded_verify_fn(state, params, tokens_w, pos0, temp, top_k,
                              top_p, fresh_seed, reseed):
            seeds = ps.rep(torch.where, reseed, fresh_seed, state["seed"])
            ps.rep(lambda cur, new: cur.copy_(new), state["seed"], seeds)
            p = dequant_tree(params)
            outs = []
            for j in range(window):
                pos_j = ps.rep(lambda t, j=j: t + j, pos0)
                logits = token_pass(state["k"], state["v"], p, ps.rep(
                    lambda t, j=j: t[:, j], tokens_w), pos_j)
                u = ps.rep(position_uniforms, seeds, pos_j)
                outs.append(ps.rep(sample_rows, logits, u, temp, top_k,
                                   top_p).parts[0])
            return torch.stack(outs, dim=1)

        return sharded_verify_fn
    token_pass = _build_token_pass(num_layers, num_heads)

    def verify_fn(state, params, tokens_w, pos0, temp, top_k, top_p,
                  fresh_seed, reseed):
        seeds = torch.where(reseed, fresh_seed, state["seed"])
        state["seed"].copy_(seeds)
        p = dequant_tree(params)
        outs = []
        for j in range(window):
            pos_j = pos0 + j
            logits = token_pass(state["k"], state["v"], p, tokens_w[:, j],
                                pos_j)
            u = position_uniforms(seeds, pos_j)
            outs.append(sample_rows(logits, u, temp, top_k, top_p))
        return torch.stack(outs, dim=1)

    return verify_fn


def _build_extract_fn():
    """Prefix harvest: a copy of one slot's full KV slab (the rows past
    the prefix ride along; every consumer rewrites them before a query
    can attend them). Over a mesh each position copies its heads: the
    slab is ``(layers, heads, rows, head_dim)`` split over heads."""
    def extract_fn(state, slot):
        if isinstance(state["k"], _mesh.MeshArray):
            return {n: _mesh.MeshArray(
                state[n].mesh, [p[:, slot].clone() for p in state[n].parts],
                spec=(None, _mesh.AXIS_MODEL)) for n in ("k", "v")}
        return {"k": state["k"][:, slot].clone(),
                "v": state["v"][:, slot].clone()}

    return extract_fn


def _build_implant_fn():
    """Prefix reuse: copy a cached KV slab into one slot, in place (each
    position its heads, over a mesh); the seeds stay as they are."""
    def implant_fn(state, slot, pk, pv):
        if isinstance(state["k"], _mesh.MeshArray):
            for n, slab in (("k", pk), ("v", pv)):
                for p, src in zip(state[n].parts, slab.parts):
                    p[:, slot].copy_(src)
            return
        state["k"][:, slot].copy_(pk)
        state["v"][:, slot].copy_(pv)

    return implant_fn


def _host_f32(v):
    """Array-like, NDArray (of either package) or tensor -> a float32 CPU
    tensor."""
    return _as_tensor(v).detach().to("cpu", torch.float32)


class GenerateFuture(Settleable):
    """Handle for one in-flight sequence; :meth:`result` blocks. Rides
    the batcher's :class:`~mxnet_tpu_torch.serving.batcher.Settleable`
    protocol (first settle wins, ``on_done`` fires once after the event),
    so open-loop clients can drive ``generate`` as they drive ``infer``."""

    __slots__ = ("prompt", "max_new", "_loop", "rid", "temperature",
                 "top_k", "top_p", "seed", "prefix_len")

    def __init__(self, loop, prompt, max_new, temperature=0.0, top_k=0,
                 top_p=1.0, seed=None, prefix_len=0, on_done=None):
        super().__init__(on_done=on_done)
        self.prompt = list(prompt)
        self.max_new = int(max_new)
        self._loop = loop
        #: serving correlation id, from the batcher's process-wide sequence
        self.rid = next(REQUEST_IDS)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        #: RNG stream id: an unseeded request draws its stream from its rid
        #: (distinct across requests); pass ``seed=`` to replay a stream
        self.seed = int(self.rid if seed is None else seed) & 0x7FFFFFFF
        self.prefix_len = int(prefix_len)

    @property
    def tokens(self):
        return self.value

    def result(self, timeout=None):
        deadline = None if timeout is None else time.monotonic() + timeout
        while not self.event.wait(0.05):
            # a future enqueued in the generate()/close() race window is on
            # a queue nothing will drain: fail it here rather than spin
            stopped = (self._loop.dead is not None or self._loop._closed
                       or not self._loop._thread.is_alive())
            if stopped and not self.done():
                self.fail(ServingClosedError(
                    "decode loop died with the sequence in flight: %s"
                    % (self._loop.dead,)
                    if self._loop.dead is not None else
                    "decode loop closed with the sequence unserved"))
                break
            if deadline is not None and time.monotonic() > deadline:
                raise MXNetError("generate: timed out after %.1fs"
                                 % timeout)
        if self.error is not None:
            raise self.error
        return self.value


class _Slot(object):
    __slots__ = ("fut", "pending", "pos", "next_token", "emitted",
                 "reseed", "producing")

    def __init__(self, fut):
        self.fut = fut
        self.pending = list(fut.prompt)   # prompt tokens still to feed
        self.pos = 0                      # next cache write position
        self.next_token = self.pending.pop(0)
        self.emitted = []
        self.reseed = True                # seed lands in-state next step
        self.producing = None             # (key, L): harvest prefix at L


class DecodeLoop(object):
    """Slot-scheduled continuous decoding over a transformer-LM parameter
    set (``models/transformer.py`` naming: ``tok_embed_weight``,
    ``layer{i}_...``, ``final_ln_*``, ``lm_head_*``), on ``device``
    (default ``cuda:0``; ``device="cpu"`` serves on the CPU).

    ``generate(prompt, max_new_tokens, temperature=..., top_k=...,
    top_p=..., seed=..., prefix_len=...)`` returns a
    :class:`GenerateFuture`; sequences join a free slot as soon as one
    retires.

    Decode knobs resolve arg > ``MXTPU_SERVE_*`` env > tuning DB >
    default: ``spec_k`` (0 = off; needs ``draft_params``),
    ``prefix_cache`` (default on), ``quantize`` (default ``"none"``).
    """

    def __init__(self, params, num_layers, num_heads, max_len, slots=4,
                 eos_id=None, health=None, name=None, contexts=None,
                 quantize=None, prefix_cache=None, spec_k=None,
                 draft_params=None, draft_num_layers=None,
                 draft_num_heads=None, device=None):
        #: the 'model' mesh the loop spans (None: one device)
        self._mesh, self.device = _model_mesh(contexts, device,
                                              "DecodeLoop")
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self._check_heads(self.num_heads, "num_heads")
        self.max_len = int(max_len)
        self.slots = int(slots)
        self.eos_id = eos_id
        self.health = health or ServingHealth(parent=SERVING_HEALTH)

        host_params = {k: _host_f32(v) for k, v in params.items()}
        for need in ("tok_embed_weight", "pos_embed_weight",
                     "final_ln_gamma", "lm_head_weight", "lm_head_bias"):
            if need not in host_params:
                raise MXNetError(
                    "DecodeLoop: params missing %r — expected the "
                    "models/transformer.py parameter naming" % need)
        vocab, embed = host_params["tok_embed_weight"].shape
        if embed % self.num_heads:
            raise MXNetError("DecodeLoop: embed %d %% num_heads %d != 0"
                             % (embed, self.num_heads))
        # a position past the embedding table would gather out of range:
        # fail at construction instead
        pos_rows = int(host_params["pos_embed_weight"].shape[0])
        if self.max_len > pos_rows:
            raise MXNetError(
                "DecodeLoop: max_len %d exceeds the positional embedding "
                "table (%d rows) — positions past it would be silently "
                "clamped" % (self.max_len, pos_rows))
        self.vocab_size = int(vocab)
        head_dim = embed // self.num_heads

        self._resolve_knobs(host_params, quantize, prefix_cache, spec_k,
                            draft_params)
        self.prefix_max = env_int("MXTPU_SERVE_PREFIX_MAX", 8)
        self._params = self._place(quantize_tree(host_params,
                                                 self.quant_mode))

        # --- draft model (speculative decoding only) ------------------
        self._draft_params = None
        self.draft_num_layers = self.draft_num_heads = 0
        if self.spec_k:
            dhost = {k: _host_f32(v) for k, v in draft_params.items()}
            if draft_num_layers is None:
                ids = [int(k[5:k.index("_", 5)]) for k in dhost
                       if k.startswith("layer")]
                draft_num_layers = max(ids) + 1 if ids else 0
            self.draft_num_layers = int(draft_num_layers)
            self.draft_num_heads = int(draft_num_heads or self.num_heads)
            self._check_heads(self.draft_num_heads, "draft_num_heads")
            if self.draft_num_layers <= 0:
                raise MXNetError(
                    "DecodeLoop: draft_params has no layer{i}_* entries")
            for need in ("tok_embed_weight", "pos_embed_weight",
                         "final_ln_gamma", "lm_head_weight"):
                if need not in dhost:
                    raise MXNetError(
                        "DecodeLoop: draft_params missing %r" % need)
            dvocab, dembed = dhost["tok_embed_weight"].shape
            if int(dvocab) != self.vocab_size:
                raise MXNetError(
                    "DecodeLoop: draft vocab %d != target vocab %d — "
                    "draft proposals must be target token ids"
                    % (dvocab, self.vocab_size))
            if dembed % self.draft_num_heads:
                raise MXNetError(
                    "DecodeLoop: draft embed %d %% draft_num_heads %d "
                    "!= 0" % (dembed, self.draft_num_heads))
            if self.max_len > int(dhost["pos_embed_weight"].shape[0]):
                raise MXNetError(
                    "DecodeLoop: max_len %d exceeds the DRAFT positional "
                    "embedding table (%d rows)"
                    % (self.max_len, dhost["pos_embed_weight"].shape[0]))
            self._draft_params = self._place(quantize_tree(
                dhost, self.quant_mode))

        # --- device state: KV cache(s) + per-slot seeds ---------------
        self._rows = self.max_len + 1
        self._state = self._init_state(self.num_layers, self.num_heads,
                                       head_dim)
        self._draft_state = None
        if self.spec_k:
            self._draft_state = self._init_state(
                self.draft_num_layers, self.draft_num_heads,
                int(dhost["tok_embed_weight"].shape[1])
                // self.draft_num_heads)

        self.name = unique_name(name or "serving-decode")
        if self.spec_k:
            self._verify_fn = _build_verify_fn(
                self.num_layers, self.num_heads, self.spec_k + 1,
                self._mesh)
            self._draft_fn = _build_decode_fn(self.draft_num_layers,
                                              self.draft_num_heads,
                                              self._mesh)
        else:
            self._step_fn = _build_decode_fn(self.num_layers,
                                             self.num_heads, self._mesh)
        self._extract_fn = _build_extract_fn()
        self._implant_fn = _build_implant_fn()
        if _dry_run():
            return
        # MXTPU_MEMCHECK: price the program set before the thread starts;
        # MXTPU_COMMSCHECK: audit its collectives (a sharded loop's)
        _audit_load_memory(self, "DecodeLoop")
        _audit_load_comms(self, "DecodeLoop")
        # the static analyzer's registry holds each program weakly: the
        # loop keeps them
        from .. import tracecheck as _tc
        self._tc_programs = []
        for pname, fn, args, donate in self._program_set():
            self._tc_programs.append(fn)
            _tc.register_program(pname, fn, args, donate_argnums=donate)

        #: device-resident prefix registry: key (the prefix token tuple)
        #: -> {"len", "target": {k,v}, "draft": {k,v}|None}, LRU-bounded
        self._prefix = collections.OrderedDict()
        self._join_q = queue.Queue()
        self._slots = [None] * self.slots
        self._closed = False
        self.dead = None
        self._steps = 0   # decode-step ordinal for the host trace
        self._wake = threading.Event()
        self._thread = threading.Thread(target=self._run,
                                        name="mxtpu-serve-decode",
                                        daemon=True)
        self._thread.start()

    @classmethod
    def priced(cls, *args, top=8, **kwargs):
        """:meth:`memory_report` of the loop ``DecodeLoop(*args,
        **kwargs)`` would build, without building it: the constructor runs
        inside a ``FakeTensorMode`` (parameters and caches fake, nothing
        allocated on the device), and a loop built there skips its load
        audit and never starts its thread."""
        from ..memcheck import fake_mode, new_fake_mode
        with fake_mode(new_fake_mode(allow_non_fake_inputs=True)):
            loop = cls(*args, **kwargs)
        return loop.memory_report(top=top)

    # ------------------------------------------------------------------
    def _resolve_knobs(self, host_params, quantize, prefix_cache, spec_k,
                       draft_params):
        """arg > MXTPU_SERVE_* env > tuning DB > default. A DB-resolved
        ``spec_k`` without a draft model falls back with a warning (a
        stale DB row must not break a deploy); an arg/env one raises."""
        self.quant_mode = resolve_mode(
            quantize if quantize is not None
            else env_str("MXTPU_SERVE_QUANT", "none"))

        db = {}
        if spec_k is None and not env_str("MXTPU_SERVE_SPEC_K") \
                or prefix_cache is None \
                and not env_str("MXTPU_SERVE_PREFIX_CACHE"):
            from .. import autotune as _at
            db = _at.resolve_decode_knobs(host_params,
                                          device=self.device) or {}

        src = "default"
        if spec_k is not None:
            self.spec_k, src = int(spec_k), "arg"
        elif env_str("MXTPU_SERVE_SPEC_K"):
            self.spec_k, src = env_int("MXTPU_SERVE_SPEC_K", 0), "env"
        elif "spec_k" in db:
            self.spec_k, src = int(db["spec_k"]), "db"
        else:
            self.spec_k = 0
        if self.spec_k < 0:
            raise MXNetError("DecodeLoop: spec_k must be >= 0, got %d"
                             % self.spec_k)
        if self.spec_k and draft_params is None:
            if src == "db":
                logging.warning(
                    "DecodeLoop: tuning DB resolved spec_k=%d but no "
                    "draft_params were given — speculative decoding "
                    "disabled", self.spec_k)
                self.spec_k = 0
            else:
                raise MXNetError(
                    "DecodeLoop: spec_k=%d (%s) needs draft_params — "
                    "speculative decoding drafts through a small "
                    "co-resident model" % (self.spec_k, src))

        if prefix_cache is not None:
            self.prefix_enabled = bool(prefix_cache)
        elif env_str("MXTPU_SERVE_PREFIX_CACHE"):
            self.prefix_enabled = env_str("MXTPU_SERVE_PREFIX_CACHE") \
                .lower() not in ("0", "false", "off", "no")
        elif "prefix_cache" in db:
            self.prefix_enabled = bool(int(db["prefix_cache"]))
        else:
            self.prefix_enabled = True

    def _check_heads(self, heads, what):
        """A sharded loop splits the KV cache over heads: ``heads`` must
        divide over the positions."""
        n = 1 if self._mesh is None else len(self._mesh.replica_devices())
        if heads % n:
            raise MXNetError(
                "DecodeLoop: %s %d %% %d model positions != 0 — the KV "
                "cache shards over heads" % (what, heads, n))

    def _place(self, tree):
        """A stored parameter tree (tensors or int8 ``{"q","s"}`` pairs)
        moved to the loop's device, or laid out over its mesh by the
        placement rule."""
        if self._mesh is not None:
            return {k: place_leaf(v, self._mesh) for k, v in tree.items()}
        return {k: ({n: t.to(self.device) for n, t in v.items()}
                    if is_quantized_leaf(v) else v.to(self.device))
                for k, v in tree.items()}

    def _init_state(self, layers, heads, head_dim):
        if self._mesh is not None:
            devs = self._mesh.replica_devices()
            local = (layers, self.slots, heads // len(devs), self._rows,
                     head_dim)
            return {n: _mesh.MeshArray(
                self._mesh, [torch.zeros(local, dtype=torch.float32,
                                         device=d) for d in devs],
                spec=(None, None, _mesh.AXIS_MODEL)) for n in ("k", "v")} \
                | {"seed": self._vec(np.zeros(self.slots), torch.int64)}
        cache_shape = (layers, self.slots, heads, self._rows, head_dim)
        return {"k": torch.zeros(cache_shape, dtype=torch.float32,
                                 device=self.device),
                "v": torch.zeros(cache_shape, dtype=torch.float32,
                                 device=self.device),
                "seed": torch.zeros((self.slots,), dtype=torch.int64,
                                    device=self.device)}

    def _vec(self, arr, dtype):
        """A host array on the device, or replicated over the mesh (one
        copy a device)."""
        t = torch.as_tensor(np.asarray(arr), dtype=dtype)
        if self._mesh is not None:
            return _mesh.split_spec(t, self._mesh, ())
        return t.to(self.device)

    def _dev(self, a):
        """The step's host-side slot vectors on the device: ids, positions
        and top-k as int64, temperatures and top-p as float32, seeds as
        int64, the reseed marks as bool."""
        dt = {"tokens": torch.int64, "pos": torch.int64,
              "temp": torch.float32, "top_k": torch.int64,
              "top_p": torch.float32, "fresh": torch.int64,
              "reseed": torch.bool}
        return {k: self._vec(v, dt[k]) for k, v in a.items()}

    # ------------------------------------------------------------------
    def weight_bytes(self):
        """Resident device bytes of the (possibly quantized) parameter
        set(s), target plus draft, from dtypes and shapes (global across a
        sharded loop's positions)."""
        total = tree_bytes(self._params)
        if self._draft_params is not None:
            total += tree_bytes(self._draft_params)
        return total

    # ------------------------------------------------------------------
    def update_params(self, params):
        """Hot-reload the TARGET parameter set under the running loop: the
        decode body reads the parameter dict once a step, so swapping it
        re-binds the next step's weights. A quantized loop re-quantizes
        the incoming float32 checkpoint on the host first. (The draft
        model is fixed at construction.)

        Every resident parameter must arrive with its exact shape. The new
        arrays land on the device before one assignment swaps the dict, so
        in-flight sequences continue on a consistent parameter set (their
        KV cache keeps prefix entries from the old weights: retire slots
        first for a clean cut)."""
        missing = sorted(set(self._params) - set(params))
        if missing:
            raise MXNetError(
                "update_params: checkpoint is missing %s — a partial swap "
                "would decode a chimera; pass the full "
                "models/transformer.py parameter set"
                % ", ".join(missing[:8]))
        new = {}
        for n, resident in self._params.items():
            arr = _host_f32(params[n])
            rq = resident["q"] if is_quantized_leaf(resident) else resident
            if tuple(arr.shape) != tuple(rq.shape):
                raise MXNetError(
                    "update_params: %r shape %s does not match the "
                    "decode body's %s — rebuild the loop for a different "
                    "architecture"
                    % (n, tuple(arr.shape), tuple(rq.shape)))
            new[n] = quantize_array(arr, self.quant_mode)
        new = self._place(new)
        # land the copies before the swap: a step dispatched the instant
        # after it must never read a half-copied weight
        _sync(self._mesh, self.device)
        self._params = new
        from ..obs import REGISTRY
        REGISTRY.counter(
            "serving.param_reloads",
            "parameter hot-reloads into live serving engines").inc()
        _obs.instant("decode_param_reload", params=len(new))
        logging.info("%s: hot-reloaded %d parameters (quantize=%s)",
                     self.name, len(new), self.quant_mode)

    # ------------------------------------------------------------------
    def generate(self, prompt, max_new_tokens, temperature=0.0, top_k=0,
                 top_p=1.0, seed=None, prefix_len=0):
        """Queue one sequence; returns a :class:`GenerateFuture` whose
        ``result()`` is the list of generated token ids.

        ``temperature=0`` (the default) is bitwise greedy decoding;
        ``temperature>0`` samples through top-k/top-p/inverse-CDF on the
        device, fixed by ``seed``. ``prefix_len=L`` declares ``prompt[:L]``
        a shared prefix for the KV prefix cache (first use prefills and
        stores it; later joins implant the cached slab and skip those L
        steps)."""
        if self.dead is not None or self._closed:
            raise ServingClosedError(
                "decode loop is not running (%s)"
                % (self.dead or "closed"))
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        if not prompt:
            raise MXNetError("generate: empty prompt")
        bad = [t for t in prompt if t < 0 or t >= self.vocab_size]
        if bad:
            raise MXNetError(
                "generate: prompt token id(s) %s outside the vocabulary "
                "[0, %d)" % (bad[:5], self.vocab_size))
        if len(prompt) + int(max_new_tokens) > self.max_len:
            raise MXNetError(
                "generate: prompt (%d) + max_new_tokens (%d) exceeds the "
                "cache length %d" % (len(prompt), max_new_tokens,
                                     self.max_len))
        temperature, top_k, top_p = validate_sampling(
            temperature, top_k, top_p)
        prefix_len = int(prefix_len)
        if prefix_len < 0 or prefix_len >= len(prompt):
            raise MXNetError(
                "generate: prefix_len %d must be in [0, len(prompt)=%d) — "
                "at least one prompt token must follow the shared prefix"
                % (prefix_len, len(prompt)))
        fut = GenerateFuture(self, prompt, max_new_tokens,
                             temperature=temperature, top_k=top_k,
                             top_p=top_p, seed=seed, prefix_len=prefix_len)
        self._join_q.put(fut)
        self._wake.set()
        _obs.instant("decode_submit", req=fut.rid, prompt_len=len(prompt),
                     max_new=int(max_new_tokens))
        self.health.record_request()
        return fut

    def close(self):
        self._closed = True
        self._wake.set()
        if self._thread.is_alive():
            self._thread.join(timeout=5.0)
        self._shed(ServingClosedError("decode loop closed"))

    # ------------------------------------------------------------------
    def _shed(self, exc):
        shed = 0
        for i, slot in enumerate(self._slots):
            if slot is not None:
                slot.fut.fail(exc)
                self._slots[i] = None
                shed += 1
        while True:
            try:
                fut = self._join_q.get_nowait()
                fut.fail(exc)
                shed += 1
            except queue.Empty:
                break
        if shed:
            self.health.record_shed(shed, exc)

    def _admit(self):
        for i in range(self.slots):
            if self._slots[i] is not None:
                continue
            try:
                fut = self._join_q.get_nowait()
            except queue.Empty:
                return
            slot = _Slot(fut)
            self._slots[i] = slot
            if self.prefix_enabled and fut.prefix_len > 0:
                key = tuple(fut.prompt[:fut.prefix_len])
                entry = self._prefix.get(key)
                if entry is not None:
                    self._prefix.move_to_end(key)
                    self._implant_slot(i, entry)
                    slot.pos = entry["len"]
                    slot.pending = list(fut.prompt[entry["len"]:])
                    slot.next_token = slot.pending.pop(0)
                    self.health.record_prefix_hit()
                    _obs.instant("decode_prefix_hit", req=fut.rid, slot=i,
                                 plen=entry["len"])
                else:
                    slot.producing = (key, fut.prefix_len)
            _obs.instant("decode_join", req=fut.rid, slot=i)
            self.health.record_join()

    def _implant_slot(self, i, entry):
        t = entry["target"]
        self._implant_fn(self._state, i, t["k"], t["v"])
        if self.spec_k and entry["draft"] is not None:
            d = entry["draft"]
            self._implant_fn(self._draft_state, i, d["k"], d["v"])

    def _maybe_harvest(self, i):
        """Prefix-cache producer path: once this slot has teacher-forced
        past its declared prefix, copy the slab out and publish it."""
        slot = self._slots[i]
        if slot is None or slot.producing is None:
            return
        key, plen = slot.producing
        if slot.pos < plen:
            return
        slot.producing = None
        if key in self._prefix:        # a co-rider raced us to it
            self._prefix.move_to_end(key)
            return
        entry = {"len": plen, "target": self._extract_fn(self._state, i),
                 "draft": None}
        if self.spec_k:
            entry["draft"] = self._extract_fn(self._draft_state, i)
        self._prefix[key] = entry
        while len(self._prefix) > self.prefix_max:
            self._prefix.popitem(last=False)   # LRU eviction
        self.health.record_prefix_prefill()
        _obs.instant("decode_prefix_store", slot=i, plen=plen)

    def _run(self):
        from .. import faults as _faults
        try:
            while not self._closed:
                with torch.inference_mode():
                    self._admit()
                if all(s is None for s in self._slots):
                    self._wake.wait(timeout=0.05)
                    self._wake.clear()
                    continue
                act = _faults.fire("serve.decode_die")
                if act == "die":
                    raise MXNetError(
                        "injected decode-loop death (serve.decode_die)")
                with torch.inference_mode(), matmul_precision(self.device):
                    self._step()
        except BaseException as e:   # shed, then die visibly
            self.dead = e
            self._shed(ServingClosedError(
                "decode loop died: %r — request shed" % (e,)))
            # post-mortem before the thread exits; dump() never raises
            # into this failure path
            from ..obs import flight as _flight
            _flight.dump("decode loop died: %r" % (e,),
                         extra={"health": self.health.report()})

    def _step(self):
        self._steps += 1
        with _obs.span("decode_step", step=self._steps,
                       reqs=[s.fut.rid for s in self._slots
                             if s is not None]):
            if self.spec_k:
                self._step_spec()
            else:
                self._step_inner()

    def _gather_sampling(self):
        """Host-side per-slot dispatch arrays (and consume reseed marks)."""
        n = self.slots
        arrs = {"tokens": np.zeros(n, np.int64),
                "pos": np.zeros(n, np.int64),
                "temp": np.zeros(n, np.float32),
                "top_k": np.zeros(n, np.int64),
                "top_p": np.ones(n, np.float32),
                "fresh": np.zeros(n, np.int64),
                "reseed": np.zeros(n, np.bool_)}
        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            arrs["tokens"][i] = slot.next_token
            arrs["pos"][i] = slot.pos
            arrs["temp"][i] = slot.fut.temperature
            arrs["top_k"][i] = slot.fut.top_k
            arrs["top_p"][i] = slot.fut.top_p
            if slot.reseed:
                arrs["fresh"][i] = slot.fut.seed
                arrs["reseed"][i] = True
                slot.reseed = False
        return arrs

    def _step_inner(self):
        from .. import faults as _faults
        a = self._gather_sampling()
        _faults.fire("serve.sample")
        d = self._dev(a)
        toks = self._step_fn(self._state, self._params, d["tokens"],
                             d["pos"], d["temp"], d["top_k"], d["top_p"],
                             d["fresh"], d["reseed"])
        host_toks = toks.cpu().numpy()   # the one per-step readback
        self.health.record_decode_step()
        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            slot.pos += 1
            if slot.pending:
                # prompt still feeding: next input is teacher-forced
                slot.next_token = slot.pending.pop(0)
            else:
                tok = int(host_toks[i])
                slot.emitted.append(tok)
                slot.next_token = tok
                if (len(slot.emitted) >= slot.fut.max_new
                        or (self.eos_id is not None and tok == self.eos_id)):
                    self._retire(i)
                    continue
            if slot.pos >= self.max_len:
                self._retire(i)
                continue
            self._maybe_harvest(i)

    def _step_spec(self):
        """One draft-K-then-verify round: K+1 draft passes chain the
        proposals (teacher-forced wherever the prompt already knows the
        token, so the draft cache stays position-synced), then one verify
        body samples every window position; the host replays the window
        through the single-token accounting, committing samples until the
        first mismatch with the window's inputs."""
        from .. import faults as _faults
        window = self.spec_k + 1
        a = self._gather_sampling()
        w = np.zeros((self.slots, window), np.int64)
        w[:, 0] = a["tokens"]
        dfill = np.zeros((self.slots, window), np.bool_)
        pend0 = [list(s.pending) if s is not None else []
                 for s in self._slots]
        _faults.fire("serve.sample")
        d = self._dev(a)
        if self._mesh is None:
            no_reseed = torch.zeros_like(d["reseed"])
        else:
            no_reseed = self._vec(np.zeros(self.slots, np.bool_),
                                  torch.bool)
        for j in range(window):
            if self._mesh is None:
                pos_j = d["pos"] + j
            else:
                pos_j = self._vec(a["pos"] + j, torch.int64)
            d_toks = self._draft_fn(
                self._draft_state, self._draft_params,
                self._vec(w[:, j], torch.int64), pos_j,
                d["temp"], d["top_k"], d["top_p"], d["fresh"],
                d["reseed"] if j == 0 else no_reseed)
            if j + 1 >= window:
                break
            d_host = d_toks.cpu().numpy()
            for i, slot in enumerate(self._slots):
                if slot is None:
                    continue
                if j < len(pend0[i]):
                    w[i, j + 1] = pend0[i][j]     # prompt knows this one
                else:
                    w[i, j + 1] = d_host[i]       # draft proposal
                    dfill[i, j + 1] = True
        _faults.fire("serve.spec_verify")
        samples = self._verify_fn(
            self._state, self._params,
            self._vec(w, torch.int64), d["pos"], d["temp"],
            d["top_k"], d["top_p"], d["fresh"], d["reseed"])
        s = samples.cpu().numpy()        # (slots, window) int32
        self.health.record_decode_step()
        accepted = judged = 0
        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            for j in range(window):
                slot.pos += 1
                if slot.pending:
                    nxt = slot.pending.pop(0)
                else:
                    tok = int(s[i, j])
                    slot.emitted.append(tok)
                    nxt = tok
                    if (len(slot.emitted) >= slot.fut.max_new
                            or (self.eos_id is not None
                                and tok == self.eos_id)):
                        self._retire(i)
                        break
                if slot.pos >= self.max_len:
                    self._retire(i)
                    break
                if j + 1 >= window:
                    slot.next_token = nxt
                    break
                if nxt != int(w[i, j + 1]):
                    # the window left the committed stream: rows past
                    # slot.pos hold speculative values the next round
                    # rewrites before any query can attend them
                    if dfill[i, j + 1]:
                        judged += 1    # a proposal the target rejected
                    slot.next_token = nxt
                    break
                if dfill[i, j + 1]:
                    judged += 1
                    accepted += 1      # a proposal the target confirmed
            if self._slots[i] is not None:
                self._maybe_harvest(i)
        # only proposals the target ruled on count: positions a retire or
        # length break left unverified would deflate the acceptance rate
        self.health.record_spec_round(judged, accepted)

    def _retire(self, i):
        slot = self._slots[i]
        self._slots[i] = None
        slot.fut.fulfill(list(slot.emitted))
        _obs.instant("decode_retire", req=slot.fut.rid, slot=i,
                     emitted=len(slot.emitted))
        self.health.record_retire()

    # ------------------------------------------------------------------
    def memory_report(self, top=8):
        """Static memory profile of every program of the loop:
        ``{program_name: MemoryReport}`` (see the module's note), each
        priced by ``memcheck.analyze`` over fake copies of the parameters,
        the caches (donated: updated in place) and a step's slot vectors.
        Nothing runs on the device and the live cache is never touched; a
        sharded loop's reports count every position's bytes."""
        from .. import memcheck as _mc
        return dict(sorted(
            (pname, _mc.analyze(fn, args, donate_argnums=donate, name=pname,
                                top=top))
            for pname, fn, args, donate in self._program_set()))

    def _program_set(self):
        """``(name, fn, args, donate_argnums)`` of every program of the
        loop (the JAX package's names), ``args`` fake copies of the
        parameters and caches and a step's slot vectors."""
        from .. import memcheck as _mc
        with _mc.fake_mode(like=self._params) as mode:
            state = _mc.fake_tree(self._state, mode)
            params = _mc.fake_tree(self._params, mode)
            n = self.slots
            samp = tuple(self._vec(np.zeros(n), dt) for dt in (
                torch.int64, torch.int64, torch.float32, torch.int64,
                torch.float32, torch.int64, torch.bool))
            if self.spec_k:
                dstate = _mc.fake_tree(self._draft_state, mode)
                dparams = _mc.fake_tree(self._draft_params, mode)
                window = self.spec_k + 1
                tokw = self._vec(np.zeros((n, window)), torch.int64)
            slabs = {"target": self._extract_fn(state, 0)}
            if self.spec_k:
                slabs["draft"] = self._extract_fn(dstate, 0)

        def in_loop(fn):
            def run(*a):
                with torch.inference_mode(), matmul_precision(self.device):
                    return fn(*a)
            return run

        programs = []
        if self.spec_k:
            programs += [
                ("verify[slots=%d,win=%d]" % (n, window), self._verify_fn,
                 (state, params, tokw) + samp[1:], (0,)),
                ("draft[slots=%d,len=%d]" % (n, self.max_len),
                 self._draft_fn, (dstate, dparams) + samp, (0,))]
        else:
            programs.append(("step[slots=%d,len=%d]" % (n, self.max_len),
                             self._step_fn, (state, params) + samp, (0,)))
        if self.prefix_enabled:
            for which, st in (("target", state),) + (
                    (("draft", dstate),) if self.spec_k else ()):
                slab = slabs[which]
                programs += [
                    ("prefix_get[%s]" % which, self._extract_fn, (st, 0),
                     ()),
                    ("prefix_put[%s]" % which, self._implant_fn,
                     (st, 0, slab["k"], slab["v"]), (0,))]
        return [("%s/%s" % (self.name, tag), in_loop(fn), args, donate)
                for tag, fn, args, donate in programs]

    def comms_report(self):
        """Static collective inventory of every program of the loop
        (``{program_name: CommsReport}``, the names of
        :meth:`memory_report`): a sharded loop's bill a token along
        'model' over separate cards; zero collectives on one device. Each
        from one shape-only dry run over fake copies of the parameters and
        caches; nothing runs on the device."""
        return _comms_reports(self, [(pname, fn, args) for pname, fn, args,
                                     _ in self._program_set()])

    def check(self, const_bytes=None, memory=False, budget=None,
              comms=False, min_eff=0.0):
        """Static-analyze the loop's registered programs; returns the
        findings: ``tracecheck``'s lints; with ``memory=True`` the memory
        lints over every program plus the ``resident-set`` lint over the
        set (with speculation, the draft and target co-residency); with
        ``comms=True`` the communication lints over :meth:`comms_report`
        at the ``min_eff`` floor (0 by default, as the engine's)."""
        return _check(self, const_bytes, memory, budget, comms, min_eff)
