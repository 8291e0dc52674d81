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

Not ported: ``contexts=`` with more than one device (a model-parallel
loop, ROADMAP.md A.7c) and the static audits ``memory_report``,
``comms_report`` and ``check`` (ROADMAP.md A.12); they raise.
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
from ..context import resolve_device
from ..obs import trace as _obs
from ..ops.attention import layer_norm
from ..ops.nn import matmul_precision
from ..tracecheck import unique_name
from .batcher import REQUEST_IDS, ServingClosedError, Settleable
from .engine import _not_ported
from .health import ServingHealth, SERVING_HEALTH
from .quantize import (_as_tensor, dequant_tree, is_quantized_leaf,
                       quantize_array, quantize_tree, resolve_mode,
                       tree_bytes)
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


def _build_decode_fn(num_layers, num_heads):
    """The single-token decode body: one position a slot, sampled on the
    device. Updates ``state`` in place and returns the ``(slots,)`` int32
    next tokens."""
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


def _build_verify_fn(num_layers, num_heads, window):
    """The speculative verify body: ``window`` positions a slot through
    the same per-position pass as the single-token body, one after the
    other (position j attends the rows the positions before it wrote),
    each sampled with its own (seed, position) uniform. Returns the
    ``(slots, window)`` samples."""
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
    can attend them)."""
    def extract_fn(state, slot):
        return {"k": state["k"][:, slot].clone(),
                "v": state["v"][:, slot].clone()}

    return extract_fn


def _build_implant_fn():
    """Prefix reuse: copy a cached KV slab into one slot, in place; the
    seeds stay as they are."""
    def implant_fn(state, slot, pk, pv):
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
        ncontexts = (contexts if isinstance(contexts, int)
                     else len(contexts or ()))
        if ncontexts > 1:
            raise MXNetError("DecodeLoop: contexts= (a model-parallel loop "
                             "across cards) is not ported yet (ROADMAP.md "
                             "A.7c)")
        self.device = resolve_device(device, "DecodeLoop")
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
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
                self.num_layers, self.num_heads, self.spec_k + 1)
            self._draft_fn = _build_decode_fn(self.draft_num_layers,
                                              self.draft_num_heads)
        else:
            self._step_fn = _build_decode_fn(self.num_layers,
                                             self.num_heads)
        self._extract_fn = _build_extract_fn()
        self._implant_fn = _build_implant_fn()

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

    def _place(self, tree):
        """A stored parameter tree (tensors or int8 ``{"q","s"}`` pairs)
        moved to the loop's device."""
        return {k: ({n: t.to(self.device) for n, t in v.items()}
                    if is_quantized_leaf(v) else v.to(self.device))
                for k, v in tree.items()}

    def _init_state(self, layers, heads, head_dim):
        cache_shape = (layers, self.slots, heads, self._rows, head_dim)
        return {"k": torch.zeros(cache_shape, dtype=torch.float32,
                                 device=self.device),
                "v": torch.zeros(cache_shape, dtype=torch.float32,
                                 device=self.device),
                "seed": torch.zeros((self.slots,), dtype=torch.int64,
                                    device=self.device)}

    def _dev(self, a):
        """The step's host-side slot vectors on the device: ids, positions
        and top-k as int64, temperatures and top-p as float32, seeds as
        int64, the reseed marks as bool."""
        dt = {"tokens": torch.int64, "pos": torch.int64,
              "temp": torch.float32, "top_k": torch.int64,
              "top_p": torch.float32, "fresh": torch.int64,
              "reseed": torch.bool}
        return {k: torch.as_tensor(np.asarray(v), dtype=dt[k],
                                   device=self.device)
                for k, v in a.items()}

    # ------------------------------------------------------------------
    def weight_bytes(self):
        """Resident device bytes of the (possibly quantized) parameter
        set(s), target plus draft, from dtypes and shapes."""
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
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
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
        no_reseed = torch.zeros_like(d["reseed"])
        for j in range(window):
            d_toks = self._draft_fn(
                self._draft_state, self._draft_params,
                torch.as_tensor(w[:, j], device=self.device), d["pos"] + j,
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
            torch.as_tensor(w, device=self.device), d["pos"], d["temp"],
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
        raise _not_ported("memory_report", "DecodeLoop")

    def comms_report(self):
        raise _not_ported("comms_report", "DecodeLoop")

    def check(self, const_bytes=None, memory=False, budget=None,
              comms=False, min_eff=0.0):
        raise _not_ported("check", "DecodeLoop")
