"""The port's ``parallel.ring`` (blockwise, ring and Ulysses attention)
and ``parallel.pipeline`` (the GPipe schedule) against the JAX package's,
which run under ``shard_map`` on the conftest's 8 virtual CPU devices; the
port runs over a CPU mesh of as many positions, the shards explicit.

The same numpy inputs (from a seed) go through both. Tolerances:
- attention outputs, against the JAX package's and against full
  softmax attention: ``rtol=1e-5, atol=1e-6`` (float32, the streaming
  softmax in another summation order than the full one);
- the pipeline's outputs: ``rtol=1e-5, atol=1e-5``, its gradients
  ``rtol=1e-4, atol=1e-4``, as the JAX package's own tests hold them;
- the collective counts: exact.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from mxnet_tpu.parallel import make_mesh as jmake_mesh
from mxnet_tpu.parallel import pipeline_apply as jpipeline_apply
from mxnet_tpu.parallel import ring as jring
from mxnet_tpu.parallel.mesh import shard_map_compat
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel import mesh as tmesh
from mxnet_tpu_torch.parallel import pipeline_apply, pipeline_spmd
from mxnet_tpu_torch.parallel import ring as tring

JP = jax.sharding.PartitionSpec
ATOL = dict(rtol=1e-5, atol=1e-6)


def _qkv(seed, b=2, h=4, s=16, d=8):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, h, s, d).astype(np.float32) for _ in range(3)]


def _full(q, k, v, causal):
    """softmax(q k^T / sqrt(d)) v in float64."""
    q, k, v = (x.astype(np.float64) for x in (q, k, v))
    s = np.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(q.shape[-1])
    if causal:
        n = s.shape[-1]
        s = np.where(np.tril(np.ones((s.shape[-2], n), bool)), s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    return np.einsum("bhqk,bhkd->bhqd", p / p.sum(-1, keepdims=True), v)


@pytest.mark.parametrize("causal,block,sk", [
    (False, 4, 16), (True, 4, 16), (False, 3, 10), (True, 3, 10)],
    ids=["plain", "causal", "ragged", "ragged-causal"])
def test_blockwise_attention_matches_jax(causal, block, sk):
    q, _, _ = _qkv(1)
    _, k, v = _qkv(2, s=sk)
    if causal and sk != q.shape[2]:
        q = q[:, :, :sk]
    want = np.asarray(jring.blockwise_attention(
        *[jnp.asarray(a) for a in (q, k, v)], block_size=block,
        causal=causal))
    got = tring.blockwise_attention(
        *[torch.from_numpy(a) for a in (q, k, v)], block_size=block,
        causal=causal).numpy()
    np.testing.assert_allclose(got, want, **ATOL)
    np.testing.assert_allclose(got, _full(q, k, v, causal), **ATOL)


def test_one_attention_core():
    """The attention op and the layer stack use ``parallel.ring``'s core."""
    from mxnet_tpu_torch.ops import attention, transformer_stack
    assert attention.blockwise_attention is tring.blockwise_attention
    assert attention._block_attn is tring._block_attn
    assert transformer_stack.blockwise_attention is tring.blockwise_attention


def _jax_seq(fn, n, q, k, v):
    spec = JP(None, None, "seq", None)
    mesh = jmake_mesh({"seq": n})
    return np.asarray(shard_map_compat(
        fn, mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec)(
            *[jnp.asarray(a) for a in (q, k, v)]))


def _port_seq(fn, n, q, k, v, as_lists=False):
    mesh = tmesh.make_mesh({"seq": n}, ["cpu"] * n)
    spec = (None, None, "seq", None)
    arrs = [tmesh.split_spec(torch.from_numpy(a), mesh, spec)
            for a in (q, k, v)]
    if as_lists:
        out = fn(*[a.parts for a in arrs])
        return tmesh.MeshArray(mesh, out, spec=spec).gather().numpy()
    return fn(*arrs).gather().numpy()


@pytest.mark.parametrize("n", [4, 8])
@pytest.mark.parametrize("causal", [False, True], ids=["plain", "causal"])
def test_ring_attention_matches_jax(n, causal):
    """Ring attention over a 4- and an 8-way 'seq' axis: the JAX
    package's under shard_map, full attention, and the K/V rotations
    counted (n - 1 a ring for K and for V)."""
    q, k, v = _qkv(3 + n + causal)
    want = _jax_seq(functools.partial(jring.ring_attention, axis_name="seq",
                                      causal=causal), n, q, k, v)
    tmesh.reset_counters()
    got = _port_seq(functools.partial(tring.ring_attention, causal=causal),
                    n, q, k, v)
    assert tmesh.COUNTERS["ppermute"] == 2 * (n - 1)
    np.testing.assert_allclose(got, want, **ATOL)
    np.testing.assert_allclose(got, _full(q, k, v, causal), **ATOL)
    lists = _port_seq(functools.partial(tring.ring_attention, causal=causal),
                      n, q, k, v, as_lists=True)
    np.testing.assert_array_equal(lists, got)


@pytest.mark.parametrize("n", [4, 8])
def test_ulysses_attention_matches_jax(n):
    """Ulysses over a 4- and an 8-way 'seq' axis (8 heads): sequence
    shards to head shards and back, three exchanges in and one out."""
    q, k, v = _qkv(20 + n, h=8)
    attn = functools.partial(jring.blockwise_attention, causal=True)
    want = _jax_seq(functools.partial(jring.ulysses_attention,
                                      axis_name="seq", attn_fn=attn),
                    n, q, k, v)
    tmesh.reset_counters()
    got = _port_seq(functools.partial(
        tring.ulysses_attention, attn_fn=functools.partial(
            tring.blockwise_attention, causal=True)), n, q, k, v)
    assert tmesh.COUNTERS["all_to_all"] == 4
    np.testing.assert_allclose(got, want, **ATOL)
    np.testing.assert_allclose(got, _full(q, k, v, True), **ATOL)


def test_ring_attention_is_differentiable():
    """Gradients through the ring (its ppermutes are ``.to`` copies) equal
    those of blockwise attention on one device (``rtol=1e-4``)."""
    q, k, v = _qkv(40)
    mesh = tmesh.make_mesh({"seq": 4}, ["cpu"] * 4)
    spec = (None, None, "seq", None)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = tring.ring_attention(
        *[tmesh.split_spec(t, mesh, spec) for t in leaves], causal=True)
    (out.gather() ** 2).sum().backward()
    ref = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    (tring.blockwise_attention(*ref, causal=True) ** 2).sum().backward()
    for a, b in zip(leaves, ref):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(),
                                   rtol=1e-4, atol=1e-5)


def _stage_np(S, D, seed):
    rng = np.random.RandomState(seed)
    Ws = (rng.randn(S, D, D) * 0.3).astype(np.float32)
    bs = (rng.randn(S, D) * 0.1).astype(np.float32)
    return Ws, bs


def test_pipeline_matches_serial_and_jax():
    """GPipe over 'pipe'=8 with 4 microbatches == serial stages == the JAX
    package's scan+ppermute schedule; one activation hop a tick."""
    S, B, D = 8, 16, 32
    Ws, bs = _stage_np(S, D, 5)
    x = np.random.RandomState(6).randn(B, D).astype(np.float32)

    def jstage(params, h):
        W, b = params
        return jnp.tanh(h @ W + b)

    def tstage(params, h):
        W, b = params
        return torch.tanh(h @ W + b)
    want = np.asarray(jpipeline_apply(
        jstage, (jnp.asarray(Ws), jnp.asarray(bs)), jnp.asarray(x),
        jmake_mesh({"pipe": 8}), num_microbatches=4))
    tmesh.reset_counters()
    got = pipeline_apply(tstage, (torch.from_numpy(Ws), torch.from_numpy(bs)),
                         torch.from_numpy(x),
                         tmesh.make_mesh({"pipe": 8}, ["cpu"] * 8),
                         num_microbatches=4).numpy()
    assert tmesh.COUNTERS["ppermute"] == S + 4 - 2
    ref = torch.from_numpy(x)
    for s in range(S):
        ref = tstage((torch.from_numpy(Ws[s]), torch.from_numpy(bs[s])), ref)
    np.testing.assert_allclose(got, ref.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_pipeline_differentiable():
    """Gradients through the schedule equal the serial stages' and the JAX
    package's ``jax.grad`` of its pipeline."""
    S, B, D = 8, 8, 16
    Ws = (np.random.RandomState(6).randn(S, D, D) * 0.3).astype(np.float32)
    x = np.random.RandomState(7).randn(B, D).astype(np.float32)
    jx = jnp.asarray(x)

    def jloss(W):
        out = jpipeline_apply(lambda w, h: jnp.tanh(h @ w), W, jx,
                              jmake_mesh({"pipe": 8}), num_microbatches=2)
        return jnp.sum(out ** 2)
    want = np.asarray(jax.grad(jloss)(jnp.asarray(Ws)))
    W = torch.from_numpy(Ws).requires_grad_()
    out = pipeline_apply(lambda w, h: torch.tanh(h @ w), W,
                         torch.from_numpy(x),
                         tmesh.make_mesh({"pipe": 8}, ["cpu"] * 8),
                         num_microbatches=2)
    (out ** 2).sum().backward()
    Wr = torch.from_numpy(Ws).requires_grad_()
    h = torch.from_numpy(x)
    for s in range(S):
        h = torch.tanh(h @ Wr[s])
    (h ** 2).sum().backward()
    np.testing.assert_allclose(W.grad.numpy(), Wr.grad.numpy(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(W.grad.numpy(), want, rtol=1e-4, atol=1e-4)


def test_pipeline_composes_with_data_parallelism():
    """``batch_axis='data'`` on a data=2 x pipe=4 mesh: each data shard of
    every microbatch runs its own pipeline; the result equals the JAX
    package's on the same mesh and the serial stages."""
    S, B, D = 4, 16, 8
    Ws, bs = _stage_np(S, D, 9)
    x = np.random.RandomState(10).randn(B, D).astype(np.float32)
    want = np.asarray(jpipeline_apply(
        lambda p, h: jnp.tanh(h @ p[0] + p[1]),
        (jnp.asarray(Ws), jnp.asarray(bs)), jnp.asarray(x),
        jmake_mesh({"data": 2, "pipe": 4}), num_microbatches=2,
        batch_axis="data"))
    got = pipeline_apply(lambda p, h: torch.tanh(h @ p[0] + p[1]),
                         (torch.from_numpy(Ws), torch.from_numpy(bs)),
                         torch.from_numpy(x),
                         tmesh.make_mesh({"data": 2, "pipe": 4},
                                         ["cpu"] * 8),
                         num_microbatches=2, batch_axis="data").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_pipeline_spmd_over_explicit_stages():
    """The schedule itself: stage ``s``'s parameters as given, M
    microbatches in, the last stage's M outputs back in order."""
    Ws, bs = _stage_np(3, 4, 11)
    micro = torch.from_numpy(
        np.random.RandomState(12).randn(5, 2, 4).astype(np.float32))
    outs = pipeline_spmd(
        lambda p, h: torch.tanh(h @ p[0] + p[1]),
        [(torch.from_numpy(Ws[s]), torch.from_numpy(bs[s]))
         for s in range(3)], micro, [torch.device("cpu")] * 3)
    assert len(outs) == 5
    for m in range(5):
        h = micro[m]
        for s in range(3):
            h = torch.tanh(h @ torch.from_numpy(Ws[s])
                           + torch.from_numpy(bs[s]))
        assert torch.equal(outs[m], h)


@pytest.mark.parametrize("case", ["batch", "stages", "microbatch"])
def test_pipeline_checks_match_jax(case):
    """The schedule's prechecks raise the JAX package's messages."""
    S = 4
    W = np.zeros((S if case != "stages" else 3, 4, 4), np.float32)
    B = 6 if case == "batch" else 8
    x = np.zeros((B, 4), np.float32)
    shape = {"data": 2, "pipe": 4} if case == "microbatch" else {"pipe": 4}
    kw = dict(num_microbatches=4 if case == "microbatch" else 4,
              batch_axis="data" if case == "microbatch" else None)
    if case == "microbatch":
        x = np.zeros((4, 4), np.float32)
    with pytest.raises(Exception) as jerr:
        jpipeline_apply(lambda w, h: h @ w, jnp.asarray(W), jnp.asarray(x),
                        jmake_mesh(shape), **kw)
    with pytest.raises(MXNetError) as terr:
        pipeline_apply(lambda w, h: h @ w, torch.from_numpy(W),
                       torch.from_numpy(x),
                       tmesh.make_mesh(shape, ["cpu"] * int(np.prod(
                           list(shape.values())))), **kw)
    assert str(terr.value) == str(jerr.value)
