"""Data parallelism over a 'data' mesh of replicas on the card, against
one device and the port's CPU mesh.

Two replicas share ``cuda:0`` (the GPU machine has one card): the narrow
ResNet of ``tests/test_torch_multichip.py`` (a fused Conv1x1->BatchNorm
pair on B1's kernel, float32 with TF32 off and deterministic cuDNN) takes
two ``TrainStep`` steps over the mesh and on one device; the MLP fits over
``[gpu(0), gpu(1)]`` where a second card exists, else the contexts
``[gpu(0), gpu(0)]`` build no mesh. Tolerances: parameters and moving
statistics ``rtol=1e-4, atol=1e-5`` against one device (float32 sums in
other orders); the replicas bit for bit; the CPU mesh ``rtol=1e-4,
atol=1e-5`` (B1's ``tf32x3`` route against its plain version, 1e-5 of
sum |x||w|).

This file imports neither JAX nor the JAX package, so it also runs on a
GPU machine without them (``tests/conftest.py`` imports JAX; skip it):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_multichip_card.py -q

Without CUDA each test skips, with its reason.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops import matmul_stats as ms
from mxnet_tpu_torch.parallel import mesh as pm
from mxnet_tpu_torch.train_step import TrainStep

TOL = dict(rtol=1e-4, atol=1e-5)
B, HW = 8, 8


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: two replicas of a 'data' mesh on "
                    "cuda:0 (chip_smoke.py phase 18 runs ResNet-50 so)")


@pytest.fixture
def exact_f32():
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    yield
    (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
     torch.backends.cudnn.deterministic) = prev


def _narrow_resnet():
    sym = mt.sym
    with mt.symbol.NameManager():
        data = sym.Variable("data")
        x = sym.Convolution(data=data, num_filter=8, kernel=(3, 3),
                            pad=(1, 1), no_bias=True, layout="NHWC",
                            name="stem")
        x = sym.BatchNorm(data=x, fix_gamma=False, axis=3, name="stem_bn")
        x = sym.Activation(data=x, act_type="relu")
        y = sym.Convolution(data=x, num_filter=8, kernel=(1, 1),
                            no_bias=True, layout="NHWC", name="u1")
        y = sym.BatchNorm(data=y, fix_gamma=False, axis=3, name="u1_bn")
        x = sym.Activation(data=x + y, act_type="relu")
        x = sym.Pooling(data=x, kernel=(HW, HW), pool_type="avg",
                        global_pool=True, layout="NHWC")
        x = sym.FullyConnected(data=sym.Flatten(data=x), num_hidden=4,
                               name="fc")
        return sym.SoftmaxOutput(data=x, name="softmax")


def _states(monkeypatch, device, mesh):
    monkeypatch.setenv("MXTPU_FUSE_CONV_BN", "1")
    one = TrainStep(_narrow_resnet(), learning_rate=0.05, device=device)
    two = TrainStep(_narrow_resnet(), learning_rate=0.05, mesh=mesh)
    st1 = one.init({"data": (B, HW, HW, 3)}, {"softmax_label": (B,)})
    st2 = two.replicate_state({
        "params": {n: v.clone() for n, v in st1["params"].items()},
        "aux": {n: v.clone() for n, v in st1["aux"].items()},
        "opt": {n: v.clone() for n, v in st1["opt"].items()},
        "step": st1["step"].clone()})
    return one, two, st1, st2


def _batch(device, k=2):
    rng = np.random.default_rng(0)
    return {"data": torch.from_numpy(rng.random((k, B, HW, HW, 3),
                                                dtype=np.float32)).to(device),
            "softmax_label": torch.from_numpy(
                rng.integers(0, 4, (k, B)).astype(np.float32)).to(device)}


def test_two_replicas_on_one_card_match_one_device(monkeypatch, exact_f32):
    """Two K=2 steps over a 2-replica mesh on cuda:0: B1 launches on each
    replica's shard (2 pairs' worth a step), the state equals one device's
    within the tolerance and the replicas are identical."""
    _need_card()
    dev = torch.device("cuda", 0)
    mesh = pm.make_mesh({"data": 2}, [dev, dev])
    one, two, st1, st2 = _states(monkeypatch, dev, mesh)
    sb = _batch(dev)
    st1, _ = one.run_steps(st1, sb)
    ms.reset_launches()
    st2, _ = two.run_steps(st2, two.shard_superbatch(sb))
    torch.cuda.synchronize()
    assert ms.LAUNCHES_BY_ROUTE["tf32x3"] == 2 * 2
    for key in ("params", "aux"):
        for n, v in st1[key].items():
            np.testing.assert_allclose(st2[key][n].cpu().numpy(),
                                       v.cpu().numpy(), err_msg=n, **TOL)
    for rep in two.replica_states(st2)[1:]:
        for n, v in st2["params"].items():
            assert torch.equal(rep["params"][n], v), n


def test_card_mesh_matches_the_cpu_mesh(monkeypatch, exact_f32):
    """The same two steps from the same state over a 2-replica mesh on the
    CPU (B1's plain version) and on the card (its kernel)."""
    _need_card()
    dev = torch.device("cuda", 0)
    cpu = torch.device("cpu")
    _, _, st0, _ = _states(monkeypatch, cpu, pm.make_mesh({"data": 2},
                                                          [cpu, cpu]))
    res = []
    for d in (cpu, dev):
        _, two, _, _ = _states(monkeypatch, d, pm.make_mesh({"data": 2},
                                                            [d, d]))
        st = two.replicate_state({
            k: ({n: v.to(d, copy=True) for n, v in st0[k].items()}
                if isinstance(st0[k], dict) else st0[k].to(d, copy=True))
            for k in ("params", "aux", "opt", "step")})
        st, _ = two.run_steps(st, two.shard_superbatch(_batch(d)))
        res.append({n: v.cpu().numpy() for n, v in st["params"].items()})
    for n in res[0]:
        np.testing.assert_allclose(res[1][n], res[0][n], err_msg=n, **TOL)


def test_module_over_gpu_contexts(monkeypatch):
    """``Module`` over two GPU contexts: a 2-replica mesh across two cards
    where the machine has them; ``[gpu(0), gpu(0)]`` builds none, as the
    JAX package's duplicate devices; a context past the cards raises."""
    _need_card()
    sym = mt.models.mlp(num_classes=4, hidden=(16,))
    shapes = dict(data_shapes=[("data", (8, 10))],
                  label_shapes=[("softmax_label", (8,))])
    mod = mt.mod.Module(sym, context=[mt.gpu(0), mt.gpu(0)])
    mod.bind(**shapes)
    assert mod._exec_group._mesh is None
    n = torch.cuda.device_count()
    if n < 2:
        with pytest.raises(mt.MXNetError, match="visible"):
            mt.mod.Module(sym, context=[mt.gpu(0), mt.gpu(1)]).bind(**shapes)
        return
    mod = mt.mod.Module(sym, context=[mt.gpu(0), mt.gpu(1)])
    mod.bind(**shapes)
    assert pm.data_axis_size(mod._exec_group._mesh) == 2
