"""The whole slice: the SSD detector served by the JAX package's
``ServingEngine`` and by the PyTorch port's, from one checkpoint.

The JAX side writes ``prefix-symbol.json`` and ``prefix-0000.params``
(weights from a numpy seed); both engines serve the same requests with
buckets (1, 4), including a chunked one. Tolerances:

- heads (cls_prob, loc_pred, anchors via ``output_names``): ``atol=1e-5``
  (f32 convolutions summed in different orders);
- detections: class ids and keep mask exact, boxes and scores
  ``atol=1e-5``. Scores that differ by float noise can swap two sorted
  rows; a row may differ only where its sorted score lies within 1e-6 of a
  neighbour's, and such rows are reported.

Also: padding never leaks into real rows, a missing parameter raises
naming it, the engine refuses to fall back to the CPU, and the port
imports neither ``jax`` nor ``mxnet_tpu``.
"""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.models import ssd as jssd
from mxnet_tpu.serving import ServingEngine as JaxEngine
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.ops import multibox_nms
from mxnet_tpu_torch.serving import ServingEngine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (3, 64, 64)
BUCKETS = (1, 4)
HEADS = ["cls_prob", "multibox_loc_pred", "multibox_anchors"]
ATOL = 1e-5
TIE = 1e-6


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """JAX-written checkpoint of ssd.get_symbol(num_classes=3, width=8)."""
    net = jssd.get_symbol(num_classes=3, width=8)
    shapes, _, _ = net.infer_shape(data=(1,) + SHAPE)
    rng = np.random.default_rng(0)
    params = {}
    for name, shape in zip(net.list_arguments(), shapes):
        if name == "data":
            continue
        if name.endswith("_weight"):
            scale = np.sqrt(2.0 / np.prod(shape[1:]))
        else:
            scale = 0.1
        params[name] = (rng.standard_normal(shape) * scale).astype(np.float32)
    prefix = str(tmp_path_factory.mktemp("ssd") / "ssd")
    mx.model.save_checkpoint(prefix, 0, net,
                             {k: mx.nd.array(v) for k, v in params.items()},
                             {})
    images = rng.random((6,) + SHAPE, dtype=np.float32)
    return prefix, params, images


def _files(prefix):
    return prefix + "-symbol.json", prefix + "-0000.params"


@pytest.fixture(scope="module")
def served(ckpt):
    """Both engines' detections and heads for requests n = 1, 3, 4, 6."""
    prefix, _, images = ckpt
    sym, par = _files(prefix)
    engines = {
        "jax": (JaxEngine(sym, par, {"data": SHAPE}, buckets=BUCKETS),
                JaxEngine(sym, par, {"data": SHAPE}, buckets=BUCKETS,
                          output_names=HEADS)),
        "torch": (ServingEngine(sym, par, {"data": SHAPE}, buckets=BUCKETS,
                                device="cpu"),
                  ServingEngine(sym, par, {"data": SHAPE}, buckets=BUCKETS,
                                output_names=HEADS, device="cpu")),
    }
    out = {}
    for side, (det, heads) in engines.items():
        for n in (1, 3, 4, 6):
            x = {"data": images[:n]}
            out[side, n] = (det.infer(x)[0], heads.infer(x))
    return out, engines["torch"][0]


def _sorted_scores(cls_prob):
    """Pre-NMS sorted scores per image, as MultiBoxDetection ranks them."""
    score = cls_prob[:, 1:].max(axis=1)
    score = np.where(score > np.float32(0.01), score, 0)
    return -np.sort(-score, axis=1, kind="stable")


@pytest.mark.parametrize("n", [1, 3, 4, 6])
def test_heads_agree(served, n):
    out, _ = served
    jh, th = out["jax", n][1], out["torch", n][1]
    assert [a.shape for a in th] == [a.shape for a in jh]
    assert th[0].shape == (n, 4, 1344) and th[1].shape == (n, 1344 * 4)
    for a, b in zip(th, jh):
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)


@pytest.mark.parametrize("n", [1, 3, 4, 6])
def test_detections_agree(served, n):
    out, _ = served
    jd, td = out["jax", n][0], out["torch", n][0]
    assert td.shape == jd.shape == (n, 1344, 6)
    assert np.isfinite(td).all()
    s = _sorted_scores(out["jax", n][1][0])[:, :400]
    gap = np.abs(np.diff(s, axis=1)) <= TIE
    near_tie = np.zeros(s.shape, bool)
    near_tie[:, 1:] |= gap
    near_tie[:, :-1] |= gap
    near_tie = np.pad(near_tie, ((0, 0), (0, td.shape[1] - s.shape[1])))
    differs = ((td[..., 0] != jd[..., 0])
               | (np.abs(td[..., 1:] - jd[..., 1:]) > ATOL).any(-1))
    tied = np.argwhere(differs & near_tie)
    if len(tied):
        print("rows that differ at near-tied scores (image, row): %s"
              % tied.tolist())
    untied = np.argwhere(differs & ~near_tie)
    assert not len(untied), "rows differ away from any score tie: %s" % (
        untied[:10].tolist())
    kept = td[..., 0] >= 0
    assert kept.any() and not kept.all()
    # rows past nms_topk=400 are all -1 in both
    assert (td[:, 400:] == -1).all() and (jd[:, 400:] == -1).all()


def test_padding_never_leaks(served):
    out, _ = served
    np.testing.assert_array_equal(out["torch", 3][0], out["torch", 4][0][:3])
    for a, b in zip(out["torch", 3][1][:2], out["torch", 4][1][:2]):
        np.testing.assert_array_equal(a, b[:3])
    # n=6 chunks as 4 + 2: its first 4 rows are the n=4 request's
    np.testing.assert_array_equal(out["torch", 6][0][:4], out["torch", 4][0])


def test_engine_counts_and_cpu_stays_plain(served):
    _, eng = served
    assert eng.device == torch.device("cpu")
    assert eng.bucket_for(3) == 4 and eng.bucket_for(1) == 1
    assert multibox_nms.LAUNCHES == 0
    with pytest.raises(MXNetError, match="no bucket"):
        eng.bucket_for(5)
    before = eng.health.report()
    eng.infer({"data": np.zeros((6,) + SHAPE, np.float32)})
    after = eng.health.report()
    assert after["batches"] - before["batches"] == 2
    assert after["examples"] - before["examples"] == 6
    assert after["padded"] - before["padded"] == 2
    assert multibox_nms.LAUNCHES == 0


def test_port_params_dict_and_convert(ckpt, served):
    """In-memory JAX parameters through convert give the same detections
    as the checkpoint file."""
    from mxnet_tpu_torch import convert
    prefix, params, images = ckpt
    out, _ = served
    arg, _ = convert.from_reference_params(
        {k: mx.nd.array(v) for k, v in params.items()}, {}, "cpu")
    eng = ServingEngine(_files(prefix)[0], arg, {"data": SHAPE},
                        buckets=BUCKETS, device="cpu")
    np.testing.assert_array_equal(eng.infer({"data": images[:3]})[0],
                                  out["torch", 3][0])


def test_missing_parameter_raises_naming_it(ckpt):
    prefix, params, _ = ckpt
    partial = {k: v for k, v in params.items() if k != "conv3_2_bias"}
    with pytest.raises(MXNetError, match="conv3_2_bias"):
        ServingEngine(_files(prefix)[0], partial, {"data": SHAPE},
                      buckets=BUCKETS, device="cpu")


def test_no_cpu_fallback_without_cuda(ckpt, monkeypatch):
    prefix, _, _ = ckpt
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="CUDA is not available"):
        ServingEngine(*_files(prefix), {"data": SHAPE}, buckets=BUCKETS)


@pytest.mark.parametrize("kwargs,what", [
    (dict(quantize="int8"), "quantize"),
    (dict(contexts=2), "contexts"),
    (dict(executables="x.bin"), "executables"),
])
def test_unported_options_raise(ckpt, kwargs, what):
    prefix, _, _ = ckpt
    with pytest.raises(MXNetError, match=what):
        ServingEngine(*_files(prefix), {"data": SHAPE}, device="cpu",
                      **kwargs)


def test_import_pulls_in_neither_jax_nor_mxnet_tpu():
    code = ("import sys, mxnet_tpu_torch, mxnet_tpu_torch.serving; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'mxnet_tpu.')) or m == 'mxnet_tpu']; "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_no_file_of_the_port_imports_jax_or_mxnet_tpu():
    bad = []
    for dirpath, _, files in os.walk(os.path.join(ROOT, "mxnet_tpu_torch")):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            tree = ast.parse(open(path).read(), path)
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module or ""]
                else:
                    continue
                for m in names:
                    if m.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu"):
                        bad.append("%s: %s" % (path, m))
    assert not bad, bad
