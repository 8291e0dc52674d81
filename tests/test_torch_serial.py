"""``.params`` interchange between the JAX package and the PyTorch port.

Files written by ``mxnet_tpu.nd.save`` load bitwise in ``mxnet_tpu_torch``,
files written by the port load bitwise in the JAX package, and both write
the same bytes for the same arrays. ``convert`` round-trips parameters
held in memory.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu_torch import context as tctx, convert, dmlc_serial
from mxnet_tpu_torch import ndarray as tnd
from mxnet_tpu_torch.base import MXNetError

DTYPES = ["float32", "float16", "uint8", "int32", "bfloat16"]


def _arrays(dtype, seed):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((3, 5)) * 10).astype(dtype),
            "b": (rng.standard_normal((7,)) * 10).astype(dtype),
            "s": np.asarray(rng.standard_normal((1,)) * 10).astype(dtype)}


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint8).tobytes(), a.shape


@pytest.mark.parametrize("dtype", DTYPES)
def test_jax_params_load_bitwise_in_port(tmp_path, dtype):
    src = _arrays(dtype, 1)
    f = str(tmp_path / "j.params")
    mx.nd.save(f, {k: mx.nd.array(v, dtype=v.dtype) for k, v in src.items()})
    got = tnd.load(f)
    assert list(got) == list(src)
    for k, v in src.items():
        assert _bits(got[k].asnumpy()) == _bits(v)
    # the port writes the same file back
    g = str(tmp_path / "t.params")
    tnd.save(g, got)
    assert open(f, "rb").read() == open(g, "rb").read()


@pytest.mark.parametrize("dtype", DTYPES)
def test_port_params_load_bitwise_in_jax(tmp_path, dtype):
    src = _arrays(dtype, 2)
    f = str(tmp_path / "t.params")
    tnd.save(f, {k: tnd.array(v, ctx=tctx.cpu()) for k, v in src.items()})
    got = mx.nd.load(f)
    for k, v in src.items():
        assert _bits(got[k].asnumpy()) == _bits(v)


def test_bfloat16_maps_to_torch_bfloat16(tmp_path):
    f = str(tmp_path / "bf.params")
    x = np.array([1.5, -2.25, 3.0e-3], dtype="bfloat16")
    mx.nd.save(f, {"x": mx.nd.array(x, dtype=x.dtype)})
    t = tnd.load(f)["x"]
    assert t.data.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.data.float().numpy(),
                                  x.astype(np.float32))


def test_list_files_roundtrip_both_ways(tmp_path):
    f = str(tmp_path / "l.params")
    mx.nd.save(f, [mx.nd.ones((2, 2)), mx.nd.zeros((3,))])
    got = tnd.load(f)
    assert isinstance(got, list) and len(got) == 2
    np.testing.assert_array_equal(got[0].asnumpy(), np.ones((2, 2)))
    g = str(tmp_path / "m.params")
    tnd.save(g, got)
    assert open(f, "rb").read() == open(g, "rb").read()


@pytest.mark.parametrize("dtype", ["float64", "int64", "int8", "bool"])
def test_wire_dtypes_beyond_the_reference_flags(dtype):
    a = (np.random.default_rng(3).random((4, 3)) * 9).astype(dtype)
    arrs, names = dmlc_serial.loads(dmlc_serial.dumps([a], ["a"]))
    assert names == ["a"] and arrs[0].dtype == np.dtype(dtype)
    np.testing.assert_array_equal(arrs[0], a)
    # the same bytes as the JAX package's serializer
    from mxnet_tpu import dmlc_serial as jserial
    assert dmlc_serial.dumps([a], ["a"]) == jserial.dumps([a], ["a"])


def test_bad_file_raises(tmp_path):
    f = str(tmp_path / "junk.params")
    open(f, "wb").write(b"not a params file")
    with pytest.raises(MXNetError):
        tnd.load(f)
    with pytest.raises(MXNetError, match="truncated"):
        dmlc_serial.loads(dmlc_serial.dumps([np.ones(4, np.float32)], [])[:-4])


def test_from_reference_params_roundtrip():
    rng = np.random.default_rng(4)
    arg = {"conv_weight": mx.nd.array(rng.standard_normal((4, 3, 3, 3))
                                      .astype(np.float32)),
           "conv_bias": rng.standard_normal(4).astype(np.float32)}
    aux = {"bn_moving_var": mx.nd.array(rng.random(4).astype(np.float32))}
    targ, taux = convert.from_reference_params(arg, aux, "cpu")
    assert all(isinstance(v, torch.Tensor) for v in targ.values())
    assert targ["conv_weight"].shape == (4, 3, 3, 3)
    back_arg, back_aux = convert.to_reference_params(targ, taux)
    for k, v in arg.items():
        ref = v.asnumpy() if hasattr(v, "asnumpy") else v
        assert _bits(back_arg[k]) == _bits(ref)
    assert _bits(back_aux["bn_moving_var"]) == _bits(
        aux["bn_moving_var"].asnumpy())
    # and back into the JAX package
    again = {k: mx.nd.array(v) for k, v in back_arg.items()}
    assert _bits(again["conv_weight"].asnumpy()) == _bits(
        arg["conv_weight"].asnumpy())
