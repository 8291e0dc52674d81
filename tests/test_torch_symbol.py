"""Symbol JSON and shape inference: the PyTorch port against the JAX
package.

The same model built in both packages gives the same NNVM JSON (compared
as parsed JSON), each package loads the other's JSON, and
``list_arguments``/``infer_shape`` agree, at test size and at the full
SSD-300 width (shapes only). The legacy JSON forms the JAX package
upgrades load the same in the port.
"""
import json

import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu.models import ssd as jssd
from mxnet_tpu_torch.models import ssd as tssd

SMALL = dict(num_classes=3, width=8)


def _both(kwargs):
    with mx.symbol.NameManager():
        j = jssd.get_symbol(**kwargs)
    with mt.symbol.NameManager():
        t = tssd.get_symbol(**kwargs)
    return j, t


@pytest.mark.parametrize("kwargs", [SMALL, {},
                                    dict(num_classes=2, width=4,
                                         nms_topk=-1, nms_thresh=0.3)],
                         ids=["small", "default", "topk_all"])
def test_ssd_json_equal(kwargs):
    j, t = _both(kwargs)
    assert json.loads(t.tojson()) == json.loads(j.tojson())
    assert t.list_arguments() == j.list_arguments()
    assert t.list_outputs() == j.list_outputs()
    assert (t.get_internals().list_outputs()
            == j.get_internals().list_outputs())


def test_auto_names_follow_the_name_manager():
    """Unscoped builds share one counter per package: the second build's
    automatic names move on in both packages alike."""
    with mx.symbol.NameManager():
        jssd.get_symbol(**SMALL)
        j2 = jssd.get_symbol(**SMALL)
    with mt.symbol.NameManager():
        tssd.get_symbol(**SMALL)
        t2 = tssd.get_symbol(**SMALL)
    assert t2.list_arguments() == j2.list_arguments()
    assert "activation6" in [o.rsplit("_", 1)[0]
                             for o in t2.get_internals().list_outputs()]


def test_each_package_loads_the_others_json():
    j, t = _both(SMALL)
    from_j = mt.symbol.load_json(j.tojson())
    from_t = mx.symbol.load_json(t.tojson())
    assert json.loads(from_j.tojson()) == json.loads(j.tojson())
    assert json.loads(from_t.tojson()) == json.loads(t.tojson())


def test_file_roundtrip(tmp_path):
    j, t = _both(SMALL)
    f = str(tmp_path / "ssd-symbol.json")
    j.save(f)
    loaded = mt.symbol.load(f)
    g = str(tmp_path / "ssd2-symbol.json")
    loaded.save(g)
    assert json.loads(open(g).read()) == json.loads(open(f).read())


@pytest.mark.parametrize("kwargs,data", [
    (SMALL, (2, 3, 64, 64)),
    (SMALL, (1, 3, 75, 83)),
    ({}, (1, 3, 300, 300)),
    ({}, (32, 3, 300, 300)),
], ids=["small", "odd", "full_width_b1", "full_width_b32"])
def test_infer_shape_equal(kwargs, data):
    j, t = _both(kwargs)
    want = j.infer_shape(data=data)
    got = t.infer_shape(data=data)
    assert got == want
    if data[2:] == (300, 300):
        assert got[1] == [(data[0], 29272, 6)]
    # every internal head (shape-only ops use meta tensors in the port)
    assert (t.get_internals().infer_shape(data=data)
            == j.get_internals().infer_shape(data=data))


def test_infer_shape_needs_the_data_shape():
    _, t = _both(SMALL)
    with pytest.raises(mt.MXNetError, match="data"):
        t.infer_shape()


# -- legacy JSON forms --------------------------------------------------

# the JAX package's early 2-tuple format (tests/test_interop.py fixture)
REPO_LEGACY = json.dumps({
    "nodes": [
        {"op": "null", "name": "x", "attrs": {}, "user_attrs": {},
         "inputs": []},
        {"op": "relu", "name": "r", "attrs": {}, "user_attrs": {},
         "inputs": [[0, 0]]},
    ],
    "heads": [[1, 0]],
    "mxnet_tpu_version": 1,
})

# pre-0.9 NNVM JSON: "param" dicts, 2-element inputs, suffix-style hidden
# keys ("weight_lr_mult"), a node-level hidden key, and a Convolution
# whose weight/bias variables are absent (upgrade adds them)
PRE09_LEGACY = json.dumps({
    "nodes": [
        {"op": "null", "name": "data", "param": {}, "inputs": []},
        {"op": "null", "name": "c1_weight", "param": {}, "inputs": []},
        {"op": "null", "name": "c1_bias", "param": {}, "inputs": []},
        {"op": "Convolution", "name": "c1",
         "param": {"kernel": "(3, 3)", "num_filter": "4", "pad": "(1, 1)",
                   "weight_lr_mult": "1.2", "weight_wd_mult": "0.3",
                   "bias_ctx_group": "stage1"},
         "inputs": [[0, 0], [1, 0], [2, 0]]},
        {"op": "Activation", "name": "a1", "param": {"act_type": "relu"},
         "attr": {"lr_mult": "0.5"}, "inputs": [[3, 0]]},
        {"op": "Convolution", "name": "c2",
         "param": {"kernel": "(1, 1)", "num_filter": "2"},
         "inputs": [[4, 0]]},
        {"op": "Pooling", "name": "p1",
         "param": {"kernel": "(2, 2)", "stride": "(2, 2)",
                   "pool_type": "avg", "pooling_convention": "full"},
         "inputs": [[5, 0]]},
    ],
    "arg_nodes": [0, 1, 2],
    "heads": [[6, 0]],
})


@pytest.mark.parametrize("fixture", [REPO_LEGACY, PRE09_LEGACY],
                         ids=["repo_2tuple", "pre09_nnvm"])
def test_legacy_json_loads_the_same(fixture):
    j = mx.symbol.load_json(fixture)
    t = mt.symbol.load_json(fixture)
    assert t.list_arguments() == j.list_arguments()
    assert t.attr_dict() == j.attr_dict()
    assert json.loads(t.tojson()) == json.loads(j.tojson())
    if fixture is PRE09_LEGACY:
        ad = t.attr_dict()
        assert ad["c1_weight"]["__lr_mult__"] == "1.2"
        assert ad["c1_weight"]["__wd_mult__"] == "0.3"
        assert ad["c1_bias"]["ctx_group"] == "stage1"
        assert "c2_weight" in t.list_arguments()
        assert (t.infer_shape(data=(1, 3, 9, 9))
                == j.infer_shape(data=(1, 3, 9, 9)))


def test_unknown_op_raises():
    js = json.dumps({"nodes": [{"op": "NoSuchOp9", "name": "n",
                                "inputs": []}],
                     "arg_nodes": [], "heads": [[0, 0, 0]],
                     "attrs": {"mxnet_version": ["int", 905]}})
    with pytest.raises(mt.MXNetError, match="NoSuchOp9"):
        mt.symbol.load_json(js)
