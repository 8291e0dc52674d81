"""The port's compiled C API, ``libmxnet_tpu_torch.so``, on the CPU.

``mxnet_tpu_torch.capi_build`` compiles the library and ``card_client``
from ``mxnet_tpu_torch/csrc/capi/`` (``cc``, ``python3-config``) into the
package's ``_build/``, once per digest of the sources and flags. Then:

- the library exports the same ``MX*`` set as the ``MXTPU_EXPORT``
  functions of the JAX package's ``src/capi/libmxnet_tpu.c``;
- the JAX package's four C clients, ``cpp-package/example/lenet.cpp`` and
  the Perl XS consumer, compiled against the port's library into
  ``tmp_path``, pass their own PASS lines on the CPU. They are compiled
  unchanged but for one text substitution: ``abi_client.c`` and
  ``mt_client.c`` name fixed ``/tmp/`` scratch files, which the JAX
  package's tests of the same clients write too, so the copies compiled
  here name the same files under ``tmp_path``;
- op enumeration through ``ctypes`` and ``cpp-package/OpWrapperGenerator.py``
  (its output into ``tmp_path``) see the JAX package's registry: the two
  libraries generate the same ``op.h``;
- ``card_client cpu`` runs its three paths at small widths, as a child
  process and in this process (``libcard_client.so`` through ``ctypes``),
  and its results equal the port's Python API on the same inputs: the
  loss and the updated parameters within rtol 1e-6 (two passes over the
  same CPU tensors), the detections exactly. ``MXRtcPush`` on CPU arrays
  fails.

Nothing is written outside ``tmp_path`` and ``_build/``.
"""
import ctypes
import filecmp
import hashlib
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import capi_build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src", "capi")
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (the client's input writer)

RTOL = 1e-6
#: card_client's small widths: ResNet-18 NHWC 16x16, batch 2, 4 classes;
#: the SSD at width 8 on 3x64x64, batch 2
SMALL = dict(batch=2, image=16, classes=4, layers=18, ssd_batch=2,
             ssd_input=(3, 64, 64), ssd_kw={"width": 8})
#: the JAX package's clients and the lines each must print
CLIENTS = {
    "smoke_client": ["SMOKE PASS"],
    "abi_client": ["ABI PASS", "introspection: 2", "updater calls",
                   "imperative in-place: square -> [1 4 9]"],
    "mt_client": ["MT PASS", "error paths: 8/8"],
    "predict_client": ["RESHAPE PASS", "PREDICT PASS"],
}


def _need_toolchain():
    if shutil.which("cc") is None or shutil.which("python3-config") is None:
        pytest.skip("no C toolchain (cc, python3-config)")


@pytest.fixture(scope="module")
def built():
    _need_toolchain()
    return capi_build.build()


def _env(**extra):
    return capi_build.client_env(MXTPU_CAPI_DEVICE="cpu",
                                 JAX_PLATFORMS="cpu", **extra)


def _link(built, src, out, cxx=False):
    cmd = (["c++", "-O2", "-std=c++14",
            "-I" + os.path.join(ROOT, "cpp-package", "include")] if cxx
           else ["cc", "-O2", "-pthread"])
    cmd += ["-o", out, src, "-L" + built["dir"], "-lmxnet_tpu_torch",
            "-Wl,-rpath," + built["dir"]]
    p = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr
    return out


def _tree_digest(path):
    h = hashlib.sha256()
    for d, _, files in sorted(os.walk(path)):
        for f in sorted(files):
            with open(os.path.join(d, f), "rb") as fh:
                h.update(os.path.relpath(os.path.join(d, f), path).encode())
                h.update(fh.read())
    return h.hexdigest()


def test_exports_the_jax_librarys_symbol_set(built):
    with open(os.path.join(SRC, "libmxnet_tpu.c")) as f:
        want = set(re.findall(r"MXTPU_EXPORT[^(;]*?\b(MX\w+)\s*\(",
                              f.read()))
    p = subprocess.run(["nm", "-D", "--defined-only", built["library"]],
                       capture_output=True, text=True, check=True)
    got = set(re.findall(r" T (MX\w+)$", p.stdout, re.M))
    assert {"MXGetLastError", "MXExecutorBind", "MXPredCreate",
            "MXRtcPush"} <= want
    assert got == want
    # -fvisibility=hidden: nothing but the ABI is exported
    assert not re.findall(r" T (?!MX)(\w+)$", p.stdout, re.M)


def test_library_imports_the_port_only():
    with open(os.path.join(capi_build.SRC_DIR, capi_build.LIBRARY)) as f:
        imports = re.findall(r'PyImport_ImportModule\("([\w.]+)"\)', f.read())
    assert imports == ["mxnet_tpu_torch.c_api"]


def test_library_source_is_the_reference_but_for_its_module():
    """The port's library is its own copy of ``src/capi/libmxnet_tpu.c``:
    past the header comment the two differ only in the module that
    ``ensure_init`` imports (and the comments naming it), so a fix made to
    one copy alone fails here."""
    def body(path):
        with open(path) as f:
            text = f.read()
        return text[text.index("*/\n") + 3:]
    ref = body(os.path.join(SRC, "libmxnet_tpu.c"))
    port = body(os.path.join(capi_build.SRC_DIR, capi_build.LIBRARY))
    assert port.count("mxnet_tpu_torch.c_api") == 3
    assert port.replace("mxnet_tpu_torch.c_api", "mxnet_tpu.c_api") == ref


def _predict_checkpoint(tmp_path):
    net = mt.sym.SoftmaxOutput(
        mt.sym.FullyConnected(mt.sym.Variable("data"), num_hidden=4,
                              name="fc"), name="softmax")
    mod = mt.mod.Module(net, context=mt.cpu())
    mod.bind(data_shapes=[("data", (3, 6))],
             label_shapes=[("softmax_label", (3,))])
    mod.init_params()
    prefix = str(tmp_path / "pc")
    mod.save_checkpoint(prefix, 1)
    return [prefix + "-symbol.json", prefix + "-0001.params", "3", "6"]


def _client_source(client, tmp_path):
    """The JAX client's source, or where it names fixed ``/tmp/`` files, a
    copy in ``tmp_path`` that names them under ``tmp_path``: the only
    change, checked by undoing it."""
    src = os.path.join(SRC, client + ".c")
    with open(src) as f:
        text = f.read()
    if '"/tmp/' not in text:
        return src
    here = '"%s/' % tmp_path
    assert '"' not in str(tmp_path) and "\\" not in str(tmp_path)
    assert here not in text
    moved = text.replace('"/tmp/', here)
    assert moved.replace(here, '"/tmp/') == text and "/tmp/" not in \
        moved.replace(here, "")
    out = tmp_path / (client + ".c")
    out.write_text(moved)
    return str(out)


@pytest.mark.parametrize("client", sorted(CLIENTS))
def test_jax_clients_pass_against_the_port(built, client, tmp_path):
    before = _tree_digest(SRC)
    exe = _link(built, _client_source(client, tmp_path),
                str(tmp_path / client))
    args = _predict_checkpoint(tmp_path) if client == "predict_client" \
        else []
    p = subprocess.run([exe] + args, capture_output=True, text=True,
                       env=_env(), cwd=str(tmp_path), timeout=600)
    assert p.returncode == 0, p.stdout + p.stderr
    for line in CLIENTS[client]:
        assert line in p.stdout, p.stdout
    assert _tree_digest(SRC) == before


def test_lenet_cpp_passes_against_the_port(built, tmp_path):
    exe = _link(built, os.path.join(ROOT, "cpp-package", "example",
                                    "lenet.cpp"),
                str(tmp_path / "lenet"), cxx=True)
    p = subprocess.run([exe], capture_output=True, text=True, env=_env(),
                       cwd=str(tmp_path), timeout=900)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "LENET PASS" in p.stdout


def test_ctypes_enumeration_gives_the_jax_registry(built):
    from mxnet_tpu.ops import list_ops
    lib = ctypes.CDLL(built["library"])
    lib.MXGetLastError.restype = ctypes.c_char_p
    n = ctypes.c_uint(0)
    arr = ctypes.POINTER(ctypes.c_uint64)()
    assert lib.MXSymbolListAtomicSymbolCreators(
        ctypes.byref(n), ctypes.byref(arr)) == 0, lib.MXGetLastError()
    seen = {}
    for i in range(n.value):
        name, desc, kv, rt = (ctypes.c_char_p() for _ in range(4))
        na = ctypes.c_uint()
        an, at, ad = (ctypes.POINTER(ctypes.c_char_p)() for _ in range(3))
        assert lib.MXSymbolGetAtomicSymbolInfo(
            ctypes.c_uint64(arr[i]), ctypes.byref(name), ctypes.byref(desc),
            ctypes.byref(na), ctypes.byref(an), ctypes.byref(at),
            ctypes.byref(ad), ctypes.byref(kv), ctypes.byref(rt)) == 0
        seen[name.value.decode()] = [an[j].decode() for j in range(na.value)]
    assert n.value == len(list_ops())
    assert set(seen) == set(list_ops())
    assert seen["Convolution"][0] == "data"


def test_op_wrapper_generator_writes_the_same_op_h(built, tmp_path):
    jax_lib = str(tmp_path / "jax" / "libmxnet_tpu.so")
    p = subprocess.run(["make", "-C", SRC, "OUT=" + str(tmp_path / "jax"),
                        jax_lib], capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stdout + p.stderr
    gen = os.path.join(ROOT, "cpp-package", "OpWrapperGenerator.py")
    heads = {}
    for name, lib in (("jax", jax_lib), ("torch", built["library"])):
        heads[name] = str(tmp_path / ("op_%s.h" % name))
        p = subprocess.run([sys.executable, gen, lib, heads[name]],
                           capture_output=True, text=True, env=_env(),
                           cwd=str(tmp_path), timeout=600)
        assert p.returncode == 0, p.stdout + p.stderr
    assert filecmp.cmp(heads["jax"], heads["torch"], shallow=False)


def test_perl_consumer_passes_against_the_port(built, tmp_path):
    if shutil.which("perl") is None or shutil.which("xsubpp") is None:
        pytest.skip("no perl/XS toolchain")
    pkg = os.path.join(ROOT, "perl-package")

    def perl_config(key):
        return subprocess.run(
            ["perl", "-MConfig", "-e", "print $Config{%s}" % key],
            capture_output=True, text=True, check=True).stdout
    typemap = os.path.join(perl_config("privlib"), "ExtUtils", "typemap")
    xs_c = str(tmp_path / "MXNetTPU.c")
    with open(xs_c, "w") as f:
        subprocess.run(["xsubpp", "-typemap", typemap,
                        os.path.join(pkg, "MXNetTPU.xs")], stdout=f,
                       check=True, cwd=pkg)
    auto = tmp_path / "blib" / "auto" / "MXNetTPU"
    auto.mkdir(parents=True)
    cmd = ([perl_config("cc"), "-O2", "-shared"]
           + perl_config("cccdlflags").split()
           + perl_config("ccflags").split()
           + ["-I" + os.path.join(perl_config("archlib"), "CORE"),
              "-o", str(auto / "MXNetTPU.so"), xs_c,
              "-L" + built["dir"], "-lmxnet_tpu_torch",
              "-Wl,-rpath," + built["dir"]])
    p = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr
    (tmp_path / "blib" / "MXNetTPU.pm").write_text(
        'package MXNetTPU;\nuse strict;\nrequire DynaLoader;\n'
        'our @ISA = ("DynaLoader");\n__PACKAGE__->bootstrap();\n1;\n')
    shutil.copy(os.path.join(pkg, "predict.pl"), str(tmp_path))
    p = subprocess.run(["perl", str(tmp_path / "predict.pl")],
                       capture_output=True, text=True, env=_env(),
                       cwd=str(tmp_path), timeout=600)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "PERL PASS" in p.stdout
    m = re.search(r"ops visible through ABI: (\d+)", p.stdout)
    assert m and int(m.group(1)) > 200


# -- card_client at small widths -------------------------------------------

@pytest.fixture(scope="module")
def client_inputs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("card_client_in"))
    return d, chip_smoke.capi_inputs(d, 0, **SMALL)


@pytest.fixture(scope="module")
def python_step(client_inputs):
    """(a) through the port's Python API on the CPU."""
    os.environ["MXTPU_FUSE_CONV_BN"] = "1"
    try:
        return chip_smoke.capi_python_step(client_inputs[1], "cpu")
    finally:
        del os.environ["MXTPU_FUSE_CONV_BN"]


def _check_against_python(out, inputs, python_step):
    res = chip_smoke.capi_results(out)
    loss, want = python_step
    assert res["a_loss"][1] == pytest.approx(loss, rel=RTOL)
    np.testing.assert_allclose(chip_smoke.capi_dumped(out, "a_params"), want,
                               rtol=RTOL, atol=1e-7)
    det = chip_smoke.capi_dumped(out, "b_det")
    shape = (SMALL["ssd_batch"],) + SMALL["ssd_input"]
    pred = mt.Predictor(inputs["ssd_json"], inputs["ssd_params"],
                        {"data": shape}, ctx=mt.cpu())
    pred.forward(data=inputs["ssd_images"])
    np.testing.assert_array_equal(det.reshape(pred.get_output(0).shape),
                                  pred.get_output(0).asnumpy())
    assert "c_w" not in res     # the Rtc push fails on the CPU
    return res


@pytest.fixture(scope="module")
def child_out(built, client_inputs, tmp_path_factory):
    """``card_client cpu`` as a child process: (its output, out dir)."""
    out = str(tmp_path_factory.mktemp("card_client_child"))
    p = subprocess.run([built["client"], "cpu", client_inputs[0], out,
                        "dump"], capture_output=True, text=True,
                       env=_env(MXTPU_FUSE_CONV_BN="1"), timeout=600)
    assert p.returncode == 0, p.stdout + p.stderr
    return p.stdout, out


def test_card_client_cpu_child_matches_the_python_api(
        child_out, client_inputs, python_step):
    stdout, out = child_out
    assert "CARD CLIENT PASS (cpu)" in stdout
    assert "MXRtcPush on cpu arrays fails" in stdout
    assert "two threads, detections equal" in stdout
    _check_against_python(out, client_inputs[1], python_step)


def test_card_client_in_process_matches_the_child(
        built, client_inputs, python_step, child_out, tmp_path,
        monkeypatch):
    """The client's code through ``ctypes`` in this (Python) process: the
    library finds the interpreter initialised and only imports. CPU
    tensors take the kernels' plain versions, which count no launch."""
    from mxnet_tpu_torch.ops import matmul_stats as ms
    in_dir, inputs = client_inputs
    monkeypatch.setenv("MXTPU_FUSE_CONV_BN", "1")
    monkeypatch.setenv("MXTPU_CAPI_DEVICE", "cpu")
    run = ctypes.CDLL(built["client_lib"]).card_client_run
    run.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_char_p)]
    argv = [a.encode() for a in ("card_client", "cpu", in_dir,
                                 str(tmp_path), "dump")]
    ms.reset_launches()
    assert run(len(argv), (ctypes.c_char_p * len(argv))(*argv)) == 0
    assert ms.LAUNCHES == 0
    res = _check_against_python(str(tmp_path), inputs, python_step)
    assert chip_smoke.capi_results(child_out[1]) == res


def test_failed_build_raises_with_the_compilers_output(monkeypatch,
                                                       tmp_path):
    _need_toolchain()
    src = tmp_path / "csrc"
    src.mkdir()
    (src / capi_build.LIBRARY).write_text("int broken(void) { return }\n")
    (src / capi_build.CLIENT).write_text("int main(void) { return 0; }\n")
    monkeypatch.setattr(capi_build, "SRC_DIR", str(src))
    monkeypatch.setattr(capi_build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(mt.MXNetError, match="cc failed building the C API"
                       ) as ei:
        capi_build.build()
    assert "error" in str(ei.value)
    assert os.listdir(str(tmp_path / "build")) == []
