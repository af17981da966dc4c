"""The port's C++ inference runtime (``native/infer.py`` over
``native/infer_core.cpp``, ``serve --native``) on the CPU.

``infer_core.cpp`` is the reference's source byte for byte, so the
port's ``NativeForward`` must give the reference's ``NativeForward``'s
outputs exactly on the same package; against the port's own torch
``ExportedForward`` (f32 on the CPU) it holds 1e-5.  The refusals and
the closed handle are the counterparts of ``tests/test_native.py``.
"""

import json
import os

import numpy as np
import pytest

from znicz_tpu.native import infer as jinfer

from znicz_tpu_torch.core import prng as tprng
from znicz_tpu_torch.core.backends import TorchDevice
from znicz_tpu_torch.native import infer as tinfer
from znicz_tpu_torch.ops import pooling as pool_ops
from znicz_tpu_torch.serve.engine import BatchEngine, load_backend
from znicz_tpu_torch.standard_workflow import StandardWorkflow
from znicz_tpu_torch.utils.export import ExportedForward, export_forward

#: native against the port's torch forward: both f32 on the CPU, summed
#: in other orders
NATIVE_ATOL = 1e-5

NETS = {
    "fc": ([{"type": "all2all_relu", "->": {"output_sample_shape": 12}},
            {"type": "all2all_sigmoid", "->": {"output_sample_shape": 9}},
            {"type": "softmax", "->": {"output_sample_shape": 3}}],
           "synthetic_classifier",
           {"n_classes": 3, "sample_shape": (13,), "n_train": 30,
            "n_valid": 0, "minibatch_size": 10}),
    "conv": ([{"type": "conv_relu", "->": {"n_kernels": 8, "kx": 5,
                                            "ky": 5, "padding": (2, 2, 2, 2)}},
              {"type": "norm", "->": {"alpha": 1e-3, "beta": 0.75,
                                      "k": 2.0, "n": 5}},
              {"type": "max_pooling", "->": {"kx": 3, "ky": 3,
                                             "sliding": (2, 2)}},
              {"type": "conv_str", "->": {"n_kernels": 6, "kx": 3,
                                           "ky": 3}},
              {"type": "avg_pooling", "->": {"kx": 2, "ky": 2}},
              {"type": "dropout", "->": {"dropout_ratio": 0.5}},
              {"type": "all2all_tanh", "->": {"output_sample_shape": 10}},
              {"type": "softmax", "->": {"output_sample_shape": 4}}],
             "synthetic_image",
             {"n_classes": 4, "sample_shape": (16, 16, 3), "n_train": 16,
              "n_valid": 0, "minibatch_size": 8}),
}


@pytest.fixture(scope="module")
def packages(tmp_path_factory):
    out = {}
    tmp = tmp_path_factory.mktemp("native")
    for i, (net, (layers, loader, cfg)) in enumerate(sorted(NETS.items())):
        tprng.seed_all(31 + i)
        w = StandardWorkflow(name=net, loss_function="softmax",
                             layers=layers, loader_name=loader,
                             loader_config=dict(cfg),
                             decision_config={"max_epochs": 1})
        w.initialize(device=TorchDevice("cpu"))
        out[net] = export_forward(w, str(tmp / f"{net}.npz"))
    return out


@pytest.mark.parametrize("net", sorted(NETS))
def test_native_matches_the_reference_runtime_and_the_torch_forward(
        packages, net):
    path = packages[net]
    native = tinfer.NativeForward(path)
    torch_fwd = ExportedForward(path, device="cpu")
    assert native.input_shape == torch_fwd.input_shape
    x = np.random.default_rng(7).normal(
        size=(9,) + native.input_shape).astype(np.float32)
    got = native(x)
    np.testing.assert_array_equal(got, jinfer.NativeForward(path)(x))
    np.testing.assert_allclose(got, torch_fwd(x), rtol=0, atol=NATIVE_ATOL)
    np.testing.assert_array_equal(got.argmax(axis=1),
                                  torch_fwd(x).argmax(axis=1))
    np.testing.assert_allclose(got.sum(axis=1), 1.0, rtol=1e-5)


def test_native_backend_serves_exact_batches(packages):
    backend = load_backend(packages["fc"], prefer_native=True)
    assert isinstance(backend, tinfer.NativeForward)
    engine = BatchEngine(backend, max_batch=8)
    assert engine.static_shapes is False and engine.warmup() == 0
    x = np.random.default_rng(2).normal(size=(3, 13)).astype(np.float32)
    np.testing.assert_array_equal(engine.run(x), backend(x))
    assert engine.compile_count == 0
    engine.close()
    with pytest.raises(RuntimeError, match="closed"):
        backend(x)


def test_a_native_runtime_that_cannot_build_raises(packages, monkeypatch):
    """--native is the user's choice: no quiet switch to the torch
    forward when the runtime cannot be built."""
    from znicz_tpu_torch import native

    monkeypatch.setattr(tinfer, "_lib", None)
    monkeypatch.setattr(native, "CXX", "no-such-compiler")
    with pytest.raises(RuntimeError, match="cannot be built"):
        load_backend(packages["fc"], prefer_native=True)


def _raw_pkg(tmp_path, name, arch, arrays, input_shape=(4, 4, 2)):
    meta = {"format": "znicz_tpu.forward", "version": 1, "name": "t",
            "ema": False, "input_shape": list(input_shape), "arch": arch}
    path = os.path.join(str(tmp_path), name)
    with open(path, "wb") as f:
        np.savez_compressed(f, __arch__=np.array(json.dumps(meta)),
                            **arrays)
    return path


def test_native_rejects_unsupported_layer(tmp_path):
    path = _raw_pkg(tmp_path, "bad.npz",
                    [{"type": "deconv", "config": {"n_kernels": 2, "kx": 3,
                                                   "ky": 3}}], {})
    with pytest.raises(ValueError, match="deconv"):
        tinfer.NativeForward(path)


def test_native_pooling_default_geometry(tmp_path):
    p = _raw_pkg(tmp_path, "pool.npz",
                 [{"type": "max_pooling", "config": {}}], {}, (5, 5, 3))
    x = np.random.default_rng(3).normal(size=(2, 5, 5, 3)).astype(
        np.float32)
    ref, _ = pool_ops.max_forward(np, x, 2, 2, 2, 2)
    np.testing.assert_allclose(tinfer.NativeForward(p)(x),
                               ref.reshape(2, -1), rtol=1e-6)


def test_native_weights_transposed(tmp_path):
    rng = np.random.default_rng(4)
    w_t = rng.normal(size=(6, 32)).astype(np.float32)   # (out, in)
    p = _raw_pkg(tmp_path, "wt.npz",
                 [{"type": "all2all",
                   "config": {"output_sample_shape": 6,
                              "weights_transposed": True}}],
                 {"0.weights": w_t}, (4, 4, 2))
    x = rng.normal(size=(3, 4, 4, 2)).astype(np.float32)
    want = x.reshape(3, -1) @ w_t.T
    np.testing.assert_allclose(tinfer.NativeForward(p)(x), want,
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ExportedForward(p, device="cpu")(x), want,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch,arrays", [
    ([{"type": "all2all", "config": {"output_sample_shape": 4}}], {}),
    ([{"config": {}}], {}),
    ([{"type": "conv", "config": {"n_kernels": 4, "kx": 3, "ky": 3}}],
     {"0.weights": np.zeros((5, 5, 2, 4), np.float32)}),
    ([{"type": "all2all", "config": {"output_sample_shape": 4}}],
     {"0.weights": np.zeros((7, 4), np.float32)})],
    ids=["fc_without_weights", "no_type", "conv_geometry", "fc_rows"])
def test_native_malformed_packages_fail_closed(tmp_path, arch, arrays):
    with pytest.raises(ValueError):
        tinfer.NativeForward(_raw_pkg(tmp_path, "bad.npz", arch, arrays))


def test_native_closed_handle_and_bad_input_raise(tmp_path):
    p = _raw_pkg(tmp_path, "pool.npz",
                 [{"type": "max_pooling", "config": {}}], {}, (4, 4, 1))
    f = tinfer.NativeForward(p)
    with pytest.raises(ValueError, match="input shape"):
        f(np.zeros((1, 4, 4, 2), np.float32))
    f.close()
    with pytest.raises(RuntimeError, match="closed"):
        f(np.zeros((1, 4, 4, 1), np.float32))
    f.close()                           # idempotent
