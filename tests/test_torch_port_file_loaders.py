"""The port's numpy file loaders against the JAX package on the CPU:
``loader/mnist.py`` (IDX files, registered as ``mnist``),
``loader/pickles.py`` (CIFAR python batches, ``pickles_image``), their
normalizers (``loader/normalization.py``) and the shared I/O retry
(``resilience/retry.py``).

- the IDX format read and written by either package, the same bytes;
- the seeded synthesis writes the same files in both packages;
- the same files serve identical minibatches in both packages (the same
  shuffle state), and the loaders' state dicts restore the normalizer;
- ``mnist_conv.build()`` and ``cifar_conv.build()`` on their default
  file loaders, at narrow widths, fused: the same per-epoch n_err as the
  JAX builds and weights within the fused conv band
  (tests/test_torch_port_fused_conv.py's ``WEIGHT_ATOL``).
"""

import copy
import filecmp
import os

import numpy as np
import pytest

from znicz_tpu.core import prng as jprng
from znicz_tpu.core.backends import NumpyDevice
from znicz_tpu.loader import mnist as jmnist_loader
from znicz_tpu.loader import pickles as jpickles
from znicz_tpu.models import cifar_conv as jcifar
from znicz_tpu.models import mnist_conv as jmnist_conv
from znicz_tpu.resilience import retry as jretry

from znicz_tpu_torch.core import prng as tprng
from znicz_tpu_torch.core.backends import TorchDevice
from znicz_tpu_torch.loader import mnist as tmnist_loader
from znicz_tpu_torch.loader import pickles as tpickles
from znicz_tpu_torch.loader.base import get_loader
from znicz_tpu_torch.loader.normalization import normalizer_factory
from znicz_tpu_torch.models import cifar_conv as tcifar
from znicz_tpu_torch.models import mnist_conv as tmnist_conv
from znicz_tpu_torch.resilience import retry as tretry

from test_torch_port_fused_conv import (WEIGHT_ATOL, SharedUniforms,
                                        _fused_runs)

#: the small synthesized sets: MNIST 60 train + 20 test images, CIFAR
#: 5 x 12 train + 20 validation images
MNIST_SYNTH = (60, 20)
CIFAR_SYNTH = {"n_per_train_batch": 12, "n_valid": 20}
EPOCHS = 2


def test_loaders_registered_under_the_reference_names():
    assert get_loader("mnist") is tmnist_loader.MnistLoader
    assert get_loader("pickles_image") is tpickles.PicklesImageLoader


@pytest.mark.parametrize("dtype,shape,gz", [
    (np.uint8, (5, 28, 28), False), (np.int32, (7,), True),
    (np.float32, (3, 2, 4), False), (np.float64, (2, 3), True)])
def test_idx_written_by_either_package_reads_in_both(tmp_path, dtype, shape,
                                                     gz):
    data = (np.random.default_rng(1).normal(size=shape) * 50).astype(dtype)
    suffix = ".gz" if gz else ""
    tp, jp = tmp_path / f"t{suffix}", tmp_path / f"j{suffix}"
    tmnist_loader.write_idx(str(tp), data)
    jmnist_loader.write_idx(str(jp), data)
    if not gz:   # gzip stamps its own header time
        assert tp.read_bytes() == jp.read_bytes()
    for path in (tp, jp):
        for read in (tmnist_loader.read_idx, jmnist_loader.read_idx):
            got = read(str(path))
            assert got.dtype == data.dtype
            np.testing.assert_array_equal(got, data)


def test_idx_rejects_non_idx(tmp_path):
    bad = tmp_path / "bad"
    bad.write_bytes(b"\x01\x02\x03\x04rest")
    with pytest.raises(ValueError, match="not an IDX file"):
        tmnist_loader.read_idx(str(bad))


def test_synthesis_writes_the_same_files(tmp_path):
    tmnist_loader.synthesize_mnist(str(tmp_path / "tm"), *MNIST_SYNTH)
    jmnist_loader.synthesize_mnist(str(tmp_path / "jm"), *MNIST_SYNTH)
    tpickles.synthesize_cifar(str(tmp_path / "tc"), **CIFAR_SYNTH)
    jpickles.synthesize_cifar(str(tmp_path / "jc"), **CIFAR_SYNTH)
    for a, b in (("tm", "jm"), ("tc", "jc")):
        names = sorted(os.listdir(tmp_path / a))
        assert names == sorted(os.listdir(tmp_path / b)) and names
        match, mismatch, errors = filecmp.cmpfiles(
            tmp_path / a, tmp_path / b, names, shallow=False)
        assert mismatch == [] and errors == [], (a, mismatch, errors)


def _serve_both(tmp_path, kind, n_serves):
    """The JAX and the port loader of ``kind`` over the same synthesized
    files, the same prng state: ``n_serves`` minibatches from each."""
    if kind == "mnist":
        jcls, tcls = jmnist_loader.MnistLoader, tmnist_loader.MnistLoader
        cfg = {"synth_sizes": MNIST_SYNTH, "n_train": 50, "n_valid": 20}
    else:
        jcls, tcls = jpickles.PicklesImageLoader, tpickles.PicklesImageLoader
        cfg = {"synth_config": CIFAR_SYNTH, "n_train": 50}
    cfg.update(data_dir=str(tmp_path / kind), minibatch_size=15)
    jprng.seed_all(3)
    jl = jcls(None, **cfg)
    jl.initialize(device=NumpyDevice())
    tprng.seed_all(3)
    tl = tcls(None, **cfg)
    tl.initialize(device=TorchDevice("cpu"))
    served = []
    for _ in range(n_serves):
        jl.run()
        tl.run()
        served.append((tl, jl))
        for name in ("data", "labels", "indices"):
            t = getattr(tl, f"minibatch_{name}").mem
            j = getattr(jl, f"minibatch_{name}").mem
            assert t.dtype == j.dtype, name
            np.testing.assert_array_equal(t, j, err_msg=name)
        assert tl.minibatch_size == jl.minibatch_size
        assert tl.minibatch_class == jl.minibatch_class
        assert tl.last_minibatch == jl.last_minibatch
        assert tl.epoch_number == jl.epoch_number
    return tl, jl


@pytest.mark.parametrize("kind", ["mnist", "pickles_image"])
def test_the_same_files_serve_the_same_minibatches(tmp_path, kind):
    """Two epochs (validation, then the shuffled train set with a short
    tail) bit-identical between the packages, and the data set itself."""
    tl, jl = _serve_both(tmp_path, kind, 2 * (2 + 4))
    assert tl.class_lengths == jl.class_lengths
    np.testing.assert_array_equal(tl.original_data.mem,
                                  jl.original_data.mem)
    np.testing.assert_array_equal(tl.original_labels.mem,
                                  jl.original_labels.mem)
    assert tl.epoch_number == 2


@pytest.mark.parametrize("kind", ["mnist", "pickles_image"])
def test_state_dict_restores_the_normalizer(tmp_path, kind):
    """A loader restored from another's state serves what it would have:
    the cursor, the shuffles and the fitted normalizer, re-applied to the
    files' raw data."""
    tl, _ = _serve_both(tmp_path, kind, 3)
    state = tl.state_dict()
    assert state["normalizer"]["meta"]["type"] == tl.normalizer.state_dict(
    )[0]["type"]
    cls = type(tl)
    fresh = cls(None, data_dir=tl.data_dir, minibatch_size=15,
                n_train=tl.n_train, n_valid=tl.n_valid,
                normalization_type="none")
    fresh.initialize(device=TorchDevice("cpu"))
    fresh.load_state_dict(copy.deepcopy(state))
    np.testing.assert_array_equal(fresh.original_data.mem,
                                  tl.original_data.mem)
    for _ in range(4):
        tl.run()
        fresh.run()
        np.testing.assert_array_equal(fresh.minibatch_data.mem,
                                      tl.minibatch_data.mem)


@pytest.mark.parametrize("name", ["linear", "mean_disp", "pointwise",
                                  "none", "exp"])
def test_normalizers_match_the_reference(name):
    from znicz_tpu.loader.normalization import normalizer_factory as jnf

    data = np.random.default_rng(2).normal(
        1.0, 3.0, (40, 6, 5)).astype(np.float32)
    t, j = normalizer_factory(name), jnf(name)
    t.analyze(data)
    j.analyze(data)
    np.testing.assert_array_equal(t.normalize(data), j.normalize(data))
    np.testing.assert_array_equal(t.denormalize(t.normalize(data)),
                                  j.denormalize(j.normalize(data)))


def test_retry_policy_backs_off_as_the_reference():
    """The same seed backs off identically in both packages; a transient
    OSError is retried, a ValueError is not."""
    delays = {}
    for mod in (tretry, jretry):
        slept = []
        policy = mod.RetryPolicy(max_attempts=4, base_delay=0.01, seed=5,
                                 sleep=slept.append)
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise OSError("transient")
            return "ok"
        assert policy.call(flaky) == "ok"
        delays[mod.__name__] = slept
        with pytest.raises(ValueError):
            policy.call(lambda: (_ for _ in ()).throw(ValueError("no")))
    t, j = delays.values()
    assert len(t) == 2 and t == j


# -- the models on their own files --------------------------------------------

def _narrow(layers):
    """The layer list at narrow widths (conv 4/8, fc 16)."""
    specs = copy.deepcopy(layers)
    for spec in specs:
        if spec["type"].startswith("conv"):
            spec["->"]["n_kernels"] //= 8
        elif spec["type"] in ("all2all_relu",):
            spec["->"]["output_sample_shape"] = 16
    return specs


def _mnist_conv(data_dir):
    def make(jax_side):
        return (jmnist_conv if jax_side else tmnist_conv).build(
            max_epochs=EPOCHS, minibatch_size=20, n_train=60, n_valid=20,
            loader_config={"data_dir": data_dir,
                           "synth_sizes": MNIST_SYNTH})
    return make


def _cifar_conv(data_dir):
    def make(jax_side):
        return (jcifar if jax_side else tcifar).build(
            max_epochs=EPOCHS, minibatch_size=20, n_train=60, n_valid=20,
            loader_config={"data_dir": data_dir,
                           "synth_config": CIFAR_SYNTH})
    return make


@pytest.mark.parametrize("model", ["mnist_conv", "cifar_conv"])
def test_models_on_their_file_loaders_match_jax(model, tmp_path,
                                                monkeypatch):
    """``build()`` with the default loader over the same synthesized
    files, narrow widths, fused, 2 epochs from one seed and the same
    initial weights (CIFAR conv's dropout drawing the same uniforms on
    both sides): the same per-epoch n_err, every weight within the fused
    conv band, every layer trained."""
    data_dir = str(tmp_path / model)
    mods = (jmnist_conv, tmnist_conv) if model == "mnist_conv" else \
        (jcifar, tcifar)
    narrow = _narrow(mods[0].LAYERS)
    for mod in mods:
        monkeypatch.setattr(mod, "LAYERS", copy.deepcopy(narrow))
    make = _mnist_conv(data_dir) if model == "mnist_conv" else \
        _cifar_conv(data_dir)
    uniforms = SharedUniforms(9) if model == "cifar_conv" else None
    jw, tw, params = _fused_runs(make, 8, uniforms, monkeypatch)
    loader = "MnistLoader" if model == "mnist_conv" else \
        "PicklesImageLoader"
    assert type(tw.loader).__name__ == type(jw.loader).__name__ == loader
    assert bool(tw.decision.complete)
    assert len(tw.decision.metrics_history) == EPOCHS
    assert tw.decision.metrics_history == jw.decision.metrics_history
    for ft, fj, p in zip(tw.forwards, jw.forwards, params):
        if p is None:
            continue
        assert not np.array_equal(ft.weights.map_read(), p["w"]), ft.name
        for a in ("weights", "bias"):
            np.testing.assert_allclose(getattr(ft, a).map_read(),
                                       getattr(fj, a).map_read(), rtol=0,
                                       atol=WEIGHT_ATOL,
                                       err_msg=f"{ft.name}.{a}")
