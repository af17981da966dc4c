"""The port's image-file input layer against the JAX package on the CPU:
``loader/image.py`` (``file_image``, ``full_batch_image``),
``units/mean_disp_normalizer.py`` and the models that read image files.

- the port's synthesized tree holds the reference's files byte for
  byte, and ``_decode`` gives the reference's pixels for every format
  the loaders scan for, converted and resized as the reference does;
- the same files and seed serve identical minibatches in both packages
  (data, labels, targets; augment off and on) through ``run`` and
  through the prefetch producer's ``fill_batch``, and the normalizer
  state restores and renormalizes;
- ``alexnet.build(loader_name="file_image", augment=True)`` (narrow
  widths, the same dropout uniforms both sides), ``models/image_ae.py``
  eager and fused and ``models/yale_faces.py`` fused train as the JAX
  builds do, within the fused conv and deconv bands;
- each of the three at ``pipeline_depth=2`` is bit-identical to its
  synchronous run, host-fed (labels or targets through the stager) and
  index-fed;
- an augmented run resumes bit-exact, and a JAX-written snapshot of one
  restores in the port.
"""

import json
import os

import jax
import numpy as np
import pytest
from PIL import Image

from znicz_tpu.core import prng as jprng
from znicz_tpu.core.backends import NumpyDevice, TPUDevice
from znicz_tpu.core.config import root as jroot
from znicz_tpu.core.memory import Array as JArray
from znicz_tpu.loader import image as jimage
from znicz_tpu.models import alexnet as jalexnet
from znicz_tpu.models import image_ae as jimage_ae
from znicz_tpu.models import yale_faces as jyale
from znicz_tpu.standard_workflow import StandardWorkflow as JStandard
from znicz_tpu.units.mean_disp_normalizer import MeanDispNormalizer as JMD

from znicz_tpu_torch.core import prng as tprng
from znicz_tpu_torch.core.backends import NumpyDevice as TNumpyDevice
from znicz_tpu_torch.core.backends import TorchDevice
from znicz_tpu_torch.core.config import root as troot
from znicz_tpu_torch.core.memory import Array as TArray
from znicz_tpu_torch.loader import image as timage
from znicz_tpu_torch.loader.base import get_loader
from znicz_tpu_torch.models import alexnet as talexnet
from znicz_tpu_torch.models import image_ae as timage_ae
from znicz_tpu_torch.models import yale_faces as tyale
from znicz_tpu_torch.pipeline import attach_prefetcher
from znicz_tpu_torch.snapshotter import restore_state
from znicz_tpu_torch.standard_workflow import StandardWorkflow as TStandard
from znicz_tpu_torch.units.mean_disp_normalizer import \
    MeanDispNormalizer as TMD
from znicz_tpu_torch.units.nn_units import load_forward_params

from test_torch_port_deconv import MSE_RTOL
from test_torch_port_deconv import WEIGHT_ATOL as AE_WEIGHT_ATOL
from test_torch_port_fused_conv import WEIGHT_ATOL, SharedUniforms

#: the reference's loader-test trees (tests/test_loader_files.py): 4
#: classes of 10 images at 12 x 10, and of 12 at 32 x 32
TREES = {"12x10": (10, (12, 10)), "32x32": (12, (32, 32))}
#: the 32-px AlexNet's tree: decoded at 32 + 29 = 61 px
ALEX_TREE = (10, (61, 61))
EPOCHS = 2


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """``{name: (reference tree, port tree)}``, each package's synthesis of
    the same tree (the reference's written by PIL)."""
    base = tmp_path_factory.mktemp("trees")
    out = {}
    for name, (n, size) in {**TREES, "alex": ALEX_TREE}.items():
        j, t = str(base / f"jax_{name}"), str(base / f"port_{name}")
        jimage.synthesize_image_dataset(j, n_classes=4, n_per_class=n,
                                        size=size)
        timage.synthesize_image_dataset(t, n_classes=4, n_per_class=n,
                                        size=size)
        out[name] = (j, t)
    return out


def _files(tree):
    return sorted(os.path.relpath(os.path.join(d, f), tree)
                  for d, _, fs in os.walk(tree) for f in fs
                  if f.endswith(".png"))


def test_loaders_and_unit_registered_under_the_reference_names():
    import znicz_tpu_torch.units as tunits

    assert get_loader("file_image") is timage.FileImageLoader
    assert get_loader("full_batch_image") is timage.FullBatchImageLoader
    assert get_loader("image_ae") is timage_ae.ImageAELoader
    assert tunits.mean_disp_normalizer.MeanDispNormalizer is TMD
    assert timage.IMAGE_EXTS == jimage.IMAGE_EXTS
    assert timage.SYNTH_VERSION == jimage.SYNTH_VERSION


# -- decoding and the synthesized trees ---------------------------------------

@pytest.mark.parametrize("name", list(TREES))
def test_port_synthesis_writes_the_reference_files(trees, name):
    jtree, ttree = trees[name]
    assert _files(ttree) == _files(jtree) and _files(ttree)
    for rel in _files(jtree):
        with open(os.path.join(jtree, rel), "rb") as j, \
                open(os.path.join(ttree, rel), "rb") as t:
            assert t.read() == j.read(), rel
    for tree in (jtree, ttree):
        with open(os.path.join(tree, ".synth_version")) as f:
            assert f.read() == jimage.SYNTH_VERSION


#: each file format the loaders scan for, and PNGs that the reference
#: converts (palette, alpha, grayscale) or resizes: (suffix, PIL mode,
#: the (h, w) it is decoded at; the files are 12 x 10)
DECODE_CASES = {"png": (".png", "RGB", (12, 10)),
                "png_down": (".png", "RGB", (8, 6)),
                "png_up": (".png", "RGB", (15, 13)),
                "png_palette": (".png", "P", (12, 10)),
                "png_rgba": (".png", "RGBA", (12, 10)),
                "png_gray": (".png", "L", (12, 10)),
                "jpeg": (".jpg", "RGB", (12, 10)),
                "bmp": (".bmp", "RGB", (12, 10)),
                "ppm": (".ppm", "RGB", (12, 10)),
                "gif": (".gif", "P", (12, 10))}


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_decode_matches_the_reference(trees, case, c, tmp_path):
    """``_decode`` of files saved from the tree in each format and mode:
    kept, turned to grayscale or RGB, or resized as the reference does;
    bit for bit."""
    suffix, mode, (h, w) = DECODE_CASES[case]
    tree = trees["12x10"][1]
    for i, rel in enumerate(_files(tree)[:3]):
        path = str(tmp_path / f"{i}{suffix}")
        Image.open(os.path.join(tree, rel)).convert(mode).save(path)
        got = timage._decode(path, (h, w, c))
        assert got.dtype == np.float32 and got.shape == (h, w, c)
        np.testing.assert_array_equal(
            got, jimage._decode(path, (h, w, c)), err_msg=rel)


def test_truncated_file_raises_as_the_reference(trees, tmp_path):
    src = os.path.join(trees["12x10"][1], _files(trees["12x10"][1])[0])
    blob = open(src, "rb").read()
    cut = str(tmp_path / "cut.png")
    open(cut, "wb").write(blob[:len(blob) // 2])
    with pytest.raises(OSError) as want:
        jimage._decode(cut, (12, 10, 3))
    with pytest.raises(type(want.value)):
        timage._decode(cut, (12, 10, 3))


def test_image_tree_regeneration_contract(tmp_path, monkeypatch):
    """The reference's contract (tests/test_zoo_text_faces.py): a current
    tree is left alone, a stale marker rebuilds, a tree without a marker
    is user data, and a torn synthesis never becomes visible."""
    d = str(tmp_path / "tree")
    timage.ensure_image_tree(d, n_classes=3, n_per_class=2, size=(8, 8))
    vfile = os.path.join(d, ".synth_version")
    assert open(vfile).read().strip() == timage.SYNTH_VERSION
    mtime = os.path.getmtime(vfile)
    timage.ensure_image_tree(d, n_classes=3, n_per_class=2, size=(8, 8))
    assert os.path.getmtime(vfile) == mtime
    with open(vfile, "w") as f:
        f.write("0-stale")
    timage.ensure_image_tree(d, n_classes=3, n_per_class=2, size=(8, 8))
    assert open(vfile).read().strip() == timage.SYNTH_VERSION
    user = str(tmp_path / "user")
    os.makedirs(os.path.join(user, "class_a"))
    with open(os.path.join(user, "class_a", "x.txt"), "w") as f:
        f.write("sentinel")
    timage.ensure_image_tree(user)
    assert os.listdir(user) == ["class_a"]

    def torn(data_dir, **kw):
        os.makedirs(os.path.join(data_dir, "class_000"))
        raise OSError("disk full")
    monkeypatch.setattr(timage, "synthesize_image_dataset", torn)
    fresh = str(tmp_path / "fresh")
    with pytest.raises(OSError, match="disk full"):
        timage.ensure_image_tree(fresh)
    assert not os.path.exists(fresh)


# -- the loaders --------------------------------------------------------------

def _config(tree, augment, **kw):
    cfg = {"data_dir": tree, "sample_shape": (12, 10, 3),
           "valid_fraction": 0.2, "minibatch_size": 8, **kw}
    if augment:
        cfg.update(mirror=True, crop=(10, 8))
    return cfg


def _loader(mod, cls, cfg, seed, jax_side):
    (jprng if jax_side else tprng).seed_all(seed)
    loader = getattr(mod, cls)(None, **cfg)
    loader.initialize(device=NumpyDevice() if jax_side else
                      TorchDevice("cpu"))
    return loader


def _produce(loader):
    """One minibatch through the prefetch producer's route (no pipeline
    attached: fresh buffers) -> (record, arrays)."""
    rec = loader._next_record()
    arrays = loader.fill_batch(rec["indices"], rec["size"], rec["cls"])
    loader._complete_record(rec)
    return rec, arrays


LOADER_CASES = [("file_image", "FileImageLoader", jimage, timage),
                ("full_batch_image", "FullBatchImageLoader", jimage,
                 timage),
                ("image_ae", "ImageAELoader", jimage_ae, timage_ae)]


@pytest.mark.parametrize("augment", [False, True], ids=["plain", "augment"])
@pytest.mark.parametrize("case", LOADER_CASES, ids=lambda c: c[0])
def test_the_same_files_serve_the_same_minibatches(trees, case, augment):
    """Two epochs (one validation and four train minibatches each, the
    train set reshuffled, the crops and mirrors drawn): the port's run()
    and its producer fill serve the reference's minibatches bit for
    bit, from the same order of files."""
    _, cls, jmod, tmod = case
    tree = trees["12x10"][1]
    cfg = _config(tree, augment, fit_samples=16)
    jl = _loader(jmod, cls, cfg, 44, True)
    tl = _loader(tmod, cls, cfg, 44, False)
    assert [os.path.relpath(p, tree) for p in tl._paths] == \
        [os.path.relpath(p, tree) for p in jl._paths]
    assert tl.class_lengths == jl.class_lengths == [0, 8, 32]
    assert tl.class_names == jl.class_names
    assert tl.served_shape == jl.served_shape
    assert tl.augmenting is augment
    keys = ["data", "labels"] + (["targets"] if cls == "ImageAELoader"
                                 else [])
    served, classes = [], []
    for _ in range(EPOCHS * 5):
        jl.run()
        tl.run()
        served.append({name: getattr(jl, f"minibatch_{name}").mem.copy()
                       for name in keys + ["indices"]})
        for name in keys + ["indices"]:
            t = getattr(tl, f"minibatch_{name}").mem
            assert t.dtype == served[-1][name].dtype, name
            np.testing.assert_array_equal(t, served[-1][name], err_msg=name)
        assert (tl.minibatch_size, tl.minibatch_class, tl.last_minibatch,
                tl.epoch_number) == (jl.minibatch_size, jl.minibatch_class,
                                     jl.last_minibatch, jl.epoch_number)
        classes.append(tl.minibatch_class)
    assert classes == [1, 2, 2, 2, 2] * EPOCHS and tl.epoch_number == EPOCHS
    if cls == "ImageAELoader":
        np.testing.assert_array_equal(tl.minibatch_targets.mem,
                                      tl.minibatch_data.mem)
    if cls != "FileImageLoader":
        for t, j in zip(tl.served_dataset(), jl.served_dataset()):
            np.testing.assert_array_equal(t, j)
        np.testing.assert_array_equal(tl.original_data.mem,
                                      jl.original_data.mem)
    # the producer route, from the same seed, draws the augmentation
    # stream in the same order and fills the same rows
    producer = _loader(tmod, cls, cfg, 44, False)
    for want in served:
        rec, arrays = _produce(producer)
        assert sorted(arrays) == sorted(keys)
        np.testing.assert_array_equal(rec["indices"], want["indices"])
        for name in keys:
            np.testing.assert_array_equal(arrays[name], want[name],
                                          err_msg=name)


@pytest.mark.parametrize("augment", [False, True], ids=["plain", "augment"])
@pytest.mark.parametrize("cls", ["FileImageLoader", "FullBatchImageLoader"])
def test_state_dict_restores_and_renormalizes(trees, cls, augment):
    """A loader restored from the reference's state (its cursor,
    shuffles, fitted normalizer and the global prng streams) serves what
    the reference serves next; a full-batch dataset is re-derived with
    the restored normalizer."""
    tree = trees["12x10"][1]
    cfg = _config(tree, augment)
    jl = _loader(jimage, cls, cfg, 7, True)
    for _ in range(3):
        jl.run()
    state = jl.state_dict()
    assert state["normalizer"]["meta"]["type"] == "mean_disp"
    # rebuilt from the same seed, as a restored workflow is: the split of
    # the files is seeded, not snapshotted
    fresh = _loader(timage, cls, {**cfg, "normalization_type": "none"}, 7,
                    False)
    fresh.load_state_dict(state)
    tprng.load_state_dict(jprng.state_dict())
    assert type(fresh.normalizer).__name__ == \
        type(jl.normalizer).__name__
    if cls == "FullBatchImageLoader":
        np.testing.assert_array_equal(fresh.original_data.mem,
                                      jl.original_data.mem)
    assert fresh.state_dict()["normalizer"]["meta"] == \
        state["normalizer"]["meta"]
    for _ in range(4):
        jl.run()
        fresh.run()
        np.testing.assert_array_equal(fresh.minibatch_data.mem,
                                      jl.minibatch_data.mem)


def test_mean_disp_normalizer_unit_matches_numpy_and_jax():
    """numpy, torch (CPU) and JAX outputs of the unit within 1e-6, and its
    checks: unfitted, and a mean of another sample shape."""
    rng = np.random.default_rng(5)
    x = rng.normal(3.0, 2.0, (6, 5, 4, 3)).astype(np.float32)
    fit = rng.normal(3.0, 2.0, (40, 5, 4, 3)).astype(np.float32)
    outs = {}
    for key, cls, arr, dev in (
            ("numpy", TMD, TArray, TNumpyDevice()),
            ("torch", TMD, TArray, TorchDevice("cpu")),
            ("jax", JMD, JArray, TPUDevice())):
        unit = cls(None)
        unit.input = arr(x.copy())
        unit.fit(fit)
        unit.initialize(device=dev)
        unit.run()
        outs[key] = np.array(unit.output.map_read())
    want = (x - fit.mean(0)) / (fit.max(0) - fit.min(0))
    for key, got in outs.items():
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6,
                                   err_msg=key)
        np.testing.assert_allclose(got, outs["jax"], rtol=0, atol=1e-6,
                                   err_msg=key)
    unit = TMD(None)
    unit.input = TArray(x)
    with pytest.raises(ValueError, match="needs mean/rdisp"):
        unit.initialize(device=TorchDevice("cpu"))
    unit.fit(fit[:, :4])
    with pytest.raises(ValueError, match="mean shape"):
        unit.initialize(device=TorchDevice("cpu"))


# -- the models against the JAX package ---------------------------------------

def _runs(make, seed, uniforms, monkeypatch):
    """The reference's run (Pallas interpret mode) and the port's from its
    initial weights and shuffle state -> (jax workflow, port workflow,
    initial params): tests/test_torch_port_fused_conv.py's ``_fused_runs``
    for eager and fused workflows, bias or none."""
    jprng.seed_all(seed)
    jroot.common.engine.pallas = True
    jroot.common.engine.pallas_interpret = True
    try:
        with monkeypatch.context() as m:
            if uniforms is not None:
                m.setattr(jax.random, "uniform", uniforms.jax_uniform)
            jw = make(True)
            jw.initialize(device=TPUDevice())
            params = [{"w": f.weights.map_read().copy(),
                       **({"b": f.bias.map_read().copy()} if f.bias
                          else {})} if f.weights else None
                      for f in jw.forwards]
            state = jprng.get().state_dict()
            jw.run()
    finally:
        jroot.common.engine.pallas = False
        jroot.common.engine.pallas_interpret = False
    tprng.seed_all(seed)
    tw = make(False)
    np.testing.assert_array_equal(np.asarray(tw.layer_specs, object),
                                  np.asarray(jw.layer_specs, object))
    load_forward_params(tw.forwards, params)
    tw.initialize(device=TorchDevice("cpu"))
    tprng.get().load_state_dict(state)
    if uniforms is not None:
        for f in tw.forwards:
            if f.NEEDS_RNG:
                f.draw_uniform = uniforms.port_draw
    tw.run()
    for w in (jw, tw):
        if getattr(w, "step", None) is not None:
            w.step.sync_to_units()
    return jw, tw, params


def _narrow(layers_fn):
    """alexnet.layers at narrow widths (conv 8/16/16/16/8, fc 32), as
    tests/test_torch_port_fused_conv.py cuts AlexNet."""
    def layers(**kw):
        specs = layers_fn(**kw)
        widths = iter((8, 16, 16, 16, 8))
        for spec in specs:
            if spec["type"] == "conv_str":
                spec["->"]["n_kernels"] = next(widths)
            elif spec["type"] == "all2all_str":
                spec["->"]["output_sample_shape"] = 32
        return specs
    return layers


@pytest.fixture
def narrow_alexnet(monkeypatch):
    for mod in (jalexnet, talexnet):
        monkeypatch.setattr(mod, "layers", _narrow(mod.layers))


def _alexnet_files(tree, **kw):
    def make(jax_side):
        return (jalexnet if jax_side else talexnet).build(
            max_epochs=EPOCHS, minibatch_size=8, n_classes=4, input_size=32,
            loader_name="file_image",
            loader_config={"data_dir": tree, "augment": True,
                           "valid_fraction": 0.25, "fit_samples": 8}, **kw)
    return make


def _forward_weights(w):
    return [(f.name, a, np.array(getattr(f, a).map_read()))
            for f in w.forwards for a in ("weights", "bias")
            if getattr(f, a, None)]


def _held(tw, jw, params, atol):
    for (name, attr, got), (_, _, want) in zip(_forward_weights(tw),
                                                _forward_weights(jw)):
        np.testing.assert_allclose(got, want, rtol=0, atol=atol,
                                   err_msg=f"{name}.{attr}")
    for f, p in zip(tw.forwards, params):
        if p is not None:
            assert not np.array_equal(f.weights.map_read(), p["w"]), f.name


def test_alexnet_on_augmented_files_matches_jax(trees, narrow_alexnet,
                                                monkeypatch):
    """The canonical recipe at 32 px (decoded at 61, random crops and
    mirrors on TRAIN, center crops on VALID), 4 classes, fused, the same
    dropout uniforms both sides: the same n_err per epoch and every
    weight within the fused conv band."""
    jw, tw, params = _runs(_alexnet_files(trees["alex"][1]), 8,
                                 SharedUniforms(9), monkeypatch)
    assert tw.loader.sample_shape == (61, 61, 3)
    assert tw.loader.crop == (32, 32) and tw.loader.mirror
    assert tw.step._dataset_dev is None       # augmenting: never pinned
    assert len(tw.decision.metrics_history) == EPOCHS
    assert tw.decision.metrics_history == jw.decision.metrics_history
    _held(tw, jw, params, WEIGHT_ATOL)


def test_alexnet_augment_needs_an_image_file_loader():
    with pytest.raises(ValueError, match="image-file loader"):
        talexnet.build(loader_config={"augment": True})


def _image_ae(tree, fused, epochs=3):
    def make(jax_side):
        return (jimage_ae if jax_side else timage_ae).build(
            max_epochs=epochs, fused=fused, loader_config={"data_dir": tree})
    return make


@pytest.fixture(scope="module")
def model_trees(tmp_path_factory):
    """The stand-in trees of image_ae and yale_faces at their defaults,
    synthesized by the port."""
    base = tmp_path_factory.mktemp("models")
    return {"image_ae": timage_ae.ensure_dataset(str(base / "image_ae")),
            "yale": tyale.ensure_dataset(str(base / "yale"))}


#: the reference's seeded pin of image_ae.build() (tests/test_models.py)
IMAGE_AE_PIN = [0.086547, 0.034062, 0.022606]


@pytest.mark.parametrize("fused", [False, True], ids=["eager", "fused"])
def test_image_ae_matches_jax(model_trees, fused, monkeypatch):
    """image_ae.build() at its defaults (24 px, 16 kernels) for 3 epochs:
    the MSE histories within the ConvAE band and on the reference's pin,
    the weights within the ConvAE weight band."""
    jw, tw, params = _runs(_image_ae(model_trees["image_ae"], fused),
                                 31, None, monkeypatch)
    hist = [[h[k] for k in sorted(h) if k.startswith("metric")]
            for h in tw.decision.metrics_history]
    jhist = [[h[k] for k in sorted(h) if k.startswith("metric")]
             for h in jw.decision.metrics_history]
    np.testing.assert_allclose(hist, jhist, rtol=MSE_RTOL)
    np.testing.assert_allclose(
        [h["metric_validation"] for h in tw.decision.metrics_history],
        IMAGE_AE_PIN, rtol=1e-4)
    _held(tw, jw, params, AE_WEIGHT_ATOL["fused" if fused else "eager"])
    np.testing.assert_array_equal(tw.loader.original_targets.mem,
                                  tw.loader.original_data.mem)


def test_yale_faces_matches_jax(model_trees, monkeypatch):
    """yale_faces.build() at its defaults (15 subjects, 32 px grayscale,
    full_batch_image), fused, 3 epochs: the same n_err per epoch and the
    weights within the fused band."""
    def make(jax_side):
        return (jyale if jax_side else tyale).build(
            max_epochs=3, loader_config={"data_dir": model_trees["yale"]})
    jw, tw, params = _runs(make, 5, None, monkeypatch)
    assert tw.loader.n_classes == 15
    assert tw.loader.class_lengths == [0, 75, 225]
    assert tw.loader.served_shape == (32, 32, 1)
    assert tw.step._dataset_dev is not None
    assert tw.decision.metrics_history == jw.decision.metrics_history
    _held(tw, jw, params, WEIGHT_ATOL)


# -- the feeding routes ------------------------------------------------------

def _fed_run(make, depth, host_fed):
    """The port's run of ``make(False)`` synchronous (depth None) or
    through the input pipeline at ``depth``; ``host_fed`` keeps the data
    set off the device, so every minibatch's rows and labels or targets
    go through the stager -> (history, weights, ring keys, pinned)."""
    tprng.seed_all(17)
    w = make(False)
    if depth:
        w.input_pipeline = attach_prefetcher(
            w.loader, stager=w.step.make_stager(), depth=depth)
    prev = troot.common.engine.get("dataset_on_device_max_bytes", 1 << 30)
    if host_fed:
        troot.common.engine.dataset_on_device_max_bytes = 0
    try:
        w.initialize(device=TorchDevice("cpu"))
    finally:
        troot.common.engine.dataset_on_device_max_bytes = prev
    pinned = w.step._dataset_dev is not None
    w.run()
    w.step.sync_to_units()
    w.stop()
    return (w.decision.metrics_history, _forward_weights(w),
            sorted(w.loader._rings), pinned)


@pytest.mark.parametrize("model,host_fed,rings", [
    ("alexnet", True, ["data", "labels"]),
    ("image_ae", True, ["data", "labels", "targets"]),
    ("image_ae", False, []),
    ("yale", True, ["data", "labels"]),
    ("yale", False, [])])
def test_depth_two_is_bit_identical_to_sync(model, host_fed, rings, trees,
                                            model_trees, narrow_alexnet):
    """Each model through the input pipeline at depth 2 against its
    synchronous run: the same history and the same weights, bit for bit.
    Host-fed, the stager ships the rows with the labels (AlexNet, Yale)
    or the targets (the image AE); index-fed, the indices only."""
    make = {"alexnet": _alexnet_files(trees["alex"][1]),
            "image_ae": _image_ae(model_trees["image_ae"], True, 2),
            "yale": lambda jax_side: tyale.build(
                max_epochs=2,
                loader_config={"data_dir": model_trees["yale"]})}[model]
    sync = _fed_run(make, None, host_fed)
    piped = _fed_run(make, 2, host_fed)
    assert piped[3] == sync[3] == (not host_fed)
    assert piped[2] == rings
    assert piped[0] == sync[0] and len(sync[0]) == 2
    for (name, attr, a), (_, _, b) in zip(sync[1], piped[1]):
        np.testing.assert_array_equal(a, b, err_msg=f"{name}.{attr}")


def test_scan_epoch_falls_back_for_augmenting_loader(trees):
    """scan_epoch needs the pinned dataset, which augmenting loaders
    refuse: the workflow runs the per-minibatch path (with augmentation)
    instead (the reference's tests/test_loader_files.py:407)."""
    troot.common.engine.scan_epoch = True
    try:
        tprng.seed_all(11)
        w = TStandard(
            name="AugScan",
            layers=[{"type": "softmax", "->": {"output_sample_shape": 4},
                     "<-": {"learning_rate": 0.05}}],
            loss_function="softmax", loader_name="full_batch_image",
            loader_config=_config(trees["12x10"][1], True,
                                  valid_fraction=0.25, minibatch_size=10),
            decision_config={"max_epochs": 3}, fused=True)
        w.initialize(device=TorchDevice("cpu"))
        assert w.step._dataset_dev is None
        w.run()
    finally:
        troot.common.engine.scan_epoch = False
    hist = [int(h["metric_validation"]) for h in w.decision.metrics_history]
    assert len(hist) == 3 and hist[-1] <= hist[0], hist


# -- snapshots ----------------------------------------------------------------

def _aug_resume_build(pkg, tree, snap_dir=None):
    """The reference's tests/test_loader_files.py:437 workflow: one
    softmax layer over full_batch_image with crops and mirrors."""
    (jprng if pkg == "jax" else tprng).seed_all(91)
    cfg = None if snap_dir is None else {
        "directory": str(snap_dir), "prefix": "a", "only_improved": False,
        "keep_all": True}
    w = (JStandard if pkg == "jax" else TStandard)(
        name="AugResume",
        layers=[{"type": "softmax", "->": {"output_sample_shape": 4},
                 "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}}],
        loss_function="softmax", loader_name="full_batch_image",
        loader_config=_config(tree, True, valid_fraction=0.25,
                              minibatch_size=10),
        decision_config={"max_epochs": 4}, snapshotter_config=cfg,
        fused=True)
    w.initialize(device=TPUDevice() if pkg == "jax" else TorchDevice("cpu"))
    return w


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_augmented_run_resumes_from_either_packages_snapshot(trees,
                                                             tmp_path,
                                                             writer):
    """The writer's uninterrupted 4-epoch run snapshots every epoch; the
    port restores its epoch-2 snapshot into a fresh workflow — the
    weights, the normalizer and the ``loader_augment`` stream are the
    snapshot's — and trains on: the same crops and mirrors, so the same
    history, and weights bit-identical to a port writer's (within 1e-6
    of the reference's)."""
    tree = trees["12x10"][1]
    full = _aug_resume_build(writer, tree, tmp_path)
    full.run()
    full.step.sync_to_units()
    assert len(full.decision.metrics_history) == 4
    path = str(tmp_path / "a_2.npz")
    with np.load(path, allow_pickle=False) as zf:
        meta = json.loads(str(zf["__meta__"]))
        snap = {k: zf[k] for k in zf.files if k != "__meta__"}
    assert "loader_augment" in meta["prng"]
    res = _aug_resume_build("port", tree)
    restore_state(res, path)
    np.testing.assert_array_equal(res.forwards[0].weights.map_read(),
                                  snap["forward.0.weights"])
    norm_meta, norm_arrays = res.loader.normalizer.state_dict()
    assert norm_meta == meta["loader"]["normalizer_meta"]
    for k, v in norm_arrays.items():
        np.testing.assert_array_equal(v, snap[f"loader.normalizer.{k}"])
    assert json.loads(json.dumps(tprng.get("loader_augment").state_dict())) \
        == meta["prng"]["loader_augment"]
    res.run()
    res.step.sync_to_units()
    assert res.decision.metrics_history == full.decision.metrics_history
    atol = 0 if writer == "port" else 1e-6
    for (name, attr, a), (_, _, b) in zip(_forward_weights(res),
                                          _forward_weights(full)):
        np.testing.assert_allclose(a, b, rtol=0, atol=atol,
                                   err_msg=f"{name}.{attr}")
