"""The port's character LM as a workflow (``loader/text.py``,
``loader/sequence.py``, ``units/lm.py``, ``models/char_lm.py``) against
the JAX reference, on the CPU in f32 at a small size (1 layer, d 32, 2
heads, seq_len 32, minibatch 16, over a slice of the synthesized corpus).

- The synthesized corpus files are byte-identical in both packages, and
  the bag-of-words loader over them serves the same rows.
- ``CharSequenceLoader`` serves identical tokens, labels and indices for
  every class over two epochs, and the port's producer fill
  (``fill_batch``) serves what its synchronous fill does.
- ``char_lm.build(max_epochs=2)`` from one seed in both packages, dense
  and MoE (4 experts, top-2, aux and z-loss): every minibatch's
  ``minibatch_mse`` within rtol 1e-4, the same stopping epoch, final
  params within 1e-5 (the bands of tests/test_torch_port_train.py).
- Pipelined (``pipeline_depth=2``) is bit-identical to synchronous.
- Snapshots cross both ways; a flavor or vocab mismatch raises.
- The port's export greedy-decodes the same tokens as the JAX export of
  the same weights; an MoE export raises.
- ``run(load, main)`` trains the builder's arguments from the config
  tree and exports with ``root.common.engine.lm_export``.

The JAX side runs on its CPU backend (head dim 16: its dense attention,
the flash kernel's reference); the port's blocks run the flash kernels'
plain versions."""

import os
import shutil

import numpy as np
import pytest
import torch

from znicz_tpu.core import prng as jprng
from znicz_tpu.core.backends import NumpyDevice as JNumpyDevice
from znicz_tpu.core.backends import TPUDevice
from znicz_tpu.loader import sequence as jsequence
from znicz_tpu.loader import text as jtext
from znicz_tpu.models import char_lm as jchar
from znicz_tpu.serve.kvcache import KVDecoder as JKVDecoder
from znicz_tpu.serve.kvcache import TokenSampler as JTokenSampler
from znicz_tpu.snapshotter import restore_state as jrestore
from znicz_tpu.utils.export import export_lm as jexport_lm
from znicz_tpu.utils.export import load_lm as jload_lm

from znicz_tpu_torch.core import prng as tprng
from znicz_tpu_torch.core.backends import NumpyDevice, TorchDevice
from znicz_tpu_torch.core.config import root as troot
from znicz_tpu_torch.launcher import Launcher
from znicz_tpu_torch.loader import sequence as tsequence
from znicz_tpu_torch.loader import text as ttext
from znicz_tpu_torch.loader.base import TRAIN
from znicz_tpu_torch.models import char_lm as tchar
from znicz_tpu_torch.parallel import transformer as tfm
from znicz_tpu_torch.serve.kvcache import KVDecoder, TokenSampler
from znicz_tpu_torch.snapshotter import restore_state
from znicz_tpu_torch.units.lm import TransformerLMStep
from znicz_tpu_torch.utils.export import load_lm

#: per-minibatch losses and final params, port vs reference (f32)
MSE_RTOL, PARAM_ATOL = 1e-4, 1e-5
SMALL = dict(seq_len=32, minibatch_size=16, n_layers=1, d=32, heads=2,
             lr=0.3)
MOE = dict(n_experts=4, moe_top_k=2, moe_aux_weight=0.01,
           moe_zloss_weight=1e-3)
#: corpus lines of each split kept for the workflow runs
TRAIN_LINES, TEST_LINES = 24, 8


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The port's synthesized corpus, and a slice of it (its first lines
    of each split) the workflow runs read: 14-char vocab, 11 train, 1
    valid and 5 test minibatches an epoch."""
    root = tmp_path_factory.mktemp("corpus")
    full, small = str(root / "full"), str(root / "small")
    ttext.ensure_corpus_files(full, synthesize=True)
    os.makedirs(small)
    for split, n in (("train", TRAIN_LINES), ("test", TEST_LINES)):
        with open(os.path.join(full, ttext.FILES[split])) as f:
            lines = f.readlines()[:n]
        with open(os.path.join(small, ttext.FILES[split]), "w") as f:
            f.writelines(lines)
    return {"full": full, "small": small}


def test_corpus_files_are_byte_identical(corpus, tmp_path):
    jtext.ensure_corpus_files(str(tmp_path), synthesize=True)
    for name in (*ttext.FILES.values(), ".synth_version"):
        with open(os.path.join(corpus["full"], name), "rb") as f:
            ours = f.read()
        with open(os.path.join(str(tmp_path), name), "rb") as f:
            assert f.read() == ours, name
    assert ttext.SYNTH_VERSION == jtext.SYNTH_VERSION
    # a torn synthesis (a missing file) regenerates instead of serving
    os.remove(os.path.join(str(tmp_path), "test.txt"))
    ttext.ensure_corpus_files(str(tmp_path), synthesize=True)
    with open(os.path.join(str(tmp_path), "test.txt"), "rb") as f:
        with open(os.path.join(corpus["full"], "test.txt"), "rb") as g:
            assert f.read() == g.read()
    with pytest.raises(FileNotFoundError):
        ttext.ensure_corpus_files(str(tmp_path / "none"), synthesize=False)


def test_bag_of_words_loader_serves_the_reference_rows(corpus):
    kw = dict(data_dir=corpus["full"], vocab_size=64, n_train=120,
              n_valid=40, minibatch_size=20)
    jl = jtext.TextBagOfWordsLoader(None, **kw)
    tl = ttext.TextBagOfWordsLoader(None, **kw)
    jl.load_data()
    tl.load_data()
    assert tl.vocab == jl.vocab and tl.class_lengths == jl.class_lengths
    np.testing.assert_array_equal(tl.original_data.mem,
                                  jl.original_data.mem)
    np.testing.assert_array_equal(tl.original_labels.mem,
                                  jl.original_labels.mem)


def _serve(loader, epochs: int = 2, fill_batch: bool = False) -> list:
    """Every minibatch of ``epochs`` epochs: (class, indices, tokens,
    labels), and, with ``fill_batch``, the producer fill's rows of the
    same indices."""
    out = []
    while True:
        loader.run()
        row = (int(loader.minibatch_class),
               np.array(loader.minibatch_indices.mem),
               np.array(loader.minibatch_data.mem),
               np.array(loader.minibatch_labels.mem))
        if fill_batch:
            got = loader.fill_batch(row[1], int(loader.minibatch_size),
                                    row[0])
            np.testing.assert_array_equal(got["data"], row[2])
            np.testing.assert_array_equal(got["labels"], row[3])
        out.append(row)
        if loader.epoch_ended and loader.epoch_number >= epochs:
            return out


def test_char_sequence_loader_serves_the_reference_minibatches(corpus):
    kw = dict(data_dir=corpus["small"], seq_len=16, minibatch_size=8,
              valid_fraction=0.2)
    jprng.seed_all(3)
    jl = jsequence.CharSequenceLoader(None, **kw)
    jl.initialize(device=JNumpyDevice())
    tprng.seed_all(3)
    tl = tsequence.CharSequenceLoader(None, **kw)
    tl.initialize(device=NumpyDevice())
    assert tl.vocab == jl.vocab and tl.vocab_size == 14
    assert tl.class_lengths == jl.class_lengths
    want, got = _serve(jl), _serve(tl, fill_batch=True)
    assert len(got) == len(want)
    assert {r[0] for r in got} == {0, 1, 2}
    for g, w in zip(got, want):
        assert g[0] == w[0]
        for a, b in zip(g[1:], w[1:]):
            np.testing.assert_array_equal(a, b)


def _jax_run(data_dir, seed=7, **kw):
    jprng.seed_all(seed)
    w = jchar.build(max_epochs=2, data_dir=data_dir, **SMALL, **kw)
    w.initialize(device=TPUDevice())
    return w, _recorded(w)


def _port_run(data_dir, seed=7, **kw):
    tprng.seed_all(seed)
    w = tchar.build(max_epochs=2, data_dir=data_dir, **SMALL, **kw)
    w.initialize(device=TorchDevice("cpu"))
    return w, _recorded(w)


def _recorded(w) -> list:
    """The step's (class, minibatch_mse) after every run."""
    seen, run = [], w.step.run

    def recording():
        run()
        seen.append((int(w.loader.minibatch_class), w.step.minibatch_mse))
    w.step.run = recording
    return seen


def _numpy_params(params) -> dict:
    if isinstance(params["emb"], torch.Tensor):
        return tfm.params_to_numpy(params)
    return {"emb": np.asarray(params["emb"]),
            "head": np.asarray(params["head"]),
            "blocks": [{k: np.asarray(a) for k, a in blk.items()}
                       for blk in params["blocks"]]}


def _flat(params):
    p = _numpy_params(params)
    return [p["emb"], p["head"]] + [blk[k] for blk in p["blocks"]
                                    for k in sorted(blk)]


@pytest.mark.parametrize("flavor", ["dense", "moe"])
def test_char_lm_matches_jax(corpus, flavor):
    kw = MOE if flavor == "moe" else {}
    jw, jseen = _jax_run(corpus["small"], **kw)
    jw.run()
    tw, tseen = _port_run(corpus["small"], **kw)
    tw.run()
    assert [c for c, _ in tseen] == [c for c, _ in jseen]
    assert sum(c == TRAIN for c, _ in tseen) == 22
    np.testing.assert_allclose([m for _, m in tseen],
                               [m for _, m in jseen], rtol=MSE_RTOL)
    th, jh = tw.decision.metrics_history, jw.decision.metrics_history
    assert len(th) == len(jh) == 2 and bool(tw.decision.complete)
    assert th[-1]["metric_validation"] < th[0]["metric_validation"]
    for a, b in zip(_flat(tw.step._params), _flat(jw.step._params)):
        np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_ATOL)


def test_pipelined_run_is_bit_identical_to_sync(corpus):
    sync, sync_seen = _port_run(corpus["small"])
    sync.run()
    piped, piped_seen = _port_run(corpus["small"], pipeline_depth=2)
    try:
        piped.run()
    finally:
        piped.stop()
    assert piped.loader.pipeline is not None
    assert piped_seen == sync_seen
    for a, b in zip(_flat(piped.step._params), _flat(sync.step._params)):
        np.testing.assert_array_equal(a, b)


def _snapshotting(directory):
    return dict(snapshotter_config={"directory": directory, "prefix": "lm",
                                    "only_improved": False})


def _restored_matches(restored, source):
    """Params, loader cursor and shuffles, and the decision's history of
    a restored workflow equal its source's."""
    for a, b in zip(_flat(restored.step._params), _flat(source.step._params)):
        np.testing.assert_array_equal(a, b)
    assert restored.loader.vocab == source.loader.vocab
    assert restored.loader.epoch_number == source.loader.epoch_number
    for cls, order in source.loader._shuffled.items():
        np.testing.assert_array_equal(restored.loader._shuffled[cls], order)
    assert restored.decision.metrics_history == \
        source.decision.metrics_history


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_snapshots_cross_between_the_packages(corpus, tmp_path, writer):
    """A snapshot of one package's run restores into the other's fresh
    workflow (built from another seed), identical; both then evaluate a
    batch to the same loss."""
    snaps = str(tmp_path / "snaps")
    run, fresh = (_jax_run, _port_run) if writer == "jax" else \
        (_port_run, _jax_run)
    source, _ = run(corpus["small"], **_snapshotting(snaps))
    source.run()
    target, _ = fresh(corpus["small"], seed=99)
    (restore_state if writer == "jax" else jrestore)(
        target, os.path.join(snaps, "lm_2.npz"))
    _restored_matches(target, source)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, 14, (16, 32)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    mask = np.arange(16) < 12
    losses = [float(np.asarray(w.step._eval(w.step._params, tokens, labels,
                                            mask)))
              for w in (source, target)]
    np.testing.assert_allclose(losses[0], losses[1], rtol=MSE_RTOL)


def test_restore_refuses_another_flavor_or_vocab(corpus):
    dense, _ = _port_run(corpus["small"])
    moe, _ = _port_run(corpus["small"], **MOE)
    with pytest.raises(ValueError, match="FFN flavor"):
        moe.step.load_state_dict(dense.step.state_dict())
    with pytest.raises(ValueError, match="FFN flavor"):
        dense.step.load_state_dict(moe.step.state_dict())
    state = dense.step.state_dict()
    params = state["params"]
    wider = dict(params, emb=np.zeros((15, 32), np.float32),
                 head=np.zeros((32, 15), np.float32))
    with pytest.raises(ValueError, match="vocab"):
        dense.step.load_state_dict({"params": wider})
    deeper = dict(params, blocks=params["blocks"] * 2)
    with pytest.raises(ValueError, match="blocks"):
        dense.step.load_state_dict({"params": deeper})


def test_restore_into_an_initialized_step_keeps_its_tensors(corpus):
    """A restore copies into the live tensors (a captured graph reads
    them), and a step after it trains from the restored weights."""
    a, _ = _port_run(corpus["small"])
    b, _ = _port_run(corpus["small"], seed=8)
    live = b.step._params["emb"]
    b.step.load_state_dict(a.step.state_dict())
    assert b.step._params["emb"] is live
    for x, y in zip(_flat(b.step._params), _flat(a.step._params)):
        np.testing.assert_array_equal(x, y)


def test_export_decodes_like_the_jax_export_of_the_same_weights(
        corpus, tmp_path):
    w, _ = _port_run(corpus["small"])
    w.run()
    pkg = w.step.export_lm(str(tmp_path / "port.npz"))
    params, meta = load_lm(pkg)
    assert meta["charmap"] == w.loader.vocab and meta["name"] == "CharLM"
    jpkg = jexport_lm(_numpy_params(w.step._params),
                      str(tmp_path / "jax.npz"), heads=SMALL["heads"],
                      charmap=w.loader.vocab)
    jparams, jmeta = jload_lm(jpkg)
    assert jmeta["charmap"] == meta["charmap"]
    for a, b in zip(_flat(params), _flat(jparams)):
        np.testing.assert_array_equal(a, b)
    prompt = [w.loader.vocab.index(c) for c in "1\tw0"]
    ours = KVDecoder(params, heads=SMALL["heads"], max_len=64,
                     device="cpu").generate(prompt, 16,
                                            TokenSampler(temperature=0.0))
    theirs = JKVDecoder(jparams, heads=SMALL["heads"], max_len=64).generate(
        prompt, 16, JTokenSampler(temperature=0.0))
    assert ours == theirs and len(ours) == 16


def test_moe_export_raises_and_the_unit_refuses(corpus, tmp_path):
    moe, _ = _port_run(corpus["small"], **MOE)
    with pytest.raises(ValueError, match="MoE"):
        moe.step.export_lm(str(tmp_path / "moe.npz"))
    with pytest.raises(ValueError, match="n_experts"):
        TransformerLMStep(None, moe_top_k=2)
    step = TransformerLMStep(None, loader=moe.loader)
    with pytest.raises(NotImplementedError):
        step.initialize(device=NumpyDevice())
    with pytest.raises(NotImplementedError, match="item 14"):
        TransformerLMStep(None, loader=moe.loader, anatomy=True).initialize(
            device=TorchDevice("cpu"))
    with pytest.raises(ValueError, match="initialized"):
        TransformerLMStep(None, loader=moe.loader).export_lm(
            str(tmp_path / "x.npz"))


def test_run_trains_the_configured_builder_and_exports(corpus, tmp_path):
    """``run(load, main)`` as the CLI drives it: the builder's arguments
    from ``root.char_lm``, the package from
    ``root.common.engine.lm_export``."""
    pkg = str(tmp_path / "lm.npz")
    data = str(tmp_path / "corp")
    shutil.copytree(corpus["small"], data)
    troot.char_lm.update(dict(SMALL, max_epochs=1, data_dir=data))
    troot.common.engine.lm_export = pkg
    try:
        tprng.seed_all(7)
        launcher = Launcher(device=TorchDevice("cpu"))
        tchar.run(launcher.load, launcher.main)
    finally:
        del troot.char_lm
        troot.common.engine.lm_export = ""
    w = launcher.workflow
    assert len(w.decision.metrics_history) == 1
    assert w.step.d == SMALL["d"] and w.loader.seq_len == SMALL["seq_len"]
    params, meta = load_lm(pkg)
    for a, b in zip(_flat(params), _flat(w.step._params)):
        np.testing.assert_array_equal(a, b)
