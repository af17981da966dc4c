"""Step anatomy, flops and the trace tools of the port
(``znicz_tpu_torch/observe/anatomy.py``, ``utils/flops.py``,
``utils/profiling.py``, ``observe/flight.py``'s viewer and
``observe/federation.py``) against the JAX package on the CPU:

- the accountant: the reference's stamp, pre-touch and probe-gate cases
  (``tests/test_anatomy.py:28-103``) with the same registry keys;
- fused MNIST FC with ``anatomy=True``: weights and n_err history
  bit-identical to the port's own fused step (the anatomy mode runs the
  same torch calls in the same order, cut at the seams), within the MNIST
  FC band (SGD 1e-6) of the JAX package's anatomy run, phase sums within
  10 % of the step wall (``:104-150``), the reference's refusal of
  accumulation in its words, and ``shard_params`` on a gloo world of 2
  (a ``zero_gather`` phase; weights within the band of the JAX anatomy
  run on a mesh of 2);
- the transformer's anatomy step against the JAX anatomy step
  (``:183-229``): losses within rtol 1e-4 / atol 1e-5, params within
  1e-5; the LM unit's ``stage`` phase;
- ``forward_flops`` / ``train_step_flops`` equal to the reference's for
  MNIST FC, AlexNet at 67 px and the conv AE; ``peak_flops`` honours the
  env and is None on the CPU;
- a CPU ``--profile`` run of MNIST FC writes a Chrome trace whose
  summary lists ``aten::`` rows; ``compare_traces``' one-sided family
  case (``tests/test_profiling.py:23-51``);
- ``flight_main`` prints an artifact the port dumped, as the reference's
  viewer does; ``merge_traces`` / ``fleet_trace_main`` and
  ``parse_prometheus`` / ``inject_rank`` give the reference's output
  exactly on the port's documents.
"""

import json
import os

import numpy as np
import pytest

import _torch_dp_world as world
from znicz_tpu.core import prng as jprng
from znicz_tpu.core.backends import TPUDevice
from znicz_tpu.models import alexnet as jalexnet
from znicz_tpu.models import autoencoder as jautoencoder
from znicz_tpu.models import mnist_fc as jmnist
from znicz_tpu.observe import anatomy as janatomy
from znicz_tpu.observe import federation as jfed
from znicz_tpu.observe import flight as jflight
from znicz_tpu.observe import registry as jregistry
from znicz_tpu.parallel import transformer as jtfm
from znicz_tpu.parallel.mesh import data_parallel_mesh as jmesh
from znicz_tpu.parallel.mesh import make_mesh
from znicz_tpu.utils import flops as jflops

from znicz_tpu_torch.core import prng as tprng
from znicz_tpu_torch.core.backends import TorchDevice
from znicz_tpu_torch.launcher import Launcher
from znicz_tpu_torch.models import alexnet as talexnet
from znicz_tpu_torch.models import autoencoder as tautoencoder
from znicz_tpu_torch.models import mnist_fc as tmnist
from znicz_tpu_torch.observe import anatomy as tanatomy
from znicz_tpu_torch.observe import federation as tfed
from znicz_tpu_torch.observe import flight as tflight
from znicz_tpu_torch.observe import probe as tprobe
from znicz_tpu_torch.observe import registry as tregistry
from znicz_tpu_torch.observe.trace import Tracer
from znicz_tpu_torch.parallel import transformer as tfm
from znicz_tpu_torch.units.nn_units import load_forward_params
from znicz_tpu_torch.utils import flops as tflops
from znicz_tpu_torch.utils import profiling

#: MNIST FC, the port's fused step against the JAX package's: the SGD
#: band in force (tests/test_torch_port_mnist.py WEIGHT_ATOL)
WEIGHT_ATOL = 1e-6
#: per-step transformer losses and params after the steps: the port's
#: transformer bands (tests/test_torch_port_train.py)
LOSS_RTOL, LOSS_ATOL, PARAM_ATOL = 1e-4, 1e-5, 1e-5
#: phase sums against the step wall (tests/test_anatomy.py:140)
RECONCILE = 0.10

#: tests/test_anatomy.py:106's run without its mesh and codec
FUSED = dict(seed=31, layers=(32,), minibatch=16, n_train=96, n_valid=32,
             epochs=2)


def _flat(registry, **kw):
    return registry.REGISTRY.snapshot_flat(skip_zero=False, **kw)


# -- the accountant -----------------------------------------------------------

def _stamped(anatomy, registry, plane):
    anat = anatomy.StepAnatomy(plane, anatomy.TRAIN_PHASES)
    pre = {k: v for k, v in _flat(registry).items() if plane in k}
    anat.set_flops(2e8)
    t0 = anat.begin()
    for phase, at in zip(anatomy.TRAIN_PHASES, (0.10, 0.60, 0.75, 0.80)):
        anat.stamp(phase, now=t0 + at)
    assert anat.finish() >= 0.0
    return pre, {k: v for k, v in _flat(registry).items() if plane in k}


def test_step_anatomy_stamps_and_pretouch(monkeypatch):
    """The reference's accountant case on both packages: every child at
    0 at construction, the injected phase boundaries charged, one step
    counted, the MFU gauge set — under the same registry keys."""
    monkeypatch.setenv("ZNICZ_TPU_PEAK_FLOPS", "1e9")
    tpre, tpost = _stamped(tanatomy, tregistry, "anat_port")
    jpre, jpost = _stamped(janatomy, jregistry, "anat_port")
    assert set(tpre) == set(jpre) and set(tpost) == set(jpost)
    assert tpre['znicz_anatomy_steps_total{plane="anat_port"}'] == 0.0
    assert tpre['znicz_anatomy_mfu{plane="anat_port"}'] == 0.0
    for phase, want in zip(tanatomy.TRAIN_PHASES, (0.10, 0.50, 0.15, 0.05)):
        key = ('znicz_anatomy_phase_seconds_sum'
               f'{{plane="anat_port",phase="{phase}"}}')
        assert tpre[key] == 0.0
        assert tpost[key] == pytest.approx(want)
        assert tpost[key] == pytest.approx(jpost[key])
    assert tpost['znicz_anatomy_steps_total{plane="anat_port"}'] == 1.0
    assert tpost['znicz_anatomy_mfu{plane="anat_port"}'] > 0.0
    assert tanatomy.PHASES == janatomy.PHASES


def test_observe_phase_respects_probe_gate():
    key = 'znicz_anatomy_phase_seconds_count{plane="gated",phase="stage"}'
    tprobe.set_enabled(False)
    try:
        before = _flat(tregistry).get(key, 0.0)
        tprobe.anatomy_phase("gated", "stage", 0.5)
        assert _flat(tregistry).get(key, 0.0) == before
    finally:
        tprobe.set_enabled(True)
    tprobe.anatomy_phase("gated", "stage", 0.5)
    assert _flat(tregistry)[key] == before + 1.0


# -- the fused producer -------------------------------------------------------

def _jax_fused(anatomy, n=1, **kw):
    jprng.seed_all(FUSED["seed"])
    w = jmnist.build_fused(
        max_epochs=FUSED["epochs"], layers=FUSED["layers"],
        minibatch_size=FUSED["minibatch"], n_train=FUSED["n_train"],
        n_valid=FUSED["n_valid"], mesh=jmesh(n), anatomy=anatomy, **kw)
    w.initialize(device=TPUDevice())
    init = {"params": [{"w": f.weights.map_read().copy(),
                        "b": f.bias.map_read().copy()} for f in w.forwards],
            "state": jprng.get().state_dict()}
    w.run()
    return w, init


def _port_fused(anatomy, init=None, **kw):
    tprng.seed_all(FUSED["seed"])
    kw.setdefault("max_epochs", FUSED["epochs"])
    w = tmnist.build_fused(
        layers=FUSED["layers"],
        minibatch_size=FUSED["minibatch"], n_train=FUSED["n_train"],
        n_valid=FUSED["n_valid"], anatomy=anatomy, **kw)
    if init is not None:
        load_forward_params(w.forwards, init["params"])
    w.initialize(device=TorchDevice("cpu"))
    if init is not None:
        tprng.get().load_state_dict(init["state"])
    w.run()
    return w


def _weights(w):
    w.step.sync_to_units()
    return [np.asarray(a.map_read()).copy() for f in w.forwards
            for a in (f.weights, f.bias)]


def _hist(w):
    return [(h.get("metric_train"), h.get("metric_validation"))
            for h in w.decision.metrics_history]


@pytest.fixture(scope="module")
def fused_runs(cpu_devices):
    """The JAX anatomy run, and the port's anatomy and plain runs from
    its initial weights, with the port's anatomy registry deltas."""
    jw, init = _jax_fused(True)
    before = _flat(tregistry)
    anat = _port_fused(True, init)
    after = _flat(tregistry)
    plain = _port_fused(False, init)
    delta = {k: after[k] - before.get(k, 0.0) for k in after
             if k.startswith("znicz_anatomy_") and 'plane="fused"' in k}
    return {"jax": (_hist(jw), _weights(jw)),
            "anatomy": (_hist(anat), _weights(anat)),
            "plain": (_hist(plain), _weights(plain)), "delta": delta,
            "init": init}


def test_fused_anatomy_bit_identical_to_the_fused_step(fused_runs):
    hist, weights = fused_runs["anatomy"]
    phist, pweights = fused_runs["plain"]
    assert hist == phist and len(hist) == FUSED["epochs"]
    for got, want in zip(weights, pweights):
        np.testing.assert_array_equal(got, want)


def test_fused_anatomy_matches_jax_anatomy(fused_runs):
    hist, weights = fused_runs["anatomy"]
    jhist, jweights = fused_runs["jax"]
    assert hist == jhist
    for got, want in zip(weights, jweights):
        np.testing.assert_allclose(got, want, rtol=0, atol=WEIGHT_ATOL)


def test_fused_anatomy_phase_sum_matches_step_wall(fused_runs, monkeypatch):
    """Every train minibatch is one step of the accountant; its grad,
    collective and update phases sum to the step wall within 10 %, and
    the MFU gauge reads against a pinned nominal peak."""
    delta = fused_runs["delta"]
    steps = delta['znicz_anatomy_steps_total{plane="fused"}']
    assert steps == FUSED["epochs"] * FUSED["n_train"] // FUSED["minibatch"]
    phase_sum = sum(v for k, v in delta.items() if k.startswith(
        'znicz_anatomy_phase_seconds_sum{plane="fused"'))
    step_sum = delta['znicz_anatomy_step_seconds_sum{plane="fused"}']
    assert step_sum > 0.0
    assert abs(phase_sum - step_sum) <= RECONCILE * step_sum, \
        (phase_sum, step_sum)
    for phase in ("grad", "collective", "update"):
        assert delta['znicz_anatomy_phase_seconds_count'
                     f'{{plane="fused",phase="{phase}"}}'] == steps
    assert delta['znicz_anatomy_phase_seconds_count'
                 '{plane="fused",phase="zero_gather"}'] == 0
    monkeypatch.setenv("ZNICZ_TPU_PEAK_FLOPS", "1e12")
    _port_fused(True, fused_runs["init"], max_epochs=1)
    assert _flat(tregistry)['znicz_anatomy_mfu{plane="fused"}'] > 0.0


def test_fused_anatomy_refuses_accumulation_in_the_reference_words():
    msgs = []
    for build, seed, dev in ((jmnist.build_fused, jprng, TPUDevice()),
                             (tmnist.build_fused, tprng,
                              TorchDevice("cpu"))):
        seed.seed_all(5)
        w = build(max_epochs=1, layers=(16,), minibatch_size=16,
                  n_train=64, n_valid=16, anatomy=True, accumulate_steps=2)
        with pytest.raises(ValueError, match="accumulate") as exc:
            w.initialize(device=dev)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


def test_fused_anatomy_shard_params_world_of_two(cpu_devices):
    """shard_params on a gloo world of 2: every step charges a
    zero_gather phase, and both ranks' weights sit within the MNIST FC
    band of the JAX anatomy run on a mesh of 2."""
    jw, init = _jax_fused(True, n=2, shard_params=True)
    case = dict(fn="mnist_anatomy", seed=FUSED["seed"],
                layers=FUSED["layers"], minibatch=FUSED["minibatch"],
                n_train=FUSED["n_train"], n_valid=FUSED["n_valid"],
                epochs=FUSED["epochs"], layout="shard_params", init="a31",
                host_fed=True)
    ranks = world.run_world(2, [case], {"a31": init})
    steps = FUSED["epochs"] * FUSED["n_train"] // FUSED["minibatch"]
    for (out,) in ranks:
        assert out["anatomy"]['znicz_anatomy_phase_seconds_count'
                              '{plane="fused",phase="zero_gather"}'] == steps
        assert out["hist"] == _hist(jw)
        for got, want in zip(out["w"], _weights(jw)):
            np.testing.assert_allclose(got, want, rtol=0, atol=WEIGHT_ATOL)


# -- the transformer producer -------------------------------------------------

def test_transformer_anatomy_matches_jax_anatomy(cpu_devices, monkeypatch):
    """tests/test_anatomy.py:183's case: the JAX anatomy step on a data
    mesh of 2 applies the true batch-mean gradient, which the port's
    anatomy step on one device computes; losses and params held within
    the transformer bands, every train phase charged, the MFU gauge
    set."""
    monkeypatch.setenv("ZNICZ_TPU_PEAK_FLOPS", "1e12")
    n_layers, d, heads, ff, vocab = 1, 16, 2, 32, 11
    params = tfm.init_params(np.random.default_rng(7), n_layers, d, heads,
                             ff, vocab)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, vocab, (4, 8)).astype(np.int32)
    labels = ((tokens + 1) % vocab).astype(np.int32)
    jstep, _ = jtfm.make_train_step(
        make_mesh({"data": 2, "seq": 1, "model": 1}), n_layers, d, heads,
        ff, vocab, lr=0.1, anatomy=True)
    tstep = tfm.make_train_step(None, n_layers, d, heads, ff, vocab, lr=0.1,
                                anatomy=True, device="cpu")
    jp = {"emb": params["emb"].copy(), "head": params["head"].copy(),
          "blocks": [{k: a.copy() for k, a in b.items()}
                     for b in params["blocks"]]}
    tp = tfm.params_from_numpy(params, "cpu")
    before = _flat(tregistry)
    jl, tl = [], []
    for _ in range(5):
        jp, jloss = jstep(jp, tokens, labels)
        tp, tloss = tstep(tp, tokens, labels)
        jl.append(float(jloss))
        tl.append(float(tloss))
    assert tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    ours = tfm.params_to_numpy(tp)
    for key in ("emb", "head"):
        np.testing.assert_allclose(ours[key], np.asarray(jp[key]), rtol=0,
                                   atol=PARAM_ATOL)
    for ob, jb in zip(ours["blocks"], jp["blocks"]):
        for k in ob:
            np.testing.assert_allclose(ob[k], np.asarray(jb[k]), rtol=0,
                                       atol=PARAM_ATOL)
    flat = _flat(tregistry)
    for phase in ("grad", "collective", "update"):
        key = ('znicz_anatomy_phase_seconds_count'
               f'{{plane="transformer",phase="{phase}"}}')
        assert flat[key] - before.get(key, 0.0) == 5
    assert flat['znicz_anatomy_mfu{plane="transformer"}'] > 0.0


def test_lm_unit_anatomy_stages_and_steps(tmp_path):
    """TransformerLMStep(anatomy=True) on the char LM: the synchronous
    path's staging lands as the plane's ``stage`` phase and every train
    minibatch as one anatomy step."""
    from znicz_tpu_torch.loader import text as ttext
    from znicz_tpu_torch.models import char_lm

    full, small = str(tmp_path / "full"), str(tmp_path / "small")
    ttext.ensure_corpus_files(full, synthesize=True)
    os.makedirs(small)
    for split in ("train", "test"):
        with open(os.path.join(full, ttext.FILES[split])) as f:
            lines = f.readlines()[:20]
        with open(os.path.join(small, ttext.FILES[split]), "w") as f:
            f.writelines(lines)
    key = ('znicz_anatomy_phase_seconds_count'
           '{plane="transformer",phase="stage"}')
    steps_key = 'znicz_anatomy_steps_total{plane="transformer"}'
    before = _flat(tregistry)
    tprng.seed_all(3)
    w = char_lm.build(max_epochs=1, seq_len=16, minibatch_size=8,
                      n_layers=1, d=32, heads=2, data_dir=small)
    w.step.anatomy = True
    w.initialize(device=TorchDevice("cpu"))
    w.run()
    flat = _flat(tregistry)
    staged = flat[key] - before.get(key, 0.0)
    stepped = flat[steps_key] - before.get(steps_key, 0.0)
    assert stepped >= 1 and staged >= stepped


# -- flops --------------------------------------------------------------------

def _initialized(jbuild, tbuild, **kw):
    jprng.seed_all(3)
    jw = jbuild(**kw)
    jw.initialize(device=TPUDevice())
    tprng.seed_all(3)
    tw = tbuild(**kw)
    tw.initialize(device=TorchDevice("cpu"))
    return jw, tw


@pytest.mark.parametrize("name", ["mnist_fc", "alexnet67", "conv_ae"])
def test_flops_equal_the_reference(name):
    jw, tw = {
        "mnist_fc": lambda: _initialized(
            jmnist.build_fused, tmnist.build_fused, layers=(64, 32),
            minibatch_size=16, n_train=32, n_valid=0),
        "alexnet67": lambda: _initialized(
            jalexnet.build, talexnet.build, input_size=67, n_train=50,
            minibatch_size=4),
        "conv_ae": lambda: _initialized(
            jautoencoder.build, tautoencoder.build, n_train=10, n_valid=0,
            minibatch_size=5)}[name]()
    batch = int(tw.loader.max_minibatch_size)
    assert [tflops.forward_flops(f, batch) for f in tw.forwards] == \
        [jflops.forward_flops(f, batch) for f in jw.forwards]
    got = tflops.train_step_flops(tw.forwards, batch)
    assert got > 0.0 and got == jflops.train_step_flops(jw.forwards, batch)


def test_peak_flops_env_and_cpu(monkeypatch):
    monkeypatch.delenv(tflops.PEAK_FLOPS_ENV, raising=False)
    assert tflops.peak_flops("cpu") is None
    assert tflops.mfu(100.0, [], 10, device="cpu") is None
    monkeypatch.setenv(tflops.PEAK_FLOPS_ENV, "2.5e12")
    assert tflops.peak_flops() == 2.5e12
    assert tflops.peak_flops("cpu") == 2.5e12
    monkeypatch.setenv(tflops.PEAK_FLOPS_ENV, "garbage")
    assert tflops.peak_flops("cpu") is None


# -- profiling ----------------------------------------------------------------

def test_profile_run_writes_a_trace_with_aten_rows(tmp_path):
    """``Launcher(profile_dir=...)`` — what ``--profile`` builds — around
    an eager MNIST FC run on the CPU: a Chrome trace in a run directory
    of its own, summarized into ``aten::`` rows."""
    prof = tmp_path / "prof"
    tprng.seed_all(3)
    launcher = Launcher(device=TorchDevice("cpu"), profile_dir=str(prof))
    launcher.load(tmnist.build_eager, max_epochs=1, layers=(16,),
                  minibatch_size=8, n_train=16, n_valid=8)
    launcher.main()
    runs = os.listdir(prof)
    assert len(runs) == 1
    assert [f for f in os.listdir(prof / runs[0])
            if f.endswith(".pt.trace.json")]
    rows = profiling.summarize_trace(str(prof), top=None)
    assert rows and any(r["op"].startswith("aten::") for r in rows)
    assert all(r["count"] >= 1 and r["total_ms"] >= 0.0 for r in rows)
    assert "total_ms" in profiling.format_summary(rows[:5])
    same = profiling.compare_traces(str(prof), str(prof))
    assert same and all(r["delta_ms"] == 0.0 for r in same)


def test_compare_traces_one_sided_category(monkeypatch):
    """tests/test_profiling.py:23's case on the port's families: a
    family present in only one trace diffs with its missing side at 0.0,
    in both directions, sorted by |delta|."""
    sides = {
        "dir_a": [{"op": "void sgd_kernel<float>(float*)", "total_ms": 3.0},
                  {"op": "aten::mm", "total_ms": 2.0}],
        "dir_b": [{"op": "void sgd_kernel<__nv_bfloat16>(float*)",
                   "total_ms": 1.5},
                  {"op": "ncclDevKernel_AllReduce_Sum_f32", "total_ms": 4.0}],
    }
    monkeypatch.setattr(profiling, "summarize_trace",
                        lambda logdir, top=None: sides[logdir])
    by_cat = {r["category"]: r for r in profiling.compare_traces("dir_a",
                                                                 "dir_b")}
    assert by_cat["sgd"] == {"category": "sgd", "a_ms": 3.0, "b_ms": 1.5,
                             "delta_ms": -1.5}
    assert by_cat["aten"]["b_ms"] == 0.0
    assert by_cat["aten"]["delta_ms"] == -2.0
    assert by_cat["nccl"]["a_ms"] == 0.0
    assert by_cat["nccl"]["delta_ms"] == 4.0
    rows = profiling.compare_traces("dir_a", "dir_b")
    assert rows[0]["category"] == "nccl"


def test_kernel_families():
    cat = profiling._category
    assert cat("void gemm_f32_kernel<64, 128, true>(...)") == "gemm_fc"
    assert cat("void act_backward_f32_kernel<1>(float const*)") == \
        "act_backward"
    assert cat("void lrn_fwd_quad_kernel(float const*)") == "lrn"
    assert cat("flash_fwd_bf16") == "flash"
    assert cat("sm90_xmma_gemm_f32f32_tf32f32") == "cublas"
    assert cat("cudnn::winograd::generateWinogradTilesKernel") == "cudnn"
    assert cat("aten::addmm") == "aten"


# -- flight, traces and federation -------------------------------------------

def test_flight_main_prints_a_port_artifact(tmp_path, capsys):
    path = tflight.dump(str(tmp_path), reason="port_probe",
                        extra={"step": 3})
    assert tflight.flight_main([path]) == 0
    ours = capsys.readouterr().out
    assert "flight: port_probe" in ours and '"step": 3' in ours
    # the reference's viewer renders the port's artifact the same way
    jflight.print_flight(tflight.load(path))
    assert capsys.readouterr().out == ours
    assert tflight.flight_main([path, "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["reason"] == "port_probe"
    assert tflight.flight_main([str(tmp_path / "missing.json")]) == 1


def _trace_docs():
    docs = []
    for rank in (0, 1):
        tracer = Tracer()
        with tracer.span("step", rank=rank):
            pass
        tracer.instant("mark", rank=rank)
        doc = tracer.export_dict()
        doc["rank"] = rank
        doc["origin_unix_ts"] += 0.25 * rank
        docs.append(doc)
    return docs


def test_merge_traces_and_fleet_trace_main_match_the_reference(tmp_path):
    docs = _trace_docs()
    assert tfed.merge_traces(docs) == jfed.merge_traces(docs)
    srcs = []
    for i, doc in enumerate(docs):
        srcs.append(str(tmp_path / f"r{i}.json"))
        with open(srcs[-1], "w") as f:
            json.dump(doc, f)
    outs = []
    for main, name in ((tfed.fleet_trace_main, "port.json"),
                       (jfed.fleet_trace_main, "ref.json")):
        assert main(["-o", str(tmp_path / name), *srcs]) == 0
        with open(tmp_path / name) as f:
            outs.append(json.load(f))
    assert outs[0] == outs[1]
    assert {e.get("pid") for e in outs[0]["traceEvents"]} >= {0, 1}


def test_parse_prometheus_and_inject_rank_match_the_reference():
    tanatomy.StepAnatomy("federated", tanatomy.TRAIN_PHASES)
    text = tregistry.REGISTRY.render_prometheus()
    assert "znicz_anatomy_step_seconds" in text
    assert tfed.parse_prometheus(text) == jfed.parse_prometheus(text)
    for line in text.splitlines():
        if line and not line.startswith("#"):
            inner = line.split(" ")[0]
            inner = inner[inner.index("{") + 1:-1] if "{" in inner else ""
            assert tfed.inject_rank(inner, 3) == jfed.inject_rank(inner, 3)


def test_trace_shorthand_runs_and_exports_the_timeline(tmp_path,
                                                       monkeypatch):
    """``python -m znicz_tpu_torch trace OUT wf.py ...`` is ``wf.py ...
    --trace OUT``, as the reference's shorthand: the run's span
    timeline lands in OUT."""
    from znicz_tpu_torch import __main__ as cli

    monkeypatch.setenv("ZNICZ_TPU_ELASTIC_EPOCHS", "1")
    monkeypatch.delenv("ZNICZ_TPU_SNAP_DIR", raising=False)
    out = tmp_path / "run.json"
    drill = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "znicz_tpu_torch", "models",
        "elastic_drill.py")
    assert cli.main(["trace", str(out), drill, "-d", "cpu"]) == 0
    with open(out) as f:
        doc = json.load(f)
    assert any(e.get("ph") == "X" for e in doc["traceEvents"])
