"""The port's forward-package serving plane against the JAX package's, on
the CPU: ``utils/export.py`` (``export_forward`` / ``ExportedForward``),
``serve/engine.py``, ``serve/batcher.py``, ``serve/metrics.py
ServingMetrics``, ``serve/server.py ServeServer`` and the ``serve`` CLI.

- Packages cross both ways: a package the port writes loads in the
  reference's ``ExportedForward`` and one the reference writes loads in
  the port's; the same seeded inputs give outputs within 1e-5 and the
  same argmax, for a small FC net and a conv stack with LRN and max
  pooling at 16x16 px.  The two writers' meta blocks are the same bytes.
- The engine, batcher, metrics and server tests are the counterparts of
  ``tests/test_serve.py``.  Where the reference lets two requests
  coalesce by sleeping, these hold the model on an event and release it
  once the queue holds what the test needs, so no outcome rides on a
  sleep's length; a sleep only ever outlasts a deadline.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from znicz_tpu.core import prng as jprng
from znicz_tpu.core.backends import TPUDevice
from znicz_tpu.standard_workflow import StandardWorkflow as JWorkflow
from znicz_tpu.utils import export as jexport

from znicz_tpu_torch.core import prng as tprng
from znicz_tpu_torch.core.backends import TorchDevice
from znicz_tpu_torch.serve.batcher import (DeadlineExceeded, MicroBatcher,
                                           QueueFull)
from znicz_tpu_torch.serve.engine import BatchEngine, bucket_sizes
from znicz_tpu_torch.serve.metrics import ServingMetrics
from znicz_tpu_torch.serve.server import ServeServer
from znicz_tpu_torch.standard_workflow import StandardWorkflow as TWorkflow
from znicz_tpu_torch.utils import export as texport

#: the two nets whose packages cross: (layers, loader name, loader config)
NETS = {
    "fc": ([{"type": "all2all_tanh", "->": {"output_sample_shape": 8}},
            {"type": "softmax", "->": {"output_sample_shape": 3}}],
           "synthetic_classifier",
           {"n_classes": 3, "sample_shape": (6,), "n_train": 40,
            "n_valid": 0, "minibatch_size": 20}),
    "conv_lrn_pool": (
        [{"type": "conv_str", "->": {"n_kernels": 8, "kx": 3, "ky": 3,
                                     "padding": (1, 1, 1, 1)}},
         {"type": "norm", "->": {"alpha": 1e-4, "beta": 0.75, "k": 2.0,
                                 "n": 5}},
         {"type": "max_pooling", "->": {"kx": 2, "ky": 2,
                                        "sliding": (2, 2)}},
         {"type": "all2all_tanh", "->": {"output_sample_shape": 16}},
         {"type": "softmax", "->": {"output_sample_shape": 4}}],
        "synthetic_image",
        {"n_classes": 4, "sample_shape": (16, 16, 3), "n_train": 16,
         "n_valid": 0, "minibatch_size": 8}),
}
#: the cross-package band: both run the same f32 forward on the CPU
CROSS_ATOL = 1e-5


def _workflow(cls, net, name="Served", **kw):
    layers, loader, cfg = NETS[net]
    return cls(name=name, loss_function="softmax", layers=layers,
               loader_name=loader, loader_config=dict(cfg),
               decision_config={"max_epochs": 1}, **kw)


def _port_package(tmp_path, net, seed=23, **kw):
    tprng.seed_all(seed)
    w = _workflow(TWorkflow, net, **kw)
    w.initialize(device=TorchDevice("cpu"))
    return texport.export_forward(w, str(tmp_path / f"port_{net}.npz")), w


def _ref_package(tmp_path, net, seed=23):
    jprng.seed_all(seed)
    w = _workflow(JWorkflow, net)
    w.initialize(device=TPUDevice())
    return jexport.export_forward(w, str(tmp_path / f"ref_{net}.npz"))


def _inputs(shape, n=5, seed=0):
    return np.random.default_rng(seed).normal(
        size=(n,) + tuple(shape)).astype(np.float32)


@pytest.mark.parametrize("net", sorted(NETS))
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_packages_cross_both_ways(tmp_path, net, writer):
    path = (_port_package(tmp_path, net)[0] if writer == "port"
            else _ref_package(tmp_path, net))
    ref = jexport.ExportedForward(path, aot=False)
    port = texport.ExportedForward(path, device="cpu")
    assert port.input_shape == ref.input_shape
    assert port.compute_dtype == torch.float32
    x = _inputs(port.input_shape)
    want = np.asarray(ref(x))
    got = port(x)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=CROSS_ATOL)
    np.testing.assert_array_equal(got.argmax(axis=1), want.argmax(axis=1))
    np.testing.assert_array_equal(port.eager(x), got)


@pytest.mark.parametrize("net", sorted(NETS))
def test_the_port_writes_the_references_format(tmp_path, net):
    """The same layers give the same ``__arch__`` bytes and the same
    entries (names, shapes, dtypes) from both writers."""
    ours, _ = _port_package(tmp_path, net)
    theirs = _ref_package(tmp_path, net)
    with np.load(ours) as a, np.load(theirs) as b:
        assert str(a["__arch__"]) == str(b["__arch__"])
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype


def test_export_use_ema_ships_the_mirrors(tmp_path):
    tprng.seed_all(5)
    w = _workflow(TWorkflow, "fc", fused=True, ema_decay=0.5)
    w.initialize(device=TorchDevice("cpu"))
    w.run()
    path = texport.export_forward(w, str(tmp_path / "ema.npz"),
                                  use_ema=True)
    ema = w.step.ema_params()
    with np.load(path) as z:
        assert json.loads(str(z["__arch__"]))["ema"] is True
        for i, leaf in enumerate(ema):
            np.testing.assert_array_equal(z[f"{i}.weights"], leaf["w"])
            np.testing.assert_array_equal(z[f"{i}.bias"], leaf["b"])
    with pytest.raises(ValueError, match="ema_decay"):
        texport.export_forward(_workflow(TWorkflow, "fc"),
                               str(tmp_path / "x.npz"), use_ema=True)
    with pytest.raises(ValueError, match="ahead-of-time"):
        texport.export_forward(w, str(tmp_path / "y.npz"), aot_max_batch=8)


def test_aot_entries_load_and_are_ignored(tmp_path):
    """A reference package with ``__aot__`` entries (the reference's
    ``attach_aot`` writes them; faked here, the port never reads them)
    serves as the same package without them."""
    path, _ = _port_package(tmp_path, "fc")
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    aot = str(tmp_path / "aot.npz")
    np.savez_compressed(aot, __aot__1=np.arange(7, dtype=np.uint8),
                        __aot__2=np.arange(3, dtype=np.uint8), **arrays)
    port = texport.ExportedForward(aot, device="cpu")
    assert port.ignored_aot == ["__aot__1", "__aot__2"]
    x = _inputs(port.input_shape)
    np.testing.assert_array_equal(
        port(x), texport.ExportedForward(path, device="cpu")(x))


def test_exported_forward_refusals(tmp_path):
    lm = str(tmp_path / "lm.npz")
    np.savez_compressed(lm, __arch__=np.array(json.dumps(
        {"format": "znicz_tpu.lm/1"})))
    with pytest.raises(ValueError, match="not a forward package"):
        texport.ExportedForward(lm, device="cpu")
    path, _ = _port_package(tmp_path, "fc")
    f = texport.ExportedForward(path, device="cpu")
    with pytest.raises(ValueError, match="input shape"):
        f(np.zeros((2, 7), np.float32))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            texport.ExportedForward(path)


# -- engine -------------------------------------------------------------------

class RecordingModel:
    """``x * 2`` callable that records every batch shape it executes;
    with ``gate`` its calls wait on that event, and ``entered`` is set
    once a call has begun."""

    def __init__(self, input_shape=(3,), gate=None, delay_s=0.0) -> None:
        self.shapes = []
        self.input_shape = tuple(input_shape)
        self.meta = {"name": "recording"}
        self.gate = gate
        self.delay_s = delay_s
        self.entered = threading.Event()

    def __call__(self, x):
        self.shapes.append(np.asarray(x).shape)
        self.entered.set()
        if self.gate is not None:
            assert self.gate.wait(30)
        if self.delay_s:
            time.sleep(self.delay_s)
        return np.asarray(x) * 2.0


def make_batcher(max_batch=8, max_wait_ms=1.0, gate=None, delay_s=0.0,
                 **kw):
    model = RecordingModel(gate=gate, delay_s=delay_s)
    engine = BatchEngine(model, max_batch=max_batch)
    return MicroBatcher(engine, max_wait_ms=max_wait_ms, **kw), model


def _wait_for(cond, what, timeout_s=30.0):
    """Poll ``cond`` until it holds (the gated tests' handshake)."""
    end = time.monotonic() + timeout_s
    while not cond():
        if time.monotonic() > end:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.001)


def test_bucket_sizes_powers_of_two_plus_ceiling():
    assert bucket_sizes(16) == (1, 2, 4, 8, 16)
    assert bucket_sizes(12) == (1, 2, 4, 8, 12)
    assert bucket_sizes(1) == (1,)
    with pytest.raises(ValueError):
        bucket_sizes(0)


def test_engine_pads_to_buckets_and_slices_back():
    model = RecordingModel()
    engine = BatchEngine(model, max_batch=8)
    for n in (1, 3, 5, 8, 3):
        x = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
        y = engine.run(x)
        assert y.shape == (n, 3)
        np.testing.assert_allclose(y, x * 2)
    assert [s[0] for s in model.shapes] == [1, 4, 8, 8, 4]
    assert engine.compile_count == 3            # buckets 1, 4, 8
    assert engine.run_count == 5
    assert engine.rows_served == 1 + 3 + 5 + 8 + 3
    assert engine.aot_count == 0


def test_engine_warmup_then_no_new_bucket_under_load(tmp_path):
    """Warmup materializes every bucket once; a stream of ragged
    batches after it materializes none, and the exported forward gives
    the padded engine's rows exactly."""
    path, _ = _port_package(tmp_path, "conv_lrn_pool")
    backend = texport.ExportedForward(path, device="cpu")
    shapes = []

    def model(x):
        shapes.append(x.shape)
        return backend(x)

    engine = BatchEngine(model, max_batch=8, input_shape=backend.input_shape)
    assert engine.warmup() == len(engine.buckets) == 4
    seen = set(shapes)
    x = _inputs(backend.input_shape, n=8, seed=3)
    for n in (1, 2, 3, 5, 7, 8, 6, 4):
        np.testing.assert_allclose(engine.run(x[:n]), backend(x[:n]),
                                   rtol=0, atol=CROSS_ATOL)
    assert engine.compile_count == 4
    assert set(shapes) == seen == {(b,) + backend.input_shape
                                   for b in engine.buckets}


def test_engine_rejects_oversize_and_bad_shape():
    engine = BatchEngine(RecordingModel(), max_batch=4)
    with pytest.raises(ValueError, match="max_batch"):
        engine.run(np.zeros((5, 3), np.float32))
    with pytest.raises(ValueError, match="input shape"):
        engine.run(np.zeros((2, 7), np.float32))


def test_engine_skips_padding_for_dynamic_backends():
    model = RecordingModel()
    model.static_shapes = False         # the NativeForward contract
    engine = BatchEngine(model, max_batch=8)
    engine.run(np.zeros((3, 3), np.float32))
    assert [s[0] for s in model.shapes] == [3]   # exact size, no pad
    assert engine.compile_count == 0
    assert engine.warmup() == 0


def test_engine_fault_site_fails_the_run():
    from znicz_tpu_torch.resilience import faults

    engine = BatchEngine(RecordingModel(), max_batch=4)
    with faults.active(faults.FaultPlan().crash_at("serve.run",
                                                    at_hit=2)):
        engine.run(np.zeros((1, 3), np.float32))
        with pytest.raises(faults.FaultInjected):
            engine.run(np.zeros((1, 3), np.float32))
    assert engine.run_count == 1


# -- micro-batcher contract ---------------------------------------------------

def test_batcher_coalesces_requests_queued_behind_a_batch():
    gate = threading.Event()
    batcher, model = make_batcher(max_batch=8, gate=gate)
    try:
        first = batcher.submit(np.full((1, 3), 0.0, np.float32))
        assert model.entered.wait(30)   # the worker holds the first alone
        rest = [batcher.submit(np.full((1, 3), float(i + 1), np.float32))
                for i in range(5)]
        gate.set()                      # the five were queued: one batch
        outs = [f.result(timeout=30) for f in [first] + rest]
        for i, out in enumerate(outs):
            np.testing.assert_allclose(out, np.full((1, 3), 2.0 * i))
        sizes = {int(k): v for k, v in batcher.metrics.snapshot()
                 ["batch_size_histogram"].items()}
        assert sizes == {1: 1, 5: 1}
        assert [s[0] for s in model.shapes] == [1, 8]
    finally:
        gate.set()
        batcher.stop()


def test_deadline_expired_request_gets_timeout_error_not_silent_drop():
    gate = threading.Event()
    batcher, model = make_batcher(max_batch=8, gate=gate)
    try:
        slow = batcher.submit(np.zeros((1, 3), np.float32))
        assert model.entered.wait(30)
        doomed = batcher.submit(np.zeros((1, 3), np.float32),
                                timeout_s=0.05)
        time.sleep(0.1)                 # outlasts the deadline
        gate.set()
        with pytest.raises(DeadlineExceeded):
            doomed.result(timeout=30)
        assert slow.result(timeout=30).shape == (1, 3)
        snap = batcher.metrics.snapshot()
        assert snap["timed_out"] == 1 and snap["completed"] == 1
    finally:
        gate.set()
        batcher.stop()


def test_queue_full_rejects_immediately():
    gate = threading.Event()
    batcher, model = make_batcher(max_batch=8, max_queue=1, gate=gate)
    try:
        served = batcher.submit(np.zeros((1, 3), np.float32))
        assert model.entered.wait(30)   # popped; the engine is held
        queued = batcher.submit(np.zeros((1, 3), np.float32))
        t0 = time.monotonic()
        with pytest.raises(QueueFull):
            batcher.submit(np.zeros((1, 3), np.float32))
        assert time.monotonic() - t0 < 0.5      # fast failure, no wait
        assert batcher.metrics.snapshot()["rejected"] == 1
        gate.set()
        for f in (served, queued):
            assert f.result(timeout=30) is not None
    finally:
        gate.set()
        batcher.stop()


def test_oversize_request_is_chunked_and_reassembled_in_order():
    batcher, model = make_batcher(max_batch=4)
    try:
        x = np.arange(11 * 3, dtype=np.float32).reshape(11, 3)
        out = batcher.predict(x)
        np.testing.assert_allclose(out, x * 2)  # rows in submission order
        assert max(s[0] for s in model.shapes) <= 4
        snap = batcher.metrics.snapshot()
        assert snap["admitted"] == 1 and snap["completed"] == 1
    finally:
        batcher.stop()


def test_shutdown_drains_inflight_requests():
    gate = threading.Event()
    batcher, model = make_batcher(max_batch=1, gate=gate)
    futures = [batcher.submit(np.full((1, 3), float(i), np.float32))
               for i in range(5)]
    assert model.entered.wait(30)
    stopper = threading.Thread(target=batcher.stop, kwargs={"drain": True})
    stopper.start()
    _wait_for(lambda: batcher.draining, "the drain")
    with pytest.raises(QueueFull):      # no admission while draining
        batcher.submit(np.zeros((1, 3), np.float32))
    gate.set()
    stopper.join(30)
    assert not stopper.is_alive()
    for i, f in enumerate(futures):
        np.testing.assert_allclose(f.result(timeout=1),
                                   np.full((1, 3), 2.0 * i))


def test_stop_without_drain_fails_queued_loudly():
    gate = threading.Event()
    batcher, model = make_batcher(max_batch=1, gate=gate)
    first = batcher.submit(np.zeros((1, 3), np.float32))
    assert model.entered.wait(30)
    queued = batcher.submit(np.zeros((1, 3), np.float32))
    stopper = threading.Thread(target=batcher.stop, kwargs={"drain": False})
    stopper.start()
    with pytest.raises(QueueFull):      # flushed before the join
        queued.result(timeout=30)
    gate.set()
    stopper.join(30)
    assert first.result(timeout=30) is not None     # in-flight finishes


def test_expired_chunk_at_queue_head_cannot_overflow_the_batch():
    gate = threading.Event()
    batcher, model = make_batcher(max_batch=8, gate=gate)
    try:
        busy = batcher.submit(np.zeros((1, 3), np.float32))
        assert model.entered.wait(30)
        c1 = batcher.submit(np.full((5, 3), 1.0, np.float32))
        doomed = batcher.submit(np.zeros((2, 3), np.float32),
                                timeout_s=0.03)
        c3 = batcher.submit(np.full((8, 3), 3.0, np.float32))
        time.sleep(0.06)                # outlasts doomed's deadline
        gate.set()
        np.testing.assert_allclose(c1.result(timeout=30),
                                   np.full((5, 3), 2.0))
        np.testing.assert_allclose(c3.result(timeout=30),
                                   np.full((8, 3), 6.0))
        with pytest.raises(DeadlineExceeded):
            doomed.result(timeout=30)
        assert busy.result(timeout=30) is not None
        snap = batcher.metrics.snapshot()
        assert snap["errors"] == 0
        assert max(int(k) for k in snap["batch_size_histogram"]) <= 8
    finally:
        gate.set()
        batcher.stop()


def test_mismatched_widths_fail_the_batch_not_the_worker():
    """With no declared input_shape the width check happens at
    concatenation: both requests queued behind the held batch coalesce,
    fail together, and the worker serves on."""
    gate, entered, calls = threading.Event(), threading.Event(), []

    def bare_model(x):                  # no input_shape attribute
        calls.append(x.shape)
        entered.set()
        assert gate.wait(30)
        return np.asarray(x) * 2.0

    batcher = MicroBatcher(BatchEngine(bare_model, max_batch=8),
                           max_wait_ms=5.0)
    try:
        busy = batcher.submit(np.zeros((1, 3), np.float32))
        assert entered.wait(30)
        a = batcher.submit(np.zeros((1, 3), np.float32))
        b = batcher.submit(np.zeros((1, 5), np.float32))
        gate.set()
        assert busy.result(timeout=30) is not None
        for f in (a, b):
            with pytest.raises(ValueError):
                f.result(timeout=30)
        out = batcher.predict(np.ones((1, 3), np.float32))   # still alive
        np.testing.assert_allclose(out, np.full((1, 3), 2.0))
        assert batcher.metrics.snapshot()["errors"] == 1
    finally:
        gate.set()
        batcher.stop()


def test_cancelled_future_does_not_kill_the_worker():
    gate = threading.Event()
    batcher, model = make_batcher(max_batch=8, gate=gate)
    try:
        busy = batcher.submit(np.zeros((1, 3), np.float32))
        assert model.entered.wait(30)
        gone = batcher.submit(np.full((1, 3), 5.0, np.float32))
        assert gone.cancel()            # the client walks away queued
        gate.set()
        assert busy.result(timeout=30) is not None
        after = batcher.predict(np.full((1, 3), 7.0, np.float32))
        np.testing.assert_allclose(after, np.full((1, 3), 14.0))
        snap = batcher.metrics.snapshot()
        assert snap["admitted"] == snap["completed"] + snap["failed"]
    finally:
        gate.set()
        batcher.stop()


def test_bad_requests_are_refused_at_submit():
    batcher, _ = make_batcher(max_batch=2, max_queue=3)
    try:
        for bad in (0, -1):
            with pytest.raises(ValueError, match="timeout_s"):
                batcher.submit(np.zeros((1, 3), np.float32), timeout_s=bad)
        with pytest.raises(ValueError, match="whole queue"):
            batcher.submit(np.zeros((8, 3), np.float32))   # 4 chunks > 3
        with pytest.raises(ValueError, match="input shape"):
            batcher.submit(np.zeros((1, 4), np.float32))
        with pytest.raises(ValueError, match="empty"):
            batcher.submit(np.zeros((0, 3), np.float32))
        assert batcher.metrics.snapshot()["rejected"] == 0
    finally:
        batcher.stop()


class Flaky(RecordingModel):
    def __call__(self, x):
        if float(np.asarray(x).ravel()[0]) < 0:
            raise RuntimeError("poison batch")
        return super().__call__(x)


def test_engine_failure_fails_the_batch_but_not_the_batcher():
    batcher = MicroBatcher(BatchEngine(Flaky(), max_batch=4),
                           max_wait_ms=1.0)
    try:
        bad = batcher.submit(np.full((1, 3), -1.0, np.float32))
        with pytest.raises(RuntimeError, match="poison"):
            bad.result(timeout=30)
        good = batcher.predict(np.full((1, 3), 1.0, np.float32))
        np.testing.assert_allclose(good, np.full((1, 3), 2.0))
        assert batcher.metrics.snapshot()["errors"] == 1
    finally:
        batcher.stop()


def test_failed_request_ledger_closes_exactly():
    """``errors`` counts failed batches, ``failed`` failed requests
    (engine error, deadline, shutdown flush): admitted == completed +
    failed."""
    gate = threading.Event()
    gate.set()
    model = Flaky(gate=gate)
    batcher = MicroBatcher(BatchEngine(model, max_batch=4),
                           max_wait_ms=1.0)
    try:
        bad = batcher.submit(np.full((1, 3), -1.0, np.float32))
        with pytest.raises(RuntimeError):
            bad.result(timeout=30)
        assert batcher.submit(np.full((1, 3), 1.0, np.float32)).result(
            timeout=30) is not None
        gate.clear()
        model.entered.clear()
        busy = batcher.submit(np.full((1, 3), 2.0, np.float32))
        assert model.entered.wait(30)
        doomed = batcher.submit(np.full((1, 3), 4.0, np.float32),
                                timeout_s=0.05)
        time.sleep(0.1)                 # outlasts the deadline
        gate.set()
        with pytest.raises(DeadlineExceeded):
            doomed.result(timeout=30)
        assert busy.result(timeout=30) is not None
    finally:
        gate.set()
        batcher.stop()
    snap = batcher.metrics.snapshot()
    assert snap["errors"] == 1 and snap["timed_out"] == 1
    assert snap["failed"] == 2
    assert snap["admitted"] == snap["completed"] + snap["failed"]


def test_load_concurrent_clients_coalesce_with_no_new_bucket(tmp_path):
    """Eight threaded clients against the exported conv stack: the model
    is held until the queue holds two chunks, so batches coalesce;
    after warmup no bucket materializes, and every admitted request gets
    one response equal to the direct forward of its rows."""
    path, _ = _port_package(tmp_path, "conv_lrn_pool")
    backend = texport.ExportedForward(path, device="cpu")
    gate = threading.Event()

    def model(x):
        assert gate.wait(30)
        return backend(x)

    engine = BatchEngine(model, max_batch=16, input_shape=backend.input_shape)
    gate.set()
    engine.warmup()
    gate.clear()
    warm = engine.compile_count
    batcher = MicroBatcher(engine, max_wait_ms=5.0, max_queue=256,
                           default_timeout_s=60.0)
    n_clients, per_client = 8, 6
    errors, results = [], {}

    def client(cid):
        rng = np.random.default_rng(cid)
        try:
            for i in range(per_client):
                x = rng.normal(size=(int(rng.integers(1, 4)),) +
                               backend.input_shape).astype(np.float32)
                y = batcher.predict(x)
                np.testing.assert_allclose(y, backend(x), rtol=0,
                                           atol=CROSS_ATOL)
                results[(cid, i)] = y.shape
        except Exception as exc:  # noqa: BLE001 — surface in main thread
            errors.append((cid, repr(exc)))

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(n_clients)]
    for t in threads:
        t.start()
    _wait_for(lambda: batcher.metrics.snapshot()["queue_depth"] >= 2,
              "two queued chunks")
    gate.set()
    for t in threads:
        t.join(timeout=120)
    batcher.stop()
    assert not errors, errors
    assert len(results) == n_clients * per_client
    snap = batcher.metrics.snapshot()
    assert snap["admitted"] == snap["completed"] == n_clients * per_client
    assert snap["rejected"] == 0 and snap["timed_out"] == 0
    assert max(int(k) for k in snap["batch_size_histogram"]) > 1
    assert engine.compile_count == warm
    assert snap["latency"]["count"] == n_clients * per_client


# -- metrics ------------------------------------------------------------------

def test_latency_histogram_percentiles_land_in_bucket():
    m = ServingMetrics()
    for ms in (1.2, 1.4, 1.6, 1.8, 90.0):
        m.on_complete(ms / 1000.0)
    snap = m.snapshot()["latency"]
    assert snap["count"] == 5
    assert 1.0 <= snap["p50_ms"] <= 2.0
    assert 50.0 <= snap["p99_ms"] <= 100.0
    assert snap["buckets_ms"]["2"] == 4 and snap["buckets_ms"]["100"] == 1


def test_metrics_snapshot_is_json_roundtrippable_and_mirrored():
    from znicz_tpu_torch.observe.registry import REGISTRY

    m = ServingMetrics()
    m.on_admit(2)
    m.on_batch(2)
    m.on_dequeue(2)
    m.on_complete(0.003)
    doc = json.loads(json.dumps(m.snapshot()))
    assert doc["admitted"] == 1 and doc["queue_depth"] == 0
    assert doc["batch_size_histogram"] == {"2": 1}
    prom = REGISTRY.render_prometheus()
    assert "znicz_serve_requests_total" in prom
    assert "znicz_serve_latency_seconds" in prom


# -- HTTP front end and CLI ---------------------------------------------------

def _http_json(url, data=None, timeout=30):
    req = urllib.request.Request(
        url, data=None if data is None else json.dumps(data).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _http_code(url, data=None):
    try:
        _http_json(url, data)
    except urllib.error.HTTPError as exc:
        return exc.code, exc
    return 200, None


def test_serve_server_endpoints(tmp_path):
    path, _ = _port_package(tmp_path, "conv_lrn_pool")
    backend = texport.ExportedForward(path, device="cpu")
    server = ServeServer(backend, max_batch=8, max_wait_ms=1.0,
                         package_info={"sha256": "x"})
    port = server.start()
    base = f"http://127.0.0.1:{port}"
    try:
        x = _inputs(backend.input_shape, n=2, seed=9)
        out = _http_json(f"{base}/predict", {"input": x.tolist()})
        np.testing.assert_allclose(np.asarray(out["output"]), backend(x),
                                   rtol=0, atol=CROSS_ATOL)
        assert _http_json(f"{base}/healthz")["status"] == "ok"
        assert _http_json(f"{base}/livez")["status"] == "ok"
        ready = _http_json(f"{base}/readyz")
        assert ready == {"status": "ready", "package": {"sha256": "x"}}
        snap = _http_json(f"{base}/metrics")
        assert snap["serving"]["completed"] == 1
        assert snap["engine"]["run_count"] == 5     # 4 warmup + 1
        assert snap["engine"]["compile_count"] == 4
        assert snap["engine"]["buckets"] == [1, 2, 4, 8]
        meta = _http_json(f"{base}/")
        assert meta["n_requests"] == 1 and meta["max_batch"] == 8
        assert "traceEvents" in _http_json(f"{base}/trace.json")
        with urllib.request.urlopen(f"{base}/metrics.prom") as r:
            assert b"znicz_serve_requests_total" in r.read()
        for p, data, code in (("/predict", {"wrong": 1}, 400),
                              ("/predict", {"input": [[0.0] * 3]}, 400),
                              ("/nope", {"input": [[0.0] * 3]}, 404)):
            assert _http_code(f"{base}{p}", data)[0] == code
        code, _ = _http_code(f"{base}/predict",
                             {"input": x[:1].tolist(), "timeout_s": -1})
        assert code == 400
    finally:
        server.stop()


def test_serve_server_maps_backpressure_to_503_and_deadline_to_504():
    gate = threading.Event()
    model = RecordingModel(gate=gate)
    server = ServeServer(model, max_batch=1, max_queue=1, max_wait_ms=1.0,
                         warmup=False)
    port = server.start()
    url = f"http://127.0.0.1:{port}/predict"
    codes = {}

    def post(name, doc):
        codes[name] = _http_code(url, doc)[0]

    held = threading.Thread(target=post, args=("held",
                                               {"input": [[0.0] * 3]}))
    doomed = threading.Thread(target=post, args=(
        "doomed", {"input": [[1.0] * 3], "timeout_s": 0.05}))
    try:
        held.start()
        assert model.entered.wait(30)           # the worker holds it
        doomed.start()
        _wait_for(lambda: server.metrics.snapshot()["queue_depth"] == 1,
                  "the queued request")
        code, exc = _http_code(url, {"input": [[0.0] * 3]})
        assert code == 503 and exc.headers.get("Retry-After") == "1"
        time.sleep(0.1)                         # outlasts the deadline
        gate.set()
        doomed.join(30)
        held.join(30)
        assert codes == {"held": 200, "doomed": 504}
    finally:
        gate.set()
        server.stop()


def test_stop_drains_before_closing_listener():
    gate = threading.Event()
    model = RecordingModel(gate=gate)
    server = ServeServer(model, max_batch=1, max_wait_ms=1.0, warmup=False)
    port = server.start()
    fut = server.batcher.submit(np.zeros((1, 3), np.float32))
    assert model.entered.wait(30)
    stopper = threading.Thread(target=server.stop)
    stopper.start()
    _wait_for(lambda: server.batcher.draining, "the drain")
    code, exc = _http_code(f"http://127.0.0.1:{port}/healthz")
    assert code == 503 and json.loads(exc.read())["status"] == "draining"
    code, _ = _http_code(f"http://127.0.0.1:{port}/readyz")
    assert code == 503
    gate.set()
    stopper.join(timeout=30)
    assert not stopper.is_alive()
    assert fut.result(timeout=1) is not None    # drained, not dropped


def test_server_rejects_conflicting_max_batch_and_the_spool():
    engine = BatchEngine(RecordingModel(), max_batch=8)
    with pytest.raises(ValueError, match="max_batch"):
        ServeServer(engine, max_batch=128)
    spool = object()                # the learn plane's spool: taken
    server = ServeServer(engine, max_batch=8, feedback=spool)
    assert server.engine is engine and server.feedback is spool
    server.batcher.stop()


def test_cli_serve_smoke_over_exported_package(tmp_path, capsys):
    from znicz_tpu_torch.__main__ import main as cli_main

    path, _ = _port_package(tmp_path, "fc")
    assert cli_main(["serve", path, "--port", "0", "--max-batch", "8",
                     "--smoke-test", "--device", "cpu", "--no-aot"]) == 0
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert doc["smoke"] == "ok"
    assert doc["metrics"]["engine"]["compile_count"] == 4
    assert doc["metrics"]["serving"]["completed"] == 1
    # a reference-written package serves the same way
    ref = _ref_package(tmp_path, "fc")
    assert cli_main(["serve", ref, "--port", "0", "--max-batch", "4",
                     "--smoke-test", "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "smoke"] == "ok"
    # --feedback-spool appends the smoke's answered prediction
    spool = str(tmp_path / "spool")
    assert cli_main(["serve", path, "--port", "0", "--smoke-test",
                     "--device", "cpu", "--feedback-spool", spool]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "smoke"] == "ok"
    from znicz_tpu.learn.spool import SpoolReader, initial_cursor

    recs, _ = SpoolReader(spool).read(initial_cursor(spool), 1, wait_s=1.0)
    assert recs[0]["kind"] == "predict" and len(recs[0]["output"]) == 2


def test_cli_serve_refuses_what_it_cannot_serve(tmp_path, capsys):
    from znicz_tpu_torch.__main__ import main as cli_main

    assert cli_main(["serve", "/nonexistent/pkg.npz", "--device",
                     "cpu"]) == 2
    assert "cannot load" in capsys.readouterr().out
    if not torch.cuda.is_available():
        path, _ = _port_package(tmp_path, "fc")
        assert cli_main(["serve", path, "--smoke-test"]) == 2
        assert "CUDA" in capsys.readouterr().err
