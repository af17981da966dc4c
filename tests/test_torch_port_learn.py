"""The port's learn plane (``znicz_tpu_torch/learn/``,
``loader/spool.py``) on the CPU, the counterpart of
``tests/test_learn.py``, held against the JAX package from one seed.

- The feedback spool: the reference's six cases on the port's
  ``FeedbackSpool`` / ``SpoolReader``, and spools crossing both ways (one
  package writes, the other reads the same records and cursors).
- ``SpoolSequenceLoader``: the reference's five cases, and minibatches
  identical to the reference loader's from one spool, synchronous and
  at ``pipeline_depth=2``.
- Publication and adoption: the fingerprint cache, the manifest and its
  counter, retention, the bridge's two cases and ``/fleet/status.json``.
- The trainer: ``trainer_workflow.build()`` of both packages in process
  over one spool from one base package, ``minibatch_mse`` within rtol
  1e-4 and final params within 1e-5, and its published package loading
  through the other package's ``load_lm`` within 1e-6.
- The feedback tap of ``ServeServer(feedback=)``, with the request id
  (the CLI taps, ``generate`` and ``serve --feedback-spool``, are held
  in ``test_torch_port_speculative.py`` and
  ``test_torch_port_serve_forward.py``).
- The overlap drill: a spool-fed trainer and two ``generate --serve
  --device cpu`` workers, a seeded SIGKILL of the trainer and one of a
  worker, publish-driven rollouts — no admitted request lost, the fleet
  converges on the newest published fingerprint, the resumed trainer's
  ``history_0.json`` equals an uninterrupted run's and no worker's
  ``compile_count`` moves in the steady state.
- The CLI: ``learn`` refuses bad arguments, asks for cuda without
  ``--device`` (exit 2 here), ``learn --smoke-test --device cpu`` exits
  0 with an ``"ok"`` verdict, and ``__main__`` dispatches it.

The LM is 2 layers, d 32, 4 heads, ff 64, over a 9-character vocabulary
(the reference tests' size)."""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from znicz_tpu.core import prng as jprng
from znicz_tpu.core.backends import TPUDevice
from znicz_tpu.core.config import root as jroot
from znicz_tpu.learn import spool as jspool
from znicz_tpu.learn import trainer_workflow as jtrainer
from znicz_tpu.loader.spool import SpoolSequenceLoader as JSpoolLoader
from znicz_tpu.utils.export import load_lm as jload_lm

from znicz_tpu_torch.core import prng
from znicz_tpu_torch.core.backends import TorchDevice
from znicz_tpu_torch.core.config import root as troot
from znicz_tpu_torch.learn import trainer_workflow as ttrainer
from znicz_tpu_torch.learn.bridge import AdoptionBridge
from znicz_tpu_torch.learn.publish import (latest_manifest, manifest_path,
                                           publish_package)
from znicz_tpu_torch.learn.spool import (FeedbackSpool, SpoolGone,
                                         SpoolReader, SpoolTimeout,
                                         initial_cursor, list_segments,
                                         read_cursor_file)
from znicz_tpu_torch.loader.spool import SpoolSequenceLoader
from znicz_tpu_torch.observe import REGISTRY
from znicz_tpu_torch.parallel import transformer as tfm
from znicz_tpu_torch.utils.export import export_lm, load_lm

CHARMAP = list("abcdefgh ")
N_LAYERS, D, HEADS, FF = 2, 32, 4, 64
#: per-minibatch losses and final params, port vs reference (f32)
MSE_RTOL, PARAM_ATOL = 1e-4, 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: worker and trainer processes keep to a few threads each (several run
#: at once, and a fixed count keeps the CPU sums in one order)
PROC_ENV = {"OMP_NUM_THREADS": "2", "ZNICZ_TPU_SITE_CONFIG": ""}
TRAINER_WF = os.path.join(REPO, "znicz_tpu_torch", "learn",
                          "trainer_workflow.py")


def _fill_spool(directory, n=120, seed=7, lo=10, hi=40, cls=FeedbackSpool):
    sp = cls(directory)
    rng = np.random.default_rng(seed)
    for i in range(n):
        sp.append_generate(
            f"r{i}", rng.integers(0, len(CHARMAP), 6).tolist(),
            rng.integers(0, len(CHARMAP), int(rng.integers(lo, hi)))
            .tolist())
    sp.close()
    return sp


def _counter_value(name: str) -> float:
    snap = REGISTRY.snapshot_flat(skip_zero=False)
    return sum(v for k, v in snap.items() if k.startswith(name))


# -- spool primitives ---------------------------------------------------------

def test_spool_round_trip_exactly_once(tmp_path):
    spool = str(tmp_path / "spool")
    _fill_spool(spool, n=10)
    reader = SpoolReader(spool)
    c0 = initial_cursor(spool)
    recs, c1 = reader.read(c0, 10, wait_s=1.0)
    assert [r["rid"] for r in recs] == [f"r{i}" for i in range(10)]
    again, c1b = reader.read(dict(c0), 10, wait_s=1.0)
    assert again == recs and c1b == c1
    a, ca = reader.read(dict(c0), 4, wait_s=1.0)
    b, cb = reader.read(ca, 6, wait_s=1.0)
    assert a + b == recs and cb == c1
    with pytest.raises(SpoolTimeout):
        reader.read(c1, 1, wait_s=0.1)


def test_spool_torn_final_line_skipped_counted_replayed(tmp_path):
    spool = str(tmp_path / "spool")
    _fill_spool(spool, n=9)
    seg = os.path.join(spool, "seg_00000000.jsonl")
    with open(seg, "r+b") as f:          # SIGKILL mid-append: the last
        f.truncate(os.path.getsize(seg) - 5)     # record loses its tail
    FeedbackSpool(spool).append_generate("r9", [1], [2, 3])
    torn0 = _counter_value("znicz_learn_spool_torn_total")
    reader = SpoolReader(spool)
    c0 = initial_cursor(spool)
    recs, c1 = reader.read(c0, 9, wait_s=1.0)
    assert [r["rid"] for r in recs] == \
        [f"r{i}" for i in range(8)] + ["r9"]
    assert _counter_value("znicz_learn_spool_torn_total") == torn0 + 1
    again, c1b = reader.read(dict(c0), 9, wait_s=1.0)
    assert again == recs and c1b == c1


def test_spool_rotation_retention_and_gone(tmp_path):
    spool = str(tmp_path / "spool")
    sp = FeedbackSpool(spool, segment_bytes=200, max_segments=3)
    for i in range(40):
        sp.append_generate(f"r{i}", list(range(8)), list(range(8)))
    segs = list_segments(spool)
    assert len(segs) <= 4 and segs[0] > 0
    assert _counter_value("znicz_learn_spool_dropped_segments_total") > 0
    reader = SpoolReader(spool)
    with pytest.raises(SpoolGone):
        reader.read({"seg": 0, "offset": 0, "records": 0}, 1, wait_s=0.1)
    recs, _ = reader.read(initial_cursor(spool), 3, wait_s=1.0)
    assert len(recs) == 3


def test_spool_end_cursor_canonical_across_later_rotation(tmp_path):
    spool = str(tmp_path / "spool")
    _fill_spool(spool, n=6)
    reader = SpoolReader(spool)
    recs, end = reader.read(initial_cursor(spool), 6, wait_s=1.0)
    assert end["seg"] == 0
    tiny = FeedbackSpool(spool, segment_bytes=1, max_segments=4)
    tiny.append_generate("later", [1], [2])
    assert list_segments(spool)[-1] > 0
    again, end2 = reader.read(initial_cursor(spool), 6, wait_s=1.0)
    assert again == recs and end2 == end


def test_spool_lag_does_not_recount_torn(tmp_path):
    spool = str(tmp_path / "spool")
    _fill_spool(spool, n=4)
    seg = os.path.join(spool, "seg_00000000.jsonl")
    with open(seg, "r+b") as f:
        f.truncate(os.path.getsize(seg) - 3)
    FeedbackSpool(spool).append_generate("after", [1], [2, 3])
    reader = SpoolReader(spool)
    before = _counter_value("znicz_learn_spool_torn_total")
    assert reader.lag(initial_cursor(spool)) == 4
    assert reader.lag(initial_cursor(spool)) == 4
    assert _counter_value("znicz_learn_spool_torn_total") == before
    reader.read(initial_cursor(spool), 4, wait_s=1.0)
    assert _counter_value("znicz_learn_spool_torn_total") == before + 1


def test_spool_multi_writer_shared_order(tmp_path):
    spool = str(tmp_path / "spool")
    a, b = FeedbackSpool(spool), FeedbackSpool(spool)
    for i in range(20):
        (a if i % 2 else b).append_generate(f"w{i}", [i], [i, i])
    reader = SpoolReader(spool)
    recs, c = reader.read(initial_cursor(spool), 20, wait_s=1.0)
    assert sorted(r["rid"] for r in recs) == \
        sorted(f"w{i}" for i in range(20))
    again, c2 = reader.read(initial_cursor(spool), 20, wait_s=1.0)
    assert [r["rid"] for r in again] == [r["rid"] for r in recs]
    assert c2 == c


def _rotating_torn_spool(directory, writer_cls):
    """Records over several segments, one torn line among them."""
    sp = writer_cls(directory, segment_bytes=600, max_segments=64)
    rng = np.random.default_rng(11)
    for i in range(30):
        sp.append_generate(f"x{i}", rng.integers(0, 9, 4).tolist(),
                           rng.integers(0, 9, 12).tolist())
        if i == 13:
            top = list_segments(directory)[-1]
            seg = os.path.join(directory, jspool.segment_name(top))
            with open(seg, "r+b") as f:
                f.truncate(os.path.getsize(seg) - 4)
            sp.close()
            sp = writer_cls(directory, segment_bytes=600, max_segments=64)
    sp.close()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_spool_crosses_between_packages(tmp_path, writer):
    """A spool one package wrote reads the same through both packages'
    readers: records and cursors, chunk for chunk, across rotations and
    a torn line."""
    spool = str(tmp_path / "spool")
    _rotating_torn_spool(spool, FeedbackSpool if writer == "port"
                         else jspool.FeedbackSpool)
    assert len(list_segments(spool)) > 2
    assert initial_cursor(spool) == jspool.initial_cursor(spool)
    ours, theirs = SpoolReader(spool), jspool.SpoolReader(spool)
    c_ours, c_theirs = initial_cursor(spool), jspool.initial_cursor(spool)
    for n in (5, 7, 1, 9, 7):
        r_ours, c_ours = ours.read(dict(c_ours), n, wait_s=1.0)
        r_theirs, c_theirs = theirs.read(dict(c_theirs), n, wait_s=1.0)
        assert r_ours == r_theirs and c_ours == c_theirs
    assert ours.lag(c_ours) == theirs.lag(c_theirs) == 0


# -- streaming loader ---------------------------------------------------------

LOADER_KW = dict(seq_len=8, records_per_epoch=4, minibatch_size=4,
                 wait_timeout_s=2.0)


def _make_loader(spool, cls=SpoolSequenceLoader, **kw):
    ld = cls(None, spool_dir=spool, charmap=CHARMAP, **{**LOADER_KW, **kw})
    ld._common_init()
    return ld


def _served(ld, n, piped=False) -> list:
    out = []
    for _ in range(n):
        ld.numpy_run() if piped else ld._serve()
        out.append((ld.minibatch_data.mem.copy(),
                    ld.minibatch_labels.mem.copy(),
                    int(ld.epoch_number), int(ld.minibatch_size)))
    return out


def _same(a, b) -> None:
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x[0], y[0])
        np.testing.assert_array_equal(x[1], y[1])
        assert x[2:] == y[2:]


def test_loader_deterministic_stream(tmp_path):
    spool = str(tmp_path / "spool")
    _fill_spool(spool, n=200)
    prng.seed_all(3)
    seen = _served(_make_loader(spool), 30)
    assert seen[-1][2] > 2                 # crossed epoch boundaries
    prng.seed_all(3)
    _same(_served(_make_loader(spool), 30), seen)
    cur = read_cursor_file(spool)
    assert cur is not None and cur["records"] > 0


@pytest.mark.parametrize("depth", [0, 2])
def test_loader_minibatches_identical_to_reference(tmp_path, depth):
    """One spool, one seed: the port's minibatches (synchronous, or
    through the input pipeline at depth 2) are the reference loader's."""
    from znicz_tpu_torch.pipeline import attach_prefetcher

    spool = str(tmp_path / "spool")
    _fill_spool(spool, n=200)
    jprng.seed_all(9)
    want = _served(_make_loader(spool, JSpoolLoader), 30)
    prng.seed_all(9)
    ours = _make_loader(spool)
    if depth:
        attach_prefetcher(ours, depth=depth)
    try:
        _same(_served(ours, 30, piped=bool(depth)), want)
    finally:
        ours.stop()
    assert want[-1][2] > 2


def test_loader_snapshot_replay_exactly_once(tmp_path):
    spool = str(tmp_path / "spool")
    _fill_spool(spool, n=200)
    prng.seed_all(3)
    ld = _make_loader(spool)
    state = pr = None
    while state is None:
        ld._serve()
        if ld.epoch_ended and ld.epoch_number == 2:
            state = ld.state_dict()
            pr = prng.state_dict()
    post = _served(ld, 10)
    prng.seed_all(3)                       # cold boot, then restore
    resumed = _make_loader(spool)
    prng.load_state_dict(pr)
    resumed.load_state_dict(state)
    _same(_served(resumed, 10), post)


def test_loader_restore_refuses_changed_charmap(tmp_path):
    spool = str(tmp_path / "spool")
    _fill_spool(spool, n=40)
    prng.seed_all(3)
    ld = _make_loader(spool)
    ld._serve()
    state = ld.state_dict()
    state["charmap"] = list("xy")
    with pytest.raises(ValueError, match="charmap"):
        ld.load_state_dict(state)


def test_loader_pipelined_matches_sync(tmp_path):
    from znicz_tpu_torch.pipeline import attach_prefetcher

    spool = str(tmp_path / "spool")
    _fill_spool(spool, n=200)
    prng.seed_all(9)
    stream = _served(_make_loader(spool), 24)
    prng.seed_all(9)
    piped = _make_loader(spool)
    attach_prefetcher(piped, depth=2)
    try:
        _same(_served(piped, 24, piped=True), stream)
    finally:
        piped.stop()


def test_records_trained_counter_moves(tmp_path):
    spool = str(tmp_path / "spool")
    _fill_spool(spool, n=40)
    before = _counter_value("znicz_learn_records_trained_total")
    prng.seed_all(3)
    _make_loader(spool)
    assert _counter_value("znicz_learn_records_trained_total") >= \
        before + 4


# -- fingerprint cache, publish, bridge, fleet status -------------------------

def test_package_fingerprint_cached_until_file_changes(tmp_path,
                                                       monkeypatch):
    import hashlib

    from znicz_tpu_torch.utils import naming

    pkg = tmp_path / "pkg.npz"
    pkg.write_bytes(b"a" * 4096)
    calls = {"n": 0}
    real = hashlib.sha256

    def counting_sha256(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(naming.hashlib, "sha256", counting_sha256)
    fp1 = naming.package_fingerprint(str(pkg))
    fp2 = naming.package_fingerprint(str(pkg))
    assert fp1 == fp2 and calls["n"] == 1
    tmp = tmp_path / "pkg.npz.tmp"
    tmp.write_bytes(b"b" * 8192)
    os.replace(tmp, pkg)
    fp3 = naming.package_fingerprint(str(pkg))
    assert calls["n"] == 2
    assert fp3["sha256"] != fp1["sha256"] and fp3["bytes"] == 8192
    fp3["sha256"] = "poison"
    assert naming.package_fingerprint(str(pkg))["sha256"] != "poison"


class _FakeStep:
    """export_lm stand-in: writes deterministic bytes per 'epoch'."""

    def __init__(self):
        self.exports = 0

    def export_lm(self, path):
        self.exports += 1
        with open(path, "wb") as f:
            f.write(b"model-bytes-%d" % self.exports)
        return path


def test_publish_manifest_and_counter(tmp_path):
    before = _counter_value("znicz_learn_publishes_total")
    doc = publish_package(_FakeStep(), str(tmp_path / "pub"), epoch=2,
                          seq=1)
    assert os.path.isfile(doc["package"])
    assert os.path.isfile(manifest_path(str(tmp_path / "pub")))
    read = latest_manifest(str(tmp_path / "pub"))
    assert read == doc and read["fingerprint"]["sha256"]
    assert _counter_value("znicz_learn_publishes_total") == before + 1
    # the manifest is the reference's: its reader takes it as is
    from znicz_tpu.learn.publish import latest_manifest as jlatest

    assert jlatest(str(tmp_path / "pub")) == doc


def test_publish_retention_bounds_the_dir(tmp_path):
    pub = str(tmp_path / "pub")
    step = _FakeStep()
    for epoch in range(2, 13, 2):
        doc = publish_package(step, pub, epoch=epoch, seq=epoch // 2,
                              keep=2)
    pkgs = sorted(n for n in os.listdir(pub)
                  if n.startswith("lm_e") and n.endswith(".npz"))
    assert pkgs == ["lm_e00010.npz", "lm_e00012.npz"]
    assert os.path.isfile(doc["package"])
    assert latest_manifest(pub)["epoch"] == 12


class _FakePool:
    def __init__(self, sha):
        self.expected_fingerprint = {"sha256": sha}


class _FakeRollout:
    def __init__(self, pool, outcome="done"):
        self.pool = pool
        self.outcome = outcome
        self.started: list = []
        self.rolling = False

    def start(self, package):
        from znicz_tpu_torch.utils.naming import package_fingerprint

        self.started.append(package)
        if self.outcome == "done":
            self.pool.expected_fingerprint = package_fingerprint(package)

    def join(self, timeout_s=0):
        return {"state": self.outcome, "error": None
                if self.outcome == "done" else "gate failed"}

    def status(self):
        return {"state": "idle"}


def test_bridge_adopts_each_new_fingerprint_once(tmp_path):
    pub = str(tmp_path / "pub")
    step = _FakeStep()
    publish_package(step, pub, epoch=2, seq=1)
    pool = _FakePool("old-sha")
    rollout = _FakeRollout(pool)
    bridge = AdoptionBridge(pub, pool, rollout, poll_s=0.05)
    assert bridge.poll_once()["state"] == "done"
    assert len(rollout.started) == 1
    assert bridge.adoptions == 1 and bridge.last_adoption_s is not None
    assert bridge.poll_once() is None and len(rollout.started) == 1
    publish_package(step, pub, epoch=4, seq=2)
    assert bridge.poll_once()["state"] == "done"
    assert bridge.adoptions == 2


def test_bridge_failed_adoption_waits_for_new_publish(tmp_path):
    pub = str(tmp_path / "pub")
    step = _FakeStep()
    publish_package(step, pub, epoch=2, seq=1)
    rollout = _FakeRollout(_FakePool("old-sha"), outcome="failed")
    bridge = AdoptionBridge(pub, rollout.pool, rollout, poll_s=0.05)
    assert bridge.poll_once()["state"] == "failed"
    assert bridge.failures == 1
    assert bridge.poll_once() is None and len(rollout.started) == 1
    publish_package(step, pub, epoch=4, seq=2)
    bridge.poll_once()
    assert len(rollout.started) == 2


def test_fleet_status_surfaces_package_and_rollout_top_level(tmp_path):
    from znicz_tpu_torch.fleet.rollout import RollingUpdate
    from znicz_tpu_torch.fleet.router import FleetRouter
    from znicz_tpu_torch.fleet.workers import WorkerPool

    pkg = tmp_path / "pkg.npz"
    pkg.write_bytes(b"some-package-bytes")
    pool = WorkerPool(str(pkg), run_dir=str(tmp_path / "fleet"))
    try:
        router = FleetRouter(pool)
        router.attach_rollout(RollingUpdate(pool))
        doc = pool.aggregator.status_doc()
        assert doc["package"]["fingerprint"]["sha256"] == \
            pool.expected_fingerprint["sha256"]
        assert doc["package"]["converged"] is False   # no workers yet
        assert doc["rollout"]["state"] == "idle"
        assert "steps" not in doc["rollout"]
        json.dumps(doc)
        pool.aggregator.register_status_provider(
            "learn", lambda: (_ for _ in ()).throw(RuntimeError("x")))
        assert "error" in pool.aggregator.status_doc()["learn"]
    finally:
        pool.stop()


# -- the trainer against the reference's --------------------------------------

def _export_base_package(tmp, seed=31) -> str:
    params = tfm.init_params(np.random.default_rng(seed), N_LAYERS, D,
                             HEADS, FF, len(CHARMAP))
    pkg = os.path.join(tmp, "lm.npz")
    export_lm(params, pkg, heads=HEADS, charmap=CHARMAP, name="lm_v1")
    return pkg


def _learn_config(spool, pkg, pub, depth) -> dict:
    return {"spool_dir": spool, "package": pkg, "publish_dir": pub,
            "publish_every": 2, "max_epochs": 4, "records_per_epoch": 6,
            "seq_len": 8, "minibatch_size": 4, "lr": 0.05,
            "pipeline_depth": depth, "wait_timeout_s": 5.0}


def _trainer_run(module, config_root, seed_all, device, cfg) -> tuple:
    for key, value in cfg.items():
        setattr(config_root.learn, key, value)
    seed_all(11)
    w = module.build()
    w.initialize(device=device)
    seen, run = [], w.step.run

    def recording():
        run()
        seen.append(w.step.minibatch_mse)
    w.step.run = recording
    try:
        w.run()
    finally:
        w.stop()
    return w, seen


def _flat(params) -> list:
    if isinstance(params["emb"], torch.Tensor):
        params = tfm.params_to_numpy(params)
    return [np.asarray(params["emb"]), np.asarray(params["head"])] + [
        np.asarray(blk[k]) for blk in params["blocks"] for k in sorted(blk)]


@pytest.mark.parametrize("depth", [0, 2])
def test_trainer_matches_reference(tmp_path, monkeypatch, depth):
    """Both packages' ``trainer_workflow.build()`` over one spool from one
    base package: the same minibatch losses, the same final params, and
    each one's published package loads through the other's ``load_lm``
    with the params it trained."""
    monkeypatch.delenv("ZNICZ_TPU_SNAP_DIR", raising=False)
    tmp = str(tmp_path)
    pkg = _export_base_package(tmp)
    spool = os.path.join(tmp, "spool")
    _fill_spool(spool, n=60, lo=12, hi=30)
    jw, jseen = _trainer_run(
        jtrainer, jroot, jprng.seed_all, TPUDevice(),
        _learn_config(spool, pkg, os.path.join(tmp, "pub_jax"), 0))
    tw, tseen = _trainer_run(
        ttrainer, troot, prng.seed_all, TorchDevice("cpu"),
        _learn_config(spool, pkg, os.path.join(tmp, "pub_port"), depth))
    assert len(tseen) == len(jseen) > 8
    np.testing.assert_allclose(tseen, jseen, rtol=MSE_RTOL)
    assert len(tw.decision.metrics_history) == 4 and \
        bool(tw.decision.complete)
    for a, b in zip(_flat(tw.step._params), _flat(jw.step._params)):
        np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_ATOL)
    # the published packages: epochs 2 and 4, loadable both ways
    ours = latest_manifest(os.path.join(tmp, "pub_port"))
    theirs = latest_manifest(os.path.join(tmp, "pub_jax"))
    assert ours["epoch"] == theirs["epoch"] == 4
    assert [d["epoch"] for d in tw.publisher.published] == [2, 4]
    jp, jmeta = jload_lm(ours["package"])
    tp, tmeta = load_lm(ours["package"])
    assert jmeta == tmeta and jmeta["charmap"] == CHARMAP
    for a, b in zip(_flat(jp), _flat(tw.step._params)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    tp2, _ = load_lm(theirs["package"])
    for a, b in zip(_flat(tp2), _flat(jw.step._params)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


# -- the feedback tap ---------------------------------------------------------

def test_serve_server_feedback_appends_answered_predictions(tmp_path):
    from znicz_tpu_torch.serve.server import ServeServer

    spool = str(tmp_path / "spool")
    server = ServeServer(lambda x: x * 2.0, max_batch=4,
                         feedback=FeedbackSpool(spool))
    server.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/predict",
            data=json.dumps({"input": [[1.0, 2.0]]}).encode(),
            headers={"Content-Type": "application/json",
                     "X-Request-Id": "p-1"})
        with urllib.request.urlopen(req, timeout=30) as r:
            assert json.load(r)["output"] == [[2.0, 4.0]]
    finally:
        server.stop()
    recs, _ = jspool.SpoolReader(spool).read(
        jspool.initial_cursor(spool), 1, wait_s=1.0)
    assert recs[0]["kind"] == "predict" and recs[0]["rid"] == "p-1"
    assert recs[0]["input"] == [[1.0, 2.0]]
    assert recs[0]["output"] == [[2.0, 4.0]]


def _run_cli(*argv, timeout=240):
    return subprocess.run(
        [sys.executable, "-m", "znicz_tpu_torch", *argv], cwd=REPO,
        env={**os.environ, "PYTHONPATH": REPO, **PROC_ENV},
        capture_output=True, text=True, timeout=timeout)


# -- the overlap drill --------------------------------------------------------

def _trainer_argv(spool, pkg, pub):
    return [TRAINER_WF,
            "-o", f"root.learn.spool_dir={spool}",
            "-o", f"root.learn.package={pkg}",
            "-o", f"root.learn.publish_dir={pub}",
            "-o", "root.learn.publish_every=2",
            "-o", "root.learn.max_epochs=4",
            "-o", "root.learn.records_per_epoch=6",
            # drill records are 8 ids (2 prompt + 6 tokens): the window
            # (seq_len + 1) must fit inside one record
            "-o", "root.learn.seq_len=6",
            # 3 minibatches an epoch, so the seeded at_hit=40 kill lands
            # mid-epoch
            "-o", "root.learn.minibatch_size=2",
            "-o", "root.learn.wait_timeout_s=120",
            "--random-seed", "11", "-d", "cpu"]


def _post_stream(base, prompt, max_tokens=6, timeout=120):
    req = urllib.request.Request(
        base + "/generate",
        data=json.dumps({"prompt": prompt, "max_tokens": max_tokens,
                         "timeout_s": 60}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return [json.loads(raw) for raw in r]


def test_overlap_chaos_drill_train_serve_kill_rollout(tmp_path):
    """The spool-fed trainer and two serving workers on the CPU, a seeded
    SIGKILL of the trainer and one of a worker overlapping
    publish-driven rollouts: zero lost admitted requests, convergence on
    the newest published fingerprint, the resumed trainer's history
    equal to an uninterrupted run's, no new shapes in the steady
    state."""
    from znicz_tpu_torch.fleet.rollout import RollingUpdate
    from znicz_tpu_torch.fleet.router import FleetRouter
    from znicz_tpu_torch.fleet.workers import WorkerPool
    from znicz_tpu_torch.resilience import faults
    from znicz_tpu_torch.resilience.elastic import run_elastic
    from znicz_tpu_torch.resilience.supervisor import SupervisorPolicy

    tmp = str(tmp_path)
    pkg = _export_base_package(tmp)
    spool = os.path.join(tmp, "spool")
    os.makedirs(spool)
    env = dict(os.environ, PYTHONPATH=REPO, **PROC_ENV)
    pool = WorkerPool(
        pkg, plane="generate", env=env,
        worker_args=("--slots", "2", "--max-len", "48", "--device", "cpu",
                     "--feedback-spool", spool),
        run_dir=os.path.join(tmp, "fleet"))
    router = None
    stop_traffic = threading.Event()
    results: list = []
    res_lock = threading.Lock()
    trainer_box: dict = {}
    pub = os.path.join(tmp, "publish")
    try:
        pool.spawn()
        # the chaos victim: a seeded generate.step SIGKILL sized to land
        # while traffic and the publish-driven rollout overlap
        victim_plan = faults.FaultPlan(seed=13).kill_at(
            "generate.step", at_hit=90).to_env()
        pool.spawn(env_extra={faults.PLAN_ENV_VAR: victim_plan})
        assert pool.wait_all_ready(timeout_s=240), pool.snapshot()
        pool.start_probes()
        router = FleetRouter(pool)
        rollout = RollingUpdate(pool)
        router.attach_rollout(rollout)
        base = f"http://127.0.0.1:{router.start()}"
        bridge = AdoptionBridge(pub, pool, rollout, poll_s=0.25)
        bridge.start()

        def client(cid: int) -> None:
            while not stop_traffic.wait(0.05):
                try:
                    lines = _post_stream(base, "ab" if cid % 2 else "cd")
                except urllib.error.HTTPError as exc:
                    exc.read()
                    with res_lock:
                        results.append(("rejected", exc.code))
                    continue
                except Exception as exc:  # noqa: BLE001 — judged below
                    with res_lock:
                        results.append(("broken", repr(exc)))
                    continue
                terminals = [ln for ln in lines if ln.get("done")]
                with res_lock:
                    if len(terminals) != 1 or lines[-1] != terminals[0]:
                        results.append(("bad_terminal", lines))
                    elif "error" in terminals[0]:
                        results.append(("errored", terminals[0]))
                    else:
                        results.append(("completed", cid))

        threads = [threading.Thread(target=client, args=(c,), daemon=True)
                   for c in range(3)]
        for t in threads:
            t.start()

        def train() -> None:
            # a seeded mid-epoch SIGKILL; the supervisor resumes from the
            # newest snapshot, whose loader state carries the cursor
            plan = faults.FaultPlan(seed=5).kill_at("elastic.worker",
                                                    at_hit=40)
            try:
                trainer_box["report"] = run_elastic(
                    _trainer_argv(spool, pkg, pub),
                    os.path.join(tmp, "snaps"), workers=1, spmd=False,
                    env=env, fault_plans={0: plan},
                    run_dir=os.path.join(tmp, "trainer"),
                    policy=SupervisorPolicy(max_restarts=3))
            except Exception as exc:  # noqa: BLE001 — judged below
                trainer_box["error"] = exc

        trainer = threading.Thread(target=train, daemon=True)
        trainer.start()
        # traffic feeds the spool, the trainer trains and publishes, the
        # bridge rolls the fleet: wait for the FINAL adoption to converge
        deadline = time.monotonic() + 420
        while time.monotonic() < deadline:
            if "error" in trainer_box:
                raise AssertionError(f"trainer supervision failed: "
                                     f"{trainer_box['error']!r}")
            manifest = latest_manifest(pub)
            if "report" in trainer_box and manifest is not None and \
                    not rollout.rolling and \
                    (pool.expected_fingerprint or {}).get("sha256") == \
                    manifest["fingerprint"]["sha256"]:
                break
            time.sleep(0.25)
        else:
            raise AssertionError(
                f"loop never converged: trainer={trainer_box}, "
                f"manifest={latest_manifest(pub)}, "
                f"rollout={rollout.status()}")
        n_done = len(results)
        deadline = time.monotonic() + 60     # a post-adoption tail
        while len(results) < n_done + 3 and time.monotonic() < deadline:
            time.sleep(0.05)
        stop_traffic.set()
        for t in threads:
            t.join(timeout=180)
        bridge.stop()

        report = trainer_box["report"]
        assert report.completed and report.restarts >= 1, report.as_dict()
        assert report.resumed_from, "resume never used a snapshot"
        with open(os.path.join(tmp, "snaps", "history_0.json")) as f:
            drill_history = json.load(f)
        with res_lock:
            kinds: dict = {}
            for kind, _ in results:
                kinds[kind] = kinds.get(kind, 0) + 1
        assert not kinds.get("broken") and not kinds.get("bad_terminal"), \
            f"lost/garbled streams: {kinds}; tail {results[-6:]}"
        assert kinds.get("completed", 0) >= 8, kinds
        ledger = router.snapshot()
        assert ledger["admitted"] == ledger["completed"] + \
            ledger["failed"] + ledger["client_gone"], ledger
        assert pool.replacements >= 1, \
            "the victim worker's seeded SIGKILL never fired"
        assert bridge.adoptions >= 1 and bridge.last_adoption_s > 0
        manifest = latest_manifest(pub)
        assert manifest["epoch"] == 4
        pool.probe_once()
        shas = {(w.fingerprint or {}).get("sha256") for w in pool.workers()}
        assert shas == {manifest["fingerprint"]["sha256"]}, pool.snapshot()
        assert pool.aggregator.status_doc()["package"]["converged"] is True

        def compile_counts():
            return [json.loads(urllib.request.urlopen(
                w.base + "/metrics", timeout=15).read())["decoder"][
                    "compile_count"] for w in pool.workers()]

        before = compile_counts()
        for _ in range(3):
            lines = _post_stream(base, "ef", max_tokens=4)
            assert lines[-1].get("done") and "error" not in lines[-1]
        assert compile_counts() == before
    finally:
        stop_traffic.set()
        if router is not None:
            router.stop()
        pool.stop()

    # the spool is frozen now: an uninterrupted trainer over the same
    # stream from the same origin reproduces the drill's history and its
    # newest published package
    clean = run_elastic(
        _trainer_argv(spool, pkg, os.path.join(tmp, "publish_clean")),
        os.path.join(tmp, "snaps_clean"), workers=1, spmd=False, env=env,
        run_dir=os.path.join(tmp, "trainer_clean"),
        policy=SupervisorPolicy(max_restarts=1))
    assert clean.completed and clean.restarts == 0
    with open(os.path.join(tmp, "snaps_clean", "history_0.json")) as f:
        assert json.load(f) == drill_history
    assert latest_manifest(os.path.join(tmp, "publish_clean"))[
        "fingerprint"]["sha256"] == manifest["fingerprint"]["sha256"]


# -- the CLI ------------------------------------------------------------------

def test_learn_cli_rejects_bad_args(tmp_path, capsys):
    from znicz_tpu_torch.learn.cli import learn_main

    pkg = tmp_path / "lm.npz"
    pkg.write_bytes(b"x")
    assert learn_main([str(pkg), "--workers", "0"]) == 2
    assert "--workers" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        learn_main([str(pkg), "--device", "tpu"])


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host "
                    "without a CUDA device")
def test_learn_asks_for_cuda_by_default(tmp_path, capsys):
    """Without ``--device`` the loop is built for cuda: on a host without
    a card it exits 2 before it starts a worker or the trainer."""
    from znicz_tpu_torch.learn.cli import learn_main

    pkg = _export_base_package(str(tmp_path))
    run_dir = tmp_path / "learn"
    assert learn_main([pkg, "--run-dir", str(run_dir), "--port", "0",
                       "--smoke-test"]) == 2
    assert "CUDA" in capsys.readouterr().err
    assert not (run_dir / "fleet").exists()


def test_learn_smoke_test_on_the_cpu(tmp_path):
    pkg = _export_base_package(str(tmp_path))
    r = _run_cli("learn", pkg, "--smoke-test", "--device", "cpu",
                 "--workers", "1", "--port", "0", "--run-dir",
                 str(tmp_path / "learn"), "--publish-every", "1",
                 "--max-epochs", "1", "--records-per-epoch", "4",
                 "--seq-len", "6", "--minibatch", "4", "--",
                 "--slots", "2", "--max-len", "32", timeout=400)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-3000:])
    doc = json.loads(r.stdout.strip().splitlines()[-1])
    assert doc["smoke"] == "ok" and doc["adoptions"] >= 1, doc
    assert doc["converged"] and not doc["traffic"].get("broken")
    assert doc["fingerprint"] != doc["base_fingerprint"]


def test_main_dispatches_learn(monkeypatch):
    import znicz_tpu_torch.__main__ as main_mod
    import znicz_tpu_torch.learn.cli as cli_mod

    called = {}

    def fake_learn_main(argv):
        called["argv"] = argv
        return 0

    monkeypatch.setattr(cli_mod, "learn_main", fake_learn_main)
    assert main_mod.main(["learn", "pkg.npz", "--workers", "2"]) == 0
    assert called["argv"] == ["pkg.npz", "--workers", "2"]
