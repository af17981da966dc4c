"""The port's serving fleet (``znicz_tpu_torch/fleet/``) on the CPU, the
counterpart of ``tests/test_fleet_serving.py``: the liveness/readiness
split and the package fingerprint on both worker planes, the request id
end to end, the router's least-loaded pick, bounded retry on admission
failures only, the empty rotation, the synthesized terminal on a broken
stream and its live metric families, the autoscaler's three cases over a
fake pool, the rollout's four unit cases, ``KVDecoder.compile_count``
against the JAX decoders' at the same buckets, and the chaos drill: two
real ``python -m znicz_tpu_torch generate --serve --device cpu`` workers
under threaded traffic roll onto a new package while a seeded fault plan
SIGKILLs one of them mid-rollout — every admitted stream ends in exactly
one terminal event, the fleet converges on the new package's sha256 and
no worker's ``compile_count`` moves in the steady state.  The CLI:
``fleet --smoke-test -- --device cpu``, the default device (cuda), and
``__main__``'s dispatch.

In-process tests ride small ``KVDecoder``-backed ``GenerateServer``s (2
layers, d 32, 4 heads, ff 64, the reference tests' size); only the drill
and the CLI spawn worker processes.  Every wait is on readiness or on an
event, never on a sleep alone."""

from __future__ import annotations

import json
import os
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch

from znicz_tpu.serve.kvcache import KVDecoder as JaxKVDecoder
from znicz_tpu.serve.paged import PagedKVDecoder as JaxPagedKVDecoder

from znicz_tpu_torch import observe
from znicz_tpu_torch.observe import flight
from znicz_tpu_torch.parallel.transformer import init_params
from znicz_tpu_torch.resilience import faults
from znicz_tpu_torch.serve.continuous import ContinuousBatcher
from znicz_tpu_torch.serve.kvcache import KVDecoder
from znicz_tpu_torch.serve.paged import PagedKVDecoder
from znicz_tpu_torch.serve.server import GenerateServer, ServeServer

N_LAYERS, D, HEADS, FF = 2, 32, 4, 64
CHARMAP = list("abcdefghijklmnopqrstuvwxyz .,!?")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: worker processes keep to a few threads each: several run at once
WORKER_ENV = {"OMP_NUM_THREADS": "2", "ZNICZ_TPU_SITE_CONFIG": ""}


@pytest.fixture(autouse=True)
def _clean_globals():
    yield
    faults.uninstall()
    flight.configure()
    observe.set_enabled(True)


@pytest.fixture(scope="module")
def params():
    return init_params(np.random.default_rng(3), N_LAYERS, D, HEADS, FF,
                       len(CHARMAP))


def _gen_server(params, package_info=None, slots=2):
    dec = KVDecoder(params, heads=HEADS, max_len=32, batch=slots,
                    device="cpu")
    server = GenerateServer(ContinuousBatcher(dec), charmap=CHARMAP,
                            package_info=package_info)
    server.start()
    return server


def _pool(tmp_path, **kw):
    from znicz_tpu_torch.fleet import WorkerPool

    pkg = tmp_path / "pool_pkg.npz"
    pkg.write_bytes(b"not a real package, fingerprint fodder")
    return WorkerPool(str(pkg), plane="generate", **kw)


def _post(url, doc, headers=(), timeout=60):
    req = urllib.request.Request(
        url, data=json.dumps(doc).encode(),
        headers={"Content-Type": "application/json", **dict(headers)})
    return urllib.request.urlopen(req, timeout=timeout)


def _stream(url, doc, headers=(), timeout=60):
    with _post(url, doc, headers=headers, timeout=timeout) as r:
        return r.headers.get("X-Request-Id"), \
            [json.loads(line) for line in r]


def _settled(read, want, timeout=10.0):
    """Poll ``read()`` until it equals ``want`` — terminal ledger
    updates land a beat after the last byte reaches the client."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = read()
        if got == want:
            return got
        time.sleep(0.02)
    return read()


# -- liveness vs readiness ----------------------------------------------------

def test_generate_readiness_split_and_fingerprint(params):
    fp = {"sha256": "cafe" * 16, "file": "lm.npz", "bytes": 7}
    server = _gen_server(params, package_info=fp)
    base = f"http://127.0.0.1:{server.port}"
    try:
        with urllib.request.urlopen(base + "/livez", timeout=5) as r:
            assert r.status == 200
        with urllib.request.urlopen(base + "/readyz", timeout=5) as r:
            doc = json.load(r)
            assert r.status == 200 and doc["status"] == "ready"
            assert doc["package"] == fp
        assert json.loads(urllib.request.urlopen(
            base + "/", timeout=5).read())["package"] == fp
        # draining: readiness drops, liveness stays up
        server.batcher.stop(drain=True)
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(base + "/readyz", timeout=5)
        assert exc.value.code == 503
        assert json.loads(exc.value.read())["status"] == "draining"
        with urllib.request.urlopen(base + "/livez", timeout=5) as r:
            assert r.status == 200
    finally:
        server.stop()


def test_serve_readiness_split():
    server = ServeServer(lambda x: x * 2.0, max_batch=4,
                         package_info={"sha256": "00", "file": "f",
                                       "bytes": 1})
    server.start()
    base = f"http://127.0.0.1:{server.port}"
    try:
        with urllib.request.urlopen(base + "/livez", timeout=5) as r:
            assert r.status == 200
        with urllib.request.urlopen(base + "/readyz", timeout=5) as r:
            assert json.load(r)["package"]["sha256"] == "00"
    finally:
        server.stop()


def test_request_id_honored_end_to_end(params):
    """A router-minted X-Request-Id is adopted by the worker, so the
    spans of one request share a track across processes."""
    from znicz_tpu_torch.observe import TRACER
    from znicz_tpu_torch.observe.federation import request_track

    server = _gen_server(params)
    try:
        rid, lines = _stream(
            f"http://127.0.0.1:{server.port}/generate",
            {"prompt": "ab", "max_tokens": 2},
            headers=(("X-Request-Id", "feed-123"),))
        assert rid == "feed-123"
        assert lines[-1]["done"] is True
        track = request_track("feed-123")
        spans = [e for e in TRACER.export_dict()["traceEvents"]
                 if e.get("args") and e["args"].get("rid") == "feed-123"]
        assert spans and all(e["tid"] == track for e in spans)
    finally:
        server.stop()


# -- router: pick / retry / relay ---------------------------------------------

def test_router_least_loaded_pick_and_exclude(tmp_path):
    from znicz_tpu_torch.fleet import FleetRouter, NoReadyWorker

    pool = _pool(tmp_path)
    try:
        a = pool.adopt("http://127.0.0.1:1")
        b = pool.adopt("http://127.0.0.1:2")
        c = pool.adopt("http://127.0.0.1:3")
        router = FleetRouter(pool)
        a.ready, b.ready, c.ready = True, True, True
        a.depth, b.depth, c.depth = 5.0, 1.0, 3.0
        assert router.pick() is b
        b.inflight = 9                  # in-flight covers the scrape gap
        assert router.pick() is c
        c.retiring = True               # a draining worker leaves
        assert router.pick() is a       # rotation immediately
        assert router.pick(exclude={a.rank}) is b
        with pytest.raises(NoReadyWorker):
            router.pick(exclude={a.rank, b.rank})
    finally:
        pool.aggregator.close()


def test_router_retries_admission_failures_only(params, tmp_path):
    """503 queue-full and connection-refused move to another worker;
    a worker VERDICT (400) is relayed verbatim, never retried."""
    from znicz_tpu_torch.fleet import FleetRouter

    class Refusing(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):
            body = json.dumps({"error": "queue full"}).encode()
            self.send_response(503)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    refuser = ThreadingHTTPServer(("127.0.0.1", 0), Refusing)
    threading.Thread(target=refuser.serve_forever, daemon=True).start()
    good = _gen_server(params)
    pool = _pool(tmp_path)
    router = None
    try:
        w_dead = pool.adopt("http://127.0.0.1:1")       # refused conn
        w_503 = pool.adopt(
            f"http://127.0.0.1:{refuser.server_address[1]}")
        w_good = pool.adopt(f"http://127.0.0.1:{good.port}")
        for w in (w_dead, w_503, w_good):
            w.ready = True
        # force the pick order dead -> 503 -> good
        w_dead.depth, w_503.depth, w_good.depth = 0.0, 1.0, 2.0
        router = FleetRouter(pool, max_retries=2)
        port = router.start()
        _, lines = _stream(f"http://127.0.0.1:{port}/generate",
                           {"prompt": "ab", "max_tokens": 2})
        assert lines[-1].get("done") and "error" not in lines[-1]
        snap = _settled(
            lambda: {k: router.snapshot()[k]
                     for k in ("retries", "completed")},
            {"retries": 2, "completed": 1})
        assert snap == {"retries": 2, "completed": 1}
        # a worker verdict is NOT retried: unknown chars -> one 400
        w_dead.ready = w_503.ready = False
        before = router.snapshot()["retries"]
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(f"http://127.0.0.1:{port}/generate",
                  {"prompt": "éé", "max_tokens": 2})
        assert exc.value.code == 400
        assert router.snapshot()["retries"] == before
    finally:
        if router is not None:
            router.stop()
        refuser.shutdown()
        refuser.server_close()
        good.stop()
        pool.aggregator.close()


def test_router_rejects_when_rotation_empty(tmp_path):
    from znicz_tpu_torch.fleet import FleetRouter

    pool = _pool(tmp_path)
    router = FleetRouter(pool, max_retries=1)
    port = router.start()
    try:
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(f"http://127.0.0.1:{port}/predict", {"input": [[0.0]]})
        assert exc.value.code == 503
        assert exc.value.headers["Retry-After"] == "1"
        snap = router.snapshot()
        assert snap["rejected"] == 1 and snap["admitted"] == 0
        # router readiness mirrors the rotation's emptiness
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/readyz",
                                   timeout=5)
        assert exc.value.code == 503
    finally:
        router.stop()
        pool.aggregator.close()


def test_router_synthesizes_terminal_on_broken_stream(tmp_path):
    """A worker that dies mid-stream still leaves the client EXACTLY ONE
    terminal event, synthesized by the router."""
    from znicz_tpu_torch.fleet import FleetRouter

    class Breaking(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.end_headers()
            for tok in (1, 2):
                self.wfile.write(
                    (json.dumps({"token": tok}) + "\n").encode())
                self.wfile.flush()
            self.wfile.close()          # no terminal line

    breaker = ThreadingHTTPServer(("127.0.0.1", 0), Breaking)
    threading.Thread(target=breaker.serve_forever, daemon=True).start()
    pool = _pool(tmp_path)
    router = FleetRouter(pool)
    try:
        w = pool.adopt(f"http://127.0.0.1:{breaker.server_address[1]}")
        w.ready = True
        port = router.start()
        _, lines = _stream(f"http://127.0.0.1:{port}/generate",
                           {"prompt": "ab", "max_tokens": 8})
        terminals = [ln for ln in lines if ln.get("done")]
        assert len(terminals) == 1 and "error" in terminals[0]
        assert [ln["token"] for ln in lines if "token" in ln] == [1, 2]
        assert _settled(lambda: router.snapshot()["failed"], 1) == 1
    finally:
        router.stop()
        breaker.shutdown()
        breaker.server_close()
        pool.aggregator.close()


def test_router_metric_families_live(params, tmp_path):
    from znicz_tpu_torch.fleet import FleetRouter

    good = _gen_server(params)
    pool = _pool(tmp_path)
    router = FleetRouter(pool)
    try:
        w = pool.adopt(f"http://127.0.0.1:{good.port}")
        w.ready = True
        port = router.start()
        _stream(f"http://127.0.0.1:{port}/generate",
                {"prompt": "ab", "max_tokens": 2})
        prom = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics.prom",
            timeout=5).read().decode()
        for family in ("znicz_router_requests_total",
                       "znicz_router_proxy_seconds",
                       "znicz_router_inflight",
                       "znicz_router_workers_ready",
                       "znicz_fleet_scale_workers"):
            assert family in prom, f"{family} missing"
    finally:
        router.stop()
        good.stop()
        pool.aggregator.close()


# -- autoscaler: deterministic control ----------------------------------------

class _FakeWorker:
    def __init__(self, rank):
        self.rank = rank
        self.ready = True
        self.retiring = False


class _FakePool:
    """The five-method pool surface Autoscaler declares."""

    def __init__(self, n=1):
        self.workers_ = [_FakeWorker(i) for i in range(n)]
        self._next = n
        self.events = []

    def worker_count(self):
        return len(self.workers_)

    def ready_workers(self):
        return [w for w in self.workers_ if w.ready and not w.retiring]

    def ready_count(self):
        return len(self.ready_workers())

    def spawn(self, event=None, env_extra=None):
        w = _FakeWorker(self._next)
        self._next += 1
        self.workers_.append(w)
        self.events.append(("spawn", event))
        return w

    def wait_ready(self, worker, timeout_s=None, expect_fingerprint=None):
        return True

    def retire(self, worker, drain=True, event=None, wait=True):
        worker.retiring = True
        self.workers_.remove(worker)
        self.events.append(("retire", event))
        return True

    def reap(self, worker):
        return True


def _scaler_fixture(queue_depth_box, n=1, **kw):
    from znicz_tpu_torch.fleet import Autoscaler
    from znicz_tpu_torch.observe.federation import FleetAggregator

    agg = FleetAggregator(min_refresh_s=0.0, stale_s=1e9)
    agg.add_source(0, lambda: (
        "# TYPE znicz_generate_queue_depth gauge\n"
        f"znicz_generate_queue_depth {queue_depth_box[0]}\n"))
    pool = _FakePool(n=n)
    scaler = Autoscaler(pool, agg, queue_high=8.0, breach_for_s=2.0,
                        cooldown_s=10.0, idle_down_s=20.0, **kw)
    return agg, pool, scaler


def test_autoscaler_scales_up_on_breach_with_cooldown():
    depth = [20.0]
    agg, pool, scaler = _scaler_fixture(depth, n=1, min_workers=1,
                                        max_workers=3)
    try:
        assert scaler.tick(now=1000.0) is None      # breach starts
        assert scaler.tick(now=1001.0) is None      # for_s not met
        assert scaler.tick(now=1003.0) == "up"      # continuous breach
        assert pool.worker_count() == 2
        assert scaler.tick(now=1005.0) is None      # cooldown holds
        assert scaler.tick(now=1014.0) == "up"      # still breaching
        assert pool.worker_count() == 3
        assert scaler.tick(now=1030.0) is None      # at max_workers
        assert pool.events == [("spawn", "up"), ("spawn", "up")]
    finally:
        agg.close()


def test_autoscaler_scales_down_after_idle_window_only():
    depth = [0.0]
    agg, pool, scaler = _scaler_fixture(depth, n=3, min_workers=1,
                                        max_workers=3)
    try:
        assert scaler.tick(now=2000.0) is None      # idle window opens
        assert scaler.tick(now=2010.0) is None      # 10 s < idle_down_s
        depth[0] = 3.0                              # a burst below the
        assert scaler.tick(now=2015.0) is None      # breach level ...
        depth[0] = 0.0                              # ... resets the
        assert scaler.tick(now=2016.0) is None      # hysteresis window
        assert scaler.tick(now=2030.0) is None      # 14 s idle again
        assert scaler.tick(now=2037.0) == "down"    # 21 s idle: retire 1
        assert pool.worker_count() == 2
        assert scaler.tick(now=2048.0) is None      # fresh window gates
        assert scaler.tick(now=2069.0) == "down"    # the next retire
        assert pool.worker_count() == 1
        assert scaler.tick(now=2095.0) is None      # min_workers floor
        assert pool.events == [("retire", "down"), ("retire", "down")]
    finally:
        agg.close()


def test_autoscaler_validates_bounds():
    from znicz_tpu_torch.fleet import Autoscaler
    from znicz_tpu_torch.observe.federation import FleetAggregator

    agg = FleetAggregator(min_refresh_s=0.0)
    try:
        with pytest.raises(ValueError):
            Autoscaler(_FakePool(), agg, min_workers=3, max_workers=2)
    finally:
        agg.close()


# -- rolling update: the state machine over a fake pool -----------------------

class _RolloutPool(_FakePool):
    """Fake pool with the package/fingerprint surface rollout drives."""

    def __init__(self, n=2):
        super().__init__(n=n)
        self.package = "old.npz"
        self.fp = {"sha256": "old"}
        self.gate_ok = True
        for w in self.workers_:
            w.fingerprint = {"sha256": "old"}
            w.gone = False
            w.live = True
            w.proc = object()

    def set_package(self, package):
        self.package = package
        self.fp = {"sha256": f"fp:{os.path.basename(package)}"}
        return self.fp

    def workers(self):
        return list(self.workers_)

    def spawn(self, event=None, env_extra=None):
        w = super().spawn(event=event)
        w.fingerprint = dict(self.fp)   # boots the CURRENT package
        w.gone = False
        w.live = True
        w.proc = object()
        return w

    def wait_ready(self, worker, timeout_s=None, expect_fingerprint=None):
        if not self.gate_ok:
            return False
        if expect_fingerprint is not None:
            return worker.fingerprint.get("sha256") == \
                expect_fingerprint.get("sha256")
        return True

    def retire(self, worker, drain=True, event=None, wait=True):
        worker.retiring = True
        self.events.append(("retire", event))
        if wait:
            return self.reap(worker)
        return True

    def reap(self, worker):
        worker.gone = True
        worker.live = False
        if worker in self.workers_:
            self.workers_.remove(worker)
        self.events.append(("reap", worker.rank))
        return True

    def probe_once(self):
        """The real probe loop's replace-on-unexpected-death shape."""
        for w in list(self.workers_):
            if not w.live and not w.retiring:
                w.gone = True
                self.workers_.remove(w)
                self.spawn(event="replace")


def test_rollout_one_at_a_time_and_converges():
    from znicz_tpu_torch.fleet import RollingUpdate

    pool = _RolloutPool(n=2)
    ru = RollingUpdate(pool, converge_timeout_s=5.0)
    report = ru.run("new.npz")
    assert report["state"] == "done" and report["adopted"] == 2
    assert {w.fingerprint["sha256"] for w in pool.workers()} == \
        {"fp:new.npz"}
    # strictly one at a time: never two old workers down at once
    assert [e[0] for e in pool.events] == ["retire", "spawn", "reap",
                                           "retire", "spawn", "reap"]
    assert ru.status()["history"][-1]["sha256"] == "fp:new.npz"


def test_rollout_skips_already_dead_worker():
    """A worker SIGKILL'd mid-rollout converges through its crash
    replacement (which boots the NEW package), not a re-roll."""
    from znicz_tpu_torch.fleet import RollingUpdate

    pool = _RolloutPool(n=2)
    pool.workers_[1].live = False
    ru = RollingUpdate(pool, converge_timeout_s=5.0)
    report = ru.run("new.npz")
    assert report["adopted"] == 1
    assert "already_dead" in [s["outcome"] for s in report["steps"]]
    assert ("spawn", "replace") in pool.events
    assert {w.fingerprint["sha256"] for w in pool.workers()} == \
        {"fp:new.npz"}


def test_rollout_gate_failure_fails_safe():
    from znicz_tpu_torch.fleet import RollingUpdate, RolloutError

    pool = _RolloutPool(n=2)
    pool.gate_ok = False                # replacements never gate ready
    ru = RollingUpdate(pool, converge_timeout_s=1.0)
    with pytest.raises(RolloutError):
        ru.run("bad.npz")
    status = ru.status()
    assert status["state"] == "failed" and status["error"]
    # only the FIRST target was touched — the rest keep serving
    assert len([w for w in pool.workers()
                if w.fingerprint["sha256"] == "old"]) == 1


def test_rollout_refuses_overlap():
    from znicz_tpu_torch.fleet import RollingUpdate

    ru = RollingUpdate(_RolloutPool(n=1))
    ru._state["state"] = "rolling"
    with pytest.raises(ValueError):
        ru.run("new.npz")


# -- compile_count: the reference's count, the port's meaning -----------------

@pytest.mark.parametrize("paged,batch", [(False, 1), (False, 2),
                                         (True, 2)])
def test_compile_count_after_warmup_matches_reference(params, paged, batch):
    """After ``warmup()`` the port's count of first-run shapes equals the
    JAX decoder's count of compiled programs at the same buckets, and a
    second pass of the same requests moves neither."""
    kw = dict(heads=HEADS, max_len=32, batch=batch)
    if paged:
        ours = PagedKVDecoder(params, page=8, device="cpu", **kw)
        theirs = JaxPagedKVDecoder(params, page=8, **kw)
    else:
        ours = KVDecoder(params, device="cpu", **kw)
        theirs = JaxKVDecoder(params, **kw)
    ours.warmup()
    theirs.warmup()
    assert ours.stats()["compile_count"] == ours.compile_count > 0
    assert ours.compile_count == theirs.compile_count
    if not paged:
        return
    prompts = [[1, 2, 3], list(range(4, 17)), [5] * 9]
    counts = []
    for _ in range(2):
        batcher = ContinuousBatcher(ours)
        streams = [batcher.submit(p, max_new_tokens=6) for p in prompts]
        outs = [s.result(timeout_s=60) for s in streams]
        batcher.stop(drain=True)
        counts.append((ours.compile_count, outs))
    assert counts[0] == counts[1]
    assert counts[0][0] == theirs.compile_count


# -- the chaos drill (real worker processes) ----------------------------------

def _build_pkg(tmp_path, seed, name):
    from znicz_tpu_torch.utils.export import export_lm

    p = init_params(np.random.default_rng(seed), N_LAYERS, D, HEADS, FF,
                    len(CHARMAP))
    path = str(tmp_path / f"{name}.npz")
    export_lm(p, path, heads=HEADS, charmap=CHARMAP, name=name)
    return path


def _compile_counts(pool) -> list:
    return [json.loads(urllib.request.urlopen(
        w.base + "/metrics", timeout=10).read())["decoder"]["compile_count"]
        for w in pool.ready_workers()]


def test_rollout_chaos_drill_zero_lost_requests(tmp_path):
    """Two real CPU workers, threaded traffic through the router, a
    rolling update from package A to package B, and a seeded SIGKILL at
    ``generate.step`` on one worker mid-rollout: every admitted stream
    gets exactly one terminal event, the router's ledger closes, the
    fleet converges on B's sha256, and no worker's compile_count moves
    in the steady state."""
    from znicz_tpu_torch.fleet import FleetRouter, RollingUpdate, WorkerPool
    from znicz_tpu_torch.utils.naming import package_fingerprint

    pkg_a = _build_pkg(tmp_path, 7, "lm_a")
    pkg_b = _build_pkg(tmp_path, 8, "lm_b")
    fp_b = package_fingerprint(pkg_b)
    env = dict(os.environ, PYTHONPATH=REPO, **WORKER_ENV)
    pool = WorkerPool(pkg_a, plane="generate",
                      worker_args=("--slots", "2", "--max-len", "48",
                                   "--device", "cpu"),
                      env=env, run_dir=str(tmp_path / "fleet"),
                      probe_interval_s=0.25)
    router = None
    stop_traffic = threading.Event()
    first_done = threading.Event()
    results = []        # (kind, detail) per attempted request
    res_lock = threading.Lock()
    try:
        pool.spawn()
        # the seeded chaos victim: SIGKILL at its 25th decode step,
        # inside the rollout window (traffic starts with the rollout,
        # and worker 0 drains first, so the steps concentrate here)
        plan = faults.FaultPlan(seed=13).kill_at("generate.step",
                                                 at_hit=25)
        pool.spawn(env_extra={faults.PLAN_ENV_VAR: plan.to_env()})
        assert pool.wait_all_ready(timeout_s=240), \
            f"workers never ready: {pool.snapshot()}"
        pool.start_probes()
        router = FleetRouter(pool, max_retries=2)
        port = router.start()
        rollout = RollingUpdate(pool, converge_timeout_s=240.0)

        def client(cid):
            rng = np.random.default_rng(cid)
            while not stop_traffic.is_set():
                prompt = "".join(CHARMAP[i] for i in rng.integers(
                    0, 26, size=int(rng.integers(2, 6))))
                try:
                    _, lines = _stream(
                        f"http://127.0.0.1:{port}/generate",
                        {"prompt": prompt, "max_tokens": 6,
                         "timeout_s": 60}, timeout=120)
                except urllib.error.HTTPError as exc:
                    exc.read()
                    with res_lock:      # never admitted — not lost
                        results.append(("rejected", exc.code))
                    stop_traffic.wait(0.05)
                    continue
                except Exception as exc:  # noqa: BLE001 — a silent
                    with res_lock:        # stream IS a lost request
                        results.append(("broken", repr(exc)))
                    continue
                terminals = [ln for ln in lines if ln.get("done")]
                with res_lock:
                    if len(terminals) != 1 or lines[-1] != terminals[0]:
                        results.append(("bad_terminal", lines))
                    elif "error" in terminals[0]:
                        results.append(("errored", terminals[0]))
                    else:
                        results.append(("completed", len(lines) - 1))
                        first_done.set()

        threads = [threading.Thread(target=client, args=(c,),
                                    daemon=True) for c in range(4)]
        for t in threads:
            t.start()
        try:
            assert first_done.wait(120), "no request completed"
            report = rollout.run(pkg_b)
        finally:
            # a tail of traffic on the new fleet, then stop
            n_done = len(results)
            deadline = time.monotonic() + 60
            while len(results) < n_done + 4 and \
                    time.monotonic() < deadline:
                time.sleep(0.05)
            stop_traffic.set()
            for t in threads:
                t.join(timeout=180)
        assert report["state"] == "done", report
        # the workers the rollout retired drained clean
        reaps = [s for s in report["steps"]
                 if s["outcome"] in ("drained", "killed")]
        assert reaps and all(s["outcome"] == "drained"
                             for s in reaps), report
        # the seeded kill landed and was replaced on the NEW package
        assert pool.replacements >= 1, pool.snapshot()
        pool.probe_once()
        fps = {(w.fingerprint or {}).get("sha256") for w in pool.workers()}
        assert fps == {fp_b["sha256"]}, pool.snapshot()
        with res_lock:
            kinds = {}
            for kind, _ in results:
                kinds[kind] = kinds.get(kind, 0) + 1
        assert kinds.get("broken", 0) == 0, (kinds, results[-10:])
        assert kinds.get("bad_terminal", 0) == 0, (kinds, results[-10:])
        assert kinds.get("completed", 0) >= 10, kinds
        assert _settled(
            lambda: (lambda s: s["admitted"] - s["completed"] -
                     s["failed"] - s["client_gone"])(router.snapshot()),
            0) == 0, router.snapshot()
        # steady state on the new fleet: a fresh request streams clean
        # and no worker runs a shape it had not run
        before = _compile_counts(pool)
        for prompt in ("hello", "ab", "xyz"):
            _, lines = _stream(f"http://127.0.0.1:{port}/generate",
                               {"prompt": prompt, "max_tokens": 4})
            assert lines[-1].get("done") and "error" not in lines[-1]
        assert _compile_counts(pool) == before
    finally:
        stop_traffic.set()
        if router is not None:
            router.stop()
        pool.stop()


# -- the CLI ------------------------------------------------------------------

def test_fleet_smoke_test_on_cpu_workers(params, tmp_path, capsys,
                                         monkeypatch):
    from znicz_tpu_torch.fleet.cli import fleet_main
    from znicz_tpu_torch.utils.export import export_lm

    pkg = str(tmp_path / "lm.npz")
    export_lm(params, pkg, heads=HEADS, charmap=CHARMAP, name="lm")
    for key, value in WORKER_ENV.items():
        monkeypatch.setenv(key, value)
    rc = fleet_main([pkg, "--workers", "1", "--port", "0", "--smoke-test",
                     "--run-dir", str(tmp_path / "fleet"), "--",
                     "--slots", "2", "--max-len", "32", "--device", "cpu"])
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and doc["smoke"] == "ok", doc
    assert doc["router"]["completed"] == 1


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host "
                    "without a CUDA device")
def test_fleet_workers_ask_for_cuda_by_default(params, tmp_path, capsys):
    """Without ``--device`` the workers run on cuda: on a host without a
    card each exits 2 before it serves, and the fleet reports it."""
    from znicz_tpu_torch.fleet.cli import fleet_main
    from znicz_tpu_torch.utils.export import export_lm

    pkg = str(tmp_path / "lm.npz")
    export_lm(params, pkg, heads=HEADS, charmap=CHARMAP, name="lm")
    run_dir = tmp_path / "fleet"
    rc = fleet_main([pkg, "--workers", "1", "--port", "0", "--smoke-test",
                     "--run-dir", str(run_dir), "--ready-timeout-s", "120"])
    assert rc == 1
    assert "never became ready" in capsys.readouterr().err
    log = (run_dir / "worker_w0.log").read_text()
    assert "CUDA" in log and "generate:" in log


def test_main_dispatches_fleet(monkeypatch):
    import znicz_tpu_torch.__main__ as main_mod
    import znicz_tpu_torch.fleet.cli as cli_mod

    called = {}
    monkeypatch.setattr(cli_mod, "fleet_main",
                        lambda argv: called.setdefault("argv", argv) and 0)
    assert main_mod.main(["fleet", "pkg.npz", "--workers", "2"]) == 0
    assert called["argv"] == ["pkg.npz", "--workers", "2"]
