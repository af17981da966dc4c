"""The port's service modules against the JAX package on the CPU:
ensembles (``utils/ensemble.py``, ``--ensemble-train``), the forge
registry (``utils/forge.py``, ``utils/export.py forge_*``, the ``forge``
subcommand), the run report (``utils/publishing.py``, ``--publish``), the
manhole (``utils/manhole.py``, ``Launcher(manhole_path=)``), the web
status (``web_status.py``), and the small APIs they read
(``Loader.total_samples``/``has_labels``,
``FullBatchLoader.served_dataset``, ``native.XorShift128P``).

Both packages build Wine from one seed (the port's seeded initial
weights equal the reference's); the reference runs on ``TPUDevice``
(plain XLA on the CPU), the port on ``TorchDevice("cpu")``.  Bands: the
committee's and the members' error counts identical; ``predict_mean``
within ``MEAN_ATOL`` (f32 logits summed in other orders); served rows of
a package crossing the registry within ``SERVE_ATOL`` (the forward
serving band of ``tests/test_torch_port_serve_forward.py``).
"""

import contextlib
import io
import json
import os
import socket
import stat
import textwrap
import time
import urllib.request

import numpy as np
import pytest

from znicz_tpu.__main__ import main as jcli
from znicz_tpu.core import prng as jprng
from znicz_tpu.core.backends import TPUDevice
from znicz_tpu.models import wine as jwine
from znicz_tpu.native import XorShift128P as JXorShift
from znicz_tpu.utils import export as jexport
from znicz_tpu.utils.ensemble import Ensemble as JEnsemble
from znicz_tpu.utils.publishing import collect_report as jcollect
from znicz_tpu.web_status import WebStatus as JWebStatus

from znicz_tpu_torch.__main__ import main as tcli
from znicz_tpu_torch.core import prng as tprng
from znicz_tpu_torch.core.backends import TorchDevice
from znicz_tpu_torch.launcher import Launcher
from znicz_tpu_torch.models import wine as twine
from znicz_tpu_torch.native import XorShift128P
from znicz_tpu_torch.utils import export as texport
from znicz_tpu_torch.utils.ensemble import Ensemble
from znicz_tpu_torch.utils.manhole import Manhole
from znicz_tpu_torch.utils.publishing import Publisher, collect_report
from znicz_tpu_torch.web_status import WebStatus

#: predict_mean, port vs reference: f32 logits of the same weights
MEAN_ATOL = 1e-5
#: served rows of one package, port vs reference (f32 on the CPU)
SERVE_ATOL = 1e-5
#: the reference test's Wine shape (tests/test_cli_services.py)
WINE_KW = {"max_epochs": 3, "n_train": 60, "n_valid": 30,
           "minibatch_size": 10}


@pytest.fixture(autouse=True)
def _hermetic_site_config(monkeypatch):
    monkeypatch.setenv("ZNICZ_TPU_SITE_CONFIG", "")


def _wines(seed=3):
    """Wine trained in both packages from ``seed`` -> (jax, port)."""
    jprng.seed_all(seed)
    jw = jwine.build(**WINE_KW)
    jw.initialize(device=TPUDevice())
    jw.run()
    jw.stop()
    tprng.seed_all(seed)
    tw = twine.build(**WINE_KW)
    tw.initialize(device=TorchDevice("cpu"))
    tw.run()
    tw.stop()
    assert tw.decision.metrics_history == jw.decision.metrics_history
    return jw, tw


@pytest.fixture(scope="module")
def wines():
    return _wines()


def test_loader_geometry_and_served_dataset(wines):
    jw, tw = wines
    assert tw.loader.total_samples == jw.loader.total_samples == 90
    assert tw.loader.has_labels is jw.loader.has_labels is True
    for got, want in zip(tw.loader.served_dataset(),
                         jw.loader.served_dataset(), strict=True):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 0xC0FFEE])
def test_xorshift128p_bit_identical(seed):
    ours, ref = XorShift128P(seed), JXorShift(seed)
    np.testing.assert_array_equal(ours.state, ref.state)
    np.testing.assert_array_equal(ours.uniform(1000), ref.uniform(1000))
    a = np.arange(257, dtype=np.int64)
    b = a.copy()
    ours.shuffle(a)
    ref.shuffle(b)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ours.uniform(7), ref.uniform(7))


def test_ensemble_committee_matches_reference():
    kw = dict(n_members=3, base_seed=50, **WINE_KW)
    jens = JEnsemble(jwine.build, **kw).train(TPUDevice())
    tens = Ensemble(twine.build, **kw).train(TorchDevice("cpu"))
    got, want = tens.test_classification(), jens.test_classification()
    assert got == want and got["n"] == 30
    assert got["committee_err"] <= max(got["member_errs"])
    data = tens.members[0].loader.original_data.map_read()[:8]
    np.testing.assert_allclose(tens.predict_mean(data),
                               jens.predict_mean(data), rtol=0,
                               atol=MEAN_ATOL)
    np.testing.assert_array_equal(tens.predict_classes(data),
                                  jens.predict_classes(data))


#: the reference test's workflow file (tests/test_cli_services.py
#: WINE_WORKFLOW), one for each package
WINE_WORKFLOW = textwrap.dedent("""
    from {pkg}.models import wine

    def run(load, main):
        load(wine.build, max_epochs=3, n_train=60, n_valid=30,
             minibatch_size=10)
        main()
    """)


def _quiet(cli, argv):
    with contextlib.redirect_stdout(io.StringIO()):
        return cli(argv)


def test_cli_ensemble_train_summary_matches_reference(tmp_path,
                                                      monkeypatch):
    monkeypatch.chdir(tmp_path)
    summaries = []
    for pkg, cli, dev in (("znicz_tpu", jcli, "tpu"),
                          ("znicz_tpu_torch", tcli, "cpu")):
        wf = tmp_path / f"{pkg}_ens.py"
        wf.write_text(WINE_WORKFLOW.format(pkg=pkg))
        argv = [str(wf), "-d", dev, "--random-seed", "7"]
        assert _quiet(cli, argv + ["--ensemble-train", "0"]) == 2
        assert _quiet(cli, argv + ["--ensemble-train", "2",
                                   "--publish", "markdown"]) == 2
        assert _quiet(cli, argv + ["--ensemble-train", "3"]) == 0
        summaries.append(json.loads(
            (tmp_path / "ensemble_wine.json").read_text()))
        os.unlink(tmp_path / "ensemble_wine.json")
    want, got = summaries
    assert got.keys() == want.keys()
    assert [m.keys() for m in got["members"]] == \
        [m.keys() for m in want["members"]]
    for key in ("workflow", "n_members", "best", "mean"):
        assert got[key] == want[key], key
    for a, b in zip(got["members"], want["members"], strict=True):
        for key in ("member", "seed", "best_metric", "best_epoch",
                    "history"):
            assert a[key] == b[key], key
    assert got["best"] <= got["mean"]


def _forge(cli, reg, *args):
    """``cli forge --registry reg *args`` -> (rc, stdout, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli(["forge", "--registry", reg, *args])
    return rc, out.getvalue(), err.getvalue()


def test_forge_crosses_packages_both_ways(wines, tmp_path):
    jw, tw = wines
    x = np.asarray(tw.loader.original_data.map_read()[:12], np.float32)
    reg = str(tmp_path / "registry")
    # the reference's export, registered by the reference's CLI, fetched
    # and served by the port
    jpkg = jexport.export_forward(jw, str(tmp_path / "jwine.npz"))
    assert _forge(jcli, reg, "upload", jpkg, "--name", "wine",
                  "--version", "1.0")[0] == 0
    served = texport.forge_fetch(reg, "wine", device="cpu")
    np.testing.assert_allclose(served(x), jexport.ExportedForward(jpkg)(x),
                               rtol=0, atol=SERVE_ATOL)
    # the port's export, registered by the port's CLI, fetched by the
    # reference
    tpkg = texport.export_forward(tw, str(tmp_path / "twine.npz"))
    rc, out, _ = _forge(tcli, reg, "upload", tpkg, "--name", "wine",
                        "--version", "1.10")
    assert rc == 0 and out.startswith("uploaded wine==1.10 (sha256 ")
    assert texport.forge_list(reg) == jexport.forge_list(reg) == \
        {"wine": ["1.0", "1.10"]}
    rc, out, _ = _forge(tcli, reg, "list")
    assert rc == 0 and out == "wine: 1.0, 1.10\n"
    np.testing.assert_allclose(
        jexport.forge_fetch(reg, "wine")(x),      # latest: 1.10
        texport.ExportedForward(tpkg, device="cpu")(x), rtol=0,
        atol=SERVE_ATOL)
    dest = tmp_path / "fetched.npz"
    rc, out, _ = _forge(tcli, reg, "fetch", "wine", "--version", "1.0",
                        "-o", str(dest))
    assert rc == 0 and out.strip() == str(dest)
    assert dest.read_bytes() == open(jpkg, "rb").read()


def test_forge_errors_are_the_reference_one_liners(tmp_path):
    pkg = tmp_path / "pkg.npz"
    np.savez(pkg, w=np.arange(4.0))
    for cli_args in (("upload", str(pkg), "--name", "demo", "--version",
                      "1"),
                     ("fetch", "nosuch"),
                     ("upload", str(tmp_path / "missing.npz"), "--name",
                      "x", "--version", "1")):
        results = []
        for cli, name in ((jcli, "jreg"), (tcli, "treg")):
            reg = str(tmp_path / name)
            _forge(cli, reg, "upload", str(pkg), "--name", "demo",
                   "--version", "1")
            rc, _, err = _forge(cli, reg, *cli_args)
            results.append((rc, err.replace(reg, "REG")))
        assert results[0] == results[1]
        rc, err = results[1]
        assert rc == 2 and err.startswith("forge: ") and \
            err.count("\n") == 1
    # corruption: the sha256 check refuses the stored file
    errs = []
    for cli, name in ((jcli, "jreg"), (tcli, "treg")):
        reg = tmp_path / name
        (reg / "demo-1.npz").write_bytes(b"corrupted")
        rc, _, err = _forge(cli, str(reg), "fetch", "demo")
        errs.append((rc, err))
    assert errs[0] == errs[1] == (
        2, "forge: forge package demo==1 is corrupt (sha256 mismatch)\n")


def test_collect_report_is_the_reference_but_device_and_versions(wines):
    import torch

    jw, tw = wines
    got, want = collect_report(tw), jcollect(jw)
    assert got.keys() == want.keys()
    assert got["device"] == "cpu"
    assert got["versions"] == {"torch": torch.__version__,
                               "cuda": torch.version.cuda}
    for key in ("name", "class_lengths", "history", "best_metric",
                "best_epoch", "artifacts"):
        assert got[key] == want[key], key
    # the same config tree, but the data directories: the port's lie
    # under its checkout
    dirs = {k for k, v in want["config"].items() if "/.data/" in v}
    assert got["config"].keys() == want["config"].keys()
    assert {k: v for k, v in got["config"].items() if k not in dirs} == \
        {k: v for k, v in want["config"].items() if k not in dirs}
    # the same units in the timing table (its rows are ordered by time)
    assert sorted(ln.split()[0] for ln in got["timing"].splitlines()) == \
        sorted(ln.split()[0] for ln in want["timing"].splitlines())


@pytest.mark.parametrize("backend,ext", [("markdown", ".md"),
                                         ("html", ".html")])
def test_publisher_renders_the_torch_versions(wines, tmp_path, backend,
                                              ext):
    import torch

    path = Publisher(backend=backend,
                     directory=str(tmp_path)).publish(wines[1])
    assert path == str(tmp_path / f"wine_report{ext}")
    text = open(path).read()
    assert "Wine" in text and torch.__version__ in text
    assert "jax" not in text.lower().split("config")[0]


def test_manhole_repl_session():
    """The reference's session: expressions echo their repr, statements
    exec with stdout captured, errors return a traceback without killing
    the session; the socket is 0600 in a 0700 directory and is removed
    at stop."""
    hole = Manhole(namespace={"answer": 41})
    path = hole.start()
    try:
        assert stat.S_ISSOCK(os.stat(path).st_mode)
        assert stat.S_IMODE(os.stat(path).st_mode) == 0o600
        assert stat.S_IMODE(os.stat(os.path.dirname(path)).st_mode) == \
            0o700
        conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        conn.settimeout(5)
        conn.connect(path)
        for line in ("answer + 1", "x = answer * 2", "print(x)", "1/0"):
            conn.sendall(line.encode() + b"\n")
        out = ""
        deadline = time.monotonic() + 5
        while "ZeroDivisionError" not in out and \
                time.monotonic() < deadline:
            out += conn.recv(65536).decode()
        assert "manhole" in out and "42" in out and "82" in out
        assert "ZeroDivisionError" in out
        conn.sendall(b"answer\n")
        reply = ""
        while "41" not in reply and time.monotonic() < deadline:
            reply += conn.recv(65536).decode()
        assert "41" in reply                         # the session survived
        conn.close()
    finally:
        hole.stop()
    assert hole._sock.fileno() == -1
    assert not hole._thread.is_alive()
    assert not os.path.exists(path)


def test_launcher_serves_manhole_during_the_run():
    """``Launcher(manhole_path="")`` serves the live workflow's namespace
    while it runs (a session reads its epoch) and tears it down after."""
    tprng.seed_all(3)
    launcher = Launcher(device=TorchDevice("cpu"), manhole_path="")
    launcher.load(twine.build, max_epochs=2, n_train=60, n_valid=30,
                  minibatch_size=10)
    seen = {}
    wf = launcher.workflow
    orig_run = wf.decision.run

    def probing_run():
        orig_run()
        if launcher.manhole is not None and "reply" not in seen and \
                wf.decision.metrics_history:
            conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            conn.settimeout(5)
            conn.connect(launcher.manhole.path)
            conn.sendall(b"(wf.name, int(wf.decision.epoch_number))\n")
            reply = ""
            while ")" not in reply.split(">>>", 1)[-1]:
                reply += conn.recv(65536).decode()
            seen["reply"] = reply
            conn.close()

    wf.decision.run = probing_run
    launcher.main()
    assert "('Wine', 1)" in seen.get("reply", ""), seen
    assert launcher.manhole._sock.fileno() == -1
    assert not os.path.exists(launcher.manhole.path)


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=5) as r:
        return r.status, r.read()


def test_web_status_snapshot_and_endpoints(wines):
    jw, tw = wines
    got = WebStatus(port=0).register(tw).snapshot()
    want = JWebStatus(port=0).register(jw).snapshot()
    assert got.keys() == want.keys()
    (g,), (w,) = got["workflows"], want["workflows"]
    for key in ("name", "epoch", "complete", "best_metric", "history"):
        assert g[key] == w[key], key
    assert [(u["name"], u["runs"]) for u in g["units"]] == \
        [(u["name"], u["runs"]) for u in w["units"]]
    ws = WebStatus(port=0).register(tw)
    port = ws.start()
    try:
        status, body = _get(port, "/status.json")
        doc = json.loads(body)
        assert status == 200 and doc["workflows"][0]["name"] == "Wine"
        assert doc["workflows"][0]["complete"] is True
        assert len(doc["workflows"][0]["history"]) == 3
        for path in ("/metrics", "/trace.json", "/timeseries.json", "/"):
            assert _get(port, path)[0] == 200, path
        assert b"Wine" in _get(port, "/")[1]
    finally:
        ws.stop()
