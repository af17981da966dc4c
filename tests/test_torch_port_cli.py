"""The port's workflow CLI and launcher on the CPU (``python -m
znicz_tpu_torch <workflow.py> [config.py ...]``, ``launcher.py``): the
``load``/``main`` contract of the models' ``run``, snapshot resume
through ``Launcher(snapshot=)`` and ``-w``, the CLI end to end with a
config file and ``-o`` overrides, every flag and subcommand of the
reference running (``--optimize``, ``--ensemble-train``, ``--manhole``,
``--publish`` and ``forge`` among them), the device defaulting to cuda (and raising without a card), and
SIGTERM ending a run at an epoch end with exit code 143 and a final
snapshot that resumes bit-exact."""

import glob
import json
import os
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

import znicz_tpu_torch.__main__ as cli
from znicz_tpu_torch.core import prng
from znicz_tpu_torch.core.backends import NumpyDevice, TorchDevice
from znicz_tpu_torch.core.config import root
from znicz_tpu_torch.launcher import Launcher
from znicz_tpu_torch.models import alexnet, cifar_conv, mnist_conv
from znicz_tpu_torch.resilience import faults
from znicz_tpu_torch.snapshotter import verify_snapshot

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: a workflow file: AlexNet's layer list at 67 px and narrow widths,
#: fused, its epochs, snapshotter and result file read from
#: ``root.port_cli``; the result holds the history and a SHA-256 of every
#: weight and momentum leaf and of the step's generator state
WORKFLOW = textwrap.dedent("""
    import hashlib
    import json

    from znicz_tpu_torch.core.config import root
    from znicz_tpu_torch.models import alexnet
    from znicz_tpu_torch.standard_workflow import StandardWorkflow


    def build():
        cfg = root.port_cli
        snapshots = cfg.get("snapshotter_config")
        layers = alexnet.layers(n_classes=5, dropout=0.5)
        widths = iter((8, 16, 16, 16, 8))
        for spec in layers:
            if spec["type"] == "conv_str":
                spec["->"]["n_kernels"] = next(widths)
            elif spec["type"] == "all2all_str":
                spec["->"]["output_sample_shape"] = 32
        return StandardWorkflow(
            name="AlexNet-narrow", layers=layers, loss_function="softmax",
            loader_name="synthetic_image",
            loader_config={"n_classes": 5, "sample_shape": (67, 67, 3),
                           "n_train": 16, "n_valid": 8,
                           "minibatch_size": 8, "spread": 1.0,
                           "noise": 0.5},
            decision_config={"max_epochs": cfg.get("max_epochs", 2)},
            snapshotter_config=snapshots.as_dict() if snapshots else None,
            fused=True)


    def digests(w):
        w.step.sync_to_units()
        out = {}
        for i, (f, g) in enumerate(zip(w.forwards, w.gds)):
            for name, arr in (("w", f.weights), ("b", f.bias),
                              ("vw", g.gradient_weights),
                              ("vb", g.gradient_bias)):
                if arr:
                    out[f"{i}.{name}"] = hashlib.sha256(
                        arr.map_read().tobytes()).hexdigest()
        out["generator"] = hashlib.sha256(
            w.step._gen.get_state().numpy().tobytes()).hexdigest()
        return out


    def run(load, main):
        w, _ = load(build)
        main()
        out = root.port_cli.get("result_file", None)
        if out:
            with open(out, "w") as f:
                json.dump({"history": w.decision.metrics_history,
                           "digests": digests(w)}, f)
""")


@pytest.fixture(autouse=True)
def _clean_root_and_faults():
    yield
    faults.uninstall()
    del root.port_cli


@pytest.fixture
def wf(tmp_path):
    path = tmp_path / "alexnet_narrow_wf.py"
    path.write_text(WORKFLOW)
    return str(path)


def _result(path):
    with open(path) as f:
        return json.load(f)


# -- the load/main contract ----------------------------------------------------

MODEL_KW = {
    alexnet: {"input_size": 67, "n_classes": 10, "n_train": 16,
              "n_valid": 8, "minibatch_size": 8},
    mnist_conv: {"loader_name": "synthetic_image", "n_train": 40,
                 "n_valid": 20, "minibatch_size": 20},
    cifar_conv: {"loader_name": "synthetic_image", "n_train": 40,
                 "n_valid": 20, "minibatch_size": 20},
}


@pytest.mark.parametrize("model", list(MODEL_KW),
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_launcher_load_main_contract(model):
    """A model's ``run(load, main)``: ``load(build)`` builds through the
    launcher, ``main()`` initializes on the launcher's device, runs and
    stops."""
    prng.seed_all(3)
    launcher = Launcher(device=TorchDevice("cpu"))
    model.run(lambda b, **kw: launcher.load(b, max_epochs=2,
                                            **MODEL_KW[model], **kw),
              launcher.main)
    w = launcher.workflow
    assert bool(w.decision.complete)
    assert len(w.decision.metrics_history) == 2
    assert type(w.step).__name__ == "FusedTrainStep"
    assert w.step._dev.type == "cpu" and launcher.restore_seconds is None
    assert "FusedStep" in w.timing_table()


def test_launcher_requires_load_before_main():
    with pytest.raises(RuntimeError, match="load"):
        Launcher(device=TorchDevice("cpu")).main()


def _snap_build(snap_dir=None, max_epochs=4):
    cfg = None if snap_dir is None else {
        "directory": str(snap_dir), "prefix": "w", "only_improved": False,
        "keep_all": True}
    return cifar_conv.build(max_epochs=max_epochs, snapshotter_config=cfg,
                            **MODEL_KW[cifar_conv])


def test_launcher_snapshot_resume(tmp_path):
    prng.seed_all(3)
    w = _snap_build(tmp_path)
    w.initialize(device=TorchDevice("cpu"))
    w.run()
    w.stop()
    snap = tmp_path / "w_2.npz"
    assert snap.exists()
    prng.seed_all(3)
    launcher = Launcher(device=TorchDevice("cpu"), snapshot=str(snap))
    res, from_snapshot = launcher.load(_snap_build)
    assert from_snapshot
    launcher.main()
    assert res.decision.metrics_history == w.decision.metrics_history
    assert launcher.restore_seconds > 0
    for a, b in zip(res.forwards, w.forwards):
        if a.weights:
            np.testing.assert_array_equal(a.weights.map_read(),
                                          b.weights.map_read())


# -- the CLI ---------------------------------------------------------------------

def test_cli_end_to_end_and_resume_with_w(wf, tmp_path):
    """A config file, ``-o`` overrides (a dict among them) and the seed
    flag; then ``-w`` resumes the epoch-1 snapshot of that run to epoch
    2, and the history and every digest equal a 2-epoch run's."""
    cfg = tmp_path / "cfg.py"
    cfg.write_text("root.port_cli.max_epochs = 1\n")
    snaps = tmp_path / "snaps"
    first = tmp_path / "first.json"
    assert cli.main([wf, str(cfg), "--random-seed", "5", "-d", "cpu",
                     "-o", f"root.port_cli.result_file={first}",
                     "-o", "root.port_cli.snapshotter_config={"
                     f"'directory': '{snaps}', 'prefix': 'a', "
                     "'only_improved': False}"]) == 0
    assert len(_result(first)["history"]) == 1
    snap = snaps / "a_1.npz"
    assert verify_snapshot(str(snap))
    assert os.readlink(snaps / "a_latest.npz") == "a_1.npz"
    del root.port_cli
    resumed = tmp_path / "resumed.json"
    assert cli.main([wf, "--random-seed", "5", "-d", "cpu", "-w", str(snap),
                     "-o", "root.port_cli.max_epochs=2",
                     "-o", f"root.port_cli.result_file={resumed}"]) == 0
    del root.port_cli
    straight = tmp_path / "straight.json"
    assert cli.main([wf, "--random-seed", "5", "-d", "cpu",
                     "-o", "root.port_cli.max_epochs=2",
                     "-o", f"root.port_cli.result_file={straight}"]) == 0
    assert _result(resumed) == _result(straight)
    assert _result(resumed)["history"][0] == _result(first)["history"][0]


def test_cli_trace_export(wf, tmp_path):
    out = tmp_path / "trace.json"
    assert cli.main([wf, "-d", "cpu", "-o", "root.port_cli.max_epochs=1",
                     "--trace", str(out)]) == 0
    doc = json.loads(out.read_text())
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    assert any(e.get("name") == "workflow.step" for e in events)


def test_cli_numpy_device_choice_builds_a_numpy_device():
    assert isinstance(cli.make_device("numpy"), NumpyDevice)
    assert cli.make_device("cpu").torch_device.type == "cpu"


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host "
                    "without a CUDA device")
def test_cli_device_defaults_to_cuda_and_raises_without_a_card(wf):
    for argv in ([wf], [wf, "-d", "auto"], [wf, "-d", "cuda"]):
        with pytest.raises(RuntimeError, match="CUDA device was requested"):
            cli.main(argv + ["-o", "root.port_cli.max_epochs=1"])


@pytest.mark.parametrize("flag,item", [
    (["--optimize", "2"], "14"), (["--ensemble-train", "2"], "14"),
    (["--manhole"], "14"), (["--publish", "markdown"], "14"),
    (["--profile", "prof"], "14")])
def test_unported_flags_raise_with_their_item(wf, flag, item, tmp_path,
                                              monkeypatch, capsys):
    """Every flag of the reference runs (queue A item ``item`` closed):
    ``--optimize`` over a ``Tune`` routes the population evaluator and
    refuses ``--publish`` and ``--manhole``; ``--ensemble-train`` writes
    the reference's summary; ``--manhole`` serves the run and removes its
    socket; ``--publish`` writes the report naming the device;
    ``--profile`` writes its profiler trace."""
    from znicz_tpu_torch.core.config import Tune
    from znicz_tpu_torch.utils import manhole

    monkeypatch.chdir(tmp_path)
    argv = [wf, "-d", "cpu"] + flag
    if flag[0] == "--optimize":
        root.port_cli.max_epochs = Tune(1, 1, 1)
        for extra in (["--publish", "markdown"], ["--manhole"]):
            assert cli.main(argv + extra) == 2
        assert cli.main(argv) == 0
        assert "'_evaluator': 'vmapped'" in capsys.readouterr().out
        return
    argv += ["-o", "root.port_cli.max_epochs=1"]
    if flag[0] == "--profile":
        prof = tmp_path / "prof"
        assert cli.main([wf, "-d", "cpu", "--profile", str(prof), "-o",
                         "root.port_cli.max_epochs=1"]) == 0
        from znicz_tpu_torch.utils.profiling import summarize_trace
        assert summarize_trace(str(prof))
        return
    if flag[0] == "--ensemble-train":
        assert cli.main(argv) == 0
        out = _result(tmp_path / "ensemble_alexnet-narrow.json")
        assert out["n_members"] == 2 and len(out["members"]) == 2
        assert [m["seed"] for m in out["members"]] == [1, 2]
        assert cli.main(argv + ["--publish", "markdown"]) == 2
        return
    if flag[0] == "--manhole":
        served = []
        start = manhole.Manhole.start
        monkeypatch.setattr(manhole.Manhole, "start",
                            lambda self: served.append(start(self)) or
                            served[-1])
        assert cli.main(argv) == 0
        assert len(served) == 1 and not os.path.exists(served[0])
        return
    assert cli.main(argv) == 0
    text = (tmp_path / "alexnet-narrow_report.md").read_text()
    assert "- device: `cpu`" in text and f"- torch: {torch.__version__}" \
        in text


@pytest.mark.parametrize("sub,item", [
    ("fleet", "14"), ("learn", "14"), ("elastic", "14"),
    ("flight", "14"), ("trace", "14"), ("forge", "14")])
def test_unported_subcommands_raise_with_their_item(sub, item, capsys):
    """Every subcommand of the reference but ``aot`` is ported and
    reaches its own parser, which refuses the bad argument."""
    if sub in ("fleet", "learn"):
        assert cli.main([sub, "x", "--workers", "0"]) == 2
        assert "--workers must be >= 1" in capsys.readouterr().err
        return
    if sub in ("elastic", "forge"):
        with pytest.raises(SystemExit) as exc:
            cli.main([sub, "x"])       # no --snap-dir; no such command
        assert exc.value.code == 2
        return
    if sub in ("flight", "trace"):
        assert cli.main([sub, "x"]) in (1, 2)
        assert sub in capsys.readouterr().err
        return


@pytest.mark.parametrize("env", ["ZNICZ_TPU_HEARTBEAT",
                                 "ZNICZ_TPU_METRICS_EXPORT"])
def test_unported_envs_raise(wf, env, monkeypatch, tmp_path):
    """The elastic worker's envs are ported: the heartbeat file carries
    the run's progress, the metrics export file the rank-tagged
    registry."""
    import time as _time

    from znicz_tpu_torch.observe import federation

    path = tmp_path / "x"
    monkeypatch.setenv(env, str(path))
    monkeypatch.setenv(env + "_INTERVAL", "0.05")
    assert cli.main([wf, "-d", "cpu", "-o", "root.port_cli.max_epochs=1"]) \
        == 0
    deadline = _time.monotonic() + 30
    while _time.monotonic() < deadline and not path.exists():
        _time.sleep(0.05)
    text = path.read_text()
    if env == "ZNICZ_TPU_HEARTBEAT":
        ts, progress = text.split()
        assert float(ts) > 0 and int(progress) >= -1
    else:
        doc = json.loads(text)
        assert doc["schema"] == federation.EXPORT_SCHEMA
        assert federation.parse_prometheus(doc["prom"])


def test_launcher_unported_options_raise():
    """Every option of the reference's Launcher is ported: the manhole
    starts in ``main``, ``profile_dir`` is kept."""
    assert Launcher(profile_dir="p").profile_dir == "p"
    launcher = Launcher(manhole_path="")
    assert launcher.manhole_path == "" and launcher.manhole is None


def test_generate_keeps_its_route_and_the_fault_plan_env(monkeypatch):
    import znicz_tpu_torch.serve.server as server

    seen = []
    monkeypatch.setattr(server, "generate_main",
                        lambda argv: seen.append(argv) or 7)
    plan = faults.FaultPlan().crash_at("serve.run", at_hit=3)
    monkeypatch.setenv(faults.PLAN_ENV_VAR, plan.to_env())
    assert cli.main(["generate", "pkg.npz", "--device", "cpu"]) == 7
    assert seen == [["pkg.npz", "--device", "cpu"]]
    assert faults.get_plan() is not None
    assert cli.main(["aot", "pkg.npz"]) == 2


def test_serve_routes_to_serve_main(monkeypatch):
    import znicz_tpu_torch.serve.server as server

    seen = []
    monkeypatch.setattr(server, "serve_main",
                        lambda argv: seen.append(argv) or 5)
    assert cli.main(["serve", "pkg.npz", "--device", "cpu"]) == 5
    assert seen == [["pkg.npz", "--device", "cpu"]]


@pytest.mark.parametrize("env", ["ZNICZ_TPU_HEARTBEAT",
                                 "ZNICZ_TPU_METRICS_EXPORT"])
def test_generate_runs_with_the_fleet_envs_set(env, monkeypatch, tmp_path):
    """The fleet envs raise on the workflow path only: ``generate`` keeps
    the route it had before the workflow CLI came."""
    import znicz_tpu_torch.serve.server as server

    monkeypatch.setattr(server, "generate_main", lambda argv: 0)
    monkeypatch.setenv(env, str(tmp_path / "x"))
    assert cli.main(["generate", "pkg.npz", "--device", "cpu"]) == 0


def test_usage_and_parser_take_every_reference_flag(capsys):
    assert cli.main([]) == 2
    assert "python -m znicz_tpu_torch" in capsys.readouterr().err
    args = cli.build_parser().parse_args(
        ["wf.py", "c.py", "-d", "cpu", "--random-seed", "3", "-w", "s.npz",
         "-s", "-o", "root.a=1", "--optimize", "2", "--ensemble-train", "3",
         "--manhole=/tmp/m", "--profile", "p", "--trace", "t.json",
         "--publish", "html", "--coordinator", "h:1", "--num-processes",
         "2", "--process-id", "1"])
    assert args.configs == ["c.py"] and args.snapshot == "s.npz"
    assert cli._parse_value("{'a': (1, 2)}") == {"a": (1, 2)}
    assert cli._parse_value("not python") == "not python"


def test_site_config_layer(monkeypatch, tmp_path):
    site = tmp_path / "site.py"
    site.write_text("root.port_cli.max_epochs = 7\n")
    monkeypatch.setenv("ZNICZ_TPU_SITE_CONFIG", str(site))
    assert cli.apply_site_config() == str(site)
    assert root.port_cli.max_epochs == 7
    monkeypatch.setenv("ZNICZ_TPU_SITE_CONFIG", "")
    assert cli.apply_site_config() is None
    monkeypatch.setenv("ZNICZ_TPU_SITE_CONFIG", str(tmp_path / "missing"))
    with pytest.raises(SystemExit):
        cli.apply_site_config()


# -- SIGTERM: finish the epoch, snapshot, exit 143 ---------------------------------

def _cli_process(wf, *args):
    env = {**os.environ, "PYTHONPATH": REPO,
           "ZNICZ_TPU_SITE_CONFIG": ""}
    return subprocess.Popen(
        [sys.executable, "-m", "znicz_tpu_torch", wf, "-d", "cpu",
         "--random-seed", "5", *args], env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def test_sigterm_ends_at_an_epoch_with_a_final_snapshot_that_resumes(
        wf, tmp_path):
    snaps = tmp_path / "snaps"
    proc = _cli_process(
        wf, "-o", "root.port_cli.max_epochs=400",
        "-o", "root.port_cli.snapshotter_config={"
        f"'directory': '{snaps}', 'prefix': 's', 'only_improved': False}}",
        "-o", f"root.port_cli.result_file={tmp_path / 'never.json'}")
    try:
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and not glob.glob(
                str(snaps / "s_[0-9]*.npz")):
            if proc.poll() is not None:
                raise AssertionError(f"died early: {proc.communicate()[0]}")
            time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 143, out
    assert "SIGTERM" in out
    # terminated as asked is not completion: no result epilogue
    assert not (tmp_path / "never.json").exists()
    final = os.path.join(snaps, os.readlink(snaps / "s_latest.npz"))
    assert verify_snapshot(final)
    with np.load(final) as zf:
        meta = json.loads(str(zf["__meta__"]))
    epochs = meta["loader"]["epoch_number"]
    assert 1 <= epochs < 400 and not meta["decision"]["complete"]
    assert len(meta["decision"]["metrics_history"]) == epochs
    # the final snapshot resumes bit-exact against an uninterrupted run
    resumed, straight = tmp_path / "resumed.json", tmp_path / "straight.json"
    total = epochs + 1
    assert cli.main([wf, "-d", "cpu", "--random-seed", "5", "-w", final,
                     "-o", f"root.port_cli.max_epochs={total}",
                     "-o", f"root.port_cli.result_file={resumed}"]) == 0
    del root.port_cli
    assert cli.main([wf, "-d", "cpu", "--random-seed", "5",
                     "-o", f"root.port_cli.max_epochs={total}",
                     "-o", f"root.port_cli.result_file={straight}"]) == 0
    assert _result(resumed) == _result(straight)
    assert len(_result(resumed)["history"]) == total
