"""The char LM through the port's CLI on a gloo world of 4
(``python -m znicz_tpu_torch znicz_tpu_torch/models/char_lm.py -d cpu
--coordinator ... -o "root.char_lm.mesh={'data': 1, 'seq': 2, 'model':
2}"``, one process a rank) at the toy width of
``tests/test_torch_port_char_lm.py`` (1 layer, d 32, 2 heads, seq_len
32, minibatch 16, lr 0.05, 2 epochs, f32 on the CPU), against the JAX
package's char LM on a mesh of the same axes from the same seed:

- the decision's history (train and validation loss an epoch) within
  rtol 1e-4, as the one-process parity holds every minibatch's loss;
- the snapshot the world wrote (rank 0 writes, every rank gathers the
  params whole) restores into a one-process workflow, whose params are
  the JAX run's within 1e-5; the exported LM package holds the same
  params bit for bit;
- every rank's process exits 0.

Above ``seq`` or ``model`` 1 a run follows the reference's gradients,
in which each replica of a replicated leaf takes its own gradient (a
``psum``'s transpose is a ``psum``), so a world's history is held
against the JAX run on the same mesh; the ungrouped run is not the
same run (tests/test_torch_port_lm_axes.py holds the first step's
forward invariant across meshes).
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from znicz_tpu.core import prng as jprng
from znicz_tpu.core.backends import TPUDevice
from znicz_tpu.models import char_lm as jchar
from znicz_tpu.parallel.mesh import make_mesh as jmake_mesh

import _torch_dp_world as world
from znicz_tpu_torch.core import prng as tprng
from znicz_tpu_torch.core.backends import TorchDevice
from znicz_tpu_torch.loader import text as ttext
from znicz_tpu_torch.models import char_lm as tchar
from znicz_tpu_torch.snapshotter import restore_state
from znicz_tpu_torch.utils.export import load_lm

#: the history and the params, world against the JAX run (the bands of
#: tests/test_torch_port_char_lm.py)
MSE_RTOL, PARAM_ATOL = 1e-4, 1e-5
#: tests/test_torch_port_char_lm.py's width at the builder's default lr:
#: its lr 0.3 diverges on this mesh, in both packages (the replicas'
#: own gradients over seq and model, ROADMAP.md "Divergences")
SMALL = dict(seq_len=32, minibatch_size=16, n_layers=1, d=32, heads=2,
             lr=0.05)
MESH = {"data": 1, "seq": 2, "model": 2}
SEED, EPOCHS, WORLD = 7, 2, 4
TRAIN_LINES, TEST_LINES = 24, 8


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The corpus slice, the world's CLI run (its snapshot directory and
    exported package) -> paths."""
    tmp = tmp_path_factory.mktemp("lm_world")
    full, data = str(tmp / "full"), str(tmp / "corpus")
    ttext.ensure_corpus_files(full, synthesize=True)
    os.makedirs(data)
    for split, n in (("train", TRAIN_LINES), ("test", TEST_LINES)):
        with open(os.path.join(full, ttext.FILES[split])) as f:
            lines = f.readlines()[:n]
        with open(os.path.join(data, ttext.FILES[split]), "w") as f:
            f.writelines(lines)
    snaps, pkg = str(tmp / "snaps"), str(tmp / "lm.npz")
    port = world.free_port()
    args = dict(SMALL, max_epochs=EPOCHS, data_dir=data, mesh=MESH,
                snapshotter_config={"directory": snaps, "prefix": "lm",
                                    "only_improved": False})
    overrides = [f"root.char_lm.{k}={v!r}" for k, v in args.items()] + \
        [f"root.common.engine.lm_export={pkg}"]
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "znicz_tpu_torch",
         "znicz_tpu_torch/models/char_lm.py", "-d", "cpu",
         "--random-seed", str(SEED), "--coordinator", f"127.0.0.1:{port}",
         "--num-processes", str(WORLD), "--process-id", str(r)] +
        [a for o in overrides for a in ("-o", o)],
        cwd=world.REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return {"data": data, "snaps": snaps, "pkg": pkg, "logs": logs,
            "rcs": [p.returncode for p in procs]}


@pytest.fixture(scope="module")
def jax_run(run, cpu_devices):
    jprng.seed_all(SEED)
    w = jchar.build(max_epochs=EPOCHS, data_dir=run["data"],
                    mesh=jmake_mesh(MESH), **SMALL)
    w.initialize(device=TPUDevice())
    w.run()
    p = w.step._params
    return w.decision.metrics_history, {
        "emb": np.asarray(p["emb"]), "head": np.asarray(p["head"]),
        "blocks": [{k: np.asarray(a) for k, a in blk.items()}
                   for blk in p["blocks"]]}


def _last_snapshot(snaps) -> str:
    names = sorted(n for n in os.listdir(snaps) if n.endswith(".npz"))
    assert names, os.listdir(snaps)
    return os.path.join(snaps, names[-1])


def test_every_rank_exits_zero(run):
    assert run["rcs"] == [0] * WORLD, [log[-3000:] for log in run["logs"]]


def test_world_history_matches_jax_on_the_mesh(run, jax_run):
    with np.load(_last_snapshot(run["snaps"])) as zf:
        meta = json.loads(str(zf["__meta__"]))
    got = meta["decision"]["metrics_history"]
    want = jax_run[0]
    assert len(got) == len(want) == EPOCHS
    for g, w in zip(got, want):
        for key in ("metric_train", "metric_validation"):
            assert np.isfinite(g[key]), (key, got)
            np.testing.assert_allclose(g[key], w[key], rtol=MSE_RTOL,
                                       err_msg=key)
    # it trained
    assert got[-1]["metric_validation"] < got[0]["metric_validation"]


def test_snapshot_is_gathered_whole_and_matches_jax(run, jax_run, tmp_path):
    """The world's snapshot restores into a one-process workflow (the
    global params, not a rank's shards) and equals the JAX run's
    params; the export holds the same params."""
    data = str(tmp_path / "corpus")
    shutil.copytree(run["data"], data)
    tprng.seed_all(SEED)
    w = tchar.build(max_epochs=EPOCHS, data_dir=data, **SMALL)
    w.initialize(device=TorchDevice("cpu"))
    restore_state(w, _last_snapshot(run["snaps"]))
    got = w.step._global_params()
    want = jax_run[1]
    assert all(np.isfinite(a).all() for a in (got["emb"], got["head"]))
    for a, b in ((got["emb"], want["emb"]), (got["head"], want["head"])):
        np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_ATOL)
    for blk, ref in zip(got["blocks"], want["blocks"]):
        for k in ref:
            np.testing.assert_allclose(blk[k], ref[k], rtol=0,
                                       atol=PARAM_ATOL, err_msg=k)
    exported, _ = load_lm(run["pkg"])
    np.testing.assert_array_equal(exported["emb"], got["emb"])
    for blk, ref in zip(exported["blocks"], got["blocks"]):
        for k in ref:
            np.testing.assert_array_equal(blk[k], ref[k])
