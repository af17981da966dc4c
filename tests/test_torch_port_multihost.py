"""The port's multi-process join (``znicz_tpu_torch/launcher.py
multihost``, the CLI's ``--coordinator/--num-processes/--process-id``),
the counterpart of ``tests/test_multihost.py``:

- two CLI processes join one gloo world through ``--coordinator`` and
  train a fused ``StandardWorkflow`` data-parallel under
  ``shard_params`` with the snapshotter on: both exit 0 with the same
  history and bit-identical weights, that history is a single
  process's and the weights within the cross-world band of its; rank 0
  alone writes each snapshot and rank 1 verifies it;
- ``wait_for_coordinator`` raises ``CoordinatorUnreachable`` within a
  short ``RetryPolicy`` (and so does ``multihost`` on a rank above 0);
  bad addresses, ranks and flag sets are refused;
- on the card (``cuda`` marker): a CUDA step over a gloo group raises
  when built, and a one-rank NCCL world trains MNIST FC in each layout
  bit-identically to the step without a group.

This file imports no jax.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from _torch_dp_world import REPO, free_port
from znicz_tpu_torch.core import prng as tprng
from znicz_tpu_torch.core.backends import TorchDevice
from znicz_tpu_torch.launcher import (CoordinatorUnreachable, multihost,
                                      wait_for_coordinator)
from znicz_tpu_torch.resilience.retry import RetryPolicy
from znicz_tpu_torch.standard_workflow import StandardWorkflow

#: a world-2 run against one process (tests/test_snapshotter.py:136)
RESUME_RTOL, RESUME_ATOL = 1e-4, 1e-5

LAYERS = [{"type": "all2all_tanh", "->": {"output_sample_shape": 12},
           "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}},
          {"type": "softmax", "->": {"output_sample_shape": 4},
           "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}}]
LOADER = {"n_classes": 4, "sample_shape": (6,), "n_train": 64,
          "n_valid": 32, "minibatch_size": 16}

WORKFLOW = textwrap.dedent('''
    import json, os
    import numpy as np
    from znicz_tpu_torch.snapshotter import process_rank_world
    from znicz_tpu_torch.standard_workflow import StandardWorkflow

    def build():
        return StandardWorkflow(
            name="MultihostWf", layers={layers!r},
            loss_function="softmax", loader_name="synthetic_classifier",
            loader_config={loader!r}, decision_config={{"max_epochs": 3}},
            snapshotter_config={{"directory": {snaps!r}, "prefix": "mh",
                                 "only_improved": False,
                                 "keep_all": True}},
            fused=True, shard_params=True)

    def run(load, main):
        w, _ = load(build)
        main()
        rank, world = process_rank_world()
        out = {{"rank": rank, "world": world,
                "mesh": w.step.mesh.shape["data"],
                "hist": [h["metric_validation"]
                         for h in w.decision.metrics_history],
                "verified": w.snapshotter.verified_ok,
                "w": [f.weights.map_read().tolist() for f in w.forwards]}}
        with open(os.path.join({out!r}, f"rank{{rank}}.json"), "w") as f:
            json.dump(out, f)
''')


def test_two_cli_processes_join_through_the_coordinator(tmp_path):
    snaps, out = tmp_path / "snaps", tmp_path / "out"
    out.mkdir()
    wf = tmp_path / "wf.py"
    wf.write_text(WORKFLOW.format(layers=LAYERS, loader=LOADER,
                                  snaps=str(snaps), out=str(out)))
    coord = f"127.0.0.1:{free_port()}"
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "znicz_tpu_torch", str(wf), "-d", "cpu",
         "--random-seed", "5", "--coordinator", coord,
         "--num-processes", "2", "--process-id", str(i)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for i in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=180)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], \
        [log[-3000:] for log in logs]
    ranks = [json.loads((out / f"rank{r}.json").read_text())
             for r in range(2)]
    assert [(r["rank"], r["world"], r["mesh"]) for r in ranks] == \
        [(0, 2, 2), (1, 2, 2)]
    assert ranks[0]["hist"] == ranks[1]["hist"]
    for a, b in zip(ranks[0]["w"], ranks[1]["w"]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # rank 0 wrote every epoch's snapshot, rank 1 verified each
    assert sorted(os.listdir(snaps)) == ["mh_1.npz", "mh_2.npz", "mh_3.npz",
                                         "mh_latest.npz"]
    assert ranks[1]["verified"] == 3 and ranks[0]["verified"] == 0
    # one process from the same seed: the same history, the weights
    # within the cross-world band
    tprng.seed_all(5)
    w = StandardWorkflow(
        name="MultihostWf", layers=LAYERS, loss_function="softmax",
        loader_name="synthetic_classifier", loader_config=LOADER,
        decision_config={"max_epochs": 3}, fused=True)
    w.initialize(device=TorchDevice("cpu"))
    w.run()
    w.step.sync_to_units()
    assert [h["metric_validation"] for h in w.decision.metrics_history] \
        == ranks[0]["hist"]
    for f, got in zip(w.forwards, ranks[0]["w"]):
        np.testing.assert_allclose(np.asarray(got, np.float32),
                                   f.weights.map_read(), rtol=RESUME_RTOL,
                                   atol=RESUME_ATOL)


def _short_policy():
    return RetryPolicy(max_attempts=3, base_delay=0.01, multiplier=1.0,
                       max_delay=0.01, jitter=0.0, retryable=(OSError,))


def test_unreachable_coordinator_raises_within_the_policy():
    coord = f"127.0.0.1:{free_port()}"          # nobody listens there
    policy = _short_policy()
    with pytest.raises(CoordinatorUnreachable, match=coord):
        wait_for_coordinator(coord, policy, connect_timeout=0.2)
    assert policy.total_attempts == 3
    with pytest.raises(CoordinatorUnreachable):
        multihost(coord, 2, 1, connect_policy=_short_policy(),
                  device="cpu")


@pytest.mark.parametrize("call,match", [
    (lambda: wait_for_coordinator("no-port"), "host:port"),
    (lambda: multihost("127.0.0.1:1", 2, 2, device="cpu"), "not a rank"),
    (lambda: multihost("127.0.0.1:1", 2, -1, device="cpu"), "not a rank")])
def test_bad_addresses_and_ranks_are_refused(call, match):
    with pytest.raises(ValueError, match=match):
        call()


def test_coordinator_needs_the_world_flags(tmp_path):
    from znicz_tpu_torch.__main__ import main

    wf = tmp_path / "wf.py"
    wf.write_text("def run(load, main):\n    pass\n")
    with pytest.raises(SystemExit, match="--num-processes"):
        main([str(wf), "-d", "cpu", "--coordinator", "127.0.0.1:1"])


# -- on the card ------------------------------------------------------------

def _one_rank_world(backend: str):
    """A world of one in this process (destroyed by the caller)."""
    import torch.distributed as dist

    dist.init_process_group(backend,
                            init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    return dist


def _mnist(layout: str):
    from znicz_tpu_torch.models import mnist_fc

    tprng.seed_all(3)
    return mnist_fc.build_fused(
        max_epochs=2, layers=(64,), minibatch_size=32, n_train=128,
        n_valid=32, optimizer="adam", shard_update=layout != "replicated",
        shard_params=layout == "shard_params")


@pytest.mark.cuda
def test_cuda_step_on_a_gloo_group_raises():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dist = _one_rank_world("gloo")
    try:
        w = _mnist("replicated")
        with pytest.raises(RuntimeError, match="needs a nccl group"):
            w.initialize(device=TorchDevice("cuda"))
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_one_rank_nccl_world_matches_the_ungrouped_step():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    want = {}
    for layout in ("replicated", "shard_update", "shard_params"):
        w = _mnist(layout)
        w.initialize(device=TorchDevice("cuda"))
        w.run()
        w.step.sync_to_units()
        want[layout] = [f.weights.map_read().copy() for f in w.forwards]
    dist = _one_rank_world("nccl")
    try:
        for layout, weights in want.items():
            w = _mnist(layout)
            w.initialize(device=TorchDevice("cuda"))
            assert w.step.mesh.group is not None
            w.run()
            w.step.sync_to_units()
            for f, b in zip(w.forwards, weights):
                np.testing.assert_array_equal(f.weights.map_read(), b)
    finally:
        dist.destroy_process_group()
