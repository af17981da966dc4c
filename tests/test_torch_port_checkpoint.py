"""Sharded checkpoints (``znicz_tpu_torch/parallel/checkpoint.py``, on
``torch.distributed.checkpoint``) of the transformer step's params on a
gloo world of 8 on the CPU, the cases of
``tests/test_transformer_spmd.py:236`` and ``:422``: 3 steps of lr 0.1
on ``(data, seq, model)`` ``(2, 2, 2)``, saved, then restored onto
``(4, 1, 2)`` (and the vocab-sharded head onto a replicated one, on
``(8, 1, 1)`` and in one process with no world) and onto ``(2, 2, 2)``:

- every rank's restored blocks equal its block of the saved params
  (each block the first holder's copy), bit for bit;
- the next step's loss from the restored params on the new mesh equals
  the one on the first mesh from the same checkpoint within 1e-6;
- against the JAX package's step on the virtual CPU devices (the plain
  case): the saved params within 1e-5 of its first device's copies,
  the losses within rtol 1e-5.  A replica of a replicated leaf takes its own gradient in
  both packages, so the run that goes on with its replicas is not the
  run restored from the checkpoint (the reference's own slow-marked
  orbax tests, which compare the two, fail for that reason); the port's
  live continuation is held against the reference's.

One module-scoped spawn (``tests/_torch_dp_world.py``); the JAX runs
are made here, in a module-scoped fixture.
"""

import numpy as np
import pytest
import torch

import jax

import _torch_dp_world as world
from znicz_tpu.parallel import transformer as jtfm
from znicz_tpu.parallel.mesh import make_mesh as jmake_mesh

from znicz_tpu_torch.parallel import checkpoint as tckpt
from znicz_tpu_torch.parallel import transformer as tfm

#: layers, d, heads, ff, vocab
ARCH = (1, 32, 4, 64, 16)
LR, STEPS = 0.1, 3
#: restored against the first mesh (same params, another layout); the
#: port against the JAX package (ROADMAP.md's band for the step)
RESTORE_RTOL, PARAM_ATOL, LOSS_RTOL = 1e-6, 1e-5, 1e-5


def _axes(d, s, m):
    return {"data": d, "seq": s, "model": m}


#: one OSError planted on one rank of the world: rank 0's os.replace of
#: the written directory, rank 1's DCP write
PLANTED = ("replace", "write")

#: name -> (first mesh, second mesh, head_sharded)
CASES = {"plain": (_axes(2, 2, 2), _axes(4, 1, 2), False),
         "head_sharded": (_axes(2, 2, 2), _axes(8, 1, 1), True)}


@pytest.fixture(scope="module")
def inits():
    rng = np.random.default_rng(8)
    tokens = rng.integers(0, ARCH[4], (8, 8)).astype(np.int32)
    return {"ckpt": {"arch": ARCH, "lr": LR, "steps": STEPS,
                     "params": tfm.init_params(np.random.default_rng(29),
                                               *ARCH),
                     "tokens": tokens,
                     "labels": ((tokens + 1) % ARCH[4]).astype(np.int32)}}


@pytest.fixture(scope="module")
def run(inits, tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt")
    cases = [{"fn": "ckpt", "mesh_a": a, "mesh_b": b, "head_sharded": hs,
              "path": str(root / name)}
             for name, (a, b, hs) in CASES.items()] + [
        {"fn": "ckpt_retry", "fail": fail, "path": str(root / fail)}
        for fail in PLANTED]
    return {"ranks": world.run_world(8, cases, inits), "root": root}


@pytest.fixture(scope="module")
def jax_runs(inits):
    """The reference on the plain case: STEPS steps on the first mesh;
    its first device's params; the next step's loss from them on the
    second mesh, and the live continuation on the first.  (The
    head-sharded step on (2, 2, 2) is held against the JAX step in
    tests/test_torch_port_lm_axes.py.)"""
    init = inits["ckpt"]
    batch = (init["tokens"], init["labels"])
    a, b, _hs = CASES["plain"]
    step_a, _ = jtfm.make_train_step(jmake_mesh(a), *ARCH, lr=LR)
    p = init["params"]
    for _ in range(STEPS):
        p, _loss = step_a(p, *batch)
    host = jax.tree.map(np.asarray, p)
    step_b, _ = jtfm.make_train_step(jmake_mesh(b), *ARCH, lr=LR)
    return {"saved": host, "restored_b": float(step_b(host, *batch)[1]),
            "live_a": float(step_a(p, *batch)[1])}


def _flat(tree) -> list:
    """The leaves by name (the JAX package's pytrees sort their keys)."""
    return [np.asarray(a) for a in [tree["emb"], tree["head"]] + [
        blk[k] for blk in tree["blocks"] for k in sorted(blk)]]


@pytest.mark.parametrize("name", list(CASES))
def test_checkpoint_restores_onto_another_mesh(run, name):
    """Every rank's restored blocks are its blocks of the saved params,
    on the second mesh and on the first, and the next loss on the second
    equals the first's from the same checkpoint."""
    ranks = [r[list(CASES).index(name)] for r in run["ranks"]]
    for r in ranks:
        assert r["blocks_equal_a"] and r["blocks_equal_b"]
        np.testing.assert_allclose(r["restored_b"], r["restored_a"],
                                   rtol=RESTORE_RTOL)


def test_checkpointed_run_matches_jax(run, jax_runs):
    """The saved params, the restored run on the second mesh and the live
    continuation on the first, against the JAX package's."""
    for r in (rank[0] for rank in run["ranks"]):
        np.testing.assert_allclose(r["restored_b"], jax_runs["restored_b"],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["live_a"], jax_runs["live_a"],
                                   rtol=LOSS_RTOL)
    for got, want in zip(_flat(run["ranks"][0][0]["saved"]),
                         _flat(jax_runs["saved"])):
        np.testing.assert_allclose(got, want, atol=PARAM_ATOL)


def test_live_replicas_are_not_the_checkpoint(run):
    """Both packages: the replicas of the replicated leaves diverged in
    the 3 steps, so going on with them is another run than the one
    restored from the first holders' copies."""
    for r in (rank[0] for rank in run["ranks"]):
        assert abs(r["live_a"] - r["restored_a"]) > 1e-3 * r["restored_a"]


def test_vocab_sharded_checkpoint_restores_in_one_process(run, inits):
    """The head-sharded run's checkpoint, written by 8 ranks, restores
    whole in a process with no world (``like`` the replicated layout)
    and trains on there: the leaves as saved, the next loss the first
    mesh's from the same checkpoint within 1e-6."""
    init = inits["ckpt"]
    saved = run["ranks"][0][1]["saved"]
    like = tfm.params_from_numpy(init["params"], "cpu")
    got = tckpt.load_pytree(str(run["root"] / "head_sharded"), like=like)
    for a, b in zip(_flat(got), _flat(saved)):
        np.testing.assert_array_equal(a, b)
    step = tfm.make_train_step(None, *ARCH, lr=LR,
                               compute_dtype=torch.float32, device="cpu")
    loss = float(step(got, init["tokens"], init["labels"])[1])
    np.testing.assert_allclose(loss, run["ranks"][0][1]["restored_a"],
                               rtol=RESTORE_RTOL)


def test_load_without_like_is_the_saved_tree(run):
    saved = run["ranks"][0][0]["saved"]
    got = tckpt.load_pytree(str(run["root"] / "plain"), device="cpu")
    assert list(got) == list(saved)
    assert [list(b) for b in got["blocks"]] == \
        [list(b) for b in saved["blocks"]]
    for a, b in zip(_flat(got), _flat(saved)):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_save_replaces_the_directory_whole(tmp_path):
    """A second save to the same path leaves only the second checkpoint
    and no partial directory; a pipeline step's flat pytree round-trips."""
    params = tfm.params_from_numpy(tfm.init_moe_pipeline_params(
        np.random.default_rng(1), 2, 8, 16, 2), "cpu")
    path = str(tmp_path / "ck")
    tckpt.save_pytree(path, params)
    doubled = {k: 2 * v for k, v in params.items()}
    assert tckpt.save_pytree(path, doubled, retry=None) == path
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ck"]
    got = tckpt.load_pytree(path, like=params)
    for k in params:
        assert torch.equal(got[k], doubled[k])


def test_load_without_like_goes_to_the_card(run):
    """Without ``like`` the leaves go to the card unless the caller asks
    for the CPU: no silent CPU fallback on a host with no card."""
    path = str(run["root"] / "plain")
    if torch.cuda.is_available():
        got = tckpt.load_pytree(path)
        assert got["emb"].device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            tckpt.load_pytree(path)


@pytest.mark.parametrize("fail", PLANTED)
def test_save_retries_a_failure_on_one_rank(run, fail):
    """One OSError on one rank of 8 (rank 0's ``os.replace``, rank 1's
    write): every rank learns of it and retries once, together, and the
    save finishes and restores (a retry on the failing rank alone would
    pair its barriers with the others' and hang)."""
    i = len(CASES) + PLANTED.index(fail)
    ranks = [r[i] for r in run["ranks"]]
    assert ranks[0 if fail == "replace" else 1]["fired"]
    for r in ranks:
        assert r["retries"] == 1 and r["equal"]
    assert not (run["root"] / f"{fail}.partial").exists()
