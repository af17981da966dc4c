"""The port's genetic hyperparameter search (``znicz_tpu_torch/utils/
genetics.py``, ``--optimize``) against the JAX package on the CPU.

- The population evaluator on the small fused FC step of the
  reference's own test (``tests/test_cli_services.py``
  ``_staged_fc_step``: 784-32-10, batch 40, six staged minibatches of a
  learnable rule), P = 8 learning rates from 0 to 0.35: each
  individual's ``n_err`` identical to the reference's vmapped evaluator
  (both f32; the reference on a data mesh of one device), each equal bit
  for bit to the port's own sequential replay of the same
  hyperparameters (the units' values through the step's usual buffer
  write, the generator re-keyed by ``individual_seed``), the lr-0
  individual equal to the untrained step's error, and the step left as
  it was (params, hyperparameter buffer, generator).
- ``Genetics`` with a fixed fitness function: the same history and best
  in both packages (one numpy stream each).
- ``--optimize`` through both CLIs on Wine: the lr ``Tune`` routes
  ``'vmapped'``, the ``hidden`` ``Tune`` ``'sequential'``, and the best
  config and fitness are equal.

The framework-free functions (``Genetics``, ``optimize`` and the probe's
helpers) are held to the reference's code by
``tests/test_torch_port_isolation.py``.
"""

import ast
import contextlib
import io
import textwrap

import numpy as np
import pytest
import torch

from znicz_tpu.__main__ import main as jcli
from znicz_tpu.core import prng as jprng
from znicz_tpu.core.backends import TPUDevice
from znicz_tpu.core.config import Tune as JTune
from znicz_tpu.core.config import root as jroot
from znicz_tpu.core.config import set_by_path as jset
from znicz_tpu.models.mnist_fc import build_fused as jbuild_fused
from znicz_tpu.parallel.mesh import data_parallel_mesh
from znicz_tpu.utils import genetics as jgenetics

from znicz_tpu_torch.__main__ import main as tcli
from znicz_tpu_torch.core import prng as tprng
from znicz_tpu_torch.core.backends import TorchDevice
from znicz_tpu_torch.core.config import Tune as TTune
from znicz_tpu_torch.core.config import root as troot
from znicz_tpu_torch.core.config import set_by_path as tset
from znicz_tpu_torch.models.mnist_fc import build_fused as tbuild_fused
from znicz_tpu_torch.utils import genetics as tgenetics

#: the reference test's population: P learning rates (lr and lr_b)
P = 8
LRS = np.linspace(0.0, 0.35, P).astype(np.float32)


@pytest.fixture(autouse=True)
def _hermetic_site_config(monkeypatch):
    monkeypatch.setenv("ZNICZ_TPU_SITE_CONFIG", "")


def _staged(n_steps=6, batch=40):
    """The reference test's staged batches (tests/test_cli_services.py
    ``_staged_fc_step``), as numpy."""
    rng = np.random.default_rng(2)
    xs = rng.normal(size=(n_steps, batch, 28, 28)).astype(np.float32)
    ys = (xs[:, :, :14, :].sum((2, 3)) >
          xs[:, :, 14:, :].sum((2, 3))).astype(np.int32)
    ms = np.ones((n_steps, batch), bool)
    return xs, ys, ms


def _hyper_pop(base):
    pop = [{k: np.full(P, v, np.float32) for k, v in layer.items()}
           for layer in base]
    for layer in pop:
        layer["lr"] = LRS.copy()
        layer["lr_b"] = LRS.copy()
    return pop


def _port_step():
    tprng.seed_all(51)
    w = tbuild_fused(max_epochs=1, layers=(32,), minibatch_size=40,
                     n_train=240, n_valid=80)
    w.initialize(device=TorchDevice("cpu"))
    return w.step


def _sequential(step, i, lr, xs, ys, ms, ev, seed):
    """Individual ``i`` replayed alone: the saved state, the units'
    learning rates (the step's usual buffer write), the re-keyed
    generator, the train steps and one eval step."""
    saved = [{k: v.clone() for k, v in leaf.items()}
             for leaf in step._params]
    units = [(gd.learning_rate, gd.learning_rate_bias) for gd in step.gds]
    try:
        for gd in step.gds:
            gd.learning_rate = gd.learning_rate_bias = float(lr)
        step._gen.manual_seed(tgenetics.individual_seed(seed, i))
        step.train_steps(*(torch.from_numpy(a) for a in (xs, ys, ms)))
        return step._eval_step(*(torch.from_numpy(a) for a in ev))[
            "n_err"].clone()
    finally:
        step.place_params(saved)
        for gd, (lr_w, lr_b) in zip(step.gds, units):
            gd.learning_rate, gd.learning_rate_bias = lr_w, lr_b


def test_population_evaluator_matches_reference_and_sequential_replay():
    import jax
    import jax.numpy as jnp

    xs, ys, ms = _staged()
    ev = (xs[0], ys[0], ms[0])
    jprng.seed_all(51)
    jw = jbuild_fused(max_epochs=1, layers=(32,), minibatch_size=40,
                      n_train=240, n_valid=80, mesh=data_parallel_mesh(1))
    jw.initialize(device=TPUDevice())
    jpop = jax.tree.map(jnp.asarray, _hyper_pop(jw.step.hyper_params()))
    want = np.asarray(jax.device_get(jgenetics.make_population_evaluator(
        jw.step)(jpop, *(jnp.asarray(a) for a in (xs, ys, ms)),
                 *(jnp.asarray(a) for a in ev))))

    step = _port_step()
    before = [{k: v.clone() for k, v in leaf.items()}
              for leaf in step._params]
    buf, gen_state = step._hyper_buf.clone(), step._gen.get_state()
    untrained = int(step._eval_step(*(torch.from_numpy(a) for a in ev))[
        "n_err"])
    evaluate = tgenetics.make_population_evaluator(step)
    got = evaluate(_hyper_pop(step.hyper_params()), xs, ys, ms, *ev)
    assert got.shape == (P,)
    np.testing.assert_array_equal(got, want)
    assert got[0] == untrained            # lr 0 learns nothing
    assert got.min() < got[0], got
    # the step is as it was: params, hyperparameter buffer, generator
    for leaf, old in zip(step._params, before):
        for k, v in leaf.items():
            assert torch.equal(v, old[k]), k
    assert torch.equal(step._hyper_buf, buf)
    assert torch.equal(step._gen.get_state(), gen_state)
    seed = step._gen.initial_seed()
    for i in range(P):
        seq = _sequential(step, i, LRS[i], xs, ys, ms, ev, seed)
        assert int(seq) == got[i], (i, int(seq), got)
    # a second call scores the same population the same
    np.testing.assert_array_equal(
        evaluate(_hyper_pop(step.hyper_params()), xs, ys, ms, *ev), got)


def test_population_evaluator_mse_bit_identical_to_sequential_replay():
    """Under MSE the fitness is a float sum: each individual's
    ``mse_sum`` equals its sequential replay bit for bit."""
    from znicz_tpu_torch.models import approximator

    tprng.seed_all(5)
    w = approximator.build(max_epochs=1)
    w.initialize(device=TorchDevice("cpu"))
    step = w.step
    rng = np.random.default_rng(3)
    n_in = int(np.prod(w.loader.original_data.shape[1:]))
    n_out = int(np.prod(w.loader.original_targets.shape[1:]))
    mb = int(w.loader.max_minibatch_size)
    xs = rng.normal(size=(3, mb, n_in)).astype(np.float32).reshape(
        (3, mb) + tuple(w.loader.original_data.shape[1:]))
    ys = rng.normal(size=(3, mb, n_out)).astype(np.float32).reshape(
        (3, mb) + tuple(w.loader.original_targets.shape[1:]))
    ms = np.ones((3, mb), bool)
    ev = (xs[0], ys[0], ms[0])
    lrs = np.float32([0.0, 0.01, 0.05])
    pop = [{k: np.full(3, v, np.float32) for k, v in layer.items()}
           for layer in step.hyper_params()]
    for layer in pop:
        layer["lr"], layer["lr_b"] = lrs.copy(), lrs.copy()
    got = tgenetics.make_population_evaluator(step, metric="mse_sum")(
        pop, xs, ys, ms, *ev)
    seed = step._gen.initial_seed()
    for i, lr in enumerate(lrs):
        saved = [{k: v.clone() for k, v in leaf.items()}
                 for leaf in step._params]
        for gd in step.gds:
            gd.learning_rate = gd.learning_rate_bias = float(lr)
        step._gen.manual_seed(tgenetics.individual_seed(seed, i))
        step.train_steps(*(torch.from_numpy(a) for a in (xs, ys, ms)))
        seq = step._eval_step(*(torch.from_numpy(a) for a in ev))[
            "mse_sum"]
        step.place_params(saved)
        assert np.float32(seq) == np.float32(got[i]), (i, float(seq), got)
    assert got[1] != got[0]


def test_genetics_fixed_fitness_same_history_and_best():
    def fitness(ind):
        return (ind["a"] - 0.3) ** 2 + abs(ind["n"] - 5)

    runs = []
    for mod, tune, prng in ((jgenetics, JTune, jprng),
                            (tgenetics, TTune, tprng)):
        prng.seed_all(6)
        ga = mod.Genetics(fitness, tunes={"a": tune(0.5, 0.0, 1.0),
                                          "n": tune(3, 1, 8)},
                          population_size=8, mutation_rate=0.5, seed=77)
        runs.append((ga.run(4), ga.history))
    assert runs[0] == runs[1]
    (best, fit), history = runs[1]
    assert len(history) == 4 and fit == fitness(best)


#: the reference test's Wine workflows (tests/test_cli_services.py
#: test_cli_optimize, test_cli_optimize_structural_tune_falls_back), one
#: file for each package
OPT_WORKFLOW = textwrap.dedent("""
    from {pkg}.core.config import root
    from {pkg}.models import wine

    def run(load, main):
        load(wine.build, max_epochs=2, n_train=60, n_valid=30,
             minibatch_size=10, lr=float(root.port_opt.lr),
             hidden=int(root.port_opt.hidden))
        main()
    """)


def _best(cli, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli(argv) == 0
    line = next(ln for ln in buf.getvalue().splitlines()
                if ln.startswith("best config: "))
    return ast.literal_eval(line[len("best config: "):])


@pytest.mark.parametrize("tuned,mode,gens", [("lr", "vmapped", 2),
                                             ("hidden", "sequential", 1)])
def test_cli_optimize_routes_and_agrees_with_reference(tmp_path, tuned, mode,
                                                       gens):
    bests = []
    for pkg, cli, root, set_by_path, tune, dev in (
            ("znicz_tpu", jcli, jroot, jset, JTune, "tpu"),
            ("znicz_tpu_torch", tcli, troot, tset, TTune, "cpu")):
        wf = tmp_path / f"{pkg}_opt.py"
        wf.write_text(OPT_WORKFLOW.format(pkg=pkg))
        set_by_path(root, "port_opt.lr", 0.3)
        set_by_path(root, "port_opt.hidden", 10)
        set_by_path(root, "port_opt." + tuned,
                    tune(0.3, 0.01, 1.0) if tuned == "lr" else
                    tune(10, 4, 16))
        try:
            bests.append(_best(cli, [str(wf), "--optimize", str(gens),
                                     "-d", dev]))
        finally:
            del root.port_opt
    assert bests[1]["_evaluator"] == mode
    assert bests[0] == bests[1]


def test_cli_optimize_refuses_publish_and_manhole(tmp_path):
    wf = tmp_path / "opt.py"
    wf.write_text(OPT_WORKFLOW.format(pkg="znicz_tpu_torch"))
    for extra in (["--publish", "markdown"], ["--manhole"]):
        assert tcli([str(wf), "--optimize", "1", "-d", "cpu"] + extra) == 2
