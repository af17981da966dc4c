"""Genetic hyperparameter optimization — the port of
``znicz_tpu/utils/genetics.py`` (rebuild of veles/genetics/:
``--optimize``; Tune leaves + GA over full training runs).

Config leaves wrapped in ``Tune(default, min, max)``
(``znicz_tpu_torch.core.config``) define the search space; each
individual is a {dotted_path: value} assignment over the global ``root``
tree.  Fitness protocols (consistent within a run, chosen by the routing
below): the SEQUENTIAL path scores the Decision's BEST validation metric
of a complete training run, early stopping and all; the POPULATION path
scores the FINAL-epoch validation metric after exactly ``max_epochs``
epochs of the staged train minibatches (no early stopping).  Selection
is top-half elitist, crossover uniform per-gene, mutation gaussian
within the Tune range — the reference's GA shape.

The reference turns the population into a batched axis by ``jax.vmap``
of the scanned train step.  Hand-written kernels bound through ctypes
have no batching rule, so the port's :func:`make_population_evaluator`
trains the individuals one after another through ONE fused step: it
saves the step's state (every leaf of its params: weights, biases,
velocities, optimizer moments), and for each individual copies that
state back into the live tensors, writes the individual's row into the
step's hyperparameter buffer (``FusedTrainStep.write_hyper``), re-keys
the step's generator from its seed and the individual's index (the
counterpart of the reference's ``fold_in(key, i)``), replays ``epochs x
n_steps`` train steps through ``train_steps`` and reads the eval metric.
On the card every step is a replay of the step's one CUDA graph, so the
whole population shares one capture, and each individual's fitness is
bit-identical to the same hyperparameters replayed alone.

The CLI ``--optimize`` path takes that evaluator when the workflow
qualifies (a fused StandardWorkflow whose Tune leaves move only
per-layer hyperparams, probed by rebuilding the workflow at each Tune
extreme and comparing the structural signature) and labels it
``'_evaluator': 'vmapped'``, the reference's label, which the port keeps
for the reference's users; anything else falls back to sequential
full-run evaluation.  ``Genetics``, ``NotVmappable``, ``_build_only``,
``_static_signature`` and ``optimize`` are the reference's code (held
to it by ``tests/test_torch_port_genetics.py``).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from znicz_tpu_torch.core import prng
from znicz_tpu_torch.core.backends import AutoDevice
from znicz_tpu_torch.core.config import (root, set_by_path, walk_tunes)
from znicz_tpu_torch.core.logger import Logger


def individual_seed(seed: int, index: int) -> int:
    """The generator seed of individual ``index`` in a population whose
    step's generator had ``seed``: the counterpart of the reference's
    ``fold_in(key, index)``."""
    return int(np.random.SeedSequence(int(seed), spawn_key=(int(index),))
               .generate_state(1, np.uint64)[0])


def make_population_evaluator(step, metric: str = "n_err",
                              epochs: int = 1):
    """Build a reusable fitness scorer over the fused ``step``.

    The returned callable
    ``evaluate(hyper_pop, train_xs, train_ys, train_ms, vx, vy, vm)``
    scores a whole population: ``hyper_pop`` is a list shaped like
    ``step.hyper_params()`` whose every value carries a leading
    population axis P (host arrays); the train inputs carry a leading
    step axis (global minibatches; each rank takes its rows).  Each
    individual trains from the step's current state, which is saved at
    the call and restored for every individual and at the end, with its
    own hyperparameters in the step's buffer and its own generator seed
    (:func:`individual_seed`), through ``epochs`` passes of
    ``train_steps`` over the staged minibatches; then one eval step
    scores the validation batch.  Returns the (P,) vector of ``metric``
    (``n_err``, or ``mse_sum`` under MSE) as numpy.  The step's params,
    hyperparameter buffer and generator are as before the call when it
    returns."""
    import torch

    def device_inputs(*arrays):
        return tuple(torch.as_tensor(a).to(step._dev) for a in arrays)

    def evaluate(hyper_pop, train_xs, train_ys, train_ms,
                 valid_x, valid_y, valid_m):
        xs, ys, ms = device_inputs(train_xs, train_ys, train_ms)
        ev = tuple(step._local_rows(t) for t in device_inputs(
            valid_x, valid_y, valid_m))
        n_pop = len(np.asarray(next(iter(hyper_pop[0].values()))))
        rows = [[{k: np.asarray(v)[i] for k, v in layer.items()}
                 for layer in hyper_pop] for i in range(n_pop)]
        saved = [{k: v.clone() for k, v in leaf.items()}
                 for leaf in step._params]
        gen = step._gen
        gen_state, seed = gen.get_state(), gen.initial_seed()
        fits = []
        try:
            for i, hyper in enumerate(rows):
                step.place_params(saved)
                step.write_hyper(hyper)
                gen.manual_seed(individual_seed(seed, i))
                for _ in range(epochs):
                    step.train_steps(xs, ys, ms)
                # a copy: the eval graph's next replay overwrites it
                fits.append(step._dispatch("eval", step._eval_step,
                                           *ev)[metric].clone())
        finally:
            step.place_params(saved)
            step.write_hyper(step.hyper_params())
            gen.set_state(gen_state)
        return torch.stack(fits).cpu().numpy()

    return evaluate


class Genetics(Logger):
    """GA driver over Tune leaves (reference: veles/genetics)."""

    def __init__(self, evaluate: Callable[[dict], float],
                 tunes: Optional[dict] = None,
                 population_size: int = 8, elite: float = 0.5,
                 mutation_rate: float = 0.3, seed: int = 0xA11E1E,
                 evaluate_many: Optional[Callable] = None) -> None:
        super().__init__()
        self.evaluate = evaluate
        #: optional batched scorer: list[individual] -> list[float] in one
        #: call (the vmapped TPU path — make_population_evaluator)
        self.evaluate_many = evaluate_many
        self.tunes = tunes if tunes is not None else dict(walk_tunes(root))
        if not self.tunes:
            raise ValueError("no Tune() leaves found in root — nothing to "
                             "optimize")
        self.population_size = population_size
        self.elite = elite
        self.mutation_rate = mutation_rate
        #: PRIVATE stream, not in the prng registry: evaluations reseed the
        #: session streams (so every individual trains on identical data),
        #: and that reseed must not restart the GA's own draws
        self._gen = prng.RandomGenerator("genetics-private", seed)
        self.history: list[dict] = []

    # -- genome ops ---------------------------------------------------------
    def _random_individual(self) -> dict:
        ind = {}
        for path, tune in self.tunes.items():
            lo, hi = float(tune.min), float(tune.max)
            ind[path] = lo + float(self._gen.uniform(0, 1, ())) * (hi - lo)
            if isinstance(tune.default, int):
                ind[path] = int(round(ind[path]))
        return ind

    def _crossover(self, a: dict, b: dict) -> dict:
        return {k: (a if float(self._gen.uniform(0, 1, ())) < 0.5
                    else b)[k] for k in a}

    def _mutate(self, ind: dict) -> dict:
        out = dict(ind)
        for path, tune in self.tunes.items():
            if float(self._gen.uniform(0, 1, ())) < self.mutation_rate:
                lo, hi = float(tune.min), float(tune.max)
                val = out[path] + \
                    float(self._gen.normal(0, 0.15, ())) * (hi - lo)
                val = min(max(val, lo), hi)
                out[path] = int(round(val)) if isinstance(tune.default, int) \
                    else val
        return out

    # -- the loop -----------------------------------------------------------
    def run(self, generations: int) -> tuple[dict, float]:
        pop = [{k: (float(t.default) if not isinstance(t.default, int)
                    else t.default) for k, t in self.tunes.items()}]
        pop += [self._random_individual()
                for _ in range(self.population_size - 1)]
        best, best_fit = None, float("inf")
        for g in range(generations):
            if self.evaluate_many is not None:
                fits = [float(f) for f in self.evaluate_many(pop)]
            else:
                fits = [float(self.evaluate(ind)) for ind in pop]
            scored = []
            for fit, ind in zip(fits, pop):
                scored.append((fit, ind))
                if fit < best_fit:
                    best, best_fit = dict(ind), fit
            scored.sort(key=lambda p: p[0])
            self.history.append({"generation": g,
                                 "best": scored[0][0],
                                 "worst": scored[-1][0]})
            self.info(f"generation {g}: best {scored[0][0]:.4f} "
                      f"worst {scored[-1][0]:.4f}")
            n_keep = max(2, int(self.population_size * self.elite))
            parents = [ind for _, ind in scored[:n_keep]]
            pop = list(parents)
            while len(pop) < self.population_size:
                i = int(self._gen.randint(0, len(parents)))
                j = int(self._gen.randint(0, len(parents)))
                pop.append(self._mutate(self._crossover(parents[i],
                                                        parents[j])))
        return best, best_fit


class NotVmappable(Exception):
    """The workflow/Tune combination cannot ride the batched evaluator."""


def _build_only(module, seed: int):
    """Build the module's workflow under the current ``root`` values —
    no device init, no training (``main`` is a no-op)."""
    prng.seed_all(seed)
    holder = {}

    def load(builder, **kwargs):
        holder["w"] = builder(**kwargs)
        return holder["w"], False

    def main(**_):
        pass

    module.run(load, main)
    return holder.get("w")


#: gd-unit attributes the fused step reads as traced hyperparams
#: (FusedTrainStep.hyper_params) — the ONLY things a Tune may move for
#: the vmapped path to be sound
_HYPER_ATTRS = frozenset({
    "learning_rate", "weights_decay", "l1_vs_l2", "gradient_moment",
    "learning_rate_bias", "weights_decay_bias", "gradient_moment_bias"})


def _static_signature(w) -> tuple:
    """Hashable summary of everything about a built workflow EXCEPT the
    fused hyperparams: unit classes and their static scalar attrs.  Two
    individuals with equal signatures compile to the same program and
    differ only in traced scalars."""
    def attrs(u, exclude=frozenset()):
        out = []
        for k in sorted(vars(u)):
            if k.startswith("_") or k in exclude:
                continue
            v = vars(u)[k]
            if isinstance(v, (bool, int, float, str)) or (
                    isinstance(v, tuple) and
                    all(isinstance(e, (bool, int, float, str))
                        for e in v)):
                out.append((k, v))
        return tuple(out)

    return (type(w).__name__, w.loss_function, w.optimizer,
            (type(w.loader).__name__, attrs(w.loader)),
            tuple((type(f).__name__, attrs(f)) for f in w.forwards),
            tuple((type(g).__name__, attrs(g, _HYPER_ATTRS))
                  for g in w.step.gds))


def _try_vmapped_evaluator(module, launcher, eval_seed: int, tunes: dict,
                           log: Logger):
    """Stand up the population ``evaluate_many`` for the CLI path, or
    raise :class:`NotVmappable` with the reason.

    Compatibility is established by construction, not by parsing Tune
    paths: the workflow is rebuilt at each Tune extreme and its
    structural signature must be unchanged — then per individual the
    rebuild's ``hyper_params()`` IS the mapping from config values to
    the step's hyperparameter rows, exactly as the builder computes it.
    The base individual's workflow is initialized on the launcher's
    device; its step trains every individual (one capture on the
    card)."""
    import torch

    from znicz_tpu_torch.loader.base import TRAIN, VALID
    from znicz_tpu_torch.parallel.step import full_batch_arrays
    from znicz_tpu_torch.standard_workflow import StandardWorkflow

    for path, t in tunes.items():
        set_by_path(root, path, t.default)
    base = _build_only(module, eval_seed)
    if not isinstance(base, StandardWorkflow) or not base.fused or \
            getattr(base, "step", None) is None:
        raise NotVmappable("workflow is not a fused StandardWorkflow")
    if base.step.accumulate_steps > 1:
        raise NotVmappable("accumulate_steps > 1: train_steps applies the "
                           "update every minibatch")
    base_sig = _static_signature(base)
    for path, t in tunes.items():
        # probe BOTH extremes: a structure change that triggers only
        # below/above some threshold must not slip past a one-sided probe
        for probe_val in {float(t.min), float(t.max)} - {float(t.default)}:
            if isinstance(t.default, int):
                probe_val = int(round(probe_val))
            set_by_path(root, path, probe_val)
            probe = _build_only(module, eval_seed)
            set_by_path(root, path, t.default)
            if not isinstance(probe, StandardWorkflow) or \
                    getattr(probe, "step", None) is None or \
                    _static_signature(probe) != base_sig:
                raise NotVmappable(f"Tune {path!r} changes workflow "
                                   f"structure, not just hyperparams")

    # the base individual's device-initialized step carries the shared
    # params every individual trains from
    prng.seed_all(eval_seed)
    base.initialize(device=launcher.device or AutoDevice())
    step = base.step
    loader = base.loader
    data_arr, labels_arr, why = full_batch_arrays(
        loader, mse=base.loss_function == "mse")
    if data_arr is None:
        raise NotVmappable(why)
    n_train = int(loader.class_lengths[TRAIN])
    n_valid = int(loader.class_lengths[VALID])
    mb = int(loader.minibatch_data.shape[0])
    n_steps = n_train // mb
    if n_valid == 0 or n_steps == 0:
        raise NotVmappable("need a VALID split and >= 1 train minibatch")

    data = np.asarray(data_arr.mem, np.float32)
    labels = np.asarray(labels_arr.mem)
    tr0, va0 = loader.class_offset(TRAIN), loader.class_offset(VALID)
    dev = step._dev
    xs = torch.from_numpy(data[tr0:tr0 + n_steps * mb].reshape(
        (n_steps, mb) + data.shape[1:])).to(dev)
    ys = torch.from_numpy(labels[tr0:tr0 + n_steps * mb].reshape(
        (n_steps, mb) + labels.shape[1:])).to(dev)
    ms = torch.ones((n_steps, mb), dtype=torch.bool, device=dev)
    # validation as one padded batch (pad rows masked out), its rows
    # divisible by the data mesh
    pad = (-n_valid) % max(step.mesh.size, 1)
    vx = np.zeros((n_valid + pad,) + data.shape[1:], np.float32)
    vx[:n_valid] = data[va0:va0 + n_valid]
    vy = np.zeros((n_valid + pad,) + labels.shape[1:], labels.dtype)
    vy[:n_valid] = labels[va0:va0 + n_valid]
    vm = np.arange(n_valid + pad) < n_valid

    # the fused step's metric keys: softmax publishes "n_err", MSE
    # publishes the batch SUM "mse_sum" — both lower-is-better fitnesses
    metric = "mse_sum" if base.loss_function == "mse" else "n_err"
    epochs = max(1, int(getattr(base.decision, "max_epochs", 1) or 1))
    evaluator = make_population_evaluator(step, metric=metric,
                                          epochs=epochs)
    log.info(f"--optimize: population evaluator engaged, one captured "
             f"step replayed per individual ({epochs} epochs x {n_steps} "
             f"steps x {mb}, {n_valid} valid samples, metric {metric})")

    def evaluate_many(pop):
        hypers = []
        for ind in pop:
            for path, value in ind.items():
                set_by_path(root, path, value)
            w_i = _build_only(module, eval_seed)
            if _static_signature(w_i) != base_sig:
                raise RuntimeError(
                    f"workflow structure drifted during optimization "
                    f"(individual {ind}) — Tune probe missed a "
                    f"structural dependency")
            hypers.append(w_i.step.hyper_params())
        hyper_pop = [{k: np.stack([np.float32(h[i][k]) for h in hypers])
                      for k in layer} for i, layer in enumerate(hypers[0])]
        fits = evaluator(hyper_pop, xs, ys, ms, vx, vy, vm)
        return [float(f) for f in fits]

    return evaluate_many


def optimize(module, launcher, generations: int,
             population_size: int = 8) -> dict:
    """CLI ``--optimize`` path: GA over the Tune leaves currently in
    ``root``.  Fused-compatible workflows score whole generations in one
    vmapped dispatch (the population as a batched axis); anything else
    falls back to sequential full training runs per individual."""

    # ONE fixed evaluation seed, captured before any evaluation runs:
    # every individual then trains on identical data/init, so fitness
    # values are comparable (the old per-call re-derivation drifted the
    # seed between evaluations AND restarted the GA's own stream)
    eval_seed = prng.get("genetics").initial_seed & 0xFFFF
    log = Logger()
    tunes = dict(walk_tunes(root))
    try:
        evaluate_many = _try_vmapped_evaluator(module, launcher, eval_seed,
                                               tunes, log)
        mode = "vmapped"    # the reference's label, kept
    except NotVmappable as exc:
        log.info(f"--optimize: sequential evaluation ({exc})")
        evaluate_many = None
        mode = "sequential"

    def evaluate(individual: dict) -> float:
        for path, value in individual.items():
            set_by_path(root, path, value)
        prng.seed_all(eval_seed)
        holder = {}

        def load(builder, **kwargs):
            holder["w"] = builder(**kwargs)
            return holder["w"], False

        def main(**_):
            holder["w"].initialize(device=launcher.device or AutoDevice())
            holder["w"].run()
            holder["w"].stop()

        module.run(load, main)
        metric = holder["w"].decision.best_metric
        return float("inf") if metric is None else float(metric)

    ga = Genetics(evaluate, population_size=population_size,
                  evaluate_many=evaluate_many, tunes=tunes)
    best, fit = ga.run(generations)
    best["_fitness"] = fit
    best["_evaluator"] = mode
    return best
