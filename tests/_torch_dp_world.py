"""Gloo worlds for the port's multi-process tests
(``test_torch_port_data_parallel.py``, ``test_torch_port_qcomm.py``,
``test_torch_port_anatomy.py``,
``test_torch_port_multihost.py``, ``test_torch_port_lm_axes.py``,
``test_torch_port_ring_attention.py``, ``test_torch_port_pipe_expert.py``,
``test_torch_port_checkpoint.py``).

:func:`run_world` starts ``n`` processes of this file, each a rank of
one gloo world on the CPU; each runs every case of a job in order and
writes its results, which come back as a list a rank.  A case is a dict
naming one of the ``CASES`` functions and its arguments; its result is a
dict of numpy arrays, lists and numbers.  The workers import torch and
the port only, never jax: the tests hold what comes back against the
JAX package in their own process.
"""

from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(n: int, cases: list, inits=None, timeout: float = 240.0):
    """Run ``cases`` on every rank of a gloo world of ``n`` processes ->
    ``[rank 0's results, rank 1's, ...]``, each a list a case.
    ``inits`` (any picklable) reaches every case as ``job["inits"]``."""
    port = free_port()
    with tempfile.TemporaryDirectory() as tmp:
        job = os.path.join(tmp, "job.pkl")
        with open(job, "wb") as f:
            pickle.dump({"cases": cases, "inits": inits}, f)
        env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
        env["OMP_NUM_THREADS"] = "1"
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(r), str(n),
             str(port), job, tmp], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(n)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        bad = [(r, p.returncode, log[-4000:])
               for r, (p, log) in enumerate(zip(procs, logs))
               if p.returncode != 0]
        if bad:
            raise RuntimeError(f"gloo world of {n} failed: {bad}")
        out = []
        for r in range(n):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


# -- the cases (run in the workers) -------------------------------------------

def _mnist_build(case, max_epochs):
    from znicz_tpu_torch.core import prng as tprng
    from znicz_tpu_torch.models import mnist_fc

    layouts = {"replicated": {}, "shard_update": {"shard_update": True},
               "shard_params": {"shard_params": True}}
    tprng.seed_all(case["seed"])
    return mnist_fc.build_fused(
        max_epochs=max_epochs, layers=tuple(case["layers"]),
        minibatch_size=case["minibatch"], n_train=case["n_train"],
        n_valid=case["n_valid"], optimizer=case.get("optimizer", "sgd"),
        **layouts[case.get("layout", "replicated")],
        **case.get("options", {}))


def _initialize(w, case, inits):
    from znicz_tpu_torch.core import prng as tprng
    from znicz_tpu_torch.core.backends import TorchDevice
    from znicz_tpu_torch.core.config import root
    from znicz_tpu_torch.units.nn_units import load_forward_params

    init = inits.get(case.get("init")) if inits else None
    if init is not None:
        load_forward_params(w.forwards, init["params"])
    if case.get("scan_epoch"):
        w.step.scan_epoch = True
    root.common.engine.zero_gather_via_psum = bool(case.get("via_psum"))
    # host_fed: the data set stays on the host, so every minibatch's
    # rows are uploaded (by the stager under pipeline_depth)
    root.common.engine.dataset_on_device_max_bytes = \
        0 if case.get("host_fed") else 1 << 30
    w.initialize(device=TorchDevice("cpu"))
    if init is not None:
        tprng.get().load_state_dict(init["state"])


def _gauge(name, unit="FusedStep"):
    from znicz_tpu_torch.observe import registry

    return registry.REGISTRY.get(name).labels(unit=unit).get()


def case_mnist(case, inits):
    """MNIST FC fused on the world: optionally restored from a snapshot
    (``restore``), optionally snapshotted after ``snapshot_epochs``
    (``snapshot``), run to ``epochs``; returns the histories, weights,
    momenta, EMA mirrors, the ZeRO gauges and the step's residuals."""
    import torch

    from znicz_tpu_torch.snapshotter import (collect_state, restore_state,
                                             write_snapshot)

    out = {}
    if case.get("snapshot"):
        w = _mnist_build(case, case["snapshot_epochs"])
        _initialize(w, case, inits)
        w.run()
        arrays, meta = collect_state(w)
        if torch.distributed.get_rank() == 0:
            write_snapshot(case["snapshot"], arrays, meta)
        torch.distributed.barrier()
        out["snapshot_rw"] = arrays.get("step.opt.0.rw")
    w = _mnist_build(case, case["epochs"])
    _initialize(w, case, inits)
    rows = set()
    dispatch = w.step._dispatch

    def spy(kind, body, *inputs):
        rows.update(int(t.shape[0]) for t in inputs)
        return dispatch(kind, body, *inputs)
    w.step._dispatch = spy
    out["param_bytes"] = _gauge("znicz_zero_param_bytes")
    out["opt_bytes"] = _gauge("znicz_zero_opt_state_bytes")
    out["gather_nbytes"] = w.step._zero_gather_nbytes
    before = _gauge("znicz_zero_gathered_bytes_total")
    if case.get("restore"):
        restore_state(w, case["restore"])
        out["restored_extra"] = w.step.extra_state_arrays()
        w.decision.max_epochs = case["epochs"]
        w.decision.complete.set(False)
    w.run()
    out["gathered_delta"] = _gauge("znicz_zero_gathered_bytes_total") - \
        before
    out["dispatched_rows"] = sorted(rows)
    w.step.sync_to_units()
    out["hist"] = [(h.get("metric_train"), h.get("metric_validation"))
                   for h in w.decision.metrics_history]
    out["w"] = [np.asarray(a.map_read()).copy() for f in w.forwards
                for a in (f.weights, f.bias)]
    out["v"] = [np.asarray(a.map_read()).copy() for g in w.gds
                for a in (g.gradient_weights, g.gradient_bias)]
    if w.step.ema_decay is not None:
        out["ema"] = w.step.ema_params()
    out["extra"] = w.step.extra_state_arrays()
    out["vw_dtype"] = str(w.step._params[0]["vw"].dtype)
    out["leaf_shapes"] = [{k: tuple(v.shape) for k, v in leaf.items()}
                          for leaf in w.step._params]
    return out


def case_generator(case, inits):
    """The step's generator after initialize: each rank's first draws."""
    import torch

    w = _mnist_build(case, 1)
    _initialize(w, case, inits)
    return {"draws": torch.rand(8, generator=w.step._gen).numpy()}


def case_qcomm(case, inits):
    """The codec's collectives on this rank's slice of ``inputs``:
    ``psum_tree`` (with and without residuals) and ``gather_slices``."""
    import torch

    from znicz_tpu_torch.parallel import mesh as tmesh
    from znicz_tpu_torch.parallel import qcomm

    m = tmesh.data_parallel_mesh()
    r = m.rank
    codec = qcomm.resolve(case["config"])
    tree = [{k: torch.from_numpy(v[r]) for k, v in leaf.items()}
            for leaf in inits["trees"]]
    res = [{k: torch.from_numpy(v[r]) for k, v in leaf.items()}
           for leaf in inits["residuals"]]
    summed, _ = qcomm.psum_tree(tree, m, codec)
    summed_ef, new_res = qcomm.psum_tree(tree, m, codec, res)
    exact, _ = qcomm.quantized_psum(tree, m, None)
    out = {"summed": [{k: v.numpy() for k, v in leaf.items()}
                      for leaf in summed],
           "summed_ef": [{k: v.numpy() for k, v in leaf.items()}
                         for leaf in summed_ef],
           "new_res": [{k: v.numpy() for k, v in leaf.items()}
                       for leaf in new_res],
           "exact": [{k: v.numpy() for k, v in leaf.items()}
                     for leaf in exact],
           "gathered": []}
    for full in inits["gather"]:
        flat = np.pad(full.reshape(-1), (0, (-full.size) % m.size))
        s = flat.size // m.size
        shard = torch.from_numpy(flat[r * s:(r + 1) * s].copy())
        out["gathered"].append(
            qcomm.gather_slices(shard, m, full.shape, codec).numpy())
    return out


def case_backend(case, inits):
    """A step on CUDA tensors over this gloo group must refuse."""
    import torch

    from znicz_tpu_torch.parallel import mesh as tmesh

    try:
        tmesh.check_backend(tmesh.data_parallel_mesh(),
                            torch.device("cuda"))
    except RuntimeError as exc:
        return {"refused": str(exc)}
    return {"refused": None}


_MESHES = {}


def _lm_mesh(axes):
    """One mesh a layout for the whole job: its groups are made once
    (``new_group`` is collective and every rank makes every group)."""
    from znicz_tpu_torch.parallel import mesh as tmesh

    key = tuple(axes.items())
    if key not in _MESHES:
        _MESHES[key] = tmesh.make_mesh(dict(axes))
    return _MESHES[key]


def case_lm(case, inits):
    """The transformer step on a (data, seq, model) mesh in f32 on the
    CPU: ``steps`` steps from the global params ``inits[case["init"]]``
    (``tokens``, ``labels`` and, masked, ``mask`` there too), then the
    eval loss and the logits at the trained params when asked.  Rank 0
    returns the gathered global params; every rank its losses, its
    mesh coordinates and the collectives it made."""
    import torch

    from znicz_tpu_torch.parallel import mesh as tmesh
    from znicz_tpu_torch.parallel import transformer as tfm

    init = inits[case["init"]]
    arch = init["arch"]
    mesh = _lm_mesh(case["mesh"])
    opts = dict(case.get("options", {}))
    masked = "mask" in init and case.get("masked", False)
    step = tfm.make_train_step(mesh, *arch, lr=case.get("lr", 0.2),
                               compute_dtype=torch.float32, masked=masked,
                               device="cpu", **opts)
    n_experts = opts.get("n_experts")
    host = init["params"]
    if opts.get("shard_params"):
        host = tfm.shard_params_host(host, tfm.param_specs(
            arch[0], opts.get("head_sharded", False),
            moe=bool(n_experts)), mesh.shape["data"])
    ps = tfm.params_from_numpy(host, "cpu", mesh=mesh, specs=step.specs)
    batch = (init["tokens"], init["labels"]) + \
        ((init["mask"],) if masked else ())
    before = tmesh.collective_launches
    losses = [float(step(ps, *batch)[1]) for _ in range(case["steps"])]
    out = {"losses": losses, "coords": mesh.coords,
           "collectives": tmesh.collective_launches - before}
    got = tfm.params_to_numpy(ps, mesh, step.specs)
    if opts.get("shard_params"):
        specs = tfm.param_specs(arch[0], opts.get("head_sharded", False),
                                moe=bool(n_experts))
        got = tfm.unshard_params_host(got, specs, tfm.param_shapes(
            arch[0], arch[1], arch[3], arch[4], n_experts=n_experts))
    if mesh.rank == 0:
        out["params"] = got
    if case.get("eval"):
        # at the gathered params placed anew: one replica of each leaf,
        # as the reference's eval reads the params it is handed
        ps = tfm.params_from_numpy(got, "cpu", mesh=mesh,
                                   specs=tfm.param_specs(
                                       arch[0], opts.get("head_sharded",
                                                         False),
                                       moe=bool(n_experts)))
        moe = {k: opts[k] for k in ("n_experts", "moe_top_k") if k in opts}
        ev = tfm.make_eval_loss(mesh, *arch, compute_dtype=torch.float32,
                                masked=masked, device="cpu",
                                loss_chunks=opts.get("loss_chunks"),
                                head_sharded=opts.get("head_sharded",
                                                      False), **moe)
        out["eval"] = float(ev(ps, *batch))
        if not opts.get("head_sharded"):
            lg = tfm.make_logits_fn(mesh, *arch,
                                    compute_dtype=torch.float32,
                                    device="cpu", **moe)
            logits = lg(ps, init["tokens"]).numpy()
            if mesh.rank == 0:
                out["logits"] = logits
    return out


def case_ring(case, inits):
    """Both ring forms over a ``seq`` mesh of the world on this rank's
    block of the global (b, t, h, dh) q, k, v: the output and the q, k,
    v gradients of ``(o * w).sum()`` for each form and masking, the
    flash forwards and backwards each ran (the plain versions, counted
    by call), the collectives they made; and ``ring_mha_forward``."""
    import torch

    from znicz_tpu_torch.kernels import flash_attention as kflash
    from znicz_tpu_torch.parallel import mesh as tmesh
    from znicz_tpu_torch.parallel import ring_attention as ring

    seq = _lm_mesh({"seq": torch.distributed.get_world_size()}).axis("seq")
    calls = {"fwd": 0, "bwd": 0}
    for kind in ("fwd", "bwd"):
        name = f"flash_attention_{kind}"
        plain = getattr(kflash, name)

        def counted(*args, _plain=plain, _kind=kind):
            calls[_kind] += 1
            return _plain(*args)
        setattr(kflash, name, counted)

    def block(a):
        t_l = a.shape[1] // seq.size
        return torch.tensor(a[:, seq.index * t_l:(seq.index + 1) * t_l])

    out = {}
    for form in ("ring_attention", "ring_flash_attention"):
        for causal in (False, True):
            q, k, v = (block(inits[x]).requires_grad_(True)
                       for x in ("q", "k", "v"))
            calls.update(fwd=0, bwd=0)
            before = tmesh.collective_launches
            o = getattr(ring, form)(q, k, v, seq, causal=causal)
            grads = torch.autograd.grad((o * block(inits["w"])).sum(),
                                        (q, k, v))
            out[(form, causal)] = {
                "o": o.detach().numpy(),
                **{g: t.numpy() for g, t in zip(("dq", "dk", "dv"), grads)},
                "calls": dict(calls),
                "collectives": tmesh.collective_launches - before}
    params = {k: torch.tensor(v) for k, v in inits["mha_params"].items()}
    out["mha"] = ring.ring_mha_forward(block(inits["x"]), params,
                                       inits["heads"], seq,
                                       causal=True).detach().numpy()
    out["index"] = seq.index
    return out


def case_lm_backend(case, inits):
    """The transformer step on CUDA tensors over this gloo world's mesh
    must refuse when it is built."""
    from znicz_tpu_torch.parallel import transformer as tfm

    try:
        tfm.make_train_step(_lm_mesh(case["mesh"]), *case["arch"],
                            device="cuda")
    except RuntimeError as exc:
        return {"refused": str(exc)}
    return {"refused": None}


def _np_tree(tree):
    return {k: v.detach().numpy().copy() for k, v in tree.items()}


def case_pipe_step(case, inits):
    """The pipeline step on a (data, pipe, expert) mesh on the CPU:
    ``steps`` steps from ``inits["pipe"]`` in f32 (``bf16``: bfloat16
    compute) -> every rank's losses, its blocks after the first step and
    after the last, and its coordinates."""
    import torch

    from znicz_tpu_torch.parallel import transformer as tfm

    init = inits["pipe"]
    mesh = _lm_mesh(case["mesh"])
    step = tfm.make_pipeline_step(
        mesh, init["n_experts"], lr=init["lr"], device="cpu",
        compute_dtype=torch.bfloat16 if case.get("bf16") else torch.float32)
    ps = tfm.params_from_numpy(init["params"], "cpu", mesh=mesh,
                               specs=step.specs)
    losses, first = [], None
    for i in range(case["steps"]):
        losses.append(float(step(ps, init["xs"], init["ys"])[1]))
        if i == 0:
            first = _np_tree(ps)
    out = {"losses": losses, "first": first, "blocks": _np_tree(ps),
           "coords": mesh.coords}
    out["global"] = tfm.params_to_numpy(ps, mesh, step.specs)
    return out


def case_axes(case, inits):
    """``pipeline_apply`` over ``pipe`` and ``moe_ffn`` over ``expert``,
    each over a mesh of the whole world, on this rank's blocks."""
    import torch

    from znicz_tpu_torch.parallel import moe as tmoe
    from znicz_tpu_torch.parallel.pipeline import pipeline_apply

    n = torch.distributed.get_world_size()
    pipe = _lm_mesh({"pipe": n}).axis("pipe")
    p = inits["pipeline"]
    r = pipe.index
    out = {"pipeline": pipeline_apply(
        lambda wb, x: torch.tanh(x @ wb[0][0] + wb[1][0]),
        (torch.tensor(p["ws"][r:r + 1]), torch.tensor(p["bs"][r:r + 1])),
        torch.tensor(p["xs"]), pipe).numpy()}
    expert = _lm_mesh({"expert": n}).axis("expert")
    m = inits["moe"]
    e_l = m["w1"].shape[0] // n
    blk = {k: torch.tensor(m[k][expert.index * e_l:(expert.index + 1) * e_l])
           for k in ("w1", "b1", "w2", "b2")}
    out["moe"] = tmoe.moe_ffn(
        torch.tensor(m["x"]), torch.tensor(m["gate"]), blk["w1"], blk["b1"],
        blk["w2"], blk["b2"], torch.relu, expert)[0].numpy()
    return out


def case_dispatch(case, inits):
    """``moe_ffn_dispatch`` over an ``expert`` mesh of the whole world on
    this rank's tokens and experts of ``inits[case["init"]]``: the
    output and, with ``loss``, the gradients of ``(y * w).sum()`` (or
    ``(y ** 2).sum()``) for x, gate and the expert weights."""
    import functools

    import torch
    import torch.nn.functional as F

    from znicz_tpu_torch.parallel import moe as tmoe

    init = inits[case["init"]]
    n = torch.distributed.get_world_size()
    axis = _lm_mesh({"expert": n}).axis("expert")
    r = axis.index
    t_l = init["x"].shape[0] // n
    e_l = init["w1"].shape[0] // n
    args = [torch.tensor(init["x"][r * t_l:(r + 1) * t_l]),
            torch.tensor(init["gate"])] + [
        torch.tensor(init[k][r * e_l:(r + 1) * e_l])
        for k in ("w1", "b1", "w2", "b2")]
    for a in args:
        a.requires_grad_(True)
    y, _ = tmoe.moe_ffn_dispatch(
        *args[:2], *args[2:], functools.partial(F.gelu, approximate="tanh"),
        axis, capacity_factor=case["capacity_factor"],
        top_k=case.get("top_k", 1))
    if case.get("loss") == "square":
        loss = (y * y).sum()
    else:
        loss = (y * torch.tensor(init["wsum"][r * t_l:(r + 1) * t_l])).sum()
    grads = torch.autograd.grad(loss, args)
    return {"y": y.detach().numpy(),
            "grads": [g.numpy() for g in grads]}


def case_hybrid(case, inits):
    """A hybrid mesh over this world split into nodes of
    ``LOCAL_WORLD_SIZE`` ranks: the rank array, this rank's coordinates,
    the world line's gather of the ranks (line order), an all-to-all
    over one axis, and a placed-and-gathered leaf."""
    import torch

    from znicz_tpu_torch.parallel import mesh as tmesh
    from znicz_tpu_torch.parallel import transformer as tfm

    os.environ["LOCAL_WORLD_SIZE"] = str(case["local"])
    try:
        mesh = tmesh.make_hybrid_mesh(case["axes"], case["dcn"])
    finally:
        del os.environ["LOCAL_WORLD_SIZE"]
    every = mesh.axis(tuple(mesh.shape))
    line = mesh.axis(case["exchange"])
    sent = torch.tensor([[100 * mesh.rank + j] for j in range(line.size)],
                        dtype=torch.float32)
    leaf = {"w": inits["hybrid"]}
    spec = {"w": tuple(mesh.shape)}
    ps = tfm.params_from_numpy(leaf, "cpu", mesh=mesh, specs=spec)
    return {"devices": mesh.devices, "coords": mesh.coords,
            "gathered": every.all_gather(
                torch.tensor([float(mesh.rank)])).numpy().ravel(),
            "exchanged": line.all_to_all(sent).numpy().ravel(),
            "line_ranks": line.ranks, "block": ps["w"].numpy(),
            "back": tfm.params_to_numpy(ps, mesh, spec)["w"]}


def case_ckpt(case, inits):
    """A checkpoint of the LM step's params on ``case["mesh_a"]`` after
    ``steps`` steps, restored onto ``mesh_b`` (and onto ``mesh_a``):
    rank 0's gathered saved and restored params, every rank's check of
    its restored blocks against the saved global, and the loss of one
    more step on each mesh from the restored params (and from the live
    ones on ``mesh_a``)."""
    import torch

    from znicz_tpu_torch.parallel import checkpoint as tckpt
    from znicz_tpu_torch.parallel import transformer as tfm

    init = inits["ckpt"]
    arch, batch = init["arch"], (init["tokens"], init["labels"])
    hs = case.get("head_sharded", False)
    mesh_a = _lm_mesh(case["mesh_a"])
    step_a = tfm.make_train_step(mesh_a, *arch, lr=init["lr"],
                                 compute_dtype=torch.float32, device="cpu",
                                 head_sharded=hs)
    ps = tfm.params_from_numpy(init["params"], "cpu", mesh=mesh_a,
                               specs=step_a.specs)
    for _ in range(init["steps"]):
        step_a(ps, *batch)
    saved = tfm.params_to_numpy(ps, mesh_a, step_a.specs)
    tckpt.save_pytree(case["path"], ps, mesh=mesh_a, specs=step_a.specs)
    out = {"live_a": float(step_a(ps, *batch)[1])}
    specs_b = tfm.param_specs(arch[0])
    for name, mesh, specs in (("a", mesh_a, step_a.specs),
                              ("b", _lm_mesh(case["mesh_b"]), specs_b)):
        like = tfm.params_from_numpy(init["params"], "cpu", mesh=mesh,
                                     specs=specs)
        got = tckpt.load_pytree(case["path"], like=like, mesh=mesh,
                                specs=specs)
        want = tfm.params_from_numpy(saved, "cpu", mesh=mesh, specs=specs)
        out[f"blocks_equal_{name}"] = all(
            torch.equal(g, w) for g, w in zip(tfm._leaves(got),
                                              tfm._leaves(want)))
        step = step_a if name == "a" else tfm.make_train_step(
            mesh, *arch, lr=init["lr"], compute_dtype=torch.float32,
            device="cpu")
        out[f"restored_{name}"] = float(step(got, *batch)[1])
    if mesh_a.rank == 0:
        out["saved"] = saved
    return out


def case_ckpt_retry(case, inits):
    """``save_pytree`` of a small replicated pytree under a retry policy
    with one planted OSError on one rank: rank 0's ``os.replace``
    (``case["fail"] == "replace"``) or rank 1's DCP write (``"write"``).
    Every rank's retries, whether the planted failure fired, and whether
    the restored leaves are the saved ones."""
    import torch
    import torch.distributed as dist
    from torch.distributed.checkpoint import FileSystemWriter

    from znicz_tpu_torch.parallel import checkpoint as tckpt
    from znicz_tpu_torch.resilience.retry import RetryPolicy

    who, owner, name = {"replace": (0, tckpt.os, "replace"),
                        "write": (1, FileSystemWriter, "write_data")}[
                            case["fail"]]
    real, left = getattr(owner, name), [1]

    def once(*args, **kwargs):
        if left[0]:
            left[0] -= 1
            raise OSError(f"planted {case['fail']} failure")
        return real(*args, **kwargs)
    params = {"w": torch.arange(12.0).reshape(3, 4), "b": [torch.ones(3)]}
    policy = RetryPolicy(max_attempts=3, base_delay=0.0, jitter=0.0)
    if dist.get_rank() == who:
        setattr(owner, name, once)
    try:
        tckpt.save_pytree(case["path"], params, retry=policy)
    finally:
        setattr(owner, name, real)
    got = tckpt.load_pytree(case["path"], like=params)
    return {"retries": policy.total_retries, "fired": left[0] == 0,
            "equal": all(torch.equal(got[k][0] if k == "b" else got[k],
                                     params[k][0] if k == "b" else params[k])
                         for k in params)}


def case_mnist_anatomy(case, inits):
    """``case_mnist`` of a step in anatomy mode, plus the phases its
    accountant charged (``znicz_anatomy_phase_seconds`` counts and sums
    of ``plane="fused"``) and the step walls' sum."""
    from znicz_tpu_torch.observe import registry

    def flat():
        return registry.REGISTRY.snapshot_flat(skip_zero=False)

    before = flat()
    out = case_mnist(dict(case, options={**case.get("options", {}),
                                         "anatomy": True}), inits)
    after = flat()
    out["anatomy"] = {k: after[k] - before.get(k, 0.0) for k in after
                      if k.startswith("znicz_anatomy_") and
                      'plane="fused"' in k}
    return out


CASES = {"mnist": case_mnist, "mnist_anatomy": case_mnist_anatomy,
         "generator": case_generator,
         "qcomm": case_qcomm, "backend": case_backend, "lm": case_lm,
         "lm_backend": case_lm_backend, "ring": case_ring,
         "pipe_step": case_pipe_step, "axes": case_axes,
         "dispatch": case_dispatch, "hybrid": case_hybrid,
         "ckpt": case_ckpt, "ckpt_retry": case_ckpt_retry}


def _worker(rank: int, n: int, port: int, job: str, out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    with open(job, "rb") as f:
        spec = pickle.load(f)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=n, rank=rank)
    try:
        results = [CASES[c["fn"]](c, spec["inits"]) for c in spec["cases"]]
        # no rank tears its groups down while a peer's traffic is in flight
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
            sys.argv[4], sys.argv[5])
