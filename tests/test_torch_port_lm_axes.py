"""The transformer step on a ``(data, seq, model)`` mesh
(``znicz_tpu_torch/parallel/{mesh,tp,moe,ring_attention,transformer}.py``)
on gloo worlds of 4 and 8 processes on the CPU, against the JAX
package's step on a mesh of the same axes over the virtual CPU devices,
f32, 3 steps of lr 0.2 at the flag fuzz's size (2 layers, d 32, 4
heads, ff 64, vocab 16; ``tests/test_transformer_flag_fuzz.py``):

- every rank's losses within rtol 1e-4 / atol 1e-5 of the JAX step's
  and the gathered params within 1e-5 (ROADMAP.md's band for the 1×1×1
  step), on ``(2, 2, 2)`` plain and masked, and on ``(1, 2, 2)``,
  ``(2, 1, 2)`` and ``(1, 4, 1)`` with ``head_sharded``,
  ``loss_chunks``, MoE at 2 and 4 experts, top-1 and top-2,
  ``shard_update``, ``shard_params`` and an int8 codec (under which
  a few rounding flips of the codec are allowed, each one codec level:
  ``INT8_FLIP_ATOL``; the logits are held on the exact meshes);
- ``make_eval_loss`` and ``make_logits_fn`` on ``(1, 2, 2)`` (and on
  ``(2, 2, 2)`` and ``(1, 4, 1)``) at the trained params, against the
  JAX package's on the same params: the eval loss within rtol 1e-4, the
  logits within the 1×1×1 step's logits band, 1e-4;
- what the reference holds invariant across meshes: the first step's
  loss (the forward at the same params) on ``(2, 2, 2)`` against
  ``(1, 1, 1)`` at rtol 2e-4 (``tests/test_transformer_spmd.py:38``),
  and with the MoE flags at model 2 against model 1 at 2e-4 / 2e-5
  (``tests/test_transformer_flag_fuzz.py:84``).  Later steps are not
  invariant in the reference (a ``psum``'s transpose is a ``psum``:
  each replica takes its own gradient), and the port's follow the
  reference's, as the parity above holds;
- the mesh: each rank's coordinates against the reference's device
  array, the pipeline's axes and DCN axes building like any other (a
  mesh spans its world), and a CUDA step over a gloo world refused
  when built.

Each world is one module-scoped spawn of gloo processes
(``tests/_torch_dp_world.py``) running all of its cases; the JAX runs
are made here.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_dp_world as world
from znicz_tpu.parallel import transformer as jtfm
from znicz_tpu.parallel.mesh import make_mesh as jmake_mesh

from znicz_tpu_torch.parallel import mesh as tmesh
from znicz_tpu_torch.parallel import transformer as tfm

#: layers, d, heads, ff, vocab
ARCH = (2, 32, 4, 64, 16)
LR, STEPS = 0.2, 3
#: port against the JAX step (ROADMAP.md's band for the 1x1x1 step)
LOSS_RTOL, LOSS_ATOL, PARAM_ATOL = 1e-4, 1e-5, 1e-5
#: the eval loss at the same params; the logits: the 1x1x1 step's
#: logits band (tests/test_torch_port_train.py LOGIT_BAND)
EVAL_RTOL, LOGIT_BAND = 1e-4, 1e-4
#: mesh invariance of the forward: tests/test_transformer_spmd.py:38
#: and tests/test_transformer_flag_fuzz.py:84
SPMD_RTOL, FUZZ_RTOL, FUZZ_ATOL = 2e-4, 2e-4, 2e-5
#: the int8 codec rounds each gradient to one of 255 levels of its
#: chunk's scale (absmax/127): a difference of ~1e-7 between the two
#: packages' gradients flips a rounding where a value sits on a level's
#: edge (about one element in 10^4 a step), and a flip moves that
#: element's update by one level, lr·scale/n.  So under a codec a leaf
#: may hold up to max(2, 1 %) elements beyond PARAM_ATOL, each within
#: one level of a chunk whose absmax is below 4 (INT8_FLIP_ATOL); the
#: losses and the eval loss keep their bands, and the logits, which a
#: flipped head element moves, are held on the exact meshes only
INT8_FLIP_ATOL = LR * 4 / 127

MOE2 = {"n_experts": 2, "moe_top_k": 2, "moe_aux_weight": 0.01,
        "moe_zloss_weight": 1e-3}
MOE4 = {"n_experts": 4, "moe_top_k": 1, "moe_aux_weight": 0.01}
INT8 = {"quantized_collectives": {"mode": "int8"}}


def _axes(d, s, m):
    return {"data": d, "seq": s, "model": m}


#: name -> (world, axes, init, masked, options, eval and logits)
CASES = {
    "plain_222": (8, _axes(2, 2, 2), "dense", False, {}, True),
    "masked_222": (8, _axes(2, 2, 2), "dense", True, {}, False),
    "moe_flags_222": (8, _axes(2, 2, 2), "moe4", True,
                      dict(MOE4, loss_chunks=4, head_sharded=True), False),
    "moe_flags_221": (4, _axes(2, 2, 1), "moe4", True,
                      dict(MOE4, loss_chunks=4, head_sharded=True), False),
    "head_chunks_update_122": (
        4, _axes(1, 2, 2), "dense", False,
        {"head_sharded": True, "loss_chunks": 3, "shard_update": True},
        True),
    "moe2_top2_122": (4, _axes(1, 2, 2), "moe2", False, MOE2, True),
    "moe4_params_212": (4, _axes(2, 1, 2), "moe4", True,
                        dict(MOE4, shard_params=True, head_sharded=True),
                        False),
    "int8_params_212": (4, _axes(2, 1, 2), "dense", False,
                        dict(INT8, shard_params=True), False),
    "chunks_update_141": (4, _axes(1, 4, 1), "dense", True,
                          {"loss_chunks": 2, "shard_update": True}, False),
    "int8_141": (4, _axes(1, 4, 1), "dense", True, INT8, True),
}


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(99)
    tokens = rng.integers(0, ARCH[4], (4, 16)).astype(np.int32)
    return tokens, ((tokens + 1) % ARCH[4]).astype(np.int32), \
        np.array([True, True, True, False])


@pytest.fixture(scope="module")
def inits(batch):
    tokens, labels, mask = batch
    out = {}
    for name, n_experts in (("dense", None), ("moe2", 2), ("moe4", 4)):
        params = tfm.init_params(np.random.default_rng(41), *ARCH,
                                 n_experts=n_experts)
        out[name] = dict(arch=ARCH, params=params, tokens=tokens,
                         labels=labels, mask=mask)
    return out


@pytest.fixture(scope="module")
def worlds(inits):
    """``{world size: {case name: [rank 0's result, ...]}}``, one spawn
    a world size."""
    out = {}
    for n in (4, 8):
        names = [k for k, c in CASES.items() if c[0] == n]
        cases = [dict(fn="lm", init=CASES[k][2], mesh=CASES[k][1],
                      masked=CASES[k][3], options=CASES[k][4],
                      eval=CASES[k][5], steps=STEPS, lr=LR)
                 for k in names]
        cases.append(dict(fn="lm_backend", mesh=_axes(1, 2, n // 2),
                          arch=ARCH))
        ranks = world.run_world(n, cases, inits=inits)
        out[n] = {k: [r[i] for r in ranks] for i, k in enumerate(names)}
        out[n]["backend"] = [r[-1] for r in ranks]
    return out


def _global(p):
    """A JAX-side params pytree as numpy, keys by name."""
    p = jax.device_get(p)
    return {"emb": np.asarray(p["emb"]), "head": np.asarray(p["head"]),
            "blocks": [{k: np.asarray(a) for k, a in blk.items()}
                       for blk in p["blocks"]]}


def _jax_run(name, inits):
    """The JAX step on the case's mesh from the same global params ->
    (losses, params, eval loss, logits)."""
    _, axes, init, masked, options, evals = CASES[name]
    init = inits[init]
    mesh = jmake_mesh(axes)
    step, _ = jtfm.make_train_step(mesh, *ARCH, lr=LR, masked=masked,
                                   compute_dtype=jnp.float32, **options)
    n_experts = options.get("n_experts")
    specs = jtfm.param_specs(ARCH[0], options.get("head_sharded", False),
                             moe=bool(n_experts))
    params = init["params"]
    if options.get("shard_params"):
        params = jtfm.shard_params_host(params, specs, axes["data"])
    batch = (init["tokens"], init["labels"]) + \
        ((init["mask"],) if masked else ())
    losses = []
    for _ in range(STEPS):
        params, loss = step(params, *batch)
        losses.append(float(loss))
    params = _global(params)
    if options.get("shard_params"):
        params = jtfm.unshard_params_host(params, specs, jtfm.param_shapes(
            ARCH[0], ARCH[1], ARCH[3], ARCH[4], n_experts=n_experts))
    ev = logits = None
    if evals:
        moe = {k: options[k] for k in ("n_experts", "moe_top_k")
               if k in options}
        ev = float(jtfm.make_eval_loss(
            mesh, *ARCH, compute_dtype=jnp.float32, masked=masked,
            loss_chunks=options.get("loss_chunks"),
            head_sharded=options.get("head_sharded", False), **moe)(
                params, *batch))
        if not options.get("head_sharded"):
            logits = np.asarray(jtfm.make_logits_fn(
                mesh, *ARCH, compute_dtype=jnp.float32, **moe)(
                    params, init["tokens"]))
    return losses, params, ev, logits


def _by_name(p) -> dict:
    flat = {"emb": p["emb"], "head": p["head"]}
    for i, blk in enumerate(p["blocks"]):
        flat.update({f"blocks.{i}.{k}": np.asarray(a)
                     for k, a in blk.items()})
    return flat


@pytest.mark.parametrize("name", list(CASES))
def test_step_matches_jax_on_the_mesh(worlds, inits, name, cpu_devices):
    n = CASES[name][0]
    ranks = worlds[n][name]
    losses, params, ev, logits = _jax_run(name, inits)
    for r in ranks:
        # every rank reports the one global loss
        assert r["losses"] == ranks[0]["losses"], name
    np.testing.assert_allclose(ranks[0]["losses"], losses, rtol=LOSS_RTOL,
                               atol=LOSS_ATOL, err_msg=name)
    got, want = _by_name(ranks[0]["params"]), _by_name(params)
    assert sorted(got) == sorted(want)
    codec = "quantized_collectives" in CASES[name][4]
    for k in want:
        err = np.abs(got[k] - want[k])
        if codec:
            flips = int((err > PARAM_ATOL).sum())
            assert flips <= max(2, err.size // 100), (name, k, flips)
            assert err.max() <= INT8_FLIP_ATOL, (name, k, err.max())
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=PARAM_ATOL,
                                       err_msg=f"{name} {k}")
    if ev is not None:
        assert all(r["eval"] == ranks[0]["eval"] for r in ranks)
        np.testing.assert_allclose(ranks[0]["eval"], ev, rtol=EVAL_RTOL,
                                   err_msg=name)
    if logits is not None and not codec:
        np.testing.assert_allclose(ranks[0]["logits"], logits,
                                   rtol=LOGIT_BAND, atol=LOGIT_BAND,
                                   err_msg=name)


def test_first_step_is_mesh_invariant(worlds, inits, cpu_devices):
    """The forward at one set of params is the same on every mesh: the
    (2, 2, 2) step's first loss against the JAX (1, 1, 1) step's, and
    with the MoE flags model 2 against model 1."""
    init = inits["dense"]
    step, _ = jtfm.make_train_step(jmake_mesh(_axes(1, 1, 1)), *ARCH, lr=LR,
                                   compute_dtype=jnp.float32)
    _, one = step(init["params"], init["tokens"], init["labels"])
    np.testing.assert_allclose(worlds[8]["plain_222"][0]["losses"][0],
                               float(one), rtol=SPMD_RTOL)
    np.testing.assert_allclose(
        worlds[8]["moe_flags_222"][0]["losses"][0],
        worlds[4]["moe_flags_221"][0]["losses"][0], rtol=FUZZ_RTOL,
        atol=FUZZ_ATOL)


def test_rank_coordinates_are_the_reference_device_array(worlds,
                                                         cpu_devices):
    for n, name in ((8, "plain_222"), (4, "head_chunks_update_122"),
                    (4, "moe4_params_212"), (4, "int8_141")):
        axes = CASES[name][1]
        devices = jmake_mesh(axes).devices
        for rank, r in enumerate(worlds[n][name]):
            assert list(r["coords"]) == list(axes)
            assert devices[tuple(r["coords"].values())].id == rank
            # the step's collectives went through the counted seam
            assert r["collectives"] > 0


def test_cuda_step_over_a_gloo_world_is_refused(worlds):
    for n in (4, 8):
        for r in worlds[n]["backend"]:
            assert r["refused"] and "needs a nccl group" in r["refused"]


def test_mesh_pipe_expert_and_dcn_axes_span_the_world():
    """The pipeline's axes and DCN axes are axes like the others: a mesh
    of one builds, a wider one needs a world as wide (the pipeline step
    on gloo worlds: tests/test_torch_port_pipe_expert.py)."""
    for bad in (lambda: tmesh.make_mesh({"data": 1, "pipe": 2}),
                lambda: tmesh.make_mesh({"expert": 2}),
                lambda: tmesh.make_hybrid_mesh({"data": 2}, {"data": 2}),
                lambda: tmesh.make_mesh(_axes(1, 2, 1))):
        with pytest.raises(ValueError, match="world of 1"):
            bad()
    pipe = tmesh.make_mesh({"data": 1, "pipe": 1, "expert": 1})
    assert pipe.axis(("pipe", "expert")).size == 1
    assert tmesh.make_hybrid_mesh({"data": 1, "model": 1},
                                  {"data": 1}).coords == {"data": 0,
                                                          "model": 0}
    one = tmesh.make_mesh(_axes(1, 1, 1))
    assert (one.size, one.coords, one.backend) == (
        1, {"data": 0, "seq": 0, "model": 0}, None)
    # the fused step keeps its data mesh, and refuses the other axes
    assert isinstance(tmesh.resolve(one), tmesh.DataMesh)
    with pytest.raises(NotImplementedError, match="fused step"):
        tmesh.resolve(_axes(1, 1, 2))
    with pytest.raises(ValueError, match="shard_params subsumes"):
        tfm.make_train_step(None, *ARCH, device="cpu", shard_update=True,
                            shard_params=True)
    with pytest.raises(ValueError, match="must divide"):
        tfm.make_train_step(None, 2, 32, 3, 64, 16, device="cpu")


def test_params_place_and_gather_on_a_mesh_of_one():
    """On a mesh of one the placement is the whole leaf and the gather
    its copy, in every layout's spec tree."""
    params = tfm.init_params(np.random.default_rng(3), *ARCH)
    one = tmesh.make_mesh(_axes(1, 1, 1))
    specs = tfm.param_specs(ARCH[0], head_sharded=True)
    ps = tfm.params_from_numpy(params, "cpu", mesh=one, specs=specs)
    back = tfm.params_to_numpy(ps, one, specs)
    for a, b in zip(tfm._leaves(back), tfm._leaves(params)):
        np.testing.assert_array_equal(a, b)
    flat = tfm.shard_params_host(params, tfm.param_specs(ARCH[0]), 3)
    assert flat["emb"].ndim == 1 and flat["emb"].size % 3 == 0
    again = tfm.unshard_params_host(flat, tfm.param_specs(ARCH[0]),
                                    tfm.param_shapes(*ARCH[:2], *ARCH[3:]))
    for a, b in zip(tfm._leaves(again), tfm._leaves(params)):
        np.testing.assert_array_equal(a, b)
    assert isinstance(ps["emb"], torch.Tensor)
