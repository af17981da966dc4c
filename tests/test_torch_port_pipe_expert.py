"""The pipeline step and the expert axis (``znicz_tpu_torch/parallel/
{pipeline,moe,mesh,transformer}.py``) on gloo worlds of 2, 4 and 8
processes on the CPU, against the JAX package on meshes of the same
axes over the virtual CPU devices, f32:

- ``pipeline_apply`` over ``pipe`` 4 (``tests/test_parallel_axes.py:
  131``) within 1e-6, and ``moe_ffn`` over ``expert`` 4, top-1
  (``:97``), within 1e-5;
- ``make_pipeline_step`` at ``(data, pipe, expert)`` ``(1, 2, 1)``,
  ``(1, 2, 2)`` and ``(2, 2, 2)``, 5 steps at the reference test's size
  (d 16, ff 32, 4 experts, 4 microbatches of 8 rows, lr 0.05): the
  losses within rtol 1e-5 and every rank's block of every leaf within
  1e-5 of its device's in the JAX step.  Beside them the reference's
  gradient scaling, pinned: at ``(1, 2, 1)`` the first update is 2.0
  times ``lr`` times the sequential two-stage model's gradient (a
  ``psum``'s transpose is a ``psum``); and bf16 compute tracks f32
  within the reference's 5e-2 at ``(2, 2, 2)``, the params f32; the
  step learns over 40 steps there (``tests/test_transformer_spmd.py:94``);
- ``moe_ffn_dispatch``'s four cases of ``tests/test_moe_dispatch.py`` at
  ``expert`` 4 (values, gradients, capacity drops and top-2) against
  the JAX dispatch on a mesh of 4, within 1e-5;
- the hybrid mesh: ``hybrid_ranks`` on played node lists against the
  reference's ``make_hybrid_mesh`` on devices wrapped with slice
  indices (``tests/test_parallel.py:356-428``), its errors, and a gloo
  world of 4 split into 2 nodes whose lines' gathers and exchanges
  keep line order.

Each world is one module-scoped spawn of gloo processes
(``tests/_torch_dp_world.py``); every JAX run is made here, in
module-scoped fixtures.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import _torch_dp_world as world
from znicz_tpu.parallel import transformer as jtfm
from znicz_tpu.parallel.compat import shard_map
from znicz_tpu.parallel.mesh import make_hybrid_mesh as jhybrid
from znicz_tpu.parallel.mesh import make_mesh as jmake_mesh
from znicz_tpu.parallel.moe import moe_ffn as jmoe_ffn
from znicz_tpu.parallel.moe import moe_ffn_dispatch as jdispatch
from znicz_tpu.parallel.pipeline import pipeline_apply as jpipeline

from znicz_tpu_torch.parallel import mesh as tmesh
from znicz_tpu_torch.parallel import moe as tmoe
from znicz_tpu_torch.parallel import transformer as tfm

#: the pipeline step: d, ff, experts, microbatches, rows, lr, steps
D, FF, E, N_MICRO, MB, LR, STEPS = 16, 32, 4, 4, 8, 0.05, 5
LEARN_STEPS = 40
#: port against the JAX package
PIPE_BAND, MOE_BAND, STEP_RTOL, BLOCK_ATOL = 1e-6, 1e-5, 1e-5, 1e-5
#: bf16 against f32: tests/test_transformer_spmd.py:191's band
BF16_RTOL = 5e-2


def _axes(d, p, e):
    return {"data": d, "pipe": p, "expert": e}


#: name -> (world, axes)
STEP_MESHES = {"121": (2, _axes(1, 2, 1)), "122": (4, _axes(1, 2, 2)),
               "222": (8, _axes(2, 2, 2))}


def _dispatch_inputs(seed, n_dev, e_local, d, ff, t_total):
    """``tests/test_moe_dispatch.py _setup``'s draws."""
    rng = np.random.default_rng(seed)
    n_exp = n_dev * e_local
    return {"x": rng.normal(size=(t_total, d)).astype(np.float32),
            "gate": rng.normal(size=(d, n_exp)).astype(np.float32),
            "w1": rng.normal(size=(n_exp, d, ff)).astype(np.float32) * 0.3,
            "b1": rng.normal(size=(n_exp, ff)).astype(np.float32),
            "w2": rng.normal(size=(n_exp, ff, d)).astype(np.float32) * 0.3,
            "b2": rng.normal(size=(n_exp, d)).astype(np.float32)}


#: the dispatch cases at expert 4: inputs (seed, e_local, d, ff, tokens),
#: capacity factor, top_k and the loss whose gradients are compared
DISPATCH = {
    "lossless": ((3, 2, 8, 16, 32), 8.0, 1, "wsum"),
    "capacity": ((5, 1, 4, 8, 16), 0.5, 1, None),
    "top2": ((11, 1, 8, 16, 32), 4.0, 2, "square"),
}


@pytest.fixture(scope="module")
def inits():
    rng = np.random.default_rng(2)
    xs = rng.normal(size=(N_MICRO, MB, D)).astype(np.float32)
    w_true = rng.normal(0, 0.3, (D, D)).astype(np.float32)
    out = {"pipe": {"params": tfm.init_moe_pipeline_params(
        np.random.default_rng(9), 2, D, FF, E), "xs": xs,
        "ys": xs @ w_true + 0.5 * xs, "n_experts": E, "lr": LR}}
    prng = np.random.default_rng(4)
    out["pipeline"] = {"xs": prng.normal(size=(6, 4, 8)).astype(np.float32),
                       "ws": prng.normal(0, 0.5, (4, 8, 8)).astype(
                           np.float32),
                       "bs": prng.normal(0, 0.1, (4, 8)).astype(np.float32)}
    mrng = np.random.default_rng(3)
    out["moe"] = {"x": mrng.normal(size=(16, 8)).astype(np.float32),
                  "gate": mrng.normal(0, 1.0, (8, 8)).astype(np.float32),
                  "w1": mrng.normal(0, 0.1, (8, 8, 16)).astype(np.float32),
                  "b1": mrng.normal(0, 0.1, (8, 16)).astype(np.float32),
                  "w2": mrng.normal(0, 0.1, (8, 16, 8)).astype(np.float32),
                  "b2": mrng.normal(0, 0.1, (8, 8)).astype(np.float32)}
    for name, ((seed, e_l, d, ff, t), *_rest) in DISPATCH.items():
        out[name] = _dispatch_inputs(seed, 4, e_l, d, ff, t)
        out[name]["wsum"] = np.random.default_rng(seed + 100).normal(
            size=(t, d)).astype(np.float32)
    out["hybrid"] = np.arange(16, dtype=np.float32).reshape(2, 8)
    return out


@pytest.fixture(scope="module")
def worlds(inits):
    """One spawn a world size, one after another: 2 the (1, 2,
    1) step; 4 the (1, 2, 2) step, the axes, the dispatch cases and the
    hybrid mesh; 8 the (2, 2, 2) step in f32, bf16 and over
    LEARN_STEPS."""
    jobs = {n: [{"fn": "pipe_step", "mesh": axes, "steps": STEPS}]
            for n, axes in STEP_MESHES.values()}
    jobs[4] += [{"fn": "axes"}] + [
        {"fn": "dispatch", "init": name, "capacity_factor": cf,
         "top_k": k, "loss": loss}
        for name, (_inp, cf, k, loss) in DISPATCH.items()] + [
        {"fn": "hybrid", "local": 2, "axes": {"data": 2, "expert": 2},
         "dcn": {"expert": 2}, "exchange": "expert"}]
    jobs[8] += [{"fn": "pipe_step", "mesh": STEP_MESHES["222"][1],
                 "steps": STEPS, "bf16": True},
                {"fn": "pipe_step", "mesh": STEP_MESHES["222"][1],
                 "steps": LEARN_STEPS}]
    return {n: world.run_world(n, cases, inits)
            for n, cases in jobs.items()}


def _device_blocks(tree) -> dict:
    """``{leaf: {device id: block}}`` of a JAX params pytree: each
    device's own copy, replicas included."""
    return {k: {s.device.id: np.asarray(s.data) for s in a.addressable_shards}
            for k, a in tree.items()}


@pytest.fixture(scope="module")
def jax_steps(inits):
    """The JAX pipeline step on each mesh in f32: losses, each device's
    blocks after the first step and after STEPS (at (2, 2, 2) the same
    run goes on to LEARN_STEPS)."""
    init = inits["pipe"]
    out = {}
    for name, (_n, axes) in STEP_MESHES.items():
        mesh = jmake_mesh(axes)
        step, _ = jtfm.make_pipeline_step(mesh, E, lr=LR,
                                          compute_dtype=jnp.float32)
        p, losses, blocks = init["params"], [], {}
        for i in range(LEARN_STEPS if name == "222" else STEPS):
            p, loss = step(p, init["xs"], init["ys"])
            losses.append(float(loss))
            if i + 1 in (1, STEPS):
                blocks[i + 1] = _device_blocks(p)
        out[name] = {"losses": losses[:STEPS], "all": losses,
                     "first": blocks[1], "blocks": blocks[STEPS],
                     "devices": [d.id for d in mesh.devices.ravel()]}
    return out


def test_init_matches_jax(inits):
    want = jtfm.init_moe_pipeline_params(np.random.default_rng(9), 2, D, FF,
                                         E)
    got = inits["pipe"]["params"]
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert tfm.moe_pipeline_specs() == {
        k: tuple(s) for k, s in jtfm.moe_pipeline_specs().items()}


@pytest.mark.parametrize("name", list(STEP_MESHES))
def test_pipeline_step_matches_jax(worlds, jax_steps, name):
    """Every rank's losses and its blocks of every leaf, replicas
    included, against its device's in the JAX step."""
    n, axes = STEP_MESHES[name]
    ref = jax_steps[name]
    assert ref["devices"] == list(range(n))      # rank r is device r
    ranks = [w[0] for w in worlds[n]]
    for rank, r in enumerate(ranks):
        np.testing.assert_allclose(r["losses"], ref["losses"],
                                   rtol=STEP_RTOL)
        assert list(r["coords"]) == list(axes)
        for when in ("first", "blocks"):
            for k, block in r[when].items():
                np.testing.assert_allclose(block, ref[when][k][rank],
                                           atol=BLOCK_ATOL,
                                           err_msg=f"{name} {when} {k}")
    # the gathered params hold each block's first holder's copy
    for k, spec in tfm.moe_pipeline_specs().items():
        whole = ranks[0]["global"][k]
        for r in ranks:
            c = r["coords"]
            if c["data"] or ("expert" not in spec and c["expert"]):
                continue
            blk = r["blocks"][k]
            e = c["expert"] if "expert" in spec else 0
            np.testing.assert_array_equal(
                whole[c["pipe"]:c["pipe"] + 1,
                      e * blk.shape[1]:(e + 1) * blk.shape[1]], blk)


def _sequential_grads(init):
    """The sequential two-stage model's gradient of the step's loss, in
    plain torch on the CPU (f32)."""
    gelu = functools.partial(torch.nn.functional.gelu, approximate="tanh")
    ps = {k: torch.tensor(v, requires_grad=True)
          for k, v in init["params"].items()}
    x = torch.tensor(init["xs"])
    for s in range(2):
        y, _ = tmoe.moe_ffn(x.reshape(-1, D), ps["gate"][s], ps["w1"][s],
                            ps["b1"][s], ps["w2"][s], ps["b2"][s], gelu)
        x = x + y.reshape(x.shape)
    loss = ((x - torch.tensor(init["ys"])) ** 2).mean()
    grads = torch.autograd.grad(loss, list(ps.values()))
    return {k: g.numpy() for k, g in zip(ps, grads)}


def test_pipeline_step_update_is_twice_the_sequential_gradient(
        worlds, jax_steps, inits):
    """The reference's quirk, held by the port: at (1, 2, 1) the first
    update is 2.0 · lr · the sequential two-stage model's gradient (the
    pipe ``psum``'s transpose sums the two stages' equal cotangents);
    both packages' updates."""
    init = inits["pipe"]
    grads = _sequential_grads(init)
    ref = jax_steps["121"]["first"]
    for stage, r in enumerate(w[0] for w in worlds[2]):
        for k, g in grads.items():
            want = 2.0 * LR * g[stage]
            for got in (init["params"][k][stage] - r["first"][k][0],
                        init["params"][k][stage] - ref[k][stage][0]):
                np.testing.assert_allclose(got, want, rtol=1e-3,
                                           atol=1e-7, err_msg=k)
    # ... and not the sequential model's own step
    upd = init["params"]["w1"][0] - worlds[2][0][0]["first"]["w1"][0]
    assert not np.allclose(upd, LR * grads["w1"][0], rtol=0.1)


def test_pipeline_step_bf16_tracks_f32_and_learns(worlds, jax_steps):
    """At (2, 2, 2): bf16 compute within 5e-2 of f32 with the params
    still f32 (tests/test_transformer_spmd.py:191, which holds the JAX
    step's bf16 to its f32 the same way); over LEARN_STEPS the loss
    falls below 0.8x its first (:94), every rank's losses against the
    JAX step's."""
    f32, bf16, learn = ([r[i] for r in worlds[8]] for i in range(3))
    for a, b in zip(f32, bf16):
        np.testing.assert_allclose(b["losses"], a["losses"], rtol=BF16_RTOL)
        assert all(v.dtype == np.float32 for v in b["blocks"].values())
    for r in learn:
        np.testing.assert_allclose(r["losses"], jax_steps["222"]["all"],
                                   rtol=1e-4)
        assert r["losses"][-1] < 0.8 * r["losses"][0], r["losses"]


@pytest.fixture(scope="module")
def jax_axes(inits):
    """The JAX package's pipeline (pipe 4, tanh stages) and moe_ffn
    (expert 4, relu, top-1) on the inputs of the axes case."""
    p, m = inits["pipeline"], inits["moe"]

    def stage_fn(params, x):
        w, b = params
        return jnp.tanh(x @ w[0] + b[0])

    pipe = shard_map(lambda xs_, w_, b_: jpipeline(stage_fn, (w_, b_), xs_,
                                                    4, "pipe"),
                     mesh=jmake_mesh({"pipe": 4}),
                     in_specs=(P(), P("pipe"), P("pipe")), out_specs=P())
    moe = shard_map(lambda x_, g_, w1_, b1_, w2_, b2_: jmoe_ffn(
        x_, g_, w1_, b1_, w2_, b2_, lambda a: jnp.maximum(a, 0.0),
        "expert")[0], mesh=jmake_mesh({"expert": 4}),
        in_specs=(P(), P(), P("expert"), P("expert"), P("expert"),
                  P("expert")), out_specs=P())
    return {"pipeline": np.asarray(jax.jit(pipe)(p["xs"], p["ws"], p["bs"])),
            "moe": np.asarray(jax.jit(moe)(m["x"], m["gate"], m["w1"],
                                           m["b1"], m["w2"], m["b2"]))}


def test_pipeline_apply_over_pipe_4_matches_jax(worlds, jax_axes, inits):
    p = inits["pipeline"]
    seq = p["xs"].copy()
    for s in range(4):
        seq = np.tanh(seq @ p["ws"][s] + p["bs"][s])
    for r in worlds[4]:
        got = r[1]["pipeline"]
        np.testing.assert_allclose(got, jax_axes["pipeline"], atol=PIPE_BAND,
                                   rtol=0)
        np.testing.assert_allclose(got, seq, rtol=2e-4, atol=2e-5)


def test_moe_ffn_over_expert_4_matches_jax(worlds, jax_axes):
    for r in worlds[4]:
        np.testing.assert_allclose(r[1]["moe"], jax_axes["moe"],
                                   rtol=MOE_BAND, atol=MOE_BAND)


@pytest.fixture(scope="module")
def jax_dispatch(inits):
    """The JAX dispatch over ``expert`` 4 on each case's inputs: the
    output and the gradients of the case's loss."""
    out = {}
    mesh = jmake_mesh({"expert": 4})
    for name, (_inp, cf, k, loss) in DISPATCH.items():
        init = inits[name]

        def local(x, gate, w1, b1, w2, b2, cf=cf, k=k):
            return jdispatch(x, gate, w1, b1, w2, b2, jax.nn.gelu,
                             axis_name="expert", capacity_factor=cf,
                             top_k=k)[0]
        fn = shard_map(local, mesh=mesh,
                       in_specs=(P("expert"), P(), P("expert"),
                                 P("expert"), P("expert"), P("expert")),
                       out_specs=P("expert"))
        args = tuple(jnp.asarray(init[a]) for a in
                     ("x", "gate", "w1", "b1", "w2", "b2"))
        wsum = jnp.asarray(init["wsum"])

        def values_and_grads(*a, fn=fn, loss=loss):
            # the loss's gradients through the cotangent of y
            y, back = jax.vjp(fn, *a)
            return y, back(wsum if loss == "wsum" else 2 * y)
        y, grads = jax.jit(values_and_grads)(*args)
        out[name] = {"y": np.asarray(y)}
        if loss is not None:
            out[name]["grads"] = [np.asarray(g) for g in grads]
    return out


def _stitched(ranks, what):
    """The port's global arrays from its ranks' blocks: x and the expert
    stacks concatenated in rank order, the gate's gradient summed (each
    rank's holds its own tokens' routing)."""
    if what == "y":
        return np.concatenate([r["y"] for r in ranks])
    return [np.concatenate([r["grads"][i] for r in ranks]) if i != 1 else
            sum(r["grads"][1] for r in ranks) for i in range(6)]


@pytest.mark.parametrize("what", ["values", "gradients", "capacity",
                                  "top2"])
def test_dispatch_matches_jax(worlds, jax_dispatch, inits, what):
    """``tests/test_moe_dispatch.py``'s cases at expert 4: lossless top-1
    values and gradients (capacity factor E), capacity drops (one slot
    a source: later tokens of an expert give exactly zero) and top-2
    with its gradients, each against the JAX dispatch."""
    case = {"values": "lossless", "gradients": "lossless"}.get(what, what)
    ranks = [r[2 + list(DISPATCH).index(case)] for r in worlds[4]]
    ref = jax_dispatch[case]
    y = _stitched(ranks, "y")
    np.testing.assert_allclose(y, ref["y"], rtol=MOE_BAND, atol=MOE_BAND)
    if what in ("gradients", "top2"):
        for got, want in zip(_stitched(ranks, "grads"), ref["grads"]):
            np.testing.assert_allclose(got, want, rtol=MOE_BAND,
                                       atol=MOE_BAND)
    if what == "capacity":
        init = inits["capacity"]
        choice = (init["x"] @ init["gate"]).argmax(-1)
        seen, dropped = set(), 0
        for t, e in enumerate(choice):
            if (t // 4, int(e)) in seen:
                assert np.all(y[t] == 0.0), t
                dropped += 1
            seen.add((t // 4, int(e)))
        assert dropped > 0


def test_bucket_slots_count_drops_in_token_order():
    choice = torch.tensor([[0], [1], [0], [0], [1], [2]])
    slot, keep = tmoe.bucket_slots(choice, 3, 2)
    assert keep.tolist() == [True, True, True, False, True, True]
    assert slot.tolist() == [0, 2, 1, 6, 3, 4]
    two = torch.tensor([[0, 1], [1, 0]])
    slot, keep = tmoe.bucket_slots(two, 2, 1)
    assert keep.tolist() == [True, True, False, False]


class _Dev:
    """A JAX device with a played slice index (the reference test's
    wrapper)."""

    def __init__(self, d, sid):
        self._d, self.slice_index = d, sid

    def __getattr__(self, name):
        return getattr(self._d, name)


#: (axis sizes, dcn sizes, slice of each of the 8 devices)
HYBRID_CASES = {
    "dcn_data_contiguous": ({"data": 2, "model": 4}, {"data": 2},
                            [i // 4 for i in range(8)]),
    "dcn_model_contiguous": ({"data": 2, "model": 4}, {"model": 2},
                             [i // 4 for i in range(8)]),
    "dcn_data_interleaved": ({"data": 2, "model": 4}, {"data": 2},
                             [i % 2 for i in range(8)]),
    "three_axes_four_slices": ({"data": 2, "pipe": 2, "expert": 2},
                               {"data": 2, "pipe": 2},
                               [i // 2 for i in range(8)]),
}


@pytest.mark.parametrize("name", list(HYBRID_CASES))
def test_hybrid_ranks_match_the_reference(cpu_devices, name):
    """The rank array from played node lists against the reference's
    device array on devices with those slice indices (no trimming)."""
    axes, dcn, sids = HYBRID_CASES[name]
    devs = [_Dev(d, s) for d, s in zip(cpu_devices, sids)]
    want = np.vectorize(lambda d: d.id)(jhybrid(axes, dcn, devices=devs)
                                        .devices)
    nodes = [[i for i, s in enumerate(sids) if s == sid]
             for sid in sorted(set(sids))]
    np.testing.assert_array_equal(tmesh.hybrid_ranks(axes, dcn, nodes),
                                  want)


def test_hybrid_ranks_one_node_and_errors(cpu_devices):
    """One node is the plain mesh (the reference's single-slice
    fallback); the reference's errors keep their words; where the
    reference trims surplus nodes or ranks, the port raises."""
    one = tmesh.hybrid_ranks({"data": 2, "model": 4}, {"data": 2},
                             [list(range(8))])
    np.testing.assert_array_equal(one, np.arange(8).reshape(2, 4))
    ref = jhybrid({"data": 2, "model": 4}, {"data": 2})
    assert ref.devices.shape == one.shape
    two = [[0, 1, 2, 3], [4, 5, 6, 7]]
    for args, words in (
            (({"data": 3}, {"data": 2}, two), "must divide"),
            (({"data": 8}, {"pipe": 2}, two), "not in axis_sizes"),
            (({"data": 8}, {"data": 4}, two), "only"),
            (({"data": 8}, None, two), "no single slice"),
            (({"data": 2, "model": 2}, {"data": 2}, two), "spans the whole"),
            (({"data": 4}, {"data": 2}, [[0], [1], [2], [3]]),
             "trims no node"),
            (({"data": 2, "model": 2}, {"data": 2}, [[0, 1, 2], [3]]),
             "per slice")):
        with pytest.raises(ValueError, match=words):
            tmesh.hybrid_ranks(*args)
    with pytest.raises(ValueError, match="world of 4"):
        tmesh.hybrid_ranks({"data": 8}, None, [[0, 1, 2, 3]])


def test_hybrid_mesh_on_a_world_split_in_two_nodes(worlds, inits):
    """A gloo world of 4, two ranks a node: ``expert`` spans the nodes
    (rank array [[0, 2], [1, 3]]); the world line's gather comes back in
    line order, an all-to-all over ``expert`` swaps blocks between the
    nodes, and a leaf sharded over both axes places and gathers back."""
    want = np.array([[0, 2], [1, 3]])
    for rank, r in enumerate(w[-1] for w in worlds[4]):
        np.testing.assert_array_equal(r["devices"], want)
        pos = np.argwhere(want == rank)[0]
        assert r["coords"] == {"data": int(pos[0]), "expert": int(pos[1])}
        np.testing.assert_array_equal(r["gathered"], want.ravel())
        line = [int(x) for x in want[pos[0]]]
        assert r["line_ranks"] == line
        mine = line.index(rank)
        np.testing.assert_array_equal(
            r["exchanged"], [100 * src + mine for src in line])
        np.testing.assert_array_equal(
            r["block"], inits["hybrid"][pos[0]:pos[0] + 1,
                                        pos[1] * 4:(pos[1] + 1) * 4])
        np.testing.assert_array_equal(r["back"], inits["hybrid"])


def test_mesh_pipe_expert_coordinates(worlds):
    """Each rank of the step's meshes sits at its device's place in the
    reference's mesh of the same axes."""
    for n, axes in STEP_MESHES.values():
        devices = jmake_mesh(axes).devices
        for rank, r in enumerate(w[0] for w in worlds[n]):
            assert devices[tuple(r["coords"].values())].id == rank
