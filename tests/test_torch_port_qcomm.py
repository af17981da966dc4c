"""The quantized-collective codec of the port (``znicz_tpu_torch/parallel/
qcomm.py``) against the reference's (``znicz_tpu/parallel/qcomm.py``):
the cases of ``tests/test_qcomm.py``, each port function against the
reference function on the same numpy inputs:

- ``resolve`` (typos refused), ``chunk_layout``, ``wire_nbytes`` and
  ``exact_nbytes``: the same values;
- ``quantize_flat`` (int8 and bf16, ``valid_size`` masking a poisoned
  tail, an all-pad slice) and ``dequantize_flat``: identical payloads,
  scales and values;
- ``psum_tree`` on gloo worlds of 2 and 4 (``tests/_torch_dp_world.py``)
  against the reference's inside ``shard_map`` on a mesh of the same
  size: within 1e-6 relative, the same on every rank; with residuals,
  the new residuals within 1e-6 and the error-feedback identity (the ranks'
  h summed equals the quantized sum plus the residuals summed);
- ``gather_slices`` (``zero.all_gather_slices`` with a codec) on aligned,
  padded and mostly-pad leaves: the reference's values within 1e-6
  relative, the same bits on every rank;
- ``quantized_psum``'s exact path: the plain sum.
"""

import numpy as np
import pytest
import torch

import jax
from jax import lax
from jax.sharding import PartitionSpec as P

import _torch_dp_world as world
from znicz_tpu.parallel import qcomm as jq
from znicz_tpu.parallel import zero as jzero
from znicz_tpu.parallel.compat import shard_map
from znicz_tpu.parallel.mesh import make_mesh

from znicz_tpu_torch.parallel import mesh as tmesh
from znicz_tpu_torch.parallel import qcomm as tq

#: the port's collectives against the reference's inside jit, relative
#: and absolute: XLA groups a four-term sum its own way and may contract
#: a product into the sum or divide by a constant through its reciprocal
#: (measured: 1 f32 ulp at most, 1.8e-7 relative), where the port rounds
#: each product and sums in rank order; outside jit the reference's
#: quantize_flat and dequantize_flat give the port's bits
SUM_RTOL = SUM_ATOL = 1e-6
WORLDS = (2, 4)
CONFIGS = ({"mode": "int8", "chunk": 16}, {"mode": "bf16"})
GATHER_SIZES = (64, 61, 3)


def _inputs(n: int) -> dict:
    """Per-rank trees and residuals (stacked on axis 0) and the full
    leaves to gather, from one seed."""
    rng = np.random.default_rng(100 + n)
    trees = [{"w": rng.standard_normal((n, 13, 7)).astype(np.float32),
              "b": rng.standard_normal((n, 5)).astype(np.float32)},
             {"w": (100 * rng.standard_normal((n, 40))).astype(np.float32)}]
    residuals = [{k: (0.01 * rng.standard_normal(v.shape)).astype(
        np.float32) for k, v in leaf.items()} for leaf in trees]
    gather = [rng.standard_normal(size).astype(np.float32)
              for size in GATHER_SIZES]
    return {"trees": trees, "residuals": residuals, "gather": gather}


@pytest.fixture(scope="module")
def worlds():
    """Each world's results: ``{n: (inputs, [rank results a config])}``."""
    out = {}
    for n in WORLDS:
        inputs = _inputs(n)
        ranks = world.run_world(n, [{"fn": "qcomm", "config": c}
                                    for c in CONFIGS], inputs)
        out[n] = (inputs, ranks)
    return out


def _ref_psum_tree(inputs, n, codec):
    """The reference's psum_tree, with and without residuals, and its
    gather_slices, inside shard_map on a mesh of n."""
    mesh = make_mesh({"data": n})

    def body(t, r):
        local = jax.tree.map(lambda x: x[0], t)
        res = jax.tree.map(lambda x: x[0], r)
        s, _ = jq.psum_tree(local, "data", codec)
        s_ef, nr = jq.psum_tree(local, "data", codec, res)
        stack = lambda tree: jax.tree.map(lambda x: x[None], tree)  # noqa
        return stack(s), stack(s_ef), stack(nr)

    fn = shard_map(body, mesh=mesh, in_specs=(P("data"), P("data")),
                   out_specs=(P("data"), P("data"), P("data")))
    summed, summed_ef, new_res = jax.jit(fn)(inputs["trees"],
                                             inputs["residuals"])
    gathered = []
    for full in inputs["gather"]:
        like = jax.ShapeDtypeStruct(full.shape, np.float32)
        flat = np.pad(full, (0, (-full.size) % n))

        def gbody(f):
            return jzero.all_gather_slices(f, lax.axis_index("data"), n,
                                           "data", like, codec=codec)

        g = shard_map(gbody, mesh=mesh, in_specs=(P("data"),),
                      out_specs=P())
        gathered.append(np.asarray(jax.jit(g)(flat)))
    return jax.device_get((summed, summed_ef, new_res)), gathered


# -- local functions ----------------------------------------------------------

@pytest.mark.parametrize("config", [
    None, {}, {"mode": "off"}, {"mode": "int8"},
    {"mode": "bf16", "chunk": 256, "error_feedback": False},
    {"mode": "int8", "chunk": 7, "error_feedback": True}])
def test_resolve_matches_reference(config):
    def key(c):
        return None if c is None else (c.mode, c.chunk, c.error_feedback)
    assert key(tq.resolve(config)) == key(jq.resolve(config))


@pytest.mark.parametrize("bad", [{"mode": "int8", "chunks": 64},
                                 {"mode": "fp8"},
                                 {"mode": "int8", "chunk": 0}])
def test_resolve_rejects_what_the_reference_rejects(bad):
    with pytest.raises(ValueError):
        jq.resolve(bad)
    with pytest.raises(ValueError):
        tq.resolve(bad)


def test_chunk_layout_and_byte_math_match_reference():
    int8, bf16 = tq.Codec("int8"), tq.Codec("bf16")
    j8, j16 = jq.Codec("int8"), jq.Codec("bf16")
    for size in (1, 7, 16, 23, 64, 1000, 1024, 1025, 4096, 99991):
        for chunk in (1, 64, 1024):
            assert tq.chunk_layout(size, chunk) == \
                jq.chunk_layout(size, chunk)
        assert tq.wire_nbytes(int8, size) == jq.wire_nbytes(j8, size)
        assert tq.wire_nbytes(bf16, size) == jq.wire_nbytes(j16, size)
        assert tq.wire_nbytes(None, size) == jq.wire_nbytes(None, size)
        assert tq.exact_nbytes(size) == jq.exact_nbytes(size)


def _quantized(mod, codec, x, valid=None):
    payload, scales = mod.quantize_flat(x, codec, valid_size=valid)
    as_np = (lambda t: t.float().numpy()) if mod is tq else \
        (lambda a: np.asarray(a, np.float32))
    return as_np(payload), None if scales is None else as_np(scales)


@pytest.mark.parametrize("mode", ["int8", "bf16"])
@pytest.mark.parametrize("size,valid", [(1, None), (500, None),
                                        (1025, None), (96, 71), (32, 0)])
def test_quantize_flat_identical_to_reference(mode, size, valid):
    """The same payload and scales, a poisoned tail past ``valid_size``
    masked out of both, and an all-pad slice quantizing to zeros."""
    rng = np.random.default_rng(size)
    x = (rng.standard_normal(size) *
         np.repeat([1e-4, 1.0, 1e3, 10.0], -(-size // 4))[:size]) \
        .astype(np.float32)
    if valid is not None:
        x[valid:] = 1e9
    got = _quantized(tq, tq.Codec(mode, chunk=32), torch.from_numpy(x),
                     valid)
    want = _quantized(jq, jq.Codec(mode, chunk=32), x, valid)
    np.testing.assert_array_equal(got[0], want[0])
    if mode == "int8":
        np.testing.assert_array_equal(got[1], want[1])
    else:
        assert got[1] is None and want[1] is None
    if valid == 0:
        assert (got[0] == 0).all()


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_dequantize_flat_identical_to_reference(mode):
    rng = np.random.default_rng(9)
    x = rng.standard_normal(333).astype(np.float32)
    tp, ts = tq.quantize_flat(torch.from_numpy(x), tq.Codec(mode, chunk=64))
    jp, js = jq.quantize_flat(x, jq.Codec(mode, chunk=64))
    np.testing.assert_array_equal(
        tq.dequantize_flat(tp, ts, 333).numpy(),
        np.asarray(jq.dequantize_flat(jp, js, 333)))


def test_psum_leaf_on_a_mesh_of_one_is_a_round_trip():
    """Without a group the quantized sum of one rank is its own
    dequantized payload, and the residual what it lost."""
    rng = np.random.default_rng(11)
    g = torch.from_numpy(rng.standard_normal(50).astype(np.float32))
    r = torch.zeros(50)
    codec = tq.Codec("int8", chunk=32)
    s, nr = tq.psum_leaf(g, tmesh.DataMesh(1), codec, r)
    p, sc = tq.quantize_flat(g, codec)
    np.testing.assert_array_equal(s.numpy(),
                                  tq.dequantize_flat(p, sc, 50).numpy())
    np.testing.assert_array_equal((s + nr).numpy(), g.numpy())


# -- on gloo worlds ----------------------------------------------------------

def _leaves(tree):
    return [leaf[k] for leaf in tree for k in sorted(leaf)]


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("ci", range(len(CONFIGS)))
def test_psum_tree_on_the_world_matches_reference(worlds, n, ci):
    inputs, ranks = worlds[n]
    codec = jq.resolve(CONFIGS[ci])
    (summed, summed_ef, new_res), _ = _ref_psum_tree(inputs, n, codec)
    for r, res in enumerate(ranks):
        got = res[ci]
        for key, want in (("summed", summed), ("summed_ef", summed_ef)):
            for a, b in zip(_leaves(got[key]), _leaves(want)):
                np.testing.assert_allclose(a, b[r], rtol=SUM_RTOL,
                                           atol=SUM_ATOL,
                                           err_msg=f"{key} rank {r}")
        # a residual is h less its dequantized self: its error is the
        # dequantization's, on h's scale
        for a, b, h in zip(_leaves(got["new_res"]), _leaves(new_res),
                           _leaves(inputs["trees"])):
            np.testing.assert_allclose(
                a, b[r], rtol=0,
                atol=SUM_ATOL * max(1.0, float(np.abs(h).max())))
        # every rank holds the same sums
        for a, b in zip(_leaves(got["summed"]),
                        _leaves(ranks[0][ci]["summed"])):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", WORLDS)
def test_error_feedback_identity_on_the_world(worlds, n):
    """Σ_r h_r = the quantized sum + Σ_r new residual_r, h = g + r: what
    the codec drops this step is carried, not lost."""
    inputs, ranks = worlds[n]
    ci = 0                                            # int8
    h = [g + r for g, r in zip(_leaves(inputs["trees"]),
                               _leaves(inputs["residuals"]))]
    for i, hi in enumerate(h):
        carried = sum(_leaves(res[ci]["new_res"])[i] for res in ranks)
        np.testing.assert_allclose(
            _leaves(ranks[0][ci]["summed_ef"])[i] + carried, hi.sum(0),
            rtol=0, atol=1e-5 * max(1.0, float(np.abs(hi).max())))


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("ci", range(len(CONFIGS)))
def test_gather_slices_matches_reference(worlds, n, ci):
    inputs, ranks = worlds[n]
    _, want = _ref_psum_tree(inputs, n, jq.resolve(CONFIGS[ci]))
    for res in ranks:
        for a, b in zip(res[ci]["gathered"], want):
            np.testing.assert_allclose(a, b, rtol=SUM_RTOL, atol=SUM_ATOL)
        for a, b in zip(res[ci]["gathered"], ranks[0][ci]["gathered"]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", WORLDS)
def test_exact_path_is_the_plain_sum(worlds, n):
    inputs, ranks = worlds[n]
    for res in ranks:
        for a, b in zip(_leaves(res[0]["exact"]), _leaves(inputs["trees"])):
            np.testing.assert_allclose(a, b.sum(0), rtol=SUM_RTOL,
                                       atol=SUM_ATOL)
