"""Ring attention over the ``seq`` axis
(``znicz_tpu_torch/parallel/ring_attention.py``) on gloo worlds of 2 and
4 processes on the CPU, against the JAX package's
``znicz_tpu/parallel/ring_attention.py`` under ``shard_map`` on a mesh
of the same ``seq`` size over the virtual CPU devices:

- ``ring_attention`` against the reference's, and
  ``ring_flash_attention`` (the flash kernels' plain versions on CPU
  tensors) against the reference's ``ring_flash_attention(...,
  interpret=True)`` (the Pallas kernel in interpret mode), causal and
  not: the outputs within 2e-4 / 2e-4 and the q, k, v gradients of
  ``(o * w).sum()`` within 3e-4 (the reference's own bands,
  ``tests/test_ring_flash.py``);
- the flash calls of the ring form: ``r + 1`` forwards and backwards on
  rank ``r`` under causal masking (a future block launches nothing),
  ``n`` without, and ``n - 1`` rotations each way;
- ``ring_mha_forward`` against the reference's
  (``tests/test_parallel_axes.py:59``'s shape and band);
- ``_merge_blocks``' exclusion, bit for bit;
- the smoke's ring-composition check (``chip_smoke.py
  ring_composition``: every rank of a ring played on one device against
  the whole-sequence flash kernel, with its future-block control) on
  the CPU at a small size.

Each world is one module-scoped spawn of gloo processes
(``tests/_torch_dp_world.py``)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import _torch_dp_world as world
from znicz_tpu.parallel.compat import shard_map
from znicz_tpu.parallel.mesh import make_mesh as jmake_mesh
from znicz_tpu.parallel import ring_attention as jring

from znicz_tpu_torch.parallel import ring_attention as ring

#: the reference's bands (tests/test_ring_flash.py)
FWD_RTOL, FWD_ATOL, GRAD_TOL = 2e-4, 2e-4, 3e-4
#: ring_mha_forward (tests/test_parallel_axes.py:59)
MHA_RTOL, MHA_ATOL = 2e-4, 2e-5
#: tests/test_ring_flash.py's shape: (b, t, h, dh); t_loc 256 and 128
SHAPE = (1, 512, 2, 64)
#: tests/test_parallel_axes.py:59's: (b, t, d), heads
MHA_SHAPE, MHA_HEADS = (2, 16, 32), 4
WORLDS = (2, 4)
FORMS = ("ring_attention", "ring_flash_attention")


@pytest.fixture(scope="module")
def inits():
    rng = np.random.default_rng(5)
    out = {x: rng.normal(size=SHAPE).astype(np.float32)
           for x in ("q", "k", "v", "w")}
    rng = np.random.default_rng(7)
    out["x"] = rng.normal(size=MHA_SHAPE).astype(np.float32)
    d = MHA_SHAPE[2]
    out["mha_params"] = {f"w{n}": rng.normal(0, 0.1, (d, d)).astype(
        np.float32) for n in "qkvo"}
    out["heads"] = MHA_HEADS
    return out


@pytest.fixture(scope="module")
def worlds(inits):
    """``{n: [rank 0's result, ...]}``, one spawn a world size."""
    return {n: [r[0] for r in world.run_world(n, [dict(fn="ring")],
                                              inits=inits)]
            for n in WORLDS}


def _gathered(ranks, key, name):
    """The ranks' blocks of ``name`` put back along time."""
    return np.concatenate([r[key][name] for r in ranks], axis=1)


def _jax_ring(n, form, causal, inits):
    """The reference's form under shard_map on a seq mesh of n: the
    output and the q, k, v gradients of ``(o * w).sum()``."""
    mesh = jmake_mesh({"data": 1, "seq": n, "model": 1})
    spec = P(None, "seq", None, None)
    if form == "ring_flash_attention":
        def inner(q, k, v):
            return jring.ring_flash_attention(q, k, v, "seq", causal=causal,
                                              interpret=True)
    else:
        def inner(q, k, v):
            return jring.ring_attention(q, k, v, "seq", causal=causal)
    fn = shard_map(inner, mesh=mesh, in_specs=(spec,) * 3, out_specs=spec)
    q, k, v, w = (jnp.asarray(inits[x]) for x in ("q", "k", "v", "w"))
    o = jax.jit(fn)(q, k, v)
    grads = jax.jit(jax.grad(lambda *a: (fn(*a) * w).sum(),
                             argnums=(0, 1, 2)))(q, k, v)
    return [np.asarray(a) for a in (o, *grads)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("n", WORLDS)
def test_ring_matches_reference(worlds, inits, n, form, causal,
                                cpu_devices):
    want = _jax_ring(n, form, causal, inits)
    got = [_gathered(worlds[n], (form, causal), name)
           for name in ("o", "dq", "dk", "dv")]
    np.testing.assert_allclose(got[0], want[0], rtol=FWD_RTOL,
                               atol=FWD_ATOL)
    for name, a, b in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        np.testing.assert_allclose(a, b, rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("n", WORLDS)
def test_flash_calls_and_rotations_a_rank(worlds, n):
    """Rank r runs r + 1 flash forwards and backwards under causal
    masking (the reference launches n and drops the future blocks'),
    n without; every rank makes n - 1 rotations forward and n - 1
    back (the reference's scan makes n)."""
    for r in worlds[n]:
        rank = r["index"]
        for causal, want in ((True, rank + 1), (False, n)):
            got = r[("ring_flash_attention", causal)]
            assert got["calls"] == {"fwd": want, "bwd": want}, (n, rank)
            assert got["collectives"] == 2 * (n - 1)
        assert r[("ring_attention", True)]["calls"] == {"fwd": 0,
                                                        "bwd": 0}


@pytest.mark.parametrize("n", WORLDS)
def test_ring_mha_matches_reference(worlds, inits, n, cpu_devices):
    mesh = jmake_mesh({"data": 1, "seq": n, "model": 1})
    f = shard_map(
        lambda x_, p_: jring.ring_mha_forward(x_, p_, MHA_HEADS, "seq",
                                              causal=True),
        mesh=mesh, in_specs=(P(None, "seq"), P()),
        out_specs=P(None, "seq"))
    want = np.asarray(jax.jit(f)(inits["x"], inits["mha_params"]))
    got = np.concatenate([r["mha"] for r in worlds[n]], axis=1)
    np.testing.assert_allclose(got, want, rtol=MHA_RTOL, atol=MHA_ATOL)


def test_merge_blocks_exclusion_is_bit_exact():
    gen = torch.Generator().manual_seed(3)
    o, o_s = (torch.randn(4, 8, 16, generator=gen) for _ in range(2))
    lse, lse_s = (torch.randn(4, 8, 1, generator=gen) for _ in range(2))
    for include in (False, torch.tensor(False)):
        got_o, got_lse = ring._merge_blocks(o, lse, o_s.bfloat16(), lse_s,
                                            include)
        assert torch.equal(got_o, o) and torch.equal(got_lse, lse)
    # an included block merges: the two normalised halves weigh by lse
    got_o, got_lse = ring._merge_blocks(o, lse, o_s, lse_s, True)
    w = torch.softmax(torch.cat([lse, lse_s], -1), -1)
    torch.testing.assert_close(got_o, o * w[..., :1] + o_s * w[..., 1:])
    torch.testing.assert_close(got_lse, torch.logaddexp(lse, lse_s))
    mask = torch.tensor([True, False, True, False])[:, None, None]
    part_o, part_lse = ring._merge_blocks(o, lse, o_s, lse_s, mask)
    assert torch.equal(part_o[1], o[1]) and torch.equal(part_lse[3],
                                                        lse[3])
    assert torch.equal(part_o[0], got_o[0])


def test_smoke_ring_composition_on_the_cpu():
    """chip_smoke's (a) at a small size in f32 on CPU tensors: every
    output within its band of the whole-sequence flash, the control
    rejected."""
    import chip_smoke

    report, bad = chip_smoke.ring_composition("cpu", 2, 2, 64, 16,
                                              torch.float32)
    assert bad == [], bad
    assert report["control"]["rejected"]
    assert len(report["rows"]) == 2 * len(chip_smoke.LM_RING_NS)
    assert max(e for r in report["rows"] for e in r["err"].values()) < 1e-5
