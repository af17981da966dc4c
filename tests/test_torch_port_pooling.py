"""The port's max-pool backward (``znicz_tpu_torch/ops/pooling.py
scatter_backward``) against the reference's ``np.add.at`` scatter
(``znicz_tpu/ops/pooling.py scatter_backward``), on the CPU.

Where windows overlap (AlexNet's k3 s2 pools) an input cell sums the
errors of up to four windows, and a sum of three or more f32 terms
depends on their order.  The torch branch must give the reference's
bits exactly (no band): its tap passes add each cell's terms in
``np.add.at``'s order, with no atomics, so it gives the same bits on the
card, run after run (``chip_smoke.py`` checks that at AlexNet's pool1).
Each case first counts its cells of three and more terms, so that it
cannot pass vacuously, and a control sums the same terms in the reverse
order and must differ."""

import numpy as np
import pytest
import torch

from znicz_tpu.ops import pooling as jpool
from znicz_tpu_torch.ops import pooling as tpool

#: (input shape, window side, stride, input, least cells of >= 3 terms):
#: "corners" puts a peak at every (4p + 2, 4q + 2), which with k3 s2 is
#: the maximum of every window that holds it, so an inner peak wins all
#: four of its windows (13 x 13 such cells a channel at 55 x 55);
#: "random" pools normal inputs (a local maximum wins several windows)
CASES = [((2, 55, 55, 8), 3, 2, "corners", 2 * 8 * 13 * 13),
         ((3, 10, 11, 4), 3, 2, "corners", 3 * 4 * 2 * 2),
         ((2, 27, 27, 6), 3, 2, "random", 1),
         ((2, 9, 9, 3), 3, 1, "random", 10),
         ((1, 8, 7, 5), 2, 1, "random", 1)]


def _inputs(shape, k, s, kind, seed):
    """x, its max pool's offsets (the port's numpy forward, the
    reference's code) and a normal error of the output's shape."""
    rng = np.random.default_rng(seed)
    x = rng.random(shape).astype(np.float32)
    if kind == "corners":
        x[:, 2::4, 2::4] += 10.0
    else:
        x = rng.normal(size=shape).astype(np.float32)
    _, off = tpool.max_forward(np, x, k, k, s, s)
    err = rng.normal(size=off.shape).astype(np.float32)
    return x, off, err


def _terms(off, shape):
    """How many windows' errors each (n, cell, c) receives."""
    n, h, w, c = shape
    counts = np.zeros((n, h * w, c), np.int64)
    np.add.at(counts, (np.arange(n)[:, None, None], off.reshape(n, -1, c),
                       np.arange(c)[None, None, :]), 1)
    return counts


@pytest.mark.parametrize("case", CASES)
def test_overlapping_scatter_is_np_add_at_bit_for_bit(case):
    shape, k, s, kind, least = case
    _, off, err = _inputs(shape, k, s, kind, sum(shape))
    terms = _terms(off, shape)
    assert (terms >= 3).sum() >= least
    if kind == "corners":
        assert terms.max() == 4
    want = jpool.scatter_backward(np, err, off, shape)
    assert np.array_equal(tpool.scatter_backward(np, err, off, shape), want)
    got = tpool.scatter_backward(torch, torch.from_numpy(err),
                                 torch.from_numpy(off), shape,
                                 (k, k, s, s))
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))
    if kind == "corners":
        # the control: the same terms in the reverse window order
        n, _, _, c = shape
        rev = np.zeros((n, shape[1] * shape[2], c), np.float32)
        np.add.at(rev, (np.arange(n)[:, None, None],
                        off.reshape(n, -1, c)[:, ::-1],
                        np.arange(c)[None, None, :]),
                  err.reshape(n, -1, c)[:, ::-1])
        assert not np.array_equal(rev.reshape(shape), want)


@pytest.mark.parametrize("shape,k,s", [((2, 28, 28, 4), 2, 2),
                                       ((2, 9, 8, 3), 2, 3)])
def test_disjoint_windows_scatter_is_exact(shape, k, s):
    """Stride >= window: every cell receives at most one term, so the
    scatter is exact in any order (and keeps its one scatter)."""
    _, off, err = _inputs(shape, k, s, "random", 3)
    assert _terms(off, shape).max() == 1
    want = jpool.scatter_backward(np, err, off, shape)
    got = tpool.scatter_backward(torch, torch.from_numpy(err),
                                 torch.from_numpy(off), shape, (k, k, s, s))
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))


def test_torch_scatter_needs_the_window():
    _, off, err = _inputs((1, 5, 5, 2), 3, 2, "random", 4)
    with pytest.raises(ValueError, match="window"):
        tpool.scatter_backward(torch, torch.from_numpy(err),
                               torch.from_numpy(off), (1, 5, 5, 2))
