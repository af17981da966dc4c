"""NN-specific plotters — the port of ``znicz_tpu/units/nn_plotting.py``
(a copy; rebuild of veles.znicz nn_plotting_units.py ::
Weights2D, KohonenHits, KohonenInputMaps, KohonenNeighborMap and
multi_hist.py :: MultiHistogram)."""

from __future__ import annotations

import numpy as np

from znicz_tpu_torch.plotting import Plotter


def tile_filters(w: np.ndarray, shape=None) -> np.ndarray:
    """(n_in, n_out) or HWIO conv weights -> a grid image of per-unit
    filters (reference: Weights2D layout logic)."""
    if w.ndim == 4:                         # HWIO conv bank
        ky, kx, c, n = w.shape
        tiles = [w[:, :, :, i].mean(axis=2) for i in range(n)]
    else:
        n_in, n_out = w.shape
        if shape is None:
            side = int(np.sqrt(n_in))
            shape = (side, side) if side * side == n_in else (1, n_in)
        tiles = [w[:, i].reshape(shape) for i in range(n_out)]
    n = len(tiles)
    cols = int(np.ceil(np.sqrt(n)))
    rows = int(np.ceil(n / cols))
    th, tw = tiles[0].shape
    grid = np.zeros((rows * (th + 1) - 1, cols * (tw + 1) - 1), np.float32)
    for i, t in enumerate(tiles):
        r, c = divmod(i, cols)
        lo, hi = t.min(), t.max()
        norm = (t - lo) / (hi - lo) if hi > lo else t * 0
        grid[r * (th + 1):r * (th + 1) + th,
             c * (tw + 1):c * (tw + 1) + tw] = norm
    return grid


class Weights2D(Plotter):
    """Weight-matrix tile image (reference: Weights2D); ``input`` is the
    weights Array of a forward unit."""

    def __init__(self, workflow=None, sample_shape=None, **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        self.input = None
        self.sample_shape = sample_shape

    def redraw(self, plt, fig) -> None:
        w = np.asarray(self.input.map_read())
        grid = tile_filters(w, self.sample_shape)
        ax = fig.add_subplot(111)
        ax.imshow(grid, cmap="gray")
        ax.axis("off")


class MultiHistogram(Plotter):
    """Per-layer weight histograms, one subplot each (reference:
    multi_hist.py :: MultiHistogram); ``inputs`` = list of Arrays."""

    def __init__(self, workflow=None, n_bins: int = 40, **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        self.inputs: list = []
        self.n_bins = n_bins

    def redraw(self, plt, fig) -> None:
        n = max(len(self.inputs), 1)
        for i, arr in enumerate(self.inputs):
            ax = fig.add_subplot(1, n, i + 1)
            ax.hist(np.asarray(arr.map_read()).ravel(), bins=self.n_bins)
            ax.set_title(f"layer {i}", fontsize=8)


class KohonenHits(Plotter):
    """SOM winner-count map (reference: KohonenHits); links ``forward`` to
    a KohonenForward unit."""

    def __init__(self, workflow=None, **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        self.forward = None

    def redraw(self, plt, fig) -> None:
        f = self.forward
        ax = fig.add_subplot(111)
        im = ax.imshow(f.hits.reshape(f.sy, f.sx), cmap="hot")
        fig.colorbar(im)
        ax.set_title("SOM hits")


class KohonenInputMaps(Plotter):
    """Per-input-dimension SOM weight maps (reference: KohonenInputMaps);
    links ``trainer`` to the KohonenTrainer."""

    def __init__(self, workflow=None, max_maps: int = 9, **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        self.trainer = None
        self.max_maps = max_maps

    def redraw(self, plt, fig) -> None:
        tr = self.trainer
        w = np.asarray(tr.weights.map_read())
        dims = min(w.shape[1], self.max_maps)
        cols = int(np.ceil(np.sqrt(dims)))
        rows = int(np.ceil(dims / cols))
        for d in range(dims):
            ax = fig.add_subplot(rows, cols, d + 1)
            ax.imshow(w[:, d].reshape(tr.sy, tr.sx), cmap="viridis")
            ax.axis("off")


class KohonenNeighborMap(Plotter):
    """U-matrix: mean distance of each SOM neuron to its grid neighbors
    (reference: KohonenNeighborMap)."""

    def __init__(self, workflow=None, **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        self.trainer = None

    def redraw(self, plt, fig) -> None:
        tr = self.trainer
        w = np.asarray(tr.weights.map_read()).reshape(tr.sy, tr.sx, -1)
        u = np.zeros((tr.sy, tr.sx), np.float32)
        for y in range(tr.sy):
            for x in range(tr.sx):
                dists = []
                for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0)):
                    yy, xx = y + dy, x + dx
                    if 0 <= yy < tr.sy and 0 <= xx < tr.sx:
                        dists.append(np.linalg.norm(w[y, x] - w[yy, xx]))
                u[y, x] = np.mean(dists)
        ax = fig.add_subplot(111)
        im = ax.imshow(u, cmap="bone")
        fig.colorbar(im)
        ax.set_title("U-matrix")
