"""Growable fully-connected layer — the port of
``znicz_tpu/units/resizable_all2all.py`` (rebuild of veles.znicz
resizable_all2all.py :: ResizableAll2All); a copy.

An All2All whose output width can change between runs: ``resize(n)``
reallocates weights/bias preserving the overlapping block (existing
columns keep their trained values; new columns get fresh init)."""

from __future__ import annotations

import numpy as np

from znicz_tpu_torch.units.all2all import All2All


class ResizableAll2All(All2All):
    """Reference: resizable_all2all.py :: ResizableAll2All."""

    MAPPING = {"resizable_all2all"}

    def resize(self, new_output: int) -> None:
        old_w = self.weights.map_read()
        n_in, old_out = old_w.shape if not self.weights_transposed else \
            old_w.shape[::-1]
        self.output_sample_shape = (int(new_output),)
        stddev = self.weights_stddev or 1.0 / np.sqrt(n_in)
        fresh = self._fill((n_in, new_output) if not self.weights_transposed
                           else (new_output, n_in),
                           self.weights_filling, stddev)
        keep = min(old_out, new_output)
        if self.weights_transposed:
            fresh[:keep, :] = old_w[:keep, :]
        else:
            fresh[:, :keep] = old_w[:, :keep]
        self.weights.map_invalidate()
        self.weights.reset(fresh)
        if self.include_bias:
            old_b = self.bias.map_read()
            fresh_b = self._fill((new_output,), self.bias_filling,
                                 self.bias_stddev or 0.01)
            fresh_b[:keep] = old_b[:keep]
            self.bias.map_invalidate()
            self.bias.reset(fresh_b)
        # output re-allocates on next initialize/run
        batch = self.output.shape[0] if self.output else None
        if batch is not None:
            self.output.reset(shape=(batch, new_output))
        if self.initialized:
            self.init_array(self.weights, self.bias, self.output)
            getattr(self, f"{self.backend_suffix}_init",
                    self.numpy_init)()
