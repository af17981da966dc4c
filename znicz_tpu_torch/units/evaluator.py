"""Evaluators — the port of ``znicz_tpu/units/evaluator.py`` (rebuild of
veles.znicz evaluator.py :: EvaluatorBase, EvaluatorSoftmax,
EvaluatorMSE).

Turn the last forward's output + labels/targets into ``err_output`` for
the backward chain plus host-side metrics (``n_err``, confusion matrix,
mse).  Rows beyond ``batch_size`` (the loader's padding) contribute
neither gradient nor metrics.  The device path is plain torch, as the
reference's is plain XLA.
"""

from __future__ import annotations

import numpy as np
import torch

from znicz_tpu_torch.core.memory import Array
from znicz_tpu_torch.core.accelerated_units import AcceleratedUnit


class EvaluatorBase(AcceleratedUnit):
    """Common evaluator state (reference: evaluator.py :: EvaluatorBase)."""

    def __init__(self, workflow=None, **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        self.output = Array()      # linked from last forward
        self.err_output = Array()  # allocated here

    def _common_init(self, **kwargs) -> None:
        if not self.err_output or self.err_output.shape != self.output.shape:
            self.err_output.reset(shape=self.output.shape)
        self.init_array(self.output, self.err_output)


class EvaluatorSoftmax(EvaluatorBase):
    """Softmax + cross-entropy evaluator (reference: EvaluatorSoftmax).

    Consumes softmax probabilities ``output`` and integer ``labels``;
    produces ``err_output = y - onehot(labels)`` (d CE/d logits), and
    metrics: ``n_err`` (argmax mismatches), ``confusion_matrix``,
    ``max_err_output_sum``.  ``class_weights`` scales each sample's
    err_output row by the weight of its TRUE class; ``n_err`` stays an
    unweighted count.
    """

    def __init__(self, workflow=None, compute_confusion_matrix: bool = True,
                 class_weights=None, **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        self.labels = Array()   # linked from loader (minibatch_labels)
        self.max_idx = Array()  # linked from All2AllSoftmax
        self.compute_confusion_matrix = compute_confusion_matrix
        self.class_weights = None if class_weights is None else \
            np.asarray(class_weights, np.float32)
        self.n_err = 0
        self.confusion_matrix = None
        self.max_err_output_sum = 0.0

    def _common_init(self, **kwargs) -> None:
        super()._common_init(**kwargs)
        n_classes = self.output.shape[1]
        if self.class_weights is not None and \
                len(self.class_weights) != n_classes:
            raise ValueError(
                f"class_weights has {len(self.class_weights)} entries "
                f"for {n_classes} classes")
        if self.compute_confusion_matrix:
            self.confusion_matrix = np.zeros((n_classes, n_classes), np.int64)

    @staticmethod
    def _compute(xp, y, labels, max_idx, batch_size, class_weights=None):
        """Pure path shared by both backends; returns (err, n_err, sums)."""
        n, c = y.shape
        if xp is np:
            valid = (xp.arange(n) < batch_size)
            onehot = (labels[:, None] == xp.arange(c)[None, :]).astype(
                y.dtype)
            err = (y - onehot) * valid[:, None].astype(y.dtype)
            if class_weights is not None:
                err = err * class_weights[labels][:, None].astype(y.dtype)
            n_err = xp.sum((max_idx != labels) & valid)
            max_err_sum = xp.abs(err).sum(axis=1).max()
            return err, n_err, max_err_sum
        labels = labels.long()
        valid = torch.arange(n, device=y.device) < batch_size
        onehot = torch.nn.functional.one_hot(labels, c).to(y.dtype)
        err = (y - onehot) * valid[:, None].to(y.dtype)
        if class_weights is not None:
            err = err * class_weights[labels][:, None].to(y.dtype)
        n_err = ((max_idx.long() != labels) & valid).sum()
        return err, n_err, err.abs().sum(dim=1).max()

    def numpy_run(self) -> None:
        y = self.output.map_read()
        labels = self.labels.map_read()
        max_idx = self.max_idx.map_read() if self.max_idx else \
            y.argmax(axis=1)
        bs = self.current_batch_size(self.output)
        err, n_err, max_err_sum = self._compute(np, y, labels, max_idx, bs,
                                                self.class_weights)
        self.err_output.map_invalidate()
        self.err_output.mem = err
        self.n_err = int(n_err)
        self.max_err_output_sum = float(max_err_sum)
        if self.compute_confusion_matrix:
            np.add.at(self.confusion_matrix,
                      (max_idx[:bs], labels[:bs]), 1)

    def torch_init(self) -> None:
        self._cw = None if self.class_weights is None else \
            torch.tensor(self.class_weights, device=self.device.torch_device)

    def torch_run(self) -> None:
        for arr in (self.output, self.labels):
            arr.unmap()
        y = self.output.devmem
        max_idx = self.max_idx.devmem if self.max_idx else y.argmax(dim=1)
        bs = self.current_batch_size(self.output)
        err, n_err, max_err_sum = self._compute(
            torch, y, self.labels.devmem, max_idx, bs, self._cw)
        self.err_output.set_devmem(err)
        # metrics are host-side scalars (Decision consumes them in Python)
        self.n_err = int(n_err)
        self.max_err_output_sum = float(max_err_sum)
        if self.compute_confusion_matrix:
            idx = max_idx[:bs].cpu().numpy()
            lab = self.labels.map_read()[:bs]
            np.add.at(self.confusion_matrix, (idx, lab), 1)


class EvaluatorMSE(EvaluatorBase):
    """Mean-squared-error evaluator (reference: EvaluatorMSE).

    err_output = output - target (masked); metrics: ``mse`` over the valid
    rows and ``rmse``.  When ``labels`` AND ``class_targets`` are linked
    (one prototype vector per class), ``n_err`` counts nearest-target
    misclassifications; otherwise it mirrors mse.
    """

    def __init__(self, workflow=None, root_mse: bool = True, **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        self.target = Array()  # linked from loader (minibatch_targets)
        self.labels = Array()         # optional: integer class labels
        self.class_targets = Array()  # optional: (n_classes, *target_shape)
        self.root_mse = root_mse
        self.mse = 0.0
        self.rmse = 0.0
        self.n_err = 0

    @staticmethod
    def _compute(xp, y, target, batch_size):
        n = y.shape[0]
        if xp is np:
            valid = (xp.arange(n) < batch_size).astype(y.dtype)
        else:
            valid = (torch.arange(n, device=y.device) < batch_size).to(
                y.dtype)
        diff = (y.reshape(n, -1) - target.reshape(n, -1)) * valid[:, None]
        err = diff.reshape(y.shape)
        sample_mse = (diff * diff).mean(1)
        mse = sample_mse.sum() / batch_size
        return err, mse

    @staticmethod
    def nearest_prototype(xp, y, protos):
        """argmin_c ||y_i - protos[c]||^2 per row — the one distance/argmin
        definition shared by the eager paths and the fused step."""
        flat = y.reshape(y.shape[0], -1)
        pf = protos.reshape(protos.shape[0], -1)
        d = ((flat[:, None, :] - pf[None, :, :]) ** 2).sum(2)
        return d.argmin(1)

    @staticmethod
    def _nearest_target_errors(xp, y, protos, labels, batch_size):
        """Count nearest-prototype mispredictions over the valid rows."""
        pred = EvaluatorMSE.nearest_prototype(xp, y, protos)
        n = y.shape[0]
        valid = (xp.arange(n) if xp is np
                 else torch.arange(n, device=y.device)) < batch_size
        return ((pred != labels) & valid).sum()

    @property
    def _classifies(self) -> bool:
        return bool(self.labels) and bool(self.class_targets)

    def _common_init(self, **kwargs) -> None:
        super()._common_init(**kwargs)
        if self._classifies:
            self.init_array(self.labels, self.class_targets)

    def numpy_run(self) -> None:
        y = self.output.map_read()
        target = self.target.map_read()
        bs = self.current_batch_size(self.output)
        err, mse = self._compute(np, y, target, bs)
        self.err_output.map_invalidate()
        self.err_output.mem = err
        self.mse = float(mse)
        self.rmse = float(np.sqrt(self.mse))
        if self._classifies:
            self.n_err = int(self._nearest_target_errors(
                np, y, self.class_targets.map_read(),
                self.labels.map_read(), bs))
        else:
            self.n_err = self.mse  # Decision tracks mse for MSE workflows

    def torch_run(self) -> None:
        for arr in (self.output, self.target):
            arr.unmap()
        bs = self.current_batch_size(self.output)
        err, mse = self._compute(torch, self.output.devmem,
                                 self.target.devmem, bs)
        self.err_output.set_devmem(err)
        self.mse = float(mse)
        self.rmse = float(np.sqrt(self.mse))
        if self._classifies:
            self.n_err = int(self._nearest_target_errors(
                torch, self.output.devmem, self.class_targets.devmem,
                self.labels.devmem.long(), bs))
        else:
            self.n_err = self.mse
