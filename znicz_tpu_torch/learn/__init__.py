"""Continuous learning on live traffic — the port of
``znicz_tpu/learn/``, the VELES
master-loop closed end to end: serving workers append accepted traffic
to a crash-safe feedback spool, a supervised trainer consumes it as a
streaming dataset, publishes a fresh LM package every K epochs, and an
adoption bridge rolls the serving fleet onto it with zero lost
requests.

Pieces (each importable on its own; the spool never imports torch, so
serving workers stay as light as before):

- :mod:`znicz_tpu_torch.learn.spool` — the bounded multi-writer JSONL
  spool (:class:`FeedbackSpool`) and its exactly-once cursor reader
  (:class:`SpoolReader`);
- :mod:`znicz_tpu_torch.loader.spool` — ``SpoolSequenceLoader``, the
  streaming dataset loader tailing the spool into the async
  ``BatchPrefetcher`` with a snapshot-durable consumption cursor;
- :mod:`znicz_tpu_torch.learn.publish` — the every-K-epochs LM export
  unit and the atomic publish manifest;
- :mod:`znicz_tpu_torch.learn.bridge` — the publish-to-rollout adoption
  bridge over the fleet's :class:`RollingUpdate`;
- :mod:`znicz_tpu_torch.learn.cli` — ``python -m znicz_tpu_torch learn
  <pkg>``, the one-command assembly (serve fleet + trainer under the
  elastic supervisor + bridge).

The trainer is the port's ``TransformerLMStep`` (the flash kernels on
the card); the workers decode with the paged-decode kernel.
"""

from znicz_tpu_torch.learn.spool import (  # noqa: F401
    FeedbackSpool, SpoolReader, SpoolTimeout, initial_cursor)
from znicz_tpu_torch.learn.publish import (  # noqa: F401
    latest_manifest, publish_package)
from znicz_tpu_torch.learn.bridge import AdoptionBridge  # noqa: F401
