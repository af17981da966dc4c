"""Admission errors of the serving plane — the part of
``znicz_tpu/serve/batcher.py`` the generative slice uses.  The dynamic
micro-batcher of the forward-package plane comes with a later slice of
the port."""

from __future__ import annotations


class QueueFull(RuntimeError):
    """Backpressure: the bounded queue has no room (HTTP 503)."""


class DeadlineExceeded(TimeoutError):
    """The request's deadline lapsed before service (HTTP 504)."""
