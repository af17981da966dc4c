"""Control-graph plumbing units — rebuild of veles/plumbing.py.

``StartPoint`` / ``EndPoint`` are the workflow's graph endpoints
(reference: veles/workflow.py :: StartPoint, EndPoint); ``Repeater`` is the
loop anchor every training workflow cycles through
(reference: veles/plumbing.py :: Repeater).
"""

from __future__ import annotations

from znicz_tpu_torch.core.units import TrivialUnit, Unit


class StartPoint(TrivialUnit):
    """Where Workflow.run injects the initial control signal."""


class EndPoint(TrivialUnit):
    """Terminal unit: firing it stops the workflow walk."""

    def __init__(self, workflow=None, **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        self.reached = False

    def run(self) -> None:
        self.reached = True


class Repeater(TrivialUnit):
    """Loop anchor: forwards the control signal each iteration.

    A Repeater fires when *any* provider signals (not all) — it is the join
    point of the cycle back-edge and the start edge, and requiring both would
    deadlock the first iteration.  Reference behavior: Repeater ignores
    incoming-link completeness.
    """

    def _signal(self, source, queue) -> None:
        # source=None bypasses the all-providers join in Unit._signal
        super()._signal(None, queue)


class UttermostPoint(TrivialUnit):
    """Alias kept for reference-API familiarity."""
