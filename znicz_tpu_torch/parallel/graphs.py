"""Step bodies as CUDA graphs — the port's counterpart of the
reference's one jitted program a step, shared by the fused Unit step
(``parallel/step.py``) and the transformer LM step
(``parallel/transformer.py``).

:func:`run_graphed` runs a body eagerly at its first call (a real step
that builds every kernel and workspace on the capture stream), captures
it into a ``torch.cuda.CUDAGraph`` at its second and replays the capture
at once, and replays it at every later call after copying the inputs
into the graph's static buffers.  A body that cannot be captured raises
with the reason; nothing falls back to eager launches.  A replay runs
no kernel wrapper, so each kernel counter's launches at capture (and
the mesh's collective count) are added back on every replay.
"""

from __future__ import annotations

import sys

import torch


def _kernel_counters() -> list:
    """``(module, name)`` of every launch counter of the loaded kernel
    wrappers (``kernels/*.py``) and of the mesh's collectives
    (``parallel/mesh.py``): the ints whose names end in ``launches``."""
    return [(mod, attr) for name, mod in list(sys.modules.items())
            if (name.startswith("znicz_tpu_torch.kernels.") or
                name == "znicz_tpu_torch.parallel.mesh") and mod is not None
            for attr, v in vars(mod).items()
            if attr.endswith("launches") and type(v) is int]


def _capture_reason(exc: BaseException) -> str:
    """The error that stopped a capture and the one it set off, if any
    (a failed capture also fails its ``capture_end``)."""
    first = exc.__context__
    return str(exc) if first is None else f"{first} (then: {exc})"


class _StepGraph:
    """One step body captured into a CUDA graph: the buffers it reads its
    inputs from, the tensors it writes its outputs to (overwritten by
    every replay), each kernel counter's launches a replay, and the
    replays so far."""

    def __init__(self, what: str, body, inputs, device, stream,
                 generator) -> None:
        # static input buffers, allocated outside the graph's pool
        self.inputs = [torch.empty(t.shape, dtype=t.dtype, device=device)
                       for t in inputs]
        self.graph = torch.cuda.CUDAGraph()
        if generator is not None:
            # replays advance the generator's offset as eager draws would
            self.graph.register_generator_state(generator)
        counters = _kernel_counters()
        before = [getattr(mod, attr) for mod, attr in counters]
        try:
            # thread-local capture: the input pipeline's worker keeps
            # allocating pinned slots and copying on its side stream while
            # this thread captures
            with torch.cuda.graph(self.graph, stream=stream,
                                  capture_error_mode="thread_local"):
                self.outputs = body(*self.inputs)
        except Exception as exc:
            raise RuntimeError(
                f"the {what} body cannot be captured into a CUDA graph: "
                f"{_capture_reason(exc)}") from exc
        finally:
            # the capture recorded the wrappers' launches, it ran none
            after = [getattr(mod, attr) for mod, attr in counters]
            for (mod, attr), n in zip(counters, before):
                setattr(mod, attr, n)
        self.launches = [(mod, attr, a - b) for (mod, attr), a, b
                         in zip(counters, after, before) if a != b]
        self.replays = 0

    def __call__(self, *inputs):
        for buf, t in zip(self.inputs, inputs):
            if t.device.type == "cpu":
                # through pinned memory (PyTorch's caching host allocator
                # keeps the block until the copy is done), so the host
                # need not wait for the queued replays to reach the copy
                t = t.pin_memory()
            # a staged (device) input: a device-to-device copy on the
            # replay's stream, which already waited on its staging event
            buf.copy_(t, non_blocking=True)
        self.graph.replay()
        self.replays += 1
        for mod, attr, n in self.launches:
            setattr(mod, attr, getattr(mod, attr) + n)
        return self.outputs


def run_graphed(graphs: dict, key, what: str, body, inputs, device,
                stream, generator=None):
    """``body(*inputs)`` on ``device`` through the graphs of ``graphs``
    (``key`` -> a :class:`_StepGraph`, or None once the body ran
    eagerly).  The first call of a key runs the body eagerly on
    ``stream`` (a real step that builds every kernel and workspace), the
    second captures it into a CUDA graph and replays the capture at
    once, and every later call copies ``inputs`` (host or device
    tensors) into the graph's buffers and replays it.  ``what`` names
    the body in the error a failed capture raises."""
    if key not in graphs:
        graphs[key] = None
        main = torch.cuda.current_stream(device)
        stream.wait_stream(main)
        with torch.cuda.stream(stream):
            out = body(*(t.to(device) for t in inputs))
        main.wait_stream(stream)
        return out
    graph = graphs[key]
    if graph is None:
        graph = graphs[key] = _StepGraph(what, body, inputs, device, stream,
                                         generator)
    return graph(*inputs)
