"""Async input pipeline of the port: prefetching loaders with overlapped
host-to-device staging (the port of ``znicz_tpu/pipeline``)."""

from znicz_tpu_torch.pipeline.prefetcher import (BatchPrefetcher,
                                                 PipelineStats,
                                                 PrefetcherStopped,
                                                 StagedBatch,
                                                 attach_prefetcher,
                                                 ready_on_current_stream,
                                                 ring_safe_stager)

__all__ = ["BatchPrefetcher", "PipelineStats", "PrefetcherStopped",
           "StagedBatch", "attach_prefetcher", "ready_on_current_stream",
           "ring_safe_stager"]
