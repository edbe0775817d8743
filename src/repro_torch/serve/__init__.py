"""Oversubscription-aware continuous-batching LM serving on the card.

`ServeEngine` (engine.py) schedules requests through the states
pending -> prefill -> decoding -> preempted -> done; `PagedKVCache`
(paged.py) is the page pool underneath, governed by the unified-memory
runtime, and decode attends over it through the hand-written CUDA
paged-attention kernel. metrics.py turns the requests' modeled timestamps
into SLO reports. The traffic harness comes with a later slice.
"""
from repro_torch.serve.engine import EngineStats, Request, SeqState, ServeEngine  # noqa: F401
from repro_torch.serve.metrics import RequestRecord, collect, summarize  # noqa: F401
from repro_torch.serve.paged import PagedKVCache  # noqa: F401
