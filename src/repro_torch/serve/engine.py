"""Oversubscription-aware continuous-batching serve engine (the port of
``repro.serve.engine``).

Requests move through the scheduler states

    pending -> prefill -> decoding -> (preempted <-> decoding)* -> done

driven by one ``step()`` per engine iteration:

  1. **Admission control**: preempted sequences resume first (oldest rid
     first), then pending requests are admitted FIFO. Admission needs free
     KV pool pages for the whole prompt plus a watermark and, when a
     :class:`UnifiedMemory` governs the pool, ``um.device_free()`` covering
     ``admit_device_fraction`` of the projected KV growth (skipped when
     nothing runs, so the engine always makes progress).
  2. **Chunked prefill**: at most ``prefill_chunk`` prompt tokens per step
     (shared FIFO budget). Each chunk attends over the KV already in the
     pool (gathered per layer), so chunked and unchunked prefill agree.
  3. **Async prefetch**: resumed sequences' pool extents are promoted ahead
     of their decode turn via ``um.prefetch_async``.
  4. **Batched decode**: one step over every decoding sequence, whose
     attention is the hand-written paged-attention kernel
     (``repro_torch.kernels.paged_attention``) over the pool. If the pool
     cannot back the batch's new-token pages, the youngest sequences are
     preempted: their KV is demoted host-side (``um.demote`` +
     ``PagedKVCache.swap_out``) and written back on resume. On a CUDA
     card the pass's layer loop is a CUDA graph, one a batch size,
     captured at the second batch of that size and replayed from then; its
     inputs are refilled at fixed addresses every step
     (:class:`DecodeInputs`). The final norm, the head and the argmax run
     eagerly on the graph's output.

The engine runs on one device: the CUDA card unless the caller passes
``device="cpu"``, where the kernel's plain version runs. Attention archs
only, dense or MoE, with global (``attention``) layers and optionally
sliding-window (``local``) ones beside them: the window layers keep their
own pool (``PagedKVCache(window=W)``, ``self.wcache``), whose pages that
leave the window go back to its free stack at the start of each step
(span ``kv.window``), and attend only their last W keys in prefill and
decode. A MoE block's ``ffn`` routes the prefill chunk's
tokens (T = chunk) or the decode batch's (T = B) with capacity-bounded
dispatch, so its drops depend on the batch's composition (recurrent archs
come with a later slice). ``fault_plan`` (a
:class:`~repro_torch.runtime.FaultPlan`) and ``tp_plan`` (a
:class:`~repro_torch.cluster.ClusterTPPlan`) only add modeled charges,
replays and node pins. The scheduler state (page table, lengths, free pages) is numpy, so the
charges of the unified-memory runtime match the JAX engine's bit for bit.

**Timing.** :meth:`ServeEngine.now` is the modeled clock (``um.clock`` under
a UnifiedMemory, the step index otherwise, plus idle time skipped by
:meth:`advance_to`). ``arrival_time`` is recorded at enqueue, so TTFT
includes the queueing delay before admission. Host-clock spans
(:mod:`repro_torch.spans`) mark the step's parts: ``serve.step``,
``serve.admit``, ``serve.prefill``, ``serve.pages``, ``serve.decode``,
``serve.sync`` (the device-to-host copy of the sampled tokens alone),
``serve.capture`` (a decode pass captured as a graph), ``kv.window`` (the
window pool's release of pages, tag: pages released) and ``um.charge``
(each call into the charge model). Spans inside the pass (``moe.block``)
run only while it runs eagerly or is captured.
"""
from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import HostSpillError, UnifiedMemory
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.models.attention import _causal_bias, _sdpa
from repro_torch.models.layers import RunPolicy
from repro_torch.serve.paged import PagedKVCache, window_pages
from repro_torch.spans import SPANS


class SeqState(Enum):
    PENDING = "pending"      # not yet admitted
    PREFILL = "prefill"      # admitted, prompt partially prefilled
    DECODING = "decoding"    # generating tokens
    PREEMPTED = "preempted"  # KV swapped host-side, waiting to resume
    DONE = "done"


@dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    generated: List[int] = field(default_factory=list)
    sid: int = -1
    state: SeqState = SeqState.PENDING
    prefill_pos: int = 0  # prompt tokens whose KV is in the pool
    saved: Optional[dict] = None  # host-side KV while preempted
    preemptions: int = 0
    recoveries: int = 0  # fault replays (KV lost, recomputed from prompt)
    tenant: str = ""
    # modeled-clock timestamps (engine.now()); TTFT anchors at arrival_time
    arrival_time: float = 0.0
    admit_time: Optional[float] = None
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None

    @property
    def done(self) -> bool:
        return self.state is SeqState.DONE


@dataclass
class EngineStats:
    admitted: int = 0
    preempted: int = 0
    resumed: int = 0
    prefill_chunks: int = 0
    decode_batches: int = 0
    decode_tokens: int = 0
    # fault-recovery accounting (zero in a fault-free run)
    node_losses: int = 0
    recovered_requests: int = 0
    replayed_tokens: int = 0  # token work thrown away and recomputed
    spill_failures: int = 0
    admission_retries: int = 0  # admissions deferred by the post-fault hold
    lane_degraded_steps: int = 0
    # how the decode passes ran (CUDA graphs on a card; zero on the CPU)
    decode_graph_captures: int = 0
    decode_graph_replays: int = 0
    # the window layers' pool (zero without one): pages returned as they
    # left the window; summed at each decode batch, the pages the pool
    # holds and those its layers would hold with every key; the most pages
    # one sequence held there at a decode batch
    window_pages_released: int = 0
    window_pages_held: int = 0
    window_pages_all_keys: int = 0
    window_seq_pages_max: int = 0

    NOT_MODELED = ("decode_graph_captures", "decode_graph_replays",
                   "window_pages_released", "window_pages_held",
                   "window_pages_all_keys", "window_seq_pages_max")

    def modeled(self) -> Dict[str, int]:
        """The counts of the modeled schedule, the same on every device and
        in the JAX engine: every field but how the decode passes ran and
        the window pool's."""
        out = dataclasses.asdict(self)
        for k in self.NOT_MODELED:
            del out[k]
        return out


class DecodeInputs:
    """The decode pass's inputs at fixed device addresses, so that a CUDA
    graph captured once for a batch size reads every later batch's values:
    for each of at most ``max_seqs`` sequences its last token, its position,
    the keys it attends (the new one too), the new token's pool page and
    slot, and its page-table row; with ``window`` also the new token's
    page and slot in the window layers' pool and its row there. One flat
    int32 buffer holds them; a batch of B sequences reads the first B rows
    of each. ``fill`` writes a host staging buffer (pinned on a card),
    zeroes the rows past the batch (the null page, length 0), and copies it
    to the device in one copy on the current stream that does not block
    the host."""

    FIELDS = ("tokens", "positions", "lengths", "pages", "slots")
    WINDOW_FIELDS = ("wpages", "wslots")

    def __init__(self, max_seqs: int, pages_per_seq: int, device,
                 window: bool = False):
        n = max_seqs
        self.fields = self.FIELDS + (self.WINDOW_FIELDS if window else ())
        self.tables = ("page_table",) + (("wpage_table",) if window else ())
        f, t = len(self.fields), len(self.tables)
        numel = n * (f + t * pages_per_seq)
        cuda = device.type == "cuda"
        self.host = torch.zeros(numel, dtype=torch.int32, pin_memory=cuda)
        self.dev = (torch.zeros(numel, dtype=torch.int32, device=device)
                    if cuda else self.host)
        # the last copy out of the staging buffer (a card only)
        self._copied = torch.cuda.Event() if cuda else None
        host = self.host.numpy()
        self._host_cols = host[:f * n].reshape(f, n)
        self._host_pt = host[f * n:].reshape(t, n, pages_per_seq)
        self._cols = self.dev[:f * n].view(f, n)
        self._pt = self.dev[f * n:].view(t, n, pages_per_seq)

    def fill(self, tokens, positions, lengths, pages, slots, page_rows,
             *window) -> None:
        """Stage one batch (each argument holds B values, ``page_rows`` is
        (B, pages_per_seq)) and copy it to the device; ``window``: the
        window pool's pages, slots and page rows."""
        B = len(tokens)
        if self._copied is not None:
            self._copied.synchronize()  # the last copy has read the stage
        cols = self._host_cols
        vals = (tokens, positions, lengths, pages, slots) + window[:2]
        for i, v in enumerate(vals):
            cols[i, :B] = v
        cols[:, B:] = 0
        for i, rows in enumerate((page_rows,) + window[2:]):
            self._host_pt[i, :B] = rows
        self._host_pt[:, B:] = 0
        if self.dev is not self.host:
            self.dev.copy_(self.host, non_blocking=True)
            self._copied.record()

    def views(self, B: int) -> Dict[str, torch.Tensor]:
        """The device views a batch of B reads: ``tokens`` and ``positions``
        (B, 1), ``lengths``, ``pages`` and ``slots`` (B,), ``page_table``
        (B, pages_per_seq), and with a window ``wpages``, ``wslots`` and
        ``wpage_table``; each contiguous, at the same address for every
        batch of B."""
        out = {k: self._cols[i, :B] for i, k in enumerate(self.fields)}
        out["tokens"] = out["tokens"].view(B, 1)
        out["positions"] = out["positions"].view(B, 1)
        for i, k in enumerate(self.tables):
            out[k] = self._pt[i, :B]
        return out


class ServeEngine:
    def __init__(self, cfg, params, *, max_seqs: int = 8, max_len: int = 512,
                 page_size: int = 64,
                 num_pages: "Optional[int] | Dict[str, int]" = None,
                 policy: Optional[RunPolicy] = None,
                 um: Optional[UnifiedMemory] = None, greedy: bool = True,
                 prefill_chunk: int = 128, watermark_pages: int = 0,
                 admit_device_fraction: float = 0.5,
                 counter_threshold: int = 16, mem_policy=None,
                 tp_plan=None, fault_plan=None,
                 admit_backoff_steps: int = 2, device=None):
        """``params`` is the :class:`~repro_torch.models.TransformerLM`;
        it must live on ``device`` (the CUDA card unless the caller passes
        ``device="cpu"``). ``num_pages`` sizes the KV pool, or with window
        layers each pool by layer kind (``{"attention": n, "local": m}``;
        a window pool left unsized holds ``max_seqs`` sequences' most)."""
        dev = resolve_device(device)
        kinds = cfg.layer_kinds()
        if (cfg.mixer != "attention" or "attention" not in kinds
                or not set(kinds) <= {"attention", "local"}):
            raise ValueError("paged serving with chunked prefill needs "
                             "global-attention archs (with or without "
                             "sliding-window layers beside them)")
        if params.device.type != dev.type or dev.index not in (
                None, params.device.index):
            raise ValueError(f"params live on {params.device}, the engine "
                             f"runs on {dev}")
        self.device = params.device
        self.cfg = cfg
        self.params = params
        self.policy = policy or RunPolicy()
        self.layout = params.layout
        # tp_plan (a ClusterTPPlan) maps sequences to serving superchips and
        # charges per-token tensor-parallel collective traffic; it only ADDS
        # modeled charges and node pins, so tokens stay those of one node
        self.tp_plan = tp_plan
        seq_node = (tp_plan.node_of_seq if tp_plan is not None
                    and um is not None else None)
        self.prefill_chunk = max(1, prefill_chunk)
        local = [i for i, k in enumerate(kinds) if k == "local"]
        pages = num_pages if isinstance(num_pages, dict) else {
            "attention": num_pages}

        def pool(layers=None, window=0, n=None):
            return PagedKVCache(cfg, self.layout, max_seqs=max_seqs,
                                max_len=max_len, page_size=page_size,
                                num_pages=n, dtype=params.final_norm.scale.dtype,
                                device=params.device, um=um,
                                counter_threshold=counter_threshold,
                                mem_policy=mem_policy, seq_node=seq_node,
                                layers=layers, window=window)
        self.cache = pool(
            [i for i, k in enumerate(kinds) if k == "attention"] if local
            else None, n=pages.get("attention"))
        self.wcache = None  # the window layers' pool
        if local:
            W = cfg.local_window
            self.wcache = pool(local, W, pages.get("local") or (
                max_seqs * window_pages(W, self.prefill_chunk, page_size) + 1))
        self.pools = [p for p in (self.cache, self.wcache) if p is not None]
        # model layer -> (the pool that holds it, its index there)
        self._kv = [(p, p.layers.index(i)) for i in range(cfg.num_layers)
                    for p in self.pools if i in p.layers]
        self.um = um
        self.requests: Dict[int, Request] = {}
        self._next_rid = 0
        self.greedy = greedy
        self.max_len = max_len
        self.watermark_pages = watermark_pages
        self.admit_device_fraction = admit_device_fraction
        self.stats = EngineStats()
        self._inputs = DecodeInputs(max_seqs, self.cache.pages_per_seq,
                                    self.device, self.wcache is not None)
        # B -> (CUDA graph of the decode pass for B sequences, its output)
        self._graphs: Dict[int, tuple] = {}
        self._sightings: Dict[int, int] = {}  # decode batches of each size
        self._graph_pool = None
        self._capture_stream = None
        self._needs_prefetch: List[Request] = []
        self._steps = 0
        self._idle_skipped = 0.0
        # fault plan (a FaultPlan): a frozen, sorted schedule this engine
        # consumes through its own cursor; None costs one identity check
        # per step, so fault-free runs are unchanged
        if fault_plan is not None and not fault_plan:
            fault_plan = None  # empty plan: take the zero-cost path
        if fault_plan is not None and um is None:
            raise ValueError(
                "fault_plan needs a UnifiedMemory-governed engine: faults "
                "are delivered through um.fail_node / set_lane_degradation "
                "/ set_spill_failure")
        self.fault_plan = fault_plan
        self._fault_idx = 0
        self._degrade_until = -1  # step the active lane window expires at
        self._spill_until = -1    # step the active spill window expires at
        self.admit_backoff_steps = max(1, admit_backoff_steps)
        self._backoff = self.admit_backoff_steps
        self._hold_admit = 0  # steps fresh admission stays held post-fault
        self.draining = False

    # ----------------------------------------------------------------- clock
    def now(self) -> float:
        """Modeled time: the UnifiedMemory clock when one governs the pool,
        the step index otherwise, plus idle time skipped via advance_to."""
        base = self.um.clock if self.um is not None else float(self._steps)
        return base + self._idle_skipped

    def advance_to(self, t: float) -> float:
        """Fast-forward the clock to ``t`` (never backwards). Returns now()."""
        cur = self.now()
        if t > cur:
            self._idle_skipped += t - cur
        return self.now()

    # ---------------------------------------------------------------- admin
    def add_request(self, prompt: np.ndarray, max_new_tokens: int = 16, *,
                    arrival_time: Optional[float] = None,
                    tenant: str = "") -> int:
        rid = self._next_rid
        self._next_rid += 1
        self.requests[rid] = Request(
            rid, np.asarray(prompt), max_new_tokens, tenant=tenant,
            arrival_time=self.now() if arrival_time is None else arrival_time)
        return rid

    def _in_state(self, state: SeqState) -> List[Request]:
        return [r for r in self.requests.values() if r.state is state]

    def _projected_kv_bytes(self, req: Request) -> int:
        """KV bytes this request still has to materialize: its projected
        footprint (prompt + max_new_tokens, capped at max_len; in a window
        pool at most a decode step's pages) minus the pool pages it already
        holds, over the pools."""
        total = min(self.max_len, len(req.prompt) + req.max_new_tokens)
        out = 0
        for c in self.pools:
            have = (int(np.count_nonzero(c.page_table[req.sid]))
                    if req.sid >= 0 else 0)
            out += max(0, c.cap_pages(c.pages_for(total)) - have) * c.page_bytes
        return out

    def _pages_free(self, pages: int, inflight: int) -> bool:
        """Every pool can back ``pages`` of a sequence (as it holds them,
        ``inflight`` tokens at once) above the watermark."""
        return all(c.free_pages() >= c.cap_pages(pages, inflight)
                   + self.watermark_pages for c in self.pools)

    # ----------------------------------------------------------- admission
    def _admission_ok(self, req: Request, running: List[Request]) -> bool:
        need = self.cache.pages_for(len(req.prompt)) + 1  # prompt + 1st decode
        if not self._pages_free(need, self.prefill_chunk):
            return False
        if self.um is not None and running and self.admit_device_fraction > 0:
            demand = self._projected_kv_bytes(req) + sum(
                self._projected_kv_bytes(r) for r in running)
            with SPANS.span("um.charge"):
                free = self.um.device_free()
            if free < self.admit_device_fraction * demand:
                return False
        return True

    def _admit(self) -> int:
        progressed = 0
        running = self._in_state(SeqState.PREFILL) + \
            self._in_state(SeqState.DECODING)
        # preempted sequences resume first, oldest rid first
        for req in sorted(self._in_state(SeqState.PREEMPTED), key=lambda r: r.rid):
            if self.cache.free_slots() == 0:
                break
            need = self.cache.pages_for(int(req.saved["len"]) + 1)
            if not self._pages_free(need, 1):
                break
            self._resume(req)
            running.append(req)
            progressed += 1
        if self._in_state(SeqState.PREEMPTED):
            return progressed  # don't admit fresh work while old work waits
        for req in sorted(self._in_state(SeqState.PENDING), key=lambda r: r.rid):
            if self.cache.free_slots() == 0:
                break
            # drain mode and the post-fault hold apply to fresh work only
            # (a replayed request already has its admit_time)
            fresh = req.admit_time is None
            if fresh and self.draining:
                continue
            if fresh and self._hold_admit > 0:
                self.stats.admission_retries += 1
                continue
            if not self._admission_ok(req, running):
                break
            req.sid = self.cache.new_seq()
            if self.wcache is not None:
                self.wcache.new_seq(req.sid)
            req.state = SeqState.PREFILL
            if req.admit_time is None:
                req.admit_time = self.now()
            self.stats.admitted += 1
            running.append(req)
            progressed += 1
        return progressed

    # ---------------------------------------------------------------- faults
    def start_drain(self) -> None:
        """In-flight requests run to completion; no fresh request is
        admitted (fault-replayed ones still re-enter)."""
        self.draining = True

    def _apply_faults(self) -> None:
        """Deliver the fault plan's due events for this step and expire any
        active lane-degradation / spill-failure window."""
        ev = self.fault_plan.events
        while self._fault_idx < len(ev) and ev[self._fault_idx].step <= self._steps:
            e = ev[self._fault_idx]
            self._fault_idx += 1
            if e.kind == "node_loss":
                self._on_node_loss(e.node)
            elif e.kind == "lane_degrade":
                self.um.set_lane_degradation(
                    (e.nvlink_factor, e.fabric_factor))
                self._degrade_until = e.step + e.duration
            elif e.kind == "spill_fail":
                self.um.set_spill_failure(True)
                self._spill_until = e.step + e.duration
            else:
                raise ValueError(f"unknown fault kind {e.kind!r}")
        if self._degrade_until >= 0:
            if self._steps >= self._degrade_until:
                self.um.set_lane_degradation(None)
                self._degrade_until = -1
            else:
                self.stats.lane_degraded_steps += 1
        if self._spill_until >= 0 and self._steps >= self._spill_until:
            self.um.set_spill_failure(False)
            self._spill_until = -1

    def _on_node_loss(self, node: int) -> None:
        """A serving superchip died: poison its resident pages, shrink the
        TP plan to the survivors and replay every sequence whose KV pages
        are gone; fresh admission backs off (doubling hold)."""
        self.stats.node_losses += 1
        lost = self.um.fail_node(node)
        if self.tp_plan is not None:
            self.tp_plan = self.tp_plan.without_node(node)
            for c in self.pools:
                c.seq_node = self.tp_plan.node_of_seq
        for c in self.pools:
            runs = lost.get(c.alloc.name, [])
            for sid in c.seqs_touching_pages(runs):
                req = next((r for r in self.requests.values()
                            if r.sid == sid and not r.done), None)
                if req is not None:
                    self._replay(req)
        self._hold_admit = max(self._hold_admit, self._backoff)
        self._backoff = min(self._backoff * 2, 64)

    def _replay(self, req: Request) -> None:
        """Drop a sequence whose KV is lost (or unsavable) and requeue it
        for recompute from its prompt (greedy decode gives the same
        tokens)."""
        self.stats.recovered_requests += 1
        self.stats.replayed_tokens += len(req.generated) + req.prefill_pos
        if req.sid >= 0:
            self._release(req.sid)
            req.sid = -1
        req.saved = None
        req.generated = []
        req.prefill_pos = 0
        req.state = SeqState.PENDING
        req.recoveries += 1

    # ---------------------------------------------------------- preemption
    def _node_ctx(self, sid: int):
        """Pin umem ops to the sequence's serving superchip under a TP plan."""
        if self.tp_plan is not None and self.um is not None:
            return self.um.on_node(self.tp_plan.node_of_seq(sid))
        return contextlib.nullcontext()

    def _preempt(self, req: Request) -> None:
        if self.um is not None:
            try:
                with SPANS.span("um.charge"), self._node_ctx(req.sid):
                    for c in self.pools:
                        for band in c.seq_views(req.sid):
                            self.um.demote(band)
            except HostSpillError:
                # the KV cannot be saved host-side: drop it and recompute
                # from the prompt
                self.stats.spill_failures += 1
                self._replay(req)
                return
        req.saved = self.cache.swap_out(req.sid)
        if self.wcache is not None:
            req.saved["window"] = self.wcache.swap_out(req.sid)
        req.sid = -1
        req.state = SeqState.PREEMPTED
        req.preemptions += 1
        self.stats.preempted += 1

    def _resume(self, req: Request) -> None:
        req.sid = self.cache.swap_in(req.saved)
        if self.wcache is not None:
            self.wcache.swap_in(req.saved["window"], req.sid)
        req.saved = None
        # a sequence preempted mid-prefill picks its prompt back up
        req.state = (SeqState.DECODING if req.prefill_pos == len(req.prompt)
                     else SeqState.PREFILL)
        self.stats.resumed += 1
        if self.um is not None:
            self._needs_prefetch.append(req)

    def _prefetch_resumed(self) -> None:
        """Promote resumed sequences' extents ahead of their decode turn."""
        if self.um is None or not self._needs_prefetch:
            self._needs_prefetch = []
            return
        todo, self._needs_prefetch = self._needs_prefetch, []
        for req in todo:
            if req.sid < 0:
                continue
            with SPANS.span("um.charge"):
                bands = [b for c in self.pools for b in c.seq_views(req.sid)]
                if bands:
                    with self._node_ctx(req.sid):
                        self.um.prefetch_async(bands)

    # -------------------------------------------------------------- prefill
    def _prefill_step(self) -> int:
        budget = self.prefill_chunk
        chunks = 0
        for req in sorted(self._in_state(SeqState.PREFILL), key=lambda r: r.rid):
            if budget == 0:
                break
            want = min(budget, len(req.prompt) - req.prefill_pos)
            # clamp the chunk to the pages the pool can back now, keeping
            # one page in reserve per decoding sequence
            reserve = len(self._in_state(SeqState.DECODING))
            afford = min(c.allocated_until(req.sid)
                         + max(0, c.free_pages() - reserve) * c.page_size
                         for c in self.pools) - req.prefill_pos
            chunk = min(want, afford)
            if chunk <= 0:
                continue
            with SPANS.span("serve.prefill", req.rid):
                self._prefill_chunk_run(req, chunk)
            budget -= chunk
            chunks += 1
        return chunks

    def _prefill_chunk_run(self, req: Request, chunk: int) -> None:
        model, pol, dev = self.params, self.policy, self.device
        s = req.prefill_pos
        e = s + chunk
        for c in self.pools:
            c.alloc_range(req.sid, s, e)
        toks = torch.as_tensor(req.prompt[s:e], device=dev)[None, :]
        positions = torch.arange(s, e, dtype=torch.int32, device=dev)
        # keys [lo, e) of each pool: a window layer's chunk attends from
        # the first query's window on
        los = {c: c.live_from(req.sid) for c in self.pools}
        bias = {c: _causal_bias(positions, torch.arange(
            lo, e, dtype=torch.int32, device=dev), c.window)
            for c, lo in los.items()}
        x = model.embed_in(toks, positions)
        for i, blk in enumerate(model.layers):
            c, j = self._kv[i]
            q, k_new, v_new = blk.mixer.project_qkv(blk.norm1(x), positions)
            c.write_at(req.sid, j, k_new[0], v_new[0], s)
            k_full, v_full = c.gather_kv(req.sid, j, e, los[c])
            o = _sdpa(q, k_full[None], v_full[None], bias[c])
            x = x + blk.mixer.out_proj(o, pol)
            x = x + blk.ffn(blk.norm2(x), pol)
        req.prefill_pos = e
        for c in self.pools:
            c.commit_prefill(req.sid, e)
        if self.tp_plan is not None:
            with SPANS.span("um.charge"):
                self.tp_plan.on_prefill(self, chunk)
        self.stats.prefill_chunks += 1
        if e == len(req.prompt):
            logits = model.logits_out(model.final_norm(x[:, -1:]))
            top = torch.argmax(logits[0, -1])
            with SPANS.span("serve.sync"):
                tok = int(top)
            req.generated.append(tok)
            if req.first_token_time is None:
                req.first_token_time = self.now()
            req.state = SeqState.DECODING
            if (len(req.generated) >= req.max_new_tokens
                    or len(req.prompt) + len(req.generated) >= self.max_len - 1):
                self._finish(req)

    # --------------------------------------------------------------- decode
    def _ensure_decode_pages(self, reqs: List[Request]) -> List[Request]:
        """Back every batch member's new-token page, preempting the youngest
        page-holding sequences when the pool runs dry. Only the oldest
        page-holder is shielded, so it always makes progress."""
        reqs = sorted(reqs, key=lambda r: r.rid)
        while True:
            if all(sum(1 for r in reqs if c.missing_pages(
                    r.sid, int(c.lengths[r.sid]) + 1)) <= c.free_pages()
                   for c in self.pools):
                break
            holders = sorted(
                (r for r in self.requests.values() if r.sid >= 0
                 and r.state in (SeqState.DECODING, SeqState.PREFILL)),
                key=lambda r: r.rid)
            if len(holders) <= 1:
                raise RuntimeError(
                    "KV page pool too small for a single sequence: "
                    f"num_pages={self.cache.num_pages}, "
                    f"seq needs page {int(self.cache.lengths[reqs[0].sid]) + 1}")
            victim = holders[-1]  # youngest first: the oldest always runs
            self._preempt(victim)
            if victim in reqs:
                reqs.remove(victim)
            if not reqs:
                return reqs  # whole batch preempted; the oldest is prefilling
        for r in reqs:
            for c in self.pools:
                c.alloc_range(r.sid, 0, int(c.lengths[r.sid]) + 1)
        return reqs

    def _decode_batch(self, reqs: List[Request]) -> None:
        model = self.params
        B = len(reqs)
        sids = [r.sid for r in reqs]
        pos = [int(self.cache.lengths[s]) for s in sids]
        pages, slots = self.cache.token_slots(sids, pos)
        window = ()
        if self.wcache is not None:
            window = self.wcache.token_slots(sids, pos) + (
                self.wcache.page_table[sids],)
            held, every, most = self.wcache.usage()
            self.stats.window_pages_held += held
            self.stats.window_pages_all_keys += every
            self.stats.window_seq_pages_max = max(
                self.stats.window_seq_pages_max, most)
        # the new token attends to itself: lengths + 1
        self._inputs.fill([r.generated[-1] for r in reqs], pos,
                          [p + 1 for p in pos], pages, slots,
                          self.cache.page_table[sids], *window)
        x = self._decode_pass(B)
        logits = model.logits_out(model.final_norm(x))
        top = torch.argmax(logits[:, 0], dim=-1)
        with SPANS.span("serve.sync"):
            nxt = top.cpu().numpy()
        for c in self.pools:
            c.commit_token(sids, pos)
        if self.tp_plan is not None:
            with SPANS.span("um.charge"):
                self.tp_plan.on_decode(self, B)
        self.stats.decode_batches += 1
        self.stats.decode_tokens += B
        for r, t in zip(reqs, nxt):
            r.generated.append(int(t))
            total = len(r.prompt) + len(r.generated)
            if len(r.generated) >= r.max_new_tokens or total >= self.max_len - 1:
                self._finish(r)

    def _decode_layers(self, B: int) -> torch.Tensor:
        """The decode pass of a batch of B sequences, from the embedding
        through the last block's residual add, on the static inputs
        (:class:`DecodeInputs`): the body both run eagerly and captured."""
        model, pol = self.params, self.policy
        cfg, lay = self.cfg, self.layout
        v = self._inputs.views(B)
        posd, ln = v["positions"], v["lengths"]
        # each pool's (write index, page table)
        at = {self.cache: ((v["pages"].long(), v["slots"].long()),
                           v["page_table"])}
        if self.wcache is not None:
            at[self.wcache] = ((v["wpages"].long(), v["wslots"].long()),
                               v["wpage_table"])
        x = model.embed_in(v["tokens"], posd)
        for i, blk in enumerate(model.layers):
            c, j = self._kv[i]
            widx, pt = at[c]
            q, k_new, v_new = blk.mixer.project_qkv(blk.norm1(x), posd)
            # the new token's KV goes straight from the device into the pool
            c.write_token(widx, j, k_new[:, 0], v_new[:, 0])
            o = paged_attention(q.reshape(B, lay.n_q_eff, cfg.head_dim),
                                c.k_pools[j], c.v_pools[j], pt, ln, c.window)
            x = x + blk.mixer.out_proj(o[:, None], pol)
            x = x + blk.ffn(blk.norm2(x), pol)
        return x

    def _decode_pass(self, B: int) -> torch.Tensor:
        """The layer loop of a decode batch of B sequences. On a CUDA card a
        replay of the graph captured for B (no padding: MoE capacity counts
        the tokens routed together), captured at the second batch of B: a
        size seen once runs eagerly, since a ramp of the batch through every
        size (a warm-up, a load's lead-in) would capture each; on the CPU
        the body itself. The output of a replay is the graph's static
        tensor: read it before the next decode pass."""
        if self.device.type != "cuda":
            return self._decode_layers(B)
        if B not in self._graphs:
            self._sightings[B] = seen = self._sightings.get(B, 0) + 1
            if seen < 2:
                return self._decode_layers(B)
            with SPANS.span("serve.capture", B):
                self._capture(B)
        graph, out = self._graphs[B]
        graph.replay()
        self.stats.decode_graph_replays += 1
        return out

    def _capture(self, B: int) -> None:
        """Capture the pass for B as a CUDA graph on a side stream. Before
        the engine's first capture one eager pass runs there: it sets up
        that stream's cuBLAS handle and workspace and loads the kernels
        (its KV writes are the replay's own). All the engine's graphs share
        one memory pool: one replays at a time."""
        first = self._graph_pool is None
        if first:
            self._graph_pool = torch.cuda.graph_pool_handle()
            self._capture_stream = torch.cuda.Stream(self.device)
        cur = torch.cuda.current_stream(self.device)
        side = self._capture_stream
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            if first:
                self._decode_layers(B)
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin(pool=self._graph_pool,
                                capture_error_mode="thread_local")
            try:
                out = self._decode_layers(B)
            finally:
                graph.capture_end()
        cur.wait_stream(side)
        self._graphs[B] = (graph, out)
        self.stats.decode_graph_captures += 1

    def _release(self, sid: int) -> None:
        for c in self.pools:
            c.release(sid)

    def _finish(self, req: Request) -> None:
        req.state = SeqState.DONE
        req.finish_time = self.now()
        if req.sid >= 0:
            self._release(req.sid)
            req.sid = -1

    # ------------------------------------------------------------------ run
    def _in_flight(self) -> bool:
        if self.draining:
            # fresh never-admitted requests will not be admitted
            return any(not r.done and not (r.state is SeqState.PENDING
                                           and r.admit_time is None)
                       for r in self.requests.values())
        return any(not r.done for r in self.requests.values())

    @torch.inference_mode()
    def step(self) -> bool:
        """One engine step: admit/resume, chunked prefill, prefetch, decode.
        Returns True while any request is in flight."""
        with SPANS.span("serve.step", self._steps):
            return self._step()

    def _step(self) -> bool:
        if self.fault_plan is not None:
            self._apply_faults()
        pre0 = self.stats.preempted
        rec0 = self.stats.recovered_requests
        progress = 0
        if self.wcache is not None:
            with SPANS.span("kv.window") as sp:
                sp.tag = released = self.wcache.trim()
            self.stats.window_pages_released += released
        if self._hold_admit > 0:
            # the post-fault backoff window ticking down is forward motion
            self._hold_admit -= 1
            progress += 1
            if self._hold_admit == 0:
                self._backoff = self.admit_backoff_steps
        with SPANS.span("serve.admit") as sp:
            sp.tag = admitted = self._admit()
        progress += admitted
        progress += self._prefill_step()
        decoding = self._in_state(SeqState.DECODING)
        if decoding:
            with SPANS.span("serve.pages") as sp:
                batch = self._ensure_decode_pages(decoding)
                sp.tag = self.stats.preempted - pre0
            if batch:
                self._prefetch_resumed()
                with SPANS.span("serve.decode", len(batch)):
                    self._decode_batch(batch)
                progress += len(batch)
        # a preemption frees pages and a fault replay requeues work for the
        # next step: both count as progress
        progress += self.stats.preempted - pre0
        progress += self.stats.recovered_requests - rec0
        if self.um is not None:
            with SPANS.span("um.charge"):
                self.um.sync()  # apply counter-driven delayed migrations
        self._steps += 1
        in_flight = self._in_flight()
        if in_flight and progress == 0:
            raise RuntimeError(
                "scheduler stalled: KV pool cannot back any in-flight request "
                f"(free_pages={self.cache.free_pages()}, "
                f"states={[r.state.value for r in self.requests.values()]})")
        return in_flight

    def run_to_completion(self, max_steps: int = 10_000) -> Dict[int, List[int]]:
        steps = 0
        while self.step():
            steps += 1
            if steps > max_steps:
                raise RuntimeError("serve did not converge")
        return {rid: r.generated for rid, r in self.requests.items()}
