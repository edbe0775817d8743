"""The served load: the port's ``ServeEngine`` driven from outside, step by
step, with the harness's own wall-clock stamps.

The engine is built as the port's ``TrafficSim`` builds it: the KV pool
under a ``UnifiedMemory()`` (the charge model's default hardware) with
``mem_policy`` "system", ``counter_threshold`` 4 and an admission gate of
0.5 of the projected KV. The benchmark makes the weights
(``weights.make``) and loads them into ``TransformerLM`` without a copy.

``Session.run`` adds each request when it is due (open loop) or when its
client's last request completes (closed loop), calls ``engine.step()`` in
a loop, and after each step reads the public state of every request in
flight (``generated``, ``prefill_pos``, ``admit_time``, ``done``) to learn
what the step did: which prefill chunks it ran, which requests it decoded,
which it admitted and finished. Each new token is stamped with the step's
end. The load starts during set-up: an open loop's lead-in lasts
``lead_in_s`` of arrivals, a closed loop's until every client has a request
decoding. The window opens between two steps and closes at the end of the
first step that ends ``seconds`` after it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from cardbench.lib.traffic import RequestStream

clock = time.perf_counter
CAPTURE_ROWS = 16384  # rows of one host buffer of captured states
CAPTURE_BUFFERS = 4   # buffers made before the load; more as they fill


@dataclass
class Req:
    rid: int
    index: int               # position in the request stream
    client: Optional[int]    # closed loop: the client that sent it
    due: float               # when it was due to be sent (host clock)
    added: float             # when it was handed to the engine
    prompt: np.ndarray
    max_new: int
    admit_t0: Optional[float] = None   # start of the step that admitted it
    tokens: List[float] = field(default_factory=list)  # stamp of each token
    done_t: Optional[float] = None


@dataclass
class Step:
    t0: float
    t1: float
    chunks: list            # (rid, start, end) in the order they ran
    decode: list            # rids of the decode batch, in batch order
    decode_len: list        # keys each of them attends (the new one too)
    stats: dict             # EngineStats delta of the step
    finished: list


def build_engine(cfg_file: dict, state_dict, device):
    """The port's model (weights loaded without a copy) and its engine."""
    from repro_torch.configs.base import ArchConfig
    from repro_torch.core import UnifiedMemory
    from repro_torch.models import TransformerLM
    from repro_torch.models.layers import RunPolicy
    from repro_torch.serve import ServeEngine

    cfg = ArchConfig(**cfg_file["arch"])
    model = TransformerLM(cfg, device="meta")
    model.load_state_dict(state_dict, assign=True, strict=True)
    e = cfg_file["engine"]
    eng = ServeEngine(
        cfg, model, max_seqs=e["max_seqs"], max_len=e["max_len"],
        page_size=e["page_size"], num_pages=e["num_pages"],
        policy=RunPolicy(**cfg_file.get("policy", {})), um=UnifiedMemory(),
        prefill_chunk=e["prefill_chunk"],
        counter_threshold=e["counter_threshold"],
        admit_device_fraction=e["admit_device_fraction"],
        mem_policy=e["mem_policy"], device=device)
    return model, eng


def warm_up(eng, cfg_file: dict, seed: int, decode_sizes=None) -> None:
    """The cell's decode batch sizes (max_seqs down to a few) and prefill
    chunks (whole and partial) once, before any timed request: short
    prompts for a full slot table, then one prompt of two chunks and a
    bit. With ``decode_sizes`` (lo, hi), the traffic file's
    ``warm_decode_sizes``, hi short prompts (at most max_seqs) whose lengths
    make their decode batches a ramp from hi down to lo, two batches of each
    size, before the long prompt runs alone: a serving stack runs the batch
    sizes its load will reach before the load, so that what the program
    does at a size's first batches (on a card: a pass run eagerly, then a
    CUDA graph captured) happens in set-up. The warm-up's requests finish
    before the load starts."""
    e = cfg_file["engine"]
    vocab = cfg_file["arch"]["vocab_size"]
    rng = np.random.default_rng([int(seed) % 2 ** 63, 0xA11])
    n = e["max_seqs"]
    if decode_sizes is None:
        lengths = [2 + i % 8 for i in range(n)]
    else:
        lo, hi = int(decode_sizes[0]), min(int(decode_sizes[1]), n)
        # the j-th request leaves after 2 (j + 1) decode batches (its first
        # token comes from its prefill), the last lo of them together
        lengths = [1 + 2 * (min(j, hi - lo) + 1) for j in range(hi)]
    for k in lengths:
        eng.add_request(rng.integers(2, vocab, 3), k)
    if decode_sizes is not None:
        while eng.step():
            pass
    eng.add_request(rng.integers(2, vocab, 2 * e["prefill_chunk"] + 5), 2)
    while eng.step():
        pass
    if eng.device.type == "cuda":
        torch.cuda.synchronize()


class Session:
    """One run's load on one engine."""

    def __init__(self, eng, traffic: dict, seed: int, vocab: int):
        self.eng = eng
        self.traffic = traffic
        self.stream = iter(RequestStream(traffic, seed, vocab))
        self.reqs: Dict[int, Req] = {}
        self.steps: List[Step] = []
        self.active: Dict[int, Req] = {}
        self.t_load = self.t_open = self.t_close = self.t_end = None
        self.on_step: Optional[Callable] = None  # (session, step) -> None
        self.step_ctx = contextlib.nullcontext
        # the load goes on after the window while this holds (tracing)
        self.hold: Callable[[], bool] = lambda: False
        # final-norm states of the passes that produced tokens: host
        # buffers, the (buffer, row) of each pass, and where each served
        # token's state lies, by (rid, index of the served token)
        self.hidden: Dict[tuple, tuple] = {}
        self._bufs: list = []
        self._buf = self._row = 0  # where the next pass goes
        self._passes: list = []
        self.capture_host_s = 0.0  # host time spent in the hook
        self._hook = None
        # what the window's host did besides the engine (window line)
        self.pages_max = 0        # most KV pool pages in use after a step
        self.gc_s = 0.0           # time in Python's garbage collector
        self._gc_t0 = None

    def capture(self, model) -> None:
        """Keep, from now on until the window closes, the output of the
        model's final norm for every pass that produces tokens (one prefill
        chunk that ends a prompt, or a decode batch): the state the served
        tokens' logits are taken from. A forward hook
        (``nn.Module.register_forward_hook``) copies it into host buffers
        made here (pinned on a card, so the copy does not wait for the
        device); a full buffer is followed by a new one."""
        self._dim = model.final_norm.scale.shape[-1]
        self._dtype = model.final_norm.scale.dtype
        self._pin = model.final_norm.scale.device.type == "cuda"
        for _ in range(CAPTURE_BUFFERS):
            self._grow()

        def hook(mod, args, out):
            t = clock()
            x = out.detach().reshape(-1, out.shape[-1])
            n = x.shape[0]
            if self._row + n > CAPTURE_ROWS:
                self._buf, self._row = self._buf + 1, 0
                if self._buf == len(self._bufs):
                    self._grow()
            self._bufs[self._buf][self._row:self._row + n].copy_(
                x, non_blocking=self._pin)
            self._passes.append((self._buf, self._row, n))
            self._row += n
            self.capture_host_s += clock() - t
        self._hook = model.final_norm.register_forward_hook(hook)

    def _grow(self) -> None:
        self._bufs.append(torch.empty((CAPTURE_ROWS, self._dim),
                                      dtype=self._dtype, pin_memory=self._pin))

    def state(self, key):
        """The captured final-norm state of served token ``key`` (rid,
        index), or None."""
        at = self.hidden.get(key)
        return None if at is None else self._bufs[at[0]][at[1]]

    def release(self) -> None:
        if self._hook is not None:
            self._hook.remove()
            self._hook = None

    def _gc(self, phase, info) -> None:
        if phase == "start":
            self._gc_t0 = clock()
        elif self._gc_t0 is not None:
            if self.t_open is not None and self.t_open <= self._gc_t0 < self.t_close:
                self.gc_s += clock() - self._gc_t0
            self._gc_t0 = None

    # ---------------------------------------------------------------- load
    def _add(self, r, due: float, client=None) -> Req:
        rid = self.eng.add_request(r.prompt, r.max_new)
        q = Req(rid, r.index, client, due, clock(), r.prompt, r.max_new)
        self.reqs[rid] = q
        self.active[rid] = q
        return q

    def _step(self) -> Step:
        eng = self.eng
        before = {rid: (len(eng.requests[rid].generated),
                        eng.requests[rid].prefill_pos,
                        eng.requests[rid].admit_time is not None)
                  for rid in self.active}
        s0 = dataclasses.asdict(eng.stats)
        with self.step_ctx():
            t0 = clock()
            eng.step()
            t1 = clock()
        s1 = dataclasses.asdict(eng.stats)
        chunks, decode, dlen, finished = [], [], [], []
        rows = []  # (rid, served token index) of each row of each pass
        for rid, q in list(self.active.items()):
            r = eng.requests[rid]
            g0, p0, a0 = before[rid]
            g1, p1 = len(r.generated), r.prefill_pos
            if p1 > p0:
                chunks.append((rid, p0, p1))
            if not a0 and r.admit_time is not None:
                q.admit_t0 = t0
            first = p1 == len(r.prompt) and p0 < len(r.prompt)
            if first:
                rows.append([(rid, 0)])
            if g1 - g0 - int(first) == 1:
                decode.append(rid)
                dlen.append(len(r.prompt) + g0 + int(first))
            q.tokens.extend([t1] * (g1 - g0))
            if r.done:
                q.done_t = t1
                finished.append(rid)
                del self.active[rid]
        if self._hook is not None:
            self._assign(rows, decode, dlen)
            if self.t_close is not None and t1 >= self.t_close:
                self.release()  # the judged requests finish by now
        self.pages_max = max(self.pages_max, eng.cache.num_pages - 1
                             - eng.cache.free_pages())
        st = Step(t0, t1, chunks, decode, dlen,
                  {k: s1[k] - s0[k] for k in s1}, finished)
        self.steps.append(st)
        if self.on_step is not None:
            self.on_step(self, st)
        return st

    def _assign(self, rows, decode, dlen) -> None:
        """Pair this step's captured passes with the served tokens they
        gave: the prompt-ending chunks (in the order they ran), then the
        decode batch."""
        if decode:
            rows.append([(rid, n - len(self.reqs[rid].prompt))
                         for rid, n in zip(decode, dlen)])
        passes, self._passes = self._passes, []
        if len(passes) != len(rows) or any(
                n != len(r) for (_, _, n), r in zip(passes, rows)):
            return  # these tokens' states stay uncaptured (check.py)
        for (b, row, _), r in zip(passes, rows):
            for i, key in enumerate(r):
                self.hidden[key] = (b, row + i)

    def run(self, seconds: float, on_open: Optional[Callable] = None) -> None:
        """Lead-in, the window of ``seconds``, and more load after it while
        ``hold()`` (the traced run's second stretch), which belongs to no
        metric. The window ends with the last step that started inside
        it."""
        gc.callbacks.append(self._gc)
        try:
            if self.traffic["loop"] == "open":
                self._run_open(seconds, on_open)
            else:
                self._run_closed(seconds, on_open)
        finally:
            gc.callbacks.remove(self._gc)
        if self.eng.device.type == "cuda":
            torch.cuda.synchronize()
        inside = [s.t1 for s in self.steps if s.t0 < self.t_close]
        self.t_end = max([self.t_close] + inside[-1:])

    def _over(self, t: float) -> bool:
        return self.t_open is not None and t >= self.t_close and not self.hold()

    def _open(self, t: float, seconds: float, on_open) -> None:
        self.t_open, self.t_close = t, t + seconds
        if on_open is not None:
            on_open(self)

    def _run_open(self, seconds: float, on_open) -> None:
        lead = float(self.traffic["lead_in_s"])
        self.t_load = clock()
        nxt = next(self.stream)
        due = self.t_load + nxt.gap
        while True:
            now = clock()
            while due <= now:
                self._add(nxt, due)
                nxt = next(self.stream)
                due += nxt.gap
            if self.t_open is None and now >= self.t_load + lead:
                self._open(now, seconds, on_open)
            if self._over(now):
                return
            if not self.active:  # idle: wait for the next arrival
                until = self.t_load + lead if self.t_open is None else self.t_close
                time.sleep(max(0.0, min(due, max(until, now + 1e-3)) - now))
                continue
            if self._over(self._step().t1):
                return

    def _run_closed(self, seconds: float, on_open) -> None:
        n = int(self.traffic["clients"])
        self.t_load = clock()
        first = [self._add(next(self.stream), self.t_load, c) for c in range(n)]
        while True:
            st = self._step()
            for rid in st.finished:  # each client sends its next request
                self._add(next(self.stream), st.t1, self.reqs[rid].client)
            if self.t_open is None:
                if all(q.tokens for q in first):
                    self._open(st.t1, seconds, on_open)
            elif self._over(st.t1):
                return

    # ------------------------------------------------------------ results
    def window_steps(self) -> List[Step]:
        return [s for s in self.steps if s.t0 >= self.t_open]

    def due_in_window(self) -> List[Req]:
        return [q for q in self.reqs.values()
                if self.t_open <= q.due < self.t_close]
