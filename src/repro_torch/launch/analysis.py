"""Trace analysis of the dry-run: per-device FLOPs, bytes, collectives and
peak memory of one rank's work (the port of ``repro.launch.analysis``).

The JAX package reads these from XLA's compiled module; the port traces one
rank's local shards on fake tensors (``launch/steps.py``) and counts:

* FLOPs -- ``torch.utils.flop_counter.FlopCounterMode`` over the rank's
  local shards: per-device work, as XLA's per-partition ``cost_analysis``
  (a count over DTensors would be global).
* bytes -- the sum over aten ops of their operand and output bytes (view
  ops, which move nothing, skipped). Every op is counted unfused, so this
  is an upper bound on the traffic of XLA's fused count.
* collectives -- each ``c10d`` op that ``CommDebugMode`` sees, with its
  output bytes and group size, through the ring wire-byte model below.
* memory -- the peak bytes of the storages the trace allocates and that
  are still alive (one weak reference each; ``MemTracker`` keeps the same
  count at several times the tracing cost), on top of the arguments
  (params, optimizer state, batch or cache) that exist before it.

Wire-byte model per device (ring algorithms, n = collective group size):
  all-reduce       2*(n-1)/n * bytes
  all-gather       (n-1)/n   * output bytes
  reduce-scatter   (n-1)     * output (shard) bytes
  all-to-all       (n-1)/n   * bytes
  collective-permute         bytes
"""
from __future__ import annotations

import weakref
from typing import Any, Dict

import torch
import torch.distributed as dist
from torch.distributed.tensor.debug import CommDebugMode
from torch.utils._python_dispatch import TorchDispatchMode

# c10d ops -> the collective they are, in the JAX package's names
_C10D_OPS = {
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute",
}

_TRANSCENDENTAL = {"exp", "exp_", "log", "log_", "tanh", "sigmoid", "sin",
                   "cos", "rsqrt", "sqrt", "sqrt_", "erf", "pow", "softplus",
                   "_softmax", "_log_softmax", "gelu", "silu"}


def wire_bytes(op: str, n: int, nbytes: float) -> float:
    """Bytes a device puts on the wire for one collective of ``nbytes``
    (output bytes; the shard for reduce-scatter) over ``n`` ranks."""
    n = max(2, n)
    if op == "all-reduce":
        return 2.0 * (n - 1) / n * nbytes
    if op in ("all-gather", "all-to-all"):
        return (n - 1) / n * nbytes
    if op == "reduce-scatter":
        return float(n - 1) * nbytes
    if op == "collective-permute":
        return float(nbytes)
    raise ValueError(f"unknown collective {op!r}")


def tensor_bytes(x) -> int:
    """Bytes of the tensors in ``x`` (a tensor, or lists, tuples and dicts
    of them)."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return sum(tensor_bytes(t) for t in x)
    return 0


class CollectiveBytes(CommDebugMode):
    """``CommDebugMode`` that also keeps each collective's op, output bytes
    and group size."""

    def __init__(self):
        super().__init__()
        self.records = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if getattr(func, "namespace", "") == "c10d":
            op = _C10D_OPS.get(func._overloadpacket.__name__)
            if op is not None:
                group = next(a for a in args if isinstance(a, torch.ScriptObject)
                             and a._type().qualified_name().endswith(".ProcessGroup"))
                n = dist.ProcessGroup.unbox(group).size()
                self.records.append((op, n, tensor_bytes(args[0])))
        return super().__torch_dispatch__(func, types, args, kwargs)

    def summary(self) -> Dict[str, Any]:
        """Per-device bytes by op type, as ``parse_collectives`` gives them."""
        out: Dict[str, Dict[str, float]] = {}
        total = 0.0
        for op, n, nbytes in self.records:
            if n < 2:
                continue
            w = wire_bytes(op, n, nbytes)
            d = out.setdefault(op, {"count": 0, "tensor_bytes": 0.0,
                                    "wire_bytes": 0.0})
            d["count"] += 1
            d["tensor_bytes"] += nbytes
            d["wire_bytes"] += w
            total += w
        return {"by_op": out, "wire_bytes": total}


class OpBytes(TorchDispatchMode):
    """Sums the operand and output bytes of every aten op (views skipped)
    and the output elements of transcendental ops, and keeps the peak of
    the live bytes of the storages the ops allocate (``peak``)."""

    def __init__(self, live=None):
        super().__init__()
        self.bytes = 0
        self.transcendentals = 0
        self.live = live if live is not None else LiveBytes()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = out if isinstance(out, (list, tuple)) else [out]
        for t in outs:
            if isinstance(t, torch.Tensor):
                self.live.track(t)
        if getattr(func, "namespace", "") == "aten" and not func.is_view:
            self.bytes += (tensor_bytes(list(args))
                           + tensor_bytes(list(kwargs.values()))
                           + tensor_bytes(outs))
            if (func._overloadpacket.__name__ in _TRANSCENDENTAL
                    and isinstance(out, torch.Tensor)):
                self.transcendentals += out.numel()
        return out


class LiveBytes:
    """Bytes of the tracked storages still alive, and their peak."""

    def __init__(self):
        self.cur = 0
        self.peak = 0
        self._seen: Dict[int, int] = {}

    def track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._seen:
            return
        n = st.nbytes()
        self._seen[key] = n
        self.cur += n
        self.peak = max(self.peak, self.cur)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.cur -= self._seen.pop(key, 0)


def cost_summary(flops: float, op_bytes: OpBytes) -> Dict[str, float]:
    return {"flops": float(flops),
            "bytes_accessed": float(op_bytes.bytes),
            "bytes_accessed_kind": "unfused aten operands + outputs (upper bound)",
            "transcendentals": float(op_bytes.transcendentals)}


def memory_summary(argument_bytes: int, peak_live: int,
                   output_bytes: int) -> Dict[str, float]:
    """The reference's memory keys from one rank's trace: the arguments, the
    peak of what the trace allocated (``temp``, outputs alive at the peak
    included) and the outputs; the peak estimate is arguments + peak."""
    return {"argument_size_in_bytes": float(argument_bytes),
            "output_size_in_bytes": float(output_bytes),
            "temp_size_in_bytes": float(peak_live),
            "alias_size_in_bytes": 0.0,
            "generated_code_size_in_bytes": 0.0,
            "peak_bytes_est": float(argument_bytes + peak_live)}


# ---------------------------------------------------------------------------
# Analytic FLOPs (the MODEL_FLOPS term; cross-checks the traced count)
# ---------------------------------------------------------------------------


def model_flops(cfg, shape) -> float:
    """6*N_active*D for train, 2*N_active*D for serve (+ attention terms)."""
    n_active = cfg.active_param_count()
    B, S = shape.global_batch, shape.seq_len
    tokens = B * S
    # attention context flops (per token: 2*2*ctx*H*hd fwd)
    attn = 0.0
    if cfg.mixer != "rwkv6":
        kinds = cfg.layer_kinds()
        for k in kinds:
            if k == "attention":
                ctx = S / 2
            elif k == "local":
                ctx = min(cfg.local_window, S / 2)
            else:
                continue
            attn += 4.0 * tokens * ctx * cfg.num_heads * cfg.head_dim
    if shape.kind == "train":
        return 6.0 * n_active * tokens + 3.0 * attn
    if shape.kind == "prefill":
        return 2.0 * n_active * tokens + attn
    # decode: one token per sequence; context = full cache
    dec_tokens = B
    attn_dec = 0.0
    if cfg.mixer != "rwkv6":
        for k in cfg.layer_kinds():
            ctx = S if k == "attention" else min(cfg.local_window, S)
            if k in ("attention", "local"):
                attn_dec += 4.0 * dec_tokens * ctx * cfg.num_heads * cfg.head_dim
    return 2.0 * n_active * dec_tokens + attn_dec
