"""Seeded request streams for the benchmark's traffic mixes.

``ArrivalProcess`` and ``LengthDist`` are frozen copies of the generators in
``src/repro_torch/serve/traffic.py``, kept here so
that the yardstick does not move when the program does. What is added here:

* ``quantiles``: the same distributions drawn as a fixed set of ``n``
  stratified values (the quantiles at (i + 0.5) / n). A traffic file with
  ``"draw": "stratified"`` gives every seed the same sizes and gaps in each
  block of ``block`` requests, in an order the seed shuffles, so two seeds
  do the same work and differ only in its order and in the token ids.
* ``RequestStream``: the endless, blockwise stream of requests (prompt ids,
  output length, and for an open loop the gap before it) of one mix.

A traffic file is JSON with ``loop`` ("open" or "closed"), ``prompt`` and
``output`` (``LengthDist`` fields), ``draw``, ``block``, and for an open
loop ``arrival`` (``ArrivalProcess`` fields) and ``lead_in_s``, for a closed
loop ``clients``.
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from statistics import NormalDist
from typing import Iterator, Optional, Tuple

import numpy as np


# ------------------------------------------------------------ frozen copies
@dataclass(frozen=True)
class ArrivalProcess:
    """Seeded arrival-time generator (seconds).

    kind='poisson': exponential inter-arrivals at ``rate`` req/s.
    kind='bursty' : burst *starts* are Poisson at ``rate / burst_size``;
                    each burst delivers ``burst_size`` requests spread by
                    exponential jitter at scale ``burst_spread``.
    kind='uniform': deterministic spacing ``1 / rate``.
    """
    kind: str = "poisson"
    rate: float = 100.0
    burst_size: int = 8
    burst_spread: float = 1e-6

    def times(self, rng: np.random.Generator, n: int) -> np.ndarray:
        if self.kind == "poisson":
            return np.cumsum(rng.exponential(1.0 / self.rate, n))
        if self.kind == "uniform":
            return (1.0 + np.arange(n, dtype=np.float64)) / self.rate
        if self.kind == "bursty":
            nb = -(-n // self.burst_size)
            starts = np.cumsum(
                rng.exponential(self.burst_size / self.rate, nb))
            jitter = np.cumsum(
                rng.exponential(self.burst_spread, (nb, self.burst_size)),
                axis=1)
            return (starts[:, None] + jitter).reshape(-1)[:n]
        raise ValueError(f"unknown arrival kind {self.kind!r}")

    def gap_quantiles(self, n: int) -> np.ndarray:
        """The n stratified inter-arrival gaps of a Poisson or uniform
        process (their sum is n / rate up to the quantile grid)."""
        u = (np.arange(n) + 0.5) / n
        if self.kind == "poisson":
            return -np.log1p(-u) / self.rate
        if self.kind == "uniform":
            return np.full(n, 1.0 / self.rate)
        raise ValueError(f"no stratified draw for arrival kind {self.kind!r}")


@dataclass(frozen=True)
class LengthDist:
    """Heavy-tail (or fixed) integer length sampler, clipped to [lo, hi].

    kind='lognormal': mean ``mean`` (pre-clip), shape ``sigma``.
    kind='pareto'   : bounded Pareto starting at ``lo``, tail ``alpha``.
    kind='fixed'    : every sample is ``mean``.
    """
    kind: str = "lognormal"
    lo: int = 1
    hi: int = 64
    mean: float = 16.0
    sigma: float = 0.8
    alpha: float = 1.5

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        if self.kind == "lognormal":
            mu = np.log(self.mean) - 0.5 * self.sigma ** 2
            raw = rng.lognormal(mu, self.sigma, n)
        elif self.kind == "pareto":
            raw = self.lo * (1.0 + rng.pareto(self.alpha, n))
        elif self.kind == "fixed":
            raw = np.full(n, float(self.mean))
        else:
            raise ValueError(f"unknown length kind {self.kind!r}")
        return np.clip(np.rint(raw).astype(np.int64), self.lo, self.hi)

    def quantiles(self, n: int) -> np.ndarray:
        """The n stratified lengths: the distribution's quantiles at
        (i + 0.5) / n, rounded and clipped as ``sample`` does."""
        u = (np.arange(n) + 0.5) / n
        if self.kind == "lognormal":
            mu = np.log(self.mean) - 0.5 * self.sigma ** 2
            z = np.array([NormalDist().inv_cdf(float(x)) for x in u])
            raw = np.exp(mu + self.sigma * z)
        elif self.kind == "pareto":
            raw = self.lo * (1.0 - u) ** (-1.0 / self.alpha)
        elif self.kind == "fixed":
            raw = np.full(n, float(self.mean))
        else:
            raise ValueError(f"unknown length kind {self.kind!r}")
        return np.clip(np.rint(raw).astype(np.int64), self.lo, self.hi)


def _make(cls, spec: Optional[dict]):
    names = {f.name for f in fields(cls)}
    unknown = set(spec or {}) - names
    if unknown:
        raise ValueError(f"{cls.__name__} has no field(s) {sorted(unknown)}")
    return cls(**(spec or {}))


# ------------------------------------------------------------------ stream
@dataclass(frozen=True)
class Request:
    index: int            # position in the stream
    gap: float            # seconds after the previous one (open loop)
    prompt: np.ndarray    # token ids
    max_new: int          # tokens to generate


class RequestStream:
    """The requests of one traffic mix for one seed, in blocks of
    ``block``. Token ids are drawn in [2, vocab) as the port's
    ``TrafficSim`` draws them."""

    def __init__(self, traffic: dict, seed: int, vocab: int):
        self.loop = traffic["loop"]
        if self.loop not in ("open", "closed"):
            raise ValueError(f"loop must be open or closed, not {self.loop!r}")
        self.prompt = _make(LengthDist, traffic["prompt"])
        self.output = _make(LengthDist, traffic["output"])
        self.arrival = (_make(ArrivalProcess, traffic["arrival"])
                        if self.loop == "open" else None)
        self.draw = traffic.get("draw", "stratified")
        if self.draw not in ("stratified", "iid"):
            raise ValueError(f"draw must be stratified or iid, not {self.draw!r}")
        self.block = int(traffic.get("block", 64))
        self.vocab = vocab
        self.rng = np.random.default_rng([int(seed) % 2 ** 63, 0x5E7])
        if self.draw == "stratified":
            self._p_q = self.prompt.quantiles(self.block)
            self._o_q = self.output.quantiles(self.block)
            self._g_q = (self.arrival.gap_quantiles(self.block)
                         if self.arrival is not None else None)

    def _block(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        n, rng = self.block, self.rng
        if self.draw == "stratified":
            plen = rng.permutation(self._p_q)
            olen = rng.permutation(self._o_q)
            gaps = (rng.permutation(self._g_q) if self._g_q is not None
                    else np.zeros(n))
        else:
            plen = self.prompt.sample(rng, n)
            olen = self.output.sample(rng, n)
            gaps = (np.diff(self.arrival.times(rng, n), prepend=0.0)
                    if self.arrival is not None else np.zeros(n))
        return plen, olen, gaps

    def __iter__(self) -> Iterator[Request]:
        i = 0
        while True:
            plen, olen, gaps = self._block()
            for j in range(self.block):
                prompt = self.rng.integers(2, self.vocab, int(plen[j]))
                yield Request(i, float(gaps[j]), prompt, int(olen[j]))
                i += 1
