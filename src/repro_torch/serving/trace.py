"""Seeded heavy-tail arrival traces for the serving benchmark.

LM serving load is famously *not* well modelled by fixed-size batches:
prompt and output lengths follow heavy-tail (approximately lognormal)
distributions, and it is exactly that variance that makes lockstep batching
slow — one p99 prompt holds the whole batch's time-to-first-token hostage.
This module generates the workload both serving modes are measured against:
Poisson arrivals with lognormal prompt/output lengths, fully determined by
a seed so lockstep and continuous runs (and replays across processes)
see byte-identical request streams.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Request:
    """One serving request: token ids to prefill, a generation budget."""

    rid: int
    arrival: float  # seconds since trace start
    prompt: tuple[int, ...]  # token ids
    out_tokens: int  # generation budget (EOS may stop earlier)

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def total_tokens(self) -> int:
        """Cache-lifetime footprint: prompt + every generated token."""
        return len(self.prompt) + self.out_tokens


@dataclass(frozen=True)
class TraceConfig:
    """Knobs for :func:`heavy_tail_trace`; defaults give a tail where the
    p99 prompt is ~8x the median (sigma=0.8 lognormal)."""

    n_requests: int = 64
    seed: int = 0
    rate: float = 32.0  # mean arrivals/s (Poisson)
    prompt_median: int = 24
    prompt_sigma: float = 0.8
    out_median: int = 8
    out_sigma: float = 0.6
    max_prompt: int = 96
    max_output: int = 32
    vocab: int = 256


def heavy_tail_trace(cfg: TraceConfig = TraceConfig(), **overrides) -> list[Request]:
    """Generate the seeded trace. Same (cfg, overrides) -> identical list."""
    if overrides:
        cfg = TraceConfig(**{**cfg.__dict__, **overrides})
    rng = np.random.default_rng(cfg.seed)
    gaps = rng.exponential(1.0 / cfg.rate, cfg.n_requests)
    arrivals = np.cumsum(gaps)
    p_lens = np.clip(
        np.rint(rng.lognormal(np.log(cfg.prompt_median), cfg.prompt_sigma, cfg.n_requests)),
        1, cfg.max_prompt).astype(int)
    o_lens = np.clip(
        np.rint(rng.lognormal(np.log(cfg.out_median), cfg.out_sigma, cfg.n_requests)),
        1, cfg.max_output).astype(int)
    out = []
    for i in range(cfg.n_requests):
        # token 0 is reserved as EOS by the serving engine; draw from [1, vocab)
        prompt = rng.integers(1, cfg.vocab, p_lens[i]).astype(np.int32)
        out.append(Request(i, float(arrivals[i]), tuple(int(t) for t in prompt),
                           int(o_lens[i])))
    return out


def trace_summary(trace: list[Request]) -> dict:
    """Shape of the tail — recorded next to benchmark results."""
    p = np.array([r.prompt_len for r in trace])
    o = np.array([r.out_tokens for r in trace])
    return {
        "n_requests": len(trace),
        "duration_s": round(trace[-1].arrival, 3) if trace else 0.0,
        "prompt_p50": int(np.percentile(p, 50)),
        "prompt_p99": int(np.percentile(p, 99)),
        "output_p50": int(np.percentile(o, 50)),
        "output_p99": int(np.percentile(o, 99)),
        "total_tokens": int(p.sum() + o.sum()),
    }
