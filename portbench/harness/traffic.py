"""The general generator of traffic mixes (portbench/traffic/*.json).

A mix states its sizes as distributions.  Every call of a mix takes the
same set of sizes (the distribution's quantiles at (i + 1/2) / n), and
the run's seed draws their order and the tokens: every seed gives the
same amount of work, in an order of its own.
"""
from __future__ import annotations

import math
import statistics
from typing import List, Tuple

import torch

from portbench.harness.weights import derive


def sizes(spec: dict, n: int) -> List[int]:
    """n sizes at the quantiles (i + 1/2) / n of `spec`: "lognormal"
    (median, sigma), or "uniform" (min to max), clipped to [min, max]."""
    lo, hi = int(spec["min"]), int(spec["max"])
    out = []
    for i in range(n):
        u = (i + 0.5) / n
        if spec["dist"] == "lognormal":
            z = statistics.NormalDist().inv_cdf(u)
            x = float(spec["median"]) * math.exp(float(spec["sigma"]) * z)
        elif spec["dist"] == "uniform":
            x = lo + u * (hi - lo)
        else:
            raise ValueError(f"unknown distribution {spec['dist']!r}")
        out.append(min(hi, max(lo, int(round(x)))))
    return out


def serve_call(traffic: dict, vocab: int, seed: int, call: int
               ) -> Tuple[List[torch.Tensor], List[int]]:
    """One call's prompts (int64 token rows on the CPU) and new-token
    budgets: the mix's sizes in an order drawn from (seed, call), the
    tokens uniform over the vocabulary from (seed, call)."""
    n = int(traffic["requests_per_call"])
    order = torch.Generator().manual_seed(derive(seed, "order", call))
    plen = sizes(traffic["prompt_tokens"], n)
    new = sizes(traffic["new_tokens"], n)
    plen = [plen[i] for i in torch.randperm(n, generator=order).tolist()]
    new = [new[i] for i in torch.randperm(n, generator=order).tolist()]
    g = torch.Generator().manual_seed(derive(seed, "call", call))
    toks = torch.randint(0, vocab, (sum(plen),), generator=g)
    return list(torch.split(toks, plen)), new


def warmup_call(traffic: dict, vocab: int, seed: int
                ) -> Tuple[List[torch.Tensor], List[int]]:
    """The warm-up's prompts: the mix's longest, median and shortest
    sizes (as many as traffic["warmup"]["requests"] asks, spread over
    the sizes), each with the warm-up's budget."""
    w = traffic["warmup"]
    n = int(traffic["requests_per_call"])
    plen = sorted(sizes(traffic["prompt_tokens"], n))
    k = int(w["requests"])
    pick = [plen[round(j * (n - 1) / max(1, k - 1))] for j in range(k)][::-1]
    g = torch.Generator().manual_seed(derive(seed, "warmup"))
    toks = torch.randint(0, vocab, (sum(pick),), generator=g)
    return list(torch.split(toks, pick)), [int(w["new_tokens"])] * k
