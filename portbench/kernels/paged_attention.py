"""Kernel class paged_attention: the port's K1
(tf_operator_tpu_torch/csrc/paged_attention.cu: the scalar kernel, the
tensor-core kernel and the merge pass of its split decode).

The work serving needs of it, per layer: each prompt segment reads the
keys and values its queries see once and computes QK^T and PV over its
visible (query, key) pairs; each decode step reads, per lane, the keys
and values its one query sees.  Keys and values in bfloat16 pools (an
int8 pool's K1q needs bytes of its own, for the cell that serves one),
q read and the output written in bfloat16.  A segment is a call of its
own, so its bound is its own; the decode steps' bound is taken over all
of them together (the larger of their summed bytes and summed
operations), which no set of calls can beat.
"""
from portbench.harness.flops import visible_pairs
from portbench.harness.yardstick import bound_s

SOURCE = "paged_attention"
PATTERNS = ("paged_attention", "paged_mma", "paged_merge")


def _keys(start: int, end: int, window) -> int:
    return end - (0 if window is None else max(0, end - window))


def bound(work: dict):
    if work.get("kind") != "serve_lm":
        return None
    s = work["shape"]
    per_pos = 2 * s.kv * s.hd * 2
    qo = 2 * s.h * s.hd * 2
    ops_pair = 2 * 2 * s.h * s.hd
    chunk = work["prefill_chunk"]
    total = 0.0
    dec_bytes = dec_ops = 0
    for p, n in work["requests"]:
        step = chunk or p
        for a in range(0, p, step):
            b = min(p, a + step)
            total += bound_s(_keys(a, b, s.window) * per_pos + (b - a) * qo,
                             ops_pair * visible_pairs(a, b, s.window))
        for pos in range(p, p + n - 1):
            k = _keys(pos, pos + 1, s.window)
            dec_bytes += k * per_pos + qo
            dec_ops += ops_pair * k
    return s.layers * (total + bound_s(dec_bytes, dec_ops))
