"""Kernel class flash_attention: the port's K2f, K2q and K2kv
(tf_operator_tpu_torch/csrc/flash_attention.cu), scalar and wgmma forms.

The work a training step needs of them, per layer and sequence: the
forward's two products (QK^T, PV) and a backward's five (QK^T again,
dO V^T, dS K, P^T dO, dS^T Q) over the visible (query, key) pairs, 2
operations a multiply-add; bytes: the forward reads q, k, v and writes
o and the row statistics, the backward reads q, k, v, o, dO and the
statistics and writes dq, dk, dv (bfloat16 tensors, float32
statistics).  Remat's second forward is not needed work.
"""
from portbench.harness.flops import visible_pairs
from portbench.harness.yardstick import bound_s

SOURCE = "flash_attention"
PATTERNS = ("flash_fwd", "flash_dq", "flash_dkv")


def bound(work: dict):
    """Least seconds of the K2 work of `work` (a train_lm window), or
    None where the work has none."""
    if work.get("kind") != "train_lm" or work.get("attention") != "flash":
        return None
    s = work["shape"]
    seq = work["seq_len"]
    calls = work["batch"] * work["steps"] * s.layers
    pairs = visible_pairs(0, seq, s.window)
    esz = 2
    qo = seq * s.h * s.hd * esz
    kv = seq * s.kv * s.hd * esz
    stat = s.h * seq * 4
    fwd_bytes = 2 * qo + 2 * kv + stat           # q k v in, o lse out
    bwd_bytes = 4 * qo + 4 * kv + 2 * stat       # q k v o dO lse delta; dq dk dv
    return calls * (bound_s(fwd_bytes, 2 * 2 * s.h * s.hd * pairs)
                    + bound_s(bwd_bytes, 5 * 2 * s.h * s.hd * pairs))
