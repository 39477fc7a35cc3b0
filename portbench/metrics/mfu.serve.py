"""mfu.serve: the serving window's model FLOPs (portbench/harness/
flops.serve_flops: 2 x the active matmul parameters of every fed
position, the head once per new token, attention over the visible
context) over the window's seconds, as a share of the card's published
bfloat16 peak."""
from portbench.harness.yardstick import PEAK_OPS_PER_S


def read(r):
    if r.get("kind") != "serve_lm":
        return None
    return 100.0 * r["model_flops"] / r["window_s"] / PEAK_OPS_PER_S["bfloat16"]
