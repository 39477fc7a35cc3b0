"""mfu.train: the training window's model FLOPs (portbench/harness/
flops.train_flops: 6 x the matmul parameters a token runs through, the
head over the labelled positions, attention's products over each
query's visible keys; remat's recomputation not counted) over the
window's seconds, as a share of the card's published bfloat16 peak."""
from portbench.harness.yardstick import PEAK_OPS_PER_S


def read(r):
    if r.get("kind") != "train_lm":
        return None
    return 100.0 * r["model_flops"] / r["window_s"] / PEAK_OPS_PER_S["bfloat16"]
