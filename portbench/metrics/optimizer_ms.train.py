"""optimizer_ms.train: device milliseconds a step in the port's phase span
`train_step.optimizer` (TrainState.apply_gradients: the optimizer's
update): its CUDA events' elapsed time (engine/tracing), summed over the
traced window and divided by the window's steps. Nothing unless the run
was traced, the program has phase spans, and the tracer's latest capture
holds exactly the window's `train_step` roots."""
from tf_operator_tpu_torch.engine import tracing

SPAN = "train_step.optimizer"


def read(r):
    if r.get("kind") != "train_lm" or r.get("trace") is None:
        return None
    totals_of = getattr(tracing.get_tracer(), "phase_totals", None)
    if totals_of is None:
        return None
    totals = totals_of()
    steps = r["work"]["steps"]
    root = totals.get("train_step")
    if root is None or root.count != steps or SPAN not in totals:
        return None
    return 1e3 * totals[SPAN].device_s / steps
