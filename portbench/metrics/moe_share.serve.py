"""moe_share.serve: the device time of the operations inside the traced
run's record_function ranges around parallel/ep.grouped_moe (the sparse
experts: routing, grouping, the int8 experts' dequantization and
products) over the traced window's busy device time."""


def read(r):
    t = r.get("trace")
    if r.get("kind") != "serve_lm" or t is None or not t.busy_s:
        return None
    inside = t.by_range.get("grouped_moe")
    if not inside:
        return None
    return 100.0 * inside / t.busy_s
