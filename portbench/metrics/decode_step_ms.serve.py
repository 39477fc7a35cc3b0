"""decode_step_ms.serve: the host-clock time serve_loop spent in its
decode dispatches (models/telemetry.ServeStats.decode_time_s, summed over
the window's calls; a fused prompt segment rides inside) over the
single-token decode steps the model ran (a forward pre-hook counts the
model's calls on one position a lane)."""


def read(r):
    if r.get("kind") != "serve_lm" or not r.get("decode_steps"):
        return None
    return 1e3 * r["decode_time_s"] / r["decode_steps"]
