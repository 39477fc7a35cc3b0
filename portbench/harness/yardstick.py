"""The yardstick: the card's published peaks and the least time a piece
of work could take on it.

Frozen copies of chip_smoke.py's sound pieces, kept here so that a
change to the program cannot move them: HBM_BYTES_PER_S and
PEAK_OPS_PER_S (chip_smoke.py's constants), `bound_s` (the larger of bytes over bandwidth and operations
over the peak, as chip_smoke's bound_ms, flash_bound_ms and
window_bound_ms take it), and `device_line` (chip_smoke.device_line).
The byte and operation counts of each kernel class live in
portbench/kernels/<class>.py.
"""
from __future__ import annotations

import subprocess

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, dense (no sparsity) rates
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}


def bound_s(nbytes: float, flops: float, dtype: str = "bfloat16") -> float:
    """The least seconds the card could take: bytes over HBM bandwidth or
    operations over the dtype's peak, whichever is larger."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_OPS_PER_S[dtype])


def device_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"
    return out.strip().splitlines()[0]
