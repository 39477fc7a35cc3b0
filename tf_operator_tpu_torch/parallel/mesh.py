"""Mesh sizing (the port of tf_operator_tpu/parallel/mesh.py's
`local_mesh_axes`; the rest of that module, the device mesh and its
sharding rules, is not ported yet)."""
from __future__ import annotations

import math
from typing import Dict


def local_mesh_axes(n_devices: int, prefer_tp: int = 1) -> Dict[str, int]:
    """A reasonable default mesh for n devices: tp as requested (clamped to
    a divisor), rest data parallel."""
    tp = math.gcd(prefer_tp, n_devices) if prefer_tp > 1 else 1
    return {"tp": tp, "dp": n_devices // tp}
