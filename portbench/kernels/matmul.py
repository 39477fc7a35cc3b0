"""Kernel class matmul: cuBLAS and CUTLASS products (no roofline here:
their work is the model FLOPs that mfu.* reads)."""

SOURCE = None
PATTERNS = ("gemm", "nvjet", "xmma", "cutlass", "sm90_", "cublas")


def bound(work: dict):
    return None
