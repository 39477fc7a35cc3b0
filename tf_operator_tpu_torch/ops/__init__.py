"""Fused operators of the port: flash and ring flash attention, and
blocked cross-entropy."""
