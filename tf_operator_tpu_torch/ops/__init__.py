"""Fused operators of the port: flash attention and blocked cross-entropy."""
