"""Parallel layouts of the port: mesh sizing and the sequence ring."""
