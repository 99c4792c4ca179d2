"""Benchmark metrics (numpy)."""
