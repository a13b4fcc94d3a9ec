"""Observability: the process metrics registry."""
