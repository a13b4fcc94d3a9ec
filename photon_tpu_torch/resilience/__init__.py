"""Durable I/O primitives (port of photon_tpu.resilience, atomic publish only)."""
