"""Serving substrate: decode caches and single-token decode steps (the
rwkv6 family so far)."""
