"""Helpers (port of terastructure_tpu/utils)."""
