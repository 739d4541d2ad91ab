"""Validation (the 2D per-volume loop so far)."""
