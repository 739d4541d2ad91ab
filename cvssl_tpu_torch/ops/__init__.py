"""Losses, schedules, EMA, dropout and the hand-written kernels."""
