"""Deterministic, resumable training data (numpy)."""
