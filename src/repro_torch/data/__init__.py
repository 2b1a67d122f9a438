"""Deterministic synthetic corpora and DSM batch streams (numpy)."""
