"""Atomic, rotated npz + json checkpoints in the reference's format."""
