"""Warm-restart checkpoints of the serving stack (DESIGN.md §12)."""
