"""Checkpoints: the training path's sharded checkpointer and the serving
stack's warm-restart state (DESIGN.md §12)."""
