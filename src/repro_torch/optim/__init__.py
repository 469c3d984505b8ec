"""Optimiser and gradient compression of the training path."""
