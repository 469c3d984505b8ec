"""Synthetic token data of the training path."""
