"""Launchers of the port: the LM serving loop and the training loop."""
