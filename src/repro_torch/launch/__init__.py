"""Launchers of the port: the LM serving loop."""
