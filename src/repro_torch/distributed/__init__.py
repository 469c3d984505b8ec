"""Multi-device pieces of the port (one-card context only so far)."""
