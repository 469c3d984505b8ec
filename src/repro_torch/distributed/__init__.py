"""Multi-device pieces of the port (one-card context only so far) and the
training loop's fault tolerance."""
