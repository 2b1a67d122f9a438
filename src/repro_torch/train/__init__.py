"""Training harness of the port."""
