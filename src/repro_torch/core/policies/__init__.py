"""Pure-Python reference policies of the port (the Clock2Q+ oracle)."""
