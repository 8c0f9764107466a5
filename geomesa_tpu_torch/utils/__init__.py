"""Host utilities the port copies from the JAX package (numpy only)."""
