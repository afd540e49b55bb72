"""Weight bridge between the JAX package's parameter layouts and the port's modules."""
