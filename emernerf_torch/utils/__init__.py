"""Framework-free helpers of the port (copies of the JAX package's)."""
