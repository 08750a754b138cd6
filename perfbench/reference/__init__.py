"""The benchmark's plain references: imports nothing of the port and no JAX."""
