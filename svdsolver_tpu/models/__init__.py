"""SVD compute models: the reference's four-implementation ladder in JAX."""
