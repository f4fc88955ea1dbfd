"""Depth + class map -> birdseye scene fusion (counterpart of the JAX package's ``geometry``)."""
