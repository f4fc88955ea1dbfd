"""Tensor ops of the serving path (counterpart of the JAX package's ``ops``)."""
