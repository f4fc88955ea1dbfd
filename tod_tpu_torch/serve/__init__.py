"""The TCP path server (counterpart of the JAX package's ``serve``)."""
