"""Frame sources and the serving engine (counterpart of the JAX package's ``runtime``)."""
