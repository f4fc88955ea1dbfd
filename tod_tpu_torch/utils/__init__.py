"""Image files and resampling without PIL (counterpart of the JAX package's ``utils``)."""
