"""Hand-written CUDA kernels of the serving path, each beside its plain
torch version (counterpart of the JAX package's ``kernels``)."""
