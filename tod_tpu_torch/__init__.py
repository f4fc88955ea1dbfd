"""PyTorch/CUDA port of the JAX package's serving path for one NVIDIA H100.

Module names mirror the JAX package's so each piece can be read beside its JAX
counterpart.  The package imports torch and numpy only; it keeps its own
copies of the configuration, wire types and host pieces it needs.
"""
