"""The host planner's native library (``csrc/planner.cpp``), built with g++
at first use and loaded with ctypes (counterpart of the JAX package's
``native``)."""
