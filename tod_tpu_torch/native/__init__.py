"""The port's host C++ (counterpart of the JAX package's ``native``), built
with g++ at first use and loaded with ctypes: the host planner
(``csrc/planner.cpp``, ``loader.py``) and the frame ring
(``csrc/framesource.cpp``, ``ring.py``)."""
