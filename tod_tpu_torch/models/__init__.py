"""The YOLACT model family in torch (counterpart of the JAX package's ``models``).

Submodule attribute names repeat the Flax module names (``MobileNetV2_0``,
``ConvBN_0``, ``lat3`` ...) so that ``core.weights.carry_across`` maps the
Flax tree onto the state dict path for path.
"""
