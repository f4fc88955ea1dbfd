"""Hand-written CUDA kernels of the serving path and of the training
ConvBN (``bn_train``), each beside its plain torch version (counterpart of
the JAX package's ``kernels``).

Each serving wrapper registers its kernel as a ``torch.library`` custom op
(``tod::*``) and calls the op only while ``torch.export`` traces it.  An
eager call launches directly: the dispatcher would add about 40 us of host
time a call, measured on an H100 host (``tools/serve_step_ab.py --via-op``,
PERF.md), and the serve step is host-bound."""
