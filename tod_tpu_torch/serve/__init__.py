"""The TCP path server and its client (counterpart of the JAX package's
``serve``)."""

from tod_tpu_torch.serve.server import PathServer, PathStore  # noqa: F401
from tod_tpu_torch.serve.client import AuthError, PathClient  # noqa: F401
