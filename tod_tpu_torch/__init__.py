"""PyTorch/CUDA port of the JAX package's serving path for one NVIDIA H100.

Module names mirror the JAX package's so each piece can be read beside its JAX
counterpart.  The package imports torch and numpy only; it keeps its own
copies of the configuration, wire types and host pieces it needs.
"""

# The headline API, imported on first use: ``import tod_tpu_torch`` imports
# nothing (no torch), as ``import tod_tpu`` does not pull the jax stack.
_LAZY = {
    "PipelineConfig": ("tod_tpu_torch.core.config", "PipelineConfig"),
    "ModelConfig": ("tod_tpu_torch.core.config", "ModelConfig"),
    "GeometryConfig": ("tod_tpu_torch.core.config", "GeometryConfig"),
    "Engine": ("tod_tpu_torch.runtime.engine", "Engine"),
    "PathClient": ("tod_tpu_torch.serve.client", "PathClient"),
    "PathStore": ("tod_tpu_torch.serve.server", "PathStore"),
    "Path": ("tod_tpu_torch.core.types", "Path"),
    "Frame": ("tod_tpu_torch.core.types", "Frame"),
    "Scene": ("tod_tpu_torch.core.types", "Scene"),
    "Detections": ("tod_tpu_torch.core.types", "Detections"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        value = getattr(importlib.import_module(module), attr)
        globals()[name] = value
        return value
    raise AttributeError(f"module 'tod_tpu_torch' has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_LAZY))
