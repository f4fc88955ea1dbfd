"""The JAX package's benchmarks on the card (counterpart of
``tod_tpu/bench``): ``configs`` (the 19 numbered configs, those the port can
run and the refusals of the rest), ``headline`` (the repo-root ``bench.py``
line), ``boot`` (boot to first plan), ``profiling`` (a step's device
timeline by kernel and category) and ``mfu`` (the cards' peak rates).

``python -m tod_tpu_torch.bench --config N`` runs one config, ``--all``
every one; each prints one JSON line.  The names below load ``configs`` on
first use, so that ``python -m tod_tpu_torch.bench.boot`` imports torch
inside its own stage clock.
"""

__all__ = ["CONFIGS", "run_config", "transport_rtt_ms"]


def __getattr__(name: str):
    if name in __all__:
        from tod_tpu_torch.bench import configs

        return getattr(configs, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
