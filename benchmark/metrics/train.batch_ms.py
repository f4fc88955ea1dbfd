"""``train.batch_ms``: the median host ms ``Trainer.train`` spends staging a
batch (``next_batch`` and ``device_batch``: pinning and enqueueing the
copy), the program's span ``train/batch`` (``tod_tpu_torch/runtime/
profiler.py`` ``SPANS``) over the window's call.  None where the program
keeps no such table."""


def read(records: dict):
    if not records["on_card"]:
        return None
    try:
        from tod_tpu_torch.runtime.profiler import SPANS
    except ImportError:
        return None
    stats = SPANS.stats("train/batch")
    return stats["p50_ms"] if stats["n"] else None
