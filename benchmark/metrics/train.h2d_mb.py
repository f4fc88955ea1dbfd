"""``train.h2d_mb``: the MB ``Trainer.train`` hands to the card a step (the
batch's tensors after ``device_batch``), the program's counters
``train/h2d_bytes`` over ``train/steps`` (``tod_tpu_torch/runtime/
profiler.py`` ``SPANS``) over the window's call.  None where the program
keeps no such counters."""


def read(records: dict):
    if not records["on_card"]:
        return None
    try:
        from tod_tpu_torch.runtime.profiler import SPANS
        steps = SPANS.counter("train/steps")
        nbytes = SPANS.counter("train/h2d_bytes")
    except (ImportError, AttributeError):
        return None
    return nbytes / steps / 1e6 if steps else None
