"""``train.idle_at_batch_share``: the % of the window call's steps whose
previous step had already finished on the card when the host came back for
their batch, before staging it: the program's counters
``train/idle_at_batch`` over ``train/steps`` (``tod_tpu_torch/runtime/
profiler.py`` ``SPANS``).  Less than ``train.idle_at_launch_share`` by the
steps in which the card drained while the host staged the batch.  None
where the program keeps no such counters."""


def read(records: dict):
    if not records["on_card"]:
        return None
    try:
        from tod_tpu_torch.runtime.profiler import SPANS
        steps = SPANS.counter("train/steps")
        idle = SPANS.counter("train/idle_at_batch")
    except (ImportError, AttributeError):
        return None
    return idle / steps * 100 if steps else None
