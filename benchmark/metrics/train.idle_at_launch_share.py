"""``train.idle_at_launch_share``: the % of the window call's steps whose
previous step had already finished on the card when the host, its batch
staged, was about to launch them: the program's counters
``train/idle_at_launch`` over ``train/steps`` (``tod_tpu_torch/runtime/
profiler.py`` ``SPANS``; one CUDA event a step, queried, never waited on).
Near 100 the host sets the pace.  None where the program keeps no such
counters."""


def read(records: dict):
    if not records["on_card"]:
        return None
    try:
        from tod_tpu_torch.runtime.profiler import SPANS
        steps = SPANS.counter("train/steps")
        idle = SPANS.counter("train/idle_at_launch")
    except (ImportError, AttributeError):
        return None
    return idle / steps * 100 if steps else None
