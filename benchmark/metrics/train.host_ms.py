"""``train.host_ms``: the median host ms of one iteration of
``Trainer.train``'s loop, the program's span ``train/step``
(``tod_tpu_torch/runtime/profiler.py`` ``SPANS``), read in the run's own
process once the cell's run has returned.  ``Trainer.train`` clears its
``train/`` names at entry, so the table describes the window's call: its
untraced steps and the few the profiler slowed.  None where the program
keeps no such table."""


def read(records: dict):
    if not records["on_card"]:
        return None
    try:
        from tod_tpu_torch.runtime.profiler import SPANS
    except ImportError:
        return None
    stats = SPANS.stats("train/step")
    return stats["p50_ms"] if stats["n"] else None
