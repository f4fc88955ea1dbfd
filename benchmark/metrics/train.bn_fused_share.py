"""``train.bn_fused_share``: the % of the window call's training-mode
ConvBN sites whose BatchNorm, ReLU6 and cast ran as the hand-written kernel
pair: the program's counters ``train/bn_fused`` over ``train/bn_sites``
(``tod_tpu_torch/runtime/profiler.py`` ``SPANS``, counted by
``models/mobilenetv2.py`` ``ConvBN``).  None where the program keeps no
such counters."""


def read(records: dict):
    if not records["on_card"]:
        return None
    try:
        from tod_tpu_torch.runtime.profiler import SPANS
        sites = SPANS.counter("train/bn_sites")
        fused = SPANS.counter("train/bn_fused")
    except (ImportError, AttributeError):
        return None
    return fused / sites * 100 if sites else None
