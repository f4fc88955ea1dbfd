"""``train.busy_ms``: device ms an optimiser step: the device's busy time in
the traced window over the steps launched in it (``bench.train_step``
ranges; the backward's kernels are launched from autograd's own thread, so
the time is not split by range)."""


def read(records: dict):
    s = records["spans"].get("bench.train_step")
    if not records["on_card"] or not s or not s["count"]:
        return None
    return records["busy_s"] / s["count"] * 1e3
