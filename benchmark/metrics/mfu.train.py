"""``mfu.train``: the model FLOPs of the traced window (counted on the
plain reference at the cell's shapes, ``counts/flops.py``) over its
seconds and the card's published bf16 peak, in %."""


def read(records: dict):
    if not records["on_card"] or not records.get("peak_flops") or not records["units"]:
        return None
    return records["flops_per_unit"] * records["units"] / records["window_s"] \
        / records["peak_flops"] * 100
