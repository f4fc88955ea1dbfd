"""``idle_share.train``: the share of the traced window in which no
activity ran on the device, in %."""


def read(records: dict):
    if not records["on_card"] or records["window_s"] <= 0:
        return None
    return (1.0 - records["busy_s"] / records["window_s"]) * 100
