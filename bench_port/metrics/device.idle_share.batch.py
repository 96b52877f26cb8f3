"""device.idle_share.batch: the share of the traced window in which no
kernel, copy or fill ran on the card, %, in a batch cell."""


def read(rec):
    if rec.trace is None or rec.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s / rec.trace.window_s)
