"""device_idle_pct.train: the share of the profiled block of steps in
which no kernel, copy or fill ran on the card."""


def read(record):
    prof = record.get("profile")
    if record.get("family") != "train" or prof is None or prof.window_s <= 0:
        return None
    return 100.0 * (1.0 - prof.busy_s / prof.window_s)
