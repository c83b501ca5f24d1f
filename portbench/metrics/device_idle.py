"""device_idle: the share of the traced window, in %, in which the
profiler shows no kernel, copy or fill running on the card."""


def read(run):
    tr = run.trace
    if tr is None or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
