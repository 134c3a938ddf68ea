"""device_idle_pct: the share of the traced window in which no operation ran
on the device (the union of the profiler's device intervals), in percent."""


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0 or not len(tr.dev_start):
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
