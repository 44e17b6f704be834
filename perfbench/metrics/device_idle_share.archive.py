"""device_idle_share.archive: share of the traced window in which neither a
kernel nor a copy ran on the card, % (torch.profiler)."""


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0 or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
