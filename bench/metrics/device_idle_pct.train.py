"""Share of the profiled round's wall in which no device operation ran:
100 x (1 - the union of the device intervals / the window). The round is
traced with the device's activity alone, so the host runs at its own pace."""


def read(trace):
    if trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
