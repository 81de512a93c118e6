"""The share of the profiled slice's wall in which no operation ran on
the device, %."""


def read(run):
    sl = run["window"].slice
    if sl is None or not sl.window_us or not sl.busy_us:
        return None
    return 100.0 * (1.0 - sl.busy_us / sl.window_us)
