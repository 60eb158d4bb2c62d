"""The device's idle share of the traced window: one minus the union of
the intervals in which any operation ran on the device (kernels,
copies, sets) over the window's length, in percent."""


def read(run):
    tr = run["trace"]
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
