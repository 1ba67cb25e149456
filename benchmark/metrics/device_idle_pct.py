"""The share of the traced window's wall time in which no device
operation ran: one minus the union of the kernels', copies' and sets'
intervals over the window, in percent."""


def read(run):
    if run.traced is None:
        return None
    tl = run.traced["timeline"]
    if not tl.device or tl.window_s <= 0:
        return None
    return 100.0 * (1.0 - tl.busy_s() / tl.window_s)
