"""Share of the traced window (``pb.window``) in which no device
operation ran: 1 - the union of its operations' intervals over the
window's length, both from the same trace.  The profiler's own host work
lengthens the window, so this reads above an untraced run's idle share
(the traced run's log gives both windows' lengths)."""


def read(w):
    busy = w.trace.busy_s()
    if busy <= 0 or w.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - busy / w.trace.window_s)
