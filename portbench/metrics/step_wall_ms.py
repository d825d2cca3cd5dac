"""Wall milliseconds per step over the measured window: its host-clock
length over the steps completed in it, taken as the end-to-end ``step_ms``
is, for a cell whose steps the host paces and whose wall time spreads too
widely from run to run to hold to a bound."""


def read(tr):
    if not tr.window_steps:
        return None
    return 1e3 * tr.window_s / tr.window_steps
