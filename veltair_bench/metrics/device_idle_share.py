"""device_idle_share.<kind> (%): the share of the traced slice in which
no operation ran on the card: 1 - the union of its device intervals over
the slice.  ``<kind>`` names the cells it is read in; the end-to-end
metric it moves is its ``moves`` in BENCHMARK.json."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
