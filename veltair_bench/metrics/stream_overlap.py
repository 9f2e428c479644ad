"""stream_overlap.<kind> (x): the engines' streams' busy time summed
over the union of the card's busy time, in the traced slice: 1 when the
streams never overlap.  Read only where two engines or more ran in the
slice.  ``<kind>`` names the cells it is read in; the end-to-end metric
it moves is its ``moves`` in BENCHMARK.json."""


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0 or len(t.stream_busy_s) < 2:
        return None
    return sum(t.stream_busy_s.values()) / t.busy_s
