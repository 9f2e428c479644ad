"""host_ms_per_tick.<kind> (ms): the cluster's and runtime's host time a
tick.  The serve's wall time, less the wall inside the engines'
device-facing calls (timed by the wrappers of ``calls.py``), less the
waits for due times and the trace's own cost, over
``ClusterRuntime.ticks``.  ``<kind>`` names the cells it is read in; the
end-to-end metric it moves is its ``moves`` in BENCHMARK.json."""


def read(run):
    s = run.served
    if not s.ticks:
        return None
    return (run.serve_s - s.inside_s) / s.ticks * 1e3
