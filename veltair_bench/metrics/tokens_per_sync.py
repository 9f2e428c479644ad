"""tokens_per_sync.<kind> (tokens/sync): tokens each engine decoded per
device-to-host sync in the serve (the engine's ``tokens_per_sync``
counters, taken over the window), averaged over the tenants weighted by
their tokens.  ``<kind>`` names the cells it is read in; the end-to-end
metric it moves is its ``moves`` in BENCHMARK.json."""


def read(run):
    s = run.served
    total = sum(s.tokens.values())
    if not total:
        return None
    return sum(tok * tok / max(s.syncs[name], 1)
               for name, tok in s.tokens.items()) / total
