"""capture_s (s): the seconds the engines' version caches spent
capturing CUDA graphs in set-up (``version_cache.capture_s``, summed over
the engines).  Moves setup_s."""


def read(run):
    return sum(run.capture_s.values())
