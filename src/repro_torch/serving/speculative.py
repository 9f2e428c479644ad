"""Prompt-lookup (n-gram) drafter for speculative decode quanta (a copy of
``repro.serving.speculative``).

No second model: drafts come from the request's own token history
(prompt + generated output) — find the most recent earlier occurrence of
the trailing n-gram and propose the tokens that followed it.  Host-side
numpy over tokens the engine already tracks, so drafting adds no device
sync; the device only sees the fixed-shape (B, d) draft block that
``TorchModel.verify_quantum`` scores.

Repetitive text (templated output, code, retrieval-stuffed prompts)
drafts well; random text drafts nothing, and the engine then falls back
to the plain fused quantum.
"""
from __future__ import annotations

import numpy as np


class TorchNgramDrafter:
    """Drafts up to ``depth`` tokens by longest-suffix prompt lookup.

    For n from ``max_ngram`` down to ``min_ngram``, search the history
    (latest occurrence first) for the trailing n-gram; on a hit, propose
    the ``depth`` tokens that followed it (right-padded by repeating the
    last candidate when the hit sits near the end of history)."""

    def __init__(self, depth: int = 4, max_ngram: int = 3,
                 min_ngram: int = 1):
        if depth < 1:
            raise ValueError("draft depth must be >= 1")
        if min_ngram < 1 or max_ngram < min_ngram:
            raise ValueError("need 1 <= min_ngram <= max_ngram")
        self.depth = int(depth)
        self.max_ngram = int(max_ngram)
        self.min_ngram = int(min_ngram)

    def propose(self, history, depth: int | None = None) -> np.ndarray | None:
        """history: 1-D int sequence (prompt + output so far, last entry
        = the token about to be fed to decode).  Returns a (depth,) int32
        draft, or None when no n-gram recurs."""
        hist = np.asarray(history, np.int32).reshape(-1)
        d = self.depth if depth is None else int(depth)
        n_hist = hist.shape[0]
        for n in range(min(self.max_ngram, n_hist - 1),
                       self.min_ngram - 1, -1):
            suffix = hist[n_hist - n:]
            # windows[i] = hist[i:i+n] over hist[:-1], so a hit at i has a
            # continuation starting at i+n inside the history
            windows = np.lib.stride_tricks.sliding_window_view(
                hist[:-1], n)
            hits = np.flatnonzero((windows == suffix).all(axis=1))
            if hits.size:
                j = int(hits[-1]) + n
                cand = hist[j:j + d]
                if cand.shape[0] < d:
                    cand = np.concatenate(
                        [cand,
                         np.full(d - cand.shape[0], cand[-1], np.int32)])
                return cand.astype(np.int32)
        return None

    # the reference's name, bound without a second ``def``: the static
    # analyzer resolves the reference engine's ``self.drafter.draft`` by
    # the method name being unique
    draft = propose


# The class has its own name and the reference's name is an alias: the
# repository's static analyzer (repro.analysis.callgraph) keys classes by
# bare name, and a second class named NgramDrafter would merge with the
# reference's and shrink the reference's audited hot path.
NgramDrafter = TorchNgramDrafter
