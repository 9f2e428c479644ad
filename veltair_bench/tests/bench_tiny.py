"""A cell at the reduced sizes of the port's CPU tests, for driving the
harness on the CPU: the co-located configuration file with its widths
and depths cut, a short traffic mix, four slots."""
from __future__ import annotations

import copy
import sys

from veltair_bench import cells

# the program under test, as run.py finds it beside the benchmark
if str(cells.ROOT / "src") not in sys.path:
    sys.path.insert(0, str(cells.ROOT / "src"))

TINY = {
    "starcoder2-3b": {"hidden_size": 128, "num_hidden_layers": 2,
                      "num_attention_heads": 4, "num_key_value_heads": 2,
                      "intermediate_size": 256, "vocab_size": 256,
                      "sliding_window": 32},
    "mamba2-780m": {"d_model": 128, "n_layer": 2, "vocab_size": 256,
                    "d_state": 16, "headdim": 32, "chunk_size": 16},
}
MIX = {"arrivals": {"process": "poisson", "rate_per_s": 40.0},
       "prompt_tokens": {"dist": "lognormal", "median": 10, "sigma": 0.7,
                         "min": 3, "max": 40},
       "output_tokens": {"dist": "lognormal", "median": 5, "sigma": 0.6,
                         "min": 2, "max": 12}}


def tiny_cell(*, mix=None, limit: float = 0.05) -> cells.Cell:
    """The co-located cell's configuration cut to TINY sizes, with
    ``limit`` as every tenant's logit-gap limit, under ``mix`` (default
    MIX)."""
    cell = cells.load("colo.batch")
    conf = copy.deepcopy(cell.config)
    conf["engine"] = {"batch_slots": 4, "max_len": 64}
    for t in conf["tenants"]:
        t["config"].update(TINY[t["model"]])
        t["logit_gap_limit"] = limit
    cell.config = conf
    cell.traffic = copy.deepcopy(mix or MIX)
    return cell
