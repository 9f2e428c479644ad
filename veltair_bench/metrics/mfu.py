"""mfu (%): the model FLOPs of every real token the serve processed
(each prompt token, each decoded token and the output head of each
output token; ``token_flops`` and ``head_flops`` of the tenant's
reference module) over the serve's wall time (``Run.serve_s``: the waits
for due times and the trace's own cost left out) at the card's bf16
peak, 989 TFLOP/s.  Moves tokens_per_s."""
from veltair_bench import roofline


def read(run):
    return 100.0 * run.model_flops() / (run.serve_s * roofline.BF16_FLOPS)
