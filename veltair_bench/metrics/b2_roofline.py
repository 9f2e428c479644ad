"""b2_roofline (%): the port's B2 kernel (``csrc/flash_attention.cu``) against its
roofline in the traced slice: the least time of every launch the slice
dispatched (``roofline.py``, from the shapes and positions of each
prefill chunk and decode step, per the tenant's reference module) over
the kernel's device time in the trace (``Run.roofline_share``).  Moves
tokens_per_s."""


def read(run):
    return run.roofline_share("b2", "flash_attention_kernel")
