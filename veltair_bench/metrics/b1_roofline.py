"""b1_roofline (%): the port's B1 kernel (``csrc/block_matmul.cu``) against its
roofline in the traced slice: the least time of every launch the slice
dispatched (``roofline.py``, from the shapes and positions of each
prefill chunk and decode step, per the tenant's reference module) over
the kernel's device time in the trace (``Run.roofline_share``).  Moves
tokens_per_s."""


def read(run):
    return run.roofline_share("b1", "block_matmul_kernel")
