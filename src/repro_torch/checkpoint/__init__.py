"""The port's checkpointer (``repro.checkpoint``; its elastic restore
waits for the port's meshes)."""
from repro_torch.checkpoint.checkpointer import Checkpointer

__all__ = ["Checkpointer"]
