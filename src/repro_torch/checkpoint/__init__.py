"""The port's checkpointer and elastic restore (``repro.checkpoint``)."""
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.checkpoint.elastic import elastic_restore, reshard_plan

__all__ = ["Checkpointer", "elastic_restore", "reshard_plan"]
