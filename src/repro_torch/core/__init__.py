"""core layer of the PyTorch port (see the package docstring): the
reference's exports (``repro.core``), under the same names, plus the
card's hardware spec ``H100_SXM`` beside the reference's ``CPU_3990X``
and ``TPU_V5E_POD`` model constants."""
from repro_torch.core.cost_model import (CPU_3990X, H100_SXM, TPU_V5E_POD,
                                         CodeVersion, GemmLayer,
                                         HardwareSpec, Interference, latency,
                                         units_required)
from repro_torch.core.multiversion import (VersionSet, compile_layer,
                                           compile_model)
from repro_torch.core.layer_block import (LayerBlock, ModelPlan, form_blocks,
                                          make_model_plan, next_block)
from repro_torch.core.scheduler import (ChunkPlan, FixedBlockPolicy,
                                        LayerWisePolicy, ModelWisePolicy,
                                        Policy, PremaPolicy, TaskState,
                                        VeltairPolicy)
from repro_torch.core.allocator import UnitPool
from repro_torch.core.interference import (LinearProxy, calibrate_proxy,
                                           pca_variance, pressure_on)

__all__ = [
    "CPU_3990X", "TPU_V5E_POD", "CodeVersion", "GemmLayer", "HardwareSpec",
    "Interference", "latency", "units_required", "VersionSet",
    "compile_layer", "compile_model", "LayerBlock", "ModelPlan",
    "form_blocks", "make_model_plan", "next_block", "ChunkPlan",
    "FixedBlockPolicy", "LayerWisePolicy", "ModelWisePolicy", "Policy",
    "PremaPolicy", "TaskState", "VeltairPolicy", "UnitPool", "LinearProxy",
    "calibrate_proxy", "pca_variance", "pressure_on",
    "H100_SXM",
]
