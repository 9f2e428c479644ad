"""models layer of the PyTorch port (see the package docstring): the
reference's exports (``repro.models``), under the same names."""
from repro_torch.models.model import Model, build_model
from repro_torch.models.params import (ParamSpec, abstract_params,
                                       init_params, param_bytes, param_count)
from repro_torch.models.frontends import (abstract_inputs, input_specs,
                                          make_sample_inputs)

__all__ = [
    "Model", "build_model", "ParamSpec", "abstract_params", "init_params",
    "param_bytes", "param_count", "abstract_inputs", "input_specs",
    "make_sample_inputs",
]
