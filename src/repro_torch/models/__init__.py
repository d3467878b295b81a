"""Models of the port (dense family in this slice)."""
from repro_torch.models.model_zoo import ModelFns, build_model  # noqa: F401
