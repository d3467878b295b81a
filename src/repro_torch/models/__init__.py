"""Models of the port: the dense, ssm and hybrid families."""
from repro_torch.models.model_zoo import ModelFns, build_model  # noqa: F401
