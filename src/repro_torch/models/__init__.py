from .common import ArchConfig, init_params, param_template
from .lm import Model

__all__ = ["ArchConfig", "Model", "init_params", "param_template"]
