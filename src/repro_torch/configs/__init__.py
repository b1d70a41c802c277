"""Model configurations of the LM substrate (copies of ``repro.configs``)."""
from repro_torch.configs.base import (ARCH_NAMES, INPUT_SHAPES,  # noqa: F401
                                      InputShape, ModelConfig, get_config,
                                      list_configs, reduced)
