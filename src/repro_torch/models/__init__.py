"""The LM substrate's models (the port of ``repro.models``): layers, the
Mamba2 block, MoE, the unified ``Model`` and ``convert.from_reference``."""
from repro_torch.models.model import Model  # noqa: F401
