"""--arch config module (see archs.py for the full definition)."""
from repro_torch.configs.archs import GRANITE_20B as CONFIG  # noqa: F401
from repro_torch.configs.archs import smoke_config

SMOKE = smoke_config(CONFIG)
