"""--arch config module (see archs.py for the full definition)."""
from repro_torch.configs.archs import SEAMLESS_M4T_LARGE_V2 as CONFIG  # noqa: F401
from repro_torch.configs.archs import smoke_config

SMOKE = smoke_config(CONFIG)
