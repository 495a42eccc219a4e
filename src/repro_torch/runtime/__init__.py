"""Runtime subsystem: the one home of every dispatch knob of the port."""
from repro_torch.runtime.config import (  # noqa: F401
    IMPLS,
    RuntimeConfig,
    active,
    config_from_env,
    configure,
    resolve_device,
)
