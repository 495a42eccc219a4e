"""Runtime subsystem: the one home of every dispatch knob of the port."""
from repro_torch.runtime.config import (  # noqa: F401
    EXECUTORS,
    IMPLS,
    TUNE_MODES,
    RuntimeConfig,
    active,
    config_from_env,
    configure,
    default_config,
    dispatch_key,
    resolve_device,
    set_default,
    torchrun_env,
    tune_cache_path,
    update_default,
)
