"""Training substrate of the port: optimizer, step factory, checkpoint,
fault tolerance, on one device or over data ranks (ZeRO-1 AdamW, the
rank-order gradient reduction, collective and elastic checkpoints, the
int8 error-feedback all-reduce); the model axis waits for ROADMAP.md,
Queue 1, item 7c."""
from repro_torch.train.checkpoint import CheckpointManager  # noqa: F401
from repro_torch.train.optimizer import (  # noqa: F401
    OptConfig,
    adamw_update,
    init_opt_state,
    zero_opt_specs,
)
from repro_torch.train.train_step import (  # noqa: F401
    make_eval_step,
    make_train_step,
    mesh_opt_specs,
)
