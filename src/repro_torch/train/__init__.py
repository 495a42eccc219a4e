"""Training substrate of the port: optimizer, step factory, checkpoint,
fault tolerance (single device; the mesh side waits for ROADMAP.md,
Queue 1, item 7b)."""
from repro_torch.train.checkpoint import CheckpointManager  # noqa: F401
from repro_torch.train.optimizer import (  # noqa: F401
    OptConfig,
    adamw_update,
    init_opt_state,
)
from repro_torch.train.train_step import make_eval_step, make_train_step  # noqa: F401
