"""Training substrate of the port: optimizer, step factory, checkpoint,
fault tolerance, on one device, over data ranks (ZeRO-1 AdamW, the
rank-order gradient reduction, collective and elastic checkpoints, the
int8 error-feedback all-reduce) and over a model axis (tensor parallel:
``models.tensor_parallel``; the dense, VLM, MoE, SSM and hybrid
families; the enc-dec waits for ROADMAP.md, Queue 1, item 7d)."""
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
