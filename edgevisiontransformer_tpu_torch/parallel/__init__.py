from .launch import spawn  # noqa: F401
from .mesh import (  # noqa: F401
    Mesh,
    batch_spec,
    gather_params,
    make_mesh,
    param_partition_spec,
    shard_params,
)
from .pipeline import (  # noqa: F401
    make_pipeline_train_step,
    pipeline_encoder_apply,
    sequence_sharded_encoder_apply,
    vit_block_apply,
)
from .train import (  # noqa: F401
    Optimizer,
    cross_entropy,
    jit_sharded_train_step,
    make_eval_step,
    make_train_step,
    scaled_lr,
)
