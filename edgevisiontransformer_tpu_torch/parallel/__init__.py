from .train import (  # noqa: F401
    Optimizer,
    cross_entropy,
    make_eval_step,
    make_train_step,
    scaled_lr,
)
