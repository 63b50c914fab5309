"""Training: Adam with step decay, the train/eval steps, checkpoints and
the epoch loop (the JAX package's train/, polydet on one card)."""
from .state import TrainState, create_train_state, lr_schedule  # noqa: F401
from .step import make_eval_step, make_train_step  # noqa: F401
