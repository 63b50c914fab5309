"""Training: Adam with step decay, the train/eval steps, checkpoints, the
epoch loop, weight surgery and data parallelism over cards (the JAX
package's train/)."""
from .mesh import (initialize_distributed, make_mesh, replicate,  # noqa: F401
                   shard_batch)
from .state import TrainState, create_train_state, lr_schedule  # noqa: F401
from .step import make_eval_step, make_train_step  # noqa: F401
