from .config import Config, DATASET_INFO, task_heads  # noqa: F401
