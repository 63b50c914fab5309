"""Training losses (the JAX package's losses/, polydet and ctdet)."""
from .ctdet import CtdetLossConfig, ctdet_loss  # noqa: F401
from .polydet import PolydetLossConfig, polydet_loss  # noqa: F401
