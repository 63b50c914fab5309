"""Training losses (the JAX package's losses/, polydet path)."""
from .polydet import PolydetLossConfig, polydet_loss  # noqa: F401
