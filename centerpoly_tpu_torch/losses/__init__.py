"""Training losses (the JAX package's losses/: polydet, ctdet, exdet,
multi_pose and ddd)."""
from .ctdet import CtdetLossConfig, ctdet_loss  # noqa: F401
from .ddd import DddLossConfig, ddd_loss  # noqa: F401
from .exdet import ExdetLossConfig, exdet_loss  # noqa: F401
from .multi_pose import MultiPoseLossConfig, multi_pose_loss  # noqa: F401
from .polydet import PolydetLossConfig, polydet_loss  # noqa: F401
