"""Detection decode, gather and NMS ops."""
from .nms import hard_nms_batch, soft_nms, soft_nms_batch  # noqa: F401
