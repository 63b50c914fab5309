"""Inference entry points."""
from .detector import create_detector  # noqa: F401
