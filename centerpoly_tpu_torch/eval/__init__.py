"""Polygon instance-AP eval on the host (numpy): rasterize detections into
mask PNGs and txt manifests, then the official Cityscapes AP protocol."""
from .harness import run_instance_eval, save_results_json  # noqa: F401
from .instance_eval import InstanceEvalConfig, evaluate_instances  # noqa: F401
from .rasterize import bresenham_line, rasterize_results  # noqa: F401
