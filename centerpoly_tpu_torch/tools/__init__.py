"""Offline tools over the port (the JAX package's tools/): GT polygon
generation, CSV <-> COCO and polar conversion, analysis; the command-line
tools `analyze_dcn_offsets`, `hourglass_weights` and `train_convergence`
run as modules.

Parity targets (behavior, not code):
  gt_polygons  — cityscapesStuff/Tools/create_bouding_box_annotations.py
  csv_coco     — src/tools/convert_csv_to_coco.py
  polar        — cityscapesStuff/Tools/convert_to_polar.py
  hourglass_weights — src/tools/convert_hourglass_weight.py
"""
from .gt_polygons import (
    polygon_to_box,
    perimeter_points,
    ray_cast_polygon,
    sample_polygon,
    generate_annotations,
)
from .csv_coco import csv_to_coco, write_csv_row, CITYSCAPES_CATS
from .polar import coco_poly_to_polar, cartesian_to_polar_flat
from .analysis import (
    eval_coco_results,
    polygon_coverage,
    simplify_masks,
    visualize_results,
    parse_training_log,
    plot_training_log,
    merge_coco_json,
)
