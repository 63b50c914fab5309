"""Cartesian -> polar GT conversion.

The JAX package's tools/polar.py (reference
cityscapesStuff/Tools/convert_to_polar.py:17-46).
Each vertex (x, y) relative to the anchor becomes (r, theta*100) — the x100
angle weight is the reference's convention for its offline-converted files.
Note the reference anchors at `bbox[0], bbox[1]` — the bbox *top-left*, not
the centroid (the in-training conversion path uses the centroid instead;
both behaviors are preserved where they occur).
"""
from __future__ import annotations

import json
import math
from typing import List, Sequence

WEIGHT_ANGLE = 100.0


def cartesian_to_polar_flat(poly: Sequence[float], cx: float, cy: float,
                            weight_angle: float = WEIGHT_ANGLE) -> List[float]:
    """Flat [x1,y1,...] -> [r1,theta1*w,...] about (cx, cy).

    theta = atan(y / (x + 1e-8)) with a +pi shift when x < 0 (the
    reference's quadrant fix, yielding theta in (-pi/2, 3pi/2))."""
    out = []
    for i in range(0, len(poly), 2):
        x = poly[i] - cx
        y = poly[i + 1] - cy
        r = math.hypot(x, y)
        theta = math.atan(y / (x + 1e-8))
        if x < 0:
            theta += math.pi
        out += [r, theta * weight_angle]
    return out


def coco_poly_to_polar(in_path: str, out_path: str,
                       weight_angle: float = WEIGHT_ANGLE) -> dict:
    """Rewrite a COCO-poly json with polar `poly` fields."""
    data = json.load(open(in_path))
    for ann in data["annotations"]:
        cx, cy = ann["bbox"][0], ann["bbox"][1]
        ann["poly"] = cartesian_to_polar_flat(ann["poly"], cx, cy,
                                              weight_angle)
    with open(out_path, "w") as f:
        f.write(json.dumps(data, sort_keys=True))
    return data


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="COCO-poly json -> polar")
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("--weight_angle", type=float, default=WEIGHT_ANGLE)
    args = ap.parse_args(argv)
    d = coco_poly_to_polar(args.input, args.output, args.weight_angle)
    print(f"{args.output}: {len(d['annotations'])} annotations converted")


if __name__ == "__main__":
    main()
