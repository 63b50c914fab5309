"""CSV <-> COCO-json conversion for polygon GT.

The JAX package's tools/csv_coco.py (reference
src/tools/convert_csv_to_coco.py:110-174): CSV rows
`path,x0,y0,x1,y1,label,count,x1,y1,...` become COCO annotations carrying
`poly` (flat vertex list) and `pseudo_depth` (the per-image draw-order
index), with image ids assigned over the *sorted* unique paths.
"""
from __future__ import annotations

import csv
import json
import os
from typing import Dict, List, Optional, Sequence

CITYSCAPES_CATS = ["person", "rider", "car", "truck", "bus", "train",
                   "motorcycle", "bicycle"]
IDD_CATS = ["person", "rider", "motorcycle", "bicycle", "autorickshaw",
            "car", "truck", "bus", "vehicle fallback"]
UA_DETRAC_CATS = ["bus", "car", "others", "van"]


def write_csv_row(writer, path: str, box, label: str, count: int,
                  poly_flat: Sequence[float]):
    writer.writerow([path, *[int(v) for v in box], label, count,
                     *[int(v) for v in poly_flat]])


def csv_to_coco(csv_path: str, out_path: Optional[str] = None,
                cats: Sequence[str] = tuple(CITYSCAPES_CATS),
                subsample: Optional[int] = None) -> Dict:
    """Convert a GT CSV into a COCO-format dict (optionally written out).

    `subsample=k` keeps only every k-th image by trailing index in the
    filename (reference's '1-on-10' mode).
    """
    cat_ids = {c: i + 1 for i, c in enumerate(cats)}

    def _frame_index(path: str):
        """Frame index for subsampling (ref convert_csv_to_coco.py:131
        strips 'img'/'.jpg' from UA-DETRAC 'img00123.jpg' names).  NOT
        a concatenation of every digit in the name: cityscapes-style
        stems end in 'leftImg8bit', whose '8' would corrupt the modulo
        and silently drop every image.  Falls back to the last
        all-digit '_'-separated field; None (keep) when no index."""
        stem = os.path.splitext(os.path.basename(path))[0]
        simple = stem.replace("img", "")
        if simple.isdigit():
            return int(simple)
        fields = [f for f in stem.split("_") if f.isdigit()]
        return int(fields[-1]) if fields else None

    image_to_rows: Dict[str, List[List[str]]] = {}
    with open(csv_path, newline="") as f:
        for items in csv.reader(f):
            if not items:
                continue
            if subsample:
                idx = _frame_index(items[0])
                if idx is not None and idx % subsample != 0:
                    continue
            image_to_rows.setdefault(items[0], []).append(items[1:])

    ret = {"images": [], "annotations": [],
           "categories": [{"name": c, "id": i + 1}
                          for i, c in enumerate(cats)]}
    for count, path in enumerate(sorted(image_to_rows)):
        ret["images"].append({"file_name": path, "id": count, "calib": ""})
        for row in image_to_rows[path]:
            x0, y0, x1, y1 = (float(v) for v in row[:4])
            label = row[4].strip()
            if label == "no_object" or label not in cat_ids:
                continue
            poly = [float(v) for v in row[6:]]
            ret["annotations"].append({
                "image_id": count,
                "id": len(ret["annotations"]) + 1,
                "category_id": cat_ids[label],
                "bbox": [x0, y0, x1 - x0, y1 - y0],
                "truncated": 0,
                "occluded": 0,
                "iscrowd": 0,
                "area": (y1 - y0) * (x1 - x0),
                "poly": poly,
                "pseudo_depth": int(row[5]),
            })
    if out_path:
        with open(out_path, "w") as f:
            json.dump(ret, f)
    return ret


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="GT CSV -> COCO json")
    ap.add_argument("csv", help="input CSV")
    ap.add_argument("out", help="output json")
    ap.add_argument("--cats", default="cityscapes",
                    choices=["cityscapes", "idd", "uadetrac"])
    ap.add_argument("--subsample", type=int, default=None)
    args = ap.parse_args(argv)
    cats = {"cityscapes": CITYSCAPES_CATS, "idd": IDD_CATS,
            "uadetrac": UA_DETRAC_CATS}[args.cats]
    ret = csv_to_coco(args.csv, args.out, cats, args.subsample)
    print(f"{args.out}: {len(ret['images'])} images, "
          f"{len(ret['annotations'])} annotations")


if __name__ == "__main__":
    main()
