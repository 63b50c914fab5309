"""Minimal COCO-format annotation reader (no pycocotools dependency); the
port's copy of the JAX package's data/coco_poly.py.

Reads the reference's shipped GT jsons unchanged
(reference: cityscapesStuff/BBoxes/*.json, loaded via pycocotools in
src/lib/datasets/dataset/cityscapes.py:114) — images, categories, and
annotations carrying the CenterPoly extras `poly` (flat [x0, y0, ...]) and
`pseudo_depth` (instance draw-order index; SURVEY.md §2.6).
"""
from __future__ import annotations

import json
from typing import Dict, List


class CocoPolyAnnotations:
    def __init__(self, annot_path: str):
        with open(annot_path) as f:
            data = json.load(f)
        self.dataset = data
        self.imgs: Dict[int, dict] = {im["id"]: im for im in data["images"]}
        self.cats: Dict[int, dict] = {
            c["id"]: c for c in data.get("categories", [])}
        self.img_to_anns: Dict[int, List[dict]] = {i: [] for i in self.imgs}
        for ann in data.get("annotations", []):
            self.img_to_anns.setdefault(ann["image_id"], []).append(ann)

    def get_img_ids(self) -> List[int]:
        return list(self.imgs.keys())

    def load_img(self, img_id: int) -> dict:
        return self.imgs[img_id]

    def load_anns(self, img_id: int) -> List[dict]:
        return self.img_to_anns.get(img_id, [])

    def __len__(self) -> int:
        return len(self.imgs)
