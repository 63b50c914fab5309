"""Dataset metadata: class tables and annotation paths (the JAX package's
data/datasets.py, its Cityscapes adapter; reference
src/lib/datasets/dataset/cityscapes.py:39-118)."""
from __future__ import annotations

import os
from typing import Dict, List, Optional


class DatasetMeta:
    name: str = "base"
    num_classes: int = 8
    default_resolution = (512, 1024)
    max_objs = 128
    class_name: List[str] = []
    label_to_id: Dict[str, int] = {}
    class_frequencies: Dict[str, float] = {}

    def __init__(self, data_root: str = "", nbr_points: int = 16):
        self.data_root = data_root
        self.nbr_points = nbr_points
        self._valid_ids = list(range(1, self.num_classes + 1))
        self.cat_ids = {v: i for i, v in enumerate(self._valid_ids)}

    def annot_path(self, split: str) -> str:
        raise NotImplementedError

    def img_dir(self, split: str) -> Optional[str]:
        return None


class CityscapesMeta(DatasetMeta):
    """8 classes, the reference's shipped default; the pole / sign / light
    entries serve the FG variant's tables only."""
    name = "cityscapes"
    num_classes = 8
    default_resolution = (512, 1024)
    class_name = [
        "__background__", "person", "rider", "car", "truck", "bus", "train",
        "motorcycle", "bicycle", "pole", "traffic sign", "traffic light"]
    label_to_id = {"person": 24, "rider": 25, "car": 26, "truck": 27,
                   "bus": 28, "train": 31, "motorcycle": 32, "bicycle": 33,
                   "pole": -1, "traffic sign": -1, "traffic light": -1}
    class_frequencies = {
        "person": 0.14062428170827013, "rider": 0.015518384984665498,
        "car": 0.20898266905714155, "truck": 0.003822132907776267,
        "bus": 0.0031719762791339126, "train": 0.0012740443025920892,
        "motorcycle": 0.005831707941761728, "bicycle": 0.0322057384531526,
        "pole": 0.34640870553158515, "traffic sign": 0.16402335310072175,
        "traffic light": 0.07813700573319936}

    def annot_path(self, split: str) -> str:
        base = os.path.join(self.data_root, "cityscapesStuff", "BBoxes")
        if split == "test":
            return os.path.join(base, "test.json")
        return os.path.join(
            base, f"{split}{self.nbr_points}_regular_interval.json")

    def img_dir(self, split: str):
        d = os.path.join(self.data_root, "leftImg8bit", split)
        return d if os.path.isdir(d) else None


DATASETS = {"cityscapes": CityscapesMeta}
