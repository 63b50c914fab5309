"""Dataset metadata: class tables, annotation paths and the eval entry (the
JAX package's data/datasets.py, its polygon adapters; reference
src/lib/datasets/dataset/{cityscapes,kitti_poly,IDD}.py): class names,
label ids, per-class frequencies, annotation paths by nbr_points and split,
and `run_eval`, wired to the instance-AP harness (eval/)."""
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
    eval_image_size = (1024, 2048)  # (h, w) of source frames
    # classes excluded from eval mask writing (ref cityscapes.py:242)
    eval_drop_classes = ("pole", "traffic sign", "traffic light")
    # instance-eval label table (labelID -> name); None = cityscapes
    instance_labels: Optional[Dict[int, str]] = None
    void_ids: Optional[tuple] = None

    def __init__(self, data_root: str = "", nbr_points: int = 16):
        self.data_root = data_root
        self.nbr_points = nbr_points
        self._valid_ids = list(range(1, self.num_classes + 1))
        self.cat_ids = {v: i for i, v in enumerate(self._valid_ids)}

    def annot_path(self, split: str) -> str:
        raise NotImplementedError

    def img_dir(self, split: str) -> Optional[str]:
        return None

    def gt_instance_dir(self, split: str = "val"):
        """Directory of *_instanceIds.png GT, when the real dataset layout
        is present (cityscapes: gtFine/<split>; ref CITYSCAPES_DATASET)."""
        d = os.path.join(self.data_root, "gtFine", split)
        return d if os.path.isdir(d) else None

    def run_eval(self, results, save_dir: str, annotations=None,
                 thresh: float = 0.05):
        """Write instance masks + run the official-protocol AP evaluator.

        `annotations` (CocoPolyAnnotations) provides the image-id ->
        file_name map; without it the harness falls back to '<id>.png'
        names, which can never match the gtFine *_instanceIds.png glob —
        so when not supplied, load the val annotations here.  `thresh`:
        the score cut of the masks."""
        from ..eval.harness import run_instance_eval
        if annotations is None:
            try:
                path = self.annot_path("val")
            except NotImplementedError:
                path = None
            if path and os.path.isfile(path):
                from .coco_poly import CocoPolyAnnotations
                annotations = CocoPolyAnnotations(path)
        return run_instance_eval(self, results, save_dir,
                                 annotations=annotations,
                                 gt_instance_dir=self.gt_instance_dir(),
                                 thresh=thresh)


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
    eval_image_size = (1024, 2048)

    def annot_path(self, split: str) -> str:
        base = os.path.join(self.data_root, "cityscapesStuff", "BBoxes")
        if split == "test":
            return os.path.join(base, "test.json")
        return os.path.join(
            base, f"{split}{self.nbr_points}_regular_interval.json")

    def img_dir(self, split: str):
        d = os.path.join(self.data_root, "leftImg8bit", split)
        return d if os.path.isdir(d) else None


class KittiPolyMeta(DatasetMeta):
    """Reference: dataset/kitti_poly.py."""
    name = "kitti_poly"
    num_classes = 8
    default_resolution = (384, 1280)
    class_name = CityscapesMeta.class_name
    label_to_id = CityscapesMeta.label_to_id
    class_frequencies = CityscapesMeta.class_frequencies
    eval_image_size = (375, 1242)

    def annot_path(self, split: str) -> str:
        base = os.path.join(self.data_root, "KITTIPolyStuff", "BBoxes")
        if split == "test":
            return os.path.join(base, "test.json")
        return os.path.join(
            base, f"{split}{self.nbr_points}_regular_interval.json")


class IDDMeta(DatasetMeta):
    """Reference: dataset/IDD.py:16-53: 9 classes in the anue (IDD)
    label-id space (IDDscripts/helpers/anue_labels.py)."""
    name = "IDD"
    num_classes = 9
    default_resolution = (512, 1024)
    class_name = [
        "__background__", "person", "rider", "motorcycle", "bicycle",
        "autorickshaw", "car", "truck", "bus", "vehicle fallback"]
    label_to_id = {"person": 6, "rider": 8, "motorcycle": 9,
                   "bicycle": 10, "autorickshaw": 11, "car": 12,
                   "truck": 13, "bus": 14, "vehicle fallback": 18}
    class_frequencies = {
        "person": 0.15, "rider": 0.03, "car": 0.20, "truck": 0.03,
        "bus": 0.03, "motorcycle": 0.03, "bicycle": 0.03,
        "autorickshaw": 0.33, "vehicle fallback": 0.18}
    eval_image_size = (1080, 1920)
    eval_drop_classes = ()
    # anue instance labels (anue_labels.py hasInstances=True, non-ignored)
    instance_labels = {6: "person", 8: "rider", 9: "motorcycle",
                       10: "bicycle", 11: "autorickshaw", 12: "car",
                       13: "truck", 14: "bus", 18: "vehicle fallback"}
    void_ids = (35, 36, 37, 38, 39, 255, -1)

    def annot_path(self, split: str) -> str:
        base = os.path.join(self.data_root, "IDDStuff", "BBoxes")
        if split == "test":
            return os.path.join(base, "test.json")
        return os.path.join(
            base, f"{split}{self.nbr_points}_regular_interval.json")


DATASETS = {
    "cityscapes": CityscapesMeta,
    "kitti_poly": KittiPolyMeta,
    # both spellings: the reference scripts pass `--dataset idd`, its
    # factory key is `IDD`
    "IDD": IDDMeta,
    "idd": IDDMeta,
}
