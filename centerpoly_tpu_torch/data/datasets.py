"""Dataset metadata: class tables, annotation paths and the eval entry (the
JAX package's data/datasets.py).  The polygon adapters (reference
src/lib/datasets/dataset/{cityscapes,kitti_poly,IDD}.py): class names,
label ids, per-class frequencies, annotation paths by nbr_points and split,
and `run_eval`, wired to the instance-AP harness (eval/).  The box
adapters of the ctdet, exdet and multi_pose tasks (dataset/{coco,coco_hp,
pascal,kitti,kitti2d,uadetrac*,uav}.py): `run_eval(results, save_dir)`
scores {img_id: {class: (n, 5+) rows}} by their first five columns with the COCO protocol (eval/coco_eval.py), VOC-07 (eval/
voc_eval.py) or the native KITTI evaluator (eval/native.py).  The box
adapters' `run_eval` takes neither `annotations` nor `thresh`, as in the
JAX package; the callers pass those to an adapter whose `run_eval` names
them (`eval_kwargs`)."""
from __future__ import annotations

import inspect
import json
import os
from typing import Dict, List, Optional

import numpy as np

from .coco_poly import CocoPolyAnnotations


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


class CocoMeta(DatasetMeta):
    """Reference: dataset/coco.py:13-70: 80-class COCO 2017."""
    name = "coco"
    num_classes = 80
    default_resolution = (512, 512)
    class_name = [
        "__background__", "person", "bicycle", "car", "motorcycle",
        "airplane", "bus", "train", "truck", "boat", "traffic light",
        "fire hydrant", "stop sign", "parking meter", "bench", "bird",
        "cat", "dog", "horse", "sheep", "cow", "elephant", "bear", "zebra",
        "giraffe", "backpack", "umbrella", "handbag", "tie", "suitcase",
        "frisbee", "skis", "snowboard", "sports ball", "kite",
        "baseball bat", "baseball glove", "skateboard", "surfboard",
        "tennis racket", "bottle", "wine glass", "cup", "fork", "knife",
        "spoon", "bowl", "banana", "apple", "sandwich", "orange",
        "broccoli", "carrot", "hot dog", "pizza", "donut", "cake", "chair",
        "couch", "potted plant", "bed", "dining table", "toilet", "tv",
        "laptop", "mouse", "remote", "keyboard", "cell phone", "microwave",
        "oven", "toaster", "sink", "refrigerator", "book", "clock", "vase",
        "scissors", "teddy bear", "hair drier", "toothbrush"]

    def __init__(self, data_root: str = "", nbr_points: int = 16):
        super().__init__(data_root, nbr_points)
        self._valid_ids = [
            1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14, 15, 16, 17, 18, 19,
            20, 21, 22, 23, 24, 25, 27, 28, 31, 32, 33, 34, 35, 36, 37, 38,
            39, 40, 41, 42, 43, 44, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55,
            56, 57, 58, 59, 60, 61, 62, 63, 64, 65, 67, 70, 72, 73, 74, 75,
            76, 77, 78, 79, 80, 81, 82, 84, 85, 86, 87, 88, 89, 90]
        self.cat_ids = {v: i for i, v in enumerate(self._valid_ids)}

    def annot_path(self, split: str) -> str:
        base = os.path.join(self.data_root, "coco", "annotations")
        if split == "test":
            return os.path.join(base, "image_info_test-dev2017.json")
        return os.path.join(base, f"instances_{split}2017.json")

    def img_dir(self, split: str):
        d = os.path.join(self.data_root, "coco", "images", f"{split}2017")
        return d if os.path.isdir(d) else None

    def run_eval(self, results, save_dir: str):
        """COCO bbox mAP over {img_id: {cls: rows}} results, each row's
        first five columns [x0, y0, x1, y1, score]: ctdet's and exdet's
        rows, and multi_pose's 39-column ones (the JAX package reshapes
        those to (-1, 5), which mixes joints into boxes or raises)."""
        from ..eval.coco_eval import evaluate_coco_map_areas

        ann = CocoPolyAnnotations(self.annot_path("val"))
        remapped = {}
        for img_id, per_class in results.items():
            remapped[int(img_id)] = {
                self._valid_ids[cls - 1]: np.asarray(
                    rows, np.float32).reshape(len(rows), -1)[:, :5]
                for cls, rows in per_class.items() if len(rows)}
        res = evaluate_coco_map_areas(ann, remapped)
        os.makedirs(save_dir, exist_ok=True)
        with open(os.path.join(save_dir, "coco_eval.json"), "w") as f:
            json.dump(res, f, indent=2)
        return res


class CocoHpMeta(CocoMeta):
    """Reference: dataset/coco_hp.py: COCO person keypoints, one class.
    `run_eval` is CocoMeta's: a multi_pose row's first five columns are
    scored as a box (the JAX package has no keypoint OKS either)."""
    name = "coco_hp"
    num_classes = 1
    class_name = ["__background__", "person"]

    def __init__(self, data_root: str = "", nbr_points: int = 16):
        DatasetMeta.__init__(self, data_root, nbr_points)
        self._valid_ids = [1]
        self.cat_ids = {1: 0}

    def annot_path(self, split: str) -> str:
        base = os.path.join(self.data_root, "coco", "annotations")
        return os.path.join(base, f"person_keypoints_{split}2017.json")


class PascalMeta(DatasetMeta):
    """Reference: dataset/pascal.py: VOC 0712 in COCO json form."""
    name = "pascal"
    num_classes = 20
    default_resolution = (384, 384)
    class_name = [
        "__background__", "aeroplane", "bicycle", "bird", "boat", "bottle",
        "bus", "car", "cat", "chair", "cow", "diningtable", "dog", "horse",
        "motorbike", "person", "pottedplant", "sheep", "sofa", "train",
        "tvmonitor"]

    def annot_path(self, split: str) -> str:
        base = os.path.join(self.data_root, "voc", "annotations")
        name = {"train": "pascal_trainval0712.json",
                "val": "pascal_test2007.json",
                "test": "pascal_test2007.json"}[split]
        return os.path.join(base, name)

    def img_dir(self, split: str):
        d = os.path.join(self.data_root, "voc", "images")
        return d if os.path.isdir(d) else None

    def run_eval(self, results, save_dir: str):
        """VOC-2007 11-point mAP (the reference's protocol: src/lib/
        datasets/dataset/pascal.py:77-79 -> tools/reval.py ->
        voc_eval_lib voc_eval with use_07_metric).  A COCO-protocol
        summary is also written alongside, clearly labeled."""
        from ..eval.coco_eval import evaluate_coco_map_areas
        from ..eval.voc_eval import evaluate_voc_map

        ann = CocoPolyAnnotations(self.annot_path("val"))
        remapped = {int(i): {c: np.asarray(r, np.float32)
                             for c, r in pc.items() if len(r)}
                    for i, pc in results.items()}
        res = evaluate_voc_map(ann, remapped, use_07_metric=True,
                               class_names=self.class_name)
        coco_res = evaluate_coco_map_areas(ann, remapped)
        os.makedirs(save_dir, exist_ok=True)
        with open(os.path.join(save_dir, "voc_eval.json"), "w") as f:
            json.dump(res, f, indent=2)
        with open(os.path.join(save_dir,
                               "coco_protocol_eval.json"), "w") as f:
            json.dump(coco_res, f, indent=2)
        return res


class KittiMeta(DatasetMeta):
    """Reference: dataset/kitti.py: 3D detection (the ddd task's meta;
    its writer and the native evaluator serve Kitti2dMeta)."""
    name = "kitti"
    num_classes = 3
    default_resolution = (384, 1280)
    class_name = ["__background__", "Pedestrian", "Car", "Cyclist"]

    def __init__(self, data_root: str = "", nbr_points: int = 16,
                 kitti_split: str = "3dop"):
        super().__init__(data_root, nbr_points)
        self.kitti_split = kitti_split
        # category 4=Van 5=Person_sitting -> ignore-as-neighbor (-3/-2),
        # 9=DontCare -> -1 (ref kitti.py:39)
        self.cat_ids = {1: 0, 2: 1, 3: 2, 4: -3, 5: -3, 6: -2, 7: -99,
                        8: -99, 9: -1}

    def annot_path(self, split: str) -> str:
        return os.path.join(self.data_root, "kitti", "annotations",
                            f"kitti_{self.kitti_split}_{split}.json")

    def img_dir(self, split: str):
        d = os.path.join(self.data_root, "kitti", "images", "trainval")
        return d if os.path.isdir(d) else None

    def write_kitti_results(self, results, results_dir: str,
                            id_to_file=None):
        """Dump {img_id: {cls: (n, 13) ddd rows}} as KITTI txt files
        (ref dataset/kitti.py:66-87 save_results)."""
        os.makedirs(results_dir, exist_ok=True)
        for img_id, per_class in results.items():
            name = f"{int(img_id):06d}.txt" if id_to_file is None \
                else id_to_file[int(img_id)]
            with open(os.path.join(results_dir, name), "w") as f:
                for cls_ind in per_class:
                    cls_name = self.class_name[int(cls_ind)]
                    for row in per_class[cls_ind]:
                        # row: [alpha, bbox4, dim3(h,w,l), loc3, ry, score]
                        f.write(f"{cls_name} 0.0 0")
                        for v in row:
                            f.write(f" {float(v):.2f}")
                        f.write("\n")

    def run_eval(self, results, save_dir: str,
                 gt_label_dir: str | None = None):
        """Write KITTI txt + run the native cpp/ evaluator."""
        from ..eval.native import run_kitti_eval
        res_dir = os.path.join(save_dir, "results")
        self.write_kitti_results(results, res_dir)
        if gt_label_dir is None:
            gt_label_dir = os.path.join(self.data_root, "kitti",
                                        "training", "label_2")
        if not os.path.isdir(gt_label_dir):
            return None
        return run_kitti_eval(gt_label_dir, res_dir)


class Kitti2dMeta(KittiMeta):
    """Reference: dataset/kitti2d.py: 2D boxes on KITTI (ctdet task)."""
    name = "kitti2d"

    def write_kitti_results(self, results, results_dir: str,
                            id_to_file=None):
        """2D rows [x0, y0, x1, y1, score] -> KITTI txt lines with the
        3D fields stubbed (ref kitti2d.py:94-112)."""
        os.makedirs(results_dir, exist_ok=True)
        for img_id, per_class in results.items():
            name = f"{int(img_id):06d}.txt" if id_to_file is None \
                else id_to_file[int(img_id)]
            with open(os.path.join(results_dir, name), "w") as f:
                for cls_ind in per_class:
                    cls_name = self.class_name[int(cls_ind)]
                    for row in per_class[cls_ind]:
                        x0, y0, x1, y1, score = [float(v)
                                                 for v in row[:5]]
                        f.write(
                            f"{cls_name} 0.0 0.0 0.0 {x0:.2f} {y0:.2f} "
                            f"{x1:.2f} {y1:.2f} -1 -1 -1 -1000 -1000 "
                            f"-1000 -10 {score:.2f}\n")


class UADetracMeta(DatasetMeta):
    """Reference: dataset/uadetrac.py: 4-class vehicle detection."""
    name = "uadetrac"
    num_classes = 4
    default_resolution = (512, 512)
    class_name = ["__background__", "bus", "car", "others", "van"]

    def annot_path(self, split: str) -> str:
        base = os.path.join(self.data_root, "UA-Detrac", "COCO-format")
        name = {"train": "train.json", "val": "val.json",
                "test": "test-1-on-30.json"}[split]
        return os.path.join(base, name)

    def run_eval(self, results, save_dir: str):
        return PascalMeta.run_eval(self, results, save_dir)


class UADetrac1on10Meta(UADetracMeta):
    """Reference: dataset/uadetrac1on10.py: the 1-in-10-frames subset."""
    name = "uadetrac1on10"

    def annot_path(self, split: str) -> str:
        base = os.path.join(self.data_root, "UA-Detrac", "COCO-format")
        name = {"train": "train-1-on-10.json", "val": "val.json",
                "test": "test-1-on-30.json"}[split]
        return os.path.join(base, name)


class UADetrac1on10BMeta(UADetrac1on10Meta):
    """Reference: dataset/uadetrac1on10_b.py (background-frames variant)."""
    name = "uadetrac1on10_b"

    def annot_path(self, split: str) -> str:
        base = os.path.join(self.data_root, "UA-Detrac", "COCO-format")
        name = {"train": "train-1-on-10-b.json", "val": "val.json",
                "test": "test-1-on-30.json"}[split]
        return os.path.join(base, name)


class UAVMeta(DatasetMeta):
    """Reference: dataset/uav.py: single-class drone detection."""
    name = "uav"
    num_classes = 1
    default_resolution = (512, 512)
    class_name = ["__background__", "drone"]

    def annot_path(self, split: str) -> str:
        base = os.path.join(self.data_root, "UAV", "COCO-format")
        return os.path.join(base, f"{split}.json")

    def run_eval(self, results, save_dir: str):
        return PascalMeta.run_eval(self, results, save_dir)


def eval_kwargs(meta, annotations=None, thresh: float = 0.05) -> dict:
    """The keywords of `meta.run_eval` beyond (results, save_dir) that it
    takes: the polygon adapters take the val annotations and the score
    cut, the box adapters neither."""
    params = inspect.signature(meta.run_eval).parameters
    return {k: v for k, v in (("annotations", annotations),
                              ("thresh", thresh)) if k in params}


DATASETS = {
    "cityscapes": CityscapesMeta,
    "kitti_poly": KittiPolyMeta,
    # both spellings: the reference scripts pass `--dataset idd`, its
    # factory key is `IDD`
    "IDD": IDDMeta,
    "idd": IDDMeta,
    "coco": CocoMeta,
    "coco_hp": CocoHpMeta,
    "pascal": PascalMeta,
    "kitti": KittiMeta,
    # in the registry, as in the JAX package, though Config's DATASET_INFO
    # has no `kitti2d` entry, so `--dataset kitti2d` is refused there
    "kitti2d": Kitti2dMeta,
    "uadetrac": UADetracMeta,
    "uadetrac1on10": UADetrac1on10Meta,
    "uadetrac1on10_b": UADetrac1on10BMeta,
    "uav": UAVMeta,
}
