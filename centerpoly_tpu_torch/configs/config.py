"""Typed experiment configuration.

The port's own copy of the JAX package's `Config` (itself the reference's
argparse `opts`, src/lib/opts.py:9-459), cut to the fields the inference,
polydet training, eval and data-parallel slices read.  The DCN mode
travels to the model as the `dcn_kernel` argument; nothing here writes
environment variables.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional, Tuple

DATASET_INFO = {
    # dataset -> (default_resolution (h, w), num_classes, mean, std)
    "cityscapes": (
        (512, 1024), 8,
        (0.28405, 0.322669, 0.28169),
        (0.042303, 0.040882, 0.042699),
    ),
    # kitti_poly uses imagenet-style stats (ref dataset/kitti_poly.py:16-20)
    "kitti_poly": (
        (512, 1024), 8,
        (0.485, 0.456, 0.406),
        (0.229, 0.224, 0.225),
    ),
    "IDD": (
        (512, 1024), 9,
        (0.28405, 0.322669, 0.28169),
        (0.042303, 0.040882, 0.042699),
    ),
    "idd": (
        (512, 1024), 9,
        (0.28405, 0.322669, 0.28169),
        (0.042303, 0.040882, 0.042699),
    ),
    "coco": ((512, 512), 80, (0.408, 0.447, 0.470), (0.289, 0.274, 0.278)),
    "pascal": ((384, 384), 20, (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
    "kitti": ((384, 1280), 3, (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
    "uadetrac": ((512, 512), 4, (0.408, 0.447, 0.470), (0.289, 0.274, 0.278)),
    "uadetrac1on10": ((512, 512), 4, (0.408, 0.447, 0.470),
                      (0.289, 0.274, 0.278)),
    "uadetrac1on10_b": ((512, 512), 4, (0.408, 0.447, 0.470),
                        (0.289, 0.274, 0.278)),
    "uav": ((512, 512), 4, (0.408, 0.447, 0.470), (0.289, 0.274, 0.278)),
    "coco_hp": ((512, 512), 1, (0.408, 0.447, 0.470), (0.289, 0.274, 0.278)),
}


def task_heads(task: str, num_classes: int, nbr_points: int = 16,
               reg_offset: bool = True, cat_spec_poly: bool = False,
               cat_spec_wh: bool = False, agnostic_ex: bool = False,
               reg_bbox: bool = True, hm_hp: bool = True,
               reg_hp_offset: bool = True) -> Dict[str, int]:
    """Head table per task (ref opts.py:332-425)."""
    if task == "polydet":
        heads = {
            "hm": num_classes,
            "poly": nbr_points * 2 * (num_classes if cat_spec_poly else 1),
            "pseudo_depth": 1,
        }
    elif task == "ctdet":
        heads = {"hm": num_classes,
                 "wh": 2 * (num_classes if cat_spec_wh else 1)}
    elif task == "ddd":
        heads = {"hm": num_classes, "dep": 1, "rot": 8, "dim": 3}
        if reg_bbox:  # ref opts.py:358-360
            heads["wh"] = 2
    elif task == "exdet":
        hc = 1 if agnostic_ex else num_classes
        heads = {"hm_t": hc, "hm_l": hc, "hm_b": hc, "hm_r": hc,
                 "hm_c": num_classes}
        if reg_offset:
            heads.update({"reg_t": 2, "reg_l": 2, "reg_b": 2, "reg_r": 2})
        return heads
    elif task == "multi_pose":
        heads = {"hm": num_classes, "wh": 2, "hps": 34}
        if hm_hp:
            heads["hm_hp"] = 17
        if reg_hp_offset:
            heads["hp_offset"] = 2
    else:
        raise ValueError(f"unknown task '{task}'")
    if reg_offset:
        heads["reg"] = 2
    return heads


# What the inference entry points default dcn_kernel to on DCN archs
# (Config.prefer_fast_inference_dcn), as in the JAX package.
INFERENCE_DCN_KERNEL_DEFAULT = "rowband:6"

_DCN_KERNEL_PREFIXES = ("auto", "off", "on", "0", "1", "rowband", "halo")


@dataclasses.dataclass
class Config:
    """One experiment.  Field names and defaults track the JAX package's
    Config and the reference's opts.py."""
    task: str = "polydet"
    dataset: str = "cityscapes"
    exp_id: str = "default"
    arch: str = "dla_34"
    load_model: str = ""           # reference .pth (weights.load_reference_checkpoint)
    resume: bool = False
    seed: int = 317
    data_dir: str = "data"
    save_dir: str = "exp"
    train_dtype: str = "float32"   # float32 | bfloat16 activations in
                                   # training; params and Adam stay f32

    # model
    dcn_kernel: str = "auto"       # auto | off | on | rowband[:R] | halo[:R]
    eval_batch: int = 1            # frames per run_batch call in test.py
    infer_devices: int = 0         # >1: test.py's run_batch over this many
                                   # cards, one replica each
    head_conv: int = -1            # -1 -> 256 for dla/hourglass, 64 for res
    down_ratio: int = 4
    rep: str = "cartesian"         # cartesian | polar | polar_fixed
    nbr_points: int = 16
    cat_spec_poly: bool = False
    reg_offset: bool = True
    mixed_precision: bool = True   # bf16 activations and weights on the card

    # input
    input_h: int = -1
    input_w: int = -1

    # train
    lr: float = 1.25e-4
    lr_step: Tuple[int, ...] = (90, 120)
    num_epochs: int = 240
    batch_size: int = 32
    val_intervals: int = 5
    grad_clip: Optional[float] = None
    num_workers: int = 4

    # loss
    mse_loss: bool = False
    poly_loss: str = "l1"          # l1 | iou | l1+iou | relu
    poly_order: bool = False
    elliptical_gt: bool = True     # paper runs use it
    hm_weight: float = 1.0
    off_weight: float = 1.0
    poly_weight: float = 1.0
    depth_weight: float = 0.1

    # augmentation
    not_rand_crop: bool = False
    shift: float = 0.1
    scale: float = 0.4
    flip: float = 0.5
    no_reorder_flip: bool = False
    no_color_aug: bool = False

    # debug views of the detector (ref opts.py:19-24): 0 = off, 1-3 =
    # compose the heat-map blend and the detection overlay, 4 = also save
    # every view to debug_dir as PNG (infer/detector.py::_debug_views)
    debug: int = 0
    debug_dir: str = "debug"

    # test
    test_scales: Tuple[float, ...] = (1.0,)
    nms: bool = False
    K: int = 128
    thresh: float = 0.05           # score cut of the eval masks
    fix_res: bool = True
    flip_test: bool = False
    vis_thresh: float = 0.3

    # oracle eval: GT maps in place of heads in validation (the
    # reference's decoupling harness, trains/polydet.py:49-70)
    eval_oracle_hm: bool = False
    eval_oracle_poly: bool = False
    eval_oracle_offset: bool = False
    eval_oracle_pseudo_depth: bool = False

    # data parallelism: one process per card (train/mesh.py)
    mesh_shape: Tuple[int, ...] = (-1,)   # parsed as the JAX CLI does; unread
    distributed: bool = False      # join a process group (main.py)
    coordinator_address: str = ""  # host:port of rank 0; "" = torchrun's env
    num_processes: int = -1        # world size; -1 = torchrun's env
    process_id: int = -1           # this process's rank; -1 = torchrun's env

    def __post_init__(self):
        info = DATASET_INFO.get(self.dataset)
        if info is None:
            raise ValueError(f"unknown dataset '{self.dataset}'")
        (dh, dw), ncls, mean, std = info
        self.num_classes = ncls
        self.mean = mean
        self.std = std
        if self.input_h <= 0:
            self.input_h = dh
        if self.input_w <= 0:
            self.input_w = dw
        if self.head_conv == -1:
            self.head_conv = 256 if (
                "dla" in self.arch or "hourglass" in self.arch) else 64
        self.pad = 127 if "hourglass" in self.arch else 31
        self.num_stacks = 2 if self.arch == "hourglass" else 1
        if self.dcn_kernel.lower().split(":", 1)[0] not in _DCN_KERNEL_PREFIXES:
            raise ValueError(
                f"dcn_kernel={self.dcn_kernel!r}: expected auto | off | on | "
                f"rowband[:R] | halo[:R]")
        if self.poly_loss in ("iou", "l1+iou") and self.rep == "cartesian":
            raise ValueError(
                f"poly_loss='{self.poly_loss}' requires rep='polar' or "
                f"'polar_fixed' (got rep='cartesian'): the polygon IoU loss "
                f"sorts (r, theta) vertex pairs by theta")
        self.output_h = self.input_h // self.down_ratio
        self.output_w = self.input_w // self.down_ratio
        self.max_objs = 128
        self.heads = task_heads(self.task, self.num_classes, self.nbr_points,
                                self.reg_offset, self.cat_spec_poly)

    def prefer_fast_inference_dcn(self) -> bool:
        """Default the inference entry points onto `rowband:6` when the user
        gave no DCN mode and the arch has DCNv2 nodes (dla_* except dlav0,
        resdcn_*).  `dcn_kernel off` keeps exact DCNv2 semantics.  Returns
        True when the default was applied."""
        has_dcn = (self.arch.startswith("dla")
                   and not self.arch.startswith("dlav0")) \
            or self.arch.startswith("resdcn")
        if self.dcn_kernel != "auto" or not has_dcn:
            return False
        self.dcn_kernel = INFERENCE_DCN_KERNEL_DEFAULT
        return True

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self) | {"heads": self.heads},
                          indent=2, default=str)

    @classmethod
    def from_args(cls, argv=None) -> "Config":
        """CLI front-end mirroring the reference flag surface."""
        import argparse

        parser = argparse.ArgumentParser(description="centerpoly_tpu_torch")
        parser.add_argument("task", nargs="?", default="polydet")
        fields = {f.name: f for f in dataclasses.fields(cls)}
        for name, f in fields.items():
            if name == "task":
                continue
            if isinstance(f.default, bool):
                # default-False flags switch on with --name; default-True
                # flags switch off with --no_name / --not_name
                parser.add_argument(f"--{name}", dest=name,
                                    action="store_true", default=f.default)
                parser.add_argument(f"--no_{name}", f"--not_{name}",
                                    dest=name, action="store_false")
            elif isinstance(f.default, tuple):
                parser.add_argument(f"--{name}", type=str,
                                    default=",".join(map(str, f.default)))
            elif f.default is None:
                parser.add_argument(f"--{name}", type=float, default=None)
            else:
                parser.add_argument(f"--{name}", type=type(f.default),
                                    default=f.default)
        ns = parser.parse_args(argv)
        kwargs = {}
        for name, f in fields.items():
            v = getattr(ns, name)
            if isinstance(f.default, tuple) and isinstance(v, str):
                cast = float if name == "test_scales" else int
                v = tuple(cast(x) for x in v.split(",") if x)
            kwargs[name] = v
        return cls(**kwargs)
