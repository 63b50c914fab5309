"""The benchmark's own inputs: seeded frames and their polydet targets."""
import json
import os

import numpy as np
import pytest
import torch

from portbench_common import small_cell
from benchmark.harness import cells, frames

BIG_SEED = 2 ** 31 + 12345
POLYDET = {"nbr_points": 16, "num_classes": 8}


def targets(*args):
    return cells.task("polydet").targets(*args, POLYDET)


def test_same_seed_same_frames_other_seed_other_frames():
    a = frames.make_frames(np.random.default_rng(BIG_SEED), 3, 64, 128)
    b = frames.make_frames(np.random.default_rng(BIG_SEED), 3, 64, 128)
    c = frames.make_frames(np.random.default_rng(BIG_SEED + 1), 3, 64, 128)
    for x, y in zip(a[0], b[0]):
        assert np.array_equal(x, y)
    assert all(np.array_equal(p[0], q[0]) for p, q in
               zip(sum(a[1], []), sum(b[1], [])))
    assert not all(np.array_equal(x, y) for x, y in zip(a[0], c[0]))
    ta = targets(a[1][0], (64, 128), (16, 32))
    tb = targets(b[1][0], (64, 128), (16, 32))
    assert all(np.array_equal(ta[k], tb[k]) for k in ta)


def test_targets_are_the_port_samplers_in_val_mode(tmp_path):
    """Every target key equals the port's PolydetSampler's (val split, no
    augmentation, polar, elliptical gaussians) on the same frames."""
    from centerpoly_tpu_torch.configs import Config
    from centerpoly_tpu_torch.data.coco_poly import CocoPolyAnnotations
    from centerpoly_tpu_torch.data.datasets import CityscapesMeta
    from centerpoly_tpu_torch.data.sampler import PolydetSampler
    h, w = 256, 512
    imgs, objects = frames.make_frames(np.random.default_rng(5), 4, h, w)
    root = str(tmp_path)
    img_dir = os.path.join(root, "leftImg8bit", "val")
    os.makedirs(img_dir)
    meta = CityscapesMeta(root, 16)
    cat = {v: k for k, v in meta.cat_ids.items()}
    images, anns = [], []
    for i, (img, objs) in enumerate(zip(imgs, objects)):
        np.save(os.path.join(img_dir, f"img_{i}.npy"), img)
        images.append({"id": i, "file_name": f"img_{i}.npy", "height": h,
                       "width": w})
        for pts, cls, depth, box in objs:
            anns.append({"id": len(anns), "image_id": i,
                         "category_id": cat[cls], "bbox": list(box),
                         "poly": pts.reshape(-1).tolist(),
                         "pseudo_depth": depth, "area": 1.0})
    os.makedirs(os.path.dirname(meta.annot_path("val")))
    with open(meta.annot_path("val"), "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": c, "name": str(c)}
                                  for c in cat.values()]}, f)
    cfg = Config(rep="polar", input_h=128, input_w=256)
    sampler = PolydetSampler(cfg, meta, CocoPolyAnnotations(
        meta.annot_path("val")), split="val", img_dir=img_dir)
    for i in range(len(imgs)):
        want = sampler(i)
        got = targets(objects[i], (h, w), (32, 64))
        for k, v in got.items():
            assert np.array_equal(v, want[k]), (i, k)


def test_batch_is_what_to_device_and_the_loss_take():
    from centerpoly_tpu_torch.losses import PolydetLossConfig, polydet_loss
    from centerpoly_tpu_torch.train.step import to_device
    cell = small_cell("dla34.train-b16")
    conf = cell["config"]
    imgs, objs = frames.make_frames(np.random.default_rng(3), 2, 64, 128)
    make_batch = cells.module("drivers", "train_step").make_batch
    batch = make_batch(imgs, objs, conf, "cpu")
    host = {k: v.numpy() for k, v in batch.items() if k != "input"}
    host["input"] = batch["input"].permute(0, 2, 3, 1).numpy()
    ref = to_device(host, "cpu")
    assert set(ref) == set(batch)
    for k, v in ref.items():
        assert v.shape == batch[k].shape and v.dtype == batch[k].dtype, k
        assert torch.equal(v, batch[k]), k
    assert batch["input"].shape == (2, 3, 64, 128)
    assert batch["hm"].shape == (2, 16, 32, 8)
    heads = {"hm": torch.randn(2, 16, 32, 8), "poly": torch.randn(2, 16, 32, 32),
             "pseudo_depth": torch.randn(2, 16, 32, 1),
             "reg": torch.randn(2, 16, 32, 2)}
    loss, _ = polydet_loss([heads], batch, PolydetLossConfig(
        rep="polar", poly_loss="l1+iou", poly_order=True))
    assert torch.isfinite(loss)


@pytest.mark.parametrize("name", ["dla34.serve-batch4", "dla34.train-b16"])
def test_traffic_files_hold_parameters_only(name):
    t = cells.load(name)["traffic"]
    assert callable(cells.driver(t["kind"]))
    assert all(isinstance(v, (int, str)) for v in t.values())
