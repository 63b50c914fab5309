"""The port's eval entry points against the JAX package's: the oracle maps,
the val decode (`Trainer._decode_outputs`), AP-gated validation with
oracle heads (tests/test_val_ap_e2e.py's fixtures), model_best gated on
AP, and `python -m centerpoly_tpu_torch.test` on a PNG fixture, on the
CPU at small shapes."""
import glob
import json
import os
import types

import numpy as np
import pytest
import torch

import torch_port_common  # noqa: F401  (caps torch's threads a worker)

from centerpoly_tpu.configs import Config as JConfig
from centerpoly_tpu.data.coco_poly import CocoPolyAnnotations as JAnnotations
from centerpoly_tpu.data.datasets import CityscapesMeta as JCityscapes
from centerpoly_tpu.eval import harness as jharness
from centerpoly_tpu.train.trainer import Trainer as JTrainer
from centerpoly_tpu.utils import oracle as joracle
from centerpoly_tpu_torch import main as tmain, test as ttest
from centerpoly_tpu_torch.configs import Config
from centerpoly_tpu_torch.data import (CityscapesMeta, CocoPolyAnnotations,
                                       IDDMeta, Loader, PolydetSampler)
from centerpoly_tpu_torch.data.fixture import rect_poly, write_rect_fixture
from centerpoly_tpu_torch.eval.harness import run_instance_eval
from centerpoly_tpu_torch.train.trainer import Trainer
from centerpoly_tpu_torch.utils import oracle

ORACLES = dict(eval_oracle_hm=True, eval_oracle_poly=True,
               eval_oracle_offset=True, eval_oracle_pseudo_depth=True)
ORACLE_ARGS = ["--eval_oracle_hm", "--eval_oracle_poly",
               "--eval_oracle_offset", "--eval_oracle_pseudo_depth"]


def _same(a, b):
    """Dicts equal, NaN for NaN."""
    return json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


# -- oracle maps --------------------------------------------------------------

def test_oracle_maps_match_jax():
    rng = np.random.RandomState(0)
    b, k, h, w = 2, 6, 12, 20
    ind = rng.randint(1, h * w, (b, k)).astype(np.int32)
    ind[0, 4:] = 0                       # empty slots
    ind[1] = 0                           # an image without objects
    batch = {"hm": rng.rand(b, h, w, 3).astype(np.float32), "ind": ind,
             "reg": rng.rand(b, k, 2).astype(np.float32),
             "poly": rng.randn(b, k, 32).astype(np.float32),
             "pseudo_depth": rng.rand(b, k, 1).astype(np.float32)}
    np.testing.assert_array_equal(
        oracle.gen_oracle_map(batch["poly"], ind, w, h),
        joracle.gen_oracle_map(batch["poly"], ind, w, h))
    heads = {"hm": rng.randn(b, h, w, 3), "reg": rng.randn(b, h, w, 2),
             "poly": rng.randn(b, h, w, 32),
             "pseudo_depth": rng.randn(b, h, w, 1)}
    for flags in (ORACLES, {"eval_oracle_poly": True}, {}):
        cfg = types.SimpleNamespace(**flags)
        got, want = (oracle.apply_oracles(heads, batch, cfg),
                     joracle.apply_oracles(heads, batch, cfg))
        assert got.keys() == want.keys()
        for key in got:
            np.testing.assert_array_equal(got[key], want[key])


# -- the val decode ---------------------------------------------------------

@pytest.fixture(scope="module")
def val_batch(tmp_path_factory):
    root = write_rect_fixture(str(tmp_path_factory.mktemp("fx")), 3, 5,
                              128, 256, splits=("val",))
    return root


def _batch(root, rep):
    cfg = Config(input_h=64, input_w=128, K=16, rep=rep)
    meta = CityscapesMeta(root)
    sampler = PolydetSampler(cfg, meta,
                             CocoPolyAnnotations(meta.annot_path("val")),
                             split="val", img_dir=meta.img_dir("val"))
    return next(iter(Loader(sampler, 3, 3, shuffle=False)))


def _sorted(rows):
    rows = np.asarray(rows, np.float64)
    return rows[np.lexsort((rows[:, 1], rows[:, 0], -rows[:, 4]))]


@pytest.mark.parametrize("rep", ["cartesian", "polar"])
@pytest.mark.parametrize("oracles", [False, True])
def test_decode_outputs_matches_jax(val_batch, rep, oracles):
    """The same heads and batch through both packages' val decode (the
    JAX method reads only `self.cfg`): per image and class the same rows,
    vertices within 1e-4 px."""
    batch = _batch(val_batch, rep)
    kw = dict(input_h=64, input_w=128, K=16, rep=rep,
              **(ORACLES if oracles else {}))
    rng = np.random.RandomState(1)
    heads = {k: (rng.randn(3, 16, 32, c) * 2).astype(np.float32)
             for k, c in Config(**kw).heads.items()}
    got = Trainer._decode_outputs(types.SimpleNamespace(cfg=Config(**kw)),
                                  {k: torch.from_numpy(v)
                                   for k, v in heads.items()}, batch)
    want = JTrainer._decode_outputs(types.SimpleNamespace(cfg=JConfig(**kw)),
                                    heads, batch)
    assert got.keys() == want.keys() and len(got) == 3
    n = 0
    for img_id in got:
        assert got[img_id].keys() == want[img_id].keys()
        assert sum(map(len, got[img_id].values())) == 16
        for cls in got[img_id]:
            a, b = got[img_id][cls], want[img_id][cls]
            assert a.dtype == np.float32 and a.shape[1] == b.shape[1]
            # score-0 rows (an oracle heat map is 0 off the objects) tie,
            # and the two top-k's order ties apart; no threshold keeps them
            a, b = a[a[:, 4] > 0], b[b[:, 4] > 0]
            assert a.shape == b.shape
            if len(a):
                np.testing.assert_allclose(_sorted(a), _sorted(b), rtol=0,
                                           atol=1e-4)
            n += len(a)
    assert n > 0


# -- AP-gated validation with oracle heads ------------------------------------

class _InMemoryGT:
    """A meta mixin scoring against in-memory GT instance images at
    128x256 (tests/test_val_ap_e2e.py's TinyCityMeta), keeping what it
    scored."""
    eval_image_size = (128, 256)

    def __init__(self, root, gt_images):
        super().__init__(str(root))
        self.gt_images = gt_images
        self.scored = None

    def run_eval(self, results, save_dir, annotations=None, thresh=0.05):
        self.scored = results
        return run_instance_eval(self, results, save_dir,
                                 gt_images=self.gt_images, thresh=thresh)


class TinyCity(_InMemoryGT, CityscapesMeta):
    pass


class TinyIDD(_InMemoryGT, IDDMeta):
    pass


def _ap_fixture(tmp_path, boxes_per_image, category, label_id):
    images, annotations, gt_images = [], [], {}
    for i, boxes in enumerate(boxes_per_image):
        images.append({"id": i, "file_name": f"img_{i}.png",
                       "height": 128, "width": 256})
        gt = np.zeros((128, 256), np.int32)
        for k, (x0, y0, w, h) in enumerate(boxes):
            annotations.append({
                "id": len(annotations), "image_id": i,
                "category_id": category,
                "bbox": [float(x0), float(y0), float(w), float(h)],
                "poly": rect_poly(x0, y0, w, h).reshape(-1).tolist(),
                "pseudo_depth": k, "area": float(w * h)})
            gt[y0:y0 + h + 1, x0:x0 + w + 1] = label_id * 1000 + k + i
        gt_images[str(i)] = gt
    path = os.path.join(tmp_path, "ann.json")
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": [{"id": c, "name": str(c)}
                                  for c in range(1, 10)]}, f)
    return path, gt_images


@pytest.mark.parametrize("dataset,rep", [("cityscapes", "cartesian"),
                                         ("cityscapes", "polar"),
                                         ("IDD", "cartesian")])
def test_oracle_validate_ap(tmp_path, dataset, rep):
    """validate with all four oracles scores the GT rectangles (AP > 0.5)
    and its AP is the JAX harness's on the same results, dict for dict;
    IDD carries its anue label ids (car = 12) through."""
    if dataset == "IDD":
        boxes = [[(40, 30, 70, 60)], [(100, 30, 70, 60)]]
        path, gts = _ap_fixture(tmp_path, boxes, 6, 12)
        meta = TinyIDD(tmp_path, gts)
    else:
        boxes = [[(30, 30, 60, 50), (150, 70, 70, 40)],
                 [(150, 30, 60, 50), (150, 70, 70, 40)]]
        path, gts = _ap_fixture(tmp_path, boxes, 3, 26)
        meta = TinyCity(tmp_path, gts)
    cfg = Config(dataset=dataset, input_h=128, input_w=256, head_conv=16,
                 batch_size=2, K=16, rep=rep, **ORACLES)
    sampler = PolydetSampler(cfg, meta, CocoPolyAnnotations(path),
                             split="val")
    loader = Loader(sampler, len(sampler), 2, shuffle=False, drop_last=False)
    trainer = Trainer(cfg, [], loader, device="cpu", dataset_meta=meta)
    save_dir = str(tmp_path / "out")
    val_loss, ap = trainer.validate(1, save_dir)
    assert np.isfinite(val_loss)
    assert ap is not None and ap > 0.5, ap
    for f in ("results.json", "gtInstances.json", "instance_ap.json"):
        assert os.path.exists(os.path.join(save_dir, f))
    with open(os.path.join(save_dir, "instance_ap.json")) as f:
        got = json.load(f)
    want = jharness.run_instance_eval(meta, meta.scored,
                                      str(tmp_path / "jax"),
                                      gt_images=meta.gt_images)
    assert _same(got, want) and ap == want["allAp"]


def test_model_best_is_gated_on_ap(tmp_path, monkeypatch):
    """`main` for 2 epochs with oracle validation on a PNG fixture: the AP
    (the same each epoch: it depends on the GT only) gates model_best, so
    it stays at epoch 1; without GT images validation logs that AP was
    skipped and gates on -val_loss."""
    monkeypatch.setattr(CityscapesMeta, "eval_image_size", (128, 256))
    root = write_rect_fixture(str(tmp_path / "png"), 4, 2, 128, 256,
                              splits=("train", "val"), png=True)
    common = ["polydet", "--input_h", "128", "--input_w", "256",
              "--head_conv", "16", "--batch_size", "2", "--num_workers", "0",
              "--K", "16", "--val_intervals", "1", "--num_epochs", "2",
              "--device", "cpu"]
    tr = tmain.main(common + ["--data_dir", root, "--save_dir",
                              str(tmp_path / "exp")] + ORACLE_ARGS)
    save_dir = tmp_path / "exp" / "cityscapes" / "polydet" / "default"
    with open(save_dir / "instance_ap.json") as f:
        ap = json.load(f)["allAp"]
    assert ap > 0 and tr.best == ap
    assert torch.load(save_dir / "model_best.pth",
                      weights_only=True)["epoch"] == 1
    log = open(glob.glob(str(save_dir / "logs_*" / "log.txt"))[0]).read()
    assert log.count(f"AP {round(ap, 4)} ") == 2

    npy = write_rect_fixture(str(tmp_path / "npy"), 4, 2, 128, 256,
                             splits=("train", "val"))
    tr = tmain.main(common + ["--data_dir", npy, "--save_dir",
                              str(tmp_path / "exp2")])
    save_dir = tmp_path / "exp2" / "cityscapes" / "polydet" / "default"
    log = open(glob.glob(str(save_dir / "logs_*" / "log.txt"))[0]).read()
    assert log.count("AP eval skipped: no GT instance images") == 2
    losses = [float(line.split(" loss ")[1].split()[0])
              for line in log.splitlines() if "val   " in line]
    assert tr.best == pytest.approx(-min(losses), abs=1e-4)


# -- test.py -------------------------------------------------------------------

def _ring_weights(path):
    """Seeded DLA-34 weights (head_conv 16) whose poly head puts a 16-gon
    of radius 6 output px around every peak, so the masks pass 100 px."""
    from centerpoly_tpu_torch.models import create_model
    torch.manual_seed(0)
    model = create_model("dla_34", Config().heads, 16)
    sd = model.state_dict()
    t = np.arange(16) * 2 * np.pi / 16
    ring = np.stack([6 * np.cos(t), 6 * np.sin(t)], 1).reshape(-1)
    sd["poly.2.weight"].zero_()
    sd["poly.2.bias"].copy_(torch.from_numpy(ring.astype(np.float32)))
    torch.save({"epoch": 1, "state_dict": sd}, path)


def test_test_cli_on_a_png_fixture(tmp_path, monkeypatch, capsys):
    """`test.main` on the CPU, eval_batch 1 and 3 (the last group short):
    results.json, masks and manifests, instance_ap.json and
    gtInstances.json, AP printed; the instance_ap.json equals the JAX
    harness's on the port's own results, and both batch sizes agree."""
    monkeypatch.setattr(CityscapesMeta, "eval_image_size", (128, 256))
    root = write_rect_fixture(str(tmp_path), 4, 3, 128, 256,
                              splits=("val",), png=True)
    weights = str(tmp_path / "ring.pth")
    _ring_weights(weights)
    outs = {}
    for bs in (1, 3):
        outs[bs] = ttest.main([
            "polydet", "--data_dir", root, "--save_dir", str(tmp_path / "exp"),
            "--exp_id", f"b{bs}", "--input_h", "128", "--input_w", "256",
            "--head_conv", "16", "--K", "16", "--load_model", weights,
            "--eval_batch", str(bs), "--device", "cpu"])
    printed = capsys.readouterr().out
    assert printed.count("instance AP:") == 2
    out = outs[1]
    assert out["frames"] == 4 and out["ap"] is not None
    for f in ("results.json", "instance_ap.json", "gtInstances.json"):
        assert os.path.exists(os.path.join(out["save_dir"], f))
    manifests = glob.glob(os.path.join(out["save_dir"], "results", "*.txt"))
    assert len(manifests) == 4
    assert os.listdir(os.path.join(out["save_dir"], "results", "masks"))
    jmeta = JCityscapes(root)
    jmeta.eval_image_size = (128, 256)
    want = jharness.run_instance_eval(
        jmeta, out["results"], str(tmp_path / "jax"),
        annotations=JAnnotations(jmeta.annot_path("val")),
        gt_instance_dir=jmeta.gt_instance_dir())
    with open(os.path.join(out["save_dir"], "instance_ap.json")) as f:
        assert _same(json.load(f), want)
    assert _same(outs[3]["ap"], out["ap"])
    for img_id, per in out["results"].items():
        for cls, rows in per.items():
            np.testing.assert_allclose(outs[3]["results"][img_id][cls], rows,
                                       rtol=0, atol=1e-3)
