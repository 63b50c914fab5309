"""Training data: annotations, GT encoder, batch loader (host numpy)."""
from .coco_poly import CocoPolyAnnotations  # noqa: F401
from .ctdet_sampler import CtdetSampler  # noqa: F401
from .ddd_sampler import DddSampler  # noqa: F401
from .exdet_sampler import ExdetSampler  # noqa: F401
from .multi_pose_sampler import MultiPoseSampler  # noqa: F401
from .datasets import (DATASETS, CityscapesMeta, CocoHpMeta,  # noqa: F401
                       CocoMeta, DatasetMeta, IDDMeta, Kitti2dMeta, KittiMeta,
                       KittiPolyMeta, PascalMeta, UADetracMeta, UAVMeta)
from .loader import Loader, stack_batch  # noqa: F401
from .sampler import PolydetSampler  # noqa: F401

SAMPLERS = {"polydet": PolydetSampler, "ctdet": CtdetSampler,
            "exdet": ExdetSampler, "multi_pose": MultiPoseSampler,
            "ddd": DddSampler}
