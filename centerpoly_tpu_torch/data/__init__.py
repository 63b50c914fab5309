"""Training data: annotations, GT encoder, batch loader (host numpy)."""
from .coco_poly import CocoPolyAnnotations  # noqa: F401
from .datasets import (DATASETS, CityscapesMeta, DatasetMeta,  # noqa: F401
                       IDDMeta, KittiPolyMeta)
from .loader import Loader, stack_batch  # noqa: F401
from .sampler import PolydetSampler  # noqa: F401

SAMPLERS = {"polydet": PolydetSampler}
