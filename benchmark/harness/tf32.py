"""PyTorch's TF32 switches (cuDNN's convolutions, matrix products) set
for a block and put back after: the training configuration's own
setting around each of the program's steps, and off for the
reference."""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def switch(enabled: bool):
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
