"""What the benchmark takes from the port (centerpoly_tpu_torch): its
Config, its detector and its training step, built from a configuration's
file, and its DCN launch counter.  Nothing else of the port is read."""
from __future__ import annotations

import dataclasses

import torch


def config(conf: dict, mode: str):
    """The port's Config of a configuration's file for `mode` ("serve" or
    "train"): every key of the file, and then of its `mode` part, that
    names a Config field, with `mixed_precision` from the part's
    `precision`."""
    from centerpoly_tpu_torch.configs import Config
    fields = {f.name for f in dataclasses.fields(Config)}
    part = conf[mode]
    kw = {k: v for k, v in conf.items() if k in fields}
    kw.update((k, v) for k, v in part.items() if k in fields)
    if "test_scales" in kw:
        kw["test_scales"] = tuple(kw["test_scales"])
    return Config(**kw, mixed_precision=part["precision"] == "bfloat16")


def detector(conf: dict, state_dict: dict, device):
    """`create_detector` of the serving configuration with these
    weights."""
    from centerpoly_tpu_torch.infer.detector import create_detector
    return create_detector(config(conf, "serve"), variables=state_dict,
                           device=device)


def train_step(conf: dict, state_dict: dict, device):
    """(train state, train_step) of the training configuration: the model
    as the port's Trainer builds it, with these weights, Adam on it
    (`create_train_state`) and `make_train_step` with the task's loss in
    the configuration's precision.  The caller sets TF32 as the
    configuration states (harness/tf32.py) around each step."""
    from centerpoly_tpu_torch.models import create_model
    from centerpoly_tpu_torch.train.state import create_train_state
    from centerpoly_tpu_torch.train.step import (loss_fn_for_task,
                                                 make_train_step)
    from centerpoly_tpu_torch.train.trainer import loss_config_for
    cfg = config(conf, "train")
    model = create_model(cfg.arch, cfg.heads, cfg.head_conv,
                         dcn_kernel=cfg.dcn_kernel)
    model.load_state_dict(state_dict)
    fmt = (torch.channels_last if torch.device(device).type == "cuda"
           else torch.contiguous_format)
    model.to(device, memory_format=fmt)
    state = create_train_state(model, base_lr=cfg.lr, lr_steps=cfg.lr_step)
    dtype = (torch.bfloat16 if conf["train"]["precision"] == "bfloat16"
             else torch.float32)
    return state, make_train_step(loss_config_for(cfg),
                                  loss_fn_for_task(cfg.task), dtype)


def dcn_launches() -> int:
    """DCN kernel launches so far in this process, every mode."""
    from centerpoly_tpu_torch.kernels import dcn
    return sum(dcn.launches.values())
