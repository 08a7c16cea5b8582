"""Reference-format NJODE checkpoints (``checkpt.tar`` = ``{epoch, weight,
model_state_dict, optimizer_state_dict}``, the reference's
``models.save_checkpoint`` layout), the port's copy of
``njode_tpu/training/torch_compat.py``.

The port's ``NJODE`` keeps the reference's module names (``ode_f.f.<i>``,
``encoder_map.ffnn.<i>``, ``readout_map.ffnn.<i>``, ``obs_c.gru_d.*``) and
torch's ``[out, in]`` weights, so where the JAX module converts layouts
this one reads and writes the state dicts as they are: an imported
checkpoint's weights load into the model unchanged, and its Adam state
(moments, step, learning rate) into the optimizer, whose parameters are
the model's in the same order.
"""

from __future__ import annotations

import os

import torch

from njode_tpu_torch.training import checkpoints
from njode_tpu_torch.utils.paths import makedirs


def load_torch_checkpoint(path):
    """Read a reference ``checkpt.tar`` (or the directory holding one) onto
    the CPU.

    :return: dict with 'epoch', 'weight', 'state' (the model's state dict)
        and 'optimizer_state' (the optimizer's)
    """
    if os.path.isdir(path):
        path = os.path.join(path, checkpoints.CKPT_FILE)
    ck = torch.load(path, map_location="cpu", weights_only=True)
    return {"epoch": int(ck["epoch"]), "weight": float(ck["weight"]),
            "state": dict(ck["model_state_dict"]),
            "optimizer_state": ck["optimizer_state_dict"]}


def import_torch_checkpoint(torch_ckpt_path, out_dir, model, optimizer):
    """Load a reference checkpoint into ``model`` and ``optimizer`` and
    write it as the port's checkpoint slot ``out_dir``
    (``training/checkpoints.py``), from which the trainers resume.

    :return: (epoch, weight)
    """
    ck = load_torch_checkpoint(torch_ckpt_path)
    model.load_state_dict(ck["state"])
    optimizer.load_state_dict(ck["optimizer_state"])
    checkpoints.save_checkpoint(out_dir, model, optimizer, ck["epoch"],
                                ck["weight"])
    return ck["epoch"], ck["weight"]


def export_torch_checkpoint(model, out_dir, epoch, weight, optimizer=None,
                            learning_rate: float = 1e-3):
    """Write a reference-format ``checkpt.tar`` of ``model`` (on the CPU)
    into ``out_dir``, so the reference code can resume or evaluate a model
    trained here; the optimizer's state where one is given, else a fresh
    torch Adam (L2 5e-4) over the exported tensors, as the JAX module
    writes. :return: the file's path."""
    state = {k: v.detach().cpu().clone() for k, v in
             model.state_dict().items()}
    if optimizer is None:
        optimizer = torch.optim.Adam(list(state.values()), lr=learning_rate,
                                     weight_decay=0.0005)
    makedirs(out_dir)
    out = os.path.join(out_dir, checkpoints.CKPT_FILE)
    torch.save({"epoch": int(epoch), "weight": float(weight),
                "model_state_dict": state,
                "optimizer_state_dict": optimizer.state_dict()}, out)
    return out
