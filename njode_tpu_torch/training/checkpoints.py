"""Checkpoint save/restore with the reference's last/best two-slot layout.

A slot directory holds ``checkpt.tar``: the reference's dict
``{epoch, weight, model_state_dict, optimizer_state_dict}`` written with
``torch.save``, so training resumes at the exact point (including the
loss-weight decay position) and the reference codebase reads it too.
Writes go to a temporary file that is fsynced and renamed, so a kill
mid-write leaves the slot's previous checkpoint intact."""

from __future__ import annotations

import os

import torch

from njode_tpu_torch.utils.paths import makedirs

CKPT_FILE = "checkpt.tar"


def save_checkpoint(path, model, optimizer, epoch, weight):
    makedirs(path)
    final = os.path.join(path, CKPT_FILE)
    tmp = final + ".tmp"
    with open(tmp, "wb") as f:
        torch.save({"epoch": int(epoch), "weight": float(weight),
                    "model_state_dict": model.state_dict(),
                    "optimizer_state_dict": optimizer.state_dict()}, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)


def load_checkpoint(path, model, optimizer, device=None):
    """Restore into ``model`` and ``optimizer``; returns (epoch, weight)."""
    ckpt = os.path.join(path, CKPT_FILE)
    if not os.path.exists(ckpt):
        raise FileNotFoundError(f"Checkpoint {ckpt} does not exist.")
    state = torch.load(ckpt, map_location=device, weights_only=True)
    model.load_state_dict(state["model_state_dict"])
    optimizer.load_state_dict(state["optimizer_state_dict"])
    return state["epoch"], state["weight"]
