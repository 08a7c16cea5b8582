"""Checkpoint save/restore with the reference's last/best two-slot layout.

A slot directory holds ``checkpt.tar``: the reference's dict
``{epoch, weight, model_state_dict, optimizer_state_dict}`` written with
``torch.save``, so training resumes at the exact point (including the
loss-weight decay position) and the reference codebase reads it too.
Writes go to a temporary file that is fsynced and renamed, so a kill
mid-write leaves the slot's previous checkpoint intact. A checkpoint is
written from the live model and optimizer (:func:`save_checkpoint`) or from
a :func:`snapshot` of them taken earlier (:func:`save_state`), as the
multi-epoch loop keeps one per epoch."""

from __future__ import annotations

import os

import torch

from njode_tpu_torch.utils.paths import makedirs

CKPT_FILE = "checkpt.tar"


def _clone(obj):
    """``obj`` with every tensor in it cloned (dicts, lists and tuples
    rebuilt in their own type, a state dict's ``_metadata`` kept, other
    values shared)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().clone()
    if isinstance(obj, dict):
        out = type(obj)((k, _clone(v)) for k, v in obj.items())
        if hasattr(obj, "_metadata"):
            out._metadata = obj._metadata
        return out
    if isinstance(obj, (list, tuple)):
        return type(obj)(_clone(v) for v in obj)
    return obj


def snapshot(model, optimizer):
    """``(model state dict, optimizer state dict)`` as copies: both
    ``state_dict()`` calls return the live tensors (Adam's moments and its
    step, a CPU tensor), which later steps overwrite in place. The copies
    are made where the tensors live, so on the card nothing is read back
    to the host."""
    return _clone(model.state_dict()), _clone(optimizer.state_dict())


def save_state(path, model_state, optimizer_state, epoch, weight):
    """Write a checkpoint from a model and an optimizer state dict."""
    makedirs(path)
    final = os.path.join(path, CKPT_FILE)
    tmp = final + ".tmp"
    with open(tmp, "wb") as f:
        torch.save({"epoch": int(epoch), "weight": float(weight),
                    "model_state_dict": model_state,
                    "optimizer_state_dict": optimizer_state}, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)


def save_checkpoint(path, model, optimizer, epoch, weight):
    save_state(path, model.state_dict(), optimizer.state_dict(), epoch,
               weight)


def load_checkpoint(path, model, optimizer, device=None):
    """Restore into ``model`` and ``optimizer``; returns (epoch, weight)."""
    ckpt = os.path.join(path, CKPT_FILE)
    if not os.path.exists(ckpt):
        raise FileNotFoundError(f"Checkpoint {ckpt} does not exist.")
    state = torch.load(ckpt, map_location=device, weights_only=True)
    model.load_state_dict(state["model_state_dict"])
    optimizer.load_state_dict(state["optimizer_state_dict"])
    return state["epoch"], state["weight"]
