"""Training and evaluation step functions, the port's copy of the synthetic
part of ``njode_tpu/training/steps.py``.

The dataset lives on the device; a step receives a batch index vector,
gathers the batch, builds the dense GridBatch on the device and runs forward
and backward through the scan: the fused CUDA kernels
(``ops/fused_scan.py``) when ``use_kernels``, else the eager
``models.njode.forward``. Step functions return device tensors and never
synchronise, so an epoch queues all its steps before the host reads a loss.
Running several epochs as one program (the JAX package's ``train_epochs``)
is not ported yet (ROADMAP.md Queue 1 item 3).
"""

from __future__ import annotations

import torch

from njode_tpu_torch.data.grid import GridBatch
from njode_tpu_torch.models import njode


def make_optimizer(params, learning_rate: float,
                   weight_decay: float = 0.0005):
    """Adam with L2 weight decay folded into the gradients
    (``torch.optim.Adam(lr, weight_decay=5e-4)``, the reference's
    optimizer; equal to the JAX package's ``add_decayed_weights`` ->
    ``adam`` chain)."""
    return torch.optim.Adam(params, lr=learning_rate,
                            weight_decay=weight_decay)


def dense_batch(paths_b, obs_b, times, dts) -> GridBatch:
    """GridBatch on the device from ``[B, D, T+1]`` paths and ``[B, T+1]``
    observation indicators (grid-aligned data)."""
    obs_t = obs_b[:, 1:].T.contiguous()                          # [K, B]
    X = (paths_b[:, :, 1:].permute(2, 0, 1) * obs_t[:, :, None]).contiguous()
    M = obs_t[:, :, None].expand_as(X)
    return GridBatch(times=times, dt=dts, obs=obs_t, X=X, M=M,
                     start_X=paths_b[:, :, 0].contiguous(),
                     n_obs_ot=obs_t.sum(dim=0))


def gather_dense_batch(paths, obs, idx, times, dts) -> GridBatch:
    """Gather rows ``idx`` of the device-resident dataset as a GridBatch."""
    return dense_batch(paths.index_select(0, idx), obs.index_select(0, idx),
                       times, dts)


def make_step_fns(model: njode.NJODE, optimizer, times, dts,
                  next_cond_exp=None, use_kernels: bool = False,
                  mask_mode: str = "prng"):
    """Step functions for a fixed grid.

    :param times/dts: [K] float32 grid tensors on the model's device
    :param use_kernels: run the training and eval losses through the fused
        CUDA kernels (a supported config; on CPU tensors the kernels' plain
        versions run)
    :param mask_mode: dropout-mask source of the kernels ('prng' = Philox
        inside the kernels; 'input' = a drawn [K,S,B,Wmax] mask tensor)
    :return: dict of functions; those taking ``generator`` draw dropout
        masks from it
    """
    cfg = model.cfg
    if use_kernels:
        from njode_tpu_torch.ops import fused_scan
        fused = fused_scan.make_fused_loss_fn(cfg, mask_mode=mask_mode)
        fused_eval = fused_scan.make_fused_eval_fn(cfg)

        def _train_loss(batch, weight, generator):
            return fused(model, batch, weight, generator, True)

        def _eval_loss(batch, weight):
            return fused_eval(model, batch, weight)
    else:
        def _train_loss(batch, weight, generator):
            _, loss = njode.forward(model, batch, weight=weight, train=True,
                                    generator=generator)
            return loss

        def _eval_loss(batch, weight):
            with torch.no_grad():
                _, loss = njode.forward(model, batch, weight=weight,
                                        train=False)
            return loss

    def _batch(paths, obs, idx):
        return gather_dense_batch(paths, obs, idx, times, dts)

    def train_step(paths, obs, idx, weight, generator):
        """One optimizer step on batch rows ``idx``; returns the loss."""
        batch = _batch(paths, obs, idx)
        optimizer.zero_grad(set_to_none=True)
        loss = _train_loss(batch, weight, generator)
        loss.backward()
        optimizer.step()
        return loss.detach()

    def train_epoch(paths, obs, idx_mat, weight, generator):
        """One step per row of ``idx_mat [n_batches, B]``; returns the
        per-batch losses ``[n_batches]``."""
        return torch.stack([train_step(paths, obs, idx, weight, generator)
                            for idx in idx_mat])

    def eval_loss(paths, obs, idx, weight):
        return _eval_loss(_batch(paths, obs, idx), weight)

    fns = {"train_step": train_step, "train_epoch": train_epoch,
           "eval_loss": eval_loss}

    if next_cond_exp is not None:
        def eval_msd(paths, obs, idx):
            return njode.evaluate(model, _batch(paths, obs, idx),
                                  next_cond_exp)

        fns["eval_msd"] = eval_msd

    def pred_path(paths, obs, idx):
        return njode.get_pred(model, _batch(paths, obs, idx))

    fns["pred_path"] = pred_path
    return fns
