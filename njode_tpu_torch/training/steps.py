"""Training and evaluation step functions, the port's copy of
``njode_tpu/training/steps.py``.

Synthetic data (:func:`make_step_fns`): the dataset lives on the device; a
step receives a batch index vector, gathers the batch and builds the dense
GridBatch on the device. Real data (:func:`make_grid_step_fns`,
:func:`make_sparse_step_fns`, :func:`make_prestacked_step_fns`): a step
receives a dense GridBatch, a :class:`~njode_tpu_torch.data.grid.SparseBatch`
of events scattered on the device, or batch rows of a pre-stacked event
bank resident on the device. Forward and backward run through the fused
CUDA kernels (``ops/fused_scan.py``) when ``use_kernels``, else the eager
``models.njode.forward``; evaluation and prediction stay on the eager
forward, as the JAX package's stay on the XLA scan. Step functions return
device tensors and never synchronise, so an epoch queues all its steps
before the host reads a loss; ``train_epochs`` queues several epochs with
their evaluations and per-epoch snapshots the same way (the JAX package
runs them as one device program).

With a ``mesh`` (``parallel.sharding.Mesh``) every rank builds the global
batch, draws the global dropout masks and trains on its block of the rows;
a step reduces the flat gradient (and the loss) over the ranks in one
collective and then takes the same Adam step everywhere (NJODE's loss, a
batch mean, is averaged; see ``sharding.allreduce_grads``). Evaluation
runs each rank's block and reduces the loss (and gathers a real-data
prediction path), so every rank returns the global values. Under a 2-D
``sharding.Mesh2D`` the eager steps run the MLPs tensor-parallel over its
'model' axis (``parallel/tensor_parallel.py``) and do all of the above over
its 'data' axis.
"""

from __future__ import annotations

import torch

from njode_tpu_torch.data.grid import GridBatch, densify_sparse, \
    scatter_events
from njode_tpu_torch.models import njode
from njode_tpu_torch.parallel import sharding, tensor_parallel
from njode_tpu_torch.training.checkpoints import snapshot
from njode_tpu_torch.utils import profiling


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
                  mask_mode: str = "prng", mesh=None):
    """Step functions for a fixed grid.

    :param times/dts: [K] float32 grid tensors on the model's device
    :param use_kernels: run the training and eval losses through the fused
        CUDA kernels (a supported config; on CPU tensors the kernels' plain
        versions run)
    :param mask_mode: dropout-mask source of the kernels ('prng' = Philox
        inside the kernels; 'input' = a drawn [K,S,B,Wmax] mask tensor)
    :param mesh: data-parallel ``parallel.sharding.Mesh`` (see the module
        docstring); the training batches' rows must divide by its size.
        ``eval_msd`` and ``pred_path`` run on the whole batch on every rank.
        A ``sharding.Mesh2D`` (data x model) runs tensor parallelism too,
        on the eager forward (``use_kernels`` False, as the JAX package's
        tensor parallelism runs its XLA scan): ``model`` (and
        ``optimizer``'s state) cut by ``sharding.shard_model`` first
    :return: dict of functions; those taking ``generator`` draw dropout
        masks from it
    """
    cfg = model.cfg
    mesh = tensor_parallel.step_mesh(model, mesh, use_kernels)
    step = _step(optimizer, _train_loss(model, use_kernels, mask_mode, mesh),
                 mesh)
    if use_kernels:
        from njode_tpu_torch.ops import fused_scan
        fused_eval = fused_scan.make_fused_eval_fn(cfg, mesh=mesh)

        def _eval_loss(batch, weight):
            return fused_eval(model, batch, weight)
    else:
        def _eval_loss(batch, weight):
            B = batch.start_X.shape[0]
            if mesh is not None:
                batch = sharding.shard_batch(batch, mesh)
            with torch.no_grad():
                _, loss = njode.forward(model, batch, weight=weight,
                                        train=False)
            return loss if mesh is None else sharding.batch_mean(loss, mesh,
                                                                 B)

    def _batch(paths, obs, idx):
        return gather_dense_batch(paths, obs, idx, times, dts)

    def train_step(paths, obs, idx, weight, generator):
        """One optimizer step on batch rows ``idx``; returns the loss."""
        return step(_batch(paths, obs, idx), weight, generator)

    def train_epoch(paths, obs, idx_mat, weight, generator):
        """One step per row of ``idx_mat [n_batches, B]``; returns the
        per-batch losses ``[n_batches]``."""
        return torch.stack([train_step(paths, obs, idx, weight, generator)
                            for idx in idx_mat])

    def eval_loss(paths, obs, idx, weight):
        return _eval_loss(_batch(paths, obs, idx), weight)

    fns = {"train_step": train_step, "train_epoch": train_epoch,
           "eval_loss": eval_loss}
    msd = None
    if next_cond_exp is not None:
        def msd(batch):
            return njode.evaluate(model, batch, next_cond_exp)

        def eval_msd(paths, obs, idx):
            return msd(_batch(paths, obs, idx))

        fns["eval_msd"] = eval_msd
    fns["train_epochs"] = make_train_epochs(model, optimizer, train_epoch,
                                            _batch, _eval_loss, msd)

    def pred_path(paths, obs, idx):
        return njode.get_pred(model, _batch(paths, obs, idx))

    fns["pred_path"] = pred_path
    return fns


def make_train_epochs(model, optimizer, train_epoch, batch, eval_loss,
                      msd=None):
    """``train_epochs`` of a model's synthetic-data step functions, the
    port's counterpart of the JAX ``train_epochs``:

    ``train_epochs(paths, obs, idx_mats, weights, generators, val_paths,
    val_obs, val_idx, do_msd) -> (train_last [N], eval_losses [N],
    eval_msds [N], params_hist, opt_hist)``

    For each of the N epochs: ``train_epoch`` over ``idx_mats[j]`` with
    loss weight ``weights[j]`` (N host floats: a kernel's call
    configuration is built from each) and ``generators[j]``; the
    validation loss on the batch ``val_idx`` of ``val_paths/val_obs``,
    gathered once for the call, and with ``do_msd`` the oracle's mean
    squared difference (``msd``; 0 without one); then a snapshot of the
    model's and the optimizer's state dicts
    (:func:`~njode_tpu_torch.training.checkpoints.snapshot`). The model and
    optimizer are updated in place, where the JAX function donates them.
    Nothing is read back to the host between the first step and the
    return (the oracle difference aside): the results are device tensors
    the caller reads when it needs them.

    :param batch: ``(paths, obs, idx) -> GridBatch``
    :param eval_loss: ``(batch, weight) -> loss``, without gradients
    :param msd: ``batch -> mean squared difference`` or None
    """

    def train_epochs(paths, obs, idx_mats, weights, generators, val_paths,
                     val_obs, val_idx, do_msd):
        val_batch = batch(val_paths, val_obs, val_idx)
        no_msd = torch.zeros((), dtype=torch.float32, device=paths.device)
        tl, ev, ms, p_hist, o_hist = [], [], [], [], []
        for idx_mat, weight, gen in zip(idx_mats, weights, generators):
            tl.append(train_epoch(paths, obs, idx_mat, weight, gen)[-1])
            ev.append(eval_loss(val_batch, weight))
            ms.append(msd(val_batch) if do_msd and msd is not None
                      else no_msd)
            p, o = snapshot(model, optimizer)
            p_hist.append(p)
            o_hist.append(o)
        return (torch.stack(tl), torch.stack(ev), torch.stack(ms), p_hist,
                o_hist)

    return train_epochs


def _index_batch(stack, i):
    """Batch ``i`` of a batch whose fields carry a leading batch axis."""
    return type(stack)(*(f[i] for f in stack))


def _train_loss(model, use_kernels, mask_mode, mesh=None):
    """The training loss ``(batch, weight, generator) -> loss``: through
    the fused CUDA kernels when ``use_kernels`` (their plain versions on CPU
    tensors), else the eager forward. With a ``mesh``: this rank's loss
    over its block of the global batch's rows, from the global masks."""
    if use_kernels:
        from njode_tpu_torch.ops import fused_scan
        fused = fused_scan.make_fused_loss_fn(model.cfg, mask_mode=mask_mode,
                                              mesh=mesh)
        return lambda batch, weight, generator: fused(model, batch, weight,
                                                      generator, True)
    if mesh is None:
        return lambda batch, weight, generator: njode.forward(
            model, batch, weight=weight, train=True, generator=generator)[1]
    cfg = model.cfg
    dropping = cfg.dropout_rate > 0.0 and any(njode.dropout_slots(cfg)[:3])

    def loss(batch, weight, generator):
        K, B = batch.obs.shape
        sharding.check_divisible(B, mesh)
        masks = None
        if dropping:
            u0, u = njode.draw_masks(cfg, K, B, generator,
                                     batch.start_X.device)
            masks = (sharding.shard_rows(u0, mesh, 1),
                     sharding.shard_rows(u, mesh, 2))
        return njode.forward(model, sharding.shard_batch(batch, mesh),
                             weight=weight, train=True, drop_masks=masks)[1]

    return loss


def _step(optimizer, train_loss, mesh=None, op="mean"):
    """One optimizer step on a GridBatch; returns the loss times
    ``loss_scale``. With a ``mesh`` the gradients and the loss are reduced
    over the ranks (``op``, see ``sharding.allreduce_grads``) before the
    step; under anomaly detection (``utils/profiling.py``) a non-finite
    loss or gradient raises before it."""

    def step(batch, weight, generator, loss_scale=1.0):
        optimizer.zero_grad(set_to_none=True)
        loss = train_loss(batch, weight, generator) * loss_scale
        loss.backward()
        if mesh is not None:
            loss = sharding.allreduce_grads(
                [p for g in optimizer.param_groups for p in g["params"]],
                mesh, op, loss)
        profiling.check_step(loss, (p for g in optimizer.param_groups
                                    for p in g["params"]))
        optimizer.step()
        return loss.detach()

    return step


def make_grid_step_fns(model: njode.NJODE, optimizer, sparse: bool = False,
                       use_kernels: bool = False, mask_mode: str = "prng",
                       mesh=None):
    """Step functions for the real-data trainers (the JAX function's dict).

    ``sparse=False``: steps take a dense :class:`GridBatch` of tensors;
    ``sparse=True``: a SparseBatch of tensors, densified on its device
    (``grid.densify_sparse``). ``loss_scale`` keeps the reference's
    1/batch_size normalisation under padded batch rows. ``train_epoch``
    takes a batch whose fields carry a leading [n_batches] axis and one
    ``torch.Generator`` per batch.

    :param use_kernels: the training loss through the fused CUDA kernels
        (a supported config; their plain versions on CPU tensors)
    :param mask_mode: the kernels' dropout-mask source ('prng' or 'input')
    :param mesh: data-parallel ``parallel.sharding.Mesh`` (module
        docstring); the batches' rows must divide by its size
    """
    prep = densify_sparse if sparse else (lambda b: b)
    mesh = tensor_parallel.step_mesh(model, mesh, use_kernels)
    step = _step(optimizer, _train_loss(model, use_kernels, mask_mode, mesh),
                 mesh)

    def train_step(b, weight, generator, loss_scale=1.0):
        """One optimizer step; returns the scaled loss."""
        return step(prep(b), weight, generator, loss_scale)

    def train_epoch(b_stack, weight, generators, loss_scales):
        return torch.stack([
            train_step(_index_batch(b_stack, i), weight, gen, ls)
            for i, (gen, ls) in enumerate(zip(generators, loss_scales))])

    def forward(batch, weight, get_loss):
        _, loss, (y0, y_pre, _) = njode.forward(
            model, batch, weight=weight, train=False, get_loss=get_loss,
            return_path=True)
        return loss, torch.cat([y0[None], y_pre], dim=0)

    return real_data_fns(forward, prep, train_step, train_epoch, mesh=mesh)


def make_sparse_step_fns(model: njode.NJODE, optimizer,
                         use_kernels: bool = False, mask_mode: str = "prng",
                         mesh=None):
    """SparseBatch step functions (see :func:`make_grid_step_fns`)."""
    return make_grid_step_fns(model, optimizer, sparse=True,
                              use_kernels=use_kernels, mask_mode=mask_mode,
                              mesh=mesh)


def real_data_fns(forward, prep, train_step, train_epoch,
                  scale_loss: bool = True, mesh=None):
    """The real-data step functions' dict; its evaluation half runs one
    eager ``forward(batch, weight, get_loss) -> (loss, path [K+1, B, D])``
    (the pre-jump path, t=0 first) without gradients and gathers the
    held-out points on the device. ``scale_loss=False``: the evaluation
    losses ignore ``loss_scale`` (a loss that is a sum over
    observations). With a ``mesh`` each rank runs ``forward`` on its block
    of the rows; the loss is reduced (the batch mean, or with
    ``scale_loss=False`` the sum) and the path gathered, so every rank
    computes the metrics of the whole batch."""

    def _forward(b, weight=0.5, get_loss=True):
        with torch.no_grad():
            batch = prep(b)
            if mesh is None:
                return forward(batch, weight, get_loss)
            B = batch.start_X.shape[0]
            loss, path = forward(sharding.shard_batch(batch, mesh), weight,
                                 get_loss)
            if get_loss:
                loss = (sharding.batch_mean(loss, mesh, B) if scale_loss
                        else sharding.all_reduce(loss, mesh))
            return loss, sharding.gather_rows(path, mesh, B, dim=1)

    def _scaled(loss, loss_scale):
        return loss * loss_scale if scale_loss else loss

    def eval_loss(b, weight, loss_scale=1.0):
        return _scaled(_forward(b, weight)[0], loss_scale)

    def pred_prejump(b):
        pred = _forward(b, get_loss=False)[1]
        return pred[0], pred[1:]

    def heldout_mse(b, k_idx, row_idx, x_val, m_val):
        p = _forward(b, get_loss=False)[1][k_idx, row_idx]
        return torch.sum(((x_val - p) ** 2) * m_val), torch.sum(m_val)

    def pred_at(b, k_idx):
        return _forward(b, get_loss=False)[1][k_idx]

    def eval_loss_and_heldout_mse(b, k_idx, row_idx, x_val, m_val, weight,
                                  loss_scale=1.0):
        loss, pred = _forward(b, weight)
        p = pred[k_idx, row_idx]
        return (_scaled(loss, loss_scale),
                torch.sum(((x_val - p) ** 2) * m_val), torch.sum(m_val))

    def eval_loss_and_pred_at(b, k_idx, weight, loss_scale=1.0):
        loss, pred = _forward(b, weight)
        return _scaled(loss, loss_scale), pred[k_idx]

    def eval_loss_and_masked_metrics(b, k_idx, x_val, m_val, weight,
                                     loss_scale=1.0):
        """The PhysioNet evaluation on the device: the loss, the masked
        squared-error sum and mask count at the held-out points
        (``x_val/m_val [B, L, D]`` against the pre-jump prediction at grid
        steps ``k_idx [L]``), and the latent-ODE per-(patient, dim)
        metric (``physionet.compute_masked_likelihood_mse``)."""
        loss, pred = _forward(b, weight)
        B = x_val.shape[0]
        p = pred[k_idx][:, :B].permute(1, 0, 2)             # [B, L, D]
        err = ((x_val - p) ** 2) * m_val
        cnt_bd = m_val.sum(dim=1)                           # [B, D]
        se_bd = err.sum(dim=1)
        per = torch.where(cnt_bd > 0, se_bd / cnt_bd.clamp_min(1.0),
                          torch.zeros_like(se_bd))
        return (_scaled(loss, loss_scale), err.sum(), m_val.sum(),
                per.mean())

    return {"train_step": train_step, "train_epoch": train_epoch,
            "eval_loss": eval_loss, "pred_prejump": pred_prejump,
            "heldout_mse": heldout_mse, "pred_at": pred_at,
            "eval_loss_and_heldout_mse": eval_loss_and_heldout_mse,
            "eval_loss_and_pred_at": eval_loss_and_pred_at,
            "eval_loss_and_masked_metrics": eval_loss_and_masked_metrics}


def prestacked_batch(k_all, X_all, M_all, idx, times, dts) -> GridBatch:
    """One batch from a pre-stacked event bank on the device: gather rows
    ``idx`` of ``k [N, E]`` (grid step per event, K = padding; row N the
    all-padding sentinel) and ``X, M [N, E, D]``, and scatter them onto the
    grid. ``start_X = 0``, the real-data trainers' convention."""
    K = times.shape[0]
    idx = idx.long()
    k = k_all.index_select(0, idx)                    # [B, E]
    Xe = X_all.index_select(0, idx)                   # [B, E, D]
    Me = M_all.index_select(0, idx)
    B, E = k.shape
    row = torch.arange(B, device=k.device).view(B, 1).expand(B, E)
    obs, X, M = scatter_events(k, row, Xe, Me, K, B)
    return GridBatch(times=times, dt=dts, obs=obs, X=X, M=M,
                     start_X=torch.zeros((B, Xe.shape[-1]),
                                         dtype=torch.float32,
                                         device=k.device),
                     n_obs_ot=obs.sum(dim=0))


def make_prestacked_step_fns(model: njode.NJODE, optimizer, times, dts,
                             use_kernels: bool = False,
                             mask_mode: str = "prng", mesh=None):
    """Training steps over a pre-stacked event bank resident on the device
    (``k_all [N+1, E]``, ``X_all/M_all [N+1, E, D]``, e.g. from
    ``climate.prestack_series`` with a sentinel row N appended): a batch is
    a gather and a scatter on the device, so an epoch ships only its
    ``[n_batches, B]`` index matrix. Pad a short batch with row N and scale
    its loss with ``loss_scale``.

    ``train_step(k_all, X_all, M_all, idx, weight, generator, loss_scale)``
    and ``train_epoch(k_all, X_all, M_all, idx_mat, weight, generators,
    loss_scales)``. With a ``mesh`` (module docstring) each rank trains on
    its block of every batch's rows."""
    mesh = tensor_parallel.step_mesh(model, mesh, use_kernels)
    step = _step(optimizer, _train_loss(model, use_kernels, mask_mode, mesh),
                 mesh)

    def train_step(k_all, X_all, M_all, idx, weight, generator,
                   loss_scale=1.0):
        return step(prestacked_batch(k_all, X_all, M_all, idx, times, dts),
                    weight, generator, loss_scale)

    def train_epoch(k_all, X_all, M_all, idx_mat, weight, generators,
                    loss_scales):
        return torch.stack([
            train_step(k_all, X_all, M_all, idx, weight, gen, ls)
            for idx, gen, ls in zip(idx_mat, generators, loss_scales)])

    return {"train_step": train_step, "train_epoch": train_epoch}
