"""Ensembles of NJODE models trained together on one card, the port's copy
of ``njode_tpu/training/vmap_sweep.py``.

The reference's only parallelism is a process pool over independent runs
(``parallel_train.py:214-224``); a small net at batch <= 200 leaves most
of an H100 idle. Same-architecture runs (the convergence study's repeats,
``parallel_train.py:292-351``) train here as one ensemble: a step runs K1
and K2 once each over a member axis (``fused_scan.
make_fused_members_loss_fn``) on a supported config on the card, each
member on its own batch order, its own dropout stream and its own Adam.
Architectures that differ only in their MLP widths train together too,
zero-padded to the width-wise maximum (:func:`init_hetero_ensemble`): the
padding is exact, so a padded member trains as its small net would.

Member e's streams: weights from ``torch.manual_seed(seeds[e])``, the
shuffle ``RandomState(seeds[e] * 100_003 + epoch + 1_000_033 *
shuffle_seed)``, and one ``torch.Generator`` an epoch seeded
``(seeds[e] + 10_000) * 100_003 + epoch`` for its dropout masks.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from njode_tpu_torch.models import mlp, njode
from njode_tpu_torch.training import group_common
from njode_tpu_torch.training.steps import gather_dense_batch, \
    make_optimizer


def init_ensemble(cfg: njode.NJODEConfig, seeds, device="cuda"):
    """One ``NJODE`` per seed, each initialised under
    ``torch.manual_seed(seed)`` (the solo trainer's init)."""
    models = []
    for s in seeds:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(int(s))
            models.append(njode.NJODE(cfg).to(device))
    return models


def _pad_net(small, big):
    """Copy the Linear layers of MLP ``small`` into the top-left corners of
    ``big``'s (zero elsewhere)."""
    with torch.no_grad():
        for ls, lb in zip(mlp.linears(small), mlp.linears(big)):
            lb.weight.zero_()
            lb.weight[:ls.weight.shape[0], :ls.weight.shape[1]] = ls.weight
            if lb.bias is not None:
                lb.bias.zero_()
                lb.bias[:ls.bias.shape[0]] = ls.bias


def hetero_super_config(cfgs):
    """The width-wise maximum of configurations that differ ONLY in their
    MLP layer widths (same input/hidden/output sizes, depths, activations,
    residual/masked/bias flags)."""
    c0 = cfgs[0]
    for c in cfgs[1:]:
        same = (c.input_size == c0.input_size
                and c.hidden_size == c0.hidden_size
                and c.output_size == c0.output_size
                and c.use_rnn == c0.use_rnn and c.bias == c0.bias
                and c.dropout_rate == c0.dropout_rate
                and c.which_loss == c0.which_loss
                and c.residual_enc_dec == c0.residual_enc_dec
                and c.input_current_t == c0.input_current_t
                and c.masked == c0.masked
                and all(len(a) == len(b) and
                        all(x[1] == y[1] for x, y in zip(a, b))
                        for a, b in ((c.ode_nn, c0.ode_nn),
                                     (c.enc_nn, c0.enc_nn),
                                     (c.readout_nn, c0.readout_nn))))
        if not same:
            raise ValueError(
                "heterogeneous ensembles support differing MLP widths only "
                "(same sizes/depths/activations/flags)")

    def wmax(get):
        nns = [get(c) for c in cfgs]
        return tuple((max(nn[i][0] for nn in nns), nns[0][i][1])
                     for i in range(len(nns[0])))

    return dataclasses.replace(c0, ode_nn=wmax(lambda c: c.ode_nn),
                               enc_nn=wmax(lambda c: c.enc_nn),
                               readout_nn=wmax(lambda c: c.readout_nn))


def init_hetero_ensemble(cfgs, seeds, device="cuda"):
    """Models of DIFFERENT widths trained together (the convergence study's
    network_size axis at a fixed hidden size, ``parallel_train.py:
    304-305``): each member initialised with ITS OWN widths, then
    zero-padded to the ensemble's width-wise maximum architecture. The
    padding is exact: a padded unit's activation is ``act(0) = 0`` and its
    outgoing weights are 0, so the forward is the small net's; every
    gradient to a padded entry is a product with one of those zeros, hence
    0, so Adam and its L2 decay keep them at 0 (with dropout the masks are
    drawn at the ensemble width: the same distribution, another stream).

    :return: (cfg_super, models)
    """
    cfg_big = hetero_super_config(list(cfgs))
    out = []
    for cfg, s in zip(cfgs, seeds):
        small = init_ensemble(cfg, [s], device)[0]
        big = njode.NJODE(cfg_big).to(device)
        for a, b in ((small.ode_f.f, big.ode_f.f),
                     (small.encoder_map.ffnn, big.encoder_map.ffnn),
                     (small.readout_map.ffnn, big.readout_map.ffnn)):
            _pad_net(a, b)
        if cfg.use_rnn:      # width-independent (input and hidden sizes)
            big.obs_c.load_state_dict(small.obs_c.state_dict())
        out.append(big)
    return cfg_big, out


def make_ensemble_step_fns(models, optimizers, times, dts,
                           use_kernels=False, mask_mode="prng"):
    """``train_epoch(paths, obs, idx_mats, weight, generators)``:
    ``idx_mats [E, n_batches, B]``, one step a batch for all members;
    returns the last batch's losses ``[E]``. ``eval_losses(paths, obs,
    idx, weight)``: each member's loss on the rows ``idx`` (eager, no
    dropout), ``[E]``."""
    step = group_common.make_group_step(models, optimizers, use_kernels,
                                        mask_mode)
    everyone = list(range(len(models)))

    def train_epoch(paths, obs, idx_mats, weight, generators):
        loss = None
        for j in range(idx_mats.shape[1]):
            batches = [gather_dense_batch(paths, obs, idx_mats[e, j], times,
                                          dts) for e in everyone]
            loss = step(batches, weight, generators, everyone)
        return loss

    def eval_losses(paths, obs, idx, weight):
        batch = gather_dense_batch(paths, obs, idx, times, dts)
        with torch.no_grad():
            return torch.stack([njode.forward(m, batch, weight=weight,
                                              train=False)[1]
                                for m in models])

    return {"train_epoch": train_epoch, "eval_losses": eval_losses}


def train_ensemble(cfg, paths, observed, delta_t, train_idx, val_idx, seeds,
                   epochs=10, batch_size=20, learning_rate=1e-3, weight=0.5,
                   weight_decay=1.0, shuffle_seed=0, cfgs=None,
                   device="cuda", use_kernels=None, mask_mode="prng"):
    """Train ``len(seeds)`` models together.

    Same architecture by default; pass ``cfgs`` (one per seed, differing
    only in MLP widths) to train a heterogeneous ensemble, zero-padded to
    the width-wise super-architecture (:func:`init_hetero_ensemble`): one
    config, so the member-axis kernels take it too.

    :param paths/observed: full dataset arrays ([N, D, T+1] / [N, T+1])
    :param use_kernels: the member-axis kernels (default: on CUDA for a
        supported config; their plain versions on the CPU)
    :return: dict with the 'models', per-epoch 'train_losses' [epochs, E]
        (last batch, the reference's convention) and 'eval_losses'
        [epochs, E]
    """
    from njode_tpu_torch.ops import fused_scan
    device = torch.device(device)
    E = len(seeds)
    K = paths.shape[2] - 1
    times = torch.as_tensor((np.arange(1, K + 1) * delta_t)
                            .astype(np.float32), device=device)
    dts = torch.full((K,), delta_t, dtype=torch.float32, device=device)
    if cfgs is not None:
        assert len(cfgs) == E
        cfg, models = init_hetero_ensemble(cfgs, seeds, device)
    else:
        models = init_ensemble(cfg, seeds, device)
    if use_kernels is None:
        use_kernels = fused_scan._is_cuda(device) and fused_scan.supported(
            cfg)
    optimizers = [make_optimizer(m.parameters(), learning_rate)
                  for m in models]
    fns = make_ensemble_step_fns(models, optimizers, times, dts,
                                 use_kernels, mask_mode)
    d_paths = torch.as_tensor(np.asarray(paths, np.float32), device=device)
    d_obs = torch.as_tensor(np.asarray(observed, np.float32), device=device)
    train_idx = np.asarray(train_idx)
    val = torch.as_tensor(np.asarray(val_idx, np.int64), device=device)
    n_full = (len(train_idx) // batch_size) * batch_size
    if n_full == 0:
        raise ValueError(f"training set ({len(train_idx)}) smaller than "
                         f"batch_size={batch_size}")
    cur_weight = float(weight)
    train_hist, eval_hist = [], []
    for epoch in range(1, epochs + 1):
        idx_mats = torch.as_tensor(np.stack([
            np.random.RandomState(
                int(s) * 100_003 + epoch + 1_000_033 * int(shuffle_seed))
            .permutation(train_idx)[:n_full].reshape(-1, batch_size)
            for s in seeds]).astype(np.int64), device=device)
        gens = [torch.Generator(device=device).manual_seed(
            (int(s) + 10_000) * 100_003 + epoch) for s in seeds]
        last = fns["train_epoch"](d_paths, d_obs, idx_mats, cur_weight, gens)
        ev = fns["eval_losses"](d_paths, d_obs, val, cur_weight)
        train_hist.append(last.cpu().numpy())
        eval_hist.append(ev.cpu().numpy())
        cur_weight = float(njode.weight_decay_step(cur_weight, weight_decay))
    return {"models": models, "train_losses": np.stack(train_hist),
            "eval_losses": np.stack(eval_hist)}
