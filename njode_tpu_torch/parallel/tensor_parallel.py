"""The tensor-parallel MLPs of an ``NJODE`` cut by ``sharding.shard_model``:
what GSPMD does for the JAX package's ``njode.forward`` under
``sharding.njode_tp_sharding``, written out over ``torch.distributed``.

Each activation is either replicated over the 'model' ranks or sharded by
columns (rank r holding block r, ``Mesh.rows``):

- a column-parallel layer (output dim sharded) computes ``x @ W_rᵀ + b_r``
  on a replicated input behind :class:`_CopyToModel` (Megatron's *f*: the
  identity forward, an all-reduce of the input's gradient backward); its
  output is sharded;
- a row-parallel layer (input dim sharded) sums the ranks' partial products
  in :class:`_ReduceFromModel` (*g*: an all-reduce forward, the identity
  backward) and adds its replicated bias after the sum; a replicated input
  is first cut to the rank's columns (:class:`_ScatterToModel`, whose
  backward gathers the gradient);
- a replicated layer, and the stack's output (the ODE and encoder outputs
  of width ``hidden_size``, the readout's), need the full input: a sharded
  activation is gathered by an all-reduce of its zero-padded block
  (:class:`_GatherFromModel`; backward: the rank's slice).

Every collective is an ``all_reduce``, so gloo ranks that share one card
can run it. Dropout draws the global ``[rows, W]`` keep-mask on every rank,
as the unsharded run draws it (``njode.draw_masks``), and a sharded
activation keeps its columns of it: at any rate the sharded run is the
unsharded one, up to the order of the row-parallel sums.

Under ``compute_dtype='bfloat16'`` the products are ``mlp.bf16_matmul``'s.
A column-parallel layer's input gradient is a sum over the ranks: each
rank's partial is left in float32 and the sum is rounded to bfloat16
once, so every operand gradient is rounded where the unsharded product
rounds it (the other collectives move whole elements).

The step (``training/steps.py``) reduces the gradients over 'data' only:
the gradient of a shard is its rank's alone, and that of a replicated
parameter is the same on every model rank. Adam with L2 decay works
element by element, so it commutes with the slicing;
:func:`full_state_dict` gathers the shards back."""

from __future__ import annotations

import dataclasses
from collections import OrderedDict

import torch

from njode_tpu_torch.models import mlp
from njode_tpu_torch.parallel import sharding


def _pad_cols(x, width, lo):
    full = x.new_zeros(x.shape[:-1] + (width,))
    full[..., lo:lo + x.shape[-1]] = x
    return full


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over the 'model' ranks (and
    then rounded to bfloat16 where ``bf16``: the sum of the unrounded
    partial gradients of ``mlp.bf16_matmul(..., round_gx=False)`` rounded
    once, as the unsharded product rounds its own)."""

    @staticmethod
    def forward(ctx, x, mesh, bf16=False):
        ctx.mesh, ctx.bf16 = mesh, bf16
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = sharding.all_reduce(g, ctx.mesh)
        return (mlp.round_bf16(g) if ctx.bf16 else g), None, None


class _ReduceFromModel(torch.autograd.Function):
    """The partial products summed over the 'model' ranks; identity
    backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        return sharding.all_reduce(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    """A column block to the full ``width`` (zero-padded, summed over the
    'model' ranks); backward: the rank's columns of the gradient."""

    @staticmethod
    def forward(ctx, x, mesh, width):
        ctx.lo, ctx.hi = mesh.rows(width)
        return sharding.all_reduce(_pad_cols(x, width, ctx.lo), mesh)

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.lo:ctx.hi].contiguous(), None, None


class _ScatterToModel(torch.autograd.Function):
    """The rank's columns of a replicated activation; backward: the
    gradient's block gathered to the full width."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.width = mesh, x.shape[-1]
        lo, hi = mesh.rows(ctx.width)
        ctx.lo = lo
        return x[..., lo:hi].contiguous()

    @staticmethod
    def backward(ctx, g):
        return sharding.all_reduce(_pad_cols(g, ctx.width, ctx.lo),
                                   ctx.mesh), None


@dataclasses.dataclass(frozen=True)
class TPPlan:
    """How one MLP stack runs sharded: each Linear's kind ('col', 'row' or
    'rep') and the full width of each activation ``(in, hidden..., out)``,
    over the 'model' mesh."""
    kinds: tuple
    widths: tuple
    mesh: sharding.Mesh

    @classmethod
    def of(cls, seq, layer_specs, mesh):
        """The plan of the ``get_ffnn`` Sequential ``seq`` (unsharded) under
        its ``sharding.ffnn_tp_specs``."""
        lins = mlp.linears(seq)
        kinds = tuple("rep" if not s["w"] else
                      "col" if s["w"][0] is None else "row"
                      for s in layer_specs)
        widths = (lins[0].in_features,) + tuple(m.out_features
                                                for m in lins)
        return cls(kinds, widths, mesh)

    def apply(self, seq, x, acts, rate=0.0, keep_masks=None, bf16=False):
        """:func:`ffnn_apply` under this plan (``models/mlp.ffnn_apply``
        calls it for a Sequential that carries one)."""
        return ffnn_apply(seq, self, x, acts, rate, keep_masks, bf16)


def ffnn_apply(seq, plan: TPPlan, x, acts, rate=0.0, keep_masks=None,
               bf16=False):
    """``mlp.ffnn_apply`` on this rank's shards of ``seq``: the full output
    on every 'model' rank (module docstring)."""
    mesh = plan.mesh
    lins = mlp.linears(seq)
    keep = 1.0 - rate
    y = x
    sharded = False
    for i, lin in enumerate(lins):
        if i:
            y = mlp.act_fn(acts[i - 1], y)
            if keep_masks is not None and rate > 0.0:
                m = keep_masks[i - 1][..., :plan.widths[i]]
                if sharded:
                    lo, hi = mesh.rows(plan.widths[i])
                    m = m[..., lo:hi]
                y = torch.where(m, y / keep, torch.zeros_like(y))
        kind = plan.kinds[i]
        if kind == "row":
            if not sharded:
                y = _ScatterToModel.apply(y, mesh)
            y = _ReduceFromModel.apply(
                mlp.bf16_matmul(y, lin.weight) if bf16
                else torch.nn.functional.linear(y, lin.weight), mesh)
            if lin.bias is not None:
                y = y + lin.bias
            sharded = False
            continue
        if sharded:
            y = _GatherFromModel.apply(y, mesh, plan.widths[i])
        if kind == "col":
            y = _CopyToModel.apply(y, mesh, bf16)
            if bf16:
                y = mlp.bf16_matmul(y, lin.weight, round_gx=False)
                y = y if lin.bias is None else y + lin.bias
            else:
                y = lin(y)
        else:
            y = mlp.linear(lin, y, bf16)
        sharded = kind == "col"
    if sharded:
        y = _GatherFromModel.apply(y, mesh, plan.widths[-1])
    return y


def step_mesh(model, mesh, use_kernels: bool):
    """The mesh a step function reduces over: a 1-D ``Mesh`` (or None) as
    it is; for a ``Mesh2D``, its 'data' axis, after checking that
    ``model`` was cut for it (``sharding.shard_model``). The fused kernels
    take no 2-D mesh: they raise as the JAX package's do."""
    if not isinstance(mesh, sharding.Mesh2D):
        return mesh
    if use_kernels:
        sharding.check_mesh(mesh, "fused kernel sharding")
    tp = getattr(model, "tp", None)
    if tp is None or tp.mesh is not mesh:
        raise ValueError("a 2-D mesh needs the model cut to this rank's "
                         "shards first: parallel.sharding.shard_model("
                         "model, mesh, optimizer)")
    return mesh.data


def full_state_dict(model, tensors=None):
    """The model's ``state_dict`` (or ``tensors``, a ``{name: tensor}`` of
    its parameters' shapes, e.g. their gradients) with every shard
    gathered over the 'model' ranks: the replicated model's, on every
    rank."""
    sd = OrderedDict()
    sub = model.tp.mesh.model
    items = model.state_dict() if tensors is None else tensors
    for name, t in items.items():
        d = sharding.shard_dim(model.tp.specs.get(name, ()),
                               name.endswith("weight"))
        if d is None:
            sd[name] = t.detach().clone()
            continue
        n = t.shape[d] * sub.size
        sd[name] = sharding.gather_rows(t.detach(), sub, n, d)
    return sd
