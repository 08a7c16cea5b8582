"""Feed-forward network primitives, the port's copy of ``njode_tpu/models/mlp.py``.

- :func:`get_ffnn` builds the reference's ``Linear [act, Dropout, Linear]*``
  ``nn.Sequential``, so the Linear layers sit at indices 0, 3, 6, ... and the
  ``state_dict`` keys are the reference's (``ode_f.f.0.weight``, ...);
  weights are Xavier-uniform, biases zero.
- :func:`ffnn_apply` runs such a Sequential functionally, with dropout given
  as explicit keep-masks (one ``[rows, >=width]`` bool tensor per hidden
  layer) so the NJODE scan, its kernels and the tests share one mask stream.
- :class:`FFNN` is the reference's class-FFNN wrapper: tanh on the input,
  optional mask concat (doubles the input), optional residual skip (identity
  tiled when out >= in, mean of chunks when in > out).
- :class:`GRUJump` holds a ``torch.nn.GRUCell`` with its default init (the
  reference's Xavier init only touches ``nn.Linear``).

Mixed precision (``compute_dtype='bfloat16'``, the JAX package's
``dot_dtype``): every Linear product and both GRU products round their two
operands to bfloat16 and sum the products in float32 (:func:`bf16_matmul`);
biases, activations, carries and gradients stay float32. As in the JAX
package's transposed dots, the gradient of each operand is the float32
product of the cotangent with the other rounded operand, itself rounded to
bfloat16. On a CUDA tensor the products run on the tensor cores as
``torch.mm(a, b, out_dtype=torch.float32)`` with bfloat16 ``a`` and ``b``:
in the backward the float32 cotangent is rounded to bfloat16 too, as the
JAX package's TPU dots round a float32 operand at their default precision.
On the CPU, as the JAX package's CPU dots do, the rounded operands are
widened to float32 and the cotangent stays float32. The tests hold the CPU
route to ``jax.grad``; ``chip_smoke.py`` holds the card's gradients to the
CPU with the card's rounding.
:data:`BF16_ROUTES` counts the calls of each route.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

_ACT_MODULES = {"tanh": nn.Tanh, "relu": nn.ReLU}

# calls of each route of the bfloat16 product (see the module docstring)
BF16_ROUTES = {"cuda: torch.mm(bf16, bf16, out_dtype=float32)": 0,
               "cpu: float32 mm of the bf16-rounded operands": 0}
_CUDA_ROUTE, _CPU_ROUTE = tuple(BF16_ROUTES)


def _mm_bf16(a, b):
    """``a [n, k] @ b [k, m]`` -> float32, ``b`` bfloat16, ``a`` float32 or
    bfloat16: bfloat16 operands, float32 sums."""
    if a.is_cuda:
        BF16_ROUTES[_CUDA_ROUTE] += 1
        return torch.mm(a.to(torch.bfloat16), b, out_dtype=torch.float32)
    BF16_ROUTES[_CPU_ROUTE] += 1
    return a.float() @ b.float()


def round_bf16(x):
    return x.to(torch.bfloat16).float()


class _BF16Matmul(torch.autograd.Function):
    """``x [..., in] @ w.T`` for a torch-layout ``w [out, in]``, both
    rounded to bfloat16, float32 result and float32 gradients (each
    rounded to bfloat16, as the JAX package's transposed dots are; ``x``'s
    left unrounded where ``round_gx`` is False, for a caller that sums
    partial gradients first and rounds the sum)."""

    @staticmethod
    def forward(ctx, x, w, round_gx=True):
        xb = x.reshape(-1, x.shape[-1]).to(torch.bfloat16)
        wb = w.to(torch.bfloat16)
        ctx.save_for_backward(xb, wb)
        ctx.x_shape, ctx.round_gx = x.shape, round_gx
        return _mm_bf16(xb, wb.t()).reshape(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, g):
        xb, wb = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1]).float()
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = _mm_bf16(g2, wb)
            gx = (round_bf16(gx) if ctx.round_gx else gx).reshape(
                ctx.x_shape)
        if ctx.needs_input_grad[1]:
            gw = round_bf16(_mm_bf16(g2.t(), xb))
        return gx, gw, None


def bf16_matmul(x, w, round_gx: bool = True):
    """The mixed-precision product ``x @ w.T`` (``w [out, in]``);
    ``round_gx``: see :class:`_BF16Matmul`."""
    return _BF16Matmul.apply(x, w, round_gx)


def linear(lin: nn.Linear, x, bf16: bool = False):
    """``lin(x)``, or its mixed-precision form (bias added in float32)."""
    if not bf16:
        return lin(x)
    y = bf16_matmul(x, lin.weight)
    return y if lin.bias is None else y + lin.bias


def act_fn(name: str, x):
    return torch.tanh(x) if name == "tanh" else torch.relu(x)


def get_ffnn(input_size: int, output_size: int,
             nn_desc: Optional[Sequence[Tuple[int, str]]],
             dropout_rate: float = 0.0, bias: bool = True) -> nn.Sequential:
    """``Linear [act, Dropout, Linear]*`` with Xavier-uniform weights and
    zero biases."""
    widths = [input_size] + [int(w) for w, _ in (nn_desc or ())] \
        + [output_size]
    layers = [nn.Linear(widths[0], widths[1], bias=bias)]
    for i, (_, act) in enumerate(nn_desc or ()):
        layers += [_ACT_MODULES[act](), nn.Dropout(dropout_rate),
                   nn.Linear(widths[i + 1], widths[i + 2], bias=bias)]
    seq = nn.Sequential(*layers)
    for m in seq:
        if isinstance(m, nn.Linear):
            nn.init.xavier_uniform_(m.weight)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
    return seq


def linears(seq: nn.Sequential):
    """The Linear layers of a :func:`get_ffnn` Sequential, in order."""
    return [m for m in seq if isinstance(m, nn.Linear)]


def ffnn_apply(seq: nn.Sequential, x, acts: Sequence[str], rate: float = 0.0,
               keep_masks=None, bf16: bool = False):
    """Linear, then per hidden layer [act, dropout, Linear].

    ``keep_masks``: None (no dropout) or one bool tensor per hidden layer,
    ``[rows, W >= width]``, sliced to the layer's width; kept units are
    scaled by ``1/(1-rate)``. ``bf16``: the mixed-precision products. A
    Sequential cut by ``parallel.sharding.shard_model`` carries a
    ``tp_plan``, which runs it tensor-parallel.
    """
    plan = getattr(seq, "tp_plan", None)
    if plan is not None:
        return plan.apply(seq, x, acts, rate, keep_masks, bf16)
    lins = linears(seq)
    y = linear(lins[0], x, bf16)
    keep = 1.0 - rate
    for i, name in enumerate(acts):
        y = act_fn(name, y)
        if keep_masks is not None and rate > 0.0:
            y = torch.where(keep_masks[i][..., :y.shape[-1]], y / keep,
                            torch.zeros_like(y))
        y = linear(lins[i + 1], y, bf16)
    return y


def residual_case(input_size: int, output_size: int, residual: bool):
    """Residual wiring of class FFNN: returns (case, mult) with case 0=no
    skip, 1=tile input, 2=mean chunks."""
    if not residual:
        return 0, 1
    if input_size <= output_size:
        if output_size % input_size != 0:
            raise ValueError(
                "for residual: output_size needs to be multiple of input_size")
        return 1, output_size // input_size
    if input_size % output_size != 0:
        raise ValueError(
            "for residual: input_size needs to be multiple of output_size")
    return 2, input_size // output_size


def residual_apply(case: int, mult: int, x_raw, out):
    if case == 0:
        return out
    if case == 1:
        return x_raw.repeat(*((1,) * (x_raw.dim() - 1) + (mult,))) + out
    chunks = torch.stack(torch.chunk(x_raw, mult, dim=-1), dim=0)
    return chunks.mean(dim=0) + out


class FFNN(nn.Module):
    """Class-FFNN semantics: tanh(input) [concat mask], MLP, skip. The MLP
    is the ``ffnn`` attribute (reference key ``<name>.ffnn.<i>``)."""

    def __init__(self, input_size, output_size, nn_desc, dropout_rate=0.0,
                 bias=True, residual=True, masked=False, bf16=False):
        super().__init__()
        self.masked = masked
        self.bf16 = bf16
        self.acts = tuple(a for _, a in (nn_desc or ()))
        self.rate = float(dropout_rate)
        self.case, self.mult = residual_case(input_size, output_size,
                                             residual)
        in_size = 2 * input_size if masked else input_size
        self.ffnn = get_ffnn(in_size, output_size, nn_desc, dropout_rate,
                             bias)

    def forward(self, x, mask=None, keep_masks=None):
        inp = torch.tanh(x)
        if self.masked:
            inp = torch.cat([inp, mask], dim=-1)
        out = ffnn_apply(self.ffnn, inp, self.acts, self.rate, keep_masks,
                         self.bf16)
        return residual_apply(self.case, self.mult, x, out)


class ODEFunc(nn.Module):
    """The ODE vector field: ``f`` is the MLP (reference key
    ``ode_f.f.<i>``) on ``[tanh x, tanh h, tau, t-tau(, t)]``."""

    def __init__(self, input_size, nn_desc, dropout_rate=0.0, bias=True,
                 hidden_size=10, bf16=False):
        super().__init__()
        self.bf16 = bf16
        self.acts = tuple(a for _, a in (nn_desc or ()))
        self.rate = float(dropout_rate)
        self.f = get_ffnn(input_size, hidden_size, nn_desc, dropout_rate,
                          bias)

    def forward(self, inp, keep_masks=None):
        return ffnn_apply(self.f, inp, self.acts, self.rate, keep_masks,
                          self.bf16)


class GRUJump(nn.Module):
    """The ``use_rnn`` jump cell (reference key ``obs_c.gru_d.*``)."""

    def __init__(self, input_size, hidden_size, bias=True, bf16=False):
        super().__init__()
        self.bf16 = bf16
        self.gru_d = nn.GRUCell(input_size, hidden_size, bias=bias)

    def forward(self, x, h):
        if not self.bf16:
            return self.gru_d(x, h)
        # torch's GRUCell (gates r, z, n) on the mixed-precision products
        c = self.gru_d
        gi = bf16_matmul(x, c.weight_ih)
        gh = bf16_matmul(h, c.weight_hh)
        if c.bias:
            gi, gh = gi + c.bias_ih, gh + c.bias_hh
        i_r, i_z, i_n = gi.chunk(3, dim=-1)
        h_r, h_z, h_n = gh.chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        return (1.0 - z) * n + z * h


def count_params(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())
