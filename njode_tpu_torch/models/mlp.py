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
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

_ACT_MODULES = {"tanh": nn.Tanh, "relu": nn.ReLU}


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
               keep_masks=None):
    """Linear, then per hidden layer [act, dropout, Linear].

    ``keep_masks``: None (no dropout) or one bool tensor per hidden layer,
    ``[rows, W >= width]``, sliced to the layer's width; kept units are
    scaled by ``1/(1-rate)``."""
    lins = linears(seq)
    y = lins[0](x)
    keep = 1.0 - rate
    for i, name in enumerate(acts):
        y = act_fn(name, y)
        if keep_masks is not None and rate > 0.0:
            y = torch.where(keep_masks[i][..., :y.shape[-1]], y / keep,
                            torch.zeros_like(y))
        y = lins[i + 1](y)
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
                 bias=True, residual=True, masked=False):
        super().__init__()
        self.masked = masked
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
        out = ffnn_apply(self.ffnn, inp, self.acts, self.rate, keep_masks)
        return residual_apply(self.case, self.mult, x, out)


class ODEFunc(nn.Module):
    """The ODE vector field: ``f`` is the MLP (reference key
    ``ode_f.f.<i>``) on ``[tanh x, tanh h, tau, t-tau(, t)]``."""

    def __init__(self, input_size, nn_desc, dropout_rate=0.0, bias=True,
                 hidden_size=10):
        super().__init__()
        self.acts = tuple(a for _, a in (nn_desc or ()))
        self.rate = float(dropout_rate)
        self.f = get_ffnn(input_size, hidden_size, nn_desc, dropout_rate,
                          bias)

    def forward(self, inp, keep_masks=None):
        return ffnn_apply(self.f, inp, self.acts, self.rate, keep_masks)


class GRUJump(nn.Module):
    """The ``use_rnn`` jump cell (reference key ``obs_c.gru_d.*``)."""

    def __init__(self, input_size, hidden_size, bias=True):
        super().__init__()
        self.gru_d = nn.GRUCell(input_size, hidden_size, bias=bias)

    def forward(self, x, h):
        return self.gru_d(x, h)


def count_params(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())
