"""Carry NJODE weights between the JAX package's pytree and this package.

The JAX package keeps its parameters as a pytree of arrays
``{"ode_f": [{"w", "b"}, ...], "encoder": [...], "readout": [...],
"gru": {"w_ih", "w_hh", "b_ih", "b_hh"}}`` with Linear weights ``[in, out]``;
this package keeps them in an ``nn.Module`` whose ``state_dict`` uses the
reference's names (``ode_f.f.<i>``, ``encoder_map.ffnn.<i>``,
``readout_map.ffnn.<i>``, ``obs_c.gru_d.*``) and torch's ``[out, in]``.
Both directions work on numpy arrays, so neither side imports the other.
"""

from __future__ import annotations

import re
from collections import OrderedDict, defaultdict

import numpy as np
import torch

_PREFIX = {"ode_f": "ode_f.f", "encoder": "encoder_map.ffnn",
           "readout": "readout_map.ffnn"}
_GRU = {"w_ih": "weight_ih", "w_hh": "weight_hh", "b_ih": "bias_ih",
        "b_hh": "bias_hh"}


def state_dict_from_jax_params(params_np) -> "OrderedDict[str, torch.Tensor]":
    """JAX pytree (numpy leaves) -> ``state_dict``. ``get_ffnn`` puts the
    Linear layers at Sequential indices 0, 3, 6, ..."""
    sd = OrderedDict()
    for name, pfx in _PREFIX.items():
        for j, layer in enumerate(params_np[name]):
            sd[f"{pfx}.{3 * j}.weight"] = torch.tensor(
                np.ascontiguousarray(np.asarray(layer["w"], np.float32).T))
            if "b" in layer:
                sd[f"{pfx}.{3 * j}.bias"] = torch.tensor(
                    np.asarray(layer["b"], np.float32).copy())
    if "gru" in params_np:
        for jk, tk in _GRU.items():
            if jk in params_np["gru"]:
                a = np.asarray(params_np["gru"][jk], np.float32)
                sd[f"obs_c.gru_d.{tk}"] = torch.tensor(
                    np.ascontiguousarray(a.T if a.ndim == 2 else a))
    return sd


def jax_params_from_state_dict(sd):
    """``state_dict`` -> JAX pytree of numpy arrays (inverse of
    :func:`state_dict_from_jax_params`)."""
    state = {k: v.detach().cpu().numpy() for k, v in sd.items()}
    params = {}
    for name, pfx in _PREFIX.items():
        layers = defaultdict(dict)
        pat = re.compile(rf"^{re.escape(pfx)}\.(\d+)\.(weight|bias)$")
        for key, arr in state.items():
            m = pat.match(key)
            if not m:
                continue
            idx = int(m.group(1))
            if m.group(2) == "weight":
                layers[idx]["w"] = np.ascontiguousarray(arr.T)
            else:
                layers[idx]["b"] = arr.copy()
        params[name] = [layers[i] for i in sorted(layers)]
    gru = {}
    for jk, tk in _GRU.items():
        key = f"obs_c.gru_d.{tk}"
        if key in state:
            a = state[key]
            gru[jk] = np.ascontiguousarray(a.T if a.ndim == 2 else a)
    if gru:
        params["gru"] = gru
    return params
