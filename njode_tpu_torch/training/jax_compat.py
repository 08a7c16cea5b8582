"""Carry NJODE and GRU-ODE-Bayes weights between the JAX package's pytree
and this package.

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


# ---------------------------------------------------------------------------
# GRU-ODE-Bayes
# ---------------------------------------------------------------------------

_GOB_MLPS = {"p_model": "p_model", "cov_map": "covariates_map",
             "class_model": "classification_model"}


def _t(a):
    a = np.asarray(a, np.float32)
    return torch.tensor(np.ascontiguousarray(a.T if a.ndim == 2 else a))


def _np(t):
    a = t.detach().cpu().numpy()
    return np.ascontiguousarray(a.T if a.ndim == 2 else a)


def gob_state_dict_from_jax_params(params_np):
    """GRU-ODE-Bayes pytree (numpy leaves) -> the ``state_dict`` of
    ``models.gru_ode_bayes.GOB``, under the reference's names: the two-layer
    MLPs at Sequential indices 0 and 3 (``p_model``, ``covariates_map``,
    ``classification_model``), ``gru_c.lin_*`` (or ``gru_c.weight_ih`` ...
    for the discretized cell), ``gru_obs.gru_d.*``, ``gru_obs.w_prep``,
    ``gru_obs.bias_prep``. Linear ``[in, out]`` becomes ``[out, in]``; the
    GRU cells' ``w_ih [in, 3H]`` becomes ``weight_ih [3H, in]`` (gates r, z,
    n); ``w_prep`` and ``bias_prep`` keep their shapes."""
    sd = OrderedDict()

    def lin(prefix, p):
        sd[prefix + ".weight"] = _t(p["w"])
        if "b" in p:
            sd[prefix + ".bias"] = _t(p["b"])

    def gru(prefix, p):
        for jk, tk in _GRU.items():
            if jk in p:
                sd[f"{prefix}.{tk}"] = _t(p[jk])

    for jname, tname in _GOB_MLPS.items():
        for j, layer in enumerate(params_np[jname]):
            lin(f"{tname}.{3 * j}", layer)
    g = params_np["gru_c"]
    if "cell" in g:
        gru("gru_c", g["cell"])
    else:
        for name, p in g.items():
            lin(f"gru_c.{name}", p)
    ob = params_np["gru_obs"]
    gru("gru_obs.gru_d", ob["gru"])
    sd["gru_obs.w_prep"] = torch.tensor(np.asarray(ob["w_prep"], np.float32))
    sd["gru_obs.bias_prep"] = torch.tensor(
        np.asarray(ob["bias_prep"], np.float32))
    return sd


def gob_jax_params_from_state_dict(sd):
    """``state_dict`` of a ``GOB`` -> the JAX pytree of numpy arrays
    (inverse of :func:`gob_state_dict_from_jax_params`)."""
    params = {}
    for jname, tname in _GOB_MLPS.items():
        layers = defaultdict(dict)
        pat = re.compile(rf"^{re.escape(tname)}\.(\d+)\.(weight|bias)$")
        for key, t in sd.items():
            m = pat.match(key)
            if m:
                layers[int(m.group(1))]["w" if m.group(2) == "weight"
                                        else "b"] = _np(t)
        params[jname] = [layers[i] for i in sorted(layers)]
    inv = {v: k for k, v in _GRU.items()}
    if "gru_c.weight_ih" in sd:
        params["gru_c"] = {"cell": {inv[k.split(".", 1)[1]]: _np(t)
                                    for k, t in sd.items()
                                    if k.startswith("gru_c.")}}
    else:
        gc = defaultdict(dict)
        pat = re.compile(r"^gru_c\.(lin_\w+)\.(weight|bias)$")
        for key, t in sd.items():
            m = pat.match(key)
            if m:
                gc[m.group(1)]["w" if m.group(2) == "weight" else "b"] = \
                    _np(t)
        params["gru_c"] = dict(gc)
    params["gru_obs"] = {
        "gru": {inv[k.rsplit(".", 1)[1]]: _np(t) for k, t in sd.items()
                if k.startswith("gru_obs.gru_d.")},
        "w_prep": sd["gru_obs.w_prep"].detach().cpu().numpy().copy(),
        "bias_prep": sd["gru_obs.bias_prep"].detach().cpu().numpy().copy()}
    return params
