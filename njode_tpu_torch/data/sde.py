"""Vectorized PyTorch samplers for the synthetic SDE stock models.

The port's copy of ``njode_tpu/data/sde.py``: BlackScholes,
OrnsteinUhlenbeck, Heston, HestonWOFeller (log-Euler, with the variance as
extra observed dimensions under ``return_vol``), their ``sine_*`` aliases
and the regime-switching ``Combined`` model. Every model simulates all
paths at once: one ``randn`` draw for the whole grid from an explicit
``torch.Generator``, then a loop over the time steps on the generator's
device. The random streams differ from JAX's, so the port is checked
against the JAX samplers by moments, not bit for bit.

Conventions kept from the reference:
- drift terms evaluate the periodic (sine) coefficient at the *previous*
  step time ``(k-1)*dt``,
- the Heston spot diffusion uses the *current*-step variance,
- returned paths have shape ``[nb_paths, dimension, nb_steps+1]``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch


def periodic_coeff(sine_coeff: Optional[float]) -> Callable:
    """Time-periodic drift multiplier (1 when ``sine_coeff`` is None)."""
    if sine_coeff is None:
        return lambda t: torch.ones_like(t) if isinstance(t, torch.Tensor) \
            else 1.0
    return lambda t: 1.0 + (torch.sin(sine_coeff * t)
                            if isinstance(t, torch.Tensor)
                            else math.sin(sine_coeff * t))


@dataclasses.dataclass(frozen=True)
class SDEModel:
    """Base for synthetic models: simulation + closed-form conditional exp.

    ``next_cond_exp(y, dt, t_prev)`` is one step of the closed-form
    conditional expectation on tensors (see data/oracle.py)."""

    drift: Optional[float] = None
    volatility: Optional[float] = None
    mean: Optional[float] = None
    speed: Optional[float] = None
    correlation: Optional[float] = None
    nb_paths: int = 10_000
    nb_steps: int = 100
    S0: float = 1.0
    maturity: float = 1.0
    dimension: int = 1
    sine_coeff: Optional[float] = None

    @property
    def dt(self) -> float:
        return self.maturity / self.nb_steps

    def next_cond_exp(self, y, dt, t_prev):
        raise NotImplementedError

    def generate_paths(self, generator: torch.Generator, start_X=None):
        raise NotImplementedError

    def _init_state(self, start_X, device):
        """Simulation dimensionality follows ``np.size(S0)``."""
        if start_X is None:
            s0 = torch.as_tensor(np.asarray(self.S0, np.float32).reshape(-1),
                                 device=device)
            return s0.expand(self.nb_paths, s0.numel()).clone()
        return torch.as_tensor(start_X, dtype=torch.float32, device=device)

    def _normals(self, generator, shape):
        return torch.randn(shape, generator=generator,
                           device=generator.device, dtype=torch.float32)


def _stack_path(x0, steps):
    """[P, D] start + list of K [P, D] states -> [P, D, K+1]."""
    return torch.stack([x0] + steps, dim=2)


@dataclasses.dataclass(frozen=True)
class BlackScholes(SDEModel):
    """GBM: dS = mu*pc(t)*S dt + sigma*S dW."""

    def next_cond_exp(self, y, dt, t_prev):
        pc = periodic_coeff(self.sine_coeff)(t_prev)
        return y * torch.exp(self.drift * pc * dt)

    def generate_paths(self, generator, start_X=None):
        dt = self.dt
        pc = periodic_coeff(self.sine_coeff)
        x = self._init_state(start_X, generator.device)
        dW = self._normals(generator, (self.nb_steps,) + tuple(x.shape)) \
            * np.sqrt(dt)
        x0, steps = x, []
        for k in range(1, self.nb_steps + 1):
            t_prev = (k - 1) * dt
            x = x + self.drift * pc(t_prev) * x * dt \
                + self.volatility * x * dW[k - 1]
            steps.append(x)
        return _stack_path(x0, steps), dt


@dataclasses.dataclass(frozen=True)
class OrnsteinUhlenbeck(SDEModel):
    """OU: dX = -speed*pc(t)*(X-mean) dt + vol dW."""

    def next_cond_exp(self, y, dt, t_prev):
        pc = periodic_coeff(self.sine_coeff)(t_prev)
        exp_delta = torch.exp(-self.speed * pc * dt)
        return y * exp_delta + self.mean * (1.0 - exp_delta)

    def generate_paths(self, generator, start_X=None):
        dt = self.dt
        pc = periodic_coeff(self.sine_coeff)
        x = self._init_state(start_X, generator.device)
        dW = self._normals(generator, (self.nb_steps,) + tuple(x.shape)) \
            * np.sqrt(dt)
        x0, steps = x, []
        for k in range(1, self.nb_steps + 1):
            t_prev = (k - 1) * dt
            x = x - self.speed * pc(t_prev) * (x - self.mean) * dt \
                + self.volatility * dW[k - 1]
            steps.append(x)
        return _stack_path(x0, steps), dt


@dataclasses.dataclass(frozen=True)
class Heston(SDEModel):
    """Heston stochastic-volatility model; the spot diffusion uses the
    current-step variance (reference quirk). The conditional expectation
    of the spot is the Black-Scholes exponential-drift formula."""

    def next_cond_exp(self, y, dt, t_prev):
        pc = periodic_coeff(self.sine_coeff)(t_prev)
        return y * torch.exp(self.drift * pc * dt)

    def generate_paths(self, generator, start_X=None):
        dt = self.dt
        pc = periodic_coeff(self.sine_coeff)
        s = self._init_state(start_X, generator.device)
        v = torch.full_like(s, float(self.mean))
        n = self._normals(generator, (self.nb_steps, 2) + tuple(s.shape))
        s0, steps = s, []
        rho = self.correlation
        for k in range(1, self.nb_steps + 1):
            n1, n2 = n[k - 1, 0], n[k - 1, 1]
            dW = n1 * np.sqrt(dt)
            dZ = (rho * n1 + np.sqrt(1.0 - rho ** 2) * n2) * np.sqrt(dt)
            v = v - self.speed * (v - self.mean) * dt \
                + self.volatility * torch.sqrt(v) * dZ
            t_prev = (k - 1) * dt
            s = s + self.drift * pc(t_prev) * s * dt + torch.sqrt(v) * s * dW
            steps.append(s)
        return _stack_path(s0, steps), dt


@dataclasses.dataclass(frozen=True)
class HestonWOFeller(SDEModel):
    """Heston via log-Euler, valid without the Feller condition: the
    variance enters the drift and diffusion as ``max(v, 0)``.
    ``return_vol`` appends the variance as extra observed dimensions, whose
    conditional expectation is the OU-style mean reversion."""

    scheme: str = "euler"
    return_vol: bool = False
    v0: Optional[float] = None

    @property
    def _v0(self):
        return self.mean if self.v0 is None else self.v0

    def next_cond_exp(self, y, dt, t_prev):
        pc = periodic_coeff(self.sine_coeff)(t_prev)
        if self.return_vol:
            s, v = y.split(y.shape[-1] // 2, dim=-1)
            s = s * torch.exp(self.drift * pc * dt)
            exp_delta = torch.exp(-self.speed * dt)
            v = v * exp_delta + self.mean * (1.0 - exp_delta)
            return torch.cat([s, v], dim=-1)
        return y * torch.exp(self.drift * pc * dt)

    def generate_paths(self, generator, start_X=None):
        if self.scheme != "euler":
            raise ValueError("unknown sampling scheme")
        dt = self.dt
        pc = periodic_coeff(self.sine_coeff)
        s0 = self._init_state(start_X, generator.device)
        v = torch.full_like(s0, float(self._v0))
        n = self._normals(generator, (self.nb_steps, 2) + tuple(s0.shape))
        logs = torch.log(s0)
        spot, var = [torch.exp(logs)], [v]
        rho = self.correlation
        for k in range(1, self.nb_steps + 1):
            n1, n2 = n[k - 1, 0], n[k - 1, 1]
            dW = n1 * np.sqrt(dt)
            dZ = (rho * n1 + np.sqrt(1.0 - rho ** 2) * n2) * np.sqrt(dt)
            vp = torch.clamp(v, min=0.0)
            t_prev = (k - 1) * dt
            logs = logs + (self.drift * pc(t_prev) - 0.5 * vp) * dt \
                + torch.sqrt(vp) * dW
            v = v - self.speed * (vp - self.mean) * dt \
                + self.volatility * torch.sqrt(vp) * dZ
            spot.append(torch.exp(logs))
            var.append(v)
        spot, var = torch.stack(spot, dim=2), torch.stack(var, dim=2)
        if self.return_vol:
            return torch.cat([spot, var], dim=1), dt
        return spot, dt


@dataclasses.dataclass(frozen=True)
class Combined:
    """Regime-switching model chaining several SDE models in time: regime
    ``i`` runs from the end of regime ``i-1`` for its own maturity."""

    stock_model_names: Sequence[str]
    hyperparam_dicts: Sequence[dict]

    def submodels(self):
        return [make_model(n, hp) for n, hp in
                zip(self.stock_model_names, self.hyperparam_dicts)]

    def boundaries(self):
        """Absolute end time of each regime."""
        ends, t = [], 0.0
        for hp in self.hyperparam_dicts:
            t += hp["maturity"]
            ends.append(t)
        return np.asarray(ends)

    def next_cond_exp(self, y, dt, t_prev):
        """Piecewise conditional-expectation step: the regime whose window
        holds ``t_prev``."""
        subs = self.submodels()
        ends = self.boundaries()
        out = subs[0].next_cond_exp(y, dt, t_prev)
        for i in range(1, len(subs)):
            nxt = subs[i].next_cond_exp(y, dt, t_prev)
            later = torch.as_tensor(t_prev >= float(ends[i - 1]) - 1e-12,
                                    device=out.device)
            out = torch.where(later, nxt, out)
        return out

    def generate_paths(self, generator, start_X=None):
        """Each regime starts from the previous one's last state; all draw
        from ``generator`` in turn."""
        subs = self.submodels()
        paths, dt = subs[0].generate_paths(generator, start_X=start_X)
        for sub in subs[1:]:
            p, dt_i = sub.generate_paths(generator, start_X=paths[:, :, -1])
            if abs(dt_i - dt) >= 1e-12:
                raise ValueError("all regimes must share dt")
            paths = torch.cat([paths, p[:, :, 1:]], dim=2)
        return paths, dt


_MODEL_CLASSES = {
    "BlackScholes": BlackScholes,
    "Heston": Heston,
    "OrnsteinUhlenbeck": OrnsteinUhlenbeck,
    "HestonWOFeller": HestonWOFeller,
    # the sine behaviour comes from the `sine_coeff` hyperparameter
    "sine_BlackScholes": BlackScholes,
    "sine_Heston": Heston,
    "sine_OrnsteinUhlenbeck": OrnsteinUhlenbeck,
}

_FIELD_NAMES = {
    "drift", "volatility", "mean", "speed", "correlation", "nb_paths",
    "nb_steps", "S0", "maturity", "dimension", "sine_coeff",
}
_WOF_EXTRA = {"scheme", "return_vol", "v0"}


def make_model(name: str, hyperparams: dict):
    """Instantiate a model from its registry name + hyperparameter dict,
    tolerating extra keys in the dict (a name outside the registry raises
    ``KeyError``)."""
    if name == "combined":
        return Combined(stock_model_names=hyperparams["stock_model_names"],
                        hyperparam_dicts=hyperparams["hyperparam_dicts"])
    cls = _MODEL_CLASSES[name]
    allowed = set(_FIELD_NAMES)
    if cls is HestonWOFeller:
        allowed |= _WOF_EXTRA
    kwargs = {k: v for k, v in hyperparams.items() if k in allowed}
    return cls(**kwargs)


STOCK_MODELS = dict(_MODEL_CLASSES)
STOCK_MODELS["combined"] = Combined


def draw_path_heston(hyperparams=None, n_paths: int = 10, seed: int = 0,
                     save_path=None):
    """Debug plot of simulated Heston paths; returns the saved filename."""
    return draw_stock_model("Heston", hyperparams, n_paths, seed, save_path)


def draw_stock_model(name: str = "BlackScholes", hyperparams=None,
                     n_paths: int = 10, seed: int = 0, save_path=None):
    """Debug plot of ``n_paths`` simulated paths (first dimension) of a
    model, simulated on the CPU from ``seed``; returns the saved filename.
    Needs matplotlib, imported here."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    hp = dict(hyperparams or {})
    hp.setdefault("drift", 2.0)
    hp.setdefault("volatility", 0.3)
    hp.setdefault("mean", 4.0)
    hp.setdefault("speed", 2.0)
    hp.setdefault("correlation", 0.5)
    hp.setdefault("nb_steps", 100)
    hp.setdefault("S0", 1.0)
    hp.setdefault("maturity", 1.0)
    hp.setdefault("dimension", 1)
    hp["nb_paths"] = n_paths
    model = make_model(name, hp)
    paths, dt = model.generate_paths(torch.Generator().manual_seed(seed))
    paths = paths.numpy()
    ts = np.arange(paths.shape[2]) * dt
    plt.figure()
    for i in range(paths.shape[0]):
        plt.plot(ts, paths[i, 0])
    plt.xlabel("$t$")
    plt.title(name)
    out = save_path or f"{name}_drawn_paths.pdf"
    plt.savefig(out, bbox_inches="tight")
    plt.close()
    return out
