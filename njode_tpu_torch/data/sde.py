"""Vectorized PyTorch samplers for the synthetic SDE stock models.

The port's copy of ``njode_tpu/data/sde.py`` for the three models the demo
accepts (BlackScholes, OrnsteinUhlenbeck, Heston). Every model simulates all
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
from typing import Callable, Optional

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


_MODEL_CLASSES = {
    "BlackScholes": BlackScholes,
    "Heston": Heston,
    "OrnsteinUhlenbeck": OrnsteinUhlenbeck,
}

_FIELD_NAMES = {
    "drift", "volatility", "mean", "speed", "correlation", "nb_paths",
    "nb_steps", "S0", "maturity", "dimension", "sine_coeff",
}


def make_model(name: str, hyperparams: dict):
    """Instantiate a model from its registry name + hyperparameter dict,
    tolerating extra keys in the dict."""
    if name not in _MODEL_CLASSES:
        raise NotImplementedError(
            f"SDE model '{name}' is not ported yet (ROADMAP.md Queue 1 item "
            "2: HestonWOFeller, the sine_* aliases and 'combined')")
    cls = _MODEL_CLASSES[name]
    kwargs = {k: v for k, v in hyperparams.items() if k in _FIELD_NAMES}
    return cls(**kwargs)
