"""AdamW with global-norm clipping and a cosine schedule.

Port of ``repro/optim/adamw.py``.  The state is a dict of tensors on the
parameters' device: ``{"step": int32 [], "mu": {name: float32},
"nu": {name: nu_dtype}, "gnorm": float32 []}``, keyed by parameter name
(``named_parameters()``).  The arithmetic is the reference's, in float32:
clip by the global norm, then bias-corrected moments and decoupled weight
decay, ``nu`` rounded back to ``nu_dtype``.  The schedule, the bias
corrections and the clip scale are float32 tensors as well (the reference
computes them in float32, where Python floats would be float64), so no
step reads a number back to the host.

The reference's train step donates its parameters and state.  Here the
moments are updated in place, and :meth:`AdamW.apply` adds each tensor's
update to its parameter as soon as it is computed, which holds one
tensor's temporaries at a time instead of a whole tree of updates.
:meth:`AdamW.state_specs` shards the moments like the parameters (ZeRO),
and on a mesh the step runs on each rank's shards with the global
gradient norm passed in (``gnorm=``, ``launch/train.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Mapping, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

__all__ = ["AdamW", "cosine_schedule"]


def cosine_schedule(peak_lr: float, warmup_steps: int, total_steps: int,
                    floor: float = 0.1) -> Callable:
    """lr(step): linear warmup to ``peak_lr``, then a cosine down to
    ``floor * peak_lr``; a float32 tensor on ``step``'s device (an int
    step gives one on the CPU)."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * step / max(warmup_steps, 1)
        frac = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0, 1)
        cos = peak_lr * (floor + (1 - floor) * 0.5 *
                         (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup_steps, warm, cos)
    return lr


def _named(params) -> Dict[str, torch.Tensor]:
    """Parameters by name, from a module or a name -> tensor mapping."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Union[float, Callable] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    # second-moment dtype: bf16 halves optimizer memory (beyond-paper lever)
    nu_dtype: str = "float32"

    def init(self, params) -> Dict:
        """Zero moments like ``params`` (a module or a name -> tensor
        mapping), on each parameter's device."""
        named = _named(params)
        dev = next(iter(named.values())).device
        nu_dt = getattr(torch, self.nu_dtype)
        return {
            "step": torch.zeros((), dtype=torch.int32, device=dev),
            "mu": {n: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device) for n, p in named.items()},
            "nu": {n: torch.zeros(p.shape, dtype=nu_dt, device=p.device)
                   for n, p in named.items()},
            "gnorm": torch.zeros((), dtype=torch.float32, device=dev),
        }

    def _lr(self, step: torch.Tensor) -> torch.Tensor:
        if callable(self.lr):
            return self.lr(step)
        return torch.tensor(self.lr, dtype=torch.float32, device=step.device)

    def _scalars(self, grads: Mapping[str, torch.Tensor], state: Dict,
                 gnorm: Optional[torch.Tensor] = None):
        """The step's float32 scalars, on the state's device: (step, global
        gradient norm, clip scale, lr, the two bias corrections).
        ``gnorm`` is the global norm where ``grads`` are shards of it."""
        step = state["step"] + 1
        if gnorm is None:
            gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                   for g in grads.values()))
        scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        t = step.to(torch.float32)
        return (step, gnorm, scale, self._lr(step), 1 - self.b1 ** t,
                1 - self.b2 ** t)

    def _one(self, g, mu, nu, p, scale, lr, bc1, bc2) -> torch.Tensor:
        """One tensor: updates ``mu`` and ``nu`` in place and returns the
        update ``u`` (float32), the reference's ``upd`` op for op."""
        g = g.float() * scale
        mu.mul_(self.b1).add_(g * (1 - self.b1))
        nu_f = nu.float()              # nu itself when it is float32
        nu_f.mul_(self.b2).add_(torch.square(g).mul_(1 - self.b2))
        if nu_f is not nu:
            nu.copy_(nu_f)
        denom = torch.sqrt(nu_f / bc2).add_(self.eps)
        u = (mu / bc1).div_(denom)
        return u.add_(self.weight_decay * p.float()).mul_(-lr)

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor], state: Dict,
               params) -> tuple:
        """The reference's ``update``: returns (updates by name, new state).

        The moments of ``state`` are updated in place (the state is
        donated, as in the train step); the new state holds the same
        moment tensors and a new step and norm."""
        named = _named(params)
        step, gnorm, scale, lr, bc1, bc2 = self._scalars(grads, state)
        updates = {n: self._one(g, state["mu"][n], state["nu"][n], named[n],
                                scale, lr, bc1, bc2)
                   for n, g in grads.items()}
        return updates, {"step": step, "mu": state["mu"], "nu": state["nu"],
                         "gnorm": gnorm}

    @torch.no_grad()
    def apply(self, params, grads: Mapping[str, torch.Tensor],
              state: Dict, gnorm: Optional[torch.Tensor] = None) -> Dict:
        """:meth:`update` and ``p + u`` in one pass, tensor by tensor, in
        place: each parameter takes its update as soon as it is computed
        (``p.add_(u)``, the reference's ``(p + u).astype(p.dtype)`` for
        float32 parameters).  Returns the new state (moments in place)."""
        named = _named(params)
        step, gnorm, scale, lr, bc1, bc2 = self._scalars(grads, state, gnorm)
        for n, g in grads.items():
            p = named[n]
            u = self._one(g, state["mu"][n], state["nu"][n], p, scale, lr,
                          bc1, bc2)
            p.add_(u.to(p.dtype))
        return {"step": step, "mu": state["mu"], "nu": state["nu"],
                "gnorm": gnorm}

    @staticmethod
    def last_grad_norm(state) -> torch.Tensor:
        return state["gnorm"]

    @staticmethod
    def state_specs(param_specs) -> Dict:
        """Optimizer state shards exactly like the parameters (ZeRO)."""
        from ..launch.mesh import P
        return {"step": P(), "mu": param_specs, "nu": param_specs,
                "gnorm": P()}

    # ----------------------------------------------- rounding between runs
    def ratio_bound(self, steps: int) -> float:
        """The largest ``|m| / sqrt(v)`` on the bias-corrected moments
        within ``steps`` steps, for any gradients: by Cauchy-Schwarz on the
        moments' weights, ``sqrt(1 - b2^t) / (1 - b1^t) * (1 - b1) /
        sqrt(1 - b2) * sqrt(sum_{k<t} (b1^2 / b2)^k)`` (1 at t = 1, 1.011
        at t = 10 for b1 = 0.9, b2 = 0.95)."""
        b1, b2, best = self.b1, self.b2, 0.0
        for t in range(1, steps + 1):
            geo = sum((b1 * b1 / b2) ** k for k in range(t))
            best = max(best, math.sqrt(1 - b2 ** t) / (1 - b1 ** t)
                       * (1 - b1) / math.sqrt(1 - b2) * math.sqrt(geo))
        return best

    def rounding_allowance(self, nus: Sequence, mus_a: Sequence,
                           mus_b: Sequence, tol: float) -> np.ndarray:
        """How far two runs of this optimizer may carry a parameter's
        elements apart through the differences of their gradients; the
        port's tests add it to the float32 tolerance on parameters.
        ``nus[t - 1]`` is one run's ``nu`` after step ``t``, ``mus_a`` and
        ``mus_b`` each run's ``mu`` after every step (arrays of one
        parameter).

        Each step's clipped gradients are recovered from consecutive
        moments (``g_t = (mu_t - b1 mu_{t-1}) / (1 - b1)``), and their
        difference ``d_t`` (at least ``tol``, which covers the recovery's
        rounding) is what the runs' arithmetic and the parameters they
        already differ by made of it.  A step moves a parameter by
        ``lr_t * r_t`` plus the decay, with ``r = m / (sqrt(v) + eps)`` on
        the bias-corrected moments; ``m`` is a weighted mean of the
        gradients and ``sqrt(v)`` a weighted RMS (weights summing to 1), so
        each moves by at most ``D_t = max_{s<=t} d_s``, and ``|dr| <= D_t /
        (sqrt(v) + eps) * (1 + R)`` with ``R`` the :meth:`ratio_bound`.
        Where ``sqrt(v)`` is near ``D_t`` (a gradient within rounding of
        zero) this first-order bound is capped by ``2 R``: the runs may
        step opposite ways.  The decay carries an earlier difference on,
        times ``1 + lr_t * weight_decay``."""
        r = self.ratio_bound(len(nus))
        total, worst = 0.0, 0.0
        prev_a = prev_b = 0.0
        for t, (nu, ma, mb) in enumerate(zip(nus, mus_a, mus_b), start=1):
            ma, mb = np.asarray(ma, np.float64), np.asarray(mb, np.float64)
            ga = (ma - self.b1 * prev_a) / (1 - self.b1)
            gb = (mb - self.b1 * prev_b) / (1 - self.b1)
            prev_a, prev_b = ma, mb
            worst = np.maximum(worst, np.maximum(np.abs(ga - gb), tol))
            lr = float(self._lr(torch.tensor(t, dtype=torch.int32)))
            root = np.sqrt(np.asarray(nu, np.float64) / (1 - self.b2 ** t))
            total = total * (1 + lr * self.weight_decay) + lr * np.minimum(
                2 * r, worst * (1 + r) / (root + self.eps))
        return total
