"""Optimizer + LR schedule.

Port of ``dml_cnn_cifar10_tpu/train/optim.py``'s SGD and AdamW branches.
Reference (``train_step``, ``cifar10cnn.py:159-164``): plain
``GradientDescentOptimizer`` with ``exponential_decay(0.1, gen, 250, 0.9,
staircase=True)`` keyed on a never-incremented variable (``:216``), so
the effective LR is a constant 0.1 (``OptimConfig.dead_lr_decay``).

The state is a dict: ``step`` (a 0-d int32 tensor on the params' device),
``momentum`` (a param-shaped dict, when SGD momentum is on), ``mu`` and
``nu`` (AdamW's moments) and ``ema`` (the eval-time parameter average,
when ``ema_decay`` is on) — the JAX package's keys. The LR is a 0-d
f32 **device** tensor computed from ``step`` on the card, so the update
never waits for the host. Updates are IN PLACE: the parameters keep
their identity (and their ``nn.Module``), and nothing is reallocated.

The update runs fused by default (``ops/optimizer.py``: weight decay +
momentum + LR in ONE pass per leaf — the hand-written CUDA kernels on the
card); ``fused_optimizer=False`` keeps the per-transform chain, the same
expression op by op. AdamW (the ViT recipes' optimizer; decoupled weight
decay, bias-corrected moments) is plain torch, as the JAX package left it
to XLA. The JAX package's other families (lars, lamb, adafactor),
gradient clipping and async staleness are not ported.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Tuple

import torch

from dml_cnn_cifar10_tpu_torch.config import OptimConfig
from dml_cnn_cifar10_tpu_torch.ops import optimizer as fused_lib

OptState = Dict[str, Any]


def learning_rate(cfg: OptimConfig, step: torch.Tensor) -> torch.Tensor:
    """LR schedule at ``step``, a 0-d f32 tensor on ``step``'s device.

    ``exponential`` (reference parity): ``tf.train.exponential_decay``
    staircase; dead_lr_decay freezes the decay argument at 0 (constant
    base LR, ``cifar10cnn.py:161,216``). ``cosine``: half-cosine to 0 over
    ``cosine_decay_steps``. ``constant``: base LR. Any of them composes
    with a linear ``warmup_steps`` ramp.
    """
    stepf = step.to(torch.float32)
    if cfg.schedule == "exponential":
        decay_steps = torch.zeros_like(stepf) if cfg.dead_lr_decay else stepf
        exponent = decay_steps / cfg.decay_every
        if cfg.staircase:
            exponent = torch.floor(exponent)
        lr = cfg.learning_rate * torch.pow(cfg.lr_decay, exponent)
    elif cfg.schedule == "cosine":
        if cfg.cosine_decay_steps <= cfg.warmup_steps:
            raise ValueError(
                f"cosine schedule needs cosine_decay_steps "
                f"({cfg.cosine_decay_steps}) > warmup_steps "
                f"({cfg.warmup_steps}); otherwise the LR collapses to 0 "
                f"right after warmup")
        horizon = cfg.cosine_decay_steps - cfg.warmup_steps
        prog = torch.clamp((stepf - cfg.warmup_steps) / horizon, 0.0, 1.0)
        lr = cfg.learning_rate * 0.5 * (1.0 + torch.cos(math.pi * prog))
    elif cfg.schedule == "constant":
        lr = torch.full((), cfg.learning_rate, dtype=torch.float32,
                        device=step.device)
    else:
        raise ValueError(f"unknown schedule {cfg.schedule!r}")
    if cfg.warmup_steps > 0:
        lr = lr * torch.clamp((stepf + 1.0) / cfg.warmup_steps, 0.0, 1.0)
    return lr


def sgd_init(params: Mapping[str, torch.Tensor], cfg: OptimConfig,
             device: torch.device | None = None) -> OptState:
    """Optimizer state for ``params`` (``{name: tensor}``) of the
    configured family (the JAX package's name, which dispatches on
    ``cfg.optimizer``)."""
    if cfg.optimizer not in ("sgd", "adamw"):
        raise NotImplementedError(
            f"optimizer {cfg.optimizer!r} is not ported to PyTorch yet "
            "(ROADMAP.md Queue 1, slice 2 left-outs); use sgd or adamw")
    if device is None:
        device = next(iter(params.values())).device

    def zeros():
        return {k: torch.zeros_like(p, device=device)
                for k, p in params.items()}

    state: OptState = {"step": torch.zeros((), dtype=torch.int32,
                                           device=device)}
    if cfg.optimizer == "adamw":
        if cfg.momentum:
            raise ValueError(
                "momentum is an SGD/LARS knob; adamw's first moment is "
                "adam_b1 — drop --momentum")
        state["mu"] = zeros()
        state["nu"] = zeros()
    elif cfg.momentum:
        state["momentum"] = zeros()
    if cfg.ema_decay:
        if not 0.0 <= cfg.ema_decay < 1.0:
            raise ValueError(
                f"ema_decay must be in [0, 1) (got {cfg.ema_decay}); 1.0 "
                "would freeze the EMA at random init forever")
        state["ema"] = {k: p.detach().clone() for k, p in params.items()}
    return state


def ema_decay_at(cfg: OptimConfig, t: torch.Tensor) -> torch.Tensor:
    """Warmup-ramped EMA decay ``min(d, (1+t)/(10+t))`` for update count
    ``t`` (the optax/TF EMA schedule)."""
    t = t.to(torch.float32)
    return torch.minimum(torch.full_like(t, cfg.ema_decay),
                         (1.0 + t) / (10.0 + t))


@torch.no_grad()
def sgd_update(grads: Mapping[str, torch.Tensor], state: OptState,
               params: Mapping[str, torch.Tensor], cfg: OptimConfig
               ) -> Tuple[Mapping[str, torch.Tensor], OptState]:
    """One optimizer step, in place; returns ``(params, state)``.

    The step counter increments on apply, mirroring ``minimize(...,
    global_step=global_step)`` (``cifar10cnn.py:163``). SGD couples weight
    decay into the gradient (classic L2); AdamW decays decoupled, applied
    directly to the weights.
    """
    lr = learning_rate(cfg, state["step"])
    momentum = state.get("momentum") if cfg.momentum else None
    if cfg.optimizer == "adamw":
        _adamw_update(grads, state, params, cfg, lr)
    elif cfg.fused_optimizer:
        fused_lib.fused_sgd_update(params, grads, momentum, lr,
                                   cfg.momentum, cfg.weight_decay)
    else:
        for name, p in params.items():
            g = grads[name]
            if cfg.weight_decay:
                g = g + cfg.weight_decay * p
            if momentum is not None:
                m = momentum[name]
                m.copy_(cfg.momentum * m + g)
                g = m
            p.copy_(p - lr * g.to(p.dtype))
    state["step"].add_(1)
    if cfg.ema_decay:
        d = ema_decay_at(cfg, state["step"])
        for name, e in state["ema"].items():
            e.copy_(d * e + (1 - d) * params[name])
    return params, state


def _adamw_update(grads: Mapping[str, torch.Tensor], state: OptState,
                  params: Mapping[str, torch.Tensor], cfg: OptimConfig,
                  lr: torch.Tensor) -> None:
    """AdamW in place, the JAX package's expression (``optim.py:201-223``):
    ``r = (mu/bc1) / (sqrt(nu/bc2) + eps) + wd·p``, ``p -= lr·r``."""
    b1, b2 = cfg.adam_b1, cfg.adam_b2
    # A Python scalar base keeps the step on the device: no host copy.
    t = (state["step"] + 1).to(torch.float32)
    bc1 = 1.0 - torch.pow(b1, t)
    bc2 = 1.0 - torch.pow(b2, t)
    for name, p in params.items():
        g = grads[name]
        mu, nu = state["mu"][name], state["nu"][name]
        mu.copy_(b1 * mu + (1 - b1) * g)
        nu.copy_(b2 * nu + (1 - b2) * torch.square(g))
        r = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.adam_eps) \
            + cfg.weight_decay * p
        p.copy_(p - (lr * r).to(p.dtype))
