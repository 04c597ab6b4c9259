"""Optimizer + LR schedule.

Port of ``dml_cnn_cifar10_tpu/train/optim.py``: SGD (plain or momentum),
AdamW, LARS, LAMB and Adafactor, global-norm clipping and the EMA.
Reference (``train_step``, ``cifar10cnn.py:159-164``): plain
``GradientDescentOptimizer`` with ``exponential_decay(0.1, gen, 250, 0.9,
staircase=True)`` keyed on a never-incremented variable (``:216``), so
the effective LR is a constant 0.1 (``OptimConfig.dead_lr_decay``).

The state is a dict: ``step`` (a 0-d int32 tensor on the params' device),
``momentum`` (a param-shaped dict: SGD momentum, LARS), ``mu`` and ``nu``
(AdamW's and LAMB's moments), ``vr``/``vc``/``v`` (Adafactor's factored
second moments), ``stale`` (the staleness snapshots, ``parallel/step.py``)
and ``ema`` (the eval-time parameter average, when ``ema_decay`` is on) —
the JAX package's keys. Adafactor factors over the trailing two dims of a
leaf in the JAX layout, so it computes on each leaf's JAX-layout view
(``convert.jax_view``) and keeps ``vr``/``vc``/``v`` in the JAX shapes
(a 0-d zero where a leaf does not use the entry, as the JAX package
does). The LR is a 0-d
f32 **device** tensor computed from ``step`` on the card, so the update
never waits for the host. Updates are IN PLACE: the parameters keep
their identity (and their ``nn.Module``), and nothing is reallocated.

The update runs fused by default (``ops/optimizer.py``: weight decay +
momentum + LR in ONE pass per leaf — the hand-written CUDA kernels on the
card); ``fused_optimizer=False`` keeps the per-transform chain, the same
expression op by op. The other families are plain torch on the device,
as the JAX package left them to XLA; the clipping norm, the trust ratios
and Adafactor's statistics stay device tensors that the host never reads,
so the update can be captured in a CUDA graph.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Tuple

import torch

from dml_cnn_cifar10_tpu_torch import convert
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


FAMILIES = ("sgd", "adamw", "lars", "lamb", "adafactor")


def sgd_init(params: Mapping[str, torch.Tensor], cfg: OptimConfig,
             device: torch.device | None = None) -> OptState:
    """Optimizer state for ``params`` (``{name: tensor}``) of the
    configured family (the JAX package's name, which dispatches on
    ``cfg.optimizer``)."""
    if cfg.optimizer not in FAMILIES:
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    if device is None:
        device = next(iter(params.values())).device

    def zeros():
        return {k: torch.zeros_like(p, device=device)
                for k, p in params.items()}

    def f32(shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    state: OptState = {"step": torch.zeros((), dtype=torch.int32,
                                           device=device)}
    if cfg.optimizer in ("adamw", "lamb"):
        if cfg.momentum:
            raise ValueError(
                f"momentum is an SGD/LARS knob; {cfg.optimizer}'s first "
                "moment is adam_b1 — drop --momentum")
        state["mu"] = zeros()
        state["nu"] = zeros()
    elif cfg.optimizer == "lars":
        # LARS always carries momentum (0 means the conventional 0.9).
        state["momentum"] = zeros()
    elif cfg.optimizer == "adafactor":
        if cfg.momentum:
            raise ValueError(
                "adafactor's memory-saving mode carries no first moment "
                "(Shazeer & Stern 2018 §9) — drop --momentum")
        shapes = {k: convert.jax_shape(k, p.shape) for k, p in params.items()}
        state["vr"] = {k: f32(s[:-1] if len(s) >= 2 else ())
                       for k, s in shapes.items()}
        state["vc"] = {k: f32(s[:-2] + s[-1:] if len(s) >= 2 else ())
                       for k, s in shapes.items()}
        state["v"] = {k: f32(() if len(s) >= 2 else s)
                      for k, s in shapes.items()}
    elif cfg.momentum:
        state["momentum"] = zeros()
    if cfg.async_staleness >= 2:
        if cfg.optimizer in ("sgd", "lars") and cfg.weight_decay:
            # A real async worker would compute the coupled L2 term at its
            # stale snapshot; the update couples it at the live params.
            raise ValueError(
                f"async_staleness with {cfg.optimizer}-coupled "
                "weight_decay would not reproduce async semantics (the "
                "L2 term would use live params); use weight_decay=0 "
                "(the reference config) or a decoupled-decay optimizer "
                "(adamw/lamb)")
        # Round-robin snapshot ring: slot t % S serves the forward pass at
        # step t and receives the updated params.
        state["stale"] = {k: torch.stack([p.detach()] * cfg.async_staleness)
                          .to(device) for k, p in params.items()}
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


def clipped(grads: Mapping[str, torch.Tensor], cfg: OptimConfig
            ) -> Mapping[str, torch.Tensor]:
    """Scale every gradient by ``min(1, clip / (global norm + 1e-12))``
    (JAX ``_clipped``); the norm is a device tensor, never read here."""
    if cfg.grad_clip_norm is None:
        return grads
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                           for g in grads.values()))
    scale = torch.clamp(cfg.grad_clip_norm / (gnorm + 1e-12), max=1.0)
    return {k: g * scale.to(g.dtype) for k, g in grads.items()}


@torch.no_grad()
def sgd_update(grads: Mapping[str, torch.Tensor], state: OptState,
               params: Mapping[str, torch.Tensor], cfg: OptimConfig
               ) -> Tuple[Mapping[str, torch.Tensor], OptState]:
    """One optimizer step, in place; returns ``(params, state)``.

    The step counter increments on apply, mirroring ``minimize(...,
    global_step=global_step)`` (``cifar10cnn.py:163``). SGD and LARS
    couple weight decay into the gradient (classic L2); AdamW, LAMB and
    Adafactor decay decoupled, applied directly to the weights.
    """
    lr = learning_rate(cfg, state["step"])
    grads = clipped(grads, cfg)
    momentum = state.get("momentum") if cfg.momentum else None
    if cfg.optimizer in ("adamw", "lamb"):
        _adam_update(grads, state, params, cfg, lr)
    elif cfg.optimizer == "adafactor":
        _adafactor_update(grads, state, params, cfg, lr)
    elif cfg.optimizer == "lars":
        _lars_update(grads, state, params, cfg, lr)
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


def _trust_ratio(p: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``||p|| / ||u||`` with optax's guards: 1 when either norm is 0."""
    pn = torch.linalg.vector_norm(p)
    un = torch.linalg.vector_norm(u)
    one = torch.ones_like(pn)
    return torch.where(pn > 0, torch.where(un > 0, pn / un, one), one)


def _adam_update(grads: Mapping[str, torch.Tensor], state: OptState,
                 params: Mapping[str, torch.Tensor], cfg: OptimConfig,
                 lr: torch.Tensor) -> None:
    """AdamW (and LAMB) in place, the JAX package's expression
    (``optim.py:201-223``): ``r = (mu/bc1) / (sqrt(nu/bc2) + eps) +
    wd·p``, ``p -= lr·r``; LAMB scales the step by the leaf's trust ratio
    ``||p|| / ||r||``."""
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
        scale = lr * _trust_ratio(p, r) if cfg.optimizer == "lamb" else lr
        p.copy_(p - (scale * r).to(p.dtype))


def _lars_update(grads: Mapping[str, torch.Tensor], state: OptState,
                 params: Mapping[str, torch.Tensor], cfg: OptimConfig,
                 lr: torch.Tensor) -> None:
    """LARS in place (JAX ``optim.py:300-330``): the decayed gradient
    ``g + wd·p`` of every leaf of 2 or more dims is scaled by the local LR
    ``trust·||p|| / (||g + wd·p|| + eps)`` (1 when either norm is 0),
    then heavy-ball momentum (``cfg.momentum``, 0.9 when 0)."""
    beta = cfg.momentum or 0.9
    for name, p in params.items():
        g = grads[name] + cfg.weight_decay * p
        if p.dim() > 1:
            pn = torch.linalg.vector_norm(p)
            gn = torch.linalg.vector_norm(g)
            one = torch.ones_like(pn)
            local = torch.where(
                pn > 0, torch.where(gn > 0, cfg.lars_trust_coef * pn
                                    / (gn + cfg.lars_eps), one), one)
            g = local * g
        m = state["momentum"][name]
        m.copy_(beta * m + g)
        p.copy_(p - (lr * m).to(p.dtype))


def _adafactor_update(grads: Mapping[str, torch.Tensor], state: OptState,
                      params: Mapping[str, torch.Tensor], cfg: OptimConfig,
                      lr: torch.Tensor) -> None:
    """Adafactor in place (JAX ``optim.py:240-290``): decay ``b2_t = 1 −
    t^-0.8``, the factored rsqrt preconditioner over the trailing two dims
    of the JAX layout (two separate rsqrts: their product underflows for a
    zero-gradient row), the update RMS-clipped at 1, a relative step
    ``lr·max(RMS(p), 1e-3)`` and decoupled weight decay."""
    t = (state["step"] + 1).to(torch.float32)
    b2 = 1.0 - torch.pow(t, -0.8)
    for name, p in params.items():
        pj = convert.jax_view(name, p)
        g = convert.jax_view(name, grads[name]).float()
        g2 = torch.square(g) + 1e-30
        if pj.dim() >= 2:
            vr, vc = state["vr"][name], state["vc"][name]
            vr.copy_(b2 * vr + (1 - b2) * g2.mean(dim=-1))
            vc.copy_(b2 * vc + (1 - b2) * g2.mean(dim=-2))
            row = vr / vr.mean(dim=-1, keepdim=True)
            u = g * torch.rsqrt(row)[..., None] * torch.rsqrt(vc)[..., None, :]
        else:
            v = state["v"][name]
            v.copy_(b2 * v + (1 - b2) * g2)
            u = g * torch.rsqrt(v)
        rms = torch.sqrt(torch.mean(torch.square(u)))
        u = u / torch.clamp(rms, min=1.0)
        alpha = lr * torch.clamp(
            torch.sqrt(torch.mean(torch.square(pj.float()))), min=1e-3)
        pj.copy_(pj - (alpha * (u + cfg.weight_decay * pj)).to(p.dtype))
