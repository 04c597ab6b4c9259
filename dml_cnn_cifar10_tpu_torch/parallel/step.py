"""The training and eval steps (single device).

Port of the single-device parts of ``dml_cnn_cifar10_tpu/parallel/step.py``:
:class:`TrainState`, :func:`init_train_state`, :func:`make_train_step`,
:func:`make_eval_step`. PyTorch runs eagerly, so a step is a plain
function: forward through the model with the state's parameters
(``torch.func.functional_call``), backward with ``torch.autograd.grad``,
then the in-place optimizer update (``train/optim.py``) whose fused form
is the hand-written CUDA kernel. No host synchronization happens inside
a step; the metrics it returns are device tensors. The model reads its
own compute dtype and attention switches from its ``ModelConfig``; the
step only keeps float32 products in full float32. Under grad the ViT's
attention runs the flash forward that saves its logsumexp (K4) and the
backward kernels (K6, K7); the eval step runs under ``no_grad``, so the
output-only forward (K3).

Meshes, chunked dispatch and staleness emulation are not ported here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn
from torch.func import functional_call

from dml_cnn_cifar10_tpu_torch.config import OptimConfig
from dml_cnn_cifar10_tpu_torch.train import loss as loss_lib
from dml_cnn_cifar10_tpu_torch.train import metrics as metrics_lib
from dml_cnn_cifar10_tpu_torch.train import optim as optim_lib


@dataclasses.dataclass
class TrainState:
    """Params + optimizer state + model state (empty for the CNN).

    ``params`` maps the model's parameter names to tensors on the device,
    in the port's layouts; ``opt`` is :func:`optim.sgd_init`'s dict.
    """

    params: Dict[str, torch.Tensor]
    opt: Dict[str, Any]
    model_state: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def step(self) -> torch.Tensor:
        return self.opt["step"]


def _f32_parity() -> None:
    # Keep convolutions and matrix products in full float32 on the card:
    # cuDNN convolutions default to TF32 (~3 decimal digits), which would
    # break parity with the JAX package's float32 math.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def init_train_state(model: nn.Module, optim_cfg: OptimConfig,
                     device: torch.device,
                     generator: Optional[torch.Generator] = None
                     ) -> TrainState:
    """Initialize ``model``'s parameters from ``generator`` (on the CPU,
    so a seed gives the same weights on every device), move the model to
    ``device`` and build the optimizer state there. The state's params
    are the module's own ``nn.Parameter`` objects."""
    model.reset_parameters(generator)
    model.to(device)
    params = dict(model.named_parameters())
    return TrainState(params=params,
                      opt=optim_lib.sgd_init(params, optim_cfg, device))


def make_train_step(model: nn.Module, optim_cfg: OptimConfig
                    ) -> Callable[[TrainState, torch.Tensor, torch.Tensor],
                                  Tuple[TrainState, dict]]:
    """``(state, images, labels) -> (state, {"loss", "accuracy"})``; the
    state is updated in place and returned."""
    _f32_parity()

    def step(state: TrainState, images: torch.Tensor, labels: torch.Tensor):
        names = list(state.params)
        with torch.enable_grad():
            logits = functional_call(model, state.params, (images,))
            loss = loss_lib.softmax_cross_entropy(
                logits, labels, optim_cfg.label_smoothing)
            # The update kernels take contiguous leaves; a kernel that
            # reaches its layer through a permute (the ViT's HWIO patch
            # embed) gets its gradient back as a permuted view.
            grads = [g.contiguous() for g in torch.autograd.grad(
                loss, [state.params[n] for n in names])]
        with torch.no_grad():
            acc = metrics_lib.batch_accuracy(logits, labels)
            optim_lib.sgd_update(dict(zip(names, grads)), state.opt,
                                 state.params, optim_cfg)
        return state, {"loss": loss.detach(), "accuracy": acc}

    return step


def make_eval_step(model: nn.Module
                   ) -> Callable[[TrainState, torch.Tensor, torch.Tensor],
                                 dict]:
    """``(state, images, labels) -> {"accuracy", "correct"}`` — single-batch
    accuracy for faithful eval (``cifar10cnn.py:237-241``) and the
    summable correct count for the full-test-set sweep. Uses the
    parameter EMA when the optimizer keeps one."""
    _f32_parity()

    @torch.no_grad()
    def step(state: TrainState, images: torch.Tensor, labels: torch.Tensor):
        params = state.opt.get("ema", state.params)
        logits = functional_call(model, params, (images,))
        return {"accuracy": metrics_lib.batch_accuracy(logits, labels),
                "correct": metrics_lib.correct_count(logits, labels)}

    return step
