"""Serving export: the trained eval forward as a self-contained program.

Port of ``dml_cnn_cifar10_tpu/export.py``, which serializes the jitted
eval forward with ``jax.export``. Here it is ``torch.export``: the
:class:`ServingForward` module (the eval decode of
``ops/preprocess.device_preprocess`` in front of the model, every
augmentation off) traced under ``no_grad`` with the weights as the
program's own constants, a symbolic batch dimension (``Dim("b", min=1)``)
and raw uint8 ``[B, H, W, C]`` full-size images in, so the serving input
contract is the on-disk CIFAR record layout. One artifact serves any
batch size.

The trace runs on the CPU whatever the device the weights were trained
on, so one artifact loads on a CPU-only host and on the card:
:func:`load_program` moves its constants to the device it is asked for.
The ViT's attention is the registered operator
``dml_torch::flash_attention_out`` (``ops/flash_attention.py``), one node
of the graph: the loaded program launches the hand-written K3 kernel on
the card and its plain version on the CPU. Loading an artifact therefore
needs this package imported (it registers the operator). The ``vit_moe``
artifact keeps its capacity symbolic in the batch (``ops/moe.py``), so
it routes each call's batch, padding included, as one; the JAX package's
``jax.export`` of ``vit_moe`` with a symbolic batch stops at its
``math.ceil`` of the capacity (a tracer where a number is needed).

:func:`restore_serving_params` restores the newest checkpoint of a run's
``log_dir`` (either format: a ``.sharded`` one is assembled whole from
its shard files, whatever layout wrote it) into a fresh model and picks
the weights that serve: the parameter EMA when the optimizer keeps one,
as ``--mode eval`` scores.
"""

from __future__ import annotations

import io
import os
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.func import functional_call

from dml_cnn_cifar10_tpu_torch.config import DataConfig, TrainConfig
from dml_cnn_cifar10_tpu_torch.ops import flash_attention  # noqa: F401
from dml_cnn_cifar10_tpu_torch.ops.preprocess import device_preprocess

#: Default artifact file name under ``--log_dir``.
ARTIFACT_NAME = "model.pt2"
# Example batch of the trace: 2, not 1, so the batch dimension stays
# symbolic (a size-1 example would be specialized).
_EXAMPLE_BATCH = 2


class ServingForward(nn.Module):
    """``uint8 [B, H, W, C] -> logits [B, K]``: the eval decode, then the
    model in eval mode. ``params`` (a ``{name: tensor}`` dict of the
    model's parameters) runs the model on those weights instead of its
    own, the live-weights form of the JAX package's
    ``make_variable_serving_fn``."""

    def __init__(self, model: nn.Module, data_cfg: DataConfig):
        super().__init__()
        self.model = model.eval()
        self.data_cfg = data_cfg.without_augmentation()

    def forward(self, images_u8: torch.Tensor,
                params: Optional[Dict[str, torch.Tensor]] = None
                ) -> torch.Tensor:
        if self.model.training:      # a trainer may have switched it
            self.model.eval()
        images = device_preprocess(images_u8, self.data_cfg)
        if params is None:
            out = self.model(images)
        else:
            out = functional_call(self.model, params, (images,))
        # A model with experts returns its router stats too: the logits
        # alone serve (JAX export.py:45,75).
        return out[0] if isinstance(out, tuple) else out


def make_serving_fn(model: nn.Module, data_cfg: DataConfig,
                    params: Optional[Dict[str, torch.Tensor]] = None
                    ) -> ServingForward:
    """The serving forward with the weights held by the module: ``params``
    (when given; the BatchNorm running stats by their buffer names with
    them) are copied into ``model`` first."""
    if params is not None:
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(params[name])
            for name, b in model.named_buffers():
                b.copy_(params[name])
    return ServingForward(model, data_cfg)


def make_variable_serving_fn(model: nn.Module,
                             data_cfg: DataConfig) -> ServingForward:
    """The serving forward that takes its weights as an argument:
    ``fn(images_u8, params)``. One module serves every checkpoint of one
    model configuration; a weight swap is a copy into the tensors passed,
    with no retrace (``serve/engine.py``)."""
    return ServingForward(model, data_cfg)


def export_forward(model: nn.Module, data_cfg: DataConfig,
                   params: Optional[Dict[str, torch.Tensor]] = None
                   ) -> torch.export.ExportedProgram:
    """Trace the serving forward of ``model`` (with ``params`` when given)
    on the CPU: weights and running stats embedded, symbolic batch, uint8
    input."""
    state = {name: p.detach() for name, p in model.named_parameters()}
    state.update((name, b.detach()) for name, b in model.named_buffers())
    if params is not None:
        state.update(params)
    fn = make_serving_fn(type(model)(model.cfg, data_cfg), data_cfg,
                         {n: t.to("cpu") for n, t in state.items()})
    example = torch.zeros((_EXAMPLE_BATCH, data_cfg.image_height,
                           data_cfg.image_width, data_cfg.num_channels),
                          dtype=torch.uint8)
    with torch.no_grad():
        return torch.export.export(
            fn, (example,),
            dynamic_shapes=({0: torch.export.Dim("b", min=1)},))


def save_exported(path: str, program: torch.export.ExportedProgram) -> None:
    """Atomic write (tmp + rename, as checkpoints are written), so a crash
    mid-write leaves no truncated artifact for a server to load."""
    buf = io.BytesIO()
    torch.export.save(program, buf)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(buf.getbuffer())
    os.replace(tmp, path)


def load_program(path: str, device="cpu") -> torch.export.ExportedProgram:
    """The artifact's :class:`~torch.export.ExportedProgram`, its
    constants on ``device``."""
    from torch.export.passes import move_to_device_pass

    return move_to_device_pass(torch.export.load(path),
                               torch.device(device))


def load_exported(path: str, device="cpu") -> nn.Module:
    """``fn(images_u8) -> logits`` of an artifact, on ``device``."""
    return load_program(path, device).module()


def artifact_image_shape(program: torch.export.ExportedProgram
                         ) -> Tuple[int, int, int]:
    """Per-request ``(H, W, C)`` from the artifact's own input spec (the
    leading batch dimension is symbolic and left out)."""
    name = program.graph_signature.user_inputs[0]
    node = next(n for n in program.graph.nodes
                if n.op == "placeholder" and n.name == name)
    return tuple(int(d) for d in node.meta["val"].shape[1:])


def restore_serving_params(cfg: TrainConfig, device: torch.device
                           ) -> Tuple[nn.Module, Dict[str, torch.Tensor],
                                      int]:
    """``(model, params, step)``: a model of ``cfg.model`` on ``device``
    and the weights that serve from the newest checkpoint under
    ``cfg.log_dir`` (the EMA when the optimizer keeps one), or the
    seed's fresh weights at step 0 when there is none; with them, by
    buffer name, the eval-mode running stats of a model that keeps them
    (``ema_mstate`` beside the EMA, else ``model_state``)."""
    from dml_cnn_cifar10_tpu_torch import ckpt as ckpt_lib
    from dml_cnn_cifar10_tpu_torch.models.registry import get_model
    from dml_cnn_cifar10_tpu_torch.parallel import step as step_lib

    model = get_model(cfg.model.name)(cfg.model, cfg.data)
    state = step_lib.init_train_state(
        model, cfg.optim, device, torch.Generator().manual_seed(cfg.seed))
    state = ckpt_lib.restore_checkpoint(cfg.log_dir, state)
    return model, {n: t.detach() for n, t in step_lib.eval_params(
        state).items()}, int(state.step)
