"""Mixture-of-Experts MLP: Switch top-1 / GShard top-2 routing with a
static capacity, over the data ranks and the model ranks.

Port of ``dml_cnn_cifar10_tpu/ops/moe.py``. The JAX layer is XLA-native
(no Pallas kernel), and so is this one: plain torch products
(``torch.bmm``, ``torch.einsum``) and an indexed add/select.

- **Routing** in float32 from the (compute-dtype-rounded) gate kernel:
  softmax over the experts, then ``top_k`` rounds of a masked argmax
  (ties take the first expert). Switch (``top_k=1``) keeps the raw
  probability as the combine weight, GShard (``top_k=2``) renormalizes
  the chosen pair (``p / max(p1 + p2, 1e-9)``).
- **Capacity** ``max(1, ceil(T/E · factor · k))`` slots an expert, every
  shape static. Queue slots go in token order, choice by choice: each
  earlier choice's FULL count offsets the later choices' slots, so a
  token loses its backup expert before anyone loses a first choice. A
  token past its expert's capacity is dropped (combine weight 0) and
  rides the residual.
- **Dispatch** ``"einsum"``: ``[T,E,C]`` one-hot contractions (O(T·E·C·D));
  ``"scatter"``: the tokens written into the ``[E,C,D]`` expert buffer by
  (expert, slot) and gathered back (O(T·D)); a dropped token takes weight
  0 (the JAX package clips it onto slot C−1 and adds zeros; the port
  writes it to a spare slot). Same semantics; close, not bit-equal.
- **Stats**: ``aux_loss = E·Σ_e f_e·p_e`` (first choices' fraction times
  the mean router probability, Switch eq. 4; differentiable), and the
  detached ``dropped_frac`` (of the T·k assignments) and
  ``expert_load`` (``f``, ``[E]``).

Over a mesh (:func:`moe_mlp`'s ``mesh``) the layer keeps the JAX
package's semantics, where GSPMD traces it at the GLOBAL batch:

- **Data ranks** (``mesh.data`` > 1): the routing is global. The
  capacity comes from the global T, a token's queue slot counts every
  earlier rank's tokens first (the global token order is data-rank
  major), and ``f``, ``p``, ``dropped_frac`` and ``expert_load`` are
  global means. Each rank's per-choice expert counts ``[k, E]`` are
  exchanged in one all-reduce of a ``[data, k, E]`` table (no gradient);
  the probability sums in a differentiable all-reduce whose backward sums
  the ranks' cotangents, so the aux term, computed whole on every rank of
  a loss that each rank scales by ``1/replicas``, counts once. A rank
  fills only its own tokens' slots of the global ``[E, C]`` queues and
  runs the experts on them: an expert's output for a slot depends on that
  slot alone, so no token moves between ranks.
- **Model ranks** (expert parallelism, ``w1``/``b1``/``w2``/``b2`` holding
  this rank's contiguous ``E/M`` experts): tokens are the same on every
  model rank of a data row, as in JAX, so every rank routes all of them
  alike and builds the routing tensors for its own experts only
  (``[T, E/M, C]``). The tokens entering the experts and the combine
  weights pass :func:`mesh.copy_to_model` (their gradients, each rank's
  share from its experts, are summed over the model ranks: the router's
  gradient along the combine path, and only that path), and the partial
  output :func:`mesh.reduce_from_model`.
"""

from __future__ import annotations

import fractions
import math
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from dml_cnn_cifar10_tpu_torch.parallel import mesh as mesh_lib

DISPATCHES = ("einsum", "scatter")


def param_shapes(dim: int, hidden: int, experts: int
                 ) -> Dict[str, Tuple[int, ...]]:
    """Expert-major leaves (the JAX package's ``init_moe_params``)."""
    return {"gate.kernel": (dim, experts), "w1": (experts, dim, hidden),
            "b1": (experts, hidden), "w2": (experts, hidden, dim),
            "b2": (experts, dim)}


@torch.no_grad()
def init_moe_params_(params: Mapping[str, torch.Tensor],
                     generator: Optional[torch.Generator] = None) -> None:
    """In place: gate ``0.02·N(0,1)``, ``w1`` ``sqrt(2/D)·N(0,1)``, ``w2``
    ``sqrt(2/H)·N(0,1)``, zero biases (leaves as :func:`param_shapes`
    names them, whole)."""
    dim, hidden = params["w1"].shape[-2:]
    for name, scale in (("gate.kernel", 0.02),
                        ("w1", math.sqrt(2.0 / dim)),
                        ("w2", math.sqrt(2.0 / hidden))):
        params[name].normal_(0.0, scale, generator=generator)
    params["b1"].zero_()
    params["b2"].zero_()


def capacity(tokens, experts: int, factor: float, top_k: int):
    """Slots an expert: ``max(1, ceil(T/E · factor · k))``, in the JAX
    package's float order. A symbolic ``tokens`` (an exported forward,
    whose batch stays symbolic) takes it in integer operations that the
    artifact can hold: ``factor · k`` as the exact fraction ``n / d`` of
    its float, ``-(-T·n // (E·d))``, the same number wherever the float
    products are exact (a power-of-two count of experts and a factor such
    as 1.25)."""
    if isinstance(tokens, torch.SymInt):
        frac = fractions.Fraction(factor * top_k)
        c = -((-tokens * frac.numerator) // (experts * frac.denominator))
        return torch.sym_max(1, c)
    return max(1, math.ceil(tokens / experts * factor * top_k))


def _route(tokens: torch.Tensor, gate: torch.Tensor, capacity_factor: float,
           top_k: int, mesh, over_data: bool):
    """The routing of ``tokens [T, D]`` (the module docstring): ``(probs
    [T,E], choices [(expert [T], one-hot [T,E], prob [T])], combine
    weights, this rank's slot offsets [k,E], the global counts [k,E],
    capacity, data ranks routed over)``."""
    t, e = tokens.shape[0], gate.shape[-1]
    if not 1 <= top_k <= e:
        raise ValueError(f"top_k={top_k} must be in [1, num_experts={e}]")
    data = mesh.data if mesh is not None and over_data else 1
    cap = capacity(t * data, e, capacity_factor, top_k)
    dev = tokens.device
    logits = tokens.float() @ gate.float()                    # [T,E]
    probs = torch.softmax(logits, dim=-1)
    experts = torch.arange(e, device=dev)
    masked, choices = probs, []
    for _ in range(top_k):
        idx = torch.argmax(masked, dim=-1)                    # [T]
        oh = idx[:, None] == experts                          # [T,E]
        choices.append((idx, oh, masked.gather(1, idx[:, None])[:, 0]))
        masked = masked.masked_fill(oh, 0.0)
    counts = torch.stack([oh.sum(0) for _, oh, _ in choices])  # [k,E]
    # Every data rank's counts: earlier ranks' tokens queue first.
    table = counts[None]
    if data > 1:
        table = torch.zeros((data, top_k, e), dtype=counts.dtype,
                            device=dev)
        table[mesh.data_rank] = counts
        mesh.all_reduce_(table, "data")
    total = table.sum(0)                                      # [k,E]
    # Choice i's slots start after every earlier choice's full counts.
    offsets = torch.cumsum(total, 0) - total
    if data > 1:
        offsets = offsets + table[:mesh.data_rank].sum(0)
    if top_k > 1:
        renorm = torch.clamp(sum(p for _, _, p in choices), min=1e-9)
        weights = [p / renorm for _, _, p in choices]
    else:
        weights = [choices[0][2]]
    return probs, choices, weights, offsets, total, cap, data


def _slot(idx: torch.Tensor, oh: torch.Tensor, offset: torch.Tensor
          ) -> torch.Tensor:
    """Each token's queue slot at its chosen expert (token order): the
    running count over the tokens, taken expert-major (``[E, T]``: a scan
    along the contiguous dim; CUDA's scan down the outer dim of ``[T, E]``
    takes milliseconds a call)."""
    run = torch.cumsum(oh.t().to(torch.int32).contiguous(), 1)    # [E,T]
    return run.gather(0, idx[None, :])[0] - 1 + offset[idx]


def assignments(x: torch.Tensor, gate: torch.Tensor,
                capacity_factor: float, top_k: int = 1
                ) -> list:
    """``[(expert [T], slot [T], kept [T])]``, one a choice, of the
    routing :func:`moe_mlp` does on ``x [B,S,D]`` alone."""
    tokens = x.reshape(-1, x.shape[-1])
    _, choices, _, offsets, _, cap, _ = _route(
        tokens, gate, capacity_factor, top_k, None, True)
    out = []
    for (idx, oh, _), off in zip(choices, offsets):
        pos = _slot(idx, oh, off)
        out.append((idx, pos, pos < cap))
    return out


def moe_mlp(x: torch.Tensor, params: Mapping[str, torch.Tensor],
            capacity_factor: float, top_k: int = 1,
            dispatch: str = "einsum", mesh=None, over_data: bool = True
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Top-k MoE MLP: ``[B,S,D] -> ([B,S,D], stats)`` (the module
    docstring). ``params``: ``gate.kernel [D,E]`` (whole), ``w1
    [E',D,H]``, ``b1 [E',H]``, ``w2 [E',H,D]``, ``b2 [E',D]`` with ``E' =
    E`` or, over ``mesh``'s model ranks, this rank's ``E/M`` experts.
    With ``mesh`` the routing is global over its data ranks (unless
    ``over_data`` is False: then each rank routes its own tokens alone);
    every rank of the groups it spans must call it in the same order."""
    if dispatch not in DISPATCHES:
        raise ValueError(
            f"dispatch must be 'einsum' or 'scatter', got {dispatch!r}")
    b, s, d = x.shape
    t = b * s
    tokens = x.reshape(t, d)
    e = params["gate.kernel"].shape[-1]
    probs, choices, weights, offsets, total, cap, data = _route(
        tokens, params["gate.kernel"], capacity_factor, top_k, mesh,
        over_data)
    e_loc = params["w1"].shape[0]
    ep = e_loc != e
    e0 = mesh.model_rank * e_loc if ep else 0
    dev, cdt = x.device, x.dtype
    if ep:
        tokens = mesh_lib.copy_to_model(tokens, mesh)
        weights = [mesh_lib.copy_to_model(w, mesh) for w in weights]

    if dispatch == "scatter":
        # Each expert's C slots and one spare, slot C, where every token
        # this rank does not keep (dropped, or under expert parallelism
        # another rank's) is written and from which it reads with weight
        # 0: the JAX package clips such a token onto slot C-1 and adds
        # zeros there, the same y and gradients. Kept slots are unique, so
        # the writes need no accumulation (and no sort).
        coords = []                       # (flat slot, keep, weight)
        for (idx, oh, _), off, w in zip(choices, offsets, weights):
            pos = _slot(idx, oh, off)
            keep = pos < cap
            if ep:
                keep = keep & (idx >= e0) & (idx < e0 + e_loc)
            ex = torch.clamp(idx - e0, 0, e_loc - 1)
            coords.append((ex, torch.where(keep, pos, cap), keep, w))
        xe = torch.zeros((e_loc, cap + 1, d), dtype=cdt, device=dev)
        for ex, slot, _, _ in coords:
            xe = xe.index_put((ex, slot), tokens)
        # The flattened output (a merge of contiguous dims: an exported
        # forward keeps its symbolic batch) gathered by index_select,
        # whose backward adds by atomics rather than sorting.
        ye = _experts(xe, params).flatten(0, 1)               # [E'(C+1),D]
        y = None
        for ex, slot, keep, w in coords:
            part = ye.index_select(0, ex * (cap + 1) + slot) \
                * (w * keep)[:, None].to(cdt)
            y = part if y is None else y + part
    else:
        local = slice(e0, e0 + e_loc)
        slots = torch.arange(cap, device=dev)
        disp = combine = None
        for (_, oh, _), off, w in zip(choices, offsets, weights):
            # Expert-major [E', T]: the running count scans the
            # contiguous dim (see _slot).
            ohf = oh[:, local].t().float().contiguous()
            pos = (torch.cumsum(ohf, 1) - 1.0 + off[local, None]) * ohf
            keep = (ohf > 0) & (pos < cap)
            pos_1h = ((pos.to(torch.int32)[..., None] == slots)
                      & keep[..., None]).float()              # [E',T,C]
            part = pos_1h * w[None, :, None]
            disp = pos_1h if disp is None else disp + pos_1h
            combine = part if combine is None else combine + part
        # The two contractions as batched products over the experts (no
        # reshape of a capacity-sized dim, so an exported forward keeps
        # its symbolic batch): "tec,td->ecd", then "tec,ecd->td" summed
        # over the experts.
        xe = torch.bmm(disp.to(cdt).transpose(1, 2),
                       tokens.expand(e_loc, t, d))
        ye = _experts(xe, params)
        y = torch.bmm(combine.to(cdt), ye).sum(0)
    if ep:
        y = mesh_lib.reduce_from_model(y, mesh)

    # Over the global batch: kept assignments from the global queues
    # (choice i of expert e fills slots offset..offset+count-1).
    prior = torch.cumsum(total, 0) - total
    kept = torch.clamp(torch.minimum(total, cap - prior), min=0).sum()
    # The means as the JAX package's XLA computes ``jnp.mean``: the sum
    # times the float32 reciprocal of the count; ``dropped_frac`` is its
    # true division.
    n_tok = t * data
    f = total[0].float() * _full(1.0 / n_tok, dev)
    psum = probs.sum(0)
    if data > 1:
        psum = mesh_lib.all_reduce_sum(psum, mesh, "data")
    p = psum * _full(1.0 / n_tok, dev)
    stats = {"aux_loss": e * torch.sum(f * p),
             "dropped_frac": (1.0 - kept.float()
                              / _full(n_tok * top_k, dev)).detach(),
             "expert_load": f.detach()}
    return y.reshape(b, s, d), stats


def _full(v, device) -> torch.Tensor:
    """``v`` as a float32 tensor on ``device`` (a CUDA division by a host
    scalar would multiply by its reciprocal instead)."""
    return torch.full((), v, dtype=torch.float32, device=device)


def _experts(xe: torch.Tensor, params: Mapping[str, torch.Tensor]
             ) -> torch.Tensor:
    """Each expert's MLP on its ``[E', C, D]`` slots (tanh GELU)."""
    h = F.gelu(torch.bmm(xe, params["w1"]) + params["b1"][:, None, :],
               approximate="tanh")
    return torch.bmm(h, params["w2"]) + params["b2"][:, None, :]
