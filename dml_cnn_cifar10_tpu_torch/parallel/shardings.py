"""Parameter/optimizer partition rules: an ordered regex → spec engine over
``/``-joined leaf paths.

Port of ``dml_cnn_cifar10_tpu/parallel/shardings.py`` without
``jax.sharding``: a spec is :class:`PartitionSpec`, the port's own small
immutable tuple of axis names (or ``None``, or a tuple of names for a
dim split over several axes), equal to JAX's ``P`` of the same entries and
printed the same way, so ``--partition_report`` renders the JAX package's
text. Each model's table is an ordered list of ``(regex, spec)`` rules;
the engine matches each leaf's path against it, first match wins. Specs
right-align to the leaf's rank (a ``^`` prefix in the CLI grammar
left-aligns them); an unmatched leaf replicates unless ``strict``.

Specs are always computed on the JAX-layout shape of a leaf
(``convert.jax_shape``): the port keeps conv kernels OIHW and dense
kernels ``[out, in]``, so ``parallel/zero.py`` maps the dim a spec shards
through ``convert.LAYOUTS`` into the port's layout.

:func:`_add_fsdp` adds the ``data`` axis to the largest still-unsharded
dim that ``|data|`` divides (ties go to the earlier dim): the ZeRO layout
of ``--fsdp`` (parameters and moments) and of ``--optimizer_sharding
zero1`` (moments and the EMA only, :data:`ZERO1_KEYS`). ``model`` is the
tensor-parallel axis (``--model_axis``): the port's models run the
Megatron pairs of the default tables as column- and row-parallel layers,
so above size 1 a table must place ``model`` exactly where the default
one does (:func:`check_axes`); :func:`model_slice` gives the slice a
model rank holds. ``pipe`` is the pipeline axis (``--pipe_axis``): above
size 1 the ViT's pipeline table (:data:`VIT_PIPE_RULES`) puts it on the
leading (depth) axis of every stacked ``blocks/`` leaf, and a table must
place it exactly there; :func:`stage_slice` gives a stage's rows, and
``ModelSplit.whole`` (``parallel/tp.py``) gathers them back over
``pipe``. The port shards no parameter over ``seq``: a rule that names
it, or ``pipe`` at size 1, is legal (it then shards nothing, as in the
JAX package at ``model_axis=1``, but still claims its dim for
:func:`_add_fsdp`); anything else raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import re
from typing import (Any, Dict, List, Mapping, NamedTuple, Optional, Sequence,
                    Tuple)


class PartitionSpec(tuple):
    """Per-dim axis entries of a leaf (JAX ``PartitionSpec``): an axis
    name, ``None`` (not sharded) or a tuple of names."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "PartitionSpec" + tuple.__repr__(self)

    __str__ = __repr__


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class PartitionRule:
    """One ``(regex, spec)`` entry of an ordered rule table: ``pattern``
    is matched with ``re.search`` against the leaf's ``/``-joined path;
    ``spec`` right-aligns to the leaf's rank (``align="left"`` anchors it
    at the leading axis)."""

    pattern: str
    spec: PartitionSpec
    align: str = "right"

    def matches(self, path: str) -> bool:
        return re.search(self.pattern, path) is not None


Rules = Sequence[PartitionRule]


def _aligned_spec(rule: PartitionRule, path: str, ndim: int
                  ) -> PartitionSpec:
    entries = tuple(rule.spec)
    if len(entries) > ndim:
        raise ValueError(
            f"partition rule {rule.pattern!r} names {len(entries)} dims "
            f"but leaf {path!r} has rank {ndim}")
    if rule.align == "left" or not entries:
        return rule.spec
    return P(*([None] * (ndim - len(entries)) + list(entries)))


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf) if isinstance(leaf, (tuple, list)) \
        else tuple(leaf.shape)


def _flat(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(path, leaf)`` of a nested dict in sorted key order (JAX's tree
    flattening order); a leaf is anything with a ``.shape`` or a shape
    tuple, and a flat dict with ``/``-joined keys gives the same paths."""
    out = []
    for key in sorted(tree):
        value = tree[key]
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            out.extend(_flat(value, path + "/"))
        else:
            out.append((path, value))
    return out


def _unflat(pairs: Sequence[Tuple[str, Any]], like: Any) -> Any:
    """Values of ``pairs`` (paths of :func:`_flat`) in ``like``'s nesting."""
    if not isinstance(like, Mapping):
        raise TypeError("a spec tree mirrors a dict of leaves")
    values = dict(pairs)

    def build(node, prefix):
        return {key: build(v, f"{prefix}{key}/") if isinstance(v, Mapping)
                else values[f"{prefix}{key}"] for key, v in node.items()}

    return build(like, "")


def match_partition_rules(rules: Rules, tree: Any,
                          strict: bool = False) -> Any:
    """Tree of :class:`PartitionSpec` for ``tree`` from an ordered rule
    table, first match wins. Scalars never partition; an unmatched leaf
    replicates, unless ``strict``: then every unmatched path is collected
    and raised at once."""
    unmatched: List[str] = []
    specs = []
    for path, leaf in _flat(tree):
        ndim = len(_shape(leaf))
        spec = P()
        if ndim:
            for rule in rules:
                if rule.matches(path):
                    spec = _aligned_spec(rule, path, ndim)
                    break
            else:
                unmatched.append(path)
        specs.append((path, spec))
    if strict and unmatched:
        raise ValueError(
            f"strict partition matching: no rule matched "
            f"{len(unmatched)} leaf path(s): {unmatched}")
    return _unflat(specs, tree)


def explain_partition_rules(rules: Rules, tree: Any) -> List[dict]:
    """The which-rule-matched-which-param report, as data: one row per
    leaf with ``path``, ``shape``, the matching ``rule`` pattern (or
    ``<scalar>`` / ``<unmatched>``), and the resulting ``spec``."""
    rows = []
    for path, leaf in _flat(tree):
        shape = _shape(leaf)
        row = {"path": path, "shape": shape, "rule": "<unmatched>",
               "spec": P()}
        if not shape:
            row["rule"] = "<scalar>"
        else:
            for rule in rules:
                if rule.matches(path):
                    row.update(rule=rule.pattern,
                               spec=_aligned_spec(rule, path, len(shape)))
                    break
        rows.append(row)
    return rows


def format_partition_report(rows: List[dict]) -> str:
    """Render :func:`explain_partition_rules` rows as a printable table
    (the ``--partition_report`` output)."""
    if not rows:
        return "(no leaves)"
    wp = max(len(r["path"]) for r in rows)
    wr = max(len(r["rule"]) for r in rows)
    lines = [f"{'param':<{wp}}  {'shape':<18} {'rule':<{wr}}  spec"]
    for r in rows:
        lines.append(f"{r['path']:<{wp}}  "
                     f"{str(r['shape']):<18} {r['rule']:<{wr}}  "
                     f"{r['spec']}")
    return "\n".join(lines)


def parse_partition_rules(text: Optional[str]
                          ) -> Optional[Tuple[PartitionRule, ...]]:
    """``--partition_rules`` grammar → rule table (None passes through).

    Rules are ``;``-separated ``regex=spec`` pairs, ordered. A spec is
    comma-separated per-dim axis entries, right-aligned to each matched
    leaf: an axis name (``model``, ``data``, ...), ``-``/``*``/empty for
    an unsharded dim, or ``a+b`` for a multi-axis dim. An empty spec or
    the word ``replicated`` is ``P()``; a ``^`` prefix left-aligns the
    spec (leading-axis anchor).

    Example: ``"full1/(kernel|bias)$=model; full2/kernel$=model,-; .*="``
    reproduces the CNN table.
    """
    if not text:
        return None
    rules = []
    for i, chunk in enumerate(t for t in text.split(";") if t.strip()):
        pattern, sep, spec_text = chunk.partition("=")
        if not sep or not pattern.strip():
            raise ValueError(
                f"--partition_rules entry {i} ({chunk.strip()!r}) must "
                f"be 'regex=spec' (spec may be empty for replicated)")
        pattern = pattern.strip()
        spec_text = spec_text.strip()
        align = "right"
        if spec_text.startswith("^"):
            align = "left"
            spec_text = spec_text[1:].strip()
        if not spec_text or spec_text == "replicated":
            spec = P()
        else:
            entries = []
            for ent in spec_text.split(","):
                ent = ent.strip()
                if ent in ("", "-", "*"):
                    entries.append(None)
                elif "+" in ent:
                    entries.append(tuple(a.strip() for a in ent.split("+")))
                else:
                    entries.append(ent)
            spec = P(*entries)
        try:
            re.compile(pattern)
        except re.error as e:
            raise ValueError(
                f"--partition_rules entry {i}: bad regex {pattern!r}: {e}")
        rules.append(PartitionRule(pattern, spec, align=align))
    return tuple(rules)


# ---------------------------------------------------------------------------
# Per-model default tables (the JAX package's). First match wins; every
# table ends in a catch-all so the defaults never trip strict mode.
# ---------------------------------------------------------------------------

#: full1 2304→384 column-parallel, full2 384→192 row-parallel (the wide FC
#: pair of the reference model, cifar10cnn.py:130-139); convs and the
#: 192→10 head replicated.
CNN_RULES = (
    PartitionRule(r"full1/(kernel|bias)$", P("model")),
    PartitionRule(r"full2/kernel$", P("model", None)),
    PartitionRule(r".*", P()),
)

#: Megatron pairing: qkv/mlp1 column-parallel (bias rides along),
#: proj/mlp2 row-parallel (bias replicated); right alignment covers the
#: stacked [depth, ...] block leaves.
VIT_RULES = (
    PartitionRule(r"(qkv|mlp1)/(kernel|bias)$", P("model")),
    PartitionRule(r"(proj|mlp2)/kernel$", P("model", None)),
    PartitionRule(r".*", P()),
)

#: Expert parallelism: the expert-major MoE leaves (``w [.., E, D, H]``,
#: ``b [.., E, H]``) shard their expert dim over ``model``
#: (``ops/moe.py``); the router gate stays replicated; attention follows
#: the dense ViT rules.
VIT_MOE_RULES = (
    PartitionRule(r"moe/(w1|w2)$", P("model", None, None)),
    PartitionRule(r"moe/(b1|b2)$", P("model", None)),
    PartitionRule(r"moe/gate", P()),
) + VIT_RULES

#: The pipelined stack's table: stacked block leaves shard their leading
#: (depth) axis over ``pipe``.
VIT_PIPE_RULES = (
    PartitionRule(r"^blocks/", P("pipe"), align="left"),
    PartitionRule(r".*", P()),
)

REPLICATED_RULES = (PartitionRule(r".*", P()),)

_RULES = {"cnn": CNN_RULES, "vit_tiny": VIT_RULES,
          "vit_moe": VIT_MOE_RULES}
_PIPE_RULES = {"vit_tiny": VIT_PIPE_RULES}


def rule_for(model_name: str, pipe: bool = False) -> Rules:
    """The model's default rule table (pipeline table when ``pipe``)."""
    if pipe:
        if model_name not in _PIPE_RULES:
            raise ValueError(
                f"pipeline parallelism is not supported for {model_name!r} "
                f"(supported: {sorted(_PIPE_RULES)})")
        return _PIPE_RULES[model_name]
    return _RULES.get(model_name, REPLICATED_RULES)


def _add_fsdp(spec: PartitionSpec, shape, data_size: int) -> PartitionSpec:
    """ZeRO/FSDP layout: additionally shard the largest still-unsharded
    dim divisible by the ``data``-axis size over ``data`` (the earlier dim
    on a tie); a leaf with no such dim keeps the base spec."""
    if data_size <= 1 or not shape:
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    best = -1
    for i, (dim, e) in enumerate(zip(shape, entries)):
        if e is None and dim % data_size == 0:
            if best < 0 or dim > shape[best]:
                best = i
    if best < 0:
        return spec
    entries[best] = "data"
    return P(*entries)


def param_pspecs(model_name: str, params: Any, pipe: bool = False,
                 fsdp_data: int = 0, rules: Optional[Rules] = None,
                 strict: bool = False) -> Any:
    """Tree of specs matching ``params`` (JAX-layout shapes). ``fsdp_data
    > 1`` layers the ZeRO/FSDP ``data``-axis sharding on top of the rule
    table; ``rules`` (a ``--partition_rules`` table) overrides the
    model's default one; ``strict`` errors on unmatched leaves."""
    table = rules if rules is not None else rule_for(model_name, pipe=pipe)
    specs = match_partition_rules(table, params, strict=strict)
    if not fsdp_data:
        return specs
    shapes = dict(_flat(params))
    return _unflat([(path, _add_fsdp(spec, _shape(shapes[path]), fsdp_data))
                    for path, spec in _flat_specs(specs)], params)


def _flat_specs(specs: Any) -> List[Tuple[str, PartitionSpec]]:
    out = []
    for key in sorted(specs):
        value = specs[key]
        if isinstance(value, PartitionSpec):
            out.append((key, value))
        else:
            out.extend((f"{key}/{p}", s) for p, s in _flat_specs(value))
    return out


#: Optimizer-state entries that mirror the param tree leaf for leaf and
#: take the per-param specs (everything else, the scalar step and
#: Adafactor's factored statistics, stays replicated). ZERO1_KEYS is the
#: subset ``--optimizer_sharding zero1`` shards over ``data``: the
#: moments and the eval-time EMA; the staleness ring serves the forward
#: pass and stays whole.
PARAM_SHAPED_OPT_KEYS = ("momentum", "mu", "nu", "ema", "stale")
ZERO1_KEYS = ("momentum", "mu", "nu", "ema")


def state_pspecs(model_name: str, state: Mapping[str, Any],
                 pipe: bool = False, fsdp_data: int = 0,
                 zero1_data: int = 0, rules: Optional[Rules] = None,
                 strict: bool = False) -> Dict[str, Any]:
    """Specs for a whole state tree ``{"params", "opt", "model_state"}``
    (JAX layouts, as ``ckpt/checkpoint.state_to_tree`` gives it): params
    by the model's rules, the param-shaped optimizer entries mirroring
    them, the rest replicated. ``fsdp_data > 1`` shards params and
    moments over ``data`` (ZeRO-3); ``zero1_data > 1`` only the moments
    and the EMA (ZeRO-1)."""
    def replicated(tree):
        return _unflat([(p, P()) for p, _ in _flat(tree)], tree) \
            if isinstance(tree, Mapping) else P()

    def opt_specs(k, v):
        if k not in PARAM_SHAPED_OPT_KEYS or not isinstance(v, Mapping):
            return replicated(v)
        data = max(fsdp_data, zero1_data if k in ZERO1_KEYS else 0)
        return param_pspecs(model_name, v, pipe=pipe, fsdp_data=data,
                            rules=rules, strict=strict)

    return {"params": param_pspecs(model_name, state["params"], pipe=pipe,
                                   fsdp_data=fsdp_data, rules=rules,
                                   strict=strict),
            "opt": {k: opt_specs(k, v) for k, v in state["opt"].items()},
            "model_state": replicated(state.get("model_state", {}))}


def specs_name_axis(tree: Any, axis: str) -> bool:
    """True iff any spec in ``tree`` (a spec, or a nested dict or list of
    them) names ``axis`` — e.g. an FSDP (``data``-axis) parameter layout,
    told from the spec tree alone."""
    if isinstance(tree, PartitionSpec):
        return any(axis in (p if isinstance(p, tuple) else (p,))
                   for p in tree if p is not None)
    values = tree.values() if isinstance(tree, Mapping) else tree
    return any(specs_name_axis(v, axis) for v in values)


#: The port's mesh axes: ``data``, ``model``, ``seq`` and ``pipe`` ranks.
MESH_AXES = ("data", "model", "seq", "pipe")

#: Where the tensor-parallel combinations still to port are listed.
TP_ROADMAP = "ROADMAP.md Queue 1, the tensor-parallel items"


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def model_dims(spec: PartitionSpec) -> Tuple[int, ...]:
    """The dims of a spec that name ``model``."""
    return tuple(i for i, e in enumerate(spec) if "model" in _axes(e))


def pipe_dims(spec: PartitionSpec) -> Tuple[int, ...]:
    """The dims of a spec that name ``pipe``."""
    return tuple(i for i, e in enumerate(spec) if "pipe" in _axes(e))


def check_axes(specs: Any, sizes: Mapping[str, int],
               megatron: Any = None, pipeline: Any = None) -> None:
    """Raise ``NotImplementedError`` unless every axis the base specs (the
    rule table's, before the ZeRO layout adds ``data``) name is one the
    port can honour: ``seq`` at size 1, which shards nothing; ``model`` at
    size 1 anywhere, above it exactly on the leaves and dims where
    ``megatron`` (the model's default table's specs for the same leaves)
    places it, alone on its dim; ``pipe`` at size 1 anywhere, above it
    exactly where ``pipeline`` (the model's pipeline table's specs,
    :data:`VIT_PIPE_RULES`: the leading axis of ``blocks/``) places it,
    alone on its dim. Sharding a parameter over a rule's ``data``, or over
    another axis larger than 1, is not ported."""
    model = sizes.get("model", 1)
    pipe = sizes.get("pipe", 1)
    want = dict(_flat_specs(megatron)) if megatron is not None else {}
    stages = dict(_flat_specs(pipeline)) if pipeline is not None else {}
    for path, spec in _flat_specs(specs):
        for entry in spec:
            for axis in _axes(entry):
                if axis not in MESH_AXES:
                    raise NotImplementedError(
                        f"partition rule spec for {path!r} names axis "
                        f"{axis!r}; the mesh has {MESH_AXES}")
                if axis == "pipe" and pipe > 1:
                    if entry != "pipe":
                        raise NotImplementedError(
                            f"partition rule spec {spec} for {path!r} "
                            f"splits one dim over {entry}: the pipeline "
                            f"shards a dim over 'pipe' alone; see ROADMAP.md "
                            f"Queue 1, the open sharding items")
                    continue
                if axis == "model" and model > 1:
                    if entry != "model":
                        raise NotImplementedError(
                            f"partition rule spec {spec} for {path!r} "
                            f"splits one dim over {entry}: tensor "
                            f"parallelism shards a dim over 'model' alone; "
                            f"see {TP_ROADMAP}")
                    continue
                if axis == "data" or sizes.get(axis, 1) > 1:
                    raise NotImplementedError(
                        f"partition rule spec {spec} for {path!r} shards "
                        f"over {axis!r} (size {sizes.get(axis, 1)}): only "
                        f"the ZeRO layout's data axis and the Megatron "
                        f"pairs' model axis are ported; see ROADMAP.md "
                        f"Queue 1, the open sharding items")
        if model > 1 and model_dims(spec) != model_dims(
                want.get(path, P())):
            raise NotImplementedError(
                f"partition rule spec {spec} for {path!r} places 'model' "
                f"where the model's Megatron table places "
                f"{want.get(path, P())}: the port's layers run the "
                f"default column/row-parallel pairs only; other 'model' "
                f"placements are {TP_ROADMAP}")
        if pipe > 1 and pipe_dims(spec) != pipe_dims(
                stages.get(path, P())):
            raise NotImplementedError(
                f"partition rule spec {spec} for {path!r} places 'pipe' "
                f"where the model's pipeline table places "
                f"{stages.get(path, P())}: a stage holds the leading "
                f"(depth) rows of the stacked blocks only; see ROADMAP.md "
                f"Queue 1, the open sharding items")


class ModelSlice(NamedTuple):
    """The slice of a leaf one model rank holds: ``length`` entries of the
    port-layout dim ``dim`` (the JAX-layout dim ``jax_dim``) from
    ``start``."""

    dim: int
    jax_dim: int
    start: int
    length: int


def model_slice(name: str, spec: PartitionSpec, jax_shape: Sequence[int],
                model: int, model_rank: int) -> Optional[ModelSlice]:
    """The slice of the leaf ``name`` (JAX-layout shape ``jax_shape``)
    that model rank ``model_rank`` of ``model`` holds under ``spec`` (JAX
    right-aligned, as :func:`param_pspecs` gives it): a contiguous
    ``1/model`` of the dim that names ``model``, in rank order (JAX's
    ``addressable_shards``), or None when the leaf is not split."""
    from dml_cnn_cifar10_tpu_torch import convert

    dims = model_dims(spec)
    if model <= 1 or not dims:
        return None
    jd = dims[0]
    size = jax_shape[jd]
    if size % model:
        raise ValueError(f"leaf {name!r} dim {jd} of size {size} does not "
                         f"split over model_axis={model}")
    n = size // model
    return ModelSlice(convert.port_dim(name, jd), jd, model_rank * n, n)


def stage_slice(name: str, spec: PartitionSpec, jax_shape: Sequence[int],
                pipe: int, pipe_rank: int) -> Optional[ModelSlice]:
    """The rows of the leaf ``name`` (JAX-layout shape ``jax_shape``) that
    pipeline stage ``pipe_rank`` of ``pipe`` holds under ``spec`` (the
    pipeline table's, left-aligned): a contiguous ``1/pipe`` of the dim
    that names ``pipe`` (the depth axis), in stage order, or None when the
    leaf is not split. The depth must split evenly (the JAX package's
    ``ValueError`` text)."""
    from dml_cnn_cifar10_tpu_torch import convert

    dims = pipe_dims(spec)
    if pipe <= 1 or not dims:
        return None
    jd = dims[0]
    depth = jax_shape[jd]
    if depth % pipe:
        raise ValueError(f"depth {depth} not divisible by pipe axis {pipe}")
    n = depth // pipe
    return ModelSlice(convert.port_dim(name, jd), jd, pipe_rank * n, n)
