"""PyTorch port, the partition-rule engine and the ZeRO layout, against the
JAX package's ``parallel/shardings.py`` on the CPU (no ranks spawned).

- The rule engine: first match wins, right/left alignment, strict mode,
  the ``--partition_rules`` grammar, the report text and ``_add_fsdp``
  give the JAX package's specs (equal, and printed the same) on the same
  JAX-layout trees: the cases of ``tests/test_zero1.py:70-155`` and
  ``tests/test_fsdp.py:58-72``, and ``state_pspecs`` of the CNN and the
  ViT under zero1 and fsdp over 2, 4 and 8 data ranks.
- The layout (``parallel/zero.py``): the dim a spec shards maps into the
  port's layout (``full1`` kernel: JAX dim 0 is the port's dim 1; conv2
  ties go to its input channels), leaves with no divisible dim stay whole.
- The guards: the JAX package's messages for the invalid compositions,
  ``NotImplementedError`` for what is not ported, and the CLI's exits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP

from dml_cnn_cifar10_tpu.config import DataConfig as JaxDataConfig
from dml_cnn_cifar10_tpu.config import ModelConfig as JaxModelConfig
from dml_cnn_cifar10_tpu.config import OptimConfig as JaxOptimConfig
from dml_cnn_cifar10_tpu.models.registry import get_model as jax_get_model
from dml_cnn_cifar10_tpu.parallel import shardings as jsh
from dml_cnn_cifar10_tpu.parallel import step as jax_step
from dml_cnn_cifar10_tpu_torch.cli.main import main
from dml_cnn_cifar10_tpu_torch.config import (DataConfig, ModelConfig,
                                              OptimConfig, ParallelConfig)
from dml_cnn_cifar10_tpu_torch.models.registry import get_model
from dml_cnn_cifar10_tpu_torch.parallel import shardings as psh
from dml_cnn_cifar10_tpu_torch.parallel import zero
from dml_cnn_cifar10_tpu_torch.parallel.mesh import Mesh

P = psh.P
VIT = dict(name="vit_tiny", vit_depth=2, vit_dim=64, vit_heads=2,
           patch_size=4, logit_relu=False)


def _shapes(tree):
    """A JAX tree of arrays or ShapeDtypeStructs as nested shape tuples."""
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


def _same(port, jax_tree):
    """Port spec tree == JAX spec tree, leaf for leaf, equal and printed
    the same."""
    jl = jax.tree_util.tree_flatten_with_path(
        jax_tree, is_leaf=lambda x: isinstance(x, JP))[0]
    pl = psh._flat_specs(port) if isinstance(port, dict) else [("", port)]
    assert len(pl) == len(jl)
    for (path, ps), (_, js) in zip(pl, jl):
        assert ps == js and str(ps) == str(js), (path, ps, js)


def _jax_abstract(model_kw, optim_kw):
    mcfg = JaxModelConfig(**model_kw)
    dcfg = JaxDataConfig(crop_height=32, crop_width=32)
    return jax.eval_shape(
        lambda k: jax_step.init_train_state(
            k, jax_get_model(mcfg.name), mcfg, dcfg,
            JaxOptimConfig(**optim_kw)), jax.random.key(0))


def test_rules_first_match_wins_alignment_and_rank_error():
    tree = {"blocks": {"qkv": {"kernel": (4, 64, 192)}, "step": ()}}
    jtree = {"blocks": {"qkv": {"kernel": jax.ShapeDtypeStruct(
        (4, 64, 192), jnp.float32)}, "step": jax.ShapeDtypeStruct(
        (), jnp.int32)}}
    rules = (psh.PartitionRule(r"qkv/kernel$", P("model")),
             psh.PartitionRule(r".*", P("data", None)))
    jrules = (jsh.PartitionRule(r"qkv/kernel$", JP("model")),
              jsh.PartitionRule(r".*", JP("data", None)))
    specs = psh.match_partition_rules(rules, tree)
    _same(specs, jsh.match_partition_rules(jrules, jtree))
    assert specs["blocks"]["qkv"]["kernel"] == P(None, None, "model")
    assert specs["blocks"]["step"] == P()
    left = (psh.PartitionRule(r".*", P("pipe"), align="left"),)
    assert psh.match_partition_rules(left, tree)["blocks"]["qkv"][
        "kernel"] == JP("pipe")
    with pytest.raises(ValueError, match="rank"):
        psh.match_partition_rules((psh.PartitionRule(
            r"step", P("model", None)),), {"step": (3,)})


def test_rules_strict_mode_and_builtin_tables():
    tree = {"a": (8,), "b": (8,)}
    rules = (psh.PartitionRule(r"^a$", P("model")),)
    assert psh.match_partition_rules(rules, tree)["b"] == P()
    with pytest.raises(ValueError, match="b"):
        psh.match_partition_rules(rules, tree, strict=True)
    for model_kw in (dict(name="cnn"), VIT):
        params = _jax_abstract(model_kw, {}).params
        _same(psh.param_pspecs(model_kw["name"], _shapes(params),
                               strict=True),
              jsh.param_pspecs(model_kw["name"], params, strict=True))


@pytest.mark.parametrize("text", [
    "full1/(kernel|bias)$=model; full2/kernel$=model,-; .*=",
    "full1/(kernel|bias)$=model; full2/kernel$=model,-; blocks/=^pipe; "
    "odd=data+model,*; .*=replicated",
    "conv.*/kernel$=-,-,-,model; .*=",
])
def test_parse_partition_rules_grammar_matches_jax(text):
    port, ref = psh.parse_partition_rules(text), \
        jsh.parse_partition_rules(text)
    assert [(r.pattern, tuple(r.spec), r.align) for r in port] \
        == [(r.pattern, tuple(r.spec), r.align) for r in ref]
    params = _jax_abstract(dict(name="cnn"), {}).params
    if "odd" not in text:
        _same(psh.param_pspecs("cnn", _shapes(params), rules=port),
              jsh.param_pspecs("cnn", params, rules=ref))


def test_parse_partition_rules_errors():
    assert psh.parse_partition_rules(None) is None
    assert psh.parse_partition_rules("") is None
    with pytest.raises(ValueError, match="regex=spec"):
        psh.parse_partition_rules("no-equals-sign")
    with pytest.raises(ValueError, match="bad regex"):
        psh.parse_partition_rules("([unclosed=model")


@pytest.mark.parametrize("model_kw", [dict(name="cnn"), VIT],
                         ids=["cnn", "vit"])
def test_partition_report_text_matches_jax(model_kw):
    """``--partition_report``: the port's text for its own model (port
    names and layouts, mapped to JAX paths and shapes) is the JAX
    package's for the same model."""
    params = _jax_abstract(model_kw, {}).params
    name = model_kw["name"]
    ref = jsh.format_partition_report(jsh.explain_partition_rules(
        jsh.rule_for(name), params))
    assert psh.format_partition_report(psh.explain_partition_rules(
        psh.rule_for(name), _shapes(params))) == ref
    mcfg = ModelConfig(**model_kw)
    net = get_model(name)(mcfg, DataConfig(crop_height=32, crop_width=32))
    assert zero.partition_report(net, name, ParallelConfig()) == ref
    assert "full1/kernel" in ref or "blocks/qkv/kernel" in ref


@pytest.mark.parametrize("spec,shape,n,want", [
    ((), (5, 5, 3, 64), 8, (None, None, None, "data")),
    ((), (2304, 384), 8, ("data", None)),
    ((None, "model"), (2304, 384), 8, ("data", "model")),
    ((), (10,), 8, ()),
    ((), (), 8, ()),
    ((), (64,), 1, ()),
    ((), (5, 5, 64, 64), 2, (None, None, "data", None)),   # tie: earlier
    (("model",), (384,), 2, ("model",)),
])
def test_add_fsdp_matches_jax(spec, shape, n, want):
    got = psh._add_fsdp(P(*spec), shape, n)
    assert got == P(*want) == jsh._add_fsdp(JP(*spec), shape, n)
    assert str(got) == str(jsh._add_fsdp(JP(*spec), shape, n))


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("model_kw,optim_kw", [
    (dict(name="cnn"), dict(momentum=0.9, ema_decay=0.9)),
    (VIT, dict(optimizer="adamw")),
], ids=["cnn_momentum_ema", "vit_adamw"])
def test_state_pspecs_match_jax(model_kw, optim_kw, n):
    abstract = _jax_abstract(model_kw, optim_kw)
    tree = {"params": _shapes(abstract.params),
            "opt": {k: _shapes(v) for k, v in abstract.opt.items()},
            "model_state": {}}
    for fsdp, zero1 in ((n, 0), (0, n)):
        ref = jsh.state_pspecs(model_kw["name"], abstract, fsdp_data=fsdp,
                               zero1_data=zero1)
        got = psh.state_pspecs(model_kw["name"], tree, fsdp_data=fsdp,
                               zero1_data=zero1)
        _same(got["params"], ref.params)
        for key in ref.opt:
            _same(got["opt"][key], ref.opt[key])
        assert psh.specs_name_axis(got["params"], "data") == bool(fsdp)
        assert psh.specs_name_axis(got["opt"], "data")


def _mesh(data=2, seq=1):
    return Mesh(world=data * seq, data=data, seq=seq)


def test_layout_maps_jax_dims_into_the_port_layout():
    net = get_model("cnn")(ModelConfig(), DataConfig())
    opt = OptimConfig(optimizer_sharding="zero1", momentum=0.9)
    lay = zero.build_layout(net, "cnn", opt, ParallelConfig(), _mesh(2))
    leaves = lay.leaves
    # JAX full1/kernel [2304, 384]: dim 0; the port's [384, 2304]: dim 1.
    assert (leaves["full1.kernel"].jax_dim, leaves["full1.kernel"].dim) \
        == (0, 1)
    assert leaves["full1.kernel"].shard_shape == (384, 1152)
    # conv2 HWIO [5, 5, 64, 64]: the tie goes to I (JAX dim 2), the
    # port's OIHW dim 1.
    assert (leaves["conv2.kernel"].jax_dim, leaves["conv2.kernel"].dim) \
        == (2, 1)
    # The rule's "model" claims full1's bias: whole on every rank.
    assert leaves["full1.bias"].dim is None
    assert leaves["full3.bias"].dim == 0
    four = zero.build_layout(net, "cnn", opt, ParallelConfig(), _mesh(4))
    assert four.leaves["full3.bias"].dim is None            # 10 % 4
    assert lay.size == sum(l.numel for l in lay.split) == (
        sum(p.numel() for p in net.parameters()) - 384) // 2
    # One data rank, or no mode: nothing to shard.
    assert zero.build_layout(net, "cnn", opt, ParallelConfig(),
                             _mesh(1)) is None
    assert zero.build_layout(net, "cnn", OptimConfig(), ParallelConfig(),
                             _mesh(2)) is None


def test_layout_shard_views_and_packing_are_exact():
    net = get_model("cnn")(ModelConfig(), DataConfig())
    net.reset_parameters(__import__("torch").Generator().manual_seed(0))
    full = {n: p.detach() for n, p in net.named_parameters()}
    layouts = [zero.build_layout(
        net, "cnn", OptimConfig(optimizer_sharding="zero1"),
        ParallelConfig(), Mesh(world=2, data=2, data_rank=r, rank=r))
        for r in (0, 1)]
    for lay in layouts:
        _, values = lay.pack(full, "cpu", copy=True)
        _, packed = lay.pack(full)
        for name, t in values.items():
            want = full[name] if not lay.is_split(name) \
                else lay.shard_of(full[name], name)
            assert t.is_contiguous() and tuple(t.shape) == tuple(want.shape)
            assert bool((t == want).all()) and bool((packed[name] == t).all())
            # A whole leaf is the tensor itself, or a copy with copy=True.
            assert (packed[name] is full[name]) == (not lay.is_split(name))
            assert t is not full[name]
    # The two ranks' shards tile every split leaf exactly.
    for name in full:
        if layouts[0].is_split(name):
            d = layouts[0].leaves[name].dim
            both = np.concatenate([l.pack(full)[1][name].numpy()
                                   for l in layouts], axis=d)
            np.testing.assert_array_equal(both, full[name].numpy())


def test_guards_use_the_jax_messages():
    net = get_model("cnn")(ModelConfig(), DataConfig())
    par = ParallelConfig()
    with pytest.raises(ValueError, match="none | zero1"):
        zero.build_layout(net, "cnn", OptimConfig(
            optimizer_sharding="zero3"), par, _mesh())
    with pytest.raises(ValueError, match="does not compose with --fsdp"):
        zero.build_layout(net, "cnn", OptimConfig(
            optimizer_sharding="zero1"), ParallelConfig(fsdp=True), _mesh())
    with pytest.raises(ValueError, match="async_staleness"):
        zero.build_layout(net, "cnn", OptimConfig(
            optimizer_sharding="zero1", async_staleness=2), par, _mesh())


@pytest.mark.parametrize("case", [
    "seq", "fsdp_staleness", "adafactor", "rule_data", "rule_unknown",
])
def test_not_ported_raises_naming_roadmap(case):
    net = get_model("cnn")(ModelConfig(), DataConfig())
    opt, par, mesh = OptimConfig(), ParallelConfig(fsdp=True), _mesh()
    if case == "seq":
        mesh = _mesh(2, 2)
    elif case == "fsdp_staleness":
        opt = OptimConfig(async_staleness=2)
    elif case == "adafactor":
        opt = OptimConfig(optimizer="adafactor")
    elif case == "rule_data":
        par = ParallelConfig(fsdp=True, partition_rules="full1/kernel$=data")
    else:
        par = ParallelConfig(partition_rules="full1/kernel$=bogus")
    with pytest.raises(NotImplementedError) as e:
        zero.build_layout(net, "cnn", opt, par, mesh)
    assert case == "rule_unknown" or "ROADMAP.md" in str(e.value)


def test_strict_rules_and_size1_axes():
    net = get_model("cnn")(ModelConfig(), DataConfig())
    with pytest.raises(ValueError, match="strict partition matching"):
        zero.build_layout(net, "cnn", OptimConfig(), ParallelConfig(
            partition_rules="conv1/kernel$=model",
            partition_rules_strict=True), _mesh())
    # A rule naming model (size 1) shards nothing but claims its dim.
    lay = zero.build_layout(net, "cnn", OptimConfig(), ParallelConfig(
        fsdp=True, partition_rules="full1/kernel$=model,-; .*="), _mesh())
    assert lay.leaves["full1.kernel"].jax_dim == 1     # 384, not 2304
    assert lay.leaves["full1.bias"].dim == 0


@pytest.mark.parametrize("argv,match", [
    (["--ckpt_format", "orbax"], "orbax"),
    (["--optimizer_sharding", "zero1", "--fsdp", "true"],
     "does not compose with --fsdp"),
    (["--optimizer_sharding", "zero1", "--async_staleness", "2"],
     "async_staleness"),
])
def test_cli_guards(argv, match, tmp_path):
    with pytest.raises(SystemExit, match=match):
        main(["--device", "cpu", "--log_dir", str(tmp_path)] + argv)
