"""PyTorch port, tensor parallelism (``--model_axis``) against the JAX
package's ``data x model`` mesh and the port's replicated run, on the CPU.

Without ranks: each leaf's local shape on a model rank equals the JAX
package's ``addressable_shards[0]`` shape under its rule table (the cases
of ``tests/test_tp.py:55-138``); a model rank's slices are the whole
seeded init's; the ViT's heads check, the ``NotImplementedError`` of each
combination that is not ported, and the FLOP count of a rank.

One spawn of 4 gloo ranks (data 2 x model 2, ``tests/_torch_dist.py:
tp_runs``) runs every CNN case at published widths, batch 16, 3 steps, from
the JAX package's init on that mesh: plain SGD, momentum 0.9, zero1,
fsdp, AdamW with the EMA, LARS and LAMB with clipping, each against JAX
``make_train_step`` on ``data=2, model=2`` in the same layout (zero1 and
fsdp as the JAX package's ``--optimizer_sharding zero1`` and ``--fsdp``)
and against the port's replicated run (one process, the same global
batches); each at the pins of ``tests/test_tp.py:104-121`` (losses rtol 1e-5,
atol 1e-6; parameters rtol 2e-5, atol 2e-6), with the health scalars
(rtol 1e-5); replicated leaves bit-equal across the model ranks; a chunk
of 3 steps equal to the 3 steps. (The ViT is ``test_torch_tp_vit.py``,
the checkpoints ``test_torch_tp_ckpt.py``.) AdamW's step
``m / (sqrt(v) + eps)`` is about ``lr * sign(g)`` for any ``|g|`` far above
``eps``, so where a gradient is rounding noise (the key slice of
``qkv``'s bias, whose gradient is 0 in exact arithmetic: a key bias
shifts every logit of a row alike) the step's direction differs between
any two summation orders, as between the JAX package's own layouts:
those elements (replicated RMS gradient below ``100 eps``), and at most
2 others (or 1 in 10^4) whose gradient's float32 sum cancels, are held to
``steps * lr`` and every other element to the pins; the AdamW and LAMB
runs' update ratio, which sums their steps, to 1e-3 relative.
"""

import concurrent.futures

import jax
import numpy as np
import pytest
import torch

import _torch_dist
from dml_cnn_cifar10_tpu.config import DataConfig as JaxDataConfig
from dml_cnn_cifar10_tpu.config import ModelConfig as JaxModelConfig
from dml_cnn_cifar10_tpu.config import OptimConfig as JaxOptimConfig
from dml_cnn_cifar10_tpu.config import ParallelConfig as JaxParallelConfig
from dml_cnn_cifar10_tpu.models.registry import get_model as jax_get_model
from dml_cnn_cifar10_tpu.parallel import mesh as jax_mesh
from dml_cnn_cifar10_tpu.parallel import step as jax_step
from dml_cnn_cifar10_tpu_torch import convert
from dml_cnn_cifar10_tpu_torch.ckpt import checkpoint as ckpt_lib
from dml_cnn_cifar10_tpu_torch.cli.main import main as cli_main
from dml_cnn_cifar10_tpu_torch.config import (DataConfig, ModelConfig,
                                              OptimConfig, ParallelConfig,
                                              TrainConfig)
from dml_cnn_cifar10_tpu_torch.models.registry import get_model
from dml_cnn_cifar10_tpu_torch.parallel import step as step_lib
from dml_cnn_cifar10_tpu_torch.parallel import zero
from dml_cnn_cifar10_tpu_torch.parallel.mesh import Mesh
from dml_cnn_cifar10_tpu_torch.utils import profiling

LOSS_PIN = dict(rtol=1e-5, atol=1e-6)
PARAM_PIN = dict(rtol=2e-5, atol=2e-6)
CNN = dict(name="cnn", logit_relu=False)
VIT = dict(name="vit_tiny", logit_relu=False, vit_depth=2, vit_dim=64,
           vit_heads=2, patch_size=8)
SGD = dict(learning_rate=0.01)
MOM = dict(learning_rate=0.01, momentum=0.9)
ADAMW = dict(optimizer="adamw", learning_rate=1e-3)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batches(seed, n=3, b=16, hw=24):
    rng = np.random.default_rng(seed)
    return [(rng.normal(0.5, 0.25, (b, hw, hw, 3)).astype(np.float32),
             rng.integers(0, 10, b).astype(np.int32)) for _ in range(n)]


def jax_train(model_kw, optim_kw, batches, data, model, mode="none"):
    """JAX steps on a ``data x model`` mesh of virtual CPU devices, the
    state laid out by ``mode`` (none | zero1 | fsdp, as the JAX package's
    ``--optimizer_sharding zero1`` / ``--fsdp``): ``(initial params,
    per-step loss, final params)`` as numpy trees."""
    mcfg = JaxModelConfig(**model_kw)
    dcfg = JaxDataConfig(normalize="scale")
    ocfg = JaxOptimConfig(**optim_kw, optimizer_sharding=(
        "zero1" if mode == "zero1" else "none"))
    mesh = jax_mesh.build_mesh(
        JaxParallelConfig(data_axis=data, model_axis=model),
        devices=jax.devices()[:data * model])
    model_def = jax_get_model(mcfg.name)
    sh = jax_step.train_state_shardings(mesh, model_def, mcfg, dcfg, ocfg,
                                        fsdp=mode == "fsdp",
                                        zero1=mode == "zero1")
    state = jax_step.init_train_state(jax.random.key(0), model_def, mcfg,
                                      dcfg, ocfg, mesh, state_sharding=sh)
    params0 = _np(state.params)
    train = jax_step.make_train_step(model_def, mcfg, ocfg, mesh,
                                     state_sharding=sh)
    losses = []
    for images, labels in batches:
        state, m = train(state, *jax_mesh.shard_batch(mesh, images, labels))
        losses.append(float(m["loss"]))
    return params0, losses, _np(state.params)


def replicated(run):
    """The port's replicated run of ``run`` in this process (one rank,
    the global batches): ``(per-step metrics, state tree, state)``; the
    state carries the eval accuracy of ``run["eval"]`` as ``eval``."""
    mcfg = ModelConfig(**run["model"])
    net = get_model(mcfg.name)(mcfg, DataConfig(**run.get("data", {})))
    ocfg = OptimConfig(**run["optim"])
    state = step_lib.init_train_state(net, ocfg, torch.device("cpu"),
                                      torch.Generator().manual_seed(0))
    tree = ckpt_lib.state_to_tree(state)
    tree["params"] = run["params"]
    if "ema" in tree["opt"]:
        tree["opt"]["ema"] = run["params"]
    ckpt_lib.load_tree_into(state, tree)
    train = step_lib.make_train_step(net, ocfg, health_metrics=True)
    metrics = []
    for images, labels in run["batches"]:
        _, m = train(state, torch.from_numpy(images),
                     torch.from_numpy(labels.astype(np.int64)))
        metrics.append({k: float(v) for k, v in m.items()})
    if "eval" in run:
        images, labels = run["eval"]
        state.eval = float(step_lib.make_eval_step(net)(
            state, torch.from_numpy(images),
            torch.from_numpy(labels.astype(np.int64)))["accuracy"])
    return metrics, ckpt_lib.state_to_tree(state), state


def _leaves(tree):
    return [(jax.tree_util.keystr(p), np.asarray(v)) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


def _close(got, want, what, skip=None, **pin):
    """``got`` within ``pin`` of ``want`` leaf for leaf; ``skip(path,
    got, want)`` may hold a leaf to its own bound instead."""
    lg, lw = _leaves(got), _leaves(want)
    assert [p for p, _ in lg] == [p for p, _ in lw], what
    for (path, x), (_, y) in zip(lg, lw):
        if skip is not None and skip(path, x, y):
            continue
        np.testing.assert_allclose(x, y, err_msg=f"{what} {path}", **pin)


def _losses(metrics):
    return [m["loss"] for m in metrics]


def _adam_noise(rep_tree, steps, lr, b2=0.999, eps=1e-8):
    """A ``skip`` for :func:`_close` on an AdamW run. AdamW's step ``m /
    (sqrt(v) + eps)`` is near ``sign(g)`` whatever ``|g|``, so an element
    whose gradient is rounding noise (bias-corrected RMS gradient in the
    replicated run, ``sqrt(nu / (1 - b2^steps))``, below ``100 eps``) or
    whose few float32 digits cancel in the gradient's sum moves by up to
    ``lr`` a step in a direction the summation order decides: the params'
    (and the EMA's) elements are held to the pins but those flat ones and
    at most 2 others or 1 in 10^4, and each of these to ``steps * lr``."""
    nu = dict(_leaves(rep_tree["opt"]["nu"]))

    def skip(path, x, y):
        for prefix in ("['params']", "['opt']['ema']", ""):
            leaf = path[len(prefix):]
            if path.startswith(prefix) and leaf in nu:
                break
        else:
            return False
        flat = np.sqrt(nu[leaf] / (1 - b2 ** steps)) < 100 * eps
        far = ~np.isclose(x, y, **PARAM_PIN)
        assert (far & ~flat).sum() <= max(2, x.size // 10 ** 4), (
            path, far.sum(), x.size)
        assert np.abs(x - y)[far | flat].max(initial=0) \
            <= steps * lr * 1.001, path
        return True

    return skip


# ---------------------------------------------------------------------------
# Without ranks.
# ---------------------------------------------------------------------------


def _port_model(name_kw, model, model_rank):
    mcfg = ModelConfig(**name_kw)
    return get_model(mcfg.name)(mcfg, DataConfig(), mesh=Mesh(
        world=model, model=model, model_rank=model_rank))


@pytest.mark.parametrize("model_kw", [CNN, VIT], ids=["cnn", "vit"])
def test_local_shapes_equal_jax_addressable_shards(model_kw):
    mcfg = JaxModelConfig(**model_kw)
    dcfg = JaxDataConfig(normalize="scale")
    mesh = jax_mesh.build_mesh(JaxParallelConfig(data_axis=4, model_axis=2))
    model_def = jax_get_model(mcfg.name)
    sh = jax_step.train_state_shardings(mesh, model_def, mcfg, dcfg,
                                        JaxOptimConfig())
    state = jax_step.init_train_state(jax.random.key(0), model_def, mcfg,
                                      dcfg, JaxOptimConfig(), mesh,
                                      state_sharding=sh)
    want = {".".join(k.key for k in path): tuple(
        leaf.addressable_shards[0].data.shape) for path, leaf in
        jax.tree_util.tree_flatten_with_path(state.params)[0]}
    for rank in (0, 1):
        net = _port_model(model_kw, 2, rank)
        got = {n: convert.jax_shape(n, p.shape)
               for n, p in net.named_parameters()}
        assert got == want
    split = sorted(net.split.slices)
    assert split == (["full1.bias", "full1.kernel", "full2.kernel"]
                     if model_kw is CNN else
                     sorted(f"blocks.{m}.{leaf}" for m, leaf in (
                         ("mlp1", "bias"), ("mlp1", "kernel"),
                         ("mlp2", "kernel"), ("qkv", "bias"),
                         ("qkv", "kernel"), ("proj", "kernel"))))


@pytest.mark.parametrize("model_kw", [CNN, VIT], ids=["cnn", "vit"])
def test_model_ranks_keep_slices_of_the_whole_seeded_init(model_kw):
    whole = get_model(model_kw["name"])(ModelConfig(**model_kw),
                                        DataConfig())
    whole.reset_parameters(torch.Generator().manual_seed(3))
    want = dict(whole.named_parameters())
    parts = []
    for rank in (0, 1):
        net = _port_model(model_kw, 2, rank)
        net.reset_parameters(torch.Generator().manual_seed(3))
        parts.append({n: p.detach() for n, p in net.named_parameters()})
    for name, p in want.items():
        sl = net.split.slices.get(name)
        got = parts[0][name] if sl is None else torch.cat(
            [part[name] for part in parts], sl.dim)
        assert torch.equal(got, p.detach()), name
    # The inverse: the whole JAX tree cut to rank 1's slices.
    tree = convert.params_to_jax({n: p.detach() for n, p in want.items()})
    local = net.split.local(convert.params_from_jax(tree))
    for name, p in parts[1].items():
        assert torch.equal(local[name], p), name


def test_vit_heads_must_split_whole_over_model_ranks():
    # Heads the model ranks cut in two (3 over 2): each rank holds half the
    # heads-major qkv columns and proj rows, and attends with the heads
    # its proj rows overlap (models/vit.py); widths the ranks do not
    # divide raise.
    for rank, span, offset in ((0, (0, 2), 0), (1, (1, 3), 8)):
        net = _port_model(dict(VIT, vit_heads=3, vit_dim=48), 2, rank)
        assert not net.whole_heads and net.head_span == span
        assert net.local_heads == 2 and net.row_offset == offset
        assert tuple(net.blocks.qkv.kernel.shape) == (2, 48, 72)
        assert tuple(net.blocks.proj.kernel.shape) == (2, 24, 48)
    with pytest.raises(ValueError, match="does not split over "
                                         "model_axis=5"):
        _port_model(dict(VIT, vit_heads=3, vit_dim=48), 5, 0)
    # ViT-Ti's 3 heads over 3 model ranks: one head (64 wide) a rank.
    net = _port_model(dict(name="vit_tiny"), 3, 2)
    assert net.local_heads == 1
    assert tuple(net.blocks.qkv.kernel.shape) == (12, 192, 192)
    assert tuple(net.blocks.proj.kernel.shape) == (12, 64, 192)


def _raises_roadmap(fn):
    with pytest.raises(NotImplementedError) as e:
        fn()
    assert "ROADMAP.md" in str(e.value)


@pytest.mark.parametrize("case", ["tp_sp", "adafactor_init",
                                  "adafactor_layout", "rule_on_conv",
                                  "rule_two_axes", "rule_drops_pair",
                                  "export", "serve"])
def test_out_of_scope_combinations_raise(case, tmp_path):
    mesh = Mesh(world=2, model=2)
    net = _port_model(CNN, 2, 0)
    if case == "tp_sp":
        _raises_roadmap(lambda: get_model("vit_tiny")(
            ModelConfig(name="vit_tiny", pool="mean"), DataConfig(),
            mesh=Mesh(world=4, model=2, seq=2)))
    elif case == "adafactor_init":
        _raises_roadmap(lambda: step_lib.init_train_state(
            net, OptimConfig(optimizer="adafactor"), torch.device("cpu")))
    elif case == "adafactor_layout":
        _raises_roadmap(lambda: zero.build_layout(
            net, "cnn", OptimConfig(optimizer="adafactor"),
            ParallelConfig(model_axis=2), mesh))
    elif case.startswith("rule_"):
        rules = {"rule_on_conv": "conv1/kernel$=model; .*=",
                 "rule_two_axes": r"full1/(kernel|bias)$=data+model; "
                                  r"full2/kernel$=model,-; .*=",
                 "rule_drops_pair": "full1/(kernel|bias)$=model; .*="}[case]
        _raises_roadmap(lambda: zero.build_layout(
            net, "cnn", OptimConfig(), ParallelConfig(
                model_axis=2, partition_rules=rules), mesh))
    else:
        _raises_roadmap(lambda: cli_main([
            "--device", "cpu", "--mode", case, "--model_axis", "2",
            "--log_dir", str(tmp_path), "--serve_port", "0"]))


def test_default_and_equal_rule_tables_pass_check():
    net = _port_model(CNN, 2, 0)
    for rules in (None, "full1/(kernel|bias)$=model; full2/kernel$=model,-;"
                        " .*="):
        assert zero.build_layout(net, "cnn", OptimConfig(), ParallelConfig(
            model_axis=2, partition_rules=rules), Mesh(world=2, model=2)) \
            is None
    report = zero.partition_report(net, "cnn", ParallelConfig(model_axis=2))
    assert "full1/kernel  (2304, 384)" in report


def test_step_flops_count_the_rank_local_widths():
    cfg = TrainConfig(batch_size=128)
    rep, label = profiling.step_flops(cfg, data=2)
    tp_flops, tp_label = profiling.step_flops(cfg, data=2, model=2)
    assert (label, tp_label) == ("exact", "model_share_x2")
    # full1 and full2 at half width: forward and both backward products.
    fc = 3 * 2 * (2304 * 384 + 384 * 192) // 2 * 64
    shapes = {n: tuple(p.shape) for n, p in _port_model(
        CNN, 2, 0).named_parameters()}
    whole = {n: tuple(p.shape) for n, p in get_model("cnn")(
        ModelConfig(), DataConfig()).named_parameters()}
    update = profiling.update_flops(cfg.optim, whole) \
        - profiling.update_flops(cfg.optim, shapes)
    assert rep - tp_flops == fc + update


# ---------------------------------------------------------------------------
# 4 ranks, data 2 x model 2: the CNN.
# ---------------------------------------------------------------------------

CNN_RUNS = {
    "sgd": dict(optim=SGD),
    "momentum": dict(optim=MOM),
    "zero1": dict(optim=MOM, mode="zero1"),
    "fsdp": dict(optim=MOM, mode="fsdp"),
    "adamw_ema": dict(optim=dict(ADAMW, ema_decay=0.9)),
    "lars": dict(optim=dict(optimizer="lars", learning_rate=0.1,
                            weight_decay=1e-4)),
    "lamb_clip": dict(optim=dict(optimizer="lamb", learning_rate=1e-3,
                                 weight_decay=1e-4, grad_clip_norm=0.5)),
    "chunk": dict(optim=MOM, chunk=True),
}


@pytest.fixture(scope="module")
def cnn(tmp_path_factory):
    batches = _batches(5)
    jax_res = {"sgd": jax_train(CNN, SGD, batches, 2, 2)}
    params0 = jax_res["sgd"][0]
    runs = {name: dict(run, model=CNN, params=params0, batches=batches,
                       eval=batches[0])
            for name, run in CNN_RUNS.items()}
    # The ranks run in their processes while this one runs JAX and the
    # replicated steps.
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(_torch_dist.run_ranks, "tp_runs", 4,
                            tmp_path_factory.mktemp("tp_cnn"), 2, runs)
        jax_res.update({name: jax_train(CNN, run["optim"], batches, 2, 2,
                                        run.get("mode", "none"))
                        for name, run in CNN_RUNS.items()
                        if name not in ("sgd", "chunk")})
        reps = {name: replicated(run) for name, run in runs.items()
                if name != "chunk"}
        ranks = ranks.result()
    return ranks, reps, jax_res


def test_rank_order_is_jax_data_model(cnn):
    ranks, _, _ = cnn
    assert [r["coords"] for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    # The broadcast that keeps the replicated leaves' gradients equal
    # over the model ranks sends model rank 0's copy (rank d * 2).
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["broadcast"], [r // 2 * 2] * 3)


@pytest.mark.parametrize("name", ["sgd", "momentum"])
def test_cnn_tp_matches_jax_and_replicated(cnn, name):
    ranks, reps, jax_res = cnn
    _, jax_losses, jax_params = jax_res[name]
    rep_metrics, rep_tree, _ = reps[name]
    for r in ranks:
        got = r[name]
        np.testing.assert_allclose(_losses(got["metrics"]), jax_losses,
                                   **LOSS_PIN)
        np.testing.assert_allclose(_losses(got["metrics"]),
                                   _losses(rep_metrics), **LOSS_PIN)
        _close(got["tree"]["params"], jax_params, f"{name} vs JAX",
               **PARAM_PIN)
        _close(got["tree"]["params"], rep_tree["params"],
               f"{name} vs replicated", **PARAM_PIN)


@pytest.mark.parametrize("name", ["zero1", "fsdp", "adamw_ema", "lars",
                                  "lamb_clip"])
def test_cnn_tp_composes_with_sharding_and_optimizers(cnn, name):
    ranks, reps, jax_res = cnn
    _, jax_losses, jax_params = jax_res[name]
    rep_metrics, rep_tree, _ = reps[name]
    skip = _adam_noise(rep_tree, 3, ADAMW["learning_rate"]) \
        if name == "adamw_ema" else None
    for r in ranks:
        got = r[name]
        np.testing.assert_allclose(_losses(got["metrics"]), jax_losses,
                                   **LOSS_PIN)
        np.testing.assert_allclose(_losses(got["metrics"]),
                                   _losses(rep_metrics), **LOSS_PIN)
        # The JAX package's step on the same mesh and layout.
        _close(got["tree"]["params"], jax_params, f"{name} vs JAX", skip,
               **PARAM_PIN)
        # The whole state: params, moments, the EMA, the step.
        _close(got["tree"], rep_tree, f"{name} vs replicated", skip,
               **PARAM_PIN)
        # Eval runs the tensor-parallel forward (the EMA when kept).
        assert got["eval"] == reps[name][2].eval


def test_cnn_tp_health_scalars_match_replicated(cnn):
    ranks, reps, _ = cnn
    for name, (rep_metrics, _, _) in reps.items():
        for r in ranks:
            for key in ("health_grad_norm", "health_param_norm",
                        "health_update_ratio"):
                # The Adam family's update holds the noise-driven steps
                # of _adam_noise (2e-4 of its norm here).
                rtol = 1e-3 if key == "health_update_ratio" and name in (
                    "adamw_ema", "lamb_clip") else 1e-5
                np.testing.assert_allclose(
                    [m[key] for m in r[name]["metrics"]],
                    [m[key] for m in rep_metrics], rtol=rtol,
                    err_msg=f"{name} {key}")


def test_replicated_leaves_bit_equal_across_model_ranks(cnn):
    ranks, _, _ = cnn
    split = ("full1.kernel", "full1.bias", "full2.kernel")
    for name in CNN_RUNS:
        for a, b in ((0, 1), (2, 3)):
            la, lb = ranks[a][name]["local"], ranks[b][name]["local"]
            for leaf in la:
                if leaf not in split:
                    np.testing.assert_array_equal(la[leaf], lb[leaf],
                                                  err_msg=f"{name} {leaf}")
        # The data ranks of one model rank hold the same slices (fsdp:
        # each its own shard of them).
        for a, b in ((0, 2), (1, 3)):
            if CNN_RUNS[name].get("mode") != "fsdp":
                for leaf, x in ranks[a][name]["local"].items():
                    np.testing.assert_array_equal(
                        x, ranks[b][name]["local"][leaf], err_msg=leaf)
        _close(ranks[0][name]["tree"], ranks[3][name]["tree"],
               f"{name} rank 0 vs 3", rtol=0, atol=0)


def test_cnn_weights_really_sharded(cnn):
    ranks, reps, _ = cnn
    whole = sum(t.numel() * 4 for t in reps["momentum"][2].params.values())
    for r in ranks:
        local = r["momentum"]["local"]
        assert local["full1.kernel"].shape == (192, 2304)
        assert local["full1.bias"].shape == (192,)
        assert local["full2.kernel"].shape == (192, 192)
        assert local["full2.bias"].shape == (192,)
        assert local["conv2.kernel"].shape == (64, 64, 5, 5)
        half = (2304 * 384 + 384 + 384 * 192) * 4 // 2
        assert r["momentum"]["param_bytes"] == whole - half
        # fsdp shards every model-local leaf with a free divisible dim.
        assert r["fsdp"]["param_bytes"] < r["momentum"]["param_bytes"] / 1.5


def test_cnn_tp_chunk_equals_steps(cnn):
    ranks, _, _ = cnn
    for r in ranks:
        assert r["chunk"]["metrics"][-1]["loss"] == \
            r["momentum"]["metrics"][-1]["loss"]
        _close(r["chunk"]["tree"], r["momentum"]["tree"], "chunk vs steps",
               rtol=0, atol=0)
