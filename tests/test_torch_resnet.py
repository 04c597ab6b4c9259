"""PyTorch port, ``models/resnet.py`` + ``ops/layers.py:batch_norm`` +
``convert.py``, against the JAX package's ``models/resnet.py`` on the CPU.

From the same params and running stats (JAX's init, perturbed with seeded
numpy noise so every residual branch is live, carried over by
``convert.py``), on the same seeded numpy images, the port's train-mode
forward and backward must give JAX ``resnet.apply(train=True)``'s logits,
new BN state and gradients, and its eval forward (on the stats given)
JAX's eval logits: ResNet-18 at 32 px (batch 4), ResNet-50 at 32 px and
at 72 px (the ImageNet stem with its max pool), the ``nf`` and ``s2d``
variants (s2d on ResNet-18 at 72 px: the stem is what it changes),
``remat`` and bf16 compute; the ResNet-50 cases at batch 2.

Tolerances, as relative errors (``err / scale`` of each leaf):

- f32 logits, new BN state and eval logits: ``max|Δ| / max|jax|`` at
  most 2e-5 (the SGD parity pin; measured at most 4.8e-6);
- f32 gradients: over the whole gradient ``‖Δ‖₂ / ‖g‖₂`` at most 2e-3
  (measured at most 5.4e-4), and each leaf's ``‖Δ‖₂ / ‖g‖₂`` at most
  3e-2 (measured at most 1.1e-2). The per-leaf pin is wide because a
  ReLU whose input lies within rounding of 0 takes a different side in
  the two frameworks (their f32 convolutions sum in different orders):
  one flipped position of a 64-channel layer moves that layer's small
  gradient by percents (ResNet-18's ``stage1[0].bn1.offset``: one channel
  off by 1.3e-4 where the others agree to 1e-6; the port in f32 matches
  itself in f64 to 2e-6 there, the JAX package's f32 matches its f64 to
  2e-3). ROADMAP.md Queue 3 keeps these numbers;
- bf16 compute: logits 2e-2 (measured 7.4e-3), state and eval 1e-2
  (2.9e-3, 4.1e-3), the whole gradient 0.1 (5.1e-2): XLA fuses the
  normalize and keeps its intermediates in f32 where torch rounds each
  op to bf16.

The structure tests are the JAX package's (``tests/test_resnet.py``):
shapes, parameter counts at the published geometry (counted on the
``meta`` device), the train/eval contract of the running stats, eval
determinism and batch independence, blocks that start as the identity,
the s2d fold and weight standardization.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dml_cnn_cifar10_tpu.config import DataConfig as JaxDataConfig
from dml_cnn_cifar10_tpu.config import ModelConfig as JaxModelConfig
from dml_cnn_cifar10_tpu.models import resnet as jax_resnet
from dml_cnn_cifar10_tpu.ops import layers as jax_layers
from dml_cnn_cifar10_tpu.train import loss as jax_loss
from dml_cnn_cifar10_tpu_torch import convert
from dml_cnn_cifar10_tpu_torch.config import DataConfig, ModelConfig
from dml_cnn_cifar10_tpu_torch.models import resnet
from dml_cnn_cifar10_tpu_torch.models.registry import get_model
from dml_cnn_cifar10_tpu_torch.ops import layers as L
from dml_cnn_cifar10_tpu_torch.train import loss as loss_lib

torch.set_num_threads(2)

# (forward max, state/eval max, whole-gradient norm, per-leaf norm)
F32 = (2e-5, 2e-5, 2e-3, 3e-2)
BF16 = (2e-2, 1e-2, 0.1, None)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _setup(name, hw, batch=4, seed=0, **kw):
    """JAX configs, perturbed params and running stats (numpy), images
    and labels."""
    mcfg = JaxModelConfig(name=name, logit_relu=False, **kw)
    dcfg = JaxDataConfig(crop_height=hw, crop_width=hw)
    params = _np(jax_resnet.init_params(jax.random.key(seed), mcfg, dcfg,
                                        depth=resnet.depth_of(name)))
    state = _np(jax_resnet.init_state(params))
    rng = np.random.default_rng(seed)

    def noisy(a, scale):
        return (a + scale * rng.standard_normal(a.shape)).astype(a.dtype)

    params = jax.tree.map(lambda a: noisy(a, 0.05), params)
    state = jax.tree.map(
        lambda a: noisy(a, 0.1) if not np.all(a == 1) else
        (1.0 + np.abs(noisy(np.zeros_like(a), 0.2))).astype(a.dtype), state)
    images = rng.uniform(0, 1, (batch, hw, hw, 3)).astype(np.float32)
    labels = rng.integers(0, 10, batch).astype(np.int32)
    return mcfg, dcfg, params, state, images, labels


def _port(name, hw, params, state, **kw):
    net = get_model(name)(ModelConfig(name=name, logit_relu=False, **kw),
                          DataConfig(crop_height=hw, crop_width=hw))
    own = dict(net.named_parameters())
    bufs = dict(net.named_buffers())
    flat = convert.params_from_jax(params)
    assert set(flat) == set(own)
    mflat = convert.params_from_jax(state)
    assert set(mflat) == set(bufs)
    with torch.no_grad():
        for n, v in flat.items():
            own[n].copy_(v)
        for n, v in mflat.items():
            bufs[n].copy_(v)
    return net


def _jax_grad(mcfg, params, state, images, labels):
    def loss(p):
        logits, ns = jax_resnet.apply(p, state, images, mcfg, train=True)
        return jax_loss.softmax_cross_entropy(logits, labels), (logits, ns)

    (_, (logits, ns)), grads = jax.jit(
        jax.value_and_grad(loss, has_aux=True))(params)
    eval_logits, _ = jax.jit(lambda p: jax_resnet.apply(
        p, state, images, mcfg, train=False))(params)
    return _np(logits), _np(ns), _np(grads), np.asarray(eval_logits)


def _port_grad(net, images, labels):
    """Eval logits (on the stats given), then one train-mode forward and
    backward, which moves the stats."""
    params = dict(net.named_parameters())
    net.eval()
    with torch.no_grad():
        eval_logits = net(torch.from_numpy(images))
    net.train()
    logits = net(torch.from_numpy(images))
    loss = loss_lib.softmax_cross_entropy(
        logits, torch.from_numpy(labels.astype(np.int64)))
    grads = torch.autograd.grad(loss, list(params.values()))
    state = convert.state_to_jax(dict(net.named_buffers()), params,
                                 lists=True)
    return (logits.detach().numpy(), state,
            convert.params_to_jax(dict(zip(params, grads)), lists=True),
            eval_logits.numpy())


def _rel(got, want, tol, what):
    """``max|got − want| / max|want|`` at most ``tol``."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                1e-30)
    assert err <= tol, f"{what}: rel err {err:.3g} > {tol}"


def _pairs(got, want, what):
    g, gdef = jax.tree.flatten_with_path(got)
    w, wdef = jax.tree.flatten_with_path(want)
    assert gdef == wdef, what
    return [(jax.tree_util.keystr(p), np.asarray(a, np.float64),
             np.asarray(b, np.float64)) for (p, a), (_, b) in zip(g, w)]


def _rel_tree(got, want, tol, what):
    for path, a, b in _pairs(got, want, what):
        _rel(a, b, tol, f"{what} {path}")


def _norm_rel(got, want, whole_tol, leaf_tol, what):
    """``‖Δ‖₂ / ‖want‖₂`` over the whole tree, and over each leaf."""
    pairs = _pairs(got, want, what)
    num = sum(float(np.sum((a - b) ** 2)) for _, a, b in pairs)
    den = sum(float(np.sum(b ** 2)) for _, a, b in pairs)
    err = (num / den) ** 0.5
    assert err <= whole_tol, f"{what}: rel norm {err:.3g} > {whole_tol}"
    if leaf_tol is None:
        return
    for path, a, b in pairs:
        err = float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))
        assert err <= leaf_tol, \
            f"{what} {path}: rel norm {err:.3g} > {leaf_tol}"


# name, image side, batch, model flags, pins
CASES = {
    "r18_32": ("resnet18", 32, 4, {}, F32),
    "r50_32": ("resnet50", 32, 2, {}, F32),
    "r50_72_imagenet_stem": ("resnet50", 72, 2, {}, F32),
    "r18_nf": ("resnet18", 32, 4, {"resnet_norm": "nf"}, F32),
    "r18_72_s2d": ("resnet18", 72, 2, {"resnet_s2d": True}, F32),
    "r18_remat": ("resnet18", 32, 4, {"remat": True}, F32),
    "r18_bf16": ("resnet18", 32, 4, {"compute_dtype": "bfloat16"}, BF16),
}


@pytest.mark.parametrize("case", list(CASES))
def test_train_and_eval_match_jax(case):
    name, hw, batch, kw, (fwd, state_tol, whole, leaf) = CASES[case]
    mcfg, _, params, state, images, labels = _setup(name, hw, batch, **kw)
    j_logits, j_state, j_grads, j_eval = _jax_grad(mcfg, params, state,
                                                   images, labels)
    net = _port(name, hw, params, state, **kw)
    logits, p_state, grads, eval_logits = _port_grad(net, images, labels)
    assert logits.dtype == np.float32
    _rel(logits, j_logits, fwd, "train logits")
    _rel_tree(p_state, j_state, state_tol, "new BN state")
    _norm_rel(grads, j_grads, whole, leaf, "grads")
    _rel(eval_logits, j_eval, state_tol, "eval logits")


def test_remat_updates_running_stats_once():
    """The backward's recompute throws its stats away: one train step
    with remat moves the buffers exactly as one without."""
    _, _, params, state, images, labels = _setup("resnet18", 32)
    after = []
    for remat in (False, True):
        net = _port("resnet18", 32, params, state, remat=remat)
        _port_grad(net, images, labels)
        after.append({n: b.clone() for n, b in net.named_buffers()})
    for n in after[0]:
        torch.testing.assert_close(after[1][n], after[0][n], rtol=0, atol=0)


def test_batch_norm_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(2.0, 3.0, (4, 5, 5, 8)).astype(np.float32)
    params = {"scale": rng.normal(1, 0.1, 8).astype(np.float32),
              "offset": rng.normal(0, 0.1, 8).astype(np.float32)}
    state = {"mean": rng.normal(0, 1, 8).astype(np.float32),
             "var": rng.uniform(0.5, 2, 8).astype(np.float32)}
    t = {k: torch.from_numpy(v) for k, v in params.items()}
    s = {k: torch.from_numpy(v) for k, v in state.items()}
    for train in (True, False):
        jy, js = jax_layers.batch_norm(jnp.asarray(x), params, state, train,
                                       0.9, 1e-5)
        y, ns = L.batch_norm(torch.from_numpy(x), t, s, train, 0.9, 1e-5)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=2e-5,
                                   atol=2e-6)
        for k in ("mean", "var"):
            np.testing.assert_allclose(ns[k].numpy(), np.asarray(js[k]),
                                       rtol=2e-5, atol=2e-6)
    # Biased batch variance in the running stats, momentum on the old.
    _, ns = L.batch_norm(torch.from_numpy(x), t, s, True, 0.9, 1e-5)
    want = 0.9 * state["var"] + 0.1 * x.reshape(-1, 8).var(axis=0)
    np.testing.assert_allclose(ns["var"].numpy(), want, rtol=1e-4)


def _meta(name, hw, classes):
    with torch.device("meta"):
        return get_model(name)(ModelConfig(name=name, num_classes=classes),
                               DataConfig(crop_height=hw, crop_width=hw))


@pytest.mark.parametrize("name,hw,classes,count", [
    ("resnet18", 24, 10, 11_173_962), ("resnet50", 224, 1000, 25_557_032)])
def test_param_counts_at_published_geometry(name, hw, classes, count):
    net = _meta(name, hw, classes)
    assert resnet.param_count(net) == count
    mcfg = JaxModelConfig(name=name, num_classes=classes)
    dcfg = JaxDataConfig(crop_height=hw, crop_width=hw)
    shapes = jax.eval_shape(lambda k: jax_resnet.init_params(
        k, mcfg, dcfg, depth=resnet.depth_of(name)), jax.random.key(0))
    assert sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes)) \
        == count
    # Every leaf maps one to one, in the JAX layout.
    want = {jax.tree_util.keystr(p): tuple(a.shape) for p, a in
            jax.tree.flatten_with_path(shapes)[0]}
    got = {"".join(f"[{k!r}]" if not k.isdigit() else f"[{k}]"
                   for k in n.split(".")): convert.jax_shape(n, p.shape)
           for n, p in net.named_parameters()}
    assert got == want


def test_shapes_stem_and_state_structure():
    net = _meta("resnet50", 72, 10)
    assert net.imagenet_stem and tuple(net.stem.conv.shape) == (64, 3, 7, 7)
    assert not _meta("resnet50", 64, 10).imagenet_stem
    mcfg, _, params, state, images, labels = _setup("resnet18", 32)
    net = _port("resnet18", 32, params, state)
    logits = net(torch.from_numpy(images))
    assert logits.shape == (4, 10) and logits.dtype == torch.float32
    # 20 BN layers of ResNet-18, two buffers each: mean, var.
    assert len(dict(net.named_buffers())) == 40
    mstate = convert.state_to_jax(dict(net.named_buffers()),
                                  dict(net.named_parameters()), lists=True)
    assert jax.tree.structure(mstate) == jax.tree.structure(state)
    assert mstate["stage1"][0]["conv1"] is None


def test_bn_state_moves_in_train_frozen_in_eval():
    _, _, params, state, images, _ = _setup("resnet18", 32)
    net = _port("resnet18", 32, params, state)
    before = {n: b.clone() for n, b in net.named_buffers()}
    net.eval()
    with torch.no_grad():
        net(torch.from_numpy(images))
    for n, b in net.named_buffers():
        assert torch.equal(b, before[n]), n
    net.train()
    with torch.no_grad():
        net(torch.from_numpy(images))
    assert not torch.equal(net.stem.bn.mean, before["stem.bn.mean"])


def test_eval_deterministic_and_batch_independent():
    _, _, params, state, images, _ = _setup("resnet18", 32, batch=8)
    net = _port("resnet18", 32, params, state).eval()
    with torch.no_grad():
        full = net(torch.from_numpy(images))
        again = net(torch.from_numpy(images))
        half = net(torch.from_numpy(images[:4]))
    assert torch.equal(full, again)
    torch.testing.assert_close(full[:4], half, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("norm", ["bn", "nf"])
def test_blocks_start_as_identity(norm):
    """Fresh init: γ = 0 on each branch's last BN (or skip_gain 0), so a
    block without a projection returns relu(x)."""
    net = get_model("resnet18")(
        ModelConfig(name="resnet18", resnet_norm=norm),
        DataConfig(crop_height=32, crop_width=32))
    net.reset_parameters(torch.Generator().manual_seed(0))
    blk = net.stage1[0]
    x = torch.relu(torch.randn(2, 64, 8, 8, generator=torch.Generator()
                               .manual_seed(1)))
    p = dict(blk.named_parameters())
    s = dict(blk.named_buffers())
    out, new = net._block(x, p, s, blk)
    torch.testing.assert_close(out, x, rtol=1e-6, atol=0)
    assert set(new) == set(s)
    if norm == "nf":
        assert float(blk.skip_gain) == 0.0 and not s
    else:
        assert float(blk.bn2.scale.detach().abs().max()) == 0.0


def test_s2d_stem_matches_folded_7x7():
    """The 4x4/1 conv on the 2x2-folded image equals the 7x7/2 SAME conv
    whose kernel is zero-padded to 8x8 and folded (JAX
    ``tests/test_resnet.py`` pins the same fold)."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 16, 16, 3)).astype(np.float32)
    w7 = rng.normal(size=(7, 7, 3, 4)).astype(np.float32)
    w8 = np.zeros((8, 8, 3, 4), np.float32)
    w8[:7, :7] = w7
    ws = w8.reshape(4, 2, 4, 2, 3, 4).transpose(0, 2, 1, 3, 4, 5).reshape(
        4, 4, 12, 4)
    want = L.conv2d(torch.from_numpy(x), torch.from_numpy(w7), stride=2)
    xs = torch.from_numpy(x).reshape(2, 8, 2, 8, 2, 3).permute(
        0, 1, 3, 2, 4, 5).reshape(2, 8, 8, 12)
    got = torch.nn.functional.conv2d(
        torch.nn.functional.pad(xs.permute(0, 3, 1, 2), (1, 2, 1, 2)),
        torch.from_numpy(ws).permute(3, 2, 0, 1))
    torch.testing.assert_close(got.permute(0, 2, 3, 1), want, rtol=1e-4,
                               atol=1e-4)


def test_weight_standardization():
    rng = np.random.default_rng(6)
    w = torch.from_numpy(rng.normal(size=(8, 4, 3, 3)).astype(np.float32))
    ws = resnet._ws(w, torch.full((8,), 1.5))
    mu = ws.mean(dim=(1, 2, 3))
    var = ws.var(dim=(1, 2, 3), correction=0)
    torch.testing.assert_close(mu, torch.zeros(8), rtol=0, atol=1e-6)
    torch.testing.assert_close(var, torch.full((8,), 1.5 ** 2 / 36),
                               rtol=1e-3, atol=0)
    jw = jax_resnet._ws_conv(jnp.asarray(w.permute(2, 3, 1, 0).numpy()),
                             jnp.full((8,), 1.5))
    np.testing.assert_allclose(ws.permute(2, 3, 1, 0).numpy(),
                               np.asarray(jw), rtol=2e-5, atol=2e-6)


def test_unported_layouts_raise():
    from dml_cnn_cifar10_tpu_torch.parallel.mesh import Mesh
    for mesh in (Mesh(world=2, model=2), Mesh(world=2, seq=2)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            resnet.ResNet(ModelConfig(name="resnet18"), DataConfig(),
                          mesh=mesh)
