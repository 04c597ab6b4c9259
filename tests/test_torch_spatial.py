"""PyTorch port, the CNN's spatial split over ``--seq_axis``
(``parallel/spatial.py``), on the CPU.

One spawn of 4 gloo ranks (``tests/_torch_dist.py:axis_runs``):

- the halo exchanges against the unsplit plain version at seq 2 (data 2)
  and seq 4, 24 rows: the SAME 5x5 conv, the 3x3/2 pool on 24 rows and on
  12 (at seq 4 three rows a rank, so the ranks' windows are unaligned),
  and the CNN's conv-pool-conv-pool trunk with the gather; outputs and
  the input's and kernels' gradients of ``sum(sin(y))`` (the trunk's
  gradients arrive ``seq`` times over, the rule the step's ``1 /
  replicas`` undoes);
- the CNN at published widths (logit ReLU off, batch 16) at data 2 x seq
  2 and at seq 4, 3 steps of plain SGD and of momentum 0.9 from the JAX
  package's init, against JAX ``make_train_step`` on a ``data`` mesh:
  losses at the pins of ``tests/test_spatial.py:66`` (rtol 1e-5, atol
  1e-6), parameters at rtol 2e-5, atol 2e-6;
- the resident chunk (a uint8 split on the device, index-fed) against the
  host-fed raw chunk of the same rows at data 2 x seq 2 (JAX
  ``test_spatial_resident_matches_hostfed``'s rtol 1e-6).

Without ranks: the ResNet under ``--seq_axis 2`` still raises, a seq
count the 24 rows cannot feed raises, and the FLOP count's label.
"""

import numpy as np
import pytest
import torch

import _torch_dist
from dml_cnn_cifar10_tpu_torch.config import (DataConfig, ModelConfig,
                                              TrainConfig)
from dml_cnn_cifar10_tpu_torch.models.registry import get_model
from dml_cnn_cifar10_tpu_torch.ops import layers as L
from dml_cnn_cifar10_tpu_torch.parallel import spatial
from dml_cnn_cifar10_tpu_torch.parallel.mesh import Mesh
from dml_cnn_cifar10_tpu_torch.utils import profiling
from test_torch_tp import (CNN, LOSS_PIN, MOM, PARAM_PIN, SGD, _batches,
                           _close, jax_train)

SEQS = (2, 4)


def _op_cases():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 3, 24, 24)).astype(np.float32)
    x12 = rng.normal(size=(2, 4, 12, 12)).astype(np.float32)
    w1 = (rng.normal(size=(4, 3, 5, 5)) * 0.1).astype(np.float32)
    w2 = (rng.normal(size=(5, 4, 5, 5)) * 0.1).astype(np.float32)
    b1 = rng.normal(size=(4,)).astype(np.float32)
    b2 = rng.normal(size=(5,)).astype(np.float32)
    cases = []
    for seq in SEQS:
        cases += [(f"conv_s{seq}", seq, "conv", x, [w1], [b1]),
                  (f"pool24_s{seq}", seq, "pool", x, None, None),
                  (f"pool12_s{seq}", seq, "pool", x12, None, None),
                  (f"trunk_s{seq}", seq, "trunk", x, [w1, w2], [b1, b2])]
    return cases


def _runs(params0, batches):
    rng = np.random.default_rng(5)
    images = rng.integers(0, 256, (64, 32, 32, 3)).astype(np.uint8)
    labels = rng.integers(0, 10, 64).astype(np.int32)
    idx = rng.integers(0, 64, (2, 16)).astype(np.int64)
    base = dict(model=CNN, params=params0, batches=batches)
    return {"d2s2": dict(base, optim=SGD, seq=2),
            "s4": dict(base, optim=SGD, seq=4),
            "d2s2_mom": dict(base, optim=MOM, seq=2),
            "s4_mom": dict(base, optim=MOM, seq=4),
            "resident": dict(base, optim=SGD, seq=2,
                             resident=(images, labels, idx))}


@pytest.fixture(scope="module")
def sp(tmp_path_factory):
    batches = _batches(23)
    jax_res = {"sgd": jax_train(CNN, SGD, batches, 2, 1),
               "mom": jax_train(CNN, MOM, batches, 2, 1)}
    cases = _op_cases()
    ranks = _torch_dist.run_ranks(
        "axis_runs", 4, tmp_path_factory.mktemp("spatial"),
        _runs(jax_res["sgd"][0], batches), None, cases)
    return ranks, jax_res, {c[0]: c for c in cases}


def _plain(kind, x, ws, bs):
    xt = torch.tensor(x, requires_grad=True)
    wt = [torch.tensor(a, requires_grad=True) for a in ws or ()]
    bt = [torch.tensor(a, requires_grad=True) for a in bs or ()]
    if kind == "trunk":
        y = xt
        for w, b in zip(wt, bt):
            y = L.max_pool_nchw(torch.relu(L.conv2d_nchw(y, w, b)))
    elif kind == "conv":
        y = L.conv2d_nchw(xt, *wt, *bt)
    else:
        y = L.max_pool_nchw(xt)
    torch.sin(y).sum().backward()
    return (y.detach().numpy(), xt.grad.numpy(),
            [t.grad.numpy() for t in wt + bt])


@pytest.mark.parametrize("seq", SEQS)
@pytest.mark.parametrize("kind", ["conv", "pool24", "pool12", "trunk"])
def test_halo_layers_match_the_unsplit_plain_version(sp, seq, kind):
    ranks, _, cases = sp
    name = f"{kind}_s{seq}"
    _, _, layer, x, ws, bs = cases[name]
    want_y, want_dx, want_g = _plain(layer, x, ws, bs)
    for d in range(4 // seq):
        rows = {r["ops"]["coords"][seq][1]: r["ops"][name] for r in ranks
                if r["ops"]["coords"][seq][0] == d}
        dx = np.concatenate([rows[s][1] for s in range(seq)], axis=2)
        if layer == "trunk":
            for s in range(seq):       # the whole map on every rank
                np.testing.assert_array_equal(rows[s][0], rows[0][0])
            y, dx = rows[0][0], dx / seq
            grads = [g / seq for g in rows[0][2]]
        else:
            y = np.concatenate([rows[s][0] for s in range(seq)], axis=2)
            grads = rows[0][2]
        np.testing.assert_allclose(y, want_y, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(dx, want_dx, rtol=1e-5,
                                   atol=1e-6 * np.abs(want_dx).max())
        for g, w in zip(grads, want_g):
            np.testing.assert_allclose(g, w, rtol=1e-5,
                                       atol=1e-6 * np.abs(w).max())


@pytest.mark.parametrize("name", ["d2s2", "s4", "d2s2_mom", "s4_mom"])
def test_spatial_cnn_matches_jax_data_parallel(sp, name):
    ranks, jax_res, _ = sp
    _, losses, params = jax_res["mom" if name.endswith("mom") else "sgd"]
    for r in ranks:
        got = r[name]
        np.testing.assert_allclose([m["loss"] for m in got["metrics"]],
                                   losses, **LOSS_PIN)
        _close(got["tree"]["params"], params, f"{name} vs JAX", **PARAM_PIN)
        # Every seq rank holds the whole model.
        assert got["local"]["full1.kernel"] == (384, 2304)
    for r in ranks[1:]:
        _close(r[name]["tree"], ranks[0][name]["tree"], "ranks", rtol=0,
               atol=0)


def test_resident_chunk_matches_host_fed(sp):
    ranks, _, _ = sp
    for r in ranks:
        (loss_r, tree_r), (loss_h, tree_h) = (r["resident"]["resident"],
                                              r["resident"]["hostfed"])
        np.testing.assert_allclose(loss_r, loss_h, rtol=1e-6)
        _close(tree_r["params"], tree_h["params"], "resident vs host-fed",
               rtol=1e-6, atol=1e-7)


def test_resnet_spatial_split_still_raises():
    mcfg = ModelConfig(name="resnet18")
    with pytest.raises(NotImplementedError, match="spatial partitioning"):
        get_model("resnet18")(mcfg, DataConfig(),
                              mesh=Mesh(world=2, seq=2))


def test_too_many_seq_ranks_for_the_rows_raise():
    with pytest.raises(ValueError, match="too many seq ranks for"):
        get_model("cnn")(ModelConfig(**CNN), DataConfig(),
                         mesh=Mesh(world=8, seq=8))
    with pytest.raises(ValueError, match="does not split over seq_axis=5"):
        spatial.Split.even(24, 5)


def test_flop_count_label_of_the_spatial_split():
    cfg = TrainConfig(batch_size=16)
    whole, label = profiling.step_flops(cfg)
    half, label2 = profiling.step_flops(cfg, seq=2)
    assert (label, label2) == ("exact", "spatial_share_x2")
    # The FCs' three products an image, whole; the update whole.
    fcs = 6 * 16 * (2304 * 384 + 384 * 192 + 192 * 10)
    net = get_model("cnn")(cfg.model, cfg.data)
    update = profiling.update_flops(cfg.optim, {
        n: tuple(p.shape) for n, p in net.named_parameters()})
    assert half == (whole - fcs - update) / 2 + fcs + update
