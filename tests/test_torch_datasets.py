"""PyTorch port, the ResNet rungs' datasets (``data/download.py``,
``data/records.py``, ``data/pipeline.py``) against the JAX package.

- ``imagenet_synth``: the generated shards (2-byte big-endian labels, up
  to 1000 classes) are byte-identical to the JAX package's generator for
  the same seed, at a small geometry; the batches decode the same, and
  the wide labels span more than one byte.
- ``cifar100``: binaries written here in the CIFAR-100 layout (coarse
  label, fine label, CHW image) with coarse != fine decode with the fine
  label, in the port and in the JAX package alike; through the host path
  and the resident chunked path of the Trainer (its full-split eval
  counts on the device against the host-fed sweep, on the same state).
- Missing CIFAR-100 binaries raise the classified ``DownloadError``
  naming the synthetic modes; nothing is fetched.
"""

import os

import numpy as np
import pytest
import torch

from dml_cnn_cifar10_tpu.config import DataConfig as JaxDataConfig
from dml_cnn_cifar10_tpu.data import download as jax_download
from dml_cnn_cifar10_tpu.data import pipeline as jax_pipeline
from dml_cnn_cifar10_tpu_torch.config import DataConfig, TrainConfig
from dml_cnn_cifar10_tpu_torch.data import download, pipeline
from dml_cnn_cifar10_tpu_torch.train.loop import Trainer

torch.set_num_threads(2)

IMAGENET = dict(dataset="imagenet_synth", image_height=20, image_width=20,
                crop_height=16, crop_width=16, num_classes=1000,
                synthetic_train_records=200, synthetic_test_records=30)


def test_imagenet_synth_bytes_and_batches_identical(tmp_path):
    port = DataConfig(data_dir=str(tmp_path / "port"), seed=4, **IMAGENET)
    ref = JaxDataConfig(data_dir=str(tmp_path / "jax"), seed=4,
                        use_native_loader=False, **IMAGENET)
    download.ensure_dataset(port)
    jax_download.ensure_dataset(ref)
    files = download.train_files(port) + download.test_files(port)
    ref_files = jax_download.train_files(ref) + jax_download.test_files(ref)
    assert [os.path.relpath(f, port.data_dir) for f in files] == \
        [os.path.relpath(f, ref.data_dir) for f in ref_files]
    for mine, theirs in zip(files, ref_files):
        with open(mine, "rb") as a, open(theirs, "rb") as b:
            got, want = a.read(), b.read()
        assert len(got) > 0 and got == want, os.path.basename(mine)
    assert os.path.getsize(files[0]) == 50 * (2 + 20 * 20 * 3)
    mine = pipeline.input_pipeline(port, 25, train=True, seed=2)
    theirs = jax_pipeline.input_pipeline(ref, 25, train=True, seed=2)
    assert mine.labels.max() > 255 and mine.labels.max() < 1000
    np.testing.assert_array_equal(mine.labels, theirs.labels)
    for _ in range(3):
        a, b = next(mine), next(theirs)
        np.testing.assert_array_equal(a.images, b.images)
        np.testing.assert_array_equal(a.labels, b.labels)


def _write_cifar100(root, n_train=120, n_test=40, hw=32, seed=0):
    """CIFAR-100 binaries: [coarse, fine, 3*hw*hw CHW bytes] a record, the
    fine label a function of the image (its first byte mod 100), the
    coarse one a different number."""
    rng = np.random.default_rng(seed)
    folder = os.path.join(root, download.CIFAR100_FOLDER)
    os.makedirs(folder, exist_ok=True)
    fines = {}
    for name, n in (("train.bin", n_train), ("test.bin", n_test)):
        img = rng.integers(0, 256, (n, 3 * hw * hw), dtype=np.uint8)
        fine = (img[:, 0] % 100).astype(np.uint8)
        coarse = ((fine.astype(np.int32) + 37) % 20).astype(np.uint8)
        recs = np.concatenate([coarse[:, None], fine[:, None], img], axis=1)
        recs.tofile(os.path.join(folder, name))
        fines[name] = fine.astype(np.int32)
    return fines


def test_cifar100_reads_the_fine_label(tmp_path):
    fines = _write_cifar100(str(tmp_path))
    port = DataConfig(dataset="cifar100", data_dir=str(tmp_path),
                      num_classes=100)
    ref = JaxDataConfig(dataset="cifar100", data_dir=str(tmp_path),
                        num_classes=100, use_native_loader=False)
    for train, name in ((True, "train.bin"), (False, "test.bin")):
        mine = pipeline.input_pipeline(port, 10, train=train, seed=1)
        theirs = jax_pipeline.input_pipeline(ref, 10, train=train, seed=1)
        np.testing.assert_array_equal(mine.labels, fines[name])
        np.testing.assert_array_equal(mine.labels, theirs.labels)
        a, b = next(mine), next(theirs)
        np.testing.assert_array_equal(a.images, b.images)
        np.testing.assert_array_equal(a.labels, b.labels)


def test_cifar100_resident_path_counts_as_host_path(tmp_path):
    _write_cifar100(str(tmp_path / "data"))
    cfg = TrainConfig(data=DataConfig(dataset="cifar100", num_classes=100,
                                      data_dir=str(tmp_path / "data"),
                                      normalize="scale"))
    cfg.model.num_classes = 100
    cfg.model.logit_relu = False
    cfg.device = "cpu"
    cfg.log_dir = str(tmp_path / "logs")
    cfg.batch_size, cfg.total_steps, cfg.steps_per_dispatch = 8, 4, 2
    cfg.output_every = cfg.eval_every = cfg.checkpoint_every = 4
    cfg.eval_full_test_set = True
    cfg.optim.learning_rate = 0.02
    trainer = Trainer(cfg)
    try:
        res = trainer.fit()
        assert trainer._resident_full_eval is not None   # resident path
        test_it = trainer.input_pipeline(train=False, seed=cfg.seed)
        resident = trainer.evaluate(res.state, test_it)
        trainer._resident_full_eval = None
        host = trainer.evaluate(res.state, test_it)
    finally:
        trainer.close()
    assert res.final_step == 4
    assert resident == host


def test_missing_cifar100_binaries_raise_classified_error(tmp_path):
    cfg = DataConfig(dataset="cifar100", data_dir=str(tmp_path))
    with pytest.raises(download.DownloadError, match="synthetic") as e:
        download.ensure_dataset(cfg)
    assert e.value.fault == "network"
    assert not os.listdir(tmp_path)       # nothing fetched or written
    assert download.label_bytes(cfg) == 2 and not download.wide_label(cfg)
