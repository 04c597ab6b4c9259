"""PyTorch port, the run telemetry against the JAX package on the CPU:
``utils/devprof.py`` (``DeviceStepEstimator``, ``classify_op``,
``parse_profile_at_steps``, ``parse_trace_doc`` on torch.profiler's
Chrome traces), ``utils/profiling.py`` (``DrainMeter``, the step's FLOP
count on the ``meta`` device) and the trainer's ``train`` and ``devtime``
records.

- The copied classes give the JAX classes' outputs exactly on the same
  clock readings; the parsers give the JAX parsers' results and errors
  where the input is theirs too (a trace whose device lane both read).
- The CNN's step at batch 128 counts 13,479,909,908 FLOPs, the analytic
  count (forward 4,728,520,704; backward 8,749,252,608, conv1 taking no
  input gradient; the SGD update 2 a parameter, 2,136,596), exactly.
  XLA's cost analysis of the JAX step is printed beside it and not
  asserted: it counts 0.844x the forward and backward. Each optimizer's
  update count equals a hand count over the CNN's 1,068,298 parameters.
- Under a CUDA graph the update's kernels are learned from a profiled
  eager run of the chunk body: in a replay's trace only the update's
  occurrences of names the forward and backward launch too count.
- A 2-block ViT (4 heads of 16) over 64 tokens, counted on ``meta``
  through the flash operators' formulas, equals the same step counted on
  the CPU with the dense attention, exactly: the formulas are the dense
  products' count, and FlopCounterMode counts no elementwise work on
  either side.
- A 20-step CPU run with ``--peak_tflops 1 --profile_at_steps 4:2``
  writes ``train`` records with ``device_step_ms``, ``drain_wait_ms``,
  ``tflops_per_sec_per_chip`` and ``mfu``, ``devtime`` records, and a
  stream that passes ``tools/check_jsonl_schema.py --strict``.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from dml_cnn_cifar10_tpu.config import DataConfig as JaxDataConfig
from dml_cnn_cifar10_tpu.config import ModelConfig as JaxModelConfig
from dml_cnn_cifar10_tpu.config import OptimConfig as JaxOptimConfig
from dml_cnn_cifar10_tpu.models.registry import get_model as jax_get_model
from dml_cnn_cifar10_tpu.parallel import step as jax_step
from dml_cnn_cifar10_tpu.utils import devprof as jax_devprof
from dml_cnn_cifar10_tpu.utils import profiling as jax_profiling
from dml_cnn_cifar10_tpu_torch import config
from dml_cnn_cifar10_tpu_torch.cli.main import main
from dml_cnn_cifar10_tpu_torch.models.cnn import CNN
from dml_cnn_cifar10_tpu_torch.ops import attention as attn
from dml_cnn_cifar10_tpu_torch.utils import devprof, profiling

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CNN_FWD_BWD_FLOPS = 13_477_773_312
CNN_PARAMS = 1_068_298
CNN_UPDATE_FLOPS = 2 * CNN_PARAMS                 # plain SGD, no decay
CNN_STEP_FLOPS = CNN_FWD_BWD_FLOPS + CNN_UPDATE_FLOPS


class _Clock:
    """A ``time`` stand-in whose ``perf_counter`` reads a list."""

    def __init__(self, readings):
        self.readings = list(readings)

    def perf_counter(self):
        return self.readings.pop(0)


def test_estimator_and_meter_match_jax_on_the_same_clock(monkeypatch):
    script = [(None, 5, 1.0, 1.5), ("mark", 0, 0.25, None),
              (None, 10, 2.0, 2.25), (None, 10, 3.0, 3.0),
              ("mark", 10, 4.0, None), (None, 30, 4.5, 6.0)]
    outs = []
    for cls in (devprof.DeviceStepEstimator,
                jax_devprof.DeviceStepEstimator):
        est, got = cls(), []
        for op, step, a, b in script:
            if op == "mark":
                est.mark(step, now=a)
            else:
                got.append(est.boundary(step, a, b))
        outs.append(got)
    assert outs[0] == outs[1]
    assert outs[0][0] == (None, 500.0)
    rates = []
    for mod, cls in ((profiling, profiling.DrainMeter),
                     (jax_profiling, jax_profiling.DrainMeter)):
        monkeypatch.setattr(mod, "time",
                            _Clock([1.0, 1.5, 1.5, 4.0, 4.0, 3.0]))
        meter = cls(128)
        got = [meter.rate(5)]
        meter.mark(0)
        got += [meter.rate(10), meter.rate(0)]
        meter.mark(10)
        got += [meter.rate(20), meter.rate(30)]
        rates.append(got)
    assert rates[0] == rates[1]
    assert rates[0][:2] == [0.0, 10 * 128 / 0.5]


@pytest.mark.parametrize("spec", [None, "", "0:1", "100:20", "7:3"])
def test_profile_at_steps_parses_as_jax(spec):
    assert devprof.parse_profile_at_steps(spec) == \
        jax_devprof.parse_profile_at_steps(spec)


@pytest.mark.parametrize("spec", ["5", "a:b", "1:2:3", "-1:4", "3:0"])
def test_profile_at_steps_errors_as_jax(spec):
    with pytest.raises(ValueError) as jerr:
        jax_devprof.parse_profile_at_steps(spec)
    with pytest.raises(ValueError) as err:
        devprof.parse_profile_at_steps(spec)
    assert str(err.value) == str(jerr.value)


NAMES = ["void flash_lse_kernel<bf16, 64>(Params)",
         "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgs)",
         "ncclKernel_AllGather_RING_LL_Sum_int8_t", "all-to-all.3",
         "Memcpy HtoD (Pinned -> Device)", "Memcpy DtoH (Device -> Pageable)",
         "copy-start", "infeed", "fusion.12", "aten::mm",
         "sm90_xmma_gemm_f32f32_tf32f32_f32_nn_n_tilesize128x128x32",
         "collective-permute-done", "send", "recv-done"]


@pytest.mark.parametrize("name", NAMES)
def test_classify_op_matches_jax(name):
    assert devprof.classify_op(name) == jax_devprof.classify_op(name)


@pytest.mark.parametrize("name,bucket", [
    ("ncclDevKernel_SendRecv(ncclDevKernelArgs)", "collective"),
    ("ncclDevKernel_AllToAll_RING_LL", "collective"),
    ("gloo:all_to_all", "collective"),
    ("Memcpy HtoD (Pageable -> Device)", "infeed"),
    ("void at::native::vectorized_elementwise_kernel<4>", "compute"),
    ("sgd_multi_kernel<true>", "compute")])
def test_classify_op_buckets_the_cards_kernels(name, bucket):
    assert devprof.classify_op(name) == bucket


def _device_doc(extra=()):
    """A trace with one device lane (a process named as JAX names its
    device lanes, kernels on two streams) and a host lane."""
    ev = [{"ph": "M", "name": "process_name", "pid": 0,
           "args": {"name": "/device:GPU:0"}},
          {"ph": "M", "name": "process_name", "pid": 77,
           "args": {"name": "/host:CPU"}}]
    for name, tid, ts, dur in [
            ("void flash_lse_kernel<bf16, 64>", 7, 100, 50),
            ("sm90_xmma_gemm_bf16", 7, 160, 20),
            ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 8, 150, 40),
            ("sgd_multi_kernel<false>", 7, 200, 10),
            ("void flash_lse_kernel<bf16, 64>", 7, 215, 45)]:
        ev.append({"ph": "X", "cat": "kernel", "name": name, "pid": 0,
                   "tid": tid, "ts": ts, "dur": dur})
    ev.append({"ph": "X", "cat": "gpu_memcpy", "pid": 0, "tid": 9,
               "name": "Memcpy HtoD (Pinned -> Device)", "ts": 90,
               "dur": 5})
    ev.append({"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 77,
               "tid": 1, "ts": 95, "dur": 30})
    return {"traceEvents": ev + list(extra)}


def test_parse_trace_doc_matches_jax_on_a_device_lane():
    got = devprof.parse_trace_doc(_device_doc(), top_k=3)
    want = jax_devprof.parse_trace_doc(_device_doc(), top_k=3)
    # No update scope and no replay signature: no update time, as JAX.
    assert got[0]["optimizer_ms"] == 0.0
    assert got == want
    lane = got[0]
    assert lane["device"] == "/device:GPU:0"
    assert (lane["compute_ms"], lane["collective_ms"],
            lane["infeed_ms"]) == (0.125, 0.04, 0.005)
    assert lane["top_ops"][0]["name"].startswith("void flash_lse_kernel")
    assert lane["top_ops"][0]["calls"] == 2


def test_parse_trace_doc_attributes_the_update_scope_by_stream():
    """The kernels that start inside the ``optimizer`` annotation on their
    own stream count; another stream's kernel at the same time does not,
    and the annotation itself is not a kernel."""
    ann = [{"ph": "X", "cat": "gpu_user_annotation", "name": "optimizer",
            "pid": 0, "tid": 7, "ts": 195, "dur": 70},
           {"ph": "X", "cat": "gpu_user_annotation", "name": "fwd_bwd",
            "pid": 0, "tid": 7, "ts": 95, "dur": 100}]
    lane, = devprof.parse_trace_doc(_device_doc(ann))
    assert lane["optimizer_ms"] == 0.055         # 10 + 45 µs on tid 7
    assert lane["total_ms"] == 0.17
    assert all(op["name"] not in ("optimizer", "fwd_bwd")
               for op in lane["top_ops"])


def test_parse_trace_doc_reads_a_recorded_cpu_trace(tmp_path):
    """No device lane on the CPU: the host lane stands in, and the
    optimizer scope's own event is the attribution."""
    from torch.profiler import ProfilerActivity, profile, record_function

    a = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with record_function("fwd_bwd"):
                b = a @ a
            with record_function("optimizer"):
                a.add_(b, alpha=-1e-3)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    lanes = devprof.parse_trace_doc(doc)
    assert len(lanes) == 1
    lane = lanes[0]
    names = {op["name"] for op in lane["top_ops"]}
    assert {"aten::mm", "optimizer", "fwd_bwd"} <= names
    assert 0 < lane["optimizer_ms"] < lane["total_ms"]
    assert lane["compute_ms"] + lane["collective_ms"] + lane["infeed_ms"] \
        == pytest.approx(lane["total_ms"], abs=3e-3)
    assert devprof.parse_trace_doc({"traceEvents": []}) == []


def _replay_docs():
    """A profiled eager run of a 2-step body (the warm-up: each kernel its
    own launch, the update inside ``optimizer`` annotations) and a trace
    of two replays of its graph (every event of a replay sharing the
    launch's correlation id), beside an eager kernel of the same name.
    The update's plain-torch kernels share names with the forward's and
    backward's."""
    mul, add = ("void at::native::vectorized_elementwise_kernel<4, "
                "at::native::BinaryFunctor<float, float, float, Mul>>"), \
        ("void at::native::vectorized_elementwise_kernel<4, "
         "at::native::CUDAFunctorOnSelf_add<float>>")
    tensor = "void at::native::multi_tensor_apply_kernel<TensorListMetadata>"
    gemm = "sm90_xmma_gemm_f32f32_f32f32_f32_tn_n"
    one_step = [(gemm, False, 30), (mul, False, 4), (add, False, 3),
                (mul, True, 2), (tensor, True, 5), (add, True, 1)]
    body = one_step * 2
    warm, ts = [], 1000
    for corr, (name, upd, dur) in enumerate(body):
        warm.append({"ph": "X", "cat": "kernel", "name": name, "pid": 0,
                     "tid": 7, "ts": ts, "dur": dur,
                     "args": {"correlation": 10 + corr}})
        if upd:
            warm.append({"ph": "X", "cat": "gpu_user_annotation",
                         "name": "optimizer", "pid": 0, "tid": 7,
                         "ts": ts, "dur": dur})
        ts += dur + 1
    replays, ts = [], 5000
    for corr in (900, 901):
        for name, _, dur in body:
            replays.append({"ph": "X", "cat": "kernel", "name": name,
                            "pid": 0, "tid": 7, "ts": ts, "dur": dur,
                            "args": {"correlation": corr}})
            ts += dur
        # An eager kernel between replays (a table refresh): one event
        # of its own launch, not a replay's.
        replays.append({"ph": "X", "cat": "kernel", "name": mul, "pid": 0,
                        "tid": 7, "ts": ts + 5, "dur": 7,
                        "args": {"correlation": corr + 50}})
        ts += 20
    return {"traceEvents": warm}, {"traceEvents": replays}, (mul, tensor,
                                                             add)


def test_update_signature_counts_only_the_updates_kernels_in_a_replay():
    warm, replays, (mul, tensor, add) = _replay_docs()
    sig = devprof.update_signature(warm)
    # Occurrences in the body's order: mul and add twice a step, the
    # update's the second of each step's.
    assert sig == {mul: (1, 3), tensor: (0, 1), add: (1, 3)}
    lane, = devprof.parse_trace_doc(replays, signature=sig)
    # Two replays x two steps x the update's 2 + 5 + 1 µs.
    assert lane["optimizer_ms"] == 0.032
    assert lane["total_ms"] == 0.194             # 2 x 90 + 2 x 7 µs
    # Without the signature a replay's update reads nothing.
    assert devprof.parse_trace_doc(replays)[0]["optimizer_ms"] == 0.0
    # The warm-up itself reads its annotations.
    assert devprof.parse_trace_doc(warm)[0]["optimizer_ms"] == 0.016


# Each optimizer's update over the CNN's leaves, by hand (train/optim.py):
# 1,067,584 parameters in its 5 kernels, 714 in its biases. Adafactor
# factors each kernel's JAX layout over its trailing two dims: conv1
# [5, 5, 3, 64] and conv2 [5, 5, 64, 64] (25 leading indices), full1
# [2304, 384], full2 [384, 192], full3 [192, 10]: 4,555 rows and 3,786
# columns in all, 53 leading indices.
UPDATE_CASES = {
    "sgd": (dict(), 2 * CNN_PARAMS),
    "momentum_decay": (dict(momentum=0.9, weight_decay=5e-4),
                       6 * CNN_PARAMS),
    "decay": (dict(weight_decay=5e-4), 4 * CNN_PARAMS),
    "adamw": (dict(optimizer="adamw"), 16 * CNN_PARAMS),
    "lamb": (dict(optimizer="lamb"), 20 * CNN_PARAMS),
    "lars": (dict(optimizer="lars"), 6 * CNN_PARAMS + 5 * 1_067_584),
    "adafactor": (dict(optimizer="adafactor"),
                  15 * 1_067_584 + 7 * 4_555 + 5 * 3_786 + 53 + 16 * 714),
    "clip_accum": (dict(grad_clip_norm=1.0, grad_accum=2),
                   (2 + 3 + 2) * CNN_PARAMS),
    "adamw_ema": (dict(optimizer="adamw", ema_decay=0.99),
                  (16 + 3) * CNN_PARAMS),
}


@pytest.mark.parametrize("case", sorted(UPDATE_CASES))
def test_update_flops_equal_a_hand_count_on_the_cnn(case):
    kw, want = UPDATE_CASES[case]
    cfg = config.reference_config(batch_size=128)
    for k, v in kw.items():
        setattr(cfg.optim, k, v)
    shapes = {n: tuple(p.shape) for n, p in
              CNN(cfg.model, cfg.data).named_parameters()}
    assert sum(np.prod(s) for s in shapes.values()) == CNN_PARAMS
    assert profiling.update_flops(cfg.optim, shapes) == want
    assert profiling.step_flops(cfg)[0] == CNN_FWD_BWD_FLOPS + want


def test_cnn_step_counts_the_analytic_flops():
    cfg = config.reference_config(batch_size=128)
    flops, label = profiling.step_flops(cfg)
    per_image = {"conv1": 2 * 24 * 24 * 64 * 5 * 5 * 3,
                 "conv2": 2 * 12 * 12 * 64 * 5 * 5 * 64,
                 "full1": 2 * 2304 * 384, "full2": 2 * 384 * 192,
                 "full3": 2 * 192 * 10}
    forward = sum(per_image.values()) * 128
    backward = (2 * sum(per_image.values()) - per_image["conv1"]) * 128
    assert (forward, backward) == (4_728_520_704, 8_749_252_608)
    assert (flops, label) == (forward + backward + 2 * CNN_PARAMS,
                              "exact") == (CNN_STEP_FLOPS, "exact")
    # Linear in the batch; a data rank counts its share, and the whole
    # update, which every rank runs.
    assert profiling.step_flops(cfg, data=2)[0] == \
        CNN_FWD_BWD_FLOPS / 2 + CNN_UPDATE_FLOPS
    # XLA's cost analysis of the JAX step, beside it (not asserted).
    mcfg, ocfg = JaxModelConfig(), JaxOptimConfig()
    model_def = jax_get_model("cnn")
    state = jax_step.init_train_state(jax.random.key(0), model_def, mcfg,
                                      JaxDataConfig(), ocfg)
    step = jax_step.make_train_step(model_def, mcfg, ocfg)
    xla = jax_profiling.compiled_flops(step, jax_profiling.abstractify((
        state, np.zeros((128, 24, 24, 3), np.float32),
        np.zeros((128,), np.int32))))
    print(f"CNN step at batch 128: counted {flops:.0f} FLOPs; XLA's cost "
          f"analysis of the JAX step {xla} "
          f"({(xla or 0) / flops:.3f}x)")


VIT = dict(vit_depth=2, vit_dim=64, vit_heads=4, pool="mean",
           logit_relu=False)


def _vit_cfg(**model):
    cfg = config.fixed_config(batch_size=8)
    cfg.model.name = "vit_tiny"
    cfg.data.crop_height = cfg.data.crop_width = 32     # 64 tokens
    for k, v in {**VIT, **model}.items():
        setattr(cfg.model, k, v)
    return cfg


def _cpu_dense_flops(cfg) -> int:
    """The step at batch 1 counted on the CPU, attention dense."""
    from torch.func import functional_call
    from torch.utils.flop_counter import FlopCounterMode

    from dml_cnn_cifar10_tpu_torch.models.registry import get_model
    from dml_cnn_cifar10_tpu_torch.train import loss as loss_lib

    model = get_model("vit_tiny")(cfg.model, cfg.data)
    model.reset_parameters(torch.Generator().manual_seed(0))
    params = {n: p.detach().clone().requires_grad_()
              for n, p in model.named_parameters()}
    images = torch.rand(1, 32, 32, 3)
    with FlopCounterMode(display=False) as counter:
        loss = loss_lib.softmax_cross_entropy(
            functional_call(model, params, (images,)), torch.tensor([3]))
        torch.autograd.grad(loss, list(params.values()))
    return counter.get_total_flops()


def _vit_shapes(cfg):
    from dml_cnn_cifar10_tpu_torch.models.registry import get_model
    return {n: tuple(p.shape) for n, p in get_model("vit_tiny")(
        cfg.model, cfg.data).named_parameters()}


@pytest.mark.parametrize("model", [dict(), dict(remat=True),
                                   dict(attn_causal=True)],
                         ids=["plain", "remat", "causal"])
def test_vit_flash_formulas_equal_the_dense_count(monkeypatch, model):
    cfg = _vit_cfg(**model)
    dense = _cpu_dense_flops(cfg)
    update = profiling.update_flops(cfg.optim, _vit_shapes(cfg))
    # Dense at 64 tokens.
    assert profiling.step_flops(cfg)[0] == 8 * dense + update
    # The same step through the flash operators on meta.
    monkeypatch.setattr(attn, "FLASH_MIN_TOKENS", 0)
    flops, label = profiling.step_flops(cfg)
    assert (flops, label) == (8 * dense + update, "exact")
    for mode, causal, want in (("ulysses", False, "seq_share_x2"),
                               ("ring", False, "seq_share_x2"),
                               ("ring", True, "seq_mean_share_x2")):
        cfg.model.sp_mode, cfg.model.attn_causal = mode, causal
        assert profiling.step_flops(cfg, seq=2)[1] == want


def test_train_records_carry_device_time_tflops_and_mfu(tmp_path, capsys):
    jsonl = str(tmp_path / "m.jsonl")
    args = ["--device", "cpu", "--dataset", "synthetic",
            "--data_dir", str(tmp_path / "data"),
            "--log_dir", str(tmp_path / "logs"),
            "--synthetic_train_records", "320", "--fidelity", "fixed",
            "--learning_rate", "0.02", "--batch_size", "32",
            "--total_steps", "20", "--output_every", "5",
            "--eval_every", "10", "--checkpoint_every", "10",
            "--peak_tflops", "1", "--profile_at_steps", "4:2",
            "--metrics_jsonl", jsonl]
    assert main(args) == 0
    with open(jsonl) as f:
        recs = [json.loads(line) for line in f]
    train = [r for r in recs if r["kind"] == "train"]
    assert [r["step"] for r in train] == [5, 10, 15, 20]
    flops = CNN_FWD_BWD_FLOPS / 4 + CNN_UPDATE_FLOPS    # batch 32
    for r in train:
        for key in ("device_step_ms", "drain_wait_ms",
                    "tflops_per_sec_per_chip", "mfu"):
            assert r[key] is not None and r[key] >= 0, (key, r)
        assert r["mfu"] == pytest.approx(r["tflops_per_sec_per_chip"],
                                         abs=1e-3)
        want = flops * r["images_per_sec"] / 32 / 1e12
        assert r["tflops_per_sec_per_chip"] == pytest.approx(want, abs=1e-3)
    assert train[0]["flops_stack"] == "exact"
    assert all("flops_stack" not in r for r in train[1:])
    # The window runs from step 4 to the drained boundary at 10, closes
    # after that boundary's record, and the later records carry its
    # optimizer_ms.
    dev = [r for r in recs if r["kind"] == "devtime"]
    assert len(dev) == 1 and dev[0]["step"] == 10
    assert dev[0]["optimizer_ms"] > 0 and dev[0]["top_ops"]
    assert [r["optimizer_ms"] is not None for r in train] == \
        [False, False, True, True]
    assert os.path.isfile(str(tmp_path / "logs" / "devprof"
                              / "trace_4_10.json"))
    res = subprocess.run([sys.executable, "tools/check_jsonl_schema.py",
                          "--strict", jsonl], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    with pytest.raises(SystemExit, match="START:COUNT"):
        main(args + ["--profile_at_steps", "4"])
