"""CLI of the PyTorch port: the reference's flags plus the slice's own.

Reference flags (``cifar10cnn.py:245-273``): ``--ps_hosts --worker_hosts
--job_name --task_index --data_dir --log_dir``, mapped as in the JAX
package's CLI: ``--job_name=ps`` prints a note and exits 0 (parameters
live on the device; there is no parameter server), ``--ps_hosts`` is
accepted and ignored, and ``--worker_hosts h:p0,h:p1 --task_index i``
starts rank ``i`` of a ``torch.distributed`` world with one process per
worker and its rendezvous at the first one (``parallel/multihost.py``).
The world is ``data x --model_axis x --seq_axis x --pipe_axis`` ranks
(``rank = ((data·M + model)·S + seq)·P + pipe``): data parallelism for
every model, tensor parallelism of the Megatron-paired layers (the CNN's
``full1``/``full2``, the ViT's ``qkv``/``proj`` and ``mlp1``/``mlp2``)
when ``--model_axis`` > 1, sequence parallelism for the ViT when
``--seq_axis`` > 1 (``--sp_mode ring`` or ``ulysses``; ``--pool`` then
defaults to ``mean``; not with ``--model_axis`` > 1), the CNN's spatial
split of its image rows over ``--seq_axis`` (halo rows exchanged with the
neighbouring ranks), and pipeline parallelism of the ViT's blocks when
``--pipe_axis`` > 1 (``--pipe_schedule 1f1b|1f1b_ring|gpipe``,
``--pipe_microbatches``; not with ``--seq_axis``, ``--model_axis``, MoE,
``--fsdp`` or ``--optimizer_sharding zero1``).
``--dist_backend`` names the backend: ``nccl`` (the default on cuda)
needs a card per rank; ``gloo`` (the default on cpu) also lets several
ranks share one card, through host memory.

Models: ``--model cnn`` (the reference, default), ``--model resnet18`` and
``resnet50`` (BatchNorm running stats through every step path,
cross-replica over the data ranks; ``--resnet_norm nf``, ``--resnet_s2d``,
``--remat``; not under ``--model_axis`` or ``--seq_axis`` > 1) and
``--model vit_tiny``
(ViT-Ti, attention through the hand-written flash kernels from 128 tokens
up, e.g. ``--crop_size 64``) and ``--model vit_moe`` (``--moe_experts``,
8 by default, ``--moe_top_k``, ``--moe_dispatch``; the experts split over
``--model_axis``, the routing global over the data ranks; not with
``--seq_axis`` > 1), with the JAX CLI's ViT, optimizer and
schedule flags, and the rest of its optimizer surface
(``--optimizer lars|lamb|adafactor``, ``--grad_clip_norm``,
``--grad_accum``, ``--async_staleness``, ``--label_smoothing``).
``--peak_tflops`` adds ``mfu`` to the ``train`` records, and
``--profile_at_steps N:K`` writes ``devtime`` records of a torch.profiler
window (``utils/devprof.py``). The run-safety flags are the JAX CLI's:
``--check_numerics`` with ``--on_nonfinite halt|skip|rollback`` and
``--recovery_retries``, ``--fault_spec`` (the step-seam kinds ``nan``,
``sigterm``, ``ckpt_corrupt``, ``data_stall``, the cluster kinds and the
``@restore|adopt|decide`` triggers), ``--checkpoint_every_secs``,
``--async_checkpoint``, ``--preempt_sync_every`` (SIGTERM/SIGINT finish the
dispatch, checkpoint and exit 0), ``--telemetry`` with
``--trace_events_path``, ``--health_metrics`` and ``--tensorboard_dir``;
``--random_brightness`` and ``--random_contrast`` augment.
``--supervise true`` runs ``--mode train`` under the run supervisor
(``train/supervisor.py``: ``--recovery_backoff_s``,
``--retry_budget_window``, ``--rollback_lr_scale``), and ``--cluster_dir``
arms the cluster layer (``parallel/cluster.py``: ``--heartbeat_interval_s``,
``--straggler_after_s``, ``--peer_dead_after_s``,
``--collective_timeout_s``, ``--min_hosts``, ``--elastic_expand``,
``--peer_redundancy`` with ``--replica_keep`` (``ckpt/peerstore.py``: a
lost host's state rebuilt from its peer's replica), ``--cluster_transport
net`` with ``--net_timeout_s`` and ``--net_retries`` (``parallel/net.py``:
process 0 serves the coordination directory over HTTP), and
``--cluster_lockstep``, under which each ``--worker_hosts`` process is a
world of its own, as in the JAX package's simulation); a process that a
restart decision fenced prints a notice and exits 0.
``--restore_deadline_s`` budgets the restore walk.
``--coordinator_timeout_s`` and ``--coordinator_retries`` bound the
rendezvous. Datasets:
``cifar10``, ``cifar100`` (their binaries on disk; nothing is fetched),
``synthetic`` and ``imagenet_synth`` (generated; 256 px stored, 224 crop,
1000 classes); ``--use_native_loader false`` is accepted (the JAX
package's C++ loader is not ported). Sharded state
over the data ranks: ``--optimizer_sharding zero1``, ``--fsdp``,
``--partition_rules``, ``--partition_rules_strict``, ``--partition_report``,
and ``--ckpt_format sharded`` with ``--shard_io_threads`` (``orbax``
exits: it is not portable). ``--steps_per_dispatch K`` runs K steps a
dispatch, one CUDA graph replay on the card, with the dataset resident on
the device and its shuffled rows drawn there (``--resident_data``,
``--device_index_stream``). Modes: ``train`` (default); ``eval`` (restore
the latest checkpoint and sweep the full test split); ``export`` (restore
it and write a self-contained ``torch.export`` serving artifact,
``export.py``: uint8 images in, the eval decode compiled in front, any
batch size); ``serve`` (the micro-batching engine over that artifact, or
over the latest checkpoint's live weights, behind an HTTP server,
``serve/``), with the JAX CLI's ``--serve_*`` flags. The run is on
``--device cuda`` unless ``--device cpu`` is given; a missing card
raises.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from dml_cnn_cifar10_tpu_torch import config as config_lib
from dml_cnn_cifar10_tpu_torch.parallel import multihost


def _bool(v: str) -> bool:
    return v.lower() == "true"   # the reference's custom bool (:247)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dml_cnn_cifar10_tpu_torch",
        description="PyTorch/CUDA port of the distributed CIFAR-10 CNN "
                    "trainer (reference-compatible CLI)")
    p.register("type", "bool", _bool)
    # --- reference flags (cifar10cnn.py:249-272) ---
    p.add_argument("--ps_hosts", type=str, default="",
                   help="DEPRECATED: comma-separated ps hosts (ignored; "
                        "there are no parameter servers)")
    p.add_argument("--worker_hosts", type=str, default="",
                   help="comma-separated hostname:port list, one per "
                        "process; the first is the rendezvous address")
    p.add_argument("--job_name", type=str, default="",
                   help="One of 'ps', 'worker' (ps exits immediately)")
    p.add_argument("--task_index", type=int, default=0,
                   help="Index of task within the job")
    p.add_argument("--data_dir", type=str, default="cifar10data",
                   help="Directory for input data")
    p.add_argument("--log_dir", type=str, default="/tmp/train_logs",
                   help="Checkpoint/log directory")
    # --- framework flags ---
    p.add_argument("--mode", type=str, default="train",
                   choices=["train", "eval", "export", "serve"],
                   help="train; eval = restore the latest checkpoint and "
                        "sweep the full test split; export = restore it "
                        "and write a self-contained torch.export serving "
                        "artifact; serve = run the micro-batching engine "
                        "over the artifact (or the latest checkpoint) "
                        "behind an HTTP endpoint")
    p.add_argument("--export_path", type=str, default=None,
                   help="output file for --mode export "
                        "(default <log_dir>/model.pt2)")
    p.add_argument("--serve_artifact", type=str, default=None,
                   help="artifact to serve (--mode serve); default "
                        "<log_dir>/model.pt2 when present, else the "
                        "latest checkpoint is restored and served live")
    p.add_argument("--serve_buckets", type=str, default="1,8,32,128",
                   help="comma-separated batch sizes, one CUDA graph each "
                        "on the card; a batch of requests pads up to the "
                        "smallest bucket that fits")
    p.add_argument("--serve_queue_depth", type=int, default=256,
                   help="admission control: submits beyond this queue "
                        "depth are shed at once (HTTP 503)")
    p.add_argument("--serve_batch_window_ms", type=float, default=2.0,
                   help="max extra latency the batcher may wait to "
                        "coalesce a fuller batch")
    p.add_argument("--serve_deadline_ms", type=float, default=None,
                   help="per-request deadline; requests queued past it "
                        "are shed at dispatch (default: none)")
    p.add_argument("--serve_port", type=int, default=8000,
                   help="HTTP port for --mode serve (0 = ephemeral)")
    p.add_argument("--serve_metrics_every_s", type=float, default=5.0,
                   help="cadence of `serve` JSONL window records")
    p.add_argument("--serve_drain_deadline_s", type=float, default=5.0,
                   help="graceful-shutdown budget for --mode serve: on "
                        "SIGTERM/SIGINT stop accepting, let queued "
                        "batches finish for at most this long, shed the "
                        "rest, flush metrics, exit 0")
    p.add_argument("--serve_cache_size", type=int, default=0,
                   help="exact-match response cache capacity (entries) "
                        "keyed by (input digest, version); hits bypass "
                        "the batcher; flushed on hot-swap. 0 = off")
    p.add_argument("--trace_sample_rate", type=float, default=0.0,
                   help="head-sample this fraction of requests for "
                        "request tracing (rspan records; shed requests "
                        "are always captured)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--model", type=str, default="cnn",
                   choices=["cnn", "resnet18", "resnet50", "vit_tiny",
                            "vit_moe"],
                   help="cnn (the reference), resnet18, resnet50, "
                        "vit_tiny or vit_moe (ViT-Ti with a routed expert "
                        "bank in every block; --moe_experts defaults to 8)")
    p.add_argument("--moe_experts", type=int, default=0,
                   help="experts per MoE block (vit_moe); split over the "
                        "model ranks (expert parallelism)")
    p.add_argument("--moe_top_k", type=int, default=1,
                   help="experts per token: 1 = Switch, 2 = GShard")
    p.add_argument("--moe_dispatch", type=str, default="einsum",
                   choices=["einsum", "scatter"],
                   help="MoE dispatch/combine: einsum ([T,E,C] one-hot "
                        "contractions) or scatter ((expert,slot) indexed "
                        "add and gather, O(T*D) instead of O(T^2*f*D)). "
                        "Same semantics either way")
    p.add_argument("--dataset", type=str, default="cifar10",
                   choices=["cifar10", "cifar100", "synthetic",
                            "imagenet_synth"],
                   help="imagenet_synth: generated ImageNet-shaped shards "
                        "(256 px stored, 224 px crop, 1000 classes, "
                        "2-byte labels); cifar100 reads its binaries")
    p.add_argument("--image_size", type=int, default=None,
                   help="stored square image side (default: 32; 256 for "
                        "imagenet_synth)")
    p.add_argument("--crop_size", type=int, default=None,
                   help="model input side after crop (default: 24; 224 "
                        "for imagenet_synth)")
    p.add_argument("--synthetic_train_records", type=int, default=None,
                   help="generated train records for the synthetic and "
                        "imagenet_synth datasets")
    p.add_argument("--resnet_norm", type=str, default="bn",
                   choices=["bn", "nf"],
                   help="ResNet normalization: bn (cross-replica BatchNorm "
                        "with running stats) or nf (normalizer-free: "
                        "scaled weight standardization, no running stats)")
    p.add_argument("--resnet_s2d", type="bool", default=False,
                   help="space-to-depth ResNet stem (ImageNet stems only): "
                        "a 4x4/1 conv on the 2x2-folded input instead of "
                        "7x7/2")
    p.add_argument("--use_native_loader", type="bool", default=False,
                   help="the JAX package's C++ shuffle-pool loader is not "
                        "ported: false (the numpy pipeline) is accepted, "
                        "true raises")
    p.add_argument("--fidelity", type=str, default="faithful",
                   choices=["faithful", "fixed"],
                   help="faithful reproduces the reference quirks (ReLU'd "
                        "logits, dead LR decay, single-batch eval, raw "
                        "pixels); fixed applies the sane versions")
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--total_steps", type=int, default=20000)
    p.add_argument("--output_every", type=int, default=200,
                   help="train-metrics cadence (reference OUTPUT_EVERY)")
    p.add_argument("--eval_every", type=int, default=500,
                   help="eval cadence (reference EVAL_EVERY)")
    p.add_argument("--checkpoint_every", type=int, default=1000)
    p.add_argument("--checkpoint_every_secs", type=float, default=None,
                   help="wall-clock checkpoint cadence in addition to the "
                        "step cadence (the reference's MTS saved every "
                        "600 s by default)")
    p.add_argument("--async_checkpoint", type="bool", default=False,
                   help="serialize+write checkpoints on a background "
                        "thread (training overlaps the disk IO; the "
                        "device-to-host copy stays at the save)")
    p.add_argument("--learning_rate", type=float, default=0.1)
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--optimizer", type=str, default="sgd",
                   choices=["sgd", "adamw", "lars", "lamb", "adafactor"],
                   help="sgd = reference; adamw for the transformer "
                        "ladder; lars/lamb add the per-layer trust ratio "
                        "for large-global-batch scaling; adafactor keeps "
                        "factored second moments")
    p.add_argument("--momentum", type=float, default=0.0,
                   help="SGD momentum (reference uses plain SGD)")
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--label_smoothing", type=float, default=0.0)
    p.add_argument("--random_brightness", type=float, default=0.0,
                   help="augment: per-image brightness delta (pixel "
                        "units; the TF tutorial used 63)")
    p.add_argument("--random_contrast", type=float, default=0.0,
                   help="augment: per-image contrast deviation (the TF "
                        "tutorial's [0.2,1.8] is 0.8)")
    p.add_argument("--grad_clip_norm", type=float, default=None,
                   help="global-norm gradient clipping")
    p.add_argument("--grad_accum", type=int, default=1,
                   help="microbatches per optimizer update (gradient "
                        "accumulation inside the step)")
    p.add_argument("--async_staleness", type=int, default=0,
                   help="emulate the reference's async-PS gradient "
                        "staleness deterministically: grads taken at a "
                        "snapshot S-1 updates old (0/1 = synchronous)")
    p.add_argument("--schedule", type=str, default="exponential",
                   choices=["exponential", "cosine", "constant"],
                   help="LR schedule family (exponential = reference "
                        "parity; cosine for the ViT ladder)")
    p.add_argument("--warmup_steps", type=int, default=0,
                   help="linear LR warmup prepended to any schedule")
    p.add_argument("--cosine_decay_steps", type=int, default=0,
                   help="cosine horizon (defaults to total_steps when "
                        "--schedule cosine and this is 0)")
    # --- ViT flags (the JAX package's names and defaults) ---
    p.add_argument("--vit_dim", type=int, default=None,
                   help="ViT embed dim (default 192)")
    p.add_argument("--vit_depth", type=int, default=None,
                   help="ViT blocks (default 12)")
    p.add_argument("--vit_heads", type=int, default=None,
                   help="ViT attention heads (default 3)")
    p.add_argument("--pool", type=str, default=None, choices=["cls", "mean"],
                   help="ViT head pooling; defaults to cls, or mean when "
                        "seq_axis > 1 (sequence sharding excludes a lone "
                        "cls token)")
    p.add_argument("--model_axis", type=int, default=1,
                   help="tensor-parallel mesh degree")
    p.add_argument("--seq_axis", type=int, default=1,
                   help="sequence-parallel degree (the ViT's tokens, the "
                        "CNN's image rows): the world is data x model_axis "
                        "x seq_axis x pipe_axis ranks")
    p.add_argument("--pipe_axis", type=int, default=1,
                   help="pipeline-parallel mesh degree (stages; schedule "
                        "per --pipe_schedule)")
    p.add_argument("--pipe_schedule", type=str, default="1f1b",
                   choices=["1f1b", "1f1b_ring", "gpipe"],
                   help="pipeline schedule: 1f1b (no bubble compute, "
                        "recompute backward — minimal memory), 1f1b_ring "
                        "(2F+1B residual-ring backward, opt-in) or gpipe "
                        "(the baseline: the stage runs on every tick)")
    p.add_argument("--pipe_microbatches", type=int, default=0,
                   help="pipeline microbatches per step (0 = one per "
                        "stage). More microbatches shrink 1f1b's live "
                        "activation footprint AND gpipe's bubble fraction "
                        "(M+P-1)/M at the cost of smaller per-microbatch "
                        "compute")
    p.add_argument("--sp_mode", type=str, default="ring",
                   choices=["ring", "ulysses"],
                   help="sequence-parallel attention strategy: ring (K/V "
                        "shards walk the ring) or ulysses (all-to-all "
                        "seq<->heads; needs vit_heads % seq_axis == 0)")
    p.add_argument("--dist_backend", type=str, default=None,
                   choices=["nccl", "gloo"],
                   help="torch.distributed backend (default nccl on cuda, "
                        "gloo on cpu); several ranks on one card need "
                        "gloo")
    p.add_argument("--remat", type="bool", default=False,
                   help="recompute each ViT block's activations in the "
                        "backward pass (activation memory O(1) in depth)")
    p.add_argument("--attn_causal", type="bool", default=False,
                   help="causal attention mask in the ViT's blocks")
    p.add_argument("--attn_window", type=int, default=None,
                   help="sliding-window attention width for the ViT: "
                        "band |row-col| < W")
    p.add_argument("--ema_decay", type=float, default=0.0,
                   help="parameter EMA decay for eval (0 = off)")
    p.add_argument("--fused_optimizer", type="bool", default=True,
                   help="fused single-pass SGD update (ops/optimizer.py: "
                        "the hand-written CUDA kernel on the card); false "
                        "keeps the per-transform chain")
    p.add_argument("--fsdp", type="bool", default=False,
                   help="ZeRO/FSDP: shard params + optimizer moments over "
                        "the data axis (state memory 1/N; grads become "
                        "reduce-scatter)")
    p.add_argument("--optimizer_sharding", type=str, default="none",
                   choices=["none", "zero1"],
                   help="cross-replica weight-update sharding: zero1 "
                        "allocates the optimizer moments sharded 1/N over "
                        "the data axis from init on, reduce-scatters "
                        "grads, updates each replica's shard (K1/K2 on "
                        "the shards), and all-gathers the new params for "
                        "the next forward — same math as replicated "
                        "(pinned <=1e-6), checkpoints interchange across "
                        "modes. Excludes --fsdp and --async_staleness")
    p.add_argument("--partition_rules", type=str, default=None,
                   help="override the model's partition-rule table "
                        "(parallel/shardings.py engine): ordered "
                        "';'-separated 'regex=spec' rules matched against "
                        "/-joined param paths; spec is comma-separated "
                        "per-dim axis names, right-aligned ('-' = "
                        "unsharded dim, '^' prefix = left-aligned, empty "
                        "= replicated)")
    p.add_argument("--partition_rules_strict", type="bool", default=False,
                   help="error at build time on any param leaf no "
                        "partition rule matches (instead of silently "
                        "replicating it)")
    p.add_argument("--partition_report", type="bool", default=False,
                   help="print the which-rule-matched-which-param "
                        "report (path, shape, rule, spec) at Trainer "
                        "build")
    p.add_argument("--ckpt_format", type=str, default="msgpack",
                   choices=["msgpack", "orbax", "sharded"],
                   help="checkpoint codec: single-file flax msgpack, or "
                        "per-process sharded files (no full-state gather, "
                        "each process writes only its own shards; restore "
                        "auto-detects and re-shards onto any layout). "
                        "orbax is not ported (it needs orbax.checkpoint, "
                        "which imports JAX)")
    p.add_argument("--shard_io_threads", type=int, default=4,
                   help="bounded thread pool for the sharded codec's "
                        "concurrent per-shard file IO: saves split the "
                        "local payload across up to this many part "
                        "files written in parallel, restores "
                        "read+verify+unpack shard files in parallel "
                        "(per-shard sha256 sidecars; shard_io JSONL "
                        "telemetry). 1 = fully serial, same bytes")
    p.add_argument("--steps_per_dispatch", type=int, default=1,
                   help="train steps per device dispatch (one CUDA graph "
                        "replay of K steps on the card; output/eval/"
                        "checkpoint cadences must be multiples)")
    p.add_argument("--resident_data", type="bool", default=True,
                   help="with --steps_per_dispatch >1, keep the uint8 "
                        "dataset on the device and gather on device "
                        "(one process; host-fed raw chunks past "
                        "the size cap)")
    p.add_argument("--device_index_stream", type="bool", default=True,
                   help="resident path only: generate the shuffled index "
                        "stream ON DEVICE (stateless per-epoch "
                        "pseudo-permutation keyed on the global step), so "
                        "a training dispatch uploads nothing and a resume "
                        "continues the data order exactly. Different "
                        "(equally valid) permutation than the host "
                        "stream; toggling changes data order. 'false' "
                        "restores the host numpy stream")
    p.add_argument("--peak_tflops", type=float, default=None,
                   help="per-chip peak TFLOP/s; enables the MFU metric "
                        "in the jsonl stream")
    p.add_argument("--check_numerics", type="bool", default=False,
                   help="halt at the next metrics boundary on non-finite "
                        "loss without checkpointing the poisoned state "
                        "(faithful parity runs NaN by design — keep off)")
    p.add_argument("--on_nonfinite", type=str, default="halt",
                   choices=["halt", "skip", "rollback"],
                   help="what a --check_numerics detection does: halt "
                        "raises without saving; skip discards the "
                        "updates since the last finite boundary and "
                        "keeps training; rollback raises a classified "
                        "failure the --supervise loop answers by "
                        "restoring the last good checkpoint (optionally "
                        "scaling LR by --rollback_lr_scale). skip/"
                        "rollback degrade to halt when the "
                        "--recovery_retries budget is exhausted")
    p.add_argument("--supervise", type="bool", default=False,
                   help="wrap training in the recovery supervisor: "
                        "classified recoverable failures (non-finite "
                        "loss under rollback, data-pipeline errors, "
                        "checkpoint-restore errors) restore the last "
                        "verifiable checkpoint, rewind the exact-resume "
                        "data state, back off, and resume")
    p.add_argument("--recovery_retries", type=int, default=3,
                   help="shared recovery budget: max on_nonfinite=skip "
                        "events per run AND max supervisor restarts; "
                        "exhausted degrades to halt")
    p.add_argument("--retry_budget_window", type=int, default=0,
                   help="progress-based retry-budget reset: when > 0, "
                        "the supervisor's attempt counter resets after "
                        "the newest checkpoint advances this many "
                        "steps past the last retry — long runs "
                        "absorbing well-spaced faults keep recovering "
                        "while a fault burst still degrades to halt. "
                        "0 = lifetime budget (historical behavior)")
    p.add_argument("--recovery_backoff_s", type=float, default=0.5,
                   help="supervisor restart backoff base (doubles per "
                        "attempt, capped at 30s)")
    p.add_argument("--rollback_lr_scale", type=float, default=1.0,
                   help="LR multiplier applied at each supervisor "
                        "rollback of a non-finite failure (1.0 = keep "
                        "LR; a deterministically diverging run replayed "
                        "at the same LR diverges again)")
    p.add_argument("--fault_spec", type=str, default=None,
                   help="deterministic fault injection for recovery "
                        "drills: comma-separated kind@trigger with kinds "
                        "nan, ckpt_corrupt, sigterm, data_stall — plus "
                        "the cluster kinds heartbeat_stall, host_lost, "
                        "collective_hang, host_return, decision_corrupt "
                        "(need --cluster_dir). A trigger is a global "
                        "step (fires once at the first dispatch at/after "
                        "it; several faults may share a step) or a "
                        "recovery phase restore|adopt|decide that fires "
                        "inside the supervisor's recovery paths "
                        "(utils/faults.py); the replica kinds "
                        "replica_corrupt, replica_stale (need "
                        "--peer_redundancy) and the network kinds "
                        "net_partition, net_delay, net_drop, net_dup "
                        "(need --cluster_transport net)")
    p.add_argument("--cluster_dir", type=str, default=None,
                   help="shared directory arming the cluster-resilience "
                        "layer (parallel/cluster.py): per-process "
                        "heartbeats, a collective watchdog classifying "
                        "straggler vs. hang/host-loss at each dispatch "
                        "seam, and chief-recorded coordinated elastic "
                        "restarts. NFS/GCS-fuse in production, a tmpdir "
                        "in the CPU simulation")
    p.add_argument("--heartbeat_interval_s", type=float, default=0.5,
                   help="background heartbeat cadence; beats publish "
                        "from a daemon thread so a compiling/blocked "
                        "host still looks alive")
    p.add_argument("--straggler_after_s", type=float, default=2.0,
                   help="dispatch-seam overrun after which the watchdog "
                        "classifies peers (straggler telemetry for "
                        "beating-but-behind peers)")
    p.add_argument("--peer_dead_after_s", type=float, default=10.0,
                   help="a peer whose newest heartbeat is older than "
                        "this is declared lost: the run aborts "
                        "deterministically (and elastically restarts "
                        "under --supervise) instead of blocking in a "
                        "collective forever")
    p.add_argument("--collective_timeout_s", type=float, default=120.0,
                   help="armed-seam duration after which the watchdog "
                        "presumes the main thread wedged inside a "
                        "collective and aborts this process after "
                        "logging (a loud corpse beats a silent hang)")
    p.add_argument("--min_hosts", type=int, default=1,
                   help="floor for coordinated elastic restarts: the "
                        "chief halts instead of shrinking the world "
                        "below this many surviving hosts")
    p.add_argument("--elastic_expand", type="bool", default=False,
                   help="elastic scale-UP: a returning (or brand-new) "
                        "host announces itself with a rejoin-phase "
                        "heartbeat instead of staying fenced; the chief "
                        "records a monotone-epoch expand decision "
                        "growing the world to the live hosts and every "
                        "process re-enters restore at the larger size. "
                        "false = shrink-only: "
                        "evicted hosts stay fenced")
    p.add_argument("--peer_redundancy", type="bool", default=False,
                   help="diskless recovery (ckpt/peerstore.py): at every "
                        "checkpoint boundary each host also pushes its "
                        "local shard payload to its ring-successor's "
                        "replica store under --cluster_dir (async, "
                        "off the step path, sha256 sidecars); on "
                        "host_lost the chief may decide source=peer and "
                        "survivors restore with ZERO checkpoint reads, "
                        "reconstructing the lost host's shards from its "
                        "replica; any missing/stale/corrupt replica "
                        "falls back to the disk restore walk. n=1: "
                        "no-op (flag legal)")
    p.add_argument("--replica_keep", type=int, default=2,
                   help="peer-replica retention: committed replica "
                        "payloads kept per owner (newest K checkpoint "
                        "boundaries)")
    p.add_argument("--restore_deadline_s", type=float, default=0.0,
                   help="wall-clock budget for the newest→oldest "
                        "checkpoint fallback walk at restore; exceeding "
                        "it raises a classified ckpt_restore error "
                        "instead of scanning a huge retention dir "
                        "forever (0 = unbounded)")
    p.add_argument("--cluster_transport", type=str, default="file",
                   choices=["file", "net"],
                   help="coordination transport (heartbeats, restart "
                        "decisions, peer-replica pushes): 'file' = the "
                        "shared-directory store (n=1 and test fallback); "
                        "'net' = a socket service (parallel/net.py) "
                        "hosted by process 0 over the same directory — "
                        "bounded timeouts, classified transport errors, "
                        "and the seam the net_* chaos faults partition")
    p.add_argument("--net_timeout_s", type=float, default=5.0,
                   help="per-request socket timeout on the net "
                        "coordination transport; every operation is "
                        "bounded so a dead/partitioned coordinator "
                        "degrades to the classified peer_lost/eviction "
                        "paths, never a hang (lockstep sims run 0.5)")
    p.add_argument("--net_retries", type=int, default=2,
                   help="bounded retry budget per net-transport "
                        "operation (exponential backoff between "
                        "attempts; retried on timeout/unreachable/5xx)")
    p.add_argument("--cluster_lockstep", type="bool", default=False,
                   help="simulation only: make the dispatch seam a "
                        "software barrier over the heartbeat store so "
                        "multi-process CPU runs without real "
                        "collectives still block on (and recover from) "
                        "a lost peer; real pods leave this off")
    p.add_argument("--coordinator_timeout_s", type=float, default=60.0,
                   help="per-attempt torch.distributed rendezvous wait "
                        "for the coordinator; a slow-to-start "
                        "coordinator is retried with bounded backoff "
                        "(--coordinator_retries), not crashed on")
    p.add_argument("--coordinator_retries", type=int, default=3,
                   help="bounded retry budget around the coordinator "
                        "bootstrap")
    p.add_argument("--preempt_sync_every", type=int, default=10,
                   help="steps between the ranks' preemption/clock-save "
                        "agreement exchanges (one process reacts "
                        "immediately)")
    p.add_argument("--telemetry", type="bool", default=False,
                   help="run-health telemetry: host-loop span tracing, "
                        "goodput fractions, and device-memory snapshots "
                        "emitted into the metrics JSONL at the existing "
                        "boundaries (no extra device reads)")
    p.add_argument("--trace_events_path", type=str, default=None,
                   help="write the host-loop spans as a Chrome "
                        "trace-event JSON file (Perfetto-loadable); "
                        "needs --telemetry true")
    p.add_argument("--health_metrics", type="bool", default=False,
                   help="compute global grad-norm / param-norm / "
                        "update-ratio scalars inside the train step; they "
                        "ride the boundary's one device read into the "
                        "train JSONL records")
    p.add_argument("--tensorboard_dir", type=str, default=None,
                   help="write TensorBoard event files (chief only; needs "
                        "the tensorboardX package; the reference's MTS "
                        "wrote summaries to --log_dir)")
    p.add_argument("--metrics_jsonl", type=str, default=None)
    p.add_argument("--profile_dir", type=str, default=None)
    p.add_argument("--profile_at_steps", type=str, default=None,
                   help="device-time attribution window 'N:K': capture "
                        "a torch.profiler trace from global step N for K "
                        "steps (closing at the next drained metrics "
                        "boundary), parse it host-side, and log `devtime` "
                        "records (top kernels; compute / collective / "
                        "infeed buckets). Writes under --profile_dir when "
                        "set, else <log_dir>/devprof")
    p.add_argument("--seed", type=int, default=0)
    return p


def config_from_args(args: argparse.Namespace) -> config_lib.TrainConfig:
    make = (config_lib.reference_config if args.fidelity == "faithful"
            else config_lib.fixed_config)
    cfg = make(
        batch_size=args.batch_size,
        total_steps=args.total_steps,
        output_every=args.output_every,
        eval_every=args.eval_every,
        checkpoint_every=args.checkpoint_every,
        checkpoint_every_secs=args.checkpoint_every_secs,
        async_checkpoint=args.async_checkpoint,
        shard_io_threads=args.shard_io_threads,
        log_dir=args.log_dir,
        metrics_jsonl=args.metrics_jsonl,
        telemetry=args.telemetry,
        trace_events_path=args.trace_events_path,
        health_metrics=args.health_metrics,
        preempt_sync_every=args.preempt_sync_every,
        check_numerics=args.check_numerics,
        on_nonfinite=args.on_nonfinite,
        recovery_retries=args.recovery_retries,
        retry_budget_window=args.retry_budget_window,
        recovery_backoff_s=args.recovery_backoff_s,
        rollback_lr_scale=args.rollback_lr_scale,
        supervise=args.supervise,
        fault_spec=args.fault_spec,
        tensorboard_dir=args.tensorboard_dir,
        seed=args.seed,
        device=args.device,
        peak_tflops=args.peak_tflops,
        profile_dir=args.profile_dir,
        profile_at_steps=args.profile_at_steps,
    )
    from dml_cnn_cifar10_tpu_torch.utils import devprof
    try:
        devprof.parse_profile_at_steps(args.profile_at_steps)
    except ValueError as e:
        raise SystemExit(str(e))
    cfg.data.dataset = args.dataset
    cfg.data.data_dir = args.data_dir
    cfg.data.random_brightness = args.random_brightness
    cfg.data.random_contrast = args.random_contrast
    if args.use_native_loader:
        raise NotImplementedError(
            "--use_native_loader true: the JAX package's C++ loader "
            "(runtime/recordio.cc) is not ported; see ROADMAP.md Queue 1 "
            "item 9. Pass --use_native_loader false (the numpy pipeline)")
    if args.dataset == "cifar100":
        cfg.data.num_classes = cfg.model.num_classes = 100
    if args.dataset == "imagenet_synth":
        # The ResNet-50 ImageNet-1k rung: 256 stored / 224 crop, 1000
        # classes (JAX cli/main.py:758-765).
        cfg.data.image_height = cfg.data.image_width = 256
        cfg.data.crop_height = cfg.data.crop_width = 224
        cfg.data.num_classes = cfg.model.num_classes = 1000
    if args.image_size is not None:
        cfg.data.image_height = cfg.data.image_width = args.image_size
    if args.crop_size is not None:
        cfg.data.crop_height = cfg.data.crop_width = args.crop_size
    if args.synthetic_train_records is not None:
        cfg.data.synthetic_train_records = args.synthetic_train_records
    # Seed the data stream (shuffle + device-side augmentation draws)
    # from the run seed, as the JAX CLI does.
    cfg.data.seed = args.seed
    cfg.steps_per_dispatch = args.steps_per_dispatch
    cfg.resident_data = args.resident_data
    cfg.data.device_index_stream = args.device_index_stream
    cfg.model.name = args.model
    cfg.model.compute_dtype = args.compute_dtype
    cfg.optim.learning_rate = args.learning_rate
    cfg.optim.optimizer = args.optimizer
    cfg.optim.momentum = args.momentum
    cfg.optim.weight_decay = args.weight_decay
    cfg.optim.ema_decay = args.ema_decay
    cfg.optim.fused_optimizer = args.fused_optimizer
    cfg.optim.label_smoothing = args.label_smoothing
    cfg.optim.grad_clip_norm = args.grad_clip_norm
    cfg.optim.grad_accum = args.grad_accum
    cfg.optim.async_staleness = args.async_staleness
    cfg.optim.schedule = args.schedule
    cfg.optim.warmup_steps = args.warmup_steps
    cfg.optim.cosine_decay_steps = args.cosine_decay_steps
    if args.schedule == "cosine" and not args.cosine_decay_steps:
        cfg.optim.cosine_decay_steps = cfg.total_steps
    if args.pool is not None:
        cfg.model.pool = args.pool
    elif args.seq_axis > 1:
        cfg.model.pool = "mean"
    cfg.model.sp_mode = args.sp_mode
    cfg.parallel.model_axis = args.model_axis
    cfg.parallel.seq_axis = args.seq_axis
    cfg.parallel.pipe_axis = args.pipe_axis
    if args.pipe_microbatches and args.pipe_axis <= 1:
        # Silently measuring "plain dp" while believing it's an M=4P
        # schedule is exactly the trap the moe_experts guard below
        # already closes for its flag pair.
        raise SystemExit(
            f"--pipe_microbatches={args.pipe_microbatches} requires "
            f"--pipe_axis > 1 (got {args.pipe_axis}); without a pipe "
            f"axis there is no schedule to microbatch")
    if args.pipe_schedule != "1f1b" and args.pipe_axis <= 1:
        # Mirror the --pipe_microbatches guard: without a pipe axis the
        # sequential fast path runs and a requested gpipe schedule would
        # be silently ignored — reject instead of mislabeling a bench.
        raise SystemExit(
            f"--pipe_schedule={args.pipe_schedule} requires --pipe_axis "
            f"> 1 (got {args.pipe_axis}); without a pipe axis there is "
            f"no schedule to select")
    cfg.model.pipe_microbatches = args.pipe_microbatches
    cfg.model.pipe_schedule = args.pipe_schedule
    cfg.parallel.dist_backend = args.dist_backend
    cfg.parallel.cluster_dir = args.cluster_dir
    cfg.parallel.heartbeat_interval_s = args.heartbeat_interval_s
    cfg.parallel.straggler_after_s = args.straggler_after_s
    cfg.parallel.peer_dead_after_s = args.peer_dead_after_s
    cfg.parallel.collective_timeout_s = args.collective_timeout_s
    cfg.parallel.min_hosts = args.min_hosts
    cfg.parallel.elastic_expand = args.elastic_expand
    cfg.parallel.peer_redundancy = args.peer_redundancy
    cfg.parallel.replica_keep = args.replica_keep
    cfg.restore_deadline_s = args.restore_deadline_s
    cfg.parallel.cluster_transport = args.cluster_transport
    cfg.parallel.net_timeout_s = args.net_timeout_s
    cfg.parallel.net_retries = args.net_retries
    cfg.parallel.cluster_lockstep = args.cluster_lockstep
    cfg.parallel.coordinator_timeout_s = args.coordinator_timeout_s
    cfg.parallel.coordinator_retries = args.coordinator_retries
    if args.ckpt_format == "orbax":
        raise SystemExit(
            "--ckpt_format orbax is not portable to the PyTorch port: it "
            "needs orbax.checkpoint, which imports JAX; use msgpack or "
            "sharded (both interchange with the JAX package)")
    cfg.ckpt_format = args.ckpt_format
    cfg.parallel.fsdp = args.fsdp
    cfg.optim.optimizer_sharding = args.optimizer_sharding
    cfg.parallel.partition_rules = args.partition_rules
    cfg.parallel.partition_rules_strict = args.partition_rules_strict
    cfg.parallel.partition_report = args.partition_report
    if args.optimizer_sharding == "zero1":
        # A silently ignored sharding mode would mislabel every run that
        # rides it.
        if args.fsdp:
            raise SystemExit(
                "--optimizer_sharding zero1 does not compose with "
                "--fsdp (ZeRO-3 already shards the optimizer moments)")
        if args.async_staleness >= 2:
            raise SystemExit(
                "--optimizer_sharding zero1 does not compose with "
                "--async_staleness: the snapshot ring serves the forward "
                "pass and must stay whole, but zero1 shards the update "
                "state it is refreshed from")
    hosts = args.worker_hosts.split(",") if args.worker_hosts else []
    if hosts:
        multihost.parallel_from_hosts(hosts, args.task_index, cfg.parallel)
    for f in ("vit_heads", "vit_dim", "vit_depth"):
        if getattr(args, f) is not None:
            setattr(cfg.model, f, getattr(args, f))
    if args.moe_experts and args.model != "vit_moe":
        raise SystemExit(
            f"--moe_experts requires --model vit_moe (got {args.model})")
    cfg.model.moe_experts = args.moe_experts
    if args.model == "vit_moe" and args.moe_experts == 0:
        cfg.model.moe_experts = 8
    cfg.model.moe_top_k = args.moe_top_k
    cfg.model.moe_dispatch = args.moe_dispatch
    cfg.model.remat = args.remat
    cfg.model.resnet_norm = args.resnet_norm
    cfg.model.resnet_s2d = args.resnet_s2d
    cfg.model.attn_causal = args.attn_causal
    cfg.model.attn_window = args.attn_window
    try:
        cfg.serve.buckets = tuple(
            int(b) for b in args.serve_buckets.split(",") if b.strip())
    except ValueError:
        raise SystemExit(
            f"--serve_buckets must be comma-separated ints, got "
            f"{args.serve_buckets!r}")
    cfg.serve.max_queue_depth = args.serve_queue_depth
    cfg.serve.batch_window_ms = args.serve_batch_window_ms
    cfg.serve.deadline_ms = args.serve_deadline_ms
    cfg.serve.port = args.serve_port
    cfg.serve.artifact_path = args.serve_artifact
    cfg.serve.metrics_every_s = args.serve_metrics_every_s
    cfg.serve.drain_deadline_s = args.serve_drain_deadline_s
    cfg.serve.trace_sample_rate = args.trace_sample_rate
    cfg.serve.cache_size = args.serve_cache_size
    return cfg


def main(argv: Optional[List[str]] = None) -> int:
    args, unparsed = build_parser().parse_known_args(argv)
    if unparsed:
        print(f"[cli] ignoring unrecognized args: {unparsed}",
              file=sys.stderr)

    if args.job_name == "ps":
        # The reference blocks a whole process on server.join()
        # (cifar10cnn.py:191-192). Parameters live on the device here.
        print("[cli] job_name=ps is obsolete: parameters live on the "
              "device. Nothing to serve; exiting.")
        return 0

    cfg = config_from_args(args)
    if args.mode in ("export", "serve") and args.model_axis > 1:
        raise NotImplementedError(
            f"--mode {args.mode} serves one process's whole model from a "
            f"checkpoint (which holds every leaf whole): run it without "
            f"--model_axis; serving a tensor-parallel model is ROADMAP.md "
            f"Queue 1, the tensor-parallel items")
    if args.mode == "export":
        return _export(cfg, args.export_path)
    if args.mode == "serve":
        from dml_cnn_cifar10_tpu_torch.serve.server import main_serve
        return main_serve(cfg, task_index=args.task_index)
    if args.mode == "eval":
        cfg.eval_full_test_set = True
    import torch.distributed as dist

    from dml_cnn_cifar10_tpu_torch.train.loop import Trainer

    try:
        if args.mode == "train" and cfg.supervise:
            from dml_cnn_cifar10_tpu_torch.train.supervisor import \
                fit_supervised
            result = fit_supervised(cfg, task_index=args.task_index)
            if result is None:
                # Fenced by a cluster restart decision (peers declared
                # this process dead): a clean, saveless exit.
                print("[cli] fenced by the cluster restart decision; "
                      "exiting cleanly")
                return 0
            print(f"[cli] done at step {result.final_step}; "
                  f"{result.images_per_sec:.1f} images/sec")
            return 0
        trainer = Trainer(cfg, task_index=args.task_index)
        try:
            if args.mode == "eval":
                _evaluate(trainer)
            else:
                result = trainer.fit()
                print(f"[cli] done at step {result.final_step}; "
                      f"{result.images_per_sec:.1f} images/sec")
        finally:
            trainer.close()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


def _evaluate(trainer) -> None:
    """``--mode eval``: restore the newest checkpoint, sweep the full
    test split, print the reference's accuracy line."""
    cfg = trainer.cfg
    state = trainer.init_or_restore()
    step = int(state.step)
    if step == 0:
        print(f"[cli] warning: no checkpoint under {cfg.log_dir}; "
              "evaluating fresh-initialized weights", file=sys.stderr)
    test_it = trainer.input_pipeline(train=False, seed=cfg.seed)
    acc = trainer.evaluate(state, test_it)
    print(f" --- Test Accuracy = {acc * 100:.2f}%.")
    print(f"[cli] eval at step {step}: {acc * 100:.2f}% on "
          f"{test_it.total_records} records")


def _export(cfg, path: Optional[str]) -> int:
    """``--mode export``: restore the newest checkpoint (the EMA weights
    when kept) and write the serving artifact."""
    import os

    from dml_cnn_cifar10_tpu_torch import export as export_lib
    from dml_cnn_cifar10_tpu_torch.utils.platform import resolve_device

    model, params, step = export_lib.restore_serving_params(
        cfg, resolve_device(cfg.device))
    if step == 0:
        print(f"[cli] warning: no checkpoint under {cfg.log_dir}; "
              "exporting fresh-initialized weights", file=sys.stderr)
    path = path or os.path.join(cfg.log_dir, export_lib.ARTIFACT_NAME)
    program = export_lib.export_forward(model, cfg.data, params)
    export_lib.save_exported(path, program)
    print(f"[cli] exported step-{step} forward ({os.path.getsize(path)} "
          f"bytes, uint8 {export_lib.artifact_image_shape(program)} in, "
          f"symbolic batch) to {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
