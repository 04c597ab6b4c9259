"""Typed configuration for the PyTorch port.

A copy of the fields of ``dml_cnn_cifar10_tpu/config.py`` that the
port's paths read (the reference CNN trainer, the ViT), with the same
defaults and the same reference ``file:line`` notes. The reference keeps
every hyperparameter
as a module-level constant (``cifar10cnn.py:9-27``); here they are
dataclass fields so parity runs are the zero-config path.

Fidelity switches (faithful by default, like the JAX package):
(1) ReLU applied to the logits (``cifar10cnn.py:145``),
(2) a dead LR-decay schedule (``cifar10cnn.py:161,216`` — effective LR is
    a constant 0.1),
(3) eval on a single *shuffled* 128-image test batch rather than the full
    test set (``cifar10cnn.py:202,238``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass
class DataConfig:
    """Input pipeline config. Reference: ``cifar10cnn.py:9-27,34-91``."""

    dataset: str = "cifar10"   # cifar10 | cifar100 | synthetic | imagenet_synth
    data_dir: str = "cifar10data"         # reference constant (cifar10cnn.py:26)
    image_height: int = 32                # cifar10cnn.py:15
    image_width: int = 32                 # cifar10cnn.py:16
    crop_height: int = 24                 # cifar10cnn.py:17
    crop_width: int = 24                  # cifar10cnn.py:18
    num_channels: int = 3                 # cifar10cnn.py:19
    num_classes: int = 10                 # cifar10cnn.py:20 (NUM_TARGETS)
    # Reference crop is a deterministic center crop despite the "Randomly
    # Crop" comment (cifar10cnn.py:67-68). random_crop=True enables the
    # augmentation the comment intended (fixed mode).
    random_crop: bool = False
    random_flip: bool = False
    # Color jitter (the TF CIFAR-tutorial lineage the reference derives
    # from used random_brightness(63) + random_contrast(0.2, 1.8)):
    # brightness adds U[-b, b] in pixel units per image; contrast scales
    # per-channel deviation-from-mean by U[1-c, 1+c]. 0 = off.
    random_brightness: float = 0.0
    random_contrast: float = 0.0
    # Pixel normalization. The reference feeds raw 0..255 floats
    # (cifar10cnn.py:66 — cast, no scaling); "scale" maps to [0,1];
    # "standardize" is tf.image.per_image_standardization.
    normalize: str = "none"               # none | scale | standardize
    prefetch: int = 2                     # host->device prefetch depth
    seed: int = 0
    # Resident path only (TrainConfig.steps_per_dispatch > 1 with
    # resident_data): generate the shuffled index stream ON THE DEVICE
    # (data/device_stream.py: a stateless per-epoch pseudo-permutation
    # keyed on the global step), so a training dispatch moves nothing
    # host->device and a resumed run continues the data order exactly.
    # The shuffle is a different (equally valid) permutation than the
    # host stream's numpy-PCG one, so toggling this flag changes the data
    # order; false restores the host numpy stream.
    device_index_stream: bool = True
    # Synthetic mode generates CIFAR-format .bin files locally (same
    # 3073-byte record layout) for air-gapped testing/benchmarking.
    synthetic_train_records: int = 2048
    synthetic_test_records: int = 512

    # Every randomized-augmentation field and its "off" value: the one
    # list ``augmented`` and ``without_augmentation`` both derive from.
    _AUG_OFF = (("random_crop", False), ("random_flip", False),
                ("random_brightness", 0.0), ("random_contrast", 0.0))

    @property
    def augmented(self) -> bool:
        """True when any randomized augmentation is on: the device decode
        (ops/preprocess.py) then needs a step to key its draws on."""
        return any(getattr(self, name) != off for name, off in self._AUG_OFF)

    def without_augmentation(self) -> "DataConfig":
        """Eval-time decode config: every randomized augmentation off."""
        return dataclasses.replace(self, **dict(self._AUG_OFF))

    @property
    def record_bytes(self) -> int:
        """1 label byte + H*W*C image bytes (cifar10cnn.py:24-25)."""
        return 1 + self.image_height * self.image_width * self.num_channels


@dataclasses.dataclass
class ModelConfig:
    """Model selection + faithful-mode switches."""

    name: str = "cnn"                     # cnn | resnet18 | resnet50 | vit_*
    num_classes: int = 10
    # Reference applies ReLU to the final logits (cifar10cnn.py:145).
    # Faithful mode keeps it; fixed mode emits raw logits.
    logit_relu: bool = True
    # Initializers: truncated normal sigma=0.05 (cifar10cnn.py:97-98),
    # bias constant 0.1 (cifar10cnn.py:100-101).
    init_stddev: float = 0.05
    bias_init: float = 0.1
    dtype: str = "float32"                # param dtype
    compute_dtype: str = "float32"        # activations: float32 | bfloat16
    # BatchNorm knobs (the ResNets): running stats m·old + (1−m)·batch.
    bn_momentum: float = 0.9
    bn_eps: float = 1e-5
    # ResNet normalization: "bn" (cross-replica BatchNorm with running
    # stats) or "nf" (normalizer-free: scaled weight standardization,
    # per-conv biases and a SkipInit residual scalar; no running stats).
    # Checkpoints do not interchange across this flag.
    resnet_norm: str = "bn"
    # Space-to-depth stem for the ImageNet-stem ResNets: the image folded
    # 2x2 into channels and a 4x4/1 conv in place of the 7x7/2 one (a
    # different stem param shape).
    resnet_s2d: bool = False
    # ViT-specific knobs (ignored by the CNN).
    patch_size: int = 4
    vit_dim: int = 192
    vit_depth: int = 12
    vit_heads: int = 3
    # The JAX package's use_pallas_attention switch is not copied: its
    # default (True) is the port's only route — the hand-written CUDA flash
    # kernels from 128 tokens up (ops/attention.py:dispatch_attention).
    # "cls" = prepend a class token (standard ViT head). "mean" = no class
    # token, mean-pool the tokens (the long-context mode).
    pool: str = "cls"                     # cls | mean
    # Recompute each transformer block's activations in the backward pass
    # instead of storing them (torch.utils.checkpoint around the block):
    # ~1 extra forward of FLOPs for activation memory O(1) in depth.
    remat: bool = False
    # Sliding-window (local) attention width: None = full attention. Band
    # |row - col| < attn_window, composed with attn_causal.
    attn_window: Optional[int] = None
    # Causal (autoregressive) attention mask for the transformer blocks.
    attn_causal: bool = False
    # Sequence-parallel attention when ParallelConfig.seq_axis > 1: "ring"
    # (K/V shards walk the ring, parallel/ring_attention.py) or "ulysses"
    # (a tokens<->heads all-to-all around full-sequence attention,
    # parallel/ulysses.py; needs vit_heads % seq_axis == 0).
    sp_mode: str = "ring"                 # ring | ulysses
    # Mixture-of-Experts (model name "vit_moe"): every block's MLP becomes
    # a routed expert bank (ops/moe.py) — moe_top_k=1 Switch routing,
    # 2 GShard — with the experts split over the ``model`` ranks (expert
    # parallelism) and the routing global over the data ranks.
    moe_experts: int = 0                  # 0 = dense MLP
    # MoE dispatch/combine formulation (ops/moe.py): "einsum" ([T,E,C]
    # one-hot contractions) or "scatter" ((expert, slot)-indexed
    # scatter/gather, O(T·D) instead of the einsum pair's O(T²·f·D)).
    # Identical semantics; outputs close, not bit-identical.
    moe_dispatch: str = "einsum"
    moe_top_k: int = 1                    # 1 = Switch, 2 = GShard routing
    moe_capacity_factor: float = 1.25
    moe_aux_coef: float = 0.01            # load-balance loss weight
    # Microbatches per step under pipeline parallelism (0 = one per
    # stage, M = P). The bubble fraction is (M+P-1)/M: at the M=P default
    # every stage idles about half the ticks; M = 4P costs 1/4 the bubble
    # for microbatches 1/4 the size. The global batch must be divisible by
    # data ranks * M.
    pipe_microbatches: int = 0
    # Pipeline schedule (parallel/pipeline.py): "1f1b" (default: bubbles
    # skipped, recompute backward: 3F+1B, activation memory O(P
    # microbatches)), "1f1b_ring" (the re-forward keeps its autograd graph
    # for the backward: 2F+1B, 2P live graphs) or "gpipe" (the stage runs
    # on every tick, autograd through the tick loop; kept for comparison).
    pipe_schedule: str = "1f1b"


@dataclasses.dataclass
class OptimConfig:
    """Optimizer/schedule. Reference: ``cifar10cnn.py:21-23,159-164``."""

    learning_rate: float = 0.1            # cifar10cnn.py:21
    lr_decay: float = 0.9                 # cifar10cnn.py:22
    decay_every: int = 250                # NUM_GENS_TO_WAIT (cifar10cnn.py:23)
    staircase: bool = True                # cifar10cnn.py:161
    # Faithful mode: the reference's decay is keyed on a variable that is
    # never incremented (cifar10cnn.py:216), so the effective LR is a
    # constant 0.1. dead_lr_decay=True reproduces that.
    dead_lr_decay: bool = True
    momentum: float = 0.0                 # reference uses plain SGD
    weight_decay: float = 0.0
    schedule: str = "exponential"         # exponential | cosine | constant
    warmup_steps: int = 0
    cosine_decay_steps: int = 0
    # "sgd" (+ optional momentum) is the reference's; "adamw" (decoupled
    # weight decay, bias-corrected moments) the transformer standard;
    # "lars"/"lamb" add the per-layer trust ratio for large global
    # batches (You et al. 2017/2019); "adafactor" (Shazeer & Stern 2018)
    # factors the second moment into row/column statistics.
    optimizer: str = "sgd"        # sgd | adamw | lars | lamb | adafactor
    # LARS trust coefficient (eta in the paper) and norm-guard epsilon.
    lars_trust_coef: float = 0.001
    lars_eps: float = 1e-9
    # Label smoothing ε for the CE loss (0 = reference parity).
    label_smoothing: float = 0.0
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    # Global-norm gradient clipping (None = off); the norm stays on the
    # device.
    grad_clip_norm: Optional[float] = None
    # Async-PS staleness emulation (cifar10cnn.py:162: the reference's
    # workers take gradients at parameters up to W-1 updates old). S >= 2
    # takes the gradients at a round-robin snapshot S-1 updates old and
    # applies them to the live parameters, deterministically; the S
    # snapshots live in the optimizer state. 0/1 = synchronous.
    async_staleness: int = 0
    # Eval-time parameter EMA (0 disables); no reference counterpart.
    ema_decay: float = 0.0
    # Fused single-pass SGD update (ops/optimizer.py): weight decay +
    # momentum + LR in ONE pass over the param bytes — a hand-written
    # CUDA kernel on the card. False keeps the per-transform chain.
    fused_optimizer: bool = True
    # Gradient accumulation: each batch is split into this many
    # microbatches, their gradients averaged, and ONE update applied.
    grad_accum: int = 1
    # Cross-replica weight-update sharding (parallel/zero.py): "zero1"
    # allocates the optimizer moments (and the EMA) 1/N per data rank,
    # reduce-scatters the gradients, updates each rank's shard and
    # all-gathers the new parameters. "none" | "zero1"; excludes
    # ParallelConfig.fsdp and async_staleness >= 2.
    optimizer_sharding: str = "none"


@dataclasses.dataclass
class ParallelConfig:
    """Process group and mesh. Replaces the PS cluster
    (``cifar10cnn.py:184-196``), as the JAX package's ``ParallelConfig``
    does, trimmed to what the port's ``torch.distributed`` layer reads.

    The world is ``data x model x seq x pipe`` ranks, one process each
    (one GPU each on NCCL): the batch is split over ``data``, the
    Megatron-paired layers' weights over ``model`` (tensor parallelism),
    the ViT's tokens or the CNN's image rows over ``seq`` (ring or Ulysses
    attention; the spatial split), the ViT's blocks over ``pipe``
    (pipeline stages), and the gradients are summed over the ranks that
    hold the same weights — the all-reduce that stands in for the JAX
    package's ``psum``.
    """

    model_axis: int = 1                   # tensor-parallel degree
    seq_axis: int = 1                     # sequence/context-parallel degree
    pipe_axis: int = 1                    # pipeline-parallel degree (stages)
    # Bootstrap (replaces ClusterSpec/Server, cifar10cnn.py:188-189): the
    # first --worker_hosts entry is the rendezvous address, as task 0 is
    # the TF chief.
    coordinator_address: Optional[str] = None
    num_processes: int = 1
    process_id: int = 0
    # The --worker_hosts entries themselves, one a process: a rank's card
    # is its index among the entries of its own host
    # (utils/platform.py:rank_device). Empty = every rank on one host.
    worker_hosts: Tuple[str, ...] = ()
    # One rendezvous attempt's timeout, and how many attempts (bounded
    # exponential backoff) before a slow-to-start rank 0 is a failure.
    coordinator_timeout_s: float = 60.0
    coordinator_retries: int = 3
    # The cluster layer (parallel/cluster.py), the JAX package's fields
    # and defaults. cluster_dir arms it: a shared directory holding every
    # process's heartbeat file and the chief's restart decisions. None =
    # off.
    cluster_dir: Optional[str] = None
    # Background beat cadence: beats publish from a daemon thread, so a
    # process that is compiling, capturing or blocked still looks alive.
    heartbeat_interval_s: float = 0.5
    # Dispatch-seam overrun after which the watchdog classifies peers
    # (straggler telemetry for a peer beating but behind).
    straggler_after_s: float = 2.0
    # A peer whose newest beat is older than this is declared lost: the
    # seam raises PeerLostError instead of blocking in a collective.
    peer_dead_after_s: float = 10.0
    # Armed-seam duration after which the watchdog presumes the main
    # thread wedged inside a collective and ends THIS process (os._exit)
    # after logging.
    collective_timeout_s: float = 120.0
    # Floor of a coordinated elastic shrink: below it the chief halts.
    min_hosts: int = 1
    # Elastic scale-up: a host a restart decision excluded announces
    # itself with a `rejoin`-phase beat instead of fencing, and the chief
    # records an expand decision growing the world to the live hosts.
    elastic_expand: bool = False
    # Peer-redundant shard replicas (ckpt/peerstore.py): at every
    # committed checkpoint each host also pushes its shard payload to its
    # ring successor's replica store under <cluster_dir>/replicas, so an
    # elastic restart can rebuild a lost host's state from a peer with no
    # checkpoint read. Needs cluster_dir; a 1-process world is a legal
    # no-op. Off: every restore reads disk.
    peer_redundancy: bool = False
    # Committed replica steps kept per owner before the oldest is pruned.
    replica_keep: int = 2
    # Coordination transport (parallel/net.py): "file" is the shared
    # directory above; "net" carries the same store and coordinator over
    # a stdlib-HTTP service that process 0 hosts over cluster_dir, every
    # request bounded, retried and its failures classified, so a dead or
    # partitioned coordinator becomes the ordinary peer_lost / eviction
    # paths instead of a hang.
    cluster_transport: str = "file"
    # Per-request socket timeout of the net transport (the lockstep
    # simulations run 0.5 s).
    net_timeout_s: float = 5.0
    # Extra attempts of a net-transport operation (bounded backoff
    # between them) before its failure surfaces.
    net_retries: int = 2
    # Simulation only: the dispatch seam waits for every live peer's beat
    # to reach its step (a software barrier over the beat store), and no
    # process group is opened: each process is a world of its own, as in
    # the JAX package's CPU simulation. Real runs leave it off.
    cluster_lockstep: bool = False
    # torch.distributed backend, chosen by the caller and never switched
    # after a failure: "nccl" when each rank has its own card, "gloo" on
    # the CPU or for several ranks sharing one card (NCCL refuses two
    # ranks on one device). None = nccl on cuda, gloo on cpu.
    dist_backend: Optional[str] = None
    # ZeRO-3 / FSDP (parallel/zero.py): parameters AND optimizer moments
    # stored 1/N per data rank, gathered before the forward; gradients
    # reduce-scattered.
    fsdp: bool = False
    # Override of the model's partition-rule table (parallel/shardings.py
    # grammar), strict matching (an unmatched leaf raises), and the
    # which-rule-matched-which-param report printed at Trainer build.
    partition_rules: Optional[str] = None
    partition_rules_strict: bool = False
    partition_report: bool = False


@dataclasses.dataclass
class ServeConfig:
    """Serving (``--mode serve``, the ``serve/`` package): the JAX
    package's ``ServeConfig`` names and defaults, without its
    quantization knobs and the ``slo_ms`` its fleet autoscaler reads
    (neither is ported)."""

    # Batch sizes served. Each is one CUDA graph, captured at warm-up; a
    # batch of requests pads up to the smallest bucket that fits.
    buckets: Tuple[int, ...] = (1, 8, 32, 128)
    # Admission control: submits beyond this queue depth are shed at once
    # (HTTP 503) instead of growing an unbounded backlog.
    max_queue_depth: int = 256
    # Most extra latency the batcher adds to the request at the head of a
    # batch while it waits to fill it.
    batch_window_ms: float = 2.0
    # Per-request deadline: requests still queued past it are shed at
    # dispatch. None = no deadline.
    deadline_ms: Optional[float] = None
    # HTTP port (0 = ephemeral; the chosen port is printed at start).
    port: int = 8000
    # Explicit artifact to serve. None = <log_dir>/model.pt2 when present,
    # else the latest checkpoint restored and served live.
    artifact_path: Optional[str] = None
    # Cadence of the `serve` JSONL window records.
    metrics_every_s: float = 5.0
    # Graceful-shutdown budget: on SIGTERM/SIGINT stop accepting, let
    # queued batches finish for at most this long, shed the rest, flush
    # the metrics, exit 0.
    drain_deadline_s: float = 5.0
    # Head-sampling rate of request tracing (`rspan` records; utils/
    # reqtrace.py). Shed requests are always captured. 0 = off.
    trace_sample_rate: float = 0.0
    # Exact-match response cache entries (serve/cache.py), flushed when
    # the serving version changes. 0 = off.
    cache_size: int = 0


@dataclasses.dataclass
class TrainConfig:
    """Training driver. Reference: ``cifar10cnn.py:11-14,219-242``."""

    batch_size: int = 128                 # per-step GLOBAL batch (cifar10cnn.py:13)
    total_steps: int = 20000              # GENERATIONS (cifar10cnn.py:14)
    output_every: int = 200               # OUTPUT_EVERY (cifar10cnn.py:11)
    eval_every: int = 500                 # EVAL_EVERY (cifar10cnn.py:12)
    # Faithful mode evaluates one shuffled test batch (cifar10cnn.py:202,238);
    # fixed mode sweeps the full test set.
    eval_full_test_set: bool = False
    log_dir: str = "/tmp/train_logs"      # checkpoint dir (cifar10cnn.py:269-272)
    checkpoint_every: int = 1000          # steps; MTS default was 600s wall-clock
    # Wall-clock checkpoint cadence IN ADDITION to the step cadence (the
    # MTS behavior, save_checkpoint_secs=600 at cifar10cnn.py:222). None
    # disables the clock trigger. Several ranks agree on it at the
    # preemption-sync exchange (train/loop.py).
    checkpoint_every_secs: Optional[float] = None
    keep_checkpoints: int = 3
    # Encode and write checkpoints on a background writer thread; the
    # device->host copy stays synchronous at the save (K1/K2 update the
    # parameters in place at the next dispatch).
    async_checkpoint: bool = False
    # Checkpoint codec: "msgpack" (one file, the chief writes the whole
    # state) or "sharded" (ckpt/sharded.py: every rank writes its own
    # shards, no gather; restore detects either).
    ckpt_format: str = "msgpack"
    # Thread pool of the sharded codec's per-shard file IO.
    shard_io_threads: int = 4
    # Wall-clock budget of the restore walk's newest-to-oldest fallback
    # (ckpt/checkpoint.py): past it the walk raises a classified
    # ckpt_restore error instead of scanning on. 0 = no limit.
    restore_deadline_s: float = 0.0
    # Several ranks agree on the preemption flag (and a due wall-clock
    # save) every this many steps, in one exchange over the process
    # group: no rank may leave the step loop alone, or its peers hang in
    # the next collective. One process reacts to the signal at once.
    preempt_sync_every: int = 10
    # Failure detection: at each metrics boundary a non-finite train loss
    # triggers on_nonfinite, and no save may persist a non-finite state.
    # Off by default: faithful runs NaN by the reference's design (LR 0.1
    # on raw 0-255 pixels) and must keep running as the reference does.
    check_numerics: bool = False
    # "halt" raises without checkpointing the poisoned state; "skip"
    # restores the copy of the state kept at the last finite boundary
    # (every update since is discarded, the step counter moves on) and
    # keeps training; "rollback" logs the fault and raises for the run
    # supervisor (train/supervisor.py), which restores the newest
    # verifiable checkpoint, rewinds the data state and retries with
    # backoff. skip and rollback share the recovery_retries budget and
    # degrade to halt when it is spent.
    on_nonfinite: str = "halt"            # halt | skip | rollback
    # Shared recovery budget: skip events inside one fit() AND supervisor
    # restart attempts across a run.
    recovery_retries: int = 3
    # Supervisor restart backoff: base * 2^(attempt-1), capped.
    recovery_backoff_s: float = 0.5
    recovery_backoff_max_s: float = 30.0
    # Progress-based budget reset: when > 0 and the newest checkpoint has
    # advanced this many steps since the budget was last charged, the
    # supervisor's attempt counter resets before the next failure is
    # judged. 0 keeps the lifetime budget.
    retry_budget_window: int = 0
    # LR multiplier applied at each supervisor rollback of a non-finite
    # failure (1.0 keeps the LR).
    rollback_lr_scale: float = 1.0
    # Deterministic fault injection (utils/faults.py): "kind@trigger,..."
    # with the step-seam kinds nan | ckpt_corrupt | sigterm | data_stall,
    # the cluster kinds (need cluster_dir), and the recovery-phase
    # triggers @restore | @adopt | @decide (need supervise). Each fires
    # once. None disables.
    fault_spec: Optional[str] = None
    # Wrap fit() in the run supervisor (train/supervisor.py): classified
    # recoverable failures restore the last verifiable checkpoint and
    # resume instead of ending the run.
    supervise: bool = False
    metrics_jsonl: Optional[str] = None   # structured metrics sink
    # Run-health telemetry (utils/telemetry.py): host-loop spans, goodput
    # fractions and device-memory snapshots in the metrics JSONL at the
    # existing boundaries, no extra device read. Off: the spans reduce to
    # a shared no-op.
    telemetry: bool = False
    # Chrome trace-event file of the host-loop spans (needs telemetry);
    # ranks other than 0 write <path>.task<N>.
    trace_events_path: Optional[str] = None
    # Grad norm, param norm and update ratio computed inside the step
    # (parallel/step.py), read with the boundary's loss in its one read.
    health_metrics: bool = False
    # TensorBoard event files (the chief only; needs tensorboardX).
    tensorboard_dir: Optional[str] = None
    seed: int = 0
    # Where the port runs: "cuda" (the default; raises when no card is
    # present) or "cpu", which the caller must ask for.
    device: str = "cuda"
    # Steps per dispatch. >1 switches the Trainer to the chunked path
    # (parallel/step.py:make_train_chunk*): K steps per call, replayed as
    # one CUDA graph on the card, the host shipping raw uint8 chunks,
    # index chunks, or nothing at all (resident_data with the device index
    # stream), and the decode running on the device.
    # output/eval/checkpoint cadences and the steps to run must be
    # multiples of K so every observable boundary falls on a dispatch
    # edge. One process only: capturing NCCL collectives is not ported.
    steps_per_dispatch: int = 1
    # With steps_per_dispatch > 1, keep the whole uint8 split resident on
    # the device and gather each chunk's rows there (indices from the
    # device stream, or shipped by the host with device_index_stream off).
    # Falls back to host-fed raw chunks when the split exceeds
    # resident_data_max_bytes.
    resident_data: bool = True
    resident_data_max_bytes: int = 2_000_000_000

    # Per-card peak TFLOP/s of the path's dtype; with it the `train`
    # records carry `mfu` beside `tflops_per_sec_per_chip`.
    peak_tflops: Optional[float] = None
    # Device-time attribution window "N:K" (utils/devprof.py): a
    # torch.profiler capture from global step N for K steps, parsed into
    # `devtime` records, written under profile_dir (default
    # <log_dir>/devprof).
    profile_at_steps: Optional[str] = None
    profile_dir: Optional[str] = None

    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)
    parallel: ParallelConfig = dataclasses.field(
        default_factory=ParallelConfig)
    serve: ServeConfig = dataclasses.field(default_factory=ServeConfig)


def reference_config(**overrides) -> TrainConfig:
    """The exact reference hyperparameters (faithful quirks on)."""
    cfg = TrainConfig()
    for k, v in overrides.items():
        if not hasattr(cfg, k):
            raise AttributeError(f"unknown TrainConfig field {k!r}")
        setattr(cfg, k, v)
    return cfg


def fixed_config(**overrides) -> TrainConfig:
    """Reference hyperparameters with the quirks fixed (sane defaults)."""
    cfg = reference_config(**overrides)
    cfg.model.logit_relu = False
    cfg.optim.dead_lr_decay = False
    cfg.data.random_crop = True
    cfg.data.random_flip = True
    cfg.data.normalize = "standardize"
    cfg.eval_full_test_set = True
    return cfg
