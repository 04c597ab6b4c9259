#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

Run from the root of a checkout:  ``python3 chip_smoke.py``

It needs one CUDA card, ``nvcc`` (PATH or ``$CUDA_HOME/bin``) and the
``dml_cnn_cifar10_tpu_torch`` package beside this file; without them it
exits non-zero and prints no result. It imports nothing of JAX. Phases, in
order; any failure ends the run with a non-zero exit:

1. device   ``torch.cuda`` must see a card; print ``nvidia-smi``'s name and
            power limit.
2. build    compile every ``csrc/*.cu`` afresh with ``nvcc`` (one process
            per source, all started together: ``sgd_update.cu`` and
            ``flash_attention.cu``); print ptxas's report, and for each of
            the 36 flash instances (K3, K4, K5: dtype x head dim; K6, K7
            also x P/dS terms) its registers, stack, spills and dynamic
            shared memory: the head-dim-64 ones must not spill.
3. parity   K1 ``sgd_update_plain`` and K2 ``sgd_update_momentum`` (one
            body; every f32 leaf of a step in one launch, ``MAX_LEAVES`` a
            launch) against their plain PyTorch version, all cases in one
            call for each (mu, wd) in {0, 0.9} x {0, 5e-4}: the CNN's 10
            leaf shapes, a one-element and an empty leaf, ragged and
            misaligned views, enough leaves for a second launch, and a
            bf16 leaf (the plain version). Both bit-equal; the launches
            counted.
4. timing   each kernel's optimizer step over the CNN's 10 leaves (CUDA
            events, and the kernels' own device time from torch.profiler),
            beside its plain version, ``torch.optim.SGD(fused=True).step()``
            on the same leaves (a yardstick the port never calls; by
            events and by the device time of its kernels), and the
            bound: the bytes the update must move over the card's memory
            rate, or its f32 operations over the card's f32 rate.
5. train    the main path, ``cli.main.main``: the reference CNN at full
            width (batch 128, 24x24x3 crop, 1,068,298 params) for 500
            steps on 50,000 synthetic records. Loss finite, K1 launched
            once per step, final test accuracy far above chance.
6. resume   the same log dir to step 600: the global step continues at 500.
7. eval     ``--mode eval`` restores step 600 and prints the accuracy of the
            in-training eval at step 600.
8. momentum 50 steps with ``--momentum 0.9 --weight_decay 5e-4``: K2
            launched once per step, K1 never.
9. profile  where a training step's time goes: the trainer's own rate, a
            step on a batch already on the card, the host's batch
            assembly, and the device's busy time by kernel.
9b. chunked  the main path with ``--steps_per_dispatch 10``: the train
            split resident on the card, its rows from the device index
            stream, each chunk of 10 steps one CUDA graph replay. 500
            steps: finite losses, test accuracy above 50%, K1 once a step
            (each replay adds the launches its capture recorded; the
            warm-up's 10 are kept apart), 50 replays, no index-stream
            miss; resume to 600 continues at 500; the resident full-split
            eval counts what the host-fed sweep counts on the same state;
            50 momentum steps launch K2 once a step; one graphed chunk
            against the same chunk body run eagerly from one state, cuDNN
            deterministic (loss 1e-6 relative, params 1e-5; printed
            without it too); a small ViT (145 tokens, the flash kernels)
            chunked the same way: a replay launches what the eager body
            launches, losses within 1e-5 relative; then a profile of 20
            replays (ms/step, device busy share, no host-to-device copy)
            beside phase 9's eager numbers, written to
            ``OUT/chunk.json``.
10. flash parity  K3 ``flash_fwd``, K4 ``flash_fwd_lse``, K6
            ``flash_bwd_dq`` and K7 ``flash_bwd_dkv`` against their plain
            versions on the card, in the working dtype: the ViT's
            [2, 257, 3, 64] in f32, bf16 and as strided views of one fused
            qkv; ragged S=300; causal; window 100; segment ids; kv_start
            (K4, K6, K7); dead rows (exactly 0); head dims 32 and 128;
            and the main paths' own shapes, [128, 257, 3, 64] f32 and
            [2, 8100, 3, 64] bf16, as views of a fused qkv, and a Ulysses
            rank's [2, 8100, 1, 64] bf16. Tolerances: the JAX package's pins in
            f32 (out 5e-6, lse 1e-5, grads 5e-5); in bf16 lse keeps
            1e-5 and out and grads 1e-2 x max|plain| (one bf16 ulp; at most
            0.05). A CUDA input the kernels cannot take must raise.
11. flash timing  each flash kernel at [128, 257, 3, 64] f32,
            [2, 8100, 3, 64] bf16 and a Ulysses rank's [2, 8100, 1, 64]
            bf16: CUDA events, device time, the plain
            version, ``F.scaled_dot_product_attention`` (a yardstick the
            port never calls; by CUDA events and by device time) and the
            bound, and the tensor-core bound of the split products each
            kernel issues.
12. vit train  the main path with ``--model vit_tiny``: ViT-Ti at full
            width (dim 192, depth 12, 3 heads, 64x64 crop = 257 tokens,
            5,399,626 f32 params), AdamW + cosine, batch 128, 200 steps on
            10,000 synthetic records. Loss finite and falling; K4 = K6 =
            K7 = 200 x 12 launches, K3 = 12 per forward-only batch, K1 =
            K2 = 0.
13. vit resume  to step 300 (the AdamW moments come back from the
            checkpoint), then ``--mode eval`` prints the same accuracy.
14. long context  the 8,100-token recipe (368/360 images, mean pool,
            remat, bf16, batch 2) for 10 steps: finite loss, K4 = 240
            (remat recomputes each block), K6 = K7 = 120, device memory
            below one dense score matrix.
15. vit profile  a main-path and a long-context step's device time split
            between the flash kernels, the GEMMs and the rest.
16. stats parity  K5 ``flash_fwd_stats`` against its plain version on the
            card: the SP main path's [2, 4050, 3, 64] bf16 block (views of
            a fused qkv) and [128, 128, 3, 64] f32, ragged, causal, a ring
            step's neighbour windows at kv_start = -S / +S, segment-id
            pairs, dead rows (exactly m = -1e30, l = 0, acc = 0), head dims
            32 and 128. f32 acc / l 5e-6; m and l 1e-5 relative; bf16
            acc / l 1e-2 x max|plain|. A CUDA input K5 cannot take raises.
            Then K6/K7 as the backward ring calls them, bf16 q/k/v of that
            block -> f32 gradients, on the diagonal block and at kv_start =
            -S / +S with window 512, against the plain version: 5e-5.
17. stats timing  K5 at [2, 4050, 3, 64] bf16: CUDA events, device time,
            the plain version, ``F.scaled_dot_product_attention`` forward
            (by CUDA events and by device time), the bound, the
            tensor-core bound of the products K5 issues and its TFLOP/s;
            the ring's K6/K7 at that block on a card alone, with their
            bounds, TFLOP/s and SDPA's backward on the block (contiguous
            [B, H, S, D] inputs, warmed up, read A/B/B/A against the pair
            by CUDA events and by device time; the kernel it picked is
            printed).
The distributed phases (``dist_phases``) run each rank as a process of its
own (this script with ``--rank R --job FILE``, after the build): over NCCL
with a card each when there are two cards, else both on this card over
gloo. Each rank starts with every launch count at 0 and writes its counts
(and, after a training run, a digest of its parameters) to ``OUT/ranks/``.
18. ring op  the 2-rank ring attention against the one-rank flash
            attention of the full sequence, out and gradients: f32
            [2, 2048, 3, 64] full, causal and window 512 (out 2e-5, grads
            5e-5), and bf16 [2, 8100, 3, 64] (1e-2 x max|reference|).
19. sp train  the SP main path, ``cli.main.main --seq_axis 2`` on each
            rank: ViT-Ti at full width on the 8,100-token recipe of phase
            14, 4,050 tokens a rank, 10 steps. Per rank K5 = 10 x 48 + 24
            per forward-only batch, K6 = K7 = 10 x 24, K3 = K4 = K1 = K2 =
            0; equal parameter digests; every logged loss (steps 5 and 10)
            within 1e-3 of phase 14's one-rank run (same seed, batches and
            weights). Then a resume to step 15 and ``--mode eval`` over the
            two ranks.
20. dp cnn  the CNN data-parallel over 2 ranks x 64 images (global batch
            128), 50 steps: K1 = 50 per rank (one a step), equal
            digests.
21. sp profile  an SP step's time per rank (host clock, batch on the card)
            and its device timeline: the union of its compute kernels'
            intervals over all streams (busy time and share of the step),
            the hops and all-reduces (NCCL kernels, or gloo's host copies)
            apart, the time the two overlap, and K5/K6/K7.

Then the serving path, on phase 6's CNN checkpoint (step 600) and phase
13's ViT-Ti checkpoint (step 300):
22. export  ``--mode export`` for each: the artifact (``<log_dir>/
            model.pt2``) holds 12 flash operator nodes for the ViT-Ti and
            none for the CNN, loads on the card, and serves b = 1, 8, 32
            and 128 within 1e-5 of the live weights' eager forward.
23. serve k3  K3 through ``dml_torch::flash_attention_out`` at the four
            serving shapes [b, 257, 3, 64] f32 (views of a fused qkv)
            against its plain version (5e-6), timed at b = 1 and 128:
            CUDA events, device time, the plain version, SDPA and the
            bound.
24. graphs  each engine (the artifact's, and the live weights') captures
            one CUDA graph a bucket at warm-up; each replay
            against the eager forward (1e-5 of the largest logit), 12 K3
            a ViT-Ti replay, at most one copy in (the uint8 batch) and
            one out (the logits) a served batch, so no weight copy (10
            traced batches; a trace drops some memcpy events); replay
            and eager ms a bucket; where a served batch's time goes at
            b = 1 and 128.
25. serve http  ``--mode serve`` (``main_serve`` with the CLI's config)
            in a thread, driven by the port's loadgen in a process of its
            own: closed loops at 1, 32 and 128 clients, once each, every
            answer's class the direct forward's (near-ties left out and
            counted), no error but 503, and the served ViT-Ti path
            launched 12 K3 a replay and no other kernel; an open loop past
            capacity with a 2-deep queue and a 0.5 ms deadline sheds
            (each closed loop 1 s); the
            CNN's step-500 weights served live with 32 clients while step
            600 is hot-swapped in: the tags flip, every answer within 1e-4
            of its version's forward, one ``swap`` record. Numbers in
            ``OUT/serve.json`` and the loadgen reports.

Then the slice of Ulysses, telemetry and the optimizer surface:
26. ulysses op  3 rank processes (ViT-Ti's 3 heads, one a rank; gloo on
            one card, NCCL given three): Ulysses attention at [2, 8100, 3,
            64] bf16 (2,700 tokens a rank) and f32 full and causal cases
            against the one-rank flash attention of the full sequence, out
            and gradients, with phase 18's pins; the long-context call
            launches one K4, one K6 and one K7 a rank, at [2, 8100, 1, 64].
27. ulysses train  ``cli.main.main --seq_axis 3 --sp_mode ulysses`` on the
            long-context recipe of phase 14, 10 steps: per rank K4 = 10 x
            24, K6 = K7 = 10 x 12, K3 = 12 per forward-only batch, K5 = K1
            = K2 = 0; equal parameter digests; every logged loss within
            1e-3 of phase 14's one-rank run. Then a resume to step 15,
            ``--mode eval`` (16 batches of 32 on each rank) and rank 0's
            step time and device timeline.
28. telemetry  the ``train`` records of the CNN (eager and chunked),
            ViT-Ti, long-context, ring SP and Ulysses runs carry
            ``device_step_ms``, ``drain_wait_ms``,
            ``tflops_per_sec_per_chip`` and ``mfu`` (``--peak_tflops`` 67
            on the f32 paths, 989 on the bf16 ones); each path's TFLOP/s
            and MFU printed with the card. Then ``--profile_at_steps
            30:10`` on 60 CNN steps, eager and chunked, with SGD, AdamW
            and LARS: ``devtime`` records; the eager SGD window's
            ``optimizer_ms`` (the ``optimizer`` range: the LR schedule,
            K1, the step counter) within 2x of one update's device time
            and its compute per step within 25% of phase 9's device time;
            each chunked window's (a replay has no range: the replayed
            kernels that the graph's profiled warm-up ran inside it) above
            0 and within 2x of its optimizer's eager window.
29. optimizer  100 CNN steps each with ``--grad_clip_norm 1 --momentum
            0.9`` (K2 once a step), ``--grad_accum 2`` (K1 once a step),
            ``--async_staleness 2`` (K1 once a step) and ``--optimizer
            lars|lamb|adafactor`` (no K1/K2), cuDNN deterministic:
            losses finite and falling.
            ``--async_staleness 2 --steps_per_dispatch 10``, 100 steps,
            then one graphed chunk against the eager body from its state,
            bit for bit with cuDNN deterministic; eager 50 + 50 steps with
            a resume against 100 steps: the same losses and step-100
            checkpoint, bit for bit. Numbers in ``OUT/slice10.json``.

Then chunked dispatch over several ranks:
30. dp chunk gloo  the DP CNN on 2 rank processes over gloo on this card,
            2 x 64 images, ``--steps_per_dispatch 10``, 50 steps: each
            chunk runs its eager body (gloo stages each collective through
            host memory, which no CUDA graph can hold), as the ranks'
            ``[dist]`` lines say; K1 once a step per rank, equal parameter
            digests, every logged loss (each chunk's) within 1e-3
            relative of a one-rank chunked run at batch 128 (same seed,
            rows, augmentation draws and steps) that sums the ranks'
            halves as they do (``--grad_accum 2``), cuDNN deterministic;
            the run summing 128 at once printed beside it. Numbers in
            ``OUT/slice11.json``.
31. chunk nccl  (``--dist`` only) each chunk one CUDA graph replay with
            its NCCL collectives captured: the DP CNN on 2 and 4 ranks, K
            = 10, 500 steps (K1 = 500 per rank in 50 replays, the
            warm-up's 10 apart; equal digests; no index-stream miss); ring
            SP at seq 2 on phase 19's recipe and Ulysses at seq 3 on
            phase 27's, K = 5, 10 steps (per-rank K3-K7 as in phases 19
            and 27). On every rank one graphed chunk against the eager
            body from the trained state, cuDNN deterministic (the replay
            launches what the body launches; DP loss 1e-6 relative and
            params 1e-5, as phase 9b; SP loss 1e-5 relative), then replays
            timed and traced: ms/step, the device's busy share (the union
            of its kernels over every stream), the NCCL kernels' time, no
            host-to-device copy. Each path's ms/step is printed beside its
            per-step NCCL run of the same call.

Then run safety, on the CNN main path at full width (``--fidelity
fixed``: random crop and flip; K1 once a step on every run, K2 under
momentum):
32. run safety  200 resident chunked steps (K = 10) with ``--random_brightness
            63 --random_contrast 0.8 --telemetry --trace_events_path
            --health_metrics``: finite losses, test accuracy at least 20%
            (chance 10%), ``span``/``goodput``/``hbm`` records (goodput
            summing to 1 within 1e-6; ``0 < peak_bytes <= bytes_limit``),
            finite health with the update ratio in (0, 1), a Chrome trace
            that loads, the stream strict under
            ``tools/check_jsonl_schema.py``, and one graphed chunk against
            its eager body bit for bit (loss, parameters, health; cuDNN
            deterministic); loop and replay ms/step beside the same run
            with these flags off. ``--check_numerics --fault_spec
            nan@105`` chunked: ``skip`` recovers at 150 and runs to 200
            with every checkpoint on disk finite, ``halt`` and
            ``rollback`` raise at 150 leaving checkpoints 50 and 100; an
            eager ``skip`` under ``--momentum 0.9`` restores K2's momenta.
            ``--fault_spec sigterm@150`` eager and chunked: stopped at the
            next dispatch with its checkpoint and a ``preempt`` record,
            then resumed to 300 bit-equal to an uninterrupted run.
            ``--async_checkpoint`` files byte-identical to sync ones (and
            the eager loop's ms/step across the saves, sync against
            async, once each); ``--checkpoint_every_secs 0.1`` saves on
            the clock at least as often as the run's time allows;
            ``ckpt_corrupt@110`` then a crash: the restore falls back to
            step 50. ``--tensorboard_dir`` writes event files, or, where
            ``tensorboardX`` is missing, raises ``ImportError`` before any
            step. Then 2 rank processes over gloo on this card: SIGTERM
            to rank 1 alone stops both at one step with one checkpoint,
            clock saves at the same steps on both, ``skip`` recovers on
            both. Numbers in ``OUT/slice12.json``.

Then sharded state (``parallel/zero.py``), the CNN main path at full
width:
33. sharded  K1 on rank 0's zero1 shard buffers at 2 ranks (one launch
            over the split leaves' contiguous views and the whole leaf)
            bit-equal to its plain version on the same shards, timed
            beside it, ``torch.optim.SGD(fused=True)`` and its bound; then
            2 rank processes over gloo on this card, cuDNN deterministic,
            plain SGD, 50 eager steps each: replicated, zero1 and fsdp (K1
            once a step per rank; zero1 within 1e-6 of replicated, fsdp
            within 2e-5 relative + 2e-6, the CPU pins; fsdp's params
            halved on each rank), zero1 with ``--ckpt_format sharded`` to
            25 and a resume under ``--fsdp`` to 50 bit-equal to the
            straight zero1 run, its ``shard_io`` stream strict. Under
            ``--dist`` over NCCL instead: K2 on fsdp shards; the CNN with
            momentum 0.9, 100 steps, replicated / zero1 / fsdp eager on 2
            and 4 ranks (losses within 1e-3 relative, at 2 ranks the
            state within the pins; moments and fsdp's params sharded),
            then zero1 and fsdp chunked at K = 10 (each chunk one CUDA
            graph with its reduce-scatter and all-gather; K2 once a step
            per rank; one graphed chunk bit-equal to its eager body on
            every rank); ViT-Ti AdamW on 2 ranks, 20 steps each mode.
            Numbers in ``OUT/slice13.json`` (``slice13_nccl.json``).

Then tensor parallelism (``parallel/tp.py``, ``--model_axis``):
34. tensor parallel  K1 and K2 on the leaves model rank 0 of 2 updates
            (the Megatron slices at half width beside the replicated
            leaves) and on phase 33's shard buffers, bit-equal, timed by
            events and device time beside fused SGD; K3/K4/K6/K7 at a
            model rank's [32, 257, 1, 64] and [128, 257, 1, 64] f32 (one
            head of ViT-Ti's 3, views of its fused qkv) against their
            plain versions at the f32 pins, timed beside SDPA; then one
            spawn of 4 rank processes over gloo on this card, cuDNN
            deterministic: the CNN at model 2 (2 ranks) and data 2 x
            model 2 (4 ranks), batch 128, 50 steps each beside the
            replicated run at the same data ranks (one process; 2 DP
            ranks), and ViT-Ti at model 3 (3 ranks), batch 32, f32, 10
            steps beside one process. One SGD step of each within the CPU
            pins of its replicated step; every logged loss of the first
            10 steps within 1e-3 relative (the last printed); replicated
            leaves bit-equal over the ranks; K1 once a step (CNN) or
            K4/K6/K7 12 a step (ViT); a ``.sharded`` save at 25 of the
            4-rank CNN resumed to 50 bit-equal to the straight run.
            Under ``--dist`` over NCCL: the CNN at data 2 x model 2 on 4
            cards beside DP on 4 and on 2 (the same data ranks: its
            logged losses of the first 10 steps within 1e-3 relative),
            100 steps eager and chunked at K = 10 (one CUDA graph a
            chunk with its model-group all-reduces, one graphed chunk
            bit-equal to its eager body on every rank, replays timed and
            traced: busy share, NCCL ms), and ViT-Ti at
            model 3 on 3 cards, batch 128, 20 steps eager (beside one
            card) and chunked at K = 5. Numbers in ``OUT/slice14.json``
            (``slice14_nccl.json``).

Then the ResNet rungs (``models/resnet.py``):
35. resnet  ResNet-18 by the README recipe's flags (batch 1024, 24 px
            crop of 32, SGD momentum 0.9, weight decay 5e-4, cosine, lr
            0.4) on 10,000 generated CIFAR-layout records: 10 steps eager
            (K2 once a step), then 50 steps at ``--steps_per_dispatch
            10`` (one CUDA graph a chunk, the BN buffers updated in place
            inside it; K2 50 in 5 replays; the loss falls); one graphed
            chunk against the same chunk body run eagerly from the same
            state, cuDNN deterministic (phase 9b's gates on loss and
            params, the running stats too), and
            three replays timed and traced: ms/step, the device's busy
            share and its time by kernel group (convs, reductions,
            elementwise, the update, idle); a graph of the same chunk
            captured with cuDNN's default algorithms replayed in turns
            with the deterministic one (the trainer's mode), ms/step of
            each. ResNet-50 on imagenet_synth (256 stored, 224 crop, 1000
            classes), batch 128, lr 0.02, f32 and bf16: 6 steps eager and
            10 chunked at K = 5 (K2 3 a
            step: 161 leaves, 64 a launch; the chunked loss falls), an
            eval on the running stats, the chunked runs' replays traced
            like ResNet-18's, the f32 one's beside a default-algorithm
            graph as ResNet-18's; ``--mode export`` and the
            artifact against the live weights (running stats included) at
            b = 1 and 32 (1e-4 relative), a hot swap of params with their
            ``model_state`` (one without is refused), ``--mode serve``
            answering over HTTP and a 32-client closed loop; ``--remat``,
            ``--resnet_norm nf`` and ``--resnet_s2d`` 3 steps each with
            plain SGD (K1 3 a step), remat's peak memory below the f32
            run's. K2 and K1 on ResNet-18's 62 and ResNet-50's 161 leaves
            bit-equal to their plain version, timed beside fused SGD and
            the bound. Then cross-replica BN on 2 rank processes over
            gloo on this card (resident chunks at K = 2, global batch
            128, 20 steps, cuDNN deterministic): every logged loss within
            1e-3 relative of one rank at the global batch on the same
            rows, zero1's whole state equal to replicated bit for bit, K1
            once a step. Under ``--dist`` the same over NCCL on 2 cards,
            each chunk one CUDA graph with the BN all-reduces captured,
            and an eager run beside. Numbers in ``OUT/slice15.json``
            (``slice15_nccl.json``).

Then the MoE rung (``ops/moe.py``, ``--model vit_moe``):
36. moe     (a) the main path: phase 12's ViT-Ti recipe (257 tokens, batch
            128, f32, AdamW, cosine) as ``--model vit_moe --moe_experts 8
            --moe_dispatch scatter``, 100 steps: K4 = K6 = K7 = 12 a step,
            K3 12 a forward-only batch, K1 = K2 = 0; the ``train``
            records' ``moe_aux_loss`` finite, ``moe_dropped_frac`` in [0,
            1], 8 ``moe_expert_load`` values summing to 1 (1e-4); the last
            window's loss below the first; ms/step, img/s, TFLOP/s, MFU
            and peak memory printed. (e) ``--mode export`` of its step-100
            checkpoint, the artifact 0 apart from the live weights at b =
            1 and 32, ``--mode serve`` under 32 HTTP clients (qps, p50,
            p99). (b) the README recipe, ``--model vit_moe --moe_experts
            8`` at the defaults (37 tokens, einsum, SGD lr 0.1): 50 eager
            and 50 chunked steps at K = 10, finite losses, K1 once a step;
            one graphed chunk bit-equal to its eager body (loss, params,
            router stats; cuDNN deterministic); K1 and K2 on its leaves
            bit-equal to their plain version, timed beside fused SGD and
            the bound. (c) one layer at [32, 257, 192], 8 experts, top-1
            and top-2: einsum against scatter within 1e-5 of max|y|, the
            router stats equal, each form's forward + backward timed. (d)
            2 rank processes over gloo on this card (in a full run the
            first two of phase 34's spawn), cuDNN deterministic:
            the README EP recipe with momentum 0.9 at ``--model_axis 2``
            (half-head attention, 4 experts a rank; K2 on a rank's expert
            slices), 10 eager steps, and data 2 x 64 on the resident
            device stream (the same global rows as one process; global
            routing), 2 chunks of 10, each beside one process: step 1
            within the CPU pins, every logged loss within 1e-3, the
            dropped fractions printed beside each other. Under ``--dist
            --phase 36`` the same over NCCL, a card a rank (each chunk one
            CUDA graph), and data 2 x model 2 on 4 cards beside the 2 data
            ranks. Numbers in ``OUT/slice16.json``
            (``slice16_nccl.json``).

Then pipeline parallelism (``parallel/pipeline.py``, ``--pipe_axis``) and
the CNN's spatial split (``parallel/spatial.py``, ``--seq_axis``):
37. pipe    K3/K4/K6/K7 at a stage's microbatch [64, 257, 3, 64] f32
            (views of a fused qkv) against their plain versions at the f32
            pins, timed beside SDPA; K1 on stage 0's leaves of the README
            recipe at pipe 2 bit-equal, timed beside fused SGD. Then, in
            phase 34's spawn (4 rank processes over gloo on this card,
            cuDNN deterministic): (a) ViT-Ti at 257 tokens (batch 128,
            f32, AdamW) at ``--pipe_axis 2``, 1f1b, 5 eager steps: K4 = K6
            = K7 = 12 a step on each stage, K3 12 a step more on stage 0
            (its re-forwards); (b) the README recipe (37 tokens, SGD) at
            pipe 2 under 1f1b, 1f1b_ring and gpipe and 1f1b at
            ``--pipe_microbatches 4``, 5 steps each, K1 once a step; (c)
            the CNN at data 1 x seq 2, 10 eager steps, and at data 2 x seq
            2 (4 ranks) one chunk of K = 10 on the resident device
            stream, K1 once a step. Each beside the port's one-process run
            of the same batches: the last logged loss within 1e-4
            relative (pipeline) and 1e-5 (CNN); replicated leaves
            bit-equal over the ranks. Under ``--dist --phase 37``, a card
            a rank over NCCL in one spawn of 4: ViT-Ti at pipe 2 on 2
            cards, pipe 4 and data 2 x pipe 2 on 4, the CNN at data 2 x
            seq 2 on 4: eager ms/step, then a chunk of 10 as one CUDA
            graph replay with the stage hops (halo exchanges) captured,
            bit-equal to its eager body on every rank, replays timed and
            traced (ms/step, device busy share, NCCL ms). Numbers in
            ``OUT/slice17.json`` (``slice17_nccl.json``).

Then the run supervisor (``train/supervisor.py``) and the cluster layer
(``parallel/cluster.py``), on the CNN main path at full width (batch 128,
24 px, ``--fidelity fixed``, plain SGD at lr 0.1):
38. supervise  K1 and K2 on the CNN's leaves bit-equal to their plain
            version, timed beside fused SGD and the bound. (a) One
            process, ``fit_supervised`` on the CLI's config of ``--supervise
            true --check_numerics true --on_nonfinite rollback
            --rollback_lr_scale 0.5 --recovery_backoff_s 0.05
            --fault_spec nan@25,ckpt_corrupt@26,data_stall@45``, checkpoints
            every 10 steps, to step 60: eager, then chunked at
            ``--steps_per_dispatch 10`` (each attempt captures its own
            graph), then ``--momentum 0.9`` (lr 0.02, ``nan@25``; K2). Each
            run's fault/rollback/recovery/ckpt_fallback records are the JAX
            package's sequence and lint strict; K1 (K2) launched once for
            every step dispatched across the attempts; the final parameters
            (and K2's momentum buffers) bit-equal to a fault-free run
            restored from the directory the last attempt restored from, at
            the cut LR; ``memory_allocated`` after each attempt (no growth
            over the failed ones); each restart's wall time from the
            failure to the end of the first dispatch after it, with the
            trainer's rebuild, the restore and the first dispatch (the
            graph's recapture) apart. (b) Two processes on this card in one
            spawn, each a world of its own under ``--cluster_lockstep``:
            ``host_lost@15`` (the survivor shrinks to world 1 from
            ``ckpt_10``, bit-identical to the one-process run restored from
            it) and ``host_lost@15`` + ``host_return@18`` under
            ``--elastic_expand`` (process 1 respawned once the shrink is
            committed; 2 -> 1 -> 2, both seats bit-identical to the
            uninterrupted run); the ``elastic_restart`` and
            ``elastic_expand`` records, K1 once a step dispatched, each
            restart's time. (c) The seam's cost: eager and chunked ms/step
            with ``--cluster_dir`` set (lockstep off) against without it,
            in turns. Numbers in ``OUT/slice19.json``.
39. peer     The rest of resilience on the same recipe. K1 and K2 on the
            CNN's leaves bit-equal to their plain version and timed. (a)
            In phase 38's spawn, four lockstep pairs under
            ``--peer_redundancy true --replica_keep 2 --ckpt_format
            sharded`` with ``host_lost`` on process 1 (which commits its
            pending replica push first): K1, K2 (momentum 0.9, lr 0.02)
            and K1 with ``replica_corrupt@12`` on the survivor, eager with
            ``host_lost@15``, and K1 in chunks of 10 (CUDA graphs) with
            ``host_lost@10``. The chief decides ``source="peer"`` at step
            10; the survivor rebuilds its state from process 1's replica
            (the lost host's entries are placed first), every restore-side
            ``shard_io`` record saying ``peer`` (the corrupted pair: a
            classified miss, one ``peer_replica`` ``fallback`` record, then
            the disk walk); each survivor bit-identical to the one-process
            run (eager or chunked) restored from its ``ckpt_10``, K1 (K2)
            once a step dispatched; the restore's time beside phase 38's
            disk restore. (b) In the same spawn, phase 38's 2 -> 1 -> 2
            drill over ``--cluster_transport net`` with
            ``net_partition@15`` on process 1 (the partition heals after
            6 s): process 1 is cut off and fences, process 0 shrinks, the
            world expands again from ``ckpt_10`` or, when the chief's scan
            sees the rejoin one scan late, ``ckpt_20``; both seats
            bit-identical to the uninterrupted run. (c) The net transport's cost: the seam's
            calls alone over ``file`` and ``net``, and the eager main
            path's ms/step with ``--cluster_dir`` over ``net`` against
            ``file``, in turns. (d) The port's chaos oracle
            (``dml_cnn_cifar10_tpu_torch/tools/chaos.py``) with its workers
            on this card: a ``train`` schedule and a ``peer_recovery``
            schedule side by side, every invariant held. Numbers in
            ``OUT/slice20.json``.

The trainer runs cuDNN on its deterministic algorithms
(``parallel/step.py:f32_parity``); phase 9b's and phase 35's graphs
captured with the default algorithms are replayed beside the trainer's
to measure what that costs.

``--dist`` runs the build, phase 31, phases 33, 34 and 35 over NCCL, phase
32's two ranks over NCCL (chunks of 10 as CUDA graphs; the ranks' flag
exchange runs between replays), then phases 18-21 over NCCL on two or more
cards, with 4 ranks beside 2 given four cards: SP data 2 x seq 2 against
its 2 data ranks without the ring, and the DP CNN on 4 ranks; given three
or more cards, phases 26-27 (and phase 31's Ulysses run) over NCCL on 3 of
them.
``--phase 32`` to ``--phase 39`` (alone or with ``--dist``, except 38
and 39) runs the build and that phase only (39 with phase 38's sims,
which its pairs ride); phases 36 and 37 run under ``--dist`` only so.

The lines before the last are ``{"kernels": [...]}`` (K1 six times:
its main path row, phase 30's with ``"path": "dp_chunk"``, phase 32's
with ``"path": "run_safety"``, phase 33's with ``"path": "zero1"`` and
``"fsdp"``, on shard buffers, phase 34's with ``"path": "tp"``, on a
model rank's leaves, and phase 35's on ResNet-18's and ResNet-50's
leaves, ``"path": "resnet18"`` and ``"resnet50"``, and phase 36's on
``vit_moe``'s, ``"path": "vit_moe"``, as K2 three times more, phase
37's on a pipeline stage's leaves, ``"path": "pipe"``, and phase 38's on
the supervised main path, ``"path": "supervised"``, and phase 39's on
the peer-restored path, ``"path": "peer"``, as K2 twice more; K3,
K4, K6
and K7's training rows carry ``launches_vit_moe``;
``--dist`` prints K2's two shard rows; K3 five
times: its training row, its serving row with ``"path": "serve"``, its
Ulysses row, its ``"path": "tp"`` row and its ``"path": "pipe"`` row
at a stage's microbatch; K4, K6 and K7 four times, with
``"path": "ulysses"``, ``"tp"`` and ``"pipe"`` rows) and the card's name
and power limit; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Scratch data and checkpoints go to ``.chip_smoke_work/`` (removed after a
passing run); the run's metrics JSONL files, the profiles, ``chunk.json``
(phase 9b), ``vit.json``
(the ViT phases' numbers), ``serve.json`` (phases 22-25), ``dist.json``
(phases 16-21;
``dist_nccl.json`` under ``--dist``, with phase 31 and phase 32's NCCL
ranks), ``slice10.json`` (phases 26-29), ``slice11.json`` (phase 30),
``slice12.json`` (phase 32, with its telemetry stream and Chrome trace),
``slice13.json`` (phase 33), ``slice14.json`` (phase 34),
``slice15.json`` (phase 35), ``slice16.json`` (phase 36),
``slice17.json`` (phase 37), ``slice19.json`` (phase 38),
``slice20.json`` (phase 39, with its chaos streams) and the ranks' logs
are written to the output directory ``OUT``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".chip_smoke_work")
OUT = os.path.join(ROOT, "chiprun_out", "chip_smoke")

STEPS, RESUME_STEPS, MOMENTUM_STEPS = 500, 600, 50
VIT_STEPS, VIT_RESUME_STEPS, LONG_STEPS = 200, 300, 10
DP_STEPS = 50
CASES = [(0.0, 0.0), (0.0, 5e-4), (0.9, 0.0), (0.9, 5e-4)]
# Published peaks (NVIDIA data sheets, SXM parts, full power limit):
# device-memory bytes/s and f32 operations/s outside the tensor cores.
PEAKS = {"H100": (3.35e12, 67e12), "H200": (4.8e12, 67e12)}
# bf16 operations/s on the tensor cores (dense), the bf16 kernels' bound.
BF16_PEAK = 989e12
# --peak_tflops of each path, the card's dense peak for its dtype: f32
# outside the tensor cores (TF32 is off on every f32 path), bf16 on them.
F32_PEAK_TFLOPS, BF16_PEAK_TFLOPS = "67", "989"

EVAL_LINE = re.compile(r"^ --- Test Accuracy = (\d+\.\d\d)%\.$")
STEP_LINE = re.compile(r"^global_step (\d+), task:0_step (\d+), ")


# The train step's record_function ranges (parallel/step.py). The
# profiler puts each on the device's timeline as an annotation spanning
# its kernels: device time, but not work of its own.
STEP_RANGES = ("fwd_bwd", "optimizer")


def is_device_work(ev) -> bool:
    """A device event of a profile that is a kernel, copy or memset (not
    one of the step's ranges)."""
    from torch.autograd import DeviceType
    return (getattr(ev, "device_type", None) == DeviceType.CUDA
            and getattr(ev, "key", getattr(ev, "name", None))
            not in STEP_RANGES)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


class _Tee(io.TextIOBase):
    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for stream in self.streams:
            stream.write(s)
        return len(s)

    def flush(self):
        for stream in self.streams:
            stream.flush()


def run_cli(args):
    """``cli.main.main(args)``, echoing its console; returns the lines."""
    from dml_cnn_cifar10_tpu_torch.cli.main import main
    buf = io.StringIO()
    print("$ python -m dml_cnn_cifar10_tpu_torch " + " ".join(args),
          flush=True)
    with contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
        rc = main(args)
    check(rc == 0, f"cli returned {rc} for {args}")
    return buf.getvalue().splitlines()


def records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def cuda_ms(fn, reps=500, warmup=50) -> float:
    """Mean time of ``fn()`` by CUDA events over ``reps`` back-to-back
    calls (what a caller waits for, launches included)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_ms(fn, reps=50) -> dict:
    """Device ms per ``fn()`` of each kernel (and device memset or copy) it
    runs, by name, from torch.profiler. The trace can miss one kernel
    event of a profiling run (seen on the card: one of two), so each is
    its mean per traced event times its events per call, not the sum over
    ``reps``."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = (getattr(ev, "self_device_time_total", None)
              or getattr(ev, "self_cuda_time_total", 0.0))
        if us > 0 and ev.count:
            out[ev.key] = us / ev.count * max(1, round(ev.count / reps)) / 1e3
    return out


def device_ms(fn, needle: str, reps=100):
    """Device time per ``fn()`` of the kernels whose name holds
    ``needle`` (``kernel_ms``); None when the trace shows none."""
    found = [ms for name, ms in kernel_ms(fn, reps).items() if needle in name]
    return sum(found) if found else None


def profile_step(args, train_recs, card, steps=50) -> None:
    """Split the main path's step time: the trainer's windowed rate (its
    own JSONL, steps 200-500), one step with its batch already on the
    card (CUDA events), the host's batch assembly, and the device's busy
    time per step by kernel (torch.profiler). Written to
    ``chiprun_out/chip_smoke/profile.json``."""
    from torch.profiler import ProfilerActivity, profile

    from dml_cnn_cifar10_tpu_torch.cli.main import (build_parser,
                                                    config_from_args)
    from dml_cnn_cifar10_tpu_torch.data import pipeline as pipe
    from dml_cnn_cifar10_tpu_torch.train.loop import Trainer

    cfg = config_from_args(build_parser().parse_args(args))
    trainer = Trainer(cfg)
    state = trainer.init_or_restore()
    it = pipe.input_pipeline(cfg.data, cfg.batch_size, train=True,
                             seed=cfg.seed)
    t0 = time.perf_counter()
    host = [next(it) for _ in range(steps)]
    host_ms = (time.perf_counter() - t0) / steps * 1e3
    images, labels = pipe.to_device(host[0], torch.device("cuda"))
    step_ms = cuda_ms(lambda: trainer.train_step(state, images, labels),
                      reps=200, warmup=20)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            trainer.train_step(state, images, labels)
        torch.cuda.synchronize()
    rows = sorted(((getattr(ev, "device_time_total", 0.0) / 1e3 / steps,
                    ev.count // steps, ev.key)
                   for ev in prof.key_averages() if is_device_work(ev)),
                  reverse=True)
    busy_ms = sum(r[0] for r in rows)
    windows = [r["images_per_sec"] for r in train_recs
               if r["kind"] == "train" and r["step"] > 100]
    loop_ms = cfg.batch_size / (sum(windows) / len(windows)) * 1e3
    summary = {"card": card, "batch": cfg.batch_size,
               "loop_ms_per_step": loop_ms, "step_ms_on_device_batch": step_ms,
               "host_batch_ms": host_ms, "device_busy_ms_per_step": busy_ms,
               "device_busy_share": busy_ms / step_ms,
               "kernels": [{"ms_per_step": ms, "per_step": n, "name": name}
                           for ms, n, name in rows]}
    with open(os.path.join(OUT, "profile.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(f"[profile] trainer loop {loop_ms:.4f} ms/step (windows after "
          f"step 100); a step on a batch already on the card "
          f"{step_ms:.4f} ms; host batch assembly {host_ms:.4f} ms; device "
          f"busy {busy_ms:.4f} ms/step ({100 * busy_ms / step_ms:.1f}% of "
          f"the step) in {sum(r[1] for r in rows)} kernels, on {card}")
    for ms, n, name in rows[:12]:
        print(f"[profile]   {ms:.5f} ms/step  x{n}  {name[:110]}")
    return summary


def run_trainer(args):
    """``Trainer(config_from_args(args)).fit()``, the CLI's train mode
    with the trainer kept, echoing its console; returns ``(lines,
    trainer, result)``."""
    from dml_cnn_cifar10_tpu_torch.cli.main import (build_parser,
                                                    config_from_args)
    from dml_cnn_cifar10_tpu_torch.train.loop import Trainer
    buf = io.StringIO()
    print("$ python -m dml_cnn_cifar10_tpu_torch " + " ".join(args),
          flush=True)
    with contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
        trainer = Trainer(config_from_args(build_parser().parse_args(args)))
        try:
            result = trainer.fit()
        finally:
            trainer.logger.close()
    return buf.getvalue().splitlines(), trainer, result


# Steps per dispatch of the chunked phase (9b), and its graphed-vs-eager
# gate: the loss of ten steps (relative) and every parameter after them.
# The graph replays the kernels the eager body launches, on the same
# inputs in the same order, so with cuDNN held to deterministic algorithms
# for the comparison the two agreed bit for bit on an H100 (PERF.md), as
# did two eager runs. Without it (printed, not gated), cuDNN may
# pick backward kernels that sum with atomics, and ten steps of SGD carry
# the difference along. The gate leaves room for a stray rounding, while
# a wrong row, a skipped or repeated update (lr x gradient, 1e-4 and up)
# lands outside it.
CHUNK_K = 10
CHUNK_LOSS_TOL, CHUNK_PARAM_TOL = 1e-6, 1e-5


def _state_copies(cfg, state, n, mesh=None):
    """``n`` (model, state) pairs of ``cfg``'s model (over ``mesh``, in
    ``state``'s layout: its shards under zero1 or fsdp) holding
    ``state``'s values, on its device."""
    from dml_cnn_cifar10_tpu_torch.models.registry import get_model
    from dml_cnn_cifar10_tpu_torch.parallel import step as step_lib
    from dml_cnn_cifar10_tpu_torch.parallel import zero
    out = []
    for _ in range(n):
        model = get_model(cfg.model.name)(cfg.model, cfg.data, mesh=mesh)
        layout = None if state.layout is None else zero.build_layout(
            model, cfg.model.name, cfg.optim, cfg.parallel, mesh)
        st = step_lib.init_train_state(model, cfg.optim, state.step.device,
                                       layout=layout)
        with torch.no_grad():
            for a, b in zip(step_lib._state_tensors(st),
                            step_lib._state_tensors(state)):
                a.copy_(b)
        out.append((model, st))
    return out


def _gaps(a, b):
    """Largest parameter gap between two states."""
    return max((x - y).abs().max().item()
               for x, y in zip(a.params.values(), b.params.values()))


def _launched(fn):
    """``fn()``'s result and the kernel launches it counted."""
    from dml_cnn_cifar10_tpu_torch.ops import flash_attention as fa
    from dml_cnn_cifar10_tpu_torch.ops import optimizer as fused
    before = {**fa.LAUNCHES, **fused.LAUNCHES}
    out = fn()
    after = {**fa.LAUNCHES, **fused.LAUNCHES}
    return out, {k: after[k] - before[k] for k in after
                 if after[k] != before[k]}


def _graph_vs_eager(cfg, state, ds_images, ds_labels, deterministic,
                    k=None, mesh=None, health=False):
    """One graphed chunk of the device-stream resident path (``k`` steps,
    ``CHUNK_K`` by default, over ``mesh``; with ``health`` the health
    scalars computed in it) against the same chunk body run eagerly,
    twice, each from a copy of ``state``; returns the gaps (and each
    run's health scalars) and each run's launches, the graphed callable
    and its state."""
    from dml_cnn_cifar10_tpu_torch.parallel import step as step_lib
    saved = torch.backends.cudnn.deterministic
    try:
        copies = _state_copies(cfg, state, 3, mesh)
        fns = [step_lib.make_train_chunk_resident(
            m, cfg.optim, ds_images, ds_labels, data_cfg=cfg.data,
            index_stream=(cfg.data.seed, cfg.batch_size, k or CHUNK_K),
            mesh=mesh, health_metrics=health)
            for m, _ in copies]
        # After the step builders, which set the trainer's deterministic
        # mode (parallel/step.py:f32_parity): the mode asked for.
        torch.backends.cudnn.deterministic = deterministic
        (_, s_g), (_, s_e), (_, s_e2) = copies
        (_, m_g), graph_launches = _launched(lambda: fns[0](s_g))
        (_, m_e), eager_launches = _launched(lambda: fns[1].eager(s_e))
        losses = [float(m_g["loss"]), float(m_e["loss"]),
                  float(fns[2].eager(s_e2)[1]["loss"])]
        healths = [{key: float(m[key]) for key in m
                    if key.startswith("health_")} for m in (m_g, m_e)]
        moes = [{key: m[key].tolist() for key in m if key.startswith("moe_")}
                for m in (m_g, m_e)]
        fns[0].check()
    finally:
        torch.backends.cudnn.deterministic = saved
    return ({"health_graph": healths[0], "health_eager": healths[1],
             "moe_graph": moes[0], "moe_eager": moes[1],
             "loss_graph": losses[0], "loss_eager": losses[1],
             "loss_gap": abs(losses[0] - losses[1]),
             "param_gap": _gaps(s_g, s_e),
             # The running stats (the ResNet's BN buffers, updated in
             # place inside the graph); 0 for a model without them.
             "mstate_gap": max([(x - y).abs().max().item() for x, y in zip(
                 s_g.model_state.values(), s_e.model_state.values())]
                 + [0.0]),
             "eager_eager_loss_gap": abs(losses[1] - losses[2]),
             "eager_eager_param_gap": _gaps(s_e, s_e2),
             "launches_graph": graph_launches,
             "launches_eager": eager_launches}, fns[0], s_g)


def _mode_replays(graphs, k, card, label, reps=5) -> dict:
    """ms/step of graphed chunks captured under cuDNN's default and its
    deterministic algorithms (``graphs``: ``{"default": (fn, state),
    "deterministic": (fn, state)}``), replayed in turns (default,
    deterministic, deterministic, default) by CUDA events: the cost of the
    trainer's deterministic mode (``parallel/step.py:f32_parity``)."""
    got = {mode: [] for mode in graphs}
    for mode in ("default", "deterministic", "deterministic", "default"):
        fn, st = graphs[mode]
        got[mode].append(cuda_ms(lambda: fn(st), reps=reps, warmup=1) / k)
    out = {mode: sum(v) / len(v) for mode, v in got.items()}
    out["turns"] = got
    print(f"[cudnn modes] {label}: a graph replay {out['default']:.4f} "
          f"ms/step with cuDNN's default algorithms, "
          f"{out['deterministic']:.4f} deterministic "
          f"({(out['deterministic'] / out['default'] - 1) * 100:+.2f}%; "
          f"turns {got}) on {card}", flush=True)
    return out


def _vit_chunk_check(card) -> dict:
    """The ViT under chunked dispatch: a small ViT (depth 2, dim 64, 48x48
    crop = 145 tokens, so the flash kernels run) on the resident device
    stream, K = 2, AdamW, two graphed chunks against the same body run
    eagerly from one state: the flash launches a replay adds equal the
    eager body's, and the losses agree (AdamW turns the rounding of
    nondeterministic sums into steps of +-lr, so params are printed, not
    gated)."""
    import numpy as np

    from dml_cnn_cifar10_tpu_torch.config import (DataConfig, ModelConfig,
                                                  OptimConfig)
    from dml_cnn_cifar10_tpu_torch.models.registry import get_model
    from dml_cnn_cifar10_tpu_torch.ops import flash_attention as fa
    from dml_cnn_cifar10_tpu_torch.parallel import step as step_lib

    mcfg = ModelConfig(name="vit_tiny", logit_relu=False, vit_depth=2,
                       vit_dim=64, vit_heads=2)
    dcfg = DataConfig(image_height=52, image_width=52, crop_height=48,
                      crop_width=48, random_crop=True,
                      normalize="standardize")
    ocfg = OptimConfig(optimizer="adamw", learning_rate=1e-3,
                       schedule="cosine", cosine_decay_steps=100,
                       warmup_steps=2, dead_lr_decay=False)
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    images = torch.from_numpy(rng.integers(0, 256, (512, 52, 52, 3),
                                           dtype=np.uint8)).to(dev)
    labels = torch.from_numpy(rng.integers(0, 10, 512)).to(dev)
    runs = []
    for _ in range(2):
        model = get_model(mcfg.name)(mcfg, dcfg)
        state = step_lib.init_train_state(model, ocfg, dev,
                                          torch.Generator().manual_seed(0))
        runs.append((state, step_lib.make_train_chunk_resident(
            model, ocfg, images, labels, data_cfg=dcfg,
            index_stream=(0, 16, 2))))
    (s_g, f_g), (s_e, f_e) = runs
    fa.reset_launches()
    gaps, graph_launches = [], {}
    for _ in range(2):
        before = dict(fa.LAUNCHES)
        loss_g = float(f_g(s_g)[1]["loss"])
        graph_launches = {n: fa.LAUNCHES[n] - before[n] for n in before}
        before = dict(fa.LAUNCHES)
        loss_e = float(f_e.eager(s_e)[1]["loss"])
        eager_launches = {n: fa.LAUNCHES[n] - before[n] for n in before}
        check(graph_launches == eager_launches and math.isfinite(loss_g),
              f"ViT chunk: replay launched {graph_launches}, the eager "
              f"body {eager_launches}; loss {loss_g}")
        gaps.append((loss_g, loss_e, _gaps(s_g, s_e)))
    f_g.check()
    check(all(abs(g - e) <= 1e-5 * abs(e) for g, e, _ in gaps),
          f"ViT chunk losses (graph, eager, param gap): {gaps}")
    check(f_g.graph.replays == 2, f"ViT chunk replays {f_g.graph.replays}")
    print(f"[chunk vit] depth 2, 145 tokens, K = 2: (graph loss, eager "
          f"loss, params max gap) per chunk {gaps}; flash launches a "
          f"replay {graph_launches}; on {card}", flush=True)
    return {"chunks": gaps, "flash_launches_per_replay": graph_launches}


def chunk_phase(base, card, eager_profile) -> dict:
    """Phase 9b: the CNN main path with ``--steps_per_dispatch 10``,
    resident on the device index stream (see the module docstring).
    Returns the numbers, also written to ``OUT/chunk.json``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dml_cnn_cifar10_tpu_torch.ops import optimizer as fused
    from dml_cnn_cifar10_tpu_torch.parallel import step as step_lib

    k = CHUNK_K
    args = base + ["--steps_per_dispatch", str(k)]
    log_dir = os.path.join(WORK, "logs_chunk")
    jsonl = os.path.join(WORK, "chunk_train.jsonl")
    fused.reset_launches()
    t0 = time.perf_counter()
    lines, trainer, _ = run_trainer(args + [
        "--log_dir", log_dir, "--total_steps", str(STEPS), "--eval_every",
        "250", "--metrics_jsonl", jsonl])
    wall_s = time.perf_counter() - t0
    fn = trainer.train_fn
    launches = dict(fused.LAUNCHES)
    want = {"sgd_update_plain": STEPS, "sgd_update_momentum": 0}
    check(launches == want, f"chunked run launched {launches}, want {want}"
          " (K1 once a step)")
    check(fn.graph.replays == STEPS // k,
          f"{fn.graph.replays} graph replays for {STEPS // k} chunks")
    check(fn.graph.warmup_launches == {"sgd_update_plain": k},
          f"warm-up launches {fn.graph.warmup_launches}")
    rows = fn.rows
    check(int(rows.misses) == 0, f"index stream misses {int(rows.misses)}")
    recs = records(jsonl)
    train_recs = [r for r in recs if r["kind"] == "train"]
    losses = [r["loss"] for r in train_recs]
    check(len(losses) == STEPS // 100 and all(
        l is not None and math.isfinite(l) for l in losses),
        f"chunked losses {losses}")
    accs = [float(m[1]) for m in map(EVAL_LINE.match, lines) if m]
    check(len(accs) == 2 and accs[-1] > 50.0,
          f"chunked test accuracies {accs} (chance is 10%)")
    windows = [r["images_per_sec"] for r in train_recs if r["step"] > 100]
    loop_ms = 128 / (sum(windows) / len(windows)) * 1e3
    print(f"[chunk train] {STEPS} steps in {STEPS // k} graph replays of "
          f"{k} steps: loss {losses[0]:.4f} -> {losses[-1]:.4f}, test "
          f"accuracy {accs[-1]:.2f}%, loop {loop_ms:.4f} ms/step (windows "
          f"after step 100), {wall_s:.1f} s wall; K1 {STEPS} launches "
          f"(+{k} in the warm-up, apart); index "
          f"stream: {rows.epochs_built} epoch tables, {rows.host_reads} "
          f"host reads, misses {int(rows.misses)}; on {card}", flush=True)

    # Resume: the stream position is the step.
    fused.reset_launches()
    lines, trainer, result = run_trainer(args + [
        "--log_dir", log_dir, "--total_steps", str(RESUME_STEPS),
        "--eval_every", "100", "--metrics_jsonl",
        os.path.join(WORK, "chunk_resume.jsonl")])
    steps = [int(m[1]) for m in map(STEP_LINE.match, lines) if m]
    check(steps == [RESUME_STEPS], f"chunked resume printed steps {steps}")
    check(fused.LAUNCHES["sgd_update_plain"] == RESUME_STEPS - STEPS
          and trainer.train_fn.graph.replays == (RESUME_STEPS - STEPS) // k,
          f"chunked resume: K1 {fused.LAUNCHES}, "
          f"{trainer.train_fn.graph.replays} replays")
    print(f"[chunk resume] continued {STEPS} -> {RESUME_STEPS} in "
          f"{trainer.train_fn.graph.replays} replays", flush=True)

    # Eval: the resident sweep against the host-fed one, same state.
    cfg, state = trainer.cfg, result.state
    test_it = trainer.input_pipeline(train=False, seed=cfg.seed)
    ev, total = step_lib.make_eval_resident(
        trainer.model, test_it.images, test_it.labels, cfg.data,
        torch.device("cuda"), batch_size=cfg.batch_size,
        expected_batches=test_it.num_padded_sweep_batches())
    resident_count = int(ev(state))
    host_count = sum(int(trainer.eval_step(
        state, *trainer._placed(b))["correct"])
        for b in test_it.full_sweep_padded())
    check(resident_count == host_count,
          f"resident eval counted {resident_count}, the host-fed sweep "
          f"{host_count}")
    print(f"[chunk eval] step {RESUME_STEPS}: {resident_count}/{total} "
          f"correct, resident and host-fed sweeps equal", flush=True)

    # Momentum: K2 once a step under the graph.
    fused.reset_launches()
    run_trainer(args + ["--log_dir", os.path.join(WORK, "logs_chunk_mom"),
                        "--total_steps", str(MOMENTUM_STEPS),
                        "--output_every", "10", "--eval_every", "50",
                        "--momentum", "0.9", "--weight_decay", "5e-4"])
    mom_launches = dict(fused.LAUNCHES)
    want = {"sgd_update_plain": 0, "sgd_update_momentum": MOMENTUM_STEPS}
    check(mom_launches == want,
          f"chunked momentum launched {mom_launches}, want {want}")

    # Graphed against eager: one chunk from one (trained) state, with
    # cuDNN's deterministic algorithms (gated) and without (printed).
    train_it = trainer.input_pipeline(train=True, seed=cfg.seed)
    ds_images = torch.from_numpy(train_it.images).cuda()
    ds_labels = torch.from_numpy(train_it.labels.astype("int64")).cuda()
    compare, graphed = {}, {}
    for det in (False, True):
        c, *graphed[det] = _graph_vs_eager(cfg, state, ds_images,
                                           ds_labels, det)
        compare["deterministic" if det else "default"] = c
        print(f"[chunk graph vs eager] {k} steps from step {RESUME_STEPS}, "
              f"cudnn.deterministic={det}: loss {c['loss_graph']!r} vs "
              f"{c['loss_eager']!r} (gap {c['loss_gap']:.3g}), params max "
              f"gap {c['param_gap']:.3g}; two eager runs "
              f"{c['eager_eager_loss_gap']:.3g}, "
              f"{c['eager_eager_param_gap']:.3g}", flush=True)
    c = compare["deterministic"]
    check(c["loss_gap"] <= CHUNK_LOSS_TOL * abs(c["loss_eager"])
          and c["param_gap"] <= CHUNK_PARAM_TOL,
          f"graphed chunk differs from the eager body: {c}")

    vit = _vit_chunk_check(card)

    # Profile: replays of the graphed chunk (default cuDNN, as trained).
    cudnn_modes = _mode_replays({"default": tuple(graphed[False]),
                                 "deterministic": tuple(graphed[True])},
                                k, card, "CNN main path, chunked K = 10")
    fn_g, s_g = graphed[False]
    reps = 20
    for _ in range(2):
        fn_g(s_g)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn_g(s_g)
    torch.cuda.synchronize()
    window_ms = (time.perf_counter() - t0) / (reps * k) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn_g(s_g)
        torch.cuda.synchronize()
    steps_traced = reps * k
    prof_rows = _device_rows(prof, steps_traced)
    busy_ms = sum(r[0] for r in prof_rows)
    groups = dict.fromkeys(("convolutions (cuDNN)", "GEMMs (cuBLAS)",
                            "max pool", "K1", "rest"), 0.0)
    for ms, _, name in prof_rows:
        group = ("K1" if "sgd_multi_kernel" in name
                 else "convolutions (cuDNN)" if _CONV.search(name)
                 else "GEMMs (cuBLAS)" if _GEMM.search(name)
                 else "max pool" if "pool" in name else "rest")
        groups[group] += ms
    h2d = [ev.key for ev in prof.key_averages() if "HtoD" in ev.key]
    k1_events = sum(ev.count for ev in prof.key_averages()
                    if getattr(ev, "device_type", None) == DeviceType.CUDA
                    and "sgd_multi_kernel<false>" in ev.key)
    fn_g.check()
    check(not h2d, f"host-to-device copies in a window of replays: {h2d}")
    summary = {
        "card": card, "batch": cfg.batch_size, "steps_per_dispatch": k,
        "loop_ms_per_step": loop_ms, "replay_ms_per_step": window_ms,
        "device_busy_ms_per_step": busy_ms,
        "device_busy_share_of_replays": busy_ms / window_ms,
        "device_busy_share_of_loop": busy_ms / loop_ms,
        "groups_ms_per_step": groups,
        "k1_launches": launches["sgd_update_plain"],
        "k1_kernel_events_traced": k1_events, "steps_traced": steps_traced,
        "k2_launches": mom_launches["sgd_update_momentum"],
        "warmup_launches": fn.graph.warmup_launches,
        "replays": STEPS // k, "host_to_device_copies": h2d,
        "index_stream": {"epochs_built": rows.epochs_built,
                         "host_reads": rows.host_reads, "misses": 0},
        "losses": losses, "test_accuracy": accs,
        "resident_eval_correct": resident_count,
        "host_eval_correct": host_count, "graph_vs_eager": compare,
        "cudnn_modes": cudnn_modes, "vit": vit,
        "eager": {key: eager_profile[key] for key in (
            "loop_ms_per_step", "step_ms_on_device_batch", "host_batch_ms",
            "device_busy_ms_per_step", "device_busy_share")},
        "kernels": [{"ms_per_step": ms, "per_step": n, "name": name}
                    for ms, n, name in prof_rows]}
    with open(os.path.join(OUT, "chunk.json"), "w") as f:
        json.dump(summary, f, indent=1)
    e = summary["eager"]
    print(f"[chunk profile] chunked loop {loop_ms:.4f} ms/step, replays "
          f"{window_ms:.4f} ms/step, device busy {busy_ms:.4f} ms/step "
          f"({100 * busy_ms / window_ms:.1f}% of the replays, "
          f"{100 * busy_ms / loop_ms:.1f}% of the loop), K1 kernels "
          f"traced {k1_events} in {steps_traced} steps, host-to-device "
          f"copies {len(h2d)}; eager (phase 9): loop "
          f"{e['loop_ms_per_step']:.4f} ms/step, device-batch step "
          f"{e['step_ms_on_device_batch']:.4f} ms, busy "
          f"{e['device_busy_ms_per_step']:.4f} ms "
          f"({100 * e['device_busy_share']:.1f}%); on {card}", flush=True)
    print("[chunk profile] device ms/step by group: " + ", ".join(
        f"{g} {ms:.5f} ({100 * ms / busy_ms:.1f}%)"
        for g, ms in groups.items()), flush=True)
    for ms, n, name in prof_rows[:12]:
        print(f"[chunk profile]   {ms:.5f} ms/step  x{n}  {name[:110]}")
    return summary


_PTXAS_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_PTXAS_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")
_INSTANCE = re.compile(r"(flash_out_kernel|flash_lse_kernel|"
                       r"flash_stats_kernel|flash_dq_kernel|flash_dkv_kernel)"
                       r"I(f|13__nv_bfloat16)Li(\d+)E(?:Li(\d+)E)?")
# Instances a build must hold: K3, K4, K5 per input dtype and head dim;
# K6, K7 also per P/dS term count.
_INSTANCES = {"flash_out_kernel": 6, "flash_lse_kernel": 6,
              "flash_stats_kernel": 6, "flash_dq_kernel": 9,
              "flash_dkv_kernel": 9}


def ptxas_report(log: str) -> list:
    """ptxas's registers, stack and spills for every flash instance (input
    dtype x head dim, and for K6/K7 x P/dS terms), beside the dynamic
    shared memory it launches with. Fails unless all 36 are found and the
    head-dim-64 instances (K3-K7: the main paths') spill nothing."""
    import ctypes

    from dml_cnn_cifar10_tpu_torch.ops import flash_attention as fa
    lib = fa._lib()
    fwd, bwd = lib.flash_fwd_smem_bytes, lib.flash_bwd_smem_bytes
    for fn in (fwd, bwd):
        fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_int
    # kernel -> its shared-memory query and that query's first argument
    smem_of = {"flash_out_kernel": (fwd, 0), "flash_lse_kernel": (fwd, 0),
               "flash_stats_kernel": (fwd, 1), "flash_dq_kernel": (bwd, 0),
               "flash_dkv_kernel": (bwd, 1)}
    found, cur = {}, None
    for line in log.splitlines():
        m = _PTXAS_ENTRY.search(line)
        if m:
            cur = found.setdefault(m[1], {})
            continue
        m = _PTXAS_SPILL.search(line)
        if m and cur is not None:
            cur.update(stack_bytes=int(m[1]), spill_stores=int(m[2]),
                       spill_loads=int(m[3]))
        m = _PTXAS_REGS.search(line)
        if m and cur is not None:
            cur["registers"] = int(m[1])
    report = []
    for name, info in sorted(found.items()):
        m = _INSTANCE.search(name)
        if not m:
            continue
        dt = 0 if m[2] == "f" else 1
        report.append(dict(kernel=m[1], dtype=["float32", "bfloat16"][dt],
                           head_dim=int(m[3]),
                           terms=int(m[4]) if m[4] else None,
                           smem_bytes=smem_of[m[1]][0](smem_of[m[1]][1], dt,
                                                       int(m[3])), **info))
    for r in report:
        print(f"[build] {r['kernel']} {r['dtype']} D={r['head_dim']}"
              + (f" P/dS terms {r['terms']}" if r["terms"] else "")
              + f": {r.get('registers')} registers, "
              f"{r.get('stack_bytes')} B stack, {r.get('spill_stores')}/"
              f"{r.get('spill_loads')} B spill stores/loads, "
              f"{r['smem_bytes']} B dynamic shared memory")
    counts = {k: sum(r["kernel"] == k and "spill_loads" in r for r in report)
              for k in _INSTANCES}
    check(counts == _INSTANCES,
          f"ptxas reported {counts} flash instances, want {_INSTANCES}")
    check(all(r["spill_stores"] == r["spill_loads"] == 0 for r in report
              if r["head_dim"] == 64),
          "a head-dim-64 flash instance spills")
    return report


def cu_constant(name: str) -> int:
    """``constexpr int <name> = N;`` of ``csrc/flash_attention.cu``."""
    path = os.path.join(ROOT, "dml_cnn_cifar10_tpu_torch", "csrc",
                        "flash_attention.cu")
    with open(path) as f:
        return int(re.search(rf"constexpr int {name} = (\d+);", f.read())[1])


def tc_flops(kname: str, f32_in: bool, f32_grads: bool = False) -> int:
    """Tensor-core FLOPs per B·H·Sq·Skv·D that K3/K4/K5 (S, O), K6 (S,
    dP, dQ) or K7 (S, dP, dV, dK) issue: 2 per product times the term
    pairs of its split (f32 inputs: 6 for every product; bf16 inputs: 1,
    but kStatsBf16Terms for K5's P V and 3 for K6/K7's second products
    with f32 gradients)."""
    first = 6 if f32_in else 1
    if kname.startswith("flash_fwd"):
        pv = first if f32_in or kname != "flash_fwd_stats" else cu_constant(
            "kStatsBf16Terms")
        return 2 * (first + pv)
    second = 6 if f32_in else (3 if f32_grads else 1)
    return 2 * (2 * first + (1 if kname == "flash_bwd_dq" else 2) * second)


# ---- the flash-attention kernels (K3, K4, K6, K7) -----------------------

# Pins of the JAX package's flash tests (tests/test_flash_backward.py) in
# f32. With bf16 inputs, lse is still an f32 result of f32 arithmetic on
# the same values, so it keeps the f32 pin; out and the gradients are
# rounded once to bf16 from f32 on both sides, so they may differ by one
# bf16 ulp (at most 2^-7 of the tensor's largest magnitude): they are held
# to 1e-2 x max|plain| per tensor, and never more than the JAX package's
# 0.05.
FLASH_TOL = {"out": 5e-6, "lse": 1e-5, "grad": 5e-5}
BF16_REL, BF16_CAP = 1e-2, 0.05


def flash_tol(kind: str, dtype, ref: torch.Tensor) -> float:
    """The gate for one output tensor against its plain version ``ref``."""
    if dtype == torch.float32 or kind == "lse":
        return FLASH_TOL[kind]
    return min(BF16_CAP, BF16_REL * ref.float().abs().max().item())


# name, (B, Sq, Skv, H, D), dtype, mask; "strided" feeds q, k, v as the
# ViT does (views of one fused [B, S, H, 3, D] qkv tensor). The first two
# are the shapes the main paths give the kernels: the ViT's attention at
# batch 128 (f32) and the long-context recipe's (8,100 tokens, bf16).
FLASH_CASES = [
    ("vit main path", (128, 257, 257, 3, 64), torch.float32,
     {"strided": True}),
    ("long context", (2, 8100, 8100, 3, 64), torch.bfloat16,
     {"strided": True}),
    # Ulysses over 3 seq ranks: each rank's full-sequence head, contiguous
    # after the all-to-all.
    ("ulysses", (2, 8100, 8100, 1, 64), torch.bfloat16, {}),
    ("vit f32", (2, 257, 257, 3, 64), torch.float32, {}),
    ("vit bf16", (2, 257, 257, 3, 64), torch.bfloat16, {}),
    ("strided qkv", (2, 257, 257, 3, 64), torch.float32, {"strided": True}),
    ("ragged 300", (2, 300, 300, 3, 64), torch.float32, {}),
    ("causal", (2, 257, 257, 3, 64), torch.float32, {"causal": True}),
    ("window 100", (2, 300, 300, 3, 64), torch.float32, {"window": 100}),
    ("segments", (2, 300, 300, 3, 64), torch.float32, {"segments": True}),
    ("kv_start", (2, 300, 200, 3, 64), torch.float32,
     {"kv_start": 100, "causal": True, "window": 150}),
    ("dead rows", (1, 512, 128, 1, 64), torch.float32, {"window": 64}),
    ("head dim 32", (2, 257, 257, 3, 32), torch.float32, {}),
    ("head dim 128", (2, 257, 257, 3, 128), torch.float32, {"causal": True}),
]
FLASH_KERNELS = ("flash_fwd", "flash_fwd_lse", "flash_bwd_dq",
                 "flash_bwd_dkv")


def _segment_ids(b, s, gen, dev):
    """Packed-sequence ids: each row cut into a few segments."""
    cuts = torch.rand(b, s, device=dev, generator=gen) < 4.0 / s
    cuts[:, 0] = False
    return torch.cumsum(cuts.to(torch.int32), dim=1).to(torch.int32)


# Per case of the last flash_parity, each kernel's max abs difference.
FLASH_CASE_DIFFS = {}


def flash_parity(dev, cases=None) -> dict:
    """Hold K3, K4, K6 and K7 against their plain versions on the card, in
    the working dtype, case by case (``FLASH_CASES`` by default); dead
    rows must be exactly 0. Returns the worst max abs difference per
    kernel and dtype."""
    from dml_cnn_cifar10_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(1)
    worst = {(k, dt): 0.0 for k in FLASH_KERNELS
             for dt in ("float32", "bfloat16")}
    for name, (b, sq, skv, h, d), dtype, mask in cases or FLASH_CASES:
        kw = {k: v for k, v in mask.items() if k not in ("strided",
                                                         "segments")}
        if mask.get("strided"):
            qkv = torch.randn(b, sq, h, 3, d, device=dev,
                              generator=gen).to(dtype)
            q, k, v = qkv.unbind(3)
            check(q.stride()[1] == h * 3 * d,
                  "the strided case lost the fused qkv layout")
        else:
            q = torch.randn(b, sq, h, d, device=dev, generator=gen).to(dtype)
            k, v = (torch.randn(b, skv, h, d, device=dev, generator=gen)
                    .to(dtype) for _ in range(2))
        if mask.get("segments"):
            kw["segment_ids"] = _segment_ids(b, sq, gen, dev)
        do = torch.randn(b, sq, h, d, device=dev, generator=gen).to(dtype)
        with torch.no_grad():
            want, want_lse = fa.flash_attention_plain(q, k, v, **kw)
            dead = want_lse >= 1e29
            outs = {}
            if "kv_start" not in kw:
                outs["flash_fwd"] = fa.flash_attention(q, k, v, **kw)
            outs["flash_fwd_lse"], lse = fa.flash_attention_fwd_lse(
                q, k, v, **kw)
            delta = fa.attention_delta(want, do)
            want_g = fa.flash_attention_bwd_plain(q, k, v, do, want_lse,
                                                  delta, **kw)
            got_g = fa.flash_attention_bwd(q, k, v, do, want_lse, delta,
                                           **kw)
        torch.cuda.synchronize()
        diffs = {}
        for kname, out in outs.items():
            check(out.dtype == dtype and out.shape == want.shape,
                  f"{name}: {kname} gave {out.dtype} {tuple(out.shape)}")
            check(bool(torch.all(out[dead] == 0)),
                  f"{name}: {kname} dead rows are not exactly 0")
            diffs[kname] = (out.float() - want.float()).abs().max().item()
            tol = flash_tol("out", dtype, want)
            check(diffs[kname] <= tol,
                  f"{name}: {kname} out max abs diff {diffs[kname]} > {tol}")
        check(torch.equal(lse >= 1e29, dead) and
              bool(torch.all(lse[dead] == 1e30)),
              f"{name}: K4 dead-row lse differs from the plain version")
        lse_diff = (lse[~dead] - want_lse[~dead]).abs().max().item() \
            if bool((~dead).any()) else 0.0
        check(lse_diff <= FLASH_TOL["lse"],
              f"{name}: K4 lse max abs diff {lse_diff} > {FLASH_TOL['lse']}")
        diffs["flash_fwd_lse"] = max(diffs["flash_fwd_lse"], lse_diff)
        gdiff = [(g.float() - w.float()).abs().max().item()
                 for g, w in zip(got_g, want_g)]
        for g, w in zip(got_g, want_g):
            check(g.dtype == w.dtype == dtype, f"{name}: grad dtype {g.dtype}")
        check(bool(torch.all(got_g[0][dead] == 0)),
              f"{name}: K6 dQ of dead rows is not exactly 0")
        diffs["flash_bwd_dq"], diffs["flash_bwd_dkv"] = gdiff[0], max(gdiff[1:])
        gtol = [flash_tol("grad", dtype, w) for w in want_g]
        check(all(g <= t for g, t in zip(gdiff, gtol)),
              f"{name}: grads max abs diff {gdiff} > {gtol}")
        dt_name = "float32" if dtype == torch.float32 else "bfloat16"
        FLASH_CASE_DIFFS[name] = diffs
        for kname, dval in diffs.items():
            worst[(kname, dt_name)] = max(worst[(kname, dt_name)], dval)
        scale_ref = max(w.float().abs().max().item() for w in want_g)
        print(f"[flash parity] {name:13s} {dt_name} {(b, sq, skv, h, d)} "
              f"{mask}: max abs diff "
              + ", ".join(f"{k} {v:.3g}" for k, v in diffs.items())
              + f" (lse {lse_diff:.3g}; |out| up to "
              f"{want.float().abs().max().item():.3g}, |grad| up to "
              f"{scale_ref:.3g}; {int(dead.sum())} dead rows)", flush=True)
    # On the card the wrappers launch or raise: no quiet fallback.
    q = torch.randn(2, 128, 3, 64, device=dev, generator=gen)
    for what, args in (
            ("float16 inputs", (q.half(), q.half(), q.half())),
            ("head dim 48", (q[..., :48],) * 3),
            ("a non-contiguous head dim",
             (torch.randn(2, 128, 3, 128, device=dev)[..., ::2],) * 3),
            ("a key on the host", (q, q.cpu(), q))):
        try:
            with torch.no_grad():
                fa.flash_attention(*args)
        except ValueError:
            continue
        fail(f"flash_attention accepted {what}")
    return worst


# Shapes of the flash timing: the ViT main path's attention (batch 128,
# 257 tokens, 3 heads of 64, f32), the long-context recipe's (8,100
# tokens, bf16) at batch 2, and its Ulysses rank's (one head of the 3).
FLASH_TIMING = [("vit", (128, 257, 3, 64), torch.float32),
                ("long", (2, 8100, 3, 64), torch.bfloat16),
                ("ulysses", (2, 8100, 1, 64), torch.bfloat16)]
FLASH_NEEDLES = {"flash_fwd": "flash_out_kernel",
                 "flash_fwd_lse": "flash_lse_kernel",
                 "flash_bwd_dq": "flash_dq_kernel",
                 "flash_bwd_dkv": "flash_dkv_kernel"}
# Matrix-product FLOPs per (B·H·Sq·Skv·D): QKᵀ and PV forward; S, dP, dQ
# for K6; S, dP, dV, dK for K7.
FLASH_FLOPS = {"flash_fwd": 4, "flash_fwd_lse": 4, "flash_bwd_dq": 6,
               "flash_bwd_dkv": 8}


def timed_ms(fn, min_ms=300.0):
    """``cuda_ms`` over enough back-to-back calls to fill ``min_ms`` of
    device time after a warm-up of a quarter of that (short runs catch the
    card before its clocks settle). Returns ``(ms, reps)``."""
    one = cuda_ms(fn, reps=1, warmup=1)
    reps = max(3, min(500, math.ceil(min_ms / max(one, 1e-3))))
    return cuda_ms(fn, reps=reps, warmup=max(1, reps // 4)), reps


def sdpa_backward(q, k, v, do):
    """``F.scaled_dot_product_attention``'s autograd backward (dQ, dK and
    dV together, gradients in the input's dtype), a yardstick the port
    never calls, on contiguous [B, H, S, D] copies of the [B, S, H, D]
    inputs and warmed up. Returns ``(fn, backend)``: the call to time and
    the name of the device kernel that takes most of its time."""
    import torch.nn.functional as F

    qg, kg, vg = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    dog = do.transpose(1, 2).contiguous()
    og = F.scaled_dot_product_attention(qg, kg, vg)

    def fn():
        return torch.autograd.grad(og, (qg, kg, vg), dog, retain_graph=True)

    cuda_ms(fn, reps=1, warmup=20)
    per_kernel = kernel_ms(fn, reps=5)
    backend = max(per_kernel, key=per_kernel.get)[:120] if per_kernel else None
    return fn, backend


def flash_timing(dev, card, bytes_per_s, f32_ops, shapes=None) -> dict:
    """Each flash kernel at the main path's and the long shape (or at
    ``shapes``, ``FLASH_TIMING``'s form): CUDA-event
    ms (launch included), the profiler's device ms, the plain version's
    ms, ``F.scaled_dot_product_attention``'s forward (for K3/K4) and its
    autograd backward (for K6+K7 together) as a yardstick the port never
    calls, by CUDA events and by device time, and the bound:
    matrix-product FLOPs over the dtype's peak (f32 on the CUDA cores,
    bf16 on the tensor cores) or the bytes each input and output needs
    once over the memory rate, whichever is larger; beside it the
    tensor-core bound of the split products each kernel issues. The
    factor against the library divides device times: at these shapes
    SDPA's event time can be its host dispatch."""
    import torch.nn.functional as F

    from dml_cnn_cifar10_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(2)
    res = {}
    for label, (b, s, h, d), dtype in shapes or FLASH_TIMING:
        q, k, v, do = (torch.randn(b, s, h, d, device=dev, generator=gen)
                       .to(dtype) for _ in range(4))
        with torch.no_grad():
            out, lse = fa.flash_attention_fwd_lse(q, k, v)
            delta = fa.attention_delta(out, do)
        bwd = (q, k, v, do, lse, delta, d ** -0.5, False, None, None, 0,
               None, None)
        fns = {"flash_fwd": lambda: fa.flash_attention(q, k, v),
               "flash_fwd_lse": lambda: fa.flash_attention_fwd_lse(q, k, v),
               "flash_bwd_dq": lambda: fa._dq_launch(*bwd),
               "flash_bwd_dkv": lambda: fa._dkv_launch(*bwd)}
        plain_fwd, _ = timed_ms(lambda: fa.flash_attention_plain(q, k, v))
        plain_bwd, _ = timed_ms(lambda: fa.flash_attention_bwd_plain(
            q, k, v, do, lse, delta))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def lib_fwd_fn():
            return F.scaled_dot_product_attention(qt, kt, vt)

        lib_fwd, _ = timed_ms(lib_fwd_fn)
        lib_fwd_device = sum(kernel_ms(lib_fwd_fn).values())
        lib_fn, lib_backend = sdpa_backward(q, k, v, do)
        lib_bwd, _ = timed_ms(lib_fn)
        lib_bwd_device = sum(kernel_ms(lib_fn).values())
        del lib_fn
        elem, n, rows = q.element_size(), b * s * h * d, b * s * h
        nbytes = {"flash_fwd": 4 * n * elem,
                  "flash_fwd_lse": 4 * n * elem + 4 * rows,
                  "flash_bwd_dq": 5 * n * elem + 8 * rows,
                  "flash_bwd_dkv": 6 * n * elem + 8 * rows}
        peak = f32_ops if dtype == torch.float32 else BF16_PEAK
        for kname, fn in fns.items():
            ms, reps = timed_ms(fn)
            dms = device_ms(fn, FLASH_NEEDLES[kname], reps=min(reps, 50))
            flops = FLASH_FLOPS[kname] * b * h * s * s * d
            by_ops = flops / peak * 1e3
            by_bytes = nbytes[kname] / bytes_per_s * 1e3
            fwd = kname.startswith("flash_fwd")
            lib_dev = lib_fwd_device if fwd else lib_bwd_device
            # The split products the kernel issues on the tensor cores.
            tcf = tc_flops(kname, dtype == torch.float32) * b * h * s * s * d
            res[(kname, label)] = dict(
                shape=[b, s, h, d], dtype=str(dtype).replace("torch.", ""),
                ms=ms, device_ms=dms, plain_ms=plain_fwd if fwd else plain_bwd,
                library_ms=lib_fwd if fwd else lib_bwd,
                library_device_ms=lib_dev,
                library=("F.scaled_dot_product_attention forward" if fwd else
                         "F.scaled_dot_product_attention backward (dQ, dK "
                         f"and dV together; kernel {lib_backend})"),
                bound_ms=max(by_ops, by_bytes),
                bound_by="operations" if by_ops >= by_bytes else "bytes",
                bound_tc_ms=max(tcf / BF16_PEAK * 1e3, by_bytes),
                flops=flops, tc_flops=tcf, bytes=nbytes[kname],
                library_factor=(dms / lib_dev if fwd and dms and lib_dev
                                else None))
            r = res[(kname, label)]
            print(f"[flash timing] {kname} {label} {[b, s, h, d]} "
                  f"{r['dtype']}: kernel {ms:.5f} ms (device {dms} ms), "
                  f"plain {r['plain_ms']:.5f} ms, library "
                  f"{r['library_ms']:.5f} ms (device {lib_dev:.5f} ms"
                  + (f"; {r['library_factor']:.2f}x on device time"
                     if r["library_factor"] else "")
                  + f"), bound {r['bound_ms']:.5f} ms "
                  f"({r['bound_by']}; {flops / ms / 1e9:.1f} TFLOP/s "
                  f"achieved), tensor-core bound {r['bound_tc_ms']:.5f} ms "
                  f"({tcf / ms / 1e9:.1f} TFLOP/s issued) on {card}",
                  flush=True)
        del q, k, v, do, out, lse, delta
    return res


_GEMM = re.compile(r"gemm|xmma|cutlass|cublas", re.I)
# cuDNN's convolution kernels (checked before _GEMM: implicit-GEMM
# convolutions carry "gemm" in their names too).
_CONV = re.compile(r"convolve|dgrad|wgrad|fprop|winograd|cudnn", re.I)


def _device_rows(prof, steps):
    return sorted(((getattr(ev, "device_time_total", 0.0) / 1e3 / steps,
                    ev.count // steps, ev.key)
                   for ev in prof.key_averages() if is_device_work(ev)),
                  reverse=True)


def profile_vit(args, label, card, steps) -> dict:
    """Where one ViT training step's time goes: the step on a batch
    already on the card (CUDA events) and the device time per step split
    between the four flash kernels, the GEMMs and the rest
    (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    from dml_cnn_cifar10_tpu_torch.cli.main import (build_parser,
                                                    config_from_args)
    from dml_cnn_cifar10_tpu_torch.data import pipeline as pipe
    from dml_cnn_cifar10_tpu_torch.train.loop import Trainer

    cfg = config_from_args(build_parser().parse_args(args))
    trainer = Trainer(cfg)
    state = trainer.init_or_restore()
    it = pipe.input_pipeline(cfg.data, cfg.batch_size, train=True,
                             seed=cfg.seed)
    t0 = time.perf_counter()
    host = [next(it) for _ in range(steps)]
    host_ms = (time.perf_counter() - t0) / steps * 1e3
    images, labels = pipe.to_device(host[0], torch.device("cuda"))
    step_ms = cuda_ms(lambda: trainer.train_step(state, images, labels),
                      reps=steps, warmup=2)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            trainer.train_step(state, images, labels)
        torch.cuda.synchronize()
    rows = _device_rows(prof, steps)
    groups = {"flash kernels (K4, K6, K7)": 0.0, "GEMMs (cuBLAS)": 0.0,
              "rest": 0.0}
    for ms, _, name in rows:
        if any(n in name for n in FLASH_NEEDLES.values()):
            groups["flash kernels (K4, K6, K7)"] += ms
        elif _GEMM.search(name):
            groups["GEMMs (cuBLAS)"] += ms
        else:
            groups["rest"] += ms
    busy = sum(groups.values())
    summary = {"card": card, "label": label, "batch": cfg.batch_size,
               "tokens_per_image": trainer.model.seq,
               "step_ms_on_device_batch": step_ms, "host_batch_ms": host_ms,
               "device_busy_ms_per_step": busy,
               "device_busy_share": busy / step_ms, "groups_ms": groups,
               "kernels": [{"ms_per_step": ms, "per_step": n, "name": name}
                           for ms, n, name in rows]}
    with open(os.path.join(OUT, f"profile_{label}.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(f"[profile {label}] a step on a batch already on the card "
          f"{step_ms:.4f} ms; host batch assembly {host_ms:.4f} ms; device "
          f"busy {busy:.4f} ms/step ({100 * busy / step_ms:.1f}%): "
          + ", ".join(f"{k} {v:.4f} ms ({100 * v / busy:.1f}%)"
                      for k, v in groups.items()) + f", on {card}",
          flush=True)
    for ms, n, name in rows[:10]:
        print(f"[profile {label}]   {ms:.5f} ms/step  x{n}  {name[:110]}")
    return summary


# ---- K5 and the distributed phases (16-21) -------------------------------

# name, (B, Sq, Skv, H, D), dtype, mask. The first is the block the SP main
# path gives K5 (two ranks of the 8,100-token recipe: 4,050 tokens each,
# q/k/v as views of the fused qkv); the left/right windows are a ring
# step's neighbour shards at kv_start = -S / +S.
STATS_CASES = [
    ("sp main path", (2, 4050, 4050, 3, 64), torch.bfloat16,
     {"strided": True}),
    ("f32 128", (128, 128, 128, 3, 64), torch.float32, {}),
    ("ragged", (2, 300, 200, 3, 64), torch.float32, {}),
    ("causal", (2, 257, 257, 3, 64), torch.float32, {"causal": True}),
    ("left window", (2, 300, 300, 3, 64), torch.float32,
     {"window": 100, "kv_start": -300}),
    ("right window", (2, 300, 300, 3, 64), torch.float32,
     {"window": 100, "kv_start": 300}),
    ("segment pair", (2, 300, 300, 3, 64), torch.float32,
     {"segments": True, "causal": True}),
    ("dead rows", (1, 512, 128, 1, 64), torch.float32, {"window": 64}),
    ("bf16 causal", (2, 300, 300, 3, 64), torch.bfloat16, {"causal": True}),
    ("head dim 32", (2, 257, 257, 3, 32), torch.float32, {}),
    ("head dim 128", (2, 257, 257, 3, 128), torch.float32, {"causal": True}),
]
# K5 against its plain version: the normalized acc / l in f32 at the flash
# out pin; m and l at 1e-5 relative (both are f32 results for either input
# dtype); bf16 out at one bf16 ulp of the largest |out| (1e-2 x max|plain|,
# at most 0.05), as phase 10 holds K3/K4.
STATS_OUT_TOL, STATS_REL_TOL = 5e-6, 1e-5


def stats_parity(dev) -> dict:
    """Hold K5 against ``flash_attention_stats_plain`` on the card, case by
    case; dead rows must be exactly ``m = -1e30``, ``l = 0``, ``acc = 0``.
    Returns the worst normalized-out difference per dtype."""
    from dml_cnn_cifar10_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(3)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for name, (b, sq, skv, h, d), dtype, mask in STATS_CASES:
        kw = {k: v for k, v in mask.items() if k not in ("strided",
                                                         "segments")}
        if mask.get("strided"):
            qkv = torch.randn(b, sq, h, 3, d, device=dev,
                              generator=gen).to(dtype)
            q, k, v = qkv.unbind(3)
        else:
            q = torch.randn(b, sq, h, d, device=dev, generator=gen).to(dtype)
            k, v = (torch.randn(b, skv, h, d, device=dev, generator=gen)
                    .to(dtype) for _ in range(2))
        if mask.get("segments"):
            kw["segment_ids"] = (_segment_ids(b, sq, gen, dev),
                                 _segment_ids(b, skv, gen, dev))
        acc, m, l = fa.flash_attention_stats(q, k, v, **kw)
        pacc, pm, pl = fa.flash_attention_stats_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        check(all(t.dtype == torch.float32 for t in (acc, m, l))
              and acc.shape == (b, sq, h, d) and m.shape == l.shape
              == (b, sq, h), f"{name}: K5 gave {acc.dtype} "
              f"{tuple(acc.shape)}, {tuple(m.shape)}")
        dead = pm <= fa.NEG_INF * 0.5
        check(torch.equal(m <= fa.NEG_INF * 0.5, dead)
              and bool(torch.all(m[dead] == fa.NEG_INF))
              and bool(torch.all(l[dead] == 0))
              and bool(torch.all(acc[dead] == 0)),
              f"{name}: K5 dead rows are not m = -1e30, l = 0, acc = 0")
        live = ~dead
        out = acc[live] / l[live][:, None]
        pout = pacc[live] / pl[live][:, None]
        out_diff = (out - pout).abs().max().item() if out.numel() else 0.0
        m_rel = ((m[live] - pm[live]).abs()
                 / pm[live].abs().clamp_min(1.0)).max().item() \
            if out.numel() else 0.0
        l_rel = ((l[live] - pl[live]).abs() / pl[live]).max().item() \
            if out.numel() else 0.0
        dt = "float32" if dtype == torch.float32 else "bfloat16"
        tol = STATS_OUT_TOL if dtype == torch.float32 else min(
            BF16_CAP, BF16_REL * pout.abs().max().item())
        check(out_diff <= tol and m_rel <= STATS_REL_TOL
              and l_rel <= STATS_REL_TOL,
              f"{name}: K5 acc/l max abs diff {out_diff} (gate {tol}), m "
              f"rel {m_rel}, l rel {l_rel} (gate {STATS_REL_TOL})")
        worst[dt] = max(worst[dt], out_diff)
        print(f"[stats parity] {name:12s} {dt} {(b, sq, skv, h, d)} {mask}: "
              f"acc/l max abs diff {out_diff:.3g} (gate {tol:.3g}), m rel "
              f"{m_rel:.3g}, l rel {l_rel:.3g}; {int(dead.sum())} dead rows",
              flush=True)
        del q, k, v, acc, m, l, pacc, pm, pl
    q = torch.randn(2, 128, 3, 64, device=dev, generator=gen)
    for what, args in (("float16 inputs", (q.half(),) * 3),
                       ("a key on the host", (q, q.cpu(), q))):
        try:
            fa.flash_attention_stats(*args)
        except ValueError:
            continue
        fail(f"flash_attention_stats accepted {what}")
    return worst


# K6/K7 as the backward ring calls them: bf16 q/k/v of the SP main path's
# block (views of a fused qkv), f32 gradients (``out_dtype``), on the
# diagonal block and on a window step's neighbour shards at kv_start = -S
# and +S. Both sides write f32, so the f32 gradient pin holds.
RING_BWD_CASES = [
    ("sp main path", {}),
    ("left window", {"window": 512, "kv_start": -4050}),
    ("right window", {"window": 512, "kv_start": 4050}),
]


def ring_bwd_parity(dev) -> float:
    """Hold ``flash_attention_bwd(..., out_dtype=torch.float32)`` (K6, K7)
    against ``flash_attention_bwd_plain`` on the same inputs at [2, 4050,
    3, 64] bf16, with lse and out from the block's plain partials; dQ of
    dead rows must be exactly 0. Returns the worst max abs difference."""
    from dml_cnn_cifar10_tpu_torch.ops import flash_attention as fa

    b, s, h, d = 2, 4050, 3, 64
    gen = torch.Generator(device=dev).manual_seed(6)
    qkv = torch.randn(b, s, h, 3, d, device=dev,
                      generator=gen).to(torch.bfloat16)
    q, k, v = qkv.unbind(3)
    do = torch.randn(b, s, h, d, device=dev,
                     generator=gen).to(torch.bfloat16)
    worst = 0.0
    for name, kw in RING_BWD_CASES:
        acc, m, l = fa.flash_attention_stats_plain(q, k, v, **kw)
        live = l > 0
        lsafe = l.clamp_min(1e-30)
        lse = torch.where(live, m + torch.log(lsafe), fa.DEAD_LSE)
        out = torch.where(live[..., None], acc / lsafe[..., None],
                          0.0).to(q.dtype)
        delta = fa.attention_delta(out, do)
        want = fa.flash_attention_bwd_plain(q, k, v, do, lse, delta,
                                            out_dtype=torch.float32, **kw)
        before = (fa.LAUNCHES["flash_bwd_dq"], fa.LAUNCHES["flash_bwd_dkv"])
        got = fa.flash_attention_bwd(q, k, v, do, lse, delta,
                                     out_dtype=torch.float32, **kw)
        torch.cuda.synchronize()
        check((fa.LAUNCHES["flash_bwd_dq"], fa.LAUNCHES["flash_bwd_dkv"])
              == (before[0] + 1, before[1] + 1),
              f"ring bwd {name}: K6/K7 were not launched")
        check(all(g.dtype == torch.float32 and g.shape == w.shape
                  for g, w in zip(got, want)),
              f"ring bwd {name}: K6/K7 gave "
              f"{[(g.dtype, tuple(g.shape)) for g in got]}")
        check(bool(torch.all(got[0][~live] == 0)),
              f"ring bwd {name}: K6 dQ of dead rows is not exactly 0")
        diffs = [(g - w).abs().max().item() for g, w in zip(got, want)]
        check(max(diffs) <= FLASH_TOL["grad"],
              f"ring bwd {name}: dq/dk/dv max abs diff {diffs} > "
              f"{FLASH_TOL['grad']}")
        worst = max(worst, max(diffs))
        print(f"[ring bwd parity] {name:12s} bfloat16 -> float32 "
              f"{(b, s, h, d)} {kw}: dq/dk/dv max abs diff "
              + ", ".join(f"{x:.3g}" for x in diffs)
              + f" (gate {FLASH_TOL['grad']}; |grad| up to "
              f"{max(w.abs().max().item() for w in want):.3g}; "
              f"{int((~live).sum())} dead rows)", flush=True)
        del acc, m, l, lse, out, delta, want, got
    return worst


def stats_timing(dev, card, bytes_per_s) -> dict:
    """K5 at the SP main path's block [2, 4050, 3, 64] bf16: CUDA-event ms,
    device ms, the plain version, ``F.scaled_dot_product_attention``'s
    forward (a yardstick the port never calls; by events and by device
    time, the factor on device time), and the bound: 4·B·H·S²·D FLOPs
    over the bf16 tensor-core peak, or the bytes of q, k, v, the f32 acc
    and m, l over the memory rate, whichever is larger."""
    import torch.nn.functional as F

    from dml_cnn_cifar10_tpu_torch.ops import flash_attention as fa

    b, s, h, d = 2, 4050, 3, 64
    gen = torch.Generator(device=dev).manual_seed(4)
    q, k, v = (torch.randn(b, s, h, d, device=dev, generator=gen)
               .to(torch.bfloat16) for _ in range(3))

    def fn():
        return fa.flash_attention_stats(q, k, v)

    ms, reps = timed_ms(fn)
    dms = device_ms(fn, "flash_stats_kernel", reps=min(reps, 50))
    plain_ms, _ = timed_ms(lambda: fa.flash_attention_stats_plain(q, k, v))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def lib_fn():
        return F.scaled_dot_product_attention(qt, kt, vt)

    lib_ms, _ = timed_ms(lib_fn)
    lib_dev = sum(kernel_ms(lib_fn).values())
    n, rows = b * s * h * d, b * s * h
    flops = 4 * b * h * s * s * d
    tcf = tc_flops("flash_fwd_stats", False) * b * h * s * s * d
    nbytes = 3 * n * q.element_size() + 4 * n + 2 * 4 * rows
    by_ops, by_bytes = flops / BF16_PEAK * 1e3, nbytes / bytes_per_s * 1e3
    res = dict(shape=[b, s, h, d], dtype="bfloat16", ms=ms, device_ms=dms,
               plain_ms=plain_ms, library_ms=lib_ms,
               library_device_ms=lib_dev,
               library_factor=dms / lib_dev if dms else None,
               library="F.scaled_dot_product_attention forward",
               bound_ms=max(by_ops, by_bytes),
               bound_by="operations" if by_ops >= by_bytes else "bytes",
               bound_tc_ms=max(tcf / BF16_PEAK * 1e3, by_bytes),
               flops=flops, tc_flops=tcf, bytes=nbytes,
               tflops=flops / (dms or ms) / 1e9)
    print(f"[stats timing] flash_fwd_stats {[b, s, h, d]} bfloat16: kernel "
          f"{ms:.5f} ms (device {dms} ms), plain {plain_ms:.5f} ms, library "
          f"{lib_ms:.5f} ms (device {lib_dev:.5f} ms"
          + (f"; {res['library_factor']:.2f}x on device time"
             if res["library_factor"] else "")
          + f"), bound {res['bound_ms']:.5f} ms "
          f"({res['bound_by']}), tensor-core bound of the products it "
          f"issues {res['bound_tc_ms']:.5f} ms, {res['tflops']:.1f} TFLOP/s "
          f"achieved on device time, on {card}", flush=True)
    # The ring backward's K6/K7 at the same block, f32 gradients, on a card
    # of their own (phase 21 sees them beside the other rank's work).
    do = torch.randn(b, s, h, d, device=dev, generator=gen).to(q.dtype)
    acc, m, l = fn()
    lse = m + torch.log(l)
    delta = fa.attention_delta((acc / l[..., None]).to(q.dtype), do)
    bwd = (q, k, v, do, lse, delta, d ** -0.5, False, torch.float32, None,
           0, None, None)
    # SDPA's backward on the same unmasked block (bf16 gradients) as the
    # library time of K6 + K7 together, read A/B/B/A against the pair.
    lib_fn, lib_backend = sdpa_backward(q, k, v, do)
    plain_bwd, _ = timed_ms(lambda: fa.flash_attention_bwd_plain(
        q, k, v, do, lse, delta, out_dtype=torch.float32))
    launches = {"flash_bwd_dq": lambda: fa._dq_launch(*bwd),
                "flash_bwd_dkv": lambda: fa._dkv_launch(*bwd)}

    def pair():
        return {name: timed_ms(fn) for name, fn in launches.items()}

    def lib_read():
        return timed_ms(lib_fn)[0], sum(kernel_ms(lib_fn).values())

    lib_a = [lib_read()]
    reads = [pair(), pair()]
    lib_a.append(lib_read())
    del lib_fn
    # SDPA's backward at this block can be bound by its host dispatch
    # (autograd), so the factor divides K6 + K7's event time (they are
    # bound by the card) by SDPA's device time; its event times are kept
    # beside it.
    factors = [sum(r[0] for r in read.values()) / a[1]
               for read, a in zip(reads, lib_a)]
    lib_bwd = sum(a[0] for a in lib_a) / 2
    lib_dev = sum(a[1] for a in lib_a) / 2
    # K6 reads q, k, v, dO (bf16), lse and delta (f32) and writes dQ; K7
    # reads the same and writes dK and dV; the gradients are f32.
    grad_bytes = {"flash_bwd_dq": 4 * n, "flash_bwd_dkv": 8 * n}
    res["ring_bwd_ms"] = {}
    for name, needle in (("flash_bwd_dq", "flash_dq_kernel"),
                         ("flash_bwd_dkv", "flash_dkv_kernel")):
        kms = sum(read[name][0] for read in reads) / 2
        kflops = FLASH_FLOPS[name] * b * h * s * s * d
        tcf = tc_flops(name, False, True) * b * h * s * s * d
        kbytes = 4 * n * q.element_size() + 8 * rows + grad_bytes[name]
        by_ops, by_bytes = kflops / BF16_PEAK * 1e3, kbytes / bytes_per_s * 1e3
        res["ring_bwd_ms"][name] = dict(
            ms=kms, ms_reads=[read[name][0] for read in reads],
            device_ms=device_ms(launches[name], needle,
                                reps=min(reads[0][name][1], 50)),
            bound_ms=max(by_ops, by_bytes),
            bound_by="operations" if by_ops >= by_bytes else "bytes",
            bound_tc_ms=max(tcf / BF16_PEAK * 1e3, by_bytes),
            flops=kflops, tc_flops=tcf, bytes=kbytes,
            tflops=kflops / kms / 1e9, plain_ms=plain_bwd,
            library_ms=lib_bwd, library_ms_reads=[a[0] for a in lib_a],
            library_device_ms=lib_dev,
            library_device_ms_reads=[a[1] for a in lib_a],
            library="F.scaled_dot_product_attention backward (dQ, dK and "
                    f"dV together, bf16 gradients; kernel {lib_backend})")
    res["ring_bwd_factor"] = factors
    pair_ms = sum(r["ms"] for r in res["ring_bwd_ms"].values())
    print(f"[stats timing] the ring backward's K6/K7 at {[b, s, h, d]} "
          f"bfloat16 -> float32 (on a card alone): "
          + "; ".join(f"{k} {r['ms']:.5f} ms (reads {r['ms_reads'][0]:.5f}, "
                      f"{r['ms_reads'][1]:.5f}; device {r['device_ms']} ms), "
                      f"bound {r['bound_ms']:.5f} ms ({r['bound_by']}), "
                      f"tensor-core bound {r['bound_tc_ms']:.5f} ms, "
                      f"{r['tflops']:.1f} TFLOP/s"
                      for k, r in res["ring_bwd_ms"].items())
          + f"; K6 + K7 {pair_ms:.5f} ms against SDPA's backward "
          f"{lib_dev:.5f} ms of device time (reads A/B/B/A "
          f"{lib_a[0][1]:.5f}, {lib_a[1][1]:.5f}; by CUDA events "
          f"{lib_a[0][0]:.5f}, {lib_a[1][0]:.5f}; kernel {lib_backend}): "
          f"{sum(factors) / 2:.2f}x ({min(factors):.2f}-{max(factors):.2f}"
          f"x), and the plain backward's {plain_bwd:.5f} ms on {card}",
          flush=True)
    return res


def _free_ports(n):
    import socket
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def spawn_ranks(label: str, job: dict, world: int = 2,
                timeout_s: float = 600.0) -> list:
    """Run ``job`` on ``world`` rank processes (this script with
    ``--rank``), each logging to ``OUT/ranks/<label>.rank<r>.log``; fails
    unless every rank exits 0 in time. Returns the ranks' result dicts."""
    rank_dir = os.path.join(OUT, "ranks")
    os.makedirs(rank_dir, exist_ok=True)
    job = dict(job, out=os.path.join(rank_dir, f"{label}.rank{{rank}}.json"))
    job_path = os.path.join(rank_dir, f"{label}.job.json")
    with open(job_path, "w") as f:
        json.dump(job, f)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    procs, logs = [], []
    for r in range(world):
        log = open(os.path.join(rank_dir, f"{label}.rank{r}.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank", str(r),
             "--job", job_path], cwd=ROOT, env=env, stdout=log,
            stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    rcs = [p.returncode for p in procs]
    if any(rc != 0 for rc in rcs):
        for r in range(world):
            with open(os.path.join(rank_dir, f"{label}.rank{r}.log")) as f:
                tail = f.read()[-3000:]
            print(f"[{label}] rank {r} exit {rcs[r]}; log tail:\n{tail}",
                  file=sys.stderr)
        fail(f"{label}: ranks exited {rcs}")
    results = []
    for r in range(world):
        with open(job["out"].format(rank=r)) as f:
            results.append(json.load(f))
    return results


def rank_log(label: str, rank: int = 0):
    with open(os.path.join(OUT, "ranks", f"{label}.rank{rank}.log")) as f:
        return f.read().splitlines()


def _rank_parts(rank: int, job: dict) -> dict:
    """Several rank jobs (``job["parts"]``, each with its ``label`` and
    ``kind``) run in order in this one rank process, so a process's start
    and its first trainer's set-up are paid once: each part's result, with
    the launches it counted and its wall seconds, under its label; each
    part's console goes to its own ``OUT/ranks/<label>.rank<r>.log`` as a
    spawn of its own would write it."""
    from dml_cnn_cifar10_tpu_torch.ops import flash_attention as fa
    from dml_cnn_cifar10_tpu_torch.ops import optimizer as fused
    out = {}
    for part in job["parts"]:
        fused.reset_launches()
        fa.reset_launches()
        t0 = time.perf_counter()
        path = os.path.join(OUT, "ranks", f"{part['label']}.rank{rank}.log")
        with open(path, "w") as log, \
                contextlib.redirect_stdout(_Tee(sys.stdout, log)):
            res = RANK_KINDS[part["kind"]](rank, part)
        res.setdefault("launches", {**fa.LAUNCHES, **fused.LAUNCHES})
        res["part_wall_s"] = time.perf_counter() - t0
        out[part["label"]] = res
    return {"parts": out}


def spawn_parts(label: str, parts: list, world: int = 2,
                timeout_s: float = 900.0) -> dict:
    """``parts`` (rank jobs with a ``label`` each) on one spawn of
    ``world`` rank processes (``_rank_parts``): ``{label: the ranks'
    results}``, as ``spawn_ranks`` of each would return them."""
    ranks = spawn_ranks(label, {"kind": "parts", "parts": parts}, world,
                        timeout_s)
    return {p["label"]: [r["parts"][p["label"]] for r in ranks]
            for p in parts}


def _dist_args_n(k: int, world: int, backend: str) -> list:
    """``k`` argument lists of ``_dist_args`` on distinct free ports (one
    pool, for parts that run in turn in one spawn)."""
    ports = _free_ports(k * world)
    return [["--worker_hosts", ",".join(
        f"localhost:{p}" for p in ports[i * world:(i + 1) * world]),
        "--dist_backend", backend] for i in range(k)]


def _whole_params(state) -> dict:
    """``state``'s parameters whole: gathered over the data ranks where
    its layout keeps shards and over the model ranks where it holds model
    slices (a collective: every rank calls it)."""
    from dml_cnn_cifar10_tpu_torch.parallel import tp, zero
    return tp.whole(state, "params", zero.whole(state, "params",
                                                state.params))


def _params_digest(params) -> str:
    import hashlib
    h = hashlib.sha256()
    for name in sorted(params):
        h.update(name.encode())
        h.update(params[name].detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def _rank_cli(rank: int, job: dict) -> dict:
    """``cli.main.main`` as this rank; the trainer's final state is kept
    for the parameter digest."""
    from dml_cnn_cifar10_tpu_torch.cli.main import main
    from dml_cnn_cifar10_tpu_torch.train import loop

    fit, kept = loop.Trainer.fit, {}

    def fit_and_keep(self, *args, **kwargs):
        kept["result"] = fit(self, *args, **kwargs)
        return kept["result"]

    loop.Trainer.fit = fit_and_keep
    rc = main(job["argv"] + ["--task_index", str(rank)])
    res = {"rc": rc}
    if "result" in kept:
        res["digest"] = _params_digest(kept["result"].state.params)
    return res


# name, global [B, S, H, D], dtype, mask: the 2-rank ring op against the
# one-rank flash_attention of the full sequence (K4 forward, K6/K7
# backward). The last is the SP main path's own shape.
RING_OP_CASES = [
    ("full", (2, 2048, 3, 64), "float32", {}),
    ("causal", (2, 2048, 3, 64), "float32", {"causal": True}),
    ("window", (2, 2048, 3, 64), "float32", {"window": 512}),
    ("long context", (2, 8100, 3, 64), "bfloat16", {}),
]
# The pins of tests/test_ring_attention.py in f32; bf16 as phase 10's.
RING_OP_TOL = {"out": 2e-5, "grad": 5e-5}


def _rank_ring(rank: int, job: dict) -> dict:
    """The 2-rank ring op on the card against the full-sequence flash
    attention; returns the max abs differences and reference scales of
    this rank's shard."""
    import torch.distributed as dist

    from dml_cnn_cifar10_tpu_torch.config import ParallelConfig
    from dml_cnn_cifar10_tpu_torch.ops import flash_attention as fa
    from dml_cnn_cifar10_tpu_torch.parallel import mesh as mesh_lib
    from dml_cnn_cifar10_tpu_torch.parallel import multihost
    from dml_cnn_cifar10_tpu_torch.parallel import ring_attention as ring

    par = ParallelConfig(seq_axis=2, coordinator_address=job["address"],
                         num_processes=2, process_id=rank)
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    multihost.initialize(par, job["backend"], dev)
    mesh = mesh_lib.build_mesh(par)
    gen = torch.Generator(device=dev).manual_seed(5)
    res = {}
    for name, (b, s, h, d), dtype, kw in RING_OP_CASES:
        q, k, v, do = (torch.randn(b, s, h, d, device=dev, generator=gen)
                       .to(getattr(torch, dtype)) for _ in range(4))
        full = [t.clone().requires_grad_() for t in (q, k, v)]
        ref = fa.flash_attention(*full, **kw)
        ref_g = torch.autograd.grad(ref, full, do)
        mine = [ring.seq_shard(t, mesh).detach().clone().requires_grad_()
                for t in (q, k, v)]
        out = ring.ring_attention_local(*mine, mesh, **kw)
        got_g = torch.autograd.grad(out, mine, ring.seq_shard(do, mesh))
        torch.cuda.synchronize()
        res[name] = {}
        for what, g, w in zip(("out", "dq", "dk", "dv"), (out, *got_g),
                              (ref, *ref_g)):
            w = ring.seq_shard(w, mesh).float()
            res[name][what] = [(g.float() - w).abs().max().item(),
                               w.abs().max().item()]
        del q, k, v, do, full, ref, ref_g, mine, out, got_g
    mesh.barrier()
    dist.destroy_process_group()
    return res


FLASH_GROUPS = {"K4 flash_lse_kernel": "flash_lse_kernel",
                "K5 flash_stats_kernel": "flash_stats_kernel",
                "K6 flash_dq_kernel": "flash_dq_kernel",
                "K7 flash_dkv_kernel": "flash_dkv_kernel"}
# Work of the ring hops and the gradient/pool all-reduces: NCCL's kernels,
# or on gloo the copies through host memory and gloo's own events.
_COMM = re.compile(r"nccl|gloo|Memcpy DtoH|Memcpy HtoD", re.I)


def _union_ms(spans) -> float:
    """Length of the union of ``(start, end)`` intervals in µs, as ms."""
    total, reach = 0.0, -math.inf
    for start, end in sorted(spans):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total / 1e3


def device_timeline(prof, steps: int) -> dict:
    """Per-step device time of this process from the trace's timeline
    (torch.profiler's device events with their start and end): the union
    of the intervals of its compute kernels over every stream, the union
    of its communication work (``_COMM``), and the time both ran at once.
    A sum of kernel times overcounts where streams overlap — NCCL's
    kernels spin on their own stream until the peer arrives — the union
    does not. Also the summed time of K5, K6 and K7."""

    compute, comm = [], []
    groups = {g: 0.0 for g in FLASH_GROUPS}
    for ev in prof.events():
        if not is_device_work(ev):
            continue
        span = (ev.time_range.start, ev.time_range.end)
        (comm if _COMM.search(ev.name) else compute).append(span)
        for group, needle in FLASH_GROUPS.items():
            if needle in ev.name:
                groups[group] += (span[1] - span[0]) / 1e3 / steps
    check(bool(compute), "the profile traced no device kernel")
    c_ms, n_ms = _union_ms(compute) / steps, _union_ms(comm) / steps
    any_ms = _union_ms(compute + comm) / steps
    return {"compute_ms": c_ms, "comm_ms": n_ms,
            "overlap_ms": c_ms + n_ms - any_ms, "device_any_ms": any_ms,
            "flash_ms": groups}


def _rank_profile(rank: int, job: dict) -> dict:
    """One SP training step of this rank: its host-clock time over a few
    steps on a batch already on the card, and its device timeline
    (``device_timeline``): compute busy time, the hops and all-reduces,
    their overlap, and K5/K6/K7."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from dml_cnn_cifar10_tpu_torch.cli.main import (build_parser,
                                                    config_from_args)
    from dml_cnn_cifar10_tpu_torch.data import pipeline as pipe
    from dml_cnn_cifar10_tpu_torch.train.loop import Trainer

    steps = job["steps"]
    cfg = config_from_args(build_parser().parse_args(
        job["argv"] + ["--task_index", str(rank)]))
    trainer = Trainer(cfg, task_index=rank)
    state = trainer.init_or_restore()
    it = trainer.input_pipeline(train=True, seed=cfg.seed)
    images, labels = pipe.to_device(next(it), trainer.device)
    trainer.train_step(state, images, labels)
    torch.cuda.synchronize()
    trainer.mesh.barrier()
    t0 = time.perf_counter()
    for _ in range(steps):
        trainer.train_step(state, images, labels)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    trainer.mesh.barrier()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            trainer.train_step(state, images, labels)
        torch.cuda.synchronize()
    rows = _device_rows(prof, steps)
    timeline = device_timeline(prof, steps)
    trainer.mesh.barrier()
    dist.destroy_process_group()
    return {"step_ms": step_ms, **timeline,
            "compute_share": timeline["compute_ms"] / step_ms,
            "kernels": [{"ms_per_step": ms, "per_step": n, "name": name}
                        for ms, n, name in rows[:25]]}


def check_ring_op(ring_res, backend: str) -> None:
    """Hold the ranks' ring-op differences to their pins."""
    for name, _, dtype, kw in RING_OP_CASES:
        for what in ("out", "dq", "dk", "dv"):
            diff = max(r[name][what][0] for r in ring_res)
            scale = max(r[name][what][1] for r in ring_res)
            kind_ = "out" if what == "out" else "grad"
            tol = RING_OP_TOL[kind_] if dtype == "float32" else min(
                BF16_CAP, BF16_REL * scale)
            check(diff <= tol, f"ring op {name}: {what} max abs diff "
                               f"{diff} > {tol}")
        print(f"[ring op] {name} {dtype} {kw} ({backend}): max abs diff vs "
              f"the full sequence's flash attention " + ", ".join(
                  f"{w} {max(r[name][w][0] for r in ring_res):.3g}"
                  for w in ("out", "dq", "dk", "dv")), flush=True)


def sp_launches(steps: int, fwd_only: int) -> dict:
    """Per-rank launches of ``steps`` SP steps at seq 2 with remat: K5 = 12
    blocks x 2 ring steps x 2, K6 = K7 = 12 x 2; K5 = 24 for each
    forward-only batch; K3 = K4 = K1 = K2 = 0."""
    return {"flash_fwd": 0, "flash_fwd_lse": 0,
            "flash_fwd_stats": steps * 48 + fwd_only * 24,
            "flash_bwd_dq": steps * 24, "flash_bwd_dkv": steps * 24,
            "sgd_update_plain": 0, "sgd_update_momentum": 0}


# Every logged SP loss against the same recipe and batches without the
# ring. Measured on H100s (PERF.md): at most 1.7e-4 apart at step 5
# (bf16 sums in another order) and 2.4e-6 at step 10, so 1e-3 leaves room
# for rounding while a wrong softmax weight or gradient sum lands far
# outside it.
SP_LOSS_TOL = 1e-3


def long_args(work: str) -> list:
    """The long-context recipe (``BASELINE.md:523``: 368/360 images, 8,100
    tokens, mean pool, remat, bf16, AdamW) without its batch size."""
    return ["--model", "vit_tiny", "--dataset", "synthetic",
            "--data_dir", os.path.join(work, "data_long"),
            "--image_size", "368", "--crop_size", "360", "--pool", "mean",
            "--remat", "true", "--compute_dtype", "bfloat16",
            "--optimizer", "adamw", "--learning_rate", "3e-4",
            "--synthetic_train_records", "64", "--fidelity", "fixed",
            "--output_every", "5", "--eval_every", "1000",
            "--checkpoint_every", "1000", "--peak_tflops", BF16_PEAK_TFLOPS]


def cnn_args(work: str) -> list:
    """The CNN main path's recipe: batch 128 on 50,000 synthetic records."""
    return ["--dataset", "synthetic", "--data_dir",
            os.path.join(work, "data"), "--synthetic_train_records",
            "50000", "--fidelity", "fixed", "--learning_rate", "0.02",
            "--batch_size", "128", "--peak_tflops", F32_PEAK_TFLOPS]


def train_log(path) -> list:
    return [(r["step"], r["loss"], r["images_per_sec"])
            for r in records(path) if r["kind"] == "train"]


def dist_phases(backend: str, card: str, worlds=(2,),
                one_rank_jsonl=None) -> dict:
    """Phases 18-21 over ``backend``, each rank a process of its own: the
    2-rank ring op; for each world in ``worlds``, the SP long-context
    recipe on ``world`` ranks (data world/2 x seq 2, 2 images a data row)
    against the same batches without the ring — one rank
    (``one_rank_jsonl``, or run here) or the world/2 data ranks alone —
    then, on 2 ranks, a resume to step 15 and ``--mode eval``; the DP CNN
    on each world; the 2-rank SP profile. Returns the numbers."""
    count = torch.cuda.device_count()

    def dist_args(world):
        return _dist_args(world, backend)

    res = {"card": card, "backend": backend, "cards": count}
    long = long_args(WORK)
    # Every 2-rank job of phases 18-21 on one spawn of 2 rank processes
    # (a process's start and a trainer's first set-up paid once), in the
    # order the checks below read them.
    sp_log = os.path.join(WORK, "logs_sp2")
    a = _dist_args_n(5, 2, backend)
    parts = spawn_parts(f"dist2_{backend}", [
        {"label": f"ring_op_{backend}", "kind": "ring", "backend": backend,
         "address": f"localhost:{_free_ports(1)[0]}"},
        {"label": f"sp2_{backend}", "kind": "cli", "argv": long + [
            "--batch_size", "2", "--seq_axis", "2", "--total_steps",
            str(LONG_STEPS), "--log_dir", sp_log, "--metrics_jsonl",
            os.path.join(WORK, "vit_sp2.jsonl")] + a[0]},
        {"label": f"sp_resume_{backend}", "kind": "cli", "argv": long + [
            "--batch_size", "2", "--seq_axis", "2", "--log_dir", sp_log,
            "--total_steps", str(LONG_STEPS + 5)] + a[1]},
        {"label": f"sp_eval_{backend}", "kind": "cli", "argv": long + [
            "--seq_axis", "2", "--log_dir", sp_log, "--batch_size", "8",
            "--mode", "eval"] + a[2]},
        {"label": f"dp2_{backend}", "kind": "cli", "argv": cnn_args(WORK) + [
            "--log_dir", os.path.join(WORK, "logs_dp2"),
            "--total_steps", str(DP_STEPS), "--eval_every", "1000",
            "--output_every", "50", "--checkpoint_every", "1000",
            "--metrics_jsonl", os.path.join(WORK, "cnn_dp2.jsonl")] + a[3]},
        {"label": f"sp_profile_{backend}", "kind": "profile", "steps": 2,
         "argv": long + ["--batch_size", "2", "--seq_axis", "2",
                         "--log_dir", os.path.join(WORK, "logs_sp_profile")]
         + a[4]}])

    def spawned(label, job, world=2, timeout_s=600.0):
        """The ranks' results of ``label``: from the spawn above when it
        ran there, else from a spawn of its own."""
        if label in parts:
            return parts[label]
        return spawn_ranks(label, job, world, timeout_s)

    # ---- 18. the 2-rank ring op ------------------------------------------
    ring_res = spawned(f"ring_op_{backend}", None)
    check_ring_op(ring_res, backend)
    res["ring_op"] = ring_res

    # ---- 19. SP long context: 4,050 tokens a rank ------------------------
    for world in worlds:
        batch = world
        ref_jsonl = one_rank_jsonl if world == 2 else None
        if ref_jsonl is None:
            ref_jsonl = os.path.join(WORK, f"ref{world}.jsonl")
            ref_args = long + ["--batch_size", str(batch), "--total_steps",
                               str(LONG_STEPS), "--log_dir",
                               os.path.join(WORK, f"logs_ref{world}"),
                               "--metrics_jsonl", ref_jsonl]
            if world == 2:
                run_cli(ref_args)
            else:
                spawn_ranks(f"dp_vit{world // 2}_{backend}", {
                    "kind": "cli", "argv": ref_args + dist_args(world // 2)},
                    world=world // 2)
        sp_log = os.path.join(WORK, f"logs_sp{world}")
        sp_jsonl = os.path.join(WORK, f"vit_sp{world}.jsonl")
        t0 = time.perf_counter()
        sp = spawned(f"sp{world}_{backend}", {"kind": "cli", "argv": long
                     + ["--batch_size", str(batch), "--seq_axis", "2",
                        "--total_steps", str(LONG_STEPS), "--log_dir",
                        sp_log, "--metrics_jsonl", sp_jsonl]
                     + dist_args(world)}, world=world)
        wall = sp[0].get("part_wall_s", time.perf_counter() - t0)
        # The fresh-batch train accuracy every 5 steps is a forward-only
        # batch.
        want = sp_launches(LONG_STEPS, LONG_STEPS // 5)
        check(all(r["launches"] == want for r in sp),
              f"SP {world} ranks launched {[r['launches'] for r in sp]}, "
              f"want {want}")
        check(len({r["digest"] for r in sp}) == 1,
              f"SP {world} ranks ended with different parameters")
        got, ref = train_log(sp_jsonl), train_log(ref_jsonl)
        gaps = [abs(g[1] - r[1]) for g, r in zip(got, ref)]
        check(len(got) == len(ref) == LONG_STEPS // 5
              and [g[0] for g in got] == [r[0] for r in ref]
              and all(math.isfinite(g[1]) for g in got)
              and max(gaps) <= SP_LOSS_TOL,
              f"SP {world} ranks (step, loss, images/s) {got}; without the "
              f"ring {ref}; gaps {gaps} (gate {SP_LOSS_TOL})")
        res[f"sp{world}"] = {
            "batch": batch, "train": got, "reference": ref,
            "loss_gaps": gaps, "step_ms": batch / got[-1][2] * 1e3,
            "tokens_per_s": got[-1][2] * 8100, "wall_s": wall,
            "launches": sp[0]["launches"]}
        shutil.copy(sp_jsonl, OUT)
        print(f"[sp train] {world} ranks (data {world // 2} x seq 2, "
              f"{backend}), batch {batch} x 8,100 tokens: (step, loss, "
              f"images/s) {got}; without the ring ({max(1, world // 2)} "
              f"rank(s)) {ref}; loss gaps {gaps} (gate {SP_LOSS_TOL}); "
              f"{res[f'sp{world}']['step_ms']:.1f} ms/step in steps 6-10; "
              f"launches per rank {sp[0]['launches']}, equal parameters, on "
              f"{min(count, world)} x {card}", flush=True)
        if world != 2:
            continue
        # resume to 15, then --mode eval, both over the 2 ranks
        label = f"sp_resume_{backend}"
        resume = spawned(label, None)
        for r in resume:
            check(r["launches"]["flash_fwd_stats"] == 5 * 48 + 24
                  and r["launches"]["flash_bwd_dq"] == 5 * 24,
                  f"SP resume ran {r['launches']}, want 5 steps from step "
                  f"{LONG_STEPS}")
        steps = [int(m[1]) for m in map(STEP_LINE.match, rank_log(label))
                 if m]
        check(steps == [LONG_STEPS + 5], f"SP resume printed steps {steps}")
        # The full test split (512 records) at 8 images a batch.
        label = f"sp_eval_{backend}"
        ev = spawned(label, None)
        eval_lines = []
        for r in range(2):
            lines = rank_log(label, r)
            check(any(f"eval at step {LONG_STEPS + 5}" in l for l in lines),
                  f"SP eval rank {r} did not restore step {LONG_STEPS + 5}")
            eval_lines.append([m[1] for m in map(EVAL_LINE.match, lines)
                               if m])
        check(len(eval_lines[0]) == 1 and eval_lines[0] == eval_lines[1],
              f"SP --mode eval printed {eval_lines}")
        check(ev[0]["launches"]["flash_fwd_stats"] == 64 * 24,
              f"SP eval launched {ev[0]['launches']} (64 batches of 8)")
        res["sp_eval_accuracy"] = eval_lines[0][0]
        print(f"[sp resume] continued {LONG_STEPS} -> {LONG_STEPS + 5}; "
              f"--mode eval over 2 ranks: {eval_lines[0][0]}% on both",
              flush=True)

    # ---- 20. data-parallel CNN: 128 images over the world ----------------
    for world in worlds:
        dp_jsonl = os.path.join(WORK, f"cnn_dp{world}.jsonl")
        dp = spawned(f"dp{world}_{backend}", {"kind": "cli", "argv":
                     cnn_args(WORK) + [
            "--log_dir", os.path.join(WORK, f"logs_dp{world}"),
            "--total_steps", str(DP_STEPS), "--eval_every", "1000",
            "--output_every", "50", "--checkpoint_every", "1000",
            "--metrics_jsonl", dp_jsonl] + dist_args(world)}, world=world)
        for r in dp:
            check(r["launches"]["sgd_update_plain"] == DP_STEPS
                  and r["launches"]["sgd_update_momentum"] == 0,
                  f"DP {world} ranks launched {[r['launches'] for r in dp]}, "
                  f"want K1 = {DP_STEPS} (one a step) each")
        check(len({r["digest"] for r in dp}) == 1,
              f"DP {world} ranks ended with different parameters")
        losses = [l for _, l, _ in train_log(dp_jsonl)]
        check(losses and all(math.isfinite(l) for l in losses),
              f"DP {world} ranks losses {losses}")
        ips = next(r for r in records(dp_jsonl)
                   if r["kind"] == "done")["images_per_sec"]
        res[f"dp{world}"] = {"losses": losses, "images_per_s": ips,
                             "step_ms": 128 / ips * 1e3,
                             "launches": dp[0]["launches"]}
        shutil.copy(dp_jsonl, OUT)
        print(f"[dp cnn] {DP_STEPS} steps, {world} ranks x {128 // world} "
              f"images ({backend}): loss {losses}, {ips:.1f} images/s = "
              f"{128 / ips * 1e3:.3f} ms/step over the run; K1 "
              f"{dp[0]['launches']['sgd_update_plain']} per rank, equal "
              f"parameters, on {min(count, world)} x {card}", flush=True)

    # ---- 21. where an SP step's time goes --------------------------------
    prof = spawned(f"sp_profile_{backend}", None)
    res["sp_profile"] = prof
    for r, p in enumerate(prof):
        print(f"[sp profile] rank {r} ({backend}): {p['step_ms']:.2f} "
              f"ms/step (host clock, batch on the card); device timeline a "
              f"step: compute {p['compute_ms']:.2f} ms "
              f"({100 * p['compute_share']:.1f}% of the step), hops and "
              f"all-reduces {p['comm_ms']:.2f} ms, of which "
              f"{p['overlap_ms']:.2f} ms beside compute; "
              + ", ".join(f"{k} {v:.2f}" for k, v in p["flash_ms"].items())
              + f"; on {card}", flush=True)
        for k in p["kernels"][:8]:
            print(f"[sp profile]   rank {r} {k['ms_per_step']:.4f} ms/step "
                  f"x{k['per_step']} {k['name'][:100]}")
    return res


# ---- serving: export, K3 through its operator, graphs, HTTP (22-25) ------

SERVE_BUCKETS = (1, 8, 32, 128)
SERVE_CONCURRENCY = (1, 32, 128)
SERVE_RUN_S = 1.0
# Closed-loop runs at each concurrency: one, to keep the script inside its
# time limit.
SERVE_REPS = 1
# Graph replay against the eager forward, and the artifact against the
# live engine: the same kernels on the same inputs, held to 1e-5 of the
# largest logit (a capture that read the wrong buffer or weights misses
# it by orders of magnitude).
SERVE_REL = 1e-5
# A response's logits against its version's forward at another batch
# size: cuBLAS may pick another kernel for another M, so rows can differ
# in their last bits; two checkpoints 100 steps apart differ by far more.
SWAP_TOL = 1e-4
# Check-set images whose two largest direct logits are closer than this
# (relative) are left out of the class check: their argmax may flip with
# the batch a request lands in. Their count is printed.
MARGIN = 1e-4
# K3 at the serving shapes, as the ViT-Ti gives them: [b, 257, 3, 64]
# f32, q/k/v views of one fused qkv.
SERVE_K3_TIMED = (1, 128)


def _rel(a, b) -> float:
    import numpy as np
    return float(np.abs(a - b).max() / max(float(np.abs(b).max()), 1e-30))


def _host_ms(fn, reps) -> float:
    """Median host ms of ``fn()`` (which ends in a device read) over
    ``reps`` calls after two warm-up calls."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def _copies(fn, reps=10, traces=5) -> dict:
    """Host-to-device and device-to-host copies of ``reps`` calls of
    ``fn()``, by the profiler's memcpy events. A trace drops some of them
    (seen on the card: 7 to 9 of 10, the first ones), so a count bounds
    the copies from below: the caller checks the upper bound, which a
    weight copy (one a leaf, 10 or more a batch) would break. The calls
    start 50 ms into the trace, in case the tracer starts late. A trace
    that holds no copy at all (seen on the card in 1 to 2 of 16 traces
    of a call, both directions empty) recorded nothing: it is traced
    again, at most ``traces`` times in all, and ``traces`` in the result
    says how many it took. A function that really copies nothing fails
    every trace the same."""
    from torch.profiler import ProfilerActivity, profile
    for n in range(1, traces + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(0.05)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        out = {"HtoD": 0, "DtoH": 0}
        for ev in prof.key_averages():
            for kind in out:
                if f"Memcpy {kind}" in ev.key:
                    out[kind] += ev.count
        if out["HtoD"] + out["DtoH"]:
            break
    return {**out, "traces": n}


def _batch_profile(eng, x, reps=20) -> dict:
    """Where a served batch's time goes: the host ms of one
    ``forward_timed`` (input copy, replay, logits back) beside the
    device's busy ms a batch by kernel group, from ``reps`` traced
    batches."""
    from torch.profiler import ProfilerActivity, profile

    eng.forward_timed(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        eng.forward_timed(x)
    host_ms = (time.perf_counter() - t0) / reps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            eng.forward_timed(x)
        torch.cuda.synchronize()
    groups = dict.fromkeys(("flash (K3)", "convolutions (cuDNN)",
                            "GEMMs (cuBLAS)", "copies", "rest"), 0.0)
    for ms, _, name in _device_rows(prof, reps):
        groups["flash (K3)" if "flash_out_kernel" in name
               else "copies" if "Memcpy" in name
               else "convolutions (cuDNN)" if _CONV.search(name)
               else "GEMMs (cuBLAS)" if _GEMM.search(name)
               else "rest"] += ms
    busy = sum(groups.values())
    return {"host_ms": host_ms, "device_busy_ms": busy,
            "device_busy_share": busy / host_ms, "groups_ms": groups}


def serve_k3(dev, card, bytes_per_s, f32_ops) -> dict:
    """K3 through the registered operator at the four serving shapes
    against its plain version (f32 out pin 5e-6), then timed at b = 1 and
    128: CUDA events, device time, the plain version, SDPA (a yardstick
    the port never calls) and the bound."""
    import torch.nn.functional as F

    from dml_cnn_cifar10_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(3)
    worst, res = 0.0, {}
    fa.reset_launches()
    for b in SERVE_BUCKETS:
        q, k, v = torch.randn(b, 257, 3, 3, 64, device=dev,
                              generator=gen).unbind(3)
        with torch.no_grad():
            got = torch.ops.dml_torch.flash_attention_out(
                q, k, v, None, None, 64 ** -0.5, False, None)
            via = fa.flash_attention(q, k, v)
            want = fa.flash_attention_plain(q, k, v)[0]
        torch.cuda.synchronize()
        diff = (got - want).abs().max().item()
        check(torch.equal(got, via), f"K3 at b={b}: flash_attention and "
              "the operator disagree")
        check(diff <= FLASH_TOL["out"],
              f"K3 at [{b}, 257, 3, 64] through the operator: max abs diff "
              f"{diff} > {FLASH_TOL['out']}")
        worst = max(worst, diff)
        print(f"[serve k3] [{b}, 257, 3, 64] f32 (views of a fused qkv) "
              f"through dml_torch::flash_attention_out: max abs diff "
              f"{diff:.3g} vs the plain version", flush=True)
        if b not in SERVE_K3_TIMED:
            continue

        def fn():
            return torch.ops.dml_torch.flash_attention_out(
                q, k, v, None, None, 64 ** -0.5, False, None)

        ms, reps = timed_ms(fn)
        dms = device_ms(fn, "flash_out_kernel", reps=min(reps, 50))
        plain_ms, _ = timed_ms(lambda: fa.flash_attention_plain(q, k, v))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def lib_fn():
            return F.scaled_dot_product_attention(qt, kt, vt)

        lib_ms, _ = timed_ms(lib_fn)
        lib_dev = sum(kernel_ms(lib_fn).values())
        flops = FLASH_FLOPS["flash_fwd"] * b * 3 * 257 * 257 * 64
        nbytes = 4 * b * 257 * 3 * 64 * 4
        by_ops, by_bytes = flops / f32_ops * 1e3, nbytes / bytes_per_s * 1e3
        # The split-bf16 products K3 issues on the tensor cores.
        tcf = tc_flops("flash_fwd", True) * b * 3 * 257 * 257 * 64
        res[b] = dict(shape=[b, 257, 3, 64], dtype="float32", ms=ms,
                      device_ms=dms, plain_ms=plain_ms, library_ms=lib_ms,
                      library_device_ms=lib_dev,
                      library="F.scaled_dot_product_attention forward",
                      bound_ms=max(by_ops, by_bytes),
                      bound_by="operations" if by_ops >= by_bytes
                      else "bytes",
                      bound_tc_ms=max(tcf / BF16_PEAK * 1e3, by_bytes),
                      flops=flops, tc_flops=tcf, bytes=nbytes,
                      blocks=b * 3 * math.ceil(257 / 64))
        print(f"[serve k3] timed [{b}, 257, 3, 64] f32: kernel {ms:.5f} ms "
              f"(device {dms} ms), plain {plain_ms:.5f} ms, SDPA "
              f"{lib_ms:.5f} ms (device {lib_dev:.5f} ms), bound "
              f"{res[b]['bound_ms']:.5f} ms ({res[b]['bound_by']}), "
              f"tensor-core bound {res[b]['bound_tc_ms']:.5f} ms of the "
              f"split products it issues, on {card}", flush=True)
    return {"worst": worst, "timed": res}


def _check_set(engine, images, path) -> int:
    """Write the ``--check_labels`` npz: the images whose direct forward
    (the engine's eager forward, in batches of 128) has a clear argmax,
    labelled with it. Returns how many were left out."""
    import numpy as np
    logits = np.concatenate([engine.forward_eager(images[i:i + 128])
                             for i in range(0, len(images), 128)])
    top2 = np.sort(logits, axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > MARGIN * np.maximum(
        1.0, np.abs(top2[:, 1]))
    np.savez(path, images=images[clear], labels=logits[clear].argmax(1))
    return int((~clear).sum())


def _serve_thread(args, engine=None):
    """``--mode serve`` of ``args`` in a thread with ready and stop events
    (``main_serve`` with the CLI's config; ``engine`` serves a caller's
    engine): ``(thread, stop_event, url, cfg, rc)`` once it is ready."""
    import threading

    from dml_cnn_cifar10_tpu_torch.cli.main import (build_parser,
                                                    config_from_args)
    from dml_cnn_cifar10_tpu_torch.serve.server import main_serve

    port = _free_ports(1)[0]
    cfg = config_from_args(build_parser().parse_args(
        args + ["--mode", "serve", "--serve_port", str(port)]))
    print("$ python -m dml_cnn_cifar10_tpu_torch " + " ".join(args)
          + f" --mode serve --serve_port {port}", flush=True)
    ready, stop, rc = threading.Event(), threading.Event(), {}

    def run():
        rc["rc"] = main_serve(cfg, ready_event=ready, stop_event=stop,
                              engine=engine)

    t = threading.Thread(target=run, name="serve-main", daemon=True)
    t.start()
    while not ready.wait(1.0):
        check(t.is_alive(), f"--mode serve of {args} died during warm-up")
    return t, stop, f"http://127.0.0.1:{port}", cfg, rc


def _stop_serve(t, stop, rc, what) -> None:
    stop.set()
    t.join(120)
    check(not t.is_alive() and rc.get("rc") == 0,
          f"{what}: the server did not drain and exit 0")


def _loadgen(argv, label) -> dict:
    """The port's load generator in a process of its own (its client
    threads do not share the server's interpreter lock)."""
    report = os.path.join(OUT, f"loadgen_{label}.json")
    cmd = [sys.executable, "-m", "dml_cnn_cifar10_tpu_torch.tools.loadgen",
           *argv, "--report", report]
    env = {**os.environ, "PYTHONPATH": ROOT + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    p = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=300)
    check(p.returncode == 0, f"loadgen {label} exited {p.returncode}: "
          f"{p.stderr[-2000:]}")
    with open(report) as f:
        return json.load(f)


def serve_phases(card, dev, cnn_cli, vit_cli, bytes_per_s, f32_ops) -> dict:
    """Phases 22-25 on phase 6's CNN checkpoint (step 600) and phase 13's
    ViT-Ti checkpoint (step 300). ``cnn_cli`` and ``vit_cli`` are their
    CLI arguments, ``--log_dir`` included."""
    import numpy as np

    from dml_cnn_cifar10_tpu_torch import export as export_lib
    from dml_cnn_cifar10_tpu_torch.cli.main import (build_parser,
                                                    config_from_args)
    from dml_cnn_cifar10_tpu_torch.data import test_files
    from dml_cnn_cifar10_tpu_torch.data.pipeline import _load_split
    from dml_cnn_cifar10_tpu_torch.ops import flash_attention as fa
    from dml_cnn_cifar10_tpu_torch.serve.engine import ServingEngine
    from dml_cnn_cifar10_tpu_torch.tools import loadgen

    models = {"cnn": {"cli": cnn_cli, "step": RESUME_STEPS, "k3": 0},
              "vit": {"cli": vit_cli, "step": VIT_RESUME_STEPS, "k3": 12}}
    out = {"card": card, "buckets": list(SERVE_BUCKETS)}

    # ---- 22. export: --mode export, one artifact serves every bucket ----
    for label, m in models.items():
        cfg = config_from_args(build_parser().parse_args(m["cli"]))
        m["cfg"] = cfg
        t0 = time.perf_counter()
        lines = run_cli(m["cli"] + ["--mode", "export"])
        m["export_s"] = time.perf_counter() - t0
        m["path"] = os.path.join(cfg.log_dir, export_lib.ARTIFACT_NAME)
        check(any(f"exported step-{m['step']} forward" in l for l in lines),
              f"{label}: --mode export did not export step {m['step']}")
        images, _ = _load_split(test_files(cfg.data), cfg.data)
        m["images"] = np.ascontiguousarray(images)
        art = ServingEngine.from_artifact(m["path"], dev)
        model, params, step = export_lib.restore_serving_params(cfg, dev)
        check(step == m["step"], f"{label}: restored step {step}")
        live = ServingEngine.from_params(model, cfg.data, params, dev,
                                         version=str(step))
        graph = export_lib.load_program(m["path"]).graph
        n_ops = sum(n.target == torch.ops.dml_torch.flash_attention_out.default
                    for n in graph.nodes)
        check(n_ops == m["k3"], f"{label}: the artifact's graph holds "
              f"{n_ops} flash operator nodes, want {m['k3']}")
        worst = 0.0
        for b in SERVE_BUCKETS:
            x = m["images"][:b]
            got, want = art.forward_eager(x), live.forward_eager(x)
            check(got.shape == (b, 10) and np.isfinite(got).all(),
                  f"{label}: the artifact gave {got.shape} at b={b}")
            worst = max(worst, _rel(got, want))
        check(worst <= SERVE_REL, f"{label}: artifact vs live weights "
              f"{worst} > {SERVE_REL} of the largest logit")
        m.update(art=art, live=live, params=params)
        out[label] = {"export_s": m["export_s"], "artifact_bytes":
                      os.path.getsize(m["path"]), "flash_op_nodes": n_ops,
                      "artifact_vs_live_rel": worst}
        print(f"[serve export] {label}: step {step} -> {m['path']} "
              f"({out[label]['artifact_bytes']} bytes, {n_ops} flash "
              f"operator nodes) in {m['export_s']:.2f} s; one artifact at "
              f"b = {SERVE_BUCKETS}: within {worst:.3g} of the live "
              f"weights' forward", flush=True)

    # ---- 23. K3 through the registered operator ------------------------
    out["k3"] = serve_k3(dev, card, bytes_per_s, f32_ops)

    # ---- 24. one CUDA graph per bucket: replay against eager ------------
    for label, m in models.items():
        rows = {}
        for kind in ("art", "live"):
            eng = m[kind]
            fa.reset_launches()
            t0 = time.perf_counter()
            eng.warmup(SERVE_BUCKETS)
            warm_s = time.perf_counter() - t0
            check(sorted(eng.graphs) == sorted(SERVE_BUCKETS),
                  f"{label} {kind}: {len(eng.graphs)} graphs captured")
            check(fa.LAUNCHES["flash_fwd"] == m["k3"] * len(eng.graphs),
                  f"{label} {kind}: warm-up replays launched "
                  f"{fa.LAUNCHES['flash_fwd']} K3")
            for g in eng.graphs.values():
                check(g.launches == ({"flash_fwd": m["k3"]} if m["k3"]
                                     else {}),
                      f"{label} {kind}: a replay launches {g.launches}")
            for b in SERVE_BUCKETS:
                x = m["images"][:b]
                rep, _ = eng.forward_timed(x)
                eag = eng.forward_eager(x)
                rel = _rel(rep, eag)
                check(rel <= SERVE_REL, f"{label} {kind} b={b}: replay vs "
                      f"eager {rel} > {SERVE_REL}")
                copies = _copies(lambda: eng.forward_timed(x), reps=10)
                check(1 <= copies["HtoD"] <= 10 and copies["DtoH"] <= 10,
                      f"{label} {kind} b={b}: 10 served batches made copies "
                      f"{copies}; want at most one in (the input) and one "
                      f"out (the logits) a batch: no weight copy")
                g = eng.graphs[b]
                replay_dev = cuda_ms(g.graph.replay, reps=50, warmup=5)
                with torch.no_grad():
                    eager_dev = cuda_ms(lambda: eng._run(
                        g.static_in, eng._params), reps=20, warmup=3)
                row = dict(rel=rel, copies=copies,
                           replay_ms=_host_ms(lambda: eng.forward_timed(x),
                                              30),
                           eager_ms=_host_ms(lambda: eng.forward_eager(x),
                                             10),
                           replay_device_ms=replay_dev,
                           eager_device_ms=eager_dev)
                rows.setdefault(kind, {})[b] = row
                print(f"[serve graphs] {label} {kind} b={b}: replay vs eager "
                      f"{rel:.3g}; served batch {row['replay_ms']:.4f} ms "
                      f"(replay), {row['eager_ms']:.4f} ms (eager), input "
                      f"copy + logits included; by CUDA events "
                      f"{replay_dev:.4f} ms replay, {eager_dev:.4f} ms eager;"
                      f" copies {copies}, on {card}", flush=True)
            rows[kind + "_warmup_s"] = warm_s
        for b in (1, 128):
            prof = _batch_profile(m["art"], m["images"][:b])
            rows.setdefault("profile", {})[b] = prof
            print(f"[serve profile] {label} artifact b={b}: served batch "
                  f"{prof['host_ms']:.4f} ms on the host clock, device busy "
                  f"{prof['device_busy_ms']:.4f} ms "
                  f"({100 * prof['device_busy_share']:.1f}%): "
                  + ", ".join(f"{g} {ms:.4f}" for g, ms
                              in prof["groups_ms"].items())
                  + f"; on {card}", flush=True)
        out[label]["graphs"] = rows

    # ---- 25. --mode serve over HTTP, driven by the port's loadgen --------
    # Each model's artifact behind the server (resolve_engine finds
    # <log_dir>/model.pt2), closed loops once each at 1, 32 and 128
    # clients: every answer's class is the direct forward's, no error but
    # 503, and the served path launched K3 12 times a replay and nothing
    # else (counts set to 0 before the server starts, read after it
    # stops: the warm-up's one replay a bucket, then one a batch).
    for label, m in models.items():
        npz = os.path.join(WORK, f"check_{label}.npz")
        left_out = _check_set(m["art"], m["images"], npz)
        fa.reset_launches()
        t, stop, url, cfg, rc = _serve_thread(
            m["cli"] + ["--metrics_jsonl",
                        os.path.join(OUT, f"serve_{label}.jsonl"),
                        "--serve_metrics_every_s", "1"])
        runs = {}
        for c in SERVE_CONCURRENCY:
            for rep in range(SERVE_REPS):
                r = _loadgen(["--target", url, "--mode", "closed",
                              "--concurrency", str(c), "--duration_s",
                              str(SERVE_RUN_S), "--check_labels", npz],
                             f"{label}_c{c}_{rep}")
                check(r["errors"] == 0 and r["rejected"] == 0,
                      f"{label} c={c}: errors {r['error_kinds']}")
                check(r["completed"] > 0 and r.get("label_checked")
                      == r["completed"] and r["accuracy"] == 1.0,
                      f"{label} c={c}: {r.get('label_checked')} checked of "
                      f"{r['completed']}, class agreement "
                      f"{r.get('accuracy')}")
                runs.setdefault(c, []).append(
                    {k: r[k] for k in ("achieved_qps", "latency_ms",
                                       "completed", "shed", "version_mix")})
                print(f"[serve http] {label} closed loop c={c} run {rep}: "
                      f"{r['achieved_qps']} qps, p50 "
                      f"{r['latency_ms']['p50']} ms, p99 "
                      f"{r['latency_ms']['p99']} ms, {r['completed']} "
                      f"completed, {r['shed']} shed, every class the direct "
                      f"forward's; on {card}", flush=True)
        _stop_serve(t, stop, rc, f"{label} serve")
        done = [r for r in records(cfg.metrics_jsonl)
                if r["kind"] == "serve_done"][-1]
        launched = dict(fa.LAUNCHES)
        want = m["k3"] * (done["batches"] + len(SERVE_BUCKETS))
        check(launched["flash_fwd"] == want
              and sum(launched.values()) == want,
              f"{label} serve path launched {launched}; want K3 = "
              f"{m['k3']} x ({done['batches']} batches + "
              f"{len(SERVE_BUCKETS)} warm-up replays) and nothing else")
        out[label]["http"] = {"closed": runs, "left_out_near_ties": left_out,
                              "serve_done": done, "launches": launched}
        print(f"[serve http] {label}: {done['batches']} batches, batch fill "
              f"{done['batch_fill']}, queue wait p50 "
              f"{done['queue_wait_p50_ms']} ms, device p50 "
              f"{done['device_p50_ms']} ms; launches {launched}; "
              f"{left_out} near-tie image(s) left out of the class check",
              flush=True)

    # Past capacity: the ViT-Ti artifact at bucket 1 with a 2-deep queue
    # and a 0.5 ms deadline, an open loop at 1,500 requests/s (a bucket-1
    # replay takes over a millisecond): overload is shed (503), not
    # buffered, and nothing else fails.
    t, stop, url, _, rc = _serve_thread(
        vit_cli + ["--serve_buckets", "1", "--serve_queue_depth", "2",
                   "--serve_deadline_ms", "0.5"])
    r = _loadgen(["--target", url, "--mode", "open", "--qps", "1500",
                  "--duration_s", str(SERVE_RUN_S), "--image_size", "72"],
                 "vit_open")
    _stop_serve(t, stop, rc, "overload serve")
    check(r["shed_fraction"] > 0 and r["errors"] == 0,
          f"open loop past capacity: shed fraction {r['shed_fraction']}, "
          f"errors {r['error_kinds']}")
    out["overload"] = {k: r[k] for k in ("achieved_qps", "latency_ms",
                                         "completed", "shed",
                                         "shed_fraction")}
    print(f"[serve http] open loop at 1500/s past capacity (ViT-Ti, bucket "
          f"1, queue 2, deadline 0.5 ms): shed fraction "
          f"{r['shed_fraction']}, {r['achieved_qps']} qps served, p99 "
          f"{r['latency_ms']['p99']} ms", flush=True)
    out["swap"] = _swap_under_load(card, dev, models["cnn"])
    with open(os.path.join(OUT, "serve.json"), "w") as f:
        json.dump(out, f, indent=1)
    return out


def _swap_under_load(card, dev, m) -> dict:
    """The CNN's step-500 checkpoint served live over HTTP to 32 closed-loop
    clients; a second in, the step-600 checkpoint is hot-swapped in. The
    version tags flip (every request sent after the swap returned is
    answered by 600), and each answer's logits are its version's forward
    of its image."""
    import threading
    from types import SimpleNamespace

    import numpy as np

    from dml_cnn_cifar10_tpu_torch import convert
    from dml_cnn_cifar10_tpu_torch.ckpt import checkpoint as ckpt
    from dml_cnn_cifar10_tpu_torch.serve.engine import ServingEngine
    from dml_cnn_cifar10_tpu_torch.tools import loadgen

    cfg, images = m["cfg"], m["images"][:256]
    params = {}
    for step in (STEPS, RESUME_STEPS):
        with open(os.path.join(cfg.log_dir, f"ckpt_{step}.msgpack"),
                  "rb") as f:
            params[step] = convert.params_from_jax(
                ckpt.from_bytes(f.read())["params"])
    refs = {}
    for step, p in params.items():
        e = ServingEngine.from_params(_fresh_model(cfg), cfg.data, p, dev,
                                      version=str(step))
        refs[str(step)] = np.concatenate(
            [e.forward_eager(images[i:i + 128]) for i in range(0, 256, 128)])
    apart = float(np.abs(refs[str(STEPS)] - refs[str(RESUME_STEPS)]).max())
    check(apart > 100 * SWAP_TOL, f"the two checkpoints' logits are only "
          f"{apart} apart")
    engine = ServingEngine.from_params(_fresh_model(cfg), cfg.data,
                                       params[STEPS], dev,
                                       version=str(STEPS))
    t, stop, url, scfg, rc = _serve_thread(
        m["cli"] + ["--metrics_jsonl", os.path.join(OUT, "serve_swap.jsonl")],
        engine=engine)
    client = loadgen.HttpClient(url)
    answers, lock = [], threading.Lock()

    def submit(idx, stats, oversize):
        t0 = time.perf_counter()
        try:
            outcome, payload = client.predict(images[idx].tobytes())
        except Exception as e:
            stats.record("error", error=repr(e))
            return
        stats.record(outcome, time.perf_counter() - t0,
                     (payload or {}).get("version"))
        if outcome == "ok":
            with lock:
                answers.append((t0, idx, payload))

    swapped = {}

    def swap():
        time.sleep(1.0)
        ok, why = engine.try_swap(params[RESUME_STEPS],
                                  version=str(RESUME_STEPS))
        swapped.update(ok=ok, why=why, at=time.perf_counter())

    stats = loadgen.ClientStats()
    swapper = threading.Thread(target=swap)
    swapper.start()
    loadgen.run_closed(submit, list(range(len(images))),
                       SimpleNamespace(duration_s=3.0, concurrency=32),
                       stats)
    swapper.join(60)
    _stop_serve(t, stop, rc, "swap serve")
    check(swapped.get("ok") is True, f"hot-swap refused: {swapped}")
    check(stats.errors == 0, f"errors under the swap: {stats.error_kinds}")
    versions = {p["version"] for _, _, p in answers}
    check(versions == {str(STEPS), str(RESUME_STEPS)},
          f"versions seen under the swap: {versions}")
    late = [p["version"] for t0, _, p in answers if t0 > swapped["at"]]
    check(late and set(late) == {str(RESUME_STEPS)},
          f"{len(late)} answers sent after the swap, versions {set(late)}")
    worst = 0.0
    for _, idx, p in answers:
        ref = refs[p["version"]][idx]
        diff = float(np.abs(np.asarray(p["logits"]) - ref).max())
        worst = max(worst, diff / max(1.0, float(np.abs(ref).max())))
    check(worst <= SWAP_TOL, f"an answer is {worst} from its version's "
          "forward")
    swaps = [r for r in records(scfg.metrics_jsonl) if r["kind"] == "swap"]
    check(len(swaps) == 1 and swaps[0]["from_version"] == str(STEPS),
          f"swap records {swaps}")
    res = {"answers": len(answers), "version_mix": dict(stats.versions),
           "after_swap": len(late), "worst_rel": worst,
           "versions_apart": apart, "swap_ms": swaps[0]["swap_ms"]}
    print(f"[serve swap] step {STEPS} -> {RESUME_STEPS} under 32 clients: "
          f"{len(answers)} answers {dict(stats.versions)}, {len(late)} sent "
          f"after the swap all answered by {RESUME_STEPS}; every answer "
          f"within {worst:.3g} of its version's forward (the versions are "
          f"{apart:.3g} apart); swap {swaps[0]['swap_ms']} ms, on {card}",
          flush=True)
    return res


# ---- Ulysses (26-27), telemetry (28), the optimizer surface (29) ---------

ULYSSES_SEQ = 3          # ViT-Ti's 3 heads, one a rank
# name, global [B, S, H, D], dtype, mask: Ulysses over 3 ranks against the
# one-rank flash_attention of the full sequence: the long-context shape
# (2,700 tokens a rank), and f32 full and causal cases.
ULYSSES_OP_CASES = [
    ("long context", (2, 8100, 3, 64), "bfloat16", {}),
    ("full", (2, 2049, 3, 64), "float32", {}),
    ("causal", (2, 2049, 3, 64), "float32", {"causal": True}),
]


def _rank_ulysses(rank: int, job: dict) -> dict:
    """Ulysses attention on ``ULYSSES_SEQ`` ranks against the
    full-sequence flash attention; returns this rank's max abs
    differences and reference scales, and the launches of the Ulysses
    calls alone at the long-context shape."""
    import torch.distributed as dist

    from dml_cnn_cifar10_tpu_torch.config import ParallelConfig
    from dml_cnn_cifar10_tpu_torch.ops import flash_attention as fa
    from dml_cnn_cifar10_tpu_torch.parallel import mesh as mesh_lib
    from dml_cnn_cifar10_tpu_torch.parallel import multihost
    from dml_cnn_cifar10_tpu_torch.parallel import ring_attention as ring
    from dml_cnn_cifar10_tpu_torch.parallel import ulysses

    n = ULYSSES_SEQ
    par = ParallelConfig(seq_axis=n, coordinator_address=job["address"],
                         num_processes=n, process_id=rank)
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    multihost.initialize(par, job["backend"], dev)
    mesh = mesh_lib.build_mesh(par)
    gen = torch.Generator(device=dev).manual_seed(6)
    res = {}
    for name, (b, s, h, d), dtype, kw in ULYSSES_OP_CASES:
        q, k, v, do = (torch.randn(b, s, h, d, device=dev, generator=gen)
                       .to(getattr(torch, dtype)) for _ in range(4))
        full = [t.clone().requires_grad_() for t in (q, k, v)]
        ref = fa.flash_attention(*full, **kw)
        ref_g = torch.autograd.grad(ref, full, do)
        mine = [ring.seq_shard(t, mesh).detach().clone().requires_grad_()
                for t in (q, k, v)]
        torch.cuda.synchronize()
        before = dict(fa.LAUNCHES)
        out = ulysses.ulysses_attention_local(*mine, mesh, **kw)
        got_g = torch.autograd.grad(out, mine, ring.seq_shard(do, mesh))
        torch.cuda.synchronize()
        res[name] = {"launches": {key: fa.LAUNCHES[key] - before[key]
                                  for key in before}}
        for what, g, w in zip(("out", "dq", "dk", "dv"), (out, *got_g),
                              (ref, *ref_g)):
            w = ring.seq_shard(w, mesh).float()
            res[name][what] = [(g.float() - w).abs().max().item(),
                               w.abs().max().item()]
        del q, k, v, do, full, ref, ref_g, mine, out, got_g
    mesh.barrier()
    dist.destroy_process_group()
    return res


def _dist_args(world: int, backend: str) -> list:
    ports = _free_ports(world)
    return ["--worker_hosts", ",".join(f"localhost:{p}" for p in ports),
            "--dist_backend", backend]


def ulysses_launches(steps: int, fwd_only: int) -> dict:
    """Per-rank launches of ``steps`` Ulysses steps with remat: K4 = 12
    blocks x 2 (the remat recomputes the forward), K6 = K7 = 12 a step, at
    [B, 8100, 1, 64]; K3 = 12 per forward-only batch; K5 = K1 = K2 = 0."""
    return {"flash_fwd": fwd_only * 12, "flash_fwd_lse": steps * 24,
            "flash_fwd_stats": 0, "flash_bwd_dq": steps * 12,
            "flash_bwd_dkv": steps * 12, "sgd_update_plain": 0,
            "sgd_update_momentum": 0}


def ulysses_phases(backend: str, card: str, one_rank_jsonl=None) -> dict:
    """Phases 26-27 over ``backend`` on ``ULYSSES_SEQ`` rank processes: the
    Ulysses op against one-rank flash attention, then the long-context
    recipe with ``--seq_axis 3 --sp_mode ulysses`` for 10 steps against
    the same batches on one rank (``one_rank_jsonl``, or run here), a
    resume to step 15, ``--mode eval`` and rank 0's step profile."""
    n = ULYSSES_SEQ
    count = torch.cuda.device_count()
    res = {"card": card, "backend": backend, "cards": min(count, n)}
    long = long_args(WORK) + ["--batch_size", "2"]
    if one_rank_jsonl is None:
        one_rank_jsonl = os.path.join(WORK, "ulysses_ref.jsonl")
        run_cli(long + ["--total_steps", str(LONG_STEPS), "--log_dir",
                        os.path.join(WORK, "logs_ulysses_ref"),
                        "--metrics_jsonl", one_rank_jsonl])
    sp = ["--seq_axis", str(n), "--sp_mode", "ulysses"]
    log = os.path.join(WORK, f"logs_ulysses_{backend}")
    jsonl = os.path.join(WORK, f"vit_ulysses_{backend}.jsonl")
    # Phases 26-27's jobs on one spawn of n rank processes (a process's
    # start and a trainer's first set-up paid once), in the order the
    # checks below read them.
    a = _dist_args_n(4, n, backend)
    parts = spawn_parts(f"ulysses{n}_{backend}", [
        {"label": f"ulysses_op_{backend}", "kind": "ulysses",
         "backend": backend, "address": f"localhost:{_free_ports(1)[0]}"},
        {"label": f"ulysses_{backend}", "kind": "cli", "argv": long + sp
         + ["--total_steps", str(LONG_STEPS), "--log_dir", log,
            "--metrics_jsonl", jsonl] + a[0]},
        {"label": f"ulysses_resume_{backend}", "kind": "cli", "argv": long
         + sp + ["--log_dir", log, "--total_steps", str(LONG_STEPS + 5)]
         + a[1]},
        {"label": f"ulysses_eval_{backend}", "kind": "cli", "argv":
         long[:-2] + sp + ["--batch_size", "32", "--log_dir", log,
                           "--mode", "eval"] + a[2]},
        {"label": f"ulysses_profile_{backend}", "kind": "profile",
         "steps": 2, "argv": long + sp + [
             "--log_dir", os.path.join(WORK, "logs_ulysses_profile")]
         + a[3]}], world=n)
    # ---- 26. the Ulysses op ---------------------------------------------
    op = parts[f"ulysses_op_{backend}"]
    for name, _, dtype, kw in ULYSSES_OP_CASES:
        for what in ("out", "dq", "dk", "dv"):
            diff = max(r[name][what][0] for r in op)
            scale = max(r[name][what][1] for r in op)
            tol = RING_OP_TOL["out" if what == "out" else "grad"] \
                if dtype == "float32" else min(BF16_CAP, BF16_REL * scale)
            check(diff <= tol, f"ulysses op {name}: {what} max abs diff "
                               f"{diff} > {tol}")
        print(f"[ulysses op] {name} {dtype} {kw} ({n} ranks, {backend}): "
              f"max abs diff vs the full sequence's flash attention "
              + ", ".join(f"{w} {max(r[name][w][0] for r in op):.3g}"
                          for w in ("out", "dq", "dk", "dv")), flush=True)
    want = {"flash_fwd": 0, "flash_fwd_lse": 1, "flash_fwd_stats": 0,
            "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    check(all(r["long context"]["launches"] == want for r in op),
          f"Ulysses op launched {[r['long context']['launches'] for r in op]}"
          f" per rank, want {want}")
    res["op"] = op

    # ---- 27. Ulysses long context: 8,100 tokens, one head a rank --------
    ranks = parts[f"ulysses_{backend}"]
    wall = ranks[0]["part_wall_s"]
    want = ulysses_launches(LONG_STEPS, LONG_STEPS // 5)
    check(all(r["launches"] == want for r in ranks),
          f"Ulysses ranks launched {[r['launches'] for r in ranks]}, want "
          f"{want}")
    check(len({r["digest"] for r in ranks}) == 1,
          "Ulysses ranks ended with different parameters")
    got, ref = train_log(jsonl), train_log(one_rank_jsonl)
    gaps = [abs(g[1] - r[1]) for g, r in zip(got, ref)]
    check(len(got) == len(ref) == LONG_STEPS // 5
          and [g[0] for g in got] == [r[0] for r in ref]
          and all(math.isfinite(g[1]) for g in got)
          and max(gaps) <= SP_LOSS_TOL,
          f"Ulysses (step, loss, images/s) {got}; one rank {ref}; gaps "
          f"{gaps} (gate {SP_LOSS_TOL})")
    res["train"] = {"train": got, "reference": ref, "loss_gaps": gaps,
                    "step_ms": 2 / got[-1][2] * 1e3,
                    "tokens_per_s": got[-1][2] * 8100, "wall_s": wall,
                    "launches": ranks[0]["launches"], "jsonl": jsonl}
    shutil.copy(jsonl, OUT)
    print(f"[ulysses train] {n} ranks (seq {n}, {backend}), batch 2 x 8,100 "
          f"tokens, one head a rank: (step, loss, images/s) {got}; one rank "
          f"{ref}; loss gaps {gaps} (gate {SP_LOSS_TOL}); "
          f"{res['train']['step_ms']:.1f} ms/step in steps 6-10; launches "
          f"per rank {ranks[0]['launches']}, equal parameters, {wall:.1f} s "
          f"wall, on {min(count, n)} x {card}", flush=True)
    label = f"ulysses_resume_{backend}"
    resume = parts[label]
    check(all(r["launches"] == ulysses_launches(5, 1) for r in resume),
          f"Ulysses resume ran {[r['launches'] for r in resume]}, want 5 "
          f"steps from step {LONG_STEPS}")
    steps = [int(m[1]) for m in map(STEP_LINE.match, rank_log(label)) if m]
    check(steps == [LONG_STEPS + 5], f"Ulysses resume printed steps {steps}")
    # The full test split (512 records) at 32 images a batch.
    label = f"ulysses_eval_{backend}"
    ev = parts[label]
    accs = []
    for r in range(n):
        lines = rank_log(label, r)
        check(any(f"eval at step {LONG_STEPS + 5}" in l for l in lines),
              f"Ulysses eval rank {r} did not restore step {LONG_STEPS + 5}")
        accs.append([m[1] for m in map(EVAL_LINE.match, lines) if m])
    check(len(accs[0]) == 1 and all(a == accs[0] for a in accs),
          f"Ulysses --mode eval printed {accs}")
    check(ev[0]["launches"]["flash_fwd"] == 16 * 12,
          f"Ulysses eval launched {ev[0]['launches']} (16 batches of 32)")
    res["eval_accuracy"] = accs[0][0]
    print(f"[ulysses resume] continued {LONG_STEPS} -> {LONG_STEPS + 5}; "
          f"--mode eval over {n} ranks: {accs[0][0]}% on each", flush=True)
    prof = parts[f"ulysses_profile_{backend}"]
    res["profile"] = prof
    p = prof[0]
    print(f"[ulysses profile] rank 0 ({backend}): {p['step_ms']:.2f} ms/step "
          f"(host clock, batch on the card); device timeline a step: compute "
          f"{p['compute_ms']:.2f} ms ({100 * p['compute_share']:.1f}% of the "
          f"step), all-to-alls and all-reduces {p['comm_ms']:.2f} ms, of "
          f"which {p['overlap_ms']:.2f} ms beside compute; "
          + ", ".join(f"{k} {v:.2f}" for k, v in p["flash_ms"].items())
          + f"; on {card}", flush=True)
    for k in p["kernels"][:8]:
        print(f"[ulysses profile]   rank 0 {k['ms_per_step']:.4f} ms/step "
              f"x{k['per_step']} {k['name'][:100]}")
    return res


# Train records checked for the run telemetry: every record after the
# first carries these (the first may close a window that opened at it).
TELEMETRY_KEYS = ("device_step_ms", "drain_wait_ms",
                  "tflops_per_sec_per_chip", "mfu")


def telemetry_check(paths: dict, card: str) -> dict:
    """Hold each path's ``train`` records to ``TELEMETRY_KEYS`` and print
    its TFLOP/s and MFU. ``paths``: label -> (jsonl, peak TFLOP/s)."""
    res = {}
    for label, (path, peak) in paths.items():
        train = [r for r in records(path) if r["kind"] == "train"]
        check(len(train) >= 2, f"{label}: {len(train)} train records")
        for r in train[1:]:
            missing = [key for key in TELEMETRY_KEYS if r.get(key) is None]
            check(not missing, f"{label}: step {r['step']} lacks {missing}")
        check(train[0].get("flops_stack") is not None,
              f"{label}: no flops_stack label")
        last = train[-1]
        res[label] = {"flops_stack": train[0]["flops_stack"],
                      "peak_tflops": float(peak),
                      **{key: last[key] for key in
                         ("step", "images_per_sec", *TELEMETRY_KEYS)}}
        print(f"[telemetry] {label}: step {last['step']}, "
              f"{last['tflops_per_sec_per_chip']} TFLOP/s a card, MFU "
              f"{last['mfu']} of {peak} TFLOP/s, device step "
              f"{last['device_step_ms']} ms, drain wait "
              f"{last['drain_wait_ms']} ms (flops {train[0]['flops_stack']});"
              f" on {card}", flush=True)
    return res


# Phase 28's profile windows: optimizer -> its flags. Each runs eager and
# chunked (one graph replay a chunk of CHUNK_K steps).
DEVTIME_OPTIMIZERS = {
    "sgd": [],
    "adamw": ["--optimizer", "adamw", "--learning_rate", "0.001"],
    "lars": ["--optimizer", "lars", "--learning_rate", "0.1"],
}


def devtime_phase(base, card, k1_device_ms, k1_replay_ms,
                  eager_busy_ms) -> dict:
    """Phase 28's profile windows on the CNN main path, 60 steps each,
    ``--profile_at_steps 30:10``, eager and chunked (graph replay), with
    SGD, AdamW and LARS. Each writes ``devtime`` records. The eager window
    counts the kernels inside the step's ``optimizer`` range; for SGD
    those are K1 and the LR schedule's and step counter's small kernels,
    held within 2x of one ``sgd_update``'s device time, measured here,
    with K1's share printed, and its compute per step is within 25% of
    phase 9's device time. A replay has no range: the chunked window
    counts the replayed kernels that the graph's profiled warm-up ran
    inside the range (the update's, whatever the optimizer), held above 0
    and within 2x of the same optimizer's eager window; K1's device time
    in phase 9b's replays is printed beside SGD's."""
    from dml_cnn_cifar10_tpu_torch.config import (DataConfig, ModelConfig,
                                                  OptimConfig)
    from dml_cnn_cifar10_tpu_torch.models.cnn import CNN
    from dml_cnn_cifar10_tpu_torch.train import optim as optim_lib

    check(k1_device_ms is not None, "phase 4 traced no K1 kernel")
    dev = torch.device("cuda")
    params = {n: p.detach().clone().to(dev) for n, p in CNN(
        ModelConfig(), DataConfig()).named_parameters()}
    grads = {n: torch.randn_like(p) for n, p in params.items()}
    ocfg = OptimConfig(learning_rate=0.02, dead_lr_decay=False)
    opt = optim_lib.sgd_init(params, ocfg, dev)
    update = kernel_ms(lambda: optim_lib.sgd_update(grads, opt, params,
                                                    ocfg))
    update_ms = sum(update.values())
    print(f"[devtime] one sgd_update (the fixed recipe's LR schedule, K1, "
          f"the step counter): {update_ms:.5f} ms of device time in "
          f"{len(update)} kernels, K1 {k1_device_ms} ms of it", flush=True)
    res = {"update_device_ms": update_ms, "update_kernels": sorted(update),
           "k1_replay_ms": k1_replay_ms}
    for opt_name, flags in DEVTIME_OPTIMIZERS.items():
        eager_ms = None
        for mode, extra in (("eager", []),
                            ("chunked", ["--steps_per_dispatch",
                                         str(CHUNK_K)])):
            label = mode if opt_name == "sgd" else f"{opt_name} {mode}"
            log = os.path.join(WORK, f"logs_devtime_{opt_name}_{mode}")
            jsonl = os.path.join(WORK, f"devtime_{opt_name}_{mode}.jsonl")
            run_cli(base + flags + extra + [
                "--log_dir", log, "--total_steps", "60", "--output_every",
                "10", "--eval_every", "1000", "--checkpoint_every", "1000",
                "--profile_at_steps", "30:10", "--metrics_jsonl", jsonl])
            recs = records(jsonl)
            devs = [r for r in recs if r["kind"] == "devtime"]
            check(devs and all(r["step"] == 40 for r in devs),
                  f"{label}: devtime records {devs}")
            lane = max(devs, key=lambda r: r["compute_ms"])
            opt_ms = [r["optimizer_ms"] for r in recs
                      if r["kind"] == "train" and r["step"] > 40]
            check(opt_ms and opt_ms[0] is not None and opt_ms[0] > 0,
                  f"{label}: train records after the window carry "
                  f"optimizer_ms {opt_ms}")
            traces = os.listdir(os.path.join(log, "devprof"))
            with open(os.path.join(log, "devprof", traces[0])) as f:
                cats = {e.get("cat") for e in json.load(f)["traceEvents"]}
            compute = lane["compute_ms"] / 10
            top = lane["top_ops"][:3]
            if mode == "eager":
                eager_ms = opt_ms[0]
                want_ms = update_ms if opt_name == "sgd" else None
            else:
                want_ms = eager_ms
            if want_ms is not None:
                check(0.5 <= opt_ms[0] / want_ms <= 2.0,
                      f"{label}: optimizer_ms {opt_ms[0]} against "
                      f"{'one update' if mode == 'eager' else 'the eager window'}"
                      f"'s device {want_ms} ms")
            if label == "eager":
                check(abs(compute / eager_busy_ms - 1) <= 0.25,
                      f"eager window compute {compute} ms/step against "
                      f"phase 9's device {eager_busy_ms} ms/step")
            res[label] = {"lanes": [r["device"] for r in devs],
                          "compute_ms_per_step": compute,
                          "collective_ms": lane["collective_ms"],
                          "infeed_ms": lane["infeed_ms"],
                          "optimizer_ms_per_step": opt_ms[0],
                          "held_to_ms": want_ms,
                          "scope_on_device": "gpu_user_annotation" in cats,
                          "top_ops": lane["top_ops"][:5]}
            shutil.copy(jsonl, OUT)
            print(f"[devtime] {label}: lanes {res[label]['lanes']}; compute "
                  f"{compute:.4f} ms/step (phase 9's device "
                  f"{eager_busy_ms:.4f}), infeed {lane['infeed_ms']} ms, "
                  f"optimizer_ms {opt_ms[0]} ms/step against "
                  f"{want_ms} ms ({opt_ms[0] / k1_device_ms:.2f}x phase "
                  f"4's K1 alone; K1 in phase 9b's replays "
                  f"{k1_replay_ms:.5f}; the update's annotation on the "
                  f"device: {res[label]['scope_on_device']}); top "
                  f"{[(o['name'][:40], o['dur_ms']) for o in top]}; on "
                  f"{card}", flush=True)
    return res


OPT_STEPS = 100
# name -> (flags, K1 launches, K2 launches): 100 CNN steps at full width.
OPT_RUNS = {
    "clip_momentum": (["--grad_clip_norm", "1", "--momentum", "0.9"], 0,
                      OPT_STEPS),
    "grad_accum": (["--grad_accum", "2"], OPT_STEPS, 0),
    "staleness": (["--async_staleness", "2"], OPT_STEPS, 0),
    # LARS leaves 1-D leaves (the biases) unadapted, so with its momentum
    # of 0.9 they step by about 10 x lr x g: at lr 1.0 the CNN's loss
    # oscillates and ends above its first reading in some runs on the
    # card; from 0.1 to 0.5 it falls in every run (chip_optim_repeat.py).
    "lars": (["--optimizer", "lars", "--learning_rate", "0.1"], 0, 0),
    "lamb": (["--optimizer", "lamb", "--learning_rate", "0.001"], 0, 0),
    "adafactor": (["--optimizer", "adafactor", "--learning_rate", "0.01"],
                  0, 0),
}


def optim_phase(base, card) -> dict:
    """Phase 29: each ``OPT_RUNS`` entry for 100 steps (losses finite and
    falling, K1/K2 counted); ``--async_staleness 2 --steps_per_dispatch
    10`` for 100 steps, then one graphed chunk from its state against the
    eager body, bit for bit with cuDNN deterministic; eager 50 + 50 steps
    with a resume against 100, bit for bit (cuDNN deterministic)."""
    from dml_cnn_cifar10_tpu_torch.ops import optimizer as fused

    res = {}
    for name, (flags, k1, k2) in OPT_RUNS.items():
        jsonl = os.path.join(WORK, f"opt_{name}.jsonl")
        fused.reset_launches()
        # cuDNN deterministic: with its default algorithms two runs on an
        # H100 drew different losses (Adafactor's read [0.451, 0.463,
        # 0.013, 0.002] in one and [0.287, 0.159, 0.015, 0.471] in the
        # next), so whether the step-100 loss fell below step 25's changed
        # from run to run; one algorithm gives every run the same
        # trajectory.
        saved = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            run_cli(base + flags + ["--log_dir",
                                    os.path.join(WORK, f"logs_{name}"),
                                    "--total_steps", str(OPT_STEPS),
                                    "--output_every", "25", "--eval_every",
                                    "1000", "--checkpoint_every", "1000",
                                    "--metrics_jsonl", jsonl])
        finally:
            torch.backends.cudnn.deterministic = saved
        losses = [l for _, l, _ in train_log(jsonl)]
        launched = (fused.LAUNCHES["sgd_update_plain"],
                    fused.LAUNCHES["sgd_update_momentum"])
        check(len(losses) == 4 and all(math.isfinite(l) for l in losses)
              and losses[-1] < losses[0],
              f"{name}: losses {losses} (finite and falling)")
        check(launched == (k1, k2),
              f"{name}: K1/K2 launched {launched}, want {(k1, k2)}")
        res[name] = {"losses": losses, "k1": launched[0], "k2": launched[1]}
        print(f"[optim] {name} {' '.join(flags)}: losses {losses}; K1 "
              f"{launched[0]}, K2 {launched[1]} launches in {OPT_STEPS} "
              f"steps; on {card}", flush=True)

    # Staleness under the graph: the snapshot slot is read on the card.
    fused.reset_launches()
    stale = ["--async_staleness", "2"]
    lines, trainer, result = run_trainer(base + stale + [
        "--steps_per_dispatch", str(CHUNK_K), "--log_dir",
        os.path.join(WORK, "logs_stale_chunk"), "--total_steps",
        str(OPT_STEPS), "--output_every", "50", "--eval_every", "1000",
        "--checkpoint_every", "1000"])
    check(fused.LAUNCHES["sgd_update_plain"] == OPT_STEPS
          and trainer.train_fn.graph.replays == OPT_STEPS // CHUNK_K,
          f"chunked staleness: {fused.LAUNCHES}, "
          f"{trainer.train_fn.graph.replays} replays")
    cfg = trainer.cfg
    train_it = trainer.input_pipeline(train=True, seed=cfg.seed)
    ds_images = torch.from_numpy(train_it.images).cuda()
    ds_labels = torch.from_numpy(train_it.labels.astype("int64")).cuda()
    c, _, _ = _graph_vs_eager(cfg, result.state, ds_images, ds_labels, True)
    check(c["loss_gap"] == 0 and c["param_gap"] == 0,
          f"staleness: graphed chunk differs from the eager body: {c}")
    res["staleness_graph_vs_eager"] = c
    print(f"[optim] async_staleness 2 under the graph: {OPT_STEPS} steps in "
          f"{OPT_STEPS // CHUNK_K} replays, K1 {OPT_STEPS}; one chunk from "
          f"step {OPT_STEPS}: loss {c['loss_graph']!r} graphed, "
          f"{c['loss_eager']!r} eager, params max gap {c['param_gap']} "
          f"(cudnn.deterministic)", flush=True)

    # Exact resume on the card: the host streams continue.
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        logs = {}
        for label, stops in (("whole", (100,)), ("split", (50, 100))):
            log = os.path.join(WORK, f"logs_resume_{label}")
            logs[label] = []
            for stop in stops:
                jsonl = os.path.join(WORK, f"resume_{label}_{stop}.jsonl")
                run_cli(base + ["--log_dir", log, "--total_steps", str(stop),
                                "--output_every", "25", "--eval_every",
                                "1000", "--checkpoint_every", "50",
                                "--metrics_jsonl", jsonl])
                logs[label] += [(s, l) for s, l, _ in train_log(jsonl)]
    finally:
        torch.backends.cudnn.deterministic = saved
    blobs = []
    for label in ("whole", "split"):
        with open(os.path.join(WORK, f"logs_resume_{label}",
                               "ckpt_100.msgpack"), "rb") as f:
            blobs.append(f.read())
    check(logs["whole"] == logs["split"] and blobs[0] == blobs[1],
          f"resumed run (step, loss) {logs['split']} against the whole "
          f"run's {logs['whole']}; checkpoints equal: {blobs[0] == blobs[1]}")
    res["resume"] = logs
    print(f"[optim] eager 50 + 50 steps with a resume: (step, loss) "
          f"{logs['split']}, the 100-step run's bit for bit, and the same "
          f"step-100 checkpoint (cudnn.deterministic); on {card}", flush=True)
    return res


# ---- chunked dispatch over several ranks (30-31) ------------------------

# Phase 30 holds every logged loss of the 2-rank chunked DP CNN to a
# one-rank chunked run of the same global batch, rows and augmentation
# draws that sums its batch as the two ranks do: two microbatches of 64
# (--grad_accum 2; halving a gradient is exact, so (g0 + g1) / 2 equals
# g0/2 + g1/2), with cuDNN's deterministic algorithms on both sides. Then
# the two agree up to the decode's rounding, as phase 19's gate
# (SP_LOSS_TOL) reads it, relative here; on an H100 they agreed bit for
# bit (PERF.md). A one-rank run that sums all 128 images in one pass is
# printed beside it, not gated: 100 SGD steps carry its other summation
# order far (2.4e-4 relative at step 10, 0.74 at step 40 on an H100).
DP_CHUNK_LOSS_RTOL = 1e-3
# Phase 31: the DP CNN's steps, and the chunk of the ring SP and Ulysses
# long-context runs (their 10 steps in 2 replays).
DIST_CHUNK_STEPS, SP_CHUNK_K = 500, 5


def _rank_chunk(rank: int, job: dict) -> dict:
    """A chunked run as this rank (``Trainer.fit`` on the CLI's config):
    its launches, parameter digest, replays and index-stream misses; then
    on the trained state one graphed chunk against the eager body (cuDNN
    deterministic, ``_graph_vs_eager``) and ``job["reps"]`` replays timed
    by the host clock, then traced on rank 0 (``device_timeline``; the
    other ranks replay beside it). The graphs go before the process
    group: they hold resources of the communicators they captured. Each
    stage is printed to the rank's log as it ends."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from dml_cnn_cifar10_tpu_torch.cli.main import (build_parser,
                                                    config_from_args)
    from dml_cnn_cifar10_tpu_torch.data import pipeline as pipe
    from dml_cnn_cifar10_tpu_torch.ops import flash_attention as fa
    from dml_cnn_cifar10_tpu_torch.ops import optimizer as fused
    from dml_cnn_cifar10_tpu_torch.train import loop

    def stage(name):
        print(f"[chunk rank {rank}] {name} done", flush=True)

    if rank >= job.get("world", 1 << 30):
        return {"skipped": True}      # a run on the first ranks only
    cfg = config_from_args(build_parser().parse_args(
        job["argv"] + ["--task_index", str(rank)]))
    trainer = loop.Trainer(cfg, task_index=rank)
    try:
        result = trainer.fit()
    finally:
        trainer.logger.close()
    stage("fit")
    fn, k = trainer.train_fn, trainer.steps_per_dispatch
    res = {"launches": {**fa.LAUNCHES, **fused.LAUNCHES},
           "digest": _params_digest(_whole_params(result.state)),
           "replays": fn.graph.replays,
           "warmup_launches": fn.graph.warmup_launches,
           "misses": int(fn.rows.misses), "device": str(trainer.device)}
    images, labels = loop._full_split_arrays(
        trainer.input_pipeline(train=True, seed=cfg.seed),
        lambda: pipe.input_pipeline(cfg.data, trainer.local_batch,
                                    train=True, seed=cfg.seed))
    ds_images = torch.from_numpy(images).to(trainer.device)
    ds_labels = torch.from_numpy(labels.astype("int64")).to(trainer.device)
    c, fn_g, s_g = _graph_vs_eager(cfg, result.state, ds_images, ds_labels,
                                   True, k=k, mesh=trainer.mesh)
    res["graph_vs_eager"] = c
    stage("graph vs eager")
    reps = job["reps"]
    fn_g(s_g)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn_g(s_g)
    torch.cuda.synchronize()
    replay_ms = (time.perf_counter() - t0) / (reps * k) * 1e3
    res["replay_ms_per_step"] = replay_ms
    stage("timed replays")
    trainer.mesh.barrier()
    tracer = (profile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA])
              if rank == 0 else contextlib.nullcontext())
    with tracer as prof:
        for _ in range(reps):
            fn_g(s_g)
        torch.cuda.synchronize()
    fn_g.check()
    stage("traced replays")
    if rank == 0:
        timeline = device_timeline(prof, reps * k)
        res.update(timeline,
                   busy_share=timeline["device_any_ms"] / replay_ms,
                   h2d=[ev.key for ev in prof.key_averages()
                        if "HtoD" in ev.key],
                   kernels=[{"ms_per_step": ms, "per_step": n, "name": name}
                            for ms, n, name in _device_rows(prof,
                                                            reps * k)[:12]])
    fn_g.graph.release()
    trainer.close()
    torch.cuda.synchronize()
    stage("graphs released")
    trainer.mesh.barrier()
    dist.destroy_process_group()
    stage("process group destroyed")
    return res


def _dist_log_says(label: str, world: int, text: str) -> None:
    for r in range(world):
        check(any(l.startswith("[dist]") and text in l
                  for l in rank_log(label, r)),
              f"{label}: rank {r}'s [dist] line does not say {text!r}")


def chunk_gloo_phase(card) -> dict:
    """Phase 30: the DP CNN chunked on 2 ranks over gloo on this card, 2 x
    64 images, ``--steps_per_dispatch 10``, 50 steps: each chunk runs its
    eager body (gloo stages each collective through host memory, which no
    graph can hold; the ``[dist]`` line says so). K1 once a step per
    rank, equal parameter digests, and every logged loss (each chunk's)
    within ``DP_CHUNK_LOSS_RTOL`` of the one-rank chunked run at batch 128
    that sums the two halves as the ranks do (same seed, rows, draws and
    steps; cuDNN deterministic); the plain one-rank run printed beside."""
    from dml_cnn_cifar10_tpu_torch.ops import optimizer as fused

    common = cnn_args(WORK) + [
        "--steps_per_dispatch", str(CHUNK_K), "--total_steps", str(DP_STEPS),
        "--eval_every", "1000", "--output_every", str(CHUNK_K),
        "--checkpoint_every", "1000"]
    refs = {}
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for name, extra in (("halves", ["--grad_accum", "2"]),
                            ("whole", [])):
            jsonl = os.path.join(WORK, f"dp_chunk_ref_{name}.jsonl")
            fused.reset_launches()
            run_cli(common + extra + [
                "--log_dir", os.path.join(WORK, f"logs_dp_chunk_{name}"),
                "--metrics_jsonl", jsonl])
            check(fused.LAUNCHES["sgd_update_plain"] == DP_STEPS,
                  f"one-rank chunked reference launched {fused.LAUNCHES}")
            refs[name] = train_log(jsonl)
    finally:
        torch.backends.cudnn.deterministic = saved
    label, jsonl = "dp_chunk_gloo", os.path.join(WORK, "dp_chunk_gloo.jsonl")
    t0 = time.perf_counter()
    ranks = spawn_ranks(label, {"kind": "cli", "deterministic": True,
                                "argv": common + [
        "--log_dir", os.path.join(WORK, "logs_dp_chunk_gloo"),
        "--metrics_jsonl", jsonl] + _dist_args(2, "gloo")})
    wall = time.perf_counter() - t0
    for r in ranks:
        check(r["launches"]["sgd_update_plain"] == DP_STEPS
              and r["launches"]["sgd_update_momentum"] == 0,
              f"chunked DP over gloo launched "
              f"{[x['launches'] for x in ranks]}, want K1 = {DP_STEPS}")
    check(len({r["digest"] for r in ranks}) == 1,
          "chunked DP ranks over gloo ended with different parameters")
    _dist_log_says(label, 2, "chunks of 10 steps: the eager body")
    got = train_log(jsonl)
    gaps = {name: [abs(g[1] - r[1]) / abs(r[1]) for g, r in zip(got, ref)]
            for name, ref in refs.items()}
    ref = refs["halves"]
    check(len(got) == len(ref) == DP_STEPS // CHUNK_K
          and [g[0] for g in got] == [r[0] for r in ref]
          and all(math.isfinite(g[1]) for g in got)
          and max(gaps["halves"]) <= DP_CHUNK_LOSS_RTOL,
          f"chunked DP (step, loss, images/s) {got}; one rank in two "
          f"halves {ref}; relative gaps {gaps['halves']} (gate "
          f"{DP_CHUNK_LOSS_RTOL})")
    res = {"card": card, "train": got, "reference": ref,
           "reference_whole_batch": refs["whole"], "loss_rtol": gaps,
           "step_ms": 128 / got[-1][2] * 1e3,
           "reference_step_ms": 128 / ref[-1][2] * 1e3, "wall_s": wall,
           "launches": ranks[0]["launches"]}
    shutil.copy(jsonl, OUT)
    print(f"[dp chunk gloo] 2 ranks x 64 images on one card, chunks of "
          f"{CHUNK_K} run eagerly (gloo), cuDNN deterministic: (step, loss) "
          f"{[(s, l) for s, l, _ in got]}; relative loss gaps to one rank "
          f"summing the same halves {gaps['halves']} (gate "
          f"{DP_CHUNK_LOSS_RTOL}), to one rank summing 128 at once "
          f"{gaps['whole']} (printed); {res['step_ms']:.3f} ms/step against "
          f"{res['reference_step_ms']:.4f} on one rank; K1 "
          f"{ranks[0]['launches']['sgd_update_plain']} per rank, equal "
          f"parameters; {wall:.1f} s wall; on {card}", flush=True)
    return res


def _check_chunk_ranks(label, ranks, want, replays, warmup) -> None:
    """Phase 31's per-rank gates: the main path's launches, its replays
    and the warm-up's launches kept apart, no index-stream miss, equal
    digests, no host-to-device copy among the replays, and the replay's
    launches equal to the eager body's."""
    for r, x in enumerate(ranks):
        check(x["launches"] == want, f"{label}: rank {r} launched "
              f"{x['launches']}, want {want}")
        check(x["replays"] == replays and x["misses"] == 0,
              f"{label}: rank {r} {x['replays']} replays (want {replays}), "
              f"{x['misses']} index-stream misses")
        check(x["warmup_launches"] == warmup,
              f"{label}: rank {r} warm-up launched {x['warmup_launches']}, "
              f"want {warmup}")
        c = x["graph_vs_eager"]
        check(c["launches_graph"] == c["launches_eager"],
              f"{label}: rank {r} replay launched {c['launches_graph']}, "
              f"the eager body {c['launches_eager']}")
    check(len({x["digest"] for x in ranks}) == 1,
          f"{label}: ranks ended with different parameters")
    check(not ranks[0]["h2d"], f"{label}: host-to-device copies in rank "
          f"0's replays: {ranks[0]['h2d']}")


def chunk_nccl_phase(card, worlds) -> dict:
    """Phase 31 over NCCL, a card a rank, each chunk one CUDA graph replay
    with its collectives captured: the DP CNN on each of ``worlds`` ranks
    (K = 10, 500 steps), ring SP on 2 (phase 19's recipe) and, given three
    cards, Ulysses on 3 (phase 27's), K = 5 for 10 steps; each rank then
    holds one graphed chunk against the eager body and traces replays
    (``_rank_chunk``)."""
    count = torch.cuda.device_count()
    res = {"card": card, "cards": count}
    for world in worlds:
        label = f"dp_chunk{world}_nccl"
        jsonl = os.path.join(WORK, f"{label}.jsonl")
        t0 = time.perf_counter()
        ranks = spawn_ranks(label, {"kind": "chunk", "reps": 20, "argv":
                            cnn_args(WORK) + [
            "--steps_per_dispatch", str(CHUNK_K), "--log_dir",
            os.path.join(WORK, f"logs_{label}"), "--total_steps",
            str(DIST_CHUNK_STEPS), "--eval_every", "1000",
            "--output_every", "50", "--checkpoint_every", "1000",
            "--metrics_jsonl", jsonl] + _dist_args(world, "nccl")},
            world=world, timeout_s=300)
        wall = time.perf_counter() - t0
        _check_chunk_ranks(label, ranks, {
            "sgd_update_plain": DIST_CHUNK_STEPS, "sgd_update_momentum": 0,
            **dict.fromkeys(("flash_fwd", "flash_fwd_lse",
                             "flash_fwd_stats", "flash_bwd_dq",
                             "flash_bwd_dkv"), 0)},
            DIST_CHUNK_STEPS // CHUNK_K, {"sgd_update_plain": CHUNK_K})
        _dist_log_says(label, world, "one CUDA graph replay each")
        for r, x in enumerate(ranks):
            c = x["graph_vs_eager"]
            check(c["loss_gap"] <= CHUNK_LOSS_TOL * abs(c["loss_eager"])
                  and c["param_gap"] <= CHUNK_PARAM_TOL,
                  f"{label}: rank {r}'s graphed chunk differs from the "
                  f"eager body: {c}")
        train = train_log(jsonl)
        windows = [ips for step, _, ips in train if step > 100]
        loop_ms = 128 / (sum(windows) / len(windows)) * 1e3
        check(all(math.isfinite(l) for _, l, _ in train),
              f"{label}: losses {train}")
        x = ranks[0]
        res[f"dp{world}"] = {
            "losses": [l for _, l, _ in train], "loop_ms_per_step": loop_ms,
            "wall_s": wall, **{key: x[key] for key in (
                "replay_ms_per_step", "compute_ms", "comm_ms", "overlap_ms",
                "device_any_ms", "busy_share", "launches", "replays",
                "warmup_launches", "graph_vs_eager", "kernels", "device")},
            "replay_ms_by_rank": [y["replay_ms_per_step"] for y in ranks]}
        shutil.copy(jsonl, OUT)
        print(f"[dp chunk nccl] {world} ranks x {128 // world} images, "
              f"{DIST_CHUNK_STEPS} steps in {x['replays']} replays of "
              f"{CHUNK_K}: loop {loop_ms:.4f} ms/step (windows after step "
              f"100); 20 replays {x['replay_ms_per_step']:.4f} ms/step, rank "
              f"0's device busy {x['device_any_ms']:.4f} ms/step "
              f"({100 * x['busy_share']:.1f}%; replays on every rank "
              f"{[round(y['replay_ms_per_step'], 4) for y in ranks]} "
              f"ms/step), NCCL "
              f"{x['comm_ms']:.4f} ms/step of which {x['overlap_ms']:.4f} "
              f"beside compute; graph vs eager: loss "
              f"{x['graph_vs_eager']['loss_gap']:.3g}, params "
              f"{x['graph_vs_eager']['param_gap']:.3g}; K1 "
              f"{x['launches']['sgd_update_plain']} per rank (+{CHUNK_K} in "
              f"the warm-up, apart), equal parameters, no H2D copy; "
              f"{wall:.1f} s wall; on {min(count, world)} x {card}",
              flush=True)
        for kern in x["kernels"][:6]:
            print(f"[dp chunk nccl]   rank 0 {kern['ms_per_step']:.5f} "
                  f"ms/step x{kern['per_step']} {kern['name'][:100]}")
    # name, ranks, flags, the launch counts: of 10 steps with a
    # forward-only batch every 5 (phases 19 and 27), and of one chunk.
    sp_runs = [("ring", 2, ["--seq_axis", "2"], sp_launches)]
    if count >= ULYSSES_SEQ:
        sp_runs.append(("ulysses", ULYSSES_SEQ,
                        ["--seq_axis", str(ULYSSES_SEQ), "--sp_mode",
                         "ulysses"], ulysses_launches))
    for name, world, flags, launches in sp_runs:
        label = f"{name}_chunk_nccl"
        jsonl = os.path.join(WORK, f"{label}.jsonl")
        t0 = time.perf_counter()
        ranks = spawn_ranks(label, {"kind": "chunk", "reps": 2, "argv":
                            long_args(WORK) + flags + [
            "--batch_size", "2", "--steps_per_dispatch", str(SP_CHUNK_K),
            "--total_steps", str(LONG_STEPS), "--log_dir",
            os.path.join(WORK, f"logs_{label}"), "--metrics_jsonl", jsonl]
            + _dist_args(world, "nccl")}, world=world, timeout_s=420)
        wall = time.perf_counter() - t0
        _check_chunk_ranks(
            label, ranks, launches(LONG_STEPS, LONG_STEPS // 5),
            LONG_STEPS // SP_CHUNK_K,
            {k: n for k, n in launches(SP_CHUNK_K, 0).items() if n})
        _dist_log_says(label, world, "one CUDA graph replay each")
        for r, x in enumerate(ranks):
            c = x["graph_vs_eager"]
            check(c["loss_gap"] <= 1e-5 * abs(c["loss_eager"]),
                  f"{label}: rank {r}'s graphed chunk differs from the "
                  f"eager body: {c}")
        train = train_log(jsonl)
        check(len(train) == LONG_STEPS // 5
              and all(math.isfinite(l) for _, l, _ in train),
              f"{label}: (step, loss, images/s) {train}")
        x = ranks[0]
        res[name] = {"train": train, "step_ms": 2 / train[-1][2] * 1e3,
                     "wall_s": wall, **{key: x[key] for key in (
                         "replay_ms_per_step", "compute_ms", "comm_ms",
                         "overlap_ms", "device_any_ms", "busy_share",
                         "flash_ms", "launches", "replays",
                         "warmup_launches", "graph_vs_eager", "kernels")}}
        shutil.copy(jsonl, OUT)
        print(f"[{name} chunk nccl] {world} ranks, batch 2 x 8,100 tokens, "
              f"chunks of {SP_CHUNK_K}: (step, loss, images/s) {train}; "
              f"{res[name]['step_ms']:.2f} ms/step in steps 6-10; 2 replays "
              f"{x['replay_ms_per_step']:.2f} ms/step, rank 0's device "
              f"busy {x['device_any_ms']:.2f} ms/step "
              f"({100 * x['busy_share']:.1f}%), compute "
              f"{x['compute_ms']:.2f}, collectives {x['comm_ms']:.2f} of "
              f"which {x['overlap_ms']:.2f} beside compute; graph vs eager: "
              f"loss {x['graph_vs_eager']['loss_gap']:.3g}, params "
              f"{x['graph_vs_eager']['param_gap']:.3g}; launches per rank "
              f"{x['launches']}, equal parameters; {wall:.1f} s wall; on "
              f"{min(count, world)} x {card}", flush=True)
    return res


# Phase 32, run safety: the steps of its runs, the chunk size, the test
# accuracy the augmented telemetry run must reach after 200 steps (twice
# chance; the synthetic classes are separable, phase 9b reaches 50% by
# step 500), and the 2-rank runs' steps.
RS_STEPS, RS_K, RS_ACC_MIN = 200, 10, 0.2
RS_RANK_STEPS = 60
# Wall-clock cadence of the clock-save runs, and a bound on the time from
# one clock save's end to the next check of the clock: one eager dispatch
# and its boundary work (a few ms at batch 128).
RS_EVERY_SECS, RS_ITER_BOUND_S = 0.1, 0.05
# The 2-rank runs' cadence: due at every exchange (10 steps apart).
RS_RANK_EVERY_SECS = 0.01


def _rs_args(name, *extra):
    """Phase 32's CNN main-path recipe (``cnn_args``: fixed fidelity, so
    random crop and flip, standardize, the full-split eval) with its own
    log dir and metrics stream; ``extra`` flags come last and win."""
    return cnn_args(WORK) + [
        "--log_dir", os.path.join(WORK, f"logs_rs_{name}"),
        "--metrics_jsonl", os.path.join(WORK, f"rs_{name}.jsonl"),
        "--total_steps", str(RS_STEPS), "--output_every", "50",
        "--eval_every", "100", "--checkpoint_every", "50", *extra]


def _rs_fit(args, expect=None, keep=None):
    """``Trainer.fit`` on the CLI's config of ``args``, echoing its
    console; returns ``(trainer, result, wall_s, K1/K2 launches)``, or
    with ``expect`` the exception of that type the run must raise in
    place of the result. The caller closes the trainer (its graph)."""
    from dml_cnn_cifar10_tpu_torch.cli.main import (build_parser,
                                                    config_from_args)
    from dml_cnn_cifar10_tpu_torch.ops import optimizer as fused
    from dml_cnn_cifar10_tpu_torch.train.loop import Trainer
    print("$ python -m dml_cnn_cifar10_tpu_torch " + " ".join(args),
          flush=True)
    cfg = config_from_args(build_parser().parse_args(args))
    if keep is not None:
        cfg.keep_checkpoints = keep
    trainer = Trainer(cfg)
    fused.reset_launches()
    t0 = time.perf_counter()
    try:
        out = trainer.fit()
    except Exception as e:
        if expect is None or not isinstance(e, expect):
            raise
        out = e
    else:
        check(expect is None, f"{args}: expected {expect} and the run "
              f"ended at step {out.final_step}")
    wall = time.perf_counter() - t0
    return trainer, out, wall, dict(fused.LAUNCHES)


def _rs_records(name, kind=None):
    recs = records(os.path.join(WORK, f"rs_{name}.jsonl"))
    return [r for r in recs if kind is None or r["kind"] == kind]


def _rs_ckpts(name):
    """``{step: path}`` of the checkpoints in a phase 32 log dir."""
    d = os.path.join(WORK, f"logs_rs_{name}")
    return {int(n[5:-8]): os.path.join(d, n) for n in os.listdir(d)
            if n.startswith("ckpt_") and n.endswith(".msgpack")}


def _finite_ckpt(path) -> bool:
    from dml_cnn_cifar10_tpu_torch import convert
    from dml_cnn_cifar10_tpu_torch.ckpt import checkpoint as ckpt_lib
    with open(path, "rb") as f:
        tree = ckpt_lib.from_bytes(f.read())
    return all(bool(torch.isfinite(t).all()) for t in
               convert.params_from_jax(tree["params"]).values())


def _chunk_costs(cfg, state, ds_images, ds_labels, reps=30) -> dict:
    """Replay ms/step of the resident chunk (K = ``RS_K``) with the jitter
    (brightness and contrast) and the health scalars each on and off,
    each from a copy of ``state``: captured once each, then ``reps``
    replays timed by the host clock around a synchronize, in turns
    (plain, health, jitter, both, then back), each the mean of its two
    turns."""
    from dml_cnn_cifar10_tpu_torch.parallel import step as step_lib
    plain = dataclasses.replace(cfg.data, random_brightness=0.0,
                                random_contrast=0.0)
    variants = {"plain": (plain, False), "health": (plain, True),
                "jitter": (cfg.data, False), "both": (cfg.data, True)}
    fns = {}
    for (name, (data, health)), (model, st) in zip(
            variants.items(), _state_copies(cfg, state, len(variants))):
        fn = step_lib.make_train_chunk_resident(
            model, cfg.optim, ds_images, ds_labels, data_cfg=data,
            index_stream=(cfg.data.seed, cfg.batch_size, RS_K),
            health_metrics=health)
        fn(st)                                   # the capture
        fns[name] = (fn, st)
    times = {name: [] for name in variants}
    for name in list(variants) + list(variants)[::-1]:
        fn, st = fns[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(st)
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) / (reps * RS_K) * 1e3)
    for fn, _ in fns.values():
        if fn.graph is not None:        # None on the CPU (a rehearsal)
            fn.graph.release()
    return {name: sum(v) / len(v) for name, v in times.items()}


def _window_ms(name) -> float:
    """Mean ms/step of a run's ``train`` windows after its first."""
    ips = [r["images_per_sec"] for r in _rs_records(name, "train")][1:]
    return 128 / (sum(ips) / len(ips)) * 1e3


def rs_telemetry(card) -> dict:
    """Phase 32.1: 200 resident chunked steps (K = 10) with brightness,
    contrast, telemetry, the Chrome trace and health on, beside the same
    run with these flags off, in this call."""
    from dml_cnn_cifar10_tpu_torch.train import loop

    trace = os.path.join(WORK, "rs_trace.json")
    chunked = ["--steps_per_dispatch", str(RS_K)]
    res = {}
    for name, extra in (("plain", []), ("telemetry", [
            "--random_brightness", "63", "--random_contrast", "0.8",
            "--telemetry", "true", "--trace_events_path", trace,
            "--health_metrics", "true"])):
        trainer, result, wall, launched = _rs_fit(_rs_args(
            name, *chunked, *extra))
        check(launched == {"sgd_update_plain": RS_STEPS,
                           "sgd_update_momentum": 0},
              f"run safety {name}: launched {launched}, want K1 = "
              f"{RS_STEPS}")
        res[name] = {"window_ms_per_step": _window_ms(name), "wall_s": wall,
                     "launches": launched}
        if name == "telemetry":
            cfg = trainer.cfg
            images, labels = loop._full_split_arrays(
                trainer.input_pipeline(train=True, seed=cfg.seed), None)
            ds_images = torch.from_numpy(images).to(trainer.device)
            ds_labels = torch.from_numpy(labels.astype("int64")).to(
                trainer.device)
            c, _, _ = _graph_vs_eager(cfg, result.state, ds_images,
                                      ds_labels, True, health=True)
            res["graph_vs_eager"] = c
            res["replay_ms_per_step"] = _chunk_costs(
                cfg, result.state, ds_images, ds_labels)
        trainer.close()
    c = res["graph_vs_eager"]
    check(c["loss_gap"] == 0 and c["param_gap"] == 0
          and c["health_graph"] == c["health_eager"]
          and len(c["health_graph"]) == 3
          and c["launches_graph"] == c["launches_eager"],
          f"run safety: a graphed chunk with brightness, contrast and "
          f"health differs from its eager body under deterministic cuDNN: "
          f"{c}")
    recs = _rs_records("telemetry")
    train = [r for r in recs if r["kind"] == "train"]
    health = ("health_grad_norm", "health_param_norm",
              "health_update_ratio")
    check(len(train) == RS_STEPS // 50 and all(
        r["loss"] is not None and math.isfinite(r["loss"])
        and all(r[key] is not None and math.isfinite(r[key])
                for key in health)
        and 0 < r["health_update_ratio"] < 1 for r in train),
        f"run safety: train records {train}")
    acc = [r["test_accuracy"] for r in recs if r["kind"] == "eval"]
    check(acc and acc[-1] >= RS_ACC_MIN,
          f"run safety: test accuracy {acc}, gate {RS_ACC_MIN}")
    spans = {r["name"] for r in recs if r["kind"] == "span"}
    gps = [r for r in recs if r["kind"] == "goodput"]
    hbm = [r for r in recs if r["kind"] == "hbm"]
    check({"data_wait", "compile_first_dispatch", "dispatch",
           "boundary_drain", "eval", "checkpoint"} <= spans,
          f"run safety: spans {spans}")
    check(gps and gps[-1].get("final") == 1 and all(
        abs(sum(v for k, v in g.items() if k.endswith("_frac")) - 1)
        <= 1e-6 for g in gps), f"run safety: goodput {gps}")
    check(hbm and all(h["available"] and 0 < h["peak_bytes"]
                      <= h["bytes_limit"] for h in hbm),
          f"run safety: hbm {hbm}")
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    check(events, "run safety: empty Chrome trace")
    lint = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "check_jsonl_schema.py"),
         "--strict", os.path.join(WORK, "rs_telemetry.jsonl")],
        capture_output=True, text=True, timeout=120)
    check(lint.returncode == 0, f"run safety: schema lint {lint.stdout} "
          f"{lint.stderr}")
    shutil.copy(os.path.join(WORK, "rs_telemetry.jsonl"), OUT)
    shutil.copy(trace, OUT)
    res.update(test_accuracy=acc[-1], goodput=gps[-1], hbm=hbm[-1],
               health={key: train[-1][key] for key in health},
               spans=sorted(spans), trace_events=len(events))
    on, off = res["telemetry"], res["plain"]
    rep = res["replay_ms_per_step"]
    print(f"[run safety] 200 chunked steps with brightness 63, contrast "
          f"0.8, telemetry, trace and health: test accuracy "
          f"{100 * acc[-1]:.2f}% (gate {100 * RS_ACC_MIN:.0f}%), health "
          f"{res['health']}, goodput {gps[-1]}, peak device memory "
          f"{hbm[-1]['peak_bytes']} of {hbm[-1]['bytes_limit']} bytes, "
          f"{len(events)} trace events, schema strict OK; graph vs eager "
          f"bit-equal (loss, params, health) under deterministic cuDNN; "
          f"K1 {on['launches']['sgd_update_plain']}; loop "
          f"{on['window_ms_per_step']:.4f} ms/step against "
          f"{off['window_ms_per_step']:.4f} with the flags off; replays "
          f"(ms/step, in turns) plain {rep['plain']:.4f}, health "
          f"{rep['health']:.4f}, brightness+contrast {rep['jitter']:.4f}, "
          f"both {rep['both']:.4f}; on {card}", flush=True)
    return res


def rs_tensorboard(card) -> dict:
    """Phase 32's ``--tensorboard_dir``: with ``tensorboardX`` importable
    here, 50 eager steps write event files; without it the trainer
    raises ``ImportError`` naming the package before any step."""
    import importlib.util
    tb = os.path.join(WORK, "rs_tb")
    args = _rs_args("tensorboard", "--total_steps", "50", "--eval_every",
                    "1000", "--tensorboard_dir", tb)
    if importlib.util.find_spec("tensorboardX") is None:
        try:
            _rs_fit(args)
        except ImportError as e:
            check("tensorboardX" in str(e) and not os.path.exists(
                os.path.join(WORK, "rs_tensorboard.jsonl")),
                f"run safety tensorboard: {e}")
            res = {"tensorboardX": False, "error": str(e)}
        else:
            fail("run safety: --tensorboard_dir without tensorboardX ran")
    else:
        trainer, result, _, _ = _rs_fit(args)
        trainer.close()
        sizes = [os.path.getsize(os.path.join(tb, n)) for n in os.listdir(tb)]
        check(result.final_step == 50 and sizes and all(sizes),
              f"run safety tensorboard: event files {sizes}")
        res = {"tensorboardX": True, "event_bytes": sum(sizes)}
    print(f"[run safety] --tensorboard_dir: {res}; on {card}", flush=True)
    return res


def rs_numerics(card) -> dict:
    """Phase 32.2: ``--check_numerics --fault_spec nan@105`` chunked with
    skip, halt and rollback, and skip eagerly under momentum."""
    res = {}
    guard = ["--check_numerics", "true", "--fault_spec", "nan@105"]
    chunked = ["--steps_per_dispatch", str(RS_K)]
    trainer, result, wall, launched = _rs_fit(_rs_args(
        "skip", *chunked, *guard, "--on_nonfinite", "skip"))
    trainer.close()
    got = [(r["kind"], r["step"], r.get("injected", r.get("action")))
           for r in _rs_records("skip") if r["kind"] in ("fault",
                                                         "recovery")]
    losses = [r["loss"] for r in _rs_records("skip", "train")]
    ckpts = _rs_ckpts("skip")
    check(result.final_step == RS_STEPS
          and got == [("fault", 110, True), ("fault", 150, False),
                      ("recovery", 150, "skip")]
          and losses[-1] is not None and math.isfinite(losses[-1])
          and launched["sgd_update_plain"] == RS_STEPS
          and ckpts and all(_finite_ckpt(p) for p in ckpts.values()),
          f"run safety skip: step {result.final_step}, records {got}, "
          f"losses {losses}, launches {launched}, checkpoints "
          f"{sorted(ckpts)}")
    res["skip"] = {"records": got, "losses": losses, "ckpts": sorted(ckpts),
                   "wall_s": wall}
    for policy, last in (("halt", "numerics_halt"), ("rollback", "fault")):
        trainer, err, wall, _ = _rs_fit(_rs_args(
            policy, *chunked, *guard, "--on_nonfinite", policy),
            expect=FloatingPointError)
        trainer.close()
        recs = [r for r in _rs_records(policy)
                if r["kind"] in ("fault", "numerics_halt")]
        ckpts = sorted(_rs_ckpts(policy))
        check(recs and recs[-1]["kind"] == last and recs[-1]["step"] == 150
              and ckpts == [50, 100],
              f"run safety {policy}: records {recs}, checkpoints {ckpts}, "
              f"error {err}")
        res[policy] = {"error": str(err), "ckpts": ckpts}
    trainer, result, wall, launched = _rs_fit(_rs_args(
        "skip_momentum", "--momentum", "0.9", *guard, "--on_nonfinite",
        "skip"))
    trainer.close()
    mom = result.state.opt["momentum"]
    check(result.final_step == RS_STEPS
          and launched == {"sgd_update_plain": 0,
                           "sgd_update_momentum": RS_STEPS}
          and [r["step"] for r in _rs_records("skip_momentum", "recovery")]
          == [150]
          and all(bool(torch.isfinite(t).all()) for t in mom.values())
          and all(bool(torch.isfinite(p).all())
                  for p in result.state.params.values()),
          f"run safety eager skip under momentum: step "
          f"{result.final_step}, launches {launched}")
    res["skip_momentum"] = {"launches": launched, "wall_s": wall}
    print(f"[run safety] nan@105, chunked: skip recovered at 150 and ran "
          f"to {RS_STEPS} (checkpoints {res['skip']['ckpts']} all finite); "
          f"halt and rollback raised at 150 with checkpoints "
          f"{res['halt']['ckpts']}; eager skip under momentum restored "
          f"K2's momenta (K2 {RS_STEPS}); on {card}", flush=True)
    return res


def rs_preempt(card) -> dict:
    """Phase 32.3: ``--fault_spec sigterm@150``, eager and chunked, each
    stopped, resumed to 300 and held to an uninterrupted 300-step run, bit
    for bit under deterministic cuDNN."""
    from dml_cnn_cifar10_tpu_torch.ckpt import checkpoint as ckpt_lib
    res = {}
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for name, k in (("eager", 1), ("chunked", RS_K)):
            common = ["--steps_per_dispatch", str(k), "--total_steps", "300",
                      "--eval_every", "1000"]
            trainer, full, _, _ = _rs_fit(_rs_args(f"full_{name}", *common))
            trainer.close()
            cut_args = _rs_args(f"cut_{name}", *common)
            trainer, cut, _, _ = _rs_fit(cut_args + ["--fault_spec",
                                                     "sigterm@150"])
            trainer.close()
            stop = 150 + k
            pre = _rs_records(f"cut_{name}", "preempt")
            latest = ckpt_lib.latest_checkpoint(
                os.path.join(WORK, f"logs_rs_cut_{name}"))
            check(cut.preempted and cut.final_step == stop
                  and [r["step"] for r in pre] == [stop]
                  and latest.endswith(f"ckpt_{stop}.msgpack"),
                  f"run safety sigterm {name}: preempted {cut.preempted} at "
                  f"{cut.final_step} (want {stop}), preempt records {pre}, "
                  f"latest {latest}")
            trainer, resumed, _, launched = _rs_fit(cut_args)
            trainer.close()
            equal = all(torch.equal(p, resumed.state.params[n])
                        for n, p in full.state.params.items())
            check(resumed.final_step == 300 and equal
                  and launched["sgd_update_plain"] == 300 - stop,
                  f"run safety sigterm {name}: resumed to "
                  f"{resumed.final_step}, launches {launched}, bit-equal "
                  f"to the uninterrupted run: {equal}")
            res[name] = {"stop": stop, "signum": pre[0]["signum"]}
    finally:
        torch.backends.cudnn.deterministic = saved
    print(f"[run safety] SIGTERM at step 150 (os.kill, delivered on this "
          f"machine): eager stopped at {res['eager']['stop']}, chunked at "
          f"{res['chunked']['stop']}, each with its checkpoint and a "
          f"preempt record; resumed to 300, bit-equal to the uninterrupted "
          f"runs; on {card}", flush=True)
    return res


def rs_checkpoints(card) -> dict:
    """Phase 32.4: async against sync checkpoints (bytes, and the eager
    loop's ms/step across the saves), the wall-clock cadence, and a
    corrupted checkpoint's fallback."""
    from dml_cnn_cifar10_tpu_torch.ckpt import checkpoint as ckpt_lib
    from dml_cnn_cifar10_tpu_torch.utils import faults
    res = {}
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    files = {}
    try:
        for name in ("sync", "async"):
            trainer, result, wall, _ = _rs_fit(_rs_args(
                name, "--async_checkpoint",
                "true" if name.startswith("async") else "false"))
            trainer.close()
            d = os.path.join(WORK, f"logs_rs_{name}")
            files[name] = {n: open(os.path.join(d, n), "rb").read()
                           for n in sorted(os.listdir(d))}
            done = _rs_records(name, "done")[-1]
            res[name] = {"ms_per_step": 128 / done["images_per_sec"] * 1e3,
                         "wall_s": wall}
    finally:
        torch.backends.cudnn.deterministic = saved
    check(files["async"] == files["sync"]
          and any(n.endswith(".msgpack") for n in files["sync"]),
          f"run safety: async checkpoint files differ from sync: "
          f"{sorted(files['async'])} / {sorted(files['sync'])}")
    # The clock cadence, the step cadence past the run.
    trainer, result, wall, _ = _rs_fit(_rs_args(
        "clock", "--total_steps", "300", "--checkpoint_every", "100000",
        "--eval_every", "1000", "--checkpoint_every_secs",
        str(RS_EVERY_SECS), "--telemetry", "true"), keep=10_000)
    trainer.close()
    saves = sorted(_rs_ckpts("clock"))
    spans = [r for r in _rs_records("clock", "span")
             if r["name"] == "checkpoint"]
    total = _rs_records("clock", "goodput")[-1]["total_s"]
    longest = max(r["dur_s"] for r in spans)
    expected = int(total // (RS_EVERY_SECS + longest + RS_ITER_BOUND_S)) - 1
    clock_saves = len(saves) - 1          # the final save is not the clock's
    check(clock_saves >= max(expected, 1) and saves[-1] == 300,
          f"run safety clock: {clock_saves} wall-clock saves at {saves} in "
          f"{total} s, expected at least {expected}")
    res["clock"] = {"saves": saves, "expected_min": expected,
                    "loop_s": total, "longest_save_s": longest}
    # ckpt_corrupt, then a crash: the restore walks back past it.
    trainer, err, _, _ = _rs_fit(_rs_args(
        "corrupt", "--total_steps", "120", "--eval_every", "1000",
        "--fault_spec", "ckpt_corrupt@110,data_stall@110"),
        expect=faults.DataStallError)
    trainer.close()
    d = os.path.join(WORK, "logs_rs_corrupt")
    ok, _ = ckpt_lib.verify_checkpoint(os.path.join(d, "ckpt_100.msgpack"))
    from dml_cnn_cifar10_tpu_torch.cli.main import (build_parser,
                                                    config_from_args)
    from dml_cnn_cifar10_tpu_torch.train.loop import Trainer
    trainer = Trainer(config_from_args(build_parser().parse_args(
        _rs_args("corrupt"))))
    restored = int(trainer.init_or_restore().step)
    trainer.close()
    check(not ok and restored == 50,
          f"run safety ckpt_corrupt: ckpt_100 verifies {ok}, restore came "
          f"back at step {restored}, want 50")
    res["corrupt"] = {"restored": restored}
    print(f"[run safety] async checkpoints byte-identical to sync (steps "
          f"{sorted(k for k in files['sync'] if k.endswith('.msgpack'))}); "
          f"eager loop across saves every 50 steps: sync "
          f"{res['sync']['ms_per_step']:.4f}, async "
          f"{res['async']['ms_per_step']:.4f} ms/step; every "
          f"{RS_EVERY_SECS} s: {clock_saves} clock saves in "
          f"{total:.2f} s (at least {expected}); ckpt_corrupt@110 then a "
          f"crash: the restore fell back to step 50; on {card}", flush=True)
    return res


def _rank_fit(rank: int, job: dict) -> dict:
    """``Trainer.fit`` on the CLI's config for each run of ``job["runs"]``
    (a list of per-rank argvs) as this rank; returns each run's final
    step, whether it was preempted, the steps this rank's checkpoint
    manager saved at, whether the final parameters are finite, and the
    K1/K2 launches over all runs. The chunk graphs go before each run's
    process group."""
    import torch.distributed as dist

    from dml_cnn_cifar10_tpu_torch.ckpt import checkpoint as ckpt_lib
    from dml_cnn_cifar10_tpu_torch.cli.main import (build_parser,
                                                    config_from_args)
    from dml_cnn_cifar10_tpu_torch.ops import optimizer as fused
    from dml_cnn_cifar10_tpu_torch.train.loop import Trainer

    saved, save = [], ckpt_lib.CheckpointManager.maybe_save

    def spy(self, state, step, force=False, data_state=None):
        did = save(self, state, step, force=force, data_state=data_state)
        if did:
            saved.append(step)
        return did

    ckpt_lib.CheckpointManager.maybe_save = spy
    out = []
    for argvs in job["runs"]:
        saved.clear()
        cfg = config_from_args(build_parser().parse_args(
            argvs[rank] + ["--task_index", str(rank)]))
        trainer = Trainer(cfg, task_index=rank)
        try:
            result = trainer.fit()
        finally:
            trainer.close()
            if dist.is_initialized():
                dist.destroy_process_group()
        out.append({"final_step": result.final_step,
                    "preempted": result.preempted, "saved": list(saved),
                    "finite": all(bool(torch.isfinite(p).all())
                                  for p in result.state.params.values())})
        print(f"[fit rank {rank}] {out[-1]}", flush=True)
    return {"runs": out, "launches": dict(fused.LAUNCHES)}


def rs_ranks(card, backend: str) -> dict:
    """Phase 32.5 (and its ``--dist`` case over NCCL): the DP CNN on 2 rank
    processes, ``RS_RANK_STEPS`` steps a run: only rank 1 is sent SIGTERM
    (both ranks stop at the same step with one checkpoint), a wall-clock
    cadence (both ranks save at the same steps), and ``skip`` (both
    recover). Over gloo on this card each step runs eagerly; over NCCL the
    chunks (K = 10) are CUDA graphs and the flag exchange runs between
    their replays."""
    k = 1 if backend == "gloo" else RS_K
    label = f"run_safety_{backend}"
    runs, names = [], ("sigterm", "clock", "skip")
    for name, extra, rank1 in (
            ("sigterm", [], ["--fault_spec", "sigterm@25"]),
            ("clock", ["--checkpoint_every_secs", str(RS_RANK_EVERY_SECS)],
             []),
            ("skip", ["--check_numerics", "true", "--on_nonfinite", "skip",
                      "--fault_spec", "nan@25"], [])):
        base = cnn_args(WORK) + [
            "--log_dir", os.path.join(WORK, f"logs_{label}_{name}"),
            "--metrics_jsonl", os.path.join(WORK, f"{label}_{name}.jsonl"),
            "--total_steps", str(RS_RANK_STEPS), "--output_every", "10",
            "--eval_every", "1000", "--checkpoint_every", "1000",
            "--steps_per_dispatch", str(k), "--preempt_sync_every", "10",
            *extra] + _dist_args(2, backend)
        runs.append([base, base + rank1])
    t0 = time.perf_counter()
    ranks = spawn_ranks(label, {"kind": "fit", "runs": runs},
                        timeout_s=420)
    wall = time.perf_counter() - t0
    by_run = {name: [r["runs"][i] for r in ranks]
              for i, name in enumerate(names)}
    # Rank 1 is signalled at the seam of step 25 (30 chunked); the next
    # exchange, every 10 steps, stops both.
    stop = 30 if k == 1 else 40
    sig, clock, skip = by_run["sigterm"], by_run["clock"], by_run["skip"]
    check([r["final_step"] for r in sig] == [stop, stop]
          and all(r["preempted"] for r in sig)
          and sig[0]["saved"] == sig[1]["saved"] == [stop],
          f"{label}: SIGTERM to rank 1 only: {sig}, want both stopped at "
          f"{stop} with one save")
    check(clock[0]["saved"] == clock[1]["saved"]
          and len(clock[0]["saved"]) >= 2,
          f"{label}: clock saves by rank {[r['saved'] for r in clock]}")
    check([r["final_step"] for r in skip] == [RS_RANK_STEPS] * 2
          and all(r["finite"] for r in skip),
          f"{label}: skip {skip}")
    want = stop + 2 * RS_RANK_STEPS
    for r, x in enumerate(ranks):
        check(x["launches"]["sgd_update_plain"] == want,
              f"{label}: rank {r} launched {x['launches']}, want K1 = "
              f"{want}")
    if backend == "nccl":
        _dist_log_says(label, 2, "one CUDA graph replay each")
    print(f"[run safety {backend}] 2 ranks, chunks of {k}: SIGTERM to rank "
          f"1 at step 25 stopped both at {stop} with one checkpoint; clock "
          f"saves at {clock[0]['saved']} on both; skip recovered on both; "
          f"K1 {want} per rank; {wall:.1f} s wall; on {card}", flush=True)
    return {"sigterm": sig, "clock": clock, "skip": skip, "wall_s": wall,
            "launches": ranks[0]["launches"]}


def run_safety_phase(card) -> dict:
    """Phase 32 on this card (see the module docstring)."""
    t0 = time.perf_counter()
    res = {"card": card, "telemetry": rs_telemetry(card),
           "tensorboard": rs_tensorboard(card),
           "numerics": rs_numerics(card), "preempt": rs_preempt(card),
           "checkpoints": rs_checkpoints(card),
           "ranks_gloo": rs_ranks(card, "gloo")}
    res["wall_s"] = time.perf_counter() - t0
    with open(os.path.join(OUT, "slice12.json"), "w") as f:
        json.dump(res, f, indent=1)
    print(f"[run safety] phase 32 took {res['wall_s']:.1f} s", flush=True)
    return res


# ---------------------------------------------------------------------------
# 33. sharded state: ZeRO-1 and FSDP over the data ranks (parallel/zero.py)
# ---------------------------------------------------------------------------

# Phase 33's eager runs (gloo, 2 ranks on this card): steps a run, and the
# sharded checkpoint's half; --dist's NCCL runs: eager steps a run, and the
# ViT-Ti's.
SHARD_STEPS, SHARD_HALF = 50, 25
SHARD_NCCL_STEPS, SHARD_VIT_STEPS, SHARD_PARITY_STEPS = 100, 20, 1
# zero1 and fsdp against replicated DP: the CPU pins (tests/test_torch_
# zero1.py: 1e-6 absolute; test_torch_fsdp.py: 2e-5 relative + 2e-6).
SHARD_ZERO1_TOL, SHARD_FSDP_RTOL, SHARD_FSDP_ATOL = 1e-6, 2e-5, 2e-6


def _tree_leaves(tree, prefix=""):
    """``(path, leaf)`` of a state tree; a ResNet ``model_state``'s
    ``None`` leaves are no leaves."""
    out = []
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, dict):
            out += _tree_leaves(value, f"{prefix}{key}/")
        elif value is not None:
            out.append((f"{prefix}{key}", value))
    return out


def _tree_gaps(a, b) -> dict:
    """Largest absolute gap between two state trees, and the largest
    excess over the fsdp pin (|a - b| - atol - rtol |b|), over every leaf
    of the params and the optimizer state but the step."""
    import numpy as np
    la, lb = dict(_tree_leaves(a)), dict(_tree_leaves(b))
    check(sorted(la) == sorted(lb), f"state trees differ: {sorted(la)} vs "
          f"{sorted(lb)}")
    gap = excess = 0.0
    for path, x in la.items():
        if path == "opt/step":
            continue
        d = np.abs(np.asarray(x, np.float64) - np.asarray(lb[path],
                                                          np.float64))
        gap = max(gap, float(d.max(initial=0.0)))
        excess = max(excess, float((d - SHARD_FSDP_ATOL - SHARD_FSDP_RTOL
                                    * np.abs(lb[path])).max(initial=-1.0)))
    return {"gap": gap, "fsdp_pin_excess": excess}


def _rank_shard(rank: int, job: dict) -> dict:
    """``Trainer.fit`` for each run of ``job["runs"]`` (``name``, ``argv``
    and ``compare``, names of earlier runs) as this rank: its K1/K2
    launches, the trainer's images/s, this rank's bytes of parameters and
    of optimizer state (the live tensors: its shards under zero1/fsdp),
    and the gaps of its whole state (gathered while the process group
    lives) to each compared run's, under ``gaps``."""
    import torch.distributed as dist

    from dml_cnn_cifar10_tpu_torch.ckpt import checkpoint as ckpt_lib
    from dml_cnn_cifar10_tpu_torch.cli.main import (build_parser,
                                                    config_from_args)
    from dml_cnn_cifar10_tpu_torch.ops import optimizer as fused
    from dml_cnn_cifar10_tpu_torch.train.loop import Trainer

    def nbytes(values):
        return sum(t.numel() * t.element_size() for t in values)

    trees, out = {}, {}
    for run in job["runs"]:
        cfg = config_from_args(build_parser().parse_args(
            run["argv"] + ["--task_index", str(rank)]))
        fused.reset_launches()
        trainer = Trainer(cfg, task_index=rank)
        try:
            result = trainer.fit()
            trees[run["name"]] = ckpt_lib.state_to_tree(result.state)
            st = result.state
            res = {"final_step": result.final_step,
                   "images_per_sec": result.images_per_sec,
                   "launches": dict(fused.LAUNCHES),
                   "param_bytes": nbytes(st.params.values()),
                   "opt_bytes": nbytes(t for k, v in st.opt.items()
                                       if isinstance(v, dict)
                                       for t in v.values()),
                   "layout": None if st.layout is None else st.layout.mode}
        finally:
            trainer.close()
            if dist.is_initialized():
                dist.destroy_process_group()
        for other in run.get("compare", ()):
            res.setdefault("gaps", {})[other] = _tree_gaps(
                trees[run["name"]], trees[other])
        out[run["name"]] = res
        print(f"[shard rank {rank}] {run['name']}: {res}", flush=True)
    return {"runs": out}


def update_kernel_rows(dev, card, bytes_per_s, ops_per_s, cases, what,
                       total=1_068_298, launches=1) -> dict:
    """K1 and K2 on the leaves a rank's update takes: ``cases`` is
    ``[(kernel name, mu, wd, tag, make)]``, ``make()`` a fresh
    ``{name: tensor}`` of the leaves (random values). One launch against
    the plain version on the same leaves, bit for bit; then timed by CUDA
    events and by the kernel's device time beside the plain version,
    ``torch.optim.SGD(fused=True)`` over the same tensors (a yardstick; by
    events and by the device time of its kernels), and the bound of the
    bytes and operations of the update. ``what(tag)`` names the leaves in
    the printed line; ``launches`` is how many launches one update of
    them takes (``MAX_LEAVES`` leaves a launch)."""
    from dml_cnn_cifar10_tpu_torch.ops import optimizer as fused

    lr = torch.tensor(0.02, device=dev)
    rows = {}
    for name, mu, wd, tag, make in cases:
        params, grads = make(), make()
        mom = make() if mu else None
        want = {k: fused.fused_sgd_update_plain(
            params[k], grads[k], mom[k] if mom else None, lr, mu, wd)
            for k in params}
        before = dict(fused.LAUNCHES)
        fused.fused_sgd_update(params, grads, mom, lr, mu, wd)
        torch.cuda.synchronize()
        launched = {k: fused.LAUNCHES[k] - before[k] for k in before
                    if fused.LAUNCHES[k] != before[k]}
        check(launched == {name: launches}, f"{name} on {what(tag)} "
              f"launched {launched}, want {launches}")
        err = 0.0
        for k, (want_p, want_m) in want.items():
            err = max(err, (params[k] - want_p).abs().max().item())
            if mom:
                err = max(err, (mom[k] - want_m).abs().max().item())
        check(err == 0.0, f"{name} on {what(tag)}: max |kernel - plain| "
              f"{err}, want 0 (bit-equal)")

        def kernel_step():
            fused.fused_sgd_update(params, grads, mom, lr, mu, wd)

        def plain_step():
            for k in params:
                fused.fused_sgd_update_plain(
                    params[k], grads[k], mom[k] if mom else None, lr, mu, wd)

        lib_params = [torch.nn.Parameter(t.clone()) for t in params.values()]
        for lp, g in zip(lib_params, grads.values()):
            lp.grad = g.clone()
        lib = torch.optim.SGD(lib_params, lr=0.02, momentum=mu,
                              weight_decay=wd, fused=True)
        n = sum(t.numel() for t in params.values())
        per_bytes, per_ops = (20, 4) if mu else (12, 2)
        if wd:
            per_ops += 2
        by_bytes = (per_bytes * n + 4) / bytes_per_s * 1e3
        by_ops = per_ops * n / ops_per_s * 1e3
        rows[name] = dict(
            ms=cuda_ms(kernel_step),
            plain_ms=cuda_ms(plain_step, reps=50, warmup=5),
            library_ms=cuda_ms(lib.step), bound_ms=max(by_bytes, by_ops),
            device_ms=device_ms(kernel_step, "sgd_multi_kernel"),
            library_device_ms=sum(kernel_ms(lib.step).values()),
            bound_by="bytes" if by_bytes >= by_ops else "operations",
            max_abs_err=err, elements=n, leaves=len(params), mu=mu, wd=wd,
            tag=tag)
        r = rows[name]
        r["launches_per_update"] = launches
        print(f"[update kernels] {name} (mu={mu}, wd={wd}) on "
              f"{what(tag)} ({n} of {total} elements, {len(params)} "
              f"tensors, {launches} launch(es)): bit-equal to the plain "
              f"version; "
              f"kernel {r['ms']:.5f} ms (device {r['device_ms']} ms), "
              f"plain {r['plain_ms']:.5f} ms, torch.optim.SGD(fused=True) "
              f"{r['library_ms']:.5f} ms (device "
              f"{r['library_device_ms']:.5f} ms), bound "
              f"{r['bound_ms']:.5f} ms ({r['bound_by']}) on {card}",
              flush=True)
    return rows


def shard_kernel_rows(dev, card, bytes_per_s, ops_per_s, world=2,
                      cases=(("sgd_update_plain", 0.0, 0.0, "zero1"),
                             ("sgd_update_momentum", 0.9, 5e-4, "fsdp"))
                      ) -> dict:
    """K1 (and K2) on one rank's shard buffers at ``world`` data ranks, the
    layout the step hands them (``parallel/zero.py``: every split leaf a
    contiguous view of one flat buffer, the leaves kept whole beside them;
    zero1's and fsdp's shards are the same at the CNN's leaves), as
    ``update_kernel_rows`` holds and times them."""
    from dml_cnn_cifar10_tpu_torch.config import (DataConfig, ModelConfig,
                                                  OptimConfig,
                                                  ParallelConfig)
    from dml_cnn_cifar10_tpu_torch.models.cnn import CNN
    from dml_cnn_cifar10_tpu_torch.parallel import zero
    from dml_cnn_cifar10_tpu_torch.parallel.mesh import Mesh

    model = CNN(ModelConfig(logit_relu=False), DataConfig())
    gen = torch.Generator(device=dev).manual_seed(33)
    layouts = {}

    def maker(mode):
        lay = layouts[mode] = zero.build_layout(
            model, "cnn", OptimConfig(optimizer_sharding=(
                "zero1" if mode == "zero1" else "none")),
            ParallelConfig(fsdp=mode == "fsdp"), Mesh(world=world,
                                                      data=world))

        def make():
            full = {n: torch.randn(p.shape, device=dev, generator=gen)
                    for n, p in model.named_parameters()}
            return lay.pack(full)[1]
        return make

    rows = update_kernel_rows(
        dev, card, bytes_per_s, ops_per_s,
        [(name, mu, wd, mode, maker(mode)) for name, mu, wd, mode in cases],
        lambda mode: f"rank 0's {mode} shards at {world} ranks")
    for r in rows.values():
        lay = layouts[r["tag"]]
        r.update(world=world, mode=r["tag"], split=len(lay.split),
                 whole=len(lay.leaves) - len(lay.split))
    return rows


def _shard_args(name, steps, *extra, ckpt_every=1000, vit=False,
                backend="gloo", world=2, k=1):
    """One eager (or ``k``-step chunked) run of phase 33's recipe: the CNN
    main path (or the ViT-Ti's with AdamW), its own log dir, stream and
    rendezvous."""
    base = cnn_args(WORK) if not vit else [
        "--model", "vit_tiny", "--dataset", "synthetic", "--data_dir",
        os.path.join(WORK, "data_vit"), "--image_size", "72",
        "--crop_size", "64", "--synthetic_train_records", "10000",
        "--fidelity", "fixed", "--batch_size", "128", "--optimizer",
        "adamw", "--learning_rate", "3e-4"]
    return base + [
        "--log_dir", os.path.join(WORK, f"logs_shard_{name}"),
        "--metrics_jsonl", os.path.join(WORK, f"shard_{name}.jsonl"),
        "--total_steps", str(steps), "--output_every", str(max(k, 10)),
        "--eval_every", "1000", "--checkpoint_every", str(ckpt_every),
        "--steps_per_dispatch", str(k), *extra] + _dist_args(world, backend)


def _shard_io_secs(name) -> dict:
    """The ``shard_io`` records of a run's stream: seconds and bytes by
    op, summed over its files, and the files."""
    recs = [r for r in records(os.path.join(WORK, f"shard_{name}.jsonl"))
            if r["kind"] == "shard_io"]
    out = {}
    for r in recs:
        o = out.setdefault(r["op"], {"secs": 0.0, "bytes": 0, "files": 0})
        o["secs"] += r["secs"]
        o["bytes"] += r["bytes"]
        o["files"] += 1
    return out


def shard_phase(card, dev, bytes_per_s, ops_per_s) -> dict:
    """Phase 33 on this card: K1 on the shard buffers (``shard_kernel_rows``),
    then the CNN with plain SGD on 2 rank processes over gloo on this card
    (cuDNN deterministic), ``SHARD_STEPS`` eager steps each: replicated,
    zero1 and fsdp (K1 once a step per rank; zero1 within the CPU pin of
    replicated, fsdp within its pin; the moments, and under fsdp the
    params, halved on each rank), then zero1 with ``--ckpt_format
    sharded`` to ``SHARD_HALF`` and a resume under fsdp to ``SHARD_STEPS``:
    the same state as the straight zero1 run's, bit for bit, and its
    ``shard_io`` records strict under the schema."""
    t0 = time.perf_counter()
    kernels = shard_kernel_rows(dev, card, bytes_per_s, ops_per_s,
                                cases=(("sgd_update_plain", 0.0, 0.0,
                                        "zero1"),))
    runs = [
        {"name": "none", "argv": _shard_args("none", SHARD_STEPS)},
        {"name": "zero1", "compare": ["none"], "argv": _shard_args(
            "zero1", SHARD_STEPS, "--optimizer_sharding", "zero1")},
        {"name": "fsdp", "compare": ["none"], "argv": _shard_args(
            "fsdp", SHARD_STEPS, "--fsdp", "true")},
        {"name": "sharded_half", "argv": _shard_args(
            "ckpt", SHARD_HALF, "--optimizer_sharding", "zero1",
            "--ckpt_format", "sharded", ckpt_every=SHARD_HALF)},
        {"name": "sharded_resume", "compare": ["zero1"], "argv": _shard_args(
            "ckpt", SHARD_STEPS, "--fsdp", "true", "--ckpt_format",
            "sharded", ckpt_every=SHARD_HALF)},
    ]
    ranks = spawn_ranks("shard_gloo", {"kind": "shard", "deterministic": True,
                                       "runs": runs}, timeout_s=420)
    res = {"card": card, "kernels": kernels, "ranks": [r["runs"]
                                                       for r in ranks]}
    for r, x in enumerate(res["ranks"]):
        for name, run in x.items():
            want = SHARD_STEPS - (SHARD_HALF if name == "sharded_resume"
                                  else 0)
            if name == "sharded_half":
                want = SHARD_HALF
            check(run["launches"]["sgd_update_plain"] == want
                  and run["launches"]["sgd_update_momentum"] == 0,
                  f"phase 33 rank {r} {name}: launched {run['launches']}, "
                  f"want K1 = {want}")
        z, f = x["zero1"]["gaps"]["none"], x["fsdp"]["gaps"]["none"]
        check(z["gap"] <= SHARD_ZERO1_TOL,
              f"rank {r}: zero1 vs replicated gap {z['gap']} > "
              f"{SHARD_ZERO1_TOL}")
        check(f["fsdp_pin_excess"] <= 0,
              f"rank {r}: fsdp vs replicated outside the pin by "
              f"{f['fsdp_pin_excess']}")
        resumed = x["sharded_resume"]["gaps"]["zero1"]["gap"]
        check(resumed == 0.0,
              f"rank {r}: sharded save at {SHARD_HALF} + fsdp resume to "
              f"{SHARD_STEPS} is {resumed} from the straight zero1 run, "
              f"want bit-equal")
        none = x["none"]
        check(x["zero1"]["opt_bytes"] == x["fsdp"]["opt_bytes"] == 0
              and x["zero1"]["param_bytes"] == none["param_bytes"]
              and x["fsdp"]["param_bytes"] < none["param_bytes"] / 1.5,
              f"rank {r}: bytes {[(n, v['param_bytes'], v['opt_bytes'])
                                  for n, v in x.items()]}")
    io = _shard_io_secs("ckpt")
    check(set(io) == {"save", "restore"}, f"shard_io records {io}")
    lint = subprocess.run([sys.executable, os.path.join(
        ROOT, "tools", "check_jsonl_schema.py"), "--strict",
        os.path.join(WORK, "shard_ckpt.jsonl")], capture_output=True,
        text=True)
    check(lint.returncode == 0, f"phase 33 stream not strict: "
          f"{lint.stdout[-2000:]}{lint.stderr[-2000:]}")
    res["shard_io"] = io
    res["wall_s"] = time.perf_counter() - t0
    x = res["ranks"][0]
    print(f"[shard] phase 33: 2 ranks over gloo on one card, the CNN with "
          f"plain SGD, {SHARD_STEPS} steps: zero1 "
          f"{x['zero1']['gaps']['none']['gap']} and fsdp "
          f"{x['fsdp']['gaps']['none']['gap']} from replicated (params and "
          f"state, "
          f"rank 0); K1 once a step per rank; params bytes a rank "
          f"{x['none']['param_bytes']} replicated, "
          f"{x['fsdp']['param_bytes']} fsdp; sharded save at {SHARD_HALF} "
          f"(save {io['save']['secs']:.4f} s over {io['save']['files']} "
          f"files, restore {io['restore']['secs']:.4f} s) + fsdp resume "
          f"bit-equal to straight zero1; {res['wall_s']:.1f} s on {card}",
          flush=True)
    with open(os.path.join(OUT, "slice13.json"), "w") as f:
        json.dump(res, f, indent=1)
    return res


def shard_nccl_phase(card, dev, worlds, bytes_per_s, ops_per_s) -> dict:
    """Phase 33 under ``--dist``, a card a rank over NCCL: K2 on the shard
    buffers; for each of ``worlds``, the CNN with momentum 0.9 eager,
    ``SHARD_NCCL_STEPS`` steps each replicated, zero1 and fsdp (timed;
    finite losses; at 2 ranks, where every sum has two terms and so one
    order, the state within the CPU pins and every logged loss within
    ``DP_CHUNK_LOSS_RTOL``; fsdp bit-equal to zero1 at every world), and
    ``SHARD_PARITY_STEPS`` steps each held to the CPU pins at every world,
    then zero1 and fsdp chunked (K = 10, one
    CUDA graph a chunk with its reduce-scatter and all-gather captured;
    K2 once a step per rank, one graphed chunk bit-equal to its eager body
    on every rank, equal digests); then ViT-Ti with AdamW on 2 ranks,
    ``SHARD_VIT_STEPS`` eager steps each replicated, zero1 and fsdp. Each
    run's ms/step (the trainer's own rate) and per-rank bytes."""
    t0 = time.perf_counter()
    res = {"card": card, "kernels": shard_kernel_rows(
        dev, card, bytes_per_s, ops_per_s,
        cases=(("sgd_update_momentum", 0.9, 5e-4, "fsdp"),))}
    mom = ["--momentum", "0.9"]
    for world in worlds:
        tag = f"nccl{world}"
        # The timed runs, then one step each for parity with replicated:
        # over 4 ranks the reduce-scatter sums in another order than the
        # all-reduce, and a last-bit difference that flips a max-pool tie
        # moves a weight by lr x O(gradient) (4 steps: 3.9e-4), which SGD
        # carries far (PERF.md §6). zero1 and fsdp share the reduce-scatter
        # and the update: they must agree bit for bit after 100 steps.
        runs = []
        for short, steps in (("", SHARD_NCCL_STEPS),
                             ("_short", SHARD_PARITY_STEPS)):
            for name, extra in (("none", []),
                                ("zero1", ["--optimizer_sharding", "zero1"]),
                                ("fsdp", ["--fsdp", "true"])):
                compare = [] if name == "none" else ["none" + short]
                if name == "fsdp":
                    compare.append("zero1" + short)
                runs.append({"name": name + short, "compare": compare,
                             "argv": _shard_args(
                                 f"{tag}_{name}{short}", steps, *mom,
                                 *extra, backend="nccl", world=world)})
        ranks = [r["runs"] for r in spawn_ranks(
            f"shard_{tag}", {"kind": "shard", "deterministic": True,
                             "runs": runs}, world=world, timeout_s=300)]
        logs = {n: train_log(os.path.join(WORK, f"shard_{tag}_{n}.jsonl"))
                for n in ("none", "zero1", "fsdp")}
        loss_gaps = {}
        for name in ("zero1", "fsdp"):
            loss_gaps[name] = [abs(a[1] - b[1]) / abs(b[1])
                               for a, b in zip(logs[name], logs["none"])]
            check(len(loss_gaps[name]) == SHARD_NCCL_STEPS // 10
                  and all(math.isfinite(x[1]) for x in logs[name]),
                  f"{tag} {name}: logged losses {logs[name]}")
            if world == 2:
                check(max(loss_gaps[name]) <= DP_CHUNK_LOSS_RTOL,
                      f"{tag} {name}: logged losses {logs[name]} against "
                      f"replicated {logs['none']}")
        for r, x in enumerate(ranks):
            for name, run in x.items():
                want = SHARD_PARITY_STEPS if name.endswith("_short") \
                    else SHARD_NCCL_STEPS
                check(run["launches"]["sgd_update_momentum"] == want,
                      f"{tag} rank {r} {name} launched {run['launches']}")
            for short in (("", "_short") if world == 2 else ("_short",)):
                z = x["zero1" + short]["gaps"]["none" + short]
                f = x["fsdp" + short]["gaps"]["none" + short]
                check(z["gap"] <= SHARD_ZERO1_TOL
                      and f["fsdp_pin_excess"] <= 0,
                      f"{tag}{short} rank {r}: zero1 gap {z['gap']}, fsdp "
                      f"excess {f['fsdp_pin_excess']}")
            check(x["fsdp"]["gaps"]["zero1"]["gap"] == 0.0,
                  f"{tag} rank {r}: fsdp {x['fsdp']['gaps']['zero1']} from "
                  f"zero1 after {SHARD_NCCL_STEPS} steps, want bit-equal")
            check(x["zero1"]["opt_bytes"] < x["none"]["opt_bytes"] / 1.5
                  and x["fsdp"]["param_bytes"]
                  < x["none"]["param_bytes"] / 1.5,
                  f"{tag} rank {r}: bytes not sharded {x}")
        eager = {n: {"ms_per_step": 128 / ranks[0][n]["images_per_sec"]
                     * 1e3, **{k: ranks[0][n][k] for k in (
                         "param_bytes", "opt_bytes", "gaps")
                         if k in ranks[0][n]}}
                 for n in ("none", "zero1", "fsdp")}
        parity = {n: ranks[0][n + "_short"]["gaps"]["none_short"]
                  for n in ("zero1", "fsdp")}
        chunked = {}
        for name, extra in (("zero1", ["--optimizer_sharding", "zero1"]),
                            ("fsdp", ["--fsdp", "true"])):
            label = f"shard_{tag}_{name}_chunk"
            cr = spawn_ranks(label, {"kind": "chunk", "reps": 20, "argv":
                                     _shard_args(f"{tag}_{name}_chunk",
                                                 SHARD_NCCL_STEPS, *mom,
                                                 *extra, backend="nccl",
                                                 world=world, k=CHUNK_K)},
                             world=world, timeout_s=300)
            want = {"sgd_update_plain": 0,
                    "sgd_update_momentum": SHARD_NCCL_STEPS,
                    **dict.fromkeys(("flash_fwd", "flash_fwd_lse",
                                     "flash_fwd_stats", "flash_bwd_dq",
                                     "flash_bwd_dkv"), 0)}
            _check_chunk_ranks(label, cr, want, SHARD_NCCL_STEPS // CHUNK_K,
                               {"sgd_update_momentum": CHUNK_K})
            for r, x in enumerate(cr):
                c = x["graph_vs_eager"]
                check(c["loss_gap"] == 0.0 and c["param_gap"] == 0.0,
                      f"{label} rank {r}: graph vs eager {c}, want "
                      f"bit-equal")
            _dist_log_says(label, world, "one CUDA graph replay each")
            log = train_log(os.path.join(WORK,
                                         f"shard_{tag}_{name}_chunk.jsonl"))
            chunked[name] = {"loop_ms_per_step": 128 / log[-1][2] * 1e3,
                             "replay_ms_per_step": cr[0]["replay_ms_per_step"],
                             "busy_share": cr[0].get("busy_share"),
                             "launches": cr[0]["launches"],
                             "graph_vs_eager": [x["graph_vs_eager"]
                                                for x in cr]}
        res[tag] = {"eager": eager, "parity": parity, "loss_gaps": loss_gaps,
                    "chunked": chunked, "ranks": ranks}
        loop_ms, replay_ms = ({n: round(v[key], 4) for n, v in chunked.items()}
                              for key in ("loop_ms_per_step",
                                          "replay_ms_per_step"))
        nbytes = {n: (v["param_bytes"], v["opt_bytes"])
                  for n, v in eager.items()}
        print(f"[shard {tag}] the CNN with momentum on {world} NCCL ranks, "
              f"{SHARD_NCCL_STEPS} steps: eager ms/step "
              f"{ {n: round(v['ms_per_step'], 4) for n, v in eager.items()} }"
              f"; chunked (K = {CHUNK_K}, one graph a chunk) loop ms/step "
              f"{loop_ms}, replay {replay_ms}; rank 0 bytes (params, "
              f"optimizer state) {nbytes}"
              f"; after {SHARD_PARITY_STEPS} steps from replicated "
              f"{parity}, after {SHARD_NCCL_STEPS} "
              f"{ {n: eager[n]['gaps'] for n in ('zero1', 'fsdp')} } "
              f"(largest logged-loss gap "
              f"{ {n: max(g) for n, g in loss_gaps.items()} }); graphs "
              f"bit-equal to their eager bodies on every rank; on {card}",
              flush=True)
    runs = [{"name": "none", "argv": _shard_args(
                "vit_none", SHARD_VIT_STEPS, vit=True, backend="nccl")},
            {"name": "zero1", "compare": ["none"], "argv": _shard_args(
                "vit_zero1", SHARD_VIT_STEPS, "--optimizer_sharding",
                "zero1", vit=True, backend="nccl")},
            {"name": "fsdp", "compare": ["none"], "argv": _shard_args(
                "vit_fsdp", SHARD_VIT_STEPS, "--fsdp", "true", vit=True,
                backend="nccl")}]
    vit = [r["runs"] for r in spawn_ranks(
        "shard_vit_nccl2", {"kind": "shard", "deterministic": True,
                            "runs": runs}, timeout_s=300)]
    logs = {n: train_log(os.path.join(WORK, f"shard_vit_{n}.jsonl"))
            for n in ("none", "zero1", "fsdp")}
    for name in ("zero1", "fsdp"):
        gaps = [abs(a[1] - b[1]) / abs(b[1])
                for a, b in zip(logs[name], logs["none"])]
        check(len(gaps) == SHARD_VIT_STEPS // 10
              and max(gaps) <= DP_CHUNK_LOSS_RTOL,
              f"ViT-Ti {name}: losses {logs[name]} vs {logs['none']}")
    for r, x in enumerate(vit):
        check(x["zero1"]["opt_bytes"] < x["none"]["opt_bytes"] / 1.5
              and x["fsdp"]["param_bytes"] < x["none"]["param_bytes"] / 1.5
              and x["fsdp"]["opt_bytes"] < x["none"]["opt_bytes"] / 1.5,
              f"ViT-Ti rank {r}: bytes not sharded {x}")
    res["vit_nccl2"] = {n: {"ms_per_step": 128 / v["images_per_sec"] * 1e3,
                            **{k: v[k] for k in ("param_bytes", "opt_bytes",
                                                 "gaps") if k in v}}
                        for n, v in vit[0].items()}
    res["wall_s"] = time.perf_counter() - t0
    print(f"[shard vit] ViT-Ti AdamW on 2 NCCL ranks, {SHARD_VIT_STEPS} "
          f"steps: {res['vit_nccl2']}; phase 33 (NCCL) took "
          f"{res['wall_s']:.1f} s on {card}", flush=True)
    with open(os.path.join(OUT, "slice13_nccl.json"), "w") as f:
        json.dump(res, f, indent=1)
    return res


def shard_kernel_entries(rows, launches, paths) -> list:
    """The ``kernels`` line's rows for K1/K2 on shards: ``rows`` from
    ``shard_kernel_rows``, ``launches`` by path from the main path's runs
    (rank 0)."""
    out = []
    for name, r in rows.items():
        kid, line = ("K1", 83) if name == "sgd_update_plain" else ("K2", 70)
        for path in paths:
            out.append({
                "name": name, "kernel": kid, "path": path, "route": "cuda",
                "source": "dml_cnn_cifar10_tpu_torch/csrc/sgd_update.cu",
                "cuda_kernel": "sgd_multi_kernel<true>" if r["mu"]
                else "sgd_multi_kernel<false>",
                "replaces": f"dml_cnn_cifar10_tpu/ops/optimizer.py:{line}",
                "launches": launches[path],
                "max_abs_err": r["max_abs_err"],
                **{k: r[k] for k in ("ms", "device_ms", "plain_ms",
                                     "bound_ms", "bound_by", "library_ms",
                                     "library_device_ms")},
                "library": "torch.optim.SGD(fused=True).step",
                "work": f"one update of rank 0's shards at {r['world']} "
                        f"data ranks ({r['elements']} f32 elements: "
                        f"{r['split']} split leaves, {r['whole']} whole), "
                        f"mu={r['mu']}, wd={r['wd']}; launches: rank 0 of "
                        f"the {path} run"})
    return out


# ---------------------------------------------------------------------------
# 34. tensor parallelism over --model_axis (parallel/tp.py)
# ---------------------------------------------------------------------------

# Phase 34's eager runs over gloo on this card: the CNN's steps and its
# sharded checkpoint's half, the ViT-Ti's steps; under --dist over NCCL:
# the CNN's steps (eager and chunked at CHUNK_K), the ViT-Ti's (chunked
# at TP_VIT_K).
TP_STEPS, TP_HALF, TP_VIT_STEPS = 50, 25, 10
TP_NCCL_STEPS, TP_NCCL_VIT_STEPS, TP_VIT_K = 100, 20, 5
# Every logged loss of the first TP_EARLY_STEPS within DP_CHUNK_LOSS_RTOL
# of the replicated run's (later ones are printed: summation order, then
# max-pool ties, part two layouts over long runs, PERF.md §6); one step
# within the CPU pins of tests/test_torch_tp.py (losses 1e-5 relative +
# 1e-6, the state SHARD_FSDP_RTOL/ATOL).
TP_EARLY_STEPS = 10
TP_LOSS_RTOL, TP_LOSS_ATOL = 1e-5, 1e-6
# K3/K4/K6/K7 at a model rank's shape: ViT-Ti's 3 heads over 3 model
# ranks, one head of 64 a rank, views of its fused qkv; batch 32 (the
# gloo run) and 128 (the main path's batch, the NCCL run).
TP_FLASH_CASES = [
    ("tp rank b32", (32, 257, 257, 1, 64), torch.float32, {"strided": True}),
    ("tp rank b128", (128, 257, 257, 1, 64), torch.float32,
     {"strided": True}),
]
TP_FLASH_TIMING = [("tp32", (32, 257, 1, 64), torch.float32),
                   ("tp128", (128, 257, 1, 64), torch.float32)]
# The CNN's leaves a model rank of 2 holds: full1/full2 at half width.
TP_CNN_ELEMENTS = 1_068_298 - (2304 * 384 + 384 + 384 * 192) // 2


def tp_kernel_rows(dev, card, bytes_per_s, ops_per_s) -> dict:
    """K1 (plain SGD) and K2 (mu 0.9, wd 5e-4) on the leaves model rank 0
    of 2 updates (``update_kernel_rows``): its own tensors, the Megatron
    slices at half width and the replicated leaves whole."""
    from dml_cnn_cifar10_tpu_torch.config import DataConfig, ModelConfig
    from dml_cnn_cifar10_tpu_torch.models.cnn import CNN
    from dml_cnn_cifar10_tpu_torch.parallel.mesh import Mesh

    model = CNN(ModelConfig(logit_relu=False), DataConfig(),
                mesh=Mesh(world=2, model=2))
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    check(sum(math.prod(v) for v in shapes.values()) == TP_CNN_ELEMENTS,
          f"a model rank's CNN leaves {shapes}")
    gen = torch.Generator(device=dev).manual_seed(34)

    def make():
        return {n: torch.randn(v, device=dev, generator=gen)
                for n, v in shapes.items()}

    return update_kernel_rows(
        dev, card, bytes_per_s, ops_per_s,
        [("sgd_update_plain", 0.0, 0.0, "tp", make),
         ("sgd_update_momentum", 0.9, 5e-4, "tp", make)],
        lambda tag: "model rank 0's leaves at model_axis 2")


def _tp_args(name, steps, world, model_axis, *extra, vit=False,
             backend="gloo", batch=128, k=1, every=1, ckpt_every=1000):
    """One run of phase 34's recipe: the CNN main path (or ViT-Ti's, f32,
    AdamW) at ``--model_axis`` over ``world`` ranks (one process, without
    ``--worker_hosts``, at world 1), its own log dir and stream; every
    ``every`` steps logged."""
    base = cnn_args(WORK) if not vit else [
        "--model", "vit_tiny", "--dataset", "synthetic", "--data_dir",
        os.path.join(WORK, "data_vit"), "--image_size", "72",
        "--crop_size", "64", "--synthetic_train_records", "10000",
        "--fidelity", "fixed", "--optimizer", "adamw", "--learning_rate",
        "3e-4", "--peak_tflops", F32_PEAK_TFLOPS]
    base = [a for a in base]
    if "--batch_size" in base:
        i = base.index("--batch_size")
        del base[i:i + 2]
    out = base + [
        "--batch_size", str(batch), "--model_axis", str(model_axis),
        "--log_dir", os.path.join(WORK, f"logs_tp_{name}"),
        "--metrics_jsonl", os.path.join(WORK, f"tp_{name}.jsonl"),
        "--total_steps", str(steps), "--output_every", str(max(k, every)),
        "--eval_every", "1000", "--checkpoint_every", str(ckpt_every),
        "--steps_per_dispatch", str(k), *extra]
    return out + (_dist_args(world, backend) if world > 1 else [])


def _tp_step1(trainer, batch: int) -> dict:
    """One plain-SGD step (lr 0.01) of ``trainer``'s model built over its
    mesh (this rank's rows of a seeded global batch, on the card), from
    the seed's init, against the replicated model's step in this process
    on the whole batch from the same init: the loss gap and the state
    gaps (``_tree_gaps``: the CPU pins). SGD: AdamW's first step is lr *
    sign(g) wherever |g| >> eps, so where a gradient is 0 in exact
    arithmetic (the ViT's key slice of qkv's bias) rounding picks the
    sign (tests/test_torch_tp.py:_adam_noise). Both models are new: the
    trainer's own stays on the host until its fit initialises it."""
    from dml_cnn_cifar10_tpu_torch.ckpt import checkpoint as ckpt_lib
    from dml_cnn_cifar10_tpu_torch.config import OptimConfig
    from dml_cnn_cifar10_tpu_torch.models.registry import get_model
    from dml_cnn_cifar10_tpu_torch.parallel import step as step_lib

    cfg, dev, mesh = trainer.cfg, trainer.device, trainer.mesh
    sgd = OptimConfig(learning_rate=0.01)
    gen = torch.Generator().manual_seed(34)
    d = cfg.data
    images = torch.rand((batch, d.crop_height, d.crop_width,
                         d.num_channels), generator=gen)
    labels = torch.randint(0, 10, (batch,), generator=gen)
    b = batch // mesh.data
    rows = slice(mesh.data_rank * b, (mesh.data_rank + 1) * b)
    trees, losses = [], []
    for over in (mesh, None):
        model = get_model(cfg.model.name)(cfg.model, cfg.data, mesh=over)
        state = step_lib.init_train_state(
            model, sgd, dev, torch.Generator().manual_seed(cfg.seed))
        ims, lbs = (images, labels) if over is None else (images[rows],
                                                          labels[rows])
        _, m = step_lib.make_train_step(model, sgd, over)(
            state, ims.to(dev), lbs.to(dev))
        losses.append(float(m["loss"]))
        trees.append(ckpt_lib.state_to_tree(state))
    return {"loss": losses[0], "rep_loss": losses[1],
            "loss_excess": abs(losses[0] - losses[1]) - TP_LOSS_ATOL
            - TP_LOSS_RTOL * abs(losses[1]), **_tree_gaps(*trees)}


def _split_digests(state) -> dict:
    """Digests of this rank's replicated leaves and of its model slices."""
    split = state.split
    whole = {n: t for n, t in state.params.items()
             if split is None or not split.is_split(n)}
    sliced = {n: t for n, t in state.params.items() if n not in whole}
    return {"replicated": _params_digest(whole),
            "sliced": _params_digest(sliced) if sliced else None}


def _rank_tp(rank: int, job: dict) -> dict:
    """Phase 34's rank job: ``Trainer.fit`` for each run of
    ``job["runs"]`` (``name``, ``argv``, ``world``: the run's ranks are
    the first ``world``; ``compare``: earlier runs' names; ``step1``: a
    global batch, for ``_tp_step1`` on the trainer before its fit) this
    rank takes part in: its launches, the trainer's images/s, bytes of
    parameters, the digests of its replicated leaves and model slices
    (``_split_digests``), the gaps of its whole state (gathered while the
    process group lives) to each compared run's, and the run's wall
    seconds, split into the trainer's set-up, the step-1 check and the
    fit."""
    import torch.distributed as dist

    from dml_cnn_cifar10_tpu_torch.ckpt import checkpoint as ckpt_lib
    from dml_cnn_cifar10_tpu_torch.cli.main import (build_parser,
                                                    config_from_args)
    from dml_cnn_cifar10_tpu_torch.ops import flash_attention as fa
    from dml_cnn_cifar10_tpu_torch.ops import optimizer as fused
    from dml_cnn_cifar10_tpu_torch.train.loop import Trainer

    if job.get("warm"):
        # A rank process's first fit carries about 10 s of one-time
        # set-up (the runs' split_s): every rank pays it here, all at
        # once, not one wave of fresh ranks after another on the path.
        trainer = Trainer(config_from_args(build_parser().parse_args(
            _tp_args(f"warm{rank}", 2, 1, 1))))
        try:
            trainer.fit()
        finally:
            trainer.close()
    trees, runs = {}, {}
    for run in job["runs"]:
        if rank >= run.get("world", 1 << 30):
            continue
        t0 = time.perf_counter()
        cfg = config_from_args(build_parser().parse_args(
            run["argv"] + ["--task_index", str(rank)]))
        trainer = Trainer(cfg, task_index=rank)
        marks = [time.perf_counter()]
        step1 = None
        try:
            if "step1" in run:
                step1 = _tp_step1(trainer, run["step1"])
                print(f"[tp rank {rank}] step 1 against replicated: "
                      f"{step1}", flush=True)
            marks.append(time.perf_counter())
            fused.reset_launches()
            fa.reset_launches()
            result = trainer.fit()
            marks.append(time.perf_counter())
            trees[run["name"]] = ckpt_lib.state_to_tree(result.state)
            st = result.state
            res = {"final_step": result.final_step,
                   "images_per_sec": result.images_per_sec,
                   "launches": {**fa.LAUNCHES, **fused.LAUNCHES},
                   "param_bytes": sum(t.numel() * t.element_size()
                                      for t in st.params.values()),
                   "step1": step1, "wall_s": time.perf_counter() - t0,
                   # The trainer's set-up (its rendezvous included), the
                   # step-1 check, the fit.
                   "split_s": [b - a for a, b in zip([t0] + marks[:-1],
                                                     marks)],
                   **_split_digests(st)}
        finally:
            trainer.close()
            if dist.is_initialized():
                dist.destroy_process_group()
        for other in run.get("compare", ()):
            if other in trees:
                res.setdefault("gaps", {})[other] = _tree_gaps(
                    trees[run["name"]], trees[other])
        runs[run["name"]] = res
        print(f"[tp rank {rank}] {run['name']}: {res}", flush=True)
    return {"runs": runs}


def _tp_loss_gaps(tp_name, rep_name) -> list:
    """``(step, relative gap)`` of every logged loss of two runs."""
    a = train_log(os.path.join(WORK, f"tp_{tp_name}.jsonl"))
    b = train_log(os.path.join(WORK, f"tp_{rep_name}.jsonl"))
    check(len(a) == len(b) and all(x[0] == y[0] for x, y in zip(a, b)),
          f"tp {tp_name} vs {rep_name}: logged steps {[x[0] for x in a]} "
          f"vs {[y[0] for y in b]}")
    check(all(math.isfinite(x[1]) for x in a), f"tp {tp_name}: losses {a}")
    return [(x[0], abs(x[1] - y[1]) / abs(y[1])) for x, y in zip(a, b)]


def _check_tp_job(label, ranks, world, model_axis, tp_runs) -> None:
    """The step-1 pins, and for each run of ``tp_runs`` the replicated
    leaves bit-equal over every rank (no ZeRO layout: every rank holds
    them) and the model slices different between model ranks."""
    for r, x in enumerate(ranks):
        s1 = x["runs"][tp_runs[0]]["step1"]
        check(s1["loss_excess"] <= 0 and s1["fsdp_pin_excess"] <= 0,
              f"{label} rank {r}: step 1 against replicated {s1}, outside "
              f"the CPU pins")
    for name in tp_runs:
        digests = [x["runs"][name] for x in ranks]
        check(len({d["replicated"] for d in digests}) == 1,
              f"{label} {name}: replicated leaves differ between ranks")
        check(len({d["sliced"] for d in digests}) == model_axis,
              f"{label} {name}: {len({d['sliced'] for d in digests})} "
              f"distinct model slices over {world} ranks, want "
              f"{model_axis}")


def tp_phase(card, dev, bytes_per_s, ops_per_s, extra_runs=()) -> dict:
    """Phase 34 on this card: K1/K2 on a model rank's leaves
    (``tp_kernel_rows``) and on phase 33's shard buffers (their device
    times), K3/K4/K6/K7 at a model rank's [b, 257, 1, 64] f32 against
    their plain versions and timed; then over gloo on this card, cuDNN
    deterministic, in one spawn of 4 rank processes (each group on its
    first ranks, after a 2-step warm-up fit on each): the CNN at model 2
    (2 ranks) and at data 2 x model 2 (4 ranks), batch 128,
    ``TP_STEPS`` eager steps each beside the
    replicated run (one process; 2 data ranks), and ViT-Ti at model 3 (3
    ranks), batch 32, f32, ``TP_VIT_STEPS`` steps beside one process: one
    step within the CPU pins, every logged loss of the first
    ``TP_EARLY_STEPS`` within ``DP_CHUNK_LOSS_RTOL`` (the last printed),
    replicated leaves bit-equal over the ranks, K1 (CNN) or K4/K6/K7
    (ViT) at the counts of the run; the 4-rank CNN saved ``.sharded`` at
    ``TP_HALF`` and resumed to ``TP_STEPS`` bit-equal to the straight
    run."""
    t0 = time.perf_counter()
    res = {"card": card,
           "kernels": tp_kernel_rows(dev, card, bytes_per_s, ops_per_s),
           "shard_kernels": shard_kernel_rows(dev, card, bytes_per_s,
                                              ops_per_s)}
    res["flash_worst"] = {f"{k}/{d}": v for (k, d), v in flash_parity(
        dev, TP_FLASH_CASES).items() if d == "float32"}
    res["flash_timing"] = {f"{k}/{l}": v for (k, l), v in flash_timing(
        dev, card, bytes_per_s, ops_per_s, TP_FLASH_TIMING).items()}
    res["kernels_s"] = time.perf_counter() - t0
    groups = {
        "cnn_m2": (2, 2, False, [
            {"name": "cnn_m2_rep", "world": 1,
             "argv": _tp_args("cnn_m2_rep", TP_STEPS, 1, 1)},
            {"name": "cnn_m2", "world": 2, "compare": ["cnn_m2_rep"],
             "step1": 128, "argv": _tp_args("cnn_m2", TP_STEPS, 2, 2)}]),
        "cnn_d2m2": (4, 2, False, [
            {"name": "cnn_d2m2_rep", "world": 2,
             "argv": _tp_args("cnn_d2m2_rep", TP_STEPS, 2, 1)},
            {"name": "cnn_d2m2", "world": 4, "compare": ["cnn_d2m2_rep"],
             "step1": 128, "argv": _tp_args("cnn_d2m2", TP_STEPS, 4, 2)},
            {"name": "cnn_d2m2_half", "world": 4, "argv": _tp_args(
                "ckpt", TP_HALF, 4, 2, "--ckpt_format", "sharded",
                ckpt_every=TP_HALF)},
            {"name": "cnn_d2m2_resume", "world": 4, "compare": ["cnn_d2m2"],
             "argv": _tp_args("ckpt", TP_STEPS, 4, 2, "--ckpt_format",
                              "sharded", ckpt_every=TP_HALF)}]),
        "vit_m3": (3, 3, True, [
            {"name": "vit_m3_rep", "world": 1, "argv": _tp_args(
                "vit_m3_rep", TP_VIT_STEPS, 1, 1, vit=True, batch=32)},
            {"name": "vit_m3", "world": 3, "compare": ["vit_m3_rep"],
             "step1": 32, "argv": _tp_args("vit_m3", TP_VIT_STEPS, 3, 3,
                                           vit=True, batch=32)}]),
    }
    # One spawn of 4 rank processes runs every group, each on its first
    # `world` ranks (the others go on to the next run), after a warm-up
    # fit on every rank; the datasets are made here, once.
    from dml_cnn_cifar10_tpu_torch.cli.main import (build_parser,
                                                    config_from_args)
    from dml_cnn_cifar10_tpu_torch.data import download
    for vit in (False, True):
        download.ensure_dataset(config_from_args(build_parser().parse_args(
            _tp_args("data", 1, 1, 1, vit=vit))).data)
    if extra_runs:
        download.ensure_dataset(config_from_args(build_parser().parse_args(
            _moe_recipe_args("data", 1))).data)
    t1 = time.perf_counter()
    # ``extra_runs`` (phase 36's rank runs, checked there) ride the same
    # spawn: a process's start and first set-up paid once.
    ranks = spawn_ranks("tp_gloo", {
        "kind": "tp", "deterministic": True, "warm": True,
        "runs": [run for *_, runs in groups.values() for run in runs]
        + list(extra_runs)}, world=4, timeout_s=600)
    res["extra_ranks"] = ranks
    res["ranks_s"] = time.perf_counter() - t1
    for label, (world, m, vit, runs) in groups.items():
        batch = 32 if vit else 128
        tp_runs = [r["name"] for r in runs
                   if not r["name"].endswith("_rep")]
        _check_tp_job(label, ranks[:world], world, m, tp_runs)
        name = tp_runs[0]
        gaps = _tp_loss_gaps(name, name + "_rep")
        early = [g for step, g in gaps if step <= TP_EARLY_STEPS]
        check(len(early) == min(TP_EARLY_STEPS, len(gaps))
              and max(early) <= DP_CHUNK_LOSS_RTOL,
              f"{label}: logged losses against replicated {gaps}")
        steps = TP_VIT_STEPS if vit else TP_STEPS
        for r, x in enumerate(ranks[:world]):
            for run in runs:
                if r >= run["world"]:
                    continue
                got = x["runs"][run["name"]]
                n = got["final_step"] - (
                    TP_HALF if run["name"].endswith("_resume") else 0)
                la = got["launches"]
                if vit:
                    ok = all(la[kn] == n * 12 for kn in (
                        "flash_fwd_lse", "flash_bwd_dq", "flash_bwd_dkv")) \
                        and la["flash_fwd_stats"] == 0 \
                        and la["sgd_update_plain"] == 0
                else:
                    ok = la["sgd_update_plain"] == n and not any(
                        la[kn] for kn in la if kn != "sgd_update_plain")
                check(ok, f"{label} rank {r} {run['name']}: launched {la}")
        if label == "cnn_d2m2":
            for r, x in enumerate(ranks):
                gap = x["runs"]["cnn_d2m2_resume"]["gaps"]["cnn_d2m2"]
                check(gap["gap"] == 0.0, f"{label} rank {r}: sharded save "
                      f"at {TP_HALF} + resume to {TP_STEPS} is {gap} from "
                      f"the straight run, want bit-equal")
        x0 = {run["name"]: ranks[0]["runs"][run["name"]] for run in runs}
        res[label] = {
            "world": world, "model_axis": m,
            "step1": [x["runs"][name]["step1"] for x in ranks[:world]],
            "wall_s": {n: v["wall_s"] for n, v in x0.items()},
            "split_s": {n: [[round(t, 2) for t in x["runs"][n]["split_s"]]
                            for x in ranks[:world] if n in x["runs"]]
                        for n in x0},
            "loss_gaps": gaps, "last_gap": gaps[-1],
            "ms_per_step": {n: batch / v["images_per_sec"] * 1e3
                            if v["images_per_sec"] else None
                            for n, v in x0.items()},
            "state_gap": x0[name]["gaps"][name + "_rep"],
            "param_bytes": {n: v["param_bytes"] for n, v in x0.items()},
            "launches": x0[name]["launches"]}
        print(f"[tp {label}] {world} ranks over gloo on one card, "
              f"model_axis {m}, batch {batch}, {steps} steps: step 1 "
              f"within the CPU pins on every rank (state gap "
              f"{max(s1['gap'] for s1 in res[label]['step1']):.3g}); "
              f"logged losses of the first {TP_EARLY_STEPS} steps within "
              f"{max(early):.3g} of replicated, at step {gaps[-1][0]} "
              f"{gaps[-1][1]:.3g} (state {x0[name]['gaps']}); replicated "
              f"leaves bit-equal over the ranks; ms/step "
              f"{res[label]['ms_per_step']}; rank 0 param bytes "
              f"{res[label]['param_bytes']}; wall s {res[label]['wall_s']} "
              f"(set-up, step 1, fit, each rank: {res[label]['split_s']}) "
              f"on {card}", flush=True)
    res["wall_s"] = time.perf_counter() - t0
    print(f"[tp] phase 34 took {res['wall_s']:.1f} s on {card}",
          flush=True)
    with open(os.path.join(OUT, "slice14.json"), "w") as f:
        json.dump(res, f, indent=1)
    return res


def tp_nccl_phase(card, count) -> dict:
    """Phase 34 under ``--dist``, a card a rank over NCCL: the CNN at data
    2 x model 2 on 4 ranks, batch 128, ``TP_NCCL_STEPS`` eager steps
    beside replicated DP on the same 4 ranks and on 2 of them (the same
    data ranks: every logged loss of the first ``TP_EARLY_STEPS`` within
    ``DP_CHUNK_LOSS_RTOL`` of it), then chunked at ``CHUNK_K``
    (``_rank_chunk``: each chunk one CUDA graph with its
    model-group all-reduces captured, one graphed chunk bit-equal to its
    eager body on every rank, replays timed and traced: device busy share
    and NCCL ms); then ViT-Ti at model 3 on 3 ranks, batch 128, f32,
    ``TP_NCCL_VIT_STEPS`` steps eager and chunked at ``TP_VIT_K`` the
    same way, beside one process on one card (128 does not split over 3
    data ranks). Needs 4 cards for the CNN, 3 for the ViT."""
    t0 = time.perf_counter()
    res = {"card": card}
    if count >= 4:
        runs = [{"name": "dp4", "world": 4, "argv": _tp_args(
                    "nccl_dp4", TP_NCCL_STEPS, 4, 1, backend="nccl",
                    every=10)},
                {"name": "d2m2", "world": 4, "argv": _tp_args(
                    "nccl_d2m2", TP_NCCL_STEPS, 4, 2, backend="nccl",
                    every=10)},
                {"name": "dp2", "world": 2, "argv": _tp_args(
                    "nccl_dp2", TP_NCCL_STEPS, 2, 1, backend="nccl",
                    every=10)}]
        ranks = spawn_ranks("tp_nccl_cnn", {"kind": "tp",
                                            "deterministic": True,
                                            "runs": runs},
                            world=4, timeout_s=300)
        for r, x in enumerate(ranks):
            for name, run in x["runs"].items():
                check(run["launches"]["sgd_update_plain"] == TP_NCCL_STEPS,
                      f"tp nccl {name} rank {r}: launched {run['launches']}")
        check(len({x["runs"]["d2m2"]["replicated"] for x in ranks}) == 1,
              "tp nccl d2m2: replicated leaves differ between ranks")
        # Every logged loss of the first TP_EARLY_STEPS within
        # DP_CHUNK_LOSS_RTOL of DP at the same 2 data ranks, which read
        # the same records (dp4 shards them 4 ways: other batches), as
        # over gloo.
        gaps = _tp_loss_gaps("nccl_d2m2", "nccl_dp2")
        early = [g for step, g in gaps if step <= TP_EARLY_STEPS]
        check(early and max(early) <= DP_CHUNK_LOSS_RTOL,
              f"tp nccl d2m2: logged losses against dp2 {gaps}")
        label = "tp_nccl_cnn_chunk"
        cr = spawn_ranks(label, {"kind": "chunk", "reps": 20, "argv":
                                 _tp_args("nccl_d2m2_chunk", TP_NCCL_STEPS,
                                          4, 2, backend="nccl", k=CHUNK_K)},
                         world=4, timeout_s=300)
        want = {"sgd_update_plain": TP_NCCL_STEPS,
                "sgd_update_momentum": 0,
                **dict.fromkeys(("flash_fwd", "flash_fwd_lse",
                                 "flash_fwd_stats", "flash_bwd_dq",
                                 "flash_bwd_dkv"), 0)}
        _check_chunk_ranks(label, cr, want, TP_NCCL_STEPS // CHUNK_K,
                           {"sgd_update_plain": CHUNK_K})
        for r, x in enumerate(cr):
            c = x["graph_vs_eager"]
            check(c["loss_gap"] == 0.0 and c["param_gap"] == 0.0,
                  f"{label} rank {r}: graph vs eager {c}, want bit-equal")
        _dist_log_says(label, 4, "one CUDA graph replay each")
        log = train_log(os.path.join(WORK, "tp_nccl_d2m2_chunk.jsonl"))
        res["cnn"] = {
            "eager_ms_per_step": {n: 128 / v["images_per_sec"] * 1e3
                                  for n, v in ranks[0]["runs"].items()},
            "loss_gaps": gaps,
            "chunk_loop_ms_per_step": 128 / log[-1][2] * 1e3,
            "replay_ms_per_step": cr[0]["replay_ms_per_step"],
            "busy_share": cr[0].get("busy_share"),
            "nccl_ms_per_step": cr[0].get("comm_ms"),
            "timeline": {k: cr[0].get(k) for k in cr[0]
                         if k.endswith("_ms")},
            "graph_vs_eager": [x["graph_vs_eager"] for x in cr]}
        c = res["cnn"]
        print(f"[tp nccl cnn] data 2 x model 2 on 4 NCCL ranks, batch 128, "
              f"{TP_NCCL_STEPS} steps: eager ms/step "
              f"{ {n: round(v, 4)
                   for n, v in c['eager_ms_per_step'].items()} }"
              f" (dp4 = replicated DP on the same 4 cards, 32 images a "
              f"rank; dp2 on 2 of them, the same data ranks as d2m2); "
              f"logged losses against dp2 within "
              f"{max(early):.3g} to step {TP_EARLY_STEPS}, at step "
              f"{gaps[-1][0]} {gaps[-1][1]:.3g}; chunked (K = {CHUNK_K}, "
              f"one graph a chunk) loop "
              f"{c['chunk_loop_ms_per_step']:.4f}, replay "
              f"{c['replay_ms_per_step']:.4f} ms/step, device busy "
              f"{c['busy_share']}, timeline {c['timeline']}; graphs "
              f"bit-equal to eager on every rank; on {card}", flush=True)
    if count >= 3:
        args = dict(vit=True, backend="nccl", every=5)
        _, trainer, one = run_trainer(_tp_args(
            "nccl_vit_one", TP_NCCL_VIT_STEPS, 1, 1, vit=True, every=5))
        trainer.close()
        ranks = spawn_ranks("tp_nccl_vit", {
            "kind": "tp", "deterministic": True, "runs": [
                {"name": "m3", "world": 3, "argv": _tp_args(
                    "nccl_vit_m3", TP_NCCL_VIT_STEPS, 3, 3, **args)}]},
            world=3, timeout_s=300)
        for r, x in enumerate(ranks):
            la = x["runs"]["m3"]["launches"]
            check(all(la[kn] == TP_NCCL_VIT_STEPS * 12 for kn in (
                "flash_fwd_lse", "flash_bwd_dq", "flash_bwd_dkv")),
                f"tp nccl vit rank {r}: launched {la}")
        gaps = _tp_loss_gaps("nccl_vit_m3", "nccl_vit_one")
        check(max(g for step, g in gaps if step <= TP_EARLY_STEPS)
              <= DP_CHUNK_LOSS_RTOL,
              f"tp nccl vit: logged losses against one card {gaps}")
        label = "tp_nccl_vit_chunk"
        cr = spawn_ranks(label, {"kind": "chunk", "reps": 4, "argv":
                                 _tp_args("nccl_vit_m3_chunk",
                                          TP_NCCL_VIT_STEPS, 3, 3,
                                          k=TP_VIT_K, **args)},
                         world=3, timeout_s=420)
        for r, x in enumerate(cr):
            c = x["graph_vs_eager"]
            check(c["launches_graph"] == c["launches_eager"]
                  and c["loss_gap"] == 0.0 and c["param_gap"] == 0.0,
                  f"{label} rank {r}: graph vs eager {c}, want bit-equal")
            check(x["replays"] == TP_NCCL_VIT_STEPS // TP_VIT_K
                  and x["misses"] == 0 and x["launches"]["flash_bwd_dq"]
                  == TP_NCCL_VIT_STEPS * 12,
                  f"{label} rank {r}: {x['replays']} replays, "
                  f"{x['misses']} misses, launched {x['launches']}")
        check(len({x["digest"] for x in cr}) == 1,
              f"{label}: ranks ended with different parameters")
        _dist_log_says(label, 3, "one CUDA graph replay each")
        log = train_log(os.path.join(WORK, "tp_nccl_vit_m3_chunk.jsonl"))
        res["vit"] = {
            "eager_ms_per_step": {
                "one card": 128 / one.images_per_sec * 1e3,
                "m3": 128 / ranks[0]["runs"]["m3"]["images_per_sec"] * 1e3},
            "loss_gaps": gaps,
            "chunk_loop_ms_per_step": 128 / log[-1][2] * 1e3,
            "replay_ms_per_step": cr[0]["replay_ms_per_step"],
            "busy_share": cr[0].get("busy_share"),
            "timeline": {k: cr[0].get(k) for k in cr[0]
                         if k.endswith("_ms")},
            "kernels": cr[0].get("kernels"),
            "graph_vs_eager": [x["graph_vs_eager"] for x in cr]}
        v = res["vit"]
        print(f"[tp nccl vit] ViT-Ti at model 3 on 3 NCCL ranks, batch 128 "
              f"f32, {TP_NCCL_VIT_STEPS} steps: eager ms/step "
              f"{ {n: round(x, 4)
                   for n, x in v['eager_ms_per_step'].items()} }"
              f"; largest logged loss gap to one card "
              f"{max(g for _, g in gaps):.3g}; chunked (K = {TP_VIT_K}) loop "
              f"{v['chunk_loop_ms_per_step']:.4f}, replay "
              f"{v['replay_ms_per_step']:.4f} ms/step, device busy "
              f"{v['busy_share']}, timeline {v['timeline']}; graphs "
              f"bit-equal to eager on every rank; on {card}", flush=True)
    res["wall_s"] = time.perf_counter() - t0
    print(f"[tp nccl] phase 34 (NCCL) took {res['wall_s']:.1f} s on {card}",
          flush=True)
    with open(os.path.join(OUT, "slice14_nccl.json"), "w") as f:
        json.dump(res, f, indent=1)
    return res


def tp_kernel_entries(tp) -> list:
    """The ``kernels`` line's rows of phase 34: K1 on a model rank's
    leaves (launches: rank 0 of the 2-rank CNN run), and K3/K4/K6/K7 at
    [32, 257, 1, 64] f32 (launches: rank 0 of the 3-rank ViT-Ti run; the
    [128, 257, 1, 64] timing beside)."""
    r = tp["kernels"]["sgd_update_plain"]
    out = [{
        "name": "sgd_update_plain", "kernel": "K1", "path": "tp",
        "route": "cuda",
        "source": "dml_cnn_cifar10_tpu_torch/csrc/sgd_update.cu",
        "cuda_kernel": "sgd_multi_kernel<false>",
        "replaces": "dml_cnn_cifar10_tpu/ops/optimizer.py:83",
        "launches": tp["cnn_m2"]["launches"]["sgd_update_plain"],
        "max_abs_err": r["max_abs_err"],
        **{k: r[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                             "bound_by", "library_ms", "library_device_ms")},
        "library": "torch.optim.SGD(fused=True).step",
        "work": f"one update of model rank 0's {r['leaves']} leaves at "
                f"model_axis 2 ({r['elements']} f32 elements: full1/full2 "
                f"at half width); launches: rank 0 of phase 34's 2-rank "
                f"CNN run, {TP_STEPS} steps"}]
    for name, kid, line, needle in (
            ("flash_fwd", "K3", 345, "flash_out_kernel"),
            ("flash_fwd_lse", "K4", 360, "flash_lse_kernel"),
            ("flash_bwd_dq", "K6", 688, "flash_dq_kernel"),
            ("flash_bwd_dkv", "K7", 736, "flash_dkv_kernel")):
        t = tp["flash_timing"][f"{name}/tp32"]
        t128 = tp["flash_timing"][f"{name}/tp128"]
        out.append({
            "name": name, "kernel": kid, "path": "tp", "route": "cuda",
            "source": "dml_cnn_cifar10_tpu_torch/csrc/flash_attention.cu",
            "cuda_kernel": needle,
            "replaces": f"dml_cnn_cifar10_tpu/ops/flash_attention.py:{line}",
            "launches": tp["vit_m3"]["launches"][name],
            "max_abs_err": tp["flash_worst"][f"{name}/float32"],
            **{k: t[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                 "bound_by", "bound_tc_ms", "flops",
                                 "library_ms", "library_device_ms",
                                 "library")},
            "work": f"one launch at a model rank's shape {t['shape']} f32 "
                    f"(ViT-Ti's 3 heads over 3 model ranks, views of its "
                    f"fused qkv); launches: rank 0 of phase 34's 3-rank "
                    f"ViT-Ti run, {TP_VIT_STEPS} steps (K3: its "
                    f"forward-only batches); max_abs_err over b = 32 and "
                    f"128",
            "b128": {k: t128[k] for k in ("shape", "ms", "device_ms",
                                          "plain_ms", "library_ms",
                                          "library_device_ms", "bound_ms",
                                          "bound_by", "bound_tc_ms")}})
    return out




# --------------------------------------------------------------------------
# 35. the ResNet rungs (models/resnet.py): BatchNorm running stats through
# every step path, cross-replica BN, cifar100-shaped and ImageNet-shaped
# data, K1/K2 on the ResNet leaves
# --------------------------------------------------------------------------

R18_RECORDS = 10_000
R18_BATCH = 1024
R18_EAGER_STEPS = 10
R18_CHUNK_STEPS, R18_K = 50, 10
R50_BATCH = 128
R50_RECORDS = 640
R50_STEPS, R50_K, R50_CHUNK_STEPS = 6, 5, 10
R50_VARIANT_STEPS = 3
RN_DIST_STEPS, RN_DIST_K, RN_DIST_BATCH = 20, 2, 128
RN_LOSS_RTOL = 1e-3
R18_PARAMS, R50_PARAMS = 11_173_962, 25_557_032
# Artifact against live weights on the card, relative to the largest
# logit: two CUDA graphs of the same ops, whose cuDNN algorithms may
# differ, through 50 layers.
RN_SERVE_REL = 1e-4
# Kernel-name groups of a ResNet step's device time (first match wins):
# K1/K2, cuDNN's convolutions (many of them GEMM-named: implicit-GEMM and
# 1x1 convs) with their layout transposes and the head's GEMM,
# the reductions (BatchNorm's E[x] and E[x²] and their backward sums, the
# global average pool, the loss), the max pool, and the elementwise rest
# (BatchNorm's normalize and its backward, ReLUs, residual adds).
RN_GROUPS = (("update (K1/K2)", re.compile(r"sgd_multi_kernel")),
             ("convs + GEMMs (cuDNN, cuBLAS)", re.compile(
                 r"convolve|dgrad|wgrad|fprop|winograd|cudnn|nchw|nhwc|"
                 r"implicit|gemm|xmma|cutlass|cublas", re.I)),
             ("reductions (BN stats)", re.compile(r"reduce", re.I)),
             ("max pool", re.compile(r"max_pool", re.I)),
             ("elementwise (BN normalize, ReLU, adds)", re.compile(r".")))


def _r18_args(name, steps, *extra, k=1, batch=R18_BATCH, lr="0.4",
              momentum="0.9"):
    """The README recipe's flags on ResNet-18 (CIFAR geometry)."""
    every = str(k if k > 1 else 10)
    return ["--model", "resnet18", "--dataset", "synthetic",
            "--data_dir", os.path.join(WORK, "r18_data"),
            "--log_dir", os.path.join(WORK, f"logs_{name}"),
            "--metrics_jsonl", os.path.join(WORK, f"{name}.jsonl"),
            "--synthetic_train_records", str(R18_RECORDS),
            "--fidelity", "fixed", "--batch_size", str(batch),
            "--learning_rate", lr, "--momentum", momentum,
            "--weight_decay", "5e-4", "--schedule", "cosine",
            "--warmup_steps", "10", "--cosine_decay_steps",
            str(R18_CHUNK_STEPS), "--use_native_loader", "false",
            "--total_steps", str(steps), "--output_every", every,
            "--eval_every", str(steps), "--checkpoint_every", str(steps),
            "--steps_per_dispatch", str(k), "--peak_tflops",
            F32_PEAK_TFLOPS, *extra]


def _r50_args(name, steps, *extra, k=1, momentum="0.9", peak=None,
              every=None):
    """ResNet-50 on imagenet_synth (256 stored, 224 crop, 1000 classes)."""
    every = str(every or (k if k > 1 else 5))
    return ["--model", "resnet50", "--dataset", "imagenet_synth",
            "--data_dir", os.path.join(WORK, "r50_data"),
            "--log_dir", os.path.join(WORK, f"logs_{name}"),
            "--metrics_jsonl", os.path.join(WORK, f"{name}.jsonl"),
            "--synthetic_train_records", str(R50_RECORDS),
            "--fidelity", "fixed", "--batch_size", str(R50_BATCH),
            "--learning_rate", "0.02", "--momentum", momentum,
            "--weight_decay", "5e-4", "--total_steps", str(steps),
            "--output_every", every, "--eval_every", str(steps),
            "--checkpoint_every", str(steps), "--steps_per_dispatch", str(k),
            "--peak_tflops", peak or F32_PEAK_TFLOPS, *extra]


def _train_losses(name) -> list:
    return [loss for _, loss, _ in train_log(os.path.join(
        WORK, f"{name}.jsonl"))]


def _rate(name, batch, after=0):
    """The run's mean images/s over its train records after step
    ``after``, ms/step, TFLOP/s and MFU."""
    recs = [r for r in records(os.path.join(WORK, f"{name}.jsonl"))
            if r["kind"] == "train" and r["step"] > after
            and r["images_per_sec"] > 0]
    check(bool(recs), f"{name}: no train record with a rate")
    rate = sum(r["images_per_sec"] for r in recs) / len(recs)
    stack = next((r["flops_stack"] for r in records(os.path.join(
        WORK, f"{name}.jsonl")) if "flops_stack" in r), None)
    return {"images_per_sec": rate, "ms_per_step": batch / rate * 1e3,
            "tflops_per_sec": recs[-1].get("tflops_per_sec_per_chip"),
            "mfu": recs[-1].get("mfu"), "flops_stack": stack}


def _free_card() -> None:
    """Drop the last run's tensors and return the allocator's cache."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def _eval_acc(lines) -> float:
    acc = [float(m[1]) for m in (EVAL_LINE.match(l) for l in lines) if m]
    check(bool(acc), "no eval line")
    return acc[-1]


def _resident_split(cfg, dev):
    from dml_cnn_cifar10_tpu_torch.data import pipeline as pipe
    it = pipe.input_pipeline(cfg.data, cfg.batch_size, train=True,
                             seed=cfg.seed)
    return (torch.from_numpy(it.images).to(dev),
            torch.from_numpy(it.labels.astype("int64")).to(dev))


def _replay_profile(fn, state, k, card, label, reps=3) -> dict:
    """Where a graphed chunk's steps go: replays timed by CUDA events, and
    one profiled replay's kernels grouped (``RN_GROUPS``), their union
    (the device's busy time) and the idle rest, per step."""
    from torch.profiler import ProfilerActivity, profile

    replay_ms = cuda_ms(lambda: fn(state), reps=reps, warmup=1) / k
    # torch.profiler has returned a session with no device event on the
    # card (seen in phase 34): up to three sessions.
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn(state)
            torch.cuda.synchronize()
        spans, groups = [], {g: 0.0 for g, _ in RN_GROUPS}
        for ev in prof.events():
            if not is_device_work(ev):
                continue
            spans.append((ev.time_range.start, ev.time_range.end))
            group = next(g for g, rx in RN_GROUPS if rx.search(ev.name))
            groups[group] += (ev.time_range.end
                              - ev.time_range.start) / 1e3 / k
        if spans:
            break
    check(bool(spans), f"{label}: three replay profiles traced no kernel")
    busy = _union_ms(spans) / k
    out = {"replay_ms_per_step": replay_ms, "device_busy_ms_per_step": busy,
           "device_busy_share": busy / replay_ms,
           "idle_ms_per_step": max(replay_ms - busy, 0.0),
           "groups_ms_per_step": groups}
    print(f"[resnet] {label}: a graph replay {replay_ms:.4f} ms/step, "
          f"device busy {busy:.4f} ms/step "
          f"({100 * busy / replay_ms:.1f}%), idle "
          f"{out['idle_ms_per_step']:.4f}; by group (ms/step): "
          + ", ".join(f"{g} {v:.4f}" for g, v in groups.items())
          + f" on {card}", flush=True)
    return out


def _chunk_gate(cfg, state, dev, k, label) -> tuple:
    """One graphed chunk against the same chunk body run eagerly from the
    same state (phase 9b's comparison, the running stats too), cuDNN
    deterministic, gated at phase 9b's pins. Returns the gaps and the
    graphed callable with its state."""
    ds_images, ds_labels = _resident_split(cfg, dev)
    c, fn, st = _graph_vs_eager(cfg, state, ds_images, ds_labels, True, k=k)
    print(f"[resnet] {label} graph vs eager body (cuDNN deterministic): "
          f"loss {c['loss_graph']!r} vs {c['loss_eager']!r} (gap "
          f"{c['loss_gap']:.3g}), params gap {c['param_gap']:.3g}, running "
          f"stats gap {c['mstate_gap']:.3g}, eager vs eager: loss gap "
          f"{c['eager_eager_loss_gap']:.3g}", flush=True)
    check(c["loss_gap"] <= CHUNK_LOSS_TOL * abs(c["loss_eager"])
          and c["param_gap"] <= CHUNK_PARAM_TOL
          and c["mstate_gap"] <= CHUNK_PARAM_TOL,
          f"{label}: graphed chunk vs eager body, cuDNN deterministic: "
          f"loss gap {c['loss_gap']}, params {c['param_gap']}, running "
          f"stats {c['mstate_gap']}")
    check(c["launches_graph"] == c["launches_eager"],
          f"{label}: a replay launched {c['launches_graph']}, the eager "
          f"body {c['launches_eager']}")
    return c, fn, st


def _meta_shapes(name, crop, classes):
    from dml_cnn_cifar10_tpu_torch.config import DataConfig, ModelConfig
    from dml_cnn_cifar10_tpu_torch.models.registry import get_model
    with torch.device("meta"):
        net = get_model(name)(ModelConfig(name=name, num_classes=classes),
                              DataConfig(crop_height=crop, crop_width=crop))
    return {n: tuple(p.shape) for n, p in net.named_parameters()}


def resnet_kernel_rows(dev, card, bytes_per_s, ops_per_s) -> dict:
    """K2 (and K1) on ResNet-18's 62 and ResNet-50's 161 f32 leaves (one
    and three launches an update), as ``update_kernel_rows`` holds and
    times them."""
    gen = torch.Generator(device=dev).manual_seed(35)
    rows = {}
    for tag, name, crop, classes, total, launches in (
            ("r18", "resnet18", 24, 10, R18_PARAMS, 1),
            ("r50", "resnet50", 224, 1000, R50_PARAMS, 3)):
        shapes = _meta_shapes(name, crop, classes)
        check(sum(math.prod(s) for s in shapes.values()) == total,
              f"{name}: parameter count")

        def make(shapes=shapes):
            return {n: torch.randn(s, device=dev, generator=gen)
                    for n, s in shapes.items()}

        got = update_kernel_rows(
            dev, card, bytes_per_s, ops_per_s,
            [("sgd_update_momentum", 0.9, 5e-4, tag, make),
             ("sgd_update_plain", 0.0, 0.0, tag, make)],
            lambda t, n=name, s=shapes: f"{n}'s {len(s)} leaves",
            total=total, launches=launches)
        for k, r in got.items():
            rows[f"{k}/{tag}"] = r
    return rows


def resnet_dist_runs(card, backend, world=2) -> dict:
    """Cross-replica BN over ``world`` data ranks (``backend``; gloo on
    this card, NCCL a card each): ResNet-18, global batch
    ``RN_DIST_BATCH``, plain SGD (K1), cuDNN deterministic. The resident
    chunked path at K = ``RN_DIST_K``, where every rank gathers its
    columns of the same global rows the one-rank run trains on (each
    logged loss within 1e-3 relative of it), replicated and zero1 (whole
    state gathered: zero1 equal to replicated bit for bit); under NCCL the
    chunks are CUDA graphs with the BN all-reduces captured, and an eager
    replicated run beside them."""
    import torch.distributed as dist  # noqa: F401  (the rank jobs use it)

    ref = f"rn_ref{world}"
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        run_cli(_r18_args(ref, RN_DIST_STEPS, k=RN_DIST_K,
                          batch=RN_DIST_BATCH, lr="0.1", momentum="0"))
    finally:
        torch.backends.cudnn.deterministic = saved
    want = _train_losses(ref)
    runs = []
    for mode in ("none", "zero1") + (("eager",) if backend == "nccl"
                                     else ()):
        name = f"rn_{backend}{world}_{mode}"
        extra = ["--optimizer_sharding", "zero1"] if mode == "zero1" else []
        k = 1 if mode == "eager" else RN_DIST_K
        runs.append({"name": name, "compare": (
            [f"rn_{backend}{world}_none"] if mode == "zero1" else []),
            "argv": _r18_args(name, RN_DIST_STEPS, *extra, k=k,
                              batch=RN_DIST_BATCH, lr="0.1", momentum="0")
            + _dist_args(world, backend)})
    label = f"resnet_{backend}{world}"
    t0 = time.perf_counter()
    ranks = spawn_ranks(label, {"kind": "shard", "deterministic": True,
                                "runs": runs}, world=world, timeout_s=600)
    secs = time.perf_counter() - t0
    out = {"ref_losses": want, "seconds": secs}
    for run in runs:
        name = run["name"]
        got = _train_losses(name)
        res = [r["runs"][name] for r in ranks]
        launches = [r["launches"].get("sgd_update_plain", 0) for r in res]
        check(all(n == RN_DIST_STEPS for n in launches),
              f"{name}: K1 launches per rank {launches}, want "
              f"{RN_DIST_STEPS} (one a step)")
        check(all(math.isfinite(x) for x in got), f"{name}: losses {got}")
        entry = {"losses": got, "launches": launches,
                 "images_per_sec": res[0]["images_per_sec"]}
        if not name.endswith("eager"):
            gaps = [abs(a - b) / abs(b) for a, b in zip(got, want)]
            check(len(got) == len(want) == RN_DIST_STEPS // RN_DIST_K
                  and max(gaps) <= RN_LOSS_RTOL,
                  f"{name}: logged losses {got} against one rank's {want}")
            entry["max_loss_rel_gap"] = max(gaps)
        if run["compare"]:
            gap = [r["gaps"][run["compare"][0]]["gap"] for r in res]
            check(all(g == 0.0 for g in gap),
                  f"{name}: whole state against replicated, gaps {gap}")
            entry["state_gap_to_replicated"] = gap
        out[name] = entry
        print(f"[resnet dist] {name} on {world} ranks over {backend}: "
              f"losses {['%.6f' % x for x in got]}"
              + (f", max gap to one rank {entry['max_loss_rel_gap']:.3g}"
                 if "max_loss_rel_gap" in entry else "")
              + (f", whole state vs replicated {entry['state_gap_to_replicated']}"
                 if "state_gap_to_replicated" in entry else "")
              + f"; K1 {launches} on {card}", flush=True)
    if backend == "nccl":
        _dist_log_says(f"{label}", world, "one CUDA graph replay each")
    return out


def resnet_phase(card, dev, bytes_per_s, ops_per_s) -> dict:
    """Phase 35 (see the module docstring)."""
    import numpy as np

    from dml_cnn_cifar10_tpu_torch import export as export_lib
    from dml_cnn_cifar10_tpu_torch.cli.main import (build_parser,
                                                    config_from_args)
    from dml_cnn_cifar10_tpu_torch.ops import optimizer as fused
    from dml_cnn_cifar10_tpu_torch.serve.engine import ServingEngine

    t_phase = time.perf_counter()
    res = {"card": card, "part_seconds": {}}

    def mark(part):
        res["part_seconds"][part] = time.perf_counter() - t_phase
        print(f"[resnet] {part} done at {res['part_seconds'][part]:.1f} s "
              f"into phase 35", flush=True)

    # -- ResNet-18, the recipe's flags: eager, then chunked -------------
    _, eager_k = _launched(lambda: run_cli(_r18_args(
        "r18_eager", R18_EAGER_STEPS)))
    check(eager_k == {"sgd_update_momentum": R18_EAGER_STEPS},
          f"ResNet-18 eager: launches {eager_k}, want K2 once a step")
    (lines, trainer, result), chunk_k = _launched(lambda: run_trainer(
        _r18_args("r18_chunk", R18_CHUNK_STEPS, k=R18_K)))
    replays = trainer.train_fn.graph.replays
    check(chunk_k == {"sgd_update_momentum": R18_CHUNK_STEPS}
          and replays == R18_CHUNK_STEPS // R18_K,
          f"ResNet-18 chunked: launches {chunk_k} in {replays} replays")
    losses = _train_losses("r18_chunk")
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"ResNet-18 chunked losses {losses}: must fall")
    cfg = trainer.cfg
    gate, fn, st = _chunk_gate(cfg, result.state, dev, R18_K, "ResNet-18")
    prof = _replay_profile(fn, st, R18_K, card, "ResNet-18 recipe step")
    ds_images, ds_labels = _resident_split(cfg, dev)
    _, fn0, st0 = _graph_vs_eager(cfg, result.state, ds_images, ds_labels,
                                  False, k=R18_K)
    modes18 = _mode_replays({"default": (fn0, st0),
                             "deterministic": (fn, st)}, R18_K, card,
                            "ResNet-18 recipe, chunked K = 10", reps=1)
    fn0.graph.release()
    del fn0, st0, ds_images, ds_labels
    fn.graph.release()
    trainer.close()
    del trainer, result, fn, st
    _free_card()
    res["r18"] = {"eager": {**_rate("r18_eager", R18_BATCH),
                            "losses": _train_losses("r18_eager"),
                            "launches": eager_k},
                  "chunked": {**_rate("r18_chunk", R18_BATCH, after=20),
                              "losses": losses, "launches": chunk_k,
                              "replays": replays,
                              "test_accuracy": _eval_acc(lines)},
                  "graph_vs_eager": gate, "replay_profile": prof,
                  "cudnn_modes": modes18}
    r = res["r18"]
    print(f"[resnet] ResNet-18 recipe (batch {R18_BATCH}, 24 px): eager "
          f"{r['eager']['ms_per_step']:.3f} ms/step "
          f"({r['eager']['images_per_sec']:.0f} img/s), chunked K={R18_K} "
          f"{r['chunked']['ms_per_step']:.3f} ms/step "
          f"({r['chunked']['images_per_sec']:.0f} img/s, "
          f"{r['chunked']['tflops_per_sec']} TFLOP/s, MFU "
          f"{r['chunked']['mfu']} of {F32_PEAK_TFLOPS} f32), device busy "
          f"{100 * prof['device_busy_share']:.1f}%, losses {losses[0]:.4f} "
          f"-> {losses[-1]:.4f}, test accuracy "
          f"{r['chunked']['test_accuracy']}%; K2 {chunk_k} on {card}",
          flush=True)

    mark("r18")
    # -- ResNet-50 on imagenet_synth, f32 and bf16 ----------------------
    for dtype, peak in (("float32", F32_PEAK_TFLOPS),
                        ("bfloat16", BF16_PEAK_TFLOPS)):
        tag = "f32" if dtype == "float32" else "bf16"
        extra = ("--compute_dtype", dtype)
        _free_card()
        torch.cuda.reset_peak_memory_stats()
        lines, k_eager = _launched(lambda: run_cli(_r50_args(
            f"r50_{tag}", R50_STEPS, *extra, peak=peak)))
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        check(k_eager == {"sgd_update_momentum": 3 * R50_STEPS},
              f"ResNet-50 {tag}: launches {k_eager}, want K2 3 a step")
        (clines, trainer, result), k_chunk = _launched(lambda: run_trainer(
            _r50_args(f"r50_{tag}_chunk", R50_CHUNK_STEPS, *extra, k=R50_K,
                      peak=peak)))
        check(k_chunk == {"sgd_update_momentum": 3 * R50_CHUNK_STEPS},
              f"ResNet-50 {tag} chunked: launches {k_chunk}")
        closses = _train_losses(f"r50_{tag}_chunk")
        check(closses[-1] < closses[0], f"ResNet-50 {tag} chunked losses "
              f"{closses}: must fall")
        entry = {"eager": {**_rate(f"r50_{tag}", R50_BATCH),
                           "losses": _train_losses(f"r50_{tag}"),
                           "launches": k_eager,
                           "test_accuracy": _eval_acc(lines),
                           "peak_gib": peak_gb},
                 "chunked": {**_rate(f"r50_{tag}_chunk", R50_BATCH),
                             "losses": _train_losses(f"r50_{tag}_chunk"),
                             "launches": k_chunk,
                             "test_accuracy": _eval_acc(clines)}}
        for run in ("eager", "chunked"):
            check(all(math.isfinite(x) for x in entry[run]["losses"]),
                  f"ResNet-50 {tag} {run}: losses {entry[run]['losses']}")
        entry["replay_profile"] = _replay_profile(
            trainer.train_fn, result.state, R50_K, card,
            f"ResNet-50 step ({tag})")
        if dtype == "float32":
            ds_images, ds_labels = _resident_split(trainer.cfg, dev)
            _, fn0, st0 = _graph_vs_eager(trainer.cfg, result.state,
                                          ds_images, ds_labels, False,
                                          k=R50_K)
            entry["cudnn_modes"] = _mode_replays(
                {"default": (fn0, st0),
                 "deterministic": (trainer.train_fn, result.state)}, R50_K,
                card, "ResNet-50 f32, chunked K = 5", reps=1)
            fn0.graph.release()
            del fn0, st0, ds_images, ds_labels
        trainer.close()
        del trainer, result
        _free_card()
        res[f"r50_{tag}"] = entry
        e, c = entry["eager"], entry["chunked"]
        print(f"[resnet] ResNet-50 {tag} (batch {R50_BATCH}, 224 px): "
              f"eager {e['ms_per_step']:.3f} ms/step "
              f"({e['images_per_sec']:.0f} img/s, {e['tflops_per_sec']} "
              f"TFLOP/s, MFU {e['mfu']} of {peak}), chunked K={R50_K} "
              f"{c['ms_per_step']:.3f} ms/step ({c['images_per_sec']:.0f} "
              f"img/s); losses {e['losses']}; eval on the running stats "
              f"{e['test_accuracy']}%; peak {peak_gb:.2f} GiB; K2 "
              f"{k_eager} on {card}", flush=True)

    mark("r50")
    # -- export and serve ResNet-50 (f32) with its running stats --------
    base = _r50_args("r50_f32", R50_STEPS)
    run_cli(base + ["--mode", "export"])
    artifact = os.path.join(WORK, "logs_r50_f32", export_lib.ARTIFACT_NAME)
    art = ServingEngine.from_artifact(artifact, dev)
    cfg = config_from_args(build_parser().parse_args(base))
    model, params, step = export_lib.restore_serving_params(cfg, dev)
    check(any(n.endswith(".mean") for n in params),
          "the served variables carry no running stats")
    live = ServingEngine.from_params(model, cfg.data, params, dev,
                                     version=str(step))
    art.warmup([1, 32])
    live.warmup([1, 32])
    rng = np.random.default_rng(35)
    images = rng.integers(0, 256, (32, 256, 256, 3), dtype=np.uint8)
    serve = {"artifact_bytes": os.path.getsize(artifact)}
    for b in (1, 32):
        a, ms = art.forward_timed(images[:b])
        want, _ = live.forward_timed(images[:b])
        rel = _rel(a, want)
        check(rel <= RN_SERVE_REL, f"ResNet-50 artifact vs live weights at "
              f"b={b}: {rel}")
        serve[f"b{b}"] = {"rel_gap": rel, "ms": ms}
    # A hot swap of params and running stats: the chunked run's step 10.
    ccfg = config_from_args(build_parser().parse_args(
        _r50_args("r50_f32_chunk", R50_CHUNK_STEPS, k=R50_K)))
    _, cand, cstep = export_lib.restore_serving_params(ccfg, dev)
    cparams = {n: t for n, t in cand.items()
               if not n.endswith((".mean", ".var"))}
    cstate = {n: t for n, t in cand.items()
              if n.endswith((".mean", ".var"))}
    ok, why = live.try_swap(cparams, version="no_state")
    check(not ok, "a swap without the running stats was accepted")
    ok, why = live.try_swap(cparams, cstate, version=f"chunk{cstep}")
    check(ok, f"swap with the running stats rejected: {why}")
    ref = ServingEngine.from_params(_fresh_model(ccfg), ccfg.data, cand, dev)
    got, _ = live.forward_timed(images)
    want, _ = ref.forward_timed(images)
    serve["swap_rel_gap"] = _rel(got, want)
    check(serve["swap_rel_gap"] <= RN_SERVE_REL,
          f"after the swap: {serve['swap_rel_gap']}")
    t, stop, url, _, rc = _serve_thread(base + ["--serve_buckets", "1,32"])
    import urllib.request
    reply = json.loads(urllib.request.urlopen(urllib.request.Request(
        f"{url}/predict", data=images[0].tobytes()), timeout=60).read())
    a1, _ = art.forward_timed(images[:1])
    check(reply["version"] == "artifact" and _rel(
        np.asarray(reply["logits"]), a1[0]) <= RN_SERVE_REL,
        "the served answer is not the artifact's")
    lg = _loadgen(["--target", url, "--mode", "closed", "--concurrency",
                   "32", "--duration_s", "2", "--image_size", "256"],
                  "r50_c32")
    _stop_serve(t, stop, rc, "ResNet-50 serve")
    check(lg["errors"] == 0 and lg["completed"] > 0,
          f"ResNet-50 serve at 32 clients: {lg['error_kinds']}")
    serve["http_c32"] = {k: lg.get(k) for k in ("completed", "achieved_qps",
                                                "latency_ms")}
    res["r50_serve"] = serve
    del art, live, ref, model, params, cand, cparams, cstate
    print(f"[resnet] ResNet-50 --mode export ({serve['artifact_bytes']} "
          f"bytes) and serve: artifact vs live weights (running stats) "
          f"{serve['b1']['rel_gap']:.3g} at b=1, {serve['b32']['rel_gap']:.3g}"
          f" at b=32; hot swap with model_state {serve['swap_rel_gap']:.3g};"
          f" HTTP 32 clients {lg['completed']} answers, "
          f"{lg['achieved_qps']} qps, p50 {lg['latency_ms']['p50']} ms, p99 "
          f"{lg['latency_ms']['p99']} ms on {card}", flush=True)

    mark("serve")
    # -- ResNet-50 variants: nf, s2d, remat (plain SGD: K1) ---------------
    variants = {}
    for name, extra in (("remat", ("--remat", "true")),
                        ("nf", ("--resnet_norm", "nf")),
                        ("s2d", ("--resnet_s2d", "true"))):
        _free_card()
        torch.cuda.reset_peak_memory_stats()
        _, k = _launched(lambda: run_cli(_r50_args(
            f"r50_v_{name}", R50_VARIANT_STEPS, *extra, momentum="0",
            every=1)))
        losses = _train_losses(f"r50_v_{name}")
        check(k == {"sgd_update_plain": 3 * R50_VARIANT_STEPS}
              and all(math.isfinite(x) for x in losses),
              f"ResNet-50 {name}: launches {k}, losses {losses}")
        variants[name] = {"launches": k, "losses": losses,
                          "peak_gib": torch.cuda.max_memory_allocated()
                          / 2 ** 30,
                          **_rate(f"r50_v_{name}", R50_BATCH)}
    # Against the f32 eager run (the same step with momentum buffers).
    plain_gib = res["r50_f32"]["eager"]["peak_gib"]
    check(variants["remat"]["peak_gib"] < plain_gib,
          f"remat did not lower the peak memory below {plain_gib} GiB")
    res["r50_variants"] = variants
    print(f"[resnet] ResNet-50 variants (3 steps, batch 128, f32, K1 3 a "
          f"step; the plain f32 run's peak {plain_gib:.2f} GiB): "
          + "; ".join(
              f"{n} {v['ms_per_step']:.2f} ms/step, peak "
              f"{v['peak_gib']:.2f} GiB" for n, v in variants.items())
          + f" on {card}", flush=True)

    mark("variants")
    # -- K1/K2 on the ResNet leaves, bit-equal and timed ----------------
    res["kernels"] = resnet_kernel_rows(dev, card, bytes_per_s, ops_per_s)
    res["launches"] = {"r18_k2": chunk_k, "r50_k2": res["r50_f32"]["eager"][
        "launches"], "r50_k1": variants["remat"]["launches"]}

    mark("kernels")
    # -- cross-replica BN on 2 gloo ranks on this card ------------------
    res["dist_gloo"] = resnet_dist_runs(card, "gloo")
    mark("dist_gloo")
    res["seconds"] = time.perf_counter() - t_phase
    with open(os.path.join(OUT, "slice15.json"), "w") as f:
        json.dump(res, f, indent=1)
    print(f"[resnet] phase 35: {res['seconds']:.1f} s on {card}",
          flush=True)
    return res


def resnet_nccl_phase(card, count) -> dict:
    """Phase 35 under ``--dist``: cross-replica BN over NCCL on 2 cards,
    chunked (one CUDA graph a chunk, the BN all-reduces captured) and
    eager."""
    res = {"card": card, "nccl2": resnet_dist_runs(card, "nccl")}
    with open(os.path.join(OUT, "slice15_nccl.json"), "w") as f:
        json.dump(res, f, indent=1)
    return res


def resnet_kernel_entries(rn) -> list:
    """The ``kernels`` line's rows of phase 35: K2 and K1 on ResNet-18's
    and ResNet-50's leaves."""
    out = []
    for key, kid, line, tag, launches, work in (
            ("sgd_update_momentum/r18", "K2", 70, "resnet18",
             rn["launches"]["r18_k2"],
             f"ResNet-18's recipe, {R18_CHUNK_STEPS} chunked steps"),
            ("sgd_update_momentum/r50", "K2", 70, "resnet50",
             rn["launches"]["r50_k2"], f"ResNet-50 f32, {R50_STEPS} steps"),
            ("sgd_update_plain/r18", "K1", 83, "resnet18",
             {"sgd_update_plain": rn["dist_gloo"]["rn_gloo2_none"][
                 "launches"][0]},
             f"rank 0 of the 2-rank cross-replica run, {RN_DIST_STEPS} "
             f"steps"),
            ("sgd_update_plain/r50", "K1", 83, "resnet50",
             rn["launches"]["r50_k1"],
             f"ResNet-50 f32 --remat, plain SGD, {R50_VARIANT_STEPS} "
             f"steps")):
        r = rn["kernels"][key]
        name = key.split("/")[0]
        out.append({
            "name": name, "kernel": kid, "path": tag, "route": "cuda",
            "source": "dml_cnn_cifar10_tpu_torch/csrc/sgd_update.cu",
            "cuda_kernel": f"sgd_multi_kernel<{str(kid == 'K2').lower()}>",
            "replaces": f"dml_cnn_cifar10_tpu/ops/optimizer.py:{line}",
            "launches": launches[name],
            "max_abs_err": r["max_abs_err"],
            **{k: r[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                 "bound_by", "library_ms",
                                 "library_device_ms")},
            "library": "torch.optim.SGD(fused=True).step",
            "work": f"one update of {tag}'s {r['leaves']} f32 leaves "
                    f"({r['elements']} params, "
                    f"{r['launches_per_update']} launch(es)); launches: "
                    f"{work}"})
    return out


# ---- the MoE rung (36) -----------------------------------------------

MOE_STEPS = 100                       # (a) the 257-token main path
MOE_RECIPE_STEPS, MOE_K = 50, 10      # (b) eager, then chunked
MOE_RANK_STEPS = 10                   # (d) the EP runs, eager
MOE_DP_STEPS = 20                     # (d) the data-rank runs: 2 chunks
MOE_EXPERTS = 8
MOE_LAYER = (32, 257, 192)            # (c) one layer: [B, S, D]
MOE_LAYER_REL = 1e-5                  # einsum vs scatter, x max|y|
# ViT-Ti's blocks: the flash kernels launch once a block a step.
MOE_BLOCKS = 12


def _moe_main_args(name, steps, *extra):
    """(a): phase 12's ViT-Ti recipe (72 px stored, 64 px crop: 257
    tokens, batch 128, f32, AdamW + cosine) as ``vit_moe`` with 8 experts
    and the scatter dispatch."""
    return ["--model", "vit_moe", "--moe_experts", str(MOE_EXPERTS),
            "--moe_dispatch", "scatter", "--dataset", "synthetic",
            "--data_dir", os.path.join(WORK, "data_vit"),
            "--image_size", "72", "--crop_size", "64",
            "--synthetic_train_records", "10000", "--fidelity", "fixed",
            "--batch_size", "128", "--optimizer", "adamw",
            "--learning_rate", "3e-4", "--schedule", "cosine",
            "--warmup_steps", "20", "--eval_every", str(steps),
            "--checkpoint_every", str(steps), "--output_every", "25",
            "--peak_tflops", F32_PEAK_TFLOPS,
            "--log_dir", os.path.join(WORK, f"logs_moe_{name}"),
            "--metrics_jsonl", os.path.join(WORK, f"moe_{name}.jsonl"),
            "--total_steps", str(steps), *extra]


def _moe_recipe_args(name, steps, *extra, world=1, backend="gloo",
                     model_axis=1, k=1, every=None):
    """The README recipe, ``--model vit_moe --moe_experts 8`` at the
    defaults (24 px crop of 32: 37 tokens, batch 128, the faithful plain
    SGD at lr 0.1, einsum dispatch), on ``world`` ranks (phase 34's rank
    job reads ``WORK/tp_<name>.jsonl``)."""
    every = every or max(k, 1)
    out = ["--model", "vit_moe", "--moe_experts", str(MOE_EXPERTS),
           "--dataset", "synthetic", "--data_dir",
           os.path.join(WORK, "data_moe"), "--synthetic_train_records",
           "10000", "--model_axis", str(model_axis),
           "--peak_tflops", F32_PEAK_TFLOPS,
           "--log_dir", os.path.join(WORK, f"logs_tp_{name}"),
           "--metrics_jsonl", os.path.join(WORK, f"tp_{name}.jsonl"),
           "--total_steps", str(steps), "--output_every", str(every),
           "--eval_every", "1000", "--checkpoint_every", "1000",
           "--steps_per_dispatch", str(k), *extra]
    return out + (_dist_args(world, backend) if world > 1 else [])


def _moe_checks(label, recs, experts=MOE_EXPERTS) -> list:
    """The ``train`` records' router stats: finite aux loss, dropped
    fraction in [0, 1], ``experts`` loads summing to 1 (1e-4); returns
    the losses."""
    train = [r for r in recs if r["kind"] == "train"]
    check(bool(train), f"{label}: no train record")
    for r in train:
        load = r.get("moe_expert_load")
        check(r.get("moe_aux_loss") is not None
              and math.isfinite(r["moe_aux_loss"])
              and r.get("moe_dropped_frac") is not None
              and 0.0 <= r["moe_dropped_frac"] <= 1.0
              and isinstance(load, list) and len(load) == experts
              and abs(sum(load) - 1.0) <= 1e-4,
              f"{label} step {r['step']}: router stats "
              f"{ {k: r.get(k) for k in r if k.startswith('moe_')} }")
    return [r["loss"] for r in train]


def moe_kernel_rows(dev, card, bytes_per_s, ops_per_s) -> dict:
    """K1 and K2 on the README recipe's ``vit_moe`` leaves (ViT-Ti, 8
    experts, 24 px: one launch an update), as ``update_kernel_rows`` holds
    and times them."""
    from dml_cnn_cifar10_tpu_torch.config import DataConfig, ModelConfig
    from dml_cnn_cifar10_tpu_torch.models.registry import get_model
    with torch.device("meta"):
        net = get_model("vit_moe")(ModelConfig(
            name="vit_moe", moe_experts=MOE_EXPERTS), DataConfig())
    shapes = {n: tuple(p.shape) for n, p in net.named_parameters()}
    total = sum(math.prod(v) for v in shapes.values())
    gen = torch.Generator(device=dev).manual_seed(36)

    def make():
        return {n: torch.randn(v, device=dev, generator=gen)
                for n, v in shapes.items()}

    return update_kernel_rows(
        dev, card, bytes_per_s, ops_per_s,
        [("sgd_update_plain", 0.0, 0.0, "vit_moe", make),
         ("sgd_update_momentum", 0.9, 5e-4, "vit_moe", make)],
        lambda tag: f"vit_moe's {len(shapes)} leaves ({MOE_EXPERTS} "
                    f"experts)", total=total)


def moe_layer_check(dev, card) -> dict:
    """(c): one MoE layer at ``MOE_LAYER``, 8 experts (ViT-Ti's widths,
    hidden 768), top-1 and top-2: the einsum form against the scatter form
    on the same tokens and leaves (y within ``MOE_LAYER_REL`` of its
    scale, the router stats equal), and each form's forward + backward
    timed by CUDA events and by its kernels' device time."""
    from dml_cnn_cifar10_tpu_torch.ops import moe

    b, s, d = MOE_LAYER
    gen = torch.Generator(device=dev).manual_seed(36)
    params = {n: torch.empty(v, device=dev) for n, v in
              moe.param_shapes(d, 4 * d, MOE_EXPERTS).items()}
    moe.init_moe_params_(params, gen)
    # A router that spreads the tokens over the experts (the init's 0.02
    # gate keeps most of them near a tie).
    params["gate.kernel"].normal_(0.0, 1.0, generator=gen)
    x = torch.randn((b, s, d), device=dev, generator=gen)
    out = {}
    for top_k in (1, 2):
        ys, stats = {}, {}
        for form in ("einsum", "scatter"):
            with torch.no_grad():
                ys[form], stats[form] = moe.moe_mlp(x, params, 1.25, top_k,
                                                    form)
        scale = ys["scatter"].abs().max().item()
        rel = (ys["einsum"] - ys["scatter"]).abs().max().item() / scale
        check(rel <= MOE_LAYER_REL, f"MoE layer top-{top_k}: einsum vs "
              f"scatter {rel:.3g} of max|y|")
        for key in ("dropped_frac", "expert_load", "aux_loss"):
            check(torch.equal(stats["einsum"][key], stats["scatter"][key]),
                  f"MoE layer top-{top_k}: {key} differs between the forms")
        row = {"rel_gap": rel,
               "dropped_frac": float(stats["scatter"]["dropped_frac"])}
        leaves = {n: t.clone().requires_grad_() for n, t in params.items()}
        xg = x.clone().requires_grad_()
        for form in ("einsum", "scatter"):
            def fwd_bwd(form=form):
                y, st = moe.moe_mlp(xg, leaves, 1.25, top_k, form)
                torch.autograd.grad(y.sum() + st["aux_loss"],
                                    [xg, *leaves.values()])
            row[f"{form}_ms"] = cuda_ms(fwd_bwd, reps=10, warmup=2)
            row[f"{form}_device_ms"] = sum(kernel_ms(fwd_bwd, reps=5)
                                           .values())
        out[f"top{top_k}"] = row
        print(f"[moe layer] [{b}, {s}, {d}] x {MOE_EXPERTS} experts, "
              f"top-{top_k}, capacity factor 1.25: einsum vs scatter "
              f"{rel:.3g} of max|y|, stats equal (dropped "
              f"{row['dropped_frac']:.4f}); forward + backward einsum "
              f"{row['einsum_ms']:.3f} ms (device "
              f"{row['einsum_device_ms']:.3f}), scatter "
              f"{row['scatter_ms']:.3f} ms (device "
              f"{row['scatter_device_ms']:.3f}) on {card}", flush=True)
    return out


def _moe_rank_runs(backend, worlds) -> tuple:
    """(d)'s runs, ``(one-process references, ranked runs)``: the README
    EP recipe with momentum 0.9 (K2 on a model rank's expert slices) at
    ``--model_axis 2`` on 2 ranks, eager; the recipe at data 2 x 64 on the
    resident device stream (every data rank takes its columns of the same
    global rows), two chunks of ``MOE_K`` steps (the second a pure replay
    over NCCL, whose loop rate is the replays'); each beside one
    process; given 4 ranks, data 2 x model 2 beside the 2 data ranks."""
    refs = {"moe_ep_rep": _moe_recipe_args(
                "moe_ep_rep", MOE_RANK_STEPS, "--momentum", "0.9", every=1),
            "moe_dp_rep": _moe_recipe_args("moe_dp_rep", MOE_DP_STEPS,
                                           k=MOE_K)}
    runs = [
        {"name": "moe_ep", "world": 2, "ref": "moe_ep_rep", "step1": 128,
         "model_axis": 2, "steps": MOE_RANK_STEPS, "argv": _moe_recipe_args(
             "moe_ep", MOE_RANK_STEPS, "--momentum", "0.9", world=2,
             backend=backend, model_axis=2, every=1)},
        {"name": "moe_dp", "world": 2, "ref": "moe_dp_rep", "step1": 128,
         "model_axis": 1, "steps": MOE_DP_STEPS, "argv": _moe_recipe_args(
             "moe_dp", MOE_DP_STEPS, world=2, backend=backend, k=MOE_K)}]
    if 4 in worlds:
        runs.append({"name": "moe_d2m2", "world": 4, "ref": "moe_dp",
                     "compare": ["moe_dp"], "step1": 128, "model_axis": 2,
                     "steps": MOE_DP_STEPS, "argv": _moe_recipe_args(
                         "moe_d2m2", MOE_DP_STEPS, world=4,
                         backend=backend, model_axis=2, k=MOE_K)})
    return refs, runs


def _moe_refs(refs) -> dict:
    """The one-process reference runs, in this process: their launches."""
    from dml_cnn_cifar10_tpu_torch.ops import flash_attention as fa
    from dml_cnn_cifar10_tpu_torch.ops import optimizer as fused
    out = {}
    for name, argv in refs.items():
        fused.reset_launches()
        fa.reset_launches()
        run_cli(argv)
        out[name] = {kn: n for kn, n in {**fa.LAUNCHES,
                                         **fused.LAUNCHES}.items() if n}
    return out


def _moe_check_ranks(label, ranks, runs, ref_launches, card) -> dict:
    """(d)'s gates: step 1 of every ranked run within the CPU pins of one
    process's, every logged loss of the run within
    ``DP_CHUNK_LOSS_RTOL`` of its reference's and the dropped fraction
    printed beside it, replicated leaves bit-equal over the ranks, K1 (K2
    under momentum) once a step on every rank and in the reference. The
    loop rates are the trainers' own (after the first dispatch)."""
    out = {}
    for run in runs:
        world, ref, m = run["world"], run["ref"], run["model_axis"]
        k2 = "--momentum" in run["argv"]
        want = {"sgd_update_momentum" if k2 else "sgd_update_plain":
                run["steps"]}
        for r, x in enumerate(ranks[:world]):
            la = x["runs"][run["name"]]["launches"]
            got = {kn: n for kn, n in la.items() if n}
            check(got == want, f"{label} rank {r} {run['name']}: launched "
                  f"{la}, want {want}")
        if ref in ref_launches:
            check(ref_launches[ref] == want, f"{ref}: launched "
                  f"{ref_launches[ref]}, want {want}")
        _check_tp_job(label, ranks[:world], world, m, [run["name"]])
        gaps = _tp_loss_gaps(run["name"], ref)
        check(max(g for _, g in gaps) <= DP_CHUNK_LOSS_RTOL,
              f"{label} {run['name']}: logged losses against {ref} {gaps}")
        a = [r for r in records(os.path.join(WORK, f"tp_{run['name']}.jsonl"))
             if r["kind"] == "train"]
        b = [r for r in records(os.path.join(WORK, f"tp_{ref}.jsonl"))
             if r["kind"] == "train"]
        _moe_checks(f"{label} {run['name']}", a)
        dropped = [(x["step"], x["moe_dropped_frac"], y["moe_dropped_frac"])
                   for x, y in zip(a, b)]
        x0 = ranks[0]["runs"][run["name"]]
        s1 = [x["runs"][run["name"]]["step1"] for x in ranks[:world]]
        out[run["name"]] = {
            "world": world, "model_axis": m, "loss_gaps": gaps,
            "dropped": dropped, "step1": s1,
            "ms_per_step": 128 / x0["images_per_sec"] * 1e3
            if x0["images_per_sec"] else None,
            "ref_ms_per_step": 128 / b[-1]["images_per_sec"] * 1e3
            if b[-1]["images_per_sec"] else None,
            "launches": x0["launches"], "wall_s": x0["wall_s"],
            "split_s": x0["split_s"]}
        print(f"[moe ranks] {run['name']}: {world} ranks over {label}, "
              f"model_axis {m}: step 1 within the CPU pins of one process "
              f"on every rank; logged losses within "
              f"{max(g for _, g in gaps):.3g} of {ref} (steps "
              f"{[s for s, _ in gaps]}); moe_dropped_frac (step, ranks, "
              f"reference) {dropped}; {out[run['name']]['ms_per_step']} "
              f"ms/step ({ref}: {out[run['name']]['ref_ms_per_step']}); "
              f"rank 0's set-up, step 1 and fit s {x0['split_s']} on "
              f"{card}", flush=True)
    return out


def moe_phase(card, dev, bytes_per_s, ops_per_s, spawned=None) -> dict:
    """Phase 36 (see the module docstring). ``spawned``: ``(refs, runs,
    ranks)`` of (d) when its rank runs rode phase 34's spawn."""
    import numpy as np

    from dml_cnn_cifar10_tpu_torch import export as export_lib
    from dml_cnn_cifar10_tpu_torch.cli.main import (build_parser,
                                                    config_from_args)
    from dml_cnn_cifar10_tpu_torch.data import download
    from dml_cnn_cifar10_tpu_torch.ops import flash_attention as fa
    from dml_cnn_cifar10_tpu_torch.ops import optimizer as fused
    from dml_cnn_cifar10_tpu_torch.serve.engine import ServingEngine

    t_phase = time.perf_counter()
    res = {"card": card, "part_seconds": {}}

    def mark(part):
        res["part_seconds"][part] = time.perf_counter() - t_phase
        print(f"[moe] {part} done at {res['part_seconds'][part]:.1f} s "
              f"into phase 36", flush=True)

    # -- (a) the main path: 257 tokens, scatter dispatch, AdamW ---------
    download.ensure_dataset(config_from_args(build_parser().parse_args(
        _moe_main_args("main", MOE_STEPS))).data)
    _free_card()
    torch.cuda.reset_peak_memory_stats()
    fused.reset_launches()
    fa.reset_launches()
    lines = run_cli(_moe_main_args("main", MOE_STEPS))
    launched = {**fa.LAUNCHES, **fused.LAUNCHES}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    recs = records(os.path.join(WORK, "moe_main.jsonl"))
    losses = _moe_checks("vit_moe main path", recs)
    check(losses[-1] < losses[0], f"vit_moe main path losses {losses}: the "
          f"last window must be below the first")
    # Forward-only batches (K3): one sweep of the 512-record test split at
    # 128, and the fresh-batch accuracy at every output boundary.
    fwd_only = 4 + MOE_STEPS // 25
    want = {"flash_fwd": fwd_only * MOE_BLOCKS,
            "flash_fwd_lse": MOE_STEPS * MOE_BLOCKS, "flash_fwd_stats": 0,
            "flash_bwd_dq": MOE_STEPS * MOE_BLOCKS,
            "flash_bwd_dkv": MOE_STEPS * MOE_BLOCKS,
            "sgd_update_plain": 0, "sgd_update_momentum": 0}
    check(launched == want, f"vit_moe main path launched {launched}, want "
          f"{want}")
    train = [r for r in recs if r["kind"] == "train"]
    win = train[1:]
    ips = sum(r["images_per_sec"] for r in win) / len(win)
    res["main"] = {
        "launches": launched, "losses": losses,
        "ms_per_step": 128 / ips * 1e3, "images_per_sec": ips,
        "tflops_per_sec": win[-1].get("tflops_per_sec_per_chip"),
        "mfu": win[-1].get("mfu"), "peak_gib": peak_gib,
        "flops_stack": train[0].get("flops_stack"),
        "device_step_ms": win[-1].get("device_step_ms"),
        "dropped_frac": [r["moe_dropped_frac"] for r in train],
        "aux_loss": [r["moe_aux_loss"] for r in train],
        "expert_load_last": train[-1]["moe_expert_load"],
        "test_accuracy": _eval_acc(lines)}
    r = res["main"]
    print(f"[moe main] vit_moe (ViT-Ti, {MOE_EXPERTS} experts, scatter) at "
          f"257 tokens, batch 128, f32, AdamW, {MOE_STEPS} steps: loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}, {r['ms_per_step']:.3f} "
          f"ms/step ({ips:.1f} img/s, {r['tflops_per_sec']} TFLOP/s, MFU "
          f"{r['mfu']} of {F32_PEAK_TFLOPS} f32), peak {peak_gib:.2f} GiB, "
          f"dropped {r['dropped_frac']}, aux {r['aux_loss']}, last load "
          f"{r['expert_load_last']}; launches {launched} on {card}",
          flush=True)
    prof = profile_vit(_moe_main_args("main", MOE_STEPS), "moe", card,
                       steps=5)
    res["main"]["profile"] = {k: v for k, v in prof.items()
                              if k != "kernels"}
    res["main"]["profile"]["top_kernels"] = prof["kernels"][:25]
    mark("main")

    # -- (e) export and serve the main path's checkpoint ----------------
    base = _moe_main_args("main", MOE_STEPS)
    run_cli(base + ["--mode", "export"])
    artifact = os.path.join(WORK, "logs_moe_main", export_lib.ARTIFACT_NAME)
    art = ServingEngine.from_artifact(artifact, dev)
    cfg = config_from_args(build_parser().parse_args(base))
    model, params, step = export_lib.restore_serving_params(cfg, dev)
    check(step == MOE_STEPS, f"the served checkpoint is step {step}")
    live = ServingEngine.from_params(model, cfg.data, params, dev,
                                     version=str(step))
    art.warmup([1, 32])
    live.warmup([1, 32])
    rng = np.random.default_rng(36)
    images = rng.integers(0, 256, (32, 72, 72, 3), dtype=np.uint8)
    serve = {"artifact_bytes": os.path.getsize(artifact)}
    for b in (1, 32):
        a, ms = art.forward_timed(images[:b])
        want_l, live_ms = live.forward_timed(images[:b])
        gap = float(np.abs(a - want_l).max())
        check(gap == 0.0, f"vit_moe artifact vs live weights at b={b}: "
              f"{gap}, want 0")
        serve[f"b{b}"] = {"gap": gap, "ms": ms, "live_ms": live_ms}
    # The server takes the artifact's engine, warmed up above.
    t, stop, url, _, rc = _serve_thread(base + ["--serve_buckets", "1,32"],
                                        engine=art)
    fa.reset_launches()
    lg = _loadgen(["--target", url, "--mode", "closed", "--concurrency",
                   "32", "--duration_s", "1", "--image_size", "72"],
                  "moe_c32")
    _stop_serve(t, stop, rc, "vit_moe serve")
    check(lg["errors"] == 0 and lg["completed"] > 0,
          f"vit_moe serve at 32 clients: {lg['error_kinds']}")
    serve["http_c32"] = {k: lg.get(k) for k in ("completed", "achieved_qps",
                                                "latency_ms")}
    serve["launches"] = dict(fa.LAUNCHES)
    check(serve["launches"]["flash_fwd"] > 0
          and serve["launches"]["flash_fwd"] % MOE_BLOCKS == 0,
          f"vit_moe serve launched {serve['launches']}")
    res["serve"] = serve
    del art, live, model, params
    print(f"[moe serve] --mode export ({serve['artifact_bytes']} bytes) and "
          f"serve: artifact vs live weights 0 apart at b = 1 and 32 "
          f"({serve['b1']['ms']:.3f} / {serve['b32']['ms']:.3f} ms a batch); "
          f"HTTP 32 clients {lg['completed']} answers, {lg['achieved_qps']} "
          f"qps, p50 {lg['latency_ms']['p50']} ms, p99 "
          f"{lg['latency_ms']['p99']} ms; K3 {serve['launches']['flash_fwd']}"
          f" on {card}", flush=True)
    mark("serve")

    # -- (b) the README recipe: eager, then chunked at K = 10 -----------
    download.ensure_dataset(config_from_args(build_parser().parse_args(
        _moe_recipe_args("data", 1))).data)
    _free_card()
    fused.reset_launches()
    fa.reset_launches()
    run_cli(_moe_recipe_args("moe_eager", MOE_RECIPE_STEPS, every=10))
    eager_k = {kn: n for kn, n in {**fa.LAUNCHES, **fused.LAUNCHES}.items()
               if n}
    check(eager_k == {"sgd_update_plain": MOE_RECIPE_STEPS},
          f"vit_moe recipe eager: launches {eager_k}, want K1 once a step")
    fused.reset_launches()
    fa.reset_launches()
    clines, trainer, result = run_trainer(_moe_recipe_args(
        "moe_chunk", MOE_RECIPE_STEPS, k=MOE_K))
    chunk_k = {kn: n for kn, n in {**fa.LAUNCHES, **fused.LAUNCHES}.items()
               if n}
    replays = trainer.train_fn.graph.replays
    check(chunk_k == {"sgd_update_plain": MOE_RECIPE_STEPS}
          and replays == MOE_RECIPE_STEPS // MOE_K,
          f"vit_moe recipe chunked: launches {chunk_k} in {replays} replays")
    recipe = {}
    for name in ("moe_eager", "moe_chunk"):
        rl = _moe_checks(f"vit_moe recipe {name}", records(
            os.path.join(WORK, f"tp_{name}.jsonl")))
        check(all(math.isfinite(x) for x in rl),
              f"vit_moe recipe {name}: losses {rl}")
        recipe[name] = {"losses": rl}
    cfg = trainer.cfg
    ds_images, ds_labels = _resident_split(cfg, dev)
    c, fn, st = _graph_vs_eager(cfg, result.state, ds_images, ds_labels,
                                True, k=MOE_K)
    check(c["loss_gap"] == 0.0 and c["param_gap"] == 0.0
          and c["moe_graph"] == c["moe_eager"]
          and c["launches_graph"] == c["launches_eager"],
          f"vit_moe recipe: graphed chunk vs eager body (cuDNN "
          f"deterministic): loss gap {c['loss_gap']}, params "
          f"{c['param_gap']}, router stats {c['moe_graph']} vs "
          f"{c['moe_eager']}, launches {c['launches_graph']} vs "
          f"{c['launches_eager']}")
    replay_ms = cuda_ms(lambda: fn(st), reps=3, warmup=1) / MOE_K
    fn.graph.release()
    trainer.close()
    del trainer, result, fn, st
    _free_card()
    recipe.update(launches_eager=eager_k, launches_chunked=chunk_k,
                  replays=replays, graph_vs_eager={
                      k: c[k] for k in ("loss_gap", "param_gap", "moe_graph",
                                        "moe_eager", "launches_graph")},
                  replay_ms_per_step=replay_ms)
    res["recipe"] = recipe
    print(f"[moe recipe] --model vit_moe --moe_experts 8 at the defaults "
          f"(37 tokens, einsum, SGD lr 0.1): {MOE_RECIPE_STEPS} eager and "
          f"{MOE_RECIPE_STEPS} chunked steps (K = {MOE_K}) with finite "
          f"losses {recipe['moe_chunk']['losses']}; K1 {chunk_k}; one graphed "
          f"chunk bit-equal to its eager body (loss, params, router stats "
          f"{c['moe_graph']}); a replay {replay_ms:.3f} ms/step on {card}",
          flush=True)
    res["kernels"] = moe_kernel_rows(dev, card, bytes_per_s, ops_per_s)
    mark("recipe")

    # -- (c) one MoE layer: einsum against scatter ----------------------
    res["layer"] = moe_layer_check(dev, card)
    mark("layer")

    # -- (d) ranks: expert parallelism and global routing over gloo -----
    if spawned is None:
        refs, runs = _moe_rank_runs("gloo", (2,))
        ranks = spawn_ranks("moe_gloo", {"kind": "tp", "deterministic": True,
                                         "runs": runs}, world=2,
                            timeout_s=600)
    else:
        refs, runs, ranks = spawned
    ref_launches = _moe_refs(refs)
    res["ranks"] = _moe_check_ranks("gloo on one card", ranks, runs,
                                    ref_launches, card)
    res["launches"] = {"k1_recipe": eager_k["sgd_update_plain"],
                       "k2_ep_rank0": ranks[0]["runs"]["moe_ep"]["launches"][
                           "sgd_update_momentum"],
                       "main": launched}
    mark("ranks")
    res["seconds"] = time.perf_counter() - t_phase
    with open(os.path.join(OUT, "slice16.json"), "w") as f:
        json.dump(res, f, indent=1)
    print(f"[moe] phase 36: {res['seconds']:.1f} s on {card}", flush=True)
    return res


def moe_nccl_phase(card, count) -> dict:
    """Phase 36 under ``--dist``, a card a rank over NCCL: (d)'s runs on 2
    cards and, given 4, data 2 x model 2 beside the 2 data ranks; the
    data-rank runs chunked at ``MOE_K`` (one CUDA graph a chunk,
    its all-reduces captured), their ms/step printed."""
    from dml_cnn_cifar10_tpu_torch.cli.main import (build_parser,
                                                    config_from_args)
    from dml_cnn_cifar10_tpu_torch.data import download

    if os.path.isdir(WORK):
        shutil.rmtree(WORK)
    os.makedirs(OUT, exist_ok=True)
    download.ensure_dataset(config_from_args(build_parser().parse_args(
        _moe_recipe_args("data", 1))).data)
    worlds = (2, 4) if count >= 4 else (2,)
    refs, runs = _moe_rank_runs("nccl", worlds)
    ref_launches = _moe_refs(refs)
    ranks = spawn_ranks("moe_nccl", {"kind": "tp", "deterministic": True,
                                     "runs": runs}, world=max(worlds),
                        timeout_s=600)
    res = {"card": card, "ranks": _moe_check_ranks(
        "nccl, a card a rank", ranks, runs, ref_launches, card)}
    with open(os.path.join(OUT, "slice16_nccl.json"), "w") as f:
        json.dump(res, f, indent=1)
    return res


def moe_kernel_entries(moe_res) -> list:
    """The kernels line's K1/K2 rows on ``vit_moe``'s leaves."""
    out = []
    for name, kid, line, launches, path in (
            ("sgd_update_plain", "K1", 83, moe_res["launches"]["k1_recipe"],
             "the README recipe's eager run"),
            ("sgd_update_momentum", "K2", 70,
             moe_res["launches"]["k2_ep_rank0"],
             "rank 0 of the EP run at --model_axis 2 (its expert slices)")):
        t = moe_res["kernels"][name]
        out.append({
            "name": name, "kernel": kid, "path": "vit_moe", "route": "cuda",
            "source": "dml_cnn_cifar10_tpu_torch/csrc/sgd_update.cu",
            "replaces": f"dml_cnn_cifar10_tpu/ops/optimizer.py:{line}",
            "launches": launches, "max_abs_err": t["max_abs_err"],
            **{k: t[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                 "bound_by", "library_ms",
                                 "library_device_ms")},
            "library": "torch.optim.SGD(fused=True).step",
            "work": f"one update of vit_moe's {t['leaves']} leaves "
                    f"({t['elements']} f32 params), mu={t['mu']}, "
                    f"wd={t['wd']}; launches: {path}, "
                    f"{MOE_RANK_STEPS if kid == 'K2' else MOE_RECIPE_STEPS} "
                    f"steps"})
    return out


# ---- 37. pipeline parallelism and the CNN's spatial split -------------

PP_VIT_STEPS = 5                      # (a) ViT-Ti at 257 tokens, gloo
PP_RECIPE_STEPS = 5                   # (b) the README recipe, gloo
PP_CNN_STEPS, PP_K = 10, 10           # (c) the CNN, eager and one chunk
PP_NCCL_STEPS = 10                    # --dist: eager steps, then a chunk
# The pins against one process of the same batches: the pipeline's last
# logged loss (ViT-Ti's 12 blocks, microbatched GEMMs); the CNN's first
# logged one, and its last (step 10), whose gap training grows from
# rounding (the halo rows' convolutions and the split gradient sums): the
# CPU reads 1.1e-7 at step 2 and 1.5e-4 at step 10 for data 2 x seq 2,
# 1.1e-3 for seq 2 (ROADMAP.md Queue 3). Every run's first step is held
# to the CPU pins besides (``_tp_step1``).
PP_LOSS_RTOL, SPATIAL_LOSS_RTOL, SPATIAL_LAST_RTOL = 1e-4, 1e-5, 5e-3
# K3/K4/K6/K7 at a stage's microbatch: batch 128 over M = 2 microbatches,
# ViT-Ti's 3 heads, views of its fused qkv.
PIPE_FLASH_CASES = [("pipe stage b64", (64, 257, 257, 3, 64), torch.float32,
                     {"strided": True})]
PIPE_FLASH_TIMING = [("pipe64", (64, 257, 3, 64), torch.float32)]
PP_SCHEDULES = ("1f1b", "1f1b_ring", "gpipe")


def _pp_args(name, steps, world, *extra, kind="vit", backend="gloo", k=1,
             every=None):
    """One run of phase 37: ``kind`` ``vit`` (phase 12's ViT-Ti recipe:
    72 px stored, 64 px crop, 257 tokens, batch 128, f32, AdamW), ``readme``
    (``--model vit_tiny`` at the defaults: 24 px crop of 32, 37 tokens,
    batch 128, the faithful plain SGD at lr 0.1) or ``cnn`` (the CNN main
    path's recipe on 10,000 records); its loss logged every ``every``
    steps (the last step by default) on ``world`` ranks."""
    if kind == "vit":
        base = ["--model", "vit_tiny", "--dataset", "synthetic",
                "--data_dir", os.path.join(WORK, "data_vit"),
                "--image_size", "72", "--crop_size", "64",
                "--synthetic_train_records", "10000", "--fidelity", "fixed",
                "--batch_size", "128", "--optimizer", "adamw",
                "--learning_rate", "3e-4"]
    elif kind == "readme":
        base = ["--model", "vit_tiny", "--dataset", "synthetic",
                "--data_dir", os.path.join(WORK, "data_moe"),
                "--synthetic_train_records", "10000"]
    else:
        base = ["--dataset", "synthetic", "--data_dir",
                os.path.join(WORK, "data_moe"), "--synthetic_train_records",
                "10000", "--fidelity", "fixed", "--learning_rate", "0.02",
                "--batch_size", "128"]
    out = base + [
        "--peak_tflops", F32_PEAK_TFLOPS,
        "--log_dir", os.path.join(WORK, f"logs_pp_{name}"),
        "--metrics_jsonl", os.path.join(WORK, f"tp_{name}.jsonl"),
        "--total_steps", str(steps),
        "--output_every", str(every or max(k, steps)),
        "--eval_every", "1000", "--checkpoint_every", "1000",
        "--steps_per_dispatch", str(k), *extra]
    return out + (_dist_args(world, backend) if world > 1 else [])


def _pp_datasets() -> None:
    """The synthetic datasets phase 37's runs read, made once here."""
    from dml_cnn_cifar10_tpu_torch.cli.main import (build_parser,
                                                    config_from_args)
    from dml_cnn_cifar10_tpu_torch.data import download
    for kind in ("vit", "readme"):
        download.ensure_dataset(config_from_args(build_parser().parse_args(
            _pp_args("data", 1, 1, kind=kind))).data)


def _pp_rank_runs() -> tuple:
    """(a)-(c)'s runs over gloo on this card: ``(one-process references,
    ranked runs)``; the ranked runs ride phase 34's spawn (each on its
    first ``world`` ranks)."""
    _pp_datasets()
    refs = {"pp_vit_one": _pp_args("pp_vit_one", PP_VIT_STEPS, 1),
            "pp_readme_one": _pp_args("pp_readme_one", PP_RECIPE_STEPS, 1,
                                      kind="readme"),
            "sp_cnn_one": _pp_args("sp_cnn_one", PP_CNN_STEPS, 1,
                                   kind="cnn", every=1),
            # Sums two halves of each batch as the 2 data ranks do (phase
            # 30's reference: one pass over all 128 takes another
            # summation order, which ten SGD steps carry to ~1e-3).
            "sp_cnn_one_chunk": _pp_args("sp_cnn_one_chunk", PP_CNN_STEPS,
                                         1, "--grad_accum", "2",
                                         kind="cnn", k=PP_K)}
    runs = [{"name": "sp_cnn_d2s2", "world": 4, "ref": "sp_cnn_one_chunk",
             "step1": 128, "argv": _pp_args(
                 "sp_cnn_d2s2", PP_CNN_STEPS, 4, "--seq_axis", "2",
                 kind="cnn", k=PP_K)},
            {"name": "pp_vit", "world": 2, "ref": "pp_vit_one",
             "step1": 128, "argv": _pp_args("pp_vit", PP_VIT_STEPS, 2,
                                            "--pipe_axis", "2")},
            {"name": "sp_cnn_s2", "world": 2, "ref": "sp_cnn_one",
             "step1": 128, "argv": _pp_args(
                 "sp_cnn_s2", PP_CNN_STEPS, 2, "--seq_axis", "2",
                 kind="cnn", every=1)}]
    for schedule, m in [(s, 0) for s in PP_SCHEDULES] + [("1f1b", 4)]:
        name = f"pp_readme_{schedule}" + (f"_m{m}" if m else "")
        runs.append({"name": name, "world": 2, "ref": "pp_readme_one",
                     "step1": 128, "argv": _pp_args(
                         name, PP_RECIPE_STEPS, 2, "--pipe_axis", "2",
                         "--pipe_schedule", schedule, "--pipe_microbatches",
                         str(m), kind="readme")})
    return refs, runs


def pp_kernel_rows(dev, card, bytes_per_s, ops_per_s) -> dict:
    """K3/K4/K6/K7 at a stage's microbatch [64, 257, 3, 64] f32 (views of
    a fused qkv) against their plain versions at the f32 pins, timed
    beside SDPA; K1 on stage 0's leaves of the README recipe at pipe 2
    (ViT-Ti's first 6 blocks and the replicated embed, LayerNorm and
    head) bit-equal to its plain version, timed beside fused SGD."""
    from dml_cnn_cifar10_tpu_torch.config import DataConfig, ModelConfig
    from dml_cnn_cifar10_tpu_torch.models.registry import get_model
    from dml_cnn_cifar10_tpu_torch.parallel.mesh import Mesh
    res = {"flash_worst": {f"{k}/{d}": v for (k, d), v in flash_parity(
        dev, PIPE_FLASH_CASES).items() if d == "float32"},
        "flash_timing": {f"{k}/{l}": v for (k, l), v in flash_timing(
            dev, card, bytes_per_s, ops_per_s, PIPE_FLASH_TIMING).items()}}
    with torch.device("meta"):
        net = get_model("vit_tiny")(ModelConfig(name="vit_tiny"),
                                    DataConfig(), mesh=Mesh(world=2, pipe=2))
    shapes = {n: tuple(p.shape) for n, p in net.named_parameters()}
    check(shapes["blocks.qkv.kernel"] == (6, 192, 576),
          f"stage 0's leaves {shapes}")
    total = sum(math.prod(v) for v in shapes.values())
    gen = torch.Generator(device=dev).manual_seed(37)

    def make():
        return {n: torch.randn(v, device=dev, generator=gen)
                for n, v in shapes.items()}

    res["update"] = update_kernel_rows(
        dev, card, bytes_per_s, ops_per_s,
        [("sgd_update_plain", 0.0, 0.0, "pipe", make)],
        lambda tag: f"stage 0's {len(shapes)} leaves at pipe_axis 2",
        total=total)
    return res


def _pp_launch_check(label, name, x, steps, rank, kind) -> None:
    """A run's launches on one rank: the README recipe and the CNN K1
    once a step and no flash kernel; ViT-Ti at 257 tokens (6 blocks a
    stage, 2 microbatches) K4 = K6 = K7 = 12 a step (the replays), K3 12
    a step more on stage 0 (its re-forwards) than on the last stage, whose
    re-forward output goes nowhere, K1 = K2 = 0 (AdamW)."""
    la = x["runs"][name]["launches"]
    if kind == "vit":
        ok = (all(la[kn] == 12 * steps for kn in (
            "flash_fwd_lse", "flash_bwd_dq", "flash_bwd_dkv"))
            and la["flash_fwd"] >= 12 * steps * (2 - rank)
            and la["flash_fwd_stats"] == 0 and la["sgd_update_plain"] == 0
            and la["sgd_update_momentum"] == 0)
    else:
        ok = la["sgd_update_plain"] == steps and not any(
            la[kn] for kn in la if kn != "sgd_update_plain")
    check(ok, f"{label} rank {rank} {name}: launched {la}")


def pp_phase(card, dev, bytes_per_s, ops_per_s, spawned=None) -> dict:
    """Phase 37 (see the module docstring). ``spawned``: ``(refs, runs,
    ranks)`` when the ranked runs rode phase 34's spawn."""
    from dml_cnn_cifar10_tpu_torch.ops import flash_attention as fa
    from dml_cnn_cifar10_tpu_torch.ops import optimizer as fused

    t_phase = time.perf_counter()
    res = {"card": card, "kernels": pp_kernel_rows(dev, card, bytes_per_s,
                                                   ops_per_s)}
    res["kernels_s"] = time.perf_counter() - t_phase
    if spawned is None:
        refs, runs = _pp_rank_runs()
        ranks = spawn_ranks("pp_gloo", {"kind": "tp", "deterministic": True,
                                        "runs": runs}, world=4,
                            timeout_s=600)
    else:
        refs, runs, ranks = spawned
    res["ranks_s"] = time.perf_counter() - t_phase - res["kernels_s"]
    ref_launches = {}
    for name, argv in refs.items():
        fused.reset_launches()
        fa.reset_launches()
        run_cli(argv)
        ref_launches[name] = {kn: n for kn, n in {
            **fa.LAUNCHES, **fused.LAUNCHES}.items() if n}
    res["refs_s"] = (time.perf_counter() - t_phase - res["kernels_s"]
                     - res["ranks_s"])
    out = {}
    for run in runs:
        name, world, ref = run["name"], run["world"], run["ref"]
        kind = "vit" if name == "pp_vit" else (
            "cnn" if name.startswith("sp_") else "readme")
        steps = PP_VIT_STEPS if kind == "vit" else (
            PP_CNN_STEPS if kind == "cnn" else PP_RECIPE_STEPS)
        for r, x in enumerate(ranks[:world]):
            _pp_launch_check("gloo on one card", name, x, steps, r, kind)
        check(len({x["runs"][name]["replicated"] for x in ranks[:world]})
              == 1, f"{name}: replicated leaves differ between ranks")
        step1 = [x["runs"][name]["step1"] for x in ranks[:world]]
        for r, s1 in enumerate(step1):
            check(s1["loss_excess"] <= 0 and s1["fsdp_pin_excess"] <= 0,
                  f"{name} rank {r}: step 1 against one process {s1}, "
                  f"outside the CPU pins")
        gaps = _tp_loss_gaps(name, ref)
        pin = PP_LOSS_RTOL
        if kind == "cnn":
            # A run logged before its last step: the first within 1e-5.
            step, gap = gaps[0]
            check(step == PP_CNN_STEPS or gap <= SPATIAL_LOSS_RTOL,
                  f"{name}: logged losses against {ref} {gaps}, want the "
                  f"first within {SPATIAL_LOSS_RTOL}")
            pin = SPATIAL_LAST_RTOL
        check(gaps[-1][1] <= pin, f"{name}: logged losses against {ref} "
              f"{gaps}, want the last within {pin}")
        x0 = ranks[0]["runs"][name]
        batch = 128
        out[name] = {"world": world, "loss_gaps": gaps, "step1": step1,
                     "launches": [x["runs"][name]["launches"]
                                  for x in ranks[:world]],
                     "ref_launches": ref_launches[ref],
                     "ms_per_step": batch / x0["images_per_sec"] * 1e3
                     if x0["images_per_sec"] else None,
                     "wall_s": x0["wall_s"], "split_s": x0["split_s"]}
        print(f"[pp gloo] {name}: {world} ranks over gloo on one card, "
              f"{steps} steps; step 1 within the CPU pins of one process "
              f"on every rank (state gap "
              f"{max(s['gap'] for s in step1):.3g}); logged losses from "
              f"{ref} {gaps} (the last's pin {pin}); launches rank 0 "
              f"{ {k: v for k, v in x0['launches'].items() if v} }; "
              f"{out[name]['ms_per_step']} ms/step; rank 0's set-up, "
              f"fit s {x0['split_s']} on {card}", flush=True)
    res["runs"] = out
    res["seconds"] = time.perf_counter() - t_phase
    with open(os.path.join(OUT, "slice17.json"), "w") as f:
        json.dump(res, f, indent=1)
    print(f"[pp] phase 37: {res['seconds']:.1f} s (kernels "
          f"{res['kernels_s']:.1f}, references {res['refs_s']:.1f}) on "
          f"{card}", flush=True)
    return res


def pp_nccl_phase(card, count) -> dict:
    """Phase 37 under ``--dist``, a card a rank over NCCL, in one spawn
    of 4 rank processes: ViT-Ti at 257 tokens (batch 128, f32, AdamW) at
    pipe 2 on 2 cards, pipe 4 on 4 (3 blocks a stage) and data 2 x pipe 2
    on 4, and the CNN at data 2 x seq 2 on 4: ``PP_NCCL_STEPS`` eager
    steps each (the trainer's ms/step), then each chunked at ``CHUNK_K``
    (``_rank_chunk``: one CUDA graph a chunk with the stage hops or halo
    exchanges captured, one graphed chunk bit-equal to its eager body on
    every rank, replays timed and traced: ms/step, device busy share and
    the NCCL kernels' device ms)."""
    t0 = time.perf_counter()
    _pp_datasets()
    check(count >= 4, f"--dist --phase 37 needs 4 cards, have {count}")
    cases = [("pp4", 4, "vit", ["--pipe_axis", "4"]),
             ("d2p2", 4, "vit", ["--pipe_axis", "2"]),
             ("cnn_d2s2", 4, "cnn", ["--seq_axis", "2"]),
             ("pp2", 2, "vit", ["--pipe_axis", "2"])]
    pool = _dist_args_n(2 * len(cases), 4, "nccl")

    def dist_args(i, world):
        hosts = pool[i][1].split(",")[:world]
        return ["--worker_hosts", ",".join(hosts), "--dist_backend", "nccl"]

    eager, parts = [], []
    for i, (name, world, kind, extra) in enumerate(cases):
        eager.append({"name": name, "world": world, "argv": _pp_args(
            f"nccl_{name}", PP_NCCL_STEPS, 1, *extra, kind=kind)
            + dist_args(2 * i, world)})
        parts.append({"label": f"pp_nccl_{name}_chunk", "kind": "chunk",
                      "world": world, "reps": 5, "argv": _pp_args(
                          f"nccl_{name}_chunk", 2 * CHUNK_K, 1, *extra,
                          kind=kind, k=CHUNK_K) + dist_args(2 * i + 1,
                                                            world)})
    got = spawn_parts("pp_nccl", [{"label": "pp_nccl_eager", "kind": "tp",
                                   "deterministic": True, "runs": eager}]
                      + parts, world=4, timeout_s=900)
    res = {"card": card, "cases": {}}
    for (name, world, kind, _), part in zip(cases, parts):
        ranks = got["pp_nccl_eager"][:world]
        steps = PP_NCCL_STEPS
        for r, x in enumerate(ranks):
            la = x["runs"][name]["launches"]
            if kind == "cnn":
                ok = la["sgd_update_plain"] == steps
            else:
                blocks = 12 // (4 if name == "pp4" else 2)
                m = 4 if name == "pp4" else 2
                ok = all(la[kn] == blocks * m * steps for kn in (
                    "flash_fwd_lse", "flash_bwd_dq", "flash_bwd_dkv"))
            check(ok, f"pp nccl {name} rank {r}: launched {la}")
        cr = got[part["label"]][:world]
        for r, x in enumerate(cr):
            c = x["graph_vs_eager"]
            check(c["launches_graph"] == c["launches_eager"]
                  and c["loss_gap"] == 0.0 and c["param_gap"] == 0.0,
                  f"{part['label']} rank {r}: graph vs eager {c}, want "
                  f"bit-equal")
            check(x["misses"] == 0 and x["replays"] == 2,
                  f"{part['label']} rank {r}: {x['replays']} replays, "
                  f"{x['misses']} misses")
        _dist_log_says(part["label"], world, "one CUDA graph replay each")
        x0 = ranks[0]["runs"][name]
        res["cases"][name] = {
            "world": world,
            "eager_ms_per_step": 128 / x0["images_per_sec"] * 1e3
            if x0["images_per_sec"] else None,
            "replay_ms_per_step": cr[0]["replay_ms_per_step"],
            "busy_share": cr[0].get("busy_share"),
            "nccl_ms_per_step": cr[0].get("comm_ms"),
            "timeline": {k: cr[0].get(k) for k in cr[0]
                         if k.endswith("_ms")},
            "kernels": cr[0].get("kernels"),
            "launches_rank0": x0["launches"],
            "graph_vs_eager": [x["graph_vs_eager"] for x in cr]}
        c = res["cases"][name]
        print(f"[pp nccl] {name} on {world} NCCL ranks, batch 128: eager "
              f"{c['eager_ms_per_step']} ms/step ({PP_NCCL_STEPS} steps); "
              f"chunked (K = {CHUNK_K}, one CUDA graph a chunk) replay "
              f"{c['replay_ms_per_step']:.4f} ms/step, device busy "
              f"{c['busy_share']}, NCCL {c['nccl_ms_per_step']} ms/step, "
              f"timeline {c['timeline']}; graphs bit-equal to eager on "
              f"every rank; on {card}", flush=True)
    res["wall_s"] = time.perf_counter() - t0
    print(f"[pp nccl] phase 37 (NCCL) took {res['wall_s']:.1f} s on {card}",
          flush=True)
    with open(os.path.join(OUT, "slice17_nccl.json"), "w") as f:
        json.dump(res, f, indent=1)
    return res


def pp_kernel_entries(pp) -> list:
    """The kernels line's rows of phase 37: K3/K4/K6/K7 at a stage's
    microbatch [64, 257, 3, 64] f32 (launches: rank 0, stage 0, of the
    ViT-Ti pipe-2 run) and K1 on stage 0's leaves (launches: rank 0 of the
    README recipe's 1f1b run)."""
    kr = pp["kernels"]
    r = kr["update"]["sgd_update_plain"]
    out = [{
        "name": "sgd_update_plain", "kernel": "K1", "path": "pipe",
        "route": "cuda",
        "source": "dml_cnn_cifar10_tpu_torch/csrc/sgd_update.cu",
        "cuda_kernel": "sgd_multi_kernel<false>",
        "replaces": "dml_cnn_cifar10_tpu/ops/optimizer.py:83",
        "launches": pp["runs"]["pp_readme_1f1b"]["launches"][0][
            "sgd_update_plain"],
        "max_abs_err": r["max_abs_err"],
        **{k: r[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                             "bound_by", "library_ms", "library_device_ms")},
        "library": "torch.optim.SGD(fused=True).step",
        "work": f"one update of stage 0's {r['leaves']} leaves at "
                f"pipe_axis 2 ({r['elements']} f32 elements: 6 of ViT-Ti's "
                f"12 blocks, the embed, LayerNorm and head); launches: "
                f"rank 0 of phase 37's README-recipe 1f1b run, "
                f"{PP_RECIPE_STEPS} steps"}]
    for name, kid, line, needle in (
            ("flash_fwd", "K3", 345, "flash_out_kernel"),
            ("flash_fwd_lse", "K4", 360, "flash_lse_kernel"),
            ("flash_bwd_dq", "K6", 688, "flash_dq_kernel"),
            ("flash_bwd_dkv", "K7", 736, "flash_dkv_kernel")):
        t = kr["flash_timing"][f"{name}/pipe64"]
        out.append({
            "name": name, "kernel": kid, "path": "pipe", "route": "cuda",
            "source": "dml_cnn_cifar10_tpu_torch/csrc/flash_attention.cu",
            "cuda_kernel": needle,
            "replaces": f"dml_cnn_cifar10_tpu/ops/flash_attention.py:{line}",
            "launches": pp["runs"]["pp_vit"]["launches"][0][name],
            "launches_last_stage": pp["runs"]["pp_vit"]["launches"][1][name],
            "max_abs_err": kr["flash_worst"][f"{name}/float32"],
            **{k: t[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                 "bound_by", "bound_tc_ms", "flops",
                                 "library_ms", "library_device_ms",
                                 "library")},
            "work": f"one launch at a stage's microbatch {t['shape']} f32 "
                    f"(ViT-Ti, batch 128 over 2 microbatches, views of its "
                    f"fused qkv); launches: rank 0 (stage 0) of phase 37's "
                    f"pipe-2 run, {PP_VIT_STEPS} steps (1f1b: K3 forward "
                    f"and re-forward, K4 the replay, K6/K7 its backward)"})
    return out


# ---- phase 38: the run supervisor and the cluster layer ----------------
# The supervised main path: stop step, checkpoint cadence, the chunk size,
# and the faults of the K1 runs (eager and chunked) and of the K2 run.
SUP_STEPS, SUP_EVERY, SUP_K = 60, 10, 10
SUP_FAULTS, SUP_MOM_FAULTS = "nan@25,ckpt_corrupt@26,data_stall@45", "nan@25"
SUP_LR, SUP_MOM_LR, SUP_SCALE, SUP_BACKOFF = 0.1, 0.02, 0.5, 0.05
# The fault, rollback, recovery and fallback records each run must log:
# (kind, step, fault, injected, action, attempt), the JAX package's
# sequence for these specs (tests/test_torch_supervisor.py holds the
# port's records to JAX's field for field).
SUP_SEQ = {
    "eager": [("fault", 25, "nan", True, None, None),
              ("fault", 26, "ckpt_corrupt", True, None, None),
              ("fault", 30, "nonfinite", False, None, None),
              ("fault", 20, "nonfinite", False, None, None),
              ("rollback", 20, None, None, None, 1),
              ("recovery", 20, "nonfinite", None, "restart", 1),
              ("ckpt_fallback", 20, None, None, None, None),
              ("fault", 45, "data_stall", True, None, None),
              ("fault", 40, "data", False, None, None),
              ("recovery", 40, "data", None, "restart", 2),
              ("recovery", 60, "none", None, "recovered", 2)],
    # Chunks of 10: the faults fire at the seam of step 30, the NaN shows
    # at the boundary of 40, and the stall at the seam of 50.
    "chunked": [("fault", 30, "nan", True, None, None),
                ("fault", 30, "ckpt_corrupt", True, None, None),
                ("fault", 40, "nonfinite", False, None, None),
                ("fault", 30, "nonfinite", False, None, None),
                ("rollback", 30, None, None, None, 1),
                ("recovery", 30, "nonfinite", None, "restart", 1),
                ("ckpt_fallback", 30, None, None, None, None),
                ("fault", 50, "data_stall", True, None, None),
                ("fault", 50, "data", False, None, None),
                ("recovery", 50, "data", None, "restart", 2),
                ("recovery", 60, "none", None, "recovered", 2)],
    "momentum": [("fault", 25, "nan", True, None, None),
                 ("fault", 30, "nonfinite", False, None, None),
                 ("fault", 20, "nonfinite", False, None, None),
                 ("rollback", 20, None, None, None, 1),
                 ("recovery", 20, "nonfinite", None, "restart", 1),
                 ("recovery", 60, "none", None, "recovered", 1)],
}
# The lockstep simulations: stop step, the lost host's and the returning
# host's steps, and the beat thresholds (a rank process takes about 20 s
# to start; the dead-peer threshold leaves room for two starting apart).
SIM_STEPS, SIM_LOST, SIM_RETURN, SIM_RESTORE = 40, 15, 18, 10
SIM_FLAGS = ["--heartbeat_interval_s", "0.1", "--straggler_after_s", "0.4",
             "--peer_dead_after_s", "5", "--collective_timeout_s", "300"]
SEAM_STEPS, SEAM_EVERY = 200, 50


class _RestartClock:
    """Phase 38's watch on the supervised loop of this process (it patches
    the classes it watches until :meth:`close`): when the supervisor
    classifies each failure (or a fenced host asks to rejoin), how long
    each trainer's construction, its restore, the set-up between the
    restore and the first dispatch, and that dispatch (waited for; on the
    chunked path the graph's warm-up and capture) take, the steps each
    attempt dispatches, and the device memory allocated after each
    attempt."""

    def __init__(self):
        from dml_cnn_cifar10_tpu_torch.parallel import step as step_lib
        from dml_cnn_cifar10_tpu_torch.train import loop, supervisor
        self.events, self.memory, self.steps = [], [], 0
        self.inside = False
        self._undo = []
        clock = self

        def patch(obj, name, wrap):
            orig = getattr(obj, name)
            self._undo.append((obj, name, orig))
            setattr(obj, name, wrap(orig))

        def timed(label):
            def wrap(orig):
                def fn(*args, **kwargs):
                    t0 = time.perf_counter()
                    try:
                        return orig(*args, **kwargs)
                    finally:
                        clock.events.append((label, t0,
                                             time.perf_counter()))
                return fn
            return wrap

        def at_fault(orig):
            def fn(*args, **kwargs):
                t = time.perf_counter()
                clock.events.append(("fault", t, t))
                return orig(*args, **kwargs)
            return fn

        def counted(orig):
            def fn(*args, **kwargs):
                stream = kwargs.get("index_stream")
                return _CountedStep(orig(*args, **kwargs), clock,
                                    stream[2] if stream else 1)
            return fn

        patch(supervisor, "classify_failure", at_fault)
        # A fenced host's rejoin request starts its restart.
        patch(supervisor, "_request_rejoin", at_fault)
        patch(loop.Trainer, "__init__", timed("rebuild"))
        patch(loop.Trainer, "init_or_restore", timed("restore"))
        patch(step_lib, "make_train_step", counted)
        patch(step_lib, "make_train_chunk_resident", counted)

    def on_attempt(self, then=None):
        """After each attempt: the device memory, then ``then()`` (the
        caller's snapshot); their time is the harness's, not the
        restart's."""
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        self.memory.append(torch.cuda.memory_allocated())
        if then is not None:
            then()
        self.events.append(("harness", t0, time.perf_counter()))

    def restarts(self, backoffs) -> list:
        """Each restart's wall time, from the failure's classification to
        the end of the first dispatch after the restore, with its parts
        (``backoffs``: the supervisor's sleeps, from its records); the
        harness's own work between the two is left out."""
        out = []
        faults = [t for name, t, _ in self.events if name == "fault"]
        for i, t_fault in enumerate(faults):
            later = {}
            for name, t0, t1 in self.events:
                if t0 >= t_fault and name != "fault" and name not in later:
                    later[name] = t1 - t0, t0, t1
            if "first_step" not in later or "restore" not in later:
                continue
            harness = later.get("harness", (0.0,))[0]
            entry = {"wall_s": later["first_step"][2] - t_fault - harness,
                     "backoff_s": backoffs[i] if i < len(backoffs) else None,
                     "rebuild_s": later.get("rebuild", (None,))[0],
                     "restore_s": later["restore"][0],
                     # The input pipelines, the resident split's upload
                     # and the step functions, between the two.
                     "setup_s": later["first_step"][1] - later["restore"][2],
                     "first_dispatch_s": later["first_step"][0]}
            entry["other_s"] = entry["wall_s"] - sum(
                v for k, v in entry.items()
                if k.endswith("_s") and k != "wall_s" and v)
            out.append(entry)
        return out

    def close(self):
        for obj, name, orig in reversed(self._undo):
            setattr(obj, name, orig)


class _CountedStep:
    """A step or chunk function whose calls count the steps they dispatch
    and whose first call's end is waited for and timed; every attribute of
    the function it wraps (a chunk's graph, its index check) reads
    through. A step called inside another (a chunk's body) is not
    counted again."""

    def __init__(self, fn, clock, k):
        self._fn, self._clock, self._k, self._first = fn, clock, k, True

    def __getattr__(self, name):
        return getattr(self._fn, name)

    def __call__(self, state, *inputs):
        clock = self._clock
        if clock.inside:
            return self._fn(state, *inputs)
        clock.inside = True
        t0 = time.perf_counter()
        try:
            out = self._fn(state, *inputs)
        finally:
            clock.inside = False
        clock.steps += self._k
        if self._first:
            self._first = False
            torch.cuda.synchronize()
            clock.events.append(("first_step", t0, time.perf_counter()))
        return out


def _sup_args(name, *extra, lr=SUP_LR):
    """The main path's recipe (batch 128, 24 px crop, 50,000 records,
    plain SGD) at ``lr`` under phase 38's supervisor flags."""
    log_dir = os.path.join(WORK, "sup", name)
    return cnn_args(WORK) + [
        "--learning_rate", str(lr), "--log_dir", log_dir,
        "--total_steps", str(SUP_STEPS), "--output_every", str(SUP_EVERY),
        "--eval_every", "1000", "--checkpoint_every", str(SUP_EVERY),
        "--metrics_jsonl", os.path.join(WORK, "sup", f"{name}.jsonl"),
        "--supervise", "true", "--check_numerics", "true",
        "--on_nonfinite", "rollback", "--rollback_lr_scale", str(SUP_SCALE),
        "--recovery_backoff_s", str(SUP_BACKOFF), *extra]


def _sup_sequence(path) -> list:
    return [(r["kind"], r["step"], r.get("fault"), r.get("injected"),
             r.get("action"), r.get("attempt")) for r in records(path)
            if r["kind"] in ("fault", "rollback", "recovery",
                             "ckpt_fallback")]


def _schema_lint(path, label) -> None:
    lint = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "check_jsonl_schema.py"),
         "--strict", path], capture_output=True, text=True, timeout=120)
    check(lint.returncode == 0, f"{label}: schema lint {lint.stdout} "
          f"{lint.stderr}")


def _supervised_run(name, card, extra=(), lr=SUP_LR) -> dict:
    """One supervised run of the main path (``fit_supervised`` on the
    CLI's config, as ``--supervise true`` runs it), snapshotting its log
    dir after every attempt; then the fault-free run restored from the
    snapshot its last attempt restored from, at the LR it ended with, and
    the two final states compared bit for bit (parameters and, with
    momentum, K2's buffers). K1/K2 launches against the steps dispatched
    across every attempt; the record sequence, the schema lint, each
    restart's time and the device memory after each attempt."""
    from dml_cnn_cifar10_tpu_torch.cli.main import (build_parser,
                                                    config_from_args)
    from dml_cnn_cifar10_tpu_torch.ops import optimizer as fused
    from dml_cnn_cifar10_tpu_torch.train.loop import Trainer
    from dml_cnn_cifar10_tpu_torch.train.supervisor import fit_supervised

    args = _sup_args(name, *extra, lr=lr)
    cfg = config_from_args(build_parser().parse_args(args))
    cfg.keep_checkpoints = 20
    snaps = []

    def snapshot():
        dst = os.path.join(WORK, "sup", f"{name}_snap{len(snaps)}")
        shutil.copytree(cfg.log_dir, dst)
        snaps.append(dst)

    clock = _RestartClock()

    def on_attempt():
        clock.on_attempt(then=snapshot)

    print("$ python -m dml_cnn_cifar10_tpu_torch " + " ".join(args),
          flush=True)
    fused.reset_launches()
    t0 = time.perf_counter()
    try:
        result = fit_supervised(cfg, on_attempt=on_attempt)
    finally:
        clock.close()
    wall_s = time.perf_counter() - t0
    launches = dict(fused.LAUNCHES)
    check(result is not None and result.final_step == SUP_STEPS,
          f"supervised {name}: ended at "
          f"{None if result is None else result.final_step}")
    kernel = "sgd_update_momentum" if cfg.optim.momentum else \
        "sgd_update_plain"
    check(launches[kernel] == clock.steps and clock.steps > SUP_STEPS
          and sum(launches.values()) == clock.steps,
          f"supervised {name}: launches {launches} for {clock.steps} steps "
          f"dispatched across every attempt")
    path = cfg.metrics_jsonl
    seq = _sup_sequence(path)
    check(seq == SUP_SEQ[name], f"supervised {name}: records {seq}, want "
          f"{SUP_SEQ[name]}")
    _schema_lint(path, f"supervised {name}")
    recs = records(path)
    rollbacks = [r for r in recs if r["kind"] == "rollback"]
    check(all(r["lr"] == lr * SUP_SCALE for r in rollbacks)
          and cfg.optim.learning_rate == lr * SUP_SCALE,
          f"supervised {name}: rollback LR {rollbacks}, config "
          f"{cfg.optim.learning_rate}")
    attempts = len(snaps)
    check(len(clock.memory) == attempts and attempts >= 2,
          f"supervised {name}: {attempts} attempts, memory {clock.memory}")
    # A failed attempt's trainer, graph and resident data are freed
    # before the next one is built.
    grown = max(clock.memory[:-1]) - clock.memory[0]
    check(grown <= 1 << 20, f"supervised {name}: device memory after the "
          f"failed attempts {clock.memory} grows")
    backoffs = [r["backoff_s"] for r in recs if r["kind"] == "recovery"
                and r["action"] == "restart"]
    restarts = clock.restarts(backoffs)
    check(len(restarts) == attempts - 1,
          f"supervised {name}: restarts {restarts}")
    # The fault-free run restored from what the last attempt restored.
    ref_dir = os.path.join(WORK, "sup", f"{name}_ref")
    shutil.copytree(snaps[-2], ref_dir)
    ref_cfg = config_from_args(build_parser().parse_args(args))
    ref_cfg.supervise, ref_cfg.fault_spec = False, None
    ref_cfg.log_dir, ref_cfg.metrics_jsonl = ref_dir, None
    ref_cfg.keep_checkpoints = 20
    ref_cfg.optim.learning_rate = cfg.optim.learning_rate
    trainer = Trainer(ref_cfg)
    try:
        ref = trainer.fit()
    finally:
        trainer.close()
    keys = ["params"] + (["momentum"] if cfg.optim.momentum else [])
    for key in keys:
        got = result.state.params if key == "params" else \
            result.state.opt[key]
        want = ref.state.params if key == "params" else ref.state.opt[key]
        diff = {n: (got[n] - want[n]).abs().max().item() for n in got
                if not torch.equal(got[n], want[n])}
        check(not diff, f"supervised {name}: {key} differ from the "
              f"fault-free run restored from the same checkpoint: {diff}")
    restored = max(int(n[5:].split(".")[0]) for n in os.listdir(snaps[-2])
                   if n.startswith("ckpt_") and n.endswith(".msgpack"))
    out = {"launches": launches, "steps_dispatched": clock.steps,
           "attempts": attempts, "memory_allocated": clock.memory,
           "restarts": restarts, "wall_s": wall_s, "records": seq,
           "lr_after": cfg.optim.learning_rate,
           "reference_restored_from_dir_newest": restored,
           "bit_equal": keys}
    print(f"[supervise] {name}: {attempts} attempts, {clock.steps} steps "
          f"dispatched, {kernel} launched {launches[kernel]}; final "
          f"{' and '.join(keys)} bit-equal to the fault-free run restored "
          f"from the same directory at lr {cfg.optim.learning_rate}; "
          f"memory_allocated after each attempt {clock.memory} bytes; "
          f"restarts {_rounded(restarts)}; {wall_s:.2f} s, on {card}",
          flush=True)
    return out


def _rounded(restarts) -> list:
    return [{k: round(v, 4) if v else v for k, v in r.items()}
            for r in restarts]


def _rank_supervise(rank: int, job: dict) -> dict:
    """A lockstep simulation's process: ``fit_supervised`` on the CLI's
    config of ``job["args"]`` (its own log dir and faults), timed by
    :class:`_RestartClock`; its parameter digest, or that it was fenced."""
    from dml_cnn_cifar10_tpu_torch.cli.main import (build_parser,
                                                    config_from_args)
    from dml_cnn_cifar10_tpu_torch.train.supervisor import fit_supervised
    args = job["args"] + ["--log_dir", job["log_dirs"][rank],
                          "--task_index", str(rank)]
    if job["faults"][rank]:
        args += ["--fault_spec", job["faults"][rank]]
    cfg = config_from_args(build_parser().parse_args(args))
    cfg.keep_checkpoints = 20
    cfg.metrics_jsonl = os.path.join(job["log_dirs"][rank], "m.jsonl")
    clock = _RestartClock()
    try:
        res = fit_supervised(cfg, task_index=rank,
                             on_attempt=clock.on_attempt)
    finally:
        clock.close()
    backoffs = [r["backoff_s"] for r in records(cfg.metrics_jsonl)
                if r["kind"] == "recovery" and r["action"] == "restart"]
    out = {"fenced": res is None, "steps_dispatched": clock.steps,
           "memory_allocated": clock.memory,
           "restarts": clock.restarts(backoffs)}
    if res is not None:
        out.update(final_step=res.final_step,
                   digest=_params_digest(res.state.params))
    return out


def _sim_args(cluster_dir, expand, lr=SUP_LR, *extra) -> list:
    return cnn_args(WORK) + [
        "--learning_rate", str(lr), "--total_steps", str(SIM_STEPS),
        "--output_every", str(SUP_EVERY), "--eval_every", "1000",
        "--checkpoint_every", str(SUP_EVERY), "--supervise", "true",
        "--recovery_backoff_s", str(SUP_BACKOFF), "--cluster_dir",
        cluster_dir, "--cluster_lockstep", "true", "--elastic_expand",
        "true" if expand else "false", "--worker_hosts",
        "localhost:1,localhost:2", *SIM_FLAGS, *extra]


def _sim_proc(label, task, job, life=""):
    rank_dir = os.path.join(OUT, "ranks")
    os.makedirs(rank_dir, exist_ok=True)
    job = dict(job, out=os.path.join(rank_dir, f"{label}.rank{{rank}}.json"))
    job_path = os.path.join(rank_dir, f"{label}{life}.job.json")
    with open(job_path, "w") as f:
        json.dump(job, f)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    log_path = os.path.join(rank_dir, f"{label}.rank{task}{life}.log")
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank", str(task),
             "--job", job_path], cwd=ROOT, env=env, stdout=log,
            stderr=subprocess.STDOUT)
    proc.log_path = log_path
    return proc


def _sim_result(label, task):
    with open(os.path.join(OUT, "ranks", f"{label}.rank{task}.json")) as f:
        return json.load(f)


def _sim_fail(what, procs, msg):
    """Stop ``procs`` (:func:`_sim_proc`'s), print their logs' tails,
    fail."""
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
        with open(p.log_path) as f:
            print(f"[{what}] {os.path.basename(p.log_path)} exit "
                  f"{p.returncode}; log tail:\n{f.read()[-3000:]}",
                  file=sys.stderr)
    fail(f"{what}: {msg}")


def sim_phase(card, extra_jobs=None) -> dict:
    """Phase 38 (b): two processes on this card as lockstep worlds of
    their own, both scenarios in one spawn: ``host_lost`` (the survivor
    shrinks to world 1 from ``ckpt_10`` and ends bit-identical to the
    one-process run restored from it) and ``host_lost`` + ``host_return``
    under ``--elastic_expand`` (process 1 respawned once the shrink is
    committed; the world goes 2 -> 1 -> 2 and both seats end bit-identical
    to the uninterrupted run). ``extra_jobs`` (phase 39's pairs, each with
    its processes' ``want_rc``) ride the same spawn; their results come
    back under ``"extra"`` for their own phase to check."""
    from dml_cnn_cifar10_tpu_torch.ops import optimizer as fused
    from dml_cnn_cifar10_tpu_torch.parallel import cluster as cluster_lib
    from dml_cnn_cifar10_tpu_torch.utils import faults as faults_lib

    jobs = {}
    for label, expand, faults in (
            ("sim_shrink", False, ["", f"host_lost@{SIM_LOST}"]),
            ("sim_expand", True, [f"host_return@{SIM_RETURN}",
                                  f"host_lost@{SIM_LOST}"])):
        cluster_dir = os.path.join(WORK, label, "cluster")
        jobs[label] = {"kind": "supervise", "deterministic": True,
                       "args": _sim_args(cluster_dir, expand),
                       "log_dirs": [os.path.join(WORK, label, f"logs_{t}")
                                    for t in (0, 1)],
                       "faults": faults, "cluster_dir": cluster_dir}
    jobs.update(extra_jobs or {})
    t0 = time.perf_counter()
    procs = {label: [(t, "", _sim_proc(label, t, job)) for t in (0, 1)]
             for label, job in jobs.items()}
    respawned_at = None
    deadline = time.monotonic() + 400
    try:
        while True:
            exp = procs["sim_expand"]
            if len(exp) == 2 and exp[1][2].poll() is not None:
                # Process 1 is gone: respawn it once the survivor has
                # committed the shrink.
                d = cluster_lib.RestartCoordinator(
                    jobs["sim_expand"]["cluster_dir"]).read()
                if d is not None and d.epoch >= 1:
                    exp.append((1, "_respawned", _sim_proc(
                        "sim_expand", 1, dict(jobs["sim_expand"],
                                              faults=["", ""]),
                        life="_respawned")))
                    respawned_at = time.perf_counter() - t0
                    continue
                if exp[0][2].poll() is not None:
                    _sim_fail("sim_expand", [p for _, _, p in exp],
                              "the survivor ended without committing a "
                              "shrink")
            if all(p.poll() is not None
                   for ps in procs.values() for _, _, p in ps):
                break
            if time.monotonic() > deadline:
                _sim_fail("the sims", [p for ps in procs.values()
                                       for _, _, p in ps],
                          "did not finish in 400 s")
            time.sleep(0.1)
    finally:
        for ps in procs.values():
            for _, _, p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    wall_s = time.perf_counter() - t0
    want = {("sim_shrink", 1, ""): faults_lib.EXIT_HOST_LOST,
            ("sim_expand", 1, ""): faults_lib.EXIT_HOST_LOST}
    for label, job in (extra_jobs or {}).items():
        for task, rc in enumerate(job["want_rc"]):
            want[(label, task, "")] = rc
    for label, ps in procs.items():
        for task, life, p in ps:
            rc = want.get((label, task, life), 0)
            if p.returncode != rc:
                _sim_fail(label, [q for _, _, q in ps],
                          f"process {task}{life} exited "
                          f"{p.returncode}, want {rc}")
    shrink = _sim_result("sim_shrink", 0)
    seats = [_sim_result("sim_expand", t) for t in (0, 1)]
    for what, r in [("shrink survivor", shrink),
                    ("expand seat 0", seats[0]), ("expand seat 1", seats[1])]:
        check(not r["fenced"] and r["final_step"] == SIM_STEPS,
              f"{what}: {r}")
        check(r["launches"]["sgd_update_plain"] == r["steps_dispatched"]
              and r["launches"]["sgd_update_momentum"] == 0,
              f"{what}: launches {r['launches']} for "
              f"{r['steps_dispatched']} steps dispatched")
    # The records: JAX's fields (tests/test_torch_cluster_sim.py holds
    # them to the JAX sim's).
    def recs(label, task, kind):
        return [{k: r[k] for k in ("step", "restore_step", "world_size",
                                   "epoch", "attempt", "source", "lost",
                                   "joined") if k in r}
                for r in records(os.path.join(jobs[label]["log_dirs"][task],
                                              "m.jsonl"))
                if r["kind"] == kind]

    shrink_rec = dict(step=SIM_RESTORE, restore_step=SIM_RESTORE,
                      world_size=1, epoch=1, attempt=1, source="disk",
                      lost=[1])
    check(recs("sim_shrink", 0, "elastic_restart") == [shrink_rec],
          f"shrink: {recs('sim_shrink', 0, 'elastic_restart')}")
    check(recs("sim_expand", 0, "elastic_restart") == [shrink_rec]
          and recs("sim_expand", 0, "elastic_expand") == [dict(
              step=SIM_RESTORE, restore_step=SIM_RESTORE, world_size=2,
              epoch=2, attempt=2, source="disk", joined=[1])]
          and recs("sim_expand", 1, "elastic_expand") == [dict(
              step=SIM_RESTORE, restore_step=SIM_RESTORE, world_size=2,
              epoch=2, attempt=1, source="disk", joined=[1])],
          f"expand: {recs('sim_expand', 0, 'elastic_expand')} "
          f"{recs('sim_expand', 1, 'elastic_expand')}")
    for label in ("sim_shrink", "sim_expand"):
        for task in (0, 1):
            _schema_lint(os.path.join(jobs[label]["log_dirs"][task],
                                      "m.jsonl"), f"{label} {task}")
    # The references, in this process: the one-process run restored from
    # the survivor's ckpt_10, and the uninterrupted run.
    base = cnn_args(WORK) + [
        "--learning_rate", str(SUP_LR), "--total_steps", str(SIM_STEPS),
        "--output_every", str(SUP_EVERY), "--eval_every", "1000",
        "--checkpoint_every", str(SUP_EVERY)]
    ref_dir = os.path.join(WORK, "sim_ref_restored")
    os.makedirs(ref_dir)
    src = jobs["sim_shrink"]["log_dirs"][0]
    for n in (f"ckpt_{SIM_RESTORE}.msgpack",
              f"ckpt_{SIM_RESTORE}.msgpack.sha256",
              f"data_state_{SIM_RESTORE}.json"):
        shutil.copy(os.path.join(src, n), ref_dir)
    fused.reset_launches()
    _, restored_tr, restored = run_trainer(base + ["--log_dir", ref_dir])
    _, uninterrupted_tr, uninterrupted = run_trainer(base + [
        "--log_dir", os.path.join(WORK, "sim_ref_uninterrupted")])
    digests = {"restored": _params_digest(restored.state.params),
               "uninterrupted": _params_digest(uninterrupted.state.params)}
    for tr in (restored_tr, uninterrupted_tr):
        tr.close()
    check(shrink["digest"] == digests["restored"],
          "the shrink survivor's parameters differ from the one-process "
          f"run restored from its ckpt_{SIM_RESTORE}")
    check(all(s["digest"] == digests["uninterrupted"] for s in seats),
          "the 2 -> 1 -> 2 run's parameters differ from the uninterrupted "
          "run's")
    out = {"wall_s": wall_s, "respawned_at_s": respawned_at,
           "shrink": shrink, "expand": seats, "digests": digests,
           "extra": {label: [_sim_result(label, t) if rc == 0 else None
                             for t, rc in enumerate(job["want_rc"])]
                     for label, job in (extra_jobs or {}).items()}}
    print(f"[supervise] lockstep sims on this card, one spawn of "
          f"{2 * len(jobs)} rank processes + 1 respawn ({wall_s:.1f} s; "
          f"respawned at "
          f"{respawned_at:.1f} s): host_lost@{SIM_LOST} -> the survivor "
          f"shrank to world 1 from ckpt_{SIM_RESTORE}, bit-identical to the "
          f"one-process run restored from it; host_return@{SIM_RETURN} -> "
          f"2 -> 1 -> 2, both seats bit-identical to the uninterrupted run; "
          f"restarts: shrink {_rounded(shrink['restarts'])}, expand seat 0 "
          f"{_rounded(seats[0]['restarts'])}, seat 1 "
          f"{_rounded(seats[1]['restarts'])}; on {card}", flush=True)
    return out


def _window_step_ms(path) -> float:
    """Mean ms/step of a run's `train` windows after the first (the first
    holds the first dispatch's set-up)."""
    ips = [r["images_per_sec"] for r in records(path)
           if r["kind"] == "train"][1:]
    return sum(128.0 / v * 1e3 for v in ips) / len(ips)


def seam_phase(card) -> dict:
    """Phase 38 (c): the main path's ms/step with ``--cluster_dir`` set
    (lockstep off: a beat file written and the decision file read every
    dispatch, the publisher and watchdog threads beside the loop) against
    without it, eager and chunked at K = 10, in turns A/B/B/A."""
    from dml_cnn_cifar10_tpu_torch.parallel import cluster as cluster_lib
    # The seam's own calls, alone: a beat publish (tmp file, rename) and
    # the decision file's read, then a whole begin_step + end_step.
    mon = cluster_lib.ClusterMonitor(os.path.join(WORK, "seam_calls"), 0, 1)
    try:
        calls = {}
        for name, fn in (
                ("publish", lambda i: mon.store.publish(i, "train")),
                ("decision_read", lambda i: mon.coordinator.read()),
                ("begin_end_step", lambda i: (mon.begin_step(i),
                                              mon.end_step(i + 1)))):
            t0 = time.perf_counter()
            for i in range(500):
                fn(i)
            calls[name] = (time.perf_counter() - t0) / 500 * 1e3
    finally:
        mon.close()
    out = {"calls_ms": calls}
    print(f"[supervise] the seam's calls alone (ms each, 500 calls): "
          f"{ {k: round(v, 4) for k, v in calls.items()} }, on {card}",
          flush=True)
    for mode, k in (("eager", 1), ("chunked", SUP_K)):
        ms = {"off": [], "on": []}
        for i, on in enumerate((False, True, True, False)):
            name = f"seam_{mode}_{i}"
            args = cnn_args(WORK) + [
                "--log_dir", os.path.join(WORK, name), "--total_steps",
                str(SEAM_STEPS), "--output_every", str(SEAM_EVERY),
                "--eval_every", "1000", "--checkpoint_every", "1000",
                "--steps_per_dispatch", str(k), "--metrics_jsonl",
                os.path.join(WORK, f"{name}.jsonl")]
            if on:
                args += ["--cluster_dir", os.path.join(WORK, name, "c")]
            _, tr, _ = run_trainer(args)
            tr.close()
            ms["on" if on else "off"].append(
                _window_step_ms(os.path.join(WORK, f"{name}.jsonl")))
        on, off = (sum(v) / len(v) for v in (ms["on"], ms["off"]))
        out[mode] = {"on_ms_per_step": ms["on"], "off_ms_per_step":
                     ms["off"], "seam_ms_per_step": on - off}
        print(f"[supervise] the cluster seam's cost, {mode}"
              f"{' K = 10' if k > 1 else ''}: {on:.4f} ms/step with "
              f"--cluster_dir against {off:.4f} without "
              f"({on - off:+.4f}; runs {ms}), on {card}", flush=True)
    return out


def supervise_phase(card, dev, bytes_per_s, ops_per_s,
                    extra_jobs=None) -> dict:
    """Phase 38 (see the module docstring); its numbers go to
    ``OUT/slice19.json``. ``extra_jobs`` ride its sims' spawn
    (:func:`sim_phase`)."""
    from dml_cnn_cifar10_tpu_torch.config import DataConfig, ModelConfig
    from dml_cnn_cifar10_tpu_torch.data import ensure_dataset
    from dml_cnn_cifar10_tpu_torch.models.cnn import CNN

    t_phase = time.perf_counter()
    ensure_dataset(DataConfig(dataset="synthetic",
                              data_dir=os.path.join(WORK, "data"),
                              synthetic_train_records=50000))
    shapes = [tuple(p.shape) for p in
              CNN(ModelConfig(logit_relu=False), DataConfig()).parameters()]
    gen = torch.Generator(device=dev).manual_seed(38)

    def make():
        return {f"l{i}": torch.randn(s, device=dev, generator=gen)
                for i, s in enumerate(shapes)}

    res = {"card": card, "kernels": update_kernel_rows(
        dev, card, bytes_per_s, ops_per_s,
        [("sgd_update_plain", 0.0, 0.0, "supervised", make),
         ("sgd_update_momentum", 0.9, 0.0, "supervised", make)],
        lambda tag: "the CNN's 10 leaves (the supervised path's update)")}
    res["kernels_s"] = time.perf_counter() - t_phase
    # (a) one process: eager and chunked K1, then K2 under momentum.
    res["eager"] = _supervised_run("eager", card, ("--fault_spec",
                                                   SUP_FAULTS))
    res["chunked"] = _supervised_run("chunked", card, (
        "--fault_spec", SUP_FAULTS, "--steps_per_dispatch", str(SUP_K)))
    res["momentum"] = _supervised_run("momentum", card, (
        "--fault_spec", SUP_MOM_FAULTS, "--momentum", "0.9"), lr=SUP_MOM_LR)
    res["one_process_s"] = time.perf_counter() - t_phase
    # (b) two processes on this card, lockstep.
    res["sims"] = sim_phase(card, extra_jobs)
    res["sims_s"] = time.perf_counter() - t_phase
    # (c) the seam's cost.
    res["seam"] = seam_phase(card)
    res["phase_s"] = time.perf_counter() - t_phase
    with open(os.path.join(OUT, "slice19.json"), "w") as f:
        json.dump(res, f, indent=1)
    print(f"[supervise] phase 38 took {res['phase_s']:.1f} s (kernels "
          f"{res['kernels_s']:.1f}, one process "
          f"{res['one_process_s'] - res['kernels_s']:.1f}, sims "
          f"{res['sims_s'] - res['one_process_s']:.1f}, seam "
          f"{res['phase_s'] - res['sims_s']:.1f}) on {card}", flush=True)
    return res


def supervise_kernel_entries(sup) -> list:
    """The kernels line's rows of phase 38: K1 and K2 on the CNN's leaves,
    launched by the supervised main path across every attempt."""
    out = []
    for name, kid, line, runs in (
            ("sgd_update_plain", "K1", 83, ("eager", "chunked")),
            ("sgd_update_momentum", "K2", 70, ("momentum",))):
        r = sup["kernels"][name]
        out.append({
            "name": name, "kernel": kid, "path": "supervised",
            "route": "cuda",
            "source": "dml_cnn_cifar10_tpu_torch/csrc/sgd_update.cu",
            "cuda_kernel": "sgd_multi_kernel<true>" if kid == "K2"
            else "sgd_multi_kernel<false>",
            "replaces": f"dml_cnn_cifar10_tpu/ops/optimizer.py:{line}",
            "launches": sup[runs[0]]["launches"][name],
            **({"launches_chunked": sup["chunked"]["launches"][name]}
               if kid == "K1" else {}),
            "max_abs_err": r["max_abs_err"],
            **{k: r[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                 "bound_by", "library_ms",
                                 "library_device_ms")},
            "library": "torch.optim.SGD(fused=True).step",
            "work": f"one update of the CNN's {r['leaves']} leaves "
                    f"({r['elements']} f32 elements, mu={r['mu']}); "
                    f"launches: phase 38's supervised {runs[0]} run across "
                    f"its attempts ({sup[runs[0]]['attempts']}), one a step "
                    f"dispatched ({sup[runs[0]]['steps_dispatched']})"})
    return out


# ---- phase 39: peer replicas, the net transport, the chaos oracle -------
# The replica fault's step on the survivor (after the step-10 push, before
# the host loss), the net drill's dead-peer threshold (the partition heals
# after utils/netfaults.py's 6 s: the majority must have shrunk by then,
# and 3.5 s leaves 2.5 s for that while tolerating a slower start than the
# JAX oracle's 2.5 s), and the seam runs' length.
PEER_CORRUPT, NET_DEAD_S, NET_SEAM_STEPS = 12, "3.5", 200
# The net drill's expand restores from the newest checkpoint when the
# chief's rejoin scan sees process 1: ckpt_10 after the host_return@18
# hold, or ckpt_20 when a loaded host's 0.5 s loopback scan times out and
# the next scan, past the step-20 save, sees it. Either way both seats end
# bit-identical to the uninterrupted run (tests/test_torch_peer_sim.py
# accepts the same pair).
NET_EXPAND_RESTORES = (SIM_RESTORE, 2 * SIM_RESTORE)
PEER_FLAGS = ["--ckpt_format", "sharded", "--peer_redundancy", "true",
              "--replica_keep", "2"]
NET_FLAGS = ["--cluster_transport", "net", "--net_timeout_s", "0.5",
             "--net_retries", "2"]
PEER_RECORD = dict(step=SIM_RESTORE, restore_step=SIM_RESTORE, world_size=1,
                   epoch=1, attempt=1, source="peer", lost=[1])


def peer_jobs() -> dict:
    """Phase 39 (a) and (b)'s lockstep pairs, for phase 38's spawn: the
    CNN recipe under ``--peer_redundancy`` with ``host_lost@15`` on
    process 1, plain SGD (K1), momentum 0.9 at lr 0.02 (K2), and K1 with
    ``replica_corrupt@12`` on the survivor; K1 in chunks of ``SUP_K``
    with ``host_lost@10`` (the seam of step 10, after its push); and the
    2 -> 1 -> 2 drill over ``--cluster_transport net`` with
    ``net_partition@15`` on process 1."""
    from dml_cnn_cifar10_tpu_torch.utils import faults as faults_lib
    lost, dead = f"host_lost@{SIM_LOST}", faults_lib.EXIT_HOST_LOST
    jobs = {}
    for label, lr, extra, faults, want in (
            ("peer_k1", SUP_LR, PEER_FLAGS, ["", lost], [0, dead]),
            ("peer_chunked", SUP_LR, PEER_FLAGS + [
                "--steps_per_dispatch", str(SUP_K)],
             ["", f"host_lost@{SIM_RESTORE}"], [0, dead]),
            ("peer_k2", SUP_MOM_LR, PEER_FLAGS + ["--momentum", "0.9"],
             ["", lost], [0, dead]),
            ("peer_corrupt", SUP_LR, PEER_FLAGS,
             [f"replica_corrupt@{PEER_CORRUPT}", lost], [0, dead]),
            ("net_expand", SUP_LR, NET_FLAGS + ["--peer_dead_after_s",
                                                NET_DEAD_S],
             [f"host_return@{SIM_RETURN}", f"net_partition@{SIM_LOST}"],
             [0, 0])):
        cluster_dir = os.path.join(WORK, label, "cluster")
        jobs[label] = {"kind": "supervise", "deterministic": True,
                       "args": _sim_args(cluster_dir, label == "net_expand",
                                         lr, *extra),
                       "log_dirs": [os.path.join(WORK, label, f"logs_{t}")
                                    for t in (0, 1)],
                       "faults": faults, "cluster_dir": cluster_dir,
                       "want_rc": want}
    return jobs


def _elastic(path, kind) -> list:
    return [{k: r[k] for k in ("step", "restore_step", "world_size", "epoch",
                               "attempt", "source", "lost", "joined")
             if k in r} for r in records(path) if r["kind"] == kind]


def _peer_pair_check(label, result, kernel, ref_digest, card) -> dict:
    """(a)'s gates on one pair's survivor: K1/K2 once a step dispatched,
    bit-identical to the one-process run restored from ``ckpt_10``, a
    ``source="peer"`` decision at step 10, and the restore's reads: from
    the peers only (the state placed from process 1's replica), or
    (``peer_corrupt``) a classified miss, one ``peer_replica``
    ``fallback`` record and the disk walk after it."""
    path = os.path.join(WORK, label, "logs_0", "m.jsonl")
    other = "sgd_update_plain" if kernel == "sgd_update_momentum" \
        else "sgd_update_momentum"
    check(not result["fenced"] and result["final_step"] == SIM_STEPS,
          f"{label}: {result}")
    check(result["launches"][kernel] == result["steps_dispatched"]
          and result["launches"][other] == 0,
          f"{label}: launches {result['launches']} for "
          f"{result['steps_dispatched']} steps dispatched")
    check(result["digest"] == ref_digest, f"{label}: the survivor's "
          f"parameters differ from the one-process run restored from "
          f"ckpt_{SIM_RESTORE}")
    check(_elastic(path, "elastic_restart") == [PEER_RECORD],
          f"{label}: {_elastic(path, 'elastic_restart')}")
    recs = records(path)
    peer = [(r["op"], r["step"], r["owner"], r["ok"]) for r in recs
            if r["kind"] == "peer_replica" and r["op"] != "push"]
    reads = [(r["op"], r["source"]) for r in recs if r["kind"] == "shard_io"
             and r["op"] != "save"]
    if label == "peer_corrupt":
        fallbacks = [r for r in recs if r["kind"] == "peer_replica"
                     and r["op"] == "fallback"]
        check(len(fallbacks) == 1 and "verification" in fallbacks[0]["error"]
              and [r["fault"] for r in recs if r["kind"] == "fault"
                   and r["injected"]] == ["replica_corrupt"]
              and peer[0] == ("decide", SIM_RESTORE, None, True),
              f"{label}: peer records {peer}")
        after = recs[recs.index(fallbacks[0]):]
        check(any(r["kind"] == "shard_io" and r["op"] == "restore"
                  and r["source"] == "disk" for r in after),
              f"{label}: no disk read after the fallback: {reads}")
    else:
        check(peer == [("decide", SIM_RESTORE, None, True),
                       ("verify", SIM_RESTORE, 1, True),
                       ("reconstruct", SIM_RESTORE, 1, True)],
              f"{label}: peer records {peer}")
        check(reads and all(src == "peer" for _, src in reads)
              and not [r for r in recs if r["kind"] == "ckpt_fallback"],
              f"{label}: restore-side shard_io {reads}")
    _schema_lint(path, label)
    pushes = [r for r in recs if r["kind"] == "peer_replica"
              and r["op"] == "push"]
    out = {"restarts": result["restarts"], "reads": reads, "peer": peer,
           "push_secs": [r["secs"] for r in pushes],
           "push_bytes": [r["bytes"] for r in pushes],
           "launches": result["launches"],
           "steps_dispatched": result["steps_dispatched"]}
    print(f"[peer] {label}: decided source=peer at step {SIM_RESTORE}; "
          f"restore reads {reads}; {kernel} launched "
          f"{result['launches'][kernel]} for {result['steps_dispatched']} "
          f"steps dispatched; bit-identical to the one-process run restored "
          f"from ckpt_{SIM_RESTORE}; restarts {_rounded(result['restarts'])};"
          f" pushes {out['push_secs']} s of {out['push_bytes']} bytes, on "
          f"{card}", flush=True)
    return out


def net_seam_phase(card) -> dict:
    """Phase 39 (c): the net transport's cost on the eager CNN. The seam's
    calls alone over each transport (a beat publish, the decision read, a
    whole begin_step + end_step; process 0 of a world of 1, which over
    ``net`` hosts the service and talks to it over loopback), then the
    main path's ms/step with ``--cluster_dir`` over ``net`` against
    ``file``, in turns net/file/file/net."""
    from dml_cnn_cifar10_tpu_torch.parallel import cluster as cluster_lib
    calls = {}
    for transport in ("file", "net"):
        mon = cluster_lib.ClusterMonitor(
            os.path.join(WORK, f"net_seam_calls_{transport}"), 0, 1,
            transport=transport)
        try:
            got = calls[transport] = {}
            for name, fn in (
                    ("publish", lambda i: mon.store.publish(i, "train")),
                    ("decision_read", lambda i: mon.coordinator.read()),
                    ("begin_end_step", lambda i: (mon.begin_step(i),
                                                  mon.end_step(i + 1)))):
                t0 = time.perf_counter()
                for i in range(300):
                    fn(i)
                got[name] = (time.perf_counter() - t0) / 300 * 1e3
        finally:
            mon.close()
    print(f"[net] the seam's calls alone (ms each, 300 calls): "
          f"{ {t: {k: round(v, 4) for k, v in c.items()} for t, c in calls.items()} }"
          f", on {card}", flush=True)
    ms = {"net": [], "file": []}
    for i, transport in enumerate(("net", "file", "file", "net")):
        name = f"net_seam_{i}"
        _, tr, _ = run_trainer(cnn_args(WORK) + [
            "--log_dir", os.path.join(WORK, name), "--total_steps",
            str(NET_SEAM_STEPS), "--output_every", str(SEAM_EVERY),
            "--eval_every", "1000", "--checkpoint_every", "1000",
            "--metrics_jsonl", os.path.join(WORK, f"{name}.jsonl"),
            "--cluster_dir", os.path.join(WORK, name, "c"),
            "--cluster_transport", transport])
        tr.close()
        ms[transport].append(
            _window_step_ms(os.path.join(WORK, f"{name}.jsonl")))
    net, file = (sum(v) / len(v) for v in (ms["net"], ms["file"]))
    print(f"[net] the net seam's cost, eager: {net:.4f} ms/step over net "
          f"against {file:.4f} over file ({net - file:+.4f}; runs {ms}), on "
          f"{card}", flush=True)
    return {"calls_ms": calls, "net_ms_per_step": ms["net"],
            "file_ms_per_step": ms["file"], "net_minus_file_ms": net - file}


def chaos_phase(card) -> dict:
    """Phase 39 (d): the port's chaos oracle with its workers on this
    card: after the fault-free reference, one sampled ``train`` schedule
    (seed 0) and one ``peer_recovery`` schedule (``replica_corrupt@14``
    before the backbone ``host_lost@15``) side by side, every invariant
    held."""
    import concurrent.futures

    from dml_cnn_cifar10_tpu_torch.tools import chaos as chaos_lib
    work = os.path.join(WORK, "chaos")
    t0 = time.perf_counter()
    harness = chaos_lib.ChaosHarness(os.path.join(work, "refs"),
                                     device="cuda")
    harness.reference_digest()
    ref_s = time.perf_counter() - t0
    jobs = {"train": dict(seeds=[0], scenario="train"),
            "peer_recovery": dict(seeds=[0], scenario="peer_recovery",
                                  explicit_spec="replica_corrupt@14")}
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        futures = {name: pool.submit(
            chaos_lib.run_campaign, workdir=os.path.join(work, name),
            metrics_jsonl=os.path.join(OUT, f"chaos_{name}.jsonl"),
            refs=harness._refs, device="cuda", **job)
            for name, job in jobs.items()}
        out = {name: f.result() for name, f in futures.items()}
    for name, summary in out.items():
        check(summary["schedules"] == 1 and summary["failed"] == 0,
              f"chaos {name}: {summary['results']}")
        _schema_lint(os.path.join(OUT, f"chaos_{name}.jsonl"),
                     f"chaos {name}")
    check(out["peer_recovery"]["faults_by_kind"] == {
        "replica_corrupt": 1, "host_lost": 1},
        f"chaos peer_recovery: {out['peer_recovery']['faults_by_kind']}")
    res = {"reference_s": ref_s, "wall_s": time.perf_counter() - t0,
           **{name: {k: v for k, v in summary.items()
                     if k != "reference_digests"}
              for name, summary in out.items()}}
    print(f"[chaos] on this card: reference {ref_s:.1f} s, then "
          + "; ".join(f"{name} \"{s['results'][0]['spec']}\" held every "
                      f"invariant in {s['results'][0]['secs']} s (injected "
                      f"{s['faults_by_kind']})" for name, s in out.items())
          + f"; {res['wall_s']:.1f} s in all, on {card}", flush=True)
    return res


def peer_phase(card, dev, bytes_per_s, ops_per_s, sims) -> dict:
    """Phase 39 (see the module docstring): ``sims`` is phase 38's
    :func:`sim_phase` result, which carried :func:`peer_jobs`; the numbers
    go to ``OUT/slice20.json``."""
    from dml_cnn_cifar10_tpu_torch.config import DataConfig, ModelConfig
    from dml_cnn_cifar10_tpu_torch.models.cnn import CNN
    from dml_cnn_cifar10_tpu_torch.ops import optimizer as fused

    t_phase = time.perf_counter()
    shapes = [tuple(p.shape) for p in
              CNN(ModelConfig(logit_relu=False), DataConfig()).parameters()]
    gen = torch.Generator(device=dev).manual_seed(39)

    def make():
        return {f"l{i}": torch.randn(s, device=dev, generator=gen)
                for i, s in enumerate(shapes)}

    res = {"card": card, "kernels": update_kernel_rows(
        dev, card, bytes_per_s, ops_per_s,
        [("sgd_update_plain", 0.0, 0.0, "peer", make),
         ("sgd_update_momentum", 0.9, 0.0, "peer", make)],
        lambda tag: "the CNN's 10 leaves (the peer-restored path's update)")}
    extra, digests = sims["extra"], dict(sims["digests"])
    # (a) K2's reference: one process restored from the K2 survivor's
    # ckpt_10 (K1's is phase 38's: the same recipe, the same checkpoint).
    src = os.path.join(WORK, "peer_k2", "logs_0")
    ref_dir = os.path.join(WORK, "peer_ref_k2")
    ckpt = f"ckpt_{SIM_RESTORE}.sharded"
    shutil.copytree(os.path.join(src, ckpt), os.path.join(ref_dir, ckpt))
    for n in (f"{ckpt}.sha256", f"data_state_{SIM_RESTORE}.json"):
        shutil.copy(os.path.join(src, n), ref_dir)
    fused.reset_launches()
    _, tr, ref = run_trainer(cnn_args(WORK) + [
        "--learning_rate", str(SUP_MOM_LR), "--momentum", "0.9",
        "--total_steps", str(SIM_STEPS), "--output_every", str(SUP_EVERY),
        "--eval_every", "1000", "--checkpoint_every", str(SUP_EVERY),
        "--ckpt_format", "sharded", "--log_dir", ref_dir])
    digests["restored_k2"] = _params_digest(ref.state.params)
    tr.close()
    # The chunked pair's: one process restored from its survivor's
    # ckpt_10, in chunks of SUP_K.
    src = os.path.join(WORK, "peer_chunked", "logs_0")
    ref_dir = os.path.join(WORK, "peer_ref_chunked")
    shutil.copytree(os.path.join(src, ckpt), os.path.join(ref_dir, ckpt))
    for n in (f"{ckpt}.sha256", f"data_state_{SIM_RESTORE}.json"):
        shutil.copy(os.path.join(src, n), ref_dir)
    _, tr, ref = run_trainer(cnn_args(WORK) + [
        "--learning_rate", str(SUP_LR), "--total_steps", str(SIM_STEPS),
        "--output_every", str(SUP_EVERY), "--eval_every", "1000",
        "--checkpoint_every", str(SUP_EVERY), "--steps_per_dispatch",
        str(SUP_K), "--ckpt_format", "sharded", "--log_dir", ref_dir])
    digests["restored_chunked"] = _params_digest(ref.state.params)
    tr.close()
    res["pairs"] = {
        label: _peer_pair_check(label, extra[label][0], kernel,
                                digests[ref_key], card)
        for label, kernel, ref_key in (
            ("peer_k1", "sgd_update_plain", "restored"),
            ("peer_k2", "sgd_update_momentum", "restored_k2"),
            ("peer_corrupt", "sgd_update_plain", "restored"),
            ("peer_chunked", "sgd_update_plain", "restored_chunked"))}
    disk = sims["shrink"]["restarts"][0]["restore_s"]
    peer = res["pairs"]["peer_k1"]["restarts"][0]["restore_s"]
    res["restore_s"] = {"disk_phase38": disk, "peer": peer, "peer_k2":
                        res["pairs"]["peer_k2"]["restarts"][0]["restore_s"],
                        "peer_chunked": res["pairs"]["peer_chunked"][
                            "restarts"][0]["restore_s"],
                        "peer_miss_then_disk": res["pairs"]["peer_corrupt"][
                            "restarts"][0]["restore_s"]}
    print(f"[peer] restore after the host loss: {res['restore_s']} s "
          f"(phase 38's shrink restores from disk), on {card}", flush=True)
    res["a_s"] = time.perf_counter() - t_phase
    # (b) the 2 -> 1 -> 2 drill over the net transport.
    seats = extra["net_expand"]
    for seat, r in enumerate(seats):
        path = os.path.join(WORK, "net_expand", f"logs_{seat}", "m.jsonl")
        check(not r["fenced"] and r["final_step"] == SIM_STEPS
              and r["digest"] == digests["uninterrupted"],
              f"net_expand seat {seat}: {r}, the parameters must equal the "
              f"uninterrupted run's")
        check(r["launches"]["sgd_update_plain"] == r["steps_dispatched"],
              f"net_expand seat {seat}: launches {r['launches']} for "
              f"{r['steps_dispatched']} steps")
        expand = [(e["restore_step"], e["world_size"], e["epoch"],
                   e["source"], e["joined"])
                  for e in _elastic(path, "elastic_expand")]
        check(len(expand) == 1 and expand[0][0] in NET_EXPAND_RESTORES
              and expand[0][1:] == (2, 2, "disk", [1]),
              f"net_expand seat {seat}: elastic_expand {expand}")
        _schema_lint(path, f"net_expand {seat}")
    recs = records(os.path.join(WORK, "net_expand", "logs_1", "m.jsonl"))
    errors = sorted({r["error"] for r in recs
                     if r["kind"] == "net" and not r["ok"]})
    check([r["fault"] for r in recs if r["kind"] == "fault"
           and r["injected"]] == ["net_partition"] and errors
          and set(errors) <= {"timeout", "unreachable"},
          f"net_expand seat 1: net errors {errors}")
    shrink = _elastic(os.path.join(WORK, "net_expand", "logs_0", "m.jsonl"),
                      "elastic_restart")
    check([(e["world_size"], e["source"], e["lost"]) for e in shrink]
          == [(1, "disk", [1])], f"net_expand seat 0: {shrink}")
    res["net_expand"] = {"seats": seats, "net_errors": errors}
    print(f"[net] net_partition@{SIM_LOST} over --cluster_transport net: "
          f"process 1 cut off ({errors}), process 0 shrank, the partition "
          f"healed, 2 -> 1 -> 2, both seats bit-identical to the "
          f"uninterrupted run; restarts seat 0 "
          f"{_rounded(seats[0]['restarts'])}, seat 1 "
          f"{_rounded(seats[1]['restarts'])}, on {card}", flush=True)
    res["b_s"] = time.perf_counter() - t_phase
    res["seam"] = net_seam_phase(card)
    res["c_s"] = time.perf_counter() - t_phase
    res["chaos"] = chaos_phase(card)
    res["phase_s"] = time.perf_counter() - t_phase
    with open(os.path.join(OUT, "slice20.json"), "w") as f:
        json.dump(res, f, indent=1)
    print(f"[peer] phase 39 took {res['phase_s']:.1f} s after its spawn "
          f"(kernels and (a) {res['a_s']:.1f}, (b) "
          f"{res['b_s'] - res['a_s']:.1f}, seam "
          f"{res['c_s'] - res['b_s']:.1f}, chaos "
          f"{res['phase_s'] - res['c_s']:.1f}) on {card}", flush=True)
    return res


def peer_kernel_entries(peer) -> list:
    """The kernels line's rows of phase 39: K1 and K2 on the CNN's leaves,
    launched by the survivors of the peer-restored pairs across their
    attempts (their states rebuilt from the replicas)."""
    out = []
    for name, kid, line, label in (
            ("sgd_update_plain", "K1", 83, "peer_k1"),
            ("sgd_update_momentum", "K2", 70, "peer_k2")):
        r, pair = peer["kernels"][name], peer["pairs"][label]
        out.append({
            "name": name, "kernel": kid, "path": "peer", "route": "cuda",
            "source": "dml_cnn_cifar10_tpu_torch/csrc/sgd_update.cu",
            "cuda_kernel": "sgd_multi_kernel<true>" if kid == "K2"
            else "sgd_multi_kernel<false>",
            "replaces": f"dml_cnn_cifar10_tpu/ops/optimizer.py:{line}",
            "launches": pair["launches"][name],
            "steps_dispatched": pair["steps_dispatched"],
            **({"launches_chunked": peer["pairs"]["peer_chunked"][
                "launches"][name], "steps_dispatched_chunked": peer[
                    "pairs"]["peer_chunked"]["steps_dispatched"]}
               if kid == "K1" else {}),
            "max_abs_err": r["max_abs_err"],
            **{k: r[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                 "bound_by", "library_ms",
                                 "library_device_ms")},
            "library": "torch.optim.SGD(fused=True).step",
            "work": f"one update of the CNN's {r['leaves']} leaves "
                    f"({r['elements']} f32 elements, mu={r['mu']}); "
                    f"launches: phase 39's {label} survivor across its "
                    f"attempts, its state rebuilt from the peer replicas "
                    f"at step {SIM_RESTORE}, one a step dispatched"
                    + (f" (launches_chunked: the peer_chunked survivor's, "
                       f"chunks of {SUP_K})" if kid == "K1" else "")})
    return out


def only_phase():
    """The phase named by ``--phase N`` (a debugging run of that phase
    alone after the build), or None."""
    if "--phase" in sys.argv:
        return sys.argv[sys.argv.index("--phase") + 1]
    return None


def phase_only_main(card, kind, count, run, name=None) -> int:
    """``--phase N``: run one phase after the build, write its numbers to
    ``OUT/<name>``, print the card and the result line."""
    if os.path.isdir(WORK):
        shutil.rmtree(WORK)
    os.makedirs(OUT, exist_ok=True)
    res = run()
    if name is not None:
        with open(os.path.join(OUT, name), "w") as f:
            json.dump(res, f, indent=1)
    shutil.rmtree(WORK)
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}))
    return 0


def _fresh_model(cfg):
    from dml_cnn_cifar10_tpu_torch.models.registry import get_model
    return get_model(cfg.model.name)(cfg.model, cfg.data)


def dist_main() -> int:
    """``--dist``: phases 31 and 18-21 over NCCL on two or more cards, one
    rank a card, with worlds 2 and (given four cards) 4 — the build, then
    ``chunk_nccl_phase`` and ``dist_phases`` (and, given three cards,
    ``ulysses_phases``); phases 1-17 are skipped. Numbers go to
    ``OUT/dist_nccl.json``; the last line is the same ``{"ok": true, ...}``
    object."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("chip_smoke --dist: needs two or more NVIDIA GPUs",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from dml_cnn_cifar10_tpu_torch.ops import _build

    card, kind = card_line(), torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    bytes_per_s, ops_per_s = next(
        (v for k, v in PEAKS.items() if k in kind), PEAKS["H100"])
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {card}; {count} cards; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}", flush=True)
    if _build.BUILD_DIR.exists():
        shutil.rmtree(_build.BUILD_DIR)
    _build.build()
    if os.path.isdir(WORK):
        shutil.rmtree(WORK)
    os.makedirs(OUT, exist_ok=True)
    worlds = (2, 4) if count >= 4 else (2,)
    if only_phase() == "32":
        return phase_only_main(card, kind, count,
                               lambda: rs_ranks(card, "nccl"),
                               "run_safety_nccl.json")
    if only_phase() == "33":
        return phase_only_main(card, kind, count, lambda: shard_nccl_phase(
            card, dev, worlds, bytes_per_s, ops_per_s))
    if only_phase() == "34":
        return phase_only_main(card, kind, count,
                               lambda: tp_nccl_phase(card, count))
    if only_phase() == "35":
        return phase_only_main(card, kind, count,
                               lambda: resnet_nccl_phase(card, count))
    if only_phase() == "36":
        return phase_only_main(card, kind, count,
                               lambda: moe_nccl_phase(card, count))
    if only_phase() == "37":
        return phase_only_main(card, kind, count,
                               lambda: pp_nccl_phase(card, count))
    # Phase 31 first: a capture that fails ends the run early.
    chunked = chunk_nccl_phase(card, worlds)
    # Phase 33 over NCCL: zero1 and fsdp eager and graphed, and ViT-Ti.
    sharded = shard_nccl_phase(card, dev, worlds, bytes_per_s, ops_per_s)
    # Phase 34 over NCCL: tensor parallelism eager and graphed.
    tensor_parallel = tp_nccl_phase(card, count)
    # Phase 35 over NCCL: cross-replica BN eager and graphed.
    resnet_nccl = resnet_nccl_phase(card, count)
    # Then phase 32's two ranks over NCCL: the flag exchange runs between
    # graph replays.
    safety_nccl = rs_ranks(card, "nccl")
    res = dist_phases("nccl", card, worlds=worlds)
    if count >= ULYSSES_SEQ:
        res["ulysses"] = ulysses_phases(
            "nccl", card, one_rank_jsonl=os.path.join(WORK, "ref2.jsonl"))
    res["chunked"] = chunked
    res["run_safety_nccl"] = safety_nccl
    res["sharded"] = {k: v for k, v in sharded.items() if k != "kernels"}
    res["tensor_parallel"] = tensor_parallel
    res["resnet"] = resnet_nccl
    # Each chunked path beside its per-step run of this call.
    pairs = [(f"DP CNN, {w} ranks", chunked[f"dp{w}"]["loop_ms_per_step"],
              res[f"dp{w}"]["step_ms"]) for w in worlds]
    pairs.append(("ring SP, 2 ranks", chunked["ring"]["step_ms"],
                  res["sp2"]["step_ms"]))
    if "ulysses" in chunked:
        pairs.append((f"Ulysses, {ULYSSES_SEQ} ranks",
                      chunked["ulysses"]["step_ms"],
                      res["ulysses"]["train"]["step_ms"]))
    for name, chunk_ms, step_ms in pairs:
        print(f"[chunk vs step] {name} over NCCL: {chunk_ms:.4f} ms/step "
              f"chunked (one graph a chunk) against {step_ms:.4f} a step "
              f"dispatched alone, in this call, on {card}", flush=True)
    with open(os.path.join(OUT, "dist_nccl.json"), "w") as f:
        json.dump(res, f, indent=1)
    shutil.rmtree(WORK)
    tag = f"nccl{worlds[0]}"
    print(json.dumps({"kernels": shard_kernel_entries(
        sharded["kernels"], {path: sharded[tag]["chunked"][path]["launches"][
            "sgd_update_momentum"] for path in ("zero1", "fsdp")},
        ("zero1", "fsdp"))}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}))
    return 0


RANK_KINDS = {"cli": _rank_cli, "ring": _rank_ring, "ulysses": _rank_ulysses,
              "profile": _rank_profile, "chunk": _rank_chunk,
              "fit": _rank_fit, "shard": _rank_shard, "tp": _rank_tp,
              "parts": _rank_parts, "supervise": _rank_supervise}


def rank_main(argv) -> int:
    """Entry of a rank process (``--rank R --job FILE``): runs the job
    and writes its result, with this process's kernel launch counts."""
    rank, job_path = int(argv[argv.index("--rank") + 1]), \
        argv[argv.index("--job") + 1]
    with open(job_path) as f:
        job = json.load(f)
    sys.path.insert(0, ROOT)
    from dml_cnn_cifar10_tpu_torch.ops import flash_attention as fa
    from dml_cnn_cifar10_tpu_torch.ops import optimizer as fused
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = bool(job.get("deterministic"))
    res = RANK_KINDS[job["kind"]](rank, job)
    # A job that runs more than its main path keeps that path's counts.
    res.setdefault("launches", {**fa.LAUNCHES, **fused.LAUNCHES})
    with open(job["out"].format(rank=rank), "w") as f:
        json.dump(res, f)
    return 0


def main() -> int:
    t_main = time.perf_counter()

    def stamp(phase):
        line = (f"[chip_smoke] phase {phase} starts at "
                f"{time.perf_counter() - t_main:.1f} s")
        print(line, flush=True)
        os.makedirs(OUT, exist_ok=True)
        with open(os.path.join(OUT, "phase_starts.txt"), "a") as f:
            f.write(line + "\n")

    # ---- 1. device -------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from dml_cnn_cifar10_tpu_torch.config import DataConfig, ModelConfig
    from dml_cnn_cifar10_tpu_torch.models.cnn import CNN
    from dml_cnn_cifar10_tpu_torch.ops import _build
    from dml_cnn_cifar10_tpu_torch.ops import optimizer as fused

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    bytes_per_s, ops_per_s = next(
        (v for k, v in PEAKS.items() if k in kind), PEAKS["H100"])
    print(f"card: {card}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}; peaks used for bounds: "
          f"{bytes_per_s / 1e12} TB/s, {ops_per_s / 1e12} f32 TFLOP/s",
          flush=True)
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    stamp("2")
    # ---- 2. build --------------------------------------------------------
    if _build.BUILD_DIR.exists():
        shutil.rmtree(_build.BUILD_DIR)
    t0 = time.perf_counter()
    logs = _build.build()
    build_s = time.perf_counter() - t0
    check(set(logs) == set(_build.sources()), f"built {sorted(logs)}")
    for name, log in logs.items():
        print(f"[build] {name}.cu:\n{log.strip()}")
    print(f"[build] {len(logs)} source(s) in {build_s:.2f} s", flush=True)
    flash_build = ptxas_report(logs["flash_attention"])
    if only_phase() == "36":
        return phase_only_main(card, kind, count, lambda: moe_phase(
            card, dev, bytes_per_s, ops_per_s))
    if only_phase() == "37":
        return phase_only_main(card, kind, count, lambda: pp_phase(
            card, dev, bytes_per_s, ops_per_s))
    if only_phase() == "38":
        return phase_only_main(card, kind, count, lambda: supervise_phase(
            card, dev, bytes_per_s, ops_per_s))
    if only_phase() == "39":
        def run39():
            from dml_cnn_cifar10_tpu_torch.config import DataConfig
            from dml_cnn_cifar10_tpu_torch.data import ensure_dataset
            ensure_dataset(DataConfig(dataset="synthetic",
                                      data_dir=os.path.join(WORK, "data"),
                                      synthetic_train_records=50000))
            return peer_phase(card, dev, bytes_per_s, ops_per_s,
                              sim_phase(card, peer_jobs()))
        return phase_only_main(card, kind, count, run39)
    if only_phase() == "32":
        return phase_only_main(card, kind, count,
                               lambda: run_safety_phase(card))
    if only_phase() == "33":
        return phase_only_main(card, kind, count, lambda: shard_phase(
            card, dev, bytes_per_s, ops_per_s))
    if only_phase() == "34":
        return phase_only_main(card, kind, count, lambda: tp_phase(
            card, dev, bytes_per_s, ops_per_s))
    if only_phase() == "35":
        return phase_only_main(card, kind, count, lambda: resnet_phase(
            card, dev, bytes_per_s, ops_per_s))

    stamp("3")
    # ---- 3. parity -------------------------------------------------------
    model = CNN(ModelConfig(logit_relu=False), DataConfig())
    leaf_shapes = [tuple(p.shape) for p in model.parameters()]
    n_leaves = len(leaf_shapes)
    n_params = sum(math.prod(s) for s in leaf_shapes)
    check(n_leaves == 10 and n_params == 1_068_298,
          f"CNN has {n_leaves} leaves / {n_params} params")
    gen = torch.Generator(device=dev).manual_seed(0)
    lr = torch.tensor(0.02, device=dev)
    worst = {"sgd_update_plain": 0.0, "sgd_update_momentum": 0.0}

    def leaf(shape, offset=0, dtype=torch.float32):
        n = math.prod(shape)
        t = torch.randn(n + offset, device=dev, generator=gen).to(dtype)
        return t[offset:].view(shape)   # offset 1: not 16-byte aligned

    # Every case in one call, as a step gives them: the CNN's leaves, a
    # one-element and an empty leaf, views 4 and 12 bytes past 16-byte
    # alignment, enough small leaves to pass MAX_LEAVES (a second
    # launch), and a bf16 leaf (the plain version).
    specs = ([(s, 0) for s in leaf_shapes]
             + [((1,), 0), ((0,), 0), ((37,), 0), ((130, 7), 0),
                ((130, 7), 1), ((2304, 384), 3)]
             + [((37,), 0)] * (fused.MAX_LEAVES - 6))
    n_f32 = sum(math.prod(shape) > 0 for shape, _ in specs)
    check(n_f32 > fused.MAX_LEAVES, f"{n_f32} leaves fit one launch")
    for mu, wd in CASES:
        params, grads, mom, want = {}, {}, {} if mu else None, {}
        for i, (shape, offset) in enumerate(specs + [((9,), 0)]):
            dtype = torch.float32 if i < len(specs) else torch.bfloat16
            key = f"l{i}" if i < len(specs) else "bf16"
            params[key], grads[key] = (leaf(shape, offset, dtype)
                                       for _ in range(2))
            if mu:
                mom[key] = leaf(shape, offset, dtype)
            want[key] = fused.fused_sgd_update_plain(
                params[key], grads[key], mom[key] if mu else None, lr, mu,
                wd)
        before = dict(fused.LAUNCHES)
        fused.fused_sgd_update(params, grads, mom, lr, mu, wd)
        torch.cuda.synchronize()
        launched = {k: fused.LAUNCHES[k] - before[k] for k in before}
        name = "sgd_update_momentum" if mu else "sgd_update_plain"
        want_launches = dict.fromkeys(before, 0)
        want_launches[name] = math.ceil(n_f32 / fused.MAX_LEAVES)
        check(launched == want_launches,
              f"mu={mu} wd={wd}: launched {launched}, want {want_launches}")
        for key, (want_p, want_m) in want.items():
            got = [params[key]] + ([mom[key]] if mu else [])
            exp = [want_p] + ([want_m] if mu else [])
            if not params[key].numel():
                continue
            diff = max((a.float() - b.float()).abs().max().item()
                       for a, b in zip(got, exp))
            if key != "bf16":
                worst[name] = max(worst[name], diff)
            # Both kernels (and the bf16 leaf's plain version, the same
            # expression) are held bit-equal.
            check(all(torch.equal(a, b) for a, b in zip(got, exp)),
                  f"{name} leaf {key} {tuple(params[key].shape)} mu={mu} "
                  f"wd={wd}: max abs diff {diff}")
    print(f"[parity] max abs diff vs plain: {worst} ({len(specs)} f32 leaves "
          f"and a bf16 one per call, K1 and K2 each in "
          f"{math.ceil(n_f32 / fused.MAX_LEAVES)} launches)", flush=True)
    # On the card the wrapper launches or raises: no quiet fallback.
    for what, bad in (
            ("a non-contiguous leaf", ({"x": leaf((8, 8)).t()},
                                       {"x": leaf((8, 8))}, None, lr)),
            ("an lr on the host", ({"x": leaf((8,))}, {"x": leaf((8,))},
                                   None, lr.cpu()))):
        try:
            fused.fused_sgd_update(*bad, 0.0, 0.0)
        except ValueError:
            continue
        fail(f"fused_sgd_update accepted {what}")

    stamp("4")
    # ---- 4. timing -------------------------------------------------------
    def cnn_leaves():
        return {f"l{i}": torch.randn(s, device=dev, generator=gen)
                for i, s in enumerate(leaf_shapes)}

    timing = {}
    for name, mu, wd, needle in (
            ("sgd_update_plain", 0.0, 0.0, "sgd_multi_kernel<false>"),
            ("sgd_update_momentum", 0.9, 5e-4, "sgd_multi_kernel<true>")):
        params, grads = cnn_leaves(), cnn_leaves()
        mom = cnn_leaves() if mu else None

        def kernel_step():
            fused.fused_sgd_update(params, grads, mom, lr, mu, wd)

        def plain_step():
            for k in params:
                fused.fused_sgd_update_plain(
                    params[k], grads[k], mom[k] if mom else None, lr, mu, wd)

        lib_params = [torch.nn.Parameter(t.clone()) for t in params.values()]
        for lp, g in zip(lib_params, grads.values()):
            lp.grad = g.clone()
        lib = torch.optim.SGD(lib_params, lr=0.02, momentum=mu,
                              weight_decay=wd, fused=True)
        ms = cuda_ms(kernel_step)
        dms = device_ms(kernel_step, needle)
        plain_ms = cuda_ms(plain_step)
        library_ms = cuda_ms(lib.step)
        # fused SGD's device time: every kernel of one lib.step.
        library_dev = kernel_ms(lib.step)
        per_param_bytes, per_param_ops = (20, 4) if mu else (12, 2)
        if wd:
            per_param_ops += 2
        need_bytes = per_param_bytes * n_params + 4      # + the lr scalar
        need_ops = per_param_ops * n_params
        by_bytes = need_bytes / bytes_per_s * 1e3
        by_ops = need_ops / ops_per_s * 1e3
        timing[name] = dict(
            ms=ms, device_ms=dms, plain_ms=plain_ms, library_ms=library_ms,
            library_device_ms=sum(library_dev.values()),
            library_kernels=sorted(library_dev),
            bound_ms=max(by_bytes, by_ops),
            bound_by="bytes" if by_bytes >= by_ops else "operations",
            bytes=need_bytes, mu=mu, wd=wd, cuda_kernel=needle)
        print(f"[timing] {name} (mu={mu}, wd={wd}, {n_leaves} leaves): "
              f"kernel {ms:.5f} ms/step (device {dms} ms), plain "
              f"{plain_ms:.5f} ms, torch.optim.SGD(fused=True) "
              f"{library_ms:.5f} ms (device "
              f"{timing[name]['library_device_ms']:.5f} ms in "
              f"{len(library_dev)} kernel(s): "
              f"{', '.join(k[:60] for k in sorted(library_dev))}), bound "
              f"{timing[name]['bound_ms']:.5f} ms "
              f"({timing[name]['bound_by']}) on {card}", flush=True)

    stamp("5")
    # ---- 5. train: the main path ----------------------------------------
    if os.path.isdir(WORK):
        shutil.rmtree(WORK)
    os.makedirs(OUT, exist_ok=True)
    log_dir = os.path.join(WORK, "logs")
    base = cnn_args(WORK) + ["--output_every", "100",
                             "--checkpoint_every", "250"]
    train_jsonl = os.path.join(WORK, "train.jsonl")
    fused.reset_launches()
    t0 = time.perf_counter()
    lines = run_cli(base + ["--log_dir", log_dir, "--total_steps",
                            str(STEPS), "--eval_every", "250",
                            "--metrics_jsonl", train_jsonl])
    wall_s = time.perf_counter() - t0
    launches = dict(fused.LAUNCHES)
    recs = records(train_jsonl)
    train_recs = [r for r in recs if r["kind"] == "train"]
    check(len(train_recs) == STEPS // 100, f"{len(train_recs)} train records")
    check(all(r["loss"] is not None and math.isfinite(r["loss"])
              for r in train_recs), "non-finite training loss")
    check(launches["sgd_update_plain"] == STEPS,
          f"K1 launched {launches['sgd_update_plain']} times, want one "
          f"for each of {STEPS} steps ({n_leaves} leaves each)")
    check(launches["sgd_update_momentum"] == 0,
          f"K2 launched {launches['sgd_update_momentum']} times in a "
          "momentum-free run")
    accs = [float(m[1]) for m in map(EVAL_LINE.match, lines) if m]
    check(len(accs) == 2 and accs[-1] > 50.0,
          f"test accuracies {accs} (chance is 10%)")
    done = next(r for r in recs if r["kind"] == "done")
    ips = done["images_per_sec"]
    train_k1 = launches["sgd_update_plain"]
    print(f"[train] {STEPS} steps, loss {train_recs[0]['loss']:.4f} -> "
          f"{train_recs[-1]['loss']:.4f}, test accuracy {accs[-1]:.2f}%, "
          f"{ips / 128:.2f} steps/s = {ips:.1f} images/s (after the first "
          f"step; evals and checkpoints included), {wall_s:.1f} s wall "
          f"with data generation, on {card}", flush=True)

    stamp("6")
    # ---- 6. resume -------------------------------------------------------
    fused.reset_launches()
    resume_jsonl = os.path.join(WORK, "resume.jsonl")
    lines = run_cli(base + ["--log_dir", log_dir, "--total_steps",
                            str(RESUME_STEPS), "--eval_every", "100",
                            "--metrics_jsonl", resume_jsonl])
    steps = [int(m[1]) for m in map(STEP_LINE.match, lines) if m]
    check(steps == [RESUME_STEPS], f"resumed run printed steps {steps}")
    check(fused.LAUNCHES["sgd_update_plain"] == RESUME_STEPS - STEPS,
          f"resume ran {fused.LAUNCHES['sgd_update_plain']} steps, want "
          f"{RESUME_STEPS - STEPS} (from step {STEPS})")
    resumed_acc = [m[1] for m in map(EVAL_LINE.match, lines) if m]
    check(len(resumed_acc) == 1, f"resume evals {resumed_acc}")
    print(f"[resume] continued {STEPS} -> {RESUME_STEPS}", flush=True)

    stamp("7")
    # ---- 7. eval mode ----------------------------------------------------
    lines = run_cli(base + ["--log_dir", log_dir, "--mode", "eval"])
    eval_acc = [m[1] for m in map(EVAL_LINE.match, lines) if m]
    check(eval_acc == resumed_acc,
          f"--mode eval printed {eval_acc}, training printed {resumed_acc}")
    check(any(f"eval at step {RESUME_STEPS}" in l for l in lines),
          "eval mode did not restore the last checkpoint")
    print(f"[eval] restored step {RESUME_STEPS}: {eval_acc[0]}% (matches)",
          flush=True)

    stamp("8")
    # ---- 8. momentum -----------------------------------------------------
    fused.reset_launches()
    mom_jsonl = os.path.join(WORK, "momentum.jsonl")
    run_cli(base + ["--log_dir", os.path.join(WORK, "logs_momentum"),
                    "--total_steps", str(MOMENTUM_STEPS), "--output_every",
                    "25", "--eval_every", "50", "--momentum", "0.9",
                    "--weight_decay", "5e-4", "--metrics_jsonl", mom_jsonl])
    momentum_k2 = fused.LAUNCHES["sgd_update_momentum"]
    check(momentum_k2 == MOMENTUM_STEPS,
          f"K2 launched {momentum_k2} times, want one for each of "
          f"{MOMENTUM_STEPS} steps ({n_leaves} leaves each)")
    check(fused.LAUNCHES["sgd_update_plain"] == 0, "K1 ran with momentum")
    check(all(r["loss"] is not None and math.isfinite(r["loss"])
              for r in records(mom_jsonl) if r["kind"] == "train"),
          "non-finite momentum-run loss")
    print(f"[momentum] {MOMENTUM_STEPS} steps, K2 launches {momentum_k2}",
          flush=True)

    stamp("9")
    # ---- 9. where a training step's time goes ---------------------------
    eager_profile = profile_step(
        base + ["--log_dir", os.path.join(WORK, "logs_profile")],
        records(train_jsonl), card)

    stamp("9b")
    # ---- 9b. chunked: resident data, device index stream, CUDA graphs --
    chunk = chunk_phase(base, card, eager_profile)

    stamp("10")
    # ---- 10. flash parity (K3, K4, K6, K7) -------------------------------
    from dml_cnn_cifar10_tpu_torch import convert
    from dml_cnn_cifar10_tpu_torch.ckpt import checkpoint as ckpt
    from dml_cnn_cifar10_tpu_torch.ops import flash_attention as fa
    flash_worst = flash_parity(dev)

    stamp("11")
    # ---- 11. flash timing ------------------------------------------------
    flash_times = flash_timing(dev, card, bytes_per_s, ops_per_s)

    stamp("12")
    # ---- 12. ViT train: the main path ------------------------------------
    n_blocks = 12
    vit_log = os.path.join(WORK, "logs_vit")
    vit_base = ["--model", "vit_tiny", "--dataset", "synthetic",
                "--data_dir", os.path.join(WORK, "data_vit"),
                "--image_size", "72", "--crop_size", "64",
                "--synthetic_train_records", "10000", "--fidelity", "fixed",
                "--batch_size", "128", "--optimizer", "adamw",
                "--learning_rate", "3e-4", "--schedule", "cosine",
                "--warmup_steps", "20", "--eval_every", "100",
                "--checkpoint_every", "100", "--output_every", "50",
                "--peak_tflops", F32_PEAK_TFLOPS]
    vit_jsonl = os.path.join(WORK, "vit_train.jsonl")
    fused.reset_launches()
    fa.reset_launches()
    t0 = time.perf_counter()
    lines = run_cli(vit_base + ["--log_dir", vit_log, "--total_steps",
                                str(VIT_STEPS), "--metrics_jsonl",
                                vit_jsonl])
    wall_s = time.perf_counter() - t0
    vit_launches = dict(fa.LAUNCHES)
    check(sum(fused.LAUNCHES.values()) == 0,
          f"the AdamW ViT path launched K1/K2: {fused.LAUNCHES}")
    recs = records(vit_jsonl)
    train_recs = [r for r in recs if r["kind"] == "train"]
    losses = [r["loss"] for r in train_recs]
    check(len(losses) == VIT_STEPS // 50 and all(
        l is not None and math.isfinite(l) for l in losses),
        f"ViT losses {losses}")
    check(losses[-1] < losses[0], f"ViT loss did not fall: {losses}")
    accs = [float(m[1]) for m in map(EVAL_LINE.match, lines) if m]
    check(len(accs) == 2, f"ViT test accuracies {accs}")
    # Forward-only batches (K3): two full sweeps of the 512-record test
    # split at batch 128, plus the fresh-batch train accuracy at every
    # output boundary.
    fwd_only = 2 * 4 + VIT_STEPS // 50
    want = {"flash_fwd": fwd_only * n_blocks,
            "flash_fwd_lse": VIT_STEPS * n_blocks, "flash_fwd_stats": 0,
            "flash_bwd_dq": VIT_STEPS * n_blocks,
            "flash_bwd_dkv": VIT_STEPS * n_blocks}
    check(vit_launches == want,
          f"ViT main path launched {vit_launches}, want {want}")
    done = next(r for r in recs if r["kind"] == "done")
    ips = done["images_per_sec"]
    win = [r["images_per_sec"] for r in train_recs[1:]]
    win_ips = sum(win) / len(win)
    vit_rate = dict(steps_per_s=ips / 128, images_per_s=ips,
                    tokens_per_s=ips * 257, window_images_per_s=win_ips,
                    window_step_ms=128 / win_ips * 1e3, wall_s=wall_s,
                    losses=losses, test_accuracy=accs)
    print(f"[vit train] {VIT_STEPS} steps, ViT-Ti 257 tokens f32 batch 128 "
          f"AdamW: loss {losses[0]:.4f} -> {losses[-1]:.4f}, test accuracy "
          f"{accs[-1]:.2f}%, {ips / 128:.3f} steps/s = {ips:.1f} images/s "
          f"= {ips * 257:.0f} tokens/s over the run (evals and checkpoints "
          f"included; {win_ips:.1f} images/s = {128 / win_ips * 1e3:.2f} "
          f"ms/step in the windows after step 50), {wall_s:.1f} s wall with "
          f"data generation; launches {vit_launches}, on {card}", flush=True)

    stamp("13")
    # ---- 13. ViT resume + eval mode --------------------------------------
    from dml_cnn_cifar10_tpu_torch.cli.main import (build_parser,
                                                    config_from_args)
    from dml_cnn_cifar10_tpu_torch.train.loop import Trainer
    resume_args = vit_base + ["--log_dir", vit_log, "--total_steps",
                              str(VIT_RESUME_STEPS)]
    trainer = Trainer(config_from_args(build_parser().parse_args(
        resume_args)))
    state = trainer.init_or_restore()
    with open(os.path.join(vit_log, f"ckpt_{VIT_STEPS}.msgpack"), "rb") as f:
        tree = ckpt.from_bytes(f.read())
    check(int(state.step) == VIT_STEPS, f"restored step {int(state.step)}")
    for key in ("mu", "nu"):
        saved = convert.params_from_jax(tree["opt"][key])
        check(all(torch.equal(t.cpu(), saved[n])
                  for n, t in state.opt[key].items())
              and any(bool(t.any()) for t in state.opt[key].values()),
              f"AdamW {key} did not come back from the checkpoint")
    del trainer, state, tree
    fa.reset_launches()
    lines = run_cli(resume_args + ["--metrics_jsonl",
                                   os.path.join(WORK, "vit_resume.jsonl")])
    steps = [int(m[1]) for m in map(STEP_LINE.match, lines) if m]
    check(steps == list(range(VIT_STEPS + 50, VIT_RESUME_STEPS + 1, 50)),
          f"resumed ViT printed steps {steps}")
    check(fa.LAUNCHES["flash_fwd_lse"]
          == (VIT_RESUME_STEPS - VIT_STEPS) * n_blocks,
          f"ViT resume ran {fa.LAUNCHES['flash_fwd_lse'] // n_blocks} steps")
    resumed_acc = [m[1] for m in map(EVAL_LINE.match, lines) if m]
    lines = run_cli(vit_base + ["--log_dir", vit_log, "--mode", "eval"])
    eval_acc = [m[1] for m in map(EVAL_LINE.match, lines) if m]
    check(len(resumed_acc) == 1 and eval_acc == resumed_acc,
          f"ViT --mode eval printed {eval_acc}, training {resumed_acc}")
    check(any(f"eval at step {VIT_RESUME_STEPS}" in l for l in lines),
          "ViT eval mode did not restore the last checkpoint")
    print(f"[vit resume] continued {VIT_STEPS} -> {VIT_RESUME_STEPS} with "
          f"the AdamW moments restored; --mode eval {eval_acc[0]}% matches",
          flush=True)

    stamp("14")
    # ---- 14. long context: 8,100 tokens, bf16, remat ---------------------
    long_base = long_args(WORK) + ["--batch_size", "2"]
    long_jsonl = os.path.join(WORK, "vit_long.jsonl")
    fa.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run_cli(long_base + ["--log_dir", os.path.join(WORK, "logs_long"),
                         "--total_steps", str(LONG_STEPS), "--metrics_jsonl",
                         long_jsonl])
    long_wall = time.perf_counter() - t0
    long_launches = dict(fa.LAUNCHES)
    peak_bytes = torch.cuda.max_memory_allocated()
    want = {"flash_fwd": (LONG_STEPS // 5) * n_blocks,
            "flash_fwd_lse": LONG_STEPS * n_blocks * 2, "flash_fwd_stats": 0,
            "flash_bwd_dq": LONG_STEPS * n_blocks,
            "flash_bwd_dkv": LONG_STEPS * n_blocks}
    check(long_launches == want,
          f"long context launched {long_launches}, want {want}")
    long_recs = records(long_jsonl)
    long_losses = [r["loss"] for r in long_recs if r["kind"] == "train"]
    check(long_losses and all(l is not None and math.isfinite(l)
                              for l in long_losses),
          f"long-context losses {long_losses}")
    # One dense f32 score matrix of this batch (2 x 3 heads x 8100^2)
    # would take 1.57 GB on its own.
    dense_bytes = 2 * 3 * 8100 * 8100 * 4
    check(peak_bytes < dense_bytes,
          f"long context peaked at {peak_bytes} bytes, more than one dense "
          f"score matrix ({dense_bytes})")
    long_ips = [r["images_per_sec"] for r in long_recs
                if r["kind"] == "train"][-1]
    long_rate = dict(step_ms=2 / long_ips * 1e3, tokens_per_s=long_ips * 8100,
                     losses=long_losses, peak_bytes=peak_bytes,
                     wall_s=long_wall)
    print(f"[long context] {LONG_STEPS} steps of 2 x 8,100 tokens, bf16, "
          f"remat: loss {long_losses}, {long_rate['step_ms']:.1f} ms/step = "
          f"{long_rate['tokens_per_s']:.0f} tokens/s (steps 6-10), peak "
          f"device memory {peak_bytes / 2**20:.1f} MiB; launches "
          f"{long_launches}, on {card}", flush=True)

    stamp("15")
    # ---- 15. where a ViT step's time goes --------------------------------
    vit_profile = profile_vit(
        vit_base + ["--log_dir", os.path.join(WORK, "logs_vit_profile")],
        "vit", card, steps=10)
    long_profile = profile_vit(
        long_base + ["--log_dir", os.path.join(WORK, "logs_long_profile")],
        "long", card, steps=2)

    stamp("16")
    # ---- 16. K5 parity, and K6/K7 as the backward ring calls them -------
    stats_worst = stats_parity(dev)
    ring_bwd_worst = ring_bwd_parity(dev)

    stamp("17")
    # ---- 17. K5 timing ---------------------------------------------------
    stats_time = stats_timing(dev, card, bytes_per_s)

    # ---- 18-21. two ranks: ring op, SP train/resume/eval, DP, profile ----
    # One card each over NCCL when there are two, else both on this card
    # over gloo (NCCL refuses two ranks on one device).
    stamp("18")
    backend = "nccl" if count >= 2 else "gloo"
    print(f"[dist] 2 ranks over {backend} on {min(count, 2)} card(s)",
          flush=True)
    dist_res = dist_phases(backend, card, one_rank_jsonl=long_jsonl)
    with open(os.path.join(OUT, "dist.json"), "w") as f:
        json.dump({"stats_parity": stats_worst, "stats_timing": stats_time,
                   "ring_bwd_parity": ring_bwd_worst, **dist_res}, f,
                  indent=1)
    sp_launched = dist_res["sp2"]["launches"]

    # ---- 22-25. serving: export, K3's operator, graphs, HTTP ------------
    stamp("22")
    serve = serve_phases(card, dev, base + ["--log_dir", log_dir],
                         vit_base + ["--log_dir", vit_log], bytes_per_s,
                         ops_per_s)

    # ---- 26-27. Ulysses: the op, then train/resume/eval/profile ----------
    # One card each over NCCL when there are three, else all on this card
    # over gloo.
    stamp("26")
    ul_backend = "nccl" if count >= ULYSSES_SEQ else "gloo"
    print(f"[dist] {ULYSSES_SEQ} ranks over {ul_backend} on "
          f"{min(count, ULYSSES_SEQ)} card(s)", flush=True)
    uly = ulysses_phases(ul_backend, card, one_rank_jsonl=long_jsonl)

    stamp("28")
    # ---- 28. telemetry: TFLOP/s and MFU of every path; profile windows ---
    telemetry = telemetry_check({
        "cnn eager": (train_jsonl, F32_PEAK_TFLOPS),
        "cnn chunked": (os.path.join(WORK, "chunk_train.jsonl"),
                        F32_PEAK_TFLOPS),
        "vit-ti": (vit_jsonl, F32_PEAK_TFLOPS),
        "long context": (long_jsonl, BF16_PEAK_TFLOPS),
        "sp ring (2 ranks)": (os.path.join(WORK, "vit_sp2.jsonl"),
                              BF16_PEAK_TFLOPS),
        "sp ulysses (3 ranks)": (uly["train"]["jsonl"], BF16_PEAK_TFLOPS)},
        card)
    devtime = devtime_phase(base, card,
                            timing["sgd_update_plain"]["device_ms"],
                            chunk["groups_ms_per_step"]["K1"],
                            eager_profile["device_busy_ms_per_step"])

    stamp("29")
    # ---- 29. the optimizer surface --------------------------------------
    optim = optim_phase(base, card)
    with open(os.path.join(OUT, "slice10.json"), "w") as f:
        json.dump({"card": card, "ulysses": uly, "telemetry": telemetry,
                   "devtime": devtime, "optim": optim}, f, indent=1)

    stamp("30")
    # ---- 30. the DP CNN chunked on 2 ranks over gloo on this card -------
    dp_chunk = chunk_gloo_phase(card)
    with open(os.path.join(OUT, "slice11.json"), "w") as f:
        json.dump({"card": card, "dp_chunk_gloo": dp_chunk}, f, indent=1)

    stamp("32")
    # ---- 32. run safety: telemetry, the numerics guard, preemption ------
    safety = run_safety_phase(card)

    stamp("33")
    # ---- 33. sharded state: zero1 and fsdp on 2 ranks over gloo ---------
    shard = shard_phase(card, dev, bytes_per_s, ops_per_s)

    stamp("34")
    # ---- 34. tensor parallelism over --model_axis, gloo on this card ----
    # (with phase 36's rank runs on the same spawn)
    moe_refs, moe_runs = _moe_rank_runs("gloo", (2,))
    pp_refs, pp_runs = _pp_rank_runs()
    tp = tp_phase(card, dev, bytes_per_s, ops_per_s,
                  extra_runs=moe_runs + pp_runs)

    stamp("35")
    # ---- 35. the ResNet rungs: BatchNorm state, cross-replica BN --------
    rn = resnet_phase(card, dev, bytes_per_s, ops_per_s)

    stamp("36")
    # ---- 36. the MoE rung: vit_moe, its recipe, EP and global routing ---
    extra_ranks = tp.pop("extra_ranks")
    moe_res = moe_phase(card, dev, bytes_per_s, ops_per_s, spawned=(
        moe_refs, moe_runs, extra_ranks))
    stamp("37")
    # ---- 37. pipeline parallelism and the CNN's spatial split ---------
    pp_res = pp_phase(card, dev, bytes_per_s, ops_per_s, spawned=(
        pp_refs, pp_runs, extra_ranks))
    stamp("38")
    # ---- 38. the run supervisor and the cluster layer -----------------
    # (with phase 39's lockstep pairs on its sims' spawn)
    sup = supervise_phase(card, dev, bytes_per_s, ops_per_s,
                          extra_jobs=peer_jobs())
    stamp("39")
    # ---- 39. peer replicas, the net transport, the chaos oracle -------
    peer = peer_phase(card, dev, bytes_per_s, ops_per_s, sup["sims"])

    for path in (train_jsonl, resume_jsonl, mom_jsonl, vit_jsonl,
                 os.path.join(WORK, "vit_resume.jsonl"), long_jsonl):
        shutil.copy(path, OUT)
    with open(os.path.join(OUT, "vit.json"), "w") as f:
        json.dump({"card": card, "main": vit_rate, "long": long_rate,
                   "flash_build": flash_build,
                   "flash_timing": {f"{k}/{l}": v
                                    for (k, l), v in flash_times.items()},
                   "flash_parity": {f"{k}/{d}": v
                                    for (k, d), v in flash_worst.items()},
                   "profiles": {"vit": {k: v for k, v in vit_profile.items()
                                        if k != "kernels"},
                                "long": {k: v for k, v in long_profile.items()
                                         if k != "kernels"}}}, f, indent=1)
    shutil.rmtree(WORK)

    kernels = []
    for name, kid, line, launches in (
            ("sgd_update_plain", "K1", 83, train_k1),
            ("sgd_update_momentum", "K2", 70, momentum_k2)):
        t = timing[name]
        kernels.append({
            **({"launches_dp_per_rank": dist_res["dp2"]["launches"][name]}
               if kid == "K1" else {}),
            "launches_chunked": chunk["k1_launches" if kid == "K1"
                                      else "k2_launches"],
            "name": name, "kernel": kid, "route": "cuda",
            "source": "dml_cnn_cifar10_tpu_torch/csrc/sgd_update.cu",
            "cuda_kernel": t["cuda_kernel"],
            "replaces": f"dml_cnn_cifar10_tpu/ops/optimizer.py:{line}",
            "launches": launches,
            "max_abs_err": worst[name], "max_abs_diff": worst[name],
            "ms": t["ms"], "kernel_ms": t["ms"],
            "device_ms": t["device_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "library_device_ms": t["library_device_ms"],
            "library": "torch.optim.SGD(fused=True).step",
            "work": f"one optimizer step over the CNN's {n_leaves} f32 "
                    f"leaves ({n_params} params), mu={t['mu']}, "
                    f"wd={t['wd']}",
        })
    t = timing["sgd_update_plain"]
    kernels.append({
        "name": "sgd_update_plain", "kernel": "K1", "path": "dp_chunk",
        "route": "cuda",
        "source": "dml_cnn_cifar10_tpu_torch/csrc/sgd_update.cu",
        "cuda_kernel": t["cuda_kernel"],
        "replaces": "dml_cnn_cifar10_tpu/ops/optimizer.py:83",
        "launches": dp_chunk["launches"]["sgd_update_plain"],
        "max_abs_err": worst["sgd_update_plain"],
        **{k: t[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                             "bound_by", "library_ms", "library_device_ms")},
        "library": "torch.optim.SGD(fused=True).step",
        "work": f"one optimizer step over the CNN's {n_leaves} f32 leaves "
                f"({n_params} params) as phase 4 times it; launches: rank "
                f"0 of phase 30's 2-rank chunked DP run (gloo on one card, "
                f"the eager chunk body), {DP_STEPS} steps",
    })
    kernels.append({
        "name": "sgd_update_plain", "kernel": "K1", "path": "run_safety",
        "route": "cuda",
        "source": "dml_cnn_cifar10_tpu_torch/csrc/sgd_update.cu",
        "cuda_kernel": t["cuda_kernel"],
        "replaces": "dml_cnn_cifar10_tpu/ops/optimizer.py:83",
        "launches": safety["telemetry"]["telemetry"]["launches"][
            "sgd_update_plain"],
        "max_abs_err": worst["sgd_update_plain"],
        **{k: t[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                             "bound_by", "library_ms", "library_device_ms")},
        "library": "torch.optim.SGD(fused=True).step",
        "work": f"one optimizer step over the CNN's {n_leaves} f32 leaves "
                f"({n_params} params) as phase 4 times it; launches: phase "
                f"32's chunked run with brightness, contrast, telemetry and "
                f"health on, {RS_STEPS} steps in CUDA graph replays",
    })
    kernels += shard_kernel_entries(
        shard["kernels"], {path: shard["ranks"][0][path]["launches"][
            "sgd_update_plain"] for path in ("zero1", "fsdp")},
        ("zero1", "fsdp"))
    kernels += tp_kernel_entries(tp)
    kernels += resnet_kernel_entries(rn)
    kernels += moe_kernel_entries(moe_res)
    kernels += pp_kernel_entries(pp_res)
    kernels += supervise_kernel_entries(sup)
    kernels += peer_kernel_entries(peer)
    t = stats_time
    kernels.append({
        "name": "flash_fwd_stats", "kernel": "K5", "route": "cuda",
        "source": "dml_cnn_cifar10_tpu_torch/csrc/flash_attention.cu",
        "cuda_kernel": "flash_stats_kernel",
        "cuda_body": "flash_fwd_tc<T, D, kStats> (tensor cores, mma.sync)",
        "replaces": "dml_cnn_cifar10_tpu/ops/flash_attention.py:386",
        "launches": sp_launched["flash_fwd_stats"],
        "max_abs_err": stats_worst["float32"],
        "max_abs_diff": stats_worst["float32"],
        "max_abs_err_bf16": stats_worst["bfloat16"],
        "ms": t["ms"], "kernel_ms": t["ms"], "device_ms": t["device_ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "library_device_ms": t["library_device_ms"],
        "library": t["library"],
        "work": f"one launch at the SP main path's ring block "
                f"{t['shape']} {t['dtype']}; launches: rank 0 of the 2-rank "
                f"8,100-token run; max_abs_err on acc / l",
    })
    for name, kid, line, needle in (
            ("flash_fwd", "K3", 345, "flash_out_kernel"),
            ("flash_fwd_lse", "K4", 360, "flash_lse_kernel"),
            ("flash_bwd_dq", "K6", 688, "flash_dq_kernel"),
            ("flash_bwd_dkv", "K7", 736, "flash_dkv_kernel")):
        t, long_t = flash_times[(name, "vit")], flash_times[(name, "long")]
        kernels.append({
            "launches_sp_per_rank": sp_launched[name],
            **({"max_abs_err_ring_bwd_f32": ring_bwd_worst,
                "ring": {k: stats_time["ring_bwd_ms"][name][k]
                         for k in ("ms", "device_ms", "plain_ms",
                                   "library_ms", "library_device_ms",
                                   "bound_ms", "bound_by")}}
               if kid in ("K6", "K7") else {}),
            "name": name, "kernel": kid, "route": "cuda",
            "source": "dml_cnn_cifar10_tpu_torch/csrc/flash_attention.cu",
            "cuda_kernel": needle,
            "replaces": f"dml_cnn_cifar10_tpu/ops/flash_attention.py:{line}",
            "launches": vit_launches[name],
            "launches_long_context": long_launches[name],
            "launches_vit_moe": moe_res["launches"]["main"][name],
            "max_abs_err": flash_worst[(name, "float32")],
            "max_abs_diff": flash_worst[(name, "float32")],
            "max_abs_err_bf16": flash_worst[(name, "bfloat16")],
            "ms": t["ms"], "kernel_ms": t["ms"], "device_ms": t["device_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "library_device_ms": t["library_device_ms"],
            "library": t["library"],
            "work": f"one launch at the ViT main path's attention "
                    f"{t['shape']} {t['dtype']}",
            "long": {k: long_t[k] for k in ("shape", "dtype", "ms",
                                            "device_ms", "plain_ms",
                                            "library_ms",
                                            "library_device_ms", "bound_ms",
                                            "bound_by")},
        })
    for name, kid, line, needle in (
            ("flash_fwd", "K3", 345, "flash_out_kernel"),
            ("flash_fwd_lse", "K4", 360, "flash_lse_kernel"),
            ("flash_bwd_dq", "K6", 688, "flash_dq_kernel"),
            ("flash_bwd_dkv", "K7", 736, "flash_dkv_kernel")):
        t = flash_times[(name, "ulysses")]
        err = FLASH_CASE_DIFFS["ulysses"][name]
        kernels.append({
            "name": name, "kernel": kid, "path": "ulysses", "route": "cuda",
            "source": "dml_cnn_cifar10_tpu_torch/csrc/flash_attention.cu",
            "cuda_kernel": needle,
            "replaces": f"dml_cnn_cifar10_tpu/ops/flash_attention.py:{line}",
            "launches": uly["train"]["launches"][name],
            "max_abs_err": err, "max_abs_err_bf16": err,
            **{k: t[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                 "bound_by", "bound_tc_ms", "flops",
                                 "library_ms", "library_device_ms",
                                 "library")},
            "kernel_ms": t["ms"],
            "tflops_per_s": t["flops"] / t["ms"] / 1e9,
            "work": f"one launch at a Ulysses rank's shape {t['shape']} "
                    f"{t['dtype']} (the 8,100-token recipe over 3 seq "
                    f"ranks); launches: rank 0 of the 3-rank run, 10 "
                    f"steps (K3: its 2 forward-only batches); max_abs_err "
                    f"against the plain version at that shape",
        })
    t, t128 = serve["k3"]["timed"][1], serve["k3"]["timed"][128]
    kernels.append({
        "name": "flash_fwd", "kernel": "K3", "path": "serve",
        "route": "cuda",
        "source": "dml_cnn_cifar10_tpu_torch/csrc/flash_attention.cu",
        "cuda_kernel": "flash_out_kernel",
        "operator": "dml_torch::flash_attention_out",
        "replaces": "dml_cnn_cifar10_tpu/ops/flash_attention.py:345",
        "launches": serve["vit"]["http"]["launches"]["flash_fwd"],
        "max_abs_err": serve["k3"]["worst"],
        "max_abs_diff": serve["k3"]["worst"],
        **{k: t[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                             "bound_by", "bound_tc_ms", "tc_flops",
                             "library_ms", "library_device_ms",
                             "library")},
        "kernel_ms": t["ms"],
        "work": "one launch through the registered operator at the ViT-Ti "
                "serving shape [1, 257, 3, 64] f32 (views of a fused qkv); "
                "launches: the ViT-Ti --mode serve run over HTTP (12 a "
                "replay); max_abs_err over b = 1, 8, 32, 128",
        "b128": {k: t128[k] for k in ("shape", "ms", "device_ms",
                                      "plain_ms", "library_ms",
                                      "library_device_ms", "bound_ms",
                                      "bound_by", "bound_tc_ms",
                                      "tc_flops")},
    })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    if "--rank" in sys.argv:
        sys.exit(rank_main(sys.argv))
    sys.exit(dist_main() if "--dist" in sys.argv else main())
