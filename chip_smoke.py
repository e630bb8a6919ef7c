#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one CUDA card: ``python3 chip_smoke.py``.

Phases (any failure exits non-zero before the result lines):

1. build  — compile the port's CUDA kernels from ``csrc/`` (one nvcc per
   library, started together, sm_90a) into ``build/kernels/``, and beside
   them the host input pipeline (``csrc/data_pipeline.cpp``, g++) into
   ``build/host/``; print the build seconds, ptxas' resource use and spills (the 1x1 GEMMs' ``_sm90``
   kernels, the three ``flash_bwd_dq_sm90``, the four
   ``bn_apply_dw_kernel_sm90``, the four ``bn_apply_dx_strip_sm90``, the
   four ``bn_apply_dx_panel_sm90`` and the four ``bn_reduce_kernel_sm90``
   instances must not spill), and the dynamic shared memory and resident
   blocks per SM of the bf16 flash kernels at D=64 (the forward under each
   q tile), of the 1x1 GEMMs and of the fused kernels (the card's
   occupancy calculator).
1b. feed_native — the host C++ pipeline at ``imagenet_resnet50``'s training
   geometry (random-resized crop to 224, flip, ImageNet mean/std, 128 a
   batch) over a seeded u8 cache of 1280 images at 256x256 (252 MB, written
   under ``build/chip_smoke_u8/`` by ``scripts/torch_feed_bench.py``'s
   ``write_cache``): batches bitwise the same at 1 thread and at every core,
   one epoch a permutation without replacement, a ``start_ticket`` resume
   equal to the stream's tail, and ``native_device_batches`` onto the card
   through 4 reused pinned staging buffers (10 batches kept) equal to the
   host stream. Prints host ms a batch and images/s at 1, 4 and all cores,
   the device path's rate and the CRC-32C's cost per 110 kB record.
2. kernel — hold the flash-attention forward kernel to its plain PyTorch
   version on the card: bf16 at B in {1, 8} x L in {256, 512, 300} with
   H=12, D=64, plus D=32, D=128, an fp32 case and the BERT training cell
   (B=24, L=512, no padding); masks with padded and fully masked rows
   (exact zeros, lse = -1e30). Every bf16 case is also run and timed under
   both q tiles (64 and 128 rows a block), and 24 ring shapes are checked
   under both: L in {17, 64, 65, 129, 300, 512} at B=1, H=2 (a grid
   smaller than the SM count) and at B=2 (a fully masked row) for D in
   {32, 64, 128}. Tolerances: bf16 o within 1e-2 (P rounds to bf16 per
   64-key tile in the kernel, once in the plain version), fp32 o within
   1e-5, lse within 1e-4. Prints kernel/plain/library (SDPA, a yardstick
   the port never calls) times and the card's bound, one JSON line per
   shape.
3. kernel_bwd — hold the backward kernels (dQ, dK/dV) to the plain backward
   on the card, with and without an lse cotangent: bf16 at B in {1, 8, 24}
   x L in {256, 512, 300}, H=12, D=64, with padded rows and one fully
   masked row (which must give exact zero gradients), the unpadded BERT
   training cell (B=24, L=512), D=32, D=128, an fp32 case, and the 24 ring
   shapes. Tolerances: bf16 within 3e-2
   (the gradients are of order 1; P and dS round to bf16 per tile in both,
   from f32 products summed in another order), fp32 within 1e-4. Prints
   per shape the backward's time (delta pass + both kernels) and each
   kernel's, the plain version's, the backward of SDPA
   with the same mask as a yardstick, and the bound; per kernel at B=24,
   L=512 padded and unpadded and at D=128, with each kernel's device time
   from a replayed CUDA graph.
4. kernel_conv1x1 — the 1x1-conv dgrad kernel (both routes) against its
   plain version at ResNet-50's 12 (M, K, N) shapes at b=128, the N=64
   shape, a ragged M and an fp32 case, timed, and at ``PW_RISK_SHAPES``
   in bf16 and fp32, checked only: bf16 within one bf16 rounding step of
   the plain value (2^-7 |ref| + 1e-3), fp32 within 1e-4. Prints per shape
   the kernel's time per back-to-back call (``kernel_ms``, the method of
   every other phase) and its device time (``kernel_graph_ms``: the calls
   replayed from a CUDA graph, no host time; ``graph_ms`` of
   ``scripts/torch_pw_bench.py``, whose shape tables these phases use),
   the plain version's, the library's (``torch.matmul(g, w.t())``, by both
   methods) and the bound.
5. kernel_wgrad — the 1x1-conv wgrad kernel against its plain version at
   the same 12 shapes, the N=64 shape, ``scripts/torch_pw_bench.py``'s 9
   shapes, a ragged M and an fp32 case, timed, and at the risk shapes and
   (4099, 64, 256), checked only: f32 dW within 1e-5 of its largest |entry|
   (exact products summed over M in another order). Prints the same times
   (library: an f32-out ``torch.mm``) and the number of M ranges.
6. kernel_bn_bwd — the fused conv+BN backward kernels (reduce, apply dx,
   apply dW) against their plain versions at ResNet-50's 12 shapes and
   Inception-v3's 12 (N = 160, 192, 320 and 448 end partway through the
   kernels' column tiles) in bf16, timed with ReLU on, and in fp32, each
   with ReLU on and off, plus a ragged M; at ResNet-50's shapes at 64
   rows, the data-parallel phases' rows a rank (bf16, untimed); and at
   ``BN_RISK_SHAPES`` (from
   ``scripts/torch_pw_bench.py``) in bf16 and fp32, checked only: s1, s2
   within 1e-5 of the terms' magnitudes summed and bitwise equal across
   two runs, the constants' rows 4-5 that the reduce writes bitwise equal
   to the CPU path's ``s / m`` (with the count of elements where the
   card's own ``s / m`` differs from it), dx as the dgrad, dW within 1e-5
   of its largest entry (f32 sums over M in another order) and bitwise
   equal across two runs. With K = N and W the identity, the dx kernels'
   output must equal the plain dz bit for bit (strip and panel kernels).
   Each kernel is also timed as device time from a replayed CUDA graph;
   dx beside the product alone (``torch.matmul(dz, w.t())`` of a dz made
   ahead, the library column) and beside dz made in device memory by the
   plain code followed by ``pw_dgrad_cuda`` (the composite). No single
   PyTorch call computes the reduce or dW, so no library time.
7. pw_bench — ``python3 scripts/torch_pw_bench.py --shapes all --check``,
   the entry point that runs the wgrad kernel: its exit code, its numerics
   lines and its launch counters against the launches it made.
8. serve  — full-width BERT-base (the ``BertConfig()`` defaults: 12 layers,
   hidden 768, 12 heads, FFN 3072, vocab 30522, 512 positions) in bf16
   with seeded random weights: save and restore through ``ckpt``, build
   ``BertInferenceEngine`` (buckets 128/256/512, tiers 1/2/4/8) behind
   ``Client``, serve 24 requests across all three buckets, and check that
   the kernel ran 12 times per forward in buckets 256 and 512, that the
   answers agree with the same params run through plain attention on the
   card, and one HTTP ``/v1/mlm`` round trip; then ``POST /profilez?ms=200``
   while bucket-512 requests keep arriving (serve_profilez): the reply's
   ``trace_dir``/``requested_ms``/``wall_ms`` with ``wall_ms >= 200``, and
   ``flash_fwd`` kernel events in the ``torch.profiler`` trace it wrote.
   Then per-bucket latency.
9. train  — full-width BERT-base pretraining (MLM + NSP) in bf16 over f32
   params at L=512, 24 rows, ``SyntheticMLM`` data, AdamW(1e-4, weight
   decay 0.01 off biases/LayerNorms) + global-norm clip 1.0, dropout 0.1
   from an explicit CUDA generator, through ``make_train_step`` + ``fit``.
   Checks: a finite loss every step; each of flash_fwd, flash_bwd_dq and
   flash_bwd_dkv launched 12 times per step; with dropout off, one step's
   gradients through the kernels agree leaf by leaf with plain attention's:
   relative L2 error within 2e-2 over the whole gradient and for the median
   leaf, and within 0.25 for every leaf (bf16 activations round differently
   on the two paths; the pooler and NSP leaves ride on one bf16 [CLS]
   vector per row and move most), each against a floor of 1e-3 of the
   whole gradient's norm for the key biases, whose exact gradient is zero;
   on one fixed batch at a constant lr the loss falls over 10 steps. Then
   the median ms per step, tokens/s and MFU against 989 TFLOP/s.
10. train_resnet50 — full-width ResNet-50 at 224x224, 128 images, bf16 over
   f32 params, SGD 0.1 with momentum 0.9, synthetic class-template data
   through ``device_batches`` + ``prefetch`` + ``make_train_step`` +
   ``fit``, under each 1x1 backend. Checks: a finite loss every step; the
   launches per step exactly 0 (``conv``), 29 ``pw_dgrad`` + 2
   ``pw_dgrad_n64`` and no ``pw_wgrad`` (``pallas``: dW stays a plain
   product, as in the JAX VJP), 29 of each fused kernel (``fused``); on
   the same params (the ``conv`` run's after its steps), batch and
   batch_stats, ``pallas``' and ``fused``'s gradients against ``conv``'s
   within 5e-2 relative L2 over the whole gradient and the median leaf and
   0.5 for every leaf (against a floor of 1e-3 of the whole norm), and their
   new batch_stats within 1e-2 (bf16 activations, dz and dW round at other
   places on each path, through 53 BatchNorms); under ``fused`` the loss
   on a fixed batch falls over 10 steps. Then ms per step, images/s, MFU
   (3 x the forward's FLOPs per image, counted from the model's layers by
   ``models/flops.py`` at 2 FLOPs a multiply-add, against 989 TFLOP/s) and
   peak memory.
10b. train_fused_native — ``fit`` of ``ResNet50(pw_backend="fused")`` (the
   same recipe, 128 images) on ``native_device_batches`` from the feed
   phase's u8 cache (through ``load_imagefolder``, with the preset's
   augmentation) for 4 steps, the first 2 under ``trace_steps(num_steps=2)``.
   Checks: 29 launches of each fused kernel a step by the counters and, by
   kernel name in the profile, 29 a profiled step; finite losses; on the
   first native batch, the fused gradients and BatchNorm statistics against
   the ``conv`` backend's at train_resnet50's limits, from the seeded init
   (the first step) and from the trained params.
11. train_inception — full-width Inception-v3 at 299x299 with the aux head,
   128 images (``bench.py``'s per-card batch for ResNet-50), bf16 over f32
   params, the ``imagenet_inception_async`` recipe (plain SGD 0.05 at a
   constant rate, K = 4 stale gradients), synthetic class-template data
   through ``device_batches`` + ``prefetch`` + ``make_train_step`` +
   ``fit``, with ``fused=False`` and ``fused=True``. Checks: a finite loss
   every step; exactly 27 launches a step of each fused kernel under
   ``fused=True`` and none under ``fused=False``; on the same params, batch
   and batch_stats with dropout off and no stale ring, the fused gradients
   against the plain ones (ResNet-50's tolerances); on one fixed batch from
   a fresh K = 4 ring (its first 4 steps apply zeros) the loss after 14
   steps below the first step's. Then ms per step, images/s, MFU and peak
   memory.
8b. serve_bert_int8 — the same BERT-base checkpoint restored with
   ``weight_dtype="int8"`` (per-channel packing at restore) behind
   ``Client``: 8 requests of 257-512 tokens in bucket 512, 12 ``flash_fwd``
   launches a forward (counted), finite answers; prints pred_ids agreement
   with the bf16 engine and ms a batch of 8 for both.
12. train_cli — ``python -m distributed_tensorflow_tpu_torch.cli.train
   --config bert_base`` (the preset at its own width: L=128, dense
   attention) for 3 steps with a checkpoint, then ``restore_serving_state``
   on it and one ``run_batch``.
12b. train_cli_lm — ``cli.train --config lm_base`` at the preset's width
   (12 layers, H 768, 12 heads, vocab 30522, L 128, bf16) and global batch
   (256) for 4 steps with a checkpoint: finite losses, ms a step and
   tokens/s; then resumed to step 64 at a constant 3e-4 (the restore
   logged, the loss down by more than 2), the checkpoint served next.
12c. serve_lm — ``CausalLMEngine`` on that checkpoint through
   ``restore_serving_state`` (buckets 64/128, 8 slots, tiers of up to 4,
   32 new tokens), 12 seeded prompts of 5-120 tokens admitted a tier at a
   time and decoded until every budget is spent (lm_base's 128 positions
   cap prompt + budget). Greedy streams against the port's own full
   forward on the card (fp32 engine exactly; bf16: a first divergence only
   within one bf16 ulp of the reference's top-2 gap), streams run to run,
   sampled streams solo versus mid-flight (fp32; bf16 measured), chunked
   prefill (32) versus monolithic (fp32), verify (k = 4) against decode
   (fp32 argmax equal;
   bf16 measured; max |logit difference| printed), prefix insert / gather /
   export / import and slot export / import bit for bit, int8 weights +
   int8 KV teacher-forced top-1 agreement >= 0.95 over >= 30 probes.
   Prints prefill ms per (tier, bucket), decode ms a step at 8 slots (bf16
   and int8), tokens/s, kv_bytes_per_token and packed parameter bytes.
12d. serve_lm_batcher — the same checkpoint and engine geometry behind
   ``Client`` and the continuous batcher. fp32 checks against the direct
   driver of serve_lm (one request's fp32 stream does not depend on its
   batchmates): 24 seeded requests (half sampled) from 8 threads with
   ``max_in_flight=2``; the same plus 4 draftable prompts with
   ``spec_tokens=4`` (drafts must be verified); 12 requests sharing a
   64-token prefix through the prefix cache (hit tokens > 0 on
   ``/statusz``); EDF with preemption (8 priority-2 requests fill the
   slots, a priority-0 request with a 1 ms deadline parks one). Then
   ``cli.serve --config lm_base`` as a server process with 16 concurrent
   ``/v1/generate`` (the server loads while the in-process checks run):
   all 200, ``n_tokens`` equal to each budget, the prom text's ``ttft``,
   ``tokens`` and ``kv_bytes_per_token``. Prints bf16
   tokens/s and ms a decode step on 16 requests under continuous
   (``max_in_flight`` 2 and 1) and flush admission beside the direct
   driver's, TTFT p50/p99, tokens a step with speculation, the prefix hit
   rate and the phase's seconds.
13. train_cli_image — ``cli.train --config imagenet_resnet50 --image-size 64
   --global-batch 16 --steps 3`` with a checkpoint, then a ``Checkpointer``
   restore that brings back the step and every BatchNorm running average.
13b. serve_image — ``cli.serve --config imagenet_resnet50 --image-size 64
   --selftest 16`` on that checkpoint, and one ``POST /v1/classify`` whose
   top-5 equals a plain eval forward of the restored model; ms a batch per
   tier.
14. train_cli_inception — the same for ``--config imagenet_inception_async
   --image-size 75`` (no aux head below 299x299): the restore also brings
   back the K = 4 stale ring, on the card.

14b. train_cli_imagenet_real — ``cli.train --config imagenet_resnet50
   --data-dir <the u8 cache>`` at the preset's width and batch (224x224, 256
   images) for 12 steps with ``--metrics-jsonl``, ``--trace-dir`` and
   ``--profile-dir --profile-steps 3``: the cache read (no fallback), finite
   losses, one JSONL record a step, the span trace's host_wait / dispatch /
   device spans, CUDA kernel events in the profile; again with
   ``--no-native-input`` and with ``--device-pool 8``. Prints each run's
   median step ms and host_wait_ms.
14c. train_cli_bert_corpus — ``cli.train --config bert_base --data-dir`` on a
   seeded corpus of made-up words (20,000 sentences in documents over four
   ``*.txt`` files, plus ``val/val.txt``) at the preset's width (L=128, 256
   rows) for 4 steps and an eval pass: finite losses, the corpus's
   vocabulary logged, eval metrics from the val split.

15. train_cli_dp — ``cli.train --config imagenet_resnet50 --image-size 64
   --global-batch 16 --steps 3`` with the cluster flags
   (``--coordinator-address 127.0.0.1:<free port> --num-processes 1
   --process-id 0``): the log must show an NCCL group of world size 1, and
   a ``Checkpointer`` restores its checkpoint on the card; the same run as
   rank 1 of 2 with nobody at the coordinator (``--init-timeout 5``) must
   exit non-zero. train_dp_world1: ``scripts/torch_dp_train.py`` at world 1
   over NCCL (full-width ResNet-50 ``fused``, 128 rows, 3 steps, 29
   launches of each fused kernel a step) and one real NCCL all-reduce of
   its flat gradient bucket (25.6 M f32), timed.
16. train_dp_resnet50 — ``scripts/torch_dp_train.py`` as two processes on
   the one card over gloo (NCCL refuses two ranks on one device; gloo
   stages CUDA tensors through the host), full-width ResNet-50 ``fused``,
   64 rows each of one fixed global batch of 128, 3 steps through
   ``initialize_runtime`` + ``make_train_step`` + ``fit``. Checks: the
   ranks' params, momentum slots and batch_stats bitwise equal after every
   step (digests); steps 1 and 2 repeated in this process as two 64-row
   ``fused`` shards with gradients and statistics averaged by hand, bit
   for bit the same params, momentum and batch_stats as rank 0's; step 2's
   averaged gradients and statistics (every zero-initialised BN scale has
   moved by then, so every leaf has a gradient) against the same two
   shards through the plain ``conv`` backend, at the train_resnet50
   phase's tolerances; 29 launches of each fused kernel a step per rank;
   the loss falls. Prints ms a step (5 more steps with no digest) and the
   all-reduce's ms. Then K = 4 stale gradients for K + 2 = 6 steps
   (started beside the in-process checks above): lockstep, launches,
   params still for the first K steps (the ring gives zeros), moved by the
   first stored gradient at step K + 1 and again at K + 2, and a loss that
   moves with them.

17. train_resilient_fused — full-width ResNet-50 ``fused`` at 224x224, 128
   images (the train_resnet50 recipe) through ``run_resilient`` with a
   ``Checkpointer`` every 4 steps, under a fault plan (a feeder error that
   costs one restart, a checkpoint-write error the retry absorbs, a slow
   step, a poisoned loss under ``nonfinite="skip"``) and a SIGTERM the
   phase sends itself after step 9: preempted with a durable checkpoint,
   resumed by a fresh model to step 12, bit for bit an uninterrupted
   ``fit`` from the same step-0 checkpoint (losses, params, momentum,
   batch_stats; deterministic cuDNN for this part only), 29 launches of
   each fused kernel in every step, every injected event in the dump.
   Prints ms a step with and without a ``StepTimeline`` on batches on the
   card (``scripts/torch_timeline_cost.py``, two pairs of 5-step runs), one
   checkpoint's write ms and bytes, and the restart's seconds.
18. train_chaos — ``scripts/torch_dp_train.py --chaos``: two ResNet-50
   ``fused`` processes at 64 images sharing no process group; rank 0's
   ``host_drop`` SIGKILLs it (exit -9, its dump names the events), the
   beacons drive ``FleetSupervisor`` to ``re_mesh``, and its last durable
   checkpoint (at most 4 steps lost) resumes under ``run_resilient`` with a
   feeder fault, bit for bit an uninterrupted ``fit`` from it.
19. train_cli_resilient — ``cli.train --config imagenet_resnet50
   --image-size 64`` with ``--resilient --fault-plan --beacon-dir
   --dump-dir``: it completes across the faults; an outside SIGTERM stops
   a bounded run with exit 0 and a durable checkpoint that a second launch
   resumes;
   ``--nonfinite abort`` fails with a dump; ``--resilient --device-pool``
   is refused.
20. serve_lm_faults — serving fault injection on the serve_lm_batcher
   checkpoint: a ``dispatch_error`` fails exactly its step's slots (fp32
   streams of the rest equal the direct driver's), over HTTP through
   ``cli.serve --fault-plan`` (500 for those, 200 with full budgets for the
   rest, the fault in a dump), and ``replica_kill`` ends a server with -9
   and a dump.

21. train_bert_mp — ``scripts/torch_mp_train.py`` as two gloo processes
   on the one card (NCCL refuses two ranks on one device). First
   collectives_gloo_cuda: the port's ``psum``, ``ppermute``,
   ``all_to_all``, ``all_gather`` (values and gradients) and
   ``pmean_tree`` on CUDA tensors between the two ranks, exact; gloo's
   ``all_reduce`` (f32, bf16), ``all_gather`` and ``all_to_all_single``
   tried raw on CUDA tensors, and the ops staged through pinned host
   memory printed (``ppermute``: gloo's ``send`` hands the device pointer
   to its socket, which fails with ``Bad address`` on an H100). Then
   BERT-base's widths at :data:`MP_LAYERS` (2) of its 12 layers (768, 12
   heads, 512 positions), 8 rows x
   L=512, bf16, from the same seeded global parameters and fixed batch,
   under ``{"model": 2}`` (TP), the ``{"seq": 2}`` ring and ``{"seq": 2}``
   Ulysses: step 1 with dropout off against a single-process run made in
   this process meanwhile (loss within 1e-2 relative, grad_norm within
   2e-2: bf16 partial sums meet at other points), the gathered
   parameters after one fp32 SGD step within 1e-5 relative (and within
   1e-3 of the reference's update), then 3 steps with dropout 0.1:
   finite losses, one launch a layer a step a rank of each flash kernel
   under TP and Ulysses and two on the ring (2 blocks a layer, with the lse
   cotangent), ms a step and the collectives' ms a step (each collective
   between two synchronisations; gloo through host memory, not NVLink).
22. train_cli_tp_sp — ``cli.train``'s ``main`` (through
   ``scripts/torch_mp_train.py --cli``: the bert_base recipe at 512
   positions, the group on gloo) as four processes on the one card with
   ``--tensor-parallel 2 --seq-parallel 2 --sp-impl ring``, 8 rows, 3
   steps, its checkpoint the global tree; restored here at TP 1 into
   ``BertInferenceEngine`` (bucket 512) and one ``/v1/mlm`` answered: 12
   ``flash_fwd`` launches.
23. serve_bert_mp — those checkpoints served by ``cli.serve`` over groups
   of two gloo ranks on the one card, a leader and a follower
   (``scripts/torch_mp_train.py --serve``), in fp32 at bucket 512: TP 2,
   EP 2 (8 experts, the stacked encoder sequential on each rank) and PP 2
   (M = 1); each answer held to the one-process engine's, ``flash_fwd``
   launches a request a rank 12 / 12 / 6, ms a request and the leader's
   share in gloo. train_lm_tp (in the CLI group): ``cli.train --config
   lm_base --tensor-parallel 2`` as two gloo ranks, its checkpoint restored
   at TP 1.
24. serve_lm_tp — train_cli_lm's checkpoint served by ``cli.serve --tp 2``
   in fp32 (its ranks start beside serve_bert_mp's and wait): 12 ``/v1/generate`` streams equal to the one-process engine's,
   decode ms a step and the leader's share in gloo.
25. serve_lm_fleet — train_cli_lm's checkpoint in fp32 across a prefill
   and a decode role: in process, a ``DisaggServingPair`` of two
   ``kv_transfer`` engines, 12 requests over ``d2d`` and 12 over the
   serialized ``wire`` (chain blocks, bytes, transfer ms); across
   processes, three ``cli.serve`` replicas started beside
   train_cli_resilient and serve_lm_faults (A launched by the port's
   ``Router``, which owns it from then on): chains POSTed to the decode
   role B (``/v1/kv_transfer``) and
   their requests served there, 8 live streams moved from A to B by
   ``/migratez`` (ms and bytes a stream) and collected by
   ``/v1/stream_wait``, and the chaos drill (A2's first stream buffer
   corrupted, refused on its CRC, retried page-less); every stream equal
   to the colocated or uninterrupted one.
26. serve_lm_router — the last phase, on serve_lm_fleet's replicas (A
   owned, A2 and B adopted) behind the port's ``Router`` and
   ``build_router_server``: 12 ``/v1/generate`` streams, each on its
   rendezvous pick and equal to the colocated one; 4 sharing a 64-token
   head on B with their prefix hits; an empty ``input_ids`` 400 with a
   minted ``rt-`` id; the router's hop in ms (12 one-token requests,
   direct and routed, medians); ``hot_swap`` of A to a new tag with 4 paced
   streams live (the 0.3 s drain deadline migrates them by ``/migratez``,
   the router collects each ``migrated`` answer by ``/v1/stream_wait``,
   every stream equal; the drain, migrate, restart and ready stages
   timed); while A restarts, A2 SIGKILLed under 4 live streams (each
   failed over and equal, A2 ``down`` and never restarted, nothing shed);
   and ``cli.router --adopt B`` as a process: one generate, then SIGTERM,
   exit 0.

Phases run one after another, but for train_cli, train_cli_image,
train_cli_inception, train_cli_bert_corpus, train_cli_dp, train_lm_tp and
train_cli_tp_sp: CLI runs that time nothing the records keep, run at once
on threads of their own (their ``seconds`` are then the group's; 80 GB
holds these seven at once, not the lm_base resume as well: train_lm_tp
is 8 rows), with train_cli_lm after the first six, beside train_cli_tp_sp's
second job; and train_cli_resilient beside serve_lm_faults (two fault
drills of their own processes). The fleet replicas load from the end of
train_chaos's two processes. Before the result lines,
``feed_summary`` gives every phase's seconds and the total, the cores the host pipeline needs to keep up with this run's ResNet-50
``fused`` step, and the CLI's median step ms and host_wait_ms under each
feed. The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``. Needs one card; without CUDA it exits 1.

``python3 chip_smoke.py --cards 4``: the port's distributed paths on four
cards of one host, one process a card, the model's collectives over NCCL
(the serving groups' control channel stays on its gloo group). It raises
unless the host has four cards, prints the link between the cards
(``phase_link``: ``nvidia-smi topo -m`` where the machine lets it run, and
each card's active NVLink links and their rate) and every card's name and
power limit, and runs, each a phase that fails the run:

C1. build, as phase 1.
C2. kernel_cards — the flash forward and both backward kernels at the
   shapes the four-card layouts give them, against their plain versions:
   3 local heads (BERT-base's 12 over TP 4 and Ulysses 4) at 32 rows x L
   = 512 and the ring's 128-key blocks (12 heads), unpadded and padded
   with a fully masked row, with the lse cotangent; times beside the
   plain version, SDPA and the bound. kernel_bn_bwd at ResNet-50's 12
   shapes at 128 rows (a DP rank's), bf16, ReLU on, timed.
C3. train_dp_cards — ``scripts/torch_dp_train.py`` as four NCCL ranks,
   full-width ResNet-50 ``fused`` at 128 images a rank (512 global), SGD
   0.1 momentum 0.9: 3 synchronous steps with the ranks' params, momentum
   and batch_stats bitwise equal after every step, steps 1 and 2 within
   ``DP4_RTOL`` of four 128-row shards averaged by hand here (NCCL sums in
   its own order) while the average with one shard left out is not, 29
   launches of each fused kernel a step on every rank; then K = 4 stale
   for 6 steps. ms a step, images/s, the all-reduce's ms; the link as
   NCCL's own log of the synchronous run found it (train_dp_cards_link:
   its topology search's path type and each channel's transport).
   train_cli_image_cards: ``cli.train --config imagenet_resnet50
   --image-size 64`` under torchrun at four processes on the seeded u8
   cache, every rank logging ``backend=nccl world=4 rank=<i>
   device=cuda:<i>``, its checkpoint restored.
C4. train_bert_mp_cards — phase 21's layouts at width 4 over NCCL, one rank
   a card, full BERT-base (12 layers) at 32 rows x L = 512: TP 4, the ring
   over 4 (its flash inner, ``attn_impl="flash"``), Ulysses 4, EP 4 (8
   experts) under the four dispatches and PP 4 at M = 16, each held to its
   single-process reference (run first, before the ranks: its MoE capacity
   buffers need most of card 0) at ``MP_*_RTOL``, with flash launches a
   step a rank exact (:func:`mp_launches`: 12, the ring 48, PP 48); ms a
   step with the collectives' timer (its share) and 2 steps without.
   train_cli_tp_sp_cards: ``cli.train`` (``bert_base_l512``) under torchrun
   with ``--tensor-parallel 2 --seq-parallel 2``, served at TP 1.
C5. serve_bert_cards — ``cli.serve`` under torchrun as four NCCL processes
   in fp32 at bucket 512: TP 4, EP 4 (8 experts, replicated dispatch) and
   PP 4 (M = 1), each answer held to the one-process engine's at the
   ``SERVE_GROUP_*`` tolerances, ``flash_fwd`` 12 / 12 / 3 a request a
   rank, ms a request with the collectives' timer (and the leader's
   collectives share) and without it.
C6. train_lm_cards (while C5's groups load) and serve_lm_cards —
   ``cli.train --config lm_base --tensor-parallel 4`` under torchrun; its
   checkpoint served by
   ``cli.serve --tp 4`` in fp32, launched with the cluster flags, every
   stream equal to the one-process engine's, decode ms a step with and
   without the collectives' timer; then, in a second such group, a
   follower SIGKILLed under load: the leader must fail (its requests
   refused, or its process ended) within ``DRILL_LIMIT_S``; how it failed,
   and whether and when NCCL's watchdog ended it, are printed.

It ends with ``summary_cards`` (each phase's seconds), the topology, the
cards' names and power limits, a ``kernels`` line whose launches are a
step or a request a rank by layout, and ``{"ok": true, ...}``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import importlib
import importlib.util
import io
import itertools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time
import typing
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor cores
PEAK_FP32_FLOPS = 67e12    # H100 SXM fp32 outside the tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
SEED = 0


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


_EMIT_LOCK = threading.Lock()


def emit(obj: dict) -> None:
    """One JSON line on stdout, whole even when phases run at once."""
    with _EMIT_LOCK:
        sys.stdout.write(json.dumps(obj) + "\n")
        sys.stdout.flush()


def concurrently(*calls) -> list:
    """Run each ``(fn, *args)`` of ``calls`` on a thread of its own, all at
    once; wait for every one, then return their results in order, or
    raise the first failure in that order."""
    import concurrent.futures

    with concurrent.futures.ThreadPoolExecutor(len(calls)) as pool:
        futures = [pool.submit(fn, *args) for fn, *args in calls]
        concurrent.futures.wait(futures)
    return [f.result() for f in futures]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def train_flops_per_token(cfg, seq: int) -> float:
    """Training FLOPs per token of BERT (3x the forward's matmuls), the
    formula of ``scripts/bench_bert.py`` ``train_flops_per_token``."""
    d, ff, vocab = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    per_layer = 8 * d * d + 4 * d * ff + 4 * seq * d
    return 3.0 * (cfg.num_layers * per_layer + 2 * d * d + 2 * d * vocab)


def flash_bound(b, l, h, d, valid_keys, esize, fp32):
    """Least time for this call on an H100 SXM: QK^T and PV over the valid
    keys (4*H*D*L per valid key), and q/k/v/o, the mask and lse moved once."""
    flops = 4.0 * h * d * l * float(sum(valid_keys))
    nbytes = 4.0 * b * l * h * d * esize + b * l + 4.0 * b * h * l
    t_ops = flops / (PEAK_FP32_FLOPS if fp32 else PEAK_BF16_FLOPS)
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def ptxas_entries(log: str) -> dict:
    """ptxas' ``-v`` lines per kernel: ``{entry: {"registers", "spill_stores",
    "spill_loads"}}`` (entry = the mangled name)."""
    out, entry = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1]
            out[entry] = {}
        elif entry and "spill stores" in ln:
            words = ln.replace(",", "").split()
            out[entry]["spill_stores"] = int(words[words.index("spill") - 2])
            out[entry]["spill_loads"] = int(words[words.index("loads") - 3])
        elif entry and "Used" in ln and "registers" in ln:
            words = ln.split()
            out[entry]["registers"] = int(words[words.index("registers,") - 1])
    return out


def phase_build(fm, pc, fcb):
    from concurrent.futures import ThreadPoolExecutor

    from distributed_tensorflow_tpu_torch.data import native
    from distributed_tensorflow_tpu_torch.ops import build as kbuild

    t0 = time.monotonic()
    # The host input pipeline's g++ build beside the kernels' nvcc builds.
    with ThreadPoolExecutor(max_workers=1) as pool:
        host = pool.submit(native.load_library)
        kbuild.load_libraries(kbuild.LIBRARIES)  # one nvcc per library, together
        host.result()
    for op in (fm, pc, fcb):
        op.build()  # bind the built libraries
    seconds = round(time.monotonic() - t0, 3)
    info = kbuild.BUILD_INFO["data_pipeline"]
    check(Path(info["path"]).parent == ROOT / "build" / "host", f"host library at {info['path']}")
    emit({"phase": "build", "library": Path(info["path"]).name,
          "gxx_seconds": round(info["seconds"], 3), "seconds": seconds,
          "warnings": [ln for ln in info["log"].splitlines() if "warning" in ln]})
    for name in kbuild.LIBRARIES:
        info = kbuild.BUILD_INFO[name]
        regs = [ln.strip() for ln in info["log"].splitlines()
                if "registers" in ln or "Compiling entry" in ln or "spill" in ln]
        emit({"phase": "build", "library": Path(info["path"]).name,
              "nvcc_seconds": round(info["seconds"], 3), "seconds": seconds,
              "ptxas": regs})
    # Registers and spills of the kernels whose designs count on none: the
    # 1x1 GEMMs (3 entries), the dQ kernel (3 head dims), the fused dW
    # kernel (ReLU on and off x 128- and 256-row tiles), the dx strip
    # kernel (ReLU x dz up to N = 256 and 512), the dx panel kernel (ReLU x
    # 256 and 512 columns of K) and the reduce (bf16 and fp32 x ReLU).
    ptxas = {}
    for lib, key, count in (("pointwise_conv", "_sm90", 3), ("flash_bwd", "flash_bwd_dq_sm90", 3),
                            ("fused_conv_bn", "bn_apply_dw_kernel_sm90", 4),
                            ("fused_conv_bn", "bn_apply_dx_strip_sm90", 4),
                            ("fused_conv_bn", "bn_apply_dx_panel_sm90", 4),
                            ("fused_conv_bn", "bn_reduce_kernel_sm90", 4)):
        entries = {entry: rec for entry, rec in
                   ptxas_entries(kbuild.BUILD_INFO[lib]["log"]).items() if key in entry}
        check(len(entries) == count
              and all(r.get("spill_stores") == 0 and r.get("spill_loads") == 0
                      for r in entries.values()),
              f"{lib} {key} kernels: ptxas {entries}")
        emit({"phase": "build", f"{key}_ptxas": entries})
        ptxas[key] = entries
    occupancy = {name: {"smem_bytes": smem, "blocks_per_sm": blocks}
                 for name, (smem, blocks) in {**fm.occupancy(), **pc.occupancy(),
                                              **fcb.occupancy()}.items()}
    emit({"phase": "build", "occupancy_bf16": occupancy})
    return occupancy, ptxas


def _masked_inputs(torch, gen, b, l, h, d, dtype, n, pad):
    """``n`` random [B, L, H, D] tensors and a key mask: with ``pad`` each
    batch row keeps a random prefix of at least L/2 keys and the last row
    (when B > 1) none at all; without, every key."""
    xs = [torch.randn(b, l, h, d, device="cuda", dtype=dtype, generator=gen) for _ in range(n)]
    valid = torch.randint(l // 2, l + 1, (b,), generator=gen, device="cuda")
    if not pad:
        valid[:] = l
    elif b > 1:
        valid[-1] = 0  # a fully masked batch row
    mask = torch.arange(l, device="cuda")[None, :] < valid[:, None]
    return xs, valid, mask


# Shapes the forward's tiling and copy ring put at risk, checked but not
# timed: ragged L (17, 65, 129, 300), one K/V tile (64), a grid smaller than
# the SM count (B=1, H=2), every head dim, a fully masked row (B=2), each
# under both q tiles.
RING_SHAPES = ([(1, l, 2, 64) for l in (17, 64, 65, 129, 300, 512)]
               + [(2, l, 2, d) for d in (32, 64, 128) for l in (17, 64, 65, 129, 300, 512)])


def _check_fwd(fm, torch, o, lse, q, k, v, mask, b, l, h, d, dtype, fully_masked):
    ro, rlse = fm.flash_attention_reference(q, k, v, mask)
    torch.cuda.synchronize()
    err = (o.float() - ro.float()).abs().max().item()
    lse_err = (lse - rlse).abs().max().item()
    fp32 = dtype == torch.float32
    check(torch.isfinite(o.float()).all().item(), f"non-finite o at {(b, l, h, d)}")
    check(err <= (1e-5 if fp32 else 1e-2), f"o error {err} at {(b, l, h, d, dtype)}")
    check(lse_err <= 1e-4, f"lse error {lse_err} at {(b, l, h, d, dtype)}")
    if fully_masked:
        check(torch.all(o[-1] == 0).item() and torch.all(lse[-1] == -1e30).item(),
              f"fully masked row must give o = 0 and lse = -1e30 at {(b, l, h, d)}")
    return err, lse_err


def phase_kernel(fm, torch):
    cases = [(b, l, 12, 64, torch.bfloat16) for b in (1, 8) for l in (256, 512, 300)]
    cases += [(2, 384, 24, 32, torch.bfloat16), (2, 512, 6, 128, torch.bfloat16),
              (2, 256, 12, 64, torch.float32), (24, 512, 12, 64, torch.bfloat16)]
    gen = torch.Generator("cuda").manual_seed(SEED)
    rows, max_err = [], 0.0
    for b, l, h, d, dtype in cases:
        (q, k, v), valid, mask = _masked_inputs(torch, gen, b, l, h, d, dtype, 3, b != 24)
        o, lse = fm.flash_fwd_cuda(q, k, v, mask)
        err, lse_err = _check_fwd(fm, torch, o, lse, q, k, v, mask, b, l, h, d, dtype,
                                  1 < b < 24)
        fp32 = dtype == torch.float32
        sdpa_mask = mask[:, None, None, :]
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        kernel_ms = cuda_ms(lambda: fm.flash_fwd_cuda(q, k, v, mask), 20)
        plain_ms = cuda_ms(lambda: fm.flash_attention_reference(q, k, v, mask), 5)
        library_ms = cuda_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=sdpa_mask), 20)
        bound_ms, bound_by = flash_bound(
            b, l, h, d, valid.tolist(), q.element_size(), fp32)
        row = {"phase": "kernel", "B": b, "L": l, "H": h, "D": d,
               "dtype": str(dtype).removeprefix("torch."), "max_abs_err": err,
               "lse_err": lse_err, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by}
        if not fp32:
            # The same call under each q tile the launcher can pick.
            for tile in (64, 128):
                got = fm.flash_fwd_cuda(q, k, v, mask, q_tile=tile)
                _check_fwd(fm, torch, *got, q, k, v, mask, b, l, h, d, dtype, 1 < b < 24)
                row[f"kernel_ms_q{tile}"] = cuda_ms(
                    lambda tile=tile: fm.flash_fwd_cuda(q, k, v, mask, q_tile=tile), 20)
        emit(row)
        rows.append(row)
        max_err = max(max_err, err)
    ring_err = 0.0
    for b, l, h, d in RING_SHAPES:
        (q, k, v), _, mask = _masked_inputs(torch, gen, b, l, h, d, torch.bfloat16, 3, True)
        for tile in (64, 128):
            o, lse = fm.flash_fwd_cuda(q, k, v, mask, q_tile=tile)
            err, _ = _check_fwd(fm, torch, o, lse, q, k, v, mask, b, l, h, d, torch.bfloat16,
                                b > 1)
            ring_err = max(ring_err, err)
    emit({"phase": "kernel", "ring_shapes": len(RING_SHAPES), "q_tiles": [64, 128],
          "max_abs_err": ring_err})
    emit({"phase": "kernel", "source_note_bound": {
        "cell": "B=24, L=512, H=12, D=64, bf16, no padding",
        "gflop": 4 * 24 * 12 * 512**2 * 64 / 1e9,
        "mbytes": 4 * 24 * 512 * 768 * 2 / 1e6,
        "bound_ms": flash_bound(24, 512, 12, 64, [512] * 24, 2, False)[0]}})
    main_row = next(r for r in rows if (r["B"], r["L"], r["dtype"]) == (8, 512, "bfloat16"))
    return main_row, max(max_err, ring_err)


def bwd_bound(b, l, h, d, valid_keys, esize, fp32, products, tensors, stats):
    """Least time on an H100 SXM for ``products`` [L x D] by [D x L]-sized
    matrix products over the valid keys (2*H*D*L flops per valid key each),
    ``tensors`` [B, L, H, D] tensors and ``stats`` f32 [B, H, L] rows moved
    once, and the mask read once."""
    flops = 2.0 * products * h * d * l * float(sum(valid_keys))
    nbytes = tensors * b * l * h * d * esize + stats * 4.0 * b * h * l + b * l
    t_ops = flops / (PEAK_FP32_FLOPS if fp32 else PEAK_BF16_FLOPS)
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def _sdpa_backward_ms(torch, q, k, v, mask, do):
    """Backward of ``scaled_dot_product_attention`` with the same key mask:
    a yardstick the port never calls. ``all``: dq, dk, dv; ``q``: dq only;
    ``kv``: dk and dv."""
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask[:, None, None, :])
    dot = do.transpose(1, 2)
    return {name: cuda_ms(lambda inputs=inputs: torch.autograd.grad(
                out, inputs, dot, retain_graph=True), 10)
            for name, inputs in (("all", (qt, kt, vt)), ("q", (qt,)), ("kv", (kt, vt)))}


def _check_bwd(fm, torch, q, k, v, mask, o, lse, do, dlse, shape, dtype, fully_masked):
    """Both backward kernels against the plain backward, with and without
    the lse cotangent; the worst error of dq and of dk/dv."""
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    err = {"dq": 0.0, "dkv": 0.0}
    for cot in (None, dlse):
        got = fm.flash_bwd_cuda(q, k, v, mask, o, lse, do, cot)
        ref = fm.flash_attention_backward_reference(q, k, v, mask, o, lse, do, cot)
        torch.cuda.synchronize()
        for name, g, r in zip(("dq", "dk", "dv"), got, ref):
            check(torch.isfinite(g.float()).all().item(), f"non-finite {name} at {shape}")
            e = (g.float() - r.float()).abs().max().item()
            check(e <= tol, f"{name} error {e} at {shape, dtype}, dlse={cot is not None}")
            if fully_masked:
                check(torch.all(g[-1] == 0).item(),
                      f"fully masked row must give zero {name} at {shape}")
            key = "dq" if name == "dq" else "dkv"
            err[key] = max(err[key], e)
    return err


def phase_kernel_bwd(fm, pwb, torch):
    bf16 = torch.bfloat16
    # (B, L, H, D, dtype, padded): the padded cases draw random valid prefixes
    # and one fully masked row; (24, 512) unpadded is the BERT training cell.
    cases = [(b, l, 12, 64, bf16, True) for b in (1, 8, 24) for l in (256, 512, 300)]
    cases += [(24, 512, 12, 64, bf16, False)]
    cases += [(2, 384, 24, 32, bf16, True), (2, 512, 6, 128, bf16, True),
              (2, 256, 12, 64, torch.float32, True)]
    gen = torch.Generator("cuda").manual_seed(SEED + 1)
    main_row, max_err = None, {"dq": 0.0, "dkv": 0.0}
    for b, l, h, d, dtype, pad in cases:
        (q, k, v, do), valid, mask = _masked_inputs(torch, gen, b, l, h, d, dtype, 4, pad)
        o, lse = fm.flash_fwd_cuda(q, k, v, mask)
        dlse = torch.randn(lse.shape, device="cuda", generator=gen)
        fp32 = dtype == torch.float32
        err = _check_bwd(fm, torch, q, k, v, mask, o, lse, do, dlse, (b, l, h, d), dtype,
                         pad and b > 1)
        delta = fm.flash_bwd_delta(o, do)
        args = (q, k, v, mask, do, lse, delta)
        esize = q.element_size()
        keys = valid.tolist()
        bound_ms, bound_by = bwd_bound(b, l, h, d, keys, esize, fp32, 5, 8, 1)
        library = _sdpa_backward_ms(torch, q, k, v, mask, do)
        row = {"phase": "kernel_bwd", "B": b, "L": l, "H": h, "D": d,
               "dtype": str(dtype).removeprefix("torch."), "padded": pad,
               "max_abs_err_dq": err["dq"], "max_abs_err_dkv": err["dkv"],
               "kernel_ms": cuda_ms(lambda: fm.flash_bwd_cuda(q, k, v, mask, o, lse, do), 10),
               "dq_ms": cuda_ms(lambda: fm.flash_bwd_dq_cuda(*args), 10),
               "dkv_ms": cuda_ms(lambda: fm.flash_bwd_dkv_cuda(*args), 10),
               "plain_ms": cuda_ms(
                   lambda: fm.flash_attention_backward_reference(q, k, v, mask, o, lse, do), 3),
               "library_ms": library["all"], "bound_ms": bound_ms, "bound_by": bound_by}
        if (b, l, dtype) == (24, 512, bf16) or d == 128:
            # Per kernel, at the training cell, its padded twin and D=128:
            # its own plain version, the SDPA backward of just its outputs
            # (dq alone is in effect SDPA's whole backward, which computes
            # all three in one pass), its device time from a replayed CUDA
            # graph, and its own bound over this run's valid keys.
            row["dq"] = {"plain_ms": cuda_ms(lambda: fm.flash_bwd_dq_reference(*args), 3),
                         "library_ms": library["q"], "library_all_ms": library["all"],
                         "graph_ms": pwb.graph_ms(lambda: fm.flash_bwd_dq_cuda(*args), 10, 2),
                         **dict(zip(("bound_ms", "bound_by"),
                                    bwd_bound(b, l, h, d, keys, esize, fp32, 3, 5, 2)))}
            row["dkv"] = {"plain_ms": cuda_ms(lambda: fm.flash_bwd_dkv_reference(*args), 3),
                          "library_ms": library["kv"],
                          "graph_ms": pwb.graph_ms(lambda: fm.flash_bwd_dkv_cuda(*args), 10, 2),
                          **dict(zip(("bound_ms", "bound_by"),
                                     bwd_bound(b, l, h, d, keys, esize, fp32, 4, 6, 2)))}
            if not pad:
                main_row = row
        emit(row)
        for key in max_err:
            max_err[key] = max(max_err[key], err[key])
    ring_err = {"dq": 0.0, "dkv": 0.0}
    for b, l, h, d in RING_SHAPES:
        (q, k, v, do), _, mask = _masked_inputs(torch, gen, b, l, h, d, bf16, 4, True)
        o, lse = fm.flash_fwd_cuda(q, k, v, mask)
        dlse = torch.randn(lse.shape, device="cuda", generator=gen)
        err = _check_bwd(fm, torch, q, k, v, mask, o, lse, do, dlse, (b, l, h, d), bf16, b > 1)
        for key in ring_err:
            ring_err[key] = max(ring_err[key], err[key])
    emit({"phase": "kernel_bwd", "ring_shapes": len(RING_SHAPES),
          "max_abs_err_dq": ring_err["dq"], "max_abs_err_dkv": ring_err["dkv"]})
    emit({"phase": "kernel_bwd", "source_note_bound": {
        "cell": "B=24, L=512, H=12, D=64, bf16, no padding",
        "dkv_gflop": 8 * 24 * 12 * 512**2 * 64 / 1e9,
        "dkv_bound_ms": bwd_bound(24, 512, 12, 64, [512] * 24, 2, False, 4, 6, 2)[0],
        "dq_bound_ms": bwd_bound(24, 512, 12, 64, [512] * 24, 2, False, 3, 5, 2)[0]}})
    return main_row, {key: max(max_err[key], ring_err[key]) for key in max_err}


def bound(nbytes: float, flops: float, peak_flops: float):
    """Least time on an H100 SXM for ``nbytes`` moved once and ``flops`` at
    ``peak_flops``: (ms, what bounds it)."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def load_script(name: str):
    """``scripts/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_pw_bench():
    """``scripts/torch_pw_bench.py`` as a module: the timers and the shape
    tables that the 1x1 phases share with it."""
    return load_script("torch_pw_bench")


def pw_tables(pwb) -> tuple[dict, dict, list, dict]:
    """The bench's 1x1 shape tables as (M, K, N): ResNet-50 at 224x224, 128
    images, the units a step that take the generic dgrad and the fused
    backward (29 units, 12 shapes), those that take the N = 64 dgrad (2),
    the bench's own 9 shapes, and Inception-v3's fused units at 299x299,
    128 images (27 units, 12 shapes)."""
    r50 = {pwb.mkn(*sh): units for sh, units in pwb.RESNET50.items()}
    n64 = {pwb.mkn(*sh): units for sh, units in pwb.RESNET50_N64.items()}
    inception = {pwb.mkn(*sh): units for sh, units in pwb.INCEPTION_FUSED.items()}
    return (r50, n64, [pwb.mkn(*sh) for group in pwb.SHAPES.values() for sh in group],
            inception)


# Shapes the 1x1 GEMMs' tiling and copy ring put at risk, checked but not
# timed: M below one tile and M not a multiple of 64, K = N = 8, N not a
# multiple of 64 (a chunk partly zero-filled), fewer output tiles than SMs
# (dgrad at (1000, 256, 128); wgrad's dW tiles at (6272, 512, 2048)), and a
# wgrad that takes one M range (6272, 1024, 2048); each in bf16 and fp32.
PW_RISK_SHAPES = [(17, 256, 128), (25091, 256, 128), (17, 8, 8), (4099, 256, 200),
                  (1000, 256, 128), (6272, 512, 2048), (6272, 1024, 2048)]


def _close(got, ref, fp32: bool, torch) -> tuple[float, bool]:
    """Max |got - ref| and whether every element is within tolerance: fp32
    within 1e-4 (the same products summed in another order); bf16 within
    one bf16 rounding step of the plain value (2^-7 |ref|, both round the
    same f32 sum once) plus 1e-3 for sums near a rounding boundary."""
    diff = (got.float() - ref.float()).abs()
    tol = 1e-4 if fp32 else 2.0**-7 * ref.float().abs() + 1e-3
    return diff.max().item(), bool(torch.all(diff <= tol).item())


def phase_kernel_conv1x1(pc, pwb, torch, r50, n64):
    """The 1x1-conv dgrad kernel (both routes) against its plain version at
    the ResNet-50 shapes (``r50``, ``n64``); the risk shapes checked only."""
    gen = torch.Generator("cuda").manual_seed(SEED + 2)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(m, k, n, bf16, "pw_dgrad", True) for m, k, n in r50]
    cases += [(m, k, n, bf16, "pw_dgrad_n64", True) for m, k, n in n64]
    cases += [(25091, 1024, 256, bf16, "pw_dgrad", True),
              (6275, 512, 256, f32, "pw_dgrad", True)]
    cases += [(m, k, n, dt, "pw_dgrad", False) for m, k, n in PW_RISK_SHAPES for dt in (bf16, f32)]
    rows = {}
    for m, k, n, dtype, route, timed in cases:
        g = torch.randn(m, n, device="cuda", dtype=dtype, generator=gen)
        w = (torch.randn(k, n, device="cuda", generator=gen) * n**-0.5).to(dtype)
        fp32 = dtype == torch.float32
        dx = pc.dgrad_cuda(g, w, route)
        ref = pc.dgrad_reference(g, w)
        torch.cuda.synchronize()
        err, ok = _close(dx, ref, fp32, torch)
        check(ok and torch.isfinite(dx.float()).all().item(),
              f"pw dgrad error {err} at {(m, k, n, dtype)}")
        row = {"phase": "kernel_conv1x1", "route": route, "M": m, "K": k, "N": n,
               "dtype": str(dtype).removeprefix("torch."), "max_abs_err": err}
        if timed:
            esize = g.element_size()
            bound_ms, bound_by = bound(esize * (m * n + k * n + m * k), 2.0 * m * k * n,
                                       PEAK_FP32_FLOPS if fp32 else PEAK_BF16_FLOPS)
            row.update({
                "kernel_ms": cuda_ms(lambda: pc.dgrad_cuda(g, w, route), 10),
                "kernel_graph_ms": pwb.graph_ms(lambda: pc.dgrad_cuda(g, w, route), 10, 2),
                "plain_ms": cuda_ms(lambda: pc.dgrad_reference(g, w), 3),
                "library_ms": cuda_ms(lambda: torch.matmul(g, w.t()), 10),
                "library_graph_ms": pwb.graph_ms(lambda: torch.matmul(g, w.t()), 10, 2),
                "bound_ms": bound_ms, "bound_by": bound_by})
            rows[(m, k, n, row["dtype"], route)] = row
        emit(row)
        del g, w, dx, ref
    return rows


def _wgrad_library(torch, x2, g):
    """One PyTorch call computing the wgrad (a yardstick the port never
    calls): an f32-out ``torch.mm`` where this torch's takes ``out_dtype``,
    else the bf16-out ``torch.matmul``; and its label."""
    try:
        torch.mm(x2.t(), g, out_dtype=torch.float32)
    except (TypeError, RuntimeError):  # no out_dtype in this torch, or not for these
        return ((lambda: torch.matmul(x2.t(), g)),
                f"torch.matmul(x2.t(), g) -> {str(x2.dtype).removeprefix('torch.')}")
    return (lambda: torch.mm(x2.t(), g, out_dtype=torch.float32)), "torch.mm(out_dtype=f32)"


def phase_kernel_wgrad(pc, pwb, torch, shapes):
    """The 1x1-conv wgrad kernel against its plain version at ``shapes``
    (M, K, N): f32 dW from exact products (bf16 x bf16 fits f32) summed
    over M in another order, within 1e-5 of the largest |dW|; the risk
    shapes checked only."""
    gen = torch.Generator("cuda").manual_seed(SEED + 4)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(m, k, n, bf16, True) for m, k, n in shapes]
    cases += [(25091, 1024, 256, bf16, True), (6275, 512, 256, f32, True)]
    cases += [(m, k, n, dt, False) for m, k, n in PW_RISK_SHAPES + [(4099, 64, 256)]
              for dt in (bf16, f32)]
    rows = {}
    for m, k, n, dtype, timed in cases:
        x2 = torch.randn(m, k, device="cuda", dtype=dtype, generator=gen)
        g = torch.randn(m, n, device="cuda", dtype=dtype, generator=gen)
        fp32 = dtype == torch.float32
        dw = pc.wgrad_cuda(x2, g)
        ref = pc.wgrad_reference(x2, g)
        torch.cuda.synchronize()
        err = (dw - ref).abs().max().item()
        check(dw.dtype == torch.float32 and torch.isfinite(dw).all().item()
              and err <= 1e-5 * ref.abs().max().item(),
              f"pw wgrad error {err} (max |dW| {ref.abs().max().item()}) at {(m, k, n, dtype)}")
        rows_per_split = pc.wgrad_rows_per_split(
            m, k, n, torch.cuda.get_device_properties(x2.device).multi_processor_count)
        row = {"phase": "kernel_wgrad", "M": m, "K": k, "N": n,
               "dtype": str(dtype).removeprefix("torch."), "max_abs_err": err,
               "splits": -(-m // rows_per_split)}
        if timed:
            es = x2.element_size()
            bound_ms, bound_by = bound(es * (m * k + m * n) + 4 * k * n, 2.0 * m * k * n,
                                       PEAK_FP32_FLOPS if fp32 else PEAK_BF16_FLOPS)
            library, label = _wgrad_library(torch, x2, g)
            row.update({
                "kernel_ms": cuda_ms(lambda: pc.wgrad_cuda(x2, g), 10),
                "kernel_graph_ms": pwb.graph_ms(lambda: pc.wgrad_cuda(x2, g), 10, 2),
                "plain_ms": cuda_ms(lambda: pc.wgrad_reference(x2, g), 3),
                "library_ms": cuda_ms(library, 10), "library": label,
                "library_graph_ms": pwb.graph_ms(library, 10, 2),
                "bound_ms": bound_ms, "bound_by": bound_by})
            rows[(m, k, n, row["dtype"])] = row
        emit(row)
        del x2, g, dw, ref
    return rows


def phase_pw_bench(torch):
    """``scripts/torch_pw_bench.py --shapes all --check``: the entry point
    that runs the wgrad kernel. Fails on a non-zero exit, a numerics line
    out of tolerance, or launch counters that disagree with the launches
    the script made."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, (str(ROOT), env.get("PYTHONPATH"))))
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "torch_pw_bench.py"), "--shapes", "all",
         "--check"], cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    seconds = time.monotonic() - t0
    check(proc.returncode == 0,
          f"torch_pw_bench exited {proc.returncode}:\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    lines = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
    checks = [ln for ln in lines if ln.get("check") == "numerics"]
    timed = [ln for ln in lines if "kernel" in ln]
    check(len(checks) == 9 and all(c["max_abs_err_dw"] <= 1e-5 * c["range_dw"] for c in checks),
          f"pw_bench numerics: {checks}")
    check(len(timed) == 18, f"pw_bench timed {len(timed)} rows, expected 9 shapes x 2 kernels")
    counts = lines[-1]
    check(counts["launches"] == counts["made"] and counts["launches"]["pw_wgrad"] > 0,
          f"pw_bench launches {counts}")
    for row in timed:
        emit({"phase": "pw_bench", **row})
    emit({"phase": "pw_bench", "seconds": seconds, **counts,
          "max_abs_err_dw": max(c["max_abs_err_dw"] for c in checks)})
    return counts["launches"], [r for r in timed if r["kernel"] == "pw_wgrad"]


def phase_kernel_bn_bwd(fcb, pc, pwb, torch, cases, cell: str):
    """The fused conv+BN backward kernels (reduce, apply dx, apply dW)
    against their plain versions; ``cases`` are (M, K, N, dtype, relus,
    timed). The reduce and every dW run twice and must repeat bit for bit;
    the constants the reduce writes must be the CPU path's ``s / m``."""
    gen = torch.Generator("cuda").manual_seed(SEED + 3)
    rows = {}
    for m, k, n, dtype, relus, timed in cases:
        fp32 = dtype == torch.float32
        x = torch.randn(m, k, device="cuda", dtype=dtype, generator=gen)
        w = (torch.randn(k, n, device="cuda", generator=gen) * k**-0.5).to(dtype)
        z = torch.matmul(x, w)
        da = torch.randn(m, n, device="cuda", dtype=dtype, generator=gen)
        zf = z.float()
        mean = zf.mean(0)
        inv = torch.rsqrt(zf.square().mean(0) - mean.square() + 1e-5)
        gamma = torch.rand(n, device="cuda", generator=gen) + 0.5
        beta = torch.randn(n, device="cuda", generator=gen) * 0.5
        errs = {"reduce": 0.0, "dx": 0.0, "dw": 0.0}
        card_division_differs = 0
        for relu in relus:
            c0 = fcb._pack_consts(mean, inv, gamma, beta)
            s1, s2 = fcb.bn_bwd_reduce_cuda(da, z, c0, relu, write_consts=True)
            t1, t2 = fcb.bn_bwd_reduce_cuda(da, z, c0, relu)
            r1, r2 = fcb.bn_bwd_reduce_reference(da, z, c0, relu)
            torch.cuda.synchronize()
            check(torch.equal(s1.view(torch.int32), t1.view(torch.int32))
                  and torch.equal(s2.view(torch.int32), t2.view(torch.int32)),
                  f"bn reduce differs between two runs at {(m, k, n, dtype, relu)}")
            # The constants the apply kernels read: the CPU path's division.
            s1c, s2c = s1.cpu(), s2.cpu()
            check(torch.equal(c0[4].cpu(), s1c / m) and torch.equal(c0[5].cpu(), s2c / m),
                  f"bn reduce constants are not s / m at {(m, k, n, dtype, relu)}")
            card_division_differs += int(((s1 / m).cpu() != s1c / m).sum().item()
                                         + ((s2 / m).cpu() != s2c / m).sum().item())
            # f32 sums of up to 401408 terms in two orders: within 1e-5 of
            # the sum of the terms' magnitudes.
            g, xh = fcb._g_xhat(da, z, c0, relu)
            for got, ref, mag in ((s1, r1, g.abs().sum(0)), (s2, r2, (g * xh).abs().sum(0))):
                e = (got - ref).abs()
                check(torch.all(e <= 1e-5 * mag + 1e-6).item(),
                      f"bn reduce error {e.max().item()} at {(m, k, n, dtype, relu)}")
                errs["reduce"] = max(errs["reduce"], e.max().item())
            del g, xh
            consts = fcb._pack_consts(mean, inv, gamma, beta, r1 / m, r2 / m)
            dx = fcb.bn_bwd_apply_dx_cuda(da, z, w, consts, relu)
            rdx = fcb.bn_bwd_apply_dx_reference(da, z, w, consts, relu)
            err, ok = _close(dx, rdx, fp32, torch)
            check(ok, f"bn apply dx error {err} at {(m, k, n, dtype, relu)}")
            errs["dx"] = max(errs["dx"], err)
            dw = fcb.bn_bwd_apply_dw_cuda(da, z, x, consts, relu)
            rdw = fcb.bn_bwd_apply_dw_reference(da, z, x, consts, relu)
            torch.cuda.synchronize()
            # Exact products (bf16 x bf16 fits f32), f32 sums over M in two
            # orders: within 1e-5 of the largest |dW|.
            e = (dw - rdw).abs().max().item()
            check(e <= 1e-5 * rdw.abs().max().item() + 1e-5,
                  f"bn apply dW error {e} at {(m, k, n, dtype, relu)}")
            again = fcb.bn_bwd_apply_dw_cuda(da, z, x, consts, relu)
            torch.cuda.synchronize()
            check(torch.equal(dw.view(torch.int32), again.view(torch.int32)),
                  f"bn apply dW differs between two runs at {(m, k, n, dtype, relu)}")
            errs["dw"] = max(errs["dw"], e)
        del dx, rdx, dw, rdw, again
        label = {"phase": "kernel_bn_bwd", "cell": cell, "M": m, "K": k, "N": n,
                 "dtype": str(dtype).removeprefix("torch."), "relu": list(relus),
                 "max_abs_err": errs, "card_division_differs": card_division_differs}
        if not timed:
            emit(label)
            del x, w, z, da, zf
            continue
        es = x.element_size()
        peak = PEAK_FP32_FLOPS if fp32 else PEAK_BF16_FLOPS
        c0 = fcb._pack_consts(mean, inv, gamma, beta)
        dz = fcb._dz(da, z, consts, True, dtype)

        def timed_pair(key, fn, plain=None):
            out = {f"{key}_ms": cuda_ms(fn, 10), f"{key}_graph_ms": pwb.graph_ms(fn, 10, 2)}
            if plain is not None:
                out[f"{key}_plain_ms"] = cuda_ms(plain, 3)
            return out

        # Elementwise work (x_hat, mask, products, sums: ~8 f32 operations
        # per element) at the fp32 rate; the products at the tensor rate.
        ew = 8.0 * m * n / PEAK_FP32_FLOPS * peak
        row = {**label,
               **timed_pair("reduce", lambda: fcb.bn_bwd_reduce_cuda(da, z, c0, True),
                            lambda: fcb.bn_bwd_reduce_reference(da, z, c0, True)),
               **timed_pair("dx", lambda: fcb.bn_bwd_apply_dx_cuda(da, z, w, consts, True),
                            lambda: fcb.bn_bwd_apply_dx_reference(da, z, w, consts, True)),
               **timed_pair("dx_library", lambda: torch.matmul(dz, w.t())),
               **timed_pair("dx_composite",
                            lambda: pc.dgrad_cuda(fcb._dz(da, z, consts, True, dtype), w)),
               **timed_pair("dw", lambda: fcb.bn_bwd_apply_dw_cuda(da, z, x, consts, True),
                            lambda: fcb.bn_bwd_apply_dw_reference(da, z, x, consts, True)),
               "library_ms": None}
        for key, nbytes, flops in (
                ("reduce", 2 * m * n * es + 8 * n, ew),
                ("dx", (2 * m * n + k * n + m * k) * es, 2.0 * m * k * n + ew),
                ("dw", (2 * m * n + m * k) * es + 4 * k * n, 2.0 * m * k * n + ew)):
            row[f"{key}_bound_ms"], row[f"{key}_bound_by"] = bound(nbytes, flops, peak)
        emit(row)
        rows[(m, k, n, row["dtype"])] = row
        del x, w, z, da, zf, dz
    return rows


def phase_kernel_bn_dz(fcb, torch):
    """With K = N and W the identity, dx = dz W^T is dz itself, every other
    product an exact zero: the bf16 dx kernels' dz (ReLU mask and rounding
    included) against the plain dz, bit for bit, in the strip kernel (N =
    160, 512) and the panel kernel (N = 1024: two ranges of K; 520: a last
    chunk 8 columns wide), at an M that is no whole number of strips."""
    gen = torch.Generator("cuda").manual_seed(SEED + 5)
    cases = 0
    for m, n in ((1000, 160), (2048, 512), (1000, 1024), (777, 520)):
        z = torch.randn(m, n, device="cuda", dtype=torch.bfloat16, generator=gen)
        da = torch.randn(m, n, device="cuda", dtype=torch.bfloat16, generator=gen)
        zf = z.float()
        mean = zf.mean(0)
        stats = (mean, torch.rsqrt(zf.square().mean(0) - mean.square() + 1e-5),
                 torch.rand(n, device="cuda", generator=gen) + 0.5,
                 torch.randn(n, device="cuda", generator=gen) * 0.5)
        w = torch.eye(n, device="cuda", dtype=torch.bfloat16)
        for relu in (True, False):
            r1, r2 = fcb.bn_bwd_reduce_reference(da, z, fcb._pack_consts(*stats), relu)
            consts = fcb._pack_consts(*stats, r1 / m, r2 / m)
            dx = fcb.bn_bwd_apply_dx_cuda(da, z, w, consts, relu)
            dz = fcb._dz(da, z, consts, relu, torch.bfloat16)
            torch.cuda.synchronize()
            check(torch.equal(dx, dz), f"bn apply dx: dz differs from the plain dz at "
                                       f"{(m, n, relu)} ({int((dx != dz).sum().item())} elements)")
            cases += 1
    emit({"phase": "kernel_bn_dz", "cases": cases, "bitwise_equal": True})


def _grads(model, batch, torch):
    from distributed_tensorflow_tpu_torch.models.bert import make_bert_pretraining_loss

    params = dict(model.named_parameters())
    loss, _ = make_bert_pretraining_loss(model)(params, {}, batch, None)
    return dict(zip(params, torch.autograd.grad(loss, list(params.values()))))


def phase_train(fm, torch):
    from distributed_tensorflow_tpu_torch.cli.train import PRESETS, _make_tx
    from distributed_tensorflow_tpu_torch.data.prefetch import prefetch
    from distributed_tensorflow_tpu_torch.data.text import (
        SyntheticMLM,
        SyntheticMLMConfig,
        mlm_device_batches,
    )
    from distributed_tensorflow_tpu_torch.models.bert import (
        BertConfig,
        BertForPreTraining,
        make_bert_pretraining_loss,
    )
    from distributed_tensorflow_tpu_torch.train import (
        create_train_state,
        fit,
        make_rng,
        make_train_step,
    )

    rows, seq = 24, 512
    cfg = BertConfig(dtype=torch.bfloat16)  # 512 positions, dropout 0.1
    model = BertForPreTraining(cfg, device="cuda",
                               generator=torch.Generator("cuda").manual_seed(SEED))
    data = SyntheticMLM(SyntheticMLMConfig(vocab_size=cfg.vocab_size, seq_len=seq, seed=SEED))
    stream = mlm_device_batches(data, rows, device="cuda", seed=1)

    # (c) Dropout off, the same params and batch: the kernels' gradients
    # against plain attention's, leaf by leaf (relative L2 error).
    batch0 = next(stream)
    grads = {}
    for impl in ("flash", "dense"):
        twin = BertForPreTraining(dataclasses.replace(cfg, dropout_rate=0.0, attn_impl=impl),
                                  device="cuda")
        twin.load_state_dict(model.state_dict())
        grads[impl] = _grads(twin, batch0, torch)
        del twin
    # Relative L2 error per leaf, against a floor of 1e-3 of the whole
    # gradient's norm: the key biases' exact gradient is zero (softmax is
    # invariant to shifting a row's scores), so both paths give noise there.
    total = torch.linalg.vector_norm(
        torch.stack([g.float().norm() for g in grads["dense"].values()])).item()
    diff = torch.linalg.vector_norm(torch.stack(
        [(g - grads["dense"][n]).float().norm() for n, g in grads["flash"].items()])).item()
    rel = {name: ((g - grads["dense"][name]).float().norm().item()
                  / max(grads["dense"][name].float().norm().item(), 1e-3 * total))
           for name, g in grads["flash"].items()}
    worst = sorted(rel, key=rel.get)[-3:]
    median = statistics.median(rel.values())
    del grads
    torch.cuda.empty_cache()
    emit({"phase": "train_grad_check", "leaves": len(rel), "rel_l2_err_total": diff / total,
          "median_rel_l2_err": median, "worst_leaves": {n: rel[n] for n in worst}})
    check(diff / total <= 2e-2 and median <= 2e-2 and rel[worst[-1]] <= 0.25,
          f"kernel gradients differ from plain attention's: total {diff / total}, "
          f"median leaf {median}, worst {worst[-1]} {rel[worst[-1]]}")

    # Host cost of one batch of the feed (numpy generation + copy to the card).
    probe = mlm_device_batches(data, rows, device="cuda", seed=3)
    t0 = time.perf_counter()
    for _ in range(3):
        next(probe)
    torch.cuda.synchronize()
    feed_ms = (time.perf_counter() - t0) * 1e3 / 3

    recipe = dataclasses.replace(PRESETS["bert_base"], lr_schedule="constant", learning_rate=1e-4)
    tx, _ = _make_tx(recipe)
    state = create_train_state(dict(model.named_parameters()), tx)
    step = make_train_step(make_bert_pretraining_loss(model), tx, clip_norm=recipe.clip_norm)
    rng = make_rng(SEED, "cuda")
    batches = prefetch(stream, 2)
    log = []
    hook = lambda s, st, m: log.append(  # noqa: E731
        (time.perf_counter(), m["loss"], m["host_wait_ms"]))
    try:
        # (a), (b) and the per-step time: the main path, synchronised at
        # every step by the loss fetch (log_every=1).
        n_steps = 12
        fm.reset_launch_counts()
        state, _ = fit(state, step, batches, num_steps=n_steps, rng=rng, log_every=1,
                       hooks=(hook,))
        torch.cuda.synchronize()
        launches = dict(fm.LAUNCHES)
        losses = [entry[1] for entry in log]
        host_wait_ms = statistics.median(entry[2] for entry in log[1:])
        check(len(losses) == n_steps and all(np.isfinite(losses)), f"losses {losses}")
        for name, n in launches.items():
            check(n == 12 * n_steps, f"{name}: {n} launches in {n_steps} steps, expected 12 per step")
        step_ms = [(b[0] - a[0]) * 1e3 for a, b in zip(log[1:], log[2:])]
        # A window with no per-step sync: fit's steady-state rate.
        window = 10
        state, last = fit(state, step, batches, num_steps=state.step + window, rng=rng,
                          log_every=window)
        torch.cuda.synchronize()
        free_ms = 1e3 / last["steps_per_sec"]
    finally:
        batches.close()

    # (d) One fixed batch, constant lr 1e-4: the loss falls over 10 steps.
    log.clear()
    fixed = next(mlm_device_batches(data, rows, device="cuda", seed=2))
    state, _ = fit(state, step, itertools.repeat(fixed), num_steps=state.step + 10, rng=rng,
                   log_every=1, hooks=(hook,))
    fixed_losses = [entry[1] for entry in log]
    check(fixed_losses[-1] < fixed_losses[0], f"fixed-batch losses did not fall: {fixed_losses}")

    tokens = rows * seq
    flops = train_flops_per_token(cfg, seq) * tokens
    median_ms = statistics.median(step_ms)
    emit({"phase": "train", "rows": rows, "L": seq, "steps": n_steps, "launches": launches,
          "losses": losses, "fixed_batch_losses": fixed_losses,
          "step_ms_median": median_ms, "step_ms_min": min(step_ms),
          "step_ms_unsynced": free_ms, "host_wait_ms_median": host_wait_ms,
          "feed_ms_per_batch": feed_ms,
          "tokens_per_s": tokens / (median_ms / 1e3),
          "tflop_per_step": flops / 1e12,
          "mfu": flops / (median_ms / 1e3) / PEAK_BF16_FLOPS,
          "mfu_unsynced": flops / (free_ms / 1e3) / PEAK_BF16_FLOPS,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    return launches


# Launches per ResNet-50 training step of each kernel under each backend.
RESNET50_LAUNCHES = {
    "conv": {},
    "pallas": {"pw_dgrad": 29, "pw_dgrad_n64": 2},
    "fused": {"bn_bwd_reduce": 29, "bn_bwd_apply_dx": 29, "bn_bwd_apply_dw": 29},
}


def _rel_errors(got: dict, ref: dict, torch):
    """Relative L2 error of a dict of tensors against a reference: over the
    whole dict, and per entry against a floor of 1e-3 of the whole
    reference's norm (entries whose exact value is near zero)."""
    total = torch.linalg.vector_norm(torch.stack([r.float().norm() for r in ref.values()])).item()
    diff = torch.linalg.vector_norm(torch.stack(
        [(got[n].float() - r.float()).norm() for n, r in ref.items()])).item()
    per = {n: (got[n].float() - r.float()).norm().item() / max(r.float().norm().item(), 1e-3 * total)
           for n, r in ref.items()}
    return diff / total, per


def phase_train_resnet50(pc, fcb, torch):
    """ResNet-50 training on the card under each 1x1 backend."""
    from distributed_tensorflow_tpu_torch.cli.train import PRESETS, _make_tx
    from distributed_tensorflow_tpu_torch.data.loader import device_batches
    from distributed_tensorflow_tpu_torch.data.prefetch import prefetch
    from distributed_tensorflow_tpu_torch.data.synthetic import synthetic_image_classification
    from distributed_tensorflow_tpu_torch.models import ResNet50
    from distributed_tensorflow_tpu_torch.train import (
        create_train_state,
        fit,
        make_rng,
        make_train_step,
    )
    from distributed_tensorflow_tpu_torch.train.objectives import (
        init_model,
        make_classification_loss,
    )

    from distributed_tensorflow_tpu_torch.models.flops import train_flops_per_image

    rows, hw, n_steps = 128, 224, 10
    recipe = dataclasses.replace(PRESETS["imagenet_resnet50"], lr_schedule="constant",
                                 learning_rate=0.1, momentum=0.9, optimizer="sgd")
    t0 = time.monotonic()
    data = synthetic_image_classification(4 * rows, (hw, hw, 3), 1000, seed=SEED)
    data_s = time.monotonic() - t0
    flops = train_flops_per_image(ResNet50(device="cuda"), (hw, hw, 3)) * rows

    def build(backend):
        model = ResNet50(dtype=torch.bfloat16, pw_backend=backend, device="cuda",
                         generator=torch.Generator("cuda").manual_seed(SEED))
        params, model_state = init_model(model)
        tx, _ = _make_tx(recipe)
        state = create_train_state(params, tx, model_state)
        return model, state, make_train_step(make_classification_loss(model), tx)

    def reset():
        pc.reset_launch_counts()
        fcb.reset_launch_counts()

    def counts():
        return {**pc.LAUNCHES, **fcb.LAUNCHES}

    launches, results, trained = {}, {}, None
    for backend in ("conv", "pallas", "fused"):
        model, state, step = build(backend)
        log = []
        hook = lambda s, st, m: log.append((time.perf_counter(), m["loss"]))  # noqa: E731
        batches = prefetch(device_batches(data, rows, device="cuda", seed=1), 2)
        torch.cuda.reset_peak_memory_stats()
        try:
            # The main path, synchronised at every step by the loss fetch.
            reset()
            state, _ = fit(state, step, batches, num_steps=n_steps, rng=make_rng(SEED, "cuda"),
                           log_every=1, hooks=(hook,))
            torch.cuda.synchronize()
            got = counts()
        finally:
            batches.close()
        losses = [entry[1] for entry in log]
        check(len(losses) == n_steps and all(np.isfinite(losses)), f"{backend} losses {losses}")
        want = {k: v * n_steps for k, v in RESNET50_LAUNCHES[backend].items()}
        check({k: v for k, v in got.items() if v} == want,
              f"{backend}: launches {got} in {n_steps} steps, expected {want}")
        launches[backend] = got
        step_ms = [(b[0] - a[0]) * 1e3 for a, b in zip(log[1:], log[2:])]
        med = statistics.median(step_ms)
        results[backend] = {
            "losses": losses, "step_ms_median": med, "step_ms_min": min(step_ms),
            "images_per_s": rows / (med / 1e3), "mfu": flops / (med / 1e3) / PEAK_BF16_FLOPS,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": got}
        emit({"phase": "train_resnet50", "backend": backend, "rows": rows, "image": hw,
              "steps": n_steps, **results[backend]})
        if backend == "conv":
            trained = ({k: v.detach().clone() for k, v in model.state_dict().items()},
                       {k: v.clone() for k, v in state.model_state["batch_stats"].items()})
        if backend == "fused":
            # One fixed batch, lr 0.1 with momentum: the loss falls in 10 steps.
            log.clear()
            fixed = next(device_batches(data, rows, device="cuda", seed=2))
            state, _ = fit(state, step, itertools.repeat(fixed), num_steps=state.step + 10,
                           rng=make_rng(SEED, "cuda"), log_every=1, hooks=(hook,))
            fixed_losses = [entry[1] for entry in log]
            emit({"phase": "train_resnet50_fixed_batch", "backend": backend,
                  "losses": fixed_losses})
            check(fixed_losses[-1] < fixed_losses[0], f"fixed-batch losses {fixed_losses}")
        del model, state, step
        torch.cuda.empty_cache()

    # The same params (the conv run's, after its steps: every block's
    # zero-initialised final BN scale has moved, so every leaf has a
    # gradient), batch_stats and batch through each backend.
    batch = next(device_batches(data, rows, device="cuda", seed=3))
    grads, stats = {}, {}
    for backend in ("conv", "pallas", "fused"):
        model = ResNet50(dtype=torch.bfloat16, pw_backend=backend, device="cuda")
        model.load_state_dict(trained[0])
        params = dict(model.named_parameters())
        loss, (new_state, _) = make_classification_loss(model)(
            params, {"batch_stats": trained[1]}, batch, None)
        grads[backend] = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        stats[backend] = new_state["batch_stats"]
        del model, params, loss
    for backend in ("pallas", "fused"):
        total, per = _rel_errors(grads[backend], grads["conv"], torch)
        stat_total, _ = _rel_errors(stats[backend], stats["conv"], torch)
        worst = max(per, key=per.get)
        median = statistics.median(per.values())
        emit({"phase": "train_resnet50_grad_check", "backend": backend, "leaves": len(per),
              "rel_l2_err_total": total, "median_rel_l2_err": median,
              "worst_leaf": {worst: per[worst]}, "batch_stats_rel_l2_err": stat_total})
        # bf16 activations round at other places on each path (the fused
        # unit's dz and dW round to bf16, the conv path's BN backward runs
        # in f32 and its dgrad in cuDNN), through 53 BatchNorms.
        check(total <= 5e-2 and median <= 5e-2 and per[worst] <= 0.5,
              f"{backend} gradients differ from conv's: total {total}, median {median}, "
              f"worst {worst} {per[worst]}")
        check(stat_total <= 1e-2, f"{backend} batch_stats differ from conv's: {stat_total}")
    del grads, stats, trained
    torch.cuda.empty_cache()
    emit({"phase": "train_resnet50_setup", "data_seconds": data_s,
          "train_gflop_per_image": flops / rows / 1e9})
    return launches, results


def phase_train_inception(fcb, pc, torch, inception):
    """Inception-v3 training on the card, plain and fused, under the
    ``imagenet_inception_async`` recipe (K = 4 stale gradients)."""
    from distributed_tensorflow_tpu_torch.cli.train import PRESETS, _make_tx
    from distributed_tensorflow_tpu_torch.data.loader import device_batches
    from distributed_tensorflow_tpu_torch.data.prefetch import prefetch
    from distributed_tensorflow_tpu_torch.data.synthetic import synthetic_image_classification
    from distributed_tensorflow_tpu_torch.models import InceptionV3
    from distributed_tensorflow_tpu_torch.models.flops import train_flops_per_image
    from distributed_tensorflow_tpu_torch.train import (
        create_train_state,
        fit,
        make_rng,
        make_train_step,
    )
    from distributed_tensorflow_tpu_torch.train.objectives import (
        init_model,
        make_classification_loss,
    )

    # 128 images per card: bench.py's per-card batch for ResNet-50.
    rows, hw, n_steps = 128, 299, 8
    recipe = dataclasses.replace(PRESETS["imagenet_inception_async"], lr_schedule="constant")
    k = recipe.staleness
    t0 = time.monotonic()
    data = synthetic_image_classification(2 * rows, (hw, hw, 3), 1000, seed=SEED)
    data_s = time.monotonic() - t0
    flops = train_flops_per_image(InceptionV3(device="cuda"), (hw, hw, 3)) * rows
    per_step = {"bn_bwd_reduce": 27, "bn_bwd_apply_dx": 27, "bn_bwd_apply_dw": 27}
    check(sum(inception.values()) == 27, "Inception's fused units")

    def build(fused, dropout_rate=0.5):
        model = InceptionV3(dtype=torch.bfloat16, fused=fused, dropout_rate=dropout_rate,
                            device="cuda", generator=torch.Generator("cuda").manual_seed(SEED))
        params, model_state = init_model(model)
        tx, _ = _make_tx(recipe)
        state = create_train_state(params, tx, model_state, staleness=k)
        step = make_train_step(make_classification_loss(model), tx, mode="stale", staleness=k)
        return model, state, step

    def counts():
        return {**pc.LAUNCHES, **fcb.LAUNCHES}

    launches, results, trained = {}, {}, None
    for fused in (False, True):
        model, state, step = build(fused)
        log = []
        hook = lambda s, st, m: log.append((time.perf_counter(), m["loss"]))  # noqa: E731
        batches = prefetch(device_batches(data, rows, device="cuda", seed=1), 2)
        torch.cuda.reset_peak_memory_stats()
        try:
            # The main path, synchronised at every step by the loss fetch.
            pc.reset_launch_counts()
            fcb.reset_launch_counts()
            state, _ = fit(state, step, batches, num_steps=n_steps, rng=make_rng(SEED, "cuda"),
                           log_every=1, hooks=(hook,))
            torch.cuda.synchronize()
            got = counts()
        finally:
            batches.close()
        name = "fused" if fused else "plain"
        losses = [entry[1] for entry in log]
        check(len(losses) == n_steps and all(np.isfinite(losses)), f"{name} losses {losses}")
        want = {kk: v * n_steps for kk, v in per_step.items()} if fused else {}
        check({kk: v for kk, v in got.items() if v} == want,
              f"inception {name}: launches {got} in {n_steps} steps, expected {want}")
        launches[name] = got
        step_ms = [(b[0] - a[0]) * 1e3 for a, b in zip(log[1:], log[2:])]
        med = statistics.median(step_ms)
        results[name] = {
            "losses": losses, "step_ms_median": med, "step_ms_min": min(step_ms),
            "images_per_s": rows / (med / 1e3), "mfu": flops / (med / 1e3) / PEAK_BF16_FLOPS,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": got}
        emit({"phase": "train_inception", "fused": fused, "rows": rows, "image": hw,
              "staleness": k, "steps": n_steps, **results[name]})
        if not fused:
            trained = ({kk: v.detach().clone() for kk, v in model.state_dict().items()},
                       {kk: v.clone() for kk, v in state.model_state["batch_stats"].items()})
        else:
            # One fixed batch under K = 4 staleness from a fresh ring: the
            # first 4 steps apply the zero ring, then the loss falls.
            tx, _ = _make_tx(recipe)
            state = create_train_state(dict(model.named_parameters()), tx, state.model_state,
                                       staleness=k)
            log.clear()
            fixed = next(device_batches(data, rows, device="cuda", seed=2))
            state, _ = fit(state, step, itertools.repeat(fixed), num_steps=14,
                           rng=make_rng(SEED, "cuda"), log_every=1, hooks=(hook,))
            fixed_losses = [entry[1] for entry in log]
            emit({"phase": "train_inception_fixed_batch", "fused": fused, "staleness": k,
                  "losses": fixed_losses})
            check(len(fixed_losses) == 14 and fixed_losses[-1] < fixed_losses[0],
                  f"fixed-batch losses under staleness {k}: {fixed_losses}")
        del model, state, step
        torch.cuda.empty_cache()

    # The same params (the plain run's, after its steps), batch_stats and
    # batch, dropout off, no stale ring: fused gradients against plain ones.
    batch = next(device_batches(data, rows, device="cuda", seed=3))
    grads, stats = {}, {}
    for fused in (False, True):
        model = InceptionV3(dtype=torch.bfloat16, fused=fused, dropout_rate=0.0, device="cuda")
        model.load_state_dict(trained[0])
        params = dict(model.named_parameters())
        loss, (new_state, _) = make_classification_loss(model)(
            params, {"batch_stats": trained[1]}, batch, None)
        grads[fused] = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        stats[fused] = new_state["batch_stats"]
        del model, params, loss
    total, per = _rel_errors(grads[True], grads[False], torch)
    stat_total, _ = _rel_errors(stats[True], stats[False], torch)
    worst = max(per, key=per.get)
    median = statistics.median(per.values())
    emit({"phase": "train_inception_grad_check", "leaves": len(per),
          "rel_l2_err_total": total, "median_rel_l2_err": median,
          "worst_leaf": {worst: per[worst]}, "batch_stats_rel_l2_err": stat_total})
    # bf16 activations, dz and dW round at other places on the two paths,
    # through 95 BatchNorms (ResNet-50's tolerances).
    check(total <= 5e-2 and median <= 5e-2 and per[worst] <= 0.5,
          f"fused gradients differ from plain ones: total {total}, median {median}, "
          f"worst {worst} {per[worst]}")
    check(stat_total <= 1e-2, f"fused batch_stats differ from plain ones: {stat_total}")
    del grads, stats, trained
    torch.cuda.empty_cache()
    emit({"phase": "train_inception_setup", "data_seconds": data_s,
          "train_gflop_per_image": flops / rows / 1e9})
    return launches, results


def phase_train_cli_inception(torch):
    """``cli.train --config imagenet_inception_async`` at 75x75 for 3 steps
    with a checkpoint, then a ``Checkpointer`` restore of the step, the
    stale ring and every BatchNorm running average, on the card."""
    from distributed_tensorflow_tpu_torch.ckpt import Checkpointer
    from distributed_tensorflow_tpu_torch.cli.train import PRESETS, _make_tx
    from distributed_tensorflow_tpu_torch.models import InceptionV3
    from distributed_tensorflow_tpu_torch.train import create_train_state
    from distributed_tensorflow_tpu_torch.train.objectives import init_model

    ckpt_dir = ROOT / "build" / "chip_smoke_inception"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, (str(ROOT), env.get("PYTHONPATH"))))
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "distributed_tensorflow_tpu_torch.cli.train",
         "--config", "imagenet_inception_async", "--image-size", "75", "--global-batch", "16",
         "--steps", "3", "--log-every", "1", "--ckpt-dir", str(ckpt_dir)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600,
    )
    seconds = time.monotonic() - t0
    check(proc.returncode == 0, f"cli.train exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    steps = [ln for ln in proc.stderr.splitlines() if "train.loop: step" in ln]
    check(len(steps) == 3 and all("loss=nan" not in ln and "staleness=4" in ln for ln in steps),
          f"log: {steps}")
    preset = PRESETS["imagenet_inception_async"]
    model = InceptionV3(dtype=torch.bfloat16, aux_logits=False, device="cuda")
    params, model_state = init_model(model)
    tx, _ = _make_tx(preset)
    state = create_train_state(params, tx, model_state, staleness=preset.staleness)
    state, step = Checkpointer(ckpt_dir).restore_latest(state)
    stats = state.model_state["batch_stats"]
    ring = state.grad_buffer
    check(step == 3 and state.step == 3 and state.buffer_index == 3, f"restored step {step}")
    check(ring.keys() == params.keys()
          and all(v.is_cuda and v.shape[0] == preset.staleness for v in ring.values())
          and any(torch.any(v[:3] != 0).item() for v in ring.values()),
          "restored stale ring")
    check(stats.keys() == model_state["batch_stats"].keys()
          and all(t.is_cuda and torch.isfinite(t).all().item() for t in stats.values()),
          "restored batch_stats")
    moved = sum(int(not torch.equal(stats[kk], model_state["batch_stats"][kk])) for kk in stats)
    check(moved == len(stats), f"only {moved} of {len(stats)} running averages moved")
    emit({"phase": "train_cli_inception", "seconds": seconds,
          "last_log": steps[-1].split(": ", 1)[-1], "restored_step": step,
          "ring_depth": preset.staleness, "batch_stats": len(stats)})


def phase_train_cli_image(torch):
    """``cli.train --config imagenet_resnet50`` at 64x64 for 3 steps with a
    checkpoint, then a ``Checkpointer`` restore of step and batch_stats."""
    from distributed_tensorflow_tpu_torch.ckpt import Checkpointer
    from distributed_tensorflow_tpu_torch.cli.train import PRESETS, _make_tx
    from distributed_tensorflow_tpu_torch.models import ResNet50
    from distributed_tensorflow_tpu_torch.train import create_train_state
    from distributed_tensorflow_tpu_torch.train.objectives import init_model

    ckpt_dir = ROOT / "build" / "chip_smoke_image"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, (str(ROOT), env.get("PYTHONPATH"))))
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "distributed_tensorflow_tpu_torch.cli.train",
         "--config", "imagenet_resnet50", "--image-size", "64", "--global-batch", "16",
         "--steps", "3", "--lr", "0.05", "--log-every", "1", "--ckpt-dir", str(ckpt_dir)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600,
    )
    seconds = time.monotonic() - t0
    check(proc.returncode == 0, f"cli.train exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    steps = [ln for ln in proc.stderr.splitlines() if "train.loop: step" in ln]
    check(len(steps) == 3 and all("loss=nan" not in ln for ln in steps), f"log: {steps}")
    model = ResNet50(dtype=torch.bfloat16, device="cuda")
    params, model_state = init_model(model)
    tx, _ = _make_tx(PRESETS["imagenet_resnet50"])
    state = create_train_state(params, tx, model_state)
    state, step = Checkpointer(ckpt_dir).restore_latest(state)
    stats = state.model_state["batch_stats"]
    check(step == 3 and state.step == 3, f"restored step {step}")
    check(stats.keys() == model_state["batch_stats"].keys()
          and all(t.is_cuda and torch.isfinite(t).all().item() for t in stats.values()),
          "restored batch_stats")
    moved = sum(int(not torch.equal(stats[k], model_state["batch_stats"][k])) for k in stats)
    check(moved == len(stats), f"only {moved} of {len(stats)} running averages moved")
    emit({"phase": "train_cli_image", "seconds": seconds, "last_log": steps[-1].split(": ", 1)[-1],
          "restored_step": step, "batch_stats": len(stats)})


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _repo_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, (str(ROOT), env.get("PYTHONPATH"))))
    return env


def load_dp_train():
    """``scripts/torch_dp_train.py`` as a module: the DP phases' model,
    recipe and fixed batch."""
    return load_script("torch_dp_train")


def _dp_launch(world: int, backend: str, *extra: str, timeout: int = 600,
               codes: tuple[int, ...] | None = None, env: dict | None = None) -> list:
    """``scripts/torch_dp_train.py`` as ``world`` processes on a fresh port,
    under one deadline of ``timeout`` seconds for them all; each rank's
    output goes to files under ``build/chip_smoke_dp_logs/`` (no pipe to
    fill), with ``env`` added to its environment. Every rank must exit 0,
    or ``codes[rank]`` when given. Returns the JSON line of each rank that
    exited 0 (None for the others)."""
    port = _free_port()
    log_dir = ROOT / "build" / "chip_smoke_dp_logs"
    shutil.rmtree(log_dir, ignore_errors=True)
    log_dir.mkdir(parents=True)
    paths = [(log_dir / f"rank{r}.out", log_dir / f"rank{r}.err") for r in range(world)]
    procs = []
    try:
        for r, (out, err) in enumerate(paths):
            with open(out, "w") as fo, open(err, "w") as fe:
                procs.append(subprocess.Popen(
                    [sys.executable, str(ROOT / "scripts" / "torch_dp_train.py"),
                     "--world", str(world), "--rank", str(r), "--port", str(port),
                     "--backend", backend, *extra],
                    cwd=ROOT, env={**_repo_env(), **(env or {})}, stdout=fo, stderr=fe,
                    text=True))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline:
                raise SmokeFailure(f"torch_dp_train ({backend}, world {world}) passed {timeout} s")
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    logs = [(out.read_text(), err.read_text()) for out, err in paths]
    codes = codes or (0,) * world
    for r, (p, (out, err)) in enumerate(zip(procs, logs)):
        check(p.returncode == codes[r], f"torch_dp_train rank {r} of {world} ({backend}) "
                                        f"exited {p.returncode}:\n{out[-2000:]}\n{err[-4000:]}")
    return [json.loads(out.strip().splitlines()[-1]) if code == 0 else None
            for (out, _), code in zip(logs, codes)]


DP_LAUNCHES = RESNET50_LAUNCHES["fused"]
DP_ROWS = 128  # the global batch of the DP phases
DP_RANK_ROWS = DP_ROWS // 2  # rows a rank at world 2
DP_STALENESS = 4


def phase_train_cli_dp(torch):
    """``cli.train --config imagenet_resnet50 --image-size 64`` as one rank
    of an NCCL group of one (the cluster flags), with a checkpoint that a
    ``Checkpointer`` restores; the same CLI with a coordinator nobody
    serves must exit non-zero. Times nothing (it runs beside the other CLI
    phases); :func:`phase_train_dp_world1` is the timed half."""
    from distributed_tensorflow_tpu_torch.ckpt import Checkpointer
    from distributed_tensorflow_tpu_torch.cli.train import PRESETS, _make_tx
    from distributed_tensorflow_tpu_torch.models import ResNet50
    from distributed_tensorflow_tpu_torch.train import create_train_state
    from distributed_tensorflow_tpu_torch.train.objectives import init_model

    ckpt_dir = ROOT / "build" / "chip_smoke_dp"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    args = [sys.executable, "-m", "distributed_tensorflow_tpu_torch.cli.train",
            "--config", "imagenet_resnet50", "--image-size", "64", "--global-batch", "16",
            "--steps", "3", "--lr", "0.05", "--log-every", "1"]
    # A declared cluster that cannot form (rank 1 of 2, nobody at the
    # coordinator) fails the run; it never trains alone. It waits out its
    # init timeout beside the run of the group of one.
    port = _free_port()
    bad_port = next(p for p in iter(_free_port, None) if p != port)
    t1 = time.monotonic()
    bad = subprocess.Popen(
        args + ["--coordinator-address", f"127.0.0.1:{bad_port}", "--num-processes", "2",
                "--process-id", "1", "--init-timeout", "5"],
        cwd=ROOT, env=_repo_env(), stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True)
    try:
        t0 = time.monotonic()
        proc = subprocess.run(
            args + ["--ckpt-dir", str(ckpt_dir), "--coordinator-address",
                    f"127.0.0.1:{port}", "--num-processes", "1", "--process-id", "0"],
            cwd=ROOT, env=_repo_env(), capture_output=True, text=True, timeout=600)
        seconds = time.monotonic() - t0
        _, bad_err = bad.communicate(timeout=300)
    finally:
        if bad.poll() is None:
            bad.kill()
            bad.wait()
    bad_seconds = time.monotonic() - t1
    check(bad.returncode != 0 and "train.loop: step" not in bad_err,
          f"cli.train with an unreachable coordinator exited {bad.returncode}")
    check(proc.returncode == 0, f"cli.train exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    group = [ln for ln in proc.stderr.splitlines() if "process group:" in ln]
    check(len(group) == 1 and "backend=nccl world=1 rank=0 device=cuda:0" in group[0],
          f"process group log: {group}")
    steps = [ln for ln in proc.stderr.splitlines() if "train.loop: step" in ln]
    check(len(steps) == 3 and all("loss=nan" not in ln for ln in steps), f"log: {steps}")
    model = ResNet50(dtype=torch.bfloat16, device="cuda")
    params, model_state = init_model(model)
    tx, _ = _make_tx(PRESETS["imagenet_resnet50"])
    state, step = Checkpointer(ckpt_dir).restore_latest(create_train_state(params, tx,
                                                                           model_state))
    stats = state.model_state["batch_stats"]
    check(step == 3 and all(t.is_cuda for t in stats.values())
          and all(not torch.equal(stats[k], model_state["batch_stats"][k]) for k in stats),
          f"restored step {step} and its batch_stats")
    del model, params, model_state, state
    emit({"phase": "train_cli_dp", "seconds": seconds, "group": group[0].split(": ", 1)[-1],
          "last_log": steps[-1].split(": ", 1)[-1], "restored_step": step,
          "bad_coordinator_exit": bad.returncode, "bad_coordinator_seconds": bad_seconds,
          "bad_coordinator_error": (bad_err.strip().splitlines() or [""])[-1][-300:]})


def phase_train_dp_world1(torch):
    """``scripts/torch_dp_train.py`` at world 1 over NCCL: full-width
    ResNet-50 ``fused`` at 128 rows, 3 steps, and one real NCCL all-reduce
    of its flat gradient bucket, timed."""
    (rank,) = _dp_launch(1, "nccl", "--steps", "3", "--rows", str(DP_ROWS))
    check(len(rank["losses"]) == 3 and all(np.isfinite(rank["losses"])),
          f"world-1 losses {rank['losses']}")
    check({k: v for k, v in rank["launches"].items() if v}
          == {k: 3 * v for k, v in DP_LAUNCHES.items()}, f"world-1 launches {rank['launches']}")
    check(rank["allreduce_ok"], "the NCCL all-reduce of a group of one changed the bucket")
    emit({"phase": "train_dp_world1", **{k: v for k, v in rank.items() if k != "digests"}})
    return rank


def _hand_shards(model, params, model_state, batch, rank_rows: int, torch) -> tuple:
    """Each ``rank_rows``-row shard of ``batch`` through ``model`` here:
    the lists of the shards' gradients and BatchNorm statistics."""
    from distributed_tensorflow_tpu_torch.train.objectives import make_classification_loss

    loss_fn = make_classification_loss(model)
    grads, stats = [], []
    for r in range(next(iter(batch.values())).shape[0] // rank_rows):
        shard = {k: v[r * rank_rows:(r + 1) * rank_rows] for k, v in batch.items()}
        loss, (new_state, _) = loss_fn(params, model_state, shard, None)
        grads.append(dict(zip(params, torch.autograd.grad(loss, list(params.values())))))
        stats.append(new_state["batch_stats"])
    return grads, stats


def _tree_mean(trees: list) -> dict:
    """The leafwise mean of ``trees``, summed in list order."""
    out = {}
    for k in trees[0]:
        total = trees[0][k]
        for t in trees[1:]:
            total = total + t[k]
        out[k] = total / len(trees)
    return out


def _hand_mean_step(model, params, model_state, batch, torch):
    """One data-parallel step by hand in this process: the loss of each
    ``DP_RANK_ROWS``-row shard of ``batch``, then the gradients and the
    BatchNorm statistics averaged as the all-reduce's sum of two halved."""
    grads, stats = _hand_shards(model, params, model_state, batch, DP_RANK_ROWS, torch)
    return _tree_mean(grads), _tree_mean(stats)


def phase_train_dp_resnet50(torch):
    """Full-width ResNet-50 ``fused`` as two ranks on the one card over
    gloo (NCCL refuses two ranks on one device), 64 rows each of a fixed
    global batch of 128: bitwise equal ranks after every step; steps 1 and
    2 repeated in this process as two 64-row ``fused`` shards averaged by
    hand, bit for bit; step 2's averaged gradients and statistics against
    the plain ``conv`` backend's; 29 launches of each fused kernel a step
    per rank; a falling loss; then K = 4 stale gradients for K + 2 steps
    (lockstep, launches, params held for K steps and then moved)."""
    dp = load_dp_train()
    out_dir = ROOT / "build" / "chip_smoke_dp_train"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    t0 = time.monotonic()
    ranks = _dp_launch(2, "gloo", "--steps", "3", "--rows", str(DP_ROWS), "--save", str(out_dir))
    seconds = time.monotonic() - t0
    for rank in ranks:
        check({k: v for k, v in rank["launches"].items() if v}
              == {k: 3 * v for k, v in DP_LAUNCHES.items()},
              f"rank {rank['rank']} launches {rank['launches']}")
        check(rank["allreduce_ok"], f"rank {rank['rank']}: the gloo all-reduce's sum is wrong")
    check(ranks[0]["digests"] == ranks[1]["digests"] and len(ranks[0]["digests"]) == 3,
          f"the ranks' states differ: {[r['digests'] for r in ranks]}")
    losses = ranks[0]["losses"]
    check(losses == ranks[1]["losses"] and all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"losses {[r['losses'] for r in ranks]}")

    def hand_checks():
        """Steps 1 and 2 by hand, then step 2 through the plain backend."""
        # Steps 1 and 2 in this process, under the ranks' numerics: the two
        # shards' gradients and statistics averaged by hand, then the same SGD
        # update. The ranks ran the same kernels on the same shards, so rank 0's
        # state must match bit for bit.
        dp.numerics()
        model, state, _ = dp.build("cuda")
        batch = dp.fixed_batch(DP_ROWS, "cuda")
        for step in (1, 2):
            grads, stats = _hand_mean_step(model, state.params, state.model_state, batch, torch)
            for name, p in state.params.items():
                p.grad = grads[name]
            state.opt_state.apply()
            for p in state.params.values():
                p.grad = None
            if step == 1:
                # The state step 2 starts from, for the plain backend below.
                start = ({k: v.detach().clone() for k, v in state.params.items()},
                         {k: v.clone() for k, v in stats.items()})
            state.model_state = {"batch_stats": stats}
            saved = torch.load(out_dir / f"dp_step{step}.pt", weights_only=True)
            mine = {"params": {k: v.detach() for k, v in state.params.items()},
                    "slots": dp.slots(state), "batch_stats": stats}
            for part in ("params", "batch_stats"):
                differ = [k for k, v in mine[part].items()
                          if not torch.equal(saved[part][k].cuda(), v)]
                check(not differ and mine[part].keys() == saved[part].keys(),
                      f"DP step {step}: {part} differ from the hand-averaged shards' "
                      f"at {len(differ)} leaves, {differ[:4]}")
            differ = [k for k, slot in mine["slots"].items()
                      if slot.keys() != saved["slots"][k].keys()
                      or not all(torch.equal(saved["slots"][k][n].cuda(), t)
                                 for n, t in slot.items())]
            check(not differ and mine["slots"].keys() == saved["slots"].keys(),
                  f"DP step {step}: momentum differs at {len(differ)} leaves, {differ[:4]}")
        fused_grads, fused_stats = grads, stats
        del model, state, saved, mine

        # Step 2's averaged gradients and statistics through the plain backend
        # from the same state: the fused kernels at the 64-row shapes against
        # cuDNN and PyTorch's BatchNorm.
        conv_model, conv_state, _ = dp.build("cuda", pw_backend="conv")
        check(conv_state.params.keys() == start[0].keys(),
              "conv and fused parameter names differ")
        with torch.no_grad():
            for k, v in conv_state.params.items():
                v.copy_(start[0][k])
        conv_grads, conv_stats = _hand_mean_step(conv_model, conv_state.params,
                                                 {"batch_stats": start[1]}, batch, torch)
        total, per = _rel_errors(fused_grads, conv_grads, torch)
        stat_total, _ = _rel_errors(fused_stats, conv_stats, torch)
        worst = max(per, key=per.get)
        median = statistics.median(per.values())
        zero = sum(int(not g.any()) for g in conv_grads.values())
        del conv_model, conv_state, conv_grads, conv_stats, fused_grads, fused_stats, start
        torch.cuda.empty_cache()
        check(zero == 0, f"{zero} leaves have an all-zero plain gradient at step 2")
        # The train_resnet50 phase's tolerances.
        check(total <= 5e-2 and median <= 5e-2 and per[worst] <= 0.5,
              f"DP step 2's gradients differ from the plain backend's: total {total}, "
              f"median {median}, worst {worst} {per[worst]}")
        check(stat_total <= 1e-2, f"DP step 2's batch_stats differ from the plain backend's: "
                                  f"{stat_total}")
        return total, median, worst, per, stat_total

    # The stale run starts beside the checks in this process: its timed
    # steps come last, after its own start and K + 2 digest steps.
    depth = DP_STALENESS
    t1 = time.monotonic()
    (total, median, worst, per, stat_total), stale = concurrently(
        (hand_checks,),
        (_dp_launch, 2, "gloo", "--steps", str(depth + 2), "--rows", str(DP_ROWS), "--mode",
         "stale", "--staleness", str(depth)))
    stale_seconds = time.monotonic() - t1
    check(stale[0]["digests"] == stale[1]["digests"] and len(stale[0]["digests"]) == depth + 2,
          f"stale ranks' states differ: {[r['digests'] for r in stale]}")
    for rank in stale:
        check({k: v for k, v in rank["launches"].items() if v}
              == {k: (depth + 2) * v for k, v in DP_LAUNCHES.items()},
              f"stale rank {rank['rank']} launches {rank['launches']}")
    # The ring applies zeros for K steps (SGD without decay: the params stay
    # put), then step 1's gradient at step K + 1 and step 2's at K + 2; the
    # loss of step K + 2 is the first taken after a real update.
    pd, stale_losses = stale[0]["param_digests"], stale[0]["losses"]
    check(len(set(pd[:depth])) == 1 and len(set(pd[depth - 1:])) == 3,
          f"stale params: digests {pd}")
    check(stale_losses[depth + 1] != stale_losses[depth], f"stale losses {stale_losses}")
    emit({"phase": "train_dp_resnet50", "seconds": seconds, "world": 2, "backend": "gloo",
          "global_rows": DP_ROWS, "losses": losses,
          "step_ms": {r["rank"]: r["step_ms"] for r in ranks},
          "step_ms_median": {r["rank"]: r["step_ms_median"] for r in ranks},
          "allreduce_ms": {r["rank"]: r["allreduce_ms"] for r in ranks},
          "bucket_numel": ranks[0]["bucket_numel"],
          "peak_mem_gb": {r["rank"]: r["peak_mem_gb"] for r in ranks},
          "launches": ranks[0]["launches"], "vs_hand_fused": "bitwise equal, steps 1 and 2",
          "vs_conv_rel_l2_err_total": total, "vs_conv_median_rel_l2_err": median,
          "vs_conv_worst_leaf": {worst: per[worst]},
          "vs_conv_batch_stats_rel_l2_err": stat_total})
    emit({"phase": "train_dp_resnet50_stale", "seconds": stale_seconds, "staleness": depth,
          "losses": stale_losses, "step_ms": {r["rank"]: r["step_ms"] for r in stale},
          "step_ms_median": {r["rank"]: r["step_ms_median"] for r in stale},
          "launches": stale[0]["launches"]})
    return ranks


def _payloads(vocab: int):
    rng = np.random.default_rng(SEED)
    lengths = ([int(x) for x in rng.integers(64, 129, 8)]
               + [int(x) for x in rng.integers(129, 257, 8)]
               + [int(x) for x in rng.integers(257, 513, 8)])
    out = []
    for i, n in enumerate(lengths):
        ids = rng.integers(5, vocab, size=n)
        tgt = ids.copy() if i % 2 == 0 else np.where(rng.random(n) < 0.15, ids, -1)
        tgt[0] = ids[0]  # every request is scored
        out.append({"input_ids": ids, "mlm_targets": tgt})
    return out


def _reference(ref_model, payload, bucket, torch):
    """One request through the plain-attention model, padded like the engine."""
    n = len(payload["input_ids"])
    ids = torch.zeros((1, bucket), dtype=torch.int32, device="cuda")
    ids[0, :n] = torch.as_tensor(payload["input_ids"], dtype=torch.int32)
    mask = torch.zeros((1, bucket), dtype=torch.bool, device="cuda")
    mask[0, :n] = True
    logits, _, _ = ref_model.serve_outputs(ids, mask, torch.zeros_like(ids))
    logits = logits[0, :n].float()
    tgt = torch.as_tensor(payload["mlm_targets"], device="cuda").long()
    logp = torch.log_softmax(logits, dim=-1)
    w = (tgt >= 0).float()
    score = (logp.gather(-1, tgt.clamp_min(0)[:, None])[:, 0] * w).sum() / w.sum()
    top2 = logits.topk(2, dim=-1).values
    return logits.argmax(-1).cpu().numpy(), float(score), (top2[:, 0] - top2[:, 1]).cpu().numpy()


def phase_serve(fm, torch):
    from distributed_tensorflow_tpu_torch import ckpt
    from distributed_tensorflow_tpu_torch.models.bert import BertConfig, BertForPreTraining
    from distributed_tensorflow_tpu_torch.serve import (
        BatcherConfig,
        BertInferenceEngine,
        Client,
        build_http_server,
    )

    cfg = BertConfig(dtype=torch.bfloat16)
    t0 = time.monotonic()
    model = BertForPreTraining(cfg, device="cuda",
                               generator=torch.Generator("cuda").manual_seed(SEED))
    ckpt_dir = ROOT / "build" / "chip_smoke_ckpt"
    ckpt.save(ckpt_dir, 0, model.state_dict())
    params, _, step = ckpt.restore_serving_state(ckpt_dir)
    engine = BertInferenceEngine(model, params, "cuda", buckets=(128, 256, 512),
                                 max_batch=8, batch_tiers=(1, 2, 4, 8))
    grid = engine.grid_status()
    check(grid["warm_fraction"] == 1.0 and grid["cells_total"] == 12, f"grid {grid}")
    emit({"phase": "serve_setup", "seconds": round(time.monotonic() - t0, 3),
          "params": sum(t.numel() for t in params.values()), "ckpt_step": step,
          "warm_cells": grid["cells_compiled"],
          "warm_seconds_total": round(grid["compile_seconds_total"], 3)})

    payloads = _payloads(cfg.vocab_size)
    with Client(engine, BatcherConfig(max_batch=8, max_delay_ms=20.0,
                                      bucket_queues=True)) as client:
        fm.reset_launch_counts()
        t0 = time.monotonic()
        futs = [client.submit(p) for p in payloads]
        results = [f.result(timeout=300) for f in futs]
        wall = time.monotonic() - t0
        launches = fm.LAUNCHES["flash_fwd"]
        hits = {int(k): v for k, v in client.metrics.bucket_hits.snapshot().items()}
        emit({"phase": "serve", "requests": len(results), "seconds": wall,
              "bucket_hits": hits, "flash_launches": launches})
        check(set(hits) == {128, 256, 512}, f"all three buckets must run, got {hits}")
        check(launches == 12 * (hits[256] + hits[512]),
              f"{launches} launches for {hits}: expected 12 per forward at 256/512")

        # Answers: shapes, finiteness, and agreement with plain attention.
        ref_model = BertForPreTraining(dataclasses.replace(cfg, attn_impl="dense"),
                                       device="cuda")
        ref_model.load_state_dict(params)
        agree = total = 0
        confident_miss = 0
        score_err = 0.0
        with torch.inference_mode():
            for p, r in zip(payloads, results):
                n = len(p["input_ids"])
                check(r["pred_ids"].shape == (n,), "pred_ids shape")
                check(r["embedding"].shape == (cfg.hidden_size,)
                      and np.isfinite(r["embedding"]).all(), "embedding")
                check(abs(float(np.sum(r["nsp_probs"])) - 1.0) < 1e-3, "nsp_probs")
                check(r["score"] is not None and np.isfinite(r["score"]), "score")
                pred, score, margin = _reference(ref_model, p, r["bucket"], torch)
                same = pred == r["pred_ids"]
                agree += int(same.sum())
                total += n
                confident_miss += int((~same & (margin > 0.125)).sum())
                score_err = max(score_err, abs(score - r["score"]))
        emit({"phase": "serve_check", "pred_agreement": agree / total,
              "confident_mismatches": confident_miss, "max_score_err": score_err})
        # bf16 logits round in steps of 1/64 near |logit| ~ 2: argmax may
        # flip where the plain model's top two are closer than 1/8.
        check(agree / total >= 0.95, f"pred_ids agree on {agree}/{total}")
        check(confident_miss == 0, f"{confident_miss} mismatches with margin > 0.125")
        check(score_err <= 0.05, f"score differs by {score_err}")

        prof_dir = ROOT / "build" / "chip_smoke_profilez"
        shutil.rmtree(prof_dir, ignore_errors=True)
        server = build_http_server(client, port=0, trace_dir=str(prof_dir))
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            base = "http://{}:{}".format(*server.server_address)
            body = json.dumps({"input_ids": payloads[-1]["input_ids"].tolist()}).encode()
            req = urllib.request.Request(base + "/v1/mlm", data=body,
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as resp:
                check(resp.status == 200, f"/v1/mlm status {resp.status}")
                out = json.loads(resp.read())
            check(len(out["pred_ids"]) == len(payloads[-1]["input_ids"]), "http pred_ids")
            with urllib.request.urlopen(base + "/healthz", timeout=10) as resp:
                check(resp.status == 200, "healthz")
            emit({"phase": "http", "route": "/v1/mlm", "status": 200,
                  "bucket": out["bucket"], "phases_ms": out.get("phases")})
            phase_serve_profilez(client, base, payloads)
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=10)

    for bucket in engine.buckets:
        for tier in (1, 8):
            batch = [{"input_ids": np.full(bucket, 7)} for _ in range(tier)]
            engine.run_batch(batch)
            times = []
            for _ in range(5):
                t0 = time.monotonic()
                engine.run_batch(batch)
                times.append((time.monotonic() - t0) * 1e3)
            emit({"phase": "latency", "bucket": bucket, "tier": tier,
                  "ms_p50": float(np.median(times)), "ms_min": min(times)})
    return launches


def phase_serve_profilez(client, base: str, payloads: list) -> None:
    """``POST /profilez?ms=200`` on the live server while bucket-512
    requests keep arriving: the reply's keys, ``wall_ms >= 200``, and
    ``flash_fwd`` kernel events in the trace it wrote."""
    reply: dict = {}

    def profilez():
        req = urllib.request.Request(base + "/profilez?ms=200", data=b"", method="POST")
        with urllib.request.urlopen(req, timeout=120) as resp:
            reply.update(status=resp.status, body=json.loads(resp.read()))

    long = [p for p in payloads if len(p["input_ids"]) > 256]  # bucket 512
    prof = threading.Thread(target=profilez)
    t0 = time.monotonic()
    prof.start()
    served = 0
    while prof.is_alive() and time.monotonic() - t0 < 120:
        for f in [client.submit(p) for p in long]:
            check(f.result(timeout=60)["bucket"] == 512, "bucket")
            served += 1
    prof.join(timeout=10)
    body = reply.get("body", {})
    check(reply.get("status") == 200 and {"trace_dir", "requested_ms", "wall_ms"} <= set(body)
          and body["wall_ms"] >= 200.0, f"/profilez reply {reply}")
    names = _kernel_names(Path(body["path"]))
    flash = sum("flash_fwd" in n for n in names)
    check(flash > 0, f"no flash_fwd kernel events among {len(names)} in the /profilez trace")
    emit({"phase": "serve_profilez", "requested_ms": body["requested_ms"],
          "wall_ms": body["wall_ms"], "requests_served": served,
          "kernel_events": len(names), "flash_fwd_events": flash})


def phase_train_cli(torch):
    from distributed_tensorflow_tpu_torch.ckpt import restore_serving_state
    from distributed_tensorflow_tpu_torch.models.bert import BertConfig, BertForPreTraining
    from distributed_tensorflow_tpu_torch.serve import BertInferenceEngine

    ckpt_dir = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, (str(ROOT), env.get("PYTHONPATH"))))
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "distributed_tensorflow_tpu_torch.cli.train",
         "--config", "bert_base", "--steps", "3", "--global-batch", "32",
         "--log-every", "1", "--ckpt-dir", str(ckpt_dir)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600,
    )
    seconds = time.monotonic() - t0
    check(proc.returncode == 0, f"cli.train exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    steps = [ln for ln in proc.stderr.splitlines() if "train.loop: step" in ln]
    check(len(steps) == 3 and all("loss=nan" not in ln for ln in steps), f"log: {steps}")
    params, _, step = restore_serving_state(ckpt_dir)
    check(step == 3, f"restored step {step}")
    cfg = BertConfig(max_position=128, dropout_rate=0.1, dtype=torch.bfloat16)
    engine = BertInferenceEngine(BertForPreTraining(cfg, device="cpu"), params, "cuda",
                                 buckets=(128,), max_batch=1, batch_tiers=(1,))
    ids = np.random.default_rng(SEED).integers(5, cfg.vocab_size, size=64)
    out = engine.run_batch([{"input_ids": ids, "mlm_targets": ids}])[0]
    check(out["pred_ids"].shape == (64,) and np.isfinite(out["embedding"]).all(),
          "served answer from the trained checkpoint")
    emit({"phase": "train_cli", "seconds": seconds, "last_log": steps[-1].split(": ", 1)[-1],
          "restored_step": step, "served_tokens": int(out["pred_ids"].shape[0]),
          "score": out["score"]})


FEED_IMAGES, FEED_HW, FEED_OUT, FEED_BATCH = 1280, 256, 224, 128


def load_feed_bench():
    """``scripts/torch_feed_bench.py`` as a module: the seeded u8 cache, the
    preset's augmentation and the host-rate timers."""
    return load_script("torch_feed_bench")


def _kernel_names(trace: Path) -> list[str]:
    """The names of the CUDA kernel events of a ``torch.profiler`` Chrome
    trace."""
    events = json.loads(trace.read_text())["traceEvents"]
    return [e["name"] for e in events if e.get("cat") == "kernel"]


def phase_feed_native(torch):
    """The host C++ pipeline at ``imagenet_resnet50``'s training geometry
    (random-resized crop to 224, flip, ImageNet mean/std, 128 a batch) over
    a seeded u8 cache of 1280 images at 256x256 written under ``build/``:
    batches bitwise the same at 1 thread and at every core, one epoch a
    permutation without replacement, a ``start_ticket`` resume equal to the
    stream's tail, and 10 batches through ``native_device_batches`` onto
    the card (4 pinned staging buffers reused, every batch kept) equal to
    the host stream. Then host ms a batch and images/s at 1, 4 and all
    cores, the device path's, and CRC-32C per 110 kB record."""
    from distributed_tensorflow_tpu_torch.data.loader import native_device_batches
    from distributed_tensorflow_tpu_torch.data.native import NativePipeline
    from distributed_tensorflow_tpu_torch.data.synthetic import SyntheticClassification

    fb = load_feed_bench()
    cores = fb.host_cores()
    t0 = time.monotonic()
    cache = fb.write_cache(ROOT / "build" / "chip_smoke_u8", FEED_IMAGES, FEED_HW, seed=SEED)
    write_s = time.monotonic() - t0
    images, labels = fb.load_cache(cache)
    check(images.shape == (FEED_IMAGES, FEED_HW, FEED_HW, 3) and images.dtype == np.uint8,
          f"cache {images.shape} {images.dtype}")
    kw = dict(seed=SEED, **fb.imagenet_kwargs(FEED_OUT))
    index = np.arange(FEED_IMAGES, dtype=np.int32)  # label = example index

    def take(n, n_threads, **extra):
        with NativePipeline(images, index, FEED_BATCH, n_threads=n_threads, **kw,
                            **extra) as pipe:
            return [pipe.next() for _ in range(n)]

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    per_epoch = FEED_IMAGES // FEED_BATCH
    epoch = take(per_epoch, cores)
    check(all(b[0].shape == (FEED_BATCH, FEED_OUT, FEED_OUT, 3) and torch.isfinite(b[0]).all()
              for b in epoch), "batch shape or values")
    check(all(same(a, b) for a, b in zip(take(3, 1), epoch)),
          f"batches differ between 1 and {cores} threads")
    seen = np.sort(np.concatenate([b[1].numpy() for b in epoch]))
    check(np.array_equal(seen, index), "one epoch is not a permutation without replacement")
    check(all(same(a, b) for a, b in zip(take(3, cores, start_ticket=7), epoch[7:])),
          "start_ticket 7 differs from the stream's batches 7..9")
    # The card's path: each batch written into one of 4 pinned buffers, its
    # copy issued on the feed's stream; all 10 batches kept, so a buffer
    # overwritten before its copy left would show here.
    feed = native_device_batches(SyntheticClassification(images=images, labels=index),
                                 FEED_BATCH, device="cuda", n_threads=cores, staging=4, **kw)
    try:
        on_card = [next(feed) for _ in range(per_epoch)]
    finally:
        feed.close()
    torch.cuda.synchronize()
    check(all(b["image"].is_cuda and torch.equal(b["image"].cpu(), h[0])
              and torch.equal(b["label"].cpu(), h[1]) for b, h in zip(on_card, epoch)),
          "native_device_batches on the card differ from the host stream")
    emit({"phase": "feed_native", "cores": cores, "cache_images": list(images.shape),
          "cache_write_seconds": write_s, "checks": "threads, epoch, resume, staging"})
    rows = []
    for n_threads in sorted({1, 4, cores}):
        rows.append(fb.bench_native(images, labels, out_hw=FEED_OUT, batch=FEED_BATCH,
                                    n_batches=5, n_threads=n_threads))
    rows.append(fb.bench_device(images, labels, out_hw=FEED_OUT, batch=FEED_BATCH,
                                n_batches=5, n_threads=cores, device="cuda"))
    rows.append(fb.bench_crc(110_000))
    for r in rows:
        emit({"phase": "feed_native_rate", "cores": cores, **r})
    return cache, rows


def _cli_train(args: list[str], timeout: int = 900) -> subprocess.CompletedProcess:
    proc = subprocess.run(
        [sys.executable, "-m", "distributed_tensorflow_tpu_torch.cli.train", *args],
        cwd=ROOT, env=_repo_env(), capture_output=True, text=True, timeout=timeout)
    check(proc.returncode == 0, f"cli.train {' '.join(args)} exited {proc.returncode}:\n"
                                f"{proc.stderr[-4000:]}")
    return proc


def phase_train_cli_imagenet_real(torch, cache: Path):
    """``cli.train --config imagenet_resnet50 --data-dir <u8 cache>`` at the
    preset's width and batch (224x224, 256 images, plain convolutions) for
    6 steps with ``--metrics-jsonl``, ``--trace-dir`` and ``--profile-dir
    --profile-steps 3``; then with ``--no-native-input`` and with
    ``--device-pool 6``. Checks: the cache was read (no fallback), finite
    losses, one JSONL record a logged step, the span trace's host_wait /
    dispatch / device spans, the profile's CUDA kernel events. Prints each
    run's median step ms and host_wait_ms (steps 3-6)."""
    out = ROOT / "build" / "chip_smoke_cli_real"
    shutil.rmtree(out, ignore_errors=True)
    n_steps = 6
    base = ["--config", "imagenet_resnet50", "--data-dir", str(cache), "--steps", str(n_steps),
            "--log-every", "1"]
    runs = {}
    for name, extra in (
            ("native", ["--trace-dir", str(out / "trace"), "--profile-dir", str(out / "prof"),
                        "--profile-steps", "3"]),
            ("numpy", ["--no-native-input"]),
            ("device_pool", ["--device-pool", "6"])):
        jsonl = out / f"{name}.jsonl"
        t0 = time.monotonic()
        proc = _cli_train(base + ["--metrics-jsonl", str(jsonl), *extra])
        seconds = time.monotonic() - t0
        check(f"image feed: {FEED_IMAGES} images" in proc.stderr
              and "FALLING BACK" not in proc.stderr, f"{name}: the cache was not read")
        recs = [json.loads(ln) for ln in jsonl.read_text().splitlines()]
        check([r["step"] for r in recs] == list(range(1, n_steps + 1)),
              f"{name}: JSONL steps {[r['step'] for r in recs]}")
        losses = [r["loss"] for r in recs]
        check(all(np.isfinite(losses)), f"{name}: losses {losses}")
        step_ms = [(b["wall"] - a["wall"]) * 1e3 for a, b in zip(recs[1:], recs[2:])]
        runs[name] = {"seconds": seconds, "step_ms_median": statistics.median(step_ms),
                      "step_ms_min": min(step_ms),
                      "host_wait_ms_median": statistics.median(r["host_wait_ms"] for r in recs[2:]),
                      "losses": losses}
        emit({"phase": "train_cli_imagenet_real", "feed": name, "rows": 256, "image": 224,
              **runs[name]})
    spans = json.loads((out / "trace" / "train_trace.json").read_text())["traceEvents"]
    names = {e["name"] for e in spans}
    check({"host_wait", "dispatch", "device"} <= names, f"span names {sorted(names)}")
    traces = list((out / "prof").glob("*.pt.trace.json"))
    check(len(traces) == 1, f"profile files {traces}")
    kernels = _kernel_names(traces[0])
    check(len(kernels) > 0, "the profile holds no CUDA kernel events")
    emit({"phase": "train_cli_imagenet_real_trace", "spans": len(spans),
          "profile_kernel_events": len(kernels), "profile_mb": traces[0].stat().st_size / 1e6})
    return runs


def phase_train_fused_native(pc, fcb, torch, cache: Path):
    """``fit`` of ``ResNet50(pw_backend="fused")`` (224x224, 128 images, the
    train_resnet50 phase's recipe) on ``native_device_batches`` from the u8
    cache, through ``load_imagefolder``, with the preset's augmentation and
    a ``trace_steps(num_steps=2)`` profile window. Checks: 29 launches of
    each fused kernel a step by the counters, and by name in the profile
    (``bn_reduce_kernel_sm90``, ``bn_apply_dx_{strip,panel}_sm90``,
    ``bn_apply_dw_kernel_sm90``) 29 a profiled step; finite losses; the
    first step's gradients and new BatchNorm statistics (the seeded init,
    the first native batch) against the ``conv`` backend's at
    train_resnet50_grad_check's limits, and again at the trained params
    (every BN scale moved: every leaf has a gradient)."""
    from distributed_tensorflow_tpu_torch.cli.train import PRESETS, _make_tx
    from distributed_tensorflow_tpu_torch.data.loader import native_device_batches
    from distributed_tensorflow_tpu_torch.data.prefetch import prefetch
    from distributed_tensorflow_tpu_torch.data.readers import load_imagefolder
    from distributed_tensorflow_tpu_torch.models import ResNet50
    from distributed_tensorflow_tpu_torch.obs.profile import trace_steps
    from distributed_tensorflow_tpu_torch.train import create_train_state, fit, make_rng
    from distributed_tensorflow_tpu_torch.train import make_train_step
    from distributed_tensorflow_tpu_torch.train.objectives import (
        init_model,
        make_classification_loss,
    )

    fb = load_feed_bench()
    rows, n_steps, prof_steps = 128, 4, 2
    ds = load_imagefolder(cache)
    check(isinstance(ds.images, np.memmap) and len(ds) == FEED_IMAGES, "load_imagefolder")
    feed_kw = dict(seed=SEED, **fb.imagenet_kwargs(FEED_OUT))
    recipe = dataclasses.replace(PRESETS["imagenet_resnet50"], lr_schedule="constant",
                                 learning_rate=0.1, momentum=0.9, optimizer="sgd")
    model = ResNet50(dtype=torch.bfloat16, pw_backend="fused", device="cuda",
                     generator=torch.Generator("cuda").manual_seed(SEED))
    params, model_state = init_model(model)
    init = ({k: v.detach().clone() for k, v in model.state_dict().items()},
            {k: v.clone() for k, v in model_state["batch_stats"].items()})
    tx, _ = _make_tx(recipe)
    state = create_train_state(params, tx, model_state)
    step = make_train_step(make_classification_loss(model), tx)
    prof_dir = ROOT / "build" / "chip_smoke_fused_prof"
    shutil.rmtree(prof_dir, ignore_errors=True)
    losses = []
    feed = prefetch(native_device_batches(ds, rows, device="cuda", **feed_kw), 2)
    try:
        pc.reset_launch_counts()
        fcb.reset_launch_counts()
        with trace_steps(prof_dir, num_steps=prof_steps, device="cuda") as win:
            def step_fn(state_, batch_, rng_):
                win.before_step()
                out = step(state_, batch_, rng_)
                win.after_step(out)
                return out

            state, _ = fit(state, step_fn, feed, num_steps=n_steps, rng=make_rng(SEED, "cuda"),
                           log_every=1, hooks=(lambda s, st, m: losses.append(m["loss"]),))
        torch.cuda.synchronize()
        launches = {**pc.LAUNCHES, **fcb.LAUNCHES}
    finally:
        feed.close()
    check(len(losses) == n_steps and all(np.isfinite(losses)), f"losses {losses}")
    want = {k: v * n_steps for k, v in RESNET50_LAUNCHES["fused"].items()}
    check({k: v for k, v in launches.items() if v} == want,
          f"launches {launches} in {n_steps} steps, expected {want}")
    names = _kernel_names(win.trace_path)
    by_kernel = {
        "bn_reduce_kernel_sm90": sum("bn_reduce_kernel_sm90" in n for n in names),
        "bn_apply_dx_*_sm90": sum("bn_apply_dx_" in n and "_sm90" in n for n in names),
        "bn_apply_dw_kernel_sm90": sum("bn_apply_dw_kernel_sm90" in n for n in names),
    }
    check(all(v == 29 * prof_steps for v in by_kernel.values()),
          f"profiled launches {by_kernel} in {prof_steps} steps, expected 29 a step")
    trained = ({k: v.detach().clone() for k, v in model.state_dict().items()},
               {k: v.clone() for k, v in state.model_state["batch_stats"].items()})
    del model, state, step, params
    torch.cuda.empty_cache()

    first = native_device_batches(ds, rows, device="cuda", **feed_kw)
    try:
        batch = next(first)
    finally:
        first.close()
    checks = {}
    for label, (weights, stats_in) in (("first_step", init), ("trained", trained)):
        grads, stats = {}, {}
        for backend in ("conv", "fused"):
            net = ResNet50(dtype=torch.bfloat16, pw_backend=backend, device="cuda")
            net.load_state_dict(weights)
            p = dict(net.named_parameters())
            loss, (new_state, _) = make_classification_loss(net)(
                p, {"batch_stats": stats_in}, batch, None)
            grads[backend] = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
            stats[backend] = new_state["batch_stats"]
            del net, p, loss
        total, per = _rel_errors(grads["fused"], grads["conv"], torch)
        stat_total, _ = _rel_errors(stats["fused"], stats["conv"], torch)
        worst = max(per, key=per.get)
        median = statistics.median(per.values())
        checks[label] = {"rel_l2_err_total": total, "median_rel_l2_err": median,
                         "worst_leaf": {worst: per[worst]}, "batch_stats_rel_l2_err": stat_total,
                         "zero_grad_leaves": sum(int(not g.any()) for g in grads["conv"].values())}
        # train_resnet50_grad_check's limits and reason.
        check(total <= 5e-2 and median <= 5e-2 and per[worst] <= 0.5 and stat_total <= 1e-2,
              f"{label}: fused gradients differ from conv's on the native batch: {checks[label]}")
        del grads, stats
    torch.cuda.empty_cache()
    emit({"phase": "train_fused_native", "rows": rows, "steps": n_steps, "losses": losses,
          "launches": launches, "profiled_steps": prof_steps, "profiled_launches": by_kernel,
          "profile_kernel_events": len(names), "grad_check": checks})
    return launches


def write_corpus(root: Path, n_sentences: int = 20_000, seed: int = SEED) -> Path:
    """A seeded corpus of made-up words with Zipf-like frequencies: four
    ``*.txt`` files of documents (4-12 sentences of 6-18 words, blank lines
    between) holding ``n_sentences`` in all, and ``val/val.txt`` with a
    twentieth as many."""
    rng = np.random.default_rng(seed)
    syllables = [a + b for a in "bdfgklmnprstvz" for b in ("a", "e", "i", "o", "u", "ai", "ou")]
    vocab = sorted({"".join(rng.choice(syllables, rng.integers(1, 4))) for _ in range(12_000)})
    weights = 1.0 / np.arange(1, len(vocab) + 1)
    weights /= weights.sum()
    shutil.rmtree(root, ignore_errors=True)
    (root / "val").mkdir(parents=True)

    def write(path: Path, n: int) -> None:
        lengths = rng.integers(6, 19, n)
        words = np.asarray(vocab)[rng.choice(len(vocab), int(lengths.sum()), p=weights)]
        sentences = [" ".join(ws).capitalize() + "."
                     for ws in np.split(words, np.cumsum(lengths)[:-1])]
        lines, i = [], 0
        while i < n:
            k = int(rng.integers(4, 13))
            lines += sentences[i:i + k] + [""]
            i += k
        path.write_text("\n".join(lines) + "\n")

    for i in range(4):
        write(root / f"part{i}.txt", n_sentences // 4)
    write(root / "val" / "val.txt", n_sentences // 20)
    return root


def phase_train_cli_bert_corpus(torch):
    """``cli.train --config bert_base --data-dir <corpus>`` at the preset's
    width (L=128, 256 rows a step) for 4 steps with an eval pass on the
    ``val/`` split: finite losses, the corpus's vocabulary logged, an eval
    metric in the log."""
    corpus = write_corpus(ROOT / "build" / "chip_smoke_corpus")
    t0 = time.monotonic()
    proc = _cli_train(["--config", "bert_base", "--data-dir", str(corpus), "--steps", "4",
                       "--log-every", "1", "--eval-every", "4", "--eval-batches", "2"])
    seconds = time.monotonic() - t0
    steps = [ln for ln in proc.stderr.splitlines() if "train.loop: step" in ln and "eval" not in ln]
    losses = [float(ln.split("loss=")[1].split()[0]) for ln in steps]
    check(len(losses) == 4 and all(np.isfinite(losses)), f"log: {steps}")
    vocab = [ln.split("text corpus: ", 1)[1] for ln in proc.stderr.splitlines()
             if "text corpus: " in ln]
    check(len(vocab) == 1 and "4 files, 20000 sentences" in vocab[0], f"corpus log {vocab}")
    evals = [ln.split("eval: ", 1)[1] for ln in proc.stderr.splitlines() if "eval: " in ln]
    check(len(evals) == 1 and "eval_mlm_accuracy=" in evals[0], f"eval log {evals}")
    check("FALLING BACK" not in proc.stderr and "RESAMPLE" not in proc.stderr,
          "the corpus or its val split was not read")
    emit({"phase": "train_cli_bert_corpus", "seconds": seconds, "corpus": vocab[0],
          "losses": losses, "eval": evals[0]})


# ------------------------------------------------------------- causal LM

LM_SLOTS, LM_TIER, LM_NEW = 8, 4, 32
LM_BUCKETS = (64, 128)
# The int8 controls' bounds, set between the H100's readings of the sound
# trees and of a planted fault (_misplace_scales); PERF.md section 5 has
# both. Max |logit - bf16 full forward's|, teacher forced: int8 0.086,
# the fault 1.125.
LM_INT8_MAX_LOGIT_ERR = 0.3
# Against the bf16 engine: pred_ids agreement, int8 0.943, the fault
# 0.381; max |mean target log-prob difference|, int8 0.0023, the fault
# 0.0096.
BERT_INT8_MIN_PRED_AGREEMENT = 0.9
BERT_INT8_MAX_SCORE_DIFF = 0.005


def phase_train_cli_lm(torch, resume_steps: int = 64):
    """``cli.train --config lm_base`` at the preset's width (12 layers, H
    768, 12 heads, vocab 30522, L 128, bf16) and global batch (256) for 4
    steps with a checkpoint and ``--metrics-jsonl``: finite losses; ms a
    step and tokens a second from the logged rate (steps 2-4). Then the
    same CLI resumes that checkpoint to step ``resume_steps`` at a constant
    3e-4 (the preset's 1000-step warmup leaves 4 steps at lr ~1e-7, a
    model whose logits are flat): the restore is logged and the loss
    falls. The served checkpoint is that one (the 4-step one when
    ``resume_steps`` is 0)."""
    ckpt_dir = ROOT / "build" / "chip_smoke_lm"
    jsonl = ROOT / "build" / "chip_smoke_lm_metrics.jsonl"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    jsonl.unlink(missing_ok=True)
    t0 = time.monotonic()
    _cli_train(["--config", "lm_base", "--steps", "4", "--log-every", "1",
                "--ckpt-dir", str(ckpt_dir), "--metrics-jsonl", str(jsonl)], timeout=600)
    seconds = time.monotonic() - t0
    records = [json.loads(line) for line in jsonl.read_text().splitlines()]
    losses = [r["loss"] for r in records if "loss" in r]
    check(len(losses) == 4 and all(np.isfinite(losses)), f"lm_base losses {losses}")
    rate = statistics.median(r["steps_per_sec"] for r in records[1:] if "loss" in r)
    out = {"phase": "train_cli_lm", "seconds": seconds, "losses": losses,
           "step_ms": 1e3 / rate, "tokens_per_s": 256 * 128 * rate}
    if resume_steps:
        t0 = time.monotonic()
        proc = _cli_train(["--config", "lm_base", "--steps", str(resume_steps), "--lr", "3e-4",
                           "--lr-schedule", "constant", "--log-every", "20",
                           "--ckpt-dir", str(ckpt_dir)], timeout=600)
        resumed = [float(ln.split(" loss=")[1].split()[0]) for ln in proc.stderr.splitlines()
                   if "train.loop: step" in ln and " loss=" in ln]
        check("restored checkpoint at step 4" in proc.stderr, "lm_base did not resume at step 4")
        check(len(resumed) >= 2 and all(np.isfinite(resumed)) and resumed[-1] < losses[0] - 2.0,
              f"lm_base losses after the resume: {resumed}")
        out.update(resume_seconds=time.monotonic() - t0, resumed_logged_losses=resumed)
    emit(out)
    return ckpt_dir


def _lm_requests(vocab: int, n: int = 12, max_position: int = 128):
    """Seeded prompts of 5-120 tokens; every other one sampled (0.8, its
    own seed); budgets fill the cache pages: min(32, 128 - prompt)."""
    rng = np.random.default_rng(SEED + 11)
    out = []
    for i in range(n):
        length = int(rng.integers(5, 121)) if i else 120
        out.append({"id": i, "input_ids": rng.integers(4, vocab, length),
                    "temperature": 0.8 if i % 2 else 0.0, "seed": 100 + i,
                    "budget": min(LM_NEW, max_position - length)})
    return out


def _generate(engine, requests, chunk: int = 0) -> dict:
    """The direct driver (the reference serve_lm_batcher holds the
    continuous batcher to): admit requests
    into free slots a tier at a time (whole prompts, or ``chunk``-token
    chunks), decode every active slot until each budget is spent, reuse
    the freed slots. Returns ``{id: [tokens]}``."""
    S = engine.slots
    lengths, active = np.zeros(S, np.int32), np.zeros(S, bool)
    temps, seeds = np.zeros(S, np.float32), np.zeros(S, np.int32)
    free, pending, owner, out = list(range(S)), list(requests), {}, {}
    while pending or owner:
        while pending and free:
            group = []
            while pending and free and len(group) < engine.max_batch:
                group.append((free.pop(0), pending.pop(0)))
            if chunk:
                first = {}
                for s0 in range(0, max(len(r["input_ids"]) for _, r in group), chunk):
                    rows = [(s, r) for s, r in group if s0 < len(r["input_ids"])]
                    tok = engine.fetch_step(engine.prefill_chunks([
                        {"slot": s, "input_ids": r["input_ids"], "start": s0,
                         "n_tokens": min(chunk, len(r["input_ids"]) - s0),
                         "length": len(r["input_ids"]), "temperature": r["temperature"],
                         "seed": r["seed"]} for s, r in rows]))
                    for j, (s, r) in enumerate(rows):
                        if s0 + chunk >= len(r["input_ids"]):
                            first[s] = int(tok[j])
                firsts = [first[s] for s, _ in group]
            else:
                tok = engine.fetch_step(engine.prefill([
                    {"slot": s, "input_ids": r["input_ids"], "temperature": r["temperature"],
                     "seed": r["seed"]} for s, r in group]))
                firsts = [int(t) for t in tok[:len(group)]]
            for (s, r), t in zip(group, firsts):
                out[r["id"]] = [t]
                lengths[s], active[s] = len(r["input_ids"]), True
                temps[s], seeds[s] = r["temperature"], r["seed"]
                owner[s] = r
        tok = engine.fetch_step(engine.decode(lengths, active, temps, seeds))
        for s, r in list(owner.items()):
            out[r["id"]].append(int(tok[s]))
            lengths[s] += 1
            if len(out[r["id"]]) >= r["budget"]:
                active[s] = False
                del owner[s]
                free.append(s)
    return out


def _bf16_ulp(x: float) -> float:
    """The spacing of bf16 values at ``x`` (8 significand bits)."""
    return 2.0 ** (np.floor(np.log2(max(abs(x), 1e-30))) - 7)


def _greedy_against_full_forward(engine, requests, streams, torch, exact: bool):
    """Each greedy stream against the port's own full forward on the card
    over prompt + stream (teacher-forced argmax at every generated
    position): the first divergence of each stream, with the reference's
    top-2 gap there. ``exact``: any divergence is a violation; otherwise
    only one whose gap exceeds one bf16 ulp of the larger logit."""
    rows, violations = [], []
    with torch.inference_mode():
        for r in requests:
            if r["temperature"]:
                continue
            stream, n = streams[r["id"]], len(r["input_ids"])
            seq = torch.as_tensor(np.concatenate([r["input_ids"], stream[:-1]]),
                                  device=engine.device)[None]
            logits = engine.model(seq, torch.ones_like(seq, dtype=torch.bool))[0, n - 1:]
            ref = logits.argmax(-1).tolist()
            diverge = next((t for t, (a, b) in enumerate(zip(stream, ref)) if a != b), None)
            if diverge is None:
                continue
            top2 = logits[diverge].float().topk(2).values.tolist()
            gap = top2[0] - top2[1]
            row = {"id": r["id"], "step": diverge, "gap": gap, "ulp": _bf16_ulp(top2[0])}
            rows.append(row)
            if exact or gap > row["ulp"]:
                violations.append(row)
    return rows, violations


def _teacher_forced_probes(ref_model, vocab: int, torch, n_prompts: int = 6,
                           n_steps: int = 7):
    """Probes for the teacher-forced agreement: seeded prompts of 8-40
    tokens, each greedily continued by ``ref_model``'s full forward (one
    re-run a token); probe ``t`` is the prompt plus the first ``t``
    reference tokens, with the reference's next two tokens and its top-2
    logit gaps there."""
    rng = np.random.default_rng(SEED + 23)
    probes = []
    with torch.inference_mode():
        for _ in range(n_prompts):
            p = rng.integers(4, vocab, int(rng.integers(8, 40)))
            seq, gaps = list(p), []
            device = next(ref_model.parameters()).device
            for _ in range(n_steps):
                ids = torch.as_tensor(seq, device=device)[None]
                row = ref_model(ids, torch.ones_like(ids, dtype=torch.bool))[0, -1].float()
                top2 = row.topk(2).values.tolist()
                gaps.append(top2[0] - top2[1])
                seq.append(int(row.argmax()))
            ref = seq[len(p):]
            probes += [(np.asarray(seq[:len(p) + t]), ref[t:t + 2], gaps[t:t + 2])
                       for t in range(n_steps - 1)]
    return probes


def _teacher_forced(engine, probes):
    """Top-1 agreement of ``engine`` with the probes' reference, teacher
    forced: each probe is admitted whole and checked on the prefill's token
    and on one decode step's (two comparisons a probe). Returns the
    agreement and the reference's top-2 gaps at the disagreements."""
    agree = total = 0
    missed = []
    S = engine.slots
    for i in range(0, len(probes), engine.max_batch):
        group = probes[i:i + engine.max_batch]
        first = engine.fetch_step(engine.prefill([
            {"slot": s, "input_ids": ids} for s, (ids, _, _) in enumerate(group)]))
        lengths, active = np.zeros(S, np.int32), np.zeros(S, bool)
        for s, (ids, _, _) in enumerate(group):
            lengths[s], active[s] = len(ids), True
        second = engine.fetch_step(engine.decode(lengths, active, np.zeros(S, np.float32),
                                                 np.zeros(S, np.int32)))
        for s, (_, ref, gaps) in enumerate(group):
            for got, want, gap in zip((first[s], second[s]), ref, gaps):
                agree += int(got == want)
                total += 1
                if got != want:
                    missed.append(gap)
    return agree / total, missed


def _misplace_scales(params: dict) -> dict:
    """A planted fault for the int8 controls: ``params`` (a packed serving
    tree) with every kernel's scales on the wrong output rows, as a
    mis-broadcast would put them: q/k/v's per-head-dim-lane scales indexed
    by ``row // heads`` instead of ``row % d``, every other kernel's
    per-row scales rolled by one row."""
    out = {}
    for name, leaf in params.items():
        if isinstance(leaf, dict) and "_q8_scale" in leaf:
            s, rows = leaf["_q8_scale"], leaf["_q8"].shape[0]
            s = s.roll(1) if s.numel() == rows else s.repeat_interleave(rows // s.numel())
            leaf = {"_q8": leaf["_q8"], "_q8_scale": s}
        out[name] = leaf
    return out


def _logit_error(engine, ref_model, probes, torch) -> dict:
    """|logit difference| of ``engine``'s model against ``ref_model``'s full
    forward, teacher forced, at each probe's next position (the prefill
    forward) and the one after (a decode step that reads the K/V the
    engine's prefill cell wrote into its slot cache, fed the reference's
    token): the max and the root mean square over all positions and
    vocabulary entries."""
    S, lc, dev = engine.slots, engine.cache_len, engine.device
    worst, sq, n = 0.0, 0.0, 0
    with torch.inference_mode():
        for i in range(0, len(probes), engine.max_batch):
            group = probes[i:i + engine.max_batch]
            engine.fetch_step(engine.prefill([
                {"slot": s, "input_ids": ids} for s, (ids, _, _) in enumerate(group)]))
            tok = torch.zeros(S, dtype=torch.int32, device=dev)
            pos = torch.full((S,), lc, dtype=torch.int32, device=dev)
            for s, (ids, ref, _) in enumerate(group):
                tok[s], pos[s] = int(ref[0]), len(ids)
            dec, _, _ = engine.model.decode_step(tok, pos, engine._cache_k, engine._cache_v)
            for s, (ids, ref, _) in enumerate(group):
                seq = torch.as_tensor(np.append(ids, ref[0]), device=dev)[None]
                mask = torch.ones_like(seq, dtype=torch.bool)
                want = ref_model(seq, mask)[0, -2:].float()
                first = engine.model.prefill(seq[:, :-1], mask[:, :-1])[0][0, -1].float()
                diff = torch.stack([first, dec[s].float()]) - want
                worst = max(worst, float(diff.abs().max()))
                sq += float(diff.square().sum())
                n += diff.numel()
    return {"max_abs": worst, "rms": (sq / n) ** 0.5}


def _verify_against_decode(engine, requests, torch):
    """Admit the first ``slots`` greedy prompts, then from that state: K + 1
    decode steps through ``decode_step`` (logits kept), and from the same
    state one ``verify_step`` over the slot's last token plus the K decoded
    tokens as drafts. Returns the argmax mismatches between verify column j
    and decode step j, the max |logit difference|, and whether the engine's
    verify cell accepted every draft and emitted decode's tokens."""
    k = engine.spec_tokens
    S = engine.slots
    reqs = [dict(r, temperature=0.0) for r in requests[:S]]
    for j in range(0, S, engine.max_batch):
        engine.fetch_step(engine.prefill([
            {"slot": j + s, "input_ids": r["input_ids"]}
            for s, r in enumerate(reqs[j:j + engine.max_batch])]))
    lengths = np.array([len(r["input_ids"]) for r in reqs], np.int32)
    snap = lambda c: ({n: t.clone() for n, t in c.items()} if isinstance(c, dict)  # noqa: E731
                      else c.clone())

    def restore(state):
        for dst, src in zip((engine._cache_k, engine._cache_v, engine._last_buf), state):
            if isinstance(dst, dict):
                for n in dst:
                    dst[n].copy_(src[n])
            else:
                dst.copy_(src)

    state = (snap(engine._cache_k), snap(engine._cache_v), engine._last_buf.clone())
    lc = engine.cache_len
    dev = engine.device
    with torch.inference_mode():
        tok = engine._last_token.clone()
        step_logits, step_tok = [], []
        for j in range(k + 1):
            pos = torch.as_tensor(lengths + j, device=dev).clamp_max(lc - 1)
            logits, _, _ = engine.model.decode_step(tok, pos, engine._cache_k, engine._cache_v)
            tok = logits.argmax(-1).to(torch.int32)
            step_logits.append(logits.float())
            step_tok.append(tok)
        restore(state)
        tokens = torch.stack([engine._last_token] + step_tok[:k], dim=1)
        pos = torch.as_tensor(lengths, device=dev)[:, None] + torch.arange(k + 1, device=dev)
        vlogits, _, _ = engine.model.verify_step(tokens, pos, engine._cache_k, engine._cache_v)
        vlogits = vlogits.float()
        restore(state)
    dec = torch.stack(step_logits, dim=1)
    mismatches = int((vlogits.argmax(-1) != dec.argmax(-1)).sum())
    max_diff = float((vlogits - dec).abs().max())
    drafts = torch.stack(step_tok[:k], dim=1).cpu().numpy()
    mat = engine.fetch_step(engine.verify(drafts, lengths, np.full(S, k + 1, np.int32),
                                          np.zeros(S, np.float32), np.zeros(S, np.int32)))
    want = torch.stack(step_tok, dim=1).cpu().numpy()
    restore(state)
    return {"argmax_mismatches": mismatches, "columns": S * (k + 1),
            "max_abs_logit_diff": max_diff, "cell_matches_decode": bool((mat == want).all())}


def _prefix_round_trip(engine, requests, torch):
    """Prefix insert, gather, export and import, bit for bit: prompt A (the
    longest request) prefilled in chunks into slot 0 and its head blocks
    published; the pool pages equal slot 0's; B (A's head plus a tail)
    admitted into slot 1 with the chain gathered equals slot 0 over the
    head; pages exported, imported under other ids and exported again are
    the same bytes; a slot's lane exported and imported into another slot
    is the same bytes."""
    bt = engine.block_tokens
    a = requests[0]["input_ids"]
    n_blocks = min(len(a) // bt, engine._max_chain)
    head = n_blocks * bt
    b = np.concatenate([a[:head], np.arange(5, 5 + 7)])
    chunk = engine.prefill_chunk_size
    for s0 in range(0, len(a), chunk):
        engine.fetch_step(engine.prefill_chunks([
            {"slot": 0, "input_ids": a, "start": s0, "n_tokens": min(chunk, len(a) - s0),
             "length": len(a)}]))
    blocks = list(range(1, 1 + n_blocks))
    engine.insert_prefix(0, [(blk, i) for i, blk in enumerate(blocks)])
    engine.fetch_step(engine.prefill_chunks([
        {"slot": 1, "input_ids": b, "start": head, "n_tokens": len(b) - head,
         "length": len(b), "chain": blocks}]))
    ck = engine._cache_k
    pool_k, pool_v = engine.export_prefix_pages(blocks)
    nl = pool_k.shape[0]
    ok = {
        "pool_is_slot0": torch.equal(pool_k[:, :n_blocks].reshape(nl, head, *ck.shape[3:]),
                                     ck[:, 0, :head]),
        "gather_is_slot0": torch.equal(ck[:, 1, :head], ck[:, 0, :head])
        and torch.equal(engine._cache_v[:, 1, :head], engine._cache_v[:, 0, :head]),
    }
    others = [engine._pool_blocks - 1 - i for i in range(n_blocks)]
    engine.import_prefix_pages([(blk, i) for i, blk in enumerate(others)], pool_k, pool_v)
    k2, v2 = engine.export_prefix_pages(others)
    ok["export_import_export"] = (torch.equal(k2[:, :n_blocks], pool_k[:, :n_blocks])
                                  and torch.equal(v2[:, :n_blocks], pool_v[:, :n_blocks]))
    sk, sv = engine.export_slot_pages(1)
    engine.import_slot_pages(2, sk, sv, last_token=int(engine._last_token[1]))
    sk2, sv2 = engine.export_slot_pages(2)
    ok["slot_lane"] = torch.equal(sk2, sk) and torch.equal(sv2, sv)
    return {**ok, "blocks": n_blocks, "block_tokens": bt}


def _time_lm(engine, vocab: int, torch) -> dict:
    """Prefill ms per (tier, bucket) with real rows (slots 0..T-1), and
    decode ms a step with all slots active (median of 20, each fetched)."""
    rng = np.random.default_rng(SEED + 31)
    prefill = {}
    for T in engine.batch_tiers:
        for L in engine.buckets:
            adm = [{"slot": s, "input_ids": rng.integers(4, vocab, L)} for s in range(T)]
            engine.fetch_step(engine.prefill(adm))
            times = []
            for _ in range(5):
                t0 = time.monotonic()
                engine.fetch_step(engine.prefill(adm))
                times.append((time.monotonic() - t0) * 1e3)
            prefill[f"t{T}/b{L}"] = statistics.median(times)
    S = engine.slots
    lengths = np.full(S, 64, np.int32)
    args = (np.ones(S, bool), np.zeros(S, np.float32), np.zeros(S, np.int32))
    engine.fetch_step(engine.decode(lengths, *args))
    times = []
    for _ in range(20):
        t0 = time.monotonic()
        engine.fetch_step(engine.decode(lengths, *args))
        times.append((time.monotonic() - t0) * 1e3)
    decode_ms = statistics.median(times)
    return {"prefill_ms": prefill, "decode_ms": decode_ms,
            "decode_tokens_per_s": S / decode_ms * 1e3}


def phase_serve_lm(torch, ckpt_dir: Path, *, device="cuda", cfg=None, n_requests=12):
    """``CausalLMEngine`` on the ``lm_base`` checkpoint through
    ``restore_serving_state``: buckets (64, 128), 8 slots, tiers of up to 4,
    32 new tokens; 12 seeded prompts of 5-120 tokens (every other one
    sampled at 0.8) admitted a tier at a time into free slots and decoded
    until every budget is spent (:func:`_generate`). Checks: greedy streams
    equal the port's full forward on the card (fp32 engine: exactly; bf16:
    a first divergence only where the reference's top-2 gap is within one
    bf16 ulp); streams equal run to run (fp32 and bf16), solo versus
    mid-flight (fp32; bf16 measured), and chunked (``prefill_chunk=32``)
    versus monolithic (fp32); verify (``spec_tokens=4``) columns' argmax
    equals decode's (fp32; bf16 measured) and the verify cell emits
    decode's tokens; prefix insert / gather / export / import and slot
    export / import bit for bit; int8 weights + int8 KV teacher-forced
    top-1 agreement with the bf16 full forward >= 0.95 over >= 30 probes
    (the bf16 engine's own agreement printed beside it), and its logits
    there within ``LM_INT8_MAX_LOGIT_ERR`` of the bf16 full forward's, a
    bound that the same tree with misplaced scales must exceed. Prints prefill ms
    per (tier, bucket), decode ms a step at 8 slots (bf16, int8), tokens/s,
    kv_bytes_per_token and packed versus fp32-equivalent parameter bytes."""
    from distributed_tensorflow_tpu_torch.ckpt import restore_serving_state
    from distributed_tensorflow_tpu_torch.models.causal_lm import CausalLM, CausalLMConfig
    from distributed_tensorflow_tpu_torch.models.quant import fp32_equiv_nbytes
    from distributed_tensorflow_tpu_torch.obs.memory import tree_nbytes
    from distributed_tensorflow_tpu_torch.serve import CausalLMEngine

    cfg = cfg or CausalLMConfig(max_position=128, dtype=torch.bfloat16)  # lm_base
    t0 = time.monotonic()
    params, _, step = restore_serving_state(ckpt_dir)

    def engine(dtype, **kw):
        model = CausalLM(dataclasses.replace(cfg, dtype=dtype), device="cpu")
        return CausalLMEngine(model, dict(params), device, buckets=LM_BUCKETS, slots=LM_SLOTS,
                              max_batch=LM_TIER, max_new_tokens=LM_NEW, **kw)

    bf16 = engine(torch.bfloat16, spec_tokens=4)
    fp32 = engine(torch.float32, spec_tokens=4)
    setup_s = time.monotonic() - t0
    requests = _lm_requests(cfg.vocab_size, n_requests, cfg.max_position)
    violations = {}
    out = {"phase": "serve_lm", "ckpt_step": step, "setup_seconds": setup_s,
           "requests": len(requests),
           "new_tokens": sum(r["budget"] for r in requests)}

    t1 = time.monotonic()
    s_bf16 = _generate(bf16, requests)
    out["generate_seconds_bf16"] = time.monotonic() - t1
    s_fp32 = _generate(fp32, requests)
    rows, bad = _greedy_against_full_forward(bf16, requests, s_bf16, torch, exact=False)
    out["bf16_greedy_divergences"] = rows
    violations["bf16_greedy"] = bad
    rows, bad = _greedy_against_full_forward(fp32, requests, s_fp32, torch, exact=True)
    out["fp32_greedy_divergences"] = rows
    violations["fp32_greedy"] = bad
    for name, eng, first in (("bf16", bf16, s_bf16), ("fp32", fp32, s_fp32)):
        again = _generate(eng, requests)
        violations[f"run_to_run_{name}"] = [i for i in first if again[i] != first[i]]
    # A request alone runs its prefill at tier 1 and its own bucket; in
    # flight, at the tier and bucket of its admission group. The fp32
    # streams must not move; bf16 is measured (the products' rounding
    # differs with their shapes, and a sampled draw can sit that close).
    sampled = [r for r in requests if r["temperature"]]
    for name, eng, mid in (("fp32", fp32, s_fp32), ("bf16", bf16, s_bf16)):
        solo = {r["id"]: _generate(eng, [r])[r["id"]] for r in sampled}
        out[f"solo_vs_mid_flight_{name}_differing"] = [i for i, s in solo.items()
                                                      if s != mid[i]]
    violations["solo_vs_mid_flight_fp32"] = out["solo_vs_mid_flight_fp32_differing"]
    chunked = engine(torch.float32, prefill_chunk=32)
    s_chunk = _generate(chunked, requests, chunk=32)
    violations["chunked_vs_monolithic_fp32"] = [i for i in s_fp32 if s_chunk[i] != s_fp32[i]]
    del chunked
    out["verify_fp32"] = _verify_against_decode(fp32, requests, torch)
    out["verify_bf16"] = _verify_against_decode(bf16, requests, torch)
    if out["verify_fp32"]["argmax_mismatches"] or not out["verify_fp32"]["cell_matches_decode"]:
        violations["verify_fp32"] = [out["verify_fp32"]]
    prefix = engine(torch.bfloat16, prefix_cache_mb=64, block_tokens=16, prefill_chunk=32,
                    kv_transfer=True, stream_migrate=True)
    out["prefix"] = _prefix_round_trip(prefix, requests, torch)
    violations["prefix"] = [k for k, v in out["prefix"].items() if v is False]
    del prefix
    int8 = engine(torch.bfloat16, weight_dtype="int8", kv_dtype="int8")
    probes = _teacher_forced_probes(bf16.model, cfg.vocab_size, torch)
    agreement, missed = _teacher_forced(int8, probes)
    out["int8_top1_agreement"], out["int8_probes"] = agreement, len(probes)
    out["int8_missed_ref_gaps"] = missed
    # The control on the same probes: the bf16 engine itself.
    out["bf16_engine_agreement"] = _teacher_forced(bf16, probes)
    if agreement < 0.95 or len(probes) < 30:
        violations["int8_agreement"] = [agreement, len(probes)]
    # The logits themselves against the bf16 full forward: the int8 engine
    # within the bound, the bf16 engine beside it, and a planted fault (the
    # same packed tree, its scales on the wrong rows) outside it: the
    # bound can fail.
    fault = CausalLMEngine(CausalLM(cfg, device="cpu"), _misplace_scales(int8.params), device,
                           buckets=LM_BUCKETS, slots=LM_SLOTS, max_batch=LM_TIER,
                           max_new_tokens=LM_NEW, kv_dtype="int8")
    out["logit_err"] = {name: _logit_error(eng, bf16.model, probes, torch)
                        for name, eng in (("int8", int8), ("bf16", bf16),
                                          ("int8_planted_fault", fault))}
    del fault
    out["logit_err_bound"] = LM_INT8_MAX_LOGIT_ERR
    if out["logit_err"]["int8"]["max_abs"] > LM_INT8_MAX_LOGIT_ERR:
        violations["int8_logits"] = [out["logit_err"]["int8"]]
    if out["logit_err"]["int8_planted_fault"]["max_abs"] <= LM_INT8_MAX_LOGIT_ERR:
        violations["int8_planted_fault_passed"] = [out["logit_err"]["int8_planted_fault"]]
    out["timing_bf16"] = _time_lm(bf16, cfg.vocab_size, torch)
    out["timing_int8"] = _time_lm(int8, cfg.vocab_size, torch)
    out["kv_bytes_per_token"] = {"bf16": bf16.kv_bytes_per_token(),
                                 "int8": int8.kv_bytes_per_token()}
    out["param_bytes"] = {"int8_packed": tree_nbytes(int8.params),
                          "int8_fp32_equiv": fp32_equiv_nbytes(int8.params),
                          "bf16_engine": tree_nbytes(bf16.params)}
    out["violations"] = {k: v for k, v in violations.items() if v}
    emit(out)
    check(not out["violations"], f"serve_lm: {out['violations']}")
    return out


class _DecodeTimer:
    """An engine seen through its decode steps: the host time each decode
    dispatch takes (enqueueing the cell's launches), and the time from a
    dispatch to its fetch (``_generate`` fetches every step before the
    next, so there this is its ms a step)."""

    def __init__(self, engine):
        self._engine, self.dispatch_ms, self.step_ms, self._t0 = engine, [], [], {}

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def decode(self, *args):
        t0 = time.monotonic()
        handle = self._engine.decode(*args)
        self.dispatch_ms.append((time.monotonic() - t0) * 1e3)
        self._t0[id(handle)] = t0
        return handle

    def fetch_step(self, handle):
        out = self._engine.fetch_step(handle)
        t0 = self._t0.pop(id(handle), None)
        if t0 is not None:
            self.step_ms.append((time.monotonic() - t0) * 1e3)
        return out


def _payload(r: dict) -> dict:
    return {"input_ids": r["input_ids"], "max_new_tokens": r["budget"],
            "temperature": r["temperature"], "seed": r["seed"]}


def _serve(client, requests, n_threads: int = 1) -> tuple[dict, list, float]:
    """Every request through ``client`` (``n_threads`` submitters, or all
    submitted at once from this thread); returns ``({id: tokens},
    [per-request phases], wall seconds)``."""
    t0 = time.monotonic()
    if n_threads > 1:
        out, errs = {}, []

        def worker(part):
            try:
                for r in part:
                    fut = client.submit(_payload(r))
                    out[r["id"]] = (fut.result(timeout=300), fut.phases)
            except Exception as e:  # noqa: BLE001 — reported below
                errs.append(e)

        threads = [threading.Thread(target=worker, args=(requests[i::n_threads],))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        check(not errs, f"batcher submitters failed: {errs[:2]}")
    else:
        futs = [(r["id"], client.submit(_payload(r))) for r in requests]
        out = {i: (f.result(timeout=300), f.phases) for i, f in futs}
    wall = time.monotonic() - t0
    return ({i: res["tokens"] for i, (res, _) in out.items()},
            [dict(ph, n_tokens=res["n_tokens"]) for res, ph in out.values()], wall)


def _batcher_rates(phases: list, wall: float) -> dict:
    """Tokens a second over the run, ms a decode step (each request's
    decode phase over its decode steps, median over requests) and the
    exact TTFT percentiles (queue wait + prefill, per request)."""
    steps = [p["decode"] / (p["n_tokens"] - 1) * 1e3 for p in phases if p["n_tokens"] > 1]
    ttft = [(p["queue_wait"] + p["prefill"]) * 1e3 for p in phases]
    return {"tokens_per_s": sum(p["n_tokens"] for p in phases) / wall,
            "decode_ms_a_step": statistics.median(steps), "wall_s": wall,
            "ttft_ms_p50": float(np.percentile(ttft, 50)),
            "ttft_ms_p99": float(np.percentile(ttft, 99))}


def _prefix_requests(vocab: int, n: int = 12, head: int = 64, max_position: int = 128,
                     seed: int = 41):
    """``n`` seeded prompts sharing a ``head``-token prefix, tails of 1-40
    tokens, every other one sampled; budgets fill the cache pages."""
    rng = np.random.default_rng(SEED + seed)
    shared = rng.integers(4, vocab, head)
    out = []
    for i in range(n):
        ids = np.concatenate([shared, rng.integers(4, vocab, int(rng.integers(1, 41)))])
        out.append({"id": 1000 + i, "input_ids": ids, "temperature": 0.8 if i % 2 else 0.0,
                    "seed": 300 + i, "budget": min(LM_NEW, max_position - len(ids))})
    return out


def _preempt_requests(vocab: int, n_victims: int):
    """``n_victims`` priority-2 requests of 33-64 tokens with full budgets
    (every other one sampled), then one priority-0 request."""
    rng = np.random.default_rng(SEED + 43)
    out = [{"id": 2000 + i, "input_ids": rng.integers(4, vocab, int(rng.integers(33, 65))),
            "temperature": 0.8 if i % 2 else 0.0, "seed": 400 + i, "budget": LM_NEW,
            "priority": 2} for i in range(n_victims)]
    out.append({"id": 2000 + n_victims, "input_ids": rng.integers(4, vocab, 20),
                "temperature": 0.0, "seed": 0, "budget": 8, "priority": 0})
    return out


def _draftable_requests(engine, vocab: int, n: int = 4):
    """Prompts the n-gram drafter has proposals for, so the verify path
    runs: a 12-token segment three times and its first 4 tokens again
    (the drafter proposes the segment's next tokens), and the model's own
    greedy continuation ``c`` embedded after a marker ``t`` with the prompt
    ending in ``t`` (re-run to a fixed point, at most 4 times: the
    drafter then proposes ``c``). Greedy and sampled in turn."""
    rng = np.random.default_rng(SEED + 53)
    out = []
    for i in range(n):
        if i % 2 == 0:
            seg = rng.integers(4, vocab, 12)
            ids = np.concatenate([seg, seg, seg, seg[:4]])
        else:
            x, t = (int(v) for v in rng.integers(4, vocab, 2))
            probe = {"id": 0, "input_ids": rng.integers(4, vocab, 12), "temperature": 0.0,
                     "seed": 0, "budget": 8}
            c = _generate(engine, [probe])[0]
            for _ in range(4):
                ids = np.array([x, t, *c, *rng.integers(4, vocab, 6), t])
                c2 = _generate(engine, [dict(probe, input_ids=ids)])[0]
                if c2 == c:
                    break
                c = c2
        out.append({"id": 4000 + i, "input_ids": ids, "temperature": 0.8 if i >= 2 else 0.0,
                    "seed": 500 + i, "budget": LM_NEW})
    return out


def _spawn_serve_cli(ckpt_dir: Path, device: str, extra: list, log: Path):
    """``python -m distributed_tensorflow_tpu_torch.cli.serve --config
    lm_base`` as a server process (output in ``log``); returns ``(proc,
    base_url, start_time)``. The caller stops it (:func:`_stop`)."""
    port = _free_port()
    with open(log, "w") as fh:
        proc = subprocess.Popen(
            [sys.executable, "-m", "distributed_tensorflow_tpu_torch.cli.serve",
             "--config", "lm_base", "--ckpt-dir", str(ckpt_dir), "--device", device,
             "--port", str(port), "--buckets", *map(str, LM_BUCKETS), "--slots", str(LM_SLOTS),
             "--max-batch", str(LM_TIER), "--batch-tiers", "1", "2", "4",
             "--max-new-tokens", str(LM_NEW), *extra],
            cwd=ROOT, env=_repo_env(), stdout=fh, stderr=subprocess.STDOUT)
    return proc, f"http://127.0.0.1:{port}", time.monotonic()


def _await_serve_cli(proc, base: str, t0: float, log: Path) -> float:
    """Wait until the server's ``/healthz`` answers 200, at most 300 s from
    ``t0``; returns the seconds from ``t0``. Stops it on failure."""
    try:
        while True:
            check(proc.poll() is None,
                  f"cli.serve exited {proc.returncode}:\n{log.read_text()[-4000:]}")
            check(time.monotonic() - t0 < 300, "cli.serve not ready within 300 s")
            try:
                with urllib.request.urlopen(base + "/healthz", timeout=5) as resp:
                    if resp.status == 200:
                        break
            except OSError:
                time.sleep(0.5)
    except BaseException:
        _stop(proc)
        raise
    return time.monotonic() - t0


def _stop(proc) -> None:
    if proc.poll() is None:
        proc.terminate()
    try:
        proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=30)


def _post_generates(base: str, reqs: list) -> tuple[dict, float]:
    """Every request as one concurrent ``POST /v1/generate``; returns
    ``({id: (status, body)}, seconds)``, a status of None when the
    connection failed."""
    replies = {}

    def post(r):
        req = urllib.request.Request(
            base + "/v1/generate", headers={"Content-Type": "application/json"},
            data=json.dumps({**_payload(r), "input_ids": r["input_ids"].tolist()}).encode())
        try:
            with urllib.request.urlopen(req, timeout=300) as resp:
                replies[r["id"]] = (resp.status, json.loads(resp.read()))
        except urllib.error.HTTPError as e:
            body = e.read().decode()
            try:
                replies[r["id"]] = (e.code, json.loads(body))
            except ValueError:
                replies[r["id"]] = (e.code, {"error": body[:500]})
        except OSError as e:
            replies[r["id"]] = (None, {"error": repr(e)[:500]})

    t0 = time.monotonic()
    threads = [threading.Thread(target=post, args=(r,)) for r in reqs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    return replies, time.monotonic() - t0


def _serve_cli_lm(server: tuple, vocab: int) -> dict:
    """``cli.serve --config lm_base`` as a server process (``server``, from
    :func:`_spawn_serve_cli`, once it is ready): 16 concurrent ``POST
    /v1/generate``, every reply 200 with ``n_tokens`` equal to its budget,
    and the prom text's decode families. The process is stopped before this
    returns."""
    proc, base, t0 = server
    ready_s = _await_serve_cli(proc, base, t0, ROOT / "build" / "chip_smoke_serve_lm.log")
    try:
        reqs = _lm_requests(vocab, 16)
        replies, burst_s = _post_generates(base, reqs)
        bad = {i: rep for i, rep in replies.items() if rep[0] != 200}
        check(len(replies) == 16 and not bad, f"cli.serve /v1/generate: {bad or len(replies)}")
        short = [r["id"] for r in reqs if replies[r["id"]][1]["n_tokens"] != r["budget"]]
        check(not short, f"cli.serve: n_tokens off budget for {short}")
        with urllib.request.urlopen(base + "/metrics?format=prom", timeout=30) as resp:
            prom = resp.read().decode()
        missing = [f for f in ("serve_ttft", "serve_tokens_total", "serve_kv_bytes_per_token")
                   if f not in prom]
        check(not missing, f"cli.serve prom text lacks {missing}")
        with urllib.request.urlopen(base + "/statusz", timeout=30) as resp:
            status = json.loads(resp.read())["batcher"]
        check(status["mode"] == "continuous" and status["served"] == 16,
              f"cli.serve statusz {status}")
    finally:
        _stop(proc)
    return {"ready_s": ready_s, "burst_s": burst_s,
            "tokens": sum(rep[1]["n_tokens"] for rep in replies.values())}


def phase_serve_lm_batcher(torch, ckpt_dir: Path, *, device="cuda", cfg=None, n_requests=24,
                           cli_extra=()):
    """The decode engine behind the continuous batcher, on the resumed
    ``lm_base`` checkpoint (buckets 64/128, 8 slots, tiers 1/2/4, 32 new
    tokens). Checks, each against the direct driver :func:`_generate` on
    an fp32 engine (one request's stream does not depend on its batchmates
    in fp32; bf16 is not batch-invariant, so bf16 is measured only):

    - 24 seeded requests (half sampled at 0.8) through ``Client``
      (``max_in_flight=2``) from 8 threads: every stream equal;
    - the same plus 4 prompts the drafter has proposals for
      (:func:`_draftable_requests`) through an engine with
      ``spec_tokens=4``: equal, and drafts were verified;
    - 12 requests sharing a 64-token prefix through the prefix cache (one
      first, then 11 at once): hit tokens > 0 on ``/statusz`` and equal
      streams;
    - ``sched="edf", preempt=True``: 8 priority-2 requests fill the slots,
      a priority-0 request with a 1 ms deadline parks at least one of
      them; every stream, the parked ones' included, equal;
    - ``cli.serve --config lm_base`` as a server process: 16 concurrent
      ``/v1/generate`` all 200, ``n_tokens`` equal to each budget, the prom
      text's ``ttft``, ``tokens`` and ``kv_bytes_per_token`` families.

    Prints bf16 tokens/s and ms a decode step through the batcher under
    continuous admission (``max_in_flight`` 2 and 1) and flush admission,
    beside ``_generate``'s, on 16 requests at 8 live slots, with the host
    ms each decode dispatch takes (:class:`_DecodeTimer`); TTFT p50/p99;
    tokens a step with speculation; the prefix hit rate; the seconds."""
    from distributed_tensorflow_tpu_torch.ckpt import restore_serving_state
    from distributed_tensorflow_tpu_torch.models.causal_lm import CausalLM, CausalLMConfig
    from distributed_tensorflow_tpu_torch.serve import (
        BatcherConfig,
        CausalLMEngine,
        Client,
        build_http_server,
    )

    cfg = cfg or CausalLMConfig(max_position=128, dtype=torch.bfloat16)  # lm_base
    t0 = time.monotonic()
    # The server process loads while the in-process checks run.
    cli_server = _spawn_serve_cli(ckpt_dir, device, list(cli_extra),
                                  ROOT / "build" / "chip_smoke_serve_lm.log")
    try:
        params, _, step = restore_serving_state(ckpt_dir)

        def engine(dtype, **kw):
            model = CausalLM(dataclasses.replace(cfg, dtype=dtype), device="cpu")
            return CausalLMEngine(model, dict(params), device, buckets=LM_BUCKETS, slots=LM_SLOTS,
                                  max_batch=LM_TIER, max_new_tokens=LM_NEW, **kw)

        def client(eng, admission="continuous", max_in_flight=2, **kw):
            return Client(eng, BatcherConfig(max_batch=LM_TIER, max_in_flight=max_in_flight,
                                             max_queue=64, **kw), admission=admission)

        vocab = cfg.vocab_size
        requests = _lm_requests(vocab, n_requests, cfg.max_position)
        prefix_reqs = _prefix_requests(vocab, max_position=cfg.max_position)
        preempt_reqs = _preempt_requests(vocab, LM_SLOTS)
        out = {"phase": "serve_lm_batcher", "ckpt_step": step, "requests": len(requests)}
        violations = {}

        fp32 = engine(torch.float32)
        draftable = _draftable_requests(fp32, vocab)
        want = _generate(fp32, requests + prefix_reqs + preempt_reqs + draftable)
        with client(fp32) as c:
            got, phases, wall = _serve(c, requests, n_threads=8)
        violations["client_fp32"] = [i for i in got if got[i] != want[i]]
        out["fp32"] = _batcher_rates(phases, wall)

        spec = engine(torch.float32, spec_tokens=4)
        with client(spec) as c:
            got, _, _ = _serve(c, requests + draftable, n_threads=8)
            st = c.batcher.status()
        violations["spec_fp32"] = [i for i in got if got[i] != want[i]]
        if not st["speculation"]["draft_tokens"]:
            violations["spec_drafts"] = [st["speculation"]]
        out["spec"] = {"tokens_per_step": st["tokens_per_step"],
                       **{k: st["speculation"][k] for k in ("draft_tokens", "accepted_tokens",
                                                            "rejects", "acceptance_rate")}}
        del spec

        prefix = engine(torch.float32, prefix_cache_mb=64, block_tokens=16, prefill_chunk=32)
        c = client(prefix)
        server = build_http_server(c, port=0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            got, _, _ = _serve(c, prefix_reqs[:1])
            more, _, _ = _serve(c, prefix_reqs[1:])
            got.update(more)
            with urllib.request.urlopen("http://{}:{}/statusz".format(*server.server_address),
                                        timeout=30) as resp:
                pc = json.loads(resp.read())["batcher"]["prefix_cache"]
        finally:
            server.shutdown()
            server.server_close()
            c.close()
            thread.join(timeout=10)
        violations["prefix_fp32"] = [i for i in got if got[i] != want[i]]
        if not pc["tokens_saved"] > 0:
            violations["prefix_hits"] = [pc]
        out["prefix_cache"] = pc

        with client(prefix, sched="edf", preempt=True, preempt_margin_ms=20.0) as c:
            futs = {r["id"]: c.submit({**_payload(r), "priority": r["priority"]})
                    for r in preempt_reqs[:-1]}
            deadline = time.monotonic() + 120
            while c.batcher.status()["slots_active"] < LM_SLOTS:
                check(time.monotonic() < deadline, "preempt: the victims never filled the slots")
                time.sleep(0.002)
            urgent = preempt_reqs[-1]
            futs[urgent["id"]] = c.submit({**_payload(urgent), "priority": 0, "deadline_ms": 1})
            got = {i: f.result(timeout=300)["tokens"] for i, f in futs.items()}
            sched = c.batcher.status()["sched"]
        violations["preempt_fp32"] = [i for i in got if got[i] != want[i]]
        if sched["preempt_parked"] < 1 or sched["preempt_resumed"] != sched["preempt_parked"]:
            violations["preempt_parked"] = [sched]
        out["preempt"] = {k: sched[k] for k in ("preempt_parked", "preempt_resumed",
                                                "preempt_aborted")}
        del prefix, fp32

        # bf16 timing: 16 requests of 33-64 tokens, 32 new each, so all 8
        # slots stay live; a warm-up run first.
        rng = np.random.default_rng(SEED + 47)
        timing = [{"id": 3000 + i, "input_ids": rng.integers(4, vocab, int(rng.integers(33, 65))),
                   "temperature": 0.0, "seed": 0, "budget": LM_NEW} for i in range(2 * LM_SLOTS)]
        bf16 = engine(torch.bfloat16)
        rates = {}
        for name, kw in (("warmup", {}), ("continuous", {}),
                         ("continuous_in_flight_1", {"max_in_flight": 1}),
                         ("flush", {"admission": "flush"})):
            timed = _DecodeTimer(bf16)
            with client(timed, **kw) as c:
                _, phases, wall = _serve(c, timing)
            rates[name] = {**_batcher_rates(phases, wall),
                           "dispatch_ms": statistics.median(timed.dispatch_ms)}
        del rates["warmup"]
        timed = _DecodeTimer(bf16)
        t1 = time.monotonic()
        streams = _generate(timed, timing)
        wall = time.monotonic() - t1
        rates["generate"] = {"tokens_per_s": sum(map(len, streams.values())) / wall,
                             "decode_ms_a_step": statistics.median(timed.step_ms), "wall_s": wall,
                             "dispatch_ms": statistics.median(timed.dispatch_ms)}
        out["bf16_16_requests_8_slots"] = rates
        del bf16, timed
    except BaseException:
        _stop(cli_server[0])
        raise
    out["cli"] = _serve_cli_lm(cli_server, vocab)
    out["seconds"] = time.monotonic() - t0
    out["violations"] = {k: v for k, v in violations.items() if v}
    emit(out)
    check(not out["violations"], f"serve_lm_batcher: {out['violations']}")
    return out


def phase_serve_bert_int8(fm, torch):
    """BERT-base at 512 positions in bf16 (``phase_serve``'s checkpoint)
    served with ``weight_dtype="int8"``: restored packed, behind ``Client``,
    8 requests of 257-512 tokens in bucket 512. Checks: 12 ``flash_fwd``
    launches a forward; finite answers; pred_ids agreement with the bf16
    engine on the same requests and the max |score difference| within
    ``BERT_INT8_*``, bounds that the same tree with misplaced scales must
    break. Prints ms a batch of 8 for both."""
    from distributed_tensorflow_tpu_torch import ckpt
    from distributed_tensorflow_tpu_torch.models.bert import BertConfig, BertForPreTraining
    from distributed_tensorflow_tpu_torch.models.quant import fp32_equiv_nbytes
    from distributed_tensorflow_tpu_torch.obs.memory import tree_nbytes
    from distributed_tensorflow_tpu_torch.serve import (
        BatcherConfig,
        BertInferenceEngine,
        Client,
    )

    cfg = BertConfig(dtype=torch.bfloat16)
    ckpt_dir = ROOT / "build" / "chip_smoke_ckpt"
    params, _, _ = ckpt.restore_serving_state(ckpt_dir, weight_dtype="int8",
                                              num_heads=cfg.num_heads)
    kw = dict(buckets=(512,), max_batch=8, batch_tiers=(1, 8))
    engine = BertInferenceEngine(BertForPreTraining(cfg, device="cpu"), params, "cuda", **kw)
    check(engine.weight_dtype == "int8", f"weight_dtype {engine.weight_dtype}")
    rng = np.random.default_rng(SEED + 5)
    payloads = []
    for n in rng.integers(257, 513, 8):
        ids = rng.integers(5, cfg.vocab_size, int(n))
        payloads.append({"input_ids": ids, "mlm_targets": ids})
    with Client(engine, BatcherConfig(max_batch=8, max_delay_ms=50.0)) as client:
        fm.reset_launch_counts()
        results = [f.result(timeout=300) for f in [client.submit(p) for p in payloads]]
        launches = fm.LAUNCHES["flash_fwd"]
        forwards = sum(client.metrics.bucket_hits.snapshot().values())
    check(launches == 12 * forwards and forwards >= 1,
          f"{launches} flash_fwd launches for {forwards} forwards")
    check(all(np.isfinite(r["embedding"]).all() and r["score"] is not None
              and np.isfinite(r["score"]) for r in results), "int8 answers")
    ref_params, _, _ = ckpt.restore_serving_state(ckpt_dir)
    ref = BertInferenceEngine(BertForPreTraining(cfg, device="cpu"), ref_params, "cuda", **kw)
    ref_results = ref.run_batch(payloads)
    total = sum(len(p["input_ids"]) for p in payloads)

    def against_bf16(got):
        return {"pred_agreement": sum(int((a["pred_ids"] == b["pred_ids"]).sum())
                                      for a, b in zip(got, ref_results)) / total,
                "max_score_diff": max(abs(a["score"] - b["score"])
                                      for a, b in zip(got, ref_results))}

    def within(r):
        return (r["pred_agreement"] >= BERT_INT8_MIN_PRED_AGREEMENT
                and r["max_score_diff"] <= BERT_INT8_MAX_SCORE_DIFF)

    # A planted fault (the same packed tree, its scales on the wrong rows)
    # must fall outside the bounds that the int8 engine keeps.
    fault = BertInferenceEngine(BertForPreTraining(cfg, device="cpu"),
                                _misplace_scales(engine.params), "cuda", **kw)
    sound, planted = against_bf16(results), against_bf16(fault.run_batch(payloads))
    del fault

    def batch_ms(eng):
        eng.run_batch(payloads)
        times = []
        for _ in range(5):
            t0 = time.monotonic()
            eng.run_batch(payloads)
            times.append((time.monotonic() - t0) * 1e3)
        return statistics.median(times)

    out = {"phase": "serve_bert_int8", "flash_fwd_launches": launches, "forwards": forwards,
           "against_bf16": sound, "planted_fault_against_bf16": planted,
           "bounds": {"min_pred_agreement": BERT_INT8_MIN_PRED_AGREEMENT,
                      "max_score_diff": BERT_INT8_MAX_SCORE_DIFF},
           "batch8_ms_int8": batch_ms(engine), "batch8_ms_bf16": batch_ms(ref),
           "param_bytes_int8": tree_nbytes(engine.params),
           "param_bytes_fp32_equiv": fp32_equiv_nbytes(engine.params)}
    emit(out)
    check(within(sound), f"int8 BERT against bf16: {sound}")
    check(not within(planted), f"a planted scale fault passed the int8 bounds: {planted}")
    return launches


def phase_serve_image(torch):
    """``cli.serve --config imagenet_resnet50 --image-size 64 --selftest 16``
    from ``train_cli_image``'s checkpoint (a subprocess, on the card), then
    the same client in this process behind the HTTP server and one ``POST
    /v1/classify``: its top-5 ids equal a plain eval forward of the
    restored model on the same image (same card, same shape), probabilities
    within 1e-3. Prints ms a batch per tier."""
    from distributed_tensorflow_tpu_torch import ckpt
    from distributed_tensorflow_tpu_torch.cli.serve import (
        PRESETS,
        build_serving_client,
        make_parser,
    )
    from distributed_tensorflow_tpu_torch.models import ResNet50
    from distributed_tensorflow_tpu_torch.serve import build_http_server

    ckpt_dir = ROOT / "build" / "chip_smoke_image"
    flags = ["--config", "imagenet_resnet50", "--ckpt-dir", str(ckpt_dir), "--image-size", "64"]
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "distributed_tensorflow_tpu_torch.cli.serve", *flags,
         "--selftest", "16"],
        cwd=ROOT, env=_repo_env(), capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"cli.serve exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    snapshot = json.loads(proc.stdout)
    check(snapshot["requests"] == 16, f"selftest served {snapshot['requests']}")
    selftest_s = time.monotonic() - t0
    client, _ = build_serving_client(PRESETS["imagenet_resnet50"], make_parser().parse_args(flags))
    server = build_http_server(client, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    img = np.random.default_rng(SEED + 7).standard_normal((64, 64, 3)).astype(np.float32)
    try:
        req = urllib.request.Request(
            "http://{}:{}/v1/classify".format(*server.server_address),
            data=json.dumps({"image": img.tolist()}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            check(resp.status == 200, f"/v1/classify status {resp.status}")
            body = json.loads(resp.read())
        engine = client.engine
        tiers = {}
        for T in engine.batch_tiers:
            batch = [{"image": img}] * T
            engine.run_batch(batch)
            times = []
            for _ in range(5):
                t1 = time.monotonic()
                engine.run_batch(batch)
                times.append((time.monotonic() - t1) * 1e3)
            tiers[T] = statistics.median(times)
    finally:
        server.shutdown()
        server.server_close()
        client.close()
        thread.join(timeout=10)
    params, state, _ = ckpt.restore_serving_state(ckpt_dir)
    model = ResNet50(dtype=torch.bfloat16, device="cuda")
    model.load_state_dict(params)
    stats = {k: v.cuda() for k, v in state["batch_stats"].items()}
    with torch.inference_mode():
        logits, _ = model.eval()(torch.from_numpy(img).cuda()[None], stats, train=False)
        want = torch.softmax(logits.float(), -1).topk(5)
    check(body["top_ids"] == want.indices[0].tolist(),
          f"/v1/classify {body['top_ids']} vs eval forward {want.indices[0].tolist()}")
    err = float(np.abs(np.asarray(body["top_probs"]) - want.values[0].cpu().numpy()).max())
    check(err <= 1e-3, f"top_probs differ by {err}")
    emit({"phase": "serve_image", "selftest_seconds": selftest_s, "top_ids": body["top_ids"],
          "top_probs_max_err": err, "batch_ms_per_tier": tiers})


FUSED = tuple(RESNET50_LAUNCHES["fused"])
RESILIENT_STEPS, RESILIENT_CKPT_EVERY, RESILIENT_SIGTERM_AT = 12, 4, 9
CHAOS_STEPS = 12
CLI_TERM_STEPS = 200  # bounds the CLI run that is sent SIGTERM after its step 3


@contextlib.contextmanager
def _deterministic(torch):
    """Deterministic cuDNN algorithms (``scripts/torch_dp_train.py``'s
    ``numerics``: bitwise repeatable steps) for one phase, then the
    settings as they were; TF32 stays off throughout the smoke."""
    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark)
    load_dp_train().numerics()
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = saved


def _counted(step, per_step: list):
    """``step`` that appends each call's fused-kernel launches to
    ``per_step`` (the counters move on the host, at each launch)."""
    from distributed_tensorflow_tpu_torch.ops import fused_conv_bn as fcb

    def run(state, batch, rng):
        before = {k: fcb.LAUNCHES.get(k, 0) for k in FUSED}
        out = step(state, batch, rng)
        per_step.append({k: fcb.LAUNCHES.get(k, 0) - before[k] for k in FUSED})
        return out

    return run


def _tree_diff(a: dict, b: dict, torch) -> list:
    """Names of the leaves of two flat tensor dicts that differ."""
    if a.keys() != b.keys():
        return ["<keys>"]
    return [k for k in a if not torch.equal(a[k], b[k])]


def _compare_states(got, want, torch, what: str) -> None:
    """Params, momentum slots and BatchNorm statistics, bit for bit."""
    dp = load_dp_train()
    params = _tree_diff({k: v.detach() for k, v in got.params.items()},
                         {k: v.detach() for k, v in want.params.items()}, torch)
    stats = _tree_diff(got.model_state["batch_stats"], want.model_state["batch_stats"], torch)
    gs, ws = dp.slots(got), dp.slots(want)
    slots = [k for k in ws if k not in gs or gs[k].keys() != ws[k].keys()
             or not all(torch.equal(gs[k][n], t) for n, t in ws[k].items())]
    check(not params and not stats and not slots and gs.keys() == ws.keys(),
          f"{what}: differs from the uninterrupted run at params {params[:4]}, "
          f"batch_stats {stats[:4]}, momentum {slots[:4]}")


def _check_launches(per_step: list, what: str, on_card: bool) -> int:
    want = {k: 29 for k in FUSED} if on_card else {k: 0 for k in FUSED}
    bad = [i for i, got in enumerate(per_step) if got != want]
    check(per_step and not bad, f"{what}: fused launches a step {per_step[bad[0]] if bad else []}"
                                f" at step calls {bad[:4]}, expected {want}")
    return len(per_step)


def phase_train_resilient_fused(torch, *, device="cuda", rows=128, hw=224) -> dict:
    """Full-width ResNet-50 ``fused`` (the train_resnet50 recipe) through
    ``run_resilient`` with a ``Checkpointer`` every 4 steps over
    ``prefetch(device_batches(..., start_step=s))``, under a fault plan:
    ``feeder_error`` at stream index 2 (a restart from the step-0
    checkpoint), ``ckpt_write_error`` at 4 (absorbed by the retry),
    ``slow_step`` at 5, ``nonfinite_loss`` at 6 (``nonfinite="skip"``), and
    a SIGTERM a hook sends this process after step 9. Checks: one restart,
    preempted, the newest checkpoint at the final step; a fresh model
    resumed from it to step 12; every logged loss but the poisoned one,
    and the final params, momentum and BatchNorm statistics, bit for bit
    those of an uninterrupted ``fit`` from the same step-0 checkpoint
    (deterministic cuDNN for this part); 29 launches of each fused kernel
    in every step of every segment; every injected event in the flight
    recorder's dump. Before that, with the smoke's usual numerics: ms a
    step with and without a ``StepTimeline`` on batches on the card (two
    pairs of 5-step runs, ``scripts/torch_timeline_cost.py``), and one
    checkpoint's snapshot and write ms and bytes. Prints the restart's
    seconds from the fault to the end of the first step after it."""
    import signal

    from distributed_tensorflow_tpu_torch.ckpt import Checkpointer
    from distributed_tensorflow_tpu_torch.data.loader import device_batches
    from distributed_tensorflow_tpu_torch.data.prefetch import prefetch
    from distributed_tensorflow_tpu_torch.data.synthetic import synthetic_image_classification
    from distributed_tensorflow_tpu_torch.obs.fleet import StepTimeline
    from distributed_tensorflow_tpu_torch.obs.flightrec import FlightRecorder
    from distributed_tensorflow_tpu_torch.ops import fused_conv_bn as fcb
    from distributed_tensorflow_tpu_torch.train import (
        FaultEvent,
        FaultInjector,
        FaultPlan,
        ResilienceConfig,
        fit,
        make_rng,
        make_train_step,
        run_resilient,
    )
    from distributed_tensorflow_tpu_torch.train.objectives import make_classification_loss

    dp = load_dp_train()
    on_card = device == "cuda"
    work = ROOT / "build" / "chip_smoke_resilient"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t0 = time.monotonic()
    data = synthetic_image_classification(4 * rows, (hw, hw, 3), 1000, seed=SEED)

    def stream(start, injector=None):
        return prefetch(device_batches(data, rows, device=device, seed=1, start_step=start), 2,
                        fault_injector=injector)

    def build():
        model, state, tx = dp.build(device)
        return state, make_train_step(make_classification_loss(model), tx)

    out = {"phase": "train_resilient_fused", "rows": rows, "image": hw}
    # ms a step with and without a timeline on batches already on the card
    # (scripts/torch_timeline_cost.py at a small count, after 2 steps of
    # warm-up), then one checkpoint of the trained state: the caller's
    # snapshot, then the write until durable.
    state, step = build()
    rng = make_rng(SEED, device)
    on_device = list(itertools.islice(device_batches(data, rows, device=device, seed=1), 2))
    fit(state, step, itertools.cycle(on_device), num_steps=2, rng=rng, log_every=2)
    out["timeline_cost"] = load_script("torch_timeline_cost").timeline_cost(
        state, step, on_device, rng, pairs=2, steps=5,
        sync=torch.cuda.synchronize if on_card else lambda: None)
    del on_device
    with Checkpointer(work / "write") as ck:
        t1 = time.perf_counter()
        ck.save(state.step, state, generator=rng)
        t2 = time.perf_counter()
        ck.wait()
        t3 = time.perf_counter()
    size = (work / "write" / f"step_{state.step:08d}.pt").stat().st_size
    out["ckpt"] = {"snapshot_ms": (t2 - t1) * 1e3, "write_ms": (t3 - t1) * 1e3, "bytes": size}
    del state, step
    if on_card:
        torch.cuda.empty_cache()

    with _deterministic(torch):
        state, step = build()
        rng = make_rng(SEED, device)
        with Checkpointer(work / "a") as ck0:
            ck0.save(0, state, generator=rng)
        shutil.copytree(work / "a", work / "b")  # the reference's origin
        rec = FlightRecorder(dump_dir=work / "dumps")
        plan = FaultPlan((FaultEvent("feeder_error", 2), FaultEvent("ckpt_write_error", 4),
                          FaultEvent("slow_step", 5, duration_s=0.05),
                          FaultEvent("nonfinite_loss", 6)))
        inj = FaultInjector(plan, recorder=rec)
        losses, wall, per_step = {}, {}, []

        def log(s, st, m):
            losses[s] = m["loss"]
            wall[s] = time.time()

        def sigterm(s, st, m):
            if s == RESILIENT_SIGTERM_AT:
                os.kill(os.getpid(), signal.SIGTERM)

        common = dict(num_steps=RESILIENT_STEPS, ckpt_every=RESILIENT_CKPT_EVERY,
                      config=ResilienceConfig(), recorder=rec, fault_injector=inj,
                      log_every=1, nonfinite="skip")
        fcb.reset_launch_counts()
        with Checkpointer(work / "a", fault_injector=inj) as ck:
            state, start = ck.restore_latest(state, generator=rng)
            check(start == 0, f"restored step {start}")
            report = run_resilient(state, _counted(step, per_step), lambda s: stream(s, inj),
                                   checkpointer=ck, rng=rng, hooks=(log, sigterm),
                                   timeline=StepTimeline(), **common)
            latest = ck.latest_step()
        check(report.restarts == 1 and report.preempted and not report.completed
              and report.final_step == RESILIENT_SIGTERM_AT == latest,
              f"resilient run: restarts {report.restarts}, preempted {report.preempted}, "
              f"final step {report.final_step}, newest checkpoint {latest}")
        first = _check_launches(per_step, "resilient run", on_card)
        check(first == 2 + RESILIENT_SIGTERM_AT, f"{first} step calls before the stop")
        del state, step, report
        # The resume: a fresh model, the run's newest checkpoint.
        state, step = build()
        rng = make_rng(SEED + 1, device)  # restored from the checkpoint
        with Checkpointer(work / "a", fault_injector=inj) as ck:
            state, start = ck.restore_latest(state, generator=rng)
            check(start == RESILIENT_SIGTERM_AT, f"resumed at {start}")
            resumed = run_resilient(state, _counted(step, per_step), lambda s: stream(s, inj),
                                    checkpointer=ck, rng=rng, hooks=(log,), **common)
            latest = ck.latest_step()
        check(resumed.completed and resumed.final_step == RESILIENT_STEPS == latest
              and resumed.restarts == 0, f"resume: {resumed.final_step}, {latest}")
        total = _check_launches(per_step, "resilient run and resume", on_card)
        launches = dict(fcb.LAUNCHES)
        dump = json.loads(Path(rec.dump("train_resilient_end", force=True)).read_text())
        # The reference: uninterrupted, no faults, from the same checkpoint.
        ref_state, ref_step = build()
        ref_rng = make_rng(SEED, device)
        ref_losses, ref_per_step = {}, []
        with Checkpointer(work / "b") as ckb:
            ref_state, _ = ckb.restore_latest(ref_state, generator=ref_rng)
        batches = stream(0)
        try:
            fit(ref_state, _counted(ref_step, ref_per_step), batches,
                num_steps=RESILIENT_STEPS, rng=ref_rng, log_every=1,
                hooks=(lambda s, st, m: ref_losses.__setitem__(s, m["loss"]),))
        finally:
            batches.close()
        _check_launches(ref_per_step, "uninterrupted run", on_card)
        poisoned = 7  # nonfinite_loss at step index 6 poisons the loss logged as step 7
        check(sorted(losses) == sorted(ref_losses) == list(range(1, RESILIENT_STEPS + 1)),
              f"logged steps {sorted(losses)}")
        check(math.isnan(losses[poisoned]) and math.isfinite(ref_losses[poisoned]),
              f"step {poisoned}: {losses[poisoned]} against {ref_losses[poisoned]}")
        differ = [s for s in losses if s != poisoned and losses[s] != ref_losses[s]]
        check(not differ, f"losses differ from the uninterrupted run at steps {differ}: "
                          f"{[(losses[s], ref_losses[s]) for s in differ[:3]]}")
        _compare_states(state, ref_state, torch, "the resumed run")
    injected = sorted(e["fault"] for e in dump["events"] if e["kind"] == "fault_injected")
    kinds = {e["kind"] for e in dump["events"]}
    check(injected == ["ckpt_write_error", "feeder_error", "nonfinite_loss", "slow_step"]
          and {"train_restart", "ckpt_save_error", "nonfinite_loss", "preempt_exit"} <= kinds,
          f"dump: injected {injected}, kinds {sorted(kinds)}")
    t_fault = next(e["t"] for e in dump["events"] if e.get("fault") == "feeder_error")
    backoff = next(e["backoff_s"] for e in dump["events"] if e["kind"] == "train_restart")
    out.update({
        "restart_s": wall[1] - t_fault, "restart_backoff_s": backoff,
        "step_calls": total, "launches": launches,
        "losses": [None if s == poisoned else losses[s] for s in range(1, RESILIENT_STEPS + 1)],
        "vs_uninterrupted": "bitwise: losses but the poisoned one, params, momentum, "
                            "batch_stats",
        "seconds": time.monotonic() - t0})
    emit(out)
    del state, step, ref_state, ref_step
    if on_card:
        torch.cuda.empty_cache()
    return out


def phase_train_chaos(torch, pad_s: float, *, rows=64, on_launched=None) -> dict:
    """``scripts/torch_dp_train.py --chaos``: two independent processes on
    the one card (no process group: beacons, checkpoints and dumps are
    their only channels), each full-width ResNet-50 ``fused`` at ``rows``
    images a step, ``CHAOS_STEPS`` steps, a checkpoint every
    ``CHAOS_CKPT_EVERY`` (4), each step padded by ``pad_s`` (the
    train_resilient_fused phase's measured write time). Rank 0's plan kills
    it by SIGKILL (``host_drop``) at ``CHAOS_HOST_DROP_AT`` (11) after a
    ``slow_step`` at 5: it must exit -9 and its dump name both events.
    Its stale beacon and the survivor's fresh one drive
    ``FleetSupervisor.poll()`` to ``re_mesh`` with ``lost_hosts == [0]``.
    Then, in this process under deterministic cuDNN, the victim's last
    durable checkpoint (at most ``CHAOS_CKPT_EVERY`` steps lost) resumes under
    ``run_resilient`` with a ``feeder_error`` at stream index 2, and its
    losses, params, momentum and BatchNorm statistics equal bit for bit an
    uninterrupted ``fit`` from the same checkpoint; 29 launches of each
    fused kernel a step, in the survivor and in both runs here.
    ``on_launched()`` is called once the two processes have ended: what
    follows here is bitwise, not timed."""
    from distributed_tensorflow_tpu_torch.ckpt import Checkpointer
    from distributed_tensorflow_tpu_torch.data.prefetch import prefetch
    from distributed_tensorflow_tpu_torch.obs.fleet import FleetSupervisor, read_beacons
    from distributed_tensorflow_tpu_torch.obs.flightrec import FlightRecorder
    from distributed_tensorflow_tpu_torch.train import (
        FaultEvent,
        FaultInjector,
        FaultPlan,
        ResilienceConfig,
        fit,
        make_rng,
        make_train_step,
        run_resilient,
    )
    from distributed_tensorflow_tpu_torch.train.objectives import make_classification_loss

    dp = load_dp_train()
    work = ROOT / "build" / "chip_smoke_chaos"
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.monotonic()
    _, survivor = _dp_launch(2, "gloo", "--chaos", str(work), "--steps", str(CHAOS_STEPS),
                             "--rows", str(rows), "--pad-s", f"{pad_s:.4f}", codes=(-9, 0))
    launch_s = time.monotonic() - t0
    if on_launched is not None:
        on_launched()
    check(survivor["step"] == survivor["latest_ckpt"] == survivor["last_step"] == CHAOS_STEPS,
          f"survivor {survivor}")
    check({k: v for k, v in survivor["launches"].items() if v}
          == {k: 29 * CHAOS_STEPS for k in FUSED}, f"survivor launches {survivor['launches']}")
    dumps = sorted((work / "dumps_0").glob("flightrec-*.json"))
    check(len(dumps) == 1, f"victim dumps {dumps}")
    payload = json.loads(dumps[0].read_text())
    injected = [e["fault"] for e in payload["events"] if e["kind"] == "fault_injected"]
    check(payload["reason"] == "host_drop" and injected == ["slow_step", "host_drop"],
          f"victim dump: {payload['reason']}, {injected}")
    beacons = {b["host"]: b for b in read_beacons(work / "beacons")}
    check(set(beacons) == {0, 1} and beacons[0]["injected_faults"] == {"slow_step": 1},
          f"beacons {sorted(beacons)}")
    t_dead, t_alive = beacons[0]["wall_time"], beacons[1]["wall_time"]
    now = t_alive + 1e-3
    verdict = FleetSupervisor(work / "beacons", expected_hosts=2,
                              heartbeat_timeout_s=0.5 * (now - t_dead), clock=lambda: now).poll()
    check(t_alive > t_dead and verdict["action"] == "re_mesh"
          and verdict["lost_hosts"] == [0] and verdict["alive_hosts"] == [1],
          f"supervisor {verdict}")

    def build():
        model, state, tx = dp.build("cuda")
        return state, make_train_step(make_classification_loss(model), tx)

    with _deterministic(torch):
        ref_state, ref_step = build()
        with Checkpointer(work / "ckpt_0") as ck:
            ref_state, start = ck.restore_latest(ref_state)
        lost = dp.CHAOS_HOST_DROP_AT - start
        check(0 <= lost <= dp.CHAOS_CKPT_EVERY,
              f"the victim's last durable checkpoint is step {start}")
        ref_losses, ref_per_step = {}, []
        batches = prefetch(dp.chaos_batches(rows, "cuda", start), 2)
        try:
            fit(ref_state, _counted(ref_step, ref_per_step), batches, num_steps=CHAOS_STEPS,
                rng=make_rng(SEED, "cuda"), log_every=1,
                hooks=(lambda s, st, m: ref_losses.__setitem__(s, m["loss"]),))
        finally:
            batches.close()
        shutil.copytree(work / "ckpt_0", work / "ckpt_resume")
        rec = FlightRecorder(dump_dir=None)
        inj = FaultInjector(FaultPlan((FaultEvent("feeder_error", 2),)), recorder=rec)
        state, step = build()
        losses, per_step = {}, []
        with Checkpointer(work / "ckpt_resume") as ck:
            state, _ = ck.restore_latest(state)
            report = run_resilient(
                state, _counted(step, per_step),
                lambda s: prefetch(dp.chaos_batches(rows, "cuda", s), 2, fault_injector=inj),
                num_steps=CHAOS_STEPS, checkpointer=ck, ckpt_every=dp.CHAOS_CKPT_EVERY,
                config=ResilienceConfig(), recorder=rec, fault_injector=inj,
                rng=make_rng(SEED, "cuda"), log_every=1,
                hooks=(lambda s, st, m: losses.__setitem__(s, m["loss"]),))
        check(report.completed and report.restarts == 1 and report.final_step == CHAOS_STEPS,
              f"resume: {report.final_step}, {report.restarts} restarts")
        kinds = [e["kind"] for e in rec.events()]
        check("fault_injected" in kinds and "train_restart" in kinds, f"resume events {kinds}")
        check(losses == ref_losses and sorted(losses) == list(range(start + 1, CHAOS_STEPS + 1)),
              f"resumed losses {losses} against {ref_losses}")
        _compare_states(state, ref_state, torch, "the chaos resume")
        _check_launches(per_step, "chaos resume", True)
        _check_launches(ref_per_step, "chaos reference", True)
    out = {"phase": "train_chaos", "rows": rows, "pad_s": pad_s, "victim_exit": -9,
           "lost_steps": lost, "resumed_from": start, "survivor_step_ms": survivor[
               "step_ms_median"], "survivor_launches": survivor["launches"],
           "launch_seconds": launch_s, "verdict": verdict["action"],
           "seconds": time.monotonic() - t0}
    emit(out)
    del state, step, ref_state, ref_step
    torch.cuda.empty_cache()
    return out


def _signal_on_line(proc, needle: str, sig, timeout: float) -> str:
    """Send ``sig`` to ``proc`` once a line of its stderr (a text pipe)
    holds ``needle``, then wait for its end; returns its stderr. A reader
    thread drains the pipe, so the deadline holds whatever the process
    prints: past ``timeout`` seconds in all, or at an end with no such
    line, the process is killed and the phase fails."""
    lines, seen = [], threading.Event()

    def read():
        for line in proc.stderr:
            lines.append(line)
            if needle in line:
                seen.set()

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    deadline = time.monotonic() + timeout
    try:
        while not seen.wait(0.05):
            check(proc.poll() is None and time.monotonic() < deadline,
                  f"no {needle!r} from the process within {timeout} s "
                  f"(exit {proc.poll()}):\n{''.join(lines)[-3000:]}")
        proc.send_signal(sig)
        proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        reader.join(timeout=10)
    return "".join(lines)


def phase_train_cli_resilient(torch) -> dict:
    """``cli.train --config imagenet_resnet50 --image-size 64 --global-batch
    16``: a process with ``--resilient`` for at most ``CLI_TERM_STEPS``
    steps, sent SIGTERM from here after its third step (exit 0,
    ``preempted`` logged, a durable checkpoint at the stop step), then a
    second launch that resumes it to two steps past it. While that one
    starts, in this process (``main`` as the ``-m`` entry calls it): with
    ``--resilient --fault-plan
    seed=7,feeder_error=1,ckpt_write_error=1,slow_step=1 --ckpt-every 1
    --beacon-dir --dump-dir --ckpt-dir`` for 5 steps (0 after one restart,
    the beacon's injected counts, no dump); with ``--nonfinite abort`` and
    ``nonfinite_loss=1`` (``NonFiniteLossError`` out of ``main``, a
    ``train_failure`` dump); ``--resilient --device-pool 4`` refused (exit
    2). Every process runs under a deadline."""
    import logging
    import signal

    from distributed_tensorflow_tpu_torch.ckpt.checkpoint import latest_step
    from distributed_tensorflow_tpu_torch.cli.train import main as train_main
    from distributed_tensorflow_tpu_torch.train import NonFiniteLossError

    work = ROOT / "build" / "chip_smoke_cli_resilient"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    base = [sys.executable, "-m", "distributed_tensorflow_tpu_torch.cli.train",
            "--config", "imagenet_resnet50", "--image-size", "64", "--global-batch", "16",
            "--lr", "0.05", "--lr-schedule", "constant", "--log-every", "1"]
    spec = "seed=7,feeder_error=1,ckpt_write_error=1,slow_step=1"
    ck = work / "ck_term"
    t0 = time.monotonic()
    term = subprocess.Popen(
        base + ["--steps", str(CLI_TERM_STEPS), "--resilient", "--ckpt-dir", str(ck)],
        cwd=ROOT, env=_repo_env(), stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    err = _signal_on_line(term, "train.loop: step 3:", signal.SIGTERM, timeout=300)
    stop = latest_step(ck)
    check(term.returncode == 0 and stop is not None and 3 <= stop < CLI_TERM_STEPS
          and f"preempted at step {stop}" in err,
          f"SIGTERM: exit {term.returncode}, checkpoint {stop}:\n{err[-3000:]}")
    log = work / "resume.log"
    with open(log, "w") as fh:
        resume = subprocess.Popen(base + ["--steps", str(stop + 2), "--resilient", "--ckpt-dir",
                                          str(ck)], cwd=ROOT, env=_repo_env(), stdout=fh,
                                  stderr=subprocess.STDOUT)
    try:
        # In this process, while the resume starts: the CLI's own logs.
        logs = io.StringIO()
        handler = logging.StreamHandler(logs)
        root = logging.getLogger()
        saved_level = root.level
        root.addHandler(handler)
        root.setLevel(logging.INFO)
        t1 = time.monotonic()
        try:
            code = train_main(base[3:] + [
                "--steps", "5", "--ckpt-every", "1", "--resilient", "--fault-plan", spec,
                "--beacon-dir", str(work / "beacons"), "--dump-dir", str(work / "dumps"),
                "--ckpt-dir", str(work / "ck")])
            nonfinite = None
            try:
                train_main(base[3:] + ["--steps", "4", "--fault-plan", "seed=3,nonfinite_loss=1",
                                       "--nonfinite", "abort", "--dump-dir",
                                       str(work / "dumps_nf")])
            except NonFiniteLossError as e:
                nonfinite = e
        finally:
            root.removeHandler(handler)
            root.setLevel(saved_level)
            torch.cuda.empty_cache()
        in_process_s = time.monotonic() - t1
        resume_code = resume.wait(timeout=600)
    finally:
        if resume.poll() is None:
            resume.kill()
            resume.wait()
    beacon = json.loads((work / "beacons" / "host_0.json").read_text())
    check(code == 0 and "restart 1 in" in logs.getvalue()
          and latest_step(work / "ck") == 5 and not list((work / "dumps").glob("*.json"))
          and beacon["injected_faults"] == {"feeder_error": 1, "ckpt_write_error": 1,
                                            "slow_step": 1} and beacon["last_step"] == 5,
          f"the faulted CLI run: {code}, beacon {beacon.get('injected_faults')} at "
          f"{beacon.get('last_step')}:\n{logs.getvalue()[-3000:]}")
    dumps = list((work / "dumps_nf").glob("flightrec-*.json"))
    check(nonfinite is not None and len(dumps) == 1
          and json.loads(dumps[0].read_text())["reason"] == "train_failure",
          f"--nonfinite abort: {nonfinite!r}, dumps {dumps}")
    resumed = log.read_text()
    check(resume_code == 0 and f"restored checkpoint at step {stop}" in resumed
          and latest_step(ck) == stop + 2,
          f"the second launch did not resume to the end (exit {resume_code}):\n"
          f"{resumed[-3000:]}")
    # The refusal is an argument check.
    err_io = io.StringIO()
    code = None
    with contextlib.redirect_stderr(err_io):
        try:
            train_main(base[3:] + ["--resilient", "--device-pool", "4"])
        except SystemExit as e:
            code = e.code
    check(code == 2 and "does not compose with --device-pool" in err_io.getvalue(),
          f"--resilient --device-pool: exit {code}")
    out = {"phase": "train_cli_resilient", "beacon_injected": beacon["injected_faults"],
           "sigterm_stop_step": stop, "in_process_seconds": in_process_s,
           "seconds": time.monotonic() - t0}
    emit(out)
    return out


SERVE_FAULT_PLAN = {"seed": None, "events": [
    {"kind": "slow_decode_step", "step": 3, "duration_s": 0.05},
    {"kind": "dispatch_error", "step": 6, "duration_s": 0.0}]}


def phase_serve_lm_faults(torch, ckpt_dir: Path, *, device="cuda", cfg=None,
                          cli_extra=()) -> dict:
    """Serving fault injection on the ``serve_lm_batcher`` checkpoint, with
    the plan ``SERVE_FAULT_PLAN`` (``slow_decode_step`` at decode step 3,
    ``dispatch_error`` at 6): an fp32 engine behind ``Client`` with the
    injector, 16 requests at once: exactly the slots of the failed step
    fail, and every other stream equals the direct driver's. Then
    ``cli.serve --config lm_base --fault-plan <that plan> --dump-dir``: 16
    concurrent ``/v1/generate``, the failed step's requests answered 500
    naming the fault, every other 200 with its full budget, the fault in
    a dump. A second server with ``replica_kill`` at step 4 dies with -9
    and leaves a dump. Both servers start first and load while the
    in-process part runs."""
    from distributed_tensorflow_tpu_torch.ckpt import restore_serving_state
    from distributed_tensorflow_tpu_torch.models.causal_lm import CausalLM, CausalLMConfig
    from distributed_tensorflow_tpu_torch.serve import BatcherConfig, CausalLMEngine, Client
    from distributed_tensorflow_tpu_torch.serve.faultinject import (
        FaultInjector,
        FaultPlan,
        InjectedFault,
    )

    cfg = cfg or CausalLMConfig(max_position=128, dtype=torch.bfloat16)  # lm_base
    work = ROOT / "build" / "chip_smoke_serve_faults"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    plans = {"faults": SERVE_FAULT_PLAN, "kill": {"seed": None, "events": [
        {"kind": "replica_kill", "step": 4, "duration_s": 0.0}]}}
    t0 = time.monotonic()
    servers = {}
    try:
        for name, plan in plans.items():
            (work / f"{name}.json").write_text(json.dumps(plan))
            servers[name] = _spawn_serve_cli(
                ckpt_dir, device, [*cli_extra, "--fault-plan", str(work / f"{name}.json"),
                                   "--dump-dir", str(work / f"dumps_{name}")],
                work / f"serve_{name}.log")

        params, _, _ = restore_serving_state(ckpt_dir)
        engine = CausalLMEngine(CausalLM(dataclasses.replace(cfg, dtype=torch.float32),
                                         device="cpu"), dict(params), device,
                                buckets=LM_BUCKETS, slots=LM_SLOTS, max_batch=LM_TIER,
                                max_new_tokens=LM_NEW)
        requests = _lm_requests(cfg.vocab_size, 16, cfg.max_position)
        want = _generate(engine, requests)
        sleeps, failed = [], []
        with Client(engine, BatcherConfig(max_batch=LM_TIER, max_in_flight=2,
                                          max_queue=64)) as c:
            c.batcher.fault_injector = FaultInjector(
                FaultPlan.from_file(work / "faults.json"),
                sleep=lambda s: (sleeps.append(s), time.sleep(s)))
            fail = c.batcher._fail_slots

            def recording(tags, exc):
                failed.append(len(tags))
                fail(tags, exc)

            c.batcher._fail_slots = recording
            futs = [(r["id"], c.submit(_payload(r))) for r in requests]
            got, errors = {}, {}
            for i, f in futs:
                try:
                    got[i] = f.result(timeout=300)["tokens"]
                except InjectedFault as e:
                    errors[i] = e
            failed_by_batcher = c.batcher.metrics.rejected_by_cause.snapshot()
        # The failed step's occupants, less any that finished on an earlier
        # step while it was planned: the batcher counts the ones it failed.
        check(sleeps == [0.05] and len(failed) == 1 and 1 <= len(errors) <= failed[0]
              and failed_by_batcher == {"engine_failure": len(errors)},
              f"in-process: sleeps {sleeps}, failed steps {failed}, errors {sorted(errors)}, "
              f"batcher {failed_by_batcher}")
        differ = [i for i in got if got[i] != want[i]]
        check(not differ and len(got) + len(errors) == 16,
              f"in-process fp32 streams differ from the direct driver's: {differ}")
        del engine
        torch.cuda.empty_cache()
        in_process = {"failed_requests": len(errors), "equal_streams": len(got)}

        proc, base, t_spawn = servers["faults"]
        ready_s = _await_serve_cli(proc, base, t_spawn, work / "serve_faults.log")
        replies, burst_s = _post_generates(base, requests)
        _stop(proc)  # its dump is on disk once it has ended
        bad = {i: rep for i, rep in replies.items() if rep[0] != 200}
        check(1 <= len(bad) <= LM_SLOTS and all(
            code == 500 and "dispatch_error" in body.get("error", "")
            for code, body in bad.values()), f"cli.serve failed requests: {bad}")
        short = [r["id"] for r in requests if r["id"] not in bad
                 and replies[r["id"]][1]["n_tokens"] != r["budget"]]
        check(not short and len(replies) == 16, f"cli.serve: n_tokens off budget for {short}")
        dumps = sorted((work / "dumps_faults").glob("flightrec-*.json"))
        faults = [e["fault"] for d in dumps for e in json.loads(d.read_text())["events"]
                  if e["kind"] == "fault_injected"]
        check("dispatch_error" in faults, f"cli.serve dumps {dumps}: faults {faults}")

        proc, base, t_spawn = servers["kill"]
        _await_serve_cli(proc, base, t_spawn, work / "serve_kill.log")
        t1 = time.monotonic()
        _post_generates(base, requests[:4])
        code = proc.wait(timeout=120)
        kill_s = time.monotonic() - t1
    finally:
        for proc, _, _ in servers.values():
            _stop(proc)
    dumps = sorted((work / "dumps_kill").glob("flightrec-*.json"))
    check(code == -9 and len(dumps) == 1
          and json.loads(dumps[0].read_text())["reason"] == "replica_kill",
          f"replica_kill: exit {code}, dumps {dumps}")
    out = {"phase": "serve_lm_faults", "in_process_fp32": in_process,
           "cli_failed_requests": len(bad), "cli": {"ready_s": ready_s, "burst_s": burst_s},
           "replica_kill_exit": code, "replica_kill_seconds": kill_s,
           "seconds": time.monotonic() - t0}
    emit(out)
    return out


# The depth of the model-parallel training layouts: BERT-base's widths at
# 2 of its 12 layers (the depth cuts that pay for the serving groups, then
# for the fleet router's phase).
MP_LAYERS = 2


def mp_launches(layers: int, world: int) -> dict:
    """Flash launches a step a rank of each kernel, by layout, at
    ``world`` ranks: one a layer (TP, Ulysses and every MoE dispatch run
    each layer's attention once), the ring's ``world`` blocks a layer (its
    flash inner, one call a hop), and the pipeline's ``layers / world``
    layers a stage x M = 4 * world microbatches (fill and drain ticks
    skipped: mask_bubble="auto")."""
    per_layer = {"tp": 1, "ring": world, "ulysses": 1, "ep_replicated": 1, "ep_alltoall": 1,
                 "ep_sharded": 1, "ep_sharded_top2": 1}
    out = {name: n * layers for name, n in per_layer.items()}
    out["pp"] = layers // world * 4 * world
    return out


MP_LAUNCHES = mp_launches(MP_LAYERS, 2)
MP_LOSS_RTOL, MP_NORM_RTOL = 1e-2, 2e-2  # bf16 step 1 against the single process
MP_PARAM_RTOL, MP_UPDATE_RTOL = 1e-5, 1e-3  # fp32 step 1's parameters, and its update


def _run_ranks(argvs: list, log_dir: Path, timeout: float) -> list:
    """Each argv as a process (output in ``log_dir/rank<r>.{out,err}``),
    all under one deadline of ``timeout`` seconds. Returns ``(returncode,
    out, err)`` a process."""
    shutil.rmtree(log_dir, ignore_errors=True)
    log_dir.mkdir(parents=True)
    paths = [(log_dir / f"rank{r}.out", log_dir / f"rank{r}.err") for r in range(len(argvs))]
    procs = []
    try:
        for argv, (out, err) in zip(argvs, paths):
            with open(out, "w") as fo, open(err, "w") as fe:
                procs.append(subprocess.Popen(argv, cwd=ROOT, env=_repo_env(), stdout=fo,
                                              stderr=fe, text=True))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline:
                raise SmokeFailure(f"{argvs[0][1:3]} passed {timeout} s")
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                _stop(p)
    return [(p.returncode, out.read_text(), err.read_text()) for p, (out, err) in zip(procs, paths)]


def phase_train_bert_mp(torch, *, device="cuda", cut: dict | None = None, world: int = 2,
                        backend: str = "gloo", rows: int | None = None, plain_steps: int = 0):
    """Full-width BERT-base (:data:`MP_LAYERS` layers) at L=512 under TP,
    the ring, Ulysses, MoE (8 experts over ``{"expert": 2}``: replicated,
    all-to-all and sharded
    dispatch, top-1, and sharded top-2) and the GPipe pipeline
    (``{"pipeline": 2}``, M = 8) as two gloo processes on the one card
    (``scripts/torch_mp_train.py``), after the collectives on CUDA tensors;
    each held against its single-process reference here (the MoE's at a
    capacity that drops nothing, over the sharded dispatch's two row groups
    where it has them). ``device="cpu"`` with ``cut`` (the script's geometry
    flags, e.g. ``{"layers": 2, "hidden": 64, "heads": 4, "vocab": 128,
    "seq_len": 64}``) rehearses it on the CPU, where no kernel launches.
    ``world``, ``backend`` and ``rows`` (the global batch, default the
    script's) run the same at another width: four NCCL ranks, one a card,
    at 32 rows in :func:`main_cards`, with ``plain_steps`` steps a layout
    timed without the collectives' timer."""
    from distributed_tensorflow_tpu_torch.interop import shard_params
    from distributed_tensorflow_tpu_torch.parallel.mesh import build_mesh

    mp = load_script("torch_mp_train")
    cut = dict(cut or {"layers": MP_LAYERS})
    geom = mp.geometry(argparse.Namespace(**{f: cut.get(f, 0) for f in
                                             ("layers", "hidden", "heads", "vocab",
                                              "seq_len")}))
    rows = rows or mp.ROWS
    layers = mp.bert.BertConfig(**geom).num_layers
    launches = mp_launches(layers, world)
    out_dir = ROOT / "build" / "chip_smoke_mp"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)

    def reference():
        """The unsharded held steps and initial parameters of every
        reference kind, made here while the ranks start (their held steps
        are untimed)."""
        t0 = time.monotonic()
        refs = mp.single_process_references(geom, rows, device, world)
        return refs, time.monotonic() - t0

    port = _free_port()
    flags = [f"--{k.replace('_', '-')}={v}" for k, v in cut.items()]
    argvs = [[sys.executable, str(ROOT / "scripts" / "torch_mp_train.py"), "--world",
              str(world), "--rank", str(r), "--port", str(port), "--out", str(out_dir),
              "--device", device, "--backend", backend, "--rows", str(rows),
              "--plain-steps", str(plain_steps), *flags]
             for r in range(world)]
    t0 = time.monotonic()
    if world == 2:
        procs, (refs, ref_s) = concurrently(
            (_run_ranks, argvs, ROOT / "build" / "chip_smoke_mp_logs", 600), (reference,))
    else:
        # Four cards at full depth: the MoE references' capacity buffers
        # (every token a slot in each of 8 experts, 12 layers) need most of
        # card 0, so they run before the ranks start.
        refs, ref_s = reference()
        if device == "cuda":
            torch.cuda.empty_cache()
        t0 = time.monotonic()
        procs = _run_ranks(argvs, ROOT / "build" / "chip_smoke_mp_logs", 600)
    wall = time.monotonic() - t0
    for r, (code, out, err) in enumerate(procs):
        check(code == 0, f"torch_mp_train rank {r} exited {code}:\n{err[-4000:]}")
    ranks = [json.loads((out_dir / f"rank{r}.json").read_text()) for r in range(world)]
    check(all(r["backend"] == backend for r in ranks),
          f"the ranks' backends {[r['backend'] for r in ranks]}, expected {backend}")

    coll = [r["collectives"] for r in ranks]
    for c in coll:
        for name, err in c["max_abs_err"].items():
            check(err <= 1e-6, f"collective {name} on CUDA tensors off by {err}")
    emit({"phase": f"collectives_{backend}_cuda", "seconds": max(c["seconds"] for c in coll),
          "world": world, "devices": [r["device"] for r in ranks],
          "max_abs_err": coll[0]["max_abs_err"], "raw_device_ops": [c["raw_device_ops"]
                                                                     for c in coll],
          "host_staged": coll[0]["host_staged"]})

    records = {}
    for name, expect in launches.items():
        expect = expect if device == "cuda" else 0
        ref = refs[mp.REFERENCE[name]]
        want_all, init_all = ref["fp32"]["params"], ref["init"]
        if mp.CONFIGS[name][1].get("pipeline_axis"):
            # The pipeline's stacked tree is the module list stacked.
            want_all, init_all = (mp.bert.stack_layer_state(t, layers)
                                  for t in (want_all, init_all))
        # ||p - p_ref|| against ||p_ref|| and against the reference's
        # update ||p_ref - p_0||, in f64, over each rank's slices (rank 0
        # holds the replicated leaves) against the same slices of the
        # single process's tree.
        num = den = upd = 0.0
        seen = set()
        for r in range(world):
            blob = torch.load(out_dir / f"params_{name}_rank{r}.pt", map_location=device,
                              weights_only=True)
            spec = {a: world if n == -1 else n for a, n in mp.CONFIGS[name][0].items()}
            cut_r = functools.partial(shard_params, specs=blob["specs"], mesh=build_mesh(
                spec, world_size=world, rank=r))
            want = cut_r({k: want_all[k] for k in blob["params"]})
            init = cut_r({k: init_all[k] for k in blob["params"]})
            for k, p in blob["params"].items():
                w = want[k].to(device).double()
                num += float((p.double() - w).square().sum())
                den += float(w.square().sum())
                upd += float((w - init[k].to(device).double()).square().sum())
            seen |= blob["params"].keys()
        check(seen == want_all.keys(), f"{name}: the ranks' trees' names")
        param_rel, update_rel = math.sqrt(num / den), math.sqrt(num / max(upd, 1e-30))
        rec = {"param_rel_err": param_rel, "update_rel_err": update_rel, "ranks": []}
        for r in ranks:
            c = r["configs"][name]
            held = c["held_bf16"]
            loss_rel = abs(held["loss"] - ref["bf16"]["loss"]) / abs(ref["bf16"]["loss"])
            norm_rel = abs(held["grad_norm"] - ref["bf16"]["grad_norm"]) / ref["bf16"]["grad_norm"]
            check(loss_rel <= MP_LOSS_RTOL and norm_rel <= MP_NORM_RTOL,
                  f"{name} rank {r['rank']}: step-1 loss/grad_norm {held} against the "
                  f"single process's {ref['bf16']}")
            check(all(math.isfinite(x) for x in c["losses"]), f"{name}: losses {c['losses']}")
            if name.startswith("ep"):
                check(len(c["moe_aux"]) == mp.steps(name) and all(a > 0 for a in c["moe_aux"]),
                      f"{name}: moe_aux {c['moe_aux']}")
            for counts in c["launches"]:
                check(all(counts[k] == expect for k in mp.FLASH),
                      f"{name} rank {r['rank']}: flash launches {counts}, expected {expect} each")
            rec["ranks"].append({"rank": r["rank"], "loss_rel_err": loss_rel,
                                 "grad_norm_rel_err": norm_rel, "launches": c["launches"],
                                 "step_ms": c["step_ms"], "comm_ms": c["comm_ms"],
                                 "step_ms_median": c["step_ms_median"],
                                 "step_ms_plain_median": c["step_ms_plain_median"],
                                 "comm_ms_median": c["comm_ms_median"],
                                 "ppermute_ms_median": c["ppermute_ms_median"],
                                 "ppermute_share": c["ppermute_ms_median"]
                                 / c["step_ms_median"],
                                 "collective_calls": c["collective_calls"],
                                 "losses": c["losses"], "moe_aux": c["moe_aux"],
                                 "seconds": c["seconds"]})
        check(param_rel <= MP_PARAM_RTOL and update_rel <= MP_UPDATE_RTOL,
              f"{name}: fp32 step's params off by {param_rel} (update {update_rel})")
        records[name] = rec
        emit({"phase": "train_bert_mp", "config": name, "reference": mp.REFERENCE[name],
              "world": world, "backend": backend, "rows": rows, "layers": layers, **rec})
    emit({"phase": "train_bert_mp_summary", "reference_s": ref_s, "ranks_wall_s": wall,
          "init_s": [r["init_s"] for r in ranks], "exit_codes": [p[0] for p in procs],
          "reference": {k: v["bf16"] for k, v in refs.items()},
          "max_memory_allocated": [r.get("max_memory_allocated") for r in ranks]})
    return {"launches": {name: [r["launches"] for r in rec["ranks"]]
                         for name, rec in records.items()},
            "collectives_s": max(c["seconds"] for c in coll)}


def _serve_checkpoint(torch, fm, ckpt_dir: Path, cfg, device, steps: int, what: str) -> int:
    """The newest checkpoint under ``ckpt_dir`` (the global tree, at
    ``steps``) restored at one process into ``BertInferenceEngine`` (bucket
    512) and one ``/v1/mlm`` answered over HTTP; returns the request's
    ``flash_fwd`` launches."""
    from distributed_tensorflow_tpu_torch.ckpt import restore_serving_state
    from distributed_tensorflow_tpu_torch.models.bert import BertForPreTraining
    from distributed_tensorflow_tpu_torch.serve import (
        BatcherConfig,
        BertInferenceEngine,
        Client,
        build_http_server,
    )

    params, _, step = restore_serving_state(ckpt_dir)
    check(step == steps, f"{what}: restored step {step}")
    model = BertForPreTraining(cfg, device="meta")  # a template: the engine loads it
    want = {k: v.shape for k, v in model.state_dict().items()}
    check({k: v.shape for k, v in params.items()} == want,
          f"{what}: the checkpoint holds the global tree")
    engine = BertInferenceEngine(model, params, device, buckets=(512,), max_batch=1,
                                 batch_tiers=(1,))
    del params
    ids = np.random.default_rng(SEED).integers(5, cfg.vocab_size, size=300)
    with Client(engine, BatcherConfig(max_batch=1, max_delay_ms=1.0)) as client:
        server = build_http_server(client, port=0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            base = "http://{}:{}".format(*server.server_address)
            req = urllib.request.Request(base + "/v1/mlm",
                                         data=json.dumps({"input_ids": ids.tolist()}).encode(),
                                         headers={"Content-Type": "application/json"})
            fm.reset_launch_counts()
            with urllib.request.urlopen(req, timeout=120) as resp:
                check(resp.status == 200, f"{what}: /v1/mlm status {resp.status}")
                out = json.loads(resp.read())
            launches = fm.LAUNCHES["flash_fwd"]
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=10)
    check(out["bucket"] == 512 and len(out["pred_ids"]) == len(ids)
          and abs(sum(out["nsp_probs"]) - 1.0) < 1e-3, f"{what}: the served answer")
    check(launches == (cfg.num_layers if device == "cuda" else 0),
          f"{what}: {launches} flash_fwd launches for one bucket-512 request")
    del engine
    return launches


def _cli_ranks(ckpt_dir: Path, flags: list, device, cli_extra, steps: int, layout: str,
               what: str) -> tuple[float, str]:
    """``cli.train --config bert_base_l512 <flags>`` as four gloo processes
    on the one card (``scripts/torch_mp_train.py --cli``), 8 rows, ``steps``
    steps, checkpointing into ``ckpt_dir``. Returns the wall seconds and the
    last step's log line."""
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    port, world = _free_port(), 4
    argvs = [[sys.executable, str(ROOT / "scripts" / "torch_mp_train.py"), "--cli",
              "--config", "bert_base_l512", *flags, "--steps", str(steps), "--global-batch",
              "8", "--log-every", "1", "--ckpt-dir", str(ckpt_dir), "--coordinator-address",
              f"127.0.0.1:{port}", "--num-processes", str(world), "--process-id", str(r),
              "--device", device, "--backend", "gloo", *cli_extra]
             for r in range(world)]
    t0 = time.monotonic()
    procs = _run_ranks(argvs, ROOT / "build" / f"{ckpt_dir.name}_logs", 600)
    cli_s = time.monotonic() - t0
    for r, (code, _, err) in enumerate(procs):
        check(code == 0, f"{what} rank {r} exited {code}:\n{err[-4000:]}")
    log = procs[0][2]
    lines = [ln for ln in log.splitlines() if "train.loop: step" in ln]
    check(len(lines) == steps and all("loss=nan" not in ln for ln in lines), f"log: {lines}")
    check(f"layout={layout}" in log and "backend=gloo world=4" in log,
          f"{what}: the CLI's log names the layout and the 4-rank gloo group")
    return cli_s, lines[-1].split(": ", 1)[-1]


def phase_train_cli_tp_sp(torch, fm, *, device="cuda", cli_extra=(), cfg=None):
    """``cli.train`` (the bert_base recipe at 512 positions) as four gloo
    processes on the one card under ``--tensor-parallel 2 --seq-parallel 2
    --sp-impl ring``, its global checkpoint restored here at TP 1 and served
    through ``BertInferenceEngine`` (bucket 512) and ``/v1/mlm``; then the
    same under ``--moe-experts 8 --expert-parallel 2 --pipeline-parallel 2``
    (M = 8), its checkpoint (every expert, the whole stacked encoder) served
    at one process with the stacked encoder run sequentially.
    ``device="cpu"`` with ``cli_extra`` (geometry flags) and the matching
    ``cfg`` rehearses it on the CPU."""
    from distributed_tensorflow_tpu_torch.models.bert import BertConfig

    steps = 3
    cfg = cfg or BertConfig(dropout_rate=0.1, dtype=torch.bfloat16)  # 512 positions
    tp_dir = ROOT / "build" / "chip_smoke_cli_tp_sp"
    moe_dir = ROOT / "build" / "chip_smoke_cli_moe_pp"
    # One after the other: side by side, with the rest of the CLI group,
    # they ran the card out of memory (run 3 of PR 15).
    cli_s, last = _cli_ranks(tp_dir, ["--tensor-parallel", "2", "--seq-parallel", "2",
                                      "--sp-impl", "ring"], device, cli_extra, steps,
                             "sp2-tp2", "cli.train --tensor-parallel 2 --seq-parallel 2")
    t0 = time.monotonic()
    launches = _serve_checkpoint(torch, fm, tp_dir, cfg, device, steps, "TP x SP checkpoint")
    serve_s = time.monotonic() - t0
    emit({"phase": "train_cli_tp_sp", "cli_seconds": cli_s, "serve_seconds": serve_s,
          "last_log": last, "restored_step": steps, "serve_flash_fwd_launches": launches,
          "bucket": 512})
    cli_s, last = _cli_ranks(moe_dir, ["--moe-experts", "8", "--expert-parallel", "2",
                                       "--pipeline-parallel", "2"], device, cli_extra, steps,
                             "pp2-ep2", "cli.train --moe-experts 8 --expert-parallel 2 "
                                        "--pipeline-parallel 2")
    check("moe_aux=" in last, f"the MoE run logs its aux: {last}")
    t0 = time.monotonic()
    moe_launches = _serve_checkpoint(
        torch, fm, moe_dir, dataclasses.replace(cfg, moe_experts=8, pipeline_parallel=2),
        device, steps, "PP x EP checkpoint")
    emit({"phase": "train_cli_moe_pp", "cli_seconds": cli_s,
          "serve_seconds": time.monotonic() - t0, "last_log": last, "restored_step": steps,
          "serve_flash_fwd_launches": moe_launches, "bucket": 512})
    # Both checkpoints stay for serve_bert_mp, which serves them over rank
    # groups (main() removes the 6.5 GB MoE one after it).
    return launches, moe_launches



# ------------------------------------------------- serving over a rank group

# layout -> (checkpoint of train_cli_tp_sp: "tp" dense, "moe" the MoE x PP
# stacked one; the serve CLI's layout flags; flash_fwd launches a bucket-512
# request on each rank: 12 layers, or a stage's 6 layers x M = 1 at tier 1).
SERVE_GROUP_LAYOUTS = {
    "tp2": ("tp", ["--tp", "2"], 12),
    "ep2": ("moe", ["--moe-experts", "8", "--pp", "2", "--mesh", "expert=2"], 12),
    "pp2": ("moe", ["--moe-experts", "8", "--pp", "2"], 6),
}
SERVE_GROUP_TIMED = 4  # timed requests a layout, after the compared one
# fp32 group against the one-process fp32 engine (tests/test_serve_mesh.py's
# tolerances; pred_ids may flip only where the top-2 logits tie within the
# model axis's reordered sums).
SERVE_GROUP_MIN_PRED_AGREEMENT = 0.99
SERVE_GROUP_SCORE_RTOL, SERVE_GROUP_VEC_RTOL, SERVE_GROUP_VEC_ATOL = 1e-4, 1e-3, 1e-4


class ServeGroup(typing.NamedTuple):
    """A spawned ``cli.serve`` job: its processes (the ranks, or one
    launcher), the leader's URL, the spawn time, its ranks, and where the
    leader writes its pid when it is a launcher's child (else None: the
    leader is ``procs[0]``)."""

    procs: list
    base: str
    t0: float
    world: int
    leader_pid_file: Path | None = None


def _spawn_group(flags: list, log_dir: Path, device: str, world: int = 2,
                 backend: str = "gloo") -> ServeGroup:
    """``cli.serve`` as ``world`` ranks over ``backend`` (gloo: all on the
    one card; NCCL: one a card) through ``scripts/torch_mp_train.py
    --serve``, rank 0 serving HTTP on a free port. Each rank's output and
    launch log land in ``log_dir``."""
    shutil.rmtree(log_dir, ignore_errors=True)
    log_dir.mkdir(parents=True)
    port, coord = _free_port(), _free_port()
    procs = []
    for r in range(world):
        with open(log_dir / f"rank{r}.log", "w") as fh:
            procs.append(subprocess.Popen(
                _serve_rank_argv(flags, device, port, coord, world, r,
                                 log_dir / f"rank{r}.json", backend),
                cwd=ROOT, env=_repo_env(), stdout=fh, stderr=subprocess.STDOUT))
    return ServeGroup(procs, f"http://127.0.0.1:{port}", time.monotonic(), world)


def _serve_rank_argv(flags: list, device: str, port: int, coord: int, world: int, rank: int,
                     launch_log: Path, backend: str = "gloo") -> list:
    """``cli.serve`` as rank ``rank`` of a ``world``-rank job over
    ``backend`` (``scripts/torch_mp_train.py --serve``), serving HTTP on
    ``port``."""
    return [sys.executable, str(ROOT / "scripts" / "torch_mp_train.py"), "--serve", *flags,
            "--device", device, "--backend", backend, "--port", str(port),
            "--coordinator-address",
            f"127.0.0.1:{coord}", "--num-processes", str(world), "--process-id", str(rank),
            "--launch-log", str(launch_log)]


def _await_group(group, log_dir: Path) -> float:
    """Wait for the leader's ``/healthz`` (every follower alive); returns
    the seconds from the spawn. Stops the group on failure."""
    try:
        for r, p in enumerate(group.procs[1:], 1):
            check(p.poll() is None,
                  f"follower {r} exited {p.returncode}:\n"
                  f"{(log_dir / f'rank{r}.log').read_text()[-4000:]}")
        return _await_serve_cli(group.procs[0], group.base, group.t0, log_dir / "rank0.log")
    except BaseException:
        _stop_group(group, log_dir, check_exit=False)
        raise


def _stop_group(group, log_dir: Path, check_exit: bool = True) -> list:
    """SIGINT to the leader: it closes its client, which stops the
    followers; every rank must exit 0 (a launcher's group: the launcher).
    Returns the ranks' launch logs."""
    import signal

    procs, pid_file = group.procs, group.leader_pid_file
    if procs[0].poll() is None:
        pid = (int(pid_file.read_text()) if pid_file is not None and pid_file.exists()
               else procs[0].pid)
        with contextlib.suppress(ProcessLookupError):
            os.kill(pid, signal.SIGINT)
    deadline = time.monotonic() + 60
    for p in procs:
        try:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            _stop(p)
    if not check_exit:
        return []
    for r, p in enumerate(procs):
        check(p.returncode == 0, f"serving rank {r} exited {p.returncode}:\n"
                                 f"{(log_dir / f'rank{r}.log').read_text()[-4000:]}")
    return [json.loads((log_dir / f"rank{r}.json").read_text())
            for r in range(group.world)]


def _post_json(base: str, route: str, body: dict, timeout: float = 300) -> tuple[dict, float]:
    req = urllib.request.Request(base + route, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.monotonic()
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        check(resp.status == 200, f"{route}: status {resp.status}")
        out = json.loads(resp.read())
    return out, time.monotonic() - t0


def _collectives_share(leader: dict, wall_s: float, backend: str = "gloo") -> dict:
    """The leader's seconds in collectives against the wall seconds they
    fell in: the model's collectives over ``backend`` (gloo, or NCCL across
    cards) and the control channel's broadcasts (always gloo), apart and
    summed. ``collectives_share`` is what earlier records called
    ``gloo_share``, when every collective was gloo."""
    control = (leader.get("group") or {}).get("control_seconds", 0.0)
    return {"backend": backend, "collectives_s": leader["comm_s"],
            "collective_calls": leader["comm_calls"], "control_s": control,
            "cells": (leader.get("group") or {}).get("cells_issued"),
            "collectives_share": (leader["comm_s"] + control) / wall_s if wall_s else None}


def phase_serve_bert_mp(torch, *, device="cuda", cli_extra=(), cfg=None, tp_dir=None,
                        moe_dir=None):
    """Full-width BERT-base (512 positions, fp32 compute) served by
    ``cli.serve`` over a group of two gloo ranks on the one card under each
    of :data:`SERVE_GROUP_LAYOUTS`, from ``train_cli_tp_sp``'s checkpoints
    (the TP x ring one, and the MoE x PP x EP one: 8 experts, the stacked
    encoder; EP 2 runs it sequentially on each rank, PP 2 as the
    pipeline). The three groups start side by side; the one-process fp32
    engine of each checkpoint answers the same bucket-512 request here
    meanwhile. Then, one layout at a time: that request over HTTP
    (``/v1/mlm`` and ``/v1/embed``) held to the one-process answer within the
    ``SERVE_GROUP_*`` tolerances, and :data:`SERVE_GROUP_TIMED` more timed
    one by one; the leader's SIGINT stops the group. Each rank launches
    ``flash_fwd`` exactly the layout's count for every request (warm-up
    excluded). ``device="cpu"`` with ``cli_extra`` (geometry flags) and the
    matching ``cfg`` rehearses it."""
    from distributed_tensorflow_tpu_torch.ckpt import restore_serving_state
    from distributed_tensorflow_tpu_torch.models.bert import BertConfig, BertForPreTraining
    from distributed_tensorflow_tpu_torch.serve import BertInferenceEngine

    cfg = dataclasses.replace(cfg or BertConfig(), dtype=torch.float32)  # 512 positions
    dirs = {"tp": tp_dir or ROOT / "build" / "chip_smoke_cli_tp_sp",
            "moe": moe_dir or ROOT / "build" / "chip_smoke_cli_moe_pp"}
    rng = np.random.default_rng(SEED + 21)
    ids = rng.integers(5, cfg.vocab_size, size=300)
    payload = {"input_ids": ids.tolist(), "mlm_targets": ids.tolist()}
    timed = [rng.integers(5, cfg.vocab_size, size=int(n)).tolist()
             for n in rng.integers(257, 513, SERVE_GROUP_TIMED)]
    common = ["--config", "bert_base_l512_f32", "--buckets", "512", "--max-batch", "1",
              "--batch-tiers", "1", "--max-delay-ms", "1", *cli_extra]
    groups = {name: _spawn_group(common + ["--ckpt-dir", str(dirs[ck])] + flags,
                                 ROOT / "build" / f"chip_smoke_serve_{name}", device)
              for name, (ck, flags, _) in SERVE_GROUP_LAYOUTS.items()}

    def reference(kind):
        model_cfg = (cfg if kind == "tp"
                     else dataclasses.replace(cfg, moe_experts=8, pipeline_parallel=2))
        params, _, _ = restore_serving_state(dirs[kind])
        engine = BertInferenceEngine(BertForPreTraining(model_cfg, device="meta"), params,
                                     device, buckets=(512,), max_batch=1, batch_tiers=(1,))
        out = engine.run_batch([{k: np.asarray(v) for k, v in payload.items()}])[0]
        del engine, params
        if device == "cuda":
            torch.cuda.empty_cache()
        return out

    try:
        return _serve_groups(groups, concurrently((reference, "tp"), (reference, "moe")),
                             payload, timed, len(ids), device)
    finally:
        # Whatever failed, no rank of any group outlives the phase.
        for name, g in groups.items():
            _stop_group(g, ROOT / "build" / f"chip_smoke_serve_{name}", check_exit=False)


def _serve_groups(groups: dict, refs: list, payload: dict, timed: list, n_ids: int,
                  device, layouts: dict = SERVE_GROUP_LAYOUTS, world: int = 2,
                  backend: str = "gloo", gated: bool = False) -> dict:
    """:func:`phase_serve_bert_mp`'s requests and checks, one layout of
    ``layouts`` at a time, each group (``world`` ranks over ``backend``)
    stopped before the next. ``gated``: the groups time their collectives
    only while ``<log dir>/timer_on`` exists (``--comm-timer-file``), and
    the timed requests run once with the timer and once without
    (``request_ms_median_plain``)."""
    refs = dict(zip(("tp", "moe"), refs))
    records = {}
    for name, (ck, flags, per_request) in layouts.items():
        log_dir = ROOT / "build" / f"chip_smoke_serve_{name}"
        group = groups[name]
        ready_s = _await_group(group, log_dir)
        gate = log_dir / "timer_on"
        try:
            if gated:
                gate.touch()
            got, first_s = _post_json(group.base, "/v1/mlm", payload)
            emb, emb_s = _post_json(group.base, "/v1/embed", payload)
            got["embedding"] = emb["embedding"]
            walls = [_post_json(group.base, "/v1/mlm", {"input_ids": t})[1] for t in timed]
            plain = []
            if gated:
                gate.unlink()
                plain = [_post_json(group.base, "/v1/mlm", {"input_ids": t})[1] for t in timed]
            with urllib.request.urlopen(group.base + "/statusz", timeout=30) as resp:
                mesh = json.loads(resp.read())["mesh"]
        finally:
            ranks = _stop_group(group, log_dir)
        ref = refs[ck]
        agree = float(np.mean(np.asarray(got["pred_ids"]) == ref["pred_ids"]))
        err = {"pred_agreement": agree,
               "score_rel_err": abs(got["score"] - ref["score"]) / abs(ref["score"]),
               "embedding_max_abs_err": float(np.max(np.abs(
                   np.asarray(got["embedding"]) - ref["embedding"]))),
               "nsp_max_abs_err": float(np.max(np.abs(
                   np.asarray(got["nsp_probs"]) - ref["nsp_probs"])))}
        n = 2 + len(timed) + len(plain)
        want = per_request * n if device == "cuda" else 0
        launches = [r["launches"]["flash_fwd"] for r in ranks]
        rec = {"layout": mesh["layout"], "mesh": mesh, "ready_s": ready_s,
               "against_one_process": err, "flash_fwd_launches": launches, "requests": n,
               "flash_fwd_per_request": [x / n for x in launches],
               "first_request_ms": first_s * 1e3,
               "request_ms_median": statistics.median(walls) * 1e3,
               **_collectives_share(ranks[0], first_s + emb_s + sum(walls), backend)}
        if plain:
            rec["request_ms_median_plain"] = statistics.median(plain) * 1e3
        emit({"phase": "serve_bert_mp", "config": name, **rec})
        check(mesh["layout"] == name and mesh["devices_per_engine"] == world,
              f"{name}: the leader's mesh {mesh}")
        check(got["bucket"] == 512 and len(got["pred_ids"]) == n_ids, f"{name}: the answer")
        check(agree >= SERVE_GROUP_MIN_PRED_AGREEMENT
              and np.isclose(got["score"], ref["score"], rtol=SERVE_GROUP_SCORE_RTOL, atol=0)
              and np.allclose(got["embedding"], ref["embedding"], rtol=SERVE_GROUP_VEC_RTOL,
                              atol=SERVE_GROUP_VEC_ATOL)
              and np.allclose(got["nsp_probs"], ref["nsp_probs"], rtol=SERVE_GROUP_VEC_RTOL,
                              atol=SERVE_GROUP_VEC_ATOL),
              f"{name}: the group's answer against the one-process engine's: {err}")
        check(launches == [want] * world,
              f"{name}: flash_fwd launches {launches} for {n} requests, expected {want} a rank")
        records[name] = rec
    return {name: rec["flash_fwd_per_request"] for name, rec in records.items()}


def phase_train_lm_tp(torch, *, device="cuda", cli_extra=(), cfg=None, steps=2) -> dict:
    """The causal LM's tensor parallelism in training: ``cli.train --config
    lm_base --tensor-parallel 2`` as two gloo ranks for ``steps`` steps at
    global batch 8 (finite losses, the layout logged), its checkpoint
    restored at TP 1 (the global tree, a finite forward on the device).
    ``device="cpu"`` with ``cli_extra`` and ``cfg`` rehearses it."""
    from distributed_tensorflow_tpu_torch.ckpt import restore_serving_state
    from distributed_tensorflow_tpu_torch.models.causal_lm import CausalLM, CausalLMConfig

    cfg = cfg or CausalLMConfig(max_position=128, dtype=torch.bfloat16)
    train_dir = ROOT / "build" / "chip_smoke_lm_tp"
    shutil.rmtree(train_dir, ignore_errors=True)
    port = _free_port()
    t0 = time.monotonic()
    procs = _run_ranks(
        [[sys.executable, str(ROOT / "scripts" / "torch_mp_train.py"), "--cli", "--config",
          "lm_base", "--tensor-parallel", "2", "--steps", str(steps), "--global-batch", "8",
          "--log-every", "1", "--ckpt-dir", str(train_dir), "--coordinator-address",
          f"127.0.0.1:{port}", "--num-processes", "2", "--process-id", str(r),
          "--device", device, "--backend", "gloo", *cli_extra] for r in range(2)],
        ROOT / "build" / "chip_smoke_lm_tp_logs", 600)
    train_s = time.monotonic() - t0
    for r, (code, _, err) in enumerate(procs):
        check(code == 0, f"lm_base --tensor-parallel 2 rank {r} exited {code}:\n{err[-4000:]}")
    log = procs[0][2]
    lines = [ln for ln in log.splitlines() if "train.loop: step" in ln]
    check(len(lines) == steps and all("loss=nan" not in ln for ln in lines)
          and "layout=tp2" in log and "backend=gloo world=2" in log,
          f"lm_base --tensor-parallel 2 log: {lines}")
    params, _, step = restore_serving_state(train_dir)
    model = CausalLM(cfg, device="cpu")
    check(step == steps and {k: v.shape for k, v in params.items()}
          == {k: v.shape for k, v in model.state_dict().items()},
          "the TP 2 checkpoint holds the global tree")
    model.load_state_dict(params)
    model = model.to(device)
    with torch.no_grad():
        ids = (torch.arange(5, 69, device=device) % cfg.vocab_size)[None]
        logits = model(ids, torch.ones_like(ids, dtype=torch.bool))
    check(bool(torch.isfinite(logits.float()).all()), "the TP 2 checkpoint at TP 1: logits")
    del model, params, logits
    shutil.rmtree(train_dir, ignore_errors=True)
    out = {"phase": "train_lm_tp", "seconds": train_s, "last_log": lines[-1],
           "restored_at_tp1_step": step}
    emit(out)
    return out


LM_TP_LOGS = ROOT / "build" / "chip_smoke_serve_lm_tp2"


def spawn_lm_tp_group(lm_ckpt: Path, device="cuda", cli_extra=()):
    """``cli.serve --config lm_base_f32 --tp 2`` on ``lm_ckpt`` as two gloo
    ranks (:func:`_spawn_group`), at :func:`phase_serve_lm`'s geometry."""
    return _spawn_group(["--config", "lm_base_f32", "--ckpt-dir", str(lm_ckpt), "--tp", "2",
                         "--buckets", *map(str, LM_BUCKETS), "--slots", str(LM_SLOTS),
                         "--max-batch", str(LM_TIER), "--batch-tiers", "1", "2", "4",
                         "--max-new-tokens", str(LM_NEW), *cli_extra], LM_TP_LOGS, device)


def phase_serve_lm_tp(torch, lm_ckpt: Path, *, device="cuda", cli_extra=(), cfg=None,
                      group=None) -> dict:
    """``train_cli_lm``'s checkpoint served by ``cli.serve --tp 2`` in fp32
    as a leader and a follower (``group`` from :func:`spawn_lm_tp_group`,
    spawned here when None): the 12 seeded ``/v1/generate`` requests of
    ``serve_lm`` at once, every stream (greedy and seeded-sampled) equal to
    the one-process fp32 engine's (:func:`_generate`, built here while the
    ranks start), then 2 greedy requests one at a time for the decode ms a
    step and the leader's gloo share. ``device="cpu"`` with ``cli_extra``
    and ``cfg`` rehearses it."""
    from distributed_tensorflow_tpu_torch.ckpt import restore_serving_state
    from distributed_tensorflow_tpu_torch.models.causal_lm import CausalLM, CausalLMConfig
    from distributed_tensorflow_tpu_torch.serve import CausalLMEngine

    cfg = dataclasses.replace(cfg or CausalLMConfig(max_position=128), dtype=torch.float32)
    log_dir = LM_TP_LOGS
    group = group or spawn_lm_tp_group(lm_ckpt, device, cli_extra)
    requests = _lm_requests(cfg.vocab_size, 12, cfg.max_position)
    try:
        lm_params, _, _ = restore_serving_state(lm_ckpt)
        ref = CausalLMEngine(CausalLM(cfg, device="meta"), lm_params, device, buckets=LM_BUCKETS,
                             slots=LM_SLOTS, max_batch=LM_TIER, batch_tiers=(1, 2, 4),
                             max_new_tokens=LM_NEW)
        want = _generate(ref, requests)
        del ref, lm_params
        ready_s = _await_group(group, log_dir)
    except BaseException:
        _stop_group(group, log_dir, check_exit=False)
        raise
    try:
        replies, burst_s = _post_generates(group.base, requests)
        greedy = [r for r in requests if r["temperature"] == 0.0][:2]
        solo = [_post_json(group.base, "/v1/generate", {
            "input_ids": r["input_ids"].tolist(), "max_new_tokens": r["budget"]})
            for r in greedy]
        with urllib.request.urlopen(group.base + "/statusz", timeout=30) as resp:
            mesh = json.loads(resp.read())["mesh"]
    finally:
        ranks = _stop_group(group, log_dir)
    bad = {i: rep for i, rep in replies.items() if rep[0] != 200}
    check(len(replies) == len(requests) and not bad, f"cli.serve --tp 2: {bad or len(replies)}")
    diverged = [r["id"] for r in requests if replies[r["id"]][1]["tokens"] != want[r["id"]]]
    decode_ms = [body["phases"]["decode"] / (body["n_tokens"] - 1)  # phases are in ms
                 for body, _ in solo]
    wall = burst_s + sum(w for _, w in solo)
    out = {"phase": "serve_lm_tp", "ready_s": ready_s, "layout": mesh["layout"], "mesh": mesh,
           "streams_equal_one_process": len(requests) - len(diverged), "diverged": diverged,
           "burst_s": burst_s, "decode_ms_a_step": decode_ms,
           "decode_ms_a_step_median": statistics.median(decode_ms),
           "solo_request_ms": [w * 1e3 for _, w in solo],
           "flash_fwd_launches": [r["launches"]["flash_fwd"] for r in ranks],
           **_collectives_share(ranks[0], wall)}
    emit(out)
    check(mesh["layout"] == "tp2", f"cli.serve --tp 2: the leader's mesh {mesh}")
    check(not diverged, f"cli.serve --tp 2 streams off the one-process engine's: {diverged}")
    return out

# ------------------------------------------------------------ fleet serving

FLEET_LOGS = ROOT / "build" / "chip_smoke_serve_lm_fleet"
# The decode role's prefix pool and pages (the in-process prefill engine
# matches them: chains move between equal page geometries only).
FLEET_BLOCK, FLEET_CHUNK, FLEET_POOL_MB = 16, 64, 256.0
# Replica A's decode pace (a fault plan of slow_decode_step events, every
# step from the 2nd): its streams sit mid-generation when /migratez comes.
FLEET_PACE_S = 0.03


def _fleet_requests(vocab: int, n: int, seed: int, max_prompt: int = 96) -> list:
    """``n`` seeded prompts of 17-``max_prompt`` tokens (at least one
    16-token page each), every other one sampled (0.8, its own seed),
    full budgets of ``LM_NEW``."""
    rng = np.random.default_rng(SEED + seed)
    out = []
    for i in range(n):
        length = int(rng.integers(17, max_prompt + 1))
        out.append({"id": seed * 100 + i, "input_ids": rng.integers(4, vocab, length),
                    "temperature": 0.8 if i % 2 else 0.0, "seed": 700 + seed * 100 + i,
                    "budget": LM_NEW})
    return out


# The router over the fleet (serve_lm_router): slow first loads and busy
# hosts are not losses; a prompt head stays on its rendezvous pick however
# many streams it holds (affinity never yields); a hot swap's drain deadline
# falls while the paced streams on A are live (each owes LM_NEW tokens at
# FLEET_PACE_S a step).
ROUTER_CONFIG = dict(poll_interval_s=0.25, poll_timeout_s=10.0, start_grace_s=900.0,
                     fail_threshold=3, affinity_max_imbalance=1e9, drain_timeout_s=0.3,
                     ready_timeout_s=300.0, request_timeout_s=300.0)
ROUTER_SWAP_TAG = "swap-2"


def spawn_fleet_replicas(lm_ckpt: Path, device="cuda", cli_extra=()) -> tuple:
    """The cross-process replicas of :func:`phase_serve_lm_fleet` and
    :func:`phase_serve_lm_router`, each ``cli.serve --config lm_base_f32``
    on ``lm_ckpt`` as a one-rank job (``scripts/torch_mp_train.py
    --serve``) at :func:`phase_serve_lm`'s geometry with
    ``--stream-migrate``: ``b`` the decode role (``--disagg-role decode``
    and its prefix pool), ``a`` with its decode paced (``FLEET_PACE_S`` a
    step), ``a2`` as ``a`` with one ``wire_corrupt`` on its first outbound
    stream buffer. The port's :class:`Router` (started here, polling) owns
    ``a``: it launches ``a``, and a hot swap relaunches it with
    ``make_cmd``; ``a2`` and ``b`` are groups of their own
    (:func:`_spawn_group`) that it adopts. Returns ``(groups, router,
    make_cmd)``, ``groups`` ``{name: (procs, base_url, start)}`` with ``a``'s
    first process; :func:`stop_fleet` stops them all."""
    from distributed_tensorflow_tpu_torch.obs.flightrec import FlightRecorder
    from distributed_tensorflow_tpu_torch.serve.router import Router, RouterConfig

    shutil.rmtree(FLEET_LOGS, ignore_errors=True)
    FLEET_LOGS.mkdir(parents=True)
    base = ["--config", "lm_base_f32", "--ckpt-dir", str(lm_ckpt),
            "--buckets", *map(str, LM_BUCKETS), "--slots", str(LM_SLOTS),
            "--max-batch", str(LM_TIER), "--batch-tiers", "1", "2", "4",
            "--max-new-tokens", str(LM_NEW), "--stream-migrate", *cli_extra]
    flags = {"b": base + ["--disagg-role", "decode", "--prefix-cache-mb", str(FLEET_POOL_MB),
                          "--block-tokens", str(FLEET_BLOCK),
                          "--prefill-chunk", str(FLEET_CHUNK)]}
    pace = [{"kind": "slow_decode_step", "step": s, "duration_s": FLEET_PACE_S}
            for s in range(2, 400)]
    for name, events in (("a", pace),
                         ("a2", [{"kind": "wire_corrupt", "step": 1, "duration_s": 0.0}, *pace])):
        plan = FLEET_LOGS / f"plan_{name}.json"
        plan.write_text(json.dumps({"seed": None, "events": events}))
        flags[name] = base + ["--fault-plan", str(plan)]
    groups = {name: _spawn_group(flags[name], FLEET_LOGS / name, device, world=1)
              for name in ("a2", "b")}
    a_port = _free_port()
    a_logs = FLEET_LOGS / "a"
    a_logs.mkdir()

    def make_cmd(replica):
        # The swap's argv: A's flags on its port under the new tag.
        return _serve_rank_argv(flags["a"] + ["--tag", ROUTER_SWAP_TAG], device, a_port,
                                _free_port(), 1, 0, a_logs / "rank0_swap.json")

    router = Router([("a", f"http://127.0.0.1:{a_port}",
                      _serve_rank_argv(flags["a"], device, a_port, _free_port(), 1, 0,
                                       a_logs / "rank0.json")),
                     *((name, groups[name].base, None) for name in ("a2", "b"))],
                    RouterConfig(**ROUTER_CONFIG), recorder=FlightRecorder(4096),
                    log_dir=a_logs)
    try:
        router.start()
        # The router writes A's output to <log_dir>/a.log; the group
        # helpers read rank0.log.
        (a_logs / "rank0.log").symlink_to("a.log")
        groups["a"] = ServeGroup([router.replicas[0].proc], router.replicas[0].base_url,
                                 time.monotonic(), 1)
    except BaseException:
        stop_fleet((groups, router, make_cmd))
        raise
    return groups, router, make_cmd


def stop_fleet(fleet) -> None:
    """Stop the router's poll thread and the replica it owns (its current
    process), then every group (SIGINT, as :func:`_stop_group`)."""
    groups, router, _ = fleet
    try:
        router.close()
    finally:
        for name, group in groups.items():
            _stop_group(group, FLEET_LOGS / name, check_exit=False)


def _host_port(base: str) -> tuple[str, int]:
    host, port = base.removeprefix("http://").rsplit(":", 1)
    return host, int(port)


def _get_json(base: str, route: str) -> dict:
    with urllib.request.urlopen(base + route, timeout=60) as resp:
        return json.loads(resp.read())


def _fleet_pair_run(pre, dec, pair, requests, want) -> dict:
    """``requests`` through ``pair`` at once (a thread each: prefill role,
    chain transfer, decode role), every stream against ``want`` (the
    colocated engine's); the decode role's ``kv_transfer_done`` events of
    this run give each chain's blocks, bytes and ms."""
    n_events = len(dec.recorder.events())
    got, errs = {}, []

    def one(r):
        try:
            got[r["id"]] = pair.submit(_payload(r)).result(300)["tokens"]
        except Exception as e:  # noqa: BLE001 — reported below
            errs.append(repr(e)[:300])

    t0 = time.monotonic()
    threads = [threading.Thread(target=one, args=(r,)) for r in requests]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.monotonic() - t0
    check(not errs and len(got) == len(requests), f"{pair.transport} pair: {errs[:2]}")
    done = [e for e in dec.recorder.events()[n_events:] if e["kind"] == "kv_transfer_done"]
    diverged = [r["id"] for r in requests if got[r["id"]] != want[r["id"]]]
    check(not diverged, f"{pair.transport} pair streams off the colocated engine's: {diverged}")
    check(len(done) == len(requests) and all(e["adopted"] == e["blocks"] > 0 for e in done),
          f"{pair.transport} pair: transfers {done}")
    return {"streams_equal_colocated": len(requests), "wall_s": wall,
            "blocks": [e["blocks"] for e in done], "bytes": [e["bytes"] for e in done],
            "transfer_ms": [e["ms"] for e in done],
            "transfer_ms_median": statistics.median(e["ms"] for e in done)}


def _post_streams(base: str, requests: list, prefix: str) -> tuple[dict, list]:
    """Each request as a concurrent ``POST /v1/generate`` with the
    ``X-Request-Id`` ``<prefix>-<id>``; returns ``({id: (status, body)},
    threads)``, the replies filling in as the threads end (status None when
    the connection failed)."""
    replies = {}

    def post(r):
        req = urllib.request.Request(
            base + "/v1/generate", data=json.dumps(
                {**_payload(r), "input_ids": [int(t) for t in r["input_ids"]]}).encode(),
            headers={"Content-Type": "application/json", "X-Request-Id": f"{prefix}-{r['id']}"})
        try:
            with urllib.request.urlopen(req, timeout=300) as resp:
                replies[r["id"]] = (resp.status, json.loads(resp.read()))
        except urllib.error.HTTPError as e:
            replies[r["id"]] = (e.code, json.loads(e.read() or b"{}"))
        except OSError as e:
            replies[r["id"]] = (None, {"error": repr(e)[:300]})

    threads = [threading.Thread(target=post, args=(r,)) for r in requests]
    for t in threads:
        t.start()
    return replies, threads


def _join_all(threads: list, what: str) -> None:
    for t in threads:
        t.join(timeout=300)
    check(not any(t.is_alive() for t in threads), f"{what}: a request still open after 300 s")


def _await_live(base: str, n: int, what: str) -> None:
    """Until ``base`` holds ``n`` live streams that have each made 4
    tokens (the slots full, ``tokens_remaining`` down by 4 a stream)."""
    deadline = time.monotonic() + 120
    while True:
        st = _get_json(base, "/statusz")["batcher"]
        if st["slots_active"] == n and st["tokens_remaining"] <= n * (LM_NEW - 4):
            return
        check(time.monotonic() < deadline, f"{what}: streams never all live on {base}: {st}")
        time.sleep(0.005)


def _migrate(src: str, dst: str, requests: list, want: dict, prefix: str) -> dict:
    """``requests`` as live streams on replica ``src``; once every one has
    tokens (the slots full, ``tokens_remaining`` down by 4 a stream),
    ``POST /migratez`` to ``src`` naming ``dst``. Every reply says
    ``migrated``; ``/v1/stream_wait`` on ``dst`` returns each stream equal
    to ``want`` (uninterrupted). Returns the ``/migratez`` digest, its ms
    and the collected streams."""
    n = len(requests)
    replies, threads = _post_streams(src, requests, prefix)
    _await_live(src, n, prefix)
    check(not replies, f"{prefix}: streams ended before the migration: {replies}")
    digest, mig_s = _post_json(src, "/migratez", {"targets": [list(_host_port(dst))]})
    _join_all(threads, prefix)
    replies = {i: body for i, (_, body) in replies.items()}
    not_migrated = {i: rep for i, rep in replies.items() if rep.get("status") != "migrated"}
    check(len(replies) == n and not not_migrated, f"{prefix}: replies {not_migrated}")
    got = {r["id"]: _post_json(dst, "/v1/stream_wait", {"request_id": f"{prefix}-{r['id']}",
                                                         "timeout_s": 120})[0]
           for r in requests}
    lost = [i for i, body in got.items() if body["tokens"] != want[i]]
    partial = [i for i, rep in replies.items() if got[i]["tokens"][:len(rep["tokens"])]
               != rep["tokens"]]
    check(not lost and not partial,
          f"{prefix}: streams off the uninterrupted ones {lost}, rewritten prefixes {partial}")
    check(digest["exported"] == digest["migrated"] == n, f"{prefix}: /migratez {digest}")
    return {"digest": digest, "migratez_ms": mig_s * 1e3, "ms_a_stream": mig_s * 1e3 / n,
            "bytes": [o["bytes"] for o in digest["streams"]],
            "pages": [o["pages"] for o in digest["streams"]],
            "resumed_at": [len(rep["tokens"]) for rep in replies.values()]}


def phase_serve_lm_fleet(torch, lm_ckpt: Path, *, device="cuda", cfg=None, cli_extra=(),
                         fleet=None, extra_refs=()) -> tuple[dict, dict]:
    """Fleet serving on ``train_cli_lm``'s checkpoint in fp32 (streams held
    exactly). In process: a prefill and a decode ``CausalLMEngine``
    (``kv_transfer=True``, a prefix pool) behind a
    :class:`DisaggServingPair`, 12 requests over ``transport="d2d"`` and 12
    more over ``"wire"``, every stream equal to the colocated engine's (the
    prefill engine serving whole requests). Across processes, with the
    replicas of :func:`spawn_fleet_replicas` (spawned here when None): 12
    chains POSTed to the decode role B (``post_kv_transfer``), then their
    requests to B, equal to the colocated streams, B's prom text counting
    the bytes; 8 live streams on A moved to B by ``/migratez``, collected
    from B by ``/v1/stream_wait`` equal to the uninterrupted streams, the
    migrations counted on both; and the chaos drill: A2's first buffer
    corrupted, refused by B on its CRC, retried page-less, nothing lost or
    duplicated. ``device="cpu"`` with ``cfg`` and ``cli_extra`` rehearses
    it. ``fleet`` (:func:`spawn_fleet_replicas`) stays up for the caller;
    without it the phase spawns and stops its own. Returns ``(record,
    {id: colocated stream})`` of ``extra_refs``, made while the replicas
    load."""
    from distributed_tensorflow_tpu_torch.ckpt import restore_serving_state
    from distributed_tensorflow_tpu_torch.models.causal_lm import CausalLM, CausalLMConfig
    from distributed_tensorflow_tpu_torch.obs.flightrec import FlightRecorder
    from distributed_tensorflow_tpu_torch.serve import (
        BatcherConfig,
        CausalLMEngine,
        Client,
        DisaggServingPair,
        TransferBudget,
        post_kv_transfer,
        serialize_chain,
    )

    cfg = dataclasses.replace(cfg or CausalLMConfig(max_position=128), dtype=torch.float32)
    vocab = cfg.vocab_size
    t0 = time.monotonic()
    owned = fleet is None
    fleet = fleet or spawn_fleet_replicas(lm_ckpt, device, cli_extra)
    replicas = fleet[0]
    clients = []
    try:
        params, _, _ = restore_serving_state(lm_ckpt)
        kw = dict(buckets=LM_BUCKETS, slots=LM_SLOTS, max_batch=LM_TIER, batch_tiers=(1, 2, 4),
                  max_new_tokens=LM_NEW, prefix_cache_mb=FLEET_POOL_MB,
                  block_tokens=FLEET_BLOCK, prefill_chunk=FLEET_CHUNK, kv_transfer=True)
        bcfg = BatcherConfig(max_batch=LM_TIER, max_queue=64, max_in_flight=2)
        pre = Client(CausalLMEngine(CausalLM(cfg, device="meta"), params, device, **kw), bcfg)
        clients.append(pre)
        dec = Client(CausalLMEngine(CausalLM(cfg, device="meta"), params, device, **kw), bcfg,
                     recorder=FlightRecorder(4096))
        clients.append(dec)
        del params
        build_s = time.monotonic() - t0
        out = {"phase": "serve_lm_fleet", "build_s": build_s}
        for k, transport in enumerate(("d2d", "wire")):
            reqs = _fleet_requests(vocab, 12, 51 + k)
            want = _serve(pre, reqs)[0]
            pair = DisaggServingPair(
                prefill_batcher=pre.batcher, decode_batcher=dec.batcher,
                prefill_engine=pre.engine, decode_engine=dec.engine,
                budget=TransferBudget(1 << 30), transport=transport, metrics=dec.metrics,
                recorder=dec.recorder, timeout_s=300)
            out[transport] = _fleet_pair_run(pre, dec, pair, reqs, want)

        # Across processes: the references first, while the replicas load.
        http_reqs = _fleet_requests(vocab, 12, 61)
        mig_reqs = _fleet_requests(vocab, LM_SLOTS, 71)
        chaos_reqs = _fleet_requests(vocab, 4, 81)
        want = {}
        for reqs in (http_reqs, mig_reqs, chaos_reqs):
            want.update(_serve(pre, reqs)[0])
        extra_want = _serve(pre, list(extra_refs))[0] if extra_refs else {}
        out["replicas_ready_s"] = {name: _await_group(group, FLEET_LOGS / name)
                                   for name, group in replicas.items()}
        b = replicas["b"][1]
        pool, eng = pre.engine.prefix_cache, pre.engine
        sent, export_ms, post_ms = 0, [], []
        for r in http_reqs:
            t1 = time.monotonic()
            m = pool.match([int(t) for t in r["input_ids"]] + [0])  # every full page
            try:
                n = len(m.blocks)
                check(n > 0, f"chain of request {r['id']} not published")
                pk, pv = eng.export_prefix_pages(m.blocks)
                buf = serialize_chain(r["input_ids"][: n * FLEET_BLOCK], pk[:, :n], pv[:, :n],
                                      eng.page_meta())
            finally:
                pool.release(m)
            t2 = time.monotonic()
            reply = post_kv_transfer(*_host_port(b), buf, timeout_s=120)
            post_ms.append((time.monotonic() - t2) * 1e3)
            export_ms.append((t2 - t1) * 1e3)
            check(reply["adopted_blocks"] == n and reply["bytes"] == len(buf),
                  f"/v1/kv_transfer of request {r['id']}: {reply}, {n} blocks")
            sent += len(buf)
        replies, burst_s = _post_generates(b, http_reqs)
        diverged = [r["id"] for r in http_reqs
                    if replies[r["id"]][0] != 200 or replies[r["id"]][1]["tokens"] != want[r["id"]]]
        check(not diverged, f"decode role B's streams off the colocated ones: {diverged}")
        with urllib.request.urlopen(b + "/metrics?format=prom", timeout=60) as resp:
            prom = [ln for ln in resp.read().decode().splitlines()
                    if ln.startswith('serve_kv_transfer_bytes_total{role="decode"}')]
        check(prom and float(prom[0].split()[-1]) == sent,
              f"B's serve_kv_transfer_bytes_total {prom}, {sent} bytes sent")
        b_prefix = _get_json(b, "/statusz")["batcher"]["prefix_cache"]
        out["http"] = {"streams_equal_colocated": len(http_reqs), "bytes_sent": sent,
                       "chain_bytes_median": sent / len(http_reqs),
                       "export_serialize_ms_median": statistics.median(export_ms),
                       "post_ms_median": statistics.median(post_ms), "burst_s": burst_s,
                       "decode_prefix_cache": b_prefix}

        a, a2 = replicas["a"][1], replicas["a2"][1]
        out["migrate"] = _migrate(a, b, mig_reqs, want, "mig")
        check(all(out["migrate"]["pages"]), f"migrations without pages: {out['migrate']}")
        counts = {name: _get_json(replicas[name][1], "/metrics")["stream_migrations"]
                  for name in ("a", "b")}
        check(counts["a"].get("migrated") == LM_SLOTS and counts["b"].get("adopted") == LM_SLOTS,
              f"serve_stream_migrations_total: {counts}")
        chaos = _migrate(a2, b, chaos_reqs, want, "chaos")
        counts["b_after_chaos"] = _get_json(b, "/metrics")["stream_migrations"]
        check(chaos["pages"].count(False) == 1
              and counts["b_after_chaos"].get("rejected") == 1
              and counts["b_after_chaos"].get("adopted") == LM_SLOTS + len(chaos_reqs),
              f"chaos drill: {chaos}, B {counts['b_after_chaos']}")
        out.update(chaos=chaos, stream_migrations=counts)
    finally:
        for c in clients:
            c.close()
        if owned:
            stop_fleet(fleet)
    out["seconds"] = time.monotonic() - t0
    emit(out)
    return out, extra_want


# ---------------------------------------------------------- the fleet router

ROUTER_NAMES = ("a", "a2", "b")
ROUTER_HOP_N = 12  # requests timed direct and through the router, alternately


def _pinned(reqs: list, target: str, names, n: int) -> list:
    """The first ``n`` of ``reqs`` whose prompt head the router's
    rendezvous pick over ``names`` sends to ``target``."""
    from distributed_tensorflow_tpu_torch.serve.router import (
        RouterConfig,
        prefix_affinity_key,
        rendezvous_pick,
    )

    k = RouterConfig().affinity_tokens
    out = [r for r in reqs
           if rendezvous_pick(prefix_affinity_key(r["input_ids"], k), sorted(names)) == target]
    check(len(out) >= n, f"only {len(out)} of {len(reqs)} prompts pick {target}")
    return out[:n]


def router_requests(vocab: int) -> dict:
    """The seeded requests of :func:`phase_serve_lm_router`: 12 routed as
    they come, 4 sharing a 64-token head that the rendezvous pick sends to
    B (the replica with a prefix pool: the first seed whose head does), 4
    live on A for the hot swap, 4 live on A2 for the failover (picked over
    A2 and B: A is swapping then), one for the CLI and
    :data:`ROUTER_HOP_N` one-token greedy ones on B for the hop's ms."""
    from distributed_tensorflow_tpu_torch.serve.router import (
        RouterConfig,
        prefix_affinity_key,
        rendezvous_pick,
    )

    k = RouterConfig().affinity_tokens
    seed = next(sd for sd in range(41, 141)
                if rendezvous_pick(prefix_affinity_key(
                    _prefix_requests(vocab, 1, seed=sd)[0]["input_ids"], k),
                    sorted(ROUTER_NAMES)) == "b")
    prefix = _prefix_requests(vocab, 4, seed=seed)
    for i, r in enumerate(prefix):
        r["id"] = 9900 + i
    hop = [dict(r, temperature=0.0, budget=1)
           for r in _pinned(_fleet_requests(vocab, 96, 95), "b", ROUTER_NAMES, ROUTER_HOP_N)]
    return {"route": _fleet_requests(vocab, 12, 91), "prefix": prefix,
            "swap": _pinned(_fleet_requests(vocab, 64, 92), "a", ROUTER_NAMES, 4),
            "failover": _pinned(_fleet_requests(vocab, 64, 93), "a2", ("a2", "b"), 4),
            "cli": _fleet_requests(vocab, 1, 94), "hop": hop}


def _prom_value(base: str, name: str) -> float:
    with urllib.request.urlopen(base + "/metrics?format=prom", timeout=60) as resp:
        vals = [float(ln.split()[-1]) for ln in resp.read().decode().splitlines()
                if ln.startswith(name + " ") or ln.startswith(name + "{")]
    return sum(vals)


def phase_serve_lm_router(torch, fleet, want: dict, reqs: dict, *, device="cuda") -> dict:
    """The fleet router on the card, over :func:`spawn_fleet_replicas`'
    replicas (``fleet``, after serve_lm_fleet; the router has owned A
    since their start) with ``want`` the colocated streams of ``reqs``
    (:func:`router_requests`). Through ``build_router_server``: 12
    ``/v1/generate`` streams, each on its rendezvous pick and equal to the
    colocated one; 4 sharing a head all on B, counted as prefix hits there;
    an empty ``input_ids`` answered 400 with a minted ``rt-`` id and no
    retry; the router's hop (12 one-token requests on B, direct and
    through the router alternately, medians). Then ``hot_swap`` of A under a new tag
    with 4 of its paced streams live: the drain deadline migrates them to
    the survivors by ``/migratez``, the router collects each ``migrated``
    answer by ``/v1/stream_wait``, every stream equal to the colocated one,
    and A comes back ready on the new tag (stages drain, migrate, restart,
    ready). While A restarts: 4 streams live on A2 when A2 is SIGKILLed,
    each failed over and equal; A2 ``down`` and never restarted, nothing
    shed. And ``python -m distributed_tensorflow_tpu_torch.cli.router
    --adopt B`` as a process: one generate through it, then SIGTERM, exit
    0."""
    import signal

    from distributed_tensorflow_tpu_torch.serve.router import (
        build_router_server,
        prefix_affinity_key,
        rendezvous_pick,
    )

    groups, router, make_cmd = fleet
    base = {name: groups[name].base for name in ROUTER_NAMES}
    k = router.config.affinity_tokens
    t0 = time.monotonic()
    out = {"phase": "serve_lm_router", "device": device}

    def streams_equal(replies: dict, requests: list, what: str) -> None:
        bad = {r["id"]: replies.get(r["id"]) for r in requests
               if replies.get(r["id"], (None,))[0] != 200
               or replies[r["id"]][1].get("tokens") != want[r["id"]]}
        check(not bad, f"{what}: streams off the colocated ones: "
                       f"{ {i: str(v)[:300] for i, v in bad.items()} }")

    # The CLI adopts B only: it starts first and loads meanwhile.
    cli_port = _free_port()
    cli_log = FLEET_LOGS / "router_cli.log"
    with open(cli_log, "w") as fh:
        cli = subprocess.Popen(
            [sys.executable, "-m", "distributed_tensorflow_tpu_torch.cli.router",
             "--adopt", base["b"], "--port", str(cli_port), "--poll-interval", "0.25"],
            cwd=ROOT, env=_repo_env(), stdout=fh, stderr=subprocess.STDOUT)
    front = build_router_server(router, port=0)
    serve_thread = threading.Thread(target=front.serve_forever, daemon=True)
    serve_thread.start()
    front_base = "http://%s:%d" % front.server_address
    swap_box = {}
    swapper = None
    try:
        check(router.wait_ready(3, timeout=120), f"router: fleet not ready: {router.fleetz()}")
        z = router.fleetz()
        check(all(rep["supervisor"]["total_restarts"] == 0 for rep in z["replicas"]),
              f"router: a replica restarted before the phase: {z}")
        a_pid = z["replicas"][0]["pid"]

        # Routing: every stream on its rendezvous pick, equal to the colocated one.
        t1 = time.monotonic()
        replies, threads = _post_streams(front_base, reqs["route"], "router-route")
        _join_all(threads, "router routing")
        out["route_s"] = time.monotonic() - t1
        streams_equal(replies, reqs["route"], "router routing")
        placed = {r["id"]: replies[r["id"]][1]["replica"] for r in reqs["route"]}
        off_pick = {i: p for r in reqs["route"]
                    if (p := placed[r["id"]]) != rendezvous_pick(
                        prefix_affinity_key(r["input_ids"], k), sorted(ROUTER_NAMES))
                    for i in [r["id"]]}
        check(not off_pick, f"router routing: off the rendezvous pick {off_pick}")
        out["route_replicas"] = {name: list(placed.values()).count(name) for name in ROUTER_NAMES}

        # Prefix affinity: one head, one replica (B), its prefix hits.
        hits0 = _prom_value(base["b"], "serve_prefix_hits_total")
        first, rest = reqs["prefix"][0], reqs["prefix"][1:]
        replies, threads = _post_streams(front_base, [first], "router-prefix")
        _join_all(threads, "router prefix")
        more, threads = _post_streams(front_base, rest, "router-prefix")
        _join_all(threads, "router prefix")
        replies.update(more)
        streams_equal(replies, reqs["prefix"], "router prefix group")
        landed = {replies[r["id"]][1]["replica"] for r in reqs["prefix"]}
        hits = _prom_value(base["b"], "serve_prefix_hits_total") - hits0
        check(landed == {"b"} and hits >= len(rest),
              f"router prefix group landed on {landed}, B's prefix hits +{hits}")
        out["prefix"] = {"replica": "b", "prefix_hits": hits}

        # A malformed request is final: 400 with a minted id, no failover.
        retries0 = router.fleetz()["retries"]
        req = urllib.request.Request(front_base + "/v1/generate",
                                     data=json.dumps({"input_ids": []}).encode(),
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=60) as resp:
                code, body = resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as e:
            code, body = e.code, json.loads(e.read() or b"{}")
        rid = str(body.get("request_id", ""))
        check(code == 400 and rid.startswith("rt-") and len(rid) == 11
              and router.fleetz()["retries"] == retries0,
              f"router: empty input_ids answered {code} {body}")

        # The router's hop: the same short request direct to B and through
        # the router, alternately.
        direct_ms, routed_ms = [], []
        for i, r in enumerate(reqs["hop"]):
            payload = {**_payload(r), "input_ids": [int(t) for t in r["input_ids"]]}
            got = {}
            for where in (("direct", "routed") if i % 2 == 0 else ("routed", "direct")):
                body, secs = _post_json(base["b"] if where == "direct" else front_base,
                                        "/v1/generate", payload, timeout=60)
                (direct_ms if where == "direct" else routed_ms).append(secs * 1e3)
                got[where] = body
            check(got["routed"]["tokens"] == got["direct"]["tokens"]
                  and got["routed"].get("replica") == "b",
                  f"router hop request {r['id']}: {got}")
        out["hop"] = {"direct_ms_median": statistics.median(direct_ms),
                      "routed_ms_median": statistics.median(routed_ms),
                      "hop_ms": statistics.median(routed_ms) - statistics.median(direct_ms),
                      "n": len(direct_ms)}

        # Hot swap with A's paced streams live: the drain deadline migrates
        # them, the router collects each migrated answer.
        swap_replies, swap_threads = _post_streams(front_base, reqs["swap"], "router-swap")
        _await_live(base["a"], len(reqs["swap"]), "router swap")
        events0 = len(router.recorder.events())

        def swap():
            try:
                swap_box["result"] = router.hot_swap(make_cmd, expected_tag=ROUTER_SWAP_TAG)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                swap_box["error"] = e

        t_swap = time.monotonic()
        swapper = threading.Thread(target=swap, name="hot-swap", daemon=True)
        swapper.start()
        _join_all(swap_threads, "router hot swap")
        out["swap_streams_s"] = time.monotonic() - t_swap
        streams_equal(swap_replies, reqs["swap"], "router hot swap")
        # The migration's digest and A's restart are on the recorder.
        deadline = time.monotonic() + 60
        while not [e for e in router.recorder.events()[events0:]
                   if e["kind"] == "hot_swap" and e.get("stage") == "restart"]:
            check(time.monotonic() < deadline and swapper.is_alive(),
                  f"router hot swap: no restart stage ({swap_box})")
            time.sleep(0.05)

        # Failover while A restarts: A2 killed under 4 live streams.
        names = [rep["name"] for rep in router.fleetz()["replicas"] if rep["state"] == "ready"]
        check("a" not in names, f"router: A routable during its swap {names}")
        fo_replies, fo_threads = _post_streams(front_base, reqs["failover"], "router-failover")
        _await_live(base["a2"], len(reqs["failover"]), "router failover")
        retries0 = router.fleetz()["retries"]
        groups["a2"].procs[0].send_signal(signal.SIGKILL)
        t_kill = time.monotonic()
        _join_all(fo_threads, "router failover")
        out["failover_s"] = time.monotonic() - t_kill
        streams_equal(fo_replies, reqs["failover"], "router failover")
        moved = {fo_replies[r["id"]][1]["replica"] for r in reqs["failover"]}
        check("a2" not in moved, f"router failover: answered by {moved}")
        deadline = time.monotonic() + 60
        while (a2 := router.fleetz()["replicas"][1])["state"] != "down":
            check(time.monotonic() < deadline, f"router: A2 never marked down: {a2}")
            time.sleep(0.05)

        # The CLI: one generate through it, then SIGTERM.
        deadline = time.monotonic() + 120
        while True:
            check(cli.poll() is None, f"cli.router exited {cli.returncode}:\n"
                                      f"{cli_log.read_text()[-4000:]}")
            try:
                if _get_json(f"http://127.0.0.1:{cli_port}", "/healthz")["n_ready"] == 1:
                    break
            except OSError:
                pass
            check(time.monotonic() < deadline, "cli.router not ready within 120 s")
            time.sleep(0.1)
        replies, threads = _post_streams(f"http://127.0.0.1:{cli_port}", reqs["cli"], "router-cli")
        _join_all(threads, "cli.router")
        streams_equal(replies, reqs["cli"], "cli.router")
        cli.send_signal(signal.SIGTERM)
        try:
            rc = cli.wait(timeout=60)
        except subprocess.TimeoutExpired:
            rc = None
        check(rc == 0, f"cli.router after SIGTERM: exit {rc}:\n{cli_log.read_text()[-4000:]}")

        # A back on the new tag.
        swapper.join(timeout=300)
        check(not swapper.is_alive(), "router hot swap still running after 300 s")
        if "error" in swap_box:
            raise swap_box["error"]
        swapped = swap_box["result"]["swapped"]
        z = router.fleetz()
        a, a2 = z["replicas"][0], z["replicas"][1]
        check(swapped == [{"replica": "a", "tag": ROUTER_SWAP_TAG}] and a["state"] == "ready"
              and a["tag"] == ROUTER_SWAP_TAG and a["pid"] != a_pid,
              f"router hot swap: {swap_box['result']}, A {a}")
        check(a2["state"] == "down" and not a2["owned"]
              and a2["supervisor"]["total_restarts"] == 0,
              f"router: A2 after its kill {a2}")
        check(z["shed"] == 0 and z["door_429"] == 0 and z["stream_migrations"] == 1
              and z["retries"] >= retries0 + len(reqs["failover"]),
              f"router fleetz after the drills: {z}")
        stages = {e["stage"]: e for e in router.recorder.events()[events0:]
                  if e["kind"] == "hot_swap" and e.get("replica") == "a"}
        check(list(stages) == ["drain", "migrate", "restart", "ready"],
              f"router hot swap stages {list(stages)}")
        mig = stages["migrate"]
        check(mig["exported"] == len(reqs["swap"]) and mig["migrated"] == len(reqs["swap"]),
              f"router hot swap migration {mig}")
        out["hot_swap"] = {
            "drain_to_migrated_s": stages["migrate"]["t"] - stages["drain"]["t"],
            "migrated_to_relaunched_s": stages["restart"]["t"] - stages["migrate"]["t"],
            "relaunched_to_ready_s": stages["ready"]["t"] - stages["restart"]["t"],
            "exported": mig["exported"], "migrated": mig["migrated"],
            "drain_timeout_s": router.config.drain_timeout_s}
        out["fleetz"] = {"retries": z["retries"], "shed": z["shed"], "door_429": z["door_429"],
                         "stream_migrations": z["stream_migrations"],
                         "requests": {rep["name"]: rep["requests"] for rep in z["replicas"]}}
    finally:
        front.shutdown()
        front.server_close()
        serve_thread.join(timeout=30)
        if cli.poll() is None:
            _stop(cli)
        if swapper is not None:
            swapper.join(timeout=300)
    out["seconds"] = time.monotonic() - t0
    emit(out)
    return out


# ----------------------------------------------------- four cards (--cards 4)

CARDS = 4  # the width of the --cards mode: one process a card, NCCL between them
DP4_RANK_ROWS = 128  # ResNet-50 images a rank (the one-card training cell's batch)
DP4_ROWS = DP4_RANK_ROWS * CARDS
# The ranks' state after DP steps 1 and 2 against four `fused` shards
# averaged by hand in this process. NCCL sums the four gradients in its own
# order (a ring, each chunk from another rank first), so the two differ by
# fp32 rounding, not bit for bit as at world 2: each part's relative L2
# error, the params against the step's update, the momentum and the
# BatchNorm statistics against their own norm, must stay within DP4_RTOL,
# and the hand average with one rank's shard left out must not.
DP4_RTOL = 1e-3
MP4_ROWS = 32  # BERT's global batch: PP 4 at M = 16 takes 2 rows a microbatch
# The serving groups at width 4 (the layout; the checkpoint: "tp" the TP x SP
# CLI's, "moe" a seeded 8-expert stacked one; the serve CLI's flags;
# flash_fwd a bucket-512 request a rank: 12 layers, or PP's 3 a stage at
# M = 1).
SERVE4_LAYOUTS = {
    "tp4": ("tp", ["--tp", "4"], 12),
    "ep4": ("moe", ["--moe-experts", "8", "--pp", "4", "--mesh", "expert=4"], 12),
    "pp4": ("moe", ["--moe-experts", "8", "--pp", "4"], 3),
}
LM4_STEPS = 8  # lm_base steps under --tensor-parallel 4 (a constant 3e-4)
# The follower-kill drill: the group's collectives time out after
# DRILL_TIMEOUT_S (NCCL's watchdog may then end a rank stuck in one). The
# leader must end within its stated time: its cell raised (a request
# refused with the group's error) within DRILL_LIMIT_S of the kill, or its
# process ended within DRILL_WATCH_S. The front end giving up on a stuck
# request after its own 60 s (serve/server.py: HTTP 500, no error) is not
# the leader failing.
DRILL_TIMEOUT_S = 30
DRILL_LIMIT_S = 75
DRILL_WATCH_S = 120


def _torchrun(tail: list, nproc: int = CARDS) -> list:
    """``python -m torch.distributed.run`` (torchrun) of ``tail`` on
    ``nproc`` processes of this host, at a free port."""
    return [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(nproc),
            "--master-addr", "127.0.0.1", "--master-port", str(_free_port()), *tail]


def _group_line(backend: str, world: int, rank: int, device: str) -> str:
    """A rank's ``process group`` log line: rank i on ``cuda:i``, or the CPU."""
    return (f"backend={backend} world={world} rank={rank} device="
            + (f"cuda:{rank}" if device == "cuda" else device))


def _check_ranks_logged(log: str, what: str, backend: str = "nccl", device: str = "cuda",
                        world: int = CARDS) -> list:
    """Every rank's ``process group`` line: ``backend``, ``world`` ranks,
    rank i on ``cuda:i`` (or the CPU). Returns the lines."""
    lines = sorted(ln.split("process group: ", 1)[1] for ln in log.splitlines()
                   if "process group: " in ln)
    want = [_group_line(backend, world, r, device) for r in range(world)]
    check(lines == want, f"{what}: process group lines {lines}, expected {want}")
    return lines


def phase_link() -> dict:
    """The link between the cards as ``nvidia-smi`` reports it: ``topo -m``
    (its text, where the machine lets it run) and, per card, the active
    NVLink links and their rate (``nvlink --status``)."""
    def smi(*args):
        return subprocess.run(["nvidia-smi", *args], capture_output=True, text=True,
                              timeout=60).stdout

    topo, links, gpu = smi("topo", "-m"), {}, None
    for ln in smi("nvlink", "--status").splitlines():
        if ln.startswith("GPU "):
            gpu = ln.split(":")[0]
            links[gpu] = []
        elif gpu is not None and "Link" in ln and "GB/s" in ln:
            links[gpu].append(float(ln.split(":", 1)[1].split()[0]))
    out = {"phase": "link", "topo_m": topo.strip(),
           "nvlink": {g: {"active_links": len(v), "gb_s_each": v[0] if v else None,
                          "gb_s_total": sum(v)} for g, v in links.items()}}
    emit(out)
    return out


def phase_kernel_cards(fm, torch) -> dict:
    """The flash kernels at the shapes the four-card layouts give them,
    against their plain versions: 3 local heads (BERT-base's 12 over TP 4,
    and Ulysses 4's heads after its all-to-all) at 32 rows x L = 512, and
    the ring's 128-key blocks (L = 128 of each of 4 hops, 12 heads), forward
    and backward (with the lse cotangent the ring's merge feeds back),
    unpadded (the layouts' batch) and padded with a fully masked row; the
    forward, backward, plain and SDPA times and the bound of the unpadded
    case."""
    shapes = {"heads3": (MP4_ROWS, 512, 3, 64), "ring_block128": (MP4_ROWS, 128, 12, 64)}
    gen = torch.Generator("cuda").manual_seed(SEED + 40)
    bf16 = torch.bfloat16
    out = {}
    for name, (b, l, h, d) in shapes.items():
        rec = {"B": b, "L": l, "H": h, "D": d, "dtype": "bfloat16"}
        for pad in (False, True):
            (q, k, v, do), valid, mask = _masked_inputs(torch, gen, b, l, h, d, bf16, 4, pad)
            o, lse = fm.flash_fwd_cuda(q, k, v, mask)
            fwd_err, lse_err = _check_fwd(fm, torch, o, lse, q, k, v, mask, b, l, h, d, bf16,
                                          pad)
            dlse = torch.randn(lse.shape, device="cuda", generator=gen)
            bwd_err = _check_bwd(fm, torch, q, k, v, mask, o, lse, do, dlse, (b, l, h, d),
                                 bf16, pad)
            rec["padded" if pad else "unpadded"] = {
                "fwd_max_abs_err": fwd_err, "lse_err": lse_err,
                "dq_max_abs_err": bwd_err["dq"], "dkv_max_abs_err": bwd_err["dkv"]}
            if pad:
                continue
            keys = valid.tolist()
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            delta = fm.flash_bwd_delta(o, do)
            args = (q, k, v, mask, do, lse, delta)
            library = _sdpa_backward_ms(torch, q, k, v, mask, do)
            rec["flash_fwd"] = {
                "ms": cuda_ms(lambda: fm.flash_fwd_cuda(q, k, v, mask), 20),
                "plain_ms": cuda_ms(lambda: fm.flash_attention_reference(q, k, v, mask), 5),
                "library_ms": cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask[:, None, None, :]), 20),
                **dict(zip(("bound_ms", "bound_by"), flash_bound(b, l, h, d, keys, 2, False)))}
            rec["flash_bwd_dq"] = {
                "ms": cuda_ms(lambda: fm.flash_bwd_dq_cuda(*args), 10),
                "plain_ms": cuda_ms(lambda: fm.flash_bwd_dq_reference(*args), 3),
                "library_ms": library["q"],
                **dict(zip(("bound_ms", "bound_by"),
                           bwd_bound(b, l, h, d, keys, 2, False, 3, 5, 2)))}
            rec["flash_bwd_dkv"] = {
                "ms": cuda_ms(lambda: fm.flash_bwd_dkv_cuda(*args), 10),
                "plain_ms": cuda_ms(lambda: fm.flash_bwd_dkv_reference(*args), 3),
                "library_ms": library["kv"],
                **dict(zip(("bound_ms", "bound_by"),
                           bwd_bound(b, l, h, d, keys, 2, False, 4, 6, 2)))}
        emit({"phase": "kernel_cards", "shape": name, **rec})
        out[name] = rec
    return out


def _hand_step(dp, state, grads: list, stats: list) -> None:
    """One SGD update of ``state`` from the mean of the shards' gradients,
    and the mean of their statistics as its BatchNorm state."""
    mean = _tree_mean(grads)
    for name, p in state.params.items():
        p.grad = mean[name]
    state.opt_state.apply()
    for p in state.params.values():
        p.grad = None
    state.model_state = {"batch_stats": _tree_mean(stats)}


def _dp_errors(dp, saved: dict, state, start: dict, torch) -> dict:
    """Relative L2 errors of rank 0's saved state against ``state`` (the
    hand's): params against the step's update from ``start``, momentum and
    BatchNorm statistics against their own norm."""
    def rel(got: dict, want: dict, ref: dict | None = None) -> float:
        check(got.keys() == want.keys(), "DP state: leaf names differ")
        num = den = 0.0
        for k, w in want.items():
            w = w.detach().double()
            num += float((got[k].to(w.device).double() - w).square().sum())
            den += float((w - (ref[k].double() if ref is not None else 0.0)).square().sum())
        return math.sqrt(num / max(den, 1e-300))

    slots = dp.slots(state)
    return {"params": rel(saved["params"], state.params, start),
            "momentum": rel({f"{k}/{n}": t for k, s in saved["slots"].items()
                             for n, t in s.items()},
                            {f"{k}/{n}": t for k, s in slots.items() for n, t in s.items()}),
            "batch_stats": rel(saved["batch_stats"], state.model_state["batch_stats"])}


def phase_train_dp_cards(torch) -> dict:
    """Full-width ResNet-50 ``fused`` as four NCCL ranks, one a card
    (``scripts/torch_dp_train.py``), 128 images a rank of one fixed global
    batch of 512: the ranks' params, momentum and batch_stats bitwise equal
    after every step (digests); steps 1 and 2 held against four 128-row
    ``fused`` shards averaged by hand in this process within
    :data:`DP4_RTOL` (and the average with one shard left out outside it);
    29 launches of each fused kernel a step on every rank; then K = 4 stale
    gradients for K + 2 steps, beside the hand checks (lockstep, launches,
    params still for K steps, then moved). Prints ms a step, images/s and
    the all-reduce's ms of the 25.6 M-float bucket."""
    dp = load_dp_train()
    out_dir = ROOT / "build" / "chip_smoke_dp4_train"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    t0 = time.monotonic()
    # NCCL's own account of the link it found (its topology search and each
    # channel's transport), in files beside the ranks' output.
    nccl_log = ROOT / "build" / "chip_smoke_dp_logs" / "nccl"
    ranks = _dp_launch(CARDS, "nccl", "--steps", "3", "--rows", str(DP4_ROWS), "--save",
                       str(out_dir), env={"NCCL_DEBUG": "INFO",
                                          "NCCL_DEBUG_SUBSYS": "INIT,GRAPH",
                                          "NCCL_DEBUG_FILE": f"{nccl_log}.%p.log"})
    seconds = time.monotonic() - t0
    link = sorted({ln.split("NCCL INFO ", 1)[1].strip()
                   for f in nccl_log.parent.glob("nccl.*.log") for ln in f.read_text().splitlines()
                   if "NCCL INFO " in ln and any(w in ln for w in (" type ", " via ", "NVLS"))})
    check([r["device"] for r in ranks] == [f"cuda:{r}" for r in range(CARDS)],
          f"DP ranks' devices {[r['device'] for r in ranks]}")
    for rank in ranks:
        check({k: v for k, v in rank["launches"].items() if v}
              == {k: 3 * v for k, v in DP_LAUNCHES.items()},
              f"rank {rank['rank']} launches {rank['launches']}")
        check(rank["allreduce_ok"], f"rank {rank['rank']}: the NCCL all-reduce's sum is wrong")
        check(rank["digests"] == ranks[0]["digests"] and len(rank["digests"]) == 3,
              f"the ranks' states differ: {[r['digests'] for r in ranks]}")
        check(rank["losses"] == ranks[0]["losses"], "the ranks' losses differ")
    losses = ranks[0]["losses"]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], f"losses {losses}")

    def hand_checks():
        """Steps 1 and 2 by hand, and the planted fault at step 1."""
        dp.numerics()
        model, state, _ = dp.build("cuda")
        batch = dp.fixed_batch(DP4_ROWS, "cuda")
        errors, first = {}, None
        for step in (1, 2):
            start = {k: v.detach().clone() for k, v in state.params.items()}
            grads, stats = _hand_shards(model, state.params, state.model_state, batch,
                                        DP4_RANK_ROWS, torch)
            first = first or (grads, stats)
            _hand_step(dp, state, grads, stats)
            saved = torch.load(out_dir / f"dp_step{step}.pt", weights_only=True)
            errors[step] = _dp_errors(dp, saved, state, start, torch)
            del grads, stats
        # The planted fault: step 1 from the same start with the last rank's
        # shard left out of the average.
        _, fresh, _ = dp.build("cuda")
        start = {k: v.detach().clone() for k, v in fresh.params.items()}
        _hand_step(dp, fresh, first[0][:-1], first[1][:-1])
        fault = _dp_errors(dp, torch.load(out_dir / "dp_step1.pt", weights_only=True), fresh,
                           start, torch)
        del model, state, fresh, first, batch
        torch.cuda.empty_cache()
        return errors, fault

    depth = DP_STALENESS
    t1 = time.monotonic()
    (errors, fault), stale = concurrently(
        (hand_checks,),
        (_dp_launch, CARDS, "nccl", "--steps", str(depth + 2), "--rows", str(DP4_ROWS),
         "--mode", "stale", "--staleness", str(depth)))
    stale_seconds = time.monotonic() - t1
    for step, err in errors.items():
        check(all(e <= DP4_RTOL for e in err.values()),
              f"DP step {step} against the hand average of four shards: {err}")
    check(any(e > DP4_RTOL for e in fault.values()),
          f"the hand average without one shard passed the DP check: {fault}")
    for rank in stale:
        check(rank["digests"] == stale[0]["digests"] and len(rank["digests"]) == depth + 2,
              f"stale ranks' states differ: {[r['digests'] for r in stale]}")
        check({k: v for k, v in rank["launches"].items() if v}
              == {k: (depth + 2) * v for k, v in DP_LAUNCHES.items()},
              f"stale rank {rank['rank']} launches {rank['launches']}")
    pd, stale_losses = stale[0]["param_digests"], stale[0]["losses"]
    check(len(set(pd[:depth])) == 1 and len(set(pd[depth - 1:])) == 3,
          f"stale params: digests {pd}")
    check(stale_losses[depth + 1] != stale_losses[depth], f"stale losses {stale_losses}")
    step_ms = statistics.median(r["step_ms_median"] for r in ranks)
    out = {"phase": "train_dp_cards", "seconds": seconds, "world": CARDS, "backend": "nccl",
           "devices": [r["device"] for r in ranks], "global_rows": DP4_ROWS,
           "rank_rows": DP4_RANK_ROWS, "losses": losses,
           "step_ms": {r["rank"]: r["step_ms"] for r in ranks},
           "step_ms_median": {r["rank"]: r["step_ms_median"] for r in ranks},
           "images_per_s": DP4_ROWS / step_ms * 1e3,
           "allreduce_ms": {r["rank"]: r["allreduce_ms"] for r in ranks},
           "bucket_numel": ranks[0]["bucket_numel"],
           "peak_mem_gb": {r["rank"]: r["peak_mem_gb"] for r in ranks},
           "launches": {r["rank"]: r["launches"] for r in ranks},
           "vs_hand_average_rel_err": errors, "rtol": DP4_RTOL,
           "planted_fault_rel_err": fault}
    emit(out)
    emit({"phase": "train_dp_cards_link",
          "channel_transports": sorted({ln.split(" via ", 1)[1] for ln in link if " via " in ln}),
          "channels": sum(" via " in ln for ln in link),
          "graph": [ln for ln in link if " via " not in ln][:20]})
    emit({"phase": "train_dp_cards_stale", "seconds": stale_seconds, "staleness": depth,
          "losses": stale_losses, "step_ms_median": {r["rank"]: r["step_ms_median"]
                                                      for r in stale},
          "launches": {r["rank"]: r["launches"] for r in stale}})
    return out


def phase_train_cli_image_cards(torch) -> dict:
    """``cli.train --config imagenet_resnet50 --image-size 64`` under
    torchrun at four processes (NCCL, one a card) on the seeded u8 cache,
    3 steps with a checkpoint that a ``Checkpointer`` restores here (the
    step and every BatchNorm running average)."""
    from distributed_tensorflow_tpu_torch.ckpt import Checkpointer
    from distributed_tensorflow_tpu_torch.cli.train import PRESETS, _make_tx
    from distributed_tensorflow_tpu_torch.models import ResNet50
    from distributed_tensorflow_tpu_torch.train import create_train_state
    from distributed_tensorflow_tpu_torch.train.objectives import init_model

    cache = load_feed_bench().write_cache(ROOT / "build" / "chip_smoke_u8", FEED_IMAGES,
                                          FEED_HW, seed=SEED)
    ckpt_dir = ROOT / "build" / "chip_smoke_dp4_cli"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    t0 = time.monotonic()
    ((code, out, err),) = _run_ranks([_torchrun(
        ["-m", "distributed_tensorflow_tpu_torch.cli.train", "--config", "imagenet_resnet50",
         "--image-size", "64", "--global-batch", "64", "--steps", "3", "--lr", "0.05",
         "--log-every", "1", "--data-dir", str(cache), "--ckpt-dir", str(ckpt_dir)])],
        ROOT / "build" / "chip_smoke_dp4_cli_logs", 600)
    log = out + err
    seconds = time.monotonic() - t0
    check(code == 0, f"cli.train under torchrun exited {code}:\n{log[-4000:]}")
    groups = _check_ranks_logged(log, "cli.train imagenet_resnet50 under torchrun")
    steps = [ln for ln in log.splitlines() if "train.loop: step" in ln]
    check(len(steps) == 3 and all("loss=nan" not in ln for ln in steps), f"log: {steps}")
    check("mesh={'data': 4}" in log, "the CLI's mesh is data=4")
    model = ResNet50(dtype=torch.bfloat16, device="cuda")
    params, model_state = init_model(model)
    tx, _ = _make_tx(PRESETS["imagenet_resnet50"])
    state, step = Checkpointer(ckpt_dir).restore_latest(create_train_state(params, tx,
                                                                           model_state))
    stats = state.model_state["batch_stats"]
    check(step == 3 and all(not torch.equal(stats[k], model_state["batch_stats"][k])
                            for k in stats), f"restored step {step} and its batch_stats")
    del model, params, model_state, state
    out = {"phase": "train_cli_image_cards", "seconds": seconds, "groups": groups,
           "last_log": steps[-1].split(": ", 1)[-1], "restored_step": step}
    emit(out)
    return out


def phase_train_cli_tp_sp_cards(torch, fm, *, device="cuda", backend="nccl", cli_extra=(),
                                cfg=None) -> tuple[Path, int]:
    """``cli.train`` (the bert_base recipe at 512 positions, through
    ``scripts/torch_mp_train.py --cli``) under torchrun at four processes
    over NCCL with ``--tensor-parallel 2 --seq-parallel 2 --sp-impl ring``,
    8 rows, 3 steps; its global checkpoint restored here at TP 1 and served
    through ``BertInferenceEngine`` and ``/v1/mlm`` (12 ``flash_fwd``).
    ``device="cpu"`` and ``backend="gloo"`` with ``cli_extra`` (geometry
    flags) and the matching ``cfg`` rehearse it."""
    from distributed_tensorflow_tpu_torch.models.bert import BertConfig

    cfg = cfg or BertConfig(dropout_rate=0.1, dtype=torch.bfloat16)  # 512 positions
    steps = 3
    ckpt_dir = ROOT / "build" / "chip_smoke_cli4_tp_sp"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    t0 = time.monotonic()
    ((code, out, err),) = _run_ranks([_torchrun(
        [str(ROOT / "scripts" / "torch_mp_train.py"), "--cli", "--config", "bert_base_l512",
         "--tensor-parallel", "2", "--seq-parallel", "2", "--sp-impl", "ring", "--steps",
         str(steps), "--global-batch", "8", "--log-every", "1", "--ckpt-dir", str(ckpt_dir),
         "--device", device, "--backend", backend, *cli_extra])],
        ROOT / "build" / "chip_smoke_cli4_tp_sp_logs", 600)
    log = out + err
    cli_s = time.monotonic() - t0
    check(code == 0, f"cli.train --tensor-parallel 2 --seq-parallel 2 under torchrun exited "
                     f"{code}:\n{log[-4000:]}")
    groups = _check_ranks_logged(log, "cli.train TP x SP under torchrun", backend, device)
    lines = [ln for ln in log.splitlines() if "train.loop: step" in ln]
    check(len(lines) == steps and all("loss=nan" not in ln for ln in lines)
          and "layout=sp2-tp2" in log, f"log: {lines}")
    t0 = time.monotonic()
    launches = _serve_checkpoint(torch, fm, ckpt_dir, cfg, device, steps,
                                 "TP x SP checkpoint (four cards)")
    emit({"phase": "train_cli_tp_sp_cards", "cli_seconds": cli_s, "groups": groups,
          "serve_seconds": time.monotonic() - t0, "last_log": lines[-1].split(": ", 1)[-1],
          "restored_step": steps, "serve_flash_fwd_launches": launches, "bucket": 512})
    return ckpt_dir, launches


def _spawn_torchrun_group(flags: list, log_dir: Path, device: str = "cuda",
                          world: int = CARDS) -> ServeGroup:
    """``cli.serve`` under torchrun as ``world`` NCCL processes, one a card
    (``scripts/torch_mp_train.py --serve``), the leader serving HTTP on a
    free port. The processes' output goes to ``log_dir/rank0.log``; their
    launch logs and pid files to ``log_dir/rank<r>.json``."""
    shutil.rmtree(log_dir, ignore_errors=True)
    log_dir.mkdir(parents=True)
    port = _free_port()
    with open(log_dir / "rank0.log", "w") as fh:
        proc = subprocess.Popen(
            _torchrun([str(ROOT / "scripts" / "torch_mp_train.py"), "--serve", *flags,
                       "--device", device, "--port", str(port), "--launch-log",
                       str(log_dir / "rank{rank}.json")], world),
            cwd=ROOT, env=_repo_env(), stdout=fh, stderr=subprocess.STDOUT)
    return ServeGroup([proc], f"http://127.0.0.1:{port}", time.monotonic(), world,
                      log_dir / "rank0.json.pid")


def phase_serve_bert_cards(torch, tp_dir: Path, *, device="cuda", backend="nccl",
                           cli_extra=(), cfg=None, during=None) -> tuple:
    """Full-width BERT-base (512 positions, fp32) served by ``cli.serve``
    under torchrun as four NCCL processes, one a card, under each of
    :data:`SERVE4_LAYOUTS`: TP 4 (3 heads a rank) on the TP x SP CLI's
    checkpoint, and EP 4 (8 experts, 2 a rank, replicated dispatch) and PP
    4 (M = 1) on a seeded 8-expert checkpoint with a stacked encoder
    written here. Each answer held to the one-process engine's at the
    ``SERVE_GROUP_*`` tolerances, and ``flash_fwd`` launches a request a
    rank exact. ``during()``, when given, runs while the groups load (after
    the one-process references); returns ``(flash launches a request a rank
    by layout, during's result)``. ``device="cpu"`` and ``backend="gloo"``
    with ``cli_extra`` (geometry flags) and the matching ``cfg`` rehearse
    it."""
    from distributed_tensorflow_tpu_torch import ckpt
    from distributed_tensorflow_tpu_torch.ckpt import restore_serving_state
    from distributed_tensorflow_tpu_torch.models.bert import BertConfig, BertForPreTraining
    from distributed_tensorflow_tpu_torch.serve import BertInferenceEngine

    cfg = dataclasses.replace(cfg or BertConfig(), dtype=torch.float32)  # 512 positions
    moe_cfg = dataclasses.replace(cfg, moe_experts=8, pipeline_parallel=CARDS)
    moe_dir = ROOT / "build" / "chip_smoke_cards_moe"
    shutil.rmtree(moe_dir, ignore_errors=True)
    model = BertForPreTraining(moe_cfg, device=device, seed=SEED + 4)
    ckpt.save(moe_dir, 1, {k: v.detach() for k, v in model.state_dict().items()})
    del model
    dirs = {"tp": tp_dir, "moe": moe_dir}
    rng = np.random.default_rng(SEED + 21)
    ids = rng.integers(5, cfg.vocab_size, size=300)
    payload = {"input_ids": ids.tolist(), "mlm_targets": ids.tolist()}
    timed = [rng.integers(5, cfg.vocab_size, size=int(n)).tolist()
             for n in rng.integers(257, 513, SERVE_GROUP_TIMED)]
    common = ["--config", "bert_base_l512_f32", "--buckets", "512", "--max-batch", "1",
              "--batch-tiers", "1", "--max-delay-ms", "1", "--backend", backend, *cli_extra]
    logs = {name: ROOT / "build" / f"chip_smoke_serve_{name}" for name in SERVE4_LAYOUTS}
    groups = {name: _spawn_torchrun_group(common + ["--ckpt-dir", str(dirs[ck]),
                                                    "--comm-timer-file",
                                                    str(logs[name] / "timer_on")] + flags,
                                          logs[name], device)
              for name, (ck, flags, _) in SERVE4_LAYOUTS.items()}

    def reference(kind):
        params, _, _ = restore_serving_state(dirs[kind])
        engine = BertInferenceEngine(BertForPreTraining(cfg if kind == "tp" else moe_cfg,
                                                        device="meta"),
                                     params, device, buckets=(512,), max_batch=1,
                                     batch_tiers=(1,))
        out = engine.run_batch([{k: np.asarray(v) for k, v in payload.items()}])[0]
        del engine, params
        if device == "cuda":
            torch.cuda.empty_cache()
        return out

    try:
        refs = [reference("tp"), reference("moe")]
        extra = during() if during is not None else None
        return _serve_groups(groups, refs, payload, timed, len(ids), device, SERVE4_LAYOUTS,
                             CARDS, backend, gated=True), extra
    finally:
        for name, g in groups.items():
            _stop_group(g, ROOT / "build" / f"chip_smoke_serve_{name}", check_exit=False)
        shutil.rmtree(moe_dir, ignore_errors=True)


def phase_train_lm_cards(torch, *, device="cuda", backend="nccl", cli_extra=()) -> Path:
    """``cli.train --config lm_base --tensor-parallel 4`` under torchrun at
    four processes over NCCL (3 heads a rank), :data:`LM4_STEPS` steps of
    the preset's 256 rows at a constant 3e-4, with a checkpoint.
    ``device="cpu"`` and ``backend="gloo"`` with ``cli_extra`` rehearse it."""
    ckpt_dir = ROOT / "build" / "chip_smoke_lm4"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    t0 = time.monotonic()
    ((code, out, err),) = _run_ranks([_torchrun(
        ["-m", "distributed_tensorflow_tpu_torch.cli.train", "--config", "lm_base",
         "--tensor-parallel", str(CARDS), "--steps", str(LM4_STEPS), "--lr-schedule",
         "constant", "--lr", "3e-4", "--log-every", "1", "--ckpt-dir", str(ckpt_dir),
         "--device", device, *cli_extra])],
        ROOT / "build" / "chip_smoke_lm4_logs", 600)
    log = out + err
    check(code == 0, f"lm_base --tensor-parallel 4 exited {code}:\n{log[-4000:]}")
    groups = _check_ranks_logged(log, "lm_base under torchrun", backend, device)
    lines = [ln for ln in log.splitlines() if "train.loop: step" in ln]
    check(len(lines) == LM4_STEPS and all("loss=nan" not in ln for ln in lines)
          and "layout=tp4" in log, f"lm_base --tensor-parallel 4 log: {lines}")
    emit({"phase": "train_lm_cards", "seconds": time.monotonic() - t0, "groups": groups,
          "first_log": lines[0].split(": ", 1)[-1], "last_log": lines[-1].split(": ", 1)[-1]})
    return ckpt_dir


def _follower_kill_drill(group, log_dir: Path, vocab: int) -> dict:
    """A follower SIGKILLed while the leader decodes (32 streams through 8
    slots, a second in), and how the leader ends: its cell raised, as over
    gloo (a request refused with HTTP 500 and the group's error, within
    :data:`DRILL_LIMIT_S`), or its process ended (NCCL's watchdog aborting
    a collective that waits for the dead rank, within
    :data:`DRILL_WATCH_S`). Fails if neither, or if an in-flight request
    never ends. Records when the front end first gave up on a stuck request,
    every thread's stack (SIGUSR1) unless the cell raised, and the last
    lines the leader's log has on the group, NCCL and the watchdog."""
    import signal

    procs, base = group.procs, group.base
    rng = np.random.default_rng(SEED + 77)
    load = [{"id": 500 + i, "input_ids": rng.integers(4, vocab, 16), "temperature": 0.0,
             "seed": 0, "budget": LM_NEW} for i in range(32)]
    box = {}
    loader = threading.Thread(target=lambda: box.update(_post_generates(base, load)[0]),
                              daemon=True)
    loader.start()
    time.sleep(1.0)  # the streams are decoding
    t_kill = time.monotonic()
    procs[-1].kill()
    raised = ended = front_end_gave_up_s = None
    probe = {"input_ids": rng.integers(4, vocab, 8).tolist(), "max_new_tokens": 2}
    while raised is None and ended is None and time.monotonic() - t_kill < DRILL_LIMIT_S:
        if procs[0].poll() is not None:
            ended = ("process ended", procs[0].returncode)
            break
        req = urllib.request.Request(base + "/v1/generate", data=json.dumps(probe).encode(),
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(
                    req, timeout=max(1.0, DRILL_LIMIT_S - (time.monotonic() - t_kill))):
                pass  # the group still answered: not failed yet
        except urllib.error.HTTPError as e:
            body = e.read().decode(errors="replace")
            try:
                error = json.loads(body).get("error")
            except ValueError:
                error = body
            if e.code == 500 and error:
                raised = (time.monotonic() - t_kill, error[:300])
            elif e.code == 500 and front_end_gave_up_s is None:
                front_end_gave_up_s = time.monotonic() - t_kill
        except OSError as e:
            if not isinstance(getattr(e, "reason", e), TimeoutError):  # not a slow answer
                ended = ("no connection", repr(e)[:300])
        time.sleep(0.1)
    if raised is None and procs[0].poll() is None:
        # Where the leader waits: every thread's stack into its log.
        procs[0].send_signal(signal.SIGUSR1)
    # A leader whose cell raised serves on, refusing every request; one
    # stuck in a collective is watched for its end.
    while raised is None and procs[0].poll() is None and time.monotonic() - t_kill < DRILL_WATCH_S:
        time.sleep(0.5)
    leader_rc = procs[0].poll()
    leader_end_s = time.monotonic() - t_kill if leader_rc is not None else None
    loader.join(timeout=max(1.0, DRILL_WATCH_S - (time.monotonic() - t_kill)))
    hung = loader.is_alive()
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait(timeout=30)
    statuses = {}
    for status, _ in box.values():
        statuses[str(status)] = statuses.get(str(status), 0) + 1
    log = (log_dir / "rank0.log").read_text()
    notes = [ln.strip()[:300] for ln in log.splitlines()
             if any(w in ln for w in ("Watchdog", "watchdog", "NCCL", "serving group broken",
                                      "timed out", "group.py", "distributed_c10d.py"))]
    out = {"killed_rank": len(procs) - 1,
           "leader_raised_s": raised[0] if raised else None,
           "leader_error": raised[1] if raised else None, "leader_unreachable": ended,
           "front_end_gave_up_s": front_end_gave_up_s,
           "leader_exit": leader_rc, "leader_end_s": leader_end_s,
           "in_flight_statuses": statuses, "in_flight_hung": hung,
           "collective_timeout_s": DRILL_TIMEOUT_S, "limit_s": DRILL_LIMIT_S,
           "watch_s": DRILL_WATCH_S, "leader_log_notes": notes[-12:]}
    check((raised is not None or (leader_rc is not None and leader_end_s <= DRILL_WATCH_S))
          and not hung, f"the leader after a follower's SIGKILL: {out}")
    return out


def phase_serve_lm_cards(torch, lm_ckpt: Path, *, device="cuda", backend="nccl",
                         cli_extra=(), cfg=None) -> dict:
    """The TP 4 checkpoint served by ``cli.serve --config lm_base_f32 --tp
    4`` as four NCCL processes launched with the cluster flags
    (``--coordinator-address --num-processes --process-id``), one a card:
    the 12 seeded ``/v1/generate`` requests of serve_lm through the
    continuous batcher, every stream (greedy and seeded-sampled) equal to
    the one-process fp32 engine's; 2 greedy requests one at a time for the
    decode ms a step, with the collectives' timer (its share) and without;
    the group stopped by SIGINT to its leader. A second group of the same,
    warmed beside the first, takes the follower-kill drill.
    ``device="cpu"`` and ``backend="gloo"`` with ``cli_extra`` and the
    matching ``cfg`` rehearse it."""
    from distributed_tensorflow_tpu_torch.ckpt import restore_serving_state
    from distributed_tensorflow_tpu_torch.models.causal_lm import CausalLM, CausalLMConfig
    from distributed_tensorflow_tpu_torch.serve import CausalLMEngine

    cfg = dataclasses.replace(cfg or CausalLMConfig(max_position=128), dtype=torch.float32)
    log_dir = ROOT / "build" / "chip_smoke_serve_lm_tp4"
    drill_dir = ROOT / "build" / "chip_smoke_serve_lm_tp4_drill"
    groups = [_spawn_group(["--config", "lm_base_f32", "--ckpt-dir", str(lm_ckpt), "--tp",
                            str(CARDS), "--buckets", *map(str, LM_BUCKETS), "--slots",
                            str(LM_SLOTS), "--max-batch", str(LM_TIER), "--batch-tiers", "1",
                            "2", "4", "--max-new-tokens", str(LM_NEW), "--init-timeout",
                            str(DRILL_TIMEOUT_S), "--comm-timer-file", str(d / "timer_on"),
                            *cli_extra], d, device, CARDS, backend)
              for d in (log_dir, drill_dir)]
    group, gate = groups[0], log_dir / "timer_on"
    requests = _lm_requests(cfg.vocab_size, 12, cfg.max_position)
    try:
        lm_params, _, _ = restore_serving_state(lm_ckpt)
        ref = CausalLMEngine(CausalLM(cfg, device="meta"), lm_params, device,
                             buckets=LM_BUCKETS, slots=LM_SLOTS, max_batch=LM_TIER,
                             batch_tiers=(1, 2, 4), max_new_tokens=LM_NEW)
        want = _generate(ref, requests)
        del ref, lm_params
        if device == "cuda":
            torch.cuda.empty_cache()
        ready_s = _await_group(group, log_dir)
        gate.touch()
        replies, burst_s = _post_generates(group.base, requests)
        greedy = [r for r in requests if r["temperature"] == 0.0][:2]

        def solo_requests():
            return [_post_json(group.base, "/v1/generate", {
                "input_ids": r["input_ids"].tolist(), "max_new_tokens": r["budget"]})
                for r in greedy]

        solo = solo_requests()
        gate.unlink()
        solo_plain = solo_requests()
        with urllib.request.urlopen(group.base + "/statusz", timeout=30) as resp:
            mesh = json.loads(resp.read())["mesh"]
        ranks = _stop_group(group, log_dir)
        for r in range(CARDS):
            line = _group_line(backend, CARDS, r, device)
            check(line in (log_dir / f"rank{r}.log").read_text(),
                  f"cli.serve --tp 4 rank {r}: no '{line}' in its log")
        _await_group(groups[1], drill_dir)
        drill = _follower_kill_drill(groups[1], drill_dir, cfg.vocab_size)
    finally:
        for g, d in zip(groups, (log_dir, drill_dir)):
            _stop_group(g, d, check_exit=False)
    bad = {i: rep for i, rep in replies.items() if rep[0] != 200}
    check(len(replies) == len(requests) and not bad, f"cli.serve --tp 4: {bad or len(replies)}")
    diverged = [r["id"] for r in requests if replies[r["id"]][1]["tokens"] != want[r["id"]]]

    def decode_ms(replies):
        return [body["phases"]["decode"] / (body["n_tokens"] - 1) for body, _ in replies]

    out = {"phase": "serve_lm_cards", "ready_s": ready_s, "layout": mesh["layout"],
           "mesh": mesh, "streams_equal_one_process": len(requests) - len(diverged),
           "diverged": diverged, "burst_s": burst_s, "decode_ms_a_step": decode_ms(solo),
           "decode_ms_a_step_median": statistics.median(decode_ms(solo)),
           "decode_ms_a_step_plain": decode_ms(solo_plain),
           "solo_request_ms": [w * 1e3 for _, w in solo],
           "solo_request_ms_plain": [w * 1e3 for _, w in solo_plain],
           "flash_fwd_launches": [r["launches"]["flash_fwd"] for r in ranks],
           **_collectives_share(ranks[0], burst_s + sum(w for _, w in solo), backend),
           "follower_kill": drill}
    emit(out)
    check(mesh["layout"] == "tp4" and mesh["devices_per_engine"] == CARDS,
          f"cli.serve --tp 4: the leader's mesh {mesh}")
    check(not diverged, f"cli.serve --tp 4 streams off the one-process engine's: {diverged}")
    return out


def main_cards(torch, smi: list) -> int:
    """``chip_smoke.py --cards 4``: the port's distributed paths on four
    cards of one host, one process a card, the model's collectives over
    NCCL (see the module docstring's four-card section)."""
    n = torch.cuda.device_count()
    if n < CARDS:
        raise RuntimeError(f"chip_smoke --cards {CARDS} needs {CARDS} cards; this host has {n}")
    fm = importlib.import_module("distributed_tensorflow_tpu_torch.ops.flash_attention")
    pc = importlib.import_module("distributed_tensorflow_tpu_torch.ops.pointwise_conv")
    fcb = importlib.import_module("distributed_tensorflow_tpu_torch.ops.fused_conv_bn")
    pwb = load_pw_bench()
    r50 = pw_tables(pwb)[0]
    link = phase_link()
    t_start = time.monotonic()
    seconds = {}

    def timed(name, fn, *args, **kwargs):
        t_phase = time.monotonic()
        try:
            return fn(*args, **kwargs)
        finally:
            seconds[name] = time.monotonic() - t_phase

    try:
        timed("build", phase_build, fm, pc, fcb)
        shapes = timed("kernel_cards", phase_kernel_cards, fm, torch)
        # The fused kernels at the DP ranks' shapes: 128 rows, ResNet-50's 12.
        bn_rows = timed("kernel_bn_bwd", phase_kernel_bn_bwd, fcb, pc, pwb, torch,
                        [(m, k, n, torch.bfloat16, (True,), True) for m, k, n in r50],
                        "resnet50_dp4_rank")
        torch.cuda.empty_cache()
        dp = timed("train_dp_cards", phase_train_dp_cards, torch)
        timed("train_cli_image_cards", phase_train_cli_image_cards, torch)
        torch.cuda.empty_cache()
        # BERT-base at full depth: 12 layers, 3 a pipeline stage.
        mp = timed("train_bert_mp_cards", phase_train_bert_mp, torch, cut={"layers": 12},
                   world=CARDS, backend="nccl", rows=MP4_ROWS, plain_steps=2)
        torch.cuda.empty_cache()
        tp_dir, tp_serve = timed("train_cli_tp_sp_cards", phase_train_cli_tp_sp_cards, torch, fm)
        torch.cuda.empty_cache()
        # lm_base trains while the BERT groups load (no request is timed
        # until it has ended); serve_bert_cards' seconds include it.
        group_serve, lm_ckpt = timed(
            "serve_bert_cards", phase_serve_bert_cards, torch, tp_dir,
            during=lambda: timed("train_lm_cards", phase_train_lm_cards, torch))
        torch.cuda.empty_cache()
        timed("serve_lm_cards", phase_serve_lm_cards, torch, lm_ckpt)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    total_s = time.monotonic() - t_start
    print(f"chip_smoke --cards {CARDS}: all phases passed in {total_s:.1f} s", file=sys.stderr)
    emit({"phase": "summary_cards", "phase_seconds": seconds, "total_seconds": total_s,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "nccl": ".".join(map(str, torch.cuda.nccl.version()))})
    print(link["topo_m"])
    src = "distributed_tensorflow_tpu_torch/csrc/"
    ref = "distributed_tensorflow_tpu/ops/flash_attention.py:"
    heads3 = shapes["heads3"]
    kernels = []
    for name, source, line, err_key in (
            ("flash_fwd", "flash_fwd.cu", "396", "fwd_max_abs_err"),
            ("flash_bwd_dq", "flash_bwd.cu", "490", "dq_max_abs_err"),
            ("flash_bwd_dkv", "flash_bwd.cu", "559", "dkv_max_abs_err")):
        kernels.append({
            "name": name, "route": "cuda", "source": src + source, "replaces": ref + line,
            # Launches a step a rank by layout (a request a rank for the
            # serving groups), from the runs of this mode.
            "launches": {"model_parallel_per_step": {
                cfg: [[step[name] for step in rank] for rank in ranks]
                for cfg, ranks in mp["launches"].items()}},
            "max_abs_err": max(rec[part][err_key] for rec in shapes.values()
                               for part in ("padded", "unpadded")),
            **{k: heads3[name][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                            "library_ms")},
            "cell": "B=32, L=512, H=3, D=64, bf16 (TP 4 and Ulysses 4 a rank)",
            "ring_block128": shapes["ring_block128"][name]})
    kernels[0]["launches"]["serve_group_per_request"] = group_serve
    kernels[0]["launches"]["tp_sp_checkpoint_serve"] = tp_serve
    bn_ref = "distributed_tensorflow_tpu/ops/fused_conv_bn.py:"
    sel = [bn_rows[(*sh, "bfloat16")] for sh in r50]
    units = list(r50.values())
    for name, part, line in (("bn_bwd_reduce", "reduce", "126"),
                             ("bn_bwd_apply_dx", "dx", "136"),
                             ("bn_bwd_apply_dw", "dw", "136")):
        kernels.append({
            "name": name, "route": "cuda", "source": src + "fused_conv_bn.cu",
            "replaces": bn_ref + line,
            "launches": {"dp_world4_per_rank": {r: v[name] for r, v in dp["launches"].items()}},
            "max_abs_err": max(r["max_abs_err"][part] for r in bn_rows.values()),
            **_step_record(sel, units, f"{part}_"), "library_ms": None,
            "cell": "ResNet-50, 128 rows a rank, per training step (launches x time, summed)"})
    kernels[-2]["library_ms"] = sum(n * r["dx_library_ms"] for r, n in zip(sel, units))
    kernels[-2]["library"] = "torch.matmul(dz, w.t()): the product alone, dz made ahead"
    print("\n".join(smi) if smi else "nvidia-smi: no output")
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def _step_record(rows: list, counts: list, field: str) -> dict:
    """One kernel's times per ResNet-50 training step: each shape's row
    (``rows``, one per shape) weighted by its launches per step
    (``counts``). ``field`` prefixes the row's keys (``""`` for the dgrad
    rows' ``kernel_ms``)."""
    def total(key):
        return sum(n * r[key] for r, n in zip(rows, counts))

    widest = max(rows, key=lambda r: r[f"{field}bound_ms"])
    return {"ms": total(f"{field}ms" if field else "kernel_ms"),
            "plain_ms": total(f"{field}plain_ms"), "bound_ms": total(f"{field}bound_ms"),
            "bound_by": widest[f"{field}bound_by"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cards", type=int, choices=(1, CARDS), default=1,
                   help=f"1: the one-card run; {CARDS}: the distributed paths on {CARDS} "
                        "cards of this host, one process a card, over NCCL")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available on this host", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    if args.cards == CARDS:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
        return main_cards(torch, smi)
    # The plain versions' f32 products stay full f32 (no TF32), and so do
    # the f32 convolutions of any reference run here.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fm = importlib.import_module("distributed_tensorflow_tpu_torch.ops.flash_attention")
    pc = importlib.import_module("distributed_tensorflow_tpu_torch.ops.pointwise_conv")
    fcb = importlib.import_module("distributed_tensorflow_tpu_torch.ops.fused_conv_bn")
    pwb = load_pw_bench()
    r50, n64, bench_shapes, inception = pw_tables(pwb)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    t_start = time.monotonic()
    seconds = {}  # each phase's wall seconds, in the order run

    def timed(name, fn, *args, **kwargs):
        t_phase = time.monotonic()
        try:
            return fn(*args, **kwargs)
        finally:
            seconds[name] = time.monotonic() - t_phase

    try:
        occupancy, ptxas = timed("build", phase_build, fm, pc, fcb)
        cache, feed_rows = timed("feed_native", phase_feed_native, torch)
        fwd_row, fwd_err = timed("kernel", phase_kernel, fm, torch)
        bwd_row, bwd_err = timed("kernel_bwd", phase_kernel_bwd, fm, pwb, torch)
        pw_rows = timed("kernel_conv1x1", phase_kernel_conv1x1, pc, pwb, torch, r50, n64)
        wgrad_rows = timed("kernel_wgrad", phase_kernel_wgrad, pc, pwb, torch,
                           list(dict.fromkeys([*r50, *n64, *bench_shapes])))
        bf16, f32 = torch.bfloat16, torch.float32
        both = (True, False)
        t_phase = time.monotonic()
        bn_rows = phase_kernel_bn_bwd(
            fcb, pc, pwb, torch, [(m, k, n, bf16, both, True) for m, k, n in r50]
            + [(25091, 1024, 256, bf16, both, True), (6275, 512, 256, f32, both, True)]
            + [(m, k, n, f32, both, False) for m, k, n in r50], "resnet50")
        # The data-parallel phases run the same kernels at 64 rows a rank.
        phase_kernel_bn_bwd(fcb, pc, pwb, torch, [(m * DP_RANK_ROWS // 128, k, n, bf16, both,
                                                   False) for m, k, n in r50], "resnet50_dp_rank")
        inception_bn_rows = phase_kernel_bn_bwd(
            fcb, pc, pwb, torch, [(m, k, n, bf16, both, True) for m, k, n in inception]
            + [(36992, 768, 160, f32, (True,), True)]
            + [(m, k, n, f32, both, False) for m, k, n in inception], "inception_v3")
        phase_kernel_bn_bwd(fcb, pc, pwb, torch, [(m, k, n, dt, both, False)
                                                  for m, k, n in pwb.BN_RISK_SHAPES
                                                  for dt in (bf16, f32)], "risk")
        phase_kernel_bn_dz(fcb, torch)
        seconds["kernel_bn_bwd"] = time.monotonic() - t_phase
        torch.cuda.empty_cache()
        bench_launches, bench_rows = timed("pw_bench", phase_pw_bench, torch)
        timed("serve", phase_serve, fm, torch)
        torch.cuda.empty_cache()
        int8_launches = timed("serve_bert_int8", phase_serve_bert_int8, fm, torch)
        torch.cuda.empty_cache()
        launches = timed("train", phase_train, fm, torch)
        torch.cuda.empty_cache()
        image_launches, image_results = timed("train_resnet50", phase_train_resnet50,
                                              pc, fcb, torch)
        torch.cuda.empty_cache()
        native_launches = timed("train_fused_native", phase_train_fused_native,
                                pc, fcb, torch, cache)
        torch.cuda.empty_cache()
        inception_launches, _ = timed("train_inception", phase_train_inception,
                                      fcb, pc, torch, inception)
        torch.cuda.empty_cache()
        # CLI runs whose checks need no quiet card (no phase of theirs times
        # anything that PERF.md reports): at once. train_cli_tp_sp runs its
        # two four-rank jobs one after the other; the lm_base CLI runs
        # beside the second, once the six short runs have ended (beside all
        # seven the card ran out of memory).
        def first_wave_then_lm():
            concurrently((phase_train_cli, torch), (phase_train_cli_image, torch),
                         (phase_train_cli_inception, torch),
                         (phase_train_cli_bert_corpus, torch), (phase_train_cli_dp, torch),
                         (phase_train_lm_tp, torch))
            t_lm = time.monotonic()
            try:
                return phase_train_cli_lm(torch)
            finally:
                seconds["train_cli_lm"] = time.monotonic() - t_lm

        tp_sp_serve, lm_ckpt = timed("train_cli_group", concurrently,
                                     (phase_train_cli_tp_sp, torch, fm), (first_wave_then_lm,))
        torch.cuda.empty_cache()
        timed("serve_lm", phase_serve_lm, torch, lm_ckpt)
        torch.cuda.empty_cache()
        timed("serve_lm_batcher", phase_serve_lm_batcher, torch, lm_ckpt)
        torch.cuda.empty_cache()
        # The causal LM's TP 2 group starts beside serve_bert_mp's three and
        # idles until its turn: no timed request overlaps another group's.
        lm_group = spawn_lm_tp_group(lm_ckpt)
        try:
            group_serve = timed("serve_bert_mp", phase_serve_bert_mp, torch)
            shutil.rmtree(ROOT / "build" / "chip_smoke_cli_moe_pp", ignore_errors=True)
            torch.cuda.empty_cache()
            timed("serve_lm_tp", phase_serve_lm_tp, torch, lm_ckpt, group=lm_group)
        finally:
            _stop_group(lm_group, LM_TP_LOGS, check_exit=False)
        torch.cuda.empty_cache()
        timed("serve_image", phase_serve_image, torch)
        torch.cuda.empty_cache()
        cli_real = timed("train_cli_imagenet_real", phase_train_cli_imagenet_real, torch, cache)
        dp_world1 = timed("train_dp_world1", phase_train_dp_world1, torch)
        dp_ranks = timed("train_dp_resnet50", phase_train_dp_resnet50, torch)
        torch.cuda.empty_cache()
        mp = timed("train_bert_mp", phase_train_bert_mp, torch)
        # The collectives ran first in the same two processes.
        seconds["collectives_gloo_cuda"] = mp["collectives_s"]
        torch.cuda.empty_cache()
        resilient = timed("train_resilient_fused", phase_train_resilient_fused, torch)
        # The fleet replicas load beside phases that time nothing the
        # records keep (train_chaos's bitwise resume, once its two timed
        # processes have ended; the fault drills), then idle until
        # serve_lm_fleet; serve_lm_router, the last phase, reuses them.
        fleets = []
        try:
            chaos = timed("train_chaos", phase_train_chaos, torch,
                          resilient["ckpt"]["write_ms"] / 1e3,
                          on_launched=lambda: fleets.append(spawn_fleet_replicas(lm_ckpt)))
            (fleet,) = fleets
            # Two fault drills, each of its own processes: at once.
            timed("resilient_cli_group", concurrently, (phase_train_cli_resilient, torch),
                  (phase_serve_lm_faults, torch, lm_ckpt))
            torch.cuda.empty_cache()
            from distributed_tensorflow_tpu_torch.models.causal_lm import CausalLMConfig

            route_reqs = router_requests(CausalLMConfig().vocab_size)
            _, route_want = timed("serve_lm_fleet", phase_serve_lm_fleet, torch, lm_ckpt,
                                  fleet=fleet, extra_refs=[r for key, group in route_reqs.items()
                                                           if key != "hop" for r in group])
            timed("serve_lm_router", phase_serve_lm_router, torch, fleet, route_want, route_reqs)
        finally:
            for fleet in fleets:
                stop_fleet(fleet)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    total_s = time.monotonic() - t_start
    print(f"chip_smoke: all phases passed in {total_s:.1f} s", file=sys.stderr)
    # The feed against the ResNet-50 `fused` step of this run: the cores
    # the host pipeline needs to keep up with it.
    fused_img_s = image_results["fused"]["images_per_s"]
    emit({"phase": "feed_summary", "phase_seconds": seconds, "total_seconds": total_s,
          "resnet50_fused_images_per_s": fused_img_s,
          "cores_needed_for_resnet50_fused": {
              f"{r['mode']}_{r['threads']}_threads": fused_img_s / r["img_per_s_per_core"]
              for r in feed_rows if "threads" in r},
          "cli_imagenet_real": {k: {f: v[f] for f in ("step_ms_median", "host_wait_ms_median")}
                                for k, v in cli_real.items()}})
    print(smi[0] if smi else "nvidia-smi: no output")
    src = "distributed_tensorflow_tpu_torch/csrc/"
    ref = "distributed_tensorflow_tpu/ops/flash_attention.py:"
    kernels = [{
        "name": "flash_fwd", "route": "cuda", "source": src + "flash_fwd.cu",
        "replaces": ref + "396", "launches": launches["flash_fwd"], "max_abs_err": fwd_err,
        "ms": fwd_row["kernel_ms"], "plain_ms": fwd_row["plain_ms"],
        "bound_ms": fwd_row["bound_ms"], "bound_by": fwd_row["bound_by"],
        "library_ms": fwd_row["library_ms"],
        "blocks_per_sm": {tile: occupancy[f"flash_fwd_{tile}"]["blocks_per_sm"]
                          for tile in ("q64", "q128")},
        # Launches on the int8 BERT serving path (bucket 512, 12 a forward).
        "int8_serve_launches": int8_launches,
        # One bucket-512 request served from the TP x SP CLI's checkpoint,
        # and from the MoE x PP x EP CLI's (stacked encoder, one process).
        "tp_sp_checkpoint_serve_launches": tp_sp_serve[0],
        "moe_pp_checkpoint_serve_launches": tp_sp_serve[1],
        # A bucket-512 request served over two gloo ranks, per rank
        # (serve_bert_mp: TP 2, EP 2 and PP 2 at M = 1).
        "serve_group_launches_per_request": group_serve,
    }]
    for name, key, line in (("flash_bwd_dq", "dq", "490"), ("flash_bwd_dkv", "dkv", "559")):
        kernels.append({
            "name": name, "route": "cuda", "source": src + "flash_bwd.cu",
            "replaces": ref + line, "launches": launches[name], "max_abs_err": bwd_err[key],
            "ms": bwd_row[f"{key}_ms"], "plain_ms": bwd_row[key]["plain_ms"],
            "bound_ms": bwd_row[key]["bound_ms"], "bound_by": bwd_row[key]["bound_by"],
            "library_ms": bwd_row[key]["library_ms"], "graph_ms": bwd_row[key]["graph_ms"],
            "blocks_per_sm": occupancy[name]["blocks_per_sm"],
        })
    # Per rank, per step on the model-parallel paths (train_bert_mp).
    for rec in kernels:
        rec["model_parallel_launches"] = {
            cfg: [[step[rec["name"]] for step in rank] for rank in ranks]
            for cfg, ranks in mp["launches"].items()}
    # dQ: SDPA's whole backward beside its dq-only yardstick.
    kernels[1]["library_all_ms"] = bwd_row["dq"]["library_all_ms"]
    # The 1x1 kernels' numbers are per ResNet-50 step (b=128): each
    # shape's time times its launches per step, summed. ``ms`` and
    # ``library_ms`` are times per call, as every other row's;
    # ``graph_ms`` and ``library_graph_ms`` the device times of the same
    # calls replayed from a CUDA graph.
    cell = "ResNet-50 b=128 224x224, per training step (launches x time, summed)"
    pw_ref = "distributed_tensorflow_tpu/ops/pointwise_conv.py:"
    for name, line, table in (("pw_dgrad", "74", r50), ("pw_dgrad_n64", "202", n64)):
        sel = [pw_rows[(*sh, "bfloat16", name)] for sh in table]
        counts = list(table.values())
        kernels.append({
            "name": name, "route": "cuda", "source": src + "pointwise_conv.cu",
            "replaces": pw_ref + line, "launches": image_launches["pallas"][name],
            "max_abs_err": max(r["max_abs_err"] for r in pw_rows.values()
                               if r["route"] == name),
            **_step_record(sel, counts, ""),
            "library_ms": sum(n * r["library_ms"] for r, n in zip(sel, counts)),
            "graph_ms": sum(n * r["kernel_graph_ms"] for r, n in zip(sel, counts)),
            "library_graph_ms": sum(n * r["library_graph_ms"] for r, n in zip(sel, counts)),
            "cell": cell,
            "blocks_per_sm": occupancy["pw_dgrad"]["blocks_per_sm"],
        })
    bn_ref = "distributed_tensorflow_tpu/ops/fused_conv_bn.py:"
    sel = [bn_rows[(*sh, "bfloat16")] for sh in r50]
    units = list(r50.values())
    bn_blocks = {
        "bn_bwd_reduce": occupancy["bn_bwd_reduce"]["blocks_per_sm"],
        "bn_bwd_apply_dx": {key.removeprefix("bn_bwd_apply_dx_"): rec["blocks_per_sm"]
                            for key, rec in occupancy.items()
                            if key.startswith("bn_bwd_apply_dx_")},
        "bn_bwd_apply_dw": occupancy["bn_bwd_apply_dw"]["blocks_per_sm"]}
    bn_ptxas = {"bn_bwd_reduce": ["bn_reduce_kernel_sm90"],
                "bn_bwd_apply_dx": ["bn_apply_dx_strip_sm90", "bn_apply_dx_panel_sm90"],
                "bn_bwd_apply_dw": ["bn_apply_dw_kernel_sm90"]}
    for name, part, line in (("bn_bwd_reduce", "reduce", "126"),
                             ("bn_bwd_apply_dx", "dx", "136"),
                             ("bn_bwd_apply_dw", "dw", "136")):
        kernels.append({
            "name": name, "route": "cuda", "source": src + "fused_conv_bn.cu",
            "replaces": bn_ref + line, "launches": image_launches["fused"][name],
            "max_abs_err": max(r["max_abs_err"][part] for r in bn_rows.values()),
            **_step_record(sel, units, f"{part}_"), "library_ms": None, "cell": cell,
            "native_feed_launches": native_launches[name],
            "resilient_launches": {"train_resilient_fused": resilient["launches"][name],
                                   "train_chaos_survivor": chaos["survivor_launches"][name]},
            "dp_launches": {"world1_nccl": dp_world1["launches"][name],
                            **{f"world2_gloo_rank{r['rank']}": r["launches"][name]
                               for r in dp_ranks}},
            "graph_ms": sum(n * r[f"{part}_graph_ms"] for r, n in zip(sel, units)),
            "blocks_per_sm": bn_blocks[name],
            "ptxas": {entry: rec for key in bn_ptxas[name] for entry, rec in ptxas[key].items()},
        })
    kernels[-2].update({
        "library_ms": sum(n * r["dx_library_ms"] for r, n in zip(sel, units)),
        "library": "torch.matmul(dz, w.t()): the product alone, dz made ahead",
        "library_graph_ms": sum(n * r["dx_library_graph_ms"] for r, n in zip(sel, units)),
        "composite_ms": sum(n * r["dx_composite_ms"] for r, n in zip(sel, units)),
        "composite_graph_ms": sum(n * r["dx_composite_graph_ms"] for r, n in zip(sel, units)),
        "composite": "plain dz in device memory (bf16), then pw_dgrad_cuda"})
    # The wgrad's only path is the bench: its 9 shapes, one call each,
    # summed; plain and error from kernel_wgrad at the same shapes.
    sel = [wgrad_rows[(*sh, "bfloat16")] for sh in bench_shapes]
    kernels.append({
        "name": "pw_wgrad", "route": "cuda", "source": src + "pointwise_conv.cu",
        "replaces": pw_ref + "85", "launches": bench_launches["pw_wgrad"],
        "max_abs_err": max(r["max_abs_err"] for r in wgrad_rows.values()),
        "ms": sum(r["ms"] for r in bench_rows),
        "plain_ms": sum(r["plain_ms"] for r in sel),
        "bound_ms": sum(r["bound_ms"] for r in sel),
        "bound_by": max(sel, key=lambda r: r["bound_ms"])["bound_by"],
        "library_ms": sum(r["library_ms"] for r in bench_rows),
        "library": bench_rows[0]["library"],
        "graph_ms": sum(r["kernel_graph_ms"] for r in sel),
        "library_graph_ms": sum(r["library_graph_ms"] for r in sel),
        "blocks_per_sm": {key.removeprefix("pw_wgrad_"): rec["blocks_per_sm"]
                          for key, rec in occupancy.items() if key.startswith("pw_wgrad_")},
        "cell": "scripts/torch_pw_bench.py --shapes all: 9 ResNet-50 shapes at b=128, "
                "one call each, summed"})
    # Inception-v3's fused units per training step, for PERF.md.
    sel = [inception_bn_rows[(*sh, "bfloat16")] for sh in inception]
    counts = list(inception.values())
    per_step = {name: {**_step_record(sel, counts, f"{part}_"),
                       "graph_ms": sum(n * r[f"{part}_graph_ms"] for r, n in zip(sel, counts))}
                for name, part in (("bn_bwd_reduce", "reduce"), ("bn_bwd_apply_dx", "dx"),
                                   ("bn_bwd_apply_dw", "dw"))}
    for key in ("library", "composite"):
        for suffix in ("ms", "graph_ms"):
            per_step["bn_bwd_apply_dx"][f"{key}_{suffix}"] = sum(
                n * r[f"dx_{key}_{suffix}"] for r, n in zip(sel, counts))
    emit({"phase": "inception_fused_per_step", "launches": inception_launches["fused"],
          "max_abs_err": {part: max(r["max_abs_err"][part] for r in inception_bn_rows.values())
                          for part in ("reduce", "dx", "dw")},
          **per_step})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
