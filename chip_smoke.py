#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``mxnet_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--seed 0]

Needs one CUDA device (an H100: the kernels build for sm_90a) and
``nvcc``; imports nothing of JAX or of the JAX package.  It

1. builds every CUDA kernel of the serving and training paths from
   ``mxnet_tpu_torch/csrc`` (one ``nvcc`` per source, in parallel) and
   prints the card's name and power limit, the build time and the TF32
   flags;
2. holds each kernel against its plain PyTorch version on the card at
   every shape the serving and training paths give it (and one odd shape),
   in float32 and bfloat16, for every activation — the ``bn_act`` forward
   and its backward (dx, dscale, dshift) — and times kernel, plain
   version, a PyTorch yardstick and the memory-traffic bound;
3. serves ResNet-50 (3x224x224, 1000 classes, float32) through
   ``Predictor`` on ``gpu(0)`` from a checkpoint of seeded random weights:
   8 requests at batch 32, then a reshape to batch 1 and back; checks
   every kernel ran on that path (17 ``bn_act`` launches per forward),
   that the outputs are finite probabilities, and that one batch-2
   request agrees with the port's CPU path, fused and with
   ``MXTPU_FUSED_KERNELS=0``;
4. times fused against ``MXTPU_FUSED_KERNELS=0`` serving in turns and
   traces where a fused forward's device time goes (``torch.profiler``);
5. trains ResNet-50 at batch 32 through ``SPMDTrainer`` on ``gpu(0)``
   (bench.py's sgd settings, seeded Xavier init, seeded batches on the
   device): exactly 50 ``bn_act`` forward and 50 backward launches per
   step, finite losses, a cross-entropy that falls on a fixed batch, no
   skipped step, moved params and moving statistics; steady ms/step,
   img/s and peak memory;
6. holds one batch-4 ``simple_bind`` -> ``forward(is_train=True)`` ->
   ``backward()`` on the card (fused, and with ``MXTPU_FUSED_KERNELS=0``,
   which must launch no ``bn_act`` kernel) against the port's CPU path:
   outputs and moving statistics against its float32 run, every
   gradient against its float64 run, as close as its own float32
   gradients come (see ``GRAD_L2_FACTOR``);
7. traces a few training steps (``torch.profiler``): idle share, kernel
   launches per step and device time by class, ``bn_act`` forward and
   backward and the optimizer update each a class of its own;
8. holds the ``lstm_cell`` forward and backward kernels against their
   plain versions at (B, H) = (32, 200), (4, 200), (7, 13) and
   (128, 1024), float32 and bfloat16, and times kernel, plain version,
   PyTorch's own fused LSTM cell (a yardstick the port never calls) and
   the memory-traffic bound; then the recurrence of the fused ``RNN``
   op (``lstm_seq``) at (T, N, H) = (32, 32, 200), (32, 4, 200),
   (5, 7, 13), the largest H the persistent route takes in float32 at
   batch 32, (8, 128, 1024), which takes ``per_step``, and the bucketed
   LM's shortest and longest buckets (10 and 60, 32, 200): the route
   each shape takes, its forward and backward against the plain
   versions, the plan's clusters against the ones the card holds at
   once; and times the persistent kernels, the ``per_step`` route, the
   plain versions, the bound and cuDNN's one-layer ``torch.nn.LSTM`` (a
   yardstick the port never calls; it includes the input projection,
   so the port's projection ``addmm`` plus the kernel is timed beside
   it);
9. trains the 2-layer LSTM language model (``models/lstm_lm``: vocab
   10000, embed and hidden 200, 32 steps, batch 32) through
   ``SPMDTrainer`` with bench.py's ``_lstm_bench`` settings on ``gpu(0)``,
   float32: exactly 2 persistent forward and 2 backward launches per
   step (one a layer) and no ``lstm_cell`` launch, finite losses, a
   cross-entropy that falls on a fixed batch, no skipped step, moved
   params; steady ms/step, tokens/s and peak memory; then a few steps of
   the bench's own ``compute_dtype="bfloat16"``; then, in float32 and in
   bfloat16, the step time of both routes in turns (persistent,
   per_step, per_step, persistent);
10. runs the example's unrolled graph (``rnn.SequentialRNNCell`` of two
    ``rnn.LSTMCell``s, which emit ``_FusedLSTMCell``) through
    ``simple_bind`` -> ``forward(is_train=True)`` -> ``backward()`` at
    batch 32 (64 + 64 ``lstm_cell`` launches, no persistent one) and
    holds it against the ``FusedRNNCell`` graph (the fused ``RNN`` op)
    given the same weights by ``pack_weights``;
11. holds one batch-4 LM forward/backward on the card (fused: 2 + 2
    persistent launches; and with ``MXTPU_FUSED_KERNELS=0``, which must
    launch no LSTM kernel) against the port's CPU path, and both against
    a float64 CPU run;
12. serves the LM through ``Predictor`` from a checkpoint at batch 32 (2
    persistent forward launches per forward, no gate residuals written,
    no backward), and traces a few LM training steps on each route
    (``torch.profiler``);
13. holds the flash-attention forward against its plain version, on
    the route ``flash_route`` picks (``mma_bf16`` for bfloat16 and
    ``tiled_f32`` for float32, every D <= 128) and on the first
    (``rowwise``) kernel, at eight shapes and from a misaligned view;
    times both kernels, the plain version, SDPA and the bound (products,
    exponentials or bytes, whichever binds); and trains and serves the
    long-context LM at seq 512 and 4096, every launch on ``tiled_f32``
    with no alignment copy (see ``long_context_paths``);
14. holds the rtc escape hatch's elementwise kernel
    (``csrc/rtc_elementwise.cu`` with three bodies pasted in: silu, its
    derivative and the JAX test's ``2x + 1``, all built in parallel with
    the other kernels) against each body's plain version at
    (32, 256, 56, 56), (32, 2048), (3, 5, 7, 3), a transposed view, a
    flat input one element off a 16-byte boundary and 0 elements,
    float32/bfloat16/float16, times kernel, plain version, bound and, for
    silu, ``F.silu`` in each dtype (a yardstick the port never calls),
    and shows that a second kernel of the same body does not rebuild;
15. fine-tunes ResNet-50 at batch 32 through ``Module.fit`` with
    ``fit.py``'s wiring on ``gpu(0)``: a checkpoint of seeded weights is
    saved, loaded and cut at ``flatten0``, an rtc op (silu, with its
    derivative kernel as the vjp) and a new 1000-way head are added, and
    one epoch runs on the fused route (``kvstore='tpu'``) and on the
    executor route (``'local'``): exactly 50 + 50 ``bn_act`` and 2 rtc
    launches per batch, finite losses, a moved head, an epoch checkpoint
    that loads again, the two routes in agreement; then ``score`` and
    ``predict`` (1 rtc launch per forward), ``SPMDTrainer.step`` on the
    same symbol for the Module's own overhead, a batch-4 step held
    against the port's CPU path (float32, and float64 for the
    gradients), and a profile of a few ``fit`` batches;
16. fits the same fine-tune on the executor route with NAG (an
    optimizer written in NDArray arithmetic, momentum 0.9) beside sgd
    with momentum 0.9, in turns: ms per batch, ``Module.update``'s host
    ms and kernel launches per batch of each;
17. runs every op of ``ops/tensor.py`` on the card against the port's
    CPU path (``tensor_op_cases`` at (64, 257): ``mx.nd.<op>`` in float32,
    float16, bfloat16 and int32 where the reference takes them, then the
    differentiable ones through ``simple_bind(mx.gpu(0))`` -> forward ->
    backward), traced to show no device-to-host copy, and the samplers by
    seed determinism and moments over 10^6 draws;
18. attacks ResNet-50 with FGSM as ``example/adversary`` does, at batch
    32, in NDArray ops on the card (``Module`` bound with
    ``inputs_need_grad``: forward, backward, ``get_input_grads``,
    ``clip(x + eps * sign(g), 0, 1)``, forward, accuracy): 50 + 50
    ``bn_act`` forward (two training forwards) and 50 backward launches
    per batch, a cross-entropy that rises, the input gradient of one
    batch's first 4 rows, from the same ``Module`` reshaped to batch 4,
    against a float64 CPU run (relative L2 and signs), ms per batch and
    its split, idle share,
    peak memory;
19. steps each optimizer written in NDArray arithmetic on the card
    against the CPU (bit for bit; SGLD by its noise's moments), and times
    the NDArray layer's dispatch beside the same torch calls;
20. trains the bucketed LSTM language model of
    ``example/rnn/lstm_bucketing.py`` at its defaults (vocab 10000,
    embed and hidden 200, 2 layers, batch 32, buckets 10 to 60, sgd lr
    0.01) on the example's synthetic Markov corpus through
    ``BucketingModule.fit`` for 2 epochs with validation data, first on
    the unrolled ``LSTMCell`` stack (exactly 2T + 2T ``lstm_cell``
    launches a batch of bucket T, 2T in validation) and then on
    ``FusedRNNCell`` (exactly 2 + 2 persistent ``lstm_seq`` launches, 2
    in validation): every bucket visited, finite losses, validation
    perplexity lower after epoch 2 than after epoch 1, every parameter
    moved; steady ms per batch by bucket, tokens/s, the binds, peak
    memory; then on each stack the weights shared across buckets (after
    updates in bucket 60, bucket 10 computes what a fresh ``Module``
    given ``get_params()`` computes), one ``update_metric`` of
    ``Perplexity`` copying only the picked probabilities to the host, a
    profile of a few ``fit`` batches, and one batch of buckets 10 and 60
    held against the port's CPU path (float32 outputs, gradients against
    float64);
21. runs the image-classification zoo (``zoo_paths``): logs each zoo
    model's fused plan (merged ``concat_fuse`` groups, ``pool_act``
    rewrites, BN sites, chains, what liveness drops, convolutions and
    ``fused_bn_act`` calls per forward) and requires every pass to engage
    on Inception-BN; holds both ``bn_act`` kernels against their plain
    versions at every shape an Inception-BN training step gives them
    (merged widths included) with times; times ``pooling_opt``'s slice
    form against the Pooling op at Inception-BN's pooling sites (the
    CUDA gate); serves Inception-BN (3x224x224, 1000 classes, batch 32)
    through ``Predictor`` with every pass on (bn_act launches, merged
    bodies and convolutions per forward held to the plan; fused against
    unfused logits; the card against the CPU at batch 4; a profile) and
    trains it through ``SPMDTrainer`` with bench.py's ResNet settings
    (48 + 48 ``bn_act`` launches and 13 merged bodies a step, 48
    convolutions a training forward, a falling loss, fused against
    unfused ms/step in turns, a profile), holds a batch-4 training step
    against the CPU (float32, and float64 for the gradients); serves
    every other zoo model at batch 32 at its published size (LeNet and
    the MLP at 1x28x28, AlexNet, VGG-16, GoogLeNet, MobileNet and
    ResNeXt-50 at 224, Inception-v3 at 299) fused and unfused, img/s,
    logits against each other and against the CPU at batch 1; serves
    ResNet-50 fused, fused interpreting every plan entry (the executor
    before liveness: 86 convolutions a forward) and unfused (53 each) in
    turns; and runs the 15 ops of ``ops/nn.py`` the port added last
    forward and backward against the CPU;
22. runs the extension surface at ResNet-50 and Inception-BN width
    (``extension_paths``, batch 32, float32): ResNet-50 through
    ``Module.fit`` with ``example/numpy-ops``' ``NumpySoftmax`` as its
    head (one host forward and backward of the op a batch, the bytes they
    move held exactly, 50 + 50 ``bn_act`` launches a batch, gradients
    against ``SoftmaxOutput``'s within 1e-5 relative L2, ms per batch of
    both heads); with ``fc1`` replaced by ``TorchModule(torch.nn.Linear(
    2048, 1000))`` (no device-to-host copy in a step, gradients against
    the FullyConnected head's, a ``TorchCriterion(CrossEntropyLoss)``
    whose loss falls on a fixed batch, ``mx.th`` on a card NDArray); under
    ``Monitor(2, norm_stat)`` as ``monitor_weights.py`` builds it (the
    plain plan's taps on every sampled batch, all finite, tapped logits
    against fused, ms per batch monitored and not in turns); FGSM through
    ``contrib.autograd.grad_and_loss`` over a node-by-node ``mx.nd`` walk
    of the symbol (the input gradient against the executor's under
    ``MXTPU_FUSED_KERNELS=0``, ms per batch beside the executor route in
    turns); Inception-BN trained through ``SPMDTrainer`` with
    ``inception_memcost.py``'s settings in float32 and bfloat16, mirror
    off and on in turns (step peak memory lower with the mirror, the
    ``bn_act`` launches a mirrored step the segments imply, ms per step),
    a batch-4 step mirror on against off within 1e-6 relative L2, and an
    executor's ``close`` (card memory back to its level before the bind,
    the caller's arrays readable);
23. runs the input pipeline (``input_paths``): probes the host (libjpeg,
    cv2, PIL, ``nvjpeg.h``, g++, cores) and builds the native library
    (and, without libjpeg, the nvJPEG decoder); writes a seeded JPEG
    ``.rec``/``.idx`` at ImageNet's layout (640 images, short side 256)
    and a detection ``.rec``; times each ``ImageRecordIter`` route's
    decode into ``gpu(0)`` (native at 1, 4 and all cores in float32,
    uint8 and bfloat16 with the fast DCT on and off, the process route
    at the example's arguments, the engine route with an ``aug_list``)
    and the batch's upload (pageable ``.to()``, pinned on the side
    stream, ``stage_batch``); trains Inception-BN through
    ``Module.fit(kvstore='tpu')`` fed by the example's train iterator
    (process route), the same without ``pad`` (native route), that
    through ``DevicePrefetchIter(stage=module)`` and the same batches in
    an ``NDArrayIter``, one after another (48 + 48 ``bn_act`` launches a
    step, ms a batch, idle share); scores ResNet-50 through
    ``Module.score`` from the val iterator (img/s, host-to-device copy
    share); and holds each
    route's batches on the card against the CPU path's (the nvJPEG
    backend against the committed fixture of libjpeg's decode), a staged
    batch against its bytes, an Inception-BN batch-4 step fed a
    ``StagedBatch`` against host arrays (bit for bit), the image I/O ops
    and ``ImageDetRecordIter`` against the CPU;
24. runs the data service (``data_service_paths``): reads the same seeded
    ``.rec`` through ``ImageRecordIter(data_service=True)`` into
    ``gpu(0)`` at 1, 2 and 4 decode workers (img/s, each worker's decoder
    held to what the host's native library predicts, the 1-worker stream
    against the 4-worker one byte for byte); checks ``DeviceAugment``
    (3x240x240 uint8 canvas, margin 16, crop, mirror, ImageNet mean/std,
    float32) on the card against the CPU on the same canvas and chunk
    seed (exact; the resize branch within 1e-5 x max; pad rows zero),
    times the canvas upload beside the float32 batch's and the augment's
    device time and kernels a batch, and holds uploaded batches unchanged
    after three more pulls; starts two network-tier servers
    (``data_service/server_main.py``, 2 workers each) on loopback and
    holds their device-augmented stream against the local service's byte
    for byte; trains Inception-BN through ``Module.fit(kvstore='tpu')``
    fed one after another by held batches, the local service
    host-augmented, with ``device_augment``, that through
    ``DevicePrefetchIter(stage=module)`` and the network tier with
    ``device_augment`` (48 + 48 ``bn_act`` launches a step, ms a batch,
    idle share);
25. runs the rest of the op library through the examples that use it
    (``detection_paths``), each example file loaded with its
    ``mxnet_tpu`` imports bound to the port (``load_example``): SSD-512
    with a ResNet-50 body (the reference's ``symbol_factory`` entry:
    ``example/ssd``'s ``get_symbol_train``/``get_symbol_detect`` around
    the zoo's ResNet-50 cut at stages 3 and 4 and four extra layers, 6132
    anchors, VOC's 20 classes) trained through ``Module.fit`` at batch 32
    (the plan's ``bn_act`` launches a step, ms a batch, peak memory, a
    profiled window's idle share), MultiBoxTarget's host and device ms,
    the detection graph on the trained weights (NMS must suppress boxes
    in every picture; the NMS sweep's host and device ms), MultiBoxTarget,
    MultiBoxDetection and Proposal card against CPU on the same inputs, a
    batch-2 training step against the CPU (float32, and float64 for the
    gradients), ``example/rcnn``'s Faster R-CNN fit (Custom ops' host
    round trips a batch), ``example/warpctc``'s toy CTC OCR at its
    defaults (1 + 1 ``lstm_seq`` launches a batch, the WarpCTC backward's
    ms), every new op card against CPU, and ROIPooling and Correlation at
    their published shapes (peak memory under 2 GiB above resident);
26. runs the resilience slice (``resilience_paths``): ResNet-50 through
    ``Module.fit`` (2 epochs of 6 batches, sgd with momentum, a
    ``CheckpointManager``, deterministic cuDNN/cuBLAS) in child processes
    written to a temp directory, uninterrupted and as a chain under
    ``tools/supervise.py``: a small Dropout net SIGTERMed in-band (exit
    85; its CUDA generator comes back through the manifest's JSON random
    state), ResNet-50 hung by ``MXTPU_FAULTS=hang_step`` against a short
    ``MXTPU_STEP_TIMEOUT`` (exit 87 with a stack and ``torch.cuda``
    dump, resumed from the epoch-end checkpoint), SIGTERMed after batch 3
    of epoch 1 (exit 85 within one step plus the save, resumed with a
    fast-forward), its final params and momentum equal to the
    uninterrupted run's bit for bit, 50 + 50 ``bn_act`` launches a batch
    in every process; then in this process one ``poison_grad`` step
    (``SkippedSteps`` 1, nothing moved), deferred ``Accuracy`` against
    ``MXTPU_METRIC_BLOCKING=1`` (ms a batch in turns, device-to-host
    bytes a step), the epoch-end save blocking against async (stall,
    bytes, the writer's time), and ``tools/ckpt_fsck.py`` with the port's
    ``verify_promotion`` on the run's directory before and after a byte
    of its newest params rots;
27. serves (``serving_paths``): ResNet-50 from a ``CheckpointManager``
    directory through ``serving.ModelPool.load_dir`` on ``gpu(0)``,
    warmed over buckets 1-32 and timed at each (17 ``bn_act`` launches a
    forward), 5 rows in a bucket of 8 against each row served alone and
    a full bucket of 32 against ``Predictor`` (bit for bit), bucket 4
    against the port's CPU path, bfloat16 and int8 pools against float32
    with their resident and peak memory; then the port's daemon
    (``serving/serve_main.py --watch``) with ResNet-50, bench.py's serving
    MLP and the LM (bench.py loaded with its imports bound to the port):
    a quiet request against the unbatched ``Predictor`` bit for bit,
    closed loops at concurrency 1 and 32 (QPS, p50, p99, shed, 0
    errors), ``/predict_seq`` at three length buckets against
    ``Predictor`` at each shape, a new epoch published under 8 clients
    (all 200, then bit-equal to a fresh ``Predictor``), a ``swap_probe``
    rollback (bit-exact), a SIGTERM drain with 8 requests in flight (exit
    0) and the daemon's own launch counters against its batches (17 a
    ResNet-50 forward, 2 a LM batch); then the daemon under
    ``tools/supervise.py`` with a hung forward (87 with a report, the
    relaunch answers 200, SIGTERM gives 0);
28. runs the fleet (``fleet_paths``): ``fleet/fleet_main.py serve
    --device-sets cuda:0 --replicas 2 --watch`` (two daemons co-tenant on
    the card behind the router, ``dup_request`` armed) with ResNet-50 and
    bench.py's MLP: time to ready, card memory, a quiet request through
    the router and on each replica bit-equal to the smoke's
    ``Predictor`` (bursts straight to each replica until buckets 8 and 32
    answered, each equal to ``Predictor`` at that bucket), the duplicate
    collapsed by the replica's dedup cache, concurrency 1 and 32 through
    the router and straight to one replica (QPS, p50, p99, 0 errors, the
    CPU seconds of the front end, the load and the replicas, batches by
    replica), a SIGKILL of the ResNet-50 home under 8 clients (all 200,
    eviction, the respawn's rejoin, the respawn bit-equal), a rolling
    swap under 4 clients (one replica at a time, all 200, both equal to a
    fresh ``Predictor`` on the new epoch), the drain (exit 0, every
    replica 0, 17 ``bn_act`` launches a ResNet-50 forward in each drained
    run), and a ``--workers 2`` fleet at concurrency 32 when the router
    used 0.8 CPU s a second or more;
29. runs the tools slice (``tools_paths``): ResNet-50 at batch 32 through
    ``Module`` for 3 batches under ``profiler_set_state("run")`` in mode
    ``all_xla`` (the profiler's overhead against 3 unprofiled batches;
    the trace's ``bn_act`` kernels equal the launch counters, 50 + 50 a
    batch, and ``get_op_stats`` puts each under its BatchNorm node or
    that node's ``_backward_`` entry; ``dumps()``'s table), then the
    same window twice more, logged: once without the profiler's warm-up
    launches and once with them (launches without a kernel record, the
    trace's ``bn_act`` kernels beside the counters); the graph
    lint on ``gpu(0)`` (``SPMDTrainer.analyze`` of the standard MLP and
    of ResNet-50: clean, 0 host syncs, 0 collectives, the analyze time),
    one ResNet-50 step under ``MXTPU_ANALYZE=strict``, the step's peak
    memory above resident, and its MFU against ``model_flops``; a strict ``ModelPool`` serving
    ResNet-50 at bucket 32 after ``analyze``, equal to ``Predictor``;
    and ``test_utils.check_consistency`` of a conv+BN+ReLU symbol on
    ``[cpu(), gpu(0)]``, forward and backward, launching ``bn_act``;
30. runs the data-parallel slice (``dist_paths``): ``tools/launch.py -n 2
    python chip_smoke.py --dist-worker <phase>`` with no ``--platform``,
    so both ranks share ``cuda:0`` and talk over gloo (each rank's
    ``current_context()`` its card, the transport of each collective kind
    printed); ResNet-50 at 32 images a rank (global 64), float32, through
    ``SPMDTrainer`` under ``grad_sync`` allreduce, zero and zero3 (50 + 50
    ``bn_act`` launches a step a rank in every tier; ms a step, params and
    optimizer state a rank against allreduce's, peak memory, the
    collectives' share of a step); the two-rank allreduce update after 1
    and 2 steps against one process at batch 64 (within
    ``GRAD_L2_FACTOR`` x the one process's fused-vs-unfused distance); a
    batch-4 zero3 step of the ranks on the card against the same ranks on
    the host; ``Module.fit`` of ResNet-50 with ``kvstore='dist_sync'``
    (executor route) and ``'tpu'`` (fused), weights identical on the
    ranks; bench.py's MLP under zero3 bit-identical to allreduce after 6
    steps, a sharded-native save at step 3 and a SIGKILL of every rank in
    step 4 (the launcher reports the failure), a resume whose digest
    equals the undisturbed run's; and the preemption drill: SIGTERM to
    rank 1 alone under ``fit(preemption_safe=True)``, both ranks saving at
    the same boundary and leaving with 85, the resumed fit bit-identical
    to an uninterrupted one;
31. runs the model-parallel axes inside one process
    (``model_parallel_paths``), every mesh position a ``gpu(0)``
    context: ResNet-50 at dp 2 x tp 2 through ``SPMDTrainer`` with
    ``fc1_weight`` and the stage-4 conv weights sharded over ``tp`` (the
    column form each took, 200 + 200 ``bn_act`` launches a step, ms a
    step, the ruled params' storage a position, the first step's update
    against one device's and against float64, the gathered params
    through ``Predictor``); the long-context LM at the example's defaults
    on dp 2 x sp 4 against one device's ``make_step``; ``pipeline_apply``
    over pp 4 and its input gradient against the sequential
    composition; ``moe_ffn`` over ep 8 against the dense mix, and its
    dropped tokens at capacity factor 1.0;
32. runs the region drill and ``group2ctx`` across devices
    (``region_paths``): ``region/region_main.py storm --context gpu(0)``
    (two data servers; the elastic zero3 trainer at world 2 on ``gpu(0)``
    positions, resized to 4; two replicas co-tenant on ``cuda:0`` behind
    two router workers; closed-loop clients; the JAX package's STORM
    schedule and epochs), gated on the report's eight checks, the
    storm's counted events and both replicas serving epoch 16, with each
    role's bring-up, the trainer's ms a batch at world 2 and 4, the
    resize-to-resumed time, ``freshness_ms`` and the clients' counts; then
    the example's model-parallel LSTM (``lstm_ctx_group.build`` at its
    defaults) with ``embed`` and ``layer1`` on ``cpu()`` and ``layer0``
    and ``out`` on ``gpu(0)``: 16 + 16 ``lstm_cell`` launches a step, the
    loss and every gradient against the same graph on ``gpu(0)`` alone
    and against float64, within 3x the CPU float32 run's own error (a
    gradient leaf scaled by 1.01 must fail that gate), a falling nll, ms
    a step placed and on one device, and the bytes that cross each
    boundary a step;
33. logs every path's wall time (``<path>: %.1f s``, also written to
    ``chiprun_out/smoke_times.json``), then prints a ``{"kernels":
    [...]}`` line and, last, ``{"ok": true, "device": {...}}``.

Any failed phase exits non-zero without the last line.  Without CUDA, or
run from a directory without the package, it fails at once.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import gc
import json
import logging
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM HBM3 rate (NVIDIA data sheet, 700 W) — the bound's denominator
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM peak rates (NVIDIA data sheet, 700 W, dense): float32 outside
#: the tensor cores, and bf16 on them
F32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
#: the five bn_act site shapes of ResNet-50 serving at batch 32, 224x224
SERVING_SHAPES_B32 = {(32, 64, 56, 56), (32, 256, 56, 56), (32, 512, 28, 28),
                      (32, 1024, 14, 14), (32, 2048, 7, 7)}
#: the twelve fused BatchNorm site shapes of one ResNet-50 training step
TRAINING_SHAPES_B32 = SERVING_SHAPES_B32 | {
    (32, 64, 112, 112), (32, 128, 56, 56), (32, 128, 28, 28),
    (32, 256, 28, 28), (32, 256, 14, 14), (32, 512, 14, 14),
    (32, 512, 7, 7)}
ODD_SHAPE = (3, 5, 7, 3)
IMAGE = (3, 224, 224)
BATCH = 32          # requests per forward, images per training step
FORWARDS = 8        # batch-32 requests served on the main path
PROFILE_FORWARDS = 5
TRAIN_STEPS = 4     # training steps on distinct seeded batches
FIXED_STEPS = 10    # then steps on one fixed batch, whose loss must fall
PROFILE_STEPS = 3
AGREE_BATCH = 4     # the GPU-vs-CPU training agreement's batch
ACTS = ("relu", "sigmoid", "tanh", None)
# the LSTM language model of bench.py's _lstm_bench (bench.py:1532-1566)
LM_VOCAB, LM_EMBED, LM_HIDDEN, LM_LAYERS = 10000, 200, 200, 2
LM_SEQ, LM_BATCH = 32, 32
LM_PER_PASS = LM_LAYERS * LM_SEQ  # lstm_cell launches per forward/backward
LM_TRAIN_STEPS = 4  # distinct seeded batches, then LM_FIXED_STEPS on one
LM_FIXED_STEPS = 10
LM_BF16_STEPS = 6
LM_FORWARDS = 6     # Predictor forwards served at batch 32
LM_AGREE_BATCH = 4
#: (B, H) of the lstm_cell checks: the bench's, the agreement batch's, an
#: odd one, and one large enough for bytes to count
LSTM_SHAPES = ((32, 200), (4, 200), (7, 13), (128, 1024))
LSTM_F32_TOL = (2e-6, 1e-5)  # max abs error: (h, c), (dgates, dc_prev)
#: (T, N, H) of the lstm_seq checks: the LM's layer, the agreement batch's,
#: an odd one, the largest H the persistent route takes in float32 at
#: batch 32 (None: found from lstm_seq_route), H = 1024, which must take
#: per_step, and the bucketed LM's shortest and longest buckets
LSTM_SEQ_SHAPES = ((LM_SEQ, LM_BATCH, LM_HIDDEN),
                   (LM_SEQ, LM_AGREE_BATCH, LM_HIDDEN), (5, 7, 13), None,
                   (8, 128, 1024), (10, 32, 200), (60, 32, 200))
#: the bucket lengths whose lstm_seq layer is timed beside the LM's
LSTM_SEQ_BUCKET_T = (10, 60)
# float32 lstm_seq kernel vs plain, max |diff| / max |plain| of each
# output: both float32, but the kernel sums each recurrent product (200 to
# 452 terms) in another order than cuBLAS (split over lanes, added by
# shuffles), a few ulp a step, which the 32 steps carry forward and back;
# the same bound as the cell backward's
LSTM_SEQ_F32_TOL = 1e-5
LM_TURN_STEPS = 6   # LM training steps a turn of the route comparison
# the long-context causal LM of example/long-context/train_lm.py at its
# published widths, its command-line defaults (train_lm.py:118-127)
LC_VOCAB, LC_DMODEL, LC_HEADS, LC_LAYERS, LC_DFF = 128, 64, 4, 2, 256
LC_BATCH, LC_LR, LC_SEQ, LC_MAX_LEN = 4, 0.3, 512, 4096
LC_STEPS = 40       # seq-512 training steps, as the example runs
LC_LONG_STEPS = 5   # seq-4096 training steps
LC_FORWARDS = 4     # seq-4096 serving forwards
LC_AGREE = (2, 1024)  # (batch, seq) of the GPU-vs-CPU check
# steps in the seq-4096 training profile: a window of 3 (7707 kernels a
# step) lost 69 kernel events in one chip run, 2 of them flash launches
LC_PROFILE_STEPS = 1
ATT_SHAPE, ATT_HEADS = (4, 512, 64), 4   # the symbolic Attention op's
#: (B, Tq, Tk, H, D, causal) of the flash kernel checks: the LM at seq 512
#: and 4096, bench.py's kernel shape causal and not, an odd shape, a
#: Tq > Tk shape (its first rows see no key), head dim 128, and a head dim
#: above 16 that is not a multiple of 16
FLASH_SHAPES = ((4, 512, 512, 4, 16, True), (4, 4096, 4096, 4, 16, True),
                (4, 512, 512, 8, 64, True), (4, 512, 512, 8, 64, False),
                (3, 37, 53, 2, 8, True), (2, 300, 200, 4, 16, True),
                (2, 512, 512, 4, 128, True), (2, 256, 256, 2, 40, True))
FLASH_MODEL_SHAPE = (4, 4096, 4096, 4, 16, True)
#: q, k, v as views one element off a 16-byte boundary: the wrapper copies
#: each (3 alignment copies) before the tiled route
FLASH_MISALIGNED_SHAPE = (2, 300, 200, 4, 16, True)
#: exp2 per clock per SM on the special-function unit (CUDA C Programming
#: Guide, arithmetic instruction throughput, compute capability 9.0)
EXP2_PER_CLOCK_PER_SM = 16
# float32 kernel vs plain: both sum in float32 in other orders (the
# streaming softmax reassociates its sums), outputs are O(1)
FLASH_F32_TOL = 2e-5
# The LM's gradients, like ResNet-50's, move when a ReLU input lies within
# rounding of 0: at batch 2 x 1024 one of the 1M ff pre-activations of the
# seeded run is 1.9e-7 from 0 in layer 0, and its flip alone moves the
# layer-0 and embedding gradients by 1.1e-3 in relative L2 (up to 1.2% of
# one tensor's max).  So the card's gradients are held to the CPU path's in
# relative L2, all together and per tensor, and the logits elementwise:
LC_GRAD_L2_TOL = 1e-2
F32_TOL = 1e-5      # max abs error, float32 kernel vs plain (y, dx)
BF16_REL_TOL = 1e-2  # max abs error / max |plain|, bfloat16
SUM_F32_REL_TOL = 1e-4  # dscale/dshift: max abs error / max |plain|, f32
AGREE_REL_TOL = 1e-3  # GPU vs CPU training: max abs diff / max |cpu|
# The gradients of a float32 ResNet-50 step at batch 4 are ill-conditioned:
# a ReLU whose input lies within rounding of 0 takes the other branch under
# another summation order, which moves a late-stage weight gradient by
# several percent.  So the card's gradients are held, with the CPU float32
# path's, against a float64 CPU run of the same step:
GRAD_L2_FACTOR = 3.0  # all gradients: relative L2 error <= 3x the CPU's
GRAD_TENSOR_L2_TOL = 0.1  # and each gradient tensor's under this


class SmokeFailure(Exception):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


_T0 = time.perf_counter()


def log(*parts):
    print(*parts, flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "smoke_trace.log"), "a") as f:
        f.write("%8.1f %s\n" % (time.perf_counter() - _T0,
                                " ".join(str(p) for p in parts)[:300]))


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def device_ms(torch, fn, iters=20, reps=5):
    """Device time of one ``fn()`` call: ``iters`` calls captured in a CUDA
    graph, replayed ``reps`` times between CUDA events, so host launch
    overhead does not show as device time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

#: the static kernels under mxnet_tpu_torch/csrc/ (rtc_elementwise.cu is the
#: template the rtc bodies are rendered into, built per body)
KERNEL_SOURCES = ["bn_act", "flash_attention", "lstm_cell"]
#: sources whose nvcc main() lets run on beside resnet_paths, which
#: launches none of them (the flash kernel's build is the longest);
#: await_builds joins them before the next path
DEFERRED_SOURCES = ("flash_attention",)
#: (thread, names, errors) of each build phase_setup left running
_DEFERRED = []


def _log_ptxas(mx, names, sources):
    for n in names:
        with open(mx.kernels.library_path(n, sources.get(n)) + ".log") as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    log("  ptxas %s: %s" % (n, line.strip()))


def phase_setup(torch, mx, rtc, defer=()):
    """The card's name and limit, the kernels' build (one nvcc a source,
    all started together; the ``defer`` sources build in a thread that
    :func:`await_builds` joins) and the TF32 flags.  Returns the card."""
    import threading
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, "nvidia-smi failed: %s" % smi.stderr)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log("torch %s, CUDA %s, device %s, %d device(s)" % (
        torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0),
        torch.cuda.device_count()))
    names = [n for n in KERNEL_SOURCES if n not in defer]
    # the rtc bodies rendered into the template build in the same nvcc
    # batch (one process per source, all started together)
    sources = {k.name: k.source for k in rtc.values()}
    if defer:
        errors = []

        def build_deferred():
            try:
                mx.kernels.build(list(defer))
            except Exception as e:  # noqa: BLE001 — await_builds raises it
                errors.append(e)
        thread = threading.Thread(target=build_deferred, daemon=True)
        thread.start()
        _DEFERRED.append((thread, list(defer), errors))
    t0 = time.perf_counter()
    mx.kernels.build(names + sorted(sources), sources=sources)
    log("kernel build: %s and rtc bodies %s in %.2f s wall (%s)%s" % (
        ", ".join(names), ", ".join(sorted(rtc)), time.perf_counter() - t0,
        ", ".join("%s %.2f s" % (n, mx.kernels.BUILD_SECONDS[n])
                  for n in names),
        "; %s building on" % ", ".join(defer) if defer else ""))
    for tag, k in sorted(rtc.items()):
        log("rtc body %s (%s) built in %.2f s: %s" % (
            tag, k.name, mx.kernels.BUILD_SECONDS[k.name], k.body))
    _log_ptxas(mx, names + sorted(sources), sources)
    mx.gpu(0).torch_device    # resolving a gpu context pins f32 numerics
    log("tf32: cudnn.allow_tf32=%s cuda.matmul.allow_tf32=%s" % (
        torch.backends.cudnn.allow_tf32,
        torch.backends.cuda.matmul.allow_tf32))
    check(not torch.backends.cudnn.allow_tf32
          and not torch.backends.cuda.matmul.allow_tf32, "TF32 left on")
    return card


def await_builds(mx):
    """Join the builds :func:`phase_setup` left running (raising what one
    raised) and log them as it logs its own."""
    while _DEFERRED:
        thread, names, errors = _DEFERRED.pop()
        thread.join()
        if errors:
            raise errors[0]
        log("kernel build (beside resnet_paths): %s" % ", ".join(
            "%s %.2f s" % (n, mx.kernels.BUILD_SECONDS[n]) for n in names))
        _log_ptxas(mx, names, {})


def bn_act_sites(mx, symbol, data_shape):
    """The data shapes the fused plan hands ``fused_bn_act``, one per call
    site: ``(serving, training)``.  Serving calls it at the ``bn_act``
    entries (the ``bn_fold`` entries fold into their convolution);
    training calls it at both."""
    plan = mx.executor._build_eval(symbol).plan
    sites = mx.mxfuse.bn_sites(plan)
    internals = symbol.get_internals()
    _, out_shapes, _ = internals.infer_shape(data=data_shape)
    shape_of = {(id(n), i): s for (n, i), s in
                zip(internals._outputs, out_shapes)}

    def shapes(nodes):
        return [tuple(shape_of[(id(n.inputs[0][0]), n.inputs[0][1])])
                for n in nodes]
    return shapes(sites["bn_act"]), shapes(sites["bn_act"] + sites["bn_fold"])


def _bwd_error(torch, got, ref, f32):
    """Worst of (dx, dscale, dshift) against the plain backward, each
    against its tolerance: ``(ratio, dx max abs err)``, ratio <= 1 passes."""
    worst, dx_err = 0.0, 0.0
    for i, (g, r) in enumerate(zip(got, ref)):
        if g.shape != r.shape or g.dtype != r.dtype:
            raise SmokeFailure("bn_act backward: output %d shape/dtype %s %s "
                               "!= %s %s" % (i, tuple(g.shape), g.dtype,
                                             tuple(r.shape), r.dtype))
        err = (g.float() - r.float()).abs().max().item()
        top = max(r.float().abs().max().item(), 1e-30)
        if i == 0:
            dx_err = err
            tol = F32_TOL if f32 else BF16_REL_TOL * top
        else:
            tol = (SUM_F32_REL_TOL if f32 else BF16_REL_TOL) * top
        worst = max(worst, err / tol)
    return worst, dx_err


def phase_kernels(torch, mx, serving_counts, training_counts, seed):
    """The bn_act forward and backward kernels against their plain
    versions at every site shape of both paths and the odd shape, float32
    and bfloat16, every activation; times at relu."""
    ba = mx.kernels.bn_act
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    shapes = sorted(training_counts, key=lambda s: (-s[1], s)) + [ODD_SHAPE]
    per_shape = {}
    max_err = {"fwd": 0.0, "bwd": 0.0}
    for shape in shapes:
        c = shape[1]
        x32 = torch.randn(shape, generator=gen, device=dev) * 2.0
        scale32 = torch.randn(c, generator=gen, device=dev) * 0.5 + 1.0
        shift32 = torch.randn(c, generator=gen, device=dev) * 0.5
        dy32 = torch.randn(shape, generator=gen, device=dev)
        row = {}
        for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            x, scale, shift, dy = (t.to(dtype)
                                   for t in (x32, scale32, shift32, dy32))
            f32 = tag == "f32"
            for act in ACTS:
                y = ba.norm_act(x, scale, shift, act)
                ref = ba.norm_act_plain(x, scale, shift, act)
                got_b = ba.norm_act_bwd(x, scale, shift, dy, act)
                ref_b = ba.norm_act_bwd_plain(x, scale, shift, dy, act)
                torch.cuda.synchronize()
                check(y.shape == ref.shape and y.dtype == ref.dtype,
                      "bn_act %s %s: shape/dtype differ" % (shape, tag))
                err = (y.float() - ref.float()).abs().max().item()
                if f32:
                    check(err <= F32_TOL, "bn_act f32 %s act=%s: max abs err "
                          "%.3g > %g" % (shape, act, err, F32_TOL))
                    max_err["fwd"] = max(max_err["fwd"], err)
                else:
                    rel = err / max(ref.float().abs().max().item(), 1e-30)
                    check(rel <= BF16_REL_TOL, "bn_act bf16 %s act=%s: rel "
                          "err %.3g > %g" % (shape, act, rel, BF16_REL_TOL))
                ratio, dx_err = _bwd_error(torch, got_b, ref_b, f32)
                check(ratio <= 1.0, "bn_act backward %s %s act=%s: error "
                      "%.3g x its tolerance" % (tag, shape, act, ratio))
                if f32:
                    max_err["bwd"] = max(max_err["bwd"], dx_err)
                row["%s_%s_err" % (tag, act or "none")] = err
                row["%s_%s_bwd_ratio" % (tag, act or "none")] = ratio
            s4 = scale.reshape(1, c, 1, 1)
            b4 = shift.reshape(1, c, 1, 1)
            row[tag + "_ms"] = device_ms(
                torch, lambda: ba.norm_act(x, scale, shift, "relu"))
            row[tag + "_plain_ms"] = device_ms(
                torch, lambda: ba.norm_act_plain(x, scale, shift, "relu"))
            row[tag + "_library_ms"] = device_ms(
                torch, lambda: torch.relu(torch.addcmul(b4, x, s4)))
            row[tag + "_bound_ms"] = 2 * x.numel() * x.element_size() \
                / HBM_BYTES_PER_S * 1e3
            row[tag + "_bwd_ms"] = device_ms(
                torch, lambda: ba.norm_act_bwd(x, scale, shift, dy, "relu"))
            row[tag + "_bwd_plain_ms"] = device_ms(
                torch, lambda: ba.norm_act_bwd_plain(x, scale, shift, dy,
                                                     "relu"))
            xl, sl, bl = (t.detach().requires_grad_(True)
                          for t in (x, s4, b4))
            row[tag + "_bwd_library_ms"] = device_ms(
                torch, lambda: torch.autograd.grad(
                    torch.relu(torch.addcmul(bl, xl, sl)), (xl, sl, bl), dy))
            # reads x and dy, writes dx (the (C,) sums are negligible)
            row[tag + "_bwd_bound_ms"] = 3 * x.numel() * x.element_size() \
                / HBM_BYTES_PER_S * 1e3
        per_shape[shape] = row
        log("bn_act %-19s sites serve=%d train=%d | fwd f32: err %.2e ms "
            "%.4f plain %.4f library %.4f bound %.4f; bf16: ms %.4f bound "
            "%.4f | bwd f32: ms %.4f plain %.4f library %.4f bound %.4f; "
            "bf16: ms %.4f bound %.4f" % (
                str(shape), serving_counts.get(shape, 0),
                training_counts.get(shape, 0), row["f32_relu_err"],
                row["f32_ms"], row["f32_plain_ms"], row["f32_library_ms"],
                row["f32_bound_ms"], row["bf16_ms"], row["bf16_bound_ms"],
                row["f32_bwd_ms"], row["f32_bwd_plain_ms"],
                row["f32_bwd_library_ms"], row["f32_bwd_bound_ms"],
                row["bf16_bwd_ms"], row["bf16_bwd_bound_ms"]))
    log("bn_act kernels: forward max abs err %.3g (f32), backward dx max "
        "abs err %.3g (f32); every shape, dtype and act within tolerance"
        % (max_err["fwd"], max_err["bwd"]))
    return per_shape, max_err


def draw_weights(symbol, data_shape, seed):
    """Seeded random weights (numpy) whose logits stay O(1-10): He-normal
    convs with each bottleneck's last conv scaled by 0.3 (the residual sum
    otherwise doubles its variance per unit), non-trivial gamma/beta and
    moving statistics."""
    import numpy as np
    rs = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = symbol.infer_shape(data=data_shape)
    args, aux = {}, {}
    for n, sh in zip(symbol.list_arguments(), arg_shapes):
        if n in ("data", "softmax_label"):
            continue
        if n.endswith("_weight") and len(sh) == 4:
            std = np.sqrt(2.0 / np.prod(sh[1:]))
            if n.endswith("_conv3_weight"):
                std *= 0.3
            args[n] = (rs.standard_normal(sh) * std).astype(np.float32)
        elif n.endswith("_weight"):
            args[n] = (rs.standard_normal(sh) / np.sqrt(sh[1])) \
                .astype(np.float32)
        elif n.endswith("_gamma"):
            args[n] = rs.uniform(0.8, 1.2, sh).astype(np.float32)
        else:
            args[n] = (0.1 * rs.standard_normal(sh)).astype(np.float32)
    for n, sh in zip(symbol.list_auxiliary_states(), aux_shapes):
        if n.endswith("_moving_mean"):
            aux[n] = (0.1 * rs.standard_normal(sh)).astype(np.float32)
        else:
            aux[n] = rs.uniform(0.8, 1.2, sh).astype(np.float32)
    return args, aux


def _with_prefixes(arg_params, aux_params):
    params = {"arg:" + k: v for k, v in arg_params.items()}
    params.update({"aux:" + k: v for k, v in aux_params.items()})
    return params


def _logits(mx, params, symbol, x, ctx):
    pred = mx.predict.Predictor(symbol, params, {"data": x.shape}, ctx=ctx,
                                output_name="fc1_output")
    return pred.forward(data=x).get_output(0)


def compare_logits(np, got, ref, what):
    check(got.shape == ref.shape and np.isfinite(got).all(),
          "%s: logits shape %s / not finite" % (what, got.shape))
    diff = float(np.abs(got - ref).max())
    bound = 1e-3 * float(np.abs(ref).max())
    same_argmax = bool((got.argmax(1) == ref.argmax(1)).all())
    log("%s: max |logit diff| %.3g (bound %.3g = 1e-3 x max|logit| %.3g), "
        "argmax equal %s" % (what, diff, bound, np.abs(ref).max(),
                             same_argmax))
    check(diff <= bound and same_argmax, what + ": disagrees with CPU path")
    return diff


def phase_serving(torch, mx, seed, card):
    import numpy as np
    ba = mx.kernels.bn_act
    image = IMAGE
    batch = BATCH
    symbol = mx.models.get_symbol("resnet-50", num_classes=1000,
                                  image_shape=image)
    sites, train_sites = bn_act_sites(mx, symbol, (batch,) + image)
    per_fwd = len(sites)
    n_fold = len(train_sites) - per_fwd
    log("resnet-50 serving plan: %d bn_act sites, %d bn_fold sites"
        % (per_fwd, n_fold))
    check(per_fwd == 17 and n_fold == 33, "unexpected fused plan")
    w_args, w_aux = draw_weights(symbol, (batch,) + image, seed)
    build_dir = os.path.join(ROOT, "mxnet_tpu_torch", "_build")
    os.makedirs(build_dir, exist_ok=True)
    ckpt_dir = tempfile.mkdtemp(prefix="smoke-ckpt-", dir=build_dir)
    try:
        prefix = os.path.join(ckpt_dir, "resnet50")
        host_args, host_aux = mx.convert.params_from_numpy(
            (w_args, w_aux), ctx=mx.cpu())
        mx.model.save_checkpoint(prefix, 0, symbol, host_args, host_aux)
        net, arg_params, aux_params = mx.model.load_checkpoint(prefix, 0)
    finally:
        shutil.rmtree(ckpt_dir)
    params = _with_prefixes(arg_params, aux_params)
    gpu = mx.gpu(0)
    pred = mx.predict.Predictor(net, params, {"data": (batch,) + image},
                                ctx=gpu)
    rs = np.random.RandomState(seed + 1)
    requests = [rs.standard_normal((batch,) + image).astype(np.float32)
                for _ in range(FORWARDS)]
    one = rs.standard_normal((1,) + image).astype(np.float32)

    # -- the main path: counts zeroed just before, read just after ---------
    ba.LAUNCHES = 0
    times = []
    outs = []
    for x in requests:
        t0 = time.perf_counter()
        out = pred.forward(data=x).get_output(0)
        times.append(time.perf_counter() - t0)
        outs.append(out)
    pred.reshape({"data": (1,) + image})
    out1 = pred.forward(data=one).get_output(0)
    pred.reshape({"data": (batch,) + image})
    out_back = pred.forward(data=requests[0]).get_output(0)
    launches = ba.LAUNCHES
    n_forwards = FORWARDS + 2
    # ----------------------------------------------------------------------

    log("bn_act launches on the serving path: %d over %d forwards "
        "(expected %d)" % (launches, n_forwards, per_fwd * n_forwards))
    check(launches == per_fwd * n_forwards,
          "bn_act launches %d != %d" % (launches, per_fwd * n_forwards))
    for out in outs + [out_back]:
        check(out.shape == (batch, 1000) and np.isfinite(out).all(),
              "serving output shape %s / not finite" % (out.shape,))
        check(np.allclose(out.sum(1), 1.0, atol=1e-4),
              "softmax rows do not sum to 1")
    check(out1.shape == (1, 1000) and np.isfinite(out1).all(),
          "batch-1 output bad")
    check(np.allclose(out_back, outs[0], rtol=1e-5, atol=1e-7),
          "same request after reshape gave a different answer")
    steady = times[1:] if len(times) > 1 else times
    img_s = batch * len(steady) / sum(steady)
    log("serving: first forward %.1f ms, steady %.2f ms/forward at batch "
        "%d -> %.1f img/s on %s" % (times[0] * 1e3,
                                    1e3 * sum(steady) / len(steady), batch,
                                    img_s, card))

    # -- agreement with the port's CPU path on one batch-2 request --------
    x2 = rs.standard_normal((2,) + image).astype(np.float32)
    ref = _logits(mx, params, net, x2, mx.cpu())
    compare_logits(np, _logits(mx, params, net, x2, gpu), ref,
                   "gpu fused vs cpu")
    before = ba.LAUNCHES
    old = os.environ.get("MXTPU_FUSED_KERNELS")  # mxlint: disable=env-direct-read (saved to restore)
    os.environ["MXTPU_FUSED_KERNELS"] = "0"
    try:
        unfused = _logits(mx, params, net, x2, gpu)
    finally:
        if old is None:
            del os.environ["MXTPU_FUSED_KERNELS"]
        else:
            os.environ["MXTPU_FUSED_KERNELS"] = old
    check(ba.LAUNCHES == before, "MXTPU_FUSED_KERNELS=0 still launched")
    compare_logits(np, unfused, ref, "gpu MXTPU_FUSED_KERNELS=0 vs cpu")
    return launches, net, params


# ---------------------------------------------------------------------------
# where a serving forward's device time goes
# ---------------------------------------------------------------------------

_KERNEL_CLASSES = (
    ("bn_act", ("bn_act_fwd_kernel", "bn_act_bwd_kernel")),
    ("lstm_cell", ("lstm_cell_fwd_kernel", "lstm_cell_bwd_kernel")),
    ("lstm_seq", ("lstm_seq_fwd_kernel", "lstm_seq_bwd_kernel")),
    ("embedding", ("embedding", "indexselect", "index_select",
                   "indexfuncsmall", "indexfunclarge", "segment",
                   "grad_weight", "sum_and_scatter", "index_put",
                   "indexing_backward", "radixsort")),
    ("softmax", ("softmax",)),
    ("conv/gemm", ("conv", "xmma", "gemm", "implicit", "cudnn", "sm90",
                   "winograd", "fft", "wgrad", "dgrad", "cutlass",
                   "ampere", "splitk")),
    ("copy", ("memcpy", "memset", "copy")),
    ("reduce", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "pooling",
                     "max_pool", "avg_pool")),
)


def _kernel_class(name):
    low = name.lower()
    for cls, keys in _KERNEL_CLASSES:
        if any(k in low for k in keys):
            return cls
    return "other"


def phase_profile(torch, mx, net, params, card, what="resnet-50"):
    """Fused vs ``MXTPU_FUSED_KERNELS=0`` serving throughput in turns
    (fused, unfused, unfused, fused), then a ``torch.profiler`` trace of
    a few fused forwards: device time by kernel class, kernel launches per
    forward, and the device's idle share.  Returns the img/s of each
    turn by plan."""
    import numpy as np
    from torch.autograd import DeviceType
    batch, forwards = BATCH, PROFILE_FORWARDS
    shape = (batch,) + IMAGE
    x = np.random.RandomState(5).standard_normal(shape).astype(np.float32)

    def bind(fused):
        old = os.environ.get("MXTPU_FUSED_KERNELS")  # mxlint: disable=env-direct-read (saved to restore)
        os.environ["MXTPU_FUSED_KERNELS"] = "1" if fused else "0"
        try:
            pred = mx.predict.Predictor(net, params, {"data": shape},
                                        ctx=mx.gpu(0))
        finally:
            if old is None:
                del os.environ["MXTPU_FUSED_KERNELS"]
            else:
                os.environ["MXTPU_FUSED_KERNELS"] = old
        pred.forward(data=x).get_output(0)     # warm-up (cuDNN setup)
        return pred

    preds = {"fused": bind(True), "unfused": bind(False)}
    rates = collections.defaultdict(list)
    for which in ("fused", "unfused", "unfused", "fused"):
        t0 = time.perf_counter()
        for _ in range(forwards):
            preds[which].forward(data=x).get_output(0)
        rates[which].append(batch * forwards / (time.perf_counter() - t0))
    for which, r in rates.items():
        log("profile: %s %s serving %s img/s (two turns of %d forwards, "
            "batch %d) on %s" % (what, which, " / ".join("%.1f" % v
                                                       for v in r),
                                 forwards, batch, card))

    pred = preds["fused"]
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(forwards):
            pred.forward(data=x).get_output(0)
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        rows.append((us / 1e3, evt.count, evt.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    check(busy_ms > 0, "profiler saw no device time")
    by_class = collections.Counter()
    launches = 0
    for ms, count, key in rows:
        by_class[_kernel_class(key)] += ms
        launches += count
    log("profile: %s %d fused forwards, wall %.2f ms, device busy %.2f "
        "ms, idle share %.3f, %.1f kernels per forward" % (
            what, forwards, wall_ms, busy_ms, 1 - busy_ms / wall_ms,
            launches / forwards))
    for cls, ms in by_class.most_common():
        log("profile: %s class %-12s %8.3f ms/forward  %5.1f%%" % (
            what, cls, ms / forwards, 100 * ms / busy_ms))
    for ms, count, key in rows[:12]:
        log("profile: %s kernel %8.3f ms/forward x%-4d %s" % (
            what, ms / forwards, count // forwards, key[:110]))
    return rates


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _cross_entropy(torch, probs, label):
    """Mean -log p[label] of softmax outputs, on the device."""
    p = probs.float().gather(1, label.long().reshape(-1, 1))
    return -torch.log(p.clamp_min(1e-30)).mean()


def make_trainer(torch, mx, seed):
    """ResNet-50 with bench.py's trainer settings (bench.py:105-115, float
    compute, no mesh) and a seeded Xavier init, on gpu(0)."""
    symbol = mx.models.get_symbol("resnet-50", num_classes=1000,
                                  image_shape=IMAGE)
    mx.random.seed(seed)
    tr = mx.parallel.SPMDTrainer(
        symbol, "sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4,
                        "rescale_grad": 1.0 / BATCH},
        mesh=None, compute_dtype=None, ctx=mx.gpu(0))
    tr.bind([("data", (BATCH,) + IMAGE)], [("softmax_label", (BATCH,))])
    tr.init_params(mx.initializer.Xavier(rnd_type="gaussian",
                                         factor_type="in", magnitude=2))
    return tr


def phase_training(torch, mx, seed, card, per_step_sites):
    import numpy as np
    ba = mx.kernels.bn_act
    tr = make_trainer(torch, mx, seed)
    dev = torch.device("cuda", 0)
    rs = np.random.RandomState(seed + 2)
    batches = [(torch.from_numpy(rs.standard_normal((BATCH,) + IMAGE)
                                 .astype(np.float32)).to(dev),
                torch.from_numpy(rs.randint(0, 1000, BATCH)
                                 .astype(np.float32)).to(dev))
               for _ in range(TRAIN_STEPS)]
    fixed = batches[0]
    params0 = {k: v.clone() for k, v in tr.params.items()}
    aux0 = {k: v.clone() for k, v in tr.aux.items()}
    ce_before = _cross_entropy(torch, tr.forward_only(*fixed)[0], fixed[1])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    plan = [batches[i] for i in range(TRAIN_STEPS)] + [fixed] * FIXED_STEPS
    n_steps = len(plan)

    # -- the main path: counts zeroed just before, read just after ---------
    ba.LAUNCHES = 0
    ba.BWD_LAUNCHES = 0
    stamps, losses = [], []
    for x, y in plan:
        stamps.append(time.perf_counter())
        out = tr.step(x, y)[0]
        losses.append(_cross_entropy(torch, out, y))
    torch.cuda.synchronize()
    stamps.append(time.perf_counter())
    skipped = tr.skipped_steps
    fwd_launches, bwd_launches = ba.LAUNCHES, ba.BWD_LAUNCHES
    # ----------------------------------------------------------------------

    peak = torch.cuda.max_memory_allocated()
    ce_after = _cross_entropy(torch, tr.forward_only(*fixed)[0], fixed[1])
    losses = [float(v) for v in torch.stack(losses).cpu()]
    ce_before, ce_after = float(ce_before), float(ce_after)
    log("training: bn_act launches over %d steps: forward %d, backward %d "
        "(expected %d each)" % (n_steps, fwd_launches, bwd_launches,
                                per_step_sites * n_steps))
    check(fwd_launches == per_step_sites * n_steps
          and bwd_launches == per_step_sites * n_steps,
          "bn_act training launches %d / %d != %d" % (
              fwd_launches, bwd_launches, per_step_sites * n_steps))
    log("training: per-step loss %s" % " ".join("%.4f" % v for v in losses))
    check(all(np.isfinite(losses)), "non-finite training loss")
    log("training: cross-entropy on the fixed batch %.4f before, %.4f after "
        "%d steps on it" % (ce_before, ce_after, FIXED_STEPS))
    check(np.isfinite(ce_after) and ce_after < ce_before,
          "the fixed batch's cross-entropy did not fall")
    check(skipped == 0, "%d guard-skipped steps" % skipped)
    moved = sum(not torch.equal(v, params0[k]) for k, v in tr.params.items())
    aux_moved = sum(not torch.equal(v, aux0[k]) for k, v in tr.aux.items())
    log("training: %d of %d params and %d of %d moving statistics changed"
        % (moved, len(params0), aux_moved, len(aux0)))
    check(moved == len(params0) and aux_moved == len(aux0),
          "params or moving statistics did not change")
    steady_s = (stamps[-1] - stamps[2]) / (n_steps - 2)
    log("training: first step %.1f ms, steady %.2f ms/step at batch %d -> "
        "%.1f img/s, peak memory %.2f GiB (max_memory_allocated) on %s" % (
            (stamps[1] - stamps[0]) * 1e3, steady_s * 1e3, BATCH,
            BATCH / steady_s, peak / 2 ** 30, card))
    return tr, batches, fwd_launches, bwd_launches


def _executor_step(mx, symbol, weights, x, y, ctx):
    """One batch through forward(is_train=True) -> backward() in x's
    dtype: outputs, every gradient and the moving statistics, as float64
    numpy.  float32 binds through simple_bind; float64 (the CPU
    reference) through bind with float64 arrays, since simple_bind
    allocates float32 gradients."""
    import numpy as np
    w_args, w_aux = weights
    if x.dtype == np.float32:
        ex = symbol.simple_bind(ctx, grad_req="write", data=x.shape,
                                softmax_label=y.shape)
        for n, v in w_args.items():
            ex.arg_dict[n][:] = v
        for n, v in w_aux.items():
            ex.aux_dict[n][:] = v
    else:
        arg_shapes, _, _ = symbol.infer_shape(data=x.shape,
                                              softmax_label=y.shape)

        def arr(v):
            return mx.nd.array(v, ctx=ctx, dtype=x.dtype)
        names = symbol.list_arguments()
        ex = symbol.bind(
            ctx, {n: arr(w_args[n] if n in w_args else np.zeros(s))
                  for n, s in zip(names, arg_shapes)},
            args_grad={n: arr(np.zeros(s)) for n, s in zip(names, arg_shapes)},
            grad_req="write",
            aux_states={n: arr(v) for n, v in w_aux.items()})
    ex.forward(is_train=True, data=x, softmax_label=y)
    ex.backward()
    out = {"output": ex.outputs[0].asnumpy()}
    out.update({"grad:" + k: v.asnumpy() for k, v in ex.grad_dict.items()})
    out.update({"aux:" + k: v.asnumpy() for k, v in ex.aux_dict.items()})
    return {k: v.astype(np.float64) for k, v in out.items()}


def _worst_max_rel(np, got, ref, keys):
    """``(max |diff| / max |ref|, key)`` of the worst tensor among keys."""
    worst = (-1.0, "")
    for k in keys:
        diff = float(np.abs(got[k] - ref[k]).max()) if ref[k].size else 0.0
        top = float(np.abs(ref[k]).max()) if ref[k].size else 0.0
        ratio = diff / top if top > 0 else (0.0 if diff == 0 else np.inf)
        worst = max(worst, (ratio, k))
    return worst


def _rel_l2(np, got, ref, keys):
    """Relative L2 error of the tensors under keys taken together."""
    num = sum(float(np.sum((got[k] - ref[k]) ** 2)) for k in keys)
    den = sum(float(np.sum(ref[k] ** 2)) for k in keys)
    return (num / den) ** 0.5 if den > 0 else (0.0 if num == 0 else np.inf)


def _compare_train(np, got, ref, exact, cpu_l2, what, zero_grads=()):
    """Outputs and moving statistics against the port's CPU float32 path,
    each within AGREE_REL_TOL x its max |cpu|.  Gradients against the
    float64 CPU run: together within max(AGREE_REL_TOL, GRAD_L2_FACTOR x
    the CPU float32 path's own relative L2 error ``cpu_l2``), each tensor
    within GRAD_TENSOR_L2_TOL; the worst tensor by max |diff| / max |cpu|
    is printed beside them.  ``zero_grads`` are gradients that are zero
    in exact arithmetic (a conv bias a batch-statistics BatchNorm
    subtracts again), so only rounding is left in them: each is held to
    an L2 norm within AGREE_REL_TOL x that of all float64 gradients
    instead of the per-tensor bound."""
    for k, r in ref.items():
        check(got[k].shape == r.shape and np.isfinite(got[k]).all(),
              "%s: %s shape %s / not finite" % (what, k, got[k].shape))
    grads = [k for k in ref if k.startswith("grad:")]
    state = [k for k in ref if not k.startswith("grad:")]
    s_ratio, s_key = _worst_max_rel(np, got, ref, state)
    log("%s: outputs and moving statistics (%d tensors), worst %s: max "
        "|diff| / max |cpu| %.3g (bound %g)" % (what, len(state), s_key,
                                                s_ratio, AGREE_REL_TOL))
    check(s_ratio <= AGREE_REL_TOL,
          what + ": outputs or moving statistics disagree with the CPU path")
    g_l2 = _rel_l2(np, got, exact, grads)
    bound = max(AGREE_REL_TOL, GRAD_L2_FACTOR * cpu_l2)
    t_l2, t_key = max((_rel_l2(np, got, exact, [k]), k) for k in grads
                      if k not in zero_grads)
    if zero_grads:
        total = sum(float(np.sum(exact[k] ** 2)) for k in grads) ** 0.5
        z_norm, z_key = max((float(np.linalg.norm(got[k])), k)
                            for k in zero_grads)
        log("%s: %d gradients zero in exact arithmetic, largest L2 norm %s "
            "%.3g (bound %.3g = %g x the float64 gradients' %.3g)" % (
                what, len(zero_grads), z_key, z_norm, AGREE_REL_TOL * total,
                AGREE_REL_TOL, total))
        check(z_norm <= AGREE_REL_TOL * total, what + ": a gradient that "
              "is zero in exact arithmetic is not")
    m_ratio, m_key = _worst_max_rel(np, got, ref, grads)
    log("%s: %d gradients, relative L2 error against float64 %.3g (bound "
        "%.3g); worst tensor %s %.3g (bound %g); worst by max |diff| / max "
        "|cpu float32|: %s %.3g" % (what, len(grads), g_l2, bound, t_key,
                                    t_l2, GRAD_TENSOR_L2_TOL, m_key, m_ratio))
    check(g_l2 <= bound and t_l2 <= GRAD_TENSOR_L2_TOL,
          what + ": gradients disagree with the float64 CPU run")


def phase_train_agreement(torch, mx, seed):
    """One batch-4 training forward/backward on the card, fused and with
    MXTPU_FUSED_KERNELS=0, against the port's CPU path (float32, and
    float64 as the exact reference for the gradients)."""
    import numpy as np
    ba = mx.kernels.bn_act
    symbol = mx.models.get_symbol("resnet-50", num_classes=1000,
                                  image_shape=IMAGE)
    shape = (AGREE_BATCH,) + IMAGE
    weights = draw_weights(symbol, shape, seed)
    rs = np.random.RandomState(seed + 3)
    x = rs.standard_normal(shape).astype(np.float32)
    y = rs.randint(0, 1000, AGREE_BATCH).astype(np.float32)
    t0 = time.perf_counter()
    ref = _executor_step(mx, symbol, weights, x, y, mx.cpu())
    exact = _executor_step(mx, symbol, weights, x.astype(np.float64),
                           y.astype(np.float64), mx.cpu())
    grads = [k for k in ref if k.startswith("grad:")]
    cpu_l2 = _rel_l2(np, ref, exact, grads)
    c_ratio, c_key = _worst_max_rel(np, ref, exact, grads)
    log("training agreement: CPU float32 and float64 forward+backward at "
        "batch %d took %.1f s; the CPU float32 gradients' relative L2 error "
        "against float64 is %.3g, worst by max |diff| / max |ref|: %s %.3g "
        "(ReLU masks that flip between roundings)" % (
            AGREE_BATCH, time.perf_counter() - t0, cpu_l2, c_key, c_ratio))
    before = (ba.LAUNCHES, ba.BWD_LAUNCHES)
    got = _executor_step(mx, symbol, weights, x, y, mx.gpu(0))
    launched = (ba.LAUNCHES - before[0], ba.BWD_LAUNCHES - before[1])
    check(launched == (50, 50), "fused executor step launched %s bn_act "
          "kernels, not (50, 50)" % (launched,))
    _compare_train(np, got, ref, exact, cpu_l2, "training gpu fused")
    before = (ba.LAUNCHES, ba.BWD_LAUNCHES)
    old = os.environ.get("MXTPU_FUSED_KERNELS")  # mxlint: disable=env-direct-read (saved to restore)
    os.environ["MXTPU_FUSED_KERNELS"] = "0"
    try:
        unfused = _executor_step(mx, symbol, weights, x, y, mx.gpu(0))
    finally:
        if old is None:
            del os.environ["MXTPU_FUSED_KERNELS"]
        else:
            os.environ["MXTPU_FUSED_KERNELS"] = old
    check((ba.LAUNCHES, ba.BWD_LAUNCHES) == before,
          "MXTPU_FUSED_KERNELS=0 training still launched bn_act")
    _compare_train(np, unfused, ref, exact, cpu_l2,
                   "training gpu MXTPU_FUSED_KERNELS=0")


#: the flash kernel's device functions: the tiled_f32 and mma_bf16
#: routes and the rowwise route (csrc/flash_attention.cu)
FLASH_KERNEL_NAMES = ("flash_attention_tiled_kernel",
                      "flash_attention_mma_kernel",
                      "flash_attention_fwd_kernel")
#: kernels with a class of their own in a training trace
_OWN_CLASSES = (("bn_act_fwd_kernel", "bn_act_fwd"),
                ("bn_act_bwd_kernel", "bn_act_bwd"),
                ("lstm_cell_fwd_kernel", "lstm_cell_fwd"),
                ("lstm_cell_bwd_kernel", "lstm_cell_bwd"),
                ("lstm_seq_fwd_kernel", "lstm_seq_fwd"),
                ("lstm_seq_bwd_kernel", "lstm_seq_bwd")) + tuple(
                    (name, "flash_attention_fwd")
                    for name in FLASH_KERNEL_NAMES) + (
                ("rtc_elementwise_kernel", "rtc"),)


def _trace_classes(path, update_range):
    """Device time by class from a chrome trace: the port's kernels
    (``bn_act_fwd``, ``bn_act_bwd``, ``lstm_cell_fwd``, ``lstm_cell_bwd``,
    ``lstm_seq_fwd``, ``lstm_seq_bwd``, ``flash_attention_fwd``, ``rtc``),
    ``optimizer update`` (kernels whose launch lies inside the trainer's
    update range) and the serving classes.  Returns ``(busy_us, {class:
    us}, kernels, top [(us, count, name)], update ranges)``."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in events
             if e.get("name") == update_range
             and e.get("cat") == "user_annotation"]
    launch_ts = {}
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if corr is not None and e.get("cat") in ("cuda_runtime",
                                                 "cuda_driver"):
            launch_ts[corr] = e["ts"]
    by_class = collections.Counter()
    by_name = collections.Counter()
    counts = collections.Counter()
    n = 0
    for e in events:
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        name, dur = e.get("name", ""), float(e.get("dur", 0))
        n += 1
        cls = next((c for key, c in _OWN_CLASSES if key in name), None)
        if cls is None:
            ts = launch_ts.get((e.get("args") or {}).get("correlation"))
            if ts is not None and any(a <= ts <= b for a, b in spans):
                cls = "optimizer update"
            else:
                cls = _kernel_class(name)
        by_class[cls] += dur
        by_name[name] += dur
        counts[name] += 1
    top = sorted(((us, counts[k], k) for k, us in by_name.items()),
                 reverse=True)
    return sum(by_class.values()), by_class, n, top, len(spans)


def phase_train_profile(torch, mx, tr, batches, card, what="train",
                        need=("bn_act_fwd", "bn_act_bwd"), unit="batch %d"
                        % BATCH):
    """A torch.profiler trace of a few SPMDTrainer steps (see
    ``profile_steps``)."""
    from mxnet_tpu_torch.parallel.trainer import UPDATE_RANGE
    tr.step(*batches[1])          # flush the previous phase's state
    torch.cuda.synchronize()
    return profile_steps(
        torch, lambda i: tr.step(*batches[i % len(batches)]),
        tr.flush_step_guard, UPDATE_RANGE, card, what, need, unit)


def profile_steps(torch, run, finish, update_range, card, what, need, unit,
                  steps=PROFILE_STEPS):
    """A torch.profiler trace of ``steps`` calls of ``run(i)`` (then
    ``finish()``): idle share, kernel launches per step, device time per
    step by class; each class in ``need`` and the optimizer update (the
    kernels launched inside ``update_range``) must show device time.
    Returns ``{kernel name: launches}`` of the window."""
    build_dir = os.path.join(ROOT, "mxnet_tpu_torch", "_build")
    os.makedirs(build_dir, exist_ok=True)
    fd, path = tempfile.mkstemp(prefix="train-trace-", suffix=".json",
                                dir=build_dir)
    os.close(fd)
    try:
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(steps):
                run(i)
            finish()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        prof.export_chrome_trace(path)
        busy_us, by_class, n_kernels, top, n_spans = _trace_classes(
            path, update_range)
    finally:
        os.remove(path)
    busy_ms = busy_us / 1e3
    check(busy_ms > 0, "%s profile saw no device time" % what)
    check(n_spans == steps, "%s profile saw %d update ranges, not %d"
          % (what, n_spans, steps))
    for cls in tuple(need) + ("optimizer update",):
        check(by_class.get(cls, 0) > 0, "%s profile: no %s time"
              % (what, cls))
    log("%s profile: %d steps at %s, wall %.2f ms, device busy %.2f ms, "
        "idle share %.3f, %.1f kernels per step, on %s" % (
            what, steps, unit, wall_ms, busy_ms, 1 - busy_ms / wall_ms,
            n_kernels / steps, card))
    for cls, us in by_class.most_common():
        log("%s profile: class %-20s %8.3f ms/step  %5.1f%%" % (
            what, cls, us / 1e3 / steps, 100 * us / busy_us))
    for us, count, key in top[:12]:
        log("%s profile: kernel %8.3f ms/step x%-4d %s" % (
            what, us / 1e3 / steps, count // steps, key[:110]))
    return {key: count for _, count, key in top}


# ---------------------------------------------------------------------------
# the LSTM language model: lstm_cell kernels, training, serving
# ---------------------------------------------------------------------------

def phase_lstm_kernels(torch, mx, seed):
    """The lstm_cell forward and backward kernels against their plain
    versions at LSTM_SHAPES, float32 and bfloat16; times in float32 and
    bfloat16, library yardstick in float32."""
    lc = mx.kernels.lstm_cell
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 10)
    rows = {}
    max_err = {"fwd": 0.0, "bwd": 0.0}
    for b, h in LSTM_SHAPES:
        g32 = torch.randn((b, 4 * h), generator=gen, device=dev) * 2.0
        c32, dh32, dc32 = (torch.randn((b, h), generator=gen, device=dev)
                           for _ in range(3))
        row = {}
        for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            g, c, dh, dc = (t.to(dtype) for t in (g32, c32, dh32, dc32))
            got = lc.lstm_cell_fwd(g, c) + lc.lstm_cell_bwd(g, c, dh, dc)
            ref = lc.lstm_cell_plain(g, c) + \
                lc.lstm_cell_bwd_plain(g, c, dh, dc)
            torch.cuda.synchronize()
            for k, (a, r) in enumerate(zip(got, ref)):
                check(a.shape == r.shape and a.dtype == r.dtype,
                      "lstm_cell %s %s output %d: shape/dtype differ"
                      % ((b, h), tag, k))
                err = (a.float() - r.float()).abs().max().item()
                which = "fwd" if k < 2 else "bwd"
                if tag == "f32":
                    tol = LSTM_F32_TOL[0 if k < 2 else 1]
                    check(err <= tol, "lstm_cell %s f32 %s output %d: max "
                          "abs err %.3g > %g" % (which, (b, h), k, err, tol))
                    max_err[which] = max(max_err[which], err)
                else:
                    rel = err / max(r.float().abs().max().item(), 1e-30)
                    check(rel <= BF16_REL_TOL, "lstm_cell %s bf16 %s output "
                          "%d: rel err %.3g > %g" % (which, (b, h), k, rel,
                                                     BF16_REL_TOL))
                row["%s_%d_err" % (tag, k)] = err
            row[tag + "_ms"] = device_ms(torch, lambda: lc.lstm_cell_fwd(g, c))
            row[tag + "_plain_ms"] = device_ms(
                torch, lambda: lc.lstm_cell_plain(g, c))
            row[tag + "_bwd_ms"] = device_ms(
                torch, lambda: lc.lstm_cell_bwd(g, c, dh, dc))
            row[tag + "_bwd_plain_ms"] = device_ms(
                torch, lambda: lc.lstm_cell_bwd_plain(g, c, dh, dc))
            size = g.element_size()
            # forward reads gates (4H) and c_prev, writes h and c; backward
            # reads gates, c_prev, dh, dc, writes dgates (4H) and dc_prev
            row[tag + "_bound_ms"] = 7 * b * h * size / HBM_BYTES_PER_S * 1e3
            row[tag + "_bwd_bound_ms"] = 12 * b * h * size \
                / HBM_BYTES_PER_S * 1e3
            if tag == "f32":
                # PyTorch's own fused LSTM cell on the same function (gate
                # order [i, f, g, o], as MXNet's), a yardstick the port
                # never calls; its hidden-gates input is allocated once,
                # so only the cell itself is timed
                fused_cell = torch.ops.aten._thnn_fused_lstm_cell
                zeros = torch.zeros_like(g)
                hy, cy, ws = fused_cell(g, zeros, c)
                row["f32_library_ms"] = device_ms(
                    torch, lambda: fused_cell(g, zeros, c))
                row["f32_bwd_library_ms"] = device_ms(
                    torch, lambda: torch.ops.aten
                    ._thnn_fused_lstm_cell_backward_impl(dh, dc, c, cy, ws,
                                                         False))
        rows[(b, h)] = row
        log("lstm_cell (B, H)=%-11s fwd f32: err h %.2e c %.2e, ms %.5f "
            "plain %.5f library %.5f bound %.5f; bf16 ms %.5f bound %.5f | "
            "bwd f32: err dgates %.2e dc_prev %.2e, ms %.5f plain %.5f "
            "library %.5f bound %.5f; bf16 ms %.5f bound %.5f" % (
                str((b, h)), row["f32_0_err"], row["f32_1_err"],
                row["f32_ms"], row["f32_plain_ms"], row["f32_library_ms"],
                row["f32_bound_ms"], row["bf16_ms"], row["bf16_bound_ms"],
                row["f32_2_err"], row["f32_3_err"], row["f32_bwd_ms"],
                row["f32_bwd_plain_ms"], row["f32_bwd_library_ms"],
                row["f32_bwd_bound_ms"], row["bf16_bwd_ms"],
                row["bf16_bwd_bound_ms"]))
    log("lstm_cell kernels: forward max abs err %.3g, backward %.3g "
        "(float32); every shape and dtype within tolerance"
        % (max_err["fwd"], max_err["bwd"]))
    return rows, max_err


def _rel_err(a, r):
    """max |a - r| / max |r|, over float32 copies."""
    return (a.float() - r.float()).abs().max().item() / max(
        r.float().abs().max().item(), 1e-30)


def event_ms(torch, fn, iters=20):
    """Time of one ``fn()`` call between CUDA events around ``iters``
    calls (after a warm-up): for work a CUDA graph does not capture."""
    for _ in range(3):
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


def traced_device_ms(torch, fn, iters=10):
    """Device time of one ``fn()`` call: the summed durations of the
    kernels, copies and sets a torch.profiler trace of ``iters`` calls
    records, over ``iters`` (after a warm-up): for work whose host side
    is as slow as its device side."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    build_dir = os.path.join(ROOT, "mxnet_tpu_torch", "_build")
    os.makedirs(build_dir, exist_ok=True)
    fd, path = tempfile.mkstemp(prefix="call-trace-", suffix=".json",
                                dir=build_dir)
    os.close(fd)
    try:
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        prof.export_chrome_trace(path)
        busy_us = _trace_classes(path, None)[0]
    finally:
        os.remove(path)
    check(busy_us > 0, "the trace of a timed call saw no device time")
    return busy_us / 1e3 / iters


def _seq_bound_ms(roofline, T, N, H, itemsize, backward=False, keep=True):
    """The lstm_seq kernel's bound: its products at the float32 (67
    TFLOP/s) or bf16 (989) peak, or its bytes at 3.35 TB/s, whichever is
    larger; and which binds."""
    work = roofline.workload("lstm_seq", itemsize=itemsize, t=T, n=N, h=H,
                             backward=backward, keep=keep)
    peak = F32_FLOPS_PER_S if itemsize == 4 else BF16_FLOPS_PER_S
    ops = work["flops"] / peak * 1e3
    mem = work["fused_bytes"] / HBM_BYTES_PER_S * 1e3
    return max(ops, mem), ("operations" if ops >= mem else "bytes")


def phase_lstm_seq_kernels(torch, mx, seed, card):
    """The recurrence's persistent kernels (``lstm_seq_fwd`` /
    ``lstm_seq_bwd``) against their plain versions at LSTM_SEQ_SHAPES,
    float32 and bfloat16, on the route lstm_seq_route picks (per_step only
    at H = 1024); then times at the LM's layer."""
    lc = mx.kernels.lstm_cell
    fns = lc._kernels()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 12)
    f32, bf16 = torch.float32, torch.bfloat16
    limit = max(h for h in range(LM_HIDDEN, 1025)
                if lc.lstm_seq_route(LM_BATCH, h, f32) == "persistent")
    shapes = [s or (LM_SEQ, LM_BATCH, limit) for s in LSTM_SEQ_SHAPES]
    max_err = {"fwd": 0.0, "bwd": 0.0}
    data = {}
    for T, N, H in shapes:
        xg32 = torch.randn((T, N, 4 * H), generator=gen, device=dev) * 1.5
        w32 = (torch.rand((4 * H, H), generator=gen, device=dev) * 2 - 1) \
            * (6.0 / (5 * H)) ** 0.5
        h032, c032, dhT32, dcT32 = (
            0.5 * torch.randn((N, H), generator=gen, device=dev)
            for _ in range(4))
        dhs32 = torch.randn((T, N, H), generator=gen, device=dev)
        for dtype, tag in ((f32, "f32"), (bf16, "bf16")):
            xg, w, h0, c0, dhs, dhT, dcT = (
                t.to(dtype) for t in (xg32, w32, h032, c032, dhs32, dhT32,
                                      dcT32))
            route = lc.lstm_seq_route(N, H, dtype)
            check(route == ("per_step" if H == 1024 else "persistent"),
                  "lstm_seq %s %s took route %s" % ((T, N, H), tag, route))
            plan = lc.lstm_seq_plan(N, H, dtype)
            note = "route %s" % route
            if plan is not None:
                code = 0 if dtype == f32 else 1
                for bwd, key in ((0, "smem_fwd"), (1, "smem_bwd")):
                    check(fns["lstm_seq_smem"](H, plan["cluster"],
                                               plan["rows"], code, bwd)
                          == plan[key], "lstm_seq %s %s: the C and Python "
                          "shared-memory sizes differ" % ((T, N, H), tag))
                resident = [lc.lstm_seq_resident(N, H, dtype, backward=b)
                            for b in (False, True)]
                check(min(resident) >= 1, "lstm_seq %s: no cluster fits"
                      % ((T, N, H),))
                note += (", %d clusters of %d blocks x %d rows, smem %d / "
                         "%d B, the card holds %d / %d such clusters at "
                         "once%s" % (
                             plan["clusters"], plan["cluster"], plan["rows"],
                             plan["smem_fwd"], plan["smem_bwd"], resident[0],
                             resident[1], "" if plan["clusters"] <= min(
                                 resident) else " (the rest wait)"))
            got = lc.lstm_seq_fwd(xg, w, h0, c0, keep=True, route=route)
            ref = lc.lstm_seq_plain(xg, w, h0, c0, keep=True)
            got_b = lc.lstm_seq_bwd(ref.gates, ref.c_prev, w, dhs, dhT, dcT,
                                    route=route)
            ref_b = lc.lstm_seq_bwd_plain(ref.gates, ref.c_prev, w, dhs,
                                          dhT, dcT)
            torch.cuda.synchronize()
            errs = {}
            for k in ("hs", "cs", "hT", "cT", "gates", "h_prev", "c_prev"):
                a, r = getattr(got, k), getattr(ref, k)
                check(a.shape == r.shape and a.dtype == r.dtype,
                      "lstm_seq %s %s %s: shape/dtype differ" % (
                          (T, N, H), tag, k))
                errs[k] = _rel_err(a, r)
            for k, a, r in zip(("dgates", "dh0", "dc0"), got_b, ref_b):
                check(a.shape == r.shape and a.dtype == r.dtype,
                      "lstm_seq %s %s %s: shape/dtype differ" % (
                          (T, N, H), tag, k))
                errs[k] = _rel_err(a, r)
            tol = LSTM_SEQ_F32_TOL if dtype == f32 else BF16_REL_TOL
            worst = max(errs, key=errs.get)
            check(errs[worst] <= tol, "lstm_seq %s %s: %s rel err %.3g > %g"
                  % ((T, N, H), tag, worst, errs[worst], tol))
            if dtype == f32 and route == "persistent":
                max_err["fwd"] = max(max_err["fwd"], max(
                    (getattr(got, k).float() - getattr(ref, k).float())
                    .abs().max().item() for k in ("hs", "cs", "gates")))
                max_err["bwd"] = max(max_err["bwd"], max(
                    (a.float() - r.float()).abs().max().item()
                    for a, r in zip(got_b, ref_b)))
            log("lstm_seq (T, N, H)=%-15s %-4s %s; max |diff| / max |plain|:"
                " %s (bound %g)" % (str((T, N, H)), tag, note, " ".join(
                    "%s %.2e" % kv for kv in errs.items()), tol))
            if (T, N, H) == (LM_SEQ, LM_BATCH, LM_HIDDEN):
                data[tag] = (xg, w, h0, c0, dhs, dhT, dcT, ref)
            if (N, H) == (LM_BATCH, LM_HIDDEN) and dtype == f32 \
                    and T in LSTM_SEQ_BUCKET_T:
                data[T] = (xg, w, h0, c0, dhs, dhT, dcT, ref)
    times = {tag: _seq_times(torch, mx, *data[tag]) for tag in ("f32",
                                                                "bf16")}
    for T in LSTM_SEQ_BUCKET_T:
        t = _bucket_seq_times(torch, mx, *data[T])
        log("lstm_seq layer at (T, N, H)=%s f32 (a bucket of the bucketed "
            "LM), ms: forward kernel %.4f, plain %.4f, bound %.4f (%s) | "
            "backward kernel %.4f, plain %.4f, bound %.4f (%s) on %s" % (
                (T, LM_BATCH, LM_HIDDEN), t["fwd"], t["fwd_plain"],
                t["fwd_bound"], t["fwd_bound_by"], t["bwd"], t["bwd_plain"],
                t["bwd_bound"], t["bwd_bound_by"], card))
    for tag, t in times.items():
        log("lstm_seq layer at (T, N, H)=%s %s, ms: forward kernel %.4f "
            "(serving, no residuals: %.4f), per_step %.4f, plain %.4f, bound "
            "%.4f (%s); projection addmm + kernel %.4f, cuDNN LSTM forward "
            "%.4f (device time in a trace, training mode; between events "
            "%.4f) | backward kernel %.4f (+ dW matmul %.4f), per_step + dW "
            "%.4f, "
            "plain %.4f (+ dW %.4f), bound %.4f (+ dW %.4f), cuDNN backward "
            "%.4f (forward + backward %.4f less forward, device time; "
            "between events %.4f) on %s" % (
                (LM_SEQ, LM_BATCH, LM_HIDDEN), tag, t["fwd"], t["fwd_serve"],
                t["fwd_step"], t["fwd_plain"], t["fwd_bound"],
                t["fwd_bound_by"], t["proj_fwd"], t["cudnn_fwd"],
                t["cudnn_fwd_event"], t["bwd"], t["bwd_dw"],
                t["bwd_step_dw"], t["bwd_plain"], t["bwd_plain_dw"],
                t["bwd_bound"], t["bwd_dw_bound"], t["cudnn_bwd"],
                t["cudnn_fwd_bwd"], t["cudnn_fwd_bwd_event"], card))
    log("lstm_seq kernels: float32 forward max abs err %.3g, backward %.3g; "
        "every shape and dtype within tolerance, per_step only at H = 1024"
        % (max_err["fwd"], max_err["bwd"]))
    return times, max_err


def _bucket_seq_times(torch, mx, xg, w, h0, c0, dhs, dhT, dcT, out):
    """Device ms of one layer's persistent recurrence at a bucket's T,
    forward (with residuals) and backward (without the dW matmul), beside
    the plain versions and the bounds."""
    lc = mx.kernels.lstm_cell
    T, N, G = xg.shape
    res = (out.gates, out.c_prev, w, dhs, dhT, dcT)
    t = {
        "fwd": device_ms(torch, lambda: lc.lstm_seq_fwd(xg, w, h0, c0,
                                                        keep=True)),
        "fwd_plain": device_ms(torch, lambda: lc.lstm_seq_plain(
            xg, w, h0, c0, keep=True)),
        "bwd": device_ms(torch, lambda: lc.lstm_seq_bwd(*res)),
        "bwd_plain": device_ms(torch, lambda: lc.lstm_seq_bwd_plain(*res)),
    }
    for key, backward in (("fwd", False), ("bwd", True)):
        t[key + "_bound"], t[key + "_bound_by"] = _seq_bound_ms(
            mx.kernels.roofline, T, N, G // 4, xg.element_size(),
            backward=backward)
    return t


def _seq_times(torch, mx, xg, w, h0, c0, dhs, dhT, dcT, out):
    """Device ms of one LM layer's recurrence on each route, the plain
    versions, the bounds, and cuDNN's one-layer LSTM at the same shape
    (timed only: the port never calls it)."""
    lc = mx.kernels.lstm_cell
    roofline = mx.kernels.roofline
    T, N, G = xg.shape
    H = G // 4
    size = xg.element_size()

    def dw(dgates):
        return torch.matmul(dgates.reshape(T * N, G).t(),
                            out.h_prev.reshape(T * N, H))
    res = (out.gates, out.c_prev, w, dhs, dhT, dcT)
    t = {
        "fwd": device_ms(torch, lambda: lc.lstm_seq_fwd(xg, w, h0, c0,
                                                        keep=True)),
        "fwd_serve": device_ms(torch, lambda: lc.lstm_seq_fwd(xg, w, h0, c0)),
        "fwd_step": device_ms(torch, lambda: lc.lstm_seq_fwd(
            xg, w, h0, c0, keep=True, route="per_step")),
        "fwd_plain": device_ms(torch, lambda: lc.lstm_seq_plain(
            xg, w, h0, c0, keep=True)),
        "bwd": device_ms(torch, lambda: lc.lstm_seq_bwd(*res)),
        "bwd_dw": device_ms(torch, lambda: dw(lc.lstm_seq_bwd(*res)[0])),
        "bwd_step_dw": device_ms(torch, lambda: dw(lc.lstm_seq_bwd(
            *res, route="per_step")[0])),
        "bwd_plain": device_ms(torch, lambda: lc.lstm_seq_bwd_plain(*res)),
        "bwd_plain_dw": device_ms(torch, lambda: dw(
            lc.lstm_seq_bwd_plain(*res)[0])),
    }
    t["fwd_bound"], t["fwd_bound_by"] = _seq_bound_ms(roofline, T, N, H,
                                                      size)
    t["bwd_bound"], t["bwd_bound_by"] = _seq_bound_ms(roofline, T, N, H,
                                                      size, backward=True)
    peak = F32_FLOPS_PER_S if size == 4 else BF16_FLOPS_PER_S
    dw_bytes = (T * N * G + T * N * H + G * H) * size
    t["bwd_dw_bound"] = t["bwd_bound"] + max(
        2 * T * N * G * H / peak, dw_bytes / HBM_BYTES_PER_S) * 1e3
    # the port's own input projection (bias added in one addmm) + kernel,
    # which is what cuDNN's layer computes from its (T, N, H) input
    gen = torch.Generator(device=xg.device)
    gen.manual_seed(7)
    x = torch.randn((T, N, H), generator=gen, device=xg.device).to(xg.dtype)
    w_i2h = (torch.rand((G, H), generator=gen, device=xg.device) * 0.1
             - 0.05).to(xg.dtype)
    bias = torch.zeros(G, device=xg.device, dtype=xg.dtype)
    t["proj_fwd"] = device_ms(torch, lambda: lc.lstm_seq_fwd(
        torch.addmm(bias, x.reshape(T * N, H), w_i2h.t()).reshape(T, N, G),
        w, h0, c0, keep=True))
    lstm = torch.nn.LSTM(H, H, 1).to(device=xg.device, dtype=xg.dtype)
    state = (h0[None], c0[None])
    xr = x.clone().requires_grad_(True)
    grad = torch.ones((T, N, H), device=xg.device, dtype=xg.dtype)

    def fwd_bwd():
        y, _ = lstm(xr, state)
        torch.autograd.backward(y, grad)
    # autograd is not captured in a graph, and between CUDA events the
    # host's enqueue of a cuDNN call takes as long as its kernels; so the
    # device time is the kernels' summed durations in a profiler trace,
    # and the event time is kept beside it
    for key, fn in (("cudnn_fwd_bwd", fwd_bwd),
                    ("cudnn_fwd", lambda: lstm(xr, state))):
        t[key + "_event"] = event_ms(torch, fn)
        t[key] = traced_device_ms(torch, fn)
    t["cudnn_bwd"] = t["cudnn_fwd_bwd"] - t["cudnn_fwd"]
    return t


def lm_symbol(mx):
    sym, _, _ = mx.models.lstm_lm.lstm_lm_sym(LM_SEQ, LM_VOCAB, LM_EMBED,
                                              LM_HIDDEN, LM_LAYERS)
    return sym


def _lm_cross_entropy(torch, probs, label):
    """Mean -log p of the (T*N, V) time-major softmax at the (N, T)
    labels."""
    return _cross_entropy(torch, probs, label.t().reshape(-1))


def _lm_batches(torch, n, seed):
    """``n`` seeded (tokens, labels) pairs of shape (batch, seq), as float
    ids on the card."""
    import numpy as np
    rs = np.random.RandomState(seed)
    dev = torch.device("cuda", 0)
    shape = (LM_BATCH, LM_SEQ)
    return [tuple(torch.from_numpy(rs.randint(0, LM_VOCAB, shape)
                                   .astype(np.float32)).to(dev)
                  for _ in range(2)) for _ in range(n)]


def make_lm_trainer(torch, mx, seed, compute_dtype=None):
    """The LM with bench.py's _lstm_bench trainer settings (sgd lr 0.1,
    momentum 0.9, wd 0, rescale_grad 1/batch, Xavier()) on gpu(0)."""
    mx.random.seed(seed)
    tr = mx.parallel.SPMDTrainer(
        lm_symbol(mx), "sgd", {"learning_rate": 0.1, "momentum": 0.9,
                               "wd": 0.0, "rescale_grad": 1.0 / LM_BATCH},
        mesh=None, compute_dtype=compute_dtype, ctx=mx.gpu(0))
    shape = (LM_BATCH, LM_SEQ)
    tr.bind([("data", shape)], [("softmax_label", shape)])
    tr.init_params(mx.initializer.Xavier())
    return tr


#: the LSTM kernels' launch counters (kernels/lstm_cell.py): the cell's
#: forward and backward, the persistent recurrence's forward and backward,
#: and the persistent forwards that wrote gate residuals
LSTM_COUNTERS = ("LAUNCHES", "BWD_LAUNCHES", "SEQ_LAUNCHES",
                 "SEQ_BWD_LAUNCHES", "SEQ_GATES_WRITTEN")


def zero_lstm_counts(lc):
    for name in LSTM_COUNTERS:
        setattr(lc, name, 0)


def lstm_counts(lc):
    """``{"cell": (fwd, bwd), "seq": (fwd, bwd), "gates": n}`` since the
    counters were last zeroed."""
    return {"cell": (lc.LAUNCHES, lc.BWD_LAUNCHES),
            "seq": (lc.SEQ_LAUNCHES, lc.SEQ_BWD_LAUNCHES),
            "gates": lc.SEQ_GATES_WRITTEN}


def _lm_steps(torch, mx, tr, plan):
    """The main path: ``tr.step`` over ``plan`` with the LSTM kernel
    counts zeroed just before and read just after; per-step losses and
    host stamps."""
    lc = mx.kernels.lstm_cell
    zero_lstm_counts(lc)
    stamps, losses = [], []
    for x, y in plan:
        stamps.append(time.perf_counter())
        losses.append(_lm_cross_entropy(torch, tr.step(x, y)[0], y))
    torch.cuda.synchronize()
    stamps.append(time.perf_counter())
    skipped = tr.skipped_steps
    return lstm_counts(lc), stamps, losses, skipped


def _check_lm_counts(counts, steps, route, what):
    """A training run of ``steps`` fused-RNN steps on ``route``: one
    persistent forward (with residuals) and backward a layer a step and no
    cell launch, or LM_PER_PASS cell launches each way and no persistent
    one."""
    n = LM_LAYERS * steps
    want = ({"cell": (0, 0), "seq": (n, n), "gates": n}
            if route == "persistent" else
            {"cell": (LM_PER_PASS * steps,) * 2, "seq": (0, 0), "gates": 0})
    check(counts == want, "%s: LSTM launches %s over %d steps, expected %s"
          % (what, counts, steps, want))


def _route_turns(torch, mx, tr, plan, what, card):
    """The LM training step on both routes of the recurrence in turns
    (persistent, per_step, per_step, persistent), ``plan`` each turn;
    steady host-clock ms per step of each turn."""
    lc = mx.kernels.lstm_cell
    turns = []
    try:
        for route in ("persistent", "per_step", "per_step", "persistent"):
            lc.SEQ_ROUTE = route
            counts, stamps, losses, skipped = _lm_steps(torch, mx, tr, plan)
            _check_lm_counts(counts, len(plan), route, "%s turn %s"
                             % (what, route))
            check(skipped == 0 and all(
                bool(torch.isfinite(v)) for v in losses),
                "%s turn %s: a skipped step or a non-finite loss"
                % (what, route))
            turns.append((route, (stamps[-1] - stamps[2])
                          / (len(plan) - 2) * 1e3))
    finally:
        lc.SEQ_ROUTE = None
    per = {r: [ms for q, ms in turns if q == r]
           for r in ("persistent", "per_step")}
    mean = {r: sum(v) / len(v) for r, v in per.items()}
    log("lm training %s, routes in turns (%d steps each, steady ms/step): "
        "%s; persistent %.2f vs per_step %.2f ms/step mean, %.1f%% lower, "
        "on %s" % (what, len(plan), ", ".join(
            "%s %.2f" % t for t in turns), mean["persistent"],
            mean["per_step"], 100 * (1 - mean["persistent"]
                                     / mean["per_step"]), card))
    return turns


def phase_lm_training(torch, mx, seed, card):
    import numpy as np
    tr = make_lm_trainer(torch, mx, seed)
    batches = _lm_batches(torch, LM_TRAIN_STEPS, seed + 20)
    fixed = batches[0]
    params0 = {k: v.clone() for k, v in tr.params.items()}
    ce_before = _lm_cross_entropy(torch, tr.forward_only(*fixed)[0],
                                  fixed[1])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    plan = batches + [fixed] * LM_FIXED_STEPS
    n = len(plan)
    counts, stamps, losses, skipped = _lm_steps(torch, mx, tr, plan)
    peak = torch.cuda.max_memory_allocated()
    ce_after = float(_lm_cross_entropy(torch, tr.forward_only(*fixed)[0],
                                       fixed[1]))
    losses = [float(v) for v in torch.stack(losses).cpu()]
    ce_before = float(ce_before)
    log("lm training: LSTM launches over %d steps: persistent forward %d, "
        "backward %d, gate residuals %d (expected %d each), lstm_cell %s "
        "(expected none)" % (n, counts["seq"][0], counts["seq"][1],
                             counts["gates"], LM_LAYERS * n, counts["cell"]))
    _check_lm_counts(counts, n, "persistent", "lm training")
    log("lm training: per-step loss %s" % " ".join("%.4f" % v
                                                   for v in losses))
    check(all(np.isfinite(losses)), "non-finite LM training loss")
    log("lm training: cross-entropy on the fixed batch %.4f before, %.4f "
        "after %d steps on it" % (ce_before, ce_after, LM_FIXED_STEPS))
    check(np.isfinite(ce_after) and ce_after < ce_before,
          "the LM's fixed-batch cross-entropy did not fall")
    check(skipped == 0, "%d guard-skipped LM steps" % skipped)
    moved = sorted(k for k, v in tr.params.items()
                   if not torch.equal(v, params0[k]))
    log("lm training: %d of %d params changed (%s)" % (
        len(moved), len(params0), ", ".join(moved)))
    check(len(moved) == len(params0), "LM params did not all change")
    tokens = LM_BATCH * LM_SEQ
    steady_s = (stamps[-1] - stamps[2]) / (n - 2)
    log("lm training float32: first step %.1f ms, steady %.2f ms/step at "
        "batch %d x %d tokens -> %.0f tokens/s, peak memory %.3f GiB "
        "(max_memory_allocated) on %s" % (
            (stamps[1] - stamps[0]) * 1e3, steady_s * 1e3, LM_BATCH, LM_SEQ,
            tokens / steady_s, peak / 2 ** 30, card))

    # the bench's own configuration: compute_dtype bfloat16 (token ids
    # are rounded to bfloat16 on the way in, as in the JAX package)
    tr16 = make_lm_trainer(torch, mx, seed, compute_dtype="bfloat16")
    plan16 = _lm_batches(torch, LM_BF16_STEPS, seed + 21)
    counts16, stamps16, losses16, skipped16 = _lm_steps(
        torch, mx, tr16, plan16)
    losses16 = [float(v) for v in torch.stack(losses16).cpu()]
    n16 = len(plan16)
    _check_lm_counts(counts16, n16, "persistent", "bf16 lm training")
    check(all(np.isfinite(losses16)) and skipped16 == 0,
          "bf16 LM loss not finite or steps skipped")
    steady16 = (stamps16[-1] - stamps16[2]) / (n16 - 2)
    log("lm training bfloat16 (the bench's compute_dtype): %d steps, "
        "persistent launches %d / %d, loss %s, steady %.2f ms/step -> %.0f "
        "tokens/s on %s" % (n16, counts16["seq"][0], counts16["seq"][1],
                            " ".join("%.3f" % v for v in losses16),
                            steady16 * 1e3, tokens / steady16, card))
    # the step time of both routes of the recurrence, in turns
    turn_plan = _lm_batches(torch, LM_TURN_STEPS, seed + 22)
    _route_turns(torch, mx, tr, turn_plan, "float32", card)
    _route_turns(torch, mx, tr16, turn_plan, "bfloat16", card)
    tr16.close()
    return tr, batches, counts["seq"][0] + counts16["seq"][0], \
        counts["seq"][1] + counts16["seq"][1]


def lm_stack(mx, fused):
    """example/rnn/lstm_bucketing.py's stack: ``FusedRNNCell(mode='lstm')``
    (``--fused 1``) or a SequentialRNNCell of LSTMCells (``--fused 0``,
    its default)."""
    if fused:
        return mx.rnn.FusedRNNCell(LM_HIDDEN, num_layers=LM_LAYERS,
                                   mode="lstm", prefix="lstm_")
    stack = mx.rnn.SequentialRNNCell()
    for i in range(LM_LAYERS):
        stack.add(mx.rnn.LSTMCell(num_hidden=LM_HIDDEN,
                                  prefix="lstm_l%d_" % i))
    return stack


def route_b_symbol(mx):
    """The example's default sym_gen (example/rnn/lstm_bucketing.py,
    ``--fused 0``): a SequentialRNNCell of LSTMCells, unrolled."""
    return _lm_head(mx, lm_stack(mx, False), LM_SEQ)


def _lm_head(mx, cell, seq):
    """Embedding -> ``cell`` unrolled over ``seq`` steps with merged
    outputs -> Reshape -> FullyConnected -> SoftmaxOutput."""
    data = mx.sym.Variable("data")
    label = mx.sym.Variable("softmax_label")
    embed = mx.sym.Embedding(data=data, input_dim=LM_VOCAB,
                             output_dim=LM_EMBED, name="embed")
    cell.reset()
    outputs, _ = cell.unroll(seq, inputs=embed, merge_outputs=True)
    pred = mx.sym.Reshape(outputs, shape=(-1, LM_HIDDEN))
    pred = mx.sym.FullyConnected(data=pred, num_hidden=LM_VOCAB, name="pred")
    label = mx.sym.Reshape(label, shape=(-1,))
    return mx.sym.SoftmaxOutput(data=pred, label=label, name="softmax")


def _route_step(mx, symbol, weights, x, y):
    ex = symbol.simple_bind(mx.gpu(0), grad_req="write", data=x.shape,
                            softmax_label=y.shape)
    for n, v in weights.items():
        ex.arg_dict[n][:] = v
    ex.forward(is_train=True, data=x, softmax_label=y)
    ex.backward()
    return ex


def phase_route_b(torch, mx, seed):
    """Route B (unrolled LSTMCells emitting _FusedLSTMCell) at batch 32 on
    the card: launches, and agreement with the FusedRNNCell graph given
    the same weights through pack_weights."""
    import numpy as np
    lc = mx.kernels.lstm_cell
    sym_b = route_b_symbol(mx)
    shape = (LM_BATCH, LM_SEQ)
    arg_shapes, _, _ = sym_b.infer_shape(data=shape, softmax_label=shape)
    rs = np.random.RandomState(seed + 30)
    w_b = {n: rs.uniform(-0.1, 0.1, s).astype(np.float32)
           for n, s in zip(sym_b.list_arguments(), arg_shapes)
           if n not in ("data", "softmax_label")}
    x = rs.randint(0, LM_VOCAB, shape).astype(np.float32)
    y = rs.randint(0, LM_VOCAB, shape).astype(np.float32)

    # -- the main path: counts zeroed just before, read just after ---------
    zero_lstm_counts(lc)
    ex_b = _route_step(mx, sym_b, w_b, x, y)
    out_b = ex_b.outputs[0].asnumpy()
    counts = lstm_counts(lc)
    # ----------------------------------------------------------------------
    launched = counts["cell"]
    log("route B (unrolled LSTMCells -> _FusedLSTMCell): one forward/"
        "backward at batch %d launched %d forward and %d backward lstm_cell "
        "kernels (expected %d each) and %s persistent ones (expected none)"
        % (LM_BATCH, launched[0], launched[1], LM_PER_PASS, counts["seq"]))
    check(counts == {"cell": (LM_PER_PASS, LM_PER_PASS), "seq": (0, 0),
                     "gates": 0},
          "route B launched %s LSTM kernels" % (counts,))

    fused = lm_stack(mx, True)
    sym_a = _lm_head(mx, fused, LM_SEQ)
    cpu = mx.cpu()
    cells = {k: mx.nd.array(v, ctx=cpu) for k, v in w_b.items()
             if k.startswith("lstm_")}
    packed = fused.pack_weights(fused.unfuse().unpack_weights(cells))
    w_a = {k: v for k, v in w_b.items() if not k.startswith("lstm_")}
    w_a["lstm_parameters"] = packed["lstm_parameters"].asnumpy()
    ex_a = _route_step(mx, sym_a, w_a, x, y)
    ref = {"output": ex_a.outputs[0].asnumpy()}
    grads_a = {n: mx.nd.array(g.asnumpy(), ctx=cpu)
               for n, g in ex_a.grad_dict.items()}
    per_cell = fused.unfuse().pack_weights(fused.unpack_weights(
        {"lstm_parameters": grads_a["lstm_parameters"]}))
    got = {"output": out_b}
    for k in w_b:
        got[k] = ex_b.grad_dict[k].asnumpy()
        ref[k] = (per_cell[k] if k.startswith("lstm_")
                  else grads_a[k]).asnumpy()
    ratio, key = _worst_max_rel(np, got, ref, list(ref))
    log("route B vs the FusedRNNCell graph (fused RNN op, pack_weights): "
        "output and %d gradients, worst %s max |diff| / max |ref| %.3g "
        "(bound 1e-4)" % (len(ref) - 1, key, ratio))
    check(ratio <= 1e-4, "route B disagrees with the fused RNN op")
    return launched


def _lm_weights(symbol, batch, seed):
    """Seeded numpy weights of the LM (uniform, about Xavier's scale);
    the init states small and non-zero."""
    import numpy as np
    rs = np.random.RandomState(seed)
    shape = (batch, LM_SEQ)
    arg_shapes, _, _ = symbol.infer_shape(data=shape, softmax_label=shape)
    out = {}
    for n, s in zip(symbol.list_arguments(), arg_shapes):
        if n in ("data", "softmax_label"):
            continue
        scale = 0.1 if n.endswith(("_weight", "_parameters")) else 0.05
        out[n] = rs.uniform(-scale, scale, s).astype(np.float32)
    return out, {}


def phase_lm_agreement(torch, mx, seed):
    """One batch-4 LM forward/backward on the card, fused (one persistent
    forward and backward a layer) and with MXTPU_FUSED_KERNELS=0 (no LSTM
    kernel), against the port's CPU path: the output and
    every gradient within AGREE_REL_TOL x max |cpu|; both also against a
    float64 CPU run, to say which path is off if the bound is missed."""
    import numpy as np
    lc = mx.kernels.lstm_cell
    symbol = lm_symbol(mx)
    weights = _lm_weights(symbol, LM_AGREE_BATCH, seed + 40)
    rs = np.random.RandomState(seed + 41)
    shape = (LM_AGREE_BATCH, LM_SEQ)
    x = rs.randint(0, LM_VOCAB, shape).astype(np.float32)
    y = rs.randint(0, LM_VOCAB, shape).astype(np.float32)
    ref = _executor_step(mx, symbol, weights, x, y, mx.cpu())
    exact = _executor_step(mx, symbol, weights, x.astype(np.float64),
                           y.astype(np.float64), mx.cpu())
    c_ratio, c_key = _worst_max_rel(np, ref, exact, list(ref))
    results = {}
    for fused in ("1", "0"):
        zero_lstm_counts(lc)
        old = os.environ.get("MXTPU_FUSED_KERNELS")  # mxlint: disable=env-direct-read (saved to restore)
        os.environ["MXTPU_FUSED_KERNELS"] = fused
        try:
            got = _executor_step(mx, symbol, weights, x, y, mx.gpu(0))
        finally:
            if old is None:
                del os.environ["MXTPU_FUSED_KERNELS"]
            else:
                os.environ["MXTPU_FUSED_KERNELS"] = old
        launched = lstm_counts(lc)
        n = LM_LAYERS if fused == "1" else 0
        want = {"cell": (0, 0), "seq": (n, n), "gates": n}
        check(launched == want, "LM agreement MXTPU_FUSED_KERNELS=%s "
              "launched %s LSTM kernels, not %s" % (fused, launched, want))
        for k, r in ref.items():
            check(got[k].shape == r.shape and np.isfinite(got[k]).all(),
                  "LM agreement: %s shape %s / not finite" % (k,
                                                              got[k].shape))
        ratio, key = _worst_max_rel(np, got, ref, list(ref))
        e_ratio, e_key = _worst_max_rel(np, got, exact, list(ref))
        results[fused] = ratio
        log("lm agreement gpu %s vs cpu: output and %d gradients, worst %s "
            "max |diff| / max |cpu| %.3g (bound %g); against float64: gpu "
            "worst %s %.3g, cpu float32 worst %s %.3g" % (
                "fused" if fused == "1" else "MXTPU_FUSED_KERNELS=0",
                len(ref) - 1, key, ratio, AGREE_REL_TOL, e_key, e_ratio,
                c_key, c_ratio))
        check(ratio <= AGREE_REL_TOL, "LM gpu (MXTPU_FUSED_KERNELS=%s) "
              "disagrees with the CPU path (%s %.3g); float64 says gpu %.3g, "
              "cpu %.3g" % (fused, key, ratio, e_ratio, c_ratio))
    return results


def phase_lm_serving(torch, mx, tr, seed, card):
    """Serve the trained LM through Predictor from a checkpoint at batch
    32: exactly one persistent forward launch a layer per forward, which
    writes no gate residuals, and no backward or cell launch; finite
    probabilities; tokens/s."""
    import numpy as np
    lc = mx.kernels.lstm_cell
    args, aux = tr.get_params()
    build_dir = os.path.join(ROOT, "mxnet_tpu_torch", "_build")
    os.makedirs(build_dir, exist_ok=True)
    ckpt_dir = tempfile.mkdtemp(prefix="smoke-lm-", dir=build_dir)
    try:
        prefix = os.path.join(ckpt_dir, "lstm_lm")
        mx.model.save_checkpoint(prefix, 0, tr.symbol, args, aux)
        net, arg_params, aux_params = mx.model.load_checkpoint(prefix, 0)
    finally:
        shutil.rmtree(ckpt_dir)
    shape = (LM_BATCH, LM_SEQ)
    pred = mx.predict.Predictor(net, _with_prefixes(arg_params, aux_params),
                                {"data": shape, "softmax_label": shape},
                                ctx=mx.gpu(0))
    rs = np.random.RandomState(seed + 50)
    requests = [rs.randint(0, LM_VOCAB, shape).astype(np.float32)
                for _ in range(LM_FORWARDS)]
    labels = np.zeros(shape, np.float32)

    # -- the main path: counts zeroed just before, read just after ---------
    zero_lstm_counts(lc)
    times, outs = [], []
    for x in requests:
        t0 = time.perf_counter()
        outs.append(pred.forward(data=x, softmax_label=labels)
                    .get_output(0))
        times.append(time.perf_counter() - t0)
    counts = lstm_counts(lc)
    # ----------------------------------------------------------------------
    log("lm serving: LSTM launches over %d Predictor forwards: persistent "
        "%s (expected %d forward, no backward), gate residuals written %d, "
        "lstm_cell %s" % (LM_FORWARDS, counts["seq"],
                          LM_LAYERS * LM_FORWARDS, counts["gates"],
                          counts["cell"]))
    check(counts == {"cell": (0, 0), "seq": (LM_LAYERS * LM_FORWARDS, 0),
                     "gates": 0}, "lm serving launches %s" % (counts,))
    for out in outs:
        check(out.shape == (LM_SEQ * LM_BATCH, LM_VOCAB)
              and np.isfinite(out).all(), "lm serving output bad")
        check(np.allclose(out.sum(1), 1.0, atol=1e-4),
              "lm serving softmax rows do not sum to 1")
    steady = times[1:]
    log("lm serving: first forward %.1f ms, steady %.2f ms/forward at "
        "batch %d x %d tokens -> %.0f tokens/s (get_output copies the "
        "%s probabilities to the host) on %s" % (
            times[0] * 1e3, 1e3 * sum(steady) / len(steady), LM_BATCH,
            LM_SEQ, LM_BATCH * LM_SEQ * len(steady) / sum(steady),
            outs[0].shape, card))
    return counts["seq"][0]


def resnet_paths(torch, mx, seed, card):
    """Phases 2-7: the bn_act kernels, ResNet-50 serving and training.
    Returns the bn_act entries of the kernels line."""
    symbol = mx.models.get_symbol("resnet-50", num_classes=1000,
                                  image_shape=IMAGE)
    serving, training = bn_act_sites(mx, symbol, (BATCH,) + IMAGE)
    serving_counts = collections.Counter(serving)
    training_counts = collections.Counter(training)
    check(set(serving_counts) == SERVING_SHAPES_B32,
          "bn_act serving site shapes %s" % sorted(serving_counts))
    check(set(training_counts) == TRAINING_SHAPES_B32 and len(training) == 50,
          "bn_act training site shapes %s" % sorted(training_counts))
    per_shape, max_err = phase_kernels(torch, mx, serving_counts,
                                       training_counts, seed)
    launches, net, params = phase_serving(torch, mx, seed, card)
    phase_profile(torch, mx, net, params, card)
    tr, batches, train_fwd, train_bwd = phase_training(
        torch, mx, seed, card, len(training))
    phase_train_agreement(torch, mx, seed)
    phase_train_profile(torch, mx, tr, batches, card)
    tr.close()

    def total(counts, key):
        return sum(per_shape[s][key] * n for s, n in counts.items())
    log("bn_act float32 relu per serving forward (%d launches): kernel %.4f "
        "plain %.4f library %.4f bound %.4f ms" % (
            len(serving), total(serving_counts, "f32_ms"),
            total(serving_counts, "f32_plain_ms"),
            total(serving_counts, "f32_library_ms"),
            total(serving_counts, "f32_bound_ms")))
    for d in ("", "bwd_"):
        log("bn_act %s float32 relu per training step (%d launches): "
            "kernel %.4f plain %.4f library %.4f bound %.4f ms" % (
                "backward" if d else "forward", len(training),
                total(training_counts, "f32_%sms" % d),
                total(training_counts, "f32_%splain_ms" % d),
                total(training_counts, "f32_%slibrary_ms" % d),
                total(training_counts, "f32_%sbound_ms" % d)))
    # times: the float32 relu launches of one batch-32 training step
    return [{
        "name": "bn_act_fwd",
        "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/bn_act.cu",
        "replaces": "mxnet_tpu/kernels/bn_act.py:109",
        "launches": launches + train_fwd,
        "max_abs_err": max_err["fwd"],
        "ms": total(training_counts, "f32_ms"),
        "plain_ms": total(training_counts, "f32_plain_ms"),
        "bound_ms": total(training_counts, "f32_bound_ms"),
        "bound_by": "bytes",
        "library_ms": total(training_counts, "f32_library_ms"),
    }, {
        "name": "bn_act_bwd",
        "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/bn_act.cu",
        "replaces": "mxnet_tpu/kernels/bn_act.py:113",
        "launches": train_bwd,
        "max_abs_err": max_err["bwd"],
        "ms": total(training_counts, "f32_bwd_ms"),
        "plain_ms": total(training_counts, "f32_bwd_plain_ms"),
        "bound_ms": total(training_counts, "f32_bwd_bound_ms"),
        "bound_by": "bytes",
        "library_ms": total(training_counts, "f32_bwd_library_ms"),
    }]


def lm_paths(torch, mx, seed, card):
    """Phases 8-12: the lstm_cell and lstm_seq kernels, the LSTM language
    model's training (both routes of the fused RNN op, and route B),
    agreement, serving and profiles.  Returns the lstm_cell and lstm_seq
    entries of the kernels line."""
    lstm_rows, lstm_err = phase_lstm_kernels(torch, mx, seed)
    seq_times, seq_err = phase_lstm_seq_kernels(torch, mx, seed, card)
    lm_tr, lm_batches, lm_fwd, lm_bwd = phase_lm_training(torch, mx, seed,
                                                          card)
    route_b = phase_route_b(torch, mx, seed)
    phase_lm_agreement(torch, mx, seed)
    lm_serve = phase_lm_serving(torch, mx, lm_tr, seed, card)
    lc = mx.kernels.lstm_cell
    unit = "batch %d x %d tokens" % (LM_BATCH, LM_SEQ)
    phase_train_profile(torch, mx, lm_tr, lm_batches, card,
                        what="lm train (persistent)",
                        need=("lstm_seq_fwd", "lstm_seq_bwd"), unit=unit)
    try:
        lc.SEQ_ROUTE = "per_step"
        phase_train_profile(torch, mx, lm_tr, lm_batches, card,
                            what="lm train (per_step)",
                            need=("lstm_cell_fwd", "lstm_cell_bwd"),
                            unit=unit)
    finally:
        lc.SEQ_ROUTE = None
    # lstm_cell times: float32 at the bench's (32, 200), summed over the 64
    # launches of one route-B pass, its main path since this slice
    bench = lstm_rows[(LM_BATCH, LM_HIDDEN)]
    kernels = []
    for name, key, launched, line in (
            ("lstm_cell_fwd", "", route_b[0], 57),
            ("lstm_cell_bwd", "bwd_", route_b[1], 70)):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/lstm_cell.cu",
            "replaces": "mxnet_tpu/kernels/lstm_cell.py:%d" % line,
            "launches": launched,
            "max_abs_err": lstm_err["fwd" if not key else "bwd"],
            "ms": LM_PER_PASS * bench["f32_%sms" % key],
            "plain_ms": LM_PER_PASS * bench["f32_%splain_ms" % key],
            "bound_ms": LM_PER_PASS * bench["f32_%sbound_ms" % key],
            "bound_by": "bytes",
            "library_ms": LM_PER_PASS * bench["f32_%slibrary_ms" % key],
        })
    fwd, bwd = kernels
    log("lstm_cell float32 per route-B pass (%d launches each at (%d, "
        "%d)): forward kernel %.4f plain %.4f library %.4f bound %.4f ms; "
        "backward kernel %.4f plain %.4f library %.4f bound %.4f ms" % (
            LM_PER_PASS, LM_BATCH, LM_HIDDEN, fwd["ms"], fwd["plain_ms"],
            fwd["library_ms"], fwd["bound_ms"], bwd["ms"], bwd["plain_ms"],
            bwd["library_ms"], bwd["bound_ms"]))
    # lstm_seq times: float32, one launch a layer of one LM training step;
    # the library is cuDNN's one-layer LSTM (forward, and forward +
    # backward less forward), which also computes the input projection
    t = seq_times["f32"]
    for name, key, launched, line in (
            ("lstm_seq_fwd", "fwd", lm_fwd + lm_serve, 57),
            ("lstm_seq_bwd", "bwd", lm_bwd, 70)):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/lstm_cell.cu",
            "replaces": "mxnet_tpu/kernels/lstm_cell.py:%d" % line,
            "launches": launched,
            "max_abs_err": seq_err[key],
            "ms": LM_LAYERS * t[key],
            "plain_ms": LM_LAYERS * t[key + "_plain"],
            "bound_ms": LM_LAYERS * t[key + "_bound"],
            "bound_by": t[key + "_bound_by"],
            "library_ms": LM_LAYERS * t["cudnn_" + key],
        })
    log("lstm_seq float32 per LM training step (%d launches each at (T, "
        "N, H) = (%d, %d, %d)): forward kernel %.4f plain %.4f cuDNN %.4f "
        "bound %.4f ms; backward kernel %.4f plain %.4f cuDNN %.4f bound "
        "%.4f ms" % ((LM_LAYERS, LM_SEQ, LM_BATCH, LM_HIDDEN)
                     + tuple(kernels[i][k] for i in (2, 3) for k in (
                         "ms", "plain_ms", "library_ms", "bound_ms"))))
    return kernels


# ---------------------------------------------------------------------------
# the long-context causal LM: the flash-attention kernel, training at seq
# 512 and 4096, serving, the symbolic Attention op
# ---------------------------------------------------------------------------

def flash_work(B, Tq, Tk, H, D, causal, itemsize, roofline):
    """``(flops, bytes, full_flops, pairs)`` of one flash-attention call,
    with the ported roofline's coefficients (``roofline.workload``, per
    score and per position): flops over the (query, key) pairs the mask
    lets through, bytes for q, k, v read once and the output written
    once; ``full_flops`` is the reference's count over the whole Tq x Tk
    square; ``pairs`` the visible pairs, one exponential each."""
    unit = roofline.workload("flash_attention", itemsize=itemsize, b=B, t=1,
                             heads=H, d=D)
    if causal:
        off = Tk - Tq
        pairs = sum(min(max(i + off + 1, 0), Tk) for i in range(Tq))
    else:
        pairs = Tq * Tk
    flops = unit["flops"] * pairs
    nbytes = unit["fused_bytes"] // 4 * (2 * Tq + 2 * Tk)
    return flops, nbytes, unit["flops"] * Tq * Tk, B * H * pairs


def exp2_per_s(torch):
    """The card's exponential rate: EXP2_PER_CLOCK_PER_SM x its SM count
    (``torch.cuda.get_device_properties``) x its largest SM clock
    (``nvidia-smi --query-gpu=clocks.max.sm``)."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, "nvidia-smi clocks failed: %s" % smi.stderr)
    mhz = float(smi.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return EXP2_PER_CLOCK_PER_SM * sms * mhz * 1e6, sms, mhz


def flash_bound_ms(work, dtype_tag, exp_rate):
    """``(bound ms, "operations" or "bytes", the side that binds)``: the
    largest of the products at the data-sheet rate (float32 FFMA for
    float32, bf16 tensor cores for bfloat16), one exponential per visible
    pair at ``exp_rate``, and the bytes at the HBM rate."""
    flops, nbytes, _, pairs = work
    peak = F32_FLOPS_PER_S if dtype_tag == "f32" else BF16_FLOPS_PER_S
    sides = {"products": flops / peak, "exp": pairs / exp_rate,
             "bytes": nbytes / HBM_BYTES_PER_S}
    side = max(sides, key=sides.get)
    return (sides[side] * 1e3, "bytes" if side == "bytes" else "operations",
            side)


def _flash_check(torch, got, ref, tag, what):
    """The kernel's output against the plain version's: float32 within
    FLASH_F32_TOL absolute, bfloat16 within BF16_REL_TOL of max|plain|.
    Returns the max abs error."""
    check(got.shape == ref.shape and got.dtype == ref.dtype,
          "flash %s %s: shape/dtype differ" % (what, tag))
    err = (got.float() - ref.float()).abs().max().item()
    if tag == "f32":
        check(err <= FLASH_F32_TOL, "flash f32 %s: max abs err %.3g > %g"
              % (what, err, FLASH_F32_TOL))
    else:
        rel = err / max(ref.float().abs().max().item(), 1e-30)
        check(rel <= BF16_REL_TOL, "flash bf16 %s: rel err %.3g > %g"
              % (what, rel, BF16_REL_TOL))
    return err


def phase_flash_kernels(torch, mx, seed):
    """The flash-attention kernel against its plain version at
    FLASH_SHAPES, float32 and bfloat16, from strided q/k/v views (as the
    model's split gives them), on the route ``flash_route`` picks (every
    D <= 128 on a tiled route) and on the rowwise route (the first
    kernel); rows that see no key exactly 0; a misaligned view, copied by
    the wrapper.  Times of both kernels, the plain version (key block
    MXTPU_FLASH_BLOCK), SDPA (a yardstick the port never calls, at Tq ==
    Tk only: its causal mask is top-left aligned) and the bound with its
    binding side, per launch."""
    fa = mx.kernels.flash_attention
    roofline = mx.kernels.roofline
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 60)
    exp_rate, sms, mhz = exp2_per_s(torch)
    log("flash bound: exponentials at %d/clock/SM x %d SMs x %.0f MHz = "
        "%.4g/s" % (EXP2_PER_CLOCK_PER_SM, sms, mhz, exp_rate))
    rows = {}
    max_err = 0.0
    for shape in FLASH_SHAPES:
        B, Tq, Tk, H, D, causal = shape
        qsrc = torch.randn((B, Tq, 3, H, D), generator=gen, device=dev)
        ksrc = torch.randn((B, Tk, 3, H, D), generator=gen, device=dev)
        row = {}
        for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            qs, ks = qsrc.to(dtype), ksrc.to(dtype)
            q, k, v = qs[:, :, 0], ks[:, :, 1], ks[:, :, 2]
            route = fa.flash_route(dtype, D)
            check(D > fa.TILED_MAX_HEAD_DIM or route != "rowwise",
                  "flash %s %s: D %d took the rowwise route" % (shape, tag,
                                                                D))
            before = dict(fa.ROUTE_LAUNCHES)
            got = fa.flash_attention_fwd(q, k, v, causal=causal)
            old = fa.flash_attention_fwd(q, k, v, causal=causal,
                                         route="rowwise")
            ref = fa.flash_attention_plain(q, k, v, causal=causal)
            torch.cuda.synchronize()
            moved = {r: fa.ROUTE_LAUNCHES[r] - before[r] for r in fa.ROUTES}
            want = {r: 0 for r in fa.ROUTES}
            want[route] += 1
            want["rowwise"] += 1
            check(moved == want, "flash %s %s: route launches %s, expected "
                  "%s" % (shape, tag, moved, want))
            err = _flash_check(torch, got, ref, tag, shape)
            row[tag + "_rowwise_err"] = _flash_check(torch, old, ref, tag,
                                                     shape)
            if tag == "f32":
                max_err = max(max_err, err, row["f32_rowwise_err"])
            dead = Tq - Tk if causal and Tq > Tk else 0
            if dead:
                check(bool((got[:, :dead] == 0).all())
                      and bool((old[:, :dead] == 0).all())
                      and bool(torch.isfinite(got).all()),
                      "flash %s %s: rows that see no key are not 0"
                      % (shape, tag))
            row[tag + "_route"] = route
            row[tag + "_err"] = err
            row[tag + "_ms"] = device_ms(
                torch, lambda: fa.flash_attention_fwd(q, k, v, causal=causal))
            row[tag + "_rowwise_ms"] = device_ms(
                torch, lambda: fa.flash_attention_fwd(q, k, v, causal=causal,
                                                      route="rowwise"))
            row[tag + "_plain_ms"] = device_ms(
                torch, lambda: fa.flash_attention_plain(q, k, v,
                                                        causal=causal),
                iters=5, reps=2)
            work = flash_work(B, Tq, Tk, H, D, causal, q.element_size(),
                              roofline)
            (row[tag + "_bound_ms"], row[tag + "_bound_by"],
             row[tag + "_bound_side"]) = flash_bound_ms(work, tag, exp_rate)
            row[tag + "_library_ms"] = None
            if Tq == Tk:
                qt, kt, vt = (t.transpose(1, 2).contiguous()
                              for t in (q, k, v))
                sdpa = torch.nn.functional.scaled_dot_product_attention
                lib = sdpa(qt, kt, vt, is_causal=causal).transpose(1, 2)
                row[tag + "_library_err"] = (
                    lib.float() - ref.float()).abs().max().item()
                row[tag + "_library_ms"] = device_ms(
                    torch, lambda: sdpa(qt, kt, vt, is_causal=causal))
        rows[shape] = row
        for tag in ("f32", "bf16"):
            lib = ("%.5f (|diff| %.1e)" % (row[tag + "_library_ms"],
                                           row[tag + "_library_err"])
                   if row[tag + "_library_ms"] is not None else "n/a")
            log("flash_attention (B, Tq, Tk, H, D)=%s causal=%s %-4s | "
                "route %s: err %.2e ms %.5f | rowwise: err %.2e ms %.5f | "
                "plain %.5f | sdpa %s | bound %.5f (%s: %s)" % (
                    str(shape[:5]), causal, tag, row[tag + "_route"],
                    row[tag + "_err"], row[tag + "_ms"],
                    row[tag + "_rowwise_err"], row[tag + "_rowwise_ms"],
                    row[tag + "_plain_ms"], lib, row[tag + "_bound_ms"],
                    row[tag + "_bound_by"], row[tag + "_bound_side"]))
    phase_flash_misaligned(torch, mx, gen)
    log("flash_attention kernel: float32 max abs err %.3g against the plain "
        "version (tiled and rowwise routes); every shape and dtype within "
        "tolerance on both routes, every D <= %d on a tiled route, rows "
        "without a visible key exactly 0" % (max_err,
                                             fa.TILED_MAX_HEAD_DIM))
    return rows, max_err


def phase_flash_misaligned(torch, mx, gen):
    """q, k, v as views one element off a 16-byte boundary (a slice of a
    flat buffer): the wrapper copies each once for the tiled route's
    16-byte loads; the result is held to the same tolerances."""
    fa = mx.kernels.flash_attention
    B, Tq, Tk, H, D, causal = FLASH_MISALIGNED_SHAPE
    n = B * Tq * 3 * H * D
    flat = torch.randn(n + 1, generator=gen, device=gen.device)
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        qkv = flat.to(dtype)[1:].view(B, Tq, 3, H, D)
        q, k, v = qkv[:, :, 0], qkv[:, :Tk, 1], qkv[:, :Tk, 2]
        check(not any(fa.vector_aligned(t) for t in (q, k, v)),
              "flash misaligned %s: the views are aligned" % tag)
        copies = fa.ALIGN_COPIES
        got = fa.flash_attention_fwd(q, k, v, causal=causal)
        ref = fa.flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = _flash_check(torch, got, ref, tag, "misaligned")
        check(fa.ALIGN_COPIES - copies == 3, "flash misaligned %s: %d "
              "alignment copies (expected 3)" % (tag,
                                                fa.ALIGN_COPIES - copies))
        check(bool((got[:, :Tq - Tk] == 0).all()),
              "flash misaligned %s: rows that see no key are not 0" % tag)
        log("flash_attention misaligned views %s %s: 3 alignment copies, "
            "err %.2e" % (FLASH_MISALIGNED_SHAPE[:5], tag, err))


def _zero_flash_counts(fa):
    """Every flash count to 0: launches, launches per route, alignment
    copies."""
    fa.LAUNCHES = 0
    fa.ALIGN_COPIES = 0
    for route in fa.ROUTES:
        fa.ROUTE_LAUNCHES[route] = 0


def _check_flash_route(fa, launches, what):
    """The main path's launches all took the float32 tiled route, and the
    model's strided views needed no alignment copy."""
    log("%s: flash launches by route %s, alignment copies %d" % (
        what, dict(fa.ROUTE_LAUNCHES), fa.ALIGN_COPIES))
    check(fa.ROUTE_LAUNCHES["tiled_f32"] == launches,
          "%s: %d of %d flash launches on the tiled_f32 route" % (
              what, fa.ROUTE_LAUNCHES["tiled_f32"], launches))
    check(fa.ALIGN_COPIES == 0, "%s: %d alignment copies of the model's "
          "views" % (what, fa.ALIGN_COPIES))


def _lc_params(torch, mx, seed, ctx):
    lm = mx.models.long_context_lm
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed + 70)
    return lm.build_params(gen, LC_VOCAB, LC_DMODEL, LC_HEADS, LC_LAYERS,
                           LC_DFF, max_len=LC_MAX_LEN, ctx=ctx)


def _lc_batches(torch, mx, n, seq, seed):
    """``n`` of the example's Markov batches (its successor table drawn
    from ``seed``), as int64 tensors on the card."""
    import numpy as np
    lm = mx.models.long_context_lm
    rs = np.random.RandomState(seed)
    succ = rs.randint(1, LC_VOCAB, size=(LC_VOCAB, 3))
    dev = torch.device("cuda", 0)
    out = []
    for _ in range(n):
        x, y = lm.markov_batch(rs, succ, LC_BATCH, seq, LC_VOCAB)
        out.append((torch.from_numpy(x).long().to(dev),
                    torch.from_numpy(y).long().to(dev)))
    return out


def _lc_train(torch, mx, params, batches, seq, card, what):
    """The main path: ``make_step`` over ``batches`` with the flash count
    zeroed just before and read just after.  Checks 2 launches per step,
    finite losses and a last loss below the first."""
    import numpy as np
    fa = mx.kernels.flash_attention
    step = mx.models.long_context_lm.make_step(None, LC_HEADS, LC_LAYERS,
                                               LC_LR)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # -- the main path: counts zeroed just before, read just after ---------
    _zero_flash_counts(fa)
    stamps, losses = [], []
    for x, y in batches:
        stamps.append(time.perf_counter())
        params, loss = step(params, x, y)
        losses.append(loss)
    torch.cuda.synchronize()
    stamps.append(time.perf_counter())
    launches = fa.LAUNCHES
    # ----------------------------------------------------------------------
    _check_flash_route(fa, launches, what)

    peak = torch.cuda.max_memory_allocated()
    n = len(batches)
    losses = [float(v) for v in torch.stack(losses).cpu()]
    log("%s: flash_attention launches over %d steps: %d (expected %d)"
        % (what, n, launches, LC_LAYERS * n))
    check(launches == LC_LAYERS * n, "%s: flash launches %d != %d"
          % (what, launches, LC_LAYERS * n))
    log("%s: per-step loss %s (uniform %.4f)" % (
        what, " ".join("%.4f" % v for v in losses), np.log(LC_VOCAB)))
    check(all(np.isfinite(losses)), what + ": non-finite loss")
    check(losses[-1] < losses[0], "%s: loss did not fall (%.4f -> %.4f)"
          % (what, losses[0], losses[-1]))
    tokens = LC_BATCH * seq
    steady_s = (stamps[-1] - stamps[1]) / (n - 1)
    log("%s: first step %.1f ms, steady %.2f ms/step at batch %d x %d tokens "
        "-> %.0f tokens/s, peak memory %.3f GiB (max_memory_allocated) on %s"
        % (what, (stamps[1] - stamps[0]) * 1e3, steady_s * 1e3, LC_BATCH, seq,
           tokens / steady_s, peak / 2 ** 30, card))
    return params, launches


def phase_lc_serving(torch, mx, params, seed, card):
    """``apply_model`` under ``torch.inference_mode()`` at seq 4096, batch
    4: 2 flash launches per forward, finite logits; tokens/s."""
    lm = mx.models.long_context_lm
    fa = mx.kernels.flash_attention
    requests = [x for x, _ in _lc_batches(torch, mx, LC_FORWARDS, LC_MAX_LEN,
                                          seed + 80)]
    torch.cuda.synchronize()

    # -- the main path: counts zeroed just before, read just after ---------
    _zero_flash_counts(fa)
    times, outs = [], []
    with torch.inference_mode():
        for x in requests:
            t0 = time.perf_counter()
            outs.append(lm.apply_model(params, x, None, LC_HEADS, LC_LAYERS))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    launches = fa.LAUNCHES
    # ----------------------------------------------------------------------
    _check_flash_route(fa, launches, "lc serving")

    log("lc serving: flash_attention launches over %d forwards: %d "
        "(expected %d)" % (LC_FORWARDS, launches, LC_LAYERS * LC_FORWARDS))
    check(launches == LC_LAYERS * LC_FORWARDS, "lc serving launches %d"
          % launches)
    for out in outs:
        check(tuple(out.shape) == (LC_BATCH, LC_MAX_LEN, LC_VOCAB)
              and bool(torch.isfinite(out).all()), "lc serving logits bad")
    steady = times[1:]
    log("lc serving: first forward %.1f ms, steady %.2f ms/forward at batch "
        "%d x %d tokens -> %.0f tokens/s (logits stay on the card) on %s" % (
            times[0] * 1e3, 1e3 * sum(steady) / len(steady), LC_BATCH,
            LC_MAX_LEN, LC_BATCH * LC_MAX_LEN * len(steady) / sum(steady),
            card))
    return launches


#: forwards through each loaded program of the in-process AOT phases
AOT_FORWARDS = 3
#: aten ops that only a kernel's plain version puts in a stored program:
#: the LSTM cell's activations, the flash loop's (or the exact softmax's)
#: exponentials and row maxima, the rtc silu's exponential
AOT_PLAIN_OPS = {
    "lstm": ("aten.sigmoid.default", "aten.tanh.default"),
    "flash": ("aten.exp.default", "aten.amax.default",
              "aten._softmax.default", "aten.softmax.int"),
    "rtc": ("aten.exp.default", "aten.sigmoid.default")}


def _aot_graph_check(mx, path, want, plain, what):
    """The stored program at ``path`` calls each ``mxt`` op of ``want``
    as many times as it gives, and holds none of the aten ops ``plain``
    (a kernel's plain version inside a program built on the card).
    Returns its ``mxt`` calls and node count."""
    from mxnet_tpu_torch.serving import aot
    with open(path, "rb") as f:
        graph = aot.load_program(f.read()).graph
    ops = collections.Counter(str(n.target) for n in graph.nodes
                              if n.op == "call_function")
    got = {k: ops["mxt.%s.default" % k] for k in want}
    check(got == want, "%s: mxt calls %s, expected %s" % (what, got, want))
    bad = {k: ops[k] for k in plain if ops[k]}
    check(not bad, "%s: a kernel's plain version inside the program: %s"
          % (what, bad))
    return {"mxt": got, "nodes": sum(ops.values()),
            "bytes": os.path.getsize(path)}


def _routes_since(before, now):
    return {k: now[k] - before[k] for k in now if now[k] != before[k]}


def phase_aot_attention(torch, mx, seed, card):
    """``contrib.Attention`` at ATT_SHAPE, causal, through the AOT store
    on gpu(0): ``export_aot([1, 4])`` in one pool, ``load_aot`` in a
    fresh one; each forward through the loaded program launches one
    ``flash_attention_fwd`` (route named) and equals the ``Predictor``
    bit for bit; the stored graph holds the op and no plain version.
    Returns the flash launches of those forwards."""
    import numpy as np
    fa = mx.kernels.flash_attention
    names = ("query", "key", "value")
    sym = mx.sym.contrib.Attention(*(mx.sym.Variable(n) for n in names),
                                   num_heads=ATT_HEADS, causal=True,
                                   name="att")
    shapes = {n: ATT_SHAPE[1:] for n in names}
    batch = ATT_SHAPE[0]
    build_dir = os.path.join(ROOT, "mxnet_tpu_torch", "_build")
    os.makedirs(build_dir, exist_ok=True)
    store = tempfile.mkdtemp(prefix="aot-att-", dir=build_dir)
    rs = np.random.RandomState(seed + 92)
    feed = {n: rs.standard_normal(ATT_SHAPE).astype(np.float32)
            for n in names}
    try:
        t0 = time.perf_counter()
        mx.serving.ModelPool(ctx=mx.gpu(0)).add(
            "att", sym, {}, {}, sample_shapes=shapes).export_aot([1, batch],
                                                                 store)
        export_s = time.perf_counter() - t0
        graph = _aot_graph_check(
            mx, os.path.join(store, "att-b%d.exec" % batch),
            {"flash_attention_fwd": 1}, AOT_PLAIN_OPS["flash"],
            "the attention program")
        entry = mx.serving.ModelPool(ctx=mx.gpu(0)).add(
            "att", sym, {}, {}, sample_shapes=shapes)
        t0 = time.perf_counter()
        loaded = entry.load_aot(store)
        load_s = time.perf_counter() - t0
        check(loaded == 2, "the attention store loaded %d of 2 buckets"
              % loaded)
        ref = mx.predict.Predictor(sym.tojson(), {},
                                   {n: ATT_SHAPE for n in names},
                                   ctx=mx.gpu(0)).forward(**feed).get_output(0)
        # -- the main path: counts zeroed just before, read just after ----
        routes = dict(fa.ROUTE_LAUNCHES)
        fa.LAUNCHES = 0
        got = [entry.forward(feed)[0] for _ in range(AOT_FORWARDS)]
        launches = fa.LAUNCHES
        routes = _routes_since(routes, fa.ROUTE_LAUNCHES)
        # -----------------------------------------------------------------
    finally:
        shutil.rmtree(store, ignore_errors=True)
    check(launches == AOT_FORWARDS and entry._pred is None,
          "the loaded attention program: %d flash launches over %d "
          "forwards (Predictor path used: %s)" % (
              launches, AOT_FORWARDS, entry._pred is not None))
    check(all(np.array_equal(g, ref) for g in got), "the loaded attention "
          "program differs from the Predictor")
    log("aot attention: export_aot([1, %d]) %.1f s (%d bytes, %d nodes, "
        "mxt %s), load_aot %.1f s in a fresh pool; %d forwards at %s through "
        "the loaded program: %d flash launches (routes %s), bit-equal to the "
        "Predictor; on %s" % (
            batch, export_s, graph["bytes"], graph["nodes"],
            json.dumps(graph["mxt"]), load_s, AOT_FORWARDS, ATT_SHAPE,
            launches, json.dumps(routes), card))
    return launches


def phase_aot_rtc(torch, mx, net, module, X, tmp, card):
    """The fine-tune's scoring symbol (its ``rtc_silu`` op, 17 ``bn_act``
    sites) through the AOT store on gpu(0): exported at bucket BATCH with
    the fitted module's params, loaded in a fresh pool; each forward
    through the loaded program launches 1 rtc and 17 ``bn_act_fwd`` and
    equals the ``Predictor`` bit for bit; the stored graph holds those
    ops and no plain version.  Returns the rtc and bn_act launches of
    those forwards."""
    import numpy as np
    args, auxs = module.get_params()
    store = os.path.join(tmp, "aot-ft")
    shapes = {"data": IMAGE}

    def entry_of():
        return mx.serving.ModelPool(ctx=mx.gpu(0)).add(
            "ft", net, args, auxs, sample_shapes=shapes)

    t0 = time.perf_counter()
    entry_of().export_aot([BATCH], store)
    export_s = time.perf_counter() - t0
    graph = _aot_graph_check(
        mx, os.path.join(store, "ft-b%d.exec" % BATCH),
        {"rtc_elementwise": 1, "bn_act_fwd": 17}, AOT_PLAIN_OPS["rtc"],
        "the fine-tune program")
    entry = entry_of()
    t0 = time.perf_counter()
    loaded = entry.load_aot(store)
    load_s = time.perf_counter() - t0
    check(loaded == 1, "the fine-tune store loaded %d of 1 bucket" % loaded)
    x = X[:BATCH]
    ref = mx.predict.Predictor(net, _with_prefixes(args, auxs),
                               {"data": (BATCH,) + IMAGE},
                               ctx=mx.gpu(0)).forward(data=x).get_output(0)
    ba = mx.kernels.bn_act
    # -- the main path: counts zeroed just before, read just after --------
    mx.rtc.LAUNCHES = 0
    ba.LAUNCHES = 0
    got = [entry.forward({"data": x})[0] for _ in range(AOT_FORWARDS)]
    rtc_n, bn_n = mx.rtc.LAUNCHES, ba.LAUNCHES
    # ---------------------------------------------------------------------
    check(rtc_n == AOT_FORWARDS and bn_n == 17 * AOT_FORWARDS
          and entry._pred is None, "the loaded fine-tune program: %d rtc and "
          "%d bn_act launches over %d forwards (Predictor path used: %s)" % (
              rtc_n, bn_n, AOT_FORWARDS, entry._pred is not None))
    check(all(np.array_equal(g, ref) for g in got), "the loaded fine-tune "
          "program differs from the Predictor")
    log("aot rtc: the fine-tune's scoring symbol export_aot([%d]) %.1f s "
        "(%d bytes, %d nodes, mxt %s), load_aot %.1f s in a fresh pool; %d "
        "forwards through the loaded program: %d rtc and %d bn_act launches, "
        "bit-equal to the Predictor; on %s" % (
            BATCH, export_s, graph["bytes"], graph["nodes"],
            json.dumps(graph["mxt"]), load_s, AOT_FORWARDS, rtc_n, bn_n,
            card))
    return rtc_n, bn_n


def phase_attention_op(torch, mx, seed, card):
    """``mx.sym.contrib.Attention`` at ATT_SHAPE, causal, through
    ``simple_bind`` -> ``forward(is_train=True)`` -> ``backward()`` and
    through ``Predictor`` on gpu(0): 1 flash launch per forward (none in
    the backward, which recomputes through the plain version); output and
    q/k/v gradients against the port's CPU path."""
    import numpy as np
    fa = mx.kernels.flash_attention
    names = ("query", "key", "value")
    sym = mx.sym.contrib.Attention(*(mx.sym.Variable(n) for n in names),
                                   num_heads=ATT_HEADS, causal=True,
                                   name="att")
    rs = np.random.RandomState(seed + 90)
    inputs = {n: rs.standard_normal(ATT_SHAPE).astype(np.float32)
              for n in names}
    head = rs.standard_normal(ATT_SHAPE).astype(np.float32)

    def train_pass(ctx):
        ex = sym.simple_bind(ctx, grad_req="write",
                             **{n: ATT_SHAPE for n in names})
        ex.forward(is_train=True, **inputs)
        ex.backward(out_grads=[mx.nd.array(head, ctx=ctx)])
        out = {"output": ex.outputs[0].asnumpy()}
        out.update({"grad:" + n: ex.grad_dict[n].asnumpy() for n in names})
        return out

    ref = train_pass(mx.cpu())

    # -- the main path: counts zeroed just before, read just after ---------
    fa.LAUNCHES = 0
    got = train_pass(mx.gpu(0))
    train_launches = fa.LAUNCHES
    pred = mx.predict.Predictor(sym.tojson(), {},
                                {n: ATT_SHAPE for n in names}, ctx=mx.gpu(0))
    fa.LAUNCHES = 0
    served = [pred.forward(**inputs).get_output(0) for _ in range(3)]
    serve_launches = fa.LAUNCHES
    # ----------------------------------------------------------------------

    log("attention op: flash launches: %d over one simple_bind forward/"
        "backward (expected 1), %d over 3 Predictor forwards (expected 3)"
        % (train_launches, serve_launches))
    check(train_launches == 1 and serve_launches == 3,
          "attention op launches %d / %d" % (train_launches, serve_launches))
    ratio, key = _worst_max_rel(np, got, ref, list(ref))
    log("attention op gpu vs cpu: output and q/k/v gradients, worst %s max "
        "|diff| / max |cpu| %.3g (bound %g)" % (key, ratio, AGREE_REL_TOL))
    check(ratio <= AGREE_REL_TOL, "attention op disagrees with the CPU path")
    for out in served:
        check(np.array_equal(out, served[0]) and np.isfinite(out).all(),
              "Predictor answers differ or are not finite")
    diff = float(np.abs(served[0] - got["output"]).max())
    log("attention op: Predictor vs the executor's forward max |diff| %.3g "
        "on %s" % (diff, card))
    check(diff <= FLASH_F32_TOL, "Predictor disagrees with the executor")
    return train_launches + serve_launches


def _lc_grads(torch, mx, np_params, x, y, ctx):
    """Logits and every parameter gradient of the mean NLL of one batch,
    as float64 numpy keyed by name."""
    lm = mx.models.long_context_lm
    params = lm.params_from_numpy(np_params, ctx)
    names, leaves = [], []
    for key in sorted(params):
        sub = params[key] if isinstance(params[key], dict) else \
            {"": params[key]}
        for k in sorted(sub):
            names.append("grad:" + key + ("/" + k if k else ""))
            leaves.append(sub[k].requires_grad_(True))
    dev = ctx.torch_device
    logits = lm.apply_model(params, torch.from_numpy(x).to(dev), None,
                            LC_HEADS, LC_LAYERS)
    logp = torch.log_softmax(logits, dim=-1)
    loss = -logp.gather(-1, torch.from_numpy(y).long().to(dev)[..., None]) \
        .mean()
    grads = torch.autograd.grad(loss, leaves)
    out = {"logits": logits.detach().double().cpu().numpy()}
    out.update({n: g.double().cpu().numpy() for n, g in zip(names, grads)})
    return out


def phase_lc_agreement(torch, mx, seed):
    """One batch-2, seq-1024 LM forward/backward on the card, fused and
    with MXTPU_FUSED_KERNELS=0 (which must launch no flash kernel),
    against the port's CPU path: logits within AGREE_REL_TOL x max |cpu|,
    the gradients within LC_GRAD_L2_TOL in relative L2 together and
    GRAD_TENSOR_L2_TOL each (see LC_GRAD_L2_TOL)."""
    import numpy as np
    fa = mx.kernels.flash_attention
    lm = mx.models.long_context_lm
    batch, seq = LC_AGREE
    np_params = lm.params_to_numpy(_lc_params(torch, mx, seed, mx.cpu()))
    rs = np.random.RandomState(seed + 100)
    x, y = lm.markov_batch(rs, rs.randint(1, LC_VOCAB, (LC_VOCAB, 3)), batch,
                           seq, LC_VOCAB)
    ref = _lc_grads(torch, mx, np_params, x, y, mx.cpu())
    for fused in ("1", "0"):
        before = fa.LAUNCHES
        old = os.environ.get("MXTPU_FUSED_KERNELS")  # mxlint: disable=env-direct-read (saved to restore)
        os.environ["MXTPU_FUSED_KERNELS"] = fused
        try:
            got = _lc_grads(torch, mx, np_params, x, y, mx.gpu(0))
        finally:
            if old is None:
                del os.environ["MXTPU_FUSED_KERNELS"]
            else:
                os.environ["MXTPU_FUSED_KERNELS"] = old
        launched = fa.LAUNCHES - before
        want = LC_LAYERS if fused == "1" else 0
        check(launched == want, "lc agreement MXTPU_FUSED_KERNELS=%s "
              "launched %d flash kernels, not %d" % (fused, launched, want))
        for k, r in ref.items():
            check(got[k].shape == r.shape and np.isfinite(got[k]).all(),
                  "lc agreement: %s shape %s / not finite" % (k,
                                                              got[k].shape))
        grads = [k for k in ref if k.startswith("grad:")]
        l_ratio, _ = _worst_max_rel(np, got, ref, ["logits"])
        g_l2 = _rel_l2(np, got, ref, grads)
        t_l2, t_key = max((_rel_l2(np, got, ref, [k]), k) for k in grads)
        m_ratio, m_key = _worst_max_rel(np, got, ref, grads)
        log("lc agreement gpu %s vs cpu at batch %d x %d: logits max |diff| "
            "/ max |cpu| %.3g (bound %g); %d gradients, relative L2 %.3g "
            "(bound %g), worst tensor %s %.3g (bound %g), worst by max "
            "|diff| / max |cpu|: %s %.3g; %d flash launches" % (
                "fused" if fused == "1" else "MXTPU_FUSED_KERNELS=0", batch,
                seq, l_ratio, AGREE_REL_TOL, len(grads), g_l2,
                LC_GRAD_L2_TOL, t_key, t_l2, GRAD_TENSOR_L2_TOL, m_key,
                m_ratio, launched))
        check(l_ratio <= AGREE_REL_TOL and g_l2 <= LC_GRAD_L2_TOL
              and t_l2 <= GRAD_TENSOR_L2_TOL, "lc gpu (MXTPU_FUSED_KERNELS="
              "%s) disagrees with the CPU path" % fused)


def long_context_paths(torch, mx, seed, card):
    """The flash kernel, the long-context LM's training at seq 512 and
    4096, its serving, the symbolic Attention op, GPU-vs-CPU agreement and
    a profile of seq-4096 training.  Returns the flash entry of the kernels
    line."""
    lm = mx.models.long_context_lm
    flash_rows, flash_err = phase_flash_kernels(torch, mx, seed)
    params = _lc_params(torch, mx, seed, mx.gpu(0))
    batches = _lc_batches(torch, mx, LC_STEPS, LC_SEQ, seed + 71)
    params, short = _lc_train(torch, mx, params, batches, LC_SEQ, card,
                              "lc train seq %d" % LC_SEQ)
    long_batches = _lc_batches(torch, mx, LC_LONG_STEPS, LC_MAX_LEN,
                               seed + 72)
    params, long_ = _lc_train(torch, mx, params, long_batches, LC_MAX_LEN,
                              card, "lc train seq %d" % LC_MAX_LEN)
    served = phase_lc_serving(torch, mx, params, seed, card)
    op = phase_attention_op(torch, mx, seed, card)
    op += phase_aot_attention(torch, mx, seed, card)
    phase_lc_agreement(torch, mx, seed)
    step = lm.make_step(None, LC_HEADS, LC_LAYERS, LC_LR)
    counts = profile_steps(
        torch, lambda i: step(params, *long_batches[i % len(long_batches)]),
        lambda: None, lm.UPDATE_RANGE, card, "lc train seq %d" % LC_MAX_LEN,
        ("flash_attention_fwd",), "batch %d x %d tokens" % (LC_BATCH,
                                                           LC_MAX_LEN),
        steps=LC_PROFILE_STEPS)
    per_step = sum(c for k, c in counts.items()
                   if any(n in k for n in FLASH_KERNEL_NAMES)) \
        / LC_PROFILE_STEPS
    log("lc profile: %.1f flash_attention launches per step (expected %d)"
        % (per_step, LC_LAYERS))
    check(per_step == LC_LAYERS, "profiled flash launches per step %.1f"
          % per_step)
    model = flash_rows[FLASH_MODEL_SHAPE]
    return [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/flash_attention.cu",
        "replaces": "mxnet_tpu/kernels/flash_attention.py:214",
        "launches": short + long_ + served + op,
        "max_abs_err": flash_err,
        "ms": model["f32_ms"],
        "plain_ms": model["f32_plain_ms"],
        "bound_ms": model["f32_bound_ms"],
        "bound_by": model["f32_bound_by"],
        "library_ms": model["f32_library_ms"],
    }]


# ---------------------------------------------------------------------------
# the rtc escape hatch: the elementwise kernel with user bodies, and the
# fine-tune of ResNet-50 through Module.fit that runs one
# ---------------------------------------------------------------------------

#: the rtc bodies the smoke builds: the fine-tune's silu, its derivative
#: (the rtc op's vjp) and the JAX package's test body (tests/test_rtc.py)
RTC_BODIES = (
    ("silu", "out = in / (1.0f + expf(-in));"),
    ("dsilu", "float s = 1.0f / (1.0f + expf(-in)); "
              "out = s * (1.0f + in * (1.0f - s));"),
    ("affine", "out = 2.0f * in + 1.0f;"),
)
#: ResNet-50's largest activation at batch 32, the fine-tune's features,
#: an odd shape, a transposed (non-contiguous) view of (32, 2048), a flat
#: input that starts one element (4 or 2 bytes) off a 16-byte boundary,
#: empty
RTC_SIZES = ((32, 256, 56, 56), (32, 2048), ODD_SHAPE, "transposed",
             "misaligned", (0, 2048))
RTC_MISALIGNED_N = 32 * 2048 + 5  # elements after the one-element offset
RTC_MODEL_SIZE = (32, 256, 56, 56)
#: float32: max |kernel - plain| within this x max |plain| (the same expf
#: and division, rounded in another order at most); bfloat16 and float16:
#: every element within one ulp of the working type (the kernel rounds
#: once from float, as the plain version does)
RTC_F32_REL_TOL = 2e-6
FT_LAYER = "flatten0"   # fine-tune.py's default --layer-before-fullc
FT_BATCHES = 4          # batches of one fit epoch, per route
FT_SCORE_BATCHES = 2
FT_LR = 0.01            # fine-tune.py:40-41: sgd, lr 0.01, mom 0, wd 0
FT_AGREE_LR = 1.0       # the batch-4 check recovers gradients from one update
#: the two Module routes after the same batches from the same weights,
#: both fitted with deterministic cuDNN algorithms: the relative L2 of
#: their parameter updates (all tensors together) and of their moving
#: statistics.  They run the same ops in the same order and agree bit
#: for bit on the H100 (PERF.md, Findings).  (With cuDNN's default
#: algorithms the float32 weight gradients accumulate with atomics in an
#: order that changes between runs, and a ReLU flip moves single gradient
#: elements: two fused runs then differ by 2e-2.)
FT_ROUTE_REL_L2 = 1e-6


def rtc_kernels(torch, mx):
    """The smoke's rtc kernels, name -> ElementwiseKernel, each with its
    plain version: the body's function in the kernel's math type (float,
    double for float64), rounded once to the storage type."""
    def math(x):
        return x.double() if x.dtype == torch.float64 else x.float()

    def silu(x):
        m = math(x)
        return (m / (1.0 + torch.exp(-m))).to(x.dtype)

    def dsilu(x):
        m = math(x)
        s = 1.0 / (1.0 + torch.exp(-m))
        return (s * (1.0 + m * (1.0 - s))).to(x.dtype)

    def affine(x):
        return (2.0 * math(x) + 1.0).to(x.dtype)

    plains = {"silu": silu, "dsilu": dsilu, "affine": affine}
    return {name: mx.rtc.elementwise_cuda_kernel(body, plain=plains[name])
            for name, body in RTC_BODIES}


def _rtc_input(torch, size, gen, dev):
    """The float32 source of an rtc input (for "misaligned", a flat tensor
    one element longer: the input is its ``[1:]`` in the working dtype)."""
    if size == "transposed":
        return torch.randn(2048, 32, generator=gen, device=dev).t() * 4.0
    if size == "misaligned":
        return torch.randn(RTC_MISALIGNED_N + 1, generator=gen,
                           device=dev) * 4.0
    return torch.randn(size, generator=gen, device=dev) * 4.0


def _ulp_ratio(torch, got, ref):
    """max over elements of |got - ref| / ulp(ref) in ref's (bfloat16 or
    float16) working type; 0 for empty tensors."""
    if ref.numel() == 0:
        return 0.0
    mbits, tiny = (7, 2.0 ** -133) if ref.dtype == torch.bfloat16 \
        else (10, 2.0 ** -24)
    r = ref.float()
    ulp = torch.ldexp(torch.ones_like(r), torch.frexp(r).exponent - 1 - mbits)
    ulp = torch.where(r == 0, torch.full_like(r, tiny), ulp.clamp_min(tiny))
    return float(((got.float() - r).abs() / ulp).max())


def phase_rtc_kernels(torch, mx, rtc, seed):
    """Each rtc body's kernel against its plain version at RTC_SIZES in
    float32, bfloat16 and float16; times at every non-empty size.  Also
    shows that a second kernel of a body reuses its library."""
    import torch.nn.functional as F
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 90)
    rows = {}
    max_f32_err = 0.0
    for name, k in rtc.items():
        check(k.build() == 0.0, "rtc %s: the library was not built in the "
              "parallel build" % name)
        again = mx.rtc.elementwise_cuda_kernel(k.body, plain=k.plain)
        check(again.build() == 0.0 and again._lib is k._lib,
              "rtc %s: a second kernel of the same body rebuilt" % name)
        for size in RTC_SIZES:
            x32 = _rtc_input(torch, size, gen, dev)
            for dtype, tag in ((torch.float32, "f32"),
                               (torch.bfloat16, "bf16"),
                               (torch.float16, "f16")):
                x = x32.to(dtype)
                if size == "misaligned":
                    x = x[1:]
                    check(x.data_ptr() % 16 != 0, "rtc misaligned %s: the "
                          "input is 16-byte aligned" % tag)
                before = mx.rtc.LAUNCHES
                y = k(x)
                ref = k.plain(x)
                torch.cuda.synchronize()
                check(mx.rtc.LAUNCHES - before == (1 if x.numel() else 0),
                      "rtc %s %s %s: %d launches" % (
                          name, size, tag, mx.rtc.LAUNCHES - before))
                check(y.shape == ref.shape and y.dtype == dtype,
                      "rtc %s %s %s: shape/dtype %s %s" % (
                          name, size, tag, tuple(y.shape), y.dtype))
                row = rows.setdefault((name, size), {})
                if x.numel() == 0:
                    continue
                if tag == "f32":
                    err = float((y - ref).abs().max())
                    top = max(float(ref.abs().max()), 1e-30)
                    check(err <= RTC_F32_REL_TOL * top, "rtc %s %s f32: max "
                          "abs err %.3g > %g x %.3g" % (
                              name, size, err, RTC_F32_REL_TOL, top))
                    max_f32_err = max(max_f32_err, err)
                    row["f32_err"] = err
                else:
                    ratio = _ulp_ratio(torch, y, ref)
                    check(ratio <= 1.0, "rtc %s %s %s: %.3g ulp from the "
                          "plain version" % (name, size, tag, ratio))
                    row[tag + "_ulps"] = ratio
                row[tag + "_ms"] = device_ms(torch, lambda: k(x))
                row[tag + "_plain_ms"] = device_ms(torch, lambda: k.plain(x))
                row[tag + "_bound_ms"] = 2 * x.numel() * x.element_size() \
                    / HBM_BYTES_PER_S * 1e3
                if name == "silu":
                    row[tag + "_library_ms"] = device_ms(
                        torch, lambda: F.silu(x))
            r = rows[(name, size)]
            if "f32_ms" in r:
                lib = lambda tag: (  # noqa: E731
                    " library %.4f" % r[tag + "_library_ms"]
                    if tag + "_library_ms" in r else "")
                log("rtc %-6s %-17s f32: err %.2e ms %.4f plain %.4f%s bound "
                    "%.4f | bf16: %.2g ulp ms %.4f plain %.4f%s bound %.4f | "
                    "f16: %.2g ulp ms %.4f plain %.4f%s bound %.4f" % (
                        name, size, r["f32_err"], r["f32_ms"],
                        r["f32_plain_ms"], lib("f32"), r["f32_bound_ms"],
                        r["bf16_ulps"], r["bf16_ms"], r["bf16_plain_ms"],
                        lib("bf16"), r["bf16_bound_ms"], r["f16_ulps"],
                        r["f16_ms"], r["f16_plain_ms"], lib("f16"),
                        r["f16_bound_ms"]))
            else:
                log("rtc %-6s %-17s empty: no launch, shape kept"
                    % (name, size))
    log("rtc kernels: float32 max abs err %.3g; every body, size and dtype "
        "within tolerance; a second kernel of each body reused its library"
        % max_f32_err)
    return rows, max_f32_err


def _register_rtc_silu(mx, rtc):
    """``mx.sym.rtc_silu``: silu through the rtc kernel, its derivative
    kernel times the cotangent as the vjp."""
    silu, dsilu = rtc["silu"], rtc["dsilu"]
    if "rtc_silu" in mx.ops.registry.OP_REGISTRY:
        return

    def rtc_silu(data):
        """x * sigmoid(x) through the rtc elementwise kernel."""
        return silu(data)

    mx.rtc.register_kernel("rtc_silu", vjp=lambda x, g: dsilu(x) * g)(
        rtc_silu)


def finetune_symbol(mx, seed, tmp):
    """fine-tune.py's flow from a checkpoint of seeded random ResNet-50
    weights: save, load, cut at FT_LAYER, add the rtc op, a new
    FullyConnected head of 1000 classes and SoftmaxOutput.  Returns the
    symbol and the loaded params without the old head."""
    with mx.name.NameManager():     # fresh counters: the Flatten is flatten0
        body = mx.models.get_symbol("resnet-50", num_classes=1000,
                                    image_shape=IMAGE)
    args, aux = draw_weights(body, (BATCH,) + IMAGE, seed)
    host = mx.cpu()
    prefix = os.path.join(tmp, "resnet-50")
    mx.model.save_checkpoint(
        prefix, 0, body, {k: mx.nd.array(v, ctx=host) for k, v in args.items()},
        {k: mx.nd.array(v, ctx=host) for k, v in aux.items()})
    sym, arg_params, aux_params = mx.model.load_checkpoint(prefix, 0)
    internals = sym.get_internals()
    layer = FT_LAYER + "_output"
    check(layer in internals.list_outputs(), "the loaded ResNet-50 has no "
          "layer %r" % layer)
    net = mx.sym.rtc_silu(internals[layer], name="rtc_silu0")
    net = mx.sym.FullyConnected(net, num_hidden=1000, name="fc-new")
    net = mx.sym.SoftmaxOutput(net, name="softmax")
    arg_params = {k: v for k, v in arg_params.items() if "fc" not in k}
    log("fine-tune: checkpoint saved and loaded (%d arg, %d aux params), "
        "cut at %s, + rtc_silu0 + fc-new (1000) + softmax: %d params"
        % (len(arg_params), len(aux_params), layer,
           len(net.list_arguments()) - 2))
    return net, arg_params, aux_params


def _ft_fit(torch, mx, net, arg_params, aux_params, X, y, kvstore, prefix,
            seed, card, note="cuDNN default algorithms", optimizer="sgd",
            momentum=0.0):
    """One epoch of Module.fit with fit.py's wiring on gpu(0) (sgd, or
    ``optimizer`` with ``momentum``); the bn_act and rtc counts are zeroed
    just before and read just after.  Returns the module, the initial
    params it drew and the run's numbers."""
    import numpy as np
    ba = mx.kernels.bn_act
    mx.random.seed(seed)            # the same fc-new init on both routes
    xavier = mx.initializer.Xavier(rnd_type="gaussian", factor_type="in",
                                   magnitude=2)
    drawn = {}

    def initializer(name, arr):
        xavier(name, arr)
        drawn[str(name)] = arr.asnumpy().copy()

    mod = mx.mod.Module(net, context=mx.gpu(0))
    train = mx.io.NDArrayIter(X, y, batch_size=BATCH)
    metric = mx.metric.create(["accuracy", mx.metric.create(
        "top_k_accuracy", top_k=5)])
    stamps, losses = [], []

    def on_batch(param):
        stamps.append(time.perf_counter())
        out = mod.get_outputs()[0]._data
        label = param.locals["data_batch"].label[0]._data.to(out.device)
        losses.append(_cross_entropy(torch, out, label))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # -- the main path: counts zeroed just before, read just after ---------
    ba.LAUNCHES = 0
    ba.BWD_LAUNCHES = 0
    mx.rtc.LAUNCHES = 0
    t0 = time.perf_counter()
    mod.fit(train, eval_metric=metric, kvstore=kvstore, optimizer=optimizer,
            optimizer_params={"learning_rate": FT_LR, "momentum": momentum,
                              "wd": 0.0},
            initializer=initializer, arg_params=arg_params,
            aux_params=aux_params, allow_missing=True,
            batch_end_callback=[mx.callback.Speedometer(BATCH, 2), on_batch],
            epoch_end_callback=mx.callback.do_checkpoint(prefix),
            num_epoch=1)
    torch.cuda.synchronize()
    counts = (ba.LAUNCHES, ba.BWD_LAUNCHES, mx.rtc.LAUNCHES)
    # ----------------------------------------------------------------------
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    n = len(stamps)
    losses = [float(v) for v in torch.stack(losses).cpu()]
    what = "fine-tune fit kvstore=%r %s momentum %g (%s)" % (
        kvstore, optimizer, momentum, note)
    log("%s: %s route, %d batches; launches bn_act %d forward / %d "
        "backward, rtc %d (expected %d / %d / %d)" % (
            what, "fused SPMDTrainer" if mod._fused is not None
            else "executor-group", n, counts[0], counts[1], counts[2],
            50 * n, 50 * n, 2 * n))
    check(n == FT_BATCHES and (mod._fused is not None) == (kvstore == "tpu"),
          "%s: %d batches, route %s" % (what, n, mod._fused))
    check(counts == (50 * n, 50 * n, 2 * n), "%s: launches %s" % (what,
                                                                  counts))
    log("%s: per-batch loss %s; Train-%s" % (
        what, " ".join("%.4f" % v for v in losses),
        ", ".join("%s=%.4f" % nv for nv in metric.get_name_value())))
    check(all(np.isfinite(losses)), what + ": non-finite loss")
    steady = (stamps[-1] - stamps[1]) / (n - 2)
    log("%s: first batch %.1f ms, steady %.2f ms/batch -> %.1f img/s, fit "
        "%.2f s in all (checkpoint included), peak memory %.2f GiB on %s" % (
            what, (stamps[0] - t0) * 1e3, steady * 1e3, BATCH / steady, wall,
            peak / 2 ** 30, card))
    args1, _ = mod.get_params()
    check(not np.allclose(args1["fc-new_weight"].asnumpy(),
                          drawn["fc-new_weight"]), what + ": fc-new did not "
          "move")
    sym_ck, args_ck, _ = mx.model.load_checkpoint(prefix, 1)
    check(sym_ck.tojson() == net.tojson() and np.array_equal(
        args_ck["fc-new_weight"].asnumpy(),
        args1["fc-new_weight"].asnumpy()), what + ": the epoch checkpoint "
          "does not load back")
    return mod, drawn, {"launches": counts, "steady_ms": steady * 1e3,
                        "img_s": BATCH / steady, "peak_gib": peak / 2 ** 30}


def _ft_score_predict(torch, mx, mod, X, y, what):
    """score and predict on FT_SCORE_BATCHES batches: 1 rtc launch per
    forward, finite probabilities."""
    import numpy as np
    it = mx.io.NDArrayIter(X[:FT_SCORE_BATCHES * BATCH],
                           y[:FT_SCORE_BATCHES * BATCH], batch_size=BATCH)
    metric = mx.metric.create(["accuracy", mx.metric.create(
        "top_k_accuracy", top_k=5)])
    # -- main path: the count zeroed just before each call, read just after
    mx.rtc.LAUNCHES = 0
    res = mod.score(it, metric)
    torch.cuda.synchronize()
    scored = mx.rtc.LAUNCHES
    mx.rtc.LAUNCHES = 0
    preds = mod.predict(it).asnumpy()
    predicted = mx.rtc.LAUNCHES
    # ----------------------------------------------------------------------
    log("%s: score %s, predict %s; rtc launches %d + %d (expected %d + %d)"
        % (what, ", ".join("%s=%.4f" % nv for nv in res), preds.shape,
           scored, predicted, FT_SCORE_BATCHES, FT_SCORE_BATCHES))
    check(scored == predicted == FT_SCORE_BATCHES, what + ": rtc launches")
    check(preds.shape == (FT_SCORE_BATCHES * BATCH, 1000)
          and np.isfinite(preds).all()
          and np.allclose(preds.sum(1), 1.0, atol=1e-4),
          what + ": predictions are not probability rows")
    return scored + predicted


def _ft_route_agreement(np, mods, start):
    """``(relative L2 of the two modules' parameter updates from start,
    all tensors together; (worst tensor's own relative L2, its name);
    relative L2 of their moving statistics)``."""
    (a_args, a_aux), (b_args, b_aux) = [m.get_params() for m in mods]
    num = den = 0.0
    worst = (0.0, "")
    for k, w0 in start.items():
        da = a_args[k].asnumpy().astype(np.float64) - w0
        db = b_args[k].asnumpy().astype(np.float64) - w0
        n, d = float(np.sum((da - db) ** 2)), float(np.sum(db ** 2))
        num, den = num + n, den + d
        if d > 0:
            worst = max(worst, ((n / d) ** 0.5, k))
    upd = (num / den) ** 0.5
    num = sum(float(np.sum((a_aux[k].asnumpy().astype(np.float64)
                            - b_aux[k].asnumpy()) ** 2)) for k in b_aux)
    den = sum(float(np.sum(b_aux[k].asnumpy().astype(np.float64) ** 2))
              for k in b_aux)
    return upd, worst, (num / den) ** 0.5


def _ft_trainer(torch, mx, net, start, aux_params, X, y, card):
    """SPMDTrainer.step on the fine-tune symbol with the same weights,
    optimizer and host batches as the Module: its steady ms per step."""
    tr = mx.parallel.SPMDTrainer(
        net, "sgd", {"learning_rate": FT_LR, "momentum": 0.0, "wd": 0.0,
                     "rescale_grad": 1.0 / BATCH}, ctx=mx.gpu(0))
    tr.bind([("data", (BATCH,) + IMAGE)], [("softmax_label", (BATCH,))])
    tr.init_params(None, start, aux_params)
    batches = [(b.data[0], b.label[0]) for b in mx.io.NDArrayIter(
        X, y, batch_size=BATCH)]
    ba = mx.kernels.bn_act
    before = (ba.LAUNCHES, mx.rtc.LAUNCHES)
    stamps = []
    for data, label in batches:
        tr.step(data, label)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
    launched = (ba.LAUNCHES - before[0], mx.rtc.LAUNCHES - before[1])
    n = len(stamps)
    check(launched == (50 * n, 2 * n), "SPMDTrainer on the fine-tune "
          "symbol: launches %s" % (launched,))
    steady = (stamps[-1] - stamps[1]) / (n - 2)
    log("fine-tune SPMDTrainer.step (same symbol, weights and host batches): "
        "steady %.2f ms/step -> %.1f img/s on %s" % (
            steady * 1e3, BATCH / steady, card))
    tr.close()
    return steady * 1e3


def phase_ft_agreement(torch, mx, net, start, aux_params, seed):
    """One batch-4 forward_backward + update of the fine-tune Module on
    the card (fused route, sgd at lr FT_AGREE_LR, so each parameter's
    update gives back its gradient) against the port's CPU path, where the
    rtc op takes its plain version: outputs and moving statistics against
    the CPU float32 run, gradients against its float64 run (as
    ``phase_train_agreement``)."""
    import numpy as np
    ba = mx.kernels.bn_act
    shape = (AGREE_BATCH,) + IMAGE
    rs = np.random.RandomState(seed + 83)
    x = rs.standard_normal(shape).astype(np.float32)
    y = rs.randint(0, 1000, AGREE_BATCH).astype(np.float32)
    weights = ({k: v.asnumpy() for k, v in start.items()},
               {k: v.asnumpy() for k, v in aux_params.items()})
    t0 = time.perf_counter()
    ref = _executor_step(mx, net, weights, x, y, mx.cpu())
    exact = _executor_step(mx, net, weights, x.astype(np.float64),
                           y.astype(np.float64), mx.cpu())
    keys = ["output"] + ["grad:" + k for k in start] + \
        ["aux:" + k for k in aux_params]
    ref = {k: ref[k] for k in keys}
    exact = {k: exact[k] for k in keys}
    grads = [k for k in keys if k.startswith("grad:")]
    cpu_l2 = _rel_l2(np, ref, exact, grads)
    log("fine-tune agreement: CPU float32 and float64 steps at batch %d "
        "took %.1f s; CPU float32 gradients' relative L2 error against "
        "float64 %.3g" % (AGREE_BATCH, time.perf_counter() - t0, cpu_l2))
    mod = mx.mod.Module(net, context=mx.gpu(0))
    mod.bind([("data", shape)], [("softmax_label", (AGREE_BATCH,))])
    mod.init_params(None, arg_params=start, aux_params=aux_params)
    mod.init_optimizer(kvstore="tpu", optimizer="sgd", optimizer_params={
        "learning_rate": FT_AGREE_LR, "momentum": 0.0, "wd": 0.0})
    check(mod._fused is not None, "fine-tune agreement: no fused route")
    batch = mx.io.DataBatch([mx.nd.array(x, ctx=mx.cpu())],
                            [mx.nd.array(y, ctx=mx.cpu())])
    before = (ba.LAUNCHES, ba.BWD_LAUNCHES, mx.rtc.LAUNCHES)
    mod.forward_backward(batch)
    mod.update()
    out = mod.get_outputs()[0].asnumpy()
    launched = (ba.LAUNCHES - before[0], ba.BWD_LAUNCHES - before[1],
                mx.rtc.LAUNCHES - before[2])
    check(launched == (50, 50, 2), "fine-tune agreement step launched %s "
          "(bn_act fwd, bwd, rtc), not (50, 50, 2)" % (launched,))
    args1, aux1 = mod.get_params()
    # w1 = w0 - lr * g / batch: the gradient from the update, summed over
    # the batch as the executor's backward gives it
    got = {"output": out.astype(np.float64)}
    for k, w0 in weights[0].items():
        got["grad:" + k] = (w0.astype(np.float64) - args1[k].asnumpy()) \
            * AGREE_BATCH / FT_AGREE_LR
    for k, v in aux1.items():
        got["aux:" + k] = v.asnumpy().astype(np.float64)
    _compare_train(np, got, ref, exact, cpu_l2, "fine-tune gpu Module step")


def phase_ft_profile(torch, mx, mod, X, y, card):
    """A torch.profiler trace of PROFILE_STEPS batches of Module.fit on
    the fused route (one more epoch of the same module)."""
    from mxnet_tpu_torch.parallel.trainer import UPDATE_RANGE
    it = mx.io.NDArrayIter(X[:PROFILE_STEPS * BATCH],
                           y[:PROFILE_STEPS * BATCH], batch_size=BATCH)

    def run(i):
        if i == 0:
            mod.fit(it, eval_metric=mx.metric.create(["accuracy", mx.metric
                    .create("top_k_accuracy", top_k=5)]), kvstore="tpu",
                    batch_end_callback=mx.callback.Speedometer(BATCH, 2),
                    num_epoch=1)

    counts = profile_steps(torch, run, lambda: None, UPDATE_RANGE, card,
                           "fine-tune fit", ("bn_act_fwd", "bn_act_bwd",
                                             "rtc"), "batch %d" % BATCH)
    per_batch = sum(c for k, c in counts.items()
                    if "rtc_elementwise_kernel" in k) / PROFILE_STEPS
    log("fine-tune profile: %.1f rtc launches per batch (expected 2)"
        % per_batch)
    check(per_batch == 2, "profiled rtc launches per batch %.1f" % per_batch)


def _update_profile(torch, mx, mod, X, y, card, what):
    """Host ms of one ``Module.update()`` (median of 5, after a forward
    and backward) and a torch.profiler trace of PROFILE_STEPS batches of
    forward -> backward -> update with the update in its own range.
    Returns ``(update ms, kernel launches per batch)``."""
    batches = [mx.io.DataBatch(
        [mx.nd.array(X[i * BATCH:(i + 1) * BATCH], ctx=mx.gpu(0))],
        [mx.nd.array(y[i * BATCH:(i + 1) * BATCH], ctx=mx.gpu(0))])
        for i in range(PROFILE_STEPS)]
    mod.forward(batches[0], is_train=True)
    mod.backward()
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mod.update()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    update_ms = sorted(times)[2]

    def run(i):
        mod.forward(batches[i], is_train=True)
        mod.backward()
        with torch.profiler.record_function("Module.update"):
            mod.update()

    counts = profile_steps(torch, run, lambda: None, "Module.update", card,
                           what, ("bn_act_fwd", "bn_act_bwd", "rtc"),
                           "batch %d" % BATCH)
    return update_ms, sum(counts.values()) / PROFILE_STEPS


def phase_nag_fit(torch, mx, net, arg_params, aux_params, X, y, tmp, seed,
                  card):
    """The fine-tune through Module.fit on the executor route with NAG
    (written in NDArray arithmetic), beside sgd with the same momentum on
    the same batches: ms per batch, the update's host ms and kernel
    launches per batch of each.  Returns the bn_act and rtc launches of
    the two fits."""
    extra = collections.Counter()
    out = {}
    for opt in ("nag", "sgd", "sgd", "nag"):
        mod, _, run = _ft_fit(torch, mx, net, arg_params, aux_params, X, y,
                              "local", os.path.join(tmp, "opt-" + opt), seed,
                              card, optimizer=opt, momentum=NAG_MOMENTUM)
        check(mod._fused is None, "%s fit took the fused route" % opt)
        fwd, bwd, rtc = run["launches"]
        extra.update({"bn_act_fwd": fwd, "bn_act_bwd": bwd,
                      "rtc_elementwise": rtc})
        if opt in out:
            out[opt]["steady_ms"].append(run["steady_ms"])
        else:
            update_ms, per_batch = _update_profile(
                torch, mx, mod, X, y, card, "fine-tune fit %s" % opt)
            out[opt] = {"steady_ms": [run["steady_ms"]],
                        "update_ms": update_ms, "launches": per_batch}
        del mod
        gc.collect()
        torch.cuda.empty_cache()
    for opt, r in sorted(out.items()):
        log("fine-tune %s (momentum %g, executor route): %s ms/batch (two "
            "fits, in turns nag, sgd, sgd, nag), Module.update %.2f ms host, "
            "%.1f kernel launches per batch, on %s" % (
                opt, NAG_MOMENTUM, " / ".join("%.2f" % v for v in
                                              r["steady_ms"]),
                r["update_ms"], r["launches"], card))
    log("fine-tune nag - sgd: update %+.2f ms, %+.1f launches per batch "
        "(the host cost of an optimizer in NDArray arithmetic, %d "
        "parameter arrays)" % (
            out["nag"]["update_ms"] - out["sgd"]["update_ms"],
            out["nag"]["launches"] - out["sgd"]["launches"],
            len(net.list_arguments()) - 2))
    return extra


@contextlib.contextmanager
def _deterministic_cudnn(torch):
    """cuDNN restricted to deterministic algorithms, as it was after."""
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = saved


def finetune_paths(torch, mx, rtc, seed, card):
    """The rtc kernels, then the fine-tune through Module.fit on both
    routes, score/predict, SPMDTrainer for comparison, CPU agreement and
    a profile; then the NAG fits (``phase_nag_fit``).  Returns the bn_act
    and rtc launches of the NAG fits and the rtc entry of the kernels
    line."""
    import logging
    import numpy as np
    logging.basicConfig(level=logging.INFO, format="  %(message)s",
                        stream=sys.stdout)
    rows, max_f32_err = phase_rtc_kernels(torch, mx, rtc, seed)
    _register_rtc_silu(mx, rtc)
    build_dir = os.path.join(ROOT, "mxnet_tpu_torch", "_build")
    os.makedirs(build_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="finetune-", dir=build_dir)
    try:
        net, arg_params, aux_params = finetune_symbol(mx, seed, tmp)
        rs = np.random.RandomState(seed + 81)
        X = rs.standard_normal((FT_BATCHES * BATCH,) + IMAGE) \
            .astype(np.float32)
        y = rs.randint(0, 1000, FT_BATCHES * BATCH).astype(np.float32)
        # the routes' agreement, from fits with deterministic cuDNN
        with _deterministic_cudnn(torch):
            agree = {kv: _ft_fit(torch, mx, net, arg_params, aux_params, X,
                                 y, kv, os.path.join(tmp, "det-" + kv), seed,
                                 card, "deterministic cuDNN")
                     for kv in ("tpu", "local")}
        drawn = agree["tpu"][1]
        check(all(np.array_equal(drawn[k], agree["local"][1][k])
                  for k in drawn),
              "the two routes drew different fc-new initial weights")
        start = {k: v.asnumpy() for k, v in arg_params.items()}
        start.update(drawn)
        upd, worst, aux_l2 = _ft_route_agreement(
            np, (agree["tpu"][0], agree["local"][0]), start)
        log("fine-tune routes fused vs executor (deterministic cuDNN): "
            "parameter updates relative L2 %.3g, worst tensor %s %.3g; "
            "moving statistics relative L2 %.3g (bound %g each)" % (
                upd, worst[1], worst[0], aux_l2, FT_ROUTE_REL_L2))
        check(upd <= FT_ROUTE_REL_L2 and aux_l2 <= FT_ROUTE_REL_L2,
              "the fused and executor routes disagree")
        main_fit_launches = sum(r[2]["launches"][2] for r in agree.values())
        del agree
        gc.collect()
        torch.cuda.empty_cache()
        # the timed fits, with cuDNN's default algorithms
        fused, _, f_run = _ft_fit(torch, mx, net, arg_params, aux_params, X,
                                  y, "tpu", os.path.join(tmp, "ft-tpu"), seed,
                                  card)
        local, _, l_run = _ft_fit(torch, mx, net, arg_params, aux_params, X,
                                  y, "local", os.path.join(tmp, "ft-local"),
                                  seed, card)
        main_fit_launches += f_run["launches"][2] + l_run["launches"][2]
        served = _ft_score_predict(torch, mx, fused, X, y,
                                   "fine-tune fused module")
        served += _ft_score_predict(torch, mx, local, X, y,
                                    "fine-tune executor module")
        aot_rtc, aot_bn = phase_aot_rtc(torch, mx, net, fused, X, tmp, card)
        served += aot_rtc
        host = mx.cpu()
        start_nd = {k: mx.nd.array(v, ctx=host) for k, v in start.items()}
        del local
        torch.cuda.empty_cache()
        tr_ms = _ft_trainer(torch, mx, net, start_nd, aux_params, X, y, card)
        log("fine-tune: Module.fit %.2f ms/batch fused, %.2f executor route; "
            "SPMDTrainer.step %.2f ms: the Module's own overhead %.2f ms "
            "per batch on the fused route, on %s" % (
                f_run["steady_ms"], l_run["steady_ms"], tr_ms,
                f_run["steady_ms"] - tr_ms, card))
        phase_ft_agreement(torch, mx, net, start_nd, aux_params, seed)
        phase_ft_profile(torch, mx, fused, X, y, card)
        del fused
        gc.collect()
        torch.cuda.empty_cache()
        extra = phase_nag_fit(torch, mx, net, arg_params, aux_params, X, y,
                              tmp, seed, card)
        extra["bn_act_fwd"] += aot_bn
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    main_launches = main_fit_launches + served
    model = rows[("silu", RTC_MODEL_SIZE)]
    feat = [rows[(n, (BATCH, 2048))] for n in ("silu", "dsilu")]
    log("rtc float32 per fine-tune batch (silu + dsilu at (%d, 2048)): "
        "kernel %.4f plain %.4f bound %.4f ms; silu at %s: kernel %.4f "
        "plain %.4f F.silu %.4f bound %.4f ms" % (
            BATCH, sum(r["f32_ms"] for r in feat),
            sum(r["f32_plain_ms"] for r in feat),
            sum(r["f32_bound_ms"] for r in feat), RTC_MODEL_SIZE,
            model["f32_ms"], model["f32_plain_ms"],
            model["f32_library_ms"], model["f32_bound_ms"]))
    return extra, [{
        "name": "rtc_elementwise",
        "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/rtc_elementwise.cu",
        "replaces": "mxnet_tpu/rtc.py:138",
        "launches": main_launches,
        "max_abs_err": max_f32_err,
        "ms": model["f32_ms"],
        "plain_ms": model["f32_plain_ms"],
        "bound_ms": model["f32_bound_ms"],
        "bound_by": "bytes",
        "library_ms": model["f32_library_ms"],
    }]


# ---------------------------------------------------------------------------
# the NDArray and Symbol surface: the tensor ops of ops/tensor.py, an FGSM
# attack on ResNet-50 in NDArray arithmetic, the optimizers written in it,
# and the NDArray layer's dispatch cost
# ---------------------------------------------------------------------------

#: the sweep's main shape (an odd width), the tests' is (3, 7)
SWEEP_SHAPE = (64, 257)
HALF_TYPES = ("float16", "bfloat16")
FLOAT_TYPES = ("float32",) + HALF_TYPES
ALL_TYPES = FLOAT_TYPES + ("int32",)
#: card vs the port's CPU path: float32 within this x max |cpu| (both
#: float32, other kernels and summation orders), half types within
#: HALF_REL_TOL x max |cpu| (a few ulp of 2^-8), gradients within
#: GRAD_REL_L2 in relative L2; integer, comparison, logic, indexing and
#: ordering results exactly
SWEEP_F32_REL_TOL = 1e-5
HALF_REL_TOL = 1e-2
GRAD_REL_L2 = 1e-4
SAMPLER_DRAWS = 10 ** 6
#: the sampling ops: checked by seed determinism and moments, not values
SAMPLERS = (("_sample_uniform", {"low": -1.0, "high": 3.0}, 1.0, 16.0 / 12),
            ("_sample_normal", {"loc": 0.5, "scale": 2.0}, 0.5, 4.0),
            ("_sample_gamma", {"alpha": 2.0, "beta": 1.5}, 3.0, 4.5))
FGSM_EPS = 0.01
FGSM_BATCHES = 3        # attack batches after one warm-up batch
FGSM_AGREE_BATCH = 2    # the attack batch held against the CPU
FGSM_SIGN_FLOOR = 1e-3  # signs compared where |g| > this x max |g|
OPT_SHAPE = (64, 257)
NAG_MOMENTUM = 0.9
DISPATCH_SHAPE = (32, 1024)
DISPATCH_REPS, DISPATCH_CALLS = 3, 1000


def _tensor_case(op, inputs, attrs=None, dtypes=FLOAT_TYPES, kind="float",
                 grad=True, tag="", fixed=None):
    return dict(op=op, inputs=tuple(inputs), attrs=attrs or {},
                dtypes=dtypes, kind=kind, grad=grad, tag=tag,
                fixed=fixed or {})


def tensor_op_cases(m, n):
    """The cases of the tensor-op sweep at main shape (m, n), shared with
    ``tests/test_torch_tensor_ops.py`` (which runs them at (3, 7) against
    the JAX package).  Each case: the op, its inputs as (domain, shape)
    or ("index", values), attributes, the dtypes it runs in (float32
    always, the half types where the op takes floats, int32 where the
    reference takes it), how it is compared (``exact``, ``float``,
    ``trans`` for transcendental) and whether its gradient is checked.
    Inputs with ties (``ties``) make ordering and comparison checks bite;
    index inputs reach outside their range and are fractional."""
    import numpy as np
    c = _tensor_case
    S, ROW, COL = (m, n), (1, n), (m, 1)
    CUBE, TALL = (m, 5, n), (m + 2, n)
    two = (("any", S), ("any", S))
    ties2 = (("ties", S), ("ties", S))
    idx = np.array([-1.7, 0.0, 3.2, m + 7.0, 4.9, -6.0], np.float32)
    rows = np.resize(np.array([0, n - 1, 2, 1], np.float32), m)
    cols = np.resize(np.array([0, m - 1, 2 % m, 1], np.float32), n)
    onehot = np.array([0.0, 2.0, -1.0, 5.0, 3.7, 1.0], np.float32)
    cases = [
        c("elemwise_add", two, dtypes=ALL_TYPES),
        c("elemwise_sub", two, dtypes=ALL_TYPES),
        c("elemwise_mul", two, dtypes=ALL_TYPES),
        c("elemwise_div", (("any", S), ("nonzero", S)), dtypes=ALL_TYPES),
        c("_power", (("pos", S), ("any", S)), kind="trans"),
        c("_power", (("small", S), ("small", S)), dtypes=("int32",),
          grad=False, tag="int"),
        c("_maximum", two, dtypes=ALL_TYPES),
        c("_minimum", two, dtypes=ALL_TYPES),
        c("_hypot", two, dtypes=ALL_TYPES, kind="trans"),
        c("_grad_add", two, dtypes=ALL_TYPES),
        c("broadcast_add", (("any", S), ("any", ROW)), dtypes=ALL_TYPES),
        c("broadcast_sub", (("any", COL), ("any", S)), dtypes=ALL_TYPES),
        c("broadcast_mul", (("any", S), ("any", ROW)), dtypes=ALL_TYPES),
        c("broadcast_div", (("any", S), ("nonzero", ROW)), dtypes=ALL_TYPES),
        c("broadcast_mod", (("any", S), ("nonzero", ROW)), dtypes=ALL_TYPES,
          grad=False),
        c("broadcast_power", (("pos", S), ("any", ROW)), kind="trans"),
        c("broadcast_power", (("small", S), ("small", ROW)),
          dtypes=("int32",), grad=False, tag="int"),
        c("broadcast_maximum", (("any", S), ("any", ROW)), dtypes=ALL_TYPES),
        c("broadcast_minimum", (("any", S), ("any", ROW)), dtypes=ALL_TYPES),
        c("broadcast_hypot", (("any", S), ("any", ROW)), dtypes=ALL_TYPES,
          kind="trans"),
    ]
    cases += [c(op, ties2, dtypes=ALL_TYPES, kind="exact", grad=False)
              for op in ("broadcast_equal", "broadcast_not_equal",
                         "broadcast_greater", "broadcast_greater_equal",
                         "broadcast_lesser", "broadcast_lesser_equal",
                         "broadcast_logical_and", "broadcast_logical_or",
                         "broadcast_logical_xor")]
    # scalar ops: 2.5 rounds to 2 in int32
    cases += [c(op, (("any", S),), {"scalar": 2.5}, dtypes=ALL_TYPES)
              for op in ("_plus_scalar", "_minus_scalar", "_rminus_scalar",
                         "_mul_scalar", "_div_scalar", "_maximum_scalar",
                         "_minimum_scalar")]
    cases += [
        c("_rdiv_scalar", (("nonzero", S),), {"scalar": 2.5},
          dtypes=ALL_TYPES),
        c("_mod_scalar", (("any", S),), {"scalar": 2.5}, dtypes=ALL_TYPES,
          grad=False),
        c("_rmod_scalar", (("nonzero", S),), {"scalar": 2.5},
          dtypes=ALL_TYPES, grad=False),
        c("_power_scalar", (("pos", S),), {"scalar": 2.5}, kind="trans"),
        c("_power_scalar", (("any", S),), {"scalar": 2.5},
          dtypes=("int32",), grad=False, tag="int"),
        c("_rpower_scalar", (("any", S),), {"scalar": 2.5}, kind="trans"),
        c("_rpower_scalar", (("small", S),), {"scalar": 2.5},
          dtypes=("int32",), grad=False, tag="int"),
        c("_hypot_scalar", (("any", S),), {"scalar": 2.5},
          dtypes=ALL_TYPES, kind="trans"),
    ]
    cases += [c(op, (("ties", S),), {"scalar": 1.0}, dtypes=ALL_TYPES,
                kind="exact", grad=False)
              for op in ("_equal_scalar", "_not_equal_scalar",
                         "_greater_scalar", "_greater_equal_scalar",
                         "_lesser_scalar", "_lesser_equal_scalar")]
    one = (("any", S),)
    cases += [
        c("smooth_l1", one, {"scalar": 1.5}),
        c("abs", one, dtypes=ALL_TYPES),
        c("sign", one, dtypes=ALL_TYPES, grad=False),
        c("negative", one, dtypes=ALL_TYPES),
        c("square", one, dtypes=ALL_TYPES),
        c("relu", one, dtypes=ALL_TYPES),
        c("sigmoid", one, kind="trans"),
        c("softsign", one, dtypes=ALL_TYPES),
        c("logical_not", (("ties", S),), dtypes=ALL_TYPES, kind="exact",
          grad=False),
        c("identity", one, dtypes=ALL_TYPES),
        c("BlockGrad", one, dtypes=ALL_TYPES),
        c("reciprocal", (("nonzero", S),), dtypes=ALL_TYPES),
        c("degrees", one, dtypes=ALL_TYPES),
        c("radians", one, dtypes=ALL_TYPES),
        c("rsqrt", (("pos", S),), kind="trans"),
        c("cbrt", one, dtypes=ALL_TYPES, kind="trans"),
        c("rcbrt", (("nonzero", S),), dtypes=ALL_TYPES, kind="trans"),
        c("gamma", (("pos", S),), kind="trans"),
        c("gamma", one, dtypes=("float32",), kind="trans", grad=False,
          tag="negative"),
        c("gammaln", (("pos", S),), kind="trans"),
        c("erf", one, kind="trans"),
        c("erfinv", (("unit", S),), kind="trans"),
    ]
    cases += [c(op, (("halves", S),), dtypes=ALL_TYPES, grad=False)
              for op in ("ceil", "floor", "round", "rint", "trunc", "fix")]
    cases += [c(op, (("pos", S),), dtypes=ALL_TYPES, kind="trans")
              for op in ("sqrt", "log", "log10", "log2", "log1p")]
    cases += [c(op, one, dtypes=ALL_TYPES, kind="trans")
              for op in ("exp", "expm1", "sin", "cos", "tan", "sinh", "cosh",
                         "tanh", "arctan", "arcsinh")]
    cases += [c(op, (("unit", S),), kind="trans")
              for op in ("arcsin", "arccos", "arctanh")]
    cases += [
        c("arccosh", (("gt1", S),), dtypes=ALL_TYPES, kind="trans"),
        # no gradient case: the reference's train forward seeds float32
        # ones heads, which jax.vjp refuses for a float16 output
        c("Cast", one, {"dtype": "float16"}, dtypes=ALL_TYPES, grad=False),
        c("Cast", one, {"dtype": "int32"}, dtypes=ALL_TYPES, grad=False,
          tag="to_int"),
        c("clip", one, {"a_min": -0.5, "a_max": 1.5}),
        c("clip", one, {"a_min": -2, "a_max": 3}, dtypes=("int32",),
          grad=False, tag="int"),
        c("softmax", one, kind="trans"),
        c("softmax", one, {"axis": 0, "temperature": 2.0}, kind="trans",
          tag="axis0_t2"),
        c("log_softmax", one, kind="trans"),
        c("log_softmax", one, {"axis": 0, "temperature": 2.0}, kind="trans",
          tag="axis0_t2"),
    ]
    # reductions, three axis forms each
    cases += [c(op, ((dom, CUBE),), attrs, dtypes=ALL_TYPES, grad=grad,
                tag=tag)
              for op, dom, grad in (("sum", "any", True),
                                    ("mean", "any", True),
                                    ("prod", "unitish", True),
                                    ("nansum", "nans", False),
                                    ("nanprod", "unitnans", False),
                                    ("max", "any", True),
                                    ("min", "any", True))
              for attrs, tag in (({}, "all"),
                                 ({"axis": 1, "keepdims": True}, "keep"),
                                 ({"axis": (0, 2), "exclude": True},
                                  "exclude"))]
    cases += [
        c("norm", one, dtypes=ALL_TYPES),
        c("norm", (("any", CUBE),), {"ord": 1, "axis": (0, 2),
                                     "keepdims": True},
          dtypes=ALL_TYPES, tag="l1_axes"),
        c("argmax", (("ties", CUBE),), dtypes=ALL_TYPES, kind="exact",
          grad=False),
        c("argmax", (("ties", CUBE),), {"axis": 1, "keepdims": True},
          dtypes=ALL_TYPES, kind="exact", grad=False, tag="axis1"),
        c("argmin", (("ties", CUBE),), dtypes=ALL_TYPES, kind="exact",
          grad=False),
        c("argmin", (("ties", CUBE),), {"axis": -1}, dtypes=ALL_TYPES,
          kind="exact", grad=False, tag="axis_last"),
        c("argmax_channel", (("ties", CUBE),), dtypes=ALL_TYPES,
          kind="exact", grad=False),
        c("broadcast_to", (("any", (m, 1, n)),), {"shape": (0, 5, 0)},
          dtypes=ALL_TYPES),
        c("broadcast_axis", (("any", (m, 1, 1)),),
          {"axis": (1, 2), "size": (5, 2)}, dtypes=ALL_TYPES),
        c("dot", (("any", S), ("any", (n, m))), dtypes=ALL_TYPES),
        c("dot", (("any", (n, m)), ("any", (m, n))),
          {"transpose_a": True, "transpose_b": True}, dtypes=ALL_TYPES,
          tag="transposed"),
        c("dot", (("any", (2, m, n)), ("any", (n, 4))), dtypes=ALL_TYPES,
          tag="3d"),
        c("dot", (("any", (n,)), ("any", (n,))), dtypes=ALL_TYPES,
          tag="1d"),
        c("batch_dot", (("any", (2, m, n)), ("any", (2, n, m))),
          dtypes=ALL_TYPES),
        c("batch_dot", (("any", (2, n, m)), ("any", (2, m, n))),
          {"transpose_a": True, "transpose_b": True}, dtypes=ALL_TYPES,
          tag="transposed"),
        c("transpose", (("any", CUBE),), dtypes=ALL_TYPES),
        c("transpose", (("any", CUBE),), {"axes": (1, 0, 2)},
          dtypes=ALL_TYPES, tag="axes"),
        c("SwapAxis", (("any", CUBE),), {"dim1": 0, "dim2": 2},
          dtypes=ALL_TYPES),
        c("Reshape", (("any", CUBE),), {"shape": (0, -1)}, dtypes=ALL_TYPES),
        c("Reshape", (("any", CUBE),), {"shape": (-3, 0)}, dtypes=ALL_TYPES,
          tag="merge"),
        c("Reshape", (("any", CUBE),), {"shape": (-4, 1, m, -2)},
          dtypes=ALL_TYPES, tag="split"),
        c("Flatten", (("any", CUBE),), dtypes=ALL_TYPES),
        c("expand_dims", one, {"axis": 1}, dtypes=ALL_TYPES),
        c("slice", (("any", TALL),), {"begin": (1, 0), "end": (m, None),
                                      "step": (1, 2)}, dtypes=ALL_TYPES),
        c("slice", (("any", TALL),), {"begin": (None, n - 2),
                                      "end": (None, 0), "step": (-1, -2)},
          dtypes=ALL_TYPES, tag="negative_step"),
        c("slice_axis", (("any", TALL),), {"axis": 1, "begin": 1, "end": -1},
          dtypes=ALL_TYPES),
        c("slice_axis", (("any", TALL),),
          {"axis": 0, "begin": -3, "end": None}, dtypes=ALL_TYPES,
          tag="tail"),
        c("reverse", (("any", CUBE),), {"axis": (0, 2)}, dtypes=ALL_TYPES),
        c("repeat", one, {"repeats": 2, "axis": 1}, dtypes=ALL_TYPES),
        c("repeat", one, {"repeats": 3}, dtypes=ALL_TYPES, tag="flat"),
        c("tile", one, {"reps": (2, 1, 3)}, dtypes=ALL_TYPES),
        c("stack", (("any", S),) * 3, {"axis": 1, "num_args": 3},
          dtypes=ALL_TYPES),
        c("add_n", (("any", S),) * 3, {"num_args": 3}, dtypes=ALL_TYPES),
        c("_zeros", (), grad=False, dtypes=ALL_TYPES, fixed={"shape": S}),
        c("_ones", (), grad=False, dtypes=ALL_TYPES, fixed={"shape": S}),
        c("_full", (), grad=False, dtypes=ALL_TYPES,
          fixed={"shape": S, "value": 2.5}),
        c("_arange", (), grad=False, dtypes=ALL_TYPES,
          fixed={"start": 1, "stop": n, "step": 1.5, "repeat": 2}),
        c("_arange", (), grad=False, dtypes=("float32", "int32"),
          fixed={"start": n}, tag="stop_none"),
        c("zeros_like", one, dtypes=ALL_TYPES, grad=False),
        c("ones_like", one, dtypes=ALL_TYPES, grad=False),
        c("take", (("any", TALL), ("index", np.resize(idx, (2, 3)))),
          {"mode": "clip"}, dtypes=ALL_TYPES, kind="exact"),
        c("take", (("any", TALL), ("index", np.resize(idx, (2, 3)))),
          {"mode": "wrap"}, dtypes=ALL_TYPES, kind="exact", tag="wrap"),
        c("take", (("any", (m, n + 1)), ("index", idx[:3])),
          {"axis": 1, "mode": "clip"}, dtypes=ALL_TYPES, kind="exact",
          tag="axis1"),
        c("batch_take", (("any", S), ("index", rows)), dtypes=ALL_TYPES,
          kind="exact"),
        c("one_hot", (("index", onehot),), {"depth": 4}, dtypes=ALL_TYPES,
          kind="exact", grad=False),
        c("one_hot", (("index", onehot.reshape(2, 3)),),
          {"depth": 5, "on_value": 2.0, "off_value": -1.0,
           "dtype": "int32"}, dtypes=("float32",), kind="exact", grad=False,
          tag="int_out"),
        c("_onehot_encode", (("index", rows), ("any", S)), dtypes=ALL_TYPES,
          kind="exact", grad=False),
        c("pick", (("any", S), ("index", rows)), dtypes=ALL_TYPES,
          kind="exact"),
        c("pick", (("any", S), ("index", cols)),
          {"axis": 0, "keepdims": True}, dtypes=ALL_TYPES, kind="exact",
          tag="axis0"),
        c("choose_element_0index", (("any", S), ("index", rows)),
          dtypes=ALL_TYPES, kind="exact"),
        c("fill_element_0index", (("any", S), ("any", (m,)),
                                  ("index", rows)),
          dtypes=ALL_TYPES, kind="exact"),
        c("where", (("bool", S), ("any", S), ("any", S)), dtypes=ALL_TYPES,
          kind="exact"),
        c("where", (("bool", (m,)), ("any", S), ("any", S)),
          dtypes=ALL_TYPES, kind="exact", tag="rows"),
    ]
    cases += [c("topk", (("ties", S),), dict(attrs, k=3), dtypes=ALL_TYPES,
                kind="exact", grad=grad, tag=tag)
              for attrs, tag, grad in (
                  ({}, "indices", False),
                  ({"is_ascend": True}, "ascend", False),
                  ({"ret_typ": "value"}, "value", True),
                  ({"ret_typ": "value", "is_ascend": True, "axis": 0},
                   "value_axis0", True),
                  ({"ret_typ": "both"}, "both", False),
                  ({"ret_typ": "mask"}, "mask", False))]
    cases += [
        c("sort", (("ties", S),), dtypes=ALL_TYPES, kind="exact"),
        c("sort", (("ties", S),), {"is_ascend": False, "axis": 0},
          dtypes=ALL_TYPES, kind="exact", tag="descend_axis0"),
        c("argsort", (("ties", S),), dtypes=ALL_TYPES, kind="exact",
          grad=False),
        c("argsort", (("ties", S),), {"is_ascend": False},
          dtypes=ALL_TYPES, kind="exact", grad=False, tag="descend"),
        c("sgd_update", two, {"lr": 0.1, "wd": 0.01, "rescale_grad": 0.5,
                              "clip_gradient": 0.7},
          dtypes=("float32",), grad=False),
        c("sgd_mom_update", (("any", S),) * 3,
          {"lr": 0.1, "momentum": 0.9, "wd": 0.01, "clip_gradient": 0.7},
          dtypes=("float32",), grad=False),
        c("adam_update", two + (("pos", S),) * 2, {"lr": 0.01, "wd": 0.01},
          dtypes=("float32",), kind="trans", grad=False),
        c("rmsprop_update", two + (("pos", S),),
          {"lr": 0.01, "clip_weights": 0.5}, dtypes=("float32",),
          kind="trans", grad=False),
        c("rmspropalex_update",
          two + (("gt1", S), ("unit", S), ("any", S)), {"lr": 0.01},
          dtypes=("float32",), kind="trans", grad=False),
        c("softmax_cross_entropy", (("any", S), ("index", rows)),
          kind="trans", grad=False),
        c("_CrossDeviceCopy", one, dtypes=ALL_TYPES),
        c("_slice_assign", (("any", TALL), ("any", (2, n))),
          {"begin": (1, None), "end": (3, None)}, dtypes=ALL_TYPES),
        c("_crop_assign_scalar", (("any", TALL),),
          {"scalar": 2.5, "begin": (1, 2), "end": (3, 5)},
          dtypes=ALL_TYPES),
    ]
    return cases


def tensor_case_id(case, dtype=None):
    base = case["op"] + ("-" + case["tag"] if case["tag"] else "")
    return base if dtype is None else "%s-%s" % (base, dtype)


def draw_tensor_inputs(case, dtype, seed):
    """The case's inputs as numpy arrays: data inputs drawn in their
    domain (integer-valued for int32 and for ``ties``), index inputs as
    the case gives them (float32)."""
    import numpy as np
    rs = np.random.RandomState(seed)
    out = []
    for domain, spec in case["inputs"]:
        if domain == "index":
            out.append(np.asarray(spec, np.float32))
            continue
        shape = spec
        if dtype == "int32":
            lo, hi = {"any": (-5, 6), "pos": (1, 6), "gt1": (2, 6),
                      "ties": (-3, 4), "small": (0, 4), "nonzero": (1, 5),
                      "bool": (0, 2), "halves": (-5, 6), "nans": (-5, 6),
                      "unitish": (-2, 3), "unitnans": (-2, 3)}[domain]
            v = rs.randint(lo, hi, shape)
            if domain == "nonzero":
                v = v * rs.choice([-1, 1], shape)
            out.append(v.astype(np.int32))
            continue
        if domain in ("any", "nans"):
            v = rs.standard_normal(shape) * 2
            if domain == "nans":
                v.flat[::5] = np.nan
        elif domain == "pos":
            v = rs.uniform(0.5, 3.0, shape)
        elif domain == "unit":
            v = rs.uniform(-0.9, 0.9, shape)
        elif domain in ("unitish", "unitnans"):
            # +-1 with a few 2s and halves: a product of any length is
            # exact in float32 and stays in range, whatever the order
            v = rs.choice([1.0, 2.0, 0.5], shape, p=[0.96, 0.02, 0.02]) \
                * rs.choice([-1, 1], shape)
            if domain == "unitnans":
                v.flat[::5] = np.nan
        elif domain == "gt1":
            v = rs.uniform(1.1, 3.0, shape)
        elif domain == "ties":
            v = rs.randint(-3, 4, shape)
        elif domain == "small":
            v = rs.uniform(0.0, 2.0, shape)
        elif domain == "nonzero":
            v = rs.uniform(0.5, 3.0, shape) * rs.choice([-1, 1], shape)
        elif domain == "bool":
            v = rs.randint(0, 2, shape)
        elif domain == "halves":
            # half-way values: round/rint go to the even neighbour
            v = rs.randint(-4, 5, shape) + 0.5
            v.flat[::2] = rs.standard_normal(v.size)[::2] * 3
        else:
            raise ValueError(domain)
        out.append(v.astype(np.float32))
    return out


def input_dtypes(case, dtype):
    """Each input's dtype: index inputs and conditions stay float32."""
    return [("float32" if domain in ("index", "bool") else dtype)
            for domain, _ in case["inputs"]]


def case_attrs(case, dtype):
    """The attributes a case calls its op with (init ops take the case's
    dtype)."""
    attrs = dict(case["attrs"], **case["fixed"])
    if not case["inputs"]:
        attrs.setdefault("dtype", dtype)
    return attrs


def _profiler(torch):
    """A torch.profiler window over the host and the card."""
    return torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])


def _nd_call(mx, case, dtype, arrays, ctx):
    """``mx.nd.<op>`` on NDArrays: a list of output NDArrays."""
    attrs = case_attrs(case, dtype)
    if not arrays:
        attrs["ctx"] = ctx
    out = getattr(mx.nd, case["op"])(*arrays, **attrs)
    return out if isinstance(out, list) else [out]


def _sweep_error(np, got, ref, exact, half):
    """``None`` when the card's output matches the CPU's, else what
    differs.  Non-finite entries must match exactly (positions and
    values); finite ones exactly, or within the float tolerance of the
    largest finite |cpu| value."""
    if got.shape != ref.shape:
        return "shape %s vs %s" % (got.shape, ref.shape)
    g, r = got.astype(np.float64), ref.astype(np.float64)
    fin = np.isfinite(r)
    if not np.array_equal(np.isfinite(g), fin) or not np.array_equal(
            g[~fin], r[~fin], equal_nan=True):
        return "non-finite entries differ"
    if exact:
        return None if np.array_equal(g, r) else \
            "max |diff| %.3g (exact expected)" % np.abs(g - r).max()
    scale = float(np.abs(r[fin]).max()) if fin.any() else 0.0
    err = float(np.abs(g[fin] - r[fin]).max()) if fin.any() else 0.0
    tol = (HALF_REL_TOL if half else SWEEP_F32_REL_TOL) * max(scale, 1e-30)
    return None if err <= tol else \
        "max |diff| %.3g over %.3g (max |cpu| %.3g)" % (err, tol, scale)


def _host_syncs(prof):
    """Device-to-host copies in a torch.profiler window, by name (a read
    of a device value on the host, ``.item()`` of a CUDA tensor, is one;
    ``.item()`` of a host scalar, as ``pow`` takes of a host exponent, is
    not)."""
    found = collections.Counter()
    for e in prof.events():
        if "DtoH" in e.name or "cudaStreamSynchronize" in e.name:
            found[e.name] += 1
    return found


def _bind_case(mx, case, arrays, ctx):
    """The case's op as a one-node graph, bound on ``ctx`` with its data
    inputs needing gradients; arguments written from numpy."""
    names = ["in%d" % i for i in range(len(arrays))]
    diff = [nm for nm, (domain, _) in zip(names, case["inputs"])
            if domain not in ("index", "bool")]
    net = getattr(mx.sym, case["op"])(*[mx.sym.var(nm) for nm in names],
                                      **case["attrs"])
    ex = net.simple_bind(ctx, grad_req={nm: "write" if nm in diff
                                        else "null" for nm in names},
                         **{nm: a.shape for nm, a in zip(names, arrays)})
    for nm, a in zip(names, arrays):
        ex.arg_dict[nm][:] = a
    return ex, diff


def phase_tensor_ops(torch, mx, seed, card):
    """Every op of ops/tensor.py on the card against the port's CPU path:
    imperatively (``mx.nd.<op>``) in each dtype, and for the
    differentiable ones through ``simple_bind(mx.gpu(0))`` -> forward ->
    backward; no device-to-host copy inside either sweep (a profile of
    both); the samplers by seed determinism and moments."""
    import numpy as np
    gpu, host = mx.gpu(0), mx.cpu()
    # the detector sees a device-to-host read (so its silence below counts)
    probe = torch.ones(2, device=gpu.torch_device)
    with _profiler(torch) as prof:
        probe.sum().item()
    check(_host_syncs(prof), "the profile shows no copy for a .item() of a "
          "device value")
    cases = tensor_op_cases(*SWEEP_SHAPE)
    covered = {c["op"] for c in cases} | {s[0] for s in SAMPLERS}
    registered = {op.name for op in mx.ops.registry.OP_REGISTRY.values()
                  if op.fn.__module__ == "mxnet_tpu_torch.ops.tensor"}
    check(registered == covered, "ops of ops/tensor.py without a sweep case: "
          "%s" % sorted(registered - covered))
    runs = []
    for k, case in enumerate(cases):
        for dtype in case["dtypes"]:
            arrays = draw_tensor_inputs(case, dtype, seed + k)
            dts = input_dtypes(case, dtype)
            runs.append((case, dtype, [
                mx.nd.array(a, ctx=gpu, dtype=d) for a, d in zip(arrays,
                                                                 dts)], [
                mx.nd.array(a, ctx=host, dtype=d) for a, d in zip(arrays,
                                                                  dts)]))
    # the imperative sweep on the card, traced; results stay on the device
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _profiler(torch) as prof:
        card_out = [_nd_call(mx, case, dtype, ins, gpu)
                    for case, dtype, ins, _ in runs]
        torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    syncs = _host_syncs(prof)
    check(not syncs, "device-to-host copies in the op sweep: %s"
          % dict(syncs))
    bad = []
    for (case, dtype, _, cpu_ins), got in zip(runs, card_out):
        ref = _nd_call(mx, case, dtype, cpu_ins, host)
        check(len(ref) == len(got), tensor_case_id(case, dtype))
        for g, r in zip(got, ref):
            if g._data.dtype != r._data.dtype or g.context != gpu:
                bad.append("%s: dtype %s vs %s" % (
                    tensor_case_id(case, dtype), g._data.dtype,
                    r._data.dtype))
                continue
            exact = case["kind"] == "exact" or \
                not r._data.is_floating_point()
            half = dtype in HALF_TYPES or r._data.dtype in (
                torch.float16, torch.bfloat16)
            err = _sweep_error(np, g.asnumpy(), r.asnumpy(), exact, half)
            if err:
                bad.append("%s: %s" % (tensor_case_id(case, dtype), err))
    check(not bad, "op sweep, card vs CPU: %s" % "; ".join(bad[:20]))
    n_types = collections.Counter(dtype for _, dtype, _, _ in runs)
    log("tensor ops: %d ops (%d cases) x dtypes = %d imperative runs on the "
        "card (%s), all agree with the CPU path (exact for integer, "
        "comparison, logic, indexing and ordering results; float32 within "
        "%g, half types within %g x max |cpu|); sweep %.2f s traced, %d "
        "device-to-host copies" % (
            len({c["op"] for c in cases}), len(cases), len(runs),
            ", ".join("%s %d" % kv for kv in sorted(n_types.items())),
            SWEEP_F32_REL_TOL, HALF_REL_TOL, sweep_s, sum(syncs.values())))
    # the differentiable ops through simple_bind, forward and backward
    bound = []
    for k, case in enumerate(cases):
        if not (case["grad"] and "float32" in case["dtypes"]
                and case["inputs"]):
            continue
        arrays = draw_tensor_inputs(case, "float32", seed + k + 1)
        ex_gpu, diff = _bind_case(mx, case, arrays, gpu)
        ex_cpu, _ = _bind_case(mx, case, arrays, host)
        shape = ex_cpu.forward()[0].shape
        head = np.random.RandomState(seed + 7).standard_normal(shape) \
            .astype(np.float32)
        bound.append((case, diff, ex_gpu, ex_cpu, head,
                      mx.nd.array(head, ctx=gpu)))
    torch.cuda.synchronize()
    with _profiler(torch) as prof:
        for case, diff, ex, _, _, head in bound:
            ex.forward(is_train=True)
            ex.backward(out_grads=[head])
        torch.cuda.synchronize()
    syncs = _host_syncs(prof)
    check(not syncs, "device-to-host copies in the bound sweep: %s"
          % dict(syncs))
    worst = (0.0, "")
    for case, diff, ex, ex_cpu, head, _ in bound:
        ex_cpu.forward(is_train=True)
        ex_cpu.backward(out_grads=[mx.nd.array(head, ctx=host)])
        what = tensor_case_id(case)
        err = _sweep_error(np, ex.outputs[0].asnumpy(),
                           ex_cpu.outputs[0].asnumpy(),
                           case["kind"] == "exact", False)
        check(err is None, "%s bound forward: %s" % (what, err))
        for nm in diff:
            g = ex.grad_dict[nm].asnumpy().astype(np.float64)
            r = ex_cpu.grad_dict[nm].asnumpy().astype(np.float64)
            den = float(np.linalg.norm(r))
            rel = float(np.linalg.norm(g - r)) / den if den > 0 else \
                float(np.linalg.norm(g))
            worst = max(worst, (rel, "%s %s" % (what, nm)))
    check(worst[0] <= GRAD_REL_L2, "bound sweep gradients: %s relative L2 "
          "%.3g (bound %g)" % (worst[1], worst[0], GRAD_REL_L2))
    log("tensor ops: %d differentiable cases bound on %s -> forward(is_train"
        "=True) -> backward(head), outputs and gradients against the CPU "
        "path: worst gradient relative L2 %.3g (%s, bound %g); no "
        "device-to-host copy" % (len(bound), gpu, worst[0], worst[1],
                                 GRAD_REL_L2))
    _check_samplers(torch, mx, seed, card)


def _check_samplers(torch, mx, seed, card):
    """Each sampler on the card: a seed gives the same draws, another seed
    others, and SAMPLER_DRAWS draws have the distribution's mean and
    variance within 5 standard errors; the sampling ops bound in a graph
    draw anew each forward."""
    gpu, n = mx.gpu(0), SAMPLER_DRAWS
    for op, attrs, mean, var in SAMPLERS:
        draws = []
        for s in (seed, seed, seed + 1):
            mx.random.seed(s)
            draws.append(getattr(mx.nd, op)(shape=(n,), ctx=gpu, **attrs)
                         ._data)
        check(draws[0].device == gpu.torch_device
              and torch.equal(draws[0], draws[1])
              and not torch.equal(draws[0], draws[2]),
              "%s: not determined by the seed" % op)
        x = draws[0].double()
        m, v = float(x.mean()), float(x.var(unbiased=False))
        m4 = float(((x - m) ** 4).mean())
        se_m, se_v = (var / n) ** 0.5, ((m4 - var ** 2) / n) ** 0.5
        log("sampler %s on the card: mean %.5f (expected %g, 5 SE %.2g), "
            "variance %.5f (expected %g, 5 SE %.2g) over %d draws" % (
                op, m, mean, 5 * se_m, v, var, 5 * se_v, n))
        check(abs(m - mean) <= 5 * se_m and abs(v - var) <= 5 * se_v,
              "%s: moments off" % op)
    net = mx.sym.var("x") + mx.sym.uniform(shape=(4, 8)) + \
        mx.sym.normal(shape=(4, 8))
    ex = net.simple_bind(gpu, grad_req="null", x=(4, 8))
    mx.random.seed(seed)
    first = ex.forward()[0].asnumpy()
    second = ex.forward()[0].asnumpy()
    mx.random.seed(seed)
    again = ex.forward()[0].asnumpy()
    import numpy as np
    check(not np.array_equal(first, second) and np.array_equal(first, again),
          "bound samplers: not fresh per forward or not seeded")


def _fgsm_ce(mx, probs, label):
    """The summed cross-entropy of softmax outputs, in NDArray ops."""
    return mx.nd.sum(-mx.nd.log(mx.nd.pick(probs, label, axis=1)))


def _profile_window(torch, run, steps):
    """``(wall ms, busy ms, kernels)`` of ``steps`` calls of ``run(i)``
    under torch.profiler (device busy time from the trace's kernels,
    copies and sets)."""
    build_dir = os.path.join(ROOT, "mxnet_tpu_torch", "_build")
    os.makedirs(build_dir, exist_ok=True)
    fd, path = tempfile.mkstemp(prefix="nd-trace-", suffix=".json",
                                dir=build_dir)
    os.close(fd)
    try:
        torch.cuda.synchronize()
        with _profiler(torch) as prof:
            t0 = time.perf_counter()
            for i in range(steps):
                run(i)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        prof.export_chrome_trace(path)
        busy_us, by_class, n_kernels, _, _ = _trace_classes(path, None)
    finally:
        os.remove(path)
    return wall_ms, busy_us / 1e3, n_kernels, by_class


def phase_fgsm_resnet(torch, mx, seed, card):
    """The adversary example's flow at ResNet-50 width on the card (see
    ``nd_paths``).  Returns the bn_act forward and backward launches of
    the attack batches."""
    import numpy as np
    ba = mx.kernels.bn_act
    gpu = mx.gpu(0)
    shape = (BATCH,) + IMAGE
    with mx.name.NameManager():
        symbol = mx.models.get_symbol("resnet-50", num_classes=1000,
                                      image_shape=IMAGE)
    w_args, w_aux = draw_weights(symbol, shape, seed)
    mod = mx.mod.Module(symbol, context=gpu)
    mod.bind(data_shapes=[("data", shape)],
             label_shapes=[("softmax_label", (BATCH,))],
             for_training=True, inputs_need_grad=True)
    mod.set_params({k: mx.nd.array(v, ctx=gpu) for k, v in w_args.items()},
                   {k: mx.nd.array(v, ctx=gpu) for k, v in w_aux.items()})
    rs = np.random.RandomState(seed + 91)
    n = FGSM_BATCHES + 1
    X = rs.uniform(0, 1, (n,) + shape).astype(np.float32)
    Y = rs.randint(0, 1000, (n, BATCH)).astype(np.float32)
    xs = [mx.nd.array(X[i], ctx=gpu) for i in range(n)]
    ys = [mx.nd.array(Y[i], ctx=gpu) for i in range(n)]

    def attack(x, label, stamps=None):
        """One attack batch; ``stamps`` (if given) gets the times after
        forward+backward, the perturbation and the second forward."""
        def mark():
            if stamps is not None:
                torch.cuda.synchronize()
                stamps.append(time.perf_counter())
        mark()
        mod.forward(mx.io.DataBatch([x], [label]), is_train=True)
        mod.backward()
        g = mod.get_input_grads()[0]
        probs = mod.get_outputs()[0]
        ce = _fgsm_ce(mx, probs, label)
        clean = mx.nd.mean(mx.nd.argmax(probs, axis=1) == label)
        mark()
        x_adv = mx.nd.clip(x + FGSM_EPS * mx.nd.sign(g), 0, 1)
        mark()
        # the second forward takes batch statistics too: the moving
        # statistics are drawn, not learned, and the gradient was taken
        # with batch statistics
        mod.forward(mx.io.DataBatch([x_adv], [label]), is_train=True)
        out = mod.get_outputs()[0]
        ce_adv = _fgsm_ce(mx, out, label)
        acc = mx.nd.mean(mx.nd.argmax(out, axis=1) == label).asscalar()
        mark()
        return g, x_adv, ce, ce_adv, clean, acc

    attack(xs[0], ys[0])                      # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rows, launches = [], [0, 0]
    for i in range(1, n):
        stamps = []
        # -- the main path: counts zeroed just before, read just after -----
        ba.LAUNCHES = 0
        ba.BWD_LAUNCHES = 0
        g, x_adv, ce, ce_adv, clean, acc = attack(xs[i], ys[i], stamps)
        counts = (ba.LAUNCHES, ba.BWD_LAUNCHES)
        # -------------------------------------------------------------------
        launches[0] += counts[0]
        launches[1] += counts[1]
        ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
        rows.append((sum(ms), ms, counts, float(ce.asscalar()),
                     float(ce_adv.asscalar()), float(clean.asscalar()), acc))
        if i == FGSM_AGREE_BATCH:
            agree = (X[i], Y[i], g.asnumpy(), x_adv.asnumpy())
    peak = torch.cuda.max_memory_allocated()
    for i, (total, ms, counts, ce, ce_adv, clean, acc) in enumerate(rows, 1):
        log("fgsm batch %d: %.2f ms (forward+backward %.2f, perturbation "
            "%.2f, second forward %.2f); bn_act launches %d forward / %d "
            "backward; cross-entropy %.2f -> %.2f on x_adv; accuracy %.4f "
            "-> %.4f; on %s" % (i, total, ms[0], ms[1], ms[2], counts[0],
                                counts[1], ce, ce_adv, clean, acc, card))
        check(counts == (100, 50), "fgsm batch %d: bn_act launches %s, "
              "expected 50 + 50 forward (two training forwards) and 50 "
              "backward" % (i, counts))
        check(np.isfinite(ce) and ce_adv > ce,
              "fgsm batch %d: the cross-entropy did not rise (%.4f -> %.4f)"
              % (i, ce, ce_adv))
    med = sorted(r[0] for r in rows)[len(rows) // 2]
    log("fgsm: median %.2f ms per attack batch at batch %d (eps %g), peak "
        "memory %.2f GiB (max_memory_allocated), on %s" % (
            med, BATCH, FGSM_EPS, peak / 2 ** 30, card))
    wall, busy, kernels, by_class = _profile_window(
        torch, lambda i: attack(xs[1 + i % FGSM_BATCHES],
                                ys[1 + i % FGSM_BATCHES]), PROFILE_STEPS)
    log("fgsm profile: %d attack batches, wall %.2f ms, device busy %.2f ms, "
        "idle share %.3f, %.1f kernels per batch, on %s" % (
            PROFILE_STEPS, wall, busy, 1 - busy / wall,
            kernels / PROFILE_STEPS, card))
    for cls, us in by_class.most_common(6):
        log("fgsm profile: class %-20s %8.3f ms/batch" % (
            cls, us / 1e3 / PROFILE_STEPS))
    check(by_class.get("bn_act_fwd", 0) > 0 and
          by_class.get("bn_act_bwd", 0) > 0, "fgsm profile: no bn_act time")
    # the input gradient of one attack batch's first AGREE_BATCH rows from
    # the timed Module itself, reshaped to that batch (the agreement batch
    # of every other training gate here; at batch 32 the two CPU runs took
    # 40 s of the smoke on the H100's host), against the CPU at that batch
    x_np, y_np, g_main, x_adv_card = agree
    x4, y4 = x_np[:AGREE_BATCH], y_np[:AGREE_BATCH]
    mod.reshape([("data", (AGREE_BATCH,) + IMAGE)],
                [("softmax_label", (AGREE_BATCH,))])
    mod.forward(mx.io.DataBatch([mx.nd.array(x4, ctx=gpu)],
                                [mx.nd.array(y4, ctx=gpu)]), is_train=True)
    mod.backward()
    g_card = mod.get_input_grads()[0].asnumpy()
    del mod, xs, ys
    gc.collect()
    torch.cuda.empty_cache()
    host = mx.cpu()
    weights = (w_args, w_aux)
    g32 = _executor_step(mx, symbol, weights, x4, y4, host)["grad:data"]
    g64 = _executor_step(mx, symbol, weights, x4.astype(np.float64),
                         y4.astype(np.float64), host)["grad:data"]
    keys = ["g"]
    cpu_l2 = _rel_l2(np, {"g": g32}, {"g": g64}, keys)
    card_l2 = _rel_l2(np, {"g": g_card.astype(np.float64)}, {"g": g64}, keys)
    bound = max(AGREE_REL_TOL, GRAD_L2_FACTOR * cpu_l2)
    top = np.abs(g64).max()
    flips = {}
    for floor in (FGSM_SIGN_FLOOR, 1e-2, 1e-1):
        decided = np.abs(g64) > floor * top
        flips[floor] = tuple(
            int((np.sign(g)[decided] != np.sign(g64)[decided]).sum())
            for g in (g_card, g32)) + (int(decided.sum()),)
    log("fgsm batch %d, its first %d rows: input gradient vs the float64 "
        "CPU run: relative L2 %.3g (bound %.3g; CPU float32 %.3g); sign "
        "flips where |g| > floor x max |g|, card / CPU float32 of "
        "elements: %s" % (
            FGSM_AGREE_BATCH, AGREE_BATCH, card_l2, bound, cpu_l2, ", ".join(
                "%g: %d / %d of %d" % ((f,) + flips[f]) for f in flips)))
    check(card_l2 <= bound, "fgsm input gradient disagrees with the CPU")
    # float32 itself flips signs against float64 here (ReLU masks that
    # flip under another summation order), so the card is held to the
    # CPU float32 path's count, as its relative L2 is
    card_flips, cpu_flips, _ = flips[FGSM_SIGN_FLOOR]
    check(card_flips <= GRAD_L2_FACTOR * max(cpu_flips, 1),
          "fgsm: %d input-gradient signs differ from float64 (CPU float32: "
          "%d)" % (card_flips, cpu_flips))
    # the perturbation in NDArray ops on the card is exactly the float32
    # arithmetic of the card's own gradient signs
    x_adv_ref = np.clip(x_np + np.float32(FGSM_EPS) * np.sign(g_main), 0, 1)
    check(np.array_equal(x_adv_card, x_adv_ref),
          "fgsm: x_adv is not clip(x + eps sign(g), 0, 1) of the card's g")
    return launches


def _optimizer_run(mx, name, params, shape, seed, ctx):
    """Two updates of optimizer ``name`` on ``ctx`` from seeded weights
    and gradients: the weight after them (numpy)."""
    import numpy as np
    rs = np.random.RandomState(seed)
    w0 = rs.standard_normal(shape).astype(np.float32)
    grads = [(rs.standard_normal(shape) * 2).astype(np.float32)
             for _ in range(2)]
    opt = mx.optimizer.create(name, learning_rate=0.1, wd=0.01,
                              clip_gradient=1.5, rescale_grad=0.5,
                              param_idx2name={0: "fc_weight"}, **params)
    upd = mx.optimizer.get_updater(opt)
    w = mx.nd.array(w0, ctx=ctx)
    for g in grads:
        upd(0, mx.nd.array(g, ctx=ctx), w)
    return w0, grads, w.asnumpy()


def phase_nd_optimizers(torch, mx, seed, card):
    """Each optimizer written in NDArray arithmetic takes two updates on
    the card and on the CPU from the same weights and gradients: NAG,
    DCASGD and Test equal bit for bit in float32; AdaGrad and AdaDelta,
    which take a square root, within the sweep's float32 tolerance
    (SWEEP_F32_REL_TOL x max |cpu|: the host's float32 ``torch.sqrt`` is
    not correctly rounded, the card's is, both counted here); SGLD by its
    noise's moments."""
    import numpy as np
    gpu, host = mx.gpu(0), mx.cpu()
    v = torch.from_numpy(np.random.RandomState(seed).uniform(
        0.5, 4.0, 1 << 20).astype(np.float32))
    rounded = torch.sqrt(v.double()).float()
    off = [int((torch.sqrt(x).cpu() != rounded).sum())
           for x in (v, v.to(gpu.torch_device))]
    log("float32 torch.sqrt of %d values in [0.5, 4): %d (host) / %d (card) "
        "not correctly rounded, on %s" % (v.numel(), off[0], off[1], card))
    for name, params in (("nag", {"momentum": NAG_MOMENTUM}),
                         ("adagrad", {}), ("adadelta", {}),
                         ("dcasgd", {"momentum": 0.9}), ("test", {})):
        _, _, w_gpu = _optimizer_run(mx, name, params, OPT_SHAPE, seed, gpu)
        _, _, w_cpu = _optimizer_run(mx, name, params, OPT_SHAPE, seed, host)
        diff = np.abs(w_gpu.astype(np.float64) - w_cpu)
        ulps = int(np.max(diff / np.spacing(np.abs(w_cpu))))
        rel = float(diff.max() / np.abs(w_cpu).max())
        exact = name not in ("adagrad", "adadelta")
        log("optimizer %s: 2 updates at %s on the card vs the CPU: max "
            "|diff| %.3g of max |cpu| (%d ulp of the weight; %s)" % (
                name, OPT_SHAPE, rel, ulps, "exact expected" if exact else
                "bound %g" % SWEEP_F32_REL_TOL))
        check(ulps == 0 if exact else rel <= SWEEP_F32_REL_TOL,
              "optimizer %s: card and CPU differ (%.3g, %d ulp)"
              % (name, rel, ulps))
    n, lr = SAMPLER_DRAWS, 0.1
    mx.random.seed(seed)
    w0, grads, w = _optimizer_run(mx, "sgld", {}, (n,), seed, gpu)
    # the drift of the two updates, less the noise, on the host in float64
    ref = w0.astype(np.float64)
    wd = 0.01
    for g in grads:
        ref = ref - lr / 2 * (np.clip(g * 0.5, -1.5, 1.5) + wd * ref)
    noise = w.astype(np.float64) - ref
    # two draws of N(0, lr), the first shrunk by the second's (1 - lr wd/2)
    var = lr * (1 + (1 - lr * wd / 2) ** 2)
    log("optimizer sgld: 2 updates of %d weights on the card: noise mean "
        "%.3g (5 SE %.2g), variance %.5f (expected %.5f, 5 SE %.2g)" % (
            n, noise.mean(), 5 * (var / n) ** 0.5, noise.var(), var,
            5 * var * (2.0 / n) ** 0.5))
    check(abs(noise.mean()) <= 5 * (var / n) ** 0.5 and
          abs(noise.var() - var) <= 5 * var * (2.0 / n) ** 0.5,
          "sgld noise moments")


def phase_nd_dispatch(torch, mx, seed, card):
    """The NDArray layer's host cost: median microseconds per call over
    DISPATCH_REPS x DISPATCH_CALLS calls on the card, beside the same
    torch call."""
    import numpy as np
    gpu = mx.gpu(0)
    rs = np.random.RandomState(seed)
    a = mx.nd.array(rs.standard_normal(DISPATCH_SHAPE), ctx=gpu)
    b = mx.nd.array(rs.standard_normal(DISPATCH_SHAPE), ctx=gpu)
    ta, tb = a._data.clone(), b._data.clone()
    held = {"a": a, "t": ta}

    def nd_isub():
        x = held["a"]
        x -= b

    def t_isub():
        x = held["t"]
        x -= tb

    pairs = (("a + b", lambda: a + b, lambda: ta + tb),
             ("a * 2.0", lambda: a * 2.0, lambda: ta * 2.0),
             ("a -= b", nd_isub, t_isub),
             ("mx.nd.sum(a, axis=1)", lambda: mx.nd.sum(a, axis=1),
              lambda: torch.sum(ta, dim=1)),
             ("a[1:3]", lambda: a[1:3], lambda: ta[1:3]),
             ("mx.nd.topk(a, k=5)", lambda: mx.nd.topk(a, k=5),
              lambda: torch.topk(ta, 5)))

    def per_call_us(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DISPATCH_CALLS):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / DISPATCH_CALLS * 1e6

    for label, nd_fn, t_fn in pairs:
        per_call_us(nd_fn)              # warm-up
        per_call_us(t_fn)
        nd_us, t_us = [], []
        for _ in range(DISPATCH_REPS):
            nd_us.append(per_call_us(nd_fn))
            t_us.append(per_call_us(t_fn))
        nd_med = sorted(nd_us)[DISPATCH_REPS // 2]
        t_med = sorted(t_us)[DISPATCH_REPS // 2]
        log("dispatch %-22s NDArray %7.2f us/call, torch %7.2f us/call "
            "(median of %d x %d calls at %s float32), on %s" % (
                label, nd_med, t_med, DISPATCH_REPS, DISPATCH_CALLS,
                DISPATCH_SHAPE, card))


def nd_paths(torch, mx, seed, card):
    """The tensor-op sweep, the FGSM attack on ResNet-50 (one warm-up and
    FGSM_BATCHES attack batches of forward(is_train=True) -> backward ->
    get_input_grads -> clip(x + eps sign(g), 0, 1) -> forward -> accuracy,
    all NDArray ops on the card), the optimizers' single steps and the
    dispatch cost.  Returns the bn_act launches of the attack batches."""
    phase_tensor_ops(torch, mx, seed, card)
    fwd, bwd = phase_fgsm_resnet(torch, mx, seed, card)
    gc.collect()
    torch.cuda.empty_cache()
    phase_nd_optimizers(torch, mx, seed, card)
    phase_nd_dispatch(torch, mx, seed, card)
    return collections.Counter({"bn_act_fwd": fwd, "bn_act_bwd": bwd})


# ---------------------------------------------------------------------------
# the bucketed LSTM language model of example/rnn/lstm_bucketing.py through
# BucketingModule.fit, on both of its stacks
# ---------------------------------------------------------------------------

# the example's defaults (lstm_bucketing.py:28-60, :98-101): the LM's
# widths (LM_LAYERS, LM_HIDDEN, LM_EMBED, LM_BATCH), six buckets, invalid
# label 0, sgd with lr 0.01, momentum 0 and wd 1e-5, Xavier(in, 2.34),
# Perplexity(0), kvstore 'local'; the example's synthetic Markov corpus
# (its fallback without the PTB files) at PTB's vocabulary, LM_VOCAB,
# 2000 training and 200 validation sentences as the example draws them;
# cut: 2 epochs of 25
BK_BUCKETS = (10, 20, 30, 40, 50, 60)
BK_INVALID = 0
BK_SENTENCES = (2000, 200)
BK_EPOCHS = 2
BK_OPT = {"learning_rate": 0.01, "momentum": 0.0, "wd": 0.00001}
BK_AGREE_BUCKETS = (10, 60)   # the buckets of the GPU-vs-CPU check
BK_SWITCH_UPDATES = 2         # updates in one bucket before the switch check
BK_PROFILE_BUCKET = 30


def synthetic_corpus(n_sent, vocab_size=200, seed=0):
    """Markov-chain sentences of 5 to 59 tokens, each token's successor
    one of 4 fixed ones 9 times in 10: a copy of
    example/rnn/lstm_bucketing.py:64-92 (the example imports the JAX
    package, so it cannot be imported here).  The transition table has
    its own fixed seed; ``seed`` picks the sentences."""
    import numpy as np
    rs = np.random.RandomState(seed)
    succ = np.random.RandomState(1234).randint(
        1, vocab_size, size=(vocab_size, 4))
    sentences = []
    for _ in range(n_sent):
        length = rs.randint(5, 60)
        tok = rs.randint(1, vocab_size)
        sent = [tok]
        for _ in range(length - 1):
            if rs.rand() < 0.9:
                tok = succ[tok][rs.randint(4)]
            else:
                tok = rs.randint(1, vocab_size)
            sent.append(tok)
        sentences.append(sent)
    return sentences


def bk_sym_gen(mx, stack):
    """The example's ``sym_gen``: Embedding -> the stack unrolled over the
    bucket's length -> FullyConnected -> SoftmaxOutput."""
    def sym_gen(seq_len):
        return _lm_head(mx, stack, seq_len), ("data",), ("softmax_label",)
    return sym_gen


class StampedIter(object):
    """An iterator over ``inner``'s batches that stamps the host clock as
    it hands each one out, so a batch-end callback can time the batch
    (forward, backward, update and the metric's read)."""

    def __init__(self, inner):
        self.inner = inner
        self.stamp = None
        self.provide_data = inner.provide_data
        self.provide_label = inner.provide_label
        self.default_bucket_key = inner.default_bucket_key

    def __iter__(self):
        return self

    def __next__(self):
        batch = self.inner.next()
        self.stamp = time.perf_counter()
        return batch

    next = __next__

    def reset(self):
        self.inner.reset()


def _lstm_vec(lc):
    """The LSTM launch counters as one tuple (see LSTM_COUNTERS)."""
    return tuple(getattr(lc, name) for name in LSTM_COUNTERS)


def bk_expected(fused, T, train):
    """LSTM launches of one batch of bucket T, in LSTM_COUNTERS order: the
    unrolled stack launches the cell forward 2T times (and the backward
    2T in training), the fused one the persistent recurrence twice (one a
    layer; its forward writes gate residuals only in training)."""
    if fused:
        n = LM_LAYERS
        return (0, 0, n, n if train else 0, n if train else 0)
    n = LM_LAYERS * T
    return (n, n if train else 0, 0, 0, 0)


def bk_batches(mx, sentences, seed):
    """A fresh shuffle's batches of the training sentences, by bucket."""
    import random
    import numpy as np
    random.seed(seed)
    np.random.seed(seed)
    it = mx.rnn.BucketSentenceIter(sentences, LM_BATCH,
                                   buckets=list(BK_BUCKETS),
                                   invalid_label=BK_INVALID)
    out = collections.defaultdict(list)
    for batch in it:
        out[batch.bucket_key].append(batch)
    return out


def phase_bucketing_fit(torch, mx, seed, card, fused, corpus):
    """The main path of one stack: ``BucketingModule.fit`` over
    BK_EPOCHS epochs of the training sentences with the validation
    sentences as ``eval_data``, as the example runs it.  Every batch's
    LSTM launches are exact for its bucket, every bucket is visited, the
    running loss stays finite, validation perplexity falls from epoch 1 to
    epoch 2 and every parameter moves.  Returns the module, the counts
    and the numbers reported."""
    import random
    import numpy as np
    lc = mx.kernels.lstm_cell
    what = "bucketing %s stack" % ("fused" if fused else "unrolled")
    random.seed(seed)
    np.random.seed(seed)          # the iterators shuffle with these
    train = StampedIter(mx.rnn.BucketSentenceIter(
        corpus[0], LM_BATCH, buckets=list(BK_BUCKETS),
        invalid_label=BK_INVALID))
    val = mx.rnn.BucketSentenceIter(corpus[1], LM_BATCH,
                                    buckets=list(BK_BUCKETS),
                                    invalid_label=BK_INVALID)
    sym_gen = bk_sym_gen(mx, lm_stack(mx, fused))
    mod = mx.mod.BucketingModule(sym_gen, context=mx.gpu(0),
                                 default_bucket_key=train.default_bucket_key)
    init = mx.initializer.Xavier(factor_type="in", magnitude=2.34)
    mx.random.seed(seed)
    # fit binds and initializes as below; done first to keep the start
    mod.bind(train.provide_data, train.provide_label)
    mod.init_params(init)
    start = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    train_rows, val_rows, val_ppl, bad = [], [], [], []
    last = [None]

    def delta():
        now = _lstm_vec(lc)
        d = tuple(a - b for a, b in zip(now, last[0]))
        last[0] = now
        return d

    def on_batch(param):
        t = time.perf_counter()
        batch = param.locals["data_batch"]
        loss = param.eval_metric.sum_metric
        if not np.isfinite(loss):
            bad.append((param.epoch, param.nbatch, loss))
        train_rows.append((param.epoch, batch.bucket_key,
                           (t - train.stamp) * 1e3, delta()))

    def on_val_batch(param):
        val_rows.append((param.epoch, param.locals["eval_batch"].bucket_key,
                         delta()))

    def on_val_end(param):
        val_ppl.append(param.eval_metric.get()[1])

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # -- the main path: counts zeroed just before, read just after ---------
    zero_lstm_counts(lc)
    last[0] = _lstm_vec(lc)
    t0 = time.perf_counter()
    mod.fit(train, eval_data=val,
            eval_metric=mx.metric.Perplexity(BK_INVALID), kvstore="local",
            optimizer="sgd", optimizer_params=dict(BK_OPT),
            initializer=init, num_epoch=BK_EPOCHS,
            batch_end_callback=on_batch,
            eval_batch_end_callback=on_val_batch,
            eval_end_callback=on_val_end)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = lstm_counts(lc)
    # ----------------------------------------------------------------------
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    total = [0] * len(LSTM_COUNTERS)
    for rows, train_mode in ((train_rows, True), (val_rows, False)):
        for row in rows:
            T, got = row[1], row[-1]
            want = bk_expected(fused, T, train_mode)
            check(got == want, "%s: a %s batch of bucket %d launched %s "
                  "(%s), expected %s" % (what, "training" if train_mode
                                         else "validation", T, got,
                                         ", ".join(LSTM_COUNTERS), want))
            total = [a + b for a, b in zip(total, got)]
    check(tuple(total) == _lstm_vec(lc), "%s: launches outside the "
          "batches: %s against %s" % (what, _lstm_vec(lc), total))
    visited = sorted({row[1] for row in train_rows})
    check(visited == list(BK_BUCKETS), "%s visited buckets %s" % (what,
                                                                visited))
    check(not bad, "%s: non-finite loss at %s" % (what, bad[:3]))
    check(len(val_ppl) == BK_EPOCHS and all(np.isfinite(val_ppl)),
          "%s: validation perplexity %s" % (what, val_ppl))
    check(val_ppl[1] < val_ppl[0], "%s: validation perplexity did not fall "
          "from epoch 1 to epoch 2: %s" % (what, val_ppl))
    end = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    frozen = [k for k in start if np.array_equal(start[k], end[k])
              or not np.isfinite(end[k]).all()]
    check(not frozen, "%s: parameters that did not move or are not "
          "finite: %s" % (what, frozen))
    # steady: every batch but each bucket's first (its bind)
    first = {}
    for i, row in enumerate(train_rows):
        first.setdefault(row[1], i)
    by_bucket = collections.defaultdict(list)
    for i, row in enumerate(train_rows):
        if i not in first.values():
            by_bucket[row[1]].append(row[2])
    steady_ms = sum(sum(v) for v in by_bucket.values())
    tokens = sum(LM_BATCH * T * len(v) for T, v in by_bucket.items())
    log("%s: %d training batches over %d epochs (%s a bucket), %d "
        "validation batches; LSTM launches %s; every batch's launches "
        "exact for its bucket; validation perplexity by epoch %s; fit wall "
        "%.2f s; peak memory %.3f GiB on %s" % (
            what, len(train_rows), BK_EPOCHS,
            "/".join(str(sum(1 for r in train_rows if r[1] == T))
                     for T in BK_BUCKETS), len(val_rows), counts,
            " -> ".join("%.2f" % p for p in val_ppl), wall, peak, card))
    log("%s: steady ms per batch by bucket (median, mean over n, each "
        "bucket's first batch left out): %s; %.0f tokens/s over the steady "
        "batches; first (bind) batch ms: %s; on %s" % (
            what, ", ".join("T=%d %.2f / %.2f (n=%d)" % (
                T, sorted(v)[len(v) // 2], sum(v) / len(v), len(v))
                for T, v in sorted(by_bucket.items())),
            tokens / (steady_ms / 1e3),
            ", ".join("T=%d %.1f" % (train_rows[i][1], train_rows[i][2])
                      for i in sorted(first.values())), card))
    return {"mod": mod, "sym_gen": sym_gen, "counts": counts,
            "val_ppl": val_ppl, "wall": wall, "peak": peak}


def phase_bucket_switch(torch, mx, run, batches, what):
    """Weights shared across buckets: after BK_SWITCH_UPDATES updates taken
    in bucket 60, bucket 10's executor computes what a fresh Module of
    bucket 10 given ``get_params()`` computes, and not what it computed
    before the updates."""
    import numpy as np
    mod = run["mod"]
    short, long_ = batches[min(BK_BUCKETS)][0], batches[max(BK_BUCKETS)][0]
    mod.forward(short, is_train=False)
    before = mod.get_outputs()[0].asnumpy()
    for _ in range(BK_SWITCH_UPDATES):
        mod.forward_backward(long_)
        mod.update()
    mod.forward(short, is_train=False)
    after = mod.get_outputs()[0].asnumpy()
    args, aux = mod.get_params()
    sym, data_names, label_names = run["sym_gen"](min(BK_BUCKETS))
    fresh = mx.mod.Module(sym, data_names, label_names, context=mx.gpu(0))
    fresh.bind(short.provide_data, short.provide_label, for_training=False)
    fresh.set_params(args, aux)
    fresh.forward(short, is_train=False)
    ref = fresh.get_outputs()[0].asnumpy()
    moved = float(np.abs(after - before).max())
    err = float(np.abs(after - ref).max()) / float(np.abs(ref).max())
    log("%s: after %d updates in bucket %d, bucket %d's executor against "
        "a fresh Module given get_params(): max |diff| / max |fresh| %.3g "
        "(bound 1e-6; bit-equal: %s); its outputs moved by %.3g since "
        "before the updates" % (what, BK_SWITCH_UPDATES, max(BK_BUCKETS),
                                min(BK_BUCKETS), err,
                                np.array_equal(after, ref), moved))
    check(moved > 0, what + ": the updates did not reach bucket 10")
    check(err <= 1e-6, what + ": bucket 10 computes with stale weights")


def _bk_weights(run, seed):
    """Seeded numpy weights of the default bucket's parameters (uniform,
    about Xavier's scale)."""
    import numpy as np
    sym, _, _ = run["sym_gen"](max(BK_BUCKETS))
    shape = (LM_BATCH, max(BK_BUCKETS))
    arg_shapes, _, _ = sym.infer_shape(data=shape, softmax_label=shape)
    rs = np.random.RandomState(seed)
    return {n: rs.uniform(-0.1, 0.1, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}


def phase_bucketing_agreement(torch, mx, seed, run, batches, fused, what):
    """One training forward/backward of a batch of bucket 10 and one of
    bucket 60 through a BucketingModule on the card (no update), against
    the port's CPU path: outputs against its float32 run, gradients in
    relative L2 against its float64 run (see _compare_train)."""
    import numpy as np
    lc = mx.kernels.lstm_cell
    weights = _bk_weights(run, seed + 70)
    mod = mx.mod.BucketingModule(run["sym_gen"], context=mx.gpu(0),
                                 default_bucket_key=max(BK_BUCKETS))
    shape = (LM_BATCH, max(BK_BUCKETS))
    mod.bind([("data", shape)], [("softmax_label", shape)])
    mod.init_params(arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                                for k, v in weights.items()})
    for T in BK_AGREE_BUCKETS:
        batch = batches[T][0]
        zero_lstm_counts(lc)
        mod.forward_backward(batch)
        got = {"output": mod.get_outputs()[0].asnumpy().astype(np.float64)}
        grads = mod._curr_module._exec_group.execs[0].grad_dict
        got.update({"grad:" + k: grads[k].asnumpy().astype(np.float64)
                    for k in weights})
        check(_lstm_vec(lc) == bk_expected(fused, T, True),
              "%s agreement: bucket %d launched %s" % (what, T,
                                                       _lstm_vec(lc)))
        sym = run["sym_gen"](T)[0]
        x, y = batch.data[0].asnumpy(), batch.label[0].asnumpy()
        ref = _executor_step(mx, sym, (weights, {}), x, y, mx.cpu())
        exact = _executor_step(mx, sym, (weights, {}), x.astype(np.float64),
                               y.astype(np.float64), mx.cpu())
        ref = {k: ref[k] for k in got}
        exact = {k: exact[k] for k in got}
        g_keys = [k for k in got if k.startswith("grad:")]
        _compare_train(np, got, ref, exact, _rel_l2(np, ref, exact, g_keys),
                       "%s gpu vs cpu, bucket %d (batch %d)" % (what, T,
                                                                LM_BATCH))


class CopyCounter(object):
    """Copies between devices while entered, over the aten calls of a
    ``TorchDispatchMode`` (autograd's backward runs under it too):
    ``bytes`` and ``count``, Counters keyed ``src->dst`` (``cpu->cuda:0``,
    ``cuda:0->cpu``).  A copy is a call named ``*copy*`` whose result lies
    on another device than one of its inputs, counted at the result's
    bytes; a scalar read of a card value (``.item()``) counts as a copy of
    its one element to the host."""

    def __init__(self, torch):
        from torch.utils._python_dispatch import TorchDispatchMode
        self.bytes = collections.Counter()
        self.count = collections.Counter()
        nbytes, count = self.bytes, self.count

        def record(src, dst, n):
            key = "%s->%s" % (src, dst)
            nbytes[key] += n
            count[key] += 1

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                name = str(func)
                ins = [a for a in args if isinstance(a, torch.Tensor)]
                if "_local_scalar_dense" in name and ins and ins[0].is_cuda:
                    record(ins[0].device, "cpu", ins[0].element_size())
                elif "copy" in name and isinstance(out, torch.Tensor):
                    src = [t for t in ins if t.device != out.device]
                    if src:
                        record(src[0].device, out.device,
                               out.numel() * out.element_size())
                return out
        self.mode = Mode()

    def __enter__(self):
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)

    def dtoh(self):
        """``(count, bytes)`` of the copies from the card to the host."""
        keys = [k for k in self.bytes
                if k.startswith("cuda") and k.endswith("->cpu")]
        return (sum(self.count[k] for k in keys),
                sum(self.bytes[k] for k in keys))


def dtoh_bytes(torch, fn):
    """Bytes copied from the card to the host while ``fn()`` runs, two
    ways: ``(ops, trace)``.  ``ops`` is a CopyCounter's sum of the copies
    whose source lies on the card and whose result lies on the host, and
    of the scalar reads of card values; ``trace`` sums the memcpy events
    of a torch.profiler trace of the same call (None when it holds none:
    a trace in a process that ran many before it can miss them)."""
    copies = CopyCounter(torch)
    torch.cuda.synchronize()
    build_dir = os.path.join(ROOT, "mxnet_tpu_torch", "_build")
    os.makedirs(build_dir, exist_ok=True)
    fd, path = tempfile.mkstemp(prefix="copy-trace-", suffix=".json",
                                dir=build_dir)
    os.close(fd)
    try:
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            with copies:
                fn()
            torch.cuda.synchronize()
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    sizes = [int((e.get("args") or {}).get("bytes", 0)) for e in events
             if e.get("cat") == "gpu_memcpy" and "DtoH" in e.get("name", "")]
    return copies.dtoh()[1], (sum(sizes) if sizes else None)


def phase_perplexity_copy(torch, mx, run, batches, what):
    """One ``update_metric`` of Perplexity after a bucket-60 forward on the
    card copies the picked probabilities (T x batch floats) and, were
    they on the card, the labels to the host, not the (T x batch, vocab)
    output; its value equals the host formula on the whole output."""
    import numpy as np
    probe = torch.ones(12345, device="cuda")
    seen = dtoh_bytes(torch, lambda: probe.cpu())
    check(seen[0] == 4 * 12345 and seen[1] in (None, 4 * 12345),
          "the copy counters read %s bytes for a copy of %d"
          % (seen, 4 * 12345))
    mod = run["mod"]
    batch = batches[max(BK_BUCKETS)][0]
    mod.forward(batch, is_train=False)
    metric = mx.metric.Perplexity(BK_INVALID)
    copied, traced = dtoh_bytes(
        torch, lambda: mod.update_metric(metric, batch.label))
    T, label = max(BK_BUCKETS), batch.label[0]
    on_card = label.context != mx.cpu()
    allowed = LM_BATCH * T * 4 + (label.size * 4 if on_card else 0)
    log("%s: one Perplexity update_metric at bucket %d copied %d bytes to "
        "the host (the trace's memcpy events: %s; bound %d: %d picked "
        "float32 probabilities, labels %s; the whole output is %d bytes)"
        % (what, T, copied, traced, allowed, LM_BATCH * T,
           "on the card" if on_card else "on the host",
           LM_BATCH * T * LM_VOCAB * 4))
    check(0 < copied <= allowed and (traced is None or traced <= allowed),
          "%s: update_metric copied %s bytes (trace: %s)" % (what, copied,
                                                             traced))
    pred = mod.get_outputs()[0].asnumpy()
    flat = label.asnumpy().reshape(-1).astype("int32")
    probs = pred[np.arange(flat.size), flat]
    ignore = flat == BK_INVALID
    probs = np.where(ignore, 1.0, probs)
    loss = -np.sum(np.log(np.maximum(1e-10, probs)))
    check(metric.sum_metric == loss
          and metric.num_inst == flat.size - ignore.sum(),
          what + ": the device pick's perplexity differs from the host "
          "formula")


def phase_bucketing_profile(torch, mx, run, batches, card, fused, what):
    """A torch.profiler trace of PROFILE_STEPS batches of bucket
    BK_PROFILE_BUCKET (forward_backward, the update in its own range,
    update_metric), as fit runs them."""
    mod = run["mod"]
    plan = batches[BK_PROFILE_BUCKET][:PROFILE_STEPS]
    metric = mx.metric.Perplexity(BK_INVALID)
    mod.forward_backward(plan[0])     # the bucket is bound and warm
    mod.update()

    def one(i):
        batch = plan[i % len(plan)]
        mod.forward_backward(batch)
        with torch.profiler.record_function("Module.update"):
            mod.update()
        mod.update_metric(metric, batch.label)

    need = ("lstm_seq_fwd", "lstm_seq_bwd") if fused else (
        "lstm_cell_fwd", "lstm_cell_bwd")
    profile_steps(torch, one, lambda: None, "Module.update", card,
                  "%s fit" % what, need, "batch %d x %d tokens"
                  % (LM_BATCH, BK_PROFILE_BUCKET))


def bucketing_paths(torch, mx, seed, card):
    """The bucketed LSTM LM of example/rnn/lstm_bucketing.py through
    BucketingModule.fit, on the unrolled stack (LSTMCells: lstm_cell
    kernels) and then on FusedRNNCell (the persistent lstm_seq kernels),
    each followed by the cross-bucket weight check, the Perplexity copy
    trace, a profile and the card-vs-CPU check at buckets 10 and 60.
    Returns the main paths' launches by kernel."""
    corpus = (synthetic_corpus(BK_SENTENCES[0], LM_VOCAB, seed),
              synthetic_corpus(BK_SENTENCES[1], LM_VOCAB, seed + 1))
    launched = collections.Counter()
    for fused in (False, True):
        what = "bucketing %s stack" % ("fused" if fused else "unrolled")
        run = phase_bucketing_fit(torch, mx, seed, card, fused, corpus)
        c = run["counts"]
        launched.update({"lstm_cell_fwd": c["cell"][0],
                         "lstm_cell_bwd": c["cell"][1],
                         "lstm_seq_fwd": c["seq"][0],
                         "lstm_seq_bwd": c["seq"][1]})
        batches = bk_batches(mx, corpus[0], seed + 80)
        phase_bucket_switch(torch, mx, run, batches, what)
        phase_perplexity_copy(torch, mx, run, batches, what)
        phase_bucketing_profile(torch, mx, run, batches, card, fused, what)
        phase_bucketing_agreement(torch, mx, seed, run, batches, fused, what)
        del run
        gc.collect()
        torch.cuda.empty_cache()
    return launched


# ---------------------------------------------------------------------------
# the image-classification zoo: the plan passes' report, Inception-BN
# served and trained through every pass, the pooling gate, the other zoo
# models served, the ResNet-50 liveness repair, and the ops of ops/nn.py
# ---------------------------------------------------------------------------

#: every other zoo model at its published input size and class count,
#: served at batch 32 (ResNet-50 has its own phases above)
ZOO_MODELS = (("lenet", (1, 28, 28), 10), ("mlp", (1, 28, 28), 10),
              ("alexnet", IMAGE, 1000), ("vgg16", IMAGE, 1000),
              ("googlenet", IMAGE, 1000), ("mobilenet", IMAGE, 1000),
              ("resnext-50", IMAGE, 1000),
              ("inception-v3", (3, 299, 299), 1000))
ZOO_TURN_FORWARDS = 1   # batch-32 forwards in each of a model's 4 turns
IBN_FORWARDS = 8        # Inception-BN batch-32 requests on the main path
IBN_TRAIN_STEPS = 4     # distinct seeded batches, then IBN_FIXED_STEPS
IBN_FIXED_STEPS = 6
IBN_TURN_STEPS = 3      # steps in each turn of fused against unfused
IBN_AGREE_BATCH = AGREE_BATCH
ZOO_AGREE_BATCH = 1
REPAIR_TURN_FORWARDS = 4
#: Fused against MXTPU_FUSED_KERNELS=0 logits on the card, every zoo model:
#: within 1e-3 x max |logit| with the same argmax (compare_logits, the CPU
#: agreement's bound).  Both plans run float32 with TF32 off; they differ
#: by summation order only: a bn_fold site runs its conv on folded weights,
#: and a concat_fuse group runs one wider (or grouped) convolution, for
#: which cuDNN may pick another algorithm than for its members, so the
#: merge is not bitwise on the card (it is on the CPU for grouped merges).


@contextlib.contextmanager
def fused_kernels(value):
    """``MXTPU_FUSED_KERNELS=value`` while graphs are bound inside."""
    old = os.environ.get("MXTPU_FUSED_KERNELS")  # mxlint: disable=env-direct-read (saved to restore)
    os.environ["MXTPU_FUSED_KERNELS"] = value
    try:
        yield
    finally:
        if old is None:
            del os.environ["MXTPU_FUSED_KERNELS"]
        else:
            os.environ["MXTPU_FUSED_KERNELS"] = old


def conv_counter(torch):
    """A dispatch mode counting ``aten.convolution`` calls (forward
    convolutions; a backward is ``convolution_backward``)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class ConvCount(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.overloadpacket is torch.ops.aten.convolution:
                self.n += 1
            return func(*args, **(kwargs or {}))
    return ConvCount()


def zoo_symbol(mx, name, image, classes):
    with mx.name.NameManager():
        if name.startswith("resnet-"):
            return mx.models.get_symbol(name, num_classes=classes,
                                        image_shape=image)
        return mx.models.get_symbol(name, num_classes=classes)


def _head(net):
    """The output of the layer SoftmaxOutput reads: the logits."""
    return net._outputs[0][0].inputs[0][0].name + "_output"


def zoo_report(mx, net, shape, **shapes):
    """The fused plan's report (``mxfuse.plan_report``) at input ``shape``
    (and the other inputs' ``shapes``) with every pass on."""
    with fused_kernels("1"):
        fn = mx.executor._build_eval(net)
    return mx.mxfuse.plan_report(fn.plan, fn.out_refs, mx.mxfuse.output_shapes(
        net, data=shape, **shapes))


def _params_on_host(mx, weights):
    args, aux = mx.convert.params_from_numpy(weights, ctx=mx.cpu())
    return _with_prefixes(args, aux)


def _predictor(mx, net, params, shape, ctx, fused, head=False):
    with fused_kernels("1" if fused else "0"):
        return mx.predict.Predictor(net, params, {"data": shape}, ctx=ctx,
                                    output_name=_head(net) if head else None)


def phase_zoo_plans(torch, mx):
    """Each zoo model's fused plan at batch 32: groups and members merged,
    pool rewrites, BN sites by kind, chains, entries liveness drops and
    the convolutions and ``fused_bn_act`` calls per forward on each path;
    for Inception-BN every pass must engage, as tests/test_mxfuse.py:366
    asks of the JAX package.  Returns ``{name: report}``."""
    reports = {}
    models = (("inception-bn", IMAGE, 1000), ("resnet-50", IMAGE, 1000)) \
        + ZOO_MODELS
    for name, image, classes in models:
        net = zoo_symbol(mx, name, image, classes)
        r = reports[name] = zoo_report(mx, net, (BATCH,) + image)
        log("plan %-12s %d entries | concat_fuse %d groups (%d grouped, %d "
            "merged at this shape), %d members | pool_act %d reorder, %d "
            "collapse, %d routed | "
            "bn_act %d, bn_fold %d | eltwise_chain %d chains of %d ops | "
            "liveness drops %d (inference) / %d (training) | convs %d in "
            "the plan, run per forward %d / %d | fused_bn_act calls %d / %d"
            % (name, r["entries"], r["concat_groups"], r["concat_grouped"],
               r["concat_merged"], r["concat_members"], r["pool_reorder"],
               r["pool_collapse"],
               r["pool_routed"], r["bn_act"], r["bn_fold"], r["chains"],
               r["chain_ops"], r["dropped_infer"], r["dropped_train"],
               r["convs"], r["conv_calls_infer"], r["conv_calls_train"],
               r["bn_act_calls_infer"], r["bn_act_calls_train"]))
        # a generated kernel per chain would launch once where the eager
        # chain launches once per op, forward and backward
        log("plan %-12s a kernel per eltwise chain would remove %d "
            "elementwise launches per forward and %d per training step"
            % (name, r["chain_ops"] - r["chains"],
               2 * (r["chain_ops"] - r["chains"])))
    r = reports["inception-bn"]
    check(r["concat_groups"] > 0 and r["concat_grouped"] > 0
          and r["pool_reorder"] > 0 and r["pool_routed"] > 0
          and r["bn_fold"] > 0 and r["dropped_infer"] > 0
          and r["dropped_train"] > 0
          and r["conv_calls_infer"] < r["convs"],
          "inception-bn: a pass did not engage: %s" % r)
    check(reports["resnet-50"]["conv_calls_infer"] == 53,
          "resnet-50 runs %d convolutions per fused forward, not 53"
          % reports["resnet-50"]["conv_calls_infer"])
    return reports


def phase_ibn_kernels(torch, mx, seed, calls):
    """The bn_act forward and backward kernels against their plain
    versions at every shape Inception-BN's training forward hands them
    (merged concat_fuse widths included), relu, float32 and bfloat16, with
    times (float32) per shape summed over one step's calls."""
    ba = mx.kernels.bn_act
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 40)
    counts = collections.Counter(calls)
    totals = collections.Counter()
    worst = {"fwd": 0.0, "bwd": 0.0}
    for shape, n in sorted(counts.items(), key=lambda kv: (-kv[0][1],
                                                           kv[0])):
        c = shape[1]
        x32 = torch.randn(shape, generator=gen, device=dev) * 2.0
        s32 = torch.randn(c, generator=gen, device=dev) * 0.5 + 1.0
        b32 = torch.randn(c, generator=gen, device=dev) * 0.5
        dy32 = torch.randn(shape, generator=gen, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            x, sc, sh, dy = (t.to(dtype) for t in (x32, s32, b32, dy32))
            f32 = dtype == torch.float32
            y = ba.norm_act(x, sc, sh, "relu")
            ref = ba.norm_act_plain(x, sc, sh, "relu")
            err = (y.float() - ref.float()).abs().max().item()
            tol = F32_TOL if f32 else \
                BF16_REL_TOL * ref.float().abs().max().item()
            check(err <= tol, "bn_act %s %s: max abs err %.3g > %.3g"
                  % (shape, dtype, err, tol))
            ratio, dx_err = _bwd_error(
                torch, ba.norm_act_bwd(x, sc, sh, dy, "relu"),
                ba.norm_act_bwd_plain(x, sc, sh, dy, "relu"), f32)
            check(ratio <= 1.0, "bn_act backward %s %s: error %.3g x its "
                  "tolerance" % (shape, dtype, ratio))
            if f32:
                worst["fwd"] = max(worst["fwd"], err)
                worst["bwd"] = max(worst["bwd"], dx_err)
        x, sc, sh, dy = x32, s32, b32, dy32
        s4, b4 = sc.reshape(1, c, 1, 1), sh.reshape(1, c, 1, 1)
        xl, sl, bl = (t.detach().requires_grad_(True) for t in (x, s4, b4))
        row = {
            "ms": device_ms(torch, lambda: ba.norm_act(x, sc, sh, "relu")),
            "plain_ms": device_ms(
                torch, lambda: ba.norm_act_plain(x, sc, sh, "relu")),
            "library_ms": device_ms(
                torch, lambda: torch.relu(torch.addcmul(b4, x, s4))),
            "bound_ms": 2 * x.numel() * 4 / HBM_BYTES_PER_S * 1e3,
            "bwd_ms": device_ms(
                torch, lambda: ba.norm_act_bwd(x, sc, sh, dy, "relu")),
            "bwd_plain_ms": device_ms(
                torch, lambda: ba.norm_act_bwd_plain(x, sc, sh, dy, "relu")),
            "bwd_library_ms": device_ms(torch, lambda: torch.autograd.grad(
                torch.relu(torch.addcmul(bl, xl, sl)), (xl, sl, bl), dy)),
            "bwd_bound_ms": 3 * x.numel() * 4 / HBM_BYTES_PER_S * 1e3,
        }
        for k, v in row.items():
            totals[k] += n * v
        log("bn_act inception-bn %-19s x%d per step | fwd f32 ms %.4f plain "
            "%.4f library %.4f bound %.4f | bwd f32 ms %.4f plain %.4f "
            "library %.4f bound %.4f" % (
                str(shape), n, row["ms"], row["plain_ms"], row["library_ms"],
                row["bound_ms"], row["bwd_ms"], row["bwd_plain_ms"],
                row["bwd_library_ms"], row["bwd_bound_ms"]))
    log("bn_act inception-bn per training step (%d launches each way, %d "
        "shapes, every shape within tolerance, f32 max abs err fwd %.3g "
        "dx %.3g): forward kernel %.4f plain %.4f library %.4f bound %.4f "
        "ms; backward kernel %.4f plain %.4f library %.4f bound %.4f ms" % (
            len(calls), len(counts), worst["fwd"], worst["bwd"],
            totals["ms"], totals["plain_ms"], totals["library_ms"],
            totals["bound_ms"], totals["bwd_ms"], totals["bwd_plain_ms"],
            totals["bwd_library_ms"], totals["bwd_bound_ms"]))
    return totals


def _pool_sites(mx, net, shape):
    """``(input shape, attrs)`` of every non-global Pooling entry."""
    shapes = mx.mxfuse.output_shapes(net, data=shape)
    plan = mx.executor._node_plan(net)
    sites = []
    for e in plan:
        if e[0].op is not None and e[0].op.name == "Pooling" \
                and not e[1].get("global_pool", False):
            src, idx = e[0].inputs[0]
            sites.append((shapes[(id(src), idx)], dict(e[1])))
    return sites


def phase_pool_gate(torch, mx, seed, card):
    """``pooling_opt``'s shifted-slice form against the registered Pooling
    op at Inception-BN's batch-32 pooling sites, inference: equal (max bit
    for bit, avg within 1e-6 x max), and timed (device time, CUDA graphs);
    the CUDA gate the measurement supports is logged beside the one in
    ``kernels/pool_act.py``, and a CUDA tensor above the gate must take
    the op."""
    PA = mx.kernels.pool_act
    nn = mx.ops.nn
    net = zoo_symbol(mx, "inception-bn", IMAGE, 1000)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 41)
    seen = set()
    wins = []
    for in_shape, attrs in _pool_sites(mx, net, (BATCH,) + IMAGE):
        key = (in_shape, tuple(sorted((k, str(v)) for k, v in attrs.items())))
        if key in seen:
            continue
        seen.add(key)
        x = torch.randn(in_shape, generator=gen, device=dev)
        big = 10 ** 9
        check(PA.slice_pool_eligible(x, attrs, limit=big),
              "pool site %s %s not slice-eligible" % (in_shape, attrs))
        got = PA.pooling_opt(x, attrs, limit=big)
        ref = nn.pooling(x, **attrs)
        if attrs.get("pool_type", "max") == "max":
            check(torch.equal(got, ref), "slice max pool %s differs"
                  % (in_shape,))
        else:
            err = (got - ref).abs().max().item()
            check(err <= 1e-6 * ref.abs().max().item(),
                  "slice avg pool %s: max abs err %.3g" % (in_shape, err))
        routed = PA.pooling_opt(x, attrs)
        check(torch.equal(routed, ref) if in_shape[2] * in_shape[3]
              > PA.POOL_SLICE_MAX_SPATIAL_CUDA else True,
              "pooling_opt on CUDA above the gate did not take the op")
        slice_ms = device_ms(torch, lambda: PA.pooling_opt(x, attrs,
                                                           limit=big))
        op_ms = device_ms(torch, lambda: nn.pooling(x, **attrs))
        bound_ms = (x.numel() + ref.numel()) * 4 / HBM_BYTES_PER_S * 1e3
        wins.append((in_shape[2] * in_shape[3], slice_ms < op_ms))
        log("pool gate %-20s %s k%s s%s p%s | slice form %.4f ms, Pooling "
            "op %.4f ms (%.2fx), bound %.4f ms on %s" % (
                str(in_shape), attrs.get("pool_type", "max"),
                attrs.get("kernel"), attrs.get("stride"), attrs.get("pad"),
                slice_ms, op_ms, op_ms / slice_ms, bound_ms, card))
    losing = [hw for hw, win in wins if not win]
    supported = max([hw for hw, win in wins if win and all(
        hw < lost for lost in losing)] or [0])
    log("pool gate: the slice form wins at %d of %d sites; largest H*W up to "
        "which it wins at every site: %d; POOL_SLICE_MAX_SPATIAL_CUDA = %d"
        % (sum(w for _, w in wins), len(wins), supported,
           PA.POOL_SLICE_MAX_SPATIAL_CUDA))


def phase_ibn_serving(torch, mx, seed, card, report):
    """Inception-BN served through ``Predictor`` at batch 32 with every
    pass on: IBN_FORWARDS requests, counts zeroed just before; bn_act
    launches and merged bodies per forward held to the plan, convolutions
    per forward (a dispatch mode) to the live count; fused against
    unfused logits; the card against the port's CPU path at batch 2;
    fused and unfused img/s in turns and a profile."""
    import numpy as np
    ba, CF = mx.kernels.bn_act, mx.kernels.concat_fuse
    net = zoo_symbol(mx, "inception-bn", IMAGE, 1000)
    shape = (BATCH,) + IMAGE
    params = _params_on_host(mx, draw_weights(net, shape, seed + 50))
    gpu = mx.gpu(0)
    pred = _predictor(mx, net, params, shape, gpu, True)
    rs = np.random.RandomState(seed + 51)
    requests = [rs.standard_normal(shape).astype(np.float32)
                for _ in range(IBN_FORWARDS)]
    pred.forward(data=requests[0]).get_output(0)     # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # -- the main path: counts zeroed just before, read just after ---------
    ba.LAUNCHES = 0
    CF.MERGED_BODIES = 0
    t0 = time.perf_counter()
    outs = [pred.forward(data=x).get_output(0) for x in requests]
    wall = time.perf_counter() - t0
    launches, merged = ba.LAUNCHES, CF.MERGED_BODIES
    # ----------------------------------------------------------------------

    peak = torch.cuda.max_memory_allocated()
    n = len(requests)
    log("inception-bn serving: %d forwards at batch %d, %.1f img/s, peak "
        "memory %.2f GiB; bn_act launches %d (plan: %d per forward), "
        "merged group bodies %d (plan: %d per forward) on %s" % (
            n, BATCH, BATCH * n / wall, peak / 2 ** 30, launches,
            report["bn_act_calls_infer"], merged, report["concat_merged"],
            card))
    check(launches == report["bn_act_calls_infer"] * n,
          "inception-bn serving bn_act launches %d" % launches)
    check(merged == report["concat_merged"] * n,
          "inception-bn serving merged bodies %d over %d forwards"
          % (merged, n))
    for out in outs:
        check(out.shape == (BATCH, 1000) and np.isfinite(out).all()
              and np.allclose(out.sum(1), 1.0, atol=1e-4),
              "inception-bn serving output bad")
    count = conv_counter(torch)
    with count:
        pred.forward(data=requests[0]).get_output(0)
    log("inception-bn serving: %d convolutions per fused forward (plan: %d "
        "live; %d in the graph)" % (count.n, report["conv_calls_infer"],
                                    report["convs"]))
    check(count.n == report["conv_calls_infer"],
          "inception-bn fused forward ran %d convolutions" % count.n)
    # fused against unfused logits, and the card against the CPU
    x = requests[1]
    fused = _predictor(mx, net, params, shape, gpu, True, head=True)
    unfused = _predictor(mx, net, params, shape, gpu, False, head=True)
    before = ba.LAUNCHES
    ref = unfused.forward(data=x).get_output(0)
    check(ba.LAUNCHES == before, "MXTPU_FUSED_KERNELS=0 launched bn_act")
    compare_logits(np, fused.forward(data=x).get_output(0), ref,
                   "inception-bn gpu fused vs unfused, batch %d" % BATCH)
    x2 = x[:IBN_AGREE_BATCH]
    cpu = _predictor(mx, net, params, x2.shape, mx.cpu(), True, head=True)
    ref2 = cpu.forward(data=x2).get_output(0)
    for plan in (True, False):
        got = _predictor(mx, net, params, x2.shape, gpu, plan, head=True)
        compare_logits(np, got.forward(data=x2).get_output(0), ref2,
                       "inception-bn gpu %s vs cpu fused, batch %d" % (
                           "fused" if plan else "unfused", IBN_AGREE_BATCH))
    del pred, fused, unfused, cpu
    rates = phase_profile(torch, mx, net, params, card, what="inception-bn")
    return launches, rates


def _ibn_trainer(torch, mx, seed, fused):
    net = zoo_symbol(mx, "inception-bn", IMAGE, 1000)
    mx.random.seed(seed)
    with fused_kernels("1" if fused else "0"):
        tr = mx.parallel.SPMDTrainer(
            net, "sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4,
                         "rescale_grad": 1.0 / BATCH},
            mesh=None, compute_dtype=None, ctx=mx.gpu(0))
        tr.bind([("data", (BATCH,) + IMAGE)], [("softmax_label", (BATCH,))])
        tr.init_params(mx.initializer.Xavier(rnd_type="gaussian",
                                             factor_type="in", magnitude=2))
    return tr


def phase_ibn_training(torch, mx, seed, card, report):
    """Inception-BN trained through ``SPMDTrainer`` at batch 32 with
    bench.py's ResNet settings, every pass on (concat_fuse in training:
    bn_act at merged widths): bn_act forward and backward launches and
    merged bodies per step held to the plan, convolutions per training
    forward to the live count, finite losses, a cross-entropy that falls
    on a fixed batch, no skipped step, moved params; then fused against
    MXTPU_FUSED_KERNELS=0 ms/step in turns, and a profile."""
    import numpy as np
    ba, CF = mx.kernels.bn_act, mx.kernels.concat_fuse
    tr = _ibn_trainer(torch, mx, seed + 60, True)
    dev = torch.device("cuda", 0)
    rs = np.random.RandomState(seed + 61)
    batches = [(torch.from_numpy(rs.standard_normal((BATCH,) + IMAGE)
                                 .astype(np.float32)).to(dev),
                torch.from_numpy(rs.randint(0, 1000, BATCH)
                                 .astype(np.float32)).to(dev))
               for _ in range(IBN_TRAIN_STEPS)]
    fixed = batches[0]
    params0 = {k: v.clone() for k, v in tr.params.items()}
    ce_before = _cross_entropy(torch, tr.forward_only(*fixed)[0], fixed[1])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    plan = list(batches) + [fixed] * IBN_FIXED_STEPS
    steps = len(plan)

    # -- the main path: counts zeroed just before, read just after ---------
    ba.LAUNCHES = 0
    ba.BWD_LAUNCHES = 0
    CF.MERGED_BODIES = 0
    stamps, losses = [], []
    for x, y in plan:
        stamps.append(time.perf_counter())
        losses.append(_cross_entropy(torch, tr.step(x, y)[0], y))
    torch.cuda.synchronize()
    stamps.append(time.perf_counter())
    fwd, bwd, merged = ba.LAUNCHES, ba.BWD_LAUNCHES, CF.MERGED_BODIES
    skipped = tr.skipped_steps
    # ----------------------------------------------------------------------

    peak = torch.cuda.max_memory_allocated()
    per = report["bn_act_calls_train"]
    log("inception-bn training: bn_act launches over %d steps: forward %d, "
        "backward %d (plan: %d per step, merged groups counted once); "
        "merged group bodies %d (plan: %d per step)" % (
            steps, fwd, bwd, per, merged, report["concat_merged"]))
    check(fwd == bwd == per * steps, "inception-bn training bn_act launches "
          "%d / %d != %d" % (fwd, bwd, per * steps))
    check(merged == report["concat_merged"] * steps, "inception-bn "
          "training merged bodies %d over %d steps" % (merged, steps))
    ce_after = float(_cross_entropy(torch, tr.forward_only(*fixed)[0],
                                    fixed[1]))
    losses = [float(v) for v in torch.stack(losses).cpu()]
    log("inception-bn training: per-step loss %s; fixed-batch cross-entropy "
        "%.4f before, %.4f after %d steps on it" % (
            " ".join("%.4f" % v for v in losses), float(ce_before), ce_after,
            IBN_FIXED_STEPS))
    check(all(np.isfinite(losses)) and ce_after < float(ce_before),
          "inception-bn training: loss not finite or not falling")
    check(skipped == 0, "inception-bn: %d guard-skipped steps" % skipped)
    moved = sum(not torch.equal(v, params0[k]) for k, v in tr.params.items())
    check(moved == len(params0), "inception-bn: %d of %d params moved"
          % (moved, len(params0)))
    steady = (stamps[-1] - stamps[2]) / (steps - 2)
    log("inception-bn training: first step %.1f ms, steady %.2f ms/step at "
        "batch %d -> %.1f img/s, peak memory %.2f GiB on %s" % (
            (stamps[1] - stamps[0]) * 1e3, steady * 1e3, BATCH,
            BATCH / steady, peak / 2 ** 30, card))
    count = conv_counter(torch)
    with count:
        tr.step(*batches[1])
        torch.cuda.synchronize()
    log("inception-bn training: %d convolutions per fused training forward "
        "(plan: %d live; %d in the graph)" % (
            count.n, report["conv_calls_train"], report["convs"]))
    check(count.n == report["conv_calls_train"],
          "inception-bn training forward ran %d convolutions" % count.n)
    # fused against unfused, in turns
    tr0 = _ibn_trainer(torch, mx, seed + 60, False)
    before = (ba.LAUNCHES, ba.BWD_LAUNCHES)
    tr0.step(*batches[1])
    torch.cuda.synchronize()
    check((ba.LAUNCHES, ba.BWD_LAUNCHES) == before,
          "MXTPU_FUSED_KERNELS=0 training launched bn_act")
    times = collections.defaultdict(list)
    for which in ("fused", "unfused", "unfused", "fused"):
        t = tr if which == "fused" else tr0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(IBN_TURN_STEPS):
            t.step(*batches[i % len(batches)])
        torch.cuda.synchronize()
        times[which].append((time.perf_counter() - t0) * 1e3
                            / IBN_TURN_STEPS)
    for which, ms in times.items():
        log("inception-bn training %s: %s ms/step (two turns of %d steps, "
            "batch %d) on %s" % (which, " / ".join("%.2f" % v for v in ms),
                                 IBN_TURN_STEPS, BATCH, card))
    tr0.close()
    del tr0
    phase_train_profile(torch, mx, tr, batches, card,
                        what="inception-bn train")
    tr.close()
    return fwd, bwd


def phase_ibn_train_agreement(torch, mx, seed, report_at):
    """One batch-2 Inception-BN training forward/backward on the card,
    fused and unfused, against the port's CPU path (float32, and float64
    for the gradients), as ``phase_train_agreement`` does for
    ResNet-50."""
    import numpy as np
    ba = mx.kernels.bn_act
    net = zoo_symbol(mx, "inception-bn", IMAGE, 1000)
    shape = (IBN_AGREE_BATCH,) + IMAGE
    per = report_at(shape)["bn_act_calls_train"]
    weights = draw_weights(net, shape, seed + 70)
    rs = np.random.RandomState(seed + 71)
    x = rs.standard_normal(shape).astype(np.float32)
    y = rs.randint(0, 1000, IBN_AGREE_BATCH).astype(np.float32)
    t0 = time.perf_counter()
    ref = _executor_step(mx, net, weights, x, y, mx.cpu())
    exact = _executor_step(mx, net, weights, x.astype(np.float64),
                           y.astype(np.float64), mx.cpu())
    grads = [k for k in ref if k.startswith("grad:")]
    cpu_l2 = _rel_l2(np, ref, exact, grads)
    # every conv of Inception-BN has a bias and feeds a BatchNorm, which
    # subtracts its batch mean again: those biases' gradients are zero
    zero = tuple("grad:" + e[0].inputs[0][0].inputs[2][0].name
                 for e in mx.executor._node_plan(net)
                 if e[0].op is not None and e[0].op.name == "BatchNorm"
                 and e[0].inputs[0][0].op is not None
                 and e[0].inputs[0][0].op.name == "Convolution"
                 and len(e[0].inputs[0][0].inputs) == 3)
    log("inception-bn training agreement: CPU float32 and float64 at batch "
        "%d took %.1f s; CPU float32 gradients' relative L2 against float64 "
        "%.3g" % (IBN_AGREE_BATCH, time.perf_counter() - t0, cpu_l2))
    before = (ba.LAUNCHES, ba.BWD_LAUNCHES)
    got = _executor_step(mx, net, weights, x, y, mx.gpu(0))
    launched = (ba.LAUNCHES - before[0], ba.BWD_LAUNCHES - before[1])
    check(launched == (per, per), "inception-bn executor step launched %s "
          "bn_act kernels, not %s" % (launched, (per, per)))
    with fused_kernels("0"):
        unfused = _executor_step(mx, net, weights, x, y, mx.gpu(0))
    log("inception-bn training agreement: gradients' relative L2 against "
        "float64: cpu float32 %.3g, gpu fused %.3g, gpu unfused %.3g" % (
            cpu_l2, _rel_l2(np, got, exact, grads),
            _rel_l2(np, unfused, exact, grads)))
    _compare_train(np, got, ref, exact, cpu_l2, "inception-bn gpu fused",
                   zero)
    _compare_train(np, unfused, ref, exact, cpu_l2,
                   "inception-bn gpu MXTPU_FUSED_KERNELS=0", zero)


def phase_zoo_serving(torch, mx, seed, card, reports):
    """Every other zoo model served through ``Predictor`` at batch 32 at
    its published input size, fused and unfused: bn_act launches on the
    fused forwards held to the plan, finite softmax rows, fused against
    unfused logits, the card against the CPU at batch 1, img/s of both in
    turns (fused, unfused, unfused, fused).  Returns the fused forwards'
    bn_act launches."""
    import numpy as np
    ba = mx.kernels.bn_act
    gpu = mx.gpu(0)
    total = 0
    for k, (name, image, classes) in enumerate(ZOO_MODELS):
        net = zoo_symbol(mx, name, image, classes)
        shape = (BATCH,) + image
        t0 = time.perf_counter()
        params = _params_on_host(mx, draw_weights(net, shape, seed + 80 + k))
        draw_s = time.perf_counter() - t0
        preds = {plan: _predictor(mx, net, params, shape, gpu, plan == "fused")
                 for plan in ("fused", "unfused")}
        x = np.random.RandomState(seed + 90 + k).uniform(
            0, 1, shape).astype(np.float32)
        for p in preds.values():
            p.forward(data=x).get_output(0)          # warm-up
        rates = collections.defaultdict(list)
        launches = 0
        for plan in ("fused", "unfused", "unfused", "fused"):
            before = ba.LAUNCHES
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(ZOO_TURN_FORWARDS):
                out = preds[plan].forward(data=x).get_output(0)
            rates[plan].append(BATCH * ZOO_TURN_FORWARDS
                               / (time.perf_counter() - t0))
            if plan == "fused":
                launches += ba.LAUNCHES - before
            else:
                check(ba.LAUNCHES == before, "%s unfused launched bn_act"
                      % name)
            check(out.shape == (BATCH, classes) and np.isfinite(out).all()
                  and np.allclose(out.sum(1), 1.0, atol=1e-4),
                  "%s %s serving output bad" % (name, plan))
        expected = reports[name]["bn_act_calls_infer"] * 2 * ZOO_TURN_FORWARDS
        check(launches == expected, "%s: bn_act launches %d != %d"
              % (name, launches, expected))
        total += launches
        del preds
        logits = {plan: _predictor(mx, net, params, shape, gpu,
                                   plan == "fused", head=True)
                  .forward(data=x).get_output(0)
                  for plan in ("fused", "unfused")}
        compare_logits(np, logits["fused"], logits["unfused"],
                       "%s gpu fused vs unfused, batch %d" % (name, BATCH))
        x1 = x[:ZOO_AGREE_BATCH]
        ref = _predictor(mx, net, params, x1.shape, mx.cpu(), True,
                         head=True).forward(data=x1).get_output(0)
        compare_logits(np, _predictor(mx, net, params, x1.shape, gpu, True,
                                      head=True).forward(data=x1)
                       .get_output(0), ref,
                       "%s gpu vs cpu fused, batch %d" % (name,
                                                          ZOO_AGREE_BATCH))
        log("zoo %-12s %s at batch %d: fused %s img/s, unfused %s img/s on "
            "%s (weights drawn in %.1f s)" % (
                name, "x".join(map(str, image)), BATCH,
                " / ".join("%.1f" % v for v in rates["fused"]),
                " / ".join("%.1f" % v for v in rates["unfused"]), card,
                draw_s))
        del params, logits
        gc.collect()
        torch.cuda.empty_cache()
    return total


def _whole_plan_eval(mx, fn):
    """An eval function interpreting EVERY entry of ``fn``'s fused plan,
    as the executor did before liveness: each fold site also runs its
    original convolution, whose result nothing reads."""
    def eval_fn(args, aux, is_train, rng, device=None, monitor=None):
        env, aux_updates = {}, {}
        mx.executor._run_plan_nodes(fn.plan, env, args, aux, is_train,
                                    aux_updates, rng, device,
                                    monitor=monitor)
        return [env[nid][i] for nid, i in fn.out_refs], aux_updates
    return eval_fn


def phase_resnet_repair(torch, mx, seed, card):
    """ResNet-50 served at batch 32 three ways in one run: fused with
    liveness (this tree), fused interpreting every entry (the executor
    before liveness, emulated by ``_whole_plan_eval``), and unfused;
    convolutions per forward (53, 86, 53), equal outputs, and img/s in
    turns."""
    import numpy as np
    net = zoo_symbol(mx, "resnet-50", IMAGE, 1000)
    shape = (BATCH,) + IMAGE
    params = _params_on_host(mx, draw_weights(net, shape, seed + 100))
    gpu = mx.gpu(0)
    preds = {"after": _predictor(mx, net, params, shape, gpu, True),
             "before": _predictor(mx, net, params, shape, gpu, True),
             "unfused": _predictor(mx, net, params, shape, gpu, False)}
    preds["before"]._exec._eval = _whole_plan_eval(
        mx, preds["before"]._exec._eval)
    x = np.random.RandomState(seed + 101).standard_normal(shape) \
        .astype(np.float32)
    outs, convs = {}, {}
    for which, p in preds.items():
        count = conv_counter(torch)
        with count:
            outs[which] = p.forward(data=x).get_output(0)
        convs[which] = count.n
    log("resnet-50 serving convolutions per forward: fused %d, fused "
        "interpreting every entry (before the repair) %d, unfused %d"
        % (convs["after"], convs["before"], convs["unfused"]))
    check(convs == {"after": 53, "before": 86, "unfused": 53},
          "resnet-50 convolutions per forward %s" % convs)
    check(np.array_equal(outs["after"], outs["before"]),
          "liveness changed the fused outputs")
    rates = collections.defaultdict(list)
    for which in ("after", "before", "unfused", "unfused", "before",
                  "after"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(REPAIR_TURN_FORWARDS):
            preds[which].forward(data=x).get_output(0)
        rates[which].append(BATCH * REPAIR_TURN_FORWARDS
                            / (time.perf_counter() - t0))
    for which, r in rates.items():
        log("resnet-50 serving %-8s %s img/s (two turns of %d forwards, "
            "batch %d) on %s" % (which, " / ".join("%.1f" % v for v in r),
                                 REPAIR_TURN_FORWARDS, BATCH, card))
    del preds
    gc.collect()
    torch.cuda.empty_cache()


#: the ops of ops/nn.py the port added last, on the card against its CPU
#: path: (op, {input: shape}, attrs, label inputs).  rrelu draws its
#: slopes from the device's generator in training, so its values differ
#: between devices by design; it is held on the CPU in the tests.
NN_OP_CASES = (
    ("Deconvolution", {"data": (8, 16, 14, 14)},
     dict(kernel=(4, 4), stride=(2, 2), pad=(1, 1), num_filter=32,
          no_bias=False), ()),
    ("Deconvolution", {"data": (8, 16, 14, 14)},
     dict(kernel=(3, 3), stride=(1, 1), pad=(1, 1), adj=(2, 2),
          num_filter=8, num_group=2, target_shape=(16, 16)), ()),
    ("LeakyReLU", {"data": (32, 64, 13, 13)},
     dict(act_type="leaky", slope=0.1), ()),
    ("LeakyReLU", {"data": (32, 64, 13, 13)}, dict(act_type="elu"), ()),
    ("LeakyReLU", {"data": (32, 64, 13, 13)}, dict(act_type="prelu"), ()),
    ("InstanceNorm", {"data": (8, 32, 17, 17)}, dict(eps=1e-3), ()),
    ("L2Normalization", {"data": (8, 32, 17, 17)}, dict(mode="instance"),
     ()),
    ("L2Normalization", {"data": (8, 32, 17, 17)}, dict(mode="channel"), ()),
    ("L2Normalization", {"data": (8, 32, 17, 17)}, dict(mode="spatial"), ()),
    ("LRN", {"data": (32, 96, 27, 27)},
     dict(alpha=1e-4, beta=0.75, knorm=2, nsize=5), ()),
    ("Pad", {"data": (8, 16, 15, 15)},
     dict(mode="constant", pad_width=(0, 0, 0, 0, 2, 1, 1, 2),
          constant_value=0.5), ()),
    ("Pad", {"data": (8, 16, 15, 15)},
     dict(mode="edge", pad_width=(0, 0, 0, 0, 2, 1, 1, 2)), ()),
    ("Pad", {"data": (8, 16, 15, 15)},
     dict(mode="reflect", pad_width=(0, 0, 0, 0, 3, 2, 2, 3)), ()),
    ("Crop", {"data": (8, 16, 15, 15)}, dict(h_w=(9, 11), offset=(2, 3)),
     ()),
    ("Crop", {"data": (8, 16, 15, 15), "like": (8, 4, 10, 10)},
     dict(num_args=2, center_crop=True), ("like",)),
    ("UpSampling", {"a": (8, 16, 14, 14), "b": (8, 16, 14, 14)},
     dict(scale=2, sample_type="nearest", num_args=2), ()),
    ("UpSampling", {"data": (8, 16, 14, 14)},
     dict(scale=2, sample_type="bilinear", num_filter=16), ()),
    ("SoftmaxActivation", {"data": (32, 10, 7, 7)}, dict(mode="channel"),
     ()),
    ("SVMOutput", {"data": (32, 100), "label": (32,)}, dict(margin=1.0),
     ("label",)),
    ("MakeLoss", {"data": (32, 100)}, dict(normalization="batch"), ()),
    ("IdentityAttachKLSparseReg", {"data": (32, 100)}, {}, ()),
    ("LinearRegressionOutput", {"data": (32, 100), "label": (32, 100)}, {},
     ("label",)),
    ("LogisticRegressionOutput", {"data": (32, 100), "label": (32, 100)},
     {}, ("label",)),
    ("MAERegressionOutput", {"data": (32, 100), "label": (32, 100)}, {},
     ("label",)),
)


def phase_nn_ops(torch, mx, seed):
    """Each case of NN_OP_CASES bound on the card and on the CPU
    (``simple_bind`` -> ``forward(is_train=True)`` -> ``backward(head)``
    with one random head): outputs within SWEEP_F32_REL_TOL x max |cpu|,
    every gradient within GRAD_REL_L2 in relative L2."""
    import numpy as np
    covered = {c[0] for c in NN_OP_CASES}
    check(len(covered) == 15, "nn op cases cover %d ops" % len(covered))
    worst_out, worst_grad = (0.0, ""), (0.0, "")
    for k, (op, shapes, attrs, labels) in enumerate(NN_OP_CASES):
        head = None
        results = []
        for ctx in (mx.gpu(0), mx.cpu()):
            with mx.name.NameManager():
                net = getattr(mx.sym, op)(
                    *[mx.sym.var(n) for n in shapes], name="op", **attrs)
            req = {n: "null" if n in labels else "write"
                   for n in net.list_arguments()}
            ex = net.simple_bind(ctx, grad_req=req, **shapes)
            rs_k = np.random.RandomState(seed + 300 + k)
            for n in sorted(ex.arg_dict):
                arr = ex.arg_dict[n]
                if n == "label" and op == "SVMOutput":
                    v = rs_k.randint(0, 100, arr.shape)
                elif n.endswith("gamma"):
                    v = rs_k.uniform(0.1, 0.5, arr.shape)
                else:
                    v = rs_k.standard_normal(arr.shape)
                arr[:] = v.astype(np.float32)
            out_shape = ex.forward(is_train=True)[0].shape
            if head is None:
                head = np.random.RandomState(seed + 200 + k) \
                    .standard_normal(out_shape).astype(np.float32)
            ex.backward(out_grads=[mx.nd.array(head, ctx=ctx)])
            results.append((ex.outputs[0].asnumpy(),
                            {n: g.asnumpy() for n, g in ex.grad_dict.items()
                             if req.get(n) == "write"}))
        (g_out, g_grads), (c_out, c_grads) = results
        what = "%s %s" % (op, ",".join("%s=%s" % kv for kv in
                                       sorted(attrs.items()))[:60])
        err = _sweep_error(np, g_out, c_out, False, False)
        check(err is None, "nn op %s forward: %s" % (what, err))
        top = float(np.abs(c_out).max())
        worst_out = max(worst_out, (float(np.abs(g_out - c_out).max())
                                    / max(top, 1e-30), what))
        check(sorted(g_grads) == sorted(c_grads) and g_grads,
              "nn op %s: gradients %s" % (what, sorted(g_grads)))
        for n in c_grads:
            r = c_grads[n].astype(np.float64)
            g = g_grads[n].astype(np.float64)
            den = float(np.linalg.norm(r))
            rel = float(np.linalg.norm(g - r)) / den if den > 0 else \
                float(np.linalg.norm(g))
            worst_grad = max(worst_grad, (rel, "%s %s" % (what, n)))
    check(worst_grad[0] <= GRAD_REL_L2, "nn op gradients: %s relative L2 "
          "%.3g (bound %g)" % (worst_grad[1], worst_grad[0], GRAD_REL_L2))
    log("nn ops: %d cases of the %d ops of ops/nn.py the port added last, "
        "forward and backward on the card against the CPU path: worst "
        "output max |diff| / max |cpu| %.3g (%s, bound %g), worst gradient "
        "relative L2 %.3g (%s, bound %g)" % (
            len(NN_OP_CASES), len(covered), worst_out[0], worst_out[1],
            SWEEP_F32_REL_TOL, worst_grad[0], worst_grad[1], GRAD_REL_L2))


def zoo_paths(torch, mx, seed, card):
    """The model zoo and the rest of the plan optimizer: the plans'
    report, the bn_act kernels at Inception-BN's shapes, the pooling gate,
    Inception-BN serving and training (with agreement against the CPU),
    the other zoo models served, the ResNet-50 liveness repair in one run,
    and the ops of ops/nn.py.  Returns the main paths' launches by
    kernel."""
    reports = phase_zoo_plans(torch, mx)
    ibn = zoo_symbol(mx, "inception-bn", IMAGE, 1000)
    with fused_kernels("1"):
        fn = mx.executor._build_eval(ibn)
    calls = mx.mxfuse.bn_act_calls(
        fn.plan, mx.mxfuse.output_shapes(ibn, data=(BATCH,) + IMAGE), True)
    check(len(calls) == reports["inception-bn"]["bn_act_calls_train"],
          "bn_act call shapes disagree with the report")
    phase_ibn_kernels(torch, mx, seed, calls)
    phase_pool_gate(torch, mx, seed, card)
    serve_launches, _ = phase_ibn_serving(torch, mx, seed, card,
                                          reports["inception-bn"])
    train_fwd, train_bwd = phase_ibn_training(torch, mx, seed, card,
                                              reports["inception-bn"])
    phase_ibn_train_agreement(
        torch, mx, seed, lambda shape: zoo_report(mx, ibn, shape))
    zoo_launches = phase_zoo_serving(torch, mx, seed, card, reports)
    phase_resnet_repair(torch, mx, seed, card)
    phase_nn_ops(torch, mx, seed)
    gc.collect()
    torch.cuda.empty_cache()
    return collections.Counter({
        "bn_act_fwd": serve_launches + train_fwd + zoo_launches,
        "bn_act_bwd": train_bwd})


# ---------------------------------------------------------------------------
# the extension surface: a Custom op head, a torch head, a Monitor, the
# autograd tape, and the mirror memory mode with Executor.close
# ---------------------------------------------------------------------------

EXT_BATCHES = 4          # Module.fit batches of each ResNet-50 head / monitor
EXT_MON_INTERVAL = 2     # monitor_weights.py's Monitor(interval, norm_stat)
EXT_GRAD_REL_L2 = 1e-5   # heads, torch head and autograd against their twins
EXT_CRIT_STEPS = 5       # TorchCriterion steps on one fixed batch
EXT_FGSM_BATCHES = 2     # attack batches of each route in each turn
EXT_MIRROR_STEPS = 2     # SPMDTrainer steps in each mirror turn
EXT_MIRROR_BATCH = 4     # the mirror-on against mirror-off gradient check
EXT_MIRROR_REL_L2 = 1e-6
# example/memcost/inception_memcost.py's trainer: sgd lr 0.1, Xavier,
# compute in bfloat16 (and float32 here), batch 32
MEMCOST_LR = 0.1


def numpy_softmax_class(mx):
    """``example/numpy-ops/numpy_softmax.py``'s ``NumpySoftmax``, on the
    port's ``mx.operator``."""
    import numpy as np

    class NumpySoftmax(mx.operator.NumpyOp):
        def __init__(self):
            super(NumpySoftmax, self).__init__(False)

        def list_arguments(self):
            return ["data", "label"]

        def list_outputs(self):
            return ["output"]

        def infer_shape(self, in_shape):
            data_shape = in_shape[0]
            label_shape = (in_shape[0][0],)
            output_shape = in_shape[0]
            return [data_shape, label_shape], [output_shape]

        def forward(self, in_data, out_data):
            x = in_data[0]
            y = out_data[0]
            y[:] = np.exp(x - x.max(axis=1).reshape((x.shape[0], 1)))
            y /= y.sum(axis=1).reshape((x.shape[0], 1))

        def backward(self, out_grad, in_data, out_data, in_grad):
            lab = in_data[1].reshape((in_data[1].size,)).astype(int)
            y = out_data[0]
            dx = in_grad[0]
            dx[:] = y
            dx[np.arange(lab.shape[0]), lab] -= 1.0
    return NumpySoftmax


@contextlib.contextmanager
def mirror_env(on):
    """``MXNET_BACKWARD_DO_MIRROR`` while executors and trainers are
    built inside."""
    old = os.environ.get("MXNET_BACKWARD_DO_MIRROR")  # mxlint: disable=env-direct-read (saved to restore)
    os.environ["MXNET_BACKWARD_DO_MIRROR"] = "1" if on else "0"
    try:
        yield
    finally:
        if old is None:
            del os.environ["MXNET_BACKWARD_DO_MIRROR"]
        else:
            os.environ["MXNET_BACKWARD_DO_MIRROR"] = old


def dtoh_ops(torch, fn):
    """Device-to-host copies and scalar reads of card values while
    ``fn()`` runs, counted by a CopyCounter: ``(count, bytes)``."""
    with CopyCounter(torch) as copies:
        fn()
    torch.cuda.synchronize()
    return copies.dtoh()


def _ext_data(seed, n):
    import numpy as np
    rs = np.random.RandomState(seed)
    X = rs.uniform(0, 1, (n * BATCH,) + IMAGE).astype(np.float32)
    y = rs.randint(0, 1000, n * BATCH).astype(np.float32)
    return X, y


def _ext_fit(torch, mx, net, weights, X, y, what, card, monitor=None):
    """One epoch of Module.fit on the executor route (sgd, lr FT_LR) from
    ``weights``; bn_act and the Custom host counts zeroed just before and
    read just after.  Returns (module, steady ms/batch, counts)."""
    import numpy as np
    ba, op = mx.kernels.bn_act, mx.operator
    host = mx.cpu()
    w_args, w_aux = weights
    mod = mx.mod.Module(net, context=mx.gpu(0))
    stamps = []

    def on_batch(_param):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    torch.cuda.synchronize()
    # -- the main path: counts zeroed just before, read just after ---------
    ba.LAUNCHES = 0
    ba.BWD_LAUNCHES = 0
    for k in op.HOST_COUNTS:
        op.HOST_COUNTS[k] = 0
    t0 = time.perf_counter()
    mod.fit(mx.io.NDArrayIter(X, y, batch_size=BATCH), kvstore="local",
            optimizer="sgd", optimizer_params={"learning_rate": FT_LR},
            arg_params={k: mx.nd.array(v, ctx=host)
                        for k, v in w_args.items()},
            aux_params={k: mx.nd.array(v, ctx=host)
                        for k, v in w_aux.items()},
            batch_end_callback=on_batch, monitor=monitor, num_epoch=1)
    torch.cuda.synchronize()
    counts = {"bn_act_fwd": ba.LAUNCHES, "bn_act_bwd": ba.BWD_LAUNCHES}
    counts.update(op.HOST_COUNTS)
    # ----------------------------------------------------------------------
    n = len(stamps)
    check(n == len(X) // BATCH, "%s: %d batches" % (what, n))
    steady = (stamps[-1] - stamps[1]) / (n - 2) * 1e3
    out = mod.get_outputs()[0].asnumpy()
    check(np.isfinite(out).all() and np.allclose(out.sum(1), 1.0,
                                                 atol=1e-4),
          "%s: outputs are not probabilities" % what)
    log("%s: %d batches of %d through Module.fit (executor route), first "
        "batch %.1f ms, steady %.2f ms/batch; launches bn_act %d forward / "
        "%d backward; on %s" % (what, n, BATCH, (stamps[0] - t0) * 1e3,
                                steady, counts["bn_act_fwd"],
                                counts["bn_act_bwd"], card))
    return mod, steady, counts


def _grad_pair(torch, mx, nets, weights, x, y, rename=None):
    """One training forward/backward of each net at the same weights and
    batch on the card, with deterministic cuDNN: the gradients of the
    first under the second's names (``rename``), and the second's."""
    import numpy as np
    got = []
    with _deterministic_cudnn(torch):
        for i, net in enumerate(nets):
            w = weights
            if i == 0 and rename:
                inv = {v: k for k, v in rename.items()}
                w = ({inv.get(k, k): v for k, v in weights[0].items()},
                     weights[1])
            got.append(_executor_step(mx, net, w, x, y, mx.gpu(0)))
    a, b = got
    if rename:
        a = {("grad:" + rename.get(k[5:], k[5:]) if k.startswith("grad:")
              else k): v for k, v in a.items()}
    keys = sorted(k for k in b if k.startswith("grad:"))
    check(sorted(k for k in a if k.startswith("grad:")) == keys,
          "gradient names differ")
    return _rel_l2(np, a, b, keys), len(keys)


def phase_custom_head(torch, mx, seed, card):
    """ResNet-50 with example/numpy-ops' ``NumpySoftmax`` as its head,
    through Module.fit: one host forward and one host backward of the op a
    batch, the bytes it moves, 50 + 50 bn_act launches a batch, the
    gradients against SoftmaxOutput's at the same weights and batch, ms
    per batch of each head.  Returns the bn_act launches of its fit."""
    body = zoo_symbol(mx, "resnet-50", IMAGE, 1000)
    logits = body.get_internals()["fc1_output"]
    custom = numpy_softmax_class(mx)()(data=logits, name="softmax")
    plain = mx.sym.SoftmaxOutput(logits, name="softmax")
    check(custom.list_arguments() == plain.list_arguments(),
          "NumpySoftmax head: arguments differ from SoftmaxOutput's")
    weights = draw_weights(body, (BATCH,) + IMAGE, seed + 100)
    X, y = _ext_data(seed + 101, EXT_BATCHES)
    _mod, ms_custom, counts = _ext_fit(torch, mx, custom, weights, X, y,
                                       "custom head (NumpySoftmax)", card)
    n = EXT_BATCHES
    to_host = BATCH * 1000 * 4 + BATCH * 4     # logits + label
    to_device = 2 * BATCH * 1000 * 4           # probabilities, dlogits
    log("custom head: host calls %d forward / %d backward; bytes across "
        "the host link %d to the host + %d to the card a batch (%d + %d "
        "expected: logits and label down, probabilities and their gradient "
        "up; need_top_grad=False sends no head gradient)" % (
            counts["forward"], counts["backward"],
            counts["bytes_to_host"] // n, counts["bytes_to_device"] // n,
            to_host, to_device))
    check((counts["forward"], counts["backward"]) == (n, n),
          "custom head: host calls %s" % counts)
    check((counts["bn_act_fwd"], counts["bn_act_bwd"]) == (50 * n, 50 * n),
          "custom head: bn_act launches %s" % counts)
    check((counts["bytes_to_host"], counts["bytes_to_device"])
          == (to_host * n, to_device * n), "custom head: host bytes %s"
          % counts)
    _mod2, ms_plain, counts2 = _ext_fit(torch, mx, plain, weights, X, y,
                                        "SoftmaxOutput head", card)
    check(counts2["forward"] == 0, "SoftmaxOutput head made host calls")
    l2, n_grads = _grad_pair(torch, mx, (custom, plain), weights,
                             X[:BATCH], y[:BATCH])
    again, _n = _grad_pair(torch, mx, (plain, plain), weights, X[:BATCH],
                           y[:BATCH])
    log("custom head: %d gradients against SoftmaxOutput's at the same "
        "weights and batch: relative L2 %.3g (bound %g; SoftmaxOutput "
        "against itself %.3g); ms per batch NumpySoftmax %.2f, "
        "SoftmaxOutput %.2f on %s" % (n_grads, l2, EXT_GRAD_REL_L2, again,
                                      ms_custom, ms_plain, card))
    check(l2 <= EXT_GRAD_REL_L2, "custom head gradients disagree")
    return counts["bn_act_fwd"], counts["bn_act_bwd"]


def phase_torch_head(torch, mx, seed, card):
    """ResNet-50 with ``fc1`` replaced by ``TorchModule(torch.nn.Linear(
    2048, 1000))``, trained through Module.fit: no device-to-host copy in
    a step, gradients against the FullyConnected head's, a
    ``TorchCriterion(CrossEntropyLoss)`` variant whose loss falls on a
    fixed batch, and ``mx.th`` on a card NDArray.  Returns the bn_act
    launches of its fit."""
    import numpy as np
    body = zoo_symbol(mx, "resnet-50", IMAGE, 1000)
    flat = body.get_internals()["flatten0_output"]
    torch.manual_seed(seed)
    lin = torch.nn.Linear(2048, 1000)
    head = mx.torch_bridge.TorchModule(lin, flat, name="fc1")
    th_net = mx.sym.SoftmaxOutput(head, name="softmax")
    rename = {"fc1_torch_weight": "fc1_weight", "fc1_torch_bias": "fc1_bias"}
    check(sorted(rename.get(k, k) for k in th_net.list_arguments())
          == sorted(body.list_arguments()), "torch head: arguments differ")
    weights = draw_weights(body, (BATCH,) + IMAGE, seed + 110)
    inv = {v: k for k, v in rename.items()}
    th_weights = ({inv.get(k, k): v for k, v in weights[0].items()},
                  weights[1])
    X, y = _ext_data(seed + 111, EXT_BATCHES)
    mod, ms, counts = _ext_fit(torch, mx, th_net, th_weights, X, y,
                               "torch head (TorchModule Linear)", card)
    n = EXT_BATCHES
    check((counts["bn_act_fwd"], counts["bn_act_bwd"]) == (50 * n, 50 * n)
          and counts["forward"] == 0, "torch head: launches / host calls %s"
          % counts)
    batch = mx.io.DataBatch([mx.nd.array(X[:BATCH], ctx=mx.gpu(0))],
                            [mx.nd.array(y[:BATCH], ctx=mx.gpu(0))])
    mod.forward_backward(batch)                 # warm
    mod.update()

    def step():
        mod.forward_backward(batch)
        mod.update()
    copies, nbytes = dtoh_ops(torch, step)
    log("torch head: one Module step (forward_backward + update) made %d "
        "device-to-host copies or reads (%d bytes); the node runs "
        "torch.func.functional_call on %s" % (
            copies, nbytes, mod._exec_group.execs[0].arg_dict[
                "fc1_torch_weight"]._data.device))
    check(copies == 0, "torch head: the step copied to the host")
    l2, n_grads = _grad_pair(torch, mx, (th_net, body), weights,
                             X[:BATCH], y[:BATCH], rename=rename)
    log("torch head: %d gradients against the FullyConnected head at the "
        "same weights and batch: relative L2 %.3g (bound %g); %.2f "
        "ms/batch on %s" % (n_grads, l2, EXT_GRAD_REL_L2, ms, card))
    check(l2 <= EXT_GRAD_REL_L2, "torch head gradients disagree")
    # TorchCriterion(CrossEntropyLoss) as the output layer
    logits = body.get_internals()["fc1_output"]
    crit = mx.torch_bridge.TorchCriterion(
        torch.nn.CrossEntropyLoss(), logits,
        mx.sym.Variable("softmax_label"), name="ce")
    tr = mx.parallel.SPMDTrainer(crit, "sgd", {"learning_rate": 0.1},
                                 ctx=mx.gpu(0))
    tr.bind([("data", (BATCH,) + IMAGE)], [("softmax_label", (BATCH,))])
    tr.init_params(None, *weights)
    dev = torch.device("cuda", 0)
    xb = torch.from_numpy(X[:BATCH]).to(dev)
    yb = torch.from_numpy(y[:BATCH]).to(dev)
    losses = [float(tr.step(xb, yb)[0].reshape(-1)[0])
              for _ in range(EXT_CRIT_STEPS)]
    log("torch head: TorchCriterion(CrossEntropyLoss) through SPMDTrainer "
        "on one fixed batch, loss per step %s" % " ".join(
            "%.4f" % v for v in losses))
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          "TorchCriterion: the loss did not fall")
    tr.close()
    a = mx.nd.array(X[:2, 0, 0, :8], ctx=mx.gpu(0))
    r = mx.th.mul(a, 2.0)
    check(isinstance(r, mx.nd.NDArray) and r.context == mx.gpu(0)
          and r._data.is_cuda and np.array_equal(r.asnumpy(),
                                                 2 * X[:2, 0, 0, :8]),
          "mx.th did not return a card NDArray")
    log("torch head: mx.th.mul on a card NDArray returned an NDArray on %s"
        % r.context)
    return counts["bn_act_fwd"], counts["bn_act_bwd"]


def plain_taps(mx, symbol, pattern):
    """The tap names of the plain plan's op nodes (``<node>_output``,
    ``<node>_output<i>``) that ``pattern`` matches."""
    import re
    prog = re.compile(pattern)
    names = []
    for node in symbol._nodes():
        if node.op is None:
            continue
        n = node.num_outputs()
        names += [node.name + "_output"] if n == 1 else [
            "%s_output%d" % (node.name, i) for i in range(n)]
    return [nm for nm in names if prog.match(nm)]


def phase_monitor(torch, mx, seed, card):
    """ResNet-50 through Module.fit with monitor_weights.py's Monitor(2,
    norm_stat): the statistics of each sampled batch are the plain plan's
    taps, all finite; tapped logits against the fused forward's; ms per
    batch monitored and not, in turns."""
    import numpy as np
    net = zoo_symbol(mx, "resnet-50", IMAGE, 1000)
    weights = draw_weights(net, (BATCH,) + IMAGE, seed + 120)
    X, y = _ext_data(seed + 121, EXT_BATCHES)

    def norm_stat(d):
        return mx.nd.norm(d) / np.sqrt(d.size)

    expect = plain_taps(mx, net, ".*")
    times = collections.defaultdict(list)
    for which in ("monitored", "plain", "plain", "monitored"):
        mon = None
        rows = []
        if which == "monitored":
            mon = mx.mon.Monitor(EXT_MON_INTERVAL, norm_stat)

            def record(mon=mon, rows=rows):
                # toc_print without the print: the rows are checked and
                # summarized below
                rows.append([(k, v) for _s, k, v in mon.queue])
                return mon.toc()
            mon.toc_print = record
        _mod, ms, counts = _ext_fit(torch, mx, net, weights, X, y,
                                    "monitor fit (%s)" % which, card,
                                    monitor=mon)
        times[which].append(ms)
        if which == "plain":
            check((counts["bn_act_fwd"], counts["bn_act_bwd"])
                  == (50 * EXT_BATCHES,) * 2, "plain fit launches %s"
                  % counts)
            continue
        sampled = [r for r in rows if r]
        check(len(sampled) == -(-EXT_BATCHES // EXT_MON_INTERVAL),
              "monitor: %d sampled batches" % len(sampled))
        vals = []
        for r in sampled:
            check([k for k, _v in r] == expect, "monitor: %d statistics, "
                  "the plain plan taps %d" % (len(r), len(expect)))
            vals += [float(v.asnumpy().reshape(-1)[0]) for _k, v in r]
        check(np.isfinite(vals).all(), "monitor: a statistic is not finite")
        log("monitor: %d sampled batches of %d, %d statistics each (the "
            "plain plan's %d taps), all finite, range %.3g..%.3g, first %s; "
            "bn_act launches %d (the plain plan runs while a tap is "
            "installed)" % (
                len(sampled), EXT_BATCHES, len(sampled[0]), len(expect),
                min(vals), max(vals), ", ".join(
                    "%s %.4g" % (k, v) for (k, _a), v in
                    zip(sampled[0][:3], vals[:3])), counts["bn_act_fwd"]))
    log("monitor: ms per batch monitored %s, unmonitored %s (turns of one "
        "fit each) on %s" % (
            " / ".join("%.2f" % v for v in times["monitored"]),
            " / ".join("%.2f" % v for v in times["plain"]), card))
    # tapped logits against the fused forward's
    logits = net.get_internals()["fc1_output"]
    ex = logits.simple_bind(mx.gpu(0), grad_req="null",
                            data=(BATCH,) + IMAGE)
    for k, v in weights[0].items():
        if k in ex.arg_dict:
            ex.arg_dict[k][:] = v
    for k, v in weights[1].items():
        ex.aux_dict[k][:] = v
    fused = ex.forward(is_train=False, data=X[:BATCH])[0].asnumpy()
    seen = []
    ex.set_monitor_callback(lambda name, arr: seen.append(name))
    tapped = ex.forward(is_train=False, data=X[:BATCH])[0].asnumpy()
    diff = float(np.abs(tapped - fused).max())
    bound = 1e-3 * float(np.abs(fused).max())
    log("monitor: tapped (plain plan) logits against fused: max |diff| %.3g "
        "(bound %.3g = 1e-3 x max|logit|), %d taps" % (diff, bound,
                                                        len(seen)))
    check(np.isfinite(tapped).all() and diff <= bound,
          "monitor: tapped logits disagree with the fused forward")
    check(seen == plain_taps(mx, logits, ".*"), "monitor: taps of the "
          "logits executor are not its plain plan's")
    ex.close()


def nd_walk(mx, symbol, values):
    """``symbol``'s nodes run one by one as ``mx.nd`` calls on ``values``
    (name -> NDArray): the first output, as an NDArray."""
    env = {}
    for node in symbol._nodes():
        if node.is_variable:
            env[id(node)] = [values[node.name]]
            continue
        ins = [env[id(src)][i] for src, i in node.inputs]
        out = getattr(mx.nd, node.op.name)(*ins, **node.op_attrs())
        env[id(node)] = out if isinstance(out, list) else [out]
    node, i = symbol._outputs[0]
    return env[id(node)][i]


def phase_autograd_fgsm(torch, mx, seed, card):
    """FGSM on ResNet-50 through ``contrib.autograd.grad_and_loss`` over
    the node-by-node ``mx.nd`` walk of the symbol, the data NDArray the
    marked variable: its input gradient against the executor's
    ``inputs_need_grad`` gradient under MXTPU_FUSED_KERNELS=0, and ms per
    attack batch in turns with the executor route (a Module, as
    ``phase_fgsm_resnet``)."""
    import numpy as np
    gpu = mx.gpu(0)
    net = zoo_symbol(mx, "resnet-50", IMAGE, 1000)
    weights = draw_weights(net, (BATCH,) + IMAGE, seed + 130)
    X, y = _ext_data(seed + 131, EXT_FGSM_BATCHES)
    values = {k: mx.nd.array(v, ctx=gpu) for k, v in weights[0].items()}
    values.update({k: mx.nd.array(v, ctx=gpu) for k, v in
                   weights[1].items()})
    xs = [mx.nd.array(X[i * BATCH:(i + 1) * BATCH], ctx=gpu)
          for i in range(EXT_FGSM_BATCHES)]
    ys = [mx.nd.array(y[i * BATCH:(i + 1) * BATCH], ctx=gpu)
          for i in range(EXT_FGSM_BATCHES)]

    def forward(x, label):
        return nd_walk(mx, net, dict(values, data=x, softmax_label=label))

    def walk_attack(x, label):
        grads, probs = mx.contrib.autograd.grad_and_loss(
            lambda v: forward(v, label))(x)
        x_adv = mx.nd.clip(x + FGSM_EPS * mx.nd.sign(grads[0]), 0, 1)
        out = forward(x_adv, label)
        return grads[0], _fgsm_ce(mx, probs, label), _fgsm_ce(mx, out, label)

    mod = mx.mod.Module(net, context=gpu)
    mod.bind(data_shapes=[("data", (BATCH,) + IMAGE)],
             label_shapes=[("softmax_label", (BATCH,))],
             for_training=True, inputs_need_grad=True)
    mod.set_params({k: mx.nd.array(v, ctx=gpu) for k, v in
                    weights[0].items()},
                   {k: mx.nd.array(v, ctx=gpu) for k, v in
                    weights[1].items()})

    def exec_attack(x, label):
        mod.forward(mx.io.DataBatch([x], [label]), is_train=True)
        mod.backward()
        g = mod.get_input_grads()[0]
        ce = _fgsm_ce(mx, mod.get_outputs()[0], label)
        x_adv = mx.nd.clip(x + FGSM_EPS * mx.nd.sign(g), 0, 1)
        mod.forward(mx.io.DataBatch([x_adv], [label]), is_train=True)
        return g, ce, _fgsm_ce(mx, mod.get_outputs()[0], label)

    # the input gradient against the executor's, plain plan, one batch
    with _deterministic_cudnn(torch):
        g_walk = walk_attack(xs[0], ys[0])[0].asnumpy()
        with fused_kernels("0"):
            ref = _executor_step(mx, net, weights, X[:BATCH], y[:BATCH],
                                 gpu)["grad:data"]
    l2 = _rel_l2(np, {"g": g_walk.astype(np.float64)}, {"g": ref}, ["g"])
    log("autograd fgsm: input gradient through grad_and_loss over the "
        "nd walk against the executor's (MXTPU_FUSED_KERNELS=0, "
        "deterministic cuDNN): relative L2 %.3g (bound %g)" % (
            l2, EXT_GRAD_REL_L2))
    check(l2 <= EXT_GRAD_REL_L2, "autograd fgsm: input gradient disagrees")
    exec_attack(xs[0], ys[0])                       # warm
    times = collections.defaultdict(list)
    for which in ("autograd", "executor", "executor", "autograd"):
        attack = walk_attack if which == "autograd" else exec_attack
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(EXT_FGSM_BATCHES):
            g, ce, ce_adv = attack(xs[i], ys[i])
            rise = float(ce_adv.asscalar()) - float(ce.asscalar())
            check(np.isfinite(rise) and rise > 0, "%s fgsm: the "
                  "cross-entropy did not rise" % which)
        torch.cuda.synchronize()
        times[which].append((time.perf_counter() - t0) * 1e3
                            / EXT_FGSM_BATCHES)
    log("autograd fgsm: ms per attack batch (batch %d, eps %g) through "
        "contrib.autograd %s, through the executor (Module, "
        "inputs_need_grad) %s, in turns on %s" % (
            BATCH, FGSM_EPS, " / ".join("%.2f" % v for v in
                                        times["autograd"]),
            " / ".join("%.2f" % v for v in times["executor"]), card))
    check(not mx.autograd.is_recording(), "autograd left recording on")


def mirror_recompute_calls(mx, plan, segments, shapes):
    """``fused_bn_act`` calls the backward's recompute of ``segments``
    makes: each segment's bn_act and bn_fold sites, and each merged group
    once in the segment holding its first member (a later segment slices
    the body handed on); a shape-ineligible grouped pair calls it per
    member wherever the member lies."""
    full = mx.mxfuse.bn_sites(plan)
    per_group = {}
    for members in full["concat"]:
        fn = mx.mxfuse._override_fn(plan, members[0])
        per_group[fn.group] = len(mx.mxfuse._group_shapes(fn, members,
                                                          shapes))
    total, carried = 0, set()
    for seg in segments:
        sites = mx.mxfuse.bn_sites(seg.entries)
        total += len(sites["bn_act"]) + len(sites["bn_fold"])
        for members in sites["concat"]:
            key = mx.mxfuse._override_fn(seg.entries, members[0]).group
            if per_group[key] == 1:
                total += 0 if key in carried else 1
            else:
                total += len(members)
        carried = set(seg.memo_out)
    return total


def _memcost_trainer(mx, net, dtype, remat, weights=None):
    tr = mx.parallel.SPMDTrainer(net, "sgd", {"learning_rate": MEMCOST_LR},
                                 compute_dtype=dtype, remat=remat,
                                 ctx=mx.gpu(0))
    tr.bind([("data", (BATCH,) + IMAGE)], [("softmax_label", (BATCH,))])
    if weights is None:
        tr.init_params(mx.initializer.Xavier())
    else:
        tr.init_params(None, *weights)
    return tr


def phase_mirror(torch, mx, seed, card):
    """Inception-BN trained through SPMDTrainer with inception_memcost.py's
    settings at batch 32, float32 and bfloat16, mirror off and on in
    turns: peak memory lower with the mirror, bn_act launches a mirrored
    step as the segments imply, ms per step; one batch-4 step's gradients
    mirror on against off; then an executor's close.  Returns the
    mirrored steps' bn_act launches."""
    import numpy as np
    ba = mx.kernels.bn_act
    net = zoo_symbol(mx, "inception-bn", IMAGE, 1000)
    shapes = mx.mxfuse.output_shapes(net, data=(BATCH,) + IMAGE)
    dev = torch.device("cuda", 0)
    rs = np.random.RandomState(seed + 140)
    x = torch.from_numpy(rs.standard_normal((BATCH,) + IMAGE)
                         .astype(np.float32)).to(dev)
    y = torch.from_numpy(rs.randint(0, 1000, BATCH).astype(np.float32)) \
        .to(dev)
    launches = [0, 0]
    for dtype in ("float32", "bfloat16"):
        mx.random.seed(seed + 141)
        off = _memcost_trainer(mx, net, dtype, False)
        on = _memcost_trainer(mx, net, dtype, True, off.get_params())
        segs = on._eval.segments
        per_step = len(mx.mxfuse.bn_act_calls(on._eval.train_plan, shapes,
                                              True))
        recompute = mirror_recompute_calls(mx, on._eval.train_plan, segs,
                                           shapes)
        carried = sum(len(s.memo_out) for s in segs)
        for t in (off, on):
            t.step(x, y)                            # warm
        torch.cuda.synchronize()
        # -- the main path: counts zeroed just before, read just after -----
        ba.LAUNCHES = 0
        ba.BWD_LAUNCHES = 0
        on.step(x, y)
        torch.cuda.synchronize()
        fwd, bwd = ba.LAUNCHES, ba.BWD_LAUNCHES
        # ------------------------------------------------------------------
        launches[0] += fwd
        launches[1] += bwd
        log("mirror %s: %d segments (MXNET_MIRROR_SEGMENTS default, sqrt "
            "of %d ops), %d merged bodies handed across a boundary; bn_act "
            "launches a mirrored step %d forward / %d backward (plan: %d + "
            "%d recomputed / %d)" % (
                dtype, len(segs), sum(1 for n_ in net._nodes()
                                      if n_.op is not None), carried, fwd,
                bwd, per_step, recompute, per_step))
        check((fwd, bwd) == (per_step + recompute, per_step),
              "mirror %s: bn_act launches %s" % (dtype, (fwd, bwd)))
        peaks, times = collections.defaultdict(list), \
            collections.defaultdict(list)
        for which in ("off", "on", "on", "off"):
            t = on if which == "on" else off
            gc.collect()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            for _ in range(EXT_MIRROR_STEPS):
                out = t.step(x, y)[0]
            torch.cuda.synchronize()
            times[which].append((time.perf_counter() - t0) * 1e3
                                / EXT_MIRROR_STEPS)
            peaks[which].append((torch.cuda.max_memory_allocated() - base)
                                / 2 ** 30)
            check(bool(torch.isfinite(out).all()), "mirror %s %s: output "
                  "not finite" % (dtype, which))
        log("mirror %s: step peak memory above the resident %.3f / %.3f GiB "
            "off, %.3f / %.3f GiB on; ms per step off %s, on %s (turns of "
            "%d steps, batch %d) on %s" % (
                dtype, peaks["off"][0], peaks["off"][1], peaks["on"][0],
                peaks["on"][1], " / ".join("%.2f" % v for v in times["off"]),
                " / ".join("%.2f" % v for v in times["on"]),
                EXT_MIRROR_STEPS, BATCH, card))
        check(max(peaks["on"]) < min(peaks["off"]),
              "mirror %s: peak memory not lower with the mirror" % dtype)
        check(off.skipped_steps == 0 and on.skipped_steps == 0,
              "mirror %s: guard-skipped steps" % dtype)
        off.close()
        on.close()
        del off, on
        gc.collect()
        torch.cuda.empty_cache()
    # one batch-4 step, mirror on against off, deterministic cuDNN
    shape = (EXT_MIRROR_BATCH,) + IMAGE
    weights = draw_weights(net, shape, seed + 142)
    xs = rs.standard_normal(shape).astype(np.float32)
    ys = rs.randint(0, 1000, EXT_MIRROR_BATCH).astype(np.float32)
    res = {}
    with _deterministic_cudnn(torch):
        for on in (False, True):
            with mirror_env(on):
                res[on] = _executor_step(mx, net, weights, xs, ys, mx.gpu(0))
    keys = [k for k in res[False] if k.startswith("grad:")]
    l2 = _rel_l2(np, res[True], res[False], keys)
    state = [k for k in res[False] if not k.startswith("grad:")]
    s_ratio, s_key = _worst_max_rel(np, res[True], res[False], state)
    log("mirror: batch-%d step, %d gradients mirror on against off: "
        "relative L2 %.3g (bound %g); outputs and moving statistics worst "
        "%s %.3g" % (EXT_MIRROR_BATCH, len(keys), l2, EXT_MIRROR_REL_L2,
                     s_key, s_ratio))
    check(l2 <= EXT_MIRROR_REL_L2 and s_ratio <= EXT_MIRROR_REL_L2,
          "mirror: gradients or moving statistics differ from the plain "
          "step")
    phase_executor_close(torch, mx, net, seed)
    return launches


def phase_executor_close(torch, mx, net, seed):
    """Bind Inception-BN on caller arrays, run a step and the next step's
    forward (its graph held), close: card memory back to what it was
    before the bind, the caller's arrays readable."""
    import numpy as np
    gpu = mx.gpu(0)
    shape = (BATCH,) + IMAGE
    w_args, w_aux = draw_weights(net, shape, seed + 150)
    rs = np.random.RandomState(seed + 151)
    x = rs.standard_normal(shape).astype(np.float32)
    y = rs.randint(0, 1000, BATCH).astype(np.float32)
    names = net.list_arguments()
    arg_shapes, _, _ = net.infer_shape(data=shape, softmax_label=(BATCH,))
    args = {n: mx.nd.array(w_args[n] if n in w_args else np.zeros(s),
                           ctx=gpu) for n, s in zip(names, arg_shapes)}
    grads = {n: mx.nd.zeros(s, ctx=gpu) for n, s in zip(names, arg_shapes)
             if n not in ("data", "softmax_label")}
    aux = {n: mx.nd.array(v, ctx=gpu) for n, v in w_aux.items()}
    for _ in range(2):
        # the first round leaves what the process keeps across executors
        # (cuBLAS's workspace: 4 MiB in the first chip run); the second
        # is held
        gc.collect()
        torch.cuda.synchronize()
        m0 = torch.cuda.memory_allocated()
        ex = net.bind(gpu, args, args_grad=grads, aux_states=aux)
        ex.forward(is_train=True, data=x, softmax_label=y)
        ex.backward()
        ex.forward(is_train=True, data=x, softmax_label=y)
        torch.cuda.synchronize()
        m1 = torch.cuda.memory_allocated()
        ex.close()
        gc.collect()
        torch.cuda.synchronize()
        m2 = torch.cuda.memory_allocated()
    readable = all(np.isfinite(a.asnumpy()).all()
                   for d in (args, grads, aux) for a in d.values())
    moved = sum(float(np.abs(g.asnumpy()).sum()) > 0 for g in grads.values())
    log("executor close: card memory %.3f GiB before the bind, %.3f GiB "
        "with a step done and the next forward's graph held, %.3f GiB after "
        "close (freed %.3f GiB of the executor's own); the caller's %d "
        "arrays read back finite: %s, %d of %d gradients non-zero" % (
            m0 / 2 ** 30, m1 / 2 ** 30, m2 / 2 ** 30, (m1 - m2) / 2 ** 30,
            len(args) + len(grads) + len(aux), readable, moved, len(grads)))
    check(m2 - m0 <= 2 ** 20 and m1 - m2 > 2 ** 27,
          "executor close: card memory did not return (%d -> %d -> %d)"
          % (m0, m1, m2))
    check(readable and moved > 0.9 * len(grads),
          "executor close: the caller's arrays are gone")


def extension_paths(torch, mx, seed, card):
    """The extension surface at ResNet-50 and Inception-BN width: a
    NumpySoftmax head and a TorchModule head through Module.fit, a
    Monitor, FGSM through contrib.autograd, the mirror memory mode and
    Executor.close.  Returns the main paths' bn_act launches."""
    launches = collections.Counter()
    for phase in (phase_custom_head, phase_torch_head):
        fwd, bwd = phase(torch, mx, seed, card)
        launches.update({"bn_act_fwd": fwd, "bn_act_bwd": bwd})
        gc.collect()
        torch.cuda.empty_cache()
    phase_monitor(torch, mx, seed, card)
    phase_autograd_fgsm(torch, mx, seed, card)
    gc.collect()
    torch.cuda.empty_cache()
    fwd, bwd = phase_mirror(torch, mx, seed, card)
    launches.update({"bn_act_fwd": fwd, "bn_act_bwd": bwd})
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# the input pipeline: seeded JPEG .rec files, the decode routes, the upload,
# Inception-BN training and ResNet-50 scoring fed from a .rec
# ---------------------------------------------------------------------------

def seeded_image(rs, h, w, noise=8.0, cells=6):
    """An (h, w, 3) uint8 image: a smooth random field (bilinear over a
    ``cells`` x ``cells`` grid of random colors) plus Gaussian noise, so a
    JPEG of it weighs about what a photo of its size does."""
    import numpy as np
    grid = rs.rand(cells + 1, cells + 1, 3) * 255.0
    y = np.linspace(0, cells, h)
    x = np.linspace(0, cells, w)
    y0 = np.minimum(y.astype(int), cells - 1)
    x0 = np.minimum(x.astype(int), cells - 1)
    fy = (y - y0)[:, None, None]
    fx = (x - x0)[None, :, None]
    img = (grid[y0][:, x0] * (1 - fy) * (1 - fx)
           + grid[y0 + 1][:, x0] * fy * (1 - fx)
           + grid[y0][:, x0 + 1] * (1 - fy) * fx
           + grid[y0 + 1][:, x0 + 1] * fy * fx)
    img += rs.normal(0.0, noise, img.shape)
    return np.clip(img + 0.5, 0, 255).astype(np.uint8)


def detection_label(rs, classes=20):
    """A flat detection label ``[2, 5, (id, x1, y1, x2, y2) * k]``, k in
    1..3, coordinates normalized to [0, 1]."""
    import numpy as np
    k = rs.randint(1, 4)
    boxes = []
    for _ in range(k):
        x1, y1 = rs.uniform(0.0, 0.6, 2)
        x2, y2 = x1 + rs.uniform(0.2, 0.4), y1 + rs.uniform(0.2, 0.4)
        boxes.append([rs.randint(0, classes), x1, y1, x2, y2])
    return np.concatenate([[2.0, 5.0], np.asarray(boxes).reshape(-1)]
                          ).astype(np.float32)


def write_seeded_rec(recordio, prefix, n, short, seed, classes=1000,
                     det=False, quality=90, long_range=(3.0 / 4, 4.0 / 3)):
    """``prefix.rec`` / ``prefix.idx`` of ``n`` seeded JPEGs (``recordio``
    is either package's module) at ImageNet's layout: short side
    ``short``, aspect ratios in ``long_range``, labels from ``classes``
    classes (``det``: detection labels).  Returns the mean JPEG bytes."""
    import numpy as np
    rs = np.random.RandomState(seed)
    rec = recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    total = 0
    try:
        for i in range(n):
            ratio = rs.uniform(*long_range)
            h, w = (short, int(short * ratio)) if ratio >= 1 else \
                (int(short / ratio), short)
            img = seeded_image(rs, h, w)
            label = detection_label(rs) if det else \
                float(rs.randint(0, classes))
            payload = recordio.pack_img((0, label, i, 0), img,
                                        quality=quality)
            total += len(payload)
            rec.write_idx(i, payload)
    finally:
        rec.close()
    return total / float(n)


IN_IMAGES = 640         # seeded JPEGs of the training .rec (20 batches of 32)
IN_SHORT = 256          # their short side: ImageNet's resized layout
IN_DET_IMAGES = 64      # seeded JPEGs of the detection .rec
IN_DET_SHAPE = (3, 300, 300)   # example/ssd's input
#: example/image-classification/common/data.py: --rgb-mean, --data-nthreads
IN_MEAN = dict(mean_r=123.68, mean_g=116.779, mean_b=103.939)
IN_THREADS = 4
IN_WARM = 2             # fit batches before the measured window
IN_FIT_BATCHES = 2      # measured batches of each feed in each turn
IN_FEED_ORDER = "abcd"  # one turn of the four feeds (two turns, ABBA, before)
IN_PROFILE_BATCHES = 2  # batches of each feed's traced window
IN_RATE_BATCHES = 2     # batches a decode-rate run reads after one warm-up
IN_UPLOAD_REPS = 10
IN_SCORE_BATCHES = 4
IN_SEED = 90
#: nvJPEG against the JAX package's exact libjpeg decode (another IDCT and
#: chroma upsampling): mean and largest absolute difference in levels
NVJPEG_MEAN_ABS = 2.0
NVJPEG_MAX_ABS = 32


def in_train_iter(mx, rec, seed, pad=True, ctx=None, **kw):
    """The example's train iterator (common/data.py:get_rec_iter) over
    ``rec``: ``pad=0`` as the example always passes it (the process
    route), or without ``pad`` (the native route)."""
    args = dict(path_imgrec=rec + ".rec", label_width=1, data_name="data",
                label_name="softmax_label", data_shape=IMAGE,
                batch_size=BATCH, rand_crop=True, max_random_scale=1.0,
                min_random_scale=1.0, rand_mirror=True,
                preprocess_threads=IN_THREADS, shuffle=True, seed=seed,
                ctx=ctx, **IN_MEAN)
    if pad:
        args["pad"] = 0
    args.update(kw)
    return mx.io.ImageRecordIter(**args)


def in_val_iter(mx, rec, seed, ctx=None, **kw):
    """The example's val iterator: center crop, no mirror (native)."""
    args = dict(path_imgrec=rec + ".rec", label_width=1, data_name="data",
                label_name="softmax_label", data_shape=IMAGE,
                batch_size=BATCH, rand_crop=False, rand_mirror=False,
                preprocess_threads=IN_THREADS, seed=seed, ctx=ctx, **IN_MEAN)
    args.update(kw)
    return mx.io.ImageRecordIter(**args)


def phase_input_probe(torch, mx):
    """What the card's host offers the input pipeline; builds the native
    library (and, without libjpeg, the nvJPEG decoder)."""
    import ctypes.util
    import glob
    heads = [p for p in ["/usr/include/jpeglib.h"]
             + glob.glob("/usr/include/*/jpeglib.h") if os.path.exists(p)]
    log("probe: jpeglib.h %s" % (", ".join(heads) or "missing"))
    log("probe: libjpeg.so %s" % (ctypes.util.find_library("jpeg")
                                   or "missing"))
    found = {}
    for name in ("cv2", "PIL"):
        try:
            m = __import__(name)
            found[name] = True
            log("probe: %s %s" % (name, m.__version__))
        except ImportError:
            found[name] = False
            log("probe: %s missing" % name)
    nvh = os.path.join(mx.native.cuda_home(), "include", "nvjpeg.h")
    log("probe: nvjpeg.h %s" % (nvh if os.path.exists(nvh) else "missing"))
    gxx = shutil.which("g++")
    ver = subprocess.run([gxx, "--version"], capture_output=True,
                         text=True).stdout.splitlines()[0] if gxx else ""
    log("probe: g++ %s (%s)" % (gxx or "missing", ver))
    log("probe: os.cpu_count() %d, cores this process may use %d" % (
        os.cpu_count(), len(os.sched_getaffinity(0))))
    secs = mx.native.build()
    lib = mx.native.get_lib()
    log("probe: native library %s built in %.2f s; libjpeg pipeline %s" % (
        os.path.basename(mx.native.library_path()), secs,
        "yes" if lib._has_imagedec else "no"))
    found["libjpeg"] = bool(lib._has_imagedec)
    if not lib._has_imagedec:
        err = (mx.native.JPEG_BUILD_ERROR or "").strip().splitlines()
        log("probe: the libjpeg build failed (%s): the native route cannot "
            "decode with libjpeg on this host; it decodes on the card with "
            "nvJPEG" % (err[0] if err else "?"))
        t0 = time.perf_counter()
        mx.native.nvjpeg_lib()
        log("probe: nvJPEG decoder library built in %.2f s" % (
            time.perf_counter() - t0))
    return found


def phase_input_recs(mx, tmp, seed):
    """The seeded training .rec/.idx and the detection .rec."""
    train = os.path.join(tmp, "train")
    t0 = time.perf_counter()
    mean = write_seeded_rec(mx.recordio, train, IN_IMAGES, IN_SHORT, seed)
    log("input: train.rec: %d JPEGs (quality 90), short side %d, aspect "
        "3:4 to 4:3, labels from 1000 classes: %.0f bytes a JPEG on "
        "average, %.1f MB, written in %.1f s" % (
            IN_IMAGES, IN_SHORT, mean, os.path.getsize(train + ".rec")
            / 1e6, time.perf_counter() - t0))
    det = os.path.join(tmp, "det")
    mean = write_seeded_rec(mx.recordio, det, IN_DET_IMAGES, IN_SHORT,
                            seed + 1, det=True)
    log("input: det.rec: %d JPEGs with 1-3 boxes each, %.0f bytes a JPEG" % (
        IN_DET_IMAGES, mean))
    return train, det


def _rate(torch, it, batches=IN_RATE_BATCHES):
    """img/s of ``batches`` batches after one warm-up batch."""
    it.next()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = 0
    for _ in range(batches):
        b = it.next()
        n += BATCH - b.pad
    torch.cuda.synchronize()
    return n / (time.perf_counter() - t0)


def phase_decode_rates(torch, mx, train, seed, card):
    """Decode rate of each ImageRecordIter route into gpu(0), in img/s."""
    dev = mx.gpu(0)
    cores = os.cpu_count()
    old = os.environ.get("MXNET_JPEG_DECODE_FAST")  # mxlint: disable=env-direct-read (saved to restore)
    try:
        for threads in sorted({1, IN_THREADS, cores}):
            for dtype in ("float32", "uint8", "bfloat16"):
                for fast in ("1", "0"):
                    os.environ["MXNET_JPEG_DECODE_FAST"] = fast
                    it = in_train_iter(mx, train, seed, pad=False, ctx=dev,
                                       preprocess_threads=threads,
                                       dtype=dtype)
                    check(it.route == "native", "decode rate: route %s"
                          % it.route)
                    rate = _rate(torch, it)
                    backend = it._pipeline.backend
                    it.close()
                    log("input decode: native route (%s) preprocess_threads"
                        " %d, %s, fast DCT %s: %.0f img/s on %s" % (
                            backend, threads, dtype,
                            "on" if fast == "1" else "off", rate, card))
    finally:
        if old is None:
            os.environ.pop("MXNET_JPEG_DECODE_FAST", None)
        else:
            os.environ["MXNET_JPEG_DECODE_FAST"] = old
    t0 = time.perf_counter()
    it = in_train_iter(mx, train, seed, ctx=dev)
    check(it.route == "process", "the example's train iterator took the %s "
          "route" % it.route)
    rate = _rate(torch, it)
    log("input decode: process route at the example's arguments (%d "
        "workers, pad=0): %.0f img/s (%.1f s with the workers' start) on %s"
        % (IN_THREADS, rate, time.perf_counter() - t0, card))
    it.close()
    augs = [mx.image.RandomCropAug((IMAGE[2], IMAGE[1])),
            mx.image.HorizontalFlipAug(0.5), mx.image.CastAug(),
            mx.image.ColorNormalizeAug(
                [IN_MEAN["mean_r"], IN_MEAN["mean_g"], IN_MEAN["mean_b"]],
                None)]
    it = in_train_iter(mx, train, seed, pad=False, ctx=dev, aug_list=augs)
    check(it.route == "engine", "aug_list took the %s route" % it.route)
    rate = _rate(torch, it, IN_RATE_BATCHES // 2)
    log("input decode: engine route with an aug_list (%d workers): %.0f "
        "img/s on %s" % (IN_THREADS, rate, card))
    it.close()


def phase_upload_rates(torch, mx, tr, card):
    """The (32, 3, 224, 224) batch to the card in float32, uint8 and
    bfloat16: pageable ``.to()``, a pinned ``non_blocking`` copy on the
    side stream (``dataflow.Uploader``) and ``SPMDTrainer.stage_batch``
    from a pageable host tensor (its pinned staging included)."""
    dev = mx.gpu(0).torch_device
    label = torch.zeros(BATCH)
    up = mx.dataflow.Uploader(dev)
    rows = {}
    for dtype in (torch.float32, torch.uint8, torch.bfloat16):
        host = (torch.rand((BATCH,) + IMAGE) * 255).to(dtype)
        pinned = host.pin_memory()
        nbytes = host.numel() * host.element_size()

        def pageable():
            host.to(dev)
            torch.cuda.synchronize()

        def side():
            _, event = up.upload([pinned])
            event.synchronize()

        def staged():
            sb = tr.stage_batch(host, label)
            sb.event.synchronize()

        for how, fn in (("pageable .to()", pageable),
                        ("pinned non_blocking side stream", side),
                        ("stage_batch", staged)):
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(IN_UPLOAD_REPS):
                fn()
            ms = (time.perf_counter() - t0) * 1e3 / IN_UPLOAD_REPS
            rows[(str(dtype).split(".")[-1], how)] = ms
            log("input upload: %s %.1f MB by %s: %.3f ms, %.2f GB/s on %s"
                % (str(dtype).split(".")[-1], nbytes / 1e6, how, ms,
                   nbytes / ms / 1e6, card))
        sb = tr.stage_batch(host, label)
        mx.dataflow.wait(list(sb.values()), sb.event)
        check(torch.equal(sb["data"].cpu(), host),
              "a staged %s batch differs from its host bytes" % dtype)
    return rows


def _in_module(torch, mx, seed):
    """Inception-BN in a Module on gpu(0) with a fused trainer
    (kvstore='tpu'), bench.py's ResNet sgd settings."""
    net = zoo_symbol(mx, "inception-bn", IMAGE, 1000)
    mod = mx.mod.Module(net, context=mx.gpu(0))
    mod.bind([("data", (BATCH,) + IMAGE)], [("softmax_label", (BATCH,))])
    mx.random.seed(seed)
    mod.init_params(mx.initializer.Xavier(rnd_type="gaussian",
                                          factor_type="in", magnitude=2))
    mod.init_optimizer(kvstore="tpu", optimizer="sgd", optimizer_params={
        "learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4,
        "rescale_grad": 1.0 / BATCH})
    check(mod._fused is not None, "inception-bn Module took no fused route")
    return net, mod


def _in_fit(torch, mx, mod, feed, batches, window, prof=None):
    """One epoch of ``Module.fit(kvstore='tpu')`` over ``batches`` batches
    of ``feed``; the host clock (and ``prof``, when given) over the
    ``window`` batches after IN_WARM.  Returns (ms a batch, counts)."""
    ba = mx.kernels.bn_act
    stamps = {}

    def on_batch(param):
        if param.nbatch in (IN_WARM - 1, IN_WARM - 1 + window):
            torch.cuda.synchronize()
            stamps[param.nbatch] = time.perf_counter()
            if prof is not None:
                (prof.start if param.nbatch == IN_WARM - 1
                 else prof.stop)()

    torch.cuda.synchronize()
    # -- the main path: counts zeroed just before, read just after ---------
    ba.LAUNCHES = 0
    ba.BWD_LAUNCHES = 0
    mod.fit(mx.io.ResizeIter(feed, batches), kvstore="tpu", optimizer="sgd",
            batch_end_callback=on_batch, num_epoch=1)
    torch.cuda.synchronize()
    counts = (ba.LAUNCHES, ba.BWD_LAUNCHES)
    # ----------------------------------------------------------------------
    ms = (stamps[IN_WARM - 1 + window] - stamps[IN_WARM - 1]) * 1e3 / window
    return ms, counts


def _htod_us(path):
    """Host-to-device copy time in a chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sum(float(e.get("dur", 0)) for e in events
               if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", ""))


def _traced(torch, run):
    """(busy ms, HtoD copy ms, kernels) of ``run(prof)``, which starts and
    stops the profiler it is given."""
    build_dir = os.path.join(ROOT, "mxnet_tpu_torch", "_build")
    os.makedirs(build_dir, exist_ok=True)
    fd, path = tempfile.mkstemp(prefix="in-trace-", suffix=".json",
                                dir=build_dir)
    os.close(fd)
    try:
        prof = _profiler(torch)
        out = run(prof)
        prof.export_chrome_trace(path)
        busy_us, _, n_kernels, _, _ = _trace_classes(path, None)
        htod = _htod_us(path)
    finally:
        os.remove(path)
    return out, busy_us / 1e3, htod / 1e3, n_kernels


def phase_ibn_feeds(torch, mx, train, seed, card):
    """Inception-BN trained through Module.fit(kvstore='tpu') at batch 32,
    fed four ways in turn (``IN_FEED_ORDER``): (a) the example's train
    iterator (process route), (b) the same without pad (native route),
    (c) (b) through DevicePrefetchIter(stage=module), (d) the same decoded
    batches in an NDArrayIter.  ms a batch, idle share and bn_act
    launches a step."""
    import numpy as np
    net, mod = _in_module(torch, mx, seed + 1)
    per = zoo_report(mx, net, (BATCH,) + IMAGE)["bn_act_calls_train"]
    batches = IN_WARM + IN_FIT_BATCHES
    dev = mx.gpu(0)
    src = in_train_iter(mx, train, seed, pad=False, ctx=dev)
    held = [src.next() for _ in range(batches)]
    src.close()
    X = np.concatenate([b.data[0].asnumpy() for b in held])
    Y = np.concatenate([b.label[0].asnumpy() for b in held])
    del held

    def feed(which):
        """(the iterator fit reads, the iterators to close after)"""
        if which == "d":
            it = mx.io.NDArrayIter(X, Y, batch_size=BATCH)
            return it, [it]
        it = in_train_iter(mx, train, seed, pad=(which == "a"), ctx=dev)
        check(it.route == ("process" if which == "a" else "native"),
              "feed (%s) took the %s route" % (which, it.route))
        if which == "c":
            pre = mx.DevicePrefetchIter(it, stage=mod)
            return pre, [pre, it]
        return it, [it]

    names = {"a": "process route (the example's, pad=0)",
             "b": "native route", "c": "native route + DevicePrefetchIter",
             "d": "decoded batches in an NDArrayIter"}
    times = collections.defaultdict(list)
    launches = collections.Counter()
    # one iterator a feed for every fit: each fit's epoch end resets it
    feeds = {which: feed(which) for which in "abcd"}
    try:
        for which in IN_FEED_ORDER:
            ms, (fwd, bwd) = _in_fit(torch, mx, mod, feeds[which][0],
                                     batches, IN_FIT_BATCHES)
            check(fwd == bwd == per * batches, "feed (%s): bn_act launches "
                  "%d / %d over %d batches, plan %d a step" % (
                      which, fwd, bwd, batches, per))
            launches.update({"bn_act_fwd": fwd, "bn_act_bwd": bwd})
            times[which].append(ms)
        traced = {}
        for which in "abcd":
            traced[which] = _traced(torch, lambda prof: _in_fit(
                torch, mx, mod, feeds[which][0],
                IN_WARM + IN_PROFILE_BATCHES, IN_PROFILE_BATCHES, prof))
    finally:
        for _, owned in feeds.values():
            for o in owned:
                o.close()
    for which in "abcd":
        (ms, _), busy, htod, kernels = traced[which]
        wall = ms * IN_PROFILE_BATCHES
        log("inception-bn fit, feed (%s) %s: %s ms a batch (%d turn(s) of "
            "%d batches, batch %d); traced window %.2f ms a batch, device "
            "busy %.2f ms, idle share %.3f, host-to-device copies %.3f ms a "
            "batch, %.0f kernels a batch; %d + %d bn_act launches a step; "
            "on %s" % (which, names[which], " / ".join(
                "%.2f" % v for v in times[which]), len(times[which]),
                IN_FIT_BATCHES, BATCH, ms,
                busy / IN_PROFILE_BATCHES, 1 - busy / wall,
                htod / IN_PROFILE_BATCHES, kernels / IN_PROFILE_BATCHES,
                per, per, card))
    for which in "abc":
        log("inception-bn fit: feed (%s) costs %+.2f ms a batch over (d)" % (
            which, np.mean(times[which]) - np.mean(times["d"])))
    out = mod.get_outputs()[0].asnumpy()
    check(np.isfinite(out).all(), "inception-bn fit: outputs not finite")
    del mod
    return launches


def phase_resnet_score(torch, mx, train, seed, card):
    """ResNet-50 scored through Module.score, fed by the example's val
    iterator (native route, center crop): img/s and the share of device
    time in host-to-device copies."""
    import numpy as np
    ba = mx.kernels.bn_act
    net = zoo_symbol(mx, "resnet-50", IMAGE, 1000)
    args, aux = draw_weights(net, (BATCH,) + IMAGE, seed + 2)
    host = mx.cpu()
    mod = mx.mod.Module(net, context=mx.gpu(0))
    mod.bind([("data", (BATCH,) + IMAGE)], [("softmax_label", (BATCH,))],
             for_training=False)
    mod.set_params({k: mx.nd.array(v, ctx=host) for k, v in args.items()},
                   {k: mx.nd.array(v, ctx=host) for k, v in aux.items()})
    per = zoo_report(mx, net, (BATCH,) + IMAGE)["bn_act_calls_infer"]
    it = in_val_iter(mx, train, seed, ctx=mx.gpu(0))
    check(it.route == "native", "the val iterator took the %s route"
          % it.route)
    mod.score(it, "acc", num_batch=2)
    torch.cuda.synchronize()
    # -- the main path: counts zeroed just before, read just after ---------
    ba.LAUNCHES = 0
    t0 = time.perf_counter()
    res = mod.score(it, mx.metric.create(["acc", mx.metric.create(
        "top_k_accuracy", top_k=5)]), num_batch=IN_SCORE_BATCHES)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    fwd = ba.LAUNCHES
    # ----------------------------------------------------------------------
    check(fwd == per * IN_SCORE_BATCHES, "resnet-50 score: %d bn_act "
          "launches, plan %d a forward" % (fwd, per))
    check(all(np.isfinite(v) for _, v in res), "resnet-50 score: %s" % res)

    def window(prof):
        prof.start()
        t0 = time.perf_counter()
        mod.score(it, "acc", num_batch=4)
        torch.cuda.synchronize()
        prof.stop()
        return time.perf_counter() - t0

    wall, busy, htod, kernels = _traced(torch, window)
    log("resnet-50 score from the val iterator (%s): %d batches of %d in "
        "%.1f ms, %.0f img/s (the iterator's reset included); traced 4 "
        "batches: idle share %.3f, host-to-device copies %.3f ms of %.2f "
        "ms device time (%.1f%%; the pageable upload was 13%% of a "
        "forward's), %d bn_act launches a forward, metrics %s; on %s" % (
            it._pipeline.backend, IN_SCORE_BATCHES, BATCH, dt * 1e3,
            IN_SCORE_BATCHES * BATCH / dt, 1 - busy / (wall * 1e3),
            htod, busy, 100 * htod / busy, per, res, card))
    it.close()
    return fwd


def _route_batches(torch, mx, make, n=2):
    """First ``n`` batches of an iterator built on gpu(0) and on the CPU
    from the same arguments: ``[(card data, card label, cpu data, cpu
    label)]`` and the route."""
    out = []
    its = [make(mx.gpu(0)), make(mx.cpu())]
    for _ in range(n):
        g, c = its[0].next(), its[1].next()
        out.append((g.data[0]._data, g.label[0]._data, c.data[0]._data,
                    c.label[0]._data))
    route = its[0].route
    for it in its:
        it.close()
    return out, route


def phase_nvjpeg_fixture(torch, mx, tmp):
    """The nvJPEG decode, and the native route through it, against the JAX
    package's libjpeg decode of the committed fixture's JPEGs."""
    import numpy as np
    path = os.path.join(ROOT, "tests", "data", "nvjpeg_fixture.npz")
    dev = mx.gpu(0).torch_device
    f = np.load(path)
    n = len([k for k in f.files if k.startswith("jpeg_")])
    dec = mx.image._NvjpegDecoder(dev)
    diffs = []
    for i in range(n):
        got = dec.decode(f["jpeg_%d" % i].tobytes())
        check(got is not None, "nvJPEG rejected fixture JPEG %d" % i)
        ref = torch.from_numpy(f["pixels_%d" % i]).to(dev)
        check(tuple(got.shape) == tuple(ref.shape), "nvJPEG decode of %d: "
              "shape %s, libjpeg %s" % (i, tuple(got.shape),
                                        tuple(ref.shape)))
        d = (got.int() - ref.int()).abs()
        diffs.append((float(d.float().mean()), int(d.max())))
    dec.close()
    log("nvjpeg: decode of %d fixture JPEGs against libjpeg's exact decode: "
        "mean |diff| %s, max %s levels (limits %.1f, %d)" % (
            n, " ".join("%.3f" % m for m, _ in diffs),
            " ".join("%d" % x for _, x in diffs), NVJPEG_MEAN_ABS,
            NVJPEG_MAX_ABS))
    check(all(m <= NVJPEG_MEAN_ABS and x <= NVJPEG_MAX_ABS
              for m, x in diffs), "nvJPEG decode off libjpeg's")
    prefix = os.path.join(tmp, "fixture")
    w = mx.recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    for i in range(n):
        w.write_idx(i, mx.recordio.pack((0, float(i), i, 0),
                                        f["jpeg_%d" % i].tobytes()))
    w.close()
    crop = [int(v) for v in f["crop"]]
    it = mx.io.ImageRecordIter(prefix + ".rec", (3, crop[0], crop[1]), n,
                               seed=int(f["seed"]), dtype="uint8",
                               rand_crop=True, rand_mirror=True,
                               preprocess_threads=1, ctx=mx.gpu(0))
    check(it.route == "native" and it._pipeline.backend == "nvjpeg",
          "fixture iterator: %s/%s" % (it.route, it._pipeline.backend))
    got = it.next().data[0]._data
    it.close()
    d = (got.int() - torch.from_numpy(f["batch"]).to(dev).int()).abs()
    log("nvjpeg: native route (nvJPEG backend) batch of the fixture against "
        "the JAX package's libjpeg route: mean |diff| %.3f, max %d levels" % (
            float(d.float().mean()), int(d.max())))
    check(float(d.float().mean()) <= NVJPEG_MEAN_ABS
          and int(d.max()) <= NVJPEG_MAX_ABS,
          "nvJPEG route batch off the libjpeg route's")


def phase_input_agreement(torch, mx, train, det, seed, found, tmp):
    """Correctness on the card: each route's batch against the CPU path's
    (byte for byte; the nvJPEG backend against the fixture), a staged
    batch against its host bytes, an Inception-BN batch-4 step fed a
    StagedBatch against the step fed host arrays (bit for bit), the
    image I/O ops against the CPU, ImageDetRecordIter on the card against
    the CPU."""
    import random
    import numpy as np
    routes = {
        "process": lambda ctx: in_train_iter(mx, train, seed, ctx=ctx,
                                             preprocess_threads=2),
        "engine": lambda ctx: in_train_iter(
            mx, train, seed, pad=False, ctx=ctx, preprocess_threads=2,
            aug_list=[mx.image.RandomCropAug((IMAGE[2], IMAGE[1])),
                      mx.image.HorizontalFlipAug(0.5), mx.image.CastAug()]),
    }
    if found["libjpeg"]:
        routes["native"] = lambda ctx: in_train_iter(
            mx, train, seed, pad=False, ctx=ctx, dtype="bfloat16")
    else:
        log("input agreement: the native route decodes with nvJPEG on the "
            "card and cannot run on this host's CPU (no libjpeg): held "
            "against the fixture instead")
        phase_nvjpeg_fixture(torch, mx, tmp)
    for name, make in sorted(routes.items()):
        pairs, route = _route_batches(torch, mx, make)
        check(route == name, "route %s took %s" % (name, route))
        for gd, gl, cd, cl in pairs:
            check(gd.is_cuda and gl.is_cuda, "%s route: a batch is not on "
                  "the card" % name)
            check(torch.equal(gd.cpu(), cd) and torch.equal(gl.cpu(), cl),
                  "%s route: the card's batch differs from the CPU's" % name)
        log("input agreement: %s route, %d batches on gpu(0) equal the CPU "
            "path's byte for byte" % (name, len(pairs)))
    # an Inception-BN batch-4 step fed a StagedBatch against host arrays
    net = zoo_symbol(mx, "inception-bn", IMAGE, 1000)
    rs = np.random.RandomState(seed + 3)
    x = rs.standard_normal((4,) + IMAGE).astype(np.float32)
    y = rs.randint(0, 1000, 4).astype(np.float32)
    trs = []
    with _deterministic_cudnn(torch):
        for _ in range(2):
            mx.random.seed(seed + 4)
            tr = mx.parallel.SPMDTrainer(
                net, "sgd", {"learning_rate": 0.1, "momentum": 0.9,
                             "rescale_grad": 0.25}, mesh=None,
                ctx=mx.gpu(0))
            tr.bind([("data", (4,) + IMAGE)], [("softmax_label", (4,))])
            tr.init_params(mx.initializer.Xavier(rnd_type="gaussian",
                                                 factor_type="in",
                                                 magnitude=2))
            trs.append(tr)
        trs[1].set_params(*trs[0].get_params())
        sb = trs[1].stage_batch(x, y)
        staged = mx.io.StagedBatch(sb, data=[x], label=[y])
        o0 = trs[0].step(x, y, key=7)[0]
        o1 = trs[1].step(staged, key=7)[0]
        torch.cuda.synchronize()
    same = torch.equal(o0, o1) and all(
        torch.equal(trs[0].params[k], trs[1].params[k])
        for k in trs[0].params)
    log("input agreement: inception-bn batch-4 step fed a StagedBatch %s the "
        "step fed host arrays bit for bit (outputs and %d params)" % (
            "equals" if same else "DIFFERS from", len(trs[0].params)))
    check(same, "StagedBatch step differs from the host-array step")
    for tr in trs:
        tr.close()
    # the image I/O ops on the card against the CPU
    rs = np.random.RandomState(seed + 5)
    worst = {}
    for dtype in ("uint8", "float32"):
        src = (rs.rand(IN_SHORT, 341, 3) * 255).astype(dtype)
        for interp in range(5):
            outs = [mx.nd.imresize(mx.nd.array(src, ctx=ctx, dtype=dtype),
                                   w=224, h=224, interp=interp).asnumpy()
                    for ctx in (mx.gpu(0), mx.cpu())]
            d = np.abs(outs[0].astype(np.float64) - outs[1]).max()
            bound = 1 if dtype == "uint8" else 1e-5 * np.abs(outs[1]).max()
            check(d <= bound, "imresize %s interp %d: card off the CPU by "
                  "%g" % (dtype, interp, d))
            worst[(dtype, interp)] = d
        borders = [mx.nd.copyMakeBorder(mx.nd.array(src, ctx=ctx,
                                                    dtype=dtype),
                                        top=2, bot=3, left=4, right=5,
                                        value=9).asnumpy()
                   for ctx in (mx.gpu(0), mx.cpu())]
        check(np.array_equal(*borders), "copyMakeBorder %s: card != CPU"
              % dtype)
    log("input agreement: imresize (256x341 -> 224x224) on the card against "
        "the CPU, largest difference per (dtype, interp): %s; copyMakeBorder "
        "equal" % ", ".join("%s/%d %.3g" % (k[0], k[1], v)
                             for k, v in sorted(worst.items())))
    # ImageDetRecordIter on the card against the CPU
    if not found["cv2"]:
        log("input agreement: cv2 missing: ImageDetRecordIter's resize "
            "cannot run here; tests/test_torch_image_det.py carries its "
            "parity")
        return
    batches = []
    for ctx in (mx.gpu(0), mx.cpu()):
        random.seed(seed)
        np.random.seed(seed)
        it = mx.io.ImageDetRecordIter(det + ".rec", IN_DET_SHAPE, 8,
                                      rand_crop_prob=0.5, rand_pad_prob=0.5,
                                      rand_mirror_prob=0.5, ctx=ctx,
                                      **IN_MEAN)
        batches.append([(b.data[0]._data.cpu(), b.label[0]._data.cpu(),
                         b.data[0]._data.device.type) for b in it])
    check(len(batches[0]) == len(batches[1]) == IN_DET_IMAGES // 8,
          "ImageDetRecordIter batches")
    check(batches[0][0][2] == "cuda", "ImageDetRecordIter: a batch is not "
          "on the card")
    for (gd, gl, _), (cd, cl, _) in zip(*batches):
        check(torch.equal(gd, cd) and torch.equal(gl, cl),
              "ImageDetRecordIter: the card's batch differs from the CPU's")
    log("input agreement: ImageDetRecordIter at %s, %d batches and padded "
        "labels (width %d) on gpu(0) equal the CPU's" % (
            IN_DET_SHAPE, len(batches[0]), batches[0][0][1].shape[1]))


def input_paths(torch, mx, seed, card):
    """The input pipeline on the card: the probe, seeded .rec files, decode
    and upload rates, Inception-BN trained through Module.fit fed four
    ways, ResNet-50 scored from the val iterator, and the agreement
    checks.  Returns the main paths' bn_act launches."""
    found = phase_input_probe(torch, mx)
    tmp = tempfile.mkdtemp(prefix="input-", dir=os.path.join(
        ROOT, "mxnet_tpu_torch", "_build"))
    try:
        train, det = phase_input_recs(mx, tmp, seed + IN_SEED)
        phase_decode_rates(torch, mx, train, seed, card)
        tr = make_trainer(torch, mx, seed)
        phase_upload_rates(torch, mx, tr, card)
        tr.close()
        del tr
        gc.collect()
        torch.cuda.empty_cache()
        launches = phase_ibn_feeds(torch, mx, train, seed, card)
        gc.collect()
        torch.cuda.empty_cache()
        launches["bn_act_fwd"] += phase_resnet_score(torch, mx, train, seed,
                                                     card)
        gc.collect()
        torch.cuda.empty_cache()
        phase_input_agreement(torch, mx, train, det, seed, found, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return launches



# ---------------------------------------------------------------------------
# the data service: decode workers over shared-memory rings, the network
# tier, on-device augmentation (DeviceAugment)
# ---------------------------------------------------------------------------

DS_WORKERS = (1, 2, 4)   # decode workers of the rate runs (the host has 8)
DS_MARGIN = 16           # device_augment's crop margin: a 3x240x240 canvas
DS_FIT_BATCHES = 2       # measured batches of each feed in each turn
DS_FEED_ORDER = "defgh"  # one turn of the five feeds (two, ABBA, before)
DS_COMPARE_BATCHES = 4   # batches held byte for byte between two streams
DS_AUG_REPS = 10         # augment calls in the traced window
DS_SERVERS = 2           # loopback server processes of the network tier
DS_SERVER_WORKERS = 2    # decode workers in each server
DS_RESIZE_REL_TOL = 1e-5  # the resize branch, card against CPU, x max|out|
#: the augmentation of every service feed: the example's crop and mirror,
#: with ImageNet's mean and std (DeviceAugment's settings)
DS_AUG = dict(rand_crop=True, rand_mirror=True, mean=True, std=True)


def ds_iter(mx, rec, seed, ctx, **kw):
    """An ``ImageRecordIter`` over the data service at the example's
    layout (``path_imgidx`` given, no ``pad``), checked to have taken the
    service's route (``"network"`` for a server list) with no fallback."""
    args = dict(path_imgrec=rec + ".rec", path_imgidx=rec + ".idx",
                label_width=1, data_name="data", label_name="softmax_label",
                data_shape=IMAGE, batch_size=BATCH,
                preprocess_threads=IN_THREADS, shuffle=True, seed=seed,
                ctx=ctx, data_service=True)
    args.update(kw)
    it = mx.io.ImageRecordIter(**args)
    want = "service" if args["data_service"] is True else "network"
    check(it._service is not None and it.route == want,
          "data service iterator took the %s route, not %s" % (it.route,
                                                              want))
    check((it._dev_aug is not None) == (args.get("device_augment")
                                        is not None),
          "device_augment=%r: DeviceAugment %s" % (
              args.get("device_augment"), it._dev_aug))
    return it


def _ds_batches(it, n):
    """The next ``n`` batches of ``it`` as private tensors."""
    out = []
    for _ in range(n):
        b = it.next()
        out.append((b.data[0]._data.clone(), b.label[0]._data.clone(),
                    b.pad))
    return out


def _ds_same(torch, a, b):
    """Two lists of ``_ds_batches`` equal byte for byte."""
    return len(a) == len(b) and all(
        torch.equal(x[0], y[0]) and torch.equal(x[1], y[1]) and x[2] == y[2]
        for x, y in zip(a, b))


def phase_ds_rates(torch, mx, train, seed, card, expect):
    """The local service's decode rate into gpu(0) at 1, 2 and 4 workers,
    each worker's decoder, and the 1-worker stream against the 4-worker
    one on the card."""
    dev = mx.gpu(0)
    rates = {}
    for workers in DS_WORKERS:
        t0 = time.perf_counter()
        it = ds_iter(mx, train, seed, dev, preprocess_threads=workers,
                     **DS_AUG)
        for _ in range(workers - 1):   # _rate warms one: one a worker
            it.next()
        rate = _rate(torch, it)
        st = it.stats()
        it.close()
        decoders = [w["decoder"] for _, w in sorted(st["workers"].items())]
        check(decoders == [expect] * workers, "data service workers decode "
              "with %s; the host probe predicts %s" % (decoders, expect))
        rates[workers] = rate
        log("data service: %d workers (decoders %s), float32 host-augmented "
            "into gpu(0): %.0f img/s (%.1f s with the workers' start; "
            "producer stall %.2f s, consumer stall %.2f s, ring occupancy "
            "%.2f) on %s" % (workers, ",".join(decoders), rate,
                             time.perf_counter() - t0,
                             st["producer_stall_s"], st["consumer_stall_s"],
                             st["ring_occupancy"], card))
    streams = []
    for workers in (1, 4):
        it = ds_iter(mx, train, seed, dev, preprocess_threads=workers,
                     **DS_AUG)
        streams.append(_ds_batches(it, DS_COMPARE_BATCHES))
        it.close()
    check(streams[0][0][0].is_cuda, "a service batch is not on the card")
    check(_ds_same(torch, *streams), "the 1-worker stream differs from the "
          "4-worker stream on the card")
    log("data service: the first %d batches on gpu(0) at 1 and 4 workers "
        "equal byte for byte" % DS_COMPARE_BATCHES)
    return rates


def phase_ds_augment(torch, mx, train, seed, card):
    """DeviceAugment on the card: the canvas upload against the float32
    batch's, the augment's device time and kernels a batch (traced), the
    card against the port's CPU DeviceAugment on the same canvas bytes and
    chunk seed (exact; the resize branch within DS_RESIZE_REL_TOL x max),
    pad rows, the iterator's first device-augmented batch against the CPU
    augment of the service's canvas, and uploaded batches unchanged after
    three more pulls."""
    from mxnet_tpu_torch.data_service import common as dsc
    dev = mx.gpu(0)
    tdev = dev.torch_device
    aug = mx.kernels.augment.DeviceAugment(IMAGE, margin=DS_MARGIN,
                                           **DS_AUG)
    # the service's own canvas stream, on the host: what device_augment
    # ships (a center crop to the canvas, uint8, no host augmentation)
    it = ds_iter(mx, train, seed, mx.cpu(), data_shape=aug.canvas_shape,
                 dtype="uint8", host_batches=True, preprocess_threads=2)
    canvas = it.next().data[0].clone()
    it.close()
    check(tuple(canvas.shape) == (BATCH,) + aug.canvas_shape
          and canvas.dtype == torch.uint8, "canvas %s %s" % (
              tuple(canvas.shape), canvas.dtype))
    cseed = dsc.chunk_seed(seed, 0, epoch=1)
    # the upload: the uint8 canvas against the float32 batch, pinned, on
    # the side stream
    up = mx.dataflow.Uploader(tdev)
    f32 = (torch.rand((BATCH,) + IMAGE) * 255).pin_memory()
    upload = {}
    for name, host in (("uint8 canvas", canvas.pin_memory()),
                       ("float32 batch", f32)):
        def side(host=host):
            _, event = up.upload([host])
            event.synchronize()
        for _ in range(3):
            side()
        t0 = time.perf_counter()
        for _ in range(IN_UPLOAD_REPS):
            side()
        ms = (time.perf_counter() - t0) * 1e3 / IN_UPLOAD_REPS
        upload[name] = ms
        nbytes = host.numel() * host.element_size()
        log("device augment: upload of the %s %s (%.1f MB), pinned "
            "non_blocking on the side stream: %.3f ms, %.2f GB/s on %s" % (
                name, tuple(host.shape), nbytes / 1e6, ms,
                nbytes / ms / 1e6, card))
    on_card = canvas.to(tdev)
    for nvalid in (BATCH, BATCH - 12):
        got = aug(on_card, cseed, nvalid)
        ref = aug(canvas, cseed, nvalid)
        check(got.is_cuda, "DeviceAugment's output is not on the card")
        check(torch.equal(got.cpu(), ref), "DeviceAugment on the card "
              "differs from the CPU's (nvalid %d)" % nvalid)
        check(not bool(got[nvalid:].any()), "pad rows not zero")
    gen = torch.Generator().manual_seed(seed + 7)
    other = torch.randint(0, 256, (BATCH, 3, 256, 256), generator=gen,
                          dtype=torch.uint8)
    got = aug(other.to(tdev), cseed, BATCH).cpu()
    ref = aug(other, cseed, BATCH)
    rel = _rel_err(got, ref)
    check(rel <= DS_RESIZE_REL_TOL, "DeviceAugment's resize branch: card "
          "off the CPU by %g x max" % rel)
    log("device augment: the card equals the CPU on the same canvas and "
        "chunk seed byte for byte (nvalid %d and %d, pad rows zero); the "
        "resize branch (256x256 -> %dx%d) within %.3g x max (limit %g)"
        % (BATCH, BATCH - 12, aug.canvas_shape[1], aug.canvas_shape[2], rel,
           DS_RESIZE_REL_TOL))
    torch.cuda.synchronize()

    def window(prof):
        prof.start()
        for _ in range(DS_AUG_REPS):
            aug(on_card, cseed, BATCH)
        torch.cuda.synchronize()
        prof.stop()

    _, busy, htod, ops = _traced(torch, window)
    ev = event_ms(torch, lambda: aug(on_card, cseed, BATCH))
    log("device augment: %.3f ms of device time a batch (traced, %d "
        "calls), %.1f device ops a batch (kernels and copies; %.4f ms of "
        "it the draws' host-to-device copy), %.3f ms a call between CUDA "
        "events (host included) on %s" % (
            busy / DS_AUG_REPS, DS_AUG_REPS, ops / DS_AUG_REPS,
            htod / DS_AUG_REPS, ev, card))
    # the iterator's first device-augmented batch is the augment of the
    # service's first canvas at the batch's chunk seed
    it = ds_iter(mx, train, seed, dev, device_augment=DS_MARGIN, **DS_AUG)
    b0 = it.next()
    first = b0.data[0]._data
    check(first.is_cuda, "a device-augmented batch is not on the card")
    check(tuple(first.shape) == (BATCH,) + IMAGE,
          "device-augmented batch %s" % (tuple(first.shape),))
    check(torch.equal(first.cpu(), aug(canvas, cseed, BATCH)),
          "the iterator's device-augmented batch differs from the CPU "
          "augment of its canvas")
    snap = first.clone()
    for _ in range(3):
        it.next()
    torch.cuda.synchronize()
    check(torch.equal(first, snap), "a device-augmented batch changed "
          "after three more pulls")
    it.close()
    it = ds_iter(mx, train, seed, dev, preprocess_threads=2, **DS_AUG)
    first = it.next().data[0]._data
    snap = first.clone()
    for _ in range(3):
        it.next()
    torch.cuda.synchronize()
    check(torch.equal(first, snap), "a host-augmented service batch "
          "changed after three more pulls")
    it.close()
    log("device augment: the iterator's first batch equals the CPU augment "
        "of the service's canvas; device- and host-augmented batches on "
        "gpu(0) unchanged after three more pulls")
    return upload, busy / DS_AUG_REPS, ops / DS_AUG_REPS


def start_data_servers(n, tmp):
    """``n`` network-tier servers (``data_service/server_main.py``) on
    loopback ports: ``(processes, 'host:port,...')``."""
    main = os.path.join(ROOT, "mxnet_tpu_torch", "data_service",
                        "server_main.py")
    procs, files = [], []
    for i in range(n):
        pf = os.path.join(tmp, "server%d.port" % i)
        procs.append(subprocess.Popen(
            [sys.executable, main, "--port", "0", "--port-file", pf],
            stderr=subprocess.DEVNULL))
        files.append(pf)
    deadline = time.monotonic() + 60
    addrs = []
    for p, pf in zip(procs, files):
        while not os.path.exists(pf):
            check(p.poll() is None and time.monotonic() < deadline,
                  "a data server did not come up")
            time.sleep(0.05)
        with open(pf) as f:
            addrs.append(f.read().strip())
    return procs, ",".join(addrs)


def stop_data_servers(procs):
    for p in procs:
        if p.poll() is None:
            p.terminate()
    for p in procs:
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(timeout=10)


def phase_ds_network(torch, mx, train, seed, card, servers):
    """Two loopback servers with 2 workers each and device_augment: their
    stream on the card equals the local service's byte for byte; the
    tier's rate into gpu(0)."""
    dev = mx.gpu(0)
    streams = []
    for ds in (True, servers):
        it = ds_iter(mx, train, seed, dev, data_service=ds,
                     preprocess_threads=DS_SERVER_WORKERS,
                     device_augment=DS_MARGIN, **DS_AUG)
        streams.append(_ds_batches(it, DS_COMPARE_BATCHES))
        it.close()
    check(_ds_same(torch, *streams), "the network tier's device-augmented "
          "stream differs from the local service's")
    it = ds_iter(mx, train, seed, dev, data_service=servers,
                 preprocess_threads=DS_SERVER_WORKERS,
                 device_augment=DS_MARGIN, **DS_AUG)
    rate = _rate(torch, it)
    st = it.stats()
    it.close()
    check(all(s["alive"] for s in st["servers"].values()),
          "a data server connection died: %s" % st)
    log("data service network tier: %d loopback servers x %d workers with "
        "device_augment: the first %d batches on gpu(0) equal the local "
        "service's byte for byte; %.0f img/s into gpu(0) (%d frames, %.1f "
        "MB received) on %s" % (
            DS_SERVERS, DS_SERVER_WORKERS, DS_COMPARE_BATCHES, rate,
            sum(s["frames"] for s in st["servers"].values()),
            sum(s["bytes_rx"] for s in st["servers"].values()) / 1e6, card))
    return rate


def phase_ds_feeds(torch, mx, train, seed, card, servers):
    """Inception-BN trained through Module.fit(kvstore='tpu') at batch 32,
    fed in turn (``DS_FEED_ORDER``): (d) held batches in an NDArrayIter,
    (e) the local service
    host-augmented, (f) the local service with device_augment, (g) (f)
    through DevicePrefetchIter(stage=module), (h) the network tier with
    device_augment.  ms a batch, idle share, bn_act launches a step."""
    import numpy as np
    net, mod = _in_module(torch, mx, seed + 1)
    per = zoo_report(mx, net, (BATCH,) + IMAGE)["bn_act_calls_train"]
    batches = IN_WARM + DS_FIT_BATCHES
    dev = mx.gpu(0)
    src = ds_iter(mx, train, seed, dev, **DS_AUG)
    held = [src.next() for _ in range(batches)]
    src.close()
    X = np.concatenate([b.data[0].asnumpy() for b in held])
    Y = np.concatenate([b.label[0].asnumpy() for b in held])
    del held

    def feed(which):
        """(the iterator fit reads, the iterators to close after)"""
        if which == "d":
            it = mx.io.NDArrayIter(X, Y, batch_size=BATCH)
            return it, [it]
        if which == "e":
            it = ds_iter(mx, train, seed, dev, **DS_AUG)
        elif which == "h":
            it = ds_iter(mx, train, seed, dev, data_service=servers,
                         preprocess_threads=DS_SERVER_WORKERS,
                         device_augment=DS_MARGIN, **DS_AUG)
        else:
            it = ds_iter(mx, train, seed, dev, device_augment=DS_MARGIN,
                         **DS_AUG)
        if which == "g":
            pre = mx.DevicePrefetchIter(it, stage=mod)
            return pre, [pre, it]
        return it, [it]

    names = {"d": "held batches in an NDArrayIter",
             "e": "local service, host-augmented",
             "f": "local service + device_augment",
             "g": "(f) + DevicePrefetchIter(stage=module)",
             "h": "network tier (%d servers) + device_augment" % DS_SERVERS}
    times = collections.defaultdict(list)
    launches = collections.Counter()
    feeds = {which: feed(which) for which in "defgh"}
    try:
        # one untimed fit first, so that no timed turn is the phase's
        # first fit of the module
        _in_fit(torch, mx, mod, feeds["d"][0], batches, DS_FIT_BATCHES)
        for which in DS_FEED_ORDER:
            aug = feeds[which][1][-1]._dev_aug if which != "d" else None
            calls = aug.calls if aug is not None else 0
            ms, (fwd, bwd) = _in_fit(torch, mx, mod, feeds[which][0],
                                     batches, DS_FIT_BATCHES)
            check(fwd == bwd == per * batches, "feed (%s): bn_act launches "
                  "%d / %d over %d batches, plan %d a step" % (
                      which, fwd, bwd, batches, per))
            # feed (g)'s prefetcher runs ahead of its fit: at least
            augmented = aug.calls - calls if aug is not None else 0
            check(which not in "fgh" or augmented >= batches,
                  "feed (%s): %d device augments over %d batches" % (
                      which, augmented, batches))
            launches.update({"bn_act_fwd": fwd, "bn_act_bwd": bwd})
            times[which].append(ms)
        traced = {}
        for which in "defgh":
            traced[which] = _traced(torch, lambda prof: _in_fit(
                torch, mx, mod, feeds[which][0],
                IN_WARM + IN_PROFILE_BATCHES, IN_PROFILE_BATCHES, prof))
        stats = {which: feeds[which][1][-1].stats() for which in "efgh"}
    finally:
        for _, owned in feeds.values():
            for o in owned:
                o.close()
    for which in "defgh":
        (ms, _), busy, htod, kernels = traced[which]
        wall = ms * IN_PROFILE_BATCHES
        log("inception-bn fit, feed (%s) %s: %s ms a batch (%d turn(s) of "
            "%d batches, batch %d); traced window %.2f ms a batch, device "
            "busy %.2f ms, idle share %.3f, host-to-device copies %.3f ms a "
            "batch, %.0f kernels a batch; %d + %d bn_act launches a step; "
            "on %s" % (which, names[which], " / ".join(
                "%.2f" % v for v in times[which]), len(times[which]),
                DS_FIT_BATCHES, BATCH, ms,
                busy / IN_PROFILE_BATCHES, 1 - busy / wall,
                htod / IN_PROFILE_BATCHES, kernels / IN_PROFILE_BATCHES,
                per, per, card))
    for which in "efgh":
        st = stats[which]
        log("inception-bn fit: feed (%s) costs %+.2f ms a batch over (d); "
            "consumer stall %.2f s over its fits%s" % (
                which, np.mean(times[which]) - np.mean(times["d"]),
                st["consumer_stall_s"],
                "; decoders %s" % ",".join(st["decoders"])
                if "decoders" in st else ""))
    out = mod.get_outputs()[0].asnumpy()
    check(np.isfinite(out).all(), "inception-bn fit: outputs not finite")
    del mod
    return launches


def data_service_paths(torch, mx, seed, card):
    """The data service on the card: the decode rate by worker count with
    each worker's decoder, DeviceAugment's checks and times, the network
    tier on loopback, and Inception-BN trained through Module.fit fed five
    ways.  Returns the main path's bn_act launches."""
    lib = mx.native.get_lib()
    expect = "native" if lib._has_imagedec else "python"
    log("data service: the native library %s libjpeg, so the decode "
        "workers take the %s decoder (the JAX package's rule)" % (
            "has" if lib._has_imagedec else "lacks", expect))
    tmp = tempfile.mkdtemp(prefix="dataservice-", dir=os.path.join(
        ROOT, "mxnet_tpu_torch", "_build"))
    procs = []
    try:
        train = os.path.join(tmp, "train")
        write_seeded_rec(mx.recordio, train, IN_IMAGES, IN_SHORT,
                         seed + IN_SEED)
        phase_ds_rates(torch, mx, train, seed, card, expect)
        phase_ds_augment(torch, mx, train, seed, card)
        procs, servers = start_data_servers(DS_SERVERS, tmp)
        phase_ds_network(torch, mx, train, seed, card, servers)
        gc.collect()
        torch.cuda.empty_cache()
        launches = phase_ds_feeds(torch, mx, train, seed, card, servers)
    finally:
        stop_data_servers(procs)
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return launches

# ---------------------------------------------------------------------------
# the detection and sequence examples on the port: example/ssd (SSD-512
# with a ResNet-50 body), example/rcnn and example/warpctc, loaded with
# ``mxnet_tpu`` bound to the port
# ---------------------------------------------------------------------------

_PKG_IMPORT = re.compile(r"^([ \t]*)(import|from)([ \t]+)mxnet_tpu\b", re.M)


def load_example(relpath, name, siblings=None):
    """Execute the example file ``relpath`` (from the repository root) as a
    module named ``name``, with ``mxnet_tpu`` bound to ``mxnet_tpu_torch``:
    every line that imports ``mxnet_tpu`` or a module under it (``import
    mxnet_tpu as mx``, ``from mxnet_tpu.io import DataIter``, an import
    inside a function) is rewritten to import the port's, and the rest of
    the file runs as written.  ``siblings`` maps the names the example
    imports its neighbours by (``import symbol_ssd``) to modules loaded
    this way; they stand in ``sys.modules`` only while the file runs."""
    import types
    path = os.path.join(ROOT, relpath)
    with open(path) as f:
        source = _PKG_IMPORT.sub(r"\1\2\3mxnet_tpu_torch", f.read())
    module = types.ModuleType(name)
    module.__file__ = path
    stand_in = dict(siblings or {})
    stand_in[name] = module
    saved = {k: sys.modules.get(k) for k in stand_in}
    sys.modules.update(stand_in)
    try:
        exec(compile(source, path, "exec"), module.__dict__)
    finally:
        for k, old in saved.items():
            if old is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = old
    return module


def example_modules():
    """The examples' modules on the port: ``symbol_ssd``, ``train_ssd``,
    ``rcnn_target`` (registers its two Custom ops), ``train_rcnn``,
    ``toy_ctc`` and ``lstm_ctx_group`` (whose import-time
    ``logging.basicConfig`` is undone)."""
    ssd = load_example("example/ssd/symbol_ssd.py", "port_symbol_ssd")
    target = load_example("example/rcnn/rcnn_target.py", "port_rcnn_target")
    root = logging.getLogger()
    saved = (root.level, list(root.handlers))
    try:
        ctx_group = load_example("example/model-parallel-lstm/"
                                 "lstm_ctx_group.py", "port_lstm_ctx_group")
    finally:
        root.setLevel(saved[0])
        root.handlers[:] = saved[1]
    return {
        "lstm_ctx_group": ctx_group,
        "symbol_ssd": ssd,
        "train_ssd": load_example("example/ssd/train_ssd.py",
                                  "port_train_ssd", {"symbol_ssd": ssd}),
        "rcnn_target": target,
        "train_rcnn": load_example("example/rcnn/train_rcnn.py",
                                   "port_train_rcnn",
                                   {"rcnn_target": target}),
        "toy_ctc": load_example("example/warpctc/toy_ctc.py",
                                "port_toy_ctc"),
    }


#: SSD-512 with a ResNet-50 body: the "resnet50" entry of the reference's
#: example/ssd/symbol/symbol_factory.py at data shape 512 (VOC's 20
#: classes): the zoo's ResNet-50 v2 cut at the ends of stages 3 and 4
#: (the reference's _plus12 and _plus15), four extra layers, six maps
SSD_IMAGE = (3, 512, 512)
SSD_CLASSES = 20
SSD_BATCH = 32
SSD_FROM = ("elemwise_add12_output", "elemwise_add15_output")
SSD_EXTRA_FILTERS = (512, 256, 256, 128)
SSD_SIZES = ((.1, .141), (.2, .272), (.37, .447), (.54, .619), (.71, .79),
             (.88, .961))
_SSD_R3, _SSD_R5 = (1.0, 2.0, .5), (1.0, 2.0, .5, 3.0, 1.0 / 3)
SSD_RATIOS = (_SSD_R3, _SSD_R5, _SSD_R5, _SSD_R5, _SSD_R3, _SSD_R3)
SSD_ANCHORS = 6132
SSD_OBJECTS = 16        # label rows a picture, padded with rows of -1
SSD_WARM, SSD_TIMED = 2, 3
SSD_PROFILE_BATCHES = 3
SSD_SGD = {"learning_rate": 0.004, "momentum": 0.9, "wd": 5e-4}
#: get_symbol_detect on the trained weights: the example's 0.2 threshold
#: would leave untrained scores near 1/21 nothing to suppress
SSD_DETECT = dict(threshold=0.01, nms_thresh=0.45, nms_topk=400)
SSD_DETECT_FORWARDS = 2
SSD_AGREE_BATCH = 2
#: MultiBox ops card against CPU on the same inputs: loc_target within
#: 1e-6 absolute (the log of each device's math library); decoded box
#: corners within 2 ulp of 1.0 (each device's exp)
MBT_LOC_ATOL = 1e-6
BOX_ATOL = 2.4e-7
#: Faster R-CNN's published test-time proposal layer: VGG-16 conv5_3 of a
#: 600 x 1000 image (stride 16: 38 x 63), 9 anchors, 6000 / 300
RCNN_PROPOSAL = dict(shape=(1, 18, 38, 63), im_info=(600.0, 1000.0, 1.6),
                     attrs=dict(rpn_pre_nms_top_n=6000,
                                rpn_post_nms_top_n=300, threshold=0.7,
                                rpn_min_size=16, scales=(8, 16, 32),
                                ratios=(0.5, 1, 2), feature_stride=16,
                                output_score=True))
RCNN_BATCHES = 8        # one epoch of the example's ToyDetIter (64 / 8)
CTC_BATCHES = 8         # one epoch of toy_ctc.train at its defaults
#: ROIPooling at Faster R-CNN's VGG-16 conv5_3 shape, 128 ROIs, 7 x 7;
#: Correlation at FlowNetC's layer (kernel 1, displacement 20, strides 1
#: and 2, pad 20); the forward+backward peak above resident of each
ROI_PUBLISHED = ((1, 512, 38, 63), 128, (7, 7), 1.0 / 16)
CORR_PUBLISHED = ((8, 256, 48, 64), dict(kernel_size=1, max_displacement=20,
                                         stride1=1, stride2=2, pad_size=20))
PEAK_TARGET_GIB = 2.0


def ssd512_symbols(mx, ssd):
    """SSD-512 ResNet-50 (train, detect) through the example's own
    ``get_symbol_train`` / ``get_symbol_detect``, with its
    ``multi_layer_feature`` replaced by the zoo's ResNet-50 (built under a
    fresh NameManager, cut at SSD_FROM) and the reference's extra layers
    (``symbol_builder.multi_layer_feature``: a 1x1 conv of max(128, f/2)
    filters, then a stride-2 3x3 conv of f, each with a relu)."""
    def multi_layer_feature(data):
        with mx.name.NameManager():
            body = mx.models.get_symbol("resnet-50", num_classes=1000,
                                        image_shape=SSD_IMAGE)
        internals = body.get_internals()
        layers = [internals[name] for name in SSD_FROM]
        for k, f in enumerate(SSD_EXTRA_FILTERS):
            c1 = ssd.conv_act(layers[-1], "multi_feat_%d_conv_1x1" % (k + 2),
                              max(128, f // 2), kernel=(1, 1), pad=(0, 0))
            layers.append(ssd.conv_act(
                c1, "multi_feat_%d_conv_3x3" % (k + 2), f, kernel=(3, 3),
                pad=(1, 1), stride=(2, 2)))
        return layers

    example_features = ssd.multi_layer_feature
    ssd.multi_layer_feature = multi_layer_feature
    try:
        with mx.name.NameManager():
            train = ssd.get_symbol_train(num_classes=SSD_CLASSES,
                                         sizes=SSD_SIZES, ratios=SSD_RATIOS)
        with mx.name.NameManager():
            detect = ssd.get_symbol_detect(
                num_classes=SSD_CLASSES, sizes=SSD_SIZES, ratios=SSD_RATIOS,
                **SSD_DETECT)
    finally:
        ssd.multi_layer_feature = example_features
    return train, detect


def ssd_data(seed, n, size=SSD_IMAGE[1], classes=SSD_CLASSES,
             objects=SSD_OBJECTS):
    """``n`` seeded pictures of noise with 1-8 colored rectangles each
    (one color a class) and their labels (n, objects, 5): rows (class, x1,
    y1, x2, y2) in [0, 1], padded with rows of -1."""
    import numpy as np
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 3, size, size), dtype=np.float32)
    x *= 0.3
    colors = rng.uniform(-1.5, 1.5, (classes, 3)).astype(np.float32)
    lab = -np.ones((n, objects, 5), np.float32)
    for i in range(n):
        for k in range(rng.integers(1, 9)):
            cls = int(rng.integers(0, classes))
            x0, y0 = rng.uniform(0.0, 0.75, 2)
            w, h = rng.uniform(0.08, 0.45, 2)
            x1, y1 = min(1.0, x0 + w), min(1.0, y0 + h)
            px = [int(round(v * size)) for v in (x0, y0, x1, y1)]
            x[i, :, px[1]:px[3], px[0]:px[2]] = colors[cls][:, None, None]
            lab[i, k] = (cls, x0, y0, x1, y1)
    return x, lab


def _host_device_ms(torch, fn, iters=5):
    """(host ms, device ms) of one ``fn()`` call: the host clock around
    calls that end in no sync, after a synced warm-up; the device time a
    trace of the same calls records (``traced_device_ms``)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return host, traced_device_ms(torch, fn, iters=iters)


def phase_ssd_fit(torch, mx, ex, seed, card):
    """SSD-512 ResNet-50 trained through the example's Module.fit wiring
    (kvstore=None, sgd, the example's Xavier init and MultiBoxMetric) at
    batch 32 on gpu(0): SSD_WARM untimed then SSD_TIMED timed batches, then
    a profiled window.  Returns (module, data, labels, detect symbol,
    bn_act launches (fwd, bwd))."""
    import numpy as np
    ba = mx.kernels.bn_act
    train, detect = ssd512_symbols(mx, ex["symbol_ssd"])
    shape = (SSD_BATCH,) + SSD_IMAGE
    label_shape = (SSD_BATCH, SSD_OBJECTS, 5)
    internals = train.get_internals()
    _, outs, _ = internals.infer_shape(data=shape, label=label_shape)
    anchors = dict(zip(internals.list_outputs(), outs))[
        "multibox_anchors_output"]
    check(anchors == (1, SSD_ANCHORS, 4), "ssd-512: %s anchors, not %d" % (
        anchors, SSD_ANCHORS))
    report = zoo_report(mx, train, shape, label=label_shape)
    per_step = report["bn_act_calls_train"]
    per_forward = report["bn_act_calls_infer"]
    batches = SSD_WARM + SSD_TIMED
    X, Y = ssd_data(seed + 140, batches * SSD_BATCH)
    it = mx.io.NDArrayIter(X, Y, batch_size=SSD_BATCH, label_name="label")
    mod = mx.mod.Module(train, data_names=("data",), label_names=("label",),
                        context=mx.gpu(0))
    metric = ex["train_ssd"].MultiBoxMetric()
    stamps = {}

    def on_batch(param):
        if param.nbatch in (SSD_WARM - 1, SSD_WARM - 1 + SSD_TIMED):
            torch.cuda.synchronize()
            stamps[param.nbatch] = time.perf_counter()

    mx.random.seed(seed)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    # -- the main path: counts zeroed just before, read just after ---------
    ba.LAUNCHES = 0
    ba.BWD_LAUNCHES = 0
    mod.fit(it, eval_metric=metric, num_epoch=1, optimizer="sgd",
            optimizer_params=dict(SSD_SGD),
            initializer=mx.initializer.Xavier(rnd_type="gaussian",
                                              factor_type="in", magnitude=2),
            batch_end_callback=on_batch, kvstore=None)
    torch.cuda.synchronize()
    launched = (ba.LAUNCHES, ba.BWD_LAUNCHES)
    # ----------------------------------------------------------------------
    peak = torch.cuda.max_memory_allocated()
    ms = (stamps[SSD_WARM - 1 + SSD_TIMED] - stamps[SSD_WARM - 1]) * 1e3 \
        / SSD_TIMED
    names, values = metric.get()
    check(np.isfinite(values).all(), "ssd-512 fit: metric %s" % (values,))
    check(launched == (per_step * batches, per_step * batches),
          "ssd-512 fit launched %s bn_act kernels over %d batches, the plan "
          "%d + %d a step" % (launched, batches, per_step, per_step))
    log("ssd-512 resnet-50 fit (Module.fit, kvstore=None, sgd lr %g, batch "
        "%d, 3x512x512, %d anchors, %d classes): %.2f ms a batch, %.1f "
        "img/s over %d batches after %d; peak memory %.2f GiB (%.2f above "
        "the %.2f GiB resident before); %d + %d bn_act launches a step; "
        "%s %s; on %s" % (
            SSD_SGD["learning_rate"], SSD_BATCH, SSD_ANCHORS, SSD_CLASSES, ms,
            SSD_BATCH * 1e3 / ms, SSD_TIMED, SSD_WARM, peak / 2 ** 30,
            (peak - resident) / 2 ** 30, resident / 2 ** 30, per_step,
            per_step, names, ["%.4f" % v for v in values], card))
    # a profiled window: one more epoch over the first batches
    prof_it = mx.io.NDArrayIter(X[:(1 + SSD_PROFILE_BATCHES) * SSD_BATCH],
                                Y[:(1 + SSD_PROFILE_BATCHES) * SSD_BATCH],
                                batch_size=SSD_BATCH, label_name="label")

    def run(prof):
        t = {}

        def stamp(param):
            if param.nbatch in (0, SSD_PROFILE_BATCHES):
                torch.cuda.synchronize()
                t[param.nbatch] = time.perf_counter()
                (prof.start if param.nbatch == 0 else prof.stop)()
        mod.fit(prof_it, eval_metric=metric, num_epoch=1,
                batch_end_callback=stamp, kvstore=None)
        return (t[SSD_PROFILE_BATCHES] - t[0]) * 1e3

    wall, busy, htod, kernels = _traced(torch, run)
    log("ssd-512 fit profile: %d batches, wall %.2f ms a batch, device busy "
        "%.2f ms, idle share %.3f, host-to-device copies %.3f ms a batch, "
        "%.0f kernels a batch; on %s" % (
            SSD_PROFILE_BATCHES, wall / SSD_PROFILE_BATCHES,
            busy / SSD_PROFILE_BATCHES, 1 - busy / wall,
            htod / SSD_PROFILE_BATCHES, kernels / SSD_PROFILE_BATCHES, card))
    return mod, X, Y, detect, launched, per_forward


def phase_ssd_target_ms(torch, mx, Y, card):
    """MultiBoxTarget at the fit's shapes on the card: host and device
    ms of one call (the example's attributes, mining on)."""
    import numpy as np
    contrib = mx.ops.contrib
    dev = mx.gpu(0).torch_device
    parts = [contrib.multibox_prior(torch.zeros(1, 1, s, s, device=dev),
                                    sizes=SSD_SIZES[k], ratios=SSD_RATIOS[k])
             for k, s in enumerate((32, 16, 8, 4, 2, 1))]
    anchors = torch.cat(parts, dim=1)
    check(anchors.shape == (1, SSD_ANCHORS, 4), "ssd anchors %s" % (
        tuple(anchors.shape),))
    rs = np.random.RandomState(7)
    pred = torch.from_numpy(rs.standard_normal(
        (SSD_BATCH, SSD_CLASSES + 1, SSD_ANCHORS)).astype(np.float32)).to(dev)
    label = torch.from_numpy(Y[:SSD_BATCH]).to(dev)
    kw = dict(overlap_threshold=0.5, ignore_label=-1,
              negative_mining_ratio=3.0, minimum_negative_samples=0,
              negative_mining_thresh=0.5, variances=(0.1, 0.1, 0.2, 0.2))
    host, device = _host_device_ms(torch, lambda: contrib.multibox_target(
        anchors, label, pred, **kw))
    log("ssd-512 MultiBoxTarget at batch %d, %d anchors, %d label rows (the "
        "fit's shapes; %d greedy matching rounds batched over the samples): "
        "host %.3f ms, device %.3f ms a call; on %s" % (
            SSD_BATCH, SSD_ANCHORS, SSD_OBJECTS, SSD_OBJECTS, host, device,
            card))
    return anchors, pred, label, kw


def phase_ssd_detect(torch, mx, mod, detect, X, per_forward, card):
    """The example's deployment graph on the trained weights at batch 32:
    ms a forward, bn_act launches and kernels a forward, the NMS sweep's
    host and device ms, boxes kept before and after NMS in the first
    pictures (NMS must suppress some in each).  Returns (bn_act launches,
    the MultiBoxDetection inputs)."""
    import numpy as np
    ba = mx.kernels.bn_act
    contrib = mx.ops.contrib
    internals = detect.get_internals()
    names = internals.list_outputs()
    prob_name = next(n for n in names if n.startswith("softmaxactivation"))
    group = mx.sym.Group([detect, internals[prob_name],
                          internals["multibox_loc_pred_output"],
                          internals["multibox_anchors_output"]])
    det = mx.mod.Module(group, data_names=("data",), label_names=None,
                        context=mx.gpu(0))
    det.bind(data_shapes=[("data", (SSD_BATCH,) + SSD_IMAGE)],
             for_training=False)
    arg_params, aux_params = mod.get_params()
    det.set_params(arg_params, aux_params, allow_missing=False)
    batch = mx.io.DataBatch(data=[mx.nd.array(X[:SSD_BATCH],
                                              ctx=mx.gpu(0))])
    det.forward(batch, is_train=False)
    torch.cuda.synchronize()
    # -- the main path: counts zeroed just before, read just after ---------
    ba.LAUNCHES = 0
    t0 = time.perf_counter()
    for _ in range(SSD_DETECT_FORWARDS):
        det.forward(batch, is_train=False)
        rows = det.get_outputs()[0].asnumpy()
    ms = (time.perf_counter() - t0) * 1e3 / SSD_DETECT_FORWARDS
    launched = ba.LAUNCHES
    # ----------------------------------------------------------------------
    check(launched == per_forward * SSD_DETECT_FORWARDS, "ssd-512 detect "
          "launched %d bn_act kernels over %d forwards, the plan %d a "
          "forward" % (launched, SSD_DETECT_FORWARDS, per_forward))
    outs = [o._data for o in det.get_outputs()]
    prob, loc, anchors = outs[1], outs[2], outs[3]
    check(rows.shape == (SSD_BATCH, SSD_ANCHORS, 6) and np.isfinite(
        rows).all(), "ssd-512 detect rows %s" % (rows.shape,))
    fg = prob[:, 1:].amax(1)
    before = (fg > SSD_DETECT["threshold"]).sum(1).cpu().numpy()
    after = (rows[..., 0] >= 0).sum(1)
    check((after < before).all() and (after > 0).all(),
          "ssd-512 detect: NMS kept %s of %s candidates" % (
              after.tolist(), before.tolist()))
    kept = rows[0][rows[0][:, 0] >= 0]
    check((kept[:, 1] > SSD_DETECT["threshold"]).all()
          and (np.diff(kept[:, 1]) <= 0).all()
          and ((kept[:, 2:] >= 0) & (kept[:, 2:] <= 1)).all(),
          "ssd-512 detect: kept rows not sorted scores over the threshold "
          "with clipped boxes")
    _, busy, _, kernels = _traced(torch, lambda prof: (
        prof.start(), det.forward(batch, is_train=False),
        det.get_outputs()[0].asnumpy(), prof.stop()))
    # the sweep alone, on this forward's rows
    boxes, score, cls_id, valid, sel = contrib._mbd_candidates(
        prob, loc, anchors, True, SSD_DETECT["threshold"], 0,
        (0.1, 0.1, 0.2, 0.2), False)
    _, sboxes, keep0 = contrib._score_rows(boxes, score, sel)
    topk = SSD_DETECT["nms_topk"]
    steps = min(topk, SSD_ANCHORS - 1)
    sweep_host, sweep_dev = _host_device_ms(
        torch, lambda: contrib._nms_sweep(sboxes, keep0,
                                          SSD_DETECT["nms_thresh"], topk),
        iters=2)
    op_host, op_dev = _host_device_ms(torch, lambda: contrib.multibox_detection(
        prob, loc, anchors, threshold=SSD_DETECT["threshold"],
        nms_threshold=SSD_DETECT["nms_thresh"], nms_topk=topk), iters=2)
    log("ssd-512 detect (get_symbol_detect, threshold %g, nms %g, topk %d) "
        "at batch %d: %.2f ms a forward; %d bn_act launches and %.0f kernels "
        "a forward (device busy %.2f ms of a traced forward); the NMS sweep "
        "runs %d steps over %d (picture, class) rows of %d: host %.2f ms, "
        "device %.2f ms; MultiBoxDetection whole: host %.2f ms, device %.2f "
        "ms; on %s" % (
            SSD_DETECT["threshold"], SSD_DETECT["nms_thresh"], topk,
            SSD_BATCH, ms, per_forward, kernels, busy, steps,
            SSD_BATCH * SSD_CLASSES, SSD_ANCHORS, sweep_host, sweep_dev,
            op_host, op_dev, card))
    log("ssd-512 detect: boxes over the threshold before NMS / kept after, "
        "first 8 pictures: %s" % ", ".join(
            "%d/%d" % (b, a) for b, a in zip(before[:8], after[:8])))
    del det
    return launched, (prob, loc, anchors)


def _same_rows(np, got, ref, what, atol):
    """Detection rows on two devices: ids and scores equal, box corners
    within ``atol``; returns the largest corner difference."""
    check(got.shape == ref.shape, "%s: shapes %s / %s" % (
        what, got.shape, ref.shape))
    check(np.array_equal(got[..., :2], ref[..., :2]),
          "%s: class ids or scores differ (%d entries)" % (
              what, int((got[..., :2] != ref[..., :2]).sum())))
    diff = float(np.abs(got[..., 2:] - ref[..., 2:]).max()) if got.size \
        else 0.0
    check(diff <= atol, "%s: corners differ by %.3g (bound %.3g)" % (
        what, diff, atol))
    return diff


def phase_multibox_agreement(torch, mx, target_in, detect_in, seed):
    """MultiBoxTarget, MultiBoxDetection and Proposal on the card against
    the port's CPU path on the same inputs (the main path's shapes):
    equal targets, masks and rows, box coordinates within rounding."""
    import numpy as np
    contrib = mx.ops.contrib
    anchors, pred, label, kw = target_in
    got = [t.cpu().numpy() for t in contrib.multibox_target(
        anchors, label, pred, **kw)]
    ref = [t.numpy() for t in contrib.multibox_target(
        anchors.cpu(), label.cpu(), pred.cpu(), **kw)]
    loc_diff = float(np.abs(got[0] - ref[0]).max())
    check(np.array_equal(got[2], ref[2]) and np.array_equal(got[1], ref[1])
          and loc_diff <= MBT_LOC_ATOL, "MultiBoxTarget card vs CPU: "
          "cls_target %d, loc_mask %d entries differ, loc_target by %.3g" % (
              int((got[2] != ref[2]).sum()), int((got[1] != ref[1]).sum()),
              loc_diff))
    log("MultiBoxTarget card vs CPU at batch %d x %d anchors (mining on): "
        "cls_target and loc_mask equal (%d positives, %d mined negatives, "
        "%d ignored), loc_target within %.3g (bound %g)" % (
            SSD_BATCH, SSD_ANCHORS, int((ref[2] > 0).sum()),
            int((ref[2] == 0).sum()), int((ref[2] == -1).sum()), loc_diff,
            MBT_LOC_ATOL))
    prob, loc, anc = detect_in
    for force in (False, True):
        attrs = dict(threshold=SSD_DETECT["threshold"],
                     nms_threshold=SSD_DETECT["nms_thresh"],
                     nms_topk=SSD_DETECT["nms_topk"], force_suppress=force)
        got = contrib.multibox_detection(prob, loc, anc, **attrs)
        ref = contrib.multibox_detection(prob.cpu(), loc.cpu(), anc.cpu(),
                                         **attrs)
        diff = _same_rows(np, got.cpu().numpy(), ref.numpy(),
                          "MultiBoxDetection card vs CPU", BOX_ATOL)
        log("MultiBoxDetection card vs CPU at batch %d (the detect "
            "forward's inputs, force_suppress %s): ids and scores equal, %d "
            "rows kept, corners within %.3g (bound %.3g)" % (
                SSD_BATCH, force, int((ref[..., 0] >= 0).sum()), diff,
                BOX_ATOL))
    rs = np.random.RandomState(seed + 150)
    shape = RCNN_PROPOSAL["shape"]
    a0 = shape[1] // 2
    for n, what in ((1, "published"), (8, "batch 8")):
        s = (n,) + shape[1:]
        p = rs.uniform(0, 1, s).astype(np.float32)
        p[:, a0:] = 1 - p[:, :a0]               # fg = 1 - bg, as a softmax
        d = (0.2 * rs.standard_normal((n, 4 * a0) + s[2:])).astype(
            np.float32)
        info = np.tile(np.asarray(RCNN_PROPOSAL["im_info"], np.float32),
                       (n, 1))
        args = [torch.from_numpy(v) for v in (p, d, info)]
        got = contrib.proposal(*[a.to(anc.device) for a in args],
                               **RCNN_PROPOSAL["attrs"])
        ref = contrib.proposal(*args, **RCNN_PROPOSAL["attrs"])
        g_rois, r_rois = got[0].cpu().numpy(), ref[0].numpy()
        atol = 4 * np.spacing(np.float32(RCNN_PROPOSAL["im_info"][1]))
        diff = float(np.abs(g_rois[:, 1:] - r_rois[:, 1:]).max())
        check(np.array_equal(g_rois[:, 0], r_rois[:, 0])
              and np.array_equal(got[1].cpu().numpy(), ref[1].numpy())
              and diff <= atol, "Proposal card vs CPU (%s): scores or "
              "indices differ, or boxes by %.3g" % (what, diff))
        log("Proposal card vs CPU (%s: %s, pre %d, post %d, output_score): "
            "scores and batch indices equal, %d rois above zero score, "
            "corners within %.3g px (bound %.3g)" % (
                what, s, RCNN_PROPOSAL["attrs"]["rpn_pre_nms_top_n"],
                RCNN_PROPOSAL["attrs"]["rpn_post_nms_top_n"],
                int((ref[1].numpy() > 0).sum()), diff, atol))


def _ssd_step(mx, symbol, params, x, lab, ctx):
    """One SSD training forward/backward in x's dtype: the three outputs
    and every parameter gradient as float64 numpy (float64 binds arrays
    of that dtype; simple_bind allocates float32)."""
    import numpy as np
    args, aux = params
    names = symbol.list_arguments()
    arg_shapes, _, _ = symbol.infer_shape(data=x.shape, label=lab.shape)

    def arr(v):
        return mx.nd.array(v, ctx=ctx, dtype=x.dtype)
    values = {n: arr(args[n] if n in args else np.zeros(s))
              for n, s in zip(names, arg_shapes)}
    values["data"], values["label"] = arr(x), arr(lab)
    grads = {n: arr(np.zeros(s)) for n, s in zip(names, arg_shapes)
             if n in args}
    ex = symbol.bind(ctx, values, args_grad=grads,
                     grad_req={n: "write" if n in args else "null"
                               for n in names},
                     aux_states={n: arr(v) for n, v in aux.items()})
    outs = ex.forward(is_train=True)
    ex.backward()
    out = {"output:" + k: o.asnumpy() for k, o in zip(
        ("cls_prob", "loc_loss", "cls_label"), outs)}
    out.update({"grad:" + k: g.asnumpy() for k, g in ex.grad_dict.items()
                if k in args})
    return {k: v.astype(np.float64) for k, v in out.items()}


def phase_ssd_agreement(torch, mx, mod, X, Y, card):
    """A batch-2 SSD-512 training forward/backward on the card against the
    port's CPU path from the fit's weights: cls_prob and loc_loss within
    AGREE_REL_TOL x their max, the gradients in relative L2 against a
    float64 CPU run; the mined cls_target entries that differ are counted
    (a negative whose score ties within rounding may flip)."""
    import numpy as np
    args, aux = mod.get_params()
    params = ({k: v.asnumpy() for k, v in args.items()},
              {k: v.asnumpy() for k, v in aux.items()})
    symbol = mod.symbol
    x, lab = X[:SSD_AGREE_BATCH], Y[:SSD_AGREE_BATCH]
    t0 = time.perf_counter()
    ref = _ssd_step(mx, symbol, params, x, lab, mx.cpu())
    exact = _ssd_step(mx, symbol, params, x.astype(np.float64),
                      lab.astype(np.float64), mx.cpu())
    got = _ssd_step(mx, symbol, params, x, lab, mx.gpu(0))
    grads = [k for k in ref if k.startswith("grad:")]
    cpu_l2 = _rel_l2(np, ref, exact, grads)
    flips = int((got["output:cls_label"] != ref["output:cls_label"]).sum())
    flips64 = int((ref["output:cls_label"]
                   != exact["output:cls_label"]).sum())
    log("ssd-512 agreement at batch %d (CPU float32 and float64 took %.1f "
        "s): cls_target entries that differ card vs CPU float32: %d of %d "
        "(CPU float32 vs float64: %d); CPU float32 gradients' relative L2 "
        "against float64 %.3g" % (
            SSD_AGREE_BATCH, time.perf_counter() - t0, flips,
            ref["output:cls_label"].size, flips64, cpu_l2))
    for k in ("output:cls_prob", "output:loc_loss"):
        top = float(np.abs(ref[k]).max())
        diff = float(np.abs(got[k] - ref[k]).max())
        log("ssd-512 agreement: %s max |card - cpu| %.3g, %.3g of its max "
            "(bound %g)" % (k[7:], diff, diff / top, AGREE_REL_TOL))
        check(diff <= AGREE_REL_TOL * top, "ssd-512: %s disagrees with the "
              "CPU path" % k[7:])
    g_l2 = _rel_l2(np, got, exact, grads)
    bound = max(AGREE_REL_TOL, GRAD_L2_FACTOR * cpu_l2)
    t_l2, t_key = max((_rel_l2(np, got, exact, [k]), k) for k in grads)
    log("ssd-512 agreement: %d gradients, relative L2 against float64 %.3g "
        "(bound %.3g), worst tensor %s %.3g (bound %g); on %s" % (
            len(grads), g_l2, bound, t_key, t_l2, GRAD_TENSOR_L2_TOL, card))
    check(g_l2 <= bound and t_l2 <= GRAD_TENSOR_L2_TOL,
          "ssd-512: gradients disagree with the float64 CPU run")


def phase_rcnn_fit(torch, mx, ex, seed, card):
    """example/rcnn at its own size (64x64, batch 8, 3 foreground
    classes): one epoch of Module.fit on gpu(0) through its anchor_target
    and proposal_target Custom ops, Proposal and ROIPooling.  ms a batch,
    the Custom ops' host round trips a batch."""
    import numpy as np
    train = ex["train_rcnn"]
    op = mx.operator
    it = train.ToyDetIter(n=RCNN_BATCHES * 8, batch_size=8)
    with mx.name.NameManager():
        net = train.get_symbol_train()
    mod = mx.mod.Module(net, data_names=("data", "im_info", "gt_boxes"),
                        label_names=None, context=mx.gpu(0))
    metric = train.RcnnMetric()
    stamps = {}

    def on_batch(param):
        if param.nbatch in (1, RCNN_BATCHES - 1):
            torch.cuda.synchronize()
            stamps[param.nbatch] = time.perf_counter()
            if param.nbatch == 1:
                for k in op.HOST_COUNTS:
                    op.HOST_COUNTS[k] = 0

    mx.random.seed(seed)
    with mx.gpu(0):     # the iterator's mx.nd.array batches land there
        mod.fit(it, num_epoch=1, eval_metric=metric, optimizer="sgd",
                optimizer_params={"learning_rate": 0.002, "momentum": 0.9,
                                  "wd": 5e-4},
                initializer=mx.initializer.Xavier(
                    rnd_type="gaussian", factor_type="in", magnitude=2),
                batch_end_callback=on_batch, kvstore=None)
    counts = dict(op.HOST_COUNTS)
    timed = RCNN_BATCHES - 2
    ms = (stamps[RCNN_BATCHES - 1] - stamps[1]) * 1e3 / timed
    vals = dict(metric.get_name_value())
    check(all(np.isfinite(v) for v in vals.values()),
          "faster r-cnn fit: metric %s" % vals)
    # both Custom ops run forward on the host each batch; only
    # anchor_target's input (rpn_cls_score) takes a gradient, so only its
    # backward runs (proposal_target's rois come from Proposal, detached)
    check(counts["forward"] == 2 * timed and counts["backward"] == timed,
          "faster r-cnn: %s Custom host calls over %d batches, not 2 "
          "forward and 1 backward a batch" % (counts, timed))
    log("faster r-cnn fit (example/rcnn, 64x64, batch 8, Proposal pre 256 / "
        "post 64, ROIPooling 4x4): %.2f ms a batch over %d batches; Custom "
        "ops %d forward and %d backward host calls a batch, %.0f bytes to "
        "the host and %.0f back a batch; %s; on %s" % (
            ms, timed, counts["forward"] // timed, counts["backward"] // timed,
            counts["bytes_to_host"] / timed, counts["bytes_to_device"] / timed,
            ", ".join("%s %.4f" % kv for kv in sorted(vals.items())), card))


def phase_warpctc(torch, mx, ex, seed, card):
    """example/warpctc/toy_ctc.train at its defaults (the LSTM net through
    FusedRNNCell, hidden 100, T 80, batch 32, adam) for one epoch of
    CTC_BATCHES batches on gpu(0): ms a batch, lstm_seq launches a batch,
    the WarpCTC backward's host and device ms.  Returns the lstm_seq
    launches (fwd, bwd)."""
    import numpy as np
    toy = ex["toy_ctc"]
    lc = mx.kernels.lstm_cell
    ctc = mx.ops.ctc
    stamps = []
    example_batch = toy.gen_batch

    def stamped(batch_size, rng):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        return example_batch(batch_size, rng)

    toy.gen_batch = stamped
    try:
        # -- the main path: counts zeroed just before, read just after -----
        zero_lstm_counts(lc)
        acc = toy.train(epochs=1, batches_per_epoch=CTC_BATCHES, seed=seed,
                        ctx=mx.gpu(0), log=lambda *a: None)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        counts = lstm_counts(lc)
        # ------------------------------------------------------------------
    finally:
        toy.gen_batch = example_batch
    check(len(acc) == 1 and np.isfinite(acc[0]), "toy ctc: accuracy %s"
          % (acc,))
    check(counts["seq"] == (CTC_BATCHES, CTC_BATCHES)
          and counts["cell"] == (0, 0), "toy ctc: lstm launches %s over %d "
          "batches, not 1 + 1 persistent a batch" % (counts, CTC_BATCHES))
    ms = (stamps[-1] - stamps[1]) * 1e3 / (CTC_BATCHES - 1)
    rs = np.random.RandomState(seed + 160)
    T, N, A = toy.SEQ_LEN, 32, toy.ALPHABET
    dev = mx.gpu(0).torch_device
    data = torch.from_numpy(rs.standard_normal((T * N, A)).astype(
        np.float32)).to(dev).requires_grad_()
    label = torch.from_numpy(rs.randint(1, A, (N, toy.NUM_LABEL)).astype(
        np.float32)).to(dev)

    def backward():
        out = ctc.warpctc(data, label, label_length=toy.NUM_LABEL,
                          input_length=T)
        return torch.autograd.grad(out, data, torch.ones_like(out))

    host, device = _host_device_ms(torch, backward)
    log("toy ctc (toy_ctc.train: LSTM hidden 100, T %d, batch 32, adam): "
        "%.2f ms a batch over %d batches after the first; %d + %d lstm_seq "
        "launches a batch; sequence accuracy %.3f after the epoch; WarpCTC "
        "forward + backward (%d alpha steps under autograd): host %.2f ms, "
        "device %.2f ms; on %s" % (
            T, ms, CTC_BATCHES - 1, counts["seq"][0] // CTC_BATCHES,
            counts["seq"][1] // CTC_BATCHES, acc[0], T - 1, host, device,
            card))
    return counts["seq"]


def _sweep_case(torch, card_dev, what, fn, inputs, diff, seed, exact=(),
                atol=None, rtol=0.0):
    """One op on the card and on the CPU on the same inputs: forward (each
    output within ``atol`` + ``rtol`` x its max, or equal where ``exact``
    names it) and, for the inputs at ``diff``, the gradients of output 0
    for one seeded cotangent (within ``atol`` + ``rtol`` x their max).
    Returns the worst relative difference."""
    import numpy as np
    res = {}
    for dev in (card_dev, torch.device("cpu")):
        args = [t.to(dev).clone() for t in inputs]
        for i in diff:
            args[i].requires_grad_(True)
        out = fn(*args)
        outs = list(out) if isinstance(out, (list, tuple)) else [out]
        grads = []
        if diff:
            cot = torch.from_numpy(np.random.RandomState(seed).standard_normal(
                tuple(outs[0].shape)).astype(np.float32)).to(dev)
            grads = list(torch.autograd.grad(outs[0], [args[i] for i in diff],
                                             cot))
        res[dev.type] = [t.detach().cpu().double().numpy()
                         for t in outs + grads]
    worst = 0.0
    for k, (g, r) in enumerate(zip(res[card_dev.type], res["cpu"])):
        top = float(np.abs(r).max()) if r.size else 0.0
        d = float(np.abs(g - r).max()) if r.size else 0.0
        if k in exact:
            check(d == 0, "op sweep %s: result %d differs by %.3g card vs "
                  "CPU" % (what, k, d))
            continue
        check(d <= atol + rtol * top, "op sweep %s: result %d differs by "
              "%.3g (bound %.3g + %.3g x %.3g)" % (what, k, d, atol, rtol,
                                                    top))
        worst = max(worst, d / top if top else d)
    return worst


def phase_op_sweep(torch, mx, seed, card):
    """The 14 ops of ops/contrib.py (MultiBox*, Proposal, fft, ifft,
    count_sketch), ops/vision.py and ops/ctc.py forward, and backward
    where they have a gradient, on the card against the CPU path; then
    ROIPooling and Correlation at their published shapes: forward +
    backward peak memory above resident."""
    import numpy as np
    ops = mx.ops
    c, v, ctc = ops.contrib, ops.vision, ops.ctc
    rs = np.random.RandomState(seed + 170)
    dev = mx.gpu(0).torch_device

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32))

    anchors = c.multibox_prior(torch.zeros(1, 1, 8, 8), sizes=(0.2, 0.4),
                               ratios=(1, 2, 0.5))
    a = anchors.shape[1]
    _, lab = ssd_data(seed + 171, 4, size=8, classes=3, objects=6)
    prob = torch.softmax(t(2 * rs.standard_normal((4, 4, a))), 1)
    feat = np.maximum(rs.standard_normal((2, 8, 20, 24)), 0)
    rois = np.array([[0, 0, 0, 79, 95], [1, 8, 8, 40, 60], [0, 30, 20, 90, 70],
                     [1, 50, 50, 51, 52], [0, 200, 200, 300, 300]])
    cp = rs.uniform(0, 1, (2, 12, 6, 7))
    cases = [
        ("MultiBoxPrior", lambda d: c.multibox_prior(
            d, sizes=(0.3, 0.5), ratios=(1, 2, 0.5, 3), clip=True),
         [torch.zeros(2, 3, 9, 11)], (), (0,), 0.0, 0.0),
        ("MultiBoxTarget", lambda an, lb, p: c.multibox_target(
            an, lb, p, negative_mining_ratio=3.0),
         [anchors, t(lab), t(rs.standard_normal((4, 4, a)))], (), (1, 2),
         MBT_LOC_ATOL, 0.0),
        ("MultiBoxDetection", lambda p, l, an: c.multibox_detection(
            p, l, an, threshold=0.1, nms_threshold=0.4, nms_topk=50),
         [prob, t(0.3 * rs.standard_normal((4, a * 4))), anchors], (), (),
         BOX_ATOL, 0.0),
        ("Proposal", lambda p, d, i: c.proposal(
            p, d, i, rpn_pre_nms_top_n=100, rpn_post_nms_top_n=30,
            rpn_min_size=4, scales=(2, 4), ratios=(0.5, 1, 2),
            feature_stride=8, output_score=True),
         [t(cp), t(0.3 * rs.standard_normal((2, 24, 6, 7))),
          t([[48, 56, 1.0], [40, 44, 1.5]])], (), (1,), 1.6e-5, 0.0),
        ("fft", lambda d: c.fft(d), [t(rs.standard_normal((4, 64)))], (0,),
         (), 0.0, 1e-5),
        ("ifft", lambda d: c.ifft(d), [t(rs.standard_normal((4, 128)))],
         (0,), (), 0.0, 1e-5),
        ("count_sketch", lambda d, h, s: c.count_sketch(d, h, s, out_dim=16),
         [t(rs.standard_normal((8, 40))), t(rs.randint(0, 16, (1, 40))),
          t(rs.choice([-1.0, 1.0], (1, 40)))], (0, 2), (), 0.0, 1e-6),
        ("ROIPooling", lambda d, r: v.roi_pooling(
            d, r, pooled_size=(3, 4), spatial_scale=0.25),
         [t(feat), t(rois)], (0,), (0,), 0.0, 1e-6),
        ("BilinearSampler", v.bilinear_sampler,
         [t(rs.standard_normal((2, 3, 9, 11))),
          t(rs.uniform(-1.2, 1.2, (2, 2, 7, 8)))], (0, 1), (), 0.0, 1e-5),
        ("GridGenerator", lambda d: v.grid_generator(
            d, transform_type="affine", target_shape=(6, 7)),
         [t(rs.standard_normal((3, 6)))], (0,), (), 0.0, 1e-6),
        ("GridGenerator warp", lambda d: v.grid_generator(
            d, transform_type="warp"), [t(rs.standard_normal((2, 2, 5, 6)))],
         (0,), (), 0.0, 1e-6),
        ("SpatialTransformer", lambda d, l: v.spatial_transformer(
            d, l, target_shape=(6, 7)),
         [t(rs.standard_normal((2, 3, 9, 11))),
          t([[0.9, 0.1, 0.05, -0.1, 0.8, 0.0], [1.1, -0.2, 0.1, 0.2, 0.7,
                                                -0.3]])], (0, 1), (), 0.0,
         1e-5),
        ("Correlation", lambda x, y: v.correlation(
            x, y, kernel_size=3, max_displacement=4, stride1=2, stride2=2,
            pad_size=4, is_multiply=False),
         [t(rs.standard_normal((2, 16, 12, 14))),
          t(rs.standard_normal((2, 16, 12, 14)))], (0, 1), (), 0.0, 1e-5),
        ("Correlation multiply", lambda x, y: v.correlation(
            x, y, kernel_size=1, max_displacement=4, stride1=1, stride2=2,
            pad_size=4),
         [t(rs.standard_normal((2, 16, 12, 14))),
          t(rs.standard_normal((2, 16, 12, 14)))], (0, 1), (), 0.0, 1e-5),
        ("WarpCTC", lambda d, l: ctc.warpctc(d, l, label_length=4,
                                              input_length=20),
         [t(rs.standard_normal((20 * 4, 8))), t(rs.randint(0, 8, (4, 4)))],
         (0,), (), 0.0, 1e-5),
        ("ctc_loss", lambda d, l: ctc.ctc_loss_op(d, l),
         [t(rs.standard_normal((20, 4, 8))), t(rs.randint(0, 8, (4, 5)))],
         (0,), (), 0.0, 1e-5),
    ]
    done = []
    for k, (name, fn, inputs, diff, exact, atol, rtol) in enumerate(cases):
        worst = _sweep_case(torch, dev, name, fn, inputs, diff, seed + k,
                            exact, atol, rtol)
        done.append("%s %.2g" % (name, worst))
    canonical = {"MultiBoxPrior", "MultiBoxTarget", "MultiBoxDetection",
                 "Proposal", "fft", "ifft", "count_sketch", "ROIPooling",
                 "BilinearSampler", "GridGenerator", "SpatialTransformer",
                 "Correlation", "WarpCTC", "ctc_loss"}
    check(canonical <= {case[0] for case in cases}, "op sweep misses ops")
    log("op sweep: %d ops (%d cases) card against CPU, forward and backward "
        "where differentiable, worst |diff| / max: %s" % (
            len(canonical), len(cases), ", ".join(done)))
    # the published shapes: peak memory of a forward + backward
    shape, n_rois, pooled, scale = ROI_PUBLISHED
    data = torch.from_numpy(np.maximum(rs.standard_normal(shape), 0).astype(
        np.float32)).to(dev)
    h, w = shape[2] / scale, shape[3] / scale
    x1 = rs.uniform(0, w - 32, n_rois)
    y1 = rs.uniform(0, h - 32, n_rois)
    roi = np.stack([np.zeros(n_rois), x1, y1,
                    np.minimum(w - 1, x1 + rs.uniform(16, 400, n_rois)),
                    np.minimum(h - 1, y1 + rs.uniform(16, 300, n_rois))], 1)
    roi = torch.from_numpy(roi.astype(np.float32)).to(dev)
    corr_shape, corr_kw = CORR_PUBLISHED
    f1 = torch.from_numpy(rs.standard_normal(corr_shape).astype(
        np.float32)).to(dev)
    f2 = torch.from_numpy(rs.standard_normal(corr_shape).astype(
        np.float32)).to(dev)
    for name, fn, args, what in (
            ("ROIPooling", lambda d: v.roi_pooling(
                d, roi, pooled_size=pooled, spatial_scale=scale), [data],
             "%s, %d ROIs, %dx%d, scale 1/%d" % (
                 shape, n_rois, pooled[0], pooled[1], round(1 / scale))),
            ("Correlation", lambda x, y: v.correlation(x, y, **corr_kw),
             [f1, f2], "%s, %s" % (corr_shape, corr_kw))):
        args = [a.clone().requires_grad_() for a in args]
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn(*args)
        grads = torch.autograd.grad(out, args, torch.ones_like(out))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() - resident
        check(all(torch.isfinite(g).all() for g in grads)
              and torch.isfinite(out).all(), "%s published: not finite"
              % name)
        log("%s at its published shape (%s): output %s, forward + backward "
            "%.2f ms (host clock, first call), peak %.3f GiB above resident "
            "(target under %g); on %s" % (
                name, what, tuple(out.shape), ms, peak / 2 ** 30,
                PEAK_TARGET_GIB, card))
        check(peak < PEAK_TARGET_GIB * 2 ** 30, "%s published shape: peak "
              "%.3f GiB above resident" % (name, peak / 2 ** 30))
        del out, grads, args
    del data, f1, f2
    gc.collect()
    torch.cuda.empty_cache()


def detection_paths(torch, mx, seed, card):
    """The rest of the op library on the card, driven by the examples that
    use it: SSD-512 ResNet-50 trained and run for detection through
    example/ssd, the MultiBox ops and Proposal held card against CPU,
    Faster R-CNN through example/rcnn, the toy CTC OCR through
    example/warpctc, and the op sweep.  Returns the main paths' launches
    by kernel."""
    ex = example_modules()
    launches = collections.Counter()
    mod, X, Y, detect, (fwd, bwd), per_forward = phase_ssd_fit(
        torch, mx, ex, seed, card)
    launches.update({"bn_act_fwd": fwd, "bn_act_bwd": bwd})
    target_in = phase_ssd_target_ms(torch, mx, Y, card)
    fwd, detect_in = phase_ssd_detect(torch, mx, mod, detect, X, per_forward,
                                      card)
    launches.update({"bn_act_fwd": fwd})
    phase_multibox_agreement(torch, mx, target_in, detect_in, seed)
    del target_in, detect_in
    phase_ssd_agreement(torch, mx, mod, X, Y, card)
    del mod, X, Y
    gc.collect()
    torch.cuda.empty_cache()
    phase_rcnn_fit(torch, mx, ex, seed, card)
    fwd, bwd = phase_warpctc(torch, mx, ex, seed, card)
    launches.update({"lstm_seq_fwd": fwd, "lstm_seq_bwd": bwd})
    phase_op_sweep(torch, mx, seed, card)
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# resilience: managed checkpoints, preemption and resume under
# tools/supervise.py, the hung-step watchdog, poison_grad, async saves,
# deferred metrics, the offline audit
# ---------------------------------------------------------------------------

RS_BATCHES = 6          # batches of each drill epoch (ResNet-50, batch 32)
RS_EPOCHS = 2
RS_SGD = {"learning_rate": 0.01, "momentum": 0.9, "wd": 1e-4}
RS_HANG_AT = 9          # the hung step: the 10th, epoch 1 batch 3
RS_STEP_TIMEOUT = 10    # seconds: MXTPU_STEP_TIMEOUT of the hang drill
RS_TERM_AFTER = (1, 2)  # SIGTERM once (epoch 1, nbatch 2) is done: batch 3
RS_DROP_PREEMPT = 5     # the Dropout net's in-band SIGTERM: boundary 6
RS_METRIC_BATCHES = 3   # batches of each deferred/blocking turn
RS_COUNT_STEPS = 2      # steps of each device-to-host count
RS_CHAIN_TIMEOUT = 420  # seconds the supervised chain may take
RS_TERM_SLACK_S = 1.0   # SIGTERM-to-exit beyond one step and the save

#: the drill's child, written to a temp directory and run as ``python3``:
#: a small Dropout net (its CUDA generator drawn each batch, so the
#: random state in the manifest must carry it) preempted in-band once,
#: then ResNet-50 through Module.fit(checkpoint=...) with deterministic
#: cuDNN/cuBLAS.  Its progress goes to RS_PROGRESS as JSON lines.
RS_CHILD = r'''
import atexit, json, logging, os, sys, time
T_START = time.time()
import torch
torch.backends.cudnn.deterministic = True
torch.backends.cudnn.benchmark = False
sys.path.insert(0, os.environ["RS_ROOT"])
logging.basicConfig(level=logging.INFO, format="  child %(message)s",
                    stream=sys.stderr)
import numpy as np
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.resilience import CheckpointManager, faults

PROGRESS = os.environ["RS_PROGRESS"]
SEED = int(os.environ["RS_SEED"])
BATCHES, EPOCHS = int(os.environ["RS_BATCHES"]), int(os.environ["RS_EPOCHS"])
chain = os.environ.get("RS_CHAIN") == "1"


def record(**kw):
    kw.update(pid=os.getpid(), t=time.time())
    with open(PROGRESS, "a") as f:
        f.write(json.dumps(kw) + "\n")


record(kind="start", t_start=T_START)
atexit.register(lambda: record(kind="exit"))
orig_save = mx.module.base_module.BaseModule._save_preemption_checkpoint


def timed_save(self, checkpoint, epoch, step):
    t0 = time.time()
    orig_save(self, checkpoint, epoch, step)
    record(kind="save", dir=checkpoint.directory, epoch=epoch, step=step,
           t0=t0, t1=time.time())


mx.module.base_module.BaseModule._save_preemption_checkpoint = timed_save
gpu = mx.gpu(0)

# -- the Dropout net: its CUDA generator round-trips through the manifest --
drop_dir = os.environ["RS_DROP_DIR"]
drop_man = CheckpointManager(drop_dir)
entry = drop_man.latest_entry()
if entry is not None and entry.get("step_state"):
    record(kind="drop_resume",
           generators=sorted(entry["step_state"]["rng"]["generators"]))
rs = np.random.RandomState(SEED + 3)
DX = rs.standard_normal((256, 32)).astype(np.float32)
DY = rs.randint(0, 4, 256).astype(np.float32)
with mx.name.NameManager():
    d = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=64,
                              name="dfc1")
    d = mx.sym.Dropout(mx.sym.Activation(d, act_type="relu"), p=0.3)
    d = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(d, num_hidden=4,
                                                   name="dfc2"),
                             name="softmax")
if chain and entry is None:
    faults.arm("preempt", times=1, after=int(os.environ["RS_DROP_PREEMPT"]))


def drop_draw(param):
    draw = mx.random.uniform(shape=(4,), ctx=gpu).asnumpy()
    record(kind="drop_draw", epoch=param.epoch, nbatch=param.nbatch,
           draw=[float(v).hex() for v in draw])


mx.random.seed(SEED + 4)
mx.random.uniform(shape=(1,), ctx=gpu)   # the CUDA generator exists
dmod = mx.mod.Module(d, context=gpu)
dmod.fit(mx.io.NDArrayIter(DX, DY, batch_size=64), num_epoch=2,
         kvstore="local", optimizer="sgd",
         optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
         initializer=mx.initializer.Xavier(), checkpoint=drop_man,
         preemption_safe=True, batch_end_callback=drop_draw)
del dmod

# -- ResNet-50 through Module.fit ---------------------------------------
res_dir = os.environ["RS_DIR"]
man = CheckpointManager(res_dir, keep_last=3)
resumed = man.latest() is not None
if resumed:
    # the drill's strip of its one-shot hang around a relaunch
    faults.disarm("hang_step")
with mx.name.NameManager():
    net = mx.models.get_symbol("resnet-50", num_classes=1000,
                               image_shape=(3, 224, 224))
gen = np.random.default_rng(SEED + 91)
X = gen.standard_normal((BATCHES * 32, 3, 224, 224), dtype=np.float32)
Y = gen.integers(0, 1000, BATCHES * 32).astype(np.float32)
ba = mx.kernels.bn_act


def progress(param):
    torch.cuda.synchronize()
    record(kind="batch", epoch=param.epoch, nbatch=param.nbatch,
           resumed=resumed, fwd=ba.LAUNCHES, bwd=ba.BWD_LAUNCHES)


mx.random.seed(SEED)
mod = mx.mod.Module(net, context=gpu)
ba.LAUNCHES = 0
ba.BWD_LAUNCHES = 0
mod.fit(mx.io.NDArrayIter(X, Y, batch_size=32), num_epoch=EPOCHS,
        kvstore="tpu", optimizer="sgd",
        optimizer_params=json.loads(os.environ["RS_SGD"]),
        initializer=mx.initializer.Xavier(rnd_type="gaussian",
                                          factor_type="in", magnitude=2),
        checkpoint=man, preemption_safe=True, batch_end_callback=progress)
record(kind="done", fwd=ba.LAUNCHES, bwd=ba.BWD_LAUNCHES)
'''


def _rs_records(path):
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _rs_env(root, tmp, name, seed, **extra):
    env = dict(os.environ)
    for k in ("MXTPU_RESUME", "MXTPU_FAULTS", "MXTPU_STEP_TIMEOUT",
              "MXTPU_CKPT_ASYNC", "MXTPU_DEBUG_DIR", "MXTPU_METRIC_BLOCKING",
              "MXTPU_ON_PREEMPT"):
        env.pop(k, None)
    env.update(RS_ROOT=root, RS_SEED=str(seed), RS_BATCHES=str(RS_BATCHES),
               RS_EPOCHS=str(RS_EPOCHS), RS_SGD=json.dumps(RS_SGD),
               RS_DROP_PREEMPT=str(RS_DROP_PREEMPT),
               RS_PROGRESS=os.path.join(tmp, name + ".jsonl"),
               RS_DIR=os.path.join(tmp, name, "resnet"),
               RS_DROP_DIR=os.path.join(tmp, name, "dropout"),
               CUBLAS_WORKSPACE_CONFIG=":4096:8")
    env.update(extra)
    return env


def _rs_check_launches(records, what):
    """Every ResNet batch of every launch added exactly 50 + 50 bn_act
    launches; returns the launch totals."""
    fwd = bwd = 0
    by_pid = collections.OrderedDict()
    for r in records:
        if r["kind"] == "batch":
            by_pid.setdefault(r["pid"], []).append(r)
    for pid, rows in by_pid.items():
        for k, r in enumerate(rows, 1):
            check((r["fwd"], r["bwd"]) == (50 * k, 50 * k),
                  "%s: process %d batch %d ran %d / %d bn_act launches "
                  "(expected %d each)" % (what, pid, k, r["fwd"], r["bwd"],
                                          50 * k))
        fwd += rows[-1]["fwd"]
        bwd += rows[-1]["bwd"]
    return fwd, bwd, sum(len(v) for v in by_pid.values())


def _same_bytes(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def _rs_same_files(a, b, names, what):
    for n in names:
        check(_same_bytes(os.path.join(a, n), os.path.join(b, n)),
              "%s: %s differs from the uninterrupted run's" % (what, n))


def _rs_param_diff(mx, np, a, b, name):
    """The largest absolute difference by parameter between two .params
    files (the finding when bit identity is missed)."""
    da, db = mx.nd.load(os.path.join(a, name)), mx.nd.load(
        os.path.join(b, name))
    return sorted(((float(np.abs(da[k].asnumpy() - db[k].asnumpy()).max()),
                    k) for k in da), reverse=True)[:3]


def phase_rs_drills(torch, mx, seed, card, tmp):
    """The uninterrupted run, then the supervised chain: the Dropout net
    preempted in-band (exit 85), ResNet-50 hung by ``hang_step`` (exit 87
    with a dump), SIGTERMed after batch 3 of epoch 1 (exit 85), and
    finished; final params and states against the uninterrupted run's
    bit for bit.  Returns the children's bn_act launches and the
    numbers."""
    import numpy as np
    script = os.path.join(tmp, "drill_child.py")
    with open(script, "w") as f:
        f.write(RS_CHILD)
    # the uninterrupted run and the supervised chain start together (the
    # chain's first launch trains only the Dropout net); the chain's
    # timed windows come after the uninterrupted run has ended
    env_full = _rs_env(ROOT, tmp, "full", seed)
    debug = os.path.join(tmp, "debug")
    env = _rs_env(ROOT, tmp, "cut", seed, RS_CHAIN="1",
                  MXTPU_FAULTS="hang_step:1@%d" % RS_HANG_AT,
                  MXTPU_STEP_TIMEOUT=str(RS_STEP_TIMEOUT),
                  MXTPU_DEBUG_DIR=debug)
    t0 = time.perf_counter()
    full_log = os.path.join(tmp, "full.log")
    out_path = os.path.join(tmp, "chain.log")
    with open(full_log, "w") as full_f, open(out_path, "w") as out_f:
        # each in a session of its own, so a failure stops the
        # supervisor's current child with it
        uninterrupted = subprocess.Popen([sys.executable, script],
                                         env=env_full, stdout=full_f,
                                         stderr=subprocess.STDOUT,
                                         start_new_session=True)
        sup = subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "tools", "supervise.py"),
             "--max-restarts", "3", "--backoff", "0", "--", sys.executable,
             script], env=env, stdout=out_f, stderr=subprocess.STDOUT,
            start_new_session=True)
        t_kill = victim = t_gone = full_s = None
        try:
            deadline = time.monotonic() + RS_CHAIN_TIMEOUT
            while sup.poll() is None or uninterrupted.poll() is None:
                check(time.monotonic() < deadline, "the drills did not "
                      "finish in %d s" % RS_CHAIN_TIMEOUT)
                if full_s is None and uninterrupted.poll() is not None:
                    full_s = time.perf_counter() - t0
                if victim is None:
                    for r in _rs_records(env["RS_PROGRESS"]):
                        if r["kind"] == "batch" and r["resumed"] and \
                                (r["epoch"], r["nbatch"]) == RS_TERM_AFTER:
                            victim = r["pid"]
                            t_kill = time.time()
                            os.kill(victim, signal.SIGTERM)
                            break
                elif t_gone is None and \
                        not os.path.exists("/proc/%d" % victim):
                    t_gone = time.time()
                time.sleep(0.005)
        finally:
            for proc in (sup, uninterrupted):
                if proc.poll() is None:
                    os.killpg(proc.pid, signal.SIGKILL)
                    proc.wait()
    chain_s = time.perf_counter() - t0
    full_s = chain_s if full_s is None else full_s
    full = _rs_records(env_full["RS_PROGRESS"])
    if uninterrupted.returncode != 0:
        with open(full_log) as f:
            log(f.read()[-4000:])
    check(uninterrupted.returncode == 0, "uninterrupted drill run exited %d"
          % uninterrupted.returncode)
    fwd, bwd, n_full = _rs_check_launches(full, "uninterrupted run")
    check(n_full == RS_BATCHES * RS_EPOCHS, "uninterrupted run trained %d "
          "batches" % n_full)
    batch_t = [r["t"] for r in full if r["kind"] == "batch"]
    steady = (batch_t[-1] - batch_t[RS_BATCHES]) / (RS_BATCHES - 1)
    log("resilience: uninterrupted ResNet-50 Module.fit (%d x %d batches, "
        "deterministic cuDNN/cuBLAS, CheckpointManager) in %.1f s as a "
        "process beside the chain's first launches; epoch 1 %.2f ms a "
        "batch; %d / %d bn_act launches"
        % (RS_EPOCHS, RS_BATCHES, full_s, steady * 1e3, fwd, bwd))
    with open(out_path) as f:
        chain_log = f.read()
    recs = _rs_records(env["RS_PROGRESS"])
    if sup.returncode != 0:
        log(chain_log[-6000:])
    check(sup.returncode == 0, "the supervised chain exited %d"
          % sup.returncode)
    starts = [r for r in recs if r["kind"] == "start"]
    for pat, what in (("graceful preemption — relaunch 1/3", "85 -> 1"),
                      ("watchdog abort (hung step) — relaunch 2/3",
                       "87 -> 2"),
                      ("graceful preemption — relaunch 3/3", "85 -> 3")):
        check(pat in chain_log, "supervise.py did not relaunch %s" % what)
    check(len(starts) == 4, "the chain ran %d launches, expected 4"
          % len(starts))
    # the watchdog's dump
    dumps = os.listdir(debug) if os.path.isdir(debug) else []
    check(len(dumps) == 1, "watchdog reports: %s" % dumps)
    with open(os.path.join(debug, dumps[0])) as f:
        report = f.read()
    for need in ("exceeded its %.1fs budget" % RS_STEP_TIMEOUT,
                 "--- thread", "maybe_hang", "torch.cuda device 0"):
        check(need in report, "the watchdog report lacks %r" % need)
    check("restored checkpoint epoch 1 from" in chain_log,
          "the relaunch after the hang did not resume epoch 1")
    # the SIGTERM launch: saved within one step plus the save
    check(victim is not None and t_gone is not None,
          "the SIGTERM launch was never seen or never exited")
    saves = [r for r in recs if r["kind"] == "save"
             and r["pid"] == victim]
    check(len(saves) == 1 and saves[0]["epoch"] == 1, "the SIGTERMed "
          "launch saved %s" % saves)
    save = saves[0]
    exit_t = [r["t"] for r in recs if r["kind"] == "exit"
              and r["pid"] == victim][0]
    vb = [r["t"] for r in recs if r["kind"] == "batch"
          and r["pid"] == victim]
    step_s = max(b - a for a, b in zip(vb[1:], vb[2:]))
    save_s = save["t1"] - save["t0"]
    term_exit = exit_t - t_kill
    check(term_exit <= step_s + save_s + RS_TERM_SLACK_S,
          "SIGTERM to exit took %.2f s (one step %.3f s + save %.3f s)"
          % (term_exit, step_s, save_s))
    # the last launch fast-forwarded past the saved steps (the first
    # fast-forward is the Dropout net's, in the second launch)
    ff = re.findall(r"fast-forwarded (\d+) batches of epoch 1 in ([0-9.]+) "
                    r"s", chain_log)
    check(len(ff) == 2 and int(ff[1][0]) == save["step"],
          "fast-forward %s after a save at step %d" % (ff, save["step"]))
    ff = ff[1:]
    last = starts[-1]["pid"]
    last_first = [r["t"] for r in recs if r["kind"] == "batch"
                  and r["pid"] == last][0]
    last_start = starts[-1]["t_start"]
    # every batch of epoch 1 ran exactly once across the last two launches
    tail = [(r["epoch"], r["nbatch"]) for r in recs if r["kind"] == "batch"
            and r["pid"] in (victim, last)]
    check(sorted(tail) == [(1, b) for b in range(RS_BATCHES)],
          "epoch 1 across the SIGTERM: %s" % tail)
    cfwd, cbwd, n_chain = _rs_check_launches(recs, "supervised chain")
    # bit for bit: ResNet-50 params and momentum, the Dropout net's
    # params and its CUDA draws
    names = ["checkpoint-%04d.params" % RS_EPOCHS,
             "checkpoint-%04d.states" % RS_EPOCHS]
    full_dir, cut_dir = (os.path.join(tmp, n, "resnet")
                         for n in ("full", "cut"))
    same = all(_same_bytes(os.path.join(full_dir, n),
                           os.path.join(cut_dir, n)) for n in names)
    if not same:
        log("resilience: the resumed ResNet-50 differs; largest "
            "differences by parameter: %s" % _rs_param_diff(
                mx, np, full_dir, cut_dir, names[0]))
    check(same, "the preempted and resumed ResNet-50 is not bit-identical "
          "to the uninterrupted run")
    _rs_same_files(os.path.join(tmp, "full", "dropout"),
                   os.path.join(tmp, "cut", "dropout"),
                   ["checkpoint-0002.params", "checkpoint-0002.states"],
                   "the Dropout net")
    draws = {}
    for what, rows in (("full", full), ("cut", recs)):
        draws[what] = sorted((r["epoch"], r["nbatch"], tuple(r["draw"]))
                             for r in rows if r["kind"] == "drop_draw")
    check(draws["full"] == draws["cut"] and len(draws["full"]) == 8,
          "the Dropout net's CUDA draws differ across the preemption")
    resumes = [r for r in recs if r["kind"] == "drop_resume"]
    check(resumes and "cuda:0" in resumes[0]["generators"],
          "the Dropout net's manifest rng holds no CUDA generator: %s"
          % resumes)
    log("resilience: supervised chain in %.1f s (4 launches): Dropout net "
        "in-band SIGTERM -> 85 -> relaunch, resumed from the manifest's "
        "random state (generators %s), its params and 8 CUDA draws equal "
        "the uninterrupted run's; ResNet-50 hung at step %d -> watchdog "
        "%d s -> 87 with a %d-byte dump -> relaunch from epoch 1; SIGTERM "
        "after batch 3 of epoch 1 -> saved at step %d -> 85 -> relaunch, "
        "fast-forward %s batches in %s s -> done; epoch-%d params and "
        "momentum equal the uninterrupted run's bit for bit; %d / %d bn_act "
        "launches in %d batches" % (
            chain_s, resumes[0]["generators"], RS_HANG_AT + 1,
            RS_STEP_TIMEOUT, len(report), save["step"], ff[0][0], ff[0][1],
            RS_EPOCHS, cfwd, cbwd, n_chain))
    log("resilience: SIGTERM to exit %.3f s (process gone %.3f s): the "
        "batch in flight, then the blocking preemption save %.3f s (one "
        "step %.3f s); resume: launch to first trained batch %.2f s, of it "
        "the fast-forward %s s, on %s" % (
            term_exit, t_gone - t_kill, save_s, step_s,
            last_first - last_start, ff[0][1], card))
    return {"fwd": fwd + cfwd, "bwd": bwd + cbwd,
            "full_dir": full_dir, "term_exit_s": term_exit,
            "save_s": save_s, "ff_s": float(ff[0][1])}


def _rs_module(torch, mx, seed):
    """ResNet-50 on the fused route with the drill's sgd and seeded
    batches (host arrays, as NDArrayIter gives them)."""
    import numpy as np
    with mx.name.NameManager():
        net = mx.models.get_symbol("resnet-50", num_classes=1000,
                                   image_shape=IMAGE)
    rs = np.random.RandomState(seed + 93)
    X = rs.standard_normal((RS_METRIC_BATCHES * BATCH,) + IMAGE) \
        .astype(np.float32)
    Y = rs.randint(0, 1000, RS_METRIC_BATCHES * BATCH).astype(np.float32)
    it = mx.io.NDArrayIter(X, Y, batch_size=BATCH)
    batches = list(it)
    mod = mx.mod.Module(net, context=mx.gpu(0))
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mx.random.seed(seed)
    mod.init_params(mx.initializer.Xavier(rnd_type="gaussian",
                                          factor_type="in", magnitude=2))
    mod.init_optimizer(kvstore="tpu", optimizer="sgd",
                       optimizer_params=dict(RS_SGD))
    check(mod._fused is not None, "resilience module: no fused route")
    return mod, batches


def _rs_steps(mod, metric, batches):
    for b in batches:
        mod.forward_backward(b)
        mod.update()
        mod.update_metric(metric, b.label)


def phase_rs_poison(torch, mx, mod, batches):
    """One ``poison_grad`` step: SkippedSteps reads 1, and params, moving
    statistics and momentum are unchanged bit for bit across it."""
    import pickle
    import numpy as np
    metric = mx.metric.Accuracy()
    _rs_steps(mod, metric, batches[:1])      # momentum is nonzero now
    args0, aux0 = mod.get_params()
    states0 = pickle.loads(mod.get_optimizer_states())
    skipped = mx.metric.SkippedSteps(mod)
    before = skipped.get()[1]
    mx.resilience.faults.arm("poison_grad")
    try:
        _rs_steps(mod, metric, batches[1:2])
    finally:
        mx.resilience.faults.disarm("poison_grad")
    after = skipped.get()[1]
    args1, aux1 = mod.get_params()
    states1 = pickle.loads(mod.get_optimizer_states())
    moved = [k for k in args0 if not np.array_equal(
        args0[k].asnumpy(), args1[k].asnumpy())]
    moved += [k for k in aux0 if not np.array_equal(
        aux0[k].asnumpy(), aux1[k].asnumpy())]
    moved += [k for k, s in states0["states"].items() if not all(
        np.array_equal(a, b) for a, b in zip(s, states1["states"][k]))]
    check(after - before == 1, "poison_grad: SkippedSteps %g -> %g"
          % (before, after))
    check(not moved and states0["num_update"] == states1["num_update"],
          "poison_grad moved %s" % moved[:5])
    log("resilience: poison_grad: SkippedSteps %g -> %g; %d params, %d "
        "moving statistics and %d momentum tensors unchanged bit for bit, "
        "update count %d kept" % (before, after, len(args0), len(aux0),
                                  len(states0["states"]),
                                  states1["num_update"]))
    _rs_steps(mod, metric, batches[2:3])
    check(mx.metric.SkippedSteps(mod).get()[1] == after,
          "the clean step after the poisoned one was skipped")


def phase_rs_metric(torch, mx, mod, batches, card):
    """Deferred Accuracy against MXTPU_METRIC_BLOCKING=1 on the fused
    route: ms a batch in turns, device-to-host bytes a step (the
    dispatch-mode counter) between folds."""
    timings = {True: [], False: []}
    copies = {}
    try:
        for deferred in (True, False, False, True):
            os.environ["MXTPU_METRIC_BLOCKING"] = "0" if deferred else "1"
            metric = mx.metric.Accuracy()
            mod._install_deferred_metric(metric)
            check((mod._deferred_metric is metric) == deferred,
                  "deferred metric install: %s" % mod._deferred_metric)
            _rs_steps(mod, metric, batches[:1])        # warm
            metric.get()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _rs_steps(mod, metric, batches)
            value = metric.get()
            torch.cuda.synchronize()
            timings[deferred].append(
                (time.perf_counter() - t0) * 1e3 / len(batches))
            if deferred not in copies:
                copies[deferred] = dtoh_ops(torch, lambda: _rs_steps(
                    mod, metric, batches[:RS_COUNT_STEPS]))
            check(metric.num_inst > 0 and 0 <= value[1] <= 1,
                  "metric %s" % (value,))
    finally:
        os.environ.pop("MXTPU_METRIC_BLOCKING", None)
    n = RS_COUNT_STEPS
    check(copies[True][1] == 0, "deferred Accuracy copied %d bytes in %d "
          "steps" % (copies[True][1], n))
    check(copies[False][1] >= n * BATCH * 1000 * 4, "blocking Accuracy "
          "copied only %d bytes in %d steps" % (copies[False][1], n))
    log("resilience: deferred Accuracy %s ms a batch against blocking %s "
        "(turns D B B D, %d batches each); device-to-host a step: deferred "
        "%d bytes in %d copies, blocking %d bytes in %d copies (%d steps "
        "counted), on %s" % (
            " / ".join("%.2f" % v for v in timings[True]),
            " / ".join("%.2f" % v for v in timings[False]),
            len(batches), copies[True][1] // n, copies[True][0] // n,
            copies[False][1] // n, copies[False][0] // n, n, card))
    return timings, copies


def phase_rs_save_cost(torch, mx, mod, tmp, card):
    """An epoch-end save of ResNet-50 (params + momentum) blocking
    against MXTPU_CKPT_ASYNC's path, in turns: the step loop's stall (the
    optimizer state's serialization and the save call), the bytes
    written, the writer's wall time."""
    man = mx.resilience.CheckpointManager(os.path.join(tmp, "savecost"),
                                          keep_last=2)
    rows = []
    for epoch, blocking in enumerate((True, False, False, True), 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        arg, aux = mod.get_params()
        t1 = time.perf_counter()
        states = mod.get_optimizer_states()
        man.save(epoch, mod.symbol, arg, aux, optimizer_states=states,
                 blocking=blocking)
        t2 = time.perf_counter()
        writer = None
        if not blocking:
            writer = man.wait()["elapsed_s"]
        sizes = [os.path.getsize(p) for p in (man.params_path(epoch),
                                             man.states_path(epoch))]
        rows.append((blocking, (t1 - t0) * 1e3, (t2 - t1) * 1e3, writer,
                     sizes))
    for blocking, get_ms, stall_ms, writer, sizes in rows:
        log("resilience: epoch-end save %s: get_params %.1f ms, stall %.1f "
            "ms%s; %d bytes of params + %d of momentum, on %s" % (
                "blocking" if blocking else "async", get_ms, stall_ms,
                "" if writer is None else ", writer %.1f ms" % (writer * 1e3),
                sizes[0], sizes[1], card))
    check(all(abs(r[4][0] - 102e6) < 5e6 and abs(r[4][1] - 102e6) < 5e6
              for r in rows), "save sizes %s" % [r[4] for r in rows])
    check(man.restore()[4] == 4, "the save-cost manager does not restore")
    return rows


def phase_rs_audit(mx, full_dir):
    """tools/ckpt_fsck.py on the uninterrupted run's directory: exit 0,
    then 1 after its newest params file rots; the port's
    verify_promotion agrees."""
    fsck = os.path.join(ROOT, "tools", "ckpt_fsck.py")

    def audit():
        return subprocess.run([sys.executable, fsck, full_dir, "-q"],
                              capture_output=True, text=True, timeout=120)

    res0 = audit()
    v0 = mx.resilience.verify_promotion(full_dir)
    path = os.path.join(full_dir, "checkpoint-%04d.params" % RS_EPOCHS)
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.seek(size // 2)
        b = f.read(1)
        f.seek(size // 2)
        f.write(bytes([b[0] ^ 0xFF]))
    res1 = audit()
    v1 = mx.resilience.verify_promotion(full_dir)
    log("resilience: ckpt_fsck exit %d on the run's directory, %d after "
        "the newest params rots; verify_promotion %s then %s" % (
            res0.returncode, res1.returncode, v0, (v1[0], v1[1][:1])))
    check(res0.returncode == 0 and v0 == (RS_EPOCHS, []),
          "clean audit: fsck %d, %s" % (res0.returncode, v0))
    check(res1.returncode == 1 and v1[0] == RS_EPOCHS and v1[1],
          "rotted audit: fsck %d, %s" % (res1.returncode, v1))


def resilience_paths(torch, mx, seed, card):
    """The resilience slice on the card (runs last): the drills as child
    processes (uninterrupted ResNet-50 fit; the supervised chain through
    exit 85, 87 and 85 to a bit-identical finish), then in this process a
    poison_grad step, deferred against blocking Accuracy, the epoch-end
    save's cost blocking and async, and the offline audit.  Returns the
    main paths' bn_act launches."""
    build_dir = os.path.join(ROOT, "mxnet_tpu_torch", "_build")
    os.makedirs(build_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="resilience-", dir=build_dir)
    try:
        drills = phase_rs_drills(torch, mx, seed, card, tmp)
        mod, batches = _rs_module(torch, mx, seed)
        ba = mx.kernels.bn_act
        ba.LAUNCHES = 0
        ba.BWD_LAUNCHES = 0
        phase_rs_poison(torch, mx, mod, batches)
        phase_rs_metric(torch, mx, mod, batches, card)
        torch.cuda.synchronize()
        fwd, bwd = ba.LAUNCHES, ba.BWD_LAUNCHES
        steps = 3 + 4 * (1 + RS_METRIC_BATCHES) + 2 * RS_COUNT_STEPS
        check((fwd, bwd) == (50 * steps, 50 * steps),
              "resilience module: %d / %d bn_act launches in %d steps"
              % (fwd, bwd, steps))
        phase_rs_save_cost(torch, mx, mod, tmp, card)
        del mod, batches
        gc.collect()
        torch.cuda.empty_cache()
        phase_rs_audit(mx, drills["full_dir"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return collections.Counter({"bn_act_fwd": drills["fwd"] + fwd,
                                "bn_act_bwd": drills["bwd"] + bwd})


# ---------------------------------------------------------------------------
# serving: the pool, the daemon, hot swap and the watchdog drill
# ---------------------------------------------------------------------------

SV_BUCKETS = (1, 2, 4, 8, 16, 32)
SV_TIMED = 3            # timed pool forwards at each bucket after the warmup
SV_IDENTITY = (5, 8)    # rows, bucket of the bit-identity check
SV_AGREE_BUCKET = 4     # the card against the port's CPU path
SV_BF16_ATOL = 1e-2     # bfloat16 weights against float32, max |diff|
SV_INT8_TOL = dict(atol=2e-2, rtol=5e-2)   # int8 against float32
SV_LOAD_S = 1.0         # closed-loop seconds at each concurrency
SV_CONCURRENCY = (1, 32)
SV_SWAP_CLIENTS = 8     # concurrency while a new epoch is published
SV_DRAIN_CLIENTS = 8    # requests in flight at SIGTERM
SV_SEQ_BUCKETS = (8, 16, 32)
SV_SEQ_LENS = (5, 16, 29)   # one /predict_seq request at each bucket
SV_STEP_TIMEOUT = 5     # MXTPU_STEP_TIMEOUT of the watchdog drill
SV_WAIT_S = 240         # the longest any one wait of the phase may take
SERVE_MAIN = os.path.join(ROOT, "mxnet_tpu_torch", "serving", "serve_main.py")
#: the serving daemon's cold warmup (no store), which the fleet's warm
#: store line reports beside the replicas' warmup from the store
_SV_COLD = {}
#: fleet processes started ahead of their phase (the warm store's
#: builder, the ``--workers 2`` fleet): ``fleet_paths`` and ``main`` stop
#: any still running when they end
_BACKGROUND = []
#: the watchdog drill's child: serve_main.py, with the injected fault
#: dropped on the supervisor's relaunch (MXTPU_RESUME=1), as a respawn does
SV_CHILD = """
import os, runpy, sys
if os.environ.get("MXTPU_RESUME") == "1":
    os.environ.pop("MXTPU_FAULTS", None)
sys.argv = [%(main)r] + sys.argv[1:]
runpy.run_path(%(main)r, run_name="__main__")
"""


def _sv_save_resnet(mx, symbol, seed, directory, epoch):
    """Seeded ResNet-50 weights published as ``epoch`` of a
    CheckpointManager directory; returns the host (args, aux)."""
    w_args, w_aux = draw_weights(symbol, (BATCH,) + IMAGE, seed)
    args, aux = mx.convert.params_from_numpy((w_args, w_aux), ctx=mx.cpu())
    mx.resilience.CheckpointManager(directory).save(
        epoch, symbol, args, aux, blocking=True)
    return args, aux


def _sv_save_lm(mx, seed, directory):
    """The LM (vocab 10000, width 200, 2 layers) with seeded weights,
    published without its init states (zero-filled per batch bucket)."""
    symbol = lm_symbol(mx)
    w, _ = _lm_weights(symbol, LM_BATCH, seed)
    w = {k: v for k, v in w.items()
         if k not in ("lstm_init_h", "lstm_init_c")}
    args, _ = mx.convert.params_from_numpy((w, {}), ctx=mx.cpu())
    mx.resilience.CheckpointManager(directory).save(
        1, symbol, args, {}, blocking=True)
    return symbol, args


def _sv_env(**extra):
    env = dict(os.environ)
    for k in ("MXTPU_RESUME", "MXTPU_FAULTS", "MXTPU_STEP_TIMEOUT",
              "MXTPU_DEBUG_DIR", "MXTPU_COMPILE_CACHE", "MXTPU_SERVE_DTYPE",
              "MXTPU_ANALYZE", "MXTPU_SWAP_POLL_S"):
        env.pop(k, None)
    env.update(extra)
    return env


def _sv_wait_port(port_file, proc, log_path):
    deadline = time.monotonic() + SV_WAIT_S
    while True:
        try:
            with open(port_file) as f:
                return int(f.read().split(":")[1])
        except (OSError, ValueError, IndexError):
            pass
        if proc.poll() is not None:
            with open(log_path) as f:
                log(f.read()[-4000:])
        check(proc.poll() is None, "serve daemon exited %s before "
              "listening" % proc.returncode)
        check(time.monotonic() < deadline, "serve daemon did not listen "
              "in %d s" % SV_WAIT_S)
        time.sleep(0.05)


def _sv_stop(proc):
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


def _sv_line(text, tag):
    """The JSON of the last ``mxserve: <tag> {...}`` line."""
    lines = [ln for ln in text.splitlines()
             if ln.startswith("mxserve: %s " % tag)]
    check(lines, "no 'mxserve: %s' line in the daemon's log" % tag)
    return json.loads(lines[-1][len("mxserve: %s " % tag):])


def _sv_mem(torch):
    torch.cuda.synchronize()
    gc.collect()
    return torch.cuda.memory_allocated()


def _sv_peak(torch, fn):
    """Peak device bytes above what is allocated before ``fn()``."""
    base = _sv_mem(torch)
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def phase_sv_pool(torch, mx, seed, card, res_dir, symbol):
    """ResNet-50 in process through ``ModelPool.load_dir`` on gpu(0):
    warmed over every bucket, timed at each, the bucket bit-identity
    contract at full width, a full bucket against ``Predictor``, the card
    against the port's CPU path, and the bfloat16 and int8 pools against
    float32 with their resident and peak memory.  Returns the bn_act
    launches of the pool forwards and the numbers."""
    import numpy as np
    from mxnet_tpu_torch.serving import pad_to_bucket
    ba = mx.kernels.bn_act
    gpu = mx.gpu(0)
    sample = {"data": IMAGE}
    rs = np.random.RandomState(seed + 70)
    xs = {b: rs.standard_normal((b,) + IMAGE).astype(np.float32)
          for b in SV_BUCKETS}
    ident = rs.standard_normal((SV_IDENTITY[0],) + IMAGE).astype(np.float32)
    out = {}
    mem0 = _sv_mem(torch)
    t0 = time.perf_counter()
    entry = mx.serving.ModelPool(ctx=gpu).load_dir("resnet", res_dir,
                                                   sample_shapes=sample)
    out["load_s"] = time.perf_counter() - t0

    # -- the main path: counts zeroed just before, read just after ---------
    ba.LAUNCHES = 0
    t0 = time.perf_counter()
    entry.forward({"data": xs[BATCH]})
    out["first_s"] = time.perf_counter() - t0
    # resident: the weights and one bucket's executor, as for the
    # low-precision pools below
    out["resident"] = {"float32": _sv_mem(torch) - mem0}
    t0 = time.perf_counter()
    entry.warmup(SV_BUCKETS)
    torch.cuda.synchronize()
    out["warmup_s"] = time.perf_counter() - t0
    forwards = 1 + len(SV_BUCKETS)
    times, outs = {}, {}
    for b in SV_BUCKETS:
        before = ba.LAUNCHES
        times[b] = []
        for _ in range(SV_TIMED):
            t0 = time.perf_counter()
            outs[b] = entry.forward({"data": xs[b]})[0]
            times[b].append((time.perf_counter() - t0) * 1e3)
        forwards += SV_TIMED
        check(ba.LAUNCHES - before == 17 * SV_TIMED, "bucket %d: %d bn_act "
              "launches in %d forwards" % (b, ba.LAUNCHES - before, SV_TIMED))
        check(outs[b].shape == (b, 1000) and np.isfinite(outs[b]).all()
              and np.allclose(outs[b].sum(1), 1.0, atol=1e-4),
              "bucket %d output bad" % b)
    n, bucket = SV_IDENTITY
    shared = entry.forward({"data": pad_to_bucket(list(ident), bucket)})[0]
    alone = [entry.forward({"data": pad_to_bucket([ident[i]], bucket)})[0][0]
             for i in range(n)]
    forwards += 1 + n
    _, out["peak"] = _sv_peak(torch, lambda: entry.forward(
        {"data": xs[BATCH]}))
    out["peak"] = {"float32": out["peak"]}
    forwards += 1
    low = {}
    for dtype in ("bfloat16", "int8"):
        m0 = _sv_mem(torch)
        e = mx.serving.ModelPool(ctx=gpu, dtype=dtype).load_dir(
            "resnet", res_dir, sample_shapes=sample)
        low[dtype] = e.forward({"data": xs[BATCH]})[0]
        out["resident"][dtype] = _sv_mem(torch) - m0
        out.setdefault("weight_bytes", {})[dtype] = e.resident_weight_bytes()
        low[dtype], out["peak"][dtype] = _sv_peak(torch, lambda: e.forward(
            {"data": xs[BATCH]})[0])
        forwards += 2
        if dtype == "int8":
            f32_bytes = sum(int(np.prod(e.arg_params[k].shape)) * 4
                            for k in e._wt_scales)
            out["int8_fraction"] = e.resident_weight_bytes() / f32_bytes
        del e
    launches = ba.LAUNCHES
    # ----------------------------------------------------------------------
    check(launches == 17 * forwards, "pool: %d bn_act launches in %d "
          "forwards (17 a forward)" % (launches, forwards))
    for i in range(n):
        check(np.array_equal(shared[i], alone[i]), "bucket %d: row %d of %d "
              "differs from the row served alone" % (bucket, i, n))
    args, aux = mx.resilience.CheckpointManager(res_dir).restore()[1:3]
    pred = mx.predict.Predictor(entry.symbol, _with_prefixes(args, aux),
                                {"data": (BATCH,) + IMAGE}, ctx=gpu)
    full = pred.forward(data=xs[BATCH]).get_output(0)
    check(np.array_equal(outs[BATCH], full), "a full bucket %d differs "
          "from Predictor at (%d, 3, 224, 224)" % (BATCH, BATCH))
    del pred
    cpu_entry = mx.serving.ModelPool(ctx=mx.cpu()).load_dir(
        "resnet", res_dir, sample_shapes=sample)
    ref = cpu_entry.forward({"data": xs[SV_AGREE_BUCKET]})[0]
    diff = float(np.abs(outs[SV_AGREE_BUCKET] - ref).max())
    check(diff <= 1e-3 * float(np.abs(ref).max()) and
          (outs[SV_AGREE_BUCKET].argmax(1) == ref.argmax(1)).all(),
          "pool bucket %d: card against CPU %.3g" % (SV_AGREE_BUCKET, diff))
    d16 = float(np.abs(low["bfloat16"] - outs[BATCH]).max())
    check(d16 <= SV_BF16_ATOL, "bfloat16 pool: max |diff| %.3g" % d16)
    d8 = float(np.abs(low["int8"] - outs[BATCH]).max())
    check(np.allclose(low["int8"], outs[BATCH], **SV_INT8_TOL),
          "int8 pool: max |diff| %.3g" % d8)
    check(out["int8_fraction"] < 0.3, "int8 weights hold %.3f of float32's "
          "bytes" % out["int8_fraction"])
    log("serving pool: resnet-50 load_dir %.2f s, first forward (bucket "
        "32) %.2f s, then warmup over buckets %s %.2f s; %d forwards, %d "
        "bn_act launches (17 a forward)" % (
            out["load_s"], out["first_s"], list(SV_BUCKETS),
            out["warmup_s"], forwards, launches))
    log("serving pool: forward ms by bucket (host clock to the output on "
        "the host, %d each after the warmup): %s; img/s at bucket 32 %.1f, "
        "on %s" % (SV_TIMED, ", ".join(
            "%d: %s" % (b, " / ".join("%.2f" % t for t in times[b]))
            for b in SV_BUCKETS), BATCH * 1e3 / min(times[BATCH]), card))
    log("serving pool: %d rows in bucket %d equal each row served alone bit "
        "for bit; bucket %d equals Predictor bit for bit; bucket %d card "
        "against CPU max |diff| %.3g (bound 1e-3 x %.3g)" % (
            n, bucket, BATCH, SV_AGREE_BUCKET, diff,
            float(np.abs(ref).max())))
    log("serving pool: against float32 at bucket 32: bfloat16 max |diff| "
        "%.3g (bound %g), int8 max |diff| %.3g (atol 2e-2, rtol 5e-2); int8 "
        "weights %.3f of float32's bytes" % (d16, SV_BF16_ATOL, d8,
                                              out["int8_fraction"]))
    for dtype in ("float32", "bfloat16", "int8"):
        log("serving pool memory %s: resident %.1f MiB, a bucket-32 "
            "forward's peak above it %.1f MiB, on %s" % (
                dtype, out["resident"][dtype] / 2 ** 20,
                out["peak"][dtype] / 2 ** 20, card))
    out["times"] = times
    return launches, out


def _sv_stats(cli):
    status, payload = cli.stats()
    check(status == 200, "/stats answered %s" % status)
    return payload


def _sv_traffic(mx, port, model, x, clients, stop, rows):
    """``clients`` threads sending ``x`` (x-npy) until ``stop`` is set;
    each result (send time, status, ms) goes to ``rows``."""
    import threading

    def worker():
        cli = mx.serving.ServeClient("127.0.0.1", port, timeout=60)
        try:
            while not stop.is_set():
                t0 = time.perf_counter()
                try:
                    status, _ = cli.predict(model, x, npy=True)
                except Exception:  # noqa: BLE001 — a dropped connection
                    status = -1
                rows.append((t0, status, (time.perf_counter() - t0) * 1e3))
        finally:
            cli.close()

    threads = [threading.Thread(target=worker) for _ in range(clients)]
    for t in threads:
        t.start()
    return threads


def _sv_predict(mx, port, model, x):
    cli = mx.serving.ServeClient("127.0.0.1", port, timeout=60)
    try:
        status, payload = cli.predict(model, x, npy=True)
    finally:
        cli.close()
    check(status == 200, "%s answered %s: %s" % (model, status, payload))
    import numpy as np
    return np.asarray(payload["outputs"][0], dtype=np.float32)


def _sv_wait(what, cond):
    deadline = time.monotonic() + SV_WAIT_S
    while not cond():
        check(time.monotonic() < deadline, "waited %d s for %s"
              % (SV_WAIT_S, what))
        time.sleep(0.05)


def phase_sv_daemon(torch, mx, seed, card, tmp, res_dir, symbol, bench):
    """serve_main.py on gpu(0) with ResNet-50 (its CheckpointManager
    directory, watched), bench.py's serving MLP and the LM: bit parity of
    a quiet request, closed-loop load at concurrency 1 and 32, the LM at
    three length buckets, a new epoch published under traffic, a rollback
    by the ``swap_probe`` fault point, a SIGTERM drain with requests in
    flight and the daemon's launch counters.  Returns its bn_act and
    lstm_seq launches and the numbers."""
    import threading
    import numpy as np
    os.makedirs(os.path.join(tmp, "bench"))
    specs = bench._save_serving_models(os.path.join(tmp, "bench"))
    lm_dir = os.path.join(tmp, "lm")
    lm_sym, lm_args = _sv_save_lm(mx, seed + 80, lm_dir)
    port_file = os.path.join(tmp, "daemon.port")
    log_path = os.path.join(tmp, "daemon.log")
    mlp_prefix, mlp_epoch, mlp_sample = specs["mlp"]
    cmd = [sys.executable, SERVE_MAIN, "--context", "gpu(0)",
           "--model", "resnet=%s" % res_dir,
           "--model", "mlp=%s:%d" % (mlp_prefix, mlp_epoch),
           "--model", "lm=%s" % lm_dir,
           "--input-shape", "resnet:data=%s" % ",".join(map(str, IMAGE)),
           "--input-shape", "mlp:data=%s" % ",".join(map(str, mlp_sample)),
           "--buckets", ",".join(map(str, SV_BUCKETS)), "--max-wait-ms", "2",
           "--seq-buckets", ",".join(map(str, SV_SEQ_BUCKETS)),
           "--warmup", "--watch", "--port", "0", "--port-file", port_file]
    # the first promotion's probe passes, the second's fails: a rollback
    env = _sv_env(MXTPU_FAULTS="swap_probe:1@1")
    out = {}
    t0 = time.perf_counter()
    with open(log_path, "w") as f:
        proc = subprocess.Popen(cmd, env=env, stdout=f,
                                stderr=subprocess.STDOUT,
                                start_new_session=True)
    try:
        port = _sv_wait_port(port_file, proc, log_path)
        out["ready_s"] = time.perf_counter() - t0
        cli = mx.serving.ServeClient("127.0.0.1", port, timeout=60)
        batches = collections.Counter()

        def count(model, fn):
            before = _sv_stats(cli)["batches"]["count"]
            result = fn()
            batches[model] += _sv_stats(cli)["batches"]["count"] - before
            return result

        # a quiet request of each image model equals Predictor at bucket 1
        parity = count("parity", lambda: bench._serve_parity(port, {
            "resnet": (os.path.join(res_dir, "checkpoint"), 1, IMAGE),
            "mlp": specs["mlp"]}))
        check(parity, "a quiet daemon request differs from the unbatched "
              "Predictor")
        check(batches.pop("parity") == 2, "the parity requests did not "
              "take one batch each")
        batches["resnet"] += 1
        batches["mlp"] += 1
        # closed loop: ResNet-50 with x-npy bodies, the MLP with JSON
        load = {}
        for model, sample, npy in (("resnet", IMAGE, True),
                                   ("mlp", mlp_sample, False)):
            for conc in SV_CONCURRENCY:
                load[model, conc] = count(model, lambda: bench._serve_load(
                    port, model, sample, conc, SV_LOAD_S, npy=npy))
                qps, p50, p99, shed, errors = load[model, conc]
                check(errors == 0 and qps > 0, "%s at concurrency %d: %s"
                      % (model, conc, load[model, conc]))
        out["load"] = load
        # the LM at three length buckets against Predictor at each shape
        rs = np.random.RandomState(seed + 81)
        seq_ok = []
        for length, bucket in zip(SV_SEQ_LENS, SV_SEQ_BUCKETS):
            toks = rs.randint(0, LM_VOCAB, length)
            status, payload = count("lm", lambda: cli.predict_seq("lm", toks))
            check(status == 200 and payload["bucket"] == bucket,
                  "predict_seq %d: %s %s" % (length, status,
                                             str(payload)[:300]))
            padded = np.concatenate([toks, np.repeat(toks[-1:],
                                                     bucket - length)])
            shape = (1, bucket)
            pred = mx.predict.Predictor(
                lm_sym, _with_prefixes(lm_args, {}),
                {"data": shape, "softmax_label": shape}, ctx=mx.gpu(0))
            ref = pred.forward(data=padded[None].astype(np.float32),
                               softmax_label=np.zeros(shape, np.float32)
                               ).get_output(0)[:length]
            seq_ok.append(np.array_equal(
                np.asarray(payload["outputs"][0], np.float32), ref))
        check(all(seq_ok), "predict_seq answers against Predictor: %s"
              % seq_ok)
        check(batches["lm"] == len(SV_SEQ_LENS), "the LM took %d batches"
              % batches["lm"])

        # -- hot swap under traffic: epoch 2 published ---------------------
        xq = np.random.RandomState(seed + 82).standard_normal(
            IMAGE).astype(np.float32)
        stop, rows = threading.Event(), []
        before = _sv_stats(cli)["batches"]["count"]
        threads = _sv_traffic(mx, port, "resnet", xq, SV_SWAP_CLIENTS, stop,
                              rows)
        try:
            time.sleep(0.5)
            t_pub = time.perf_counter()
            args2, aux2 = _sv_save_resnet(mx, symbol, seed + 1, res_dir, 2)
            _sv_wait("epoch 2 to serve", lambda: cli.healthz()[1]
                     ["epochs"]["resnet"] == 2)
            out["publish_to_served_s"] = time.perf_counter() - t_pub
            time.sleep(0.5)
        finally:
            stop.set()
            for t in threads:
                t.join(60)
        batches["resnet"] += _sv_stats(cli)["batches"]["count"] - before
        statuses = collections.Counter(r[1] for r in rows)
        check(set(statuses) == {200}, "answers during the swap: %s"
              % dict(statuses))
        deploy = _sv_stats(cli)["deploy"]["resnet"]
        out["swap_ms"] = deploy["last_swap_ms"]
        out["swap_requests"] = len(rows)
        out["swap_max_ms"] = max(r[2] for r in rows)
        pred = mx.predict.Predictor(symbol, _with_prefixes(args2, aux2),
                                    {"data": (1,) + IMAGE}, ctx=mx.gpu(0))
        fresh = pred.forward(data=xq[None]).get_output(0)[0]
        del pred
        served = count("resnet", lambda: _sv_predict(mx, port, "resnet",
                                                     xq))
        check(np.array_equal(served, fresh), "after the swap the daemon "
              "differs from a fresh Predictor on epoch 2")
        # -- epoch 3: its probe fails (swap_probe), the rollback -------------
        _sv_save_resnet(mx, symbol, seed + 2, res_dir, 3)
        _sv_wait("the rollback", lambda: _sv_stats(cli)["deploy"]["resnet"]
                 ["rolled_back"] == 1)
        deploy = _sv_stats(cli)["deploy"]["resnet"]
        check(deploy["promoted"] == 1 and deploy["epoch"] == 2,
              "after the rollback: %s" % deploy)
        again = count("resnet", lambda: _sv_predict(mx, port, "resnet", xq))
        check(np.array_equal(again, served), "the rollback is not bit-exact")
        staged = deploy["promoted"] + deploy["rolled_back"]

        # -- SIGTERM with requests in flight --------------------------------
        stats = _sv_stats(cli)
        accepted = stats["counters"]["accepted"]
        last = stats["batches"]["count"]
        results = []
        drain = [threading.Thread(target=lambda i=i: results.append(
            _sv_predict(mx, port, "resnet", xq + i)))
            for i in range(SV_DRAIN_CLIENTS)]
        for t in drain:
            t.start()
        _sv_wait("the drain requests", lambda: _sv_stats(cli)["counters"]
                 ["accepted"] >= accepted + SV_DRAIN_CLIENTS)
        cli.close()
        t_term = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        for t in drain:
            t.join(60)
        rc = proc.wait(timeout=SV_WAIT_S)
        out["drain_s"] = time.perf_counter() - t_term
    finally:
        _sv_stop(proc)
    with open(log_path) as f:
        text = f.read()
    if rc != 0:
        log(text[-4000:])
    check(rc == 0, "the daemon exited %d after SIGTERM" % rc)
    check(len(results) == SV_DRAIN_CLIENTS, "%d of %d in-flight requests "
          "answered" % (len(results), SV_DRAIN_CLIENTS))
    counts = _sv_line(text, "launches")
    final = _sv_line(text, "stats")["batches"]
    batches["resnet"] += final - last
    log("serving daemon: batches by model %s, daemon's %d; deploy %s; "
        "watcher lines: %s" % (dict(batches), final, json.dumps(deploy),
                               [ln for ln in text.splitlines()
                                if "CheckpointWatcher" in ln][:8]))
    check(sum(batches.values()) == final, "batches by model %s against "
          "the daemon's %d" % (dict(batches), final))
    resnet_fwd = len(SV_BUCKETS) + batches["resnet"] + staged \
        + deploy["promoted"]
    check(counts["bn_act_fwd"] == 17 * resnet_fwd, "daemon: %d bn_act "
          "launches, expected 17 x %d ResNet-50 forwards (%d warmup, %d "
          "batches, %d staged validations, %d probes)" % (
              counts["bn_act_fwd"], resnet_fwd, len(SV_BUCKETS),
              batches["resnet"], staged, deploy["promoted"]))
    check(counts["lstm_seq_fwd"] == LM_LAYERS * batches["lm"],
          "daemon: %d lstm_seq launches in %d LM batches"
          % (counts["lstm_seq_fwd"], batches["lm"]))
    check(counts["bn_act_bwd"] == counts["lstm_seq_bwd"] == 0,
          "daemon ran a backward: %s" % counts)
    out.update(counts=counts, batches=dict(batches))
    cold = re.findall(r"mxserve: warmup_s=([0-9.]+)", text)
    if cold:
        _SV_COLD.update(warmup_s=float(cold[0]), what="resnet-50, mlp and "
                        "lm over buckets %s, no store" % (list(SV_BUCKETS),))
    log("serving daemon: ready in %.1f s (resnet-50 directory, mlp, lm; "
        "warmup over %s: %s s); a quiet request of each image model equals "
        "the unbatched Predictor bit for bit" % (
            out["ready_s"], list(SV_BUCKETS), cold))
    for (model, conc), (qps, p50, p99, shed, errors) in sorted(load.items()):
        log("serving daemon load: %s (%s bodies) concurrency %d: %.2f QPS, "
            "p50 %s ms, p99 %s ms, shed %d, errors %d, on %s" % (
                model, "x-npy" if model == "resnet" else "JSON", conc, qps,
                p50, p99, shed, errors, card))
    for model in ("resnet", "mlp"):
        c1, c32 = load[model, 1][0], load[model, 32][0]
        log("serving daemon load: %s c32 / c1 = %.2f" % (model, c32 / c1))
    log("serving daemon: /predict_seq at length buckets %s equals Predictor "
        "at each bucket shape bit for bit" % (list(SV_SEQ_BUCKETS),))
    log("serving hot swap: epoch 2 published under %d clients, served %.2f "
        "s after the publish began; %d requests, all 200, slowest %.1f ms; "
        "the swap's stall at the dispatch boundary %s ms; equals a fresh "
        "Predictor bit for bit; epoch 3's probe failed and rolled back bit "
        "for bit, on %s" % (SV_SWAP_CLIENTS, out["publish_to_served_s"],
                            out["swap_requests"], out["swap_max_ms"],
                            out["swap_ms"], card))
    log("serving daemon: SIGTERM with %d requests in flight: all 200, exit "
        "0 in %.2f s; launches %s over %s batches by model (%d a forward "
        "on the ResNet-50, %d a batch on the LM)" % (
            SV_DRAIN_CLIENTS, out["drain_s"], json.dumps(counts),
            dict(batches), 17, LM_LAYERS))
    return counts, out


def start_sv_drill(tmp, res_dir):
    """Start the watchdog drill's daemon under ``tools/supervise.py
    --max-restarts 1`` with ``hang_serve_forward`` armed, on a copy of
    the ResNet-50 directory.  Its start-up (imports, the card's first
    forward) overlaps the main daemon's; it then waits for its request.
    Returns the supervisor and its paths."""
    drill_dir = os.path.join(tmp, "drill-resnet")
    shutil.copytree(res_dir, drill_dir)
    child = os.path.join(tmp, "serve_child.py")
    with open(child, "w") as f:
        f.write(SV_CHILD % {"main": SERVE_MAIN})
    paths = {"port": os.path.join(tmp, "drill.port"),
             "log": os.path.join(tmp, "drill.log"),
             "debug": os.path.join(tmp, "debug")}
    env = _sv_env(MXTPU_FAULTS="hang_serve_forward:1",
                  MXTPU_STEP_TIMEOUT=str(SV_STEP_TIMEOUT),
                  MXTPU_DEBUG_DIR=paths["debug"])
    cmd = [sys.executable, os.path.join(ROOT, "tools", "supervise.py"),
           "--max-restarts", "1", "--backoff", "0", "--", sys.executable,
           child, "--context", "gpu(0)", "--model", "resnet=%s" % drill_dir,
           "--input-shape", "data=%s" % ",".join(map(str, IMAGE)),
           "--buckets", "1,2", "--max-wait-ms", "2", "--warmup", "--port",
           "0", "--port-file", paths["port"]]
    with open(paths["log"], "w") as f:
        sup = subprocess.Popen(cmd, env=env, stdout=f,
                               stderr=subprocess.STDOUT,
                               start_new_session=True)
    return sup, paths


def phase_sv_watchdog(torch, mx, seed, card, sup, paths):
    """The drill (``start_sv_drill``): the first batch hangs, the
    watchdog exits 87 with a report, the relaunch answers 200, a SIGTERM
    to the supervisor gives 0.  Returns the relaunch's bn_act launches
    and the numbers."""
    import numpy as np
    port_file, log_path, debug = paths["port"], paths["log"], paths["debug"]
    x = np.random.RandomState(seed + 90).standard_normal(IMAGE).astype(
        np.float32)
    rc = None
    try:
        first = _sv_wait_port(port_file, sup, log_path)
        t_hang = time.perf_counter()
        status, port = None, first
        deadline = time.monotonic() + SV_WAIT_S
        while status != 200:
            check(time.monotonic() < deadline, "no 200 after the relaunch")
            check(sup.poll() is None, "the supervisor exited %s"
                  % sup.returncode)
            try:
                with open(port_file) as f:
                    port = int(f.read().split(":")[1])
                cli = mx.serving.ServeClient("127.0.0.1", port,
                                             timeout=SV_STEP_TIMEOUT + 20)
                status, payload = cli.predict("resnet", x, npy=True)
                cli.close()
            except Exception:  # noqa: BLE001 — hung, dead or relaunching
                status = None
                time.sleep(0.2)
        restart_s = time.perf_counter() - t_hang
        check(port != first, "the 200 came from the hung daemon's port")
        cli = mx.serving.ServeClient("127.0.0.1", port, timeout=60)
        batches = _sv_stats(cli)["batches"]["count"]
        cli.close()
        sup.send_signal(signal.SIGTERM)
        rc = sup.wait(timeout=SV_WAIT_S)
    finally:
        _sv_stop(sup)
        with open(log_path) as f:
            text = f.read()
        if rc != 0:
            log(text[-6000:])
    check(rc == 0, "the supervisor exited %d after SIGTERM" % rc)
    check("watchdog abort (hung step)" in text and "exceeded its %.1fs "
          "budget" % SV_STEP_TIMEOUT in text, "no watchdog report (87)")
    dumps = os.listdir(debug) if os.path.isdir(debug) else []
    check(len(dumps) == 1, "watchdog dumps: %s" % dumps)
    size = os.path.getsize(os.path.join(debug, dumps[0]))
    counts = _sv_line(text, "launches")
    warm = re.findall(r"mxserve: warmup_s=([0-9.]+)", text)
    check(len(warm) == 2, "warmups in the drill: %s" % warm)
    check(counts["bn_act_fwd"] == 17 * (2 + batches), "relaunch: %d bn_act "
          "launches in 2 warmup forwards and %d batches"
          % (counts["bn_act_fwd"], batches))
    log("serving watchdog drill: the hung forward -> watchdog %d s -> exit "
        "87 with a %d-byte report -> supervise.py relaunch (warmup %s s) -> "
        "200 after %.2f s from the hung request; SIGTERM to the supervisor "
        "-> 0; relaunch bn_act %d in 2 warmup forwards and %d batches, on "
        "%s" % (SV_STEP_TIMEOUT, size, warm[1], restart_s,
                counts["bn_act_fwd"], batches, card))
    return counts["bn_act_fwd"], {"restart_s": restart_s}


#: the portable archive, called by a process that imports only torch
#: and numpy (``mxnet_tpu_torch`` and JAX made unimportable), on the card
#: and on the host, float32 without TF32 as the port computes it:
#: ``child.py <archive> <inputs.npy> <out prefix>``
SV_PORTABLE_CHILD = r"""
import sys, time
for name in ("mxnet_tpu_torch", "mxnet_tpu", "jax"):
    sys.modules[name] = None
import numpy as np, torch
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
x = torch.from_numpy(np.load(sys.argv[2]))
for dev in ("cuda:0", "cpu"):
    t0 = time.perf_counter()
    m = torch.export.load(sys.argv[1]).module().to(dev)
    with torch.no_grad():
        y = m(x.to(dev))[0]
    np.save("%s-%s.npy" % (sys.argv[3], dev.split(":")[0]), y.cpu().numpy())
    print("PORTABLE %s %.3f" % (dev, time.perf_counter() - t0), flush=True)
"""


#: ``predict.export_compiled`` of the serving checkpoint's ResNet-50 at
#: batch 32, traced on the host: ``export.py <ckpt dir> <archive>``
SV_PORTABLE_EXPORT = r"""
import sys, time
sys.path.insert(0, %(root)r)
import mxnet_tpu_torch as mx
symbol, args, aux, _states, _epoch = mx.resilience.CheckpointManager(
    sys.argv[1]).restore()
t0 = time.perf_counter()
mx.predict.export_compiled(symbol, args, aux, {"data": %(shape)r},
                           fname=sys.argv[2])
print("EXPORT %%.3f" %% (time.perf_counter() - t0), flush=True)
"""


def start_sv_portable(seed, tmp, res_dir):
    """In the background, beside the pool and the daemon: a process
    exports the serving checkpoint with ``export_compiled``, then the
    torch-only child runs the archive.  Returns what
    :func:`phase_sv_portable` reads."""
    import threading
    import numpy as np
    job = {"path": os.path.join(tmp, "resnet50-b%d.pt2" % BATCH),
           "x": np.random.RandomState(seed + 95).standard_normal(
               (BATCH,) + IMAGE).astype(np.float32),
           "log": os.path.join(tmp, "portable.log"), "procs": [],
           "rcs": []}
    np.save(os.path.join(tmp, "portable-x.npy"), job["x"])
    scripts = {}
    for name, text in (("export", SV_PORTABLE_EXPORT % {
            "root": ROOT, "shape": (BATCH,) + IMAGE}),
            ("child", SV_PORTABLE_CHILD)):
        scripts[name] = os.path.join(tmp, "portable_%s.py" % name)
        with open(scripts[name], "w") as f:
            f.write(text)
    cmds = [[sys.executable, scripts["export"], res_dir, job["path"]],
            [sys.executable, scripts["child"], job["path"],
             os.path.join(tmp, "portable-x.npy"),
             os.path.join(tmp, "portable-y")]]

    def work():
        with open(job["log"], "w") as f:
            for cmd in cmds:
                proc = subprocess.Popen(cmd, cwd=tmp, env=_sv_env(), stdout=f,
                                        stderr=subprocess.STDOUT,
                                        start_new_session=True)
                job["procs"].append(proc)
                job["rcs"].append(proc.wait())
                if job["rcs"][-1] != 0:
                    return

    job["t0"] = time.perf_counter()
    job["thread"] = threading.Thread(target=work, name="sv-portable")
    job["thread"].start()
    return job


def phase_sv_portable(torch, mx, seed, card, tmp, symbol, args, aux, job):
    """The portable archive against the smoke's ``Predictor`` on the card:
    loaded here by ``load_compiled`` on ``cuda:0``, and by the torch-only
    child on ``cuda:0`` and on the host, each within 1e-3 x max."""
    import numpy as np
    ba = mx.kernels.bn_act
    x = job["x"]
    job["thread"].join(SV_WAIT_S)
    child_s = time.perf_counter() - job["t0"]
    with open(job["log"]) as f:
        text = f.read()
    if job["rcs"] != [0, 0]:
        log(text[-4000:])
    check(job["rcs"] == [0, 0], "the portable export and its torch-only "
          "child exited %s" % job["rcs"])
    pred = mx.predict.Predictor(symbol, _with_prefixes(args, aux),
                                {"data": x.shape}, ctx=mx.gpu(0))
    ref = pred.forward(data=x).get_output(0)
    del pred
    bound = 1e-3 * float(np.abs(ref).max())
    t0 = time.perf_counter()
    fn = mx.predict.load_compiled(job["path"])
    before = ba.LAUNCHES
    y = fn(torch.from_numpy(x).to("cuda:0"))[0]
    torch.cuda.synchronize()
    here_s = time.perf_counter() - t0
    check(y.is_cuda and ba.LAUNCHES == before, "the portable program ran "
          "on %s with %d bn_act launches (its graph holds aten ops only)"
          % (y.device, ba.LAUNCHES - before))
    diffs = {"load_compiled cuda:0": float(np.abs(y.cpu().numpy()
                                                  - ref).max())}
    del fn, y
    gc.collect()
    torch.cuda.empty_cache()
    for dev in ("cuda", "cpu"):
        got = np.load(os.path.join(tmp, "portable-y-%s.npy" % dev))
        check(got.shape == ref.shape, "child %s output %s" % (dev, got.shape))
        diffs["child " + dev] = float(np.abs(got - ref).max())
    check(all(d <= bound for d in diffs.values()), "the portable archive "
          "against the card's Predictor: max |diff| %s, bound %.3g"
          % (diffs, bound))
    log("serving portable: export_compiled of resnet-50 at batch %d (traced "
        "on the host, a process of its own) %s s, %d bytes; load_compiled "
        "+ a forward on cuda:0 %.2f s; the torch-only child "
        "(mxnet_tpu_torch unimportable) %s; both processes %.1f s in all "
        "beside the pool and the daemon; max |diff| against the card's "
        "Predictor %s (bound 1e-3 x %.3g); on %s" % (
            BATCH, " ".join(ln.split()[1] for ln in text.splitlines()
                            if ln.startswith("EXPORT")),
            os.path.getsize(job["path"]), here_s,
            " ".join(ln for ln in text.splitlines()
                     if ln.startswith("PORTABLE")), child_s,
            json.dumps(diffs), bound / 1e-3, card))


def serving_paths(torch, mx, seed, card):
    """The serving slice on the card: the pool in process, the portable
    archive, then the daemon (load, sequences, hot swap, drain) and the
    watchdog drill as child processes.  Returns the serving launches of
    rows 1 and 3."""
    build_dir = os.path.join(ROOT, "mxnet_tpu_torch", "_build")
    os.makedirs(build_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="serving-", dir=build_dir)
    sup = portable = None
    try:
        bench = load_example("bench.py", "port_bench")
        with mx.name.NameManager():
            symbol = mx.models.get_symbol("resnet-50", num_classes=1000,
                                          image_shape=IMAGE)
        res_dir = os.path.join(tmp, "resnet")
        args, aux = _sv_save_resnet(mx, symbol, seed, res_dir, 1)
        portable = start_sv_portable(seed, tmp, res_dir)
        pool_fwd, _ = phase_sv_pool(torch, mx, seed, card, res_dir, symbol)
        gc.collect()
        torch.cuda.empty_cache()
        sup, paths = start_sv_drill(tmp, res_dir)
        counts, _ = phase_sv_daemon(torch, mx, seed, card, tmp, res_dir,
                                    symbol, bench)
        drill_fwd, _ = phase_sv_watchdog(torch, mx, seed, card, sup, paths)
        phase_sv_portable(torch, mx, seed, card, tmp, symbol, args, aux,
                          portable)
    finally:
        if sup is not None:
            _sv_stop(sup)
        if portable is not None:
            for proc in portable["procs"]:
                _sv_stop(proc)
            portable["thread"].join(SV_WAIT_S)
        shutil.rmtree(tmp, ignore_errors=True)
    return collections.Counter({
        "bn_act_fwd": pool_fwd + counts["bn_act_fwd"] + drill_fwd,
        "lstm_seq_fwd": counts["lstm_seq_fwd"]})


# -- the fleet: two replica daemons co-tenant on the card --------------------

FL_DEVICE_SETS = "cuda:0"    # both replicas co-tenant on card 0
FL_BUCKETS = (1, 8, 32)
FL_C1_S = 1.0           # closed-loop seconds at concurrency 1
FL_C32_S = 1.5          # and at concurrency 32
FL_KILL_CLIENTS = 8     # clients through the SIGKILL drill
FL_SWAP_CLIENTS = 4     # clients through the rolling swap
FL_BURSTS = 4           # most burst rounds to see buckets 8 and 32 served
FL_ROUTER_BOUND = 0.8   # router CPU s per s past which --workers 2 runs too
FL_IDLE_S = 1.0         # an idle window: what the front end costs unloaded
FL_ENV = {"MXTPU_FLEET_HEARTBEAT_S": "0.3", "MXTPU_FLEET_EVICT_S": "1.2",
          "MXTPU_FLEET_SPILL_QUEUE": "4", "MXTPU_SERVE_MAX_WAIT_MS": "2",
          "MXTPU_SERVE_SEQ_BUCKETS": str(LM_SEQ)}
FLEET_MAIN = os.path.join(ROOT, "mxnet_tpu_torch", "fleet", "fleet_main.py")


#: the fleet's models; each replica run warms every one from the store
FL_MODELS = ("resnet", "mlp", "lm")
#: the /predict_seq request each replica answers (length bucket LM_SEQ)
FL_SEQ_LEN = 29


def _fl_lm_dir(tmp):
    """The full-width LM's checkpoint directory in the fleet's tmp."""
    return os.path.join(tmp, "lm")


def _fl_model_flags(res_dir, mlp, lm_dir):
    """The manifest's flags: ResNet-50 (a checkpoint directory), the MLP
    and the full-width LM (a checkpoint directory; its tokens and its
    label both declared, so its programs enter the store) on card 0 at
    ``FL_BUCKETS``."""
    prefix, epoch, sample = mlp
    return ["--device-sets", FL_DEVICE_SETS,
            "--buckets", ",".join(map(str, FL_BUCKETS)),
            "--model", "resnet=%s" % res_dir,
            "--model", "mlp=%s:%d" % (prefix, epoch),
            "--model", "lm=%s" % lm_dir,
            "--input-shape", "resnet:data=%s" % ",".join(map(str, IMAGE)),
            "--input-shape", "mlp:data=%s" % ",".join(map(str, sample)),
            "--input-shape", "lm:data=%d" % LM_SEQ,
            "--input-shape", "lm:softmax_label=%d" % LM_SEQ]


def _fl_start(tmp, name, res_dir, mlp, workers=1, watch=True,
              warm_store=None, wait=True, **env):
    """``fleet_main.py serve`` with two replicas on card 0 serving the
    ResNet-50 directory and the MLP, warmed from ``warm_store`` when
    given; returns (process, public port, seconds from spawn to the port
    file, run directory, log path), or with ``wait=False`` what
    :func:`_fl_wait` takes."""
    run_dir = os.path.join(tmp, name)
    port_file = os.path.join(tmp, name + ".port")
    log_path = os.path.join(tmp, name + ".log")
    cmd = [sys.executable, FLEET_MAIN, "serve", "--replicas", "2"] + \
        _fl_model_flags(res_dir, mlp, _fl_lm_dir(tmp)) + [
            "--workers", str(workers), "--run-dir", run_dir, "--port", "0",
            "--port-file", port_file]
    if watch:
        cmd.append("--watch")
    if warm_store:
        cmd += ["--warm-store", warm_store]
    t0 = time.perf_counter()
    with open(log_path, "w") as f:
        proc = subprocess.Popen(cmd, env=_sv_env(**dict(FL_ENV, **env)),
                                stdout=f, stderr=subprocess.STDOUT,
                                start_new_session=True)
    spawned = (proc, t0, run_dir, log_path, port_file)
    return _fl_wait(spawned) if wait else spawned


def _fl_wait(spawned):
    """Wait for a fleet started by :func:`_fl_spawn` (or inside
    :func:`_fl_start`) to write its port file: the returns of
    :func:`_fl_start`."""
    proc, t0, run_dir, log_path, port_file = spawned
    try:
        port = _sv_wait_port(port_file, proc, log_path)
    except SmokeFailure:
        for r in (0, 1):
            path = os.path.join(run_dir, "replica-%d.log" % r)
            if os.path.exists(path):
                with open(path) as f:
                    log("replica %d: %s" % (r, f.read()[-3000:]))
        _fl_stop(proc)
        raise
    return proc, port, time.perf_counter() - t0, run_dir, log_path


def _fl_replica_port(run_dir, rid):
    with open(os.path.join(run_dir, "replica-%d.port" % rid)) as f:
        return int(f.read().split(":")[1])


def _fl_get(mx, port):
    """``/stats`` of the router or replica on ``port``."""
    cli = mx.serving.ServeClient("127.0.0.1", port, timeout=60)
    try:
        status, payload = cli.stats()
    finally:
        cli.close()
    check(status == 200, "/stats on port %d answered %s" % (port, status))
    return payload


def _fl_batches(mx, run_dir):
    """Each replica's batch count, from its own ``/stats``."""
    return [_fl_get(mx, _fl_replica_port(run_dir, r))["batches"]["count"]
            for r in (0, 1)]


def _fl_cpu_s(pids):
    """CPU seconds (user + system) the processes have used so far."""
    tick = os.sysconf("SC_CLK_TCK")
    total = 0
    for pid in pids:
        with open("/proc/%d/stat" % pid) as f:
            fields = f.read().rsplit(")", 1)[1].split()
        total += int(fields[11]) + int(fields[12])
    return total / tick


def _fl_router_pids(mx, proc, port):
    """The front end's processes: the fleet process (router or prober)
    and, sharded, its router workers."""
    workers = _fl_get(mx, port).get("workers") or {}
    return [proc.pid] + sorted(int(w["pid"]) for w in workers.values()
                               if w.get("pid") and int(w["pid"]) != proc.pid)


def _fl_card_mib():
    """The card's used memory in MiB (``nvidia-smi
    --query-gpu=memory.used``): every process on it together."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=memory.used",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=30)
    check(res.returncode == 0, "nvidia-smi: %s" % res.stderr)
    return int(res.stdout.split()[0])


def _fl_apps():
    """``nvidia-smi --query-compute-apps`` as it prints (pid, name and
    memory of each process on the card, where the machine shows them),
    and the MPS daemons running (none expected: the replicas time-slice
    the card)."""
    res = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,"
                          "process_name,used_memory", "--format=csv"],
                         capture_output=True, text=True, timeout=30)
    mps = []
    for entry in os.listdir("/proc"):
        if entry.isdigit():
            try:
                with open("/proc/%s/comm" % entry) as f:
                    comm = f.read().strip()
            except OSError:
                continue
            if comm.startswith("nvidia-cuda-mps"):
                mps.append(comm)
    return res.stdout.strip().splitlines(), mps


def _fl_serving(mx, port):
    """Whether the replica on ``port`` answers ``/healthz`` ok (not
    draining, not gone)."""
    cli = mx.serving.ServeClient("127.0.0.1", port, timeout=0.5)
    try:
        status, payload = cli.healthz()
        return status == 200 and payload.get("status") == "ok"
    except Exception:  # noqa: BLE001 — refused or torn down: not serving
        return False
    finally:
        cli.close()


def _fl_alive(pid):
    """Whether ``pid`` runs (a zombie awaiting its parent's reap does
    not)."""
    try:
        with open("/proc/%d/stat" % pid) as f:
            return f.read().rsplit(")", 1)[1].split()[0] not in "ZX"
    except OSError:
        return False


def _fl_load(mx, bench, port, conc, seconds, groups, run_dir):
    """``bench._serve_load`` of ResNet-50 x-npy at ``conc``; returns its
    (qps, p50, p99, shed, errors) and the CPU seconds of each group of
    processes (``{name: pids}``: the front end, the load's own process,
    the replicas) over the call, with the call's wall time and each
    replica's batches."""
    c0 = {k: _fl_cpu_s(p) for k, p in groups.items()}
    b0 = _fl_batches(mx, run_dir)
    t0 = time.perf_counter()
    load = bench._serve_load(port, "resnet", IMAGE, conc, seconds, npy=True)
    cpu = {k: round(_fl_cpu_s(p) - c0[k], 2) for k, p in groups.items()}
    cpu["wall"] = round(time.perf_counter() - t0, 2)
    cpu["batches"] = [a - b for a, b in zip(_fl_batches(mx, run_dir), b0)]
    qps, p50, p99, shed, errors = load
    check(errors == 0 and qps > 0, "resnet at concurrency %d on port %d: "
          "%s" % (conc, port, load))
    return load, cpu


def _fl_traffic(mx, port, x, clients, stop, rows):
    """``clients`` threads sending ``x`` (ResNet-50, x-npy) until ``stop``;
    each answer's (time, status, retried, error) goes to ``rows``: status
    -1 is a request that raised in the client, ``error`` its repr and how
    long it had run."""
    import threading

    def worker():
        cli = mx.serving.ServeClient("127.0.0.1", port, timeout=60)
        try:
            while not stop.is_set():
                t0 = time.perf_counter()
                err = None
                try:
                    status, payload = cli.predict("resnet", x, npy=True)
                    retried = payload.get("retried") is True
                except Exception as e:  # noqa: BLE001 — a dropped connection
                    status, retried = -1, False
                    err = "%r after %.3f s" % (e, time.perf_counter() - t0)
                rows.append((t0, status, retried, err))
        finally:
            cli.close()

    threads = [threading.Thread(target=worker) for _ in range(clients)]
    for t in threads:
        t.start()
    return threads


def _fl_refs(torch, mx, symbol, args, aux, x, buckets=FL_BUCKETS):
    """The smoke's own ``Predictor`` answer for ``x`` at each bucket
    shape (``x`` in every row), on gpu(0)."""
    import numpy as np
    refs = {}
    for b in buckets:
        pred = mx.predict.Predictor(symbol, _with_prefixes(args, aux),
                                    {"data": (b,) + IMAGE}, ctx=mx.gpu(0))
        refs[b] = pred.forward(data=np.repeat(x[None], b, axis=0)
                               ).get_output(0)[0]
        del pred
    gc.collect()
    torch.cuda.empty_cache()
    return refs


def _fl_buckets_of(np, answer, refs):
    return {b for b, ref in refs.items() if np.array_equal(answer, ref)}


def _fl_bursts(mx, port, x, refs):
    """Bursts of 8 and 32 concurrent requests of ``x`` straight to one
    replica until buckets 8 and 32 have both answered (each answer must
    equal the reference of the bucket that served it).  Returns the
    buckets seen and the requests sent."""
    import threading
    import numpy as np
    seen, sent = set(), 0
    for _ in range(FL_BURSTS):
        for n in (8, 32):
            # connect first (one keep-alive connection a client, opened
            # in turn), then fire the n requests together
            clients = [mx.serving.ServeClient("127.0.0.1", port, timeout=60)
                       for _ in range(n)]
            for cli in clients:
                check(cli.healthz()[0] == 200, "replica on %d" % port)
            answers, go = [], threading.Barrier(n)

            def one(cli):
                go.wait(60)
                status, payload = cli.predict("resnet", x, npy=True)
                check(status == 200, "burst answer %s" % status)
                answers.append(np.asarray(payload["outputs"][0],
                                          dtype=np.float32))

            threads = [threading.Thread(target=one, args=(c,))
                       for c in clients]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60)
            for cli in clients:
                cli.close()
            check(len(answers) == n, "%d of %d burst answers" % (
                len(answers), n))
            sent += n
            for a in answers:
                matched = _fl_buckets_of(np, a, refs)
                check(matched, "a burst answer on port %d equals no bucket's "
                      "Predictor answer (max |diff| to bucket 1: %.3g)"
                      % (port, float(np.abs(a - refs[1]).max())))
                seen |= matched
        if {8, 32} <= seen:
            break
    check({8, 32} <= seen, "bursts on port %d served buckets %s only"
          % (port, sorted(seen)))
    return seen, sent


def _fl_launch_check(text, extra_batches, swaps, what, lm_batches=0):
    """The drained replica's launch line against its forwards through the
    loaded programs.  ResNet-50: the warmup's (one validation call of the
    smallest bucket's program) + its batches (less ``extra_batches`` of
    the MLP and the LM) + a staged validation and a probe per swap, 17
    ``bn_act`` each.  The LM: its validation call + ``lm_batches``, 2
    persistent ``lstm_seq`` each.  Returns the bn_act launches, the
    ResNet-50 batches and the lstm_seq launches."""
    counts = _sv_line(text, "launches")
    batches = _sv_line(text, "stats")["batches"] - extra_batches - lm_batches
    fwd = 1 + batches + 2 * swaps
    check(counts["bn_act_fwd"] == 17 * fwd, "%s: %d bn_act launches, "
          "expected 17 x %d ResNet-50 forwards (1 validation of the loaded "
          "programs, %d batches, %d swaps)" % (
              what, counts["bn_act_fwd"], fwd, batches, swaps))
    seq = LM_LAYERS * (1 + lm_batches)
    check(counts["lstm_seq_fwd"] == seq, "%s: %d lstm_seq launches, "
          "expected %d (%d a forward of the LM's loaded programs: 1 "
          "validation, %d batches)" % (what, counts["lstm_seq_fwd"], seq,
                                       LM_LAYERS, lm_batches))
    check(counts["bn_act_bwd"] == counts["lstm_seq_bwd"] == 0,
          "%s ran a backward: %s" % (what, counts))
    return counts["bn_act_fwd"], batches, counts["lstm_seq_fwd"]


def _fl_stop(proc):
    if proc is not None and proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


def _fl_start_build(tmp, res_dir, mlp):
    """``fleet_main.py warmup``: the warm store's builder (one daemon run
    exporting every (model, bucket) program under replica 0's device
    env), started in the background; returns (process, store, start
    time in the host's Unix seconds, stdout path, log path)."""
    store = os.path.join(tmp, "store")
    out_path = os.path.join(tmp, "warm-build.json")
    log_path = os.path.join(tmp, "warm-build.log")
    cmd = [sys.executable, FLEET_MAIN, "warmup"] + \
        _fl_model_flags(res_dir, mlp, _fl_lm_dir(tmp)) + ["--warm-store",
                                                           store]
    t0 = time.time()
    with open(out_path, "w") as out_f, open(log_path, "w") as log_f:
        proc = subprocess.Popen(cmd, env=_sv_env(), stdout=out_f,
                                stderr=log_f, start_new_session=True)
    return proc, store, t0, out_path, log_path


def _fl_finish_build(build, param_bytes):
    """Wait for the builder; check its store (a weight-free ``.exec`` a
    (model, bucket), each under a tenth of its model's parameter bytes)
    and return the numbers."""
    proc, store, t0, out_path, log_path = build
    try:
        rc = proc.wait(timeout=SV_WAIT_S)
    finally:
        _fl_stop(proc)
    with open(log_path) as f:
        text = f.read()
    if rc != 0:
        log(text[-4000:])
    check(rc == 0, "fleet_main.py warmup exited %s" % rc)
    with open(out_path) as f:
        marker = json.load(f)
    aot_dir = os.path.join(store, "aot")
    sizes = {}
    for model, nbytes in sorted(param_bytes.items()):
        sizes[model] = {}
        for b in FL_BUCKETS:
            path = os.path.join(aot_dir, "%s-b%d.exec" % (model, b))
            check(os.path.exists(path), "the warm store lacks %s" % path)
            sizes[model][b] = os.path.getsize(path)
            check(sizes[model][b] < 0.1 * nbytes, "%s: %d bytes, not under "
                  "a tenth of the model's %d parameter bytes" % (
                      path, sizes[model][b], nbytes))
    # the builder's wall time: from its spawn to its marker's write
    return {"store": store, "builder_s": marker["built_unix"] - t0,
            "builder_warmup_s": marker["warmup_s"], "exec_bytes": sizes,
            "param_bytes": param_bytes}


def _fl_param_bytes(mx, params):
    return sum(int(v._data.numel()) * v._data.element_size()
               for d in params for v in d.values())


def _fl_warm_check(text, runs, what):
    """A replica log's daemon runs each warmed every model from the
    store, every bucket (no executor warmup); returns their warmup_s."""
    n = len(FL_BUCKETS)
    for model in FL_MODELS:
        got = text.count("mxserve: warmed %r from the AOT store (%d/%d "
                         "buckets)" % (model, n, n))
        check(got == runs, "%s: %d of %d runs warmed %r from the store"
              % (what, got, runs, model))
        check("mxserve: warmed %r over buckets" % model not in text,
              "%s fell back from the store to the bucket warmup of %r"
              % (what, model))
    warm = [float(v) for v in re.findall(r"mxserve: warmup_s=([0-9.]+)",
                                         text)]
    check(len(warm) == runs, "%s: %d warmup_s lines for %d runs"
          % (what, len(warm), runs))
    return warm


def _fl_lm_graphs(mx, store):
    """Each stored LM program (one a bucket: its init-state fills carry
    the batch) calls ``mxt.lstm_seq_fwd`` once a layer and holds no cell
    of the plain recurrence."""
    return {b: _aot_graph_check(
        mx, os.path.join(store, "aot", "lm-b%d.exec" % b),
        {"lstm_seq_fwd": LM_LAYERS}, AOT_PLAIN_OPS["lstm"],
        "the LM's bucket-%d program" % b) for b in FL_BUCKETS}


def _fl_predict_seq(torch, mx, seed, prep, run_dir):
    """One ``/predict_seq`` of FL_SEQ_LEN tokens (length bucket LM_SEQ)
    straight to each replica's port (the router forwards no
    ``/predict_seq``): it runs through the replica's loaded bucket-1 LM
    program and must equal the smoke's ``Predictor`` on the padded input
    on gpu(0) bit for bit."""
    import numpy as np
    rs = np.random.RandomState(seed + 104)
    toks = rs.randint(0, LM_VOCAB, FL_SEQ_LEN)
    shape = (1, LM_SEQ)
    padded = np.concatenate([toks, np.repeat(toks[-1:], LM_SEQ - FL_SEQ_LEN)]
                            ).astype(np.float32)[None]
    pred = mx.predict.Predictor(prep["lm_sym"],
                                _with_prefixes(prep["lm_args"], {}),
                                {"data": shape, "softmax_label": shape},
                                ctx=mx.gpu(0))
    ref = pred.forward(data=padded, softmax_label=np.zeros(shape, np.float32)
                       ).get_output(0)[:FL_SEQ_LEN]
    del pred
    # the replicas' launch lines count persistent launches: the route the
    # op picks at the request's batch bucket
    route = mx.kernels.lstm_cell.lstm_seq_route(1, LM_HIDDEN, torch.float32)
    check(route == "persistent", "lstm_seq_route(1, %d) is %s" % (LM_HIDDEN,
                                                                route))
    for r in (0, 1):
        cli = mx.serving.ServeClient("127.0.0.1", _fl_replica_port(run_dir, r),
                                     timeout=60)
        try:
            status, payload = cli.predict_seq("lm", toks.tolist())
        finally:
            cli.close()
        check(status == 200 and payload["bucket"] == LM_SEQ,
              "replica %d: /predict_seq of %d tokens: %s %s" % (
                  r, FL_SEQ_LEN, status, str(payload)[:300]))
        got = np.asarray(payload["outputs"][0], np.float32)
        check(got.shape == ref.shape and np.array_equal(got, ref),
              "replica %d: the LM's /predict_seq answer differs from the "
              "smoke's Predictor" % r)
    return {"route": route, "tokens": FL_SEQ_LEN, "bucket": LM_SEQ}


def fleet_prepare(torch, mx, seed):
    """The fleet's inputs (ResNet-50 published as epoch 1 of a
    checkpoint directory, bench.py's MLP) and the warm store's builder,
    started in the background: ``main`` calls this before
    ``serving_paths`` so that the build overlaps that path's waits."""
    build_dir = os.path.join(ROOT, "mxnet_tpu_torch", "_build")
    os.makedirs(build_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="fleet-", dir=build_dir)
    bench = load_example("bench.py", "port_bench")
    with mx.name.NameManager():
        symbol = mx.models.get_symbol("resnet-50", num_classes=1000,
                                      image_shape=IMAGE)
    os.makedirs(os.path.join(tmp, "bench"))
    mlp = bench._save_serving_models(os.path.join(tmp, "bench"))["mlp"]
    res_dir = os.path.join(tmp, "resnet")
    args1, aux1 = _sv_save_resnet(mx, symbol, seed + 100, res_dir, 1)
    lm_sym, lm_args = _sv_save_lm(mx, seed + 103, _fl_lm_dir(tmp))
    build = _fl_start_build(tmp, res_dir, mlp)
    _BACKGROUND.append(build[0])
    return {"tmp": tmp, "bench": bench, "symbol": symbol, "mlp": mlp,
            "res_dir": res_dir, "args1": args1, "aux1": aux1,
            "lm_sym": lm_sym, "lm_args": lm_args, "build": build}


def phase_fl_fleet(torch, mx, seed, prep):
    """The fleet's main path on the card: bring-up from the warm store,
    parity, route overhead, scale-out at concurrency 32, the SIGKILL
    drill, the ``dup_request`` collapse, the rolling swap under traffic,
    one ``/predict_seq`` of the LM on each replica and the drain.  When the router's CPU bounds it at concurrency 32,
    the ``--workers 2`` fleet is started before the drills, so that its
    bring-up overlaps them.  Returns the drained replicas' bn_act and
    lstm_seq launches and the numbers."""
    import threading
    import numpy as np
    tmp, bench, symbol, mlp, res_dir = (prep[k] for k in (
        "tmp", "bench", "symbol", "mlp", "res_dir"))
    args1, aux1 = prep["args1"], prep["aux1"]
    rs = np.random.RandomState(seed + 101)
    xq = rs.standard_normal(IMAGE).astype(np.float32)
    refs = _fl_refs(torch, mx, symbol, args1, aux1, xq)
    out = {"buckets_distinct": len({r.tobytes() for r in refs.values()}),
           "w2": None}
    _m, margs0, maux0 = mx.model.load_checkpoint(mlp[0], mlp[1])
    out["warm"] = _fl_finish_build(prep["build"], {
        "resnet": _fl_param_bytes(mx, (args1, aux1)),
        "mlp": _fl_param_bytes(mx, (margs0, maux0)),
        "lm": _fl_param_bytes(mx, (prep["lm_args"], {}))})
    out["lm_graph"] = _fl_lm_graphs(mx, out["warm"]["store"])
    gc.collect()
    torch.cuda.empty_cache()
    mem = out["card_mib"] = {"smoke_alone": _fl_card_mib()}
    proc, port, out["ready_s"], run_dir, log_path = _fl_start(
        tmp, "fleet", res_dir, mlp, warm_store=out["warm"]["store"],
        MXTPU_FAULTS="dup_request:1")
    try:
        stats = _fl_get(mx, port)
        pids = [stats["replicas"][str(r)]["pid"] for r in (0, 1)]
        mem["ready"] = _fl_card_mib()
        out["apps"], out["mps"] = _fl_apps()
        man = mx.fleet.FleetManifest({"resnet": res_dir, "mlp": mlp[0]},
                                     replicas=2)
        home = man.home("resnet")
        # -- parity; the first routed request is delivered twice -------
        routed = _sv_predict(mx, port, "resnet", xq)
        check(np.array_equal(routed, refs[1]), "a quiet request through "
              "the router differs from the smoke's Predictor at bucket 1")
        router = _fl_get(mx, port)["router"]["counters"]
        per = [_fl_get(mx, _fl_replica_port(run_dir, r))["counters"]
               for r in (0, 1)]
        out["dup"] = {"dup_requests": router.get("dup_requests", 0),
                      "completed": [c.get("completed", 0) for c in per],
                      "dedup": [c.get("dedup_hits", 0)
                                + c.get("dedup_joined", 0) for c in per]}
        check(out["dup"]["dup_requests"] == 1
              and sum(out["dup"]["completed"]) == 1
              and sum(out["dup"]["dedup"]) == 1,
              "dup_request: %s" % out["dup"])
        # the MLP through the router, against the smoke's Predictor
        before = _fl_batches(mx, run_dir)
        prefix, epoch, sample = mlp
        xm = rs.rand(*sample).astype(np.float32)
        got = _sv_predict(mx, port, "mlp", xm)
        msym, margs, maux = mx.model.load_checkpoint(prefix, epoch)
        pred = mx.predict.Predictor(msym, _with_prefixes(margs, maux),
                                    {"data": (1,) + tuple(sample)},
                                    ctx=mx.gpu(0))
        check(np.array_equal(got, pred.forward(data=xm[None]).get_output(0)
                             [0]), "the MLP through the router differs from "
              "the smoke's Predictor")
        del pred
        mlp_batches = [a - b for a, b in zip(_fl_batches(mx, run_dir),
                                             before)]
        check(sum(mlp_batches) == 1, "the MLP request took %s batches"
              % mlp_batches)
        # the same bytes straight to each replica, at buckets 1, 8, 32
        out["bursts"] = []
        for r in (0, 1):
            rport = _fl_replica_port(run_dir, r)
            check(np.array_equal(_sv_predict(mx, rport, "resnet", xq),
                                 refs[1]), "replica %d differs at bucket 1"
                  % r)
            out["bursts"].append(_fl_bursts(mx, rport, xq, refs))
        # -- route overhead at concurrency 1 ---------------------------
        groups = {"front": _fl_router_pids(mx, proc, port),
                  "client": [os.getpid()], "replicas": pids}
        home_port = _fl_replica_port(run_dir, home)
        c0 = {k: _fl_cpu_s(p) for k, p in groups.items()}
        time.sleep(FL_IDLE_S)
        out["idle_cpu"] = {k: round(_fl_cpu_s(p) - c0[k], 2)
                           for k, p in groups.items()}
        out["c1_router"] = _fl_load(mx, bench, port, 1, FL_C1_S, groups,
                                    run_dir)
        out["c1_direct"] = _fl_load(mx, bench, home_port, 1, FL_C1_S,
                                    groups, run_dir)
        # -- scale-out on one card at concurrency 32 -------------------
        c0 = _fl_get(mx, port)["router"]["counters"]
        out["c32_router"] = _fl_load(mx, bench, port, 32, FL_C32_S, groups,
                                     run_dir)
        c1 = _fl_get(mx, port)["router"]["counters"]
        out["c32_routed"] = {k: c1.get(k, 0) - c0.get(k, 0)
                             for k in ("routed", "spilled", "rerouted",
                                       "retries")}
        check(min(out["c32_router"][1]["batches"]) > 0, "concurrency 32 "
              "through the router: batches by replica %s"
              % out["c32_router"][1]["batches"])
        out["c32_direct"] = _fl_load(mx, bench, home_port, 32, FL_C32_S,
                                     groups, run_dir)
        mem["loaded"] = _fl_card_mib()
        cpu = out["c32_router"][1]
        if cpu["front"] / cpu["wall"] >= FL_ROUTER_BOUND:
            out["w2"] = _fl_start(tmp, "fleet-w2", res_dir, mlp, workers=2,
                                  watch=False, warm_store=out["warm"]["store"],
                                  wait=False)
            _BACKGROUND.append(out["w2"][0])
        # -- SIGKILL the ResNet-50 home under 8 clients ----------------
        victim = pids[home]
        stop, rows = threading.Event(), []
        threads = _fl_traffic(mx, port, xq, FL_KILL_CLIENTS, stop, rows)
        cli = mx.serving.ServeClient("127.0.0.1", port, timeout=60)
        try:
            time.sleep(0.5)
            t_kill = time.perf_counter()
            os.kill(victim, signal.SIGKILL)
            _sv_wait("the eviction", lambda: cli.healthz()[1]
                     ["replicas_healthy"] == 1)
            out["evict_s"] = time.perf_counter() - t_kill
            mem["evicted"] = _fl_card_mib()
            _sv_wait("the respawn's rejoin", lambda: cli.healthz()[1]
                     ["replicas_healthy"] == 2)
            out["rejoin_s"] = time.perf_counter() - t_kill
            mem["rejoined"] = _fl_card_mib()
            time.sleep(0.5)
        finally:
            stop.set()
            for t in threads:
                t.join(60)
            cli.close()
        statuses = collections.Counter(r[1] for r in rows)
        check(set(statuses) == {200}, "answers through the SIGKILL: %s; "
              "errors %s" % (dict(statuses), [r[3] for r in rows if r[3]]))
        out["kill_requests"] = len(rows)
        out["kill_retried"] = sum(1 for r in rows if r[2])
        check(out["kill_retried"] >= 1, "the SIGKILL was never "
              "client-visible (no retried answer)")
        stats = _fl_get(mx, port)
        rep = stats["replicas"][str(home)]
        check(rep["restarts"] >= 1 and rep["pid"] != victim,
              "the respawn: %s" % rep)
        pids[home] = rep["pid"]
        home_port = _fl_replica_port(run_dir, home)
        check(np.array_equal(_sv_predict(mx, home_port, "resnet", xq),
                             refs[1]), "the respawned replica's answer "
              "differs from the answer before the kill")
        out["kill_counters"] = {k: stats["router"]["counters"].get(k, 0)
                                for k in ("retries", "retry_ok",
                                          "replica_errors", "rerouted")}
        # -- the rolling swap under 4 clients --------------------------
        stop, rows, fences = threading.Event(), [], []
        threads = _fl_traffic(mx, port, xq, FL_SWAP_CLIENTS, stop, rows)
        try:
            time.sleep(0.5)
            t_pub = time.perf_counter()
            args2, aux2 = _sv_save_resnet(mx, symbol, seed + 102, res_dir, 2)

            def rolled():
                s = _fl_get(mx, port)
                fences.append(sorted(r for r, v in s["replicas"].items()
                                     if v.get("fenced")))
                st = (s.get("rollout") or {}).get("state") or {}
                return st.get("state") == "complete" and st.get("epoch") == 2

            _sv_wait("the rollout of epoch 2", rolled)
            out["rollout_s"] = time.perf_counter() - t_pub
            time.sleep(0.3)
        finally:
            stop.set()
            for t in threads:
                t.join(60)
        statuses = collections.Counter(r[1] for r in rows)
        check(set(statuses) == {200}, "answers during the rolling swap: "
              "%s; errors %s" % (dict(statuses),
                                 [r[3] for r in rows if r[3]]))
        out["swap_requests"] = len(rows)
        rollout = _fl_get(mx, port)["rollout"]
        out["rollout"] = rollout
        check(max(len(f) for f in fences) <= 1 and
              rollout["state"]["done"] == [0, 1], "the rollout did not go "
              "one replica at a time: fenced sets %s, %s" % (
                  sorted(set(map(tuple, fences))), rollout))
        out["fenced_seen"] = sorted(set(r for f in fences for r in f))
        fresh = _fl_refs(torch, mx, symbol, args2, aux2, xq, (1,))[1]
        deploy = []
        for r in (0, 1):
            rport = _fl_replica_port(run_dir, r)
            check(np.array_equal(_sv_predict(mx, rport, "resnet", xq),
                                 fresh), "replica %d after the rollout "
                  "differs from a fresh Predictor on epoch 2" % r)
            deploy.append(_fl_get(mx, rport)["deploy"]["resnet"])
        check(all(d["promoted"] == 1 and d["rolled_back"] == 0
                  for d in deploy), "the replicas' swaps: %s" % deploy)
        # -- the LM through each replica's loaded programs -------------
        out["lm_seq"] = _fl_predict_seq(torch, mx, seed, prep, run_dir)
        # -- the drain -------------------------------------------------
        t_term = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        exits, fenced = {}, {}
        ports = [_fl_replica_port(run_dir, r) for r in (0, 1)]
        while proc.poll() is None:
            check(time.perf_counter() - t_term < SV_WAIT_S, "the fleet did "
                  "not exit in %d s after SIGTERM" % SV_WAIT_S)
            for r, pid in enumerate(pids):
                now = round(time.perf_counter() - t_term, 2)
                if r not in exits and not _fl_alive(pid):
                    exits[r] = now
                if r not in fenced and not _fl_serving(mx, ports[r]):
                    fenced[r] = now
            time.sleep(0.05)
        rc = proc.returncode
        out["drain_s"] = time.perf_counter() - t_term
        out["replica_exit_s"] = [exits.get(r) for r in (0, 1)]
        out["replica_draining_s"] = [fenced.get(r) for r in (0, 1)]
    finally:
        _fl_stop(proc)
    with open(log_path) as f:
        text = f.read()
    if rc != 0:
        log(text[-4000:])
    check(rc == 0 and "replica exit codes {0: 0, 1: 0}" in text,
          "the fleet exited %d after SIGTERM: %s" % (rc, text[-600:]))
    launches, seq, out["drained_batches"] = 0, 0, []
    out["warm"]["replica_warmup_s"] = []
    for r in (0, 1):
        with open(os.path.join(run_dir, "replica-%d.log" % r)) as f:
            rtext = f.read()
        check(rtext.count("mxserve: drained") == 1, "replica %d: %d drained "
              "runs" % (r, rtext.count("mxserve: drained")))
        # the SIGKILLed home's respawn warmed from the store as well
        out["warm"]["replica_warmup_s"].append(_fl_warm_check(
            rtext, 2 if r == home else 1, "replica %d" % r))
        n, batches, lm_n = _fl_launch_check(
            rtext, mlp_batches[r] if r != home else 0, 1,
            "replica %d (%s run)" % (r, "respawned" if r == home else "first"),
            lm_batches=1)
        launches += n
        seq += lm_n
        out["drained_batches"].append(batches)
    out["launches"], out["seq_launches"] = launches, seq
    return collections.Counter({"bn_act_fwd": launches,
                                "lstm_seq_fwd": seq}), out


def phase_fl_workers(mx, bench, spawned):
    """The same fleet with two router workers on the public port
    (``--workers 2``, started by :func:`phase_fl_fleet`): concurrency 32
    and the front end's CPU, then the drain.  Returns the replicas'
    bn_act and lstm_seq launches and the numbers."""
    proc, port, ready_s, run_dir, log_path = _fl_wait(spawned)
    out = {"ready_s": ready_s}
    try:
        stats = _fl_get(mx, port)
        groups = {"front": _fl_router_pids(mx, proc, port),
                  "client": [os.getpid()],
                  "replicas": [stats["replicas"][str(r)]["pid"]
                               for r in (0, 1)]}
        check(len(groups["front"]) == 3, "front-end processes %s"
              % groups["front"])
        out["c32"] = _fl_load(mx, bench, port, 32, FL_C32_S, groups,
                              run_dir)
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=SV_WAIT_S)
    finally:
        _fl_stop(proc)
    with open(log_path) as f:
        text = f.read()
    check(rc == 0 and "worker exit codes {0: 0, 1: 0}" in text
          and "replica exit codes {0: 0, 1: 0}" in text,
          "the sharded fleet exited %d: %s" % (rc, text[-600:]))
    launches = collections.Counter()
    for r in (0, 1):
        with open(os.path.join(run_dir, "replica-%d.log" % r)) as f:
            rtext = f.read()
        _fl_warm_check(rtext, 1, "sharded replica %d" % r)
        n, _, lm_n = _fl_launch_check(rtext, 0, 0, "sharded replica %d" % r)
        launches.update({"bn_act_fwd": n, "lstm_seq_fwd": lm_n})
    return launches, out


def fleet_paths(torch, mx, seed, card, prepared=None):
    """The fleet slice on the card: ``fleet_main.py warmup`` builds the
    warm store (:func:`fleet_prepare`, unless ``main`` started it
    already), ``fleet_main.py serve --device-sets cuda:0 --replicas 2``
    (two daemons co-tenant on the one H100 behind the router, warmed from
    the store), and, when the router's CPU bounds it, the same load
    through ``--workers 2``.  Returns the replicas' bn_act and lstm_seq
    launches (rows 1 and 3)."""
    prep = prepared or fleet_prepare(torch, mx, seed)
    try:
        launches, out = phase_fl_fleet(torch, mx, seed, prep)
        sharded = None
        if out["w2"] is not None:
            n, sharded = phase_fl_workers(mx, prep["bench"], out["w2"])
            launches.update(n)
    finally:
        for proc in _BACKGROUND:
            _fl_stop(proc)
        shutil.rmtree(prep["tmp"], ignore_errors=True)
    _fl_report(out, sharded, card)
    return launches


def _fl_report(out, sharded, card):
    def load(key, res=None):
        (qps, p50, p99, shed, errors), cpu = (res or out)[key]
        return ("%.2f QPS, p50 %s ms, p99 %s ms, shed %d, errors %d, CPU s "
                "%s" % (qps, p50, p99, shed, errors, json.dumps(cpu)))
    log("fleet: 2 replicas on %s ready %.1f s after the spawn; card memory "
        "used (MiB, nvidia-smi, every process) %s; per process: %s; MPS "
        "daemons: %s; bucket answers distinct: %d of 3; on %s" % (
            FL_DEVICE_SETS, out["ready_s"], json.dumps(out["card_mib"]),
            out["apps"], out["mps"] or "none", out["buckets_distinct"],
            card))
    log("fleet parity: a quiet request through the router and on each "
        "replica equals the smoke's Predictor at bucket 1, the MLP too; "
        "bursts straight to each replica served buckets %s (%s requests), "
        "every answer equal to that bucket's Predictor answer; dup_request "
        "%s" % ([sorted(b[0]) for b in out["bursts"]],
                [b[1] for b in out["bursts"]], json.dumps(out["dup"])))
    p50r, p50d = out["c1_router"][0][1], out["c1_direct"][0][1]
    log("fleet route overhead at concurrency 1 (resnet-50, x-npy): router "
        "%s; direct %s; p50 difference %.3f ms" % (
            load("c1_router"), load("c1_direct"), p50r - p50d))
    qr, qd = out["c32_router"][0][0], out["c32_direct"][0][0]
    log("fleet at concurrency 32: router %s, %s; one replica direct %s; "
        "fleet / one replica = %.3f; CPU s over %.1f s idle (the --watch "
        "poll hashes the newest epoch) %s; on %s" % (
            load("c32_router"), json.dumps(out["c32_routed"]),
            load("c32_direct"), qr / qd, FL_IDLE_S,
            json.dumps(out["idle_cpu"]), card))
    if sharded is not None:
        log("fleet --workers 2 (no --watch) at concurrency 32: %s, ready "
            "%.1f s; / the one-router fleet = %.3f" % (
                load("c32", sharded), sharded["ready_s"],
                sharded["c32"][0][0] / qr))
    else:
        log("fleet: the router used %s CPU s at concurrency 32, under %.1f a "
            "second: no --workers 2 run" % (
                json.dumps(out["c32_router"][1]), FL_ROUTER_BOUND))
    log("fleet SIGKILL of the resnet home under %d clients: evicted %.2f s "
        "after the kill, %d requests all 200 (%d retried: true), the respawn "
        "rejoined %.2f s after the kill and answers the pre-kill bytes bit "
        "for bit; router %s" % (
            FL_KILL_CLIENTS, out["evict_s"], out["kill_requests"],
            out["kill_retried"], out["rejoin_s"],
            json.dumps(out["kill_counters"])))
    log("fleet rolling swap under %d clients: epoch 2 on both replicas %.2f s "
        "after the publish began, one at a time (fenced seen %s), %d requests "
        "all 200; both replicas equal a fresh Predictor on epoch 2; %s" % (
            FL_SWAP_CLIENTS, out["rollout_s"], out["fenced_seen"],
            out["swap_requests"], json.dumps(out["rollout"])))
    warm = out["warm"]
    log("fleet warm store: cold warmup_s %s (serving_paths' daemon: %s); "
        "the builder's warmup_s %.3f (fleet_main.py warmup %.1f s of wall, "
        "beside serving_paths); the replicas' warmup_s from the "
        "store %s (replica 0, replica 1; the SIGKILLed home's respawn "
        "included); .exec bytes by bucket %s against parameter bytes %s; "
        "on %s" % (
            _SV_COLD.get("warmup_s"), _SV_COLD.get("what"),
            warm["builder_warmup_s"], warm["builder_s"],
            json.dumps(warm["replica_warmup_s"]),
            json.dumps(warm["exec_bytes"]), json.dumps(warm["param_bytes"]),
            card))
    lm = out["lm_seq"]
    log("fleet LM (vocab %d, width %d, %d layers): the builder's programs by "
        "bucket %s against %d parameter bytes; every replica run warmed "
        "'lm' from the store (%d/%d buckets); /predict_seq of %d tokens "
        "(length bucket %d, batch bucket 1, lstm_seq route %s) on each "
        "replica equals the smoke's Predictor bit for bit; lstm_seq %d over "
        "the drained runs (%d a forward: 1 validation + 1 request a run); "
        "on %s" % (
            LM_VOCAB, LM_HIDDEN, LM_LAYERS, json.dumps(out["lm_graph"]),
            warm["param_bytes"]["lm"], len(FL_BUCKETS), len(FL_BUCKETS),
            lm["tokens"], lm["bucket"], lm["route"], out["seq_launches"],
            LM_LAYERS, card))
    log("fleet drain: SIGTERM -> exit 0 in %.2f s (replicas draining at %s "
        "s, gone at %s s), replicas 0 and 0; bn_act %d over the drained "
        "runs' %s ResNet-50 batches (17 a forward: 1 validation of the "
        "loaded programs, the batches, a staged validation and a probe a "
        "swap)" % (
            out["drain_s"], out["replica_draining_s"], out["replica_exit_s"],
            out["launches"], out["drained_batches"]))


# ---------------------------------------------------------------------------
# the tools slice: profiler, graph lint, serving gate, check_consistency
# ---------------------------------------------------------------------------

#: Module batches under the profiler (and unprofiled ones beside them)
TOOLS_PROFILED = 3
#: warm-up launches of the profiled windows read after the gated one: a
#: window with none beside one with the profiler's own
TOOLS_WARMUPS = (0, None)
#: steps timed for the MFU
TOOLS_MFU_STEPS = 6


def _bn_counts(ba):
    return ba.LAUNCHES, ba.BWD_LAUNCHES


def _bn_delta(ba, before):
    return collections.Counter({"bn_act_fwd": ba.LAUNCHES - before[0],
                                "bn_act_bwd": ba.BWD_LAUNCHES - before[1]})


def _resnet50(mx):
    with mx.name.NameManager():
        return mx.models.get_symbol("resnet-50", num_classes=1000,
                                    image_shape=IMAGE)


@contextlib.contextmanager
def _env(name, value):
    old = os.environ.get(name)  # mxlint: disable=env-direct-read (saved to restore)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old


def _tools_module(torch, mx, seed):
    """ResNet-50 bound through ``Module`` on ``gpu(0)``, one batch, its
    BatchNorm node names and ``run(n)``: n batches, ms a batch."""
    import numpy as np
    symbol = _resnet50(mx)
    bn_nodes = {n.name for n in symbol._nodes()
                if n.op is not None and n.op.name == "BatchNorm"}
    rs = np.random.RandomState(seed + 40)
    it = mx.io.NDArrayIter(
        rs.standard_normal((BATCH,) + IMAGE).astype(np.float32),
        rs.randint(0, 1000, BATCH).astype(np.float32), batch_size=BATCH)
    mod = mx.mod.Module(symbol, context=mx.gpu(0))
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mx.random.seed(seed)
    mod.init_params(initializer=mx.initializer.Xavier(
        rnd_type="gaussian", factor_type="in", magnitude=2))
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": 0.01, "momentum": 0.9, "rescale_grad": 1.0 / BATCH})
    batch = next(iter(it))

    def run(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            mod.forward_backward(batch)
            mod.update()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    return bn_nodes, run


def _tools_window(mx, run, trace_dir):
    """One profiled window of ``TOOLS_PROFILED`` batches in mode
    ``all_xla``: the counters' ``bn_act`` launches in it, ms a batch, the
    trace's events and their attribution, and what the trace shows of
    its own kernel records: ``lag_us``, the least start of a kernel less
    the start of its launch (a kernel cannot start before its launch, so
    a negative lag is the skew of the card's clock against the host's as
    the trace maps them), and ``orphans``, the kernel launches with no
    kernel record, each at ms from the window's start and end."""
    from mxnet_tpu_torch import profiler
    ba = mx.kernels.bn_act
    profiler.profiler_set_config(mode="all_xla", trace_dir=trace_dir,
                                 filename=trace_dir + ".json")
    # -- the profiled path: counts read just before and just after ----------
    at = _bn_counts(ba)
    profiler.profiler_set_state("run")
    try:
        prof_ms = run(TOOLS_PROFILED)
    finally:
        profiler.profiler_set_state("stop")
    fwd, bwd = ba.LAUNCHES - at[0], ba.BWD_LAUNCHES - at[1]
    # ------------------------------------------------------------------------
    t0 = time.perf_counter()
    with open(profiler.latest_device_trace()) as f:
        events = json.load(f)["traceEvents"]
    triples = profiler.attribute_trace(events)
    parse_s = time.perf_counter() - t0
    spans = [e for e in events if e.get("ph") == "X"]
    start = min(e["ts"] for e in spans)
    end = max(e["ts"] + e.get("dur", 0) for e in spans)
    launches, done, ops, ext = {}, {}, {}, {}
    for e in spans:
        args = e.get("args") or {}
        corr = args.get("correlation")
        if e.get("cat") == "cpu_op" and "External id" in args:
            ops.setdefault(args["External id"], e["ts"])
        if corr is None:
            continue
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and \
                "LaunchKernel" in e["name"]:
            launches[corr] = e["ts"]
            ext[corr] = args.get("External id")
        elif e.get("cat") == "kernel":
            done[corr] = e["ts"]
    lags = [done[c] - t for c, t in launches.items() if c in done]
    orphans = sorted(t for c, t in launches.items() if c not in done)
    # a launch record (CUPTI's clock) against the op that made it (the
    # host's): below 0 where the launch seems to precede its own op
    in_op = [t - ops[ext[c]] for c, t in launches.items()
             if ext.get(c) in ops]
    return {"fwd": fwd, "bwd": bwd, "prof_ms": prof_ms, "events": events,
            "triples": triples, "parse_s": parse_s,
            "n_fwd": sum("bn_act_fwd_kernel" in ev for _n, _u, ev in triples),
            "n_bwd": sum("bn_act_bwd_kernel" in ev for _n, _u, ev in triples),
            "lag_us": min(lags) if lags else None,
            "in_op_us": min(in_op) if in_op else None,
            "kernel_launches": len(launches),
            "orphans": [(round((t - start) / 1e3, 3),
                         round((end - t) / 1e3, 3)) for t in orphans]}


def _log_tools_window(tag, w):
    log("%s: bn_act %d / %d in the trace, %d / %d launches counted; %d "
        "kernel launches, %d without a kernel record %s (ms from the "
        "window's start, end); least launch-to-kernel lag %s us, least "
        "launch less its op's start %s us" % (
            tag, w["n_fwd"], w["n_bwd"], w["fwd"], w["bwd"],
            w["kernel_launches"], len(w["orphans"]),
            json.dumps(w["orphans"][:4] + w["orphans"][-2:]), w["lag_us"],
            w["in_op_us"]))


def phase_tools_profile(torch, mx, seed, card, tmp):
    """ResNet-50 through ``Module`` under the profiler in mode
    ``all_xla``: the trace's ``bn_act`` kernels against the counters, and
    their attribution to BatchNorm nodes."""
    from mxnet_tpu_torch import profiler
    ba = mx.kernels.bn_act
    before = _bn_counts(ba)
    bn_nodes, run = _tools_module(torch, mx, seed)
    run(2)                                  # warm-up, outside the trace
    plain_ms = run(TOOLS_PROFILED)
    w = _tools_window(mx, run, os.path.join(tmp, "trace"))
    plain2_ms = run(TOOLS_PROFILED)
    fwd, bwd, triples = w["fwd"], w["bwd"], w["triples"]
    check(fwd == bwd == 50 * TOOLS_PROFILED,
          "profiled fit: bn_act launches %d / %d, not %d each"
          % (fwd, bwd, 50 * TOOLS_PROFILED))
    _log_tools_window("tools profile", w)
    check(not w["orphans"], "%d kernel launches without a kernel record "
          "in the trace" % len(w["orphans"]))
    stats = profiler.get_op_stats()
    kinds = {"bn_act_fwd_kernel": ("", fwd), "bn_act_bwd_kernel":
             ("_backward_", bwd)}
    for kernel, (prefix, launches) in kinds.items():
        owners = collections.Counter(node for node, _us, ev in triples
                                     if kernel in ev)
        n_trace = sum(owners.values())
        stray = {k: v for k, v in owners.items()
                 if not (k.startswith(prefix) and
                         k[len(prefix):] in bn_nodes)}
        log("tools profile: %s: %d in the trace, %d launches counted; "
            "under %d distinct %sBatchNorm nodes; outside them: %s" % (
                kernel, n_trace, launches, len(owners), prefix or "",
                json.dumps(stray)))
        check(n_trace == launches, "trace holds %d %s, counters %d"
              % (n_trace, kernel, launches))
        check(not stray, "%s attributed outside the BN nodes: %s"
              % (kernel, stray))
        for node in owners:
            check(node in stats and stats[node]["total_us"] > 0,
                  "get_op_stats lacks %s" % node)
    busy = sum(us for _n, us, _e in triples)
    unattr = sum(us for n, us, _e in triples if n == profiler.UNATTRIBUTED)
    bn_us = sum(us for _n, us, ev in triples if "bn_act_" in ev)
    prof_ms = w["prof_ms"]
    log("tools profile: ResNet-50 Module batch %d: %.2f ms unprofiled "
        "(%.2f ms after), %.2f ms profiled (x%.3f); device %.2f ms a batch "
        "in %d kernels, %.1f%% unattributed, bn_act %.3f ms; %d nodes in "
        "get_op_stats; trace parsed in %.2f s; on %s" % (
            BATCH, plain_ms, plain2_ms, prof_ms,
            prof_ms / ((plain_ms + plain2_ms) / 2), busy / 1e3 /
            TOOLS_PROFILED, len(triples) // TOOLS_PROFILED,
            100.0 * unattr / max(busy, 1e-9), bn_us / 1e3 / TOOLS_PROFILED,
            len(stats), w["parse_s"], card))
    for line in profiler.dumps().splitlines()[:14]:
        log("tools dumps: " + line)
    return _bn_delta(ba, before)


def phase_tools_profile_windows(torch, mx, seed, card, tmp, windows,
                                gap_s=0.0, warmups=None):
    """The profiled fit's trace in this process, ``windows`` times with
    ``gap_s`` seconds of unprofiled batches between: each window's
    ``bn_act`` kernels against the counters, its launches without a
    kernel record and its clock readings, logged (a reading: in a
    process that has traced windows before, a trace can lose the kernel
    records of its window's first launches unless the profiler warms
    CUPTI up first).  ``warmups`` cycles ``profiler.WARMUP_LAUNCHES``
    over the windows (None: the profiler's own)."""
    from mxnet_tpu_torch import profiler
    ba = mx.kernels.bn_act
    warm0 = profiler.WARMUP_LAUNCHES
    before = _bn_counts(ba)
    _bn_nodes, run = _tools_module(torch, mx, seed)
    run(2)
    born = time.perf_counter()
    for i in range(windows):
        if i and gap_s:
            t_end = time.perf_counter() + gap_s
            while time.perf_counter() < t_end:
                run(1)
        warm = warmups[i % len(warmups)] if warmups else None
        warm = warm0 if warm is None else warm
        profiler.WARMUP_LAUNCHES = warm
        try:
            w = _tools_window(mx, run, os.path.join(tmp, "window-%d" % i))
        finally:
            profiler.WARMUP_LAUNCHES = warm0
        check(w["fwd"] == w["bwd"] == 50 * TOOLS_PROFILED,
              "profiled window: bn_act launches %d / %d" % (w["fwd"],
                                                           w["bwd"]))
        _log_tools_window("tools profile in-process window %d at %.0f s, %d "
                    "warm-up launches" % (i, time.perf_counter() - born,
                                          warm), w)
    log("tools profile in-process: on %s" % card)
    return _bn_delta(ba, before)


def phase_tools_lint(torch, mx, seed, card):
    """``SPMDTrainer.analyze`` on ``gpu(0)``, a strict-gated ResNet-50
    step, the step's peak memory above resident, and MFU."""
    import numpy as np
    from mxnet_tpu_torch.analysis import fixtures
    from mxnet_tpu_torch.contrib.flops import model_flops
    ba = mx.kernels.bn_act
    before = _bn_counts(ba)
    mlp = fixtures.standard_mlp_trainer(ctx=mx.gpu(0))
    t0 = time.perf_counter()
    rep = mlp.analyze(*fixtures.standard_mlp_batch())
    mlp_s = time.perf_counter() - t0
    coll = sum(c["count"] for c in rep.stats["collectives"].values())
    log("tools lint: standard MLP on gpu(0): %s; %d ops, %d host syncs, %d "
        "collectives, %.3f s" % (
            "clean" if rep.ok else rep.format_text(),
            rep.stats["dispatched_ops"], rep.stats["host_syncs"], coll,
            mlp_s))
    check(rep.ok and rep.stats["host_syncs"] == 0 and coll == 0,
          "MLP step lint: %s" % rep.format_text())
    mlp.close()

    tr = make_trainer(torch, mx, seed)
    dev = mx.gpu(0).torch_device
    rs = np.random.RandomState(seed + 41)
    x = torch.from_numpy(rs.standard_normal((BATCH,) + IMAGE)
                         .astype(np.float32)).to(dev)
    y = torch.from_numpy(rs.randint(0, 1000, BATCH).astype(np.float32)) \
        .to(dev)
    w0 = {k: v.clone() for k, v in tr.params.items()}
    times = []
    for _ in range(2):          # the first pays cuDNN's autotuning
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = tr.analyze(x, y)
        times.append(time.perf_counter() - t0)
    coll = sum(c["count"] for c in rep.stats["collectives"].values())
    log("tools lint: ResNet-50 step batch %d on gpu(0): %s; %d ops, %d host "
        "syncs, %d collectives, kernel launches %s, plan %s; analyze %.2f s "
        "(first %.2f s); on %s" % (
            BATCH, "clean" if rep.ok else rep.format_text(),
            rep.stats["dispatched_ops"], rep.stats["host_syncs"], coll,
            json.dumps(rep.stats["kernel_launches"]),
            json.dumps(rep.stats["plan_fusion"]), times[-1], times[0], card))
    check(rep.ok and rep.stats["host_syncs"] == 0 and coll == 0,
          "ResNet-50 step lint: %s" % rep.format_text())
    check(rep.stats["kernel_launches"] == {"bn_act_bwd": 50,
                                           "bn_act_fwd": 50},
          "analyze saw launches %s" % rep.stats["kernel_launches"])
    check(tr._num_update == 0 and all(torch.equal(v, w0[k])
                                      for k, v in tr.params.items()),
          "analyze moved the trainer")
    ptrs = {k: v.data_ptr() for k, v in tr.params.items()}
    with _env("MXTPU_ANALYZE", "strict"):
        out = tr.step(x, y)[0]
    torch.cuda.synchronize()
    check(tr._num_update == 1 and len(tr._analyzed_keys) == 1
          and bool(torch.isfinite(out).all()),
          "strict-gated step did not train")
    check(all(v.data_ptr() == ptrs[k] for k, v in tr.params.items()),
          "params moved to new storage")
    moved = sum(not torch.equal(v, w0[k]) for k, v in tr.params.items())
    log("tools lint: MXTPU_ANALYZE=strict ResNet-50 step trained (%d of %d "
        "params moved, storage kept)" % (moved, len(w0)))
    check(moved == len(w0), "the strict step moved %d params" % moved)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    tr.step(x, y)
    torch.cuda.synchronize()
    log("tools lint: ResNet-50 step peak above resident %.1f MiB, resident "
        "%.1f MiB; on %s" % (
            (torch.cuda.max_memory_allocated() - resident) / 2 ** 20,
            resident / 2 ** 20, card))

    flops = model_flops(_resnet50(mx), data=(BATCH,) + IMAGE)
    tr.step(x, y)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TOOLS_MFU_STEPS):
        tr.step(x, y)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / TOOLS_MFU_STEPS
    log("tools flops: ResNet-50 model_flops %d forward at batch %d (%.3f "
        "GFLOP an image), %d a training step (3x); step %.2f ms -> %.2f "
        "TFLOP/s, MFU %.4f of %.0f TFLOP/s float32 (TF32 off); on %s" % (
            flops, BATCH, flops / BATCH / 1e9, 3 * flops, step_s * 1e3,
            3 * flops / step_s / 1e12, 3 * flops / step_s / F32_FLOPS_PER_S,
            F32_FLOPS_PER_S / 1e12, card))
    check(tr.skipped_steps == 0, "skipped steps in the tools phase")
    tr.close()
    return _bn_delta(ba, before)


def phase_tools_serving_gate(torch, mx, seed, card):
    """A strict ``ModelPool`` serving ResNet-50 at bucket 32 after
    ``analyze``, against ``Predictor``."""
    import numpy as np
    ba = mx.kernels.bn_act
    before = _bn_counts(ba)
    symbol = _resnet50(mx)
    args, aux = draw_weights(symbol, (BATCH,) + IMAGE, seed + 42)
    x = np.random.RandomState(seed + 43).standard_normal(
        (BATCH,) + IMAGE).astype(np.float32)
    with _env("MXTPU_ANALYZE", "strict"):
        pool = mx.serving.ModelPool(ctx=mx.gpu(0))
        pool.add("resnet-50", symbol, args, aux,
                 sample_shapes={"data": IMAGE})
        entry = pool.get("resnet-50")
        t0 = time.perf_counter()
        rep = entry.analyze(bucket=BATCH)
        analyze_s = time.perf_counter() - t0
        check(rep.ok and rep.stats["host_syncs"] == 0,
              "serving lint: %s" % rep.format_text())
        got = entry.forward({"data": x})[0]
    check((("data", (BATCH,) + IMAGE),) in entry._analyzed,
          "the strict gate did not lint the signature")
    pred = mx.predict.Predictor(symbol, _with_prefixes(args, aux),
                                {"data": x.shape}, ctx=mx.gpu(0))
    want = pred.forward(data=x).get_output(0)
    check(got.shape == (BATCH, 1000) and np.isfinite(got).all(),
          "strict pool output %s" % (got.shape,))
    same = bool(np.array_equal(got, want))
    log("tools serving gate: MXTPU_ANALYZE=strict pool served ResNet-50 at "
        "bucket %d after analyze (%s, %d ops, %d host syncs, launches %s, "
        "%.2f s); output equal to Predictor bit for bit: %s; max |diff| "
        "%.3g; on %s" % (
            BATCH, "clean" if rep.ok else "findings",
            rep.stats["dispatched_ops"], rep.stats["host_syncs"],
            json.dumps(rep.stats["kernel_launches"]), analyze_s, same,
            float(np.abs(got - want).max()), card))
    check(float(np.abs(got - want).max()) <= 1e-5,
          "strict pool disagrees with Predictor")
    return _bn_delta(ba, before)


def phase_tools_consistency(torch, mx, seed):
    """``test_utils.check_consistency`` of conv+BN+ReLU on ``[cpu(),
    gpu(0)]``, the training forward and backward."""
    import numpy as np
    ba = mx.kernels.bn_act
    data = mx.sym.Variable("data")
    net = mx.sym.Convolution(data, num_filter=16, kernel=(3, 3),
                             pad=(1, 1), name="cc_conv")
    net = mx.sym.BatchNorm(net, fix_gamma=False, name="cc_bn")
    net = mx.sym.Activation(net, act_type="relu", name="cc_relu")
    shapes = {"data": (4, 8, 16, 16)}
    np.random.seed(seed + 44)
    before = _bn_counts(ba)
    for is_train in (False, True):
        mx.test_utils.check_consistency(
            net, [mx.cpu(), mx.gpu(0)], shapes=shapes, is_train=is_train,
            rtol=1e-3, atol=1e-3)
    delta = _bn_delta(ba, before)
    log("tools check_consistency: conv+BN+ReLU %s on [cpu(), gpu(0)], "
        "inference and training (outputs and every argument gradient "
        "within rtol 1e-3, atol 1e-3); bn_act launches on gpu(0) %s"
        % (shapes["data"], json.dumps(delta)))
    check(delta["bn_act_fwd"] >= 1 and delta["bn_act_bwd"] >= 1,
          "check_consistency launched no bn_act")
    return delta


def tools_paths(torch, mx, seed, card):
    """The tools slice on the card (docstring item 29).  Returns every
    ``bn_act`` launch of its paths (rows 1-2)."""
    build_dir = os.path.join(ROOT, "mxnet_tpu_torch", "_build")
    os.makedirs(build_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="tools-", dir=build_dir)
    try:
        counts = phase_tools_profile(torch, mx, seed, card, tmp)
        counts += phase_tools_profile_windows(torch, mx, seed, card, tmp,
                                              len(TOOLS_WARMUPS),
                                              warmups=TOOLS_WARMUPS)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    counts += phase_tools_lint(torch, mx, seed, card)
    counts += phase_tools_serving_gate(torch, mx, seed, card)
    counts += phase_tools_consistency(torch, mx, seed)
    return counts


# ---------------------------------------------------------------------------
# the data-parallel slice: two ranks on the one card (dist_paths)
# ---------------------------------------------------------------------------

#: ranks launched on the card (they share cuda:0 and talk over gloo)
DIST_RANKS = 2
#: ResNet-50 steps a tier: the first warms up, the rest are timed (the
#: last with the collectives' host seconds counted), and the allreduce
#: tier's params after the first and the last are held to one process at
#: the global batch
DIST_STEPS = 2
DIST_TIERS = ("allreduce", "zero", "zero3")
#: Module.fit batches a kvstore kind
DIST_FIT_BATCHES = 2
#: the zero3 drill on bench.py's MLP (bench.py:761-767): steps, the save
DIST_MLP_STEPS, DIST_MLP_SAVE = 6, 3
DIST_MLP_BATCH = 64
#: the preemption drill: MLP fit batches an epoch, and the boundary (of
#: the second epoch) where rank 1 alone gets SIGTERM
DIST_PRE_BATCHES, DIST_PRE_AT = 4, 2
#: a launch's time limit (seconds)
DIST_LAUNCH_TIMEOUT = 420
#: the seed of the ResNet-50 weights every tier and reference starts from
DIST_SEED_INIT = 17


def _dist_emit(tag, **rec):
    print("DIST %s %s" % (tag, json.dumps(rec, sort_keys=True)), flush=True)


def _dist_mlp(mx):
    """bench.py's MLP (bench.py:761-767): 256 -> 1024 -> 1024 -> 10."""
    with mx.name.NameManager():
        data = mx.sym.Variable("data")
        net = mx.sym.FullyConnected(data, num_hidden=1024, name="fc1")
        net = mx.sym.Activation(net, act_type="relu")
        net = mx.sym.FullyConnected(net, num_hidden=1024, name="fc2")
        net = mx.sym.Activation(net, act_type="relu")
        net = mx.sym.FullyConnected(net, num_hidden=10, name="fc3")
        return mx.sym.SoftmaxOutput(net, name="softmax")


def _dist_digest(arg, aux):
    import hashlib
    h = hashlib.sha256()
    for d in (arg, aux):
        for k in sorted(d):
            h.update(d[k].asnumpy().tobytes())
    return h.hexdigest()


def _dist_host(tr):
    arg, aux = tr.get_params()
    return ({k: v.asnumpy() for k, v in arg.items()},
            {k: v.asnumpy() for k, v in aux.items()})


def _dist_resnet_trainer(mx, sync, world, batch, ctx, args, aux):
    mesh = mx.parallel.local_mesh() if world > 1 else None
    tr = mx.parallel.SPMDTrainer(
        _resnet50(mx), "sgd", {"learning_rate": 0.1, "momentum": 0.9,
                               "wd": 1e-4, "rescale_grad": 1.0 / (
                                   batch * world)},
        mesh=mesh, grad_sync=sync, ctx=ctx)
    tr.bind([("data", (batch,) + IMAGE)], [("softmax_label", (batch,))])
    if args is None:
        mx.random.seed(DIST_SEED_INIT)
        tr.init_params(mx.initializer.Xavier(rnd_type="gaussian",
                                             factor_type="in", magnitude=2))
    else:
        tr.init_params(None, arg_params=args, aux_params=aux)
    return tr


def _dist_tiers(torch, mx, seed, rank, world, init):
    """ResNet-50 at 32 images a rank through SPMDTrainer under each
    grad_sync: launches a step, ms a step, resident bytes, peak memory,
    the collectives' share of a step.  The first tier draws seeded Xavier
    weights; they and the allreduce params after the first and the last
    of DIST_STEPS steps are returned for the one-process gate."""
    import numpy as np
    from mxnet_tpu_torch import distributed
    ba = mx.kernels.bn_act
    dev = distributed.device()
    rs = np.random.RandomState(seed + 41)
    glob = [(rs.standard_normal((BATCH * world,) + IMAGE).astype(np.float32),
             rs.randint(0, 1000, BATCH * world).astype(np.float32))
            for _ in range(DIST_STEPS)]
    local = [(torch.from_numpy(x[rank * BATCH:(rank + 1) * BATCH]).to(dev),
              torch.from_numpy(y[rank * BATCH:(rank + 1) * BATCH]).to(dev))
             for x, y in glob]
    finals = None
    for sync in DIST_TIERS:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        tr = _dist_resnet_trainer(mx, sync, world, BATCH, mx.gpu(dev.index),
                                  *(init or (None, None)))
        if init is None:
            # the first tier's seeded Xavier weights (rank 0's, broadcast)
            # start every later run
            init = _dist_host(tr)
        spans, fwd, bwd, after = [], [], [], []
        for i, (x, y) in enumerate(local[:DIST_STEPS]):
            f0, b0 = ba.LAUNCHES, ba.BWD_LAUNCHES
            # the last step also counts the collectives' host seconds
            distributed.reset_stats()
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            tr.step(x, y)
            torch.cuda.synchronize(dev)
            spans.append(time.perf_counter() - t0)
            fwd.append(ba.LAUNCHES - f0)
            bwd.append(ba.BWD_LAUNCHES - b0)
            if sync == "allreduce" and i in (0, DIST_STEPS - 1):
                after.append(_dist_host(tr))
        coll = {k: dict(v) for k, v in distributed.STATS.items()
                if v["count"]}
        share = sum(v["seconds"] for v in coll.values()) / spans[-1]
        steady = [v * 1e3 for v in spans[1:]]
        if sync == "allreduce":
            finals = after
        _dist_emit("tier", rank=rank, sync=sync, ms=steady,
                   first_ms=spans[0] * 1e3,
                   fwd=fwd, bwd=bwd, resident=tr.resident_bytes(),
                   peak=torch.cuda.max_memory_allocated(dev),
                   profiled_ms=spans[-1] * 1e3, coll_share=share,
                   collectives=coll, tier=tr.zero3_tier,
                   groups=len(tr._zero3_groups),
                   skipped=tr.skipped_steps)
        tr.close()
        del tr
    return glob, init, finals


def _dist_update_l2(np, got, ref, init):
    """Relative L2 of ``got``'s update (params minus ``init``) against
    ``ref``'s, all params together, and the worst tensor's."""
    dg = {k: got[k] - init[k] for k in init}
    dr = {k: ref[k] - init[k] for k in init}
    return (_rel_l2(np, dg, dr, sorted(dr)),
            list(max((_rel_l2(np, dg, dr, [k]), k) for k in dr)))


def _dist_one_process_gate(torch, mx, rank, world, init, glob, finals):
    """Rank 0 steps one process at the global batch from the same weights
    on the same batches, then twice more in other equally valid float32
    orders: with MXTPU_FUSED_KERNELS=0, and with the batch's two halves
    swapped (every reduction over the batch sums in another order); and
    takes the first step's update in float64.  The first step: the
    two-rank update lies within GRAD_L2_FACTOR x the one process's
    relative L2 distance from float64 (at least AGREE_REL_TOL), the
    smoke's gradient convention.  After the first and the last of
    DIST_STEPS steps: the two-rank update lies within GRAD_L2_FACTOR x
    the larger distance of the other orders from the one process (at
    least AGREE_REL_TOL), in relative L2 over all params, and the moving
    statistics too.  ReLU masks flip under another summation order and
    the flips grow step by step (see GRAD_L2_FACTOR): after a few steps
    any two float32 orders are far apart."""
    import numpy as np
    from mxnet_tpu_torch import distributed
    distributed.barrier("dist_gate")
    if rank == 0:
        dev = distributed.device()
        n = BATCH * world
        swap = np.concatenate([np.arange(n // 2, n), np.arange(n // 2)])
        runs = {}
        for name, fused, order in (("one", "1", None), ("plain", "0", None),
                                   ("swapped", "1", swap)):
            torch.cuda.empty_cache()
            with _env("MXTPU_FUSED_KERNELS", fused):
                tr = _dist_resnet_trainer(mx, "allreduce", 1, n,
                                          mx.gpu(dev.index), *init)
                hist = []
                for i, (x, y) in enumerate(glob[:DIST_STEPS]):
                    if order is not None:
                        x, y = x[order], y[order]
                    tr.step(torch.from_numpy(x).to(dev),
                            torch.from_numpy(y).to(dev))
                    if i in (0, DIST_STEPS - 1):
                        hist.append(_dist_host(tr))
                opt = tr.optimizer
                tr.close()
            runs[name] = hist
        # the first step's update in float64 (the plain plan; the kernels
        # take float32 and bfloat16): sgd from zero momentum moves each
        # param by -lr (rescale_grad g + wd w)
        torch.cuda.empty_cache()
        with _env("MXTPU_FUSED_KERNELS", "0"):
            ref = _executor_step(mx, _resnet50(mx), init,
                                 glob[0][0].astype(np.float64),
                                 glob[0][1].astype(np.float64),
                                 mx.gpu(dev.index))
        arg0 = init[0]
        step64 = {k: arg0[k] - opt.lr * (
            opt.rescale_grad * ref["grad:" + k]
            + opt.wd * opt.wd_mult.get(k, 1.0) * arg0[k]) for k in arg0}
        del ref
        rec = {"f64": {
            "two": _dist_update_l2(np, finals[0][0], step64, arg0)[0],
            "one": _dist_update_l2(np, runs["one"][0][0], step64, arg0)[0]}}
        for i, at in enumerate((1, DIST_STEPS)):
            one, two = runs["one"][i], finals[i]
            l2, worst = _dist_update_l2(np, two[0], one[0], arg0)
            spread = {k: _dist_update_l2(np, runs[k][i][0], one[0], arg0)[0]
                      for k in ("plain", "swapped")}
            aux = _rel_l2(np, two[1], one[1], sorted(one[1]))
            aux_spread = {k: _rel_l2(np, runs[k][i][1], one[1], sorted(one[1]))
                          for k in ("plain", "swapped")}
            rec["step%d" % at] = dict(update_l2=l2, worst=worst,
                                      spread=spread, aux_l2=aux,
                                      aux_spread=aux_spread)
        _dist_emit("gate", rank=rank, **rec)
    distributed.barrier("dist_gate_done")


def _dist_cpu_agreement(torch, mx, seed, rank, world, init):
    """One zero3 ResNet-50 step of the ranks at a global batch of
    AGREE_BATCH on the card and on the host (the same gloo group, CPU
    tensors), and on the card with MXTPU_FUSED_KERNELS=0 and with each
    rank's rows reversed for the step's own conditioning: outputs and
    moving statistics within AGREE_REL_TOL x max |cpu|, the update within
    GRAD_L2_FACTOR x the larger distance of those two orders from the
    card's step (at least AGREE_REL_TOL) in relative L2."""
    import numpy as np
    from mxnet_tpu_torch import distributed
    dev = distributed.device()
    n = AGREE_BATCH // world
    rs = np.random.RandomState(seed + 43)
    x = rs.standard_normal((AGREE_BATCH,) + IMAGE).astype(np.float32)
    y = rs.randint(0, 1000, AGREE_BATCH).astype(np.float32)
    x, y = x[rank * n:(rank + 1) * n], y[rank * n:(rank + 1) * n]
    res = {}
    swap = np.arange(n)[::-1].copy()
    for name, ctx, fused, order in (
            ("card", mx.gpu(dev.index), "1", None),
            ("card_plain", mx.gpu(dev.index), "0", None),
            ("card_swapped", mx.gpu(dev.index), "1", swap),
            ("cpu", mx.cpu(), "1", None)):
        xs, ys = (x, y) if order is None else (x[order], y[order])
        with _env("MXTPU_FUSED_KERNELS", fused):
            tr = _dist_resnet_trainer(mx, "zero3", world, n, ctx, *init)
            out = tr.step(xs, ys)[0].float().cpu().numpy()
            res[name] = (out,) + _dist_host(tr)
            tr.close()
    (oc, ac, xc), (oh, ah, xh) = res["card"], res["cpu"]
    l2, worst = _dist_update_l2(np, ac, ah, init[0])
    spread = max(_dist_update_l2(np, res[k][1], ac, init[0])[0]
                 for k in ("card_plain", "card_swapped"))
    _dist_emit("agree", rank=rank,
               out_rel=float(np.abs(oc - oh).max() / np.abs(oh).max()),
               update_l2=l2, worst=worst, spread=spread,
               aux_rel=list(_worst_max_rel(np, xc, xh, sorted(xh))))


def _dist_module_fits(torch, mx, seed, rank, world):
    """ResNet-50 through Module.fit for DIST_FIT_BATCHES batches of 32 a
    rank with kvstore 'dist_sync' (the executor route, the collective
    store) and 'tpu' (the fused step over the mesh): launches a batch,
    and rank 0's weights broadcast equal every rank's."""
    import numpy as np
    from mxnet_tpu_torch import distributed
    ba = mx.kernels.bn_act
    dev = distributed.device()
    rs = np.random.RandomState(seed + 45)
    X = rs.standard_normal((BATCH * world * DIST_FIT_BATCHES,) + IMAGE
                           ).astype(np.float32)
    Y = rs.randint(0, 1000, X.shape[0]).astype(np.float32)
    for kind in ("dist_sync", "tpu"):
        it = mx.io.NDArrayIter(X[rank::world], Y[rank::world],
                               batch_size=BATCH)
        mod = mx.mod.Module(_resnet50(mx), context=mx.gpu(dev.index))
        mx.random.seed(seed)
        f0, b0 = ba.LAUNCHES, ba.BWD_LAUNCHES
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        mod.fit(it, num_epoch=1, kvstore=kind, optimizer="sgd",
                optimizer_params={"learning_rate": 0.05, "momentum": 0.9},
                initializer=mx.initializer.Xavier(rnd_type="gaussian",
                                                  factor_type="in",
                                                  magnitude=2))
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        fwd, bwd = ba.LAUNCHES - f0, ba.BWD_LAUNCHES - b0
        arg, aux = mod.get_params()

        def same(d):
            ok = True
            for k in sorted(d):
                t = d[k]._data.to(dev)
                ok &= bool(torch.equal(t, distributed.broadcast(t.clone())))
            return ok
        # the weights; the moving statistics agree on the fused route
        # (global batch statistics) and not on the executor route, whose
        # executors normalise each rank's own rows
        _dist_emit("fit", rank=rank, kind=kind, fused=mod._fused is not None,
                   fwd=fwd, bwd=bwd, wall_s=wall, identical=same(arg),
                   aux_identical=same(aux))
        del mod
        torch.cuda.empty_cache()


def _dist_mlp_trainer(mx, sync, world, ctx):
    tr = mx.parallel.SPMDTrainer(
        _dist_mlp(mx), "sgd", {"learning_rate": 0.1, "momentum": 0.9,
                               "rescale_grad": 1.0 / DIST_MLP_BATCH},
        mesh=mx.parallel.local_mesh(), grad_sync=sync, ctx=ctx)
    n = DIST_MLP_BATCH // world
    tr.bind([("data", (n, 256))], [("softmax_label", (n,))])
    mx.random.seed(33)
    tr.init_params(mx.initializer.Xavier())
    return tr


def _dist_mlp_data(rank, world):
    import numpy as np
    rs = np.random.RandomState(0)
    out = []
    for _ in range(DIST_MLP_STEPS):
        x = rs.standard_normal((DIST_MLP_BATCH, 256)).astype(np.float32)
        y = rs.randint(0, 10, DIST_MLP_BATCH).astype(np.float32)
        out.append((x[rank::world], y[rank::world]))
    return out


def _dist_zero3_drill(torch, mx, phase, rank, world, ckpt):
    """The zero3 drill on bench.py's MLP: ``baseline`` holds zero3 to
    allreduce bit for bit after DIST_MLP_STEPS steps and emits the
    digest; ``kill`` saves sharded-native at DIST_MLP_SAVE and SIGKILLs
    every rank inside the next step; ``resume`` restores and replays."""
    from mxnet_tpu_torch import distributed
    ctx = mx.gpu(distributed.device().index)
    data = _dist_mlp_data(rank, world)
    if phase == "baseline":
        finals = {}
        for sync in ("allreduce", "zero3"):
            tr = _dist_mlp_trainer(mx, sync, world, ctx)
            for x, y in data:
                tr.step(x, y)
            finals[sync] = tr.get_params()
            if sync == "zero3":
                local = list(tr.params["fc1_weight"].shape)
                res = tr.resident_bytes()
            tr.close()
        a, z = finals["allreduce"][0], finals["zero3"][0]
        diff = max(float(abs(a[k].asnumpy() - z[k].asnumpy()).max())
                   for k in a)
        _dist_emit("zero3", rank=rank, phase=phase, max_diff=diff,
                   local_fc1=local, resident=res,
                   digest=_dist_digest(*finals["zero3"]))
        return
    mgr = mx.resilience.CheckpointManager(ckpt)
    tr = _dist_mlp_trainer(mx, "zero3", world, ctx)
    with _env("MXTPU_CKPT_SHARDED", "1"):
        if phase == "kill":
            for x, y in data[:DIST_MLP_SAVE]:
                tr.step(x, y)
            t0 = time.perf_counter()
            tr.save_checkpoint(mgr, DIST_MLP_SAVE)
            _dist_emit("zero3", rank=rank, phase="saved",
                       save_ms=(time.perf_counter() - t0) * 1e3,
                       blobs=sorted(n for n in os.listdir(ckpt)
                                    if ".params.s" in n))
            tr.step(*data[DIST_MLP_SAVE])
            os.kill(os.getpid(), signal.SIGKILL)
        mx.random.seed(99)
        t0 = time.perf_counter()
        epoch = tr.restore(mgr)
        restore_ms = (time.perf_counter() - t0) * 1e3
    for x, y in data[DIST_MLP_SAVE:]:
        tr.step(x, y)
    _dist_emit("zero3", rank=rank, phase=phase, epoch=epoch,
               restore_ms=restore_ms, digest=_dist_digest(*tr.get_params()))


def _dist_preempt(torch, mx, phase, rank, world, ckpt):
    """bench.py's MLP through Module.fit(kvstore='tpu', checkpoint=...,
    preemption_safe=True): ``baseline`` runs 2 epochs undisturbed;
    ``kill`` delivers SIGTERM to rank 1 alone (the ``preempt`` fault
    point sends the real signal) at boundary DIST_PRE_AT of epoch 2 — both
    ranks agree there, save and leave with 85; ``resume`` continues."""
    import numpy as np
    rs = np.random.RandomState(4)
    n = DIST_MLP_BATCH * DIST_PRE_BATCHES
    X = rs.standard_normal((n, 256)).astype(np.float32)
    Y = rs.randint(0, 10, n).astype(np.float32)
    it = mx.io.NDArrayIter(X[rank::world], Y[rank::world],
                           batch_size=DIST_MLP_BATCH // world)
    if phase == "kill" and rank == 1:
        mx.resilience.faults.arm("preempt", times=1,
                                 after=DIST_PRE_BATCHES + DIST_PRE_AT - 1)
    mod = mx.mod.Module(_dist_mlp(mx))
    mx.random.seed(21)
    code = 0
    t0 = time.perf_counter()
    ends = []
    try:
        mod.fit(it, num_epoch=2, kvstore="tpu", optimizer="sgd",
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
                initializer=mx.initializer.Xavier(), checkpoint=ckpt,
                preemption_safe=True,
                batch_end_callback=lambda p: ends.append(
                    time.perf_counter() - t0))
    except SystemExit as e:
        code = e.code
    wall = time.perf_counter() - t0
    # rank 0 publishes the manifest: every rank reads it after the save
    from mxnet_tpu_torch import distributed
    distributed.barrier("dist_preempt_done")
    rec = {"rank": rank, "phase": phase, "code": code, "wall_s": wall,
           "batch_end_s": ends}
    if code == 0:
        rec["digest"] = _dist_digest(*mod.get_params())
    if code:
        entry = mx.resilience.CheckpointManager(ckpt).latest_entry() or {}
        rec["step_state"] = {k: v for k, v in
                             (entry.get("step_state") or {}).items()
                             if k != "rng"}
    _dist_emit("preempt", **rec)


#: the model-parallel axes across the two ranks (_dist_mp): name ->
#: (mesh axes, the rank of each position, grad_sync, remat); the ranks'
#: positions are all on cuda:0.  (a) tp over the ranks, one position a
#: rank; (b) dp 2 x tp 2 with every tp group across the ranks and dp in
#: each process; (c) the JAX package's layout, dp across the ranks and
#: tp in each process
DMP_CASES = (("a_tp_ranks", {"dp": 1, "tp": 2}, [0, 1], "allreduce",
              False),
             ("b_hybrid", {"dp": 2, "tp": 2}, [0, 1, 0, 1], "allreduce",
              False),
             ("b_hybrid_zero3", {"dp": 2, "tp": 2}, [0, 1, 0, 1], "zero3",
              False),
             ("b_hybrid_zero3_remat", {"dp": 2, "tp": 2}, [0, 1, 0, 1],
              "zero3", True),
             ("c_jax_layout", {"dp": 2, "tp": 2}, [0, 0, 1, 1], "allreduce",
              False))
#: ResNet-50 steps a trainer (the gates read the first update); the LM's
DMP_STEPS = 1
DMP_LM_STEPS = 2
#: (d) the LM's dp 2 x sp 4 with every sp ring over both ranks, (e) the
#: pipeline's pp 4 and MoE's ep 8, positions alternating between ranks
DMP_LM_OWNERS = [0, 1] * 4
DMP_PP_OWNERS = [0, 1] * 2
DMP_MOE_OWNERS = [0, 1] * 4


def _dmp_mesh(mx, axes, owners):
    from mxnet_tpu_torch import distributed
    dev = distributed.device()
    if len(owners) == distributed.num_workers():
        return mx.parallel.build_mesh(axes, list(owners))
    return mx.parallel.build_mesh(axes, [(r, mx.gpu(dev.index))
                                         for r in owners])


def _dmp_stats(distributed):
    """The collectives since the last ``reset_stats`` by kind, each with
    its transport."""
    return {k: dict(v, transport=distributed.TRANSPORTS.get(k, "native"))
            for k, v in distributed.STATS.items() if v["count"]}


def _dmp_refs(torch, mx, rank, init, x, y):
    """Rank 0's references for the first update at the global batch: one
    device's fused and unfused float32 steps and the float64 step."""
    import numpy as np
    from mxnet_tpu_torch import distributed
    if rank != 0:
        return None
    dev = distributed.device()
    runs = {}
    for name, fused in (("one", "1"), ("plain", "0")):
        with _env("MXTPU_FUSED_KERNELS", fused):
            tr = _dist_resnet_trainer(mx, "allreduce", 1, BATCH,
                                      mx.gpu(dev.index), *init)
            tr.step(torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev))
            runs[name] = _dist_host(tr)[0]
            opt = tr.optimizer
            tr.close()
    torch.cuda.empty_cache()
    with _env("MXTPU_FUSED_KERNELS", "0"):
        ref = _executor_step(mx, _resnet50(mx), init, x.astype(np.float64),
                             y.astype(np.float64), mx.gpu(dev.index))
    arg0 = init[0]
    runs["step64"] = {k: arg0[k] - opt.lr * (
        opt.rescale_grad * ref["grad:" + k]
        + opt.wd * opt.wd_mult.get(k, 1.0) * arg0[k]) for k in arg0}
    del ref
    torch.cuda.empty_cache()
    return runs


def _dist_mp(torch, mx, seed, rank, world, init):
    """The model-parallel axes across the two ranks on the card (both on
    cuda:0 over gloo): ResNet-50 at global batch BATCH from the tiers'
    weights through SPMDTrainer with MP_RESNET_RULES on DMP_CASES,
    DMP_STEPS steps each (each rank fed the rows of its dp coordinates),
    under deterministic cuDNN; then the long-context LM, the pipeline
    and MoE on meshes over both ranks.  Gates (rank 0): (a), (b)'s
    allreduce and (c) hold their first update to one device's and to
    float64 as _mp_resnet does; (b)'s zero3, with and without remat,
    equal (b)'s allreduce within MP_ZERO_SAME_TOL, a position holds
    MP_ZERO_SHARE['b'] of params + momentum, and analyze() is clean;
    every step launches 50 + 50 bn_act kernels a position (100 + 50
    with remat); the LM, pipeline and MoE gates are model_parallel_
    paths'.  Emits ms a step, the collectives across the ranks of a step
    by kind (count, bytes, host seconds, transport; every cross-rank
    exchange is one all_gather), bn_act launches and peak memory."""
    import numpy as np
    from mxnet_tpu_torch import distributed
    ba = mx.kernels.bn_act
    dev = distributed.device()
    card = os.environ.get("DIST_CARD", "")  # mxlint: disable=env-direct-read (set by dist_paths)
    rs = np.random.RandomState(seed + 45)
    glob = [(rs.standard_normal((BATCH,) + IMAGE).astype(np.float32),
             rs.randint(0, 1000, BATCH).astype(np.float32))
            for _ in range(DMP_STEPS)]
    t_all = time.perf_counter()
    with _deterministic_cudnn(torch):
        refs = _dmp_refs(torch, mx, rank, init, *glob[0])
        distributed.barrier("dmp_refs")
        firsts = {}
        for name, axes, owners, sync, remat in DMP_CASES:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            mesh = _dmp_mesh(mx, axes, owners)
            held = sorted({mesh.coords(i)["dp"] for i in mesh.local})
            per = BATCH // axes["dp"]
            rows = np.concatenate([np.arange(d * per, (d + 1) * per)
                                   for d in held])
            tr = mx.parallel.SPMDTrainer(
                _resnet50(mx), "sgd", {"learning_rate": 0.1,
                                       "momentum": 0.9, "wd": 1e-4,
                                       "rescale_grad": 1.0 / BATCH},
                mesh=mesh, param_shardings=MP_RESNET_RULES, grad_sync=sync,
                remat=remat, ctx=mx.gpu(dev.index))
            tr.bind([("data", (len(rows),) + IMAGE)],
                    [("softmax_label", (len(rows),))])
            tr.init_params(None, arg_params=init[0], aux_params=init[1])
            spans, fwd, bwd, exch = [], [], [], None
            for i, (x, y) in enumerate(glob):
                xd = torch.from_numpy(x[rows]).to(dev)
                yd = torch.from_numpy(y[rows]).to(dev)
                distributed.reset_stats()
                f0, b0 = ba.LAUNCHES, ba.BWD_LAUNCHES
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                outs = tr.step(xd, yd)
                torch.cuda.synchronize(dev)
                spans.append(time.perf_counter() - t0)
                fwd.append(ba.LAUNCHES - f0)
                bwd.append(ba.BWD_LAUNCHES - b0)
                exch = _dmp_stats(distributed)
                check(bool(torch.isfinite(outs[0]).all()) and
                      outs[0].shape[0] == len(rows),
                      "dist mp %s: step %d outputs" % (name, i))
                if i == 0:
                    firsts[name] = _dist_host(tr)[0]
            res = tr.resident_bytes()
            whole = sum(int(np.prod(tr.arg_shapes[n])) * 4
                        for n in tr.param_names)
            rec = {"rank": rank, "name": name, "ms": [v * 1e3 for v in
                                                      spans[1:]],
                   "first_ms": spans[0] * 1e3, "fwd": fwd, "bwd": bwd,
                   "local": len(mesh.local), "exchanges": exch,
                   "peak": torch.cuda.max_memory_allocated(dev),
                   "share": (res["params"] + res["opt_state"]) /
                   float(2 * whole), "tier": tr.zero3_tier,
                   "forms": sorted(set(tr.tp_forms.values())),
                   "skipped": tr.skipped_steps}
            if sync == "zero3" and not remat:
                x, y = glob[0]
                rep = tr.analyze(torch.from_numpy(x[rows]).to(dev),
                                 torch.from_numpy(y[rows]).to(dev))
                rec["analyze_ok"] = rep.ok
                rec["analyze"] = rep.format_text()[-800:]
            tr.close()
            del tr
            _dist_emit("mp", **rec)
            per_pos = 100 if remat else 50
            check(fwd == [per_pos * len(mesh.local)] * DMP_STEPS and
                  bwd == [50 * len(mesh.local)] * DMP_STEPS,
                  "dist mp %s rank %d: bn_act launches %s + %s"
                  % (name, rank, fwd, bwd))
            check(rec["skipped"] == 0 and exch["all_gather"]["count"] > 0,
                  "dist mp %s: %s" % (name, rec))
            if sync == "zero3":
                check(abs(rec["share"] - MP_ZERO_SHARE["b"]) <=
                      MP_ZERO_SHARE_TOL and rec.get("analyze_ok", True),
                      "dist mp %s: %s" % (name, rec))
        if rank == 0:
            arg0 = init[0]
            spread = _dist_update_l2(np, refs["plain"], refs["one"], arg0)[0]
            f64_one = _dist_update_l2(np, refs["one"], refs["step64"],
                                      arg0)[0]
            gate = {"spread": spread, "f64_one": f64_one}
            for name, _, _, sync, _ in DMP_CASES:
                first = firsts[name]
                if sync == "allreduce":
                    l2 = _dist_update_l2(np, first, refs["one"], arg0)
                    f64 = _dist_update_l2(np, first, refs["step64"],
                                          arg0)[0]
                    gate[name] = {"one": l2[0], "worst": l2[1], "f64": f64}
                    check(l2[0] <= GRAD_L2_FACTOR * max(spread,
                                                        AGREE_REL_TOL)
                          and f64 <= GRAD_L2_FACTOR * max(f64_one,
                                                          AGREE_REL_TOL),
                          "dist mp %s: first update %s (one device's "
                          "spread %.3g, float64 %.3g)" % (name, gate[name],
                                                         spread, f64_one))
                else:
                    same = _dist_update_l2(np, first, firsts["b_hybrid"],
                                           arg0)
                    gate[name] = {"same": same[0], "worst": same[1]}
                    check(same[0] <= MP_ZERO_SAME_TOL,
                          "dist mp %s: %.3g from the mesh's allreduce"
                          % (name, same[0]))
            _dist_emit("mp_gate", **gate)
        del refs, firsts
        torch.cuda.empty_cache()
        resnet_s = time.perf_counter() - t_all
        t0 = time.perf_counter()
        distributed.reset_stats()
        lm = _mp_lm(torch, mx, seed, card, mesh=_dmp_mesh(
            mx, MP_LM_MESH, DMP_LM_OWNERS), steps=DMP_LM_STEPS,
            tag="dist mp rank %d" % rank)
        lm["exchanges"] = _dmp_stats(distributed)
        lm_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        distributed.reset_stats()
        pp = _mp_pipeline(torch, mx, seed, card, mesh=_dmp_mesh(
            mx, {"pp": MP_PP_STAGES}, DMP_PP_OWNERS),
            tag="dist mp rank %d" % rank)
        pp["exchanges"] = _dmp_stats(distributed)
        distributed.reset_stats()
        moe = _mp_moe(torch, mx, seed, card, mesh=_dmp_mesh(
            mx, {"ep": MP_MOE_E}, DMP_MOE_OWNERS),
            tag="dist mp rank %d" % rank)
        moe["exchanges"] = _dmp_stats(distributed)
        ppmoe_s = time.perf_counter() - t0
    _dist_emit("mp_axes", rank=rank, lm=lm, pp=pp, moe=moe,
               seconds={"resnet": resnet_s, "lm": lm_s,
                        "pp_moe": ppmoe_s})


def dist_worker(phase):
    """One rank of ``dist_paths`` (run by tools/launch.py): ``train``,
    ``kill`` or ``resume``."""
    import torch
    torch.set_num_threads(4)
    sys.path.insert(0, ROOT)
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import distributed
    rank, world = distributed.rank(), distributed.num_workers()
    dev = distributed.device()
    check(world == DIST_RANKS and dev is not None and dev.type == "cuda",
          "rank %d: world %d, device %s" % (rank, world, dev))
    check(mx.current_context() == mx.gpu(dev.index),
          "rank %d: current_context() %s, not its card"
          % (rank, mx.current_context()))
    mx.kernels.build(["bn_act"])
    ba = mx.kernels.bn_act
    ba.LAUNCHES = ba.BWD_LAUNCHES = 0
    tmp = os.environ["DIST_DIR"]  # mxlint: disable=env-direct-read (set by dist_paths)
    seed = int(os.environ["DIST_SEED"])  # mxlint: disable=env-direct-read (set by dist_paths)
    _dist_emit("rank", rank=rank, world=world, device=str(dev),
               backend=distributed.backend(),
               transports=dict(distributed.TRANSPORTS))
    t0 = time.perf_counter()
    marks = {}

    def mark(name):
        marks[name] = round(time.perf_counter() - t0, 2)
    if phase == "train":
        glob, init, finals = _dist_tiers(torch, mx, seed, rank, world, None)
        mark("tiers")
        _dist_one_process_gate(torch, mx, rank, world, init, glob, finals)
        mark("gate")
        _dist_cpu_agreement(torch, mx, seed, rank, world, init)
        mark("agreement")
        _dist_module_fits(torch, mx, seed, rank, world)
        mark("fits")
        _dist_zero3_drill(torch, mx, "baseline", rank, world, None)
        mark("zero3")
        _dist_preempt(torch, mx, "baseline", rank, world,
                      os.path.join(tmp, "preempt_base"))
        mark("preempt")
        _dist_mp(torch, mx, seed, rank, world, init)
        mark("model_parallel")
        _dist_emit("marks", rank=rank, phase=phase, seconds=marks)
    elif phase == "kill":
        _dist_preempt(torch, mx, "kill", rank, world,
                      os.path.join(tmp, "preempt"))
        _dist_emit("launches", rank=rank, phase=phase, fwd=ba.LAUNCHES,
                   bwd=ba.BWD_LAUNCHES)
        _dist_zero3_drill(torch, mx, "kill", rank, world,
                          os.path.join(tmp, "zero3"))
    else:
        _dist_zero3_drill(torch, mx, "resume", rank, world,
                          os.path.join(tmp, "zero3"))
        _dist_preempt(torch, mx, "resume", rank, world,
                      os.path.join(tmp, "preempt"))
    _dist_emit("launches", rank=rank, phase=phase, fwd=ba.LAUNCHES,
               bwd=ba.BWD_LAUNCHES)
    distributed.barrier("dist_worker_done")


def _dist_launch(phase, tmp, seed, **env):
    """``tools/launch.py -n DIST_RANKS python chip_smoke.py --dist-worker
    phase`` (no --platform: every rank on the card) in a session of its
    own, so a timeout kills every rank; returns (exit code, records by
    tag, seconds)."""
    wenv = {k: v for k, v in os.environ.items()  # mxlint: disable=env-direct-read (the children's environment)
            if not k.startswith("MXTPU_")}
    wenv.update(DIST_DIR=tmp, DIST_SEED=str(seed),
                CUBLAS_WORKSPACE_CONFIG=":4096:8",
                PYTHONPATH=ROOT + os.pathsep + wenv.get("PYTHONPATH", ""))
    wenv.update(env)
    cmd = [sys.executable, os.path.join(ROOT, "tools", "launch.py"), "-n",
           str(DIST_RANKS), sys.executable, os.path.join(ROOT, "chip_smoke.py"),
           "--dist-worker", phase]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, env=wenv, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=DIST_LAUNCH_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise SmokeFailure("dist %s: no end in %d s:\n%s" % (
            phase, DIST_LAUNCH_TIMEOUT, out[-3000:]))
    secs = time.perf_counter() - t0
    with open(os.path.join(tmp, "launch-%s.log" % phase), "w") as f:
        f.write(out)
    recs = collections.defaultdict(list)
    for line in out.splitlines():
        m = re.search(r"DIST (\w+) (\{.*\})$", line)
        if m:
            recs[m.group(1)].append(json.loads(m.group(2)))
    return proc.returncode, recs, secs, out


def _dist_mp_report(recs, card):
    """dist_paths' lines and checks of _dist_mp's records; returns the
    bn_act launches of its steps over the ranks."""
    names = [c[0] for c in DMP_CASES]
    got = {(r["name"], r["rank"]): r for r in recs["mp"]}
    check(len(got) == len(names) * DIST_RANKS and recs["mp_gate"]
          and len(recs["mp_axes"]) == DIST_RANKS,
          "dist mp: records %s" % sorted(got))
    fwd = bwd = 0
    for name in names:
        for r in range(DIST_RANKS):
            t = got[(name, r)]
            fwd += sum(t["fwd"])
            bwd += sum(t["bwd"])
            e = t["exchanges"]
            log("dist mp %s rank %d (%d positions, forms %s%s): %s ms a "
                "step after the first (first %.1f), bn_act %d + %d a step, "
                "collectives "
                "across the ranks a step (each cross-rank exchange an "
                "all_gather) %s; a position's params + momentum %.4f of "
                "the whole; peak %.2f GiB; %s" % (
                    name, r, t["local"], ",".join(t["forms"]),
                    ", zero3 %s" % t["tier"] if t["tier"] else "",
                    " ".join("%.1f" % v for v in t["ms"]) or "no step",
                    t["first_ms"], t["fwd"][-1], t["bwd"][-1], "; ".join(
                        "%s %d, %.1f MB, %.3f s of host time, transport %s"
                        % (k, v["count"], v["bytes"] / 1e6, v["seconds"],
                           v["transport"]) for k, v in sorted(e.items())),
                    t["share"], t["peak"] / 2 ** 30, card))
            check(t["skipped"] == 0 and e["all_gather"]["count"] > 0
                  and t.get("analyze_ok", True),
                  "dist mp %s rank %d: %s" % (name, r, t))
    gate = recs["mp_gate"][0]
    log("dist mp gate: one device's fused-vs-unfused spread %.3g, its "
        "float64 distance %.3g; %s" % (
            gate["spread"], gate["f64_one"], json.dumps(
                {n: gate[n] for n in names})))
    for a in sorted(recs["mp_axes"], key=lambda r: r["rank"]):
        log("dist mp rank %d: lm dp 2 x sp 4 %s ms a step (first %.1f), "
            "losses %.3g, update %.3g, exchanges %s; pipeline %.1f ms, "
            "exchanges %s; moe %.1f ms, exchanges %s; seconds %s" % (
                a["rank"], " ".join("%.1f" % v for v in a["lm"]["ms"]),
                a["lm"]["first_ms"], a["lm"]["loss_rel"],
                a["lm"]["update_l2"], json.dumps(a["lm"]["exchanges"]),
                a["pp"]["ms"], json.dumps(a["pp"]["exchanges"]),
                a["moe"]["ms"], json.dumps(a["moe"]["exchanges"]),
                json.dumps(a["seconds"])))
    return {"fwd": fwd, "bwd": bwd}


def dist_paths(torch, mx, seed, card):
    """The data-parallel slice on the card: two ranks launched by
    tools/launch.py share cuda:0 and talk over gloo.  Launch 1 trains
    ResNet-50 at full width, 32 images a rank, under each grad_sync
    (launches, ms a step, resident bytes, peak memory, the collectives'
    share of a step, the transports), holds the allreduce update to one
    process at the global batch and a batch-4 zero3 step to the host,
    fits ResNet-50 through Module with 'dist_sync' and 'tpu' (identical
    weights on both ranks), holds zero3 to allreduce bit for bit on
    bench.py's MLP and runs the preemption drill's undisturbed fit.
    Launch 2 preempts rank 1 alone (both ranks must save at the same
    boundary and leave with 85), then saves the zero3 MLP sharded-native
    and SIGKILLs every rank in the next step (the launcher must report
    the failure).  Launch 3 resumes both: digests equal the undisturbed
    runs'.  Returns the ranks' bn_act launches."""
    import numpy as np
    del np
    build_dir = os.path.join(ROOT, "mxnet_tpu_torch", "_build")
    os.makedirs(build_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="dist-", dir=build_dir)
    fwd = bwd = 0
    try:
        rc, recs, secs, out = _dist_launch("train", tmp, seed,
                                           DIST_CARD=card)
        check(rc == 0, "dist train launch exit %d:\n%s" % (rc, out[-4000:]))
        ranks = sorted(recs["rank"], key=lambda r: r["rank"])
        check(len(ranks) == DIST_RANKS
              and all(r["device"] == "cuda:0" for r in ranks)
              and all(r["backend"] == "gloo" for r in ranks),
              "dist ranks: %s" % ranks)
        log("dist: %d ranks on %s over %s, transports %s; launch 1 %.1f s "
            "on %s" % (len(ranks), ranks[0]["device"], ranks[0]["backend"],
                       json.dumps(ranks[0]["transports"]), secs, card))
        tiers = collections.defaultdict(dict)
        for t in recs["tier"]:
            tiers[t["sync"]][t["rank"]] = t
        full = {r: tiers["allreduce"][r]["resident"] for r in range(DIST_RANKS)}
        for sync in DIST_TIERS:
            for r in range(DIST_RANKS):
                t = tiers[sync][r]
                check(t["fwd"] == [50] * DIST_STEPS
                      and t["bwd"] == [50] * DIST_STEPS,
                      "dist %s rank %d: bn_act launches a step %s + %s"
                      % (sync, r, t["fwd"], t["bwd"]))
                check(t["skipped"] == 0, "dist %s: skipped steps" % sync)
                frac = (t["resident"]["params"] + t["resident"]["opt_state"]) \
                    / float(full[r]["params"] + full[r]["opt_state"])
                if sync != "allreduce":
                    check(frac < 0.55, "dist %s rank %d: resident %.3f of "
                          "allreduce's" % (sync, r, frac))
                log("dist %s rank %d: %s ms a step (first %.1f), bn_act "
                    "%d + %d a step, params + optimizer state %d bytes "
                    "(%.4f of allreduce's), peak %.2f GiB, the last step "
                    "%.1f ms of which collectives %.3f (%s)%s" % (
                        sync, r, " ".join("%.1f" % v for v in t["ms"]),
                        t["first_ms"], t["fwd"][0], t["bwd"][0],
                        t["resident"]["params"] + t["resident"]["opt_state"],
                        frac, t["peak"] / 2 ** 30, t["profiled_ms"],
                        t["coll_share"], json.dumps(t["collectives"]),
                        (", %d gather groups" % t["groups"])
                        if sync == "zero3" else ""))
        gate = recs["gate"][0]
        f64 = gate["f64"]
        log("dist gate: the first step's update against float64 (relative "
            "L2): two ranks %.3g, one process %.3g" % (f64["two"],
                                                       f64["one"]))
        check(f64["two"] <= max(AGREE_REL_TOL, GRAD_L2_FACTOR * f64["one"]),
              "dist: the two-rank step is further from float64 than "
              "GRAD_L2_FACTOR x one process's: %s" % f64)
        for key in ("step1", "step%d" % DIST_STEPS):
            g = gate[key]
            log("dist gate %s: two-rank allreduce vs one process at batch %d: "
                "update relative L2 %.3g (worst tensor %.3g %s); the one "
                "process against itself unfused %.3g, with the halves "
                "swapped %.3g; moving statistics %.3g (%.3g, %.3g)" % (
                    key, BATCH * DIST_RANKS, g["update_l2"], g["worst"][0],
                    g["worst"][1], g["spread"]["plain"],
                    g["spread"]["swapped"], g["aux_l2"],
                    g["aux_spread"]["plain"], g["aux_spread"]["swapped"]))
            check(g["update_l2"] <= max(
                AGREE_REL_TOL, GRAD_L2_FACTOR * max(g["spread"].values()))
                and g["aux_l2"] <= max(
                    AGREE_REL_TOL,
                    GRAD_L2_FACTOR * max(g["aux_spread"].values())),
                "dist: two ranks disagree with one process: %s" % gate)
        for a in sorted(recs["agree"], key=lambda r: r["rank"]):
            log("dist agreement rank %d: zero3 at batch %d on the card vs "
                "the host: outputs %.3g of max, update relative L2 %.3g "
                "(worst tensor %.3g %s; the card against itself in other "
                "orders %.3g), "
                "moving statistics %.3g (%s)" % (
                    a["rank"], AGREE_BATCH, a["out_rel"], a["update_l2"],
                    a["worst"][0], a["worst"][1], a["spread"],
                    a["aux_rel"][0], a["aux_rel"][1]))
            check(a["out_rel"] <= AGREE_REL_TOL
                  and a["update_l2"] <= max(AGREE_REL_TOL,
                                            GRAD_L2_FACTOR * a["spread"])
                  and a["aux_rel"][0] <= AGREE_REL_TOL,
                  "dist: card vs host zero3 step: %s" % a)
        for f in sorted(recs["fit"], key=lambda r: (r["kind"], r["rank"])):
            per = 50 * DIST_FIT_BATCHES
            log("dist Module.fit kvstore %r rank %d: %s route, %d batches "
                "in %.1f s, bn_act %d + %d, weights identical on the ranks: "
                "%s (moving statistics: %s)" % (
                    f["kind"], f["rank"],
                    "fused" if f["fused"] else "executor",
                    DIST_FIT_BATCHES, f["wall_s"], f["fwd"], f["bwd"],
                    f["identical"], f["aux_identical"]))
            check(f["identical"] and f["fwd"] == per and f["bwd"] == per
                  and f["fused"] == (f["kind"] == "tpu"),
                  "dist Module.fit: %s" % f)
        z = {r["rank"]: r for r in recs["zero3"]}
        check(all(z[r]["max_diff"] == 0.0 for r in z)
              and len({z[r]["digest"] for r in z}) == 1,
              "dist zero3 MLP vs allreduce: %s" % z)
        base_digest = z[0]["digest"]
        log("dist zero3 MLP: bit-identical to allreduce after %d steps on "
            "both ranks, fc1_weight %s a rank, resident %s" % (
                DIST_MLP_STEPS, z[0]["local_fc1"], json.dumps(z[0]["resident"])))
        pre_base = {r["rank"]: r for r in recs["preempt"]}
        check(len({p["digest"] for p in pre_base.values()}) == 1,
              "dist preemption baseline digests differ")
        mp = _dist_mp_report(recs, card)
        for rec in recs["launches"]:
            fwd += rec["fwd"]
            bwd += rec["bwd"]

        rc, recs, secs, out = _dist_launch("kill", tmp, seed)
        check(rc != 0, "dist kill launch exited 0")
        pre = sorted(recs["preempt"], key=lambda r: r["rank"])
        check(len(pre) == DIST_RANKS and all(p["code"] == 85 for p in pre),
              "dist preemption: exit codes %s" % pre)
        saved = re.findall(r"\[worker (\d)\].*preemption: saved mid-epoch "
                           r"checkpoint \(epoch (\d+), step (\d+)\)", out)
        check(sorted(w for w, _, _ in saved) == ["0", "1"]
              and len({(e, s) for _, e, s in saved}) == 1,
              "dist preemption: saves %s" % saved)
        log("dist preemption: SIGTERM to rank 1 alone; both ranks saved at "
            "epoch %s step %s and left with 85 (%.1f s, %.1f s of fit); "
            "manifest step_state %s" % (
                saved[0][1], saved[0][2], pre[0]["wall_s"], pre[1]["wall_s"],
                json.dumps(pre[0]["step_state"])))
        kill = sorted([r for r in recs["zero3"] if r["phase"] == "saved"],
                      key=lambda r: r["rank"])
        check(len(kill) == DIST_RANKS and
              "checkpoint-0003.params.s001-of-002" in kill[-1]["blobs"],
              "dist zero3 kill: saves %s" % kill)
        log("dist zero3 kill: sharded-native save at step %d (%s, %.1f / "
            "%.1f ms), then SIGKILL of every rank in step %d: launch exit "
            "%d (%.1f s)" % (DIST_MLP_SAVE, kill[-1]["blobs"],
                              kill[0]["save_ms"], kill[1]["save_ms"],
                              DIST_MLP_SAVE + 1, rc, secs))
        for rec in recs["launches"]:
            fwd += rec["fwd"]
            bwd += rec["bwd"]

        rc, recs, secs, out = _dist_launch("resume", tmp, seed,
                                           MXTPU_RESUME="1")
        check(rc == 0, "dist resume launch exit %d:\n%s" % (rc, out[-4000:]))
        z = [r for r in recs["zero3"] if r["phase"] == "resume"]
        check(len(z) == DIST_RANKS and all(
            r["digest"] == base_digest and r["epoch"] == DIST_MLP_SAVE
            for r in z), "dist zero3 resume: %s vs %s" % (z, base_digest))
        pre = [r for r in recs["preempt"] if r["phase"] == "resume"]
        check(len(pre) == DIST_RANKS and all(
            p["code"] == 0 and p["digest"] == pre_base[0]["digest"]
            for p in pre), "dist preemption resume: %s" % pre)
        log("dist resume (%.1f s): zero3 MLP digest equals the undisturbed "
            "run's on both ranks (restore %.1f / %.1f ms); the preempted fit "
            "resumed bit-identical to the uninterrupted one" % (
                secs, z[0]["restore_ms"], z[1]["restore_ms"]))
        for rec in recs["launches"]:
            fwd += rec["fwd"]
            bwd += rec["bwd"]
    finally:
        keep = os.path.join(ROOT, "chiprun_out", "dist")
        os.makedirs(keep, exist_ok=True)
        for name in os.listdir(tmp):
            if name.startswith("launch-"):
                shutil.copy(os.path.join(tmp, name), keep)
        shutil.rmtree(tmp, ignore_errors=True)
    log("dist: bn_act launches over the ranks: %d forward, %d backward "
        "(%d + %d of them on the meshes across the ranks)"
        % (fwd, bwd, mp["fwd"], mp["bwd"]))
    return collections.Counter({"bn_act_fwd": fwd, "bn_act_bwd": bwd})


# ---------------------------------------------------------------------------
# the model-parallel axes inside one process (model_parallel_paths)
# ---------------------------------------------------------------------------

#: ResNet-50 at dp 2 x tp 2 over [gpu(0)] * 4: the rules, the steps
MP_RESNET_MESH = {"dp": 2, "tp": 2}
MP_RESNET_RULES = {r"fc1_weight": ("tp", None),
                   r"stage4_unit\d+_conv\d_weight": ("tp", None, None, None)}
MP_RESNET_STEPS = 2
#: the long-context LM at the example's defaults on its dp 2 x sp 4 mesh
MP_LM_MESH = {"dp": 2, "sp": 4}
MP_LM_STEPS = 2
MP_LM_LOSS_TOL = 1e-4      # |loss - one device's| / one device's
#: pipeline_apply: S stages of tanh(x @ w + b) at width d, batch, M
MP_PP_STAGES, MP_PP_D, MP_PP_BATCH, MP_PP_MICRO = 4, 1024, 256, 8
#: moe_ffn: E experts over ep E, d_model, d_hidden, tokens (B, S)
MP_MOE_E, MP_MOE_D, MP_MOE_H, MP_MOE_TOKENS = 8, 512, 2048, (4, 512)
MP_TOL = 1e-5              # relative to max |reference|: pp and moe results
#: a capacity factor at which some tokens lose both experts
MP_MOE_DROP_CF = 0.25
#: zero and zero3 on the mesh (_mp_zero): part, mesh, rules, grad_sync,
#: remat; a position's predicted share of params + momentum a part, the
#: gate on it, and the steps each trainer takes
MP_ZERO_PARTS = (("a", {"dp": 4}, None, "allreduce", False),
                 ("a", {"dp": 4}, None, "zero", False),
                 ("a", {"dp": 4}, None, "zero3", False),
                 ("b", MP_RESNET_MESH, MP_RESNET_RULES, "zero", False),
                 ("b", MP_RESNET_MESH, MP_RESNET_RULES, "zero3", False),
                 ("c", MP_RESNET_MESH, MP_RESNET_RULES, "zero3", True))
MP_ZERO_SHARE = {"a": 0.25, "b": 0.50, "c": 0.50}
MP_ZERO_SHARE_TOL = 0.02
MP_ZERO_STEPS = 1
#: a zero tier's first update against the same mesh's allreduce where
#: their semantics match (zero; zero3's gspmd tier, with remat or
#: without): the same sums in the same order, so relative L2 <= 1e-6
#: (max-pool's backward adds with atomics: bit-equality not promised)
MP_ZERO_SAME_TOL = 1e-6


def _mp_rel(torch, got, ref):
    """max |got - ref| / max |ref|."""
    top = float(ref.abs().max())
    return float((got - ref).abs().max()) / (top if top > 0 else 1.0)


def _mp_resnet(torch, mx, seed, card):
    """ResNet-50 at global batch BATCH over a dp 2 x tp 2 mesh of
    [gpu(0)] * 4 through SPMDTrainer with MP_RESNET_RULES: the tp form
    each rule took, 50 + 50 bn_act launches a step a position (counts
    zeroed just before each step, read just after), ms a step, the ruled
    params' storage on a position (half the whole), the first step's
    update against the one-device step (within GRAD_L2_FACTOR x the
    one device's fused-vs-unfused distance) and against the float64
    step (as dist_paths holds it), and the gathered params through
    Predictor against the mesh's own forward of the same weights."""
    import numpy as np
    ba = mx.kernels.bn_act
    dev = mx.gpu(0).torch_device
    rs = np.random.RandomState(seed + 43)
    glob = [(rs.standard_normal((BATCH,) + IMAGE).astype(np.float32),
             rs.randint(0, 1000, BATCH).astype(np.float32))
            for _ in range(MP_RESNET_STEPS)]
    one = _dist_resnet_trainer(mx, "allreduce", 1, BATCH, mx.gpu(0), None,
                               None)
    init = _dist_host(one)
    runs = {}
    for name, fused in (("one", "1"), ("plain", "0")):
        with _env("MXTPU_FUSED_KERNELS", fused):
            tr = one if name == "one" else _dist_resnet_trainer(
                mx, "allreduce", 1, BATCH, mx.gpu(0), *init)
            x, y = glob[0]
            tr.step(torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev))
            runs[name] = _dist_host(tr)[0]
            opt = tr.optimizer
            tr.close()
    del one
    torch.cuda.empty_cache()
    with _env("MXTPU_FUSED_KERNELS", "0"):
        ref = _executor_step(mx, _resnet50(mx), init,
                             glob[0][0].astype(np.float64),
                             glob[0][1].astype(np.float64), mx.gpu(0))
    arg0 = init[0]
    step64 = {k: arg0[k] - opt.lr * (
        opt.rescale_grad * ref["grad:" + k]
        + opt.wd * opt.wd_mult.get(k, 1.0) * arg0[k]) for k in arg0}
    del ref
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    mesh = mx.parallel.build_mesh(MP_RESNET_MESH, [mx.gpu(0)] * 4)
    tr = mx.parallel.SPMDTrainer(
        _resnet50(mx), "sgd", {"learning_rate": 0.1, "momentum": 0.9,
                               "wd": 1e-4, "rescale_grad": 1.0 / BATCH},
        mesh=mesh, param_shardings=MP_RESNET_RULES, ctx=mx.gpu(0))
    tr.bind([("data", (BATCH,) + IMAGE)], [("softmax_label", (BATCH,))])
    tr.init_params(None, arg_params=init[0], aux_params=init[1])
    ruled = sorted(tr.tp_forms)
    log("mp resnet: tp forms %s" % json.dumps(
        collections.Counter(tr.tp_forms.values())))
    check(len(ruled) == 10 and set(tr.tp_forms.values()) == {"column"},
          "mp resnet: the 10 ruled weights take the column form: %s"
          % tr.tp_forms)
    whole = sum(int(np.prod(tr.arg_shapes[n])) * 4 for n in ruled)
    held = tr.resident_bytes(position=0, names=ruled)
    log("mp resnet: ruled params %d bytes whole, %d held a position "
        "(optimizer state %d)" % (whole, held["params"],
                                  held["opt_state"]))
    check(held["params"] * 2 == whole and held["opt_state"] * 2 == whole,
          "mp resnet: a position holds half of the ruled params: %s of %d"
          % (held, whole))
    spans, fwd, bwd, first = [], [], [], None
    for i, (x, y) in enumerate(glob):
        xd, yd = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
        torch.cuda.synchronize(dev)
        # -- the main path: counts zeroed just before, read just after ----
        ba.LAUNCHES = ba.BWD_LAUNCHES = 0
        t0 = time.perf_counter()
        outs = tr.step(xd, yd)
        torch.cuda.synchronize(dev)
        spans.append(time.perf_counter() - t0)
        fwd.append(ba.LAUNCHES)
        bwd.append(ba.BWD_LAUNCHES)
        check(bool(torch.isfinite(outs[0]).all()),
              "mp resnet: step %d outputs finite" % i)
        if i == 0:
            first = _dist_host(tr)[0]
    log("mp resnet: bn_act launches a step %s forward, %s backward; ms a "
        "step %s (first %.1f); peak %.2f GiB; %s" % (
            fwd, bwd, ["%.1f" % (v * 1e3) for v in spans[1:]],
            spans[0] * 1e3, torch.cuda.max_memory_allocated(dev) / 2 ** 30,
            card))
    per = 50 * mesh.size
    check(fwd == [per] * MP_RESNET_STEPS and bwd == [per] * MP_RESNET_STEPS,
          "mp resnet: %d + %d bn_act launches a step (50 + 50 a position): "
          "%s, %s" % (per, per, fwd, bwd))
    check(tr.skipped_steps == 0, "mp resnet: no guard-skipped step")
    l2_one = _dist_update_l2(np, first, runs["one"], arg0)
    spread = _dist_update_l2(np, runs["plain"], runs["one"], arg0)[0]
    f64_mesh = _dist_update_l2(np, first, step64, arg0)[0]
    f64_one = _dist_update_l2(np, runs["one"], step64, arg0)[0]
    log("mp resnet: step 1 update vs one device %.3g (worst %s), one "
        "device's fused-vs-unfused %.3g; vs float64: mesh %.3g, one device "
        "%.3g" % (l2_one[0], l2_one[1], spread, f64_mesh, f64_one))
    check(l2_one[0] <= GRAD_L2_FACTOR * max(spread, AGREE_REL_TOL),
          "mp resnet: step 1 update %.3g from one device's (bound %.3g)"
          % (l2_one[0], GRAD_L2_FACTOR * max(spread, AGREE_REL_TOL)))
    check(f64_mesh <= GRAD_L2_FACTOR * max(f64_one, AGREE_REL_TOL),
          "mp resnet: step 1 update %.3g from float64 (bound %.3g)"
          % (f64_mesh, GRAD_L2_FACTOR * max(f64_one, AGREE_REL_TOL)))
    # the gathered params through Predictor: the mesh's inference forward
    # of the same weights
    args, aux = tr.get_params()
    x = torch.from_numpy(glob[0][0]).to(dev)
    mine = tr.eval_step(x, torch.from_numpy(glob[0][1]).to(dev))[0]
    pred = mx.predict.Predictor(_resnet50(mx), _with_prefixes(args, aux),
                                {"data": x.shape}, ctx=mx.gpu(0))
    got = torch.as_tensor(pred.forward(data=glob[0][0]).get_output(0)).to(
        dev)
    rel = _mp_rel(torch, got, mine)
    log("mp resnet: Predictor of the gathered params vs the mesh's "
        "forward: max |diff| / max %.3g" % rel)
    check(rel <= AGREE_REL_TOL, "mp resnet: Predictor %.3g from the mesh's "
          "forward" % rel)
    tr.close()
    return {"ms": [v * 1e3 for v in spans[1:]], "fwd": sum(fwd),
            "bwd": sum(bwd), "init": init, "batches": glob,
            "step64": step64, "first": first, "spread": spread,
            "f64_one": f64_one, "lr": opt.lr, "wd": opt.wd,
            "rescale": opt.rescale_grad,
            "wd_mult": dict(opt.wd_mult)}


def _mp_zero_trainer(mx, axes, rules, sync, remat, init):
    import numpy as np
    mesh = mx.parallel.build_mesh(axes, [mx.gpu(0)] * int(
        np.prod(list(axes.values()))))
    tr = mx.parallel.SPMDTrainer(
        _resnet50(mx), "sgd", {"learning_rate": 0.1, "momentum": 0.9,
                               "wd": 1e-4, "rescale_grad": 1.0 / BATCH},
        mesh=mesh, param_shardings=rules, grad_sync=sync, remat=remat,
        ctx=mx.gpu(0))
    tr.bind([("data", (BATCH,) + IMAGE)], [("softmax_label", (BATCH,))])
    tr.init_params(None, arg_params=init[0], aux_params=init[1])
    return tr


def _mp_zero_manual64(np, mx, base):
    """The first update of zero3's manual tier at dp 4 in float64: each
    position's rows through their own BatchNorm statistics (four
    executor steps of BATCH / 4 rows), the gradients summed."""
    arg0 = base["init"][0]
    x, y = base["batches"][0]
    n = BATCH // 4
    grads = None
    with _env("MXTPU_FUSED_KERNELS", "0"):
        for k in range(4):
            ref = _executor_step(mx, _resnet50(mx), base["init"],
                                 x[k * n:(k + 1) * n].astype(np.float64),
                                 y[k * n:(k + 1) * n].astype(np.float64),
                                 mx.gpu(0))
            part = {k2: ref["grad:" + k2] for k2 in arg0}
            grads = part if grads is None else {
                k2: grads[k2] + part[k2] for k2 in arg0}
            del ref
    return {k: arg0[k] - base["lr"] * (
        base["rescale"] * grads[k]
        + base["wd"] * base["wd_mult"].get(k, 1.0) * arg0[k]) for k in arg0}


def _mp_zero(torch, mx, seed, card, base):
    """zero and zero3 on the in-process mesh: ResNet-50 at global batch
    BATCH over [gpu(0)] * 4 from _mp_resnet's weights and batches, under
    model_parallel_paths' deterministic cuDNN.  Parts (MP_ZERO_PARTS):
    (a) dp 4 under allreduce, zero and zero3 (the manual tier); (b) dp 2
    x tp 2 with MP_RESNET_RULES under zero and zero3 (the gspmd tier);
    (c) (b)'s zero3 with remat; (d) analyze of (a)'s and (b)'s zero3,
    and a sharded-native checkpoint of (a)'s zero3 restored onto (b)'s
    zero3 trainer.  Each trainer: 50 + 50 bn_act launches a step a
    position (100 + 50 with remat, whose backward recomputes the
    forward; counts zeroed just before each step, read just after), ms
    a step, a position's params + momentum against the whole (within
    MP_ZERO_SHARE_TOL of MP_ZERO_SHARE under zero and zero3), peak
    memory, and the first update against the float64 step within
    GRAD_L2_FACTOR x the one device's distance (_mp_resnet's gate) and,
    under zero and zero3's gspmd tier, against the same mesh's allreduce
    update within MP_ZERO_SAME_TOL (dp 4's allreduce against dp 2 x tp
    2's within _mp_resnet's gate); the manual tier's per-position
    statistics are held to their own float64 step (_mp_zero_manual64)
    instead of allreduce's."""
    import pickle
    import numpy as np
    ba = mx.kernels.bn_act
    dev = mx.gpu(0).torch_device
    arg0 = base["init"][0]
    whole = sum(int(v.size) * 4 for v in arg0.values())
    batches = [tuple(torch.from_numpy(a).to(dev) for a in b)
               for b in base["batches"][:MP_ZERO_STEPS]]
    ckpt = os.path.join(ROOT, "mxnet_tpu_torch", "_build", "mp_zero_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    # the same mesh's allreduce update: (a)'s own allreduce trainer runs
    # first (and is held to _mp_resnet's dp 2 x tp 2 allreduce update)
    firsts = {"a": base["first"], "b": base["first"], "c": base["first"]}
    manual64 = None
    fwd_all = bwd_all = 0
    out = {}
    saved = None
    for part, axes, rules, sync, remat in MP_ZERO_PARTS:
        label = "mp zero (%s) %s %s%s" % (
            part, "x".join("%s%d" % kv for kv in axes.items()), sync,
            " remat" if remat else "")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        tr = _mp_zero_trainer(mx, axes, rules, sync, remat,
                              base["init"])
        n = tr.mesh.size
        held = tr.resident_bytes(position=0)
        share = (held["params"] + held["opt_state"]) / (2.0 * whole)
        spans, fwd, bwd = [], [], []
        for i, (x, y) in enumerate(batches):
            torch.cuda.synchronize(dev)
            # -- the main path: counts zeroed just before, read after
            ba.LAUNCHES = ba.BWD_LAUNCHES = 0
            t0 = time.perf_counter()
            outs = tr.step(x, y)
            torch.cuda.synchronize(dev)
            spans.append(time.perf_counter() - t0)
            fwd.append(ba.LAUNCHES)
            bwd.append(ba.BWD_LAUNCHES)
            check(bool(torch.isfinite(outs[0]).all()),
                  "%s: step %d outputs finite" % (label, i))
            if i == 0:
                first = _dist_host(tr)[0]
        fwd_all += sum(fwd)
        bwd_all += sum(bwd)
        log("%s: tier %s, bn_act launches a step %s forward, %s "
            "backward; ms a step %.1f (first %.1f); a position holds "
            "%d + %d bytes of params + momentum, %.4f of the whole; "
            "peak %.2f GiB; %s" % (
                label, tr.zero3_tier, fwd, bwd, spans[-1] * 1e3,
                spans[0] * 1e3, held["params"], held["opt_state"],
                share, torch.cuda.max_memory_allocated(dev) / 2 ** 30,
                card))
        # remat: the backward recomputes every segment's forward, so
        # each BatchNorm site launches its forward kernel twice
        per = 50 * n * (2 if remat else 1)
        check(fwd == [per] * len(batches) and
              bwd == [50 * n] * len(batches),
              "%s: %d + 50 bn_act launches a step a position: %s, %s"
              % (label, per // n, fwd, bwd))
        check(tr.skipped_steps == 0, "%s: no guard-skipped step" % label)
        if sync != "allreduce":
            want = MP_ZERO_SHARE[part]
            check(abs(share - want) <= MP_ZERO_SHARE_TOL,
                  "%s: a position holds %.4f of params + momentum "
                  "(predicted %.2f)" % (label, share, want))
        manual = tr.zero3_tier == "manual"
        # allreduce at dp 4 is held to dp 2 x tp 2's allreduce (another
        # mesh: _mp_resnet's gate); a zero tier to its own mesh's
        bound = GRAD_L2_FACTOR * max(base["spread"], AGREE_REL_TOL) \
            if sync == "allreduce" else MP_ZERO_SAME_TOL
        f64_bound = GRAD_L2_FACTOR * max(base["f64_one"], AGREE_REL_TOL)
        if manual:
            if manual64 is None:
                manual64 = _mp_zero_manual64(np, mx, base)
            f64 = _dist_update_l2(np, first, manual64, arg0)[0]
            log("%s: step 1 update vs its own float64 step (per-"
                "position statistics) %.3g (bound %.3g)"
                % (label, f64, f64_bound))
        else:
            f64 = _dist_update_l2(np, first, base["step64"], arg0)[0]
            l2 = _dist_update_l2(np, first, firsts[part], arg0)
            same = all(np.array_equal(first[k], firsts[part][k])
                       for k in arg0)
            log("%s: step 1 update vs the mesh's allreduce %.3g "
                "(worst %s, bit-equal %s; bound %.3g), vs float64 "
                "%.3g (bound %.3g)" % (label, l2[0], l2[1], same,
                                       bound, f64, f64_bound))
            check(l2[0] <= bound, "%s: step 1 update %.3g from the "
                  "mesh's allreduce (bound %.3g)" % (label, l2[0],
                                                    bound))
        check(f64 <= f64_bound, "%s: step 1 update %.3g from float64 "
              "(bound %.3g)" % (label, f64, f64_bound))
        row = {"tier": tr.zero3_tier, "ms": spans[-1] * 1e3,
               "share": share, "fwd": fwd, "bwd": bwd,
               "peak": torch.cuda.max_memory_allocated(dev)}
        if sync == "zero3" and not remat:
            # (d): analyze on the mesh; (a)'s zero3 saves, (b)'s
            # restores
            x, y = batches[0]
            t0 = time.perf_counter()
            rep = tr.analyze(x, y)
            coll = rep.stats["data_axis_collectives"]
            log("%s: analyze ok %s in %.1f s, dp collectives %s, "
                "expected gather %d bytes, owed all-reduce %d bytes; "
                "findings %s" % (
                    label, rep.ok, time.perf_counter() - t0,
                    json.dumps({k: v for k, v in coll.items()
                                if v["count"]}),
                    *tr._zero3_schedule_bytes(),
                    [f.rule for f in rep.findings]))
            check(rep.ok and coll["all-gather"]["count"] > 0 and
                  coll["reduce-scatter"]["count"] > 0,
                  "%s: analyze ok with all-gathers and reduce-"
                  "scatters: %s" % (label, rep.format_text()))
            row["analyze"] = {k: v for k, v in coll.items()
                              if v["count"]}
            mgr = mx.resilience.CheckpointManager(ckpt)
            if part == "a":
                with _env("MXTPU_CKPT_SHARDED", "1"):
                    tr.save_checkpoint(mgr, 1)
                entry = mgr.entry(1)
                check(entry["format"] == 2 and
                      entry["shard_set"]["world"] == 4,
                      "%s: a sharded-native entry of 4 blobs" % label)
                saved = (_dist_host(tr), tr.get_states())
            else:
                check(tr.restore(mgr) == 1, "%s: restored" % label)
                got = _dist_host(tr)
                a_states = pickle.loads(saved[1])
                b_states = pickle.loads(tr.get_states())
                equal = all(
                    np.array_equal(got[j][k], saved[0][j][k])
                    for j in (0, 1) for k in saved[0][j]) and \
                    a_states["num_update"] == b_states["num_update"] \
                    and all(np.array_equal(np.asarray(s),
                                           np.asarray(t))
                            for k, v in a_states["states"].items()
                            for s, t in zip(v, b_states["states"][k]))
                log("%s: the dp 4 sharded-native checkpoint restored "
                    "onto dp 2 x tp 2: params, aux, momentum and "
                    "num_update bit-equal %s" % (label, equal))
                check(equal, "%s: sharded-native dp 4 checkpoint "
                      "restored bit-equal onto dp 2 x tp 2" % label)
                row["restored_bit_equal"] = equal
        if sync == "allreduce":
            firsts[part] = first
        out["%s_%s%s" % (part, sync, "_remat" if remat else "")] = row
        tr.close()
        del tr
    shutil.rmtree(ckpt, ignore_errors=True)
    return {"parts": out, "fwd": fwd_all, "bwd": bwd_all}


def _mp_lm(torch, mx, seed, card, mesh=None, steps=MP_LM_STEPS, tag="mp"):
    """The long-context LM at the example's defaults on its dp 2 x sp 4
    mesh over [gpu(0)] * 8 (the ring over sp; or ``mesh``, which may
    span ranks: every rank runs the same steps), against the one-device
    make_step on the same batches from the same weights: losses and the
    updated params, ms a step."""
    import numpy as np
    lm = mx.models.long_context_lm
    if mesh is None:
        mesh = mx.parallel.build_mesh(MP_LM_MESH, [mx.gpu(0)] * 8)
    p_one = _lc_params(torch, mx, seed, mx.gpu(0))
    p_mesh = mx.parallel.collectives.tree_map(lambda t: t.clone(), p_one)
    batches = _lc_batches(torch, mx, steps, LC_SEQ, seed + 71)

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, prefix + k + "/") if isinstance(v, dict)
                       else {prefix + k: np.array(v, copy=True)})
        return out
    start = flat(lm.params_to_numpy(p_one))
    one = lm.make_step(None, LC_HEADS, LC_LAYERS, LC_LR)
    on_mesh = lm.make_step(mesh, LC_HEADS, LC_LAYERS, LC_LR)
    spans, losses = [], []
    for x, y in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, lm_loss = on_mesh(p_mesh, x, y)
        torch.cuda.synchronize()
        spans.append(time.perf_counter() - t0)
        _, lo = one(p_one, x, y)
        losses.append((float(lm_loss), float(lo)))
    got, ref = lm.params_to_numpy(p_mesh), lm.params_to_numpy(p_one)
    got, ref = flat(got), flat(ref)
    l2 = _dist_update_l2(np, got, ref, start)
    worst_loss = max(abs(a - b) / abs(b) for a, b in losses)
    log("%s lm: dp 2 x sp 4 losses %s vs one device's %s (worst rel "
        "%.3g); update rel L2 %.3g (worst %s); ms a step %s (first %.1f); "
        "%s" % (tag, ["%.5f" % a for a, _ in losses],
                ["%.5f" % b for _, b in losses], worst_loss, l2[0], l2[1],
                ["%.1f" % (v * 1e3) for v in spans[1:]], spans[0] * 1e3,
                card))
    check(all(np.isfinite(a) for a, _ in losses), "%s lm: finite losses"
          % tag)
    check(worst_loss <= MP_LM_LOSS_TOL, "%s lm: losses %.3g from one "
          "device's" % (tag, worst_loss))
    check(l2[0] <= LC_GRAD_L2_TOL, "%s lm: params' update %.3g from one "
          "device's (relative L2)" % (tag, l2[0]))
    return {"ms": [v * 1e3 for v in spans[1:]], "first_ms": spans[0] * 1e3,
            "loss_rel": worst_loss, "update_l2": l2[0]}


def _mp_pipeline(torch, mx, seed, card, mesh=None, tag="mp"):
    """pipeline_apply over pp 4 of [gpu(0)] * 4 (or ``mesh``, which may
    span ranks): S stages of tanh(x @ w + b) at width MP_PP_D, batch
    MP_PP_BATCH, MP_PP_MICRO microbatches; the result and the input's
    gradient against the sequential composition."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed + 75)
    dev = mx.gpu(0).torch_device
    d = MP_PP_D
    per = [{"w": (torch.randn((d, d), generator=gen) / d ** 0.5).to(dev),
            "b": (torch.randn((d,), generator=gen) * 0.1).to(dev)}
           for _ in range(MP_PP_STAGES)]
    x = torch.randn((MP_PP_BATCH, d), generator=gen).to(dev)
    cot = torch.randn((MP_PP_BATCH, d), generator=gen).to(dev)
    if mesh is None:
        mesh = mx.parallel.build_mesh({"pp": MP_PP_STAGES},
                                      [mx.gpu(0)] * MP_PP_STAGES)

    def stage(p, a):
        return torch.tanh(a @ p["w"] + p["b"])
    xs = x.clone().requires_grad_(True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = mx.parallel.pipeline_apply(
        stage, mx.parallel.stack_stage_params(per), xs, mesh,
        n_microbatch=MP_PP_MICRO)
    (gx,) = torch.autograd.grad((out * cot).sum(), xs)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    xr = x.clone().requires_grad_(True)
    ref = xr
    for p in per:
        ref = stage(p, ref)
    (gr,) = torch.autograd.grad((ref * cot).sum(), xr)
    errs = (_mp_rel(torch, out.detach(), ref.detach()), _mp_rel(torch, gx, gr))
    log("%s pipeline: S %d, d %d, batch %d, M %d: result %.3g, input "
        "gradient %.3g (max |diff| / max), forward+backward %.1f ms; %s"
        % (tag, MP_PP_STAGES, d, MP_PP_BATCH, MP_PP_MICRO, errs[0], errs[1],
           ms, card))
    check(max(errs) <= MP_TOL, "%s pipeline: %.3g / %.3g from the "
          "sequential composition" % ((tag,) + errs))
    return {"ms": ms, "errs": list(errs)}


def _mp_moe_reference(torch, tok, params, every, cf):
    """The top-2 mix at capacity factor ``cf``, computed here from the
    JAX package's contract (not the port's routing): softmax gates, the
    two largest renormalized, each choice's slot its rank among the
    earlier tokens of that choice for that expert (the second choice's
    after all kept first choices), a slot past ceil(cf * T * 2 / E)
    dropped.  ``every`` (T, E, d) is every expert's FFN on every token.
    Returns (mix (T, d), experts kept a token (T,), capacity)."""
    T, E = tok.shape[0], params["w1"].shape[0]
    cap = int(math.ceil(cf * T * 2 / E))
    top, idx = torch.topk(torch.softmax(tok @ params["gate"], dim=-1), 2,
                          dim=-1)
    g = top / top.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    rows = torch.arange(T, device=tok.device)
    prior = torch.zeros(E, device=tok.device)
    mix = torch.zeros_like(tok)
    kept = torch.zeros(T, dtype=torch.int64, device=tok.device)
    for c in range(2):
        onehot = torch.nn.functional.one_hot(idx[:, c], E).to(tok.dtype)
        slot = (torch.cumsum(onehot, dim=0) - onehot + prior)[rows, idx[:, c]]
        keep = slot < cap
        prior = prior + (onehot * keep[:, None]).sum(dim=0)
        mix = mix + every[rows, idx[:, c]] * (g[:, c] * keep)[:, None]
        kept += keep.to(torch.int64)
    return mix, kept, cap


def _mp_moe(torch, mx, seed, card, mesh=None, tag="mp"):
    """moe_ffn with E experts over ep E of [gpu(0)] * E (or ``mesh``,
    which may span ranks) against the top-2
    mix computed here (:func:`_mp_moe_reference`) at capacity factor E
    (nothing drops), 1.0 and MP_MOE_DROP_CF, where some tokens must lose
    both experts and get exactly zero rows."""
    P = mx.parallel
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed + 80)
    dev = mx.gpu(0).torch_device
    E = MP_MOE_E
    params = P.moe_init(gen, MP_MOE_D, MP_MOE_H, E, ctx=mx.gpu(0))
    x = torch.randn(MP_MOE_TOKENS + (MP_MOE_D,), generator=gen).to(dev)
    if mesh is None:
        mesh = P.build_mesh({"ep": E}, [mx.gpu(0)] * E)
    placed = P.collectives.shard_tree(params, mesh, P.moe_shardings("ep"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = P.moe_ffn(placed, x, capacity_factor=E)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    # every expert's FFN on every token
    tok = x.reshape(-1, MP_MOE_D)
    h = torch.relu(torch.einsum("td,edh->teh", tok, params["w1"])
                   + params["b1"][None])
    every = torch.einsum("teh,ehd->ted", h, params["w2"]) + params["b2"][None]
    del h
    errs, notes = [], []
    for cf in (E, 1.0, MP_MOE_DROP_CF):
        got = out if cf == E else P.moe_ffn(placed, x, capacity_factor=cf)
        ref, kept, cap = _mp_moe_reference(torch, tok, params, every, cf)
        got = got.reshape(-1, MP_MOE_D)
        errs.append(_mp_rel(torch, got, ref))
        both = kept == 0
        zero = float(got[both].abs().max()) if bool(both.any()) else None
        notes.append("capacity factor %g (capacity %d): %.3g, %d of %d "
                     "tokens lost an expert, %d both (max |row| %s)"
                     % (cf, cap, errs[-1], int((kept < 2).sum()),
                        tok.shape[0], int(both.sum()), zero))
    del every
    log("%s moe: E %d over ep %d, d %d, h %d, tokens %s, %.1f ms at "
        "capacity factor E; against the top-2 mix: %s; %s"
        % (tag, E, E, MP_MOE_D, MP_MOE_H, MP_MOE_TOKENS, ms,
           "; ".join(notes), card))
    check(max(errs) <= MP_TOL * 10, "%s moe: %s from the top-2 mix"
          % (tag, ", ".join("%.3g" % e for e in errs)))
    check(int(both.sum()) > 0 and zero == 0.0,
          "%s moe: at capacity factor %g tokens lose both experts (%d) "
          "and get zero rows (max %s)" % (tag, MP_MOE_DROP_CF,
                                          int(both.sum()), zero))
    return {"ms": ms, "errs": errs}


def model_parallel_paths(torch, mx, seed, card):
    """The model-parallel axes inside one process on the card: every mesh
    position a [gpu(0)] context, float32 with TF32 off.  ResNet-50 at dp
    2 x tp 2 through SPMDTrainer, zero and zero3 on the mesh (_mp_zero),
    the long-context LM at dp 2 x sp 4, pipeline_apply over pp 4 and
    moe_ffn over ep 8 (see each phase).  Returns the bn_act launches of
    the ResNet-50 steps."""
    # deterministic cuDNN, so that the zero tiers' updates can equal the
    # same mesh's allreduce update bit for bit
    with _deterministic_cudnn(torch):
        res = _mp_resnet(torch, mx, seed, card)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        zero = _mp_zero(torch, mx, seed, card, res)
        zero_s = time.perf_counter() - t0
    log("mp zero: %.1f s" % zero_s)
    del res["init"], res["batches"], res["step64"], res["first"]
    torch.cuda.empty_cache()
    lm = _mp_lm(torch, mx, seed, card)
    pp = _mp_pipeline(torch, mx, seed, card)
    moe = _mp_moe(torch, mx, seed, card)
    torch.cuda.empty_cache()
    log(json.dumps({"model_parallel": {"resnet_dp2_tp2_ms": res["ms"],
                                       "zero": zero["parts"],
                                       "zero_seconds": zero_s,
                                       "lm_dp2_sp4_ms": lm["ms"],
                                       "pipeline_ms": pp["ms"],
                                       "moe_ms": moe["ms"], "card": card}}))
    return collections.Counter({"bn_act_fwd": res["fwd"] + zero["fwd"],
                                "bn_act_bwd": res["bwd"] + zero["bwd"]})


# ---------------------------------------------------------------------------
# the region drill and group2ctx across devices (region_paths)
# ---------------------------------------------------------------------------

REGION_MAIN = os.path.join(ROOT, "mxnet_tpu_torch", "region", "region_main.py")
RG_CONTEXT = "gpu(0)"   # the trainer's positions and the replicas' card
#: the drill's own timeouts, well inside this script's limit (the storm's
#: spec is otherwise the JAX package's preset: schedule, epochs, roles)
RG_SPEC = {"bringup_timeout_s": 240, "settle_timeout_s": 240}
RG_DRILL_S = 420        # the longest the whole drill may take
RG_EVENTS = ("kill:data#0", "resize:trainer", "arm:trainer:rot_checkpoint",
             "kill:replica#1")
#: the region's bring-up milestones (its stderr lines), in order
RG_MILESTONES = (("dataset", "region: dataset:"),
                 ("data", "region: data#%d listening"),
                 ("trainer", "region: trainer published verified epoch"),
                 ("fleet", "region: fleet router on port"),
                 ("serving", "region: trainer released (go)"),
                 ("up", "region: region is up"),
                 ("resize", "region: STORM fired resize:trainer"))
#: example/model-parallel-lstm/lstm_ctx_group.py's defaults
RG_LSTM = {"seq_len": 16, "num_layers": 2, "num_hidden": 64, "vocab": 100}
RG_LSTM_BATCH = 16
RG_LSTM_LR = 0.5
RG_LSTM_STEPS = 3
RG_LSTM_FLOOR = 1e-5    # the placed LSTM's agreement floor: float32 rounding
                        # over 16 steps at hidden 64 is about 1e-7
RG_GROUPS = {"embed": "cpu", "layer0": "gpu", "layer1": "cpu", "out": "gpu"}


def _rg_drill(torch, tmp):
    """``region_main.py storm --context gpu(0)`` as a subprocess: its
    report, its stderr lines stamped with their arrival (wall clock) and
    the trainer's timing lines."""
    import threading
    run_dir = os.path.join(tmp, "region")
    spec = os.path.join(tmp, "region-spec.json")
    report = os.path.join(tmp, "region-report.json")
    with open(spec, "w") as f:
        json.dump(RG_SPEC, f)
    env = dict(os.environ)
    for k in ("MXTPU_FAULTS", "MXTPU_RESUME", "CUDA_VISIBLE_DEVICES"):
        env.pop(k, None)
    t0 = time.time()
    # its own process group: every process of the region goes with it
    proc = subprocess.Popen(
        [sys.executable, REGION_MAIN, "storm", "--context", RG_CONTEXT,
         "--spec", spec, "--run-dir", run_dir, "--report", report],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=tmp, start_new_session=True)
    lines = []

    def drain(stream, out):
        for line in stream:
            out.append((time.time(), line.rstrip("\n")))
    stdout = []
    readers = [threading.Thread(target=drain, args=(proc.stderr, lines),
                                daemon=True),
               threading.Thread(target=drain, args=(proc.stdout, stdout),
                                daemon=True)]
    for r in readers:
        r.start()
    try:
        rc = proc.wait(timeout=RG_DRILL_S)
    except subprocess.TimeoutExpired:
        rc = None
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()
        for r in readers:
            r.join(timeout=10)
    elapsed = time.time() - t0
    keep = os.path.join(ROOT, "chiprun_out", "region")
    os.makedirs(keep, exist_ok=True)
    with open(os.path.join(keep, "region.err"), "w") as f:
        f.write("\n".join("%.3f %s" % (t - t0, ln) for t, ln in lines))
    for name in ("trainer.log", "fleet.log"):
        if os.path.exists(os.path.join(run_dir, name)):
            shutil.copy(os.path.join(run_dir, name), keep)
    check(rc == 0 and os.path.exists(report),
          "region storm exited %s after %.1f s (chiprun_out/region/): %s"
          % (rc, elapsed, " | ".join(ln for _t, ln in lines[-12:])))
    with open(report) as f:
        doc = json.load(f)
    times = []
    with open(os.path.join(run_dir, "trainer.log")) as f:
        for ln in f:
            if ln.startswith("REGION_TRAINER_TIMES "):
                times.append(json.loads(ln[len("REGION_TRAINER_TIMES "):]))
    return doc, lines, times, stdout, t0, elapsed


def _rg_bringup(lines, t0, data_servers):
    """Seconds from the drill's start to each milestone, and each role's
    own bring-up (from the milestone before it)."""
    at = {}
    for name, prefix in RG_MILESTONES:
        if name == "data":
            prefix = prefix % (data_servers - 1)
        hit = [t for t, ln in lines if ln.startswith(prefix)]
        at[name] = hit[0] - t0 if hit else None
    check(all(v is not None for v in at.values()),
          "region storm: milestones missing from its log: %s" % at)
    roles = {"dataset": at["dataset"],
             "data_servers": at["data"] - at["dataset"],
             "trainer_first_publish": at["trainer"] - at["data"],
             "fleet_router": at["fleet"] - at["trainer"],
             "replicas_serving": at["serving"] - at["fleet"]}
    return at, roles


def _rg_storm(torch, tmp):
    """(a) of region_paths: the STORM drill on the card, gated as the JAX
    package's test_region_storm_drill gates it."""
    import numpy as np
    doc, lines, times, stdout, t0, elapsed = _rg_drill(torch, tmp)
    checks = doc["checks"]
    stats = doc["stats"]
    events = stats["events"]
    log("region storm: report ok=%s after %.1f s; checks %s"
        % (doc["ok"], elapsed, json.dumps(checks, sort_keys=True)))
    log("region storm: events %s" % json.dumps(events, sort_keys=True))
    check(doc["ok"] and len(checks) == 8 and all(checks.values()),
          "region storm: checks failed: %s" % checks)
    for label in RG_EVENTS:
        check(events.get(label) == 1,
              "region storm: event %s counted %s times, not once"
              % (label, events.get(label)))
    epochs = doc["spec"]["epochs"]
    check(stats["served_epochs"] == {"0": epochs, "1": epochs},
          "region storm: served epochs %s, not %d on both replicas"
          % (stats["served_epochs"], epochs))
    check(stats["clients"]["dropped"] == 0 and
          events.get("client_retry:502", 0) == 0,
          "region storm: clients dropped %s, 502s retried %s"
          % (stats["clients"]["dropped"], events.get("client_retry:502")))
    check(stats["trainer"]["world"] == 4, "region storm: the resize did not "
          "land (world %s)" % stats["trainer"]["world"])
    check(events.get("data_reconnect", 0) >= 1 and
          events.get("publish_rejected", 0) >= 1,
          "region storm: no data reconnect or no rejected publish: %s"
          % events)
    check(stats["freshness_ms"] is not None,
          "region storm: no freshness_ms")
    report = [ln for _t, ln in stdout if ln.startswith("REGION_REPORT ")]
    check(report and json.loads(report[-1][len("REGION_REPORT "):]) == doc,
          "region storm: REGION_REPORT line missing or unlike --report")
    at, roles = _rg_bringup(lines, t0, doc["spec"]["data_servers"])
    step_ms = {}
    for w in (2, 4):
        ms = [r["step_ms"] for r in times
              if r.get("event") == "epoch" and r["world"] == w]
        check(ms, "region storm: no timed epoch at world %d" % w)
        # the first epoch of a process holds its CUDA set-up
        step_ms[w] = float(np.median(ms[1:] if len(ms) > 1 else ms))
    resumed = [r["wall"] for r in times if r.get("event") == "resumed"]
    check(resumed, "region storm: the trainer never resumed")
    resize_s = resumed[0] - (t0 + at["resize"])
    clients = stats["clients"]
    out = {"elapsed_s": elapsed, "bringup_s": roles,
           "milestones_s": at, "step_ms": {"world2": step_ms[2],
                                           "world4": step_ms[4]},
           "resize_to_resumed_s": resize_s,
           "freshness_ms": stats["freshness_ms"],
           "clients": {"requests": clients["requests"],
                       "ok": clients["ok"],
                       "retries": doc["client_retries"]},
           "rollouts": events.get("rollouts")}
    log("region storm: %.1f s; bring-up %s; trainer ms a batch world 2 "
        "%.3f, world 4 %.3f; resize to resumed %.2f s; freshness_ms %s; "
        "clients %d requests, %d ok, %d retries"
        % (elapsed, json.dumps({k: round(v, 2) for k, v in roles.items()}),
           step_ms[2], step_ms[4], resize_s, stats["freshness_ms"],
           clients["requests"], clients["ok"], doc["client_retries"]))
    return out


def _rg_lstm_run(torch, mx, build, ctx, group2ctx, init, x, y, dtype,
                 crossings=None):
    """The example's loop (its ``main`` without the device query) from the
    weights ``init``: per step the nll of the labels, every gradient
    (float64 numpy) and the step's host ms, after a device sync."""
    import numpy as np
    net = build(**RG_LSTM)
    shapes = {"data": x.shape, "softmax_label": y.shape}
    if dtype == np.float32:
        ex = net.simple_bind(ctx, group2ctx=group2ctx, **shapes)
    else:
        arg_shapes, _, _ = net.infer_shape(**shapes)
        names = net.list_arguments()

        def arr(v):
            return mx.nd.array(v, ctx=ctx, dtype=dtype)
        ex = net.bind(ctx, {n: arr(init[n] if n in init else np.zeros(s))
                            for n, s in zip(names, arg_shapes)},
                      args_grad={n: arr(np.zeros(s))
                                 for n, s in zip(names, arg_shapes)},
                      group2ctx=group2ctx)
    for k, v in init.items():
        ex.arg_dict[k][:] = v
    ex.arg_dict["data"][:] = x
    ex.arg_dict["softmax_label"][:] = y
    steps = []
    for _ in range(RG_LSTM_STEPS):
        t0 = time.perf_counter()
        with crossings if crossings is not None else contextlib.nullcontext():
            out = ex.forward(is_train=True)[0]
            ex.backward()
        for name in init:
            w, g = ex.arg_dict[name], ex.grad_dict[name]
            w._data = w._data - RG_LSTM_LR / x.size * g._data
        if ctx.device_type == "gpu" or group2ctx:
            torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        p = out.asnumpy().astype(np.float64)
        nll = -np.log(np.maximum(p[np.arange(p.shape[0]),
                                   y.reshape(-1).astype(int)], 1e-12)).mean()
        steps.append({"nll": nll, "ms": ms, "grads": {
            k: ex.grad_dict[k].asnumpy().astype(np.float64) for k in init}})
    return ex, steps


def _rg_lstm_agree(np, placed, single, plain, exact, names):
    """The placed LSTM's agreement, a row a step.  The yardstick is the
    CPU float32 run's own error against float64 (``plain`` against
    ``exact``), which holds neither card run: the placed run's nll and
    gradients are held against ``gpu(0)`` alone (``single``) and against
    float64, all gradients together and each tensor alone, each within
    max(RG_LSTM_FLOOR, GRAD_L2_FACTOR x the CPU float32 run's error on
    the same quantity).  ``failed`` names what did not hold."""
    rows = []
    for p, s, c, e in zip(placed, single, plain, exact):
        def rel(a, b):
            return abs(a["nll"] - b["nll"]) / abs(b["nll"])
        loss_spread = rel(c, e)
        loss_bound = max(RG_LSTM_FLOOR, GRAD_L2_FACTOR * loss_spread)
        spread = _rel_l2(np, c["grads"], e["grads"], names)
        bound = max(RG_LSTM_FLOOR, GRAD_L2_FACTOR * spread)
        row = {"loss": (rel(p, s), rel(p, e)), "loss_spread": loss_spread,
               "loss_bound": loss_bound,
               "grads": (_rel_l2(np, p["grads"], s["grads"], names),
                         _rel_l2(np, p["grads"], e["grads"], names)),
               "spread": spread, "bound": bound, "failed": [],
               "worst_key": "", "worst_share": 0.0}
        if max(row["loss"]) > loss_bound:
            row["failed"].append("nll")
        if max(row["grads"]) > bound:
            row["failed"].append("gradients")
        for k in names:
            k_bound = max(RG_LSTM_FLOOR, GRAD_L2_FACTOR * _rel_l2(
                np, c["grads"], e["grads"], [k]))
            k_err = max(_rel_l2(np, p["grads"], s["grads"], [k]),
                        _rel_l2(np, p["grads"], e["grads"], [k]))
            if k_err / k_bound > row["worst_share"]:
                row["worst_key"], row["worst_share"] = k, k_err / k_bound
            if k_err > k_bound:
                row["failed"].append(k)
        rows.append(row)
    return rows


def _rg_lstm(torch, mx, seed, card):
    """(b) of region_paths: the example's model-parallel LSTM over
    ``cpu()`` and ``gpu(0)``.  Returns its lstm_cell launches."""
    import numpy as np
    lc = mx.kernels.lstm_cell
    build = example_modules()["lstm_ctx_group"].build
    ctx_of = {"cpu": mx.cpu(), "gpu": mx.gpu(0)}
    group2ctx = {g: ctx_of[k] for g, k in RG_GROUPS.items()}
    net = build(**RG_LSTM)
    rs = np.random.RandomState(seed + 220)
    arg_shapes, _, _ = net.infer_shape(
        data=(RG_LSTM_BATCH, RG_LSTM["seq_len"]),
        softmax_label=(RG_LSTM_BATCH, RG_LSTM["seq_len"]))
    init = {n: rs.uniform(-0.08, 0.08, s).astype(np.float32)
            for n, s in zip(net.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}
    toks = rs.randint(1, RG_LSTM["vocab"],
                      size=(RG_LSTM_BATCH, RG_LSTM["seq_len"] + 1))
    x, y = toks[:, :-1].astype("f"), toks[:, 1:].astype("f")

    # -- the main path: counts zeroed just before, read just after ---------
    crossings = CopyCounter(torch)
    zero_lstm_counts(lc)
    ex, placed = _rg_lstm_run(torch, mx, build, group2ctx["embed"],
                              group2ctx, init, x, y, np.float32, crossings)
    counts = lstm_counts(lc)
    # ----------------------------------------------------------------------
    check(len({str(c) for c in ex._placement.values()}) == 2,
          "placed LSTM: placement %s" % set(ex._placement.values()))
    n = RG_LSTM["seq_len"] * RG_LSTM_STEPS
    log("placed LSTM: %d steps launched %s LSTM kernels (expected cell "
        "%d + %d: layer0 on gpu(0))" % (RG_LSTM_STEPS, counts, n, n))
    check(counts == {"cell": (n, n), "seq": (0, 0), "gates": 0},
          "placed LSTM launched %s LSTM kernels" % (counts,))
    one, single = _rg_lstm_run(torch, mx, build, mx.gpu(0), None, init, x,
                               y, np.float32)
    _ex, plain = _rg_lstm_run(torch, mx, build, mx.cpu(), None, init, x, y,
                              np.float32)
    _ex, exact = _rg_lstm_run(torch, mx, build, mx.cpu(), None, init,
                              x.astype(np.float64), y.astype(np.float64),
                              np.float64)
    names = sorted(init)
    rows = _rg_lstm_agree(np, placed, single, plain, exact, names)
    for i, r in enumerate(rows):
        log("placed LSTM step %d: nll placed %.6f, gpu(0) %.6f, float64 "
            "%.6f: rel %.3g / %.3g against gpu(0) / float64 (bound %.3g = "
            "max(%g, %g x the CPU float32 run's %.3g)); %d gradients, "
            "relative L2 %.3g / %.3g (bound %.3g = max(%g, %g x the CPU "
            "float32 run's %.3g)); worst tensor %s %.3g of its bound"
            % (i, placed[i]["nll"], single[i]["nll"], exact[i]["nll"],
               r["loss"][0], r["loss"][1], r["loss_bound"], RG_LSTM_FLOOR,
               GRAD_L2_FACTOR, r["loss_spread"], len(names), r["grads"][0],
               r["grads"][1], r["bound"], RG_LSTM_FLOOR, GRAD_L2_FACTOR,
               r["spread"], r["worst_key"], r["worst_share"]))
        check(not r["failed"], "placed LSTM step %d disagrees with gpu(0) "
              "alone or with float64: %s" % (i, r["failed"]))
        for k in names:
            check(np.isfinite(placed[i]["grads"][k]).all(),
                  "placed LSTM: %s not finite" % k)
    # the gate itself: one gradient leaf of the placed run scaled by 1.01
    # in one step must fail it
    for k in names:
        if not np.any(exact[-1]["grads"][k]):
            continue            # scaling a zero gradient changes nothing
        bent = [dict(p, grads=dict(p["grads"])) for p in placed]
        bent[-1]["grads"][k] = bent[-1]["grads"][k] * 1.01
        bad = _rg_lstm_agree(np, bent, single, plain, exact, names)
        check(bad[-1]["failed"], "placed LSTM: the gate passes %s scaled "
              "by 1.01" % k)
    worst = {"loss": max(max(r["loss"]) for r in rows),
             "grads": max(max(r["grads"]) for r in rows),
             "bound": max(r["bound"] for r in rows)}
    nll = [p["nll"] for p in placed]
    check(nll[-1] < nll[0], "placed LSTM: the nll does not fall: %s" % nll)
    per_step = {k: v // RG_LSTM_STEPS for k, v in crossings.bytes.items()}
    check(per_step.get("cpu->cuda:0") and per_step.get("cuda:0->cpu"),
          "placed LSTM: no copy crossed a boundary: %s" % per_step)
    placed_ms = float(np.median([p["ms"] for p in placed[1:]]))
    single_ms = float(np.median([s["ms"] for s in single[1:]]))
    log("placed LSTM: ms a step placed %.2f, gpu(0) alone %.2f; bytes a "
        "step across boundaries %s; nll %s (%s)"
        % (placed_ms, single_ms, json.dumps(per_step), nll, card))
    return {"launches": counts["cell"], "placed_ms": placed_ms,
            "single_ms": single_ms, "boundary_bytes": per_step,
            "nll": nll, "worst": worst}


def region_paths(torch, mx, seed, card):
    """The region drill on the card (_rg_storm) and the example's
    model-parallel LSTM over cpu() and gpu(0) (_rg_lstm).  Returns the
    placed LSTM's lstm_cell launches."""
    tmp = tempfile.mkdtemp(prefix="mxt-region-")
    try:
        storm = _rg_storm(torch, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    lstm = _rg_lstm(torch, mx, seed, card)
    log(json.dumps({"region": {"storm": storm, "placed_lstm": {
        k: v for k, v in lstm.items() if k != "launches"}, "card": card}}))
    return collections.Counter({"lstm_cell_fwd": lstm["launches"][0],
                                "lstm_cell_bwd": lstm["launches"][1]})


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the weights, requests and batches")
    parser.add_argument("--dist-worker", default=None,
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import mxnet_tpu_torch as mx
    except ImportError as e:
        print("chip_smoke: cannot import mxnet_tpu_torch: %s" % e,
              file=sys.stderr)
        return 2
    if args.dist_worker:
        dist_worker(args.dist_worker)
        return 0
    times = collections.OrderedDict()

    def timed(name, fn, *args):
        """Run one path, log its wall time and keep every time so far in
        chiprun_out/smoke_times.json (a failure still leaves its row)."""
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            times[name] = round(time.perf_counter() - t0, 1)
            log("%s: %.1f s" % (name, times[name]))
            out = os.path.join(ROOT, "chiprun_out")
            os.makedirs(out, exist_ok=True)
            with open(os.path.join(out, "smoke_times.json"), "w") as f:
                json.dump(times, f, indent=1)

    rtc = timed("setup_rtc", rtc_kernels, torch, mx)
    card = timed("setup", phase_setup, torch, mx, rtc, DEFERRED_SOURCES)
    seed = args.seed
    try:
        kernels = timed("resnet_paths", resnet_paths, torch, mx, seed, card)
    finally:
        # the deferred nvcc ends before anything else runs, or the script
        timed("setup_deferred", await_builds, mx)
    kernels += timed("lm_paths", lm_paths, torch, mx, seed, card)
    kernels += timed("long_context_paths", long_context_paths, torch, mx,
                     seed, card)
    extra, rows = timed("finetune_paths", finetune_paths, torch, mx, rtc,
                        seed, card)
    kernels += rows
    prepared = {}

    def fleet_after_serving(torch, mx, seed, card):
        return fleet_paths(torch, mx, seed, card, prepared=prepared["fleet"])

    try:
        for name, path in (("nd_paths", nd_paths),
                           ("bucketing_paths", bucketing_paths),
                           ("zoo_paths", zoo_paths),
                           ("extension_paths", extension_paths),
                           ("input_paths", input_paths),
                           ("data_service_paths", data_service_paths),
                           ("detection_paths", detection_paths),
                           ("resilience_paths", resilience_paths),
                           ("fleet_prepare", None),
                           ("serving_paths", serving_paths),
                           ("fleet_paths", fleet_after_serving),
                           ("tools_paths", tools_paths),
                           ("dist_paths", dist_paths),
                           ("model_parallel_paths", model_parallel_paths),
                           ("region_paths", region_paths)):
            if path is None:
                # the fleet's warm store builds beside serving_paths
                prepared["fleet"] = timed(name, fleet_prepare, torch, mx,
                                          seed)
                continue
            extra += timed(name, path, torch, mx, seed, card)
    finally:
        for proc in _BACKGROUND:
            _sv_stop(proc)
    times["total"] = round(sum(times.values()), 1)
    log(json.dumps({"path_seconds": times}))
    for row in kernels:
        row["launches"] += extra.get(row["name"], 0)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print("chip_smoke FAILED: %s" % e, file=sys.stderr)
        sys.exit(1)
